"""SubscriptionHub — per-replica fan-out of standing-query deltas.

The hub sits beside a :class:`~reflow_tpu_torch.serve.replica.ReplicaScheduler`
(attached via ``replica.attach_hub(hub)``) and turns the replica's
apply path into a push stream. The contract that keeps the write path
safe:

- **The apply path never blocks on subscribers.** The replica's only
  obligation is :meth:`on_window` — an append to a bounded work queue
  under a dedicated lock plus a condition notify. Everything expensive
  (mirror advance, per-query delta computation, 100k outbox appends)
  happens on the hub's own fan-out thread.
- **Slow subscribers degrade, never stall.** Each subscriber has a
  bounded outbox; overflow conflates the backlog into one merged frame
  (:func:`~reflow_tpu_torch.subs.query.merge_frames`), and a backlog too
  large even to conflate sheds the subscriber to snapshot semantics
  (outbox cleared, rebase flag set — the next round delivers a fresh
  snapshot). Both are counted.
- **Shed ladder** (driven by :class:`~reflow_tpu_torch.serve.control
  .ControlPlane`): level 0 normal; level 1 conflates eagerly (outbox
  never holds more than one frame); level 2 pauses emission entirely —
  mirrors still advance so correctness is preserved, and recovery
  re-snapshots every subscriber.

**Fan-out rounds.** Each round drains queued windows, advances one
per-sink *mirror* (a full view the fan-out thread owns exclusively),
computes at most one frame per distinct query (a *fan* — subscribers
sharing a query share the stream), appends it to member outboxes under
sharded locks, then services rebase-flagged subscribers with snapshot
frames and finally advances the published fan-out horizon. Frames are
appended *before* the horizon advances, and :meth:`poll` reads the
horizon *before* inspecting the outbox — that ordering is what lets an
empty poll double as a heartbeat that safely advances the client's
cursor past changeless windows.

``min_horizon=`` inherits the :class:`~reflow_tpu_torch.serve.read.ReadTier`
semantics: a subscription parks (no snapshot, no deltas) until the
fan-out horizon reaches ``min_horizon`` — read-your-writes for
subscribers.

The port's copy of ``reflow_tpu/subs/hub.py``. The hub folds
``TickResult.sink_deltas`` rows: on a replica over the ``"cuda"``
executor those are the scheduler's host batches, read back once a tick
before the replica hands the window over, so the fan-out thread and the
subscription server's threads read host mirrors only and never touch
the card.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.obs.registry import REGISTRY
from reflow_tpu_torch.subs.query import (DeltaFrame, QueryState, StandingQuery,
                                   canon_query, delta_rows, merge_frames,
                                   snapshot_rows)
from reflow_tpu_torch.utils.config import env_float, env_int
from reflow_tpu_torch.utils.faults import CrashPoint
from reflow_tpu_torch.utils.runtime import named_lock

_POLL_S = 0.2
#: windows queued beyond this are folded into a rebase (fan-out thread
#: dead or badly behind) — on_window stays O(1) and bounded either way.
_WQ_MAX = 4096


class _Mirror:
    """Fan-out-thread-owned copy of one sink view at horizon ``h``."""
    __slots__ = ("h", "view")

    def __init__(self, h: int, view: Dict):
        self.h = h
        self.view = view


class _Fan:
    """One distinct standing query and its member tokens. The delta
    stream is computed once per fan per round."""
    __slots__ = ("query", "tokens", "last_emit_h", "last_topk")

    def __init__(self, query: StandingQuery):
        self.query = query
        self.tokens: set = set()
        self.last_emit_h: Optional[int] = None
        self.last_topk: Optional[tuple] = None


class _Sub:
    __slots__ = ("token", "query", "outbox", "acked", "rebase",
                 "min_horizon", "wire", "expire_s", "last_seen")

    def __init__(self, token: str, query: StandingQuery, *,
                 min_horizon: int, wire: bool, expire_s: Optional[float],
                 now: float):
        self.token = token
        self.query = query
        self.outbox: deque = deque()
        self.acked = -1
        self.rebase = True
        self.min_horizon = min_horizon
        self.wire = wire
        self.expire_s = expire_s
        self.last_seen = now


class _Shard:
    __slots__ = ("lock", "cond", "subs")

    def __init__(self, name: str):
        self.lock = named_lock(name)
        self.cond = threading.Condition(self.lock)
        self.subs: Dict[str, _Sub] = {}


class SubHandle:
    """In-process subscriber: drains its hub outbox directly into a
    :class:`~reflow_tpu_torch.subs.query.QueryState`. This is both the
    programmatic API and the unit the 100k-subscriber bench simulates
    (the wire :class:`~reflow_tpu_torch.subs.client.Subscriber` wraps the
    same state machine around a transport)."""

    def __init__(self, hub: "SubscriptionHub", token: str,
                 query: StandingQuery):
        self.hub = hub
        self.token = token
        self.state = QueryState(query)

    def drain(self, wait_s: float = 0.0,
              max_frames: Optional[int] = None) -> int:
        """Poll once and apply; returns frames that advanced state."""
        frames, horizon = self.hub.poll(self.token,
                                        acked=self.state.horizon,
                                        wait_s=wait_s,
                                        max_frames=max_frames)
        n = 0
        for f in frames:
            if self.state.apply(f):
                n += 1
        self.state.note_horizon(horizon)
        return n

    def wait_horizon(self, horizon: int, timeout_s: float = 5.0) -> bool:
        """Drain until local state reaches ``horizon`` (or timeout)."""
        deadline = time.monotonic() + timeout_s
        while self.state.horizon < horizon:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self.drain(wait_s=min(remaining, _POLL_S))
        return True

    @property
    def horizon(self) -> int:
        return self.state.horizon

    def value(self):
        return self.state.value()

    def close(self) -> None:
        self.hub.unsubscribe(self.token)


class SubscriptionHub:
    """Standing-query fan-out for one replica. See module docstring.

    ``start=False`` leaves the fan-out thread unstarted so tests can
    drive rounds deterministically with :meth:`pump_once`."""

    def __init__(self, replica, *, name: Optional[str] = None,
                 shards: int = 8,
                 outbox_max: Optional[int] = None,
                 conflate_max_rows: Optional[int] = None,
                 idle_poll_s: Optional[float] = None,
                 expire_s: Optional[float] = None,
                 crash=None, start: bool = True):
        self.replica = replica
        self.name = name or getattr(replica, "name", "hub")
        self.outbox_max = (outbox_max if outbox_max is not None
                           else env_int("REFLOW_SUB_OUTBOX"))
        self.conflate_max_rows = (
            conflate_max_rows if conflate_max_rows is not None
            else env_int("REFLOW_SUB_CONFLATE_MAX_ROWS"))
        self._idle_poll_s = (idle_poll_s if idle_poll_s is not None
                             else env_float("REFLOW_SUB_IDLE_POLL_S"))
        self._expire_s = (expire_s if expire_s is not None
                          else env_float("REFLOW_SUB_EXPIRE_S"))
        self._crash = crash
        # registry lock: fans + token issuance. Ordered before shard
        # locks; never acquired from under one.
        self._reg = named_lock(f"subs.hub.{self.name}")
        self._fans: Dict[StandingQuery, _Fan] = {}
        self._seq = 0
        # work queue: the only lock the replica apply path ever touches.
        self._wq_lock = named_lock(f"subs.hub.{self.name}.wq")
        self._wq_cond = threading.Condition(self._wq_lock)
        self._wq: deque = deque()
        self._rebase_all = False
        self._kick = False
        self._shed_level = 0
        self._shards: List[_Shard] = [
            _Shard(f"subs.hub.{self.name}.shard{i}") for i in range(shards)]
        self._mirrors: Dict[str, _Mirror] = {}   # fan-out thread only
        self._fanout_h = -1
        # counters (plain ints; exported as gauges by publish_metrics)
        self.windows_total = 0
        self.rounds_total = 0
        self.frames_total = 0
        self.fanout_rows_total = 0
        self.conflations_total = 0
        self.sheds_total = 0
        self.snapshots_total = 0
        self.rebases_total = 0
        self.reaped_total = 0
        self.wq_overflows = 0
        # causality tokens drained from windows but not yet stamped on
        # an emitted frame (a sampled write whose window produced no
        # frame for any fan yet rides the next frame that does emit —
        # chains must not tear on quiet queries). Fan-out thread only.
        self._pending_causes: List[str] = []
        # reservoir of window-recv → frame-emit latencies (seconds):
        # the in-hub slice of ack→push freshness, exported as
        # subs.freshness_p50/p99.
        self._freshness: deque = deque(maxlen=512)
        self.pump_errors = 0
        self.pump_error: Optional[BaseException] = None
        self._metric_names: List[Tuple[object, str]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- replica-facing ----------------------------------------------------

    def on_window(self, from_h: int, to_h: int, results: tuple,
                  causes: Optional[tuple] = None) -> None:
        """Called by the replica after applying a commit window
        ``(from_h, to_h]``; ``results`` holds one ``TickResult`` per
        tick. ``causes`` carries the causality tokens of any sampled
        writes in the window (tracing on) — they ride the emitted
        :class:`DeltaFrame`\\ s so the chain reaches subscribers. O(1),
        bounded, never blocks the apply path."""
        with self._wq_lock:
            if len(self._wq) >= _WQ_MAX:
                self._wq.clear()
                self._rebase_all = True
                self.wq_overflows += 1
            self._wq.append((from_h, to_h, results, causes,
                             time.perf_counter()))
            self.windows_total += 1
            self._wq_cond.notify_all()

    def rebase(self) -> None:
        """Discard mirrors and re-snapshot every subscriber on the next
        round — called when replica state moved non-monotonically
        (bootstrap / promote / re-anchor) or after a fan-out crash."""
        with self._wq_lock:
            self._wq.clear()
            self._rebase_all = True
            self._wq_cond.notify_all()

    # -- subscriber registration -------------------------------------------

    def subscribe(self, sink, kind: str = "view", params: Sequence = (), *,
                  token: Optional[str] = None, cursor: int = -1,
                  min_horizon: int = 0, wire: bool = False,
                  expire_s: Optional[float] = None) -> Tuple[str, str]:
        """Register (or resume) a standing query. Returns
        ``(token, mode)`` where mode is ``"resume"`` when the
        subscriber's cursor lets the stream continue without a
        snapshot, else ``"snapshot"``.

        Resume rules: a known ``token`` with the same query always
        resumes (its outbox still holds any unacked frames); an unknown
        token resumes iff ``cursor`` is inside the fan's changeless
        tail (``last_emit_h <= cursor <= fan-out horizon``) — nothing
        was emitted past the cursor, so the subscriber is provably
        current."""
        q = canon_query(sink, kind, params)
        now = time.monotonic()
        exp = self._expire_s if (wire and expire_s is None) else expire_s
        with self._reg:
            if token is None:
                self._seq += 1
                token = f"{self.name}-sub-{self._seq}"
            fan = self._fans.get(q)
            if fan is None:
                fan = self._fans[q] = _Fan(q)
            shard = self._shard(token)
            with shard.lock:
                sub = shard.subs.get(token)
                if sub is not None and sub.query == q:
                    sub.last_seen = now
                    fan.tokens.add(token)
                    mode = "resume" if not sub.rebase else "snapshot"
                    shard.cond.notify_all()
                    self._kick_round()
                    return token, mode
                if sub is not None:       # token reused for a new query
                    self._drop_membership(sub)
                sub = _Sub(token, q, min_horizon=min_horizon, wire=wire,
                           expire_s=exp, now=now)
                if (cursor is not None and cursor >= 0
                        and fan.last_emit_h is not None
                        and fan.last_emit_h <= cursor <= self._fanout_h
                        and cursor >= min_horizon):
                    sub.rebase = False
                    sub.acked = cursor
                    mode = "resume"
                else:
                    mode = "snapshot"
                shard.subs[token] = sub
                fan.tokens.add(token)
        self._kick_round()
        return token, mode

    def open(self, sink, kind: str = "view", params: Sequence = (), *,
             min_horizon: int = 0, token: Optional[str] = None) -> SubHandle:
        """Subscribe and wrap in an in-process :class:`SubHandle`."""
        token, _ = self.subscribe(sink, kind, params, token=token,
                                  min_horizon=min_horizon)
        return SubHandle(self, token, canon_query(sink, kind, params))

    def unsubscribe(self, token: str) -> bool:
        with self._reg:
            shard = self._shard(token)
            with shard.lock:
                sub = shard.subs.pop(token, None)
                if sub is None:
                    return False
                self._drop_membership(sub)
                shard.cond.notify_all()
        return True

    def _drop_membership(self, sub: _Sub) -> None:
        # caller holds self._reg
        fan = self._fans.get(sub.query)
        if fan is not None:
            fan.tokens.discard(sub.token)
            if not fan.tokens:
                del self._fans[sub.query]

    # -- subscriber polling ------------------------------------------------

    def poll(self, token: str, *, acked: int = -1, wait_s: float = 0.0,
             max_frames: Optional[int] = None
             ) -> Tuple[List[DeltaFrame], int]:
        """Drain up to ``max_frames`` pending frames for ``token``,
        long-polling up to ``wait_s``. Returns ``(frames, horizon)``;
        an empty list is a heartbeat — ``horizon`` certifies the query
        unchanged through it. Raises ``KeyError`` for unknown/expired
        tokens (the wire layer maps this to ``gone``)."""
        if max_frames is None:
            max_frames = env_int("REFLOW_SUB_MAX_FRAMES")
        shard = self._shard(token)
        deadline = time.monotonic() + max(0.0, wait_s)
        with shard.lock:
            while True:
                sub = shard.subs.get(token)
                if sub is None:
                    raise KeyError(token)
                sub.last_seen = time.monotonic()
                if acked is not None and acked > sub.acked:
                    sub.acked = acked
                outbox = sub.outbox
                while outbox and not outbox[0].snapshot \
                        and outbox[0].to_h <= sub.acked:
                    outbox.popleft()
                # read the horizon before deciding "empty" (the pump
                # appends frames before advancing it, so an empty
                # outbox at this horizon proves changelessness)... but
                # a rebase-flagged subscriber's stream is broken (shed,
                # paused at level 2, or parked below min_horizon):
                # frames stopped flowing, so the fan-out horizon
                # certifies nothing for it — heartbeat -1, the client
                # holds its horizon until the snapshot lands.
                horizon = -1 if sub.rebase else self._fanout_h
                if outbox:
                    frames = []
                    while outbox and len(frames) < max_frames:
                        frames.append(outbox.popleft())
                    return frames, horizon
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], horizon
                shard.cond.wait(min(remaining, _POLL_S))

    # -- fan-out rounds ----------------------------------------------------

    def _crash_point(self, point: str) -> None:
        if self._crash is not None:
            self._crash.point(point)

    def _shard(self, token: str) -> _Shard:
        return self._shards[hash(token) % len(self._shards)]

    def _kick_round(self) -> None:
        with self._wq_lock:
            self._kick = True
            self._wq_cond.notify_all()

    def pump_once(self, wait_s: float = 0.0) -> int:
        """One fan-out round; returns frames appended. Tests call this
        directly (``start=False``) for deterministic rounds."""
        t0 = time.perf_counter()
        with self._wq_lock:
            deadline = time.monotonic() + max(0.0, wait_s)
            while not (self._wq or self._kick or self._rebase_all):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    break
                self._wq_cond.wait(min(remaining, _POLL_S))
            windows = list(self._wq)
            self._wq.clear()
            rebase_all = self._rebase_all
            self._rebase_all = False
            self._kick = False
            shed_level = self._shed_level
        self.rounds_total += 1
        # the seam sits at the most dangerous point: windows drained
        # from the queue but not yet folded into mirrors. Recovery is
        # rebase() — tests prove a crash here never corrupts a
        # subscriber, it only costs a snapshot.
        self._crash_point("sub_fanout")
        with self._reg:
            fans = [(fan.query, fan, set(fan.tokens))
                    for fan in self._fans.values()]
        sinks = {q.sink for q, _, _ in fans}
        for s in list(self._mirrors):
            if s not in sinks:
                del self._mirrors[s]
        if rebase_all:
            self._mirrors.clear()
            windows = []
            self._pending_causes.clear()
            self._flag_all_rebase()
            self.rebases_total += 1
        for w in windows:
            for c in (w[3] or ()):
                if c not in self._pending_causes:
                    self._pending_causes.append(c)
        for s in sinks:
            if s not in self._mirrors:
                h, view = self.replica.view_at(s)
                self._mirrors[s] = _Mirror(h, dict(view))
        round_deltas = self._advance_mirrors(windows)
        appended = 0
        rows_out = 0
        emitted_causes: Optional[tuple] = None
        if shed_level >= 2:
            # paused: mirrors advanced (correctness kept), nothing
            # emitted; every live subscriber owes a snapshot on resume.
            for _, fan, _ in fans:
                mirror = self._mirrors.get(fan.query.sink)
                if mirror is not None:
                    fan.last_emit_h = mirror.h
                    fan.last_topk = None
            self._flag_all_rebase()
        else:
            causes = tuple(self._pending_causes) or None
            delta_frames = 0
            for q, fan, tokens in fans:
                mirror = self._mirrors.get(q.sink)
                if mirror is None:
                    continue
                if fan.last_emit_h is None:
                    fan.last_emit_h = mirror.h
                    continue
                if mirror.h <= fan.last_emit_h:
                    continue
                rows = delta_rows(q, round_deltas.get(q.sink, {}),
                                  mirror.view, fan.last_topk)
                if rows is None:
                    continue
                frame = DeltaFrame(fan.last_emit_h, mirror.h, q.kind,
                                   rows, False, causes)
                if q.kind == "topk":
                    fan.last_topk = rows
                fan.last_emit_h = mirror.h
                delta_frames += 1
                n = self._fan_out(frame, tokens)
                appended += n
                rows_out += n * len(rows)
            if delta_frames:
                emitted_causes = causes
                self._pending_causes.clear()
                if windows:
                    emit_t = time.perf_counter()
                    for w in windows:
                        self._freshness.append(emit_t - w[4])
            appended += self._service_rebases()
        reaped = self._reap_expired()
        # order matters: frames land in outboxes (above) before the
        # horizon moves, so a poll that sees the new horizon also sees
        # every frame at or below it.
        if self._mirrors:
            self._fanout_h = min(m.h for m in self._mirrors.values())
        elif windows:
            self._fanout_h = max(self._fanout_h, windows[-1][1])
        for shard in self._shards:
            with shard.lock:
                shard.cond.notify_all()
        self.frames_total += appended
        self.fanout_rows_total += rows_out
        if _trace.ENABLED and emitted_causes:
            _trace.evt("sub_fanout", t0, time.perf_counter() - t0,
                       track=f"subs/{self.name}",
                       args={"frames": appended,
                             "causes": list(emitted_causes),
                             "horizon": self._fanout_h})
        if _trace.ENABLED and (appended or windows or reaped):
            _trace.evt("sub_push", t0, time.perf_counter() - t0,
                       track=f"subs/{self.name}",
                       args={"frames": appended, "windows": len(windows),
                             "fans": len(fans), "horizon": self._fanout_h,
                             "shed_level": shed_level})
        return appended

    def _advance_mirrors(self, windows) -> Dict[str, Dict]:
        """Fold queued windows into the per-sink mirrors; returns the
        per-sink delta accumulated over exactly the span each mirror
        advanced this round."""
        round_deltas: Dict[str, Dict] = {}
        for from_h, to_h, results, _causes, _recv in windows:
            for s, mirror in self._mirrors.items():
                if mirror.h >= to_h:
                    continue
                if mirror.h < from_h:
                    # continuity lost (shouldn't happen outside races
                    # with bootstrap) — heal via rebase next round.
                    self.rebase()
                    continue
                acc = round_deltas.setdefault(s, {})
                view = mirror.view
                while mirror.h < to_h:
                    batch = results[mirror.h - from_h].sink_deltas.get(s)
                    if batch is not None:
                        for k, v, w in batch.rows():
                            kv = (k, v)
                            nw = view.get(kv, 0) + w
                            if nw == 0:
                                view.pop(kv, None)
                            else:
                                view[kv] = nw
                            acc[kv] = acc.get(kv, 0) + w
                    mirror.h += 1
        return round_deltas

    def _fan_out(self, frame: DeltaFrame, tokens: set) -> int:
        by_shard: Dict[int, List[str]] = {}
        for token in tokens:
            by_shard.setdefault(hash(token) % len(self._shards),
                                []).append(token)
        appended = 0
        for idx, toks in by_shard.items():
            shard = self._shards[idx]
            with shard.lock:
                for token in toks:
                    sub = shard.subs.get(token)
                    if sub is None or sub.rebase:
                        continue
                    self._append(sub, frame)
                    appended += 1
        return appended

    def _append(self, sub: _Sub, frame: DeltaFrame) -> None:
        # caller holds the sub's shard lock
        sub.outbox.append(frame)
        overflow = len(sub.outbox) > self.outbox_max
        eager = self._shed_level >= 1 and len(sub.outbox) > 1
        if not (overflow or eager):
            return
        merged = merge_frames(list(sub.outbox))
        if len(merged.rows) > self.conflate_max_rows:
            sub.outbox.clear()
            sub.rebase = True
            sub.acked = -1
            self.sheds_total += 1
        else:
            sub.outbox.clear()
            sub.outbox.append(merged)
            self.conflations_total += 1

    def _service_rebases(self) -> int:
        """Deliver snapshot frames to rebase-flagged subscribers whose
        sink mirror has reached their ``min_horizon`` (parking)."""
        snap_cache: Dict[StandingQuery, DeltaFrame] = {}
        appended = 0
        for shard in self._shards:
            with shard.lock:
                for sub in shard.subs.values():
                    if not sub.rebase:
                        continue
                    mirror = self._mirrors.get(sub.query.sink)
                    if mirror is None or mirror.h < sub.min_horizon:
                        continue          # parked below min_horizon
                    frame = snap_cache.get(sub.query)
                    if frame is None:
                        frame = DeltaFrame(
                            -1, mirror.h, sub.query.kind,
                            snapshot_rows(sub.query, mirror.view), True)
                        snap_cache[sub.query] = frame
                    sub.outbox.clear()
                    sub.outbox.append(frame)
                    sub.rebase = False
                    sub.acked = -1
                    self.snapshots_total += 1
                    appended += 1
        return appended

    def _flag_all_rebase(self) -> None:
        for shard in self._shards:
            with shard.lock:
                for sub in shard.subs.values():
                    sub.rebase = True

    def _reap_expired(self) -> int:
        now = time.monotonic()
        reaped: List[str] = []
        for shard in self._shards:
            with shard.lock:
                for token, sub in list(shard.subs.items()):
                    if sub.expire_s is not None \
                            and now - sub.last_seen > sub.expire_s:
                        del shard.subs[token]
                        reaped.append(token)
                        shard.cond.notify_all()
        if reaped:
            with self._reg:
                for token in reaped:
                    for fan in list(self._fans.values()):
                        if token in fan.tokens:
                            fan.tokens.discard(token)
                            if not fan.tokens:
                                del self._fans[fan.query]
                            break
            self.reaped_total += len(reaped)
        return len(reaped)

    # -- shedding ----------------------------------------------------------

    @property
    def shed_level(self) -> int:
        return self._shed_level

    def set_shed_level(self, level: int) -> None:
        """0 = normal, 1 = conflate eagerly, 2 = pause emission."""
        level = max(0, min(2, int(level)))
        with self._wq_lock:
            self._shed_level = level
            self._kick = True
            self._wq_cond.notify_all()

    def load(self) -> Dict:
        """Control-plane view of fan-out pressure."""
        with self._wq_lock:
            backlog = len(self._wq)
        return {"active": self.active_subs(),
                "backlog_windows": backlog,
                "slowest_lag": self.slowest_lag(),
                "shed_level": self._shed_level,
                "horizon": self._fanout_h}

    def active_subs(self) -> int:
        return sum(len(s.subs) for s in self._shards)

    def slowest_lag(self) -> Optional[int]:
        """Fan-out horizon minus the slowest subscriber's acked cursor
        (in ticks); ``None`` with no measurable subscriber."""
        horizon = self._fanout_h
        worst = None
        for shard in self._shards:
            with shard.lock:
                for sub in shard.subs.values():
                    if sub.rebase or sub.acked < 0:
                        continue
                    lag = horizon - sub.acked
                    if worst is None or lag > worst:
                        worst = lag
        return max(worst, 0) if worst is not None else None

    @property
    def fanout_horizon(self) -> int:
        return self._fanout_h

    # -- lifecycle ---------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        """Start (or restart after a crash) the fan-out thread. A
        restart rebases: whatever the dead thread had in flight is
        replaced by fresh snapshots."""
        if self.alive:
            return
        restarted = self._thread is not None
        self._stop.clear()
        if restarted:
            self.rebase()
        self._thread = threading.Thread(target=self._run,
                                        name=f"subs-hub-{self.name}",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.pump_once(wait_s=self._idle_poll_s)
            except CrashPoint as e:
                # simulated process death (the sub_fanout seam): record
                # and exit the loop — supervision notices ``not alive``
                # and restarts, which rebases. Recorded, not re-raised:
                # the fault model kills the *loop*, and an exception
                # escaping a thread is just noise on top of that.
                self.pump_error = e
                return
            except Exception:  # noqa: BLE001 - fan-out is advisory; a poisoned round must not kill push for every subscriber. Count and rebase.
                self.pump_errors += 1
                self.rebase()

    def close(self) -> None:
        self._stop.set()
        with self._wq_lock:
            self._wq_cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        for reg, base in self._metric_names:
            reg.unregister_prefix(base)
        self._metric_names = []

    # -- observability -----------------------------------------------------

    def publish_metrics(self, registry=None,
                        name: Optional[str] = None) -> None:
        reg = registry if registry is not None else REGISTRY
        base = name or "subs"
        reg.gauge(f"{base}.active", self.active_subs)
        reg.gauge(f"{base}.horizon", lambda: self._fanout_h)
        reg.gauge(f"{base}.backlog_windows", lambda: len(self._wq))
        reg.gauge(f"{base}.frames_total", lambda: self.frames_total)
        reg.gauge(f"{base}.fanout_rows_total",
                  lambda: self.fanout_rows_total)
        reg.gauge(f"{base}.conflations_total",
                  lambda: self.conflations_total)
        reg.gauge(f"{base}.sheds_total", lambda: self.sheds_total)
        reg.gauge(f"{base}.snapshots_total", lambda: self.snapshots_total)
        reg.gauge(f"{base}.slowest_lag",
                  lambda: self.slowest_lag() or 0)
        reg.gauge(f"{base}.shed_level", lambda: self._shed_level)
        reg.gauge(f"{base}.freshness_p50",
                  lambda: self.freshness_pct(0.50))
        reg.gauge(f"{base}.freshness_p99",
                  lambda: self.freshness_pct(0.99))
        self._metric_names.append((reg, base))

    def freshness_pct(self, q: float) -> float:
        """Percentile (seconds) of window-recv → frame-emit latency
        over the recent reservoir; 0.0 until the first emission."""
        snap = sorted(self._freshness)
        if not snap:
            return 0.0
        i = min(len(snap) - 1, int(q * (len(snap) - 1) + 0.5))
        return snap[i]
