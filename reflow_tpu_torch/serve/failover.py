"""Promote-on-failure: epoch-fenced leader failover.

The write path's single point of failure was the leader: PR 10 gave
reads N replicas, but a dead leader meant no more commit windows, ever.
This module closes that gap with a :class:`FailoverCoordinator` — a
control-plane actuator that detects leader death, elects a follower,
promotes it, and re-points the whole serving path, while **epoch
fencing** guarantees a not-actually-dead old leader (the classic
zombie) can never corrupt the new timeline.

The sequence, and why each step is where it is:

1. **Final drain.** Every acknowledged write is synced (acks gate on
   ``wal.wait_durable``), and synced bytes are plain file bytes — a
   dead *committer* doesn't make the disk unreadable. So before
   electing, the coordinator pumps the old shipper until no byte
   moves: acked ⊆ synced ⊆ shipped. Zero acknowledged-write loss is
   a property of this ordering, not of luck.
2. **Fence.** The old WAL is fenced at ``epoch+1``: any append the
   zombie still attempts raises :class:`~reflow_tpu_torch.wal.log.FencedWrite`
   (counted, traced), and every shipment it emits carries the old
   epoch — replicas NACK it with a ``fenced`` reason before mirroring
   a single byte, and the zombie's shipper stops offering to fenced
   followers. Rejected, never merged.
3. **Elect.** Deterministic policy, pluggable interface
   (:class:`ElectionPolicy`): the default
   :class:`HighestHorizonElection` picks the highest applied horizon,
   ties broken by name — after the final drain that follower holds
   every acknowledged window.
4. **Promote.** The winner truncates its held-back tail, opens its
   mirror as its own WAL in the new epoch (a fresh segment) and
   replays the mirrored prefix through ``recover()`` — see
   ``ReplicaScheduler.promote``.
5. **Re-ship.** A new :class:`~reflow_tpu_torch.wal.ship.SegmentShipper`
   runs off the new leader; survivors ``reanchor()`` (truncate to
   their apply point, adopt the epoch) and re-attach — the
   truncation-style re-anchor that makes their mirrored prefixes
   byte-compatible with the new leader's log.
6. **Re-point serving.** ``ReadTier.promote`` swings the leader
   fallback; the tier handle's ``rebind()`` revives the (crashed)
   ``IngestFrontend`` over the promoted scheduler. In-flight tickets
   on the dead leader already failed with ``PumpCrashed``; producers
   resubmit through the rebuilt dedup mirror, so a batch the old
   leader committed-and-shipped dedups and a batch it never committed
   folds exactly once on the new leader.

Detection is sampled, not event-driven, in the style the rest of the
control plane tests depend on: ``step(now)`` with an injectable
``clock`` and ``sampler`` runs on a fake clock with zero sleeps. A
sample reports ``committer_dead`` / ``pump_failed`` booleans and an
opaque monotone ``beat`` value (the default sampler uses the WAL's
last LSN); the coordinator derives ``leader.heartbeat_age_s`` from
beat changes and declares death after ``confirm_intervals``
*consecutive* dead samples — one healthy sample resets the streak, so
a flapping gauge can't trigger a promotion.

Drive it standalone (``step()`` / ``promote_now()``) or hand it to
``ControlPlane(failover=...)``, which steps it on the supervision
interval and records its actions alongside the other actuators.

The port's copy of ``reflow_tpu/serve/failover.py``. Its ``handle`` is
the port's :class:`~reflow_tpu_torch.serve.frontend.IngestFrontend`
(``revive(sched=...)``); the serving tier's ``rebind`` and the control
plane come with later slices. The promoted leader runs on a fresh
executor of the winner's own kind and device (``ReplicaScheduler.
promote``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.obs.registry import REGISTRY
from reflow_tpu_torch.wal.ship import SegmentShipper

__all__ = ["ElectionPolicy", "HighestHorizonElection",
           "FailoverCoordinator"]


class ElectionPolicy:
    """Pluggable leader election over replica candidates. The in-tree
    policy is deterministic (every observer picks the same winner from
    the same candidate set); a distributed-consensus implementation
    plugs in here when replicas leave the process."""

    def elect(self, candidates: List[object]):
        raise NotImplementedError


class HighestHorizonElection(ElectionPolicy):
    """Highest applied horizon wins; ties break by name (ascending).
    After the coordinator's final drain, the highest horizon holds
    every acknowledged commit window — promoting anyone else could
    lose acked writes."""

    def elect(self, candidates: List[object]):
        if not candidates:
            raise RuntimeError("leader election with no candidates: "
                               "every replica is dead or promoted")
        return min(candidates,
                   key=lambda r: (-r.published_horizon(),
                                  getattr(r, "name", "")))


class FailoverCoordinator:
    """Detect leader death, elect, promote, re-point. See the module
    docstring for the sequence.

    ``replicas`` is the candidate pool (a live list is fine — it is
    re-read at election time). ``shipper`` is the OLD leader's
    ``SegmentShipper`` (its ``wal`` is what gets fenced; None for
    pure election tests). ``handle`` is the tier ``GraphHandle`` (or a
    bare ``IngestFrontend``) whose ingestion gets re-bound;
    ``read_tier`` the ``ReadTier`` whose leader fallback follows.
    ``promote_fn(winner, epoch)`` overrides the actual promotion —
    fake-clock tests stub it and assert on the decision logic alone.
    ``durable_kw`` forwards to ``ReplicaScheduler.promote`` (``fsync=``,
    ``committer=``, ...).
    """

    def __init__(self, replicas, *, shipper: Optional[SegmentShipper] = None,
                 handle=None, read_tier=None,
                 election: Optional[ElectionPolicy] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 confirm_intervals: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 sampler: Optional[Callable[[float], Dict]] = None,
                 promote_fn: Optional[Callable] = None,
                 durable_kw: Optional[Dict] = None,
                 drain_timeout_s: float = 3.0,
                 name: str = "failover"):
        if confirm_intervals < 1:
            raise ValueError("confirm_intervals must be >= 1")
        self.replicas = replicas
        self.shipper = shipper
        self.handle = handle
        self.read_tier = read_tier
        self.election = election if election is not None \
            else HighestHorizonElection()
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.confirm_intervals = confirm_intervals
        self.drain_timeout_s = drain_timeout_s
        self.name = name
        self._clock = clock
        self._sampler = sampler
        self._promote_fn = promote_fn
        self._durable_kw = dict(durable_kw or {})
        wal = shipper.wal if shipper is not None else None
        self._epoch = wal.epoch if wal is not None else 0
        self.heartbeat_age_s = 0.0
        self._last_beat = None
        self._beat_at: Optional[float] = None
        self._dead_streak = 0
        self._pending_rebind = False
        #: set by a successful promotion
        self.winner = None
        self.leader_sched = None
        self.new_shipper: Optional[SegmentShipper] = None
        self.promotions = 0
        self.drained_bytes = 0
        self.partitions_detected = 0
        self._metric_names: List[tuple] = []

    # -- detection ---------------------------------------------------------

    @property
    def epoch(self) -> int:
        """The epoch this coordinator believes is current."""
        return self._epoch

    @property
    def promoted(self) -> bool:
        return self.leader_sched is not None

    def _default_sample(self) -> Dict:
        wal = self.shipper.wal if self.shipper is not None else None
        fe = self.handle
        if fe is not None:
            fe = getattr(fe, "frontend", fe)
        committer_dead = (wal is not None
                          and wal.committer_error is not None)
        # every wire-attached follower unreachable while the committer
        # still runs: the leader is cut off from its replicas — a
        # partition, not a death (step() labels it "leader_partitioned")
        conn_states = []
        if self.shipper is not None:
            with self.shipper._lock:
                states = list(self.shipper._followers.values())
            conn_states = [getattr(st.follower, "conn_state", None)
                           for st in states]
            conn_states = [s for s in conn_states if s is not None]
        return {
            "committer_dead": committer_dead,
            "pump_failed": (fe is not None
                            and getattr(fe, "_state", None) == "failed"),
            "beat": wal.last_lsn() if wal is not None else None,
            "partitioned": (bool(conn_states) and not committer_dead
                            and all(s == "unreachable"
                                    for s in conn_states)),
        }

    def step(self, now: Optional[float] = None) -> List[Dict]:
        """One detect-and-maybe-act pass; returns this tick's actions
        (``ControlPlane`` merges them into its action log). After a
        promotion this only retries a still-pending ingestion rebind
        — the coordinator is single-fire; a failure of the NEW leader
        is a fresh coordinator's job (over ``new_shipper`` and the
        surviving replicas)."""
        now = self._clock() if now is None else now
        actions: List[Dict] = []
        if self.promoted:
            if self._pending_rebind and self._try_rebind():
                self._pending_rebind = False
                actions.append({"now": now, "kind": "failover_rebind",
                                "epoch": self._epoch})
            return actions
        sample = (self._sampler(now) if self._sampler is not None
                  else self._default_sample())
        beat = sample.get("beat")
        if self._beat_at is None or beat != self._last_beat:
            self._last_beat, self._beat_at = beat, now
        self.heartbeat_age_s = max(0.0, now - self._beat_at)
        dead = bool(sample.get("committer_dead")
                    or sample.get("pump_failed"))
        reason = ("committer_dead" if sample.get("committer_dead")
                  else "pump_failed")
        if not dead and sample.get("partitioned"):
            # the sampler can see the leader process alive but its
            # links dark (e.g. every shipping client unreachable):
            # "leader partitioned", not "leader dead". Same debounced
            # promotion — the epoch fence, not the drain, is what
            # protects the timeline from the isolated ex-leader.
            dead, reason = True, "leader_partitioned"
        if (not dead and self.heartbeat_timeout_s is not None
                and self.heartbeat_age_s > self.heartbeat_timeout_s):
            # beats stopped arriving: with positive evidence that the
            # committer still runs, that is a partition; without it we
            # can only call the stall itself
            dead = True
            reason = ("leader_partitioned" if sample.get("committer_alive")
                      else "heartbeat_timeout")
        if not dead:
            self._dead_streak = 0  # one healthy sample resets the streak
            return actions
        self._dead_streak += 1
        if self._dead_streak < self.confirm_intervals:
            return actions
        if reason == "leader_partitioned":
            self.partitions_detected += 1
        actions.extend(self.promote_now(now, reason=reason))
        return actions

    # -- the actuator ------------------------------------------------------

    def promote_now(self, now: Optional[float] = None, *,
                    reason: str = "manual") -> List[Dict]:
        """Run the failover end to end (also the operator's forced-
        promotion entry — see docs/guide.md "Leader failover").
        Idempotent: a second call returns no actions."""
        if self.promoted:
            return []
        now = self._clock() if now is None else now
        t0 = time.perf_counter()
        # 1. final drain: ship every synced byte the dead leader will
        # ever produce, so the election sees every acknowledged window
        drained = 0
        old_had_thread = False
        old_wal = None
        if self.shipper is not None:
            old_wal = self.shipper.wal
            old_had_thread = self.shipper._thread is not None
            # PATIENT drain: a remote follower mid-reconnect-backoff
            # reports zero progress for whole passes without being
            # done, so "no bytes moved" alone must not end the drain —
            # only "everyone reached the watermark" (fully_shipped) or
            # the deadline may. The deadline is real time on purpose:
            # it bounds waiting on real links, and fake-clock tests
            # stub the shipper out entirely.
            deadline = time.monotonic() + max(0.0, self.drain_timeout_s)
            try:
                while True:
                    got = self.shipper.pump_once()
                    drained += got
                    if got:
                        continue
                    if self.shipper.fully_shipped() \
                            or time.monotonic() >= deadline:
                        break
                    time.sleep(0.005)
            except Exception:  # noqa: BLE001 - a dead leader's disk may
                pass           # be gone too; promote from what shipped
            self.shipper.stop()
        self.drained_bytes = drained
        # 2. fence: from here every zombie append raises FencedWrite
        new_epoch = self._epoch + 1
        if old_wal is not None:
            new_epoch = max(new_epoch, old_wal.epoch + 1)
            try:
                old_wal.fence(new_epoch)
            except Exception:  # noqa: BLE001 - fencing a torn-down log
                pass           # is advisory; replicas reject by epoch
        # 3. elect (deterministic; see HighestHorizonElection)
        candidates = [r for r in self.replicas
                      if not getattr(r, "promoted", False)]
        winner = self.election.elect(candidates)
        if _trace.ENABLED:
            _trace.evt("failover_elect", t0, time.perf_counter() - t0,
                       track="failover",
                       args={"winner": getattr(winner, "name", "?"),
                             "epoch": new_epoch, "reason": reason,
                             "drained_bytes": drained,
                             "horizons": {
                                 getattr(r, "name", str(i)):
                                     r.published_horizon()
                                 for i, r in enumerate(candidates)}})
        # 4. promote (emits the failover_replay span)
        if self._promote_fn is not None:
            sched = self._promote_fn(winner, new_epoch)
        else:
            sched = winner.promote(epoch=new_epoch, **self._durable_kw)
        self.winner = winner
        self.leader_sched = sched
        self._epoch = new_epoch
        self.promotions += 1
        # 5. new shipper; survivors re-anchor and re-subscribe
        wal = getattr(sched, "wal", None)
        if wal is not None and self.shipper is not None:
            self.new_shipper = SegmentShipper(
                wal, ckpt_dir=getattr(winner, "ckpt_dir", None),
                leader_tick=lambda: sched._tick,
                poll_s=self.shipper.poll_s,
                max_chunk_bytes=self.shipper.max_chunk_bytes)
            for r in self.replicas:
                if r is winner or getattr(r, "promoted", False):
                    continue
                r.reanchor(new_epoch)
                self.new_shipper.attach(r)
            if old_had_thread:
                self.new_shipper.start()
        # 6. re-point reads and ingestion
        if self.read_tier is not None:
            self.read_tier.promote(winner, epoch=new_epoch)
        rebound = self._try_rebind()
        self._pending_rebind = self.handle is not None and not rebound
        return [{"now": now, "kind": "failover_promote",
                 "winner": getattr(winner, "name", "?"),
                 "epoch": new_epoch, "reason": reason,
                 "drained_bytes": drained, "rebound": rebound}]

    def _try_rebind(self) -> bool:
        """Revive the ingestion frontend over the new leader. Fails
        (and is retried each step) until the pump has actually crashed
        — a committer-dead leader whose pump hasn't hit the WAL yet is
        still ``"running"``, and ``revive()`` refuses to re-arm a
        frontend that never settled."""
        if self.handle is None:
            return True
        if self.leader_sched is None:
            return False
        try:
            fn = getattr(self.handle, "rebind", None)
            if fn is not None:
                fn(self.leader_sched)
            else:
                self.handle.revive(sched=self.leader_sched)
            return True
        except GraphError:
            return False

    # -- observability -----------------------------------------------------

    def publish_metrics(self, registry=None) -> None:
        reg = registry if registry is not None else REGISTRY

        def _rejected_appends() -> int:
            wal = self.shipper.wal if self.shipper is not None else None
            return wal.fence_rejected_appends if wal is not None else 0

        reg.gauge("failover.epoch", lambda: self._epoch)
        reg.gauge("failover.promotions_total", lambda: self.promotions)
        reg.gauge("failover.partitions_detected",
                  lambda: self.partitions_detected)
        reg.gauge("leader.heartbeat_age_s", lambda: self.heartbeat_age_s)
        reg.gauge("fence.rejected_appends", _rejected_appends)
        reg.gauge("fence.rejected_shipments",
                  lambda: sum(getattr(r, "fence_rejected_shipments", 0)
                              for r in self.replicas))
        self._metric_names += [(reg, "failover."),
                               (reg, "leader.heartbeat_age_s"),
                               (reg, "fence.")]

    def close(self) -> None:
        if self.new_shipper is not None:
            self.new_shipper.stop()
        for reg, base in self._metric_names:
            reg.unregister_prefix(base)
        self._metric_names.clear()
