"""Read replicas: continuous WAL tail replay at a published tick horizon.

A :class:`ReplicaScheduler` is the follower end of the WAL shipping
protocol (``wal/ship.py``). It mirrors the leader's CRC-framed segments
into a local directory, replays them through the exact idempotent
machinery crash recovery already trusts (``wal.recovery.replay_records``
— a replayed push dedups by batch id, a replayed tick below the counter
is skipped), and publishes a **tick horizon**: reads are answered from
a snapshot of the sink views as of a whole number of commit windows.
Readers never see half a window.

Three invariants carry the design:

- **Holdback**: shipped records are staged and applied only through the
  *last tick marker* received. Pushes past it — a commit window still in
  flight — touch nothing, not even the pending buffers, until their
  marker arrives. A torn or tampered shipment is therefore rejected
  whole (NACK with the replica's authoritative cursor) and a partial
  commit window is never applied, no matter where the transport died.
- **Restart-resume**: the replica checkpoints its own scheduler state
  (stamping the applied WAL position into ``meta.pkl``, exactly the
  contract ``recover()`` reads) and persists its ship cursor next to the
  checkpoint. A restart restores checkpoint + mirrored tail and
  re-subscribes from where it left off — never from segment 0.
- **Immutable read snapshots**: each published horizon lazily
  materializes per-sink arrays (keys + weights) that are never mutated
  afterward, so ``top_k`` is a lock-free ``np.argpartition`` over frozen
  numpy buffers — reads scale with replica count instead of serializing
  on the leader's live, mutable views.

``promote()`` turns a follower into a leader: the staged (unapplied)
tail is truncated out of the mirror, a ``DurableScheduler`` opens the
mirror directory as its own WAL in a **new epoch**, and ``recover()``
replays the mirrored prefix — so the new leader's state is exactly the
replica's published horizon, rebuilt through the same machinery crash
recovery trusts. Shipments from an older epoch are NACKed with a
``fenced`` reason and never mirrored; ``reanchor()`` is the surviving
followers' half of a failover (drop holdback, truncate to the apply
point, adopt the new epoch, re-subscribe). The election and serving
re-bind live in ``serve/failover.py``.

The port's copy of ``reflow_tpu/serve/replica.py``. The cursor file is
the JAX package's (``reflow.replica_cursor/1``) and the mirror holds the
leader's segments byte for byte, so a replica of either package follows
a leader of the other from a segment start. Its own checkpoints are the
port's (array states by ``torch.save``). On the card the replica runs
the port's ``"cuda"`` executor: a k-NN replica replays each shipped
window through the hand-written top-k (``topk`` on insert ticks,
``topk_merge`` on rescans). Its launches go to the device's current
stream, which is the legacy default stream in every host thread (PyTorch
turns on no per-thread default stream), so a replay driven from the
shipper's thread is ordered with the leader's pump and every other
launch on that card; reads take the replica's lock and read back
synchronously. ``promote()`` builds the new leader on a fresh executor
of the replica's own kind and device (``Executor.fresh``), never on the
CPU oracle by default.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np

from reflow_tpu_torch.obs import flight as _flight
from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.obs.registry import REGISTRY
from reflow_tpu_torch.scheduler import DirtyScheduler
from reflow_tpu_torch.utils import tiles as _t
from reflow_tpu_torch.utils.config import env_int
from reflow_tpu_torch.utils.runtime import named_lock
from reflow_tpu_torch.wal.log import (_MAGIC, LogPosition, WalError,
                                      _repair_tail, _seg_path, list_segments)
from reflow_tpu_torch.wal.recovery import replay_records
from reflow_tpu_torch.wal.ship import (ShipAck, Shipment, ShipNack,
                                       iter_frames, record_causes)

__all__ = ["ReplicaScheduler", "CURSOR_FILE", "TILE_UNIT_SCHEMA"]

CURSOR_FILE = "cursor.json"
CURSOR_SCHEMA = "reflow.replica_cursor/1"
#: one checkpoint file shipped as an independently CRC-framed unit
#: (wal/ship.py ``_bootstrap_tiles`` <-> ``receive_ckpt_tile``)
TILE_UNIT_SCHEMA = "reflow.tile_ship/1"
#: staging directory for an in-flight tile-unit bootstrap transfer
_STAGE_DIR = "bootstrap-ckpt"


class _Snapshot(NamedTuple):
    """Frozen per-sink read state at one published horizon. ``keys`` and
    ``weights`` are never mutated after construction: ``top_k`` runs
    ``np.argpartition`` on them without holding any lock."""

    horizon: int
    keys: List[tuple]
    weights: np.ndarray
    #: per-row scalar values, when the sink's values are numeric (the
    #: unique-keyed aggregate case, e.g. wordcount's (word, count) rows
    #: at weight 1) — None for non-numeric payloads
    values: Optional[np.ndarray]
    index: Dict[tuple, float]


class _Tile(NamedTuple):
    """One immutable key-range shard of a tiled snapshot. ``gen`` is the
    content generation: it bumps only when the tile is rebuilt, so two
    horizons sharing a gen share the *same* array objects (zero-copy
    reuse for untouched key ranges — the BENCH_r02 preload fix)."""

    lo: int
    hi: int
    gen: int
    keys: List[tuple]
    weights: np.ndarray
    values: Optional[np.ndarray]
    index: Dict[tuple, float]


class _TileSnap(NamedTuple):
    """Frozen tiled read state at one published horizon: a bucket-range
    plan plus one :class:`_Tile` per range. ``top_k`` argpartitions each
    tile and merges at most k candidates per tile; the full state is
    never concatenated into one array."""

    horizon: int
    plan: Tuple[Tuple[int, int], ...]
    tiles: Tuple[_Tile, ...]


def _row_bytes(kv) -> int:
    """Histogram estimate for one view row ``(key, value)``."""
    if isinstance(kv, tuple) and len(kv) == 2:
        return _t.approx_row_bytes(kv[0], kv[1])
    return _t.approx_row_bytes(kv, None)


class ReplicaScheduler:
    """A follower that replays shipped WAL windows into its own
    ``DirtyScheduler`` and serves snapshot reads at a published horizon.

    ``replica_dir`` holds everything the replica needs to resume:
    ``wal/`` (the mirrored leader segments), ``ckpt/`` (its own
    checkpoints) and ``cursor.json`` (the ship cursor, leader
    coordinates). Build it with the same graph the leader runs;
    ``executor=None`` gives the CPU oracle, ``get_executor("cuda")`` a
    replica on the card — views are host Counters either way."""

    def __init__(self, graph, replica_dir: str, *, executor=None,
                 name: Optional[str] = None,
                 tile_bytes: Optional[int] = None) -> None:
        self.graph = graph
        self.replica_dir = replica_dir
        self.mirror_dir = os.path.join(replica_dir, "wal")
        self.ckpt_dir = os.path.join(replica_dir, "ckpt")
        os.makedirs(self.mirror_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.name = name or (os.path.basename(os.path.normpath(replica_dir))
                             or "replica")
        self.sched = DirtyScheduler(graph, executor)
        self._lock = named_lock(f"serve.replica.{self.name}", reentrant=True)
        #: parsed-but-unapplied records (the holdback buffer): entries
        #: are (pos, end_pos, record); only a suffix past the last
        #: applied tick marker ever lives here
        self._staged: List[Tuple[LogPosition, LogPosition, dict]] = []
        self._cursor: Optional[LogPosition] = None   # next byte expected
        self._applied: Optional[LogPosition] = None  # end of last applied
        self._horizon = 0
        self._leader_tick = 0
        self._snapshots: Dict[str, _Snapshot] = {}
        #: highest epoch witnessed (shipment header or mirrored record);
        #: shipments below it are fenced out before a byte is mirrored
        self._epoch = 0
        self._promoted_sched = None
        self.shipments = 0
        self.records_applied = 0
        self.windows_applied = 0
        self.crc_rejects = 0
        self.order_rejects = 0
        self.fence_rejected_shipments = 0
        self.bootstraps = 0
        self.restored_from: Optional[str] = None
        self._metric_names: List[Tuple[object, str]] = []
        #: optional SubscriptionHub fed by _apply_staged (attach_hub)
        self._hub = None
        #: snapshot tiling budget; 0 (the default) keeps the monolithic
        #: per-sink snapshot arrays byte-for-byte unchanged
        self.tile_bytes = env_int("REFLOW_TILE_BYTES") \
            if tile_bytes is None else int(tile_bytes)
        #: per-sink dirty bucket sets since that sink's last snapshot
        #: build; a ``None`` value means "everything dirty" (rebase,
        #: bootstrap, unreliable history) and forces a full rebuild
        self._dirty: Dict[str, Optional[Set[int]]] = {}
        self.snapshot_tile_builds = 0
        self.snapshot_tiles_reused = 0
        #: unit indices staged for the in-flight tile bootstrap transfer
        self._tile_units_seen: Set[int] = set()
        self.tile_units_received = 0
        self._restore()

    # -- transport surface (the watermark handshake) -----------------------

    def subscribe(self) -> Optional[Tuple[int, int]]:
        """The replica's persisted resume cursor in leader coordinates,
        or None for a fresh replica (the shipper then bootstraps)."""
        with self._lock:
            return tuple(self._cursor) if self._cursor is not None else None

    def attach_hub(self, hub) -> None:
        """Wire a :class:`~reflow_tpu_torch.subs.hub.SubscriptionHub`
        into the apply path: each applied commit window is handed off as
        ``hub.on_window(from_h, to_h, tick_results)`` (O(1), the hub's
        own thread does the fan-out) and non-monotonic state moves
        (bootstrap/promote/reanchor) call ``hub.rebase()``. Pass None
        to detach."""
        with self._lock:
            self._hub = hub
        if hub is not None:
            hub.rebase()   # start from a fresh snapshot of current state

    def bootstrap(self, ckpt_dir: str) -> Tuple[int, int]:
        """Checkpoint-anchored catch-up: load the *leader's* checkpoint
        and resume shipping from its recorded WAL position — always a
        segment start, so leader and mirror coordinates agree on every
        byte after it. Immediately re-checkpoints locally so a restart
        never needs the leader's files again."""
        from reflow_tpu_torch.utils.checkpoint import load_checkpoint

        with self._lock:
            meta = load_checkpoint(self.sched, ckpt_dir)
            pos = meta.get("wal_pos")
            if pos is None:
                raise WalError(f"{ckpt_dir}: leader checkpoint has no "
                               f"wal_pos — cannot anchor a replica on it")
            self._cursor = LogPosition(*pos)
            self._applied = self._cursor
            self._horizon = self.sched._tick
            self._staged.clear()
            self._snapshots = {}
            self._dirty = dict.fromkeys(self.sched.sink_views, None)
            self.bootstraps += 1
        self.checkpoint()
        if self._hub is not None:
            self._hub.rebase()   # state moved non-monotonically
        return tuple(self._cursor)

    def receive(self, sh: Shipment):
        """Verify, mirror, stage and (window-complete) apply one
        shipment. Returns :class:`ShipAck` with the advanced cursor and
        the new horizon, or :class:`ShipNack` carrying the replica's
        authoritative cursor for the shipper to resume from."""
        t0 = time.perf_counter()
        with self._lock:
            self.shipments += 1
            ep = getattr(sh, "epoch", 0)
            if ep < self._epoch:
                # a zombie ex-leader kept shipping: refuse before a
                # single byte is mirrored or staged
                self.fence_rejected_shipments += 1
                if _trace.ENABLED:
                    _trace.evt("fence_reject", t0,
                               time.perf_counter() - t0,
                               track=f"replica/{self.name}",
                               args={"kind": "shipment", "epoch": ep,
                                     "fenced_by": self._epoch,
                                     "segment": sh.segment})
                # a fence is exactly the moment this process may not
                # outlive — get the evidence onto disk now
                _flight.note("fence_reject", epoch=ep,
                             fenced_by=self._epoch, segment=sh.segment)
                return ShipNack(
                    tuple(self._cursor) if self._cursor else None,
                    f"fenced: shipment epoch {ep} < replica epoch "
                    f"{self._epoch}")
            if ep > self._epoch:
                self._epoch = ep
            cur = self._cursor
            if cur is None:
                # an unanchored fresh replica may only start at a
                # segment's first frame
                if sh.offset != len(_MAGIC):
                    self.order_rejects += 1
                    return ShipNack(None, "fresh replica needs a segment "
                                          "start")
                cur = LogPosition(sh.segment, sh.offset)
            if (sh.segment, sh.offset) != tuple(cur):
                self.order_rejects += 1
                return ShipNack(tuple(cur),
                                f"out of order: expected {tuple(cur)}, "
                                f"got {(sh.segment, sh.offset)}")
            entries, valid, reason = iter_frames(sh.payload, sh.segment,
                                                 sh.offset)
            if valid != len(sh.payload) \
                    or sh.offset + valid != sh.end_offset:
                # reject the shipment whole: nothing mirrored, nothing
                # staged, cursor unmoved — the shipper re-reads from it
                self.crc_rejects += 1
                return ShipNack(tuple(cur),
                                reason or "end_offset mismatch")
            self._mirror_append(sh)
            self._staged.extend(entries)
            applied = self._apply_staged()
            if sh.seals:
                nxt = (sh.next_segment if sh.next_segment is not None
                       else sh.segment + 1)
                self._cursor = LogPosition(nxt, len(_MAGIC))
            else:
                self._cursor = LogPosition(sh.segment, sh.end_offset)
            self._leader_tick = max(self._leader_tick, sh.leader_tick)
            self._persist_cursor()
            ack = ShipAck(tuple(self._cursor), self._horizon)
        if _trace.ENABLED:
            causes: List[str] = []
            for _p, _e, r in entries:
                for c in record_causes(r):
                    if c not in causes:
                        causes.append(c)
            _trace.evt("replica_replay", t0, time.perf_counter() - t0,
                       track=f"replica/{self.name}",
                       args={"segment": sh.segment, "bytes": len(sh.payload),
                             "records": len(entries), "applied": applied,
                             "horizon": ack.horizon,
                             "cause": getattr(sh, "cause", None),
                             "causes": causes,
                             "lag_ticks": self.lag_ticks()})
        return ack

    def _mirror_append(self, sh: Shipment) -> None:
        path = _seg_path(self.mirror_dir, sh.segment)
        if not os.path.exists(path):
            if sh.offset != len(_MAGIC):
                raise WalError(f"mirror gap: shipment for "
                               f"wal-{sh.segment:08d}.log @ {sh.offset} "
                               f"but no local segment")
            with open(path, "wb") as f:
                f.write(_MAGIC)
        size = os.path.getsize(path)
        if size > sh.offset:
            # an acked-but-forgotten overlap (shipper resumed behind us
            # after a NACK storm): drop our unacked surplus and re-land
            with open(path, "rb+") as f:
                f.truncate(sh.offset)
        elif size < sh.offset:
            raise WalError(f"mirror gap: wal-{sh.segment:08d}.log is "
                           f"{size} bytes, shipment starts at {sh.offset}")
        with open(path, "ab") as f:
            f.write(sh.payload)
            f.flush()

    def _apply_staged(self) -> int:
        """Apply staged records through the LAST tick marker; everything
        past it stays held back. Returns records applied."""
        last = None
        for i in range(len(self._staged) - 1, -1, -1):
            if self._staged[i][2].get("kind") == "tick":
                last = i
                break
        if last is None:
            return 0
        window = self._staged[:last + 1]
        del self._staged[:last + 1]
        hist0 = len(self.sched.history)
        from_h = self._horizon
        _rep, _ded, ticks, _skip = replay_records(
            self.sched, [(p, r) for p, _e, r in window])
        self.records_applied += len(window)
        self.windows_applied += ticks
        self._applied = window[-1][1]
        self._horizon = self.sched._tick
        results = tuple(self.sched.history[hist0:])
        reliable = len(results) == self._horizon - from_h
        if self.tile_bytes > 0:
            if reliable:
                # accumulate dirty buckets from the window's columnar
                # deltas: the next snapshot build rebuilds only tiles
                # owning a touched bucket and reuses the rest by identity
                for res in results:
                    for sname, d in res.sink_deltas.items():
                        cur = self._dirty.get(sname, set())
                        if cur is None:
                            continue  # already all-dirty
                        for kk, vv, _w in d.rows():
                            cur.add(_t.bucket_of((kk, vv)))
                        self._dirty[sname] = cur
            else:
                # restored state or trimmed history — per-key deltas
                # can't be trusted; next build starts from scratch
                self._dirty = dict.fromkeys(self.sched.sink_views, None)
            # keep stale tiled snapshots: they seed zero-copy reuse
            self._snapshots = {n: s for n, s in self._snapshots.items()
                               if isinstance(s, _TileSnap)}
        else:
            self._snapshots = {}
        hub = self._hub
        if hub is not None and self._horizon > from_h:
            if reliable:
                causes: List[str] = []
                if _trace.ENABLED:
                    for _p, _e, r in window:
                        for c in record_causes(r):
                            if c not in causes:
                                causes.append(c)
                # O(1) hand-off: the hub's fan-out thread does the work
                if causes:
                    hub.on_window(from_h, self._horizon, results,
                                  causes=tuple(causes))
                else:
                    hub.on_window(from_h, self._horizon, results)
            else:
                # replay didn't tick one-for-one (restored state or a
                # trimmed history) — deltas can't be trusted; re-snapshot
                hub.rebase()
        return len(window)

    # -- persistence -------------------------------------------------------

    def _persist_cursor(self) -> None:
        state = {
            "schema": CURSOR_SCHEMA,
            "cursor": list(self._cursor) if self._cursor else None,
            "applied": list(self._applied) if self._applied else None,
            "horizon": self._horizon,
            "leader_tick": self._leader_tick,
        }
        path = os.path.join(self.replica_dir, CURSOR_FILE)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, path)
        except OSError:
            pass  # advisory: restart re-derives the cursor from disk

    def checkpoint(self) -> str:
        """Checkpoint the replica's own scheduler state, stamping the
        applied WAL position into the meta so a restart resumes replay
        exactly where reads last saw — the same ``wal_pos`` contract
        ``recover()`` uses, written by hand because a replica's plain
        scheduler has no WAL of its own to rotate."""
        from reflow_tpu_torch.utils.checkpoint import save_checkpoint

        with self._lock:
            save_checkpoint(self.sched, self.ckpt_dir)
            meta_path = os.path.join(self.ckpt_dir, "meta.pkl")
            with open(meta_path, "rb") as f:
                meta = pickle.load(f)
            pos = self._applied if self._applied is not None \
                else self._cursor
            if pos is not None:
                meta["wal_pos"] = tuple(pos)
            tmp = meta_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(meta, f)
                f.flush()
                # reflow-lint: waive lock-blocking-call -- checkpoint-meta fsync on the replica's own apply thread; readers never park on this lock mid-read (horizon snapshot is taken before)
                os.fsync(f.fileno())
            os.replace(tmp, meta_path)
            self._persist_cursor()
        return self.ckpt_dir

    def _restore(self) -> None:
        """Restart-resume: local checkpoint (if any) + mirrored tail.
        The cursor comes out at the end of the mirror's valid prefix —
        never segment 0 unless the replica truly is fresh."""
        from reflow_tpu_torch.utils.checkpoint import (checkpoint_exists,
                                                       load_checkpoint)

        start: Optional[Tuple[int, int]] = None
        if checkpoint_exists(self.ckpt_dir):
            meta = load_checkpoint(self.sched, self.ckpt_dir)
            start = meta.get("wal_pos")
            self._horizon = self.sched._tick
            self.restored_from = "checkpoint"
        segs = list_segments(self.mirror_dir)
        if segs:
            # a kill mid-append leaves a torn mirror tail; drop it (the
            # shipper re-sends from our recomputed cursor)
            _repair_tail(segs[-1][1], segs[-1][0])
            segs = list_segments(self.mirror_dir)
        cursor = LogPosition(*start) if start is not None else None
        self._applied = cursor
        had_ckpt = self.restored_from == "checkpoint"
        had_tail = False
        for seq, path in segs:
            if start is not None and seq < start[0]:
                continue
            with open(path, "rb") as f:
                data = f.read()
            if data[:len(_MAGIC)] != _MAGIC:
                continue
            entries, _valid, _reason = iter_frames(
                data[len(_MAGIC):], seq, len(_MAGIC))
            for p, e, r in entries:
                # mirrored records carry their writer's epoch: a restart
                # resumes already knowing the highest epoch it witnessed,
                # so a zombie's shipments stay fenced across restarts
                self._epoch = max(self._epoch, r.get("epoch", 0) or 0)
                if start is not None and p.segment == start[0] \
                        and p.offset < start[1]:
                    continue
                self._staged.append((p, e, r))
                cursor = e if cursor is None or e > cursor else cursor
            had_tail = had_tail or bool(entries)
        if had_tail:
            self.restored_from = "checkpoint+tail" if had_ckpt else "tail"
        if self._staged:
            self._apply_staged()
        # NOTE: cursor.json is deliberately NOT consulted here — it can
        # run AHEAD of a torn mirror tail (persisted, then the appended
        # bytes died with the process), and resuming past bytes the
        # mirror lost would skip records forever. Checkpoint + mirror
        # walk is always sufficient: bootstrap checkpoints immediately,
        # so the persisted wal_pos anchors every resume.
        self._cursor = cursor
        self._horizon = self.sched._tick

    # -- read surface ------------------------------------------------------

    def published_horizon(self) -> int:
        """Tick counter as of the last fully-applied commit window."""
        return self._horizon

    def lag_ticks(self) -> int:
        """Published horizon's distance behind the leader tick last seen
        on a shipment (0 when fully caught up)."""
        return max(0, self._leader_tick - self._horizon)

    def _snapshot(self, sink):
        name = sink if isinstance(sink, str) else sink.name
        snap = self._snapshots.get(name)
        h = self._horizon
        if snap is not None and snap.horizon == h:
            return snap
        if self.tile_bytes > 0:
            return self._snapshot_tiled(name)
        with self._lock:
            snap = self._snapshots.get(name)
            if snap is None or snap.horizon != self._horizon:
                view = self.sched.sink_views[name]
                items = [(kv, w) for kv, w in view.items() if w != 0]
                try:
                    values = np.asarray([kv[1] for kv, _ in items],
                                        dtype=np.float64)
                except (TypeError, ValueError, IndexError):
                    values = None
                if values is not None and values.ndim != 1:
                    values = None
                snap = _Snapshot(
                    self._horizon,
                    [kv for kv, _ in items],
                    np.asarray([w for _, w in items], dtype=np.float64),
                    values,
                    dict(items))
                self._snapshots[name] = snap
        return snap

    # -- tiled snapshots (REFLOW_TILE_BYTES > 0) ---------------------------

    @staticmethod
    def _build_tile(items, lo: int, hi: int, gen: int) -> _Tile:
        try:
            values = np.asarray([kv[1] for kv, _ in items],
                                dtype=np.float64)
        except (TypeError, ValueError, IndexError):
            values = None
        if values is not None and values.ndim != 1:
            values = None
        return _Tile(lo, hi, gen,
                     [kv for kv, _ in items],
                     np.asarray([w for _, w in items], dtype=np.float64),
                     values, dict(items))

    def _build_all_tiles(self, view, h: int) -> _TileSnap:
        """Full build: histogram the live view into buckets, plan tiles
        under the budget, materialize each tile once."""
        buckets: List[list] = [[] for _ in range(_t.N_BUCKETS)]
        bbytes = [0.0] * _t.N_BUCKETS
        for kv, w in view.items():
            if w == 0:
                continue
            b = _t.bucket_of(kv)
            buckets[b].append((kv, w))
            bbytes[b] += _row_bytes(kv)
        plan = tuple(_t.plan_tiles(bbytes, self.tile_bytes))
        tiles = []
        for lo, hi in plan:
            items = [it for b in range(lo, hi) for it in buckets[b]]
            tiles.append(self._build_tile(items, lo, hi, 1))
            self.snapshot_tile_builds += 1
        return _TileSnap(h, plan, tuple(tiles))

    def _snapshot_tiled(self, name: str) -> _TileSnap:
        with self._lock:
            snap = self._snapshots.get(name)
            h = self._horizon
            if isinstance(snap, _TileSnap) and snap.horizon == h:
                return snap
            view = self.sched.sink_views[name]
            prev = snap if isinstance(snap, _TileSnap) else None
            dirty = self._dirty.get(name, set())
            if prev is None or dirty is None:
                snap = self._build_all_tiles(view, h)
            elif not dirty:
                # no delta touched this sink: every tile reused as-is
                self.snapshot_tiles_reused += len(prev.tiles)
                snap = prev._replace(horizon=h)
            else:
                snap = self._rebuild_dirty(view, h, prev, dirty)
            self._dirty[name] = set()
            self._snapshots[name] = snap
            return snap

    def _rebuild_dirty(self, view, h: int, prev: _TileSnap,
                       dirty: Set[int]) -> _TileSnap:
        """Rebuild only the tiles owning a dirty bucket; clean tiles are
        carried over by identity (same array objects, same gen)."""
        dirty_tiles = {i for i, (lo, hi) in enumerate(prev.plan)
                       if any(lo <= b < hi for b in dirty)}
        if not dirty_tiles:
            self.snapshot_tiles_reused += len(prev.tiles)
            return prev._replace(horizon=h)
        per: Dict[int, list] = {i: [] for i in dirty_tiles}
        est: Dict[int, float] = {i: 0.0 for i in dirty_tiles}
        for kv, w in view.items():
            if w == 0:
                continue
            i = _t.owning_tile(prev.plan, _t.bucket_of(kv))
            if i in per:
                per[i].append((kv, w))
                est[i] += _row_bytes(kv)
        for i in dirty_tiles:
            lo, hi = prev.plan[i]
            if est[i] > 2 * self.tile_bytes and hi - lo > 1:
                # a rebuilt tile blew past the enforced bound and can
                # still be split — replan the whole sink
                return self._build_all_tiles(view, h)
        tiles = list(prev.tiles)
        for i in dirty_tiles:
            lo, hi = prev.plan[i]
            tiles[i] = self._build_tile(per[i], lo, hi,
                                        prev.tiles[i].gen + 1)
            self.snapshot_tile_builds += 1
        self.snapshot_tiles_reused += len(prev.tiles) - len(dirty_tiles)
        return _TileSnap(h, prev.plan, tuple(tiles))

    def _top_k_tiled(self, snap: _TileSnap, k: int, by: str):
        if by not in ("weight", "value"):
            raise ValueError(f"by={by!r}: expected 'weight' or 'value'")
        cands: List[Tuple[float, tuple, float]] = []
        for t in snap.tiles:
            n = len(t.keys)
            if n == 0:
                continue
            if by == "value":
                if t.values is None:
                    raise ValueError(
                        f"sink has non-numeric values; "
                        f"top_k(by='value') needs scalars")
                rank = t.values
            else:
                rank = t.weights
            kk = min(int(k), n)
            idx = np.argpartition(rank, n - kk)[n - kk:]
            for i in idx:
                cands.append((float(rank[i]), t.keys[int(i)],
                              float(t.weights[i])))
        cands.sort(key=lambda c: c[0], reverse=True)
        return (max(snap.horizon, 0),
                [(key, w) for _r, key, w in cands[:int(k)]])

    def top_k(self, sink, k: int, *, by: str = "weight",
              ) -> Tuple[int, List[Tuple[tuple, float]]]:
        """Top ``k`` sink entries at the snapshot's horizon:
        ``(horizon, [((key, value), weight), ...])`` descending.
        ``by="weight"`` ranks by multiset weight; ``by="value"`` ranks
        by the row's scalar value — the natural order for unique-keyed
        aggregate sinks, where the count lives in the value and every
        live row has weight 1. The hot path is a lock-free argpartition
        over frozen arrays. With ``REFLOW_TILE_BYTES`` set, each tile is
        argpartitioned independently and at most k candidates per tile
        are merged — the full state is never concatenated."""
        snap = self._snapshot(sink)
        if isinstance(snap, _TileSnap):
            return self._top_k_tiled(snap, k, by)
        n = len(snap.keys)
        if n == 0:
            return max(snap.horizon, 0), []
        if by == "value":
            if snap.values is None:
                raise ValueError(f"sink {sink!r} has non-numeric values; "
                                 f"top_k(by='value') needs scalars")
            rank = snap.values
        elif by == "weight":
            rank = snap.weights
        else:
            raise ValueError(f"by={by!r}: expected 'weight' or 'value'")
        kk = min(int(k), n)
        idx = np.argpartition(rank, n - kk)[n - kk:]
        idx = idx[np.argsort(rank[idx])[::-1]]
        return snap.horizon, [(snap.keys[int(i)], float(snap.weights[i]))
                              for i in idx]

    def lookup(self, sink, key) -> Tuple[int, float]:
        """Weight of one ``(key, value)`` sink entry at the snapshot's
        horizon (0.0 when absent). Tiled snapshots touch only the
        owning tile's index."""
        snap = self._snapshot(sink)
        if isinstance(snap, _TileSnap):
            t = snap.tiles[_t.owning_tile(snap.plan, _t.bucket_of(key))]
            return max(snap.horizon, 0), float(t.index.get(key, 0.0))
        return max(snap.horizon, 0), float(snap.index.get(key, 0.0))

    def view_at(self, sink) -> Tuple[int, Dict[tuple, float]]:
        """Full sink view copy at the snapshot's horizon — parity
        checks and small views; ``top_k`` is the scaling read."""
        snap = self._snapshot(sink)
        if isinstance(snap, _TileSnap):
            out: Dict[tuple, float] = {}
            for t in snap.tiles:
                out.update(t.index)
            return max(snap.horizon, 0), out
        return max(snap.horizon, 0), dict(snap.index)

    # -- tile-unit bootstrap (wal/ship.py _bootstrap_tiles) ----------------

    def receive_ckpt_tile(self, unit: dict) -> dict:
        """Stage one CRC-framed checkpoint unit (one file of the
        leader's checkpoint directory, tile files included) into
        ``bootstrap-ckpt/``; on the last unit, anchor on the staged
        checkpoint exactly as :meth:`bootstrap` would. Returns
        ``{"ok": True}`` per unit (plus ``"cursor"`` on the last) or
        ``{"ok": False, "reason": ...}`` — a per-unit NACK, so the
        shipper re-sends one tile, not the chain."""
        stage = os.path.join(self.replica_dir, _STAGE_DIR)
        with self._lock:
            if unit.get("schema") != TILE_UNIT_SCHEMA:
                return {"ok": False,
                        "reason": f"schema {unit.get('schema')!r}"}
            idx = int(unit.get("idx", -1))
            if idx == 0:
                # a new transfer: drop any half-staged earlier attempt
                shutil.rmtree(stage, ignore_errors=True)
                self._tile_units_seen = set()
            payload = unit.get("payload") or b""
            if (zlib.crc32(payload) & 0xFFFFFFFF) != unit.get("crc"):
                self.crc_rejects += 1
                return {"ok": False, "reason": "crc mismatch",
                        "idx": idx}
            rel = unit.get("rel") or ""
            parts = rel.replace("\\", "/").split("/")
            if not rel or os.path.isabs(rel) or ".." in parts:
                return {"ok": False, "reason": f"bad relpath {rel!r}"}
            dest = os.path.join(stage, *parts)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "wb") as f:
                f.write(payload)
            self._tile_units_seen.add(idx)
            self.tile_units_received += 1
            if not unit.get("last"):
                return {"ok": True}
            total = int(unit.get("total", 0))
            if len(self._tile_units_seen) != total:
                return {"ok": False,
                        "reason": f"incomplete transfer: "
                                  f"{len(self._tile_units_seen)}/{total} "
                                  f"units staged"}
            cursor = self.bootstrap(stage)
            shutil.rmtree(stage, ignore_errors=True)
            self._tile_units_seen = set()
            return {"ok": True, "cursor": tuple(cursor)}

    # -- failover ----------------------------------------------------------

    @property
    def epoch(self) -> int:
        """Highest epoch this replica has witnessed."""
        return self._epoch

    @property
    def promoted(self) -> bool:
        return self._promoted_sched is not None

    def _truncate_mirror_to_applied(self) -> None:
        """Drop every mirrored byte past the apply point: segments
        beyond it are deleted, the apply-point segment is cut at its
        offset. With ``_applied`` None (nothing ever applied) the whole
        mirror goes — the shipper re-bootstraps."""
        pos = self._applied
        for seq, path in list_segments(self.mirror_dir):
            if pos is None or seq > pos.segment:
                os.remove(path)
            elif seq == pos.segment:
                with open(path, "rb+") as f:
                    f.truncate(pos.offset)

    def promote(self, *, epoch: Optional[int] = None, **durable_kw):
        """Promote this follower to leader. The staged (held-back) tail
        is truncated out of the mirror — a partial commit window never
        survives a failover — then a :class:`DurableScheduler` opens the
        mirror directory as its own WAL in the new epoch (a fresh
        segment; segments are never resumed) and ``recover()`` replays
        the mirrored prefix through the replica's checkpoint. Returns
        the new leader scheduler; idempotent (a second call returns the
        same scheduler). ``durable_kw`` forwards to
        ``DurableScheduler`` (``fsync=``, ``committer=``, ...); unless it
        names an ``executor``, the new leader runs on a fresh executor of
        this replica's kind and device (``Executor.fresh``)."""
        from reflow_tpu_torch.wal.durable import DurableScheduler
        from reflow_tpu_torch.wal.recovery import recover

        t0 = time.perf_counter()
        with self._lock:
            if self._promoted_sched is not None:
                return self._promoted_sched
            new_epoch = int(epoch) if epoch is not None \
                else self._epoch + 1
            if new_epoch <= self._epoch and epoch is not None:
                raise WalError(
                    f"promote epoch {new_epoch} must exceed the "
                    f"replica's witnessed epoch {self._epoch}")
            self._staged.clear()
            self._truncate_mirror_to_applied()
            self._cursor = self._applied
            # the promotion horizon: what this replica had applied when
            # it won the election — the new leader's state is exactly it
            horizon = self._horizon
            kw = dict(durable_kw)
            if kw.get("executor") is None:
                kw["executor"] = self.sched.executor.fresh()
            sched = DurableScheduler(
                self.graph, wal_dir=self.mirror_dir,
                epoch=new_epoch, **kw)
            report = recover(sched, self.mirror_dir, self.ckpt_dir)
            self._epoch = new_epoch
            self._promoted_sched = sched
            self._persist_cursor()
        if _trace.ENABLED:
            _trace.evt("failover_replay", t0, time.perf_counter() - t0,
                       track=f"replica/{self.name}",
                       args={"epoch": new_epoch, "horizon": horizon,
                             "replayed_pushes": report.replayed_pushes,
                             "replayed_ticks": report.replayed_ticks,
                             "final_tick": report.final_tick})
        # promotion is a die-worthy moment for the flight ring: flush
        # the failover evidence before this process does anything else
        _flight.note("promote", epoch=new_epoch, horizon=horizon)
        if self._hub is not None:
            self._hub.rebase()   # subscribers re-snapshot off the leader
        return sched

    def reanchor(self, epoch: int) -> Optional[Tuple[int, int]]:
        """The surviving followers' half of a failover: drop the
        holdback buffer, truncate the mirror back to the apply point
        (bytes past it may diverge from the new leader's log), adopt the
        new epoch and return the re-anchored cursor — ready for a fresh
        ``shipper.attach``. Applied state is untouched: the apply point
        is always at or below the promotion horizon, so the new leader's
        log extends it byte-identically."""
        with self._lock:
            self._staged.clear()
            self._truncate_mirror_to_applied()
            self._cursor = self._applied
            if epoch > self._epoch:
                self._epoch = epoch
            self._persist_cursor()
            cursor = tuple(self._cursor) if self._cursor is not None \
                else None
        if self._hub is not None:
            self._hub.rebase()   # holdback dropped; re-prove via snapshot
        return cursor

    # -- lifecycle / observability -----------------------------------------

    def publish_metrics(self, registry=None,
                        name: Optional[str] = None) -> None:
        reg = registry if registry is not None else REGISTRY
        base = name or f"replica.{self.name}"
        reg.gauge(f"{base}.lag_ticks", self.lag_ticks)
        reg.gauge(f"{base}.horizon", lambda: self._horizon)
        reg.gauge(f"{base}.records_applied",
                  lambda: self.records_applied)
        reg.gauge(f"{base}.crc_rejects", lambda: self.crc_rejects)
        reg.gauge(f"{base}.staged_records", lambda: len(self._staged))
        reg.gauge(f"{base}.epoch", lambda: self._epoch)
        reg.gauge(f"{base}.fence_rejected_shipments",
                  lambda: self.fence_rejected_shipments)
        reg.gauge(f"{base}.snapshot_tiles",
                  lambda: sum(len(s.tiles)
                              for s in self._snapshots.values()
                              if isinstance(s, _TileSnap)))
        reg.gauge(f"{base}.snapshot_tiles_reused",
                  lambda: self.snapshot_tiles_reused)
        self._metric_names.append((reg, base))

    def close(self) -> None:
        for reg, base in self._metric_names:
            reg.unregister_prefix(base)
        self._metric_names.clear()
