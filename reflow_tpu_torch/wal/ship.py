"""WAL shipping: stream the durable log prefix to read replicas.

The pipelined committer (``wal/log.py``) already maintains a *synced*
watermark — the LSN below which every frame is written AND fsynced.
:meth:`WriteAheadLog.synced_position` exposes its byte-position twin,
and everything strictly before that ``(segment, offset)`` is exactly the
prefix a follower may safely mirror: bytes past it may still be sitting
in the committer queue or the page cache, and a power loss could take
them back (shipping them would let a replica serve state the leader
itself forgets on restart).

:class:`SegmentShipper` tails that watermark and streams the prefix to
N followers over a deliberately dumb, resumable protocol:

- ``follower.subscribe()`` returns the follower's persisted cursor
  (leader WAL coordinates) or ``None`` for a fresh replica. Fresh
  replicas are **checkpoint-anchored**: if the leader keeps checkpoints,
  the shipper calls ``follower.bootstrap(ckpt_dir)`` so catch-up replays
  only the WAL tail, not history from segment 0. Cursor coordinates are
  shared between leader and mirror by construction — a checkpoint's
  recorded ``wal_pos`` is always a segment *start* (``save_checkpoint``
  rotates first), so both sides agree on every byte after it.
- Each :class:`Shipment` is a run of raw CRC-framed bytes from one
  segment (no magic header), re-verified by the shipper before it leaves
  and by the receiver before it lands. ``seals=True`` marks the end of a
  sealed segment; ``next_segment`` tells the follower where the log
  continues (segment numbering may skip across leader restarts).
- The receiver answers :class:`ShipAck` (cursor advanced, new replay
  horizon) or :class:`ShipNack` (out-of-order or CRC-rejected). A NACK
  carries the receiver's authoritative cursor; the shipper re-reads from
  there off disk and resends — the WAL itself is the retransmit buffer,
  so the shipper keeps no in-flight state worth losing.

Transport is in-process (followers are objects, shipping is a thread —
same stance as the serve tier's pump pool); the protocol above is the
part that matters, and it is exercised torn/tampered/killed in
``tests/test_replica.py``.

The shipper persists ``ship-state.json`` next to the leader's segments
so ``tools/wal_inspect.py`` can report shipped/applied watermarks
without importing any of this.

The port's copy of ``reflow_tpu/wal/ship.py``. The segments are the JAX
package's byte for byte, so are the shipments cut from them and the
persisted state: a shipper of either package feeds a replica of the
other from any segment start the log still holds. Checkpoints do not
cross (the port saves device state with ``torch.save``), so a
checkpoint-anchored bootstrap needs a leader of the replica's own
package. A tile-unit bootstrap ships the files the committed
``meta.pkl`` (or ``chain.json``) names — the port's array states sit in
a ``states-t<tick>-*`` directory of their own — never a directory walk
that could pick up an uncommitted save's files.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import time
import zlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.utils.config import env_int
from reflow_tpu_torch.utils.runtime import named_lock
from reflow_tpu_torch.obs.registry import REGISTRY
from reflow_tpu_torch.wal.compact import (COMPACT_MANIFEST_FILE,
                                          read_compact_manifest)
from reflow_tpu_torch.wal.log import (_HEADER, _MAGIC, LogPosition, WalError,
                                      list_segments)

__all__ = ["Shipment", "ShipAck", "ShipNack", "SegmentShipper",
           "iter_frames", "record_causes", "SHIP_STATE_FILE",
           "SHIP_STATE_SCHEMA"]

SHIP_STATE_FILE = "ship-state.json"
SHIP_STATE_SCHEMA = "reflow.wal_ship/1"

_MAX_FRAME = 64 << 20  # sanity bound mirroring log._MAX_RECORD


class Shipment(NamedTuple):
    """One run of raw CRC-framed bytes from a single leader segment.

    ``payload`` covers leader bytes ``[offset, end_offset)`` of
    ``segment`` and always ends on a frame boundary. ``seals`` marks
    that this shipment reaches the end of a sealed segment, in which
    case ``next_segment`` is where the log continues. ``leader_tick``
    piggybacks the leader's tick counter so receivers can publish a lag
    gauge without a second channel. ``epoch`` is the shipping leader's
    epoch token (``wal/log.py`` fencing): a receiver rejects shipments
    from an epoch below its own — a fenced zombie's bytes are never
    merged. ``cause`` is an opaque causality token
    (``obs.trace.mint_cause``) stamped only while tracing is enabled so
    the ship → send → replay spans of one chunk stitch into a single
    cross-process chain; receivers echo it into their replay span and
    otherwise ignore it. Both trailing fields are defaulted so
    pre-epoch / pre-trace constructors stay valid."""

    segment: int
    offset: int
    payload: bytes
    end_offset: int
    seals: bool
    next_segment: Optional[int]
    leader_tick: int
    epoch: int = 0
    cause: Optional[str] = None


class ShipAck(NamedTuple):
    """Receiver accepted a shipment: ``cursor`` is its new resume
    position (leader coordinates), ``horizon`` its published tick
    horizon after applying any completed commit windows."""

    cursor: Tuple[int, int]
    horizon: int


class ShipNack(NamedTuple):
    """Receiver rejected a shipment (cursor mismatch or CRC failure).
    ``cursor`` is the receiver's authoritative resume position — the
    shipper re-reads from there and resends."""

    cursor: Optional[Tuple[int, int]]
    reason: str


def iter_frames(payload: bytes, segment: int, base: int,
                ) -> Tuple[List[Tuple[LogPosition, LogPosition, dict]],
                           int, Optional[str]]:
    """Walk ``payload`` (raw frames, no magic) as leader bytes starting
    at ``(segment, base)``. Returns ``(entries, valid_len, reason)``
    where each entry is ``(pos, end_pos, record)``; ``valid_len <
    len(payload)`` means the walk stopped early for ``reason`` (torn
    header, short payload, CRC mismatch, unpicklable record)."""
    entries: List[Tuple[LogPosition, LogPosition, dict]] = []
    off = 0
    n = len(payload)
    while off < n:
        if off + _HEADER.size > n:
            return entries, off, "truncated frame header"
        length, crc = _HEADER.unpack_from(payload, off)
        if length > _MAX_FRAME:
            return entries, off, f"implausible frame length {length}"
        body = payload[off + _HEADER.size: off + _HEADER.size + length]
        if len(body) < length:
            return entries, off, (f"truncated payload "
                                  f"({len(body)}/{length} bytes)")
        if zlib.crc32(body) != crc:
            return entries, off, "CRC mismatch"
        try:
            rec = pickle.loads(body)
        except Exception as e:  # noqa: BLE001 - framed yet unloadable
            return entries, off, f"unpicklable payload ({e})"
        end = off + _HEADER.size + length
        entries.append((LogPosition(segment, base + off),
                        LogPosition(segment, base + end), rec))
        off = end
    return entries, off, None


def record_causes(rec) -> List[str]:
    """Causality tokens stamped on one WAL push record
    (``DurableScheduler.push_cause``): the singular ``cause`` plus any
    coalesced ``causes`` overflow, deduplicated in order. Empty for
    unstamped (tracing-off) records."""
    if not isinstance(rec, dict):
        return []
    out: List[str] = []
    c = rec.get("cause")
    if c:
        out.append(c)
    for x in rec.get("causes") or ():
        if x not in out:
            out.append(x)
    return out


class _FollowerState:
    __slots__ = ("name", "follower", "cursor", "applied_horizon",
                 "bytes_total", "shipments", "nacks", "bootstraps",
                 "fenced", "high_water", "retransmit_bytes",
                 "link_stalls", "anchor_gen", "compact_reanchors")

    def __init__(self, name: str, follower) -> None:
        self.name = name
        self.follower = follower
        self.cursor: Optional[LogPosition] = None
        self.applied_horizon = 0
        self.bytes_total = 0
        self.shipments = 0
        self.nacks = 0
        self.bootstraps = 0
        #: the follower rejected our epoch as stale: this shipper is a
        #: zombie ex-leader's — stop re-offering, the bytes will never
        #: be accepted (retrying would NACK-spin forever)
        self.fenced = False
        #: furthest position ever offered to this follower: a chunk
        #: starting below it is a retransmission (NACK resync or
        #: ack-lost duplicate), counted in ``retransmit_bytes``
        self.high_water: Optional[LogPosition] = None
        self.retransmit_bytes = 0
        #: receive() returned None — link-level no-progress (down,
        #: mid-backoff, reset mid-exchange); NOT a protocol NACK
        self.link_stalls = 0
        #: compaction generation this follower's cursor was anchored
        #: under (-1 for a persisted-cursor attach, where the era is
        #: unknown and any compacted segment forces a conservative
        #: re-anchor). Mid-segment offsets from an older generation
        #: point into bytes a compaction pass rewrote.
        self.anchor_gen = -1
        self.compact_reanchors = 0


class SegmentShipper:
    """Tail the leader WAL's synced watermark and stream the durable
    prefix to attached followers.

    ``wal`` is the leader's :class:`WriteAheadLog` (or ``None`` for a
    cold log: pass ``wal_dir`` and the shipper treats the whole on-disk
    prefix as shippable — useful for tools and tests). ``ckpt_dir``
    enables checkpoint-anchored bootstrap for fresh followers.
    ``leader_tick`` is a callable returning the leader's current tick
    counter (piggybacked on shipments for lag gauges).

    Drive it either with the background thread (``start()`` /
    ``stop()``) or synchronously via :meth:`pump_once` (tests, benches
    that want deterministic interleaving).

    ``max_chunk_bytes`` bounds a shipment's payload, except that one
    frame longer than it (a bulk load's batch) ships alone and whole;
    the JAX package's shipper stops at such a frame for good."""

    def __init__(self, wal=None, *, wal_dir: Optional[str] = None,
                 ckpt_dir: Optional[str] = None,
                 leader_tick: Optional[Callable[[], int]] = None,
                 poll_s: float = 0.002,
                 max_chunk_bytes: int = 1 << 20,
                 epoch: Optional[int] = None) -> None:
        if wal is None and wal_dir is None:
            raise ValueError("SegmentShipper needs a wal or a wal_dir")
        self.wal = wal
        #: explicit epoch override (cold-log mode); with a live wal the
        #: shipper reads ``wal.epoch`` at stamp time so a recovery-time
        #: ``adopt_epoch`` is picked up without re-wiring
        self._epoch = epoch
        self.wal_dir = wal_dir if wal_dir is not None else wal.wal_dir
        self.ckpt_dir = ckpt_dir
        self._leader_tick = leader_tick or (lambda: 0)
        self.poll_s = poll_s
        self.max_chunk_bytes = max(int(max_chunk_bytes), 1 << 10)
        self._lock = named_lock("wal.ship")
        self._followers: Dict[str, _FollowerState] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.bytes_total = 0
        self.shipments = 0
        self.nacks = 0
        self.crc_stops = 0
        #: NACKs that named a newer epoch — this shipper is fenced
        self.fence_nacks = 0
        #: bytes re-offered below a follower's high-water mark (the
        #: WAL-as-retransmit-buffer path, driven by real loss)
        self.retransmit_bytes = 0
        #: link-level no-progress passes (follower.receive() -> None)
        self.link_stalls = 0
        #: followers re-anchored because their cursor predated a
        #: compacted range (wal/compact.py) — the truncation re-anchor
        #: path extended to rewritten-in-place segments
        self.compact_reanchors = 0
        #: tile-unit bootstrap transfers: checkpoint files shipped as
        #: independently CRC-framed units (REFLOW_TILE_BYTES > 0 and a
        #: follower exposing receive_ckpt_tile) — a NACK re-fetches one
        #: tile, not the chain
        self.tile_units_shipped = 0
        self.tile_unit_retries = 0
        self.tile_bootstraps = 0
        #: (mtime_ns, {out_seq: entry}) cache of the compaction
        #: manifest so the hot shipping path stats instead of parsing
        self._compact_cache: Tuple[Optional[int], Dict[int, dict]] = \
            (None, {})
        #: (registry, prefix) pairs, unregistered from the *same*
        #: registry they were registered on (a bare prefix list silently
        #: leaked gauges on any non-global registry)
        self._metric_names: List[Tuple[object, str]] = []
        self._metrics_registry = None

    @property
    def epoch(self) -> int:
        """The epoch stamped into every outgoing shipment."""
        if self._epoch is not None:
            return self._epoch
        return self.wal.epoch if self.wal is not None else 0

    # -- membership --------------------------------------------------------

    def attach(self, follower, name: Optional[str] = None) -> str:
        """Register ``follower`` and run the watermark handshake:
        ``subscribe()`` for its persisted cursor, falling back to a
        checkpoint-anchored ``bootstrap(ckpt_dir)`` (or the oldest
        on-disk segment) for a fresh replica."""
        name = name or getattr(follower, "name", None) \
            or f"follower-{len(self._followers)}"
        st = _FollowerState(name, follower)
        cursor = follower.subscribe()
        if cursor is None:
            cursor = self._bootstrap(st)
        st.cursor = LogPosition(*cursor)
        with self._lock:
            if name in self._followers:
                raise ValueError(f"follower {name!r} already attached")
            self._followers[name] = st
        if self._metrics_registry is not None \
                and hasattr(follower, "conn_state"):
            self._publish_conn_state(self._metrics_registry, name)
        return name

    def detach(self, name: str) -> None:
        with self._lock:
            self._followers.pop(name, None)

    def _bootstrap(self, st: _FollowerState) -> Tuple[int, int]:
        from reflow_tpu_torch.utils.checkpoint import checkpoint_exists

        st.bootstraps += 1
        # the re-anchor point is a segment start established *now*:
        # remember the compaction generation it was minted under so a
        # later rewrite of that segment invalidates the cursor again
        st.anchor_gen = self._compact_gen()
        if self.ckpt_dir is not None and checkpoint_exists(self.ckpt_dir):
            if env_int("REFLOW_TILE_BYTES") > 0 \
                    and hasattr(st.follower, "receive_ckpt_tile"):
                cursor = self._bootstrap_tiles(st)
                if cursor is not None:
                    return cursor
                # exhausted retries or a mid-transfer surprise: the
                # plain whole-directory bootstrap is always correct
            return tuple(st.follower.bootstrap(self.ckpt_dir))
        segs = list_segments(self.wal_dir)
        first = segs[0][0] if segs else 0
        return (first, len(_MAGIC))

    def _bootstrap_tiles(self,
                         st: _FollowerState) -> Optional[Tuple[int, int]]:
        """Ship the committed checkpoint file-by-file as independently
        CRC-framed units (``reflow.tile_ship/1``): each state or tile
        file travels alone, so a NACK re-fetches one file instead of the
        whole chain. The commit file (``meta.pkl``, or ``chain.json``)
        is deliberately sent last — it names every other file, so a
        torn transfer can never look complete to the receiver. Returns
        the follower's anchored cursor, or None to fall back to the
        plain bootstrap."""
        from reflow_tpu_torch.utils.checkpoint import committed_files

        try:
            rels, commit_rel, commit = committed_files(self.ckpt_dir)
        except (OSError, ValueError, KeyError, EOFError,
                pickle.UnpicklingError):
            # a save is mid-commit or reaped what we listed: the plain
            # bootstrap (which loads whatever is committed) is correct
            return None
        # the commit file travels last, as read before the listing: a
        # torn transfer never looks complete to the receiver
        files = [(rel, os.path.join(self.ckpt_dir, rel)) for rel in rels]
        files.append((commit_rel, None))
        retries = max(1, env_int("REFLOW_TILE_SHIP_RETRIES"))
        total = len(files)
        cursor = None
        for i, (rel, path) in enumerate(files):
            try:
                if path is None:
                    payload = commit
                else:
                    with open(path, "rb") as f:
                        payload = f.read()
            except OSError:
                # the chain rotated under us (a reaped tile file):
                # this transfer is stale, start over via the fallback
                return None
            unit = {"schema": "reflow.tile_ship/1",
                    "rel": rel.replace(os.sep, "/"), "idx": i,
                    "total": total, "payload": payload,
                    "crc": zlib.crc32(payload) & 0xFFFFFFFF,
                    "last": i == total - 1}
            ok = False
            for attempt in range(retries):
                t0 = time.perf_counter()
                try:
                    resp = st.follower.receive_ckpt_tile(unit)
                except Exception:  # noqa: BLE001 - transport-level miss
                    resp = None
                accepted = bool(resp) and bool(resp.get("ok"))
                if _trace.ENABLED:
                    _trace.evt("tile_ship", t0,
                               time.perf_counter() - t0,
                               track="wal-shipper",
                               args={"follower": st.name, "rel": unit["rel"],
                                     "idx": i, "total": total,
                                     "bytes": len(payload),
                                     "attempt": attempt,
                                     "ok": accepted})
                if accepted:
                    ok = True
                    self.tile_units_shipped += 1
                    if unit["last"]:
                        cursor = resp.get("cursor")
                    break
                self.tile_unit_retries += 1
            if not ok:
                return None
        if cursor is None:
            return None
        self.tile_bootstraps += 1
        return tuple(cursor)

    # -- shipping ----------------------------------------------------------

    def _horizon(self) -> LogPosition:
        if self.wal is not None:
            return self.wal.synced_position()
        # cold log: everything on disk is the shippable prefix
        segs = list_segments(self.wal_dir)
        if not segs:
            return LogPosition(0, len(_MAGIC))
        seq, path = segs[-1]
        return LogPosition(seq, os.path.getsize(path))

    def pump_once(self) -> int:
        """Ship every follower as far toward the current synced
        watermark as one pass allows. Returns bytes shipped."""
        horizon = self._horizon()
        with self._lock:
            states = list(self._followers.values())
        shipped = 0
        for st in states:
            shipped += self._ship_follower(st, horizon)
        if shipped or states:
            self._persist_state(horizon)
        return shipped

    def _ship_follower(self, st: _FollowerState,
                       horizon: LogPosition) -> int:
        base = st.bytes_total
        guard = 0
        while (not st.fenced and st.cursor is not None
               and st.cursor < horizon):
            guard += 1
            if guard > 10_000:  # paranoia: never wedge the pump loop
                break
            if not self._ship_chunk(st, horizon):
                break
        return st.bytes_total - base

    def _ship_chunk(self, st: _FollowerState,
                    horizon: LogPosition) -> bool:
        """Read, re-verify and send one chunk ``[cursor, ...)``; returns
        False when this follower can make no more progress this pass."""
        segs = dict(list_segments(self.wal_dir))
        cur = st.cursor
        if cur.segment not in segs:
            # the leader truncated past this follower's cursor (a
            # checkpoint retired those segments) — re-anchor on the
            # checkpoint instead of a full refetch. Compaction reuses
            # this path for unlinked middle segments of a folded range.
            st.cursor = LogPosition(*self._bootstrap(st))
            return st.cursor != cur
        ent = self._compact_entries().get(cur.segment)
        if (ent is not None and ent["gen"] > st.anchor_gen
                and cur.offset > len(_MAGIC)):
            # the segment under this mid-segment cursor was rewritten
            # by a compaction pass from a newer generation: the offset
            # addresses bytes of the old era. Partially folded replay
            # would break the all-or-nothing batch-id dedup, so
            # re-anchor on the checkpoint — the same contract as a
            # truncation, through the same bootstrap.
            st.compact_reanchors += 1
            self.compact_reanchors += 1
            st.cursor = LogPosition(*self._bootstrap(st))
            return st.cursor != cur
        sealed = cur.segment < horizon.segment
        if sealed:
            end = os.path.getsize(segs[cur.segment])
        else:
            end = horizon.offset
        if end <= cur.offset:
            if not sealed:
                return False
            # fully shipped sealed segment with no remaining frames to
            # piggyback the seal on: the seal must still travel as a
            # normal (empty) shipment — the receiver's cursor is the
            # authoritative one, and a shipper-local hop would strand
            # it at the old segment's end, NACK-rejecting every later
            # chunk forever (cursor livelock)
            payload = b""
            chunk_end = cur.offset
            entries = []
        else:
            with open(segs[cur.segment], "rb") as f:
                f.seek(cur.offset)
                want = min(end - cur.offset, self.max_chunk_bytes)
                data = f.read(want)
                if len(data) < end - cur.offset \
                        and len(data) >= _HEADER.size:
                    # one frame longer than the chunk bound (a bulk
                    # load's batch): ship that frame alone, whole — a
                    # chunk that ends inside its first frame would never
                    # make progress
                    length, _crc = _HEADER.unpack_from(data, 0)
                    whole = _HEADER.size + length
                    if len(data) < whole <= end - cur.offset \
                            and length <= _MAX_FRAME:
                        data += f.read(whole - len(data))
            entries, valid, reason = iter_frames(data, cur.segment,
                                                 cur.offset)
            if valid < len(data) and len(data) < end - cur.offset:
                # chunk boundary split a frame mid-air: ship the whole
                # frames we have, the next chunk restarts at the boundary
                reason = None
            if valid == 0:
                if reason is not None and sealed:
                    # before declaring corruption, re-read the
                    # compaction manifest uncached: a pass may have
                    # swapped the folded file under our feet between
                    # the manifest check and the read above
                    ent = self._compact_entries(force=True) \
                        .get(cur.segment)
                    if ent is not None and ent["gen"] > st.anchor_gen:
                        st.compact_reanchors += 1
                        self.compact_reanchors += 1
                        st.cursor = LogPosition(*self._bootstrap(st))
                        return st.cursor != cur
                    raise WalError(
                        f"wal-{cur.segment:08d}.log @ {cur.offset}: "
                        f"{reason} in a sealed segment below the synced "
                        f"watermark — real corruption, refusing to ship")
                self.crc_stops += 1
                return False
            payload = data[:valid]
            chunk_end = cur.offset + valid
        seals = sealed and chunk_end == end
        nxt = self._next_segment(segs, cur.segment) if seals else None
        tok: Optional[str] = None
        causes: List[str] = []
        if _trace.ENABLED:
            # stamp a causality token so this chunk's ship_segment /
            # net_send / replica_replay spans stitch across processes;
            # lazy import — obs.wire rides net/, which rides this module
            from reflow_tpu_torch.obs.wire import node_id as _node_id
            tok = _trace.mint_cause(_node_id(), self.epoch)
            # per-write tokens stamped on the chunk's WAL records: the
            # span carries BOTH, joining each sampled write's chain to
            # the chunk-level ship/send/replay spans
            for _p, _e, r in entries:
                for c in record_causes(r):
                    if c not in causes:
                        causes.append(c)
        shipment = Shipment(cur.segment, cur.offset, payload, chunk_end,
                            seals, nxt, self._leader_tick(), self.epoch,
                            tok)
        if payload and st.high_water is not None and cur < st.high_water:
            # re-offering bytes the follower was already sent: the WAL
            # acting as the retransmit buffer, made visible
            st.retransmit_bytes += len(payload)
            self.retransmit_bytes += len(payload)
        offered = LogPosition(cur.segment, chunk_end)
        if st.high_water is None or offered > st.high_water:
            st.high_water = offered
        t0 = time.perf_counter()
        resp = st.follower.receive(shipment)
        if _trace.ENABLED:
            _trace.evt("ship_segment", t0, time.perf_counter() - t0,
                       track="wal-shipper",
                       args={"follower": st.name,
                             "segment": cur.segment,
                             "offset": cur.offset,
                             "bytes": len(payload),
                             "seals": seals,
                             "cause": tok,
                             "causes": causes,
                             "ack": isinstance(resp, ShipAck)})
        if resp is None:
            # link-level no-progress (remote follower down or inside a
            # backoff window): skip this follower for the pass. Not a
            # NACK — the replica never spoke.
            st.link_stalls += 1
            self.link_stalls += 1
            return False
        if isinstance(resp, ShipAck):
            st.cursor = LogPosition(*resp.cursor)
            st.applied_horizon = resp.horizon
            st.bytes_total += len(payload)
            st.shipments += 1
            self.bytes_total += len(payload)
            self.shipments += 1
            return True
        # NACK: adopt the receiver's authoritative cursor and let the
        # next pass re-read from disk (the WAL is the retransmit buffer)
        st.nacks += 1
        self.nacks += 1
        if resp.reason.startswith("fenced"):
            # the receiver is on a newer epoch: we are the zombie. Do
            # NOT adopt its cursor — our log diverged at the promotion
            # horizon; just stop offering this follower anything.
            st.fenced = True
            self.fence_nacks += 1
            return False
        if resp.cursor is not None:
            st.cursor = LogPosition(*resp.cursor)
        return False

    @staticmethod
    def _next_segment(segs: Dict[int, str], seq: int) -> int:
        later = [s for s in segs if s > seq]
        return min(later) if later else seq + 1

    # -- compaction awareness ----------------------------------------------

    def _compact_entries(self, force: bool = False) -> Dict[int, dict]:
        """``{out_segment: manifest entry}`` for the leader log's
        compacted ranges, cached by manifest mtime (flips are atomic,
        so mtime-staleness is the only hazard and ``force`` closes it
        on the one path that matters)."""
        path = os.path.join(self.wal_dir, COMPACT_MANIFEST_FILE)
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            self._compact_cache = (None, {})
            return {}
        cached_key, cached = self._compact_cache
        if not force and cached_key == mtime:
            return cached
        manifest = read_compact_manifest(self.wal_dir) or {}
        entries = {e["out"]: e for e in manifest.get("ranges", [])}
        self._compact_cache = (mtime, entries)
        return entries

    def _compact_gen(self) -> int:
        """The current compaction generation (0 = never compacted)."""
        entries = self._compact_entries()
        return max((e["gen"] for e in entries.values()), default=0)

    def min_cursor(self) -> Optional[LogPosition]:
        """The laggiest attached, unfenced follower's cursor — the
        compactor's eligibility floor: segments at or past it are still
        being fetched and must not be rewritten under a live cursor."""
        with self._lock:
            cursors = [st.cursor for st in self._followers.values()
                       if not st.fenced and st.cursor is not None]
        return min(cursors) if cursors else None

    # -- backlog / state ---------------------------------------------------

    def fully_shipped(self, horizon: Optional[LogPosition] = None) -> bool:
        """True when every attached, unfenced follower's cursor has
        reached ``horizon`` (default: the current synced watermark).
        The patient-drain predicate: a remote follower mid-backoff
        reports no progress for whole passes, so a drain loop must ask
        'is everyone there yet' instead of 'did this pass move bytes'."""
        if horizon is None:
            horizon = self._horizon()
        with self._lock:
            states = list(self._followers.values())
        return all(st.fenced or (st.cursor is not None
                                 and st.cursor >= horizon)
                   for st in states)

    def backlog_segments(self) -> int:
        """How many segments the laggiest follower still has to fetch
        (0 = everyone is inside the watermark segment)."""
        horizon = self._horizon()
        with self._lock:
            cursors = [st.cursor for st in self._followers.values()
                       if st.cursor is not None]
        if not cursors:
            return 0
        return max(0, horizon.segment - min(c.segment for c in cursors))

    def _transport_state(self, st: _FollowerState) -> Optional[dict]:
        """Connection-level state for one follower: the client's
        reconnect-policy snapshot plus shipper-side retransmit/stall
        counters. None for in-process followers (no wire, no story)."""
        snap_fn = getattr(st.follower, "transport_snapshot", None)
        if snap_fn is None:
            return None
        try:
            snap = dict(snap_fn())
        except Exception:  # noqa: BLE001 - advisory state only
            snap = {"state": "unknown"}
        snap["retransmit_bytes"] = st.retransmit_bytes
        snap["link_stalls"] = st.link_stalls
        return snap

    def _persist_state(self, horizon: LogPosition) -> None:
        with self._lock:
            followers = {}
            transport = {}
            for st in self._followers.values():
                followers[st.name] = {
                    "shipped": list(st.cursor) if st.cursor else None,
                    "applied_horizon": st.applied_horizon,
                    "bytes_total": st.bytes_total,
                    "shipments": st.shipments,
                    "nacks": st.nacks,
                    "bootstraps": st.bootstraps,
                    "compact_reanchors": st.compact_reanchors,
                }
                tsnap = self._transport_state(st)
                if tsnap is not None:
                    transport[st.name] = tsnap
        state = {
            "schema": SHIP_STATE_SCHEMA,
            "horizon": list(horizon),
            "leader_tick": self._leader_tick(),
            "bytes_total": self.bytes_total,
            "shipments": self.shipments,
            "nacks": self.nacks,
            "retransmit_bytes": self.retransmit_bytes,
            "link_stalls": self.link_stalls,
            "tile_units_shipped": self.tile_units_shipped,
            "tile_unit_retries": self.tile_unit_retries,
            "tile_bootstraps": self.tile_bootstraps,
            "followers": followers,
        }
        if transport:
            state["transport"] = transport
        path = os.path.join(self.wal_dir, SHIP_STATE_FILE)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(state, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # tooling state only; never fail shipping over it

    # -- thread loop -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="wal-shipper", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                moved = self.pump_once()
            except WalError:
                raise
            except Exception:  # noqa: BLE001 - a dying follower must
                moved = 0      # not take the shipping loop with it
            if not moved:
                self._stop.wait(self.poll_s)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def close(self) -> None:
        self.stop()
        for reg, name in self._metric_names:
            reg.unregister_prefix(name)
        self._metric_names.clear()

    # -- observability -----------------------------------------------------

    def _net_reconnects_total(self) -> int:
        with self._lock:
            states = list(self._followers.values())
        return sum(getattr(st.follower, "reconnects_total", 0)
                   for st in states)

    def _conn_state(self, name: str) -> str:
        with self._lock:
            st = self._followers.get(name)
        if st is None:
            return "detached"
        return getattr(st.follower, "conn_state", "local")

    def publish_metrics(self, registry=None, name: str = "ship") -> None:
        reg = registry if registry is not None else REGISTRY
        self._metrics_registry = reg
        reg.gauge(f"{name}.bytes_total", lambda: self.bytes_total)
        reg.gauge(f"{name}.backlog_segments", self.backlog_segments)
        reg.gauge(f"{name}.shipments", lambda: self.shipments)
        reg.gauge(f"{name}.nacks", lambda: self.nacks)
        reg.gauge(f"{name}.followers", lambda: len(self._followers))
        reg.gauge(f"{name}.link_stalls", lambda: self.link_stalls)
        reg.gauge(f"{name}.compact_reanchors",
                  lambda: self.compact_reanchors)
        reg.gauge(f"{name}.tile_units_shipped",
                  lambda: self.tile_units_shipped)
        reg.gauge(f"{name}.tile_bootstraps",
                  lambda: self.tile_bootstraps)
        reg.gauge("net.reconnects_total", self._net_reconnects_total)
        reg.gauge("net.retransmit_bytes", lambda: self.retransmit_bytes)
        self._metric_names.append((reg, name))
        self._metric_names.append((reg, "net."))
        with self._lock:
            states = list(self._followers.values())
        for st in states:
            if hasattr(st.follower, "conn_state"):
                self._publish_conn_state(reg, st.name)

    def _publish_conn_state(self, reg, follower_name: str) -> None:
        gname = f"replica.{follower_name}.conn_state"
        reg.gauge(gname, lambda n=follower_name: self._conn_state(n))
        self._metric_names.append((reg, gname))
