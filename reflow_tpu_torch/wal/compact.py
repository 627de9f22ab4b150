"""Key-level WAL compaction: fold sealed segments down to O(state).

A long-lived leader's replay tail holds every update since the last
checkpoint anchor — N updates to one key cost N records on every
recovery and every replica bootstrap. :class:`WalCompactor` rewrites a
range of **sealed, fully-shipped** segments at or after the newest
checkpoint anchor so that all push records fold key-level: per source,
the (key, value) rows of the whole range are summed into one columnar
batch (zero-weight rows — insert-then-retract — disappear entirely),
while every original batch id is carried forward on the folded record
and every tick marker / epoch stamp is preserved verbatim. The result
replays through the unchanged ``recover()``/``replay_records`` path to
**exact state parity** with the original range (same final views, same
tick counter, same dedup window) in O(state) work instead of
O(history).

Atomicity (write-new → fsync → manifest flip → unlink):

1. the folded range ``[a..b]`` is written to ``wal-<a>.log.compact``
   and fsynced;
2. ``compact-manifest.json`` flips atomically to record the range
   (out segment, covered seqs, generation) — the advisory commit point
   shippers and ``wal_inspect`` read;
3. ``os.replace`` swaps the compacted file over segment ``a``;
4. the superseded originals ``a+1..b`` are unlinked.

A crash anywhere in between leaves a *replay-equivalent* log: the
folded segment carries the batch ids of everything it covers, so any
surviving original records dedup away during replay — double-apply is
impossible by the same mechanism that makes recovery idempotent.
Interrupted passes are rolled forward (or back) on the next pass.

Followers: a cursor inside a compacted range points at bytes that no
longer exist. Deleted middle segments hit ``SegmentShipper``'s existing
leader-truncation re-anchor; for the rewritten *first* segment the
shipper consults the manifest generation and re-anchors any cursor
established under an older generation (``wal/ship.py``). Eligibility
already excludes segments any *attached* follower still needs, so only
detached/stale followers ever take that path — and re-anchoring is
O(state) now, which is the point.

Run it from the ``ControlPlane`` (``serve/control.py``)
(``compactor=``): the control loop supervises the compactor thread with
the same respawn-or-fail-fast budget as the WAL committer.

**Tiled folds** (``REFLOW_TILE_BYTES`` > 0, docs/guide.md 'Tiled
maintenance'): the monolithic fold holds the whole folded state of the
range in RAM. Above the tile budget the pass instead runs a cheap
key-histogram scan, plans contiguous key-range tiles under the budget
(:mod:`reflow_tpu_torch.utils.tiles`), and folds one [key-range] x
[segment-range] tile at a time — peak resident fold state is one tile.
The output segment holds, per source, one zero-row *cover* record
carrying every original batch id (written first, so a restore point
inside the fold fails loud before any part applies) and one *part*
record per tile with a synthetic batch id ``<first_id>#t<k>``; replay
dedup works unchanged. Tiles append incrementally to the same tmp
file; a ``<tmp>.progress`` sidecar flips after each tile so a crash
mid-pass resumes without refolding finished tiles (per-tile
generations record which pass attempt folded each tile).

The port's copy of ``reflow_tpu/wal/compact.py``. The fold runs on the
host over the logged numpy columns (a device batch is logged as its host
pre-image), and writes the JAX package's records, manifest
(``reflow.wal_compact/1``) and progress sidecar: either package's
compactor folds a log the other wrote, and either package recovers the
result.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from reflow_tpu_torch.utils.runtime import named_lock
from reflow_tpu_torch.obs.registry import REGISTRY
from reflow_tpu_torch.wal.log import (_HEADER, _MAGIC, WalError,
                                      _read_segment, _seg_path, list_segments)

__all__ = ["WalCompactor", "read_compact_manifest",
           "COMPACT_MANIFEST_FILE", "COMPACT_SCHEMA"]

COMPACT_MANIFEST_FILE = "compact-manifest.json"
COMPACT_SCHEMA = "reflow.wal_compact/1"
PROGRESS_SCHEMA = "reflow.wal_compact_progress/1"
_TMP_SUFFIX = ".compact"
_PROGRESS_SUFFIX = ".compact.progress"


def read_compact_manifest(wal_dir: str) -> Optional[dict]:
    """The compaction manifest as a dict, or None when the log was
    never compacted. Tolerates a missing file, fails loud on corrupt
    JSON (flips are atomic; garbage means real trouble)."""
    path = os.path.join(wal_dir, COMPACT_MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _scalarize(x):
    """A hashable identity for one key or value cell (ndarray cells
    hash by dtype/shape/bytes)."""
    import numpy as np

    if isinstance(x, np.ndarray):
        if x.ndim == 0:
            return x.item()
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    return x


def _col(cells: List, like) -> "object":
    """Rebuild one columnar array from folded cells, matching the dtype
    and row shape of ``like`` (a column from an original record)."""
    import numpy as np

    arr_like = np.asarray(like)
    if arr_like.dtype == object:
        out = np.empty(len(cells), dtype=object)
        out[:] = cells
        return out
    if not cells:
        return np.empty((0,) + arr_like.shape[1:], dtype=arr_like.dtype)
    return np.asarray(cells, dtype=arr_like.dtype)


class _SourceFold:
    """Running key-level fold of one source's push records."""

    __slots__ = ("nid", "name", "first_tick", "epoch", "agg", "ids",
                 "ids_set", "keys_like", "values_like")

    def __init__(self, nid: int, rec: Dict):
        self.nid = nid
        self.name = rec["node_name"]
        self.first_tick = rec.get("tick", 0)
        self.epoch = 0
        #: rowkey -> [key_cell, value_cell, weight]
        self.agg: Dict = {}
        self.ids: List[str] = []
        self.ids_set = set()
        self.keys_like = rec["keys"]
        self.values_like = rec["values"]

    def add(self, rec: Dict, row_filter=None, take_ids: bool = True,
            take_rows: bool = True) -> None:
        """Fold one push record in. A tiled pass restricts the fold:
        ``row_filter(key) -> bool`` keeps only the tile's rows,
        ``take_ids=False`` leaves batch ids to the cover record, and
        ``take_rows=False`` (histogram/cover pass) collects only
        ids/epoch/tick."""
        import numpy as np

        self.epoch = max(self.epoch, rec.get("epoch", 0) or 0)
        if take_ids:
            ids = rec.get("batch_ids")
            if ids is None:
                ids = [rec["batch_id"]] if rec.get("batch_id") else []
            for b in ids:
                if b not in self.ids_set:
                    self.ids_set.add(b)
                    self.ids.append(b)
        if not take_rows:
            return
        keys = np.asarray(rec["keys"])
        values = np.asarray(rec["values"])
        weights = np.asarray(rec["weights"])
        for k, v, w in zip(keys, values, weights):
            if row_filter is not None and not row_filter(k):
                continue
            rk = (_scalarize(k), _scalarize(v))
            cell = self.agg.get(rk)
            if cell is None:
                self.agg[rk] = [k, v, int(w)]
            else:
                cell[2] += int(w)

    def resident_bytes(self) -> int:
        """Approximate host bytes this fold holds resident — the
        quantity the tile budget bounds (``compact.peak_tile_bytes``)."""
        from reflow_tpu_torch.utils.tiles import approx_row_bytes

        return sum(approx_row_bytes(c[0], c[1])
                   for c in self.agg.values())

    def record(self, batch_id: Optional[str] = None) -> Dict:
        """The folded record. ``batch_id`` overrides for a tile *part*:
        the record then carries only that synthetic id (dedup unit =
        one tile) and the original ids ride the range's cover record."""
        rows = [c for c in self.agg.values() if c[2] != 0]
        rec = {
            "kind": "push",
            "tick": self.first_tick,
            "node": self.nid,
            "node_name": self.name,
            "batch_id": batch_id if batch_id is not None else self.ids[0],
            # the folded batch is a SUM with no per-id slice; replay
            # fails loud if a restore point falls inside the fold
            # (wal/recovery.py's partial-ids check keys off this)
            "compacted": True,
            "keys": _col([c[0] for c in rows], self.keys_like),
            "values": _col([c[1] for c in rows], self.values_like),
            "weights": _col([c[2] for c in rows], [0]),
        }
        if batch_id is None and len(self.ids) > 1:
            rec["batch_ids"] = list(self.ids)
        if self.epoch:
            rec["epoch"] = self.epoch
        return rec


class WalCompactor:
    """Background key-level compactor over one leader WAL directory.

    ``wal`` is the live :class:`~reflow_tpu_torch.wal.log.WriteAheadLog`
    (or None for a cold log — pass ``wal_dir``; tools, benches and
    recovery-time catch-up compaction). ``shipper`` (optional) bounds
    eligibility to segments every attached follower has fully fetched.
    ``ckpt_dir`` (optional) supplies the newest checkpoint anchor — a
    :class:`~reflow_tpu_torch.utils.checkpoint.CheckpointChain` root or a
    legacy full checkpoint — and compaction never folds across it
    (records before the anchor belong to the checkpoint, records after
    it to the replay tail; a fold spanning the boundary would move tail
    records below the recovery scan start).

    Drive it with the background thread (``start()``/``stop()``,
    supervised by the ControlPlane) or synchronously via
    :meth:`compact_once`."""

    def __init__(self, wal=None, *, wal_dir: Optional[str] = None,
                 shipper=None, ckpt_dir: Optional[str] = None,
                 interval_s: Optional[float] = None,
                 min_segments: Optional[int] = None,
                 keep_segments: Optional[int] = None,
                 tile_bytes: Optional[int] = None,
                 crash=None) -> None:
        from reflow_tpu_torch.utils.config import env_float, env_int

        if wal is None and wal_dir is None:
            raise ValueError("WalCompactor needs a wal or a wal_dir")
        self.wal = wal
        self.wal_dir = wal_dir if wal_dir is not None else wal.wal_dir
        self.shipper = shipper
        self.ckpt_dir = ckpt_dir
        self.interval_s = (interval_s if interval_s is not None
                           else env_float("REFLOW_COMPACT_INTERVAL_S"))
        self.min_segments = (min_segments if min_segments is not None
                             else env_int("REFLOW_COMPACT_MIN_SEGMENTS"))
        self.keep_segments = (keep_segments if keep_segments is not None
                              else env_int("REFLOW_COMPACT_KEEP_SEGMENTS"))
        self.tile_bytes = (tile_bytes if tile_bytes is not None
                           else env_int("REFLOW_TILE_BYTES"))
        self._crash = crash
        self._lock = named_lock("wal.compact")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.passes = 0
        self.folds = 0
        self.segments_folded = 0
        self.records_in = 0
        self.records_out = 0
        self.reclaimed_bytes = 0
        self.tile_folds = 0
        self.peak_tile_bytes = 0
        self.restarts = 0
        self.last_error: Optional[BaseException] = None
        self._events: List[Dict] = []
        self._metric_names: List[Tuple[object, str]] = []

    def _crash_point(self, name: str) -> None:
        if self._crash is not None:
            self._crash.point(name)

    # -- eligibility -------------------------------------------------------

    def _anchor_segment(self) -> Optional[int]:
        """Segment of the newest checkpoint anchor (chain head or
        legacy full), or None when no checkpoint exists."""
        if self.ckpt_dir is None:
            return None
        from reflow_tpu_torch.utils.checkpoint import chain_head_wal_pos

        pos = chain_head_wal_pos(self.ckpt_dir)
        if pos is None:
            meta_path = os.path.join(self.ckpt_dir, "meta.pkl")
            if os.path.exists(meta_path):
                import pickle

                with open(meta_path, "rb") as f:
                    pos = pickle.load(f).get("wal_pos")
        if pos is None:
            return None
        seg, off = pos
        # anchors are segment starts by construction (saves rotate
        # first); a mid-segment anchor would mean folding could bury
        # post-anchor bytes, so exclude that segment entirely
        return seg if off <= len(_MAGIC) else seg + 1

    def eligible_range(self) -> Optional[List[int]]:
        """The segment seqs the next pass would fold, or None."""
        segs = list_segments(self.wal_dir)
        if not segs:
            return None
        seqs = [s for s, _ in segs]
        if self.wal is not None:
            sealed_lim = self.wal.synced_position().segment
        else:
            sealed_lim = seqs[-1]  # cold log: all but the newest file
        lo = self._anchor_segment()
        lo = seqs[0] if lo is None else max(lo, seqs[0])
        floor = None
        if self.shipper is not None:
            mc = self.shipper.min_cursor()
            if mc is not None:
                floor = mc.segment
        cand = [s for s in seqs
                if lo <= s < sealed_lim
                and (floor is None or s < floor)]
        if self.keep_segments > 0:
            cand = cand[:max(0, len(cand) - self.keep_segments)]
        if not cand:
            return None
        manifest = read_compact_manifest(self.wal_dir)
        covered_hi = -1
        if manifest is not None:
            for ent in manifest.get("ranges", []):
                if ent["out"] == cand[0]:
                    covered_hi = ent["covers"][1]
        fresh = [s for s in cand if s > covered_hi]
        if len(fresh) < max(1, self.min_segments):
            return None
        return cand

    def reclaimable_bytes(self) -> int:
        """Bytes the next pass could fold (sizes of the eligible
        segments) — drops to ~one folded segment after a pass, which is
        the bounded-footprint signal the bench asserts on."""
        rng = self.eligible_range()
        if not rng:
            return 0
        segs = dict(list_segments(self.wal_dir))
        return sum(os.path.getsize(segs[s]) for s in rng if s in segs)

    def log_bytes(self) -> int:
        return sum(os.path.getsize(p)
                   for _s, p in list_segments(self.wal_dir))

    # -- the pass ----------------------------------------------------------

    def compact_once(self) -> Optional[Dict]:
        """One full pass: finish any interrupted pass, then fold the
        eligible range (if any). Returns the pass event dict or None
        when there was nothing to do."""
        self.passes += 1
        try:
            self._recover_interrupted()
            rng = self.eligible_range()
            if not rng:
                return None
            return self._fold_range(rng)
        except FileNotFoundError:
            # a checkpoint truncation raced the pass and deleted a
            # candidate out from under us; next pass sees fresh state
            return None

    def _fold_range(self, rng: List[int]) -> Optional[Dict]:
        if self.tile_bytes and self.tile_bytes > 0:
            return self._fold_range_tiled(rng)
        return self._fold_range_mono(rng)

    def _fold_range_mono(self, rng: List[int]) -> Optional[Dict]:
        segs = dict(list_segments(self.wal_dir))
        folds: Dict[int, _SourceFold] = {}
        order: List[int] = []
        passthrough: List[Dict] = []
        records_in = 0
        orig_bytes = 0
        tick_lo: Optional[int] = None
        tick_hi: Optional[int] = None
        for seq in rng:
            path = segs[seq]
            orig_bytes += os.path.getsize(path)
            seg_records, _torn = _read_segment(path, seq, False)
            for _pos, rec in seg_records:
                records_in += 1
                kind = rec.get("kind")
                if kind == "push":
                    nid = rec["node"]
                    f = folds.get(nid)
                    if f is None:
                        f = folds[nid] = _SourceFold(nid, rec)
                        order.append(nid)
                    f.add(rec)
                elif kind == "tick":
                    t = rec.get("tick", 0)
                    tick_lo = t if tick_lo is None else min(tick_lo, t)
                    tick_hi = t if tick_hi is None else max(tick_hi, t)
                    passthrough.append(rec)
                elif kind == "ckpt":
                    # informational for replay, but wal_inspect
                    # discovers chain roots from the recorded paths —
                    # keep them (they are tiny)
                    passthrough.append(rec)
                else:
                    # unknown kinds survive verbatim (replay skips
                    # them; a future consumer must treat them as
                    # idempotent, same as the crash-window duplicates)
                    passthrough.append(rec)
        out_records = [folds[nid].record() for nid in order
                       if folds[nid].ids]
        out_records.extend(passthrough)
        out_seq = rng[0]
        tmp = _seg_path(self.wal_dir, out_seq) + _TMP_SUFFIX
        new_bytes = self._write_segment(tmp, out_records)
        return self._commit(rng, segs, tmp, new_bytes, orig_bytes,
                            records_in, len(out_records),
                            tick_lo, tick_hi, None)

    # -- tiled fold (REFLOW_TILE_BYTES > 0) --------------------------------

    def _fold_range_tiled(self, rng: List[int]) -> Optional[Dict]:
        """Fold the range one key-range tile at a time: histogram pass
        -> tile plan -> per-tile fold passes appending to the same tmp
        segment, with a progress sidecar flipped after every tile so an
        interrupted pass resumes without refolding finished tiles."""
        import time

        import numpy as np

        from reflow_tpu_torch.obs import trace as _trace
        from reflow_tpu_torch.utils import tiles as _t

        budget = int(self.tile_bytes)
        segs = dict(list_segments(self.wal_dir))
        # -- histogram pass: per-bucket byte estimate, cover folds
        # (ids/epoch/tick only — no rows held), passthrough, stats
        bucket_bytes = [0.0] * _t.N_BUCKETS
        covers: Dict[int, _SourceFold] = {}
        order: List[int] = []
        passthrough: List[Dict] = []
        records_in = 0
        orig_bytes = 0
        tick_lo: Optional[int] = None
        tick_hi: Optional[int] = None
        for seq in rng:
            path = segs[seq]
            orig_bytes += os.path.getsize(path)
            seg_records, _torn = _read_segment(path, seq, False)
            for _pos, rec in seg_records:
                records_in += 1
                kind = rec.get("kind")
                if kind == "push":
                    nid = rec["node"]
                    f = covers.get(nid)
                    if f is None:
                        f = covers[nid] = _SourceFold(nid, rec)
                        order.append(nid)
                    f.add(rec, take_rows=False)
                    for k, v in zip(np.asarray(rec["keys"]),
                                    np.asarray(rec["values"])):
                        bucket_bytes[_t.bucket_of(k)] += \
                            _t.approx_row_bytes(k, v)
                elif kind == "tick":
                    t = rec.get("tick", 0)
                    tick_lo = t if tick_lo is None else min(tick_lo, t)
                    tick_hi = t if tick_hi is None else max(tick_hi, t)
                    passthrough.append(rec)
                else:
                    passthrough.append(rec)
        plan = [[lo, hi] for lo, hi in _t.plan_tiles(bucket_bytes, budget)]
        if len(plan) <= 1:
            # state fits one tile: the monolithic fold is the same
            # work without synthetic ids or a sidecar
            return self._fold_range_mono(rng)
        out_seq = rng[0]
        tmp = _seg_path(self.wal_dir, out_seq) + _TMP_SUFFIX
        prog_path = _seg_path(self.wal_dir, out_seq) + _PROGRESS_SUFFIX
        cover_recs = [covers[nid].record() for nid in order
                      if covers[nid].ids]
        # -- resume or start: a valid sidecar for this exact range and
        # plan means finished tiles are already on the tmp segment
        prog = self._read_progress(prog_path)
        if not (prog is not None and os.path.exists(tmp)
                and prog.get("covers") == [rng[0], rng[-1]]
                and prog.get("plan") == plan):
            for stale in (tmp, prog_path):
                if os.path.exists(stale):
                    os.remove(stale)
            end = self._append_records(tmp, cover_recs, None)
            prog = {"schema": PROGRESS_SCHEMA, "covers": [rng[0], rng[-1]],
                    "plan": plan, "budget": budget, "attempt": 1,
                    "covers_end": end, "done": []}
            self._write_progress(prog_path, prog)
        else:
            prog["attempt"] = int(prog.get("attempt", 1)) + 1
        done = {int(d["tile"]): d for d in prog["done"]}
        end = max([int(prog["covers_end"])]
                  + [int(d["end"]) for d in done.values()])
        peak = max([0] + [int(d.get("resident", 0))
                          for d in done.values()])
        resumed_tiles = len(done)
        gens: List[int] = [0] * len(plan)
        for k, d in done.items():
            gens[k] = int(d["gen"])
        parts_out = sum(int(d.get("parts", 0)) for d in done.values())
        for k, (lo, hi) in enumerate(plan):
            if k in done:
                continue
            t0 = time.perf_counter()
            in_tile = (lambda key, _lo=lo, _hi=hi:
                       _lo <= _t.bucket_of(key) < _hi)
            folds: Dict[int, _SourceFold] = {}
            torder: List[int] = []
            for seq in rng:
                seg_records, _torn = _read_segment(segs[seq], seq, False)
                for _pos, rec in seg_records:
                    if rec.get("kind") != "push":
                        continue
                    nid = rec["node"]
                    f = folds.get(nid)
                    if f is None:
                        f = folds[nid] = _SourceFold(nid, rec)
                        torder.append(nid)
                    f.add(rec, row_filter=in_tile, take_ids=False)
            resident = sum(folds[nid].resident_bytes() for nid in torder)
            peak = max(peak, resident)
            recs = []
            for nid in torder:
                f = folds[nid]
                if any(c[2] != 0 for c in f.agg.values()):
                    recs.append(f.record(
                        batch_id=f"{covers[nid].ids[0]}#t{k}"))
            folds.clear()
            # append the tile (truncating any torn partial append from
            # a crashed attempt), then flip the sidecar: the tile is
            # durable before it is recorded done
            end = self._append_records(tmp, recs, end)
            parts_out += len(recs)
            self._crash_point("compact_tile_before_progress")
            gens[k] = prog["attempt"]
            prog["done"].append({"tile": k, "gen": prog["attempt"],
                                 "end": end, "resident": resident,
                                 "parts": len(recs)})
            self._write_progress(prog_path, prog)
            self._crash_point("compact_tile_after_progress")
            if _trace.ENABLED:
                _trace.evt("compact_tile", t0,
                           time.perf_counter() - t0,
                           track="wal-compactor",
                           args={"tile": k, "of": len(plan),
                                 "buckets": [lo, hi],
                                 "resident_bytes": resident,
                                 "parts": len(recs),
                                 "gen": prog["attempt"]})
            with self._lock:
                self.tile_folds += 1
                self.peak_tile_bytes = max(self.peak_tile_bytes,
                                           resident)
        new_bytes = self._append_records(tmp, passthrough, end)
        records_out = len(cover_recs) + parts_out + len(passthrough)
        tiles_info = {
            "n": len(plan),
            "budget": budget,
            "peak_tile_bytes": peak,
            "plan": plan,
            "gens": gens,
            "resumed_tiles": resumed_tiles,
            "attempts": prog["attempt"],
        }
        return self._commit(rng, segs, tmp, new_bytes, orig_bytes,
                            records_in, records_out, tick_lo, tick_hi,
                            tiles_info)

    def _commit(self, rng: List[int], segs: Dict[int, str], tmp: str,
                new_bytes: int, orig_bytes: int, records_in: int,
                records_out: int, tick_lo, tick_hi,
                tiles_info: Optional[Dict]) -> Optional[Dict]:
        """Shared commit tail: manifest flip -> swap -> unlink, with
        the crash seams every fold shape shares."""
        out_seq = rng[0]
        prog_path = _seg_path(self.wal_dir, out_seq) + _PROGRESS_SUFFIX
        self._crash_point("compact_before_flip")
        manifest = read_compact_manifest(self.wal_dir) or {
            "schema": COMPACT_SCHEMA, "gen": 0, "ranges": [],
            "reclaimed_bytes": 0}
        gen = manifest["gen"] + 1
        entry = {
            "out": out_seq,
            "covers": [rng[0], rng[-1]],
            "gen": gen,
            "bytes": new_bytes,
            "orig_bytes": orig_bytes,
            "records_in": records_in,
            "records_out": records_out,
            "tick_lo": tick_lo,
            "tick_hi": tick_hi,
        }
        if tiles_info is not None:
            entry["tiles"] = tiles_info
        manifest["gen"] = gen
        manifest["ranges"] = ([e for e in manifest["ranges"]
                               if e["out"] != out_seq] + [entry])
        manifest["ranges"].sort(key=lambda e: e["out"])
        manifest["reclaimed_bytes"] = (manifest.get("reclaimed_bytes", 0)
                                       + max(0, orig_bytes - new_bytes))
        self._flip_manifest(manifest)
        self._crash_point("compact_after_flip")
        if not os.path.exists(segs[out_seq]):
            # a concurrent checkpoint truncated the range mid-pass:
            # swapping now would resurrect a pre-anchor segment. The
            # replay-side cost would only be dedup work, but don't.
            os.remove(tmp)
            if os.path.exists(prog_path):
                os.remove(prog_path)
            return None
        os.replace(tmp, segs[out_seq])
        _fsync_dir(self.wal_dir)
        if os.path.exists(prog_path):
            os.remove(prog_path)
        self._crash_point("compact_before_unlink")
        for seq in rng[1:]:
            try:
                os.remove(segs[seq])
            except FileNotFoundError:
                pass
        _fsync_dir(self.wal_dir)
        self._crash_point("compact_after_unlink")
        event = {
            "kind": "wal_compact",
            "out": out_seq,
            "covers": [rng[0], rng[-1]],
            "segments": len(rng),
            "records_in": records_in,
            "records_out": records_out,
            "orig_bytes": orig_bytes,
            "bytes": new_bytes,
            "reclaimed_bytes": max(0, orig_bytes - new_bytes),
            "gen": gen,
        }
        if tiles_info is not None:
            event["tiles"] = {"n": tiles_info["n"],
                              "peak_tile_bytes":
                                  tiles_info["peak_tile_bytes"]}
        with self._lock:
            self.folds += 1
            self.segments_folded += len(rng)
            self.records_in += records_in
            self.records_out += records_out
            self.reclaimed_bytes += event["reclaimed_bytes"]
            self._events.append(event)
        return event

    @staticmethod
    def _write_segment(path: str, records: List[Dict]) -> int:
        import pickle

        with open(path, "wb") as f:
            f.write(_MAGIC)
            n = len(_MAGIC)
            for rec in records:
                body = pickle.dumps(rec)
                f.write(_HEADER.pack(len(body), zlib.crc32(body)))
                f.write(body)
                n += _HEADER.size + len(body)
            f.flush()
            os.fsync(f.fileno())
        return n

    @staticmethod
    def _append_records(path: str, records: List[Dict],
                        at: Optional[int]) -> int:
        """Append pickled frames to a tmp segment at byte offset
        ``at``, truncating anything beyond it first (a torn tile
        append from a crashed attempt). ``at=None`` (re)creates the
        file with the WAL magic. Returns the new end offset."""
        import pickle

        if at is None:
            with open(path, "wb") as f:
                f.write(_MAGIC)
                f.flush()
                os.fsync(f.fileno())
            at = len(_MAGIC)
        with open(path, "r+b") as f:
            f.truncate(at)
            f.seek(at)
            n = at
            for rec in records:
                body = pickle.dumps(rec)
                f.write(_HEADER.pack(len(body), zlib.crc32(body)))
                f.write(body)
                n += _HEADER.size + len(body)
            f.flush()
            os.fsync(f.fileno())
        return n

    @staticmethod
    def _read_progress(path: str) -> Optional[Dict]:
        """The tile-progress sidecar as a dict, or None when absent or
        unusable (a torn/alien sidecar just means a fresh fold)."""
        try:
            with open(path) as f:
                prog = json.load(f)
        except (OSError, ValueError):
            return None
        if prog.get("schema") != PROGRESS_SCHEMA:
            return None
        return prog

    def _write_progress(self, path: str, prog: Dict) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(prog, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.wal_dir)

    def _flip_manifest(self, manifest: Dict) -> None:
        path = os.path.join(self.wal_dir, COMPACT_MANIFEST_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.wal_dir)

    # -- interrupted-pass recovery -----------------------------------------

    def _recover_interrupted(self) -> None:
        """Roll an interrupted pass forward (flip happened), back (it
        didn't), or *hold* it (a tiled pass with a valid progress
        sidecar resumes in the next fold), and prune manifest entries
        for segments a later checkpoint truncated away."""
        manifest = read_compact_manifest(self.wal_dir)
        entries = {e["out"]: e for e in
                   (manifest or {}).get("ranges", [])}
        changed = False
        for fname in sorted(os.listdir(self.wal_dir)):
            if fname.endswith(_PROGRESS_SUFFIX + ".tmp"):
                # torn sidecar flip: the flipped sidecar (if any) is
                # authoritative, the half-written one is garbage
                os.remove(os.path.join(self.wal_dir, fname))
                continue
            if fname.endswith(_PROGRESS_SUFFIX):
                # orphan sidecar (pass completed, crash before the
                # sidecar unlink): harmless, drop it
                base = fname[:-len(_PROGRESS_SUFFIX)]
                if not os.path.exists(os.path.join(
                        self.wal_dir, base + _TMP_SUFFIX)):
                    os.remove(os.path.join(self.wal_dir, fname))
                continue
            if not fname.endswith(_TMP_SUFFIX):
                continue
            tmp = os.path.join(self.wal_dir, fname)
            seg_name = fname[:-len(_TMP_SUFFIX)]
            try:
                seq = int(seg_name[len("wal-"):-len(".log")])
            except ValueError:
                os.remove(tmp)
                continue
            ent = entries.get(seq)
            if (ent is not None
                    and ent["bytes"] == os.path.getsize(tmp)
                    and self._tmp_valid(tmp, seq)):
                # crashed between flip and swap: roll forward
                os.replace(tmp, os.path.join(self.wal_dir, seg_name))
                prog_path = tmp[:-len(_TMP_SUFFIX)] + _PROGRESS_SUFFIX
                if os.path.exists(prog_path):
                    os.remove(prog_path)
                _fsync_dir(self.wal_dir)
            elif (self.tile_bytes and self.tile_bytes > 0
                  and self._read_progress(
                      tmp[:-len(_TMP_SUFFIX)] + _PROGRESS_SUFFIX)
                  is not None):
                # a tiled pass died mid-fold before its flip: the
                # originals are still authoritative (nothing swapped),
                # and the sidecar lets the next fold resume finished
                # tiles instead of refolding — hold the tmp
                continue
            else:
                # crashed before the flip (or the tmp is torn): the
                # originals are authoritative — roll back
                os.remove(tmp)
                prog_path = tmp[:-len(_TMP_SUFFIX)] + _PROGRESS_SUFFIX
                if os.path.exists(prog_path):
                    os.remove(prog_path)
                if ent is not None:
                    del entries[seq]
                    changed = True
        # resume unlinks: originals inside a flipped range are
        # superseded (their ids all live on the folded segment)
        live = dict(list_segments(self.wal_dir))
        for seq, ent in list(entries.items()):
            if seq not in live:
                del entries[seq]  # truncated by a checkpoint
                changed = True
                continue
            for s in range(ent["covers"][0] + 1, ent["covers"][1] + 1):
                if s in live:
                    try:
                        os.remove(live[s])
                    except FileNotFoundError:
                        pass
        if manifest is not None and changed:
            manifest["ranges"] = sorted(entries.values(),
                                        key=lambda e: e["out"])
            self._flip_manifest(manifest)

    def _tmp_valid(self, tmp: str, seq: int) -> bool:
        try:
            _read_segment(tmp, seq, False)
            return True
        except WalError:
            return False

    # -- thread + supervision ----------------------------------------------

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "WalCompactor":
        if self.alive:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="wal-compactor", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.compact_once()
            except Exception as e:  # noqa: BLE001 - surface via supervision
                self.last_error = e
                raise

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def restart(self) -> bool:
        """Supervision hook (ControlPlane): respawn a dead compactor
        thread. Returns False if it is still alive (nothing to do)."""
        if self.alive:
            return False
        self.last_error = None
        self.restarts += 1
        self._thread = None
        self.start()
        return True

    def drain_events(self) -> List[Dict]:
        """Completed-pass events since the last drain (the ControlPlane
        turns these into ``wal_compact`` actions)."""
        with self._lock:
            out, self._events = self._events, []
        return out

    def close(self) -> None:
        self.stop()
        for reg, name in self._metric_names:
            reg.unregister_prefix(name)
        self._metric_names.clear()

    # -- observability -----------------------------------------------------

    def publish_metrics(self, registry=None, name: str = "compact"
                        ) -> None:
        reg = registry if registry is not None else REGISTRY
        reg.gauge(f"{name}.folds", lambda: self.folds)
        reg.gauge(f"{name}.segments_folded",
                  lambda: self.segments_folded)
        reg.gauge(f"{name}.reclaimed_bytes",
                  lambda: self.reclaimed_bytes)
        reg.gauge(f"{name}.reclaimable_bytes", self.reclaimable_bytes)
        reg.gauge(f"{name}.log_bytes", self.log_bytes)
        reg.gauge(f"{name}.restarts", lambda: self.restarts)
        reg.gauge(f"{name}.tile_folds", lambda: self.tile_folds)
        reg.gauge(f"{name}.peak_tile_bytes",
                  lambda: self.peak_tile_bytes)
        self._metric_names.append((reg, name))
