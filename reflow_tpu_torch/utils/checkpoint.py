"""Durable checkpoint/resume (SURVEY.md §5).

The port's copy of ``reflow_tpu/utils/checkpoint.py``. The host side
(``meta.pkl``, the chain manifest, the delta and tile framing) is the
JAX package's; the array states are the port's own: orbax has no
counterpart here, so each node's tree of tensors is saved with
``torch.save`` as host (CPU) tensors and loaded onto the executor's
device. bfloat16 leaves (a ViT's params) keep their dtype — numpy, which
the JAX package's delta elements hold, has none.

The durable state of an incremental dataflow is small and well-defined:
(per-node operator state, tick counter, materialized sink views). The
checkpoint records ``tick`` so the host driver knows where its cursor
was. On its own, a checkpoint covers ingestion only *at* save points —
everything pushed since the last save is lost on a crash unless the
upstream replays it. ``reflow_tpu_torch.wal`` closes that window: a WAL-backed
scheduler (``wal.DurableScheduler``) logs every accepted batch, the save
records the log replay position (``"wal_pos"``) and truncates the sealed
segments it covers, and ``wal.recovery.recover`` restores checkpoint +
tail for exactly-once ingestion across process death.

Two serialization paths behind one API:

- **array states** (the ``"cuda"`` executor's trees of tensors): read
  back to the host once (one synchronize, one ``.cpu()`` a leaf, outside
  any tick) and written with ``torch.save`` as ``<states dir>/<node
  id>.pt``; restored with ``torch.load(..., map_location=<the
  executor's device>, weights_only=True)``, each tree checked against
  the live one (structure, shapes, dtypes) before it replaces it.
- **host states** (CpuExecutor's dict/Counter oracle state): pickle.

Pending device batches (a ``DeviceDelta`` pushed but not yet ticked) are
written as host images: the durable scheduler's logged pre-image, else
a readback counted as a forced sync (``meta["pending_readbacks"]``), so
``meta.pkl`` holds no tensor and loads in a process without a card.

Layout: ``<dir>/meta.pkl`` (tick, sink views, host states) and
``<dir>/states-t<tick>-<suffix>/`` (one ``torch.save`` file of each
array state, if any), which ``meta["states_dir"]`` names. A save writes
its state files into a directory of its own, then lands ``meta.pkl``
atomically (temp file, fsync, ``os.replace``) as its commit point, and
only then removes the directories no meta names: a save into the same
directory that dies before its meta lands leaves the previous
checkpoint whole, state files and replay position together.

Bounded history (incremental checkpoints)
-----------------------------------------
A full checkpoint is O(state) bytes *every* save, which caps how often
an operator can afford to take one — and the WAL only truncates at
saves, so rare saves mean O(history) replay tails. :class:`CheckpointChain`
fixes the cost side: it manages a directory of one **full** checkpoint
plus a chain of **delta** elements (per-source state snapshots of only
what changed since the previous element, keyed by the macro-tick
horizon), linked by a ``chain.json`` manifest. ``load_checkpoint`` on a
chain directory restores base + deltas in order; a broken link
mid-chain fails loud, while a torn/partial *final* delta falls back one
chain element — exactly the WAL's torn-tail stance. To make that
fallback always recoverable, WAL truncation lags one element: a delta
save truncates only up to the *previous* element's anchor, so the log
still covers the newest element's window if its file is lost.

Delta file framing mirrors the WAL: ``RFCKD001`` magic, then one
``[u32 len][u32 crc32]`` pickled payload — torn bytes are detected the
same way a torn WAL record is.

Tiled elements (``REFLOW_TILE_BYTES`` > 0, docs/guide.md 'Tiled
maintenance')
-------------------------------------------------------------------
A monolithic element pickles the whole keyed state in one payload —
O(state) peak on both the writer and any restoring reader. Above the
tile budget, keyed state (sink views plus host states that are plain
``dict``/``Counter`` maps) is split by key-range tile
(:mod:`reflow_tpu_torch.utils.tiles`): a full checkpoint writes
``tiles/t<tick>-NNN.ckt`` files (``RFCKT001`` magic + one CRC frame
each) next to a small ``meta.pkl`` that lists them, and a delta element
becomes a multi-frame ``.ckd`` — frame 0 carries the small fields plus
a ``"tiles"`` count, then one CRC frame per tile. Restore streams one
frame at a time (peak extra allocation = the largest single frame,
tracked in :data:`TILE_IO_STATS`); a torn frame anywhere in a delta
keeps the ``torn=True`` contract, so a torn *final* tiled delta still
falls back exactly one chain element. Non-map host states and array
pytrees stay monolithic in the residual payload.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from reflow_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["save_checkpoint", "load_checkpoint", "meta_digest",
           "checkpoint_exists", "CheckpointChain", "CheckpointError",
           "load_chain", "read_chain_manifest", "chain_head_wal_pos",
           "committed_files", "CHAIN_MANIFEST", "CHAIN_SCHEMA"]

CHAIN_MANIFEST = "chain.json"
CHAIN_SCHEMA = "reflow.ckpt_chain/1"
_DELTA_MAGIC = b"RFCKD001"
_DELTA_HEADER = struct.Struct("<II")
_TILE_MAGIC = b"RFCKT001"
_TILE_DIR = "tiles"

#: process-wide high-water marks of tiled checkpoint IO — the largest
#: single frame pickled on a save and unpickled on a restore. The
#: tiles bench asserts both stay under 2x the tile budget; reset with
#: :func:`reset_tile_io_stats` around a measured window.
TILE_IO_STATS = {"writer_peak_frame_bytes": 0,
                 "reader_peak_frame_bytes": 0}


def reset_tile_io_stats() -> None:
    TILE_IO_STATS["writer_peak_frame_bytes"] = 0
    TILE_IO_STATS["reader_peak_frame_bytes"] = 0


def _tile_budget() -> int:
    from reflow_tpu_torch.utils.config import env_int

    return int(env_int("REFLOW_TILE_BYTES") or 0)


class CheckpointError(RuntimeError):
    """A checkpoint/chain element is unreadable or the chain is
    inconsistent (broken parent link, horizon mismatch)."""

    def __init__(self, msg: str, *, torn: bool = False):
        super().__init__(msg)
        #: True when the element's *bytes* are torn/short/corrupt (the
        #: WAL-torn-tail analogue) as opposed to a structural link break
        self.torn = torn


def checkpoint_exists(path: Optional[str]) -> bool:
    """True when ``path`` holds a restorable checkpoint — either a
    legacy full checkpoint (``meta.pkl``) or a chain directory
    (``chain.json``)."""
    if path is None:
        return False
    return (os.path.exists(os.path.join(path, CHAIN_MANIFEST))
            or os.path.exists(os.path.join(path, "meta.pkl")))


def _full_files(path: str, meta: dict) -> List[str]:
    """The state and tile files one full checkpoint's ``meta`` names,
    relative to its directory ``path``."""
    rels: List[str] = []
    sdir = meta.get("states_dir")
    if sdir:
        rels += [os.path.join(sdir, n)
                 for n in sorted(os.listdir(os.path.join(path, sdir)))]
    rels += list((meta.get("tiled") or {}).get("files", ()))
    return rels


def committed_files(path: str) -> Tuple[List[str], str, bytes]:
    """The files the committed checkpoint in ``path`` is made of, as
    ``(rels, commit_rel, commit_bytes)``: the paths (relative to
    ``path``) of the state directory's files and the tile files its
    ``meta.pkl`` names — for a chain, those of the base element, the
    base's ``meta.pkl`` and the delta elements — and the commit file
    (``meta.pkl``, or ``chain.json`` for a chain) with its bytes as read
    first, so the list is what those bytes name. Directories a save left
    behind uncommitted, or superseded ones not yet reaped, are not
    listed. Raises ``OSError`` when a named file is gone (a save raced
    the listing)."""
    chain = os.path.join(path, CHAIN_MANIFEST)
    if os.path.exists(chain):
        with open(chain, "rb") as f:
            commit = f.read()
        manifest = json.loads(commit)
        base = manifest["base"]
        with open(os.path.join(path, base, "meta.pkl"), "rb") as f:
            base_meta = pickle.loads(f.read())
        rels = [os.path.join(base, r)
                for r in _full_files(os.path.join(path, base), base_meta)]
        rels.append(os.path.join(base, "meta.pkl"))
        rels += list(manifest.get("deltas", []))
        return rels, CHAIN_MANIFEST, commit
    with open(os.path.join(path, "meta.pkl"), "rb") as f:
        commit = f.read()
    return _full_files(path, pickle.loads(commit)), "meta.pkl", commit


def _is_array_state(st) -> bool:
    """A node state that is a dict tree whose leaves are all tensors."""
    leaves = tree_leaves(st) if isinstance(st, dict) else []
    return bool(leaves) and all(isinstance(v, torch.Tensor)
                                for v in leaves)


def _split_states(states: Dict[int, object]):
    """Partition per-node states into (array trees, host objects)."""
    arr, host = {}, {}
    for nid, st in states.items():
        if _is_array_state(st):
            arr[nid] = st
        else:
            host[nid] = st
    return arr, host


def _host_trees(trees: Dict) -> Dict:
    """Every tree's leaves copied to host tensors: one synchronize of
    each card the leaves live on, then one ``.cpu()`` a leaf."""
    devices = {leaf.device for t in trees.values() for leaf in
               tree_leaves(t) if leaf.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return {k: tree_map(lambda a: a.detach().cpu(), t)
            for k, t in trees.items()}


def _tree_bytes(trees: Dict) -> int:
    return sum(a.numel() * a.element_size() for t in trees.values()
               for a in tree_leaves(t))


def _state_blob(tree) -> bytes:
    """The bytes a host tree's content is compared by: each leaf's dtype,
    shape and raw bytes (a pickled tensor's own bytes vary from call to
    call, so they cannot tell two states apart)."""
    return pickle.dumps(tree_map(
        lambda a: (str(a.dtype), tuple(a.shape),
                   a.reshape(-1).view(torch.uint8).numpy().tobytes()),
        tree))


def _host_pending(sched):
    """The scheduler's pending buffers with every device batch replaced
    by its host image: the durable scheduler's logged pre-image, else a
    readback (counted as a forced sync). Returns (pending, readbacks)."""
    image_of = getattr(sched, "pending_image", None)
    out, reads = {}, 0
    for nid, batches in sched._pending.items():
        host = []
        for b in batches:
            if hasattr(b, "nonzero"):
                img = image_of(b) if image_of is not None else None
                if img is None:
                    sched._note_forced_sync("checkpoint of a pending "
                                            "device batch")
                    img = sched.executor.materialize(b)
                    reads += 1
                b = img
            host.append(b)
        out[nid] = host
    return out, reads


def _write_file(path: str, write) -> int:
    """``write(f)`` into ``path``, flushed and fsynced; returns the size."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
        return f.tell()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _save_array_states(path: str, host_arr: Dict, tick: int):
    """``torch.save`` each node's host tree as ``<nid>.pt`` in a new
    directory under ``path``, every file and the directory fsynced.
    Returns (the directory's name, the bytes written)."""
    import tempfile

    sdir = tempfile.mkdtemp(prefix=f"states-t{tick:08d}-", dir=path)
    nbytes = 0
    for nid, tree in host_arr.items():
        nbytes += _write_file(os.path.join(sdir, f"{nid}.pt"),
                              lambda f, t=tree: torch.save(t, f))
    _fsync_dir(sdir)
    return os.path.basename(sdir), nbytes


def _check_like(sid: str, got, live) -> None:
    """Raise ValueError unless ``got`` has ``live``'s tree structure and
    each leaf its shape and dtype."""
    try:
        tree_map(lambda g, lv: None, got, live)
    except ValueError as e:
        raise ValueError(f"checkpointed state of node {sid}: {e}") from e
    for g, lv in zip(tree_leaves(got), tree_leaves(live)):
        if g.shape != lv.shape or g.dtype != lv.dtype:
            raise ValueError(
                f"checkpointed state of node {sid}: a {g.dtype} "
                f"{tuple(g.shape)} leaf where the bound executor holds "
                f"{lv.dtype} {tuple(lv.shape)} — restore onto the same "
                f"graph and executor kind it was saved from")


def _load_array_states(sdir: str, executor) -> Dict[int, object]:
    """The array states saved in ``sdir``, loaded onto ``executor``'s
    device and checked against its live trees."""
    live_arr, _ = _split_states(executor.states)
    if not live_arr:
        raise ValueError(
            "checkpoint holds array states but the bound executor has "
            "none — restore onto the same executor kind it was saved "
            "from")
    device = getattr(executor, "device", "cpu")
    out = {}
    for fname in sorted(os.listdir(sdir)):
        nid = int(fname[:-len(".pt")])
        if nid not in live_arr:
            raise ValueError(f"checkpoint holds a state of node {nid}, "
                             f"which the bound executor does not have")
        st = torch.load(os.path.join(sdir, fname), map_location=device,
                        weights_only=True)
        _check_like(str(nid), st, live_arr[nid])
        out[nid] = st
    return out


def meta_digest(tick: int, seen_batch_ids) -> int:
    """64-bit digest of the host-side meta that multi-controller saves
    assume SPMD-identical (tick counter + dedup window, in insertion
    order — order divergence is divergence)."""
    import hashlib

    h = hashlib.sha256(repr((tick, list(seen_batch_ids))).encode())
    return int.from_bytes(h.digest()[:8], "big")


# -- key-range tiled elements ----------------------------------------------


def _splittable(st) -> bool:
    """Only plain key->value maps split by key tile; subclasses with
    extra invariants (and non-map states) stay in the residual blob."""
    from collections import Counter

    return type(st) in (dict, Counter)


def _cls_name(st) -> str:
    return "Counter" if type(st).__name__ == "Counter" else "dict"


def _make_cls(name: str):
    from collections import Counter

    return Counter if name == "Counter" else dict


def _plan_keyed(maps: List, budget: int):
    """Tile plan over the union of several key->value maps, or None
    when everything fits one tile (caller stays monolithic)."""
    from reflow_tpu_torch.utils import tiles as _t

    bucket_bytes = [0.0] * _t.N_BUCKETS
    for m in maps:
        for k, v in m.items():
            bucket_bytes[_t.bucket_of(k)] += _t.approx_row_bytes(k, v)
    plan = _t.plan_tiles(bucket_bytes, budget)
    return plan if len(plan) > 1 else None


def _slice_by_tile(maps: Dict, plan) -> List[Dict]:
    """Per-tile slices of several key->value maps in ONE pass — one
    ``bucket_of`` per key. Slicing per tile would rescan every map
    once per tile (quadratic in the tile count: a 64-tile save of an
    8k-key view costs 512k key hashes instead of 8k). The slices hold
    references into the already-resident source maps, so this buys
    time, not memory — the tile bound is on pickled frame bytes."""
    from reflow_tpu_torch.utils import tiles as _t

    tile_of = [0] * _t.N_BUCKETS
    for i, (lo, hi) in enumerate(plan):
        for b in range(lo, hi):
            tile_of[b] = i
    out: List[Dict] = [{name: {} for name in maps} for _ in plan]
    for name, m in maps.items():
        for k, v in m.items():
            out[tile_of[_t.bucket_of(k)]][name][k] = v
    return out


def _write_tile_file(path: str, payload: dict) -> int:
    body = pickle.dumps(payload)
    TILE_IO_STATS["writer_peak_frame_bytes"] = max(
        TILE_IO_STATS["writer_peak_frame_bytes"], len(body))
    frame = (_TILE_MAGIC + _DELTA_HEADER.pack(len(body),
                                              zlib.crc32(body)) + body)
    with open(path, "wb") as f:
        f.write(frame)
        f.flush()
        os.fsync(f.fileno())
    return len(frame)


def _read_tile_file(path: str) -> dict:
    """One tiled-checkpoint frame; raises :class:`CheckpointError`
    (``torn=True``) on missing/short/CRC-torn bytes — a torn base tile
    fails the restore loud (the chain base has no fallback)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointError(f"{path}: missing checkpoint tile ({e})",
                              torn=True) from e
    if data[:len(_TILE_MAGIC)] != _TILE_MAGIC:
        raise CheckpointError(f"{path}: bad tile magic "
                              f"{data[:len(_TILE_MAGIC)]!r}", torn=True)
    off = len(_TILE_MAGIC)
    if off + _DELTA_HEADER.size > len(data):
        raise CheckpointError(f"{path}: truncated tile header",
                              torn=True)
    length, crc = _DELTA_HEADER.unpack_from(data, off)
    body = data[off + _DELTA_HEADER.size: off + _DELTA_HEADER.size
                + length]
    if len(body) < length or zlib.crc32(body) != crc:
        raise CheckpointError(f"{path}: torn checkpoint tile "
                              f"({len(body)}/{length} bytes)", torn=True)
    TILE_IO_STATS["reader_peak_frame_bytes"] = max(
        TILE_IO_STATS["reader_peak_frame_bytes"], len(body))
    try:
        return pickle.loads(body)
    except Exception as e:  # noqa: BLE001 - framed+CRC-clean yet unloadable
        raise CheckpointError(f"{path}: unpicklable tile payload "
                              f"({e})", torn=True) from e


def _write_full_tiles(path: str, sched, host: Dict, budget: int,
                      crash=None) -> Optional[dict]:
    """Write the keyed state of a full checkpoint as per-tile files.
    Returns the ``meta["tiled"]`` descriptor, or None when one tile
    would cover everything (caller stays monolithic). Tile files are
    named by tick so a crashed save never clobbers the files the
    current ``meta.pkl`` references; superseded files are reaped by
    the caller after the new meta lands."""
    import time

    from reflow_tpu_torch.obs import trace as _trace

    views = {name: c for name, c in sched.sink_views.items()}
    split_host = {nid: st for nid, st in host.items()
                  if _splittable(st)}
    plan = _plan_keyed(list(views.values()) + list(split_host.values()),
                       budget)
    if plan is None:
        return None
    tile_dir = os.path.join(path, _TILE_DIR)
    os.makedirs(tile_dir, exist_ok=True)
    view_slices = _slice_by_tile(views, plan)
    host_slices = _slice_by_tile(split_host, plan)
    files: List[str] = []
    peak = 0
    for t, (lo, hi) in enumerate(plan):
        t0 = time.perf_counter()
        payload = {
            "range": [lo, hi],
            "views": view_slices[t],
            "host": host_slices[t],
        }
        rel = os.path.join(_TILE_DIR,
                           f"t{sched._tick:08d}-{t:03d}.ckt")
        nbytes = _write_tile_file(os.path.join(path, rel), payload)
        peak = max(peak, nbytes)
        files.append(rel)
        if crash is not None:
            crash.point("ckpt_tile_full_append")
        if _trace.ENABLED:
            _trace.evt("ckpt_tile", t0, time.perf_counter() - t0,
                       track="checkpoint",
                       args={"tile": t, "of": len(plan),
                             "kind": "full", "bytes": nbytes})
    return {
        "n": len(plan),
        "budget": budget,
        "files": files,
        "peak_tile_bytes": peak,
        "views_cls": {name: "Counter" for name in views},
        "host_cls": {nid: _cls_name(st)
                     for nid, st in split_host.items()},
    }


def save_checkpoint(sched, path: str, *, truncate: bool = True,
                    crash=None) -> Dict:
    """Save ``sched``'s state to ``path`` (see the module docstring for
    the layout); a WAL-backed scheduler's log is rotated, the replay
    position recorded, and (``truncate``) the covered segments dropped
    once the save has landed. Returns the meta dict, with the bytes the
    array states took (``"states_bytes"``). ``crash`` is a
    :class:`~reflow_tpu_torch.utils.faults.CrashInjector` hook: the seam
    ``ckpt_before_meta`` lies between the new state files and the meta
    that commits them (``ckpt_tile_full_append`` after each tile file).

    In a group of processes (``parallel/dist.py``) every process calls
    this collectively with the same (shared) ``path``. The tick and the
    dedup window must be the same everywhere (mint batch ids from a
    :class:`~reflow_tpu_torch.scheduler.SourceCursor`): one allgather of
    :func:`meta_digest` checks it and raises ``RuntimeError`` on a
    divergence. Each process then saves its own part (its shards' states,
    sink views and pending batches) as a checkpoint of its own under
    ``proc<i>of<k>-t<tick>/``, and once all have landed process 0 writes
    the top ``meta.pkl`` last, by rename: the tick, the dedup window, the
    process count, the mesh shape and the processes' directories. The
    returned meta is this process's."""
    from reflow_tpu_torch.parallel import dist

    if dist.process_count() > 1:
        return _save_collective(sched, path, truncate=truncate, crash=crash)
    return _save_checkpoint(sched, path, truncate=truncate, crash=crash)[0]


def _mesh_shape(sched) -> Optional[dict]:
    mesh = getattr(sched.executor, "mesh", None)
    return None if mesh is None else dict(mesh.shape)


def _save_collective(sched, path: str, *, truncate: bool, crash) -> Dict:
    """:func:`save_checkpoint` in a group of processes."""
    from reflow_tpu_torch.parallel import dist

    mine = np.uint64(meta_digest(sched._tick, sched._seen_batch_ids))
    digests = dist.process_allgather(mine)
    if len(set(int(x) for x in digests.ravel())) != 1:
        raise RuntimeError(
            "checkpoint meta diverged across controllers (tick "
            "counter or batch-id dedup window differs between "
            "processes); mint batch ids from a shared "
            "scheduler.SourceCursor so every process dedups "
            "identically")
    pid, k = dist.process_index(), dist.process_count()
    os.makedirs(path, exist_ok=True)
    sub = f"proc{pid}of{k}-t{sched._tick:08d}"
    meta = _save_checkpoint(sched, os.path.join(path, sub),
                            truncate=truncate, crash=crash)[0]
    # every process's part has landed once this allgather returns
    subs = dist.allgather_object(sub)
    if pid == 0:
        top = {"tick": sched._tick,
               "seen_batch_ids": dict(sched._seen_batch_ids),
               "process_count": k, "mesh_shape": _mesh_shape(sched),
               "procs": subs}
        mtmp = os.path.join(path, "meta.pkl.tmp")
        _write_file(mtmp, lambda f: pickle.dump(top, f))
        os.replace(mtmp, os.path.join(path, "meta.pkl"))
        _fsync_dir(path)
        import shutil

        for fname in os.listdir(path):
            if fname.startswith("proc") and fname not in subs:
                shutil.rmtree(os.path.join(path, fname), ignore_errors=True)
    # nobody reads the checkpoint before its meta is in place
    dist.allgather_object(None)
    return meta


def _save_checkpoint(sched, path: str, *, truncate: bool, crash):
    """:func:`save_checkpoint`, returning (meta, the array states' host
    trees as read back for the save)."""
    os.makedirs(path, exist_ok=True)
    arr, host = _split_states(sched.executor.states)
    arr = _host_trees(arr)
    pending, pending_reads = _host_pending(sched)
    meta = {
        "tick": sched._tick,
        "sink_views": {name: dict(c) for name, c in sched.sink_views.items()},
        "seen_batch_ids": dict(sched._seen_batch_ids),
        # accepted-but-unticked batches: without these, a crash between
        # push and tick would lose deltas whose ids the dedup set already
        # claims (exactly-once would silently become at-most-once)
        "pending": pending,
        "pending_readbacks": pending_reads,
        "host_states": pickle.dumps(host),
        "has_array_states": bool(arr),
    }
    budget = _tile_budget()
    if budget > 0:
        tiled = _write_full_tiles(path, sched, host, budget,
                                  crash=crash)
        if tiled is not None:
            # keyed state lives in the tile files; meta keeps only the
            # residual (non-map host states) and the descriptor
            meta["sink_views"] = {}
            meta["host_states"] = pickle.dumps(
                {nid: st for nid, st in host.items()
                 if not _splittable(st)})
            meta["tiled"] = tiled
    states_bytes = 0
    if arr:
        meta["states_dir"], states_bytes = _save_array_states(
            path, arr, sched._tick)
    # a WAL-backed scheduler (wal/durable.py): everything the log holds
    # up to now is covered by this checkpoint. Rotate so the whole
    # covered history sits in sealed segments, record the fresh
    # segment's start as the replay position, and drop the sealed
    # segments once the save has fully landed (never before — a failed
    # save must leave the tail replayable).
    wal = getattr(sched, "wal", None)
    if wal is not None:
        wal.sync()
        wal.rotate()
        meta["wal_pos"] = tuple(wal.position())
        wal.append({"kind": "ckpt", "tick": sched._tick,
                    "path": os.path.abspath(path)})
    if crash is not None:
        crash.point("ckpt_before_meta")
    # the commit point: meta names its state files and tiles, and lands
    # whole or not at all; then reap what no meta references any more
    mtmp = os.path.join(path, "meta.pkl.tmp")
    _write_file(mtmp, lambda f: pickle.dump(meta, f))
    os.replace(mtmp, os.path.join(path, "meta.pkl"))
    _fsync_dir(path)
    _reap(path, meta)
    meta["states_bytes"] = states_bytes
    if wal is not None and truncate:
        from reflow_tpu_torch.wal.log import LogPosition

        wal.truncate_until(LogPosition(*meta["wal_pos"]))
    return meta, arr


def _reap(path: str, meta: dict) -> None:
    """Remove the state directories and tile files of ``path`` that
    ``meta`` does not name (a superseded save's, or a crashed one's)."""
    import shutil

    for fname in os.listdir(path):
        if fname.startswith("states") and fname != meta.get("states_dir"):
            shutil.rmtree(os.path.join(path, fname), ignore_errors=True)
    tile_dir = os.path.join(path, _TILE_DIR)
    if not os.path.isdir(tile_dir):
        return
    live = set((meta.get("tiled") or {}).get("files", ()))
    for fname in os.listdir(tile_dir):
        if os.path.join(_TILE_DIR, fname) not in live:
            try:
                os.remove(os.path.join(tile_dir, fname))
            except OSError:
                pass


def load_checkpoint(sched, path: str) -> Dict:
    """Restore into a scheduler whose graph/executor match the saved one.
    ``path`` may be a legacy full checkpoint directory (``meta.pkl``) or
    a :class:`CheckpointChain` directory (``chain.json``) — a chain is
    restored base-then-deltas. Returns the checkpoint meta dict
    (``wal.recovery.recover`` reads the recorded WAL replay position,
    ``"wal_pos"``, from it)."""
    if os.path.exists(os.path.join(path, CHAIN_MANIFEST)):
        return load_chain(sched, path)
    return _load_full(sched, path)


def _load_full(sched, path: str, part: bool = False) -> Dict:
    """The legacy single-directory restore (meta.pkl + the array states'
    directory it names); ``part``: one process's part of a collective
    save."""
    from collections import Counter

    from reflow_tpu_torch.parallel import dist

    try:
        with open(os.path.join(path, "meta.pkl"), "rb") as f:
            meta = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError) as e:
        raise CheckpointError(f"{path}: unreadable checkpoint meta "
                              f"({e})", torn=True) from e
    k = meta.get("process_count", 1)
    if not part and k != dist.process_count():
        raise ValueError(
            f"{path}: written by {k} process(es); this job has "
            f"{dist.process_count()} — restore with the process count it "
            f"was saved with")
    if "procs" in meta:
        if meta["mesh_shape"] != _mesh_shape(sched):
            raise ValueError(
                f"{path}: saved from a mesh of shape {meta['mesh_shape']}, "
                f"restoring onto {_mesh_shape(sched)}")
        return _load_full(sched, os.path.join(
            path, meta["procs"][dist.process_index()]), part=True)
    sched._tick = meta["tick"]
    sched._seen_batch_ids = dict(meta["seen_batch_ids"])
    sched._pending.clear()
    for nid, batches in meta["pending"].items():
        sched._pending[nid].extend(batches)
    for name, d in meta["sink_views"].items():
        sched.sink_views[name] = Counter(d)
    states = dict(pickle.loads(meta["host_states"]))
    tiled = meta.get("tiled")
    if tiled is not None:
        # keyed state streams back one tile frame at a time — peak
        # extra allocation is the largest single frame, not O(state)
        for name in tiled["views_cls"]:
            sched.sink_views[name] = Counter()
        acc: Dict = {nid: {} for nid in tiled["host_cls"]}
        for rel in tiled["files"]:
            payload = _read_tile_file(os.path.join(path, rel))
            for name, kv in payload["views"].items():
                sched.sink_views[name].update(kv)
            for nid, kv in payload["host"].items():
                acc[nid].update(kv)
        for nid, cls in tiled["host_cls"].items():
            states[nid] = _make_cls(cls)(acc[nid])
    if meta["has_array_states"]:
        states.update(_load_array_states(
            os.path.join(path, meta["states_dir"]), sched.executor))
    sched.executor.states = states
    # arena occupancy (rcount) and the sticky overflow flag travel inside
    # the checkpointed state tree itself; the Join lowering's high-water
    # check needs no host-side tracker reconstruction after restore.
    # Derived caches keyed to state content
    # (the linear fixpoint's sorted-arena CSR) must drop, though: two
    # lineages can share a (gen, rcount) pair over different arena rows,
    # so the in-program validity predicate alone cannot see the swap.
    sched.executor.on_states_replaced()
    return meta


# -- incremental checkpoint chain ------------------------------------------


def read_chain_manifest(root: str) -> Optional[dict]:
    """The chain manifest as a dict, or None when ``root`` is not a
    chain directory. Raises :class:`CheckpointError` on unparseable
    JSON (a half-written manifest is a broken chain, not an empty one —
    the flip is atomic, so this only happens under real corruption)."""
    path = os.path.join(root, CHAIN_MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"{path}: unreadable chain manifest "
                              f"({e})") from e


def chain_head_wal_pos(root: str):
    """The newest chain element's recorded WAL anchor as a
    ``(segment, offset)`` tuple, or None (no chain / no WAL)."""
    m = read_chain_manifest(root)
    if m is None or m.get("wal_pos") is None:
        return None
    return tuple(m["wal_pos"])


def _write_delta_file(path: str, payload: dict) -> int:
    body = pickle.dumps(payload)
    frame = (_DELTA_MAGIC + _DELTA_HEADER.pack(len(body),
                                               zlib.crc32(body)) + body)
    with open(path, "wb") as f:
        f.write(frame)
        f.flush()
        os.fsync(f.fileno())
    return len(frame)


def _scan_delta_frames(path: str) -> List[int]:
    """Validate every frame of a delta element (magic, lengths, CRCs)
    WITHOUT keeping payloads resident; returns the byte offset of each
    frame header. Raises :class:`CheckpointError` (``torn=True``) on
    any torn byte — validation runs before a single frame is applied,
    so a torn element never half-mutates the restoring scheduler."""
    try:
        f = open(path, "rb")
    except OSError as e:
        raise CheckpointError(f"{path}: missing delta element ({e})",
                              torn=True) from e
    with f:
        magic = f.read(len(_DELTA_MAGIC))
        if magic != _DELTA_MAGIC:
            raise CheckpointError(f"{path}: bad delta magic "
                                  f"{magic!r}", torn=True)
        size = os.fstat(f.fileno()).st_size
        off = len(_DELTA_MAGIC)
        offsets: List[int] = []
        while off < size:
            hdr = f.read(_DELTA_HEADER.size)
            if len(hdr) < _DELTA_HEADER.size:
                raise CheckpointError(f"{path}: truncated delta "
                                      f"header", torn=True)
            length, crc = _DELTA_HEADER.unpack(hdr)
            body = f.read(length)
            if len(body) < length:
                raise CheckpointError(
                    f"{path}: truncated delta payload ({len(body)}/"
                    f"{length} bytes)", torn=True)
            if zlib.crc32(body) != crc:
                raise CheckpointError(f"{path}: delta CRC mismatch",
                                      torn=True)
            offsets.append(off)
            off += _DELTA_HEADER.size + length
    if not offsets:
        raise CheckpointError(f"{path}: empty delta element",
                              torn=True)
    return offsets


def _read_frame_at(f, path: str, off: int) -> dict:
    """One already-CRC-validated frame from an open element file."""
    f.seek(off)
    length, _crc = _DELTA_HEADER.unpack(f.read(_DELTA_HEADER.size))
    body = f.read(length)
    TILE_IO_STATS["reader_peak_frame_bytes"] = max(
        TILE_IO_STATS["reader_peak_frame_bytes"], len(body))
    try:
        return pickle.loads(body)
    except Exception as e:  # noqa: BLE001 - framed+CRC-clean yet unloadable
        raise CheckpointError(f"{path}: unpicklable delta payload "
                              f"({e})", torn=True) from e


def _read_delta_file(path: str) -> dict:
    """Parse one framed delta element into a single merged payload
    (non-streaming convenience — tools and inspection; the chain
    loader streams instead). Raises :class:`CheckpointError`
    (``torn=True``) on missing/short/CRC-torn bytes — the condition
    the chain loader answers by falling back one element."""
    offsets = _scan_delta_frames(path)
    with open(path, "rb") as f:
        payload = _read_frame_at(f, path, offsets[0])
        ntiles = int(payload.get("tiles", 0) or 0)
        if ntiles != len(offsets) - 1:
            raise CheckpointError(
                f"{path}: tiled delta frame count mismatch "
                f"({len(offsets) - 1}/{ntiles} tile frames)", torn=True)
        for off in offsets[1:]:
            tp = _read_frame_at(f, path, off)
            for sink, kv in tp["view_deltas"].items():
                payload.setdefault("view_deltas", {}).setdefault(
                    sink, {}).update(kv)
            for nid, ent in tp["host_states"].items():
                cur = payload.setdefault("_tiled_host", {}).setdefault(
                    nid, (ent["cls"], {}))
                cur[1].update(ent["items"])
        for nid, (cls, items) in payload.pop("_tiled_host", {}).items():
            payload["host_states"][nid] = pickle.dumps(
                _make_cls(cls)(items))
    return payload


def _apply_delta(sched, payload: dict) -> None:
    from collections import Counter

    sched._tick = payload["tick"]
    for sink, kv in payload["view_deltas"].items():
        view = sched.sink_views.get(sink)
        if view is None:
            view = sched.sink_views[sink] = Counter()
        for k, v in kv.items():
            if v is None:
                view.pop(k, None)
            else:
                view[k] = v
    states = sched.executor.states
    for nid, blob in payload["host_states"].items():
        states[nid] = pickle.loads(blob)
    for nid, host_tree in (payload.get("array_states") or {}).items():
        live = states.get(nid)
        if live is not None and _is_array_state(live):
            # each leaf copied onto the live leaf's device and dtype (the
            # full restore's placement)
            _check_like(str(nid), host_tree, live)
            states[nid] = tree_map(
                lambda h, lv: h.to(device=lv.device, dtype=lv.dtype),
                host_tree, live)
        else:
            states[nid] = host_tree
    for b in payload["ids_added"]:
        sched._seen_batch_ids[b] = None
    for _ in range(payload["ids_dropped"]):
        if not sched._seen_batch_ids:
            break
        sched._seen_batch_ids.pop(next(iter(sched._seen_batch_ids)))
    sched._pending.clear()
    for nid, batches in payload["pending"].items():
        sched._pending[nid].extend(batches)


def _apply_delta_tiles(sched, f, path: str, offsets: List[int]) -> None:
    """Stream a tiled delta's tile frames into the scheduler: view
    deltas merge per frame (tile key ranges are disjoint), changed
    splittable host states accumulate their slices and replace the
    live state whole — the same replace semantics the monolithic
    delta's pickled blob has."""
    from collections import Counter

    acc: Dict = {}
    for off in offsets:
        tp = _read_frame_at(f, path, off)
        for sink, kv in tp["view_deltas"].items():
            view = sched.sink_views.get(sink)
            if view is None:
                view = sched.sink_views[sink] = Counter()
            for k, v in kv.items():
                if v is None:
                    view.pop(k, None)
                else:
                    view[k] = v
        for nid, ent in tp["host_states"].items():
            cur = acc.setdefault(nid, (ent["cls"], {}))
            cur[1].update(ent["items"])
    states = sched.executor.states
    for nid, (cls, items) in acc.items():
        states[nid] = _make_cls(cls)(items)


def load_chain(sched, root: str) -> Dict:
    """Restore a :class:`CheckpointChain` directory: the base full
    checkpoint, then every delta element in manifest order. A broken
    link anywhere mid-chain (missing/corrupt element, parent or horizon
    mismatch) fails loud; a torn/partial *final* delta falls back to
    the previous chain element — the WAL still covers its window
    because truncation lags one element. Returns a meta dict whose
    ``"wal_pos"`` is the last successfully applied element's anchor."""
    manifest = read_chain_manifest(root)
    if manifest is None:
        raise CheckpointError(f"{root}: no chain manifest")
    base = manifest["base"]
    meta = _load_full(sched, os.path.join(root, base))
    wal_pos = meta.get("wal_pos")
    prev_name = base
    applied = 0
    fallback = None
    deltas: List[str] = list(manifest.get("deltas", []))
    for i, dname in enumerate(deltas):
        dpath = os.path.join(root, dname)
        try:
            # whole-file CRC validation first (bounded memory), THEN
            # frame-by-frame apply: a torn element — torn in ANY tile
            # frame — is detected before a single byte is applied, so
            # the final-element fallback leaves clean state
            offsets = _scan_delta_frames(dpath)
            with open(dpath, "rb") as df:
                payload = _read_frame_at(df, dpath, offsets[0])
                ntiles = int(payload.get("tiles", 0) or 0)
                if ntiles != len(offsets) - 1:
                    raise CheckpointError(
                        f"{dpath}: tiled delta frame count mismatch "
                        f"({len(offsets) - 1}/{ntiles} tile frames)",
                        torn=True)
                if payload.get("parent") != prev_name \
                        or payload.get("base_tick") != sched._tick:
                    raise CheckpointError(
                        f"{root}/{dname}: broken chain link (parent "
                        f"{payload.get('parent')!r} @ tick "
                        f"{payload.get('base_tick')!r}, expected "
                        f"{prev_name!r} @ tick {sched._tick})")
                _apply_delta(sched, payload)
                if ntiles:
                    _apply_delta_tiles(sched, df, dpath, offsets[1:])
        except CheckpointError as e:
            if e.torn and i == len(deltas) - 1:
                # torn tail of the chain: fall back one element, the
                # WAL tail (truncation lagged one save) replays the gap
                fallback = str(e)
                break
            raise
        if payload.get("wal_pos") is not None:
            wal_pos = tuple(payload["wal_pos"])
        prev_name = dname
        applied += 1
    sched.executor.on_states_replaced()
    out = {
        "tick": sched._tick,
        "wal_pos": wal_pos,
        "seen_batch_ids": dict(sched._seen_batch_ids),
        "chain": {"base": base, "deltas_applied": applied,
                  "deltas_total": len(deltas), "fallback": fallback},
    }
    if wal_pos is None:
        out.pop("wal_pos")
    return out


class CheckpointChain:
    """Writer side of the bounded-history checkpoint chain.

    ``save(sched)`` takes a cheap **delta** element (only the sinks,
    per-source states, dedup-window entries and pending buffers that
    changed since the previous element), promoting to a **full**
    checkpoint every ``delta_every``-th save (or when forced with
    ``full=True``; the very first save is always full). Every save
    follows the WAL choreography of ``save_checkpoint`` — sync, rotate,
    record the fresh segment start as the element's anchor — and then
    truncates the log up to the *previous* element's anchor (lag-one:
    a torn final delta must leave its window replayable from the WAL).

    The atomic commit point of every save is the ``chain.json``
    manifest flip (write-tmp + fsync + ``os.replace``): a crash before
    the flip leaves the previous chain fully restorable, a crash after
    it leaves the new one. ``crash`` is a
    :class:`~reflow_tpu_torch.utils.faults.CrashInjector` seam hook
    (``ckpt_full_before_flip`` / ``ckpt_delta_before_flip`` /
    ``ckpt_delta_after_flip``, plus the per-tile seams
    ``ckpt_tile_full_append`` / ``ckpt_tile_append`` when
    ``REFLOW_TILE_BYTES`` tiles the elements) for the differential
    crash tests."""

    def __init__(self, root: str, *, delta_every: Optional[int] = None,
                 crash=None):
        from reflow_tpu_torch.utils.config import env_int

        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.delta_every = (delta_every if delta_every is not None
                            else env_int("REFLOW_CKPT_DELTA_EVERY"))
        self._crash = crash
        self.saves = 0
        self.fulls = 0
        self.deltas = 0
        self.delta_bytes = 0
        #: bytes of array state read back to the host to diff and
        #: shadow the elements (every save reads all of it back)
        self.readback_bytes = 0
        #: tile shape of the newest element (0 = monolithic) and the
        #: largest tile frame any save of this chain ever pickled
        self.tile_count = 0
        self.peak_tile_bytes = 0
        self._metric_names: List = []
        #: what the previous element looked like, for diffing; None
        #: forces the next save to be full (fresh writer, fresh chain)
        self._shadow: Optional[dict] = None

    def _crash_point(self, name: str) -> None:
        if self._crash is not None:
            self._crash.point(name)

    # -- shadow bookkeeping ------------------------------------------------

    def _classify_states(self, states: Dict, arr: Optional[Dict] = None):
        """(host {nid: pickled bytes}, array {nid: host tree of CPU
        tensors}) — both forms are diffable host-side. The array states
        come back to the host here (one synchronize, one ``.cpu()`` a
        leaf) unless ``arr`` holds the trees the save already read back;
        ``readback_bytes`` adds up their size once a save."""
        dev, host_st = _split_states(states)
        host = {nid: pickle.dumps(st) for nid, st in host_st.items()}
        if arr is None:
            arr = _host_trees(dev)
        self.readback_bytes += _tree_bytes(arr)
        return host, arr

    def _snapshot(self, sched, arr: Dict) -> dict:
        host, arr = self._classify_states(sched.executor.states, arr)
        return {
            "tick": sched._tick,
            "views": {name: dict(c)
                      for name, c in sched.sink_views.items()},
            "host": host,
            "arr_blobs": {nid: _state_blob(t) for nid, t in arr.items()},
            "ids": dict(sched._seen_batch_ids),
        }

    # -- saves -------------------------------------------------------------

    def _wal_anchor(self, sched):
        """sync+rotate the scheduler's WAL (if any) and return the
        fresh segment start — the element's replay anchor."""
        wal = getattr(sched, "wal", None)
        if wal is None:
            return None
        wal.sync()
        wal.rotate()
        pos = tuple(wal.position())
        wal.append({"kind": "ckpt", "tick": sched._tick,
                    "path": self.root})
        return pos

    def _flip_manifest(self, manifest: dict) -> None:
        path = os.path.join(self.root, CHAIN_MANIFEST)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _truncate_to(self, sched, wal_pos) -> None:
        wal = getattr(sched, "wal", None)
        if wal is None or wal_pos is None:
            return
        from reflow_tpu_torch.wal.log import LogPosition

        wal.truncate_until(LogPosition(*wal_pos))

    def save(self, sched, *, full: Optional[bool] = None) -> dict:
        """Take one chain element; returns an info dict (kind, element
        name, tick horizon, anchor, bytes written)."""
        want_full = (full if full is not None
                     else (self._shadow is None or self.delta_every <= 1
                           or self.saves % self.delta_every == 0))
        if self._shadow is None:
            want_full = True
        info = (self._save_full(sched) if want_full
                else self._save_delta(sched))
        self.saves += 1
        return info

    def _save_full(self, sched) -> dict:
        old = read_chain_manifest(self.root) if os.path.exists(
            os.path.join(self.root, CHAIN_MANIFEST)) else None
        name = f"full-{self.saves:06d}"
        path = os.path.join(self.root, name)
        # truncate=False: the log must stay intact until the manifest
        # names this full as the new chain base — a crash between the
        # save and the flip restores the OLD chain, whose last element
        # still needs its replay tail
        meta, arr = _save_checkpoint(sched, path, truncate=False,
                                     crash=self._crash)
        tiled = meta.get("tiled")
        self.tile_count = tiled["n"] if tiled else 0
        if tiled:
            self.peak_tile_bytes = max(self.peak_tile_bytes,
                                       tiled["peak_tile_bytes"])
        wal = getattr(sched, "wal", None)
        wal_pos = meta.get("wal_pos") if wal is not None else None
        self._crash_point("ckpt_full_before_flip")
        manifest = {
            "schema": CHAIN_SCHEMA,
            "base": name,
            "deltas": [],
            "horizon": sched._tick,
            "wal_pos": list(wal_pos) if wal_pos is not None else None,
            "saves": self.saves + 1,
        }
        if tiled:
            manifest["tiles"] = {"count": tiled["n"],
                                 "budget": tiled["budget"],
                                 "peak_tile_bytes":
                                     tiled["peak_tile_bytes"]}
        self._flip_manifest(manifest)
        self._truncate_to(sched, wal_pos)
        self._gc(old)
        self._shadow = self._snapshot(sched, arr)
        self._shadow["wal_pos"] = wal_pos
        self._shadow["name"] = name
        self.fulls += 1
        return {"kind": "full", "element": name, "tick": sched._tick,
                "wal_pos": wal_pos, "states_bytes": meta["states_bytes"]}

    def _save_delta(self, sched) -> dict:
        shadow = self._shadow
        host, arr = self._classify_states(sched.executor.states)
        host_changed = {nid: blob for nid, blob in host.items()
                        if shadow["host"].get(nid) != blob}
        blobs = {nid: _state_blob(tree) for nid, tree in arr.items()}
        arr_changed = {nid: tree for nid, tree in arr.items()
                       if shadow["arr_blobs"].get(nid) != blobs[nid]}
        view_deltas: Dict[str, Dict] = {}
        for name, c in sched.sink_views.items():
            old = shadow["views"].get(name, {})
            kv = {k: v for k, v in c.items() if old.get(k) != v}
            kv.update({k: None for k in old if k not in c})
            if kv:
                view_deltas[name] = kv
        new_ids = dict(sched._seen_batch_ids)
        added = [b for b in new_ids if b not in shadow["ids"]]
        dropped = len(shadow["ids"]) + len(added) - len(new_ids)
        budget = _tile_budget()
        tile_plan = None
        split_changed: Dict = {}
        if budget > 0:
            for nid in host_changed:
                st = sched.executor.states.get(nid)
                if st is not None and _splittable(st):
                    split_changed[nid] = st
            tile_plan = _plan_keyed(
                list(view_deltas.values()) + list(split_changed.values()),
                budget)
            if tile_plan is None:
                split_changed = {}
        wal_pos = self._wal_anchor(sched)
        payload = {
            "tick": sched._tick,
            "base_tick": shadow["tick"],
            "parent": shadow["name"],
            "view_deltas": view_deltas if tile_plan is None else {},
            "host_states": (host_changed if tile_plan is None else
                            {nid: b for nid, b in host_changed.items()
                             if nid not in split_changed}),
            "array_states": {nid: t for nid, t in arr_changed.items()},
            "ids_added": added,
            "ids_dropped": max(0, dropped),
            "pending": _host_pending(sched)[0],
            "wal_pos": wal_pos,
        }
        name = f"delta-{self.saves:06d}.ckd"
        if tile_plan is None:
            self.tile_count = 0
            nbytes = _write_delta_file(os.path.join(self.root, name),
                                       payload)
        else:
            payload["tiles"] = len(tile_plan)
            nbytes = self._write_delta_tiles(
                os.path.join(self.root, name), payload, tile_plan,
                view_deltas, split_changed)
            self.tile_count = len(tile_plan)
        self._crash_point("ckpt_delta_before_flip")
        manifest = read_chain_manifest(self.root)
        manifest["deltas"] = list(manifest.get("deltas", [])) + [name]
        manifest["horizon"] = sched._tick
        manifest["wal_pos"] = (list(wal_pos) if wal_pos is not None
                               else None)
        manifest["saves"] = self.saves + 1
        if tile_plan is not None:
            manifest["tiles"] = {"count": len(tile_plan),
                                 "budget": budget,
                                 "peak_tile_bytes":
                                     self.peak_tile_bytes}
        self._flip_manifest(manifest)
        self._crash_point("ckpt_delta_after_flip")
        # lag-one truncation: keep the log back to the PREVIOUS
        # element's anchor, so a torn copy of the element we just wrote
        # falls back one link and replays its window from the WAL
        self._truncate_to(sched, shadow.get("wal_pos"))
        self._shadow = {"tick": sched._tick,
                        "views": {name: dict(c)
                                  for name, c in sched.sink_views.items()},
                        "host": host, "arr_blobs": blobs,
                        "ids": new_ids}
        self._shadow["wal_pos"] = wal_pos
        self._shadow["name"] = name
        self.deltas += 1
        self.delta_bytes += nbytes
        return {"kind": "delta", "element": name, "tick": sched._tick,
                "wal_pos": wal_pos, "bytes": nbytes,
                "changed_sources": sorted(
                    list(host_changed) + list(arr_changed))}

    def _write_delta_tiles(self, path: str, header: dict, plan,
                           view_deltas: Dict,
                           split_changed: Dict) -> int:
        """Write a tiled delta element: frame 0 is the small header
        payload, then one CRC frame per key-range tile. One tile's
        slice is pickled at a time — writer peak is the largest tile
        frame, not the whole delta."""
        import time

        from reflow_tpu_torch.obs import trace as _trace

        peak = 0
        view_slices = _slice_by_tile(view_deltas, plan)
        host_slices = _slice_by_tile(split_changed, plan)
        with open(path, "wb") as f:
            f.write(_DELTA_MAGIC)
            n = len(_DELTA_MAGIC)
            hbody = pickle.dumps(header)
            f.write(_DELTA_HEADER.pack(len(hbody), zlib.crc32(hbody)))
            f.write(hbody)
            n += _DELTA_HEADER.size + len(hbody)
            for t, (lo, hi) in enumerate(plan):
                t0 = time.perf_counter()
                tp = {
                    "range": [lo, hi],
                    "view_deltas": view_slices[t],
                    "host_states": {nid: {"cls": _cls_name(
                                              split_changed[nid]),
                                          "items": items}
                                    for nid, items in
                                    host_slices[t].items()},
                }
                body = pickle.dumps(tp)
                TILE_IO_STATS["writer_peak_frame_bytes"] = max(
                    TILE_IO_STATS["writer_peak_frame_bytes"],
                    len(body))
                peak = max(peak, len(body))
                f.write(_DELTA_HEADER.pack(len(body),
                                           zlib.crc32(body)))
                f.write(body)
                n += _DELTA_HEADER.size + len(body)
                f.flush()
                self._crash_point("ckpt_tile_append")
                if _trace.ENABLED:
                    _trace.evt("ckpt_tile", t0,
                               time.perf_counter() - t0,
                               track="checkpoint",
                               args={"tile": t, "of": len(plan),
                                     "kind": "delta",
                                     "bytes": len(body)})
            f.flush()
            os.fsync(f.fileno())
        self.peak_tile_bytes = max(self.peak_tile_bytes, peak)
        return n

    def publish_metrics(self, registry=None, name: str = "ckpt"
                        ) -> None:
        from reflow_tpu_torch.obs.registry import REGISTRY

        reg = registry if registry is not None else REGISTRY
        reg.gauge(f"{name}.saves", lambda: self.saves)
        reg.gauge(f"{name}.fulls", lambda: self.fulls)
        reg.gauge(f"{name}.deltas", lambda: self.deltas)
        reg.gauge(f"{name}.delta_bytes", lambda: self.delta_bytes)
        reg.gauge(f"{name}.tile_count", lambda: self.tile_count)
        reg.gauge(f"{name}.peak_tile_bytes",
                  lambda: self.peak_tile_bytes)
        self._metric_names.append((reg, name))

    def close(self) -> None:
        for reg, name in self._metric_names:
            reg.unregister_prefix(name)
        self._metric_names.clear()

    def _gc(self, old_manifest: Optional[dict]) -> None:
        """Drop the superseded chain's elements (best-effort; stray
        files from a crashed save are harmless and reaped next full)."""
        import shutil

        if old_manifest is None:
            return
        for dname in old_manifest.get("deltas", []):
            try:
                os.remove(os.path.join(self.root, dname))
            except OSError:
                pass
        base = old_manifest.get("base")
        if base:
            shutil.rmtree(os.path.join(self.root, base),
                          ignore_errors=True)

    def restore(self, sched) -> Dict:
        """Reader convenience: :func:`load_chain` over this root."""
        return load_chain(sched, self.root)
