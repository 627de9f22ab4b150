"""Key-range tiling for O(state) maintenance paths.

The port's copy of ``reflow_tpu/utils/tiles.py`` (numpy only): a key
must land in the same bucket whichever package computes it, so the two
copies stay identical below this paragraph.

Compaction, checkpointing, and replica snapshot publication all walk
the full keyed state of a graph.  Monolithically that is O(state) peak
host memory — fine for demos, fatal at "millions of users" sizes.  The
shared move (the same one LSM compaction and sharded checkpoint
restore make) is to partition the key space into contiguous *tiles*
and process one tile at a time under a byte budget.

The partition must be stable across processes and across time: the
compactor, the checkpoint writer, a restoring replica, and the tile
shipper all need to agree on which tile owns a row key without
exchanging state.  So tiling is two-level:

- every row key hashes to one of ``N_BUCKETS`` fixed *buckets*
  (``bucket_of``) — deterministic, process-independent, and
  insensitive to insertion order;
- contiguous bucket runs are greedily grouped into *tiles* whose
  estimated resident bytes fit the ``REFLOW_TILE_BYTES`` budget
  (``plan_tiles``), from a cheap histogram pass the caller supplies.

A tile is then just a ``(lo, hi)`` half-open bucket range; ownership
is ``lo <= bucket_of(key) < hi``.  Budget 0 (the default) disables
tiling everywhere — callers fall back to their monolithic paths
byte-for-byte unchanged.
"""

from __future__ import annotations

import sys
import zlib
from typing import Any, List, Sequence, Tuple

import numpy as np

#: fixed bucket count — the histogram resolution.  Small enough that a
#: per-bucket byte histogram is trivially cheap, large enough that a
#: budget forcing dozens of tiles still gets balanced cuts.
N_BUCKETS = 64


def _scalarize(x: Any) -> Any:
    """Hashable, value-stable form of a row key (mirrors the WAL
    compactor's scalarization so folded and live rows agree)."""
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    return x


def bucket_of(rowkey: Any, n_buckets: int = N_BUCKETS) -> int:
    """Deterministic bucket for a row key.

    crc32 over the repr of the scalarized key: stable across
    processes and Python hash randomization (``hash()`` is salted per
    process, which would scatter a replica's tiles away from its
    leader's).
    """
    return zlib.crc32(repr(_scalarize(rowkey)).encode()) % n_buckets


def approx_row_bytes(key: Any, value: Any) -> int:
    """Cheap per-row resident-size estimate for the histogram pass.

    Exactness does not matter — tiles only need to land near the
    budget; the enforced bound is 2x budget, sized for estimate slop
    plus one oversized bucket.
    """
    n = 0
    for x in (key, value):
        if isinstance(x, np.ndarray):
            n += x.nbytes
        elif isinstance(x, (bytes, str)):
            n += len(x)
        elif x is not None:
            n += sys.getsizeof(x)
    return n + 16  # dict-slot / weight overhead


def plan_tiles(bucket_bytes: Sequence[float],
               budget: int) -> List[Tuple[int, int]]:
    """Group contiguous buckets into half-open ``(lo, hi)`` tiles.

    Greedy: extend the current tile while it stays under ``budget``;
    a single bucket over budget becomes its own tile (the plan never
    splits a bucket, so one hot bucket can exceed the budget — that is
    why the enforced peak bound is 2x, and why callers replan when a
    tile blows past it).  Returns at least one tile covering the whole
    bucket space; ``budget <= 0`` yields the single monolithic tile.
    """
    n = len(bucket_bytes)
    if budget <= 0 or n == 0:
        return [(0, max(n, 1))]
    tiles: List[Tuple[int, int]] = []
    lo = 0
    acc = 0.0
    for i, b in enumerate(bucket_bytes):
        if i > lo and acc + b > budget:
            tiles.append((lo, i))
            lo = i
            acc = 0.0
        acc += b
    tiles.append((lo, n))
    return tiles


def owning_tile(tiles: Sequence[Tuple[int, int]], bucket: int) -> int:
    """Index of the tile whose ``[lo, hi)`` range holds ``bucket``."""
    for i, (lo, hi) in enumerate(tiles):
        if lo <= bucket < hi:
            return i
    raise KeyError(f"bucket {bucket} outside tile plan {list(tiles)}")
