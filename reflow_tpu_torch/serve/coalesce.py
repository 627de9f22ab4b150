"""Coalescing: fold queued micro-batches into ``tick_many`` macro-ticks.

The window has three triggers (any one fires the pump):

- **max-rows**: enough host rows are queued to fill a merged feed batch;
- **max-ticks**: the backlog would already unfold into that many feeds;
- **max-latency**: the oldest admitted micro-batch has waited long
  enough — the tail-latency bound under light traffic.

Feed construction honors the scheduler's one-per-source-per-tick rule:
host micro-batches for the same source merge via ``DeltaBatch.concat``
(up to ``max_rows`` rows per merged batch); a device-resident batch
takes a feed slot alone (host concat would force a device readback).
Feeds form in parallel across sources — feed ``t`` carries every
source's ``t``-th merged chunk — so steady-state multi-source traffic
rides one macro-tick, not one tick per source.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.graph import Node

from .queues import Entry

__all__ = ["CoalesceWindow", "Feed", "build_feeds"]


@dataclasses.dataclass(frozen=True)
class CoalesceWindow:
    """Coalescing-window configuration (see module docstring)."""

    max_rows: int = 4096        # host rows per merged feed batch
    max_ticks: int = 8          # feeds per tick_many macro-tick
    max_latency_s: float = 0.005  # oldest-entry admission-to-tick bound

    def __post_init__(self):
        if self.max_rows < 1 or self.max_ticks < 1:
            raise ValueError(f"degenerate coalescing window: {self}")


@dataclasses.dataclass
class Feed:
    """One tick's worth of coalesced input."""

    batches: Dict[Node, DeltaBatch]
    ids: Dict[Node, List[str]]
    entries: Dict[Node, List[Entry]]


def _chunk_source(entries: Sequence[Entry], max_rows: int
                  ) -> List[List[Entry]]:
    """Split one source's FIFO backlog into feed chunks: device entries
    alone, host runs merged up to ``max_rows`` rows."""
    chunks: List[List[Entry]] = []
    run: List[Entry] = []
    run_rows = 0
    for e in entries:
        if e.device:
            if run:
                chunks.append(run)
                run, run_rows = [], 0
            chunks.append([e])
            continue
        if run and run_rows + e.rows > max_rows:
            chunks.append(run)
            run, run_rows = [], 0
        run.append(e)
        run_rows += e.rows
    if run:
        chunks.append(run)
    return chunks


def build_feeds(entries_by_source: Dict[int, List[Entry]],
                max_rows: int) -> List[Feed]:
    """Unfold a drained backlog into ordered ``tick_many`` feeds."""
    per_source = {sid: _chunk_source(es, max_rows)
                  for sid, es in entries_by_source.items() if es}
    n_feeds = max((len(c) for c in per_source.values()), default=0)
    feeds: List[Feed] = []
    for t in range(n_feeds):
        batches: Dict[Node, DeltaBatch] = {}
        ids: Dict[Node, List[str]] = {}
        entries: Dict[Node, List[Entry]] = {}
        for chunks in per_source.values():
            if t >= len(chunks):
                continue
            chunk = chunks[t]
            node = chunk[0].source
            if chunk[0].device:
                batches[node] = chunk[0].batch
            elif len(chunk) == 1:
                batches[node] = chunk[0].batch
            else:
                batches[node] = DeltaBatch.concat(
                    [e.batch for e in chunk])
            ids[node] = [e.batch_id for e in chunk]
            entries[node] = list(chunk)
        feeds.append(Feed(batches, ids, entries))
    return feeds
