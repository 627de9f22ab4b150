"""Admission queues: per-source bounded FIFOs under an injected byte
budget.

Pure data structure — every method is called with the frontend's lock
held; no locking happens here. The two admission limits compose:

- ``max_batches`` bounds each SOURCE's queue depth (a slow source can't
  starve the rest);
- the :class:`~reflow_tpu_torch.serve.budget.BudgetShare` bounds the TOTAL
  in-flight payload (queued + currently executing) — per frontend when
  the frontend built its own budget, across every graph of a
  ``ServeTier`` when the share belongs to a tier-wide
  ``AdmissionBudget``.

What happens when a limit is hit is the frontend's backpressure policy
(``block`` / ``reject`` / ``shed-oldest``); this module only answers
"is there room" and "which entries would shedding evict".
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

from reflow_tpu_torch.graph import Node

from .tickets import Ticket

__all__ = ["Entry", "SourceQueues", "batch_nbytes"]


def _col_nbytes(col) -> int:
    if isinstance(col, torch.Tensor):
        return col.numel() * col.element_size()
    return int(getattr(col, "nbytes", 0) or 0)


def batch_nbytes(batch) -> int:
    """Payload bytes of a delta batch: a host ``DeltaBatch`` (numpy
    columns) or a ``DeviceDelta`` (tensors) — shape metadata on both,
    never a device sync."""
    return sum(_col_nbytes(col)
               for col in (batch.keys, batch.values, batch.weights))


@dataclasses.dataclass
class Entry:
    """One admitted micro-batch waiting for (or riding) a macro-tick."""

    ticket: Ticket
    source: Node
    batch: object                # DeltaBatch or device-resident batch
    batch_id: str
    nbytes: int
    t_admitted: float
    #: device-resident batches ride a feed slot ALONE (the
    #: one-per-source-per-tick rule; host concat would force a readback)
    device: bool
    #: host row count (0 for device batches — len() would read back)
    rows: int
    #: host-side pre-image of a device batch, captured at submit()
    #: BEFORE upload so a durable scheduler can log it without a forced
    #: readback (None for host batches or when the producer has none)
    preimage: object = None


class SourceQueues:
    def __init__(self, max_batches: int, budget):
        self.max_batches = max_batches
        #: BudgetShare holding this graph's in-flight bytes (queued +
        #: executing); acquire on push, release on shed/commit
        self.budget = budget
        self._q: Dict[int, Deque[Entry]] = {}
        self.queued_batches = 0
        self.queued_rows = 0
        self.queued_bytes = 0
        #: bytes drained into an executing macro-tick but not yet
        #: committed — still counted against the budget
        self.executing_bytes = 0

    @property
    def max_bytes(self) -> int:
        """This frontend's effective byte cap (guaranteed-reachable
        in-flight total) — the reject-reason bound."""
        return self.budget.max_alone

    # -- admission ---------------------------------------------------------

    def room_for(self, source_id: int, nbytes: int) -> bool:
        depth = len(self._q.get(source_id, ()))
        return depth < self.max_batches and self.budget.room_for(nbytes)

    def fits_alone(self, nbytes: int) -> bool:
        """Could this batch EVER be admitted (empty queues)? False means
        the batch alone exceeds the byte budget — reject, don't shed."""
        return self.budget.fits_alone(nbytes)

    def push(self, entry: Entry) -> None:
        self._q.setdefault(entry.source.id, deque()).append(entry)
        self.queued_batches += 1
        self.queued_rows += entry.rows
        self.queued_bytes += entry.nbytes
        self.budget.acquire(entry.nbytes)

    def shed_for(self, source_id: int, nbytes: int) -> List[Entry]:
        """Evict oldest-first until ``room_for`` holds: first from the
        submitting source's own queue (depth limit), then globally
        oldest (byte budget; only THIS graph's entries are sheddable —
        a tier sibling's backlog is never another graph's to evict).
        Returns the evicted entries — the caller resolves their tickets
        as SHED."""
        out: List[Entry] = []
        q = self._q.get(source_id)
        while q and len(q) >= self.max_batches:
            out.append(self._pop_entry(q))
        while not self.budget.room_for(nbytes):
            oldest: Optional[Deque[Entry]] = None
            for dq in self._q.values():
                if dq and (oldest is None
                           or dq[0].t_admitted < oldest[0].t_admitted):
                    oldest = dq
            if oldest is None:
                break  # nothing left to shed (executing bytes or a
                # sibling graph's admissions hold the budget)
            out.append(self._pop_entry(oldest))
        return out

    def _pop_entry(self, dq: Deque[Entry]) -> Entry:
        e = dq.popleft()
        self.queued_batches -= 1
        self.queued_rows -= e.rows
        self.queued_bytes -= e.nbytes
        self.budget.release(e.nbytes)
        return e

    # -- pump side ---------------------------------------------------------

    def oldest_t(self) -> Optional[float]:
        ts = [dq[0].t_admitted for dq in self._q.values() if dq]
        return min(ts) if ts else None

    def pending_feed_rounds(self, max_rows: int) -> int:
        """How many macro-tick feeds the current backlog would unfold
        into (the max-ticks coalescing trigger): per source, each
        device batch needs its own feed slot and host rows pack
        ``max_rows`` per slot; feeds form in parallel across sources,
        so the count is the max over sources."""
        rounds = 0
        for dq in self._q.values():
            dev = sum(1 for e in dq if e.device)
            host_rows = sum(e.rows for e in dq if not e.device)
            r = dev + (host_rows + max_rows - 1) // max_rows if dq else 0
            rounds = max(rounds, r)
        return rounds

    def drain_all(self) -> Dict[int, List[Entry]]:
        """Take the whole backlog (per-source FIFO order preserved);
        their bytes move to ``executing_bytes`` — still held against
        the budget — until the caller calls :meth:`commit_executing`."""
        out = {sid: list(dq) for sid, dq in self._q.items() if dq}
        self.executing_bytes += self.queued_bytes
        self._q.clear()
        self.queued_batches = 0
        self.queued_rows = 0
        self.queued_bytes = 0
        return out

    def commit_executing(self) -> None:
        if self.executing_bytes:
            self.budget.release(self.executing_bytes)
        self.executing_bytes = 0

    def release_executing(self, nbytes: int) -> int:
        """Release part of ``executing_bytes`` back to the budget — the
        pipelined pump's stage-complete release: once a window's rows
        are slot-written into the device ingress queue, their HOST
        payload no longer occupies the frontend, so producers may be
        admitted against that room while the window is still in flight.
        Clamped to what is actually held; returns the bytes released."""
        n = min(int(nbytes), self.executing_bytes)
        if n > 0:
            self.executing_bytes -= n
            self.budget.release(n)
        return n
