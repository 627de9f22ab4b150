"""Fault seams: the delivery-contract error, a lossy transport, and
simulated process death.

The port's copy of ``reflow_tpu/utils/faults.py`` without the wire
faults (``WireFaults``, which only the replication transport reads):

- :class:`DeliveryError` — the host boundary refusing a batch that would
  break the delivery contract (the ingress queue raises it for keys
  outside its int32 slot range; :class:`FaultyChannel` raises it when the
  scheduler accepts a duplicate or rejects a first delivery);
- :class:`FaultyChannel` — an at-least-once transport that drops,
  duplicates and reorders batches; with the scheduler's
  ``push(batch_id=...)`` dedup the composition is exactly-once;
- :class:`CrashPoint`, :class:`CrashInjector` and :class:`StormInjector`
  — process death at the N-th instrumented seam (the serve frontend's
  ``producer_*`` / ``pump_*`` seams, the durable scheduler's
  append/tick seams, the WAL committer's write/fsync seams, the
  checkpoint chain's manifest-flip seams), once or at every visit;
- :func:`tear_wal_tail` — the log's final record torn after the fact,
  as a kill mid-write leaves it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.graph import Node
from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["CrashInjector", "CrashPoint", "DeliveryError", "FaultyChannel",
           "StormInjector", "tear_wal_tail"]


class DeliveryError(RuntimeError):
    """The transport observed the scheduler violating the delivery
    contract (a duplicate accepted, or a first delivery rejected)."""


class CrashPoint(BaseException):
    """Simulated process death. Derives from BaseException so generic
    ``except Exception`` recovery paths can't accidentally 'survive'
    the kill — only the test harness catches it."""


class CrashInjector:
    """Raise :class:`CrashPoint` at the N-th instrumented crash seam.

    ``at`` counts every visited seam; ``only`` restricts counting to
    seams whose name contains the substring (e.g. ``"pump"`` to kill the
    serve frontend's pump thread). ``fired`` records whether the kill
    happened; ``fired_seam`` which seam it happened at. A named
    frontend scopes its seams as ``<seam>@<name>``.

    Seam visits are counted under a lock: the serve frontend fires its
    seams from N producer threads and the pump thread concurrently, and
    exactly ONE of them must die.
    """

    def __init__(self, at: int, *, only: Optional[str] = None):
        self.remaining = at
        self.only = only
        self.fired = False
        self.fired_seam: Optional[str] = None
        self.seams: List[str] = []
        self._lock = named_lock("faults.crash")

    def point(self, name: str) -> None:
        with self._lock:
            if self.fired or (self.only is not None
                              and self.only not in name):
                return
            self.seams.append(name)
            self.remaining -= 1
            if self.remaining <= 0:
                self.fired = True
                self.fired_seam = name
                raise CrashPoint(name)


class StormInjector:
    """Raise :class:`CrashPoint` at EVERY visit of matching seams while
    armed — a repeating crash storm, where :class:`CrashInjector` models
    exactly one process death.

    This is the circuit-breaker scenario: a graph whose every revival
    crashes again (a poisoned batch, a broken kernel) must trip the
    control plane's breaker instead of burning the pool in a
    crash-respawn loop; :meth:`disarm` ends the storm so the breaker's
    half-open probe can prove the graph healthy again. ``crashes``
    counts the kills actually delivered."""

    def __init__(self, only: str):
        self.only = only
        self.armed = True
        self.crashes = 0
        self.seams: List[str] = []
        self._lock = named_lock("faults.storm")

    def point(self, name: str) -> None:
        with self._lock:
            if not self.armed or self.only not in name:
                return
            self.crashes += 1
            self.seams.append(name)
        raise CrashPoint(name)

    def disarm(self) -> None:
        self.armed = False

    def rearm(self) -> None:
        self.armed = True


def tear_wal_tail(wal_dir: str, cut_bytes: int) -> Optional[str]:
    """Tear the WAL's final record as a mid-write kill would: strictly
    in the LAST segment (the only one a live writer ever touches). A
    segment with records loses its last ``cut_bytes`` (clamped to the
    8-byte magic header, so the tear models a torn *record*, not a
    missing segment); a freshly-rotated empty segment instead gains a
    partial frame (a header whose payload never landed). Returns the
    torn segment's path, or None for an empty log."""
    from reflow_tpu_torch.wal.log import _MAGIC, list_segments

    segs = list_segments(wal_dir)
    if not segs:
        return None
    _seq, path = segs[-1]
    size = os.path.getsize(path)
    if size > len(_MAGIC):
        with open(path, "rb+") as f:
            f.truncate(max(len(_MAGIC), size - cut_bytes))
    else:
        with open(path, "ab") as f:
            f.write((64).to_bytes(4, "little") + b"\0\0\0\0" + b"\xde\xad")
    return path


class FaultyChannel:
    """At-least-once delivery of source batches with injected faults.

    ``send`` enqueues a batch; each call then attempts delivery of some
    enqueued batches with faults applied. A batch stays queued until a
    delivery attempt is "acked" (survives the drop roll), so nothing is
    ever lost — only delayed, repeated, or reordered. Call ``flush()``
    before the final tick to force the tail retransmissions.
    """

    def __init__(self, sched, source: Node, *, drop_p: float = 0.3,
                 dup_p: float = 0.3, reorder_window: int = 4, seed: int = 0):
        self.sched = sched
        self.source = source
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.reorder_window = reorder_window
        self.rng = np.random.default_rng(seed)
        self._unacked: List[Tuple[str, DeltaBatch]] = []
        self._delivered_ids: List[str] = []   # for duplicate injection
        self.stats = {"delivered": 0, "dropped": 0, "duplicated": 0,
                      "reordered": 0}
        self._batches = {}

    def send(self, batch: DeltaBatch, batch_id: str) -> None:
        self._unacked.append((batch_id, batch))
        self._batches[batch_id] = batch
        self._pump()

    def _pump(self) -> None:
        # reorder: deliver from a window at a random position
        while self._unacked:
            w = min(self.reorder_window, len(self._unacked))
            i = int(self.rng.integers(0, w))
            if i != 0:
                self.stats["reordered"] += 1
            bid, batch = self._unacked[i]
            if self.rng.random() < self.drop_p:
                # this transmission is lost in flight; the batch stays
                # queued for retransmission
                self.stats["dropped"] += 1
                if self.rng.random() < 0.5:
                    break  # transport stalls until the next send/flush
                continue
            self.sched.push(self.source, batch, batch_id=bid)
            self.stats["delivered"] += 1
            self._delivered_ids.append(bid)
            del self._unacked[i]
            # duplicate: retransmit an already-delivered batch (the
            # upstream never got the ack); the dedup set must drop it
            if self._delivered_ids and self.rng.random() < self.dup_p:
                dup = self._delivered_ids[
                    int(self.rng.integers(0, len(self._delivered_ids)))]
                accepted = self.sched.push(self.source, self._batches[dup],
                                           batch_id=dup)
                if accepted:
                    # must raise even under python -O: a silently
                    # double-folded batch corrupts every downstream view
                    raise DeliveryError(
                        f"duplicate batch {dup!r} was accepted (folded "
                        f"twice) — the scheduler's dedup window dropped "
                        f"it; widen dedup_window or tighten redelivery")
                self.stats["duplicated"] += 1
            if self.rng.random() < 0.3:
                break  # partial progress per pump

    def flush(self) -> None:
        """Retransmit until every batch has been delivered exactly once."""
        while self._unacked:
            bid, batch = self._unacked.pop(0)
            accepted = self.sched.push(self.source, batch, batch_id=bid)
            if not accepted:
                # a queued batch was by definition never delivered, so a
                # rejection means the dedup window claims an id the
                # transport still holds — at-least-once just became
                # at-most-once for this batch
                raise DeliveryError(
                    f"first delivery of batch {bid!r} was rejected as a "
                    f"duplicate; its rows were never folded")
            self.stats["delivered"] += 1
            self._delivered_ids.append(bid)
