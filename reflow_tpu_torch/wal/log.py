"""Segmented append-only write-ahead log of pushed source batches.

The port's copy of ``reflow_tpu/wal/log.py``. The on-disk format is the
JAX package's byte for byte (the magic, the ``[u32 len][u32 crc]``
framing, the pickled record dicts of plain numpy columns, the epoch
stamping), so a log either package writes is a log the other scans and
recovers. Records hold host bytes only: the durable scheduler logs a
device batch's host pre-image (or a counted readback), never a tensor.
The committer thread touches no tensor and no stream; the continuations
it fires (``when_durable``) resolve host tickets only.

On-disk layout: ``<wal_dir>/wal-<seq>.log`` segment files, each starting
with an 8-byte magic header, followed by length+CRC framed records::

    [u32 payload_len][u32 crc32(payload)][payload]

The payload is a pickled record dict (the same serialization the
checkpoint module uses for host state). Three record kinds flow through
the log:

- ``push``: one accepted source batch — serialized ``DeltaBatch``
  columns + ``batch_id`` + source node id/name + the tick horizon at
  append time;
- ``tick``: a tick-boundary commit marker (appended after the tick
  completes);
- ``ckpt``: informational marker stamped at checkpoint rotation.

Durability contract by fsync policy (``fsync=``):

- ``"record"``: every append is fsynced before it is *acknowledged* —
  survives power loss per accepted batch; highest latency.
- ``"tick"`` (default): flush per append (page cache — survives process
  death), fsync once per tick boundary — a power loss can lose at most
  the current in-flight tick, never a committed one.
- ``"os"``: flush per append, no per-record/per-tick fsync — survives
  process death only; the OS decides when bytes hit disk (segment
  rotation still fsyncs the sealed file, whatever the policy).

Pipelined commit (the asynchronous committer)
---------------------------------------------

With ``committer="thread"`` (the default) the dispatch path never
touches the disk: ``append``/``append_group`` pickle the record, assign
it a monotonically increasing **LSN** and an exact ``LogPosition``
(offset bookkeeping is synchronous), enqueue the framed bytes on an
in-memory commit queue, and return. A dedicated *committer* thread
(``reflow-wal-committer``) drains the queue in LSN order and performs
the ``write`` + ``flush`` + ``os.fsync`` syscalls, advancing two
watermarks: *flushed* (written to the page cache — process-death
durable) and *synced* (fsynced — power-loss durable). Callers gate
acknowledgement on :meth:`wait_durable` / :meth:`when_durable`, so
window N's framing, write and fsync all overlap window N+1's host merge
and device dispatch. What ``wait_durable(lsn)`` guarantees per policy:

========  =========================================================
policy    ``wait_durable(lsn)`` returns once the frame is …
========  =========================================================
record    fsynced (power-loss durable)
tick      fsynced at the covering tick barrier (power-loss durable)
os        written + flushed (process-death durable; no fsync wait)
========  =========================================================

A record an appender has enqueued but the committer has not yet written
is NOT yet process-death durable — which is exactly why every
acknowledgement path gates on the watermarks above, and why a crash
that loses queued frames loses only *unacknowledged* batches (the
upstream re-sends; replay dedups). ``committer="inline"`` restores the
fully synchronous pre-pipeline behavior — every frame is written and
every barrier fsynced in the appending thread (the
``REFLOW_BENCH_WALPIPE=1`` baseline).

A crashed process may leave a torn final record (partial write). The
read side (:func:`scan_wal`) tolerates exactly that: a bad frame at the
tail of the *last* segment truncates the log there; a bad frame
anywhere else is real corruption and raises :class:`WalError`. A fresh
:class:`WriteAheadLog` never appends to an existing segment (the tail
may be torn) — it always opens a new one.
"""

from __future__ import annotations

import os
import pickle
import re
import struct
import threading
import time
import zlib
from collections import deque
from typing import (Callable, Deque, Dict, Iterable, List, NamedTuple,
                    Optional, Tuple)

from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["FencedWrite", "LogPosition", "TornTail", "WalError",
           "WriteAheadLog", "list_segments", "scan_wal"]

_MAGIC = b"RFWAL001"
_HEADER = struct.Struct("<II")  # payload_len, crc32
_SEG_RE = re.compile(r"^wal-(\d{8})\.log$")
#: frame-length sanity bound — a "length" beyond this is a torn/corrupt
#: header, not a real record (segments rotate long before this)
_MAX_RECORD = 1 << 30
#: latency/group-size sample retention (percentile inputs only — the
#: ``appends``/``fsyncs``/``bytes_written`` counters stay exact)
_METRIC_WINDOW = 4096


class WalError(RuntimeError):
    """Corruption in a sealed (non-tail) region of the log."""


class FencedWrite(WalError):
    """A write was refused because this log's epoch has been fenced: a
    newer leader epoch was minted at promotion (``wal/ship.py`` /
    ``serve/failover.py``), so this writer is a zombie ex-leader. Its
    appends must never reach the replicated history — they are rejected
    here, and the epoch stamped into every record lets receivers reject
    anything that slipped onto disk before the fence landed."""


#: on-disk sidecar recording the log's epoch + fence state so offline
#: tooling (tools/wal_inspect.py) can report it after the process died
FENCE_STATE_SCHEMA = "reflow.wal_fence/1"
_FENCE_STATE_FILE = "fence-state.json"


class LogPosition(NamedTuple):
    """Byte position in the log: (segment sequence number, offset)."""

    segment: int
    offset: int


class TornTail(NamedTuple):
    """Where and why the tail of the last segment stopped parsing."""

    segment: int
    offset: int
    reason: str


def _seg_path(wal_dir: str, seq: int) -> str:
    return os.path.join(wal_dir, f"wal-{seq:08d}.log")


def list_segments(wal_dir: str) -> List[Tuple[int, str]]:
    """Sorted [(seq, path)] of the segment files present in ``wal_dir``."""
    if not os.path.isdir(wal_dir):
        return []
    out = []
    for name in os.listdir(wal_dir):
        m = _SEG_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(wal_dir, name)))
    return sorted(out)


class WriteAheadLog:
    """Appender over a directory of rotating segment files.

    Latency accounting (``utils.metrics.summarize_wal``): every append
    and fsync wall is recorded in ``append_s`` / ``fsync_s``, and
    ``appends`` / ``fsyncs`` / ``bytes_written`` count totals. With the
    threaded committer ``append_s`` measures the *dispatch-path* cost
    (pickle + enqueue); the write/fsync syscall wall lands in
    ``fsync_s`` on the committer.

    Thread safety + group commit (ROADMAP open item): appends are safe
    from concurrent threads, and under ``fsync="record"`` the fsync is a
    classic *group commit* — the committer drains every pending frame
    and durability request with ONE fsync, and a request already
    covered by the durable watermark (rotation sealed it, or an earlier
    fsync passed it) rides for free. ``group_sizes`` records how many
    appends each fsync covered; >1 means grouping engaged (the serving
    frontend's coalescing window is the hot producer of large groups).

    Locking: ``self._lock`` (an RLock) guards all appender state — LSN
    and offset bookkeeping, the commit queue, the watermarks. The
    committer performs its syscalls with ``_lock`` RELEASED (holding
    only ``_sync_lock``, which orders fsync/close against fd swaps), so
    appends keep flowing during the disk wait; lock order is
    ``_lock`` → ``_sync_lock``. Durable callbacks registered via
    :meth:`when_durable` fire *under* ``_lock`` (in LSN order, on
    whichever thread advanced the watermark) — callbacks may take their
    own locks but must never call back into a lock that is held while
    calling WAL methods (the serve frontend never holds its admission
    lock across a WAL call, so WAL-lock → frontend-lock is a safe
    order).
    """

    POLICIES = ("record", "tick", "os")
    COMMITTERS = ("thread", "inline")

    def __init__(self, wal_dir: str, *, fsync: str = "tick",
                 segment_bytes: int = 16 << 20,
                 committer: str = "thread", crash=None, epoch: int = 0):
        if fsync not in self.POLICIES:
            raise ValueError(f"fsync policy {fsync!r} not in {self.POLICIES}")
        if committer not in self.COMMITTERS:
            raise ValueError(
                f"committer {committer!r} not in {self.COMMITTERS}")
        self.wal_dir = wal_dir
        self.fsync_policy = fsync
        self.segment_bytes = segment_bytes
        self._crash = crash
        #: leader-epoch token stamped into every appended record (and
        #: into the shipper's Shipments): minted at promotion, so a
        #: receiver can tell a live leader's bytes from a zombie's
        self._epoch = int(epoch)
        #: the newer epoch that fenced this log (None = not fenced)
        self._fenced_by: Optional[int] = None
        #: appends refused because the log was fenced (zombie writer)
        self.fence_rejected_appends = 0
        os.makedirs(wal_dir, exist_ok=True)
        # a fenced log STAYS fenced across restarts: a zombie that
        # crashes and reopens its old directory must not come back
        # writable (the sidecar is best-effort, but so is the zombie's
        # luck — replicas reject its shipments by epoch regardless)
        try:
            import json
            with open(os.path.join(wal_dir, _FENCE_STATE_FILE)) as f:
                saved = json.load(f)
            self._epoch = max(self._epoch, int(saved.get("epoch") or 0))
            fb = saved.get("fenced_by")
            if fb is not None and int(fb) > self._epoch:
                self._fenced_by = int(fb)
        except (OSError, ValueError):
            pass
        segs = list_segments(wal_dir)
        #: torn tail repaired at open, if any (surfaced by recovery)
        self.repaired_tail: Optional[TornTail] = None
        if segs:
            # self-healing open: truncate a crashed generation's torn
            # final record to the valid prefix BEFORE opening a new
            # segment — otherwise the tear would sit in a sealed
            # (non-final) segment and read as corruption forever after
            self.repaired_tail = _repair_tail(segs[-1][1], segs[-1][0])
        # never resume an existing segment: append offsets are only
        # known-good for a segment this process wrote start to finish
        self._seq = (segs[-1][0] + 1) if segs else 0
        self._f = None
        self.appends = 0
        self.fsyncs = 0
        self.bytes_written = 0
        # bounded reservoirs (most recent _METRIC_WINDOW samples): the
        # counters above are exact; only percentile inputs are windowed,
        # so a long-running server's log can't leak through its metrics
        self.append_s: Deque[float] = deque(maxlen=_METRIC_WINDOW)
        self.fsync_s: Deque[float] = deque(maxlen=_METRIC_WINDOW)
        #: appends covered per fsync (group-commit effectiveness)
        self.group_sizes: Deque[int] = deque(maxlen=_METRIC_WINDOW)
        self._lock = named_lock("wal.log", reentrant=True)
        #: orders the fsync/close syscalls against fd swaps (rotation,
        #: close): any path that closes the fd takes it, so a file is
        #: never closed mid-fsync. Lock order: ``_lock`` →
        #: ``_sync_lock`` (the committer never takes ``_lock`` while
        #: holding ``_sync_lock``)
        self._sync_lock = named_lock("wal.sync")
        self._unsynced_appends = 0
        #: LSN watermarks, all process-local and monotonic:
        #: ``_written_lsn`` — last LSN *assigned* (frame pickled +
        #: enqueued; with the inline committer also written);
        #: ``_flushed_lsn`` — written + flushed to the page cache
        #: (process-death durable, the ``"os"`` gate);
        #: ``_synced_lsn`` — fsynced (power-loss durable, the
        #: ``"record"``/``"tick"`` gate and group-commit free-ride
        #: check)
        self._written_lsn = 0
        self._flushed_lsn = 0
        self._synced_lsn = 0
        #: byte-position twin of ``_synced_lsn``: everything strictly
        #: before this (segment, offset) is on disk AND fsynced — the
        #: prefix a WAL shipper (wal/ship.py) may stream to followers.
        #: Maintained from ``_lsn_pos`` (frame LSN -> frame end
        #: position), popped as the synced watermark advances.
        self._synced_pos = LogPosition(self._seq, len(_MAGIC))
        self._lsn_pos: Deque[Tuple[int, int, int]] = deque()
        #: committer work queue, strictly FIFO == LSN order:
        #: ("frame", bytes, lsn) | ("rotate", new_seq, cover_lsn) |
        #: ("fsync", target_lsn, t_enqueued)
        self._io_q: Deque[tuple] = deque()
        #: gauge mirror of pending durability requests (lsn, t) — feeds
        #: queue_depth()/durable_lag_s(); popped as the watermark passes
        self._fsync_q: Deque[Tuple[int, float]] = deque()
        #: (lsn, fn) continuations fired once lsn is durable (LSN order)
        self._callbacks: Deque[Tuple[int,
                                     Callable[[Optional[BaseException]],
                                              None]]] = deque()
        self._commit_cv = threading.Condition(self._lock)   # committer
        self._durable_cv = threading.Condition(self._lock)  # waiters
        self._closing = False
        self._metric_keys: list = []  # (registry, key) published
        #: True while the committer is mid-batch (drain() barrier)
        self._io_busy = False
        self.committer_error: Optional[BaseException] = None
        #: supervision counters: how many times a dead committer was
        #: respawned (:meth:`restart_committer`), and the cause of the
        #: most recent death (kept after the error is cleared so the
        #: control plane can report WHY it restarted)
        self.committer_restarts = 0
        self.last_committer_error: Optional[BaseException] = None
        self._open_segment()
        if self._epoch:
            self._persist_fence_locked()
        #: highest segment seq the committer has finished opening
        #: (thread-mode rotate() barrier)
        self._rotated_seq = self._seq
        self._committer: Optional[threading.Thread] = None
        if committer == "thread":
            self._committer = threading.Thread(
                target=self._committer_loop, name="reflow-wal-committer",
                daemon=True)
            self._committer.start()

    # -- crash seams (tests only) ------------------------------------------

    def _crash_point(self, name: str) -> None:
        if self._crash is not None:
            self._crash.point(name)

    # -- write side --------------------------------------------------------

    def _open_segment(self) -> None:
        self._f = open(_seg_path(self.wal_dir, self._seq), "wb")
        self._f.write(_MAGIC)
        self._f.flush()
        self._offset = len(_MAGIC)

    def _frame(self, record: Dict) -> bytes:
        # records from a promoted leader carry its epoch: receivers
        # (replicas, recovery) can reject/attribute bytes by leader
        # generation even when they arrived on disk before a fence
        # landed. The binary frame layout is unchanged — the token
        # rides in the pickled dict — and epoch 0 (the founding
        # leader) stays UNstamped, so its bytes are identical to a
        # pre-failover log's (an absent key reads as epoch 0
        # everywhere).
        if self._epoch and record.get("epoch") != self._epoch:
            record = {**record, "epoch": self._epoch}
        payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload

    def _append_frame(self, record: Dict) -> Tuple[LogPosition, int]:
        # caller holds self._lock; returns (position, frame LSN)
        if self._committer is not None:
            return self._enqueue_frame(record)
        return self._write_frame(record)

    def _enqueue_frame(self, record: Dict) -> Tuple[LogPosition, int]:
        # threaded committer: the dispatch path only pickles and does
        # position/LSN bookkeeping — write+flush+fsync happen on the
        # committer, strictly in enqueue (== LSN) order
        t0 = time.perf_counter()
        frame = self._frame(record)
        pos = LogPosition(self._seq, self._offset)
        self._offset += len(frame)
        self.appends += 1
        self._unsynced_appends += 1
        self.bytes_written += len(frame)
        self._written_lsn += 1
        lsn = self._written_lsn
        self._lsn_pos.append((lsn, pos.segment, pos.offset + len(frame)))
        self._io_q.append(("frame", frame, lsn))
        if self._offset >= self.segment_bytes:
            # bookkeeping rotation: later frames get positions in the
            # next segment; the committer performs the actual
            # seal-fsync/close/open when it reaches this command
            self._seq += 1
            self._io_q.append(("rotate", self._seq, lsn))
            self._offset = len(_MAGIC)
        self._commit_cv.notify()
        # the seam fires only once the enqueue is complete (committer
        # woken): a crash "after enqueue" must not strand the frame in a
        # queue nobody is draining
        self._crash_point("wal_enqueue")
        self.append_s.append(time.perf_counter() - t0)
        if _trace.ENABLED:
            _trace.evt("wal_append", t0, time.perf_counter() - t0,
                       track="wal", args={"bytes": len(frame), "lsn": lsn})
        return pos, lsn

    def _write_frame(self, record: Dict) -> Tuple[LogPosition, int]:
        # inline committer: frame + write + flush synchronously (the
        # pre-pipeline behavior); caller holds self._lock
        self._crash_point("wal_before_write")
        t0 = time.perf_counter()
        frame = self._frame(record)
        pos = LogPosition(self._seq, self._offset)
        self._f.write(frame)
        # page cache is the floor for every policy: a killed process
        # must never take back a record the scheduler already accepted
        self._f.flush()
        self._offset += len(frame)
        self.appends += 1
        self._unsynced_appends += 1
        self.bytes_written += len(frame)
        self._written_lsn += 1
        self._flushed_lsn = self._written_lsn
        lsn = self._written_lsn
        self._lsn_pos.append((lsn, pos.segment, pos.offset + len(frame)))
        self.append_s.append(time.perf_counter() - t0)
        if _trace.ENABLED:
            _trace.evt("wal_append", t0, time.perf_counter() - t0,
                       track="wal", args={"bytes": len(frame), "lsn": lsn})
        self._crash_point("wal_after_write")
        if self._offset >= self.segment_bytes:
            self.rotate()
        return pos, lsn

    def append(self, record: Dict, *, wait: bool = True) -> LogPosition:
        """Frame + append one record; returns its (exact) position.
        Under ``"record"`` a durability request is enqueued for the
        frame and (``wait=True``, the default) acknowledged only once
        durable; ``wait=False`` returns immediately after the enqueue —
        the caller gates on :meth:`wait_durable`/:meth:`when_durable`
        with :meth:`last_lsn`. ``"tick"`` batches the fsync into
        :meth:`note_tick`."""
        with self._lock:
            self._raise_if_fenced()
            self._raise_if_committer_dead()
            pos, lsn = self._append_frame(record)
            if self.fsync_policy == "record":
                self._request_durable(lsn)
        if wait and self.fsync_policy == "record":
            self.wait_durable(lsn)
        return pos

    def append_group(self, records: Iterable[Dict], *, wait: bool = True,
                     request: bool = True) -> List[LogPosition]:
        """Append several records under ONE durability barrier: the
        explicit group-commit path for a coalescing window whose batches
        commit atomically anyway (``DurableScheduler.tick_many``). Under
        ``"record"`` the group shares a single fsync. An empty group is
        a complete no-op — no write, no fsync, no positions.

        ``request=False`` skips even the durability *request*: the
        caller is about to append a later group in the same logical
        commit (data before markers) and wants one barrier for the
        whole window, not one per group. The caller owns the follow-up
        — it must issue a request (or an explicit ``wait_durable``)
        covering these frames before acknowledging anything."""
        records = list(records)
        if not records:
            return []
        with self._lock:
            self._raise_if_fenced()
            self._raise_if_committer_dead()
            out = [self._append_frame(r) for r in records]
            lsn = out[-1][1]
            if request and self.fsync_policy == "record":
                self._request_durable(lsn)
        if wait and request and self.fsync_policy == "record":
            self.wait_durable(lsn)
        return [pos for pos, _lsn in out]

    # -- durability pipeline ----------------------------------------------

    def last_lsn(self) -> int:
        """LSN of the most recently appended frame (0 = nothing yet).
        Monotonic within this process — replay does not persist it."""
        with self._lock:
            return self._written_lsn

    def _durable_point(self) -> int:
        # caller holds self._lock: the watermark the current policy's
        # durability promise gates on
        if self.fsync_policy == "os":
            return self._flushed_lsn
        return self._synced_lsn

    def durable_lsn(self) -> int:
        """Highest LSN the policy's durability promise already covers."""
        with self._lock:
            return self._durable_point()

    def queue_depth(self) -> int:
        """Committer backlog: frames + barriers awaiting the committer
        thread (0 with the inline committer — nothing is deferred)."""
        with self._lock:
            return len(self._io_q)

    def durable_lag_s(self) -> float:
        """Age of the oldest pending durability request (0.0 when the
        committer is caught up)."""
        with self._lock:
            if not self._fsync_q:
                return 0.0
            return time.perf_counter() - self._fsync_q[0][1]

    def _raise_if_committer_dead(self) -> None:
        # caller holds self._lock — fail fast instead of accepting
        # appends whose write/fsync no one will ever serve
        if self.committer_error is not None:
            raise self.committer_error

    # -- epoch fencing -----------------------------------------------------

    @property
    def epoch(self) -> int:
        """Leader epoch stamped into every appended record."""
        with self._lock:
            return self._epoch

    @property
    def fenced(self) -> bool:
        with self._lock:
            return self._fenced_by is not None

    def adopt_epoch(self, epoch: int) -> None:
        """Raise this log's epoch to ``epoch`` (never lowers it) — the
        recovery path: a restarted leader must come back writing in the
        highest epoch its log already contains, or its fresh records
        would read as a zombie's."""
        with self._lock:
            if epoch > self._epoch and (self._fenced_by is None
                                        or epoch >= self._fenced_by):
                self._epoch = int(epoch)
                if self._fenced_by is not None \
                        and self._epoch >= self._fenced_by:
                    self._fenced_by = None  # caught up: fence satisfied
                self._persist_fence_locked()

    def fence(self, new_epoch: int) -> bool:
        """Fence this log out of epochs below ``new_epoch``: a promotion
        minted a newer leader generation, so every subsequent append on
        this (now zombie) writer raises :class:`FencedWrite` instead of
        growing the replicated history. Idempotent; returns True when
        the fence engaged (False: ``new_epoch`` is not newer)."""
        with self._lock:
            if new_epoch <= self._epoch:
                return False
            if self._fenced_by is None or new_epoch > self._fenced_by:
                self._fenced_by = int(new_epoch)
                self._persist_fence_locked()
            return True

    def _raise_if_fenced(self) -> None:
        # caller holds self._lock; sits beside _raise_if_committer_dead
        # at the top of every append-side entry point
        if self._fenced_by is None:
            return
        self.fence_rejected_appends += 1
        self._persist_fence_locked()
        if _trace.ENABLED:
            now = time.perf_counter()
            _trace.evt("fence_reject", now, 0.0, track="wal",
                       args={"kind": "append", "epoch": self._epoch,
                             "fenced_by": self._fenced_by})
        raise FencedWrite(
            f"WAL epoch {self._epoch} fenced by epoch "
            f"{self._fenced_by}: this writer is a zombie ex-leader; "
            f"its appends are rejected, never merged")

    def _persist_fence_locked(self) -> None:
        # best-effort sidecar for offline tooling; never fails a write
        # path over telemetry
        try:
            import json
            tmp = os.path.join(self.wal_dir, _FENCE_STATE_FILE + ".tmp")
            with open(tmp, "w") as f:
                json.dump({"schema": FENCE_STATE_SCHEMA,
                           "epoch": self._epoch,
                           "fenced_by": self._fenced_by,
                           "rejected_appends": self.fence_rejected_appends},
                          f)
            os.replace(tmp, os.path.join(self.wal_dir, _FENCE_STATE_FILE))
        except OSError:
            pass

    def _request_durable(self, lsn: int) -> None:
        # caller holds self._lock: hand the barrier to the committer,
        # or serve it inline when there is none
        if self._committer is None:
            if self._synced_lsn < lsn:
                self._fsync()
            return
        now = time.perf_counter()
        self._io_q.append(("fsync", lsn, now))
        self._fsync_q.append((lsn, now))
        self._commit_cv.notify()

    def wait_durable(self, lsn: int,
                     timeout: Optional[float] = None) -> None:
        """Block until ``lsn`` is covered by the policy's durability
        promise (see the module docstring table). Raises the committer's
        death cause if the write/fsync can no longer happen.

        ``timeout`` (seconds) bounds the wait: on expiry a
        :class:`TimeoutError` is raised WITHOUT consuming the durability
        request — the committer keeps working, the frame may still
        become durable later, and a re-wait on the same LSN can succeed.
        This is the escape hatch for callers parked behind a wedged
        committer (a disk stall, a dead fd) who would otherwise hang
        forever."""
        if lsn <= 0:
            return
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._lock:
            if self._committer is None and self._durable_point() < lsn:
                if self.fsync_policy != "os":
                    self._fsync()
            while self._durable_point() < lsn:
                if self.committer_error is not None:
                    raise self.committer_error
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"lsn {lsn} not durable after {timeout}s "
                            f"(durable point {self._durable_point()}, "
                            f"committer queue {len(self._io_q)})")
                self._durable_cv.wait(timeout=remaining)

    def when_durable(self, lsn: int,
                     fn: Callable[[Optional[BaseException]], None]) -> bool:
        """Register a continuation for ``lsn``: returns False when the
        LSN is already durable (the caller runs its continuation
        inline); otherwise ``fn(None)`` fires once the watermark passes
        it — in LSN order, under the WAL lock, on the thread that
        advanced the watermark — or ``fn(error)`` if the committer dies
        first. The serve frontend's deferred ticket resolution hangs off
        this seam."""
        with self._lock:
            if self.committer_error is not None:
                raise self.committer_error
            if lsn <= self._durable_point():
                return False
            self._callbacks.append((lsn, fn))
            return True

    def _fire_due_callbacks(self) -> None:
        # caller holds self._lock; a watermark just advanced
        point = self._durable_point()
        while self._callbacks and self._callbacks[0][0] <= point:
            _lsn, fn = self._callbacks.popleft()
            fn(None)

    def _advance_synced(self, cover: int) -> None:
        # caller holds self._lock
        self._synced_lsn = cover
        while self._lsn_pos and self._lsn_pos[0][0] <= cover:
            _lsn, seg, end = self._lsn_pos.popleft()
            self._synced_pos = LogPosition(seg, end)
        while self._fsync_q and self._fsync_q[0][0] <= cover:
            self._fsync_q.popleft()
        self._durable_cv.notify_all()
        self._fire_due_callbacks()

    def drain(self) -> None:
        """Block until the committer has performed every write and
        rotation enqueued so far (NO fsync barrier — use :meth:`sync`
        for that): afterwards the on-disk log matches what a process
        death at this instant would leave behind. A no-op with the
        inline committer, where nothing is ever deferred."""
        with self._lock:
            if self._io_q:
                self._commit_cv.notify()  # defensive wakeup
            while self._io_q or self._io_busy:
                if self.committer_error is not None:
                    raise self.committer_error
                self._durable_cv.wait()

    def _committer_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    self._io_busy = False
                    self._durable_cv.notify_all()
                    while not self._io_q and not self._closing:
                        self._commit_cv.wait()
                    if not self._io_q:
                        return  # closing and caught up
                    self._io_busy = True
                    items = list(self._io_q)
                    self._io_q.clear()
                    f = self._f
                # the syscalls below run with _lock RELEASED — appends,
                # and the pump dispatching the next window through them,
                # keep flowing while this thread blocks in the kernel.
                # Only the committer writes in thread mode, so the fd is
                # stable here except across its own rotate commands.
                flushed_to = 0
                sync_target = 0
                for item in items:
                    kind = item[0]
                    if kind == "frame":
                        _kind, data, lsn = item
                        self._crash_point("wal_before_write")
                        f.write(data)
                        # page cache floor: flush per drain batch below
                        flushed_to = lsn
                        self._crash_point("wal_after_write")
                    elif kind == "rotate":
                        _kind, new_seq, cover = item
                        f.flush()
                        t0 = time.perf_counter()
                        with self._sync_lock:
                            # reflow-lint: waive lock-blocking-call -- wal.sync exists to serialize fsync/close; never taken on the admit path
                            os.fsync(f.fileno())
                            f.close()
                        f = open(_seg_path(self.wal_dir, new_seq), "wb")
                        f.write(_MAGIC)
                        f.flush()
                        with self._lock:
                            self._f = f
                            self._rotated_seq = new_seq
                            self.fsyncs += 1
                            self.fsync_s.append(time.perf_counter() - t0)
                            if flushed_to > self._flushed_lsn:
                                self._flushed_lsn = flushed_to
                            # bytes in a sealed segment are durable
                            # whatever the policy
                            if cover > self._synced_lsn:
                                self._advance_synced(cover)
                            else:
                                self._durable_cv.notify_all()
                    else:  # "fsync" durability request
                        _kind, lsn, _t = item
                        sync_target = max(sync_target, lsn)
                if flushed_to:
                    f.flush()
                do_sync = False
                with self._lock:
                    if flushed_to > self._flushed_lsn:
                        self._flushed_lsn = flushed_to
                        self._durable_cv.notify_all()
                        if self.fsync_policy == "os":
                            self._fire_due_callbacks()
                    if sync_target:
                        self._crash_point("wal_before_fsync")
                        if sync_target > self._synced_lsn:
                            # snapshot: every frame <= cover is written+
                            # flushed to fd ``f``, so an fsync started
                            # after this point durably covers them all
                            do_sync = True
                            cover = self._flushed_lsn
                            n = self._unsynced_appends
                            self._unsynced_appends = 0
                        else:
                            # free ride: a rotation seal or an earlier
                            # fsync already covered this barrier
                            self._crash_point("wal_after_fsync")
                if not do_sync:
                    continue
                t0 = time.perf_counter()
                with self._sync_lock:
                    if not f.closed:
                        # reflow-lint: waive lock-blocking-call -- the committer's durability fsync; wal.sync is the fsync-serializing leaf
                        os.fsync(f.fileno())
                dur = time.perf_counter() - t0
                with self._lock:
                    self.fsyncs += 1
                    self.fsync_s.append(dur)
                    if _trace.ENABLED:
                        _trace.evt("wal_fsync", t0, dur,
                                   track="wal-committer",
                                   args={"covered": n,
                                         "queue_depth": len(self._io_q)})
                    if n:
                        self.group_sizes.append(n)
                    if cover > self._synced_lsn:
                        self._advance_synced(cover)
                    self._crash_point("wal_after_fsync")
        except BaseException as e:  # noqa: BLE001 - incl. CrashPoint kills
            with self._lock:
                self.committer_error = e
                self._io_busy = False
                self._io_q.clear()
                self._fsync_q.clear()
                cbs = list(self._callbacks)
                self._callbacks.clear()
                self._durable_cv.notify_all()
            for _lsn, fn in cbs:
                fn(e)

    def restart_committer(self) -> bool:
        """Respawn a dead committer thread on a FRESH segment — the
        control plane's respawn-or-fail-fast actuator. Returns True when
        a restart happened (False: committer alive, inline mode, or the
        log is closing).

        Contract: committer death already failed every unacknowledged
        frame — queued writes were dropped, ``when_durable`` callbacks
        fired with the death cause, ``wait_durable`` waiters raised — so
        from every caller's perspective those LSNs are settled losses,
        exactly like a process crash losing unacknowledged batches
        (upstream re-send + replay dedup carries exactly-once across
        it). The restart therefore advances the durable watermarks to
        the written watermark and starts clean: the on-disk log simply
        never contains the lost frames. The old segment's tail is
        repaired first (the dead committer may have torn a frame
        mid-write), so sealed-segment scans stay valid."""
        with self._lock:
            if (self._committer is None or self._closing
                    or self.committer_error is None):
                return False
            self.last_committer_error = self.committer_error
            # seal best-effort and never append to the old fd again: a
            # torn tail must stay in the OLD segment where repair can
            # truncate it, same rule as a process restart
            try:
                with self._sync_lock:
                    if self._f is not None and not self._f.closed:
                        self._f.close()
            except OSError:
                pass
            segs = list_segments(self.wal_dir)
            if segs:
                _repair_tail(segs[-1][1], segs[-1][0])
                self._seq = segs[-1][0] + 1
            else:
                self._seq += 1
            self._open_segment()
            self._rotated_seq = self._seq
            # settle the watermarks: nothing below _written_lsn can ever
            # reach the disk now, and every such frame was already
            # reported failed to its caller
            self._flushed_lsn = self._written_lsn
            self._synced_lsn = self._written_lsn
            # the dropped frames never reached the disk: the shippable
            # prefix restarts at the fresh segment, never mid-loss
            self._lsn_pos.clear()
            self._synced_pos = LogPosition(self._seq, len(_MAGIC))
            self._unsynced_appends = 0
            self._io_q.clear()
            self._fsync_q.clear()
            self._io_busy = False
            self.committer_error = None
            self.committer_restarts += 1
            self._committer = threading.Thread(
                target=self._committer_loop, name="reflow-wal-committer",
                daemon=True)
            self._committer.start()
            self._durable_cv.notify_all()
            return True

    def _fsync(self) -> None:
        # inline barrier — caller holds self._lock AND owns a drained
        # log (inline committer always; thread mode only after the
        # committer has exited or via the close path), so everything
        # appended is written+flushed and this fsync covers through
        # _written_lsn. The _sync_lock round-trip serializes against a
        # committer fsync in flight on the same fd.
        t0 = time.perf_counter()
        with self._sync_lock:
            # reflow-lint: waive lock-blocking-call -- seal-path fsync; wal.sync only ever guards fsync/close
            os.fsync(self._f.fileno())
        self.fsyncs += 1
        self.fsync_s.append(time.perf_counter() - t0)
        if _trace.ENABLED:
            _trace.evt("wal_fsync", t0, time.perf_counter() - t0,
                       track="wal",
                       args={"covered": self._unsynced_appends,
                             "queue_depth": len(self._io_q)})
        if self._unsynced_appends:
            self.group_sizes.append(self._unsynced_appends)
            self._unsynced_appends = 0
        self._flushed_lsn = self._written_lsn
        self._advance_synced(self._written_lsn)

    def note_tick(self, *, wait: bool = True) -> None:
        """Tick-boundary durability barrier (``"tick"`` policy requests
        its fsync here; ``"record"`` already did; ``"os"`` never does).
        Skipped entirely when nothing was appended since the last
        barrier — an idle tick must not pay a no-op fsync."""
        if self.fsync_policy != "tick":
            return
        with self._lock:
            self._raise_if_fenced()
            self._raise_if_committer_dead()
            if self._synced_lsn >= self._written_lsn:
                return
            lsn = self._written_lsn
            self._request_durable(lsn)
        if wait:
            self.wait_durable(lsn)

    def sync(self) -> None:
        """Unconditional durability barrier (checkpoint path): blocks
        until everything appended so far is written AND fsynced,
        whatever the policy."""
        with self._lock:
            if self._committer is not None:
                self._raise_if_committer_dead()
                lsn = self._written_lsn
                if self._synced_lsn >= lsn:
                    return
                now = time.perf_counter()
                self._io_q.append(("fsync", lsn, now))
                self._fsync_q.append((lsn, now))
                self._commit_cv.notify()
                while self._synced_lsn < lsn:
                    if self.committer_error is not None:
                        raise self.committer_error
                    self._durable_cv.wait()
                return
            self._f.flush()
            self._fsync()

    def position(self) -> LogPosition:
        """Position one past the last appended byte (exact even while
        frames are still queued for the committer — offsets are
        assigned at append time)."""
        with self._lock:
            return LogPosition(self._seq, self._offset)

    def synced_position(self) -> LogPosition:
        """Byte-position twin of the *synced* watermark: every frame
        strictly before this (segment, offset) is written AND fsynced
        (power-loss durable). This is the prefix a shipper
        (``wal/ship.py``) may stream to read replicas — bytes past it
        may still be sitting in the committer queue or the page cache,
        and a power loss could take them back."""
        with self._lock:
            return self._synced_pos

    def rotate(self) -> None:
        """Seal the current segment and open the next one. The sealed
        segment is fsynced before close — whatever the policy, bytes in
        a sealed segment are durable (so the free-ride check can trust
        the durable watermark across rotations, and a mid-tick rotation
        can't strand committed records in the page cache). With the
        threaded committer this enqueues a rotate command and blocks
        until the committer has performed it (FIFO order keeps every
        already-queued frame in the old segment)."""
        with self._lock:
            if self._committer is not None:
                self._raise_if_committer_dead()
                self._seq += 1
                new_seq = self._seq
                self._io_q.append(("rotate", new_seq, self._written_lsn))
                self._offset = len(_MAGIC)
                self._commit_cv.notify()
                while self._rotated_seq < new_seq:
                    if self.committer_error is not None:
                        raise self.committer_error
                    self._durable_cv.wait()
                return
            self._f.flush()
            self._fsync()
            # the close rides the same mutex: a committer fsync holding
            # a stale snapshot of this fd must finish (or see .closed)
            # before the fd number can be reused by the next segment
            with self._sync_lock:
                self._f.close()
            self._seq += 1
            self._open_segment()

    def truncate_until(self, pos: LogPosition) -> List[str]:
        """Delete sealed segments strictly before ``pos.segment`` (the
        checkpoint already covers them). Returns the removed paths."""
        removed = []
        for seq, path in list_segments(self.wal_dir):
            if seq < pos.segment and seq != self._seq:
                os.remove(path)
                removed.append(path)
        return removed

    def publish_metrics(self, registry=None, *, name: str = "wal"
                        ) -> str:
        """Register this log's live summary (the ``summarize_wal``
        schema: append/fsync latency percentiles, group-commit shape)
        plus the committer pipeline gauges (``.queue_depth`` backlog of
        frames + barriers, ``.durable_lag_s`` age of the oldest pending
        durability request) as obs metric sources. Returns the source
        key."""
        from reflow_tpu_torch.obs import REGISTRY
        from reflow_tpu_torch.utils.metrics import summarize_wal
        reg = registry if registry is not None else REGISTRY
        reg.register_source(name,
                            lambda: summarize_wal(self).to_dict())
        reg.gauge(f"{name}.fsync_rate",
                  lambda: self.fsyncs / max(self.appends, 1))
        reg.gauge(f"{name}.queue_depth", self.queue_depth)
        reg.gauge(f"{name}.durable_lag_s", self.durable_lag_s)
        self._metric_keys.append((reg, name))
        return name

    def close(self) -> None:
        # stop the committer first: it drains every queued frame and
        # barrier (firing their continuations) before exiting, so no
        # ticket is stranded by a clean shutdown
        committer = self._committer
        if committer is not None:
            with self._lock:
                self._closing = True
                self._commit_cv.notify_all()
            committer.join(timeout=30.0)
            self._committer = None
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.flush()
                # seal-time idle skip: only fsync when bytes were
                # appended since the last durability barrier
                if self._synced_lsn < self._written_lsn \
                        or self._unsynced_appends:
                    self._fsync()
                with self._sync_lock:
                    self._f.close()
            # a committer that died mid-pipeline already failed its
            # callbacks; a clean close must not strand any either
            if self._callbacks:
                self._fire_due_callbacks()
                self._callbacks.clear()
        for reg, key in self._metric_keys:
            reg.unregister_source(key)
            reg.unregister_prefix(f"{key}.")
        self._metric_keys = []


# -- read side -------------------------------------------------------------

def _valid_prefix(data: bytes) -> int:
    """Byte length of the longest valid record prefix (past the magic);
    -1 when even the magic is gone."""
    if data[:len(_MAGIC)] != _MAGIC:
        return -1
    off = len(_MAGIC)
    while off + _HEADER.size <= len(data):
        length, crc = _HEADER.unpack_from(data, off)
        payload = data[off + _HEADER.size: off + _HEADER.size + length]
        if (length > _MAX_RECORD or len(payload) < length
                or zlib.crc32(payload) != crc):
            break
        off += _HEADER.size + length
    return off


def _repair_tail(path: str, seq: int) -> Optional[TornTail]:
    """Truncate ``path`` to its valid record prefix (drop a torn final
    record); delete it outright if even the magic header is torn.
    Returns what was repaired, or None for an already-clean segment."""
    with open(path, "rb") as f:
        data = f.read()
    keep = _valid_prefix(data)
    if keep == len(data):
        return None
    if keep < 0:
        os.remove(path)
        return TornTail(seq, 0, "segment magic torn; segment removed")
    with open(path, "rb+") as f:
        f.truncate(keep)
    return TornTail(seq, keep,
                    f"torn record truncated ({len(data) - keep} bytes)")

def _read_segment(path: str, seq: int, is_last: bool,
                  ) -> Tuple[List[Tuple[LogPosition, Dict]],
                             Optional[TornTail]]:
    records: List[Tuple[LogPosition, Dict]] = []

    def bad(offset: int, reason: str):
        if is_last:
            return records, TornTail(seq, offset, reason)
        raise WalError(f"{path} @ {offset}: {reason} in a sealed "
                       f"(non-final) segment — real corruption, not a "
                       f"torn tail")

    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_MAGIC)] != _MAGIC:
        return bad(0, f"bad segment magic {data[:len(_MAGIC)]!r}")
    off = len(_MAGIC)
    while off < len(data):
        if off + _HEADER.size > len(data):
            return bad(off, "truncated frame header")
        length, crc = _HEADER.unpack_from(data, off)
        if length > _MAX_RECORD:
            return bad(off, f"implausible frame length {length}")
        payload = data[off + _HEADER.size: off + _HEADER.size + length]
        if len(payload) < length:
            return bad(off, f"truncated payload ({len(payload)}/{length} "
                            f"bytes)")
        if zlib.crc32(payload) != crc:
            return bad(off, "CRC mismatch")
        try:
            record = pickle.loads(payload)
        except Exception as e:  # noqa: BLE001 - framed+CRC-clean yet unloadable
            return bad(off, f"unpicklable payload ({e})")
        records.append((LogPosition(seq, off), record))
        off += _HEADER.size + length
    return records, None


def scan_wal(wal_dir: str, start: Optional[Tuple[int, int]] = None,
             ) -> Tuple[List[Tuple[LogPosition, Dict]], Optional[TornTail]]:
    """Parse every record at or after ``start`` ((segment, offset), e.g.
    a checkpoint's recorded position). Returns ``(records, torn)`` where
    ``torn`` describes a tolerated torn tail in the final segment (None
    for a clean log). Raises :class:`WalError` on non-tail corruption.
    """
    segs = list_segments(wal_dir)
    records: List[Tuple[LogPosition, Dict]] = []
    torn: Optional[TornTail] = None
    for ix, (seq, path) in enumerate(segs):
        if start is not None and seq < start[0]:
            continue
        seg_records, torn = _read_segment(path, seq, ix == len(segs) - 1)
        for pos, rec in seg_records:
            if start is not None and pos.segment == start[0] \
                    and pos.offset < start[1]:
                continue
            records.append((pos, rec))
    return records, torn


def iter_push_records(records: Iterable[Tuple[LogPosition, Dict]]):
    """The push records of a scan, in log order."""
    for pos, rec in records:
        if rec.get("kind") == "push":
            yield pos, rec
