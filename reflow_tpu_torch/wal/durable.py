"""DurableScheduler: a DirtyScheduler whose ingestion survives crashes.

The port's copy of ``reflow_tpu/wal/durable.py``, over the port's
scheduler and any of its executors (the ``"cuda"`` executor included:
the log holds host bytes, the executor's state lives on the card and is
covered by ``utils.checkpoint``).

Ordering is the whole design: the WAL append happens *before* the base
scheduler accepts a push, so every accepted batch is durable by the time
``push`` returns True. The failure window decomposes as:

- crash **before** the append: the batch was never accepted — upstream
  never got an ack and re-sends after recovery; folded once.
- crash **during** the append (torn record): same as above — the torn
  frame is dropped at scan time, the re-send is accepted once.
- crash **between** append and accept, or between ``push`` and
  ``tick``: recovery replays the record into pending; the upstream
  re-send then dedups against the replayed ``batch_id``. Folded once.
- crash **mid-tick** (no ``tick`` marker yet): recovery replays the
  pushes and re-runs the tick deterministically from the checkpoint
  state.
- crash **between write and fsync** (the asynchronous committer): the
  execute may have finished, but acknowledgement gates on
  ``wal.wait_durable`` — so the caller's ticket is still unresolved,
  the upstream re-sends, and replay (of whatever prefix survived)
  dedups. Folded once.

Exactly-once across process death therefore needs nothing from the
caller beyond what lossy-transport exactly-once already needed: stable
``batch_id``s (mint them with ``scheduler.SourceCursor``). Pushes
without an id get an auto-minted ``__wal__<source>@<n>`` id so replay
still dedups — but the *caller's* re-send of such a batch cannot be
recognized, so end-to-end exactly-once requires caller-supplied ids.

Device-resident batches and pre-images (ROADMAP: "log device-resident
batches without a forced sync"): durability needs the host bytes, but a
readback of a device batch is a forced sync — on a tunnel runtime the
degrading first-sync (on a card, a stall of the stream the pump just
filled). The fix is **ingest-time pre-image logging**:
whoever uploaded the batch had the host payload first; hand it to
:meth:`DurableScheduler.push_preimage` (the serve frontend does this
automatically from ``submit(..., preimage=...)``) and the WAL logs that
pre-image while the device batch flows on untouched.
``log_readbacks`` counts the fallback materializations — zero on a
well-formed streaming path (the ``REFLOW_BENCH_WALPIPE=1`` assertion).

Crash-point injection (``crash=utils.faults.CrashInjector(...)``) fires
at the named seams above plus the WAL's own pipeline seams:
``wal_enqueue`` on the appending thread (the frame is queued, nothing
is on disk yet), then ``wal_before_write`` / ``wal_after_write`` and
``wal_before_fsync`` / ``wal_after_fsync`` on the committer thread
(inline committers fire the write/fsync seams on the appender itself);
``utils.faults.tear_wal_tail`` tears the final record after the fact.
Together they drive the crash-recovery differential tests.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.graph import Node
from reflow_tpu_torch.scheduler import DirtyScheduler, TickResult
from reflow_tpu_torch.wal.log import WriteAheadLog

__all__ = ["DurableScheduler"]


class DurableScheduler(DirtyScheduler):
    """DirtyScheduler + write-ahead logging of accepted source batches.

    ``fsync`` picks the durability/latency point (log.py's contract):
    ``"record"`` / ``"tick"`` (default) / ``"os"``. ``committer`` picks
    where the fsync runs: ``"thread"`` (default — pipelined, off the
    dispatch path) or ``"inline"`` (synchronous, the pre-pipeline
    behavior). Device-resident batches log their host **pre-image**
    when one was registered (:meth:`push_preimage`); without one they
    are materialized to host — a forced readback the streaming path
    must avoid (``log_readbacks`` counts them).
    """

    def __init__(self, graph, executor=None, *, wal_dir: str,
                 fsync: str = "tick", segment_bytes: int = 16 << 20,
                 committer: str = "thread", crash=None, epoch: int = 0,
                 **kwargs):
        super().__init__(graph, executor, **kwargs)
        self.wal = WriteAheadLog(wal_dir, fsync=fsync,
                                 segment_bytes=segment_bytes,
                                 committer=committer, crash=crash,
                                 epoch=epoch)
        self._crash = crash
        self._wal_suspended = False  # recovery replay must not re-log
        self._auto_seq = 0
        #: batch_id -> host pre-image of an uploaded device batch,
        #: consumed (popped) when that batch is logged
        self._preimages: Dict[str, DeltaBatch] = {}
        #: batch_id -> causality token (obs.trace.mint_cause) to stamp
        #: onto that batch's WAL push record, consumed when logged —
        #: replicas and the shipper re-emit the token so the trace
        #: chain stitches across processes (tracing-on only; replay
        #: ignores unknown record keys)
        self._causes: Dict[str, str] = {}
        #: forced host readbacks on the logging path (device batch, no
        #: pre-image) — the streaming zero-readback property's counter
        self.log_readbacks = 0
        #: id -> (device batch, its logged host pre-image) for device
        #: batches sitting in the pending buffers: a checkpoint taken
        #: between push and tick writes these host bytes instead of
        #: reading the batch back (cleared when a tick drains pending)
        self._pending_images: Dict[int, tuple] = {}

    # -- crash-point seam --------------------------------------------------

    def _crash_point(self, name: str) -> None:
        if self._crash is not None:
            self._crash.point(name)

    @property
    def epoch(self) -> int:
        """Leader epoch stamped into every appended record — the WAL
        owns it (promotion mints the new one there). Surfaced so the
        ingestion RPC's hello can advertise the true epoch: producer
        causality tokens minted after a failover must carry the new
        epoch, not 0."""
        return self.wal.epoch

    # -- ingestion ---------------------------------------------------------

    def _mint_auto_id(self, source: Node) -> str:
        # skip past ids a recovered dedup window already holds, so a
        # restarted driver never mints an id that would dedup away
        while True:
            bid = f"__wal__{source.name}@{self._auto_seq}"
            self._auto_seq += 1
            if bid not in self._seen_batch_ids:
                return bid

    def push_preimage(self, batch_id: str, batch: DeltaBatch) -> None:
        """Register the host-side pre-image of a device batch about to
        be pushed (or submitted) under ``batch_id``: the WAL logs these
        bytes instead of reading the device copy back. The caller owns
        the equivalence — the pre-image must be the exact batch that was
        uploaded. Consumed by the next log of that id; unused pre-images
        are dropped when their id resolves (dedup) or the log is
        sealed."""
        if hasattr(batch, "nonzero"):
            raise ValueError(
                f"pre-image for {batch_id!r} is itself device-resident; "
                f"pass the host DeltaBatch that was uploaded")
        self._preimages[batch_id] = batch

    def push_cause(self, batch_id: str, cause: str) -> None:
        """Register the causality token riding ``batch_id`` (the serve
        frontend does this for sampled tickets): the batch's WAL push
        record is stamped with it, so the shipper and every replica
        replaying the record can re-emit the same token. Consumed by
        the next log of that id; dropped on dedup or seal."""
        self._causes[batch_id] = cause

    def _record_causes(self, ids) -> list:
        """Pop the registered tokens of a record's batch ids (one per
        sampled micro-batch; coalesced records may carry several)."""
        out = []
        for bid in ids:
            c = self._causes.pop(bid, None)
            if c is not None:
                out.append(c)
        return out

    def _host_image(self, batch, batch_id: str):
        """(host_bytes_for_log, batch_to_execute): a device batch with a
        registered pre-image logs the pre-image and executes untouched;
        without one it is materialized (counted) and the host copy both
        logs and executes — the legacy forced-readback path."""
        if not hasattr(batch, "nonzero"):
            self._preimages.pop(batch_id, None)
            return batch, batch
        pre = self._preimages.pop(batch_id, None)
        if pre is not None:
            return pre, batch
        self.log_readbacks += 1
        host = self.executor.materialize(batch)
        return host, host

    def pending_image(self, batch) -> Optional[DeltaBatch]:
        """The host pre-image this scheduler logged for ``batch``, a
        device batch in its pending buffers, or None (the checkpoint
        then reads the batch back, counted)."""
        ent = self._pending_images.get(id(batch))
        return ent[1] if ent is not None and ent[0] is batch else None

    def _log_push(self, source: Node, batch: DeltaBatch,
                  batch_id: str) -> DeltaBatch:
        image, batch = self._host_image(batch, batch_id)
        if image is not batch:
            self._pending_images[id(batch)] = (batch, image)
        self._crash_point("before_append")
        rec = {
            "kind": "push",
            "tick": self._tick,
            "node": source.id,
            "node_name": source.name,
            "batch_id": batch_id,
            "keys": image.keys,
            "values": image.values,
            "weights": image.weights,
        }
        causes = self._record_causes((batch_id,))
        if causes:
            rec["cause"] = causes[0]
        self.wal.append(rec)
        self._crash_point("after_append")
        return batch

    def push(self, source: Node, batch: DeltaBatch, *,
             batch_id: Optional[str] = None) -> bool:
        if self._wal_suspended:
            return super().push(source, batch, batch_id=batch_id)
        if source.kind not in ("source", "loop"):
            # fail before logging what the base scheduler would reject
            return super().push(source, batch, batch_id=batch_id)
        # refuse before the id is minted or held and before the log: a
        # refused batch must not replay at recover()
        self.check_host_batch(source, batch)
        if batch_id is None:
            batch_id = self._mint_auto_id(source)
        elif batch_id in self._seen_batch_ids:
            self._preimages.pop(batch_id, None)
            self._causes.pop(batch_id, None)
            return False  # duplicate: nothing to make durable
        batch = self._log_push(source, batch, batch_id)
        accepted = super().push(source, batch, batch_id=batch_id)
        self._crash_point("after_push")
        return accepted

    # -- tick boundary -----------------------------------------------------

    def _log_tick_mark(self) -> None:
        self._crash_point("before_tick_mark")
        self.wal.append({"kind": "tick", "tick": self._tick})
        self.wal.note_tick()  # the per-tick durability barrier
        self._crash_point("after_tick")

    def tick(self, **kwargs) -> TickResult:
        result = super().tick(**kwargs)
        self._pending_images.clear()  # the tick drained pending
        if not self._wal_suspended:
            self._log_tick_mark()
        return result

    def tick_many(self, feeds: Sequence[Dict[Node, DeltaBatch]], *,
                  feed_ids=None, wait_durable: bool = True) -> TickResult:
        """``wait_durable=False`` is the pipelined-commit entry (the
        serve frontend): the window's records and tick markers are
        written + flushed and their durability REQUEST is enqueued, but
        this call returns without blocking on the fsync. The caller must
        gate every acknowledgement on ``wal.wait_durable(lsn)`` /
        ``wal.when_durable(lsn, ...)`` with ``lsn = wal.last_lsn()``
        read right after this returns — so window N's fsync overlaps
        window N+1's host merge and dispatch."""
        if self._wal_suspended:
            return super().tick_many(feeds, feed_ids=feed_ids)
        # feeds bypass push(), so log them here first (append-before-
        # accept, same as push). ``feed_ids`` carries the producer batch
        # ids a coalesced feed entry commits (serve frontend); entries
        # without ids get an auto id so the replay is still idempotent.
        # The whole window is one wal.append_group — under
        # fsync="record" that is ONE fsync for the window (group
        # commit), not one per micro-batch. Device-resident feeds log
        # their registered pre-image (no readback); only an unregistered
        # device feed pays the forced materialize.
        for f in feeds:
            for src, b in f.items():
                self.check_host_batch(src, b)   # before anything is logged
        logged, records = self._window_records(feeds, feed_ids)
        self._crash_point("before_append")
        # request=False: the window is ONE logical commit — the marker
        # group below carries the single durability barrier covering
        # data + markers (acknowledgement gates on the marker LSN)
        self.wal.append_group(records, wait=False, request=False)
        self._crash_point("after_append")
        # suspend the per-tick overrides during execution: the fallback
        # path runs self.tick() per feed, and its per-tick markers would
        # duplicate the window markers appended below
        self._wal_suspended = True
        try:
            result = super().tick_many(logged, feed_ids=feed_ids)
        finally:
            self._wal_suspended = False
        tick_now = self._tick
        self.wal.append_group([
            {"kind": "tick", "tick": t}
            for t in range(tick_now - len(feeds) + 1, tick_now + 1)],
            wait=False)
        self.wal.note_tick(wait=False)
        if wait_durable:
            self.wal.wait_durable(self.wal.last_lsn())
        self._crash_point("after_tick")
        return result

    def _window_records(self, feeds, feed_ids):
        """Build one window's WAL push records (and the executable feed
        maps with device batches swapped for their logged host images).
        Shared between ``tick_many`` and the staged pipeline's
        ``_log_window_feeds``."""
        ids_seq = feed_ids if feed_ids is not None else [{}] * len(feeds)
        logged, records = [], []
        for feed, ids_map in zip(feeds, ids_seq):
            entry = {}
            for src, b in feed.items():
                ids = list(ids_map.get(src, ())) or [self._mint_auto_id(src)]
                image, b = self._host_image(b, ids[0])
                entry[src] = b
                rec = {
                    "kind": "push",
                    "tick": self._tick,
                    "node": src.id,
                    "node_name": src.name,
                    "batch_id": ids[0],
                    "keys": image.keys,
                    "values": image.values,
                    "weights": image.weights,
                }
                if len(ids) > 1:
                    # several micro-batches coalesced into this one feed
                    # batch: their ids commit (and replay) atomically
                    rec["batch_ids"] = ids
                causes = self._record_causes(ids)
                if causes:
                    rec["cause"] = causes[0]
                    if len(causes) > 1:
                        rec["causes"] = tuple(causes)
                records.append(rec)
            logged.append(entry)
        return logged, records

    # -- staged (pipelined) windows ----------------------------------------

    def _log_window_feeds(self, feeds, feed_ids) -> None:
        """Append a staged window's push records before its dispatch —
        the same append-before-dispatch order, grouping, and single
        durability barrier as ``tick_many`` (request=False here; the
        marker group appended by ``dispatch_staged`` carries the
        window's one durability request). ``stage_window`` rejects
        device-resident feeds before reaching this, so no materialize
        readbacks can occur here."""
        if self._wal_suspended:
            return
        _, records = self._window_records(feeds, feed_ids)
        self._crash_point("before_append")
        self.wal.append_group(records, wait=False, request=False)
        self._crash_point("after_append")

    def dispatch_staged(self, handle):
        """Dispatch a staged window and append its K tick markers. Never
        blocks on the fsync (the pipelined-commit contract): the caller
        gates acknowledgements on ``wal.when_durable(wal.last_lsn(), …)``
        read right after this returns."""
        result = super().dispatch_staged(handle)
        if not self._wal_suspended:
            tick_now = self._tick
            self.wal.append_group([
                {"kind": "tick", "tick": t}
                for t in range(tick_now - handle.k + 1, tick_now + 1)],
                wait=False)
            self.wal.note_tick(wait=False)
            self._crash_point("after_tick")
        return result

    def close(self) -> None:
        """Durably flush and seal the log (clean shutdown). Idempotent —
        the serving frontend's ``close()`` and a caller's own shutdown
        path may both reach it."""
        self._preimages.clear()
        self._causes.clear()
        self.wal.close()
        super().close()
