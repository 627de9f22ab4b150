"""IngestFrontend: backpressured multi-producer admission onto one
scheduler.

The paper's tick-synchronous model assumes *someone* feeds the
scheduler; this is that someone. N concurrent producers call
``submit(source, batch)`` from their own threads; a single **pump**
owns the scheduler (``DirtyScheduler`` or ``DurableScheduler`` — never
touch it directly while the frontend is running), coalesces the queued
micro-batches into ``tick_many`` macro-ticks, and resolves each
submission's :class:`~reflow_tpu_torch.serve.tickets.Ticket`.

Admission control (per submit, in order):

1. **id mint / dedup** — a missing ``batch_id`` is minted through
   ``SourceCursor`` (restart-safe: cursors resume past the scheduler's
   recovered dedup window); a duplicate id resolves the ticket
   ``DEDUPED`` immediately, never silently dropped.
2. **backpressure** — per-source queue depth + the in-flight byte
   budget (a :class:`~reflow_tpu_torch.serve.budget.BudgetShare`), with the
   configured policy: ``block`` (wait for room; a ``close()`` releases
   blocked producers with :class:`FrontendClosed`), ``reject`` (resolve
   ``REJECTED`` now), ``shed-oldest`` (evict the oldest admitted
   entries — their tickets resolve ``SHED`` — to admit the newer one).

Two pump deployments share all of the above (the refactor the serving
tier forced — admission and pumping are **injectable**):

- ``start=True`` (default): the frontend owns a private pump thread —
  the PR-2 standalone shape.
- ``start=False`` + ``lock=``/``work=``/``budget=``: an external pump
  pool (``serve.tier.ServeTier``) drives the frontend through
  ``_poll`` / ``_take_window`` / ``_run_window`` / ``_finish_window``,
  under a lock shared with sibling graphs. The ``_executing`` flag is
  the per-graph in-flight latch: a graph's macro-tick never interleaves
  with itself, whoever pumps it.

Steady-state traffic rides the streaming path: the pump calls
``tick_many`` (never a synchronous ``tick``), so the scheduler itself
forces no mid-stream readback. Where the executor has the window path
(``window_support``), the pump stages each chunk of ticks into the
device ingress queue and keeps up to ``depth`` dispatched windows in
flight while it stages the next (``REFLOW_WINDOW_DEPTH``, default 2).

Durability pipeline (durable schedulers): the pump never blocks on an
fsync. ``tick_many(wait_durable=False)`` returns once the window's WAL
records are written+flushed; ticket resolution is deferred into a
:class:`_ResBlock` registered with ``wal.when_durable(lsn, ...)`` and
fires when the committer thread's fsync passes the window's LSN — so
window N's disk latency overlaps window N+1's merge and dispatch, while
commit-before-resolve holds (a crash between execute and fsync leaves
the tickets unresolved; upstream re-sends, replay dedups). Device
batches submitted with ``preimage=`` log the host pre-image instead of
paying a device readback (``DurableScheduler.push_preimage``).

Crash seams (``utils.faults.CrashInjector``): ``producer_submit`` /
``producer_admitted`` on the submitting thread, ``pump_coalesce`` /
``pump_before_tick`` / ``pump_after_tick`` on the pump. A named
frontend (tier-managed) scopes its seams as ``<seam>@<name>`` so one
graph of a pool can be killed in isolation. A pump kill fails every
undecided ticket with :class:`PumpCrashed` and releases blocked
producers; a durable scheduler's WAL then carries exactly-once across
``recover()`` + upstream re-send.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from reflow_tpu_torch.graph import GraphError, Node
from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.scheduler import SourceCursor
from reflow_tpu_torch.utils.config import env_int
from reflow_tpu_torch.utils.faults import DeliveryError
from reflow_tpu_torch.utils.runtime import named_lock

from .budget import AdmissionBudget
from .coalesce import CoalesceWindow, build_feeds
from .queues import Entry, SourceQueues, batch_nbytes
from .tickets import (APPLIED, DEDUPED, REJECTED, SHED, FrontendClosed,
                      PumpCrashed, Ticket, TicketResult)

__all__ = ["IngestFrontend"]

POLICIES = ("block", "reject", "shed-oldest")


@dataclasses.dataclass
class _ResBlock:
    """One executed chunk awaiting its durability point: the tickets of
    a ``tick_many`` call whose WAL records are written but possibly not
    yet fsynced. Resolution fires from ``wal.when_durable`` — on the
    committer thread when the fsync overlapped later work, inline on
    the pump when the LSN was already durable."""

    #: (entry, committed tick, coalesced_with) per micro-batch
    items: List[Tuple[Entry, int, int]]
    lsn: int
    nticks: int
    t_ready: float
    t_exec0: float
    t_exec1: float


@dataclasses.dataclass
class _InflightWindow:
    """One dispatched-but-unretired pipelined window: the scheduler's
    staged handle (whose retire frees its ingress-queue generation)
    plus the :class:`_ResBlock` whose durability wiring happens at the
    retire step — both deliberately OFF the stage→dispatch critical
    path."""

    handle: object               # scheduler _StagedTicks
    block: _ResBlock


#: per-sample metric retention: percentile summaries only need a recent
#: window, and a long-running serving process must not grow them forever
METRIC_WINDOW = 4096


class IngestFrontend:
    """Thread-safe streaming ingestion frontend over one scheduler.

    ``policy``: backpressure policy (``block`` / ``reject`` /
    ``shed-oldest``). ``queue_batches``: per-source queue bound.
    ``max_bytes``: in-flight payload budget (ignored when ``budget`` is
    injected). ``window``: the coalescing window (rows / ticks /
    latency triggers). ``crash``: a ``CrashInjector`` wired to the
    documented seams (tests only).

    Tier injection (``serve.tier`` wires these; standalone callers
    leave them defaulted): ``budget`` — a ``BudgetShare`` of a shared
    ``AdmissionBudget``; ``lock`` — the lock every sibling frontend and
    the pump pool share; ``work`` — the pool's shared work condition
    (must be built on ``lock``); ``name`` — the graph name, used to
    scope crash seams; ``start=False`` — no private pump thread, the
    pool pumps.
    """

    def __init__(self, sched, *, policy: str = "block",
                 queue_batches: int = 256, max_bytes: int = 64 << 20,
                 window: Optional[CoalesceWindow] = None, crash=None,
                 start: bool = True, budget=None, lock=None, work=None,
                 name: Optional[str] = None, admission: str = "auto",
                 depth: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if admission not in ("auto", "host", "device"):
            raise ValueError(
                f"admission {admission!r} not in ('auto', 'host', "
                f"'device')")
        self.sched = sched
        self.policy = policy
        self.window = window if window is not None else CoalesceWindow()
        self.name = name
        #: the executor advertises the fused window path for this graph:
        #: the pump's tick_many windows dispatch through the device
        #: ingress queue
        self.megatick = bool(getattr(sched, "window_support", False))
        #: what a host batch's admission charge measures: "host" = its
        #: payload bytes, "device" = the queue-slot bytes it will reserve
        #: on device (backpressure then tracks device memory pressure);
        #: "auto" picks "device" exactly when the window path engages
        self.admission = ("device" if admission == "auto" and self.megatick
                          else "host" if admission == "auto" else admission)
        #: pipelined window depth: how many dispatched-but-unretired
        #: windows may be in flight while the NEXT one stages (software
        #: pipelining over the async device dispatch). 1 = the fully
        #: serial stage→dispatch→retire loop, bit-for-bit today's
        #: behavior; >1 requires the staged scheduler surface, so it is
        #: forced to 1 off the fused window path.
        if depth is None:
            depth = env_int("REFLOW_WINDOW_DEPTH")
        staged = (self.megatick
                  and getattr(sched, "stage_window", None) is not None)
        self.depth = max(1, int(depth)) if staged else 1
        #: dispatched windows awaiting their retire step, oldest first.
        #: Owned by whoever holds the pump latch (or the pool's settle
        #: latch) — never mutated concurrently.
        self._inflight: Deque[_InflightWindow] = deque()
        self._crash = crash
        self._lock = (lock if lock is not None
                      else named_lock(f"serve.frontend.{name}" if name
                                      else "serve.frontend"))
        self._not_full = threading.Condition(self._lock)   # producers
        self._work = (work if work is not None
                      else threading.Condition(self._lock))  # pump
        self._idle = threading.Condition(self._lock)       # flush/pause
        if budget is None:
            budget = AdmissionBudget(max_bytes).register(name or "frontend")
        budget.attach(self._not_full)
        self._budget = budget
        self._queues = SourceQueues(queue_batches, budget)
        self._cursors: Dict[int, SourceCursor] = {}
        #: admission-side mirror of the scheduler's dedup window (the
        #: pump owns the scheduler, so producers can't read it): seeded
        #: from the (possibly recovered) window, bounded the same way
        self._admitted: Dict[str, None] = dict.fromkeys(
            sched._seen_batch_ids)
        self._state = "running"
        self._closing_flush = True
        self._paused = False
        self._executing = False
        self._flush_pending = False
        #: executed chunks whose tickets await the durable watermark
        self._pending_res = 0
        self.pump_error: Optional[BaseException] = None
        # -- counters/samples --
        self.submitted = 0
        self.admitted = 0
        self.applied = 0
        self.deduped = 0
        self.rejected = 0
        self.shed = 0
        self.ticks = 0
        self.pump_iterations = 0
        #: pipelining counters: fused windows staged through the split
        #: lifecycle, how many staged while a previous window was still
        #: in flight, and the host-stage seconds in each bucket
        #: (``stage_overlap_frac`` is the overlapped fraction)
        self.windows_staged = 0
        self.windows_pipelined = 0
        self.stage_s_total = 0.0
        self.stage_overlap_s = 0.0
        #: times a failed frontend was re-armed (:meth:`revive`)
        self.revives = 0
        # bounded reservoirs (most recent METRIC_WINDOW samples) — the
        # totals above are exact; only percentile inputs are windowed
        self.queue_depth_samples: Deque[int] = deque(maxlen=METRIC_WINDOW)
        self.admission_s: Deque[float] = deque(maxlen=METRIC_WINDOW)
        self.ticks_per_pump: Deque[int] = deque(maxlen=METRIC_WINDOW)
        self.inflight_bytes_peak = 0
        # obs wiring: registered metric sources (publish_metrics) and
        # the current window's ready/take stamps (trace spans)
        self._metric_keys: List = []
        self._win_t_ready: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._pump_loop, name="reflow-ingest-pump",
                daemon=True)
            self._thread.start()

    # -- crash seams -------------------------------------------------------

    def _crash_point(self, name: str) -> None:
        if self._crash is not None:
            self._crash.point(
                name if self.name is None else f"{name}@{self.name}")

    # -- producer side -----------------------------------------------------

    def submit(self, source: Node, batch, *, batch_id: Optional[str] = None,
               timeout: Optional[float] = None, preimage=None,
               cause: Optional[str] = None,
               sampled: Optional[bool] = None) -> Ticket:
        """Admit one micro-batch for ``source``; returns a Ticket that
        resolves once the batch's fate is decided. Thread-safe; callable
        from any number of producers. ``timeout`` bounds a ``block``
        admission wait (expiry resolves the ticket REJECTED).

        ``preimage``: for a device-resident ``batch``, the host-side
        ``DeltaBatch`` it was uploaded from — a durable scheduler then
        logs these bytes instead of reading the device copy back (the
        zero-readback logging path). Ignored for host batches.

        ``cause`` / ``sampled``: cross-process trace adoption (the
        ingestion RPC). ``sampled=None`` keeps today's local 1-in-N
        decision; a bool ADOPTS the wire decision that rode in with the
        producer's causality token, so every process records the same
        writes. A locally-sampled submit with no token mints one, so
        in-process callers get full chains too."""
        if source.kind not in ("source", "loop"):
            raise GraphError(
                f"can only submit to sources/loops, not {source}")
        if preimage is not None and hasattr(preimage, "nonzero"):
            raise GraphError(
                "preimage must be the HOST DeltaBatch the device batch "
                "was uploaded from, not another device batch")
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        try:
            # the executor's refusal (a key past the source's key_space)
            # fails this ticket alone, before its id is admitted: a
            # corrected resubmit with the same id goes through
            self.sched.check_host_batch(source, batch)
            refusal = None
        except DeliveryError as e:
            refusal = str(e)
        with self._lock:
            self._crash_point("producer_submit")
            self.submitted += 1
            if self._state != "running":
                raise FrontendClosed(
                    f"frontend is {self._state}; submissions not accepted")
            if batch_id is None:
                batch_id = self._cursor(source).next_id()
            ticket = Ticket(batch_id)
            if _trace.ENABLED:
                if sampled is None:
                    ticket.trace = _trace.mint(batch_id, t0)
                    if cause is not None:
                        ticket.trace.cause = cause
                else:
                    ticket.trace = _trace.TraceCtx(batch_id, t0,
                                                   sampled, cause)
                if ticket.trace.sampled and ticket.trace.cause is None:
                    ticket.trace.cause = _trace.mint_cause(
                        f"node-{os.getpid()}",
                        getattr(self.sched, "epoch", 0))
            if batch_id in self._admitted:
                self.deduped += 1
                ticket._resolve(TicketResult(
                    DEDUPED, batch_id,
                    reason="batch_id already admitted"))
                self._trace_submit(ticket, "deduped")
                return ticket
            if refusal is not None:
                self.rejected += 1
                ticket._resolve(TicketResult(REJECTED, batch_id,
                                             reason=refusal))
                self._trace_submit(ticket, "rejected")
                return ticket
            device = hasattr(batch, "nonzero")
            rows = 0 if device else len(batch)
            if not device and rows == 0:
                # an empty host batch is a semantic no-op; report it
                # applied rather than occupying a queue slot
                self._note_admitted(batch_id)
                ticket._resolve(TicketResult(APPLIED, batch_id,
                                             reason="empty batch"))
                self._trace_submit(ticket, "empty")
                return ticket
            nbytes = self._charge_bytes(source, batch, device)
            if not self._admit(source, nbytes, ticket, batch_id, deadline):
                return ticket  # ticket already resolved REJECTED/…
            if batch_id in self._admitted:
                # a blocked admission drops the lock in wait(): another
                # producer may have admitted this very id meanwhile —
                # pushing now would fold the batch twice
                self.deduped += 1
                ticket._resolve(TicketResult(
                    DEDUPED, batch_id,
                    reason="batch_id admitted concurrently while this "
                           "submit was blocked on backpressure"))
                self._trace_submit(ticket, "deduped")
                return ticket
            entry = Entry(ticket, source, batch, batch_id, nbytes,
                          time.perf_counter(), device, rows,
                          preimage=preimage if device else None)
            self._note_admitted(batch_id)
            self._queues.push(entry)
            self.admitted += 1
            self.admission_s.append(time.perf_counter() - t0)
            self.queue_depth_samples.append(self._queues.queued_batches)
            self.inflight_bytes_peak = max(
                self.inflight_bytes_peak,
                self._queues.queued_bytes + self._queues.executing_bytes)
            self._trace_submit(ticket, "admitted")
            self._work.notify()
            self._crash_point("producer_admitted")
        return ticket

    @staticmethod
    def _trace_submit(ticket: Ticket, outcome: str) -> None:
        # producer-track span covering this submit() call: admission
        # wait plus its terminal outcome (the sampled ticket's own
        # six-stage timeline is emitted at resolve time by the pump)
        ctx = ticket.trace
        if ctx is not None and ctx.sampled:
            _trace.evt("submit", ctx.t0,
                       time.perf_counter() - ctx.t0,
                       args={"batch_id": ticket.batch_id,
                             "outcome": outcome})

    def _charge_bytes(self, source: Node, batch, device: bool) -> int:
        """What this batch's admission charges against the byte budget.
        Under device-keyed admission (``admission="device"``, the
        window-path default) a host batch is charged the device bytes its
        ingress-queue slot will reserve — the capacity-bucketed padded
        footprint — so backpressure reflects actual device memory
        pressure, not host payload size. Device-resident batches always
        charge their (device) payload bytes; both reads are metadata,
        never a device sync."""
        if not device and self.admission == "device":
            from reflow_tpu_torch.executors.ingress_queue import slot_nbytes

            return slot_nbytes(source.spec, len(batch))
        return batch_nbytes(batch)

    def _admit(self, source: Node, nbytes: int, ticket: Ticket,
               batch_id: str, deadline: Optional[float]) -> bool:
        # caller holds the lock; resolves the ticket and returns False
        # when admission is refused
        while not self._queues.room_for(source.id, nbytes):
            if self.policy == "reject":
                self.rejected += 1
                ticket._resolve(TicketResult(
                    REJECTED, batch_id, reason="backpressure: queue full"))
                self._trace_submit(ticket, "rejected")
                return False
            if self.policy == "shed-oldest":
                if not self._queues.fits_alone(nbytes):
                    self.rejected += 1
                    ticket._resolve(TicketResult(
                        REJECTED, batch_id,
                        reason=f"batch of {nbytes}B exceeds the "
                               f"{self._queues.max_bytes}B budget"))
                    self._trace_submit(ticket, "rejected")
                    return False
                shed_any = False
                for e in self._queues.shed_for(source.id, nbytes):
                    self.shed += 1
                    shed_any = True
                    # the evicted batch never reached the scheduler: drop
                    # it from the dedup mirror so the re-send the SHED
                    # ticket demands is admitted, not DEDUPED away
                    self._admitted.pop(e.batch_id, None)
                    e.ticket._resolve(TicketResult(
                        SHED, e.batch_id,
                        reason="shed-oldest backpressure; re-send"))
                    self._trace_submit(e.ticket, "shed")
                if shed_any:
                    # freed bytes are budget-wide: a sibling graph's
                    # blocked producer may fit now
                    self._budget.notify_room()
                if self._queues.room_for(source.id, nbytes):
                    return True
                # executing bytes hold the budget: fall through to wait
            # block (and shed-oldest squeezed by in-flight execution)
            remaining = (None if deadline is None
                         else deadline - time.perf_counter())
            if remaining is not None and remaining <= 0:
                self.rejected += 1
                ticket._resolve(TicketResult(
                    REJECTED, batch_id,
                    reason="backpressure: admission timed out"))
                self._trace_submit(ticket, "rejected")
                return False
            if not self._not_full.wait(timeout=remaining):
                self.rejected += 1
                ticket._resolve(TicketResult(
                    REJECTED, batch_id,
                    reason="backpressure: admission timed out"))
                self._trace_submit(ticket, "rejected")
                return False
            if self._state != "running":
                raise FrontendClosed(
                    "frontend closed while blocked on admission")
        return True

    def _cursor(self, source: Node) -> SourceCursor:
        cur = self._cursors.get(source.id)
        if cur is None:
            cur = self._cursors[source.id] = SourceCursor.resume(
                self.sched, source)
        return cur

    def _note_admitted(self, batch_id: str) -> None:
        self._admitted[batch_id] = None
        while len(self._admitted) > self.sched.dedup_window:
            self._admitted.pop(next(iter(self._admitted)))

    def admitted_ids(self, batch_ids) -> list:
        """Which of ``batch_ids`` the dedup mirror currently remembers.
        The ingestion RPC's reconnect handshake: a producer that died
        in an ack window sends its in-doubt ids here, then resubmits —
        a remembered id resolves DEDUPED, keeping resubmission
        exactly-once without the producer ever guessing."""
        with self._lock:
            return [b for b in batch_ids if b in self._admitted]

    # -- lifecycle ---------------------------------------------------------

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every batch admitted so far has been ticked."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._lock:
            if self._state == "failed":
                raise PumpCrashed(f"pump died: {self.pump_error!r}")
            if self._paused:
                raise GraphError("flush() while paused would never "
                                 "complete; resume() first")
            self._flush_pending = True
            self._work.notify_all()
            try:
                while (self._queues.queued_batches or self._executing
                       or self._pending_res):
                    if self._state == "failed":
                        raise PumpCrashed(
                            f"pump died: {self.pump_error!r}")
                    if self._state == "closed":
                        return
                    remaining = (None if deadline is None
                                 else deadline - time.perf_counter())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError("flush timed out")
                    self._idle.wait(timeout=remaining)
            finally:
                self._flush_pending = False

    def drain(self, source: Optional[Node] = None, *, max_ticks: int = 256,
              probe_rows: int = 1) -> int:
        """Flush, then run the scheduler's ``drain`` (deferred-fixpoint
        residue) with the pump paused. ``source`` defaults to the
        graph's sole source; pass one explicitly on multi-source graphs.
        Returns the scheduler drain's tick count."""
        if source is None:
            srcs = [n for n in self.sched.graph.nodes
                    if n.kind == "source"]
            if len(srcs) != 1:
                raise GraphError(
                    f"drain needs an explicit source on a graph with "
                    f"{len(srcs)} sources")
            source = srcs[0]
        self.flush()
        self.pause()
        try:
            return self.sched.drain(source, max_ticks=max_ticks,
                                    probe_rows=probe_rows)
        finally:
            self.resume()

    def pause(self) -> None:
        """Stop pumping (admission continues to queue); returns once the
        in-flight macro-tick (if any) completes. The scheduler may then
        be inspected/driven directly until :meth:`resume`."""
        with self._lock:
            self._paused = True
            # also wait out dispatched-but-unretired pipelined windows:
            # their retire mutates the ingress queue the caller is about
            # to drive directly
            while self._executing or self._inflight:
                self._idle.wait()

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._work.notify_all()

    def close(self, *, flush: bool = True,
              timeout: Optional[float] = None) -> None:
        """Quiesce and shut down: stop admission, release blocked
        producers with :class:`FrontendClosed`, tick out the remaining
        backlog (``flush=True``) or fail its tickets (``flush=False``),
        stop the pump, and seal a durable scheduler's WAL. Idempotent.

        On an externally-pumped frontend the draining is done by the
        pool (which must still be serving — ``ServeTier`` closes graphs
        before stopping its threads); this call waits for it."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._lock:
            seal_only = self._state in ("closed", "failed")
        if seal_only:
            # outside the lock: sealing a durable scheduler closes its
            # WAL, whose final fsync may fire when_durable callbacks
            # that re-take this (non-reentrant) lock
            self._seal()
            return
        with self._lock:
            if self._state not in ("closed", "failed"):
                if self._state == "running":
                    self._closing_flush = flush
                # else: a retry after a close() timeout — keep the
                # original call's flush intent rather than silently
                # downgrading it
                self._state = "closing"
                self._paused = False
                self._not_full.notify_all()
                self._work.notify_all()
        if self._thread is not None:
            if self._thread.is_alive():
                self._thread.join(timeout=timeout)
                if self._thread.is_alive():
                    # the pump is still mid-macro-tick: sealing the WAL
                    # now would close a file it is appending to. Stay
                    # "closing" (admission already refused) and let the
                    # caller retry.
                    raise TimeoutError(
                        f"close() timed out after {timeout}s with the "
                        f"pump still draining; frontend left in state "
                        f"'closing' — call close() again to finish")
        else:
            self._close_external(deadline, timeout)
        with self._lock:
            if self._state != "failed":
                self._state = "closed"
            self._idle.notify_all()
        self._seal()

    def _close_external(self, deadline: Optional[float],
                        timeout: Optional[float]) -> None:
        # externally-pumped shutdown: with flush intent the pool drains
        # the backlog (closing graphs fire unconditionally in _poll);
        # without it we only wait out an in-flight window, then strand-
        # fail whatever is still queued
        with self._lock:
            while self._state == "closing" and (
                    self._executing or self._inflight
                    or (self._closing_flush
                        and self._queues.queued_batches)):
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"close() timed out after {timeout}s with the "
                        f"pump pool still draining; frontend left in "
                        f"state 'closing' — call close() again to "
                        f"finish")
                self._idle.wait(timeout=remaining)
            if self._state == "closing" and not self._closing_flush:
                self._exit_pump_locked()

    @property
    def stage_overlap_frac(self) -> float:
        """Fraction of host staging time that overlapped an in-flight
        device dispatch (0.0 at depth 1 or before any fused window)."""
        return (self.stage_overlap_s / self.stage_s_total
                if self.stage_s_total > 0 else 0.0)

    def publish_metrics(self, registry=None) -> str:
        """Register this frontend's live counters (the
        ``summarize_serve().to_dict()`` schema) as an obs metric source
        — live snapshots and offline summaries stay one schema.
        Unregistered automatically at :meth:`close`. Returns the source
        key (``serve.<name>``)."""
        from reflow_tpu_torch.obs import REGISTRY
        from reflow_tpu_torch.utils.metrics import summarize_serve
        reg = registry if registry is not None else REGISTRY
        key = f"serve.{self.name or 'frontend'}"
        reg.register_source(key,
                            lambda: summarize_serve(self).to_dict())
        self._metric_keys.append((reg, key))
        return key

    def _seal(self) -> None:
        for reg, key in self._metric_keys:
            reg.unregister_source(key)
        self._metric_keys = []
        closefn = getattr(self.sched, "close", None)
        if closefn is not None:
            closefn()

    def __enter__(self) -> "IngestFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close(flush=exc == (None, None, None))

    # -- the pump ----------------------------------------------------------

    def _fire_or_timeout(self, now: float):
        # under lock: (fire, wait_timeout)
        if self._state == "closing":
            return True, None
        if self._paused or self._queues.queued_batches == 0:
            return False, None
        if self._flush_pending:
            return True, None
        w = self.window
        if self._queues.queued_rows >= w.max_rows:
            return True, None
        if self._queues.pending_feed_rounds(w.max_rows) >= w.max_ticks:
            return True, None
        oldest = self._queues.oldest_t()
        age = now - oldest if oldest is not None else 0.0
        if age >= w.max_latency_s:
            return True, None
        return False, w.max_latency_s - age

    # external-pump surface (the tier's pool; every method below up to
    # _run_window is called with the shared lock held) ---------------------

    def _poll(self, now: float):
        """Pool eligibility: (fire, wait_s). Never fires while the
        in-flight latch is held (single-owner invariant), after a
        failure, or once closed; a closing graph fires only while a
        flush-close still has backlog to tick out."""
        if self._executing or self._state in ("closed", "failed"):
            return False, None
        if self._state == "closing":
            return (self._closing_flush
                    and self._queues.queued_batches > 0), None
        return self._fire_or_timeout(now)

    def _take_window(self, ready_since: Optional[float] = None
                     ) -> Dict[int, List[Entry]]:
        """Claim the backlog as one macro-tick work item and set the
        in-flight latch; the caller must follow with ``_run_window``
        (lock released) and ``_finish_window`` (lock re-held).
        ``ready_since`` (tier pool): when the window first became
        eligible — the gap to now is cross-graph scheduling delay on
        the trace timeline."""
        self._win_t_ready = (ready_since if ready_since is not None
                             else time.perf_counter())
        drained = self._queues.drain_all()
        self._flush_pending = False
        self._executing = True
        return drained

    def _finish_window(self) -> None:
        """Release the latch and the window's remaining budget bytes
        (staged chunks already released theirs at stage-complete); wake
        blocked producers (budget-wide) and flush/pause waiters."""
        self._executing = False
        self._queues.commit_executing()
        self._budget.notify_room()
        self._idle.notify_all()

    def _needs_settle(self) -> bool:
        """Pool eligibility for a settle-only iteration (caller holds
        the lock): dispatched windows are waiting for their retire and
        nobody owns the latch. Ignores ``_paused`` deliberately — pause
        WAITS on the in-flight windows, so settling must proceed."""
        return (bool(self._inflight) and not self._executing
                and self._state != "failed")

    def _begin_settle(self) -> None:
        """Latch the graph for a settle-only iteration (caller holds
        the lock; follow with ``_settle_all`` unlocked, then
        ``_finish_window``)."""
        self._executing = True

    def _pump_loop(self) -> None:
        try:
            while True:
                drained = None
                with self._lock:
                    while True:
                        if self._state == "closing" and (
                                not self._closing_flush
                                or self._queues.queued_batches == 0):
                            if not self._inflight:
                                self._exit_pump_locked()
                                return
                            self._begin_settle()  # retire first
                            break
                        fire, wait_t = self._fire_or_timeout(
                            time.perf_counter())
                        if fire:
                            drained = self._take_window()
                            break
                        if self._inflight:
                            # idle with windows in flight: the device has
                            # nothing to overlap with, so retire now
                            # (latched, so pause/close wait it out)
                            self._begin_settle()
                            break
                        self._work.wait(timeout=wait_t)
                if drained is None:
                    self._settle_all()
                    with self._lock:
                        self._finish_window()
                    continue
                self._run_window(drained)
                with self._lock:
                    self._finish_window()
        except BaseException as e:  # noqa: BLE001 - incl. CrashPoint kills
            self._on_pump_crash(e)

    def _exit_pump_locked(self) -> None:
        # caller holds the lock; fail whatever close(flush=False) strands
        stranded = self._queues.drain_all()
        self._queues.commit_executing()
        for entries in stranded.values():
            for e in entries:
                e.ticket._fail(FrontendClosed(
                    f"frontend closed before batch {e.batch_id!r} "
                    f"was ticked"))
        self._budget.notify_room()
        self._idle.notify_all()
        self._not_full.notify_all()

    def _device_label(self) -> Optional[str]:
        """Executing-device obs tag for this graph's spans (placement
        skew shows up in trace_inspect's per-device breakdown)."""
        return getattr(getattr(self.sched, "executor", None),
                       "device_label", None)

    def _run_window(self, drained: Dict[int, List[Entry]]) -> None:
        self._window_entries = drained  # crash path fails their tickets
        tr = _trace.ENABLED
        t_w0 = time.perf_counter()
        t_ready = self._win_t_ready or t_w0
        feeds = build_feeds(drained, self.window.max_rows)
        if tr:
            _trace.evt("host_merge", t_w0, time.perf_counter() - t_w0,
                       args={"graph": self.name or "frontend",
                             "feeds": len(feeds)})
        self._crash_point("pump_coalesce")
        wal = getattr(self.sched, "wal", None)
        push_pre = getattr(self.sched, "push_preimage", None)
        if wal is not None and push_pre is not None:
            # ingest-time pre-images: hand the durable scheduler the
            # host payloads captured at submit() so device batches log
            # without a forced readback
            for f in feeds:
                for entries in f.entries.values():
                    for e in entries:
                        if e.device and e.preimage is not None:
                            push_pre(e.batch_id, e.preimage)
        push_cause = getattr(self.sched, "push_cause", None)
        if tr and wal is not None and push_cause is not None:
            # register sampled tickets' causality tokens so the WAL
            # stamps them onto this window's push records — the shipper
            # and replicas then re-emit the same tokens, stitching the
            # chain across processes
            for f in feeds:
                for entries in f.entries.values():
                    for e in entries:
                        ctx = e.ticket.trace
                        if ctx is not None and ctx.cause:
                            push_cause(e.batch_id, ctx.cause)
        k = self.window.max_ticks
        for i in range(0, len(feeds), k):
            chunk = feeds[i:i + k]
            # bound the pipeline: at most depth dispatched windows may
            # exist once this chunk dispatches, so retire the oldest
            # until a slot is free (depth 1 ⇒ settle everything here ⇒
            # the serial stage→dispatch→retire loop, today's behavior)
            while len(self._inflight) > self.depth - 1:
                self._settle_one()
            self._crash_point("pump_before_tick")
            handle = None
            if self.depth > 1:
                t_s0 = time.perf_counter()
                inflight0 = len(self._inflight)
                handle = self.sched.stage_window(
                    [f.batches for f in chunk],
                    feed_ids=[f.ids for f in chunk])
                if handle is not None:
                    t_s1 = time.perf_counter()
                    self.windows_staged += 1
                    self.stage_s_total += t_s1 - t_s0
                    if inflight0 > 0:
                        self.windows_pipelined += 1
                        self.stage_overlap_s += t_s1 - t_s0
                    if tr:
                        _trace.evt("window_stage", t_s0, t_s1 - t_s0,
                                   args={"graph": self.name or "frontend",
                                         "ticks": len(chunk),
                                         "inflight": inflight0,
                                         "device": self._device_label()})
                    # stage-complete budget release: the chunk's rows now
                    # live in the device ingress queue, so their admission
                    # bytes stop occupying the frontend — producers
                    # unblock a window earlier than the retire
                    chunk_bytes = sum(
                        e.nbytes for f in chunk
                        for entries in f.entries.values() for e in entries)
                    with self._lock:
                        self._queues.release_executing(chunk_bytes)
                        self._budget.notify_room()
            if handle is not None:
                tick0 = self.sched._tick
                t_exec0 = time.perf_counter()
                self.sched.dispatch_staged(handle)
                lsn = wal.last_lsn() if wal is not None else 0
                t_exec1 = time.perf_counter()
                if tr:
                    _trace.evt("pump_execute", t_exec0, t_exec1 - t_exec0,
                               args={"graph": self.name or "frontend",
                                     "ticks": len(chunk), "lsn": lsn,
                                     "megatick": True,
                                     "depth": len(self._inflight) + 1,
                                     "device": self._device_label()})
                self._crash_point("pump_after_tick")
                block = _ResBlock(self._chunk_items(chunk, tick0), lsn,
                                  len(chunk), t_ready, t_exec0, t_exec1)
                with self._lock:
                    self._pending_res += 1
                self._inflight.append(_InflightWindow(handle, block))
                continue
            # unfused (or depth-1) chunk: settle the pipeline first so
            # ticket wiring stays LSN-ordered, then run today's serial
            # tick_many path verbatim (it re-checks the window fit and
            # counts any fallback exactly once)
            self._settle_all()
            tick0 = self.sched._tick
            t_exec0 = time.perf_counter()
            if wal is not None:
                self.sched.tick_many([f.batches for f in chunk],
                                     feed_ids=[f.ids for f in chunk],
                                     wait_durable=False)
                lsn = wal.last_lsn()
            else:
                self.sched.tick_many([f.batches for f in chunk],
                                     feed_ids=[f.ids for f in chunk])
                lsn = 0
            t_exec1 = time.perf_counter()
            if tr:
                _trace.evt("pump_execute", t_exec0, t_exec1 - t_exec0,
                           args={"graph": self.name or "frontend",
                                 "ticks": len(chunk), "lsn": lsn,
                                 "megatick": self.megatick,
                                 "depth": 1,
                                 "device": self._device_label()})
            self._crash_point("pump_after_tick")
            block = _ResBlock(self._chunk_items(chunk, tick0), lsn,
                              len(chunk), t_ready, t_exec0, t_exec1)
            with self._lock:
                self._pending_res += 1
            if tr:
                self._trace_retire_wait(block, time.perf_counter())
            self._wire_block(block)
        if tr:
            _trace.evt("window", t_w0, time.perf_counter() - t_w0,
                       args={"graph": self.name or "frontend",
                             "feeds": len(feeds),
                             "device": self._device_label()})
        self._win_t_ready = None
        with self._lock:
            self.pump_iterations += 1
            self.ticks_per_pump.append(len(feeds))
            more = (self._state == "running" and not self._paused
                    and not self._flush_pending
                    and self._queues.queued_batches > 0)
        self._window_entries = None
        # keep the pipeline primed only when another window is imminent:
        # its stage will overlap these dispatches. Otherwise retire now,
        # inside the latch, so flush/pause/close observe a settled graph.
        if self.depth <= 1 or not more:
            self._settle_all()

    @staticmethod
    def _chunk_items(chunk, tick0: int) -> List[Tuple[Entry, int, int]]:
        items = []
        for j, f in enumerate(chunk):
            for entries in f.entries.values():
                for e in entries:
                    items.append((e, tick0 + j + 1, len(entries) - 1))
        return items

    def _settle_one(self) -> None:
        """Retire the OLDEST dispatched window (lock NOT held): re-adopt
        its queue generation, then wire its tickets onto the
        durable watermark. Runs off the stage→dispatch critical path —
        under pipelining this executes while the next window is already
        on the device."""
        iw = self._inflight.popleft()
        tr = _trace.ENABLED
        t_r0 = time.perf_counter() if tr else 0.0
        if tr:
            self._trace_retire_wait(iw.block, t_r0)
        self.sched.retire_staged(iw.handle)
        if tr:
            _trace.evt("window_retire", t_r0, time.perf_counter() - t_r0,
                       args={"graph": self.name or "frontend",
                             "ticks": iw.block.nticks})
        self._wire_block(iw.block)

    def _settle_all(self) -> None:
        while self._inflight:
            self._settle_one()

    def _trace_retire_wait(self, block: _ResBlock, t_end: float) -> None:
        """The ``retire_wait`` span of one dispatched window: from its
        dispatch's end to the start of its retire (on the pipelined path,
        the wait for the next window's stage and dispatch; on the serial
        path, the moment before its tickets are wired)."""
        _trace.evt("retire_wait", block.t_exec1, t_end - block.t_exec1,
                   args={"graph": self.name or "frontend",
                         "first": block.items[0][1] if block.items else None,
                         "last": block.items[-1][1] if block.items else None,
                         "ticks": block.nticks})

    def _wire_block(self, block: _ResBlock) -> None:
        """Park one executed chunk's tickets on the durable watermark
        (``_pending_res`` was already taken at dispatch). Pipelined
        resolution: commit-before-resolve holds, but the commit (the
        fsync) may still be in flight — ``when_durable`` fires on the
        committer once the window's LSN is covered, so the pump overlaps
        the disk latency instead of serializing behind it."""
        wal = getattr(self.sched, "wal", None)
        if wal is None:
            self._complete_block(block, None)
            return
        try:
            deferred = wal.when_durable(
                block.lsn,
                lambda err, b=block: self._complete_block(b, err))
        except BaseException:
            with self._lock:
                self._pending_res -= 1
            raise
        if not deferred:
            self._complete_block(block, None)

    def _complete_block(self, block: _ResBlock,
                        err: Optional[BaseException]) -> None:
        """Resolve one executed chunk's tickets at its durability point.
        Runs inline on the pump (LSN already durable / non-durable
        scheduler) or on the WAL committer thread via ``when_durable``
        (pipelined fsync). ``err`` is the committer's death cause — the
        chunk's records may never become durable, so its undecided
        tickets fail with :class:`PumpCrashed` instead (the upstream
        re-sends; replay after ``recover()`` dedups)."""
        if err is not None:
            crash = PumpCrashed(
                f"wal committer died before the window's records were "
                f"durable: {err!r}")
            crash.__cause__ = err
            with self._lock:
                self._state = "failed"
                self.pump_error = err
                self._pending_res -= 1
                self._not_full.notify_all()
                self._work.notify_all()
                self._idle.notify_all()
            for e, _tick, _co in block.items:
                if not e.ticket.done():
                    e.ticket._fail(crash)
            return
        tr = _trace.ENABLED
        t_dur = time.perf_counter()
        applied = 0
        for e, tick, co in block.items:
            if e.ticket.done():
                continue  # a pump-crash path decided it first
            ctx = e.ticket.trace
            e.ticket._resolve(TicketResult(
                APPLIED, e.batch_id, tick=tick, coalesced_with=co,
                lsn=block.lsn or None))
            applied += 1
            if tr and ctx is not None and ctx.sampled:
                _trace.ticket_stages(
                    ctx, t_adm=e.t_admitted, t_ready=block.t_ready,
                    t_exec0=block.t_exec0, t_exec1=block.t_exec1,
                    t_dur=t_dur, t_res=time.perf_counter())
                if ctx.cause:
                    # the write's durability boundary on the shared
                    # chain: execute end -> durable watermark passed
                    _trace.evt("wal_append", block.t_exec1,
                               t_dur - block.t_exec1, track="wal",
                               args={"batch_id": e.batch_id,
                                     "cause": ctx.cause,
                                     "lsn": block.lsn or None})
        with self._lock:
            self._pending_res -= 1
            self.ticks += block.nticks
            self.applied += applied
            self._idle.notify_all()

    def _on_pump_crash(self, error: BaseException,
                       window: Optional[Dict[int, List[Entry]]] = None,
                       ) -> None:
        """Fail the frontend after its pump died: every undecided ticket
        of the in-flight window and the stranded backlog resolves with
        :class:`PumpCrashed`, blocked producers are released, and the
        graph's budget bytes return to the pool. On a tier, only THIS
        graph fails — the pool thread survives and keeps serving
        siblings (``window`` carries the drained entries when the crash
        fired before ``_run_window`` stamped them)."""
        with self._lock:
            self._state = "failed"
            self.pump_error = error
            self._executing = False
            # dispatched-but-unretired pipelined windows die with the
            # pump: their device work may or may not have completed, so
            # treat them like the in-flight window — tickets fail (the
            # upstream re-sends; durable replay dedups what actually
            # applied) and their ids STAY in the dedup mirror. Their
            # queue generations are never retired; the executor drops
            # the queue on a dispatch crash, and a fresh one is
            # allocated next window.
            inflight = list(self._inflight)
            self._inflight.clear()
            self._pending_res -= len(inflight)
            stranded = self._queues.drain_all()
            self._queues.commit_executing()
            # the stranded backlog never reached the scheduler: drop its
            # ids from the dedup mirror (same reasoning as the shed
            # path) so a re-send after revive() is admitted, not
            # DEDUPED. The in-flight window's ids stay mirrored — they
            # may have executed before the crash, and a re-send that
            # turns out unapplied still dedups safely at replay.
            for entries in stranded.values():
                for e in entries:
                    self._admitted.pop(e.batch_id, None)
            self._budget.notify_room()
            self._not_full.notify_all()
            self._work.notify_all()
            self._idle.notify_all()
        crash = PumpCrashed(f"ingest pump died: {error!r}")
        crash.__cause__ = error
        if window is None:
            window = getattr(self, "_window_entries", None) or {}
        for iw in inflight:
            for e, _tick, _co in iw.block.items:
                if not e.ticket.done():
                    e.ticket._fail(crash)
        for entries in list(window.values()) + list(stranded.values()):
            for e in entries:
                if not e.ticket.done():
                    e.ticket._fail(crash)

    def _bind_sched(self, sched) -> None:
        """Re-point a settled frontend at a new scheduler (the failover
        path; caller holds the lock, state is ``"failed"``). The dedup
        mirror is REBUILT from the new scheduler's recovered window:
        a batch the old leader committed *and shipped* dedups here,
        while a batch only the dead leader ever saw is dropped from the
        mirror — its ticket failed with ``PumpCrashed``, the producer's
        resubmit is admitted, and it folds exactly once on the new
        leader."""
        self.sched = sched
        self._cursors.clear()  # auto-id cursors re-derive from new sched
        self._admitted = dict.fromkeys(sched._seen_batch_ids)
        self.megatick = bool(getattr(sched, "window_support", False))
        if not self.megatick and self.admission == "device":
            self.admission = "host"
        staged = (self.megatick
                  and getattr(sched, "stage_window", None) is not None)
        if not staged:
            self.depth = 1

    def revive(self, sched=None) -> None:
        """Re-arm a failed frontend: ``"failed"`` → ``"running"`` — the
        control plane's respawn actuator (callers can also use it by
        hand). Only valid after :meth:`_on_pump_crash` settled the
        graph: queues drained, budget released, every undecided ticket
        failed — so the frontend is structurally identical to a freshly
        registered one and new submissions flow immediately. Upstreams
        re-send the batches whose tickets failed with
        :class:`PumpCrashed`; a durable graph's replay dedups any that
        actually executed.

        ``sched=`` re-points the frontend at a NEW scheduler before
        re-arming — the failover path: after a leader dies and a
        replica promotes, the tier revives the same frontend over the
        promoted ``DurableScheduler`` so producers keep their handle
        and resubmit through the (rebuilt) dedup mirror.

        Durability caveat: reviving is at-most-once for the CRASHED
        window on a volatile graph (its deltas are gone); a durable
        graph loses nothing acknowledged — unacknowledged batches are
        the upstream's to re-send, same as process-crash recovery. If
        the scheduler's WAL committer is dead this raises — call
        ``wal.restart_committer()`` first (or pass the promoted
        ``sched=``), or the next window would fail the graph right
        back."""
        with self._lock:
            if self._state != "failed":
                raise GraphError(
                    f"revive() re-arms a failed frontend; state is "
                    f"{self._state!r}")
            if sched is not None and sched is not self.sched:
                self._bind_sched(sched)
            wal = getattr(self.sched, "wal", None)
            if wal is not None and wal.committer_error is not None:
                raise GraphError(
                    "scheduler's WAL committer is dead; "
                    "restart_committer() before revive()")
            self._state = "running"
            self.pump_error = None
            self._executing = False
            self.revives += 1
            if self._thread is not None and not self._thread.is_alive():
                # the pump thread died WITH the crash (its own window
                # hit the dead committer) rather than surviving it (the
                # committer thread failing tickets via when_durable):
                # re-arm the loop itself, not just the state flag, or
                # nothing drains the queues and flush() never returns
                self._thread = threading.Thread(
                    target=self._pump_loop, name="reflow-ingest-pump",
                    daemon=True)
                self._thread.start()
            self._not_full.notify_all()
            self._work.notify_all()
            self._idle.notify_all()
