"""Trace spans: lock-free per-thread ring buffers of timed events, and
spans on the card's clock.

The serving stack mints a :class:`TraceCtx` at ``IngestFrontend.submit``
and carries it on the :class:`~reflow_tpu_torch.serve.tickets.Ticket`; each
subsystem a ticket crosses (admission, coalesce queue, pump/tick, WAL
group-commit, resolve) records stage spans via :func:`evt`. Events land
in a fixed-size ring owned by the *recording* thread — no locks, no
allocation beyond the event tuple — so tracing a hot pump costs one
attribute check when disabled and one ring slot when enabled.
:func:`span` is the one helper for a block: an obs span while tracing
is on, and a ``torch.profiler`` range while a profiler records.

Disabled by default. Enable with ``REFLOW_TRACE=1`` in the environment
or ``obs.enable()`` at runtime; every instrumentation site guards with
a direct ``if trace.ENABLED:`` module-attribute read, so the disabled
cost stays at a single dict lookup and no CUDA event is made.

Per-ticket sampling: minting is counted globally and every
``SAMPLE_EVERY``-th ticket (``REFLOW_TRACE_SAMPLE``, default 16) gets
``sampled=True`` — only sampled tickets emit the six-stage end-to-end
timeline (:func:`ticket_stages`); unsampled traffic still appears in
the aggregate per-thread spans (windows, ticks, WAL appends).

The stage tiling is exact by construction: ``admission`` ``[t0,t_adm]``,
``coalesce`` ``[t_adm,t_ready]``, ``sched_delay`` ``[t_ready,t_exec0]``,
``execute`` ``[t_exec0,t_exec1]``, ``fsync`` ``[t_exec1,t_dur]``,
``resolve`` ``[t_dur,t_res]`` — the six durations tile ``[t0,t_res]``
with no gaps or overlap, so they sum to the measured end-to-end ticket
latency. With the asynchronous WAL committer the ``fsync`` stage is the
*durability wait*: the gap between the execute finishing (``t_exec1``)
and the ticket's LSN passing the durable watermark (``t_dur``) — near
zero when the committer's fsync fully overlapped the execute, the
exposed disk latency when it didn't. The committer's own ``wal_fsync``
spans land on the ``wal-committer`` track. On a scheduler without a
WAL, ``t_dur`` is the moment the window is settled, so ``fsync`` is the
pipeline's wait for the settle: with a window depth above 1, window N
settles only once window N+1 has been staged and dispatched (the
frontend's ``retire_wait`` span, one a window).

Device spans: while tracing is on, an executor on a card records a pair
of timing CUDA events on its stream around each tick's launches
(:func:`device_tick_begin` / :func:`device_tick_end`). The events come
from a pool per device, and the pairs are resolved lazily — the
completed ones when a window retires (:func:`device_resolve`), any left
when the spans are read — so nothing synchronises on the hot path. One
clock anchor per device, the best of a few event round trips after one
``synchronize`` (:func:`_take_anchor`), taken when tracing first meets
the device and again after :func:`reset`, turns a pair into a
``device_tick`` span on the
``time.perf_counter()`` clock of every other span, on a track
``device/<label>``. These spans are kept apart from :func:`events`
(:func:`device_events` reads them, under the same :func:`reset` and
``RING_CAPACITY``): a reader that names host-side gaps by the spans
around them should not name them after the card.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

__all__ = ["ENABLED", "RING_CAPACITY", "SAMPLE_EVERY", "STAGES",
           "WINDOW_SPANS", "DEVICE_SPANS",
           "TraceCtx", "enable", "disable", "enabled", "reset", "evt",
           "events", "span", "device_tick_begin", "device_tick_end",
           "device_resolve", "device_events", "count_live", "mint",
           "mint_cause",
           "sample", "set_flight_hook", "ticket_stages", "wal_accum_reset",
           "wal_accum_add", "wal_accum_take"]

#: hot-path gate — read directly (``if trace.ENABLED:``) at every
#: instrumentation site; never wrapped in a function call
ENABLED = False

from reflow_tpu_torch.utils.config import env_flag, env_int

RING_CAPACITY = env_int("REFLOW_TRACE_RING")
SAMPLE_EVERY = max(1, env_int("REFLOW_TRACE_SAMPLE"))

#: the per-ticket stage names, in pipeline order
STAGES = ("admission", "coalesce", "sched_delay", "execute", "fsync",
          "resolve")

#: the aggregate spans of the pump's window path, beside the per-ticket
#: stages: the executor's stage (``queue_stage``) with its slot writes
#: into the ingress queue (``queue_write``), the launches of one window
#: (``device_dispatch``, ``kind`` "window") and of each of its ticks
#: (``tick_launch``), and its retire (``queue_retire``); the scheduler's
#: plan (``tick_plan``), its ``tick_many`` (``fused`` and, on the pump's
#: staged path, ``staged``) and its ``tick_result``; the pump's
#: ``window_stage``, ``pump_execute`` and ``window_retire``, and
#: ``retire_wait``, a dispatched window's wait for its retire
WINDOW_SPANS = ("queue_stage", "queue_write", "device_dispatch",
                "tick_launch", "queue_retire", "tick_plan", "tick_many",
                "tick_result", "window_stage", "pump_execute",
                "window_retire", "retire_wait")

#: the spans on the card's clock (:func:`device_events`)
DEVICE_SPANS = ("device_tick",)

#: event tuple: (name, ts_s, dur_s, track_override_or_None, args_or_None)
Event = Tuple[str, float, float, Optional[str], Optional[Dict[str, Any]]]

_rings: List["Ring"] = []
from reflow_tpu_torch.utils.runtime import named_lock

_rings_lock = named_lock("obs.trace.rings")  # ring *registration* only, never puts
_tls = threading.local()
_gen = 0
_mint_n = itertools.count()
_cause_n = itertools.count()

#: optional flight-recorder tee (obs/flight.py installs it): called as
#: ``hook(name, ts, dur, track, args)`` after every ring put. A plain
#: module global (like ENABLED) so the disabled cost is one None check.
_flight_hook = None


def set_flight_hook(hook) -> None:
    """Install (or clear, with None) the flight-recorder tee on
    :func:`evt`. One consumer at a time — the per-process
    :class:`~reflow_tpu_torch.obs.flight.FlightRecorder`."""
    global _flight_hook
    _flight_hook = hook

class TraceCtx:
    """Per-submission trace context carried on the Ticket.

    ``cause`` is the optional causality token (:func:`mint_cause`) that
    correlates this context with spans recorded elsewhere: the
    replication path stamps it onto :class:`~reflow_tpu_torch.wal.ship.
    Shipment` chunks so ``ship_segment`` and ``replica_replay`` stitch
    into one chain."""

    __slots__ = ("batch_id", "t0", "sampled", "cause")

    def __init__(self, batch_id: str, t0: float, sampled: bool,
                 cause: Optional[str] = None):
        self.batch_id = batch_id
        self.t0 = t0
        self.sampled = sampled
        self.cause = cause


class Ring:
    """Fixed-size overwrite-oldest event buffer, single-writer (the
    owning thread); snapshots tolerate concurrent writes by copying."""

    __slots__ = ("track", "cap", "buf", "n", "gen")

    def __init__(self, track: str, cap: int, gen: int):
        self.track = track
        self.cap = cap
        self.buf: List[Optional[Event]] = [None] * cap
        self.n = 0
        self.gen = gen

    def put(self, ev: Event) -> None:
        self.buf[self.n % self.cap] = ev
        self.n += 1

    def events(self) -> List[Event]:
        """Buffered events, oldest first (an approximate snapshot if the
        owner is still writing — fine for export)."""
        n, cap = self.n, self.cap
        if n <= cap:
            return [e for e in self.buf[:n] if e is not None]
        i = n % cap
        return [e for e in self.buf[i:] + self.buf[:i] if e is not None]


def _ring() -> Ring:
    r = getattr(_tls, "ring", None)
    if r is None or r.gen != _gen:
        r = Ring(threading.current_thread().name, RING_CAPACITY, _gen)
        _tls.ring = r
        with _rings_lock:
            _rings.append(r)
    return r


def enable() -> None:
    """Turn tracing on (idempotent); anchors the clock of every card
    tracing has met since the last :func:`reset` and has no anchor for."""
    global ENABLED
    ENABLED = True
    _anchor_known()


def disable() -> None:
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def reset() -> None:
    """Drop all buffered events and detach every thread's ring (they
    re-register lazily via a generation bump), the device spans and their
    pending pairs too; while tracing is on, the clock of every card met so
    far is anchored anew. Tests / bench baselines."""
    global _gen
    with _rings_lock:
        _gen += 1
        _rings.clear()
    with _dev_lock:
        for label, _tick, a, b in _dev_pending:
            _dev_pool.setdefault(label, []).extend((a, b))
        _dev_pending.clear()
        _counts_pending.clear()
        _anchors.clear()
    _anchor_known()


def evt(name: str, ts: float, dur: float, track: Optional[str] = None,
        args: Optional[Dict[str, Any]] = None) -> None:
    """Record one complete span: ``ts`` is a ``time.perf_counter()``
    start, ``dur`` seconds. ``track`` overrides the export row (default:
    the recording thread's name)."""
    if not ENABLED:
        return
    _ring().put((name, ts, dur, track, args))
    if _flight_hook is not None:
        _flight_hook(name, ts, dur, track, args)


def events() -> List[Tuple[str, Event]]:
    """Every buffered event as ``(track, event)``, per ring oldest first
    (the recording thread's name is the default track); the counts still
    on a card (:func:`count_live`) are waited for and filled in
    first."""
    _resolve_counts(wait=True)
    with _rings_lock:
        rings = list(_rings)
    return [(ev[3] or r.track, ev) for r in rings for ev in r.events()]


class _Span:
    """The context :func:`span` returns while tracing is on or a profiler
    records; ``t1`` is the obs span's end once the block has left it."""

    __slots__ = ("name", "args", "label", "t0", "t1", "rf")

    def __init__(self, name: Optional[str], args, label: Optional[str]):
        self.name = name
        self.args = args
        self.label = label
        self.t0 = None
        self.t1 = None
        self.rf = None

    def __enter__(self) -> "_Span":
        # the obs span holds the profiler range's own cost
        if ENABLED and self.name is not None:
            self.t0 = time.perf_counter()
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(
                self.label or f"reflow::{self.name}")
            self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.t0 is not None:
            self.t1 = time.perf_counter()
            evt(self.name, self.t0, self.t1 - self.t0, args=self.args)


_NO_SPAN = contextlib.nullcontext()


def span(name: Optional[str], args: Optional[Dict[str, Any]] = None, *,
         label: Optional[str] = None):
    """A block's span, the one helper for both records: while tracing is
    on, an obs span ``name`` (with ``args``) on the recording thread's
    track; while a ``torch.profiler`` records, a range ``label`` (by
    default ``reflow::<name>``), so a device trace attributes the block's
    device time. ``name=None`` makes the profiler range alone. Neither
    on: a shared no-op context, for two flag reads."""
    if ENABLED or torch.autograd._profiler_enabled():
        return _Span(name, args, label)
    return _NO_SPAN


# -- device-clock spans ------------------------------------------------------

_dev_lock = named_lock("obs.trace.device")
#: free timing events by device label, reused pair after pair
_dev_pool: Dict[str, List[Any]] = {}
#: recorded pairs not yet resolved, oldest first: (label, tick, a, b)
_dev_pending: Deque[Tuple[str, int, Any, Any]] = deque()
#: the clock anchor of each device: (perf_counter s, completed event)
_anchors: Dict[str, Tuple[float, Any]] = {}
#: every device tracing has met, by label (re-anchored after a reset)
_dev_known: Dict[str, Any] = {}
_dev_ring: Optional[Ring] = None
#: round trips an anchor takes the best of
ANCHOR_TRIPS = 7
#: pending pairs past which a new tick first resolves the completed ones
#: (a path with no window retire, such as per-tick passes)
PENDING_MAX = 256


def _take_anchor(device) -> Tuple[float, Any]:
    """The host time of a completed event on ``device``: after one
    ``synchronize``, the shortest of a few record-and-wait round trips on
    the idle stream, timed at the moment its record returned. An idle card
    stamps an event as soon as it is submitted; the synchronize's wake-up
    comes later and by an unequal amount, so the round trip's middle
    would place the card's clock early."""
    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    best = None
    for _ in range(ANCHOR_TRIPS):
        ev = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        ev.record(stream)
        h_rec = time.perf_counter()
        ev.synchronize()
        trip = time.perf_counter() - h0
        if best is None or trip < best[0]:
            best = (trip, h_rec, ev)
    return best[1], best[2]


def _anchor_known() -> None:
    """Anchor every device met so far that has no anchor (tracing on)."""
    if not ENABLED:
        return
    with _dev_lock:
        for label, device in _dev_known.items():
            if label not in _anchors:
                _anchors[label] = _take_anchor(device)


def device_tick_begin(device) -> Tuple[str, Any, Any, Any, int]:
    """Record the start event of one tick's launches on ``device``'s
    current stream (call under ``ENABLED``, for a CUDA device). The first
    call on a device since a reset anchors its clock (one synchronize).
    Returns the token :func:`device_tick_end` takes."""
    label = str(device)
    with _dev_lock:
        if label not in _anchors:
            _dev_known[label] = device
            _anchors[label] = _take_anchor(device)
        pool = _dev_pool.setdefault(label, [])
        a = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        b = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        gen = _gen
    a.record(torch.cuda.current_stream(device))
    return label, a, b, device, gen


def device_tick_end(token, tick: int) -> None:
    """Record the end event of the tick begun with ``token`` and queue the
    pair for resolution (no wait)."""
    label, a, b, device, gen = token
    b.record(torch.cuda.current_stream(device))
    with _dev_lock:
        if gen != _gen:  # begun before a reset: drop the pair
            _dev_pool.setdefault(label, []).extend((a, b))
            return
        _dev_pending.append((label, tick, a, b))
        backlog = len(_dev_pending) > PENDING_MAX
    if backlog:
        device_resolve()


def device_resolve(wait: bool = False) -> None:
    """Turn recorded pairs into ``device_tick`` spans, oldest first: those
    the card has completed, or with ``wait`` every one recorded so far
    (waiting on those still in flight, outside the lock the pump's ticks
    take: for readers, never the hot path). Their events go back to the
    pool. The counts on a card (:func:`count_live`) resolve alike."""
    global _dev_ring
    _resolve_counts(wait)
    if wait:
        with _dev_lock:
            ends = [b for _label, _tick, _a, b in _dev_pending]
        for b in ends:
            b.synchronize()
    with _dev_lock:
        if _dev_ring is None or _dev_ring.gen != _gen:
            _dev_ring = Ring("device", RING_CAPACITY, _gen)
        while _dev_pending:
            label, tick, a, b = _dev_pending[0]
            if not b.query():
                break
            _dev_pending.popleft()
            host0, ev0 = _anchors[label]
            _dev_ring.put((DEVICE_SPANS[0],
                           host0 + ev0.elapsed_time(a) / 1e3,
                           a.elapsed_time(b) / 1e3, f"device/{label}",
                           {"tick": tick, "device": label}))
            _dev_pool[label].extend((a, b))


def _device_ring() -> Optional[Ring]:
    """The ring of resolved device spans of this generation, every pending
    pair resolved first (None before any)."""
    device_resolve(wait=True)
    with _dev_lock:
        return _dev_ring if _dev_ring.gen == _gen else None


def device_events() -> List[Tuple[str, Event]]:
    """Every buffered ``device_tick`` span as ``(track, event)``, oldest
    first, like :func:`events` (which leaves them out); pending pairs are
    resolved first, waiting on the card for those still in flight."""
    ring = _device_ring()
    return [(ev[3], ev) for ev in ring.events()] if ring is not None else []


# -- counts of the card's rows, read after the tick -------------------------

#: live counts still on a card, oldest first: (span args, host copy, event)
_counts_pending: Deque[Tuple[Dict[str, Any], Any, Any]] = deque()


def count_live(args: Dict[str, Any], n: torch.Tensor) -> None:
    """Put the device scalar ``n`` (a delta's live rows,
    ``DeviceDelta.nonzero()``) into ``args["live"]`` (call under
    ``ENABLED``), with no sync: on the CPU at once; on a card the count is
    copied to the host behind a CUDA event, ``args["live"]`` is None until
    the card has passed it, and the completed counts are filled in where
    the device spans resolve (:func:`device_resolve`) and every count by
    :func:`events`, which waits for them."""
    if n.device.type != "cuda":
        args["live"] = int(n)
        return
    host = n.to("cpu", non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(n.device))
    args["live"] = None
    with _dev_lock:
        _counts_pending.append((args, host, ev))
        backlog = len(_counts_pending) > PENDING_MAX
    if backlog:
        _resolve_counts(wait=False)


def _resolve_counts(wait: bool) -> None:
    """Fill in the counts the card has completed, oldest first, or with
    ``wait`` every one recorded so far (waiting outside the lock)."""
    if wait:
        with _dev_lock:
            evs = [ev for _args, _host, ev in _counts_pending]
        for ev in evs:
            ev.synchronize()
    with _dev_lock:
        while _counts_pending and _counts_pending[0][2].query():
            args, host, _ev = _counts_pending.popleft()
            args["live"] = int(host)


def mint(batch_id: str, t0: float) -> TraceCtx:
    """Mint the trace context for one submission (call under ENABLED)."""
    return TraceCtx(batch_id, t0,
                    next(_mint_n) % SAMPLE_EVERY == 0)


def sample() -> bool:
    """One draw from the global 1-in-``SAMPLE_EVERY`` sampler — the
    same counter :func:`mint` uses, for callers (the remote producer)
    that decide sampling *before* a ticket exists. The decision then
    rides the minted causality token over the wire so every downstream
    process records the same writes without re-rolling."""
    return next(_mint_n) % SAMPLE_EVERY == 0


def mint_cause(origin: str, epoch: int) -> str:
    """Mint one causality token: ``<origin>#<epoch>#<seq>``.

    ``origin`` is the minting node's fleet id, ``epoch`` the WAL epoch
    the work belongs to, ``seq`` a process-local monotonic counter.
    The token is an opaque string on purpose: it rides span ``args``
    (JSON) and the pickled ``Shipment`` wire frame unchanged, and every
    process that re-records it under its own clock still joins on exact
    string equality — no cross-host clock trust required."""
    return f"{origin}#{epoch}#{next(_cause_n)}"


def ticket_stages(ctx: TraceCtx, *, t_adm: float, t_ready: float,
                  t_exec0: float, t_exec1: float, t_dur: float,
                  t_res: float) -> None:
    """Emit the six-stage end-to-end timeline of one sampled ticket onto
    its own ``ticket/<batch_id>`` track. ``t_dur`` is the durability
    point — when the ticket's LSN passed ``wal.wait_durable``; on a
    scheduler without a WAL, the moment the window was settled, so the
    fsync stage is the pipeline's wait for the settle (the window's
    ``retire_wait`` and the retire). Boundaries are clamped into
    pipeline order so the stages tile ``[ctx.t0, t_res]`` exactly."""
    if not ENABLED:
        return
    track = f"ticket/{ctx.batch_id}"
    t_adm = max(ctx.t0, min(t_adm, t_exec0))
    c1 = max(t_adm, min(t_ready, t_exec0))      # coalesce end
    t_res = max(t_exec1, t_res)
    d = max(t_exec1, min(t_dur, t_res))         # durability point
    spans = (("admission", ctx.t0, t_adm),
             ("coalesce", t_adm, c1),
             ("sched_delay", c1, t_exec0),
             ("execute", t_exec0, t_exec1),
             ("fsync", t_exec1, d),
             ("resolve", d, t_res))
    args: Dict[str, Any] = {"batch_id": ctx.batch_id}
    if ctx.cause:
        args["cause"] = ctx.cause
    for name, s, e in spans:
        evt(name, s, e - s, track=track, args=args)


# -- WAL time accumulator ----------------------------------------------------
# A per-thread sum of WAL append and fsync seconds, for instrumentation
# outside the package: the frontend measures the durability wait as its
# own span and does not feed it.

def wal_accum_reset() -> None:
    _tls.wal_s = 0.0


def wal_accum_add(s: float) -> None:
    _tls.wal_s = getattr(_tls, "wal_s", 0.0) + s


def wal_accum_take() -> float:
    """The thread's sum since its last reset or take, and reset it."""
    s = getattr(_tls, "wal_s", 0.0)
    _tls.wal_s = 0.0
    return s


if env_flag("REFLOW_TRACE"):
    enable()
