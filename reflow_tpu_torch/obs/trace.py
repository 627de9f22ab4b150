"""Trace spans: lock-free per-thread ring buffers of timed events.

The serving stack mints a :class:`TraceCtx` at ``IngestFrontend.submit``
and carries it on the :class:`~reflow_tpu_torch.serve.tickets.Ticket`; each
subsystem a ticket crosses (admission, coalesce queue, pump/tick, WAL
group-commit, resolve) records stage spans via :func:`evt`. Events land
in a fixed-size ring owned by the *recording* thread — no locks, no
allocation beyond the event tuple — so tracing a hot pump costs one
attribute check when disabled and one ring slot when enabled.

Disabled by default. Enable with ``REFLOW_TRACE=1`` in the environment
or ``obs.enable()`` at runtime; every instrumentation site guards with
a direct ``if trace.ENABLED:`` module-attribute read so the disabled
cost stays at a single dict lookup (the <1% serve-bench regression
budget in ISSUE 4).

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
latency (the 10% acceptance budget is headroom for export rounding, not
for model error). With the asynchronous WAL committer the ``fsync``
stage is the *durability wait*: the gap between the execute finishing
(``t_exec1``) and the ticket's LSN passing the durable watermark
(``t_dur``) — near-zero when the committer's fsync fully overlapped the
execute, the exposed disk latency when it didn't. The committer's own
``wal_fsync`` spans land on the ``wal-committer`` track.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ENABLED", "RING_CAPACITY", "SAMPLE_EVERY", "STAGES",
           "WINDOW_SPANS",
           "TraceCtx", "enable", "disable", "enabled", "reset", "evt",
           "events", "mint", "mint_cause", "sample", "set_flight_hook",
           "ticket_stages", "wal_accum_reset", "wal_accum_add",
           "wal_accum_take"]

#: hot-path gate — read directly (``if trace.ENABLED:``) at every
#: instrumentation site; never wrapped in a function call
ENABLED = False

from reflow_tpu_torch.utils.config import env_flag, env_int

RING_CAPACITY = env_int("REFLOW_TRACE_RING")
SAMPLE_EVERY = max(1, env_int("REFLOW_TRACE_SAMPLE"))

#: the per-ticket stage names, in pipeline order
STAGES = ("admission", "coalesce", "sched_delay", "execute", "fsync",
          "resolve")

#: the aggregate spans of the window path, beside the per-ticket stages:
#: the executor's slot writes into the ingress queue (``queue_write``)
#: and the launches of one window (``device_dispatch``, ``kind``
#: "window"); the scheduler's ``tick_many`` (``fused`` and, on the pump's
#: staged path, ``staged``); the pump's ``window_stage``, ``pump_execute``
#: and ``window_retire``
WINDOW_SPANS = ("queue_write", "device_dispatch", "tick_many",
                "window_stage", "pump_execute", "window_retire")

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
    """Turn tracing on (idempotent)."""
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def reset() -> None:
    """Drop all buffered events and detach every thread's ring (they
    re-register lazily via a generation bump). Tests / bench baselines."""
    global _gen
    with _rings_lock:
        _gen += 1
        _rings.clear()


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
    (the recording thread's name is the default track)."""
    with _rings_lock:
        rings = list(_rings)
    return [(ev[3] or r.track, ev) for r in rings for ev in r.events()]


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
    point — when the ticket's LSN passed ``wal.wait_durable`` (equal to
    ``t_exec1`` on a non-durable scheduler, so the fsync stage collapses
    to zero). Boundaries are clamped into pipeline order so the stages
    tile ``[ctx.t0, t_res]`` exactly."""
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
