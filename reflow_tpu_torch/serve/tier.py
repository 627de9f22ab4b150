"""ServeTier: many named graphs behind one budget and one pump pool.

The port's copy of ``reflow_tpu/serve/tier.py``. Placement is over the
devices of each executor's kind (:func:`_placement_devices`): the CUDA
devices for a ``cuda`` executor, ``[cpu]`` for one on the CPU, so on one
card every tenant lands on ``cuda:0``. A graph's ``device_label`` is its
executor's device name (``"cuda:0"``, ``"cpu"``), never None: tenants on
one card are co-located, and the placement-aware pick counts that in
``device_collisions``. Every pool thread launches on the legacy default
stream, so one tenant's windows stay ordered whichever thread runs them.

One host serves many incremental graphs (per-tenant pagerank, tfidf,
knn …). Standalone ``IngestFrontend``\\ s give each graph a private pump
thread and a private byte budget — N graphs means N unmanaged threads
and no global memory bound. The tier multiplexes instead:

- **one** :class:`~reflow_tpu_torch.serve.budget.AdmissionBudget` spans every
  graph (global in-flight bytes), with per-graph ``floor_bytes``
  (guaranteed reservation — a hot tenant can never push a sibling below
  it) and ``ceiling_bytes`` (hard cap on one graph's usage);
- **one pump pool** of K threads pulls coalesced macro-tick work items
  from the per-graph ready set, picked by deficit-weighted round-robin
  on configured QoS ``weight``\\ s (:func:`dwrr_pick`): over time a
  ready graph receives service proportional to its weight, in units of
  rows served, regardless of how bursty its siblings are.

Single-owner invariant: a scheduler is only ever driven by one thread
at a time. Each graph carries an in-flight latch (the frontend's
``_executing`` flag); a latched graph is simply not ready, so its
macro-tick never interleaves with itself — the pool adds concurrency
ACROSS graphs, never within one.

Concurrency design — one shared lock: the tier's lock is *the* lock of
every registered frontend, every producer-wakeup condition, and the
budget. This is what makes cross-graph wakeups (graph A's commit frees
bytes graph B's producer is blocked on) deadlock-free by construction:
there is no second lock to order against. The pool holds the lock only
to pick/latch work; macro-tick execution runs unlocked.

Reuse, not fork: admission, dedup (``SourceCursor`` + mirror),
coalescing, ticket resolution, and crash semantics all live in the
ingest frontend — the tier injects its budget/lock/work-condition and
drives the frontend's external-pump surface (``_poll`` /
``_take_window`` / ``_run_window`` / ``_finish_window``). Durable
graphs keep their own WAL; the pool's window IS the group-commit
window (``DurableScheduler.tick_many`` → ``append_group``, one fsync
per macro-tick).

Failure isolation: a crash inside one graph's macro-tick
(``pool_window@<name>`` / ``pump_*@<name>`` seams) fails THAT graph —
its undecided tickets resolve :class:`PumpCrashed`, its bytes return
to the pool — and the worker thread survives to keep serving siblings.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from reflow_tpu_torch.executors.device_delta import devices_of
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.utils.runtime import named_lock
from reflow_tpu_torch.obs import trace as _trace

from .budget import AdmissionBudget
from .coalesce import CoalesceWindow
from .frontend import METRIC_WINDOW, IngestFrontend

__all__ = ["GraphConfig", "GraphHandle", "ServeTier", "dwrr_pick"]


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Per-graph QoS and admission knobs for :meth:`ServeTier.register`.

    ``weight`` is the DWRR service share (relative rows/s under
    contention). ``floor_bytes`` / ``ceiling_bytes`` are this graph's
    guaranteed / maximum slice of the tier's byte budget. ``policy`` /
    ``queue_batches`` / ``window`` are the frontend's backpressure
    policy, per-source depth bound, and coalescing window.
    ``admission`` keys the byte charge: ``"host"`` = payload bytes,
    ``"device"`` = ingress-queue slot bytes, ``"auto"`` = device iff
    the graph's executor advertises the mega-tick window path.

    ``placement`` / ``device`` bind the graph's executor to one
    device at register time, so K tenants run their windows on K cards
    concurrently instead of serializing on one: ``placement="spread"``
    round-robins over the devices of the executor's kind,
    ``placement="pin"`` (or just ``device=``) pins to the given
    ``torch.device`` / device index. ``"none"`` leaves the executor
    wherever it already runs.
    """

    weight: float = 1.0
    floor_bytes: int = 0
    ceiling_bytes: Optional[int] = None
    policy: str = "block"
    queue_batches: int = 256
    window: Optional[CoalesceWindow] = None
    crash: Optional[object] = None  # CrashInjector override (tests)
    admission: str = "auto"
    #: None | torch.device | int index into the devices of the
    #: executor's kind (implies "pin")
    device: Optional[object] = None
    placement: str = "none"  # "none" | "spread" | "pin"
    #: pipelined window depth for this graph's pump (None = the
    #: frontend's REFLOW_WINDOW_DEPTH default; 1 = serial windows)
    window_depth: Optional[int] = None


def _placement_devices(executor) -> list:
    """The devices ``placement`` chooses among for ``executor``: those
    of its device's kind, in index order."""
    return devices_of(executor.device.type)


def dwrr_pick(ready: List["GraphHandle"], quantum_rows: int,
              busy_devices: frozenset = frozenset()) -> "GraphHandle":
    """Deficit-weighted round-robin over the ready graphs.

    Each graph carries a rolling deficit in row units. When every ready
    graph is out of deficit, all of them are replenished by
    ``weight * quantum_rows``; the pick is the largest positive
    deficit, and the caller charges the rows actually served after the
    window runs. Long-run service among continuously-ready graphs is
    therefore proportional to weight, independent of burst shape; a
    graph that is rarely ready is never replenished in absentia, so it
    cannot hoard deficit and then monopolize the pool.

    ``busy_devices`` makes the pick placement-aware: among the
    positive-deficit candidates, graphs whose bound device currently
    has NO window in flight are preferred (largest deficit among them),
    so co-located tenants stop contending for a card while other cards
    idle. Deficit accounting is untouched — a deferred graph keeps its
    deficit and wins as soon as its device frees up, so long-run
    weighted fairness is preserved; only the service ORDER shifts. When
    every candidate's device is busy (or devices are untagged) the pick
    falls back to pure DWRR.
    """
    while all(h._deficit <= 0 for h in ready):
        for h in ready:
            h._deficit += h.config.weight * quantum_rows
    cands = [h for h in ready if h._deficit > 0]
    free = [h for h in cands
            if h.device_label is None
            or h.device_label not in busy_devices]
    return max(free or cands, key=lambda h: h._deficit)


class GraphHandle:
    """One registered graph: the producer-facing proxy plus the tier's
    per-graph scheduling state. Returned by :meth:`ServeTier.register`;
    ``submit`` / ``flush`` / ``drain`` forward to the underlying
    :class:`IngestFrontend` (``handle.frontend`` for everything else)."""

    def __init__(self, tier: "ServeTier", name: str,
                 frontend: IngestFrontend, config: GraphConfig):
        self.tier = tier
        self.name = name
        self.frontend = frontend
        self.config = config
        # -- pool scheduling state (under the tier lock) --
        self._deficit = 0.0
        #: when the graph's current ready stretch began (None while not
        #: ready / latched) — scheduling delay is sampled on pick
        self._ready_since: Optional[float] = None
        self.windows = 0
        self.rows_applied = 0
        #: windows that crashed THIS graph (the control plane's
        #: circuit-breaker input)
        self.crashes = 0
        self.sched_delay_s: Deque[float] = deque(maxlen=METRIC_WINDOW)

    @property
    def weight(self) -> float:
        return self.config.weight

    @property
    def device_label(self) -> Optional[str]:
        """Where this graph's windows execute: the executor's obs tag
        (``"cuda:0"``, ``"cpu"``; None for an executor without one)."""
        sched = getattr(self.frontend, "sched", None)
        return getattr(getattr(sched, "executor", None),
                       "device_label", None)

    def submit(self, source, batch, **kw):
        return self.frontend.submit(source, batch, **kw)

    def flush(self, timeout: Optional[float] = None) -> None:
        self.frontend.flush(timeout)

    def drain(self, source=None, **kw) -> int:
        return self.frontend.drain(source, **kw)

    def rebind(self, sched) -> None:
        """Failover re-point: revive this graph's (crashed) frontend
        over a NEW scheduler — normally a promoted replica's
        ``DurableScheduler``. The graph stays registered, producers keep
        this handle, and resubmissions of batches the dead leader never
        committed are re-admitted through the rebuilt dedup mirror
        (see ``IngestFrontend.revive``). The old scheduler is left to
        its owner — a fenced zombie may still be flailing at it."""
        self.frontend.revive(sched=sched)

    def __repr__(self) -> str:
        return (f"GraphHandle({self.name!r}, weight={self.config.weight}, "
                f"state={self.frontend._state!r})")


class ServeTier:
    """Host many named graphs on one admission budget and one pump pool.

    ``max_bytes``: the tier-wide in-flight payload budget shared by all
    graphs. ``pump_threads``: pool size K (macro-ticks of *different*
    graphs run concurrently; one graph is always single-owner).
    ``quantum_rows``: the DWRR replenish quantum. ``crash``: a
    ``CrashInjector`` for the pool seams (tests only).
    """

    def __init__(self, *, max_bytes: int = 256 << 20,
                 pump_threads: int = 2, quantum_rows: int = 4096,
                 crash=None):
        if pump_threads <= 0:
            raise ValueError(
                f"pump_threads must be positive, got {pump_threads}")
        self.quantum_rows = quantum_rows
        self._crash = crash
        self._lock = named_lock("serve.tier")
        #: the pool's (and every frontend's) work condition: producers
        #: notify on admit, workers notify on window finish
        self._work = threading.Condition(self._lock)
        self.budget = AdmissionBudget(max_bytes)
        self._graphs: Dict[str, GraphHandle] = {}
        self._closed = False
        #: round-robin cursor for placement="spread" registrations
        self._place_counter = 0
        # -- counters (utils.metrics.summarize_tier) --
        self.windows = 0
        self.pool_crashes = 0
        #: completed checkpoint_barrier() cuts (the barrier seq)
        self.barriers = 0
        #: picks whose graph's device already had a window in flight —
        #: the placement-aware DWRR tie-break could not avoid the
        #: contention (every positive-deficit candidate was co-located
        #: with busy hardware). trace_inspect's per-device breakdown
        #: shows the resulting skew.
        self.device_collisions = 0
        self._busy_s = 0.0
        self._metric_keys: List = []
        self._t0 = time.perf_counter()
        self.pump_threads = pump_threads
        # -- pool supervision state (under the tier lock) --
        #: how many live workers the pool SHOULD have; the supervisor
        #: (ensure_workers) respawns toward it, scale_pool retunes it
        self._target_threads = pump_threads
        #: workers asked to exit at their next loop top (scale-down)
        self._retiring = 0
        self._next_worker_id = 0
        self.worker_deaths = 0
        self.worker_respawns = 0
        self.last_worker_error: Optional[BaseException] = None
        self._threads: List[threading.Thread] = []
        with self._lock:
            for _ in range(pump_threads):
                self._spawn_worker_locked()

    # -- registry ----------------------------------------------------------

    def register(self, name: str, sched,
                 config: Optional[GraphConfig] = None) -> GraphHandle:
        """Host ``sched`` (Dirty- or DurableScheduler) as graph
        ``name``. The scheduler must not be driven directly from now
        until :meth:`unregister` — the pool owns it."""
        cfg = config if config is not None else GraphConfig()
        if cfg.weight <= 0:
            raise ValueError(
                f"QoS weight must be positive, got {cfg.weight} "
                f"for {name!r}")
        placement = cfg.placement
        if placement not in ("none", "spread", "pin"):
            raise ValueError(
                f"placement must be 'none', 'spread' or 'pin', got "
                f"{placement!r} for {name!r}")
        if cfg.device is not None and placement == "none":
            placement = "pin"  # device= alone means: pin to it
        if placement == "pin" and cfg.device is None:
            raise ValueError(
                f"placement='pin' needs device= for {name!r}")
        with self._lock:
            if self._closed:
                raise GraphError("tier is closed; register refused")
            if name in self._graphs:
                raise ValueError(f"graph {name!r} already registered")
            if placement != "none":
                ex = getattr(sched, "executor", None)
                if not hasattr(ex, "place"):
                    raise GraphError(
                        f"graph {name!r}: placement={placement!r} needs an "
                        f"executor with place() (CudaExecutor); "
                        f"{type(ex).__name__} has none")
                if placement == "spread":
                    devs = _placement_devices(ex)
                    dev = devs[self._place_counter % len(devs)]
                    self._place_counter += 1
                elif isinstance(cfg.device, int):
                    dev = _placement_devices(ex)[cfg.device]
                else:
                    dev = cfg.device
                ex.place(dev)
            share = self.budget.register(
                name, floor=cfg.floor_bytes, ceiling=cfg.ceiling_bytes)
            try:
                fe = IngestFrontend(
                    sched, policy=cfg.policy,
                    queue_batches=cfg.queue_batches, window=cfg.window,
                    crash=cfg.crash if cfg.crash is not None
                    else self._crash,
                    start=False, budget=share, lock=self._lock,
                    work=self._work, name=name,
                    admission=cfg.admission, depth=cfg.window_depth)
            except BaseException:
                self.budget.unregister(name)
                raise
            handle = GraphHandle(self, name, fe, cfg)
            self._graphs[name] = handle
            return handle

    def handle(self, name: str) -> GraphHandle:
        with self._lock:
            return self._graphs[name]

    def graphs(self) -> Dict[str, GraphHandle]:
        with self._lock:
            return dict(self._graphs)

    # -- lifecycle ---------------------------------------------------------

    def drain(self, name: str, source=None, **kw) -> int:
        """Quiesce one graph in place (flush its backlog, run the
        scheduler's deferred-fixpoint drain) without unregistering it —
        siblings keep ticking throughout. Returns the drain tick
        count."""
        return self.handle(name).drain(source, **kw)

    def checkpoint_barrier(self, saver, *, names: Optional[List[str]]
                           = None) -> Dict[str, object]:
        """Tier-wide checkpoint barrier: one consistent cut across all
        (or ``names``) graphs. Every frontend is paused — each quiesces
        at a macro-tick boundary, so each graph's cut is a whole-window
        horizon — and only once ALL of them are idle does
        ``saver(name, handle)`` run per graph against the frozen
        schedulers (a ``CheckpointChain.save``, a ``save_checkpoint``,
        a state probe — the tier does not care). Admission keeps
        queueing throughout; producers block at the budget, they are
        not failed. Resumes everything even when a saver raises.

        Returns ``{"barrier": seq, "horizons": {name: tick},
        "results": {name: saver result}}`` — the horizons are the
        per-graph macro-tick cut the chain manifests record, which is
        what makes cross-tenant restore consistent: every graph's
        checkpoint in one barrier observes a single quiesced tier."""
        with self._lock:
            if self._closed:
                raise GraphError("tier is closed; barrier refused")
            if names is None:
                handles = dict(self._graphs)
            else:
                handles = {n: self._graphs[n] for n in names}
            self.barriers += 1
            seq = self.barriers
        paused: List[GraphHandle] = []
        results: Dict[str, object] = {}
        t0 = time.perf_counter()
        try:
            for h in handles.values():
                h.frontend.pause()
                paused.append(h)
            horizons = {n: h.frontend.sched._tick
                        for n, h in handles.items()}
            for n, h in handles.items():
                results[n] = saver(n, h)
        finally:
            for h in paused:
                h.frontend.resume()
        if _trace.ENABLED:
            _trace.evt("checkpoint_barrier", t0,
                       time.perf_counter() - t0,
                       args={"barrier": seq,
                             "graphs": sorted(handles)})
        return {"barrier": seq, "horizons": horizons,
                "results": results}

    def unregister(self, name: str, *, flush: bool = True,
                   timeout: Optional[float] = None) -> GraphHandle:
        """Quiesce and remove one graph: admission stops, blocked
        producers are released with ``FrontendClosed``, the pool ticks
        out its backlog (``flush=True``) or its tickets fail
        (``flush=False``), the scheduler's WAL (if durable) is sealed,
        and its budget share returns to the pool. Siblings never stall:
        the pool keeps serving them while this graph drains."""
        with self._lock:
            h = self._graphs.get(name)
            if h is None:
                raise KeyError(f"no graph {name!r} registered")
        h.frontend.close(flush=flush, timeout=timeout)
        with self._lock:
            self._graphs.pop(name, None)
            self.budget.unregister(name)
        return h

    def close(self, *, flush: bool = True,
              timeout: Optional[float] = None) -> None:
        """Drain and unregister every graph, then stop the pool.
        Idempotent."""
        with self._lock:
            names = list(self._graphs)
        for n in names:
            try:
                self.unregister(n, flush=flush, timeout=timeout)
            except KeyError:
                pass  # a concurrent unregister won the race
        with self._lock:
            self._closed = True
            self._work.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"tier close() timed out after {timeout}s waiting "
                    f"for {t.name}")
        for reg, key in self._metric_keys:
            reg.unregister_source(key)
            reg.unregister_prefix(f"{key}.")
        self._metric_keys = []
        self.budget.unpublish_metrics()

    def __enter__(self) -> "ServeTier":
        return self

    def __exit__(self, *exc) -> None:
        self.close(flush=exc == (None, None, None))

    # -- metrics -----------------------------------------------------------

    def publish_metrics(self, registry=None, *, name: str = "tier"
                        ) -> str:
        """Register the tier's live summary (``summarize_tier``
        schema, every graph nested) plus shared-budget occupancy gauges
        as obs metric sources; unregistered at :meth:`close`. Returns
        the source key."""
        from reflow_tpu_torch.obs import REGISTRY
        from reflow_tpu_torch.utils.metrics import summarize_tier
        reg = registry if registry is not None else REGISTRY
        reg.register_source(name,
                            lambda: summarize_tier(self).to_dict())
        reg.gauge(f"{name}.pump_utilization",
                  lambda: self.pump_utilization)
        reg.gauge(f"{name}.budget_used_bytes", lambda: self.budget.used)
        reg.gauge(f"{name}.budget_occupancy",
                  lambda: self.budget.used / self.budget.total_bytes)
        reg.gauge(f"{name}.live_workers", lambda: self.live_workers)
        reg.gauge(f"{name}.worker_deaths", lambda: self.worker_deaths)
        reg.gauge(f"{name}.device_collisions",
                  lambda: self.device_collisions)
        self._metric_keys.append((reg, name))
        return name

    @property
    def pump_utilization(self) -> float:
        """Busy-fraction of the pool since construction: macro-tick
        seconds / (threads x wall seconds)."""
        elapsed = time.perf_counter() - self._t0
        if elapsed <= 0:
            return 0.0
        return self._busy_s / (self.pump_threads * elapsed)

    # -- pool supervision / elasticity -------------------------------------

    def _spawn_worker_locked(self) -> None:
        t = threading.Thread(
            target=self._pool_loop,
            name=f"reflow-tier-pump-{self._next_worker_id}", daemon=True)
        self._next_worker_id += 1
        self._threads.append(t)
        t.start()

    def _reap_locked(self) -> None:
        self._threads = [t for t in self._threads if t.is_alive()]

    @property
    def live_workers(self) -> int:
        """Pool workers currently alive (dead ones are respawned by
        :meth:`ensure_workers`; retirees from a scale-down exit at their
        next loop top)."""
        return sum(1 for t in self._threads if t.is_alive())

    def ensure_workers(self) -> int:
        """Respawn dead pool workers back to the target size — the
        supervision seam the control plane ticks. A worker that dies
        (a bug escaping the per-window isolation, a deliberate
        ``pool_worker@*`` seam) would otherwise shrink effective
        parallelism for the life of the tier. Returns how many workers
        were spawned (0 = pool already at target)."""
        with self._lock:
            if self._closed:
                return 0
            self._reap_locked()
            spawned = 0
            while (len(self._threads) - self._retiring
                   < self._target_threads):
                self._spawn_worker_locked()
                spawned += 1
            self.worker_respawns += spawned
            return spawned

    def scale_pool(self, target: int) -> int:
        """Retune the pool to ``target`` workers — the autoscaling
        actuator. Growing spawns immediately; shrinking marks the excess
        to retire at their next loop top (never mid-window). Clamped to
        at least 1. Returns the new target."""
        with self._lock:
            if self._closed:
                return self._target_threads
            target = max(1, int(target))
            self._target_threads = target
            self.pump_threads = target  # utilization denominator
            self._reap_locked()
            planned = len(self._threads) - self._retiring
            if planned < target:
                for _ in range(target - planned):
                    self._spawn_worker_locked()
            elif planned > target:
                self._retiring += planned - target
                self._work.notify_all()  # idle workers retire in wait()
            return target

    @property
    def ready_depth(self) -> int:
        """How many graphs have a fireable window RIGHT NOW (the
        autoscaler's backlog signal; racy-but-fine telemetry)."""
        with self._lock:
            now = time.perf_counter()
            return sum(1 for h in self._graphs.values()
                       if h.frontend._poll(now)[0])

    # -- the pool ----------------------------------------------------------

    def _pool_loop(self) -> None:
        # worker death (anything escaping _pool_iteration, including
        # the per-window isolation handler itself failing) is recorded
        # so the supervisor can respawn back to target — a silent exit
        # here is the pool-capacity leak
        try:
            while self._pool_iteration():
                pass
        except BaseException as e:  # noqa: BLE001 - supervision boundary
            with self._lock:
                self.worker_deaths += 1
                self.last_worker_error = e
                self._work.notify_all()

    def _pool_iteration(self) -> bool:
        # one pick + macro-tick (or one settle-only pass over a graph
        # with retired work pending); False = exit this worker
        with self._lock:
            picked = None
            settle_h: Optional[GraphHandle] = None
            while picked is None:
                if self._closed:
                    return False
                if self._retiring > 0:
                    self._retiring -= 1
                    return False
                now = time.perf_counter()
                ready: List[GraphHandle] = []
                wait_t: Optional[float] = None
                for h in self._graphs.values():
                    fire, w = h.frontend._poll(now)
                    if fire:
                        if h._ready_since is None:
                            h._ready_since = now
                        ready.append(h)
                    else:
                        # not ready (or latched by a sibling
                        # worker): the ready stretch is over
                        h._ready_since = None
                        if w is not None:
                            wait_t = (w if wait_t is None
                                      else min(wait_t, w))
                if ready:
                    # placement-aware tie-break: devices with a window
                    # (or unretired pipeline) in flight are "busy" —
                    # prefer candidates whose card is idle
                    busy = frozenset(
                        h.device_label for h in self._graphs.values()
                        if h.device_label is not None
                        and (h.frontend._executing
                             or h.frontend._inflight))
                    picked = dwrr_pick(ready, self.quantum_rows, busy)
                    if (picked.device_label is not None
                            and picked.device_label in busy):
                        self.device_collisions += 1
                    ready_since = picked._ready_since
                    picked.sched_delay_s.append(now - ready_since)
                    picked._ready_since = None
                    if _trace.ENABLED:
                        _trace.evt("pool_pick", ready_since,
                                   now - ready_since,
                                   args={"graph": picked.name,
                                         "device": picked.device_label})
                    drained = picked.frontend._take_window(
                        ready_since=ready_since)
                else:
                    # nothing fireable: retire any graph's dispatched-
                    # but-unsettled pipelined windows (their tickets
                    # wire to the durable watermark here, and pause/
                    # close waiters unblock)
                    settle_h = next(
                        (h for h in self._graphs.values()
                         if h.frontend._needs_settle()), None)
                    if settle_h is not None:
                        settle_h.frontend._begin_settle()
                        break
                    self._work.wait(timeout=wait_t)
        if settle_h is not None:
            t0 = time.perf_counter()
            crashed = False
            try:
                settle_h.frontend._settle_all()
            except BaseException as e:  # noqa: BLE001 - fault isolation
                crashed = True
                # count the crash BEFORE tickets fail: an observer who
                # caught a PumpCrashed result must already see it
                with self._lock:
                    self.pool_crashes += 1
                    settle_h.crashes += 1
                settle_h.frontend._on_pump_crash(e)
            with self._lock:
                self._busy_s += time.perf_counter() - t0
                if not crashed:
                    settle_h.frontend._finish_window()
                self._work.notify_all()
            return True
        # -- macro-tick, unlocked (single-owner: the latch set by
        # _take_window keeps every other worker off this graph) --
        t0 = time.perf_counter()
        crashed = False
        try:
            if self._crash is not None:
                self._crash.point(f"pool_window@{picked.name}")
            picked.frontend._run_window(drained)
        except BaseException as e:  # noqa: BLE001 - fault isolation
            crashed = True
            # count the crash BEFORE tickets fail: an observer who
            # caught a PumpCrashed result must already see it
            with self._lock:
                self.pool_crashes += 1
                picked.crashes += 1
            picked.frontend._on_pump_crash(e, window=drained)
            # _on_pump_crash released the latch, the graph's bytes,
            # and its blocked producers
        busy = time.perf_counter() - t0
        rows = sum(e.rows for entries in drained.values()
                   for e in entries)
        with self._lock:
            self._busy_s += busy
            self.windows += 1
            picked.windows += 1
            picked._deficit -= max(rows, 1)
            if not crashed:
                picked.rows_applied += rows
                picked.frontend._finish_window()
            # re-evaluate readiness pool-wide: the just-unlatched
            # graph may have accrued backlog, and idle workers only
            # wake on notify
            self._work.notify_all()
        # deliberate WORKER-death seam (vs pool_window@, which crashes
        # the graph): fires between windows, after the graph is settled,
        # so the only casualty is this thread — exactly the capacity
        # leak the supervisor exists to heal
        if self._crash is not None:
            self._crash.point(f"pool_worker@{picked.name}")
        return True
