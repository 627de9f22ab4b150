"""Self-healing control plane: the actuator loop over the obs gauges.

The port's copy of ``reflow_tpu/serve/control.py``.

The serving tier is instrumented end to end — pump utilization,
per-graph sched-delay p99, shared-budget occupancy, ``wal.queue_depth``
/ ``wal.durable_lag_s`` — but without this module nothing *acts* on the
signals: a hot tenant could pin the tier at its admission ceiling
forever, a crashed pump worker would silently shrink pool parallelism
for the life of the process, and a dead WAL committer would poison
every later append. This
module closes the loop. A :class:`ControlPlane` samples those gauges on
a fixed interval and drives three actuator families against the tier:

**Graceful overload degradation** — each graph gets an :class:`SLOSpec`
(sched-delay p99, durable lag, budget occupancy; ``None`` thresholds
are skipped). On ``breach_intervals`` consecutive breached samples the
controller steps THAT graph down a brownout ladder of admission
policies (configured policy → ``"reject"`` → ``"shed-oldest"``), and
steps back up one rung per ``recover_intervals`` consecutive clean
samples (hysteresis — a flapping gauge can't oscillate the policy). A
hot-tenant surge therefore degrades the surging tenant while quiet
siblings keep their configured admission behavior; QoS-selective
shedding falls out of the per-graph specs (give high-QoS graphs no
spec, an empty ladder, or set ``ControlConfig.protect_weight``).

**Supervision and self-healing** — a graph whose window crashed
(``PumpCrashed``; frontend state ``"failed"``) is revived with
exponential backoff plus jitter, behind a per-graph crash-storm
circuit breaker: K crashes inside a sliding window opens the breaker
(the graph stays quarantined, submissions fail fast), a cooldown later
a half-open probe revives it once, and only a probe that stays healthy
for ``probe_intervals`` samples closes the breaker again (a probe
crash re-opens it with a doubled cooldown). A dead WAL committer under
a still-running durable graph is respawned via
``WriteAheadLog.restart_committer()`` at most
``max_committer_restarts`` times — after that the graph fails fast
instead of looping. Dead pool *workers* (the capacity leak) are
respawned every tick via ``ServeTier.ensure_workers()``.

**Elasticity and rebalancing** — an :class:`Autoscaler` grows the pump
pool on sustained ready-graph backlog exceeding the live worker count
and shrinks it on sustained idle, clamped to ``[min_workers,
max_workers]``; idle-graph budget reclaim shrinks a quiet graph's floor
to the bytes it actually holds (returning the reservation tier-wide,
under the shared budget lock) and restores the configured floor the
moment traffic returns.

Design for testability: every policy lives in a standalone state
machine (:class:`BrownoutLadder`, :class:`CircuitBreaker`,
:class:`Autoscaler`) driven by plain ``observe``/``poll`` calls, and
:class:`ControlPlane.step` takes an explicit ``now`` plus an injectable
``sampler``/``clock``/``rng`` — the state-machine tests run on a fake
clock with injected gauge sequences, no sleeps anywhere.

Lock discipline: actuation (policy flips, budget resizes) happens under
the tier lock; WAL calls (``durable_lag_s``, ``restart_committer``)
happen with the tier lock RELEASED, because the committer thread takes
the tier lock while holding the WAL lock (durable callbacks resolve
tickets), so the reverse order here would deadlock.

Observability of the observer: the loop publishes ``control.*`` action
counters (brownouts entered/exited, respawns, breaker opens/closes,
scale events, reclaims) and a ``pool.live_workers`` gauge through the
same :class:`MetricsRegistry`, and emits ``control.<action>`` trace
spans when tracing is enabled — ``tools/trace_inspect.py`` surfaces
them alongside the data-path spans.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.utils.metrics import percentile

from .frontend import POLICIES

__all__ = ["SLOSpec", "BrownoutLadder", "CircuitBreaker", "Autoscaler",
           "ControlConfig", "ControlPlane", "load_slo_specs"]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One graph's service-level objective and its brownout ladder.

    A threshold of ``None`` skips that signal. ``breach_intervals``
    consecutive breached control samples step the graph DOWN one rung
    of ``ladder``; ``recover_intervals`` consecutive clean samples step
    it back UP one rung (each rung of recovery needs a full clean
    streak — the hysteresis that keeps a borderline gauge from
    flapping the policy). The ladder rungs are admission policies
    applied in order after the graph's configured policy.
    """

    #: cross-graph scheduling delay bound (s): time a ready window
    #: waited for a pool thread, p99 over the metric window
    sched_delay_p99_s: Optional[float] = None
    #: age bound (s) on the oldest pending durability request
    durable_lag_s: Optional[float] = None
    #: bound on the graph's share usage / its byte cap (0..1)
    budget_occupancy: Optional[float] = None
    breach_intervals: int = 3
    recover_intervals: int = 5
    ladder: Tuple[str, ...] = ("reject", "shed-oldest")

    def __post_init__(self):
        for p in self.ladder:
            if p not in POLICIES:
                raise ValueError(
                    f"ladder policy {p!r} not in {POLICIES}")
        if self.breach_intervals <= 0 or self.recover_intervals <= 0:
            raise ValueError("breach/recover intervals must be >= 1")

    def breached(self, info: Dict) -> bool:
        """Does one control sample (a per-graph gauge dict) breach this
        SLO? Missing keys read as healthy."""
        if (self.sched_delay_p99_s is not None
                and info.get("sched_delay_p99_s", 0.0)
                > self.sched_delay_p99_s):
            return True
        if (self.durable_lag_s is not None
                and info.get("durable_lag_s", 0.0) > self.durable_lag_s):
            return True
        if (self.budget_occupancy is not None
                and info.get("occupancy", 0.0) > self.budget_occupancy):
            return True
        return False


def load_slo_specs(path: str) -> Dict[str, SLOSpec]:
    """Parse per-graph :class:`SLOSpec`s from a JSON config file so
    operators can retune brownout ladders without code::

        {"default_slo": {"sched_delay_p99_s": 0.5},
         "specs": {"hot-tenant": {"budget_occupancy": 0.9,
                                  "ladder": ["reject", "shed-oldest"],
                                  "breach_intervals": 2}}}

    ``default_slo`` (optional) supplies field defaults every spec
    inherits; each entry under ``specs`` overrides per graph. Unknown
    fields and invalid ladder policies fail loudly — a typo'd config
    must not silently disable an SLO."""
    import json

    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: SLO config must be a JSON object")
    unknown = set(raw) - {"specs", "default_slo"}
    if unknown:
        raise ValueError(f"{path}: unknown top-level keys {sorted(unknown)}")
    fields = {f.name for f in dataclasses.fields(SLOSpec)}

    def build(name: str, entry: Dict) -> SLOSpec:
        if not isinstance(entry, dict):
            raise ValueError(f"{path}: spec {name!r} must be an object")
        bad = set(entry) - fields
        if bad:
            raise ValueError(f"{path}: spec {name!r} has unknown "
                             f"fields {sorted(bad)} (valid: "
                             f"{sorted(fields)})")
        merged = dict(raw.get("default_slo") or {})
        merged.update(entry)
        if "ladder" in merged:
            merged["ladder"] = tuple(merged["ladder"])
        return SLOSpec(**merged)

    if raw.get("default_slo"):
        bad = set(raw["default_slo"]) - fields
        if bad:
            raise ValueError(f"{path}: default_slo has unknown fields "
                             f"{sorted(bad)}")
    return {name: build(name, entry)
            for name, entry in (raw.get("specs") or {}).items()}


class BrownoutLadder:
    """Per-graph brownout state machine: level 0 is the configured
    policy, level i>0 is ``ladder[i-1]``. Driven by one
    :meth:`observe` per control interval; returns the new policy
    string when (and only when) the level changed."""

    def __init__(self, base_policy: str,
                 ladder: Tuple[str, ...] = ("reject", "shed-oldest"),
                 *, breach_intervals: int = 3, recover_intervals: int = 5):
        # duplicate rungs (e.g. a base policy already in the ladder)
        # collapse — stepping "down" to the same policy is a no-op rung
        levels: List[str] = [base_policy]
        for p in ladder:
            if p not in levels:
                levels.append(p)
        self.levels: Tuple[str, ...] = tuple(levels)
        self.breach_intervals = breach_intervals
        self.recover_intervals = recover_intervals
        self.level = 0
        self._breach_streak = 0
        self._ok_streak = 0

    @property
    def policy(self) -> str:
        return self.levels[self.level]

    def observe(self, breached: bool) -> Optional[str]:
        """Feed one interval's breach verdict; returns the policy to
        actuate when the level moved, else None."""
        if breached:
            self._ok_streak = 0
            self._breach_streak += 1
            if (self._breach_streak >= self.breach_intervals
                    and self.level < len(self.levels) - 1):
                self.level += 1
                self._breach_streak = 0
                return self.levels[self.level]
            return None
        self._breach_streak = 0
        if self.level == 0:
            self._ok_streak = 0
            return None
        self._ok_streak += 1
        if self._ok_streak >= self.recover_intervals:
            self.level -= 1
            self._ok_streak = 0  # next rung up needs a fresh streak
            return self.levels[self.level]
        return None


class CircuitBreaker:
    """Crash-storm breaker + respawn backoff for one graph.

    States: ``"closed"`` (normal; each crash schedules a revive after
    an exponentially-backed-off, jittered delay) → ``"open"`` (K
    crashes inside ``window_s``: quarantined, submissions fail fast,
    no revives) → ``"half_open"`` (cooldown elapsed: ONE probe revive)
    → ``"closed"`` again once the probe stays healthy for
    ``probe_intervals`` polls; a crash while half-open re-opens with a
    doubled (capped) cooldown. Pure state machine: callers feed
    :meth:`record_crash` on observed crashes and :meth:`poll` once per
    control interval, acting on the returned verdicts.
    """

    def __init__(self, *, max_crashes: int = 3, window_s: float = 10.0,
                 backoff_s: float = 0.05, backoff_max_s: float = 2.0,
                 cooldown_s: float = 0.5, cooldown_max_s: float = 8.0,
                 probe_intervals: int = 2, jitter_frac: float = 0.2,
                 rng: Optional[Callable[[], float]] = None):
        if max_crashes <= 0:
            raise ValueError("max_crashes must be >= 1")
        self.max_crashes = max_crashes
        self.window_s = window_s
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.cooldown_base_s = cooldown_s
        self.cooldown_max_s = cooldown_max_s
        self.probe_intervals = probe_intervals
        self.jitter_frac = jitter_frac
        self._rng = rng if rng is not None else random.random
        self.state = "closed"
        self.crashes = 0
        self.opens = 0
        self._crash_times: Deque[float] = deque()
        self._respawn_at: Optional[float] = None
        self._consecutive_respawns = 0
        self._opened_at: Optional[float] = None
        self._cooldown = cooldown_s
        self._healthy_polls = 0

    def respawn_delay(self) -> float:
        """The backoff the NEXT closed-state respawn would use (before
        jitter): exponential in respawns since the last confirmed
        healthy stretch, capped."""
        return min(self.backoff_s * (2 ** self._consecutive_respawns),
                   self.backoff_max_s)

    def record_crash(self, now: float) -> str:
        """Feed one observed crash; returns the resulting state."""
        self.crashes += 1
        self._crash_times.append(now)
        while (self._crash_times
               and now - self._crash_times[0] > self.window_s):
            self._crash_times.popleft()
        self._healthy_polls = 0
        if self.state == "half_open":
            # the probe itself crashed: back off harder
            self.state = "open"
            self.opens += 1
            self._opened_at = now
            self._cooldown = min(self._cooldown * 2, self.cooldown_max_s)
            self._respawn_at = None
            return self.state
        if len(self._crash_times) >= self.max_crashes:
            self.state = "open"
            self.opens += 1
            self._opened_at = now
            self._respawn_at = None
            return self.state
        # closed, storm threshold not reached: schedule a backed-off,
        # jittered revive
        delay = self.respawn_delay()
        delay *= 1.0 + self.jitter_frac * self._rng()
        self._consecutive_respawns += 1
        self._respawn_at = now + delay
        return self.state

    def poll(self, now: float, *, healthy: bool) -> Optional[str]:
        """One control interval; ``healthy`` is whether the graph is
        currently running. Returns an action verdict:

        - ``"respawn"`` — closed-state backoff elapsed, revive now;
        - ``"probe"`` — cooldown elapsed, transitioned to half-open,
          revive ONCE as the probe;
        - ``"close"`` — the probe proved out, breaker closed (reset);
        - ``None`` — nothing to do this interval.
        """
        if self.state == "closed":
            if not healthy:
                if (self._respawn_at is not None
                        and now >= self._respawn_at):
                    self._respawn_at = None
                    return "respawn"
                return None
            self._healthy_polls += 1
            if self._healthy_polls >= self.probe_intervals:
                self._consecutive_respawns = 0  # backoff resets
            return None
        if self.state == "open":
            if now - self._opened_at >= self._cooldown:
                self.state = "half_open"
                self._healthy_polls = 0
                return "probe"
            return None
        # half_open: the probe revive happened; wait for it to prove out
        # (a crash arrives via record_crash and re-opens)
        if not healthy:
            return None
        self._healthy_polls += 1
        if self._healthy_polls >= self.probe_intervals:
            self.state = "closed"
            self._cooldown = self.cooldown_base_s
            self._consecutive_respawns = 0
            self._crash_times.clear()
            return "close"
        return None


class Autoscaler:
    """Pump-pool sizing policy: grow one worker after
    ``grow_intervals`` consecutive samples with more ready graphs than
    live workers; shrink one after ``shrink_intervals`` consecutive
    fully-idle samples; always clamp into ``[min_workers,
    max_workers]`` (an out-of-range live count returns a clamping
    target immediately). Returns the new target, or None to hold."""

    def __init__(self, *, min_workers: int = 1, max_workers: int = 8,
                 grow_intervals: int = 3, shrink_intervals: int = 10):
        if not 1 <= min_workers <= max_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"[{min_workers}, {max_workers}]")
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.grow_intervals = grow_intervals
        self.shrink_intervals = shrink_intervals
        self._backlog_streak = 0
        self._idle_streak = 0

    def observe(self, ready_depth: int, live: int) -> Optional[int]:
        if live < self.min_workers:
            self._backlog_streak = self._idle_streak = 0
            return self.min_workers
        if live > self.max_workers:
            self._backlog_streak = self._idle_streak = 0
            return self.max_workers
        if ready_depth > live:
            self._idle_streak = 0
            self._backlog_streak += 1
            if self._backlog_streak >= self.grow_intervals:
                self._backlog_streak = 0
                if live < self.max_workers:
                    return live + 1
            return None
        self._backlog_streak = 0
        if ready_depth == 0:
            self._idle_streak += 1
            if self._idle_streak >= self.shrink_intervals:
                self._idle_streak = 0
                if live > self.min_workers:
                    return live - 1
            return None
        self._idle_streak = 0
        return None


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Tuning knobs for :class:`ControlPlane` (see docs/guide.md
    "Control plane" for the operator's view)."""

    #: control sample/actuation period (the loop thread's tick)
    interval_s: float = 0.05
    #: SLO applied to graphs without an explicit spec (None = none)
    default_slo: Optional[SLOSpec] = None
    #: graphs with QoS weight >= this are never browned out, even under
    #: default_slo (QoS-protected tenants); None disables the carve-out
    protect_weight: Optional[float] = None
    # -- supervision --
    #: master switch for crash revives (breaker still tracks crashes)
    respawn: bool = True
    max_crashes: int = 3
    crash_window_s: float = 10.0
    respawn_backoff_s: float = 0.05
    respawn_backoff_max_s: float = 2.0
    breaker_cooldown_s: float = 0.5
    breaker_cooldown_max_s: float = 8.0
    probe_intervals: int = 2
    jitter_frac: float = 0.2
    #: dead-WAL-committer respawn budget per graph; exhausted = the
    #: graph fails fast instead of looping (respawn-or-fail-fast)
    max_committer_restarts: int = 3
    #: dead-WAL-compactor respawn budget (same respawn-or-fail-fast
    #: stance: a compactor that keeps dying has hit real corruption,
    #: and the log is merely unbounded without it, never wrong)
    max_compactor_restarts: int = 3
    # -- elasticity --
    #: pump-pool autoscale range; None disables autoscaling
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None
    grow_intervals: int = 3
    shrink_intervals: int = 10
    #: consecutive idle intervals before a quiet graph's budget floor
    #: is reclaimed tier-wide (0 disables)
    reclaim_idle_intervals: int = 0
    # -- subscription shedding (ControlPlane(subs=hub)) --
    #: queued fan-out windows above which subscription fan-out counts
    #: as breaching (the hub is falling behind the apply path); None
    #: disables the backlog signal
    sub_backlog_windows_max: Optional[int] = 8
    #: slowest-subscriber lag (ticks behind the fan-out horizon) above
    #: which fan-out counts as breaching; None disables the lag signal
    sub_lag_windows_max: Optional[int] = None
    #: consecutive breached/recovered intervals before the subs ladder
    #: steps (conflate -> pause) or relaxes
    sub_breach_intervals: int = 3
    sub_recover_intervals: int = 5


class _GraphControl:
    """Per-graph controller state (ladder + breaker + reclaim/committer
    bookkeeping), keyed by handle identity so an unregister/re-register
    under the same name starts fresh."""

    __slots__ = ("handle", "spec", "ladder", "breaker", "last_state",
                 "committer_restarts_used", "reclaimed", "idle_streak",
                 "windows_last")

    def __init__(self, handle, spec: Optional[SLOSpec],
                 cfg: ControlConfig, rng: Callable[[], float]):
        self.handle = handle
        self.spec = spec
        self.ladder = None
        if spec is not None and spec.ladder:
            self.ladder = BrownoutLadder(
                handle.config.policy, spec.ladder,
                breach_intervals=spec.breach_intervals,
                recover_intervals=spec.recover_intervals)
        self.breaker = CircuitBreaker(
            max_crashes=cfg.max_crashes, window_s=cfg.crash_window_s,
            backoff_s=cfg.respawn_backoff_s,
            backoff_max_s=cfg.respawn_backoff_max_s,
            cooldown_s=cfg.breaker_cooldown_s,
            cooldown_max_s=cfg.breaker_cooldown_max_s,
            probe_intervals=cfg.probe_intervals,
            jitter_frac=cfg.jitter_frac, rng=rng)
        self.last_state = "running"
        self.committer_restarts_used = 0
        self.reclaimed = False
        self.idle_streak = 0
        self.windows_last = 0


class ControlPlane:
    """The supervision thread: sample → decide → actuate, once per
    ``config.interval_s``. Construct over a live :class:`ServeTier`,
    optionally with per-graph ``specs``; ``start()`` spawns the daemon
    loop (or drive :meth:`step` by hand — tests and benches do).

    ``sampler``/``clock``/``rng`` are injectable for determinism: the
    sampler returns the gauge dict :meth:`_default_sample` would
    (``{"graphs": {name: {...}}, "ready_depth": int, "live_workers":
    int}``), the clock feeds every state machine, the rng drives
    respawn jitter.
    """

    def __init__(self, tier, *, specs: Optional[Dict[str, SLOSpec]] = None,
                 config: Optional[ControlConfig] = None,
                 config_path: Optional[str] = None, registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[Callable[[], float]] = None,
                 sampler: Optional[Callable[[float], Dict]] = None,
                 failover=None, compactor=None, fleet=None, subs=None):
        from reflow_tpu_torch.obs import REGISTRY
        self.tier = tier
        #: optional serve.failover.FailoverCoordinator, stepped on the
        #: control interval — leader-death detection and promotion ride
        #: the same supervision loop as the other actuators
        self.failover = failover
        #: optional wal.compact.WalCompactor, supervised on the control
        #: interval with the committer's respawn-or-fail-fast budget
        self.compactor = compactor
        #: optional obs.fleet.FleetAggregator: fleet gauges consulted
        #: on the control interval. Advisory only — a lag-spread breach
        #: is surfaced as an action + counter, never actuated, because
        #: telemetry is allowed to be stale or absent (the inversion
        #: the fleet plane is built on)
        self.fleet = fleet
        self._fleet_breached = False
        #: optional subs.hub.SubscriptionHub: subscription fan-out is
        #: the one read-side load the control plane actuates, because
        #: it shares the replica process with the apply path — the
        #: shedding ladder degrades push freshness (conflate, then
        #: pause) before write-path SLOs breach
        self.subs = subs
        self._compactor_restarts_used = 0
        self._compactor_failed = False
        self._compactor_booted = False
        # file first, explicit specs= override per graph — an operator
        # config sets the fleet default, code pins the exceptions
        self.specs = (dict(load_slo_specs(config_path))
                      if config_path is not None else {})
        if specs:
            self.specs.update(specs)
        self.config = config if config is not None else ControlConfig()
        self.registry = registry if registry is not None else REGISTRY
        self._clock = clock
        self._rng = rng if rng is not None else random.random
        self._sampler = sampler
        self._ctl: Dict[str, _GraphControl] = {}
        self._autoscaler: Optional[Autoscaler] = None
        if (self.config.min_workers is not None
                or self.config.max_workers is not None):
            lo = self.config.min_workers or 1
            hi = self.config.max_workers or max(lo, tier.pump_threads)
            self._autoscaler = Autoscaler(
                min_workers=lo, max_workers=hi,
                grow_intervals=self.config.grow_intervals,
                shrink_intervals=self.config.shrink_intervals)
        self.ticks = 0
        self.errors = 0
        self.last_error: Optional[BaseException] = None
        #: recent actuations (dicts: now/kind/graph), for tests/benches
        self.actions: Deque[Dict] = deque(maxlen=1024)
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sub_ladder = (BrownoutLadder(
            "normal", ("conflate", "pause"),
            breach_intervals=self.config.sub_breach_intervals,
            recover_intervals=self.config.sub_recover_intervals)
            if subs is not None else None)
        reg = self.registry
        self._c = {k: reg.counter(f"control.{k}") for k in (
            "ticks", "brownouts_entered", "brownouts_exited",
            "brownout_steps", "respawns", "breaker_opens",
            "breaker_probes", "breaker_closes", "worker_respawns",
            "committer_restarts", "scale_ups", "scale_downs",
            "reclaims", "floor_restores", "errors",
            "compactions", "compactor_restarts",
            "fleet_lag_breaches", "sub_shed_steps",
            "sub_shed_recovers")}
        reg.gauge("pool.live_workers", lambda: self.tier.live_workers)
        reg.gauge("control.interval_s", lambda: self.config.interval_s)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ControlPlane":
        if self._thread is not None:
            return self
        self._stop_ev.clear()
        self._thread = threading.Thread(
            target=self._loop, name="reflow-control", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_ev.wait(self.config.interval_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 - loop must survive
                self.errors += 1
                self.last_error = e
                self._c["errors"].inc()

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.registry.unregister_prefix("control.")
        self.registry.unregister_prefix("pool.")

    def __enter__(self) -> "ControlPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- introspection (tests/benches) -------------------------------------

    def level(self, name: str) -> int:
        """Current brownout rung for graph ``name`` (0 = configured
        policy; no ladder reads as 0)."""
        ctl = self._ctl.get(name)
        if ctl is None or ctl.ladder is None:
            return 0
        return ctl.ladder.level

    def breaker_state(self, name: str) -> str:
        ctl = self._ctl.get(name)
        return "closed" if ctl is None else ctl.breaker.state

    @property
    def sub_shed_level(self) -> int:
        """Current subscription shedding rung (0 normal, 1 conflate,
        2 pause); 0 when no hub is attached."""
        return 0 if self._sub_ladder is None else self._sub_ladder.level

    # -- the control loop --------------------------------------------------

    def step(self, now: Optional[float] = None) -> List[Dict]:
        """One sample → decide → actuate pass; returns this tick's
        actions. Thread-driven in production; called directly (with an
        explicit fake ``now``) by tests and benches."""
        now = self._clock() if now is None else now
        if self.tier._closed:
            return []
        sample = (self._sampler(now) if self._sampler is not None
                  else self._default_sample())
        self.ticks += 1
        self._c["ticks"].inc()
        actions: List[Dict] = []
        handles = self.tier.graphs()
        # controller GC: drop graphs that left; a same-name re-register
        # is a different handle and starts with fresh machines
        for name in list(self._ctl):
            if self._ctl[name].handle is not handles.get(name):
                del self._ctl[name]
        for name, info in sample.get("graphs", {}).items():
            h = handles.get(name)
            if h is None:
                continue
            ctl = self._ctl.get(name)
            if ctl is None:
                ctl = self._ctl[name] = _GraphControl(
                    h, self._spec_for(h), self.config, self._rng)
            self._step_brownout(now, name, ctl, info, actions)
            self._step_supervision(now, name, ctl, info, actions)
            self._step_reclaim(now, name, ctl, info, actions)
        self._step_pool(now, sample, actions)
        if self.failover is not None:
            actions.extend(self.failover.step(now))
        if self.compactor is not None:
            self._step_compactor(now, actions)
        if self.fleet is not None:
            self._step_fleet(now, actions)
        if self.subs is not None:
            self._step_subs(now, actions)
        for a in actions:
            self._record(a)
        return actions

    def _step_fleet(self, now: float, actions: List[Dict]) -> None:
        """Consult the fleet aggregator's cross-node gauges. A lag
        spread past the aggregator's threshold raises an *advisory*
        action, edge-triggered (one per breach episode, one more on
        recovery) — the operator decides; this loop never actuates on
        telemetry that is allowed to be stale."""
        try:
            snap = self.fleet.fleet_snapshot()
        except Exception:  # noqa: BLE001 - telemetry loss is tolerated
            return
        gauges = snap.get("gauges", {})
        spread = gauges.get("lag_spread")
        limit = getattr(self.fleet, "lag_spread_max", None)
        breached = (spread is not None and limit is not None
                    and spread > limit)
        if breached and not self._fleet_breached:
            self._c["fleet_lag_breaches"].inc()
            actions.append({"now": now, "kind": "fleet_lag_spread",
                            "advisory": True,
                            "lag_spread": spread, "limit": limit,
                            "stale_nodes": gauges.get("nodes_stale", 0),
                            "alerts": list(snap.get("alerts", []))})
        elif self._fleet_breached and not breached:
            actions.append({"now": now, "kind": "fleet_lag_recovered",
                            "advisory": True, "lag_spread": spread})
        self._fleet_breached = breached

    def _step_subs(self, now: float, actions: List[Dict]) -> None:
        """Drive the subscription shedding ladder off the hub's own
        load signals (work-queue backlog, slowest-subscriber lag).
        Unlike the fleet hook this one actuates: fan-out shares the
        replica process with the apply path, so degrading push
        freshness — conflate (level 1), then pause (level 2) — is how
        write-path SLOs stay whole under subscriber overload. The
        ladder's hysteresis (breach/recover streaks) keeps it from
        flapping on one bursty window."""
        cfg = self.config
        if (cfg.sub_backlog_windows_max is None
                and cfg.sub_lag_windows_max is None):
            return
        try:
            load = self.subs.load()
        except Exception:  # noqa: BLE001 - a closing hub must not kill the control loop; next interval re-reads
            return
        backlog = load.get("backlog_windows") or 0
        lag = load.get("slowest_lag")
        breached = (
            (cfg.sub_backlog_windows_max is not None
             and backlog > cfg.sub_backlog_windows_max)
            or (cfg.sub_lag_windows_max is not None and lag is not None
                and lag > cfg.sub_lag_windows_max))
        before = self._sub_ladder.level
        moved = self._sub_ladder.observe(breached)
        if moved is None:
            return
        level = self._sub_ladder.level
        self.subs.set_shed_level(level)
        kind = "sub_shed_step" if level > before else "sub_shed_recover"
        self._c["sub_shed_steps" if level > before
                else "sub_shed_recovers"].inc()
        actions.append({"now": now, "kind": kind, "level": level,
                        "mode": moved, "backlog_windows": backlog,
                        "slowest_lag": lag,
                        "active_subs": load.get("active")})

    def _step_compactor(self, now: float, actions: List[Dict]) -> None:
        """Supervise the background WAL compactor: surface completed
        passes as actions, respawn a dead thread within the budget,
        fail fast past it (unbounded log, loudly — not a wrong one)."""
        comp = self.compactor
        for ev in comp.drain_events():
            self._c["compactions"].inc()
            actions.append({"now": now, "kind": "wal_compact",
                            "out": ev["out"], "covers": ev["covers"],
                            "segments": ev["segments"],
                            "reclaimed_bytes": ev["reclaimed_bytes"],
                            "gen": ev["gen"]})
        if comp.alive or self._compactor_failed:
            return
        if not self._compactor_booted:
            # first sight of a cold compactor: the control plane owns
            # its lifecycle — boot it for free, budget only respawns
            comp.start()
            self._compactor_booted = True
            return
        cfg = self.config
        if self._compactor_restarts_used >= cfg.max_compactor_restarts:
            self._compactor_failed = True
            actions.append({"now": now, "kind": "compactor_failed",
                            "error": repr(comp.last_error),
                            "used": self._compactor_restarts_used})
            return
        if comp.restart():
            self._compactor_restarts_used += 1
            self._c["compactor_restarts"].inc()
            actions.append({"now": now, "kind": "compactor_restart",
                            "used": self._compactor_restarts_used,
                            "error": repr(comp.last_error)})

    def _spec_for(self, h) -> Optional[SLOSpec]:
        spec = self.specs.get(h.name, self.config.default_slo)
        if (spec is not None and self.config.protect_weight is not None
                and h.config.weight >= self.config.protect_weight):
            return None  # QoS-protected: never browned out
        return spec

    def _default_sample(self) -> Dict:
        tier = self.tier
        graphs: Dict[str, Dict] = {}
        wals: Dict[str, object] = {}
        with tier._lock:
            live = tier.live_workers
            target = tier._target_threads
            t = time.perf_counter()
            ready = 0
            for name, h in tier._graphs.items():
                fe = h.frontend
                fire, _w = fe._poll(t)
                if fire:
                    ready += 1
                share = fe._budget
                cap = max(1, share.ceiling)
                graphs[name] = {
                    "state": fe._state,
                    "policy": fe.policy,
                    "queued_batches": fe._queues.queued_batches,
                    "bytes_used": share.used,
                    "occupancy": share.used / cap,
                    "sched_delay_p99_s": percentile(
                        list(h.sched_delay_s), 99),
                    "windows": h.windows,
                    "durable_lag_s": 0.0,
                    "committer_dead": False,
                }
                wal = getattr(fe.sched, "wal", None)
                if wal is not None:
                    wals[name] = wal
        # WAL reads OUTSIDE the tier lock (see module docstring: the
        # committer holds the WAL lock when it takes the tier lock)
        for name, wal in wals.items():
            err = wal.committer_error
            graphs[name]["committer_dead"] = err is not None
            if err is None:
                graphs[name]["durable_lag_s"] = wal.durable_lag_s()
        return {"graphs": graphs, "ready_depth": ready,
                "live_workers": live, "target_workers": target}

    # -- actuator family 1: graceful overload degradation ------------------

    def _step_brownout(self, now: float, name: str, ctl: _GraphControl,
                       info: Dict, actions: List[Dict]) -> None:
        if ctl.ladder is None or info.get("state") != "running":
            return
        before = ctl.ladder.level
        new_policy = ctl.ladder.observe(ctl.spec.breached(info))
        if new_policy is None:
            return
        with self.tier._lock:
            fe = ctl.handle.frontend
            fe.policy = new_policy
            # blocked producers re-check the (new) policy on wakeup
            fe._not_full.notify_all()
        level = ctl.ladder.level
        if level > before:
            if before == 0:
                self._c["brownouts_entered"].inc()
            self._c["brownout_steps"].inc()
            actions.append({"now": now, "kind": "brownout_step",
                            "graph": name, "level": level,
                            "policy": new_policy})
        else:
            if level == 0:
                self._c["brownouts_exited"].inc()
            actions.append({"now": now, "kind": "brownout_recover",
                            "graph": name, "level": level,
                            "policy": new_policy})

    # -- actuator family 2: supervision / self-healing ---------------------

    def _step_supervision(self, now: float, name: str,
                          ctl: _GraphControl, info: Dict,
                          actions: List[Dict]) -> None:
        cfg = self.config
        state = info.get("state", "running")
        failed = state == "failed"
        # a committer that died under a still-RUNNING graph is healed
        # before the next window would poison the whole graph
        if (info.get("committer_dead") and not failed
                and self._restart_committer(now, name, ctl, actions)):
            pass
        if failed and ctl.last_state != "failed":
            verdict = ctl.breaker.record_crash(now)
            if verdict == "open":
                self._c["breaker_opens"].inc()
                actions.append({"now": now, "kind": "breaker_open",
                                "graph": name,
                                "crashes": ctl.breaker.crashes})
                # a breaker trip is a moment the process may not
                # outlive — flush it to the flight ring eagerly
                from reflow_tpu_torch.obs import flight as _flight
                _flight.note("breaker_open", graph=name,
                             crashes=ctl.breaker.crashes)
        ctl.last_state = state
        if not cfg.respawn:
            return
        verdict = ctl.breaker.poll(now, healthy=not failed)
        if verdict in ("respawn", "probe"):
            if verdict == "probe":
                self._c["breaker_probes"].inc()
                actions.append({"now": now, "kind": "breaker_probe",
                                "graph": name})
            if self._revive(now, name, ctl, actions):
                ctl.last_state = "running"
            else:
                # revive impossible (committer budget exhausted, state
                # raced): counts as a failed attempt — the breaker backs
                # off or opens instead of hot-looping
                ctl.breaker.record_crash(now)
        elif verdict == "close":
            self._c["breaker_closes"].inc()
            actions.append({"now": now, "kind": "breaker_close",
                            "graph": name})

    def _restart_committer(self, now: float, name: str,
                           ctl: _GraphControl,
                           actions: List[Dict]) -> bool:
        cfg = self.config
        if ctl.committer_restarts_used >= cfg.max_committer_restarts:
            return False  # fail fast from here on
        wal = getattr(ctl.handle.frontend.sched, "wal", None)
        if wal is None or not wal.restart_committer():
            return False
        ctl.committer_restarts_used += 1
        self._c["committer_restarts"].inc()
        actions.append({"now": now, "kind": "committer_restart",
                        "graph": name,
                        "used": ctl.committer_restarts_used})
        return True

    def _revive(self, now: float, name: str, ctl: _GraphControl,
                actions: List[Dict]) -> bool:
        fe = ctl.handle.frontend
        wal = getattr(fe.sched, "wal", None)
        if wal is not None and wal.committer_error is not None:
            if not self._restart_committer(now, name, ctl, actions):
                return False
        try:
            fe.revive()
        except Exception:  # noqa: BLE001 - state raced; retry next tick
            return False
        self._c["respawns"].inc()
        actions.append({"now": now, "kind": "respawn", "graph": name})
        return True

    # -- actuator family 3: elasticity / rebalancing -----------------------

    def _step_reclaim(self, now: float, name: str, ctl: _GraphControl,
                      info: Dict, actions: List[Dict]) -> None:
        cfg = self.config
        floor_cfg = ctl.handle.config.floor_bytes
        if not cfg.reclaim_idle_intervals or floor_cfg <= 0:
            return
        windows = info.get("windows", 0)
        idle = (info.get("state") == "running"
                and info.get("queued_batches", 0) == 0
                and info.get("bytes_used", 0) == 0
                and windows == ctl.windows_last)
        ctl.windows_last = windows
        if idle:
            if ctl.reclaimed:
                return
            ctl.idle_streak += 1
            if ctl.idle_streak < cfg.reclaim_idle_intervals:
                return
            with self.tier._lock:
                try:
                    # shrink to the bytes actually held (0 when idle):
                    # the unused reservation returns tier-wide
                    self.tier.budget.resize(name, floor=0)
                except (KeyError, ValueError):
                    return
            ctl.reclaimed = True
            self._c["reclaims"].inc()
            actions.append({"now": now, "kind": "floor_reclaim",
                            "graph": name, "floor_bytes": floor_cfg})
            return
        ctl.idle_streak = 0
        if not ctl.reclaimed:
            return
        with self.tier._lock:
            try:
                self.tier.budget.resize(name, floor=floor_cfg)
            except (KeyError, ValueError):
                return  # not reservable right now; retry next tick
        ctl.reclaimed = False
        self._c["floor_restores"].inc()
        actions.append({"now": now, "kind": "floor_restore",
                        "graph": name, "floor_bytes": floor_cfg})

    def _step_pool(self, now: float, sample: Dict,
                   actions: List[Dict]) -> None:
        spawned = self.tier.ensure_workers()
        if spawned:
            self._c["worker_respawns"].inc(spawned)
            actions.append({"now": now, "kind": "worker_respawn",
                            "count": spawned})
        if self._autoscaler is None:
            return
        live = sample.get("live_workers", self.tier.live_workers)
        target = self._autoscaler.observe(
            sample.get("ready_depth", 0), live)
        if target is None or target == live:
            return
        self.tier.scale_pool(target)
        if target > live:
            self._c["scale_ups"].inc()
            kind = "scale_up"
        else:
            self._c["scale_downs"].inc()
            kind = "scale_down"
        actions.append({"now": now, "kind": kind, "workers": target})

    # -- recording ---------------------------------------------------------

    def _record(self, action: Dict) -> None:
        self.actions.append(action)
        if _trace.ENABLED:
            t = time.perf_counter()
            args = {k: v for k, v in action.items() if k != "now"}
            _trace.evt(f"control.{action['kind']}", t, 0.0,
                       track="control", args=args)
