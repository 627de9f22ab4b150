"""The port's control plane (``reflow_tpu_torch.serve.control``) and the
robustness seams it actuates, against ``tests/test_control.py``, on the
CPU.

Every test of ``tests/test_control.py`` has a counterpart here, in its
three layers:

1. **State machines on a fake clock** — :class:`BrownoutLadder`,
   :class:`CircuitBreaker`, :class:`Autoscaler` fed synthetic
   observations; no tier, no threads, no sleeps.

2. **Actuator seams** — ``AdmissionBudget.resize``,
   ``WriteAheadLog.wait_durable(timeout=)``,
   ``WriteAheadLog.restart_committer``, ``IngestFrontend.revive``,
   ``ServeTier.ensure_workers``/``scale_pool``.

3. **ControlPlane integration** — injected samplers on a fake clock drive
   the real actuators on a live tier: brownout flips the real admission
   policy, idle reclaim shrinks and restores the real budget floor, the
   breaker quarantines a crash-storming graph and heals it through
   half-open once the storm ends.

The tests that drive a graph run over the port's CPU oracle (string keys)
and over its ``"cuda"`` executor at ``device="cpu"`` (integer keys
interned into one vocabulary). The ``fleet=`` and ``subs=`` hooks are
driven with the port's ``FleetAggregator`` and ``SubscriptionHub``
(counterparts of ``tests/test_fleet.py``'s and ``tests/test_subs.py``'s
control-plane tests).
"""

from __future__ import annotations

import time

import pytest

import reflow_tpu_torch as P
from reflow_tpu_torch.executors.cpu import CpuExecutor
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.scheduler import DirtyScheduler
from reflow_tpu_torch.obs import MetricsRegistry
from reflow_tpu_torch.obs.fleet import FleetAggregator
from reflow_tpu_torch.serve import (AdmissionBudget, Autoscaler,
                                    BrownoutLadder, CircuitBreaker,
                                    CoalesceWindow, ControlConfig,
                                    ControlPlane, FrontendClosed, GraphConfig,
                                    IngestFrontend, PumpCrashed,
                                    ReplicaScheduler, SLOSpec, ServeTier,
                                    load_slo_specs)
from reflow_tpu_torch.subs import SubscriptionHub
from reflow_tpu_torch.utils.faults import (CrashInjector, CrashPoint,
                                           StormInjector)
from reflow_tpu_torch.wal import WriteAheadLog
from reflow_tpu_torch.wal.log import scan_wal
from reflow_tpu_torch.workloads import wordcount

WINDOW = CoalesceWindow(max_rows=256, max_ticks=8, max_latency_s=0.002)


#: the executor the graph-driving tests run on (set by ``kind``)
_KIND = ["cpu"]
#: one vocabulary for every integer-keyed graph: a word's key is fixed
_VOCAB: dict = {}
KEY_SPACE = 1 << 12


@pytest.fixture(params=["cpu", "cuda"])
def kind(request):
    _KIND[0] = request.param
    yield request.param
    _KIND[0] = "cpu"


def make_graph():
    if _KIND[0] == "cuda":
        g, src, sink = wordcount.build_graph(KEY_SPACE)
        return (DirtyScheduler(g, P.get_executor("cuda", device="cpu")),
                src, sink)
    g, src, sink = wordcount.build_graph()
    return DirtyScheduler(g, CpuExecutor()), src, sink


def lines_batch(*words: str):
    if _KIND[0] == "cuda":
        b = wordcount.ingest_lines([" ".join(words)], vocab=_VOCAB)
        assert len(_VOCAB) < KEY_SPACE
        return b
    return wordcount.ingest_lines([" ".join(words)])


def key(word: str):
    """A word's key in the sink's view on the current executor."""
    return _VOCAB[word] if _KIND[0] == "cuda" else word


def config(**kw):
    kw.setdefault("window", WINDOW)
    return GraphConfig(**kw)


def wait_until(pred, timeout=10.0, interval=0.005, msg="condition"):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


# -- 1: brownout ladder ------------------------------------------------------

def test_ladder_steps_down_after_breach_intervals():
    lad = BrownoutLadder("block", ("reject", "shed-oldest"),
                         breach_intervals=3, recover_intervals=2)
    assert lad.policy == "block" and lad.level == 0
    assert lad.observe(True) is None
    assert lad.observe(True) is None
    assert lad.observe(True) == "reject"          # 3rd consecutive breach
    assert lad.level == 1
    # the streak restarts per rung: two more breaches don't move yet
    assert lad.observe(True) is None
    assert lad.observe(True) is None
    assert lad.observe(True) == "shed-oldest"
    assert lad.level == 2
    # bottom rung: further breaches are absorbed
    for _ in range(5):
        assert lad.observe(True) is None
    assert lad.policy == "shed-oldest"


def test_ladder_recovery_hysteresis_per_rung():
    lad = BrownoutLadder("block", ("reject", "shed-oldest"),
                         breach_intervals=1, recover_intervals=3)
    assert lad.observe(True) == "reject"
    assert lad.observe(True) == "shed-oldest"
    # two clean samples then a breach: the ok-streak resets, the level
    # holds — a flapping gauge can't pump the ladder
    assert lad.observe(False) is None
    assert lad.observe(False) is None
    assert lad.observe(True) is None
    assert lad.level == 2
    # a full clean streak recovers exactly ONE rung...
    assert lad.observe(False) is None
    assert lad.observe(False) is None
    assert lad.observe(False) == "reject"
    assert lad.level == 1
    # ...and the next rung needs a fresh full streak
    assert lad.observe(False) is None
    assert lad.observe(False) is None
    assert lad.observe(False) == "block"
    assert lad.level == 0
    # at level 0 clean samples are a no-op
    assert lad.observe(False) is None


def test_ladder_collapses_duplicate_rungs():
    lad = BrownoutLadder("reject", ("reject", "shed-oldest"),
                         breach_intervals=1, recover_intervals=1)
    assert lad.levels == ("reject", "shed-oldest")
    assert lad.observe(True) == "shed-oldest"
    assert lad.level == 1


def test_slo_spec_validates_and_breaches():
    with pytest.raises(ValueError):
        SLOSpec(ladder=("bogus",))
    with pytest.raises(ValueError):
        SLOSpec(breach_intervals=0)
    spec = SLOSpec(sched_delay_p99_s=0.1, durable_lag_s=0.5,
                   budget_occupancy=0.8)
    assert not spec.breached({})
    assert spec.breached({"sched_delay_p99_s": 0.2})
    assert spec.breached({"durable_lag_s": 1.0})
    assert spec.breached({"occupancy": 0.9})
    assert not spec.breached({"sched_delay_p99_s": 0.05,
                              "durable_lag_s": 0.1, "occupancy": 0.5})
    # None thresholds are skipped entirely
    assert not SLOSpec(budget_occupancy=None).breached({"occupancy": 9.0})


# -- 1: circuit breaker ------------------------------------------------------

def breaker(**kw):
    kw.setdefault("max_crashes", 3)
    kw.setdefault("window_s", 10.0)
    kw.setdefault("backoff_s", 0.1)
    kw.setdefault("backoff_max_s", 1.0)
    kw.setdefault("cooldown_s", 5.0)
    kw.setdefault("cooldown_max_s", 20.0)
    kw.setdefault("probe_intervals", 2)
    kw.setdefault("jitter_frac", 0.0)   # deterministic unless overridden
    return CircuitBreaker(**kw)


def test_breaker_opens_on_k_crashes_in_window():
    br = breaker()
    assert br.record_crash(0.0) == "closed"
    assert br.record_crash(1.0) == "closed"
    assert br.record_crash(2.0) == "open"
    assert br.state == "open" and br.opens == 1
    # open: no respawns, cooldown not yet elapsed
    assert br.poll(3.0, healthy=False) is None


def test_breaker_window_expiry_prevents_opening():
    br = breaker(window_s=5.0)
    br.record_crash(0.0)
    br.record_crash(1.0)
    # the first two crashes age out of the window before the third
    assert br.record_crash(20.0) == "closed"
    assert br.state == "closed"


def test_breaker_closed_backoff_is_exponential_with_jitter():
    br = breaker(backoff_s=0.1, backoff_max_s=1.0, jitter_frac=0.5,
                 rng=lambda: 1.0, window_s=1e9, max_crashes=100)
    t = 0.0
    waits = []
    for _ in range(6):
        br.record_crash(t)
        # not ready before the scheduled instant
        assert br.poll(t, healthy=False) is None
        lo = t
        while br.poll(lo + 1e-9, healthy=False) != "respawn":
            lo += 0.01
        waits.append(lo - t)
        t = lo + 1e-9
    # base 0.1 doubling each consecutive respawn, rng=1.0 → ×1.5 jitter,
    # capped at backoff_max 1.0 (→ 1.5 with jitter)
    expect = [0.15, 0.3, 0.6, 1.2, 1.5, 1.5]
    for got, want in zip(waits, expect):
        assert abs(got - want) < 0.02, (waits, expect)


def test_breaker_backoff_resets_after_sustained_health():
    br = breaker(probe_intervals=2, window_s=1e9, max_crashes=100)
    br.record_crash(0.0)
    br.poll(10.0, healthy=False)  # consume the respawn
    assert br.respawn_delay() > br.backoff_s  # backed off
    br.poll(11.0, healthy=True)
    br.poll(12.0, healthy=True)   # probe_intervals healthy polls
    assert br.respawn_delay() == br.backoff_s


def test_breaker_half_open_probe_then_close():
    br = breaker(cooldown_s=5.0, probe_intervals=2)
    for t in (0.0, 1.0, 2.0):
        br.record_crash(t)
    assert br.state == "open"
    assert br.poll(6.0, healthy=False) is None        # cooldown running
    assert br.poll(7.1, healthy=False) == "probe"     # 2.0 + 5.0 elapsed
    assert br.state == "half_open"
    # only ONE probe: further polls while unhealthy do nothing
    assert br.poll(7.2, healthy=False) is None
    assert br.poll(8.0, healthy=True) is None          # 1st healthy
    assert br.poll(9.0, healthy=True) == "close"       # 2nd → closed
    assert br.state == "closed"
    # full reset: the old crashes don't count toward the next storm
    assert br.record_crash(10.0) == "closed"


def test_breaker_probe_crash_reopens_with_doubled_cooldown():
    br = breaker(cooldown_s=5.0, cooldown_max_s=8.0)
    for t in (0.0, 1.0, 2.0):
        br.record_crash(t)
    assert br.poll(7.1, healthy=False) == "probe"
    assert br.record_crash(7.5) == "open"             # probe crashed
    assert br.opens == 2
    # doubled cooldown: 7.5 + 10 → but capped at 8.0
    assert br.poll(14.0, healthy=False) is None
    assert br.poll(15.6, healthy=False) == "probe"
    # a successful probe restores the base cooldown
    br.poll(16.0, healthy=True)
    br.poll(17.0, healthy=True)
    assert br.state == "closed" and br._cooldown == br.cooldown_base_s


# -- 1: autoscaler -----------------------------------------------------------

def test_autoscaler_grows_on_sustained_backlog():
    au = Autoscaler(min_workers=1, max_workers=4, grow_intervals=3,
                    shrink_intervals=5)
    assert au.observe(5, 2) is None
    assert au.observe(5, 2) is None
    assert au.observe(5, 2) == 3          # 3rd sustained sample
    # streak restarts after a grow, and an intervening calm sample
    # resets it
    assert au.observe(5, 3) is None
    assert au.observe(3, 3) is None       # ready == live: calm
    assert au.observe(5, 3) is None
    assert au.observe(5, 3) is None
    assert au.observe(5, 3) == 4
    # at max: sustained backlog is absorbed
    for _ in range(6):
        assert au.observe(9, 4) is None


def test_autoscaler_shrinks_on_sustained_idle_and_clamps():
    au = Autoscaler(min_workers=2, max_workers=4, grow_intervals=2,
                    shrink_intervals=3)
    assert au.observe(0, 3) is None
    assert au.observe(0, 3) is None
    assert au.observe(0, 3) == 2
    # at min: sustained idle is absorbed
    for _ in range(4):
        assert au.observe(0, 2) is None
    # out-of-range live counts clamp immediately, no streak needed
    assert au.observe(0, 1) == 2
    assert au.observe(0, 9) == 4
    with pytest.raises(ValueError):
        Autoscaler(min_workers=3, max_workers=2)


# -- 2: budget resize --------------------------------------------------------

def test_budget_resize_retunes_and_validates():
    b = AdmissionBudget(1000)
    a = b.register("a", floor=300, ceiling=600)
    c = b.register("c", floor=200)
    # shrinking a's floor grows c's guaranteed headroom
    before = c.max_alone
    b.resize("a", floor=0)
    assert a.floor == 0 and c.max_alone == before + 300
    b.resize("a", floor=300)   # restorable while reservable
    assert a.floor == 300
    with pytest.raises(KeyError):
        b.resize("nope", floor=1)
    with pytest.raises(ValueError):
        b.resize("a", floor=-1)
    with pytest.raises(ValueError):
        b.resize("a", floor=700, ceiling=600)
    with pytest.raises(ValueError):
        b.resize("a", ceiling=2000)
    with pytest.raises(ValueError):
        b.resize("a", floor=900)   # c's 200 floor stays reserved
    # ceiling below current usage: legal, nothing evicted
    a.acquire(500)
    b.resize("a", ceiling=400)
    assert a.used == 500 and a.ceiling == 400
    assert not a.room_for(1)


# -- 2: bounded durability waits --------------------------------------------

def test_wait_durable_timeout_is_bounded_and_non_consuming(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="record")
    # wedge the committer: holding _sync_lock blocks its write/fsync
    wal._sync_lock.acquire()
    try:
        wal.append({"k": 1}, wait=False)
        lsn = wal.last_lsn()
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            wal.wait_durable(lsn, timeout=0.2)
        assert time.perf_counter() - t0 < 5.0
    finally:
        wal._sync_lock.release()
    # non-consuming: the request stayed queued, a re-wait succeeds
    wal.wait_durable(lsn, timeout=10.0)
    assert wal.durable_lsn() >= lsn
    wal.close()


def test_ticket_result_timeout_is_bounded_and_non_consuming(kind):
    sched, src, _sink = make_graph()
    # a window that only fires on flush: the ticket stays pending
    fe = IngestFrontend(sched, window=CoalesceWindow(
        max_rows=1 << 20, max_ticks=1 << 20, max_latency_s=60.0))
    t = fe.submit(src, lines_batch("hello"))
    with pytest.raises(TimeoutError):
        t.result(timeout=0.1)
    fe.flush(timeout=10)
    assert t.result(timeout=10).applied   # same ticket, later success
    fe.close()


# -- 2: committer respawn ----------------------------------------------------

def test_restart_committer_recovers_a_dead_wal(tmp_path):
    inj = CrashInjector(at=1, only="wal_before_fsync")
    wal = WriteAheadLog(str(tmp_path), fsync="record", crash=inj)
    with pytest.raises(CrashPoint):
        wal.append({"k": 1})          # committer dies at the fsync seam
    assert wal.committer_error is not None
    with pytest.raises(CrashPoint):
        wal.append({"k": 2})          # dead committer poisons appends
    assert wal.restart_committer() is True
    assert wal.committer_error is None
    assert wal.committer_restarts == 1
    assert isinstance(wal.last_committer_error, CrashPoint)
    # the respawned committer serves appends and durability again
    wal.append({"k": 3})
    wal.wait_durable(wal.last_lsn(), timeout=10.0)
    wal.close()
    # the log stays scannable end to end (tail repaired at restart)
    records, torn = scan_wal(str(tmp_path))
    assert torn is None
    assert {"k": 3} in [r for _pos, r in records]


def test_restart_committer_noop_when_healthy(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="record")
    assert wal.restart_committer() is False
    assert wal.committer_restarts == 0
    wal.close()


# -- 2: pool supervision (the capacity-leak regression) ----------------------

def test_worker_death_is_healed_and_throughput_restored(kind):
    inj = CrashInjector(at=1, only="pool_worker@g0")
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2, crash=inj)
    sched, src, sink = make_graph()
    h = tier.register("g0", sched, config())
    assert tier.live_workers == 2
    # the seam fires between windows: the batch lands, the worker dies
    assert h.submit(src, lines_batch("a", "b")).result(timeout=10).applied
    wait_until(lambda: tier.worker_deaths == 1, msg="worker death")
    wait_until(lambda: tier.live_workers == 1, msg="thread exit")
    # before this PR the pool stayed at 1 thread forever; the
    # supervisor restores it to the configured size
    assert tier.ensure_workers() == 1
    assert tier.live_workers == 2
    assert tier.worker_respawns == 1
    # post-crash throughput parity: the restored pool serves everything
    tickets = [h.submit(src, lines_batch(f"w{j}")) for j in range(40)]
    assert all(t.result(timeout=10).applied for t in tickets)
    assert dict(sched.view(sink.name))[(key("a"), 1.0)] == 1
    tier.close()


def test_scale_pool_grows_and_shrinks_live_workers():
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2)
    assert tier.live_workers == 2
    assert tier.scale_pool(4) == 4
    wait_until(lambda: tier.live_workers == 4, msg="scale up")
    assert tier.pump_threads == 4   # utilization denominator follows
    assert tier.scale_pool(1) == 1
    wait_until(lambda: tier.live_workers == 1, msg="scale down")
    # clamped at 1: the pool can never scale to zero
    assert tier.scale_pool(0) == 1
    tier.close()


def test_revive_rearms_a_failed_graph(kind):
    inj = CrashInjector(at=1, only="pool_window@doomed")
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2, crash=inj)
    sched, src, sink = make_graph()
    h = tier.register("doomed", sched, config())
    t = h.submit(src, lines_batch("x"))
    with pytest.raises(PumpCrashed):
        t.result(timeout=10)
    wait_until(lambda: h.frontend._state == "failed", msg="failed state")
    with pytest.raises(FrontendClosed):
        h.submit(src, lines_batch("y"))   # failed: submissions refused
    h.frontend.revive()
    assert h.frontend.revives == 1
    # the revived graph serves new traffic (injector is one-shot)
    assert h.submit(src, lines_batch("z")).result(timeout=10).applied
    assert dict(sched.view(sink.name)).get((key("z"), 1.0)) == 1
    # revive() on a running frontend is an error
    with pytest.raises(GraphError):
        h.frontend.revive()
    tier.close()


# -- 3: ControlPlane integration --------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def make_tier_with(name, **cfg_kw):
    tier = ServeTier(max_bytes=1 << 20, pump_threads=2)
    sched, src, sink = make_graph()
    h = tier.register(name, sched, config(**cfg_kw))
    return tier, h, src, sink


def test_control_brownout_actuates_and_recovers_policy(kind):
    tier, h, _src, _sink = make_tier_with("hot")
    clk = FakeClock()
    occ = {"v": 0.95}
    sampler = lambda now: {"graphs": {"hot": {
        "state": "running", "occupancy": occ["v"]}},
        "ready_depth": 0, "live_workers": tier.live_workers}
    reg = MetricsRegistry()
    cp = ControlPlane(
        tier, specs={"hot": SLOSpec(budget_occupancy=0.8,
                                    breach_intervals=2,
                                    recover_intervals=3)},
        registry=reg, clock=clk, sampler=sampler)
    cp.step(clk.advance(0.05))
    assert h.frontend.policy == "block"
    cp.step(clk.advance(0.05))            # 2nd breach → level 1
    assert h.frontend.policy == "reject" and cp.level("hot") == 1
    for _ in range(2):
        cp.step(clk.advance(0.05))
    assert h.frontend.policy == "shed-oldest" and cp.level("hot") == 2
    occ["v"] = 0.1
    for _ in range(6):
        cp.step(clk.advance(0.05))
    assert h.frontend.policy == "block" and cp.level("hot") == 0
    assert reg.value("control.brownouts_entered") == 1
    assert reg.value("control.brownouts_exited") == 1
    cp.stop()
    tier.close()


def test_control_protect_weight_exempts_high_qos_graph(kind):
    tier = ServeTier(max_bytes=1 << 20, pump_threads=2)
    s1, _, _ = make_graph()
    s2, _, _ = make_graph()
    tier.register("hot", s1, config(weight=1.0))
    tier.register("vip", s2, config(weight=4.0))
    clk = FakeClock()
    sampler = lambda now: {"graphs": {
        "hot": {"state": "running", "occupancy": 0.99},
        "vip": {"state": "running", "occupancy": 0.99}},
        "ready_depth": 0, "live_workers": tier.live_workers}
    cp = ControlPlane(
        tier,
        config=ControlConfig(
            default_slo=SLOSpec(budget_occupancy=0.8, breach_intervals=1),
            protect_weight=2.0),
        registry=MetricsRegistry(), clock=clk, sampler=sampler)
    for _ in range(3):
        cp.step(clk.advance(0.05))
    assert cp.level("hot") > 0
    assert tier.handle("hot").frontend.policy != "block"
    # the protected tenant is never browned out
    assert cp.level("vip") == 0
    assert tier.handle("vip").frontend.policy == "block"
    cp.stop()
    tier.close()


def test_control_idle_reclaim_shrinks_and_restores_floor(kind):
    tier, h, _src, _sink = make_tier_with("quiet", floor_bytes=1 << 16)
    clk = FakeClock()
    busy = {"v": False}
    sampler = lambda now: {"graphs": {"quiet": {
        "state": "running",
        "queued_batches": 1 if busy["v"] else 0,
        "bytes_used": 64 if busy["v"] else 0,
        "windows": 0}},
        "ready_depth": 0, "live_workers": tier.live_workers}
    reg = MetricsRegistry()
    cp = ControlPlane(tier, config=ControlConfig(reclaim_idle_intervals=3),
                      registry=reg, clock=clk, sampler=sampler)
    share = tier.budget.shares()["quiet"]
    for _ in range(2):
        cp.step(clk.advance(0.05))
    assert share.floor == 1 << 16        # not yet: streak too short
    cp.step(clk.advance(0.05))
    assert share.floor == 0              # reclaimed tier-wide
    assert reg.value("control.reclaims") == 1
    busy["v"] = True
    cp.step(clk.advance(0.05))
    assert share.floor == 1 << 16        # restored on first traffic
    assert reg.value("control.floor_restores") == 1
    cp.stop()
    tier.close()


def test_control_autoscaler_resizes_the_real_pool(kind):
    tier, _h, _src, _sink = make_tier_with("g")
    clk = FakeClock()
    depth = {"v": 8}
    sampler = lambda now: {"graphs": {},
                           "ready_depth": depth["v"],
                           "live_workers": tier.live_workers}
    reg = MetricsRegistry()
    cp = ControlPlane(
        tier, config=ControlConfig(min_workers=1, max_workers=4,
                                   grow_intervals=2, shrink_intervals=3),
        registry=reg, clock=clk, sampler=sampler)
    for _ in range(2):
        cp.step(clk.advance(0.05))
    wait_until(lambda: tier.live_workers == 3, msg="scale up")
    assert reg.value("control.scale_ups") == 1
    assert reg.value("pool.live_workers") == 3
    depth["v"] = 0
    for _ in range(6):
        cp.step(clk.advance(0.05))
        time.sleep(0.01)   # let retiring workers notice between steps
    wait_until(lambda: tier.live_workers == 1, msg="scale down")
    assert reg.value("control.scale_downs") >= 1
    cp.stop()
    assert reg.value("pool.live_workers") is None   # unregistered at stop
    tier.close()


def test_control_heals_crash_storm_through_breaker(kind):
    storm = StormInjector(only="pool_window@stormy")
    tier = ServeTier(max_bytes=1 << 20, pump_threads=2, crash=storm)
    sched, src, sink = make_graph()
    h = tier.register("stormy", sched, config())
    reg = MetricsRegistry()
    cp = ControlPlane(
        tier,
        config=ControlConfig(max_crashes=3, crash_window_s=30.0,
                             respawn_backoff_s=0.0,
                             respawn_backoff_max_s=0.01,
                             breaker_cooldown_s=0.02,
                             breaker_cooldown_max_s=0.1,
                             probe_intervals=2),
        registry=reg)
    # storm: every revive crashes again until the breaker opens
    deadline = time.perf_counter() + 30
    while (cp.breaker_state("stormy") != "open"
           and time.perf_counter() < deadline):
        try:
            h.submit(src, lines_batch("x"), timeout=0.1)
        except Exception:
            pass
        cp.step()
        time.sleep(0.005)
    assert cp.breaker_state("stormy") == "open"
    assert reg.value("control.breaker_opens") == 1
    assert storm.crashes >= 3
    # quarantined: submissions fail fast, no respawn churn
    with pytest.raises(Exception):
        h.submit(src, lines_batch("y"))
    # storm ends → half-open probe → closed, no manual intervention
    storm.disarm()
    wait_until(lambda: (cp.step(), time.sleep(0.005),
                        cp.breaker_state("stormy") == "closed")[-1],
               timeout=30, msg="breaker close")
    assert reg.value("control.breaker_probes") >= 1
    assert reg.value("control.breaker_closes") == 1
    assert h.submit(src, lines_batch("back")).result(timeout=10).applied
    assert dict(sched.view(sink.name)).get((key("back"), 1.0)) == 1
    cp.stop()
    tier.close()


def test_control_loop_thread_survives_sampler_errors(kind):
    tier, h, src, _sink = make_tier_with("g")
    boom = {"n": 0}

    def sampler(now):
        boom["n"] += 1
        if boom["n"] < 3:
            raise RuntimeError("flaky gauge")
        return {"graphs": {}, "ready_depth": 0,
                "live_workers": tier.live_workers}

    reg = MetricsRegistry()
    cp = ControlPlane(tier, config=ControlConfig(interval_s=0.005),
                      registry=reg, sampler=sampler)
    with cp:
        wait_until(lambda: cp.ticks >= 2, msg="loop survived errors")
        assert reg.value("control.errors") == 2
    assert cp.errors == 2
    # stop() tears the control.* metrics down with it
    assert reg.value("control.errors") is None
    # the tier still serves traffic throughout
    assert h.submit(src, lines_batch("ok")).result(timeout=10).applied
    tier.close()


def test_control_default_sampler_reads_live_tier_without_deadlock(kind):
    tier, h, src, _sink = make_tier_with("g")
    cp = ControlPlane(tier, registry=MetricsRegistry())
    assert h.submit(src, lines_batch("a", "b")).result(timeout=10).applied
    actions = cp.step()
    assert actions == []                  # healthy tier: nothing to do
    info = cp._default_sample()["graphs"]["g"]
    assert info["state"] == "running" and not info["committer_dead"]
    assert 0.0 <= info["occupancy"] <= 1.0
    cp.stop()
    tier.close()


# -- SLO specs from a config file (ControlPlane(config_path=)) --------------

def _write_slo_config(tmp_path, payload):
    import json
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(payload))
    return str(path)


def test_load_slo_specs_parses_defaults_and_overrides(tmp_path):
    path = _write_slo_config(tmp_path, {
        "default_slo": {"sched_delay_p99_s": 0.5, "breach_intervals": 2},
        "specs": {
            "hot": {"budget_occupancy": 0.9,
                    "ladder": ["reject", "shed-oldest"]},
            "cold": {"sched_delay_p99_s": 2.0},
        }})
    specs = load_slo_specs(path)
    assert set(specs) == {"hot", "cold"}
    # default inherited, per-spec field layered on top
    assert specs["hot"].sched_delay_p99_s == 0.5
    assert specs["hot"].budget_occupancy == 0.9
    assert specs["hot"].breach_intervals == 2
    assert specs["hot"].ladder == ("reject", "shed-oldest")
    # per-spec override beats the default
    assert specs["cold"].sched_delay_p99_s == 2.0
    assert isinstance(specs["cold"], SLOSpec)


def test_load_slo_specs_fails_loudly_on_typos(tmp_path):
    with pytest.raises(ValueError, match="unknown fields"):
        load_slo_specs(_write_slo_config(tmp_path, {
            "specs": {"g": {"sched_delay_p99s": 0.5}}}))  # missing _
    with pytest.raises(ValueError, match="unknown top-level"):
        load_slo_specs(_write_slo_config(tmp_path, {
            "spec": {}}))
    with pytest.raises(ValueError, match="ladder policy"):
        load_slo_specs(_write_slo_config(tmp_path, {
            "specs": {"g": {"ladder": ["reject", "nuke-from-orbit"]}}}))
    with pytest.raises(ValueError, match="default_slo has unknown"):
        load_slo_specs(_write_slo_config(tmp_path, {
            "default_slo": {"durable_lags": 1.0}, "specs": {}}))


def test_control_plane_config_path_with_explicit_override(tmp_path, kind):
    path = _write_slo_config(tmp_path, {
        "specs": {"g": {"sched_delay_p99_s": 0.25},
                  "other": {"budget_occupancy": 0.8}}})
    tier, h, src, _sink = make_tier_with("g")
    pinned = SLOSpec(sched_delay_p99_s=9.0)
    cp = ControlPlane(tier, config_path=path, specs={"g": pinned},
                      registry=MetricsRegistry())
    # file supplies the fleet, explicit specs= pins the exceptions
    assert cp.specs["g"] is pinned
    assert cp.specs["other"].budget_occupancy == 0.8
    assert h.submit(src, lines_batch("x")).result(timeout=10).applied
    assert cp.step() == []  # healthy: file-loaded specs drive the loop
    cp.stop()
    tier.close()


# -- the fleet= and subs= hooks, over the ported aggregator and hub --------
# (counterparts of tests/test_fleet.py's and tests/test_subs.py's
# ControlPlane tests)

def _fleet_snap(mono, **gauges):
    return {"schema": "reflow.obs.snapshot/1", "ts_mono": mono,
            "ts_wall": 1000.0 + mono, "gauges": gauges}


def test_control_plane_fleet_advisory_edge_triggered():
    """A port ``FleetAggregator`` behind ``ControlPlane(fleet=)``: the
    lag-spread breach surfaces exactly one advisory action per episode
    (plus one on recovery) and actuates nothing."""
    tier = ServeTier(max_bytes=1 << 20, pump_threads=1)
    clk = FakeClock()
    fleet = FleetAggregator(retention=4, stale_after_s=1e9, clock=clk)
    fleet.lag_spread_max = 4
    fleet.ingest("r0", _fleet_snap(1.0, **{"replica.r0.horizon": 10}))
    fleet.ingest("r1", _fleet_snap(1.0, **{"replica.r1.horizon": 0}))
    reg = MetricsRegistry()
    sampler = lambda now: {"graphs": {}, "ready_depth": 0,
                           "live_workers": tier.live_workers}
    cp = ControlPlane(tier, registry=reg, clock=clk, sampler=sampler,
                      fleet=fleet)
    a1 = cp.step(clk.advance(0.05))
    assert [a["kind"] for a in a1] == ["fleet_lag_spread"]
    assert a1[0]["advisory"] is True and a1[0]["lag_spread"] == 10
    assert cp.step(clk.advance(0.05)) == []  # still breached: no spam
    fleet.ingest("r1", _fleet_snap(2.0, **{"replica.r1.horizon": 9}))
    a2 = cp.step(clk.advance(0.05))
    assert [a["kind"] for a in a2] == ["fleet_lag_recovered"]
    assert cp.step(clk.advance(0.05)) == []
    assert reg.value("control.fleet_lag_breaches") == 1
    cp.stop()
    tier.close()
    fleet.close()


def test_control_plane_tolerates_fleet_snapshot_failure():
    """A port aggregator whose snapshot raises (its lock swapped for one
    that fails) degrades to no action, never an error."""
    class _Weather:
        def __enter__(self):
            raise RuntimeError("telemetry weather")

        def __exit__(self, *exc):
            return False

    tier = ServeTier(max_bytes=1 << 20, pump_threads=1)
    clk = FakeClock()
    fleet = FleetAggregator(retention=4, stale_after_s=5.0, clock=clk)
    fleet.ingest("r0", _fleet_snap(1.0, **{"replica.r0.horizon": 10}))
    fleet._lock = _Weather()
    cp = ControlPlane(tier, registry=MetricsRegistry(), clock=clk,
                      sampler=lambda now: {"graphs": {},
                                           "ready_depth": 0,
                                           "live_workers": 0},
                      fleet=fleet)
    assert cp.step(clk.advance(0.05)) == []  # loss tolerated
    assert cp.errors == 0
    cp.stop()
    tier.close()


class _FakeTier:
    _closed = False
    live_workers = 1
    pump_threads = 1

    def graphs(self):
        return {}

    def ensure_workers(self):
        return 0


class _FakeHub:
    def __init__(self):
        self.levels = []
        self.backlog = 0

    def load(self):
        return {"active": 7, "backlog_windows": self.backlog,
                "slowest_lag": 0, "shed_level": 0, "horizon": 5}

    def set_shed_level(self, level):
        self.levels.append(level)


def test_control_plane_sub_shed_ladder_steps_and_recovers(tmp_path):
    """A port ``SubscriptionHub`` (its fan-out thread unstarted, on a
    word-count replica) behind ``ControlPlane(subs=)``: a backlog of
    queued windows steps the hub's shed level to conflate, then pause;
    once the backlog clears, it recovers rung by rung."""
    g, _src, sink = wordcount.build_graph()
    rep = ReplicaScheduler(g, str(tmp_path / "r0"), name="r0")
    hub = SubscriptionHub(rep, name="r0", start=False)
    for _ in range(7):
        hub.subscribe(sink.name)
    levels = []
    set_level = hub.set_shed_level

    def record(level):
        levels.append(level)
        set_level(level)

    hub.set_shed_level = record
    cp = ControlPlane(
        _FakeTier(), registry=MetricsRegistry(),
        sampler=lambda now: {"graphs": {}, "ready_depth": 0,
                             "live_workers": 1},
        config=ControlConfig(sub_backlog_windows_max=4,
                             sub_breach_intervals=2,
                             sub_recover_intervals=2),
        subs=hub)
    now = 0.0

    def step():
        nonlocal now
        now += 0.05
        return cp.step(now)

    try:
        for h in range(10):                   # 10 queued windows
            hub.on_window(h, h + 1, ())
        assert hub.load()["backlog_windows"] == 10
        assert step() == []                   # hysteresis: 1st breach
        acts = step()                         # 2nd -> conflate
        assert [a["kind"] for a in acts] == ["sub_shed_step"]
        assert acts[0]["mode"] == "conflate" and acts[0]["level"] == 1
        assert acts[0]["active_subs"] == 7
        assert hub.shed_level == 1
        step()
        acts = step()                         # 2 more -> pause
        assert [a["kind"] for a in acts] == ["sub_shed_step"]
        assert acts[0]["mode"] == "pause" and cp.sub_shed_level == 2
        assert hub.shed_level == 2
        hub.rebase()                          # the backlog clears
        assert hub.load()["backlog_windows"] == 0
        step()
        acts = step()                         # recover one rung
        assert [a["kind"] for a in acts] == ["sub_shed_recover"]
        assert acts[0]["level"] == 1
        step()
        acts = step()
        assert acts[0]["level"] == 0 and cp.sub_shed_level == 0
        assert levels == [1, 2, 1, 0] and hub.shed_level == 0
    finally:
        hub.close()
        rep.close()


def test_control_plane_survives_hub_load_errors():
    class _Broken(_FakeHub):
        def load(self):
            raise RuntimeError("hub closing")

    cp = ControlPlane(
        _FakeTier(), registry=MetricsRegistry(),
        sampler=lambda now: {"graphs": {}, "ready_depth": 0,
                             "live_workers": 1},
        config=ControlConfig(sub_backlog_windows_max=1,
                             sub_breach_intervals=1),
        subs=_Broken())
    assert cp.step(0.05) == []                # tolerated, not fatal
    assert cp.sub_shed_level == 0


# -- the same state machines in both packages --------------------------------

def test_breaker_and_ladder_match_the_jax_package_step_for_step():
    """One seeded observation stream through both packages' ladder,
    breaker and autoscaler, on one fake clock: every transition, level,
    policy, backoff and target is the same."""
    import random

    from reflow_tpu.serve import control as jcontrol

    from reflow_tpu_torch.serve import control as pcontrol

    def run(mod):
        rng = random.Random(5)
        obs_rng = random.Random(9)
        lad = mod.BrownoutLadder("block", ("reject", "shed-oldest"),
                                 breach_intervals=2, recover_intervals=3)
        br = mod.CircuitBreaker(max_crashes=3, window_s=10.0,
                                backoff_s=0.1, backoff_max_s=2.0,
                                cooldown_s=1.0, cooldown_max_s=8.0,
                                probe_intervals=2, rng=rng.random)
        sc = mod.Autoscaler(min_workers=1, max_workers=4,
                            grow_intervals=2, shrink_intervals=3)
        trace = []
        t = 0.0
        workers = 2
        for _ in range(300):
            t += 0.25
            x = obs_rng.random()
            trace.append(("ladder", lad.observe(x < 0.5), lad.policy))
            if x < 0.2:
                trace.append(("crash", br.record_crash(t)))
            trace.append(("breaker", br.poll(t, healthy=x > 0.3),
                          br.state, br.respawn_delay(), br.opens))
            target = sc.observe(int(x * 10) % 5, workers)
            if target is not None:
                workers = target
            trace.append(("scale", target))
        return trace

    assert run(pcontrol) == run(jcontrol)
