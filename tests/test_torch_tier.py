"""The port's multi-graph serving tier (``reflow_tpu_torch.serve.tier``)
against ``tests/test_tier.py``, ``tests/test_shardserve.py``'s placement
tests and the JAX package, on the CPU.

Every test of ``tests/test_tier.py`` has a counterpart here: K pump
threads serving N graphs keep each graph equal to a bare loop and never
run one graph's window on two threads at once; the shared budget's floors
and ceilings isolate tenants; drain, unregister and a pump crash on one
graph leave its siblings ticking; a durable graph recovers exactly once;
the metrics round-trip through JSON. The ones that drive a graph run over
the port's CPU oracle (string keys) and over its ``"cuda"`` executor at
``device="cpu"`` (integer keys interned into one vocabulary).

The placement tests of ``tests/test_shardserve.py`` that need no mesh
have counterparts over the devices of the executor's kind: on the CPU
that is ``[cpu]``, so the test that spread lands distinct devices
monkeypatches the tier's device list with four CPU device names.

Beyond the reference: ``GraphHandle.device_label`` is the executor's
device name (``"cpu"`` here, ``"cuda:0"`` on one card; JAX's is None on
its default device), and ``summarize_tier`` shows it; the summary's JSON
has the same keys as the JAX package's; ``CudaExecutor.place`` keeps the
tables bit-equal across a move; and a small k-NN tenant on the ``"cuda"``
executor serves windows from the pool threads equal, bit for bit, to a
twin that takes the same batches outside the tier.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu_torch.executors.cpu import CpuExecutor
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.scheduler import DirtyScheduler
from reflow_tpu_torch.serve import (AdmissionBudget, CoalesceWindow,
                                    FrontendClosed, GraphConfig, GraphHandle,
                                    PumpCrashed, ServeTier, dwrr_pick)
from reflow_tpu_torch.serve import tier as tier_mod
from reflow_tpu_torch.utils.faults import CrashInjector
from reflow_tpu_torch.utils.metrics import (summarize_serve, summarize_tier,
                                            summarize_wal)
from reflow_tpu_torch.wal import DurableScheduler, WriteAheadLog, recover
from reflow_tpu_torch.workloads import knn as pknn
from reflow_tpu_torch.workloads import wordcount

from test_torch_megatick import K_SPACE, _batch, _exact, _small_graph

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


def executor():
    if _KIND[0] == "cuda":
        return P.get_executor("cuda", device="cpu")
    return CpuExecutor()


def make_graph():
    g, src, sink = wordcount.build_graph(
        KEY_SPACE if _KIND[0] == "cuda" else 0)
    return DirtyScheduler(g, executor()), src, sink


def lines_batch(*words: str):
    if _KIND[0] == "cuda":
        b = wordcount.ingest_lines([" ".join(words)], vocab=_VOCAB)
        assert len(_VOCAB) < KEY_SPACE
        return b
    return wordcount.ingest_lines([" ".join(words)])


def config(**kw):
    kw.setdefault("window", WINDOW)
    return GraphConfig(**kw)


def _durable(wal_dir):
    g, src, sink = wordcount.build_graph(
        KEY_SPACE if _KIND[0] == "cuda" else 0)
    return (DurableScheduler(g, executor(), wal_dir=wal_dir,
                             fsync="record"), src, sink)


# -- correctness across the pool --------------------------------------------

def test_multi_graph_differential_matches_bare_loops(kind):
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2)
    graphs = {}
    for i in range(3):
        sched, src, sink = make_graph()
        h = tier.register(f"g{i}", sched, config())
        graphs[f"g{i}"] = (h, sched, src, sink)
    payload = lambda g, p, j: lines_batch(f"{g}w{p}", f"w{(p + j) % 5}")

    def produce(name, p):
        h, _sched, src, _sink = graphs[name]
        for j in range(20):
            r = h.submit(src, payload(name, p, j)).result(timeout=10)
            assert r.applied

    threads = [threading.Thread(target=produce, args=(n, p))
               for n in graphs for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (h, sched, src, sink) in graphs.items():
        h.flush(timeout=10)
        want_sched, want_src, want_sink = make_graph()
        for p in range(2):
            for j in range(20):
                want_sched.push(want_src, payload(name, p, j))
                want_sched.tick()
        assert dict(sched.view(sink.name)) == dict(
            want_sched.view(want_sink.name))
        # the oracle never syncs; a device executor reads the sink back
        # once a tick, as the JAX TpuExecutor does on this graph
        assert sched.forced_syncs == (0 if kind == "cpu" else sched._tick)
    tier.close()


def test_single_owner_latch_never_interleaves_one_graph(kind):
    # wrap each scheduler's tick_many in a non-blocking per-graph mutex:
    # if the pool ever ran one graph's macro-tick concurrently with
    # itself, acquire(blocking=False) fails and the window crashes loud
    tier = ServeTier(max_bytes=8 << 20, pump_threads=4)
    graphs, violations = {}, []
    for i in range(3):
        sched, src, sink = make_graph()
        owner = threading.Lock()
        real = sched.tick_many

        def guarded(feeds, *a, owner=owner, real=real, **kw):
            if not owner.acquire(blocking=False):
                violations.append("concurrent tick_many on one graph")
                raise AssertionError(violations[-1])
            try:
                time.sleep(0.001)  # widen the race window
                return real(feeds, *a, **kw)
            finally:
                owner.release()

        sched.tick_many = guarded
        h = tier.register(f"g{i}", sched, config())
        graphs[f"g{i}"] = (h, src)

    def produce(name, p):
        h, src = graphs[name]
        for j in range(15):
            h.submit(src, lines_batch(f"{name}p{p}j{j}"))

    threads = [threading.Thread(target=produce, args=(n, p))
               for n in graphs for p in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for h, _src in graphs.values():
        h.flush(timeout=10)
    tier.close()
    assert not violations


# -- shared budget: floors and ceilings -------------------------------------

def test_ceiling_caps_hot_graph_while_floored_sibling_admits(kind):
    tier = ServeTier(max_bytes=4096, pump_threads=2)
    hot_sched, hot_src, _ = make_graph()
    hot = tier.register("hot", hot_sched, config(
        policy="reject", ceiling_bytes=1024))
    quiet_sched, quiet_src, _ = make_graph()
    quiet = tier.register("quiet", quiet_sched, config(floor_bytes=1024))
    hot.frontend.pause()
    quiet.frontend.pause()
    # fill the hot graph to its ceiling: admissions then REJECT even
    # though the tier-wide budget still has room
    hot_results = []
    for j in range(4096):
        t = hot.submit(hot_src, lines_batch(f"h{j}", "x", "y"))
        if t.done() and t.result().status == "rejected":
            hot_results.append(t.result())
            break
    assert hot_results, "hot graph never hit its ceiling"
    assert "exceeds" not in (hot_results[0].reason or "")
    share = tier.budget.shares()["hot"]
    assert share.used <= 1024 < tier.budget.total_bytes
    # the floored sibling still admits instantly (block policy, but
    # room is guaranteed by its reservation)
    t = quiet.submit(quiet_src, lines_batch("q"), timeout=0.5)
    assert not t.done()  # queued (pump paused), not rejected
    quiet.frontend.resume()
    hot.frontend.resume()
    assert t.result(timeout=10).applied
    tier.close()


def test_budget_floor_validation():
    tier = ServeTier(max_bytes=1000, pump_threads=1)
    s1, *_ = make_graph()
    tier.register("a", s1, config(floor_bytes=700))
    s2, *_ = make_graph()
    with pytest.raises(ValueError, match="not reservable"):
        tier.register("b", s2, config(floor_bytes=400))
    with pytest.raises(ValueError, match="floor <= ceiling"):
        AdmissionBudget(1000).register("c", floor=500, ceiling=400)
    with pytest.raises(ValueError, match="exceeds"):
        AdmissionBudget(1000).register("d", ceiling=2000)
    tier.close()


def test_register_validation_and_close_refusal():
    tier = ServeTier(max_bytes=4096, pump_threads=1)
    sched, *_ = make_graph()
    tier.register("a", sched, config())
    dup, *_ = make_graph()
    with pytest.raises(ValueError, match="already registered"):
        tier.register("a", dup, config())
    bad, *_ = make_graph()
    with pytest.raises(ValueError, match="weight"):
        tier.register("b", bad, config(weight=0))
    tier.close()
    late, *_ = make_graph()
    with pytest.raises(GraphError, match="closed"):
        tier.register("late", late, config())
    with pytest.raises(KeyError):
        tier.unregister("never-there")


# -- DWRR scheduling ---------------------------------------------------------

def test_dwrr_pick_serves_proportionally_to_weight():
    tier = ServeTier(max_bytes=1 << 20, pump_threads=1)
    a = GraphHandle(tier, "a", None, GraphConfig(weight=3.0))
    b = GraphHandle(tier, "b", None, GraphConfig(weight=1.0))
    served = {"a": 0, "b": 0}
    for _ in range(400):
        h = dwrr_pick([a, b], quantum_rows=100)
        served[h.name] += 100
        h._deficit -= 100  # the pool charges rows served
    assert served["a"] / served["b"] == pytest.approx(3.0, rel=0.1)
    tier.close()


def test_dwrr_ignores_absent_graphs():
    tier = ServeTier(max_bytes=1 << 20, pump_threads=1)
    a = GraphHandle(tier, "a", None, GraphConfig(weight=1.0))
    b = GraphHandle(tier, "b", None, GraphConfig(weight=100.0))
    # b is never ready: only a is offered, so only a is replenished —
    # b cannot accumulate deficit in absentia and then starve a
    for _ in range(50):
        assert dwrr_pick([a], quantum_rows=10) is a
        a._deficit -= 10
    assert b._deficit == 0.0
    tier.close()


# -- lifecycle: per-graph vs tier-wide --------------------------------------

def test_unregister_releases_blocked_producers_and_spares_siblings(kind):
    tier = ServeTier(max_bytes=1 << 20, pump_threads=2)
    vic_sched, vic_src, _ = make_graph()
    victim = tier.register("victim", vic_sched, config(
        ceiling_bytes=256))
    sib_sched, sib_src, sib_sink = make_graph()
    sib = tier.register("sib", sib_sched, config())
    victim.frontend.pause()
    # saturate the victim's tiny ceiling so the NEXT submit blocks:
    # stop while there is still room, the blocked thread takes the
    # first admission that does not fit
    from reflow_tpu_torch.serve import batch_nbytes
    probe = batch_nbytes(lines_batch("v", "w", "x"))
    share = tier.budget.shares()["victim"]
    while share.room_for(probe):
        victim.submit(vic_src, lines_batch("v", "w", "x"))
    blocked_err = []

    def blocked():
        try:
            victim.submit(vic_src, lines_batch("blocked", "b", "c"))
        except FrontendClosed as e:
            blocked_err.append(e)

    th = threading.Thread(target=blocked)
    th.start()
    time.sleep(0.05)
    assert th.is_alive(), "producer should be blocked on admission"
    tier.unregister("victim", flush=False, timeout=10)
    th.join(timeout=5)
    assert not th.is_alive() and blocked_err
    assert "victim" not in tier.graphs()
    assert "victim" not in tier.budget.shares()
    # the sibling never noticed
    r = sib.submit(sib_src, lines_batch("still", "alive")).result(10)
    assert r.applied
    tier.close()


def test_tier_drain_quiesces_one_graph_while_sibling_ticks(kind):
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2)
    a_sched, a_src, a_sink = make_graph()
    a = tier.register("a", a_sched, config())
    b_sched, b_src, _ = make_graph()
    b = tier.register("b", b_sched, config())
    for j in range(10):
        a.submit(a_src, lines_batch(f"a{j}"))
    ticks = tier.drain("a")
    assert ticks >= 1
    assert a_sched.quiescent() if hasattr(a_sched, "quiescent") else True
    assert dict(a_sched.view(a_sink.name))  # backlog landed
    r = b.submit(b_src, lines_batch("b-live")).result(10)
    assert r.applied
    tier.close()


def test_tier_close_is_idempotent_and_final(kind):
    tier = ServeTier(max_bytes=1 << 20, pump_threads=2)
    sched, src, sink = make_graph()
    h = tier.register("g", sched, config())
    tks = [h.submit(src, lines_batch(f"w{j}")) for j in range(25)]
    tier.close()
    assert all(t.result(timeout=5).applied for t in tks)
    assert dict(sched.view(sink.name))
    tier.close()  # idempotent
    with pytest.raises(FrontendClosed):
        h.submit(src, lines_batch("late"))


# -- pump-pool crash isolation ----------------------------------------------

def test_pool_crash_fails_only_the_latched_graph(kind):
    crash = CrashInjector(at=1, only="pool_window@doomed")
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2, crash=crash)
    d_sched, d_src, _ = make_graph()
    doomed = tier.register("doomed", d_sched, config())
    s_sched, s_src, _ = make_graph()
    sib = tier.register("sib", s_sched, config())
    assert sib.submit(s_src, lines_batch("before")).result(10).applied
    tks = []
    for j in range(10):
        try:
            tks.append(doomed.submit(d_src, lines_batch(f"d{j}")))
        except FrontendClosed:
            break  # the crash already landed mid-loop
    statuses = {"crashed": 0, "applied": 0}
    for t in tks:
        try:
            t.result(timeout=10)
            statuses["applied"] += 1
        except PumpCrashed:
            statuses["crashed"] += 1
    assert crash.fired and crash.fired_seam == "pool_window@doomed"
    assert statuses["crashed"] > 0
    assert tier.pool_crashes == 1
    assert doomed.frontend._state == "failed"
    # both workers outlived the crash: the sibling still applies
    for j in range(5):
        assert sib.submit(
            s_src, lines_batch(f"after{j}")).result(10).applied
    with pytest.raises(FrontendClosed):
        doomed.submit(d_src, lines_batch("dead"))
    tier.unregister("doomed", flush=False)
    tier.close()


def test_scoped_pump_seam_crashes_one_graph_mid_window(kind):
    crash = CrashInjector(at=1, only="pump_before_tick@doomed")
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2, crash=crash)
    d_sched, d_src, _ = make_graph()
    doomed = tier.register("doomed", d_sched, config())
    s_sched, s_src, _ = make_graph()
    sib = tier.register("sib", s_sched, config())
    t = doomed.submit(d_src, lines_batch("x"))
    with pytest.raises(PumpCrashed):
        t.result(timeout=10)
    assert crash.fired_seam == "pump_before_tick@doomed"
    assert sib.submit(s_src, lines_batch("fine")).result(10).applied
    tier.unregister("doomed", flush=False)
    tier.close()


def test_durable_graph_in_tier_recovers_exactly_once(tmp_path, kind):
    wal_dir = str(tmp_path / "wal")
    crash = CrashInjector(at=2, only="pump_before_tick@wal")
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2, crash=crash)
    dsched, src, sink = _durable(wal_dir)
    h = tier.register("wal", dsched, config())
    sent = [(f"m{j}", lines_batch(f"w{j % 4}", "c")) for j in range(30)]
    tks = []
    for bid, batch in sent:
        try:
            tks.append(h.submit(src, batch, batch_id=bid))
        except FrontendClosed:
            break
        time.sleep(0.001)  # several windows
    crashed = 0
    for t in tks:
        try:
            t.result(timeout=10)
        except PumpCrashed:
            crashed += 1
    assert crash.fired and crashed > 0
    tier.unregister("wal", flush=False)
    tier.close()

    # recover into a fresh tier and re-send EVERY id: exactly-once
    rsched, src2, sink2 = _durable(wal_dir)
    recover(rsched, wal_dir)
    tier2 = ServeTier(max_bytes=8 << 20, pump_threads=2)
    h2 = tier2.register("wal", rsched, config())
    results = [h2.submit(src2, batch, batch_id=bid).result(10)
               for bid, batch in sent]
    h2.flush(timeout=10)
    assert any(r.status == "deduped" for r in results)
    want_sched, want_src, want_sink = make_graph()
    for _bid, batch in sent:
        want_sched.push(want_src, batch)
        want_sched.tick()
    assert dict(rsched.view(sink2.name)) == dict(
        want_sched.view(want_sink.name))
    tier2.close()


# -- metrics -----------------------------------------------------------------

def test_tier_metrics_and_json_round_trip(tmp_path, kind):
    tier = ServeTier(max_bytes=1 << 20, pump_threads=2)
    sched, src, sink = make_graph()
    h = tier.register("g", sched, config(weight=2.0, floor_bytes=1024))
    for j in range(20):
        h.submit(src, lines_batch(f"w{j % 3}")).result(10)
    h.flush(timeout=10)
    tm = summarize_tier(tier)
    assert tm.graphs == 1 and tm.pump_threads == 2
    assert tm.windows >= 1 and tm.pool_crashes == 0
    assert 0.0 <= tm.pump_utilization <= 1.0
    assert tm.budget_total_bytes == 1 << 20
    assert tm.budget_peak_bytes > 0
    g = tm.per_graph["g"]
    assert g["weight"] == 2.0 and g["floor_bytes"] == 1024
    assert g["applied"] == 20 and g["state"] == "running"
    assert g["windows"] >= 1 and g["rows_applied"] > 0
    # every export survives json round-trip (numpy scalars coerced)
    for payload in (tm.to_dict(), summarize_serve(h.frontend).to_dict()):
        assert json.loads(json.dumps(payload)) == payload
    wal = WriteAheadLog(str(tmp_path), fsync="record")
    wal.append({"kind": "tick", "tick": 0})
    wal.close()
    wm = summarize_wal(wal).to_dict()
    assert json.loads(json.dumps(wm)) == wm
    tier.close()


# -- tenant placement (tests/test_shardserve.py, the tests with no mesh) ----

PWINDOW = CoalesceWindow(max_rows=256, max_ticks=8, max_latency_s=0.002)


def _cuda_small():
    g, (s0, s1), r = _small_graph()
    return DirtyScheduler(g, P.get_executor("cuda", device="cpu")), s0, r


def _cpu_names(n):
    return lambda ex: [torch.device("cpu", i) for i in range(n)]


def test_spread_placement_lands_distinct_devices(monkeypatch):
    """placement="spread" round-robins tenants over the devices of the
    executor's kind (four CPU device names here); each tenant's table
    still matches a bare per-tick loop."""
    monkeypatch.setattr(tier_mod, "_placement_devices", _cpu_names(4))
    n = 4
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2)
    handles = []
    try:
        for i in range(n):
            sched, src, r = _cuda_small()
            h = tier.register(
                f"g{i}", sched,
                GraphConfig(window=PWINDOW, placement="spread"))
            handles.append((h, sched, src, r))
        labels = [h.device_label for h, *_ in handles]
        assert labels == [f"cpu:{i}" for i in range(n)]
        for i, (h, sched, src, r) in enumerate(handles):
            for j in range(4):
                assert h.submit(src, _batch(
                    P, [(j, float(i + 1), 1)])).result(10).applied
            h.flush(timeout=10)
            want = {j: float(2 * (i + 1)) for j in range(4)}  # map doubles
            assert _exact(sched, r) == want
    finally:
        tier.close()


def test_spread_on_the_cpu_lands_every_tenant_on_cpu():
    """With the real device list a CPU executor's kind has one device:
    spread puts every tenant there (on one card: every tenant on
    cuda:0)."""
    tier = ServeTier(max_bytes=8 << 20, pump_threads=1)
    try:
        labels = []
        for i in range(3):
            sched, _src, _r = _cuda_small()
            labels.append(tier.register(
                f"g{i}", sched, GraphConfig(window=PWINDOW,
                                            placement="spread")
            ).device_label)
        assert labels == ["cpu"] * 3
    finally:
        tier.close()


def test_device_alone_implies_pin():
    tier = ServeTier(max_bytes=8 << 20, pump_threads=1)
    try:
        sched, src, r = _cuda_small()
        dev = torch.device("cpu")
        h = tier.register("pin", sched, GraphConfig(window=PWINDOW,
                                                    device=dev))
        assert h.device_label == "cpu"
        assert h.submit(src, _batch(P, [(1, 3.0, 1)])).result(10).applied
        h.flush(timeout=10)
        assert _exact(sched, r) == {1: 6.0}
    finally:
        tier.close()


def test_pin_accepts_device_index(monkeypatch):
    """Integer device= pins by position in the device list."""
    monkeypatch.setattr(tier_mod, "_placement_devices", _cpu_names(2))
    tier = ServeTier(max_bytes=8 << 20, pump_threads=1)
    try:
        sched, _src, _r = _cuda_small()
        h = tier.register("byix", sched,
                          GraphConfig(window=PWINDOW, placement="pin",
                                      device=1))
        assert h.device_label == "cpu:1"
        assert sched.executor.device == torch.device("cpu", 1)
    finally:
        tier.close()


def test_placement_validation_errors():
    tier = ServeTier(max_bytes=8 << 20, pump_threads=1)
    try:
        sched, _s, _r = _cuda_small()
        with pytest.raises(ValueError, match="placement"):
            tier.register("bad", sched,
                          GraphConfig(window=PWINDOW, placement="stripe"))
        with pytest.raises(ValueError, match="device"):
            tier.register("bad", sched,
                          GraphConfig(window=PWINDOW, placement="pin"))
        # an executor with no placement hook refuses loudly, not silently
        g, (_s0, _s1), _r2 = _small_graph()
        cpu_sched = DirtyScheduler(g, CpuExecutor())
        with pytest.raises(GraphError, match="place"):
            tier.register("cpu", cpu_sched,
                          GraphConfig(window=PWINDOW, placement="spread"))
        assert "bad" not in tier.graphs()
        assert "cpu" not in tier.graphs()
    finally:
        tier.close()


def test_pinned_crash_isolates_to_its_device_tenant(monkeypatch):
    """A pump crash on a pinned tenant leaves the sibling (pinned to a
    different device) applying: placement does not widen the blast
    radius of the crash-isolation contract."""
    monkeypatch.setattr(tier_mod, "_placement_devices", _cpu_names(2))
    crash = CrashInjector(at=1, only="pump_before_tick@doomed")
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2, crash=crash)
    try:
        d_sched, d_src, _ = _cuda_small()
        doomed = tier.register("doomed", d_sched,
                               GraphConfig(window=PWINDOW, device=0))
        s_sched, s_src, s_r = _cuda_small()
        sib = tier.register("sib", s_sched,
                            GraphConfig(window=PWINDOW, device=1))
        assert doomed.device_label != sib.device_label
        t = doomed.submit(d_src, _batch(P, [(1, 1.0, 1)]))
        with pytest.raises(PumpCrashed):
            t.result(timeout=10)
        assert crash.fired_seam == "pump_before_tick@doomed"
        assert sib.submit(s_src, _batch(P, [(2, 4.0, 1)])).result(
            10).applied
        sib.flush(timeout=10)
        assert _exact(s_sched, s_r) == {2: 8.0}
        tier.unregister("doomed", flush=False)
    finally:
        tier.close()


def _ticks(seed, n_ticks=4, rows=6):
    rng = np.random.default_rng(seed)
    return [{0: [(int(rng.integers(0, K_SPACE)),
                  float(rng.integers(0, 8)), 1) for _ in range(rows)],
             1: [(int(rng.integers(0, K_SPACE)),
                  float(rng.integers(0, 8)), 1) for _ in range(rows)]}
            for _ in range(n_ticks)]


def _drive(sched, srcs, ticks):
    res = sched.tick_many([{srcs[ix]: _batch(P, rows)
                            for ix, rows in t.items()} for t in ticks])
    res.block()


def test_placed_executor_runs_windows_on_its_device():
    """Direct executor-level check: place() moves state and the window
    path onto the chosen device, tables unchanged."""
    ticks = _ticks(17)
    g, (s0, s1), r = _small_graph()
    ex = P.get_executor("cuda", device="cpu")
    ex.place(len(tier_mod._placement_devices(ex)) - 1)
    sched = DirtyScheduler(g, ex)
    _drive(sched, {0: s0, 1: s1}, ticks)
    og, (o0, o1), orr = _small_graph()
    oracle = DirtyScheduler(og, CpuExecutor())
    for t in ticks:
        for ix, rows in t.items():
            oracle.push((o0, o1)[ix], _batch(P, rows))
        oracle.tick()
    assert _exact(sched, r) == {k: float(v) for k, v in
                                oracle.read_table(orr).items()}
    assert sched.megatick_fallbacks == 0
    assert ex.device_label == "cpu"
    for st in ex.states.values():
        for leaf in st.values():
            assert leaf.device.type == "cpu"


# -- CudaExecutor.place ------------------------------------------------------

def test_place_keeps_tables_bit_equal_across_a_move():
    """A move between windows keeps every table bit-equal to an unmoved
    twin's, drops the window cache (its queues hold the old device's
    slots) and rebuilds it on the next window; nested Map params move
    with the state."""
    ticks = _ticks(23, n_ticks=8)
    g, (s0, s1), r = _small_graph()
    sched = DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    tg, (t0, t1), tr = _small_graph()
    twin = DirtyScheduler(tg, P.get_executor("cuda", device="cpu"))
    _drive(sched, {0: s0, 1: s1}, ticks[:4])
    _drive(twin, {0: t0, 1: t1}, ticks[:4])
    ex = sched.executor
    assert ex._window_cache
    ex.place("cpu:1")
    assert ex.device == torch.device("cpu", 1)
    assert ex.device_label == "cpu:1"
    assert not ex._window_cache and not ex._csr_cache
    assert _exact(sched, r) == _exact(twin, tr)
    _drive(sched, {0: s0, 1: s1}, ticks[4:])
    _drive(twin, {0: t0, 1: t1}, ticks[4:])
    assert _exact(sched, r) == _exact(twin, tr)
    assert ex._window_cache and sched.megatick_fallbacks == 0

    # a Map's nested params tree moves leaf by leaf
    pg = P.FlowGraph("params")
    src = pg.source("s", P.Spec((2,), np.float32, key_space=8))
    params = {"w": np.eye(2, dtype=np.float32),
              "blocks": [{"b": np.ones(2, np.float32)}]}
    m = pg.map(src, lambda p, v: v @ p["w"] + p["blocks"][0]["b"],
               vectorized=True, params=params)
    red = pg.reduce(m, "sum", tol=0.0)
    psched = DirtyScheduler(pg, P.get_executor("cuda", device="cpu"))
    batch = P.DeltaBatch(np.array([1, 2], np.int64),
                         np.array([[1, 2], [3, 4]], np.float32))
    psched.push(src, batch)
    psched.tick()
    before = {k: np.asarray(v) for k, v in psched.read_table(red).items()}
    psched.executor.place(0)
    leaves = psched.executor.states[m.id]["params"]
    assert leaves["blocks"][0]["b"].dtype == torch.float32
    psched.push(src, batch)
    psched.tick()
    after = psched.read_table(red)
    for k in before:
        np.testing.assert_array_equal(np.asarray(after[k]), 2 * before[k])


def test_place_names_no_card_raises():
    """A CUDA device with no card raises; the executor stays where it
    was and never drops to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    ex = P.get_executor("cuda", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.place("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.place(torch.device("cuda"))
    assert ex.device == torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_place_moves_card_state_to_the_cpu_and_back(cuda_device):
    """On a card: a move to the CPU and back keeps the tables bit-equal
    to an unmoved twin on the card."""
    ticks = _ticks(29, n_ticks=6)
    g, (s0, s1), r = _small_graph()
    sched = DirtyScheduler(g, P.get_executor("cuda", device=cuda_device))
    tg, (t0, t1), tr = _small_graph()
    twin = DirtyScheduler(tg, P.get_executor("cuda", device=cuda_device))
    for lo, dev in ((0, "cpu"), (2, cuda_device), (4, None)):
        _drive(sched, {0: s0, 1: s1}, ticks[lo:lo + 2])
        _drive(twin, {0: t0, 1: t1}, ticks[lo:lo + 2])
        assert _exact(sched, r) == _exact(twin, tr)
        if dev is not None:
            sched.executor.place(dev)


# -- the device label and the summary ---------------------------------------

def test_device_label_is_the_executor_device_in_the_summary():
    """The port pins ``device_label`` to the executor's device name
    ("cpu" here, "cuda:0" on one card), and ``summarize_tier`` carries
    it; the CPU oracle has no device (None, as JAX's default device)."""
    tier = ServeTier(max_bytes=1 << 20, pump_threads=1)
    try:
        _KIND[0] = "cuda"
        s1, src1, _ = make_graph()
        _KIND[0] = "cpu"
        s2, src2, _ = make_graph()
        h1 = tier.register("dev", s1, config())
        h2 = tier.register("oracle", s2, config())
        assert h1.device_label == "cpu" and h2.device_label is None
        _KIND[0] = "cuda"
        assert h1.submit(src1, lines_batch("a")).result(10).applied
        _KIND[0] = "cpu"
        assert h2.submit(src2, lines_batch("a")).result(10).applied
        per = summarize_tier(tier).to_dict()["per_graph"]
        assert per["dev"]["device"] == "cpu"
        assert per["oracle"]["device"] is None
    finally:
        _KIND[0] = "cpu"
        tier.close()


def test_summarize_tier_json_has_the_jax_keys():
    """The same tier, graphs and traffic in both packages: the summary's
    JSON has the same keys, nested per graph, and the same counts; the
    device field differs only as pinned (None on JAX's default device,
    the device name in the port)."""
    from reflow_tpu import DirtyScheduler as JDirty
    from reflow_tpu.executors import get_executor as jget
    from reflow_tpu.serve import GraphConfig as JGraphConfig
    from reflow_tpu.serve import ServeTier as JServeTier
    from reflow_tpu.utils.metrics import summarize_tier as jsummarize
    from reflow_tpu.workloads import wordcount as jwc

    out = {}
    for pkg in ("jax", "port"):
        tier = (JServeTier if pkg == "jax" else ServeTier)(
            max_bytes=1 << 20, pump_threads=2)
        wc = jwc if pkg == "jax" else wordcount
        g, src, _sink = wc.build_graph(64)
        sched = (JDirty(g, jget("tpu")) if pkg == "jax" else
                 DirtyScheduler(g, P.get_executor("cuda", device="cpu")))
        h = tier.register("g", sched, (JGraphConfig if pkg == "jax"
                                       else GraphConfig)(
            weight=2.0, floor_bytes=1024, window=WINDOW))
        vocab = {}
        for j in range(6):
            b = wc.ingest_lines([f"w{j % 3} x"], vocab=vocab)
            assert h.submit(src, b).result(10).applied
        h.flush(timeout=10)
        d = (jsummarize if pkg == "jax" else summarize_tier)(tier).to_dict()
        assert json.loads(json.dumps(d)) == d
        out[pkg] = d
        tier.close()
    j, p = out["jax"], out["port"]
    assert set(j) == set(p)
    assert set(j["per_graph"]["g"]) == set(p["per_graph"]["g"])
    assert j["per_graph"]["g"]["device"] is None
    assert p["per_graph"]["g"]["device"] == "cpu"
    for key in ("applied", "weight", "floor_bytes", "state", "policy"):
        assert j["per_graph"]["g"][key] == p["per_graph"]["g"][key], key


# -- a k-NN tenant on the cuda executor ---------------------------------------

KQ, KD, KDIM, KK, KCHUNK = 8, 384, 16, 4, 128


def _knn_items(seed=3):
    rng = np.random.default_rng(seed)

    def b(keys, vals, w=1):
        keys = np.asarray(keys, np.int64)
        return P.DeltaBatch(keys, vals, np.full(len(keys), w, np.int64))

    def vecs(n):
        return rng.standard_normal((n, KDIM)).astype(np.float32)

    items = [("q0", "q", b(np.arange(KQ), vecs(KQ)))]
    items += [(f"pre{i}", "d", b(np.arange(i, i + 64), vecs(64)))
              for i in range(0, 192, 64)]
    items += [(f"ins{i}", "d", b(np.arange(i, i + 32), vecs(32)))
              for i in range(192, 320, 32)]
    items.append(("ret0", "d", b(np.arange(200, 210),
                                 np.zeros((10, KDIM), np.float32), -1)))
    items.append(("qup0", "q", b(np.arange(3), vecs(3))))
    return items


def _knn_table(sched, kg):
    return {int(q): np.asarray(r, np.float32)
            for q, r in sched.read_table(kg.index).items()}


def test_knn_tenant_on_pool_threads_equals_its_twin(tmp_path):
    """A durable k-NN tenant on the cuda executor shares a two-thread pool
    with a word-count sibling; each batch is acknowledged before the next
    goes, so each is one window on whichever pool thread picks it. After
    every acknowledged tick the table equals, bit for bit, a twin that
    ticks the same batches outside the tier."""
    kg, tg = (pknn.build_graph(KQ, KD, KDIM, KK, scan_chunk=KCHUNK)
              for _ in range(2))
    sched = DurableScheduler(kg.graph, P.get_executor("cuda", device="cpu"),
                             wal_dir=str(tmp_path / "wal"), fsync="tick",
                             committer="thread")
    twin = DirtyScheduler(tg.graph, P.get_executor("cuda", device="cpu"))
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2)
    try:
        h = tier.register("knn", sched, config())
        _KIND[0] = "cuda"
        wsched, wsrc, _ = make_graph()
        w = tier.register("wc", wsched, config())
        threads = set()
        ex = sched.executor
        for meth in ("dispatch_window", "run_pass"):
            def spy(*a, _real=getattr(ex, meth), **kw):
                threads.add(threading.get_ident())
                return _real(*a, **kw)

            setattr(ex, meth, spy)
        for bid, s, batch in _knn_items():
            w.submit(wsrc, lines_batch(bid))
            res = h.submit(kg.queries if s == "q" else kg.docs, batch,
                           batch_id=bid).result(10)
            assert res.applied and res.lsn is not None
            twin.push(tg.queries if s == "q" else tg.docs, batch)
            twin.tick()
            got, want = _knn_table(sched, kg), _knn_table(twin, tg)
            assert got.keys() == want.keys()
            for q in want:
                np.testing.assert_array_equal(got[q], want[q])
        assert sched._tick == twin._tick
        assert threads and threading.get_ident() not in threads
        assert sched.megatick_windows >= 1
    finally:
        _KIND[0] = "cpu"
        tier.close()
