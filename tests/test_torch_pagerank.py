"""The port's PageRank slice against the JAX package, the CPU oracle and
the float64 power iteration, on the CPU.

The same web graph and churn, made from one numpy seed by both packages'
``WebGraph``, run through the initial tick and three 1% churn ticks on
the port's ``cuda`` executor (``device="cpu"``: its plain PyTorch path),
both on the scheduler's host-driven loop (``fixpoint=False``) and on the
executor's default, the fused delta-vector loop. Tolerances, as
``max|Δ| / max(ref, 1)``:

- against the JAX ``TpuExecutor(fixpoint=False)`` (the same host-driven
  algorithm): 2e-4, twice tol — a float-order difference can flip one
  emit decision at the tol boundary;
- against the JAX default (the fused delta-vector loop), the float64
  ``reference_ranks`` and the port's ``CpuExecutor``: 1e-3.

The deferred mode (``defer_passes``) mirrors ``tests/test_pagerank.py``'s
bounds: drained error under 5e-4, mid-stream error under 0.2.
"""

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.executors.device_delta import bucket_capacity
from reflow_tpu.executors.tpu import TpuExecutor
from reflow_tpu.workloads import pagerank as jpr
from reflow_tpu_torch.convert import states_from_jax, states_to_numpy
from reflow_tpu_torch.executors.linear_fixpoint import LinearFixpointProgram
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.workloads import pagerank as ppr

N, E, CHURN, TOL, SEED = 2000, 20000, 0.01, 1e-4, 7


def _arena(n_edges, churn):
    """The arena bench.py sizes for the full-width run: live rows plus
    eight churn ticks of headroom."""
    return (bucket_capacity(n_edges)
            + 8 * bucket_capacity(2 * int(churn * n_edges) + 2))


def run(pkg, n=N, e=E, churn_ticks=3, seed=SEED):
    """Initial tick + ``churn_ticks`` churn ticks -> (ranks, passes per
    tick, scheduler, web graph, graph)."""
    mod = jpr if pkg.startswith("jax") else ppr
    web = mod.WebGraph.random(n, e, seed=seed)
    pg = mod.build_graph(n, tol=TOL, arena_capacity=_arena(e, CHURN))
    if pkg == "jax":
        sched = JDirtyScheduler(pg.graph, TpuExecutor(fixpoint=False))
    elif pkg == "jax_fused":
        sched = JDirtyScheduler(pg.graph, jget_executor("tpu"))
    else:
        ex = {"port": lambda: host_loop(),
              "port_fused": lambda: P.get_executor("cuda", device="cpu"),
              "cpu": P.CpuExecutor}[pkg]()
        sched = P.DirtyScheduler(pg.graph, ex)
    sched.push(pg.teleport, mod.teleport_batch(n))
    sched.push(pg.edges, web.initial_batch())
    passes = [sched.tick().passes]
    for _ in range(churn_ticks):
        sched.push(pg.edges, web.churn(CHURN))
        r = sched.tick()
        assert r.quiesced
        passes.append(r.passes)
    ranks = mod.ranks_to_array(sched.read_table(pg.new_rank), n)
    return ranks, passes, sched, web, pg


def host_loop():
    """The port's executor with the scheduler driving the passes."""
    return P.get_executor("cuda", device="cpu", fixpoint=False)


def rel_err(a, ref):
    return float(np.max(np.abs(a - ref) / np.maximum(ref, 1.0)))


@pytest.fixture(scope="module")
def port_run():
    return run("port")


def test_same_seed_same_graph_and_churn():
    jw = jpr.WebGraph.random(500, 4000, seed=SEED)
    pw = ppr.WebGraph.random(500, 4000, seed=SEED)
    np.testing.assert_array_equal(jw.src, pw.src)
    np.testing.assert_array_equal(jw.dst, pw.dst)
    for _ in range(3):
        jb, pb = jw.churn(CHURN), pw.churn(CHURN)
        np.testing.assert_array_equal(jb.keys, pb.keys)
        np.testing.assert_array_equal(jb.values, pb.values)
        np.testing.assert_array_equal(jb.weights, pb.weights)
    t1, t2 = jpr.teleport_batch(500), ppr.teleport_batch(500)
    np.testing.assert_array_equal(t1.values, t2.values)
    np.testing.assert_array_equal(jpr.reference_ranks(jw),
                                  ppr.reference_ranks(pw))


def test_port_matches_jax_host_driven(port_run):
    ranks, passes, _, _, _ = port_run
    jranks, jpasses, _, _, _ = run("jax")
    err = rel_err(ranks, jranks)
    assert err <= 2 * TOL, (err, passes, jpasses)


def test_port_matches_fused_loop_and_reference(port_run):
    ranks, passes, _, web, _ = port_run
    fused, _, _, _, _ = run("jax_fused")
    assert rel_err(ranks, fused) <= 1e-3
    ref = ppr.reference_ranks(web)
    assert rel_err(ranks, ref) <= 1e-3, passes


def test_port_matches_cpu_oracle():
    """The CPU oracle (dict multisets, per-row Python) at a smaller size."""
    ranks, passes, _, web, _ = run("port", n=300, e=2000)
    oracle, opasses, _, _, _ = run("cpu", n=300, e=2000)
    assert rel_err(ranks, oracle) <= 1e-3, (passes, opasses)
    assert rel_err(ranks, ppr.reference_ranks(web)) <= 1e-3


def test_passes_and_forced_syncs_per_tick(port_run):
    """Every tick iterates the loop to quiescence; each tick forces two
    syncs (the tick's error check and the Join's compact-or-not readback
    before its edge append) and the rank read one more. The per-pass
    quiescence readback is the scheduler's own, not a forced sync."""
    _, passes, sched, _, pg = port_run
    assert passes[0] > passes[1] > 1 and all(p > 1 for p in passes)
    assert sched.executor.host_syncs == len(passes)
    assert sched.forced_syncs == 2 * len(passes) + 1
    st = sched.executor.states[pg.join.id]
    assert int(st["rcount"]) == E + 3 * 2 * int(CHURN * E)
    assert not bool(st["error"])


def test_state_carried_from_jax_then_one_churn_tick():
    """The JAX state after the initial tick, carried into the port through
    ``states_from_jax``; one churn tick in both; the ranks and every
    state array agree (integers exactly)."""
    n, e = 1000, 10000
    jweb = jpr.WebGraph.random(n, e, seed=3)
    pweb = ppr.WebGraph.random(n, e, seed=3)
    arena = _arena(e, CHURN)
    jpg = jpr.build_graph(n, tol=TOL, arena_capacity=arena)
    ppg = ppr.build_graph(n, tol=TOL, arena_capacity=arena)
    js = JDirtyScheduler(jpg.graph, TpuExecutor(fixpoint=False))
    js.push(jpg.teleport, jpr.teleport_batch(n))
    js.push(jpg.edges, jweb.initial_batch())
    js.tick()
    np_states = {nid: {name: np.asarray(a) for name, a in st.items()}
                 for nid, st in js.executor.states.items()}
    assert all(a.dtype == np.int32 for st in np_states.values()
               for name, a in st.items()
               if name in ("wcnt", "lw", "rkeys", "rw", "rcount", "gen"))
    ps = P.DirtyScheduler(ppg.graph, host_loop())
    ps.executor.state_restore(states_from_jax(np_states, ppg.graph,
                                              device="cpu"))
    jb, pb = jweb.churn(CHURN), pweb.churn(CHURN)
    np.testing.assert_array_equal(jb.values, pb.values)
    js.push(jpg.edges, jb)
    ps.push(ppg.edges, pb)
    jr, pr = js.tick(), ps.tick()
    assert jr.passes == pr.passes
    jranks = jpr.ranks_to_array(js.read_table(jpg.new_rank), n)
    pranks = ppr.ranks_to_array(ps.read_table(ppg.new_rank), n)
    assert rel_err(pranks, jranks) <= 2 * TOL
    back = states_to_numpy(ps.executor.states)
    for nid, st in js.executor.states.items():
        for name, a in st.items():
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(back[nid][name], a, atol=2e-4,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(back[nid][name], a,
                                              err_msg=name)


def test_states_from_jax_refuses_a_wrong_integer_dtype():
    pg = ppr.build_graph(64, arena_capacity=256)
    sched = P.DirtyScheduler(pg.graph, P.get_executor("cuda", device="cpu"))
    st = states_to_numpy(sched.executor.states)
    st[pg.join.id]["rkeys"] = st[pg.join.id]["rkeys"].astype(np.int64)
    with pytest.raises(ValueError, match="int64"):
        states_from_jax(st, pg.graph, device="cpu")


def _refused_graphs():
    spec = P.Spec((), np.float32, key_space=8)
    uniq = P.Spec((), np.float32, key_space=8, unique=True)

    def minmax(how):
        def build():
            g = P.FlowGraph()
            g.reduce(g.source("s", spec), how)
            return g
        return build

    def multiset_join():
        g = P.FlowGraph()
        g.join(g.source("a", spec), g.source("b", spec),
               merge=lambda k, x, y: x + y, spec=spec, arena_capacity=64)
        return g

    def map_params():
        g = P.FlowGraph()
        g.map(g.source("s", spec), lambda p, v: p["w"] * v,
              params={"w": torch.ones(())})
        return g

    def bad_default_merge():
        g = P.FlowGraph()
        g.join(g.source("a", uniq), g.source("b", spec), spec=spec,
               arena_capacity=64)
        return g

    return {"min": minmax("min"), "max": minmax("max"),
            "multiset_join": multiset_join, "map_params": map_params,
            "default_merge_spec": bad_default_merge}


#: kinds that bind now, with the state key their lowering keeps
_BOUND_NOW = {"min": "cand_v", "max": "cand_v", "multiset_join": "lkeys",
              "map_params": "params"}


@pytest.mark.parametrize("kind", sorted(_refused_graphs()))
def test_unported_kinds_refused_at_bind(kind):
    """A mis-sized default-merge spec is refused at ``bind``; the min/max
    reducers, the multiset-left join and Map ``params``, once refused as
    not ported, now bind and build their device state."""
    g = _refused_graphs()[kind]()
    if kind in _BOUND_NOW:
        ex = P.get_executor("cuda", device="cpu")
        P.DirtyScheduler(g, ex)
        (st,) = ex.states.values()
        assert _BOUND_NOW[kind] in st
        return
    match = ("flat value elements" if kind == "default_merge_spec"
             else "not ported yet")
    with pytest.raises(GraphError, match=match):
        P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))


def test_one_readback_per_pass():
    """A churn tick reads back one scalar per pass (the scheduler's
    quiescence count) and one for the Join's compact-or-append decision,
    nothing else: no lowering reads a device value back in passing."""
    n, e = 500, 4000
    web = ppr.WebGraph.random(n, e, seed=1)
    pg = ppr.build_graph(n, tol=TOL, arena_capacity=_arena(e, CHURN))
    sched = P.DirtyScheduler(pg.graph, host_loop())
    sched.push(pg.teleport, ppr.teleport_batch(n))
    sched.push(pg.edges, web.initial_batch())
    sched.tick()
    sched.push(pg.edges, web.churn(CHURN))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = sched.tick()
    reads = sum(ev.name == "aten::item" for ev in prof.events())
    assert res.passes > 2
    assert reads == res.passes + 1


# -- the fused delta-vector loop (the executor's default) --------------------

@pytest.fixture(scope="module")
def fused_run():
    return run("port_fused")


def test_port_fused_matches_jax_fused_and_reference(fused_run):
    ranks, passes, sched, web, _ = fused_run
    assert isinstance(sched.executor._fx_program, LinearFixpointProgram)
    jranks, jpasses, _, _, _ = run("jax_fused")
    assert rel_err(ranks, jranks) <= 1e-3, (passes, jpasses)
    assert rel_err(ranks, ppr.reference_ranks(web)) <= 1e-3


def test_fused_churn_tick_readbacks():
    """A fused churn tick reads back once a pass (the packed
    [live, edges, edges, rows] read; the last one sees the loop end), once
    for the Join's compact-or-append decision, once for the CSR's
    (gen, rcount), and once for the tick's error check: passes + 3.
    Nothing else: no ``item``/``bool()`` of a tensor beyond the append's
    one, and no ``nonzero``."""
    n, e = 500, 4000
    web = ppr.WebGraph.random(n, e, seed=1)
    pg = ppr.build_graph(n, tol=TOL, arena_capacity=_arena(e, CHURN))
    sched = P.DirtyScheduler(pg.graph, P.get_executor("cuda", device="cpu"))
    ex = sched.executor
    sched.push(pg.teleport, ppr.teleport_batch(n))
    sched.push(pg.edges, web.initial_batch())
    sched.tick()
    sched.push(pg.edges, web.churn(CHURN))
    r0, h0, f0 = ex.loop_reads, ex.host_syncs, sched.forced_syncs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = sched.tick()
    names = [ev.name for ev in prof.events()]
    assert res.passes > 2 and res.quiesced
    assert ex.loop_reads - r0 == res.passes
    assert ex.host_syncs - h0 == 2
    assert sched.forced_syncs - f0 == 3
    assert names.count("aten::item") == 1
    assert names.count("aten::is_nonzero") == 0
    assert names.count("aten::nonzero") == 0
    assert names.count("reflow::linear.read") == res.passes


# -- the deferred mode (cross-tick residual deferral) -------------------------

DN, DE, DTOL = 40, 160, 1e-5


def _run_deferred(defer, seed=21, churn_ticks=6, drain=True, settle=False):
    """As ``tests/test_pagerank.py::_run_deferred``, on the port."""
    web = ppr.WebGraph.random(DN, DE, seed=seed)
    pg = ppr.build_graph(DN, tol=DTOL, arena_capacity=4096,
                         defer_passes=defer)
    sched = P.DirtyScheduler(pg.graph, P.get_executor("cuda", device="cpu"),
                             max_loop_iters=500)
    sched.push(pg.teleport, ppr.teleport_batch(DN))
    sched.push(pg.edges, web.initial_batch())
    sched.tick(sync=False)
    if settle:
        sched.drain(pg.edges)
    for _ in range(churn_ticks):
        sched.push(pg.edges, web.churn(0.05))
        sched.tick(sync=False)
    if drain:
        sched.drain(pg.edges)
    return web, pg, sched


@pytest.mark.parametrize("defer", [1, 2, 4])
def test_deferred_drain_matches_reference(defer):
    web, pg, sched = _run_deferred(defer)
    assert isinstance(sched.executor._fx_program, LinearFixpointProgram)
    assert all(r.passes <= 1 + defer for r in sched.history)
    ranks = ppr.ranks_to_array(sched.read_table(pg.new_rank), DN)
    np.testing.assert_allclose(ranks, ppr.reference_ranks(web), atol=5e-4)


def test_deferred_left_table_consistency():
    """After drain the Join's folded left table equals the Reduce's
    emitted table exactly (A = emitted - resid at resid == 0)."""
    _, pg, sched = _run_deferred(2)
    jt = sched.read_table(pg.join)
    rt = sched.read_table(pg.new_rank)
    assert set(jt) == set(rt)
    for k in rt:
        assert jt[k] == rt[k]


def test_deferred_mid_stream_accuracy_bounded():
    web, pg, sched = _run_deferred(2, drain=False, settle=True)
    ref = ppr.reference_ranks(web)
    mid = ppr.ranks_to_array(sched.read_table(pg.new_rank), DN)
    resid = sched.executor.states[pg.ranks.id]["resid"]
    assert bool((resid != 0).any())        # the residue is in flight
    sched.drain(pg.edges)
    drained = ppr.ranks_to_array(sched.read_table(pg.new_rank), DN)
    assert np.abs(mid - ref).max() < 0.2
    assert np.abs(drained - ref).max() < 5e-4


def test_deferred_state_carried_from_jax():
    """The JAX fused loop's state taken mid-stream under defer_passes=1
    (residue live), carried into the port; one churn tick and a drain in
    both: the ranks agree (1e-3) and the integer state exactly."""
    jweb = jpr.WebGraph.random(DN, DE, seed=23)
    pweb = ppr.WebGraph.random(DN, DE, seed=23)
    jpg = jpr.build_graph(DN, tol=DTOL, arena_capacity=4096, defer_passes=1)
    ppg = ppr.build_graph(DN, tol=DTOL, arena_capacity=4096, defer_passes=1)
    js = JDirtyScheduler(jpg.graph, TpuExecutor(), max_loop_iters=500)
    js.push(jpg.teleport, jpr.teleport_batch(DN))
    js.push(jpg.edges, jweb.initial_batch())
    js.tick(sync=False)
    for _ in range(3):
        b = jweb.churn(0.05)
        pweb.churn(0.05)
        js.push(jpg.edges, b)
        js.tick(sync=False)
    np_states = {nid: {name: np.asarray(a) for name, a in st.items()}
                 for nid, st in js.executor.states.items()}
    assert np.any(np_states[jpg.ranks.id]["resid"] != 0)
    ps = P.DirtyScheduler(ppg.graph, P.get_executor("cuda", device="cpu"),
                          max_loop_iters=500)
    ps.executor.state_restore(states_from_jax(np_states, ppg.graph,
                                              device="cpu"))
    np.testing.assert_array_equal(
        ps.executor.states[ppg.ranks.id]["resid"].numpy(),
        np_states[jpg.ranks.id]["resid"])
    jb, pb = jweb.churn(0.05), pweb.churn(0.05)
    np.testing.assert_array_equal(jb.values, pb.values)
    js.push(jpg.edges, jb)
    ps.push(ppg.edges, pb)
    js.tick(sync=False)
    ps.tick(sync=False)
    js.drain(jpg.edges)
    ps.drain(ppg.edges)
    jranks = jpr.ranks_to_array(js.read_table(jpg.new_rank), DN)
    pranks = ppr.ranks_to_array(ps.read_table(ppg.new_rank), DN)
    assert rel_err(pranks, jranks) <= 1e-3
    back = states_to_numpy(ps.executor.states)
    assert set(back) == set(js.executor.states)
    for nid, st in js.executor.states.items():
        for name, a in st.items():
            a = np.asarray(a)
            if not np.issubdtype(a.dtype, np.floating):
                np.testing.assert_array_equal(back[nid][name], a,
                                              err_msg=name)


def test_state_carried_from_jax_then_one_churn_tick_fused():
    """The twin of ``test_state_carried_from_jax_then_one_churn_tick`` on
    the fused path: the JAX default's state after the initial tick, one
    churn tick in both fused loops (the port builds its CSR cache from
    the carried arena); ranks within 2 tol, every state array agrees
    (integers exactly)."""
    n, e = 1000, 10000
    jweb = jpr.WebGraph.random(n, e, seed=3)
    pweb = ppr.WebGraph.random(n, e, seed=3)
    arena = _arena(e, CHURN)
    jpg = jpr.build_graph(n, tol=TOL, arena_capacity=arena)
    ppg = ppr.build_graph(n, tol=TOL, arena_capacity=arena)
    js = JDirtyScheduler(jpg.graph, TpuExecutor())
    js.push(jpg.teleport, jpr.teleport_batch(n))
    js.push(jpg.edges, jweb.initial_batch())
    js.tick()
    np_states = {nid: {name: np.asarray(a) for name, a in st.items()}
                 for nid, st in js.executor.states.items()}
    ps = P.DirtyScheduler(ppg.graph, P.get_executor("cuda", device="cpu"))
    ps.executor.state_restore(states_from_jax(np_states, ppg.graph,
                                              device="cpu"))
    jb, pb = jweb.churn(CHURN), pweb.churn(CHURN)
    js.push(jpg.edges, jb)
    ps.push(ppg.edges, pb)
    jr, pr = js.tick(), ps.tick()
    assert jr.quiesced and pr.quiesced
    assert ps.executor.csr_rebuilds == {"initial": 1}
    assert abs(jr.passes - pr.passes) <= 2, (jr.passes, pr.passes)
    jranks = jpr.ranks_to_array(js.read_table(jpg.new_rank), n)
    pranks = ppr.ranks_to_array(ps.read_table(ppg.new_rank), n)
    assert rel_err(pranks, jranks) <= 2 * TOL
    back = states_to_numpy(ps.executor.states)
    for nid, st in js.executor.states.items():
        for name, a in st.items():
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(back[nid][name], a, atol=2e-4,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(back[nid][name], a,
                                              err_msg=name)
