"""The port's whole-tick fixpoint (``reflow_tpu_torch/executors/
fixpoint.py``) against the JAX package's, on the CPU.

- ``analyze`` finds the same structure as the JAX ``analyze`` on the same
  graphs, compared by node names.
- ``_emitted_diff`` equals the JAX one exactly.
- The row program (``linear_fixpoint=False``) against the JAX row
  program, the port's host-driven loop and the CPU oracle, mirroring
  ``tests/test_fixpoint.py``. Tolerance: two tol-converged fixpoints
  with different accumulation orders differ by at most
  ``tol / (1 - damping)`` plus float32 noise (``1e-5``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.executors import fixpoint as jfx
from reflow_tpu.executors.tpu import TpuExecutor
from reflow_tpu.workloads import pagerank as jpr
from reflow_tpu_torch.executors import fixpoint as pfx
from reflow_tpu_torch.executors.fixpoint import FixpointProgram
from reflow_tpu_torch.workloads import pagerank as ppr

N, E = 48, 200
TOL = 1e-5
BOUND = TOL / (1.0 - ppr.DAMPING) + 1e-5


def _port(**kw):
    return P.get_executor("cuda", device="cpu", **kw)


def _run(pkg, executor, churn_ticks=2, sink=False, seed=3):
    mod = jpr if pkg is J else ppr
    web = mod.WebGraph.random(N, E, seed=seed)
    pg = mod.build_graph(N, tol=TOL)
    if sink:
        pg.graph.sink(pg.new_rank, "ranks_out")
    sched = pkg.DirtyScheduler(pg.graph, executor, max_loop_iters=500)
    sched.push(pg.teleport, mod.teleport_batch(N))
    sched.push(pg.edges, web.initial_batch())
    results = [sched.tick()]
    for _ in range(churn_ticks):
        sched.push(pg.edges, web.churn(0.05))
        results.append(sched.tick())
    return sched, pg, results


def _ranks(sched, pg):
    return ppr.ranks_to_array(sched.read_table(pg.new_rank), N)


# -- analyze ----------------------------------------------------------------

def _pagerank(pkg):
    return (jpr if pkg is J else ppr).build_graph(16, arena_capacity=256).graph


def _pagerank_with_sink(pkg):
    pg = (jpr if pkg is J else ppr).build_graph(16, arena_capacity=256)
    pg.graph.sink(pg.new_rank, "ranks_out")
    return pg.graph


def _non_reduce_boundary(pkg):
    """loop -> map (boundary, with an outside sink) -> reduce -> back."""
    spec = pkg.Spec((), np.float32, key_space=8, unique=True)
    raw = pkg.Spec((), np.float32, key_space=8)
    g = pkg.FlowGraph("decay")
    x = g.loop("x", spec)
    halved = g.map(x, lambda v: 0.5 * v, vectorized=True, name="halve",
                   spec=raw)
    g.sink(halved, "halves")
    nxt = g.reduce(halved, "sum", tol=1e-3, name="next", spec=spec)
    g.close_loop(x, nxt)
    return g


def _loop_carried_arena(pkg):
    """A Join whose right (arena) input is the loop itself."""
    spec = pkg.Spec((), np.float32, key_space=8, unique=True)
    g = pkg.FlowGraph("arena_in_loop")
    a = g.source("a", spec)
    x = g.loop("x", spec)
    j = g.join(a, x, merge=lambda k, va, vb: va + vb, spec=spec,
               arena_capacity=64, name="j")
    nxt = g.reduce(j, "sum", tol=1e-3, name="next", spec=spec)
    g.close_loop(x, nxt)
    return g


def _names(nodes):
    return tuple(n.name for n in nodes)


@pytest.mark.parametrize("build", [_pagerank, _pagerank_with_sink,
                                   _non_reduce_boundary,
                                   _loop_carried_arena],
                         ids=lambda f: f.__name__.strip("_"))
def test_analyze_matches_jax(build):
    js, ps = jfx.analyze(build(J)), pfx.analyze(build(P))
    if js is None:
        assert ps is None
        return
    jg, pg = build(J), build(P)
    js, ps = jfx.analyze(jg), pfx.analyze(pg)
    for field in ("loops", "loop_plan", "boundary", "exit_plan"):
        assert _names(getattr(ps, field)) == _names(getattr(js, field)), field
    jname = {n.id: n.name for n in jg.nodes}
    pname = {n.id: n.name for n in pg.nodes}
    assert ({pname[i] for i in ps.region_ids}
            == {jname[i] for i in js.region_ids})


def test_analyze_refusals_are_the_ones_jax_makes():
    assert pfx.analyze(_non_reduce_boundary(P)) is None
    assert pfx.analyze(_loop_carried_arena(P)) is None
    st = pfx.analyze(_pagerank_with_sink(P))
    assert _names(st.boundary) == ("rank",)
    assert _names(st.exit_plan) == ("ranks_out",)


# -- the telescoped boundary diff ---------------------------------------------

@pytest.mark.parametrize("vshape", [(), (3,)])
def test_emitted_diff_matches_jax_exactly(vshape):
    rng = np.random.default_rng(5)
    K = 97
    em_a = rng.standard_normal((K,) + vshape).astype(np.float32)
    em_f = em_a.copy()
    change = rng.random(K) < 0.3
    em_f[change] += 1.0
    has_a = rng.random(K) < 0.7
    has_f = rng.random(K) < 0.7
    spec = P.Spec(vshape, np.float32, key_space=K)
    g = P.FlowGraph()
    node = g.source("s", spec)
    got = pfx._emitted_diff(
        (torch.from_numpy(em_a), torch.from_numpy(has_a)),
        {"emitted": torch.from_numpy(em_f),
         "emitted_has": torch.from_numpy(has_f)}, node)
    want = jfx._emitted_diff(
        (jnp.asarray(em_a), jnp.asarray(has_a)),
        {"emitted": jnp.asarray(em_f), "emitted_has": jnp.asarray(has_f)},
        None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the row program ----------------------------------------------------------

def test_row_program_used_and_matches_jax_and_host_driven():
    s_row, pg_row, r_row = _run(P, _port(linear_fixpoint=False))
    s_host, pg_host, r_host = _run(P, _port(fixpoint=False))
    s_j, pg_j, r_j = _run(J, TpuExecutor(linear_fixpoint=False))
    assert all(r.quiesced for r in r_row + r_host + r_j)
    assert isinstance(s_row.executor._fx_program, FixpointProgram)
    assert s_row.executor._linear_structure is None
    assert s_host.executor._fx_program is None
    # the same algorithm as the JAX row program, pass for pass
    assert [r.passes for r in r_row] == [r.passes for r in r_j]
    np.testing.assert_allclose(_ranks(s_row, pg_row), _ranks(s_j, pg_j),
                               atol=BOUND)
    np.testing.assert_allclose(_ranks(s_row, pg_row),
                               _ranks(s_host, pg_host), atol=BOUND)


def test_row_program_matches_cpu_oracle_and_reference_after_churn():
    web = ppr.WebGraph.random(N, E, seed=9)
    pg = ppr.build_graph(N, tol=TOL)
    sched = P.DirtyScheduler(pg.graph, _port(linear_fixpoint=False),
                             max_loop_iters=500)
    sched.push(pg.teleport, ppr.teleport_batch(N))
    sched.push(pg.edges, web.initial_batch())
    sched.tick()
    for _ in range(3):
        sched.push(pg.edges, web.churn(0.05))
        assert sched.tick().quiesced
    np.testing.assert_allclose(_ranks(sched, pg), ppr.reference_ranks(web),
                               atol=5e-4)
    s_cpu, pg_cpu, _ = _run(P, P.CpuExecutor(), churn_ticks=2, seed=3)
    s_row, pg_row, _ = _run(P, _port(linear_fixpoint=False), seed=3)
    np.testing.assert_allclose(_ranks(s_row, pg_row), _ranks(s_cpu, pg_cpu),
                               atol=BOUND)


def test_row_program_loop_rows_and_readbacks():
    """The fused tick still reports loop traffic (deltas_in) and > 2
    passes; the loop reads back once a pass plus once to see it end."""
    ex = _port(linear_fixpoint=False)
    _, _, results = _run(P, ex, churn_ticks=1)
    assert results[0].passes > 2
    assert results[0].deltas_in > N + E
    # passes = phase A + loop passes; reads = loop passes + 1 per tick
    assert ex.loop_reads == sum(r.passes for r in results)


@pytest.mark.parametrize("linear", [False, True], ids=["row", "fused"])
def test_boundary_sink_matches_cpu_executor(linear):
    """A sink fed by the in-region Reduce receives the telescoped table
    diff in the exit pass; its view equals the CPU executor's."""
    s_dev, _, _ = _run(P, _port(linear_fixpoint=linear), sink=True, seed=5)
    s_cpu, _, _ = _run(P, P.CpuExecutor(), sink=True, seed=5)
    ex = s_dev.executor
    assert (ex._linear_structure is not None) == linear
    assert len(ex._fx_structure.exit_plan) == 1
    v_dev, v_cpu = s_dev.view_dict("ranks_out"), s_cpu.view_dict("ranks_out")
    assert set(v_dev) == set(v_cpu)
    for k in v_cpu:
        assert abs(float(v_dev[k]) - float(v_cpu[k])) <= 1e-4


def test_non_reduce_boundary_falls_back_to_host_loop():
    """The map's emissions don't telescope, so the executor declines the
    fused path and the host-driven loop still converges."""
    g = _non_reduce_boundary(P)
    ex = _port()
    sched = P.DirtyScheduler(g, ex, max_loop_iters=200)
    x = g.loops[0]
    sched.push(x, P.DeltaBatch(np.arange(8), np.ones(8, np.float32)))
    r = sched.tick()
    assert ex._fx_unsupported
    assert r.quiesced and r.passes > 3


def test_row_program_max_iters_halt_resumes():
    """A row-program tick halted at max_loop_iters hands its live carry
    back: the scheduler stashes it, and the next ticks resume to the
    same fixpoint as an unhalted run."""
    web = ppr.WebGraph.random(N, E, seed=4)
    pg = ppr.build_graph(N, tol=TOL)
    sched = P.DirtyScheduler(pg.graph, _port(linear_fixpoint=False),
                             max_loop_iters=5)
    sched.push(pg.teleport, ppr.teleport_batch(N))
    sched.push(pg.edges, web.initial_batch())
    r = sched.tick()
    assert not r.quiesced and r.passes == 6
    for _ in range(100):
        if sched.tick().quiesced:
            break
    s_full, pg_full, _ = _run(P, _port(linear_fixpoint=False),
                              churn_ticks=0, seed=4)
    np.testing.assert_allclose(_ranks(sched, pg), _ranks(s_full, pg_full),
                               atol=BOUND)
