"""The port's Join-arena compaction (``reflow_tpu_torch/executors/arena.py``)
against the JAX package's, on the CPU.

``compact_arena`` is held BIT-identical to the JAX kernel on the same
arrays: the same surviving rows in the same order, the same net weights,
value bits compared at native width (float64 included). The arena's
life inside the Join — compaction when an append would cross capacity,
the sticky overflow error raised by ``check_errors``, a long churn
stream through an arena sized for live rows — is held to the JAX
``TpuExecutor(fixpoint=False)`` and to the float64 reference ranks.
"""

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.executors.arena import compact_arena as jcompact
from reflow_tpu.executors.device_delta import bucket_capacity
from reflow_tpu.executors.tpu import TpuExecutor
from reflow_tpu.graph import GraphError as JGraphError
from reflow_tpu.workloads import pagerank as jpr
from reflow_tpu_torch.executors.arena import compact_arena, propagate_plan_caps
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.workloads import pagerank as ppr


def _arena(rng, R, n, vshape, dtype, n_keys=6, n_vals=4):
    """An arena of ``n`` filled rows out of ``R``: few keys and few
    distinct values, so equal (key, value) runs form and insert/retract
    pairs cancel; some filled rows are dead (weight 0)."""
    keys = np.zeros(R, np.int32)
    vals = np.zeros((R,) + vshape, dtype)
    w = np.zeros(R, np.int32)
    keys[:n] = rng.integers(0, n_keys, n)
    pool = (rng.standard_normal((n_vals,) + vshape) * 4).astype(dtype)
    vals[:n] = pool[rng.integers(0, n_vals, n)]
    w[:n] = rng.choice([-1, 1, 1, 2, 0], n)
    return keys, vals, w, n


def _both(keys, vals, w, rcount, jdtype=None, tdtype=None):
    import jax.numpy as jnp

    jst = {"rkeys": jnp.asarray(keys), "rw": jnp.asarray(w),
           "rvals": jnp.asarray(vals, jdtype) if jdtype is not None
           else jnp.asarray(vals),
           "rcount": jnp.asarray(rcount, jnp.int32),
           "gen": jnp.asarray(3, jnp.int32),
           "lval": jnp.zeros((4,)), "lw": jnp.zeros((4,), jnp.int32)}
    tv = torch.from_numpy(np.array(vals))
    pst = {"rkeys": torch.from_numpy(keys.copy()),
           "rw": torch.from_numpy(w.copy()),
           "rvals": tv.to(tdtype) if tdtype is not None else tv,
           "rcount": torch.tensor(rcount, dtype=torch.int32),
           "gen": torch.tensor(3, dtype=torch.int32),
           "lval": torch.zeros(4), "lw": torch.zeros(4, dtype=torch.int32)}
    return jcompact(jst), compact_arena(pst)


def _assert_bit_identical(jout, pout, as_np=None):
    for name in ("rkeys", "rw", "rcount", "gen"):
        np.testing.assert_array_equal(pout[name].numpy(),
                                      np.asarray(jout[name]), err_msg=name)
    pv = pout["rvals"]
    jv = np.asarray(jout["rvals"] if as_np is None else as_np(jout["rvals"]))
    if pv.dtype == torch.bfloat16:
        pv = pv.view(torch.int16)
        jv = jv.view(np.int16)
    pv = pv.numpy()
    assert pv.tobytes() == jv.tobytes()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("vshape", [(), (2,), (3,)])
def test_compact_matches_jax_bit_for_bit(seed, vshape):
    rng = np.random.default_rng(seed)
    keys, vals, w, n = _arena(rng, 128, 100, vshape, np.float32)
    jout, pout = _both(keys, vals, w, n)
    _assert_bit_identical(jout, pout)
    assert int(pout["gen"]) == 4
    # it compacted something: cancelled pairs and dead rows are gone
    assert int(pout["rcount"]) < n


def test_compact_bf16_and_int8_values_match_jax():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    keys, vals, w, n = _arena(rng, 64, 60, (2,), np.float32)
    jout, pout = _both(keys, vals, w, n, jnp.bfloat16, torch.bfloat16)
    _assert_bit_identical(
        jout, pout,
        as_np=lambda a: jax.lax.bitcast_convert_type(a, jnp.int16))
    ints = np.clip(np.round(vals), -100, 100).astype(np.int8)
    jout, pout = _both(keys, ints, w, n)
    _assert_bit_identical(jout, pout)


def test_compact_kernel_case():
    """``tests/test_arena_gc.py:15``: (1, 2.0) twice survives with net
    weight 2, (3, 5.0) cancels, (4, 7.0, -1) survives."""
    R = 16
    keys = np.zeros(R, np.int32)
    keys[:5] = [1, 3, 1, 3, 4]
    vals = np.zeros((R, 1), np.float32)
    vals[:5, 0] = [2.0, 5.0, 2.0, 5.0, 7.0]
    w = np.zeros(R, np.int32)
    w[:5] = [1, 1, 1, -1, -1]
    jout, pout = _both(keys, vals, w, 5)
    _assert_bit_identical(jout, pout)
    assert int(pout["rcount"]) == 2
    live = pout["rw"].numpy() != 0
    rows = sorted(zip(pout["rkeys"].numpy()[live].tolist(),
                      pout["rvals"].numpy()[live, 0].tolist(),
                      pout["rw"].numpy()[live].tolist()))
    assert rows == [(1, 2.0, 2), (4, 7.0, -1)]


def test_compact_native_width_bit_identity():
    """Distinct float64 values that are equal as float32 must not cancel
    (``tests/test_arena_gc.py:81``), and the order of the two int32
    words of each value matches the JAX bitcast's."""
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        R = 16
        a, b = 1.0, 1.0 + 2.0 ** -40
        keys = np.zeros(R, np.int32)
        keys[:6] = [5, 5, 2, 2, 2, 7]
        vals = np.zeros((R, 1), np.float64)
        vals[:6, 0] = [a, b, -3.5, 2.0 ** 40 + 1, -3.5, 0.0]
        w = np.zeros(R, np.int32)
        w[:6] = [1, -1, 1, 1, -1, 1]
        jout, pout = _both(keys, vals, w, 6)
        _assert_bit_identical(jout, pout)
        live = pout["rw"].numpy() != 0
        assert sorted(pout["rvals"].numpy()[live, 0].tolist()) == \
            [0.0, a, b, 2.0 ** 40 + 1]
        rng = np.random.default_rng(8)
        keys, vals, w, n = _arena(rng, 64, 50, (2,), np.float64)
        vals[:n] += np.where(rng.random((n, 2)) < 0.5, 2.0 ** -45, 0.0)
        _assert_bit_identical(*_both(keys, vals, w, n))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_compact_empty_and_full_arena():
    rng = np.random.default_rng(2)
    for n in (0, 64):
        keys, vals, w, n = _arena(rng, 64, n, (2,), np.float32)
        _assert_bit_identical(*_both(keys, vals, w, n))


# -- the arena inside the Join ---------------------------------------------

def _overflow_graph(pkg):
    if pkg == "jax":
        from reflow_tpu import FlowGraph, Spec
    else:
        FlowGraph, Spec = P.FlowGraph, P.Spec
    K = 16
    uniq = Spec((), np.float32, key_space=K, unique=True)
    raw = Spec((), np.float32, key_space=K)
    g = FlowGraph("overflow")
    vals = g.source("vals", uniq)
    edges = g.source("edges", raw)
    tot = g.reduce(vals, "sum", name="uniq")
    j = g.join(tot, edges, merge=lambda k, va, vb: va + vb, spec=raw,
               arena_capacity=64, name="j")
    g.sink(g.reduce(j, "sum", name="joined"), "out")
    return g, vals, edges, K


def test_arena_overflow_raises_from_check_errors():
    """Live rows + appends beyond capacity, nothing to cancel: the sticky
    error flag raises at the tick's check (``tests/test_arena_gc.py:112``),
    after compaction was tried (``gen`` moved)."""
    g, vals, edges, K = _overflow_graph("port")
    ex = P.get_executor("cuda", device="cpu")
    sched = P.DirtyScheduler(g, ex)
    sched.push(vals, P.DeltaBatch(np.arange(K), np.ones(K, np.float32)))
    sched.tick()
    n, v0 = 48, 0
    with pytest.raises(RuntimeError, match="arena overflowed"):
        for _ in range(4):
            keys = (np.arange(n) % K).astype(np.int64)
            sched.push(edges, P.DeltaBatch(
                keys, np.arange(v0, v0 + n).astype(np.float32)))
            v0 += n
            sched.tick()
    j = next(n for n in g.nodes if n.name == "j")
    st = ex.states[j.id]
    assert bool(st["error"]) and int(st["gen"]) >= 1
    with pytest.raises(RuntimeError, match="arena overflowed"):
        sched.read_table(j)


def test_one_pass_larger_than_the_arena_is_refused():
    """The static capacity walk refuses a right delta whose capacity
    exceeds the arena, as the JAX package's does, before any append."""
    for pkg, Err in (("port", GraphError), ("jax", JGraphError)):
        g, vals, edges, K = _overflow_graph(pkg)
        if pkg == "port":
            sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
            DB = P.DeltaBatch
        else:
            from reflow_tpu import DeltaBatch as DB
            sched = JDirtyScheduler(g, TpuExecutor(fixpoint=False))
        sched.push(edges, DB(np.arange(100) % K,
                             np.ones(100, np.float32)))
        with pytest.raises(Err, match="exceeds the per-shard arena"):
            sched.tick()


def test_propagate_plan_caps_matches_jax():
    from reflow_tpu.executors.arena import propagate_plan_caps as jcaps

    jpg = jpr.build_graph(64, arena_capacity=1024)
    ppg = ppr.build_graph(64, arena_capacity=1024)
    for seed in ({"teleport": 64, "edges": 256}, {"ranks": 128},
                 {"edges": 64}):
        jseed = {n.id: c for n in jpg.graph.nodes for name, c in seed.items()
                 if n.name == name}
        pseed = {n.id: c for n in ppg.graph.nodes for name, c in seed.items()
                 if n.name == name}
        assert propagate_plan_caps(ppg.graph.nodes, pseed) == \
            jcaps(jpg.graph.nodes, jseed)


def test_long_churn_constant_arena():
    """50 churn ticks through an arena sized for LIVE rows only
    (``tests/test_arena_gc.py:47``): lifetime appends exceed capacity
    several times over, so this passes only if compaction reclaims
    cancelled pairs. The port's arena, compaction count and ranks match
    the JAX executor's; each compaction check is one counted readback."""
    N, E, churn, ticks = 48, 200, 0.2, 50
    churn_cap = bucket_capacity(2 * int(churn * E) + 2)
    arena = bucket_capacity(E) + 2 * churn_cap
    runs = {}
    for pkg, mod in (("port", ppr), ("jax", jpr)):
        web = mod.WebGraph.random(N, E, seed=4)
        pg = mod.build_graph(N, tol=1e-5, arena_capacity=arena)
        if pkg == "port":
            # the host-driven loop, as the JAX run below
            ex = P.get_executor("cuda", device="cpu", fixpoint=False)
            sched = P.DirtyScheduler(pg.graph, ex, max_loop_iters=500)
        else:
            ex = TpuExecutor(fixpoint=False)
            sched = JDirtyScheduler(pg.graph, ex, max_loop_iters=500)
        sched.push(pg.teleport, mod.teleport_batch(N))
        sched.push(pg.edges, web.initial_batch())
        assert sched.tick().quiesced
        for i in range(ticks):
            sched.push(pg.edges, web.churn(churn))
            assert sched.tick().quiesced, f"{pkg} tick {i}"
        st = ex.states[pg.join.id]
        ranks = mod.ranks_to_array(sched.read_table(pg.new_rank), N)
        runs[pkg] = (int(st["gen"]), int(st["rcount"]), ranks,
                     mod.reference_ranks(web), ex)
    (pgen, pcount, pranks, ref, pex), (jgen, jcount, jranks, _, _) = \
        runs["port"], runs["jax"]
    assert bucket_capacity(E) + ticks * churn_cap > arena
    assert pgen == jgen >= 5 and pcount == jcount
    # one compact-or-not readback per tick that appended edges
    assert pex.host_syncs == ticks + 1
    np.testing.assert_allclose(pranks, jranks, rtol=0, atol=2e-4)
    assert np.max(np.abs(pranks - ref)) < 5e-3
