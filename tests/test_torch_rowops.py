"""The port's row lowerings (Map, Filter, GroupBy, Union) and its linear
Reduce (sum / count / mean, dense and sparse modes) against the JAX
package and the CPU oracle, on the CPU.

Two levels: the same graphs and delta streams as
``tests/test_tpu_executor.py`` through the port's ``cuda`` executor on
the CPU (``device="cpu"``, its plain PyTorch path), the JAX
``TpuExecutor(fixpoint=False)`` and the port's ``CpuExecutor``; and the
Reduce lowering alone on identical random inputs made from a numpy seed,
held to the JAX lowering. Tolerances: keys, weights and emission
decisions exact; float values within 1e-5 (float32 sums in another
order; views are compared after rounding to 4 places, as the JAX
package's own differential tests do).
"""

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu import DeltaBatch as JDeltaBatch
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu import FlowGraph as JFlowGraph
from reflow_tpu import Spec as JSpec
from reflow_tpu.executors import lowerings as jlow
from reflow_tpu.executors.device_delta import DeviceDelta as JDeviceDelta
from reflow_tpu.executors.tpu import TpuExecutor
from reflow_tpu_torch.executors import lowerings as plow
from reflow_tpu_torch.executors.device_delta import DeviceDelta

K = 32
#: a key space above the smallest delta capacity (64), so small batches
#: take the Reduce's sparse mode; K = 32 always takes the dense mode
K_SPARSE = 256


def _ns(pkg):
    if pkg == "jax":
        return JFlowGraph, JSpec, JDeltaBatch
    return P.FlowGraph, P.Spec, P.DeltaBatch


def _sched(pkg, g):
    if pkg == "jax":
        return JDirtyScheduler(g, TpuExecutor(fixpoint=False))
    ex = (P.get_executor("cuda", device="cpu") if pkg == "port"
          else P.CpuExecutor())
    return P.DirtyScheduler(g, ex)


def _batch(DB, rows):
    """rows: (int_key, float_value, weight)."""
    return DB(np.array([r[0] for r in rows], dtype=np.int64),
              np.array([r[1] for r in rows], dtype=np.float32),
              np.array([r[2] for r in rows], dtype=np.int64))


def run_all(build, ticks):
    """The same graph and stream through the port's cuda executor (on the
    CPU), the JAX TpuExecutor and the port's CpuExecutor -> three views."""
    views = {}
    for pkg in ("port", "jax", "cpu"):
        FG, SP, DB = _ns(pkg)
        g, sink = build(FG, SP)
        sched = _sched(pkg, g)
        for tick in ticks:
            for src_name, rows in tick:
                src = next(s for s in g.sources if s.name == src_name)
                sched.push(src, _batch(DB, rows))
            sched.tick()
        views[pkg] = {k: round(float(v), 4)
                      for k, v in sched.view_dict(sink).items()}
    return views


def _same(views, expect=None):
    assert views["port"] == views["jax"] == views["cpu"], views
    if expect is not None:
        assert views["port"] == expect


@pytest.mark.parametrize("k", [K, K_SPARSE])
def test_map_reduce_sum(k):
    def build(FG, SP):
        g = FG()
        src = g.source("in", SP((), np.float32, key_space=k))
        doubled = g.map(src, lambda v: v * 2.0, vectorized=True)
        return g, g.sink(g.reduce(doubled, "sum", name="sum"), "out")

    _same(run_all(build, [
        [("in", [(1, 1.0, 1), (1, 2.0, 1), (5, 3.0, 1)])],
        [("in", [(1, 1.0, -1), (7, 4.0, 2)])],
        [("in", [(5, 3.0, -1)])],               # group 5 vanishes
    ]), {1: 4.0, 7: 16.0})


@pytest.mark.parametrize("k", [K, K_SPARSE])
def test_filter_groupby(k):
    def build(FG, SP):
        g = FG()
        src = g.source("in", SP((), np.float32, key_space=k))
        big = g.filter(src, lambda v: v > 1.5, vectorized=True)
        rekey = g.group_by(big, lambda k_, v: (k_ + 1) % k, vectorized=True)
        return g, g.sink(g.reduce(rekey, "sum", name="sum"), "out")

    _same(run_all(build, [
        [("in", [(0, 1.0, 1), (0, 2.0, 1), (3, 9.0, 1)])],
        [("in", [(3, 9.0, -1), (3, 5.0, 1)])],
    ]), {1: 2.0, 4: 5.0})


def test_per_row_fns_take_vmap():
    """Non-vectorized Map / Filter / GroupBy fns run per row
    (``torch.func.vmap`` in the port, ``jax.vmap`` in the JAX package)."""
    def build(FG, SP):
        g = FG()
        src = g.source("in", SP((), np.float32, key_space=K_SPARSE))
        m = g.map(src, lambda v: v * v + 1.0)
        f = g.filter(m, lambda v: v < 50.0)
        gb = g.group_by(f, lambda k_, v: (k_ * 3) % K_SPARSE,
                        value_fn=lambda k_, v: v - 1.0)
        return g, g.sink(g.reduce(gb, "sum", name="sum"), "out")

    _same(run_all(build, [
        [("in", [(1, 2.0, 1), (2, 3.0, 1), (4, 9.0, 1), (7, -1.0, 2)])],
        [("in", [(2, 3.0, -1), (5, 4.0, 1)])],
    ]), {3: 4.0, 21: 2.0, 15: 16.0})


def _const(kind, pkg, x):
    """``x`` as a row function's constant result: a Python float or int,
    or a 0-d array of the package (a torch or a jax.numpy one)."""
    if kind == "float":
        return float(x)
    if kind == "int":
        return int(x)
    if pkg == "jax":
        import jax.numpy as jnp
        return jnp.asarray(x)
    return torch.tensor(x)


@pytest.mark.parametrize("kind", ["float", "int", "0d_tensor"])
def test_constant_row_functions_broadcast(kind):
    """Per-row Map / Filter / GroupBy key and value functions that return
    a constant, independent of the row: ``jax.vmap`` broadcasts such a
    result to every row, and so must the port (``torch.func.vmap``
    refuses a non-tensor result by itself). Views equal exactly."""
    def build(pkg):
        def b(FG, SP):
            g = FG()
            src = g.source("in", SP((), np.float32, key_space=K_SPARSE))
            m = g.map(src, lambda v: _const(kind, pkg, 2))
            f = g.filter(m, lambda v: _const(kind, pkg, 1))
            gb = g.group_by(f, key_fn=lambda k_, v: _const(kind, pkg, 3),
                            value_fn=lambda k_, v: _const(kind, pkg, 5))
            by_key = g.group_by(m, key_fn=lambda k_, v: _const(kind, pkg, 0))
            return g, (g.sink(g.reduce(gb, "sum", name="sum"), "out"),
                       g.sink(g.reduce(by_key, "sum", name="s2"), "out2"))
        return b

    ticks = [[(1, 7.0, 1), (4, -2.0, 1), (9, 0.5, 2)], [(4, -2.0, -1)]]
    views = {}
    for pkg in ("port", "jax"):
        FG, SP, DB = _ns(pkg)
        g, sinks = build(pkg)(FG, SP)
        sched = _sched(pkg, g)
        for rows in ticks:
            sched.push(g.sources[0], _batch(DB, rows))
            sched.tick()
        views[pkg] = [{int(k): float(v) for k, v in sched.view_dict(s)
                       .items()} for s in sinks]
    # 4 live rows (weights 1, 2, ...), each -> key 3 with value 5, and
    # Map's 2 summed at key 0
    assert views["port"] == views["jax"] == [{3: 15.0}, {0: 6.0}]


@pytest.mark.parametrize("how,expect", [("count", {2: 3.0}),
                                        ("mean", {2: 2.0})])
@pytest.mark.parametrize("k", [K, K_SPARSE])
def test_reduce_count_and_mean(how, expect, k):
    def build(FG, SP):
        g = FG()
        src = g.source("in", SP((), np.float32, key_space=k))
        return g, g.sink(g.reduce(src, how, name="agg"), "out")

    _same(run_all(build, [
        [("in", [(2, 1.0, 1), (2, 2.0, 1)])],
        [("in", [(2, 3.0, 1)])],
    ]), expect)


@pytest.mark.parametrize("k", [8, K_SPARSE])
def test_full_retraction_leaves_no_phantom_group(k):
    """Float scatter-add residue must not resurrect a fully retracted
    group when tol > 0 (the device path); the host is exact
    (``tests/test_tpu_executor.py:237``)."""
    def build(FG, SP):
        g = FG()
        src = g.source("in", SP((), np.float32, key_space=k))
        return g, g.sink(g.reduce(src, "sum", tol=1e-5), "out")

    _same(run_all(build, [
        [("in", [(3, 0.1, 1), (3, 0.2, 1)])],
        [("in", [(3, 0.1, -1), (3, 0.2, -1)])],
    ]), {})


@pytest.mark.parametrize("k", [8, K_SPARSE])
def test_reduce_tol_quiesces(k):
    """A change within tol emits nothing (``tests/test_tpu_executor.py:256``)."""
    FG, SP, DB = _ns("port")
    g = FG()
    src = g.source("in", SP((), np.float32, key_space=k))
    g.sink(g.reduce(src, "sum", tol=1e-3), "out")
    sched = _sched("port", g)
    sched.push(src, _batch(DB, [(1, 1.0, 1)]))
    assert len(sched.tick().sink_deltas["out"]) == 1
    sched.push(src, _batch(DB, [(1, 1e-6, 1)]))
    assert len(sched.tick().sink_deltas.get("out", [])) == 0
    assert sched.view_dict("out") == {1: 1.0}


@pytest.mark.parametrize("k", [K, K_SPARSE])
def test_union(k):
    def build(FG, SP):
        g = FG()
        spec = SP((), np.float32, key_space=k)
        a, b = g.source("a", spec), g.source("b", spec)
        u = g.union(a, b, name="u")
        return g, g.sink(g.reduce(u, "sum", name="sum"), "out")

    _same(run_all(build, [
        [("a", [(1, 2.0, 1), (2, 3.0, 1)]), ("b", [(1, 5.0, 1)])],
        [("b", [(2, 7.0, 1), (1, 5.0, -1)])],
        [("a", [(1, 2.0, -1)])],
    ]), {2: 10.0})


def test_vector_values_sum_and_mean():
    """[K, 3] value rows through Map and both linear reducers."""
    rng = np.random.default_rng(11)

    def build_for(how):
        def build(FG, SP):
            g = FG()
            src = g.source("in", SP((3,), np.float32, key_space=K_SPARSE))
            m = g.map(src, lambda v: v * 0.5, vectorized=True)
            return g, g.sink(g.reduce(m, how, name="agg", tol=1e-6), "out")
        return build

    keys = rng.integers(0, K_SPARSE, 40)
    vals = rng.standard_normal((40, 3)).astype(np.float32)
    for how in ("sum", "mean"):
        views = {}
        for pkg in ("port", "jax", "cpu"):
            FG, SP, DB = _ns(pkg)
            g, sink = build_for(how)(FG, SP)
            sched = _sched(pkg, g)
            sched.push(g.sources[0], DB(keys, vals, np.ones(40, np.int64)))
            sched.tick()
            sched.push(g.sources[0], DB(keys[:10], vals[:10],
                                        -np.ones(10, np.int64)))
            sched.tick()
            views[pkg] = sched.view_dict(sink)
        assert set(views["port"]) == set(views["jax"]) == set(views["cpu"])
        for key in views["port"]:
            np.testing.assert_allclose(np.asarray(views["port"][key]),
                                       np.asarray(views["jax"][key]),
                                       atol=1e-5)
            np.testing.assert_allclose(np.asarray(views["port"][key]),
                                       np.asarray(views["cpu"][key],
                                                  np.float32), atol=1e-5)


# -- the Reduce lowering alone, against the JAX lowering --------------------

def _reduce_nodes(how, tol, k, vshape):
    # a count is one scalar per key, whatever the value shape
    oshape = () if how == "count" else vshape
    jg = JFlowGraph()
    js = jg.source("in", JSpec(vshape, np.float32, key_space=k))
    jr = jg.reduce(js, how, tol=tol,
                   spec=JSpec(oshape, np.float32, key_space=k))
    pg = P.FlowGraph()
    ps = pg.source("in", P.Spec(vshape, np.float32, key_space=k))
    pr = pg.reduce(ps, how, tol=tol,
                   spec=P.Spec(oshape, np.float32, key_space=k))
    return jr, pr


def _deltas(rng, cap, k, vshape, n_live):
    keys = np.zeros(cap, np.int32)
    w = np.zeros(cap, np.int32)
    vals = np.zeros((cap,) + vshape, np.float32)
    keys[:n_live] = rng.integers(0, k, n_live)
    w[:n_live] = rng.choice([-2, -1, 1, 1, 2], n_live)
    vals[:n_live] = rng.integers(-8, 8, (n_live,) + vshape) * 0.25
    return (JDeviceDelta(*(np.asarray(a) for a in (keys, vals, w))),
            DeviceDelta(torch.from_numpy(keys), torch.from_numpy(vals),
                        torch.from_numpy(w)))


@pytest.mark.parametrize("how", ["sum", "count", "mean"])
@pytest.mark.parametrize("mode,k,cap", [("dense", 64, 128),
                                        ("sparse", 512, 64)])
@pytest.mark.parametrize("vshape", [(), (2,)])
def test_reduce_lowering_matches_jax(how, mode, k, cap, vshape):
    """Three ticks of random deltas (repeated keys, retractions, values
    on a 0.25 grid so the sums are exact) through the port's and the JAX
    Reduce lowering: emitted rows and every state table agree exactly."""
    import jax.numpy as jnp

    rng = np.random.default_rng(len(how) * 7 + k + len(vshape))
    tol = 1e-4 if how == "sum" else 0.0
    jr, pr = _reduce_nodes(how, tol, k, vshape)
    jst = jlow.reduce_state(jr.op, jr.inputs[0].spec, jr.spec)
    pst = plow.reduce_state(pr.inputs[0].spec, pr.spec, "cpu")
    for _ in range(3):
        jd, pd = _deltas(rng, cap, k, vshape, n_live=cap * 3 // 4)
        jout, jst = jlow.lower_node(jr, jst, [JDeviceDelta(
            *(jnp.asarray(a) for a in jd))])
        pout, pst = plow.lower_node(pr, pst, [pd])
        assert pout.capacity == jout.capacity == (2 * k if mode == "dense"
                                                  else 2 * cap)
        np.testing.assert_array_equal(pout.weights.numpy(),
                                      np.asarray(jout.weights))
        live = pout.weights.numpy() != 0
        np.testing.assert_array_equal(pout.keys.numpy()[live],
                                      np.asarray(jout.keys)[live])
        np.testing.assert_array_equal(pout.values.numpy()[live],
                                      np.asarray(jout.values)[live])
        for name, a in jst.items():
            np.testing.assert_array_equal(pst[name].numpy(), np.asarray(a),
                                          err_msg=name)


@pytest.mark.parametrize("bad", [[K_SPARSE, K_SPARSE + 3], [-1, -5]])
def test_reduce_out_of_range_keys_match_jax(bad):
    """Keys outside [0, K): the JAX package wraps a negative key once and
    drops a key >= K from its scatters; the port does the same and never
    indexes out of range, in both modes."""
    import jax.numpy as jnp

    for k, cap in ((K_SPARSE, 64), (32, 64)):
        jr, pr = _reduce_nodes("sum", 0.0, k, ())
        jst = jlow.reduce_state(jr.op, jr.inputs[0].spec, jr.spec)
        pst = plow.reduce_state(pr.inputs[0].spec, pr.spec, "cpu")
        keys = np.zeros(cap, np.int32)
        keys[:4] = [3, 5] + bad
        vals = np.zeros(cap, np.float32)
        vals[:4] = [1.0, 2.0, 4.0, 8.0]
        w = np.zeros(cap, np.int32)
        w[:4] = 1
        jout, jst = jlow.lower_node(jr, jst, [JDeviceDelta(
            jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(w))])
        pout, pst = plow.lower_node(pr, pst, [DeviceDelta(
            torch.from_numpy(keys), torch.from_numpy(vals),
            torch.from_numpy(w))])
        for name in ("wsum", "wcnt", "emitted", "emitted_has"):
            np.testing.assert_array_equal(pst[name].numpy(),
                                          np.asarray(jst[name]),
                                          err_msg=name)


def _host_reads(fn):
    """Host readbacks (``aten::item``) the profiler records while ``fn``
    runs on CPU tensors."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name in ("aten::item", "aten::_local_scalar_dense")
               for e in prof.events())


@pytest.mark.parametrize("vshape", [(), (3,)])
def test_masked_set_reads_nothing_back(vshape):
    """``_masked_set_`` scatters without reading a value back to the host
    (it used to index with 0-d tensors: four ``item`` syncs per call, 20
    a PageRank pass on the card), and still writes exactly the masked
    rows."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((16,) + vshape)
                             .astype(np.float32))
    want = table.clone()
    idx = torch.from_numpy(rng.permutation(16)[:10])
    mask = torch.from_numpy(rng.random(10) < 0.5)
    src = torch.from_numpy(rng.standard_normal((10,) + vshape)
                           .astype(np.float32))
    want[idx[mask]] = src[mask]
    assert _host_reads(lambda: plow._masked_set_(table, idx, mask, src)) == 0
    torch.testing.assert_close(table, want, rtol=0, atol=0)
    before = table.clone()
    plow._masked_set_(table, idx, torch.zeros(10, dtype=torch.bool), src)
    torch.testing.assert_close(table, before, rtol=0, atol=0)
