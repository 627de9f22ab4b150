"""The port's unique-left Join (dense left table x right append arena)
against the JAX package and the CPU oracle, on the CPU.

Graph level: the join shapes of ``tests/test_tpu_executor.py`` through
the port's ``cuda`` executor on the CPU, the JAX
``TpuExecutor(fixpoint=False)`` and the port's ``CpuExecutor``; views
rounded to 4 places agree exactly (the deep chain within 1e-3, as there).
Lowering level: ``join_core`` on identical random inputs made from a
numpy seed — both delta sides at once, appends that trigger compaction,
out-of-range keys — emits the same rows and leaves the same state as the
JAX ``join_core``, exactly (the merge is one float32 product per row in
both).
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
    return DB(np.array([r[0] for r in rows], dtype=np.int64),
              np.array([r[1] for r in rows], dtype=np.float32),
              np.array([r[2] for r in rows], dtype=np.int64))


def run_all(build, ticks, pkgs=("port", "jax", "cpu")):
    out = {}
    for pkg in pkgs:
        FG, SP, DB = _ns(pkg)
        g, sink = build(FG, SP)
        sched = _sched(pkg, g)
        for tick in ticks:
            for src_name, rows in tick:
                src = next(s for s in g.sources if s.name == src_name)
                sched.push(src, rows if not isinstance(rows, list)
                           else _batch(DB, rows))
            sched.tick()
        out[pkg] = sched
    return out


def _views(scheds, sink):
    return {pkg: {k: round(float(v), 4)
                  for k, v in s.view_dict(sink).items()}
            for pkg, s in scheds.items()}


def test_join_pagerank_shape():
    """Unique-keyed table (left) ⋈ growing arena (right), merge = product
    (``tests/test_tpu_executor.py:104``)."""
    def build(FG, SP):
        g = FG()
        vals = g.source("vals", SP((), np.float32, key_space=K, unique=True))
        edges = g.source("edges", SP((), np.float32, key_space=K))
        tot = g.reduce(vals, "sum", name="uniq")
        j = g.join(tot, edges, merge=lambda k, va, vb: va * vb,
                   spec=SP((), np.float32, key_space=K), arena_capacity=256)
        return g, g.sink(g.reduce(j, "sum", name="joined"), "out")

    v = _views(run_all(build, [
        [("vals", [(1, 10.0, 1), (2, 20.0, 1)]),
         ("edges", [(1, 0.5, 1), (1, 0.25, 1), (2, 1.0, 1)])],
        [("vals", [(1, 10.0, -1), (1, 11.0, 1)])],
        [("edges", [(2, 2.0, 1), (1, 0.5, -1)])],
    ]), "out")
    assert v["port"] == v["jax"] == v["cpu"] == {1: 2.75, 2: 60.0}


def test_deep_chain_multi_tick():
    """map -> filter -> groupby -> reduce joined against a second stream,
    random inserts and retractions over six ticks
    (``tests/test_tpu_executor.py:315``)."""
    rng = np.random.default_rng(42)

    def build(FG, SP):
        spec = SP((), np.float32, key_space=K)
        g = FG()
        a = g.source("a", spec)
        b = g.source("b", spec)
        scaled = g.map(a, lambda v: v * 0.5, vectorized=True)
        pos = g.filter(scaled, lambda v: v > 0.1, vectorized=True)
        regrouped = g.group_by(pos, key_fn=lambda k, v: (k * 7) % K,
                               vectorized=True)
        left = g.reduce(regrouped, "sum", name="lsum",
                        spec=SP((), np.float32, key_space=K, unique=True))
        j = g.join(left, b, merge=lambda k, va, vb: va * vb, spec=spec,
                   arena_capacity=1 << 10, name="j")
        return g, g.sink(g.reduce(j, "sum", name="osum", tol=1e-6), "out")

    history, ticks = [], []
    for _ in range(6):
        n = int(rng.integers(2, 8))
        rows = [(int(rng.integers(0, K)), float(np.float32(rng.normal())), 1)
                for _ in range(n)]
        history.extend(rows)
        if rng.random() < 0.7:
            k0, v0, _ = history[int(rng.integers(0, len(history)))]
            rows.append((k0, v0, -1))
        m = int(rng.integers(1, 4))
        ticks.append([("a", rows), ("b", [
            (int(rng.integers(0, K)), float(np.float32(rng.normal())), 1)
            for _ in range(m)])])
    v = _views(run_all(build, ticks), "out")
    assert set(v["port"]) == set(v["jax"]) == set(v["cpu"])
    for k in v["cpu"]:
        assert abs(v["port"][k] - v["jax"][k]) < 1e-3
        assert abs(v["port"][k] - v["cpu"][k]) < 1e-3


def test_default_merge_concatenates_values():
    """``merge=None`` lowers to the flattened (va ++ vb) row in both
    packages; the CPU oracle's (va, vb) tuple holds the same numbers."""
    def build(FG, SP):
        g = FG()
        a = g.source("a", SP((2,), np.float32, key_space=K, unique=True))
        b = g.source("b", SP((), np.float32, key_space=K))
        left = g.reduce(a, "sum", name="l",
                        spec=SP((2,), np.float32, key_space=K, unique=True))
        j = g.join(left, b, spec=SP((3,), np.float32, key_space=K),
                   arena_capacity=128, name="j")
        return g, g.sink(j, "out")

    rng = np.random.default_rng(3)
    av = rng.integers(-4, 4, (3, 2)).astype(np.float32)

    def pushes(DB):
        return [[("a", DB(np.array([1, 4, 9]), av, np.ones(3, np.int64))),
                 ("b", DB(np.array([1, 1, 9]),
                          np.array([0.5, 2.0, -1.0], np.float32),
                          np.ones(3, np.int64)))],
                [("b", DB(np.array([4, 1]), np.array([3.0, 0.5], np.float32),
                          np.array([1, -1])))]]

    def flat(v):
        if isinstance(v, tuple):
            return tuple(x for e in v for x in flat(e))
        return (float(v),)

    rows = {}
    for pkg in ("port", "jax", "cpu"):
        FG, SP, DB = _ns(pkg)
        g, sink = build(FG, SP)
        sched = _sched(pkg, g)
        for tick in pushes(DB):
            for name, b in tick:
                sched.push(next(s for s in g.sources if s.name == name), b)
            sched.tick()
        rows[pkg] = sorted((int(k), flat(v), w)
                           for (k, v), w in sched.view(sink).items())
    assert rows["port"] == rows["jax"] == rows["cpu"]
    assert len(rows["port"]) == 3


def test_compaction_readback_is_counted():
    """Each tick whose right delta appends reads ``rcount + appends >
    capacity`` back once; the scheduler counts it in ``forced_syncs``."""
    g = P.FlowGraph()
    vals = g.source("vals", P.Spec((), np.float32, key_space=K, unique=True))
    edges = g.source("edges", P.Spec((), np.float32, key_space=K))
    j = g.join(g.reduce(vals, "sum"), edges,
               merge=lambda k, va, vb: va * vb,
               spec=P.Spec((), np.float32, key_space=K), arena_capacity=256)
    g.sink(g.reduce(j, "sum"), "out")
    ex = P.get_executor("cuda", device="cpu")
    sched = P.DirtyScheduler(g, ex)
    sched.push(vals, _batch(P.DeltaBatch, [(1, 2.0, 1)]))
    sched.tick()
    assert ex.host_syncs == 0 and sched.forced_syncs == 1
    for i in range(3):
        sched.push(edges, _batch(P.DeltaBatch, [(1, float(i), 1)]))
        sched.tick()
    assert ex.host_syncs == 3
    assert sched.forced_syncs == 1 + 3 * 2


# -- join_core alone, against the JAX join_core ---------------------------

def _join_nodes(R, vshape_b=(2,)):
    def mk(FG, SP):
        g = FG()
        a = g.source("a", SP((), np.float32, key_space=K, unique=True))
        b = g.source("b", SP(vshape_b, np.float32, key_space=K))
        return g.join(a, b, merge=_merge, spec=SP((2,), np.float32,
                                                  key_space=K),
                      arena_capacity=R)
    return mk(JFlowGraph, JSpec), mk(P.FlowGraph, P.Spec)


def _merge(k, va, vb):
    if isinstance(vb, torch.Tensor):
        return torch.stack([vb[:, 0], va * vb[:, 1]], dim=-1)
    import jax.numpy as jnp

    return jnp.stack([vb[:, 0], va * vb[:, 1]], axis=-1)


def _pair(keys, vals, w):
    import jax.numpy as jnp

    return (JDeviceDelta(jnp.asarray(keys), jnp.asarray(vals),
                         jnp.asarray(w)),
            DeviceDelta(torch.from_numpy(keys.copy()),
                        torch.from_numpy(vals.copy()),
                        torch.from_numpy(w.copy())))


def _assert_same(jout, jst, pout, pst):
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


@pytest.mark.parametrize("seed", range(3))
def test_join_core_matches_jax(seed):
    """Eight passes of random left and right deltas (left retract+insert
    per key, right inserts and retractions replaying earlier rows) into a
    48-row arena: compaction runs, and every pass agrees exactly."""
    rng = np.random.default_rng(seed)
    R, cap = 48, 16
    jn, pn = _join_nodes(R)
    jst = jlow.join_state(jn.op, jn.inputs[0].spec, jn.inputs[1].spec)
    pst = plow.join_state(pn.op, pn.inputs[0].spec, pn.inputs[1].spec, "cpu")
    left = {}
    right = []
    syncs = []
    for step in range(8):
        da = db = None
        if step % 3 != 2:
            keys = np.zeros(cap, np.int32)
            vals = np.zeros(cap, np.float32)
            w = np.zeros(cap, np.int32)
            ks = rng.choice(K, 5, replace=False)
            i = 0
            for k in ks:
                if k in left:                       # retract the old value
                    keys[i], vals[i], w[i] = k, left[k], -1
                    i += 1
                left[k] = np.float32(rng.integers(1, 9) * 0.5)
                keys[i], vals[i], w[i] = k, left[k], 1
                i += 1
            da = _pair(keys, vals, w)
        if step % 3 != 1:
            keys = np.zeros(cap, np.int32)
            vals = np.zeros((cap, 2), np.float32)
            w = np.zeros(cap, np.int32)
            n_ins = int(rng.integers(6, 12))
            for i in range(n_ins):
                row = (int(rng.integers(0, K)),
                       np.float32(rng.integers(0, K)),
                       np.float32(rng.integers(1, 5) * 0.25))
                right.append(row)
                keys[i], vals[i], w[i] = row[0], row[1:], 1
            for i in range(n_ins, cap - 2):
                if right and rng.random() < 0.9:
                    row = right.pop(int(rng.integers(0, len(right))))
                    keys[i], vals[i], w[i] = row[0], row[1:], -1
            db = _pair(keys, vals, w)
        jout, jst = jlow.join_core(jn.op, K, R, np.float32, jst,
                                   None if da is None else da[0],
                                   None if db is None else db[0],
                                   oshape=(2,))
        pout, pst = plow.join_core(pn.op, K, R, torch.float32, pst,
                                   None if da is None else da[1],
                                   None if db is None else db[1],
                                   oshape=(2,),
                                   on_sync=lambda: syncs.append(1))
        _assert_same(jout, jst, pout, pst)
    assert int(pst["gen"]) >= 1 and not bool(pst["error"])
    assert len(syncs) == sum(1 for s in range(8) if s % 3 != 1)


def test_join_core_out_of_range_keys_match_jax():
    """Right-side keys outside [0, K) go into the arena as they are (the
    JAX package appends them raw), gathers from the left table clamp, and
    a left delta's out-of-range keys are dropped from its scatters."""
    R, cap = 64, 8
    jn, pn = _join_nodes(R)
    jst = jlow.join_state(jn.op, jn.inputs[0].spec, jn.inputs[1].spec)
    pst = plow.join_state(pn.op, pn.inputs[0].spec, pn.inputs[1].spec, "cpu")
    ka = np.zeros(cap, np.int32)
    ka[:4] = [0, K - 1, K + 2, -1]
    va = np.zeros(cap, np.float32)
    va[:4] = [1.5, 2.5, 3.5, 4.5]
    wa = np.zeros(cap, np.int32)
    wa[:4] = 1
    kb = np.zeros(cap, np.int32)
    kb[:4] = [0, K + 5, -1, -K - 3]
    vb = np.ones((cap, 2), np.float32)
    wb = np.zeros(cap, np.int32)
    wb[:4] = 1
    for da, db in ((None, _pair(kb, vb, wb)), (_pair(ka, va, wa), None),
                   (_pair(ka, va, -wa), _pair(kb, vb, wb))):
        jout, jst = jlow.join_core(jn.op, K, R, np.float32, jst,
                                   da and da[0], db and db[0], oshape=(2,))
        pout, pst = plow.join_core(pn.op, K, R, torch.float32, pst,
                                   da and da[1], db and db[1], oshape=(2,))
        _assert_same(jout, jst, pout, pst)
