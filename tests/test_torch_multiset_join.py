"""The port's multiset-left Join (both sides append arenas, both
δ-products key-matched pair enumerations at a fixed budget) against the
JAX package and the CPU oracle, on the CPU; and the per-kind sticky-error
messages of the port's executor.

Graph level, mirroring ``tests/test_multiset_join.py``: the default merge
and a custom merge with a vector left side, through the port's ``cuda``
executor (``device="cpu"``), the JAX ``TpuExecutor`` and the port's
``CpuExecutor``; views equal exactly (values rounded to 3 places, as
there). Budget overflow sets the sticky error; the default-merge spec is
checked at ``bind``; ``read_table`` refuses a multiset join. Lowering
level: ``join_core`` over the multiset state on identical random deltas
with small arenas, so both arenas compact: emitted rows and every state
array bit-equal to the JAX ``join_core`` after every step.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu import DeltaBatch as JDeltaBatch
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu import FlowGraph as JFlowGraph
from reflow_tpu import Spec as JSpec
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.executors import lowerings as jlow
from reflow_tpu.executors.device_delta import DeviceDelta as JDeviceDelta
from reflow_tpu_torch.executors import lowerings as plow
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.graph import GraphError

K = 16


def _ns(pkg):
    if pkg == "jax":
        return JFlowGraph, JSpec, JDeltaBatch
    return P.FlowGraph, P.Spec, P.DeltaBatch


def _sched(pkg, g):
    if pkg == "jax":
        return JDirtyScheduler(g, jget_executor("tpu"))
    return P.DirtyScheduler(g, P.get_executor("cuda", device="cpu")
                            if pkg == "port" else P.CpuExecutor())


def _flat(v):
    if isinstance(v, tuple):
        out = []
        for x in v:
            out.extend(_flat(x) if isinstance(x, tuple) else [float(x)])
        return tuple(round(x, 3) for x in out)
    return tuple(round(float(x), 3) for x in np.asarray(v).ravel())


def _view(sched, sink):
    return Counter({(int(k), _flat(v)): w
                    for (k, v), w in sched.view(sink).items() if w})


def build_default(FG, SP, arena=2048, slack=4):
    g = FG("msj")
    a = g.source("a", SP((), np.float32, key_space=K))
    b = g.source("b", SP((), np.float32, key_space=K))
    j = g.join(a, b, spec=SP((2,), np.float32, key_space=K),
               arena_capacity=arena, product_slack=slack)
    g.sink(j, "out")
    return g, a, b, j


def _b(DB, keys, vals, w):
    return DB(np.asarray(keys, np.int64), np.asarray(vals, np.float32),
              np.asarray(w, np.int64))


def drive_default(pkg):
    FG, SP, DB = _ns(pkg)
    g, a, b, _ = build_default(FG, SP)
    sched = _sched(pkg, g)
    # tick 1: multiset left (repeated key 3, weight-2 row), right rows
    sched.push(a, _b(DB, [3, 3, 5], [1., 2., 7.], [1, 2, 1]))
    sched.push(b, _b(DB, [3, 5, 5], [10., 20., 30.], [1, 1, 1]))
    sched.tick()
    # tick 2: left retraction + insert, another right row
    sched.push(a, _b(DB, [3, 5], [1., 9.], [-1, 1]))
    sched.push(b, _b(DB, [3], [40.], [1]))
    sched.tick()
    # tick 3: right retraction (pairs with all left rows of that key)
    sched.push(b, _b(DB, [5], [20.], [-1]))
    sched.tick()
    return _view(sched, "out"), sched


def test_default_merge_differential():
    views = {pkg: drive_default(pkg)[0] for pkg in ("port", "jax", "cpu")}
    assert views["cpu"]
    assert views["port"] == views["jax"] == views["cpu"]


def test_both_sides_read_back_once_each():
    """A tick with both sides live makes two compact-or-append decisions
    on the host, a tick with one side one."""
    _, sched = drive_default("port")
    assert sched.executor.host_syncs == 2 + 2 + 1


def _custom_merge(k, va, vb):
    if getattr(va, "ndim", 1) <= 1:       # host per-row form
        return np.float64(va[0]) * vb + va[1]
    return va[:, 0] * vb + va[:, 1]


def drive_custom(pkg):
    FG, SP, DB = _ns(pkg)
    g = FG("msjc")
    a = g.source("a", SP((2,), np.float32, key_space=K))
    b = g.source("b", SP((), np.float32, key_space=K))
    j = g.join(a, b, merge=_custom_merge,
               spec=SP((), np.float32, key_space=K), arena_capacity=2048)
    g.sink(j, "out")
    sched = _sched(pkg, g)
    sched.push(a, _b(DB, [2, 2], [[2., 1.], [3., 0.]], [1, 1]))
    sched.push(b, _b(DB, [2, 2], [5., 6.], [1, 2]))
    sched.tick()
    sched.push(a, _b(DB, [2], [[2., 1.]], [-1]))
    sched.tick()
    return _view(sched, "out")


def test_custom_merge_vector_left_differential():
    views = {pkg: drive_custom(pkg) for pkg in ("port", "jax", "cpu")}
    assert views["cpu"]
    assert views["port"] == views["jax"] == views["cpu"]


def test_product_budget_overflow_sticky_error():
    """A true pair count beyond product_slack x delta capacity fails
    loudly at the tick's error check, never by silent truncation."""
    FG, SP, DB = _ns("port")
    g, a, b, _ = build_default(FG, SP, slack=1)
    sched = _sched("port", g)
    # 60 left rows on one key, then 60 right rows on it: the δB product
    # wants 60 * 60 = 3600 pairs against a budget of 1 * 64
    sched.push(a, _b(DB, np.full(60, 3), np.arange(60), np.ones(60)))
    sched.tick()
    sched.push(b, _b(DB, np.full(60, 3), np.arange(60), np.ones(60)))
    with pytest.raises(RuntimeError, match="product budget"):
        sched.tick()


def test_default_merge_spec_shape_validated_at_bind():
    g = P.FlowGraph("msv")
    a = g.source("a", P.Spec((), np.float32, key_space=K))
    b = g.source("b", P.Spec((), np.float32, key_space=K))
    g.join(a, b, arena_capacity=2048)   # default out spec: scalar (wrong)
    g.sink(g.nodes[-1], "out")
    with pytest.raises(GraphError, match="flat value elements"):
        P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))


def test_read_table_rejects_multiset_join():
    FG, SP, DB = _ns("port")
    g, a, b, j = build_default(FG, SP)
    sched = _sched("port", g)
    sched.push(a, _b(DB, [1], [1.], [1]))
    sched.tick()
    with pytest.raises(KeyError, match="multiset"):
        sched.read_table(j)


# -- join_core over the multiset state, against the JAX join_core ----------

def _nodes(La, R, vshape_a=()):
    def mk(FG, SP):
        g = FG()
        a = g.source("a", SP(vshape_a, np.float32, key_space=K))
        b = g.source("b", SP((), np.float32, key_space=K))
        flat = int(np.prod(vshape_a or (1,))) + 1
        return g.join(a, b, spec=SP((flat,), np.float32, key_space=K),
                      arena_capacity=R, left_arena_capacity=La,
                      product_slack=4)
    return mk(JFlowGraph, JSpec), mk(P.FlowGraph, P.Spec)


def _pair(keys, vals, w):
    return (JDeviceDelta(jnp.asarray(keys), jnp.asarray(vals),
                         jnp.asarray(w)),
            DeviceDelta(torch.from_numpy(keys.copy()),
                        torch.from_numpy(vals.copy()),
                        torch.from_numpy(w.copy())))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _side(rng, live, cap, vshape):
    """A delta of fresh rows and retractions of live ones (``live`` is
    the side's multiset model, updated in place)."""
    keys = np.zeros(cap, np.int32)
    vals = np.zeros((cap,) + vshape, np.float32)
    w = np.zeros(cap, np.int32)
    n_ins = int(rng.integers(4, cap // 2))
    for i in range(n_ins):
        row = (int(rng.integers(0, K)),
               tuple(float(x) for x in rng.integers(0, 6, vshape or (1,))))
        live.append(row)
        keys[i], vals[i], w[i] = row[0], np.reshape(row[1], vshape), 1
    for i in range(n_ins, cap - 2):
        if live and rng.random() < 0.8:
            row = live.pop(int(rng.integers(0, len(live))))
            keys[i], vals[i], w[i] = row[0], np.reshape(row[1], vshape), -1
    return _pair(keys, vals, w)


@pytest.mark.parametrize("vshape_a", [(), (2,)])
@pytest.mark.parametrize("seed", range(2))
def test_join_core_multiset_matches_jax(seed, vshape_a):
    """Ten steps of random left and right deltas (one side or both) into
    a 40-row left arena and a 48-row right arena: both compact, and every
    step agrees bit for bit (rows, arenas, counts, generations)."""
    rng = np.random.default_rng(seed)
    La, R, cap = 40, 48, 16
    jn, pn = _nodes(La, R, vshape_a)
    jst = jlow.join_state(jn.op, jn.inputs[0].spec, jn.inputs[1].spec)
    pst = plow.join_state(pn.op, pn.inputs[0].spec, pn.inputs[1].spec, "cpu")
    left, right = [], []
    oshape = (int(np.prod(vshape_a or (1,))) + 1,)
    syncs = []
    for step in range(10):
        da = _side(rng, left, cap, vshape_a) if step % 3 != 2 else None
        db = _side(rng, right, cap, ()) if step % 3 != 1 else None
        jout, jst = jlow.join_core(jn.op, K, R, np.float32, jst,
                                   da and da[0], db and db[0],
                                   oshape=oshape)
        pout, pst = plow.join_core(pn.op, K, R, torch.float32, pst,
                                   da and da[1], db and db[1],
                                   oshape=oshape,
                                   on_sync=lambda: syncs.append(1))
        np.testing.assert_array_equal(pout.weights.numpy(),
                                      np.asarray(jout.weights))
        live = pout.weights.numpy() != 0
        np.testing.assert_array_equal(pout.keys.numpy()[live],
                                      np.asarray(jout.keys)[live])
        np.testing.assert_array_equal(_bits(pout.values.numpy()[live]),
                                      _bits(np.asarray(jout.values)[live]))
        assert set(pst) == set(jst)
        for name, a in jst.items():
            np.testing.assert_array_equal(_bits(pst[name].numpy()),
                                          _bits(a), err_msg=name)
    assert int(pst["gen"]) >= 1 and int(pst["lgen"]) >= 1
    assert not bool(pst["error"])
    assert len(syncs) == sum((s % 3 != 2) + (s % 3 != 1) for s in range(10))


# -- per-kind sticky-error messages ---------------------------------------

def _flag(sched, node):
    sched.executor.states[node.id]["error"] = torch.ones((), dtype=torch.bool)


def _error_graphs():
    spec = P.Spec((), np.float32, key_space=8)
    uniq = P.Spec((), np.float32, key_space=8, unique=True)

    def minmax():
        g = P.FlowGraph()
        return g, g.reduce(g.source("s", spec), "min", name="lowest")

    def join():
        g = P.FlowGraph()
        return g, g.join(g.source("a", uniq), g.source("b", spec),
                         merge=lambda k, x, y: x * y, spec=spec,
                         arena_capacity=64, name="j")

    def multiset():
        g = P.FlowGraph()
        return g, g.join(g.source("a", spec), g.source("b", spec),
                         spec=P.Spec((2,), np.float32, key_space=8),
                         arena_capacity=64, name="mj")

    return {"minmax": (minmax, "candidate buffer"),
            "join": (join, "stable_key=True"),
            "multiset_join": (multiset, "product budget")}


@pytest.mark.parametrize("kind", sorted(_error_graphs()))
def test_error_reason_names_the_node_kind(kind):
    """A set sticky flag reads as its own node kind's cause, from both
    ``check_errors`` and ``read_table`` (the min/max buffer exhausted is
    not reported as an arena overflow, nor the other way round)."""
    build, phrase = _error_graphs()[kind]
    g, node = build()
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    _flag(sched, node)
    others = {p for k, (_, p) in _error_graphs().items() if k != kind}
    with pytest.raises(RuntimeError) as err:
        sched.executor.check_errors()
    assert phrase in str(err.value)
    assert not any(p in str(err.value) for p in others), str(err.value)
    with pytest.raises(RuntimeError, match=phrase):
        sched.read_table(node)
