"""The port's StagedCudaExecutor: counterparts of ``tests/test_topo.py``.

Graph stages run one pass each, their state pinned to the stage's
device, boundary deltas handed over with ``.to(device)``. On the CPU
every device is ``cpu``, so the placement test reads the executor's
stage-to-device map and the devices its state tensors sit on.
"""

import time

import numpy as np
import pytest
import torch

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.parallel.topo import StagedTpuExecutor
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.parallel.topo import StagedCudaExecutor
from reflow_tpu_torch.utils.tree import tree_leaves

K = 64


def _two_stage_graph(pkg):
    """Stage 0: map + reduce; stage 1: join against a second source."""
    spec = pkg.Spec((), np.float32, key_space=K)
    g = pkg.FlowGraph("staged")
    src = g.source("src", spec)
    doubled = g.map(src, lambda v: 2.0 * v, vectorized=True, name="x2")
    totals = g.reduce(doubled, "sum", name="totals")
    rsrc = g.source("right", spec)
    j = g.join(totals, rsrc, merge=lambda k, a, b: a + b, spec=spec,
               name="j", arena_capacity=1 << 10)
    g.sink(j, "out")
    for node in (doubled, totals):
        node.stage = 0
    j.stage = 1
    return g, src, rsrc


def _drive(pkg, sched, src, rsrc):
    rng = np.random.default_rng(3)
    views = []
    for t in range(3):
        n = 40 + 10 * t
        sched.push(src, pkg.DeltaBatch(
            rng.integers(0, K, n), rng.integers(1, 9, n).astype(np.float32),
            np.where(rng.random(n) < 0.2, -1, 1)))
        kb = rng.integers(0, K, 16)
        sched.push(rsrc, pkg.DeltaBatch(kb, np.ones(16, np.float32),
                                        np.ones(16, np.int64)))
        sched.tick()
        views.append({(int(k), float(v)): int(w)
                      for (k, v), w in sched.view("out").items()})
    return views


def test_staged_matches_unpartitioned_and_cpu():
    outs = {}
    for name, pkg, ex in (
            ("staged", P, StagedCudaExecutor(device="cpu")),
            ("cuda", P, P.get_executor("cuda", device="cpu")),
            ("cpu", P, P.CpuExecutor()),
            ("jax", J, StagedTpuExecutor())):
        g, src, rsrc = _two_stage_graph(pkg)
        outs[name] = _drive(pkg, pkg.DirtyScheduler(g, ex), src, rsrc)
    assert outs["staged"] == outs["cuda"] == outs["cpu"] == outs["jax"]


def test_staged_states_live_on_stage_devices():
    """Two stages on two devices: each op's state sits on its stage's
    device (the executor's map says which; on the CPU both are cpu)."""
    g, src, rsrc = _two_stage_graph(P)
    ex = StagedCudaExecutor(devices=["cpu", "cpu"])
    sched = P.DirtyScheduler(g, ex)
    _drive(P, sched, src, rsrc)
    totals = next(n for n in g.nodes if n.name == "totals")
    j = next(n for n in g.nodes if n.name == "j")
    assert ex.stage_of(totals) == 0 and ex.stage_of(j) == 1
    assert sorted(ex.stage_devices) == [0, 1]
    for node in (totals, j):
        dev = ex.stage_devices[ex.stage_of(node)]
        assert all(t.device == dev for t in tree_leaves(ex.states[node.id])
                   if isinstance(t, torch.Tensor))
    assert ex.device_label == "cpu"


def test_staged_rejects_backwards_stage_edge():
    spec = P.Spec((), np.float32, key_space=K)
    g = P.FlowGraph("bad")
    src = g.source("s", spec)
    a = g.map(src, lambda v: v, vectorized=True, name="a")
    r = g.reduce(a, "sum", name="r")
    g.sink(r, "out")
    a.stage = 1
    r.stage = 0
    with pytest.raises(GraphError, match="backwards in stages"):
        P.DirtyScheduler(g, StagedCudaExecutor(device="cpu"))


def test_staged_overhead_is_bounded():
    """Splitting a compute-bound two-stage graph over two devices costs at
    most a bounded handoff overhead against the same staged path on one,
    and gives the same table (within 1e-5 relative)."""
    Kk, D, ROWS, TICKS, CHAIN = 64, 64, 128, 6, 4

    def heavy(p, v):
        for _ in range(CHAIN):
            v = torch.tanh(v @ p)
        return v

    def run(devices):
        g = P.FlowGraph("pipe")
        src = g.source("x", P.Spec((D,), np.float32, key_space=Kk))
        rng = np.random.default_rng(0)
        W = (rng.standard_normal((D, D)) * 0.05).astype(np.float32)
        m0 = g.map(src, heavy, vectorized=True, params=W, name="m0")
        m1 = g.map(m0, heavy, vectorized=True, params=W.copy(), name="m1")
        gb = g.group_by(m1, key_fn=lambda k, v: k % Kk, vectorized=True)
        red = g.reduce(gb, "sum", name="agg")
        m0.stage = 0
        for n in (m1, gb, red):
            n.stage = 1
        sched = P.DirtyScheduler(g, StagedCudaExecutor(devices=devices))
        rng = np.random.default_rng(7)

        def batch():
            return P.DeltaBatch(
                np.arange(ROWS) % Kk,
                rng.standard_normal((ROWS, D)).astype(np.float32),
                np.ones(ROWS, np.int64))

        sched.push(src, batch())
        sched.tick(sync=False)
        sched.read_table(red)
        t0 = time.perf_counter()
        for _ in range(TICKS):
            sched.push(src, batch())
            sched.tick(sync=False)
        table = sched.read_table(red)
        return time.perf_counter() - t0, table

    w1, t1 = run(["cpu"])
    w2, t2 = run(["cpu", "cpu"])
    assert set(t1) == set(t2)
    for k in t1:
        np.testing.assert_allclose(t1[k], t2[k], rtol=1e-5)
    assert w2 < 2.0 * w1 + 0.25, (w1, w2)
