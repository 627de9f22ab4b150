"""Sharded and staged cases of the differential fuzzers, on the CPU.

``tests/test_fuzz_differential.py`` drives random graphs (maps, filters,
re-keys, every reducer, unions, unique- and multiset-left Joins) through
the JAX executors, the sharded and the staged ones among them;
``tests/test_fuzz_linear_fixpoint.py`` drives random declared-linear
loop regions through the sharded fused loop, with and without
``defer_passes``. Here the same grammars, built in the port from the
same seeds (the linear one from ``test_torch_linear_fixpoint.py``), run
through the port's ShardedCudaExecutor (an 8-shard CPU mesh) and
StagedCudaExecutor (two stages), the port's CPU oracle and JAX's
sharded executor. The random graphs' sink views must agree exactly
(values rounded to 3 places, as the reference does); the linear loops'
tables within the reference's ``rtol=5e-4, atol=1e-3``.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.parallel import make_mesh as jmake_mesh
from reflow_tpu.parallel.shard import ShardedTpuExecutor
from reflow_tpu_torch.executors.linear_fixpoint import LinearFixpointProgram
from reflow_tpu_torch.parallel import make_mesh
from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor
from reflow_tpu_torch.parallel.topo import StagedCudaExecutor

from test_torch_linear_fixpoint import (as_vec, build_linear_loop, drive,
                                        make_ticks)

K = 64          # key space: divisible by the 8-shard mesh
N_TICKS = 4
ROWS_PER_TICK = 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_random_graph(pkg, rng: np.random.Generator):
    """The reference's random graph (``test_fuzz_differential.py``) in
    ``pkg``, two contiguous stages split at the median op id."""
    spec = pkg.Spec((), np.float32, key_space=K)
    g = pkg.FlowGraph("fuzz")
    sources = [g.source(f"s{i}", spec) for i in range(rng.integers(1, 3))]
    streams = list(sources)
    uniques = []
    for _ in range(int(rng.integers(4, 9))):
        kind = rng.choice(["map", "filter", "groupby", "reduce", "union",
                           "join"])
        if kind == "map":
            a, b = int(rng.integers(1, 4)), int(rng.integers(0, 5))
            node = g.map(rng.choice(streams),
                         lambda v, a=a, b=b: v * np.float32(a) + np.float32(b),
                         vectorized=True)
            streams.append(node)
        elif kind == "filter":
            c = float(rng.integers(0, 6))
            node = g.filter(rng.choice(streams),
                            lambda v, c=c: v > c, vectorized=True)
            streams.append(node)
        elif kind == "groupby":
            m, s = int(rng.integers(1, 5)), int(rng.integers(0, K))
            node = g.group_by(
                rng.choice(streams),
                key_fn=lambda k, v, m=m, s=s: (k * m + s) % K,
                vectorized=True)
            streams.append(node)
        elif kind == "reduce":
            how = rng.choice(["sum", "count", "mean", "min", "max"])
            node = g.reduce(rng.choice(streams), how,
                            tol=1e-6 if how in ("sum", "mean") else 0.0,
                            candidates=32)
            uniques.append(node)
            streams.append(node)
        elif kind == "union":
            a, b = rng.choice(streams), rng.choice(streams)
            streams.append(g.union(a, b))
        elif kind == "join":
            if uniques and rng.random() < 0.6:
                left, right = rng.choice(uniques), rng.choice(streams)
                w = int(rng.integers(1, 3))
                node = g.join(
                    left, right,
                    merge=lambda k, va, vb, w=w: va + np.float32(w) * vb,
                    arena_capacity=1 << 12)
                streams.append(node)
            else:
                left, right = rng.choice(streams), rng.choice(streams)
                pair = g.join(left, right,
                              spec=pkg.Spec((2,), np.float32, key_space=K),
                              arena_capacity=1 << 12, product_slack=16)
                proj = g.map(pair,
                             lambda v: v[:, 0] + np.float32(2) * v[:, 1],
                             vectorized=True,
                             spec=pkg.Spec((), np.float32, key_space=K))
                node = g.reduce(proj, "sum", tol=1e-6)
                uniques.append(node)
                streams.append(node)
    sink = g.sink(streams[-1], "out")
    op_ids = [n.id for n in g.nodes if n.kind == "op"]
    if op_ids:
        cut = op_ids[len(op_ids) // 2]
        for n in g.nodes:
            if n.kind == "op":
                n.stage = 0 if n.id <= cut else 1
    return g, sources, sink


def random_ticks(rng: np.random.Generator, n_sources: int):
    """Inserts plus exact retractions of earlier rows (the reference's)."""
    ticks = []
    log = [[] for _ in range(n_sources)]
    for _ in range(N_TICKS):
        tick = []
        for s in range(n_sources):
            rows = []
            for _ in range(ROWS_PER_TICK):
                if log[s] and rng.random() < 0.3:
                    k, v, w = log[s].pop(int(rng.integers(0, len(log[s]))))
                    rows.append((k, v, -w))
                else:
                    row = (int(rng.integers(0, K)),
                           float(rng.integers(0, 8)),
                           int(rng.integers(1, 3)))
                    rows.append(row)
                    log[s].append(row)
            tick.append((s, rows))
        ticks.append(tick)
    return ticks


def run_on(pkg, executor, g, sources, sink, ticks):
    sched = pkg.DirtyScheduler(g, executor)
    for tick in ticks:
        for s_ix, rows in tick:
            sched.push(sources[s_ix], pkg.DeltaBatch(
                np.array([r[0] for r in rows], np.int64),
                np.array([r[1] for r in rows], np.float32),
                np.array([r[2] for r in rows], np.int64)))
        sched.tick()
    return Counter({(int(k), round(float(v), 3)): w
                    for (k, v), w in sched.view(sink).items() if w})


@pytest.mark.parametrize("seed", list(range(6)))
def test_random_graph_sharded_and_staged_agree(seed):
    rng = np.random.default_rng(seed)
    graph_seed = rng.integers(0, 1 << 30)
    ticks_seed = rng.integers(0, 1 << 30)
    n_sources = len(build_random_graph(
        P, np.random.default_rng(graph_seed))[1])
    ticks = random_ticks(np.random.default_rng(ticks_seed), n_sources)
    views = {}
    for name, pkg, mk in (
            ("cpu", P, lambda: P.CpuExecutor()),
            ("sharded", P,
             lambda: ShardedCudaExecutor(make_mesh(8, device="cpu"))),
            ("staged", P, lambda: StagedCudaExecutor(devices=["cpu",
                                                              "cpu"])),
            ("jax_sharded", J,
             lambda: ShardedTpuExecutor(jmake_mesh(8)))):
        g, sources, sink = build_random_graph(
            pkg, np.random.default_rng(graph_seed))
        views[name] = run_on(pkg, mk(), g, sources, sink, ticks)
    for name in ("sharded", "staged", "jax_sharded"):
        assert views[name] == views["cpu"], (
            f"seed {seed}: {name} disagrees with the oracle:\n"
            f"only-{name}: {views[name] - views['cpu']}\n"
            f"only-cpu: {views['cpu'] - views[name]}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_linear_loop_sharded_agrees(seed):
    """The sharded fused loop (one region a tick) and its deferred
    schedule (``defer_passes=2`` plus ``drain``) on the random linear
    regions, against the oracle and JAX's sharded fused loop."""
    rng = np.random.default_rng(100 + seed)
    graph_seed = int(rng.integers(0, 1 << 30))
    tick_seed = int(rng.integers(0, 1 << 30))
    _, _, _, _, use_groupby, map_cs = build_linear_loop(
        P, np.random.default_rng(graph_seed))
    map_scale = float(np.prod(map_cs)) if map_cs else 1.0
    ticks = make_ticks(np.random.default_rng(tick_seed), use_groupby,
                       map_scale)
    runs = {
        "cpu": (P, lambda: P.CpuExecutor(), None),
        "sharded": (P, lambda: ShardedCudaExecutor(
            make_mesh(8, device="cpu")), None),
        "sharded_defer2": (P, lambda: ShardedCudaExecutor(
            make_mesh(8, device="cpu")), 2),
        "jax_sharded": (J, lambda: ShardedTpuExecutor(jmake_mesh(8)), None),
    }
    tables = {}
    for name, (pkg, mk, defer) in runs.items():
        g, base, edges, red, _, _ = build_linear_loop(
            pkg, np.random.default_rng(graph_seed), defer=defer)
        ex = mk()
        tables[name] = drive(pkg, ex, g, base, edges, red, ticks,
                             deferred=defer is not None)
        if name.startswith("sharded"):
            assert isinstance(ex._fx_program, LinearFixpointProgram), name
    what = f"seed {seed}: groupby={use_groupby}, maps={map_cs}"
    ref = as_vec(tables["cpu"])
    for name in ("sharded", "sharded_defer2", "jax_sharded"):
        np.testing.assert_allclose(as_vec(tables[name]), ref, rtol=5e-4,
                                   atol=1e-3, err_msg=f"{name}, {what}")
    np.testing.assert_allclose(as_vec(tables["sharded"]),
                               as_vec(tables["jax_sharded"]), rtol=5e-4,
                               atol=1e-3, err_msg=what)


def test_dryrun_multichip_certifies_eight_shards():
    """``parallel.dryrun.dryrun_multichip(8)``: sharded PageRank, fused
    and deferred, within 5e-4 relative of the dense reference."""
    from reflow_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(8, device="cpu")
    assert out["rel_err"] < 5e-4 and out["rel_err_deferred"] < 5e-4
    assert out["passes"][0] > 1
