"""The port's ShardedCudaExecutor on an 8-shard CPU mesh: counterparts of
``tests/test_sharded.py``, test for test.

Every test feeds the same seeded numpy stream to the port's sharded
executor (``make_mesh(8, device="cpu")``: eight shards of the SPMD
runtime in one process), to the JAX ``ShardedTpuExecutor`` on its
8-device virtual CPU mesh, and to the CPU oracle. Keys, weights and
integer-valued tables are held exactly; PageRank ranks within 1e-5
absolute (float sums in another order), or bit for bit where the test
says so.
"""

import numpy as np
import pytest
import torch

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.parallel import make_mesh as jmake_mesh
from reflow_tpu.parallel.shard import ShardedTpuExecutor
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.parallel import make_mesh, shard_batch
from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor
from reflow_tpu_torch.parallel.spmd import (collective_tally,
                                            reset_collective_tally)
from reflow_tpu_torch.workloads import pagerank as ppr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # eight shards of small ops: torch's intra-op pool only adds
    # contention at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8)


def _mesh(n=8, **kw):
    return make_mesh(n, device="cpu", **kw)


def _reduce_graph(pkg, K=64):
    spec = pkg.Spec((), np.float32, key_space=K)
    g = pkg.FlowGraph("wc")
    src = g.source("src", spec)
    ones = g.map(src, lambda v: v * 0 + 1, vectorized=True, name="ones")
    counts = g.reduce(ones, "sum", name="counts",
                      spec=pkg.Spec((), np.float32, key_space=K))
    g.sink(counts, "out")
    return g, src


def _push_ticks(pkg, sched, src, K, ticks=3):
    rng = np.random.default_rng(0)
    views = []
    for t in range(ticks):
        n = 50 + 30 * t
        keys = rng.integers(0, K, n)
        w = np.where(rng.random(n) < 0.25, -1, 1)
        sched.push(src, pkg.DeltaBatch(keys, np.ones(n, np.float32), w))
        sched.tick()
        views.append({int(k): float(v)
                      for k, v in sched.view_dict("out").items()})
    return views


def test_sharded_reduce_matches_cpu(jmesh):
    K = 64
    out = {}
    for name, pkg, ex in (("port", P, ShardedCudaExecutor(_mesh())),
                          ("jax", J, ShardedTpuExecutor(jmesh)),
                          ("cpu", P, P.CpuExecutor())):
        g, s = _reduce_graph(pkg, K)
        out[name] = _push_ticks(pkg, pkg.DirtyScheduler(g, ex), s, K)
    assert out["port"] == out["cpu"] == out["jax"]


def _pagerank(pkg, ex, seed, tol, churns=2, frac=0.05, N=64, E=512):
    pr = ppr if pkg is P else __import__(
        "reflow_tpu.workloads.pagerank", fromlist=["x"])
    web = pr.WebGraph.random(N, E, seed=seed)
    pg = pr.build_graph(N, tol=tol, arena_capacity=1 << 13)
    sched = pkg.DirtyScheduler(pg.graph, ex, max_loop_iters=500)
    sched.push(pg.teleport, pr.teleport_batch(N))
    sched.push(pg.edges, web.initial_batch())
    assert sched.tick().quiesced
    for _ in range(churns):
        sched.push(pg.edges, web.churn(frac))
        assert sched.tick().quiesced
    return (pr.ranks_to_array(sched.read_table(pg.new_rank), N),
            pr.reference_ranks(web))


def test_sharded_pagerank_matches_single_device(jmesh):
    got, ref = _pagerank(P, ShardedCudaExecutor(_mesh()), 11, 1e-5)
    one, _ = _pagerank(P, P.get_executor("cuda", device="cpu"), 11, 1e-5)
    jsh, _ = _pagerank(J, ShardedTpuExecutor(jmesh), 11, 1e-5)
    # two tol-converged fixpoints summed in different orders differ by up
    # to tol / (1 - damping) (the tol-gated emission lags a key by <= tol,
    # amplified through the rank loop) — the bound test_sharded.py uses
    bound = 1e-5 / (1.0 - ppr.DAMPING) + 1e-4
    np.testing.assert_allclose(got, one, rtol=0, atol=bound)
    np.testing.assert_allclose(got, jsh, rtol=0, atol=bound)
    np.testing.assert_allclose(got, ref, atol=5e-4)


def test_sharded_join_matches_cpu(jmesh):
    K = 32

    def build(pkg):
        left = pkg.Spec((), np.float32, key_space=K, unique=True)
        right = pkg.Spec((), np.float32, key_space=K)
        g = pkg.FlowGraph("j")
        a = g.source("a", left)
        b = g.source("b", right)
        j = g.join(a, b, merge=lambda k, va, vb: va * 10 + vb, spec=right,
                   name="j", arena_capacity=1 << 10)
        g.sink(j, "out")
        return g, a, b

    def drive(pkg, ex):
        g, a, b = build(pkg)
        sched = pkg.DirtyScheduler(g, ex)
        rng = np.random.default_rng(5)
        ka = rng.permutation(K)[:16]
        sched.push(a, pkg.DeltaBatch(ka, ka.astype(np.float32)))
        kb = rng.integers(0, K, 40)
        sched.push(b, pkg.DeltaBatch(kb, np.ones(40, np.float32)))
        sched.tick()
        sched.push(b, pkg.DeltaBatch(kb[:10], np.ones(10, np.float32),
                                     -np.ones(10, np.int64)))
        sched.tick()
        return {(int(k), float(v)): int(w)
                for (k, v), w in sched.view("out").items()}

    port = drive(P, ShardedCudaExecutor(_mesh()))
    assert port == drive(P, P.CpuExecutor())
    assert port == drive(J, ShardedTpuExecutor(jmesh))


def test_key_space_divisibility_enforced():
    g = P.FlowGraph("bad")
    src = g.source("s", P.Spec((), np.float32, key_space=30))
    r = g.reduce(src, "sum", spec=P.Spec((), np.float32, key_space=30))
    g.sink(r, "out")
    with pytest.raises(GraphError, match="multiple of the mesh"):
        P.DirtyScheduler(g, ShardedCudaExecutor(_mesh()))


def test_sharded_route_overflow_surfaces():
    """Key skew past the ROUTE_SLACK budget raises through check_errors
    for a LINEAR reducer (K 512: 64 keys a shard; a 64-row delta is 8 a
    shard, the sparse regime), never a silently wrong aggregate."""
    K = 512
    g, src = _reduce_graph(P, K)
    sh = P.DirtyScheduler(g, ShardedCudaExecutor(_mesh()))
    n = 64
    keys = np.arange(n) % 64       # every key owned by shard 0
    sh.push(src, P.DeltaBatch(keys, np.ones(n, np.float32),
                              np.ones(n, np.int64)))
    with pytest.raises(RuntimeError, match="route overflow"):
        sh.tick()


def test_sharded_linear_fixpoint_engages(jmesh):
    """The fused delta-vector loop runs on the sharded executor (one SPMD
    region a tick, a psum_scatter a pass) and matches the single-device
    executor and JAX's sharded run."""
    reset_collective_tally()
    ex = ShardedCudaExecutor(_mesh())
    got, _ = _pagerank(P, ex, 21, 1e-6)
    assert ex._linear_fixpoint and ex._linear_structure is not None
    assert type(ex._fx_program).__name__ == "LinearFixpointProgram"
    assert collective_tally()[("psum_scatter", ("delta",))][0] > 0
    one, _ = _pagerank(P, P.get_executor("cuda", device="cpu"), 21, 1e-6)
    jex = ShardedTpuExecutor(jmesh)
    jsh, _ = _pagerank(J, jex, 21, 1e-6)
    assert jex._linear_fixpoint
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, jsh, rtol=1e-6, atol=1e-7)


def test_sharded_join_routed_path_differential(jmesh):
    """Large deltas take the routed (all_to_all) Join path — a
    per-destination budget of >= 64 rows on 8 shards."""
    K, rows = 1024, 2048

    def build(pkg):
        spec = pkg.Spec((), np.float32, key_space=K)
        g = pkg.FlowGraph("join")
        ls = g.source("L", spec)
        rs = g.source("R", spec)
        lt = g.reduce(ls, "sum", name="lt")
        j = g.join(lt, rs, merge=lambda k, x, y: x + y, spec=spec, name="j",
                   arena_capacity=1 << 15)
        g.sink(j, "out")
        return g, ls, rs

    def drive(pkg, ex):
        g, ls, rs = build(pkg)
        sched = pkg.DirtyScheduler(g, ex)
        r = np.random.default_rng(5)
        lk = r.integers(0, K, rows)
        sched.push(ls, pkg.DeltaBatch(
            lk, r.integers(0, 100, rows).astype(np.float32),
            np.ones(rows, np.int64)))
        sched.tick()
        rk = r.integers(0, K, rows)
        sched.push(rs, pkg.DeltaBatch(
            rk, r.integers(0, 100, rows).astype(np.float32),
            np.ones(rows, np.int64)))
        sched.tick()
        sched.push(rs, pkg.DeltaBatch(rk[:rows // 2],
                                      np.zeros(rows // 2, np.float32),
                                      -np.ones(rows // 2, np.int64)))
        sched.tick()
        return dict(sched.view("out"))

    reset_collective_tally()
    port = drive(P, ShardedCudaExecutor(_mesh()))
    assert collective_tally()[("all_to_all", ("delta",))][0] > 0
    assert port == drive(P, P.CpuExecutor())
    assert port == drive(J, ShardedTpuExecutor(jmesh))


def _minmax_ticks(K):
    rng = np.random.default_rng(8)
    inserted, ticks = [], []
    for _ in range(3):
        rows = []
        for _ in range(96):
            if inserted and rng.random() < 0.3:
                k, v = inserted.pop(int(rng.integers(0, len(inserted))))
                rows.append((k, v, -1))
            else:
                k, v = int(rng.integers(0, K)), float(rng.integers(-50, 50))
                rows.append((k, v, 1))
                inserted.append((k, v))
        ticks.append(rows)
    return ticks


def test_sharded_minmax_matches_cpu(jmesh):
    K = 64
    for how in ("min", "max"):
        out = {}
        for name, pkg, ex in (("port", P, ShardedCudaExecutor(_mesh())),
                              ("jax", J, ShardedTpuExecutor(jmesh)),
                              ("cpu", P, P.CpuExecutor())):
            g = pkg.FlowGraph(how)
            src = g.source("s", pkg.Spec((), np.float32, key_space=K))
            g.sink(g.reduce(src, how, name="m"), "out")
            sched = pkg.DirtyScheduler(g, ex)
            for rows in _minmax_ticks(K):
                sched.push(src, pkg.DeltaBatch(
                    np.array([r[0] for r in rows]),
                    np.array([r[1] for r in rows], np.float32),
                    np.array([r[2] for r in rows])))
                sched.tick()
            out[name] = {int(k): float(v)
                         for k, v in sched.view_dict("out").items()}
        assert out["port"] == out["cpu"] == out["jax"], how


def test_sharded_minmax_buffer_exhaustion_flags_error():
    K = 64
    g = P.FlowGraph("mm1")
    src = g.source("s", P.Spec((), np.float32, key_space=K))
    g.sink(g.reduce(src, "max", name="m", candidates=1), "out")
    sh = P.DirtyScheduler(g, ShardedCudaExecutor(_mesh()))
    sh.push(src, P.DeltaBatch(np.array([3, 3]),
                              np.array([2.0, 1.0], np.float32),
                              np.ones(2, np.int64)))
    sh.tick()
    sh.push(src, P.DeltaBatch(np.array([3]), np.array([2.0], np.float32),
                              -np.ones(1, np.int64)))
    with pytest.raises(RuntimeError, match="min/max"):
        sh.tick()


def test_sharded_macro_tick_matches_sequential():
    """tick_many on the sharded executor runs the SPMD tick per window
    slot and equals sequential streaming ticks bit for bit."""
    N, E, K = 64, 256, 3

    def prep():
        web = ppr.WebGraph.random(N, E, seed=23)
        pg = ppr.build_graph(N, tol=1e-5, arena_capacity=1 << 13)
        sched = P.DirtyScheduler(pg.graph, ShardedCudaExecutor(_mesh()),
                                 max_loop_iters=500)
        sched.push(pg.teleport, ppr.teleport_batch(N))
        sched.push(pg.edges, web.initial_batch())
        sched.tick()
        return pg, sched, [web.churn(0.1) for _ in range(K)]

    pg_a, sched_a, churns = prep()
    for b in churns:
        sched_a.push(pg_a.edges, b)
        sched_a.tick(sync=False)
    pg_b, sched_b, churns_b = prep()
    agg = sched_b.tick_many([{pg_b.edges: b} for b in churns_b]).block()
    assert agg.quiesced
    assert sched_b.megatick_windows == 1
    a = sched_a.read_table(pg_a.new_rank)
    b = sched_b.read_table(pg_b.new_rank)
    assert set(a) == set(b)
    for k in a:
        assert float(a[k]) == float(b[k])


def test_shard_batch_presharded_ingress_matches_host_push():
    """shard_batch builds a row-sharded device batch from per-shard host
    chunks; pushing it equals pushing the same rows as one host batch."""
    K = 64
    rng = np.random.default_rng(21)
    n = 8 * 16
    keys = rng.integers(0, K, n)
    w = np.where(rng.random(n) < 0.25, -1, 1)
    vals = np.ones(n, np.float32)
    mesh = _mesh()
    g1, s1 = _reduce_graph(P, K)
    a = P.DirtyScheduler(g1, ShardedCudaExecutor(mesh))
    a.push(s1, P.DeltaBatch(keys, vals, w))
    a.tick()
    g2, s2 = _reduce_graph(P, K)
    b = P.DirtyScheduler(g2, ShardedCudaExecutor(mesh))
    chunks = [P.DeltaBatch(keys[i::8], vals[i::8], w[i::8])
              for i in range(8)]
    b.push(s2, shard_batch(chunks, s2.spec, mesh))
    b.tick()
    assert dict(a.view_dict("out")) == dict(b.view_dict("out"))


def test_two_axis_dcn_mesh_single_controller():
    """make_mesh(8, dcn=2): the executor shards over the flattened (dcn,
    delta) product axis and matches the 1-axis result."""
    flat, _ = _pagerank(P, ShardedCudaExecutor(_mesh()), 41, 1e-5,
                        churns=1)
    ex = ShardedCudaExecutor(_mesh(dcn=2))
    assert ex.axis == ("dcn", "delta") and ex.n == 8
    dcn, ref = _pagerank(P, ex, 41, 1e-5, churns=1)
    np.testing.assert_allclose(flat, dcn, rtol=0,
                               atol=1e-5 / (1.0 - ppr.DAMPING) + 1e-4)
    np.testing.assert_allclose(dcn, ref, atol=5e-4)


def test_placement_helpers_follow_the_executor_layout():
    """``shard_state_tree`` splits dim 0 where it divides the mesh and
    copies the rest whole, each shard's piece its own tensor on its
    device, as the executor places a Reduce's tables; ``replicate``
    gives every shard a copy."""
    from reflow_tpu_torch.parallel import replicate, shard_state_tree

    g, src = _reduce_graph(P, 64)
    ex = ShardedCudaExecutor(_mesh())
    sched = P.DirtyScheduler(g, ex)
    _push_ticks(P, sched, src, 64, ticks=1)
    glob = ex.state_snapshot()
    red = next(n for n in g.nodes if n.name == "counts")
    pieces = shard_state_tree({red.id: glob[red.id]}, ex.mesh)
    assert len(pieces) == 8
    for r in range(8):
        mine = ex.shard_states(r)[red.id]
        for k, t in pieces[r][red.id].items():
            assert torch.equal(t, mine[k]), (r, k)
            assert t.data_ptr() != mine[k].data_ptr()
    copies = replicate({"w": torch.arange(4.0)}, ex.mesh)
    assert len({c["w"].data_ptr() for c in copies}) == 8
    assert all(c["w"].tolist() == [0.0, 1.0, 2.0, 3.0] for c in copies)


def test_model_axis_refused_by_name():
    """A (delta, model) mesh builds and the executor takes its model
    axis: the data axis is the other one. A model axis the mesh lacks,
    or one that leaves no data axis, is refused by name."""
    from reflow_tpu_torch.parallel import make_model_mesh

    mm = make_model_mesh(4, 2, device="cpu")
    assert mm.shape == {"delta": 4, "model": 2} and mm.size == 8
    ex = ShardedCudaExecutor(mm, model_axis="model")
    assert ex.axis == "delta" and ex.n == 4 and ex.m == 2
    with pytest.raises(GraphError, match="model_axis 'mp'"):
        ShardedCudaExecutor(mm, model_axis="mp")
    with pytest.raises(GraphError, match="no data axis"):
        ShardedCudaExecutor(make_mesh(4, axis_name="model", device="cpu"),
                            model_axis="model")
    with pytest.raises(GraphError, match="power of two"):
        ShardedCudaExecutor(make_mesh(6, device="cpu"))
