"""Auxiliary checks of the port against the JAX package, on the CPU:
the ``tests/test_aux.py`` tests no other port test covers, the forced-sync
counter of ``tests/test_runtime_warn.py``, and the two host-boundary
behaviours of ``to_device`` (int8 sources, int32 keys).

Counterparts of ``tests/test_aux.py``'s
``test_device_minmax_buffer_exhaustion_flags_error``,
``test_checkpoint_restores_arena_occupancy``,
``test_device_rejects_oversized_weight_mass``, ``test_tick_many_guards``,
``test_minmax_latch_refresh_soak``,
``test_checkpoint_meta_digest_order_sensitive`` and
``test_drain_rejects_unreachable_source``, and of
``tests/test_runtime_warn.py::test_scheduler_counts_but_advisory_stays_quiet_on_cpu``.
The device tests run on the port's ``"cuda"`` executor at
``device="cpu"`` beside the JAX ``TpuExecutor``; each holds both packages
to the same outcome.
"""

import numpy as np
import pytest
import torch

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.executors import device_delta as jdd
from reflow_tpu.executors import get_executor as j_get_executor
from reflow_tpu.graph import GraphError as JGraphError
from reflow_tpu.utils import checkpoint as jckpt
from reflow_tpu.workloads import pagerank as jpagerank
from reflow_tpu.workloads import wordcount as jwordcount
from reflow_tpu_torch.executors import device_delta as pdd
from reflow_tpu_torch.graph import GraphError as PGraphError
from reflow_tpu_torch.utils import checkpoint as pckpt
from reflow_tpu_torch.utils.faults import DeliveryError
from reflow_tpu_torch.workloads import pagerank as ppagerank
from reflow_tpu_torch.workloads import wordcount as pwordcount

N, E = 48, 200


def _port_ex():
    return P.get_executor("cuda", device="cpu")


#: (package, device executor factory, GraphError, pagerank, wordcount,
#: checkpoint module) for each side
SIDES = {
    "jax": (J, lambda: j_get_executor("tpu"), JGraphError, jpagerank,
            jwordcount, jckpt),
    "port": (P, _port_ex, PGraphError, ppagerank, pwordcount, pckpt),
}


def test_device_minmax_buffer_exhaustion_flags_error():
    """Retraction churn beyond the candidate buffer fails loudly (never a
    silently wrong extremum) at the scheduler, in both packages:
    candidates=1, evict one value, then hollow the buffer."""
    for pkg, ex, *_ in SIDES.values():
        g = pkg.FlowGraph("mm")
        spec = pkg.Spec((), np.float32, key_space=32)
        src = g.source("src", spec)
        mx = g.reduce(src, "max", name="mx", spec=spec, candidates=1)
        g.sink(mx, "out")
        sched = pkg.DirtyScheduler(g, ex())
        sched.push(src, pkg.DeltaBatch(np.array([1, 1]),
                                       np.array([2.0, 1.0], np.float32)))
        sched.tick()    # the buffer holds 2.0; 1.0 evicted to overflow
        sched.push(src, pkg.DeltaBatch(
            np.array([1]), np.array([2.0], np.float32),
            -np.ones(1, np.int64)))
        # the tick itself fails loudly, so corrupt deltas never reach the
        # sink views
        with pytest.raises(RuntimeError, match="min/max"):
            sched.tick()
        with pytest.raises(RuntimeError, match="min/max"):
            sched.read_table(mx)
        assert dict(sched.view("out")) == {(1, 2.0): 1}


def _pagerank_sched(pkg, pr, ex):
    pg = pr.build_graph(N, tol=1e-5)
    sched = pkg.DirtyScheduler(pg.graph, ex, max_loop_iters=500)
    web = pr.WebGraph.random(N, E, seed=2)
    sched.push(pg.teleport, pr.teleport_batch(N))
    sched.push(pg.edges, web.initial_batch())
    sched.tick()
    return sched, pg, web


def test_checkpoint_restores_arena_occupancy(tmp_path):
    """The arena's occupancy (``rcount``) and sticky overflow flag travel
    inside the checkpointed state, so the arena resumes against its true
    occupancy after a restore; the port's equals the JAX package's."""
    occupancy = {}
    for side, (pkg, ex_f, _err, pr, _wc, ck) in SIDES.items():
        ex = ex_f()
        sched, pg, web = _pagerank_sched(pkg, pr, ex)
        join_ids = [n.id for n in pg.graph.nodes
                    if n.kind == "op" and n.op.kind == "join"]
        before = {nid: int(np.max(np.asarray(ex.states[nid]["rcount"])))
                  for nid in join_ids}
        assert any(v > 0 for v in before.values())
        ck.save_checkpoint(sched, str(tmp_path / side))

        ex2 = ex_f()
        sched2 = pkg.DirtyScheduler(pg.graph, ex2, max_loop_iters=500)
        ck.load_checkpoint(sched2, str(tmp_path / side))
        for nid in join_ids:
            assert int(np.max(np.asarray(
                ex2.states[nid]["rcount"]))) == before[nid]
            assert not bool(np.asarray(ex2.states[nid]["error"]))
        # churn after the restore still ticks through the restored arena
        sched2.push(pg.edges, web.churn(0.2))
        assert bool(sched2.tick().quiesced)
        occupancy[side] = sorted(before.values())
    assert occupancy["port"] == occupancy["jax"]


def test_device_rejects_oversized_weight_mass():
    """A batch whose |weight| mass reaches 2**24 would fold through an
    inexact float32 sum: both uploads reject it."""
    for D, dd, kw in ((J, jdd, {}), (P, pdd, {"device": "cpu"})):
        spec = D.Spec((), np.float32, key_space=8)
        b = D.DeltaBatch(np.zeros(2, np.int64), np.ones(2, np.float32),
                         np.array([1 << 23, 1 << 23], np.int64))
        with pytest.raises(ValueError, match="weight mass"):
            dd.to_device(b, spec, **kw)


def test_tick_many_guards():
    """tick_many refuses pending push()es and non-source feeds, and a
    sink-bearing graph aggregates its sink deltas, as in JAX."""
    views = {}
    for side, (pkg, _ex, err, _pr, wc, _ck) in SIDES.items():
        g, src, sink = wc.build_graph()
        sched = pkg.DirtyScheduler(g)
        sched.push(src, wc.ingest_lines(["a b"]))
        with pytest.raises(err, match="pending"):
            sched.tick_many([{src: wc.ingest_lines(["c"])}])
        sched.tick()
        with pytest.raises(err, match="sources"):
            sched.tick_many([{sink: wc.ingest_lines(["c"])}])
        agg = sched.tick_many(
            [{src: wc.ingest_lines(["c d"])},
             {src: wc.ingest_lines(["d"])}]).block()
        assert agg.quiesced
        assert dict(sched.view(sink.name)) and agg.deltas_in == 3
        views[side] = dict(sched.view(sink.name))
    assert views["port"] == views["jax"]


def test_minmax_latch_refresh_soak():
    """The eviction latches are one-way, so a long-running high-churn key
    trips the loud error even when the answer stays derivable from a
    replay; ``refresh_minmax`` resets them from a full-multiset replay.
    The same churn that errors without a refresh stays exact across a
    10k-tick soak with one, on the port's device executor (the JAX side
    of both error cases runs beside it)."""
    def build(pkg, candidates=2):
        spec = pkg.Spec((), np.float32, key_space=8)
        g = pkg.FlowGraph("soak")
        src = g.source("s", spec)
        red = g.reduce(src, "min", name="m", candidates=candidates)
        return g, src, red

    def hollow_cycle(pkg, sched, src, lo):
        """insert {lo, lo+1, lo+2} (evicts lo+2 at candidates=2, latching
        the watermark), then retract lo and lo+1: the buffer hollows past
        the watermark, unknowable from bounded state."""
        vals = np.array([lo, lo + 1.0, lo + 2.0], np.float32)
        sched.push(src, pkg.DeltaBatch(np.zeros(3, np.int64), vals,
                                       np.ones(3, np.int64)))
        sched.tick(sync=False)
        sched.push(src, pkg.DeltaBatch(np.zeros(2, np.int64), vals[:2],
                                       -np.ones(2, np.int64)))
        sched.tick(sync=False)

    def epoch(pkg, sched, src, base_v, refresh_red=None):
        """insert {a,b,c} (c evicts: the watermark latches), retract c
        (the evicted value), retract a, refresh from the true multiset
        {b} (resetting the stale latches), then retract b: the key
        empties cleanly only with the refresh."""
        vals = np.array([base_v, base_v + 1.0, base_v + 2.0], np.float32)
        sched.push(src, pkg.DeltaBatch(np.zeros(3, np.int64), vals,
                                       np.ones(3, np.int64)))
        sched.tick(sync=False)
        for v in (vals[2], vals[0]):
            sched.push(src, pkg.DeltaBatch(np.zeros(1, np.int64),
                                           np.array([v], np.float32),
                                           -np.ones(1, np.int64)))
            sched.tick(sync=False)
        if refresh_red is not None:
            sched.refresh_minmax(refresh_red, pkg.DeltaBatch(
                np.zeros(1, np.int64), vals[1:2], np.ones(1, np.int64)))
        sched.push(src, pkg.DeltaBatch(np.zeros(1, np.int64), vals[1:2],
                                       -np.ones(1, np.int64)))
        sched.tick(sync=False)

    for pkg, ex, *_ in SIDES.values():
        g, src, red = build(pkg)
        sched = pkg.DirtyScheduler(g, ex())
        hollow_cycle(pkg, sched, src, 100.0)
        with pytest.raises(RuntimeError, match="min/max"):
            sched.read_table(red)
        g, src, red = build(pkg)
        sched = pkg.DirtyScheduler(g, ex())
        epoch(pkg, sched, src, 50.0)
        with pytest.raises(RuntimeError, match="min/max"):
            sched.read_table(red)

    # with the refresh: 2,500 epochs x 4 ticks = 10k ticks, exact
    g, src, red = build(P)
    sched = P.DirtyScheduler(g, _port_ex())
    for i in range(2_500):
        epoch(P, sched, src, float(3 * i), refresh_red=red)
        if i % 500 == 499:
            assert sched.read_table(red) == {}   # a sync point, no error
    assert sched.read_table(red) == {}


def test_checkpoint_meta_digest_order_sensitive():
    """The save guard digests the dedup window in order; the port's
    digest is the JAX package's number for the same window."""
    for ck in (jckpt, pckpt):
        a = ck.meta_digest(5, ["s@0", "s@1"])
        assert a != ck.meta_digest(5, ["s@1", "s@0"])
        assert a != ck.meta_digest(6, ["s@0", "s@1"])
        assert a == ck.meta_digest(5, ["s@0", "s@1"])
    for tick, ids in ((5, ["s@0", "s@1"]), (5, ["s@1", "s@0"]),
                      (0, [])):
        assert pckpt.meta_digest(tick, ids) == jckpt.meta_digest(tick, ids)


def test_drain_rejects_unreachable_source():
    """drain() refuses a probe source that cannot reach a deferred loop's
    region, in both packages."""
    for pkg, _ex, err, pr, *_ in SIDES.values():
        pg = pr.build_graph(32, defer_passes=2, arena_capacity=1024)
        other = pg.graph.source("unrelated",
                                pkg.Spec((), np.float32, key_space=8))
        pg.graph.sink(pg.graph.reduce(other, "sum"), "o")
        sched = pkg.DirtyScheduler(pg.graph)
        with pytest.raises(err, match="does not reach"):
            sched.drain(other)


def test_scheduler_counts_no_forced_sync_on_the_cpu_oracle():
    """The forced-sync counter of the CPU oracle stays 0 (``read_table``
    on the oracle is no forced sync), and the port's device executor
    counts its readbacks, as the JAX ``TpuExecutor`` does."""
    counts = {}
    for side, (pkg, ex, *_rest) in SIDES.items():
        for kind, executor in (("cpu", None), ("device", ex())):
            g = pkg.FlowGraph()
            src = g.source("s", pkg.Spec((), np.float32, key_space=8))
            red = g.reduce(src, "sum")
            g.sink(red, "out")
            sched = pkg.DirtyScheduler(g, executor)
            sched.push(src, pkg.DeltaBatch(np.array([1]),
                                           np.array([2.0], np.float32)))
            sched.tick()
            assert sched.read_table(red) == {1: 2.0}
            counts[side, kind] = sched.forced_syncs
    assert counts["port", "cpu"] == counts["jax", "cpu"] == 0
    assert counts["port", "device"] == counts["jax", "device"] > 0


# -- to_device at the host boundary -----------------------------------------

def test_int8_source_zeroes_unit_float_rows_in_both_packages():
    """A unit float32 vector pushed to an int8 k-NN source truncates to
    zeros at the upload, in both packages (the reference's caveat; push
    pre-quantized rows). Integral rows pass through unchanged."""
    rng = np.random.default_rng(3)
    unit = rng.standard_normal((4, 8)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    whole = np.round(unit * 100).astype(np.float32)
    for rows, want in ((unit, np.zeros((4, 8), np.int8)),
                       (whole, whole.astype(np.int8))):
        keys = np.arange(4, dtype=np.int64)
        jd = jdd.to_device(J.DeltaBatch(keys, rows),
                           J.Spec((8,), np.int8, key_space=16))
        pd = pdd.to_device(P.DeltaBatch(keys, rows),
                           P.Spec((8,), np.int8, key_space=16),
                           device="cpu")
        jv = np.asarray(jd.values)[:4]
        pv = pd.values.numpy()[:4]
        assert jv.dtype == pv.dtype == np.int8
        np.testing.assert_array_equal(pv, want)
        np.testing.assert_array_equal(pv, jv)


@pytest.mark.parametrize("bad", [2 ** 31, -2 ** 31 - 1])
def test_to_device_refuses_keys_beyond_int32(bad):
    """The port's per-tick upload raises ``DeliveryError`` for a key
    outside int32, as its ingress queue does, and uploads nothing; the
    JAX ``to_device`` wraps the key silently. Keys at the int32 bounds
    pass in both."""
    spec_j = J.Spec((), np.float32, key_space=2 ** 40)
    spec_p = P.Spec((), np.float32, key_space=2 ** 40)
    keys = np.array([1, bad], np.int64)
    vals = np.ones(2, np.float32)
    with pytest.raises(DeliveryError, match="int32"):
        pdd.to_device(P.DeltaBatch(keys, vals), spec_p, device="cpu")
    wrapped = np.asarray(jdd.to_device(J.DeltaBatch(keys, vals),
                                       spec_j).keys)[:2]
    assert int(wrapped[1]) == int(np.int64(bad).astype(np.int32))
    assert int(wrapped[1]) != bad
    edge = np.array([2 ** 31 - 1, -2 ** 31], np.int64)
    got = pdd.to_device(P.DeltaBatch(edge, vals), spec_p,
                        device="cpu").keys.numpy()[:2]
    want = np.asarray(jdd.to_device(J.DeltaBatch(edge, vals),
                                    spec_j).keys)[:2]
    np.testing.assert_array_equal(got, edge)
    np.testing.assert_array_equal(got, want)


def test_scheduler_push_of_a_key_beyond_int32_raises_before_the_tick():
    """Through the scheduler, the port's device executor refuses the
    batch at the push with ``DeliveryError`` (the upload holds the same
    check); nothing is pending and the tick horizon does not move."""
    g = P.FlowGraph()
    src = g.source("s", P.Spec((), np.float32, key_space=8))
    g.sink(g.reduce(src, "sum"), "out")
    sched = P.DirtyScheduler(g, _port_ex())
    with pytest.raises(DeliveryError, match="int32"):
        sched.push(src, P.DeltaBatch(np.array([2 ** 31], np.int64),
                                     np.ones(1, np.float32)))
    assert not any(sched._pending.values())
    assert sched._tick == 0


def _sharded_sides():
    """(package, sharded executor factory, pagerank, checkpoint module)
    for the port's 8-shard CPU mesh and JAX's 8-device virtual mesh."""
    from reflow_tpu.parallel import make_mesh as jmake_mesh
    from reflow_tpu.parallel.shard import ShardedTpuExecutor
    from reflow_tpu_torch.parallel import make_mesh
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    return {"jax": (J, lambda: ShardedTpuExecutor(jmake_mesh(8)), jpagerank,
                    jckpt),
            "port": (P, lambda: ShardedCudaExecutor(make_mesh(
                8, device="cpu")), ppagerank, pckpt)}


@pytest.fixture
def one_thread():
    """Eight shards of small ops: torch's intra-op thread pool only adds
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpoint_resume_sharded(tmp_path, one_thread):
    """A sharded executor's checkpoint holds the GLOBAL state tree (the
    shards' slices gathered, the per-shard append counters as mesh
    vectors); restoring it onto a fresh mesh scatters it back and the
    ranks read back unchanged. The port's restored ranks equal JAX's
    within 1e-5 and the arena's per-shard occupancy vectors equal."""
    ranks, occupancy = {}, {}
    for side, (pkg, mk, pr, ck) in _sharded_sides().items():
        pg = pr.build_graph(64, tol=1e-5, arena_capacity=1 << 13)
        ex = mk()
        sched = pkg.DirtyScheduler(pg.graph, ex, max_loop_iters=500)
        web = pr.WebGraph.random(64, 256, seed=5)
        sched.push(pg.teleport, pr.teleport_batch(64))
        sched.push(pg.edges, web.initial_batch())
        sched.tick()
        before = sched.read_table(pg.new_rank)
        ck.save_checkpoint(sched, str(tmp_path / side))
        ex2 = mk()
        sched2 = pkg.DirtyScheduler(pg.graph, ex2, max_loop_iters=500)
        ck.load_checkpoint(sched2, str(tmp_path / side))
        restored = sched2.read_table(pg.new_rank)
        assert {k: float(v) for k, v in before.items()} == \
            {k: float(v) for k, v in restored.items()}
        occupancy[side] = np.asarray(ex2.states[pg.join.id]["rcount"]
                                     ).tolist()
        sched2.push(pg.edges, web.churn(0.2))
        assert bool(sched2.tick().quiesced)
        ranks[side] = pr.ranks_to_array(sched2.read_table(pg.new_rank), 64)
    assert occupancy["port"] == occupancy["jax"]
    assert len(occupancy["port"]) == 8
    np.testing.assert_allclose(ranks["port"], ranks["jax"], rtol=0,
                               atol=1e-5 / (1 - ppagerank.DAMPING) + 1e-4)


def test_minmax_latch_refresh_sharded():
    """The routed refresh on an 8-shard mesh: the polluted-latch epoch
    pattern spread over keys owned by different shards; the replay rows
    reach their key's owner, its latches reset, and the final
    retraction leaves the table empty on the port and on JAX's mesh."""
    for side, (pkg, mk, _pr, _ck) in _sharded_sides().items():
        spec = pkg.Spec((), np.float32, key_space=64)
        g = pkg.FlowGraph("soak_sh")
        src = g.source("s", spec)
        red = g.reduce(src, "min", name="m", candidates=2)
        sched = pkg.DirtyScheduler(g, mk())
        for i in range(6):
            k = np.full(3, 9 * i % 64, np.int64)
            vals = np.array([10.0 * i, 10.0 * i + 1, 10.0 * i + 2],
                            np.float32)
            sched.push(src, pkg.DeltaBatch(k, vals, np.ones(3, np.int64)))
            sched.tick(sync=False)
            for v in (vals[2], vals[0]):
                sched.push(src, pkg.DeltaBatch(k[:1], np.array([v],
                                                               np.float32),
                                               -np.ones(1, np.int64)))
                sched.tick(sync=False)
            sched.refresh_minmax(red, pkg.DeltaBatch(
                k[:1], vals[1:2], np.ones(1, np.int64)))
            sched.push(src, pkg.DeltaBatch(k[:1], vals[1:2],
                                           -np.ones(1, np.int64)))
            sched.tick(sync=False)
        assert sched.read_table(red) == {}, side
