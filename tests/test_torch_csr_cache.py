"""The fused loop's persistent CSR cache in the port, on the CPU: the
three single-device cases of ``tests/test_csr_cache.py``.

The sorted arena base persists across ticks on the executor (one cache
per join) and each tick sorts only the append tail; a full rebuild
happens when the tail outgrows its window or a compaction bumps the
arena's ``gen``, and a state restore drops the cache. Each case runs
against the port's CPU oracle and asserts, from the executor's
``csr_rebuilds`` counts, that its regime really happened. Tolerance:
``2e-3`` absolute against the oracle (float32 device sums against the
oracle's float64, both tol-gated), as in the JAX tests.
"""

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu_torch.executors.linear_fixpoint import LinearFixpointProgram
from reflow_tpu_torch.workloads import pagerank

TOL = 1e-5
BOUND = TOL / (1.0 - pagerank.DAMPING) + 1e-4


def _executor(name):
    if name == "cpu":
        return P.CpuExecutor()
    return P.get_executor("cuda", device="cpu")


def _drive(name, web, churn, ticks, arena_capacity):
    pg = pagerank.build_graph(web.n_nodes, tol=TOL,
                              arena_capacity=arena_capacity)
    sched = P.DirtyScheduler(pg.graph, _executor(name), max_loop_iters=500)
    sched.push(pg.teleport, pagerank.teleport_batch(web.n_nodes))
    sched.push(pg.edges, web.initial_batch())
    assert sched.tick().quiesced
    #: per loop tick: (rebuild cause or None, tail rows)
    sched.csr_log = []
    for _ in range(ticks):
        sched.push(pg.edges, web.churn(churn))
        assert sched.tick().quiesced
        last = getattr(sched.executor, "_fx_program", None)
        if isinstance(last, LinearFixpointProgram):
            sched.csr_log.append((last.last_tick["csr"],
                                  last.last_tick["tail_rows"]))
    return pagerank.ranks_to_array(sched.read_table(pg.new_rank),
                                   web.n_nodes), sched, pg


def test_tail_accumulation_and_overflow_rebuild_match_oracle():
    """arena 1<<15 -> tail window 4096; churn(1.0) appends 1024 rows a
    tick, so the tail overflows (forcing a rebuild) every ~4 ticks across
    10 ticks, with plain tail ticks in between."""
    web_a = pagerank.WebGraph.random(64, 512, seed=31)
    web_b = pagerank.WebGraph.random(64, 512, seed=31)
    ranks_t, sched, pg = _drive("cuda", web_a, 1.0, 10, 1 << 15)
    ranks_c, _, _ = _drive("cpu", web_b, 1.0, 10, 1 << 15)
    assert np.array_equal(web_a.dst, web_b.dst)
    np.testing.assert_allclose(ranks_t, ranks_c, atol=2e-3)
    ex = sched.executor
    prog = ex._fx_program
    assert isinstance(prog, LinearFixpointProgram) and prog.Ft == 4096
    assert ex.csr_rebuilds["initial"] == 1
    assert ex.csr_rebuilds["tail"] == 2, ex.csr_rebuilds
    assert ex.csr_rebuilds["gen"] == 0
    # between rebuilds the cache persisted and each tick sorted only its
    # growing tail: 1024 appended rows a tick
    assert sched.csr_log == [
        (None, 1024), (None, 2048), (None, 3072), (None, 4096),
        ("tail", 0), (None, 1024), (None, 2048), (None, 3072),
        (None, 4096), ("tail", 0)], sched.csr_log
    assert ex._csr_cache[pg.join.id]["count"] > 0


def test_compaction_gen_bump_invalidates_csr():
    """A 1024-row arena compacts repeatedly under heavy churn; every
    compaction bumps the arena's gen, which forces a CSR rebuild, and the
    ranks keep matching the oracle."""
    web_a = pagerank.WebGraph.random(48, 384, seed=33)
    web_b = pagerank.WebGraph.random(48, 384, seed=33)
    ranks_t, sched, pg = _drive("cuda", web_a, 0.5, 8, 1 << 10)
    ranks_c, _, _ = _drive("cpu", web_b, 0.5, 8, 1 << 10)
    assert np.array_equal(web_a.dst, web_b.dst)
    np.testing.assert_allclose(ranks_t, ranks_c, atol=2e-3)
    ex = sched.executor
    jst = ex.states[pg.join.id]
    gen = int(jst["gen"])
    assert gen > 0 and int(jst["rcount"]) <= 1 << 10
    # one rebuild per compaction that a loop tick saw
    assert ex.csr_rebuilds["gen"] == gen, (ex.csr_rebuilds, gen)
    assert ex._csr_cache[pg.join.id]["gen"] == gen


def test_state_restore_invalidates_csr_cache():
    """Two histories can share a (gen, rcount) pair over different arena
    rows, so a restore drops the sorted-arena cache. Diverge after a
    snapshot, restore it, replay the original churn: the ranks equal a
    run from scratch over the same delta sequence."""
    web = pagerank.WebGraph.random(64, 512, seed=37)
    pg = pagerank.build_graph(64, tol=TOL, arena_capacity=1 << 15)
    sched = P.DirtyScheduler(pg.graph, _executor("cuda"), max_loop_iters=500)
    sched.push(pg.teleport, pagerank.teleport_batch(64))
    sched.push(pg.edges, web.initial_batch())
    sched.tick()
    sched.push(pg.edges, web.churn(1.0))
    sched.tick()
    ex = sched.executor
    snap = ex.state_snapshot()
    dst_at_save = web.dst.copy()

    # diverge: more churn ticks advance (and re-sort) the arena + cache
    for _ in range(3):
        sched.push(pg.edges, web.churn(1.0))
        sched.tick()
    assert pg.join.id in ex._csr_cache

    # restore the earlier history into the SAME warm executor
    ex.state_restore(snap)
    assert not ex._csr_cache
    before = ex.csr_rebuilds["initial"]
    web.dst = dst_at_save
    replay = web.churn(1.0)
    sched.push(pg.edges, replay)
    assert sched.tick().quiesced
    assert ex.csr_rebuilds["initial"] == before + 1
    restored = pagerank.ranks_to_array(sched.read_table(pg.new_rank), 64)

    # a fresh run over the identical delta sequence
    web2 = pagerank.WebGraph.random(64, 512, seed=37)
    pg2 = pagerank.build_graph(64, tol=TOL, arena_capacity=1 << 15)
    s2 = P.DirtyScheduler(pg2.graph, _executor("cuda"), max_loop_iters=500)
    s2.push(pg2.teleport, pagerank.teleport_batch(64))
    s2.push(pg2.edges, web2.initial_batch())
    s2.tick()
    s2.push(pg2.edges, web2.churn(1.0))
    s2.tick()
    s2.push(pg2.edges, replay)
    assert s2.tick().quiesced
    fresh = pagerank.ranks_to_array(s2.read_table(pg2.new_rank), 64)
    # not bitwise: the restored run rebuilds with another base/tail split
    # (another summation order); a stale cache would push values through
    # the wrong arena rows, errors ~1e-1
    np.testing.assert_allclose(restored, fresh, atol=BOUND)


@pytest.fixture
def one_thread():
    """Eight shards of small ops: torch's intra-op thread pool only adds
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_csr_cache_sharded_matches_single_device(one_thread):
    """One persistent CSR cache per shard over its arena slice: the same
    churn on an 8-shard mesh, the single device and JAX's sharded run;
    the two tol-converged fixpoints agree within ``BOUND``."""
    from reflow_tpu.parallel import make_mesh as jmake_mesh
    from reflow_tpu.parallel.shard import ShardedTpuExecutor
    from reflow_tpu.scheduler import DirtyScheduler as JDirtyScheduler
    from reflow_tpu.workloads import pagerank as jpr
    from reflow_tpu_torch.parallel import make_mesh
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    ranks = {}
    for name, mod, mk in (
            ("sharded", pagerank,
             lambda: ShardedCudaExecutor(make_mesh(8, device="cpu"))),
            ("single", pagerank, lambda: _executor("cuda")),
            ("jax", jpr, lambda: ShardedTpuExecutor(jmake_mesh(8)))):
        web = mod.WebGraph.random(64, 512, seed=35)
        pg = mod.build_graph(64, tol=TOL, arena_capacity=1 << 15)
        ex = mk()
        sched = (JDirtyScheduler if mod is jpr else P.DirtyScheduler)(
            pg.graph, ex, max_loop_iters=500)
        sched.push(pg.teleport, mod.teleport_batch(64))
        sched.push(pg.edges, web.initial_batch())
        sched.tick()
        for _ in range(6):
            sched.push(pg.edges, web.churn(1.0))
            assert sched.tick().quiesced
        if name == "sharded":
            assert isinstance(ex._fx_program, LinearFixpointProgram)
            assert sorted(ex._csr_cache) == [(pg.join.id, r)
                                             for r in range(8)]
        ranks[name] = mod.ranks_to_array(sched.read_table(pg.new_rank), 64)
    np.testing.assert_allclose(ranks["sharded"], ranks["single"], rtol=0,
                               atol=BOUND)
    np.testing.assert_allclose(ranks["sharded"], ranks["jax"], rtol=0,
                               atol=BOUND)
