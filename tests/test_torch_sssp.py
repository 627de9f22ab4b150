"""Incremental SSSP (the min-plus fixpoint, ``workloads/sssp.py``) on the
port's ``cuda`` executor, on the CPU, against the port's CPU oracle, the
JAX ``TpuExecutor`` and Bellman-Ford, at N = 48 nodes.

The loop is not linear, so the port runs it through the row fixpoint
program (``analyze_linear`` refuses it), as the JAX executor runs its
own. Distances are sums of integer weights in float32, exact: every
table is compared exactly, and the passes of each tick equal JAX's.
"""

import numpy as np
import pytest

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.workloads import sssp as jsp
from reflow_tpu_torch.executors.fixpoint import FixpointProgram, analyze
from reflow_tpu_torch.executors.linear_fixpoint import analyze_linear
from reflow_tpu_torch.workloads import sssp as psp

N = 48


def random_graph(rng, n_edges=160):
    src = rng.integers(0, N, n_edges)
    dst = rng.integers(0, N, n_edges)
    w = rng.integers(1, 10, n_edges).astype(np.float32)
    return src, dst, w


def _sched(pkg, sg, max_iters=None, **kw):
    it = psp.max_loop_iters(N) if max_iters is None else max_iters
    if pkg == "jax":
        return JDirtyScheduler(sg.graph, jget_executor("tpu"),
                               max_loop_iters=it)
    ex = (P.get_executor("cuda", device="cpu", **kw) if pkg == "port"
          else P.CpuExecutor())
    return P.DirtyScheduler(sg.graph, ex, max_loop_iters=it)


def as_dict(table):
    return {int(k): float(np.asarray(v).reshape(())) for k, v in
            table.items()}


def drive(pkg, src, dst, w, extra_ticks=(), candidates=16, **kw):
    mod = jsp if pkg == "jax" else psp
    sg = mod.build_graph(N, candidates=candidates)
    sched = _sched(pkg, sg, **kw)
    sched.push(sg.seeds, mod.seed_batch(0))
    sched.push(sg.edges, mod.edge_batch(src, dst, w))
    passes = [sched.tick().passes]
    for s, d, ww, weight in extra_ticks:
        sched.push(sg.edges, mod.edge_batch(s, d, ww, weight=weight))
        r = sched.tick()
        assert r.quiesced
        passes.append(r.passes)
    return as_dict(sched.read_table(sg.best)), passes, sched, sg


def _churn(rng, src, dst, w):
    """Delete 12 random edges, then insert 12 fresh ones."""
    ix = rng.choice(len(src), 12, replace=False)
    ns, nd = rng.integers(0, N, 12), rng.integers(0, N, 12)
    nw = rng.integers(1, 10, 12).astype(np.float32)
    keep = np.setdiff1d(np.arange(len(src)), ix)
    final = (np.concatenate([src[keep], ns]), np.concatenate([dst[keep], nd]),
             np.concatenate([w[keep], nw]))
    return [(src[ix], dst[ix], w[ix], -1), (ns, nd, nw, 1)], final


@pytest.mark.parametrize("seed", [7, 8])
def test_device_matches_cpu_and_jax_including_churn(seed):
    """Cold build, a deletion tick and an insertion tick: the port's
    table equals the CPU oracle's, JAX's and Bellman-Ford's over the
    final edges, and every tick ran as many passes as JAX's."""
    rng = np.random.default_rng(seed)
    src, dst, w = random_graph(rng)
    ticks, (fs, fd, fw) = _churn(rng, src, dst, w)
    got = {pkg: drive(pkg, src, dst, w, ticks)
           for pkg in ("port", "jax", "cpu")}
    ref = psp.reference_distances(N, fs, fd, fw, 0)
    assert got["port"][0] == got["jax"][0] == got["cpu"][0] == ref
    assert got["port"][1] == got["jax"][1]
    # the host-driven loop runs the same passes
    host = drive("port", src, dst, w, ticks, fixpoint=False)
    assert host[0] == ref and host[1] == got["port"][1]


def test_analyze_linear_refuses_the_loop():
    """The min-plus loop is no linear chain: the executor runs the row
    program, and no sticky flag is set along the way."""
    rng = np.random.default_rng(1)
    _, _, sched, sg = drive("port", *random_graph(rng))
    ex = sched.executor
    st = analyze(sg.graph)
    assert st is not None and analyze_linear(sg.graph, st) is None
    assert type(ex._fx_program) is FixpointProgram
    ex.check_errors()


def test_orphaned_cycle_repaired_in_place():
    """Deleting the only edge into a cycle orphans it: the tick halts at
    ``max_loop_iters`` and pauses (its carry re-enters as pending), and
    ``affected_set`` + ``repair`` re-derive the region in place."""
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 1])
    w = np.ones(3, np.float32)
    sg = psp.build_graph(N)
    sched = _sched("port", sg)
    sched.push(sg.seeds, psp.seed_batch(0))
    sched.push(sg.edges, psp.edge_batch(src, dst, w))
    assert sched.tick().quiesced
    dist_prev = as_dict(sched.read_table(sg.best))
    assert dist_prev == {0: 0.0, 1: 1.0, 2: 2.0}
    sched.push(sg.edges, psp.edge_batch(src[:1], dst[:1], w[:1], weight=-1))
    assert not sched.tick().quiesced      # divergence detected (paused)
    aff = psp.affected_set(N, src[1:], dst[1:], w[1:], dist_prev,
                           src[:1], dst[:1], w[:1])
    assert aff == {1, 2}
    r1, r2 = psp.repair(sched, sg, src[1:], dst[1:], w[1:], aff)
    assert r1.quiesced and r2.quiesced
    got = as_dict(sched.read_table(sg.best))
    assert got == psp.reference_distances(N, src[1:], dst[1:], w[1:], 0)
    assert got == {0: 0.0}


def test_tree_edge_deletion_repair_is_incremental():
    """A tree-edge deletion strands a sub-cycle on a larger graph: the
    repair touches the affected region only (delta-ops far below the
    cold build) and lands on Bellman-Ford, same scheduler."""
    rng = np.random.default_rng(5)
    star_d = np.arange(8, N)
    n_base = 200
    bsrc = np.where(rng.random(n_base) < 0.2, 0, rng.integers(8, N, n_base))
    bdst = rng.integers(8, N, n_base)
    src = np.concatenate([np.zeros(len(star_d), np.int64), bsrc,
                          [0, 1, 2, 3, 3, 4]])
    dst = np.concatenate([star_d, bdst, [1, 2, 3, 1, 4, 5]])
    w = np.concatenate([rng.integers(1, 10, len(star_d) + n_base),
                        np.ones(6)]).astype(np.float32)
    sg = psp.build_graph(N)
    sched = _sched("port", sg)
    sched.push(sg.seeds, psp.seed_batch(0))
    sched.push(sg.edges, psp.edge_batch(src, dst, w))
    cold = sched.tick()
    assert cold.quiesced
    dist_prev = as_dict(sched.read_table(sg.best))
    d = len(src) - 6
    cut = slice(d, d + 1)
    sched.push(sg.edges, psp.edge_batch(src[cut], dst[cut], w[cut],
                                        weight=-1))
    assert not sched.tick().quiesced
    keep = np.r_[0:d, d + 1:len(src)]
    aff = psp.affected_set(N, src[keep], dst[keep], w[keep], dist_prev,
                           src[cut], dst[cut], w[cut])
    assert {1, 2, 3} <= aff
    r1, r2 = psp.repair(sched, sg, src[keep], dst[keep], w[keep], aff)
    assert r1.quiesced and r2.quiesced
    repair_ops = r1.block().delta_ops + r2.block().delta_ops
    assert repair_ops < cold.block().delta_ops / 2
    assert as_dict(sched.read_table(sg.best)) == psp.reference_distances(
        N, src[keep], dst[keep], w[keep], 0)


def test_paused_iteration_resumes_exactly():
    """A tick halted at ``max_loop_iters`` = 3 resumes in later ticks to
    the same fixpoint a single big-budget tick reaches, pass for pass as
    JAX resumes it."""
    rng = np.random.default_rng(9)
    src, dst, w = random_graph(rng, n_edges=200)

    def run(pkg, budget_first):
        mod = jsp if pkg == "jax" else psp
        sg = mod.build_graph(N)
        sched = _sched(pkg, sg, max_iters=budget_first)
        sched.push(sg.seeds, mod.seed_batch(0))
        sched.push(sg.edges, mod.edge_batch(src, dst, w))
        r = sched.tick()
        passes = [r.passes]
        sched.max_loop_iters = mod.max_loop_iters(N)
        while not r.quiesced:
            r = sched.tick()
            passes.append(r.passes)
        return as_dict(sched.read_table(sg.best)), passes

    paused, p_passes = run("port", 3)
    assert len(p_passes) > 1
    assert paused == run("port", psp.max_loop_iters(N))[0]
    assert (paused, p_passes) == run("jax", 3)


def _replay(sg, table, src, dst, w, keys):
    """The live candidate multiset of ``keys``: ``d(u) + w`` for each
    edge ``u -> v`` whose ``u`` has a distance, and the seed at 0."""
    rows = [(0, 0.0)] if 0 in keys else []
    for u, v, ww in zip(src, dst, w):
        if int(v) in keys and int(u) in table:
            rows.append((int(v), np.float32(table[int(u)]) + np.float32(ww)))
    return P.DeltaBatch(np.array([k for k, _ in rows], np.int64),
                        np.array([x for _, x in rows], np.float32),
                        np.ones(len(rows), np.int64))


def test_refresh_minmax_keeps_the_table_and_clears_latches():
    """After a cold build and a deletion tick through four-candidate
    buffers (rows evicted: latches set), ``refresh_minmax`` over every key
    with at most four distinct live candidates rebuilds their buffers
    from the replay:
    the table is unchanged, their latches clear, the error flag clear;
    the next churn tick still equals Bellman-Ford."""
    rng = np.random.default_rng(3)
    src, dst, w = random_graph(rng)
    ticks, (fs, fd, fw) = _churn(rng, src, dst, w)
    table, _, sched, sg = drive("port", src, dst, w, ticks[:1],
                                candidates=4)
    # the live edges: the cold set minus the deleted ones
    live = list(zip(src, dst, w))
    for e in zip(*ticks[0][:3]):
        live.remove(e)
    s_, d_, w_ = (np.array(c) for c in zip(*live))
    st = sched.executor.states[sg.best.id]
    assert bool(st["over_maybe_pos"].any())
    cands = {}
    for u, v, ww in zip(s_, d_, w_):
        if int(u) in table:
            cands.setdefault(int(v), set()).add(
                float(np.float32(table[int(u)]) + np.float32(ww)))
    keys = {k for k, c in cands.items() if len(c) <= 4} - {0}
    assert any(bool(st["over_maybe_pos"][k]) for k in keys)
    sched.refresh_minmax(sg.best, _replay(sg, table, s_, d_, w_, keys))
    assert as_dict(sched.read_table(sg.best)) == table
    st = sched.executor.states[sg.best.id]
    assert not bool(st["error"])
    assert not any(bool(st["over_maybe_pos"][k]) for k in keys)
    # the oracle ignores refresh_minmax; the tables stay in step after
    sched.push(sg.edges, psp.edge_batch(*ticks[1][:3]))
    assert sched.tick().quiesced
    assert as_dict(sched.read_table(sg.best)) == \
        psp.reference_distances(N, fs, fd, fw, 0)
