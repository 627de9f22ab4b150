"""The port's window path (``tick_many`` over the device ingress queue,
``CudaExecutor.run_window``) on the CPU, against its own per-tick path,
the JAX ``TpuExecutor`` window path and the CPU oracle.

The counterpart of ``tests/test_megatick.py``, test for test, plus the
graph kinds the reference windows elsewhere (TF-IDF, k-NN, the row
program) and the two caveats the window path pins. Every result is held
to three things on the same seeded feeds:

- the port's own per-tick path (``tick(sync=False)`` per feed), bit for
  bit: the same float32 bits in every table;
- the JAX window path (``JAX_PLATFORMS=cpu``), exactly where the values
  are integers (every table here sums small integers in float32), and
  PageRank's ranks within 1e-6;
- the CPU oracle, exactly (rounded to 3 places, as the reference does).

The JAX ingress queue reuses one host scratch array per source across
slot writes when its one-time probe says the CPU client copies host
arguments; under load its asynchronous transfers can read a scratch the
next write already refilled, and the reference's own window tests then
fold wrong rows. The fixture below turns that reuse off for the JAX
runs here, so the reference these tests compare against is the one its
code means. It changes nothing in the JAX package.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.graph import GraphError as JGraphError
from reflow_tpu_torch.delta import DeltaBatch, Spec
from reflow_tpu_torch.executors.device_delta import bucket_capacity
from reflow_tpu_torch.executors.ingress_queue import (DeviceIngressQueue,
                                                      slot_nbytes)
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.serve import IngestFrontend
from reflow_tpu_torch.serve.queues import batch_nbytes
from reflow_tpu_torch.utils.faults import DeliveryError

K_SPACE = 32


@pytest.fixture(autouse=True)
def _jax_scratch_copies(monkeypatch):
    import reflow_tpu.executors.ingress_queue as jiq

    monkeypatch.setattr(jiq, "_SCRATCH_REUSE_SAFE", False)


def _port_ex(**kw):
    return P.get_executor("cuda", device="cpu", **kw)


def _batch(pkg, rows):
    return pkg.DeltaBatch(np.array([r[0] for r in rows], np.int64),
                          np.array([r[1] for r in rows], np.float32),
                          np.array([r[2] for r in rows], np.int64))


def _small_graph(pkg=P):
    """source -> map -> union(source2) -> reduce(sum): loop-free,
    sink-free, two sources so per-tick source sets can be ragged."""
    g = pkg.FlowGraph("megatick")
    spec = pkg.Spec((), np.float32, key_space=K_SPACE)
    s0 = g.source("s0", spec)
    s1 = g.source("s1", spec)
    m = g.map(s0, lambda v: v * np.float32(2), vectorized=True)
    u = g.union(m, s1)
    r = g.reduce(u, "sum", tol=0.0)
    return g, (s0, s1), r


def _ragged_ticks(n_ticks=4, rows=6, seed=3):
    """s0 fed every tick, s1 only on even ticks (pad share = 0.25)."""
    rng = np.random.default_rng(seed)
    ticks = []
    for t in range(n_ticks):
        tick = {0: [(int(rng.integers(0, K_SPACE)),
                     float(rng.integers(0, 8)), 1) for _ in range(rows)]}
        if t % 2 == 0:
            tick[1] = [(int(rng.integers(0, K_SPACE)),
                        float(rng.integers(0, 8)), 1) for _ in range(rows)]
        ticks.append(tick)
    return ticks


def _exact(sched, node):
    """{key: float} with the stored float32 bits, no rounding."""
    return {int(k): float(np.asarray(v).reshape(()))
            for k, v in sched.read_table(node).items()}


def _rounded(table):
    return {k: round(v, 3) for k, v in table.items()}


def _oracle(ticks):
    """CPU per-tick drive of the same feeds — the reference views."""
    g, (s0, s1), r = _small_graph()
    sched = P.DirtyScheduler(g, P.CpuExecutor())
    srcs = {0: s0, 1: s1}
    for tick in ticks:
        for s_ix, rows in tick.items():
            sched.push(srcs[s_ix], _batch(P, rows))
        sched.tick()
    return _rounded(_exact(sched, r))


def _per_tick(ticks):
    """The port's own per-tick streaming drive of the same feeds."""
    g, (s0, s1), r = _small_graph()
    sched = P.DirtyScheduler(g, _port_ex())
    srcs = {0: s0, 1: s1}
    results = []
    for tick in ticks:
        for s_ix, rows in tick.items():
            sched.push(srcs[s_ix], _batch(P, rows))
        results.append(sched.tick(sync=False))
    for res in results:
        res.block()
    return _exact(sched, r)


def _window_drive(ticks, k, pkg=P, **tweak):
    """tick_many drive in windows of ``k``; returns (table, sched)."""
    g, (s0, s1), r = _small_graph(pkg)
    ex = _port_ex() if pkg is P else jget_executor("tpu")
    for attr, v in tweak.pop("executor", {}).items():
        setattr(ex, attr, v)
    sched = pkg.DirtyScheduler(g, ex)
    for attr, v in tweak.items():
        setattr(sched, attr, v)
    srcs = {0: s0, 1: s1}
    results = []
    for lo in range(0, len(ticks), k):
        feeds = [{srcs[s_ix]: _batch(pkg, rows)
                  for s_ix, rows in tick.items()}
                 for tick in ticks[lo:lo + k]]
        results.append(sched.tick_many(feeds))
    for res in results:
        res.block()
    return _exact(sched, r), sched


def _held(ticks, got, k, **tweak):
    """``got`` (the port's window table) against the three references."""
    assert got == _per_tick(ticks)                      # bit for bit
    jgot, jsched = _window_drive(ticks, k, pkg=J, **tweak)
    assert got == jgot                                  # integer sums
    assert _rounded(got) == _oracle(ticks)
    return jsched


def _queues(sched):
    return [q for key, q in sched.executor._window_cache.items()
            if key[0] == "ingress_q"]


def test_ragged_feeds_padded_to_window_union():
    """Ragged per-tick feeds ride ONE fused window (zero-row padding for
    the missing source slots) and the views match every reference."""
    ticks = _ragged_ticks()
    got, sched = _window_drive(ticks, k=4)
    jsched = _held(ticks, got, 4)
    assert sched.megatick_windows == jsched.megatick_windows == 1
    assert sched.megatick_fallbacks == 0


def test_divergent_dirty_sets_fall_back_cleanly():
    """With the waste threshold at zero, any padding falls back (counted)
    and the per-tick path still gives the reference views."""
    ticks = _ragged_ticks()
    got, sched = _window_drive(ticks, k=4, megatick_waste=0.0)
    jsched = _held(ticks, got, 4, megatick_waste=0.0)
    assert sched.megatick_windows == 0
    assert sched.megatick_fallbacks == jsched.megatick_fallbacks == 1


def test_over_capacity_batches_fall_back_cleanly():
    """Batches above the executor's per-source row ceiling refuse the
    queue (no crash): the fallback is counted, the views stay right."""
    ticks = _ragged_ticks(rows=12)
    got, sched = _window_drive(ticks, k=4,
                               executor={"megatick_max_rows": 8})
    jsched = _held(ticks, got, 4, executor={"megatick_max_rows": 8})
    assert sched.megatick_windows == 0
    assert sched.megatick_fallbacks == jsched.megatick_fallbacks == 1


def test_queue_and_program_reused_across_windows():
    """Two same-shaped windows share one ingress queue and one window
    program: the second window allocates nothing."""
    ticks = _ragged_ticks(n_ticks=8)
    got, sched = _window_drive(ticks, k=4)
    _held(ticks, got, 4)
    assert sched.megatick_windows == 2
    assert sched.executor.window_dispatches == 2
    (q,) = _queues(sched)
    assert q.generations == 1
    progs = [key for key in sched.executor._window_cache
             if key[0] == "pass_many"]
    assert len(progs) == 1


def test_uniform_feeds_no_fallback_k2():
    """Uniform source sets (zero padding) fuse at any window size."""
    ticks = [{0: [(i, 1.0, 1)], 1: [(i, 2.0, 1)]} for i in range(4)]
    got, sched = _window_drive(ticks, k=2)
    _held(ticks, got, 2)
    assert sched.megatick_windows == 2
    assert sched.megatick_fallbacks == 0


# -- differential fuzz: window sizes x seeds vs the per-tick oracle --------

def _streaming_graph(pkg, rng):
    """test_fuzz_differential's sink-free random graph, built from the
    same draws in either package."""
    from test_fuzz_differential import K

    spec = pkg.Spec((), np.float32, key_space=K)
    g = pkg.FlowGraph("fuzz_stream")
    sources = [g.source(f"s{i}", spec) for i in range(rng.integers(1, 3))]
    streams = list(sources)
    reduces = []
    for _ in range(int(rng.integers(3, 7))):
        kind = rng.choice(["map", "groupby", "reduce", "union"])
        if kind == "map":
            a = int(rng.integers(1, 4))
            streams.append(g.map(rng.choice(streams),
                                 lambda v, a=a: v * np.float32(a),
                                 vectorized=True))
        elif kind == "groupby":
            m = int(rng.integers(1, 5))
            streams.append(g.group_by(
                rng.choice(streams),
                key_fn=lambda k, v, m=m: (k * m) % K, vectorized=True))
        elif kind == "reduce":
            node = g.reduce(rng.choice(streams),
                            rng.choice(["sum", "count"]), tol=0.0)
            reduces.append(node)
            streams.append(node)
        else:
            streams.append(g.union(rng.choice(streams),
                                   rng.choice(streams)))
    if not reduces:
        reduces.append(g.reduce(streams[-1], "sum"))
    return g, sources, reduces


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("seed", [10, 11, 12])
def test_fuzz_window_vs_pertick(seed, k):
    """test_fuzz_differential's streaming generator through the window
    path in windows of ``k``: every aggregate table equals the port's
    per-tick drive bit for bit, the JAX window path's and the oracle's
    (inserts AND retractions)."""
    from test_fuzz_differential import random_ticks

    rng = np.random.default_rng(seed)
    graph_seed = rng.integers(0, 1 << 30)
    ticks_seed = rng.integers(0, 1 << 30)
    n_sources = len(_streaming_graph(
        P, np.random.default_rng(graph_seed))[1])
    ticks = random_ticks(np.random.default_rng(ticks_seed), n_sources)

    def drive(pkg, ex, windowed):
        g, sources, reduces = _streaming_graph(
            pkg, np.random.default_rng(graph_seed))
        sched = pkg.DirtyScheduler(g, ex)
        results = []
        if windowed:
            for lo in range(0, len(ticks), k):
                results.append(sched.tick_many(
                    [{sources[s]: _batch(pkg, rows) for s, rows in tick}
                     for tick in ticks[lo:lo + k]]))
        else:
            for tick in ticks:
                for s, rows in tick:
                    sched.push(sources[s], _batch(pkg, rows))
                results.append(sched.tick(sync=False))
        for res in results:
            res.block()
        return {ix: _exact(sched, node)
                for ix, node in enumerate(reduces)}, sched

    got, sched = drive(P, _port_ex(), True)
    assert got == drive(P, _port_ex(), False)[0]
    assert got == drive(J, jget_executor("tpu"), True)[0]
    oracle = drive(P, P.CpuExecutor(), False)[0]
    assert {ix: _rounded(t) for ix, t in got.items()} == \
        {ix: _rounded(t) for ix, t in oracle.items()}, f"seed {seed} k {k}"
    assert sched.megatick_fallbacks == 0
    assert sched.megatick_windows == len(range(0, len(ticks), k))


# -- loop graphs: the fused PageRank loop and the row program --------------

def _pagerank_window(pkg, n_nodes, n_edges, k, windowed, **ex_kw):
    from reflow_tpu.workloads import pagerank as jpr
    from reflow_tpu_torch.workloads import pagerank as ppr

    pr_mod = jpr if pkg is J else ppr
    web = pr_mod.WebGraph.random(n_nodes, n_edges, seed=5)
    init = web.initial_batch()
    churn = [web.churn(0.02) for _ in range(k)]
    pr = pr_mod.build_graph(n_nodes, tol=1e-5, arena_capacity=1 << 12)
    ex = (jget_executor("tpu", **ex_kw) if pkg is J
          else _port_ex(**ex_kw))
    sched = pkg.DirtyScheduler(pr.graph, ex)
    sched.push(pr.teleport, pr_mod.teleport_batch(n_nodes))
    sched.push(pr.edges, init)
    # synchronous: a streamed tick of the JAX row program would leave its
    # carry pending (see test_carry_after_converged_streamed_tick)
    sched.tick()
    if windowed:
        res = sched.tick_many([{pr.edges: b} for b in churn]).block()
    else:
        for b in churn:
            sched.push(pr.edges, b)
            sched.tick(sync=False)
        res = None
    ranks = pr_mod.ranks_to_array(sched.read_table(pr.new_rank), n_nodes)
    return ranks, sched, res


@pytest.mark.parametrize("linear", [True, False],
                         ids=["fused_loop", "row_program"])
def test_pagerank_loop_window_parity(linear):
    """The loop flavors of the window: a churn window over PageRank
    through the fused delta-vector loop and through the row program
    equals the port's per-tick twin fed identical batches bit for bit,
    the JAX window path within 1e-6, and quiesces every tick."""
    n_nodes, n_edges, k = 128, 512, 4
    kw = {} if linear else {"linear_fixpoint": False}
    got, sched, res = _pagerank_window(P, n_nodes, n_edges, k, True,
                                          **kw)
    per, psched, _ = _pagerank_window(P, n_nodes, n_edges, k, False,
                                         **kw)
    jgot, jsched, _ = _pagerank_window(J, n_nodes, n_edges, k, True,
                                          **kw)
    prog = type(sched.executor._fx_program).__name__
    assert prog == ("LinearFixpointProgram" if linear
                    else "FixpointProgram")
    assert sched.megatick_windows == jsched.megatick_windows == 1
    assert sched.megatick_fallbacks == 0
    assert res.quiesced
    np.testing.assert_array_equal(got, per)
    np.testing.assert_allclose(got, jgot, atol=1e-6)
    assert res.passes == sum(r.passes for r in psched.history[1:])
    if linear:
        assert sched.executor.csr_rebuilds == psched.executor.csr_rebuilds


def test_window_iters_rows_conv_are_device_stacks():
    """A loop window hands back its per-tick iters/rows/converged as [K]
    tensors (device-resident until block()), as the JAX scan does."""
    from reflow_tpu_torch.workloads import pagerank as ppr

    web = ppr.WebGraph.random(128, 512, seed=5)
    pr = ppr.build_graph(128, tol=1e-5, arena_capacity=1 << 12)
    sched = P.DirtyScheduler(pr.graph, _port_ex())
    sched.push(pr.teleport, ppr.teleport_batch(128))
    sched.push(pr.edges, web.initial_batch())
    sched.tick()
    feeds = [{pr.edges.id: web.churn(0.02)} for _ in range(3)]
    plan = sched._dirty_plan([pr.edges.id])
    out = sched.executor.run_window(plan, feeds, sched.max_loop_iters)
    passes_base, iters, rows, conv, _ = out
    assert passes_base == 3
    for col, dt in ((iters, torch.int32), (rows, torch.int64),
                    (conv, torch.bool)):
        assert isinstance(col, torch.Tensor) and col.shape == (3,)
        assert col.dtype == dt
    assert bool(conv.all()) and int(iters.min()) > 0


def test_window_reuses_and_frees_queue_buffers():
    """The port's form of the reference's donation test: PyTorch has no
    donation, so a window reads its slots in place and retiring only
    frees the generation. After each window the generation is free
    again (nothing in flight, one generation in all), every slot of the
    next window is written (an empty window zeroes every slot the last
    one filled), and the next window over the reused buffers still
    matches every reference — no stale rows."""
    ticks = _ragged_ticks(n_ticks=8)
    got, sched = _window_drive(ticks, k=4)
    _held(ticks, got, 4)
    assert sched.megatick_windows == 2
    (queue,) = _queues(sched)
    assert queue.in_flight == 0 and queue.generations == 1
    # the last window's rows are still in the (free) generation...
    assert sum(int(dd.weights.sum()) for dd in queue.stacked().values()) > 0
    # ...until the next window's writes, which cover every slot
    empty = P.DeltaBatch(np.zeros(0, np.int64), np.zeros(0, np.float32),
                         np.zeros(0, np.int64))
    for t in range(4):
        for nid in queue.caps:
            queue.write(t, nid, empty)
    for dd in queue.stacked().values():
        assert int(dd.weights.abs().sum()) == 0
        assert float(dd.values.abs().sum()) == 0.0
        assert int(dd.keys.abs().sum()) == 0


def test_window_program_shared_across_identical_graphs():
    """The reference shares one compiled window program between tenants
    with identically-built graphs (its plan-signature cache). The port's
    window program is an eager pass an executor builds in microseconds,
    so the port shares none: each tenant keeps its own, the views still
    match, and dropping a tenant frees its executor — no process-wide
    cache keeps it, or its state on the device, alive."""
    ticks = _ragged_ticks(n_ticks=4, seed=9)
    got_a, sched_a = _window_drive(ticks, k=4)
    got_b, sched_b = _window_drive(ticks, k=4)
    _held(ticks, got_a, 4)
    assert got_b == got_a
    (key,) = [k for k in sched_a.executor._window_cache
              if k[0] == "pass_many"]
    assert (sched_a.executor._window_cache[key]
            is not sched_b.executor._window_cache[key])
    assert sched_a.megatick_fallbacks == 0
    assert sched_b.megatick_fallbacks == 0
    freed = weakref.ref(sched_a.executor)
    del sched_a
    gc.collect()
    assert freed() is None


# -- the other loop-free graph kinds the reference windows -----------------

def test_tfidf_window_parity():
    """Streaming TF-IDF (config 2's graph) through tick_many windows: the
    tf/df/ndocs tables equal the port's per-tick drive bit for bit and
    the JAX window path's exactly (integer counts), the combined view is
    within 1e-5 of the oracle, and a window reads nothing back."""
    from reflow_tpu.workloads import tfidf as jtf
    from reflow_tpu_torch.workloads import tfidf as ptf

    rng = np.random.default_rng(4)
    vocab = [f"w{i}" for i in range(40)]
    texts = [[" ".join(rng.choice(vocab, size=int(rng.integers(3, 9))))
              for _ in range(4)] for _ in range(6)]

    def drive(pkg, mod, ex, windowed):
        tg = mod.build_graph(n_pairs=512, n_terms=64, n_docs=16)
        sched = pkg.DirtyScheduler(tg.graph, ex)
        corpus = mod.Corpus(512, 64)
        feeds = []
        for t, group in enumerate(texts):
            b = pkg.DeltaBatch.concat(
                [corpus.edit((t * 3 + i) % 16, txt)
                 for i, txt in enumerate(group)])
            feeds.append({tg.tokens: b})
        syncs0 = sched.forced_syncs
        if windowed:
            sched.tick_many(feeds[:3]).block()
            sched.tick_many(feeds[3:]).block()
        else:
            for f in feeds:
                for src, b in f.items():
                    sched.push(src, b)
                sched.tick(sync=False).block()
        syncs = sched.forced_syncs - syncs0
        tables = [{int(k): float(v) for k, v in
                   sched.read_table(n).items()}
                  for n in (tg.tf, tg.df, tg.ndocs)]
        return tables, sched, tg, corpus, syncs

    got, sched, tg, corpus, syncs = drive(P, ptf, _port_ex(), True)
    assert sched.megatick_windows == 2 and sched.megatick_fallbacks == 0
    assert syncs == 0
    assert got == drive(P, ptf, _port_ex(), False)[0]
    assert got == drive(J, jtf, jget_executor("tpu"), True)[0]
    view = ptf.tfidf_view(sched, tg, corpus)
    ref = corpus.reference_tfidf()
    assert set(view) == set(ref)
    for key in ref:
        assert abs(view[key] - ref[key]) < 1e-5


def test_knn_window_parity():
    """The k-NN graph (no sink, no loop) through tick_many windows of
    insert, retract and query-update ticks: ids equal the port's
    per-tick drive and the JAX window path's exactly, scores bit for bit
    against the per-tick drive and within 1e-5 of JAX; the window reads
    back once a tick (the lowering's path choice), as the per-tick path
    does."""
    from reflow_tpu.workloads import knn as jknn
    from reflow_tpu_torch.workloads import knn as pknn

    Q, D, DIM, KK = 8, 256, 16, 4
    rng = np.random.default_rng(6)
    vec = lambda n: rng.standard_normal((n, DIM)).astype(np.float32)
    plan = [("q", np.arange(Q), vec(Q), 1),
            ("d", np.arange(0, 64), vec(64), 1),
            ("d", np.arange(64, 128), vec(64), 1),
            ("d", np.arange(10, 30), np.zeros((20, DIM), np.float32), -1),
            ("q", np.arange(3), vec(3), 1),
            ("d", np.arange(128, 150), vec(22), 1)]

    def drive(pkg, mod, ex, windowed):
        kg = mod.build_graph(Q, D, DIM, KK, scan_chunk=64)
        sched = pkg.DirtyScheduler(kg.graph, ex)
        feeds = [{kg.queries if s == "q" else kg.docs:
                  pkg.DeltaBatch(keys.astype(np.int64), vals,
                                 np.full(len(keys), w, np.int64))}
                 for s, keys, vals, w in plan]
        syncs0 = sched.forced_syncs
        if windowed:
            sched.tick_many(feeds[:3]).block()
            sched.tick_many(feeds[3:]).block()
        else:
            for f in feeds:
                for src, b in f.items():
                    sched.push(src, b)
                sched.tick(sync=False).block()
        syncs = sched.forced_syncs - syncs0
        table = sched.read_table(kg.index)
        return np.stack([table[q] for q in range(Q)]), sched, syncs

    got, sched, syncs = drive(P, pknn, _port_ex(), True)
    per, _, per_syncs = drive(P, pknn, _port_ex(), False)
    jgot, jsched, _ = drive(J, jknn, jget_executor("tpu"), True)
    assert sched.megatick_windows == jsched.megatick_windows == 2
    assert sched.megatick_fallbacks == 0
    assert syncs == per_syncs == len(plan)
    np.testing.assert_array_equal(got, per)
    np.testing.assert_array_equal(got[:, :, 0], jgot[:, :, 0])
    np.testing.assert_allclose(got[:, :, 1], jgot[:, :, 1], atol=1e-5)


# -- the two caveats the window path pins -----------------------------------

def test_int32_key_check_stages_nothing():
    """The port's copy of ``test_int64_keys_beyond_int32_rejected`` at
    the window's two entry points: a key of 2**31 or -2**31 - 1 raises
    ``DeliveryError`` from the queue's ``write`` and from
    ``stage_window``, and nothing is staged (no generation sealed, no
    batch id registered, the tick horizon unchanged)."""
    spec = Spec((), np.float32, key_space=2 ** 40)
    q = DeviceIngressQueue({0: spec}, {0: 64}, 2, placement="cpu")
    for bad in (2 ** 31, -2 ** 31 - 1):
        with pytest.raises(DeliveryError):
            q.write(0, 0, _batch(P, [(bad, 1.0, 1)]))
    q.write(0, 0, _batch(P, [(2 ** 31 - 1, 1.0, 1)]))
    q.write(1, 0, _batch(P, [(-2 ** 31, 1.0, 1)]))
    assert q.writes == 2 and q.in_flight == 0

    g, (s0, _s1), _r = _small_graph()
    sched = P.DirtyScheduler(g, _port_ex())
    for bad in (2 ** 31, -2 ** 31 - 1):
        with pytest.raises(DeliveryError):
            sched.stage_window(
                [{s0: _batch(P, [(1, 1.0, 1)])},
                 {s0: _batch(P, [(bad, 1.0, 1)])}],
                feed_ids=[{s0: ["a"]}, {s0: ["b"]}])
    assert not sched._seen_batch_ids and sched._tick == 0
    assert all(q.in_flight == 0 for q in _queues(sched))


def test_carry_after_converged_streamed_tick():
    """The carry-only pending batch. In streaming mode the JAX executor
    stashes the row program's carry on EVERY tick (a quiescent tick's
    carry is all weight-0 rows), so the next ``tick_many`` refuses to run
    (pending pushes). The port stashes the carry only when a tick did not
    converge: after a converged streamed tick nothing is pending and
    ``tick_many`` runs its window; after a halted tick the live carry is
    pending and ``tick_many`` refuses, as in JAX."""
    from reflow_tpu.workloads import pagerank as jpr
    from reflow_tpu_torch.workloads import pagerank as ppr

    def setup(pkg, pr_mod, ex):
        web = pr_mod.WebGraph.random(64, 256, seed=3)
        pr = pr_mod.build_graph(64, tol=1e-5, arena_capacity=1 << 12)
        sched = pkg.DirtyScheduler(pr.graph, ex)
        sched.push(pr.teleport, pr_mod.teleport_batch(64))
        sched.push(pr.edges, web.initial_batch())
        return sched, pr, web

    sched, pr, web = setup(P, ppr, _port_ex(linear_fixpoint=False))
    assert sched.tick(sync=False).block().quiesced
    assert not any(sched._pending.values())
    sched.tick_many([{pr.edges: web.churn(0.05)}]).block()
    assert sched.megatick_windows == 1

    jsched, jpr_g, jweb = setup(J, jpr, jget_executor(
        "tpu", linear_fixpoint=False))
    assert jsched.tick(sync=False).block().quiesced
    assert any(jsched._pending.values())
    with pytest.raises(JGraphError, match="pending"):
        jsched.tick_many([{jpr_g.edges: jweb.churn(0.05)}])

    # a halted tick leaves its live carry pending in the port too
    sched.max_loop_iters = 1
    sched.push(pr.edges, web.churn(0.05))
    assert not sched.tick(sync=False).block().quiesced
    assert any(sched._pending.values())
    with pytest.raises(GraphError, match="pending"):
        sched.tick_many([{pr.edges: web.churn(0.05)}])


# -- ingress queue unit behavior -------------------------------------------

def test_zero_padding_overwrites_stale_slot():
    """Queue buffers persist across windows: a padding (zero-row) write
    must CLEAR its slot, or the next window would replay last window's
    rows. The zero write moves no host bytes — counted in zero_writes."""
    spec = Spec((), np.float32, key_space=8)
    q = DeviceIngressQueue({0: spec}, {0: 64}, 2, placement="cpu")
    q.write(0, 0, _batch(P, [(1, 2.0, 3)]))
    q.write(1, 0, _batch(P, [(2, 1.0, 1)]))
    stacked = q.stacked()[0]
    assert int(stacked.weights[0].sum()) == 3
    q.write(0, 0, _batch(P, []))          # next window, empty slot
    stacked = q.stacked()[0]
    assert int(stacked.weights[0].sum()) == 0
    assert float(stacked.values[0].abs().sum()) == 0.0
    assert int(stacked.weights[1].sum()) == 1
    assert q.zero_writes == 1


def test_queue_rejects_over_capacity_rows():
    spec = Spec((), np.float32, key_space=8)
    q = DeviceIngressQueue({0: spec}, {0: 4}, 1, placement="cpu")
    with pytest.raises(ValueError):
        q.write(0, 0, _batch(P, [(i % 8, 1.0, 1) for i in range(5)]))


def test_slot_nbytes_is_bucketed_footprint():
    from reflow_tpu.executors.ingress_queue import slot_nbytes as jslot

    spec = Spec((), np.float32, key_space=8)
    cap = bucket_capacity(10)
    assert slot_nbytes(spec, 10) == cap * (4 + 4 + 4)
    vec = Spec((3,), np.float32, key_space=8)
    assert slot_nbytes(vec, 10) == cap * (4 + 4 + 12)
    bf = Spec((3,), torch.bfloat16, key_space=8)
    assert slot_nbytes(bf, 10) == cap * (4 + 4 + 6)
    for rows in (0, 10, 64, 65, 5000):
        assert slot_nbytes(vec, rows) == jslot(
            J.Spec((3,), np.float32, key_space=8), rows)


# -- serve wiring: admission keyed on device queue headroom ----------------

def test_frontend_advertises_megatick_and_device_admission():
    g, _srcs, _r = _small_graph()
    sched = P.DirtyScheduler(g, _port_ex())
    fe = IngestFrontend(sched, start=False)
    assert fe.megatick is True
    assert fe.admission == "device"
    assert fe.depth == 2

    g2, _s, _r2 = _small_graph()
    cpu_sched = P.DirtyScheduler(g2, P.CpuExecutor())
    fe_cpu = IngestFrontend(cpu_sched, start=False)
    assert fe_cpu.megatick is False
    assert fe_cpu.admission == "host"
    assert fe_cpu.depth == 1

    g3, _s3, _r3 = _small_graph()
    fe_host = IngestFrontend(P.DirtyScheduler(g3, _port_ex()),
                             start=False, admission="host")
    assert fe_host.admission == "host"
    with pytest.raises(ValueError):
        IngestFrontend(cpu_sched, start=False, admission="bogus")
    g4, _s4, _r4 = _small_graph()
    nofx = P.DirtyScheduler(g4, _port_ex(fixpoint=False))
    assert IngestFrontend(nofx, start=False).admission == "host"


def test_device_admission_charges_slot_bytes():
    """Under device-keyed admission a host batch charges its bucketed
    queue-slot footprint, not its payload bytes."""
    g, (s0, _s1), _r = _small_graph()
    sched = P.DirtyScheduler(g, _port_ex())
    fe = IngestFrontend(sched, start=False)
    b = _batch(P, [(1, 1.0, 1), (2, 2.0, 1)])
    assert fe._charge_bytes(s0, b, device=False) == slot_nbytes(s0.spec, 2)
    fe.admission = "host"
    assert fe._charge_bytes(s0, b, device=False) == batch_nbytes(b)


def test_frontend_pump_runs_fused_windows():
    """End to end through the serve pump: submissions over a port-backed
    sink-free scheduler commit through the window path; the table equals
    the oracle's."""
    g, (s0, _s1), r = _small_graph()
    sched = P.DirtyScheduler(g, _port_ex())
    fe = IngestFrontend(sched)
    try:
        tks = [fe.submit(s0, _batch(P, [(i % K_SPACE, float(i), 1)]))
               for i in range(8)]
        fe.flush()
    finally:
        fe.close()
    assert all(t.result(timeout=10).applied for t in tks)
    assert sched.megatick_windows >= 1
    assert sched.megatick_fallbacks == 0
    want = {i: float(2 * i) for i in range(8)}
    assert _exact(sched, r) == want


def test_sharded_placement_refused():
    """The JAX queue shards its capacity axis over a ``(mesh, axis)``
    placement; the port has one device and refuses it by name."""
    spec = Spec((), np.float32, key_space=8)
    with pytest.raises(NotImplementedError, match="step 10"):
        DeviceIngressQueue({0: spec}, {0: 64}, 2,
                           placement=(object(), "shard"))


def test_profile_annotation_labels_the_window():
    """A window's call runs under a ``reflow.window[K]`` profiler range
    (the JAX package's ``jax.profiler.TraceAnnotation`` label), and
    ``enabled=False`` runs the block unlabelled."""
    from reflow_tpu_torch.utils.metrics import profile_annotation

    ticks = _ragged_ticks()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _window_drive(ticks, k=4)
        with profile_annotation("reflow.window[9]", enabled=False):
            pass
    names = [e.name for e in prof.events()]
    assert names.count("reflow.window[4]") == 1
    assert "reflow.window[9]" not in names
