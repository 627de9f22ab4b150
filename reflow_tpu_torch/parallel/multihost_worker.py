"""One process of a mesh that spans processes: the port's counterpart of
the JAX package's two-process DCN-mesh worker.

Run one per process, all with the same arguments but the process id::

    python -m reflow_tpu_torch.parallel.multihost_worker COORD PID NPROC \\
        --backend gloo --device cpu --out tables-PID.npz [--case pagerank]

``COORD`` is ``host:port`` (process 0 listens there). Each process joins
the group (``parallel/dist.py``), builds ``make_mesh(NPROC * --delta,
dcn=NPROC)`` (each dcn row one process's shards) and runs a case:

- ``pagerank`` (config 3's graph): the build and ``--churn-ticks`` churn
  ticks, ingested through ``shard_batch_process_local`` (each process
  contributes its stripe of every global batch), its owned ranks checked
  against ``pagerank.reference_ranks``; then the exactly-once round: a
  ``SourceCursor`` id pushed twice dedups on every process, the digests
  agree, a collective save (``--ckpt``) is restored into a fresh
  scheduler, one more churn tick runs on both, and their owned shards
  agree. ``--drift`` instead registers one extra batch id on process 1
  before the save, which must raise the digest ``RuntimeError``.
- ``knn`` (config 4's graph at ``--q/--docs/--dim/--k``): host batches
  (global: every process pushes the same) — the queries, a preload, the
  inserts, a retraction and a query update — one tick each; the sharded
  k-NN's scan, ring merge and incremental top-k run across the process
  boundary.
- ``stream``: a keyed min Reduce into a sink, streaming ticks
  (``tick(sync=False)``) of which three give sink rows to one process
  only: the scheduler's sink branch and the error check must still run
  on every process.

- ``window``: the window path across the processes. Config 3's build
  tick, then a churn window of ``WINDOW_K`` ticks through
  ``tick_many`` (global host batches: each process's ingress queue
  holds its own shards' slots), a collective checkpoint between windows
  restored into a fresh scheduler and one more window on both; then the
  k-NN feed through an ``IngestFrontend`` at depth 2 (windows of 2
  ticks, pumped in this thread so every process forms the same
  windows). ``--window-fault`` makes the last process raise inside the
  first churn window: every process must fail within the group timeout
  (the summary's ``window_failed`` and ``failed_after_s``).

- ``badkey``: ``shard_batch_process_local`` where only the last
  process's chunk holds a key at its Spec's ``key_space``: every process
  must raise the same ``DeliveryError`` at once (the summary's
  ``refused`` and ``refused_after_s``), and a clean call after it must
  still meet in the gather (``after``, the rows this process holds).

``--no-fixpoint`` has the scheduler drive a loop's passes itself (its
next-pass branch then reads every process's egress counts).

Each tick's owned tables (every state of the shards this process steps,
or with ``--record ranks`` only the rank table) go to ``--out`` (an
``.npz``; keys ``<tick tag>/r<rank>/<node id>/<leaf path>``), so the
caller can hold them against a twin: the same case functions below run
a single-controller mesh of the same shape (:func:`twin_batch` lays a
global batch out as the processes' stripes). The last stdout line is a
JSON summary: the backend, the bytes staged across the boundary, the
boundary exchanges by kind, the kernel launches, the tick times and the
seconds from start to the group's ready point.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

_T0 = time.time()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from reflow_tpu_torch.delta import DeltaBatch, Spec  # noqa: E402
from reflow_tpu_torch.executors.device_delta import (  # noqa: E402
    DeviceDelta, bucket_capacity, to_device)
from reflow_tpu_torch.scheduler import DirtyScheduler, SourceCursor  # noqa
from reflow_tpu_torch.workloads import knn, pagerank  # noqa: E402

__all__ = ["FRONTEND_DEPTH", "FRONTEND_TICKS", "PAGERANK", "KNN", "STREAM",
           "WINDOW_K", "WorkerGroup",
           "drive_knn", "drive_knn_frontend", "drive_pagerank",
           "drive_pagerank_windows", "drive_stream", "knn_feed",
           "local_capacity", "main", "pagerank_arena", "split_rows",
           "stream_feed", "twin_batch"]

#: the test's PageRank: 256 nodes, 2,048 edges, two processes of 4 shards
PAGERANK = dict(n_nodes=256, n_edges=2048, churn=0.02, churn_ticks=1,
                tol=5e-5, seed=0)
#: the test's k-NN: small widths, two chunks a shard
KNN = dict(Q=16, D=1024, dim=32, k=4, scan_chunk=64, preload_chunk=256,
           preload_chunks=2, insert_ticks=2, per_tick=64, retract=32,
           query_update=4, seed=18)
#: the test's keyed-min stream: 64 keys, a first tick of 48 rows
STREAM = dict(keys=64, rows=48, seed=21)
#: the window case: a churn window of 4 ticks before the checkpoint
#: and one after it; the k-NN frontend's windows of 2 ticks at depth 2
WINDOW_K, FRONTEND_TICKS, FRONTEND_DEPTH = 4, 2, 2


# -- the global batch as the processes lay it out ---------------------------

def split_rows(batch: DeltaBatch, pid: int, nproc: int) -> DeltaBatch:
    """Process ``pid``'s stripe of a global batch (rows ``pid::nproc``):
    every process derives it from the same global content."""
    return DeltaBatch(np.asarray(batch.keys)[pid::nproc],
                      np.asarray(batch.values)[pid::nproc],
                      np.asarray(batch.weights)[pid::nproc])


def local_capacity(n_rows: int, nproc: int) -> int:
    """The global capacity of a batch of ``n_rows`` striped over
    ``nproc`` processes: each process's share a bucket."""
    return nproc * bucket_capacity(-(-n_rows // nproc))


def twin_batch(batch: DeltaBatch, spec, nproc: int, capacity: int,
               device) -> DeviceDelta:
    """The global batch a group of ``nproc`` processes ingests through
    ``shard_batch_process_local`` (process ``p``'s stripe padded in rows
    ``[p, p+1) * capacity / nproc``), built in one process for a
    single-controller twin of the same mesh shape."""
    parts = [to_device(split_rows(batch, p, nproc), spec,
                       capacity=capacity // nproc, device=device)
             for p in range(nproc)]
    return DeviceDelta(*(torch.cat(cols) for cols in zip(*parts)))


def pagerank_arena(n_shards: int, n_edges: int, churn: float) -> int:
    """A sharded PageRank's arena: the sharded executor holds one tick's
    whole delta against ONE shard's slice, so each slice is bench.py's
    arena (the edges' bucket and eight churn ticks' headroom)."""
    head = 8 * bucket_capacity(2 * int(churn * n_edges) + 2)
    return n_shards * (bucket_capacity(n_edges) + head)


# -- recording --------------------------------------------------------------

def _flat(tree, path: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)   # the lowerings write in place
        out[path] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{path}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{path}/{i}", out)


def _shards(ex):
    """(rank, state dict) of each shard this process steps; a
    single-device executor is rank 0."""
    mesh = getattr(ex, "mesh", None)
    if mesh is None:
        return [(0, ex.states)]
    return [(r, ex.shard_states(r)) for r in mesh.local_ranks]


def record_shards(out: Dict[str, np.ndarray], tag: str, ex,
                  nids: Optional[List[int]] = None) -> None:
    """The shards this process steps, each node's tree (``nids`` only,
    when given), under ``<tag>/r<rank>/<node id>``."""
    for r, states in _shards(ex):
        for nid in list(states):
            if nids is None or nid in nids:
                _flat(states[nid], f"{tag}/r{r}/{nid}", out)


# -- the cases --------------------------------------------------------------

Ingest = Callable[..., bool]


def _pagerank_graph(cfg: Dict, ex):
    """Config 3's graph with its arena sized for ``ex``'s shards."""
    mesh = getattr(ex, "mesh", None)
    n_shards = 1 if mesh is None else mesh.size
    return pagerank.build_graph(cfg["n_nodes"], tol=cfg["tol"],
                                arena_capacity=pagerank_arena(
                                    n_shards, cfg["n_edges"], cfg["churn"]))


def _restored_vs_live(ex, ex2, nid: int, nid2: int,
                      restore_rtol: float) -> float:
    """The largest relative difference of two runs' emitted ranks, shard
    by shard; raises above ``restore_rtol``."""
    worst = 0.0
    for (_, sa), (_, sb) in zip(_shards(ex), _shards(ex2)):
        a = sa[nid]["emitted"].cpu().numpy()
        b = sb[nid2]["emitted"].cpu().numpy()
        worst = max(worst, float((np.abs(a - b)
                                  / np.maximum(np.abs(a), 1.0)).max()))
    if worst > restore_rtol:
        raise AssertionError(f"restored run differs from the live one by "
                             f"{worst} (relative)")
    return worst


def _vs_reference(sched, pr, web) -> Dict:
    """This process's owned ranks against the dense reference."""
    ref = pagerank.reference_ranks(web)
    table = sched.read_table(pr.new_rank)
    worst = max(abs(v - ref[k]) / max(abs(ref[k]), 1.0)
                for k, v in table.items())
    return {"owned": len(table), "owned_lo": min(table),
            "owned_hi": max(table), "vs_reference": float(worst)}


def drive_pagerank(cfg: Dict, make_ex: Callable[[], object], ingest: Ingest,
                   *, nproc: int, save: Callable, load: Callable,
                   out: Dict[str, np.ndarray], record: str = "all",
                   drift: Optional[Callable] = None,
                   restore_rtol: float = 1e-5) -> Dict:
    """Config 3's build, churn, exactly-once and checkpoint round on the
    executors ``make_ex()`` gives. ``ingest(sched, node, batch, capacity,
    batch_id=None)`` pushes one global batch as this process ingests it;
    ``save(sched)``/``load(sched)`` checkpoint. The restored run's ranks
    must stay within ``restore_rtol`` (relative) of the live run's: on
    the CPU they are equal; on the card float atomics and the restored
    run's fresh CSR order can flip a tol-gated emission. Returns the
    summary; the tables of every tick land in ``out``."""
    n, e, churn = cfg["n_nodes"], cfg["n_edges"], cfg["churn"]
    ex = make_ex()
    pr = _pagerank_graph(cfg, ex)
    sched = DirtyScheduler(pr.graph, ex, max_loop_iters=500)
    web = pagerank.WebGraph.random(n, e, seed=cfg["seed"])
    keep = [pr.new_rank.id] if record == "ranks" else None
    ticks: List[Dict] = []

    def tick(s, tag, exr):
        t0 = time.perf_counter()
        r = s.tick(sync=False)
        r.block()
        if not r.quiesced:
            raise AssertionError(f"{tag}: the tick did not quiesce")
        ticks.append({"tag": tag, "ms": (time.perf_counter() - t0) * 1e3,
                      "passes": int(r.passes),
                      "deltas_in": int(r.deltas_in)})
        record_shards(out, tag, exr, keep)

    tb = pagerank.teleport_batch(n)
    ingest(sched, pr.teleport, tb, local_capacity(len(tb), nproc))
    ib = web.initial_batch()
    ingest(sched, pr.edges, ib, local_capacity(len(ib), nproc))
    tick(sched, "t0", ex)
    for i in range(cfg["churn_ticks"]):
        cb = web.churn(churn)
        ingest(sched, pr.edges, cb, local_capacity(len(cb), nproc))
        tick(sched, f"t{i + 1}", ex)

    summary = _vs_reference(sched, pr, web)

    # the exactly-once round: ids from a shared cursor are the same on
    # every process, so a redelivery dedups everywhere
    cur = SourceCursor(pr.edges)
    c2 = web.churn(churn)
    cap = local_capacity(len(c2), nproc)
    bid = cur.next_id()
    acc1 = ingest(sched, pr.edges, c2, cap, batch_id=bid)
    acc2 = ingest(sched, pr.edges, c2, cap, batch_id=bid)
    if not acc1 or acc2:
        raise AssertionError(f"redelivery: accepted {acc1}, then {acc2}")
    tick(sched, "once", ex)
    if drift is not None:
        drift(sched)
    save(sched)
    ex2 = make_ex()
    pr2 = _pagerank_graph(cfg, ex2)
    sched2 = DirtyScheduler(pr2.graph, ex2, max_loop_iters=500)
    load(sched2)
    cur2 = SourceCursor.resume(sched2, pr2.edges)
    if cur2.seq != cur.seq:
        raise AssertionError(f"cursor resumed at {cur2.seq}, not {cur.seq}")
    c3 = web.churn(churn)
    cap = local_capacity(len(c3), nproc)
    for s, prx, c, tag, exr in ((sched, pr, cur, "cont", ex),
                                (sched2, pr2, cur2, "restored", ex2)):
        ingest(s, prx.edges, c3, cap, batch_id=c.next_id())
        tick(s, tag, exr)
    worst = _restored_vs_live(ex, ex2, pr.new_rank.id, pr2.new_rank.id,
                              restore_rtol)
    summary.update(restored_vs_live=worst, ticks=ticks,
                   digest=_digest(sched))
    return summary


def _queue_bytes(ex) -> int:
    """Device bytes a generation of the executor's ingress queues holds
    (this process's data shards' slots)."""
    return sum(q.gen_nbytes for key, q in ex._window_cache.items()
               if key[0] == "ingress_q")


def _window_engaged(tag: str, sched, windows: int) -> None:
    """Every window went through the queue: none ran per tick."""
    ex = sched.executor
    if (sched.megatick_windows != windows or sched.megatick_fallbacks
            or ex.window_dispatches != windows):
        raise AssertionError(
            f"{tag}: {sched.megatick_windows} windows, "
            f"{ex.window_dispatches} dispatches, "
            f"{sched.megatick_fallbacks} fallbacks; expected {windows} "
            f"windows and no fallback")


def drive_pagerank_windows(cfg: Dict, make_ex: Callable[[], object], *,
                           save: Callable, load: Callable,
                           out: Dict[str, np.ndarray], record: str = "all",
                           restore_rtol: float = 1e-5,
                           fault: Optional[Callable] = None) -> Dict:
    """Config 3 on the window path: the build tick (global host batches
    pushed), one churn window of ``WINDOW_K`` ticks through
    ``tick_many``, a collective save restored into a fresh scheduler,
    and one more window on the live and the restored scheduler. Every
    batch is a global host batch: every process writes the same one and
    its queue keeps its own shards' rows. ``fault(sched)`` (a test's)
    runs before the first window. The tables after the build and after
    each window land in ``out`` (``b0``, ``w1``, ``cont``,
    ``restored``); returns the summary."""
    n, e, churn, k = cfg["n_nodes"], cfg["n_edges"], cfg["churn"], WINDOW_K
    ex = make_ex()
    pr = _pagerank_graph(cfg, ex)
    sched = DirtyScheduler(pr.graph, ex, max_loop_iters=500)
    web = pagerank.WebGraph.random(n, e, seed=cfg["seed"])
    keep = [pr.new_rank.id] if record == "ranks" else None
    rows: List[Dict] = []

    def run(s, tag, exr, feeds=None):
        t0 = time.perf_counter()
        r = s.tick(sync=False) if feeds is None else s.tick_many(feeds)
        r.block()
        if not r.quiesced:
            raise AssertionError(f"{tag}: a tick did not quiesce")
        rows.append({"tag": tag, "ticks": 1 if feeds is None else len(feeds),
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "passes": int(r.passes)})
        record_shards(out, tag, exr, keep)

    sched.push(pr.teleport, pagerank.teleport_batch(n))
    sched.push(pr.edges, web.initial_batch())
    run(sched, "b0", ex)
    if fault is not None:
        fault(sched)
    run(sched, "w1", ex, [{pr.edges: web.churn(churn)} for _ in range(k)])
    _window_engaged("pagerank", sched, 1)
    gen_bytes = _queue_bytes(ex)

    save(sched)
    ex2 = make_ex()
    pr2 = _pagerank_graph(cfg, ex2)
    sched2 = DirtyScheduler(pr2.graph, ex2, max_loop_iters=500)
    load(sched2)
    batches = [web.churn(churn) for _ in range(k)]
    for s, prx, tag, exr in ((sched, pr, "cont", ex),
                             (sched2, pr2, "restored", ex2)):
        run(s, tag, exr, [{prx.edges: b} for b in batches])
    _window_engaged("pagerank", sched, 2)
    _window_engaged("pagerank restored", sched2, 1)
    worst = _restored_vs_live(ex, ex2, pr.new_rank.id, pr2.new_rank.id,
                              restore_rtol)
    return dict(_vs_reference(sched, pr, web),
                windows=sched.megatick_windows,
                window_dispatches=ex.window_dispatches,
                fallbacks=sched.megatick_fallbacks, queue_bytes=gen_bytes,
                ticks=rows, restored_vs_live=worst, digest=_digest(sched))


def _digest(sched) -> int:
    from reflow_tpu_torch.utils.checkpoint import meta_digest

    return meta_digest(sched._tick, sched._seen_batch_ids)


def knn_feed(cfg: Dict) -> List[tuple]:
    """(batch id, source, host batch, kind) in the upstream's order: the
    queries, the preload (random int8 rows), the inserts on fresh ids,
    the retraction and the query update."""
    Q, dim = cfg["Q"], cfg["dim"]
    rng = np.random.default_rng(cfg["seed"])

    def docs(lo: int, n: int) -> DeltaBatch:
        return DeltaBatch(np.arange(lo, lo + n, dtype=np.int64),
                          rng.integers(-127, 128, (n, dim), dtype=np.int8))

    n = cfg["preload_chunk"]
    feed = [("q0", "q", DeltaBatch(np.arange(Q, dtype=np.int64),
                                   rng.standard_normal((Q, dim),
                                                       dtype=np.float32)),
             "query insert")]
    feed += [(f"pre{c}", "d", docs(c * n, n), "preload")
             for c in range(cfg["preload_chunks"])]
    lo = cfg["preload_chunks"] * n
    for i in range(cfg["insert_ticks"]):
        feed.append((f"ins{i}", "d", docs(lo, cfg["per_tick"]), "insert"))
        lo += cfg["per_tick"]
    gone = np.arange(cfg["retract"], dtype=np.int64)
    feed.append(("ret", "d", DeltaBatch(
        gone, np.zeros((len(gone), dim), np.int8),
        -np.ones(len(gone), np.int64)), "retract"))
    nq = cfg["query_update"]
    feed.append(("qup", "q", DeltaBatch(
        np.arange(nq, dtype=np.int64),
        rng.standard_normal((nq, dim), dtype=np.float32)), "query update"))
    return feed


def _launches(l0=(0, 0, 0)) -> List[int]:
    """(topk, topk_merge, scan_score) kernel launches of this process
    since the counts ``l0``."""
    from reflow_tpu_torch.kernels import topk as topk_mod

    return [topk_mod.TOPK_LAUNCHES - l0[0],
            topk_mod.TOPK_MERGE_LAUNCHES - l0[1],
            topk_mod.SCAN_SCORE_LAUNCHES - l0[2]]


def knn_graph(cfg: Dict):
    """Config 4's k-NN graph (bf16 queries, int8 corpus)."""
    return knn.build_graph(cfg["Q"], cfg["D"], cfg["dim"], cfg["k"],
                           scan_chunk=cfg["scan_chunk"],
                           dtype=torch.bfloat16, doc_dtype=torch.int8,
                           precision="default")


def drive_knn(cfg: Dict, ex, out: Dict[str, np.ndarray]) -> Dict:
    """The k-NN feed, one tick a batch; the index table of every tick
    lands in ``out`` (``<tick>/emitted``, ``<tick>/em_has``)."""
    kg = knn_graph(cfg)
    sched = DirtyScheduler(kg.graph, ex)
    ticks = []
    for i, (bid, src, batch, kind) in enumerate(knn_feed(cfg)):
        l0 = _launches()
        t0 = time.perf_counter()
        sched.push(kg.queries if src == "q" else kg.docs, batch,
                   batch_id=bid)
        sched.tick()
        if ex.device.type == "cuda":
            torch.cuda.synchronize(ex.device)
        ms = (time.perf_counter() - t0) * 1e3
        # the replicated leaves only: a global read would gather the
        # corpus slices too
        st = ex._node_state(kg.index.id)
        for key in ("emitted", "em_has"):
            _flat(st[key], f"k{i}/{key}", out)
        ticks.append({"kind": kind, "ms": ms, "launches": _launches(l0)})
    return {"ticks": ticks, "queries": len(sched.read_table(kg.index))}


def drive_knn_frontend(cfg: Dict, ex, out: Dict[str, np.ndarray]) -> Dict:
    """The k-NN feed through an ``IngestFrontend`` at depth
    ``FRONTEND_DEPTH``, in two rounds: the queries, the preload and the
    inserts (one tick each but the queries', which share the first
    preload's: windows of ``FRONTEND_TICKS`` ticks, each staged while
    the one before is in flight), then the retraction with the query
    update (one tick). The pump runs in this thread (``start=False``),
    one iteration a round, so every process of a group forms the same
    windows. The index
    table after each round lands in ``out`` (``f<round>/emitted``,
    ``f<round>/em_has``)."""
    from reflow_tpu_torch.serve import CoalesceWindow, IngestFrontend

    kg = knn_graph(cfg)
    sched = DirtyScheduler(kg.graph, ex)
    feed = knn_feed(cfg)
    ticks = FRONTEND_TICKS
    # a round is admitted whole before the pump runs: the budget must
    # hold it (two preload chunks of config 4 are 102 MB of slots)
    fe = IngestFrontend(sched, start=False, depth=FRONTEND_DEPTH,
                        max_bytes=1 << 40,
                        window=CoalesceWindow(max_rows=cfg["per_tick"],
                                              max_ticks=ticks,
                                              max_latency_s=0.001))
    rounds = [feed[:-2], feed[-2:]]
    out_rounds = []
    l0 = _launches()
    try:
        for i, items in enumerate(rounds):
            tks = [fe.submit(kg.queries if src == "q" else kg.docs, batch,
                             batch_id=bid, timeout=60)
                   for bid, src, batch, _kind in items]
            t0 = time.perf_counter()
            tick0 = sched._tick
            with fe._lock:
                drained = fe._take_window()
            fe._run_window(drained)
            with fe._lock:
                fe._finish_window()
            if ex.device.type == "cuda":
                torch.cuda.synchronize(ex.device)
            ms = (time.perf_counter() - t0) * 1e3
            if not all(t.result(timeout=60).applied for t in tks):
                raise AssertionError(f"round {i}: a ticket was not applied")
            st = ex._node_state(kg.index.id)
            for key in ("emitted", "em_has"):
                _flat(st[key], f"f{i}/{key}", out)
            out_rounds.append({"ms": ms, "ticks": sched._tick - tick0})
    finally:
        fe.close()
    _window_engaged("knn", sched, sum(-(-r["ticks"] // ticks)
                                      for r in out_rounds))
    return {"rounds": out_rounds, "windows": sched.megatick_windows,
            "window_dispatches": ex.window_dispatches,
            "fallbacks": sched.megatick_fallbacks,
            "windows_pipelined": fe.windows_pipelined,
            "queue_bytes": _queue_bytes(ex),
            "launches": _launches(l0)}


def stream_feed(cfg: Dict) -> List[tuple]:
    """(kind, host batch) of the keyed-min stream over ``cfg["keys"]``
    keys: a tick of rows on every key range, then one new minimum on a
    key of the first process's range, one on the last process's (its
    row still enters on the first process's rows, so the route crosses
    the boundary), and the first one's retraction. On a mesh across
    processes the last three ticks give sink rows to one process only."""
    K = cfg["keys"]
    rng = np.random.default_rng(cfg["seed"])
    k0 = rng.integers(0, K, cfg["rows"])

    def rows(keys, vals, w=1):
        return DeltaBatch(np.asarray(keys, np.int64),
                          np.asarray(vals, np.float32),
                          np.full(len(keys), w, np.int64))

    low = rows([1], [-1000.0])
    return [("every range", rows(k0, rng.integers(-50, 50, len(k0)))),
            ("first range", low),
            ("last range", rows([K - 3], [-1000.0])),
            ("retract", DeltaBatch(low.keys, low.values, -low.weights))]


def drive_stream(cfg: Dict, ex, out: Dict[str, np.ndarray]) -> Dict:
    """The keyed-min stream through a sink, streaming ticks
    (``tick(sync=False)``) and one ``block()`` at the end; every tick's
    sink view (this process's keys on a mesh across processes) lands in
    ``out`` (``s<tick>/keys``, ``s<tick>/vals``)."""
    from reflow_tpu_torch.delta import Spec
    from reflow_tpu_torch.graph import FlowGraph

    g = FlowGraph("keyed_min")
    src = g.source("s", Spec((), np.float32, key_space=cfg["keys"]))
    g.sink(g.reduce(src, "min", name="m"), "out")
    sched = DirtyScheduler(g, ex)
    sinks = []
    for i, (kind, batch) in enumerate(stream_feed(cfg)):
        sched.push(src, batch)
        r = sched.tick(sync=False)
        view = sched.view_dict("out")
        keys = np.array(sorted(view), np.int64)
        out[f"s{i}/keys"] = keys
        out[f"s{i}/vals"] = np.array([view[k] for k in keys.tolist()],
                                     np.float32)
        sinks.append(len(r.sink_deltas.get("out", ())))
    r.block()
    return {"ticks": [{"kind": k, "sink_rows": n} for (k, _), n in
                      zip(stream_feed(cfg), sinks)]}


# -- a group of worker processes --------------------------------------------

_MODULE = "reflow_tpu_torch.parallel.multihost_worker"

class WorkerGroup:
    """``nproc`` worker processes of one group, started at once, for a
    caller that holds their tables against a twin. ``device`` is passed
    to every child (None: each takes the card of its index, as nccl
    needs). :meth:`wait` gives their summaries and tables; a child that
    exits non-zero or outlives ``limit_s`` raises, and every child still
    running is killed. A caller that may fail before :meth:`wait` calls
    :meth:`kill` in a ``finally``."""

    def __init__(self, nproc: int, backend: str, args: List[str], *,
                 out_dir: str, tag: str = "w", device: Optional[str] = None,
                 limit_s: float = 120.0, timeout_s: float = 60.0):
        import socket
        import subprocess

        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{sock.getsockname()[1]}"
        dev = [] if device is None else ["--device", str(device)]
        self.tag, self.limit_s = tag, limit_s
        self.outs = [os.path.join(out_dir, f"{tag}-{i}.npz")
                     for i in range(nproc)]
        self.t0 = time.time()
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", _MODULE, coord, str(i), str(nproc),
             "--backend", backend, *dev, "--timeout", str(timeout_s),
             "--out", self.outs[i], *args],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for i in range(nproc)]

    def kill(self) -> None:
        """End every child still running (a no-op once all have ended)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self) -> tuple:
        """``(summaries, tables)``, in process order; each summary gains
        ``start_s``, the seconds from the spawn to its group's ready
        point."""
        import subprocess

        logs = []
        try:
            for p in self.procs:
                left = max(1.0, self.limit_s - (time.time() - self.t0))
                try:
                    out, err = p.communicate(timeout=left)
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"{self.tag}: a child outlived "
                                       f"{self.limit_s} s") from None
                logs.append((p.returncode, out, err))
        finally:
            self.kill()
        for i, (rc, out, err) in enumerate(logs):
            if rc != 0:
                raise RuntimeError(f"{self.tag} child {i} exited {rc}:\n"
                                   f"{out[-2000:]}\n{err[-6000:]}")
        sums = [json.loads(out.strip().splitlines()[-1])
                for _, out, _ in logs]
        for s in sums:
            s["start_s"] = s["t_ready"] - self.t0
        return sums, [dict(np.load(o)) for o in self.outs]


# -- the process ------------------------------------------------------------

def _args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m reflow_tpu_torch.parallel.multihost_worker")
    ap.add_argument("coord")
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda:<i> (default: the card)")
    ap.add_argument("--case", default="pagerank",
                    choices=("pagerank", "knn", "stream", "window",
                             "badkey"))
    ap.add_argument("--window-fault", action="store_true",
                    help="the last process raises inside the first "
                         "churn window (window case)")
    ap.add_argument("--no-fixpoint", action="store_true",
                    help="the scheduler drives the loop's passes")
    ap.add_argument("--delta", type=int, default=4,
                    help="shards a process")
    ap.add_argument("--out", required=True, help="the tables' .npz")
    ap.add_argument("--ckpt", default=None,
                    help="the shared checkpoint directory (pagerank)")
    ap.add_argument("--record", default="all", choices=("all", "ranks"))
    ap.add_argument("--drift", action="store_true")
    ap.add_argument("--restore-rtol", type=float, default=1e-5)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a collective may wait for a peer")
    for key, val in (list(PAGERANK.items()) + list(KNN.items())
                     + list(STREAM.items())):
        flag = "--" + key.lower().replace("_", "-")
        if flag in ("--seed",):
            continue
        ap.add_argument(flag, type=type(val), default=None)
    ap.add_argument("--seed", type=int, default=None)
    return ap.parse_args(argv)


def _cfg(base: Dict, args) -> Dict:
    out = dict(base)
    for key in base:
        got = getattr(args, key.lower(), None)
        if got is not None:
            out[key] = got
    return out


def main(argv=None) -> int:
    args = _args(sys.argv[1:] if argv is None else argv)
    torch.set_num_threads(1)
    from reflow_tpu_torch.parallel import dist, spmd
    from reflow_tpu_torch.parallel.mesh import (make_mesh,
                                                shard_batch_process_local)
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor
    from reflow_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    pid, nproc = args.pid, args.nproc
    dist.initialize(args.coord, nproc, pid, backend=args.backend,
                    timeout_s=args.timeout)
    ready_s = time.time() - _T0
    device = args.device

    def make_ex():
        return ShardedCudaExecutor(make_mesh(nproc * args.delta, dcn=nproc,
                                             device=device),
                                   fixpoint=not args.no_fixpoint)

    out: Dict[str, np.ndarray] = {}
    spmd.reset_collective_tally()
    summary: Dict = {"pid": pid, "backend": args.backend, "case": args.case,
                     "ready_s": ready_s, "t_ready": time.time()}
    try:
        if args.case == "pagerank":
            cfg = _cfg(PAGERANK, args)

            def ingest(sched, node, batch, capacity, batch_id=None):
                return sched.push(node, shard_batch_process_local(
                    split_rows(batch, pid, nproc), node.spec,
                    sched.executor.mesh, capacity=capacity),
                    batch_id=batch_id)

            drift = None
            if args.drift:
                def drift(sched):
                    if pid == 1:
                        sched._register_batch_id("drifted@0")
                    try:
                        save_checkpoint(sched, args.ckpt)
                    except RuntimeError as e:
                        if "diverged across controllers" not in str(e):
                            raise
                        summary["drift_raised"] = str(e)
                        raise _Drifted() from e
                    raise AssertionError("a drifted dedup window saved")
            try:
                summary.update(drive_pagerank(
                    cfg, make_ex, ingest, nproc=nproc,
                    save=lambda s: save_checkpoint(s, args.ckpt),
                    load=lambda s: load_checkpoint(s, args.ckpt),
                    out=out, record=args.record, drift=drift,
                    restore_rtol=args.restore_rtol))
            except _Drifted:
                pass
        elif args.case == "knn":
            cfg = _cfg(KNN, args)
            summary.update(drive_knn(cfg, make_ex(), out))
        elif args.case == "window":
            _window_case(args, make_ex, out, summary)
        elif args.case == "badkey":
            _badkey_case(args, make_ex().mesh, summary)
        else:
            summary.update(drive_stream(_cfg(STREAM, args), make_ex(), out))
        tally = spmd.collective_tally()
        summary.update(
            staged_bytes=dist.staged_bytes(),
            boundary={kind: list(v) for (kind, axis), v in tally.items()
                      if axis == (spmd.PROCESS_BOUNDARY,)},
            collectives={f"{kind}/{'x'.join(axis)}": list(v)
                         for (kind, axis), v in tally.items()},
            launches=_launches())
        tmp = args.out + ".tmp.npz"
        np.savez(tmp, **out)
        os.replace(tmp, args.out)
    finally:
        dist.shutdown()
    print(json.dumps(summary), flush=True)
    return 0


def _window_case(args, make_ex, out: Dict[str, np.ndarray],
                 summary: Dict) -> None:
    """The window case (see the module docstring): the PageRank windows
    and the checkpoint between them, then the k-NN frontend; with
    ``--window-fault`` the first window fails on the last process and
    every process records how long its group took to fail."""
    from reflow_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    pid, nproc = args.pid, args.nproc
    fault = None
    if args.window_fault:
        def fault(sched):
            if pid != nproc - 1:
                return
            ex, calls = sched.executor, [0]
            real = ex.run_region

            def run_region(*a):
                # a window tick is one region: fail the second
                calls[0] += 1
                if calls[0] == 2:
                    raise RuntimeError("a fault injected into the "
                                       "window's second tick")
                return real(*a)

            ex.run_region = run_region
    t0 = time.time()
    try:
        summary["pagerank"] = drive_pagerank_windows(
            _cfg(PAGERANK, args), make_ex,
            save=lambda s: save_checkpoint(s, args.ckpt),
            load=lambda s: load_checkpoint(s, args.ckpt), out=out,
            record=args.record, restore_rtol=args.restore_rtol, fault=fault)
    except Exception as e:  # noqa: BLE001 - the injected fault's outcome
        if not args.window_fault:
            raise
        summary["window_failed"] = f"{type(e).__name__}: {e}"[:400]
        summary["failed_after_s"] = time.time() - t0
        return
    if args.window_fault:
        raise AssertionError("the faulted window did not fail")
    summary["knn"] = drive_knn_frontend(_cfg(KNN, args), make_ex(), out)


def _badkey_case(args, mesh, summary: Dict) -> None:
    """The badkey case (see the module docstring)."""
    from reflow_tpu_torch.parallel.mesh import shard_batch_process_local
    from reflow_tpu_torch.utils.faults import DeliveryError

    spec = Spec((), np.float32, key_space=8)

    def chunk(keys):
        return DeltaBatch(np.array(keys, np.int64),
                          np.ones(len(keys), np.float32))

    last = args.pid == args.nproc - 1
    t0 = time.time()
    try:
        shard_batch_process_local(chunk([1, 8 if last else 2]), spec, mesh,
                                  capacity=2 * mesh.size)
    except DeliveryError as e:
        summary["refused"] = str(e)
        summary["refused_after_s"] = time.time() - t0
    else:
        raise AssertionError("the bad key passed")
    got = shard_batch_process_local(chunk([1, 2]), spec, mesh,
                                    capacity=2 * mesh.size)
    summary["after"] = int(got.nonzero())


class _Drifted(Exception):
    """The drifted save raised as it must; the case ends there."""


if __name__ == "__main__":
    sys.exit(main())
