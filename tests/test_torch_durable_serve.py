"""The port's serving frontend over its durable scheduler, on the CPU.

``bench.py``'s durability-pipeline shape (``REFLOW_BENCH_WALPIPE``) at a
small size: four producers submit 512-row batches of ``(16,)`` vectors
into a map -> sum graph over the ``"cuda"`` executor at ``device="cpu"``
behind ``IngestFrontend`` at depths 1 and 2, with ``fsync="record"``,
the log written inline (``committer="inline"``) and by the committer
thread. Host batches at depth 2 take the staged window path (the WAL
append in ``stage_window``, the tick markers in ``dispatch_staged``);
device batches carry their host pre-images. The values are small
integers, so every sum is exact in any order and the tables are held
equal exactly: inline, pipelined, replayed through ``recover()``, and
the JAX frontend's over the JAX ``DurableScheduler`` on the same feed.
Pre-imaged device batches log with zero readbacks and every ticket
carries its covering LSN.

Then a small k-NN graph served durably at depth 2: checkpoint after the
preload, a kill inside the last window, ``recover()`` into a fresh
executor, the upstream's resend through a new frontend (statuses only
``deduped`` or ``applied``), and a table equal to the uncrashed twin's
(ids and scores exact: the same CPU arithmetic).
"""

import threading

import numpy as np
import pytest

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.executors.device_delta import to_device as jto_device
from reflow_tpu.serve import CoalesceWindow as JCoalesceWindow
from reflow_tpu.wal import DurableScheduler as JDurableScheduler
from reflow_tpu_torch.executors.device_delta import to_device
from reflow_tpu_torch.serve import (APPLIED, DEDUPED, CoalesceWindow,
                                    PumpCrashed)
from reflow_tpu_torch.utils.checkpoint import save_checkpoint
from reflow_tpu_torch.utils.faults import CrashInjector
from reflow_tpu_torch.wal import DurableScheduler, recover
from reflow_tpu_torch.workloads import knn as pknn

ROWS, FEAT, KEYS = 512, 16, 64
N_PROD, PER_PROD = 4, 2


def walpipe_graph(pkg):
    """bench.py's walpipe graph without its sink (so host windows can
    take the fused path): source -> map(2v) -> sum Reduce."""
    spec = pkg.Spec((FEAT,), np.float32, key_space=KEYS)
    g = pkg.FlowGraph("walpipe")
    src = g.source("in", spec)
    total = g.reduce(g.map(src, lambda v: v * 2.0, vectorized=True),
                     "sum", name="sum")
    return g, src, total


def payloads(pkg):
    """{producer: [(batch_id, host batch)]}, small-integer values."""
    out = {}
    for pid in range(N_PROD):
        rng = np.random.default_rng(1000 + pid)
        out[pid] = [(f"p{pid}-{j}", pkg.DeltaBatch(
            rng.integers(0, KEYS, ROWS).astype(np.int64),
            rng.integers(0, 8, (ROWS, FEAT)).astype(np.float32),
            np.ones(ROWS, np.int64))) for j in range(PER_PROD)]
    return out


def serve(pkg, wal_dir, *, committer, depth, device):
    """Drive the walpipe feed through ``pkg``'s frontend over a durable
    scheduler; returns (table, ticket results, scheduler, frontend)."""
    port = pkg is P
    g, src, total = walpipe_graph(pkg)
    if port:
        sched = DurableScheduler(g, P.get_executor("cuda", device="cpu"),
                                 wal_dir=wal_dir, fsync="record",
                                 committer=committer)
        win, up = CoalesceWindow, (lambda b: to_device(b, src.spec,
                                                       device="cpu"))
    else:
        sched = JDurableScheduler(g, J.get_executor("tpu"), wal_dir=wal_dir,
                                  fsync="record", committer=committer)
        win, up = JCoalesceWindow, (lambda b: jto_device(b, src.spec))
    fe = pkg.IngestFrontend(sched, depth=depth, window=win(
        max_rows=ROWS, max_ticks=2, max_latency_s=0.001))
    feed = payloads(pkg)
    tickets, lock = [], threading.Lock()

    def produce(pid):
        mine = []
        for bid, host in feed[pid]:
            if device:
                mine.append(fe.submit(src, up(host), batch_id=bid,
                                      preimage=host))
            else:
                mine.append(fe.submit(src, host, batch_id=bid))
        with lock:
            tickets.extend(mine)

    threads = [threading.Thread(target=produce, args=(pid,))
               for pid in range(N_PROD)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        fe.flush(timeout=60)
        results = [t.result(timeout=60) for t in tickets]
        table = {int(k): np.asarray(v, np.float32)
                 for k, v in sched.read_table(total).items()}
    finally:
        fe.close()
    return table, results, sched, fe


def same_tables(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("depth", [1, 2])
def test_walpipe_inline_pipelined_replayed_and_jax_equal(tmp_path,
                                                         monkeypatch, depth,
                                                         device):
    import reflow_tpu.executors.ingress_queue as jiq

    # the JAX queue's host scratch reuse races under load (ROADMAP
    # Queue 3); the port's queue keeps one staging buffer a slot
    monkeypatch.setattr(jiq, "_SCRATCH_REUSE_SAFE", False)
    tables = {}
    for committer in ("inline", "thread"):
        wal_dir = str(tmp_path / committer)
        table, results, sched, fe = serve(P, wal_dir, committer=committer,
                                          depth=depth, device=device)
        assert len(results) == N_PROD * PER_PROD
        assert all(r.status == APPLIED for r in results)
        # committed evidence: every ticket names its covering LSN
        assert all(r.lsn for r in results)
        assert sched.log_readbacks == 0
        assert fe.depth == depth
        if depth == 2 and not device:
            # host windows staged through the ingress queue: the WAL
            # append ran in stage_window, the markers in dispatch_staged
            assert fe.windows_staged > 0
            assert sched.megatick_fallbacks == 0
        tables[committer] = table
    same_tables(tables["inline"], tables["thread"])
    # replay: the pipelined log drives a fresh executor to the same table
    g, _src, total = walpipe_graph(P)
    fresh = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    rep = recover(fresh, str(tmp_path / "thread"))
    assert rep.replayed_pushes > 0 and rep.torn_tail is None
    same_tables({int(k): np.asarray(v, np.float32)
                 for k, v in fresh.read_table(total).items()},
                tables["thread"])
    # the JAX frontend over the JAX durable scheduler, same feed
    jtable, jres, jsched, _ = serve(J, str(tmp_path / "jax"),
                                    committer="thread", depth=depth,
                                    device=device)
    assert all(r.applied for r in jres) and jsched.log_readbacks == 0
    same_tables(jtable, tables["thread"])


def test_device_batch_without_preimage_is_a_counted_readback(tmp_path):
    """A device batch submitted with no pre-image still logs and
    applies, at the cost of one counted readback."""
    g, src, total = walpipe_graph(P)
    sched = DurableScheduler(g, P.get_executor("cuda", device="cpu"),
                             wal_dir=str(tmp_path / "wal"), fsync="tick")
    host = payloads(P)[0][0][1]
    with P.IngestFrontend(sched) as fe:
        t = fe.submit(src, to_device(host, src.spec, device="cpu"),
                      batch_id="x")
        fe.flush(timeout=60)
        assert t.result(timeout=60).status == APPLIED
    assert sched.log_readbacks == 1
    fresh = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    recover(fresh, str(tmp_path / "wal"))
    same_tables(fresh.read_table(total), sched.read_table(total))


# -- k-NN: kill, recover, resend ---------------------------------------------

Q, D, DIM, K = 16, 512, 32, 4


def knn_batches(seed=0):
    """(batch_id, source, host batch) in submit order: the queries, a
    preload, inserts, a retraction and a query update."""
    rng = np.random.default_rng(seed)

    def b(keys, vals, w=1):
        keys = np.asarray(keys, np.int64)
        return P.DeltaBatch(keys, vals, np.full(len(keys), w, np.int64))

    def vecs(n):
        return rng.standard_normal((n, DIM)).astype(np.float32)

    out = [("q0", "q", b(np.arange(Q), vecs(Q)))]
    out += [(f"pre{i}", "d", b(np.arange(i, i + 64), vecs(64)))
            for i in range(0, 256, 64)]
    out += [(f"ins{i}", "d", b(np.arange(i, i + 32), vecs(32)))
            for i in range(256, 416, 32)]
    out.append(("ret", "d", b(np.arange(20, 50),
                              np.zeros((30, DIM), np.float32), -1)))
    out.append(("qup", "q", b(np.arange(4), vecs(4))))
    return out


N_PRELOAD = 5  # the queries and the 4 preload batches


def knn_serve(sched, kg, batches, fe=None):
    fe = fe or P.IngestFrontend(sched, admission="device")
    out = []
    for bid, src, batch in batches:
        node = kg.queries if src == "q" else kg.docs
        t = fe.submit(node, batch, batch_id=bid)
        fe.flush(timeout=60)
        out.append(t.result(timeout=60))
    return fe, out


def knn_table(sched, kg):
    return {int(q): np.asarray(r, np.float32)
            for q, r in sched.read_table(kg.index).items()}


@pytest.mark.parametrize("seam", ["after_append", "after_tick"])
def test_knn_durable_kill_recover_resend_equals_uncrashed(tmp_path, seam):
    """Checkpoint after the preload, then the inserts, the retraction and
    the query update at depth 2; the last window dies at ``seam`` (its
    records logged but not dispatched, or dispatched and marked but not
    acknowledged). A fresh executor recovers from checkpoint plus tail,
    the upstream re-sends every batch from its cursor, and the table
    equals the uncrashed twin's exactly."""
    batches = knn_batches()
    kg0 = pknn.build_graph(Q, D, DIM, K, scan_chunk=128)
    twin = P.DirtyScheduler(kg0.graph, P.get_executor("cuda", device="cpu"))
    fe0, _ = knn_serve(twin, kg0, batches)
    fe0.close()
    want = knn_table(twin, kg0)

    wal_dir, ckpt = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    kg = pknn.build_graph(Q, D, DIM, K, scan_chunk=128)
    crash = CrashInjector(1, only=seam)
    crash.remaining = 10 ** 9  # armed below, before the last window
    sched = DurableScheduler(kg.graph, P.get_executor("cuda", device="cpu"),
                             wal_dir=wal_dir, fsync="tick", crash=crash)
    fe, res = knn_serve(sched, kg, batches[:N_PRELOAD])
    assert fe.depth == 2 and fe.admission == "device"
    save_checkpoint(sched, ckpt)
    _, res2 = knn_serve(sched, kg, batches[N_PRELOAD:-1], fe)
    assert all(r.status == APPLIED and r.lsn for r in res + res2)
    assert sched.megatick_windows == len(batches) - 1
    crash.remaining = 1
    bid, src, batch = batches[-1]
    t = fe.submit(kg.queries if src == "q" else kg.docs, batch,
                  batch_id=bid)
    with pytest.raises(PumpCrashed):
        t.result(timeout=60)
    assert crash.fired_seam == seam
    sched.wal.drain()  # what the page cache holds at the kill
    fe.close(flush=False)

    kg2 = pknn.build_graph(Q, D, DIM, K, scan_chunk=128)
    sched2 = DurableScheduler(kg2.graph,
                              P.get_executor("cuda", device="cpu"),
                              wal_dir=wal_dir, fsync="tick")
    rep = recover(sched2, wal_dir, ckpt)
    assert rep.checkpoint_loaded and rep.checkpoint_tick == N_PRELOAD
    if any(sched2._pending.values()):
        sched2.tick()  # the logged, undispatched window
    fe2, res3 = knn_serve(sched2, kg2, batches)
    fe2.close()
    assert {r.status for r in res3} <= {APPLIED, DEDUPED}
    assert all(r.status == DEDUPED for r in res3)
    got = knn_table(sched2, kg2)
    assert set(got) == set(want)
    for q in want:
        np.testing.assert_array_equal(got[q], want[q])
