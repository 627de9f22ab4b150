"""The port's k-NN slice served through ``IngestFrontend``, against the
JAX package's frontend over the same batches (on the CPU, small size).

Each batch is submitted and flushed before the next, so both frontends
tick the same feeds; tickets must resolve ``applied`` and the tables
must match (ids exact, scores within 1e-5: the same float32 sums in
another order). The port's frontend runs at its default depth (2): the
k-NN graph has no sink and no loop, so each flush stages a window
through the port's ingress queue. The JAX frontend runs both ways: with
``fixpoint=False`` (per-tick streaming ticks) and with its default
executor, which takes its own window path.
"""

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.executors.tpu import TpuExecutor
from reflow_tpu.serve import IngestFrontend as JIngestFrontend
from reflow_tpu.workloads import knn as jknn
from reflow_tpu_torch.executors.device_delta import to_device
from reflow_tpu_torch.serve import APPLIED, DEDUPED
from reflow_tpu_torch.workloads import knn as pknn

Q, D, DIM, K = 16, 512, 32, 4


def _batches(seed):
    """(source, keys, values, weights) in submit order."""
    rng = np.random.default_rng(seed)

    def vecs(n):
        return rng.standard_normal((n, DIM)).astype(np.float32)

    out = [("q", np.arange(Q), vecs(Q), 1)]
    out += [("d", np.arange(i, i + 64), vecs(64), 1)
            for i in range(0, 256, 64)]
    out.append(("d", np.arange(20, 50), np.zeros((30, DIM), np.float32), -1))
    out.append(("q", np.arange(4), vecs(4), 1))        # query update
    out.append(("d", np.arange(256, 300), vecs(44), 1))
    return out


def _serve(pkg, seed, device_batches=False):
    if pkg in ("jax", "jax_window"):
        kg = jknn.build_graph(Q, D, DIM, K, scan_chunk=128)
        sched = JDirtyScheduler(kg.graph,
                                TpuExecutor(fixpoint=pkg == "jax_window"))
        fe = JIngestFrontend(sched)
        from reflow_tpu import DeltaBatch as DB
    else:
        kg = pknn.build_graph(Q, D, DIM, K, scan_chunk=128)
        ex = (P.CpuExecutor() if pkg == "oracle"
              else P.get_executor("cuda", device="cpu"))
        sched = P.DirtyScheduler(kg.graph, ex)
        fe = P.IngestFrontend(sched)
        DB = P.DeltaBatch
    results = []
    try:
        for src, keys, vals, w in _batches(seed):
            node = kg.queries if src == "q" else kg.docs
            b = DB(np.asarray(keys, np.int64), vals,
                   np.full(len(keys), w, np.int64))
            if device_batches:
                b = to_device(b, node.spec, device="cpu")
            t = fe.submit(node, b)
            fe.flush(timeout=60)
            results.append(t.result(timeout=60))
        table = {int(q): np.asarray(r, np.float32)
                 for q, r in sched.read_table(kg.index).items()}
    finally:
        fe.close()
    return table, results, fe, sched


@pytest.mark.parametrize("seed", [0, 1])
def test_frontend_port_matches_jax_frontend(seed):
    pt, pres, pfe, _ = _serve("port", seed)
    jt, jres, _, _ = _serve("jax", seed)
    ct, _, _, _ = _serve("oracle", seed)
    assert all(r.status == APPLIED for r in pres)
    assert all(r.status == APPLIED for r in jres)
    assert pfe.applied == len(pres)
    assert set(pt) == set(jt) == set(ct) == set(range(Q))
    for q in pt:
        for other in (jt, ct):
            np.testing.assert_array_equal(pt[q][:, 0], other[q][:, 0])
            np.testing.assert_allclose(pt[q][:, 1], other[q][:, 1],
                                       atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_window_path_at_depth_2_matches_jax_window_path(seed, monkeypatch):
    """The port's frontend at its default depth against the JAX frontend
    over the default executor, both taking their window paths: every
    flush is one staged window, tickets ``applied``, ids exact, scores
    within 1e-5. (The JAX queue's host scratch reuse is turned off: see
    ``tests/test_torch_megatick.py``.)"""
    import reflow_tpu.executors.ingress_queue as jiq

    monkeypatch.setattr(jiq, "_SCRATCH_REUSE_SAFE", False)
    pt, pres, pfe, psched = _serve("port", seed)
    jt, jres, jfe, jsched = _serve("jax_window", seed)
    n = len(_batches(seed))
    assert pfe.depth == jfe.depth == 2
    assert pfe.admission == jfe.admission == "device"
    assert psched.megatick_windows == jsched.megatick_windows == n
    assert psched.megatick_fallbacks == jsched.megatick_fallbacks == 0
    assert pfe.windows_staged == jfe.windows_staged == n
    assert all(r.status == APPLIED for r in pres + jres)
    assert set(pt) == set(jt) == set(range(Q))
    for q in pt:
        np.testing.assert_array_equal(pt[q][:, 0], jt[q][:, 0])
        np.testing.assert_allclose(pt[q][:, 1], jt[q][:, 1], atol=1e-5)


def test_device_batches_through_frontend_match_host_batches():
    host, _, _, _ = _serve("port", 2)
    dev, res, _, sched = _serve("port", 2, device_batches=True)
    assert all(r.status == APPLIED for r in res)
    assert set(host) == set(dev)
    for q in host:
        np.testing.assert_array_equal(host[q], dev[q])
    # a device-resident batch counts its live rows lazily, at block():
    # the last tick folded the last batch
    assert sched.history[-1].block().deltas_in == len(_batches(2)[-1][1])


def test_resubmitted_batch_id_dedups():
    kg = pknn.build_graph(Q, D, DIM, K, scan_chunk=128)
    sched = P.DirtyScheduler(kg.graph, P.get_executor("cuda", device="cpu"))
    rng = np.random.default_rng(8)
    b = P.DeltaBatch(np.arange(Q), rng.standard_normal((Q, DIM)
                                                       ).astype(np.float32))
    with P.IngestFrontend(sched) as fe:
        t1 = fe.submit(kg.queries, b, batch_id="q@0")
        fe.flush(timeout=60)
        t2 = fe.submit(kg.queries, b, batch_id="q@0")
        assert t1.result(timeout=60).status == APPLIED
        assert t2.result(timeout=60).status == DEDUPED
    assert sched._tick == 1


def test_streaming_ticks_make_no_readback_but_the_branch():
    """The pump ticks with sync=False: the only forced syncs are the k-NN
    lowering's one host branch decision per tick."""
    _, res, _, sched = _serve("port", 3)
    assert sched.forced_syncs == sched.executor.host_syncs + 1  # + read
    assert sched.executor.host_syncs == len(res)
    assert torch.count_nonzero(
        sched.executor.states[sched.graph.nodes[-1].id]["em_has"]) == Q
