"""The window path on a model axis (config 5 tensor parallel), on the CPU.

The port's sharded executor runs ``tick_many`` windows, the staged
``stage_window`` -> ``dispatch_window`` -> ``retire_window`` lifecycle
and a depth-2 ``IngestFrontend`` on ``make_model_mesh(2, 2,
device="cpu")``: the ingress queue splits each slot over the two data
shards and both members of a model group read their data shard's one
buffer. Each window is held to the port's per-tick run on the same mesh
(bit for bit: every tick's slot has the per-tick upload's capacity), and
to the JAX package's ``ShardedTpuExecutor(make_model_mesh(2, 2),
model_axis="model")`` window on four of conftest's 8 forced CPU devices,
within test_torch_image_embed.py's tolerance (2e-3 absolute on each
centroid entry; the packages sum the psums' partial products in another
order). A ViT of 2 blocks (``VIT_TINY``), 16-19 images a tick.
"""

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.executors.ingress_queue import DeviceIngressQueue
from reflow_tpu_torch.models import VIT_TINY, init_vit
from reflow_tpu_torch.parallel import make_mesh, make_model_mesh, spmd
from reflow_tpu_torch.parallel.mesh import Mesh
from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor
from reflow_tpu_torch.serve import CoalesceWindow, IngestFrontend
from reflow_tpu_torch.workloads import image_embed as pie

N_IMG, N_GRP, PER_TICK = 64, 8, 16
ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_scratch_copies(monkeypatch):
    # the JAX queue reuses a host scratch under asynchronous transfers
    # and its own window tests fail under load (ROADMAP Queue 3)
    import reflow_tpu.executors.ingress_queue as jiq

    monkeypatch.setattr(jiq, "_SCRATCH_REUSE_SAFE", False)


@pytest.fixture(scope="module")
def params():
    return init_vit(0, **VIT_TINY, device="cpu")


def _feed(stream, concat, ticks):
    """``ticks`` batches: 16 inserts a tick, and from the second tick on
    a group move and a delete of earlier images (16-19 rows, one
    capacity bucket)."""
    rng = np.random.default_rng(9)
    out = []
    for t in range(ticks):
        ids = np.arange(PER_TICK * t, PER_TICK * (t + 1))
        b = stream.insert(ids, rng.integers(0, N_GRP, PER_TICK))
        if t:
            i = int(rng.integers(0, PER_TICK * t))
            j = (i + 5) % (PER_TICK * t)
            b = concat([b, stream.move(i, (stream.groups[i] + 1) % N_GRP),
                        stream.delete(j)])
        out.append(b)
    return out


def _tp_sched(params):
    ex = ShardedCudaExecutor(make_model_mesh(2, 2, device="cpu"),
                             model_axis="model")
    ig = pie.build_graph(N_IMG, N_GRP, params, model_axis="model")
    return P.DirtyScheduler(ig.graph, ex), ig


def _per_tick(params, ticks):
    sched, ig = _tp_sched(params)
    for b in _feed(pie.ImageStream(params, seed=4), DeltaBatch.concat,
                   ticks):
        sched.push(ig.images, b)
        sched.tick()
    assert sched.megatick_windows == 0
    return sched, ig


def _assert_tables_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def _close(got, want):
    assert set(int(k) for k in got) == set(int(k) for k in want)
    for grp, cent in want.items():
        np.testing.assert_allclose(np.asarray(got[grp], np.float64),
                                   np.asarray(cent, np.float64), rtol=0,
                                   atol=ATOL)


def _engaged(sched, windows):
    assert sched.megatick_windows == windows
    assert sched.megatick_fallbacks == 0
    assert sched.executor.window_dispatches == windows


@pytest.mark.parametrize("k", [2, 4])
def test_model_axis_window_equals_per_tick(params, k):
    """Windows of ``k`` ticks on a (delta 2, model 2) mesh: one queue
    window a ``tick_many``, no fallback, two psums over the model axis a
    block a tick, and the centroids and the params equal the per-tick
    run's bit for bit."""
    ticks = 4
    sched, ig = _tp_sched(params)
    assert sched.executor.supports_window()
    spmd.reset_collective_tally()
    feed = _feed(pie.ImageStream(params, seed=4), DeltaBatch.concat, ticks)
    for lo in range(0, ticks, k):
        r = sched.tick_many([{ig.images: b} for b in feed[lo:lo + k]])
        r.block()
        assert r.quiesced
    _engaged(sched, ticks // k)
    assert spmd.collective_tally()[("psum", ("model",))][0] == \
        2 * VIT_TINY["depth"] * ticks
    twin, tig = _per_tick(params, ticks)
    _assert_tables_equal(sched.read_table(ig.centroids),
                         twin.read_table(tig.centroids))
    for r in sched.executor.mesh.local_ranks:
        a = sched.executor.shard_states(r)[ig.embed.id]["params"]
        b = twin.executor.shard_states(r)[tig.embed.id]["params"]
        assert torch.equal(a["blocks"][1]["w1"], b["blocks"][1]["w1"])


def test_model_axis_staged_windows_equal_tick_many(params):
    """The staged lifecycle by hand: window 2 staged while window 1 is
    in flight (two queue generations), each retired after the next was
    staged; the tables equal one ``tick_many`` of the same ticks."""
    sched, ig = _tp_sched(params)
    feed = _feed(pie.ImageStream(params, seed=4), DeltaBatch.concat, 4)
    h1 = sched.stage_window([{ig.images: b} for b in feed[:2]])
    sched.dispatch_staged(h1)
    h2 = sched.stage_window([{ig.images: b} for b in feed[2:]])
    assert h1 is not None and h2 is not None
    q = h2.sw.queue
    assert q.generations == 2 and q.in_flight == 2
    sched.retire_staged(h1)
    sched.dispatch_staged(h2)
    sched.retire_staged(h2)
    assert q.in_flight == 0 and sched.megatick_windows == 2
    twin, tig = _per_tick(params, 4)
    _assert_tables_equal(sched.read_table(ig.centroids),
                         twin.read_table(tig.centroids))


def test_model_axis_window_matches_jax_sharded_window(params):
    """The same four ticks as two windows of 2 through JAX's sharded
    executor on its (delta 2, model 2) mesh: the centroids within
    ``ATOL`` of the port's window, and JAX's states, carried over with
    ``convert.states_from_jax``, within ``ATOL`` of the port's (the
    group counts exact, the params bit for bit)."""
    from reflow_tpu import DirtyScheduler as JDirtyScheduler
    from reflow_tpu.delta import DeltaBatch as JDeltaBatch
    from reflow_tpu.models import init_vit as jinit_vit
    from reflow_tpu.parallel.mesh import make_model_mesh as jmake_model_mesh
    from reflow_tpu.parallel.shard import ShardedTpuExecutor
    from reflow_tpu.workloads import image_embed as jie
    from reflow_tpu_torch.convert import states_from_jax, states_to_numpy

    sched, ig = _tp_sched(params)
    feed = _feed(pie.ImageStream(params, seed=4), DeltaBatch.concat, 4)
    for lo in (0, 2):
        sched.tick_many([{ig.images: b} for b in feed[lo:lo + 2]]).block()
    _engaged(sched, 2)

    jp = jinit_vit(0, **VIT_TINY)
    jig = jie.build_graph(N_IMG, N_GRP, jp, model_axis="model")
    jex = ShardedTpuExecutor(jmake_model_mesh(2, 2), model_axis="model")
    js = JDirtyScheduler(jig.graph, jex)
    jfeed = _feed(jie.ImageStream(jp, seed=4), JDeltaBatch.concat, 4)
    for lo in (0, 2):
        js.tick_many([{jig.images: b} for b in jfeed[lo:lo + 2]]).block()
    assert js.megatick_windows == 2 and js.megatick_fallbacks == 0
    got = sched.read_table(ig.centroids)
    _close(got, js.read_table(jig.centroids))

    jst = {nid: {name: (np.asarray(a) if not isinstance(a, dict) else a)
                 for name, a in st.items()}
           for nid, st in jex.states.items()}
    carried = states_to_numpy(states_from_jax(jst, ig.graph, device="cpu"))
    mine = states_to_numpy(sched.executor.states)
    assert set(carried) == set(mine)
    for nid, st in mine.items():
        # the sharded executor's own leaves (the route-overflow flag)
        # have no JAX counterpart to carry
        assert set(carried[nid]) <= set(st)
        for name, a in st.items():
            if name == "params" or name not in carried[nid]:
                continue
            b = carried[nid][name]
            if name == "wsum":
                # a sum of wcnt feature rows: the tolerance is a mean's
                n = np.maximum(np.abs(st["wcnt"]), 1)[:, None]
                a, b = a / n, b / n
            if np.issubdtype(np.asarray(a).dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                           err_msg=f"{nid}/{name}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{nid}/{name}")
    wq = sched.executor.states[ig.embed.id]["params"]["blocks"][0]["wq"]
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(jex.states[ig.embed.id]["params"]
                               ["blocks"][0]["wq"]))


def test_model_axis_frontend_pipelines_windows(params):
    """A depth-2 ``IngestFrontend`` over the (delta 2, model 2) mesh,
    pumped in this thread: four ticks as two windows of 2, the second
    staged while the first is in flight; every ticket applied and the
    table equal to the per-tick run's."""
    sched, ig = _tp_sched(params)
    fe = IngestFrontend(sched, start=False, depth=2,
                        window=CoalesceWindow(max_rows=PER_TICK, max_ticks=2,
                                              max_latency_s=0.001))
    assert fe.megatick and fe.depth == 2
    feed = _feed(pie.ImageStream(params, seed=4), DeltaBatch.concat, 4)
    try:
        tks = [fe.submit(ig.images, b) for b in feed]
        with fe._lock:
            drained = fe._take_window()
        fe._run_window(drained)
        with fe._lock:
            fe._finish_window()
        assert all(t.result(timeout=0).applied for t in tks)
    finally:
        fe.close()
    assert fe.windows_pipelined > 0 and fe.windows_staged == 2
    _engaged(sched, 2)
    twin, tig = _per_tick(params, 4)
    _assert_tables_equal(sched.read_table(ig.centroids),
                         twin.read_table(tig.centroids))


# -- the queue's placement ---------------------------------------------------

def _spec():
    from reflow_tpu_torch.delta import Spec

    return Spec((2,), np.float32, key_space=64)


def _rows(n, lo=0):
    return DeltaBatch(np.arange(lo, lo + n, dtype=np.int64),
                      np.arange(2 * n, dtype=np.float32).reshape(n, 2),
                      np.ones(n, np.int64))


def test_queue_splits_over_data_shards_and_replicates_over_model():
    """On (delta 2, model 4) a slot splits over the 2 data shards, not
    the 8 entries; the executor's region hands every member of a model
    group its data shard's rows, the same tensors."""
    mesh = make_model_mesh(2, 4, device="cpu")
    q = DeviceIngressQueue({0: _spec()}, {0: 64}, 2,
                           placement=(mesh, "delta"))
    assert q.n_data == 2 and q.data_base == 0 and len(q.shard_devices) == 2
    q.write(0, 0, _rows(40))
    q.write(1, 0, _rows(0))
    st = q.stacked()[0]
    assert [p.keys.shape for p in st] == [(2, 32)] * 2
    np.testing.assert_array_equal(st[0].keys[0].numpy(), np.arange(32))
    np.testing.assert_array_equal(st[1].keys[0, :8].numpy(),
                                  np.arange(32, 40))
    assert int(st[1].weights[0].sum()) == 8
    ex = ShardedCudaExecutor(mesh, model_axis="model")
    parts = ex._split(st)
    assert len(parts) == 8
    for r in range(8):
        d = r // 4
        assert parts[r].keys.data_ptr() == st[d].keys.data_ptr()
        assert torch.equal(parts[r].values, st[d].values)
    assert q.gen_nbytes == 2 * 64 * (4 + 4 + 2 * 4)


def test_queue_capacity_must_divide_the_data_shards():
    """``cap % n_data`` is the check: 6 rows split over (delta 2, model
    4)'s two data shards, not over its 8 entries; a capacity the data
    shards do not divide raises before any buffer is made."""
    q = DeviceIngressQueue({0: _spec()}, {0: 6}, 1,
                           placement=(make_model_mesh(2, 4, device="cpu"),
                                      "delta"))
    assert [p.keys.shape for p in q.stacked()[0]] == [(1, 3)] * 2
    with pytest.raises(ValueError, match="4 data shards"):
        DeviceIngressQueue({0: _spec()}, {0: 6}, 1,
                           placement=(make_mesh(4, device="cpu"), "delta"))


def test_queue_on_a_process_mesh_holds_its_own_shards():
    """Process 1 of a (dcn 2, delta 4) mesh: the queue holds data shards
    4-7 only, and a write of the GLOBAL batch lands its rows 32-63 of a
    64-row slot there (8 a shard), as the per-tick upload slices them."""
    devs = np.array(["cpu"] * 8, dtype=object).reshape(2, 4)
    mesh = Mesh(devs, ("dcn", "delta"), process_count=2, process_index=1)
    q = DeviceIngressQueue({0: _spec()}, {0: 64}, 1,
                           placement=(mesh, ("dcn", "delta")))
    assert q.n_data == 8 and q.data_base == 4 and len(q.shard_devices) == 4
    q.write(0, 0, _rows(50))
    st = q.stacked()[0]
    assert [p.keys.shape for p in st] == [(1, 8)] * 4
    got = np.concatenate([p.keys[0].numpy() for p in st])
    want = np.zeros(32, np.int32)
    want[:18] = np.arange(32, 50)
    np.testing.assert_array_equal(got, want)
    w = np.concatenate([p.weights[0].numpy() for p in st])
    assert int(w.sum()) == 18
    assert q.gen_nbytes == 32 * (4 + 4 + 2 * 4)


def test_supports_window_on_model_and_process_meshes(params):
    """A fixpoint, sink-free graph windows on a model mesh and on a mesh
    across processes; a graph with a sink still does not."""
    sched, _ = _tp_sched(params)
    assert sched.window_support
    from reflow_tpu_torch.workloads import pagerank as ppr

    devs = np.array(["cpu"] * 4, dtype=object).reshape(2, 2)
    mesh = Mesh(devs, ("dcn", "delta"), process_count=2, process_index=0)
    pr = ppr.build_graph(32, arena_capacity=4096)
    ps = P.DirtyScheduler(pr.graph, ShardedCudaExecutor(mesh))
    assert ps.window_support
    ig = pie.build_graph(N_IMG, N_GRP, params, model_axis="model")
    ig.graph.sink(ig.embed, "feats")
    ex = ShardedCudaExecutor(make_model_mesh(2, 2, device="cpu"),
                             model_axis="model")
    assert not P.DirtyScheduler(ig.graph, ex).window_support
