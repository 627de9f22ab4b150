"""Image-embed ETL (config 5) through the port: the ViT Map with
``params`` feeding an incremental groupby-mean, on the port's
``CpuExecutor`` and on its ``cuda`` executor run on the CPU
(``device="cpu"``), against the oracle (``ImageStream.
reference_centroids``: float64 means of the port's forward) and against
the JAX ``TpuExecutor`` on the same stream.

Tolerance: 2e-3 absolute on each centroid entry, as the JAX package's
own test holds its executors to its oracle (features of magnitude 1-2.5;
float32 sums over the group's rows against float64 means, and the two
packages' products differ only in summation order).
"""

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.delta import DeltaBatch as JDeltaBatch
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.models import init_vit as jinit_vit
from reflow_tpu.workloads import image_embed as jie
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.models import VIT_TINY, init_vit
from reflow_tpu_torch.workloads import image_embed as pie

N_IMG, N_GRP = 64, 8
ATOL = 2e-3


@pytest.fixture(scope="module")
def params():
    return init_vit(0, **VIT_TINY, device="cpu")


def _weights(p):
    return {k: v for k, v in p.items() if k != "_cfg"}


def _drive(sched, ig, stream, DB):
    """Two ticks: 24 inserts, then 16 inserts + a group move + a delete
    in one tick (tests/test_image_embed.py's stream)."""
    rng = np.random.default_rng(9)
    sched.push(ig.images, stream.insert(np.arange(24),
                                        rng.integers(0, N_GRP, 24)))
    sched.tick()
    sched.push(ig.images, DB.concat([
        stream.insert(np.arange(24, 40), rng.integers(0, N_GRP, 16)),
        stream.move(3, (stream.groups[3] + 1) % N_GRP),
        stream.delete(7),
    ]))
    sched.tick()


def _port(executor, params):
    ig = pie.build_graph(N_IMG, N_GRP, params)
    sched = P.DirtyScheduler(ig.graph, executor)
    stream = pie.ImageStream(params, seed=4)
    _drive(sched, ig, stream, P.DeltaBatch)
    return sched, ig, stream


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _close(got, want):
    assert set(int(k) for k in got) == set(int(k) for k in want)
    for grp, cent in want.items():
        np.testing.assert_allclose(np.asarray(got[grp], np.float64),
                                   np.asarray(cent, np.float64), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("executor", ["cpu", "cuda_on_cpu"])
def test_port_matches_oracle(params, executor):
    ex = (P.CpuExecutor() if executor == "cpu"
          else P.get_executor("cuda", device="cpu"))
    sched, ig, stream = _port(ex, params)
    _close(sched.read_table(ig.centroids), stream.reference_centroids())


def test_streams_draw_the_same_pixels(params):
    jp = jinit_vit(0, **VIT_TINY)
    js, ps = jie.ImageStream(jp, seed=4), pie.ImageStream(params, seed=4)
    jb = js.insert(np.arange(5), np.arange(5))
    pb = ps.insert(np.arange(5), np.arange(5))
    np.testing.assert_array_equal(pb.values, jb.values)
    np.testing.assert_array_equal(pie.pixels_to_input(pb.values),
                                  jie.pixels_to_input(jb.values))
    np.testing.assert_array_equal(
        pie.pixels_to_input(torch.from_numpy(pb.values)).numpy(),
        jie.pixels_to_input(jb.values))


def test_port_matches_jax_tpu_executor(params):
    jp = jinit_vit(0, **VIT_TINY)
    jig = jie.build_graph(N_IMG, N_GRP, jp)
    js = JDirtyScheduler(jig.graph, jget_executor("tpu"))
    _drive(js, jig, jie.ImageStream(jp, seed=4), JDeltaBatch)
    sched, ig, _ = _port(P.get_executor("cuda", device="cpu"), params)
    _close(sched.read_table(ig.centroids), js.read_table(jig.centroids))


def test_update_params_swaps_without_rebind(params, monkeypatch):
    ex = P.get_executor("cuda", device="cpu")
    ig = pie.build_graph(N_IMG, N_GRP, params)
    sched = P.DirtyScheduler(ig.graph, ex)
    binds = []
    monkeypatch.setattr(ex, "bind", lambda g: binds.append(g))
    stream = pie.ImageStream(params, seed=4)
    sched.push(ig.images, stream.insert(np.arange(8), np.zeros(8, int)))
    sched.tick()
    before = dict(sched.read_table(ig.centroids))
    old = ex.states[ig.embed.id]["params"]["blocks"][0]["wq"]

    params2 = init_vit(1, **VIT_TINY, device="cpu")
    ex.update_params(ig.embed, _weights(params2))
    new = ex.states[ig.embed.id]["params"]["blocks"][0]["wq"]
    assert new.data_ptr() != params2["blocks"][0]["wq"].data_ptr()
    assert np.array_equal(new.numpy(), params2["blocks"][0]["wq"].numpy())
    assert not np.array_equal(new.numpy(), old.numpy())
    # the same rows' features under the new weights change the centroid
    sched.push(ig.images, stream.insert(np.arange(8, 16), np.zeros(8, int)))
    sched.tick()
    after = dict(sched.read_table(ig.centroids))
    assert binds == [] and sched.executor is ex
    assert not np.allclose(after[0], before[0])
    # the table is the mean over both weight sets' features
    ref1 = pie.ImageStream(params, seed=4)
    ref1.insert(np.arange(8), np.zeros(8, int))
    ref2 = pie.ImageStream(params2)
    ref2.images = {i: stream.images[i] for i in range(8, 16)}
    ref2.groups = {i: 0 for i in range(8, 16)}
    want = (ref1.reference_centroids()[0]
            + ref2.reference_centroids()[0]) / 2
    np.testing.assert_allclose(np.asarray(after[0], np.float64), want,
                               rtol=0, atol=ATOL)


def test_update_params_needs_a_params_map(params):
    ex = P.get_executor("cuda", device="cpu")
    ig = pie.build_graph(N_IMG, N_GRP, params)
    P.DirtyScheduler(ig.graph, ex)
    with pytest.raises(GraphError, match="holds no params state"):
        ex.update_params(ig.centroids, _weights(params))


def test_snapshot_restore_params_map(params):
    """A snapshot of the params Map and the Reduce, a swap and a tick
    after it, then the restore: ticking on equals an uninterrupted run
    bit for bit, and the snapshot's params tree is a copy."""
    ex = P.get_executor("cuda", device="cpu")
    ig = pie.build_graph(N_IMG, N_GRP, params)
    sched = P.DirtyScheduler(ig.graph, ex)
    stream = pie.ImageStream(params, seed=4)
    sched.push(ig.images, stream.insert(np.arange(12), np.arange(12) % 3))
    sched.tick()
    snap = ex.state_snapshot()
    blocks = snap[ig.embed.id]["params"]["blocks"]
    assert isinstance(blocks, list) and len(blocks) == VIT_TINY["depth"]
    assert blocks[0]["wq"].data_ptr() != \
        ex.states[ig.embed.id]["params"]["blocks"][0]["wq"].data_ptr()
    nxt = stream.insert(np.arange(12, 20), np.arange(8) % 3)

    # the uninterrupted run
    sched.push(ig.images, nxt)
    sched.tick()
    want = dict(sched.read_table(ig.centroids))

    # diverge: new weights, another tick; then restore and replay
    ex.update_params(ig.embed, _weights(init_vit(2, **VIT_TINY,
                                                 device="cpu")))
    sched.push(ig.images, stream.insert(np.arange(20, 24), np.zeros(4, int)))
    sched.tick()
    ex.state_restore(snap)
    sched.push(ig.images, nxt)
    sched.tick()
    got = dict(sched.read_table(ig.centroids))
    assert set(got) == set(want)
    for g in want:
        np.testing.assert_array_equal(got[g], want[g])
    # the snapshot survived its restore unchanged
    np.testing.assert_array_equal(
        snap[ig.embed.id]["params"]["blocks"][1]["w2"].numpy(),
        params["blocks"][1]["w2"].numpy())


def test_bind_refuses_non_array_params_leaf(params):
    bad = dict(_weights(params), scale=0.5)
    g = P.FlowGraph("bad")
    src = g.source("x", P.Spec((3,), np.float32, key_space=8))
    g.map(src, lambda p, v: v, vectorized=True, params=bad,
          spec=P.Spec((3,), np.float32, key_space=8), name="m")
    with pytest.raises(GraphError, match="params leaves must be arrays, "
                                         "got float"):
        P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))


def test_bind_accepts_numpy_leaves_and_keeps_dtype():
    g = P.FlowGraph("np_params")
    src = g.source("x", P.Spec((3,), np.float32, key_space=8))
    w = {"w": np.eye(3, dtype=np.float32) * 2, "b": [np.ones(3, np.float64)]}
    m = g.map(src, lambda p, v: v @ p["w"] + p["b"][0], vectorized=True,
              params=w, spec=P.Spec((3,), np.float32, key_space=8),
              name="m")
    sink = g.sink(m, "out")
    ex = P.get_executor("cuda", device="cpu")
    sched = P.DirtyScheduler(g, ex)
    st = ex.states[m.id]["params"]
    assert st["w"].dtype == _torch_dtype(np.float32)
    assert st["b"][0].dtype == _torch_dtype(np.float64)
    sched.push(src, P.DeltaBatch(np.array([1, 2]),
                                 np.array([[1, 2, 3], [0, 0, 1]], np.float32)))
    sched.tick()
    assert {k: tuple(v) for k, v in sched.view_dict(sink).items()} == {
        1: (3.0, 5.0, 7.0), 2: (1.0, 1.0, 3.0)}


def test_row_wise_params_map_matches_cpu_executor():
    """A Map with params that is not vectorized maps over the rows with
    the params held fixed (``vmap`` with ``in_dims=(None, 0)``)."""
    w = {"scale": np.array([1.0, 2.0], np.float32),
         "shift": np.float32(0.5)}

    def build(pkg):
        g = pkg.FlowGraph("rowwise")
        src = g.source("x", pkg.Spec((2,), np.float32, key_space=16))
        m = g.map(src, lambda p, v: v * p["scale"] + p["shift"],
                  params=w, spec=pkg.Spec((2,), np.float32, key_space=16))
        return g, src, g.sink(m, "out")

    views = []
    for ex in (P.CpuExecutor(), P.get_executor("cuda", device="cpu")):
        g, src, sink = build(P)
        sched = P.DirtyScheduler(g, ex)
        rows = np.arange(8, dtype=np.float32).reshape(4, 2)
        sched.push(src, P.DeltaBatch(np.arange(4), rows))
        sched.tick()
        views.append({k: tuple(np.asarray(v, np.float32).tolist())
                      for k, v in sched.view_dict(sink).items()})
    assert views[0] == views[1] == {0: (0.5, 2.5), 1: (2.5, 6.5),
                                    2: (4.5, 10.5), 3: (6.5, 14.5)}


def test_build_graph_checks():
    """A tensor-parallel graph builds and runs only on a sharded executor
    with a model axis; too many groups are refused."""
    from reflow_tpu_torch.parallel import make_mesh
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    p = init_vit(0, **VIT_TINY, device="cpu")
    ig = pie.build_graph(N_IMG, N_GRP, p, model_axis="model")
    assert ig.embed.op.param_specs is not None
    with pytest.raises(GraphError, match="model_axis"):
        P.DirtyScheduler(ig.graph, ShardedCudaExecutor(
            make_mesh(2, device="cpu")))
    ig = pie.build_graph(N_IMG, N_GRP, p, model_axis="model")
    sched = P.DirtyScheduler(ig.graph, P.get_executor("cuda", device="cpu"))
    sched.push(ig.images, pie.ImageStream(p, seed=4).insert(
        np.arange(4), np.zeros(4, int)))
    with pytest.raises(GraphError, match="model_axis"):
        sched.tick()
    with pytest.raises(ValueError, match="n_groups must be <= 256"):
        pie.build_graph(N_IMG, 300, p)


def test_sharded_dataparallel_matches_oracle_and_jax(params):
    """Data-parallel image-embed on an 8-shard mesh: every shard holds a
    copy of the ViT params (a replicated Map state) and embeds its slice
    of the tick's rows; the centroids (key-sharded Reduce) match the
    oracle and JAX's sharded run within ``ATOL``. The shards' params are
    their own tensors, so an update reaches each of them."""
    from reflow_tpu.parallel import make_mesh as jmake_mesh
    from reflow_tpu.parallel.shard import ShardedTpuExecutor
    from reflow_tpu_torch.parallel import make_mesh
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    ex = ShardedCudaExecutor(make_mesh(8, device="cpu"))
    sched, ig, stream = _port(ex, params)
    got = sched.read_table(ig.centroids)
    _close(got, stream.reference_centroids())
    jp = jinit_vit(0, **VIT_TINY)
    jig = jie.build_graph(N_IMG, N_GRP, jp)
    js = JDirtyScheduler(jig.graph, ShardedTpuExecutor(jmake_mesh(8)))
    _drive(js, jig, jie.ImageStream(jp, seed=4), JDeltaBatch)
    _close(got, js.read_table(jig.centroids))
    leaves = [ex.shard_states(r)[ig.embed.id]["params"]["proj_w"]
              for r in range(8)]
    assert len({t.data_ptr() for t in leaves}) == 8
    ex.update_params(ig.embed, _weights(params))
    assert all(torch.equal(ex.shard_states(r)[ig.embed.id]["params"]
                           ["proj_w"], params["proj_w"]) for r in range(8))


# -- the model axis: tests/test_image_embed.py's tensor-parallel tests -----

def _tp_executor(n_delta, n_model):
    from reflow_tpu_torch.parallel import make_model_mesh
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    return ShardedCudaExecutor(make_model_mesh(n_delta, n_model,
                                               device="cpu"),
                               model_axis="model")


def _tp_port(params, ex):
    ig = pie.build_graph(N_IMG, N_GRP, params, model_axis="model")
    sched = P.DirtyScheduler(ig.graph, ex)
    stream = pie.ImageStream(params, seed=4)
    _drive(sched, ig, stream, P.DeltaBatch)
    return sched, ig, stream


def test_tensor_parallel_vit_matches_oracle_and_jax(params):
    """A (delta 2, model 4) mesh: the ViT's weights split tensor-parallel
    over the model axis, deltas row-sharded over the delta axis. The
    centroids match the oracle and JAX's tensor-parallel run within
    ``ATOL``; each shard holds 1/4 of every split matrix, and
    ``update_params`` keeps it so."""
    from reflow_tpu.parallel.mesh import make_model_mesh as jmake_model_mesh
    from reflow_tpu.parallel.shard import ShardedTpuExecutor
    from reflow_tpu_torch.parallel import spmd

    ex = _tp_executor(2, 4)
    assert ex.axis == "delta" and ex.n == 2 and ex.m == 4
    spmd.reset_collective_tally()
    sched, ig, stream = _tp_port(params, ex)
    # one forward a tick, two psums a block over the model axis
    assert spmd.collective_tally()[("psum", ("model",))][0] == \
        2 * 2 * VIT_TINY["depth"]
    got = sched.read_table(ig.centroids)
    _close(got, stream.reference_centroids())
    jp = jinit_vit(0, **VIT_TINY)
    jig = jie.build_graph(N_IMG, N_GRP, jp, model_axis="model")
    js = JDirtyScheduler(jig.graph, ShardedTpuExecutor(
        jmake_model_mesh(2, 4), model_axis="model"))
    _drive(js, jig, jie.ImageStream(jp, seed=4), JDeltaBatch)
    _close(got, js.read_table(jig.centroids))

    dim = VIT_TINY["dim"]
    wq = ex.states[ig.embed.id]["params"]["blocks"][0]["wq"]
    assert tuple(wq.shape) == (dim, dim)                # the global tree
    assert torch.equal(wq, params["blocks"][0]["wq"])
    for r in range(8):
        local = ex.shard_states(r)[ig.embed.id]["params"]["blocks"][0]
        assert tuple(local["wq"].shape) == (dim, dim // 4)
        assert tuple(local["wo"].shape) == (dim // 4, dim)
        assert tuple(local["ln1"]["g"].shape) == (dim,)
    ex.update_params(ig.embed, _weights(params))
    for r in range(8):
        local = ex.shard_states(r)[ig.embed.id]["params"]["blocks"][0]
        assert tuple(local["wq"].shape) == (dim, dim // 4)
        # shard (d, m) holds column slice m
        m = r % 4
        assert torch.equal(local["wq"], params["blocks"][0]["wq"][
            :, m * dim // 4:(m + 1) * dim // 4])


def test_tensor_parallel_rejects_nondivisible_heads():
    """heads=4 over a model axis of 8 fails loudly at the first tick."""
    p = init_vit(0, **VIT_TINY, device="cpu")
    ig = pie.build_graph(N_IMG, N_GRP, p, model_axis="model")
    sched = P.DirtyScheduler(ig.graph, _tp_executor(1, 8))
    stream = pie.ImageStream(p, seed=4)
    sched.push(ig.images, stream.insert(np.arange(8), np.zeros(8, int)))
    with pytest.raises(ValueError, match="must divide heads"):
        sched.tick()


def test_tensor_parallel_save_restore_round_trips(params, tmp_path):
    """A checkpoint of a tensor-parallel graph holds the global tree (the
    slices joined); a restore onto a fresh executor re-slices it, and
    the next tick matches the live run's exactly."""
    from reflow_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    ex = _tp_executor(2, 4)
    sched, ig, stream = _tp_port(params, ex)
    save_checkpoint(sched, str(tmp_path))
    ex2 = _tp_executor(2, 4)
    ig2 = pie.build_graph(N_IMG, N_GRP, params, model_axis="model")
    sched2 = P.DirtyScheduler(ig2.graph, ex2)
    load_checkpoint(sched2, str(tmp_path))
    for r in range(8):
        a = ex.shard_states(r)[ig.embed.id]["params"]["blocks"][1]["w2"]
        b = ex2.shard_states(r)[ig2.embed.id]["params"]["blocks"][1]["w2"]
        assert torch.equal(a, b) and a.shape[0] == VIT_TINY["mlp_dim"] // 4
    batch = stream.insert(np.arange(40, 48), np.arange(8) % N_GRP)
    for s, g in ((sched, ig), (sched2, ig2)):
        s.push(g.images, batch)
        s.tick()
    a, b = sched.read_table(ig.centroids), sched2.read_table(ig2.centroids)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    _close(a, stream.reference_centroids())
