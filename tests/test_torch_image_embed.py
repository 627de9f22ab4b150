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
    p = init_vit(0, **VIT_TINY, device="cpu")
    with pytest.raises(NotImplementedError, match="step 10"):
        pie.build_graph(N_IMG, N_GRP, p, model_axis="model")
    with pytest.raises(ValueError, match="n_groups must be <= 256"):
        pie.build_graph(N_IMG, 300, p)
