"""The readers of ``embed.vitb16``'s per-layer metrics, against what the
program records: ``embed.forward_pad_pct`` reads back the ``rows`` and
``live`` counts of the params Map's ``map`` spans (``VIT_TINY`` widths
on the CPU, hand-built ticks with padding) over the replayed ticks
alone, and nothing from a program whose spans carry no counts;
``mfu.embed`` counts ``vit_flops`` an image; ``embed.elementwise_pct``
leaves the products and the copies out."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu_torch import obs
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.models import VIT_B_16, VIT_TINY, init_vit, vit_flops
from reflow_tpu_torch.obs import trace
from reflow_tpu_torch.workloads import image_embed as pie

from benchmark import harness, kernel_counts
from benchmark.tests import _tiny


def _reader(name):
    return harness.load_module(_tiny.ROOT / "layer_metrics" / f"{name}.py")


@pytest.fixture
def traced():
    obs.disable()
    trace.reset()
    obs.enable()
    yield
    obs.disable()
    trace.reset()


def _padded(rng, cap, n_live):
    flat = VIT_TINY["img"] ** 2 * VIT_TINY["chans"]
    v = torch.from_numpy(rng.integers(0, 256, (cap, 1 + flat),
                                      dtype=np.uint8))
    v[:, 0] = 0
    w = torch.zeros(cap, dtype=torch.int32)
    w[rng.permutation(cap)[:n_live]] = 1
    return DeviceDelta(torch.arange(cap, dtype=torch.int32), v, w)


def test_forward_pad_pct_reads_the_replayed_maps_counts(traced):
    rng = np.random.default_rng(7)
    ig = pie.build_graph(512, 4, init_vit(0, **VIT_TINY, device="cpu"))
    sched = P.DirtyScheduler(ig.graph, P.get_executor("cuda", device="cpu"))
    # ticks before the replay, padded otherwise, are left out
    for cap, n in ((256, 10), (64, 64)):
        sched.push(ig.images, _padded(rng, cap, n))
        sched.tick()
    tick_a = sched._tick
    replay = ((128, 100), (128, 70), (64, 33))
    for cap, n in replay:
        sched.push(ig.images, _padded(rng, cap, n))
        sched.tick()
    run = SimpleNamespace(slice=SimpleNamespace(tick_a=tick_a,
                                                tick_b=sched._tick))
    fwd = sum(c for c, _n in replay)
    want = 100.0 * (fwd - sum(n for _c, n in replay)) / fwd
    assert _reader("embed.forward_pad_pct").read(run) == pytest.approx(want)


def test_forward_pad_pct_finds_nothing_without_counts(traced):
    # the parent's program: map spans without args
    trace.evt("device_dispatch", 1.0, 1.0, args={"tick": 1})
    trace.evt("map", 1.5, 0.1)
    run = SimpleNamespace(slice=SimpleNamespace(tick_a=0, tick_b=1))
    assert _reader("embed.forward_pad_pct").read(run) is None


def test_mfu_counts_vit_flops_for_each_delta_row():
    mod = _reader("mfu.embed")
    cfg = dict(VIT_B_16)
    assert mod.vit_flops(cfg) == vit_flops(**VIT_B_16) == 34_941_763_584
    sl = SimpleNamespace(device=[(0.0, 1.0, "k")], busy_s=0.5,
                         tick_infos={1: [{"rows": 450}], 2: [{"rows": 440}]})
    run = SimpleNamespace(slice=sl, cell=SimpleNamespace(cfg=cfg))
    want = 100.0 * 890 * 34_941_763_584 / (0.5 * kernel_counts.BF16_OPS_PER_S)
    assert mod.read(run) == pytest.approx(want)


def test_elementwise_pct_leaves_out_products_and_copies():
    dev = [(0, 30, "nvjet_tss_192x192_64x3_1x2_h_bz_coopB_NNN"),
           (30, 50, "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8"),
           (50, 60, "void at::native::vectorized_elementwise_kernel<4>"),
           (60, 75, "void (anonymous namespace)::softmax_warp_forward"),
           (75, 175, "Memcpy HtoD (Pinned -> Device)"),
           (175, 180, "Memset (Device)")]
    run = SimpleNamespace(slice=SimpleNamespace(device=dev))
    assert _reader("embed.elementwise_pct").read(run) == \
        pytest.approx(100.0 * 25 / 75)
