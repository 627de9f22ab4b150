"""What ``embed.vitb16``'s comparison tells from a sound table, at the
configuration's CPU cut: the reference's own forward in the stated
precision passes; a table one write behind fails; and at the cut's
widths the same forward with the attention's products in bfloat16 fails
``stated_gap`` (at ViT-B/16's it moves the group means about as little
as the order of float32 sums does, and passes: PERF.md, section 2). The
reference's weights are a host copy made before the program is built."""

import pytest
import torch

from benchmark import generator, harness
from benchmark.tests import _tiny

BENCH = _tiny.bench()
CELL = "embed.vitb16"
CPU = torch.device("cpu")


def _inputs(seed):
    c = harness.cell(BENCH, CELL)
    cfg, mix = _tiny.tiny(BENCH, CELL)
    warm, window = generator.schedule(mix, seed, _tiny.SECONDS)
    dep = harness.load_module(c.config_dir / f"{c.config}.py").Deployment(
        cfg, mix, seed, "cpu")
    dep.make_data(warm, window)
    ref = harness.load_module(_tiny.ROOT / "reference" / f"{c.config}.py")
    return cfg, ref, dep.inputs(len(warm), len(window))


def _failed(cfg, got):
    return sorted(k for k, v in cfg["checks"].items() if got[k] > v)


@pytest.mark.parametrize("seed", [5, 77])
def test_stated_precision_passes_and_bf16_attention_fails_at_the_cut(seed):
    torch.set_num_threads(1)
    cfg, ref, inputs = _inputs(seed)
    stated = ref.means(cfg, inputs, CPU, ref._bf16)
    assert _failed(cfg, ref.judge(cfg, inputs, stated, CPU)) == []
    attn = ref.means(cfg, inputs, CPU, ref._bf16, ref._bf16)
    assert "stated_gap" in _failed(cfg, ref.judge(cfg, inputs, attn, CPU))


@pytest.mark.parametrize("seed", [5, 77])
def test_a_table_one_write_behind_fails(seed):
    torch.set_num_threads(1)
    cfg, ref, inputs = _inputs(seed)
    behind = dict(inputs, writes=inputs["writes"][:-1])
    table = ref.means(cfg, behind, CPU, ref._bf16)
    assert _failed(cfg, ref.judge(cfg, inputs, table, CPU))


def test_the_reference_weights_are_a_copy_made_before_the_program():
    c = harness.cell(BENCH, CELL)
    cfg, mix = _tiny.tiny(BENCH, CELL)
    warm, window = generator.schedule(mix, 5, _tiny.SECONDS)
    dep = harness.load_module(c.config_dir / f"{c.config}.py").Deployment(
        cfg, mix, 5, "cpu")
    dep.setup(warm, window)
    try:
        ref_w = dep.inputs(0, 0)["weights"]
        before = ref_w["blocks"][0]["wq"].clone()
        # an in-place write to the Map's params reaches the program alone
        dep.weights["blocks"][0]["wq"].add_(1.0)
        assert torch.equal(ref_w["blocks"][0]["wq"], before)
    finally:
        dep.close()
