"""The port's ViT (reflow_tpu_torch/models/vit.py) against the JAX
package's: the weights ``init_vit`` draws, ``vit_flops``, the bf16
product ``_dot`` and the whole forward, at ``VIT_TINY`` and at ViT-B/16
widths cut to one block. Inputs are made with numpy from a seed and
handed to both packages.

Tolerances. ``_dot``: both packages round the operands to bf16 and sum
the exact float32 products in float32, so only the summation order
differs: 1e-5 of the output's largest magnitude. The forward: each
product's last-bit differences can flip a bf16 rounding at the next
product, a change of one bf16 step in a few operands; over one or two
blocks that leaves well under 1e-3 on features of magnitude 1-2.5, and
the tests hold 5e-3 absolute.

On the CPU the port's ``_dot`` takes its plain version (the tensors lie
on the CPU); the card's bf16 GEMM (``torch.mm(..., out_dtype=float32)``)
is held to the plain version by the ``cuda``-marked test below and by
``chip_smoke.py`` phase 11.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflow_tpu.models import vit as jvit
from reflow_tpu_torch.models import vit as pvit
from reflow_tpu_torch.utils.tree import tree_leaves, tree_map

CONFIGS = {"tiny": jvit.VIT_TINY,
           "b16_depth1": dict(jvit.VIT_B_16, depth=1)}
FORWARD_ATOL = 5e-3
DOT_RTOL = 1e-5


def _weights(p):
    return {k: v for k, v in p.items() if k != "_cfg"}


def _pixels(cfg, n, seed):
    flat = cfg["img"] * cfg["img"] * cfg["chans"]
    px = np.random.default_rng(seed).integers(0, 256, (n, flat),
                                              dtype=np.uint8)
    return px.astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)


def test_configs_match_jax():
    assert pvit.VIT_B_16 == jvit.VIT_B_16
    assert pvit.VIT_TINY == jvit.VIT_TINY


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_vit_leaves_bit_equal(name):
    cfg = CONFIGS[name]
    jp, pp = jvit.init_vit(0, **cfg), pvit.init_vit(0, **cfg, device="cpu")
    assert pp["_cfg"] == jp["_cfg"]

    def same(a, b):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        return np.array_equal(a.view(np.uint32), b.view(np.uint32))

    eq = tree_map(same, _weights(jp), _weights(pp))
    assert all(tree_leaves(eq)) and len(tree_leaves(eq)) == 5 + 12 * cfg[
        "depth"]


@pytest.mark.parametrize("name", sorted(CONFIGS) + ["b16"])
def test_vit_flops_match_jax(name):
    cfg = CONFIGS.get(name, jvit.VIT_B_16)
    assert pvit.vit_flops(**cfg) == jvit.vit_flops(**cfg)


@pytest.mark.parametrize("m,k,n", [(392, 768, 768), (64, 3072, 768),
                                   (50, 37, 5)])
def test_plain_dot_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    want = np.asarray(jvit._dot(jnp.asarray(a), jnp.asarray(b)))
    got = pvit._dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    # the same function as the plain version, which the CPU runs
    assert torch.equal(got, pvit._dot_plain(torch.from_numpy(a),
                                            torch.from_numpy(b)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=DOT_RTOL * scale)


def test_dot_output_is_not_bf16_rounded():
    """The product's output keeps float32 bits: a bf16 matmul would round
    it to 8 mantissa bits."""
    a = torch.full((1, 3), 1.0)
    b = torch.tensor([[1.0], [2.0 ** -8], [2.0 ** -9]])
    assert pvit._dot(a, b).item() == 1.0 + 2.0 ** -8 + 2.0 ** -9


@pytest.mark.parametrize("name,n", [("tiny", 16), ("b16_depth1", 2)])
def test_forward_matches_jax(name, n):
    cfg = CONFIGS[name]
    jp, pp = jvit.init_vit(0, **cfg), pvit.init_vit(0, **cfg, device="cpu")
    x = _pixels(cfg, n, seed=3)
    want = np.asarray(jvit.vit_forward(jp, jnp.asarray(x)))
    got = pvit.vit_forward(pp, torch.from_numpy(x))
    assert got.shape == (n, cfg["dim"]) and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FORWARD_ATOL)
    # the plain forward is the same function on the CPU
    assert torch.equal(got, pvit.vit_forward_plain(pp, torch.from_numpy(x)))


def test_dot_refuses_mixed_devices():
    with pytest.raises(ValueError, match="operands on"):
        pvit._dot(torch.ones(2, 2), torch.ones(2, 2, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 GEMM with float32 output "
                    "does not run on the CPU (chip_smoke.py phase 11 checks "
                    "it on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_dot_matches_plain(cuda_device):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((6272, 768)).astype(
        np.float32)).to(cuda_device)
    b = torch.from_numpy((rng.standard_normal((768, 3072)) / 768 ** 0.5)
                         .astype(np.float32)).to(cuda_device)
    got = pvit._dot(a, b)
    want = pvit._dot_plain(a, b)
    assert got.dtype == torch.float32
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= DOT_RTOL * float(scale)
