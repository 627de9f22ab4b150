"""The port's tensor-parallel ViT (``vit_param_specs``,
``vit_forward_tp``) against the JAX package's, on the CPU.

The port's forward is a generator body of its SPMD runtime: it runs here
on ``make_model_mesh(1, 4, device="cpu")`` (four model shards, each with
its slices of the weights), JAX's under ``shard_map`` on four of
conftest's 8 forced CPU devices. Inputs come from a numpy seed.

Tolerance: 5e-3 absolute on features of magnitude 1-2.5, the same as the
whole forward's in ``test_torch_vit.py``. The two packages sum the
psums' partial products in another order, and the tensor-parallel
forward sums each row-sharded product in four parts where the plain
forward sums it whole, so a last-bit difference can flip one bf16
rounding at the next product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from reflow_tpu.models import vit as jvit
from reflow_tpu.parallel.mesh import make_model_mesh as jmake_model_mesh
from reflow_tpu.parallel.shard import shard_map
from reflow_tpu_torch.models import vit as pvit
from reflow_tpu_torch.parallel import spmd
from reflow_tpu_torch.parallel.mesh import (PartSpec, join_by_spec,
                                            make_model_mesh, slice_by_spec)

ATOL = 5e-3


def _weights(p):
    return {k: v for k, v in p.items() if k != "_cfg"}


def _pixels(cfg, n, seed):
    flat = cfg["img"] * cfg["img"] * cfg["chans"]
    px = np.random.default_rng(seed).integers(0, 256, (n, flat),
                                              dtype=np.uint8)
    return px.astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)


def _pairs(port, jax_tree, path=()):
    """(path, port PartSpec, JAX PartitionSpec) over both spec trees."""
    if isinstance(port, PartSpec):
        assert isinstance(jax_tree, PartitionSpec), path
        yield path, port, jax_tree
        return
    if isinstance(port, dict):
        assert set(port) == set(jax_tree), path
        for k in port:
            yield from _pairs(port[k], jax_tree[k], path + (k,))
        return
    assert len(port) == len(jax_tree), path
    for i, (a, b) in enumerate(zip(port, jax_tree)):
        yield from _pairs(a, b, path + (i,))


@pytest.mark.parametrize("axis", ["model", "mp"])
def test_param_specs_match_jax(axis):
    """The same leaves split, over the same dim, as JAX's tree; the rest
    replicated."""
    cfg = jvit.VIT_TINY
    pairs = list(_pairs(pvit.vit_param_specs(cfg, axis),
                        jvit.vit_param_specs(cfg, axis)))
    assert len(pairs) == 5 + 12 * cfg["depth"]
    split = 0
    for path, ps, js in pairs:
        assert tuple(ps) == tuple(js), path
        split += ps.dim_of(axis) is not None
    assert split == 7 * cfg["depth"]   # wq wk wv wo w1 b1 w2 a block


def _port_tp(p, x, m):
    """The port's forward on a (1, m) mesh: each model shard's slice of
    the weights, the same images; every shard's features."""
    specs = pvit.vit_param_specs(p["_cfg"])
    mesh = make_model_mesh(1, m, device="cpu")

    def body(ctx, w):
        return (yield from pvit.vit_forward_tp({**w, "_cfg": p["_cfg"]}, x))

    args = [(slice_by_spec(_weights(p), specs, "model", m, j),)
            for j in range(m)]
    return spmd.run(mesh, body, args, "model")


def test_forward_tp_matches_jax_and_the_plain_forward():
    cfg = jvit.VIT_TINY
    jp, pp = jvit.init_vit(0, **cfg), pvit.init_vit(0, **cfg, device="cpu")
    x = _pixels(cfg, 6, seed=5)
    spmd.reset_collective_tally()
    outs = _port_tp(pp, torch.from_numpy(x), 4)
    # two psums a block over the model axis, each one region-wide step
    assert spmd.collective_tally()[("psum", ("model",))][0] == \
        2 * cfg["depth"]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])      # every model shard agrees
    got = outs[0].numpy()
    assert got.shape == (6, cfg["dim"]) and np.isfinite(got).all()

    jmesh = jmake_model_mesh(1, 4)
    specs = jvit.vit_param_specs(cfg, "model")
    fn = shard_map(lambda w, xx: jvit.vit_forward_tp(
        {**w, "_cfg": cfg}, xx, axis="model"), mesh=jmesh,
        in_specs=(specs, PartitionSpec()), out_specs=PartitionSpec(),
        check_vma=False)
    want = np.asarray(jax.jit(fn)(_weights(jp), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    plain = pvit.vit_forward(pp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)


def test_slices_join_back_to_the_params():
    p = pvit.init_vit(0, **jvit.VIT_TINY, device="cpu")
    specs = pvit.vit_param_specs(p["_cfg"])
    parts = [slice_by_spec(_weights(p), specs, "model", 4, j)
             for j in range(4)]
    assert parts[1]["blocks"][0]["wq"].shape == (32, 8)
    assert parts[1]["blocks"][0]["wo"].shape == (8, 32)
    assert parts[1]["blocks"][0]["b1"].shape == (16,)
    assert parts[1]["pos"] is p["pos"]
    whole = join_by_spec(parts, specs, "model")
    for a, b in zip(jax.tree_util.tree_leaves(whole),
                    jax.tree_util.tree_leaves(_weights(p))):
        assert torch.equal(a, b)


def test_nondivisible_heads_raise():
    """heads=4 over a model axis of 8: every shape splits (dim 32 into
    4-wide slices) but each shard would fuse half a head, so the forward
    refuses it, as JAX's does."""
    p = pvit.init_vit(0, **jvit.VIT_TINY, device="cpu")
    x = torch.from_numpy(_pixels(jvit.VIT_TINY, 2, seed=1))
    with pytest.raises(ValueError, match="must divide heads"):
        _port_tp(p, x, 8)
