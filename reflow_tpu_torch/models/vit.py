"""Vision Transformer feature extractor in PyTorch (config 5's Map model).

The counterpart of ``reflow_tpu/models/vit.py``: params are a plain tree
(a dict; ``blocks`` a list of dicts) of float32 tensors and the forward
is a pure function, so it embeds as a vectorized Map function with the
weights as the Map's ``params``. Standard pre-LN ViT: patchify -> linear
projection + learned positional embedding -> depth x [LN, MSA, residual,
LN, MLP(gelu), residual] -> final LN -> mean pool over patches.

Numerics follow the JAX package:

- :func:`_dot` takes bf16 operands and gives a float32 product summed in
  float32 (JAX's ``preferred_element_type``). On the card it is
  :func:`_dot_card`, cuBLAS's bf16 GEMM with float32 output
  (``torch.mm(..., out_dtype=torch.float32)``). On the CPU, where this
  overload does not run, it is :func:`_dot_plain`: both operands rounded
  to bf16 and multiplied in float32. A product of two bf16 values is
  exact in float32, so the two differ only in summation order. A bf16
  ``torch.matmul`` would round the output to bf16, a different result,
  and no path here uses one.
- Attention stays float32: two batched products and a softmax. TF32
  must be off (``torch.backends.cuda.matmul.allow_tf32 = False``, the
  default) to match JAX's float32 einsums.
- GELU is the tanh approximation, ``jax.nn.gelu``'s default.
- LayerNorm takes the population variance and ``rsqrt(v + 1e-6)``.

Tensor parallelism (:func:`vit_param_specs`, :func:`vit_forward_tp`):
Megatron's layout over a model axis of ``m`` shards. QKV and MLP-in are
column-sharded (each shard holds ``heads/m`` heads and ``mlp_dim/m``
hidden units), attention-out and MLP-out row-sharded, and each
row-sharded product is summed over the model axis by one ``psum``: two a
block. The forward is a generator body of the SPMD runtime
(``parallel/spmd.py``) that yields those psums; activations are the
same on every member of a model group.

While a profiler records, the bf16 GEMMs run inside ``reflow::vit.gemm``
ranges and the attention products inside ``reflow::vit.attn_products``,
so a trace can split the forward's device time; everything else is
elementwise work (LayerNorm, bias adds, GELU, softmax, the bf16 casts).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from reflow_tpu_torch.executors.device_delta import resolve_device
from reflow_tpu_torch.executors.lowerings import span

__all__ = ["init_vit", "vit_forward", "vit_forward_plain",
           "vit_forward_tp", "vit_flops", "vit_param_specs", "VIT_B_16",
           "VIT_TINY"]

#: ViT-B/16 (the reference workload's extractor)
VIT_B_16 = dict(img=224, chans=3, patch=16, dim=768, depth=12, heads=12,
                mlp_dim=3072)
#: tiny config for CI
VIT_TINY = dict(img=16, chans=3, patch=8, dim=32, depth=2, heads=4,
                mlp_dim=64)


def init_vit(seed: int, *, img: int, chans: int, patch: int, dim: int,
             depth: int, heads: int, mlp_dim: int, dtype=torch.float32,
             device=None) -> Dict:
    """Random weights from ``np.random.default_rng(seed)``, drawn in the
    JAX package's order, so every leaf equals ``reflow_tpu.models.
    init_vit``'s bit for bit; on ``device`` (the card unless the caller
    names one). ``_cfg`` holds the shape-driving config."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_patches = (img // patch) ** 2
    pdim = patch * patch * chans

    def dense(*shape):
        w = rng.normal(0, shape[0] ** -0.5, shape).astype(np.float32)
        return torch.from_numpy(w).to(device=device, dtype=dtype)

    def const(n, v):
        return torch.full((n,), v, dtype=dtype, device=device)

    params = {
        "proj_w": dense(pdim, dim),
        "proj_b": const(dim, 0.0),
        "pos": torch.from_numpy(
            rng.normal(0, 0.02, (n_patches, dim)).astype(np.float32)).to(
                device=device, dtype=dtype),
        "ln_f": {"g": const(dim, 1.0), "b": const(dim, 0.0)},
        "blocks": [],
    }
    for _ in range(depth):
        params["blocks"].append({
            "ln1": {"g": const(dim, 1.0), "b": const(dim, 0.0)},
            "ln2": {"g": const(dim, 1.0), "b": const(dim, 0.0)},
            "wq": dense(dim, dim), "wk": dense(dim, dim),
            "wv": dense(dim, dim), "wo": dense(dim, dim),
            "w1": dense(dim, mlp_dim),
            "b1": const(mlp_dim, 0.0),
            "w2": dense(mlp_dim, dim),
            "b2": const(dim, 0.0),
        })
    params["_cfg"] = dict(img=img, chans=chans, patch=patch, dim=dim,
                          depth=depth, heads=heads, mlp_dim=mlp_dim)
    return params


def _ln(x, p):
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, keepdim=True, correction=0)
    return (x - m) * torch.rsqrt(v + 1e-6) * p["g"] + p["b"]


def _dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands rounded to bf16, multiplied and summed
    in float32 (on any device; with TF32 off on the card)."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


def _dot_card(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one cuBLAS bf16 GEMM with float32 accumulation and
    float32 output, ``a`` flattened to 2-D."""
    a2 = a.reshape(-1, a.shape[-1]).to(torch.bfloat16)
    b2 = b.to(torch.bfloat16)
    with span("vit.gemm"):
        try:
            out = torch.mm(a2, b2, out_dtype=torch.float32)
        except TypeError as e:
            raise RuntimeError(
                f"torch {torch.__version__} has no torch.mm(..., "
                f"out_dtype=torch.float32), the bf16 GEMM with float32 "
                f"output that the ViT's products need on the card") from e
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, float32 accumulation and output: :func:`_dot_card`
    on CUDA tensors, :func:`_dot_plain` on CPU tensors."""
    if a.device.type == "cuda" and b.device.type == "cuda":
        return _dot_card(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return _dot_plain(a, b)
    raise ValueError(f"_dot operands on {a.device} and {b.device}")


def _attn(x, blk, heads: int, dot: Callable):
    """Multi-head attention over ``heads`` heads of ``blk``'s projections
    (all of them, or one model shard's column slices), ending in the
    output projection (a partial product under tensor parallelism)."""
    d = blk["wq"].shape[-1]
    hd = d // heads

    def split(w):
        y = dot(x, w)
        return y.reshape(*y.shape[:-1], heads, hd)       # [.., n, h, hd]

    q, k, v = split(blk["wq"]), split(blk["wk"]), split(blk["wv"])
    qh = q.transpose(-3, -2).contiguous()                # [.., h, n, hd]
    kt = k.movedim(-3, -1).contiguous()                  # [.., h, hd, n]
    vh = v.transpose(-3, -2).contiguous()                # [.., h, n, hd]
    with span("vit.attn_products"):
        logits = torch.matmul(qh, kt)                    # [.., h, q, k]
    a = torch.softmax(logits * (hd ** -0.5), dim=-1)
    with span("vit.attn_products"):
        o = torch.matmul(a, vh)                          # [.., h, q, hd]
    o = o.transpose(-3, -2).reshape(*x.shape[:-1], d)
    return dot(o, blk["wo"])


def vit_flops(*, img: int, chans: int, patch: int, dim: int, depth: int,
              heads: int, mlp_dim: int) -> float:
    """Matmul FLOPs per image at the FMA=2 convention (the one peak rates
    use, so achieved/peak is a true MFU): the patch projection and, per
    block, the QKVO projections, attention scores and apply, and the MLP;
    LN/gelu/pool vector work is left out. ViT-B/16 at 224: ~35 GFLOP."""
    n = (img // patch) ** 2
    pdim = patch * patch * chans
    per_block = 8 * n * dim * dim + 4 * n * n * dim + 4 * n * dim * mlp_dim
    return float(2 * n * pdim * dim + depth * per_block)


def _embed(params: Dict, images: torch.Tensor, dot: Callable):
    cfg = params["_cfg"]
    img, chans, patch = cfg["img"], cfg["chans"], cfg["patch"]
    b = images.shape[0]
    x = images.reshape(b, img, img, chans).to(torch.float32)
    g = img // patch
    # patchify: [B, g, p, g, p, C] -> [B, g*g, p*p*C]
    x = x.reshape(b, g, patch, g, patch, chans)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, patch * patch * chans)
    return dot(x, params["proj_w"]) + params["proj_b"] + params["pos"]


def _forward(params: Dict, images: torch.Tensor, dot: Callable):
    cfg = params["_cfg"]
    x = _embed(params, images, dot)
    for blk in params["blocks"]:
        x = x + _attn(_ln(x, blk["ln1"]), blk, cfg["heads"], dot)
        h = dot(_ln(x, blk["ln2"]), blk["w1"]) + blk["b1"]
        x = x + dot(F.gelu(h, approximate="tanh"), blk["w2"]) + blk["b2"]
    x = _ln(x, params["ln_f"])
    return x.mean(dim=-2)


def vit_forward(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C] (or [B, H*W*C] flat) -> features [B, dim]
    float32, every product through :func:`_dot`."""
    return _forward(params, images, _dot)


def vit_forward_plain(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """:func:`vit_forward` with every product through :func:`_dot_plain`,
    on any device: the yardstick the card's forward is held to."""
    return _forward(params, images, _dot_plain)


# -- tensor-parallel forward over a (delta, model) mesh -------------------

def vit_param_specs(cfg: Dict, model_axis: str = "model"):
    """Per-leaf :class:`~reflow_tpu_torch.parallel.mesh.PartSpec` s for
    Megatron tensor parallelism, the JAX package's layout: QKV and MLP-in
    split by column (dim 1), attention-out and MLP-out by row (dim 0),
    ``b1`` split; the LayerNorms, the row-sharded layers' biases, the
    projection and the positional table replicated. The tree is
    ``init_vit``'s without ``_cfg``."""
    from reflow_tpu_torch.parallel.mesh import PartSpec

    col_w = PartSpec(None, model_axis)      # [in, out/m]
    row_w = PartSpec(model_axis, None)      # [in/m, out]
    rep = PartSpec()
    block = {
        "ln1": {"g": rep, "b": rep}, "ln2": {"g": rep, "b": rep},
        "wq": col_w, "wk": col_w, "wv": col_w, "wo": row_w,
        "w1": col_w, "b1": PartSpec(model_axis), "w2": row_w, "b2": rep,
    }
    return {
        "proj_w": rep, "proj_b": rep, "pos": rep,
        "ln_f": {"g": rep, "b": rep},
        "blocks": [dict(block) for _ in range(cfg["depth"])],
    }


def vit_forward_tp(params: Dict, images: torch.Tensor,
                   axis: str = "model"):
    """One model shard's tensor-parallel forward, a generator body:
    ``params`` holds this shard's slices (:func:`vit_param_specs`), the
    images are the same on every member of the model group, and each
    block yields two ``psum`` requests over ``axis`` (attention-out,
    MLP-out). Drive it with ``yield from`` inside an SPMD region (the
    sharded Map lowering does); it returns the features ``[B, dim]``,
    equal to :func:`vit_forward`'s up to float32 summation order. The
    model axis size is read from the slices; one that does not divide
    ``heads``, ``dim`` and ``mlp_dim`` raises ``ValueError``."""
    from reflow_tpu_torch.parallel.spmd import psum

    cfg = params["_cfg"]
    m = cfg["dim"] // params["blocks"][0]["wq"].shape[-1] \
        if params["blocks"] else 1
    if (cfg["heads"] % m or cfg["dim"] % m or cfg["mlp_dim"] % m
            or cfg["dim"] // m != params["blocks"][0]["wq"].shape[-1]):
        # a wrong split passes every shape check (heads=4 over m=8 with
        # dim 32) but fuses fractions of heads into each local one
        raise ValueError(
            f"model axis size {m} must divide heads={cfg['heads']}, "
            f"dim={cfg['dim']}, and mlp_dim={cfg['mlp_dim']}")
    heads_local = cfg["heads"] // m
    x = _embed(params, images, _dot)
    for blk in params["blocks"]:
        part = _attn(_ln(x, blk["ln1"]), blk, heads_local, _dot)
        x = x + (yield psum(part, axis))
        h = _dot(_ln(x, blk["ln2"]), blk["w1"]) + blk["b1"]
        part = _dot(F.gelu(h, approximate="tanh"), blk["w2"])
        x = x + (yield psum(part, axis)) + blk["b2"]
    x = _ln(x, params["ln_f"])
    return x.mean(dim=-2)
