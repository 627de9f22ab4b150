"""The plain reference of ``vit-b16-etl``: ViT-B/16 in plain PyTorch and
float32, and each group's mean of its live images' features in float64.

It rebuilds the live images from the inputs the harness handed to the
program (the weights, as a host copy made before the program was built,
the pixels, the preload, then every write sent, in order), runs each live image once through the forward below, in blocks
of images so that it fits beside the program's freed state, and sums
each group's features in float64. The forward is the paper's ViT-Base
encoder (Dosovitskiy et al., arXiv:2010.11929: patches of 16 x 16 x 3
projected to 768, learned positions, 12 pre-LN blocks of 12-head
self-attention and a 3,072-wide MLP, a final LayerNorm), with the
departures the configuration states: no class token (the final
LayerNorm's output averaged over the 196 patches), no bias on the
attention's Q, K, V and output projections, the tanh GELU, LayerNorm's
epsilon 1e-6, and no classification head (a feature extractor). Every
product is float32 with TF32 off.

The served table (``{group: vector}``) is judged by three numbers:

- ``missing``: groups with live images that the table lacks or serves in
  another shape, and served groups that have none (limit 0);
- ``mean_gap``: the largest gap between a served feature and the
  reference's, over every group, relative to the norm of that group's
  reference mean;
- ``stated_gap``: the same gap against the forward in the precision the
  configuration states: the projections' and the MLP's operands rounded
  to bfloat16 and multiplied and summed in float32, every other product
  float32. The bfloat16 rounding the configuration allows sets most of
  ``mean_gap``, about as much as a table one write behind moves it, so
  ``mean_gap`` alone cannot tell such a table from a sound one; against
  this forward a sound program differs only by the order of its float32
  sums, far less.

``control`` serves the same table one precision down: the products the
configuration states with bfloat16 operands (the projections and the
MLP) take float8 e4m3 operands, and the float32 attention products take
bfloat16 operands, each summed in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

#: images a block of the forward (activations of a few hundred MB at
#: ViT-B/16's widths)
BLOCK = 128
#: float8 e4m3's largest finite value: operands are clamped to it before
#: the cast, which would otherwise make a larger one NaN
E4M3_MAX = 448.0


def _ln(x, p):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + 1e-6) * p["g"] + p["b"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def _f32(a, b):
    return a @ b


def _e4m3(t):
    return t.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).float()


def _fp8(a, b):
    return _e4m3(a) @ _e4m3(b)


def _bf16(a, b):
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def features(cfg: dict, w: dict, px: torch.Tensor, dot: Callable = _f32,
             attn_dot: Callable = _f32) -> torch.Tensor:
    """``[B, dim]`` float32 features of ``px`` (``[B, img*img*chans]``
    uint8, each image's rows, columns and channels in order). ``dot`` takes
    the projections' and the MLP's products, ``attn_dot`` the attention's
    two."""
    img, chans, patch = int(cfg["img"]), int(cfg["chans"]), int(cfg["patch"])
    heads, dim = int(cfg["heads"]), int(cfg["dim"])
    b, g, hd = px.shape[0], img // patch, dim // heads
    x = px.to(torch.float32) * np.float32(2.0 / 255.0) - 1.0
    x = x.reshape(b, g, patch, g, patch, chans).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, g * g, patch * patch * chans)
    x = dot(x, w["proj_w"]) + w["proj_b"] + w["pos"]
    n = g * g
    for blk in w["blocks"]:
        h = _ln(x, blk["ln1"])
        q, k, v = (dot(h, blk[m]).reshape(b, n, heads, hd).transpose(1, 2)
                   for m in ("wq", "wk", "wv"))
        a = torch.softmax(attn_dot(q, k.transpose(-1, -2)) / math.sqrt(hd),
                          dim=-1)
        o = attn_dot(a, v).transpose(1, 2).reshape(b, n, dim)
        x = x + dot(o, blk["wo"])
        h = _ln(x, blk["ln2"])
        x = x + dot(_gelu(dot(h, blk["w1"]) + blk["b1"]), blk["w2"]) \
            + blk["b2"]
    return _ln(x, w["ln_f"]).mean(dim=1)


def live_images(cfg: dict, inputs: dict):
    """``(group, image)`` int64 arrays over the id space after every write
    sent, -1 where an id holds no image."""
    grp = np.full(int(cfg["images"]), -1, np.int64)
    img = np.full(int(cfg["images"]), -1, np.int64)
    for ids, groups, images, drop in inputs["writes"]:
        grp[drop] = img[drop] = -1
        grp[ids] = groups
        img[ids] = images
    return grp, img


def means(cfg: dict, inputs: dict, device, dot: Callable = _f32,
          attn_dot: Callable = _f32) -> Dict[int, np.ndarray]:
    """Each group's mean feature over its live images: the forward in
    blocks on ``device``, the sums in float64."""
    # a float32 product on the card may run in TF32 unless both are off;
    # set here, at the reference's own call, after the program has run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)

    def to(t):
        if isinstance(t, dict):
            return {k: to(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to(v) for v in t]
        return torch.as_tensor(t).to(device=dev, dtype=torch.float32)

    w = to(inputs["weights"])
    grp, img = live_images(cfg, inputs)
    live = np.flatnonzero(grp >= 0)
    G = int(cfg["groups"])
    sums = np.zeros((G, int(cfg["dim"])), np.float64)
    with torch.no_grad():
        for at in range(0, len(live), BLOCK):
            ids = live[at:at + BLOCK]
            px = torch.from_numpy(inputs["pixels"][img[ids]]).to(dev)
            f = features(cfg, w, px, dot, attn_dot).double().cpu().numpy()
            np.add.at(sums, grp[ids], f)
    n = np.bincount(grp[live], minlength=G)
    return {int(g): sums[g] / n[g] for g in np.flatnonzero(n)}


def _gap(ref: Dict[int, np.ndarray], table: Dict[int, np.ndarray]) -> float:
    """The largest gap between a served feature and ``ref``'s over the
    groups served in ``ref``'s shape, each over its ``ref`` mean's norm."""
    gap = 0.0
    for g, want in ref.items():
        got = table.get(g)
        if got is not None and np.shape(got) == want.shape:
            gap = max(gap, float(np.abs(np.asarray(got, np.float64)
                                        - want).max()
                                 / np.linalg.norm(want)))
    return gap


def judge(cfg: dict, inputs: dict, table: Dict[int, np.ndarray],
          device) -> Dict[str, float]:
    """The three numbers of a served table against the reference."""
    ref = means(cfg, inputs, device)
    missing = sum(1 for g, want in ref.items()
                  if np.shape(table.get(g)) != want.shape)
    missing += len(set(table) - set(ref))
    return {"missing": float(missing), "mean_gap": _gap(ref, table),
            "stated_gap": _gap(means(cfg, inputs, device, _bf16), table)}


def control(cfg: dict, inputs: dict, device) -> Dict[int, np.ndarray]:
    """The table the reference serves one precision down: float8 e4m3
    operands where the configuration states bfloat16, bfloat16 where it
    states float32."""
    return means(cfg, inputs, device, _fp8, _bf16)
