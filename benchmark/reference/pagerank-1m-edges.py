"""The plain reference of ``pagerank-1m-edges``: power iteration.

It rebuilds the graph from the inputs the harness handed to the program
(the graph remade from its seed, then every rewire sent, in order) and
iterates ``r = (1 - d) + d * sum over in-edges of r[src] / outdeg[src]``
in float64 until no rank moves by 1e-12. The served ranks are judged by
``rank_err``: the largest ``|rank - ref| / max(ref, 1)``.

``control`` iterates the same in bfloat16, the precision below the
program's float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import datagen


def edges(inputs: dict):
    src, dst = datagen.web_graph(inputs["nodes"], inputs["edges"],
                                 inputs["seed"])
    for idx, new in zip(inputs["idx"], inputs["new"]):
        dst[idx] = new
    return src, dst


def power(inputs: dict, device, dtype=torch.float64,
          tol: float = 1e-12, iters: int = 2000) -> np.ndarray:
    n, d = inputs["nodes"], inputs["damping"]
    src, dst = edges(inputs)
    src_t = torch.as_tensor(src, device=device)
    dst_t = torch.as_tensor(dst, device=device)
    deg = torch.bincount(src_t, minlength=n).to(dtype)
    inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1), 0.0).to(dtype)
    r = torch.ones(n, dtype=dtype, device=device)
    for _ in range(iters):
        contrib = torch.zeros(n, dtype=dtype, device=device)
        contrib.index_add_(0, dst_t, (r * inv)[src_t])
        r_new = ((1.0 - d) + d * contrib).to(dtype)
        done = float((r_new - r).abs().max()) < tol
        r = r_new
        if done:
            break
    return r.double().cpu().numpy()


def judge(cfg: dict, inputs: dict, ranks: np.ndarray,
          device) -> Dict[str, float]:
    ref = power(inputs, device)
    return {"rank_err": float((np.abs(ranks - ref)
                               / np.maximum(ref, 1.0)).max())}


def control(cfg: dict, inputs: dict, device) -> np.ndarray:
    return power(inputs, device, dtype=torch.bfloat16, tol=1e-4, iters=200)
