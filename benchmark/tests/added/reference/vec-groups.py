"""The plain reference of ``vec-groups``: group means in float64.

It rebuilds the items from the inputs the harness handed to the program
(the preload, then every write sent, in order), maps each vector through
tanh and takes each group's mean of its live items. The served table
(``{group: vector}``) is judged by two numbers:

- ``missing``: groups with live items that the table lacks or serves in
  another shape, and served groups that have none (limit 0);
- ``mean_gap``: the widest gap between a served feature and the
  reference's.

``control`` serves the same table computed in bfloat16, the precision
below the program's float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def items(cfg: dict, inputs: dict):
    """``(group [N] int64, -1 for no item; vector [N, dim] float32)``
    after every write sent."""
    grp = np.full(int(cfg["items"]), -1, np.int64)
    vec = np.zeros((int(cfg["items"]), int(cfg["dim"])), np.float32)
    for ids, groups, vecs, drop in inputs["writes"]:
        grp[drop] = -1
        grp[ids] = groups
        vec[ids] = vecs
    return grp, vec


def means(cfg: dict, inputs: dict, device, dtype) -> Dict[int, np.ndarray]:
    """Each group's mean of ``tanh`` of its live items' vectors, computed
    in ``dtype`` on ``device``."""
    grp, vec = items(cfg, inputs)
    live = grp >= 0
    g = torch.as_tensor(grp[live], device=device)
    v = torch.tanh(torch.as_tensor(vec[live], device=device).to(dtype))
    G = int(cfg["groups"])
    sums = torch.zeros((G, v.shape[1]), dtype=dtype, device=device)
    sums.index_add_(0, g, v)
    n = torch.bincount(g, minlength=G)
    out = (sums / n.clamp(min=1)[:, None].to(dtype)).double().cpu().numpy()
    return {int(i): out[i] for i in torch.nonzero(n).flatten().tolist()}


def judge(cfg: dict, inputs: dict, table: Dict[int, np.ndarray],
          device) -> Dict[str, float]:
    """The two numbers of a served table against the reference."""
    ref = means(cfg, inputs, device, torch.float64)
    missing, gap = 0, 0.0
    for g, want in ref.items():
        got = table.get(g)
        if got is None or np.shape(got) != want.shape:
            missing += 1
            continue
        gap = max(gap, float(np.abs(np.asarray(got, np.float64)
                                    - want).max()))
    missing += len(set(table) - set(ref))
    return {"missing": float(missing), "mean_gap": gap}


def control(cfg: dict, inputs: dict, device) -> Dict[int, np.ndarray]:
    """The table the reference serves in bfloat16."""
    return means(cfg, inputs, device, torch.bfloat16)
