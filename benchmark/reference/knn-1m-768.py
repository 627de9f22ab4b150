"""The plain reference of ``knn-1m-768``: brute-force top-k in blocks.

It rebuilds the corpus from the inputs the harness handed to the program
(the preload, remade from its seed, then every write sent, in order),
puts each operand in the configuration's stated form (int8 documents
dequantized to bfloat16, bfloat16 queries normalized in float32) and
scores in float64. The served table is judged by three numbers:

- ``missing``: served entries that are not a live document, repeat one,
  or are empty while k documents are live (limit 0);
- ``score_gap``: the widest gap between a served score and the
  reference's score of the same document;
- ``rank_gap``: the widest gap by which a served document's reference
  score lies below the query's true k-th best.

``control`` serves the same table with both operands in float8 (e4m3),
the precision below the stated one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import datagen

#: documents scored in one block
BLOCK = 1 << 16
NEG = float(np.finfo(np.float32).min)


def corpus(cfg: dict, inputs: dict, device):
    """``(int8 [D, dim], live bool [D])`` after every write sent."""
    D, dim = int(cfg["doc_key_space"]), int(cfg["dim"])
    vec = torch.zeros((D, dim), dtype=torch.int8, device=device)
    live = torch.zeros(D, dtype=torch.bool, device=device)
    n, chunk = inputs["preload"], inputs["preload_chunk"]
    for c in range(0, n, chunk):
        m = min(chunk, n - c)
        vec[c:c + m] = datagen.embeddings_int8(
            m, dim, datagen.generator(inputs["seed"], 13, c, device=device),
            device)
        live[c:c + m] = True
    for set_ids, new, drop in inputs["writes"]:
        if len(drop):
            live[torch.as_tensor(drop, device=device)] = False
        if len(set_ids):
            i = torch.as_tensor(set_ids, device=device)
            vec[i] = torch.as_tensor(new, device=device)
            live[i] = True
    return vec, live


def doc_form(v: torch.Tensor) -> torch.Tensor:
    """int8 rows dequantized to bfloat16: ``v * bf16(1/127)``, rounded to
    bfloat16 once."""
    return v.to(torch.bfloat16) * float(torch.tensor(1 / 127.0,
                                                     dtype=torch.bfloat16))


def query_form(q: np.ndarray, device) -> torch.Tensor:
    """The float32 queries cast to bfloat16, normalized in float32, stored
    as bfloat16."""
    v = torch.as_tensor(q, device=device).to(torch.bfloat16).float()
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return torch.where(n > 0, v / torch.clamp(n, min=1e-30),
                       0.0).to(torch.bfloat16)


def _topk(qf: torch.Tensor, vec, live, k: int, form, dtype):
    """Top k of ``qf @ form(vec).T`` over live rows, in blocks; ties to
    the lower id. Returns (scores, ids) [Q, k] on the device."""
    Q = qf.shape[0]
    best = torch.full((Q, k), -np.inf, dtype=dtype, device=qf.device)
    ids = torch.full((Q, k), -1, dtype=torch.int64, device=qf.device)
    for lo in range(0, vec.shape[0], BLOCK):
        s = qf @ form(vec[lo:lo + BLOCK]).to(dtype).T
        s = torch.where(live[lo:lo + BLOCK][None, :], s, -np.inf)
        cand = torch.cat([best, s], 1)
        cid = torch.cat([ids, torch.arange(lo, lo + s.shape[1],
                                           device=qf.device).expand(Q, -1)],
                        1)
        # stable sort on ids already ascending within the candidates
        cid, order = torch.sort(cid, dim=1, stable=True)
        cand = torch.gather(cand, 1, order)
        v, o = torch.sort(cand, dim=1, descending=True, stable=True)
        best, ids = v[:, :k], torch.gather(cid, 1, o[:, :k])
    return best, ids


def judge(cfg: dict, inputs: dict, table: Dict[int, np.ndarray],
          device) -> Dict[str, float]:
    """The three numbers of a served table (``{query: [k, 2] (id,
    score)}``) against the reference."""
    Q, k = int(cfg["queries"]), int(cfg["k"])
    vec, live = corpus(cfg, inputs, device)
    qf = query_form(inputs["queries"], device).double()
    ref_s, _ = _topk(qf, vec, live, k, doc_form, torch.float64)
    kth = ref_s[:, k - 1].cpu().numpy()
    n_live = int(live.sum())
    live_h = live.cpu().numpy()
    missing, score_gap, rank_gap = 0, 0.0, 0.0
    for q in range(Q):
        row = table.get(q)
        if row is None or np.asarray(row).shape != (k, 2):
            missing += k
            continue
        row = np.asarray(row, np.float64)
        ids = row[:, 0].astype(np.int64)
        sel = (ids >= 0) & (ids < len(live_h))
        sel[sel] = live_h[ids[sel]]
        served = ids[sel]
        missing += (min(k, n_live) - len(np.unique(served))
                    + int((ids[~sel] >= 0).sum()))
        if not len(served):
            continue
        d = doc_form(vec[torch.as_tensor(served, device=device)]).double()
        rs = (d @ qf[q]).cpu().numpy()
        score_gap = max(score_gap, float(np.abs(row[sel, 1] - rs).max()))
        rank_gap = max(rank_gap, float(kth[q] - rs.min()))
    return {"missing": float(missing), "score_gap": score_gap,
            "rank_gap": max(rank_gap, 0.0)}


def control(cfg: dict, inputs: dict, device) -> Dict[int, np.ndarray]:
    """The table the reference serves with both operands rounded to
    float8 e4m3 (scores summed in float32)."""
    Q, k = int(cfg["queries"]), int(cfg["k"])
    vec, live = corpus(cfg, inputs, device)
    f8 = torch.float8_e4m3fn
    qf = query_form(inputs["queries"], device).to(f8).float()
    s, ids = _topk(qf, vec, live, k, lambda v: doc_form(v).to(f8),
                   torch.float32)
    s, ids = s.cpu().numpy(), ids.cpu().numpy()
    return {q: np.stack([ids[q].astype(np.float32), s[q]], -1)
            for q in range(Q)}
