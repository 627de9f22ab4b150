"""Top-k: the hand-written CUDA kernel and its plain PyTorch version.

The k-NN workload's hot op is a row-wise top-k over a float32 scores
matrix. On a CUDA tensor :func:`topk` launches ``csrc/topk.cu`` (one
thread block per row, the row held in shared memory, k block-wide
argmax rounds; it replaces the TPU kernel
``reflow_tpu/kernels/topk.py::_topk_kernel``). On a CPU tensor it runs
:func:`topk_plain`, a stable descending sort. Both return distinct
columns, larger value first and the lower column on equal values, so
they agree exactly on every input.

``chunked_corpus_topk`` is the streaming form for corpora whose scores
matrix would not fit memory: one ``torch.matmul`` per corpus chunk,
folded into a running (values, ids) top-k carry.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

__all__ = ["topk", "topk_plain", "chunked_corpus_topk", "score_form",
           "scores", "NEG", "INT8_EMBED_SCALE", "TOPK_LAUNCHES"]

#: sentinel for "no candidate" — finite so arithmetic/compares stay clean
NEG = float(np.finfo(np.float32).min)

#: kernel launches made by :func:`topk` (CUDA tensors only); a run resets
#: it to 0 and reads it back to show its path went through the kernel
TOPK_LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from reflow_tpu_torch.kernels._build import load

        fn = load("topk").reflow_topk_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def topk_plain(scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of ``scores [Q, N]`` -> ``(values f32, ids int32)
    [Q, k]`` by a stable descending sort: distinct columns, the lower
    column first on equal values."""
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of ``scores [Q, N]`` -> ``(values f32, ids int32)
    [Q, k]``, ties to the lowest column. A CPU tensor runs
    :func:`topk_plain`; a CUDA tensor launches the kernel on the current
    stream, or raises. ``scores`` must be a contiguous float32 matrix
    with ``1 <= k <= N``."""
    global TOPK_LAUNCHES
    if scores.dim() != 2:
        raise ValueError(f"topk takes a [Q, N] matrix, got shape "
                         f"{tuple(scores.shape)}")
    q, n = scores.shape
    if not 1 <= k <= n:
        raise ValueError(f"topk needs 1 <= k <= N, got k={k}, N={n}")
    if scores.dtype != torch.float32:
        raise TypeError(f"topk takes float32 scores, got {scores.dtype}")
    if scores.device.type == "cpu":
        return topk_plain(scores, k)
    if scores.device.type != "cuda":
        raise ValueError(f"topk runs on cpu or cuda, not {scores.device}")
    if not scores.is_contiguous():
        raise ValueError("topk needs a contiguous scores matrix")
    if q >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"topk shape {tuple(scores.shape)} exceeds int32")
    vals = torch.empty((q, k), dtype=torch.float32, device=scores.device)
    ids = torch.empty((q, k), dtype=torch.int32, device=scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = _kernel()(scores.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                    q, n, k, scores.device.index, stream)
    if err != 0:
        raise RuntimeError(f"top-k kernel launch failed: cudaError {err} "
                           f"(shape {q}x{n}, k={k})")
    TOPK_LAUNCHES += 1
    return vals, ids


#: int8 embedding encoding: wire/table value is round(unit_vec * 127);
#: cosine only needs direction, so the per-vector scale folds away
INT8_EMBED_SCALE = 127.0
#: the dequantization scale as bf16 holds it (1/127 rounded to bf16), as
#: a Python float: multiplying a bf16 tensor by it rounds once, to bf16
_INV_SCALE_BF16 = float(torch.tensor(1.0 / INT8_EMBED_SCALE,
                                     dtype=torch.bfloat16))


def score_form(v: torch.Tensor) -> torch.Tensor:
    """Compute-form of stored embeddings: int8 tables dequantize to bf16
    at score time (wire and device memory stay 1 byte/dim), rounding
    ``v * bf16(1/127)`` to bf16 once as the JAX package does; float
    tables pass through."""
    if v.dtype == torch.int8:
        return v.to(torch.bfloat16) * _INV_SCALE_BF16
    return v


def scores(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``score_form(q) @ score_form(d).T`` as float32 sums.

    The JAX package multiplies bf16 operands into float32 sums
    (``preferred_element_type=f32``); ``torch.matmul`` on bf16 would
    round its output to bf16. So bf16 operands are upcast to float32
    first, which is exact (a bf16 value is a float32 value), and the
    product runs in full float32 — TF32 must stay off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default),
    else the float32 operands would be rounded to TF32. The cost: the
    upcast chunk is materialized at 4 bytes/element and the product runs
    on float32 units, not bf16 tensor cores. The two precisions of the
    graph (``"highest"``/``"default"``) therefore compute the same
    thing here; they differ only in the stored dtype that feeds it."""
    return torch.matmul(score_form(q).float(), score_form(d).float().T)


def chunked_corpus_topk(qvec: torch.Tensor, dvec: torch.Tensor,
                        dlive: torch.Tensor, k: int, chunk: int = 8192
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``qvec @ dvec.T`` without materializing the full [Q, D]
    scores matrix: score the corpus one chunk at a time and fold each
    chunk into a running top-k carry (one :func:`topk` per chunk).

    ``dlive`` masks dead corpus slots to NEG. D must be a multiple of the
    chunk (or <= chunk, in which case one pass covers it).
    """
    q = qvec.shape[0]
    d = dvec.shape[0]
    chunk = min(chunk, d)
    if d % chunk:
        raise ValueError(f"corpus size {d} must be a multiple of the "
                         f"scan chunk {chunk}")
    dev = qvec.device
    vals = torch.full((q, k), NEG, dtype=torch.float32, device=dev)
    ids = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    cols = torch.arange(chunk, dtype=torch.int32, device=dev)
    for lo in range(0, d, chunk):
        s = scores(qvec, dvec[lo:lo + chunk])
        s = torch.where(dlive[lo:lo + chunk][None, :], s, NEG)
        cand_vals = torch.cat([vals, s], dim=1)
        cand_ids = torch.cat([ids, (lo + cols).expand(q, chunk)], dim=1)
        vals, sel = topk(cand_vals, k)
        ids = torch.gather(cand_ids, 1, sel.long())
    return vals, ids
