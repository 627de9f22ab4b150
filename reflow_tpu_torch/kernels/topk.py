"""Top-k: the hand-written CUDA kernels and their plain PyTorch versions.

The k-NN workload's hot op is a row-wise top-k over a float32 scores
matrix. On a CUDA tensor :func:`topk` launches ``csrc/topk.cu``, which
replaces the TPU kernel ``reflow_tpu/kernels/topk.py::_topk_kernel``: each
row is split over a cluster of thread blocks that each keep the
candidates at or above a threshold taken from lane maxima, rank those few
survivors, and merge their lists through distributed shared memory (the
source's note gives the design). On a CPU tensor it runs
:func:`topk_plain`, a stable descending sort. Both return distinct
columns, larger value first and the lower column on equal values, so
they agree exactly on every input.

:func:`topk_merge` is one step of the corpus scan, the same kernel
reading its candidates in place: a running (values, ids) carry, then one
chunk of scores masked by a live mask. :func:`topk_merge_plain` builds
the concatenation it stands for.

``chunked_corpus_topk`` is the streaming form for corpora whose scores
matrix would not fit memory: one ``torch.matmul`` per corpus chunk,
folded into the running top-k carry by one :func:`topk_merge` each.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["topk", "topk_plain", "topk_merge", "topk_merge_plain",
           "chunked_corpus_topk", "score_form", "scores", "NEG",
           "INT8_EMBED_SCALE", "TOPK_LAUNCHES", "TOPK_MERGE_LAUNCHES",
           "LAUNCHES_BY_THREAD"]

#: sentinel for "no candidate" — finite so arithmetic/compares stay clean
NEG = float(np.finfo(np.float32).min)

#: kernel launches made by :func:`topk` and by :func:`topk_merge` (CUDA
#: tensors only); a run resets them to 0 and reads them back to show its
#: path went through the kernels
TOPK_LAUNCHES = 0
TOPK_MERGE_LAUNCHES = 0
#: the same launches by the host thread that made them:
#: ``threading.get_ident()`` -> [topk, topk_merge] (a replica's replay on
#: the shipper's thread is told apart from its leader's pump); cleared
#: with the two counts above
LAUNCHES_BY_THREAD: Dict[int, List[int]] = {}


def _tally(entry: int) -> None:
    LAUNCHES_BY_THREAD.setdefault(threading.get_ident(), [0, 0])[entry] += 1

#: the kernels index rows and columns with int32 (a cluster of up to 8
#: blocks per row, each a tile past its segment's end): shapes stay
#: below this
_INT32_ROOM = (1 << 31) - (1 << 16)

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from reflow_tpu_torch.kernels._build import load

        fn = getattr(load("topk"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "reflow_topk_f32": [p, p, p, i, i, i, i, p],
            "reflow_topk_merge_f32": [p, p, p, p, i, p, p, i, i, i, i, p],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


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
    if 8 * q >= _INT32_ROOM or n >= _INT32_ROOM:
        raise ValueError(f"topk shape {tuple(scores.shape)} exceeds int32")
    vals = torch.empty((q, k), dtype=torch.float32, device=scores.device)
    ids = torch.empty((q, k), dtype=torch.int32, device=scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = _kernel("reflow_topk_f32")(
        scores.data_ptr(), vals.data_ptr(), ids.data_ptr(), q, n, k,
        scores.device.index, stream)
    if err != 0:
        raise RuntimeError(f"top-k kernel launch failed: cudaError {err} "
                           f"(shape {q}x{n}, k={k})")
    TOPK_LAUNCHES += 1
    _tally(0)
    return vals, ids


def topk_merge_plain(carry_vals: torch.Tensor, carry_ids: torch.Tensor,
                     scores: torch.Tensor, live: torch.Tensor, lo: int,
                     out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scan step by plain ops: the top k of the carry ``[Q, k]``
    followed by ``scores [Q, n]`` masked to NEG where ``live [n]`` is
    False, with ids ``carry_ids`` then ``lo + j``; ties to the earlier
    candidate. Written into ``out`` when given."""
    q, k = carry_vals.shape
    n = scores.shape[1]
    s = torch.where(live[None, :], scores, NEG)
    cols = torch.arange(n, dtype=torch.int32, device=scores.device)
    vals, sel = topk_plain(torch.cat([carry_vals, s], dim=1), k)
    ids = torch.gather(torch.cat([carry_ids, (lo + cols).expand(q, n)],
                                 dim=1), 1, sel.long())
    if out is None:
        return vals, ids
    out[0].copy_(vals)
    out[1].copy_(ids)
    return out


def _check_merge(carry_vals, carry_ids, scores, live, lo) -> None:
    if carry_vals.dim() != 2 or scores.dim() != 2 or live.dim() != 1:
        raise ValueError("topk_merge takes carry [Q, k], scores [Q, n] and "
                         "live [n]")
    q, k = carry_vals.shape
    n = scores.shape[1]
    if (tuple(carry_ids.shape) != (q, k) or scores.shape[0] != q
            or live.shape[0] != n or k < 1):
        raise ValueError(
            f"topk_merge shapes: carry {tuple(carry_vals.shape)} / "
            f"{tuple(carry_ids.shape)}, scores {tuple(scores.shape)}, live "
            f"{tuple(live.shape)}")
    if (carry_vals.dtype != torch.float32 or scores.dtype != torch.float32
            or carry_ids.dtype != torch.int32 or live.dtype != torch.bool):
        raise TypeError("topk_merge takes float32 values, int32 ids and a "
                        "bool live mask")
    dev = scores.device
    if any(t.device != dev for t in (carry_vals, carry_ids, live)):
        raise ValueError("topk_merge's tensors must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_merge runs on cpu or cuda, not {dev}")
    if dev.type == "cuda":
        if not all(t.is_contiguous()
                   for t in (carry_vals, carry_ids, scores, live)):
            raise ValueError("topk_merge needs contiguous tensors on cuda")
        if 8 * q >= _INT32_ROOM or not 0 <= lo <= _INT32_ROOM - n - k:
            raise ValueError(f"topk_merge shape {q}x{n}, lo={lo} exceeds "
                             f"int32")


def _launch_merge(carry_vals, carry_ids, scores, live, lo, out, stream):
    """Launch the merge kernel on checked CUDA tensors, writing ``out``
    (which must alias no input)."""
    global TOPK_MERGE_LAUNCHES
    q, k = carry_vals.shape
    n = scores.shape[1]
    vals, ids = out
    err = _kernel("reflow_topk_merge_f32")(
        carry_vals.data_ptr(), carry_ids.data_ptr(), scores.data_ptr(),
        live.data_ptr(), lo, vals.data_ptr(), ids.data_ptr(), q, n, k,
        scores.device.index, stream)
    if err != 0:
        raise RuntimeError(f"top-k merge kernel launch failed: cudaError "
                           f"{err} (carry {q}x{k}, chunk {n})")
    TOPK_MERGE_LAUNCHES += 1
    _tally(1)
    return out


def topk_merge(carry_vals: torch.Tensor, carry_ids: torch.Tensor,
               scores: torch.Tensor, live: torch.Tensor, lo: int,
               out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of the carry ``(carry_vals f32, carry_ids int32) [Q, k]``
    followed by chunk column j of ``scores [Q, n]`` (value ``scores[:,
    j]`` if ``live[j]`` else NEG, id ``lo + j``), ties to the earlier
    candidate: exactly :func:`topk_merge_plain`. A CPU tensor runs that
    plain version; a CUDA tensor launches the merge kernel on the current
    stream, reading the candidates in place, or raises. The result goes
    into ``out = (vals, ids)`` when given (on CUDA it must alias no
    input), else into new tensors."""
    _check_merge(carry_vals, carry_ids, scores, live, lo)
    if scores.device.type == "cpu":
        return topk_merge_plain(carry_vals, carry_ids, scores, live, lo, out)
    if out is None:
        out = (torch.empty_like(carry_vals), torch.empty_like(carry_ids))
    elif (tuple(out[0].shape) != tuple(carry_vals.shape)
          or tuple(out[1].shape) != tuple(carry_ids.shape)
          or out[0].dtype != torch.float32 or out[1].dtype != torch.int32
          or not (out[0].is_contiguous() and out[1].is_contiguous())):
        raise ValueError("topk_merge's out must be contiguous (float32, "
                         "int32) tensors of the carry's shape")
    elif {o.data_ptr() for o in out} & {
            t.data_ptr() for t in (carry_vals, carry_ids, scores, live)}:
        raise ValueError("topk_merge's out must not alias its inputs")
    return _launch_merge(carry_vals, carry_ids, scores, live, lo, out,
                         torch.cuda.current_stream(scores.device).cuda_stream)


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
    chunk into a running top-k carry (one :func:`topk_merge` per chunk,
    which reads the carry, the chunk's scores and its slice of ``dlive``
    in place; dead slots count as NEG).

    The carry is updated in place: two (values, ids) buffers allocated
    once per scan take turns as a step's input and its ``out``. Shapes
    are checked once per scan, not per chunk. D must be a multiple of
    the chunk (or <= chunk, in which case one pass covers it).
    """
    q = qvec.shape[0]
    d = dvec.shape[0]
    chunk = min(chunk, d)
    if d % chunk:
        raise ValueError(f"corpus size {d} must be a multiple of the "
                         f"scan chunk {chunk}")
    dev = qvec.device
    bufs = [(torch.full((q, k), NEG, dtype=torch.float32, device=dev),
             torch.full((q, k), -1, dtype=torch.int32, device=dev)),
            (torch.empty((q, k), dtype=torch.float32, device=dev),
             torch.empty((q, k), dtype=torch.int32, device=dev))]
    # the query operand in its float32 compute form, once per scan
    qf = score_form(qvec).float()
    if tuple(dlive.shape) != (d,) or not dlive.is_contiguous():
        raise ValueError(f"dlive must be a contiguous [{d}] mask")
    if dev.type == "cuda":
        step = functools.partial(_launch_merge,
                                 stream=torch.cuda.current_stream(dev)
                                 .cuda_stream)
    else:
        step = topk_merge_plain
    for c, lo in enumerate(range(0, d, chunk)):
        s = torch.matmul(qf, score_form(dvec[lo:lo + chunk]).float().T)
        if c == 0:
            # every chunk's scores are a fresh contiguous [q, chunk]
            # float32 product: the first chunk's check covers them all
            _check_merge(*bufs[0], s, dlive[:chunk], d - chunk)
        step(*bufs[c % 2], s, dlive[lo:lo + chunk], lo, out=bufs[1 - c % 2])
    return bufs[(d // chunk) % 2]
