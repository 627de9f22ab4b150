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
matrix would not fit memory: each corpus chunk is scored, then folded
into the running top-k carry by one :func:`topk_merge`. On the card a
chunk of an int8 or bf16 table is scored by :func:`scan_scores`, which
launches ``csrc/scan_score.cu`` (bf16 tensor cores, float32 sums, the
int8 values dequantized inside the kernel); its plain version
:func:`scan_scores_plain` is the float32 product of the upcast operands,
which CPU tensors and float32 tables take.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["topk", "topk_plain", "topk_merge", "topk_merge_plain",
           "chunked_corpus_topk", "scan_scores", "scan_scores_plain",
           "score_form", "scores", "NEG", "INT8_EMBED_SCALE",
           "TOPK_LAUNCHES", "TOPK_MERGE_LAUNCHES", "SCAN_SCORE_LAUNCHES",
           "LAUNCHES_BY_THREAD", "SCAN_SCORE_BY_THREAD"]

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
#: kernel launches made by :func:`scan_scores` (CUDA tensors only; a
#: rescan of an int8 or bf16 table makes one a chunk), reset with the two
#: counts above, and the same by host thread (kept apart from
#: ``LAUNCHES_BY_THREAD``, whose entries stay two)
SCAN_SCORE_LAUNCHES = 0
SCAN_SCORE_BY_THREAD: Dict[int, int] = {}


_TALLY_LOCK = named_lock("kernels.topk.tally")


def _tally(entry: int) -> None:
    """Count one launch of entry 0 (``topk``) or 1 (``topk_merge``).
    Many host threads launch at once (a serving tier's pool threads, a
    replica server's handler, a twin on the main thread), so the counts
    move under a lock."""
    global TOPK_LAUNCHES, TOPK_MERGE_LAUNCHES
    with _TALLY_LOCK:
        if entry == 0:
            TOPK_LAUNCHES += 1
        else:
            TOPK_MERGE_LAUNCHES += 1
        LAUNCHES_BY_THREAD.setdefault(threading.get_ident(),
                                      [0, 0])[entry] += 1


def _tally_scan() -> None:
    """Count one launch of the scoring kernel, as :func:`_tally` does."""
    global SCAN_SCORE_LAUNCHES
    with _TALLY_LOCK:
        SCAN_SCORE_LAUNCHES += 1
        ident = threading.get_ident()
        SCAN_SCORE_BY_THREAD[ident] = SCAN_SCORE_BY_THREAD.get(ident, 0) + 1

#: the kernels index rows and columns with int32 (a cluster of up to 8
#: blocks per row, each a tile past its segment's end): shapes stay
#: below this
_INT32_ROOM = (1 << 31) - (1 << 16)

_fns = {}
#: each C entry's source (``csrc/<name>.cu``)
_SOURCE = {"reflow_topk_f32": "topk", "reflow_topk_merge_f32": "topk",
           "reflow_scan_score_bf16": "scan_score"}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from reflow_tpu_torch.kernels._build import load

        fn = getattr(load(_SOURCE[name]), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "reflow_topk_f32": [p, p, p, i, i, i, i, p],
            "reflow_topk_merge_f32": [p, p, p, p, i, p, p, i, i, i, i, p],
            "reflow_scan_score_bf16": [p, p, i, p, i, i, i, i, p],
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
    upcast operands are materialized at 4 bytes/element and the product
    runs on float32 units, not bf16 tensor cores; the corpus scan on the
    card therefore scores bf16 forms with :func:`scan_scores`, and this
    product stays for the incremental merge's few delta docs, for float32
    tables and for CPU tensors. The two precisions of the graph
    (``"highest"``/``"default"``) compute the same thing here; they
    differ only in the stored dtype that feeds it."""
    return torch.matmul(score_form(q).float(), score_form(d).float().T)


def scan_scores_plain(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`scan_scores`: :func:`scores`, the
    float32 product of the upcast operands."""
    return scores(q, d)


def _scan_kernel_takes(q: torch.Tensor, d: torch.Tensor) -> bool:
    """Whether the scoring kernel computes ``scores(q, d)``: bf16
    queries (a compute form) and an int8 or bf16 doc table."""
    return (q.dtype == torch.bfloat16
            and d.dtype in (torch.int8, torch.bfloat16))


def _check_scan(q: torch.Tensor, d: torch.Tensor, out: torch.Tensor
                ) -> None:
    """Raise unless the scoring kernel takes ``q``, ``d`` and ``out`` (CUDA
    tensors): shapes, dtypes, one device, contiguity, alignment."""
    if q.dim() != 2 or d.dim() != 2 or q.shape[1] != d.shape[1]:
        raise ValueError(f"scan_scores takes q [Q, dim] and d [n, dim], "
                         f"got {tuple(q.shape)} and {tuple(d.shape)}")
    if not _scan_kernel_takes(q, d) or out.dtype != torch.float32:
        raise TypeError(f"the scoring kernel takes bf16 queries, int8 or "
                        f"bf16 docs and a float32 out, got {q.dtype}, "
                        f"{d.dtype}, {out.dtype}")
    nq, dim = q.shape
    nd = d.shape[0]
    if tuple(out.shape) != (nq, nd):
        raise ValueError(f"scan_scores' out must be [{nq}, {nd}], got "
                         f"{tuple(out.shape)}")
    if any(t.device != q.device for t in (d, out)):
        raise ValueError("scan_scores' tensors must share one device")
    if not all(t.is_contiguous() for t in (q, d, out)):
        raise ValueError("scan_scores needs contiguous tensors on cuda")
    per_chunk = 16 if d.dtype == torch.int8 else 8
    if (dim < 1 or dim % per_chunk or q.data_ptr() % 16
            or d.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError(f"the scoring kernel needs dim a positive "
                         f"multiple of {per_chunk} ({d.dtype} docs) and "
                         f"16-byte aligned tables, got dim {dim}")
    if nq < 1 or nd < 1 or nd > 128 * 65535:
        # a block scores 128 docs; the grid's second extent is below 2^16
        raise ValueError(f"scan_scores shape {nq}x{nd} out of the "
                         f"kernel's range")


def _launch_scan(q: torch.Tensor, d: torch.Tensor, lo: int, n: int,
                 out: torch.Tensor, stream: int) -> torch.Tensor:
    """Launch the scoring kernel for doc rows ``[lo, lo + n)`` of ``d``
    on checked CUDA tensors, writing ``out [Q, n]``."""
    dim = q.shape[1]
    err = _kernel("reflow_scan_score_bf16")(
        q.data_ptr(), d.data_ptr() + lo * dim * d.element_size(),
        int(d.dtype == torch.int8), out.data_ptr(), q.shape[0], n, dim,
        q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"scoring kernel launch failed: cudaError {err} "
                           f"(queries {tuple(q.shape)}, docs {lo}:{lo + n})")
    _tally_scan()
    return out


def scan_scores(q: torch.Tensor, d: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[Q, n]`` float32 scores of bf16 queries ``q [Q, dim]`` against
    docs ``d [n, dim]``: int8 rows dequantized as :func:`score_form` does,
    or bf16 rows, multiplied in bf16 into float32 sums. A CPU tensor runs
    :func:`scan_scores_plain`; a CUDA tensor launches the kernel on the
    current stream (into ``out`` when given), or raises. The kernel sums
    in another order than the plain version: a few float32 ulps apart."""
    if q.device.type == "cpu" and d.device.type == "cpu":
        s = scan_scores_plain(q, d)
        return s if out is None else out.copy_(s)
    if out is None:
        out = torch.empty((q.shape[0], d.shape[0]), dtype=torch.float32,
                          device=q.device)
    _check_scan(q, d, out)
    if q.device.type != "cuda":
        raise ValueError(f"scan_scores runs on cpu or cuda, not {q.device}")
    return _launch_scan(q, d, 0, d.shape[0], out,
                        torch.cuda.current_stream(q.device).cuda_stream)


def chunked_corpus_topk(qvec: torch.Tensor, dvec: torch.Tensor,
                        dlive: torch.Tensor, k: int, chunk: int = 8192
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``qvec @ dvec.T`` without materializing the full [Q, D]
    scores matrix: score the corpus one chunk at a time and fold each
    chunk into a running top-k carry (one :func:`topk_merge` per chunk,
    which reads the carry, the chunk's scores and its slice of ``dlive``
    in place; dead slots count as NEG).

    On the card, when both compute forms are bf16 (int8 or bf16 tables),
    a chunk is scored by the scoring kernel into one buffer allocated per
    scan: two launches a chunk. Otherwise (a float32 table, or CPU
    tensors) a chunk is :func:`scan_scores_plain` of the float32 query
    form, hoisted out of the loop.

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
    qs = score_form(qvec)
    if tuple(dlive.shape) != (d,) or not dlive.is_contiguous():
        raise ValueError(f"dlive must be a contiguous [{d}] mask")
    kernel = dev.type == "cuda" and _scan_kernel_takes(qs, dvec)
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev).cuda_stream
        step = functools.partial(_launch_merge, stream=stream)
    else:
        step = topk_merge_plain
    if kernel:
        qs = qs.contiguous()
        s = torch.empty((q, chunk), dtype=torch.float32, device=dev)
        # every chunk is a row range of the same table: the first
        # chunk's check covers them all
        _check_scan(qs, dvec[:chunk], s)
    else:
        # the query operand in its float32 compute form, once per scan
        qf = qs.float()
    for c, lo in enumerate(range(0, d, chunk)):
        if kernel:
            _launch_scan(qs, dvec, lo, chunk, s, stream)
        else:
            s = scan_scores_plain(qf, dvec[lo:lo + chunk])
        if c == 0:
            # every chunk's scores are a contiguous [q, chunk] float32
            # matrix: the first chunk's check covers them all
            _check_merge(*bufs[0], s, dlive[:chunk], d - chunk)
        step(*bufs[c % 2], s, dlive[lo:lo + chunk], lo, out=bufs[1 - c % 2])
    return bufs[(d // chunk) % 2]
