"""The yardstick of the kernels: bytes and operations a launch needs, and
the card's peaks.

A frozen copy of the port's arithmetic for its top-k kernel (the least
time of a launch), and the count of the corpus scan's scoring kernel,
kept here so that the yardstick does not move when the program does.
Each input byte is counted read once and each output byte written once,
whatever the kernel reads again.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, the data sheet's dense rates at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989.4e12
F32_OPS_PER_S = 67e12

F32, I32, BF16, I8, BOOL = 4, 4, 2, 1, 1


def topk_bytes(q: int, n: int, k: int) -> int:
    """``topk`` on a float32 ``[q, n]`` scores matrix: the matrix read,
    ``(values f32, ids int32) [q, k]`` written."""
    return q * n * F32 + q * k * (F32 + I32)


def topk_merge_bytes(q: int, n: int, k: int) -> int:
    """``topk_merge``, one step of the corpus scan: the ``[q, k]`` carry
    (values and ids) and a float32 ``[q, n]`` chunk of scores with its
    ``[n]`` live mask read, the new ``[q, k]`` carry written."""
    return (q * k * (F32 + I32) + q * n * F32 + n * BOOL
            + q * k * (F32 + I32))


def scan_score_bytes(q: int, dim: int, n: int) -> int:
    """``scan_scores``, the scoring of one chunk of the corpus scan: the
    int8 ``[n, dim]`` chunk and the bfloat16 ``[q, dim]`` queries read,
    the float32 ``[q, n]`` scores written. Its operations are
    ``score_ops(q, dim, n)``, at the bfloat16 peak."""
    return n * dim * I8 + q * dim * BF16 + q * n * F32


def topk_ops(q: int, n: int) -> int:
    """Comparisons: one a candidate (the selection reads every candidate
    once; a bound on operations far below the bytes' bound)."""
    return q * n


def least_seconds(nbytes: int, ops: int,
                  ops_per_s: float = F32_OPS_PER_S) -> float:
    """The least time the card allows a launch: the larger of its bytes
    over the memory rate and its operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def score_ops(q: int, dim: int, docs: int) -> int:
    """Multiply-adds of scoring ``docs`` documents for ``q`` queries, two
    operations each."""
    return 2 * q * dim * docs
