"""``scan_score_roofline``: the least time the corpus scan's scoring
launches of the traced ticks allow, over their device time. Each launch
reads an int8 [scan_chunk, dim] chunk and the bfloat16 [Q, dim] queries
and writes float32 [Q, scan_chunk] scores; its 2 * Q * dim * scan_chunk
operations run at the bfloat16 peak."""

from benchmark import kernel_counts

#: the profiler's name of the scoring kernel
SCAN_SCORE = "scan_score_kernel"


def read(run):
    sl = run.slice
    if sl is None:
        return None
    n, us = sl.kernel_us(SCAN_SCORE)
    if not n:
        return None
    cfg = run.cell.cfg
    q, dim, c = int(cfg["queries"]), int(cfg["dim"]), int(cfg["scan_chunk"])
    least = kernel_counts.least_seconds(
        kernel_counts.scan_score_bytes(q, dim, c),
        kernel_counts.score_ops(q, dim, c), kernel_counts.BF16_OPS_PER_S)
    return 100.0 * n * least / (us / 1e6)
