"""``topk_merge_roofline``: the least time the corpus scan's merge
launches of the traced ticks allow, over their device time. Each launch
reads a [Q, k] carry, a float32 [Q, scan_chunk] chunk of scores and its
live mask, and writes a [Q, k] carry."""

from benchmark import kernel_counts
from benchmark.layer_metrics._common import TOPK_MERGE


def read(run):
    sl = run.slice
    if sl is None:
        return None
    n, us = sl.kernel_us(*TOPK_MERGE)
    if not n:
        return None
    cfg = run.cell.cfg
    q, k, c = int(cfg["queries"]), int(cfg["k"]), int(cfg["scan_chunk"])
    least = kernel_counts.least_seconds(
        kernel_counts.topk_merge_bytes(q, c, k), kernel_counts.topk_ops(q, c))
    return 100.0 * n * least / (us / 1e6)
