"""``topk_roofline``: the least time the traced ticks' ``topk`` launches
allow, over their device time. An incremental tick's launch needs the
[Q, k + docs] float32 candidates read (the emitted k and the tick's
inserted documents) and [Q, k] written."""

from benchmark import kernel_counts
from benchmark.layer_metrics._common import TOPK


def read(run):
    sl = run.slice
    if sl is None:
        return None
    n, us = sl.kernel_us(*TOPK)
    docs = [sum(i["insert"] for i in infos)
            for infos in sl.tick_infos.values()
            if not any(i["rescan"] for i in infos)]
    if not n or len(docs) != n:
        return None
    cfg = run.cell.cfg
    q, k = int(cfg["queries"]), int(cfg["k"])
    least = sum(kernel_counts.least_seconds(
        kernel_counts.topk_bytes(q, k + d, k), kernel_counts.topk_ops(q, k + d))
        for d in docs)
    return 100.0 * least / (us / 1e6)
