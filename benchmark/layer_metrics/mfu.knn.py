"""``mfu.knn``: the scoring operations needed by the ticks of the writes
visible within the window, over
the window's seconds times the card's bf16 dense peak (the precision
the int8 corpus is dequantized to): every live document on a rescan
tick, the inserted ones on an incremental tick, 2 x Q x dim each."""

from benchmark import kernel_counts
from benchmark.layer_metrics._common import knn_tick_ops, ticks


def read(run):
    if run.device_kind == "cpu":
        return None
    by_tick = ticks(run, run.in_window)
    if not by_tick:
        return None
    ops = sum(knn_tick_ops(run.cell.cfg, infos) for infos in by_tick.values())
    return 100.0 * ops / (run.seconds * kernel_counts.BF16_OPS_PER_S)
