"""``knn.execute_ms_p50``: the median over the window's writes of the
``execute`` ticket stage (the scheduler's dispatch of the write's
window: lowerings, launches and the tick's one readback)."""

from benchmark.layer_metrics._common import percentile, stage_ms


def read(run):
    return percentile(stage_ms(run, "execute"), 50)
