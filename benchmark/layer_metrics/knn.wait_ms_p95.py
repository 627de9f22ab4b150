"""``knn.wait_ms_p95``: the 95th percentile over the window's writes of
the time a write waits in the frontend before its tick starts
(admission + coalesce + scheduling delay), from the program's ticket
stages."""

from benchmark.layer_metrics._common import percentile, stage_ms


def read(run):
    return percentile(stage_ms(run, "admission", "coalesce", "sched_delay"),
                      95)
