"""``embed.execute_ms_p50``: the median over the window's writes of the
``execute`` ticket stage (the scheduler's dispatch of the write's
window: the slot writes' upload, the lowerings and the ViT's launches;
the card runs on after it returns)."""

from benchmark.layer_metrics._common import percentile, stage_ms


def read(run):
    return percentile(stage_ms(run, "execute"), 50)
