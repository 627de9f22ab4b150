"""``pagerank.pass_ms``: the window's summed ``execute`` stage over its
summed loop passes (one write a tick in a closed loop, so the two sums
cover the same ticks)."""

from benchmark.layer_metrics._common import stage_ms


def read(run):
    ex = stage_ms(run, "execute")
    return sum(ex) / run.passes if run.passes and ex else None
