"""``pagerank.passes_per_tick``: the fused loop's passes a tick, over the
window's ticks (the scheduler's TickResults)."""


def read(run):
    return run.passes / run.ticks if run.ticks else None
