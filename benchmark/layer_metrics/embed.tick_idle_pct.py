"""``embed.tick_idle_pct``: the share of the replayed ticks' wall time in
which no kernel or copy ran on the card (the union of the profile's
device intervals). The ticks are driven back to back by the harness
after the window (``harness._replay``), one write each, so the share
counts the idle time inside a tick and none between ticks."""


def read(run):
    sl = run.slice
    if sl is None or not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
