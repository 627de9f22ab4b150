"""``knn.live_no_tick_pct``: the share of the live window's seconds in
which no tick was in flight on the card: 100 x (1 - the union of the
window's ``device_tick`` spans, cut to the window, over its seconds). A
``device_tick`` is the program's pair of CUDA events around one tick's
launches, placed on the host clock (``obs.trace.device_events``), so it
counts as in flight the time the card waits inside a tick for the host's
launches: this is not the card's idle share, but the pipeline's
headroom at the cell's rate, which shorter ticks raise (the card's or
the host's side). ``knn.tick_idle_pct`` reads the idle time inside the
replayed ticks. A program without such spans gives nothing."""

from reflow_tpu_torch.obs import trace


def read(run):
    device_events = getattr(trace, "device_events", None)
    if device_events is None:
        return None
    a, b = run.t0, run.t0 + run.seconds
    spans = sorted((max(ev[1], a), min(ev[1] + ev[2], b))
                   for _track, ev in device_events()
                   if ev[0] == "device_tick" and ev[1] < b
                   and ev[1] + ev[2] > a)
    if not spans:
        return None
    busy, reach = 0.0, a
    for s, e in spans:
        s = max(s, reach)
        if e > s:
            busy += e - s
            reach = e
    return 100.0 * (1.0 - busy / run.seconds)
