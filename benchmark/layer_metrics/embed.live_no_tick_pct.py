"""``embed.live_no_tick_pct``: the share of the live window's seconds in
which no tick was in flight on the card: 100 x (1 - the union of the
window's ``device_tick`` spans, cut to the window, over its seconds).
At the cell's rate, half the highest the card sustains, it is the
card's headroom in the live window, where the replay's
``embed.tick_idle_pct`` sees only the inside of a tick. A program
without such spans gives nothing."""

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
