"""``embed.forward_pad_pct``: the share of the rows the params Map (the
ViT) forwarded in the replayed ticks that were padding: 100 x (forwarded
- live) / forwarded, from the ``rows`` and ``live`` args of the program's
``map`` spans (``obs/spans.md``) inside the replayed ticks'
``device_dispatch`` spans. The Map runs the ViT over every row of its
input's capacity, a power of two (``executors/device_delta.py``
``bucket_capacity``), so a tick of ~450 delta rows forwards 512. A
program whose ``map`` spans carry no counts gives nothing."""

from reflow_tpu_torch.obs import trace


def read(run):
    sl = run.slice
    if sl is None:
        return None
    evs = [ev for _track, ev in trace.events()]
    ticks = range(sl.tick_a + 1, sl.tick_b + 1)
    spans = [(ev[1], ev[1] + ev[2]) for ev in evs
             if ev[0] == "device_dispatch" and ev[4]
             and ev[4].get("tick") in ticks]
    rows = live = 0
    for ev in evs:
        args = ev[4]
        if (ev[0] == "map" and args and args.get("live") is not None
                and any(a <= ev[1] <= b for a, b in spans)):
            rows += args["rows"]
            live += args["live"]
    return 100.0 * (rows - live) / rows if rows else None
