"""``knn.device_trail_ms_p50``: the median over the live window's
dispatches of the end of the dispatch's last ``device_tick`` (the card's
clock, placed on the host's) minus the end of the host's
``device_dispatch`` span. Near 0, the card waits for the host's
launches; large, the host is ahead of the card. A program without
device spans gives nothing."""

import numpy as np

from reflow_tpu_torch.obs import trace


def read(run):
    device_events = getattr(trace, "device_events", None)
    if device_events is None:
        return None
    a, b = run.t0, run.t0 + run.seconds
    ends = {ev[4]["tick"]: ev[1] + ev[2] for _track, ev in device_events()
            if ev[0] == "device_tick"}
    trail = []
    for _track, ev in trace.events():
        if (ev[0] == "device_dispatch" and ev[4] and a <= ev[1]
                and ev[1] + ev[2] <= b and ev[4].get("tick") in ends):
            trail.append((ends[ev[4]["tick"]] - ev[1] - ev[2]) * 1e3)
    return float(np.median(trail)) if trail else None
