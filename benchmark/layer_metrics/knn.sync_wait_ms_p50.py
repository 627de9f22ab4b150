"""``knn.sync_wait_ms_p50``: the median over the live window's ticks of
the ``branch_sync`` span, the host blocked in the tick's one readback
that picks the k-NN path (a rescan or the incremental merge): how long
the host waits for the card inside a dispatch."""

import numpy as np

from reflow_tpu_torch.obs import trace


def read(run):
    a, b = run.t0, run.t0 + run.seconds
    ms = [ev[2] * 1e3 for _track, ev in trace.events()
          if ev[0] == "branch_sync" and a <= ev[1] and ev[1] + ev[2] <= b]
    return float(np.median(ms)) if ms else None
