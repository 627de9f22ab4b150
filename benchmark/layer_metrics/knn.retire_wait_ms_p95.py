"""``knn.retire_wait_ms_p95``: the 95th percentile over the live window's
windows of the frontend's ``retire_wait`` span, from a window's dispatch
end to the start of its retire. With the pipelined pump, window N
retires (and its writes turn APPLIED) only once window N+1 has been
staged and dispatched, or the pump has gone idle."""

import numpy as np

from reflow_tpu_torch.obs import trace


def read(run):
    a, b = run.t0, run.t0 + run.seconds
    ms = [ev[2] * 1e3 for _track, ev in trace.events()
          if ev[0] == "retire_wait" and a <= ev[1] and ev[1] + ev[2] <= b]
    return float(np.percentile(np.asarray(ms), 95)) if ms else None
