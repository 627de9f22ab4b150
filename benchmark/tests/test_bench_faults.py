"""Runs of each cell with the timed path broken underneath come out not
correct: a window whose steps leave the state unchanged, half of each
write left out, an answer altered where it is produced. (No cell spans
chips, so no exchange between chips can be left out.)"""

import time

import numpy as np
import pytest

from reflow_tpu_torch.serve.tickets import APPLIED, Ticket, TicketResult

from benchmark.tests import _tiny

BENCH = _tiny.bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _stale(dep, phase, out):
    """The window's writes are acknowledged APPLIED and never reach the
    scheduler: every step returns the state unchanged."""
    if phase == "setup":
        real = dep.submit

        def submit(ph, i, batch_id):
            if ph == "warm":
                return real(ph, i, batch_id)
            dep.batch(ph, i)
            time.sleep(0.02)  # the step takes its time and does nothing
            t = Ticket(batch_id)
            t._resolve(TicketResult(APPLIED, batch_id, tick=0))
            return t
        dep.submit = submit
    return out


def _half(dep, phase, out):
    """Each window write reaches the program with half its rows."""
    if phase == "setup":
        real = dep.fe.submit

        def submit(source, batch, **kw):
            if str(kw.get("batch_id", "")).startswith("window") \
                    and len(batch) > 1:
                batch = type(batch)(batch.keys[::2], batch.values[::2],
                                    batch.weights[::2])
            return real(source, batch, **kw)
        dep.fe.submit = submit
    return out


def _alter(dep, phase, out):
    """One answer altered where it is produced: a query's best document
    swapped for another id, or one node's rank moved."""
    if phase != "output":
        return out
    if isinstance(out, np.ndarray):
        out = out.copy()
        out[int(np.argmax(out))] *= 1.01
        return out
    out = dict(out)
    row = np.array(out[0], copy=True)
    row[0, 0] = row[-1, 0] + 1 if row[-1, 0] + 1 not in row[:, 0] else 0
    out[0] = row
    return out


@pytest.mark.parametrize("fault", [_stale, _half, _alter],
                         ids=["stale", "half", "alter"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(name, fault):
    r = _tiny.run(BENCH, name, hook=fault)
    assert r["correct"] is False, r["checks"]
