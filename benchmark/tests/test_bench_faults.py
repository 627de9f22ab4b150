"""Runs of each cell with the timed path broken underneath come out not
correct: a window whose steps leave the state unchanged, half of each
write left out, an answer altered where it is produced (by the cell's
configuration module's ``alter``). (No cell spans chips, so no exchange
between chips can be left out.)"""

import time

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


#: each fault, as a run's hook for cell ``name``; ``alter`` is the one
#: the cell's configuration module brings for its own output
FAULTS = {"stale": lambda b, name: _stale, "half": lambda b, name: _half,
          "alter": _tiny.altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(name, fault):
    r = _tiny.run(BENCH, name, hook=FAULTS[fault](BENCH, name))
    assert r["correct"] is False, r["checks"]
