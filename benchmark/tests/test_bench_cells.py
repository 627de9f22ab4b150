"""Each cell through the harness at tiny sizes on the CPU: a well-formed
result, correct, with the cell's metrics; and the command refuses a
machine without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.tests import _tiny

BENCH = _tiny.bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, trace):
    r = _tiny.run(BENCH, name, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-2:] == ["checks", "run"]
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 10
    assert r["device"]["platform"] == "cpu"
    json.dumps(r)
    # on the CPU no reader of the device's trace finds anything, nor one
    # of a share of the card's peak
    on_cpu = lambda m: (m["source"] != "device_trace"
                        and not m["name"].startswith("mfu."))
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind]
            if name in m.get("workloads", [name]) and on_cpu(m)}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())
    # every run replays the mix's ticks once the window is over
    replay = r["run"]["replay"]
    assert replay["ticks"] == 3 and replay["rows"] > 0
    assert "busy_s" not in r["device"]
    for k, v in r["checks"].items():
        assert set(v) == {"value", "limit"}


def test_command_refuses_a_machine_without_a_card():
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         CELLS[0], "--seed", str(2 ** 33 + 5), "--seconds", "1",
         "--trace", "0"], cwd=_tiny.ROOT.parent, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


def test_pin_pump_gives_the_pump_a_cpu_of_its_own():
    # in a process of its own: pinning outlives the call
    code = (
        "import os, threading\n"
        "from benchmark import harness\n"
        "cpus = sorted(os.sched_getaffinity(0))\n"
        "ev = threading.Event()\n"
        "t = threading.Thread(target=ev.wait, name=harness.PUMP_THREAD)\n"
        "t.start()\n"
        "harness.pin_pump()\n"
        "print(sorted(os.sched_getaffinity(t.native_id)),\n"
        "      sorted(os.sched_getaffinity(0)), cpus)\n"
        "ev.set()\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=_tiny.ROOT.parent,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    pump, rest, cpus = json.loads("[" + p.stdout.replace("] [", "], [")
                                  + "]")
    if len(cpus) < 2:
        pytest.skip("one CPU: nothing to split")
    assert pump == cpus[:1] and rest == cpus[1:]
