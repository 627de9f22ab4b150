"""The control (the reference one precision down, in the program's place)
fails the comparison of every cell: at a tiny size on the CPU, and at
the cell's own size on a card (marked ``cuda``; it skips here)."""

import pytest

from benchmark import control, harness
from benchmark.tests import _tiny

BENCH = _tiny.bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
#: writes a closed-loop window sends at the cell's size (a run's count)
CLOSED_WRITES = 300


def _fails(name, got):
    limits = harness.cell(BENCH, name).cfg["checks"]
    return [k for k in limits if got[k] > limits[k]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_tiny_size(name):
    for seed in (5, 2 ** 36 + 1, 77):
        cfg, mix = _tiny.tiny(BENCH, name)
        got = control.readings(BENCH, name, seed, 1.0, "cpu", cfg=cfg,
                               mix=mix)
        assert _fails(name, got), got


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    closed = harness.cell(BENCH, name).mix["loop"] == "closed"
    for seed in (5, 2 ** 36 + 1, 77):
        got = control.readings(BENCH, name, seed,
                               float(BENCH["run_seconds"]), card,
                               writes=CLOSED_WRITES if closed else None)
        assert _fails(name, got), got
