"""The rows a params Map forwards, and how many of them were live: the
``rows`` and ``live`` args of its ``map`` span (``obs/spans.md``).

A Map with ``params`` (config 5's ViT, here at ``VIT_TINY`` widths on the
``cuda`` executor over CPU tensors) runs its fn over every row of its
input's capacity, weight-0 padding included. While tracing, its span
counts the capacity and the rows of weight != 0, on the per-tick path
(a hand-built device batch with padding between its rows) and on the
window path (host batches written into ``[K, cap]`` slots). On a card
the live count is copied back behind a CUDA event with no sync; its
resolution runs here against stand-in events, and on a card in the
``cuda``-marked test.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu_torch import obs
from reflow_tpu_torch.delta import Spec
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.graph import FlowGraph
from reflow_tpu_torch.models import VIT_TINY, init_vit
from reflow_tpu_torch.obs import trace
from reflow_tpu_torch.workloads import image_embed as pie

N_IMG, N_GRP = 256, 4


@pytest.fixture(autouse=True)
def _clean_trace():
    obs.disable()
    trace.reset()
    yield
    obs.disable()
    trace.reset()


@pytest.fixture(scope="module")
def params():
    return init_vit(0, **VIT_TINY, device="cpu")


def _embed(params, device="cpu"):
    ig = pie.build_graph(N_IMG, N_GRP, params)
    return ig, P.DirtyScheduler(ig.graph, P.get_executor("cuda",
                                                         device=device))


def _rows(n, rng, device="cpu"):
    flat = VIT_TINY["img"] ** 2 * VIT_TINY["chans"]
    v = rng.integers(0, 256, (n, 1 + flat), dtype=np.uint8)
    v[:, 0] = rng.integers(0, N_GRP, n)
    return torch.from_numpy(v).to(device)


def _padded(rng, cap, live_at, device="cpu"):
    """A hand-built device batch of ``cap`` rows, live (weight 1) only at
    ``live_at``: the rest weight-0 padding with pixels of their own."""
    w = torch.zeros(cap, dtype=torch.int32)
    w[list(live_at)] = 1
    keys = torch.arange(cap, dtype=torch.int32)
    return DeviceDelta(keys.to(device), _rows(cap, rng, device),
                       w.to(device))


def _maps():
    return [ev[4] for _t, ev in trace.events() if ev[0] == "map"]


def test_per_tick_map_counts_capacity_and_live_rows(params):
    rng = np.random.default_rng(1)
    ig, sched = _embed(params)
    obs.enable()
    live = [0, 3, 4, 17, 40, 63]
    sched.push(ig.images, _padded(rng, 64, live))
    sched.tick()
    sched.push(ig.images, _padded(rng, 128, range(0, 128, 3)))
    sched.tick()
    assert _maps() == [{"rows": 64, "live": len(live)},
                       {"rows": 128, "live": len(range(0, 128, 3))}]


def test_window_map_counts_each_slot(params):
    rng = np.random.default_rng(2)
    ig, sched = _embed(params)
    obs.enable()
    batches = []
    for n, ids in ((70, np.arange(70)), (5, np.arange(100, 105))):
        batches.append(P.DeltaBatch(ids, _rows(n, rng).numpy(),
                                    np.ones(n, np.int64)))
    sched.tick_many([{ig.images: b} for b in batches])
    assert sched.megatick_windows == 1
    # one slot capacity for the window's ticks: the largest batch's
    # bucket
    assert _maps() == [{"rows": 128, "live": 70}, {"rows": 128, "live": 5}]
    # a retraction beside an insert: both live
    back = P.DeltaBatch(np.array([3, 3]), np.concatenate(
        [batches[0].values[3:4], batches[0].values[3:4]]),
        np.array([-1, 1]))
    sched.tick_many([{ig.images: back}])
    assert _maps()[-1] == {"rows": 64, "live": 2}


def test_only_params_maps_count_and_only_while_tracing(params):
    rng = np.random.default_rng(3)
    g = FlowGraph("plain")
    src = g.source("v", Spec((4,), np.float32, key_space=64))
    g.reduce(g.map(src, lambda v: v * 2, vectorized=True,
                   spec=Spec((4,), np.float32, key_space=64)), "sum")
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    obs.enable()
    sched.push(src, P.DeltaBatch(np.arange(5), rng.standard_normal(
        (5, 4)).astype(np.float32), np.ones(5, np.int64)))
    sched.tick()
    assert _maps() == [None]
    obs.disable()
    trace.reset()
    ig, sched = _embed(params)
    sched.push(ig.images, _padded(rng, 64, [1, 2]))
    sched.tick()
    assert trace.events() == [] and len(trace._counts_pending) == 0


class _Event:
    """A stand-in CUDA event, complete once ``done`` is set or once
    waited on."""

    def __init__(self):
        self.done = False
        self.waits = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True


def test_counts_on_a_card_resolve_in_order_without_a_wait(monkeypatch):
    monkeypatch.setattr(trace, "_counts_pending", deque())
    obs.enable()
    spans, evs = [], []
    for live in (5, 7, 9):
        args, ev = {"rows": 64, "live": None}, _Event()
        trace._counts_pending.append((args, torch.tensor(live), ev))
        spans.append(args)
        evs.append(ev)
    evs[1].done = True
    trace.device_resolve()  # as a window's retire does: no wait
    assert [a["live"] for a in spans] == [None, None, None]
    evs[0].done = True
    trace.device_resolve()
    assert [a["live"] for a in spans] == [5, 7, None]
    assert not any(e.waits for e in evs)
    # a reader waits for the rest
    trace.events()
    assert [a["live"] for a in spans] == [5, 7, 9] and evs[2].waits == 1
    assert len(trace._counts_pending) == 0


def test_reset_drops_counts_still_on_the_card(monkeypatch):
    monkeypatch.setattr(trace, "_counts_pending", deque())
    trace._counts_pending.append(({"live": None}, torch.tensor(1),
                                  _Event()))
    trace.reset()
    assert len(trace._counts_pending) == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_map_counts_on_the_card(card):
    rng = np.random.default_rng(4)
    cparams = init_vit(0, **VIT_TINY, device=card)
    ig, sched = _embed(cparams, card)
    obs.enable()
    live = [0, 5, 6, 60]
    for _ in range(3):
        sched.push(ig.images, _padded(rng, 64, live, card))
        sched.tick()
    # counted on the card, filled in once read: no sync on the tick
    assert _maps() == [{"rows": 64, "live": 4}] * 3
    assert len(trace._counts_pending) == 0
