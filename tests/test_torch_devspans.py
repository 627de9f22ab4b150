"""The port's dispatch spans and device-clock spans (``obs.trace``), on
the CPU, with the card's part on a card.

A k-NN frontend on the ``cuda`` executor over CPU tensors records the
tick's handoffs (``branch_sync``, ``knn_fold``, ``knn_rescan`` or
``knn_merge``, ``knn_emit``) inside its window's dispatch, and one
``retire_wait`` a dispatched window. The device spans' machinery (the
event pool, the lazy resolution, the clock anchor, the export) runs on
the CPU against host-clock stand-ins for CUDA's events; on a card the
``cuda``-marked tests hold the real spans to the ticks' order and to the
host's dispatch.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu_torch import obs
from reflow_tpu_torch.analysis import run as lint_run
from reflow_tpu_torch.executors.cuda import CudaExecutor
from reflow_tpu_torch.obs import trace
from reflow_tpu_torch.serve import CoalesceWindow, IngestFrontend
from reflow_tpu_torch.workloads import knn

Q, D, DIM, K = 4, 128, 8, 3
#: the handoff spans a k-NN tick records, beside its path's own
KNN_SPANS = ("branch_sync", "knn_fold", "knn_emit")


@pytest.fixture(autouse=True)
def _clean_trace():
    obs.disable()
    trace.reset()
    yield
    obs.disable()
    trace.reset()


def _vecs(rng, n):
    return rng.standard_normal((n, DIM)).astype(np.float32)


def _batch(keys, vals, w=1):
    keys = np.asarray(keys, np.int64)
    return P.DeltaBatch(keys, vals, np.full(len(keys), w, np.int64))


def _writes(kind, rng, n):
    """``n`` writes of 4 rows and one kind over a corpus holding ids
    0..D/2-1: fresh inserts (the incremental path) or re-embeds of live
    ids (a rescan)."""
    if kind == "insert":
        ids = [[D // 2 + 4 * i + j for j in range(4)] for i in range(n)]
    else:
        ids = [[2 * i, 2 * i + 1] for i in range(n)]
    out = []
    for ks in ids:
        if kind == "insert":
            out.append(_batch(ks, _vecs(rng, 4)))
        else:
            out.append(P.DeltaBatch.concat([
                _batch(ks, np.zeros((2, DIM), np.float32), -1),
                _batch(ks, _vecs(rng, 2))]))
    return out


def _loaded(device="cpu"):
    """A k-NN scheduler on the cuda executor with its queries and half
    the corpus in."""
    rng = np.random.default_rng(3)
    kg = knn.build_graph(Q, D, DIM, K, scan_chunk=D)
    sched = P.DirtyScheduler(kg.graph, P.get_executor("cuda", device=device))
    sched.push(kg.queries, _batch(range(Q), _vecs(rng, Q)))
    sched.push(kg.docs, _batch(range(D // 2), _vecs(rng, D // 2)))
    sched.tick()
    return kg, sched, rng


def _run_pump_once(fe):
    """One pump iteration in this thread: the whole backlog as windows
    of ``max_ticks`` ticks, pipelined up to ``depth``."""
    with fe._lock:
        drained = fe._take_window()
    fe._run_window(drained)
    with fe._lock:
        fe._finish_window()


def _serve(kind, depth, n=6, traced=True):
    """``n`` writes of ``kind`` through a paused frontend, run as one pump
    iteration (windows of 2 ticks, a write a tick). Returns the
    scheduler and the buffered host spans by name."""
    kg, sched, rng = _loaded()
    fe = IngestFrontend(sched, start=False, depth=depth,
                        window=CoalesceWindow(max_rows=4, max_ticks=2,
                                              max_latency_s=0.001))
    writes = _writes(kind, rng, n)
    if traced:
        trace.enable()
    try:
        tickets = [fe.submit(kg.docs, b) for b in writes]
        _run_pump_once(fe)
        assert all(t.result(timeout=10).applied for t in tickets)
    finally:
        fe.close()
    by = {}
    for track, ev in trace.events():
        by.setdefault(ev[0], []).append((track, ev))
    return sched, by


def _inside(inner, outer):
    return (inner[1] >= outer[1]
            and inner[1] + inner[2] <= outer[1] + outer[2] + 1e-9)


# -- the dispatch's handoffs --------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kind,path", [("insert", "knn_merge"),
                                       ("update", "knn_rescan")])
def test_knn_frontend_records_its_handoffs(kind, path, depth):
    sched, by = _serve(kind, depth)
    other = {"knn_merge": "knn_rescan", "knn_rescan": "knn_merge"}[path]
    assert other not in by
    dispatches = [ev for _t, ev in by["device_dispatch"]
                  if ev[4]["kind"] == "window"]
    executes = [ev for _t, ev in by["pump_execute"]]
    assert len(dispatches) == len(executes) == 3
    for name in KNN_SPANS + (path,):
        spans = by[name]
        assert len(spans) == 6, name  # one a tick
        for track, ev in spans:
            assert ev[2] > 0
            assert any(_inside(ev, d) for d in dispatches), name
            assert any(_inside(ev, x) for x in executes), name
            assert track == by["device_dispatch"][0][0]
    # one retire_wait a dispatched window, from its dispatch's end
    waits = sorted((ev for _t, ev in by["retire_wait"]), key=lambda e: e[1])
    assert len(waits) == len(executes)
    ticks = []
    for w, x in zip(waits, sorted(executes, key=lambda e: e[1])):
        assert w[1] == pytest.approx(x[1] + x[2], abs=1e-9)
        assert w[2] >= 0
        a = w[4]
        assert a["ticks"] == 2 and a["last"] == a["first"] + 1
        ticks += [a["first"], a["last"]]
    assert ticks == list(range(sched._tick - 5, sched._tick + 1))
    # the window's dispatch names its last tick, and a tick_launch a turn
    # of its K loop holds each tick's lowering spans
    assert sorted(d[4]["tick"] for d in dispatches) == ticks[1::2]
    launches = [ev for _t, ev in by["tick_launch"]]
    assert sorted(ev[4]["tick"] for ev in launches) == ticks
    for name in KNN_SPANS + (path,):
        for _t, ev in by[name]:
            assert any(_inside(ev, x) for x in launches), name
    for x in launches:
        assert any(_inside(x, d) for d in dispatches)
    assert (len(by["tick_plan"]) == len(by["queue_stage"])
            == len(by["queue_retire"]) == len(by["tick_result"]) == 3)


@pytest.mark.parametrize("kind", ["insert", "update"])
def test_host_syncs_a_tick_are_the_same_traced_or_not(kind):
    def syncs(traced):
        kg, sched, rng = _loaded()
        if traced:
            trace.enable()
        out = []
        for b in _writes(kind, rng, 4):
            s0 = sched.executor.host_syncs
            sched.tick_many([{kg.docs: b}])
            out.append(sched.executor.host_syncs - s0)
        obs.disable()
        return out, len(trace.events())

    off, n_off = syncs(False)
    on, n_on = syncs(True)
    assert off == on == [1, 1, 1, 1]
    assert n_off == 0 and n_on > 0


def test_device_events_are_empty_on_the_cpu_and_after_reset():
    _serve("update", 2)
    assert trace.events() and trace.device_events() == []
    trace.reset()
    assert trace.events() == [] and trace.device_events() == []


# -- device spans against stand-ins for CUDA's events -------------------------

class _Card:
    """Host-clock stand-ins for ``torch.cuda``'s events, streams and
    ``synchronize``, counting what is made and waited on. With ``lazy``
    an event is done only once it was waited on; ``held`` notes, for
    each wait on an event, whether the device spans' lock was held."""

    def __init__(self):
        self.made = 0
        self.syncs = 0
        self.lazy = False
        self.held = []
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                card.made += 1
                self.t = None
                self.done = False

            def record(self, stream=None):
                self.t = time.perf_counter()
                self.done = not card.lazy

            def query(self):
                return self.done

            def synchronize(self):
                card.held.append(trace._dev_lock.locked())
                self.done = True

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e3

        self.Event = Event

    def synchronize(self, device=None):
        self.syncs += 1


@pytest.fixture
def card(monkeypatch):
    """The cuda executor on the CPU treats its device as a card whose
    events are :class:`_Card`'s; the trace module's device state is this
    test's own."""
    c = _Card()
    monkeypatch.setattr(torch.cuda, "Event", c.Event)
    monkeypatch.setattr(torch.cuda, "synchronize", c.synchronize)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    monkeypatch.setattr(CudaExecutor, "_on_card", lambda self: True)
    for name, fresh in (("_dev_pool", {}), ("_dev_pending", deque()),
                        ("_anchors", {}), ("_dev_known", {}),
                        ("_dev_ring", None)):
        monkeypatch.setattr(trace, name, fresh)
    yield c
    obs.disable()
    trace.reset()


def test_tracing_off_records_nothing_and_makes_no_event(card):
    _sched, by = _serve("update", 2, traced=False)
    assert by == {} and trace.events() == []
    assert trace.device_events() == []
    assert card.made == 0 and card.syncs == 0


def test_device_ticks_in_order_pooled_and_resolved_at_retire(card):
    sched, by = _serve("insert", 2, n=12)
    # every pair was resolved when its window retired
    assert len(trace._dev_pending) == 0
    devs = trace.device_events()
    assert [t for t, _ev in devs] == ["device/cpu"] * 12
    ticks = [ev[4]["tick"] for _t, ev in devs]
    assert ticks == list(range(sched._tick - 11, sched._tick + 1))
    starts = [ev[1] for _t, ev in devs]
    assert starts == sorted(starts)
    for (_t, a), (_u, b) in zip(devs, devs[1:]):
        assert a[1] + a[2] <= b[1]
    # one anchor (a synchronize, a few events), then pairs from the pool
    assert card.syncs == 1
    assert card.made < trace.ANCHOR_TRIPS + 2 * 12
    dispatches = [ev for _t, ev in by["device_dispatch"]]
    for d in dispatches:
        mine = [ev for _t, ev in devs
                if d[4]["tick"] - d[4]["ticks"] < ev[4]["tick"]
                <= d[4]["tick"]]
        assert len(mine) == 2
        for ev in mine:
            assert _inside(ev, d)
    # kept out of the host spans, written by the exporter
    assert "device_tick" not in {ev[0] for _t, ev in trace.events()}
    chrome = obs.chrome_events()
    tracks = {e["args"]["name"] for e in chrome if e.get("ph") == "M"
              and e["name"] == "thread_name"}
    assert "device/cpu" in tracks
    assert sum(e["name"] == "device_tick" for e in chrome) == 12
    json.dumps(chrome)


def test_reset_drops_device_spans_and_anchors_anew(card):
    _serve("update", 2, n=4)
    assert len(trace.device_events()) == 4 and card.syncs == 1
    trace.enable()
    trace.reset()  # tracing on: the known card is anchored again now
    assert card.syncs == 2
    assert trace.device_events() == []
    obs.disable()
    trace.reset()
    assert card.syncs == 2  # off: no anchor until tracing meets it again


def test_a_waiting_reader_leaves_the_ticks_lock_free(card, monkeypatch):
    """With every tick still on the card, a reader waits on each pair
    outside the lock the pump's ticks take, then resolves them in
    order."""
    monkeypatch.setattr(trace, "_dev_lock", threading.Lock())
    card.lazy = True
    sched, _by = _serve("insert", 2, n=4)
    assert len(trace._dev_pending) == 4  # nothing done at retire
    card.held.clear()
    devs = trace.device_events()
    assert len(card.held) == 4 and not any(card.held)
    assert [ev[4]["tick"] for _t, ev in devs] == list(
        range(sched._tick - 3, sched._tick + 1))


def test_per_tick_passes_resolve_their_backlog(card, monkeypatch):
    monkeypatch.setattr(trace, "PENDING_MAX", 3)
    kg, sched, rng = _loaded()
    trace.enable()
    for b in _writes("insert", rng, 6):
        sched.push(kg.docs, b)
        sched.tick()
    # the per-tick path has no window retire: a backlog past PENDING_MAX
    # resolves at the next tick's end
    assert len(trace._dev_pending) <= 3
    ticks = [ev[4]["tick"] for _t, ev in trace.device_events()]
    assert ticks == list(range(2, 8))
    # a per-tick pass is its device_dispatch, which names its tick: no
    # tick_launch beside it
    names = [ev[0] for _t, ev in trace.events()]
    assert "tick_launch" not in names
    assert sorted(ev[4]["tick"] for _t, ev in trace.events()
                  if ev[0] == "device_dispatch") == ticks


# -- the span catalog ---------------------------------------------------------

@pytest.mark.parametrize("guide,port,want", [
    ("# nothing\n", "# nothing\n", {"fixture_dev", "fixture_block"}),
    ("`fixture_dev` `fixture_block`\n", "# nothing\n", set()),
    ("# nothing\n", "`fixture_block`\n", {"fixture_dev"}),
    ("# nothing\n", None, {"fixture_dev", "fixture_block"}),
    ("`fixture_dev`\n", "`fixture_block`\n", set()),
], ids=["neither", "guide", "port-part", "no-port-file", "both"])
def test_span_blocks_and_device_spans_are_held_to_the_catalogs(
        tmp_path, guide, port, want):
    """``span("...")`` blocks and ``DEVICE_SPANS`` are held to the union
    of the JAX package's catalog and the port's own."""
    src = ("from reflow_tpu_torch.obs.trace import span\n"
           "DEVICE_SPANS = ('fixture_dev',)\n"
           "def f():\n"
           "    with span('fixture_block'):\n"
           "        pass\n"
           "    with span(None, label='x'):\n"
           "        pass\n")
    obs_dir = tmp_path / "reflow_tpu_torch" / "obs"
    obs_dir.mkdir(parents=True)
    (obs_dir / "trace.py").write_text(src)
    if port is not None:
        (obs_dir / "spans.md").write_text(port)
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "guide.md").write_text(guide)
    rep = lint_run(str(tmp_path), passes=["spans"])
    got = {f["msg"].split("`")[1] for f in rep["findings"]}
    assert got == want


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device_tick spans are CUDA "
                    "events on the card's stream")
    return torch.device("cuda")


def _card_ticks(cuda_device, feeds_per_call):
    kg, sched, rng = _loaded(cuda_device)
    trace.enable()
    sched.tick_many([{kg.docs: _writes("insert", rng, 1)[0]}])
    trace.reset()  # tracing on: anchors the card again, off the ticks
    tick0 = sched._tick
    writes = _writes("update", rng, 8)
    for i in range(0, len(writes), feeds_per_call):
        torch.cuda.synchronize(cuda_device)
        sched.tick_many([{kg.docs: b}
                         for b in writes[i:i + feeds_per_call]])
    torch.cuda.synchronize(cuda_device)
    devs = [ev for _t, ev in trace.device_events()]
    disp = [ev for _t, ev in trace.events() if ev[0] == "device_dispatch"]
    return tick0, sched._tick, devs, disp


@pytest.mark.cuda
@pytest.mark.parametrize("per_call", [1, 4], ids=["tick", "window"])
def test_device_ticks_on_the_card(cuda_device, per_call):
    tick0, tick1, devs, disp = _card_ticks(cuda_device, per_call)
    assert [ev[4]["tick"] for ev in devs] == list(range(tick0 + 1,
                                                        tick1 + 1))
    for a, b in zip(devs, devs[1:]):
        assert a[1] + a[2] <= b[1] + 1e-6  # one stream: no overlap
    for ev in devs:
        assert ev[2] > 0
    if per_call == 1:
        # each tick's span starts within 1 ms after its dispatch began
        assert len(disp) == len(devs)
        for d, ev in zip(disp, devs):
            assert d[4]["tick"] == ev[4]["tick"]
            assert -1e-4 <= ev[1] - d[1] <= 1e-3, (ev, d)
