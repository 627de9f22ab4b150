"""The port's observability layer (``reflow_tpu_torch.obs``: the trace
rings, the Chrome-trace exporter, the metrics registry) against
``tests/test_obs.py`` and the JAX package, on the CPU.

Every test of ``tests/test_obs.py`` has a counterpart here: tracing is a
strict no-op while disabled and a correct decomposition while enabled
(every sampled ticket's six stages tile its end-to-end latency), the
exported file is valid trace-event JSON with one track a component, the
registry is JSON-clean under numpy and deque values, degrades on a
failing gauge and unregisters with its publisher, ``percentile`` and the
``to_dict()`` schemas round-trip, and ``profile_trace`` degrades when the
profiler is missing. The port's exported files are read by the JAX
package's tools (``tools/trace_inspect.py``, ``tools/wal_inspect.py``)
and by the JAX ``ticket_timelines``, which must give the port's stages.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

from reflow_tpu.obs import export as jexport
from reflow_tpu_torch import obs
from reflow_tpu_torch.obs import trace as trace_mod
from reflow_tpu_torch.scheduler import DirtyScheduler
from reflow_tpu_torch.serve import (CoalesceWindow, GraphConfig,
                                    IngestFrontend, ServeTier)
from reflow_tpu_torch.utils import metrics as metrics_mod
from reflow_tpu_torch.utils.metrics import (percentile, profile_trace,
                                            summarize_serve, summarize_tier,
                                            summarize_wal)
from reflow_tpu_torch.wal import DurableScheduler
from reflow_tpu_torch.workloads import wordcount

WINDOW = CoalesceWindow(max_rows=256, max_ticks=8, max_latency_s=0.002)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def traced(monkeypatch):
    """Tracing on, every ticket sampled; rings cleared before/after."""
    obs.disable()
    trace_mod.reset()
    monkeypatch.setattr(trace_mod, "SAMPLE_EVERY", 1)
    obs.enable()
    yield
    obs.disable()
    trace_mod.reset()


def lines(*words):
    return wordcount.ingest_lines([" ".join(words)])


def drive_frontend(sched_factory, n=12):
    g, src, _sink = wordcount.build_graph()
    sched = sched_factory(g)
    fe = IngestFrontend(sched, window=WINDOW)
    tickets = [fe.submit(src, lines(f"w{j}", f"w{j % 3}"))
               for j in range(n)]
    for t in tickets:
        assert t.result(timeout=10).applied
    fe.close()
    return fe, sched


def _durable(tmp_path):
    return lambda g: DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                                      fsync="record")


# -- tracing disabled: strict no-op -----------------------------------------

def test_disabled_records_nothing():
    obs.disable()
    trace_mod.reset()
    drive_frontend(DirtyScheduler)
    assert obs.chrome_events() == []
    assert not obs.enabled()


def test_mint_not_called_when_disabled():
    obs.disable()
    trace_mod.reset()
    drive_frontend(DirtyScheduler, n=3)
    assert trace_mod.evt("x", 0.0, 1.0) is None  # evt is a no-op too
    assert obs.chrome_events() == []


# -- ticket stage decomposition ---------------------------------------------

def test_ticket_stages_tile_e2e_exactly(tmp_path, traced):
    drive_frontend(_durable(tmp_path))
    events = obs.chrome_events()
    timelines = obs.ticket_timelines(events)
    assert timelines, "sampling every ticket must yield timelines"
    # the JAX reader decomposes the port's events the same way
    assert jexport.ticket_timelines(events) == timelines
    for tl in timelines.values():
        assert set(tl["stages"]) == set(trace_mod.STAGES)
        assert all(d >= 0.0 for d in tl["stages"].values())
        assert tl["sum_us"] == pytest.approx(tl["e2e_us"], rel=1e-6,
                                             abs=0.01)


def test_export_tracks_and_event_shape(tmp_path, traced):
    drive_frontend(_durable(tmp_path))
    path = str(tmp_path / "trace.json")
    assert obs.export_chrome_trace(path) == path
    with open(path) as f:
        doc = json.load(f)
    assert doc["node"] == obs.node_id() and doc["baseTimeS"] > 0
    evs = doc["traceEvents"]
    tracks = {e["args"]["name"] for e in evs
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert "wal" in tracks
    # the pipelined fsync is recorded on the committer's own timeline
    assert "wal-committer" in tracks
    assert any(t.startswith("ticket/") for t in tracks)
    for e in evs:
        if e.get("ph") == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0 and e["tid"] >= 1
    spans = {e["name"] for e in evs if e.get("ph") == "X"}
    assert {"wal_append", "wal_fsync", "submit", "window"} <= spans


def test_tier_records_pool_pick_and_sched_delay(traced):
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2)
    g, src, _sink = wordcount.build_graph()
    h = tier.register("g0", DirtyScheduler(g), GraphConfig(window=WINDOW))
    tickets = [h.submit(src, lines(f"w{j}")) for j in range(8)]
    for t in tickets:
        assert t.result(timeout=10).applied
    tier.close()
    spans = {e["name"] for e in obs.chrome_events()
             if e.get("ph") == "X"}
    assert "pool_pick" in spans
    timelines = obs.ticket_timelines(obs.chrome_events())
    assert timelines
    for tl in timelines.values():
        assert tl["sum_us"] == pytest.approx(tl["e2e_us"], rel=1e-6,
                                             abs=0.01)


def test_ring_overflow_keeps_newest(monkeypatch):
    obs.disable()
    trace_mod.reset()
    monkeypatch.setattr(trace_mod, "RING_CAPACITY", 8)
    obs.enable()
    try:
        for i in range(50):
            trace_mod.evt(f"e{i}", float(i), 1.0)
        evs = [e for e in obs.chrome_events() if e.get("ph") == "X"]
        assert len(evs) == 8
        assert [e["name"] for e in evs] == [f"e{i}" for i in range(42, 50)]
    finally:
        obs.disable()
        trace_mod.reset()


def test_sampling_rate_respected(monkeypatch):
    obs.disable()
    trace_mod.reset()
    monkeypatch.setattr(trace_mod, "SAMPLE_EVERY", 4)
    obs.enable()
    try:
        ctxs = [trace_mod.mint(f"b{i}", time.perf_counter())
                for i in range(16)]
        assert sum(c.sampled for c in ctxs) == 4
    finally:
        obs.disable()
        trace_mod.reset()


# -- metrics registry -------------------------------------------------------

def test_registry_snapshot_is_json_clean():
    reg = obs.MetricsRegistry()
    reg.counter("a").inc()
    reg.counter("a").inc(2)
    reg.gauge("g", lambda: np.float32(1.5))
    reg.gauge("depth").set(np.int64(7))
    reg.gauge("t", lambda: torch.tensor(2.5))
    reg.register_source("src", lambda: {
        "d": collections.deque([1, 2, 3]),
        "arr": np.arange(3),
        "scalar": np.float64(0.25)})
    back = json.loads(json.dumps(reg.snapshot()))
    assert back["counters"]["a"] == 3
    assert back["gauges"]["g"] == 1.5
    assert back["gauges"]["depth"] == 7
    assert back["sources"]["src"]["d"] == [1, 2, 3]
    assert back["sources"]["src"]["arr"] == [0, 1, 2]
    assert back["sources"]["src"]["scalar"] == 0.25


def test_registry_degrades_on_failing_gauge():
    reg = obs.MetricsRegistry()
    reg.gauge("bad", lambda: 1 / 0)
    reg.register_source("badsrc", lambda: {}[3])
    snap = reg.snapshot()
    assert "error" in str(snap["gauges"]["bad"])
    assert "error" in snap["sources"]["badsrc"]
    json.dumps(snap)


def test_snapshot_emitter_writes_schema_lines(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("n").inc(5)
    path = str(tmp_path / "telemetry.jsonl")
    em = obs.SnapshotEmitter(path, interval_s=0.02, registry=reg)
    em.start()
    time.sleep(0.1)
    em.stop()
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    assert len(rows) >= 2  # periodic + the final snapshot on stop()
    assert all(r["schema"] == obs.SNAPSHOT_SCHEMA for r in rows)
    assert all(r["counters"]["n"] == 5 for r in rows)
    assert all("ts" in r for r in rows)


def test_snapshot_emitter_fixed_rate_rearm_does_not_drift(tmp_path):
    """A slow emit shrinks the next sleep instead of shifting the
    cadence; an emit that overran a whole interval skips one beat."""
    clk = {"t": 0.0}
    em = obs.SnapshotEmitter(str(tmp_path / "t.jsonl"), interval_s=1.0,
                             registry=obs.MetricsRegistry(),
                             clock=lambda: clk["t"])
    em._deadline = 1.0
    clk["t"] = 1.4
    em._rearm()
    assert em._deadline == pytest.approx(2.0)
    assert em._sleep_s() == pytest.approx(0.6)
    clk["t"] = 4.3
    em._rearm()
    assert em._deadline == pytest.approx(5.3)
    assert em._sleep_s() == pytest.approx(1.0)


def test_ring_overflow_export_carries_drop_marker(monkeypatch):
    """A wrapped ring's track carries a ``dropped_events`` metadata event
    with the exact overwrite count."""
    obs.disable()
    trace_mod.reset()
    monkeypatch.setattr(trace_mod, "RING_CAPACITY", 8)
    obs.enable()
    try:
        for i in range(13):
            trace_mod.evt(f"e{i}", float(i), 1.0)
        evs = obs.chrome_events()
        drops = [e for e in evs if e.get("ph") == "M"
                 and e["name"] == "dropped_events"]
        assert len(drops) == 1
        assert drops[0]["args"]["count"] == 5  # 13 puts - 8 capacity
        tracks = {e["tid"]: e["args"]["name"] for e in evs
                  if e.get("ph") == "M" and e["name"] == "thread_name"}
        assert drops[0]["args"]["track"] == tracks[drops[0]["tid"]]
    finally:
        obs.disable()
        trace_mod.reset()


def test_unwrapped_ring_has_no_drop_marker(monkeypatch):
    obs.disable()
    trace_mod.reset()
    monkeypatch.setattr(trace_mod, "RING_CAPACITY", 8)
    obs.enable()
    try:
        for i in range(8):  # exactly full: nothing overwritten
            trace_mod.evt(f"e{i}", float(i), 1.0)
        evs = obs.chrome_events()
        assert not any(e.get("name") == "dropped_events" for e in evs)
        assert len([e for e in evs if e.get("ph") == "X"]) == 8
    finally:
        obs.disable()
        trace_mod.reset()


def test_frontend_publish_unregisters_on_close():
    reg = obs.MetricsRegistry()
    g, src, _sink = wordcount.build_graph()
    fe = IngestFrontend(DirtyScheduler(g), window=WINDOW)
    key = fe.publish_metrics(reg)
    assert fe.submit(src, lines("a", "b")).result(timeout=10).applied
    snap = reg.snapshot()
    assert snap["sources"][key]["applied"] == 1
    assert snap["sources"][key]["policy"] == fe.policy
    fe.close()
    assert key not in reg.snapshot()["sources"]


def test_tier_publish_unregisters_on_close():
    reg = obs.MetricsRegistry()
    tier = ServeTier(max_bytes=8 << 20, pump_threads=1)
    g, src, _sink = wordcount.build_graph()
    h = tier.register("g0", DirtyScheduler(g), GraphConfig(window=WINDOW))
    key = tier.publish_metrics(reg)
    assert h.submit(src, lines("x")).result(timeout=10).applied
    snap = reg.snapshot()
    assert snap["sources"][key]["graphs"] == 1
    assert "g0" in snap["sources"][key]["per_graph"]
    assert 0.0 <= snap["gauges"][f"{key}.pump_utilization"] <= 1.0
    tier.close()
    after = reg.snapshot()
    assert key not in after["sources"]
    assert f"{key}.pump_utilization" not in after["gauges"]


def test_scheduler_and_wal_publish(tmp_path):
    reg = obs.MetricsRegistry()
    g, src, _sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                             fsync="record")
    skey = sched.publish_metrics(reg)
    wkey = sched.wal.publish_metrics(reg)
    sched.push(src, lines("a", "b"))
    sched.tick()
    snap = reg.snapshot()
    assert snap["gauges"][f"{skey}.tick"] == 1
    assert snap["gauges"][f"{skey}.forced_syncs"] == 0
    assert snap["sources"][wkey]["appends"] >= 1
    assert snap["gauges"][f"{wkey}.fsync_rate"] > 0
    json.dumps(snap)
    sched.wal.close()


def test_wal_pipeline_gauges_publish(tmp_path):
    """``queue_depth`` is the in-memory commit backlog and
    ``durable_lag_s`` the age of the oldest pending durability request:
    both drop to zero once a barrier lands."""
    reg = obs.MetricsRegistry()
    g, src, _sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                             fsync="tick")
    wkey = sched.wal.publish_metrics(reg)
    sched.push(src, lines("a", "b"))
    sched.tick()
    snap = reg.snapshot()
    assert snap["gauges"][f"{wkey}.queue_depth"] >= 0
    assert snap["gauges"][f"{wkey}.durable_lag_s"] >= 0.0
    sched.wal.sync()
    snap2 = reg.snapshot()
    assert snap2["gauges"][f"{wkey}.queue_depth"] == 0
    assert snap2["gauges"][f"{wkey}.durable_lag_s"] == 0.0
    json.dumps(snap2)
    sched.wal.close()


# -- shared percentile + to_dict round-trips --------------------------------

def test_percentile_empty_and_single():
    assert percentile([], 99) == 0.0
    assert percentile([0.5], 50) == 0.5
    assert percentile([0.5], 99) == 0.5
    assert percentile(collections.deque([1.0, 2.0, 3.0]), 50) == 2.0
    assert isinstance(percentile(np.arange(5), 95), float)


def test_to_dicts_round_trip_json(tmp_path):
    fe, sched = drive_frontend(_durable(tmp_path), n=6)
    sm = json.loads(json.dumps(summarize_serve(fe).to_dict()))
    assert sm["applied"] == 6
    wm = json.loads(json.dumps(summarize_wal(sched.wal).to_dict()))
    assert wm["appends"] >= 1 and wm["fsync_policy"] == "record"

    tier = ServeTier(max_bytes=8 << 20, pump_threads=1)
    g, src, _sink = wordcount.build_graph()
    h = tier.register("g0", DirtyScheduler(g), GraphConfig(window=WINDOW))
    assert h.submit(src, lines("x")).result(timeout=10).applied
    tm = json.loads(json.dumps(summarize_tier(tier).to_dict()))
    tier.close()
    assert tm["graphs"] == 1 and "g0" in tm["per_graph"]


def test_profile_trace_degrades_without_the_profiler(tmp_path,
                                                     monkeypatch):
    """The reference degrades when ``jax.profiler`` is missing; the
    port's ``profile_trace`` (``torch.profiler``) warns once and runs the
    block untraced when the profiler refuses to start."""
    def refuse(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(metrics_mod, "_trace_warned", False)
    ran = []
    with pytest.warns(RuntimeWarning, match="profile_trace"):
        with profile_trace(str(tmp_path)):
            ran.append(1)   # the block must still run
    assert ran == [1]


# -- the inspect CLIs -------------------------------------------------------

def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_inspect_cli(tmp_path, traced, capsys):
    drive_frontend(_durable(tmp_path))
    path = str(tmp_path / "trace.json")
    obs.export_chrome_trace(path)
    ti = _load_tool("trace_inspect")
    assert ti.main([path, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["schema"] == "reflow.trace_inspect/2"
    assert out["trace_files"] == [path]
    assert out["tickets"] > 0
    assert out["decomposition_max_dev_frac"] < 0.10
    assert set(out["critical_path"]) == set(trace_mod.STAGES)
    dur = out["durability"]
    assert dur["offpath_fsyncs"] > 0 and dur["onpath_fsyncs"] == 0
    assert dur["offpath_fsync_frac"] == 1.0
    assert dur["fsync_covered_mean"] >= 1.0
    assert ti.main([path]) == 0  # human mode renders too
    human = capsys.readouterr().out
    assert "critical path:" in human
    assert "off the dispatch path" in human


def test_wal_inspect_json_schema(tmp_path, capsys):
    g, src, _sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                             fsync="tick")
    for j in range(4):
        sched.push(src, lines(f"w{j}"))
        sched.tick()
    sched.wal.close()
    wi = _load_tool("wal_inspect")
    assert wi.main([str(tmp_path / "wal"), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["schema"] == "reflow.wal_inspect/1"
    assert out["records"] == 8 and out["commit_windows"] == 4
    assert out["commit_window_pushes"] == [1, 1, 1, 1]
    seg = out["segments_detail"]
    assert sum(s["records"] for s in seg) == 8
    assert sum(s["bytes"] for s in seg) == out["bytes"]
