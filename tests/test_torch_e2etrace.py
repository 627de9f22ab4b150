"""Follow-the-write on the port: causality tokens on the wire, sampling
coherence, the chain reader and the freshness gauges, against
``tests/test_e2etrace.py`` and the JAX package, on the CPU.

Counterparts of ``tests/test_e2etrace.py``: the trailing ``cause`` on
``SubmitReq``/``SubmitAck``/``DeltaFrame`` trimmed when unset (byte for
byte the JAX package's pickles), one sampling decision recorded at every
hop of the RPC stack, the fleet's freshness and flight gauges, the hub's
freshness gauge, the durable scheduler's epoch. The chain tests write
their spans through the port's rings and exporter, and hold the port's
reader (``obs.export.full_chains``) and ``tools/trace_inspect.py`` to the
same chains and freshness tiling. The flight recorder's two tests have
their counterparts in ``tests/test_torch_net_obs.py``; the reference's
``test_chain_freshness_two_element_bounds_fallback`` and
``test_read_report_backfills_v1_to_v2_keys`` test helpers of
``tools/trace_inspect.py`` on hand-built dicts, with no package in them.
"""

import importlib.util
import json
import os
import pickle

import numpy as np
import pytest

from reflow_tpu.obs import export as jexport
from reflow_tpu.obs import fleet as jfleet
from reflow_tpu.serve import rpc as jrpc
from reflow_tpu.subs import query as jquery
from reflow_tpu_torch import obs
from reflow_tpu_torch.net import LoopbackTransport
from reflow_tpu_torch.obs import trace
from reflow_tpu_torch.obs.export import FULL_CHAIN, full_chains
from reflow_tpu_torch.obs.fleet import FleetAggregator
from reflow_tpu_torch.serve import (APPLIED, IngestFrontend, RemoteProducer,
                                    ReplicaScheduler, RpcIngestServer)
from reflow_tpu_torch.serve.rpc import SubmitAck, SubmitReq, _trim
from reflow_tpu_torch.subs import SubscriptionHub
from reflow_tpu_torch.subs.query import (DeltaFrame, frames_from_wire,
                                         frames_to_wire)
from reflow_tpu_torch.wal import DurableScheduler, SegmentShipper
from reflow_tpu_torch.workloads import wordcount

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- wire compatibility -----------------------------------------------------

def test_submit_req_unstamped_pickles_byte_identical():
    req = SubmitReq("b0", "src", ("payload",), 5.0)
    assert req.cause is None
    legacy = ("b0", "src", ("payload",), 5.0)   # the pre-trace 4-tuple
    assert pickle.dumps(_trim(tuple(req))) == pickle.dumps(legacy)
    assert pickle.dumps(_trim(tuple(req))) == pickle.dumps(
        jrpc._trim(tuple(jrpc.SubmitReq("b0", "src", ("payload",), 5.0))))
    assert SubmitReq(*legacy).cause is None


def test_submit_req_stamped_round_trips():
    req = SubmitReq("b0", "src", (), None, "p#1#7")
    wire = _trim(tuple(req))
    assert len(wire) == 5
    assert SubmitReq(*wire).cause == "p#1#7"
    assert pickle.dumps(wire) == pickle.dumps(jrpc._trim(tuple(
        jrpc.SubmitReq("b0", "src", (), None, "p#1#7"))))


def test_submit_ack_trim_and_one_sided_tolerance():
    ack = SubmitAck("b0", "pending")
    legacy = ("b0", "pending", None, None)
    assert pickle.dumps(_trim(tuple(ack))) == pickle.dumps(legacy)
    assert SubmitAck(*legacy).cause is None
    stamped = SubmitAck("b0", "pending", cause="p#0#3")
    assert _trim(tuple(stamped))[-1] == "p#0#3"
    assert pickle.dumps(_trim(tuple(stamped))) == pickle.dumps(jrpc._trim(
        tuple(jrpc.SubmitAck("b0", "pending", cause="p#0#3"))))


def test_delta_frame_unstamped_wire_identity_and_stamped():
    fr = DeltaFrame(0, 4, "view", ((("k", 1.0), 1),), False)
    legacy = ((0, 4, "view", ((("k", 1.0), 1),), False),)
    assert pickle.dumps(frames_to_wire([fr])) == pickle.dumps(legacy)
    assert frames_from_wire(legacy)[0].cause is None
    stamped = DeltaFrame(0, 4, "view", (), False, ("p#0#1", "p#0#2"))
    wire = frames_to_wire([stamped])
    assert wire[0][-1] == ("p#0#1", "p#0#2")
    assert frames_from_wire(wire)[0].cause == ("p#0#1", "p#0#2")
    assert pickle.dumps(wire) == pickle.dumps(jquery.frames_to_wire(
        [jquery.DeltaFrame(*stamped)]))


# -- cross-process sampling coherence ---------------------------------------

def _rpc_stack(tmp_path):
    g, src, sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                             fsync="tick")
    fe = IngestFrontend(sched, start=True)
    lt = LoopbackTransport()
    srv = RpcIngestServer(fe, lt).start()
    return sched, fe, lt, srv, src


def _spans(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X"]


def test_sampled_write_recorded_at_every_hop(tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "SAMPLE_EVERY", 1)   # every write draws
    sched, fe, lt, srv, src = _rpc_stack(tmp_path)
    obs.enable()
    trace.reset()
    prod = RemoteProducer(lt, srv.address, name="p0")
    try:
        t = prod.submit(src, wordcount.ingest_lines(["aa bb"]),
                        batch_id="b0")
        assert t.result(10).status == APPLIED
        tok = t.cause
        assert tok and tok.startswith("p0#0#")   # origin#epoch#seq
        out = tmp_path / "trace.json"
        obs.export_chrome_trace(str(out))
        by_name = {}
        for e in _spans(str(out)):
            if (e.get("args") or {}).get("cause") == tok:
                by_name.setdefault(e["name"], []).append(e)
        for name in ("producer_submit", "rpc_admit", "admission",
                     "wal_append"):
            assert name in by_name, (name, sorted(by_name))
        assert by_name["wal_append"][0]["args"]["lsn"] is not None
    finally:
        obs.disable()
        trace.reset()
        prod.close()
        srv.close()
        fe.close()
        sched.wal.close()


def test_unsampled_write_appears_nowhere(tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "SAMPLE_EVERY", 1 << 30)
    trace.sample()   # burn the counter's possible zero-phase draw
    sched, fe, lt, srv, src = _rpc_stack(tmp_path)
    obs.enable()
    trace.reset()
    prod = RemoteProducer(lt, srv.address, name="p0")
    try:
        t = prod.submit(src, wordcount.ingest_lines(["aa"]),
                        batch_id="b0")
        assert t.result(10).status == APPLIED
        assert t.cause is None
        out = tmp_path / "trace.json"
        obs.export_chrome_trace(str(out))
        causes = [e for e in _spans(str(out))
                  if (e.get("args") or {}).get("cause")
                  or (e.get("args") or {}).get("causes")]
        assert causes == []          # no torn chain anywhere
        assert not any(e["name"] == "rpc_admit"
                       for e in _spans(str(out)))
    finally:
        obs.disable()
        trace.reset()
        prod.close()
        srv.close()
        fe.close()
        sched.wal.close()


# -- chains and freshness tiling, through the port's rings and exporter ----

TOK = "p0#0#1"      # the write's own token
CHUNK = "n0#0#9"    # the shipped chunk's token (bridges net_send)


def _chain(*, replay_dur=500.0, extra=()):
    """(name, start us, dur us, args) of one write's nine links."""
    evs = [
        ("producer_submit", 0.0, 1000.0, {"cause": TOK}),
        ("rpc_admit", 100.0, 100.0, {"cause": TOK}),
        ("admission", 120.0, 50.0, {"cause": TOK}),
        ("wal_append", 300.0, 200.0, {"cause": TOK, "lsn": 3}),
        ("ship_segment", 600.0, 300.0, {"cause": CHUNK, "causes": [TOK]}),
        ("net_send", 620.0, 100.0, {"cause": CHUNK}),
        ("replica_replay", 1000.0, replay_dur,
         {"cause": CHUNK, "causes": [TOK]}),
        ("sub_fanout", 1600.0, 100.0, {"causes": [TOK]}),
        ("sub_deliver", 1800.0, 50.0, {"causes": [TOK]}),
    ]
    return evs + list(extra)


def _export(path, spans, t0=10.0):
    """Record ``spans`` through the port's rings (starts and durations
    in microseconds from ``t0`` seconds) and export them."""
    trace.reset()
    obs.enable()
    try:
        for name, ts, dur, args in spans:
            trace.evt(name, t0 + ts * 1e-6, dur * 1e-6, args=dict(args))
        return obs.export_chrome_trace(str(path))
    finally:
        obs.disable()
        trace.reset()


def _events(*paths):
    out = []
    for p in paths:
        with open(p) as f:
            out += json.load(f)["traceEvents"]
    return out


def test_inspect_stitches_full_chain_across_files(tmp_path):
    """One write's spans split across three port trace files (producer,
    leader, replica): the port's reader finds one full chain in the
    files' events together, and ``trace_inspect`` merges the files onto
    one timeline and tiles the write's freshness exactly."""
    ti = _load_tool("trace_inspect")
    evs = _chain()
    producer = [e for e in evs if e[0] == "producer_submit"]
    leader = [e for e in evs if e[0] in ("rpc_admit", "admission",
                                         "wal_append", "ship_segment",
                                         "net_send")]
    rest = [e for e in evs if e not in producer and e not in leader]
    files = [_export(tmp_path / "p.json", producer),
             _export(tmp_path / "l.json", leader),
             _export(tmp_path / "r.json", rest)]
    assert [len(full_chains(_events(f))) for f in files] == [0, 0, 0]
    groups = full_chains(_events(*files))
    assert len(groups) == 1 and groups[0]["tokens"] == {TOK, CHUNK}
    rep = ti.inspect(files, require_chain=list(ti.FULL_CHAIN))
    assert tuple(ti.FULL_CHAIN) == FULL_CHAIN
    assert rep["schema"] == "reflow.trace_inspect/2"
    assert rep["causal"]["full_chains"] == 1
    assert rep["causal"]["required_chains"] == 1
    fresh = rep["freshness"]
    assert fresh["chains"] == 1 and fresh["worst"]["token"] == TOK
    assert fresh["max_dev_frac"] == pytest.approx(0.0, abs=1e-6)
    assert fresh["e2e_p50_us"] == pytest.approx(1850.0, abs=0.01)
    assert fresh["stages"]["admission"]["p50_us"] == \
        pytest.approx(200.0, abs=0.01)
    assert fresh["stages"]["durability"]["p50_us"] == \
        pytest.approx(300.0, abs=0.01)


def test_require_chain_fails_on_missing_link(tmp_path):
    ti = _load_tool("trace_inspect")
    f = _export(tmp_path / "t.json",
                [e for e in _chain() if e[0] != "net_send"])
    assert full_chains(_events(f)) == []
    rep = ti.inspect([f], require_chain=list(ti.FULL_CHAIN))
    assert rep["causal"]["required_chains"] == 0
    assert rep["causal"]["full_chains"] == 0


def test_freshness_tiles_when_replay_encloses_fanout(tmp_path):
    # the hub can push inside the replay span, so the replay closes after
    # the push: the apply cut takes the earlier end and the tiling holds
    ti = _load_tool("trace_inspect")
    f = _export(tmp_path / "t.json", _chain(replay_dur=900.0))
    assert len(full_chains(_events(f))) == 1
    rep = ti.inspect([f], require_chain=list(ti.FULL_CHAIN))
    fresh = rep["freshness"]
    assert fresh["max_dev_frac"] == pytest.approx(0.0, abs=1e-6)
    assert fresh["worst"]["raw_stage_us"]["fanout"] == \
        pytest.approx(0.0, abs=0.01)
    assert fresh["worst"]["raw_stage_us"]["apply"] == \
        pytest.approx(700.0, abs=0.01)


def test_freshness_uses_first_admit_of_a_resubmitted_write(tmp_path):
    # a lost ack's dedup re-admit records a second rpc_admit later; the
    # freshness reads the first, and the tiling still closes
    ti = _load_tool("trace_inspect")
    f = _export(tmp_path / "t.json", _chain(
        extra=[("rpc_admit", 900.0, 100.0, {"cause": TOK})]))
    groups = full_chains(_events(f))
    assert len(groups) == 1 and groups[0]["spans"]["rpc_admit"] == 2
    rep = ti.inspect([f], require_chain=list(ti.FULL_CHAIN))
    assert rep["freshness"]["max_dev_frac"] == pytest.approx(0.0, abs=1e-6)


def test_port_chain_reader_matches_trace_inspect_on_mixed_groups(tmp_path):
    """Three writes, one complete, one missing its delivery, one bridged
    to the complete one's chunk token: the port's reader and the tool
    count the same groups and the same full chains."""
    ti = _load_tool("trace_inspect")
    spans = _chain()
    spans += [(n, ts + 5000.0, d, {k: (v.replace("p0#0#1", "p0#0#2")
                                       .replace("n0#0#9", "n0#0#8")
                                       if isinstance(v, str) else
                                       [x.replace("p0#0#1", "p0#0#2")
                                        for x in v] if isinstance(v, list)
                                       else v)
                                   for k, v in a.items()})
              for n, ts, d, a in _chain() if n != "sub_deliver"]
    spans.append(("replica_replay", 9000.0, 10.0,
                  {"cause": CHUNK, "causes": ["p0#0#3"]}))
    f = _export(tmp_path / "t.json", spans)
    events = _events(f)
    rep = ti.inspect([f], require_chain=list(ti.FULL_CHAIN))
    assert len(full_chains(events)) == rep["causal"]["full_chains"] == 1
    assert len(obs.export.causal_groups(events)) == \
        rep["causal"]["groups"] == 2


# -- fleet aggregation: gauges with pre-upgrade tolerance -------------------

#: one node that ships the freshness and flight gauges, one that predates
#: them
_FEED = (("new", {"gauges": {"subs.freshness_p50": 0.002,
                             "subs.freshness_p99": 0.010,
                             "flight.events_total": 42}}),
         ("old", {"gauges": {}}))


def test_fleet_freshness_and_flight_gauges_backfill_tolerant():
    snaps = {}
    for name, cls in (("jax", jfleet.FleetAggregator),
                      ("port", FleetAggregator)):
        agg = cls(retention=4, stale_after_s=60.0)
        for node, snap in _FEED:
            agg.ingest(node, snap)
        snaps[name] = agg.fleet_snapshot()
    snap = snaps["port"]
    assert snap["nodes"]["old"]["sub_freshness_p50"] is None
    assert snap["nodes"]["old"]["flight_events"] is None
    assert snap["nodes"]["new"]["sub_freshness_p99"] == 0.010
    assert snap["gauges"]["subs.freshness_p50"] == 0.002
    assert snap["gauges"]["flight.events_total"] == 42
    assert not snap["alerts"]
    for s in snaps.values():
        s.pop("ts_wall")
        for node in s["nodes"].values():
            node.pop("age_s")
        s["gauges"].pop("max_age_s")
    assert snaps["port"] == snaps["jax"]


def test_fleet_gauges_none_when_no_node_ships_them():
    agg = FleetAggregator(retention=4, stale_after_s=60.0)
    agg.ingest("old", {"gauges": {"r0.horizon": 7}})
    g = agg.fleet_snapshot()["gauges"]
    assert g["subs.freshness_p50"] is None
    assert g["subs.freshness_p99"] is None
    assert g["flight.events_total"] is None


# -- hub freshness gauges feed the fleet plane ------------------------------

def test_hub_freshness_gauge_populates_after_fanout(tmp_path):
    g, src, sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                             fsync="tick")
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    g2, _s, _k = wordcount.build_graph()
    rep = ReplicaScheduler(g2, str(tmp_path / "r0"), name="r0")
    ship.attach(rep)
    hub = SubscriptionHub(rep, name="r0", idle_poll_s=0.005)
    rep.attach_hub(hub)
    reg = obs.MetricsRegistry()
    hub.publish_metrics(reg)
    try:
        h = hub.open(sink.name, "view")
        rng = np.random.default_rng(0)
        for t in range(3):
            words = " ".join(f"w{int(x)}"
                             for x in rng.integers(0, 20, 8))
            sched.push(src, wordcount.ingest_lines([words]),
                       batch_id=f"t{t}")
            sched.tick()
        sched.wal.sync()
        for _ in range(200):
            ship.pump_once()
            if rep.published_horizon() == sched._tick:
                break
        assert h.wait_horizon(rep.published_horizon())
        snap = reg.snapshot()["gauges"]
        assert snap["subs.freshness_p50"] > 0.0
        assert snap["subs.freshness_p99"] >= snap["subs.freshness_p50"]
    finally:
        hub.close()
        sched.close()


# -- the promoted leader advertises its true epoch --------------------------

def test_durable_scheduler_exposes_wal_epoch(tmp_path):
    g, _src, _sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                             fsync="tick", epoch=3)
    try:
        assert sched.epoch == 3
        assert sched.epoch == sched.wal.epoch
    finally:
        sched.wal.close()


def test_port_trace_reads_the_same_in_jax_ticket_timelines(tmp_path,
                                                           monkeypatch):
    """A port trace of sampled frontend tickets: the JAX
    ``ticket_timelines`` and the port's give the same stages, tiling the
    same end-to-end spans."""
    monkeypatch.setattr(trace, "SAMPLE_EVERY", 1)
    g, src, _sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                             fsync="record")
    trace.reset()
    obs.enable()
    fe = IngestFrontend(sched)
    try:
        for j in range(6):
            assert fe.submit(src, wordcount.ingest_lines(
                [f"w{j} w{j % 2}"])).result(timeout=10).applied
    finally:
        fe.close()
        obs.disable()
    path = obs.export_chrome_trace(str(tmp_path / "trace.json"))
    trace.reset()
    sched.wal.close()
    events = _events(path)
    mine = obs.ticket_timelines(events)
    theirs = jexport.ticket_timelines(events)
    assert mine and mine == theirs
    for tl in mine.values():
        assert set(tl["stages"]) == set(trace.STAGES)
        assert tl["sum_us"] == pytest.approx(tl["e2e_us"], rel=1e-6,
                                             abs=0.01)
