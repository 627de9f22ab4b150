"""The port's fleet telemetry plane (``reflow_tpu_torch.obs.fleet`` and
``obs.wire``) against ``tests/test_fleet.py`` and the JAX package, on the
CPU.

Every test of ``tests/test_fleet.py`` has a counterpart here, over the
port's classes: causality tokens stitch one shipment's ``ship_segment``
-> ``net_send`` -> ``replica_replay`` spans (legacy ``Shipment`` frames
stay byte-identical), the subscribe handshake's clock anchor, telemetry
loss tolerated, the aggregator's derived gauges, and the consumers
(``tools/fleet_inspect.py``, ``tools/reflow_top.py``) on a port
``reflow.fleet/1`` snapshot; the two ``ControlPlane(fleet=)`` tests are in
``tests/test_torch_control.py``, over the port's aggregator. TCP cases
run on 127.0.0.1 with every wait bounded.

Across the packages: a JAX ``TelemetryLink`` ships to a port
``TelemetryServer`` and the reverse; the telemetry requests of both links
pickle to the same bytes for the same inputs; and the two aggregators
give the same fleet snapshot for the same ingested snapshots.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pickle

import numpy as np
import pytest

from reflow_tpu.obs import fleet as jfleet
from reflow_tpu.obs import wire as jwire
from reflow_tpu.net import TcpTransport as JTcpTransport
from reflow_tpu_torch import obs
from reflow_tpu_torch.net import (ReconnectPolicy, RemoteFollower,
                                  ReplicaServer, TcpTransport)
from reflow_tpu_torch.net.framing import TransportError
from reflow_tpu_torch.obs import trace as trace_mod
from reflow_tpu_torch.obs import wire as pwire
from reflow_tpu_torch.obs.fleet import (FLEET_SCHEMA, FleetAggregator,
                                        TelemetryShipper)
from reflow_tpu_torch.obs.wire import (TelemetryLink, TelemetryServer,
                                       node_id)
from reflow_tpu_torch.serve import ReplicaScheduler
from reflow_tpu_torch.wal import DurableScheduler, SegmentShipper
from reflow_tpu_torch.wal.ship import Shipment
from reflow_tpu_torch.workloads import wordcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def traced():
    obs.disable()
    trace_mod.reset()
    obs.enable()
    yield
    obs.disable()
    trace_mod.reset()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def drive(sched, src, n_ticks, seed=0):
    rng = np.random.default_rng(seed)
    for t in range(n_ticks):
        words = " ".join(f"w{int(x)}" for x in rng.integers(0, 40, 8))
        sched.push(src, wordcount.ingest_lines([words]),
                   batch_id=f"t{t}")
        sched.tick()


def pump_until_caught(ship, sched, replicas, max_rounds=200):
    sched.wal.sync()
    for _ in range(max_rounds):
        ship.pump_once()
        if all(r.published_horizon() == sched._tick for r in replicas):
            return
    raise AssertionError("replicas never caught up")


# -- the Shipment wire frame (legacy compat + cause stamping) ---------------

class _ScriptConn:
    def __init__(self, replies):
        self.sent = []
        self._replies = list(replies)

    def send_msg(self, msg, timeout_s=None):
        self.sent.append(msg)

    def recv_msg(self, timeout_s=None):
        if not self._replies:
            raise TransportError("script exhausted")
        return self._replies.pop(0)

    def close(self):
        pass


class _ScriptTransport:
    def __init__(self, conn):
        self._conn = conn

    def connect(self, address):
        return self._conn


def _follower(conn, name="r0"):
    return RemoteFollower(
        _ScriptTransport(conn), ("stub", 0), name=name,
        policy=ReconnectPolicy(name, base_s=0.001, cap_s=0.01, seed=0))


def test_legacy_shipment_frame_is_byte_identical(tmp_path):
    """An unstamped shipment's receive frame pickles to exactly the
    pre-trace 8-field protocol: the trailing None cause never reaches the
    wire."""
    obs.disable()
    legacy = Shipment(0, 0, b"xx", 2, False, None, 3, 1)
    assert legacy.cause is None
    conn = _ScriptConn([("ok", None), ("ack", (0, 2), 3)])
    f = _follower(conn)
    f.receive(legacy)  # the first call dials and resyncs
    ack = f.receive(legacy)
    assert ack.horizon == 3
    sent = conn.sent[-1]
    assert sent == ("receive", 0, 0, b"xx", 2, False, None, 3, 1)
    pre_trace = ("receive",) + tuple(legacy)[:8]
    assert pickle.dumps(sent) == pickle.dumps(pre_trace)


def test_stamped_shipment_carries_cause_and_span_echoes_it(traced):
    stamped = Shipment(0, 0, b"xx", 2, False, None, 3, 1,
                       trace_mod.mint_cause("leader", 1))
    conn = _ScriptConn([("ok", None), ("ack", (0, 2), 3)])
    f = _follower(conn)
    f.receive(stamped)
    f.receive(stamped)
    sent = conn.sent[-1]
    assert len(sent) == 10 and sent[-1] == stamped.cause
    sends = [e for e in obs.chrome_events()
             if e.get("ph") == "X" and e["name"] == "net_send"]
    assert any(e.get("args", {}).get("cause") == stamped.cause
               for e in sends)


def test_subscribe_anchor_captured_and_legacy_server_tolerated():
    anchored = _ScriptConn([("ok", None,
                             {"node": "r0", "mono": 1.0, "wall": 2.0})])
    f = _follower(anchored)
    f.subscribe()
    assert f.anchor is not None
    assert f.anchor["node"] == "r0"
    assert f.anchor["rtt_s"] >= 0.0
    assert "wall_offset_s" in f.anchor
    legacy = _ScriptConn([("ok", None)])  # a pre-anchor 2-tuple reply
    f2 = _follower(legacy, name="r1")
    assert f2.subscribe() is None
    assert f2.anchor is None


def test_cause_tokens_stitch_ship_send_replay_over_tcp(tmp_path, traced):
    """One leader, one TCP replica: every shipped chunk's three hops share
    one causality token, read by the port's exporter and reader and by
    ``tools/trace_inspect.py``."""
    g, src, _sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                             fsync="tick")
    gr, _s, _k = wordcount.build_graph()
    r = ReplicaScheduler(gr, str(tmp_path / "r0"), name="r0")
    srv = ReplicaServer(r, TcpTransport()).start()
    link = RemoteFollower(
        TcpTransport(), srv.address, name="r0",
        policy=ReconnectPolicy("r0", base_s=0.005, cap_s=0.05, seed=0),
        io_timeout_s=2.0)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    ship.attach(link)
    try:
        drive(sched, src, 4)
        pump_until_caught(ship, sched, [r])
        hops = ("ship_segment", "net_send", "replica_replay")
        by_cause = {}
        for e in obs.chrome_events():
            if e.get("ph") != "X":
                continue
            cause = e.get("args", {}).get("cause")
            if cause:
                by_cause.setdefault(cause, set()).add(e["name"])
        full = [c for c, names in by_cause.items() if set(hops) <= names]
        assert full, f"no complete chain in {by_cause}"
        for c in full:
            assert c.startswith(f"{node_id()}#")  # origin#epoch#seq
        path = str(tmp_path / "trace.json")
        obs.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        assert len(obs.export.full_chains(events, hops)) >= 1
        ti = _load_tool("trace_inspect")
        out = ti.inspect(path, require_chain=list(hops))
        assert out["causal"]["required_chains"] >= 1
        assert ti.main([path, "--require-chain", ",".join(hops),
                        "--json"]) == 0
    finally:
        ship.close()
        link.close()
        srv.close()
        r.close()
        sched.wal.close()


def test_tracing_disabled_ships_no_cause(tmp_path):
    obs.disable()
    g, src, _sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                             fsync="tick")
    gr, _s, _k = wordcount.build_graph()
    r = ReplicaScheduler(gr, str(tmp_path / "r0"), name="r0")
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    seen = []
    orig = r.receive

    def spy(sh):
        seen.append(sh)
        return orig(sh)

    r.receive = spy
    ship.attach(r)
    try:
        drive(sched, src, 2)
        pump_until_caught(ship, sched, [r])
        assert seen and all(sh.cause is None for sh in seen)
    finally:
        ship.close()
        r.close()
        sched.wal.close()


# -- FleetAggregator derivation ---------------------------------------------

def _snap(mono, **gauges):
    return {"schema": obs.SNAPSHOT_SCHEMA, "ts_mono": mono,
            "ts_wall": 1000.0 + mono, "gauges": gauges}


#: one fleet's snapshots, fed to both packages' aggregators
_FLEET_FEED = (
    ("r0", _snap(1.0, **{"replica.r0.horizon": 10,
                         "replica.r0.lag_ticks": 0,
                         "replica.r0.epoch": 1,
                         "replica.r0.conn_state": "healthy",
                         "tier.replica_reads": 100})),
    ("r0", _snap(3.0, **{"replica.r0.horizon": 12,
                         "replica.r0.lag_ticks": 0,
                         "replica.r0.epoch": 1,
                         "replica.r0.conn_state": "healthy",
                         "tier.replica_reads": 200,
                         "subs.active": 3,
                         "subs.freshness_p50": 0.002})),
    ("r1", _snap(1.0, **{"replica.r1.horizon": 4,
                         "replica.r1.lag_ticks": 8,
                         "replica.r1.epoch": 1,
                         "compact.reclaimable_bytes": 4096,
                         "node.peak_tile_bytes": 77,
                         "r1.brownout.level": 2})),
)


def test_aggregator_derives_lag_spread_epochs_and_qps():
    clk = FakeClock()
    agg = FleetAggregator(retention=8, stale_after_s=5.0, clock=clk,
                          wall=lambda: 42.0)
    for node, snap in _FLEET_FEED:
        agg.ingest(node, snap)
    snap = agg.fleet_snapshot()
    assert snap["schema"] == FLEET_SCHEMA and snap["ts_wall"] == 42.0
    g = snap["gauges"]
    assert g["nodes_total"] == 2 and g["nodes_stale"] == 0
    assert g["lag_spread"] == 8          # 12 - 4
    assert g["epochs"] == [1] and g["epoch_agree"] is True
    # 100 reads over 2 s of the sender's monotonic clock
    assert g["aggregate_read_qps"] == pytest.approx(50.0)
    assert snap["nodes"]["r0"]["horizon"] == 12
    assert snap["nodes"]["r1"]["lag_ticks"] == 8
    assert snap["nodes"]["r0"]["conn_states"] == {
        "replica.r0.conn_state": "healthy"}
    assert snap["alerts"] == []  # spread 8 <= the default limit
    json.dumps(snap)
    agg.close()


def test_fleet_snapshot_matches_the_jax_aggregator():
    """The same snapshots into both packages' aggregators (fake clocks)
    give the same ``reflow.fleet/1`` document, key for key and value for
    value, stale marks and alerts included."""
    out = {}
    for name, cls in (("jax", jfleet.FleetAggregator),
                      ("port", FleetAggregator)):
        clk = FakeClock()
        agg = cls(retention=8, stale_after_s=1.0, clock=clk,
                  wall=lambda: 42.0)
        agg.lag_spread_max = 4
        for node, snap in _FLEET_FEED:
            agg.ingest(node, snap)
        agg.record_anchor("r0", {"node": "r0", "mono": 1.0, "wall": 2.0})
        clk.advance(3.0)
        agg.ingest("r2", _snap(9.0))
        out[name] = agg.fleet_snapshot()
        agg.close()
    assert out["port"] == out["jax"]
    assert out["port"]["gauges"]["nodes_stale"] == 2
    assert len(out["port"]["alerts"]) == 3


def test_aggregator_epoch_disagreement_and_spread_alerts():
    clk = FakeClock()
    agg = FleetAggregator(retention=4, stale_after_s=5.0, clock=clk)
    agg.lag_spread_max = 16
    agg.ingest("r0", _snap(1.0, **{"replica.r0.horizon": 100,
                                   "replica.r0.epoch": 2}))
    agg.ingest("r1", _snap(1.0, **{"replica.r1.horizon": 10,
                                   "replica.r1.epoch": 1}))
    snap = agg.fleet_snapshot()
    assert snap["gauges"]["epoch_agree"] is False
    assert snap["gauges"]["epochs"] == [1, 2]
    assert any("epoch disagreement" in a for a in snap["alerts"])
    assert any("lag spread 90 ticks exceeds 16" in a
               for a in snap["alerts"])
    agg.close()


def test_aggregator_stale_marks_but_keeps_serving():
    """A silent node stays in the fleet view with an honest age on it:
    staleness is a display state, never an eviction or an error."""
    clk = FakeClock()
    agg = FleetAggregator(retention=4, stale_after_s=1.0, clock=clk)
    agg.ingest("r0", _snap(1.0, **{"replica.r0.horizon": 5}))
    agg.ingest("r1", _snap(1.0, **{"replica.r1.horizon": 5}))
    clk.advance(0.5)
    assert agg.stale_nodes() == []
    clk.advance(2.0)
    agg.ingest("r1", _snap(4.0, **{"replica.r1.horizon": 7}))
    snap = agg.fleet_snapshot()
    assert agg.stale_nodes() == ["r0"]
    assert snap["nodes"]["r0"]["stale"] is True
    assert snap["nodes"]["r0"]["horizon"] == 5  # last known, served
    assert snap["nodes"]["r1"]["stale"] is False
    assert snap["gauges"]["nodes_stale"] == 1
    assert any(a.startswith("stale: r0") for a in snap["alerts"])
    agg.close()


def test_aggregator_retention_bounds_ring():
    agg = FleetAggregator(retention=3, stale_after_s=5.0,
                          clock=FakeClock())
    for i in range(10):
        agg.ingest("r0", _snap(float(i)))
    snap = agg.fleet_snapshot()
    assert snap["nodes"]["r0"]["snapshots"] == 3
    assert snap["gauges"]["snapshots_total"] == 10
    agg.close()


def test_aggregator_publish_metrics_and_unregister():
    reg = obs.MetricsRegistry()
    agg = FleetAggregator(retention=4, stale_after_s=5.0,
                          clock=FakeClock())
    agg.ingest("r0", _snap(1.0, **{"replica.r0.horizon": 5}))
    agg.publish_metrics(reg)
    snap = reg.snapshot()
    assert snap["gauges"]["fleet.nodes_total"] == 1
    assert snap["gauges"]["fleet.snapshots_total"] == 1
    agg.close()
    assert "fleet.nodes_total" not in reg.snapshot()["gauges"]


# -- snapshot shipping over the wire ----------------------------------------

def test_shipper_to_aggregator_over_tcp_and_fleet_query():
    reg = obs.MetricsRegistry()
    reg.counter("serve.applied").inc(7)
    reg.gauge("replica.r0.horizon", lambda: 9)
    agg = FleetAggregator(retention=8, stale_after_s=5.0)
    tsrv = TelemetryServer(agg, TcpTransport()).start()
    sh = TelemetryShipper(
        reg, TcpTransport(), tsrv.address, node="r0",
        policy=ReconnectPolicy("tele/r0", base_s=0.005, cap_s=0.05,
                               seed=0),
        io_timeout_s=2.0)
    probe = TelemetryLink(TcpTransport(), tsrv.address,
                          node="probe", io_timeout_s=2.0)
    try:
        snap = sh.build_snapshot()
        assert snap["schema"] == obs.SNAPSHOT_SCHEMA
        assert snap["node"] == "r0" and "ts_mono" in snap
        assert sh.ship_once() and sh.shipped == 1
        assert agg.node_count() == 1
        # the hello handshake recorded r0's clock anchor
        assert "r0" in agg.fleet_snapshot()["anchors"]
        fleet = probe.fetch_fleet()
        assert fleet is not None and fleet["schema"] == FLEET_SCHEMA
        assert fleet["nodes"]["r0"]["horizon"] == 9
        assert probe.anchor is not None and probe.anchor["rtt_s"] >= 0
    finally:
        probe.close()
        sh.close()
        tsrv.close()
        agg.close()


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_telemetry_across_packages_over_tcp(server_side):
    """A JAX link ships to a port ``TelemetryServer`` and a port link to
    a JAX one: the snapshot lands, the anchor is recorded, and the fleet
    query answers with the other package's aggregator's document."""
    if server_side == "port":
        agg, srv_cls, tcp = FleetAggregator, TelemetryServer, TcpTransport
        link_cls, ltcp = jwire.TelemetryLink, JTcpTransport
    else:
        agg, srv_cls, tcp = (jfleet.FleetAggregator, jwire.TelemetryServer,
                             JTcpTransport)
        link_cls, ltcp = TelemetryLink, TcpTransport
    a = agg(retention=4, stale_after_s=5.0)
    srv = srv_cls(a, tcp(), node="agg").start()
    link = link_cls(ltcp(), srv.address, node="r0", io_timeout_s=2.0)
    try:
        assert link.send_snapshot(_snap(1.0, **{"replica.r0.horizon": 6}))
        assert a.node_count() == 1
        fleet = link.fetch_fleet()
        assert fleet["schema"] == FLEET_SCHEMA
        assert fleet["nodes"]["r0"]["horizon"] == 6
        assert fleet["anchors"]["r0"]["node"] == "r0"
        assert link.anchor["node"] == "agg"
    finally:
        link.close()
        srv.close()
        a.close()


def test_telemetry_requests_pickle_identically_across_packages(
        monkeypatch):
    """For the same node, anchor and snapshot, both links send the same
    requests, pickled to the same bytes: hello, snap and fleet."""
    anchor = {"node": "r0", "mono": 1.0, "wall": 2.0}
    sent = {}
    for name, mod in (("jax", jwire), ("port", pwire)):
        monkeypatch.setattr(mod, "clock_anchor", lambda node=None: anchor)
        conn = _ScriptConn([("ok", dict(anchor)), ("ok",),
                            ("ok", {"schema": FLEET_SCHEMA})])
        link = mod.TelemetryLink(_ScriptTransport(conn), ("stub", 0),
                                 node="r0")
        assert link.send_snapshot(_snap(1.0, **{"r0.horizon": 3}))
        assert link.fetch_fleet() == {"schema": FLEET_SCHEMA}
        sent[name] = [pickle.dumps(m) for m in conn.sent]
    assert len(sent["port"]) == 3
    assert sent["port"] == sent["jax"]


def test_telemetry_loss_tolerated_never_raises():
    """A dead aggregator: every beat is a dropped counter, the data path
    never sees an exception, and the link state degrades."""

    class _DeadTransport:
        def connect(self, address):
            raise TransportError("nothing listening")

    reg = obs.MetricsRegistry()
    sh = TelemetryShipper(
        reg, _DeadTransport(), ("nowhere", 0), node="r0",
        policy=ReconnectPolicy("tele/r0", base_s=0.0, cap_s=0.0,
                               seed=0))
    for _ in range(5):
        assert sh.ship_once() is False
    assert sh.dropped == 5 and sh.shipped == 0
    assert sh.link.conn_state != "healthy"
    sh.close()


def test_telemetry_server_survives_poison_and_keeps_serving():
    agg = FleetAggregator(retention=4, stale_after_s=5.0)
    tsrv = TelemetryServer(agg, TcpTransport()).start()
    try:
        conn = TcpTransport().connect(tsrv.address)
        conn.send_msg(("bogus-op", 1, 2), 2.0)
        assert conn.recv_msg(2.0)[0] == "err"
        conn.send_msg("not-a-tuple", 2.0)
        assert conn.recv_msg(2.0)[0] == "err"
        # a malformed snap degrades, then a healthy request still works
        conn.send_msg(("snap", "r0"), 2.0)
        assert conn.recv_msg(2.0)[0] == "err"
        conn.send_msg(("ping",), 2.0)
        ok, info = conn.recv_msg(2.0)
        assert ok == "ok" and info["nodes"] == 0
        conn.close()
    finally:
        tsrv.close()
        agg.close()


def test_shipper_publishes_its_own_metrics():
    reg = obs.MetricsRegistry()
    agg = FleetAggregator(retention=4, stale_after_s=5.0)
    tsrv = TelemetryServer(agg, TcpTransport()).start()
    sh = TelemetryShipper(reg, TcpTransport(), tsrv.address, node="r0",
                          io_timeout_s=2.0)
    sh.publish_metrics()
    try:
        sh.ship_once()
        snap = reg.snapshot()
        assert snap["gauges"]["telemetry.shipped"] == 1
        assert snap["gauges"]["telemetry.dropped"] == 0
        assert snap["gauges"]["telemetry.conn_state"] == "healthy"
    finally:
        sh.close()
        tsrv.close()
        agg.close()
    assert "telemetry.shipped" not in reg.snapshot()["gauges"]


# -- consumers --------------------------------------------------------------

def _fleet_fixture():
    agg = FleetAggregator(retention=4, stale_after_s=5.0,
                          clock=FakeClock())
    agg.ingest("r0", _snap(1.0, **{"replica.r0.horizon": 12,
                                   "replica.r0.lag_ticks": 0,
                                   "replica.r0.epoch": 1,
                                   "replica.r0.conn_state": "healthy"}))
    agg.ingest("r1", _snap(1.0, **{"replica.r1.horizon": 4,
                                   "replica.r1.lag_ticks": 8,
                                   "replica.r1.epoch": 1}))
    snap = agg.fleet_snapshot()
    agg.close()
    return snap


def test_fleet_inspect_file_json_and_fail_on_alert(tmp_path, capsys):
    snap = _fleet_fixture()
    path = str(tmp_path / "fleet.json")
    with open(path, "w") as f:
        json.dump(snap, f)
    fi = _load_tool("fleet_inspect")
    assert fi.main([path, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["schema"] == FLEET_SCHEMA
    assert out["gauges"]["lag_spread"] == 8
    assert fi.main([path]) == 0  # the human table renders
    human = capsys.readouterr().out
    assert "r0" in human and "lag spread" in human
    # alerts are reported, not fatal, unless asked
    snap["alerts"] = ["stale: r1 last seen 9.0s ago"]
    with open(path, "w") as f:
        json.dump(snap, f)
    assert fi.main([path]) == 0
    capsys.readouterr()
    assert fi.main([path, "--fail-on-alert"]) == 1
    with open(path, "w") as f:
        f.write(json.dumps({"schema": "other/1"}))
    with pytest.raises(SystemExit):
        fi.main([path, "--json"])


def test_fleet_inspect_bench_dir_backfill_tolerant(tmp_path, capsys):
    """``fleet_inspect --bench-dir`` over a directory with a port fleet
    snapshot beside bench results: the snapshot is not a bench."""
    (tmp_path / "new.json").write_text(json.dumps(
        {"schema": "reflow.bench/1", "mode": "fleetobs",
         "rows_per_s": 1}))
    (tmp_path / "old.json").write_text(json.dumps(
        {"metric": "x", "rows_per_s": 2.0}))
    (tmp_path / "fleet.json").write_text(json.dumps(_fleet_fixture()))
    (tmp_path / "junk.json").write_text("{broken")
    fi = _load_tool("fleet_inspect")
    assert fi.main(["--bench-dir", str(tmp_path), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["schema"] == "reflow.fleet_benchdir/1"
    assert out["stamped"] == 1 and out["unstamped"] == 1
    by_file = {e["file"]: e for e in out["benches"]}
    assert by_file["new.json"]["mode"] == "fleetobs"
    assert by_file["old.json"]["mode"] is None
    assert "fleet.json" not in by_file


def test_reflow_top_render_marks_stale_and_disconnect():
    rt = _load_tool("reflow_top")
    snap = _fleet_fixture()
    snap["nodes"]["r1"]["stale"] = True
    snap["nodes"]["r1"]["age_s"] = 9.3
    snap["alerts"] = ["stale: r1 last seen 9.3s ago"]
    frame = rt.render(snap)
    assert "reflow-top" in frame and "2 node(s)" in frame
    assert "STALE(9.3s)" in frame
    assert "ALERT: stale: r1" in frame
    assert "lag spread 8" in frame
    assert "[disconnected]" in rt.render(snap, stale_link=True)


def test_reflow_top_once_renders_saved_snapshot(tmp_path, capsys):
    snap = _fleet_fixture()
    path = str(tmp_path / "fleet.json")
    with open(path, "w") as f:
        json.dump(snap, f)
    rt = _load_tool("reflow_top")
    assert rt.main([path, "--once"]) == 0
    out = capsys.readouterr().out
    assert "r0" in out and "r1" in out
