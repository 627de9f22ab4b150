"""The port's wire framing (``reflow_tpu_torch.net.framing``), flight
recorder (``obs.flight``), node identity (``obs.wire``) and the trace tee
(``obs.trace.set_flight_hook``) against the JAX package, on the CPU.

Counterparts of ``tests/test_net.py``'s framing tests (round trip and
split, CRC and magic enforced) and of ``tests/test_e2etrace.py``'s flight
recorder tests (the ring rotates, a respawn archives ``.prev``, a torn
final line is dropped, ``tools/reflow_flight.py`` merges the corner; the
gauges unregister on close). Across the packages: the same message
encodes to the same frame bytes in both, each decodes the other's, and a
flight file the port wrote reads in the JAX package. Beyond them: an
installed recorder tees causality-carrying spans and control-plane
events off ``trace.evt`` and drops the bulk, and a replica's fence
reject and promotion are noted on it eagerly.
"""

import importlib.util
import os

import pytest

from reflow_tpu.net import framing as jframing
from reflow_tpu.obs.flight import read_flight_dir as j_read_flight_dir
from reflow_tpu_torch import obs
from reflow_tpu_torch.net.framing import (HEADER, MAGIC, FrameError,
                                          TransportError, WireTimeout,
                                          decode_frame, encode_frame,
                                          frame_size, split_frames)
from reflow_tpu_torch.obs import flight
from reflow_tpu_torch.obs import trace as trace_mod
from reflow_tpu_torch.obs.flight import FlightRecorder, read_flight_dir
from reflow_tpu_torch.serve import ReplicaScheduler
from reflow_tpu_torch.wal import DurableScheduler, SegmentShipper
from reflow_tpu_torch.workloads import wordcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- framing ----------------------------------------------------------------

def test_frame_round_trip_and_split():
    msgs = [("subscribe",), ("ack", (0, 128), 7),
            ("blob", b"\x00" * 4096)]
    buf = b"".join(encode_frame(m) for m in msgs)
    got, consumed = split_frames(buf)
    assert got == msgs and consumed == len(buf)
    buf2 = buf + encode_frame(("tail",))[:-3]
    got2, consumed2 = split_frames(buf2)
    assert got2 == msgs and consumed2 == len(buf)


def test_frame_crc_and_magic_are_enforced():
    raw = encode_frame(("hello", 1))
    hdr = len(MAGIC) + HEADER.size
    header, payload = raw[:hdr], raw[hdr:]
    assert frame_size(header) == len(payload)
    assert decode_frame(header, payload) == ("hello", 1)
    flipped = bytearray(payload)
    flipped[-1] ^= 0x01
    with pytest.raises(FrameError):
        decode_frame(header, bytes(flipped))
    with pytest.raises(FrameError):
        decode_frame(b"XXNOPE00" + header[8:], payload)
    with pytest.raises(FrameError):
        decode_frame(header, payload[:-1])
    assert issubclass(FrameError, TransportError)
    assert issubclass(WireTimeout, TransportError)


def test_frames_identical_across_packages():
    msgs = [("ship", 3, 8, b"\x01\x02" * 300, 608, True, 4, 17, 1, None),
            ("ack", (4, 8), 17)]
    for m in msgs:
        assert encode_frame(m) == jframing.encode_frame(m)
    buf = b"".join(jframing.encode_frame(m) for m in msgs)
    assert split_frames(buf) == (msgs, len(buf))
    pbuf = b"".join(encode_frame(m) for m in msgs)
    assert jframing.split_frames(pbuf) == (msgs, len(pbuf))


# -- flight recorder --------------------------------------------------------

def test_flight_ring_rotates_and_respawn_archives_prev(tmp_path):
    corner = str(tmp_path / "n0" / "flight")
    rec = FlightRecorder(corner, node="n0", cap_bytes=8192, flush_every=1)
    for i in range(200):
        rec.record("ship_segment", float(i), 1.0, "wal",
                   {"cause": f"n0#0#{i}"})
    assert rec.rotations_total >= 1
    rec.note("promote", epoch=1, horizon=42)    # eager flush
    rec.close()
    rec2 = FlightRecorder(corner, node="n0", cap_bytes=8192, flush_every=1)
    rec2.note("breaker_open", graph="g0")
    rec2.close()
    names = sorted(os.listdir(corner))
    assert any(n.endswith(".prev") for n in names)
    with open(os.path.join(corner, "flight-a.jsonl"), "a") as f:
        f.write('{"seq": 999, "kind": "sp')
    rf = _load_tool("reflow_flight")
    merged = rf.merge([str(tmp_path)])
    assert "n0" in merged["nodes"]
    node = merged["nodes"]["n0"]
    assert node["files"] >= 2
    names = [ev["name"] for ev in merged["events"]]
    assert "promote" in names and "breaker_open" in names
    assert not any(ev.get("seq") == 999 for ev in merged["events"])
    # the JAX package reads the port's corner as its own
    port = [(f["header"]["node"], len(f["events"]))
            for f in read_flight_dir(corner)]
    assert port == [(f["header"]["node"], len(f["events"]))
                    for f in j_read_flight_dir(corner)]


def test_flight_publish_metrics_unregisters_on_close(tmp_path):
    reg = obs.MetricsRegistry()
    rec = FlightRecorder(str(tmp_path / "flight"), node="n0",
                         flush_every=4)
    rec.publish_metrics(reg)
    rec.record("sub_push", 0.0, 1.0, None, {"cause": "x#0#0"})
    snap = reg.snapshot()["gauges"]
    assert snap["flight.events_total"] == 1
    rec.close()
    assert "flight.events_total" not in reg.snapshot()["gauges"]


def test_installed_recorder_tees_causal_spans_and_notes(tmp_path,
                                                        monkeypatch):
    """``install`` hooks the recorder onto ``trace.evt``: spans that carry
    a cause and the always-record control set land on disk, the bulk
    does not; a replica's fence reject and a promotion are noted and
    flushed at once; ``uninstall`` unhooks it."""
    monkeypatch.setenv("REFLOW_FLEET_NODE", "port-node")
    assert obs.node_id() == "port-node"
    assert obs.clock_anchor()["node"] == "port-node"
    corner = str(tmp_path / "flight")
    trace_mod.reset()
    obs.enable()
    rec = flight.install(corner, flush_every=1000)
    try:
        assert flight.installed() is rec and rec.node == "port-node"
        trace_mod.evt("bulk_span", 0.0, 1.0, args={"n": 1})
        trace_mod.evt("tagged", 0.0, 1.0, args={"cause": "a#0#1"})
        trace_mod.evt("fence_reject", 0.0, 1.0, args={"kind": "append"})
        assert rec.events_total == 2
        g, src, _sink = wordcount.build_graph()
        sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                                 fsync="tick")
        ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
        r0 = ReplicaScheduler(wordcount.build_graph()[0],
                              str(tmp_path / "r0"), name="r0")
        ship.attach(r0)
        sched.push(src, wordcount.ingest_lines(["a b"]), batch_id="b0")
        sched.tick()
        sched.wal.sync()
        ship.pump_once()
        new = r0.promote(committer="inline")
        ship.pump_once()  # the epoch-0 shipper is now fenced out
        sched.push(src, wordcount.ingest_lines(["c"]), batch_id="b1")
        sched.tick()
        sched.wal.sync()
        ship.pump_once()
        assert r0.fence_rejected_shipments >= 1
        events = [e["name"] for f in read_flight_dir(corner)
                  for e in f["events"]]
        # noted eagerly: on disk with no flush or close
        assert "promote" in events and "fence_reject" in events
        assert "bulk_span" not in events
        new.close()
        sched.close()
    finally:
        flight.uninstall()
        obs.disable()
        trace_mod.reset()
    assert flight.installed() is None and trace_mod._flight_hook is None
    flight.note("after_uninstall")  # a no-op without a recorder
    flight.flush_now()
