"""The port's replication over the wire (``reflow_tpu_torch.net``):
framed transports, fault injection, reconnect/backoff and partition
tolerance, against ``tests/test_net.py`` and the JAX package, on the CPU.

Every test of ``tests/test_net.py`` has a counterpart here. The protocol
matrix runs over both transports: the in-process ``LoopbackTransport``
and real ``TcpTransport`` sockets on ``127.0.0.1`` (every wait bounded).
Fault-path tests drive ``WireFaults``/``FaultyTransport``
deterministically (scripted partitions/resets and probability-1 rates),
and the backoff/debounce state machines run on fake clocks with no real
sleeps. The tests that replicate a graph run over the port's CPU oracle
(string keys) and over its ``"cuda"`` executor at ``device="cpu"``
(integer keys interned into one vocabulary). The trace test writes the
Chrome trace with the port's ``obs.export_chrome_trace`` and reads it with
``tools/trace_inspect.py``.

Across the packages: a JAX ``SegmentShipper`` feeds a port replica over
TCP (through a port ``RemoteFollower``, and through a JAX one to a port
``ReplicaServer``), a port shipper feeds a JAX replica, each to the
leader's view exactly; and one seeded ``WireFaults`` schedule injects the
same faults at the same frames, byte for byte, in both packages.
"""

import importlib.util
import json
import os
import time

import numpy as np
import pytest

import reflow_tpu_torch as P
from reflow_tpu_torch.executors.cpu import CpuExecutor
from reflow_tpu_torch.net import (FaultyTransport, LoopbackTransport,
                                  ReconnectPolicy, RemoteFollower,
                                  ReplicaServer, TcpTransport,
                                  TransportError, WireTimeout)
from reflow_tpu_torch.net.framing import (HEADER, MAGIC, FrameError,
                                          decode_frame, encode_frame,
                                          frame_size, split_frames)
from reflow_tpu_torch.obs import REGISTRY
from reflow_tpu_torch.serve import (FailoverCoordinator, ReadTier,
                                    ReplicaScheduler)
from reflow_tpu_torch.utils.faults import WireFaults
from reflow_tpu_torch.wal import DurableScheduler, SegmentShipper
from reflow_tpu_torch.workloads import wordcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the executor the replicating tests run on (set by ``exe``)
_KIND = ["cpu"]
#: the words ``drive`` draws, interned once: a word's key is fixed
_VOCAB = {f"w{i}": i for i in range(40)}


@pytest.fixture(params=["cpu", "cuda"])
def exe(request):
    _KIND[0] = request.param
    yield request.param
    _KIND[0] = "cpu"


def _graph_and_executor():
    if _KIND[0] == "cuda":
        g, src, sink = wordcount.build_graph(64)
        return g, src, sink, P.get_executor("cuda", device="cpu")
    g, src, sink = wordcount.build_graph()
    return g, src, sink, CpuExecutor()


def make_leader(tmp_path, **kw):
    g, src, sink, ex = _graph_and_executor()
    sched = DurableScheduler(g, ex, wal_dir=str(tmp_path / "wal"),
                             fsync="tick", **kw)
    return sched, src, sink


def make_replica(tmp_path, name="r0"):
    g, _src, _sink, ex = _graph_and_executor()
    return ReplicaScheduler(g, str(tmp_path / name), executor=ex,
                            name=name)


def ingest(words: str):
    if _KIND[0] == "cuda":
        return wordcount.ingest_lines([words], vocab=dict(_VOCAB))
    return wordcount.ingest_lines([words])


def drive(sched, src, n_ticks, seed=0, start=0):
    rng = np.random.default_rng(seed + start)
    for t in range(start, start + n_ticks):
        for j in range(2):
            words = " ".join(
                f"w{int(x)}" for x in rng.integers(0, 40, 8))
            sched.push(src, ingest(words), batch_id=f"t{t}b{j}")
        sched.tick()


def live_view(sched, sink):
    return {kv: w for kv, w in sched.view(sink.name).items() if w != 0}


def fast_policy(name, **kw):
    """Real-clock policy tuned so tests never wait perceptibly."""
    kw.setdefault("base_s", 0.001)
    kw.setdefault("cap_s", 0.005)
    kw.setdefault("jitter", 0.0)
    return ReconnectPolicy(name, **kw)


def pump_until_caught(ship, sched, replicas, timeout_s=20.0):
    """Pump tolerant of link stalls: a remote follower mid-backoff
    makes whole passes report zero progress without being done."""
    sched.wal.sync()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ship.pump_once()
        if all(r.published_horizon() == sched._tick for r in replicas):
            return
        time.sleep(0.002)
    raise AssertionError(
        f"replicas stuck: leader tick {sched._tick}, horizons "
        f"{[r.published_horizon() for r in replicas]}")


# -- transports: one matrix, two implementations ----------------------------

TRANSPORTS = ["loopback", "tcp"]


def make_transports(kind):
    """(server_transport, client_transport) — loopback must share the
    instance (addresses are process-local), TCP must not."""
    if kind == "loopback":
        t = LoopbackTransport()
        return t, t
    return TcpTransport(), TcpTransport()


# -- framing ----------------------------------------------------------------

def test_frame_round_trip_and_split():
    msgs = [("subscribe",), ("ack", (0, 128), 7),
            ("blob", b"\x00" * 4096)]
    buf = b"".join(encode_frame(m) for m in msgs)
    got, consumed = split_frames(buf)
    assert got == msgs and consumed == len(buf)
    # a partial tail frame stays unconsumed in the buffer
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
    flipped[-1] ^= 0x01            # payload bit flip: CRC mismatch
    with pytest.raises(FrameError):
        decode_frame(header, bytes(flipped))
    with pytest.raises(FrameError):
        decode_frame(b"XXNOPE00" + header[8:], payload)
    with pytest.raises(FrameError):
        decode_frame(header, payload[:-1])     # truncated payload


# -- transport matrix -------------------------------------------------------

@pytest.mark.parametrize("kind", TRANSPORTS)
def test_transport_round_trip_and_close(kind):
    st, ct = make_transports(kind)
    lst = st.listen()
    conn = ct.connect(lst.address, timeout_s=2.0)
    srv = lst.accept(timeout_s=2.0)
    big = ("payload", b"\xab" * (1 << 20))
    conn.send_msg(big, 2.0)
    assert srv.recv_msg(2.0) == big
    srv.send_msg(("ok",), 2.0)
    assert conn.recv_msg(2.0) == ("ok",)
    srv.close()
    with pytest.raises(TransportError):
        for _ in range(64):        # close may race one buffered frame
            conn.recv_msg(0.2)
    lst.close()


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_transport_idle_timeout_is_wire_timeout(kind):
    st, ct = make_transports(kind)
    lst = st.listen()
    conn = ct.connect(lst.address, timeout_s=2.0)
    srv = lst.accept(timeout_s=2.0)
    t0 = time.monotonic()
    with pytest.raises(WireTimeout):
        conn.recv_msg(0.05)
    assert time.monotonic() - t0 < 5.0
    # an idle timeout is NOT fatal: the link still works afterwards
    srv.send_msg(("late",), 2.0)
    assert conn.recv_msg(2.0) == ("late",)
    conn.close()
    srv.close()
    lst.close()


# -- server/client protocol matrix ------------------------------------------

@pytest.mark.parametrize("kind", TRANSPORTS)
def test_remote_follower_ships_exact_parity(tmp_path, kind, exe):
    st, ct = make_transports(kind)
    sched, src, sink = make_leader(tmp_path, segment_bytes=2048)
    replica = make_replica(tmp_path)
    srv = ReplicaServer(replica, st).start()
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    link = RemoteFollower(ct, srv.address, name="r0",
                          policy=fast_policy("r0"), io_timeout_s=2.0)
    ship.attach(link)
    drive(sched, src, 8)
    pump_until_caught(ship, sched, [replica])
    h, got = replica.view_at(sink.name)
    assert h == sched._tick
    assert got == live_view(sched, sink)
    assert link.conn_state == "healthy"
    snap = link.transport_snapshot()
    assert snap["state"] == "healthy" and snap["failures"] == 0
    ping = link.ping()
    assert ping["name"] == "r0" and ping["horizon"] == sched._tick
    srv.close()
    sched.close()
    replica.close()


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_server_answers_err_for_unknown_op(kind):
    st, ct = make_transports(kind)
    replica = object()  # never reached by an unknown op
    srv = ReplicaServer(replica, st).start()
    conn = ct.connect(srv.address, timeout_s=2.0)
    conn.send_msg(("warp", 9), 2.0)
    resp = conn.recv_msg(2.0)
    assert resp[0] == "err" and "warp" in resp[1]
    conn.close()
    srv.close()


# -- fault paths (deterministic: scripted switches, probability-1 rates) ----

def _wired_cluster(tmp_path, faults, **link_kw):
    t = LoopbackTransport()
    sched, src, sink = make_leader(tmp_path)
    replica = make_replica(tmp_path)
    srv = ReplicaServer(replica, t).start()
    link_kw.setdefault("policy", fast_policy("r0"))
    link_kw.setdefault("io_timeout_s", 0.2)
    link = RemoteFollower(FaultyTransport(t, faults), srv.address,
                          name="r0", **link_kw)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    ship.attach(link)
    return sched, src, sink, replica, srv, link, ship


def test_partition_drives_unreachable_then_heal_resyncs(tmp_path, exe):
    faults = WireFaults()
    sched, src, sink, replica, srv, link, ship = _wired_cluster(
        tmp_path, faults)
    drive(sched, src, 2)
    pump_until_caught(ship, sched, [replica])
    faults.partition("c2s")
    sched_tick_before = replica.published_horizon()
    drive(sched, src, 2, start=2)
    sched.wal.sync()
    deadline = time.monotonic() + 10
    while link.conn_state != "unreachable" \
            and time.monotonic() < deadline:
        ship.pump_once()
        time.sleep(0.002)
    assert link.conn_state == "unreachable"
    assert replica.published_horizon() == sched_tick_before  # no leak
    assert ship.link_stalls > 0 and ship.nacks == 0
    faults.heal()
    pump_until_caught(ship, sched, [replica])
    assert link.conn_state == "healthy"
    assert link.reconnects_total >= 1
    h, got = replica.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    # loss forced the WAL-as-retransmit-buffer path for real
    assert ship.retransmit_bytes > 0
    srv.close()
    sched.close()
    replica.close()


def test_scripted_reset_reconnects_idempotently(tmp_path, exe):
    faults = WireFaults()
    sched, src, sink, replica, srv, link, ship = _wired_cluster(
        tmp_path, faults)
    drive(sched, src, 3)
    pump_until_caught(ship, sched, [replica])
    before = live_view(sched, sink)
    faults.reset_once(1)
    drive(sched, src, 3, start=3)
    pump_until_caught(ship, sched, [replica])
    assert link.reconnects_total >= 1
    h, got = replica.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    assert got != before  # the post-reset windows actually landed
    srv.close()
    sched.close()
    replica.close()


def test_corrupt_payload_is_nacked_by_record_crc(tmp_path, exe):
    # frame CRC passes (the flip happens before framing); the replica's
    # record-level CRC must reject the shipment and NACK its cursor
    faults = WireFaults()
    sched, src, sink, replica, srv, link, ship = _wired_cluster(
        tmp_path, faults)
    drive(sched, src, 2)
    pump_until_caught(ship, sched, [replica])
    faults.set_rates(corrupt_payload=1.0)
    drive(sched, src, 2, start=2)
    sched.wal.sync()
    deadline = time.monotonic() + 10
    while ship.nacks == 0 and time.monotonic() < deadline:
        ship.pump_once()
        time.sleep(0.002)
    assert ship.nacks >= 1
    faults.quiesce()
    pump_until_caught(ship, sched, [replica])
    h, got = replica.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    srv.close()
    sched.close()
    replica.close()


def test_corrupt_frame_resets_connection_then_recovers(tmp_path, exe):
    faults = WireFaults()
    sched, src, sink, replica, srv, link, ship = _wired_cluster(
        tmp_path, faults)
    drive(sched, src, 2)
    pump_until_caught(ship, sched, [replica])
    faults.set_rates(corrupt_frame=1.0)
    drive(sched, src, 2, start=2)
    sched.wal.sync()
    deadline = time.monotonic() + 10
    while link.link_failures == 0 and time.monotonic() < deadline:
        ship.pump_once()
        time.sleep(0.002)
    assert link.link_failures >= 1      # desynced stream = link failure
    faults.quiesce()
    pump_until_caught(ship, sched, [replica])
    assert srv.frame_resets >= 1
    h, got = replica.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    srv.close()
    sched.close()
    replica.close()


def test_duplicates_and_reorders_never_skew_state(tmp_path, exe):
    # every ack/nack carries the receiver's authoritative cursor, so a
    # mis-paired response is still a true statement — parity must hold
    faults = WireFaults()
    sched, src, sink, replica, srv, link, ship = _wired_cluster(
        tmp_path, faults)
    faults.set_rates(dup=0.5, reorder=0.5)
    drive(sched, src, 6)
    sched.wal.sync()
    deadline = time.monotonic() + 20
    while replica.published_horizon() != sched._tick \
            and time.monotonic() < deadline:
        ship.pump_once()
        time.sleep(0.002)
    faults.quiesce()
    pump_until_caught(ship, sched, [replica])
    assert faults.stats["dup"] + faults.stats["reorder"] > 0
    h, got = replica.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    srv.close()
    sched.close()
    replica.close()


def test_drop_s2c_applies_but_retransmits(tmp_path, exe):
    # a dropped RESPONSE means the server applied and the client never
    # heard: the re-offer is counted as retransmission and the dedup/
    # cursor machinery keeps the replay exactly-once
    faults = WireFaults()
    sched, src, sink, replica, srv, link, ship = _wired_cluster(
        tmp_path, faults)
    drive(sched, src, 2)
    pump_until_caught(ship, sched, [replica])
    faults.set_rates(drop_s2c=1.0)
    drive(sched, src, 2, start=2)
    sched.wal.sync()
    for _ in range(8):
        ship.pump_once()
        time.sleep(0.002)
    faults.quiesce()
    pump_until_caught(ship, sched, [replica])
    assert faults.stats["drop_s2c"] >= 1
    assert ship.retransmit_bytes > 0
    h, got = replica.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    srv.close()
    sched.close()
    replica.close()


# -- backoff state machine (fake clock, no sleeps) --------------------------

def test_backoff_growth_caps_and_states():
    clk = FakeClock()
    p = ReconnectPolicy("r0", base_s=0.1, cap_s=0.8, jitter=0.0,
                        degraded_after=1, unreachable_after=4,
                        clock=clk)
    assert p.state == "connecting"
    delays = [p.failed() for _ in range(6)]
    assert delays == [0.1, 0.2, 0.4, 0.8, 0.8, 0.8]  # 2^n capped
    assert p.state == "unreachable"
    assert not p.due()                      # gated until the clock moves
    assert p.seconds_until_due() == pytest.approx(0.8)
    clk.advance(0.8)
    assert p.due()
    assert p.ok() is True                   # a failure run just ended
    assert p.state == "healthy" and p.failures == 0
    assert p.reconnects == 1
    assert p.ok() is False                  # steady-state ok: no event
    snap = p.snapshot()
    assert snap["state"] == "healthy" and snap["reconnects"] == 1


def test_backoff_jitter_is_bounded_and_seeded():
    clk = FakeClock()
    a = ReconnectPolicy("r0", base_s=0.1, cap_s=10.0, jitter=0.25,
                        seed=7, clock=clk)
    b = ReconnectPolicy("r0", base_s=0.1, cap_s=10.0, jitter=0.25,
                        seed=7, clock=clk)
    da = [a.failed() for _ in range(8)]
    db = [b.failed() for _ in range(8)]
    assert da == db                          # same seed+name: same storm
    for i, d in enumerate(da):
        raw = min(10.0, 0.1 * 2 ** i)
        assert raw * 0.75 <= d <= raw * 1.25
    c = ReconnectPolicy("r1", base_s=0.1, cap_s=10.0, jitter=0.25,
                        seed=7, clock=clk)
    assert [c.failed() for _ in range(8)] != da  # per-name decorrelated


def test_backoff_degraded_threshold_and_recovery_cycle():
    clk = FakeClock()
    p = ReconnectPolicy("r0", base_s=0.05, cap_s=1.0, jitter=0.0,
                        degraded_after=2, unreachable_after=3,
                        clock=clk)
    p.failed()
    assert p.state == "connecting"      # below degraded_after, no flap
    p.failed()
    assert p.state == "degraded"
    p.failed()
    assert p.state == "unreachable"
    clk.advance(10)
    p.ok()
    assert p.state == "healthy"
    p.failed()
    # one failure below degraded_after: still nominally healthy, and
    # the backoff growth restarted from base
    assert p.state == "healthy" and p.failures == 1
    assert p.last_backoff_s == pytest.approx(0.05)


# -- partition detection (fake clock, _stub_coord style) --------------------

class _StubReplica:
    def __init__(self, name, horizon):
        self.name = name
        self._h = horizon
        self.promoted = False

    def published_horizon(self):
        return self._h


def _stub_coord(sample, **kw):
    calls = []

    def promote_fn(winner, epoch):
        calls.append((winner.name, epoch))
        return object()

    kw.setdefault("confirm_intervals", 2)
    coord = FailoverCoordinator(
        [_StubReplica("a", 5), _StubReplica("b", 7)],
        sampler=sample, promote_fn=promote_fn, **kw)
    return coord, calls


def test_partitioned_sample_fires_debounced():
    clk = FakeClock()
    part = {"v": False}
    coord, calls = _stub_coord(
        lambda now: {"committer_dead": False, "pump_failed": False,
                     "beat": 1, "partitioned": part["v"]})
    assert coord.step(clk.advance(0.05)) == []
    part["v"] = True
    assert coord.step(clk.advance(0.05)) == []        # streak 1 of 2
    acts = coord.step(clk.advance(0.05))              # streak 2: fire
    assert [a["kind"] for a in acts] == ["failover_promote"]
    assert acts[0]["reason"] == "leader_partitioned"
    assert calls == [("b", 1)]
    assert coord.partitions_detected == 1


def test_partition_flapping_never_fires():
    clk = FakeClock()
    seq = iter([True, False] * 10)
    coord, calls = _stub_coord(
        lambda now: {"committer_dead": False, "pump_failed": False,
                     "beat": 1, "partitioned": next(seq)})
    for _ in range(10):
        assert coord.step(clk.advance(0.05)) == []
    assert calls == [] and coord.partitions_detected == 0


def test_heartbeat_stall_with_live_committer_is_partition():
    # a stalled beat while the committer provably lives is a partition,
    # not a death — the reason must say so (the bare-stall label
    # "heartbeat_timeout" is pinned by test_failover)
    clk = FakeClock()
    coord, calls = _stub_coord(
        lambda now: {"committer_dead": False, "pump_failed": False,
                     "beat": 1, "committer_alive": True},
        heartbeat_timeout_s=0.2, confirm_intervals=2)
    coord.step(clk.advance(0.05))
    coord.step(clk.advance(0.3))                      # stale: streak 1
    acts = coord.step(clk.advance(0.3))               # streak 2: fire
    assert acts[0]["reason"] == "leader_partitioned"
    assert coord.partitions_detected == 1


# -- read tier ejection / restore -------------------------------------------

class _FakeLink:
    def __init__(self, state="healthy"):
        self.conn_state = state


class _FakeReplica:
    def __init__(self, name, horizon=10, fail=None):
        self.name = name
        self._h = horizon
        self.fail = fail
        self.reads = 0

    def published_horizon(self):
        return self._h

    def lag_ticks(self):
        return 0

    def top_k(self, sink, k, by="weight"):
        if self.fail is not None:
            raise self.fail
        self.reads += 1
        return self._h, [((sink, "x"), 1.0)]


def test_read_tier_ejects_unreachable_link_and_restores():
    r0, r1 = _FakeReplica("r0"), _FakeReplica("r1")
    link = _FakeLink()
    tier = ReadTier([r0, r1])
    tier.bind_link(r0, link)
    link.conn_state = "unreachable"
    for _ in range(4):
        res = tier.top_k("s", 1)
        assert res.source == "r1"
    assert tier.ejects == 1
    assert any(r is r0 for r in tier.ejected_replicas)
    assert r0.reads == 0
    link.conn_state = "healthy"
    sources = {tier.top_k("s", 1).source for _ in range(4)}
    assert sources == {"r0", "r1"}        # restored into rotation
    assert tier.restores == 1


def test_read_tier_ejects_on_link_flavored_read_error():
    r0 = _FakeReplica("r0", fail=ConnectionError("peer gone"))
    r1 = _FakeReplica("r1")
    tier = ReadTier([r0, r1])
    tier.bind_link(r0, _FakeLink("unreachable"))
    res = tier.top_k("s", 1)
    assert res.source == "r1" and tier.ejects == 1
    # a StaleRead-path value error still propagates (not link-flavored)
    r1.fail = ValueError("boom")
    with pytest.raises(ValueError):
        tier.top_k("s", 1)


# -- observability surfaces --------------------------------------------------

def test_conn_state_gauges_and_transport_sidecar(tmp_path):
    t = LoopbackTransport()
    sched, src, sink = make_leader(tmp_path)
    replica = make_replica(tmp_path)
    srv = ReplicaServer(replica, t).start()
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    link = RemoteFollower(t, srv.address, name="r0",
                          policy=fast_policy("r0"), io_timeout_s=0.5)
    ship.attach(link)
    ship.publish_metrics()
    try:
        drive(sched, src, 3)
        pump_until_caught(ship, sched, [replica])
        assert REGISTRY.value("replica.r0.conn_state", "?") == "healthy"
        assert REGISTRY.value("net.reconnects_total", -1) == 0
        assert REGISTRY.value("net.retransmit_bytes", -1) >= 0

        state = json.load(
            open(os.path.join(sched.wal.wal_dir, "ship-state.json")))
        assert state["transport"]["r0"]["state"] == "healthy"

        wi = _load_tool("wal_inspect")
        summary = wi.inspect(sched.wal.wal_dir, verbose=False)
        tsec = summary["shipping"]["transport"]
        assert tsec["r0"]["state"] == "healthy"
        assert tsec["r0"]["reconnects"] == 0
        assert tsec["r0"]["retransmit_bytes"] == 0
        assert "last_backoff_s" in tsec["r0"]
    finally:
        ship.close()
        srv.close()
        sched.close()
        replica.close()


def test_net_trace_spans_surface_in_trace_inspect(tmp_path, capsys):
    from reflow_tpu_torch import obs
    obs.enable()
    try:
        t = LoopbackTransport()
        sched, src, sink = make_leader(tmp_path)
        replica = make_replica(tmp_path)
        srv = ReplicaServer(replica, t).start()
        ship = SegmentShipper(sched.wal,
                              leader_tick=lambda: sched._tick)
        link = RemoteFollower(t, srv.address, name="r0",
                              policy=fast_policy("r0"),
                              io_timeout_s=0.5)
        ship.attach(link)
        drive(sched, src, 3)
        pump_until_caught(ship, sched, [replica])
        path = str(tmp_path / "trace.json")
        obs.export_chrome_trace(path)
        ti = _load_tool("trace_inspect")
        assert ti.main([path, "--json"]) == 0
        out = json.loads(capsys.readouterr().out)
        net = out["network"]["r0"]
        assert net["sends"] >= 1 and net["send_failures"] == 0
        assert "receive" in net["ops"]
        assert net["last_state"] == "healthy"
        ship.close()
        srv.close()
        sched.close()
        replica.close()
    finally:
        obs.disable()


# -- protocol responses remain the shipping tuples --------------------------

def test_remote_follower_receive_speaks_ack_nack(tmp_path):
    t = LoopbackTransport()
    sched, src, sink = make_leader(tmp_path)
    replica = make_replica(tmp_path)
    srv = ReplicaServer(replica, t).start()
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    link = RemoteFollower(t, srv.address, name="r0",
                          policy=fast_policy("r0"), io_timeout_s=0.5)
    cur = link.subscribe()
    assert cur is None or isinstance(cur, tuple)
    drive(sched, src, 1)
    sched.wal.sync()
    ship.attach(link)
    deadline = time.monotonic() + 10
    while replica.published_horizon() != sched._tick \
            and time.monotonic() < deadline:
        ship.pump_once()
        time.sleep(0.002)
    # the link's receive() really returned ShipAck objects to the
    # shipper (cursor advanced past subscribe, zero nacks)
    st = ship._followers["r0"]
    assert st.nacks == 0 and st.cursor is not None
    assert replica.published_horizon() == sched._tick
    srv.close()
    sched.close()
    replica.close()


# -- across the packages ------------------------------------------------------

class _JaxFacing:
    """A port ``RemoteFollower`` attached to a JAX shipper: shipments go
    in as the port's tuples and the replica's answers come back as the
    JAX package's (None, "no progress", passes as it is). The wire needs
    no such bridge; only the in-process shipper API is package-typed."""

    def __init__(self, link):
        import reflow_tpu.wal.ship as jship

        import reflow_tpu_torch.wal.ship as pship

        self.link = link
        self.name = link.name
        self._in = pship.Shipment
        self._out = {pship.ShipAck: jship.ShipAck,
                     pship.ShipNack: jship.ShipNack}

    def subscribe(self):
        return self.link.subscribe()

    def receive(self, sh):
        resp = self.link.receive(self._in(*sh))
        return None if resp is None else self._out[type(resp)](*resp)


def _jax_leader(tmp_path):
    from reflow_tpu.wal import DurableScheduler as JD
    from reflow_tpu.workloads import wordcount as jwc

    g, src, sink = jwc.build_graph()
    return JD(g, wal_dir=str(tmp_path / "wal"), fsync="tick",
              segment_bytes=2048), src, sink


def _jdrive(sched, src, n_ticks):
    from reflow_tpu.workloads import wordcount as jwc

    rng = np.random.default_rng(3)
    for t in range(n_ticks):
        for j in range(2):
            words = " ".join(f"w{int(x)}" for x in rng.integers(0, 40, 8))
            sched.push(src, jwc.ingest_lines([words]), batch_id=f"t{t}b{j}")
        sched.tick()


@pytest.mark.parametrize("route", ["jax_shipper_port_follower",
                                   "jax_follower_port_server",
                                   "port_follower_jax_server"])
def test_replication_over_tcp_across_packages(tmp_path, route):
    """A shipper of one package feeds, over TCP, a replica of the other
    from segment 0, across segment rotations, to the leader's view
    exactly: through a port ``RemoteFollower`` on a JAX shipper, through
    a JAX follower to a port ``ReplicaServer``, and through a port
    follower to a JAX server."""
    from reflow_tpu.net import RemoteFollower as JRemoteFollower
    from reflow_tpu.net import ReplicaServer as JReplicaServer
    from reflow_tpu.net import TcpTransport as JTcp
    from reflow_tpu.serve import ReplicaScheduler as JReplica
    from reflow_tpu.wal import SegmentShipper as JShipper
    from reflow_tpu.workloads import wordcount as jwc

    if route == "port_follower_jax_server":
        sched, src, sink = make_leader(tmp_path, segment_bytes=2048)
        replica = JReplica(jwc.build_graph()[0], str(tmp_path / "r0"),
                           name="r0")
        srv = JReplicaServer(replica, JTcp()).start()
        ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
        ship.attach(RemoteFollower(TcpTransport(), srv.address, name="r0",
                                   policy=fast_policy("r0"),
                                   io_timeout_s=2.0))
        drive(sched, src, 8)
    else:
        sched, src, sink = _jax_leader(tmp_path)
        replica = make_replica(tmp_path)
        srv = ReplicaServer(replica, TcpTransport()).start()
        ship = JShipper(sched.wal, leader_tick=lambda: sched._tick)
        if route == "jax_shipper_port_follower":
            ship.attach(_JaxFacing(RemoteFollower(
                TcpTransport(), srv.address, name="r0",
                policy=fast_policy("r0"), io_timeout_s=2.0)))
        else:
            from reflow_tpu.net import ReconnectPolicy as JPolicy

            ship.attach(JRemoteFollower(
                JTcp(), srv.address, name="r0",
                policy=JPolicy("r0", base_s=0.001, cap_s=0.005,
                               jitter=0.0), io_timeout_s=2.0))
        _jdrive(sched, src, 8)
    try:
        pump_until_caught(ship, sched, [replica])
        h, got = replica.view_at(sink.name)
        assert h == sched._tick == 8
        assert got == live_view(sched, sink)
        assert ship.nacks == 0
    finally:
        ship.close()
        srv.close()
        sched.close()
        replica.close()


class _Sink:
    """An inner conn that keeps every frame written to it and answers
    each read with the same small reply: the fault schedule's effect on
    the bytes, with no socket and no timing."""

    def __init__(self):
        self.frames = []
        self.closes = 0

    def send_raw(self, data, timeout_s=None):
        self.frames.append(bytes(data))
        return len(data)

    def recv_msg(self, timeout_s=None):
        return ("ack", (0, 0), 0)

    def close(self):
        self.closes += 1

    @property
    def alive(self):
        return True


def _fault_run(pkg):
    if pkg == "jax":
        from reflow_tpu.net.faults import FaultyConn as FC
        from reflow_tpu.utils.faults import WireFaults as WF
        from reflow_tpu.net.framing import TransportError as TE
    else:
        from reflow_tpu_torch.net.faults import FaultyConn as FC
        WF, TE = WireFaults, TransportError
    faults = WF(seed=13, drop_c2s_p=0.05, drop_s2c_p=0.05, dup_p=0.05,
                reorder_p=0.05, corrupt_frame_p=0.05,
                corrupt_payload_p=0.05, reset_p=0.05)
    inner = _Sink()
    conn = FC(inner, faults)
    outcomes = []
    rng = np.random.default_rng(4)
    for i in range(300):
        if i == 100:
            faults.reset_once(2)
        if i == 150:
            faults.partition("s2c")
        if i == 170:
            faults.heal()
        msg = ("receive", (i, i * 64), rng.bytes(48), i % 7, None, 5)
        try:
            conn.send_msg(msg, 1.0)
            sent = "sent"
        except TE as e:
            sent = str(e)
        try:
            got = conn.recv_msg(1.0)
        except TE as e:
            got = str(e)
        outcomes.append((sent, got, len(inner.frames)))
    return outcomes, inner.frames, inner.closes, faults.snapshot()


def test_wire_faults_same_schedule_both_packages():
    """One seeded schedule (every per-message fault at 5%, scripted resets
    and a one-way partition on a timeline) through each package's
    ``FaultyConn``: the same fault lands on the same frame, the bytes that
    reach the wire (flipped bits included) are identical, and so are the
    fault counts."""
    j = _fault_run("jax")
    p = _fault_run("port")
    assert p[0] == j[0]
    assert p[1] == j[1]
    assert p[2] == j[2] and p[3] == j[3]
    stats = p[3]
    for k in WireFaults.OUTCOMES:
        assert stats[k] > 0, k
    assert stats["scripted_resets"] == 2 and stats["partitioned"] > 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_started_frame_outlives_the_idle_poll(pkg):
    """A server polls ``recv_msg`` in short slices (0.2 s); a large
    frame whose bytes keep arriving past the slice must still be read
    whole. The port reads a started frame's rest under the I/O timeout;
    the JAX transport cuts it off at the slice and resets the link (a
    shipped 50 MB record over TCP does this, ROADMAP Queue 3)."""
    import threading

    if pkg == "jax":
        from reflow_tpu.net import TcpTransport as T
        from reflow_tpu.net import TransportError as TE
        from reflow_tpu.net.framing import encode_frame as enc
    else:
        T, TE, enc = TcpTransport, TransportError, encode_frame
    lst = T().listen()
    client = T().connect(lst.address, timeout_s=2.0)
    server = lst.accept(timeout_s=2.0)
    msg = ("receive", b"\x5a" * (1 << 16))
    frame = enc(msg)
    client.send_raw(frame[:32], 2.0)

    def rest():
        time.sleep(0.3)
        client.send_raw(frame[32:], 2.0)

    th = threading.Thread(target=rest)
    th.start()
    try:
        if pkg == "port":
            assert server.recv_msg(timeout_s=0.2) == msg
        else:
            with pytest.raises(TE, match="mid-frame"):
                server.recv_msg(timeout_s=0.2)
    finally:
        th.join()
        client.close()
        server.close()
        lst.close()
