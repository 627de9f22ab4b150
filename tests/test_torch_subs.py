"""The port's reactive reads (``reflow_tpu_torch.subs``) against
``tests/test_subs.py`` and the JAX package, on the CPU.

Every test of ``tests/test_subs.py`` has a counterpart here (the two
``ControlPlane(subs=)`` tests are in ``tests/test_torch_control.py``: the
ladder over a port ``SubscriptionHub``, and the hub whose ``load`` raises).
The invariants, each a hard assert: a delta-reconstructed answer equals
the pull path at the same horizon for every query kind, through
conflation, shedding, a crash rebase and a reconnect; a wire subscriber
resumes from its one-integer cursor with no gap and no duplicate; the
apply path never blocks on fan-out.

Across the packages: a JAX ``Subscriber`` resumes against a port
``SubscriptionServer`` through a reset, and a port one against a JAX
server, with no gap and no duplicate; ``SubscribeReq``, ``SubAck`` and
``frames_to_wire`` pickle to the same bytes in both; and the same stream
through both packages' stacks answers the same polls with the same bytes.
The ``cuda``-marked test runs a hub on a replica over the ``"cuda"``
executor of a small k-NN graph; it skips without a card.
"""

import pickle
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import reflow_tpu.subs as jsubs
from reflow_tpu.net import TcpTransport as JTcpTransport
from reflow_tpu.serve import ReplicaScheduler as JReplicaScheduler
from reflow_tpu.subs import query as jquery
from reflow_tpu.wal import DurableScheduler as JDurableScheduler
from reflow_tpu.wal import SegmentShipper as JSegmentShipper
from reflow_tpu.workloads import wordcount as jwordcount
import reflow_tpu_torch as P
from reflow_tpu_torch.net import (LoopbackTransport, ReconnectPolicy,
                                  TcpTransport)
from reflow_tpu_torch.obs import MetricsRegistry
from reflow_tpu_torch.serve import ReplicaScheduler
from reflow_tpu_torch.subs import (DeltaFrame, QueryState, SubAck,
                                   SubscribeReq, Subscriber,
                                   SubscriptionHub, SubscriptionServer,
                                   canon_query, merge_frames)
from reflow_tpu_torch.subs import query as pquery
from reflow_tpu_torch.subs.cli import SUB_SCHEMA, make_update, render_update
from reflow_tpu_torch.subs.query import topk_rows
from reflow_tpu_torch.utils.faults import CrashInjector
from reflow_tpu_torch.wal import DurableScheduler, SegmentShipper
from reflow_tpu_torch.workloads import knn, wordcount

#: each package's stack parts: (DurableScheduler, SegmentShipper,
#: ReplicaScheduler, SubscriptionHub, wordcount)
STACKS = {
    "port": (DurableScheduler, SegmentShipper, ReplicaScheduler,
             SubscriptionHub, wordcount),
    "jax": (JDurableScheduler, JSegmentShipper, JReplicaScheduler,
            jsubs.SubscriptionHub, jwordcount),
}


def make_stack(tmp_path, pkg="port", **hub_kw):
    """Leader -> shipper -> replica -> hub, all in-process."""
    Durable, Shipper, Replica, Hub, wc = STACKS[pkg]
    g, src, sink = wc.build_graph()
    sched = Durable(g, wal_dir=str(tmp_path / f"{pkg}-wal"), fsync="tick")
    ship = Shipper(sched.wal, leader_tick=lambda: sched._tick)
    g2, _s, _k = wc.build_graph()
    rep = Replica(g2, str(tmp_path / f"{pkg}-r0"), name="r0")
    ship.attach(rep)
    hub_kw.setdefault("idle_poll_s", 0.005)
    hub = Hub(rep, name="r0", **hub_kw)
    rep.attach_hub(hub)
    return sched, ship, rep, hub, src, sink


def drive(sched, src, n_ticks, seed=0, start=0, vocab=40, wc=wordcount):
    rng = np.random.default_rng(seed + start)
    for t in range(start, start + n_ticks):
        for j in range(2):
            words = " ".join(
                f"w{int(x)}" for x in rng.integers(0, vocab, 8))
            sched.push(src, wc.ingest_lines([words]),
                       batch_id=f"t{t}b{j}")
        sched.tick()


def pump_until_caught(ship, sched, rep, max_rounds=200):
    sched.wal.sync()
    for _ in range(max_rounds):
        ship.pump_once()
        if rep.published_horizon() == sched._tick:
            return
    raise AssertionError(
        f"replica stuck at {rep.published_horizon()}, "
        f"leader at {sched._tick}")


def close_stack(sched, ship, hub):
    hub.close()
    sched.close()


def pull_value(rep, sink, query):
    """The pull-path answer for ``query`` (the parity oracle). For topk
    the oracle is the deterministic ranking over the pull view; the
    ranked weights are cross-checked against ``top_k``."""
    if query.kind == "view":
        return rep.view_at(sink.name)[1]
    if query.kind == "lookup":
        return rep.lookup(sink.name, query.params[0])[1]
    k, by = query.params
    ranked = topk_rows(rep.view_at(sink.name)[1], k, by)
    pulled = rep.top_k(sink.name, k, by=by)[1]
    assert [w for _kv, w in ranked] == [w for _kv, w in pulled]
    return ranked


# -- the frame contiguity rule (pure) ---------------------------------------

def test_query_state_contiguity_counts_dups_and_gaps():
    """The port's ``QueryState`` and the JAX one take the same frames to
    the same state and counters at every step."""
    frames = [
        DeltaFrame(0, 1, "view", ((("a", 1.0), 1),), False),   # gap
        DeltaFrame(-1, 3, "view", ((("a", 1.0), 2),), True),
        DeltaFrame(3, 5, "view", ((("b", 1.0), 1),), False),
        DeltaFrame(4, 7, "view", ((("a", 1.0), -2),), False),
        DeltaFrame(5, 7, "view", ((("b", 1.0), 9),), False),   # dup
        DeltaFrame(9, 11, "view", ((("c", 1.0), 1),), False),  # gap
    ]
    st = QueryState(canon_query("s", "view"))
    jst = jquery.QueryState(jquery.canon_query("s", "view"))
    applied = []
    for f in frames:
        applied.append(st.apply(f))
        assert jst.apply(jquery.DeltaFrame(*f)) == applied[-1]
        assert (st.horizon, st.value(), st.gaps, st.dups_skipped) == \
            (jst.horizon, jst.value(), jst.gaps, jst.dups_skipped)
    assert applied == [False, True, True, True, False, False]
    assert st.horizon == 7 and st.value() == {("b", 1.0): 1}
    assert st.gaps == 2 and st.dups_skipped == 1
    # an empty poll's horizon advances past changeless windows; a stale
    # heartbeat never rewinds
    st.note_horizon(10)
    assert st.horizon == 10
    st.note_horizon(4)
    assert st.horizon == 10
    # a snapshot at a lower horizon is a deliberate rewind: accepted
    assert st.apply(DeltaFrame(-1, 2, "view", (), True))
    assert st.horizon == 2 and st.value() == {}


def test_merge_frames_matches_sequential_apply():
    frames = [
        DeltaFrame(-1, 2, "view", ((("a", 1.0), 2), (("b", 1.0), 1)),
                   True),
        DeltaFrame(2, 4, "view", ((("a", 1.0), -2), (("c", 1.0), 3)),
                   False),
        DeltaFrame(4, 5, "view", ((("c", 1.0), -1),), False),
    ]
    seq = QueryState(canon_query("s", "view"))
    for f in frames:
        seq.apply(f)
    merged = merge_frames(frames)
    assert merged.snapshot and merged.to_h == 5
    assert tuple(merged) == tuple(jquery.merge_frames(
        [jquery.DeltaFrame(*f) for f in frames]))
    one = QueryState(canon_query("s", "view"))
    one.apply(merged)
    assert one.value() == seq.value() and one.horizon == seq.horizon
    assert not any(kv == ("a", 1.0) for kv, _w in merged.rows)
    # topk conflation keeps only the newest ranked list
    t1 = DeltaFrame(0, 1, "topk", ((("a", 1.0), 5),), False)
    t2 = DeltaFrame(1, 3, "topk", ((("b", 1.0), 9),), False)
    m = merge_frames([t1, t2])
    assert m.rows == t2.rows and (m.from_h, m.to_h) == (0, 3)


def test_wire_messages_pickle_identically_across_packages():
    """What goes on the wire is plain tuples: the subscribe request, the
    ack and the frames pickle to the same bytes in both packages (never
    under the NamedTuple classes' names)."""
    req = ("counts", "topk", (5, "value"), 7, 2, "tok-1")
    assert pickle.dumps(("sub",) + tuple(SubscribeReq(*req))) == \
        pickle.dumps(("sub",) + tuple(jsubs.SubscribeReq(*req)))
    assert pickle.dumps(("sub",) + tuple(SubscribeReq("counts"))) == \
        pickle.dumps(("sub",) + tuple(jsubs.SubscribeReq("counts")))
    ack = ("tok-1", 12, "resume")
    assert pickle.dumps(("ok",) + tuple(SubAck(*ack))) == \
        pickle.dumps(("ok",) + tuple(jsubs.SubAck(*ack)))
    frames = [DeltaFrame(0, 4, "view", ((("k", 1.0), 1),), False),
              DeltaFrame(-1, 4, "topk", ((("k", 1.0), 2),), True),
              DeltaFrame(4, 6, "lookup", ((("k", 1.0), -1),), False,
                         ("p#0#1", "p#0#2"))]
    wire = pquery.frames_to_wire(frames)
    assert pickle.dumps(wire) == pickle.dumps(jquery.frames_to_wire(
        [jquery.DeltaFrame(*f) for f in frames]))
    assert [tuple(f) for f in jquery.frames_from_wire(wire)] == \
        [tuple(f) for f in frames]


def test_same_stream_same_poll_bytes_across_packages(tmp_path):
    """The same word stream through the JAX stack and the port's: the
    servers' subscribe and poll replies for the same token carry the
    same frames and horizons, pickled to the same bytes."""
    replies = {}
    for pkg in ("jax", "port"):
        sched, ship, rep, hub, src, sink = make_stack(tmp_path, pkg,
                                                      start=False)
        wc = STACKS[pkg][4]
        srv_cls = (SubscriptionServer if pkg == "port"
                   else jsubs.SubscriptionServer)
        srv = srv_cls(hub, None)
        try:
            drive(sched, src, 2, wc=wc)
            pump_until_caught(ship, sched, rep)
            out = []
            for kind, params in (("view", ()), ("topk", (4,)),
                                 ("lookup", (("w3", 1.0),))):
                ok = srv._dispatch(("sub", sink.name, kind, params, -1, 0,
                                    f"tok-{kind}"))
                out.append(ok[:4])
            hub.pump_once()
            drive(sched, src, 3, start=2, wc=wc)
            pump_until_caught(ship, sched, rep)
            hub.pump_once()
            for kind in ("view", "topk", "lookup"):
                out.append(srv._dispatch(("sub_poll", f"tok-{kind}", -1,
                                          0.0)))
            replies[pkg] = [pickle.dumps(r) for r in out]
        finally:
            close_stack(sched, ship, hub)
    assert replies["port"] == replies["jax"]


# -- in-process: parity with the pull path ----------------------------------

def test_inprocess_parity_all_kinds(tmp_path):
    sched, ship, rep, hub, src, sink = make_stack(tmp_path)
    try:
        drive(sched, src, 3)
        pump_until_caught(ship, sched, rep)
        h_view = hub.open(sink.name)
        h_top = hub.open(sink.name, "topk", (5,))
        key = sorted(rep.view_at(sink.name)[1])[0]
        h_look = hub.open(sink.name, "lookup", (key,))
        # more windows after subscribing: snapshots first, then deltas
        drive(sched, src, 5, start=3)
        pump_until_caught(ship, sched, rep)
        horizon = rep.published_horizon()
        for h in (h_view, h_top, h_look):
            assert h.wait_horizon(horizon), \
                f"{h.state.query.kind} stuck at {h.horizon}"
            assert h.value() == pull_value(rep, sink, h.state.query)
            assert h.state.gaps == 0
        # the view handle saw real deltas, not a snapshot a window
        assert h_view.state.applied > 1
        h_view.close()
        assert hub.active_subs() == 2
    finally:
        close_stack(sched, ship, hub)


@pytest.mark.parametrize("path", ["hub", "wire"])
def test_topk_by_value_ranks_varying_counts(tmp_path, path):
    """Every word-count row has weight 1, so a topk by weight ranks by its
    tie-break alone. By value it ranks the counts, which differ: at each
    horizon the answer is the k largest counts in order (ties on the
    pair's string form), held against a plain sort of the pull view and
    the JAX package's ``topk_rows``."""
    k = 6
    sched, ship, rep, hub, src, sink = make_stack(tmp_path)
    lt = srv = None
    try:
        drive(sched, src, 3)
        pump_until_caught(ship, sched, rep)
        if path == "hub":
            sub = hub.open(sink.name, "topk", (k, "value"))
        else:
            lt = LoopbackTransport()
            srv = SubscriptionServer(hub, lt).start()
            sub = Subscriber(lt, srv.address, sink.name, kind="topk",
                             params=(k, "value"),
                             policy=wire_policy("sub-rank"))
        for leg in range(4):
            drive(sched, src, 3, start=3 + 3 * leg)
            pump_until_caught(ship, sched, rep)
            horizon = rep.published_horizon()
            if path == "hub":
                assert sub.wait_horizon(horizon)
            else:
                pump_to(sub, horizon)
            view = rep.view_at(sink.name)[1]
            want = sorted(view.items(),
                          key=lambda it: (-it[0][1], str(it[0])))[:k]
            got = sub.value()
            assert list(got) == want, f"horizon {horizon}"
            assert got == jquery.topk_rows(view, k, "value")
            counts = [kv[1] for kv, _w in got]
            assert counts == sorted((kv[1] for kv in view),
                                    reverse=True)[:k]
            assert len(set(counts)) > 1, "the rank saw only ties"
    finally:
        if path == "wire":
            sub.close()
            srv.close()
        close_stack(sched, ship, hub)


def test_changeless_windows_advance_horizon_without_frames(tmp_path):
    sched, ship, rep, hub, src, sink = make_stack(tmp_path)
    try:
        drive(sched, src, 2)
        pump_until_caught(ship, sched, rep)
        # a lookup on a key this workload never produces: every window is
        # changeless for it, yet its horizon advances
        h = hub.open(sink.name, "lookup", (("never", -1.0),))
        assert h.wait_horizon(rep.published_horizon())
        drive(sched, src, 4, start=2)
        pump_until_caught(ship, sched, rep)
        assert h.wait_horizon(rep.published_horizon())
        assert h.value() == 0.0
        assert h.state.applied == 1          # the seed snapshot only
        assert h.state.gaps == 0
    finally:
        close_stack(sched, ship, hub)


# -- slow subscribers: conflate / shed, never stall apply -------------------

def test_slow_subscriber_conflates_and_never_blocks_apply(tmp_path):
    sched, ship, rep, hub, src, sink = make_stack(tmp_path, outbox_max=4)
    try:
        slow = hub.open(sink.name)            # never drained below
        fast = hub.open(sink.name, "topk", (3,))
        for leg in range(6):
            drive(sched, src, 4, start=leg * 4)
            pump_until_caught(ship, sched, rep)   # apply never stalls
            fast.drain(wait_s=0.05)
        horizon = rep.published_horizon()
        assert horizon == 24
        assert fast.wait_horizon(horizon)
        deadline = time.monotonic() + 5.0
        while hub.conflations_total == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hub.conflations_total > 0
        # the un-drained outbox is bounded by conflation
        shard = hub._shard(slow.token)
        assert len(shard.subs[slow.token].outbox) <= 4 + 1
        # and the conflated stream still reconstructs exactly
        assert slow.wait_horizon(horizon)
        assert slow.value() == pull_value(rep, sink, slow.state.query)
        assert slow.state.gaps == 0
    finally:
        close_stack(sched, ship, hub)


def test_overloaded_subscriber_sheds_to_snapshot(tmp_path):
    # a backlog too large even to conflate is shed: outbox cleared, one
    # fresh snapshot on the next round
    sched, ship, rep, hub, src, sink = make_stack(
        tmp_path, outbox_max=2, conflate_max_rows=4)
    try:
        slow = hub.open(sink.name)
        for leg in range(4):
            drive(sched, src, 3, start=leg * 3)
            pump_until_caught(ship, sched, rep)
        deadline = time.monotonic() + 5.0
        while hub.sheds_total == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hub.sheds_total > 0
        horizon = rep.published_horizon()
        assert slow.wait_horizon(horizon)
        assert slow.value() == pull_value(rep, sink, slow.state.query)
        assert slow.state.rebases >= 1
        assert slow.state.gaps == 0
    finally:
        close_stack(sched, ship, hub)


def test_shed_level_two_pauses_emission_then_rebases(tmp_path):
    sched, ship, rep, hub, src, sink = make_stack(tmp_path)
    try:
        h = hub.open(sink.name, "topk", (3,))
        drive(sched, src, 2)
        pump_until_caught(ship, sched, rep)
        assert h.wait_horizon(rep.published_horizon())
        hub.set_shed_level(2)                 # brownout: pause pushes
        drive(sched, src, 3, start=2)
        pump_until_caught(ship, sched, rep)
        frozen = h.horizon
        time.sleep(0.1)
        h.drain(wait_s=0.05)
        assert h.horizon == frozen            # nothing emitted
        hub.set_shed_level(0)                 # recover: snapshot rebase
        assert h.wait_horizon(rep.published_horizon())
        assert h.value() == pull_value(rep, sink, h.state.query)
        assert h.state.gaps == 0
    finally:
        close_stack(sched, ship, hub)


# -- min_horizon: read-your-writes for subscriptions ------------------------

def test_min_horizon_parks_snapshot_until_caught_up(tmp_path):
    sched, ship, rep, hub, src, sink = make_stack(tmp_path)
    try:
        drive(sched, src, 2)
        pump_until_caught(ship, sched, rep)
        want = rep.published_horizon() + 3
        h = hub.open(sink.name, min_horizon=want)
        h.drain(wait_s=0.1)
        assert h.horizon == -1                # parked, not served stale
        drive(sched, src, 3, start=2)
        pump_until_caught(ship, sched, rep)
        assert h.wait_horizon(want)
        assert h.state.rebases == 1
        assert h.value() == pull_value(rep, sink, h.state.query)
    finally:
        close_stack(sched, ship, hub)


# -- the crash seam ---------------------------------------------------------

def test_crash_seam_sub_fanout_rebases_on_restart(tmp_path):
    # the fan-out thread dies after draining the window queue, before
    # the mirrors fold it: the restart rebases from replica state
    crash = CrashInjector(1, only="sub_fanout")
    sched, ship, rep, hub, src, sink = make_stack(tmp_path, crash=crash)
    try:
        h = hub.open(sink.name)
        drive(sched, src, 3)
        pump_until_caught(ship, sched, rep)
        deadline = time.monotonic() + 5.0
        while not crash.fired and time.monotonic() < deadline:
            time.sleep(0.01)
        assert crash.fired and crash.fired_seam == "sub_fanout"
        deadline = time.monotonic() + 5.0
        while hub.alive and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not hub.alive                  # the thread really died
        drive(sched, src, 2, start=3)         # writes continue meanwhile
        pump_until_caught(ship, sched, rep)
        hub.start()                           # supervision revives it
        assert h.wait_horizon(rep.published_horizon())
        assert h.value() == pull_value(rep, sink, h.state.query)
        assert h.state.gaps == 0
        assert hub.rebases_total >= 1
    finally:
        close_stack(sched, ship, hub)


# -- over the wire: reconnect-resume ----------------------------------------

def wire_policy(name, cls=ReconnectPolicy):
    return cls(name, base_s=0.01, cap_s=0.05, jitter=0.0)


def pump_to(sub, horizon, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while sub.horizon < horizon and time.monotonic() < deadline:
        sub.pump(wait_s=0.05)
    assert sub.horizon >= horizon, \
        f"subscriber stuck at {sub.horizon} (< {horizon})"


def test_wire_reconnect_resumes_gap_free_dup_free(tmp_path):
    sched, ship, rep, hub, src, sink = make_stack(tmp_path)
    lt = LoopbackTransport()
    srv = SubscriptionServer(hub, lt).start()
    sub = Subscriber(lt, srv.address, sink.name, kind="view",
                     policy=wire_policy("sub-p0"))
    srv2 = None
    try:
        drive(sched, src, 3)
        pump_until_caught(ship, sched, rep)
        pump_to(sub, rep.published_horizon())
        assert sub.mode == "snapshot"
        applied_before = sub.frames_applied_total

        srv.close()                           # the partition
        for _ in range(3):
            sub.pump(wait_s=0.01)             # never raises while down
        drive(sched, src, 4, start=3)         # writes continue
        pump_until_caught(ship, sched, rep)

        srv2 = SubscriptionServer(hub, lt).start()   # the heal
        sub.retarget(srv2.address)
        pump_to(sub, rep.published_horizon())
        assert sub.mode == "resume"           # the cursor, no snapshot
        assert sub.gaps_total == 0
        assert sub.dups_skipped_total == 0
        assert sub.rebases_total == 1         # only the initial seed
        assert sub.frames_applied_total > applied_before
        assert sub.value() == pull_value(rep, sink, sub.query)
        assert sub.reconnects_total >= 1
    finally:
        sub.close()
        for s in (srv, srv2):
            if s is not None:
                s.close()
        close_stack(sched, ship, hub)


@pytest.mark.parametrize("server", ["port", "jax"])
def test_wire_resume_across_packages_through_a_reset(tmp_path, server):
    """A JAX ``Subscriber`` against a port ``SubscriptionServer`` (and a
    port one against a JAX server) over TCP: the server goes away, writes
    continue, a new server comes up on the same hub, and the subscriber
    resumes from its cursor with no gap and no duplicate, its answer equal
    to the pull path's."""
    sched, ship, rep, hub, src, sink = make_stack(tmp_path, server)
    wc = STACKS[server][4]
    if server == "port":
        srv_cls, stcp = SubscriptionServer, TcpTransport
        sub_cls, ctcp = jsubs.Subscriber, JTcpTransport
        from reflow_tpu.net import ReconnectPolicy as policy_cls
    else:
        srv_cls, stcp = jsubs.SubscriptionServer, JTcpTransport
        sub_cls, ctcp = Subscriber, TcpTransport
        policy_cls = ReconnectPolicy
    srv = srv_cls(hub, stcp()).start()
    sub = sub_cls(ctcp(), srv.address, sink.name, kind="view",
                  policy=wire_policy("sub-x", policy_cls),
                  io_timeout_s=2.0)
    top = sub_cls(ctcp(), srv.address, sink.name, kind="topk",
                  params=(4,), policy=wire_policy("sub-y", policy_cls),
                  io_timeout_s=2.0)
    srv2 = None
    try:
        drive(sched, src, 3, wc=wc)
        pump_until_caught(ship, sched, rep)
        for s in (sub, top):
            pump_to(s, rep.published_horizon())
            assert s.mode == "snapshot"
        srv.close()                           # the reset
        for _ in range(3):
            sub.pump(wait_s=0.01)
        drive(sched, src, 4, start=3, wc=wc)
        pump_until_caught(ship, sched, rep)
        srv2 = srv_cls(hub, stcp()).start()
        for s in (sub, top):
            s.retarget(srv2.address)
            pump_to(s, rep.published_horizon())
            assert s.mode == "resume"
            assert s.gaps_total == 0 and s.dups_skipped_total == 0
            assert s.rebases_total == 1
            assert s.value() == pull_value(rep, sink, s.query)
    finally:
        for s in (sub, top):
            s.close()
        for s in (srv, srv2):
            if s is not None:
                s.close()
        close_stack(sched, ship, hub)


def test_wire_expired_subscription_answers_gone_then_reregisters(
        tmp_path):
    sched, ship, rep, hub, src, sink = make_stack(tmp_path, expire_s=0.2)
    lt = LoopbackTransport()
    srv = SubscriptionServer(hub, lt).start()
    sub = Subscriber(lt, srv.address, sink.name, kind="topk",
                     params=(4,), policy=wire_policy("sub-p1"))
    try:
        drive(sched, src, 2)
        pump_until_caught(ship, sched, rep)
        pump_to(sub, rep.published_horizon())
        time.sleep(0.5)                       # idle past expire_s
        deadline = time.monotonic() + 5.0
        while hub.reaped_total == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert hub.reaped_total >= 1          # the server forgot us
        drive(sched, src, 2, start=2)
        pump_until_caught(ship, sched, rep)
        pump_to(sub, rep.published_horizon())  # "gone" -> re-handshake
        assert sub.handshakes_total >= 2
        assert sub.gaps_total == 0
        assert sub.value() == pull_value(rep, sink, sub.query)
    finally:
        sub.close()
        srv.close()
        close_stack(sched, ship, hub)


# -- consoles and telemetry -------------------------------------------------

def _snap(mono, **gauges):
    return {"schema": "reflow.obs.snapshot/1", "ts_mono": mono,
            "ts_wall": 1000.0 + mono, "gauges": gauges}


def test_fleet_derives_sub_gauges_with_backfill_tolerance():
    from reflow_tpu_torch.obs.fleet import FleetAggregator

    clk_v = [10.0]
    agg = FleetAggregator(retention=8, stale_after_s=5.0,
                          clock=lambda: clk_v[0])
    agg.ingest("r0", _snap(1.0, **{"subs.active": 3,
                                   "subs.fanout_rows_total": 100,
                                   "subs.slowest_lag": 1,
                                   "subs.conflations_total": 2,
                                   "subs.sheds_total": 1}))
    agg.ingest("r0", _snap(3.0, **{"subs.active": 5,
                                   "subs.fanout_rows_total": 300,
                                   "subs.slowest_lag": 4,
                                   "subs.conflations_total": 2,
                                   "subs.sheds_total": 1}))
    agg.ingest("r1", _snap(1.0))              # a pre-subs node
    snap = agg.fleet_snapshot()
    r0, r1 = snap["nodes"]["r0"], snap["nodes"]["r1"]
    assert r0["subs_active"] == 5
    assert r0["sub_rows_s"] == pytest.approx(100.0)   # (300-100)/2 s
    assert r0["sub_conflations"] == 3
    assert r0["sub_lag_windows"] == 4
    assert r1["subs_active"] is None and r1["sub_rows_s"] is None
    g = snap["gauges"]
    assert g["subs_active"] == 5
    assert g["sub_rows_s"] == pytest.approx(100.0)
    assert g["sub_lag_windows"] == 4
    agg2 = FleetAggregator(retention=4, stale_after_s=5.0,
                           clock=lambda: clk_v[0])
    agg2.ingest("r0", _snap(1.0))
    g2 = agg2.fleet_snapshot()["gauges"]
    assert g2["subs_active"] is None and g2["sub_rows_s"] is None


def test_hub_publishes_sub_gauges(tmp_path):
    sched, ship, rep, hub, src, sink = make_stack(tmp_path)
    reg = MetricsRegistry()
    try:
        hub.publish_metrics(reg)
        h = hub.open(sink.name)
        drive(sched, src, 2)
        pump_until_caught(ship, sched, rep)
        assert h.wait_horizon(rep.published_horizon())
        gauges = reg.snapshot()["gauges"]
        assert gauges["subs.active"] == 1
        assert gauges["subs.horizon"] == rep.published_horizon()
        assert gauges["subs.fanout_rows_total"] >= 1
        assert gauges["subs.shed_level"] == 0
    finally:
        close_stack(sched, ship, hub)
        assert "subs.active" not in reg.snapshot()["gauges"]


def test_cli_update_schema_and_render():
    from reflow_tpu.subs import cli as jcli

    q = canon_query("counts", "topk", (3,))
    ranked = ((("the", 2.0), 9), (("a", 1.0), 7))
    sub = SimpleNamespace(query=q, horizon=42,
                          value=lambda: ranked,
                          frames_applied_total=5, gaps_total=0,
                          dups_skipped_total=1, rebases_total=1,
                          conn_state="healthy")
    upd = make_update(sub, ts_wall=123.456)
    assert upd == jcli.make_update(sub, ts_wall=123.456)
    assert upd["schema"] == SUB_SCHEMA == "reflow.sub/1"
    assert upd["horizon"] == 42 and upd["kind"] == "topk"
    assert upd["rows"] == [[["the", 2.0], 9], [["a", 1.0], 7]]
    line = render_update(upd)
    assert line == jcli.render_update(upd)
    assert "h=42" in line and "counts/topk" in line
    assert "gaps=0" in line
    sub.query = canon_query("counts", "lookup", (("the", 2.0),))
    sub.value = lambda: 9.0
    upd = make_update(sub, ts_wall=123.5)
    assert upd["rows"] == 9.0
    assert "value=9.0" in render_update(upd)


# -- the hub on a replica over the "cuda" executor ----------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the replica's k-NN replay runs "
                    "the top-k kernel, which has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_hub_on_a_cuda_knn_follower(tmp_path, card):
    """A k-NN leader on the card ships to a replica on its own ``"cuda"``
    executor with a hub attached: every subscriber's answer equals the
    pull path at each horizon, and the hub holds host rows only."""
    Q, D, dim, k = 16, 4096, 64, 8

    def graph():
        kg = knn.build_graph(Q, D, dim, k, scan_chunk=1024)
        kg.graph.sink(kg.index, "nn")
        return kg

    kl, kr = graph(), graph()
    sched = DurableScheduler(kl.graph, P.get_executor("cuda"),
                             wal_dir=str(tmp_path / "wal"), fsync="tick")
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    rep = ReplicaScheduler(kr.graph, str(tmp_path / "r0"),
                           executor=P.get_executor("cuda"), name="r0")
    ship.attach(rep)
    hub = SubscriptionHub(rep, name="r0", idle_poll_s=0.005)
    rep.attach_hub(hub)
    rng = np.random.default_rng(0)
    try:
        sched.push(kl.queries, P.DeltaBatch(
            np.arange(Q), rng.standard_normal((Q, dim)).astype(np.float32)))
        sched.push(kl.docs, P.DeltaBatch(
            np.arange(D // 2),
            rng.standard_normal((D // 2, dim)).astype(np.float32)))
        sched.tick()
        pump_until_caught(ship, sched, rep)
        handles = [hub.open("nn"), hub.open("nn", "topk", (4,)),
                   hub.open("nn", "lookup", (next(iter(
                       rep.view_at("nn")[1])),))]
        for lo in range(D // 2, D, 512):
            sched.push(kl.docs, P.DeltaBatch(
                np.arange(lo, lo + 512),
                rng.standard_normal((512, dim)).astype(np.float32)))
            sched.tick()
            pump_until_caught(ship, sched, rep)
            for h in handles:
                assert h.wait_horizon(rep.published_horizon())
                assert h.value() == pull_value(
                    rep, SimpleNamespace(name="nn"), h.state.query)
                assert h.state.gaps == 0
        for kv, _w in rep.view_at("nn")[1].items():
            assert not any(isinstance(x, torch.Tensor)
                           for x in (kv[0], *kv[1]))
    finally:
        hub.close()
        sched.close()
