"""The port's log shipping and read replicas (``reflow_tpu_torch.wal.ship``,
``serve.replica``, ``serve.read``) against ``tests/test_replica.py`` and
the JAX package, on the CPU.

Every test of ``tests/test_replica.py`` has a counterpart here: the round
trip's exact parity across segment rotations, the synced prefix, the
tampered, partial, out-of-order and torn shipments (a partial commit
window is never applied), the restart from the mirrored tail and from a
checkpoint plus a torn mirror (never from segment 0), the bootstrap from
the leader's checkpoint, the re-anchor after the leader truncated, the
read tier's routing and leader fallback, ``tools/wal_inspect.py``'s
shipping watermarks, the cursor file, and the empty seal shipment. Each
runs twice: over the port's CPU oracle (string keys) and over its
``"cuda"`` executor at ``device="cpu"`` (its plain PyTorch path; integer
keys from one fixed vocabulary). Views are held equal exactly: the counts
are small integers.

Beyond the reference: a promoted replica leads on a fresh executor of its
own kind and device (the JAX ``promote`` builds its leader with no
executor, which in the port would be the CPU oracle); and a small k-NN
leader on the ``"cuda"`` executor feeds two replicas, one from segment 0
and one from a checkpoint, whose tables equal the leader's exactly (ids
and float32 scores) at every horizon, after a restart and after a
promotion.

Across the packages: a JAX ``SegmentShipper`` feeds a port
``ReplicaScheduler`` and a port shipper a JAX replica, both from segment
0, to equal views; the same feed gives byte-identical shipments, cursor
files and ``ship-state.json`` in both packages; and ``tools/wal_inspect.py
--json`` reads a port leader's log with its shipping and fence state.
Shipping starts from segment 0 because checkpoints do not cross the
packages (the port saves device state with ``torch.save``, the JAX
package with orbax); logs do, byte for byte.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import reflow_tpu_torch as P
from reflow_tpu.serve import ReplicaScheduler as JReplicaScheduler
from reflow_tpu.wal import DurableScheduler as JDurableScheduler
from reflow_tpu.wal import SegmentShipper as JSegmentShipper
from reflow_tpu.workloads import wordcount as jwc
from reflow_tpu_torch.serve import (LeaderReadAdapter, ReadTier,
                                    ReplicaScheduler, StaleRead)
from reflow_tpu_torch.utils.checkpoint import save_checkpoint
from reflow_tpu_torch.utils.faults import tear_wal_tail
from reflow_tpu_torch.wal import (DurableScheduler, FencedWrite,
                                  SegmentShipper)
from reflow_tpu_torch.wal.log import _MAGIC, list_segments
from reflow_tpu_torch.wal.ship import (ShipAck, Shipment, ShipNack,
                                       iter_frames)
from reflow_tpu_torch.workloads import knn as pknn
from reflow_tpu_torch.workloads import wordcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORDS = [f"w{i}" for i in range(40)] + [
    "alpha", "beta", "held", "back", "words", "torn", "tail", "fresh"]
VOCAB = {w: i for i, w in enumerate(WORDS)}
KEY_SPACE = 64


class WC:
    """Word-count over the port's CPU oracle (string keys) or its cuda
    executor on the CPU (vocabulary keys)."""

    def __init__(self, kind: str):
        self.kind = kind

    def build(self):
        return wordcount.build_graph(KEY_SPACE if self.kind == "cuda"
                                     else 0)

    def executor(self):
        if self.kind == "cuda":
            return P.get_executor("cuda", device="cpu")
        return P.CpuExecutor()

    def ingest(self, lines, weight=1):
        if self.kind != "cuda":
            return wordcount.ingest_lines(lines, weight=weight)
        vocab = dict(VOCAB)
        b = wordcount.ingest_lines(lines, weight=weight, vocab=vocab)
        assert len(vocab) == len(VOCAB), "a word outside WORDS"
        return b

    def key(self, word):
        return VOCAB[word] if self.kind == "cuda" else word

    def leader(self, tmp_path, **kw):
        g, src, sink = self.build()
        sched = DurableScheduler(g, self.executor(),
                                 wal_dir=str(tmp_path / "wal"),
                                 fsync="tick", **kw)
        return sched, src, sink

    def replica(self, tmp_path, name="r0"):
        g, _src, _sink = self.build()
        return ReplicaScheduler(g, str(tmp_path / name),
                                executor=self.executor(), name=name)


@pytest.fixture(params=["cpu", "cuda"])
def wc(request):
    return WC(request.param)


def drive(wc, sched, src, n_ticks, seed=0, start=0):
    rng = np.random.default_rng(seed + start)
    for t in range(start, start + n_ticks):
        for j in range(2):
            words = " ".join(
                f"w{int(x)}" for x in rng.integers(0, 40, 8))
            sched.push(src, wc.ingest([words]), batch_id=f"t{t}b{j}")
        sched.tick()


def live_view(sched, sink):
    return {kv: w for kv, w in sched.view(sink.name).items() if w != 0}


def pump_until_caught(ship, sched, replicas, max_rounds=100):
    sched.wal.sync()
    for _ in range(max_rounds):
        ship.pump_once()
        if all(r.published_horizon() == sched._tick for r in replicas):
            return
    raise AssertionError(
        f"replicas stuck: leader tick {sched._tick}, horizons "
        f"{[r.published_horizon() for r in replicas]}")


# -- round trip -------------------------------------------------------------

def test_ship_round_trip_exact_parity(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path, segment_bytes=2048)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    replicas = [wc.replica(tmp_path, f"r{i}") for i in range(2)]
    for r in replicas:
        ship.attach(r)
    drive(wc, sched, src, 8)
    pump_until_caught(ship, sched, replicas)
    want = live_view(sched, sink)
    for r in replicas:
        h, got = r.view_at(sink.name)
        assert h == sched._tick
        assert got == want
        assert r.lag_ticks() == 0
    assert ship.nacks == 0
    assert len(list_segments(sched.wal.wal_dir)) > 1  # rotations happened
    sched.close()


def test_shipper_only_ships_synced_prefix(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r = wc.replica(tmp_path)
    ship.attach(r)
    drive(wc, sched, src, 3)
    sched.wal.sync()
    before = sched.wal.synced_position()
    sched.push(src, wc.ingest(["alpha beta"]), batch_id="unsynced")
    # no sync: the new record may lie past the synced watermark
    ship.pump_once()
    cur = r.subscribe()
    assert cur is not None
    assert tuple(cur) <= tuple(sched.wal.synced_position())
    assert tuple(cur) >= tuple(before)
    sched.close()


# -- torn / tampered shipments ---------------------------------------------

class Corrupting:
    """Wraps a replica, corrupting the first non-empty shipment in
    flight."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.corrupted = 0

    def subscribe(self):
        return self.inner.subscribe()

    def bootstrap(self, ckpt_dir):
        return self.inner.bootstrap(ckpt_dir)

    def receive(self, sh):
        if self.corrupted == 0 and sh.payload:
            self.corrupted += 1
            bad = bytearray(sh.payload)
            bad[len(bad) // 2] ^= 0xFF
            return self.inner.receive(sh._replace(payload=bytes(bad)))
        return self.inner.receive(sh)


def test_tampered_shipment_nacked_and_rerequested(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    r = wc.replica(tmp_path)
    wrapped = Corrupting(r)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    ship.attach(wrapped)
    drive(wc, sched, src, 4)
    h_before = r.published_horizon()
    sched.wal.sync()
    ship.pump_once()  # first chunk corrupted -> NACK, nothing applied
    assert wrapped.corrupted == 1
    assert r.crc_rejects == 1
    assert ship.nacks == 1
    pump_until_caught(ship, sched, [r])
    assert r.published_horizon() == sched._tick > h_before
    _h, got = r.view_at(sink.name)
    assert got == live_view(sched, sink)
    sched.close()


def test_partial_commit_window_never_applied(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    drive(wc, sched, src, 1)
    sched.push(src, wc.ingest(["held back words"]), batch_id="hb1")
    sched.tick()
    sched.wal.sync()
    sched.close()

    seq, path = list_segments(str(tmp_path / "wal"))[0]
    with open(path, "rb") as f:
        data = f.read()
    entries, _valid, reason = iter_frames(data[len(_MAGIC):], seq,
                                          len(_MAGIC))
    assert reason is None
    last_tick = max(i for i, (_p, _e, rec) in enumerate(entries)
                    if rec["kind"] == "tick")
    cut = entries[last_tick][0].offset  # start of the final marker

    r = wc.replica(tmp_path)
    first = Shipment(seq, len(_MAGIC), data[len(_MAGIC):cut], cut, False,
                     None, 2)
    ack = r.receive(first)
    assert isinstance(ack, ShipAck)
    assert r.published_horizon() == 1          # first window applied
    assert len(r._staged) > 0                   # second window held back
    assert not any(r.sched._pending.values())   # not even pending
    _h, got = r.view_at(sink.name)
    assert (wc.key("held"), 1) not in got

    rest = Shipment(seq, cut, data[cut:], len(data), False, None, 2)
    ack = r.receive(rest)
    assert isinstance(ack, ShipAck)
    assert r.published_horizon() == 2
    assert r._staged == []
    _h, got = r.view_at(sink.name)
    assert got.get((wc.key("held"), 1)) == 1


def test_out_of_order_shipment_nacked(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r = wc.replica(tmp_path)
    ship.attach(r)
    drive(wc, sched, src, 2)
    pump_until_caught(ship, sched, [r])
    cur = r.subscribe()
    dup = Shipment(0, len(_MAGIC), b"", len(_MAGIC), False, None, 0)
    nack = r.receive(dup)
    assert isinstance(nack, ShipNack)
    assert tuple(nack.cursor) == tuple(cur)  # authoritative resume point
    assert r.order_rejects == 1
    sched.close()


def test_torn_leader_tail_never_ships(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    drive(wc, sched, src, 3)
    sched.push(src, wc.ingest(["torn tail words"]), batch_id="torn")
    sched.wal.sync()
    view3 = live_view(sched, sink)
    sched.wal.close()  # crash stand-in: no recovery pass over this dir
    tear_wal_tail(str(tmp_path / "wal"), 7)

    ship = SegmentShipper(wal_dir=str(tmp_path / "wal"))
    r = wc.replica(tmp_path)
    ship.attach(r)
    for _ in range(10):
        ship.pump_once()
    assert ship.crc_stops > 0          # hit the tear, refused to ship it
    assert r.crc_rejects == 0          # torn bytes never reached the wire
    assert r.published_horizon() == 3  # whole windows only
    _h, got = r.view_at(sink.name)
    assert got == view3


# -- restart-resume -----------------------------------------------------------

def test_replica_restart_resumes_from_tail_not_segment0(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path, segment_bytes=2048)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r = wc.replica(tmp_path)
    ship.attach(r)
    drive(wc, sched, src, 6)
    pump_until_caught(ship, sched, [r])
    cur_before = r.subscribe()
    assert cur_before[0] > 0  # past segment 0 (rotations happened)
    shipped_before = ship.bytes_total
    del r  # kill: no close, no checkpoint

    r2 = wc.replica(tmp_path)
    assert r2.restored_from == "tail"
    assert tuple(r2.subscribe()) == tuple(cur_before)  # resume, not seg 0
    assert r2.published_horizon() == 6

    ship2 = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    ship2.attach(r2)
    drive(wc, sched, src, 3, start=6)
    pump_until_caught(ship2, sched, [r2])
    assert ship2.bytes_total < shipped_before  # only the new tail
    _h, got = r2.view_at(sink.name)
    assert got == live_view(sched, sink)
    sched.close()


def test_replica_restart_with_checkpoint_and_torn_mirror(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r = wc.replica(tmp_path)
    ship.attach(r)
    drive(wc, sched, src, 4)
    pump_until_caught(ship, sched, [r])
    r.checkpoint()
    drive(wc, sched, src, 4, start=4)
    pump_until_caught(ship, sched, [r])
    assert r.published_horizon() == 8
    del r
    tear_wal_tail(str(tmp_path / "r0" / "wal"), 9)  # torn mid-frame

    r2 = wc.replica(tmp_path)
    assert r2.restored_from == "checkpoint+tail"
    assert r2.published_horizon() >= 4  # at least the checkpoint
    cur = r2.subscribe()
    assert cur is not None and tuple(cur) > (0, len(_MAGIC))
    ship2 = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    ship2.attach(r2)
    pump_until_caught(ship2, sched, [r2])
    _h, got = r2.view_at(sink.name)
    assert got == live_view(sched, sink)
    sched.close()


# -- checkpoint-anchored bootstrap / leader truncation ----------------------

def test_fresh_replica_bootstraps_from_leader_checkpoint(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    drive(wc, sched, src, 5)
    ck = str(tmp_path / "ckpt")
    save_checkpoint(sched, ck)  # rotates + truncates covered segments
    drive(wc, sched, src, 3, start=5)
    ship = SegmentShipper(sched.wal, ckpt_dir=ck,
                          leader_tick=lambda: sched._tick)
    r = wc.replica(tmp_path)
    ship.attach(r)
    assert r.bootstraps == 1
    assert r.published_horizon() == 5  # the checkpoint, before any ship
    pump_until_caught(ship, sched, [r])
    assert r.published_horizon() == 8
    _h, got = r.view_at(sink.name)
    assert got == live_view(sched, sink)
    total = sum(os.path.getsize(p)
                for _s, p in list_segments(sched.wal.wal_dir))
    assert ship.bytes_total <= total  # only the post-checkpoint tail
    sched.close()


def test_leader_truncation_reanchors_lagging_follower(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path, segment_bytes=2048)
    ck = str(tmp_path / "ckpt")
    ship = SegmentShipper(sched.wal, ckpt_dir=ck,
                          leader_tick=lambda: sched._tick)
    r = wc.replica(tmp_path)
    ship.attach(r)
    drive(wc, sched, src, 4)
    pump_until_caught(ship, sched, [r])
    drive(wc, sched, src, 4, start=4)
    save_checkpoint(sched, ck)  # truncates the follower's cursor segment
    drive(wc, sched, src, 2, start=8)
    pump_until_caught(ship, sched, [r])
    assert r.bootstraps == 1  # re-anchored once
    _h, got = r.view_at(sink.name)
    assert got == live_view(sched, sink)
    sched.close()


# -- read tier --------------------------------------------------------------

def test_read_tier_routing_and_leader_fallback(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r1, r2 = wc.replica(tmp_path, "r1"), wc.replica(tmp_path, "r2")
    ship.attach(r1)
    drive(wc, sched, src, 4)
    pump_until_caught(ship, sched, [r1])  # r1 caught up; r2 never attached
    leader = LeaderReadAdapter(sched)
    tier = ReadTier([r1, r2], leader=leader)

    res = tier.top_k(sink.name, 3, min_horizon=4, by="value")
    assert res.source == "r1" and res.horizon == 4
    assert tier.replica_reads == 1 and tier.leader_fallbacks == 0
    want3 = sorted(live_view(sched, sink).items(),
                   key=lambda r: -float(r[0][1]))[:3]
    assert sorted(v for (_k, v), _w in res.value) \
        == sorted(v for (_k, v), _w in want3)

    sched.push(src, wc.ingest(["fresh words"]), batch_id="fresh")
    sched.tick()
    res = tier.view_at(sink.name, min_horizon=5)
    assert res.source == "leader" and res.horizon == 5
    assert tier.leader_fallbacks == 1
    assert res.value == live_view(sched, sink)

    tier_noleader = ReadTier([r1, r2])
    with pytest.raises(StaleRead):
        tier_noleader.top_k(sink.name, 3, min_horizon=5)
    assert tier_noleader.stale_reads == 1

    assert tier.max_lag_ticks() >= 0
    new_sched = tier.promote(r1, committer="inline")
    assert r1.promoted and new_sched.wal.epoch == 1
    assert type(new_sched.executor) is type(r1.sched.executor)
    assert new_sched.executor is not r1.sched.executor
    assert all(x is not r1 for x in tier.replicas)
    res = tier.view_at(sink.name, min_horizon=4)
    assert res.source == "leader" and res.horizon == 4
    new_sched.close()
    sched.close()


def test_read_tier_round_robins_eligible_replicas(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    replicas = [wc.replica(tmp_path, f"r{i}") for i in range(3)]
    for r in replicas:
        ship.attach(r)
    drive(wc, sched, src, 2)
    pump_until_caught(ship, sched, replicas)
    tier = ReadTier(replicas)
    sources = {tier.top_k(sink.name, 2).source for _ in range(9)}
    assert sources == {"r0", "r1", "r2"}  # spread, not pinned
    sched.close()


# -- tooling ----------------------------------------------------------------

def _wal_inspect():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import wal_inspect
    finally:
        sys.path.pop(0)
    return wal_inspect


def test_wal_inspect_reports_ship_watermarks(tmp_path, wc):
    wal_inspect = _wal_inspect()
    sched, src, sink = wc.leader(tmp_path, segment_bytes=2048)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r = wc.replica(tmp_path)
    ship.attach(r)
    drive(wc, sched, src, 5)
    pump_until_caught(ship, sched, [r])
    summary = wal_inspect.inspect(str(tmp_path / "wal"), verbose=False)
    ship_sum = summary["shipping"]
    assert ship_sum is not None
    assert ship_sum["leader_tick"] == 5
    f = ship_sum["followers"]["r0"]
    assert f["applied_horizon"] == 5 and f["lag_ticks"] == 0
    assert tuple(f["shipped"]) == tuple(r.subscribe())
    sealed = summary["segments_detail"][:-1]
    assert sealed and all(s["shipped_fully"] for s in sealed)
    assert json.dumps(summary)
    sched.close()


def test_cursor_file_persisted_next_to_checkpoint(tmp_path, wc):
    sched, src, sink = wc.leader(tmp_path)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r = wc.replica(tmp_path)
    ship.attach(r)
    drive(wc, sched, src, 2)
    pump_until_caught(ship, sched, [r])
    with open(tmp_path / "r0" / "cursor.json") as f:
        state = json.load(f)
    assert state["schema"] == "reflow.replica_cursor/1"
    assert tuple(state["cursor"]) == tuple(r.subscribe())
    assert state["horizon"] == 2
    sched.close()


def test_fully_shipped_segment_seal_travels_as_empty_shipment(tmp_path,
                                                              wc):
    sched, src, sink = wc.leader(tmp_path)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r = wc.replica(tmp_path)
    ship.attach(r)
    drive(wc, sched, src, 3)
    pump_until_caught(ship, sched, [r])   # open segment fully shipped
    cur_before = r._cursor
    assert cur_before.offset > len(_MAGIC)
    sched.wal.rotate()                    # seals it with no new bytes
    drive(wc, sched, src, 2, start=3)
    pump_until_caught(ship, sched, [r])
    assert ship.nacks == 0 and r.order_rejects == 0
    assert r._cursor.segment > cur_before.segment
    assert live_view(r.sched, sink) == live_view(sched, sink)
    segs = dict(list_segments(str(tmp_path / "wal")))
    mirror = dict(list_segments(os.path.join(str(tmp_path / "r0"), "wal")))
    assert (os.path.getsize(mirror[cur_before.segment])
            == os.path.getsize(segs[cur_before.segment]))


# -- frames longer than a chunk ------------------------------------------------

def test_frame_longer_than_the_chunk_bound_ships_whole(tmp_path, wc):
    """A record longer than ``max_chunk_bytes`` (a bulk load) ships alone
    in one shipment and the replica lands on the leader's view; the JAX
    shipper cannot cut such a frame into chunks and makes no progress
    past it (ROADMAP Queue 3)."""
    sched, src, sink = wc.leader(tmp_path)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick,
                          max_chunk_bytes=1 << 10)
    r = wc.replica(tmp_path)
    ship.attach(r)
    words = " ".join(f"w{i % 40}" for i in range(600))
    sched.push(src, wc.ingest([words]), batch_id="bulk")
    sched.tick()
    drive(wc, sched, src, 2, start=1)
    pump_until_caught(ship, sched, [r])
    assert ship.crc_stops == 0
    _h, got = r.view_at(sink.name)
    assert got == live_view(sched, sink)
    sched.close()
    if wc.kind == "cpu":  # the reference, over the same log
        jship = JSegmentShipper(wal_dir=str(tmp_path / "wal"),
                                max_chunk_bytes=1 << 10)
        jr = JReplicaScheduler(jwc.build_graph()[0], str(tmp_path / "jr"),
                               name="jr")
        jship.attach(_bridge(jr, "jax"))
        for _ in range(5):
            jship.pump_once()
        assert jship.crc_stops > 0 and jr.published_horizon() == 0


# -- the promoted leader's executor -------------------------------------------

def test_promote_leads_on_a_fresh_executor_of_the_replica_kind(tmp_path,
                                                               wc):
    """The new leader runs on a new executor of the replica's own kind and
    device (the JAX ``promote`` passes none, which in the port is the CPU
    oracle), and takes further ticks there; an executor named in
    ``durable_kw`` wins."""
    sched, src, sink = wc.leader(tmp_path)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r, r2 = wc.replica(tmp_path, "r0"), wc.replica(tmp_path, "r2")
    ship.attach(r)
    ship.attach(r2)
    drive(wc, sched, src, 3)
    pump_until_caught(ship, sched, [r, r2])
    new = r.promote(committer="inline")
    ex, old_ex = new.executor, r.sched.executor
    assert type(ex) is type(old_ex) and ex is not old_ex
    if wc.kind == "cuda":
        assert ex.device == old_ex.device
        assert (ex.fixpoint, ex.linear_fixpoint) \
            == (old_ex.fixpoint, old_ex.linear_fixpoint)
    assert live_view(new, sink) == live_view(sched, sink)
    new.push(src, wc.ingest(["alpha"]), batch_id="after")
    new.tick()
    assert live_view(new, sink)[(wc.key("alpha"), 1)] == 1
    new.close()
    # an explicit executor in durable_kw is the one the leader runs on
    mine = wc.executor()
    new2 = r2.promote(committer="inline", executor=mine)
    assert new2.executor is mine
    new2.close()
    sched.close()


# -- a small k-NN replica on the cuda executor --------------------------------

Q, D, DIM, K, CHUNK = 8, 384, 16, 4, 128


def _knn_graph():
    return pknn.build_graph(Q, D, DIM, K, scan_chunk=CHUNK)


def _knn_table(sched, kg):
    return {int(q): np.asarray(r, np.float32)
            for q, r in sched.read_table(kg.index).items()}


def _same_table(got, want):
    assert got.keys() == want.keys()
    for q in want:
        np.testing.assert_array_equal(got[q], want[q])


def _knn_feed(seed=3):
    """(batch id, source, host batch) in submit order: the queries, a
    preload, inserts, a retraction of docs the inserts added, query
    updates, then a promotion's worth: one insert and one query update."""
    rng = np.random.default_rng(seed)

    def b(keys, vals, w=1):
        keys = np.asarray(keys, np.int64)
        return P.DeltaBatch(keys, vals, np.full(len(keys), w, np.int64))

    def vecs(n):
        return rng.standard_normal((n, DIM)).astype(np.float32)

    head = [("q0", "q", b(np.arange(Q), vecs(Q)))]
    head += [(f"pre{i}", "d", b(np.arange(i, i + 64), vecs(64)))
             for i in range(0, 128, 64)]
    tail = [(f"ins{i}", "d", b(np.arange(i, i + 32), vecs(32)))
            for i in range(128, 256, 32)]
    tail.append(("ret0", "d", b(np.arange(140, 150),
                                np.zeros((10, DIM), np.float32), -1)))
    tail.append(("qup0", "q", b(np.arange(2), vecs(2))))
    tail.append(("ret1", "d", b(np.arange(200, 204),
                                np.zeros((4, DIM), np.float32), -1)))
    tail.append(("qup1", "q", b(np.arange(3, 5), vecs(2))))
    after = [("ins-after", "d", b(np.arange(300, 332), vecs(32))),
             ("qup-after", "q", b(np.arange(1, 3), vecs(2)))]
    return head, tail, after


def test_knn_replicas_equal_the_leader_through_bootstrap_restart_promotion(
        tmp_path):
    """A k-NN leader on the cuda executor (plain top-k on the CPU), one
    replica shipped from segment 0 and one bootstrapped from the leader's
    checkpoint: at every leader tick each replica's table equals the
    leader's exactly; a restarted replica resumes from its own checkpoint
    and mirrored tail; the promoted replica leads on the same executor
    kind and device, the survivor re-anchors and follows it, and both
    equal a non-replicated twin fed the same batches."""
    from reflow_tpu_torch.serve import FailoverCoordinator

    head, tail, after = _knn_feed()

    def ex():
        return P.get_executor("cuda", device="cpu")

    def step(sched, g, item):
        bid, src, batch = item
        sched.push(g.queries if src == "q" else g.docs, batch, batch_id=bid)
        sched.tick()

    graphs = {n: _knn_graph() for n in ("leader", "twin", "r0", "r1")}
    kg = graphs["leader"]
    leader = DurableScheduler(kg.graph, ex(), wal_dir=str(tmp_path / "wal"),
                              fsync="tick", segment_bytes=8192)
    ck = str(tmp_path / "ckpt")
    ship = SegmentShipper(leader.wal, ckpt_dir=ck,
                          leader_tick=lambda: leader._tick)
    r0 = ReplicaScheduler(graphs["r0"].graph, str(tmp_path / "r0"),
                          executor=ex(), name="r0")
    ship.attach(r0)
    assert r0.bootstraps == 0  # no checkpoint yet: from segment 0
    twin = P.DirtyScheduler(graphs["twin"].graph, ex())
    for item in head:
        step(leader, kg, item)
        step(twin, graphs["twin"], item)
    save_checkpoint(leader, ck)
    r1 = ReplicaScheduler(graphs["r1"].graph, str(tmp_path / "r1"),
                          executor=ex(), name="r1")
    ship.attach(r1)
    assert r1.bootstraps == 1 and r1.published_horizon() == len(head)
    for item in tail:
        step(leader, kg, item)
        step(twin, graphs["twin"], item)
        pump_until_caught(ship, leader, [r0, r1])
        want = _knn_table(leader, kg)
        _same_table(_knn_table(r0.sched, graphs["r0"]), want)
        _same_table(_knn_table(r1.sched, graphs["r1"]), want)
    assert len(list_segments(leader.wal.wal_dir)) > 1

    # restart r0 on its directory with a fresh executor
    r0.checkpoint()
    ship.detach("r0")
    del r0
    graphs["r0"] = _knn_graph()
    r0 = ReplicaScheduler(graphs["r0"].graph, str(tmp_path / "r0"),
                          executor=ex(), name="r0")
    assert r0.restored_from in ("checkpoint", "checkpoint+tail", "tail")
    assert r0.published_horizon() == leader._tick
    _same_table(_knn_table(r0.sched, graphs["r0"]), _knn_table(leader, kg))
    ship.attach(r0)

    # failover: the leader stops, the highest horizon wins (a tie: r0)
    coord = FailoverCoordinator([r0, r1], shipper=ship,
                                durable_kw={"fsync": "tick",
                                            "committer": "inline"})
    coord.promote_now()
    new = coord.leader_sched
    assert coord.winner is r0 and new.wal.epoch == 1
    assert type(new.executor) is type(r0.sched.executor)
    assert new.executor.device == r0.sched.executor.device
    with pytest.raises(FencedWrite):
        leader.wal.append({"kind": "tick", "tick": 999})
    for item in after:
        step(new, graphs["r0"], item)
        step(twin, graphs["twin"], item)
    pump_until_caught(coord.new_shipper, new, [r1])
    want = _knn_table(twin, graphs["twin"])
    _same_table(_knn_table(new, graphs["r0"]), want)
    _same_table(_knn_table(r1.sched, graphs["r1"]), want)
    new.close()
    leader.close()


def test_knn_replica_equals_a_windowed_leader_at_every_horizon(tmp_path):
    """A sink-free k-NN leader on the cuda executor takes its batches in
    ``tick_many`` windows of three ticks, each window logged before its
    dispatch; after each window a replica that replays tick by tick holds
    the leader's horizon and its table exactly."""
    head, tail, after = _knn_feed(seed=5)
    items = head + tail + after
    kg, rg = _knn_graph(), _knn_graph()
    leader = DurableScheduler(kg.graph, P.get_executor("cuda", device="cpu"),
                              wal_dir=str(tmp_path / "wal"), fsync="tick")
    ship = SegmentShipper(leader.wal, leader_tick=lambda: leader._tick)
    r = ReplicaScheduler(rg.graph, str(tmp_path / "r0"),
                         executor=P.get_executor("cuda", device="cpu"),
                         name="r0")
    ship.attach(r)
    windows = 0
    for i in range(0, len(items), 3):
        feeds = [{(kg.queries if s == "q" else kg.docs): b}
                 for _bid, s, b in items[i:i + 3]]
        ids = [{(kg.queries if s == "q" else kg.docs): [bid]}
               for bid, s, _b in items[i:i + 3]]
        leader.tick_many(feeds, feed_ids=ids)
        windows += 1
        pump_until_caught(ship, leader, [r])
        _same_table(_knn_table(r.sched, rg), _knn_table(leader, kg))
    assert leader.megatick_windows >= 1 and windows > 3
    leader.close()


# -- across the packages ------------------------------------------------------

def _jfeed(n_ticks, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_ticks):
        out.append([(f"t{t}b{j}", " ".join(
            f"w{int(x)}" for x in rng.integers(0, 40, 8)))
            for j in range(2)])
    return out


def _feed_leader(sched, src, mod, feed):
    for batches in feed:
        for bid, words in batches:
            sched.push(src, mod.ingest_lines([words]), batch_id=bid)
        sched.tick()


class Recording:
    """Wraps a replica, keeping every shipment that reaches it."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.seen = []

    def subscribe(self):
        return self.inner.subscribe()

    def bootstrap(self, ckpt_dir):
        return self.inner.bootstrap(ckpt_dir)

    def receive(self, sh):
        self.seen.append(tuple(sh))
        return self.inner.receive(sh)


class Bridge:
    """Carries shipments from a shipper of one package to a replica of
    the other and the answers back, rebuilt as each side's own tuples:
    in-process stand-in for the wire endpoints, which flatten the
    protocol's tuples and rebuild them at each end (``net/framing.py``),
    so neither side depends on the other's classes."""

    def __init__(self, inner, to_receiver, to_shipper):
        self.inner = inner
        self.name = inner.name
        self._in = to_receiver      # the receiver's Shipment class
        self._out = to_shipper      # {receiver class: shipper class}

    def subscribe(self):
        return self.inner.subscribe()

    def bootstrap(self, ckpt_dir):
        return self.inner.bootstrap(ckpt_dir)

    def receive(self, sh):
        resp = self.inner.receive(self._in(*sh))
        return self._out[type(resp)](*resp)


def _bridge(replica, receiver_pkg):
    import reflow_tpu.wal.ship as jship
    import reflow_tpu_torch.wal.ship as pship

    rx, tx = (jship, pship) if receiver_pkg == "jax" else (pship, jship)
    return Bridge(replica, rx.Shipment,
                  {rx.ShipAck: tx.ShipAck, rx.ShipNack: tx.ShipNack})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_shipping_across_packages_from_segment0(tmp_path, direction):
    """A shipper of one package feeds a replica of the other from segment
    0, across segment rotations and an explicit one, to the leader's view
    exactly."""
    feed = _jfeed(8)
    if direction == "jax_to_port":
        g, src, sink = jwc.build_graph()
        sched = JDurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                                  fsync="tick", segment_bytes=2048)
        ship = JSegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
        r = ReplicaScheduler(wordcount.build_graph()[0],
                             str(tmp_path / "r"), name="r")
        mod = jwc
    else:
        g, src, sink = wordcount.build_graph()
        sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"),
                                 fsync="tick", segment_bytes=2048)
        ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
        r = JReplicaScheduler(jwc.build_graph()[0], str(tmp_path / "r"),
                              name="r")
        mod = wordcount
    ship.attach(_bridge(r, "port" if direction == "jax_to_port"
                        else "jax"))
    _feed_leader(sched, src, mod, feed[:4])
    pump_until_caught(ship, sched, [r])
    sched.wal.rotate()
    _feed_leader(sched, src, mod, feed[4:])
    pump_until_caught(ship, sched, [r])
    h, got = r.view_at(sink.name)
    assert h == sched._tick == 8
    assert got == live_view(sched, sink)
    assert ship.nacks == 0 and len(list_segments(str(tmp_path / "wal"))) > 2
    sched.close()


def test_shipments_cursor_and_ship_state_identical_across_packages(
        tmp_path):
    """The same feed through each package's leader, shipper and replica:
    every shipment (segment, offsets, payload bytes, seal, next segment,
    leader tick, epoch) is the same, and so are the replicas' cursor files
    and the shippers' ``ship-state.json``."""
    feed = _jfeed(6, seed=5)
    seen, cursors, states = {}, {}, {}
    for name in ("jax", "port"):
        mod = jwc if name == "jax" else wordcount
        base = tmp_path / name
        g, src, sink = mod.build_graph()
        sched = (JDurableScheduler if name == "jax" else DurableScheduler)(
            g, wal_dir=str(base / "wal"), fsync="tick", segment_bytes=1500)
        ship = (JSegmentShipper if name == "jax" else SegmentShipper)(
            sched.wal, leader_tick=lambda s=sched: s._tick)
        r = (JReplicaScheduler if name == "jax" else ReplicaScheduler)(
            mod.build_graph()[0], str(base / "r"), name="r")
        rec = Recording(r)
        ship.attach(rec)
        for batches in feed:
            for bid, words in batches:
                sched.push(src, mod.ingest_lines([words]), batch_id=bid)
            sched.tick()
            pump_until_caught(ship, sched, [r])
        seen[name] = rec.seen
        with open(base / "r" / "cursor.json", "rb") as f:
            cursors[name] = f.read()
        with open(base / "wal" / "ship-state.json", "rb") as f:
            states[name] = f.read()
        sched.close()
    assert len(seen["port"]) > 6 and any(s[4] for s in seen["port"])
    assert seen["jax"] == seen["port"]
    assert cursors["jax"] == cursors["port"]
    assert states["jax"] == states["port"]


def test_wal_inspect_json_reads_port_shipping_and_fence_state(tmp_path):
    """``tools/wal_inspect.py --json`` on a port leader's log after a
    failover: the ``shipping`` key with the follower's watermarks, and the
    fence a promotion left on the old log."""
    g, src, sink = wordcount.build_graph()
    sched = DurableScheduler(g, wal_dir=str(tmp_path / "wal"), fsync="tick",
                             segment_bytes=2048)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    r = ReplicaScheduler(wordcount.build_graph()[0], str(tmp_path / "r0"),
                         name="r0")
    ship.attach(r)
    _feed_leader(sched, src, wordcount, _jfeed(5))
    pump_until_caught(ship, sched, [r])
    from reflow_tpu_torch.serve import FailoverCoordinator
    coord = FailoverCoordinator([r], shipper=ship,
                                durable_kw={"committer": "inline"})
    coord.promote_now()
    with pytest.raises(FencedWrite):
        sched.wal.append({"kind": "tick", "tick": 99})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "tools", "wal_inspect.py"),
                          str(tmp_path / "wal"), "--json"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)
    f = summary["shipping"]["followers"]["r0"]
    assert f["applied_horizon"] == 5 and f["lag_ticks"] == 0
    assert summary["epochs"]["fenced"] is True
    assert summary["epochs"]["fenced_by"] == 1
    assert summary["epochs"]["rejected_appends"] >= 1
    coord.leader_sched.close()
    sched.close()
