"""The port's key-range tiled maintenance on the replication path — the
tiled compaction fold, tiled replica snapshots and the tile-unit
bootstrap — and the replica's bootstrap from a checkpoint chain, against
``tests/test_tiles.py`` and ``tests/test_checkpoint_chain.py``, on the
CPU.

Counterparts of the tests PR 8 left for the replica slice (the rest of
both files have theirs in ``tests/test_torch_checkpoint.py``): the tiled
fold's replay parity and manifest, a crash at either per-tile seam
resuming finished tiles, snapshot tiles reused by identity and the empty
window reusing the whole tuple, the replica's tile gauges, a tile unit
corrupted in flight NACKed and re-sent alone, retries exhausted falling
back to the whole bootstrap, bad units refused, a follower re-anchored
into a tile-compacted range, and a fresh replica bootstrapped from a
chain directory. Each runs over the port's CPU oracle (string keys) and
over its ``"cuda"`` executor at ``device="cpu"`` (integer keys from one
fixed vocabulary); views are held equal exactly (small integer counts).

Beyond the reference: the port's checkpoint keeps its array states in a
``states-t<tick>-*`` directory that ``meta.pkl`` names, so a tile-unit
bootstrap ships relative paths that hold a directory, and ships only the
files the committed ``meta.pkl`` names — never an uncommitted save's.
"""

import os
import zlib

import numpy as np
import pytest

import reflow_tpu_torch as P
from reflow_tpu_torch.obs import MetricsRegistry
from reflow_tpu_torch.serve import ReplicaScheduler
from reflow_tpu_torch.utils import tiles
from reflow_tpu_torch.utils.checkpoint import (CheckpointChain,
                                               committed_files,
                                               save_checkpoint)
from reflow_tpu_torch.utils.faults import CrashInjector, CrashPoint
from reflow_tpu_torch.wal import (DurableScheduler, SegmentShipper,
                                  WalCompactor, recover)
from reflow_tpu_torch.wal.compact import read_compact_manifest
from reflow_tpu_torch.wal.log import _MAGIC
from reflow_tpu_torch.workloads import wordcount

WORDS = [f"w{i}" for i in range(40)]
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

    def durable(self, g, wal_dir, **kw):
        return DurableScheduler(g, self.executor(), wal_dir=wal_dir, **kw)

    def replica(self, path, **kw):
        return ReplicaScheduler(self.build()[0], path,
                                executor=self.executor(), name="r0", **kw)

    def ingest(self, lines, weight=1):
        if self.kind != "cuda":
            return wordcount.ingest_lines(lines, weight=weight)
        vocab = dict(VOCAB)
        b = wordcount.ingest_lines(lines, weight=weight, vocab=vocab)
        assert len(vocab) == len(VOCAB), "a word outside WORDS"
        return b


@pytest.fixture(params=["cpu", "cuda"])
def wc(request):
    return WC(request.param)


# -- helpers ----------------------------------------------------------------

def make_feed(wc, seed, n_ticks, tag="", vocab=25):
    """Deterministic per-tick [(batch_id, batch)] lists with retractions
    mixed in (``tests/test_tiles.py``'s feed)."""
    rng = np.random.default_rng(seed)
    feed = []
    for t in range(n_ticks):
        batches = []
        for j in range(int(rng.integers(1, 3))):
            words = " ".join(
                f"w{int(x)}" for x in rng.integers(0, vocab,
                                                   int(rng.integers(2, 8))))
            weight = -1 if (t > 2 and rng.random() < 0.2) else 1
            batches.append((f"{tag}t{t}b{j}",
                            wc.ingest([words], weight=weight)))
        feed.append(batches)
    return feed


def drive(sched, src, feed):
    for batches in feed:
        for bid, b in batches:
            sched.push(src, b, batch_id=bid)
        sched.tick()


def build_log(wc, wal_dir, feed, segment_bytes=1 << 12):
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=segment_bytes)
    drive(sched, src, feed)
    view = dict(sched.view(sink.name))
    tick = sched._tick
    sched.close()
    return view, tick


def recovered_view(wc, wal_dir, ckpt_dir=None):
    g, _src, sink = wc.build()
    sched = P.DirtyScheduler(g, wc.executor())
    recover(sched, wal_dir, ckpt_dir)
    return dict(sched.view(sink.name)), sched._tick


def live_view(sched, sink):
    return {kv: w for kv, w in sched.view(sink.name).items() if w != 0}


def pump(sched, ship, rep):
    sched.wal.sync()
    for _ in range(100):
        ship.pump_once()
        if rep.published_horizon() == sched._tick:
            return
    raise AssertionError("replica stuck")


# -- tiled compaction -----------------------------------------------------------

def test_tiled_fold_parity_and_manifest(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    oracle, tick = build_log(wc, wal_dir, make_feed(wc, 7, 30))
    comp = WalCompactor(wal_dir=wal_dir, min_segments=2, keep_segments=1,
                        tile_bytes=512)
    assert comp.compact_once() is not None
    while comp.compact_once() is not None:
        pass
    m = read_compact_manifest(wal_dir)
    ent = next(e for e in m["ranges"] if "tiles" in e)
    ti = ent["tiles"]
    assert ti["n"] >= 2 and ti["n"] == len(ti["plan"])
    assert ti["plan"][0][0] == 0 \
        and ti["plan"][-1][1] == tiles.N_BUCKETS
    assert all(g >= 1 for g in ti["gens"])
    assert 0 < ti["peak_tile_bytes"] <= 2 * 512
    got, got_tick = recovered_view(wc, wal_dir)
    assert got == oracle and got_tick == tick


@pytest.mark.parametrize("seam", ["compact_tile_before_progress",
                                  "compact_tile_after_progress"])
def test_tiled_fold_crash_resumes_finished_tiles(tmp_path, wc, seam):
    wal_dir = str(tmp_path / "wal")
    oracle, tick = build_log(wc, wal_dir, make_feed(wc, 3, 30))
    inj = CrashInjector(2, only=seam)
    comp = WalCompactor(wal_dir=wal_dir, min_segments=2, keep_segments=1,
                        tile_bytes=512, crash=inj)
    with pytest.raises(CrashPoint):
        comp.compact_once()
    assert inj.fired_seam == seam
    got, got_tick = recovered_view(wc, wal_dir)
    assert got == oracle and got_tick == tick
    comp2 = WalCompactor(wal_dir=wal_dir, min_segments=2, keep_segments=1,
                         tile_bytes=512)
    ev = comp2.compact_once()
    assert ev is not None
    ti = read_compact_manifest(wal_dir)["ranges"][-1]["tiles"]
    assert ti["attempts"] == 2
    if seam == "compact_tile_after_progress":
        assert ti["resumed_tiles"] >= 1
        assert set(ti["gens"]) == {1, 2}
    got, got_tick = recovered_view(wc, wal_dir)
    assert got == oracle and got_tick == tick


# -- tiled replica snapshots ------------------------------------------------

def make_pair(wc, tmp_path, tile_bytes=512):
    g, src, sink = wc.build()
    sched = wc.durable(g, str(tmp_path / "wal"), fsync="tick")
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    rep = wc.replica(str(tmp_path / "r0"), tile_bytes=tile_bytes)
    ship.attach(rep)
    return sched, src, sink, ship, rep


def test_snapshot_reuses_clean_tiles_by_identity(tmp_path, wc):
    sched, src, sink, ship, rep = make_pair(wc, tmp_path)
    drive(sched, src, make_feed(wc, 5, 12))
    pump(sched, ship, rep)
    s1 = rep._snapshot(sink.name)
    assert len(s1.plan) >= 2
    sched.push(src, wc.ingest(["w3 w3"]), batch_id="hot")
    sched.tick()
    pump(sched, ship, rep)
    s2 = rep._snapshot(sink.name)
    assert s2.plan == s1.plan and s2.horizon > s1.horizon
    reused = sum(1 for a, b in zip(s1.tiles, s2.tiles) if a is b)
    assert reused >= 1
    assert reused < len(s2.tiles)
    for a, b in zip(s1.tiles, s2.tiles):
        assert (b.gen == a.gen) if (a is b) else (b.gen == a.gen + 1)
    assert rep.snapshot_tiles_reused >= reused
    h, got = rep.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    sched.close()
    rep.close()


def test_snapshot_empty_window_reuses_whole_tuple(tmp_path, wc):
    sched, src, sink, ship, rep = make_pair(wc, tmp_path)
    drive(sched, src, make_feed(wc, 6, 8))
    pump(sched, ship, rep)
    s1 = rep._snapshot(sink.name)
    sched.tick()  # an empty tick: horizon advances, no sink delta
    pump(sched, ship, rep)
    s2 = rep._snapshot(sink.name)
    assert s2.horizon == s1.horizon + 1
    assert s2.tiles is s1.tiles
    sched.close()
    rep.close()


def test_replica_tile_gauges_lifecycle(tmp_path, wc):
    sched, src, sink, ship, rep = make_pair(wc, tmp_path)
    reg = MetricsRegistry()
    rep.publish_metrics(reg)
    drive(sched, src, make_feed(wc, 8, 6))
    pump(sched, ship, rep)
    rep._snapshot(sink.name)
    assert reg.value("replica.r0.snapshot_tiles") >= 2
    assert reg.value("replica.r0.snapshot_tiles_reused") >= 0
    rep.close()
    assert reg.value("replica.r0.snapshot_tiles") is None
    sched.close()


# -- tile-unit bootstrap protocol -------------------------------------------

def tiled_leader_with_chain(wc, tmp_path, monkeypatch):
    monkeypatch.setenv("REFLOW_TILE_BYTES", "512")
    g, src, sink = wc.build()
    sched = wc.durable(g, str(tmp_path / "wal"), fsync="tick",
                       segment_bytes=1 << 12)
    chain = CheckpointChain(str(tmp_path / "ckpt"), delta_every=4)
    drive(sched, src, make_feed(wc, 11, 10))
    chain.save(sched)
    sched.wal.sync()
    assert chain.tile_count >= 2
    return sched, src, sink, str(tmp_path / "ckpt")


class FlakyTransport:
    """Delegating replica proxy that corrupts the first N tile units in
    flight (payload flipped after the CRC was stamped)."""

    def __init__(self, inner, corrupt_first=1):
        self.inner = inner
        self.left = corrupt_first
        self.rels = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def receive_ckpt_tile(self, unit):
        self.rels.append(unit["rel"])
        if self.left > 0 and unit.get("payload"):
            self.left -= 1
            unit = dict(unit)
            unit["payload"] = b"\xff" + unit["payload"][1:]
        return self.inner.receive_ckpt_tile(unit)


def test_tile_unit_corrupt_in_flight_nacked_and_retried(tmp_path, wc,
                                                        monkeypatch):
    sched, src, sink, root = tiled_leader_with_chain(wc, tmp_path,
                                                     monkeypatch)
    ship = SegmentShipper(sched.wal, ckpt_dir=root,
                          leader_tick=lambda: sched._tick)
    rep = wc.replica(str(tmp_path / "r0"))
    flaky = FlakyTransport(rep)
    ship.attach(flaky)
    assert rep.crc_rejects == 1
    assert ship.tile_unit_retries == 1
    assert ship.tile_bootstraps == 1
    assert ship.tile_units_shipped > 2
    assert flaky.rels[-1] == "chain.json"  # the commit file last
    pump(sched, ship, rep)
    h, got = rep.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    sched.close()
    rep.close()


def test_tile_unit_retries_exhaust_falls_back_whole(tmp_path, wc,
                                                    monkeypatch):
    monkeypatch.setenv("REFLOW_TILE_SHIP_RETRIES", "2")
    sched, src, sink, root = tiled_leader_with_chain(wc, tmp_path,
                                                     monkeypatch)
    ship = SegmentShipper(sched.wal, ckpt_dir=root,
                          leader_tick=lambda: sched._tick)
    rep = wc.replica(str(tmp_path / "r0"))
    ship.attach(FlakyTransport(rep, corrupt_first=10 ** 6))
    assert ship.tile_bootstraps == 0
    assert ship.tile_unit_retries == 2
    pump(sched, ship, rep)
    h, got = rep.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    sched.close()
    rep.close()


def test_receive_ckpt_tile_rejects_bad_units(tmp_path, wc):
    rep = wc.replica(str(tmp_path / "r0"))
    assert rep.receive_ckpt_tile({"schema": "nope"})["ok"] is False
    body = b"payload"
    unit = {"schema": "reflow.tile_ship/1", "rel": "../evil", "idx": 0,
            "total": 2, "payload": body,
            "crc": zlib.crc32(body) & 0xFFFFFFFF, "last": False}
    resp = rep.receive_ckpt_tile(unit)
    assert resp["ok"] is False and "relpath" in resp["reason"]
    assert not os.path.exists(str(tmp_path / "evil"))
    unit = {"schema": "reflow.tile_ship/1", "rel": "meta.pkl", "idx": 1,
            "total": 3, "payload": body,
            "crc": zlib.crc32(body) & 0xFFFFFFFF, "last": True}
    resp = rep.receive_ckpt_tile(unit)
    assert resp["ok"] is False and "incomplete" in resp["reason"]
    rep.close()


def test_follower_reanchor_into_tile_compacted_range(tmp_path, wc,
                                                     monkeypatch):
    monkeypatch.setenv("REFLOW_TILE_BYTES", "512")
    wal_dir = str(tmp_path / "wal")
    ckpt_dir = str(tmp_path / "ckpt")
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=1 << 12)
    chain = CheckpointChain(ckpt_dir, delta_every=4)
    chain.save(sched)
    ship = SegmentShipper(sched.wal, ckpt_dir=ckpt_dir,
                          leader_tick=lambda: sched._tick)
    g2, _s2, sink2 = wc.build()
    replica = ReplicaScheduler(g2, str(tmp_path / "r0"),
                               executor=wc.executor(), name="r0")
    ship.attach(replica)
    drive(sched, src, make_feed(wc, 4, 3))
    sched.wal.sync()
    ship.pump_once()
    stale = replica.subscribe()
    assert stale is not None and stale[1] > len(_MAGIC)
    ship.detach("r0")
    drive(sched, src, make_feed(wc, 6, 30, tag="x"))
    sched.wal.sync()
    comp = WalCompactor(sched.wal, ckpt_dir=ckpt_dir, min_segments=1,
                        keep_segments=1)
    ev = comp.compact_once()
    assert ev is not None and ev["covers"][0] == stale[0]
    ti = read_compact_manifest(wal_dir)["ranges"][-1]["tiles"]
    assert ti["n"] >= 2
    ship.attach(replica)
    sched.wal.sync()
    for _ in range(200):
        ship.pump_once()
        if replica.published_horizon() == sched._tick:
            break
    assert ship.compact_reanchors >= 1
    h, got = replica.view_at(sink2.name)
    assert h == sched._tick and got == live_view(sched, sink)
    sched.close()
    replica.close()


# -- bootstrap from a chain directory (tests/test_checkpoint_chain.py) ---------

def _drive_words(wc, sched, src, n_ticks, start=0):
    rng = np.random.default_rng(start)
    for t in range(start, start + n_ticks):
        for j in range(2):
            words = " ".join(f"w{int(x)}" for x in rng.integers(0, 40, 8))
            sched.push(src, wc.ingest([words]), batch_id=f"t{t}b{j}")
        sched.tick()


def test_replica_bootstrap_from_chain_dir(tmp_path, wc):
    g, src, sink = wc.build()
    sched = wc.durable(g, str(tmp_path / "wal"), fsync="tick",
                       segment_bytes=1 << 12)
    root = str(tmp_path / "ckpt")
    chain = CheckpointChain(root, delta_every=4)
    ship = SegmentShipper(sched.wal, ckpt_dir=root,
                          leader_tick=lambda: sched._tick)
    for r in range(4):
        _drive_words(wc, sched, src, 3, start=3 * r)
        chain.save(sched)
    _drive_words(wc, sched, src, 3, start=12)
    sched.wal.sync()
    g2, _s2, sink2 = wc.build()
    replica = ReplicaScheduler(g2, str(tmp_path / "r0"),
                               executor=wc.executor(), name="r0")
    ship.attach(replica)
    assert replica.bootstraps == 1
    assert replica.published_horizon() == 12  # the chain's head
    for _ in range(200):
        ship.pump_once()
        if replica.published_horizon() == sched._tick:
            break
    h, got = replica.view_at(sink2.name)
    want = {kv: w for kv, w in sched.view(sink.name).items() if w != 0}
    assert h == sched._tick and got == want
    sched.close()


# -- the port's layout: state directories, committed files only ----------------

def test_tile_bootstrap_ships_only_the_committed_files(tmp_path, wc,
                                                       monkeypatch):
    """A full checkpoint (not a chain) of the leader, beside a stray
    ``states-*`` directory and tile file no ``meta.pkl`` names (an
    uncommitted save's): the tile units carry exactly the files the
    committed ``meta.pkl`` names — relative paths into its state
    directory included — and ``meta.pkl`` last; the staged copy restores
    the leader's view exactly."""
    monkeypatch.setenv("REFLOW_TILE_BYTES", "512")
    g, src, sink = wc.build()
    sched = wc.durable(g, str(tmp_path / "wal"), fsync="tick")
    drive(sched, src, make_feed(wc, 11, 10))
    ck = str(tmp_path / "ckpt")
    save_checkpoint(sched, ck)
    stray = os.path.join(ck, "states-t99999999-stray")
    os.makedirs(stray)
    with open(os.path.join(stray, "0.pt"), "wb") as f:
        f.write(b"not committed")
    os.makedirs(os.path.join(ck, "tiles"), exist_ok=True)
    with open(os.path.join(ck, "tiles", "t99999999-000.ckt"), "wb") as f:
        f.write(b"not committed either")
    rels, commit_rel, _commit = committed_files(ck)
    assert commit_rel == "meta.pkl"
    assert not any("99999999" in r for r in rels)
    if wc.kind == "cuda":  # array states: files inside a states dir
        assert any(r.startswith("states-t") and os.sep in r for r in rels)
    drive(sched, src, make_feed(wc, 12, 3, tag="after"))
    ship = SegmentShipper(sched.wal, ckpt_dir=ck,
                          leader_tick=lambda: sched._tick)
    rep = wc.replica(str(tmp_path / "r0"))
    flaky = FlakyTransport(rep, corrupt_first=0)
    ship.attach(flaky)
    assert ship.tile_bootstraps == 1
    assert flaky.rels == [r.replace(os.sep, "/") for r in rels] \
        + ["meta.pkl"]
    assert rep.published_horizon() == 10
    pump(sched, ship, rep)
    h, got = rep.view_at(sink.name)
    assert h == sched._tick and got == live_view(sched, sink)
    sched.close()
    rep.close()
