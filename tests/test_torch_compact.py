"""The port's key-level WAL compaction (``reflow_tpu_torch.wal.compact``)
against ``tests/test_compact.py`` and the JAX package, on the CPU.

Every test of ``tests/test_compact.py`` has a counterpart here: the
folded log's replay parity and manifest, a re-fold extending the
range, zero-weight rows vanishing from the fold, a crash at each seam of
write-new → manifest flip → swap → unlink, interrupted temp files rolled
back, eligibility bounded by the checkpoint anchor, by ``min_segments`` /
``keep_segments`` and by an attached follower's cursor, a follower whose
cursor lies in a compacted range re-anchoring through the checkpoint, a
partially deduped folded record failing loud, the metrics, and the
control plane's supervision of the compactor (a free boot, pass events
as actions, budgeted respawns, then fail fast). The ones
that drive a scheduler run over the port's CPU oracle (string keys) and
over its ``"cuda"`` executor at ``device="cpu"`` (integer keys from one
fixed vocabulary); views are held equal exactly (small integer counts).

Across the packages: the port's compactor and the JAX one fold copies of
one log into byte-identical segments and manifests (the same records,
pickled the same way), and a log the port folded recovers in the JAX
package to the JAX recovery's views of the unfolded log.
"""

import json
import os
import shutil

import numpy as np
import pytest

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.wal import WalCompactor as JWalCompactor
from reflow_tpu.wal import recover as jrecover
from reflow_tpu.workloads import wordcount as jwc
from reflow_tpu_torch.obs import MetricsRegistry
from reflow_tpu_torch.serve import ReplicaScheduler
from reflow_tpu_torch.utils.checkpoint import (CheckpointChain,
                                               chain_head_wal_pos)
from reflow_tpu_torch.utils.faults import CrashInjector, CrashPoint
from reflow_tpu_torch.wal import (DurableScheduler, SegmentShipper,
                                  WalCompactor, WalError, recover)
from reflow_tpu_torch.wal.compact import (COMPACT_MANIFEST_FILE,
                                          read_compact_manifest)
from reflow_tpu_torch.wal.log import _MAGIC, list_segments, scan_wal
from reflow_tpu_torch.wal.recovery import replay_records
from reflow_tpu_torch.workloads import wordcount

WORDS = [f"w{i}" for i in range(25)] + ["gone", "forever", "kept",
                                        "alpha", "beta"]
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

    def ingest(self, lines, weight=1):
        if self.kind != "cuda":
            return wordcount.ingest_lines(lines, weight=weight)
        vocab = dict(VOCAB)
        b = wordcount.ingest_lines(lines, weight=weight, vocab=vocab)
        assert len(vocab) == len(VOCAB), "a word outside WORDS"
        return b

    def key(self, word):
        return VOCAB[word] if self.kind == "cuda" else word


@pytest.fixture(params=["cpu", "cuda"])
def wc(request):
    return WC(request.param)


# -- helpers ----------------------------------------------------------------

def make_feed(wc, seed, n_ticks, tag=""):
    """Deterministic per-tick [(batch_id, batch)] lists with retractions
    mixed in (``tests/test_compact.py``'s feed)."""
    rng = np.random.default_rng(seed)
    feed = []
    for t in range(n_ticks):
        batches = []
        for j in range(int(rng.integers(1, 3))):
            words = " ".join(
                f"w{int(x)}" for x in rng.integers(0, 25,
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
    rep = recover(sched, wal_dir, ckpt_dir)
    return dict(sched.view(sink.name)), sched._tick, rep


# -- fold parity ------------------------------------------------------------

def test_fold_replay_parity_and_manifest(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    oracle, tick = build_log(wc, wal_dir, make_feed(wc, 7, 30))
    comp = WalCompactor(wal_dir=wal_dir, min_segments=2, keep_segments=1)
    assert comp.reclaimable_bytes() > 0
    ev = comp.compact_once()
    assert ev is not None and ev["kind"] == "wal_compact"
    assert ev["records_out"] < ev["records_in"]
    assert ev["reclaimed_bytes"] > 0
    m = read_compact_manifest(wal_dir)
    assert m["gen"] == 1 and len(m["ranges"]) == 1
    ent = m["ranges"][0]
    assert ent["out"] == ent["covers"][0] == ev["out"]
    got, got_tick, _rep = recovered_view(wc, wal_dir)
    assert got == oracle and got_tick == tick
    seqs = [s for s, _ in list_segments(wal_dir)]
    assert ent["covers"][1] not in seqs or ent["covers"][1] == ent["out"]
    records, _ = scan_wal(wal_dir)
    folded = [r for _p, r in records if r.get("compacted")]
    assert folded and all(r["kind"] == "push" for r in folded)
    assert any(len(r.get("batch_ids", [])) > 1 for r in folded)


def test_refold_extends_previous_range(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    build_log(wc, wal_dir, make_feed(wc, 7, 30))
    comp = WalCompactor(wal_dir=wal_dir, min_segments=2, keep_segments=1)
    ev1 = comp.compact_once()
    assert ev1 is not None
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=1 << 12)
    recover(sched, wal_dir)
    drive(sched, src, make_feed(wc, 11, 40, tag="x"))
    oracle2 = dict(sched.view(sink.name))
    tick2 = sched._tick
    sched.close()
    ev2 = comp.compact_once()
    assert ev2 is not None
    m = read_compact_manifest(wal_dir)
    assert m["gen"] == 2
    assert ev2["covers"][0] == ev1["covers"][0]
    assert ev2["covers"][1] > ev1["covers"][1]
    got, got_tick, _rep = recovered_view(wc, wal_dir)
    assert got == oracle2 and got_tick == tick2


def test_zero_weight_rows_vanish_from_fold(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=1 << 10)
    for t in range(12):
        sched.push(src, wc.ingest(["gone forever"]), batch_id=f"in{t}")
        sched.tick()
    for t in range(12):
        sched.push(src, wc.ingest(["gone forever"], weight=-1),
                   batch_id=f"out{t}")
        sched.tick()
    sched.push(src, wc.ingest(["kept"]), batch_id="keep")
    sched.tick()
    oracle = dict(sched.view(sink.name))
    sched.close()
    comp = WalCompactor(wal_dir=wal_dir, min_segments=1, keep_segments=0)
    ev = comp.compact_once()
    assert ev is not None
    records, _ = scan_wal(wal_dir)
    folded = [r for _p, r in records if r.get("compacted")]
    assert folded
    gone = {wc.key("gone"), wc.key("forever")}
    for r in folded:
        assert all(w != 0 for w in r["weights"])
        assert not any(k in gone for k in np.asarray(r["keys"]).tolist())
    got, _t, _rep = recovered_view(wc, wal_dir)
    assert got == oracle


# -- crash seams ------------------------------------------------------------

@pytest.mark.parametrize("seam", ["compact_before_flip",
                                  "compact_after_flip",
                                  "compact_before_unlink",
                                  "compact_after_unlink"])
def test_compact_crash_seam_differential(tmp_path, wc, seam):
    wal_dir = str(tmp_path / "wal")
    oracle, tick = build_log(wc, wal_dir, make_feed(wc, 3, 30))
    crash = CrashInjector(1, only=seam)
    comp = WalCompactor(wal_dir=wal_dir, min_segments=2, keep_segments=1,
                        crash=crash)
    with pytest.raises(CrashPoint):
        comp.compact_once()
    got, got_tick, _rep = recovered_view(wc, wal_dir)
    assert got == oracle and got_tick == tick, f"{seam}: raw layout diverged"
    comp2 = WalCompactor(wal_dir=wal_dir, min_segments=2, keep_segments=1)
    comp2.compact_once()
    assert not [f for f in os.listdir(wal_dir) if f.endswith(".compact")]
    got, got_tick, _rep = recovered_view(wc, wal_dir)
    assert got == oracle and got_tick == tick, f"{seam}: recovery diverged"


def test_interrupted_tmp_rolled_back(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    oracle, tick = build_log(wc, wal_dir, make_feed(wc, 5, 20))
    seqs = [s for s, _ in list_segments(wal_dir)]
    stray = os.path.join(wal_dir, f"wal-{seqs[0]:08d}.log.compact")
    with open(stray, "wb") as f:
        f.write(b"garbage, not a segment")
    comp = WalCompactor(wal_dir=wal_dir, min_segments=64)  # fold nothing
    comp.compact_once()
    assert not os.path.exists(stray)
    got, got_tick, _rep = recovered_view(wc, wal_dir)
    assert got == oracle and got_tick == tick

    with open(stray, "wb") as f:
        f.write(_MAGIC + b"\x00" * 7)
    with open(os.path.join(wal_dir, COMPACT_MANIFEST_FILE), "w") as f:
        json.dump({"schema": "reflow.wal_compact/1", "gen": 1,
                   "reclaimed_bytes": 0,
                   "ranges": [{"out": seqs[0],
                               "covers": [seqs[0], seqs[1]], "gen": 1,
                               "bytes": 12345, "orig_bytes": 0,
                               "records_in": 0, "records_out": 0,
                               "tick_lo": None, "tick_hi": None}]}, f)
    comp.compact_once()
    assert not os.path.exists(stray)
    assert read_compact_manifest(wal_dir)["ranges"] == []
    got, got_tick, _rep = recovered_view(wc, wal_dir)
    assert got == oracle and got_tick == tick


# -- eligibility ------------------------------------------------------------

def test_eligibility_respects_checkpoint_anchor(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    ckpt_dir = str(tmp_path / "ckpt")
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=1 << 12)
    chain = CheckpointChain(ckpt_dir, delta_every=4)
    for t, batches in enumerate(make_feed(wc, 9, 30)):
        for bid, b in batches:
            sched.push(src, b, batch_id=bid)
        sched.tick()
        if t == 14:
            chain.save(sched)
    oracle = dict(sched.view(sink.name))
    tick = sched._tick
    sched.close()
    anchor = chain_head_wal_pos(ckpt_dir)
    assert anchor is not None
    comp = WalCompactor(wal_dir=wal_dir, ckpt_dir=ckpt_dir,
                        min_segments=1, keep_segments=1)
    rng = comp.eligible_range()
    assert rng is not None and rng[0] >= anchor[0]
    ev = comp.compact_once()
    assert ev is not None and ev["covers"][0] >= anchor[0]
    got, got_tick, rep = recovered_view(wc, wal_dir, ckpt_dir)
    assert got == oracle and got_tick == tick
    assert rep.checkpoint_loaded


def test_eligibility_min_and_keep_segments(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    build_log(wc, wal_dir, make_feed(wc, 5, 20))
    n_sealed = len(list_segments(wal_dir)) - 1
    assert n_sealed >= 2
    comp = WalCompactor(wal_dir=wal_dir, min_segments=n_sealed + 10,
                        keep_segments=0)
    assert comp.eligible_range() is None
    assert comp.compact_once() is None
    comp2 = WalCompactor(wal_dir=wal_dir, min_segments=1, keep_segments=2)
    rng = comp2.eligible_range()
    seqs = [s for s, _ in list_segments(wal_dir)]
    assert rng is not None
    assert set(rng).isdisjoint(seqs[-3:])  # open + 2 kept sealed


def test_eligibility_respects_attached_follower_cursor(tmp_path, wc):
    g, src, sink = wc.build()
    sched = wc.durable(g, str(tmp_path / "wal"), fsync="tick",
                       segment_bytes=1 << 12)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick,
                          max_chunk_bytes=1 << 10)
    replica = ReplicaScheduler(wc.build()[0], str(tmp_path / "r0"),
                               executor=wc.executor(), name="r0")
    ship.attach(replica)
    drive(sched, src, make_feed(wc, 2, 25))
    sched.wal.sync()
    ship.pump_once()  # one small chunk: cursor parked low in the log
    floor = ship.min_cursor()
    assert floor is not None
    comp = WalCompactor(sched.wal, shipper=ship, min_segments=1,
                        keep_segments=0)
    rng = comp.eligible_range()
    if rng is not None:
        assert max(rng) < floor.segment
    ev = comp.compact_once()
    if ev is not None:
        assert ev["covers"][1] < floor.segment
    sched.close()


# -- follower re-anchor across a compacted range ------------------------------

def test_follower_cursor_in_compacted_range_reanchors(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    ckpt_dir = str(tmp_path / "ckpt")
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=1 << 12)
    chain = CheckpointChain(ckpt_dir, delta_every=4)
    chain.save(sched)  # anchor at the log head
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
    assert ev is not None
    assert ev["covers"][0] == stale[0], \
        "test setup: stale cursor must sit in the rewritten out segment"
    ship.attach(replica)
    sched.wal.sync()
    for _ in range(200):
        ship.pump_once()
        if replica.published_horizon() == sched._tick:
            break
    assert ship.compact_reanchors >= 1
    assert replica.published_horizon() == sched._tick
    h, got = replica.view_at(sink2.name)
    want = {kv: w for kv, w in sched.view(sink.name).items() if w != 0}
    assert h == sched._tick and got == want
    sched.close()


def test_compacted_record_partial_dedup_fails_loud(wc):
    g, src, _sink = wc.build()
    sched = P.DirtyScheduler(g, wc.executor())
    sched.push(src, wc.ingest(["alpha"]), batch_id="a")
    sched.tick()
    b = wc.ingest(["alpha beta"])
    rec = {"kind": "push", "tick": 0, "node": src.id,
           "node_name": src.name, "batch_id": "a", "compacted": True,
           "batch_ids": ["a", "b"], "keys": b.keys, "values": b.values,
           "weights": b.weights}
    with pytest.raises(WalError, match="folded range"):
        replay_records(sched, [(None, rec)])
    assert replay_records(sched, [(None, dict(rec, batch_ids=["a"],
                                              batch_id="a"))]) \
        == (0, 1, 0, 0)
    assert replay_records(sched, [(None, dict(rec, batch_ids=["x", "y"],
                                              batch_id="x"))]) \
        == (1, 0, 0, 0)


def test_control_plane_supervises_compactor(tmp_path, wc):
    # the ControlPlane boots a cold compactor for free, surfaces pass
    # events as wal_compact actions, respawns a dead thread within the
    # budget, and fails fast past it (respawn-or-fail-fast, same stance
    # as the WAL committer)
    from reflow_tpu_torch.serve import ControlConfig, ControlPlane, ServeTier

    wal_dir = str(tmp_path / "wal")
    build_log(wc, wal_dir, make_feed(wc, 8, 30))
    comp = WalCompactor(wal_dir=wal_dir, interval_s=3600.0,
                        min_segments=2, keep_segments=1)
    tier = ServeTier(max_bytes=1 << 20, pump_threads=1)
    cp = ControlPlane(tier, config=ControlConfig(max_compactor_restarts=2),
                      compactor=comp, sampler=lambda now: {"graphs": {}})
    try:
        cp.step(0.0)
        assert comp.alive  # free boot, no budget spent
        ev = comp.compact_once()  # synchronous pass queues an event
        assert ev is not None
        actions = cp.step(1.0)
        compacts = [a for a in actions if a["kind"] == "wal_compact"]
        assert len(compacts) == 1
        assert compacts[0]["covers"] == ev["covers"]
        assert compacts[0]["reclaimed_bytes"] == ev["reclaimed_bytes"]
        # kill the thread twice: budgeted respawns
        for i in (1, 2):
            comp.stop()
            acts = cp.step(1.0 + i)
            assert [a["kind"] for a in acts] == ["compactor_restart"]
            assert comp.alive
        # third death exhausts the budget: fail fast, stay failed
        comp.stop()
        acts = cp.step(10.0)
        assert [a["kind"] for a in acts] == ["compactor_failed"]
        assert not comp.alive
        assert cp.step(11.0) == []
    finally:
        cp.stop()
        comp.close()
        tier.close()


def test_compactor_metrics_publish_and_close(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    build_log(wc, wal_dir, make_feed(wc, 1, 20))
    reg = MetricsRegistry()
    comp = WalCompactor(wal_dir=wal_dir, min_segments=2, keep_segments=1)
    comp.publish_metrics(reg)
    comp.compact_once()
    assert reg.value("compact.folds") == 1
    assert reg.value("compact.reclaimed_bytes") > 0
    assert reg.value("compact.log_bytes") == comp.log_bytes()
    comp.close()
    assert reg.value("compact.folds") is None  # unregistered on close


# -- across the packages ------------------------------------------------------

def _segment_bytes(wal_dir):
    out = {}
    for _seq, path in list_segments(wal_dir):
        with open(path, "rb") as f:
            out[os.path.basename(path)] = f.read()
    return out


def _jax_view(wal_dir):
    g, _src, sink = jwc.build_graph()
    sched = JDirtyScheduler(g)
    jrecover(sched, wal_dir)
    return dict(sched.view(sink.name)), sched._tick


def test_folds_identical_across_packages_and_jax_recovers_port_fold(
        tmp_path):
    """Copies of one port-written log (string keys, retractions), folded
    by the JAX compactor and by the port's: the same segments byte for
    byte and the same manifest; the port-folded log recovers in the JAX
    package to the JAX recovery's views of the unfolded log."""
    src_dir = str(tmp_path / "orig")
    build_log(WC("cpu"), src_dir, make_feed(WC("cpu"), 7, 30))
    want, want_tick = _jax_view(src_dir)
    dirs = {}
    for name, cls in (("jax", JWalCompactor), ("port", WalCompactor)):
        d = dirs[name] = str(tmp_path / name)
        shutil.copytree(src_dir, d)
        ev = cls(wal_dir=d, min_segments=2, keep_segments=1).compact_once()
        assert ev is not None and ev["records_out"] < ev["records_in"]
    assert _segment_bytes(dirs["jax"]) == _segment_bytes(dirs["port"])
    with open(os.path.join(dirs["jax"], COMPACT_MANIFEST_FILE)) as f:
        jm = json.load(f)
    assert jm == read_compact_manifest(dirs["port"])
    got, got_tick = _jax_view(dirs["port"])
    assert got == want and got_tick == want_tick
