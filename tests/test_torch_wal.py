"""The port's write-ahead log, durable scheduler and recovery
(``reflow_tpu_torch.wal``) against ``tests/test_wal.py`` and the JAX
package, on the CPU.

Every test of ``tests/test_wal.py`` has a counterpart here: the log's
framing, rotation and truncation, torn tail against sealed corruption,
the crash differential (a killed, torn, recovered run's sink view equals
an uninterrupted run's), each crash seam, checkpoint plus tail, group
commit, committer death, ``when_durable`` order, the idle-tick fsync
skip, the metrics and the lossy transport's delivery errors. The ones
that drive a scheduler run twice: over the port's CPU oracle (string
keys) and over its ``"cuda"`` executor at ``device="cpu"`` (its plain
PyTorch path; integer keys from one fixed vocabulary). Views are held
equal exactly: the counts are small integers.

Across the packages: the same appends give byte-identical segment files,
a log either package's ``DurableScheduler`` wrote (crashed and torn)
recovers in the other to equal views, ``tools/wal_inspect.py`` reads a
log the port wrote, and a log the JAX ``WalCompactor`` folded recovers
in the port to the JAX recovery's views.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.wal import DurableScheduler as JDurableScheduler
from reflow_tpu.wal import WalCompactor
from reflow_tpu.wal import WriteAheadLog as JWriteAheadLog
from reflow_tpu.wal import recover as jrecover
from reflow_tpu.workloads import wordcount as jwc
from reflow_tpu_torch.utils.checkpoint import save_checkpoint
from reflow_tpu_torch.utils.faults import (CrashInjector, CrashPoint,
                                           DeliveryError, FaultyChannel,
                                           StormInjector, tear_wal_tail)
from reflow_tpu_torch.utils.metrics import summarize, summarize_wal
from reflow_tpu_torch.wal import (DurableScheduler, WalError, WriteAheadLog,
                                  recover, scan_wal)
from reflow_tpu_torch.wal.log import LogPosition, list_segments
from reflow_tpu_torch.workloads import wordcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: every word the feeds use, interned once: the cuda executor's integer
#: keys are the same in every run of a test (ingest never extends it)
WORDS = [f"w{i}" for i in range(40)] + list("abcdxyz")
VOCAB = {w: i for i, w in enumerate(WORDS)}
KEY_SPACE = 64
KINDS = ["cpu", "cuda"]


class WC:
    """Word-count over one executor kind: ``cpu`` is the port's oracle
    with string keys, ``cuda`` the port's device executor on the CPU
    with vocabulary keys."""

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

    def plain(self, g):
        return P.DirtyScheduler(g, self.executor())

    def ingest(self, lines, weight=1):
        if self.kind != "cuda":
            return wordcount.ingest_lines(lines, weight=weight)
        vocab = dict(VOCAB)
        b = wordcount.ingest_lines(lines, weight=weight, vocab=vocab)
        assert len(vocab) == len(VOCAB), "a word outside WORDS"
        return b


@pytest.fixture(params=KINDS)
def wc(request):
    return WC(request.param)


# -- feed / drive helpers ---------------------------------------------------

def make_feed(wc, seed: int, n_ticks: int = 10):
    """Deterministic per-tick [(batch_id, DeltaBatch)] lists with
    retractions mixed in (``tests/test_wal.py``'s feed)."""
    rng = np.random.default_rng(seed)
    feed = []
    for t in range(n_ticks):
        batches = []
        for j in range(int(rng.integers(1, 3))):
            words = " ".join(
                f"w{int(x)}" for x in rng.integers(0, 25,
                                                   int(rng.integers(2, 8))))
            weight = -1 if (t > 2 and rng.random() < 0.2) else 1
            batches.append((f"t{t}b{j}", wc.ingest([words], weight=weight)))
        feed.append(batches)
    return feed


def drive(sched, src, feed):
    for batches in feed:
        for bid, b in batches:
            sched.push(src, b, batch_id=bid)
        sched.tick()


def clean_run(wc, feed):
    g, src, sink = wc.build()
    sched = wc.plain(g)
    drive(sched, src, feed)
    return dict(sched.view(sink.name))


def resume_from_cursor(sched, src, feed):
    """A restarted upstream re-sends everything from its cursor with the
    same batch ids; the dedup window drops what already folded."""
    drive(sched, src, feed)


def push_rec(b, bid="b0", node=0, name="w"):
    return {"kind": "push", "tick": 0, "node": node, "node_name": name,
            "batch_id": bid, "keys": b.keys, "values": b.values,
            "weights": b.weights}


# -- log mechanics ----------------------------------------------------------

def test_append_scan_roundtrip(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="record")
    b = wordcount.ingest_lines(["a b a"])
    p0 = wal.append(push_rec(b, name="words"))
    p1 = wal.append({"kind": "tick", "tick": 1})
    wal.close()
    records, torn = scan_wal(str(tmp_path))
    assert torn is None
    assert [pos for pos, _ in records] == [p0, p1]
    assert records[0][1]["batch_id"] == "b0"
    assert list(records[0][1]["keys"]) == list(b.keys)
    assert records[1][1] == {"kind": "tick", "tick": 1}
    assert wal.appends == 2 and wal.fsyncs >= 2 and wal.bytes_written > 0


def test_segment_rotation_and_truncate(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="os", segment_bytes=256)
    for i in range(64):
        wal.append({"kind": "tick", "tick": i})
    wal.close()
    segs = list_segments(str(tmp_path))
    assert len(segs) > 1, "256-byte segments must have rotated"
    records, torn = scan_wal(str(tmp_path))
    assert torn is None
    assert [r["tick"] for _p, r in records] == list(range(64))
    cut = segs[2][0]
    wal2 = WriteAheadLog(str(tmp_path), fsync="os")
    removed = wal2.truncate_until(LogPosition(cut, 8))
    wal2.close()
    assert len(removed) == 2
    assert all(seq >= cut for seq, _ in list_segments(str(tmp_path)))
    kept, _ = scan_wal(str(tmp_path))
    assert [r["tick"] for _p, r in kept if r["kind"] == "tick"] \
        == [r["tick"] for p, r in records
            if p.segment >= cut and r["kind"] == "tick"]


def test_torn_tail_tolerated_but_sealed_corruption_raises(tmp_path):
    torn_dir = str(tmp_path / "torn")
    wal = WriteAheadLog(torn_dir, fsync="os")
    for i in range(10):
        wal.append({"kind": "tick", "tick": i})
    wal.close()
    full, _ = scan_wal(torn_dir)
    assert tear_wal_tail(torn_dir, 5) is not None
    records, torn = scan_wal(torn_dir)
    assert torn is not None and "truncated" in torn.reason
    assert len(records) == len(full) - 1

    sealed_dir = str(tmp_path / "sealed")
    wal = WriteAheadLog(sealed_dir, fsync="os", segment_bytes=200)
    for i in range(40):
        wal.append({"kind": "tick", "tick": i})
    wal.close()
    seg0 = list_segments(sealed_dir)[0][1]
    with open(seg0, "rb+") as f:
        f.seek(20)
        byte = f.read(1)
        f.seek(20)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(WalError):
        scan_wal(sealed_dir)


def test_fresh_writer_never_appends_to_existing_segment(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="os")
    wal.append({"kind": "tick", "tick": 1})
    wal.close()
    tear_wal_tail(str(tmp_path), 3)
    wal2 = WriteAheadLog(str(tmp_path), fsync="os")
    wal2.append({"kind": "tick", "tick": 2})
    wal2.close()
    records, torn = scan_wal(str(tmp_path))
    assert torn is None
    assert [r["tick"] for _p, r in records] == [2]


# -- crash-recovery differential --------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_crash_recovery_differential(tmp_path, wc, seed):
    """Kill at an arbitrary seam, maybe tear the final record, recover,
    resume from the upstream cursor: the view equals the clean run's."""
    feed = make_feed(wc, seed)
    want = clean_run(wc, feed)
    rng = np.random.default_rng(1000 + seed)
    wal_dir = str(tmp_path / "wal")
    g, src, _sink = wc.build()
    crash = CrashInjector(int(rng.integers(1, 60)))
    sched = wc.durable(g, wal_dir, fsync="record", crash=crash)
    with pytest.raises(CrashPoint):
        drive(sched, src, feed)
        raise CrashPoint("end-of-feed")
    sched.wal.drain()
    if crash.fired and rng.random() < 0.5:
        tear_wal_tail(wal_dir, int(rng.integers(1, 24)))
    g2, src2, sink2 = wc.build()
    sched2 = wc.durable(g2, wal_dir, fsync="record")
    report = recover(sched2, wal_dir)
    resume_from_cursor(sched2, src2, feed)
    assert dict(sched2.view(sink2.name)) == want, (
        f"seed {seed}: crashed at {crash.seams[-1] if crash.seams else '?'}"
        f"; report={report.as_dict()}")
    sched2.close()


@pytest.mark.parametrize("seam", ["before_append", "after_append",
                                  "after_push", "before_tick_mark"])
def test_crash_at_each_seam(tmp_path, wc, seam):
    feed = make_feed(wc, 99)
    want = clean_run(wc, feed)
    wal_dir = str(tmp_path / seam)
    g, src, _sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick",
                       crash=CrashInjector(7, only=seam))
    with pytest.raises(CrashPoint):
        drive(sched, src, feed)
    sched.wal.drain()
    g2, src2, sink2 = wc.build()
    sched2 = wc.durable(g2, wal_dir, fsync="tick")
    recover(sched2, wal_dir)
    resume_from_cursor(sched2, src2, feed)
    assert dict(sched2.view(sink2.name)) == want
    sched2.close()


@pytest.mark.parametrize("seed", range(4))
def test_checkpoint_plus_tail_recovery(tmp_path, wc, seed):
    """After a checkpoint the covered segments are gone, and checkpoint
    plus tail recovers the clean run's view (pre-checkpoint re-sends
    dedup)."""
    import pickle

    feed = make_feed(wc, 200 + seed, n_ticks=12)
    want = clean_run(wc, feed)
    rng = np.random.default_rng(300 + seed)
    wal_dir = str(tmp_path / "wal")
    ckpt_dir = str(tmp_path / "ckpt")
    g, src, _sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=512)
    ckpt_at = int(rng.integers(3, 9))
    for t, batches in enumerate(feed):
        for bid, b in batches:
            sched.push(src, b, batch_id=bid)
        sched.tick()
        if t == ckpt_at:
            save_checkpoint(sched, ckpt_dir)
            with open(os.path.join(ckpt_dir, "meta.pkl"), "rb") as f:
                wal_pos = pickle.load(f)["wal_pos"]
            assert all(s >= wal_pos[0]
                       for s, _p in list_segments(wal_dir))
        if t == ckpt_at + 2:
            break
    sched.wal.drain()
    if rng.random() < 0.5:
        tear_wal_tail(wal_dir, int(rng.integers(1, 16)))
    g2, src2, sink2 = wc.build()
    sched2 = wc.durable(g2, wal_dir, fsync="tick")
    report = recover(sched2, wal_dir, ckpt_dir)
    assert report.checkpoint_loaded and report.checkpoint_tick == ckpt_at + 1
    resume_from_cursor(sched2, src2, feed)
    assert dict(sched2.view(sink2.name)) == want, report.as_dict()
    sched2.close()


def test_recovery_without_resume_matches_prefix(tmp_path, wc):
    feed = make_feed(wc, 7)
    wal_dir = str(tmp_path / "wal")
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="record")
    drive(sched, src, feed)
    want = dict(sched.view(sink.name))
    g2, _src2, sink2 = wc.build()
    sched2 = wc.plain(g2)  # recovery also works on a plain scheduler
    report = recover(sched2, wal_dir)
    assert report.replayed_pushes > 0 and report.replayed_ticks == len(feed)
    assert dict(sched2.view(sink2.name)) == want
    assert sched2._tick == sched._tick
    sched.close()


def test_auto_minted_ids_replay_once(tmp_path, wc):
    wal_dir = str(tmp_path / "wal")
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="record")
    sched.push(src, wc.ingest(["a b"]))
    sched.push(src, wc.ingest(["b c"]))
    sched.tick()
    want = dict(sched.view(sink.name))
    g2, src2, sink2 = wc.build()
    sched2 = wc.durable(g2, wal_dir, fsync="record")
    recover(sched2, wal_dir)
    assert dict(sched2.view(sink2.name)) == want
    assert sched2.push(src2, wc.ingest(["d"]))
    sched2.tick()
    assert dict(sched2.view(sink2.name)) != want
    sched2.close()


def test_wal_metrics_and_summary(tmp_path, wc):
    feed = make_feed(wc, 3, n_ticks=5)
    wal_dir = str(tmp_path / "wal")
    g, src, _sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick")
    drive(sched, src, feed)
    wm = summarize_wal(sched.wal)
    assert wm.fsync_policy == "tick"
    assert wm.appends == sched.wal.appends > len(feed)
    assert wm.fsyncs == len(feed)  # one barrier per tick
    assert wm.append_p95_s >= wm.append_p50_s > 0.0
    s = summarize(sched.history)
    assert s.ticks == len(feed) and s.delta_ops > 0
    g2, _src2, _sink2 = wc.build()
    sched2 = wc.durable(g2, wal_dir, fsync="tick")
    report = recover(sched2, wal_dir)
    wm2 = summarize_wal(sched2.wal, recovery=report)
    assert wm2.replayed_pushes == report.replayed_pushes > 0
    assert wm2.replayed_ticks == len(feed)
    assert json.loads(json.dumps(wm2.to_dict()))["appends"] == wm2.appends
    sched2.close()


def test_wal_inspect_tool_reads_a_port_log(tmp_path, wc):
    """The JAX package's ``tools/wal_inspect.py`` reads a log the port
    wrote: the formats are one."""
    feed = make_feed(wc, 5, n_ticks=4)
    wal_dir = str(tmp_path / "wal")
    g, src, _sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="os")
    drive(sched, src, feed)
    sched.close()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    tool = os.path.join(REPO, "tools", "wal_inspect.py")
    out = subprocess.run([sys.executable, tool, wal_dir, "--json"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)
    assert summary["record_kinds"]["tick"] == len(feed)
    assert summary["record_kinds"]["push"] == sum(len(t) for t in feed)
    assert summary["torn_tail"] is None
    tear_wal_tail(wal_dir, 4)
    out = subprocess.run([sys.executable, tool, wal_dir, "--json",
                          "--verify"], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["torn_tail"] is not None


# -- delivery faults raise loudly even under python -O ----------------------

def test_flush_raises_on_rejected_first_delivery(wc):
    g, src, _sink = wc.build()
    sched = wc.plain(g)
    sched.push(src, wc.ingest(["a"]), batch_id="b0")
    chan = FaultyChannel(sched, src, drop_p=0.0, dup_p=0.0, seed=1)
    chan._unacked.append(("b0", wc.ingest(["a"])))
    with pytest.raises(DeliveryError):
        chan.flush()


def test_pump_raises_when_duplicate_accepted(wc):
    g, src, _sink = wc.build()
    sched = wc.plain(g)
    sched.push = lambda *a, **k: True  # a scheduler that lost its dedup
    chan = FaultyChannel(sched, src, drop_p=0.0, dup_p=1.0, seed=0)
    with pytest.raises(DeliveryError):
        chan.send(wc.ingest(["a"]), "b0")


def test_faulty_channel_is_exactly_once(wc):
    """Drops, duplicates and reorders through the transport, then flush:
    the view equals the clean run's (the dedup window drops every
    duplicate)."""
    feed = make_feed(wc, 11, n_ticks=8)
    want = clean_run(wc, feed)
    g, src, sink = wc.build()
    sched = wc.plain(g)
    chan = FaultyChannel(sched, src, drop_p=0.3, dup_p=0.3, seed=4)
    for batches in feed:
        for bid, b in batches:
            chan.send(b, bid)
    chan.flush()
    sched.tick()
    assert chan.stats["duplicated"] > 0 and chan.stats["dropped"] > 0
    assert dict(sched.view(sink.name)) == want


def test_storm_injector_kills_every_visit_until_disarmed(tmp_path, wc):
    """A crash storm: every matching seam visit dies while armed (each
    revival of the writer crashes again), none once disarmed; the log
    still recovers to the batches that were logged."""
    storm = StormInjector(only="before_append")
    wal_dir = str(tmp_path / "wal")
    for i in range(3):
        g, src, _sink = wc.build()
        sched = wc.durable(g, wal_dir, crash=storm)
        with pytest.raises(CrashPoint):
            sched.push(src, wc.ingest(["a b"]), batch_id=f"s{i}")
        sched.close()
    assert storm.crashes == 3 and storm.seams == ["before_append"] * 3
    storm.disarm()
    g2, src2, sink2 = wc.build()
    sched = wc.durable(g2, wal_dir, crash=storm)
    assert sched.push(src2, wc.ingest(["a b"]), batch_id="ok")
    sched.tick()
    sched.close()
    assert storm.crashes == 3
    g3, _src3, sink3 = wc.build()
    fresh = wc.plain(g3)
    rep = recover(fresh, wal_dir)
    assert rep.replayed_pushes == 1
    assert dict(fresh.view(sink3.name)) == dict(sched.view(sink2.name))


def test_empty_history_summary_keyword_constructed():
    s = summarize([])
    assert s.ticks == 0 and s.delta_ops == 0
    assert s.quiesced_all is True and s.forced_syncs == 0


# -- group commit ------------------------------------------------------------

def test_append_group_one_fsync_covers_the_group(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="record")
    fsyncs0 = wal.fsyncs
    poss = wal.append_group([{"kind": "tick", "tick": i} for i in range(5)])
    assert len(poss) == 5
    assert wal.fsyncs == fsyncs0 + 1
    assert wal.group_sizes[-1] == 5
    wal.close()
    records, torn = scan_wal(str(tmp_path))
    assert torn is None
    assert [r["tick"] for _p, r in records] == list(range(5))


def test_individual_appends_record_group_size_one(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="record")
    for i in range(3):
        wal.append({"kind": "tick", "tick": i})
    wal.close()
    assert list(wal.group_sizes) == [1, 1, 1]
    assert wal.fsyncs >= 3


def test_group_commit_survives_rotation(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="record", segment_bytes=256)
    wal.append_group([{"kind": "tick", "tick": i} for i in range(64)])
    wal.close()
    assert len(list_segments(str(tmp_path))) > 1
    records, torn = scan_wal(str(tmp_path))
    assert torn is None
    assert [r["tick"] for _p, r in records] == list(range(64))


def test_append_group_rotation_mid_window_atomic_replay(tmp_path, wc):
    """A window whose group rotates mid-way: the sealed segment is
    fsynced at the rotation, and each ``batch_ids`` unit replays all or
    nothing across the boundary."""
    wal_dir = str(tmp_path / "wal")
    g, src, _sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=1024,
                       crash=CrashInjector(at=1, only="after_append"))
    feeds, feed_ids = [], []
    for t in range(8):
        lines = [" ".join(f"w{(t * 7 + k) % 13}" for k in range(40))]
        feeds.append({src: wc.ingest(lines)})
        feed_ids.append({src: [f"t{t}a", f"t{t}b"]})
    with pytest.raises(CrashPoint):
        sched.tick_many(feeds, feed_ids=feed_ids)
    sched.wal.drain()
    segs = list_segments(wal_dir)
    assert len(segs) > 1, "window did not span a rotation; shrink segments"
    assert sched.wal.fsyncs == len(segs) - 1
    records, torn = scan_wal(wal_dir)
    assert torn is None and len(records) == 8
    g2, _src2, sink2 = wc.build()
    fresh = wc.durable(g2, wal_dir, fsync="tick")
    report = recover(fresh, wal_dir)
    fresh.tick()
    fresh.close()
    assert report.replayed_pushes == 8
    g3, src3, sink3 = wc.build()
    want = wc.plain(g3)
    for feed in feeds:
        for _src, batch in feed.items():
            want.push(src3, batch)
        want.tick()
    assert dict(fresh.view(sink2.name)) == dict(want.view(sink3.name))
    g4, _src4, _sink4 = wc.build()
    again = wc.durable(g4, wal_dir, fsync="tick")
    again._register_batch_id("t4a")
    report2 = recover(again, wal_dir)
    again.tick()
    again.close()
    assert report2.replayed_pushes == 7
    assert report2.deduped_pushes == 1


def test_empty_group_is_a_noop(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="record")
    fsyncs0 = wal.fsyncs
    assert wal.append_group([]) == []
    assert wal.fsyncs == fsyncs0 and wal.appends == 0
    wal.close()


def test_wal_metrics_report_group_shape(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="record")
    wal.append({"kind": "tick", "tick": 0})
    wal.append_group([{"kind": "tick", "tick": i} for i in range(1, 5)])
    wal.close()
    wm = summarize_wal(wal)
    assert wm.group_commits == len(wal.group_sizes)
    assert wm.group_max == 4.0
    assert wm.as_dict()["group_p50"] >= 1.0


def test_coalesced_batch_ids_replay_all_or_nothing(tmp_path, wc):
    g, src, sink = wc.build()
    wal_dir = str(tmp_path / "wal")
    sched = wc.durable(g, wal_dir)
    sched.tick_many([{src: wc.ingest(["a b"])}, {src: wc.ingest(["b c"])}],
                    feed_ids=[{src: ["m0", "m1"]}, {src: ["m2"]}])
    want = dict(sched.view(sink.name))
    sched.close()
    g2, _src2, sink2 = wc.build()
    fresh = wc.durable(g2, wal_dir)
    report = recover(fresh, wal_dir)
    fresh.close()
    assert dict(fresh.view(sink2.name)) == want
    assert report.replayed_pushes == 2
    for bid in ("m0", "m1", "m2"):
        assert bid in fresh._seen_batch_ids
    g3, _src3, _sink3 = wc.build()
    again = wc.durable(g3, wal_dir)
    again._register_batch_id("m1")
    report2 = recover(again, wal_dir)
    again.close()
    assert report2.deduped_pushes >= 1


# -- the asynchronous committer ---------------------------------------------

PIPELINE_SEAMS = ["wal_enqueue", "wal_before_write", "wal_after_write",
                  "wal_before_fsync", "wal_after_fsync"]


@pytest.mark.parametrize("seam", PIPELINE_SEAMS)
def test_committer_seam_crash_replays_exactly_once(tmp_path, wc, seam):
    feed = make_feed(wc, 7)
    want = clean_run(wc, feed)
    wal_dir = str(tmp_path / seam)
    g, src, _sink = wc.build()
    crash = CrashInjector(3, only=seam)
    sched = wc.durable(g, wal_dir, fsync="record", crash=crash)
    with pytest.raises(CrashPoint):
        drive(sched, src, feed)
    assert crash.fired
    with contextlib.suppress(CrashPoint):
        sched.wal.drain()
    g2, src2, sink2 = wc.build()
    sched2 = wc.durable(g2, wal_dir, fsync="record")
    recover(sched2, wal_dir)
    resume_from_cursor(sched2, src2, feed)
    assert dict(sched2.view(sink2.name)) == want
    sched2.close()


def test_committer_death_fails_waiters_and_callbacks(tmp_path):
    crash = CrashInjector(1, only="wal_before_fsync")
    wal = WriteAheadLog(str(tmp_path), fsync="record", crash=crash)
    rec = push_rec(wordcount.ingest_lines(["a b"]))
    got = []
    fired = threading.Event()
    wal.append(rec, wait=False)
    lsn = wal.last_lsn()
    try:
        pending = wal.when_durable(
            lsn, lambda err: (got.append(err), fired.set()))
    except CrashPoint:
        pending = False
    if pending:
        assert fired.wait(timeout=10.0), "continuation never resolved"
        assert isinstance(got[0], CrashPoint)
    with pytest.raises(CrashPoint):
        wal.wait_durable(lsn)
    with pytest.raises(CrashPoint):
        wal.append(rec, wait=False)


def test_drain_is_write_barrier_not_fsync_barrier(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="tick")
    b = wordcount.ingest_lines(["a b a"])
    for j in range(3):
        wal.append(push_rec(b, f"b{j}"), wait=False)
    fsyncs0 = wal.fsyncs
    wal.drain()
    assert wal.queue_depth() == 0
    records, torn = scan_wal(str(tmp_path))
    assert torn is None and len(records) == 3
    assert wal.fsyncs == fsyncs0
    assert wal.durable_lsn() < wal.last_lsn()
    wal.note_tick()
    wal.wait_durable(wal.last_lsn())
    assert wal.durable_lsn() == wal.last_lsn()
    wal.close()


def test_when_durable_fires_in_lsn_order(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="tick")
    b = wordcount.ingest_lines(["x"])
    lsns = []
    for j in range(4):
        wal.append(push_rec(b, f"b{j}"), wait=False)
        lsns.append(wal.last_lsn())
    fired = []
    for lsn in lsns:
        assert wal.when_durable(lsn, lambda err, lsn=lsn:
                                fired.append((lsn, err)))
    wal.note_tick()
    wal.wait_durable(lsns[-1])
    assert fired == [(lsn, None) for lsn in lsns]
    assert wal.when_durable(lsns[-1], lambda err: None) is False
    wal.close()


def test_idle_tick_and_seal_skip_fsync(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="tick")
    wal.append(push_rec(wordcount.ingest_lines(["a b"])), wait=False)
    wal.note_tick()
    n = wal.fsyncs
    wal.note_tick()
    wal.note_tick()
    assert wal.fsyncs == n
    wal.close()
    assert wal.fsyncs == n


def test_lockcheck_wraps_the_committer_locks(tmp_path, monkeypatch):
    """With ``REFLOW_LOCKCHECK=1`` the log's locks are monitor-wrapped
    (the committer's Conditions included), the pipeline still commits,
    and its one lock order (``wal.log`` before ``wal.sync``) is what the
    monitor records; the inverse order then raises."""
    from reflow_tpu_torch.utils import runtime

    monkeypatch.setenv("REFLOW_LOCKCHECK", "1")
    mon = runtime.LockOrderMonitor()
    monkeypatch.setattr(runtime, "LOCK_MONITOR", mon)
    wal = WriteAheadLog(str(tmp_path), fsync="record")
    assert isinstance(wal._lock, runtime.NamedLock)
    for i in range(4):
        wal.append({"kind": "tick", "tick": i})
    wal.close()
    assert [r["tick"] for _p, r in scan_wal(str(tmp_path))[0]] \
        == list(range(4))
    assert "wal.sync" in mon.edges().get("wal.log", set())
    with pytest.raises(runtime.LockOrderError):
        with wal._sync_lock:
            with wal._lock:
                pass


# -- across the packages ------------------------------------------------------

def _records(n_push: int = 6):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n_push):
        keys = rng.integers(0, 50, 7)
        out.append({"kind": "push", "tick": i, "node": 0,
                    "node_name": "words", "batch_id": f"b{i}",
                    "keys": keys,
                    "values": rng.standard_normal((7, 3)).astype(np.float32),
                    "weights": np.where(keys % 3 == 0, -1, 1)})
        out.append({"kind": "tick", "tick": i + 1})
    out.append({"kind": "ckpt", "tick": n_push, "path": "/ckpt"})
    return out


def _segments(d):
    return {os.path.basename(p): open(p, "rb").read()
            for _s, p in list_segments(d)}


@pytest.mark.parametrize("committer", ["inline", "thread"])
@pytest.mark.parametrize("epoch", [0, 3])
def test_segment_files_identical_across_packages(tmp_path, committer,
                                                 epoch):
    """The same appends (single and grouped, rotating) through the JAX
    ``WriteAheadLog`` and the port's give byte-identical segments, the
    epoch stamp included."""
    recs = _records()
    dirs = {}
    for name, cls in (("jax", JWriteAheadLog), ("port", WriteAheadLog)):
        d = dirs[name] = str(tmp_path / name)
        wal = cls(d, fsync="tick", segment_bytes=700, committer=committer,
                  epoch=epoch)
        for r in recs[:5]:
            wal.append(r)
        wal.append_group(recs[5:])
        wal.note_tick()
        wal.close()
    jax_segs, port_segs = _segments(dirs["jax"]), _segments(dirs["port"])
    assert len(port_segs) > 1
    assert jax_segs == port_segs


def test_durable_logs_identical_across_packages(tmp_path):
    """The JAX ``DurableScheduler`` and the port's, fed the same batches
    (pushes, ticks and a coalesced ``tick_many`` window), write
    byte-identical logs."""
    dirs = {}
    for name in ("jax", "port"):
        mod = jwc if name == "jax" else wordcount
        feed = (_jax_feed(21, 4, keyed=False) if name == "jax"
                else make_feed(WC("cpu"), 21, n_ticks=4))
        g, src, _sink = mod.build_graph()
        d = dirs[name] = str(tmp_path / name)
        sched = (JDurableScheduler if name == "jax" else DurableScheduler)(
            g, wal_dir=d, fsync="tick", segment_bytes=600)
        drive(sched, src, feed)
        sched.tick_many([{src: mod.ingest_lines(["a b"])},
                         {src: mod.ingest_lines(["b c"])}],
                        feed_ids=[{src: ["m0", "m1"]}, {src: ["m2"]}])
        sched.close()
    assert _segments(dirs["jax"]) == _segments(dirs["port"])


def _jax_feed(seed, n_ticks, keyed):
    """``make_feed``'s feed built with the JAX package's ingest (vocab
    keys when ``keyed``)."""
    rng = np.random.default_rng(seed)
    feed = []
    for t in range(n_ticks):
        batches = []
        for j in range(int(rng.integers(1, 3))):
            words = " ".join(
                f"w{int(x)}" for x in rng.integers(0, 25,
                                                   int(rng.integers(2, 8))))
            weight = -1 if (t > 2 and rng.random() < 0.2) else 1
            batches.append((f"t{t}b{j}", jwc.ingest_lines(
                [words], weight=weight,
                vocab=dict(VOCAB) if keyed else None)))
        feed.append(batches)
    return feed


def _as_port(b):
    return P.DeltaBatch(b.keys, b.values, b.weights)


@pytest.mark.parametrize("seed", range(3))
def test_jax_written_log_recovers_in_the_port(tmp_path, wc, seed):
    """A log the JAX ``DurableScheduler`` wrote, killed at a seam and
    torn, recovers in the port to the JAX recovery's view, and the
    resent feed then gives the clean run's."""
    keyed = wc.kind == "cuda"
    jfeed = _jax_feed(40 + seed, 10, keyed)
    rng = np.random.default_rng(50 + seed)
    wal_dir = str(tmp_path / "wal")
    jg, jsrc, _ = jwc.build_graph(KEY_SPACE if keyed else 0)
    jsched = JDurableScheduler(jg, wal_dir=wal_dir, fsync="tick",
                               segment_bytes=1024,
                               crash=CrashInjector(int(rng.integers(5, 40))))
    with pytest.raises(CrashPoint):
        drive(jsched, jsrc, jfeed)
        raise CrashPoint("end-of-feed")
    jsched.wal.drain()
    tear_wal_tail(wal_dir, int(rng.integers(1, 24)))
    jcopy = str(tmp_path / "jcopy")
    shutil.copytree(wal_dir, jcopy)
    jg2, _s, jsink2 = jwc.build_graph(KEY_SPACE if keyed else 0)
    jfresh = JDirtyScheduler(jg2)
    jrep = jrecover(jfresh, jcopy)
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick")
    rep = recover(sched, wal_dir)
    assert dict(sched.view(sink.name)) == dict(jfresh.view(jsink2.name))
    assert (rep.replayed_pushes, rep.replayed_ticks) \
        == (jrep.replayed_pushes, jrep.replayed_ticks)
    feed = [[(bid, _as_port(b)) for bid, b in t] for t in jfeed]
    resume_from_cursor(sched, src, feed)
    assert dict(sched.view(sink.name)) == clean_run(wc, feed)
    sched.close()


@pytest.mark.parametrize("seed", range(3))
def test_port_written_log_recovers_in_jax(tmp_path, wc, seed):
    """The reverse: the port's durable scheduler, killed and torn; the
    JAX recovery and the port's give equal views."""
    feed = make_feed(wc, 60 + seed)
    rng = np.random.default_rng(70 + seed)
    wal_dir = str(tmp_path / "wal")
    g, src, _sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=1024,
                       crash=CrashInjector(int(rng.integers(5, 40))))
    with pytest.raises(CrashPoint):
        drive(sched, src, feed)
        raise CrashPoint("end-of-feed")
    sched.wal.drain()
    tear_wal_tail(wal_dir, int(rng.integers(1, 24)))
    keyed = wc.kind == "cuda"
    jg, _s, jsink = jwc.build_graph(KEY_SPACE if keyed else 0)
    jfresh = JDirtyScheduler(jg)
    jrep = jrecover(jfresh, wal_dir)
    g2, _src2, sink2 = wc.build()
    fresh = wc.plain(g2)
    rep = recover(fresh, wal_dir)
    assert rep.replayed_ticks == jrep.replayed_ticks > 0
    assert dict(fresh.view(sink2.name)) == dict(jfresh.view(jsink.name))


def test_jax_compacted_log_recovers_in_the_port(tmp_path, wc):
    """A log the JAX ``WalCompactor`` folded (records carrying
    ``compacted`` and several ``batch_ids``) recovers in the port to
    the JAX recovery's view and tick."""
    keyed = wc.kind == "cuda"
    jfeed = _jax_feed(7, 30, keyed)
    wal_dir = str(tmp_path / "wal")
    jg, jsrc, jsink = jwc.build_graph(KEY_SPACE if keyed else 0)
    jsched = JDurableScheduler(jg, wal_dir=wal_dir, fsync="tick",
                               segment_bytes=1 << 12)
    drive(jsched, jsrc, jfeed)
    oracle = dict(jsched.view(jsink.name))
    jsched.close()
    comp = WalCompactor(wal_dir=wal_dir, min_segments=2, keep_segments=1)
    assert comp.compact_once() is not None
    records, _ = scan_wal(wal_dir)
    assert any(r.get("compacted") and len(r.get("batch_ids", [])) > 1
               for _p, r in records)
    jg2, _s, jsink2 = jwc.build_graph(KEY_SPACE if keyed else 0)
    jfresh = JDirtyScheduler(jg2)
    jrecover(jfresh, wal_dir)
    g, src, sink = wc.build()
    fresh = wc.plain(g)
    recover(fresh, wal_dir)
    got = dict(fresh.view(sink.name))
    assert got == dict(jfresh.view(jsink2.name))
    assert {kv: w for kv, w in got.items() if w} \
        == {kv: w for kv, w in oracle.items() if w}
    assert fresh._tick == jfresh._tick
    # the folded ids are back in the dedup window: a re-send of the whole
    # feed folds nothing twice
    feed = [[(bid, _as_port(b)) for bid, b in t] for t in jfeed]
    resume_from_cursor(fresh, src, feed)
    assert dict(fresh.view(sink.name)) == clean_run(wc, feed)
