"""The port's epoch-fenced failover (``reflow_tpu_torch.serve.failover``,
``ReplicaScheduler.promote``/``reanchor``, the log's fence) against
``tests/test_failover.py``, on the CPU.

Every test of ``tests/test_failover.py`` has a counterpart here: a kill
mid-window (the partial window
truncated, then folded once), mid-shipment (the final drain), mid-
checkpoint (a torn ``meta.pkl.tmp``) and mid-promotion (a second
failover at epoch 2); the zombie writer whose every fenced byte is
rejected and never merged; the read tier through the promotion window;
the fake-clock detection (confirm intervals, flapping, heartbeat
timeout); the epoch adopted by recovery and the fence persisted on disk;
``tools/wal_inspect.py`` and ``tools/trace_inspect.py`` on the failover's
logs and spans; the gauges; the control plane stepping the coordinator;
and a tier-hosted leader killed mid-window, promoted and rebound in place,
its producers' resubmissions folded exactly once. The differential oracle is a fresh
scheduler folding the same windows: exactly-once survives a failover iff
the promoted leader's view equals it. The ones that drive a scheduler run
over the port's CPU oracle (string keys) and over its ``"cuda"`` executor
at ``device="cpu"`` (integer keys from one fixed vocabulary); every
promoted leader is checked to run on a fresh executor of the winner's own
kind. Views are held equal exactly (small integer counts).
"""

import glob
import json
import os

import numpy as np
import pytest

import reflow_tpu_torch as P
from reflow_tpu_torch import obs
from reflow_tpu_torch.obs import MetricsRegistry
from reflow_tpu_torch.obs import trace as trace_mod
from reflow_tpu_torch.serve import (FailoverCoordinator, LeaderReadAdapter,
                                    ReadTier, ReplicaScheduler, StaleRead)
from reflow_tpu_torch.wal import (DurableScheduler, FencedWrite,
                                  SegmentShipper, recover)
from reflow_tpu_torch.wal.log import FENCE_STATE_SCHEMA, _FENCE_STATE_FILE
from reflow_tpu_torch.workloads import wordcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORDS = [f"w{i}" for i in range(40)] + ["x", "z", "zombie", "a", "0"]
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


@pytest.fixture(params=["cpu", "cuda"])
def wc(request):
    return WC(request.param)


# -- helpers (test_replica.py idiom) ----------------------------------------

def make_leader(wc, tmp_path, **kw):
    g, src, sink = wc.build()
    kw.setdefault("fsync", "tick")
    sched = DurableScheduler(g, wc.executor(), wal_dir=str(tmp_path / "wal"),
                             **kw)
    return sched, src, sink


def make_replica(wc, tmp_path, name="r0"):
    g, _src, _sink = wc.build()
    return ReplicaScheduler(g, str(tmp_path / name), executor=wc.executor(),
                            name=name)


def gen_windows(n, start=0, tag=""):
    """Deterministic commit windows: 2 batches per tick, stable ids."""
    rng = np.random.default_rng(7 + start)
    out = []
    for t in range(start, start + n):
        out.append([(f"{tag}t{t}b{j}",
                     " ".join(f"w{int(x)}"
                              for x in rng.integers(0, 40, 8)))
                    for j in range(2)])
    return out


def apply_windows(wc, sched, src, windows):
    for win in windows:
        for bid, text in win:
            sched.push(src, wc.ingest([text]), batch_id=bid)
        sched.tick()


def oracle_view(wc, windows):
    g, src, sink = wc.build()
    ref = P.DirtyScheduler(g, wc.executor())
    apply_windows(wc, ref, src, windows)
    return {kv: w for kv, w in ref.view(sink.name).items() if w != 0}


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


def make_cluster(wc, tmp_path, n_replicas=2, **leader_kw):
    sched, src, sink = make_leader(wc, tmp_path, **leader_kw)
    ship = SegmentShipper(sched.wal, leader_tick=lambda: sched._tick)
    replicas = [make_replica(wc, tmp_path, f"r{i}")
                for i in range(n_replicas)]
    for r in replicas:
        ship.attach(r)
    return sched, src, sink, ship, replicas


def mirror_bytes(replica):
    return sum(os.path.getsize(p) for p in
               glob.glob(os.path.join(replica.mirror_dir, "wal-*.log")))


def same_kind(new, winner):
    """The promoted leader runs on a fresh executor of the winner's kind
    and device."""
    ex, old = new.executor, winner.sched.executor
    assert type(ex) is type(old) and ex is not old
    assert getattr(ex, "device", None) == getattr(old, "device", None)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


# -- kill seam 1: mid-window ------------------------------------------------

def test_kill_mid_window_partial_window_truncated_and_replayed_once(
        tmp_path, wc):
    sched, src, sink, ship, replicas = make_cluster(wc, tmp_path)
    done = gen_windows(4)
    apply_windows(wc, sched, src, done)
    pump_until_caught(ship, sched, replicas)
    orphan = gen_windows(1, start=4)[0]
    for bid, text in orphan:
        sched.push(src, wc.ingest([text]), batch_id=bid)
    sched.wal.sync()          # the partial window is even on disk
    ship.pump_once()          # ...and may be mirrored (staged, held back)

    coord = FailoverCoordinator(replicas, shipper=ship,
                                durable_kw={"committer": "inline"})
    acts = coord.promote_now(reason="test")
    assert acts and acts[0]["kind"] == "failover_promote"
    new = coord.leader_sched
    same_kind(new, coord.winner)
    assert new.wal.epoch == 1 and new._tick == 4
    assert live_view(new, sink) == oracle_view(wc, done)

    assert all(new.push(src, wc.ingest([text]), batch_id=bid)
               for bid, text in orphan)
    new.tick()
    assert live_view(new, sink) == oracle_view(wc, done + [orphan])
    bid, text = done[2][0]
    assert not new.push(src, wc.ingest([text]), batch_id=bid)
    coord.close()
    new.close()
    sched.close()


# -- kill seam 2: mid-shipment ----------------------------------------------

def test_kill_mid_shipment_final_drain_preserves_every_acked_window(
        tmp_path, wc):
    sched, src, sink, ship, replicas = make_cluster(wc, tmp_path)
    windows = gen_windows(6)
    apply_windows(wc, sched, src, windows[:3])
    pump_until_caught(ship, sched, replicas)
    apply_windows(wc, sched, src, windows[3:])
    sched.wal.sync()          # acked (durable) but never shipped
    assert max(r.published_horizon() for r in replicas) == 3

    coord = FailoverCoordinator(replicas, shipper=ship,
                                durable_kw={"committer": "inline"})
    acts = coord.promote_now(reason="test")
    assert coord.drained_bytes > 0 and acts[0]["drained_bytes"] > 0
    new = coord.leader_sched
    same_kind(new, coord.winner)
    assert new._tick == 6
    assert live_view(new, sink) == oracle_view(wc, windows)
    coord.close()
    new.close()
    sched.close()


# -- kill seam 3: mid-checkpoint --------------------------------------------

def test_kill_mid_checkpoint_promotes_from_checkpoint_plus_tail(tmp_path,
                                                                 wc):
    sched, src, sink, ship, replicas = make_cluster(wc, tmp_path)
    early = gen_windows(3)
    apply_windows(wc, sched, src, early)
    pump_until_caught(ship, sched, replicas)
    replicas[0].checkpoint()
    late = gen_windows(3, start=3)
    apply_windows(wc, sched, src, late)
    pump_until_caught(ship, sched, replicas)
    with open(os.path.join(replicas[0].ckpt_dir, "meta.pkl.tmp"),
              "wb") as f:
        f.write(b"\x00garbage torn mid-checkpoint")

    coord = FailoverCoordinator(replicas, shipper=ship,
                                durable_kw={"committer": "inline"})
    coord.promote_now(reason="test")
    assert coord.winner is replicas[0]  # tie on horizon: by name
    new = coord.leader_sched
    same_kind(new, coord.winner)
    assert new._tick == 6
    assert live_view(new, sink) == oracle_view(wc, early + late)
    coord.close()
    new.close()
    sched.close()


# -- kill seam 4: mid-promotion (double failure) ----------------------------

def test_kill_mid_promotion_second_failover_epoch_two(tmp_path, wc):
    sched, src, sink, ship, replicas = make_cluster(wc, tmp_path,
                                                    n_replicas=3)
    windows = gen_windows(4)
    apply_windows(wc, sched, src, windows)
    pump_until_caught(ship, sched, replicas)

    c1 = FailoverCoordinator(replicas, shipper=ship,
                             durable_kw={"committer": "inline"})
    c1.promote_now(reason="test")
    a, a_sched = c1.winner, c1.leader_sched
    assert a_sched.wal.epoch == 1
    a_win = gen_windows(1, start=4, tag="a")[0]
    apply_windows(wc, a_sched, src, [a_win])
    survivors = [r for r in replicas if r is not a]
    pump_until_caught(c1.new_shipper, a_sched, survivors)

    c2 = FailoverCoordinator(replicas, shipper=c1.new_shipper,
                             durable_kw={"committer": "inline"})
    c2.promote_now(reason="test")
    b, b_sched = c2.winner, c2.leader_sched
    assert b is not a and b_sched.wal.epoch == 2
    assert b._epoch == 2
    assert b_sched._tick == 5
    same_kind(b_sched, b)
    assert live_view(b_sched, sink) == oracle_view(wc, windows + [a_win])
    bid, text = a_win[0]
    assert not b_sched.push(src, wc.ingest([text]), batch_id=bid)
    with pytest.raises(FencedWrite):
        a_sched.push(src, wc.ingest(["zombie a"]), batch_id="za")
    with pytest.raises(FencedWrite):
        sched.push(src, wc.ingest(["zombie 0"]), batch_id="z0")
    c1.close()
    c2.close()
    b_sched.close()
    a_sched.close()
    sched.close()


# -- zombie writer: rejected, never merged ----------------------------------

def test_zombie_writer_every_fenced_byte_rejected_never_merged(tmp_path,
                                                               wc):
    sched, src, sink, ship, replicas = make_cluster(wc, tmp_path)
    windows = gen_windows(4)
    apply_windows(wc, sched, src, windows)
    pump_until_caught(ship, sched, replicas)

    winner, survivor = replicas
    new = winner.promote(epoch=1, committer="inline")
    same_kind(new, winner)
    survivor.reanchor(1)
    want = oracle_view(wc, windows)
    before_bytes = mirror_bytes(survivor)
    assert before_bytes > 0
    before_h = survivor.published_horizon()

    apply_windows(wc, sched, src, gen_windows(2, start=4, tag="zombie"))
    sched.wal.sync()
    ship.pump_once()
    assert ship.fence_nacks > 0
    assert survivor.fence_rejected_shipments > 0
    assert winner.fence_rejected_shipments > 0
    assert survivor.published_horizon() == before_h
    assert mirror_bytes(survivor) == before_bytes       # zero bytes merged
    _h, got = survivor.view_at(sink.name)
    assert got == want
    assert ship.pump_once() == 0
    new.close()
    sched.close()


# -- ReadTier through the promotion window ------------------------------------

def test_read_tier_stale_then_leader_fallback_through_promotion(tmp_path,
                                                                wc):
    sched, src, sink, ship, replicas = make_cluster(wc, tmp_path)
    windows = gen_windows(3)
    apply_windows(wc, sched, src, windows)
    pump_until_caught(ship, sched, replicas)
    tier = ReadTier(replicas, leader=LeaderReadAdapter(sched))

    tier.leader = None
    with pytest.raises(StaleRead):
        tier.view_at(sink.name, min_horizon=4)
    assert tier.stale_reads == 1
    res = tier.view_at(sink.name, min_horizon=3)
    assert res.source.startswith("r") and res.horizon == 3

    new = tier.promote(replicas[0], epoch=1, committer="inline")
    same_kind(new, replicas[0])
    assert all(x is not replicas[0] for x in tier.replicas)
    apply_windows(wc, new, src, gen_windows(1, start=3))
    res = tier.view_at(sink.name, min_horizon=4)
    assert res.source == "leader" and res.horizon == 4
    assert tier.leader_fallbacks == 1
    assert res.value == oracle_view(wc, windows + gen_windows(1, start=3))
    new.close()
    sched.close()


# -- fake-clock detection (no sleeps) ---------------------------------------

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


def test_coordinator_fires_after_confirm_intervals_single_shot():
    clk = FakeClock()
    dead = {"v": False}
    coord, calls = _stub_coord(
        lambda now: {"committer_dead": dead["v"], "pump_failed": False,
                     "beat": 1})
    assert coord.step(clk.advance(0.05)) == []
    dead["v"] = True
    assert coord.step(clk.advance(0.05)) == []        # streak 1 of 2
    acts = coord.step(clk.advance(0.05))              # streak 2: fire
    assert [a["kind"] for a in acts] == ["failover_promote"]
    assert acts[0]["winner"] == "b"                   # highest horizon
    assert acts[0]["reason"] == "committer_dead"
    assert calls == [("b", 1)] and coord.epoch == 1
    assert coord.step(clk.advance(0.05)) == []
    assert calls == [("b", 1)]


def test_coordinator_flapping_never_fires():
    clk = FakeClock()
    seq = iter([True, False] * 10)
    coord, calls = _stub_coord(
        lambda now: {"committer_dead": next(seq), "pump_failed": False,
                     "beat": 1})
    for _ in range(20):
        assert coord.step(clk.advance(0.05)) == []
    assert calls == [] and not coord.promoted


def test_coordinator_heartbeat_timeout_and_beat_reset():
    clk = FakeClock()
    beat = {"v": 1}
    coord, calls = _stub_coord(
        lambda now: {"committer_dead": False, "pump_failed": False,
                     "beat": beat["v"]},
        heartbeat_timeout_s=0.2, confirm_intervals=2)
    coord.step(clk.advance(0.05))
    beat["v"] = 2                                     # fresh beat: age 0
    coord.step(clk.advance(0.3))
    assert coord.heartbeat_age_s == 0.0
    coord.step(clk.advance(0.25))                     # stale: streak 1
    assert coord.heartbeat_age_s > 0.2 and not coord.promoted
    acts = coord.step(clk.advance(0.25))              # streak 2: fire
    assert acts[0]["reason"] == "heartbeat_timeout"
    assert calls == [("b", 1)]


# -- the control plane steps the coordinator ---------------------------------

def test_control_plane_steps_failover_coordinator(tmp_path):
    from reflow_tpu_torch.serve import ControlPlane, ServeTier

    clk = FakeClock()
    coord, calls = _stub_coord(
        lambda now: {"committer_dead": True, "pump_failed": False,
                     "beat": 1},
        confirm_intervals=1)
    tier = ServeTier()
    cp = ControlPlane(
        tier, specs={}, clock=clk, failover=coord,
        sampler=lambda now: {"graphs": {}, "ready_depth": 0,
                             "live_workers": 1, "target_workers": 1})
    acts = cp.step(clk.advance(0.05))
    assert any(a["kind"] == "failover_promote" for a in acts)
    assert calls == [("b", 1)]
    tier.close()


# -- end to end: tier-hosted leader killed mid-stream, rebound in place -----

def test_tier_hosted_failover_resubmit_exactly_once(tmp_path, wc):
    # the full serving path: a tier-hosted durable leader is killed
    # mid-window by a crash seam; the coordinator detects the failed
    # pump through its default sampler, promotes a replica, swings the
    # ReadTier fallback and revives the SAME handle over the new
    # leader. Producers resubmit every id: committed-and-shipped ids
    # dedup, the orphaned window folds exactly once — differential
    # equality against a bare fold of every batch
    import time as _time

    from reflow_tpu_torch.serve import (CoalesceWindow, FrontendClosed,
                                        GraphConfig, PumpCrashed,
                                        ServeTier)
    from reflow_tpu_torch.utils.faults import CrashInjector

    crash = CrashInjector(at=2, only="pump_before_tick@wal")
    tier = ServeTier(max_bytes=8 << 20, pump_threads=2, crash=crash)
    dsched, src, sink = make_leader(wc, tmp_path, fsync="record")
    ship = SegmentShipper(dsched.wal, leader_tick=lambda: dsched._tick)
    replicas = [make_replica(wc, tmp_path, f"r{i}") for i in range(2)]
    for r in replicas:
        ship.attach(r)
    cfg = GraphConfig(window=CoalesceWindow(max_rows=256, max_ticks=8,
                                            max_latency_s=0.002))
    h = tier.register("wal", dsched, cfg)
    read_tier = ReadTier(replicas, leader=LeaderReadAdapter(dsched))
    coord = FailoverCoordinator(
        replicas, shipper=ship, handle=h, read_tier=read_tier,
        confirm_intervals=1, durable_kw={"committer": "inline"})

    sent = [(f"m{j}", [f"w{j % 4} w{10 + j % 7}"]) for j in range(30)]
    tks = []
    for bid, lines in sent:
        try:
            tks.append(h.submit(src, wc.ingest(lines), batch_id=bid))
        except FrontendClosed:
            break
        ship.pump_once()
        _time.sleep(0.001)  # several windows
    crashed = 0
    for t in tks:
        try:
            t.result(timeout=10)
        except PumpCrashed:
            crashed += 1
    assert crash.fired and crashed > 0

    # detection through the *default* sampler: the pump is "failed"
    acts = coord.step()
    assert [a["kind"] for a in acts] == ["failover_promote"]
    assert acts[0]["reason"] == "pump_failed" and acts[0]["rebound"]
    new = coord.leader_sched
    assert new.wal.epoch == 1
    assert read_tier.leader.sched is new
    assert type(new.executor) is type(dsched.executor)

    # resubmit EVERY id through the same handle: exactly-once
    results = [h.submit(src, wc.ingest(lines), batch_id=bid).result(10)
               for bid, lines in sent]
    h.flush(timeout=10)
    assert any(r.status == "deduped" for r in results)
    assert any(r.applied for r in results)
    assert live_view(new, sink) == oracle_view(
        wc, [[(bid, lines[0])] for bid, lines in sent])
    # the old leader is fenced: a zombie append is rejected, counted
    with pytest.raises(FencedWrite):
        dsched.push(src, wc.ingest(["zombie"]), batch_id="z")
    assert dsched.wal.fence_rejected_appends == 1
    coord.close()
    tier.close()
    new.close()
    dsched.close()


# -- epoch persistence / recovery -------------------------------------------

def test_recovery_adopts_highest_record_epoch(tmp_path, wc):
    g, src, sink = wc.build()
    d = str(tmp_path / "wal")
    sched = DurableScheduler(g, wc.executor(), wal_dir=d, fsync="tick",
                             committer="inline", epoch=3)
    apply_windows(wc, sched, src, gen_windows(2))
    sched.close()

    g2, src2, sink2 = wc.build()
    fresh = DurableScheduler(g2, wc.executor(), wal_dir=d, fsync="tick",
                             committer="inline")
    report = recover(fresh, d)
    assert report.epoch == 3
    assert fresh.wal.epoch == 3
    assert live_view(fresh, sink2) == oracle_view(wc, gen_windows(2))
    fresh.close()


def test_restarted_zombie_stays_fenced(tmp_path, wc):
    g, src, sink = wc.build()
    d = str(tmp_path / "wal")
    sched = DurableScheduler(g, wc.executor(), wal_dir=d, fsync="tick",
                             committer="inline")
    apply_windows(wc, sched, src, gen_windows(1))
    assert sched.wal.fence(2)
    with pytest.raises(FencedWrite):
        sched.push(src, wc.ingest(["x"]), batch_id="zz")
    sched.close()
    with open(os.path.join(d, _FENCE_STATE_FILE)) as f:
        saved = json.load(f)
    assert saved["schema"] == FENCE_STATE_SCHEMA
    assert saved["fenced_by"] == 2
    g2, src2, _ = wc.build()
    again = DurableScheduler(g2, wc.executor(), wal_dir=d, fsync="tick",
                             committer="inline")
    assert again.wal.fenced
    with pytest.raises(FencedWrite):
        again.push(src2, wc.ingest(["x"]), batch_id="z2")
    again.close()


# -- inspection tools -------------------------------------------------------

def _load_tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inspect_tools_surface_failover(tmp_path, capsys, wc):
    trace_mod.reset()
    obs.enable()
    try:
        sched, src, sink, ship, replicas = make_cluster(wc, tmp_path)
        apply_windows(wc, sched, src, gen_windows(3))
        pump_until_caught(ship, sched, replicas)
        coord = FailoverCoordinator(replicas, shipper=ship,
                                    durable_kw={"committer": "inline"})
        coord.promote_now(reason="test")
        with pytest.raises(FencedWrite):
            sched.push(src, wc.ingest(["z"]), batch_id="z")
        apply_windows(wc, coord.leader_sched, src, gen_windows(1, start=3))
        coord.leader_sched.wal.sync()
        trace_path = str(tmp_path / "trace.json")
        obs.export_chrome_trace(trace_path)
    finally:
        obs.disable()
        trace_mod.reset()

    wi = _load_tool("wal_inspect")
    assert wi.main([str(tmp_path / "wal"), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    ep = out["epochs"]
    assert ep["record_max"] == 0 and ep["epoch"] == 0
    assert ep["fenced"] and ep["fenced_by"] == 1
    assert ep["rejected_appends"] == 1
    assert wi.main([str(tmp_path / "wal")]) == 0
    assert "FENCED by epoch 1" in capsys.readouterr().out
    assert wi.main([coord.leader_sched.wal.wal_dir, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["epochs"]["epoch"] == 1 and not out["epochs"]["fenced"]
    assert out["segments_detail"][-1]["epoch"] == 1

    ti = _load_tool("trace_inspect")
    assert ti.main([trace_path, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    fo = out["failover"]
    assert fo["promotions"] == 1
    assert fo["fence_rejects"]["append"] == 1
    kinds = {e["event"] for e in fo["events"]}
    assert kinds == {"elect", "replay"}
    assert ti.main([trace_path]) == 0
    human = capsys.readouterr().out
    assert "failover: 1 promotion(s)" in human
    coord.close()
    coord.leader_sched.close()
    sched.close()


# -- metrics ----------------------------------------------------------------

def test_failover_metrics_published(tmp_path, wc):
    sched, src, sink, ship, replicas = make_cluster(wc, tmp_path)
    apply_windows(wc, sched, src, gen_windows(2))
    pump_until_caught(ship, sched, replicas)
    coord = FailoverCoordinator(replicas, shipper=ship,
                                durable_kw={"committer": "inline"})
    reg = MetricsRegistry()
    coord.publish_metrics(reg)
    assert reg.value("failover.epoch") == 0
    assert reg.value("failover.promotions_total") == 0
    coord.promote_now(reason="test")
    with pytest.raises(FencedWrite):
        sched.push(src, wc.ingest(["z"]), batch_id="z")
    apply_windows(wc, coord.leader_sched, src, gen_windows(1, start=2))
    snap = reg.snapshot()
    assert snap["gauges"]["failover.epoch"] == 1
    assert snap["gauges"]["failover.promotions_total"] == 1
    assert snap["gauges"]["fence.rejected_appends"] == 1
    assert snap["gauges"]["leader.heartbeat_age_s"] >= 0.0
    coord.close()
    coord.leader_sched.close()
    sched.close()
