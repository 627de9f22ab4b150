"""The port's checkpoints (``reflow_tpu_torch.utils.checkpoint``) and key
tiles (``utils.tiles``) against ``tests/test_checkpoint.py``,
``tests/test_checkpoint_chain.py``, ``tests/test_tiles.py`` and the JAX
package, on the CPU.

Counterparts: the snapshot seam; every chain test that needs no replica,
shipper (full and delta restore parity, the replayed tail past the
chain head, the torn final delta falling back one element, the broken
mid-chain link failing loud, the crash at each manifest seam, the serving
tier's checkpoint barrier: one consistent cut across its graphs, and
every graph resumed after a saver's error); every tiles test that needs no compactor, replica or shipper (the
bucket and plan primitives, the torn final tiled delta, the crash
between tile appends, an untiled reader of a tiled chain). The ones that
drive a scheduler run over the port's CPU oracle and over its
``"cuda"`` executor at ``device="cpu"``; their views are held equal
exactly.

Device state, on the ``"cuda"`` executor at ``device="cpu"``: a 2k-node
PageRank on the fused loop survives a full checkpoint (restored bit-equal
to the state saved), a restore into a fresh executor, the WAL tail's
replay and a further churn tick bit-equal to the run never stopped once
that run rebuilds its CSR at the same tick — a restore drops the derived
CSR cache, and its rebuild in one piece adds the float sums in another
order than the live base and tail, so against the run as it was the
ranks are held to ``tests/test_csr_cache.py``'s bound; a chain with
deltas does the same (a torn final delta included); the same protocol through the JAX ``TpuExecutor`` (orbax)
gives ranks within 1e-3 of the port's (``max|Δ| / max(ref, 1)``, the
bound ``tests/test_torch_pagerank.py`` holds the port's fused loop to
against the JAX one); a ``VIT_TINY`` params tree with bfloat16 leaves
round-trips bit-exact; a checkpoint whose pending buffer held a
``DeviceDelta`` holds no tensor and loads in a scheduler at
``device="cpu"``.
"""

import glob
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.utils import tiles as jtiles
from reflow_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from reflow_tpu.wal import DurableScheduler as JDurableScheduler
from reflow_tpu.workloads import pagerank as jpr
from reflow_tpu_torch.executors.device_delta import (bucket_capacity,
                                                     to_device)
from reflow_tpu_torch.models import VIT_TINY, init_vit
from reflow_tpu_torch.utils import tiles
from reflow_tpu_torch.utils.checkpoint import (CheckpointChain,
                                               CheckpointError,
                                               chain_head_wal_pos,
                                               checkpoint_exists, load_chain,
                                               load_checkpoint,
                                               read_chain_manifest,
                                               save_checkpoint)
from reflow_tpu_torch.utils.faults import CrashInjector, CrashPoint
from reflow_tpu_torch.utils.tree import tree_leaves
from reflow_tpu_torch.wal import DurableScheduler, recover
from reflow_tpu_torch.wal.log import list_segments
from reflow_tpu_torch.workloads import image_embed as pie
from reflow_tpu_torch.workloads import pagerank as ppr
from reflow_tpu_torch.workloads import wordcount

WORDS = [f"w{i}" for i in range(40)] + list("abcxy") + [
    "g0", "g1", "g2", "after", "barrier", "d"]
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

    def plain(self, g):
        return P.DirtyScheduler(g, self.executor())

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


# -- the snapshot seam (tests/test_checkpoint.py) ----------------------------

def test_snapshot_is_isolated_from_live_state(wc):
    g, src, sink = wc.build()
    sched = wc.plain(g)
    sched.push(src, wc.ingest(["a b a"]))
    sched.tick()
    snap = sched.executor.state_snapshot()
    before = sched.view_dict(sink)
    sched.push(src, wc.ingest(["a c"]))
    sched.tick()
    assert sched.view_dict(sink) != before
    sched.executor.state_restore(snap)
    sched.push(src, wc.ingest(["a c"]))
    r = sched.tick()
    got = {k: w for (k, _v), w in r.sink_deltas["out"].to_counter().items()}
    assert wc.key("a") in got and wc.key("c") in got


def test_restore_then_diverge(wc):
    g, src, sink = wc.build()
    sched = wc.plain(g)
    sched.push(src, wc.ingest(["x y"]))
    sched.tick()
    snap = sched.executor.state_snapshot()
    sched.push(src, wc.ingest(["x"]))
    sched.tick()
    sched.executor.state_restore(snap)
    sched.push(src, wc.ingest(["x y"], weight=-1))
    sched.tick()
    # every group emptied exactly
    counts = g.nodes[sink.inputs[0].id]
    if wc.kind == "cuda":
        st = sched.executor.states[counts.id]
        assert not bool(st["emitted_has"].any())
        assert int(st["wcnt"].abs().sum()) == 0
    else:
        assert all(st == {} for st in sched.executor.states.values()
                   if isinstance(st, dict))


# -- chains (tests/test_checkpoint_chain.py) ---------------------------------

def make_leader(wc, tmp_path, **kw):
    g, src, sink = wc.build()
    kw.setdefault("segment_bytes", 1 << 12)
    return wc.durable(g, str(tmp_path / "wal"), fsync="tick", **kw), src, sink


def drive(wc, sched, src, n_ticks, seed=0, start=0):
    rng = np.random.default_rng(seed + start)
    for t in range(start, start + n_ticks):
        for j in range(2):
            words = " ".join(f"w{int(x)}" for x in rng.integers(0, 40, 8))
            sched.push(src, wc.ingest([words]), batch_id=f"t{t}b{j}")
        sched.tick()


def fresh_view(wc, tmp_path, ckpt_dir=None):
    g, _src, sink = wc.build()
    sched = wc.plain(g)
    rep = recover(sched, str(tmp_path / "wal"), ckpt_dir)
    return dict(sched.view(sink.name)), sched._tick, rep


def test_chain_full_delta_restore_parity(tmp_path, wc):
    sched, src, sink = make_leader(wc, tmp_path)
    root = str(tmp_path / "ckpt")
    chain = CheckpointChain(root, delta_every=4)
    infos = []
    for r in range(8):
        drive(wc, sched, src, 3, start=3 * r)
        infos.append(chain.save(sched))
    want = dict(sched.view(sink.name))
    tick = sched._tick
    ids = dict(sched._seen_batch_ids)
    sched.close()
    assert [i["kind"] for i in infos[:5]] \
        == ["full", "delta", "delta", "delta", "full"]
    assert chain.fulls == 2 and chain.deltas == 6
    m = read_chain_manifest(root)
    assert m["horizon"] == tick and len(m["deltas"]) == 3
    assert checkpoint_exists(root)
    g2, _s2, sink2 = wc.build()
    sched2 = wc.plain(g2)
    meta = load_chain(sched2, root)
    assert meta["chain"]["deltas_applied"] == 3
    assert meta["chain"]["fallback"] is None
    assert dict(sched2.view(sink2.name)) == want
    assert sched2._tick == tick
    assert dict(sched2._seen_batch_ids) == ids
    g3, _s3, sink3 = wc.build()
    sched3 = wc.plain(g3)
    assert load_checkpoint(sched3, root)["tick"] == tick
    assert dict(sched3.view(sink3.name)) == want


def test_chain_recover_replays_post_anchor_tail(tmp_path, wc):
    sched, src, sink = make_leader(wc, tmp_path)
    root = str(tmp_path / "ckpt")
    chain = CheckpointChain(root, delta_every=3)
    drive(wc, sched, src, 5)
    chain.save(sched)
    drive(wc, sched, src, 4, start=5)
    chain.save(sched)
    drive(wc, sched, src, 6, start=9)
    want = dict(sched.view(sink.name))
    tick = sched._tick
    sched.close()
    got, got_tick, rep = fresh_view(wc, tmp_path, root)
    assert got == want and got_tick == tick
    assert rep.checkpoint_loaded and rep.checkpoint_tick == 9
    assert rep.replayed_ticks == 6
    anchor = chain_head_wal_pos(root)
    segs = [s for s, _ in list_segments(str(tmp_path / "wal"))]
    assert segs and segs[-1] >= anchor[0]


def test_torn_final_delta_falls_back_one_element(tmp_path, wc):
    sched, src, sink = make_leader(wc, tmp_path)
    root = str(tmp_path / "ckpt")
    chain = CheckpointChain(root, delta_every=8)
    for r in range(3):
        drive(wc, sched, src, 4, start=4 * r)
        chain.save(sched)
    want = dict(sched.view(sink.name))
    tick = sched._tick
    sched.close()
    last = read_chain_manifest(root)["deltas"][-1]
    path = os.path.join(root, last)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 7)
    g2, _s2, _k2 = wc.build()
    meta = load_chain(wc.plain(g2), root)
    assert meta["chain"]["fallback"] is not None
    assert meta["chain"]["deltas_applied"] == 1
    got, got_tick, rep = fresh_view(wc, tmp_path, root)
    assert got == want and got_tick == tick
    assert rep.replayed_ticks == 4


def test_broken_mid_chain_link_fails_loud(tmp_path, wc):
    sched, src, _sink = make_leader(wc, tmp_path)
    root = str(tmp_path / "ckpt")
    chain = CheckpointChain(root, delta_every=8)
    for r in range(3):
        drive(wc, sched, src, 3, start=3 * r)
        chain.save(sched)
    sched.close()
    first_delta = read_chain_manifest(root)["deltas"][0]
    with open(os.path.join(root, first_delta), "r+b") as f:
        f.seek(12)
        f.write(b"\xff\xff\xff")
    g2, _s2, _k2 = wc.build()
    with pytest.raises(CheckpointError):
        load_chain(wc.plain(g2), root)
    os.remove(os.path.join(root, first_delta))
    g3, _s3, _k3 = wc.build()
    with pytest.raises(CheckpointError):
        load_chain(wc.plain(g3), root)


@pytest.mark.parametrize("seam,full_crash", [
    ("ckpt_before_meta", True),
    ("ckpt_full_before_flip", True),
    ("ckpt_delta_before_flip", False),
    ("ckpt_delta_after_flip", False),
])
def test_chain_crash_seam_differential(tmp_path, wc, seam, full_crash):
    crash = CrashInjector(2, only=seam)
    sched, src, sink = make_leader(wc, tmp_path)
    root = str(tmp_path / "ckpt")
    chain = CheckpointChain(root, delta_every=4, crash=crash)
    drive(wc, sched, src, 4)
    chain.save(sched)
    drive(wc, sched, src, 4, start=4)
    chain.save(sched)
    drive(wc, sched, src, 4, start=8)
    want = dict(sched.view(sink.name))
    tick = sched._tick
    with pytest.raises(CrashPoint):
        chain.save(sched, full=full_crash)
    sched.close()
    got, got_tick, rep = fresh_view(wc, tmp_path, root)
    assert got == want and got_tick == tick, f"{seam}: diverged"
    assert rep.checkpoint_loaded


def test_crash_before_meta_keeps_the_previous_checkpoint(tmp_path, wc):
    """A second save into the same directory dies after its state files
    and before its meta: recovery restores the first save whole (its
    states with its replay position) and replays the tail to the views
    of the run never stopped; the next save leaves one state directory,
    the one its meta names."""
    sched, src, sink = make_leader(wc, tmp_path)
    ckpt = str(tmp_path / "ckpt")
    drive(wc, sched, src, 4)
    first = save_checkpoint(sched, ckpt)
    drive(wc, sched, src, 4, start=4)
    want, tick = dict(sched.view(sink.name)), sched._tick
    crash = CrashInjector(1, only="ckpt_before_meta")
    with pytest.raises(CrashPoint):
        save_checkpoint(sched, ckpt, crash=crash)
    sched.close()
    got, got_tick, rep = fresh_view(wc, tmp_path, ckpt)
    assert got == want and got_tick == tick
    assert rep.checkpoint_tick == first["tick"] and rep.replayed_ticks == 4
    g, src2, _sink = wc.build()
    back = wc.durable(g, str(tmp_path / "wal"), fsync="tick")
    recover(back, str(tmp_path / "wal"), ckpt)
    meta = save_checkpoint(back, ckpt)
    back.close()
    dirs = sorted(f for f in os.listdir(ckpt) if f.startswith("states"))
    assert dirs == ([meta["states_dir"]] if wc.kind == "cuda" else [])


def test_chain_metrics_publish_and_close(tmp_path):
    from reflow_tpu_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    wc = WC("cpu")
    sched, src, _sink = make_leader(wc, tmp_path)
    chain = CheckpointChain(str(tmp_path / "ckpt"), delta_every=4)
    chain.publish_metrics(reg, name="ck")
    drive(wc, sched, src, 2)
    chain.save(sched)
    drive(wc, sched, src, 2, start=2)
    chain.save(sched)
    assert reg.value("ck.saves") == 2 and reg.value("ck.deltas") == 1
    assert reg.value("ck.delta_bytes") > 0
    chain.close()
    assert reg.value("ck.saves") is None
    sched.close()


def test_tier_checkpoint_barrier_consistent_cut(tmp_path, wc):
    from reflow_tpu_torch.serve import CoalesceWindow, GraphConfig, ServeTier

    window = CoalesceWindow(max_rows=256, max_ticks=8, max_latency_s=0.002)
    tier = ServeTier(max_bytes=1 << 20, pump_threads=2)
    handles = {}
    for i in range(3):
        g, src, sink = wc.build()
        sched = wc.plain(g)
        h = tier.register(f"g{i}", sched, GraphConfig(window=window))
        handles[f"g{i}"] = (h, src, sink, sched)
    for name, (h, src, _sink, _sched) in handles.items():
        for j in range(6):
            h.submit(src, wc.ingest([f"{name} w{j}"])).result(timeout=10)
        h.flush(timeout=10)
    chains = {n: CheckpointChain(str(tmp_path / n), delta_every=4)
              for n in handles}

    def saver(name, h):
        return chains[name].save(h.frontend.sched)

    out = tier.checkpoint_barrier(saver)
    assert out["barrier"] == 1 and tier.barriers == 1
    assert set(out["horizons"]) == set(handles)
    for name, (h, _src, sink, sched) in handles.items():
        # the recorded horizon is the quiesced window cut, and the chain
        # manifest agrees with it
        assert out["horizons"][name] == sched._tick
        assert read_chain_manifest(str(tmp_path / name))["horizon"] \
            == sched._tick
        assert out["results"][name]["kind"] == "full"
        g2, _s2, sink2 = wc.build()
        s2 = wc.plain(g2)
        load_chain(s2, str(tmp_path / name))
        assert dict(s2.view(sink2.name)) == dict(sched.view(sink.name))
    # the tier keeps serving after the barrier
    for name, (h, src, _sink, _sched) in handles.items():
        assert h.submit(src, wc.ingest(["after barrier"])) \
            .result(timeout=10).applied
    tier.close()


def test_tier_checkpoint_barrier_resumes_after_saver_error(tmp_path, wc):
    from reflow_tpu_torch.graph import GraphError
    from reflow_tpu_torch.serve import CoalesceWindow, GraphConfig, ServeTier

    window = CoalesceWindow(max_rows=256, max_ticks=8, max_latency_s=0.002)
    tier = ServeTier(max_bytes=1 << 20, pump_threads=1)
    g, src, _sink = wc.build()
    h = tier.register("g", wc.plain(g), GraphConfig(window=window))
    h.submit(src, wc.ingest(["a b"])).result(timeout=10)

    def bad_saver(name, handle):
        raise RuntimeError("disk full")

    with pytest.raises(RuntimeError, match="disk full"):
        tier.checkpoint_barrier(bad_saver)
    # every frontend was resumed on the way out
    assert h.submit(src, wc.ingest(["c d"])).result(timeout=10).applied
    tier.close()
    with pytest.raises(GraphError):
        tier.checkpoint_barrier(lambda n, hh: None)


# -- tiles (tests/test_tiles.py) ---------------------------------------------

def test_bucket_of_stable_across_processes():
    assert tiles.bucket_of("alpha") == 22
    assert tiles.bucket_of(("w1", "w1")) == 3
    assert tiles.bucket_of(7) == 2
    assert tiles.bucket_of((b"x", 3.5)) == 24
    # the JAX package buckets every key the same way
    for k in ("alpha", ("w1", "w1"), 7, (b"x", 3.5), np.int64(9), "w33"):
        assert tiles.bucket_of(k) == jtiles.bucket_of(k)


def test_bucket_of_numpy_scalar_matches_python():
    assert tiles.bucket_of(np.int64(7)) == tiles.bucket_of(7)
    arr = np.arange(3, dtype=np.float32)
    assert tiles.bucket_of(arr) == tiles.bucket_of(arr.copy())


def test_approx_row_bytes_estimates():
    assert tiles.approx_row_bytes("abc", None) == 3 + 16
    arr = np.arange(3, dtype=np.float32)
    assert tiles.approx_row_bytes(arr, None) == arr.nbytes + 16
    assert tiles.approx_row_bytes("ab", "cd") == 2 + 2 + 16


def test_plan_tiles_contiguous_cover_never_splits_bucket():
    rng = np.random.default_rng(0)
    hist = [float(x) for x in rng.integers(1, 200, tiles.N_BUCKETS)]
    plan = tiles.plan_tiles(hist, 400)
    assert plan == jtiles.plan_tiles(hist, 400)
    assert len(plan) > 1
    assert plan[0][0] == 0 and plan[-1][1] == tiles.N_BUCKETS
    for (_, a_hi), (b_lo, _) in zip(plan, plan[1:]):
        assert a_hi == b_lo
    assert all(hi > lo for lo, hi in plan)
    hot = [1.0] * tiles.N_BUCKETS
    hot[10] = 10_000.0
    plan = tiles.plan_tiles(hot, 100)
    i = tiles.owning_tile(plan, 10)
    assert plan[i] == (10, 11)


def test_plan_budget_zero_is_monolithic_and_owning_tile_raises():
    assert tiles.plan_tiles([1.0] * tiles.N_BUCKETS, 0) \
        == [(0, tiles.N_BUCKETS)]
    with pytest.raises(KeyError):
        tiles.owning_tile([(0, 32)], 40)


def tiles_feed(wc, seed, n_ticks, tag=""):
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


def push_feed(sched, src, feed):
    for batches in feed:
        for bid, b in batches:
            sched.push(src, b, batch_id=bid)
        sched.tick()


def live_view(sched, sink):
    return {kv: w for kv, w in sched.view(sink.name).items() if w != 0}


def recovered_view(wc, wal_dir, ckpt_dir=None):
    g, _src, sink = wc.build()
    sched = wc.plain(g)
    recover(sched, wal_dir, ckpt_dir)
    return ({kv: w for kv, w in sched.view(sink.name).items() if w != 0},
            sched._tick)


def drive_chain(wc, tmp_path, saves=3, per_save=5):
    wal_dir = str(tmp_path / "wal")
    root = str(tmp_path / "ckpt")
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=1 << 12)
    chain = CheckpointChain(root, delta_every=4)
    t = 0
    for _ in range(saves):
        push_feed(sched, src, tiles_feed(wc, t, per_save, tag=f"s{t}"))
        t += per_save
        chain.save(sched)
    push_feed(sched, src, tiles_feed(wc, 99, 2, tag="tail"))
    view = live_view(sched, sink)
    tick = sched._tick
    sched.close()
    return wal_dir, root, view, tick, chain


def test_torn_final_tiled_delta_falls_back_one_element(tmp_path, wc,
                                                       monkeypatch):
    monkeypatch.setenv("REFLOW_TILE_BYTES", "512")
    wal_dir, root, view, tick, chain = drive_chain(wc, tmp_path)
    assert chain.tile_count >= 2
    deltas = sorted(glob.glob(os.path.join(root, "delta-*.ckd")))
    assert deltas
    with open(deltas[-1], "rb+") as f:
        f.truncate(os.path.getsize(deltas[-1]) - 4)
    got, got_tick = recovered_view(wc, wal_dir, root)
    assert got == view and got_tick == tick


@pytest.mark.parametrize("seam", ["ckpt_tile_full_append",
                                  "ckpt_tile_append"])
def test_tiled_chain_crash_seam_recovers(tmp_path, wc, monkeypatch, seam):
    monkeypatch.setenv("REFLOW_TILE_BYTES", "512")
    wal_dir = str(tmp_path / "wal")
    root = str(tmp_path / "ckpt")
    g, src, sink = wc.build()
    sched = wc.durable(g, wal_dir, fsync="tick", segment_bytes=1 << 12)
    inj = CrashInjector(2, only=seam)
    chain = CheckpointChain(root, delta_every=4, crash=inj)
    fired = False
    for i in range(4):
        push_feed(sched, src, tiles_feed(wc, 20 + i, 5, tag=f"c{i}"))
        if not fired:
            try:
                chain.save(sched)
            except CrashPoint:
                fired = True
    assert fired and inj.fired_seam == seam
    view = live_view(sched, sink)
    tick = sched._tick
    sched.close()
    got, got_tick = recovered_view(wc, wal_dir, root)
    assert got == view and got_tick == tick


def test_untiled_reader_restores_tiled_chain(tmp_path, wc, monkeypatch):
    monkeypatch.setenv("REFLOW_TILE_BYTES", "512")
    wal_dir, root, view, tick, chain = drive_chain(wc, tmp_path)
    assert chain.tile_count >= 2
    assert glob.glob(os.path.join(root, "*", "tiles", "*.ckt"))
    monkeypatch.delenv("REFLOW_TILE_BYTES")
    got, got_tick = recovered_view(wc, wal_dir, root)
    assert got == view and got_tick == tick


# -- device state: PageRank on the fused loop ---------------------------------

N, E, CHURN, TOL = 2000, 20000, 0.01, 1e-4


def _arena(n_edges):
    return (bucket_capacity(n_edges)
            + 8 * bucket_capacity(2 * int(CHURN * n_edges) + 2))


def pr_sched(wal_dir=None, mod=ppr, **graph_kw):
    """A PageRank scheduler over the port's cuda executor on the CPU (or,
    with ``mod=jpr``, the JAX default ``TpuExecutor``); durable when
    ``wal_dir`` is given."""
    pg = mod.build_graph(N, tol=TOL, arena_capacity=_arena(E), **graph_kw)
    if mod is jpr:
        ex = jget_executor("tpu")
        cls = JDurableScheduler if wal_dir else JDirtyScheduler
    else:
        ex = P.get_executor("cuda", device="cpu")
        cls = DurableScheduler if wal_dir else P.DirtyScheduler
    kw = {"wal_dir": wal_dir} if wal_dir else {}
    return pg, cls(pg.graph, ex, **kw)


def pr_feed(mod, n_churn):
    web = mod.WebGraph.random(N, E, seed=7)
    first = [(None, mod.teleport_batch(N)), (None, web.initial_batch())]
    return first, [web.churn(CHURN) for _ in range(n_churn)]


def pr_push(sched, pg, batches, tag):
    for i, (_, b) in enumerate(batches):
        src = pg.teleport if i == 0 and tag == "init" else pg.edges
        sched.push(src, b, batch_id=f"{tag}{i}")


def pr_tick(sched, pg, churn, t):
    sched.push(pg.edges, churn, batch_id=f"c{t}")
    assert sched.tick().quiesced


def states_equal(a, b):
    assert set(a) == set(b)
    for nid in a:
        la, lb = tree_leaves(a[nid]), tree_leaves(b[nid])
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y), nid


#: ranks of a restored run against the run never stopped, as
#: ``max|Δ|``: the restored executor rebuilds its sorted-arena CSR in one
#: piece where the live one kept a base and a tail, so its float sums add
#: in another order; the bound is ``tests/test_csr_cache.py``'s for the
#: same lineage swap (a tol-gated emission can flip at the edge)
RESTORED_BOUND = TOL / (1.0 - ppr.DAMPING) + 1e-4


def pr_reference(first, churns, drop_at):
    """The run never stopped, fed ``first`` and ``churns``, its CSR cache
    dropped after tick ``drop_at`` as a restore at that tick drops it."""
    pg, ref = pr_sched()
    pr_push(ref, pg, first, "init")
    ref.tick()
    if ref._tick == drop_at:
        ref.executor.on_states_replaced()
    for t, churn in enumerate(churns):
        pr_tick(ref, pg, churn, t)
        if ref._tick == drop_at:
            ref.executor.on_states_replaced()
    return pg, ref


def pr_ranks(sched, pg):
    return ppr.ranks_to_array(sched.read_table(pg.new_rank), N)


def test_pagerank_checkpoint_restore_bit_equal(tmp_path):
    """Save after the initial tick and 2 churn ticks, run 2 more, stop. A
    fresh executor restores the checkpoint (bit-equal to the live state
    at the save), replays the WAL tail and takes a further churn tick:
    every state tensor is bit-equal to the run never stopped once that
    run rebuilds its CSR at the same tick (the one thing a restore
    changes), and its ranks are within ``RESTORED_BOUND`` of the run as
    it was."""
    first, churns = pr_feed(ppr, 5)
    wal_dir, ckpt = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    pg, live = pr_sched(wal_dir)
    pr_push(live, pg, first, "init")
    live.tick()
    for t in range(2):
        pr_tick(live, pg, churns[t], t)
    saved = live.executor.state_snapshot()
    meta = save_checkpoint(live, ckpt)
    assert meta["states_bytes"] > 0 and meta["has_array_states"]
    for t in range(2, 4):
        pr_tick(live, pg, churns[t], t)
    live.close()
    _pg, loaded = pr_sched()
    load_checkpoint(loaded, ckpt)
    states_equal(loaded.executor.states, saved)
    pg2, back = pr_sched(wal_dir)
    rep = recover(back, wal_dir, ckpt)
    assert rep.checkpoint_tick == 3 and rep.replayed_ticks == 2
    assert back.executor.csr_rebuilds["initial"] == 1
    pr_tick(back, pg2, churns[4], 4)
    pg3, ref = pr_reference(first, churns, drop_at=3)
    states_equal(back.executor.states, ref.executor.states)
    pg4, never = pr_reference(first, churns, drop_at=None)
    err = np.max(np.abs(pr_ranks(back, pg2) - pr_ranks(never, pg4)))
    assert err < RESTORED_BOUND, err
    back.close()


@pytest.mark.parametrize("torn", [False, True])
def test_pagerank_chain_restore_bit_equal(tmp_path, torn):
    """A chain (a full element, then a delta after each churn tick;
    ``torn``: the final delta cut short, so the restore falls back one
    element) and the WAL tail past it: the recovered executor and a
    further churn tick are bit-equal to the run never stopped with its
    CSR rebuilt at the restored element's tick."""
    first, churns = pr_feed(ppr, 5)
    wal_dir, root = str(tmp_path / "wal"), str(tmp_path / "ck")
    pg, live = pr_sched(wal_dir)
    chain = CheckpointChain(root, delta_every=8)
    pr_push(live, pg, first, "init")
    live.tick()
    assert chain.save(live)["kind"] == "full"
    for t in range(3):
        pr_tick(live, pg, churns[t], t)
        info = chain.save(live)
        assert info["kind"] == "delta" and info["changed_sources"]
    assert chain.readback_bytes > 0
    pr_tick(live, pg, churns[3], 3)
    live.close()
    if torn:
        last = os.path.join(root, read_chain_manifest(root)["deltas"][-1])
        with open(last, "r+b") as f:
            f.truncate(os.path.getsize(last) - 9)
    pg2, back = pr_sched(wal_dir)
    rep = recover(back, wal_dir, root)
    assert rep.checkpoint_tick == (3 if torn else 4)
    assert rep.replayed_ticks == (2 if torn else 1)
    pr_tick(back, pg2, churns[4], 4)
    pg3, ref = pr_reference(first, churns, drop_at=rep.checkpoint_tick)
    states_equal(back.executor.states, ref.executor.states)
    back.close()


def test_pagerank_checkpoint_protocol_matches_jax(tmp_path):
    """The same protocol (initial tick, 2 churn ticks, checkpoint, 2
    more, recover into a fresh executor, one more churn tick) through
    the JAX ``TpuExecutor`` (orbax array states) and through the port:
    ranks within 1e-3, the bound the port's fused loop keeps to the JAX
    one (``tests/test_torch_pagerank.py``)."""
    ranks = {}
    for name, mod, save in (("jax", jpr, jsave_checkpoint),
                            ("port", ppr, save_checkpoint)):
        first, churns = pr_feed(mod, 5)
        wal_dir = str(tmp_path / name / "wal")
        ckpt = str(tmp_path / name / "ckpt")
        pg, live = pr_sched(wal_dir, mod)
        pr_push(live, pg, first, "init")
        live.tick()
        for t in range(2):
            pr_tick(live, pg, churns[t], t)
        save(live, ckpt)
        for t in range(2, 4):
            pr_tick(live, pg, churns[t], t)
        live.close()
        pg2, back = pr_sched(wal_dir, mod)
        if mod is jpr:
            from reflow_tpu.wal import recover as jrecover
            rep = jrecover(back, wal_dir, ckpt)
        else:
            rep = recover(back, wal_dir, ckpt)
        assert rep.replayed_ticks == 2
        pr_tick(back, pg2, churns[4], 4)
        ranks[name] = mod.ranks_to_array(back.read_table(pg2.new_rank), N)
        back.close()
    err = np.max(np.abs(ranks["port"] - ranks["jax"])
                 / np.maximum(ranks["jax"], 1.0))
    assert err < 1e-3, err


def test_checkpoint_resume_replays_identically(tmp_path, wc):
    """``tests/test_aux.py``'s resume: save after the initial tick, churn;
    a fresh scheduler restores and takes the same churn to the same
    ranks (the port's cuda executor on the CPU is bit-reproducible)."""
    n, e = 48, 200
    web = ppr.WebGraph.random(n, e, seed=2)
    pg = ppr.build_graph(n, tol=1e-5)
    sched = P.DirtyScheduler(pg.graph, wc.executor(), max_loop_iters=500)
    sched.push(pg.teleport, ppr.teleport_batch(n))
    sched.push(pg.edges, web.initial_batch())
    sched.tick()
    save_checkpoint(sched, str(tmp_path / "ckpt"))
    churn = web.churn(0.05)
    sched.push(pg.edges, churn)
    sched.tick()
    after = sched.read_table(pg.new_rank)
    sched2 = P.DirtyScheduler(pg.graph, wc.executor(), max_loop_iters=500)
    load_checkpoint(sched2, str(tmp_path / "ckpt"))
    sched2.push(pg.edges, churn)
    sched2.tick()
    replay = sched2.read_table(pg.new_rank)
    assert set(after) == set(replay)
    for k in after:
        assert float(after[k]) == float(replay[k])


def test_checkpoint_restore_invalidates_csr_cache(tmp_path):
    """``tests/test_csr_cache.py``'s lineage swap: diverge after a save,
    restore into the same warm executor, replay the original churn; the
    ranks match a from-scratch run (the restore dropped the CSR cache;
    the JAX test's bound)."""
    tol = 1e-4
    web = ppr.WebGraph.random(64, 512, seed=37)
    pg = ppr.build_graph(64, tol=tol, arena_capacity=1 << 15)
    sched = P.DirtyScheduler(pg.graph, P.get_executor("cuda", device="cpu"),
                             max_loop_iters=500)
    sched.push(pg.teleport, ppr.teleport_batch(64))
    sched.push(pg.edges, web.initial_batch())
    sched.tick()
    sched.push(pg.edges, web.churn(1.0))
    sched.tick()
    ckpt = str(tmp_path / "ck")
    save_checkpoint(sched, ckpt)
    dst_at_save = web.dst.copy()
    for _ in range(3):
        sched.push(pg.edges, web.churn(1.0))
        sched.tick()
    rebuilds = sum(sched.executor.csr_rebuilds.values())
    load_checkpoint(sched, ckpt)
    web.dst = dst_at_save
    replay = web.churn(1.0)
    sched.push(pg.edges, replay)
    assert sched.tick().quiesced
    assert sum(sched.executor.csr_rebuilds.values()) > rebuilds
    restored = ppr.ranks_to_array(sched.read_table(pg.new_rank), 64)
    web2 = ppr.WebGraph.random(64, 512, seed=37)
    pg2 = ppr.build_graph(64, tol=tol, arena_capacity=1 << 15)
    s2 = P.DirtyScheduler(pg2.graph, P.get_executor("cuda", device="cpu"),
                          max_loop_iters=500)
    s2.push(pg2.teleport, ppr.teleport_batch(64))
    s2.push(pg2.edges, web2.initial_batch())
    s2.tick()
    s2.push(pg2.edges, web2.churn(1.0))
    s2.tick()
    s2.push(pg2.edges, replay)
    assert s2.tick().quiesced
    fresh = ppr.ranks_to_array(s2.read_table(pg2.new_rank), 64)
    bound = tol / (1.0 - ppr.DAMPING) + 1e-4
    assert np.max(np.abs(restored - fresh)) < bound


def test_deferred_checkpoint_roundtrip_with_live_residue(tmp_path):
    """``tests/test_pagerank.py``'s deferred round trip: a checkpoint
    taken mid-stream restores the carried residue, and both runs drain
    to the same ranks."""
    n, e = 200, 1200
    web = ppr.WebGraph.random(n, e, seed=23)

    def build():
        pg = ppr.build_graph(n, tol=1e-4, arena_capacity=4096,
                             defer_passes=2)
        return pg, P.DirtyScheduler(
            pg.graph, P.get_executor("cuda", device="cpu"),
            max_loop_iters=500)

    pg, sched = build()
    sched.push(pg.teleport, ppr.teleport_batch(n))
    sched.push(pg.edges, web.initial_batch())
    sched.tick(sync=False)
    churns = [web.churn(0.05) for _ in range(6)]
    for b in churns[:3]:
        sched.push(pg.edges, b)
        sched.tick(sync=False)
    save_checkpoint(sched, str(tmp_path / "ck"))
    pg2, sched2 = build()
    load_checkpoint(sched2, str(tmp_path / "ck"))
    assert bool(sched2.executor.states[pg2.ranks.id]["resid"].any())
    out = []
    for sch, pgx in ((sched, pg), (sched2, pg2)):
        for b in churns[3:]:
            sch.push(pgx.edges, b)
            sch.tick(sync=False)
        sch.drain(pgx.edges)
        out.append(ppr.ranks_to_array(sch.read_table(pgx.new_rank), n))
    # the JAX test's bound: the restore drops the CSR cache, so the sums
    # agree to float reordering, not bit for bit
    np.testing.assert_allclose(out[0], out[1], atol=1e-5)


# -- device state: bf16 params, pending device batches -----------------------

def test_vit_bf16_params_roundtrip_bit_exact(tmp_path):
    """A ``VIT_TINY`` image-embed graph with bfloat16 weights: the params
    tree and the centroid tables come back bit-exact (dtypes kept), and
    the next tick gives the same centroids as the run never stopped."""
    params = init_vit(0, **VIT_TINY, dtype=torch.bfloat16, device="cpu")

    def build():
        ig = pie.build_graph(64, 8, params)
        return ig, P.DirtyScheduler(ig.graph,
                                    P.get_executor("cuda", device="cpu"))

    rng = np.random.default_rng(9)
    stream = pie.ImageStream(params, seed=4)
    ig, sched = build()
    sched.push(ig.images, stream.insert(np.arange(24),
                                        rng.integers(0, 8, 24)))
    sched.tick()
    save_checkpoint(sched, str(tmp_path / "ck"))
    leaves = tree_leaves(sched.executor.states[ig.embed.id])
    assert leaves and all(x.dtype == torch.bfloat16 for x in leaves)
    ig2, back = build()
    load_checkpoint(back, str(tmp_path / "ck"))
    states_equal(back.executor.states, sched.executor.states)
    nxt = stream.insert(np.arange(24, 40), rng.integers(0, 8, 16))
    for s, g in ((sched, ig), (back, ig2)):
        s.push(g.images, nxt)
        s.tick()
    a, b = sched.read_table(ig.centroids), back.read_table(ig2.centroids)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _walk_tensors(obj, seen=None):
    """Whether ``obj`` (a meta dict's contents) holds a tensor."""
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, dict):
        return any(_walk_tensors(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_walk_tensors(v) for v in obj)
    if hasattr(obj, "__slots__"):
        return any(_walk_tensors(getattr(obj, s, None))
                   for s in obj.__slots__)
    return False


@pytest.mark.parametrize("how", ["preimage", "logged_readback", "plain"])
def test_pending_device_batch_checkpoint_loads_without_a_card(tmp_path,
                                                              how):
    """A ``DeviceDelta`` pushed but not ticked. ``preimage``: the durable
    scheduler keeps it pending and the checkpoint writes its logged
    pre-image (no readback). ``logged_readback``: with no pre-image the
    durable scheduler reads it back once to log it (``log_readbacks``)
    and keeps the host copy pending. ``plain``: a plain scheduler keeps
    it pending and the checkpoint reads it back (``pending_readbacks``,
    a forced sync). Either way ``meta.pkl`` holds no tensor; it loads in
    a separate process where no card is visible, into a scheduler at
    ``device="cpu"``, and the restored tick equals the live one."""
    import json

    wc = WC("cuda")
    g, src, sink = wc.build()
    sched = (wc.plain(g) if how == "plain"
             else wc.durable(g, str(tmp_path / "wal"), fsync="tick"))
    sched.push(src, wc.ingest(["a b a"]), batch_id="h0")
    sched.tick()
    host = wc.ingest(["b c c"])
    dev = to_device(host, src.spec, device="cpu")
    if how == "preimage":
        sched.push_preimage("d0", host)
    syncs0 = sched.forced_syncs
    sched.push(src, dev, batch_id="d0")
    pending = [b for bs in sched._pending.values() for b in bs]
    assert len(pending) == 1
    assert hasattr(pending[0], "nonzero") == (how != "logged_readback")
    meta = save_checkpoint(sched, str(tmp_path / "ck"))
    assert meta["pending_readbacks"] == (1 if how == "plain" else 0)
    assert sched.forced_syncs - syncs0 == (1 if how == "plain" else 0)
    if how != "plain":
        assert sched.log_readbacks == (1 if how == "logged_readback" else 0)
    with open(tmp_path / "ck" / "meta.pkl", "rb") as f:
        assert not _walk_tensors(pickle.load(f))
    sched.tick()
    want = dict(sched.view(sink.name))
    sched.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import reflow_tpu_torch as P\n"
        "from reflow_tpu_torch.utils.checkpoint import load_checkpoint\n"
        "from reflow_tpu_torch.workloads import wordcount\n"
        f"g, src, sink = wordcount.build_graph({KEY_SPACE})\n"
        "s = P.DirtyScheduler(g, P.get_executor('cuda', device='cpu'))\n"
        f"load_checkpoint(s, {str(tmp_path / 'ck')!r})\n"
        "assert sum(len(v) for v in s._pending.values()) == 1\n"
        "s.tick()\n"
        "print(json.dumps(sorted([k, v, w] for (k, v), w in "
        "s.view('out').items())))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
    got = {(k, v): w for k, v, w in json.loads(out.stdout.splitlines()[-1])}
    assert got == want


def test_array_state_restore_refuses_another_executor_kind(tmp_path):
    """A checkpoint of device states does not load into the CPU oracle,
    whose states are host objects."""
    wc = WC("cuda")
    g, src, _sink = wc.build()
    sched = wc.plain(g)
    sched.push(src, wc.ingest(["a b"]))
    sched.tick()
    save_checkpoint(sched, str(tmp_path / "ck"))
    g2, _s, _k = wc.build()
    with pytest.raises(ValueError):
        load_checkpoint(P.DirtyScheduler(g2, P.CpuExecutor()),
                        str(tmp_path / "ck"))
    # a tree of another shape is refused too (a wider key space)
    g3, _s3, _k3 = wordcount.build_graph(2 * KEY_SPACE)
    with pytest.raises(ValueError, match="restore onto the same"):
        load_checkpoint(P.DirtyScheduler(
            g3, P.get_executor("cuda", device="cpu")), str(tmp_path / "ck"))
