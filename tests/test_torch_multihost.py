"""A mesh across processes: the port's counterpart of
``tests/test_multihost.py``, run for real on the CPU.

Two ``python -m reflow_tpu_torch.parallel.multihost_worker`` children
join a ``gloo`` group on 127.0.0.1 and each steps its half of a (dcn 2,
delta 4) mesh. Their owned tables are held bit for bit against the
port's single-controller mesh of the same shape (``make_mesh(8, dcn=2,
device="cpu")`` in this process, fed the same global layout) and the
final ranks within 5e-4 of the JAX package's single-controller
``ShardedTpuExecutor(make_mesh(8, dcn=2))`` on the 8 forced CPU devices
(float sums in another order). Every child has a time limit and is
killed in a ``finally``.
"""

import socket

import numpy as np
import pytest
import torch

from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.executors import CpuExecutor
from reflow_tpu_torch.parallel import dist, make_mesh, spmd
from reflow_tpu_torch.parallel import multihost_worker as mw
from reflow_tpu_torch.parallel.mesh import Mesh, shard_batch_process_local
from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor
from reflow_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from reflow_tpu_torch.workloads import pagerank as ppr

#: seconds the two children of one test may take in all
LIMIT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, *extra):
    """Two workers on one gloo group; their JSON summaries and tables."""
    return mw.WorkerGroup(2, "gloo", list(extra), out_dir=str(tmp_path),
                          tag="tables", device="cpu", limit_s=LIMIT_S,
                          timeout_s=60).wait()


def _twin_ingest(device="cpu"):
    def ingest(sched, node, batch, capacity, batch_id=None):
        return sched.push(node, mw.twin_batch(batch, node.spec, 2, capacity,
                                              device), batch_id=batch_id)
    return ingest


def _assert_bit_equal(child: dict, twin: dict) -> int:
    assert child, "the worker recorded no table"
    for key, arr in child.items():
        assert key in twin, key
        np.testing.assert_array_equal(arr, twin[key], err_msg=key)
    return len(child)


def _jax_ranks(cfg):
    """The JAX package's single-controller (dcn, delta) mesh on the same
    stream (host batches), its ranks after every churn."""
    import reflow_tpu as J
    from reflow_tpu.parallel import make_mesh as jmake_mesh
    from reflow_tpu.parallel.shard import ShardedTpuExecutor
    from reflow_tpu.workloads import pagerank as jpr

    n, e, churn = cfg["n_nodes"], cfg["n_edges"], cfg["churn"]
    g = jpr.build_graph(n, tol=cfg["tol"],
                        arena_capacity=mw.pagerank_arena(8, e, churn))
    sched = J.DirtyScheduler(g.graph, ShardedTpuExecutor(
        jmake_mesh(8, dcn=2)), max_loop_iters=500)
    web = jpr.WebGraph.random(n, e, seed=cfg["seed"])
    sched.push(g.teleport, jpr.teleport_batch(n))
    sched.push(g.edges, web.initial_batch())
    sched.tick()
    for _ in range(cfg["churn_ticks"] + 2):
        sched.push(g.edges, web.churn(churn))
        sched.tick()
    return jpr.ranks_to_array(sched.read_table(g.new_rank), n)


def test_two_process_pagerank_equals_single_controller(tmp_path):
    """Build, churn, the exactly-once round and the collective checkpoint
    on (dcn 2, delta 4) over two processes; every tick's owned tables
    equal the single-controller mesh's bit for bit, and the final ranks
    match JAX's single-controller mesh within 5e-4."""
    ckpt = tmp_path / "ckpt"
    sums, tables = _spawn(tmp_path, "--ckpt", str(ckpt))
    cfg = mw.PAGERANK
    for p, s in enumerate(sums):
        assert s["owned"] == 128 and s["owned_lo"] == 128 * p
        assert s["vs_reference"] < 5e-4
        assert s["restored_vs_live"] == 0.0     # bit for bit on the CPU
        # the boundary traffic: host branches, the fused loop's
        # psum_scatter, the router's dcn leg
        assert {"host_gather", "psum_scatter"} <= set(s["boundary"])
        assert s["staged_bytes"] > 0
    assert sums[0]["digest"] == sums[1]["digest"]
    assert [t["passes"] for t in sums[0]["ticks"]] == \
        [t["passes"] for t in sums[1]["ticks"]]

    twin: dict = {}
    tck = tmp_path / "twin_ckpt"
    summary = mw.drive_pagerank(
        cfg, lambda: ShardedCudaExecutor(make_mesh(8, dcn=2, device="cpu")),
        _twin_ingest(), nproc=2, out=twin,
        save=lambda s: save_checkpoint(s, str(tck)),
        load=lambda s: load_checkpoint(s, str(tck)))
    n = sum(_assert_bit_equal(t, twin) for t in tables)
    assert n > 100
    assert [t["passes"] for t in summary["ticks"]] == \
        [t["passes"] for t in sums[0]["ticks"]]
    assert summary["digest"] == sums[0]["digest"]

    # the owned halves joined: the live run's ranks after its last tick
    nid = [k for k in tables[0] if k.startswith("cont/r0/")
           and k.endswith("/emitted")][0].split("/")[2]
    ranks = np.concatenate([tables[r // 4][f"cont/r{r}/{nid}/emitted"]
                            for r in range(8)])
    want = _jax_ranks(cfg)
    np.testing.assert_allclose(ranks, want, rtol=0, atol=5e-4)

    # a collective checkpoint restores only with its process count
    pr = ppr.build_graph(cfg["n_nodes"], tol=cfg["tol"],
                         arena_capacity=mw.pagerank_arena(
                             8, cfg["n_edges"], cfg["churn"]))
    sched = P_sched(pr, make_mesh(8, dcn=2, device="cpu"))
    with pytest.raises(ValueError, match="written by 2 process"):
        load_checkpoint(sched, str(ckpt))


def P_sched(pr, mesh):
    from reflow_tpu_torch.scheduler import DirtyScheduler

    return DirtyScheduler(pr.graph, ShardedCudaExecutor(mesh))


def test_two_process_knn_ring_merge_crosses_the_boundary(tmp_path):
    """The sharded k-NN on (dcn 2, delta 4) over two processes: the scan,
    the ring merge (ppermute) and the incremental top-k cross the process
    boundary, and every tick's index table equals the single-controller
    mesh's bit for bit."""
    sums, tables = _spawn(tmp_path, "--case", "knn")
    for s in sums:
        assert "ppermute" in s["boundary"] and "all_gather" in s["boundary"]
        assert [t["kind"] for t in s["ticks"]][-2:] == ["retract",
                                                        "query update"]
    # the table is replicated: both processes hold all of it
    np.testing.assert_equal(tables[0], tables[1])
    twin: dict = {}
    mw.drive_knn(mw.KNN, ShardedCudaExecutor(make_mesh(8, dcn=2,
                                                       device="cpu")), twin)
    assert _assert_bit_equal(tables[0], twin) == 2 * len(mw.knn_feed(mw.KNN))
    assert sums[0]["queries"] == mw.KNN["Q"]


def test_two_process_streaming_sink_ticks_stay_in_step(tmp_path):
    """A keyed min Reduce into a sink on (dcn 2, delta 4) over two
    processes, streaming ticks (``tick(sync=False)``), three of them with
    sink rows on one process only. Both processes still materialize the
    sink and run the error check (its allgather), since the scheduler's
    branch reads every process's egress counts; otherwise the lone check
    would pair with the other process's next exchange. The two views
    joined equal the single-controller mesh's and the CPU oracle's at
    every tick."""
    sums, tables = _spawn(tmp_path, "--case", "stream")
    live = [[bool(t["sink_rows"]) for t in s["ticks"]] for s in sums]
    assert live == [[True, True, False, True], [True, False, True, False]]
    twin: dict = {}
    mw.drive_stream(mw.STREAM, ShardedCudaExecutor(
        make_mesh(8, dcn=2, device="cpu")), twin)
    oracle: dict = {}
    mw.drive_stream(mw.STREAM, CpuExecutor(), oracle)
    for i in range(len(mw.stream_feed(mw.STREAM))):
        for col in ("keys", "vals"):
            joined = np.concatenate([t[f"s{i}/{col}"] for t in tables])
            np.testing.assert_array_equal(joined, twin[f"s{i}/{col}"])
            np.testing.assert_array_equal(joined, oracle[f"s{i}/{col}"])
        # each process shows its own key range
        assert (tables[0][f"s{i}/keys"] < 32).all()
        assert (tables[1][f"s{i}/keys"] >= 32).all()


def test_two_process_scheduler_driven_loop_stays_in_step(tmp_path):
    """PageRank with ``fixpoint=False`` on (dcn 2, delta 4) over two
    processes: the scheduler drives every loop pass, and its next-pass
    branch reads every process's egress counts, so both run the same
    passes (a process whose own back-edge rows run out keeps stepping
    with the other). Every tick's owned tables equal the
    single-controller mesh's bit for bit."""
    sums, tables = _spawn(tmp_path, "--no-fixpoint", "--ckpt",
                          str(tmp_path / "ckpt"))
    cfg = mw.PAGERANK
    for s in sums:
        assert s["vs_reference"] < 5e-4
        assert s["restored_vs_live"] == 0.0
    passes = [[t["passes"] for t in s["ticks"]] for s in sums]
    assert passes[0] == passes[1] and min(passes[0]) > 1
    twin: dict = {}
    tck = tmp_path / "twin_ckpt"
    summary = mw.drive_pagerank(
        cfg, lambda: ShardedCudaExecutor(make_mesh(8, dcn=2, device="cpu"),
                                         fixpoint=False),
        _twin_ingest(), nproc=2, out=twin,
        save=lambda s: save_checkpoint(s, str(tck)),
        load=lambda s: load_checkpoint(s, str(tck)))
    assert sum(_assert_bit_equal(t, twin) for t in tables) > 100
    assert [t["passes"] for t in summary["ticks"]] == passes[0]


def test_drifted_dedup_window_fails_the_collective_save(tmp_path):
    """Process 1 registers one batch id process 0 never saw: the save's
    digest allgather catches it, and BOTH processes raise JAX's
    RuntimeError instead of saving a wrong exactly-once horizon."""
    sums, _ = _spawn(tmp_path, "--ckpt", str(tmp_path / "ckpt"), "--drift")
    for s in sums:
        assert "diverged across controllers" in s["drift_raised"]
    assert not (tmp_path / "ckpt" / "meta.pkl").exists()


# -- the window path across the processes ------------------------------------

@pytest.fixture(scope="module")
def window_pair(tmp_path_factory):
    """One pair of ``--case window`` children for the window tests: the
    PageRank windows around a collective checkpoint, then the k-NN
    through a depth-2 frontend."""
    tmp = tmp_path_factory.mktemp("window")
    sums, tables = _spawn(tmp, "--case", "window", "--ckpt",
                          str(tmp / "ckpt"))
    return sums, tables


def _twin_windows(tmp_path):
    twin: dict = {}
    tck = tmp_path / "twin_ckpt"
    summary = mw.drive_pagerank_windows(
        mw.PAGERANK,
        lambda: ShardedCudaExecutor(make_mesh(8, dcn=2, device="cpu")),
        save=lambda s: save_checkpoint(s, str(tck)),
        load=lambda s: load_checkpoint(s, str(tck)), out=twin)
    return summary, twin


def test_two_process_pagerank_window_equals_single_controller(
        window_pair, tmp_path):
    """Config 3's churn as one window of 4 ticks through ``tick_many`` on
    (dcn 2, delta 4) over two processes: each process's queue holds its
    own shards' slots of the global batches, the window engaged on both
    (no per-tick fallback), and the owned tables after the build and the
    window equal the single-controller mesh's window bit for bit."""
    from reflow_tpu_torch.executors.ingress_queue import slot_nbytes

    sums, tables = window_pair
    cfg = mw.PAGERANK
    spec = ppr.build_graph(cfg["n_nodes"]).edges.spec
    rows = len(ppr.WebGraph.random(cfg["n_nodes"], cfg["n_edges"],
                                   seed=cfg["seed"]).churn(cfg["churn"]))
    for s in sums:
        pr = s["pagerank"]
        assert pr["windows"] == pr["window_dispatches"] == 2
        assert pr["fallbacks"] == 0
        # K slots of a churn batch's bucket, half of it on each process
        assert pr["queue_bytes"] == \
            mw.WINDOW_K * slot_nbytes(spec, rows) // 2
        assert pr["vs_reference"] < 5e-4
    assert sums[0]["pagerank"]["digest"] == sums[1]["pagerank"]["digest"]
    summary, twin = _twin_windows(tmp_path)
    assert summary["windows"] == 2 and summary["fallbacks"] == 0
    n = 0
    for t in tables:
        got = {key: a for key, a in t.items()
               if key.split("/")[0] in ("b0", "w1", "cont")}
        n += _assert_bit_equal(got, twin)
    assert n > 50
    assert [r["passes"] for r in summary["ticks"]] == \
        [r["passes"] for r in sums[0]["pagerank"]["ticks"]]


def test_two_process_window_checkpoint_restores(window_pair, tmp_path):
    """A collective checkpoint taken between two windows (every queue
    generation retired) and restored into fresh schedulers: the next
    window on the restored run equals the live run's bit for bit, on
    each process and against the single-controller twin's."""
    sums, tables = window_pair
    for s in sums:
        assert s["pagerank"]["restored_vs_live"] == 0.0
    for t in tables:
        cont = {key[len("cont/"):]: a for key, a in t.items()
                if key.startswith("cont/")}
        rest = {key[len("restored/"):]: a for key, a in t.items()
                if key.startswith("restored/")}
        assert cont and set(cont) == set(rest)
        for key in cont:
            np.testing.assert_array_equal(rest[key], cont[key], err_msg=key)
    _, twin = _twin_windows(tmp_path)
    for t in tables:
        _assert_bit_equal({key: a for key, a in t.items()
                           if key.startswith("restored/")}, twin)


def test_two_process_knn_frontend_windows_equal_single_device(window_pair):
    """Config 4's k-NN through an ``IngestFrontend`` at depth 2 on (dcn
    2, delta 4) over two processes: three windows (the second staged
    while the first was in flight), no fallback, and the index table at
    every round's end equal to a single-device executor's through the
    same frontend, bit for bit."""
    from reflow_tpu_torch.executors import get_executor

    sums, tables = window_pair
    for s in sums:
        kn = s["knn"]
        assert kn["windows"] == kn["window_dispatches"] == 3
        assert kn["fallbacks"] == 0 and kn["windows_pipelined"] == 1
        assert [r["ticks"] for r in kn["rounds"]] == [4, 1]
    twin: dict = {}
    tsum = mw.drive_knn_frontend(mw.KNN, get_executor("cuda", device="cpu"),
                                 twin)
    assert tsum["windows"] == 3 and tsum["windows_pipelined"] == 1
    for t in tables:
        got = {key: a for key, a in t.items() if key.startswith("f")}
        assert _assert_bit_equal(got, twin) == 4


def test_a_window_fault_in_one_process_fails_both(tmp_path):
    """The last process raises inside the first churn window: its peer,
    waiting in the window's next exchange, fails too, within the group
    timeout, instead of hanging."""
    sums, _ = mw.WorkerGroup(
        2, "gloo", ["--case", "window", "--window-fault", "--ckpt",
                    str(tmp_path / "ckpt")],
        out_dir=str(tmp_path), tag="fault", device="cpu", limit_s=LIMIT_S,
        timeout_s=30).wait()
    assert "fault injected" in sums[1]["window_failed"]
    assert sums[0]["window_failed"]
    for s in sums:
        assert s["failed_after_s"] < 30
        assert "pagerank" not in s and "knn" not in s


def test_a_bad_key_in_one_process_chunk_fails_every_process(tmp_path):
    """Only the last process's chunk holds a key at its Spec's
    ``key_space``: ``shard_batch_process_local`` raises DeliveryError in
    both processes, at once rather than after the group timeout, and
    the next clean call still meets in the gather."""
    sums, _ = mw.WorkerGroup(
        2, "gloo", ["--case", "badkey"], out_dir=str(tmp_path),
        tag="badkey", device="cpu", limit_s=LIMIT_S, timeout_s=30).wait()
    assert "process 1's chunk: key 8 is at or past the Spec's " \
        "key_space 8" in sums[1]["refused"]
    assert "process 1's chunk holds a key" in sums[0]["refused"]
    for s in sums:
        assert s["refused_after_s"] < 30
        assert s["after"] == 2


def test_nccl_refuses_two_ranks_on_one_card():
    """nccl needs a card per process; two processes on fewer cards raise
    before any rendezvous, and nothing falls back to gloo."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="one card per process"):
        dist.initialize(f"127.0.0.1:{_free_port()}", cards + 1, 0,
                        backend="nccl", timeout_s=5)
    assert not dist.is_initialized() and dist.backend() is None
    with pytest.raises(ValueError, match="backend"):
        dist.initialize("127.0.0.1:1", 2, 0, backend="mpi")


# -- shard_batch_process_local in one process --------------------------------

def _chunk(n, w=1):
    return DeltaBatch(np.arange(n, dtype=np.int64),
                      np.ones(n, np.float32), np.full(n, w, np.int64))


def test_process_local_capacity_must_divide_the_mesh():
    spec = ppr.build_graph(16).teleport.spec
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="multiple of the mesh size 8"):
        shard_batch_process_local(_chunk(4), spec, mesh, capacity=100)
    with pytest.raises(ValueError, match="positive"):
        shard_batch_process_local(_chunk(4), spec, mesh, capacity=0)


def test_process_local_chunk_over_its_share_raises():
    spec = ppr.build_graph(16).teleport.spec
    devs = np.array(["cpu"] * 8, dtype=object).reshape(2, 4)
    mesh = Mesh(devs, ("dcn", "delta"), process_count=2, process_index=1)
    assert mesh.local_ranks == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="share 64 of capacity 128"):
        shard_batch_process_local(_chunk(65), spec, mesh, capacity=128)


def test_process_local_batch_is_this_process_rows(monkeypatch):
    """On one process the result is the whole batch; on process 1 of two
    it is its padded share, and the mass guard sums every process's
    mass through one allgather."""
    spec = ppr.build_graph(16).teleport.spec
    whole = shard_batch_process_local(_chunk(10), spec,
                                      make_mesh(8, device="cpu"),
                                      capacity=128)
    assert whole.capacity == 128 and int(whole.nonzero()) == 10
    devs = np.array(["cpu"] * 8, dtype=object).reshape(2, 4)
    mesh = Mesh(devs, ("dcn", "delta"), process_count=2, process_index=1)
    seen = []

    def allgather(x):
        seen.append(int(x))
        return np.array([1 << 23, int(x)])

    monkeypatch.setattr(dist, "process_allgather", allgather)
    part = shard_batch_process_local(_chunk(10), spec, mesh, capacity=128)
    assert part.capacity == 64 and int(part.nonzero()) == 10
    assert seen == [10]
    # each process is under the bound, the global mass is not
    with pytest.raises(ValueError, match="weight mass"):
        shard_batch_process_local(_chunk(10, w=1 << 20), spec, mesh,
                                  capacity=128)


def test_a_divergence_across_processes_names_the_process(monkeypatch):
    """An exchange whose headers differ raises SpmdMismatch on every
    process, naming the other process, its first shard and the step."""
    devs = np.array(["cpu"] * 4, dtype=object).reshape(2, 2)
    mesh = Mesh(devs, ("dcn", "delta"), process_count=2, process_index=0)

    def exchange(header, tensors):
        return [(header, []), (("done", header[1]), [])], 0, 0

    monkeypatch.setattr(dist, "exchange", exchange)

    def body(ctx):
        yield ctx.psum(torch.ones(2))

    with pytest.raises(spmd.SpmdMismatch,
                       match=r"process 1 \(shard 2\) its shards returned "
                             r"where process 0 \(shard 0\) asked for \('psum'"):
        spmd.run(mesh, body, [(), ()], ("dcn", "delta"))
