"""``ReflowConfig`` in the port against the JAX package's, on the CPU.

The port's counterpart of ``tests/test_aux.py``'s
``test_config_from_env_and_scheduler``, with the port's executor names
(``cpu``, ``cuda``, ``sharded``, ``staged``): the same environment builds
the same scheduler in both packages, and the same sum graph and the same
sharded PageRank give the same tables. Beside it, the port's other names
the JAX package exports and no other port test holds: the WAL time
accumulator of ``obs.trace`` and ``lowerings.DEVICE_REDUCERS``.

Device executors run at ``device="cpu"`` (their plain PyTorch path);
with no card and no ``device`` they raise.
"""

import threading

import numpy as np
import pytest
import torch

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.executors import lowerings as jlow
from reflow_tpu.graph import GraphError as JGraphError
from reflow_tpu.obs import trace as jtrace
from reflow_tpu.ops import core as jcore
from reflow_tpu.utils import config as jconfig
from reflow_tpu.workloads import pagerank as jpr
from reflow_tpu_torch.executors import lowerings as plow
from reflow_tpu_torch.executors.cpu import CpuExecutor
from reflow_tpu_torch.executors.cuda import CudaExecutor
from reflow_tpu_torch.graph import GraphError as PGraphError
from reflow_tpu_torch.obs import trace as ptrace
from reflow_tpu_torch.ops import core as pcore
from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor
from reflow_tpu_torch.parallel.topo import StagedCudaExecutor
from reflow_tpu_torch.utils import config as pconfig
from reflow_tpu_torch.workloads import pagerank as ppr

#: the five knobs ``ReflowConfig.from_env`` reads
CORE_KNOBS = ("REFLOW_EXECUTOR", "REFLOW_MAX_LOOP_ITERS",
              "REFLOW_DEDUP_WINDOW", "REFLOW_MESH_DEVICES",
              "REFLOW_LINEAR_FIXPOINT")


@pytest.fixture
def one_thread():
    # eight shards of small ops: torch's intra-op pool only adds
    # contention at these sizes (as in tests/test_torch_sharded.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sum_graph(pkg):
    g = pkg.FlowGraph()
    src = g.source("s", pkg.Spec((), np.float32, key_space=8))
    g.sink(g.reduce(src, "sum"), "out")
    return g, src


def test_config_from_env_and_scheduler():
    """The load-bearing flag: the same environment, with each package's
    device executor named, builds a scheduler with the loop bound and the
    fused-loop switch set, and the sum graph's view is the same in both."""
    env = {"REFLOW_MAX_LOOP_ITERS": "77", "REFLOW_LINEAR_FIXPOINT": "0"}
    jcfg = jconfig.ReflowConfig.from_env(dict(env, REFLOW_EXECUTOR="tpu"))
    pcfg = P.ReflowConfig.from_env(dict(env, REFLOW_EXECUTOR="cuda"))
    assert pcfg.executor == "cuda" and pcfg.max_loop_iters == 77
    assert not pcfg.linear_fixpoint
    views = {}
    for name, pkg, make in (("jax", J, jcfg.scheduler),
                            ("port", P, lambda g: pcfg.scheduler(
                                g, device="cpu"))):
        g, src = _sum_graph(pkg)
        sched = make(g)
        assert sched.max_loop_iters == 77
        sched.push(src, pkg.DeltaBatch(np.array([2, 5, 2]),
                                       np.array([5.0, 1.5, -2.0],
                                                np.float32)))
        sched.tick()
        views[name] = sched.view_dict("out")
        if pkg is P:
            ex = sched.executor
            assert isinstance(ex, CudaExecutor) and ex.name == "cuda"
            assert ex.device == torch.device("cpu")
            assert ex.linear_fixpoint is False
    assert views["port"] == views["jax"] == {2: 3.0, 5: 1.5}


def test_linear_fixpoint_reaches_the_constructor():
    """``REFLOW_LINEAR_FIXPOINT=0`` is the executor's constructor flag,
    so a fresh executor keeps it; a config PageRank then runs the row
    program, and with the flag on the fused loop, as JAX's does."""
    for flag, prog in (("0", "FixpointProgram"),
                       ("1", "LinearFixpointProgram")):
        cfg = P.ReflowConfig.from_env({"REFLOW_LINEAR_FIXPOINT": flag})
        ex = cfg.make_executor(device="cpu")
        assert ex.linear_fixpoint is (flag == "1")
        assert ex.fresh().linear_fixpoint is (flag == "1")
        pg = ppr.build_graph(32, tol=1e-5, arena_capacity=1 << 10)
        web = ppr.WebGraph.random(32, 128, seed=3)
        sched = cfg.scheduler(pg.graph, device="cpu")
        sched.push(pg.teleport, ppr.teleport_batch(32))
        sched.push(pg.edges, web.initial_batch())
        assert sched.tick().quiesced
        assert type(sched.executor._fx_program).__name__ == prog
        got = ppr.ranks_to_array(sched.read_table(pg.new_rank), 32)
        np.testing.assert_allclose(got, ppr.reference_ranks(web),
                                   atol=5e-4)


def _pagerank(pkg, sched_of, seed=11, tol=1e-5, N=64, E=512, churns=2):
    pr = ppr if pkg is P else jpr
    web = pr.WebGraph.random(N, E, seed=seed)
    pg = pr.build_graph(N, tol=tol, arena_capacity=1 << 13)
    sched = sched_of(pg.graph)
    sched.push(pg.teleport, pr.teleport_batch(N))
    sched.push(pg.edges, web.initial_batch())
    assert sched.tick().quiesced
    for _ in range(churns):
        sched.push(pg.edges, web.churn(0.05))
        assert sched.tick().quiesced
    return (sched, pr.ranks_to_array(sched.read_table(pg.new_rank), N),
            pr.reference_ranks(web))


def test_sharded_config_on_an_8_shard_cpu_mesh(one_thread):
    """``REFLOW_EXECUTOR=sharded`` with ``REFLOW_MESH_DEVICES=8`` builds
    an 8-shard mesh in both packages (the port's on the CPU), and a
    PageRank through each config's scheduler agrees within
    ``tests/test_torch_sharded.py``'s bound for two tol-converged runs
    summed in different orders."""
    env = {"REFLOW_EXECUTOR": "sharded", "REFLOW_MESH_DEVICES": "8",
           "REFLOW_MAX_LOOP_ITERS": "500"}
    jcfg = jconfig.ReflowConfig.from_env(env)
    pcfg = P.ReflowConfig.from_env(env)
    ex = pcfg.make_executor(device="cpu")
    assert isinstance(ex, ShardedCudaExecutor) and ex.n == 8
    assert {str(d) for d in ex.mesh.device_list} == {"cpu"}
    assert jcfg.make_executor().n == 8
    psched, got, ref = _pagerank(
        P, lambda g: pcfg.scheduler(g, device="cpu"))
    jsched, jgot, _ = _pagerank(J, jcfg.scheduler)
    assert psched.max_loop_iters == jsched.max_loop_iters == 500
    assert psched.executor.n == 8 and psched.executor.linear_fixpoint
    bound = 1e-5 / (1.0 - ppr.DAMPING) + 1e-4
    np.testing.assert_allclose(got, jgot, rtol=0, atol=bound)
    np.testing.assert_allclose(got, ref, atol=5e-4)


@pytest.mark.parametrize("name,cls", [("cpu", CpuExecutor),
                                      ("cuda", CudaExecutor),
                                      ("sharded", ShardedCudaExecutor),
                                      ("staged", StagedCudaExecutor)])
def test_make_executor_builds_each_port_executor(name, cls, one_thread):
    """Each of the port's four names builds its executor; ``device``
    reaches the ones that take it."""
    cfg = P.ReflowConfig(executor=name, mesh_devices=2)
    ex = cfg.make_executor(device="cpu")
    assert type(ex) is cls and ex.name == name
    if name != "cpu":
        assert ex.device == torch.device("cpu")
    g, src = _sum_graph(P)
    sched = cfg.scheduler(g, device="cpu")
    sched.push(src, P.DeltaBatch(np.array([1, 1]),
                                 np.array([2.0, 3.0], np.float32)))
    sched.tick()
    assert sched.view_dict("out") == {1: 5.0}


def test_jax_executor_name_is_refused_by_name():
    """``"tpu"`` is the JAX package's executor: the port refuses it with
    a message that names the port's four and the H100's, and never takes
    it as ``"cuda"``; the registry refuses an unknown name, as JAX's
    does."""
    cfg = P.ReflowConfig.from_env({"REFLOW_EXECUTOR": "tpu"})
    assert cfg.executor == "tpu"
    with pytest.raises(ValueError) as e:
        cfg.make_executor(device="cpu")
    msg = str(e.value)
    assert "'tpu'" in msg and "'cuda' is the H100's" in msg
    for name in ("cpu", "cuda", "sharded", "staged"):
        assert name in msg
    with pytest.raises(KeyError, match="no executor 'gpu'"):
        P.ReflowConfig(executor="gpu").make_executor(device="cpu")
    with pytest.raises(KeyError, match="no executor 'gpu'"):
        jconfig.ReflowConfig(executor="gpu").make_executor()
    with pytest.raises(ValueError, match="'tpu'"):
        cfg.scheduler(_sum_graph(P)[0], device="cpu")


def test_defaults_beside_the_jax_package():
    """The port's one default that differs from JAX's: the executor is
    ``"cuda"`` (JAX's ``"cpu"``); the other four fields, and the five
    knobs' names and types, are JAX's."""
    p, j = P.ReflowConfig(), jconfig.ReflowConfig()
    assert p.executor == "cuda" and j.executor == "cpu"
    assert P.ReflowConfig.from_env({}) == p
    assert jconfig.ReflowConfig.from_env({}) == j
    for field in ("max_loop_iters", "dedup_window", "mesh_devices",
                  "linear_fixpoint"):
        assert getattr(p, field) == getattr(j, field), field
    for name in CORE_KNOBS:
        pk, jk = pconfig.KNOBS[name], jconfig.KNOBS[name]
        assert pk.kind == jk.kind, name
        if name != "REFLOW_EXECUTOR":
            assert pk.default == jk.default, name
    assert pconfig.KNOBS["REFLOW_EXECUTOR"].default == "cuda"
    assert jconfig.KNOBS["REFLOW_EXECUTOR"].default == "cpu"
    assert P.ReflowConfig.from_env({"REFLOW_EXECUTOR": "cpu"}).executor == \
        "cpu"


@pytest.mark.parametrize("name", ["cuda", "sharded", "staged"])
def test_make_executor_never_falls_back_to_the_cpu(name, monkeypatch):
    """With no card and no ``device``, a device executor raises (through
    ``resolve_device`` or the mesh's device list) instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ReflowConfig(executor=name).make_executor()
    assert isinstance(P.ReflowConfig(executor="cpu").make_executor(),
                      CpuExecutor)


def test_package_exports_match_the_jax_package():
    """``from reflow_tpu_torch import ReflowConfig, Executor`` works, and
    the port's ``__all__`` holds every name of JAX's."""
    from reflow_tpu_torch import Executor, ReflowConfig

    assert ReflowConfig is pconfig.ReflowConfig
    assert issubclass(CudaExecutor, Executor)
    assert set(J.__all__) <= set(P.__all__)
    assert set(jtrace.__all__) <= set(ptrace.__all__)


def test_wal_accum_matches_jax_across_two_threads():
    """The WAL time accumulator is thread-local in both packages: two
    threads add their own seconds, take them, and find nothing after a
    take or a reset."""
    steps = [("reset",), ("add", 0.25), ("add", 0.5), ("take",),
             ("take",), ("add", 1.5), ("reset",), ("take",),
             ("add", 0.125), ("take",)]

    def drive(mod, scale, out, barrier):
        got = []
        for step in steps:
            barrier.wait()
            if step[0] == "reset":
                mod.wal_accum_reset()
            elif step[0] == "add":
                mod.wal_accum_add(step[1] * scale)
            else:
                got.append(mod.wal_accum_take())
        out.append(got)

    res = {}
    for name, mod in (("jax", jtrace), ("port", ptrace)):
        outs = {s: [] for s in (1, 3)}
        barrier = threading.Barrier(2)
        threads = [threading.Thread(target=drive,
                                    args=(mod, s, outs[s], barrier))
                   for s in outs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        res[name] = {s: o[0] for s, o in outs.items()}
    assert res["port"] == res["jax"]
    assert res["port"][1] == [0.75, 0.0, 0.0, 0.125]
    assert res["port"][3] == [2.25, 0.0, 0.0, 0.375]
    assert ptrace.wal_accum_take() == 0.0      # this thread added nothing


def test_device_reducers_equal_jax():
    assert plow.DEVICE_REDUCERS == jlow.DEVICE_REDUCERS
    assert "DEVICE_REDUCERS" in plow.__all__
    assert set(plow.LINEAR_DEVICE_REDUCERS) < set(plow.DEVICE_REDUCERS)


def test_unknown_reducer_refused_by_bind_in_both_packages(monkeypatch):
    """A reducer registered beside the five runs on the CPU oracle, and
    each package's device executor refuses it at ``bind`` with a
    ``GraphError`` naming it and the reducers it has."""
    def agg_median(ms):
        vals = sorted(v for v, w in ms.items() for _ in range(max(w, 0)))
        return vals[len(vals) // 2] if vals else None

    monkeypatch.setitem(jcore.REDUCERS, "median", (agg_median, False))
    monkeypatch.setitem(pcore.REDUCERS, "median", (agg_median, False))
    for pkg, ex, err in ((J, lambda: J.get_executor("tpu"), JGraphError),
                         (P, lambda: P.get_executor("cuda", device="cpu"),
                          PGraphError)):
        g = pkg.FlowGraph()
        src = g.source("s", pkg.Spec((), np.float32, key_space=8))
        g.sink(g.reduce(src, "median"), "out")
        with pytest.raises(err) as e:
            pkg.DirtyScheduler(g, ex())
        msg = str(e.value)
        assert "'median' has no device lowering" in msg
        assert "('sum', 'count', 'mean', 'min', 'max')" in msg
        oracle = pkg.DirtyScheduler(g, pkg.CpuExecutor())
        oracle.push(src, pkg.DeltaBatch(np.array([1, 1, 1]),
                                        np.array([3.0, 1.0, 2.0],
                                                 np.float32)))
        oracle.tick()
        assert oracle.view_dict("out") == {1: 2.0}


def test_chip_smoke_phase_20_on_the_cpu(monkeypatch, one_thread):
    """``chip_smoke.py``'s phase 20 at small widths on CPU tensors: every
    leg's scheduler comes from ``ReflowConfig.from_env`` of an explicit
    environment; leg a's and leg c's k-NN tables equal a hand-built
    twin's bit for bit, leg b runs the row program within the phase's
    rank bound, and leg d is refused."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    knn = dict(Q=16, D=2048, dim=32, k=4, scan_chunk=512, per_tick=128,
               preload_chunk=256, preload_chunks=2, insert_ticks=1,
               retract=64, query_update=4)
    pr = dict(n_nodes=2000, n_edges=20_000, churn=0.01, tol=1e-4, seed=7,
              churn_ticks=2)
    out = cs.phase_config("cpu (no card)", knn, pr)
    assert out["launches"] == (0, 0)        # the plain versions off the card
    assert len(out["a"]["ms"]) == 3 and len(out["c"]["ms"]) == 2
    assert out["rel_err"] <= cs.PAGERANK_MAX_REL_ERR
    assert all(p <= 500 for p in out["passes"])
