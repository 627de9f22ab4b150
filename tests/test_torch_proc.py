"""The port's multi-process harness (``reflow_tpu_torch.proc``) against
``tests/test_proc.py`` and the JAX package, on the CPU.

Every test of ``tests/test_proc.py`` has a counterpart here. The hermetic
half drives the parent-side machinery without spawning anything:
``OwnershipMap`` (the same map and layout as the JAX one),
``horizon_barrier``, the harness's crash seams, the deterministic producer
batches. The subprocess half spawns real ``python -m
reflow_tpu_torch.proc`` children (each imports torch first, about 1.5-2 s
on this host; every wait on a child is bounded): the kill -9 / respawn /
barrier cycle under a paced producer, the replica role's ready and exit
lines, and a mixed fleet: a JAX replica child (``python -m
reflow_tpu.proc``) following a port leader child, its view equal to the
fold of every acknowledged batch, with the fleet's telemetry reaching a
port aggregator from both packages' children. The children run word-count
on the CPU oracle, as the JAX package's do.
"""

import json
import os
import subprocess
import sys
import time
from collections import Counter

import pytest

from reflow_tpu.proc import ProcHarness as JProcHarness
from reflow_tpu.proc import worker as jworker
from reflow_tpu.proc.ownership import OwnershipMap as JOwnershipMap
from reflow_tpu_torch.net import ReplicaServer, TcpTransport
from reflow_tpu_torch.proc import (BarrierTimeout, OwnershipMap,
                                   ProcHarness, horizon_barrier)
from reflow_tpu_torch.proc import harness as pharness
from reflow_tpu_torch.proc.harness import ControlClient
from reflow_tpu_torch.proc.worker import producer_batch_words
from reflow_tpu_torch.serve import ReplicaScheduler
from reflow_tpu_torch.utils.faults import CrashInjector, CrashPoint
from reflow_tpu_torch.workloads import wordcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: children see no card: the oracle needs none
CHILD_ENV = {"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}


# -- ownership + barrier (hermetic) ------------------------------------


def test_ownership_map_round_robin_and_layout(tmp_path):
    m = OwnershipMap(str(tmp_path), ["a", "b"], sources=["s0", "s1",
                                                         "s2"])
    assert m.owner("s0") == "a" and m.owner("s1") == "b"
    assert m.owner("s2") == "a"
    assert m.sources_of("a") == ["s0", "s2"]
    for d in (m.wal_dir("a"), m.ckpt_dir("a")):
        assert os.path.isdir(d)
    # mirror_dir only names the path: the ReplicaScheduler lays it out
    assert m.mirror_dir("b") == os.path.join(str(tmp_path), "b", "wal")
    m2 = OwnershipMap.from_spec(m.spec())
    assert m2.owner("s2") == "a" and m2.sources_of("b") == ["s1"]
    # a spec crosses between the packages: the same owners and dirs
    j = JOwnershipMap.from_spec(m.spec())
    assert j.spec() == m.spec()
    assert [j.owner(s) for s in m.sources] == \
        [m.owner(s) for s in m.sources]
    assert j.wal_dir("b") == m.wal_dir("b")


def test_horizon_barrier_waits_for_the_straggler():
    horizons = {"a": 5, "b": 2}

    def probe(name):
        def read():
            h = horizons[name]
            horizons[name] = h + 1       # advances on every poll
            return h
        return read

    out = horizon_barrier({n: probe(n) for n in horizons},
                          timeout_s=5.0, poll_s=0.001)
    # the target was pinned on the first full pass (max = 5)
    assert out["a"] >= 5 and out["b"] >= 5


def test_horizon_barrier_timeout_reports_last_observations():
    probes = {"up": lambda: 7, "down": lambda: None}  # never reachable
    with pytest.raises(BarrierTimeout) as ei:
        horizon_barrier(probes, min_horizon=7, timeout_s=0.2,
                        poll_s=0.01)
    assert ei.value.horizons["up"] == 7
    assert ei.value.horizons["down"] is None


def test_deterministic_producer_batches():
    """The oracle refolds acked batches from (index, seq) alone, and both
    packages' producers submit the same batch for the same pair."""
    assert producer_batch_words(0, 0) == producer_batch_words(0, 0)
    assert producer_batch_words(0, 1) != producer_batch_words(0, 0)
    assert producer_batch_words(1, 0) != producer_batch_words(0, 0)
    for index in range(4):
        for seq in range(50):
            assert producer_batch_words(index, seq) == \
                jworker.producer_batch_words(index, seq)


# -- chaos seams (hermetic) --------------------------------------------


def test_spawn_seam_cuts_before_the_child_exists(tmp_path):
    crash = CrashInjector(1, only="proc_spawn@r0")
    h = ProcHarness(str(tmp_path), crash=crash, fleet=False)
    try:
        with pytest.raises(CrashPoint):
            h.spawn_replica("r0")
        assert crash.fired_seam == "proc_spawn@r0"
        assert "r0" not in h.children    # nothing leaked half-spawned
    finally:
        h.close()


def test_kill9_and_respawn_seams_cut_before_acting(tmp_path):
    crash = CrashInjector(1, only="proc_kill9@r0")
    h = ProcHarness(str(tmp_path), crash=crash, fleet=False)
    try:
        with pytest.raises(CrashPoint):
            h.kill9("r0")
        assert h.kills == 0              # the seam fired before the kill
        h._crash = CrashInjector(1, only="proc_respawn@r0")
        with pytest.raises(CrashPoint):
            h.respawn("r0")
        assert h.respawns == 0
    finally:
        h.close()


def test_harness_spawns_the_port_package(tmp_path):
    """The harness's children are ``python -m reflow_tpu_torch.proc``,
    run from the root that holds ``reflow_tpu_torch``."""
    h = ProcHarness(str(tmp_path), fleet=False)
    try:
        argv = h._argv({"role": "replica", "name": "r0",
                        "root": str(tmp_path / "r0")})
        assert argv[1:3] == ["-m", "reflow_tpu_torch.proc"]
        assert os.path.isdir(os.path.join(pharness._REPO_ROOT,
                                          "reflow_tpu_torch"))
    finally:
        h.close()


# -- port 0 / OS-assigned addressing -----------------------------------


def test_parallel_replica_servers_get_distinct_ports(tmp_path):
    """Replica endpoints bind port 0 side by side: the OS assigns every
    port, nothing collides, and each reported address is dialable."""
    g, _src, sink = wordcount.build_graph()
    servers = []
    try:
        for i in range(3):
            rep = ReplicaScheduler(g, str(tmp_path / f"r{i}"),
                                   name=f"r{i}")
            servers.append(ReplicaServer(rep, TcpTransport()).start())
        ports = [s.address[1] for s in servers]
        assert len(set(ports)) == 3 and all(p > 0 for p in ports)
        for s in servers:
            ok, horizon, view = ControlClient(s.address).call(
                "view", sink.name)
            assert ok == "ok" and horizon == 0 and view == {}
    finally:
        for s in servers:
            s.close()


# -- real child-process cycles -----------------------------------------


def test_child_kill9_respawn_rejoins_the_barrier(tmp_path):
    """A real proc_spawn / proc_kill9 / proc_respawn cycle: the replica
    child dies by SIGKILL mid-stream, comes back over the same state
    directory, and rejoins the fleet at a consistent horizon while a
    paced producer keeps writing."""
    h = ProcHarness(str(tmp_path), fleet=False, child_env=CHILD_ENV)
    try:
        ready = h.spawn_leader()
        assert ready["ingest"][1] > 0        # OS-assigned, reported
        h.spawn_replica("r0")
        assert h.replica_address("r0")[1] > 0
        h.attach_replicas()
        h.spawn_producer("p0", index=0, pace_s=0.02)
        time.sleep(0.5)

        h.kill9("r0")
        assert not h.child("r0").alive
        h.respawn("r0")
        h.attach_replicas(["r0"])
        out = h.barrier(timeout_s=60.0)      # recovered and caught up
        assert out["r0"] >= 0
        assert h.kills == 1 and h.respawns == 1

        st = h.child("p0").stop()
        assert st is not None and st["ok"]
        assert st["in_doubt"] == []          # every batch fully acked
        assert len(st["acked"]) >= 1
    finally:
        h.close()


def test_cli_role_replica_json_status(tmp_path):
    """``python -m reflow_tpu_torch.proc --role replica --json``: the
    first stdout line is the ready JSON with the OS-assigned address, EOF
    on stdin is a clean stop, and the last line is the exit status."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "reflow_tpu_torch.proc",
         "--role", "replica", "--name", "rx",
         "--root", str(tmp_path / "rx"), "--json"],
        cwd=REPO, text=True, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, env=dict(os.environ, **CHILD_ENV))
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["event"] == "ready" and ready["name"] == "rx"
        assert ready["addr"][1] > 0 and ready["subs"][1] > 0
        proc.stdin.close()                   # EOF doubles as stop
        out = proc.stdout.read()
        assert proc.wait(timeout=30) == 0
        status = json.loads(out.strip().splitlines()[-1])
        assert status["event"] == "exit" and status["ok"]
        assert not status["promoted"]
    finally:
        if proc.poll() is None:
            proc.kill()


def _oracle(acked, index):
    """The word-count view folded from every acknowledged batch."""
    counts = Counter()
    for seq, _status in acked:
        counts.update(producer_batch_words(index, seq))
    return {(w, float(c)): 1 for w, c in counts.items()}


def test_mixed_fleet_jax_replica_follows_a_port_leader(tmp_path):
    """A port leader child ships its WAL to a JAX replica child (``python
    -m reflow_tpu.proc``) while a port producer child writes: the JAX
    replica's view reaches the fold of every acknowledged batch, nothing
    more, and both packages' children ship telemetry to the port
    harness's aggregator."""
    h = ProcHarness(str(tmp_path / "port"), child_env=CHILD_ENV)
    tele = "{}:{}".format(*h.telemetry.address)
    j = JProcHarness(str(tmp_path / "jax"), fleet=False,
                     child_env=CHILD_ENV)
    j._argv = (lambda spec, real=j._argv:
               real(spec) + ["--telemetry", tele])
    try:
        h.spawn_leader()
        j.spawn_replica("jr0")
        leader = h.child("leader")
        leader.send({"cmd": "attach",
                     "replicas": [["jr0", list(j.replica_address("jr0"))]]})
        assert leader.await_event("attached", 10.0) is not None
        h.spawn_producer("p0", index=3, pace_s=0.01)
        time.sleep(1.0)
        st = h.child("p0").stop()
        assert st["ok"] and st["in_doubt"] == [] and st["acked"]
        want = _oracle(st["acked"], 3)
        ctl = ControlClient(j.replica_address("jr0"))
        deadline = time.monotonic() + 30.0
        while True:
            _ok, horizon, view = ctl.call("view", "out")
            if view == want or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert view == want, f"the JAX replica at horizon {horizon}"
        assert horizon >= 1
        assert h.aggregator.await_nodes(3, timeout_s=10.0)
        nodes = h.aggregator.fleet_snapshot()["nodes"]
        assert {"leader", "jr0", "p0"} <= set(nodes)
        assert nodes["jr0"]["horizon"] is not None
    finally:
        j.close()
        h.close()
