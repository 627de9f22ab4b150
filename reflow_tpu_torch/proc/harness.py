"""The multi-process harness: spawn, kill -9, respawn, promote.

``ProcHarness`` is the parent-side control plane for a fleet of real
OS processes (``python -m reflow_tpu_torch.proc`` children — see
``proc/worker.py`` for what each role runs):

- **Spawn**: children bind port 0 and report their OS-assigned
  addresses on a JSON ready line; the parent never pre-picks ports, so
  any number of fleets run in parallel. The parent hosts the fleet's
  :class:`~reflow_tpu_torch.obs.wire.TelemetryServer`; every child ships
  registry snapshots to it, so ``fleet_snapshot()`` shows the whole
  multi-process topology from one place.
- **Chaos**: :meth:`kill9` is a real ``SIGKILL`` — no atexit, no
  flush, the process is simply gone, which is the only honest way to
  test the durability story. :meth:`respawn` restarts the same node
  name over the same state directory; the child recovers from its
  local mirrored WAL and the caller uses :func:`~reflow_tpu_torch.proc
  .ownership.horizon_barrier` to wait for it to rejoin at a
  consistent cut. Both are crash seams (``proc_kill9@<node>`` /
  ``proc_respawn@<node>`` / ``proc_spawn@<node>``) so recovery tests
  can cut the *harness* mid-operation too.
- **Failover**: :meth:`coordinator` wires a stock
  :class:`~reflow_tpu_torch.serve.failover.FailoverCoordinator` across the
  process boundary — candidates are :class:`RemoteReplicaProxy`
  objects speaking the replica children's control protocol, the final
  drain runs off a *cold-log* :class:`~reflow_tpu_torch.wal.ship
  .SegmentShipper` over the dead leader's on-disk WAL (synced bytes
  are plain file bytes; the leader being kill -9'd does not make its
  disk unreadable), and the promotion itself executes inside the
  winning replica *process*, which starts serving ingestion on a
  fresh ``RpcIngestServer``. Producers are then retargeted and their
  in-doubt resubmissions stay exactly-once against the recovered
  dedup mirror.

Every blocking child interaction is deadline-bounded
(``REFLOW_PROC_READY_TIMEOUT_S`` / ``REFLOW_PROC_REAP_TIMEOUT_S``): a
hung child is killed and reported, never waited on forever — the CI
suite must survive the worst child, that being the point of the
exercise.

The port's copy of ``reflow_tpu/proc/harness.py``: it spawns
``python -m reflow_tpu_torch.proc`` and takes the repository root from
``reflow_tpu_torch.__file__``. A port child imports torch first (about
1.5-2 s on a CPU host, against about 0.3 s for a JAX child, which
imports no JAX on this path), well inside the ready deadline.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import reflow_tpu_torch
from reflow_tpu_torch.net.client import RemoteFollower
from reflow_tpu_torch.net.framing import TransportError
from reflow_tpu_torch.net.transport import TcpTransport
from reflow_tpu_torch.obs.fleet import FleetAggregator
from reflow_tpu_torch.obs.wire import TelemetryServer
from reflow_tpu_torch.proc.ownership import horizon_barrier
from reflow_tpu_torch.serve.failover import FailoverCoordinator
from reflow_tpu_torch.utils.config import env_float, env_str
from reflow_tpu_torch.utils.runtime import named_lock
from reflow_tpu_torch.wal.ship import SegmentShipper

__all__ = ["ChildProc", "ControlClient", "RemoteReplicaProxy",
           "ProcHarness"]

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.abspath(reflow_tpu_torch.__file__)))


class ChildProc:
    """One spawned role process: pipes, ready line, reaping.

    A reader thread turns the child's stdout JSON lines into
    :attr:`ready` / :attr:`exit_status` / :attr:`events`; stderr
    passes through (child tracebacks must land somewhere a human
    looks). ``kill9()`` is SIGKILL; ``stop()`` asks politely first and
    escalates on the reap deadline.
    """

    def __init__(self, name: str, role: str, argv: List[str],
                 env: Optional[dict] = None,
                 cwd: str = _REPO_ROOT) -> None:
        self.name = name
        self.role = role
        self.argv = list(argv)
        self.env = dict(env) if env is not None else None
        self.cwd = cwd
        self.proc: Optional[subprocess.Popen] = None
        self.ready: Optional[dict] = None
        self.exit_status: Optional[dict] = None
        self.events: List[dict] = []
        self._ready_evt = threading.Event()
        self._lock = named_lock(f"proc.child.{name}")

    def start(self) -> "ChildProc":
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        env["PYTHONPATH"] = self.cwd + os.pathsep + \
            env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            self.argv, cwd=self.cwd, env=env, text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=None, bufsize=1)
        threading.Thread(target=self._read_stdout,
                         name=f"proc-out/{self.name}",
                         daemon=True).start()
        return self

    def _read_stdout(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if not line.startswith("{"):
                continue  # library noise on stdout is not protocol
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            with self._lock:
                self.events.append(obj)
                if obj.get("event") == "ready":
                    self.ready = obj
                    self._ready_evt.set()
                elif obj.get("event") == "exit":
                    self.exit_status = obj

    def wait_ready(self, timeout_s: Optional[float] = None) -> dict:
        timeout_s = (env_float("REFLOW_PROC_READY_TIMEOUT_S")
                     if timeout_s is None else timeout_s)
        if not self._ready_evt.wait(timeout_s):
            rc = self.proc.poll() if self.proc is not None else None
            self.kill9()
            raise TimeoutError(
                f"child {self.name} ({self.role}) not ready after "
                f"{timeout_s}s (rc={rc})")
        return self.ready

    def await_event(self, event: str,
                    timeout_s: float = 10.0) -> Optional[dict]:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                for obj in self.events:
                    if obj.get("event") == event:
                        return obj
            if not self.alive:
                return None
            time.sleep(0.02)
        return None

    def send(self, obj: dict) -> bool:
        p = self.proc
        if p is None or p.poll() is not None or p.stdin is None:
            return False
        try:
            p.stdin.write(json.dumps(obj) + "\n")
            p.stdin.flush()
            return True
        except (OSError, ValueError):
            return False

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def kill9(self) -> None:
        """SIGKILL — the process gets no chance to flush anything."""
        p = self.proc
        if p is not None and p.poll() is None:
            try:
                os.kill(p.pid, signal.SIGKILL)
            except OSError:
                pass
        self.reap(5.0)

    def reap(self, timeout_s: Optional[float] = None) -> Optional[int]:
        """Wait for exit with a deadline; escalate to SIGKILL on it.
        Always bounded — a hung child cannot wedge the caller."""
        timeout_s = (env_float("REFLOW_PROC_REAP_TIMEOUT_S")
                     if timeout_s is None else timeout_s)
        p = self.proc
        if p is None:
            return None
        try:
            return p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            try:
                os.kill(p.pid, signal.SIGKILL)
            except OSError:
                pass
            try:
                return p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                return None

    def stop(self, timeout_s: Optional[float] = None) -> Optional[dict]:
        """Graceful stop: send the command, reap on a deadline, return
        the child's exit-status JSON (None if it never printed one —
        e.g. it had to be killed)."""
        self.send({"cmd": "stop"})
        if self.proc is not None and self.proc.stdin is not None:
            try:
                self.proc.stdin.close()  # EOF doubles as stop
            except OSError:
                pass
        self.reap(timeout_s)
        return self.exit_status


class ControlClient:
    """Dial-per-call client for a replica child's control endpoint
    (:class:`~reflow_tpu_torch.proc.worker.ControlledReplicaServer`). No
    connection state survives between calls, so a child restart (new
    port, new process) needs nothing but the refreshed address."""

    def __init__(self, address, *, host: str = "127.0.0.1",
                 io_timeout_s: Optional[float] = None) -> None:
        self.address = tuple(address)
        self.transport = TcpTransport(host)
        self.io_timeout_s = (io_timeout_s if io_timeout_s is not None
                             else env_float("REFLOW_RPC_IO_TIMEOUT_S"))

    def call(self, *msg):
        """One request-response; raises TransportError on any link or
        protocol failure."""
        conn = self.transport.connect(self.address)
        try:
            conn.send_msg(tuple(msg), self.io_timeout_s)
            resp = conn.recv_msg(self.io_timeout_s)
        finally:
            conn.close()
        if not (isinstance(resp, tuple) and resp
                and resp[0] in ("ok", "ack", "nack")):
            raise TransportError(f"control {msg[0]!r} failed: {resp!r}")
        return resp

    def try_call(self, *msg):
        try:
            return self.call(*msg)
        except TransportError:
            return None

    def status(self) -> Optional[dict]:
        resp = self.try_call("status")
        return resp[1] if resp is not None else None

    def horizon(self) -> Optional[int]:
        st = self.status()
        return int(st["horizon"]) if st is not None else None


class RemoteReplicaProxy:
    """A replica *process* as a failover candidate.

    Duck-types what :class:`FailoverCoordinator` and
    :class:`HighestHorizonElection` read — ``name``,
    ``published_horizon()``, ``promoted``, ``epoch``, ``reanchor()``,
    ``promote()`` — over the child's control protocol. An unreachable
    candidate reports horizon ``-1`` (it loses any election against a
    live peer rather than raising mid-promotion).

    ``promote()`` runs the whole cross-process step 5: survivors are
    re-anchored to the new epoch first, then the winner child promotes
    in place and attaches them to its fresh shipper. The returned
    leader object carries the child's new ingest address and — by
    design — no ``.wal``, so the coordinator's in-process re-shipping
    block stays idle (the child already did it where the WAL lives).
    """

    def __init__(self, harness: "ProcHarness", name: str) -> None:
        self.harness = harness
        self.name = name

    def _control(self) -> ControlClient:
        return self.harness.control(self.name)

    def published_horizon(self) -> int:
        h = self._control().horizon()
        return -1 if h is None else h

    def lag_ticks(self) -> int:
        st = self._control().status()
        return int(st["lag_ticks"]) if st else 0

    @property
    def promoted(self) -> bool:
        st = self._control().status()
        return bool(st and st["promoted"])

    @property
    def epoch(self) -> int:
        st = self._control().status()
        return int(st["epoch"]) if st else 0

    def reanchor(self, epoch: int):
        resp = self._control().try_call("reanchor", epoch)
        return tuple(resp[1]) if resp is not None else None

    def promote(self, *, epoch: int, **durable_kw):
        h = self.harness
        survivors = [(nm, list(h.replica_address(nm)))
                     for nm in h.replica_names()
                     if nm != self.name and h.child(nm).alive]
        for nm, _addr in survivors:
            h.control(nm).try_call("reanchor", epoch)
        resp = self._control().call("promote", epoch, survivors,
                                    dict(durable_kw))
        info = resp[1]
        return h._promoted(self.name, tuple(info["ingest"]), epoch)


class PromotedLeader:
    """What a cross-process promotion returns: where the new leader
    serves ingestion. Deliberately ``.wal``-less (see
    :meth:`RemoteReplicaProxy.promote`)."""

    def __init__(self, name: str, ingest, epoch: int) -> None:
        self.name = name
        self.ingest = tuple(ingest)
        self.epoch = epoch


class ProcHarness:
    """Spawn and torment a leader + replicas + producers fleet."""

    def __init__(self, root: str, *, host: str = "127.0.0.1",
                 crash=None, fleet: bool = True,
                 child_env: Optional[dict] = None,
                 python: Optional[str] = None,
                 workload: str = "wordcount") -> None:
        self.root = root
        self.host = host
        self.workload = workload
        self._crash = crash
        self._python = (python or env_str("REFLOW_PROC_PYTHON")
                        or sys.executable)
        self._child_env = dict(child_env or {})
        self.children: Dict[str, ChildProc] = {}
        self._specs: Dict[str, dict] = {}
        self.leader_name: Optional[str] = None
        self.ingest_address: Optional[Tuple[str, int]] = None
        self.kills = 0
        self.respawns = 0
        self.aggregator: Optional[FleetAggregator] = None
        self.telemetry: Optional[TelemetryServer] = None
        if fleet:
            self.aggregator = FleetAggregator()
            self.telemetry = TelemetryServer(
                self.aggregator, TcpTransport(host), node="harness")
            self.telemetry.start()

    # -- seams ---------------------------------------------------------

    def _chaos_point(self, name: str) -> None:
        if self._crash is not None:
            self._crash.point(name)

    # -- spawning ------------------------------------------------------

    def _argv(self, spec: dict) -> List[str]:
        argv = [self._python, "-m", "reflow_tpu_torch.proc",
                "--role", spec["role"], "--name", spec["name"],
                "--host", self.host, "--workload", self.workload,
                "--json"]
        if spec.get("root"):
            argv += ["--root", spec["root"]]
        if spec.get("connect"):
            host, port = spec["connect"]
            argv += ["--connect", f"{host}:{port}"]
        if self.telemetry is not None:
            host, port = self.telemetry.address
            argv += ["--telemetry", f"{host}:{port}"]
        if "index" in spec:
            argv += ["--index", str(spec["index"])]
        if spec.get("pace"):
            argv += ["--pace", str(spec["pace"])]
        if spec.get("fsync"):
            argv += ["--fsync", spec["fsync"]]
        if spec.get("epoch"):
            argv += ["--epoch", str(spec["epoch"])]
        return argv

    def _spawn(self, spec: dict) -> dict:
        name = spec["name"]
        self._chaos_point(f"proc_spawn@{name}")
        child = ChildProc(name, spec["role"], self._argv(spec),
                          env=self._child_env)
        self.children[name] = child
        self._specs[name] = dict(spec)
        child.start()
        ready = child.wait_ready()
        if spec["role"] == "leader":
            self.leader_name = name
            self.ingest_address = tuple(ready["ingest"])
        return ready

    def spawn_leader(self, name: str = "leader", *,
                     fsync: str = "tick", epoch: int = 0) -> dict:
        return self._spawn({
            "role": "leader", "name": name, "fsync": fsync,
            "epoch": epoch,
            "root": os.path.join(self.root, name)})

    def spawn_replica(self, name: str) -> dict:
        return self._spawn({
            "role": "replica", "name": name,
            "root": os.path.join(self.root, name)})

    def spawn_producer(self, name: str, *, index: int = 0,
                       connect: Optional[Tuple[str, int]] = None,
                       pace_s: float = 0.0) -> dict:
        if connect is None:
            connect = self.ingest_address
        if connect is None:
            raise RuntimeError("no leader to connect the producer to")
        return self._spawn({
            "role": "producer", "name": name, "index": index,
            "connect": tuple(connect), "pace": pace_s,
            # producers get a disk corner too: the flight recorder and
            # exit-time trace export land there, same as server roles
            "root": os.path.join(self.root, name)})

    # -- topology ------------------------------------------------------

    def child(self, name: str) -> ChildProc:
        return self.children[name]

    def replica_names(self) -> List[str]:
        return [n for n, s in self._specs.items()
                if s["role"] == "replica"]

    def producer_names(self) -> List[str]:
        return [n for n, s in self._specs.items()
                if s["role"] == "producer"]

    def replica_address(self, name: str) -> Tuple[str, int]:
        return tuple(self.children[name].ready["addr"])

    def control(self, name: str) -> ControlClient:
        return ControlClient(self.replica_address(name), host=self.host)

    def leader_wal_dir(self) -> str:
        return self.children[self.leader_name].ready["wal_dir"]

    def leader_ckpt_dir(self) -> str:
        return self.children[self.leader_name].ready["ckpt_dir"]

    def attach_replicas(self, names: Optional[List[str]] = None,
                        timeout_s: float = 10.0) -> None:
        """Tell the leader child to attach (or re-attach) replicas to
        its shipper."""
        names = self.replica_names() if names is None else names
        leader = self.children[self.leader_name]
        leader.send({"cmd": "attach",
                     "replicas": [[nm, list(self.replica_address(nm))]
                                  for nm in names]})
        leader.await_event("attached", timeout_s)

    def retarget_producers(self, address: Tuple[str, int]) -> None:
        for nm in self.producer_names():
            self.children[nm].send({"cmd": "connect",
                                    "address": list(address)})

    # -- chaos ---------------------------------------------------------

    def kill9(self, name: str) -> None:
        """SIGKILL one child, mid-whatever-it-was-doing."""
        self._chaos_point(f"proc_kill9@{name}")
        self.children[name].kill9()
        self.kills += 1

    def respawn(self, name: str) -> dict:
        """Restart a killed child under its original spec — same name,
        same state directory; a replica recovers from its mirrored WAL
        and rejoins through the horizon barrier."""
        self._chaos_point(f"proc_respawn@{name}")
        spec = self._specs[name]
        old = self.children.get(name)
        if old is not None and old.alive:
            raise RuntimeError(f"respawn of live child {name!r}; "
                               f"kill9 it first")
        if spec["role"] == "producer" and self.ingest_address:
            spec = dict(spec, connect=tuple(self.ingest_address))
        ready = self._spawn(spec)
        self.respawns += 1
        return ready

    # -- the consistent cut --------------------------------------------

    def barrier(self, *, timeout_s: float = 15.0,
                min_horizon: Optional[int] = None,
                names: Optional[List[str]] = None) -> Dict[str, int]:
        """Cross-process tick-horizon barrier over the replica fleet
        (a respawned process rejoins by passing this)."""
        names = self.replica_names() if names is None else names
        probes = {nm: self.control(nm).horizon for nm in names}
        return horizon_barrier(probes, min_horizon=min_horizon,
                               timeout_s=timeout_s)

    # -- failover ------------------------------------------------------

    def _promoted(self, name: str, ingest: Tuple[str, int],
                  epoch: int) -> PromotedLeader:
        """Called from the winning proxy once its child serves
        ingestion: swing the harness's view and the producers."""
        self.leader_name = name
        self.ingest_address = tuple(ingest)
        self.retarget_producers(self.ingest_address)
        for nm, spec in self._specs.items():
            if spec["role"] == "producer":
                spec["connect"] = tuple(ingest)
        return PromotedLeader(name, ingest, epoch)

    def coordinator(self, *, confirm_intervals: int = 2,
                    drain_timeout_s: float = 5.0,
                    epoch: int = 0,
                    **kw) -> FailoverCoordinator:
        """A stock FailoverCoordinator spanning the process boundary.

        The drain shipper is a cold-log SegmentShipper over the (about
        to be dead) leader's on-disk WAL; candidates are control-
        protocol proxies; the sampler reports ``committer_dead`` from
        the leader child's exit status. Drive it with ``step()`` in a
        loop, exactly like the in-process coordinator.
        """
        leader = self.children[self.leader_name]
        shipper = SegmentShipper(
            wal_dir=self.leader_wal_dir(),
            ckpt_dir=self.leader_ckpt_dir(), epoch=epoch)
        for nm in self.replica_names():
            if not self.children[nm].alive:
                continue
            try:
                shipper.attach(RemoteFollower(
                    TcpTransport(), self.replica_address(nm), name=nm))
            except TransportError:
                pass  # a dead candidate just isn't drained into

        def sampler(now: float) -> dict:
            return {"committer_dead": not leader.alive,
                    "pump_failed": False, "beat": None,
                    "partitioned": False}

        coord = FailoverCoordinator(
            [RemoteReplicaProxy(self, nm)
             for nm in self.replica_names()],
            shipper=shipper, sampler=sampler,
            confirm_intervals=confirm_intervals,
            drain_timeout_s=drain_timeout_s, **kw)
        coord._epoch = epoch
        return coord

    # -- teardown ------------------------------------------------------

    def close(self) -> None:
        """Stop everyone, bounded: producers, leader, replicas — any
        child missing its reap deadline is SIGKILLed."""
        order = (self.producer_names()
                 + ([self.leader_name] if self.leader_name else [])
                 + self.replica_names())
        seen = set()
        for nm in order + list(self.children):
            if nm in seen or nm not in self.children:
                continue
            seen.add(nm)
            self.children[nm].stop()
        if self.telemetry is not None:
            self.telemetry.close()
