"""Child-process role runners for the multi-process harness.

``python -m reflow_tpu_torch.proc`` parses argv and hands a plain
options dict to one of :func:`run_leader` / :func:`run_replica` /
:func:`run_producer`.
Each runner owns its role's whole in-process stack (the same classes
the single-process tests drive — nothing is forked *logic*, only
forked *processes*), speaks a line protocol with the parent, and
returns a status dict the CLI prints as its exit JSON:

- **stdout**: one JSON object per line. The first is the ready line
  (``{"event": "ready", "name", "pid", addresses...}``) — the parent
  learns the OS-assigned ports from it. The last is the exit status.
- **stdin**: JSON commands — ``{"cmd": "stop"}`` everywhere;
  ``{"cmd": "attach", "replicas": [[name, [host, port]], ...]}`` on a
  leader; ``{"cmd": "connect", "address": [host, port]}`` retargets a
  producer at a promoted leader. EOF on stdin counts as ``stop``: a
  child whose parent vanished drains and exits instead of leaking.

The replica's control surface (``status`` / ``reanchor`` /
``promote``) rides its existing :class:`ReplicaServer` wire protocol
(:class:`ControlledReplicaServer` below) rather than stdin, because
the failover coordinator in the *parent* drives those per-candidate
during an election — request/response over the same framed transport
the shipper already uses, so a promotion works even if the parent's
pipe buffers are wedged.

The port's copy of ``reflow_tpu/proc/worker.py``. Every role runs
word-count with no executor, the CPU oracle (``ReplicaScheduler(graph,
root, name=name)``, ``DurableScheduler(g, wal_dir=...)``), as the JAX
package's do: this leg runs no kernel and opens no CUDA context. The
WAL and the shipped bytes are the JAX package's, so a JAX replica child
follows a port leader child.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
from typing import Dict, List, Optional

from reflow_tpu_torch.net.client import RemoteFollower
from reflow_tpu_torch.net.framing import TransportError
from reflow_tpu_torch.net.server import ReplicaServer
from reflow_tpu_torch.net.transport import TcpTransport
from reflow_tpu_torch.obs import flight as _flight
from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.obs.fleet import TelemetryShipper
from reflow_tpu_torch.obs.registry import REGISTRY
from reflow_tpu_torch.utils.config import env_flag, env_str
from reflow_tpu_torch.serve import (APPLIED, DEDUPED, IngestFrontend,
                              RemoteProducer, ReplicaScheduler,
                              RpcIngestServer)
from reflow_tpu_torch.subs.hub import SubscriptionHub
from reflow_tpu_torch.subs.wire import SubscriptionServer
from reflow_tpu_torch.utils.runtime import named_lock
from reflow_tpu_torch.wal.durable import DurableScheduler
from reflow_tpu_torch.wal.ship import SegmentShipper
from reflow_tpu_torch.workloads import wordcount

__all__ = ["ControlledReplicaServer", "run_leader", "run_replica",
           "run_producer", "producer_batch_words", "emit"]

#: producer batch shape: words per batch, vocabulary size — small
#: enough that dedup/coalescing paths all engage, deterministic so the
#: bench oracle can regenerate any batch from (producer, seq) alone
_BATCH_WORDS = 8
_BATCH_VOCAB = 50


def emit(obj: dict) -> None:
    """One protocol line on stdout (flushed — the parent blocks on
    it). Anything else the child prints must go to stderr."""
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _stdin_commands() -> "queue.Queue[Optional[dict]]":
    """Background reader: parsed JSON commands, ``None`` once on EOF.
    Non-JSON lines are ignored (a shell poking at the child is not a
    protocol error)."""
    q: "queue.Queue[Optional[dict]]" = queue.Queue()

    def read() -> None:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                cmd = json.loads(line)
            except ValueError:
                continue
            if isinstance(cmd, dict):
                q.put(cmd)
        q.put(None)

    threading.Thread(target=read, name="proc-stdin", daemon=True).start()
    return q


def _graph(workload: str):
    if workload != "wordcount":
        raise ValueError(f"unknown workload {workload!r}")
    return wordcount.build_graph()


def producer_batch_words(index: int, seq: int) -> List[str]:
    """The batch a producer child submits for (producer ``index``,
    ``seq``) — a pure function, shared with the bench oracle so acked
    ``batch_id``s alone reconstruct the exact submitted content."""
    base = (index + 1) * 100003 + seq * 9176
    return [f"w{(base + i * 31) % _BATCH_VOCAB}"
            for i in range(_BATCH_WORDS)]


def _obs_install(opts: dict, name: str):
    """Per-child observability: when ``REFLOW_FLIGHT`` is set, install
    the flight recorder in this node's disk corner
    (``REFLOW_FLIGHT_DIR`` or ``<root>/flight``) — the bounded on-disk
    recording a kill -9 leaves behind for ``tools/reflow_flight.py``."""
    if not env_flag("REFLOW_FLIGHT"):
        return None
    directory = env_str("REFLOW_FLIGHT_DIR")
    if not directory:
        root = opts.get("root")
        directory = os.path.join(root, "flight") if root else "flight"
    rec = _flight.install(directory, node=name)
    rec.publish_metrics(REGISTRY)
    return rec


def _obs_exit(opts: dict) -> None:
    """Clean-exit observability: flush the flight ring and export this
    child's trace rings to ``<root>/trace.json`` so the parent can
    merge per-process traces post-run. Killed children never get here
    — their evidence is the flight recording."""
    _flight.flush_now()
    if _trace.ENABLED and opts.get("root"):
        try:
            from reflow_tpu_torch.obs.export import export_chrome_trace
            export_chrome_trace(
                os.path.join(opts["root"], "trace.json"))
        except OSError:
            pass


def _telemetry(opts: dict, name: str) -> Optional[TelemetryShipper]:
    addr = opts.get("telemetry")
    if not addr:
        return None
    shipper = TelemetryShipper(REGISTRY, TcpTransport(), tuple(addr),
                               node=name)
    shipper.start()
    return shipper


# -- replica -----------------------------------------------------------


class ControlledReplicaServer(ReplicaServer):
    """A replica child's endpoint: the shipping protocol plus the
    parent-driven control ops an election needs::

        ("status",)                    -> ("ok", {..ping.., promoted,
                                                  ingest})
        ("reanchor", epoch)            -> ("ok", cursor)
        ("promote", epoch, attach,
                    durable_kw)        -> ("ok", {ingest, epoch})

    ``promote`` runs the full in-child promotion: the replica opens
    its mirror as its own WAL (``ReplicaScheduler.promote``), a fresh
    ``IngestFrontend`` + ``RpcIngestServer`` start serving producers,
    and a new ``SegmentShipper`` attaches the surviving replicas
    (``attach`` = ``[[name, [host, port]], ...]``; an unreachable
    survivor is skipped and counted, not fatal — it reanchors and
    resubscribes when it comes back).
    """

    def __init__(self, node: "ReplicaNode", transport) -> None:
        super().__init__(node.rep, transport)
        self.node = node

    def _dispatch(self, msg):
        if isinstance(msg, tuple) and msg:
            op, args = msg[0], msg[1:]
            if op == "status":
                return ("ok", self.node.status())
            if op == "reanchor":
                return ("ok", tuple(self.node.rep.reanchor(args[0])))
            if op == "promote":
                epoch, attach = args[0], args[1]
                kw = args[2] if len(args) > 2 and args[2] else {}
                return ("ok", self.node.promote(epoch, attach, kw))
        return super()._dispatch(msg)


class ReplicaNode:
    """Everything one replica process runs; promotable in place."""

    def __init__(self, name: str, root: str, *, host: str = "127.0.0.1",
                 workload: str = "wordcount") -> None:
        self.name = name
        self.host = host
        self.graph, self.src, self.sink = _graph(workload)
        self.rep = ReplicaScheduler(self.graph, root, name=name)
        self.server = ControlledReplicaServer(self, TcpTransport(host))
        #: standing-query fan-out: every replica child serves
        #: subscriptions beside the shipping endpoint
        self.hub = SubscriptionHub(self.rep, name=name, start=False)
        self.subs_server = SubscriptionServer(self.hub,
                                              TcpTransport(host))
        # cached at start: status() must keep answering on the exit
        # path, after the listener (and its getsockname) is gone
        self.subs_address: Optional[tuple] = None
        self.frontend: Optional[IngestFrontend] = None
        self.ingest: Optional[RpcIngestServer] = None
        self.ingest_address: Optional[tuple] = None
        self.shipper: Optional[SegmentShipper] = None
        self.attach_skipped = 0
        self._lock = named_lock(f"proc.node.{name}")

    def start(self) -> "ReplicaNode":
        self.rep.publish_metrics(REGISTRY)
        self.rep.attach_hub(self.hub)
        self.hub.start()
        self.hub.publish_metrics(REGISTRY)
        self.server.start()
        self.subs_server.start()
        self.subs_address = tuple(self.subs_server.address)
        return self

    def status(self) -> dict:
        r = self.rep
        return {
            "name": self.name,
            "horizon": r.published_horizon(),
            "epoch": r.epoch,
            "lag_ticks": r.lag_ticks(),
            "promoted": r.promoted,
            "ingest": (list(self.ingest_address)
                       if self.ingest_address is not None else None),
            "subs": (list(self.subs_address)
                     if self.subs_address is not None else None),
            "subs_active": self.hub.active_subs(),
        }

    def promote(self, epoch: int, attach, durable_kw: dict) -> dict:
        with self._lock:
            sched = self.rep.promote(epoch=epoch, **durable_kw)
            if self.frontend is None:
                self.frontend = IngestFrontend(sched, name=self.name)
                self.frontend.publish_metrics(REGISTRY)
                self.ingest = RpcIngestServer(
                    self.frontend, TcpTransport(self.host)).start()
                self.ingest_address = tuple(self.ingest.address)
                self.shipper = SegmentShipper(
                    sched.wal, ckpt_dir=self.rep.ckpt_dir,
                    leader_tick=lambda: sched._tick)
                self.shipper.publish_metrics(REGISTRY)
            for nm, addr in (attach or ()):
                try:
                    self.shipper.detach(nm)
                    self.shipper.attach(RemoteFollower(
                        TcpTransport(), tuple(addr), name=nm))
                except TransportError:
                    # survivor unreachable right now: it rejoins by
                    # reanchoring when respawned; never block promotion
                    self.attach_skipped += 1
            self.shipper.start()
            return {"ingest": list(self.ingest_address), "epoch": epoch}

    def close(self) -> None:
        if self.frontend is not None:
            self.frontend.close()
        if self.shipper is not None:
            self.shipper.stop()
        if self.ingest is not None:
            self.ingest.close()
        self.subs_server.close()
        self.hub.close()
        self.server.close()


def run_replica(opts: dict) -> dict:
    node = ReplicaNode(opts["name"], opts["root"],
                       host=opts.get("host", "127.0.0.1"),
                       workload=opts.get("workload", "wordcount"))
    node.start()
    _obs_install(opts, opts["name"])
    telemetry = _telemetry(opts, opts["name"])
    emit({"event": "ready", "role": "replica", "name": node.name,
          "pid": os.getpid(), "addr": list(node.server.address),
          "subs": list(node.subs_address)})
    cmds = _stdin_commands()
    try:
        while True:
            cmd = cmds.get()
            if cmd is None or cmd.get("cmd") == "stop":
                break
    finally:
        if telemetry is not None:
            telemetry.stop()
        node.close()
        _obs_exit(opts)
    st = node.status()
    st.update({"event": "exit", "role": "replica", "ok": True})
    return st


# -- leader ------------------------------------------------------------


def run_leader(opts: dict) -> dict:
    name = opts["name"]
    root = opts["root"]
    wal_dir = os.path.join(root, "wal")
    ckpt_dir = os.path.join(root, "ckpt")
    os.makedirs(wal_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    host = opts.get("host", "127.0.0.1")
    g, src, sink = _graph(opts.get("workload", "wordcount"))
    sched = DurableScheduler(g, wal_dir=wal_dir,
                             fsync=opts.get("fsync", "tick"),
                             epoch=int(opts.get("epoch", 0)))
    fe = IngestFrontend(sched, name=name)
    fe.publish_metrics(REGISTRY)
    ingest = RpcIngestServer(fe, TcpTransport(host)).start()
    shipper = SegmentShipper(sched.wal, ckpt_dir=ckpt_dir,
                             leader_tick=lambda: sched._tick)
    shipper.publish_metrics(REGISTRY)
    shipper.start()
    _obs_install(opts, name)
    telemetry = _telemetry(opts, name)
    emit({"event": "ready", "role": "leader", "name": name,
          "pid": os.getpid(), "ingest": list(ingest.address),
          "wal_dir": wal_dir, "ckpt_dir": ckpt_dir})
    cmds = _stdin_commands()
    attached: List[str] = []
    try:
        while True:
            cmd = cmds.get()
            if cmd is None or cmd.get("cmd") == "stop":
                break
            if cmd.get("cmd") == "attach":
                for nm, addr in cmd.get("replicas", ()):
                    # re-attach semantics: a respawned replica keeps
                    # its name but gets a fresh port — drop the stale
                    # link before the new subscribe handshake
                    shipper.detach(nm)
                    shipper.attach(RemoteFollower(
                        TcpTransport(), tuple(addr), name=nm))
                    attached.append(nm)
                emit({"event": "attached", "replicas": attached})
    finally:
        try:
            fe.close()
        except Exception:  # noqa: BLE001 - a crashed pump still exits
            pass
        shipper.stop()
        ingest.close()
        if telemetry is not None:
            telemetry.stop()
        _obs_exit(opts)
    wal = sched.wal
    return {"event": "exit", "role": "leader", "name": name, "ok": True,
            "tick": sched._tick, "lsn": wal.last_lsn(),
            "attached": attached}


# -- producer ----------------------------------------------------------


def run_producer(opts: dict) -> dict:
    """Submit deterministic batches until told to stop; resubmit until
    acked. The exit JSON carries every acked ``(seq, status)`` so the
    harness oracle can refold exactly what was acknowledged."""
    name = opts["name"]
    index = int(opts.get("index", 0))
    pace_s = float(opts.get("pace_s", 0.0) or 0.0)
    src_name = opts.get("source", "words")
    prod = RemoteProducer(TcpTransport(), tuple(opts["connect"]),
                          name=name)
    _obs_install(opts, name)
    telemetry = _telemetry(opts, name)
    emit({"event": "ready", "role": "producer", "name": name,
          "pid": os.getpid(), "connect": list(opts["connect"])})
    cmds = _stdin_commands()
    acked: List[List] = []          # [seq, status]
    stop = False
    drain_deadline: Optional[float] = None
    seq = 0

    def poll_cmds() -> None:
        nonlocal stop, drain_deadline
        while True:
            try:
                cmd = cmds.get_nowait()
            except queue.Empty:
                return
            if cmd is None or cmd.get("cmd") == "stop":
                if not stop:
                    stop = True
                    # stop means "finish the in-flight batch, then
                    # exit": abandoning an admitted batch would leave
                    # a fold no ack accounts for. Bounded — a dead
                    # leader can't wedge the exit.
                    drain_deadline = time.monotonic() + float(
                        cmd.get("drain_s", 10.0) if cmd else 10.0)
            elif cmd.get("cmd") == "connect":
                prod.retarget(tuple(cmd["address"]))

    try:
        while True:
            poll_cmds()
            if stop:
                break
            bid = f"{name}-{seq}"
            batch = wordcount.ingest_lines(
                [" ".join(producer_batch_words(index, seq))])
            ticket = prod.submit(src_name, batch, batch_id=bid)
            while True:
                poll_cmds()
                if stop and time.monotonic() >= drain_deadline:
                    break  # give up: the id stays in in_doubt below
                try:
                    res = ticket.result(timeout=0.3)
                except TimeoutError:
                    continue  # link down / mid-failover: keep driving
                if res.status in (APPLIED, DEDUPED):
                    acked.append([seq, res.status])
                    seq += 1
                    if pace_s > 0 and not stop:
                        # pacing keeps a many-process fleet from
                        # starving a recovering child on a small box
                        time.sleep(pace_s)
                    break
                # REJECTED (backpressure) or SHED: the contract says
                # re-send; same id keeps the fold exactly-once
                time.sleep(0.01)
                ticket = prod.submit(src_name, batch, batch_id=bid)
    finally:
        if telemetry is not None:
            telemetry.stop()
        prod.close()
        _obs_exit(opts)
    return {"event": "exit", "role": "producer", "name": name,
            "ok": True, "index": index, "acked": acked,
            "submits": prod.submits_total,
            "resubmits": prod.resubmits_total,
            "reconnects": prod.reconnects_total,
            "deduped": prod.deduped_total,
            "in_doubt": list(prod.in_doubt_ids())}
