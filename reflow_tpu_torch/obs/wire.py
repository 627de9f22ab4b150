"""Telemetry wire plane: registry snapshots over the ``net/`` framed
transports (docs/guide.md "Fleet telemetry").

The data plane ships WAL bytes; this module ships *telemetry* — each
node's :class:`~reflow_tpu_torch.obs.registry.MetricsRegistry` snapshots —
from a :class:`~reflow_tpu_torch.obs.fleet.TelemetryShipper` to the
:class:`~reflow_tpu_torch.obs.fleet.FleetAggregator` behind a
:class:`TelemetryServer`. It deliberately reuses the replication
stack's parts (``Transport``/``Conn`` framing, ``ReconnectPolicy``
backoff, ``WireFaults`` injection via ``FaultyTransport``) so the
telemetry plane inherits the same fault model the chaos bench already
trusts, with one inversion: **telemetry loss is always tolerated**. A
dropped snapshot is a stale gauge, never an error — no call in this
module may block a data-path thread or let a telemetry failure
propagate as an exception.

Requests (pickled tuples, ``net/framing.py``)::

    ("hello", node, anchor)   -> ("ok", server_anchor)
    ("snap", node, snapshot)  -> ("ok",)
    ("fleet",)                -> ("ok", fleet_snapshot)
    ("ping",)                 -> ("ok", {node, nodes})
    anything else             -> ("err", text)

Clock anchoring: every process keeps its own monotonic clock; anchors
(:func:`clock_anchor`) pair a ``monotonic`` reading with the local
wall clock at handshake time so a consumer can *display* cross-node
timestamps on one axis. The offset is an estimate bounded by the
handshake RTT — it is never used for ordering or correctness (the
causality tokens on the data plane do that by exact string equality).

The port's copy of ``reflow_tpu/obs/wire.py``: the same pickled
requests over the same frames, so a JAX ``TelemetryLink`` ships to a port
``TelemetryServer`` and the reverse.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from reflow_tpu_torch.net.backoff import ReconnectPolicy
from reflow_tpu_torch.net.framing import TransportError, WireTimeout
from reflow_tpu_torch.net.transport import Conn, Transport
from reflow_tpu_torch.utils.config import env_str
from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["clock_anchor", "node_id", "TelemetryLink",
           "TelemetryServer"]

#: accept/recv poll slice, mirroring net/server.py: how often blocked
#: telemetry threads re-check the stop flag
_POLL_S = 0.2


def node_id() -> str:
    """This process's id on the telemetry plane: ``REFLOW_FLEET_NODE``
    when set, else ``node-<pid>`` (unique per process on one host —
    the single-host fleet the benches run)."""
    nid = env_str("REFLOW_FLEET_NODE")
    return nid if nid else f"node-{os.getpid()}"


def clock_anchor(node: Optional[str] = None) -> Dict[str, Any]:
    """One (monotonic, wall) clock pairing for ``node``, taken now.
    Exchanged at handshake time so consumers can anchor another
    process's monotonic span timestamps to a shared wall-clock axis,
    within handshake-RTT error. Display only — never ordering."""
    return {"node": node if node is not None else node_id(),
            "mono": time.monotonic(), "wall": time.time()}


class TelemetryLink:
    """Client end of one telemetry connection: dial, ``hello``
    handshake (clock-anchor exchange), then ``snap`` pushes.

    The whole unreliable-link lifecycle mirrors
    :class:`~reflow_tpu_torch.net.client.RemoteFollower`: a
    :class:`ReconnectPolicy` gates redials with capped backoff, and
    every failure path degrades to "this snapshot is dropped" —
    :meth:`send_snapshot` returns ``False`` instead of raising, so the
    shipper thread can never crash or stall on weather."""

    def __init__(self, transport: Transport, address, *,
                 node: Optional[str] = None,
                 policy: Optional[ReconnectPolicy] = None,
                 io_timeout_s: Optional[float] = None) -> None:
        self.transport = transport
        self.address = address
        self.node = node if node is not None else node_id()
        self.policy = policy if policy is not None \
            else ReconnectPolicy(f"telemetry/{self.node}")
        self.io_timeout_s = io_timeout_s
        self._conn: Optional[Conn] = None
        self.reconnects_total = 0
        self.link_failures = 0
        self.anchor: Optional[Dict[str, Any]] = None  # server's, +rtt

    @property
    def conn_state(self) -> str:
        return self.policy.state

    def _fail(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        self.link_failures += 1
        self.policy.failed()

    def _dial(self) -> bool:
        """One gated dial + hello. True when the link is live."""
        if not self.policy.due():
            return False
        try:
            conn = self.transport.connect(self.address)
        except TransportError:
            self._fail()
            return False
        t0 = time.monotonic()
        try:
            conn.send_msg(("hello", self.node, clock_anchor(self.node)),
                          self.io_timeout_s)
            resp = conn.recv_msg(self.io_timeout_s)
        except TransportError:
            conn.close()
            self._fail()
            return False
        rtt = time.monotonic() - t0
        if not (isinstance(resp, tuple) and len(resp) >= 2
                and resp[0] == "ok" and isinstance(resp[1], dict)):
            conn.close()
            self._fail()
            return False
        anchor = dict(resp[1])
        # wall-skew estimate against the midpoint of the exchange;
        # error is bounded by rtt/2 and recorded alongside
        anchor["rtt_s"] = rtt
        anchor["wall_offset_s"] = anchor.get("wall", 0.0) - \
            (time.time() - rtt / 2.0)
        self.anchor = anchor
        self._conn = conn
        if self.policy.ok():
            self.reconnects_total += 1
        return True

    def _roundtrip(self, msg: tuple) -> Any:
        """One request-response; None on any link failure (the failure
        is absorbed: connection closed, backoff armed)."""
        if self._conn is None and not self._dial():
            return None
        conn = self._conn
        try:
            conn.send_msg(msg, self.io_timeout_s)
            resp = conn.recv_msg(self.io_timeout_s)
        except TransportError:
            self._fail()
            return None
        self.policy.ok()
        return resp

    def send_snapshot(self, snapshot: Dict[str, Any]) -> bool:
        """Push one registry snapshot. False means the snapshot was
        dropped (link down / backoff open / failed mid-exchange) —
        always tolerated, never raised."""
        resp = self._roundtrip(("snap", self.node, snapshot))
        return isinstance(resp, tuple) and bool(resp) \
            and resp[0] == "ok"

    def fetch_fleet(self) -> Optional[Dict[str, Any]]:
        """The aggregator's current fleet snapshot, or None when the
        aggregator is unreachable (consumers render the last one they
        saw, stale-marked)."""
        resp = self._roundtrip(("fleet",))
        if isinstance(resp, tuple) and len(resp) >= 2 \
                and resp[0] == "ok" and isinstance(resp[1], dict):
            return resp[1]
        return None

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class TelemetryServer:
    """Serve a :class:`~reflow_tpu_torch.obs.fleet.FleetAggregator` over a
    transport listener — the fleet's telemetry ingest + query endpoint.

    Threading mirrors :class:`~reflow_tpu_torch.net.server.ReplicaServer`:
    one accept loop plus one handler per connection, ``WireTimeout`` as
    "idle", any other ``TransportError`` as the end of that connection.
    A poisoned request degrades to ``("err", ...)`` — the aggregator
    must keep serving the healthy nodes no matter what one link sends.
    """

    def __init__(self, aggregator, transport: Transport, *,
                 node: Optional[str] = None) -> None:
        self.aggregator = aggregator
        self.transport = transport
        self.node = node if node is not None else node_id()
        self._listener = None
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._lock = named_lock("obs.telemetry.server")
        self._conns: list = []
        self._handlers: list = []
        self.connections_total = 0
        self.requests_total = 0

    @property
    def address(self):
        if self._listener is None:
            raise TransportError("telemetry server not started")
        return self._listener.address

    def start(self) -> "TelemetryServer":
        if self._accept_thread is not None:
            return self
        self._listener = self.transport.listen()
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"telemetry-accept/{self.node}", daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept(timeout_s=_POLL_S)
            except WireTimeout:
                continue
            except TransportError:
                return  # listener closed under us
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self.connections_total += 1
                t = threading.Thread(
                    target=self._serve_conn, args=(conn,),
                    name=f"telemetry-serve/{self.connections_total}",
                    daemon=True)
                self._conns.append(conn)
                self._handlers.append(t)
            t.start()

    def _serve_conn(self, conn: Conn) -> None:
        try:
            while not self._stop.is_set():
                try:
                    msg = conn.recv_msg(timeout_s=_POLL_S)
                except WireTimeout:
                    continue
                except TransportError:
                    return
                try:
                    reply = self._dispatch(msg)
                except Exception as e:  # noqa: BLE001 - telemetry must
                    # never crash the aggregator endpoint
                    reply = ("err", f"{type(e).__name__}: {e}")
                try:
                    conn.send_msg(reply)
                except TransportError:
                    return
        finally:
            conn.close()
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _dispatch(self, msg):
        if not isinstance(msg, tuple) or not msg:
            return ("err", f"malformed request {type(msg).__name__}")
        self.requests_total += 1
        op, args = msg[0], msg[1:]
        agg = self.aggregator
        if op == "hello":
            if len(args) >= 2 and isinstance(args[1], dict):
                agg.record_anchor(str(args[0]), args[1])
            return ("ok", clock_anchor(self.node))
        if op == "snap":
            if len(args) < 2 or not isinstance(args[1], dict):
                return ("err", "malformed snap")
            agg.ingest(str(args[0]), args[1])
            return ("ok",)
        if op == "fleet":
            return ("ok", agg.fleet_snapshot())
        if op == "ping":
            return ("ok", {"node": self.node,
                           "nodes": agg.node_count()})
        return ("err", f"unknown op {op!r}")

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            self._listener.close()
        with self._lock:
            conns = list(self._conns)
            handlers = list(self._handlers)
        for c in conns:
            c.close()
        t, self._accept_thread = self._accept_thread, None
        if t is not None:
            t.join(timeout=5.0)
        for h in handlers:
            h.join(timeout=5.0)
