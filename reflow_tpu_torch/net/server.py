"""ReplicaServer: put a ReplicaScheduler behind a transport listener.

The port's copy of ``reflow_tpu/net/server.py``; it moves the same frames.

The server end of "Replication over the wire" (docs/guide.md): it owns
a :class:`~reflow_tpu_torch.net.transport.Listener` and answers the shipping
protocol as framed request-response messages, delegating every decision
to the wrapped :class:`~reflow_tpu_torch.serve.replica.ReplicaScheduler` —
epoch fencing, order/CRC rejection, holdback and cursor persistence all
stay exactly where the in-process tests already exercise them. The
wire adds nothing but the wire.

Requests (pickled tuples, ``net/framing.py``)::

    ("subscribe",)                     -> ("ok", cursor | None, anchor)
    ("bootstrap", ckpt_dir)            -> ("ok", cursor)
    ("receive", *shipment_fields)      -> ("ack", cursor, horizon)
                                        | ("nack", cursor, reason)
    ("ping",)                          -> ("ok", {name, horizon, epoch,
                                                  lag_ticks})
    ("view", sink_name)                -> ("ok", horizon, {key: weight})
    anything else                      -> ("err", text)

Addressing: ``start()`` binds whatever the transport's listener
reports — under :class:`~reflow_tpu_torch.net.transport.TcpTransport` that
is port 0 by default, so the OS assigns a free port and ``address``
is the authoritative ``(host, port)`` to advertise. Callers must read
``address`` *after* ``start()`` rather than pre-picking ports; this
is what lets the process harness spawn many replica processes in
parallel (each child prints its assigned address on its ready line)
without port collisions.

Concurrency: one accept-loop thread plus one handler thread per
connection. Multiple concurrent clients are not an edge case — during
a failover the NEW leader's shipper and the partitioned zombie's both
hold connections, and the replica's own lock (plus the epoch fence)
arbitrates. A handler treats :class:`WireTimeout` as "idle, keep
waiting" and any other :class:`TransportError` (including a
:class:`FrameError` from a corrupted frame — unsyncable by design) as
the end of that connection; the client reconnects and re-handshakes,
which ``subscribe()`` makes idempotent.
"""

from __future__ import annotations

import threading
from typing import Optional

from reflow_tpu_torch.net.framing import TransportError, WireTimeout
from reflow_tpu_torch.net.transport import Conn, Transport
from reflow_tpu_torch.utils.runtime import named_lock
from reflow_tpu_torch.wal.ship import ShipAck, Shipment

__all__ = ["ReplicaServer"]

#: accept/recv poll slice: how often blocked server threads re-check
#: the stop flag (short, so close() never hangs a test)
_POLL_S = 0.2


class ReplicaServer:
    """Serve one replica's shipping endpoint over ``transport``.

    ``start()`` binds a listener and returns; ``address`` is then
    dialable by a :class:`~reflow_tpu_torch.net.client.RemoteFollower`.
    ``close()`` tears down the listener and every live connection.
    """

    def __init__(self, replica, transport: Transport) -> None:
        self.replica = replica
        self.transport = transport
        self._listener = None
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._lock = named_lock("net.server")
        self._conns: list = []
        self._handlers: list = []
        self.connections_total = 0
        self.requests_total = 0
        self.frame_resets = 0

    @property
    def address(self):
        if self._listener is None:
            raise TransportError("server not started")
        return self._listener.address

    def start(self) -> "ReplicaServer":
        if self._accept_thread is not None:
            return self
        self._listener = self.transport.listen()
        self._stop.clear()
        name = getattr(self.replica, "name", "replica")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"net-accept/{name}",
            daemon=True)
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
                self._conns.append(conn)
                t = threading.Thread(
                    target=self._serve_conn, args=(conn,),
                    name=f"net-serve/{self.connections_total}",
                    daemon=True)
                self._handlers.append(t)
            t.start()

    def _serve_conn(self, conn: Conn) -> None:
        try:
            while not self._stop.is_set():
                try:
                    msg = conn.recv_msg(timeout_s=_POLL_S)
                except WireTimeout:
                    continue  # idle connection; re-check stop and wait
                except TransportError:
                    # closed, reset, or an unsyncable corrupt frame —
                    # drop the connection; the client re-handshakes
                    self.frame_resets += 1
                    return
                try:
                    reply = self._dispatch(msg)
                except TransportError:
                    raise
                except Exception as e:  # noqa: BLE001 - a poisoned
                    # request must not kill the endpoint for the others
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
        r = self.replica
        if op == "subscribe":
            cur = r.subscribe()
            # piggyback a clock anchor on the handshake so the leader
            # can display this replica's span timestamps on one wall
            # axis; old clients ignore the third element (lazy import —
            # obs.wire rides this package's transports)
            from reflow_tpu_torch.obs.wire import clock_anchor
            return ("ok", tuple(cur) if cur is not None else None,
                    clock_anchor(getattr(r, "name", "replica")))
        if op == "bootstrap":
            return ("ok", tuple(r.bootstrap(args[0])))
        if op == "receive":
            resp = r.receive(Shipment(*args))
            if isinstance(resp, ShipAck):
                return ("ack", tuple(resp.cursor), resp.horizon)
            return ("nack",
                    tuple(resp.cursor) if resp.cursor is not None
                    else None,
                    resp.reason)
        if op == "ping":
            return ("ok", {
                "name": getattr(r, "name", "replica"),
                "horizon": r.published_horizon(),
                "epoch": getattr(r, "epoch", 0),
                "lag_ticks": r.lag_ticks() if hasattr(r, "lag_ticks")
                else 0,
            })
        if op == "view":
            # published view at a consistent cut — parity checks across
            # process boundaries (bench oracle, harness barrier probes)
            horizon, view = r.view_at(args[0])
            return ("ok", horizon, dict(view))
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
