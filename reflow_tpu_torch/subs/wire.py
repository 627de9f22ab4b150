"""Subscription wire protocol: standing queries over ``net/`` framing.

Pickled tuples over the shared length-prefixed CRC framing (the same
carrier as replication and the ingestion RPC)::

    ("sub",) + SubscribeReq       -> ("ok",) + SubAck + (anchor,)
                                     | ("err", text)
    ("sub_poll", token, acked,
                 wait_s)          -> ("ok", frames, horizon)
                                     | ("gone", token) | ("err", text)
    ("sub_close", token)          -> ("ok",)
    ("ping",)                     -> ("ok", {name, horizon, active,
                                             shed_level})
    anything else                 -> ("err", text)

``frames`` is a tuple of plain-tuple :class:`~reflow_tpu_torch.subs.query
.DeltaFrame`\\ s. An empty ``frames`` reply is the heartbeat: it
certifies the query unchanged through ``horizon``, which lets the
client advance its cursor without data. ``acked`` rides every poll so
the server drops delivered frames exactly when the client has durably
applied them — the cursor is the whole resume protocol. ``("gone",
token)`` means the server no longer knows the token (expired while the
client was partitioned away, or the replica restarted): the client
re-handshakes and the hub decides resume-vs-snapshot from the cursor.

The server is intentionally dumb: every decision (resume rules,
conflation, shedding, parking) lives in the
:class:`~reflow_tpu_torch.subs.hub.SubscriptionHub`; this module only frames
it. Long polls are capped by ``REFLOW_SUB_POLL_WAIT_S`` so a subscriber
cannot pin a handler thread past the stop flag's patience.

The port's copy of ``reflow_tpu/subs/wire.py``; requests and replies
are plain tuples (never the NamedTuple classes), so the bytes on the
wire are the JAX package's.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

from reflow_tpu_torch.net.framing import TransportError, WireTimeout
from reflow_tpu_torch.net.transport import Conn, Transport
from reflow_tpu_torch.subs.query import frames_to_wire
from reflow_tpu_torch.utils.config import env_float, env_int
from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["SubscribeReq", "SubAck", "SubscriptionServer"]

#: accept/recv poll slice (matches net/server.py)
_POLL_S = 0.2


class SubscribeReq(NamedTuple):
    """Register (or resume) one standing query over the wire.
    ``cursor`` is the client's local horizon (-1 = none); ``token``
    lets a reconnecting client reclaim its server-side outbox."""

    sink: str
    kind: str = "view"
    params: tuple = ()
    cursor: int = -1
    min_horizon: int = 0
    token: Optional[str] = None


class SubAck(NamedTuple):
    """``mode`` is ``"resume"`` (stream continues from the cursor,
    gap-free and duplicate-free) or ``"snapshot"`` (a full snapshot
    frame precedes the stream)."""

    token: str
    horizon: int
    mode: str


class SubscriptionServer:
    """Host one hub's subscription endpoint over ``transport``.

    Same shape as :class:`~reflow_tpu_torch.serve.rpc.RpcIngestServer`: an
    accept-loop thread plus one handler thread per connection, so one
    subscriber's long poll never delays another's handshake."""

    def __init__(self, hub, transport: Transport) -> None:
        self.hub = hub
        self.transport = transport
        self._poll_cap = env_float("REFLOW_SUB_POLL_WAIT_S")
        self._max_frames = env_int("REFLOW_SUB_MAX_FRAMES")
        self._listener = None
        self._stop = threading.Event()
        self._accept_thread = None
        self._lock = named_lock("subs.server")
        self._conns: list = []
        self._handlers: list = []
        self.connections_total = 0
        self.requests_total = 0
        self.subscribes_total = 0
        self.polls_total = 0

    @property
    def address(self):
        if self._listener is None:
            raise TransportError("server not started")
        return self._listener.address

    def start(self) -> "SubscriptionServer":
        if self._accept_thread is not None:
            return self
        self._listener = self.transport.listen()
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="subs-accept", daemon=True)
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
                    name=f"subs-serve/{self.connections_total}",
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

    # -- ops -----------------------------------------------------------

    def _dispatch(self, msg):
        if not isinstance(msg, tuple) or not msg:
            return ("err", f"malformed request {type(msg).__name__}")
        self.requests_total += 1
        op, args = msg[0], msg[1:]
        if op == "sub":
            return self._op_sub(SubscribeReq(*args))
        if op == "sub_poll":
            return self._op_poll(*args)
        if op == "sub_close":
            self.hub.unsubscribe(args[0])
            return ("ok",)
        if op == "ping":
            load = self.hub.load()
            return ("ok", {"name": self.hub.name,
                           "horizon": load["horizon"],
                           "active": load["active"],
                           "shed_level": load["shed_level"]})
        return ("err", f"unknown op {op!r}")

    def _op_sub(self, req: SubscribeReq):
        self.subscribes_total += 1
        token, mode = self.hub.subscribe(
            req.sink, req.kind, req.params, token=req.token,
            cursor=req.cursor, min_horizon=req.min_horizon, wire=True)
        # trailing clock anchor (obs.wire.clock_anchor) piggybacks on
        # the handshake so post-mortem tools can align this process's
        # monotonic clock; older clients ignore extra elements.
        from reflow_tpu_torch.obs.wire import clock_anchor
        return ("ok",) + tuple(
            SubAck(token, self.hub.fanout_horizon, mode)) + (
            clock_anchor(),)

    def _op_poll(self, token, acked, wait_s):
        self.polls_total += 1
        wait = min(max(float(wait_s), 0.0), self._poll_cap)
        try:
            frames, horizon = self.hub.poll(
                token, acked=acked, wait_s=wait,
                max_frames=self._max_frames)
        except KeyError:
            return ("gone", token)
        return ("ok", frames_to_wire(frames), horizon)

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
