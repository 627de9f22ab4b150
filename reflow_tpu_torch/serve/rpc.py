"""Ingestion RPC: ``IngestFrontend.submit() -> Ticket`` over the wire.

The producer half of "Multi-process deployment" (docs/guide.md).
Replication already crosses processes (``net/client.py`` /
``net/server.py``); this module does the same for *ingestion* so a
producer can live in its own OS process and still get the exact
frontend contract: submit a batch, hold a ticket, learn its fate —
APPLIED (with ``tick``/``lsn``), DEDUPED, REJECTED or SHED.

Wire protocol (pickled tuples over ``net/framing.py``)::

    ("hello", producer, in_doubt_ids) -> ("ok", {graph, epoch, tick,
                                                 admitted})
    ("submit",) + SubmitReq           -> ("ack",) + SubmitAck
    ("resolve",) + TicketResolve      -> ("ok", {batch_id: SubmitAck})
    ("ping",)                         -> ("ok", {graph, tick, lsn,
                                                 state})
    ("view", sink_name)               -> ("ok", tick, {key: weight})
    anything else                     -> ("err", text)

Exactly-once across reconnects is the point of the handshake. A
producer that dies mid-submit cannot know whether its last batch was
admitted, so on (re)connect it sends every in-doubt ``batch_id`` with
``hello``; the server answers with the subset its frontend's dedup
mirror remembers. Either way the producer simply *resubmits* the same
ids: an admitted id resolves DEDUPED against the mirror (one fold
total), an unadmitted one folds exactly once. The handshake makes the
outcome observable — ``RemoteProducer.last_hello["admitted"]`` — and
lets tests pin the invariant; it is never required for safety, which
rests on the mirror alone.

The port's copy of ``reflow_tpu/serve/rpc.py``, on the same wire: a
producer of either package submits to a server of either. A batch
crosses as a host ``DeltaBatch`` of numpy columns; :meth:`RemoteProducer.
submit` brings a device batch to the host first, and the framing
refuses a torch tensor.

Ticket identity does NOT survive the server's ticket-table bound
(``REFLOW_RPC_TICKETS``): an evicted in-flight ticket resolves as
``"unknown"`` and the producer resubmits — again safe by dedup. A
promoted replacement leader starts with an empty table but a recovered
mirror, so the same path covers failover.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, NamedTuple, Optional, Tuple

from reflow_tpu_torch.executors.device_delta import DeviceDelta, to_host
from reflow_tpu_torch.net.backoff import ReconnectPolicy
from reflow_tpu_torch.net.framing import TransportError, WireTimeout
from reflow_tpu_torch.net.transport import Conn, Transport
from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.serve.tickets import (
    APPLIED, DEDUPED, REJECTED, SHED, FrontendClosed, TicketResult)
from reflow_tpu_torch.utils.config import env_float, env_int
from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["SubmitReq", "SubmitAck", "TicketResolve", "RpcIngestServer",
           "RemoteProducer", "RemoteTicket"]

#: accept/recv poll slice (matches net/server.py): how often blocked
#: server threads re-check the stop flag
_POLL_S = 0.2

#: ack states that end a ticket's life on the client
_TERMINAL = (APPLIED, DEDUPED, REJECTED, SHED)


class SubmitReq(NamedTuple):
    """One producer submission as it crosses the wire.

    ``cause`` is the optional causality token minted at the producer
    (``obs.trace.mint_cause``); its presence IS the sampling decision —
    the server adopts it instead of re-rolling, so every process
    records the same 1-in-N writes. Trailing + defaulted and trimmed
    when None (:func:`_trim`) so untraced requests stay byte-identical
    to the pre-trace wire protocol."""

    batch_id: str
    source: str                    # source/loop node name on the graph
    payload: Any                   # host DeltaBatch (picklable)
    timeout_s: Optional[float] = None
    cause: Optional[str] = None


class SubmitAck(NamedTuple):
    """Server's answer to a submit (or one entry of a resolve reply).

    ``state`` is a ticket status (terminal), ``"pending"`` (admitted,
    fate undecided — resolve later), ``"retry"`` (frontend closed or
    pump crashed mid-admission; resubmit after backoff) or
    ``"unknown"`` (server holds no ticket for this id; resubmit).
    ``result`` carries the :class:`TicketResult` fields when terminal.
    """

    batch_id: str
    state: str
    result: Optional[tuple] = None
    reason: Optional[str] = None
    cause: Optional[str] = None    # echo of the request token (traced)


class TicketResolve(NamedTuple):
    """Poll the fate of outstanding tickets, server-side long-poll up
    to ``wait_s`` (capped by ``REFLOW_RPC_RESOLVE_WAIT_S``)."""

    batch_ids: tuple
    wait_s: float = 0.0


def _trim(fields: tuple) -> tuple:
    """Drop exactly one trailing None before a frame hits the wire —
    the ``Shipment`` compat pattern (net/client.py): an unstamped
    request/ack pickles byte-identically to the pre-``cause`` protocol,
    while the receiving NamedTuple's default fills the gap."""
    if fields and fields[-1] is None:
        fields = fields[:-1]
    return fields


def _ticket_cause(ticket) -> Optional[str]:
    """The causality token riding a server-side ticket's trace context
    (None for unsampled/untraced tickets)."""
    return getattr(getattr(ticket, "trace", None), "cause", None)


def _result_fields(res: TicketResult) -> tuple:
    return (res.status, res.batch_id, res.tick, res.coalesced_with,
            res.reason, res.lsn)


def _result_from(fields) -> TicketResult:
    return TicketResult(*fields)


def _host_batch(batch):
    """The batch as it crosses the wire: a device batch (its tensors on
    a card or the CPU) comes back to the host, padding dropped; a host
    batch passes as it is."""
    if isinstance(batch, DeviceDelta):
        return to_host(batch)
    return batch


def _frontend_of(handle):
    """Accept an ``IngestFrontend`` or anything carrying one (a
    ``GraphHandle`` from the serve tier exposes ``.frontend``)."""
    return getattr(handle, "frontend", handle)


class RpcIngestServer:
    """Host one frontend's ingestion endpoint over ``transport``.

    Same shape as :class:`~reflow_tpu_torch.net.server.ReplicaServer`: an
    accept-loop thread plus one handler thread per connection, so one
    producer's blocked admission (``policy="block"`` backpressure)
    never stalls another's. ``start()`` binds (port 0 under TCP — the
    OS assigns) and ``address`` reports the dialable address.
    """

    def __init__(self, handle, transport: Transport, *,
                 max_tickets: Optional[int] = None) -> None:
        self.handle = handle
        self.transport = transport
        self.max_tickets = (max_tickets if max_tickets is not None
                            else env_int("REFLOW_RPC_TICKETS"))
        self._submit_cap = env_float("REFLOW_RPC_SUBMIT_TIMEOUT_S")
        self._resolve_cap = env_float("REFLOW_RPC_RESOLVE_WAIT_S")
        self._listener = None
        self._stop = threading.Event()
        self._accept_thread = None
        self._lock = named_lock("serve.rpc.server")
        self._conns: list = []
        self._handlers: list = []
        self._tickets: "OrderedDict[str, Any]" = OrderedDict()
        self.connections_total = 0
        self.requests_total = 0
        self.submits_total = 0
        self.evicted_tickets = 0

    # the frontend is re-read per request: a tier ``rebind()`` revives
    # the same frontend object in place, and a ``GraphHandle`` always
    # names the current one — no server restart across failover rebinds
    @property
    def frontend(self):
        return _frontend_of(self.handle)

    @property
    def address(self):
        if self._listener is None:
            raise TransportError("server not started")
        return self._listener.address

    def start(self) -> "RpcIngestServer":
        if self._accept_thread is not None:
            return self
        self._listener = self.transport.listen()
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True)
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
                    name=f"rpc-serve/{self.connections_total}",
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
        if op == "hello":
            return self._op_hello(*args)
        if op == "submit":
            return ("ack",) + _trim(tuple(self._op_submit(
                SubmitReq(*args))))
        if op == "resolve":
            return ("ok", self._op_resolve(TicketResolve(*args)))
        if op == "ping":
            return ("ok", self._status())
        if op == "flush":
            self.frontend.flush(timeout=args[0] if args else None)
            return ("ok",)
        if op == "view":
            fe = self.frontend
            sched = fe.sched
            return ("ok", sched._tick, dict(sched.view(args[0])))
        return ("err", f"unknown op {op!r}")

    def _status(self) -> dict:
        fe = self.frontend
        sched = fe.sched
        wal = getattr(sched, "wal", None)
        return {
            "graph": getattr(sched.graph, "name", "flow"),
            "tick": sched._tick,
            "lsn": wal.last_lsn() if wal is not None else None,
            "epoch": getattr(sched, "epoch", 0),
            "state": fe._state,
        }

    def _op_hello(self, producer, in_doubt_ids):
        """The dedup handshake: which of the producer's in-doubt ids
        does the frontend's mirror already remember? The reply also
        piggybacks this server's clock anchor (inside the dict — the
        reply stays a 2-tuple for old clients) so producer-side spans
        can be displayed on the leader's wall axis post-mortem."""
        from reflow_tpu_torch.obs.wire import clock_anchor
        fe = self.frontend
        sched = fe.sched
        return ("ok", {
            "graph": getattr(sched.graph, "name", "flow"),
            "epoch": getattr(sched, "epoch", 0),
            "tick": sched._tick,
            "admitted": fe.admitted_ids(in_doubt_ids),
            "anchor": clock_anchor(),
        })

    def _source_node(self, name: str):
        fe = self.frontend
        for node in fe.sched.graph.nodes:
            if node.name == name and node.kind in ("source", "loop"):
                return node
        raise KeyError(f"no source/loop node named {name!r}")

    def _op_submit(self, req: SubmitReq) -> SubmitAck:
        self.submits_total += 1
        t0 = time.perf_counter()
        source = self._source_node(req.source)
        timeout = self._submit_cap
        if req.timeout_s is not None:
            timeout = min(timeout, req.timeout_s)
        try:
            # the wire decision rides the token: a present ``cause``
            # means the producer sampled this write, so the frontend
            # adopts it (and its sampling bit) instead of re-rolling —
            # every process then records the same writes
            ticket = self.frontend.submit(
                source, req.payload, batch_id=req.batch_id,
                timeout=timeout, cause=req.cause,
                sampled=(req.cause is not None))
        except FrontendClosed as e:
            # closed OR pump crashed: either way the producer holds the
            # payload and the mirror holds the truth — tell it to retry
            return SubmitAck(req.batch_id, "retry",
                             reason=f"{type(e).__name__}: {e}",
                             cause=req.cause)
        if _trace.ENABLED and req.cause is not None:
            _trace.evt("rpc_admit", t0, time.perf_counter() - t0,
                       track="rpc-server",
                       args={"batch_id": req.batch_id,
                             "cause": req.cause})
        return self._ack_of(ticket)

    def _ack_of(self, ticket) -> SubmitAck:
        cause = _ticket_cause(ticket)
        if ticket.done():
            try:
                res = ticket.result(timeout=0)
            except FrontendClosed as e:
                return SubmitAck(ticket.batch_id, "retry",
                                 reason=f"{type(e).__name__}: {e}",
                                 cause=cause)
            with self._lock:
                self._tickets.pop(ticket.batch_id, None)
            return SubmitAck(ticket.batch_id, res.status,
                             result=_result_fields(res), cause=cause)
        with self._lock:
            self._tickets[ticket.batch_id] = ticket
            self._tickets.move_to_end(ticket.batch_id)
            while len(self._tickets) > self.max_tickets:
                self._evict_one()
        return SubmitAck(ticket.batch_id, "pending", cause=cause)

    def _evict_one(self) -> None:
        # caller holds the lock; prefer dropping a resolved ticket (its
        # fate was deliverable) over an in-flight one (which will
        # resolve "unknown" -> resubmit -> DEDUPED, still exactly-once)
        for bid, t in self._tickets.items():
            if t.done():
                del self._tickets[bid]
                return
        self._tickets.popitem(last=False)
        self.evicted_tickets += 1

    def _op_resolve(self, req: TicketResolve) -> Dict[str, tuple]:
        wait_s = min(max(req.wait_s, 0.0), self._resolve_cap)
        deadline = time.perf_counter() + wait_s
        while True:
            out, pending = {}, []
            with self._lock:
                tickets = {b: self._tickets.get(b)
                           for b in req.batch_ids}
            for bid, t in tickets.items():
                if t is None:
                    out[bid] = _trim(tuple(SubmitAck(
                        bid, "unknown",
                        reason="no ticket on this server; resubmit")))
                elif t.done():
                    out[bid] = _trim(tuple(self._ack_of(t)))
                else:
                    pending.append(t)
                    out[bid] = _trim(tuple(SubmitAck(
                        bid, "pending", cause=_ticket_cause(t))))
            remaining = deadline - time.perf_counter()
            if not pending or remaining <= 0 or self._stop.is_set():
                return out
            # long-poll one slice on the first undecided ticket; loop
            # re-reads them all (another may have resolved meanwhile)
            pending[0]._event.wait(min(remaining, _POLL_S))

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


class RemoteTicket:
    """Client-side future for one remote submission.

    Unlike an in-process :class:`~reflow_tpu_torch.serve.tickets.Ticket`,
    this one RETAINS its payload until the fate is terminal: a link
    reset in the ack window means the producer cannot know whether the
    batch was admitted, and the only safe move is to resubmit the same
    ``batch_id`` after reconnect (the server's dedup mirror collapses
    the duplicate).
    """

    __slots__ = ("batch_id", "source", "payload", "timeout_s",
                 "submits", "link_gen", "cause", "_producer", "_result")

    def __init__(self, producer: "RemoteProducer", batch_id: str,
                 source: str, payload, timeout_s: Optional[float],
                 cause: Optional[str] = None):
        self.batch_id = batch_id
        self.source = source
        self.payload = payload
        self.timeout_s = timeout_s
        self.submits = 0       # wire submits (resubmits = submits - 1)
        self.link_gen = -1     # dial generation the last submit rode
        #: causality token for a sampled submission — minted ONCE, so
        #: every resubmit of this batch rides the same token and the
        #: post-failover chain still joins on string equality
        self.cause = cause
        self._producer = producer
        self._result: Optional[TicketResult] = None

    def done(self) -> bool:
        return self._result is not None

    def result(self, timeout: Optional[float] = None) -> TicketResult:
        """Drive the producer's link until this ticket is terminal.
        Raises ``TimeoutError`` if the fate stays undecided — the
        ticket stays live and a later call resumes where this left
        off."""
        res = self._producer._await(self, timeout)
        if res is None:
            raise TimeoutError(
                f"remote ticket {self.batch_id!r} unresolved after "
                f"{timeout}s (link {self._producer.conn_state})")
        return res


class RemoteProducer:
    """Mirror of the ``IngestFrontend.submit() -> Ticket`` surface over
    a framed transport connection.

    Owns the unreliable-link lifecycle the way
    :class:`~reflow_tpu_torch.net.client.RemoteFollower` does for shipping:
    :class:`ReconnectPolicy` gates every re-dial, a down link never
    raises out of :meth:`submit` (the ticket simply stays pending), and
    every fresh connection re-runs the ``hello`` dedup handshake with
    all in-doubt ids before any resubmission.

    ``retarget(address)`` swings the producer at a different endpoint
    (the promoted leader after a failover); in-doubt tickets are then
    resubmitted there, where the recovered dedup mirror keeps them
    exactly-once.
    """

    def __init__(self, transport: Transport, address, *,
                 name: str = "producer",
                 policy: Optional[ReconnectPolicy] = None,
                 io_timeout_s: Optional[float] = None) -> None:
        self.transport = transport
        self.address = address
        self.name = name
        self.policy = policy if policy is not None \
            else ReconnectPolicy(name)
        self.io_timeout_s = (io_timeout_s if io_timeout_s is not None
                             else env_float("REFLOW_RPC_IO_TIMEOUT_S"))
        self._lock = named_lock("serve.rpc.producer")
        self._conn: Optional[Conn] = None
        self._gen = 0                  # successful-dial generation
        self._seq = 0
        self._pending: "OrderedDict[str, RemoteTicket]" = OrderedDict()
        #: server's answer to the last hello (graph/epoch/tick/admitted)
        self.last_hello: Optional[dict] = None
        #: server clock anchor from the last hello (+ rtt_s /
        #: wall_offset_s), when the server sends one; display-only —
        #: never used for ordering
        self.anchor: Optional[dict] = None
        self.submits_total = 0
        self.resubmits_total = 0
        self.reconnects_total = 0
        self.link_failures = 0
        self.deduped_total = 0

    @property
    def conn_state(self) -> str:
        return self.policy.state

    def transport_snapshot(self) -> dict:
        snap = self.policy.snapshot()
        snap["address"] = str(self.address)
        snap["in_doubt"] = len(self._pending)
        return snap

    def in_doubt_ids(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._pending)

    # -- the frontend surface ------------------------------------------

    def submit(self, source, batch, *, batch_id: Optional[str] = None,
               timeout: Optional[float] = None) -> RemoteTicket:
        """Submit one batch to the remote frontend (a device batch goes
        as its host copy). Returns a :class:`RemoteTicket` immediately;
        a down link just leaves it pending (``result()`` keeps pushing).
        ``source`` is a graph ``Node`` or its name."""
        src = getattr(source, "name", source)
        batch = _host_batch(batch)
        with self._lock:
            if batch_id is None:
                batch_id = f"{self.name}-{self._seq}"
                self._seq += 1
            cause = None
            if _trace.ENABLED and _trace.sample():
                # sampling is decided HERE, before any ticket exists on
                # the server; the token carries the decision downstream
                epoch = (self.last_hello or {}).get("epoch", 0)
                cause = _trace.mint_cause(self.name, epoch)
            ticket = RemoteTicket(self, batch_id, src, batch, timeout,
                                  cause=cause)
            self._pending[batch_id] = ticket
            self._ensure_link()
            self._push(ticket)
        return ticket

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every outstanding ticket is terminal."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while True:
            with self._lock:
                t = next(iter(self._pending.values()), None)
            if t is None:
                return
            left = (None if deadline is None
                    else deadline - time.perf_counter())
            if left is not None and left <= 0:
                raise TimeoutError(
                    f"{len(self.in_doubt_ids())} tickets still in "
                    f"doubt after {timeout}s")
            t.result(left)

    def retarget(self, address) -> None:
        """Point at a new endpoint (post-failover). The live link is
        torn down; the next pump re-dials, re-runs hello with every
        in-doubt id and resubmits them there."""
        with self._lock:
            self.address = address
            if self._conn is not None:
                self._conn.close()
                self._conn = None
            self.policy.failed()  # schedules a (short, first) backoff

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    # -- link machinery ------------------------------------------------

    def _fail(self, err: Exception) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        self.link_failures += 1
        self.policy.failed()

    def _ensure_link(self) -> bool:
        """Dial + hello handshake if the link is down and a backoff
        window is open. Caller holds the lock. True if live."""
        if self._conn is not None:
            return True
        if not self.policy.due():
            return False
        t0 = time.perf_counter()
        try:
            conn = self.transport.connect(self.address)
            conn.send_msg(("hello", self.name, tuple(self._pending)),
                          self.io_timeout_s)
            resp = conn.recv_msg(self.io_timeout_s)
        except TransportError as e:
            self._fail(e)
            if _trace.ENABLED:
                _trace.evt("net_reconnect", t0,
                           time.perf_counter() - t0,
                           track=f"rpc/{self.name}",
                           args={"ok": False, "error": str(e)[:120],
                                 "state": self.policy.state})
            return False
        if not (isinstance(resp, tuple) and len(resp) == 2
                and resp[0] == "ok"):
            conn.close()
            self._fail(TransportError(f"bad hello response {resp!r}"))
            return False
        recovered = self.policy.ok()
        if recovered:
            self.reconnects_total += 1
        self._conn = conn
        self._gen += 1
        self.last_hello = dict(resp[1])
        anchor = self.last_hello.get("anchor")
        if isinstance(anchor, dict):
            # pre-anchor servers omit the key; newer ones piggyback a
            # clock anchor so this producer's spans can be shown on the
            # leader's wall axis (error bounded by rtt/2)
            rtt = time.perf_counter() - t0
            anchor = dict(anchor)
            anchor["rtt_s"] = rtt
            anchor["wall_offset_s"] = anchor.get("wall", 0.0) - \
                (time.time() - rtt / 2.0)
            self.anchor = anchor
        if _trace.ENABLED:
            _trace.evt("net_reconnect", t0, time.perf_counter() - t0,
                       track=f"rpc/{self.name}",
                       args={"ok": True, "recovered": recovered,
                             "in_doubt": len(self._pending)})
        return True

    def _roundtrip(self, msg: tuple,
                   cause: Optional[str] = None) -> Any:
        conn = self._conn
        if conn is None:
            return None
        t0 = time.perf_counter()
        try:
            conn.send_msg(msg, self.io_timeout_s)
            resp = conn.recv_msg(self.io_timeout_s)
        except TransportError as e:
            self._fail(e)
            if _trace.ENABLED:
                args = {"op": msg[0], "ok": False,
                        "error": str(e)[:120]}
                if cause is not None:
                    args["cause"] = cause
                _trace.evt("net_send", t0, time.perf_counter() - t0,
                           track=f"rpc/{self.name}", args=args)
            return None
        self.policy.ok()
        if _trace.ENABLED:
            args = {"op": msg[0], "ok": True}
            if cause is not None:
                args["cause"] = cause
            _trace.evt("net_send", t0, time.perf_counter() - t0,
                       track=f"rpc/{self.name}", args=args)
        return resp

    def _push(self, ticket: RemoteTicket) -> None:
        """One wire submit for ``ticket`` (caller holds the lock; link
        may drop mid-call — the ticket then stays in doubt)."""
        if self._conn is None or ticket.done():
            return
        if ticket.submits > 0:
            self.resubmits_total += 1
        ticket.submits += 1
        ticket.link_gen = self._gen
        req = SubmitReq(ticket.batch_id, ticket.source, ticket.payload,
                        ticket.timeout_s, ticket.cause)
        self.submits_total += 1
        t0 = time.perf_counter()
        resp = self._roundtrip(("submit",) + _trim(tuple(req)),
                               cause=ticket.cause)
        if _trace.ENABLED and ticket.cause is not None:
            # the producer's end of the chain: submit sent -> ack (or
            # link loss) — freshness decomposition anchors ack->deliver
            # at this span's start
            _trace.evt("producer_submit", t0,
                       time.perf_counter() - t0,
                       track=f"rpc/{self.name}",
                       args={"batch_id": ticket.batch_id,
                             "cause": ticket.cause,
                             "submits": ticket.submits,
                             "ok": resp is not None})
        if isinstance(resp, tuple) and resp and resp[0] == "ack":
            self._apply_ack(ticket, SubmitAck(*resp[1:]))
        elif isinstance(resp, tuple) and resp and resp[0] == "err":
            # a protocol rejection (unknown source, malformed batch) is
            # deterministic — retrying the same request cannot succeed,
            # so resolve the ticket rather than park it in doubt
            ticket._result = TicketResult(REJECTED, ticket.batch_id,
                                          reason=str(resp[1]))
            ticket.payload = None
            self._pending.pop(ticket.batch_id, None)

    def _apply_ack(self, ticket: RemoteTicket, ack: SubmitAck) -> None:
        # caller holds the lock
        if ack.state in _TERMINAL:
            ticket._result = _result_from(ack.result)
            ticket.payload = None  # drop the retained bytes
            self._pending.pop(ticket.batch_id, None)
            if ack.state == DEDUPED:
                self.deduped_total += 1
        elif ack.state == "unknown":
            # the server holds no ticket (evicted, or a promoted
            # replacement): resubmit on the next pump — the dedup
            # mirror keeps the duplicate from folding twice
            ticket.link_gen = -1
        elif ack.state == "retry":
            # frontend closed / pump crashed mid-admission: back off a
            # touch, then resubmit against the (revived or promoted)
            # frontend on a later pump
            ticket.link_gen = -1
        # "pending": nothing to do — resolve polls will decide it

    def _pump(self, wait_s: float) -> None:
        """One client pump: ensure the link, (re)submit anything the
        current connection hasn't carried, then long-poll resolve."""
        with self._lock:
            if not self._ensure_link():
                return
            for t in list(self._pending.values()):
                if t.link_gen != self._gen:
                    self._push(t)
                    if self._conn is None:
                        return
            ids = tuple(self._pending)
            if not ids:
                return
            resp = self._roundtrip(
                ("resolve",) + tuple(TicketResolve(ids, wait_s)))
            if not (isinstance(resp, tuple) and len(resp) == 2
                    and resp[0] == "ok"):
                return
            for bid, fields in resp[1].items():
                t = self._pending.get(bid)
                if t is not None:
                    self._apply_ack(t, SubmitAck(*fields))

    def _await(self, ticket: RemoteTicket,
               timeout: Optional[float]) -> Optional[TicketResult]:
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while True:
            if ticket.done():
                return ticket._result
            left = (None if deadline is None
                    else deadline - time.perf_counter())
            if left is not None and left <= 0:
                return None
            if self._conn is None:
                # link down: sleep out (a slice of) the backoff window
                # instead of spinning on due()
                nap = max(self.policy.seconds_until_due(), 0.01)
                if left is not None:
                    nap = min(nap, left)
                time.sleep(min(nap, _POLL_S))
            wait = _POLL_S if left is None else min(left, _POLL_S)
            self._pump(wait)
