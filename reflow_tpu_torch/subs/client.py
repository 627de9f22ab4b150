"""Subscriber — the client half of reactive reads.

Mirrors the :class:`~reflow_tpu_torch.serve.rpc.RemoteProducer` lifecycle
for the read direction: :class:`~reflow_tpu_torch.net.backoff
.ReconnectPolicy` gates every re-dial, a down link never raises out of
:meth:`Subscriber.pump` (state simply stops advancing until the link
heals), and every fresh connection re-runs the ``("sub", ...)``
handshake carrying the local cursor — the server's hub then decides
*resume* (stream continues, provably gap-free and duplicate-free) or
*snapshot* (full rebase frame first). The client never needs more
resume state than one integer.

The duplicate/gap proof is mechanical: every received frame runs
through :class:`~reflow_tpu_torch.subs.query.QueryState`'s contiguity rule,
so ``gaps_total`` / ``dups_applied`` on a live subscriber are the
test assertions, not log forensics. A detected gap (which the protocol
should never produce) triggers an automatic re-handshake so the stream
self-heals via snapshot rather than serving wrong values.

The port's copy of ``reflow_tpu/subs/client.py``.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Optional, Sequence

from reflow_tpu_torch.net.backoff import ReconnectPolicy
from reflow_tpu_torch.net.framing import TransportError
from reflow_tpu_torch.net.transport import Conn, Transport
from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.subs.query import (QueryState, canon_query,
                                         frames_from_wire)
from reflow_tpu_torch.subs.wire import SubAck, SubscribeReq
from reflow_tpu_torch.utils.config import env_float
from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["Subscriber"]

_POLL_S = 0.2
_SEQ = itertools.count()


class Subscriber:
    """One standing query tailed over the wire.

    Drive it with :meth:`pump` (one poll round-trip, long-polling up
    to ``wait_s`` server-side) or :meth:`wait_horizon`; read the
    reconstructed answer with :meth:`value` — it matches the pull path
    (`view_at`/`lookup`/`top_k`) exactly at :attr:`horizon`.
    """

    def __init__(self, transport: Transport, address, sink, *,
                 kind: str = "view", params: Sequence = (),
                 name: str = "subscriber", min_horizon: int = 0,
                 token: Optional[str] = None,
                 policy: Optional[ReconnectPolicy] = None,
                 io_timeout_s: Optional[float] = None) -> None:
        self.transport = transport
        self.address = address
        self.name = name
        self.query = canon_query(sink, kind, params)
        self.state = QueryState(self.query)
        self.min_horizon = min_horizon
        self.token = token if token is not None \
            else f"{name}-{os.getpid()}-{next(_SEQ)}"
        self.policy = policy if policy is not None \
            else ReconnectPolicy(name)
        self.io_timeout_s = (io_timeout_s if io_timeout_s is not None
                             else env_float("REFLOW_SUB_IO_TIMEOUT_S"))
        self._lock = named_lock("subs.client")
        self._conn: Optional[Conn] = None
        #: server's answer to the last handshake
        self.last_ack: Optional[SubAck] = None
        self.mode: Optional[str] = None
        #: server clock anchor from the last handshake (rtt_s /
        #: wall_offset_s added client-side) — post-mortem alignment
        self.anchor: Optional[dict] = None
        self.polls_total = 0
        self.heartbeats_total = 0
        self.handshakes_total = 0
        self.reconnects_total = 0
        self.link_failures = 0

    # -- read surface ----------------------------------------------------

    @property
    def horizon(self) -> int:
        return self.state.horizon

    def value(self):
        return self.state.value()

    @property
    def gaps_total(self) -> int:
        return self.state.gaps

    @property
    def dups_skipped_total(self) -> int:
        return self.state.dups_skipped

    @property
    def frames_applied_total(self) -> int:
        return self.state.applied

    @property
    def rebases_total(self) -> int:
        return self.state.rebases

    @property
    def conn_state(self) -> str:
        return self.policy.state

    # -- driving ---------------------------------------------------------

    def pump(self, wait_s: float = 0.0) -> int:
        """One pump: (re)dial + handshake if needed, then one poll.
        Returns frames that advanced state; 0 while the link is down
        (never raises for link trouble)."""
        deadline = time.perf_counter() + max(0.0, wait_s)
        while True:
            applied = None
            with self._lock:
                if self._ensure_link():
                    left = max(0.0, deadline - time.perf_counter())
                    applied = self._poll_once(left)
            if applied is not None:
                return applied
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return 0
            nap = max(self.policy.seconds_until_due(), 0.01)
            time.sleep(min(nap, remaining, _POLL_S))

    def wait_horizon(self, horizon: int, timeout_s: float = 10.0) -> bool:
        """Pump until the reconstructed view reaches ``horizon``."""
        deadline = time.perf_counter() + timeout_s
        while self.state.horizon < horizon:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return False
            self.pump(wait_s=min(remaining, _POLL_S))
        return True

    def retarget(self, address) -> None:
        """Point at a different endpoint (e.g. another replica). The
        cursor rides the next handshake, so the stream resumes or
        rebases there by the same rules."""
        with self._lock:
            self.address = address
            if self._conn is not None:
                self._conn.close()
                self._conn = None
            self.policy.failed()

    def close(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
            if conn is not None:
                try:
                    conn.send_msg(("sub_close", self.token),
                                  self.io_timeout_s)
                    conn.recv_msg(self.io_timeout_s)
                except TransportError:
                    pass  # best-effort: the hub reaps expired tokens
                conn.close()

    # -- link machinery --------------------------------------------------

    def _fail(self, err: Exception) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        self.link_failures += 1
        self.policy.failed()

    def _sub_req(self) -> SubscribeReq:
        return SubscribeReq(self.query.sink, self.query.kind,
                            self.query.params,
                            cursor=self.state.horizon,
                            min_horizon=self.min_horizon,
                            token=self.token)

    def _ensure_link(self) -> bool:
        """Dial + subscribe handshake if down and backoff allows.
        Caller holds the lock. True if live."""
        if self._conn is not None:
            return True
        if not self.policy.due():
            return False
        t0 = time.perf_counter()
        try:
            conn = self.transport.connect(self.address)
            conn.send_msg(("sub",) + tuple(self._sub_req()),
                          self.io_timeout_s)
            resp = conn.recv_msg(self.io_timeout_s)
        except TransportError as e:
            self._fail(e)
            if _trace.ENABLED:
                _trace.evt("net_reconnect", t0,
                           time.perf_counter() - t0,
                           track=f"subs/{self.name}",
                           args={"ok": False, "error": str(e)[:120],
                                 "state": self.policy.state})
            return False
        if not (isinstance(resp, tuple) and len(resp) >= 4
                and resp[0] == "ok"):
            conn.close()
            self._fail(TransportError(f"bad sub response {resp!r}"))
            return False
        recovered = self.policy.ok()
        if recovered:
            self.reconnects_total += 1
        self._conn = conn
        self._accept_ack(resp, rtt=time.perf_counter() - t0)
        if _trace.ENABLED:
            _trace.evt("net_reconnect", t0, time.perf_counter() - t0,
                       track=f"subs/{self.name}",
                       args={"ok": True, "recovered": recovered,
                             "mode": self.mode,
                             "cursor": self.state.horizon})
        return True

    def _roundtrip(self, msg: tuple):
        conn = self._conn
        if conn is None:
            return None
        try:
            conn.send_msg(msg, self.io_timeout_s)
            return conn.recv_msg(self.io_timeout_s)
        except TransportError as e:
            self._fail(e)
            return None

    def _rehandshake(self) -> bool:
        """Re-run the subscribe op on the live connection (after a
        ``gone`` or a detected gap). Caller holds the lock."""
        t0 = time.perf_counter()
        resp = self._roundtrip(("sub",) + tuple(self._sub_req()))
        if not (isinstance(resp, tuple) and len(resp) >= 4
                and resp[0] == "ok"):
            if self._conn is not None:
                self._fail(TransportError(f"bad sub response {resp!r}"))
            return False
        self._accept_ack(resp, rtt=time.perf_counter() - t0)
        return True

    def _accept_ack(self, resp: tuple, rtt: Optional[float] = None) -> None:
        """Record a successful handshake reply; parses the trailing
        clock anchor when the server sends one (older servers reply
        without it — both directions stay compatible)."""
        self.last_ack = SubAck(*resp[1:4])
        self.mode = self.last_ack.mode
        self.handshakes_total += 1
        if len(resp) >= 5 and isinstance(resp[4], dict):
            anchor = dict(resp[4])
            if rtt is not None:
                anchor["rtt_s"] = rtt
                anchor["wall_offset_s"] = anchor.get("wall", 0.0) - (
                    time.time() - rtt / 2.0)
            self.anchor = anchor

    def _poll_once(self, wait_s: float) -> Optional[int]:
        """One poll round-trip. Caller holds the lock. None on link
        failure (caller backs off), else frames applied."""
        # the server also caps; staying under the io timeout keeps the
        # long poll from looking like a dead link
        wait = min(wait_s, max(self.io_timeout_s / 2.0, 0.0))
        self.polls_total += 1
        resp = self._roundtrip(
            ("sub_poll", self.token, self.state.horizon, wait))
        if resp is None:
            return None
        if isinstance(resp, tuple) and resp and resp[0] == "gone":
            # expired while we were away (or the replica restarted):
            # re-register; the cursor decides resume-vs-snapshot
            self._rehandshake()
            return 0
        if not (isinstance(resp, tuple) and len(resp) == 3
                and resp[0] == "ok"):
            return 0
        frames = frames_from_wire(resp[1])
        horizon = resp[2]
        gaps_before = self.state.gaps
        applied = 0
        for frame in frames:
            t_apply = time.perf_counter()
            ok = self.state.apply(frame)
            if ok:
                applied += 1
            if _trace.ENABLED and ok and getattr(frame, "cause", None):
                # the last link of the write's chain: a sampled write
                # is now visible in this subscriber's local answer.
                _trace.evt("sub_deliver", t_apply,
                           time.perf_counter() - t_apply,
                           track=f"subs/{self.name}",
                           args={"from_h": frame.from_h,
                                 "to_h": frame.to_h,
                                 "causes": list(frame.cause)})
        self.state.note_horizon(horizon)
        if not frames:
            self.heartbeats_total += 1
        if self.state.gaps > gaps_before:
            # protocol violation (or a server that lost our outbox
            # without noticing): self-heal via snapshot rather than
            # serve values we can't prove. Drop the server-side sub
            # first so the cursor rules — not the suspect outbox —
            # decide what comes next.
            self._roundtrip(("sub_close", self.token))
            self._rehandshake()
        return applied
