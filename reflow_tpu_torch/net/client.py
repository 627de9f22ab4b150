"""RemoteFollower: the shipper's wire-side view of one replica.

The port's copy of ``reflow_tpu/net/client.py``; it moves the same frames.

Duck-types the follower surface :class:`~reflow_tpu_torch.wal.ship
.SegmentShipper` expects (``subscribe`` / ``bootstrap`` / ``receive``
/ ``name``) over a framed transport connection, and owns the whole
unreliable-link lifecycle so the shipper never sees a socket:

- **Link failures return ``None``** from :meth:`receive` — "no
  progress this pass", categorically different from a protocol
  :class:`ShipNack` (which is the *replica* speaking). The shipper
  skips the follower and retries on its own cadence; NACK counters
  never inflate from weather.
- **Reconnect is a state machine**, not a loop:
  :class:`~reflow_tpu_torch.net.backoff.ReconnectPolicy` (connect → healthy
  → degraded → unreachable) gates every attempt with capped
  exponential backoff + seeded jitter. While a backoff window is open,
  calls return ``None`` immediately — a stalled link never blocks the
  pump thread.
- **Re-handshake after reset is idempotent**: the first exchange on a
  fresh connection is always ``subscribe()``, whose answer is the
  replica's authoritative persisted cursor. :meth:`receive` surfaces
  that as ``ShipNack(cursor, "reconnected: resync")`` so the shipper
  adopts it and re-reads from disk (the WAL is the retransmit buffer)
  instead of blindly resending a chunk the replica may have already
  durably applied (the ack-lost case).

Every roundtrip emits a ``net_send`` trace span and every recovery a
``net_reconnect`` span (``tools/trace_inspect.py`` folds both into its
network section).
"""

from __future__ import annotations

import time
from typing import Any, Optional, Tuple

from reflow_tpu_torch.net.backoff import ReconnectPolicy
from reflow_tpu_torch.net.framing import TransportError
from reflow_tpu_torch.net.transport import Conn, Transport
from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.wal.ship import ShipAck, Shipment, ShipNack

__all__ = ["RemoteFollower"]


class RemoteFollower:
    """One replica endpoint as seen from the shipping leader."""

    def __init__(self, transport: Transport, address, *,
                 name: str = "remote", policy: Optional[ReconnectPolicy]
                 = None, io_timeout_s: Optional[float] = None) -> None:
        self.transport = transport
        self.address = address
        self.name = name
        self.policy = policy if policy is not None \
            else ReconnectPolicy(name)
        self.io_timeout_s = io_timeout_s
        self._conn: Optional[Conn] = None
        self.reconnects_total = 0      # successful re-dials after loss
        self.link_failures = 0
        #: replica's clock anchor from the last subscribe handshake
        #: (``obs.wire.clock_anchor`` + rtt_s / wall_offset_s), when the
        #: server sends one; display-only — never used for ordering
        self.anchor: Optional[dict] = None

    # -- connection state (read by ship.py / read.py / wal_inspect) ----

    @property
    def conn_state(self) -> str:
        return self.policy.state

    @property
    def last_backoff_s(self) -> float:
        return self.policy.last_backoff_s

    def transport_snapshot(self) -> dict:
        snap = self.policy.snapshot()
        snap["address"] = str(self.address)
        return snap

    # -- link machinery ------------------------------------------------

    def _fail(self, err: Exception) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        self.link_failures += 1
        self.policy.failed()

    def _dial(self) -> Optional[Tuple[int, int]]:
        """Dial + handshake: returns the replica's authoritative cursor
        (or None-cursor for a fresh replica) on success; raises
        :class:`TransportError` on failure. On return ``self._conn``
        is live and subscribed."""
        conn = self.transport.connect(self.address)
        t0 = time.monotonic()
        try:
            conn.send_msg(("subscribe",), self.io_timeout_s)
            resp = conn.recv_msg(self.io_timeout_s)
        except TransportError:
            conn.close()
            raise
        rtt = time.monotonic() - t0
        if not (isinstance(resp, tuple) and len(resp) >= 2
                and resp[0] == "ok"):
            conn.close()
            raise TransportError(f"bad subscribe response {resp!r}")
        if len(resp) >= 3 and isinstance(resp[2], dict):
            # pre-anchor servers answer a 2-tuple; newer ones piggyback
            # a clock anchor so trace consumers can display this
            # replica's monotonic timestamps on the leader's wall axis
            # (error bounded by rtt/2 — never used for ordering)
            anchor = dict(resp[2])
            anchor["rtt_s"] = rtt
            anchor["wall_offset_s"] = anchor.get("wall", 0.0) - \
                (time.time() - rtt / 2.0)
            self.anchor = anchor
        self._conn = conn
        return resp[1] if resp[1] is None else tuple(resp[1])

    def _roundtrip(self, msg: tuple,
                   cause: Optional[str] = None) -> Any:
        """One request-response on the live connection. Returns the
        reply, or None on a link failure (connection closed, backoff
        scheduled). ``cause`` is echoed into the ``net_send`` span so
        the hop joins its shipment's cross-process causal chain."""
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
                        "error": str(e)[:120],
                        "state": self.policy.state}
                if cause is not None:
                    args["cause"] = cause
                _trace.evt("net_send", t0, time.perf_counter() - t0,
                           track=f"net/{self.name}", args=args)
            return None
        self.policy.ok()
        if _trace.ENABLED:
            args = {"op": msg[0], "ok": True}
            if cause is not None:
                args["cause"] = cause
            _trace.evt("net_send", t0, time.perf_counter() - t0,
                       track=f"net/{self.name}", args=args)
        return resp

    def _reconnect(self) -> Optional[Tuple[Optional[Tuple[int, int]]]]:
        """One gated reconnect attempt. Returns a 1-tuple holding the
        subscribe cursor on success (so a None cursor is distinguishable
        from 'attempt failed' = None)."""
        if not self.policy.due():
            return None
        t0 = time.perf_counter()
        try:
            cursor = self._dial()
        except TransportError as e:
            self._fail(e)
            if _trace.ENABLED:
                _trace.evt("net_reconnect", t0,
                           time.perf_counter() - t0,
                           track=f"net/{self.name}",
                           args={"ok": False, "error": str(e)[:120],
                                 "state": self.policy.state,
                                 "backoff_s": self.policy.last_backoff_s})
            return None
        recovered = self.policy.ok()
        if recovered:
            self.reconnects_total += 1
        if _trace.ENABLED:
            _trace.evt("net_reconnect", t0, time.perf_counter() - t0,
                       track=f"net/{self.name}",
                       args={"ok": True, "recovered": recovered})
        return (cursor,)

    # -- the follower surface ship.py drives ---------------------------

    def subscribe(self) -> Optional[Tuple[int, int]]:
        """The replica's persisted cursor. Called by ``attach()`` at
        wiring time — a dead link here raises so the operator sees the
        misconfiguration instead of a silently idle follower."""
        if self._conn is None:
            got = self._reconnect()
            if got is None:
                raise TransportError(
                    f"{self.name}: cannot reach {self.address} "
                    f"(state={self.policy.state})")
            return got[0]
        resp = self._roundtrip(("subscribe",))
        if resp is None:
            raise TransportError(f"{self.name}: subscribe failed "
                                 f"(state={self.policy.state})")
        if not (isinstance(resp, tuple) and resp[0] == "ok"):
            raise TransportError(f"bad subscribe response {resp!r}")
        return resp[1] if resp[1] is None else tuple(resp[1])

    def bootstrap(self, ckpt_dir: str) -> Tuple[int, int]:
        resp = self._roundtrip(("bootstrap", ckpt_dir))
        if resp is None:
            raise TransportError(f"{self.name}: bootstrap failed "
                                 f"(state={self.policy.state})")
        if not (isinstance(resp, tuple) and resp[0] == "ok"):
            raise TransportError(f"bootstrap rejected: {resp!r}")
        return tuple(resp[1])

    def receive(self, sh: Shipment):
        """Ship one chunk. Returns :class:`ShipAck` / :class:`ShipNack`
        from the replica, or ``None`` for "no progress" (link down,
        backoff window open, or failed mid-exchange)."""
        if self._conn is None:
            got = self._reconnect()
            if got is None:
                return None
            # fresh link: hand the shipper the replica's authoritative
            # cursor instead of guessing whether our last chunk landed
            return ShipNack(got[0], "reconnected: resync")
        fields = tuple(sh)
        if fields and fields[-1] is None:
            # unstamped shipment: drop the trailing None cause so the
            # wire frame stays byte-identical to the pre-trace protocol
            fields = fields[:-1]
        resp = self._roundtrip(("receive",) + fields, cause=sh.cause)
        if resp is None:
            return None
        if isinstance(resp, tuple) and resp and resp[0] == "ack":
            return ShipAck(tuple(resp[1]), resp[2])
        if isinstance(resp, tuple) and resp and resp[0] == "nack":
            cur = tuple(resp[1]) if resp[1] is not None else None
            return ShipNack(cur, resp[2])
        # ("err", ...) or garbage: treat as link trouble, force rescync
        self._fail(TransportError(f"bad receive response {resp!r}"))
        return None

    def ping(self) -> Optional[dict]:
        """Replica liveness + horizon probe; None when unreachable."""
        if self._conn is None:
            got = self._reconnect()
            if got is None:
                return None
        resp = self._roundtrip(("ping",))
        if isinstance(resp, tuple) and len(resp) == 2 \
                and resp[0] == "ok":
            return resp[1]
        return None

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
