"""FaultyTransport: deterministic wire chaos over any transport.

The port's copy of ``reflow_tpu/net/faults.py``; it moves the same frames.

Wraps a :class:`~reflow_tpu_torch.net.transport.Transport` and injects the
faults a real network has — drop, delay, duplicate, reorder,
truncate/corrupt, one-way partition, connection reset — from a seeded
:class:`~reflow_tpu_torch.utils.faults.WireFaults` schedule (the policy
object; this module is only the mechanism). Injection happens
client-side at message granularity, so the exact same chaos plays out
over :class:`LoopbackTransport` and :class:`TcpTransport`.

How each fault maps onto a strict request-response stream:

- **drop (c2s)** — the request never transmits; the caller sees a
  :class:`TransportError` as a timeout would deliver one, just without
  burning the real timeout.
- **drop (s2c)** — the request transmits (the server APPLIES it), the
  response is read off the wire and discarded to keep the stream
  frame-synced, then the caller gets a :class:`TransportError`. This is
  the ack-lost case that forces a duplicate retransmission.
- **duplicate** — the framed request is written twice; the extra
  response is drained on a later receive so pairing never skews.
- **reorder** — the previous request is retransmitted *before* the
  current one (out-of-order duplicate delivery, the only reordering a
  windowless request-response protocol can observe); the extra response
  is drained like a duplicate's.
- **corrupt (frame)** — one seeded bit of the framed bytes flips in
  flight; the receiver's frame CRC (or magic check) fails and the
  connection resets.
- **corrupt (payload)** — one seeded bit flips inside the message's
  embedded WAL bytes *before* framing, so the frame verifies but the
  replica's record-CRC check NACKs the shipment whole — the deep
  end-to-end integrity path.
- **partition** — scripted, directional: ``c2s`` makes requests (and
  new dials) vanish; ``s2c`` lets requests through but eats responses.
- **reset** — the connection is closed under the caller mid-exchange.

Response-pairing safety: a drained or mis-paired response can only be a
``ShipAck``/``ShipNack``, and both carry the receiver's *authoritative*
cursor at response time — adopting one is always safe, which is why
the shipping protocol tolerates this whole menu without sequence
numbers.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from reflow_tpu_torch.net.framing import TransportError, encode_frame
from reflow_tpu_torch.net.transport import (Conn, Listener, Transport,
                                            default_io_timeout_s)
from reflow_tpu_torch.utils.faults import WireFaults

__all__ = ["FaultyTransport", "FaultyConn"]

#: cap on a single injected delay so a hostile schedule cannot wedge a
#: pump thread past its link timeout
_MAX_DELAY_S = 0.25


def _flip_payload_bytes(faults: WireFaults, msg: Any) -> Optional[Any]:
    """Flip one bit inside the largest bytes field of a message tuple
    (the shipped WAL chunk). Returns the mangled message, or None when
    the message carries no meaningful byte payload."""
    if not isinstance(msg, tuple):
        return None
    best, best_i = None, -1
    for i, v in enumerate(msg):
        if isinstance(v, (bytes, bytearray)) and len(v) >= 16:
            if best is None or len(v) > len(best):
                best, best_i = v, i
    if best is None:
        return None
    out = list(msg)
    out[best_i] = faults.flip(bytes(best))
    return tuple(out)


class FaultyConn(Conn):
    """One chaotic connection: consults the :class:`WireFaults`
    schedule on every message. Client-side only — servers always get a
    clean conn and the chaos happens on the way in/out of it."""

    def __init__(self, inner: Conn, faults: WireFaults) -> None:
        self._inner = inner
        self._faults = faults
        self._stale = 0          # extra responses to drain (dup/reorder)
        self._eat_response = False   # s2c drop: discard the next one
        self._last_frame: Optional[bytes] = None

    def send_msg(self, obj: Any, timeout_s: Optional[float] = None) -> int:
        f = self._faults
        if f.take_scripted_reset():
            self._inner.close()
            raise TransportError("injected: connection reset")
        if f.is_partitioned("c2s"):
            f.count_partitioned()
            raise TransportError("injected: partitioned (c2s)")
        d = f.delay_roll()
        if d > 0.0:
            time.sleep(min(d, _MAX_DELAY_S))
        roll = f.decide()
        if roll == "drop_c2s":
            return 0  # vanished in flight; the recv will time out fast
        if roll == "reset":
            self._inner.close()
            raise TransportError("injected: connection reset")
        if roll == "corrupt_frame":
            frame = f.flip(encode_frame(obj))
            self._last_frame = None
            return self._inner.send_raw(frame, timeout_s)
        if roll == "corrupt_payload":
            mangled = _flip_payload_bytes(f, obj)
            if mangled is None:  # nothing to corrupt deeply: hit frame
                frame = f.flip(encode_frame(obj))
                self._last_frame = None
                return self._inner.send_raw(frame, timeout_s)
            frame = encode_frame(mangled)
            self._last_frame = frame
            return self._inner.send_raw(frame, timeout_s)
        frame = encode_frame(obj)
        n = 0
        if roll == "reorder" and self._last_frame is not None:
            n += self._inner.send_raw(self._last_frame, timeout_s)
            self._stale += 1
        n += self._inner.send_raw(frame, timeout_s)
        if roll == "dup":
            n += self._inner.send_raw(frame, timeout_s)
            self._stale += 1
        if roll == "drop_s2c":
            self._eat_response = True
        self._last_frame = frame
        return n

    def send_raw(self, data: bytes,
                 timeout_s: Optional[float] = None) -> int:
        return self._inner.send_raw(data, timeout_s)

    def recv_msg(self, timeout_s: Optional[float] = None) -> Any:
        timeout_s = default_io_timeout_s() if timeout_s is None \
            else timeout_s
        while self._stale > 0:
            self._stale -= 1
            self._inner.recv_msg(timeout_s)  # drain; pairing stays 1:1
        if self._faults.is_partitioned("s2c"):
            self._faults.count_partitioned()
            # the server DID apply; eat its answer to stay frame-synced
            try:
                self._inner.recv_msg(timeout_s)
            except TransportError:
                pass
            raise TransportError("injected: partitioned (s2c)")
        if self._eat_response:
            self._eat_response = False
            try:
                self._inner.recv_msg(timeout_s)
            except TransportError:
                pass
            raise TransportError("injected: response dropped (s2c)")
        return self._inner.recv_msg(timeout_s)

    def close(self) -> None:
        self._inner.close()

    @property
    def alive(self) -> bool:
        return self._inner.alive


class FaultyTransport(Transport):
    """Compose chaos over any transport: ``connect`` wraps the dialed
    conn in a :class:`FaultyConn`; ``listen`` passes through untouched
    (injection is single-ended by design — double-ending would square
    every probability)."""

    def __init__(self, inner: Transport, faults: WireFaults) -> None:
        self.inner = inner
        self.faults = faults

    def listen(self) -> Listener:
        return self.inner.listen()

    def connect(self, address, timeout_s: Optional[float] = None) -> Conn:
        if self.faults.is_partitioned("c2s"):
            self.faults.count_partitioned()
            raise TransportError("injected: partitioned (c2s, dial)")
        if self.faults.take_scripted_reset():
            raise TransportError("injected: connection refused (reset)")
        return FaultyConn(self.inner.connect(address, timeout_s),
                          self.faults)
