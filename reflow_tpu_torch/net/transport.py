"""Framed-message transports: real TCP and an in-process loopback twin.

The port's copy of ``reflow_tpu/net/transport.py``; it moves the same frames.

Both speak the same protocol surface — :class:`Conn` (``send_msg`` /
``recv_msg`` / ``close``), :class:`Listener` (``accept``), and a
:class:`Transport` factory (``listen`` / ``connect``) — and both move
*the same framed bytes* (``net/framing.py``): the loopback twin
serializes every message through ``encode_frame`` into a byte buffer
and re-parses it on the far side, so a frame-level fault (a flipped
byte, a truncated tail) corrupts identically on either transport and
the protocol test matrix runs verbatim against both.

Timeouts are mandatory. Every blocking operation takes an explicit
timeout and raises :class:`~reflow_tpu_torch.net.framing.TransportError` when
it expires — there is no infinite wait anywhere in this module.
Defaults come from the ``REFLOW_NET_*`` knobs (docs/guide.md
"Environment knobs").

Use :class:`LoopbackTransport` for hermetic tests and single-process
benches; :class:`TcpTransport` to put replicas in other processes or on
other hosts. ``serve/replica.py`` objects never see either — they sit
behind a :class:`~reflow_tpu_torch.net.server.ReplicaServer` and in front of
a :class:`~reflow_tpu_torch.net.client.RemoteFollower`, which are
transport-agnostic.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Dict, Optional, Tuple

from reflow_tpu_torch.net.framing import (HEADER, MAGIC, FrameError,
                                          TransportError, WireTimeout,
                                          decode_frame, encode_frame,
                                          frame_size)
from reflow_tpu_torch.utils.config import env_float
from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["Conn", "Listener", "Transport", "LoopbackTransport",
           "TcpTransport", "default_io_timeout_s"]

_HDR = len(MAGIC) + HEADER.size


def default_io_timeout_s() -> float:
    """The per-operation send/recv timeout (REFLOW_NET_IO_TIMEOUT_S)."""
    return env_float("REFLOW_NET_IO_TIMEOUT_S")


class Conn:
    """One framed-message connection. ``send_msg`` frames and writes;
    ``recv_msg`` blocks up to ``timeout_s`` for a frame to start, and
    returns it whole (over TCP the rest of a started frame gets the I/O
    timeout). Both
    raise :class:`TransportError` on link death and ``recv_msg`` raises
    :class:`FrameError` (a subclass) on an unsyncable stream."""

    def send_msg(self, obj: Any, timeout_s: Optional[float] = None) -> int:
        raise NotImplementedError

    def send_raw(self, data: bytes,
                 timeout_s: Optional[float] = None) -> int:
        """Write pre-framed (possibly deliberately mangled) bytes —
        the fault injector's corruption seam."""
        raise NotImplementedError

    def recv_msg(self, timeout_s: Optional[float] = None) -> Any:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def alive(self) -> bool:
        raise NotImplementedError


class Listener:
    def accept(self, timeout_s: Optional[float] = None) -> Conn:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def address(self):
        raise NotImplementedError


class Transport:
    """Factory pair: ``listen()`` binds a server endpoint, ``connect``
    dials one. Addresses are opaque tokens minted by ``listen``."""

    def listen(self) -> Listener:
        raise NotImplementedError

    def connect(self, address, timeout_s: Optional[float] = None) -> Conn:
        raise NotImplementedError


# -- loopback ---------------------------------------------------------------

class _LoopbackEnd(Conn):
    """One direction pair of an in-process connection: bytes land in
    the peer's buffer under the peer's condition. The framing layer is
    NOT bypassed — every message round-trips through encode/decode so
    corruption faults behave exactly as on a socket."""

    def __init__(self) -> None:
        self._cond = threading.Condition(
            named_lock("net.loopback.conn"))
        self._rx = bytearray()
        self._closed = False
        self.peer: Optional["_LoopbackEnd"] = None

    def send_msg(self, obj: Any, timeout_s: Optional[float] = None) -> int:
        return self.send_raw(encode_frame(obj), timeout_s)

    def send_raw(self, data: bytes,
                 timeout_s: Optional[float] = None) -> int:
        peer = self.peer
        if peer is None or self._closed:
            raise TransportError("send on a closed loopback connection")
        with peer._cond:
            if peer._closed:
                raise TransportError("peer closed the loopback "
                                     "connection")
            peer._rx += data
            peer._cond.notify_all()
        return len(data)

    def recv_msg(self, timeout_s: Optional[float] = None) -> Any:
        timeout_s = default_io_timeout_s() if timeout_s is None \
            else timeout_s
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                got = self._try_parse_locked()
                if got is not None:
                    return got[0]
                if self._closed:
                    raise TransportError("loopback connection closed")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise WireTimeout(
                        f"recv timed out after {timeout_s}s")
                self._cond.wait(left)

    def _try_parse_locked(self):
        if len(self._rx) < _HDR:
            return None
        length = frame_size(bytes(self._rx[:_HDR]))  # FrameError -> up
        if len(self._rx) < _HDR + length:
            return None
        hdr = bytes(self._rx[:_HDR])
        payload = bytes(self._rx[_HDR:_HDR + length])
        del self._rx[:_HDR + length]
        return (decode_frame(hdr, payload),)

    def close(self) -> None:
        for end in (self, self.peer):
            if end is None:
                continue
            with end._cond:
                end._closed = True
                end._cond.notify_all()

    @property
    def alive(self) -> bool:
        return not self._closed


class _LoopbackListener(Listener):
    def __init__(self, transport: "LoopbackTransport", address: str) -> None:
        self._transport = transport
        self._address = address
        self._cond = threading.Condition(
            named_lock("net.loopback.listener"))
        self._pending: list = []
        self._closed = False

    def accept(self, timeout_s: Optional[float] = None) -> Conn:
        timeout_s = default_io_timeout_s() if timeout_s is None \
            else timeout_s
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not self._pending:
                if self._closed:
                    raise TransportError("listener closed")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise WireTimeout(
                        f"accept timed out after {timeout_s}s")
                self._cond.wait(left)
            return self._pending.pop(0)

    def _offer(self, server_end: _LoopbackEnd) -> None:
        with self._cond:
            if self._closed:
                raise TransportError(
                    f"connection refused: {self._address} is closed")
            self._pending.append(server_end)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._transport._unbind(self._address)

    @property
    def address(self) -> str:
        return self._address


class LoopbackTransport(Transport):
    """The in-process twin: same framing, same protocol, no kernel.
    One instance is a private little network — listeners bind
    ``loopback:<n>`` addresses on it and ``connect`` dials them."""

    def __init__(self) -> None:
        self._lock = named_lock("net.loopback.transport")
        self._listeners: Dict[str, _LoopbackListener] = {}
        self._next = 0

    def listen(self) -> Listener:
        with self._lock:
            addr = f"loopback:{self._next}"
            self._next += 1
            lst = _LoopbackListener(self, addr)
            self._listeners[addr] = lst
        return lst

    def _unbind(self, address: str) -> None:
        with self._lock:
            self._listeners.pop(address, None)

    def connect(self, address, timeout_s: Optional[float] = None) -> Conn:
        with self._lock:
            lst = self._listeners.get(address)
        if lst is None:
            raise TransportError(f"connection refused: no listener at "
                                 f"{address!r}")
        client, server = _LoopbackEnd(), _LoopbackEnd()
        client.peer, server.peer = server, client
        lst._offer(server)
        return client


# -- TCP --------------------------------------------------------------------

class _TcpConn(Conn):
    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._closed = False
        # one writer/reader at a time per side; the protocol is
        # request-response so this never contends in steady state
        self._send_lock = named_lock("net.tcp.send")
        self._recv_lock = named_lock("net.tcp.recv")
        self._sock.settimeout(default_io_timeout_s())

    def send_msg(self, obj: Any, timeout_s: Optional[float] = None) -> int:
        return self.send_raw(encode_frame(obj), timeout_s)

    def send_raw(self, data: bytes,
                 timeout_s: Optional[float] = None) -> int:
        with self._send_lock:
            if self._closed:
                raise TransportError("send on a closed TCP connection")
            try:
                self._sock.settimeout(
                    default_io_timeout_s() if timeout_s is None
                    else timeout_s)
                self._sock.sendall(data)
            except (OSError, ValueError) as e:
                raise TransportError(f"TCP send failed: {e}") from e
        return len(data)

    def _read_exact(self, n: int, deadline: float,
                    idle_ok: bool = False) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TransportError("recv timed out mid-frame")
            try:
                self._sock.settimeout(left)
                chunk = self._sock.recv(n - len(buf))
            except socket.timeout as e:
                # a timeout before ANY byte of the frame arrived leaves
                # the stream synced (idle); one mid-frame does not
                if idle_ok and not buf:
                    raise WireTimeout(f"recv timed out: {e}") from e
                raise TransportError(
                    f"recv timed out mid-frame: {e}") from e
            except OSError as e:
                raise TransportError(f"TCP recv failed: {e}") from e
            if not chunk:
                raise TransportError("connection closed by peer")
            buf += chunk
        return bytes(buf)

    def recv_msg(self, timeout_s: Optional[float] = None) -> Any:
        timeout_s = default_io_timeout_s() if timeout_s is None \
            else timeout_s
        with self._recv_lock:
            if self._closed:
                raise TransportError("recv on a closed TCP connection")
            deadline = time.monotonic() + timeout_s
            hdr = self._read_exact(_HDR, deadline, idle_ok=True)
            length = frame_size(hdr)  # FrameError propagates: reset
            # ``timeout_s`` bounds the wait for a frame to START (a
            # server's short poll slice); once its header is in, the rest
            # gets the I/O timeout, so a large frame is not cut off
            # mid-transfer by the idle poll (the JAX transport reads the
            # payload under the poll's deadline and resets the link)
            deadline = max(deadline,
                           time.monotonic() + default_io_timeout_s())
            payload = self._read_exact(length, deadline)
        return decode_frame(hdr, payload)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def alive(self) -> bool:
        return not self._closed


class _TcpListener(Listener):
    def __init__(self, host: str, port: int) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._closed = False

    def accept(self, timeout_s: Optional[float] = None) -> Conn:
        if self._closed:
            raise TransportError("listener closed")
        try:
            self._sock.settimeout(
                default_io_timeout_s() if timeout_s is None
                else timeout_s)
            sock, _peer = self._sock.accept()
        except socket.timeout as e:
            raise WireTimeout(f"accept timed out: {e}") from e
        except OSError as e:
            raise TransportError(f"accept failed: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return _TcpConn(sock)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def address(self) -> Tuple[str, int]:
        return self._sock.getsockname()


class TcpTransport(Transport):
    """Real sockets on ``host``. ``listen`` binds ``port`` — default 0,
    i.e. the OS assigns an ephemeral port and ``Listener.address``
    reports the ``(host, port)`` actually bound. Servers built on this
    (``ReplicaServer`` / ``RpcIngestServer`` / ``TelemetryServer``)
    therefore never need a pre-picked port: start one, read
    ``.address``, hand it to whoever dials — which is what lets the
    process harness spawn children in parallel without collisions.
    Pass an explicit ``port`` only to pin a deployment-known endpoint.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port

    def listen(self) -> Listener:
        return _TcpListener(self.host, self.port)

    def connect(self, address, timeout_s: Optional[float] = None) -> Conn:
        timeout_s = env_float("REFLOW_NET_CONNECT_TIMEOUT_S") \
            if timeout_s is None else timeout_s
        try:
            sock = socket.create_connection(tuple(address),
                                            timeout=timeout_s)
        except OSError as e:
            raise TransportError(f"connect to {address} failed: {e}") \
                from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return _TcpConn(sock)
