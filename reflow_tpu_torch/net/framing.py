"""Wire framing for the replication transport (docs/guide.md
"Replication over the wire").

The port's copy of ``reflow_tpu/net/framing.py``, byte for byte on the
wire: a frame either package encodes, the other decodes. A host
:class:`~reflow_tpu_torch.delta.DeltaBatch` (an ingestion RPC's payload)
is pickled under the wire name the JAX package's frames give it,
``reflow_tpu.delta.DeltaBatch``, and that name decodes to the port's
class: the same request makes the same frame in both packages, and
neither end needs the other package to read it. A torch tensor never
crosses the wire (it would unpickle onto a card at the other end); the
encoder refuses one.

One message = one length-prefixed, CRC-protected frame::

    RFNET001 | <u32 payload_len> <u32 crc32(payload)> | payload

The 8-byte magic rides on EVERY frame (not once per stream like the
WAL's segment magic) so a desynchronized byte stream is detected at the
next frame boundary instead of being misparsed as a plausible length.
The payload is a pickled tuple ``(op, *args)`` — the same stance the
WAL takes on disk: pickling is the project's record codec, and both
ends re-verify the CRC before trusting a byte of it.

Shipping-protocol payloads (:class:`~reflow_tpu_torch.wal.ship.Shipment` and
friends) are flattened to plain tuples by ``encode_msg`` and rebuilt by
the endpoint, so the wire never depends on NamedTuple class identity
across processes.

Everything here raises :class:`FrameError` for malformed bytes (a
corrupt or truncated frame — the connection is unsyncable past it) and
:class:`TransportError` for link-level failures (reset, timeout,
refused). Callers treat FrameError as grounds for a reset: with a
length-prefixed stream there is no way to find the next frame after a
bad header.
"""

from __future__ import annotations

import io
import pickle
import struct
import zlib
from typing import Any, Tuple

from reflow_tpu_torch.delta import DeltaBatch

__all__ = ["FrameError", "TransportError", "WireTimeout", "MAGIC",
           "HEADER", "MAX_FRAME", "encode_frame", "decode_frame",
           "frame_size", "split_frames"]

MAGIC = b"RFNET001"
HEADER = struct.Struct("<II")  # payload_len, crc32(payload)
#: sanity bound mirroring wal.log._MAX_RECORD: a corrupted length
#: prefix must not convince a receiver to buffer gigabytes
MAX_FRAME = 64 << 20


class TransportError(RuntimeError):
    """Link-level failure: connection refused / reset / timed out /
    closed under us. Retryable — the reconnect state machine's input."""


class WireTimeout(TransportError):
    """A blocking wire call ran out its deadline with the link still
    up. Servers treat this as 'idle, keep waiting'; clients treat it
    like any other TransportError (fail, back off, reconnect)."""


class FrameError(TransportError):
    """Malformed frame (bad magic, implausible length, CRC mismatch,
    unpicklable payload). NOT retryable on the same connection: a
    length-prefixed stream cannot re-synchronize past a bad header, so
    the only safe response is a reset."""


#: wire name of each class that crosses the wire under a name of its
#: own: the port's host batch travels as the JAX package's
_WIRE_NAMES = {DeltaBatch: ("reflow_tpu.delta", "DeltaBatch")}
_FROM_WIRE = {name: cls for cls, name in _WIRE_NAMES.items()}


class _WirePickler(pickle._Pickler):
    """The standard pickler (pure-Python, which writes the same bytes as
    ``pickle.dumps``) with two changes: a class of :data:`_WIRE_NAMES`
    is written under its wire name, and a torch tensor is refused."""

    def reducer_override(self, obj):
        if type(obj).__module__.partition(".")[0] == "torch":
            raise FrameError(
                f"a {type(obj).__name__} cannot cross the wire; send "
                f"host numpy arrays")
        return NotImplemented

    def save_global(self, obj, name=None):
        wire = _WIRE_NAMES.get(obj)
        if wire is None or self.proto < 4:
            return super().save_global(obj, name)
        self.save(wire[0])
        self.save(wire[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _WireUnpickler(pickle.Unpickler):
    """``pickle.loads`` that resolves a wire name to the port's class."""

    def find_class(self, module, name):
        cls = _FROM_WIRE.get((module, name))
        return cls if cls is not None else super().find_class(module, name)


def _dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _WirePickler(buf, pickle.DEFAULT_PROTOCOL).dump(obj)
    return buf.getvalue()


def encode_frame(obj: Any) -> bytes:
    """Pickle ``obj`` and wrap it in one framed message."""
    payload = _dumps(obj)
    if len(payload) > MAX_FRAME:
        raise FrameError(f"message of {len(payload)} bytes exceeds the "
                         f"{MAX_FRAME}-byte frame bound")
    return MAGIC + HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def frame_size(header: bytes) -> int:
    """Payload length promised by a ``MAGIC + HEADER`` prefix (the
    receiver reads exactly this many more bytes). Raises
    :class:`FrameError` on bad magic or an implausible length."""
    if len(header) < len(MAGIC) + HEADER.size:
        raise FrameError(f"short frame header ({len(header)} bytes)")
    if header[:len(MAGIC)] != MAGIC:
        raise FrameError(f"bad frame magic {header[:len(MAGIC)]!r}")
    length, _crc = HEADER.unpack_from(header, len(MAGIC))
    if length > MAX_FRAME:
        raise FrameError(f"implausible frame length {length}")
    return length


def decode_frame(header: bytes, payload: bytes) -> Any:
    """Verify and unpickle one frame's payload against its header."""
    length = frame_size(header)
    _len, crc = HEADER.unpack_from(header, len(MAGIC))
    if len(payload) != length:
        raise FrameError(f"truncated frame payload "
                         f"({len(payload)}/{length} bytes)")
    if zlib.crc32(payload) != crc:
        raise FrameError("frame CRC mismatch")
    try:
        return _WireUnpickler(io.BytesIO(payload)).load()
    except Exception as e:  # noqa: BLE001 - framed yet unloadable
        raise FrameError(f"unpicklable frame payload ({e})") from e


def split_frames(data: bytes) -> Tuple[list, int]:
    """Walk ``data`` as a run of frames; returns ``(messages,
    consumed)`` where ``consumed < len(data)`` means the tail is an
    incomplete frame (more bytes needed). Raises :class:`FrameError`
    on a malformed complete frame. Loopback conns use this; TCP conns
    read frame-at-a-time off the socket."""
    msgs = []
    off = 0
    hdr = len(MAGIC) + HEADER.size
    while len(data) - off >= hdr:
        length = frame_size(data[off:off + hdr])
        if len(data) - off - hdr < length:
            break
        msgs.append(decode_frame(data[off:off + hdr],
                                 data[off + hdr:off + hdr + length]))
        off += hdr + length
    return msgs, off
