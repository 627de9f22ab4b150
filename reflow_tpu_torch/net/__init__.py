"""Replication and ingestion over the wire: framed transports, the
fault injector, and the shipping protocol's two wire endpoints.

The port's copy of ``reflow_tpu.net``. Layers, bottom up:

- ``framing`` — one message = one CRC-protected, magic-prefixed frame.
- ``transport`` — :class:`TcpTransport` (real sockets) and
  :class:`LoopbackTransport` (in-process twin, same bytes) behind one
  ``Conn``/``Listener``/``Transport`` surface.
- ``faults`` — :class:`FaultyTransport` composes over any transport
  and injects drop/delay/duplicate/reorder/corrupt/partition/reset
  from a seeded :class:`~reflow_tpu_torch.utils.faults.WireFaults`
  schedule.
- ``backoff`` — :class:`ReconnectPolicy`, the per-link
  connect → healthy → degraded → unreachable state machine.
- ``client`` / ``server`` — :class:`RemoteFollower` (what a
  ``SegmentShipper`` attaches) and :class:`ReplicaServer` (what a
  ``ReplicaScheduler`` sits behind).
"""

from reflow_tpu_torch.net.backoff import (ReconnectPolicy, STATE_CONNECTING,
                                          STATE_DEGRADED, STATE_HEALTHY,
                                          STATE_UNREACHABLE)
from reflow_tpu_torch.net.client import RemoteFollower
from reflow_tpu_torch.net.faults import FaultyConn, FaultyTransport
from reflow_tpu_torch.net.framing import (FrameError, TransportError,
                                          WireTimeout, decode_frame,
                                          encode_frame)
from reflow_tpu_torch.net.server import ReplicaServer
from reflow_tpu_torch.net.transport import (Conn, Listener,
                                            LoopbackTransport, TcpTransport,
                                            Transport)

__all__ = [
    "Conn", "Listener", "Transport", "LoopbackTransport", "TcpTransport",
    "FaultyConn", "FaultyTransport",
    "ReconnectPolicy", "STATE_CONNECTING", "STATE_HEALTHY",
    "STATE_DEGRADED", "STATE_UNREACHABLE",
    "RemoteFollower", "ReplicaServer",
    "FrameError", "TransportError", "WireTimeout",
    "encode_frame", "decode_frame",
]
