"""Replication over the wire: the framing layer.

The port's copy of ``reflow_tpu.net`` holds, so far, ``framing`` (one
message = one CRC-protected, magic-prefixed frame, and the transport
errors the read tier and the shipping endpoints raise). The transports,
the fault injector, the reconnect policy and the two wire endpoints
(``RemoteFollower``, ``ReplicaServer``) come with the ``net/`` slice
(ROADMAP Queue 1 step 9).
"""

from reflow_tpu_torch.net.framing import (FrameError, TransportError,
                                          WireTimeout, decode_frame,
                                          encode_frame, frame_size,
                                          split_frames)

__all__ = ["FrameError", "TransportError", "WireTimeout",
           "encode_frame", "decode_frame", "frame_size", "split_frames"]
