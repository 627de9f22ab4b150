"""Telemetry wire plane: the node's identity and its clock anchor.

The port's copy of the two helpers of ``reflow_tpu/obs/wire.py`` that
the replication path needs: :func:`node_id` names this process in the
causality tokens a ``SegmentShipper`` stamps on its shipments and in the
flight recorder's headers, and :func:`clock_anchor` pairs its monotonic
clock with the wall clock. ``TelemetryLink`` and ``TelemetryServer``
(registry snapshots over the framed transports) come with the ``obs/``
slice (ROADMAP Queue 1 step 9).

Clock anchoring: every process keeps its own monotonic clock; an anchor
pairs a ``monotonic`` reading with the local wall clock so a consumer
can *display* cross-node timestamps on one axis. It is never used for
ordering or correctness (the causality tokens do that by exact string
equality).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from reflow_tpu_torch.utils.config import env_str

__all__ = ["clock_anchor", "node_id"]


def node_id() -> str:
    """This process's id on the telemetry plane: ``REFLOW_FLEET_NODE``
    when set, else ``node-<pid>`` (unique per process on one host)."""
    nid = env_str("REFLOW_FLEET_NODE")
    return nid if nid else f"node-{os.getpid()}"


def clock_anchor(node: Optional[str] = None) -> Dict[str, Any]:
    """One (monotonic, wall) clock pairing for ``node``, taken now.
    Display only — never ordering."""
    return {"node": node if node is not None else node_id(),
            "mono": time.monotonic(), "wall": time.time()}
