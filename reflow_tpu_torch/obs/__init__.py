"""reflow_tpu_torch.obs — trace spans, the live metrics registry and the
flight recorder.

- **Trace spans** (:mod:`.trace`): per-thread ring buffers of timed
  stage spans, off by default (``REFLOW_TRACE=1`` or :func:`enable`).
- **Live registry** (:mod:`.registry`): named counters/gauges plus
  ``register_source`` bridges; :class:`SnapshotEmitter` appends periodic
  JSONL snapshots.
- **Flight recorder** (:mod:`.flight`): a crash-surviving on-disk ring
  of causality-carrying spans and control-plane events (fence rejects,
  promotions), teed off :func:`evt` once :func:`flight.install` runs.
- **Node identity** (:mod:`.wire`): :func:`node_id` and
  :func:`clock_anchor`. The fleet telemetry plane (``TelemetryLink``,
  ``TelemetryServer``, the aggregator) comes with the ``obs/`` slice.

The scheduler, the ingest frontend and the replication path record
spans through ``trace.evt`` and publish gauges into :data:`REGISTRY`.
"""

from . import flight, registry, trace, wire  # noqa: F401
from .flight import FLIGHT_SCHEMA, FlightRecorder, read_flight_dir
from .registry import (REGISTRY, SNAPSHOT_SCHEMA, Counter, Gauge,
                       MetricsRegistry, SnapshotEmitter)
from .trace import (STAGES, TraceCtx, disable, enable, enabled, evt,
                    mint, mint_cause, set_flight_hook, ticket_stages)
from .wire import clock_anchor, node_id

__all__ = ["REGISTRY", "SNAPSHOT_SCHEMA", "Counter", "Gauge",
           "MetricsRegistry", "SnapshotEmitter", "STAGES", "TraceCtx",
           "disable", "enable", "enabled", "evt", "mint", "mint_cause",
           "set_flight_hook", "ticket_stages", "FLIGHT_SCHEMA",
           "FlightRecorder", "read_flight_dir", "clock_anchor", "node_id"]
