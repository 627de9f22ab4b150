"""reflow_tpu_torch.obs — trace spans and the live metrics registry.

- **Trace spans** (:mod:`.trace`): per-thread ring buffers of timed
  stage spans, off by default (``REFLOW_TRACE=1`` or :func:`enable`).
- **Live registry** (:mod:`.registry`): named counters/gauges plus
  ``register_source`` bridges; :class:`SnapshotEmitter` appends periodic
  JSONL snapshots.

The scheduler and the ingest frontend record spans through
``trace.evt`` and publish gauges into :data:`REGISTRY`.
"""

from . import registry, trace  # noqa: F401
from .registry import (REGISTRY, SNAPSHOT_SCHEMA, Counter, Gauge,
                       MetricsRegistry, SnapshotEmitter)
from .trace import (STAGES, TraceCtx, disable, enable, enabled, evt,
                    mint, mint_cause, ticket_stages)

__all__ = ["REGISTRY", "SNAPSHOT_SCHEMA", "Counter", "Gauge",
           "MetricsRegistry", "SnapshotEmitter", "STAGES", "TraceCtx",
           "disable", "enable", "enabled", "evt", "mint", "mint_cause",
           "ticket_stages"]
