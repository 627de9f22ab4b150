"""reflow_tpu_torch.obs — tracing, live metrics, the flight recorder and
fleet telemetry for the serving stack.

- **Trace spans** (:mod:`.trace` / :mod:`.export`): per-thread ring
  buffers of timed stage spans, off by default (``REFLOW_TRACE=1`` or
  :func:`enable`), exported as Chrome trace-event JSON for Perfetto.
  Sampled tickets get a six-stage end-to-end timeline (admission /
  coalesce / sched_delay / execute / fsync / resolve) that tiles the
  measured ticket latency exactly.
- **Live registry** (:mod:`.registry`): named counters/gauges plus
  ``register_source`` bridges; :class:`SnapshotEmitter` appends periodic
  JSONL snapshots.
- **Flight recorder** (:mod:`.flight`): a crash-surviving on-disk ring
  of causality-carrying spans and control-plane events (fence rejects,
  promotions), teed off :func:`evt` once :func:`flight.install` runs.
- **Fleet telemetry** (:mod:`.fleet` / :mod:`.wire`): each node's
  :class:`TelemetryShipper` streams registry snapshots over the
  ``net/`` transports to a :class:`FleetAggregator` (behind a
  :class:`TelemetryServer`), which derives cross-node gauges — lag
  spread, link health, epoch agreement — and stale-marks nodes whose
  telemetry link drops. Loss is always tolerated, never blocking. The
  requests and snapshots are the JAX package's, so either package's
  link talks to the other's server.

Quickstart::

    from reflow_tpu_torch import obs
    obs.enable()                       # or REFLOW_TRACE=1
    fe.publish_metrics()               # frontend/tier/wal/sched/budget
    with obs.SnapshotEmitter("telemetry.jsonl", interval_s=2.0):
        ...serve traffic...
    obs.export_chrome_trace("trace.json")   # open in ui.perfetto.dev
"""

from . import export, flight, registry, trace  # noqa: F401
from .export import chrome_events, export_chrome_trace, ticket_timelines
from .flight import FLIGHT_SCHEMA, FlightRecorder, read_flight_dir
from .registry import (REGISTRY, SNAPSHOT_SCHEMA, Counter, Gauge,
                       MetricsRegistry, SnapshotEmitter)
from .trace import (STAGES, TraceCtx, disable, enable, enabled, evt,
                    mint, mint_cause, set_flight_hook, ticket_stages)

__all__ = ["chrome_events", "export_chrome_trace", "ticket_timelines",
           "REGISTRY", "SNAPSHOT_SCHEMA", "Counter", "Gauge",
           "MetricsRegistry", "SnapshotEmitter", "STAGES", "TraceCtx",
           "disable", "enable", "enabled", "evt", "mint", "mint_cause",
           "set_flight_hook", "ticket_stages", "FLIGHT_SCHEMA",
           "FlightRecorder", "read_flight_dir", "FLEET_SCHEMA",
           "FleetAggregator", "TelemetryShipper", "TelemetryLink",
           "TelemetryServer", "clock_anchor", "node_id"]

# The fleet plane rides the net/ transports, and net/ itself traces
# through this package — resolve the cycle by loading fleet/wire names
# lazily (PEP 562) instead of at obs import time.
_FLEET_NAMES = {"FLEET_SCHEMA": "fleet", "FleetAggregator": "fleet",
                "TelemetryShipper": "fleet", "TelemetryLink": "wire",
                "TelemetryServer": "wire", "clock_anchor": "wire",
                "node_id": "wire", "fleet": None, "wire": None}


def __getattr__(name):
    mod = _FLEET_NAMES.get(name, "")
    if mod == "":
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    if mod is None:
        return importlib.import_module(f".{name}", __name__)
    return getattr(importlib.import_module(f".{mod}", __name__), name)
