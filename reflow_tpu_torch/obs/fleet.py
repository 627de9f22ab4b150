"""Fleet telemetry: per-node snapshot shipping + cross-node gauges
(docs/guide.md "Fleet telemetry").

Per-process observability (PR 4) answers "what is *this* node doing";
this module answers "what is the *fleet* doing" without ssh-ing into
every process. Each node runs a :class:`TelemetryShipper` that tails
its :class:`~reflow_tpu_torch.obs.registry.MetricsRegistry` and streams
``reflow.obs.snapshot/1`` lines over the ``net/`` transports to a
:class:`FleetAggregator`, which keeps a retention-bounded per-node
time-series ring and derives the gauges no single node can compute:

- **replication lag spread** — max−min follower horizon across nodes;
- **per-link health** — every ``*.conn_state`` gauge in the fleet;
- **epoch agreement** — any node still behind the failover fence;
- **compaction debt** — summed ``compact.reclaimable_bytes``;
- **aggregate read QPS** — summed per-node read rates (from
  consecutive snapshots of the cumulative read counters).

Loss semantics: telemetry is *advisory*. A dropped snapshot, a
partitioned telemetry link, or a dead aggregator degrades to stale
gauges (each node entry carries ``age_s``/``stale``) — never an
exception, and never back-pressure on the data path. The shipper runs
on its own daemon thread with the same fixed-rate deadline re-arm as
:class:`~reflow_tpu_torch.obs.registry.SnapshotEmitter`.

The port's copy of ``reflow_tpu/obs/fleet.py``: the same snapshot
schema, derived gauges and ``reflow.fleet/1`` keys.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from reflow_tpu_torch.net.backoff import ReconnectPolicy
from reflow_tpu_torch.net.transport import Transport
from reflow_tpu_torch.obs.registry import (REGISTRY, SNAPSHOT_SCHEMA,
                                     MetricsRegistry)
from reflow_tpu_torch.obs.wire import TelemetryLink, node_id
from reflow_tpu_torch.utils.config import env_float, env_int
from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["FLEET_SCHEMA", "FleetAggregator", "TelemetryShipper"]

FLEET_SCHEMA = "reflow.fleet/1"


def _num(v: Any) -> Optional[float]:
    """A gauge value as a float, or None for the non-numeric ones
    (conn-state strings, degraded ``"error: ..."`` entries)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def _suffix_values(gauges: Dict[str, Any], suffix: str
                   ) -> Dict[str, float]:
    out = {}
    for k, v in gauges.items():
        if k.endswith(suffix):
            n = _num(v)
            if n is not None:
                out[k] = n
    return out


class TelemetryShipper:
    """Tail one registry and stream its snapshots to the aggregator.

    Every ``interval_s`` (``REFLOW_FLEET_INTERVAL_S``) the shipper
    snapshots ``registry`` and pushes it over its
    :class:`~reflow_tpu_torch.obs.wire.TelemetryLink`. A failed push is
    *dropped* (counted in :attr:`dropped`) — the link's
    :class:`ReconnectPolicy` backs off and later beats retry with
    fresh data; stale snapshots are never queued, because the newest
    one supersedes everything a dead link missed."""

    def __init__(self, registry: Optional[MetricsRegistry],
                 transport: Transport, address, *,
                 node: Optional[str] = None,
                 interval_s: Optional[float] = None,
                 policy: Optional[ReconnectPolicy] = None,
                 io_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.registry = registry if registry is not None else REGISTRY
        self.node = node if node is not None else node_id()
        self.interval_s = interval_s if interval_s is not None \
            else env_float("REFLOW_FLEET_INTERVAL_S")
        self.link = TelemetryLink(transport, address, node=self.node,
                                  policy=policy,
                                  io_timeout_s=io_timeout_s)
        self.shipped = 0
        self.dropped = 0
        self._clock = clock
        self._deadline: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._metric_names: List[Tuple[MetricsRegistry, str]] = []

    def build_snapshot(self) -> Dict[str, Any]:
        return {"schema": SNAPSHOT_SCHEMA, "node": self.node,
                "ts_wall": time.time(), "ts_mono": time.monotonic(),
                **self.registry.snapshot()}

    def ship_once(self) -> bool:
        """Snapshot + push one beat; False when the push was dropped.
        Never raises — telemetry failures are stale gauges, not
        errors."""
        try:
            ok = self.link.send_snapshot(self.build_snapshot())
        except Exception:  # noqa: BLE001 - loss is always tolerated
            ok = False
        if ok:
            self.shipped += 1
        else:
            self.dropped += 1
        return ok

    # -- thread loop (fixed-rate, same re-arm as SnapshotEmitter) ------

    def _sleep_s(self) -> float:
        return max(0.0, self._deadline - self._clock())

    def _rearm(self) -> None:
        self._deadline += self.interval_s
        now = self._clock()
        if self._deadline <= now:
            self._deadline = now + self.interval_s

    def _loop(self) -> None:
        self._deadline = self._clock() + self.interval_s
        while not self._stop.wait(self._sleep_s()):
            self.ship_once()
            self._rearm()

    def start(self) -> "TelemetryShipper":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"telemetry-ship/{self.node}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def close(self) -> None:
        self.stop()
        self.link.close()
        for reg, name in self._metric_names:
            reg.unregister_prefix(name)
        self._metric_names.clear()

    # -- observability (the shipper observes itself too) ---------------

    def publish_metrics(self, registry: Optional[MetricsRegistry]
                        = None, name: str = "telemetry") -> None:
        reg = registry if registry is not None else self.registry
        reg.gauge(f"{name}.shipped", lambda: self.shipped)
        reg.gauge(f"{name}.dropped", lambda: self.dropped)
        reg.gauge(f"{name}.conn_state", lambda: self.link.conn_state)
        self._metric_names.append((reg, name))


class FleetAggregator:
    """Retention-bounded per-node snapshot rings + derived fleet
    gauges. Thread-safe: ingest happens on telemetry handler threads
    while consumers (``fleet_inspect`` / ``reflow_top`` /
    ``ControlPlane``) read :meth:`fleet_snapshot` concurrently.

    A node whose newest snapshot is older than ``stale_after_s``
    (``REFLOW_FLEET_STALE_S``) is *stale-marked*, not evicted: during
    a telemetry-link partition the fleet view keeps serving the last
    known state with an honest age on it."""

    def __init__(self, *, retention: Optional[int] = None,
                 stale_after_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time) -> None:
        self.retention = retention if retention is not None \
            else env_int("REFLOW_FLEET_RETENTION")
        self.stale_after_s = stale_after_s if stale_after_s is not None \
            else env_float("REFLOW_FLEET_STALE_S")
        self.lag_spread_max = env_int("REFLOW_FLEET_LAG_SPREAD_MAX")
        self._clock = clock
        self._wall = wall
        self._lock = named_lock("obs.fleet")
        self._rings: Dict[str, deque] = {}   # node -> (recv_mono, snap)
        self._anchors: Dict[str, Dict[str, Any]] = {}
        self.snapshots_total = 0
        self._metric_names: List[Tuple[MetricsRegistry, str]] = []

    # -- ingest (called from TelemetryServer handler threads) ----------

    def ingest(self, node: str, snapshot: Dict[str, Any]) -> None:
        now = self._clock()
        with self._lock:
            ring = self._rings.get(node)
            if ring is None:
                ring = self._rings[node] = deque(maxlen=self.retention)
            ring.append((now, snapshot))
            self.snapshots_total += 1

    def record_anchor(self, node: str, anchor: Dict[str, Any]) -> None:
        with self._lock:
            self._anchors[node] = dict(anchor)

    def node_count(self) -> int:
        with self._lock:
            return len(self._rings)

    def await_nodes(self, n: int, timeout_s: float = 10.0,
                    poll_s: float = 0.02) -> bool:
        """Block until at least ``n`` distinct nodes have shipped a
        snapshot (the process harness's "fleet is up" gate: a child
        counts as joined once its first telemetry beat lands). Returns
        False on timeout — telemetry loss is tolerated by design, so
        callers decide whether an incomplete fleet is an error."""
        deadline = self._clock() + timeout_s
        while self.node_count() < n:
            if self._clock() >= deadline:
                return False
            time.sleep(poll_s)
        return True

    # -- per-node derivation -------------------------------------------

    def _node_entry(self, ring: deque, now: float) -> Dict[str, Any]:
        recv_mono, snap = ring[-1]
        gauges = snap.get("gauges", {}) or {}
        age = max(0.0, now - recv_mono)
        horizons = _suffix_values(gauges, ".horizon")
        lags = _suffix_values(gauges, ".lag_ticks")
        epochs = _suffix_values(gauges, ".epoch")
        conn = {k: v for k, v in gauges.items()
                if k.endswith(".conn_state") and isinstance(v, str)}
        entry: Dict[str, Any] = {
            "age_s": round(age, 4),
            "stale": age > self.stale_after_s,
            "snapshots": len(ring),
            "ts_wall": snap.get("ts_wall"),
            "horizon": max(horizons.values()) if horizons else None,
            "lag_ticks": max(lags.values()) if lags else None,
            "epoch": max(epochs.values()) if epochs else None,
            "conn_states": conn,
            "reads_total": self._reads_total(gauges),
            "read_qps": self._read_qps(ring),
            "compact_debt_bytes": _num(
                gauges.get("compact.reclaimable_bytes")),
            "ship_backlog_segments": _num(
                gauges.get("ship.backlog_segments")),
            "subs_active": _num(gauges.get("subs.active")),
            "sub_rows_s": self._sub_rows_s(ring),
            "sub_conflations": self._sub_conflations(gauges),
            "sub_lag_windows": _num(gauges.get("subs.slowest_lag")),
            # None on snapshots from pre-upgrade nodes (gauge absent)
            "sub_freshness_p50": _num(gauges.get("subs.freshness_p50")),
            "sub_freshness_p99": _num(gauges.get("subs.freshness_p99")),
            "flight_events": _num(gauges.get("flight.events_total")),
            # tiled maintenance (REFLOW_TILE_BYTES > 0): worst resident
            # tile across this node's compactor/chain, published
            # snapshot tiles across its replicas
            "tile_peak_bytes": (max(_suffix_values(
                gauges, ".peak_tile_bytes").values())
                if _suffix_values(gauges, ".peak_tile_bytes")
                else None),
            "snapshot_tiles": (int(sum(_suffix_values(
                gauges, ".snapshot_tiles").values()))
                if _suffix_values(gauges, ".snapshot_tiles")
                else None),
        }
        brownout = {k: v for k, v in gauges.items() if "brownout" in k}
        if brownout:
            entry["brownout"] = brownout
        return entry

    @staticmethod
    def _reads_total(gauges: Dict[str, Any]) -> Optional[float]:
        total, seen = 0.0, False
        for suffix in (".replica_reads", ".leader_fallbacks"):
            for v in _suffix_values(gauges, suffix).values():
                total += v
                seen = True
        return total if seen else None

    def _read_qps(self, ring: deque) -> Optional[float]:
        """Read rate across the retention window: newest minus oldest
        cumulative read counter, over the *sender's* monotonic clock
        (one process, so the delta is trustworthy; wall clocks never
        enter it)."""
        if len(ring) < 2:
            return None
        new, old = ring[-1][1], ring[0][1]
        rn = self._reads_total(new.get("gauges", {}) or {})
        ro = self._reads_total(old.get("gauges", {}) or {})
        tn, to = _num(new.get("ts_mono")), _num(old.get("ts_mono"))
        if rn is None or ro is None or tn is None or to is None \
                or tn <= to:
            return None
        return max(0.0, (rn - ro) / (tn - to))

    @staticmethod
    def _sub_conflations(gauges: Dict[str, Any]) -> Optional[float]:
        total, seen = 0.0, False
        for key in ("subs.conflations_total", "subs.sheds_total"):
            v = _num(gauges.get(key))
            if v is not None:
                total += v
                seen = True
        return total if seen else None

    def _sub_rows_s(self, ring: deque) -> Optional[float]:
        """Fan-out row rate, derived exactly like ``_read_qps``: the
        cumulative ``subs.fanout_rows_total`` counter differenced over
        the sender's monotonic clock. None until a node ships two
        snapshots that carry the gauge (old fleets never do)."""
        if len(ring) < 2:
            return None
        new, old = ring[-1][1], ring[0][1]
        rn = _num((new.get("gauges", {}) or {}).get(
            "subs.fanout_rows_total"))
        ro = _num((old.get("gauges", {}) or {}).get(
            "subs.fanout_rows_total"))
        tn, to = _num(new.get("ts_mono")), _num(old.get("ts_mono"))
        if rn is None or ro is None or tn is None or to is None \
                or tn <= to:
            return None
        return max(0.0, (rn - ro) / (tn - to))

    # -- the fleet view -------------------------------------------------

    def fleet_snapshot(self) -> Dict[str, Any]:
        """The whole fleet as one dict (schema ``reflow.fleet/1``):
        per-node entries plus the derived cross-node gauges and the
        alert lines both consoles render."""
        now = self._clock()
        with self._lock:
            rings = {n: ring for n, ring in self._rings.items() if ring}
            nodes = {n: self._node_entry(ring, now)
                     for n, ring in rings.items()}
            anchors = {n: dict(a) for n, a in self._anchors.items()}
            total = self.snapshots_total
        horizons = [e["horizon"] for e in nodes.values()
                    if e["horizon"] is not None]
        epochs = sorted({int(e["epoch"]) for e in nodes.values()
                         if e["epoch"] is not None})
        qps = [e["read_qps"] for e in nodes.values()
               if e["read_qps"] is not None]
        debt = [e["compact_debt_bytes"] for e in nodes.values()
                if e["compact_debt_bytes"] is not None]
        backlog = [e["ship_backlog_segments"] for e in nodes.values()
                   if e["ship_backlog_segments"] is not None]
        subs = [e["subs_active"] for e in nodes.values()
                if e["subs_active"] is not None]
        sub_rows = [e["sub_rows_s"] for e in nodes.values()
                    if e["sub_rows_s"] is not None]
        sub_lag = [e["sub_lag_windows"] for e in nodes.values()
                   if e["sub_lag_windows"] is not None]
        sub_f50 = [e["sub_freshness_p50"] for e in nodes.values()
                   if e["sub_freshness_p50"] is not None]
        sub_f99 = [e["sub_freshness_p99"] for e in nodes.values()
                   if e["sub_freshness_p99"] is not None]
        flight_ev = [e["flight_events"] for e in nodes.values()
                     if e["flight_events"] is not None]
        tile_peaks = [e["tile_peak_bytes"] for e in nodes.values()
                      if e["tile_peak_bytes"] is not None]
        snap_tiles = [e["snapshot_tiles"] for e in nodes.values()
                      if e["snapshot_tiles"] is not None]
        link_states: Dict[str, int] = {}
        for e in nodes.values():
            for state in e["conn_states"].values():
                link_states[state] = link_states.get(state, 0) + 1
        stale = sorted(n for n, e in nodes.items() if e["stale"])
        lag_spread = (max(horizons) - min(horizons)) if horizons \
            else None
        gauges: Dict[str, Any] = {
            "nodes_total": len(nodes),
            "nodes_stale": len(stale),
            "lag_spread": lag_spread,
            "epochs": epochs,
            "epoch_agree": len(epochs) <= 1,
            "aggregate_read_qps": round(sum(qps), 3) if qps else None,
            "compact_debt_bytes": sum(debt) if debt else None,
            "ship_backlog_segments": max(backlog) if backlog else None,
            "subs_active": int(sum(subs)) if subs else None,
            "sub_rows_s": round(sum(sub_rows), 3) if sub_rows else None,
            "sub_lag_windows": max(sub_lag) if sub_lag else None,
            # worst push freshness across the fleet (seconds); None
            # until some node ships the gauge (pre-upgrade snapshots)
            "subs.freshness_p50": (round(max(sub_f50), 6)
                                   if sub_f50 else None),
            "subs.freshness_p99": (round(max(sub_f99), 6)
                                   if sub_f99 else None),
            "flight.events_total": (int(sum(flight_ev))
                                    if flight_ev else None),
            "tile_peak_bytes": max(tile_peaks) if tile_peaks else None,
            "snapshot_tiles": (int(sum(snap_tiles))
                               if snap_tiles else None),
            "link_states": link_states,
            "max_age_s": round(max(
                (e["age_s"] for e in nodes.values()), default=0.0), 4),
            "snapshots_total": total,
        }
        alerts: List[str] = []
        for n in stale:
            alerts.append(f"stale: {n} last seen "
                          f"{nodes[n]['age_s']:.1f}s ago")
        if len(epochs) > 1:
            alerts.append(f"epoch disagreement: {epochs}")
        if lag_spread is not None \
                and lag_spread > self.lag_spread_max:
            alerts.append(f"lag spread {int(lag_spread)} ticks exceeds "
                          f"{self.lag_spread_max}")
        return {"schema": FLEET_SCHEMA, "ts_wall": self._wall(),
                "nodes": nodes, "gauges": gauges, "alerts": alerts,
                "anchors": anchors}

    # -- point reads (ControlPlane / gauges) ----------------------------

    def lag_spread(self) -> Optional[float]:
        return self.fleet_snapshot()["gauges"]["lag_spread"]

    def stale_nodes(self) -> List[str]:
        snap = self.fleet_snapshot()
        return sorted(n for n, e in snap["nodes"].items()
                      if e["stale"])

    # -- observability --------------------------------------------------

    def publish_metrics(self, registry: Optional[MetricsRegistry]
                        = None, name: str = "fleet") -> None:
        reg = registry if registry is not None else REGISTRY

        def _gauge(key):
            return lambda: self.fleet_snapshot()["gauges"][key]

        reg.gauge(f"{name}.nodes_total", _gauge("nodes_total"))
        reg.gauge(f"{name}.nodes_stale", _gauge("nodes_stale"))
        reg.gauge(f"{name}.lag_spread", _gauge("lag_spread"))
        reg.gauge(f"{name}.epoch_agree", _gauge("epoch_agree"))
        reg.gauge(f"{name}.aggregate_read_qps",
                  _gauge("aggregate_read_qps"))
        reg.gauge(f"{name}.compact_debt_bytes",
                  _gauge("compact_debt_bytes"))
        reg.gauge(f"{name}.snapshots_total",
                  lambda: self.snapshots_total)
        self._metric_names.append((reg, name))

    def close(self) -> None:
        for reg, name in self._metric_names:
            reg.unregister_prefix(name)
        self._metric_names.clear()
