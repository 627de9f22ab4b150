"""Live metrics: named counters/gauges + periodic JSONL snapshots.

A :class:`MetricsRegistry` holds three kinds of publishable state:

- **counters** — monotonically increasing totals owned by the registry
  (``registry.counter("serve.shed").inc(n)``);
- **gauges** — point-in-time values, either set directly or backed by a
  callable evaluated at snapshot time (``registry.gauge("budget.used",
  lambda: budget.used)``);
- **sources** — callables returning whole dicts, the bridge to the
  existing offline summaries: subsystems register
  ``lambda: summarize_serve(fe).to_dict()`` so live telemetry and
  post-hoc reports share one schema (``publish_metrics()`` on the
  frontend / tier / budget / WAL / scheduler wires these).

:class:`SnapshotEmitter` is a daemon thread appending one JSON line per
interval (schema tag ``reflow.obs.snapshot/1``) — tail the file or diff
trajectories across PRs. ``stop()`` emits a final snapshot so even a
sub-interval run records its end state.

Snapshot evaluation copies the registry under its lock, then calls
gauges/sources *outside* it: a source that itself takes a subsystem
lock (``summarize_tier`` takes the tier lock) can never deadlock
against a concurrent ``register_source``. A failing source degrades to
an ``{"error": ...}`` entry instead of killing the emitter.
"""

from __future__ import annotations

import json
import threading
import time

from reflow_tpu_torch.utils.runtime import named_lock
from collections import deque
from typing import Any, Callable, Dict, Optional

__all__ = ["SNAPSHOT_SCHEMA", "Counter", "Gauge", "MetricsRegistry",
           "SnapshotEmitter", "REGISTRY"]

SNAPSHOT_SCHEMA = "reflow.obs.snapshot/1"


def _jsonify(obj: Any) -> Any:
    # numpy scalars/arrays and deques → plain python, so every snapshot
    # survives json.dumps no matter what a source hands back
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, deque)):
        return [_jsonify(v) for v in obj]
    if hasattr(obj, "item") and callable(obj.item):
        try:
            return obj.item()
        except Exception:
            pass
    if hasattr(obj, "tolist") and callable(obj.tolist):
        try:
            return obj.tolist()
        except Exception:
            pass
    return obj


class Counter:
    """Monotonic counter; ``inc`` is GIL-atomic for int increments."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Point-in-time value: ``set()`` it, or back it with a callable
    evaluated lazily at snapshot time."""

    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str,
                 fn: Optional[Callable[[], Any]] = None):
        self.name = name
        self._value: Any = 0
        self._fn = fn

    def set(self, value: Any) -> None:
        self._value = value

    @property
    def value(self) -> Any:
        return self._fn() if self._fn is not None else self._value


class MetricsRegistry:
    """Thread-safe name → Counter/Gauge/source map with one-call
    :meth:`snapshot` (always ``json.dumps``-clean)."""

    def __init__(self):
        self._lock = named_lock("obs.registry")
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._sources: Dict[str, Callable[[], Dict[str, Any]]] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str,
              fn: Optional[Callable[[], Any]] = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, fn)
            elif fn is not None:
                g._fn = fn
            return g

    def register_source(self, name: str,
                        fn: Callable[[], Dict[str, Any]]) -> str:
        with self._lock:
            self._sources[name] = fn
        return name

    def unregister_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def unregister_prefix(self, prefix: str) -> None:
        """Drop every counter/gauge/source whose name starts with
        ``prefix`` — subsystem teardown (``close()``) hygiene."""
        with self._lock:
            for d in (self._counters, self._gauges, self._sources):
                for k in [k for k in d if k.startswith(prefix)]:
                    del d[k]

    def value(self, name: str, default: Any = None) -> Any:
        """Read one counter or gauge by name (counters shadow gauges on
        a name collision; ``default`` when neither exists or the gauge's
        callable fails). The point-read the control plane and bench
        assertions use — cheaper than a full :meth:`snapshot`, and the
        gauge callable runs OUTSIDE the registry lock for the same
        deadlock-hygiene reason snapshot's do."""
        with self._lock:
            c = self._counters.get(name)
            g = self._gauges.get(name)
        if c is not None:
            return c.value
        if g is None:
            return default
        try:
            return g.value
        except Exception:  # noqa: BLE001 - degrade like snapshot()
            return default

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = dict(self._gauges)
            sources = dict(self._sources)
        gvals: Dict[str, Any] = {}
        for k, g in gauges.items():
            try:
                gvals[k] = g.value
            except Exception as e:  # noqa: BLE001 - degrade per-gauge
                gvals[k] = f"error: {e}"
        svals: Dict[str, Any] = {}
        for k, fn in sources.items():
            try:
                svals[k] = fn()
            except Exception as e:  # noqa: BLE001 - degrade per-source
                svals[k] = {"error": str(e)}
        return _jsonify({"counters": counters, "gauges": gvals,
                         "sources": svals})


#: the process-wide default registry ``publish_metrics()`` targets when
#: no explicit registry is passed
REGISTRY = MetricsRegistry()


class SnapshotEmitter:
    """Background JSONL telemetry: appends one snapshot line every
    ``interval_s`` seconds (plus a final one at :meth:`stop`)."""

    def __init__(self, path: str, *, interval_s: float = 5.0,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.path = path
        self.interval_s = interval_s
        self.registry = registry if registry is not None else REGISTRY
        self.lines = 0
        self._clock = clock
        self._deadline: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._f = None

    def start(self) -> "SnapshotEmitter":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._f = open(self.path, "a")
        self._thread = threading.Thread(
            target=self._loop, name="reflow-obs-snapshot", daemon=True)
        self._thread.start()
        return self

    def _sleep_s(self) -> float:
        """Time left until the armed deadline — shrinks by however long
        the last emit took, so cadence does not drift with emit cost."""
        return max(0.0, self._deadline - self._clock())

    def _rearm(self) -> None:
        """Advance the deadline one interval from the *previous*
        deadline (fixed-rate), not from now (fixed-delay — the drift
        bug). If an emit overran a whole interval, snap forward instead
        of burst-emitting to catch up."""
        self._deadline += self.interval_s
        now = self._clock()
        if self._deadline <= now:
            self._deadline = now + self.interval_s

    def _loop(self) -> None:
        self._deadline = self._clock() + self.interval_s
        while not self._stop.wait(self._sleep_s()):
            self._emit()
            self._rearm()

    def _emit(self) -> None:
        snap = {"schema": SNAPSHOT_SCHEMA, "ts": time.time(),
                **self.registry.snapshot()}
        self._f.write(json.dumps(snap) + "\n")
        self._f.flush()
        self.lines += 1

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None
        self._emit()  # final snapshot: short runs still record end state
        self._f.close()
        self._f = None

    def __enter__(self) -> "SnapshotEmitter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
