"""ReadTier: fan read queries across replicas with horizon-aware routing.

The router holds N :class:`~reflow_tpu_torch.serve.replica.ReplicaScheduler`s
and answers ``top_k`` / ``lookup`` / ``view_at`` from whichever replica
satisfies the caller's consistency floor:

- ``min_horizon=0`` (default): any replica will do — round-robin so
  aggregate read QPS scales with replica count.
- ``min_horizon=H`` (read-your-writes): a writer that observed its
  window land at leader tick H passes it here; only replicas whose
  published horizon has reached H are eligible, and the result is
  re-checked after the read (a replica may hand back a snapshot built a
  moment before its horizon advanced).
- **Leader fallback**: when no replica has caught up to ``min_horizon``,
  the read goes to the leader adapter — always current, never scalable.
  Leader reads serialize on one lock and copy the live view every time;
  the whole point of the tier is that steady-state traffic never lands
  there (the ``read.leader_fallbacks`` counter says whether yours does).

:class:`LeaderReadAdapter` wraps the leader's scheduler with that
lock-and-copy discipline. The leader's sink views are mutated in place
by the ingest pump's window folds (outside any lock this adapter could
share), so a copy taken mid-fold may observe a torn iteration — the
adapter retries on that, and the *consistency* story stays with the
replicas' published horizons, which is where reads belong.

The port's copy of ``reflow_tpu/serve/read.py``: it routes over any
object with the replica read surface (``published_horizon``, ``top_k``,
``lookup``, ``view_at``), a port replica on the card included.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Tuple

from reflow_tpu_torch.net.framing import TransportError
from reflow_tpu_torch.obs.registry import REGISTRY
from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["ReadTier", "LeaderReadAdapter", "StaleRead", "ReadResult"]


class StaleRead(RuntimeError):
    """No replica satisfies ``min_horizon`` and no leader to fall back
    on (or the leader itself is behind the requested horizon)."""


class ReadResult(NamedTuple):
    """One routed read: the payload, the horizon it was served at, and
    which backend answered (a replica name or ``"leader"``)."""

    value: object
    horizon: int
    source: str


class LeaderReadAdapter:
    """Leader-side fallback reads: copy the live, mutable sink view
    under one adapter-local lock. The pump folds windows into those
    Counters concurrently, so iteration can be torn mid-fold — retried
    here — and two leader reads never run in parallel. Both costs are
    the point of comparison for the replica path's frozen snapshots."""

    name = "leader"

    def __init__(self, sched, *, tick=None) -> None:
        self.sched = sched
        self._tick = tick if tick is not None else (lambda: sched._tick)
        self._lock = named_lock("serve.read.leader")

    def published_horizon(self) -> int:
        return self._tick()

    def _copy_view(self, sink) -> Dict[tuple, float]:
        name = sink if isinstance(sink, str) else sink.name
        view = self.sched.sink_views[name]
        for _ in range(64):
            try:
                return dict(view)
            except RuntimeError:
                continue  # fold resized the dict mid-copy; go again
        return dict(view)  # let the final attempt raise for real

    def top_k(self, sink, k: int, *, by: str = "weight"):
        with self._lock:
            h = self._tick()
            view = self._copy_view(sink)
        if by == "value":
            key = lambda r: -float(r[0][1])  # noqa: E731
        elif by == "weight":
            key = lambda r: -r[1]  # noqa: E731
        else:
            raise ValueError(f"by={by!r}: expected 'weight' or 'value'")
        rows = sorted(((kv, float(w)) for kv, w in view.items()
                       if w != 0), key=key)
        return h, rows[:int(k)]

    def lookup(self, sink, key):
        with self._lock:
            h = self._tick()
            view = self._copy_view(sink)
        return h, float(view.get(key, 0.0))

    def view_at(self, sink):
        with self._lock:
            h = self._tick()
            view = self._copy_view(sink)
        return h, {kv: float(w) for kv, w in view.items() if w != 0}


class ReadTier:
    """Route reads across replicas by published horizon, falling back
    to the leader only when nothing else is fresh enough."""

    def __init__(self, replicas=(), *, leader: Optional[object] = None,
                 name: str = "read") -> None:
        self.name = name
        self.leader = leader
        self._replicas: List[object] = list(replicas)
        self._rr = itertools.count()
        self._lock = named_lock(f"serve.read.{name}")
        self.replica_reads = 0
        self.leader_fallbacks = 0
        self.stale_reads = 0
        #: replicas pulled from rotation because their link went
        #: unreachable or a read blew up link-side; every _route pass
        #: probes them for restore
        self._ejected: List[object] = []
        #: id(replica) -> link object exposing ``conn_state`` (normally
        #: the shipper's RemoteFollower for the same endpoint)
        self._links: Dict[int, object] = {}
        self.ejects = 0
        self.restores = 0
        self._metric_names: List[Tuple[object, str]] = []

    # -- membership --------------------------------------------------------

    def add_replica(self, replica) -> None:
        with self._lock:
            self._replicas.append(replica)

    def remove_replica(self, replica) -> None:
        with self._lock:
            self._replicas = [r for r in self._replicas if r is not replica]
            self._ejected = [r for r in self._ejected if r is not replica]
            self._links.pop(id(replica), None)

    @property
    def replicas(self) -> List[object]:
        with self._lock:
            return list(self._replicas)

    @property
    def ejected_replicas(self) -> List[object]:
        with self._lock:
            return list(self._ejected)

    def bind_link(self, replica, link) -> None:
        """Tie ``replica``'s rotation eligibility to ``link`` (anything
        exposing ``conn_state``, normally the
        ``RemoteFollower`` (``net/``) shipping to the
        same endpoint): while the link reports ``unreachable`` the
        replica is ejected from rotation, and it is restored on the
        first probe after recovery."""
        with self._lock:
            self._links[id(replica)] = link

    def _link_unreachable(self, replica) -> bool:
        link = self._links.get(id(replica))
        return link is not None \
            and getattr(link, "conn_state", "local") == "unreachable"

    def _eject(self, replica) -> None:
        with self._lock:
            if any(r is replica for r in self._ejected):
                return
            self._replicas = [r for r in self._replicas
                              if r is not replica]
            self._ejected.append(replica)
            self.ejects += 1

    def _probe_ejected(self) -> None:
        """Restore any ejected replica whose link recovered. Cheap (an
        attribute read per ejected replica), so every routed read runs
        it — recovery latency is one read, not a timer."""
        with self._lock:
            if not self._ejected:
                return
            back = [r for r in self._ejected
                    if not self._link_unreachable(r)]
            if not back:
                return
            self._ejected = [r for r in self._ejected
                             if not any(r is b for b in back)]
            self._replicas.extend(back)
            self.restores += len(back)

    def promote(self, replica, *, epoch: Optional[int] = None,
                **durable_kw):
        """Failover re-point: promote ``replica`` to leader (idempotent
        — an already-promoted replica hands back its scheduler), drop it
        from the read rotation (its snapshots stop advancing as a
        follower's would) and swing the leader fallback to a
        :class:`LeaderReadAdapter` over the new leader. Returns the new
        leader scheduler so the caller (normally
        ``serve.failover.FailoverCoordinator``) can re-bind ingestion
        and shipping too."""
        sched = replica.promote(epoch=epoch, **durable_kw)
        self.remove_replica(replica)
        with self._lock:
            self.leader = LeaderReadAdapter(sched)
        return sched

    # -- routing -----------------------------------------------------------

    def _route(self, op: str, sink, args: tuple,
               min_horizon: int, kwargs: Optional[dict] = None,
               ) -> ReadResult:
        kwargs = kwargs or {}
        self._probe_ejected()
        replicas = self.replicas
        start = next(self._rr)
        n = len(replicas)
        for i in range(n):
            r = replicas[(start + i) % n]
            if self._link_unreachable(r):
                self._eject(r)
                continue
            try:
                if r.published_horizon() < min_horizon:
                    continue
                h, value = getattr(r, op)(sink, *args, **kwargs)
            except (TransportError, ConnectionError, TimeoutError,
                    OSError) as e:
                # link-flavored failure mid-read: out of rotation until
                # a probe sees the link healthy again
                self._eject(r)
                del e
                continue
            if h < min_horizon:
                # the snapshot raced an advancing horizon; this replica
                # is eligible, but this *result* is not — try the next
                continue
            self.replica_reads += 1
            return ReadResult(value, h, getattr(r, "name", "replica"))
        if self.leader is not None \
                and self.leader.published_horizon() >= min_horizon:
            h, value = getattr(self.leader, op)(sink, *args, **kwargs)
            self.leader_fallbacks += 1
            return ReadResult(value, h,
                              getattr(self.leader, "name", "leader"))
        self.stale_reads += 1
        lead = (self.leader.published_horizon()
                if self.leader is not None else None)
        raise StaleRead(
            f"no backend at min_horizon={min_horizon} "
            f"(replica horizons: "
            f"{[r.published_horizon() for r in replicas]}, "
            f"leader: {lead})")

    def top_k(self, sink, k: int, *, min_horizon: int = 0,
              by: str = "weight") -> ReadResult:
        return self._route("top_k", sink, (k,), min_horizon, {"by": by})

    def lookup(self, sink, key, *, min_horizon: int = 0) -> ReadResult:
        return self._route("lookup", sink, (key,), min_horizon)

    def view_at(self, sink, *, min_horizon: int = 0) -> ReadResult:
        return self._route("view_at", sink, (), min_horizon)

    def max_lag_ticks(self) -> int:
        """Laggiest replica's distance behind the leader tick it last
        saw (the ``replica.lag_ticks`` fleet gauge)."""
        lags = [r.lag_ticks() for r in self.replicas
                if hasattr(r, "lag_ticks")]
        return max(lags) if lags else 0

    def min_horizon_available(self) -> int:
        """Highest horizon any replica currently serves (a writer can
        read-its-writes up to this without touching the leader)."""
        hs = [r.published_horizon() for r in self.replicas]
        return max(hs) if hs else 0

    # -- observability -----------------------------------------------------

    def publish_metrics(self, registry=None,
                        name: Optional[str] = None) -> None:
        reg = registry if registry is not None else REGISTRY
        base = name or self.name
        reg.gauge(f"{base}.replica_reads", lambda: self.replica_reads)
        reg.gauge(f"{base}.leader_fallbacks",
                  lambda: self.leader_fallbacks)
        reg.gauge(f"{base}.stale_reads", lambda: self.stale_reads)
        reg.gauge(f"{base}.replicas", lambda: len(self.replicas))
        reg.gauge(f"{base}.ejected_replicas",
                  lambda: len(self.ejected_replicas))
        reg.gauge(f"{base}.ejects", lambda: self.ejects)
        reg.gauge(f"{base}.restores", lambda: self.restores)
        reg.gauge("replica.lag_ticks", self.max_lag_ticks)
        self._metric_names.append((reg, base))
        self._metric_names.append((reg, "replica.lag_ticks"))

    def close(self) -> None:
        for reg, base in self._metric_names:
            reg.unregister_prefix(base)
        self._metric_names.clear()
