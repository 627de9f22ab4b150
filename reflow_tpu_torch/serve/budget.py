"""Admission budget: the in-flight byte bound, injectable and shareable.

PR 2's ``IngestFrontend`` carried its byte budget inside
``SourceQueues`` (a bare ``max_bytes``); the serving tier needs ONE
budget spanning many graphs, with per-graph **floors** (guaranteed
bytes) and **ceilings** (caps). This module is that budget, factored so
both deployments inject the same object:

- standalone frontend: ``AdmissionBudget(max_bytes).register("solo")``
  (what the frontend builds for itself when none is injected);
- ``ServeTier``: one ``AdmissionBudget``, one ``register(name,
  floor=..., ceiling=...)`` per graph.

Like ``SourceQueues`` this is a pure data structure: every method is
called with the owning lock held — the frontend's own lock standalone,
the tier's shared lock when graphs share a budget. (Sharing an
``AdmissionBudget`` across frontends therefore REQUIRES sharing their
lock; the tier guarantees that by construction.)

Floors are *reservations*, not partitions: graph ``g``'s admission is
granted from ``total - sum(other graphs' unused floors)``, so a hot
tenant can burst into shared headroom but can never push a sibling
below its guaranteed floor — the unused part of every floor is held
back from everyone else. Ceilings cap one graph's usage outright.
The guarantee is stable under churn: as a graph uses its floor, its
reservation shrinks exactly in step with the bytes it takes from the
shared pool, and a release returns bytes and reservation together.

Producer wakeups: each frontend attaches its not-full condition to its
share; any release (a committed macro-tick, a shed) notifies EVERY
attached condition, because freed global bytes may unblock a producer
on a different graph.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["AdmissionBudget", "BudgetShare"]


class BudgetShare:
    """One graph's slice of an :class:`AdmissionBudget`.

    The frontend-facing surface: ``room_for`` / ``fits_alone`` answer
    admission, ``acquire`` / ``release`` move bytes, ``attach`` /
    ``notify_room`` wire producer wakeups. ``used`` / ``peak`` are the
    graph's live and high-water byte occupancy.
    """

    __slots__ = ("budget", "name", "floor", "ceiling", "used", "peak",
                 "_conds")

    def __init__(self, budget: "AdmissionBudget", name: str, floor: int,
                 ceiling: int):
        self.budget = budget
        self.name = name
        self.floor = floor
        self.ceiling = ceiling
        self.used = 0
        self.peak = 0
        self._conds: List[threading.Condition] = []

    # -- admission ---------------------------------------------------------

    def room_for(self, nbytes: int) -> bool:
        return self.budget._room_for(self, nbytes)

    def fits_alone(self, nbytes: int) -> bool:
        """Could this batch EVER be admitted (every queue empty)? False
        means the batch alone exceeds what this graph can hold — the
        frontend rejects instead of shedding for it."""
        return nbytes <= self.max_alone

    @property
    def max_alone(self) -> int:
        """The largest in-flight total this graph is guaranteed to be
        able to reach: its ceiling, clipped by the headroom left once
        every sibling's full floor is reserved."""
        return self.budget._max_alone(self)

    # -- accounting --------------------------------------------------------

    def acquire(self, nbytes: int) -> None:
        self.used += nbytes
        self.peak = max(self.peak, self.used)
        self.budget.used += nbytes
        self.budget.peak = max(self.budget.peak, self.budget.used)

    def release(self, nbytes: int) -> None:
        self.used -= nbytes
        self.budget.used -= nbytes

    # -- producer wakeups --------------------------------------------------

    def attach(self, cond: threading.Condition) -> None:
        """Register a not-full condition to wake on any release. All
        attached conditions must be built on the budget's owning lock."""
        self._conds.append(cond)

    def notify_room(self) -> None:
        """Wake blocked producers budget-wide (caller holds the owning
        lock): freed bytes are global, so a release by this graph may
        unblock a producer waiting on a sibling's frontend."""
        self.budget.notify_room()


class AdmissionBudget:
    """Global in-flight byte budget with per-graph floors/ceilings.

    ``total_bytes`` bounds the sum of every registered share's usage.
    ``register`` validates that floors stay reservable (their sum can't
    exceed the total) and that each ceiling is at least its floor.
    """

    def __init__(self, total_bytes: int):
        if total_bytes <= 0:
            raise ValueError(f"total_bytes must be positive, "
                             f"got {total_bytes}")
        self.total_bytes = total_bytes
        self.used = 0
        self.peak = 0
        self._shares: Dict[str, BudgetShare] = {}
        self._metric_keys: list = []  # (registry, prefix) published

    # -- registration ------------------------------------------------------

    def register(self, name: str, *, floor: int = 0,
                 ceiling: Optional[int] = None) -> BudgetShare:
        if name in self._shares:
            raise ValueError(f"budget share {name!r} already registered")
        ceiling = self.total_bytes if ceiling is None else ceiling
        if not 0 <= floor <= ceiling:
            raise ValueError(
                f"need 0 <= floor <= ceiling, got floor={floor} "
                f"ceiling={ceiling} for {name!r}")
        if ceiling > self.total_bytes:
            raise ValueError(
                f"ceiling {ceiling} for {name!r} exceeds the "
                f"{self.total_bytes}B budget")
        reserved = sum(s.floor for s in self._shares.values())
        if reserved + floor > self.total_bytes:
            raise ValueError(
                f"floor {floor} for {name!r} is not reservable: "
                f"{reserved}B of the {self.total_bytes}B budget is "
                f"already promised to other graphs")
        share = BudgetShare(self, name, floor, ceiling)
        self._shares[name] = share
        return share

    def resize(self, name: str, *, floor: Optional[int] = None,
               ceiling: Optional[int] = None) -> BudgetShare:
        """Live-retune one share's floor/ceiling under the owning lock —
        the control plane's rebalancing actuator.

        Validation matches :meth:`register`: the new floor must stay
        reservable alongside every sibling's floor, and the ceiling must
        stay within the total. Shrinking a floor returns its reservation
        to the shared pool immediately (siblings' ``max_alone`` grows);
        growing one re-checks reservability. A ceiling below the share's
        CURRENT usage is legal: nothing is evicted, but no new admission
        happens until usage drains back under it. Loosened constraints
        may unblock parked producers, so every resize notifies room
        budget-wide.
        """
        share = self._shares.get(name)
        if share is None:
            raise KeyError(f"no budget share {name!r}")
        new_floor = share.floor if floor is None else floor
        new_ceiling = share.ceiling if ceiling is None else ceiling
        if not 0 <= new_floor <= new_ceiling:
            raise ValueError(
                f"need 0 <= floor <= ceiling, got floor={new_floor} "
                f"ceiling={new_ceiling} for {name!r}")
        if new_ceiling > self.total_bytes:
            raise ValueError(
                f"ceiling {new_ceiling} for {name!r} exceeds the "
                f"{self.total_bytes}B budget")
        reserved = sum(s.floor for s in self._shares.values()
                       if s is not share)
        if reserved + new_floor > self.total_bytes:
            raise ValueError(
                f"floor {new_floor} for {name!r} is not reservable: "
                f"{reserved}B of the {self.total_bytes}B budget is "
                f"already promised to other graphs")
        share.floor = new_floor
        share.ceiling = new_ceiling
        self.notify_room()
        return share

    def unregister(self, name: str) -> None:
        """Drop a share; any bytes it still holds return to the pool
        (its entries' tickets were already failed or applied)."""
        share = self._shares.pop(name, None)
        if share is not None and share.used:
            self.used -= share.used
            share.used = 0

    def shares(self) -> Dict[str, BudgetShare]:
        return dict(self._shares)

    # -- admission math ----------------------------------------------------

    def _reserved_for_others(self, share: BudgetShare) -> int:
        return sum(max(0, s.floor - s.used)
                   for s in self._shares.values() if s is not share)

    def _room_for(self, share: BudgetShare, nbytes: int) -> bool:
        if share.used + nbytes > share.ceiling:
            return False
        return (self.used + nbytes
                <= self.total_bytes - self._reserved_for_others(share))

    def _max_alone(self, share: BudgetShare) -> int:
        headroom = self.total_bytes - sum(
            s.floor for s in self._shares.values() if s is not share)
        return min(share.ceiling, headroom)

    # -- producer wakeups --------------------------------------------------

    def notify_room(self) -> None:
        for share in self._shares.values():
            for cond in share._conds:
                cond.notify_all()

    # -- observability -----------------------------------------------------

    def publish_metrics(self, registry=None, *, name: str = "budget"
                        ) -> str:
        """Register live occupancy gauges (total/used/peak bytes,
        occupancy fraction, per-share usage) into an obs registry.
        Gauges read the counters the owning lock already guards —
        snapshot reads are racy-but-consistent-enough telemetry, never
        admission decisions. Returns the gauge-name prefix."""
        from reflow_tpu_torch.obs import REGISTRY
        reg = registry if registry is not None else REGISTRY
        reg.gauge(f"{name}.total_bytes", lambda: self.total_bytes)
        reg.gauge(f"{name}.used_bytes", lambda: self.used)
        reg.gauge(f"{name}.peak_bytes", lambda: self.peak)
        reg.gauge(f"{name}.occupancy",
                  lambda: self.used / self.total_bytes)
        self._metric_keys.append((reg, name))
        reg.gauge(f"{name}.per_share_used",
                  lambda: {s.name: s.used
                           for s in self._shares.values()})
        return name

    def unpublish_metrics(self) -> None:
        """Drop every gauge :meth:`publish_metrics` registered — the
        tier calls this at close so a re-created budget never leaves
        stale lambdas capturing a dead instance in the registry."""
        for reg, prefix in self._metric_keys:
            reg.unregister_prefix(f"{prefix}.")
        self._metric_keys = []
