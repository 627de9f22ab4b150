"""Source ownership and the cross-process tick-horizon barrier.

Two small pieces of shared vocabulary for the process harness:

- :class:`OwnershipMap` pins every graph source to an owning node and
  gives each node its own on-disk corner under one root — WAL, mirror
  and checkpoint directories that survive a ``kill -9`` and are found
  again by a respawn of the *same* node name. Ownership is what makes
  a "local mirrored WAL keyed by source ownership" well-defined: the
  batch ids a producer mints are scoped by its source, the source is
  scoped by its owner, so two nodes never contend for one id space.
- :func:`horizon_barrier` is the consistent-cut gate: given a horizon
  probe per node (a ``ping`` over the wire, usually), it waits until
  every node's applied horizon reaches a common target tick. A
  restarted process calls this to *rejoin* — its recovery replay is
  only complete once it stands at the same cut as the peers that never
  died, and parity checks across processes are only meaningful at such
  a cut.

The port's copy of ``reflow_tpu/proc/ownership.py``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

__all__ = ["OwnershipMap", "horizon_barrier", "BarrierTimeout"]


class BarrierTimeout(TimeoutError):
    """The fleet never converged on a common horizon: ``.horizons``
    holds the last observed per-node values (None = unreachable)."""

    def __init__(self, msg: str, horizons: Dict[str, Optional[int]]):
        super().__init__(msg)
        self.horizons = dict(horizons)


class OwnershipMap:
    """Deterministic source→node assignment + per-node disk layout.

    ``nodes`` are the owning process names (replicas, or the leader for
    an unreplicated source); ``sources`` the graph's source/loop node
    names. Assignment is round-robin in the given order — pure data, so
    a harness parent and a respawned child derive the identical map
    from the identical spec (see :meth:`spec` / :meth:`from_spec`).
    """

    def __init__(self, root: str, nodes: List[str],
                 sources: List[str] = ()) -> None:
        if not nodes:
            raise ValueError("OwnershipMap needs at least one node")
        self.root = root
        self.nodes = list(nodes)
        self.sources = list(sources)
        self._owner = {s: self.nodes[i % len(self.nodes)]
                       for i, s in enumerate(self.sources)}

    def owner(self, source: str) -> str:
        return self._owner[source]

    def sources_of(self, node: str) -> List[str]:
        return [s for s, n in self._owner.items() if n == node]

    # -- disk layout ---------------------------------------------------

    def node_dir(self, node: str) -> str:
        d = os.path.join(self.root, node)
        os.makedirs(d, exist_ok=True)
        return d

    def wal_dir(self, node: str) -> str:
        d = os.path.join(self.node_dir(node), "wal")
        os.makedirs(d, exist_ok=True)
        return d

    def mirror_dir(self, node: str) -> str:
        # a ReplicaScheduler takes the node dir and lays out wal/ +
        # ckpt/ itself; this names where its mirror lands
        return os.path.join(self.node_dir(node), "wal")

    def ckpt_dir(self, node: str) -> str:
        d = os.path.join(self.node_dir(node), "ckpt")
        os.makedirs(d, exist_ok=True)
        return d

    # -- shipping across the process boundary --------------------------

    def spec(self) -> dict:
        return {"root": self.root, "nodes": list(self.nodes),
                "sources": list(self.sources)}

    @classmethod
    def from_spec(cls, d: dict) -> "OwnershipMap":
        return cls(d["root"], d["nodes"], d.get("sources", ()))


def horizon_barrier(probes: Dict[str, Callable[[], Optional[int]]], *,
                    min_horizon: Optional[int] = None,
                    timeout_s: float = 10.0,
                    poll_s: float = 0.05) -> Dict[str, int]:
    """Wait until every probed node's applied horizon reaches a common
    cut; returns the per-node horizons observed at the moment the
    barrier opened.

    ``probes`` maps node name to a callable returning its current
    horizon, or ``None`` while the node is unreachable (mid-restart —
    that is precisely the window the barrier exists to wait out). The
    target cut is ``min_horizon`` when given; otherwise the highest
    horizon seen on the first full pass — "everyone catches up to the
    most advanced survivor", which is the rejoin contract after a
    ``kill -9``: the respawned node replays its mirror and re-ships
    the tail until it stands where the fleet stands.

    Raises :class:`BarrierTimeout` (with the last observations) if the
    fleet does not converge in ``timeout_s``.
    """
    deadline = time.monotonic() + timeout_s
    target = min_horizon
    last: Dict[str, Optional[int]] = {n: None for n in probes}
    while True:
        horizons: Dict[str, Optional[int]] = {}
        for node, probe in probes.items():
            try:
                horizons[node] = probe()
            except Exception:  # noqa: BLE001 - unreachable == not yet
                horizons[node] = None
        last = horizons
        seen = [h for h in horizons.values() if h is not None]
        if target is None and len(seen) == len(probes):
            target = max(seen) if seen else 0
        if (target is not None and len(seen) == len(probes)
                and all(h >= target for h in seen)):
            return {n: int(h) for n, h in horizons.items()}
        if time.monotonic() >= deadline:
            raise BarrierTimeout(
                f"horizon barrier (target {target}) still open after "
                f"{timeout_s}s: {horizons}", horizons)
        time.sleep(poll_s)
