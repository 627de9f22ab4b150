"""Executor ABC: run one pass of a tick's dirty plan.

The scheduler computes *what* to run (dirty plan, structural — no device
values are consulted, keeping host↔device traffic at the graph boundary per
the north star); the executor decides *how*. The contract:

``run_pass(plan, ingress) -> egress``

- ``plan``: topo-ordered dirty nodes (sources/loops first).
- ``ingress``: {node_id: DeltaBatch} for the dirty source/loop nodes.
- ``egress``: {node_id: DeltaBatch} for every sink in the plan **and** every
  loop node whose back-edge produced deltas this pass (the scheduler re-ticks
  those). Internal edges never cross the executor boundary.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, Sequence, Union

from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.graph import FlowGraph, Node

__all__ = ["Executor", "register_executor", "get_executor"]


class Executor(abc.ABC):
    name: str = "?"

    def __init__(self):
        self.graph: FlowGraph | None = None
        self.states: Dict[int, object] = {}
        #: device→host readbacks done by :meth:`materialize` (forced
        #: syncs on a streaming path; always 0 for host executors)
        self.materialize_count = 0

    def fresh(self) -> "Executor":
        """A new, unbound executor of this one's kind and options (a
        promoted replica's leader runs on one)."""
        return type(self)()

    def bind(self, graph: FlowGraph) -> None:
        """Attach to a validated graph and allocate per-node state."""
        self.graph = graph
        self.states = {
            n.id: n.op.initial_state()
            for n in graph.nodes
            if n.kind == "op" and n.op is not None
        }

    @abc.abstractmethod
    def run_pass(self, plan: Sequence[Node],
                 ingress: Dict[int, DeltaBatch]) -> Dict[int, DeltaBatch]:
        ...

    def run_tick_fixpoint(self, plan: Sequence[Node],
                          ingress: Dict[int, DeltaBatch], max_iters: int,
                          *, sync: bool = True):
        """Optionally run an ENTIRE tick (all fixpoint passes) in one call.

        Returns ``({sink_id: [batches]}, passes, loop_rows, quiesced,
        extra_dirty_node_ids, leftover)`` or None when unsupported — the
        scheduler then drives passes itself. ``leftover`` maps loop node
        ids to in-flight loop-delta batches of a tick that halted at
        ``max_iters``: the scheduler stashes them as pending so the
        paused iteration RESUMES next tick (empty when quiescent).
        Executors that can fuse the loop on device (TpuExecutor via
        ``lax.while_loop``) override this.

        ``sync=False`` permits the scalar observability fields (passes,
        loop_rows, quiesced) to come back as device values without
        blocking — streaming callers pipeline ticks and block once per
        batch (see ``TickResult.block``).
        """
        return None

    def materialize(self, batch) -> DeltaBatch:
        """Convert a (possibly device-resident) sink egress batch to host."""
        return batch

    def refresh_minmax(self, node: Node, batch: DeltaBatch) -> None:
        """Maintenance hook for bounded min/max state (no-op by default):
        rebuild the candidate buffers of every key in ``batch`` from a
        replay of its full live multiset, resetting the monotone
        overflow latches. The CPU oracle keeps exact multisets and needs
        no refresh; device executors override."""

    def on_states_replaced(self) -> None:
        """Hook: the caller swapped ``self.states`` wholesale (checkpoint
        restore). Executors holding derived caches keyed to state content
        (e.g. the linear fixpoint's sorted-arena CSR) must invalidate
        them here — the (gen, rcount) validity predicate cannot detect a
        lineage swap whose counters happen to line up."""

    def check_errors(self) -> None:
        """Raise if any op state carries a sticky error flag (called by the
        scheduler once per tick, so invalid state fails loudly instead of
        leaking corrupt deltas into sink views)."""

    def read_table(self, node: Node) -> Dict:
        """Materialized {key: value} of a stateful node's collection.

        Reduce: the last emitted aggregate per key. Join: the left table.
        """
        st = self.states.get(node.id)
        if st is None:
            raise KeyError(f"{node} holds no materialized state")
        if node.op.kind == "reduce":
            from reflow_tpu_torch.ops.core import _NO_AGG
            return {k: em for k, (ms, em) in st.items() if em is not _NO_AGG}
        if node.op.kind == "join":
            left, _right = st
            out = {}
            for k, ms in left.items():
                for v, w in ms.items():
                    if w > 0:
                        out[k] = v
            return out
        if node.op.kind == "knn":
            return dict(st["emitted"])
        raise KeyError(f"{node} ({node.op.kind}) has no table to read")

    # -- checkpoint seam (SURVEY.md §5) -----------------------------------

    def state_snapshot(self) -> Dict[int, object]:
        """Host-representable snapshot of all per-node operator state.

        Deep-copied: ops mutate their state in place, so a shallow copy
        would alias live state and be invalidated by the next tick.
        """
        import copy

        return copy.deepcopy(self.states)

    def state_restore(self, snapshot: Dict[int, object]) -> None:
        self.states = dict(snapshot)


_REGISTRY: Dict[str, Union[type, Callable[[], type]]] = {}


def register_executor(name: str, cls_or_thunk) -> None:
    _REGISTRY[name] = cls_or_thunk


def get_executor(name: str, **kwargs) -> Executor:
    """Instantiate a registered executor by name ('cpu' is the default
    path; 'cuda' takes ``device=``, and defaults to the current CUDA
    device)."""
    if name not in _REGISTRY:
        raise KeyError(f"no executor {name!r}; registered: {sorted(_REGISTRY)}")
    entry = _REGISTRY[name]
    cls = entry if isinstance(entry, type) else entry()
    return cls(**kwargs)
