"""FlowGraph: the dataflow IR (SURVEY.md §2 item 1, §3 stack 1).

A ``FlowGraph`` is a DAG of nodes (sources, ops, sinks) plus optional
*back-edges* for fixpoint iteration (SURVEY.md §2 item 13). Nodes carry an
output :class:`~reflow_tpu_torch.delta.Spec` so the device executor can build
static-shape device buffers; host-only graphs may leave specs at their
defaults.

Graph construction performs static validation (arity, spec compatibility,
acyclicity modulo declared back-edges, deterministic topo order — the graph
validator the survey calls for in §5 in lieu of a data-race sanitizer).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from reflow_tpu_torch.delta import Spec
from reflow_tpu_torch.ops import (Filter, GroupBy, Join, KnnIndex, Map, Op,
                                  Reduce, Union)

__all__ = ["Node", "FlowGraph", "GraphError"]


class GraphError(ValueError):
    pass


@dataclasses.dataclass(eq=False)
class Node:
    """One vertex: a source, an operator, or a sink."""

    id: int
    name: str
    kind: str                      # 'source' | 'op' | 'sink' | 'loop'
    op: Optional[Op]
    inputs: Tuple["Node", ...]     # ordered input ports
    spec: Spec
    # loop nodes: the node whose output feeds back into this one (back-edge)
    back_input: Optional["Node"] = None
    # optional per-node sharding hint consumed by the device executor:
    # 'key' (shard by key over the mesh), 'replicate', or None (inherit)
    sharding: Optional[str] = None
    # optional partition/stage assignment for topo-partitioned execution
    stage: Optional[int] = None
    # loop nodes: cap on fixpoint passes per tick (close_loop defer_passes).
    # None = run to quiescence every tick. When set, device fixpoint
    # programs may stop after this many passes and carry the residual
    # loop deltas into the next tick (cross-tick residual deferral — see
    # docs/guide.md "Deferred fixpoint"); the CPU oracle and the
    # row-based device program always run to quiescence (strictly more
    # converged, same fixpoint).
    defer_passes: Optional[int] = None

    def __hash__(self):
        return self.id

    def __repr__(self):
        return f"<{self.kind}:{self.name}#{self.id}>"


class FlowGraph:
    """Builder + container for the dataflow graph.

    Typical usage::

        g = FlowGraph()
        lines = g.source("lines", Spec((), np.int64, key_space=V))
        words = g.map(lines, tokenize)
        counts = g.reduce(words, "count", name="counts")
        out = g.sink(counts, "out")
    """

    def __init__(self, name: str = "flow"):
        self.name = name
        self.nodes: List[Node] = []
        self.sources: List[Node] = []
        self.sinks: List[Node] = []
        self.loops: List[Node] = []
        self._consumers: Dict[int, List[Tuple[Node, int]]] = {}
        self._frozen = False

    # -- construction ------------------------------------------------------

    def _add(self, name: Optional[str], kind: str, op: Optional[Op],
             inputs: Sequence[Node], spec: Spec) -> Node:
        if self._frozen:
            raise GraphError("graph is frozen (already validated/executed)")
        for inp in inputs:
            if inp not in self.nodes:
                raise GraphError(f"input {inp} is not a node of this graph")
            if inp.kind == "sink":
                raise GraphError("sinks have no output to consume")
        node = Node(
            id=len(self.nodes),
            name=name or f"{kind}{len(self.nodes)}",
            kind=kind,
            op=op,
            inputs=tuple(inputs),
            spec=spec,
        )
        self.nodes.append(node)
        for port, inp in enumerate(node.inputs):
            self._consumers.setdefault(inp.id, []).append((node, port))
        return node

    def source(self, name: str, spec: Spec = Spec()) -> Node:
        node = self._add(name, "source", None, (), spec)
        self.sources.append(node)
        return node

    def sink(self, input: Node, name: str) -> Node:
        node = self._add(name, "sink", None, (input,), input.spec)
        self.sinks.append(node)
        return node

    def loop(self, name: str, spec: Spec = Spec()) -> Node:
        """Declare a loop variable (a source-like node fed by a back-edge).

        Close it with :meth:`close_loop`; the scheduler then re-ticks the
        cyclic region until deltas quiesce (host-driven).
        """
        node = self._add(name, "loop", None, (), spec)
        self.loops.append(node)
        return node

    def close_loop(self, loop: Node, result: Node, *,
                   defer_passes: Optional[int] = None) -> None:
        """Close a loop's back-edge. ``defer_passes`` opts the region into
        cross-tick residual deferral: a device fixpoint program may stop
        after that many passes per tick, carrying the un-propagated loop
        deltas (as dense linear observables) into the next tick instead
        of iterating to quiescence. Amortizes convergence across a churn
        stream at a documented accuracy trade (docs/guide.md "Deferred
        fixpoint"); ``DirtyScheduler.drain`` flushes the residue."""
        if loop.kind != "loop":
            raise GraphError(f"{loop} is not a loop node")
        if loop.back_input is not None:
            raise GraphError(f"{loop} already closed")
        if result not in self.nodes:
            raise GraphError(f"{result} is not a node of this graph")
        if defer_passes is not None and defer_passes < 1:
            raise GraphError(f"defer_passes must be >= 1, got {defer_passes}")
        loop.back_input = result
        loop.defer_passes = defer_passes

    # op sugar -------------------------------------------------------------

    def add_op(self, op: Op, inputs: Sequence[Node], name: Optional[str] = None,
               spec: Optional[Spec] = None) -> Node:
        if len(inputs) != op.arity:
            raise GraphError(
                f"{op!r} expects {op.arity} inputs, got {len(inputs)}")
        out = spec if spec is not None else op.out_spec([n.spec for n in inputs])
        return self._add(name, "op", op, inputs, out)

    def map(self, input: Node, fn: Callable, *, vectorized: bool = False,
            linear: bool = False, name: Optional[str] = None,
            spec: Optional[Spec] = None, params=None,
            param_specs=None) -> Node:
        op = Map(fn, vectorized=vectorized, linear=linear, out_spec=spec,
                 params=params, param_specs=param_specs)
        return self.add_op(op, [input], name=name)

    def filter(self, input: Node, pred: Callable, *, vectorized: bool = False,
               name: Optional[str] = None) -> Node:
        return self.add_op(Filter(pred, vectorized=vectorized), [input], name=name)

    def group_by(self, input: Node, key_fn: Callable,
                 value_fn: Optional[Callable] = None, *, vectorized: bool = False,
                 name: Optional[str] = None, spec: Optional[Spec] = None,
                 stable_key: bool = False) -> Node:
        op = GroupBy(key_fn, value_fn, vectorized=vectorized, out_spec=spec,
                     stable_key=stable_key)
        return self.add_op(op, [input], name=name)

    def reduce(self, input: Node, how: str = "sum", *, tol: float = 0.0,
               name: Optional[str] = None, spec: Optional[Spec] = None,
               candidates: int = 8) -> Node:
        op = Reduce(how, tol=tol, out_spec=spec, candidates=candidates)
        return self.add_op(op, [input], name=name)

    def join(self, left: Node, right: Node, merge: Optional[Callable] = None,
             *, name: Optional[str] = None, spec: Optional[Spec] = None,
             arena_capacity: int = 1 << 16,
             linear_left: bool = False,
             left_arena_capacity: Optional[int] = None,
             product_slack: int = 4) -> Node:
        op = Join(merge, out_spec=spec, arena_capacity=arena_capacity,
                  linear_left=linear_left,
                  left_arena_capacity=left_arena_capacity,
                  product_slack=product_slack)
        return self.add_op(op, [left, right], name=name)

    def union(self, *inputs: Node, name: Optional[str] = None) -> Node:
        return self.add_op(Union(arity=len(inputs)), list(inputs), name=name)

    def knn(self, queries: Node, docs: Node, k: int, dim: int, *,
            name: Optional[str] = None, scan_chunk: int = 8192,
            precision: str = "highest") -> Node:
        op = KnnIndex(k, dim, scan_chunk=scan_chunk, precision=precision)
        return self.add_op(op, [queries, docs], name=name)

    # -- structure queries -------------------------------------------------

    def consumers(self, node: Node) -> List[Tuple[Node, int]]:
        """(consumer, input-port) pairs fed by ``node``'s output (DAG edges
        only; back-edges are reached via ``Node.back_input``)."""
        return self._consumers.get(node.id, [])

    def back_consumers(self, node: Node) -> List[Node]:
        return [l for l in self.loops if l.back_input is node]

    def topo_order(self) -> List[Node]:
        """Deterministic topological order ignoring back-edges.

        Node ids are assigned in construction order and inputs must already
        exist, so construction order *is* a topo order; we validate that
        invariant rather than re-sorting, keeping the order deterministic
        across runs (SURVEY.md §5: determinism in place of race detection).
        """
        for node in self.nodes:
            for inp in node.inputs:
                if inp.id >= node.id:
                    raise GraphError(
                        f"forward reference {inp} -> {node}; DAG edges must "
                        f"flow in construction order (use loop() for cycles)")
        return list(self.nodes)

    def validate(self) -> None:
        self.topo_order()
        for loop in self.loops:
            if loop.back_input is None:
                raise GraphError(f"{loop} was never closed (close_loop)")
        for sink in self.sinks:
            (inp,) = sink.inputs
            if inp.kind == "sink":
                raise GraphError("sink of sink")
        self._frozen = True

    def loop_region(self) -> List[Node]:
        """Nodes on a path loop -> ... -> back_input (the cyclic region)."""
        region: set = set()
        for loop in self.loops:
            if loop.back_input is None:
                continue
            reach_fwd = {loop.id}
            changed = True
            while changed:
                changed = False
                for n in self.nodes:
                    if n.id not in reach_fwd and any(i.id in reach_fwd for i in n.inputs):
                        reach_fwd.add(n.id)
                        changed = True
            back = {loop.back_input.id}
            changed = True
            while changed:
                changed = False
                for n in self.nodes:
                    if n.id in back:
                        for i in n.inputs:
                            if i.id not in back:
                                back.add(i.id)
                                changed = True
            region |= (reach_fwd & back) | {loop.id}
        return [n for n in self.nodes if n.id in region]
