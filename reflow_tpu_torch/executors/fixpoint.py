"""Whole-tick fixpoint: phase A, the loop over the cyclic region, the
exit pass — one executor call per tick.

The counterpart of ``reflow_tpu/executors/fixpoint.py``. The JAX package
lowers a tick of an iterative graph to one compiled program:

    phase A   one pass over the dirty plan (source ingest; sinks outside
              loop regions emit here),
    phase B   ``lax.while_loop`` over the cyclic region, the loop deltas
              as carry, with an on-device quiescence predicate,
    phase C   one "exit pass" over the nodes strictly downstream of the
              region, fed the *telescoped* boundary deltas.

**Design in the port: a host-checked loop with one readback a pass.**
PyTorch has no ``while_loop``, ``cond`` or ``switch``: a program cannot
branch on a device value without reading it back. So the loop runs on the
host, and each pass starts with ONE small packed readback (the live-row
count of the carry here; ``[live, base edges, tail edges, rows]`` in the
fused linear loop) that decides whether to run the pass and, in the
linear loop, which gather tier it takes. Everything else — the carry, the
state tables, the sticky error flags — stays on the device. A tick that
runs ``n`` loop passes reads back ``n + 1`` times (the last read sees the
carry dead, or the pass cap reached, and reports whether it converged).
Capturing each pass body as a CUDA graph would cut its launches, not the
readback; it is not done yet (ROADMAP).

Boundary telescoping (as in the JAX package): a consumer outside the
region would, under the host loop, receive one delta batch per pass.
Those per-pass emissions of a Reduce telescope, so their multiset sum
equals the diff of the Reduce's emitted table before phase B and after.
Every region-exit edge must therefore originate at a Reduce; otherwise
:func:`analyze` returns None and the scheduler drives the passes itself.

Left out, and why: ``_solve_carry_caps``, ``_pad_delta`` and
``_abstract_delta`` exist in the JAX package only to keep the
``while_loop`` carry's shapes stable across iterations; an eager loop
carries each pass's egress as it comes, at whatever capacity it has.

K ticks in one call (the window path): :func:`make_scan_program` runs a
tick program over the K slots of a ``[K, cap]`` ingress stack in an
eager loop, where JAX ``lax.scan``s it; both programs take it through
:class:`_MacroTickMixin.call_many`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.executors.lowerings import _differs
from reflow_tpu_torch.graph import FlowGraph, Node

__all__ = ["FixpointProgram", "FixpointStructure", "analyze",
           "collect_sink_egress", "make_scan_program", "slot_ingress"]


@dataclasses.dataclass(frozen=True)
class FixpointStructure:
    """Static decomposition of a graph for whole-tick fixpoint execution."""

    loops: Tuple[Node, ...]          # loop nodes (all have back_input)
    region_ids: frozenset            # the cyclic region (includes loops)
    loop_plan: Tuple[Node, ...]      # region nodes, topo order
    boundary: Tuple[Node, ...]       # region producers with outside consumers
    exit_plan: Tuple[Node, ...]      # non-region nodes downstream of boundary


def analyze(graph: FlowGraph) -> Optional[FixpointStructure]:
    """Static feasibility analysis; None = use the host-driven loop."""
    loops = tuple(l for l in graph.loops if l.back_input is not None)
    if not loops:
        return None
    region = graph.loop_region()
    region_ids = frozenset(n.id for n in region)
    for node in region:
        if (node.kind == "op" and node.op.kind == "join"
                and node.inputs[1].id in region_ids):
            # a loop-carried right (arena) input appends rows every pass;
            # only the host-driven loop tracks those appends
            return None
    boundary = []
    for node in region:
        if any(c.id not in region_ids for c, _ in graph.consumers(node)):
            boundary.append(node)
    for node in boundary:
        if node.kind != "op" or node.op.kind != "reduce":
            # only Reduce emissions telescope into a table diff
            return None
    # nodes strictly downstream of the boundary, outside the region
    downstream = set(n.id for n in boundary)
    exit_plan = []
    for node in graph.nodes:  # construction order == topo order
        if node.id in region_ids or node.id in downstream:
            continue
        if any(i.id in downstream for i in node.inputs):
            downstream.add(node.id)
            exit_plan.append(node)
    return FixpointStructure(
        loops=loops,
        region_ids=region_ids,
        loop_plan=tuple(n for n in region),
        boundary=tuple(boundary),
        exit_plan=tuple(exit_plan),
    )


def _emitted_diff(snap: Tuple[torch.Tensor, torch.Tensor], state: dict,
                  node: Node) -> DeviceDelta:
    """Telescoped boundary delta: diff of a Reduce's emitted table.

    Unchanged keys keep bit-identical stored values (the lowering writes
    through where-masks), so exact inequality is the right changed-test.
    """
    em_a, has_a = snap
    em_f, has_f = state["emitted"], state["emitted_has"]
    differ = _differs(em_a, em_f, 0.0)
    ret = has_a & (~has_f | differ)
    ins = has_f & (~has_a | differ)
    K = em_a.shape[0]
    keys = torch.arange(K, dtype=torch.int32, device=em_a.device)
    return DeviceDelta(
        keys=torch.cat([keys, keys]),
        values=torch.cat([em_a, em_f]),
        weights=torch.cat([-ret.to(torch.int32), ins.to(torch.int32)]),
    )


def snapshot_boundary(states, boundary: Sequence[Node]) -> dict:
    """The boundary Reduces' emitted tables after phase A, copied: the
    lowerings update some tables in place, so a reference would follow
    the loop's writes."""
    return {n.id: (states[n.id]["emitted"].clone(),
                   states[n.id]["emitted_has"].clone()) for n in boundary}


def run_exit_pass(exit_pass, states, snaps: dict, boundary: Sequence[Node]):
    """Phase C: the exit plan fed each boundary Reduce's table diff."""
    if exit_pass is None:
        return states, {}
    diffs = {n.id: _emitted_diff(snaps[n.id], states[n.id], n)
             for n in boundary}
    return exit_pass(states, diffs)


def collect_sink_egress(sink_ids: Sequence[int], eg_a: dict,
                        eg_b: dict) -> Dict[int, Tuple[DeviceDelta, ...]]:
    """Each sink's batches from phase A and the exit pass, in order."""
    out = {}
    for sid in sink_ids:
        batches = [eg[sid] for eg in (eg_a, eg_b) if sid in eg]
        if batches:
            out[sid] = tuple(batches)
    return out


def slot_ingress(ing_stack: Dict[int, DeviceDelta], t: int
                 ) -> Dict[int, DeviceDelta]:
    """Tick ``t``'s ingress: a view of slot ``t`` of every source's
    ``[K, cap]`` stack (no copy)."""
    return {nid: DeviceDelta(d.keys[t], d.values[t], d.weights[t])
            for nid, d in ing_stack.items()}


def make_scan_program(tick_fn):
    """K consecutive ticks in ONE call: the window path's tick loop.

    ``tick_fn(states, ingress)`` is one tick with the program call
    contract ``-> (states', sink_egress, carry, iters, rows, converged)``.
    The JAX package ``lax.scan``s it over the K stacked ingress pytrees
    inside one jit; here an eager loop runs it over views of the K slots
    of the ``[K, cap]`` stack, all on one stream. Sink-free graphs only
    (the caller guards): per-tick sink egress would need per-tick host
    materialization.

    As in the scan, each tick's carry is dropped before the next tick: a
    tick of the row program that halts at ``max_iters`` does not resume
    inside a window; its converged flag comes back False.

    Returns ``scan_fn(states, ing_stack, n_ticks) -> (states',
    (iters[K], rows[K], converged[K]), stack)``. The loop already reads
    each tick's three scalars on the host; they are uploaded again as
    ``[K]`` tensors on the stack's device only so that the result has
    the form of JAX's scan outputs, and ``block()`` reads them back (one
    small copy each way a window). The stack comes back as it went in
    (nothing is donated in PyTorch): the ingress queue re-adopts it at
    retire.
    """

    def scan_fn(op_states, ing_stack, n_ticks: int):
        states = op_states
        ys = []
        for t in range(n_ticks):
            states, sink_eg, _carry, iters, rows, conv = tick_fn(
                states, slot_ingress(ing_stack, t))
            if sink_eg:
                raise RuntimeError("macro-tick requires a sink-free graph")
            ys.append((int(iters), int(rows), bool(conv)))
        dev = next(iter(ing_stack.values())).keys.device
        cols = list(zip(*ys)) if ys else [(), (), ()]
        return states, (
            torch.tensor(cols[0], dtype=torch.int32, device=dev),
            torch.tensor(cols[1], dtype=torch.int64, device=dev),
            torch.tensor(cols[2], dtype=torch.bool, device=dev)), ing_stack

    return scan_fn


class _MacroTickMixin:
    """Shared macro-tick entry for the two fixpoint program kinds (both
    have the call contract ``(states, plan, ingress, max_iters)``)."""

    def call_many(self, op_states, plan: Sequence[Node],
                  ing_stack: Dict[int, DeviceDelta], n_ticks: int,
                  max_iters: int):
        """-> (states', (iters[K], rows[K], converged[K]), stack). The
        state a tick leaves (the fused loop's CSR cache included) is the
        next tick's, exactly as K single-tick calls thread it."""
        return make_scan_program(
            lambda st, ing: self(st, plan, ing, max_iters))(
                op_states, ing_stack, n_ticks)


class FixpointProgram(_MacroTickMixin):
    """One tick of the row-based fixpoint: phase A pass, the host-checked
    loop over the region's row lowerings, the exit pass.

    Built once per bound graph (the port compiles nothing, so a program
    depends only on the graph's structure); the dirty plan is an argument
    of each call.
    """

    def __init__(self, executor, *, structure: FixpointStructure):
        graph = executor.graph
        self.structure = structure
        self.sink_ids = [s.id for s in graph.sinks]
        self._executor = executor
        self._body_pass = executor.build_pass_fn(list(structure.loop_plan))
        self._exit_pass = (executor.build_pass_fn(list(structure.exit_plan))
                           if structure.exit_plan else None)

    def __call__(self, op_states, plan: Sequence[Node],
                 dev_ingress: Dict[int, DeviceDelta], max_iters: int):
        """-> (states', {sink_id: (DeviceDelta, ...)}, {loop_id: carry},
        iters, loop_rows, converged), all but the tensors host values.
        The carry is the live loop delta a ``max_iters`` halt leaves in
        flight (the scheduler stashes it, so the next tick resumes)."""
        ex, st = self._executor, self.structure
        states, eg_a = ex.build_pass_fn(list(plan))(op_states, dev_ingress)
        carry = {l.id: eg_a[l.id] for l in st.loops if l.id in eg_a}
        snaps = snapshot_boundary(states, st.boundary)

        iters = rows = 0
        while True:
            # the pass's one readback: the carry's live-row count
            live = (ex.read_scalars(torch.stack(
                [torch.count_nonzero(d.weights) for d in carry.values()]
            ).sum().reshape(1))[0] if carry else 0)
            if live == 0 or iters >= max_iters:
                break
            rows += live
            states, eg = self._body_pass(states, carry)
            carry = {lid: eg[lid] for lid in carry if lid in eg}
            iters += 1
        converged = live == 0

        states, eg_b = run_exit_pass(self._exit_pass, states, snaps,
                                     st.boundary)
        sink_egress = collect_sink_egress(self.sink_ids, eg_a, eg_b)
        return (states, sink_egress, {} if converged else carry, iters,
                rows, converged)
