"""CudaExecutor: one tick pass as eager PyTorch over device tensors.

The counterpart of ``reflow_tpu/executors/tpu.py``'s ``TpuExecutor``:
delta buffers and operator state live on the device; host batches cross
at graph sources (``to_device``) and sinks (``to_host``); each pass runs
the dirty plan's lowerings in order (``executors/lowerings.py``).

What it leaves out, and why the scheduler does not miss it: PyTorch runs
eagerly, so there is no compiled-program cache; there is no on-device
fixpoint yet, so the scheduler's ``run_tick_fixpoint`` probe gets None
and the scheduler drives an iterative graph's passes itself, one
``run_pass`` per pass with one scalar readback per pass for its
quiescence test (the JAX ``TpuExecutor(fixpoint=False)`` loop); and one
card needs no ``place``.

Refused at :meth:`bind` with "not ported yet": op kinds without a
lowering, min/max reducers, the multiset-left Join (a left input whose
Spec is not unique), Map ``params``, and loops with ``defer_passes``
(their residual state belongs to the fused loop).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do): on the CPU every kernel wrapper takes its plain PyTorch
version, because the tensors it is given lie on the CPU.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch

from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.executors.arena import propagate_plan_caps
from reflow_tpu_torch.executors.base import Executor
from reflow_tpu_torch.executors.device_delta import (DeviceDelta,
                                                     resolve_device,
                                                     to_device, to_host)
from reflow_tpu_torch.executors.lowerings import (LINEAR_DEVICE_REDUCERS,
                                                  LOWERINGS, join_state,
                                                  knn_state, lower_node,
                                                  reduce_state)
from reflow_tpu_torch.graph import FlowGraph, GraphError, Node
from reflow_tpu_torch.obs import trace as _trace

__all__ = ["CudaExecutor"]

#: op kinds whose lowering keeps no state
_STATELESS = ("map", "filter", "groupby", "union")
#: what a set sticky ``error`` flag means (only the Join's state has one)
_ERROR_REASON = ("join sticky error: the arena overflowed (live rows + "
                 "appends exceeded capacity even after compaction — raise "
                 "arena_capacity); this tick's state is invalid")


class CudaExecutor(Executor):
    name = "cuda"

    def __init__(self, *, device=None):
        super().__init__()
        #: where state, uploads and every lowering run
        self.device = resolve_device(device)
        #: device->host scalar readbacks the lowerings made to decide a
        #: branch on the host (the k-NN full-vs-incremental choice, the
        #: Join's compact-before-append check); the scheduler folds them
        #: into its ``forced_syncs``
        self.host_syncs = 0

    def _note_sync(self) -> None:
        self.host_syncs += 1

    # -- bind: validate lowerability, build device state -------------------

    def bind(self, graph: FlowGraph) -> None:
        self.graph = graph
        self.states = {}
        for loop in graph.loops:
            if loop.defer_passes:
                raise GraphError(
                    f"{loop}: defer_passes (cross-tick residual deferral "
                    f"in the fused loop) is not ported yet to the cuda "
                    f"executor")
        for node in graph.nodes:
            if node.kind != "op":
                continue
            self._bind_op(node)

    def _bind_op(self, node: Node) -> None:
        op = node.op
        if op.kind not in LOWERINGS:
            raise GraphError(
                f"{node}: op kind {op.kind!r} is not ported yet to the "
                f"cuda executor (ported: {sorted(LOWERINGS)}); run it "
                f"on the cpu executor")
        if op.kind == "map" and op.params is not None:
            raise GraphError(f"{node}: Map params are not ported yet to "
                             f"the cuda executor")
        if op.kind in _STATELESS:
            return
        in_specs = [i.spec for i in node.inputs]
        for s in in_specs:
            if s.key_space <= 0:
                raise GraphError(
                    f"{node}: the device lowering needs key_space > 0 "
                    f"on every keyed-op input Spec")
        if op.kind == "reduce":
            if op.how not in LINEAR_DEVICE_REDUCERS:
                raise GraphError(
                    f"{node}: reducer {op.how!r} is not ported yet to the "
                    f"cuda executor (ported: {LINEAR_DEVICE_REDUCERS}); run "
                    f"it on the cpu executor")
            self.states[node.id] = reduce_state(in_specs[0], node.spec,
                                                self.device)
        elif op.kind == "join":
            if not in_specs[0].unique:
                raise GraphError(
                    f"{node}: the multiset-left join (left Spec not "
                    f"unique) is not ported yet to the cuda executor")
            if op.merge is None:
                # the default merge lowers to the flattened concatenation
                # of (va, vb); the out Spec must size it
                flat = (int(np.prod(in_specs[0].value_shape or (1,)))
                        + int(np.prod(in_specs[1].value_shape or (1,))))
                got = int(np.prod(node.spec.value_shape or (1,)))
                if got != flat:
                    raise GraphError(
                        f"{node}: default-merge device Join needs a spec "
                        f"with {flat} flat value elements (va ++ vb), got "
                        f"{node.spec.value_shape}")
            self.states[node.id] = join_state(op, in_specs[0], in_specs[1],
                                              self.device)
        else:  # knn
            for port, s in enumerate(in_specs):
                if tuple(s.value_shape) != (op.dim,):
                    raise GraphError(
                        f"{node}: knn input {port} value_shape "
                        f"{s.value_shape} != (dim={op.dim},)")
            D = in_specs[1].key_space
            if D > op.scan_chunk and D % op.scan_chunk:
                raise GraphError(
                    f"{node}: corpus key_space {D} must be a multiple "
                    f"of scan_chunk {op.scan_chunk}")
            self.states[node.id] = knn_state(op, *in_specs, self.device)

    # -- one pass ----------------------------------------------------------

    def _to_device_ingress(self, ingress) -> Dict[int, DeviceDelta]:
        """Host boundary in: upload host batches; pass device ones
        through (moved onto this executor's device if they are not)."""
        dev_ingress: Dict[int, DeviceDelta] = {}
        for nid, b in ingress.items():
            if isinstance(b, DeviceDelta):
                dev_ingress[nid] = DeviceDelta(*(t.to(self.device)
                                                 for t in b))
            else:
                dev_ingress[nid] = to_device(b, self.graph.nodes[nid].spec,
                                             device=self.device)
        return dev_ingress

    def run_pass(self, plan: Sequence[Node],
                 ingress: Dict[int, DeltaBatch]) -> Dict[int, object]:
        t0 = time.perf_counter() if _trace.ENABLED else 0.0
        dev_ingress = self._to_device_ingress(ingress)
        # fail loudly BEFORE an append could be truncated
        self._track_arena(plan, {nid: d.capacity
                                 for nid, d in dev_ingress.items()})
        states, egress = self.build_pass_fn(list(plan))(
            self.states, dev_ingress)
        self.states = states
        if _trace.ENABLED:
            _trace.evt("device_dispatch", t0, time.perf_counter() - t0,
                       args={"kind": "pass", "device": str(self.device)})
        # everything stays device-resident: sink batches are materialized
        # by the scheduler once per tick
        return egress

    def build_pass_fn(self, plan: Sequence[Node]):
        """The pass over ``plan``: ``(states, ingress) -> (states',
        egress)`` over DeviceDelta inputs. Ingress seeds any node's output
        (sources/loops); sink inputs and loop back-edges are returned."""
        graph = self.graph
        sink_inputs = [(s.inputs[0].id, s.id) for s in graph.sinks]
        back_edges = [(l.back_input.id, l.id) for l in graph.loops
                      if l.back_input is not None]

        def pass_fn(states, ingress):
            outs: Dict[int, DeviceDelta] = dict(ingress)
            new_states = dict(states)
            for node in plan:
                if node.id in outs or node.kind in ("source", "loop",
                                                    "sink"):
                    continue
                ins = [outs.get(i.id) for i in node.inputs]
                if all(x is None for x in ins):
                    continue
                out, st = lower_node(node, new_states.get(node.id), ins,
                                     on_sync=self._note_sync)
                if st is not None:
                    new_states[node.id] = st
                outs[node.id] = out
            egress: Dict[int, DeviceDelta] = {}
            for src_id, sink_id in sink_inputs:
                if src_id in outs:
                    egress[sink_id] = outs[src_id]
            for back_id, loop_id in back_edges:
                if back_id in outs:
                    egress[loop_id] = outs[back_id]
            return new_states, egress

        return pass_fn

    # -- host boundary out -------------------------------------------------

    def materialize(self, batch) -> DeltaBatch:
        if isinstance(batch, DeviceDelta):
            self.materialize_count += 1
            return to_host(batch)
        return batch

    def check_errors(self) -> None:
        """Raise if a state's sticky ``error`` flag is set (the Join's arena
        overflow). All flags come back in one readback."""
        flagged = [(nid, st["error"]) for nid, st in self.states.items()
                   if "error" in st]
        if not flagged:
            return
        vals = torch.stack([e for _, e in flagged]).cpu().tolist()
        for (nid, _), v in zip(flagged, vals):
            if v:
                raise RuntimeError(f"{self.graph.nodes[nid]}: {_ERROR_REASON}")

    def _track_arena(self, plan, ingress_caps: Dict[int, int]) -> None:
        """Static per-pass capacity sanity for Join arenas: reject one
        pass's right-delta capacity exceeding the whole arena. The dynamic
        high-water check is the Join lowering's (compact, else the sticky
        error)."""
        propagate_plan_caps(plan, ingress_caps)

    def read_table(self, node: Node):
        st = self.states.get(node.id)
        if st is None:
            raise KeyError(f"{node} holds no materialized state")
        if node.op.kind in ("reduce", "join"):
            if "error" in st and bool(st["error"]):
                raise RuntimeError(f"{node}: {_ERROR_REASON}")
            if node.op.kind == "reduce":
                keys = st["emitted_has"].cpu().numpy().nonzero()[0]
                vals = st["emitted"]
            else:
                keys = (st["lw"] > 0).cpu().numpy().nonzero()[0]
                vals = st["lval"]
            vals = vals.float() if vals.dtype == torch.bfloat16 else vals
            vals = vals.cpu().numpy()
            return {int(k): vals[k] if vals.ndim > 1 else vals[k].item()
                    for k in keys}
        if node.op.kind == "knn":
            has = st["em_has"].cpu().numpy()
            rows = st["emitted"].cpu().numpy()
            return {int(q): rows[q] for q in has.nonzero()[0]}
        raise KeyError(f"{node} ({node.op.kind}) has no table to read")

    # -- checkpoint seam ---------------------------------------------------

    def state_snapshot(self) -> Dict[int, object]:
        """A copy of every node's state tensors, on the device (lowerings
        update some tables in place, so a reference would be overwritten
        by the next tick)."""
        return {nid: {k: t.clone() for k, t in st.items()}
                for nid, st in self.states.items()}

    def state_restore(self, snapshot: Dict[int, object]) -> None:
        """Adopt a snapshot (cloned onto this executor's device, so the
        snapshot stays valid for another restore)."""
        self.states = {nid: {k: t.to(self.device, copy=True)
                             for k, t in st.items()}
                       for nid, st in snapshot.items()}
