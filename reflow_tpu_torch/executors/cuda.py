"""CudaExecutor: one tick pass as eager PyTorch over device tensors.

The counterpart of ``reflow_tpu/executors/tpu.py``'s ``TpuExecutor``:
delta buffers and operator state live on the device; host batches cross
at graph sources (``to_device``) and sinks (``to_host``); each pass runs
the dirty plan's lowerings in order (``executors/lowerings.py``).

What it leaves out, and why the scheduler does not miss it: PyTorch runs
eagerly, so there is no compiled-program cache; there is no on-device
fixpoint yet, so the scheduler's ``run_tick_fixpoint`` probe gets None;
and one card needs no ``place``. Op kinds without a ported lowering are refused at
:meth:`bind`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do): on the CPU every kernel wrapper takes its plain PyTorch
version, because the tensors it is given lie on the CPU.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence


from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.executors.base import Executor
from reflow_tpu_torch.executors.device_delta import (DeviceDelta,
                                                     resolve_device,
                                                     to_device, to_host)
from reflow_tpu_torch.executors.lowerings import (LOWERINGS, knn_state,
                                                  lower_node)
from reflow_tpu_torch.graph import FlowGraph, GraphError, Node
from reflow_tpu_torch.obs import trace as _trace

__all__ = ["CudaExecutor"]


class CudaExecutor(Executor):
    name = "cuda"

    def __init__(self, *, device=None):
        super().__init__()
        #: where state, uploads and every lowering run
        self.device = resolve_device(device)
        #: device->host scalar readbacks the lowerings made to decide a
        #: branch on the host (the k-NN full-vs-incremental choice); the
        #: scheduler folds them into its ``forced_syncs``
        self.host_syncs = 0

    def _note_sync(self) -> None:
        self.host_syncs += 1

    # -- bind: validate lowerability, build device state -------------------

    def bind(self, graph: FlowGraph) -> None:
        self.graph = graph
        self.states = {}
        for node in graph.nodes:
            if node.kind != "op":
                continue
            op = node.op
            if op.kind not in LOWERINGS:
                raise GraphError(
                    f"{node}: op kind {op.kind!r} is not ported yet to the "
                    f"cuda executor (ported: {sorted(LOWERINGS)}); run it "
                    f"on the cpu executor")
            in_specs = [i.spec for i in node.inputs]
            for s in in_specs:
                if s.key_space <= 0:
                    raise GraphError(
                        f"{node}: the device lowering needs key_space > 0 "
                        f"on every keyed-op input Spec")
            # op.kind == "knn", the one ported lowering
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
        states, egress = self.build_pass_fn(list(plan))(
            self.states, self._to_device_ingress(ingress))
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
        """No ported lowering carries a sticky error flag yet (the k-NN
        state has none), so there is nothing to check."""

    def read_table(self, node: Node):
        st = self.states.get(node.id)
        if st is None:
            raise KeyError(f"{node} holds no materialized state")
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
