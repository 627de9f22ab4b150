"""Topo-partitioned execution: FlowGraph stages on separate devices.

The counterpart of ``reflow_tpu/parallel/topo.py``'s
``StagedTpuExecutor``. ``Node.stage`` assigns each operator to a
contiguous topological stage; :class:`StagedCudaExecutor` runs ONE pass
per stage a pass of the tick, pins each stage's operator state to its
stage's device, and hands the deltas crossing a stage boundary to the
next stage's device with ``.to(device)``.

Devices: ``devices`` lists them (stage ``i`` of the sorted stage list
takes ``devices[i % len(devices)]``). By default they are the machine's
cards — on a machine with one card every stage sits on ``cuda:0``, so
the staged executor's value there is the partitioning itself, not
overlap — or ``[cpu]`` with ``device="cpu"``. Where stages sit on
different cards, the launches of stage ``s`` of a tick and stage ``s -
1`` of the next run on different devices' streams, so the host's
in-order dispatch pipelines them (the JAX package's argument, with CUDA
streams for XLA's async dispatch).

Validation at bind (as in the JAX package): every DAG edge must be
stage-monotone, and a loop's cyclic region must live inside one stage.
Unassigned ops take stage 0; sources and loops ride with their first
consumer, sinks with their producer. The whole-tick fixpoint programs
fuse a tick onto one device, so staged graphs with loops take the
scheduler's host-driven loop (``fixpoint=False``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.executors.cuda import CudaExecutor
from reflow_tpu_torch.executors.device_delta import (DeviceDelta,
                                                     devices_of,
                                                     resolve_device,
                                                     to_device)
from reflow_tpu_torch.graph import FlowGraph, GraphError, Node
from reflow_tpu_torch.utils.tree import tree_map

__all__ = ["StagedCudaExecutor"]


class StagedCudaExecutor(CudaExecutor):
    name = "staged"

    def __init__(self, devices: Optional[Sequence] = None, *, device=None):
        if devices is not None:
            devs = [resolve_device(d) for d in devices]
        elif device is not None:
            devs = [resolve_device(device)]
        else:
            devs = devices_of("cuda")
        if not devs:
            raise GraphError("a staged executor needs at least one device")
        super().__init__(device=devs[0], fixpoint=False,
                         linear_fixpoint=False)
        self._devices: List[torch.device] = devs
        self._stage_of: Dict[int, int] = {}
        self._dev: Dict[int, torch.device] = {}
        self._boundary_of: Dict[int, List[int]] = {}
        self._stage_fns: Dict[tuple, object] = {}

    def fresh(self) -> "StagedCudaExecutor":
        return type(self)(self._devices)

    def place(self, device) -> None:
        """A staged executor's stages sit on their own devices; it cannot
        be moved as a whole."""
        raise GraphError("StagedCudaExecutor pins each stage to its own "
                         "device and cannot be placed on one device")

    @property
    def stage_devices(self) -> Dict[int, torch.device]:
        """Stage -> the device its state and pass live on."""
        return dict(self._dev)

    def stage_of(self, node: Node) -> int:
        return self._stage_of[node.id]

    # -- bind: stage assignment, validation, per-stage placement ------------

    def bind(self, graph: FlowGraph) -> None:
        super().bind(graph)
        self._stage_fns = {}
        stage_of: Dict[int, int] = {}
        for node in graph.nodes:
            if node.kind == "op":
                stage_of[node.id] = node.stage if node.stage is not None else 0
        for node in graph.nodes:
            if node.kind in ("source", "loop"):
                cons = [stage_of.get(c.id, 0)
                        for c, _ in graph.consumers(node)]
                stage_of[node.id] = min(cons) if cons else 0
            elif node.kind == "sink":
                stage_of[node.id] = stage_of.get(node.inputs[0].id, 0)
        for node in graph.nodes:
            for inp in node.inputs:
                if stage_of[inp.id] > stage_of[node.id]:
                    raise GraphError(
                        f"edge {inp} -> {node} goes backwards in stages "
                        f"({stage_of[inp.id]} -> {stage_of[node.id]}); "
                        f"stages must be monotone along dataflow edges")
        for loop in graph.loops:
            if loop.back_input is None:
                continue
            region = self._cyclic_region(graph, loop)
            stages = {stage_of[nid] for nid in region}
            if len(stages) > 1:
                raise GraphError(
                    f"{loop}'s cyclic region spans stages {sorted(stages)}; "
                    f"a fixpoint region must live inside one stage")
        self._stage_of = stage_of
        stage_list = sorted(set(stage_of.values()))
        self._dev = {s: self._devices[i % len(self._devices)]
                     for i, s in enumerate(stage_list)}
        for nid, st in list(self.states.items()):
            dev = self._dev[stage_of[nid]]
            self.states[nid] = tree_map(
                lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t,
                st)
        # nodes with a consumer in a LATER stage are returned by their
        # stage's pass (the boundary handoff)
        self._boundary_of = {s: [] for s in stage_list}
        for node in graph.nodes:
            if node.kind == "sink":
                continue
            s = stage_of[node.id]
            if any(stage_of[c.id] > s for c, _ in graph.consumers(node)):
                self._boundary_of[s].append(node.id)

    @staticmethod
    def _cyclic_region(graph: FlowGraph, loop: Node) -> set:
        fwd = {loop.id}
        changed = True
        while changed:
            changed = False
            for nd in graph.nodes:
                if nd.id not in fwd and any(i.id in fwd for i in nd.inputs):
                    fwd.add(nd.id)
                    changed = True
        back = {loop.back_input.id}
        changed = True
        while changed:
            changed = False
            for nd in graph.nodes:
                if nd.id in back:
                    for i in nd.inputs:
                        if i.id not in back:
                            back.add(i.id)
                            changed = True
        return (fwd & back) | {loop.id}

    # -- the staged pass -----------------------------------------------------

    def run_pass(self, plan: Sequence[Node],
                 ingress: Dict[int, DeltaBatch]) -> Dict[int, object]:
        stage_of = self._stage_of
        dev_ingress: Dict[int, DeviceDelta] = {}
        for nid, b in ingress.items():
            dev = self._dev[stage_of[nid]]
            if isinstance(b, DeviceDelta):
                dev_ingress[nid] = DeviceDelta(*(t.to(dev) for t in b))
            else:
                # uploads land directly on the consuming stage's device
                node = self.graph.nodes[nid]
                dev_ingress[nid] = to_device(
                    b, node.spec, device=dev,
                    source=f"source {node.name!r}")
        self._track_arena(plan, {nid: d.capacity
                                 for nid, d in dev_ingress.items()})

        outs: Dict[int, DeviceDelta] = dict(dev_ingress)
        egress: Dict[int, object] = {}
        out_ids = ({s.id for s in self.graph.sinks}
                   | {l.id for l in self.graph.loops
                      if l.back_input is not None})
        for s, dev in sorted(self._dev.items()):
            sub = [n for n in plan if stage_of[n.id] == s]
            if not sub:
                continue
            # seeds: ingress or an earlier stage's boundary egress this
            # stage consumes, moved to its device (the handoff)
            need = {i.id for n in sub for i in n.inputs} | {n.id for n in sub}
            seeds = {nid: DeviceDelta(*(t.to(dev) for t in d))
                     for nid, d in outs.items() if nid in need}
            if not seeds:
                continue
            key = (s, tuple(n.id for n in sub))
            fn = self._stage_fns.get(key)
            if fn is None:
                fn = self._stage_fns[key] = self.build_pass_fn(
                    sub, self._boundary_of[s])
            stage_states = {nid: st for nid, st in self.states.items()
                            if stage_of[nid] == s}
            new_states, stage_eg = fn(stage_states, seeds)
            self.states.update(new_states)
            for nid, d in stage_eg.items():
                if nid in out_ids:
                    egress[nid] = d
                else:
                    outs[nid] = d          # boundary -> later stages
        return egress
