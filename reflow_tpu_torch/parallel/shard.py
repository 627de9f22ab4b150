"""ShardedCudaExecutor: the tick pass as an SPMD program over a mesh.

The counterpart of ``reflow_tpu/parallel/shard.py``'s
``ShardedTpuExecutor``. Delta buffers are row-sharded over the mesh,
keyed state tables key-range-sharded, and the cross-shard combines are
explicit collectives of the port's SPMD runtime (``parallel/spmd.py``):
``psum_scatter``/``all_to_all`` row routing in Reduce and Join, ``pmax``
in min/max, the ``ppermute`` ring merge in k-NN
(``parallel/shard_lowerings.py``). Each process steps its own shards
with one host thread, each shard's body a generator.

**State layout.** Each shard holds its own state tree on its own device
(``_shards``, one ``{node id: tree}`` dict per shard this process steps,
in rank order). A key-sharded leaf holds the shard's slice of dim 0; a
replicated leaf (Map params, the k-NN's query tables and emitted table)
a full copy per shard — the lowerings update tables in place, so no two
shards may share a tensor. One function decides which leaf is which
(:meth:`_leaf_sharded`, the JAX package's ``_state_tree_specs``): a
leaf shards when its dim 0 divides the data size, except Map params and
the k-NN's replicated tables. It runs once, where a global tree is
placed, and its answer is the node's layout, which every later gather
and scatter follows. The Join's per-shard append counters and
arena generations ride as data-length vectors (a ``[1]`` slice per
shard), as in the JAX package.

**The model axis** (``model_axis=``, a (delta, model) mesh): the data
axis is the mesh's other axes, so ``n`` counts data shards. A Map with
``param_specs`` holds on shard (d, m) slice m of each leaf its
:class:`~reflow_tpu_torch.parallel.mesh.PartSpec` splits over the model
axis, and its function yields its own psums over that axis
(``models.vit.vit_forward_tp``). Every other state is keyed over the
data axis and replicated across the model axis: each member of a model
group holds its own copy of the group's tables and runs the same
lowerings on the same delta slice; the region's output is read from
model index 0.

``states`` is a view of the GLOBAL tree: reading a node gathers it
(sharded leaves concatenated in data order onto the first shard's
device, tensor-parallel params joined along their split dims, replicated
leaves from the first shard, a sticky ``error`` flag OR-ed over the
shards), assigning a node or the whole dict scatters. So ``read_table``,
``state_snapshot``/``state_restore``, the checkpoint, the WAL and the
replica paths see the tree a single-device executor holds. The programs
themselves thread the per-shard list (:meth:`_op_states`).

**A mesh across processes** (``make_mesh(dcn=process_count())``): the
executor holds and updates only this process's shards, and everything
it shows is this process's part, as a JAX array's addressable shards
are. ``states`` and the checkpoint read and write the process-local
tree (key-sharded leaves: this process's key ranges); ``read_table``
gives the owned keys (global ids); a device batch pushed (one from
``shard_batch_process_local``) is this process's rows, while a host
``DeltaBatch`` is global — every process pushes the same one and each
takes its shards' slices. Every host branch (the k-NN path, a loop's
quiescence, the fused loop's tiers, the error check, and the
scheduler's next pass and sink materialization through
:meth:`live_anywhere`) reads every process's flags through one
exchange, so all processes take it alike.

**The window path** (``tick_many``, ``stage_window`` -> ``dispatch_window``
-> ``retire_window``, the serve pump at any depth) runs on every mesh, as
the JAX package's does. The ingress queue splits a slot over the data
shards only: the members of a model group share their data shard's
buffer, and on a mesh across processes each process holds only its own
data shards' slots, filled from the global host batch every process
writes alike (``executors/ingress_queue.py``). A window's ticks are the
same regions as the per-tick path's (the loop-free pass, the fixpoint
tick with its ``host_gather`` branches), so every process runs the
window's passes in step.

**Passes and ticks.** A pass (and a whole fixpoint tick, see
``executors/fixpoint.py``) is one SPMD region: the ingress batches are
split into row slices (views on one device), every shard runs the
shared traversal with the shard-aware lowerings, and the shards' egress
slices are concatenated back into one batch. A host branch that must be
uniform reads every shard's flag in one readback.

**Divisibility contract** (checked at bind): the data size is a power
of two no larger than the minimum delta capacity, so every bucketed
delta capacity splits evenly; every keyed op's key space, every Join's
arena (and left arena) and the k-NN's query and corpus spaces are
multiples of the data size; the k-NN's per-shard corpus is a multiple
of its scan chunk; the model axis divides every dim a ``PartSpec``
splits.
"""

from __future__ import annotations

from collections.abc import Mapping, MutableMapping
from typing import Dict, List, Optional

import numpy as np
import torch

from reflow_tpu_torch.delta import torch_dtype
from reflow_tpu_torch.executors.cuda import CudaExecutor
from reflow_tpu_torch.executors.device_delta import (MIN_CAPACITY,
                                                     DeviceDelta,
                                                     ShardedDelta, to_device)
from reflow_tpu_torch.executors.lowerings import (LINEAR_DEVICE_REDUCERS,
                                                  minmax_refresh_core)
from reflow_tpu_torch.graph import FlowGraph, GraphError, Node
from reflow_tpu_torch.parallel import spmd
from reflow_tpu_torch.parallel.mesh import (Mesh, join_by_spec, make_mesh,
                                            slice_by_spec)
from reflow_tpu_torch.parallel.shard_lowerings import (deliver_to_owner,
                                                       knn_state_specs,
                                                       lower_node_sharded)
from reflow_tpu_torch.utils.tree import tree_map

__all__ = ["ShardedCudaExecutor"]

_ROUTE_REASON = ("a sparse-route overflow: key skew exceeded the "
                 "ROUTE_SLACK per-destination budget (raise the delta "
                 "capacity or rebalance the key space)")


class _GlobalStates(MutableMapping):
    """The executor's state as the global ``{node id: tree}`` dict (this
    process's part on a mesh across processes): reads gather, writes
    scatter (see the module docstring)."""

    def __init__(self, ex: "ShardedCudaExecutor"):
        self._ex = ex

    def __getitem__(self, nid):
        return self._ex._gather(nid)

    def __setitem__(self, nid, tree):
        self._ex._scatter(nid, tree)

    def __delitem__(self, nid):
        for sh in self._ex._shards:
            del sh[nid]
        self._ex._layout.pop(nid, None)

    def __iter__(self):
        return iter(list(self._ex._shards[0]))

    def __len__(self):
        return len(self._ex._shards[0])


class _LazyNode(Mapping):
    """One node's global tree for ``read_table``: a leaf is gathered only
    when read (a k-NN table read must not copy the corpus)."""

    def __init__(self, ex: "ShardedCudaExecutor", nid: int):
        self._ex, self._nid = ex, nid

    def __getitem__(self, key):
        return self._ex._gather(self._nid, (key,))[key]

    def __iter__(self):
        return iter(list(self._ex._shards[0][self._nid]))

    def __len__(self):
        return len(self._ex._shards[0][self._nid])


class ShardedCudaExecutor(CudaExecutor):
    name = "sharded"

    def __init__(self, mesh: Optional[Mesh] = None, *,
                 fixpoint: bool = True, linear_fixpoint: bool = True,
                 model_axis: Optional[str] = None):
        #: one shard per card by default
        self.mesh = mesh if mesh is not None else make_mesh()
        mesh = self.mesh
        #: the tensor-parallel axis: delta rows and keyed state shard over
        #: the other (data) axes and are replicated over this one; Map
        #: params with ``param_specs`` shard over it. None: every axis is
        #: a data axis.
        self.model_axis = model_axis
        names = mesh.axis_names
        if model_axis is not None:
            if model_axis not in names:
                raise GraphError(
                    f"model_axis {model_axis!r} not in mesh axes {names}")
            names = tuple(a for a in names if a != model_axis)
            if not names:
                raise GraphError("a pure-model mesh has no data axis; "
                                 "add a delta axis")
            if any(len({mesh.process_of(r) for r in g}) > 1
                   for g in mesh.groups((model_axis,))):
                raise GraphError(
                    f"model axis {model_axis!r}: each model group must "
                    f"lie within one process")
        #: a 2-axis (dcn, delta) data mesh shards over the flattened
        #: product axis, dcn-major
        self.axis = names[0] if len(names) == 1 else tuple(names)
        data = names if len(names) > 1 else (names[0],)
        #: data shards (the mesh size without a model axis)
        self.n = int(np.prod([mesh.shape[a] for a in data]))
        #: model shards (1 without a model axis)
        self.m = mesh.size // self.n
        #: per-axis extents of a 2-axis data mesh (the two-leg router)
        self._axis_sizes = (tuple(mesh.shape[a] for a in names)
                            if len(names) > 1 else None)
        if self.n & (self.n - 1) or self.n > MIN_CAPACITY:
            raise GraphError(
                f"data size {self.n} must be a power of two <= "
                f"{MIN_CAPACITY} so bucketed delta capacities shard evenly")
        #: each rank's data index and model index
        self._d = [mesh.axis_index(r, data) for r in range(mesh.size)]
        self._mi = ([mesh.axis_index(r, (model_axis,))
                     for r in range(mesh.size)] if model_axis is not None
                    else [0] * mesh.size)
        self._local: List[int] = list(mesh.local_ranks)
        self._pos = {r: i for i, r in enumerate(self._local)}
        #: the shards this process reads its outputs and its view from:
        #: model index 0, in data order (contiguous data ranks)
        self._view = sorted((r for r in self._local if self._mi[r] == 0),
                            key=lambda r: self._d[r])
        self._nv = len(self._view)
        self._vbase = self._d[self._view[0]]
        if [self._d[r] for r in self._view] != list(
                range(self._vbase, self._vbase + self._nv)):
            raise GraphError("this process's data shards must be a "
                             "contiguous block of data ranks")
        self._shards: List[dict] = [{} for _ in self._local]
        self._plain: Optional[dict] = None
        self._replicated_ids: frozenset = frozenset()
        self._knn_ids: frozenset = frozenset()
        #: tensor-parallel Map nodes: node id -> its params' PartSpec tree
        self._tp_specs: Dict[int, object] = {}
        #: node id -> the keys of its dim-0-sharded leaves (set at bind)
        self._layout: Dict[int, frozenset] = {}
        super().__init__(device=mesh.device_list[self._local[0]],
                         fixpoint=fixpoint, linear_fixpoint=linear_fixpoint)
        self._arena_divisor = self.n

    # -- the global view -----------------------------------------------------

    @property
    def states(self):
        if self._plain is not None:
            return self._plain
        return _GlobalStates(self)

    @states.setter
    def states(self, value):
        if self._plain is not None:
            self._plain = dict(value)
            return
        self._shards = [{} for _ in self._local]
        for nid, tree in dict(value).items():
            self._scatter(nid, tree)

    def _leaf_sharded(self, nid: int, key, shape) -> bool:
        """The one placement rule: does the leaf of global ``shape`` shard
        along dim 0?"""
        if nid in self._replicated_ids:
            return False
        if nid in self._knn_ids:
            return knn_state_specs()[key]
        return len(shape) >= 1 and shape[0] % self.n == 0

    def _sharded_key(self, nid: int, key) -> bool:
        """Is leaf ``key`` of node ``nid`` dim-0 sharded? The layout
        :meth:`_leaf_sharded` gave when the global tree was placed (at
        bind, or by ``update_params``) answers; a node placed no other
        way has none."""
        got = self._layout.get(nid)
        if got is None:
            raise GraphError(f"node {nid} has no state layout: bind the "
                             f"graph before placing its state")
        return key in got

    def _scatter(self, nid: int, tree, whole: bool = False) -> None:
        """Place one node's tree — the global one (``whole``) or this
        process's view of it — as a slice or a copy per local shard."""
        parts = self.n if whole else self._nv
        off = 0 if whole else self._vbase
        if (whole and isinstance(tree, dict) and nid not in self._tp_specs
                and nid not in self._replicated_ids):
            self._layout[nid] = frozenset(
                k for k, x in tree.items()
                if self._leaf_sharded(nid, k, tuple(x.shape)))
        for i, r in enumerate(self._local):
            dev = self.mesh.device_list[r]

            def copy(x, dev=dev):
                return (x.to(dev, copy=True) if isinstance(x, torch.Tensor)
                        else x)

            if nid in self._tp_specs:
                part = slice_by_spec(tree["params"], self._tp_specs[nid],
                                     self.model_axis, self.m, self._mi[r])
                self._shards[i][nid] = {"params": tree_map(copy, part)}
            elif isinstance(tree, dict) and nid not in self._replicated_ids:
                j = self._d[r] - off
                self._shards[i][nid] = {
                    k: (x.chunk(parts, 0)[j].to(dev, copy=True)
                        if self._sharded_key(nid, k)
                        else x.to(dev, copy=True))
                    for k, x in tree.items()}
            else:
                self._shards[i][nid] = tree_map(copy, tree)

    def _gather(self, nid: int, keys=None):
        """One node's global tree (its ``keys`` leaves only, when given),
        on the first shard's device; this process's part of it on a mesh
        across processes."""
        parts = [self._shards[self._pos[r]][nid] for r in self._view]
        if nid in self._tp_specs:
            d0 = self._d[self._view[0]]
            group = sorted((r for r in self._local if self._d[r] == d0),
                           key=lambda r: self._mi[r])
            return {"params": join_by_spec(
                [self._shards[self._pos[r]][nid]["params"] for r in group],
                self._tp_specs[nid], self.model_axis)}
        if not isinstance(parts[0], dict) or nid in self._replicated_ids:
            return parts[0]
        d0 = self.device
        out = {}
        for k, x in parts[0].items():
            if keys is not None and k not in keys:
                continue
            if self._sharded_key(nid, k):
                out[k] = torch.cat([p[k].to(d0) for p in parts])
            elif k == "error":
                out[k] = torch.stack([p[k].to(d0) for p in parts]).any()
            else:
                out[k] = x
        return out

    # -- executor surface ----------------------------------------------------

    def fresh(self) -> "ShardedCudaExecutor":
        return type(self)(self.mesh, fixpoint=self.fixpoint,
                          linear_fixpoint=self.linear_fixpoint,
                          model_axis=self.model_axis)

    def place(self, device) -> None:
        """A sharded executor spans its mesh and cannot be pinned to one
        device."""
        raise GraphError(
            "ShardedCudaExecutor spans the device mesh and cannot be "
            "placed on a single device; use the cuda executor with "
            "GraphConfig(device=...) / placement='spread' instead")

    @property
    def device_label(self) -> str:
        return f"mesh[{self.mesh.size}]"

    def _ingress_placement(self):
        # queue buffers shard their capacity axis over the data axis (a
        # model axis replicates; across processes, this process's data
        # shards only), so slot writes land shard-local
        return (self.mesh, self.axis)

    def _node_state(self, nid: int):
        if nid not in self._shards[0]:
            return None
        st = self._shards[0][nid]
        if (not isinstance(st, dict) or nid in self._replicated_ids
                or nid in self._tp_specs):
            return st
        return _LazyNode(self, nid)

    def read_table(self, node: Node):
        """As on one device; on a mesh across processes, this process's
        owned keys (global ids) of a keyed table, and the whole
        replicated k-NN table."""
        got = super().read_table(node)
        if not self.mesh.spans_processes or node.op.kind == "knn":
            return got
        base = self._vbase * (node.inputs[0].spec.key_space // self.n)
        return {k + base: v for k, v in got.items()}

    def _op_states(self):
        return [dict(sh) for sh in self._shards]

    def _set_op_states(self, states) -> None:
        self._shards = list(states)

    def _error_reason(self, node: Node) -> str:
        if (node.op.kind == "reduce"
                and node.op.how in LINEAR_DEVICE_REDUCERS):
            return (f"sticky device error flag set ({_ROUTE_REASON}); this "
                    f"tick's state is invalid")
        return f"{super()._error_reason(node)}; or {_ROUTE_REASON}"

    # -- bind ----------------------------------------------------------------

    def bind(self, graph: FlowGraph) -> None:
        self._plain = {}
        try:
            super().bind(graph)
            self._validate(graph)
            glob = self._plain
        finally:
            self._plain = None
        self._shards = [{} for _ in self._local]
        self._layout = {}
        for nid, tree in glob.items():
            self._scatter(nid, tree, whole=True)

    def _validate(self, graph: FlowGraph) -> None:
        """The divisibility contract, and the sharded-only state leaves
        (the route-overflow flag of linear Reduces; the Join's per-shard
        counters)."""
        n, dev = self.n, self.device
        maps = [node for node in graph.nodes
                if node.kind == "op" and node.op.kind == "map"
                and node.op.params is not None]
        tp = {node.id: node.op.param_specs for node in maps
              if node.op.param_specs is not None}
        if tp and self.model_axis is None:
            raise GraphError(
                f"{graph.nodes[next(iter(tp))]}: param_specs shard the "
                f"params over a model axis; run it on "
                f"ShardedCudaExecutor(mesh, model_axis=...)")
        self._tp_specs = tp
        self._replicated_ids = frozenset(node.id for node in maps
                                         if node.id not in tp)
        knn_ids = set()
        for loop in graph.loops:
            if loop.defer_passes and loop.spec.key_space % n:
                raise GraphError(
                    f"{loop}: key_space {loop.spec.key_space} must be a "
                    f"multiple of the mesh's data size {n}")
        for node in graph.nodes:
            if node.kind != "op":
                continue
            st = self._plain.get(node.id)
            if node.op.kind == "knn":
                Q = node.inputs[0].spec.key_space
                D = node.inputs[1].spec.key_space
                if Q % n or D % n:
                    raise GraphError(
                        f"{node}: query space {Q} and corpus space {D} "
                        f"must be multiples of the mesh's data size {n}")
                if (D // n) % min(node.op.scan_chunk, D // n):
                    raise GraphError(
                        f"{node}: per-shard corpus {D // n} must be a "
                        f"multiple of scan_chunk {node.op.scan_chunk}")
                knn_ids.add(node.id)
                continue
            if node.op.kind not in ("reduce", "join"):
                continue
            K = node.inputs[0].spec.key_space
            if K % n:
                raise GraphError(
                    f"{node}: key_space {K} must be a multiple of the "
                    f"mesh's data size {n} (round it up)")
            if node.op.kind == "reduce":
                if node.op.how in LINEAR_DEVICE_REDUCERS:
                    # the sticky route-overflow flag (never dropped)
                    st["error"] = torch.zeros((), dtype=torch.bool,
                                              device=dev)
                continue
            if node.op.arena_capacity % n:
                raise GraphError(
                    f"{node}: arena_capacity {node.op.arena_capacity} "
                    f"must be a multiple of the mesh's data size {n}")
            counters = ["rcount", "gen"]
            if "lkeys" in st:
                La = node.op.left_arena_capacity or node.op.arena_capacity
                if La % n:
                    raise GraphError(
                        f"{node}: left_arena_capacity {La} must be a "
                        f"multiple of the mesh's data size {n}")
                counters += ["lcount", "lgen"]
            for f in counters:
                st[f] = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._knn_ids = frozenset(knn_ids)

    def update_params(self, node: Node, params) -> None:
        """Swap a params-bearing Map's tree: a copy on every shard, or
        each shard's slice under its ``param_specs``."""
        if "params" not in self._shards[0].get(node.id, {}):
            raise GraphError(f"{node} holds no params state")
        self._scatter(node.id, {"params": self._copy_params(node, params)},
                      whole=True)

    # -- passes --------------------------------------------------------------

    def _to_device_ingress(self, ingress) -> Dict[int, object]:
        """Device batches pass through; a host batch is uploaded whole
        (on a mesh across processes it is global: this process keeps its
        shards' rows)."""
        out: Dict[int, object] = {}
        for nid, b in ingress.items():
            if isinstance(b, (DeviceDelta, ShardedDelta)):
                out[nid] = b
                continue
            node = self.graph.nodes[nid]
            d = to_device(b, node.spec, device=self.device,
                          source=f"source {node.name!r}")
            if self.mesh.spans_processes:
                per = d.capacity // self.n
                lo, hi = self._vbase * per, (self._vbase + self._nv) * per
                d = DeviceDelta(*(t[lo:hi] for t in d))
            out[nid] = d
        return out

    def _split(self, d) -> List[DeviceDelta]:
        """A batch as one row slice per local shard, each on its shard's
        device (views on one device): a global batch split over the data
        shards, or on a mesh across processes this process's rows split
        over its own. Members of a model group take the same slice."""
        devs = [self.mesh.device_list[r] for r in self._local]
        local = self.mesh.spans_processes
        parts_n = self._nv if local else self.n
        off = self._vbase if local else 0
        if isinstance(d, ShardedDelta):
            if len(d) == self.n:
                off = 0
            elif len(d) != parts_n:
                raise ValueError(f"a ShardedDelta of {len(d)} shards on a "
                                 f"mesh of {self.n} data shards")
            return [DeviceDelta(*(t.to(dv) for t in d[self._d[r] - off]))
                    for r, dv in zip(self._local, devs)]
        if d.capacity % parts_n:
            raise ValueError(f"delta capacity {d.capacity} is not a "
                             f"multiple of the {parts_n} data shards")
        cols = [t.chunk(parts_n, 0) for t in d]
        return [DeviceDelta(*(c[self._d[r] - off].to(dv) for c in cols))
                for r, dv in zip(self._local, devs)]

    def _combine(self, vals: list):
        """The view shards' outputs of a region as one value: deltas
        concatenated in data order, dicts and tuples element-wise, host
        scalars checked uniform."""
        v0 = vals[0]
        if isinstance(v0, DeviceDelta):
            d0 = self.device
            return DeviceDelta(*(torch.cat([v[i].to(d0) for v in vals])
                                 for i in range(3)))
        if isinstance(v0, dict):
            if any(set(v) != set(v0) for v in vals):
                raise spmd.SpmdMismatch("shards returned different keys")
            return {k: self._combine([v[k] for v in vals]) for k in v0}
        if isinstance(v0, tuple):
            return tuple(self._combine(list(x)) for x in zip(*vals))
        if any(v != v0 for v in vals[1:]):
            raise spmd.SpmdMismatch(f"shards disagree on a uniform value: "
                                    f"{vals}")
        return v0

    def run_region(self, body, op_states, dev_ingress, *args):
        """One SPMD region over this process's shards: ``body(ctx,
        shard_states, shard_ingress, *args)`` per shard; returns
        ``(per-shard states, *the rest combined)``."""
        parts = {nid: self._split(d) for nid, d in dev_ingress.items()}
        per = [(op_states[i], {nid: p[i] for nid, p in parts.items()})
               + tuple(args) for i in range(len(self._local))]
        outs = spmd.run(self.mesh, body, per, self.axis)
        view = [outs[self._pos[r]] for r in self._view]
        rest = [self._combine([o[i] for o in view])
                for i in range(1, len(outs[0]))]
        return ([o[0] for o in outs], *rest)

    def _lower(self, ctx, node: Node, state, ins):
        return (yield from lower_node_sharded(
            ctx, node, state, ins, self.axis, self.n,
            sizes=self._axis_sizes, reader=self.read_branch))

    # -- maintenance and errors ----------------------------------------------

    def refresh_minmax(self, node: Node, batch) -> None:
        """Sharded latch refresh: the replay rows reach their key's owner
        (the min/max routing policy), then the refresh core runs on each
        owned key slice."""
        d = self._to_device_ingress({node.inputs[0].id: batch})[
            node.inputs[0].id]
        K = node.inputs[0].spec.key_space
        n, axis, sizes = self.n, self.axis, self._axis_sizes
        Kl = K // n
        op = node.op
        oshape = tuple(node.spec.value_shape)
        odt = torch_dtype(node.spec.value_dtype)

        def body(ctx, st, dd):
            base = ctx.axis_index(axis) * Kl
            dl, route_err = yield from deliver_to_owner(ctx, dd, axis, n, Kl,
                                                        sizes)
            core = dict(st)
            core["error"] = st["error"] | route_err
            st2 = minmax_refresh_core(op, Kl, oshape, odt, core, dl,
                                      key_offset=base)
            e = yield ctx.pmax(st2["error"].to(torch.int32), axis)
            st2["error"] = e > 0
            return st2

        parts = self._split(d)
        outs = spmd.run(self.mesh, body,
                        [(sh[node.id], p)
                         for sh, p in zip(self._shards, parts)], axis)
        for sh, st in zip(self._shards, outs):
            sh[node.id] = st

    def check_errors(self) -> None:
        """Raise if any shard's sticky ``error`` flag is set: every flag
        of this process's shards comes back in one readback, and on a
        mesh across processes every process's in one exchange, so all of
        them raise alike."""
        flagged = [nid for nid, st in self._shards[0].items()
                   if isinstance(st, dict) and "error" in st]
        if not flagged:
            return
        d0 = self.device
        vals = torch.stack([
            torch.stack([sh[nid]["error"].to(d0) for sh in self._shards]
                        ).any() for nid in flagged]).cpu().numpy()
        if self.mesh.spans_processes:
            from reflow_tpu_torch.parallel import dist

            vals = dist.process_allgather(vals).any(axis=0)
        for nid, v in zip(flagged, vals.tolist()):
            if v:
                node = self.graph.nodes[nid]
                raise RuntimeError(f"{node}: {self._error_reason(node)}")

    def live_anywhere(self, counts: Dict[int, int]) -> Dict[int, bool]:
        """As on one controller; on a mesh across processes a batch is
        live when any process's part of it is, read through one
        allgather of every process's counts."""
        if not self.mesh.spans_processes or not counts:
            return super().live_anywhere(counts)
        from reflow_tpu_torch.parallel import dist

        nids = sorted(counts)
        rows = dist.process_allgather(
            np.array([counts[k] for k in nids], np.int64)).sum(axis=0)
        return {k: bool(v) for k, v in zip(nids, rows.tolist())}

    def shard_states(self, rank: int) -> dict:
        """Shard ``rank``'s own state trees (for inspection; a shard this
        process steps)."""
        if rank not in self._pos:
            raise KeyError(f"shard {rank} is not stepped by this process "
                           f"(it steps {self._local})")
        return self._shards[self._pos[rank]]
