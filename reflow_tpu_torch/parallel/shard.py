"""ShardedCudaExecutor: the tick pass as an SPMD program over a mesh.

The counterpart of ``reflow_tpu/parallel/shard.py``'s
``ShardedTpuExecutor``. Delta buffers are row-sharded over the mesh,
keyed state tables key-range-sharded, and the cross-shard combines are
explicit collectives of the port's SPMD runtime (``parallel/spmd.py``):
``psum_scatter``/``all_to_all`` row routing in Reduce and Join, ``pmax``
in min/max, the ``ppermute`` ring merge in k-NN
(``parallel/shard_lowerings.py``). Everything runs in one process: each
shard's body is a generator stepped by one host thread.

**State layout.** Each shard holds its own state tree on its own device
(``_shards``, a list of ``{node id: tree}`` dicts in rank order). A
key-sharded leaf holds the shard's slice of dim 0; a replicated leaf
(Map params, the k-NN's query tables and emitted table) a full copy per
shard — the lowerings update tables in place, so no two shards may
share a tensor. One function decides which leaf is which
(:meth:`_leaf_sharded`, the JAX package's ``_state_tree_specs``): a
leaf shards when its dim 0 divides the mesh size, except Map params and
the k-NN's replicated tables. The Join's per-shard append counters and
arena generations ride as mesh-length vectors (a ``[1]`` slice per
shard), as in the JAX package.

``states`` is a view of the GLOBAL tree: reading a node gathers it
(sharded leaves concatenated in rank order onto the first shard's
device, replicated leaves from shard 0, a sticky ``error`` flag OR-ed
over the shards), assigning a node or the whole dict scatters. So
``read_table``, ``state_snapshot``/``state_restore``, the checkpoint,
the WAL and the replica paths see the tree a single-device executor
holds. The programs themselves thread the per-shard list
(:meth:`_op_states`).

**Passes and ticks.** A pass (and a whole fixpoint tick, see
``executors/fixpoint.py``) is one SPMD region: the ingress batches are
split into row slices (views on one device), every shard runs the
shared traversal with the shard-aware lowerings, and the shards' egress
slices are concatenated back into one global batch. A host branch that
must be uniform (the k-NN path, a loop's quiescence, the fused loop's
tiers) reads every shard's flag in one readback.

**Divisibility contract** (checked at bind): the mesh size is a power
of two no larger than the minimum delta capacity, so every bucketed
delta capacity splits evenly; every keyed op's key space, every Join's
arena (and left arena) and the k-NN's query and corpus spaces are
multiples of the mesh size; the k-NN's per-shard corpus is a multiple
of its scan chunk.

Not yet: a ``model_axis`` (tensor-parallel Map params) — refused by
name; multi-controller meshes spanning processes.
"""

from __future__ import annotations

from collections.abc import Mapping, MutableMapping
from typing import Dict, List, Optional

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
from reflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from reflow_tpu_torch.parallel.shard_lowerings import (deliver_to_owner,
                                                       knn_state_specs,
                                                       lower_node_sharded)
from reflow_tpu_torch.utils.tree import tree_map

__all__ = ["ShardedCudaExecutor"]

_ROUTE_REASON = ("a sparse-route overflow: key skew exceeded the "
                 "ROUTE_SLACK per-destination budget (raise the delta "
                 "capacity or rebalance the key space)")


class _GlobalStates(MutableMapping):
    """The executor's state as the global ``{node id: tree}`` dict:
    reads gather, writes scatter (see the module docstring)."""

    def __init__(self, ex: "ShardedCudaExecutor"):
        self._ex = ex

    def __getitem__(self, nid):
        return self._ex._gather(nid)

    def __setitem__(self, nid, tree):
        self._ex._scatter(nid, tree)

    def __delitem__(self, nid):
        for sh in self._ex._shards:
            del sh[nid]

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
        if model_axis is not None:
            raise GraphError(
                f"model_axis {model_axis!r}: tensor-parallel Map params "
                f"are not ported yet (the next slice); shard over the data "
                f"axes only")
        #: one shard per card by default
        self.mesh = mesh if mesh is not None else make_mesh()
        names = self.mesh.axis_names
        #: a 2-axis (dcn, delta) mesh shards over the flattened product
        #: axis, dcn-major
        self.axis = names[0] if len(names) == 1 else tuple(names)
        self.n = self.mesh.size
        #: per-axis extents of a 2-axis mesh (the two-leg router)
        self._axis_sizes = (tuple(self.mesh.shape[a] for a in names)
                            if len(names) > 1 else None)
        if self.n & (self.n - 1) or self.n > MIN_CAPACITY:
            raise GraphError(
                f"mesh size {self.n} must be a power of two <= "
                f"{MIN_CAPACITY} so bucketed delta capacities shard evenly")
        self._shards: List[dict] = [{} for _ in range(self.n)]
        self._plain: Optional[dict] = None
        self._replicated_ids: frozenset = frozenset()
        self._knn_ids: frozenset = frozenset()
        super().__init__(device=self.mesh.device_list[0], fixpoint=fixpoint,
                         linear_fixpoint=linear_fixpoint)
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
        self._shards = [{} for _ in range(self.n)]
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

    def _scatter(self, nid: int, tree) -> None:
        """Place one node's global tree: a slice or a copy per shard."""
        n = self.n
        for r, dev in enumerate(self.mesh.device_list):
            if isinstance(tree, dict) and nid not in self._replicated_ids:
                self._shards[r][nid] = {
                    k: (x.chunk(n, 0)[r].to(dev, copy=True)
                        if self._leaf_sharded(nid, k, tuple(x.shape))
                        else x.to(dev, copy=True))
                    for k, x in tree.items()}
            else:
                self._shards[r][nid] = tree_map(
                    lambda x: x.to(dev, copy=True)
                    if isinstance(x, torch.Tensor) else x, tree)

    def _gather(self, nid: int, keys=None):
        """One node's global tree (its ``keys`` leaves only, when given),
        on the first shard's device."""
        parts = [sh[nid] for sh in self._shards]
        if not isinstance(parts[0], dict) or nid in self._replicated_ids:
            return parts[0]
        d0 = self.device
        out = {}
        for k, x in parts[0].items():
            if keys is not None and k not in keys:
                continue
            gshape = (x.shape[0] * self.n,) if x.dim() else ()
            if self._leaf_sharded(nid, k, gshape):
                out[k] = torch.cat([p[k].to(d0) for p in parts])
            elif k == "error":
                out[k] = torch.stack([p[k].to(d0) for p in parts]).any()
            else:
                out[k] = x
        return out

    # -- executor surface ----------------------------------------------------

    def fresh(self) -> "ShardedCudaExecutor":
        return type(self)(self.mesh, fixpoint=self.fixpoint,
                          linear_fixpoint=self.linear_fixpoint)

    def place(self, device) -> None:
        """A sharded executor spans its mesh and cannot be pinned to one
        device."""
        raise GraphError(
            "ShardedCudaExecutor spans the device mesh and cannot be "
            "placed on a single device; use the cuda executor with "
            "GraphConfig(device=...) / placement='spread' instead")

    @property
    def device_label(self) -> str:
        return f"mesh[{self.n}]"

    def _ingress_placement(self):
        # queue buffers shard their capacity axis over the mesh, so slot
        # writes land shard-local
        return (self.mesh, self.axis)

    def _node_state(self, nid: int):
        if nid not in self._shards[0]:
            return None
        st = self._shards[0][nid]
        if not isinstance(st, dict) or nid in self._replicated_ids:
            return st
        return _LazyNode(self, nid)

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
        n = self.n
        self._plain = {}
        try:
            super().bind(graph)
            self._validate(graph)
            glob = self._plain
        finally:
            self._plain = None
        self._shards = [{} for _ in range(n)]
        for nid, tree in glob.items():
            self._scatter(nid, tree)

    def _validate(self, graph: FlowGraph) -> None:
        """The divisibility contract, and the sharded-only state leaves
        (the route-overflow flag of linear Reduces; the Join's per-shard
        counters)."""
        n, dev = self.n, self.device
        self._replicated_ids = frozenset(
            node.id for node in graph.nodes
            if node.kind == "op" and node.op.kind == "map"
            and node.op.params is not None)
        knn_ids = set()
        for loop in graph.loops:
            if loop.defer_passes and loop.spec.key_space % n:
                raise GraphError(
                    f"{loop}: key_space {loop.spec.key_space} must be a "
                    f"multiple of the mesh size {n}")
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
                        f"must be multiples of the mesh size {n}")
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
                    f"{node}: key_space {K} must be a multiple of the mesh "
                    f"size {n} (round it up)")
            if node.op.kind == "reduce":
                if node.op.how in LINEAR_DEVICE_REDUCERS:
                    # the sticky route-overflow flag (never dropped)
                    st["error"] = torch.zeros((), dtype=torch.bool,
                                              device=dev)
                continue
            if node.op.arena_capacity % n:
                raise GraphError(
                    f"{node}: arena_capacity {node.op.arena_capacity} "
                    f"must be a multiple of the mesh size {n}")
            counters = ["rcount", "gen"]
            if "lkeys" in st:
                La = node.op.left_arena_capacity or node.op.arena_capacity
                if La % n:
                    raise GraphError(
                        f"{node}: left_arena_capacity {La} must be a "
                        f"multiple of the mesh size {n}")
                counters += ["lcount", "lgen"]
            for f in counters:
                st[f] = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._knn_ids = frozenset(knn_ids)

    def update_params(self, node: Node, params) -> None:
        """Swap a params-bearing Map's tree: a copy on every shard."""
        if "params" not in self._shards[0].get(node.id, {}):
            raise GraphError(f"{node} holds no params state")
        self._scatter(node.id, {"params": self._copy_params(node, params)})

    # -- passes --------------------------------------------------------------

    def _to_device_ingress(self, ingress) -> Dict[int, object]:
        out: Dict[int, object] = {}
        for nid, b in ingress.items():
            if isinstance(b, (DeviceDelta, ShardedDelta)):
                out[nid] = b
            else:
                out[nid] = to_device(b, self.graph.nodes[nid].spec,
                                     device=self.device)
        return out

    def _split(self, d) -> List[DeviceDelta]:
        """A global (or already sharded) delta as one row slice per
        shard, each on its shard's device (views on one device)."""
        devs = self.mesh.device_list
        if isinstance(d, ShardedDelta):
            if len(d) != self.n:
                raise ValueError(f"a ShardedDelta of {len(d)} shards on a "
                                 f"mesh of {self.n}")
            return [DeviceDelta(*(t.to(dv) for t in p))
                    for p, dv in zip(d, devs)]
        if d.capacity % self.n:
            raise ValueError(f"delta capacity {d.capacity} is not a "
                             f"multiple of the mesh size {self.n}")
        cols = [t.chunk(self.n, 0) for t in d]
        return [DeviceDelta(*(c[r].to(dv) for c in cols))
                for r, dv in enumerate(devs)]

    def _combine(self, vals: list):
        """The shards' outputs of a region as one value: deltas
        concatenated in rank order (the global row-sharded batch), dicts
        and tuples element-wise, host scalars checked uniform."""
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
        """One SPMD region over the mesh: ``body(ctx, shard_states,
        shard_ingress, *args)`` per shard; returns ``(per-shard states,
        *the rest combined)``."""
        parts = {nid: self._split(d) for nid, d in dev_ingress.items()}
        per = [(op_states[r], {nid: p[r] for nid, p in parts.items()})
               + tuple(args) for r in range(self.n)]
        outs = spmd.run(self.mesh, body, per, self.axis)
        rest = [self._combine([o[i] for o in outs])
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
        d = to_device(batch, node.inputs[0].spec, device=self.device)
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
                        [(self._shards[r][node.id], parts[r])
                         for r in range(n)], axis)
        for r, st in enumerate(outs):
            self._shards[r][node.id] = st

    def check_errors(self) -> None:
        """Raise if any shard's sticky ``error`` flag is set: every flag
        of every shard comes back in one readback."""
        flagged = [nid for nid, st in self._shards[0].items()
                   if isinstance(st, dict) and "error" in st]
        if not flagged:
            return
        d0 = self.device
        vals = torch.stack([
            torch.stack([sh[nid]["error"].to(d0) for sh in self._shards]
                        ).any() for nid in flagged]).cpu().tolist()
        for nid, v in zip(flagged, vals):
            if v:
                node = self.graph.nodes[nid]
                raise RuntimeError(f"{node}: {self._error_reason(node)}")

    def shard_states(self, rank: int) -> dict:
        """Shard ``rank``'s own state trees (for inspection)."""
        return self._shards[rank]
