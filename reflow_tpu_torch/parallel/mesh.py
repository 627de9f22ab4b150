"""Device meshes for the sharded executor, and the placement helpers
that row-shard a delta or key-shard a state tree.

The counterpart of ``reflow_tpu/parallel/mesh.py``. A :class:`Mesh` is
an n-dimensional array of ``torch.device`` entries with one name per
axis; the sharded executor runs one SPMD shard per entry
(``parallel/spmd.py``). Delta buffers shard along their row axis (each
shard ingests a contiguous slice of the tick's rows); keyed state tables
shard along the key axis (each shard owns a key range).

Devices: a mesh entry may repeat a device. On a machine with one card
every shard of ``make_mesh(n)`` sits on ``cuda:0`` (``n`` shards, one
stream: the semantics of the mesh at ``n`` times the launches); with
``k`` cards the shards map onto ``cuda:0..k-1`` in contiguous blocks.
``device="cpu"`` puts every shard on the CPU (the tests do). With no
card and no ``device`` it raises, as every entry point of the port
does.

Processes: once this process joined a group (``parallel/dist.py``),
``make_mesh(dcn=process_count())`` spans the processes. Each dcn row is
one process's shards (``Mesh.local_ranks``); the other rows' entries
stand for shards this process never steps. Ingest with
:func:`shard_batch_process_local`: each process contributes its own
rows, and the weight-mass guard runs on the global mass.

Tensor parallelism: :class:`PartSpec` says how one parameter leaf lies
over the mesh (one entry per dim: an axis name or None);
:func:`slice_by_spec` and :func:`join_by_spec` cut a tree into its model
shards and join them back.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from reflow_tpu_torch.executors.device_delta import (
    DeviceDelta, ShardedDelta, bucket_capacity, check_weight_mass_value,
    key_refusal, resolve_device, to_device)
from reflow_tpu_torch.utils.faults import DeliveryError

__all__ = ["DELTA_AXIS", "DCN_AXIS", "MODEL_AXIS", "Mesh", "PartSpec",
           "ShardedDelta", "join_by_spec", "make_mesh", "make_model_mesh",
           "replicate", "shard_batch", "shard_batch_process_local",
           "shard_state_tree", "slice_by_spec"]

#: name of the mesh axis delta rows and key ranges are sharded over
DELTA_AXIS = "delta"
#: name of the slow (cross-host) axis of a 2-axis mesh
DCN_AXIS = "dcn"
#: name of the tensor-parallel axis of a (delta, model) mesh
MODEL_AXIS = "model"


class Mesh:
    """Devices laid out on named axes. ``devices`` is an object array of
    ``torch.device`` whose shape gives the axis sizes; ``shape`` maps
    each axis name to its size, as a ``jax.sharding.Mesh``'s does.
    Shard ``rank`` is the flat (C-order) index of an entry.

    ``process_count`` processes hold the shards in contiguous blocks of
    ranks (the dcn rows of ``make_mesh(dcn=...)``); this one is
    ``process_index`` and steps ``local_ranks``."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 process_count: int = 1, process_index: int = 0):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).ravel()]
        arr.ravel()[:] = flat
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.size = int(arr.size)
        self.device_list: List[torch.device] = flat
        self._groups = {}
        if self.size % process_count:
            raise ValueError(f"{self.size} shards over {process_count} "
                             f"processes")
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        self._per_proc = self.size // self.process_count
        #: the flat ranks this process steps, in rank order
        self.local_ranks: List[int] = self.ranks_of(self.process_index)

    def process_of(self, rank: int) -> int:
        """The process that steps shard ``rank``."""
        return rank // self._per_proc

    def ranks_of(self, process: int) -> List[int]:
        """The flat ranks process ``process`` steps."""
        return list(range(process * self._per_proc,
                          (process + 1) * self._per_proc))

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    def __repr__(self) -> str:
        devs = sorted(set(map(str, self.device_list)))
        procs = (f", process {self.process_index} of "
                 f"{self.process_count}" if self.spans_processes else "")
        return f"Mesh({self.shape}, devices={devs}{procs})"

    def _coords(self, rank: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(rank,
                                                      self.devices.shape))

    def axis_index(self, rank: int, axes: tuple) -> int:
        """``rank``'s index along the flattened ``axes`` (first major)."""
        c = self._coords(rank)
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.devices.shape[i] + c[i]
        return idx

    def groups(self, axes: tuple) -> List[List[int]]:
        """The shard groups a collective over ``axes`` runs in: shards
        that agree on every other axis, each group in axis-index order."""
        got = self._groups.get(axes)
        if got is None:
            for a in axes:
                if a not in self.shape:
                    raise ValueError(f"axis {a!r} not in mesh axes "
                                     f"{self.axis_names}")
            rest = [i for i, a in enumerate(self.axis_names)
                    if a not in axes]
            by: dict = {}
            for r in range(self.size):
                c = self._coords(r)
                by.setdefault(tuple(c[i] for i in rest), []).append(r)
            got = [sorted(g, key=lambda r: self.axis_index(r, axes))
                   for g in by.values()]
            self._groups[axes] = got
        return got

    @property
    def single_device(self) -> bool:
        """Every shard this process steps sits on one device."""
        return len({self.device_list[r] for r in self.local_ranks}) == 1


def _devices(n: int, device=None) -> List[torch.device]:
    """``n`` shard devices: ``device`` repeated when named, else the
    cards in contiguous blocks (all of them ``cuda:0`` with one card)."""
    if device is not None:
        return [resolve_device(device)] * n
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to build a mesh of CPU shards")
    k = torch.cuda.device_count()
    return [torch.device("cuda", i * k // n) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, *,
              axis_name: str = DELTA_AXIS, dcn: Optional[int] = None,
              device=None) -> Mesh:
    """A mesh of ``n_devices`` shards for the sharded executor (default:
    one shard per card; with ``device=`` it must be given).

    1-axis (default): one ``axis_name`` axis. 2-axis (``dcn=k``): a
    ``(DCN_AXIS, axis_name)`` mesh of shape ``[k, n // k]``; the sharded
    executor then shards over the flattened product axis, dcn-major, and
    routes rows in two legs (one exchange across the dcn axis).

    In a group of processes (``parallel.dist.initialize``) the mesh spans
    them: ``dcn`` must be ``process_count()``, ``n_devices`` counts the
    shards of every process (default: one a process), and dcn row ``p``
    is process ``p``'s shards, on ``device`` (default: the card an nccl
    group gave this process, else ``cuda:0``). The other rows' entries
    name this process's device: their payloads land there when an
    exchange brings them in."""
    from reflow_tpu_torch.parallel import dist

    procs = dist.process_count()
    if procs > 1:
        if dcn != procs:
            raise ValueError(
                f"a mesh in a group of {procs} processes spans them: pass "
                f"dcn={procs} (each dcn row is one process's shards)")
        if device is None:
            device = dist.process_device()
            if device is None:
                _devices(1)                 # raises with no card
                device = torch.device("cuda", 0)
        if n_devices is None:
            n_devices = procs
    elif n_devices is None:
        if device is not None:
            raise ValueError("make_mesh(device=...) needs n_devices")
        _devices(1)                 # raises with no card
        n_devices = torch.cuda.device_count()
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    devs = _devices(n, device)
    if dcn is None:
        return Mesh(np.array(devs, dtype=object), (axis_name,))
    if n % dcn:
        raise ValueError(f"n_devices {n} not divisible by dcn {dcn}")
    return Mesh(np.array(devs, dtype=object).reshape(dcn, n // dcn),
                (DCN_AXIS, axis_name), process_count=procs,
                process_index=dist.process_index())


def make_model_mesh(n_delta: int, n_model: int, *,
                    axis_name: str = DELTA_AXIS,
                    model_axis: str = MODEL_AXIS, device=None) -> Mesh:
    """A 2-axis (delta, model) mesh, delta-major: delta rows and key
    ranges shard over ``axis_name``, Map params with ``param_specs``
    shard tensor-parallel over ``model_axis`` (pair it with
    ``ShardedCudaExecutor(mesh, model_axis=...)``). Each model group is
    ``n_model`` adjacent entries, so with several cards its two psums a
    block stay within a block of cards."""
    devs = _devices(n_delta * n_model, device)
    return Mesh(np.array(devs, dtype=object).reshape(n_delta, n_model),
                (axis_name, model_axis))


def shard_batch(chunks, spec, mesh: Mesh, *, capacity=None):
    """A row-sharded device batch from one host chunk per shard: chunk
    ``i`` is padded to ``capacity // n`` rows (default: the bucket of the
    largest chunk) and uploaded straight to shard ``i``'s device. Push
    the result like any batch. On a one-device mesh the result is the
    global ``DeviceDelta`` (chunk ``i`` in rows ``[i*per, (i+1)*per)``);
    across devices a :class:`ShardedDelta`. The weight-mass bound every
    host->device path enforces is checked on the global batch, and each
    chunk's keys at its upload (``check_keys``: int32, below the Spec's
    ``key_space``)."""
    n = mesh.size
    if mesh.spans_processes:
        raise ValueError("a mesh across processes ingests through "
                         "shard_batch_process_local")
    if len(chunks) != n:
        raise ValueError(f"need one chunk per mesh device ({n}), got "
                         f"{len(chunks)}")
    if capacity is not None and (capacity <= 0 or capacity % n):
        raise ValueError(f"capacity {capacity} must be a positive multiple "
                         f"of the mesh size {n}")
    per = (capacity // n if capacity is not None
           else bucket_capacity(max(len(c) for c in chunks)))
    check_weight_mass_value(sum(int(np.abs(np.asarray(c.weights)).sum())
                                for c in chunks if len(c)))
    parts = [to_device(c, spec, capacity=per, device=d,
                       source=f"shard_batch chunk {i}")
             for i, (c, d) in enumerate(zip(chunks, mesh.device_list))]
    if mesh.single_device:
        return DeviceDelta(*(torch.cat(cols) for cols in zip(*parts)))
    return ShardedDelta(parts)


def shard_batch_process_local(chunk, spec, mesh: Mesh, *, capacity: int):
    """Multi-controller ingestion: this process's rows (``chunk``, a
    host ``DeltaBatch``) as its slice of a row-sharded batch of
    ``capacity`` rows in all (a multiple of the mesh size). Every process
    calls it, and the push and tick after it, with the same capacity.

    The chunk is padded to ``capacity // process_count`` rows and split
    over this process's shards in rank order: a ``DeviceDelta`` when they
    share one device, else a :class:`ShardedDelta`. The sharded executor
    reads a device batch pushed on a mesh across processes as this
    process's rows. The weight-mass guard runs on the GLOBAL mass, one
    ``process_allgather`` of the local masses, and so does the key guard
    (``key_refusal``): a process whose chunk holds a refused key sends
    -1 for its mass, and every process raises the same
    :class:`DeliveryError` instead of leaving its peers in the gather. On
    a mesh of one process the result is the whole batch."""
    from reflow_tpu_torch.parallel import dist

    n = mesh.size
    if capacity <= 0 or capacity % n:
        raise ValueError(f"capacity {capacity} must be a positive "
                         f"multiple of the mesh size {n}")
    n_local = capacity // mesh.process_count
    if len(chunk) > n_local:
        raise ValueError(
            f"local chunk ({len(chunk)} rows) exceeds this process's "
            f"share {n_local} of capacity {capacity}")
    why = key_refusal(
        chunk.keys, spec,
        f"shard_batch_process_local: process {mesh.process_index}'s chunk")
    mass = int(np.abs(np.asarray(chunk.weights)).sum()) if len(chunk) else 0
    if mesh.spans_processes:
        got = dist.process_allgather(np.int64(-1 if why else mass))
        refused = np.flatnonzero(got < 0)
        if len(refused) and why is None:
            why = (f"shard_batch_process_local: process "
                   f"{int(refused[0])}'s chunk holds a key the device path "
                   f"refuses (see that process's error)")
        mass = int(got.sum())
    if why is not None:
        raise DeliveryError(why)
    check_weight_mass_value(mass)
    local = mesh.local_ranks
    devs = [mesh.device_list[r] for r in local]
    if mesh.single_device:
        return to_device(chunk, spec, capacity=n_local, device=devs[0])
    whole = to_device(chunk, spec, capacity=n_local, device="cpu")
    cols = [t.chunk(len(local), 0) for t in whole]
    return ShardedDelta([DeviceDelta(*(c[i].to(d) for c in cols))
                         for i, d in enumerate(devs)])


def _dim0_sharded(x, n: int) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] % n == 0


def shard_state_tree(states, mesh: Mesh) -> List[dict]:
    """Per-shard copies of a ``{node id: tree}`` state dict: every leaf
    whose dim 0 divides the mesh size is split along it (shard ``i``
    takes the ``i``-th slice), every other leaf is copied whole onto
    each shard's device. The sharded executor's own placement refines
    this per node (replicated Map params, the k-NN's query tables)."""
    n = mesh.size
    out = []
    for r, dev in enumerate(mesh.device_list):
        def one(x):
            if _dim0_sharded(x, n):
                return x.chunk(n, 0)[r].to(dev, copy=True)
            return x.to(dev, copy=True)

        out.append({nid: _tree_map(one, st) for nid, st in states.items()})
    return out


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per shard, each on its shard's device."""
    return [_tree_map(lambda x: x.to(d, copy=True), tree)
            for d in mesh.device_list]


def _tree_map(fn, tree):
    from reflow_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: fn(x) if isinstance(x, torch.Tensor) else x,
                    tree)


class PartSpec(tuple):
    """How one leaf lies over a mesh, the port's ``PartitionSpec``: one
    entry per leading dim, the mesh axis that dim is split over or None;
    missing trailing entries are None. ``PartSpec()`` is replicated,
    ``PartSpec(None, "model")`` splits dim 1 over the model axis."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartSpec{tuple.__repr__(self)}"

    def dim_of(self, axis: str) -> Optional[int]:
        """The dim split over ``axis``, or None."""
        hits = [i for i, a in enumerate(self) if a == axis]
        if len(hits) > 1:
            raise ValueError(f"{self!r} splits two dims over {axis!r}")
        return hits[0] if hits else None


def _walk_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a params tree and its spec tree (dicts and
    lists, :class:`PartSpec` leaves), the tree's structure kept."""
    if isinstance(specs, PartSpec):
        return fn(tree, specs)
    if isinstance(tree, dict):
        if set(tree) != set(specs):
            raise ValueError(f"param_specs keys {sorted(specs)} do not "
                             f"match the params' {sorted(tree)}")
        return {k: _walk_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(specs):
            raise ValueError(f"param_specs list of {len(specs)} for "
                             f"{len(tree)} params")
        return type(tree)(_walk_specs(fn, t, sp)
                          for t, sp in zip(tree, specs))
    raise ValueError(f"param_specs leaf {specs!r} is not a PartSpec")


def slice_by_spec(tree, specs, axis: str, size: int, index: int):
    """Member ``index`` of ``size``'s slice of a params tree: each leaf
    whose spec splits a dim over ``axis`` takes its ``index``-th chunk of
    that dim, every other leaf is kept whole. A split dim that ``size``
    does not divide raises."""
    def one(x, spec):
        for a in spec:
            if a is not None and a != axis:
                raise ValueError(f"{spec!r}: params shard only over the "
                                 f"model axis {axis!r}")
        dim = spec.dim_of(axis)
        if dim is None:
            return x
        if x.shape[dim] % size:
            raise ValueError(
                f"model axis size {size} must divide the sharded dim "
                f"{dim} of a {tuple(x.shape)} param")
        return x.chunk(size, dim)[index]

    return _walk_specs(one, tree, specs)


def join_by_spec(parts: list, specs, axis: str):
    """The whole params tree from its members' slices (the inverse of
    :func:`slice_by_spec`), on the first slice's device."""
    def one(x0, spec, path):
        dim = spec.dim_of(axis)
        if dim is None:
            return x0
        leaves = [_at(p, path) for p in parts]
        return torch.cat([t.to(x0.device) for t in leaves], dim)

    def walk(tree, sp, path):
        if isinstance(sp, PartSpec):
            return one(tree, sp, path)
        if isinstance(tree, dict):
            return {k: walk(tree[k], sp[k], path + (k,)) for k in tree}
        return type(tree)(walk(t, s_, path + (i,))
                          for i, (t, s_) in enumerate(zip(tree, sp)))

    return walk(parts[0], specs, ())


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
