"""Device meshes for the single-controller sharded executor, and the
placement helpers that row-shard a delta or key-shard a state tree.

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

Left out until the multi-controller slice: ``shard_batch_process_local``
(each process contributing its rows to one global batch) and a ``dcn``
axis that spans processes; ``make_mesh(dcn=k)`` here is the
single-controller 2-axis form.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from reflow_tpu_torch.executors.device_delta import (
    DeviceDelta, MAX_BATCH_WEIGHT_MASS, ShardedDelta, bucket_capacity,
    resolve_device, to_device)

__all__ = ["DELTA_AXIS", "DCN_AXIS", "MODEL_AXIS", "Mesh", "ShardedDelta",
           "make_mesh", "make_model_mesh", "replicate", "shard_batch",
           "shard_state_tree"]

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
    Shard ``rank`` is the flat (C-order) index of an entry."""

    def __init__(self, devices, axis_names: Sequence[str]):
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

    def __repr__(self) -> str:
        devs = sorted(set(map(str, self.device_list)))
        return f"Mesh({self.shape}, devices={devs})"

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
        """Every shard sits on one device."""
        return len(set(self.device_list)) == 1


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
    routes rows in two legs (one exchange across the dcn axis)."""
    if n_devices is None:
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
                (DCN_AXIS, axis_name))


def make_model_mesh(n_delta: int, n_model: int, *,
                    axis_name: str = DELTA_AXIS,
                    model_axis: str = MODEL_AXIS, device=None) -> Mesh:
    """A 2-axis (delta, model) mesh, delta-major. The sharded executor
    refuses a model axis until the tensor-parallel slice; the mesh itself
    builds."""
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
    host->device path enforces is checked on the global batch."""
    n = mesh.size
    if len(chunks) != n:
        raise ValueError(f"need one chunk per mesh device ({n}), got "
                         f"{len(chunks)}")
    if capacity is not None and (capacity <= 0 or capacity % n):
        raise ValueError(f"capacity {capacity} must be a positive multiple "
                         f"of the mesh size {n}")
    per = (capacity // n if capacity is not None
           else bucket_capacity(max(len(c) for c in chunks)))
    mass = sum(int(np.abs(np.asarray(c.weights)).sum())
               for c in chunks if len(c))
    if mass >= MAX_BATCH_WEIGHT_MASS:
        raise ValueError(
            "batch weight mass >= 2**24 exceeds the device path's exact "
            "float32 range; split the batch across ticks")
    parts = [to_device(c, spec, capacity=per, device=d)
             for c, d in zip(chunks, mesh.device_list)]
    if mesh.single_device:
        return DeviceDelta(*(torch.cat(cols) for cols in zip(*parts)))
    return ShardedDelta(parts)


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
