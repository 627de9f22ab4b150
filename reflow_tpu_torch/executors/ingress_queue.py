"""Device-resident ingress queue for the K-tick window path.

The counterpart of ``reflow_tpu/executors/ingress_queue.py``. One K-tick
commit window is one executor call (``CudaExecutor.run_window``): the
window's tick loop reads one queue *slot* — a ``(tick, source)`` cell of
a preallocated ``[K, cap]`` delta buffer on the device — per tick per
source. Instead of padding and uploading each tick's batches on their
own, each host batch is written into its slot of persistent buffers:

- buffers are allocated ONCE per (plan, capacity, K) signature and reused
  window after window (the executor keeps the queue in its window cache,
  dropped on a bind of another graph);
- a batch's rows are copied into its slot from a pinned host staging
  buffer with an asynchronous copy (``non_blocking=True``), so the host
  goes on to the next slot while the copy runs; only the live rows
  cross, and the rows a slot held beyond them are zeroed on the device;
- an empty slot (window padding — a tick where this source had no
  deltas) is zeroed on the device: no host transfer at all, and no stale
  rows from an earlier window can leak (every slot is written every
  window);
- capacity is negotiated with the arena up front: the caller validates
  the per-source caps through the same static propagation the per-tick
  path uses (``arena.propagate_plan_caps``) BEFORE any device memory is
  reserved.

**No donation.** JAX donates the stack to the window program, which
hands back a zeroed one for :meth:`retire` to adopt. PyTorch has no
donation: the window reads the slots in place, and retiring a
generation only makes it free again. That is safe because the slot
copies, the memsets and the window's kernels all run on one CUDA stream:
a later window's slot writes into a generation are ordered after every
read an earlier window made of it.

**Pinned staging and its reuse.** The host side of a slot copy is a
pinned buffer of the same ``[K, cap]`` shape, one per generation. An
asynchronous copy reads it after the host has moved on, so refilling it
before the copy lands would corrupt the slot — only on the card, since a
pageable (or CPU) copy is synchronous. Each generation therefore records
a CUDA event after its last slot copy (:meth:`seal`) and the host waits
on that event before it writes the generation's staging again. This
takes the place of the JAX package's ``_scratch_reuse_safe`` probe.

**Generation rotation (pipelined windows).** The buffers come in
*generations* — independent full buffer sets. ``write`` targets the
current *staging* generation; :meth:`seal` hands that generation to a
dispatch and the next ``write`` rotates onto a free generation, so
window N+1's slot writes never touch a buffer set an undispatched or
in-flight window reads. :meth:`retire` frees it for reuse. Generations
are allocated lazily: a depth-1 caller (seal → dispatch → retire → seal)
ping-pongs on generation 0 and pays for exactly one buffer set; a
depth-D pump allocates at most D sets.

``placement`` is the device the buffers live on (a ``torch.device`` or
its name; None = the current CUDA device, as every entry point of the
port), or a ``(mesh, axis)`` pair: the sharded executor's queue splits
each source's capacity axis over the mesh's DATA shards (``axis``, one
name or a tuple of them, flattened first-major), as the JAX package's
sharded queue places a ``[K, cap]`` stack with ``P(None, axis)``. Data
shard ``j`` then holds rows ``[j*cap/n, (j+1)*cap/n)`` of every slot in
its own ``[K, cap/n]`` buffer, where ``n`` is the data size (``cap % n``
is checked). The placement follows the JAX one on the other two counts:

- mesh axes outside ``axis`` (a model axis) replicate: the members of a
  model group share their data shard's ONE buffer, on the device of the
  member at model index 0, so they can never read different rows (the
  executor's region hands a member on another device a copy of it);
- on a mesh across processes the queue holds only this process's data
  shards (the data indices of ``mesh.local_ranks``, a contiguous block
  from ``data_base``), and a slot write takes their rows out of the
  GLOBAL host batch every process writes alike.

A slot write copies each shard's rows straight into that shard's
buffer, and :meth:`stacked` hands the window a
:class:`~reflow_tpu_torch.executors.device_delta.ShardedDelta` per
source: one part per data shard this process holds (all ``n`` on one
controller), the row slices the sharded pass consumes as they are.

``slot_nbytes`` is the admission-side view of the same reservation: the
device bytes one host batch will occupy in its queue slot, used by the
serve frontend to key the ``AdmissionBudget`` on device memory pressure
instead of host payload bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from reflow_tpu_torch.delta import host_dtype, torch_dtype
from reflow_tpu_torch.executors.device_delta import (DeviceDelta,
                                                     ShardedDelta,
                                                     bucket_capacity,
                                                     check_keys,
                                                     check_weight_mass,
                                                     resolve_device)

__all__ = ["DeviceIngressQueue", "slot_nbytes"]


def slot_nbytes(spec, rows: int) -> int:
    """Device bytes a host batch of ``rows`` reserves in its queue slot:
    the capacity bucket times the per-row footprint (int32 key + int32
    weight + the value payload). This is what admission should charge
    when backpressure tracks device memory, not host payload size."""
    cap = bucket_capacity(int(rows))
    per_val = int(np.prod(spec.value_shape)) if spec.value_shape else 1
    return cap * (4 + 4 + per_val * torch_dtype(spec.value_dtype).itemsize)


def _data_shards(mesh, axis) -> tuple:
    """``(n_data, data_base, devices)`` of a mesh placement: the data
    size over ``axis``, the first data index this process holds, and the
    device of each of its data shards in data order (the member at model
    index 0 of each model group; the other axes are model axes)."""
    data = tuple(axis) if isinstance(axis, tuple) else (axis,)
    model = tuple(a for a in mesh.axis_names if a not in data)
    n_data = int(np.prod([mesh.shape[a] for a in data]))
    first: Dict[int, tuple] = {}
    for r in mesh.local_ranks:
        d = mesh.axis_index(r, data)
        mi = mesh.axis_index(r, model) if model else 0
        if d not in first or mi < first[d][0]:
            first[d] = (mi, r)
    held = sorted(first)
    base = held[0]
    if held != list(range(base, base + len(held))):
        raise ValueError(f"this process's data shards {held} are not a "
                         f"contiguous block")
    return n_data, base, [mesh.device_list[first[d][1]] for d in held]


def _host_values(batch, n: int, vshape: tuple) -> np.ndarray:
    """A batch's values as one ``[n, *vshape]`` array (object columns of
    per-row arrays are stacked, as ``to_device`` stacks them)."""
    v = batch.values
    if isinstance(v, np.ndarray) and v.dtype == object:
        v = np.stack([np.asarray(x) for x in v])
    return np.asarray(v).reshape((n,) + vshape)


class DeviceIngressQueue:
    """Per-source [K, cap] delta buffers and their slot writer.

    ``specs``/``caps`` map source node ids to their Spec and padded
    per-tick row capacity; ``k`` is the window length in ticks.
    ``placement``: the device of the buffers (see the module docstring).
    """

    def __init__(self, specs: Dict[int, object], caps: Dict[int, int],
                 k: int, placement=None):
        self.k = int(k)
        self.caps = dict(caps)
        self._specs = dict(specs)
        #: data shards the capacity axis splits over, and the first of
        #: them this process holds (1 and 0 without a mesh)
        self.n_data, self.data_base = 1, 0
        if isinstance(placement, tuple):
            mesh, axis = placement
            self.n_data, self.data_base, self.shard_devices = _data_shards(
                mesh, axis)
            for nid, cap in self.caps.items():
                if cap % self.n_data:
                    raise ValueError(
                        f"node {nid}: queue capacity {cap} is not a "
                        f"multiple of the mesh's {self.n_data} data shards")
            self.placement = self.shard_devices[0]
        else:
            self.placement = resolve_device(placement)
            #: one device per data shard this process holds
            self.shard_devices = [self.placement]
        self._sharded = isinstance(placement, tuple)
        self._cuda = self.placement.type == "cuda"
        self.writes = 0
        self.zero_writes = 0
        self.generations = 0
        #: device bytes of every generation allocated so far
        self.nbytes = 0
        #: host staging bytes (pinned on the card) of the same generations
        self.host_nbytes = 0
        #: device bytes of one generation: this process's data shards'
        #: share of every source's [K, cap] stack
        self.gen_nbytes = sum(
            k * slot_nbytes(specs[nid], cap) // self.n_data
            * len(self.shard_devices) for nid, cap in caps.items())
        #: generation -> {nid: DeviceDelta}; _staging is the generation
        #: writes land in, _inflight the sealed ones in dispatch order,
        #: _free the reusable ones (LIFO so the depth-1 flow ping-pongs on
        #: generation 0)
        self._gens: List[Dict[int, DeviceDelta]] = []
        #: generation -> {nid: (keys, values, weights)} host staging
        #: tensors (pinned on the card)
        self._host: List[Dict[int, tuple]] = []
        #: generation -> {nid: [[rows a slot may hold on the device] per
        #: shard]}: the rows past a new batch's that must be zeroed
        self._dirty: List[Dict[int, List[List[int]]]] = []
        #: generation -> the event recorded after its last slot copy (the
        #: host waits on it before refilling the generation's staging)
        self._copied: List[Optional[object]] = []
        self._free: List[int] = []
        self._inflight: List[int] = []
        self._staging: Optional[int] = None
        self._alloc_gen()  # generation 0, eagerly — same memory as before

    def _alloc_gen(self) -> int:
        pin = self._cuda
        n = len(self.shard_devices)
        bufs: Dict[int, List[DeviceDelta]] = {}
        host: Dict[int, tuple] = {}
        for nid, cap in sorted(self.caps.items()):
            spec = self._specs[nid]
            vshape = tuple(spec.value_shape)
            shape, vfull = (self.k, cap), (self.k, cap) + vshape
            # one [K, cap/n] buffer per data shard, on the shard's device
            cl = cap // self.n_data
            bufs[nid] = [DeviceDelta(
                torch.zeros((self.k, cl), dtype=torch.int32, device=dev),
                torch.zeros((self.k, cl) + vshape,
                            dtype=torch_dtype(spec.value_dtype), device=dev),
                torch.zeros((self.k, cl), dtype=torch.int32, device=dev))
                for dev in self.shard_devices]
            hvals = torch.from_numpy(np.zeros(0, host_dtype(
                spec.value_dtype))).dtype
            cols = (torch.empty(shape, dtype=torch.int32, pin_memory=pin),
                    torch.empty(vfull, dtype=hvals, pin_memory=pin),
                    torch.empty(shape, dtype=torch.int32, pin_memory=pin))
            self.host_nbytes += sum(c.numel() * c.element_size()
                                    for c in cols)
            host[nid] = cols
        gen = len(self._gens)
        self._gens.append(bufs)
        self._host.append(host)
        self._dirty.append({nid: [[0] * self.k for _ in range(n)]
                            for nid in self.caps})
        self._copied.append(None)
        self._free.append(gen)
        self.generations += 1
        self.nbytes += self.gen_nbytes
        return gen

    # -- generation rotation -----------------------------------------------

    @property
    def in_flight(self) -> int:
        """Sealed generations currently handed to dispatches."""
        return len(self._inflight)

    def _ensure_staging(self) -> int:
        if self._staging is None:
            if not self._free:
                self._alloc_gen()
            gen = self._free.pop()
            ev = self._copied[gen]
            if ev is not None:
                # the generation's last slot copies read its pinned
                # staging asynchronously: they must land before the host
                # writes it again
                ev.synchronize()
                self._copied[gen] = None
            self._staging = gen
        return self._staging

    def seal(self) -> int:
        """Hand the staging generation to a dispatch: the next ``write``
        rotates onto a free generation. Returns the generation id the
        caller must :meth:`retire` (or :meth:`cancel`) later."""
        gen = self._ensure_staging()
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.placement))
            self._copied[gen] = ev
        self._staging = None
        self._inflight.append(gen)
        return gen

    def retire(self, gen: int, stacked: Dict[int, DeviceDelta]) -> None:
        """Free generation ``gen`` for restaging once its window was
        dispatched. ``stacked`` is what the window handed back (the
        executor passes the stack it read, so this adopts the same
        buffers); a stack of other tensors is adopted with every slot
        treated as dirty, so the next writes clear it whole."""
        if gen not in self._inflight:
            raise ValueError(f"generation {gen} is not in flight")
        if sorted(stacked) != sorted(self.caps):
            raise ValueError(
                f"retire stack keys {sorted(stacked)} != queue sources "
                f"{sorted(self.caps)}")
        old = self._gens[gen]
        n = len(self.shard_devices)
        adopted = {}
        for nid, dd in stacked.items():
            parts = list(dd) if isinstance(dd, ShardedDelta) else [dd]
            if any(a is not b for p, q in zip(parts, old[nid])
                   for a, b in zip(p, q)):
                cl = self.caps[nid] // self.n_data
                self._dirty[gen][nid] = [[cl] * self.k for _ in range(n)]
            adopted[nid] = parts
        self._gens[gen] = adopted
        self._inflight.remove(gen)
        self._free.append(gen)

    def cancel(self, gen: int) -> None:
        """Un-seal a generation whose dispatch never happened: it goes
        straight back to the free list — every slot is rewritten every
        window, so stale rows can't leak."""
        if gen in self._inflight:
            self._inflight.remove(gen)
            self._free.append(gen)

    def rebind(self, stacked: Dict[int, DeviceDelta]) -> None:
        """Single-generation surface: retire the OLDEST in-flight
        generation (the depth-1 flow seals exactly one at a time)."""
        if not self._inflight:
            raise ValueError("rebind with no sealed generation in flight")
        self.retire(self._inflight[0], stacked)

    # -- slot writes --------------------------------------------------------

    def write(self, t: int, nid: int, batch,
              source: Optional[str] = None) -> None:
        """Fill slot ``(t, nid)`` of the staging generation from a host
        batch (a zero-row batch zeroes the slot on the device). Every
        slot must be written every window — the buffers persist, so a
        skipped slot would replay a previous window's rows. ``source``
        names the batch's source in the errors the key check raises."""
        cap = self.caps[nid]
        n = len(batch)
        if n > cap:
            raise ValueError(
                f"batch of {n} rows exceeds queue slot capacity {cap} "
                f"for node {nid}")
        if n:
            check_weight_mass(batch)   # same host-boundary guards as upload
            # the slot buffers are int32, and the lowerings drop a key
            # past the Spec's key_space: refuse both at the host boundary
            bkeys = check_keys(batch.keys, self._specs[nid],
                               source or f"node {nid}")
        gen = self._ensure_staging()
        parts = self._gens[gen][nid]
        cl = cap // self.n_data
        # the global rows this process's data shards take
        lo0 = self.data_base * cl
        hi0 = min(n, lo0 + len(parts) * cl)
        if hi0 > lo0:
            hk, hv, hw = self._host[gen][nid]
            vshape = tuple(self._specs[nid].value_shape)
            hk[t, lo0:hi0].numpy()[:] = bkeys[lo0:hi0]
            hw[t, lo0:hi0].numpy()[:] = np.asarray(batch.weights)[lo0:hi0]
            hv[t, lo0:hi0].numpy()[:] = _host_values(
                batch, n, vshape)[lo0:hi0]
        if not n:
            self.zero_writes += 1
        # data shard j takes rows [(base+j)*cl, (base+j+1)*cl) of the
        # slot (one shard, the whole slot, without a mesh)
        for j, (dev, dirty) in enumerate(zip(parts,
                                             self._dirty[gen][nid])):
            lo = lo0 + j * cl
            m = min(max(n - lo, 0), cl)
            if m:
                for d, h in zip(dev, (hk, hv, hw)):
                    src = h[t, lo:lo + m]
                    if src.dtype != d.dtype:
                        # a bfloat16 Spec stages float32 on the host and
                        # casts on the device
                        src = src.to(d.device, non_blocking=True)
                    d[t, :m].copy_(src, non_blocking=True)
            if dirty[t] > m:
                for d in dev:
                    d[t, m:dirty[t]].zero_()
            dirty[t] = m
        self.writes += 1

    def stacked(self) -> Dict[int, object]:
        """The staging generation's contents as the [K, cap] ingress
        stack the window's tick loop reads (under a mesh placement a
        ``ShardedDelta`` of the [K, cap/n] stacks of the data shards this
        process holds, in data order)."""
        gen = self._gens[self._ensure_staging()]
        if self._sharded:
            return {nid: ShardedDelta(p) for nid, p in gen.items()}
        return {nid: p[0] for nid, p in gen.items()}
