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
port). The JAX package also takes a ``(mesh, axis)`` pair to shard the
capacity axis; that is the multi-device step of ROADMAP.md and raises
``NotImplementedError`` here.

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
                                                     bucket_capacity,
                                                     check_weight_mass,
                                                     resolve_device)
from reflow_tpu_torch.utils.faults import DeliveryError

__all__ = ["DeviceIngressQueue", "slot_nbytes"]

_I32 = np.iinfo(np.int32)


def slot_nbytes(spec, rows: int) -> int:
    """Device bytes a host batch of ``rows`` reserves in its queue slot:
    the capacity bucket times the per-row footprint (int32 key + int32
    weight + the value payload). This is what admission should charge
    when backpressure tracks device memory, not host payload size."""
    cap = bucket_capacity(int(rows))
    per_val = int(np.prod(spec.value_shape)) if spec.value_shape else 1
    return cap * (4 + 4 + per_val * torch_dtype(spec.value_dtype).itemsize)


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
        if isinstance(placement, tuple):
            raise NotImplementedError(
                "a (mesh, axis) placement shards the queue over a device "
                "mesh; the multi-device executors are not ported yet "
                "(ROADMAP.md Queue 1 step 10)")
        self.k = int(k)
        self.caps = dict(caps)
        self._specs = dict(specs)
        self.placement = resolve_device(placement)
        self._cuda = self.placement.type == "cuda"
        self.writes = 0
        self.zero_writes = 0
        self.generations = 0
        #: device bytes of every generation allocated so far
        self.nbytes = 0
        #: host staging bytes (pinned on the card) of the same generations
        self.host_nbytes = 0
        self.gen_nbytes = sum(k * slot_nbytes(specs[nid], cap)
                              for nid, cap in caps.items())
        #: generation -> {nid: DeviceDelta}; _staging is the generation
        #: writes land in, _inflight the sealed ones in dispatch order,
        #: _free the reusable ones (LIFO so the depth-1 flow ping-pongs on
        #: generation 0)
        self._gens: List[Dict[int, DeviceDelta]] = []
        #: generation -> {nid: (keys, values, weights)} host staging
        #: tensors (pinned on the card)
        self._host: List[Dict[int, tuple]] = []
        #: generation -> {nid: [rows a slot may hold on the device]}: the
        #: rows past a new batch's that must be zeroed
        self._dirty: List[Dict[int, List[int]]] = []
        #: generation -> the event recorded after its last slot copy (the
        #: host waits on it before refilling the generation's staging)
        self._copied: List[Optional[object]] = []
        self._free: List[int] = []
        self._inflight: List[int] = []
        self._staging: Optional[int] = None
        self._alloc_gen()  # generation 0, eagerly — same memory as before

    def _alloc_gen(self) -> int:
        dev, pin = self.placement, self._cuda
        bufs: Dict[int, DeviceDelta] = {}
        host: Dict[int, tuple] = {}
        for nid, cap in sorted(self.caps.items()):
            spec = self._specs[nid]
            vshape = tuple(spec.value_shape)
            shape, vfull = (self.k, cap), (self.k, cap) + vshape
            bufs[nid] = DeviceDelta(
                torch.zeros(shape, dtype=torch.int32, device=dev),
                torch.zeros(vfull, dtype=torch_dtype(spec.value_dtype),
                            device=dev),
                torch.zeros(shape, dtype=torch.int32, device=dev))
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
        self._dirty.append({nid: [0] * self.k for nid in self.caps})
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
        for nid, dd in stacked.items():
            if any(a is not b for a, b in zip(dd, old[nid])):
                self._dirty[gen][nid] = [self.caps[nid]] * self.k
        self._gens[gen] = dict(stacked)
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

    def write(self, t: int, nid: int, batch) -> None:
        """Fill slot ``(t, nid)`` of the staging generation from a host
        batch (a zero-row batch zeroes the slot on the device). Every
        slot must be written every window — the buffers persist, so a
        skipped slot would replay a previous window's rows."""
        cap = self.caps[nid]
        n = len(batch)
        if n > cap:
            raise ValueError(
                f"batch of {n} rows exceeds queue slot capacity {cap} "
                f"for node {nid}")
        if n:
            check_weight_mass(batch)   # same host-boundary guard as upload
            bkeys = np.asarray(batch.keys)
            if (int(bkeys.max()) > _I32.max
                    or int(bkeys.min()) < _I32.min):
                # the slot buffers are int32: assigning int64 keys would
                # silently wrap anything >= 2^31 — refuse at the host
                # boundary instead of folding a corrupted key
                raise DeliveryError(
                    f"node {nid}: batch keys exceed the int32 ingress "
                    f"key range [{_I32.min}, {_I32.max}] "
                    f"(max {int(bkeys.max())}, min {int(bkeys.min())})")
        gen = self._ensure_staging()
        dev = self._gens[gen][nid]
        dirty = self._dirty[gen][nid]
        if n:
            hk, hv, hw = self._host[gen][nid]
            vshape = tuple(self._specs[nid].value_shape)
            hk[t, :n].numpy()[:] = bkeys
            hw[t, :n].numpy()[:] = batch.weights
            hv[t, :n].numpy()[:] = _host_values(batch, n, vshape)
            for d, h in zip(dev, (hk, hv, hw)):
                src = h[t, :n]
                if src.dtype != d.dtype:
                    # a bfloat16 Spec stages float32 on the host and casts
                    # on the device
                    src = src.to(self.placement, non_blocking=True)
                d[t, :n].copy_(src, non_blocking=True)
        else:
            self.zero_writes += 1
        if dirty[t] > n:
            for d in dev:
                d[t, n:dirty[t]].zero_()
        dirty[t] = n
        self.writes += 1

    def stacked(self) -> Dict[int, DeviceDelta]:
        """The staging generation's contents as the [K, cap] ingress
        stack the window's tick loop reads."""
        return dict(self._gens[self._ensure_staging()])
