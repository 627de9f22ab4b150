"""Device-resident delta buffers: padded, columnar, fixed capacity.

The device form of a :class:`~reflow_tpu_torch.delta.DeltaBatch`: three
tensors of one capacity with **weight-0 padding** — a zero-weight row is
a no-op of the multiset algebra, so every lowering can process all
``capacity`` rows uniformly with no masking beyond the weights. Padding
rows carry key 0 (and zero values), as in the JAX package.

Capacities are bucketed to powers of two, so a steady stream of batches
reuses a handful of shapes.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from reflow_tpu_torch.delta import DeltaBatch, Spec, host_dtype, torch_dtype
from reflow_tpu_torch.utils.faults import DeliveryError

__all__ = ["DeviceDelta", "ShardedDelta", "bucket_capacity", "check_keys",
           "check_weight_mass", "check_weight_mass_value",
           "devices_of", "key_refusal", "resolve_device", "to_device",
           "to_host",
           "MAX_BATCH_WEIGHT_MASS"]

MIN_CAPACITY = 64
_I32 = np.iinfo(np.int32)


def resolve_device(device=None) -> torch.device:
    """Where an entry point of the port puts its tensors: the current
    CUDA device unless the caller names another. With no card and no
    ``device`` it raises rather than running on the CPU; ``device="cpu"``
    runs the plain PyTorch path there (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA "
                               f"device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    return dev


def devices_of(kind: str) -> List[torch.device]:
    """The devices of one kind, in index order: every CUDA device for
    ``"cuda"`` (it raises with no card), ``[cpu]`` for ``"cpu"``. An
    integer placement indexes this list."""
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"the port runs on cuda or cpu, not {kind}")


def bucket_capacity(n: int) -> int:
    """Next power-of-two capacity ≥ n (min MIN_CAPACITY)."""
    if n <= MIN_CAPACITY:
        return MIN_CAPACITY
    return 1 << (int(n) - 1).bit_length()


class DeviceDelta(NamedTuple):
    """A padded delta batch on the device.

    ``keys``:    int32[C]   — key ids in [0, key_space); 0 on padding rows
    ``values``:  dtype[C, *value_shape]
    ``weights``: int32[C]   — 0 marks padding / cancelled rows
    """

    keys: torch.Tensor
    values: torch.Tensor
    weights: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def nonzero(self) -> torch.Tensor:
        """Number of live (weight != 0) rows — a device scalar."""
        return torch.count_nonzero(self.weights)

    def __len__(self) -> int:  # host-side: forces a scalar readback
        return int(self.nonzero().item())

    @staticmethod
    def empty(spec: Spec, capacity: int = MIN_CAPACITY,
              device=None) -> "DeviceDelta":
        device = resolve_device(device)
        return DeviceDelta(
            keys=torch.zeros((capacity,), dtype=torch.int32, device=device),
            values=torch.zeros((capacity,) + tuple(spec.value_shape),
                               dtype=torch_dtype(spec.value_dtype),
                               device=device),
            weights=torch.zeros((capacity,), dtype=torch.int32,
                                device=device),
        )


class ShardedDelta(tuple):
    """A row-sharded delta whose shards live on different devices: one
    :class:`DeviceDelta` per shard, in rank order (the global batch is
    their concatenation). On a one-device mesh the port keeps the global
    batch as one ``DeviceDelta`` instead."""

    @property
    def capacity(self) -> int:
        return sum(p.capacity for p in self)

    @property
    def weights(self) -> torch.Tensor:
        d0 = self[0].weights.device
        return torch.cat([p.weights.to(d0) for p in self])

    def nonzero(self) -> torch.Tensor:
        """Live rows over every shard, a device scalar."""
        d0 = self[0].weights.device
        return sum(p.nonzero().to(d0) for p in self)


#: per-batch |w| mass bound: the JAX package folds weights through
#: float32 sums, exact only below 2**24; the port holds batches to the
#: same bound so both packages accept the same streams
MAX_BATCH_WEIGHT_MASS = 1 << 24


def check_weight_mass(batch: DeltaBatch) -> None:
    """Reject a batch whose |w| mass the device fold cannot take exactly
    (fail loudly at the host boundary)."""
    if len(batch):
        check_weight_mass_value(int(np.abs(batch.weights).sum()))


def check_weight_mass_value(mass) -> None:
    """:func:`check_weight_mass` on a mass already summed (a global mass
    over several processes' chunks)."""
    if mass >= MAX_BATCH_WEIGHT_MASS:
        raise ValueError(
            "batch weight mass >= 2**24 exceeds the device path's exact "
            "float32 range; split the batch across ticks")


def key_refusal(keys: np.ndarray, spec: Spec,
                source: str = "batch") -> Optional[str]:
    """Why the device path refuses these host keys, or None: keys
    outside int32 (the key columns are int32, and assigning them would
    wrap; the JAX ``to_device`` wraps silently), and keys at or past the
    Spec's ``key_space`` when it is declared (> 0). The device lowerings
    index their tables by key and drop such a row, as the JAX package's
    do, where the CPU oracle keeps it: an accepted row would be lost with
    no error. Negative keys pass; the lowerings wrap them once, as the
    JAX package's do."""
    k64 = np.asarray(keys).astype(np.int64)
    if not len(k64):
        return None
    hi, lo = int(k64.max()), int(k64.min())
    if hi > _I32.max or lo < _I32.min:
        return (f"{source}: keys exceed the int32 key range [{_I32.min}, "
                f"{_I32.max}] (max {hi}, min {lo})")
    if 0 < spec.key_space <= hi:
        return (f"{source}: key {hi} is at or past the Spec's key_space "
                f"{spec.key_space}; the device path holds keys in "
                f"[0, {spec.key_space}) (negative keys wrap once)")
    return None


def check_keys(keys: np.ndarray, spec: Spec,
               source: str = "batch") -> np.ndarray:
    """:func:`key_refusal` as a :class:`DeliveryError`; returns the keys
    as int64."""
    why = key_refusal(keys, spec, source)
    if why is not None:
        raise DeliveryError(why)
    return np.asarray(keys).astype(np.int64)


def to_device(batch: DeltaBatch, spec: Spec,
              capacity: Optional[int] = None,
              device=None, *, source: str = "batch") -> DeviceDelta:
    """Host DeltaBatch -> padded DeviceDelta (the source host boundary),
    on ``device`` (see :func:`resolve_device`: cuda unless named).

    Host values are laid out at the Spec's host dtype (float32 for a
    ``torch.bfloat16`` Spec) and cast to the Spec's torch dtype on the
    device, in one host->device copy per column. Values are assigned as
    numpy casts them: float rows bound for an integer Spec truncate
    toward zero, as in the JAX package (an int8 k-NN source zeroes unit
    float32 vectors; push pre-quantized rows).

    Keys outside int32 or at or past the Spec's ``key_space`` raise
    :class:`DeliveryError` naming ``source`` before anything is uploaded,
    as :meth:`DeviceIngressQueue.write` does (:func:`check_keys`).
    """
    device = resolve_device(device)
    n = len(batch)
    cap = capacity if capacity is not None else bucket_capacity(n)
    if n > cap:
        raise ValueError(f"batch of {n} rows exceeds capacity {cap}")
    check_weight_mass(batch)
    keys = np.zeros(cap, np.int32)
    weights = np.zeros(cap, np.int32)
    values = np.zeros((cap,) + tuple(spec.value_shape),
                      host_dtype(spec.value_dtype))
    if n:
        keys[:n] = check_keys(batch.keys, spec, source)
        weights[:n] = batch.weights
        values[:n] = np.asarray(
            np.stack([np.asarray(v) for v in batch.values])
            if batch.values.dtype == object else batch.values
        ).reshape((n,) + tuple(spec.value_shape))
    dt = torch_dtype(spec.value_dtype)
    return DeviceDelta(
        torch.from_numpy(keys).to(device),
        torch.from_numpy(values).to(device=device, dtype=dt),
        torch.from_numpy(weights).to(device))


def to_host(d: DeviceDelta) -> DeltaBatch:
    """DeviceDelta -> host DeltaBatch, dropping padding (the sink
    boundary). bf16 values come back as float32."""
    keys = d.keys.cpu().numpy()
    v = d.values.cpu()
    values = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    weights = d.weights.cpu().numpy()
    live = weights != 0
    return DeltaBatch(keys[live].astype(np.int64), values[live],
                      weights[live])
