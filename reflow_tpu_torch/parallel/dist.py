"""Processes of one job: the port's counterpart of ``jax.distributed``
and ``jax.experimental.multihost_utils``.

:func:`initialize` joins this process to a ``torch.distributed`` group of
``num_processes`` (one TCP rendezvous at ``coordinator``, ``host:port``);
:func:`process_count`, :func:`process_index` and
:func:`process_allgather` then answer as their JAX namesakes do, and a
mesh from ``parallel.mesh.make_mesh(dcn=process_count())`` spans the
processes: each dcn row is one process's shards, and the SPMD runtime
(``parallel/spmd.py``) completes a collective that crosses processes
with one :func:`exchange`.

**The backend is the caller's choice, and never changes behind its
back.**

- ``"gloo"`` runs on the CPU and beside the card. gloo has no CUDA
  ``all_gather``, so an exchange stages every CUDA payload through a
  pinned host buffer and uploads what it receives; those bytes are
  counted (:func:`staged_bytes`). Two processes sharing one card take
  this backend.
- ``"nccl"`` needs one card per process: process ``i`` takes
  ``cuda:i``. NCCL refuses two ranks on one GPU, so :func:`initialize`
  raises when there are fewer cards than processes instead of switching
  to gloo.

The group carries a timeout: a peer that died or took another branch
makes the waiting collective raise after ``timeout_s`` instead of
hanging the job.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["BACKENDS", "allgather_object", "backend", "exchange",
           "initialize", "is_initialized", "process_allgather", "process_count", "process_device",
           "process_index", "shutdown", "staged_bytes", "unstage"]

#: the backends :func:`initialize` accepts
BACKENDS = ("gloo", "nccl")

_STATE = {"backend": None, "count": 1, "index": 0, "device": None,
          "staged": 0}


def initialize(coordinator: str, num_processes: int, process_id: int, *,
               backend: str, timeout_s: float = 120.0) -> None:
    """Join the group of ``num_processes`` processes rendezvousing at
    ``coordinator`` (``"host:port"``; process 0 listens there) as
    process ``process_id``. ``backend`` is required: ``"gloo"`` or
    ``"nccl"`` (see the module docstring). Collectives that wait longer
    than ``timeout_s`` raise."""
    import torch.distributed as tdist

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if _STATE["backend"] is not None:
        raise RuntimeError("this process already joined a group; call "
                           "shutdown() first")
    n, pid = int(num_processes), int(process_id)
    if n < 1 or not 0 <= pid < n:
        raise ValueError(f"process_id {pid} of {n} processes")
    device = None
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards < n:
            raise RuntimeError(
                f"backend 'nccl' needs one card per process: {n} processes "
                f"on {cards} card(s) would put two ranks on one card, "
                f"which NCCL refuses; use backend='gloo' to share a card")
        device = torch.device("cuda", pid)
        torch.cuda.set_device(device)
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=n,
        rank=pid, timeout=datetime.timedelta(seconds=float(timeout_s)))
    _STATE.update(backend=backend, count=n, index=pid, device=device,
                  staged=0)


def shutdown() -> None:
    """Leave the group (a no-op when this process joined none)."""
    import torch.distributed as tdist

    if _STATE["backend"] is None:
        return
    tdist.destroy_process_group()
    _STATE.update(backend=None, count=1, index=0, device=None)


def is_initialized() -> bool:
    return _STATE["backend"] is not None


def backend() -> Optional[str]:
    """The group's backend, or None with no group."""
    return _STATE["backend"]


def process_count() -> int:
    """Processes in the group (1 with no group)."""
    return _STATE["count"]


def process_index() -> int:
    """This process's index in the group (0 with no group)."""
    return _STATE["index"]


def process_device() -> Optional[torch.device]:
    """The card an ``nccl`` group gave this process, else None."""
    return _STATE["device"]


def staged_bytes() -> int:
    """Bytes this process has sent and received in exchanges since it
    joined the group."""
    return _STATE["staged"]


def allgather_object(obj) -> list:
    """Every process's picklable ``obj``, in process order (``[obj]``
    with no group). Doubles as a barrier."""
    if _STATE["count"] == 1:
        return [obj]
    import torch.distributed as tdist

    out = [None] * _STATE["count"]
    tdist.all_gather_object(out, obj)
    return out


def process_allgather(x) -> np.ndarray:
    """Every process's ``x`` (a numpy array or scalar of the same shape
    everywhere), stacked in process order: ``[process_count(),
    *x.shape]``. With no group, ``x`` with a leading axis of one."""
    a = np.asarray(x)
    if _STATE["count"] == 1:
        return a[None]
    got = allgather_object(a)
    _STATE["staged"] += sum(g.nbytes for g in got)
    return np.stack(got)


def _stage(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes on the host: a CUDA tensor through a pinned host
    buffer, a CPU one as it lies."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.is_cuda:
        host = torch.empty(b.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(b)
        b = host
    return b.numpy()


def unstage(buf: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """Bytes received for a tensor of ``like``'s dtype and shape, on
    ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(buf)).view(like.dtype)
    return t.reshape(like.shape).to(device)


def exchange(header, tensors: List[torch.Tensor]
             ) -> Tuple[list, int, int]:
    """One all-to-all exchange: every process sends ``(header, its
    tensors' bytes)`` and receives every process's pair, in process
    order. Returns ``(pairs, bytes sent, bytes received)``; the tensors
    come back as uint8 arrays (:func:`unstage` rebuilds them)."""
    bufs = [_stage(t) for t in tensors]
    got = allgather_object((header, bufs))
    me = _STATE["index"]
    sent = sum(b.nbytes for b in bufs)
    received = sum(b.nbytes for p, (_, bs) in enumerate(got) if p != me
                   for b in bs)
    _STATE["staged"] += sent + received
    return got, sent, received
