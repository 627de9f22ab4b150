"""Multi-process deployment: real OS processes for every role.

The single-process simulation becomes a deployable system here: the
ingestion RPC (``serve/rpc.py``) lets producers live off-process, and
this package supplies the other half — replica/leader/producer
*processes* (``python -m reflow_tpu_torch.proc``), a harness that spawns and
kill -9s them, source-ownership + per-node disk layout, and the
cross-process tick-horizon barrier a restarted process rejoins
through. See docs/guide.md "Multi-process deployment".

The port's copy of ``reflow_tpu/proc/``: the children are
``python -m reflow_tpu_torch.proc``; they run word-count on the CPU
oracle (no executor), as the JAX package's do, and touch no card.
"""

from .harness import (ChildProc, ControlClient, ProcHarness,
                      RemoteReplicaProxy)
from .ownership import BarrierTimeout, OwnershipMap, horizon_barrier

__all__ = [
    "BarrierTimeout", "ChildProc", "ControlClient", "OwnershipMap",
    "ProcHarness", "RemoteReplicaProxy", "horizon_barrier",
]
