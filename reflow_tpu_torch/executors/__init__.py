"""Executor plugin interface.

Execution of a tick's dirty batch is pluggable: the NumPy/dict
:class:`CpuExecutor` is the default path and correctness oracle; the
PyTorch :class:`~reflow_tpu_torch.executors.cuda.CudaExecutor` runs each
pass over device tensors. Executors are registered by name so the choice
is a config flag: ``"cuda"`` (one device), ``"sharded"`` (a mesh,
``parallel/shard.py``) and ``"staged"`` (graph stages on devices,
``parallel/topo.py``) load lazily.
"""

from reflow_tpu_torch.executors.base import (Executor, get_executor,
                                             register_executor)
from reflow_tpu_torch.executors.cpu import CpuExecutor

__all__ = ["Executor", "CpuExecutor", "register_executor", "get_executor"]


def _lazy_cuda():
    from reflow_tpu_torch.executors.cuda import CudaExecutor

    return CudaExecutor


def _lazy_sharded():
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    return ShardedCudaExecutor


def _lazy_staged():
    from reflow_tpu_torch.parallel.topo import StagedCudaExecutor

    return StagedCudaExecutor


register_executor("cpu", CpuExecutor)
register_executor("cuda", _lazy_cuda)
register_executor("sharded", _lazy_sharded)
register_executor("staged", _lazy_staged)
