"""Executor plugin interface.

Execution of a tick's dirty batch is pluggable: the NumPy/dict
:class:`CpuExecutor` is the default path and correctness oracle; the
PyTorch :class:`~reflow_tpu_torch.executors.cuda.CudaExecutor` runs each
pass over device tensors. Executors are registered by name so the choice
is a config flag.
"""

from reflow_tpu_torch.executors.base import (Executor, get_executor,
                                             register_executor)
from reflow_tpu_torch.executors.cpu import CpuExecutor

__all__ = ["Executor", "CpuExecutor", "register_executor", "get_executor"]


def _lazy_cuda():
    from reflow_tpu_torch.executors.cuda import CudaExecutor

    return CudaExecutor


register_executor("cpu", CpuExecutor)
register_executor("cuda", _lazy_cuda)
