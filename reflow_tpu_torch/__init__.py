"""reflow_tpu_torch — the PyTorch/CUDA port of reflow_tpu.

The same incremental dataflow model — a :class:`FlowGraph` of keyed
operators over delta collections, recomputed change by change by a
:class:`DirtyScheduler` — with the device executor written in PyTorch
for one NVIDIA H100 and its hot kernel (the k-NN row-wise top-k) in
hand-written CUDA. The NumPy :class:`CpuExecutor` is the oracle; the
``"cuda"`` executor (``get_executor("cuda")``, or ``device="cpu"`` to
run its plain PyTorch path on the CPU) runs the ported lowerings.

Ported (PRs 1-16), everything the JAX package does but the pieces left
out on purpose (ROADMAP.md): the k-NN re-index workload served end to
end (``IngestFrontend`` -> ``DirtyScheduler`` -> ``CudaExecutor`` -> the
KnnIndex lowering -> the top-k kernel, redesigned for the H100); every
row lowering with PageRank on the host-driven and the fused loop,
word-count, TF-IDF, SSSP and the multiset Join; the ViT-B/16 image-embed
ETL (``models``, ``workloads.image_embed``); the window path (K ticks
through the device ingress queue in one executor call, pipelined by the
serving pump); durable ingestion (the write-ahead log,
:class:`DurableScheduler`, checkpoints, :func:`recover`); replication,
failover and compaction; the serving tier and the wire (``serve``,
``net``); fleet telemetry, standing-query subscriptions and the
multi-process harness (``obs``, ``subs``, ``proc``); reflow-lint for the
port (``analysis``); the device mesh on one controller and across
processes, with a model axis (``parallel``); and :class:`ReflowConfig`,
which picks the executor and the scheduler's bounds from the
``REFLOW_*`` environment (``ReflowConfig.from_env().scheduler(graph)``).
"""

from reflow_tpu_torch.delta import DeltaBatch, Spec
from reflow_tpu_torch.executors import CpuExecutor, Executor, get_executor
from reflow_tpu_torch.graph import FlowGraph
from reflow_tpu_torch.scheduler import DirtyScheduler
from reflow_tpu_torch.serve import IngestFrontend
from reflow_tpu_torch.utils.config import ReflowConfig
from reflow_tpu_torch.wal import DurableScheduler, recover

__version__ = "0.1.0"

__all__ = ["DeltaBatch", "Spec", "FlowGraph", "DirtyScheduler",
           "DurableScheduler", "Executor", "CpuExecutor", "IngestFrontend",
           "get_executor", "recover", "ReflowConfig", "__version__"]
