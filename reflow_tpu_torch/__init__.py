"""reflow_tpu_torch — the PyTorch/CUDA port of reflow_tpu.

The same incremental dataflow model — a :class:`FlowGraph` of keyed
operators over delta collections, recomputed change by change by a
:class:`DirtyScheduler` — with the device executor written in PyTorch
for one NVIDIA H100 and its hot kernel (the k-NN row-wise top-k) in
hand-written CUDA. The NumPy :class:`CpuExecutor` is the oracle; the
``"cuda"`` executor (``get_executor("cuda")``, or ``device="cpu"`` to
run its plain PyTorch path on the CPU) runs the ported lowerings.

Ported so far: the k-NN re-index workload served end to end
(``IngestFrontend`` -> ``DirtyScheduler`` -> ``CudaExecutor`` -> the
KnnIndex lowering -> the top-k kernel), every row lowering with
PageRank, word-count, TF-IDF and SSSP, and the ViT-B/16 image-embed ETL
(``models``, ``workloads.image_embed``: a Map whose ``params`` are the
model's weights), and the window path: K ticks staged into the device
ingress queue and run in one executor call (``tick_many``), pipelined by
the serving pump at depth > 1, and durable ingestion: the
:class:`DurableScheduler` logs every accepted batch to a write-ahead log
before it runs, ``utils.checkpoint`` saves the executor's device state
(full or as a chain of deltas), and :func:`recover` restores a crashed
run from checkpoint plus log tail.
"""

from reflow_tpu_torch.delta import DeltaBatch, Spec
from reflow_tpu_torch.executors import CpuExecutor, get_executor
from reflow_tpu_torch.graph import FlowGraph
from reflow_tpu_torch.scheduler import DirtyScheduler
from reflow_tpu_torch.serve import IngestFrontend
from reflow_tpu_torch.wal import DurableScheduler, recover

__version__ = "0.1.0"

__all__ = ["DeltaBatch", "Spec", "FlowGraph", "DirtyScheduler",
           "DurableScheduler", "CpuExecutor", "get_executor",
           "IngestFrontend", "recover", "__version__"]
