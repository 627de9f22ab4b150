"""Mesh execution for the port: the SPMD runtime, the sharded executor,
the staged executor, and meshes across processes.

The counterpart of ``reflow_tpu/parallel``. The parallelism strategies:

- **delta-parallel**: delta buffers row-sharded over the mesh — each
  shard ingests a slice of the tick's changes;
- **key-parallel**: keyed state tables (Reduce aggregates, Join left
  tables and arenas) key-range-sharded — each shard owns a key range;
  cross-shard combination is ``psum_scatter`` (dense) or ``all_to_all``
  row routing (``shard_lowerings.route_rows``);
- **tensor-parallel**: a Map's params split over a model axis
  (``ShardedCudaExecutor(model_axis=...)``, ``mesh.PartSpec``), its
  function yielding its own psums (``models.vit.vit_forward_tp``);
- **topo-partitioning**: contiguous FlowGraph stages pinned to devices,
  one pass per stage with explicit boundary handoff —
  ``topo.StagedCudaExecutor``, driven by ``Node.stage``.

``spmd`` steps each process's shards on one host thread (each shard a
generator that yields at its collectives; a collective across processes
is one exchange); ``dist`` joins the processes of a job;
``mesh`` builds meshes of torch devices (``make_mesh(dcn=
process_count())`` spans the processes); ``dryrun.dryrun_multichip(n)``
certifies a sharded PageRank on an ``n``-shard mesh;
``multihost_worker`` is one process of a mesh across processes.
"""

from reflow_tpu_torch.parallel.mesh import (DCN_AXIS, DELTA_AXIS, MODEL_AXIS,
                                            Mesh, PartSpec, make_mesh,
                                            make_model_mesh, replicate,
                                            shard_batch,
                                            shard_batch_process_local,
                                            shard_state_tree)

__all__ = ["DCN_AXIS", "DELTA_AXIS", "MODEL_AXIS", "Mesh", "PartSpec",
           "make_mesh", "make_model_mesh", "replicate", "shard_batch",
           "shard_batch_process_local", "shard_state_tree",
           "ShardedCudaExecutor", "StagedCudaExecutor", "dryrun_multichip"]


def __getattr__(name):
    # lazy: the executor classes pull in the executors package
    if name == "StagedCudaExecutor":
        from reflow_tpu_torch.parallel.topo import StagedCudaExecutor
        return StagedCudaExecutor
    if name == "ShardedCudaExecutor":
        from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor
        return ShardedCudaExecutor
    if name == "dryrun_multichip":
        from reflow_tpu_torch.parallel.dryrun import dryrun_multichip
        return dryrun_multichip
    raise AttributeError(name)
