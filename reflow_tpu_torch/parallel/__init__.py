"""Mesh execution for the port: the single-controller SPMD runtime, the
sharded executor and the staged executor.

The counterpart of ``reflow_tpu/parallel``. The parallelism strategies:

- **delta-parallel**: delta buffers row-sharded over the mesh — each
  shard ingests a slice of the tick's changes;
- **key-parallel**: keyed state tables (Reduce aggregates, Join left
  tables and arenas) key-range-sharded — each shard owns a key range;
  cross-shard combination is ``psum_scatter`` (dense) or ``all_to_all``
  row routing (``shard_lowerings.route_rows``);
- **topo-partitioning**: contiguous FlowGraph stages pinned to devices,
  one pass per stage with explicit boundary handoff —
  ``topo.StagedCudaExecutor``, driven by ``Node.stage``.

``spmd`` runs the shards of a region in one process (one host thread,
each shard a generator that yields at its collectives); ``mesh`` builds
meshes of torch devices; ``dryrun.dryrun_multichip(n)`` certifies a
sharded PageRank on an ``n``-shard mesh.
"""

from reflow_tpu_torch.parallel.mesh import (DCN_AXIS, DELTA_AXIS, MODEL_AXIS,
                                            Mesh, make_mesh, make_model_mesh,
                                            replicate, shard_batch,
                                            shard_state_tree)

__all__ = ["DCN_AXIS", "DELTA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh",
           "make_model_mesh", "replicate", "shard_batch", "shard_state_tree",
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
