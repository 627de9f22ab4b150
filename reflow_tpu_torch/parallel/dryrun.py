"""``dryrun_multichip(n)``: the sharded tick certified on an n-shard mesh.

The counterpart of ``__graft_entry__.dryrun_multichip``. It runs the
incremental PageRank graph (config 3's workload at a tiny size) through
:class:`~reflow_tpu_torch.parallel.shard.ShardedCudaExecutor` — row-
sharded delta buffers, key-range-sharded state tables, the
``psum_scatter`` Reduce combine and the Join's owner delivery, with the
fused delta-vector loop as one SPMD region a tick — for an initial build
plus one churn tick, and again under the deferred schedule
(``defer_passes=2``: capped passes a tick, the residue carried, then a
drain). Both results are certified against the dense power iteration
``reference_ranks`` on the churned graph, within 5e-4 relative.

The JAX package re-executes itself in a subprocess when the process
sees fewer devices than the mesh needs; the port's mesh may repeat a
device, so the n shards run in process on one card (or on the CPU with
``device="cpu"``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["DryrunFailed", "dryrun_multichip", "N_NODES", "N_EDGES"]

N_NODES, N_EDGES = 256, 2048


def _graph(tol: float, defer_passes=None):
    from reflow_tpu_torch.executors.device_delta import bucket_capacity
    from reflow_tpu_torch.workloads import pagerank

    # the arena holds every (padded) edge row ever appended, per shard
    # under the conservative skew bound: 16x headroom covers an 8-way
    # mesh and the churn ticks
    return pagerank.build_graph(
        N_NODES, tol=tol, arena_capacity=16 * bucket_capacity(N_EDGES),
        defer_passes=defer_passes)


class DryrunFailed(RuntimeError):
    """The sharded tick did not converge, or its ranks missed the bound."""


def _certify(ok: bool, what: str) -> None:
    if not ok:
        raise DryrunFailed(what)


def _rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    return float((np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max())


def dryrun_multichip(n_devices: int, *, device=None) -> dict:
    """Run the sharded tick (collectives and the fused fixpoint) on an
    ``n_devices``-shard mesh and certify the ranks; returns the two
    relative errors and the passes. Raises :class:`DryrunFailed` on a
    miss."""
    from reflow_tpu_torch.parallel.mesh import make_mesh
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor
    from reflow_tpu_torch.scheduler import DirtyScheduler
    from reflow_tpu_torch.workloads import pagerank

    # tol=5e-5: two tol-converged fixpoints of different summation order
    # differ by up to tol/(1-damping) = 3.3e-4, inside the 5e-4 bound
    pg = _graph(5e-5)
    web = pagerank.WebGraph.random(N_NODES, N_EDGES, 0)
    ex = ShardedCudaExecutor(make_mesh(n_devices, device=device))
    sched = DirtyScheduler(pg.graph, ex, max_loop_iters=500)
    sched.push(pg.teleport, pagerank.teleport_batch(N_NODES))
    sched.push(pg.edges, web.initial_batch())
    r0 = sched.tick()
    _certify(r0.quiesced, "sharded fixpoint did not quiesce")
    _certify(ex._linear_structure is not None, "the fused loop did not engage")
    sched.push(pg.edges, web.churn(0.02))
    r1 = sched.tick()
    _certify(r1.quiesced, "sharded churn tick did not quiesce")
    got = pagerank.ranks_to_array(sched.read_table(pg.new_rank), N_NODES)
    rel = _rel_err(got, pagerank.reference_ranks(web))
    _certify(rel < 5e-4, f"sharded ranks diverge from reference: {rel:.2e}")

    # the deferred schedule: capped passes a tick, carried residue, drain
    pgd = _graph(5e-5, defer_passes=2)
    webd = pagerank.WebGraph.random(N_NODES, N_EDGES, 0)
    schedd = DirtyScheduler(pgd.graph, ShardedCudaExecutor(
        make_mesh(n_devices, device=device)), max_loop_iters=500)
    schedd.push(pgd.teleport, pagerank.teleport_batch(N_NODES))
    schedd.push(pgd.edges, webd.initial_batch())
    schedd.tick(sync=False)
    for _ in range(3):
        schedd.push(pgd.edges, webd.churn(0.02))
        schedd.tick(sync=False)
    schedd.drain(pgd.edges)
    gotd = pagerank.ranks_to_array(schedd.read_table(pgd.new_rank), N_NODES)
    reld = _rel_err(gotd, pagerank.reference_ranks(webd))
    _certify(reld < 5e-4, f"deferred sharded ranks diverge: {reld:.2e}")
    return {"rel_err": rel, "rel_err_deferred": reld,
            "passes": [r0.passes, r1.passes]}
