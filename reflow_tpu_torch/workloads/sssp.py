"""Incremental single-source shortest paths: iterative Join + min-Reduce.

The port's copy of ``reflow_tpu/workloads/sssp.py``: the same graph and
the same host-side helpers. The min-plus analog of PageRank's sum-loop,
and the graph shape that drives the retraction-exact device min/max
(``executors/lowerings.py`` ``minmax_core``) inside the fixpoint: every
distance improvement emits retract(old)/insert(new) through the
min-Reduce, and edge churn retracts relaxation candidates outright.

Graph::

    edges   source {src: [dst, weight]}
    seeds   source {node: dist}          (0.0 at the SSSP source)
    dist    loop   {node: best dist}     (unique)
    relax   Join(dist, edges, merge=[dst, d + w])
    cands   GroupBy(dst, value d + w)
    best    Reduce('min')( Union(cands, seeds) )
    close_loop(dist, best)

The loop is not linear (a min, not a sum), so the cuda executor runs each
tick through the row fixpoint program (``executors/fixpoint.py``), one
readback a pass; edge deletions retract the corresponding relaxation
candidates, exact while each node's candidate churn fits the
min-Reduce's ``candidates`` buffer and loud beyond it.

**Quiescence contract.** Distances must stay positive. Insertion ticks
always quiesce (relaxation only improves distances, and a shortest path
has at most ``n_nodes - 1`` hops). A deletion tick quiesces too — unless
it disconnects a cycle from the source: the orphaned cycle's nodes then
sustain each other with ever-growing candidate distances (the classic
incremental-SSSP invalidation problem). A tick that reaches
``max_loop_iters`` pauses (its loop carry re-enters as pending, so
nothing is dropped) and reports ``quiesced=False``; :func:`affected_set`
and :func:`repair` then re-derive the affected region in place (Ramalingam–
Reps style), or the caller rebuilds over the surviving edges.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from reflow_tpu_torch.delta import DeltaBatch, Spec
from reflow_tpu_torch.graph import FlowGraph, Node

__all__ = ["SsspGraph", "build_graph", "max_loop_iters", "edge_batch",
           "seed_batch", "affected_set", "repair", "reference_distances"]


@dataclasses.dataclass
class SsspGraph:
    graph: FlowGraph
    edges: Node
    seeds: Node
    dist: Node    # loop var
    best: Node    # the min-Reduce; read_table -> {node: distance}


def _relax_merge(k, d, vb):
    """(dist, [dst, w]) -> [dst, dist + w]: per row on the CPU oracle,
    batched tensors on the device (branch on ndim)."""
    if getattr(vb, "ndim", 1) <= 1:
        return np.asarray([vb[0], d + vb[1]])
    return torch.stack([vb[:, 0], d + vb[:, 1]], dim=-1)


def build_graph(n_nodes: int, *, arena_capacity: Optional[int] = None,
                candidates: int = 16) -> SsspGraph:
    dist_spec = Spec((), np.float32, key_space=n_nodes, unique=True)
    scalar = Spec((), np.float32, key_space=n_nodes)
    edge2 = Spec((2,), np.float32, key_space=n_nodes)
    arena = arena_capacity if arena_capacity is not None else 1 << 15

    g = FlowGraph("sssp")
    edges = g.source("edges", edge2)
    seeds = g.source("seeds", scalar)
    dist = g.loop("dist", dist_spec)
    relax = g.join(dist, edges, merge=_relax_merge, spec=edge2,
                   arena_capacity=arena, name="relax")
    cands = g.group_by(relax, key_fn=lambda k, v: _as_int32(v[:, 0]),
                       value_fn=lambda k, v: v[:, 1], vectorized=True,
                       spec=scalar, name="cands")
    best = g.reduce(g.union(cands, seeds), "min", name="best",
                    spec=dist_spec, candidates=candidates)
    g.close_loop(dist, best)
    return SsspGraph(g, edges, seeds, dist, best)


def _as_int32(x):
    """The destination column as int32: numpy on the CPU oracle, torch on
    the device."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return x.astype("int32")


def max_loop_iters(n_nodes: int) -> int:
    """The quiescence bound: a legitimate tick converges in <= n_nodes
    relaxation passes, so exceeding this proves an orphaned sustaining
    cycle (repair or rebuild — see the module docstring)."""
    return n_nodes + 2


def edge_batch(src, dst, w, weight: int = 1) -> DeltaBatch:
    """Edge rows keyed by src with [dst, w] values; ``weight=-1``
    retracts (values must replay the inserted rows exactly)."""
    src = np.asarray(src, np.int64)
    vals = np.stack([np.asarray(dst, np.float32),
                     np.asarray(w, np.float32)], axis=1)
    return DeltaBatch(src, vals, np.full(len(src), weight, np.int64))


def seed_batch(node: int) -> DeltaBatch:
    return DeltaBatch(np.array([node], np.int64),
                      np.zeros(1, np.float32), np.ones(1, np.int64))


def affected_set(n_nodes: int, src, dst, w, dist_prev: dict,
                 del_src, del_dst, del_w) -> set:
    """Conservative affected set for a batch of edge deletions
    (Ramalingam–Reps phase 1, host-side, O(E)).

    ``dist_prev`` is the trustworthy pre-deletion distance table;
    ``src/dst/w`` are the surviving edges. A node is affected when its
    (pre-deletion) shortest path may have used a deleted edge: seed with
    each deleted edge's head whose distance was tight through it
    (``dist[v] == dist[u] + w``), then close over the shortest-path DAG
    of the surviving edges (descendants of a stale node are themselves
    suspect). A superset only costs re-derivation work, never
    correctness.
    """
    d = np.full(n_nodes, np.inf)
    for k, v in dist_prev.items():
        d[int(k)] = v

    def _tight(du, dv, ww):
        # device distances are float32: tightness tolerates one rounding
        # (a false positive only widens the conservative superset)
        return (np.isfinite(du) & np.isfinite(dv)
                & np.isclose(dv, du + ww, rtol=1e-6, atol=1e-5))

    seeds = set()
    for u, v, ww in zip(np.asarray(del_src, np.int64),
                        np.asarray(del_dst, np.int64),
                        np.asarray(del_w, np.float64)):
        if _tight(d[u], d[v], ww):
            seeds.add(int(v))
    if not seeds:
        return set()
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float64)
    tight = _tight(d[src], d[dst], w)
    affected = set(seeds)
    frontier = list(seeds)
    # adjacency over tight (shortest-path DAG) surviving edges only
    adj = defaultdict(list)
    for u, v in zip(src[tight], dst[tight]):
        adj[int(u)].append(int(v))
    while frontier:
        u = frontier.pop()
        for v in adj[u]:
            if v not in affected:
                affected.add(v)
                frontier.append(v)
    return affected


def repair(sched, sg: SsspGraph, src, dst, w, affected: set):
    """In-place repair after edge deletions (the orphaned-cycle case),
    without a fresh scheduler: ``sched.rederive`` the surviving in-edges
    of the affected set. The retraction makes every affected candidate
    vanish through the exact algebra (a shrinking wave — it quiesces even
    from a paused, divergent iteration), and the re-insertion re-derives
    the affected region from the valid boundary distances. Device work is
    proportional to the affected region's in-edges and the relaxation
    cascade, not a rebuild.

    ``src/dst/w`` are the surviving edges; returns the two TickResults.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    mask = np.isin(dst, np.fromiter(affected, np.int64, len(affected)))
    if not mask.any():
        raise ValueError("repair: affected set has no surviving in-edges "
                         "(nothing to re-derive — the keys are simply "
                         "unreachable; a normal tick settles that)")
    batch = edge_batch(src[mask], dst[mask], np.asarray(w)[mask])
    return sched.rederive(sg.edges, batch)


def reference_distances(n_nodes, src_arr, dst_arr, w_arr, source: int):
    """Bellman-Ford oracle -> {node: distance} for reachable nodes."""
    dist = np.full(n_nodes, np.inf)
    dist[source] = 0.0
    for _ in range(n_nodes):
        nd = dist[src_arr] + w_arr
        new = dist.copy()
        np.minimum.at(new, dst_arr, nd)
        if np.array_equal(new, dist):
            break
        dist = new
    return {int(i): float(dist[i]) for i in range(n_nodes)
            if np.isfinite(dist[i])}
