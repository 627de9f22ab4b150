"""Carry operator state between the JAX package and the port.

The state of a graph — for k-NN the query and corpus tables, their live
masks and each query's emitted top-k; for PageRank the Reduce's linear
tables and emitted ranks and the Join's left table and edge arena; for a
min/max Reduce its candidate buffer and latches (``cand_v``, ``cand_w``,
``over_lo``, ``over_maybe_pos``, ``emitted``, ``emitted_has``,
``error``); for a multiset-left Join both arenas — is
what the two packages must compute the same thing from, as a model's
weights are for a model. A loop under ``defer_passes`` adds its
``resid``: the fused loop's carried observables, ``[K, P+1]`` float32.
A Map with ``params`` carries ``{"params": tree}``, the weights as a
nested tree (a ViT's ``blocks`` is a list of dicts), each leaf checked
against the shape of the op's own ``params`` and kept at its dtype
(float32 stays exact).
The fused loop's sorted-arena CSR cache is derived state and is never
carried: the receiving executor rebuilds it on its first loop tick. The
JAX executor's per-node state, handed over
as numpy arrays (bf16 arrays as float32, since numpy has no bfloat16),
becomes the port's tensors at the dtypes the port's lowerings build, and
back. Integer and boolean arrays (keys, weights, ``rcount``, ``gen``,
flags) must arrive at exactly the port's dtype: they are int32 in both
packages, and a silent cast could wrap them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from reflow_tpu_torch.executors.device_delta import resolve_device
from reflow_tpu_torch.executors.linear_fixpoint import resid_state
from reflow_tpu_torch.executors.lowerings import (join_state, knn_state,
                                                  reduce_state)
from reflow_tpu_torch.graph import FlowGraph, GraphError
from reflow_tpu_torch.utils.tree import tree_map

__all__ = ["states_from_jax", "states_to_numpy"]


def _template(graph: FlowGraph) -> Dict[int, Dict[str, torch.Tensor]]:
    out = {}
    for node in graph.nodes:
        if node.kind == "loop" and node.defer_passes:
            # the deferred loop's carried observables (semantic state)
            out[node.id] = resid_state(node.spec, "meta")
        if node.kind != "op":
            continue
        op = node.op
        specs = [i.spec for i in node.inputs]
        if op.kind in ("filter", "groupby", "union") or (
                op.kind == "map" and op.params is None):
            continue
        if op.kind == "map":
            out[node.id] = {"params": tree_map(_meta_like, op.params)}
        elif op.kind == "knn":
            out[node.id] = knn_state(op, *specs, "meta")
        elif op.kind == "reduce":
            # linear tables, or a min/max Reduce's candidate buffer
            out[node.id] = reduce_state(specs[0], node.spec, "meta", op)
        elif op.kind == "join":
            # the dense left table, or the multiset-left arena pair
            out[node.id] = join_state(op, specs[0], specs[1], "meta")
        else:
            raise GraphError(f"{node}: state conversion for this "
                             f"{op.kind!r} op is not ported yet")
    return out


def _meta_like(x) -> torch.Tensor:
    """A meta tensor of a params leaf's shape and dtype (what ``bind``
    makes of it)."""
    dtype = x.dtype if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype
    return torch.empty(tuple(x.shape), dtype=dtype, device="meta")


def states_from_jax(np_states: Mapping[int, Mapping[str, np.ndarray]],
                    graph: FlowGraph, device=None
                    ) -> Dict[int, Dict[str, torch.Tensor]]:
    """``{node_id: {name: array}}`` from the JAX executor's ``states``
    (as numpy) -> the port's state dict for ``graph`` on ``device``
    (cuda unless the caller names another), ready for ``CudaExecutor.state_restore``. Every node and array the
    port's lowering keeps must be present with the port's shape; values
    are cast to the port's dtype (float32 -> bfloat16 for a bf16 table,
    which is exact for values that came from bf16)."""
    device = resolve_device(device)
    out = {}
    for nid, tmpl in _template(graph).items():
        if nid not in np_states:
            raise KeyError(f"{graph.nodes[nid]}: no state given")
        src = np_states[nid]
        node = graph.nodes[nid]
        st = {}
        for name, t in tmpl.items():
            if name not in src:
                raise KeyError(f"{node}: state {name!r} missing")

            def leaf(a, t, name=name):
                a = np.asarray(a)
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(
                        f"{node}: state {name!r} has shape {a.shape}, the "
                        f"port's is {tuple(t.shape)}")
                if not t.dtype.is_floating_point and \
                        torch.from_numpy(np.zeros(0, a.dtype)).dtype \
                        != t.dtype:
                    raise ValueError(f"{node}: state {name!r} is {a.dtype}, "
                                     f"the port's is {t.dtype}")
                # np.array copies: the tensor owns writable memory
                return torch.from_numpy(np.array(a)).to(device=device,
                                                        dtype=t.dtype)

            st[name] = tree_map(leaf, src[name], t)
        out[nid] = st
    return out


def states_to_numpy(states: Mapping[int, Mapping[str, torch.Tensor]]
                    ) -> Dict[int, Dict[str, np.ndarray]]:
    """The port's state dict -> ``{node_id: {name: numpy array}}`` on the
    host (bf16 tensors come back as float32; a params tree keeps its
    structure)."""
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {nid: tree_map(host, st) for nid, st in states.items()}
