"""Per-op device lowerings: one tick pass over device tensors.

Each lowering is a function ``(op, node, state, in_deltas) ->
(out_delta, state')`` over :class:`DeviceDelta` buffers and dense keyed
state tables, the counterpart of ``reflow_tpu/executors/lowerings.py``.
Emission capacities are fixed functions of input capacities and
key-space sizes; dead rows carry weight 0.

Only the KnnIndex lowering is ported so far; the executor refuses other
op kinds at ``bind``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from reflow_tpu_torch.delta import Spec, torch_dtype
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.graph import Node
from reflow_tpu_torch.kernels.topk import (NEG, chunked_corpus_topk, scores,
                                           topk)

__all__ = ["lower_node", "knn_state", "LOWERINGS",
           "LINEAR_DEVICE_REDUCERS"]

#: the reducers whose device lowering is a linear scatter-add (the
#: scheduler's ``refresh_minmax`` refuses them); the Reduce lowering
#: itself is not ported yet
LINEAR_DEVICE_REDUCERS = ("sum", "count", "mean")


# -- KnnIndex (cosine scores + the top-k kernel) ----------------------------

def knn_state(op, q_spec: Spec, d_spec: Spec, device) -> dict:
    Q, D = q_spec.key_space, d_spec.key_space
    dim, k = op.dim, op.k
    # vectors store at the SOURCE spec dtype (bf16 halves device memory
    # and the per-tick upload; int8 halves it again); normalization and
    # scoring run in float32
    return {
        "qvec": torch.zeros((Q, dim), dtype=torch_dtype(q_spec.value_dtype),
                            device=device),
        "qlive": torch.zeros((Q,), dtype=torch.bool, device=device),
        "dvec": torch.zeros((D, dim), dtype=torch_dtype(d_spec.value_dtype),
                            device=device),
        "dlive": torch.zeros((D,), dtype=torch.bool, device=device),
        "emitted": torch.zeros((Q, k, 2), dtype=torch.float32, device=device),
        "em_has": torch.zeros((Q,), dtype=torch.bool, device=device),
    }


def _norm_rows(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return torch.where(n > 0, v / torch.clamp(n, min=1e-30), 0.0)


def _table_index(keys: torch.Tensor, cap: int):
    """Row indices of ``keys`` into a table of ``cap`` rows, with the JAX
    package's out-of-range semantics: negative keys wrap once (``-1`` is
    the last row), a gather clamps into ``[0, cap)``, a scatter drops.
    Returns ``(clamped int64 indices, in-range mask)``."""
    k = keys.long()
    k = torch.where(k < 0, k + cap, k)
    inb = (k >= 0) & (k < cap)
    return k.clamp(0, cap - 1), inb


def _masked_set_(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                 src: torch.Tensor) -> None:
    """``table[idx[mask]] = src[mask]`` in place, without a host sync
    (boolean indexing would read the mask's count back) and without a
    drop mode (PyTorch has none). Rows outside the mask are redirected
    onto the first row inside it, with that row's value, so they rewrite
    what it writes; when no row is inside, every row targets ``idx[0]``
    with the value already there. Either way the redirected writes are
    no-ops. As in the JAX package, two rows inside the mask with one
    index leave one of their values, unspecified which."""
    first = torch.argmax(mask.to(torch.int32))
    anchor = idx[first]
    anchor_v = torch.where(mask[first], src[first], table[anchor])
    tgt = torch.where(mask, idx, anchor)
    m = mask.view((-1,) + (1,) * (src.dim() - 1))
    table[tgt] = torch.where(m, src, anchor_v)


def _fold_vectors_(vec: torch.Tensor, live: torch.Tensor,
                   delta: DeviceDelta) -> None:
    """Retract-then-insert fold of vector deltas into a dense table, in
    place (an in-tick update = retract + insert resolves to the insert).
    Keys outside the table are dropped, as the JAX package's
    ``mode="drop"`` scatter drops them."""
    idx, inb = _table_index(delta.keys, vec.shape[0])
    ins = (delta.weights > 0) & inb
    ret = (delta.weights < 0) & inb
    if vec.dtype == torch.int8:
        # int8 tables receive PRE-normalized, pre-quantized rows
        # (workloads/knn.quantize_int8): store raw — renormalizing a
        # round(unit*127) row would truncate it to zeros at int8
        vals = delta.values.to(torch.int8)
    else:
        # normalize in f32 regardless of storage dtype, store at table
        # dtype
        vals = _norm_rows(delta.values.float()).to(vec.dtype)
    _masked_set_(vec, idx, ins, vals)
    _masked_set_(live, idx, ret, torch.zeros_like(ret))
    _masked_set_(live, idx, ins, torch.ones_like(ins))


def _lower_knn(op, node: Node, state, ins, *, on_sync=None
               ) -> Tuple[DeviceDelta, dict]:
    """The KnnIndex tick: fold the query and corpus deltas into the dense
    tables, then either merge the delta docs into each query's emitted
    top-k (incremental path) or rescan the whole corpus in chunks (full
    path), and emit retract-old/insert-new rows for the queries whose
    top-k changed.

    Host decision: the JAX package picks the path on the device
    (``lax.cond``); PyTorch has no device-side branch, so the choice is
    made on the host from one scalar readback per tick (the ``need_full``
    flag — it depends on ``dlive``, a device table). ``on_sync`` is
    called once for that readback, so the scheduler can count it in
    ``forced_syncs``.

    In place: ``qvec``/``qlive``/``dvec``/``dlive`` are updated in place
    (the JAX package donates its state; copying a 0.8 GB corpus every
    tick would double the device memory and the tick's traffic), so the
    ``state`` dict passed in is consumed; ``state_snapshot`` clones.
    """
    dq, dd = ins
    dev = state["qvec"].device
    if dq is None:
        dq = DeviceDelta.empty(node.inputs[0].spec, device=dev)
    if dd is None:
        dd = DeviceDelta.empty(node.inputs[1].spec, device=dev)
    Q = node.inputs[0].spec.key_space
    D = node.inputs[1].spec.key_space
    k = op.k

    # an insert whose doc id is ALREADY live is an in-place update: its
    # stale score may sit in a query's emitted top-k, and the
    # incremental merge would keep treating it as a valid candidate —
    # updates therefore rescan, exactly like retractions (checked
    # against the PRE-fold live mask; padding rows have weight 0; the
    # gather clamps out-of-range keys, as the JAX package's does)
    d_idx, _ = _table_index(dd.keys, D)
    doc_update = torch.any((dd.weights > 0) & state["dlive"][d_idx])
    # fresh doc-insert and query-retract ticks take the incremental
    # merge (a retracted query just stops emitting); query
    # inserts/updates, doc retractions and doc UPDATES rescan the corpus
    need_full = (torch.any(dd.weights < 0) | torch.any(dq.weights > 0)
                 | doc_update)

    qvec, qlive = state["qvec"], state["qlive"]
    dvec, dlive = state["dvec"], state["dlive"]
    _fold_vectors_(qvec, qlive, dq)
    _fold_vectors_(dvec, dlive, dd)
    emitted, em_has = state["emitted"], state["em_has"]

    if on_sync is not None:
        on_sync()
    if bool(need_full.item()):
        vals, ids = chunked_corpus_topk(qvec, dvec, dlive, k, op.scan_chunk)
    else:
        # current top-k rows stay valid (no retractions): merge them with
        # scores against just the delta docs
        em_ids = emitted[:, :, 0].to(torch.int32)                   # [Q, k]
        em_vals = torch.where(em_has[:, None] & (em_ids >= 0),
                              emitted[:, :, 1], NEG)
        di = dd.keys                                                # [Cd]
        s_new = scores(qvec, dvec[d_idx])                           # [Q, Cd]
        s_new = torch.where((dd.weights > 0)[None, :], s_new, NEG)
        cand_vals = torch.cat([em_vals, s_new], dim=1)
        cand_ids = torch.cat([em_ids, di.expand(Q, di.shape[0])], dim=1)
        # order candidates by id so topk's first-index tie-break matches
        # the oracle's lowest-doc-id rule on exact score ties
        cand_ids, order = torch.sort(cand_ids, dim=1, stable=True)
        cand_vals = torch.gather(cand_vals, 1, order)
        vals, sel = topk(cand_vals, k)
        ids = torch.gather(cand_ids, 1, sel.long())

    ids = torch.where(vals <= NEG, -1, ids)
    new_row = torch.stack([ids.float(), vals], dim=-1)             # [Q,k,2]

    changed = torch.any((new_row != emitted).flatten(1), dim=1)
    ins_m = qlive & (~em_has | changed)
    ret_m = em_has & (~qlive | changed)
    qkeys = torch.arange(Q, dtype=torch.int32, device=dev)
    out = DeviceDelta(
        keys=torch.cat([qkeys, qkeys]),
        values=torch.cat([emitted, new_row]),
        weights=torch.cat([-ret_m.to(torch.int32), ins_m.to(torch.int32)]),
    )
    new_emitted = torch.where(ins_m[:, None, None], new_row, emitted)
    new_has = torch.where(ins_m, True, torch.where(ret_m & ~qlive, False,
                                                   em_has))
    return out, {"qvec": qvec, "qlive": qlive, "dvec": dvec, "dlive": dlive,
                 "emitted": new_emitted, "em_has": new_has}


# -- dispatch ---------------------------------------------------------------

LOWERINGS = {
    "knn": _lower_knn,
}


def lower_node(node: Node, state, ins: Sequence[Optional[DeviceDelta]], *,
               on_sync=None) -> Tuple[DeviceDelta, Optional[dict]]:
    return LOWERINGS[node.op.kind](node.op, node, state, ins,
                                   on_sync=on_sync)
