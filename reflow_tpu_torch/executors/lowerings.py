"""Per-op device lowerings: one tick pass over device tensors.

Each lowering is a function ``(op, node, state, in_deltas) ->
(out_delta, state')`` over :class:`DeviceDelta` buffers and dense keyed
state tables, the counterpart of ``reflow_tpu/executors/lowerings.py``.
Emission capacities are fixed functions of input capacities and
key-space sizes; dead rows carry weight 0, and every consumption goes
through a ``where(w == 0, 0, ...)`` guard so padding garbage never
reaches live state.

Keyed-state representations (as in the JAX package):

- Reduce (linear reducers sum/count/mean): dense tables over the key
  space — ``wsum[K,*V]`` (Σ w·v), ``wcnt[K]`` (Σ w), ``emitted[K,*V]`` +
  ``emitted_has[K]`` (the last aggregate emitted downstream, so
  retractions stay exact under ``tol``).
- Reduce (min / max): the bounded per-key candidate buffer of
  :func:`minmax_core` (``cand_v[K,R,V]``, ``cand_w[K,R]``, the eviction
  latches ``over_lo[K,V]`` and ``over_maybe_pos[K]``, ``emitted`` +
  ``emitted_has`` and a sticky ``error``), exact under retractions while
  the answer is derivable from the buffer, loud beyond it.
- Join, unique left: a dense left table (``lval[K,*VA]``, ``lw[K]``) and
  the right side as an append-log arena (``rkeys[R]``, ``rvals[R,*VB]``,
  ``rw[R]``, ``rcount``, ``gen``) with a sticky ``error`` flag.
- Join, multiset left: the left side a second append arena (``lkeys``,
  ``lvals``, ``lrw``, ``lcount``, ``lgen``) beside the right one; both
  δ-products are key-matched pair enumerations at a fixed budget
  (:func:`_keyed_product`).

Every lowering of the JAX package's module has its counterpart here. A
Map with ``params`` holds them as its state (``{"params": tree}``, built
by the executor's ``bind``) and passes them to ``fn`` as its first
argument; the state passes through unchanged.

Out-of-range keys: the JAX package's scatters drop them and its gathers
clamp them (``mode="drop"`` and the default gather). PyTorch raises on
the CPU and asserts on the card instead, so every keyed scatter here
goes through :func:`_table_index` (wrap a negative key once, clamp the
index, mask the row out of the scatter) — never an out-of-range index.

In place: the arenas, the Reduce's sparse-mode tables, the min/max
buffers and the Join's left table are updated in place (the JAX package
donates its state); the ``state`` dict passed in is consumed, and
``state_snapshot`` clones.

Profiler spans: each composition opens a ``torch.profiler`` range
(``reflow::<op>.<part>``) only while a profiler is recording, so a
traced tick attributes its device time by composition; otherwise a
span costs one flag check.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

from reflow_tpu_torch.delta import Spec, torch_dtype
from reflow_tpu_torch.executors.arena import _lex_order, compact_arena
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.graph import Node
from reflow_tpu_torch.kernels.topk import (NEG, chunked_corpus_topk, scores,
                                           topk)

__all__ = ["lower_node", "knn_state", "reduce_state", "join_state",
           "join_core", "minmax_state", "minmax_core", "minmax_refresh_core",
           "LOWERINGS", "LINEAR_DEVICE_REDUCERS"]

#: the reducers that lower to linear scatter-adds (min and max lower to
#: the bounded candidate buffer; the scheduler's ``refresh_minmax``
#: refuses the linear ones)
LINEAR_DEVICE_REDUCERS = ("sum", "count", "mean")


def span(name: str):
    """A ``torch.profiler`` range named ``reflow::<name>`` while a profiler
    records, else a no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(f"reflow::{name}")
    return contextlib.nullcontext()


# -- state builders --------------------------------------------------------

def reduce_state(in_spec: Spec, out_spec: Spec, device, op=None) -> dict:
    """A Reduce's state: the linear tables, or for a min/max ``op`` the
    candidate buffer of :func:`minmax_state`."""
    K = in_spec.key_space
    vshape = tuple(in_spec.value_shape)
    oshape = tuple(out_spec.value_shape)
    if op is not None and op.how not in LINEAR_DEVICE_REDUCERS:
        return minmax_state(op, K, vshape, oshape,
                            torch_dtype(out_spec.value_dtype), device)
    return {
        "wsum": torch.zeros((K,) + vshape, dtype=torch.float32,
                            device=device),
        "wcnt": torch.zeros((K,), dtype=torch.int32, device=device),
        "emitted": torch.zeros((K,) + oshape,
                               dtype=torch_dtype(out_spec.value_dtype),
                               device=device),
        "emitted_has": torch.zeros((K,), dtype=torch.bool, device=device),
    }


def join_state(op, left_spec: Spec, right_spec: Spec, device) -> dict:
    """Join state: the dense left table when the left Spec is unique,
    else a left append arena (``left_arena_capacity`` rows, or
    ``arena_capacity``) mirroring the right one."""
    K = left_spec.key_space
    R = op.arena_capacity

    def scalar(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    def arena(n, spec):
        return (torch.zeros((n,), dtype=torch.int32, device=device),
                torch.zeros((n,) + tuple(spec.value_shape),
                            dtype=torch_dtype(spec.value_dtype),
                            device=device),
                torch.zeros((n,), dtype=torch.int32, device=device))

    if not left_spec.unique:
        lkeys, lvals, lrw = arena(op.left_arena_capacity or R, left_spec)
        rkeys, rvals, rw = arena(R, right_spec)
        return {"lkeys": lkeys, "lvals": lvals, "lrw": lrw,
                "lcount": scalar(torch.int32), "lgen": scalar(torch.int32),
                "rkeys": rkeys, "rvals": rvals, "rw": rw,
                "rcount": scalar(torch.int32), "gen": scalar(torch.int32),
                "error": scalar(torch.bool)}
    return {
        "lval": torch.zeros((K,) + tuple(left_spec.value_shape),
                            dtype=torch_dtype(left_spec.value_dtype),
                            device=device),
        "lw": torch.zeros((K,), dtype=torch.int32, device=device),
        "rkeys": torch.zeros((R,), dtype=torch.int32, device=device),
        "rvals": torch.zeros((R,) + tuple(right_spec.value_shape),
                             dtype=torch_dtype(right_spec.value_dtype),
                             device=device),
        "rw": torch.zeros((R,), dtype=torch.int32, device=device),
        "rcount": scalar(torch.int32),
        # bumped by every compaction (which reorders the arena's rows)
        "gen": scalar(torch.int32),
        # sticky: an append overflowed the arena even after compaction
        "error": scalar(torch.bool),
    }


# -- helpers ---------------------------------------------------------------

def _bcast_w(w: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """weights [C] broadcast against values [C, *V]."""
    return w.reshape(w.shape + (1,) * (values.dim() - 1))


def _masked_contrib(w: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """w·v with an explicit zero at w==0 so padding NaNs never propagate."""
    wb = _bcast_w(w, values)
    return torch.where(wb == 0, 0, wb.to(values.dtype) * values)


def _differs(a: torch.Tensor, b: torch.Tensor, tol: float) -> torch.Tensor:
    """Per-key 'aggregates differ' over trailing value axes."""
    d = torch.abs(a - b) > tol if tol > 0.0 else a != b
    if d.dim() > 1:
        d = torch.any(d.flatten(1), dim=1)
    return d


def _apply_rowfn(fn, vectorized: bool, *cols):
    """A row function over the delta's columns: as given when vectorized,
    else per row under ``torch.func.vmap``.

    A per-row result that does not depend on the row (a Python or numpy
    scalar, a 0-d tensor, any tensor made without the input) broadcasts
    to every row, as ``jax.vmap`` broadcasts it. ``torch.func.vmap``
    refuses a non-tensor result, so such a result becomes a tensor on
    the columns' device first; vmap then sees a result that carries no
    batch dimension (its output is not a batched tensor) and, with the
    default ``out_dims=0``, expands it along the ``C`` rows."""
    if vectorized:
        return fn(*cols)
    dev = cols[0].device

    def row(*xs):
        out = fn(*xs)
        return out if isinstance(out, torch.Tensor) else torch.as_tensor(
            out, device=dev)

    return torch.func.vmap(row)(*cols)


def _as(x, dtype, device) -> torch.Tensor:
    """A row fn's result as a tensor of ``dtype`` (``jnp.asarray(x,
    dtype)``: a float cast to an int type truncates)."""
    return torch.as_tensor(x, device=device).to(dtype)


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
    index leave one of their values, unspecified which; ``src`` is cast
    to the table's dtype, as a JAX ``.at[].set`` casts it."""
    src = src.to(table.dtype)
    if idx.numel() == 0:      # nothing to write (argmax needs a row)
        return
    # one-element index tensors throughout: indexing with a 0-d tensor
    # would read it back to the host (an ``item`` sync per call)
    first = torch.argmax(mask.to(torch.int32)).reshape(1)
    anchor = idx.index_select(0, first)
    m = mask.view((-1,) + (1,) * (src.dim() - 1))
    anchor_v = torch.where(m.index_select(0, first),
                           src.index_select(0, first),
                           table.index_select(0, anchor))
    tgt = torch.where(mask, idx, anchor)
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


# -- Map / Filter / GroupBy / Union ----------------------------------------

def _lower_map(op, node: Node, state, ins, *, on_sync=None
               ) -> Tuple[DeviceDelta, Optional[dict]]:
    (d,) = ins
    with span("map"):
        if op.params is not None:
            # the params are op state, passed as fn's first argument; a
            # row-wise fn maps over the rows with the params held fixed
            p = state["params"]
            if op.vectorized:
                vals = op.fn(p, d.values)
            else:
                vals = torch.func.vmap(op.fn, in_dims=(None, 0))(p, d.values)
        else:
            vals = _apply_rowfn(op.fn, op.vectorized, d.values)
        vals = _as(vals, torch_dtype(node.spec.value_dtype), d.values.device)
    return DeviceDelta(d.keys, vals, d.weights), state


def _lower_filter(op, node: Node, state, ins, *, on_sync=None
                  ) -> Tuple[DeviceDelta, None]:
    (d,) = ins
    with span("filter"):
        keep = _as(_apply_rowfn(op.pred, op.vectorized, d.values),
                   torch.bool, d.values.device)
        w = torch.where(keep, d.weights, 0)
    return DeviceDelta(d.keys, d.values, w), None


def _lower_groupby(op, node: Node, state, ins, *, on_sync=None
                   ) -> Tuple[DeviceDelta, None]:
    (d,) = ins
    dev = d.keys.device
    with span("groupby"):
        keys = _as(_apply_rowfn(op.key_fn, op.vectorized, d.keys, d.values),
                   torch.int32, dev)
        # keep padding rows at key 0 so downstream scatters stay in range
        keys = torch.where(d.weights == 0, 0, keys)
        vals = d.values
        if op.value_fn is not None:
            vals = _as(_apply_rowfn(op.value_fn, op.vectorized, d.keys,
                                    d.values),
                       torch_dtype(node.spec.value_dtype), dev)
    return DeviceDelta(keys, vals, d.weights), None


def _lower_union(op, node: Node, state, ins, *, on_sync=None
                 ) -> Tuple[DeviceDelta, None]:
    live = [d for d in ins if d is not None]  # absent streams vanish
    if len(live) == 1:
        return live[0], None
    with span("union"):
        return DeviceDelta(
            torch.cat([d.keys for d in live]),
            torch.cat([d.values for d in live]),
            torch.cat([d.weights for d in live]),
        ), None


# -- Reduce (linear: sum / count / mean) -----------------------------------

def _agg_tables(op, wsum, wcnt, vdtype):
    """(aggregate, exists) per key from the running linear tables.

    Existence mirrors the host oracle's linear-observable rule: a group
    exists iff Σw != 0 or Σw·v != 0. For sum with ``tol > 0`` the Σw·v
    test is tol-guarded, so float scatter-add residue after a full
    retraction leaves no phantom group behind.
    """
    if op.how == "sum":
        agg = wsum.to(vdtype)
        nz = torch.abs(wsum) > op.tol if op.tol > 0.0 else wsum != 0
        if nz.dim() > 1:
            nz = torch.any(nz.flatten(1), dim=1)
        exists = (wcnt != 0) | nz
    elif op.how == "count":
        agg = wcnt.to(vdtype)
        exists = wcnt != 0
    elif op.how == "mean":
        denom = torch.where(wcnt == 0, 1, wcnt)
        agg = (wsum / _bcast_w(denom, wsum)).to(vdtype)
        exists = wcnt != 0
    else:  # pragma: no cover - refused at bind
        raise NotImplementedError(op.how)
    return agg, exists


#: spare rows below a scatter-add table that take the rows adding nothing
SPREAD_ROWS = 1024


def _scatter_contribs(d: DeviceDelta, K: int):
    """One fused scatter-add of (w·v, w) into a [K, F+1] table (one
    scatter of the stacked columns instead of two). Rows whose key lies
    outside the table are dropped.

    Rows of weight 0 add zeros; they are sent, by row number, to
    ``SPREAD_ROWS`` spare rows below the table (sliced off after) rather
    than to their key. A loop pass hands the dense Reduce millions of
    them, all at key 0 (GroupBy parks dead rows there), and their atomic
    adds on one address would serialize."""
    C = d.capacity
    idx, inb = _table_index(d.keys, K)
    w = torch.where(inb, d.weights, 0)
    vflat = _masked_contrib(w, d.values).to(torch.float32).reshape(C, -1)
    upd = torch.cat([vflat, w.to(torch.float32)[:, None]], dim=-1)
    spare = K + torch.arange(C, device=idx.device) % SPREAD_ROWS
    tgt = torch.where(w != 0, idx, spare)
    table = torch.zeros((K + SPREAD_ROWS, upd.shape[1]), dtype=torch.float32,
                        device=upd.device).index_add_(0, tgt, upd)[:K]
    dws = table[:, :-1].reshape((K,) + tuple(d.values.shape[1:]))
    # weights are ints; their float32 sum is exact below 2**24 rows/key
    dwc = table[:, -1].to(torch.int32)
    return dws, dwc


def _emit(keys, old, new, ret_m, ins_m) -> DeviceDelta:
    """Retract-old / insert-new rows for the keys whose masks are set."""
    return DeviceDelta(
        keys=torch.cat([keys, keys]),
        values=torch.cat([old, new]),
        weights=torch.cat([-ret_m.to(torch.int32), ins_m.to(torch.int32)]))


def _lower_reduce(op, node: Node, state, ins, *, on_sync=None
                  ) -> Tuple[DeviceDelta, dict]:
    (d,) = ins
    K = node.inputs[0].spec.key_space
    C = d.capacity
    vdtype = torch_dtype(node.spec.value_dtype)
    if op.how not in LINEAR_DEVICE_REDUCERS:
        return minmax_core(op, K, tuple(node.spec.value_shape), vdtype,
                           state, d)
    dev = d.keys.device
    emitted, em_has = state["emitted"], state["emitted_has"]

    if C >= K:
        # dense mode: diff the whole aggregate table against what was
        # emitted — no sort, pure vector ops (the PageRank-iteration shape)
        with span("reduce.scatter_add"):
            dws, dwc = _scatter_contribs(d, K)
            wsum = state["wsum"] + dws
            wcnt = state["wcnt"] + dwc
        with span("reduce.diff"):
            agg, exists = _agg_tables(op, wsum, wcnt, vdtype)
            changed = _differs(agg, emitted, op.tol)
            ins_m = exists & (~em_has | changed)
            ret_m = em_has & (~exists | changed)
            out = _emit(torch.arange(K, dtype=torch.int32, device=dev),
                        emitted, agg, ret_m, ins_m)
            new_emitted = torch.where(_bcast_w(ins_m, agg), agg, emitted)
            new_has = torch.where(ins_m, True,
                                  torch.where(ret_m & ~exists, False, em_has))
        return out, {"wsum": wsum, "wcnt": wcnt, "emitted": new_emitted,
                     "emitted_has": new_has}

    # sparse mode: O(C) end to end, never O(K) — contributions scatter-add
    # straight into the persistent tables (in place), and aggregation and
    # emission run only on the gathered touched rows
    idx, inb = _table_index(d.keys, K)
    w = torch.where(inb, d.weights, 0)
    wsum, wcnt = state["wsum"], state["wcnt"]
    with span("reduce.scatter_add"):
        contrib = _masked_contrib(w, d.values).to(torch.float32)
        # rows of weight 0 add zeros: spread them over distinct keys
        # rather than pile their atomics on their key (padding: key 0)
        tgt = torch.where(w != 0, idx,
                          torch.arange(C, device=dev) % K)
        wsum.index_add_(0, tgt, contrib.to(wsum.dtype))
        wcnt.index_add_(0, tgt, w)

    with span("reduce.sort"):
        live = w != 0
        skey = torch.where(live, idx, K)
        sk = torch.sort(skey, stable=True).values
        prev = torch.cat([torch.full((1,), -1, dtype=sk.dtype, device=dev),
                          sk[:-1]])
        first = (sk != prev) & (sk < K)
        tk = torch.where(sk < K, sk, 0)

    with span("reduce.diff"):
        agg, exists = _agg_tables(op, wsum[tk], wcnt[tk], vdtype)
        em = emitted[tk]
        has = em_has[tk]
        changed = _differs(agg, em, op.tol)
        ins_m = first & exists & (~has | changed)
        ret_m = first & has & (~exists | changed)
        out = _emit(tk.to(torch.int32), em, agg, ret_m, ins_m)
        _masked_set_(emitted, tk, ins_m, agg)
        _masked_set_(em_has, tk, ins_m, torch.ones_like(ins_m))
        gone = ret_m & ~exists
        _masked_set_(em_has, tk, gone, torch.zeros_like(gone))
    return out, {"wsum": wsum, "wcnt": wcnt, "emitted": emitted,
                 "emitted_has": em_has}


# -- Reduce (min / max: the bounded candidate buffer) ----------------------

def minmax_state(op, K: int, in_vshape, out_vshape, odtype, device) -> dict:
    """State of the retraction-capable min/max, scalar and vector values
    alike (a scalar is the V = 1 row case), with the JAX package's names,
    shapes and dtypes.

    Values ride sign-normalized (``sign·v``: +1 for min, -1 for max), so
    one lex-min serves both. ``cand_v``/``cand_w`` hold the R lex-smallest
    distinct value rows of each key with their multiset weights (any
    sign: anti-rows are legal transients), in ascending lex order.
    ``over_lo`` is a monotone watermark, the lex-smallest row ever
    evicted; ``over_maybe_pos`` latches whether a positive-net row was
    ever evicted. Together they bound what the buffer can prove (see
    :func:`minmax_core`); only :func:`minmax_refresh_core` resets them.
    """
    R = op.candidates
    V = 1
    for s in in_vshape:
        V *= s
    inf = float("inf")

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "cand_v": full((K, R, V), inf, torch.float32),
        "cand_w": full((K, R), 0, torch.int32),
        "over_lo": full((K, V), inf, torch.float32),
        "over_maybe_pos": full((K,), False, torch.bool),
        "emitted": full((K,) + tuple(out_vshape), 0, odtype),
        "emitted_has": full((K,), False, torch.bool),
        "error": full((), False, torch.bool),
    }


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """float32 values -> int32 keys that sort as the JAX package's sort
    comparator orders floats: -0.0 and +0.0 equal (both +0.0 here), every
    NaN one value above +inf. Sorting these integers instead of the
    floats keeps the order identical on the CPU and the card."""
    v = torch.where(v == 0, 0.0, v)
    v = torch.where(torch.isnan(v), float("nan"), v)
    b = v.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < b`` over the trailing axis (equal -> False):
    the CPU oracle's min of vector values is the min of value tuples, so
    candidate rows order lexicographically, never elementwise."""
    neq = a != b
    has = torch.any(neq, dim=-1)
    fi = torch.argmax(neq.to(torch.int32), dim=-1, keepdim=True)
    av = torch.gather(a, -1, fi)[..., 0]
    bv = torch.gather(b, -1, fi)[..., 0]
    return torch.where(has, av < bv, False)


def minmax_core(op, K: int, out_vshape, odtype, state, d: DeviceDelta
                ) -> Tuple[DeviceDelta, dict]:
    """One tick of the buffered min/max over keys ``[0, K)``.

    As in the JAX package: compact the tick's touched keys into slots,
    gather their buffers, merge buffer rows and delta rows by (slot,
    normalized value row) with one lexicographic sort, net bit-equal
    rows' weights, keep the R lex-best nonzero rows of each slot (ranked
    by a running count, so the buffer stays sorted), evict the rest into
    the ``over_lo``/``over_maybe_pos`` latches and write the rebuilt
    buffers back. The first positive row of a buffer is the true extremum
    iff it is strictly lex-below ``over_lo``; when later retractions
    hollow the buffer past that point the answer is unknowable from
    bounded state and the sticky ``error`` is set. Rows of a key outside
    ``[0, K)`` are dropped (a negative key wraps once).

    **Slots.** The JAX package sizes the slot table by the delta's
    capacity ``C`` (``C·R + C`` merged rows a call). At most ``min(C,
    K)`` keys can be touched, and every slot past the touched keys holds
    nothing, so ``S = min(C, K)`` slots give the same state and the same
    emission bit for bit, and sort ``S·R + C`` rows. In an SSSP loop pass
    ``C`` is twice the Join's arena (its two δA halves): millions of rows,
    where ``S`` is the node count.

    **The lexsort.** PyTorch has none: a chain of stable sorts, the last
    value column first and the slot last (``_lex_order``), over the
    values' :func:`_order_key` integers, so ``-0.0``/``+0.0``, ``inf`` and
    NaN order as JAX orders them.

    In place: ``cand_v``, ``cand_w``, ``over_lo`` and ``over_maybe_pos``
    are written at the touched keys only (the ``state`` dict passed in is
    consumed). The emission is the JAX package's dense one: a retract and
    an insert row for every key, weight 0 where nothing changed.
    """
    sign = 1.0 if op.how == "min" else -1.0
    cand_v, cand_w = state["cand_v"], state["cand_w"]
    over_lo, over_pos = state["over_lo"], state["over_maybe_pos"]
    R, V = cand_v.shape[1], cand_v.shape[2]
    C = d.capacity
    S = min(C, K)
    dev = d.keys.device
    inf = float("inf")

    with span("reduce.minmax.slots"):
        idx, inb = _table_index(d.keys, K)
        live = (d.weights != 0) & inb
        dval = torch.where(live[:, None],
                           d.values.reshape(C, V).to(torch.float32) * sign,
                           inf)
        # touched keys -> dense slots [0, n_t); dead rows sort last (K).
        # Sort keys are int32 (half the radix passes of int64)
        skey = torch.where(live, idx, K).to(torch.int32)
        sk, order = torch.sort(skey, stable=True)
        sk = sk.long()
        prev = torch.cat([sk.new_full((1,), -1), sk[:-1]])
        first = (sk != prev) & (sk < K)
        slot_sorted = torch.cumsum(first.to(torch.int64), 0) - 1
        # slot -> key (a spare slot S takes the rows that start no slot)
        tkeys = torch.full((S + 1,), K, dtype=torch.int64, device=dev)
        tkeys[torch.where(first, slot_sorted, S)] = sk
        tkeys = tkeys[:S]
        # original row -> slot (dead rows -> S)
        row_slot = torch.empty((C,), dtype=torch.int64, device=dev)
        row_slot[order] = torch.where(sk < K, slot_sorted, S)

        tvalid = tkeys < K
        tk_c = tkeys.clamp(max=K - 1)
        bw = torch.where(tvalid[:, None], cand_w[tk_c], 0)        # [S, R]
        bv = torch.where((bw != 0)[:, :, None], cand_v[tk_c], inf)

        # merged candidate rows: S·R buffer rows + C delta rows
        slot_b = torch.where(
            bw.reshape(-1) != 0,
            torch.arange(S, device=dev).repeat_interleave(R), S)
        mslot = torch.cat([slot_b, row_slot])
        mval = torch.cat([bv.reshape(S * R, V), dval])            # [M, V]
        mw = torch.cat([bw.reshape(-1), torch.where(live, d.weights, 0)])
        M = mslot.shape[0]

    with span("reduce.minmax.sort"):
        o2 = _lex_order(mslot.to(torch.int32), _order_key(mval))
        s2, v2, w2 = mslot[o2], mval[o2], mw[o2]

    with span("reduce.minmax.rank"):
        pv = torch.cat([s2.new_full((1,), -1), s2[:-1]])
        pval = torch.cat([v2.new_full((1, V), -inf), v2[:-1]])
        in_slot = s2 < S
        first2 = ((s2 != pv) | torch.any(v2 != pval, dim=1)) & in_slot
        gid = torch.cumsum(first2.to(torch.int64), 0) - 1
        gid_c = torch.where(in_slot, gid, M - 1)
        # rows outside every slot add nothing: JAX sends them to group
        # M - 1, the port to SPREAD_ROWS spare rows by row number (millions
        # of atomic adds on one address would serialize)
        spare = M + torch.arange(M, device=dev) % SPREAD_ROWS
        netw = torch.zeros((M + SPREAD_ROWS,), dtype=torch.int32,
                           device=dev).index_add_(
            0, torch.where(in_slot, gid, spare),
            torch.where(in_slot, w2, 0))[:M]
        net_here = netw[gid_c]
        alive = first2 & (net_here != 0)

        # rank among the alive rows of each slot
        alive_i = alive.to(torch.int64)
        ca = torch.cumsum(alive_i, 0)
        slot_start = (s2 != pv) & in_slot
        base = torch.zeros((S + 1,), dtype=torch.int64, device=dev)
        base[torch.where(slot_start, s2, S)] = ca - alive_i
        rank = ca - 1 - base[s2.clamp(max=S)]
        keep = alive & (rank < R)
        evict = alive & (rank >= R)

    with span("reduce.minmax.rebuild"):
        # rebuilt buffers per slot (rank-ordered: ascending lex)
        flat = torch.where(keep, s2.clamp(max=S - 1) * R + rank, S * R)
        nb_v = torch.full((S * R + 1, V), inf, device=dev)
        nb_v[flat] = v2
        nb_v = nb_v[:S * R].reshape(S, R, V)
        nb_w = torch.zeros((S * R + 1,), dtype=torch.int32, device=dev)
        nb_w[flat] = net_here
        nb_w = nb_w[:S * R].reshape(S, R)

        # the slot's first evicted row (rank == R) is its lex-smallest
        # evicted: it lowers the watermark; a positive-net eviction
        # latches over_maybe_pos (both monotone)
        ev_lo = torch.full((S + 1, V), inf, device=dev)
        ev_lo[torch.where(evict & (rank == R), s2, S)] = v2
        ev_lo = ev_lo[:S]
        ev_pos = torch.zeros((S + 1,), dtype=torch.bool, device=dev)
        ev_pos[torch.where(evict & (net_here > 0), s2, S)] = True
        ev_pos = ev_pos[:S]

        lo_g = torch.where(tvalid[:, None], over_lo[tk_c], inf)
        new_lo = torch.where(_lex_lt(ev_lo, lo_g)[:, None], ev_lo, lo_g)
        pos_g = over_pos[tk_c] | ev_pos
        _masked_set_(cand_v, tk_c, tvalid, nb_v)
        _masked_set_(cand_w, tk_c, tvalid, nb_w)
        _masked_set_(over_lo, tk_c, tvalid, new_lo)
        _masked_set_(over_pos, tk_c, tvalid, pos_g)

    with span("reduce.minmax.emit"):
        # dense aggregate over the key range. Existence is the CPU
        # oracle's any(w > 0), provable from the buffer unless a positive
        # row was ever evicted; the buffered minimum is exact only when
        # strictly lex-below the watermark (at equality an evicted
        # anti-row at that value could cancel the buffered support)
        pos = cand_w > 0                                          # [K, R]
        has_pos = torch.any(pos, dim=1)
        fi = torch.argmax(pos.to(torch.int32), dim=1)
        bmin = torch.gather(cand_v, 1,
                            fi[:, None, None].expand(K, 1, V))[:, 0]
        unknown = ((~has_pos & over_pos)
                   | (has_pos & ~_lex_lt(bmin, over_lo)))
        exists = has_pos
        # cand_w nets weights across ticks; latch loudly at 2**30, far
        # below an int32 wrap
        w_over = torch.any(torch.abs(nb_w) > (1 << 30))
        error = state["error"] | torch.any(unknown) | w_over

        emitted, em_has = state["emitted"], state["emitted_has"]
        agg_rows = torch.where(has_pos[:, None], bmin, 0.0) * sign
        aggv = agg_rows.reshape((K,) + tuple(out_vshape)).to(odtype)
        changed = _differs(aggv, emitted, op.tol)
        ins_m = exists & ~unknown & (~em_has | changed)
        ret_m = em_has & ((~exists | changed) & ~unknown)
        out = _emit(torch.arange(K, dtype=torch.int32, device=dev),
                    emitted, aggv, ret_m, ins_m)
        new_emitted = torch.where(_bcast_w(ins_m, aggv), aggv, emitted)
        new_has = torch.where(ins_m, True,
                              torch.where(ret_m & ~exists, False, em_has))
    return out, {"cand_v": cand_v, "cand_w": cand_w, "over_lo": over_lo,
                 "over_maybe_pos": over_pos, "emitted": new_emitted,
                 "emitted_has": new_has, "error": error}


def minmax_refresh_core(op, K: int, out_vshape, odtype, state,
                        d: DeviceDelta) -> dict:
    """Latch refresh: rebuild the candidate buffers of every key present
    in ``d`` from a replay of its full live multiset (one +w row per
    entry), resetting its ``over_lo``/``over_maybe_pos`` latches — the
    maintenance that keeps a heavy-churn key exact instead of tripping
    the overflow error. The replay is the collection the state already
    aggregates, so the aggregate cannot change: a live emission out of
    it means the replay contradicts the state and sets the sticky
    ``error`` instead."""
    idx, inb = _table_index(d.keys, K)
    live = (d.weights != 0) & inb
    touched = torch.zeros((K + 1,), dtype=torch.bool, device=idx.device)
    touched[torch.where(live, idx, K)] = True
    touched = touched[:K]
    st = dict(state)
    tb = touched[:, None]
    st["cand_v"] = torch.where(touched[:, None, None], float("inf"),
                               state["cand_v"])
    st["cand_w"] = torch.where(tb, 0, state["cand_w"])
    st["over_lo"] = torch.where(tb, float("inf"), state["over_lo"])
    st["over_maybe_pos"] = torch.where(touched, False,
                                       state["over_maybe_pos"])
    out, st2 = minmax_core(op, K, out_vshape, odtype, st, d)
    st2["error"] = st2["error"] | torch.any(out.weights != 0)
    return st2


# -- Join (unique left: dense left table x right append arena) -------------

def _lower_join(op, node: Node, state, ins, *, on_sync=None
                ) -> Tuple[DeviceDelta, dict]:
    da, db = ins
    return join_core(op, node.inputs[0].spec.key_space, op.arena_capacity,
                     torch_dtype(node.spec.value_dtype), state, da, db,
                     oshape=tuple(node.spec.value_shape), on_sync=on_sync)


def _append_arena_(state: dict, keys, vals, w, R: int, on_sync) -> dict:
    """Append the live rows of a delta to an append arena (live rows
    first), compacting first when the append would cross capacity. The
    arena is the dict's ``rkeys``/``rvals``/``rw``/``rcount``/``gen``
    fields (the multiset join's left arena is handed in with its fields
    aliased to those names).

    The JAX package makes that choice on the device (``lax.cond``); here
    it is made on the host from one scalar readback per append, reported
    through ``on_sync``. Rows beyond capacity even after compaction are
    dropped and set the sticky ``error`` flag. Writes the arena tensors
    in place (or, after a compaction, the compacted copies) and returns
    the updated state."""
    live = w != 0
    n_app = live.sum(dtype=torch.int32)
    over = state["rcount"] + n_app > R
    if on_sync is not None:
        on_sync()
    if bool(over.item()):
        with span("arena.compact"):
            state = compact_arena(state)
    with span("arena.append"):
        rank = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
        pos = (state["rcount"] + rank).long()
        fits = live & (pos < R)
        pos = pos.clamp(max=R - 1)
        _masked_set_(state["rkeys"], pos, fits, keys)
        _masked_set_(state["rvals"], pos, fits, vals)
        _masked_set_(state["rw"], pos, fits, w)
        state["rcount"] = state["rcount"] + n_app
        state["error"] = state["error"] | (state["rcount"] > R)
    return state


def _keyed_product(dk, dv, dw, ak, av, aw, K: int, T: int, emit
                   ) -> Tuple[DeviceDelta, torch.Tensor]:
    """Key-matched delta × arena pair enumeration at the fixed budget
    ``T``: each live delta row pairs with every live arena row of its key.

    As in the JAX package: a CSR over the arena by key (a stable sort of
    the keys, dead rows at the sentinel ``K``; a degree histogram; its
    exclusive cumsum), each delta row's segment of pair slots from the
    cumsum of its degree, and each slot's owning row by scattering the
    row index at its segment's start and forward-filling with a running
    max (``scatter_reduce_("amax")`` into a ``T + 1`` buffer whose spare
    slot takes the segments that start at or past ``T``, then
    ``torch.cummax``). A true pair count beyond ``T`` returns ``overflow``
    as a device flag (the caller folds it into the sticky error; nothing
    is read back). ``emit(keys, v_delta, v_arena)`` -> merged values."""
    C = dk.shape[0]
    R = ak.shape[0]
    dev = dk.device
    with span("join.product"):
        skey = torch.where(aw != 0, ak.long().clamp(0, K - 1), K)
        order = torch.sort(skey, stable=True).indices
        # dead rows count at spare rows past K (by row number), not all
        # at the sentinel K
        hist = torch.where(aw != 0, skey,
                           K + torch.arange(R, device=dev) % SPREAD_ROWS)
        deg = torch.zeros((K + SPREAD_ROWS,), dtype=torch.int64, device=dev)
        deg = deg.index_add_(0, hist, torch.ones_like(hist))[:K]
        starts = torch.cumsum(deg, 0) - deg
        k_c = dk.long().clamp(0, K - 1)
        di = torch.where(dw != 0, deg[k_c], 0)
        cum = torch.cumsum(di, 0)
        total = cum[-1]
        seg0 = cum - di
        overflow = total > T
        spos = torch.where((di > 0) & (seg0 < T), seg0, T)
        marks = torch.zeros((T + 1,), dtype=torch.int64, device=dev)
        marks.scatter_reduce_(0, spos, torch.arange(C, device=dev), "amax")
        owner = torch.cummax(marks[:T], 0).values.clamp(0, C - 1)
        j = torch.arange(T, device=dev)
        within = j - seg0[owner]
        d_own = di[owner]
        valid = (j < total) & (d_own > 0) & (within < d_own)
        row = order[(starts[k_c[owner]] + within).clamp(0, R - 1)]
        k = k_c[owner].to(torch.int32)
        w = torch.where(valid, dw[owner] * aw[row], 0)
        vals = emit(k, dv[owner], av[row])
    return DeviceDelta(k, vals, w), overflow


def _join_core_multiset(op, K: int, R: int, state,
                        da: Optional[DeviceDelta], db: Optional[DeviceDelta],
                        merge_v, on_sync) -> Tuple[DeviceDelta, dict]:
    """Two-arena join: both sides are append logs, and both δ-products
    are key-matched pair enumerations (δA against the old right arena,
    δB against the left arena after δA's append: the bilinear update
    δA⋈B + (A+δA)⋈δB) at budgets of ``product_slack`` × the delta's
    capacity. A budget or arena overflow sets the sticky error.

    Each side's append makes its own compact-before-append decision on
    the host (one readback through ``on_sync``), so a tick with both
    sides live reads back twice."""
    st = dict(state)
    err = st["error"]
    outs = []
    if da is not None:
        out_a, ovf = _keyed_product(
            da.keys, da.values, da.weights, st["rkeys"], st["rvals"],
            st["rw"], K, op.product_slack * da.capacity, merge_v)
        outs.append(out_a)
        err = err | ovf
        left = {"rkeys": st["lkeys"], "rvals": st["lvals"], "rw": st["lrw"],
                "rcount": st["lcount"], "gen": st["lgen"], "error": err}
        with span("join.append_left"):
            left = _append_arena_(left, da.keys, da.values, da.weights,
                                  st["lkeys"].shape[0], on_sync)
        st.update(lkeys=left["rkeys"], lvals=left["rvals"], lrw=left["rw"],
                  lcount=left["rcount"], lgen=left["gen"])
        err = left["error"]
    if db is not None:
        # (A + δA) ⋈ δB: the delta is the right side and the arena the
        # left, so the merge gets its value arguments swapped back
        out_b, ovf = _keyed_product(
            db.keys, db.values, db.weights, st["lkeys"], st["lvals"],
            st["lrw"], K, op.product_slack * db.capacity,
            lambda k, vd, va_: merge_v(k, va_, vd))
        outs.append(out_b)
        st["error"] = err | ovf
        st = _append_arena_(st, db.keys, db.values, db.weights, R, on_sync)
        err = st["error"]
    st["error"] = err
    with span("join.concat"):
        out = DeviceDelta(torch.cat([o.keys for o in outs]),
                          torch.cat([o.values for o in outs]),
                          torch.cat([o.weights for o in outs]))
    return out, st


def join_core(op, K: int, R: int, odtype, state,
              da: Optional[DeviceDelta], db: Optional[DeviceDelta], *,
              oshape=None, on_sync=None) -> Tuple[DeviceDelta, dict]:
    """δ(A⋈B) = δA⋈B_old + (A+δA)⋈δB.

    A ``None`` side is absent: its product, fold and append do not run —
    a tick that only delivers right-side deltas never sweeps the arena,
    and a loop pass with no right deltas never appends. Over the
    unique-left state δA splits into its retract and insert halves,
    scattered into dense ``[K]`` tables, so the arena-side product is a
    pure gather over the arena; the multiset-left state (a second arena,
    ``lkeys``/...) takes :func:`_join_core_multiset`.
    """

    def merge_v(keys, va, vb):
        if op.merge is None:
            # default merge: the flattened value pair, the device
            # encoding of the host oracle's (va, vb) tuple
            n = va.shape[0]
            out = torch.cat([va.to(odtype).reshape(n, -1),
                             vb.to(odtype).reshape(n, -1)], dim=-1)
            return out.reshape((n,) + tuple(oshape))
        return _as(op.merge(keys, va, vb), odtype, keys.device)

    if "lkeys" in state:
        return _join_core_multiset(op, K, R, state, da, db, merge_v, on_sync)

    st = dict(state)
    ak, av, aw = st["rkeys"], st["rvals"], st["rw"]
    lval, lw = st["lval"], st["lw"]
    outs = []

    if da is not None:
        wa = da.weights
        didx, dinb = _table_index(da.keys, K)
        with span("join.scatter_delta"):
            # fresh [K + 1] tables: rows outside a half go to the extra
            # row K, which no arena gather (indices < K) reads
            halves = []
            for m in (dinb & (wa < 0), dinb & (wa > 0)):
                tgt = torch.where(m, didx, K)
                tab = da.values.new_zeros((K + 1,)
                                          + tuple(da.values.shape[1:]))
                tab[tgt] = da.values
                tw = wa.new_zeros((K + 1,))
                tw[tgt] = wa
                halves.append((tab, tw))
        # δA ⋈ B_old: a pure gather over the whole arena
        with span("join.gather"):
            aidx, _ = _table_index(ak, K)
            for tab, tw in halves:
                w = tw[aidx] * aw
                outs.append(DeviceDelta(ak, merge_v(ak, tab[aidx], av), w))
        # fold δA into the left table
        with span("join.scatter_delta"):
            lw.index_add_(0, didx, torch.where(dinb, wa, 0))
            _masked_set_(lval, didx, dinb & (wa > 0), da.values)

    if db is not None:
        # (A + δA) ⋈ δB: a gather from the left table
        kb, vb, wb = db.keys, db.values, db.weights
        with span("join.probe"):
            bidx, _ = _table_index(kb, K)
            outs.append(DeviceDelta(kb, merge_v(kb, lval[bidx], vb),
                                    lw[bidx] * wb))
        st = _append_arena_(st, kb, vb, wb, R, on_sync)

    with span("join.concat"):
        out = DeviceDelta(torch.cat([o.keys for o in outs]),
                          torch.cat([o.values for o in outs]),
                          torch.cat([o.weights for o in outs]))
    return out, st


# -- dispatch ---------------------------------------------------------------

LOWERINGS = {
    "map": _lower_map,
    "filter": _lower_filter,
    "groupby": _lower_groupby,
    "union": _lower_union,
    "reduce": _lower_reduce,
    "join": _lower_join,
    "knn": _lower_knn,
}


def lower_node(node: Node, state, ins: Sequence[Optional[DeviceDelta]], *,
               on_sync=None) -> Tuple[DeviceDelta, Optional[dict]]:
    return LOWERINGS[node.op.kind](node.op, node, state, ins,
                                   on_sync=on_sync)
