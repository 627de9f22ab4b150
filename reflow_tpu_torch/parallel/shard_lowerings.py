"""Shard-aware op lowerings: one shard's part of a sharded pass.

The counterpart of ``reflow_tpu/parallel/shard_lowerings.py``. Each
keyed lowering here is a generator body of the SPMD runtime
(``parallel/spmd.py``): it runs on one shard's slice of the delta and of
the state, and yields at each collective. The design is the JAX
package's (route rows to their key's owner, shard what is big):

- **Map / Filter / GroupBy / Union** are shard-local on row-sharded
  deltas: the single-device lowerings run unchanged.
- **Row routing** (:func:`route_rows`): one ``all_to_all`` on
  shard-of-key delivers every live row to the shard owning its key
  range, in per-destination buckets of ``ROUTE_SLACK`` x the balanced
  share; a row past its bucket sets a sticky per-node error, never a
  silent truncation. On a 2-axis ``(dcn, delta)`` mesh the route takes
  two legs (:func:`_route_rows_hier`): one exchange inside each dcn row,
  then ONE across the dcn axis.
- **Reduce**: sparse regime (delta well under the key slice) routes rows
  and folds them with the single-device core on the owned slice; dense
  regime scatters a full-K table and combines it with one
  ``psum_scatter``. Min/max route to owners (or gather and mask on small
  meshes) and run the candidate-buffer core on the owned slice.
- **Join**: both delta sides reach their key's owner and the
  single-device core runs over the shard's slice of the left table and
  of the append arena. Arena rows therefore carry shard-LOCAL keys (the
  sharded fused loop's per-shard CSR relies on it). The arenas'
  compact-before-append decisions of every shard come back in one
  readback.
- **KnnIndex**: the corpus is row-sharded, queries and the emitted table
  are replicated (each shard holds its own copy: the folds write them in
  place). A rescan runs the top-k scan step kernel over each shard's
  corpus slice, then a ring merge over ``ppermute`` (n - 1 hops, each a
  ``[Q, 2k]`` top-k by the kernel); an incremental tick scores the delta
  docs on their owner, combines with one ``pmax`` and takes the top k of
  ``[Q, k + Cd]`` by the kernel. The path choice is uniform: every
  shard's flag comes back in one readback.

Keyed state is range-sharded: shard ``i`` of ``n`` owns keys
``[i*K/n, (i+1)*K/n)``.

Where the JAX package drops out-of-range scatter rows (``mode="drop"``),
the bucket writes here send them to one spare row past the buffer,
sliced off.
"""

from __future__ import annotations

import inspect
from typing import Optional, Sequence, Tuple

import torch

from reflow_tpu_torch.delta import torch_dtype
from reflow_tpu_torch.executors.device_delta import MIN_CAPACITY, DeviceDelta
from reflow_tpu_torch.executors.lowerings import (
    LINEAR_DEVICE_REDUCERS, LOWERINGS, _as, _fold_vectors_,
    _scatter_contribs, _table_index, join_core, minmax_core, reduce_core,
    reduce_dense_fold, span)
from reflow_tpu_torch.graph import GraphError, Node
from reflow_tpu_torch.kernels.topk import (NEG, chunked_corpus_topk, scores,
                                           topk)

__all__ = ["ROUTE_SLACK", "deliver_to_owner", "knn_state_specs",
           "lower_node_sharded", "route_rows"]

#: per-destination row budget = ROUTE_SLACK x the perfectly balanced
#: share; pathological skew trips the sticky overflow flag instead
ROUTE_SLACK = 4
#: the Join and min/max route a delta only when its per-destination
#: budget is at least this many rows (thin budgets trip on ordinary
#: randomness; a small delta is cheap to replicate)
_MIN_ROUTE_BUDGET = 64


def _should_route(n: int, Cl: int) -> bool:
    """The routed-vs-replicated policy (Join, min/max): route when the
    mesh is big enough for all_to_all to beat all_gather AND the
    per-destination budget is thick enough."""
    return n > ROUTE_SLACK and ROUTE_SLACK * Cl >= _MIN_ROUTE_BUDGET * n


def _localize(d: DeviceDelta, base: int, Kl: int) -> DeviceDelta:
    """A gathered delta masked to this shard's key range, keys re-based;
    rows it does not own become weight-0 padding at local key 0."""
    own = (d.keys >= base) & (d.keys < base + Kl)
    return DeviceDelta(torch.where(own, d.keys - base, 0), d.values,
                       torch.where(own, d.weights, 0))


def _bucket_exchange(ctx, d: DeviceDelta, dest: torch.Tensor, n_sub: int,
                     B: int, axis):
    """One bucketed ``all_to_all`` leg: rows with ``dest`` in ``[0,
    n_sub)`` pack into per-destination buckets of ``B`` slots (``dest ==
    n_sub``: dead rows, not sent), exchange along ``axis``; returns the
    ``n_sub * B`` rows received (keys untouched) and this shard's
    overflow flag."""
    Cl = d.capacity
    dev = d.keys.device
    order = torch.sort(dest, stable=True).indices
    so = dest[order]
    sk, sv, sw = d.keys[order], d.values[order], d.weights[order]
    start = torch.searchsorted(so, torch.arange(n_sub, dtype=so.dtype,
                                                device=dev))
    slot = torch.arange(Cl, device=dev) - start[so.clamp(max=n_sub - 1)]
    ok = (so < n_sub) & (slot < B)
    err = torch.any((so < n_sub) & (slot >= B))
    # rows not sent go to one spare row past the buckets, sliced off
    pos = torch.where(ok, so * B + slot, n_sub * B)

    def pack(col, dtype):
        buf = torch.zeros((n_sub * B + 1,) + tuple(col.shape[1:]),
                          dtype=dtype, device=dev)
        buf[pos] = col
        return buf[:n_sub * B].reshape((n_sub, B) + tuple(col.shape[1:]))

    send = DeviceDelta(pack(sk, torch.int32), pack(sv, sv.dtype),
                       pack(sw, torch.int32))
    got = yield ctx.all_to_all(send, axis, 0, 0)
    return DeviceDelta(*(t.reshape((n_sub * B,) + tuple(t.shape[2:]))
                         for t in got)), err


def route_rows(ctx, d: DeviceDelta, axis, n: int, Kl: int,
               slack: int = ROUTE_SLACK):
    """Deliver each live row of this shard's delta slice to the shard
    owning its key (one ``all_to_all``). Returns a local-keyed delta of
    capacity ``n * B`` (``B = ceil(slack * Cl / n)``, weight-0 padding)
    and this shard's overflow flag (a live row past its bucket was NOT
    sent)."""
    Cl = d.capacity
    B = max(1, -(-slack * Cl // n))
    live = d.weights != 0
    owner = torch.where(live, torch.clamp(d.keys // Kl, 0, n - 1),
                        n).long()
    got, err = yield from _bucket_exchange(ctx, d, owner, n, B, axis)
    base = ctx.axis_index(axis) * Kl
    lk = torch.where(got.weights != 0, got.keys - base, 0)
    return DeviceDelta(lk, got.values, got.weights), err


def _route_rows_hier(ctx, d: DeviceDelta, axes: Tuple[str, str],
                     sizes: Tuple[int, int], Kl: int,
                     slack: int = ROUTE_SLACK):
    """Two-leg owner delivery on a ``(dcn, delta)`` mesh: an exchange
    inside each dcn row to the destination's column, then ONE exchange
    across the dcn axis. Owner ids are dcn-major (the executor's
    product-axis order): ``(own_dcn, own_col) = divmod(key // Kl,
    n_col)``."""
    dcn_ax, col_ax = axes
    n_dcn, n_col = sizes
    n = n_dcn * n_col
    Cl = d.capacity
    live = d.weights != 0
    owner = torch.where(live, torch.clamp(d.keys // Kl, 0, n - 1), n).long()
    own_col = torch.where(owner < n, owner % n_col, n_col)
    B1 = max(1, -(-slack * Cl // n_col))
    d1, err1 = yield from _bucket_exchange(ctx, d, own_col, n_col, B1,
                                           col_ax)
    # the second leg's buckets derive from the original live-row bound
    # Cl, as the JAX package's do
    live1 = d1.weights != 0
    owner1 = torch.where(live1, torch.clamp(d1.keys // Kl, 0, n - 1),
                         n).long()
    own_dcn = torch.where(owner1 < n, owner1 // n_col, n_dcn)
    B2 = max(1, -(-slack * Cl // n_dcn))
    d2, err2 = yield from _bucket_exchange(ctx, d1, own_dcn, n_dcn, B2,
                                           dcn_ax)
    base = ctx.axis_index(axes) * Kl
    lk = torch.where(d2.weights != 0, d2.keys - base, 0)
    return DeviceDelta(lk, d2.values, d2.weights), err1 | err2


def deliver_to_owner(ctx, d: DeviceDelta, axis, n: int, Kl: int,
                     sizes: Optional[Tuple[int, int]] = None):
    """Every live row of a row-sharded delta delivered to the shard
    owning its key: a LOCAL-keyed delta plus the route-overflow flag
    (combined over the mesh with ``pmax``). The one routed-vs-replicated
    policy of every keyed consumer (Join, min/max, the latch refresh)."""
    Cl = d.capacity
    if _should_route(n, Cl):
        if isinstance(axis, tuple) and sizes is not None:
            dl, err = yield from _route_rows_hier(ctx, d, axis, sizes, Kl)
        else:
            dl, err = yield from route_rows(ctx, d, axis, n, Kl)
        err = yield ctx.pmax(err.to(torch.int32), axis)
        return dl, err > 0
    base = ctx.axis_index(axis) * Kl
    g = yield ctx.all_gather(d, axis)
    return (_localize(g, base, Kl),
            torch.zeros((), dtype=torch.bool, device=d.keys.device))


def _lower_reduce_sharded(ctx, op, node: Node, state, ins, axis, n: int,
                          sizes=None, reader=None):
    (d,) = ins
    K = node.inputs[0].spec.key_space
    Kl = K // n
    Cl = d.capacity
    vdtype = torch_dtype(node.spec.value_dtype)
    base = ctx.axis_index(axis) * Kl
    err = state["error"]
    core = {k: state[k] for k in ("wsum", "wcnt", "emitted", "emitted_has")}
    if ROUTE_SLACK * Cl < Kl:
        # sparse regime: rows to their key's owner, folded by the
        # single-device core on the owned slice (traffic O(slack x Cl))
        if isinstance(axis, tuple) and sizes is not None:
            dl, route_err = yield from _route_rows_hier(ctx, d, axis, sizes,
                                                        Kl)
        else:
            dl, route_err = yield from route_rows(ctx, d, axis, n, Kl)
        route_err = yield ctx.pmax(route_err.to(torch.int32), axis)
        err = err | (route_err > 0)
        out, st = reduce_core(op, Kl, vdtype, core, dl, key_offset=base)
    else:
        # dense regime: full-K contributions and one reduce-scatter
        with span("reduce.scatter_add"):
            dws, dwc = _scatter_contribs(d, K)
            stacked = torch.cat([dws.reshape(K, -1),
                                 dwc.to(torch.float32)[:, None]], dim=-1)
        comb = yield ctx.psum_scatter(stacked, axis)
        vshape = tuple(d.values.shape[1:])
        out, st = reduce_dense_fold(
            op, vdtype, core, comb[:, :-1].reshape((Kl,) + vshape),
            comb[:, -1].to(torch.int32), key_offset=base)
    st["error"] = err
    return out, st


def _lower_reduce_minmax_sharded(ctx, op, node: Node, state, ins, axis,
                                 n: int, sizes=None, reader=None):
    """Min/max, key-sharded: rows reach their key's owner, then the
    candidate-buffer core runs on the owned slice; the error flags
    combine with ``pmax``."""
    (d,) = ins
    K = node.inputs[0].spec.key_space
    Kl = K // n
    base = ctx.axis_index(axis) * Kl
    dl, route_err = yield from deliver_to_owner(ctx, d, axis, n, Kl, sizes)
    core = dict(state)
    core["error"] = state["error"] | route_err
    out, st = minmax_core(op, Kl, tuple(node.spec.value_shape),
                          torch_dtype(node.spec.value_dtype), core, dl,
                          key_offset=base)
    e = yield ctx.pmax(st["error"].to(torch.int32), axis)
    st["error"] = e > 0
    return out, st


def _lower_join_sharded(ctx, op, node: Node, state, ins, axis, n: int,
                        sizes=None, reader=None):
    da, db = ins
    K = node.inputs[0].spec.key_space
    Kl = K // n
    Rl = op.arena_capacity // n
    base = ctx.axis_index(axis) * Kl
    err = state["error"]
    dl = []
    for d in (da, db):
        if d is None:
            dl.append(None)
            continue
        got, route_err = yield from deliver_to_owner(ctx, d, axis, n, Kl,
                                                     sizes)
        err = err | route_err
        dl.append(got)
    da_l, db_l = dl
    # per-shard counters ride as length-1 slices of mesh-length vectors
    # (the JAX package's global layout); the core wants scalars
    core = dict(state)
    scal = ("rcount", "gen", "lcount", "lgen")
    for f in scal:
        if f in core:
            core[f] = state[f][0]
    multiset = "lkeys" in state
    # every shard's compact-before-append decisions in one readback
    flags = []
    if multiset and da_l is not None:
        La = state["lkeys"].shape[0]
        flags.append(core["lcount"] + torch.count_nonzero(da_l.weights) > La)
    if db_l is not None:
        flags.append(core["rcount"] + torch.count_nonzero(db_l.weights) > Rl)
    compact = [None, None]
    if flags:
        rows = yield ctx.host_gather(torch.stack(flags), reader)
        own = [bool(v) for v in rows[ctx.rank]]
        if multiset and da_l is not None:
            compact[0] = own.pop(0)
        if db_l is not None:
            compact[1] = own.pop(0)
    out, st = join_core(op, Kl, Rl, torch_dtype(node.spec.value_dtype),
                        core, da_l, db_l, oshape=tuple(node.spec.value_shape),
                        key_offset=base, compact=tuple(compact))
    for f in scal:
        if f in st:
            st[f] = st[f].reshape(1)
    e = yield ctx.pmax(st["error"].to(torch.int32), axis)
    st["error"] = err | (e > 0)
    return out, st


def _merge2(av, ai, bv, bi, k: int):
    """Merge two ``[Q, k]`` candidate sets by the top-k kernel on ``[Q,
    2k]``, ties to the lowest id: (score desc, id asc) is a total order,
    so the pairwise ring merge equals one flat sort."""
    cv = torch.cat([av, bv], dim=1)
    ci = torch.cat([ai, bi], dim=1)
    key = torch.where(ci < 0, torch.iinfo(torch.int32).max, ci)
    order = torch.sort(key, dim=1, stable=True).indices
    ci = torch.gather(ci, 1, order)
    cv = torch.gather(cv, 1, order).contiguous()
    vals, sel = topk(cv, k)
    return vals, torch.gather(ci, 1, sel.long())


def _lower_knn_sharded(ctx, op, node: Node, state, ins, axis, n: int,
                       sizes=None, reader=None):
    """Corpus row-sharded k-NN (see the module docstring)."""
    dq, dd = ins
    dev = state["qvec"].device
    if dq is None:
        dq = DeviceDelta.empty(node.inputs[0].spec, MIN_CAPACITY, device=dev)
    if dd is None:
        dd = DeviceDelta.empty(node.inputs[1].spec, MIN_CAPACITY, device=dev)
    Q = node.inputs[0].spec.key_space
    D = node.inputs[1].spec.key_space
    Ql, Dl = Q // n, D // n
    k = op.k
    r = ctx.axis_index(axis)
    base_q, base_d = r * Ql, r * Dl

    # the deltas are replicated by one gather each: queries fold into
    # every shard's query table, docs into the owned corpus slice
    gq = yield ctx.all_gather(dq, axis)
    gd = yield ctx.all_gather(dd, axis)
    gd_l = _localize(gd, base_d, Dl)
    qvec, qlive = state["qvec"], state["qlive"]
    dvec, dlive = state["dvec"], state["dlive"]
    # an insert over a live doc is an update (rescan), checked against
    # the PRE-fold live mask on the doc's owner
    d_idx, _ = _table_index(gd_l.keys, Dl)
    doc_update = torch.any((gd_l.weights > 0) & dlive[d_idx])
    need = (torch.any(gd.weights < 0) | torch.any(gq.weights > 0)
            | doc_update)
    _fold_vectors_(qvec, qlive, gq)
    _fold_vectors_(dvec, dlive, gd_l)
    emitted, em_has = state["emitted"], state["em_has"]
    flags = yield ctx.host_gather(need.reshape(1), reader)
    need_full = any(row[0] for row in flags)

    if need_full:
        chunk = min(op.scan_chunk, Dl)
        vals_l, ids_l = chunked_corpus_topk(qvec, dvec, dlive, k, chunk)
        acc_v = vals_l
        acc_i = torch.where(vals_l <= NEG, -1, ids_l + base_d)
        # ring merge over neighbours: n - 1 hops of a [Q, k] window, each
        # merged into the local best (peak buffer [Q, 2k])
        perm = [(i, (i + 1) % n) for i in range(n)]
        cur_v, cur_i = acc_v, acc_i
        for _ in range(n - 1):
            cur_v, cur_i = yield ctx.ppermute((cur_v, cur_i), perm, axis)
            acc_v, acc_i = _merge2(acc_v, acc_i, cur_v, cur_i, k)
        vals, ids = acc_v, acc_i
    else:
        em_ids = emitted[:, :, 0].to(torch.int32)
        em_vals = torch.where(em_has[:, None] & (em_ids >= 0),
                              emitted[:, :, 1], NEG)
        # each delta doc scored on its owner (exactly the single-device
        # dvec[di] semantics), combined with one pmax; the others give NEG
        di = gd.keys
        own = (di >= base_d) & (di < base_d + Dl)
        di_l = torch.where(own, di - base_d, 0).long()
        s_loc = scores(qvec, dvec[di_l])
        s_loc = torch.where((own & (gd.weights > 0))[None, :], s_loc, NEG)
        s_new = yield ctx.pmax(s_loc, axis)
        cand_vals = torch.cat([em_vals, s_new], dim=1)
        cand_ids = torch.cat([em_ids, di.expand(Q, di.shape[0])], dim=1)
        cand_ids, order = torch.sort(cand_ids, dim=1, stable=True)
        cand_vals = torch.gather(cand_vals, 1, order)
        vals, sel = topk(cand_vals, k)
        ids = torch.gather(cand_ids, 1, sel.long())

    ids = torch.where(vals <= NEG, -1, ids)
    new_row = torch.stack([ids.float(), vals], dim=-1)          # [Q, k, 2]
    changed = torch.any((new_row != emitted).flatten(1), dim=1)
    ins_m = qlive & (~em_has | changed)
    ret_m = em_has & (~qlive | changed)
    # replicated tables; each shard EMITS its owned query range, so the
    # egress delta is row-sharded like every other op's
    sl = slice(base_q, base_q + Ql)
    qkeys = base_q + torch.arange(Ql, dtype=torch.int32, device=dev)
    out = DeviceDelta(
        keys=torch.cat([qkeys, qkeys]),
        values=torch.cat([emitted[sl], new_row[sl]]),
        weights=torch.cat([-ret_m[sl].to(torch.int32),
                           ins_m[sl].to(torch.int32)]))
    new_emitted = torch.where(ins_m[:, None, None], new_row, emitted)
    new_has = torch.where(ins_m, True, torch.where(ret_m & ~qlive, False,
                                                   em_has))
    return out, {"qvec": qvec, "qlive": qlive, "dvec": dvec, "dlive": dlive,
                 "emitted": new_emitted, "em_has": new_has}


def knn_state_specs() -> dict:
    """Which k-NN state leaves shard (True: the corpus) and which every
    shard holds whole (the queries and the emitted table)."""
    return {"qvec": False, "qlive": False, "dvec": True, "dlive": True,
            "emitted": False, "em_has": False}


def _lower_map_tp(ctx, op, node: Node, state, ins, axis, n: int,
                  sizes=None, reader=None):
    """A tensor-parallel Map (``param_specs``): the function gets this
    shard's params slice and may be a generator that yields its own
    collectives over the model axis (``models.vit.vit_forward_tp``)."""
    (d,) = ins
    if not op.vectorized:
        raise GraphError(f"{node}: a tensor-parallel Map must be "
                         f"vectorized")
    got = op.fn(state["params"], d.values)
    vals = (yield from got) if inspect.isgenerator(got) else got
    vals = _as(vals, torch_dtype(node.spec.value_dtype), d.values.device)
    return DeviceDelta(d.keys, vals, d.weights), state


_SHARDED = {"join": _lower_join_sharded, "knn": _lower_knn_sharded}


def lower_node_sharded(ctx, node: Node, state,
                       ins: Sequence[Optional[DeviceDelta]], axis, n: int,
                       sizes=None, reader=None):
    """One node's lowering on one shard (a generator body). ``reader``
    reads the uniform host branches back (the executor's
    ``read_branch``)."""
    kind = node.op.kind
    if kind == "reduce":
        fn = (_lower_reduce_sharded if node.op.how in LINEAR_DEVICE_REDUCERS
              else _lower_reduce_minmax_sharded)
        return (yield from fn(ctx, node.op, node, state, ins, axis, n,
                              sizes, reader))
    if kind == "map" and node.op.param_specs is not None:
        return (yield from _lower_map_tp(ctx, node.op, node, state, ins,
                                         axis, n, sizes, reader))
    if kind in _SHARDED:
        return (yield from _SHARDED[kind](ctx, node.op, node, state, ins,
                                          axis, n, sizes, reader))
    # stateless row ops are shard-local
    return LOWERINGS[kind](node.op, node, state, ins)
