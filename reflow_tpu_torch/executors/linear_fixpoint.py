"""Fused delta-vector fixpoint: frontier-proportional loop passes.

The counterpart of ``reflow_tpu/executors/linear_fixpoint.py``. The row
fixpoint (``fixpoint.py``) does O(arena) work per loop pass: the Join
sweeps its whole append arena and the Reduce scatter-adds the full
product, however few keys changed. For a *declared-linear* loop region

    loop L -> Join(left=L, linear_left) -> [GroupBy] -> [linear Maps]
           -> [Union with region-external streams] -> Reduce('sum', tol)
           -> close_loop(L, ...)

the per-pass delta stream is fully determined by its *linear
observables* per key — ``dval[k] = Σ w·v`` and ``dw[k] = Σ w`` of the
loop delta — so the loop carry is one dense ``[K, P+1]`` array ``xw`` and
a pass is:

    1. frontier = keys with a nonzero observable and out-degree > 0,
    2. gather exactly the frontier's arena rows through a CSR index over
       the arena and push ``merge/key_fn/value_fn/maps`` through them,
    3. one scatter-add of the (value, weight) contributions into a
       ``[KR, P+1]`` table,
    4. fold the table into the Reduce's dense tables; the tol-gated
       emission diff is the next pass's ``xw``.

**Persistent CSR.** The arena is an append-only log between compactions,
so its sorted base (rows ``[0, count)``: ``svalw`` with the per-key
``geo`` = (start, degree) table) is a cache kept on the EXECUTOR across
ticks, one per Join. Each tick sorts only the append tail
``[count, rcount)`` into a window CSR of ``Ft`` rows, and a pass pushes
the frontier through both segments. A full rebuild happens when the
arena's ``gen`` changed (a compaction reordered it), when ``rcount``
shrank below ``count``, or when the tail outgrew ``Ft``. The cache is
derived state: never checkpointed, never carried by ``convert.py``, and
dropped by ``bind``, ``state_restore`` and ``on_states_replaced``.

**The port's loop: host-checked, one packed readback a pass.** The JAX
package runs the passes in ``lax.while_loop``, picks the gather tier
with ``lax.switch`` and decides rebuild and tail with ``lax.cond``.
Here, each pass begins with one readback of ``[live, base frontier
edges, tail frontier edges, rows so far]``. The host then ends the loop
(nothing live, or the pass cap reached), picks the base tier (the
smallest static budget that holds the frontier's edges, else the dense
tier) and the tail tier (or skips the tail), by the same rules as the
JAX program (:func:`pick_base_tier`, :func:`pick_tail_tier`). The
rebuild and tail decisions are host branches on one more readback a
tick, of the arena's ``(gen, rcount)``; the cache's own count and
generation are host ints. So a tick with ``n`` loop passes reads back
``n + 2`` times in here, besides the Join's compact-or-append readback
in phase A and the scheduler's error check. The sticky ``stable_key``
error flag and the pass rows stay on the device until those reads.
The tiers' shapes are static, so a later CUDA-graph capture of each
tier's pass body has fixed shapes to capture.

Fewer launches a pass, same rows: a pass is launched op by op from the
host, so where the JAX program pushes and scatters each segment on its
own and sums the tables, a pass here pushes the rows of all its
segments in ONE push and one scatter (:meth:`_push_tab`); and when base
and tail both take budget tiers, one gather at the sum of the two
budgets takes both segments' rows (:meth:`_joined`). The tiers are
still the JAX program's. The joined gather offsets tail rows past the
arena, so the arena plus its tail window must be exact in float32 (JAX
bounds the arena alone); a larger arena takes the row program.

No ``mode="drop"``: every scatter that JAX drops or parks at key 0 (dead
gather slots, out-of-budget slots, invalid destinations, dead arena
rows) goes to ``SPREAD_ROWS`` spare rows past the table instead, sliced
off after, so no single address takes the atomics of hundreds of
thousands of weight-0 rows. The destination-sorted dense tier puts its
invalid rows at the END of the sort (JAX puts them at key 0); their
contributions are zero either way. Sorts pass ``stable=True``, as
``jnp.argsort`` is stable.

State transitions are exactly the row program's: the Reduce's
wsum/wcnt/emitted tables evolve identically, and the Join's left table
is patched densely at loop exit (``lval = emitted where live``,
``lw += has_final - has_entry``). Under ``close_loop(defer_passes=d)``
the loop stops after ``d`` passes a tick and carries the live ``xw`` in
the loop node's ``resid`` state (semantic state: checkpointed and
carried by ``convert.py``); the left-table patch then tracks the folded
collection ``emitted - resid``.

K ticks in one call (``call_many``, the window path) run the same tick
K times over the slots of the window's ingress stack; the CSR cache
threads through them as it threads through K single calls (JAX carries
it through its ``lax.scan``).

Left out: the shard context (the loop inside one ``shard_map`` region
with ``psum_scatter``/``pmax``) waits for the multi-device port; it
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from reflow_tpu_torch.delta import Spec, torch_dtype
from reflow_tpu_torch.executors.device_delta import MIN_CAPACITY, DeviceDelta
from reflow_tpu_torch.executors.fixpoint import (FixpointStructure,
                                                 _MacroTickMixin,
                                                 collect_sink_egress,
                                                 run_exit_pass,
                                                 snapshot_boundary)
from reflow_tpu_torch.executors.lowerings import (SPREAD_ROWS, _agg_tables,
                                                  _apply_rowfn, _as, _bcast_w,
                                                  _differs, _masked_contrib,
                                                  _table_index, span)
from reflow_tpu_torch.graph import FlowGraph, Node

__all__ = ["LinearFixpointProgram", "LinearStructure", "analyze_linear",
           "pick_base_tier", "pick_tail_tier", "resid_state"]

#: offsets/degrees/keys ride in f32 columns of fused gathers; they must be
#: exactly representable
_F32_EXACT = 1 << 24


def _f32_roundtrip_safe(dtype) -> bool:
    """Whether every value of ``dtype`` survives a cast through float32
    (the budget tiers stack arena/loop values into f32 gather columns)."""
    dt = torch_dtype(dtype)
    if dt.is_complex:
        return False
    if dt.is_floating_point:
        return dt.itemsize <= 4   # f32 exact; bf16/f16/f8 widen losslessly
    return dt.itemsize <= 2       # int8/int16/uint8/bool fit f32's mantissa


@dataclasses.dataclass(frozen=True)
class LinearStructure:
    """A loop region matching the fused delta-vector pattern."""

    loop: Node                    # the loop variable (unique-keyed)
    join: Node                    # Join(left=loop, right external, linear)
    groupby: Optional[Node]       # optional re-key after the join
    maps: Tuple[Node, ...]        # linear Maps after the (re-keyed) join
    union: Optional[Node]         # optional Union with external streams
    reduce: Node                  # Reduce('sum'), closes the loop


def analyze_linear(graph: FlowGraph,
                   structure: FixpointStructure) -> Optional[LinearStructure]:
    """Match the region against the linear-chain pattern; None = no match."""
    if len(structure.loops) != 1:
        return None
    (loop,) = structure.loops
    region = {n.id: n for n in structure.loop_plan}

    # the loop's only region consumer must be a declared-linear Join with
    # the loop variable on the (unique-keyed) left and an external right
    consumers = [c for c, _ in graph.consumers(loop)]
    if len(consumers) != 1:
        return None
    join = consumers[0]
    if (join.kind != "op" or join.op.kind != "join"
            or not join.op.linear_left or join.op.merge is None
            or join.id not in region):
        return None
    if join.inputs[0] is not loop or not join.inputs[0].spec.unique:
        return None
    if join.inputs[1].id in region:
        return None  # arena must be static during the loop

    # walk the single-consumer chain join -> [groupby] -> maps* -> [union]
    # -> reduce
    groupby: Optional[Node] = None
    maps: List[Node] = []
    union: Optional[Node] = None
    node = join
    red: Optional[Node] = None
    while red is None:
        cons = [c for c, _ in graph.consumers(node) if c.id in region]
        if len(cons) != 1:
            return None
        prev, node = node, cons[0]
        if node.kind != "op":
            return None
        k = node.op.kind
        if k == "groupby":
            if groupby is not None or maps or union is not None:
                return None  # at most one, directly after the join
            groupby = node
        elif k == "map":
            if not node.op.linear or union is not None:
                return None
            maps.append(node)
        elif k == "union":
            if union is not None:
                return None
            # every other Union input must be region-external (quiet
            # during the loop)
            for inp in node.inputs:
                if inp is not prev and inp.id in region:
                    return None
            union = node
        elif k == "reduce":
            red = node
        else:
            return None

    if red.op.how != "sum" or loop.back_input is not red:
        return None
    # the Reduce must be the region's only boundary node (telescoping)
    if any(b is not red for b in structure.boundary):
        return None
    # every region node must be on the recognized chain
    chain_ids = {loop.id, join.id, red.id}
    chain_ids.update(m.id for m in maps)
    if groupby is not None:
        chain_ids.add(groupby.id)
    if union is not None:
        chain_ids.add(union.id)
    if set(region) != chain_ids:
        return None
    # the loop variable and the Reduce emission are the same collection
    if (loop.spec.key_space != red.spec.key_space
            or tuple(loop.spec.value_shape) != tuple(red.spec.value_shape)):
        return None
    return LinearStructure(loop=loop, join=join, groupby=groupby,
                           maps=tuple(maps), union=union, reduce=red)


def _edge_budget_tiers(arena_capacity: int) -> List[int]:
    """Static gather budgets, large to small; the dense full-arena branch
    sits above the largest. The ladder starts at arena/4 and steps by
    ratio 2 (at most 2x wasted gather slots), six tiers at most; smaller
    frontiers ride the smallest tier."""
    tiers = []
    c = 1 << (max(arena_capacity // 4, 1).bit_length() - 1)
    while c >= 2048 and len(tiers) < 6:
        tiers.append(c)
        c //= 2
    return tiers


def _tail_tiers(Ft: int) -> List[int]:
    """Budget ladder for the tail segment. The top tier is ``Ft`` itself
    (the tail's frontier edge count can never exceed its row count, so a
    dense fallback is unnecessary); smaller tiers halve down like the
    base ladder."""
    tiers = [Ft]
    c = Ft // 2
    while c >= 2048 and len(tiers) < 6:
        tiers.append(c)
        c //= 2
    return tiers


def pick_base_tier(tiers: Sequence[int], nedges: int) -> int:
    """Index of the smallest budget tier holding ``nedges`` frontier
    edges, or ``len(tiers)`` (the dense tier) when none does — the JAX
    program's ``lax.switch`` index."""
    n_fits = sum(t >= nedges for t in tiers)
    return n_fits - 1 if n_fits > 0 else len(tiers)


def pick_tail_tier(tail_tiers: Sequence[int], nt: int, base_dense: bool,
                   stable_dst: bool) -> Optional[int]:
    """Index of the tail tier for ``nt`` tail frontier edges, or None to
    skip the tail: nothing touched, or the raw dense tier (which sweeps
    the tail rows itself) ran. The destination-sorted dense tier covers
    only the base, so it runs with the tail."""
    if nt == 0 or (base_dense and not stable_dst):
        return None
    return max(sum(t >= nt for t in tail_tiers) - 1, 0)


def resid_state(loop_spec: Spec, device) -> dict:
    """The ``resid`` state of a loop under ``defer_passes``: the carried
    observables ``[K, P+1]`` (flattened dval columns + dw), float32."""
    P = 1
    for s in loop_spec.value_shape:
        P *= s
    return {"resid": torch.zeros((loop_spec.key_space, P + 1),
                                 dtype=torch.float32, device=device)}


class LinearFixpointProgram(_MacroTickMixin):
    """One tick for a linear loop region: row-based phase A, the fused
    delta-vector loop, the row-based exit pass.

    Drop-in alternative to :class:`~.fixpoint.FixpointProgram` (same call
    contract), built by the executor when :func:`analyze_linear`
    matches. Raises ValueError when shapes don't fit the fused path's
    float32 columns (the executor then builds the row program).
    """

    def __init__(self, executor, *, structure: FixpointStructure,
                 linear: LinearStructure):
        if getattr(executor, "mesh", None) is not None:
            raise NotImplementedError(
                "the sharded fused loop (shard_map region, psum_scatter) "
                "is not ported yet")
        graph = executor.graph
        self.structure = structure
        self.linear = linear
        self.sink_ids = [s.id for s in graph.sinks]
        self._executor = executor

        L, J, R = linear.loop, linear.join, linear.reduce
        Ft = min(J.op.arena_capacity, max(2048, J.op.arena_capacity // 8))
        # (the arena plus its tail window: a joined base+tail gather
        # offsets tail rows past the base ones)
        if (L.spec.key_space >= _F32_EXACT
                or J.op.arena_capacity + Ft >= _F32_EXACT
                or R.inputs[0].spec.key_space >= _F32_EXACT):
            raise ValueError("key space / arena too large for fused-f32 "
                             "index columns")
        for what, dt in (("arena value", J.inputs[1].spec.value_dtype),
                         ("join output value", J.spec.value_dtype),
                         ("loop value", L.spec.value_dtype),
                         ("reduce value", R.spec.value_dtype)):
            if not _f32_roundtrip_safe(dt):
                raise ValueError(
                    f"{what} dtype {torch_dtype(dt)} does not round-trip "
                    f"exactly through the fused loop's float32 columns; "
                    f"using the row-based fixpoint")

        self._exit_pass = (executor.build_pass_fn(list(structure.exit_plan))
                           if structure.exit_plan else None)
        self._gb = linear.groupby
        self._KR = R.inputs[0].spec.key_space
        self._odtype = torch_dtype(J.spec.value_dtype)
        self._rdtype = torch_dtype(R.spec.value_dtype)
        self._vdtype = torch_dtype(J.inputs[1].spec.value_dtype)
        self._vshape = tuple(L.spec.value_shape)
        self._avshape = tuple(J.inputs[1].spec.value_shape)
        self._P = 1
        for s in self._vshape:
            self._P *= s
        self._Q = 1
        for s in self._avshape:
            self._Q *= s
        #: cross-tick residual deferral (close_loop defer_passes)
        self._defer = L.defer_passes
        self.tiers = _edge_budget_tiers(J.op.arena_capacity)
        #: tail window capacity: appends since the last full CSR rebuild
        #: accumulate here; overflow forces a rebuild
        self.Ft = Ft
        self.tail_tiers = _tail_tiers(Ft)
        #: destination-sorted dense tier: every arena row's output key is
        #: loop-value-independent (GroupBy(stable_key=True), or no re-key)
        self.stable_dst = self._gb is None or self._gb.op.stable_key
        self._loop_id, self._join_id, self._red_id = L.id, J.id, R.id
        self._loop_spec = L.spec
        #: constant index tensors by (kind, n), made once per device
        self._consts: Dict[tuple, torch.Tensor] = {}
        #: what the last loop tick did: base/tail tier per pass, the CSR
        #: rebuild cause (None = kept), the tail's rows
        self.last_tick: Dict[str, object] = {}

    # -- constants ---------------------------------------------------------

    def _const(self, kind: str, n: int, device) -> torch.Tensor:
        key = (kind, n, str(device))
        t = self._consts.get(key)
        if t is None:
            if kind == "ones":
                t = torch.ones(n, dtype=torch.int32, device=device)
            else:
                ar = torch.arange(n, device=device)
                t = {"spread": ar % SPREAD_ROWS,
                     "f32": ar.to(torch.float32),
                     "i32": ar.to(torch.int32)}[kind]
            self._consts[key] = t
        return t

    def _spare(self, rows: int, n: int, device) -> torch.Tensor:
        """Spare-row targets ``rows + (i % SPREAD_ROWS)`` for ``n`` rows."""
        return rows + self._const("spread", n, device)

    # -- the pass's compositions -------------------------------------------

    def _push(self, src_keys, x, dwx, vb, ew):
        """Per-edge contributions of the frontier push: ``src_keys [E']``
        join keys, ``x [E', *loop_vshape]`` per-key dval gathered per
        edge, ``dwx [E']`` per-key net weight, ``vb [E', *arena_vshape]``
        arena values, ``ew [E']`` arena row weights (0 = dead or
        out-of-budget). -> (okey, wsum contributions, wcnt
        contributions)."""
        dev = src_keys.device
        gb = self._gb
        merged = _as(self.linear.join.op.merge(src_keys, x, vb),
                     self._odtype, dev)
        if gb is not None:
            okey = _as(_apply_rowfn(gb.op.key_fn, gb.op.vectorized,
                                    src_keys, merged), torch.int32, dev)
        else:
            okey = src_keys
        okey = torch.where(ew == 0, 0, okey)
        val = merged
        if gb is not None and gb.op.value_fn is not None:
            val = _apply_rowfn(gb.op.value_fn, gb.op.vectorized, src_keys,
                               merged)
        for m in self.linear.maps:
            val = _apply_rowfn(m.op.fn, m.op.vectorized, val)
        wv = _masked_contrib(ew, _as(val, torch.float32, dev))
        return okey, wv, (dwx * ew).to(torch.float32)

    def _push_tab(self, parts, dtgt=None):
        """Push the rows one pass gathered from its segments (each part a
        ``(src, x, dwx, vb, ew)`` tuple), all through ONE push, and
        scatter-add their contributions into one ``[KR, P+1]`` table —
        the JAX program sums a table per segment; the sum is the same,
        in another order. Rows of weight 0, and keys outside ``[0, KR)``
        (which JAX's ``mode="drop"`` drops), go to spare rows below the
        table. ``dtgt`` gives the first part's destinations precomputed
        (the destination-sorted dense tier); its live rows' runtime keys
        are checked against them. -> (table, mismatch flag or None): a
        mismatch is a violated ``stable_key`` declaration, which goes
        into the Join's sticky error."""
        cols = ([p[i] for p in parts] for i in range(5))
        src, x, dwx, vb, ew = (c[0] if len(parts) == 1 else torch.cat(c)
                               for c in cols)
        okey, wv, wc = self._push(src, x, dwx, vb, ew)
        n, KR, dev = okey.shape[0], self._KR, okey.device
        n0 = 0 if dtgt is None else dtgt.shape[0]
        bad = None
        if dtgt is not None:
            bad = torch.any((okey[:n0].long() != dtgt) & (ew[:n0] != 0))
        tgt = dtgt
        if n > n0:
            idx, inb = _table_index(okey[n0:], KR)
            rest = torch.where((ew[n0:] != 0) & inb, idx,
                               self._spare(KR, n - n0, dev))
            tgt = rest if dtgt is None else torch.cat([dtgt, rest])
        upd = torch.cat([wv.reshape(n, -1), wc[:, None]], dim=-1)
        tab = torch.zeros((KR + SPREAD_ROWS, self._P + 1),
                          dtype=torch.float32, device=dev
                          ).index_add_(0, tgt, upd)[:KR]
        return tab, bad

    def _fold(self, rstate: dict, tab: torch.Tensor):
        """Fold one pass's summed contribution table into the Reduce's
        running tables, then the dense emission diff (exactly the dense
        Reduce lowering's, on the vectors). -> (rstate', next xw, rows
        emitted this pass as a device scalar)."""
        op = self.linear.reduce.op
        Ko, P = tab.shape[0], self._P
        wsum = rstate["wsum"] + tab[:, :-1].reshape((Ko,) + self._vshape)
        wcnt = rstate["wcnt"] + tab[:, -1].to(torch.int32)
        emitted, em_has = rstate["emitted"], rstate["emitted_has"]
        agg, exists = _agg_tables(op, wsum, wcnt, self._rdtype)
        changed = _differs(agg, emitted, op.tol)
        ins_m = exists & (~em_has | changed)
        ret_m = em_has & (~exists | changed)
        new_emitted = torch.where(_bcast_w(ins_m, agg), agg, emitted)
        new_has = torch.where(ins_m, True,
                              torch.where(ret_m & ~exists, False, em_has))
        # next-pass linear observables of the emission delta:
        # rows are (emitted_old, -1)[ret] + (agg, +1)[ins]
        dval = (torch.where(_bcast_w(ins_m, agg), agg.to(torch.float32), 0.0)
                - torch.where(_bcast_w(ret_m, emitted),
                              emitted.to(torch.float32), 0.0))
        dwv = ins_m.to(torch.float32) - ret_m.to(torch.float32)
        xw = torch.cat([dval.reshape(Ko, P), dwv[:, None]], dim=1)
        rows = (ins_m.to(torch.int64) + ret_m.to(torch.int64)).sum()
        new_rstate = dict(rstate)
        new_rstate.update(wsum=wsum, wcnt=wcnt, emitted=new_emitted,
                          emitted_has=new_has)
        return new_rstate, xw, rows

    def _budget_rows(self, EB: int, seg: dict, xw, fmask):
        """The rows a frontier-compacted gather at static budget EB takes
        from one CSR segment (base, tail, or both joined), as ``(src, x,
        dwx, vb, ew)`` for :meth:`_push_tab`. ``fmask`` marks the keys
        with a nonzero observable (the pass's frontier). One gather builds
        the compacted frontier table, a scatter of segment starts plus a
        cumsum assigns gather slots to frontier entries, one gather
        expands the frontier table per slot, one fetches the segment's
        sorted rows. The caller picked EB >= the frontier's edge count,
        so every frontier entry fits."""
        dev = xw.device
        K = xw.shape[0]
        copies = seg["copies"]
        if copies > 1:
            # a joined segment lists each key once per part
            xw, fmask = xw.repeat(copies, 1), fmask.repeat(copies)
        Klc = seg["has_deg"].shape[0]
        P, Q = self._P, self._Q
        mask = fmask & seg["has_deg"]
        # compact frontier keys; count <= frontier edge count <= EB
        # because every compacted key has deg >= 1
        pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
        tgt = torch.where(mask & (pos < EB), pos.long(),
                          self._spare(EB, Klc, dev))
        ids = torch.full((EB + SPREAD_ROWS,), Klc, dtype=torch.int32,
                         device=dev)
        ids[tgt] = self._const("i32", Klc, dev)
        ids = ids[:EB]
        ids_c = torch.clamp(ids, max=Klc - 1).long()
        # one fused gather: offsets, deg, key, observables per frontier
        ftab = torch.cat([seg["gkey"], xw], dim=1)
        fr = ftab[ids_c]                        # [EB, 3 + P + 1]
        fdeg = torch.where(ids < Klc, fr[:, 1], 0.0)
        cum = torch.cumsum(fdeg, 0)
        total = cum[-1:]                        # stays on the device
        start = cum - fdeg
        # slot j belongs to the frontier entry whose segment starts at or
        # before j: mark segment starts (distinct), running-sum them
        spos = torch.where(fdeg > 0, start.long(), self._spare(EB, EB, dev))
        marks = torch.zeros((EB + SPREAD_ROWS,), dtype=torch.int32,
                            device=dev)
        marks[spos] = 1
        owner = torch.clamp(torch.cumsum(marks[:EB], 0, dtype=torch.int32)
                            - 1, 0, EB - 1).long()
        # expand the frontier table per slot (one gather), with the
        # segment start appended so each slot finds its sorted row
        frs = torch.cat([fr, start[:, None]], dim=1)[owner]
        j = self._const("f32", EB, dev)
        valid = (j < total) & (frs[:, 1] > 0)
        eidx = (frs[:, 0] + (j - frs[:, -1])).long()
        eidx = torch.where(valid, eidx, 0)
        src = torch.clamp(frs[:, 2].to(torch.int32), 0, K - 1)
        x = frs[:, 3:3 + P].reshape((EB,) + self._vshape)
        sv = seg["svalw"][eidx]                 # [EB, Q + 1]
        vb = sv[:, :Q].to(self._vdtype).reshape((EB,) + self._avshape)
        ew = torch.where(valid, sv[:, Q].to(torch.int32), 0)
        return src, x, frs[:, 3 + P], vb, ew

    def _dense_rows(self, jstate, xw):
        """The RAW arena rows (base and tail alike) with their keys'
        observables: the always-correct top tier when destinations are
        not stable."""
        Klc = xw.shape[0]
        rk = torch.clamp(jstate["rkeys"], max=Klc - 1)
        gidx, _ = _table_index(rk, Klc)
        g = xw[gidx]                            # [R, P+1] one gather
        x = g[:, :self._P].reshape((rk.shape[0],) + self._vshape)
        return rk, x, g[:, self._P], jstate["rvals"], jstate["rw"]

    def _dense_sorted_rows(self, csr, xw):
        """The base rows [0, count) in the destination-SORTED copy (the
        tail runs alongside), so the scatter walks destinations in order;
        push them with ``dtgt=csr["dtgt"]``."""
        dsrc, dvalw = csr["dsrc"], csr["dvalw"]
        Rl, Q, P = dsrc.shape[0], self._Q, self._P
        src_c = torch.clamp(dsrc, 0, xw.shape[0] - 1)
        g = xw[src_c.long()]                    # [R, P+1] one gather
        x = g[:, :P].reshape((Rl,) + self._vshape)
        vb = dvalw[:, :Q].to(self._vdtype).reshape((Rl,) + self._avshape)
        return src_c, x, g[:, P], vb, dvalw[:, Q].to(torch.int32)

    # -- the CSR -----------------------------------------------------------

    def _degrees(self, keys, Klc: int):
        """Per-key row counts over ``[0, Klc)`` (the sentinel ``Klc`` and
        out-of-range keys counted on spare rows, sliced off)."""
        dev = keys.device
        idx, inb = _table_index(keys, Klc + 1)
        n = keys.shape[0]
        tgt = torch.where(inb & (idx < Klc), idx,
                          self._spare(Klc + 1, n, dev))
        return torch.zeros((Klc + 1 + SPREAD_ROWS,), dtype=torch.int32,
                           device=dev).index_add_(
            0, tgt, self._const("ones", n, dev))[:Klc]

    def _segment(self, deg_i, svalw) -> dict:
        """One CSR segment: the sorted rows ``svalw`` and, per key, its
        degree, (start, degree) in float32, and the gather table
        (start, degree, key) the budget tiers read per frontier key."""
        starts = torch.cumsum(deg_i, 0, dtype=torch.int32) - deg_i
        geo = torch.stack([starts, deg_i], dim=1).to(torch.float32)
        keys = self._const("f32", deg_i.shape[0], deg_i.device)
        return {"geo": geo, "deg": deg_i, "has_deg": deg_i > 0,
                "gkey": torch.cat([geo, keys[:, None]], dim=1),
                "svalw": svalw, "copies": 1}

    def _joined(self, base: dict, tail: dict) -> dict:
        """Base and tail as ONE segment for the budget gather: each key
        listed twice (its base run, then its tail run, whose starts are
        shifted past the base rows). A pass whose base and tail both
        take budget tiers then gathers once, at the sum of the two
        budgets — the same rows as two gathers, in half the launches."""
        R = base["svalw"].shape[0]
        shift = torch.zeros(3, dtype=torch.float32, device=base["geo"].device)
        shift[0] = R
        return {"has_deg": torch.cat([base["has_deg"], tail["has_deg"]]),
                "gkey": torch.cat([base["gkey"], tail["gkey"] + shift]),
                "svalw": torch.cat([base["svalw"], tail["svalw"]]),
                "copies": 2}

    def _build_base(self, jstate, Klc: int, rc: int, gen: int) -> dict:
        """Full rebuild: sort the whole arena by key (dead rows to the
        sentinel ``Klc``), per-key (start, degree) by a histogram and a
        cumsum; and, for stable destinations, the destination-sorted copy
        with each row's precomputed output key."""
        rk, rv, rw = jstate["rkeys"], jstate["rvals"], jstate["rw"]
        Rcap, Q, dev = rk.shape[0], self._Q, rk.device
        skey = torch.where(rw != 0, rk, Klc)
        order = torch.sort(skey, stable=True).indices
        svalw = torch.cat([rv[order].reshape(Rcap, Q).to(torch.float32),
                           rw[order].to(torch.float32)[:, None]], dim=1)
        csr = self._segment(self._degrees(skey, Klc), svalw)
        csr.update(count=rc, gen=gen)
        if self.stable_dst:
            # per-row output keys with the loop value zeroed (the
            # stable_key contract makes them loop-independent); live rows
            # outside [0, KR) mirror the scatter's drop
            KR = self._KR
            gk = torch.clamp(rk, 0, Klc - 1)
            x0 = torch.zeros((Rcap,) + self._vshape, dtype=torch.float32,
                             device=dev)
            merged0 = _as(self.linear.join.op.merge(gk, x0, rv),
                          self._odtype, dev)
            gb = self._gb
            if gb is not None:
                ok0 = _as(_apply_rowfn(gb.op.key_fn, gb.op.vectorized, gk,
                                       merged0), torch.int32, dev)
            else:
                ok0 = gk
            ok_valid = (rw != 0) & (ok0 >= 0) & (ok0 < KR)
            dorder = torch.sort(torch.where(ok_valid, ok0, KR),
                                stable=True).indices
            valid_s = ok_valid[dorder]
            csr.update(
                dsrc=rk[dorder],
                dvalw=torch.cat(
                    [rv[dorder].reshape(Rcap, Q).to(torch.float32),
                     torch.where(valid_s, rw[dorder], 0
                                 ).to(torch.float32)[:, None]], dim=1),
                dtgt=torch.where(valid_s, ok0[dorder].long(),
                                 self._spare(KR, Rcap, dev)))
        return csr

    def _build_tail(self, jstate, Klc: int, bcount: int, rc: int) -> dict:
        """Tail CSR over the fresh rows ``[bcount, rc)`` in a window of
        ``Ft`` rows (appends are live-compacted, so the window holds only
        live rows below ``rc``)."""
        rk, rv, rw = jstate["rkeys"], jstate["rvals"], jstate["rw"]
        Rcap, Ft, Q, dev = rk.shape[0], self.Ft, self._Q, rk.device
        fidx = bcount + torch.arange(Ft, device=dev)
        fi_c = torch.clamp(fidx, max=Rcap - 1)
        tk = torch.where((fidx < rc) & (rw[fi_c] != 0), rk[fi_c], Klc)
        torder = torch.sort(tk, stable=True).indices
        fi_s = fi_c[torder]
        svalw = torch.cat(
            [rv[fi_s].reshape(Ft, Q).to(torch.float32),
             torch.where(tk[torder] < Klc, rw[fi_s].to(torch.float32),
                         0.0)[:, None]], dim=1)
        return self._segment(self._degrees(tk, Klc), svalw)

    def _take_csr(self) -> dict:
        """The ONE sorted-arena cache this join keeps across ticks, held on
        the executor; an empty cache (no tensors, ``gen`` -1) forces the
        first loop tick to build it."""
        csr = self._executor._csr_cache.pop(self._join_id, None)
        return csr if csr is not None else {"count": 0, "gen": -1}

    # -- the loop ------------------------------------------------------------

    def _observables(self, ld: DeviceDelta, Klc: int, resid):
        """Loop delta rows -> the dense ``[Klc, P+1]`` observables (plus the
        carried residue under ``defer_passes``: it joins at the first
        pass, pushed against the post-churn arena — the schedule a host
        loop resuming its stashed back-edge rows would run)."""
        C, dev = ld.capacity, ld.keys.device
        idx, inb = _table_index(ld.keys, Klc)
        tgt = torch.where(inb & (ld.weights != 0), idx,
                          self._spare(Klc, C, dev))
        contrib = _masked_contrib(ld.weights, ld.values.to(torch.float32))
        upd = torch.cat([contrib.reshape(C, self._P),
                         ld.weights.to(torch.float32)[:, None]], dim=1)
        xw = torch.zeros((Klc + SPREAD_ROWS, self._P + 1),
                         dtype=torch.float32, device=dev
                         ).index_add_(0, tgt, upd)[:Klc]
        return xw if resid is None else xw + resid

    def _loop_region(self, jstate, rstate, ld, has_entry, resid,
                     max_iters: int):
        ex = self._executor
        Klc = rstate["emitted_has"].shape[0]
        dev = ld.keys.device
        with span("linear.observables"):
            xw = self._observables(ld, Klc, resid)

        # CSR cache validity: the base ordering survives only while the
        # arena is append-only past ``count`` under the same generation,
        # and the un-sorted tail must fit its window
        gen, rc = ex.read_branch(torch.stack(
            [jstate["gen"].reshape(()), jstate["rcount"].reshape(())]))
        csr = self._take_csr()
        cause = None
        if "geo" not in csr:
            cause = "initial"
        elif csr["gen"] != gen:
            cause = "gen"
        elif csr["count"] > rc:
            cause = "shrunk"
        elif rc - csr["count"] > self.Ft:
            cause = "tail"
        if cause is not None:
            with span("linear.csr.rebuild"):
                csr = self._build_base(jstate, Klc, rc, gen)
            ex.csr_rebuilds[cause] += 1
        bcount = csr["count"]
        tail = joined = None
        if rc > bcount:
            with span("linear.csr.tail"):
                tail = self._build_tail(jstate, Klc, bcount, rc)
                joined = self._joined(csr, tail)
        self.last_tick = {"csr": cause, "tail_rows": rc - bcount,
                          "tiers": []}

        tiers, dense_ix = self.tiers, len(self.tiers)
        # per key: base and tail degree, for the frontier's edge counts
        degs = torch.stack([csr["deg"], tail["deg"] if tail is not None
                            else torch.zeros_like(csr["deg"])], dim=1)
        rows_dev = torch.zeros((1,), dtype=torch.int64, device=dev)
        err = torch.zeros((), dtype=torch.bool, device=dev)
        iters = 0
        while True:
            with span("linear.read"):
                fmask = torch.any(xw != 0, dim=1)
                edges = torch.where(fmask[:, None], degs, 0).sum(0)
                nb, nt, rows, live = ex.read_scalars(torch.cat(
                    [edges, rows_dev,
                     fmask.any().reshape(1).to(torch.int64)]))
            if not live or iters >= max_iters:
                break
            ix_b = pick_base_tier(tiers, nb)
            ix_t = pick_tail_tier(self.tail_tiers, nt, ix_b == dense_ix,
                                  self.stable_dst)
            dtgt = None
            if ix_b < dense_ix:
                with span("linear.budget"):
                    if ix_t is None:
                        parts = [self._budget_rows(tiers[ix_b], csr, xw,
                                                   fmask)]
                    else:
                        # base and tail in one gather at both budgets
                        parts = [self._budget_rows(
                            tiers[ix_b] + self.tail_tiers[ix_t], joined, xw,
                            fmask)]
            else:
                if self.stable_dst:
                    with span("linear.dense_sorted"):
                        parts = [self._dense_sorted_rows(csr, xw)]
                        dtgt = csr["dtgt"]
                else:
                    with span("linear.dense"):
                        parts = [self._dense_rows(jstate, xw)]
                if ix_t is not None:
                    with span("linear.tail"):
                        parts.append(self._budget_rows(
                            self.tail_tiers[ix_t], tail, xw, fmask))
            with span("linear.push"):
                tab, bad = self._push_tab(parts, dtgt)
                if bad is not None:
                    err = err | bad
            with span("linear.fold"):
                rstate, xw, prows = self._fold(rstate, tab)
                rows_dev = rows_dev + prows
            self.last_tick["tiers"].append((ix_b, ix_t))
            iters += 1
        converged = not live

        with span("linear.patch"):
            # patch the Join's left table densely (per-pass retract/insert
            # pairs cancel; only entry-vs-exit existence and value matter)
            has_f, em_f = rstate["emitted_has"], rstate["emitted"]
            lval, lw = jstate["lval"], jstate["lw"]
            new_jstate = dict(jstate)
            # a violated stable_key declaration surfaces as the join's
            # sticky error at the tick's error check
            new_jstate["error"] = jstate["error"] | err
            if resid is None:
                new_jstate["lval"] = torch.where(_bcast_w(has_f, em_f),
                                                 em_f.to(lval.dtype), lval)
                new_jstate["lw"] = (lw + has_f.to(torch.int32)
                                    - has_entry.to(torch.int32))
            else:
                # defer mode: the final xw is still in flight, so the
                # FOLDED collection lags the emitted table by exactly its
                # observables: A = emitted - xw; the weight delta nets the
                # entry and exit residues
                rout = xw[:, :self._P].reshape((Klc,) + self._vshape)
                lval_t = em_f.to(torch.float32) - rout
                new_jstate["lval"] = torch.where(_bcast_w(has_f, em_f),
                                                 lval_t.to(lval.dtype), lval)
                ddw = torch.round(xw[:, self._P] - resid[:, self._P]
                                  ).to(torch.int32)
                new_jstate["lw"] = (lw + has_f.to(torch.int32)
                                    - has_entry.to(torch.int32) - ddw)
        ex._csr_cache[self._join_id] = csr
        return new_jstate, rstate, iters, rows, converged, xw

    def __call__(self, op_states, plan: Sequence[Node],
                 dev_ingress: Dict[int, DeviceDelta], max_iters: int):
        """-> (states', {sink_id: (DeviceDelta, ...)}, carry, iters,
        loop_rows, converged) — the FixpointProgram call contract. carry
        is None: the in-flight loop state is dense observables, carried
        in the loop node's ``resid`` state under defer_passes; a
        ``max_iters`` halt without defer_passes does not resume."""
        ex, st = self._executor, self.structure
        self.last_tick = {}
        # the loop folds every emission from phase A's onward into the
        # join's left table, so the exit patch diffs existence against the
        # PRE-tick table (copied: the sparse Reduce writes it in place)
        has_entry = op_states[self._red_id]["emitted_has"].clone()
        states, eg_a = ex.build_pass_fn(list(plan))(op_states, dev_ingress)
        snaps = (snapshot_boundary(states, st.boundary)
                 if self._exit_pass is not None else {})
        defer = self._defer
        mi = min(max_iters, defer) if defer else max_iters

        ld = eg_a.get(self._loop_id)
        if defer and ld is None:
            # carried residue may still be live when phase A emitted no
            # loop delta: run the loop with an empty delta
            ld = DeviceDelta.empty(self._loop_spec, MIN_CAPACITY,
                                   device=ex.device)
        if ld is not None:
            resid = states[self._loop_id]["resid"] if defer else None
            jst, rst, iters, rows, converged, xw = self._loop_region(
                states[self._join_id], states[self._red_id], ld, has_entry,
                resid, mi)
            states = dict(states)
            states[self._join_id] = jst
            states[self._red_id] = rst
            if defer:
                states[self._loop_id] = {"resid": xw}
        else:
            # phase A emitted no loop delta: the region is quiescent and
            # the left-table patch would be an identity; the CSR cache
            # stays, and phase-A appends land in the next loop tick's tail
            iters, rows, converged = 0, 0, True

        states, eg_b = run_exit_pass(self._exit_pass, states, snaps,
                                     st.boundary)
        sink_egress = collect_sink_egress(self.sink_ids, eg_a, eg_b)
        return states, sink_egress, None, iters, rows, converged
