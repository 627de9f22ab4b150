"""Join-arena compaction (GC): bound the arena by LIVE rows, not lifetime.

The counterpart of ``reflow_tpu/executors/arena.py``. The device Join
stores its right side as an append-only log: retractions append
negative-weight rows rather than freeing their match, so without
reclamation ``arena_capacity`` would have to cover the lifetime append
count.

:func:`compact_arena` cancels matched pairs on the device: rows are
lex-sorted by (key, value bits) through a chain of stable sorts, equal
(key, value) runs are weight-summed, and groups with net weight 0
vanish; survivors are repacked to the front with their net weight.
Exactness contract: a retraction carries the SAME value bits as the
insert it cancels (true by construction for host-driven deltas — the
retract batch replays the original row with weight -1; floats are
compared bitwise at their native width).

When it runs: PyTorch cannot branch on a device value without reading
it back, so the Join lowering reads ``rcount + appends > capacity`` back
once per right-side append and compacts first when it holds (the JAX
package decides the same thing on the device with ``lax.cond``). A
genuine overflow (live rows + appends > capacity even after compaction)
sets the join state's sticky ``error`` flag, raised at the next
``check_errors``.

:func:`propagate_plan_caps` is the host-side static counterpart: the
pre-dispatch capacity walk that rejects statically impossible ingress
sizes.
"""

from __future__ import annotations

from typing import Dict

import torch

from reflow_tpu_torch.graph import GraphError

__all__ = ["compact_arena", "propagate_plan_caps"]

_INT32_MAX = torch.iinfo(torch.int32).max


def propagate_plan_caps(plan, ingress_caps: Dict[int, int],
                        divisor: int = 1) -> Dict[int, int]:
    """Static per-tick capacity propagation against the Join arenas.

    Walks ``plan`` in topo order carrying worst-case per-node egress row
    counts from the seeded ``ingress_caps`` (sources, loops), and raises
    :class:`GraphError` for the statically impossible case: one tick's
    right-delta capacity exceeding the whole (per-shard, via
    ``divisor``) arena. Nothing here reads a device value back.
    """
    outs_cap: Dict[int, int] = dict(ingress_caps)
    for node in plan:
        if node.kind in ("source", "loop") or node.id in ingress_caps:
            continue
        if node.kind == "sink":
            continue
        caps = [outs_cap.get(i.id, 0) for i in node.inputs]
        if all(c == 0 for c in caps):
            continue
        if node.op.kind == "join":
            cap = node.op.arena_capacity // divisor
            if caps[1] > cap:
                raise GraphError(
                    f"{node}: a single tick's right-delta capacity "
                    f"({caps[1]} rows) exceeds the per-shard arena "
                    f"capacity {cap}; raise arena_capacity")
            if not node.inputs[0].spec.unique:
                La = ((node.op.left_arena_capacity
                       or node.op.arena_capacity) // divisor)
                if caps[0] > La:
                    raise GraphError(
                        f"{node}: a single tick's left-delta capacity "
                        f"({caps[0]} rows) exceeds the per-shard left "
                        f"arena capacity {La}; raise "
                        f"left_arena_capacity")
                outs_cap[node.id] = (node.op.product_slack
                                     * (caps[0] + caps[1]) * divisor)
                continue
            # an absent left delta skips the arena sweep entirely
            outs_cap[node.id] = (
                (2 * node.op.arena_capacity if caps[0] else 0) +
                divisor * caps[1])
        elif node.op.kind == "reduce":
            K = node.inputs[0].spec.key_space
            outs_cap[node.id] = 2 * K if caps[0] >= K else 2 * caps[0]
        elif node.op.kind == "knn":
            outs_cap[node.id] = 2 * node.inputs[0].spec.key_space
        elif node.op.kind == "union":
            outs_cap[node.id] = sum(caps)
        else:
            outs_cap[node.id] = caps[0]
    return outs_cap


def _value_bits(rv: torch.Tensor) -> torch.Tensor:
    """``[R, *V]`` values -> ``[R, B]`` int32 columns holding their bits at
    native width: 64-bit dtypes as two int32 columns each (little-endian
    word order, as the JAX package's bitcast gives them), 32-bit as one,
    16-bit through int16; 1-byte floats widen losslessly to float32
    first (a numeric int cast would merge distinct values); other
    sub-4-byte types (int8, uint8, bool) widen numerically."""
    R = rv.shape[0]
    vcols = rv.reshape(R, -1).contiguous()
    itemsize = vcols.element_size()
    if itemsize >= 4:
        return vcols.view(torch.int32).reshape(R, -1)
    if itemsize == 2:
        return vcols.view(torch.int16).to(torch.int32)
    if vcols.dtype.is_floating_point:
        return vcols.to(torch.float32).view(torch.int32)
    return vcols.to(torch.int32)


def _lex_order(primary: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The permutation sorting rows by ``primary``, then by ``cols[:, 0]``,
    then ``cols[:, 1]``, ... (``jnp.lexsort`` with ``primary`` last): a
    chain of stable sorts from the least significant column up."""
    order = torch.arange(primary.shape[0], device=primary.device)
    for q in range(cols.shape[1] - 1, -1, -1):
        order = order[torch.sort(cols[order, q], stable=True).indices]
    return order[torch.sort(primary[order], stable=True).indices]


def compact_arena(state: dict) -> dict:
    """(join state) -> (join state with its arena compacted).

    Only the arena fields (``rkeys``/``rvals``/``rw``/``rcount``) change,
    and ``gen`` is bumped (compaction reorders rows); the left table
    passes through. New tensors are returned; the inputs are not
    written. No value is read back to the host.
    """
    rk, rv, rw = state["rkeys"], state["rvals"], state["rw"]
    R = rk.shape[0]
    bits = _value_bits(rv)
    live = rw != 0
    skey = torch.where(live, rk, _INT32_MAX)

    order = _lex_order(skey, bits)
    sk = skey[order]
    sb = bits[order]
    sv = rv[order]
    sw = rw[order]

    same = (sk[1:] == sk[:-1]) & torch.all(sb[1:] == sb[:-1], dim=-1)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=rk.device),
                       ~same])
    gid = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    netw = torch.zeros_like(rw).index_add_(0, gid, sw)
    net_here = netw[gid]
    keep = first & (net_here != 0) & (sk != _INT32_MAX)

    # repack the survivors to the front: a scatter into one extra row
    # (the target of every dropped row), sliced off after
    pos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(keep, pos, R).long()

    def repack(src, like):
        out = torch.zeros((R + 1,) + tuple(like.shape[1:]), dtype=like.dtype,
                          device=like.device)
        out[tgt] = src
        return out[:R]

    out = dict(state)
    out.update(rkeys=repack(sk, rk), rvals=repack(sv, rv),
               rw=repack(net_here, rw),
               rcount=keep.sum(dtype=torch.int32).reshape(
                   state["rcount"].shape))
    if "gen" in state:
        out["gen"] = state["gen"] + 1
    return out
