"""Core operator definitions + exact host-side incremental semantics.

Every op implements:

- ``arity``: number of input ports.
- ``initial_state()``: host-side state (the device executor builds its
  own device state; see ``executors/cuda.py``).
- ``apply(state, in_batches) -> out_batch``: consume one tick's deltas on
  each port, mutate/replace state, emit output deltas. Must satisfy the
  incremental-vs-full oracle property (SURVEY.md §4b): folding the emitted
  deltas equals recomputing the op on the fully accumulated input.

Ops are data: the graph stores them; executors interpret or lower them.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter, defaultdict
from typing import Any, Callable, Optional, Sequence

import numpy as np

from reflow_tpu_torch.delta import (DeltaBatch, Spec, _hashable,
                              counter_to_batch)

__all__ = ["Op", "Map", "Filter", "GroupBy", "Reduce", "Join", "Union", "REDUCERS"]


class Op:
    """Base operator. Subclasses are declarative; executors do the work."""

    arity: int = 1
    kind: str = "op"

    def initial_state(self) -> Any:
        return None

    def out_spec(self, in_specs: Sequence[Spec]) -> Spec:
        return in_specs[0]

    def apply(self, state: Any, in_batches: Sequence[DeltaBatch]) -> DeltaBatch:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class Map(Op):
    """Pure per-row value transform; key and weight preserved.

    ``fn(value) -> value'``. If ``vectorized``, ``fn`` is applied to the
    whole values column at once; otherwise it is applied per row (under
    ``torch.func.vmap`` on the device, where a constant result broadcasts
    to every row).

    ``params`` (optional) is a pytree of ARRAYS the transform closes over
    logically but receives as an explicit first argument: ``fn(params,
    value)``. On device executors the pytree is held as op state and flows
    into the compiled tick program as an *argument*, never a traced
    constant — so the program size is independent of the model size and
    params can be swapped without recompiling (VERDICT r2 #2: a ViT-B
    embedded as constants produced a ~350MB HLO). Static configuration
    (python ints driving reshapes) does NOT belong in ``params``; close
    ``fn`` over it.
    """

    kind = "map"

    def __init__(self, fn: Callable, *, vectorized: bool = False,
                 linear: bool = False, out_spec: Optional[Spec] = None,
                 params: Any = None, param_specs: Any = None):
        self.fn = fn
        self.vectorized = vectorized
        #: optional pytree of jax.sharding.PartitionSpec matching
        #: ``params``: under a ShardedTpuExecutor with a model axis, the
        #: params shard per these specs instead of replicating, and
        #: ``fn`` receives its LOCAL shard inside shard_map — the fn is
        #: then responsible for the model-axis collectives (e.g.
        #: models.vit.vit_forward_tp's two psums per block). This is the
        #: tensor-parallel seam for models too large for one chip's HBM.
        self.param_specs = param_specs
        #: declares fn linear (fn(a·x + b·y) == a·fn(x) + b·fn(y), so
        #: fn(0) == 0). Enables the fused delta-vector fixpoint lowering
        #: for loop regions whose operator chain is linear end to end
        #: (see executors/linear_fixpoint.py).
        self.linear = linear
        self.params = params
        self._out_spec = out_spec

    def out_spec(self, in_specs):
        return self._out_spec if self._out_spec is not None else in_specs[0]

    def apply(self, state, in_batches):
        (b,) = in_batches
        if len(b) == 0:
            return DeltaBatch.empty(self._out_spec)
        fn = self.fn if self.params is None else (
            lambda *cols: self.fn(self.params, *cols))
        if self.vectorized:
            vals = np.asarray(fn(b.values))
        else:
            vals = np.array([fn(v) for v in b.values], dtype=object)
        return DeltaBatch(b.keys, vals, b.weights)


class Filter(Op):
    """Keep rows where ``pred(value)`` holds; key/weight preserved.

    Same vectorization contract as :class:`Map`.
    """

    kind = "filter"

    def __init__(self, pred: Callable, *, vectorized: bool = False):
        self.pred = pred
        self.vectorized = vectorized

    def apply(self, state, in_batches):
        (b,) = in_batches
        if len(b) == 0:
            return b
        if self.vectorized:
            mask = np.asarray(self.pred(b.values), dtype=bool)
        else:
            mask = np.array([bool(self.pred(v)) for v in b.values])
        return DeltaBatch(b.keys[mask], b.values[mask], b.weights[mask])


class GroupBy(Op):
    """Re-key rows: ``key' = key_fn(key, value)``; value/weight preserved
    unless ``value_fn`` is given.

    Feeds :class:`Reduce` (SURVEY.md §2 item 6). On TPU a re-key is what
    triggers cross-shard routing (``all_to_all`` on the key axis).
    """

    kind = "groupby"

    def __init__(self, key_fn: Callable, value_fn: Optional[Callable] = None,
                 *, vectorized: bool = False, out_spec: Optional[Spec] = None,
                 stable_key: bool = False):
        self.key_fn = key_fn
        self.value_fn = value_fn
        self.vectorized = vectorized
        self._out_spec = out_spec
        #: DECLARATION (unchecked contract): inside a declared-linear loop
        #: region, ``key_fn``'s output does not depend on the loop/left
        #: value — only on the input key and the right-side (arena) value
        #: components of the merged row (e.g. PageRank's dst, read from
        #: the edge). The fused fixpoint then precomputes each arena
        #: row's destination at CSR-build time and runs its dense tier as
        #: a destination-SORTED segment sum instead of a random
        #: scatter-add (~30% cheaper at 1M rows, measured v5e).
        self.stable_key = stable_key

    def out_spec(self, in_specs):
        if self._out_spec is not None:
            return self._out_spec
        # re-keying can collapse distinct keys: uniqueness is NOT preserved
        return dataclasses.replace(in_specs[0], unique=False)

    def apply(self, state, in_batches):
        (b,) = in_batches
        if len(b) == 0:
            return b
        if self.vectorized:
            keys = np.asarray(self.key_fn(b.keys, b.values))
            vals = (np.asarray(self.value_fn(b.keys, b.values))
                    if self.value_fn else b.values)
        else:
            keys = np.array([self.key_fn(k, v) for k, v in zip(b.keys, b.values)],
                            dtype=object)
            vals = (np.array([self.value_fn(k, v) for k, v in zip(b.keys, b.values)],
                             dtype=object)
                    if self.value_fn else b.values)
        return DeltaBatch(keys, vals, b.weights)


# -- Reduce ---------------------------------------------------------------

def _wv(v, w):
    """Weighted value; vector values (stored as tuples) go through numpy."""
    if isinstance(v, tuple):
        return np.asarray(v, np.float64) * w
    return v * w


def _agg_sum(ms: Counter):
    return sum(_wv(v, w) for v, w in ms.items())


def _agg_count(ms: Counter) -> int:
    return sum(ms.values())


def _agg_mean(ms: Counter):
    n = sum(ms.values())
    return _agg_sum(ms) / n


def _agg_min(ms: Counter):
    return min(v for v, w in ms.items() if w > 0)


def _agg_max(ms: Counter):
    return max(v for v, w in ms.items() if w > 0)


_EMPTY_MS: Counter = Counter()

#: name -> (aggregate_fn, linear?) — linear reducers lower to pure
#: scatter-add on device; non-linear ones need multiset state (host) or
#: recompute-on-retract (device, bounded key groups).
REDUCERS = {
    "sum": (_agg_sum, True),
    "count": (_agg_count, True),
    "mean": (_agg_mean, True),
    "min": (_agg_min, False),
    "max": (_agg_max, False),
}


class _NoAgg:
    """Sentinel: the group has no defined aggregate (empty / degenerate)."""

    def __repr__(self):
        return "<no-agg>"


_NO_AGG = _NoAgg()


class Reduce(Op):
    """Incremental keyed aggregation with persistent per-key state.

    Emits the *change in the aggregate*: retract the previously **emitted**
    aggregate, insert the new one (each weight ±1); a group appearing emits
    only the insert, a group vanishing only the retract. ``tol`` suppresses
    emission when a float aggregate moved by ≤ tol — this is what lets
    iterative graphs (PageRank) quiesce. Retractions are always against the
    last emitted value (not the raw state aggregate), so tol-suppressed
    drift never corrupts downstream views.

    Oracle state: ``{key: (Counter(value -> weight), last_emitted_agg)}`` —
    exact for all reducers including non-invertible min/max. Multisets with
    negative or mixed-sign multiplicities (legal transients in the
    differential algebra) are preserved, not discarded.
    """

    kind = "reduce"

    def __init__(self, how: str = "sum", *, tol: float = 0.0,
                 out_spec: Optional[Spec] = None, candidates: int = 8):
        if how not in REDUCERS:
            raise ValueError(f"unknown reducer {how!r}; have {sorted(REDUCERS)}")
        if candidates < 1:
            raise ValueError(f"candidates must be >= 1, got {candidates}")
        self.how = how
        self.tol = tol
        #: device min/max only: per-key candidate-buffer depth. The device
        #: path keeps the ``candidates`` best distinct values per key with
        #: their multiset weights, so retractions stay EXACT until a key's
        #: churn exceeds the buffer — then a sticky error raises at the
        #: next sync (loud, never a wrong aggregate). The host oracle is
        #: always exact. Irrelevant for linear reducers.
        self.candidates = candidates
        self._out_spec = out_spec

    def out_spec(self, in_specs):
        spec = self._out_spec if self._out_spec is not None else in_specs[0]
        return spec.as_unique()  # one aggregate row per key

    def initial_state(self):
        return {}

    def _aggregate(self, ms: Counter):
        """Aggregate of a (possibly mixed-sign) multiset, or _NO_AGG.

        Linear reducers define group existence via their *linear
        observables* (net count Σw, weighted sum Σw·v): a group whose
        observables are all zero is indistinguishable from an empty group
        downstream, so both host and device treat it as vanished. This
        keeps the cpu-vs-tpu differential contract exact (the device path
        only keeps the linear observables, never the full multiset).
        min/max keep true multiset existence (host-only reducers).
        """
        if not ms:
            return _NO_AGG
        if self.how in ("min", "max"):
            if not any(w > 0 for w in ms.values()):
                return _NO_AGG
        elif self.how in ("mean", "count"):
            if sum(ms.values()) == 0:
                return _NO_AGG
        fn, _ = REDUCERS[self.how]
        agg = fn(ms)
        if self.how == "sum":
            if (sum(ms.values()) == 0 and
                    bool(np.all(np.asarray(agg) == 0))):
                return _NO_AGG
        if isinstance(agg, np.ndarray):
            # vector aggregate: keep it hashable for the emission multiset
            agg = tuple(agg.tolist())
        return agg

    def apply(self, state, in_batches):
        (b,) = in_batches
        tick: dict = defaultdict(Counter)
        for k, v, w in b.rows():
            tick[k][v] += w
        out: Counter = Counter()
        for k, dms in tick.items():
            old_ms, emitted = state.get(k, (_EMPTY_MS, _NO_AGG))
            new_ms = Counter(old_ms)
            for v, w in dms.items():
                new_ms[v] += w
            new_ms = Counter({v: w for v, w in new_ms.items() if w != 0})
            new_agg = self._aggregate(new_ms)
            if emitted is _NO_AGG and new_agg is not _NO_AGG:
                out[(k, new_agg)] += 1
                emitted = new_agg
            elif emitted is not _NO_AGG and new_agg is _NO_AGG:
                out[(k, emitted)] -= 1
                emitted = _NO_AGG
            elif emitted is not _NO_AGG and not _close(emitted, new_agg, self.tol):
                out[(k, emitted)] -= 1
                out[(k, new_agg)] += 1
                emitted = new_agg
            if new_ms or emitted is not _NO_AGG:
                state[k] = (new_ms, emitted)
            else:
                state.pop(k, None)
        return counter_to_batch(out, like=b)


def _close(a, b, tol: float) -> bool:
    if isinstance(a, tuple) or isinstance(b, tuple):
        if tol <= 0.0:
            return a == b
        try:
            av = np.asarray(a, np.float64)
            bv = np.asarray(b, np.float64)
            ok = (np.abs(av - bv) <= tol) | (np.isnan(av) & np.isnan(bv))
            return bool(np.all(ok))
        except (TypeError, ValueError):
            return a == b
    if tol <= 0.0:
        return a == b
    try:
        return bool(abs(a - b) <= tol) or (isinstance(a, float) and isinstance(b, float)
                                           and math.isnan(a) and math.isnan(b))
    except TypeError:
        return a == b


def _merge_arg(v):
    """Host-boundary form of a join value handed to ``merge``: FLAT tuples
    of numeric scalars become 1-D f64 arrays (the array-like contract);
    anything else — scalars, strings, arrays, and ANY nested tuple —
    passes through unchanged. The flatness test is explicit (ADVICE r3):
    ``np.asarray`` would silently coerce a rectangular numeric nest (e.g.
    a default join's ``(va, vb)`` pair of equal-length vectors) into a
    2-D array, handing a downstream custom merge a different shape than
    the nested-tuple contract documents."""
    if isinstance(v, tuple) and all(
            isinstance(x, (int, float, bool, np.number, np.bool_))
            for x in v):
        return np.asarray(v, np.float64)
    return v


class Join(Op):
    """Incremental binary equi-join with per-side multiset state.

    δ(A⋈B) = δA⋈B + (A+δA)⋈δB. Output rows are
    ``(key, merge(key, va, vb))`` with weight ``wa*wb``; ``merge`` defaults
    to the tuple ``(va, vb)``.

    Merge contract: values arrive ARRAY-LIKE on both executors — per row
    on the CPU oracle (scalars stay scalars; vector values arrive as 1-D
    float64 arrays), batched with a leading row axis on the device path.
    Elementwise expressions (``va + vb``) therefore behave identically on
    both; a merge that needs to tell the forms apart branches on ``ndim``
    (see ``workloads/pagerank._contrib_merge``). Host multiset state
    stays hashable internally (tuples) — the conversion happens at this
    call boundary, both ways.
    """

    kind = "join"
    arity = 2

    def __init__(self, merge: Optional[Callable] = None, *,
                 out_spec: Optional[Spec] = None, arena_capacity: int = 1 << 16,
                 linear_left: bool = False,
                 left_arena_capacity: Optional[int] = None,
                 product_slack: int = 4):
        self.merge = merge
        self._out_spec = out_spec
        #: device-path right-side arena capacity (rows); the TPU executor
        #: stores the right collection as a fixed-size append log.
        self.arena_capacity = arena_capacity
        #: MULTISET-left device path only (left Spec not unique): the left
        #: side is a second append arena of this capacity (defaults to
        #: arena_capacity), and each tick's delta×arena products run at a
        #: static budget of ``product_slack x delta_capacity`` pair slots
        #: per side — a true pair count beyond the budget sets the sticky
        #: error (loud, never truncation). Unique-left joins ignore both.
        self.left_arena_capacity = left_arena_capacity
        self.product_slack = product_slack
        #: declares ``merge(k, va, vb)`` linear in ``va`` (so
        #: ``merge(k, 0, vb)`` zeroes every va-dependent component), and —
        #: if a GroupBy consumes this join — that its ``key_fn``/any
        #: va-independent uses read only components that survive
        #: ``merge(k, 0, vb)`` unchanged. Enables the fused delta-vector
        #: fixpoint lowering (executors/linear_fixpoint.py).
        self.linear_left = linear_left

    def out_spec(self, in_specs):
        if self._out_spec is not None:
            return self._out_spec
        return in_specs[0]

    def initial_state(self):
        return (defaultdict(Counter), defaultdict(Counter))

    def _emit(self, out: Counter, k, va, wa, vb, wb):
        if self.merge is None:
            out[(k, (va, vb))] += wa * wb
            return
        # NUMERIC vector values live as hashable TUPLES in the host
        # multiset state; the device path hands merge jax ARRAYS. Convert
        # at the boundary both ways so one array-style merge (e.g.
        # ``lambda k, va, vb: va + vb`` meaning elementwise) serves both
        # executors — without this, tuple + tuple would concatenate.
        # Non-numeric / nested tuples (host-only graphs: strings, a
        # default join's (va, vb) pairs) pass through untouched.
        v = self.merge(k, _merge_arg(va), _merge_arg(vb))
        if isinstance(v, np.ndarray):
            v = _hashable(v)
        out[(k, v)] += wa * wb

    def apply(self, state, in_batches):
        left, right = state
        da, db = in_batches
        out: Counter = Counter()
        # δA ⋈ B (old B)
        for k, va, wa in da.rows():
            for vb, wb in right[k].items():
                if wb:
                    self._emit(out, k, va, wa, vb, wb)
        # fold δA into A
        for k, va, wa in da.rows():
            left[k][va] += wa
            if left[k][va] == 0:
                del left[k][va]
            if not left[k]:
                del left[k]
        # (A + δA) ⋈ δB
        for k, vb, wb in db.rows():
            for va, wa in left[k].items():
                if wa:
                    self._emit(out, k, va, wa, vb, wb)
        # fold δB into B
        for k, vb, wb in db.rows():
            right[k][vb] += wb
            if right[k][vb] == 0:
                del right[k][vb]
            if not right[k]:
                del right[k]
        return counter_to_batch(out, like=da if len(da) else db)


class Union(Op):
    """Multiset union (addition) of n same-spec delta streams."""

    kind = "union"

    def __init__(self, arity: int = 2):
        self.arity = arity

    def out_spec(self, in_specs):
        # merged streams can collide on keys: uniqueness is NOT preserved
        return dataclasses.replace(in_specs[0], unique=False)

    def apply(self, state, in_batches):
        return DeltaBatch.concat(in_batches)
