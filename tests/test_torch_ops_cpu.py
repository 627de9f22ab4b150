"""The port's host operators (``reflow_tpu_torch.ops``, the CPU oracle)
against ``tests/test_ops_cpu.py`` and the JAX package's, on the CPU.

Every test of ``tests/test_ops_cpu.py`` has a counterpart here. Each case
runs the same hand-built delta sequence through the operator of both
packages (``run`` takes the package's ``delta`` and ``ops`` modules) and
holds every output of the port's to the JAX package's and to the values
the reference test asserts.
"""

from collections import Counter

import numpy as np

from reflow_tpu import delta as jdelta
from reflow_tpu import ops as jops
from reflow_tpu_torch import delta as pdelta
from reflow_tpu_torch import ops as pops

PKGS = {"jax": (jdelta, jops), "port": (pdelta, pops)}


def batch(D, rows):
    """rows: list of (key, value, weight)."""
    return D.DeltaBatch(
        np.array([r[0] for r in rows], dtype=object),
        np.array([r[1] for r in rows], dtype=object),
        np.array([r[2] for r in rows], dtype=np.int64),
    )


def both(run):
    """``run(D, O)`` in both packages; its outputs (a list of counters
    and values) must agree. Returns the port's."""
    got = {name: run(D, O) for name, (D, O) in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_map():
    out = both(lambda D, O: [O.Map(lambda v: v * 10).apply(
        None, [batch(D, [("a", 1, 1), ("b", 2, -1)])]).to_counter()])
    assert out == [{("a", 10): 1, ("b", 20): -1}]


def test_map_vectorized():
    def run(D, O):
        b = D.DeltaBatch(np.array([0, 1]), np.array([1.0, 2.0]),
                         np.array([1, 1]))
        return [O.Map(lambda v: v + 1, vectorized=True)
                .apply(None, [b]).to_counter()]

    assert both(run) == [{(0, 2.0): 1, (1, 3.0): 1}]


def test_filter():
    out = both(lambda D, O: [O.Filter(lambda v: v % 2 == 0).apply(
        None, [batch(D, [("a", 1, 1), ("b", 2, 1), ("c", 4, -1)])])
        .to_counter()])
    assert out == [{("b", 2): 1, ("c", 4): -1}]


def test_groupby_rekeys():
    out = both(lambda D, O: [O.GroupBy(lambda k, v: v % 3).apply(
        None, [batch(D, [("x", 4, 1), ("y", 7, 1), ("z", 5, 1)])])
        .to_counter()])
    assert out == [{(1, 4): 1, (1, 7): 1, (2, 5): 1}]


def test_reduce_sum_incremental():
    def run(D, O):
        op = O.Reduce("sum")
        st = op.initial_state()
        outs = [op.apply(st, [batch(D, rows)]).to_counter()
                for rows in ([("a", 1.0, 1), ("a", 2.0, 1)],
                             [("a", 1.0, -1)], [("a", 2.0, -1)])]
        return outs + [st]

    out = both(run)
    assert out[:3] == [{("a", 3.0): 1}, {("a", 3.0): -1, ("a", 2.0): 1},
                       {("a", 2.0): -1}]
    assert out[3] == {}


def test_reduce_count_weights():
    def run(D, O):
        op = O.Reduce("count")
        st = op.initial_state()
        return [op.apply(st, [batch(D, [("w", 1, 3), ("w", 1, 2)])])
                .to_counter()]

    assert both(run) == [{("w", 5): 1}]


def test_reduce_min_retract_nonlinear():
    def run(D, O):
        op = O.Reduce("min")
        st = op.initial_state()
        op.apply(st, [batch(D, [("a", 5, 1), ("a", 3, 1)])])
        return [op.apply(st, [batch(D, [("a", 3, -1)])]).to_counter()]

    # the min climbs back to 5
    assert both(run) == [{("a", 3): -1, ("a", 5): 1}]


def test_reduce_tolerance_suppresses():
    def run(D, O):
        op = O.Reduce("sum", tol=1e-6)
        st = op.initial_state()
        op.apply(st, [batch(D, [("a", 1.0, 1)])])
        return [len(op.apply(st, [batch(D, [("a", 1e-9, 1)])]))]

    assert both(run) == [0]  # a change below tol is quiescent


def test_reduce_tol_drift_retracts_emitted_value():
    """tol-suppressed state drift must not corrupt later retractions: the
    retraction is against the last *emitted* aggregate."""
    def run(D, O):
        op = O.Reduce("sum", tol=1e-6)
        st = op.initial_state()
        net = Counter()
        for kv, w in op.apply(st, [batch(D, [("a", 1.0, 1)])]) \
                .to_counter().items():
            net[kv] += w
        op.apply(st, [batch(D, [("a", 1e-9, 1)])])  # suppressed: drift
        out = op.apply(st, [batch(D, [("a", 1.0, -1), ("a", 1e-9, -1)])])
        for kv, w in out.to_counter().items():
            net[kv] += w
        return [{kv: w for kv, w in net.items() if w != 0}, st]

    # the group is empty again: every emission cancels exactly
    assert both(run) == [{}, {}]


def test_reduce_mixed_sign_multiset_preserved():
    """A multiset whose weights net to <= 0 is not 'vanished': negative
    multiplicities are legal transients of the delta algebra."""
    def run(D, O):
        op = O.Reduce("sum")
        st = op.initial_state()
        return [op.apply(st, [batch(D, rows)]).to_counter()
                for rows in ([("a", 5.0, -1), ("a", 3.0, 1)],
                             [("a", 5.0, 1)])]

    assert both(run) == [{("a", -2.0): 1},
                         {("a", -2.0): -1, ("a", 3.0): 1}]


def test_join_differential():
    def run(D, O):
        op = O.Join()
        st = op.initial_state()
        steps = ([batch(D, [("k", "a1", 1)]), batch(D, [("k", "b1", 1)])],
                 [batch(D, [("k", "a2", 1)]), D.DeltaBatch.empty()],
                 [D.DeltaBatch.empty(), batch(D, [("k", "b1", -1)])])
        return [op.apply(st, ins).to_counter() for ins in steps]

    assert both(run) == [
        {("k", ("a1", "b1")): 1},
        {("k", ("a2", "b1")): 1},
        {("k", ("a1", "b1")): -1, ("k", ("a2", "b1")): -1}]


def test_join_merge_fn():
    def run(D, O):
        op = O.Join(merge=lambda k, va, vb: va + vb)
        st = op.initial_state()
        return [op.apply(st, [batch(D, [("k", 1, 1)]),
                              batch(D, [("k", 10, 1)])]).to_counter()]

    assert both(run) == [{("k", 11): 1}]


def test_union():
    out = both(lambda D, O: [O.Union(2).apply(
        None, [batch(D, [("a", 1, 1)]), batch(D, [("b", 2, -1)])])
        .to_counter()])
    assert out == [{("a", 1): 1, ("b", 2): -1}]


def test_join_incremental_vs_full_random():
    """The differential Join equals the full A x B join of the
    accumulated inputs, and both packages emit the same stream."""
    rng = np.random.default_rng(0)
    steps = []
    for _ in range(20):
        da = [(int(rng.integers(3)), int(rng.integers(4)),
               int(rng.choice([-1, 1])))
              for _ in range(rng.integers(0, 5))]
        db = [(int(rng.integers(3)), int(rng.integers(4)),
               int(rng.choice([-1, 1])))
              for _ in range(rng.integers(0, 5))]
        steps.append((da, db))

    def run(D, O):
        op = O.Join()
        st = op.initial_state()
        outs = []
        for da, db in steps:
            outs.append(op.apply(st, [
                batch(D, da) if da else D.DeltaBatch.empty(),
                batch(D, db) if db else D.DeltaBatch.empty()]).to_counter())
        return outs

    outs = both(run)
    acc_a, acc_b, emitted = Counter(), Counter(), Counter()
    for (da, db), out in zip(steps, outs):
        for kv, w in out.items():
            emitted[kv] += w  # not Counter.__iadd__: it drops <= 0 entries
        for k, v, w in da:
            acc_a[(k, v)] += w
        for k, v, w in db:
            acc_b[(k, v)] += w
    full = Counter()
    for (ka, va), wa in acc_a.items():
        for (kb, vb), wb in acc_b.items():
            if ka == kb and wa and wb:
                full[(ka, (va, vb))] += wa * wb
    assert {kv: w for kv, w in emitted.items() if w != 0} == \
        {kv: w for kv, w in full.items() if w != 0}
