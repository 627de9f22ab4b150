"""Word-count (BASELINE config 1) on the port's ``cuda`` executor, on the
CPU, against brute force, the JAX ``TpuExecutor`` and the port's CPU
oracle.

The device path takes integer keys: ``ingest_lines(vocab=...)`` interns
each word, and the graph's ``key_space`` covers the vocabulary. The same
lines go through every executor; the counts are compared exactly (they
are small integers in float32), after mapping ids back to words.
"""

from collections import Counter

import numpy as np
import pytest

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.workloads import wordcount as jwc
from reflow_tpu_torch.workloads import wordcount as pwc

LINES_T1 = ["the quick brown fox", "jumps over the lazy dog"]
LINES_T2 = ["the dog barks", "quick quick quick"]
KEY_SPACE = 64


def run(pkg, ticks):
    """``ticks``: a list of (lines, weight) -> ({word: count}, scheduler)."""
    mod = jwc if pkg == "jax" else pwc
    g, src, sink = mod.build_graph(KEY_SPACE)
    if pkg == "jax":
        sched = JDirtyScheduler(g, jget_executor("tpu"))
    else:
        sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu")
                                 if pkg == "port" else P.CpuExecutor())
    vocab = {}
    for lines, weight in ticks:
        sched.push(src, mod.ingest_lines(lines, weight, vocab=vocab))
        r = sched.tick()
        assert r.quiesced
    words = {i: w for w, i in vocab.items()}
    return {words[k]: float(v) for k, v in sched.view_dict(sink).items()}, \
        sched


def brute_counts(ticks):
    c = Counter()
    for lines, weight in ticks:
        for line in lines:
            for tok in pwc.tokenize(line):
                c[tok] += weight
    return {k: float(v) for k, v in c.items() if v}


@pytest.mark.parametrize("ticks", [
    [(LINES_T1, 1), (LINES_T2, 1)],
    [(LINES_T1 + LINES_T2, 1)],
    [(LINES_T1, 1), ([LINES_T1[0]], -1)],
], ids=["two_ticks", "one_tick", "retract_a_line"])
def test_matches_brute_force_and_jax(ticks):
    want = brute_counts(ticks)
    for pkg in ("port", "jax", "cpu"):
        got, _ = run(pkg, ticks)
        assert got == want, pkg


def test_incremental_equals_full_recompute():
    incremental, _ = run("port", [(LINES_T1, 1), (LINES_T2, 1)])
    full, _ = run("port", [(LINES_T1 + LINES_T2, 1)])
    assert incremental == full


def test_read_table_equals_the_sink():
    got, sched = run("port", [(LINES_T1, 1), (LINES_T2, 1),
                              ([LINES_T2[1]], -1)])
    reduce_node = next(n for n in sched.graph.nodes
                       if n.kind == "op" and n.op.kind == "reduce")
    table = sched.read_table(reduce_node)
    sink = next(iter(sched.sink_views))
    assert table == {k: v for k, v in sched.view_dict(sink).items()}


@pytest.mark.parametrize("vals", [
    np.array([1.5, -0.0, 3.0], np.float32),
    np.array([[1.5, 2.0], [0.0, -1.0], [7.0, 7.0]], np.float32),
    np.arange(12, dtype=np.float32).reshape(3, 2, 2),
    np.array([True, False, True]),
    np.array([4, 5, -6], np.int32),
], ids=["scalar", "vector", "matrix", "bool", "int"])
def test_rows_numeric_fast_path_equals_per_row(vals):
    """``DeltaBatch.rows`` converts numeric columns with ``tolist()`` (the
    sink fold's cost); it yields what the per-row ``_hashable`` path
    yields, type for type."""
    from reflow_tpu_torch.delta import DeltaBatch, _hashable

    b = DeltaBatch(np.array([3, 1, 3], np.int64), vals,
                   np.array([1, -2, 5], np.int64))
    got = list(b.rows())
    want = [(k, _hashable(v), int(w))
            for k, v, w in zip(b.keys, b.values, b.weights)]
    assert got == want
    assert [tuple(map(type, r[:1])) for r in got] == [(int,)] * 3
    assert [type(r[1]) for r in got] == [type(r[1]) for r in want]


def test_random_delta_oracle():
    """Thirty ticks of random words over a 20-word vocabulary, a share
    of them retractions of present words (the multiset stays valid):
    the port, JAX and brute force agree after every tick."""
    rng = np.random.default_rng(42)
    words = [f"w{i}" for i in range(20)]
    acc = Counter()
    ticks = []
    for _ in range(30):
        n = int(rng.integers(1, 8))
        rows = []
        for k in rng.choice(words, size=n):
            w = -1 if (acc[k] > 0 and rng.random() < 0.4) else 1
            acc[k] += w
            rows.append((str(k), w))
        ticks.append(rows)
    views = {}
    for pkg in ("port", "jax"):
        mod = jwc if pkg == "jax" else pwc
        g, src, sink = mod.build_graph(KEY_SPACE)
        sched = (JDirtyScheduler(g, jget_executor("tpu")) if pkg == "jax"
                 else P.DirtyScheduler(g, P.get_executor("cuda",
                                                         device="cpu")))
        vocab = {w: i for i, w in enumerate(words)}
        DB = type(mod.ingest_lines([], vocab=vocab))
        for rows in ticks:
            sched.push(src, DB(np.array([vocab[k] for k, _ in rows]),
                               np.ones(len(rows), np.float32),
                               np.array([w for _, w in rows])))
            sched.tick()
        views[pkg] = {words[k]: float(v)
                      for k, v in sched.view_dict(sink).items()}
    expect = {k: float(c) for k, c in acc.items() if c > 0}
    assert views["port"] == views["jax"] == expect
