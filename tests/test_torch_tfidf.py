"""Streaming TF-IDF (BASELINE config 2) on the port's ``cuda`` executor,
on the CPU, against the brute-force oracle, the JAX ``TpuExecutor`` and
the port's CPU oracle.

The graph's row functions include constants (``lambda v: 1.0``, a GroupBy
key ``lambda k, v: 0``): the port broadcasts them to every row as
``jax.vmap`` does. Tolerances: the ``tf``/``df``/``ndocs`` tables hold
small integer counts in float32 and are compared exactly with the JAX
executor's; the combined TF-IDF within 1e-5 of the oracle, as in the JAX
package's own test.
"""

import numpy as np

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.workloads import tfidf as jtf
from reflow_tpu_torch.workloads import tfidf as ptf

DOCS = [
    "the quick brown fox jumps over the lazy dog",
    "the cat sat on the mat",
    "a quick brown cat",
    "dogs and cats living together",
    "the dog chased the cat over the mat",
]


def _sched(pkg, g):
    if pkg == "jax":
        return JDirtyScheduler(g, jget_executor("tpu"))
    return P.DirtyScheduler(g, P.get_executor("cuda", device="cpu")
                            if pkg == "port" else P.CpuExecutor())


def _drive(pkg):
    mod = jtf if pkg == "jax" else ptf
    tg = mod.build_graph(n_pairs=256, n_terms=64, n_docs=16)
    sched = _sched(pkg, tg.graph)
    corpus = mod.Corpus(256, 64)
    # initial corpus, one doc per tick (streaming)
    for i, text in enumerate(DOCS[:3]):
        sched.push(tg.tokens, corpus.edit(i, text))
        sched.tick()
    # batch tick with two more docs
    DB = type(corpus.edit(0, DOCS[0]))
    sched.push(tg.tokens, DB.concat(
        [corpus.edit(3, DOCS[3]), corpus.edit(4, DOCS[4])]))
    sched.tick()
    # edit an existing doc (retract+insert deltas), delete another
    sched.push(tg.tokens, corpus.edit(1, "the cat sat on a new hat"))
    sched.tick()
    sched.push(tg.tokens, corpus.edit(2, None))
    sched.tick()
    return sched, tg, corpus


def _check(sched, tg, corpus, mod=ptf):
    got = mod.tfidf_view(sched, tg, corpus)
    ref = corpus.reference_tfidf()
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) < 1e-5, (k, got[k], ref[k])
    (n,) = sched.read_table(tg.ndocs).values()
    assert int(n) == len(corpus.docs)


def _tables(sched, tg):
    return [{int(k): float(v) for k, v in sched.read_table(node).items()}
            for node in (tg.tf, tg.df, tg.ndocs)]


def test_port_matches_oracle():
    _check(*_drive("port"))
    _check(*_drive("cpu"))


def test_tables_identical_to_jax():
    ps, ptg, _ = _drive("port")
    js, jtg, _ = _drive("jax")
    assert _tables(ps, ptg) == _tables(js, jtg)


def test_large_vocab_term_ids_exact():
    """Term ids far beyond 2**14 survive the radix-split presence path
    exactly, as in the JAX package."""
    n_terms = 1 << 20
    terms = [937_211, 16_384, (1 << 20) - 1, 12]
    rows = [(0, terms[0], 3), (1, terms[0], 1), (1, terms[1], 2),
            (0, terms[2], 1), (1, terms[3], 5)]  # (doc, term, count)
    keys = np.arange(len(rows))
    vals = np.array([[t, d] for d, t, _ in rows], np.float32)
    w = np.array([c for *_, c in rows], np.int64)
    dfs = {}
    for pkg in ("port", "jax"):
        mod = jtf if pkg == "jax" else ptf
        tg = mod.build_graph(n_pairs=64, n_terms=n_terms, n_docs=8)
        sched = _sched(pkg, tg.graph)
        DB = type(mod.Corpus(1, 1).edit(0, None))
        sched.push(tg.tokens, DB(keys, vals, w))
        sched.tick()
        df = {int(k): float(v) for k, v in sched.read_table(tg.df).items()}
        assert df == {terms[0]: 2.0, terms[1]: 1.0, terms[2]: 1.0,
                      terms[3]: 1.0}
        # full retraction of doc 0's copy of terms[0] -> its df drops to 1
        sched.push(tg.tokens, DB(keys[:1], vals[:1],
                                 np.array([-3], np.int64)))
        sched.tick()
        dfs[pkg] = {int(k): float(v)
                    for k, v in sched.read_table(tg.df).items()}
        assert dfs[pkg][terms[0]] == 1.0
    assert dfs["port"] == dfs["jax"]


def test_tick_many_equals_sequential_ticks():
    """``tick_many`` over the edits equals one tick per edit, table for
    table, and matches the oracle."""
    def drive(many):
        tg = ptf.build_graph(n_pairs=256, n_terms=64, n_docs=16)
        sched = _sched("port", tg.graph)
        corpus = ptf.Corpus(256, 64)
        feeds = [{tg.tokens: corpus.edit(i, t)} for i, t in enumerate(DOCS)]
        feeds.append({tg.tokens: corpus.edit(0, "the fox sleeps")})
        if many:
            agg = sched.tick_many(feeds).block()
            assert agg.quiesced and agg.passes == len(feeds)
        else:
            for f in feeds:
                for src, b in f.items():
                    sched.push(src, b)
                sched.tick(sync=False)
        return sched, tg, corpus

    s1, g1, c1 = drive(False)
    s2, g2, c2 = drive(True)
    assert _tables(s1, g1) == _tables(s2, g2)
    assert ptf.tfidf_view(s1, g1, c1) == ptf.tfidf_view(s2, g2, c2)
    _check(s2, g2, c2)
