"""Benchmark config 2: streaming TF-IDF over document-edit deltas.

The port's copy of ``reflow_tpu/workloads/tfidf.py``: the same graph, the
same host ``Corpus`` and the same combine. BASELINE.md: "Streaming TF-IDF
over Wikipedia-edit deltas (Map / GroupBy / Reduce)". The graph maintains
the classic decomposition with exactly that op vocabulary (no Join)::

    src(key=pair, value=[term, doc], weight=+-occurrences)
    tf      = Reduce(sum)(Map(1))            {pair: tf}
    pres    = Reduce(mean)(Map(v[0]))        {pair: term}   (see below)
    df      = Reduce(sum)(GroupBy(term, 1)(pres-emissions)) {term: df}
    doctok  = Reduce(sum)(GroupBy(doc, 1)(src))             {doc: tokens}
    ndocs   = Reduce(sum)(GroupBy(0, 1)(doctok-emissions))  {0: N}

The presence trick: ``Reduce('mean')`` over a constant per-pair value
emits exactly one insert when a (doc, term) pair first appears and one
retract when its count reaches zero — tf changes in between leave the
mean unchanged and are suppressed. Grouping those ±1 presence rows by
term and summing gives the document frequency incrementally. The same
telescoping applied to ``doctok``'s emissions (every live doc nets exactly
one row) counts distinct documents.

``tfidf(doc, term) = tf * log(N / df)`` is combined at the sink boundary
(host side) from the three maintained tables.

Exactness bound (device path): the mean-reduce keeps a float32 running
sum of ``component * tf`` per pair, so each stored component must satisfy
``component * max_tf < 2**24``. The presence value is therefore the term
id split radix-``_TERM_RADIX`` into two small components ``[term // R,
term % R]`` (each < 4096), and the by-term GroupBy reassembles ``term =
v0*R + v1``: exact up to 2**24 terms at a per-document term count of
4096.

Several row functions return a constant (``lambda v: 1.0``, ``lambda k,
v: 0``); the device lowering broadcasts such a result to every row, as
``jax.vmap`` does.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from reflow_tpu_torch.delta import DeltaBatch, Spec
from reflow_tpu_torch.graph import FlowGraph, Node

__all__ = ["TfidfGraph", "Corpus", "build_graph", "tfidf_view", "tokenize"]

_TOKEN = re.compile(r"[A-Za-z0-9']+")


def tokenize(text: str) -> List[str]:
    return [t.lower() for t in _TOKEN.findall(text)]


@dataclasses.dataclass
class TfidfGraph:
    graph: FlowGraph
    tokens: Node   # source
    tf: Node       # read_table -> {pair: tf}
    df: Node       # read_table -> {term: df}
    ndocs: Node    # read_table -> {0: N}


#: radix for splitting term ids into two f32-exact presence components
_TERM_RADIX = 4096


def _split_term(v):
    """[C, 2] (term, doc) -> [C, 2] (term // R, term % R): numpy on the
    CPU oracle, torch (float32 floor division) on the device."""
    t = v[:, 0]
    hi = t // _TERM_RADIX
    lo = t - hi * _TERM_RADIX
    if isinstance(v, np.ndarray):
        return np.stack([hi, lo], axis=-1)
    return torch.stack([hi, lo], dim=-1)


def build_graph(n_pairs: int, n_terms: int, n_docs: int,
                *, n0: int = 8) -> TfidfGraph:
    if n_terms > 1 << 24:
        raise ValueError(
            f"n_terms {n_terms} > 2**24 would overflow the float32 "
            f"radix-split presence components (see module docstring)")
    f32 = np.float32
    g = FlowGraph("tfidf")
    src = g.source("tokens", Spec((2,), f32, key_space=n_pairs))
    ones = g.map(src, lambda v: 1.0, spec=Spec((), f32, key_space=n_pairs),
                 name="ones")
    tf = g.reduce(ones, "sum", name="tf")
    term_of = g.map(src, _split_term, vectorized=True,
                    spec=Spec((2,), f32, key_space=n_pairs), name="term_of")
    pres = g.reduce(term_of, "mean", name="pair_presence")
    bterm = g.group_by(
        pres, key_fn=lambda k, v: v[0] * _TERM_RADIX + v[1],
        value_fn=lambda k, v: 1.0,
        spec=Spec((), f32, key_space=n_terms), name="by_term")
    df = g.reduce(bterm, "sum", name="df")
    bdoc = g.group_by(src, key_fn=lambda k, v: v[1],
                      value_fn=lambda k, v: 1.0,
                      spec=Spec((), f32, key_space=n_docs), name="by_doc")
    doctok = g.reduce(bdoc, "sum", name="doc_tokens")
    bone = g.group_by(doctok, key_fn=lambda k, v: 0,
                      value_fn=lambda k, v: 1.0,
                      spec=Spec((), f32, key_space=n0), name="all_docs")
    ndocs = g.reduce(bone, "sum", name="ndocs")
    return TfidfGraph(g, src, tf, df, ndocs)


# -- host boundary: edit ingestion + vocab interning -----------------------

class Corpus:
    """Host mirror: documents, term/pair vocabularies, delta generation."""

    def __init__(self, n_pairs: int, n_terms: int):
        self.n_pairs, self.n_terms = n_pairs, n_terms
        self.terms: Dict[str, int] = {}
        self.pairs: Dict[Tuple[int, int], int] = {}
        self.docs: Dict[int, Counter] = {}

    def _term(self, t: str) -> int:
        i = self.terms.setdefault(t, len(self.terms))
        if i >= self.n_terms:
            raise ValueError(f"term vocabulary overflow (> {self.n_terms})")
        return i

    def _pair(self, doc: int, term: int) -> int:
        i = self.pairs.setdefault((doc, term), len(self.pairs))
        if i >= self.n_pairs:
            raise ValueError(f"pair vocabulary overflow (> {self.n_pairs})")
        return i

    def edit(self, doc: int, new_text: Optional[str]) -> DeltaBatch:
        """Replace (or with None, delete) a document; returns token deltas."""
        old = self.docs.get(doc, Counter())
        new = Counter(self._term(t) for t in tokenize(new_text)) \
            if new_text is not None else Counter()
        keys, vals, weights = [], [], []
        for term in set(old) | set(new):
            w = new[term] - old[term]
            if w:
                keys.append(self._pair(doc, term))
                vals.append((float(term), float(doc)))
                weights.append(w)
        if new:
            self.docs[doc] = new
        else:
            self.docs.pop(doc, None)
        return DeltaBatch(np.array(keys, np.int64),
                          np.array(vals, np.float32).reshape(-1, 2),
                          np.array(weights, np.int64))

    # -- oracles -----------------------------------------------------------

    def reference_tfidf(self) -> Dict[Tuple[int, int], float]:
        """Brute-force recompute over the current corpus."""
        n = len(self.docs)
        df: Counter = Counter()
        for c in self.docs.values():
            df.update(set(c))
        out = {}
        for doc, c in self.docs.items():
            for term, tf in c.items():
                out[(doc, term)] = tf * math.log(n / df[term])
        return out


def tfidf_view(sched, tg: TfidfGraph, corpus: Corpus
               ) -> Dict[Tuple[int, int], float]:
    """Sink-boundary combine of the three maintained tables."""
    tf = sched.read_table(tg.tf)
    df = sched.read_table(tg.df)
    nd = sched.read_table(tg.ndocs)
    n = float(next(iter(nd.values()))) if nd else 0.0
    rev = {i: dt for dt, i in corpus.pairs.items()}
    out = {}
    for pair, tfv in tf.items():
        doc, term = rev[int(pair)]
        out[(doc, term)] = float(tfv) * math.log(n / float(df[term]))
    return out
