"""Benchmark config 1: incremental word-count (single Map→Reduce).

The port's copy of ``reflow_tpu/workloads/wordcount.py``, with the same
API. Tokenization happens at the host boundary (source ingest); the graph
itself is Map (to the countable unit) → Reduce (sum). Raw word strings are
the keys on the CPU oracle; for the device path ``ingest_lines(vocab=...)``
interns words into dense integer keys through a host-side vocabulary, and
``build_graph(key_space)`` needs ``key_space > 0`` above the vocabulary.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from reflow_tpu_torch.delta import DeltaBatch, Spec
from reflow_tpu_torch.graph import FlowGraph, Node

__all__ = ["tokenize", "build_graph", "ingest_lines"]

_TOKEN = re.compile(r"[A-Za-z0-9']+")


def tokenize(line: str) -> List[str]:
    return [t.lower() for t in _TOKEN.findall(line)]


def build_graph(key_space: int = 0) -> Tuple[FlowGraph, Node, Node]:
    """Map→Reduce word-count graph. Returns (graph, source, sink).

    Map projects each token row to the countable unit ``1.0`` (so upstream
    payloads don't matter), Reduce('sum') folds ``value*weight`` per word.
    """
    spec = Spec((), np.float32, key_space=key_space)
    g = FlowGraph("wordcount")
    words = g.source("words", spec)
    # dtype-generic (v*0+1): numpy on the CPU oracle, torch on the device
    ones = g.map(words, lambda v: v * 0 + 1, vectorized=True, name="to_ones")
    counts = g.reduce(ones, "sum", name="counts", spec=spec)
    out = g.sink(counts, "out")
    return g, words, out


def ingest_lines(lines: Iterable[str], weight: int = 1,
                 vocab: Optional[Dict[str, int]] = None) -> DeltaBatch:
    """Host-side ingest: tokenize lines into (word, 1) delta rows.

    With ``vocab``, words are interned to dense int keys (extending the
    vocab in place) for integer-keyed / device graphs.
    """
    keys: List = []
    for line in lines:
        for tok in tokenize(line):
            if vocab is not None:
                tok = vocab.setdefault(tok, len(vocab))
            keys.append(tok)
    n = len(keys)
    if vocab is not None:
        karr = np.array(keys, dtype=np.int64)
    else:
        karr = np.array(keys, dtype=object)
    return DeltaBatch(karr, np.ones(n, dtype=np.float32),
                      np.full(n, weight, dtype=np.int64))
