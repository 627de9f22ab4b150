"""The benchmark's own data: seeds, embeddings, a web graph and its
rewiring.

Frozen copies of the generators the port's workloads carry
(``workloads/knn.py`` ``quantize_int8`` and the embedding store,
``workloads/pagerank.py`` ``WebGraph.random`` and ``churn``), rewritten
to draw on the device in a few large calls. The harness hands what they
make to the program and the plain reference alike; neither side makes
its own.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of one run, from the run's ``--seed``
    (any whole number) and the stream's tags."""
    words = np.random.SeedSequence([int(seed) % (1 << 128), *tags]
                                   ).generate_state(2, np.uint64)
    return int((int(words[0]) << 32 ^ int(words[1])) & ((1 << 63) - 1))


def generator(seed: int, *tags: int, device="cpu") -> torch.Generator:
    """A torch generator on ``device`` for one stream."""
    return torch.Generator(device=device).manual_seed(subseed(seed, *tags))


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator on the host for one stream."""
    return np.random.default_rng(subseed(seed, *tags))


def quantize_int8(v: torch.Tensor) -> torch.Tensor:
    """Each row normalized, scaled by 127, rounded: the corpus's stored
    form (``round(unit * 127)``, one byte a dimension)."""
    v = v.float()
    unit = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                           min=1e-30)
    return torch.clamp(torch.round(unit * 127.0), -127, 127).to(torch.int8)


def embeddings_int8(n: int, dim: int, gen: torch.Generator,
                    device) -> torch.Tensor:
    """``n`` random document embeddings in their int8 stored form, made on
    ``device`` in one call."""
    return quantize_int8(torch.randn((n, dim), generator=gen, device=device))


def web_graph(n_nodes: int, n_edges: int, seed: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``(src, dst)`` int64 edge arrays: sources uniform, destinations
    power-law popular (``WebGraph.random``'s draw)."""
    r = rng(seed, 3)
    src = r.integers(0, n_nodes, n_edges)
    dst = (n_nodes * r.power(0.3, n_edges)).astype(np.int64) % n_nodes
    return src.astype(np.int64), dst.astype(np.int64)


def rewire_plan(n_writes: int, m: int, n_edges: int, n_nodes: int,
                seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """For each of ``n_writes`` writes, ``m`` distinct edges to rewire and
    their new destinations: ``(idx [n, m], new_dst [n, m])`` int64 arrays.
    Drawn on ``device``, one permutation a write, and read back once."""
    g = generator(seed, 4, device=device)
    idx = torch.empty((n_writes, m), dtype=torch.int32, device=device)
    for i in range(n_writes):
        idx[i] = torch.randperm(n_edges, generator=g, device=device)[:m]
    new = torch.randint(0, n_nodes, (n_writes, m), generator=g,
                        device=device, dtype=torch.int32)
    return (idx.cpu().numpy().astype(np.int64),
            new.cpu().numpy().astype(np.int64))
