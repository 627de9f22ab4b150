"""Configuration ``pagerank-1m-edges``: the port's incremental PageRank
of a 100,000-node, 1,000,000-edge web graph, served through
``IngestFrontend``.

The graph comes from the seed on the host (``datagen.web_graph``); the
edges to rewire come from the seed on the card, for as many writes as
the mix makes ready. Item operation of a mix:

- ``rewire``: one edge gets a new destination, its source and so every
  out-degree kept: two delta rows (the old edge retracted, the new one
  inserted).

``tiny`` and ``alter`` serve the CPU tests alone: the configuration's cut
to a size the CPU runs in a second or two, and its planted fault.
"""

from __future__ import annotations

import copy
from typing import List

import numpy as np
import torch

from benchmark import datagen
from benchmark.generator import Write

from reflow_tpu_torch import DeltaBatch, DirtyScheduler, get_executor
from reflow_tpu_torch.executors.device_delta import bucket_capacity
from reflow_tpu_torch.serve import CoalesceWindow, IngestFrontend
from reflow_tpu_torch.workloads import pagerank


def tiny(cfg: dict, mix: dict):
    """``(cfg, mix)`` cut for a run on the CPU with the port's plain
    kernels (copies)."""
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg.update(nodes=2000, edges=20000)
    mix.update(size={"min": 200, "max": 200}, warm_writes=3,
               max_rate_per_s=100, replay={"ticks": 3, "writes_per_tick": 1})
    return cfg, mix


def alter(ranks: np.ndarray) -> np.ndarray:
    """The served ranks with one answer altered: the top node's rank
    moved by 1%."""
    ranks = ranks.copy()
    ranks[int(np.argmax(ranks))] *= 1.01
    return ranks


class Deployment:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.n, self.E = int(cfg["nodes"]), int(cfg["edges"])

    def make_data(self, warm: List[Write], window: List[Write]) -> None:
        """The run's data from the seed, before any of the program: the
        graph and the edges each write rewires."""
        n, E = self.n, self.E
        m = {w.ops["rewire"] for w in warm + window}
        if len(m) != 1:
            raise ValueError("every rewire write has the same size")
        self.m = m.pop()
        self.src, self.dst0 = datagen.web_graph(n, E, self.seed)
        self.dst = self.dst0.copy()
        deg = np.bincount(self.src, minlength=n)
        self.inv = (1.0 / np.maximum(deg, 1)).astype(np.float32)
        self.n_warm = len(warm)
        self.idx, self.new = datagen.rewire_plan(
            len(warm) + len(window), self.m, E, n, self.seed, self.device)
        self.made = 0
        self._ready = {}
        self.info = {"warm": [self._info()] * len(warm),
                     "window": [self._info()] * len(window)}

    def setup(self, warm: List[Write], window: List[Write]) -> None:
        """Make the data, build the system, and load the teleport rows and
        the graph through the frontend."""
        self.make_data(warm, window)
        cfg, n, E = self.cfg, self.n, self.E
        churn = int(cfg["churn_fraction"] * E)
        arena = bucket_capacity(E) + 8 * bucket_capacity(2 * churn + 2)
        self.pg = pagerank.build_graph(n, damping=cfg["damping"],
                                       tol=cfg["tol"], arena_capacity=arena)
        self.sched = DirtyScheduler(self.pg.graph,
                                    get_executor("cuda", device=self.device))
        f = cfg["frontend"]
        self.fe = IngestFrontend(
            self.sched, policy=f["policy"], queue_batches=f["queue_batches"],
            max_bytes=f["max_bytes"], window=CoalesceWindow(
                max_rows=f["max_rows"], max_ticks=f["max_ticks"],
                max_latency_s=f["max_latency_s"]))
        d = cfg["damping"]
        tickets = [
            self.fe.submit(self.pg.teleport, DeltaBatch(
                np.arange(n, dtype=np.int64),
                np.full(n, 1.0 - d, np.float32), np.ones(n, np.int64))),
            self.fe.submit(self.pg.edges, DeltaBatch(
                self.src.copy(), np.stack([self.dst0.astype(np.float32),
                                           self.inv[self.src]], axis=-1),
                np.ones(E, np.int64)))]
        self.fe.flush()
        for t in tickets:
            if not t.result(timeout=600).applied:
                raise RuntimeError(f"set-up write {t.batch_id} not applied")

    def _info(self) -> dict:
        return {"items": self.m, "rows": 2 * self.m}

    def _batch(self, j: int) -> DeltaBatch:
        """Write ``j`` of the run (warm-up first), made in order: it
        retracts each rewired edge at its current destination."""
        if j != self.made:
            raise RuntimeError(f"rewire writes are made in order: {j} "
                               f"after {self.made}")
        self.made += 1
        idx, new = self.idx[j], self.new[j]
        src, old = self.src[idx], self.dst[idx]
        self.dst[idx] = new
        inv = self.inv[src]
        keys = np.concatenate([src, src])
        vals = np.stack([np.concatenate([old, new]).astype(np.float32),
                         np.concatenate([inv, inv])], axis=-1)
        wts = np.concatenate([-np.ones(self.m, np.int64),
                              np.ones(self.m, np.int64)])
        return DeltaBatch(keys, vals, wts)

    def _j(self, phase: str, i: int) -> int:
        return i if phase == "warm" else self.n_warm + i

    def prepare(self, phase: str, i: int) -> None:
        """Make write ``i`` ahead of its send (the writer does so while
        the write before it is in flight)."""
        j = self._j(phase, i)
        self._ready[j] = self._batch(j)

    def batch(self, phase: str, i: int) -> DeltaBatch:
        j = self._j(phase, i)
        b = self._ready.pop(j, None)
        return b if b is not None else self._batch(j)

    @property
    def source(self):
        """The source node the writes go to."""
        return self.pg.edges

    def submit(self, phase: str, i: int, batch_id: str):
        return self.fe.submit(self.source, self.batch(phase, i),
                              batch_id=batch_id)

    def output(self) -> np.ndarray:
        """The maintained ranks as a dense vector (a node the table lacks
        holds the teleport floor, as ``read_table`` documents)."""
        out = np.full(self.n, 1.0 - self.cfg["damping"])
        for k, v in self.sched.read_table(self.pg.new_rank).items():
            out[int(k)] = float(v)
        return out

    def inputs(self, n_warm: int, n_window: int) -> dict:
        """The graph's seed and size and the rewires sent, in order."""
        take = list(range(n_warm)) + [self.n_warm + i
                                      for i in range(n_window)]
        return {"seed": self.seed, "nodes": self.n, "edges": self.E,
                "damping": self.cfg["damping"], "idx": self.idx[take],
                "new": self.new[take]}

    def close(self) -> None:
        self.fe.close()
        del self.fe, self.sched, self.pg
