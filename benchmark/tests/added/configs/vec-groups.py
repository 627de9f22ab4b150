"""Configuration ``vec-groups``: group means of float32 vectors, the
table that config 5's image-embed ETL serves (``{group: vector}``), with
a cheap Map in the ViT's place. It stands for a configuration of a new
shape that a later change adds by new files alone.

The graph: source ``{item: [group, *vector]}`` → Map (tanh of each
feature) → GroupBy (group) → Reduce ``mean``. Item operations of a mix:

- ``insert``: a new item under a fresh id, in a random group;
- ``move``: a live item to another group (its old row retracted, the
  new one inserted, the vector kept);
- ``delete``: a live item retracted.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from benchmark import datagen
from benchmark.generator import Write

from reflow_tpu_torch import DeltaBatch, DirtyScheduler, get_executor
from reflow_tpu_torch.delta import Spec
from reflow_tpu_torch.graph import FlowGraph
from reflow_tpu_torch.serve import CoalesceWindow, IngestFrontend


class TrafficRefused(ValueError):
    """The schedule needs more ids than the key space has."""


def tiny(cfg: dict, mix: dict):
    """``(cfg, mix)`` cut for a run on the CPU (copies)."""
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg.update(items=4096, groups=16, dim=16)
    mix.update(preload_items=1024, rate_per_s=40, warm_s=0.3,
               replay={"ticks": 3, "writes_per_tick": 2})
    return cfg, mix


def alter(table: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """The served table with one answer altered: the lowest group's mean
    moved in its first feature."""
    table = dict(table)
    g = min(table)
    table[g] = np.array(table[g], np.float64, copy=True)
    table[g][0] += 0.5
    return table


def _embed(v):
    """``[C, 1 + dim]`` rows: the group kept, each feature through tanh."""
    return torch.cat([v[:, :1], torch.tanh(v[:, 1:])], dim=-1)


class Deployment:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.N, self.G = int(cfg["items"]), int(cfg["groups"])
        self.dim = int(cfg["dim"])
        self.preload = int(mix["preload_items"])

    def _plan(self, writes: List[Write], taken: dict) -> List[dict]:
        """Ids and groups of each write's items, in order."""
        live, fresh, r = taken["live"], taken["fresh"], taken["rng"]
        out = []
        for w in writes:
            n_ins, n_mov = w.ops.get("insert", 0), w.ops.get("move", 0)
            n_del = w.ops.get("delete", 0)
            if n_mov + n_del > len(live) or n_ins > len(fresh):
                raise TrafficRefused(
                    f"the run needs more ids than the key space of "
                    f"{self.N} holds; shorten --seconds")
            pick = r.permutation(len(live))[:n_mov + n_del]
            touched = [live[j] for j in pick]
            for j in sorted(pick, reverse=True):
                live[j] = live[-1]
                live.pop()
            mov, dele = touched[:n_mov], touched[n_mov:]
            ins = [fresh.popleft() for _ in range(n_ins)]
            live.extend(mov + ins)
            out.append({"insert": np.asarray(ins, np.int64),
                        "move": np.asarray(mov, np.int64),
                        "delete": np.asarray(dele, np.int64),
                        "to": r.integers(0, self.G, n_mov + n_ins)})
        return out

    def _batches(self, plan: List[dict]):
        """Host batches of the planned writes, and the reference's record
        of each: ids set to a group and vector, ids dropped."""
        batches, log = [], []
        for p in plan:
            ins, mov, dele = p["insert"], p["move"], p["delete"]
            to_mov, to_ins = p["to"][:len(mov)], p["to"][len(mov):]
            self.vec[ins] = self._new[:len(ins)]
            self._new = self._new[len(ins):]
            ret = np.concatenate([mov, dele])
            new_ids = np.concatenate([mov, ins])
            new_grp = np.concatenate([to_mov, to_ins])
            old = self._rows(ret, self.grp[ret])
            self.grp[new_ids] = new_grp
            self.grp[dele] = -1
            new = self._rows(new_ids, new_grp)
            batches.append(DeltaBatch(
                np.concatenate([ret, new_ids]), np.concatenate([old, new]),
                np.concatenate([-np.ones(len(ret), np.int64),
                                np.ones(len(new_ids), np.int64)])))
            log.append((new_ids, new_grp, self.vec[new_ids].copy(), dele))
        return batches, log

    def _rows(self, ids, groups) -> np.ndarray:
        return np.concatenate([np.asarray(groups, np.float32)[:, None],
                               self.vec[ids]], axis=1)

    def make_data(self, warm: List[Write], window: List[Write]) -> None:
        """The run's data from the seed, before any of the program: the
        preload, each write's ids, groups and vectors, and host batches."""
        taken = {"live": list(range(self.preload)),
                 "fresh": deque(range(self.preload, self.N)),
                 "rng": datagen.rng(self.seed, 21)}
        plans = self._plan(warm, taken), self._plan(window, taken)
        n_ins = sum(len(p["insert"]) for ps in plans for p in ps)
        vecs = torch.randn(
            (self.preload + n_ins, self.dim), generator=datagen.generator(
                self.seed, 22, device=self.device),
            device=self.device).cpu().numpy()
        self.vec = np.zeros((self.N, self.dim), np.float32)
        self.vec[:self.preload] = vecs[:self.preload]
        self._new = vecs[self.preload:]
        self.grp = np.full(self.N, -1, np.int64)
        self.grp[:self.preload] = datagen.rng(self.seed, 23).integers(
            0, self.G, self.preload)
        ids = np.arange(self.preload, dtype=np.int64)
        self.preload_batch = DeltaBatch(ids, self._rows(ids, self.grp[ids]),
                                        np.ones(self.preload, np.int64))
        self._preload_log = (ids, self.grp[ids].copy(),
                             self.vec[ids].copy(), ids[:0])
        self.warm_batches, warm_log = self._batches(plans[0])
        self.window_batches, win_log = self._batches(plans[1])
        self._log = {"warm": warm_log, "window": win_log}
        self.info = {ph: [{"items": len(p["insert"]) + len(p["move"])
                           + len(p["delete"]),
                           "rows": len(p["insert"]) + 2 * len(p["move"])
                           + len(p["delete"])} for p in plan]
                     for ph, plan in zip(("warm", "window"), plans)}

    def setup(self, warm: List[Write], window: List[Write]) -> None:
        """Make the data, build the system, and load the preload through
        the frontend."""
        self.make_data(warm, window)
        g = FlowGraph("vec_groups")
        self.src = g.source("items", Spec((1 + self.dim,), np.float32,
                                          key_space=self.N))
        emb = g.map(self.src, _embed, vectorized=True,
                    spec=Spec((1 + self.dim,), np.float32,
                              key_space=self.N), name="embed")
        by = g.group_by(emb, key_fn=lambda k, v: v[0],
                        value_fn=lambda k, v: v[1:],
                        spec=Spec((self.dim,), np.float32,
                                  key_space=self.G), name="by_group")
        self.means = g.reduce(by, "mean", name="means")
        self.sched = DirtyScheduler(g, get_executor("cuda",
                                                    device=self.device))
        f = self.cfg["frontend"]
        self.fe = IngestFrontend(
            self.sched, policy=f["policy"], queue_batches=f["queue_batches"],
            max_bytes=f["max_bytes"], window=CoalesceWindow(
                max_rows=f["max_rows"], max_ticks=f["max_ticks"],
                max_latency_s=f["max_latency_s"]))
        t = self.fe.submit(self.src, self.preload_batch)
        self.fe.flush()
        if not t.result(timeout=600).applied:
            raise RuntimeError(f"set-up write {t.batch_id} not applied")

    def batch(self, phase: str, i: int) -> DeltaBatch:
        return (self.warm_batches if phase == "warm"
                else self.window_batches)[i]

    @property
    def source(self):
        """The source node the writes go to."""
        return self.src

    def submit(self, phase: str, i: int, batch_id: str):
        return self.fe.submit(self.source, self.batch(phase, i),
                              batch_id=batch_id)

    def output(self) -> Dict[int, np.ndarray]:
        return self.sched.read_table(self.means)

    def inputs(self, n_warm: int, n_window: int) -> dict:
        """What the reference rebuilds the items from: the preload, then
        the writes sent, in order."""
        return {"writes": [self._preload_log] + self._log["warm"][:n_warm]
                + self._log["window"][:n_window]}

    def close(self) -> None:
        self.fe.close()
        del self.fe, self.sched
        self.warm_batches = self.window_batches = None
