"""Configuration ``knn-1m-768``: the port's k-NN index over a 2^20-id,
768-dimension int8 corpus, served through ``IngestFrontend``.

The corpus preload is made on the card from the seed, each write's
embeddings too (one call for the run), and handed to the program as
host batches at send time. Item operations of a mix:

- ``insert``: a new document under a free id;
- ``update``: a new embedding for a live id (retract + insert, one id);
- ``delete``: retract a live id.

The mix's ``ids`` picks the ids: ``"fresh"`` takes ids above the preload
in order, never one twice; ``"random"`` draws each id uniformly from its
pool, the live ids for updates and deletes and the free ids (those above
the preload, and the deleted ones) for inserts. An id a write touched
goes back to its pool only once the frontend's ``max_rows`` rows have
been written after it: the coalescer merges at most that many rows into
one tick, so no two writes on one id share a tick (the port folds such
a pair wrongly; PERF.md, Open questions). A schedule that would run out
of ids is refused.

``tiny`` and ``alter`` serve the CPU tests alone: the configuration's cut
to a size the CPU runs in a second or two, and its planted fault.
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
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.serve import CoalesceWindow, IngestFrontend
from reflow_tpu_torch.workloads import knn

#: the preload goes in as device batches of this many documents
PRELOAD_CHUNK = 1 << 16


class TrafficRefused(ValueError):
    """The schedule needs more ids than the key space has."""


def tiny(cfg: dict, mix: dict):
    """``(cfg, mix)`` cut for a run on the CPU with the port's plain
    kernels (copies; the widths are cut here only)."""
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg.update(doc_key_space=4096, dim=16, k=4, queries=8, scan_chunk=512)
    # a tick merges at most this many rows: ids touched are held back
    # that long, which the tiny key space must afford
    cfg["frontend"]["max_rows"] = 256
    mix.update(preload_docs=1024, rate_per_s=40, warm_s=0.3,
               replay={"ticks": 3, "writes_per_tick": 2})
    return cfg, mix


def alter(table: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """The served table with one answer altered: query 0's best document
    swapped for an id it does not hold."""
    table = dict(table)
    row = np.array(table[0], copy=True)
    row[0, 0] = row[-1, 0] + 1 if row[-1, 0] + 1 not in row[:, 0] else 0
    table[0] = row
    return table


def _draw(pool: list, n: int, r: np.random.Generator) -> list:
    """``n`` distinct ids drawn uniformly from ``pool`` and taken out of
    it (each swapped with the pool's last id and popped)."""
    out = []
    for j in r.integers(0, np.arange(len(pool), len(pool) - n, -1)):
        out.append(pool[j])
        pool[j] = pool[-1]
        pool.pop()
    return out


class Deployment:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.D, self.dim = int(cfg["doc_key_space"]), int(cfg["dim"])
        self.Q, self.k = int(cfg["queries"]), int(cfg["k"])
        self.preload = int(mix["preload_docs"])

    # -- ids and payloads ------------------------------------------------

    def _assign(self, writes: List[Write], taken: dict) -> List[dict]:
        """Ids for each write's items, in order, from the mix's policy.
        ``taken`` holds the pools across the warm-up and the window."""
        policy = self.mix["ids"]
        if policy not in ("fresh", "random"):
            raise ValueError(f"ids {policy!r} is neither fresh nor random")
        live, free, r = taken["live"], taken["free"], taken["rng"]
        held, span = taken["held"], int(self.cfg["frontend"]["max_rows"])
        out = []
        for w in writes:
            n_up, n_del = w.ops.get("update", 0), w.ops.get("delete", 0)
            n_ins = w.ops.get("insert", 0)
            if policy == "fresh" and (n_up or n_del):
                raise ValueError("ids 'fresh' takes inserts only")
            # ids held back long enough go back to their pools
            while held and taken["rows"] - held[0][0] >= span:
                _, to_live, to_free = held.popleft()
                live.extend(to_live)
                free.extend(to_free)
            if n_up + n_del > len(live) or n_ins > len(free):
                raise TrafficRefused(
                    f"the run needs more ids than the key space of "
                    f"{self.D} holds; shorten --seconds")
            if policy == "fresh":
                ins = [free.popleft() for _ in range(n_ins)]
                touch = []
            else:
                touch = _draw(live, n_up + n_del, r)
                ins = _draw(free, n_ins, r)
                held.append((taken["rows"], touch[:n_up] + ins,
                             touch[n_up:]))
            taken["rows"] += 2 * n_up + n_del + n_ins
            out.append({"update": np.asarray(touch[:n_up], np.int64),
                        "delete": np.asarray(touch[n_up:], np.int64),
                        "insert": np.asarray(ins, np.int64)})
        return out

    def _batches(self, plan: List[dict], vecs: np.ndarray, at: int):
        """Host batches of the planned writes, their new embeddings taken
        from ``vecs`` from row ``at`` on. Returns (batches, log, at)."""
        zeros = np.zeros((0, self.dim), np.int8)
        batches, log = [], []
        for p in plan:
            up, de, ins = p["update"], p["delete"], p["insert"]
            n_new = len(up) + len(ins)
            new = vecs[at:at + n_new]
            at += n_new
            ret = np.concatenate([up, de])
            keys = np.concatenate([ret, up, ins]).astype(np.int64)
            vals = np.concatenate([np.zeros((len(ret), self.dim), np.int8),
                                   new if n_new else zeros])
            wts = np.concatenate([-np.ones(len(ret), np.int64),
                                  np.ones(n_new, np.int64)])
            batches.append(DeltaBatch(keys, vals, wts))
            # the reference's record: ids set to a new vector, ids dropped
            log.append((np.concatenate([up, ins]).astype(np.int64), new,
                        de.astype(np.int64)))
        return batches, log, at

    # -- the harness's interface ------------------------------------------

    def make_data(self, warm: List[Write], window: List[Write]) -> None:
        """The run's data from the seed, before any of the program: ids,
        the queries, each write's embeddings and host batch. Refuses a
        schedule that runs out of ids."""
        dev = self.device
        if self.mix["ids"] == "fresh":
            taken = {"live": deque(), "free": deque(range(self.preload,
                                                          self.D))}
        else:
            taken = {"live": list(range(self.preload)),
                     "free": list(range(self.preload, self.D))}
        taken.update(rng=datagen.rng(self.seed, 11), held=deque(), rows=0)
        plans = self._assign(warm, taken), self._assign(window, taken)
        self.queries = torch.randn(
            (self.Q, self.dim), generator=datagen.generator(
                self.seed, 10, device=dev), device=dev).cpu().numpy()
        n_new = sum(len(p["update"]) + len(p["insert"])
                    for ps in plans for p in ps)
        vecs = datagen.embeddings_int8(
            n_new, self.dim, datagen.generator(self.seed, 12, device=dev),
            dev).cpu().numpy()
        self.warm_batches, warm_log, at = self._batches(plans[0], vecs, 0)
        self.window_batches, win_log, _ = self._batches(plans[1], vecs, at)
        self._log = {"warm": warm_log, "window": win_log}
        self.info = {"warm": self._info(plans[0], self.preload)}
        self.info["window"] = self._info(
            plans[1], self.info["warm"][-1]["live_after"]
            if warm else self.preload)

    def setup(self, warm: List[Write], window: List[Write]) -> None:
        """Make the data, build the system, and load the queries and the
        preload through the frontend."""
        self.make_data(warm, window)
        cfg, dev = self.cfg, self.device
        self.kg = knn.build_graph(
            self.Q, self.D, self.dim, self.k, scan_chunk=cfg["scan_chunk"],
            dtype=torch.bfloat16, doc_dtype=torch.int8, precision="default")
        self.sched = DirtyScheduler(self.kg.graph,
                                    get_executor("cuda", device=dev))
        f = cfg["frontend"]
        self.fe = IngestFrontend(
            self.sched, policy=f["policy"], queue_batches=f["queue_batches"],
            max_bytes=f["max_bytes"], window=CoalesceWindow(
                max_rows=f["max_rows"], max_ticks=f["max_ticks"],
                max_latency_s=f["max_latency_s"]))
        # the standing queries, then the preload, made on the card
        t = self.fe.submit(self.kg.queries, DeltaBatch(
            np.arange(self.Q, dtype=np.int64), self.queries))
        tickets = [t]
        for c in range(0, self.preload, PRELOAD_CHUNK):
            n = min(PRELOAD_CHUNK, self.preload - c)
            rows = self._preload_rows(c, n)
            tickets.append(self.fe.submit(self.kg.docs, DeviceDelta(
                torch.arange(c, c + n, device=dev, dtype=torch.int32), rows,
                torch.ones(n, dtype=torch.int32, device=dev))))
            self.fe.flush()
        for t in tickets:
            if not t.result(timeout=600).applied:
                raise RuntimeError(f"set-up write {t.batch_id} not applied")

    def _preload_rows(self, c: int, n: int) -> torch.Tensor:
        return datagen.embeddings_int8(
            n, self.dim, datagen.generator(self.seed, 13, c,
                                           device=self.device), self.device)

    @staticmethod
    def _info(plan: List[dict], live: int) -> List[dict]:
        out = []
        for p in plan:
            up, de, ins = len(p["update"]), len(p["delete"]), len(p["insert"])
            live += ins - de
            out.append({"items": up + de + ins, "rows": 2 * up + de + ins,
                        "update": up, "delete": de, "insert": ins,
                        "rescan": bool(up or de), "live_after": live})
        return out

    def batch(self, phase: str, i: int) -> DeltaBatch:
        return (self.warm_batches if phase == "warm"
                else self.window_batches)[i]

    @property
    def source(self):
        """The source node the writes go to."""
        return self.kg.docs

    def submit(self, phase: str, i: int, batch_id: str):
        return self.fe.submit(self.source, self.batch(phase, i),
                              batch_id=batch_id)

    def output(self) -> Dict[int, np.ndarray]:
        return self.sched.read_table(self.kg.index)

    def inputs(self, n_warm: int, n_window: int) -> dict:
        """What the reference rebuilds the corpus from: the queries, the
        preload's seed and size, and the writes sent, in order."""
        return {"queries": self.queries, "seed": self.seed,
                "preload": self.preload, "preload_chunk": PRELOAD_CHUNK,
                "writes": (self._log["warm"][:n_warm]
                           + self._log["window"][:n_window])}

    def close(self) -> None:
        self.fe.close()
        del self.fe, self.sched, self.kg
        self.warm_batches = self.window_batches = None
