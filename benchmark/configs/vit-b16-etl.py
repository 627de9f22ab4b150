"""Configuration ``vit-b16-etl``: config 5's image-embed ETL, ViT-B/16 at
its published widths feeding an incremental mean per group, served
through ``IngestFrontend``.

The graph is the port's own (``workloads/image_embed.build_graph``):
source ``{image_id: uint8 [group, *pixels]}`` → ``Map(vit_forward,
params=weights)`` → GroupBy (group) → Reduce ``mean``, on the ``cuda``
executor. The weights are the benchmark's own draw from the seed
(:func:`weights`, on the card; the program's ``init_vit`` is not used), and
the reference takes a host copy of them made before the program is built;
the pixels of every image a run makes are drawn on the card in one call
and copied to the host once, and the writes reach the program as host
batches at send time. Item operations of a mix:

- ``insert``: a new image under a free id, in a random group;
- ``move``: a live image to another group (its old row retracted and
  the new one inserted, the same pixels: two delta rows);
- ``delete``: a live image's row retracted.

The mix's ``ids`` is ``"random"``: moves and deletes draw their ids from
the live ones, inserts from the free ones. An id a write touched goes
back to its pool only once the frontend's ``max_rows`` rows have been
written after it: the coalescer merges at most that many rows into one
tick, so no two writes on one id share a tick (the port folds such a
pair wrongly; PERF.md, Open questions). A write's ``rows`` are its delta
rows, 1 per insert and per delete and 2 per move. A schedule that would
run out of ids is refused.

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

from reflow_tpu_torch import DirtyScheduler, get_executor
from reflow_tpu_torch.delta import DeltaBatch
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.models import VIT_TINY
from reflow_tpu_torch.serve import CoalesceWindow, IngestFrontend
from reflow_tpu_torch.workloads import image_embed

#: the model's widths, keys of the configuration and of the weights' ``_cfg``
WIDTHS = ("img", "chans", "patch", "dim", "depth", "heads", "mlp_dim")


class TrafficRefused(ValueError):
    """The schedule needs more ids than the id space has."""


def tiny(cfg: dict, mix: dict):
    """``(cfg, mix)`` cut for a run on the CPU with the port's plain
    products (copies): ``VIT_TINY`` widths, a hundred-odd ids, writes of
    four images, and the limits of ``mean_gap`` and ``stated_gap`` at
    those widths."""
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg.update(VIT_TINY, images=128, groups=8, preload_images=32,
               preload_chunk=16)
    # a tick merges at most this many rows: ids touched are held back
    # that long, which the tiny id space must afford
    cfg["frontend"]["max_rows"] = 16
    # at VIT_TINY widths a group averages about ten images, not 230, and
    # the bf16 operands' error averages out less: sound runs read up to
    # 3.8e-3 there and the control 2.4e-2 to 5.6e-2 (CPU, eight seeds)
    cfg["checks"]["mean_gap"] = 1e-2
    # against the stated precision a sound run differs by a rounding flip
    # at most: 5.4e-8 to 1.9e-4 over sixteen seeds, the attention's
    # products in bf16 1.1e-3 to 1.9e-3 (CPU)
    cfg["checks"]["stated_gap"] = 5e-4
    mix.update(size={"min": 4, "max": 4}, rate_per_s=10, warm_s=0.3,
               replay={"ticks": 3, "writes_per_tick": 1})
    return cfg, mix


def alter(table: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """The served table with one answer altered: the lowest group's mean
    moved in its first feature by half its norm."""
    table = dict(table)
    g = min(table)
    table[g] = np.array(table[g], np.float64, copy=True)
    table[g][0] += 0.5 * np.linalg.norm(table[g])
    return table


def weights(cfg: dict, seed: int, device) -> dict:
    """The ViT's weights from the seed, drawn on ``device`` in one stream
    of the benchmark's own: the tree ``image_embed.build_graph`` takes
    (float32; normal(0, fan_in^-0.5) projections, normal(0, 0.02)
    positions, zero biases, unit LayerNorm gains; ``_cfg`` the widths)."""
    w = {k: int(cfg[k]) for k in WIDTHS}
    dim, mlp = w["dim"], w["mlp_dim"]
    pdim = w["patch"] ** 2 * w["chans"]
    g = datagen.generator(seed, 40, device=device)

    def normal(std, *shape):
        return torch.randn(shape, generator=g, device=device) * std

    def dense(n_in, n_out):
        return normal(n_in ** -0.5, n_in, n_out)

    def ln():
        return {"g": torch.ones(dim, device=device),
                "b": torch.zeros(dim, device=device)}

    return {
        "proj_w": dense(pdim, dim), "proj_b": torch.zeros(dim, device=device),
        "pos": normal(0.02, (w["img"] // w["patch"]) ** 2, dim),
        "ln_f": ln(),
        "blocks": [{"ln1": ln(), "ln2": ln(),
                    "wq": dense(dim, dim), "wk": dense(dim, dim),
                    "wv": dense(dim, dim), "wo": dense(dim, dim),
                    "w1": dense(dim, mlp),
                    "b1": torch.zeros(mlp, device=device),
                    "w2": dense(mlp, dim),
                    "b2": torch.zeros(dim, device=device)}
                   for _ in range(w["depth"])],
        "_cfg": w}


def _host_copy(t):
    """A copy of a tree of tensors on the host, sharing no storage."""
    if isinstance(t, dict):
        return {k: _host_copy(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_host_copy(v) for v in t]
    return t.detach().to("cpu", copy=True)


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
        self.N, self.G = int(cfg["images"]), int(cfg["groups"])
        self.preload = int(cfg["preload_images"])
        self.flat = int(cfg["img"]) ** 2 * int(cfg["chans"])

    # -- ids, groups and pixels ------------------------------------------

    def _writes(self, writes: List[Write], s: dict):
        """Host batches of the writes, in order, from the state ``s``
        (pools, each id's group and image) shared across the warm-up and
        the window; returns (batches, the reference's log, records)."""
        live, free, r = s["live"], s["free"], s["rng"]
        held, span = s["held"], int(self.cfg["frontend"]["max_rows"])
        grp, img = s["grp"], s["img"]
        batches, log, info = [], [], []
        for w in writes:
            n_ins, n_mov = w.ops.get("insert", 0), w.ops.get("move", 0)
            n_del = w.ops.get("delete", 0)
            # ids held back long enough go back to their pools
            while held and s["rows"] - held[0][0] >= span:
                _, to_live, to_free = held.popleft()
                live.extend(to_live)
                free.extend(to_free)
            if n_mov + n_del > len(live) or n_ins > len(free):
                raise TrafficRefused(
                    f"the run needs more ids than the id space of "
                    f"{self.N} holds; shorten --seconds")
            touch = np.asarray(_draw(live, n_mov + n_del, r), np.int64)
            ins = np.asarray(_draw(free, n_ins, r), np.int64)
            mov, dele = touch[:n_mov], touch[n_mov:]
            held.append((s["rows"], mov.tolist() + ins.tolist(),
                         dele.tolist()))
            old = (grp[touch].copy(), img[touch].copy())
            # a move goes to another group; an insert to any, with a new
            # image
            grp[mov] = (grp[mov] + 1 + r.integers(0, self.G - 1, n_mov)) \
                % self.G
            grp[ins] = r.integers(0, self.G, n_ins)
            img[ins] = np.arange(s["next_img"], s["next_img"] + n_ins)
            s["next_img"] += n_ins
            grp[dele] = img[dele] = -1
            new = np.concatenate([mov, ins])
            keys = np.concatenate([touch, new])
            rows = self._rows(np.concatenate([old[0], grp[new]]),
                              np.concatenate([old[1], img[new]]))
            batches.append(DeltaBatch(keys, rows, np.concatenate(
                [-np.ones(len(touch), np.int64),
                 np.ones(len(new), np.int64)])))
            log.append((new, grp[new].copy(), img[new].copy(), dele))
            n_rows = n_ins + 2 * n_mov + n_del
            s["rows"] += n_rows
            info.append({"items": n_ins + n_mov + n_del, "rows": n_rows,
                         "insert": n_ins, "move": n_mov, "delete": n_del})
        return batches, log, info

    def _rows(self, groups, images) -> np.ndarray:
        """``[n, 1 + flat]`` uint8 rows: the group byte, then the pixels."""
        out = np.empty((len(groups), 1 + self.flat), np.uint8)
        out[:, 0] = groups
        out[:, 1:] = self.pixels[images]
        return out

    # -- the harness's interface ------------------------------------------

    def make_data(self, warm: List[Write], window: List[Write]) -> None:
        """The run's data from the seed, before the system is built: the
        weights (:func:`weights`, on the device, and the reference's host
        copy of them), the pixels of
        every image (the preload's and each insert's), the preload's
        groups, each write's ids and host batch. Refuses a schedule that
        runs out of ids."""
        if self.mix["ids"] != "random":
            raise ValueError(f"ids {self.mix['ids']!r}: this configuration "
                             f"draws its ids at random")
        dev, P = self.device, self.preload
        self.weights = weights(self.cfg, self.seed, dev)
        self.ref_weights = _host_copy(
            {k: v for k, v in self.weights.items() if k != "_cfg"})
        n_img = P + sum(w.ops.get("insert", 0) for w in warm + window)
        px = torch.randint(0, 256, (n_img, self.flat), dtype=torch.uint8,
                           generator=datagen.generator(self.seed, 43,
                                                       device=dev),
                           device=dev)
        self.pixels = px.cpu().numpy()
        grp = np.full(self.N, -1, np.int64)
        img = np.full(self.N, -1, np.int64)
        grp[:P] = datagen.rng(self.seed, 42).integers(0, self.G, P)
        img[:P] = np.arange(P)
        # a copy: the writes below change ``grp`` in place
        self.preload_groups = torch.tensor(grp[:P], device=dev)
        self._preload_px = px[:P]
        ids = np.arange(P, dtype=np.int64)
        self._preload_log = (ids, grp[:P].copy(), img[:P].copy(), ids[:0])
        s = {"live": list(range(P)), "free": list(range(P, self.N)),
             "rng": datagen.rng(self.seed, 41), "held": deque(), "rows": 0,
             "grp": grp, "img": img, "next_img": P}
        self.warm_batches, warm_log, warm_info = self._writes(warm, s)
        self.window_batches, win_log, win_info = self._writes(window, s)
        self._log = {"warm": warm_log, "window": win_log}
        self.info = {"warm": warm_info, "window": win_info}

    def setup(self, warm: List[Write], window: List[Write]) -> None:
        """Make the data, build the system, and load the preload through
        the frontend as device batches."""
        self.make_data(warm, window)
        cfg, dev = self.cfg, self.device
        self.ig = image_embed.build_graph(self.N, self.G, self.weights)
        self.sched = DirtyScheduler(self.ig.graph,
                                    get_executor("cuda", device=dev))
        f = cfg["frontend"]
        self.fe = IngestFrontend(
            self.sched, policy=f["policy"], queue_batches=f["queue_batches"],
            max_bytes=f["max_bytes"], window=CoalesceWindow(
                max_rows=f["max_rows"], max_ticks=f["max_ticks"],
                max_latency_s=f["max_latency_s"]))
        tickets = []
        chunk = int(cfg["preload_chunk"])
        for c in range(0, self.preload, chunk):
            n = min(chunk, self.preload - c)
            rows = torch.cat([self.preload_groups[c:c + n, None].to(
                torch.uint8), self._preload_px[c:c + n]], dim=1)
            tickets.append(self.fe.submit(self.ig.images, DeviceDelta(
                torch.arange(c, c + n, device=dev, dtype=torch.int32), rows,
                torch.ones(n, dtype=torch.int32, device=dev))))
            self.fe.flush()
        for t in tickets:
            if not t.result(timeout=600).applied:
                raise RuntimeError(f"set-up write {t.batch_id} not applied")
        del self._preload_px, self.preload_groups

    def batch(self, phase: str, i: int) -> DeltaBatch:
        return (self.warm_batches if phase == "warm"
                else self.window_batches)[i]

    @property
    def source(self):
        """The source node the writes go to."""
        return self.ig.images

    def submit(self, phase: str, i: int, batch_id: str):
        return self.fe.submit(self.source, self.batch(phase, i),
                              batch_id=batch_id)

    def output(self) -> Dict[int, np.ndarray]:
        return self.sched.read_table(self.ig.centroids)

    def inputs(self, n_warm: int, n_window: int) -> dict:
        """What the reference rebuilds the live images from: the host copy
        of the weights made before the program was built, the pixels, the
        preload, then the writes sent, in order."""
        return {"weights": self.ref_weights,
                "pixels": self.pixels,
                "writes": [self._preload_log] + self._log["warm"][:n_warm]
                + self._log["window"][:n_window]}

    def close(self) -> None:
        self.fe.close()
        del self.fe, self.sched, self.ig, self.weights
        self.warm_batches = self.window_batches = None
