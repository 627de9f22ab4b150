"""Benchmark config 5: image-embed ETL — ViT feature extraction feeding
an incremental groupby-agg.

The counterpart of ``reflow_tpu/workloads/image_embed.py``. The graph
is::

    images  source {image_id: uint8 [group_byte, *raw_pixels]}
    embed   Map(vit_forward, params=weights)  -> f32 [group_id, *features]
    by_grp  GroupBy(key=group, value=features)
    cent    Reduce('mean')              {group: centroid}

The weights ride as the Map's ``params`` (op state on the ``cuda``
executor, swapped by ``update_params`` with no rebind); only the
shape-driving config is closed over. An image moving between groups (or
being deleted) is an ordinary retract/insert delta pair; the mean's
retract-old/insert-new emission keeps every centroid exact, not
approximate.

On the sharded executor the Map is data-parallel inference: each shard
runs the whole ViT on its row slice. With ``model_axis`` it is tensor
parallel as well (``models.vit.vit_forward_tp``): run it on
``ShardedCudaExecutor(make_model_mesh(d, m), model_axis="model")``; each
shard then holds 1/m of every sharded weight, and a forward costs two
psums over the model axis a block.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from reflow_tpu_torch.delta import DeltaBatch, Spec
from reflow_tpu_torch.graph import FlowGraph, Node
from reflow_tpu_torch.models.vit import (vit_forward, vit_forward_tp,
                                         vit_param_specs)
from reflow_tpu_torch.utils.tree import tree_map

__all__ = ["ImageEmbedGraph", "ImageStream", "build_graph",
           "pixels_to_input"]


@dataclasses.dataclass
class ImageEmbedGraph:
    graph: FlowGraph
    images: Node     # source
    embed: Node      # the params-bearing Map (``update_params`` target)
    centroids: Node  # read_table -> {group: mean feature vector}


def pixels_to_input(px):
    """uint8 pixels -> the model's [-1, 1] float input, the same float32
    ops on numpy arrays and torch tensors (the device Map and the host
    oracle compare the same forward pass)."""
    if isinstance(px, torch.Tensor):
        return px.to(torch.float32) * float(np.float32(2.0 / 255.0)) - 1.0
    return px.astype("float32") * np.float32(2.0 / 255.0) - np.float32(1.0)


def build_graph(n_images: int, n_groups: int, params: Dict,
                model_axis: Optional[str] = None) -> ImageEmbedGraph:
    """The config-5 graph over ``n_images`` image ids and ``n_groups``
    groups, the ViT weights ``params`` (``init_vit``'s tree, ``_cfg``
    included) as the embed Map's params. ``model_axis``: shard the ViT
    tensor-parallel over that mesh axis (``vit_param_specs``); the graph
    then runs only on ``ShardedCudaExecutor(mesh, model_axis=...)``."""
    cfg = params["_cfg"]
    flat = cfg["img"] * cfg["img"] * cfg["chans"]
    dim = cfg["dim"]
    f32 = np.float32
    if n_groups > 256:
        raise ValueError("group id rides in the row's leading uint8 byte; "
                         "n_groups must be <= 256 (ids 0-255)")
    g = FlowGraph("image_embed")
    # rows ship as raw uint8 [group_byte | pixels]: what a real ETL
    # ingests, and 4x less host->device traffic than float32 pixels
    src = g.source("images", Spec((1 + flat,), np.uint8, key_space=n_images))
    weights = {k: v for k, v in params.items() if k != "_cfg"}
    param_specs = None
    if model_axis is not None:
        param_specs = vit_param_specs(cfg, model_axis)

        def embed(p, v):  # (this shard's weights, [C, 1+flat] u8)
            feats = yield from vit_forward_tp(
                {**p, "_cfg": cfg}, pixels_to_input(v[:, 1:]),
                axis=model_axis)
            return torch.cat([v[:, :1].to(torch.float32), feats], dim=-1)
    else:
        def embed(p, v):  # (weights, [C, 1+flat] u8) -> [C, 1+dim] f32
            # the cuda executor passes device tensors; the CpuExecutor
            # numpy rows, computed where the weights lie and handed back
            # as numpy
            host = not isinstance(v, torch.Tensor)
            x = torch.as_tensor(np.asarray(v) if host else v).to(
                p["proj_w"].device)
            feats = vit_forward({**p, "_cfg": cfg},
                                pixels_to_input(x[:, 1:]))
            out = torch.cat([x[:, :1].to(torch.float32), feats], dim=-1)
            return out.cpu().numpy() if host else out

    emb = g.map(src, embed, vectorized=True, params=weights,
                param_specs=param_specs,
                spec=Spec((1 + dim,), f32, key_space=n_images), name="embed")
    by_grp = g.group_by(emb, key_fn=lambda k, v: v[0],
                        value_fn=lambda k, v: v[1:],
                        spec=Spec((dim,), f32, key_space=n_groups),
                        name="by_group")
    cent = g.reduce(by_grp, "mean", name="centroids")
    return ImageEmbedGraph(g, src, emb, cent)


# -- host boundary: the image stream ---------------------------------------

class ImageStream:
    """Host mirror: images with group assignments, delta generation. The
    same ``default_rng(seed)`` draws as the JAX package's, so both
    packages see the same pixels."""

    def __init__(self, params: Dict, seed: int = 0):
        self.cfg = params["_cfg"]
        self.params = params
        self.rng = np.random.default_rng(seed)
        self.images: Dict[int, np.ndarray] = {}   # id -> flat pixels
        self.groups: Dict[int, int] = {}          # id -> group

    def _flat(self) -> int:
        return self.cfg["img"] * self.cfg["img"] * self.cfg["chans"]

    def _row(self, i: int) -> np.ndarray:
        return np.concatenate(
            [[np.uint8(self.groups[i])], self.images[i]]).astype(np.uint8)

    def insert(self, ids, groups) -> DeltaBatch:
        rows = []
        for i, grp in zip(ids, groups):
            self.images[int(i)] = self.rng.integers(
                0, 256, size=self._flat(), dtype=np.uint8)
            self.groups[int(i)] = int(grp)
            rows.append(self._row(int(i)))
        return DeltaBatch(np.asarray(ids, np.int64), np.stack(rows),
                          np.ones(len(rows), np.int64))

    def move(self, i: int, new_group: int) -> DeltaBatch:
        """Reassign an image's group: retract old row, insert new."""
        old = self._row(i)
        self.groups[i] = int(new_group)
        new = self._row(i)
        return DeltaBatch(np.array([i, i], np.int64), np.stack([old, new]),
                          np.array([-1, 1], np.int64))

    def delete(self, i: int) -> DeltaBatch:
        row = self._row(i)
        del self.images[i], self.groups[i]
        return DeltaBatch(np.array([i], np.int64), row[None],
                          -np.ones(1, np.int64))

    def reference_centroids(self) -> Dict[int, np.ndarray]:
        """Oracle: the port's forward pass on the CPU (its plain products),
        float64 group means."""
        if not self.images:
            return {}
        ids = sorted(self.images)
        cpu = tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor)
                       else t, self.params)
        px = torch.from_numpy(np.stack([self.images[i] for i in ids]))
        feats = vit_forward(cpu, pixels_to_input(px)).numpy()
        out: Dict[int, list] = {}
        for i, f in zip(ids, feats):
            out.setdefault(self.groups[i], []).append(f.astype(np.float64))
        return {g: np.mean(v, axis=0) for g, v in out.items()}
