"""Tiny sizes of the cells, for runs on the CPU with the port's plain
kernels (the widths are cut here only; the chip runs the files as they
are)."""

from __future__ import annotations

import copy
from pathlib import Path

import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parent.parent
SEED = (1 << 40) + 7
SECONDS = 1.5


def bench() -> dict:
    """``BENCHMARK.json`` with the cells held out of it for a fault of the
    program (``held_out.json``) added back: the tests run both."""
    b = harness.load_json(ROOT.parent / "BENCHMARK.json")
    held = harness.load_json(ROOT / "held_out.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        b[key] = b[key] + held[key]
    return b


def tiny(b: dict, name: str, root: Path = ROOT):
    """``(cfg, mix)`` of cell ``name`` cut to a size the CPU runs in a
    second or two."""
    c = harness.cell(b, name, root)
    cfg, mix = copy.deepcopy(c.cfg), copy.deepcopy(c.mix)
    if "doc_key_space" in cfg:
        cfg.update(doc_key_space=4096, dim=16, k=4, queries=8,
                   scan_chunk=512)
        # a tick merges at most this many rows: ids touched are held back
        # that long, which the tiny key space must afford
        cfg["frontend"]["max_rows"] = 256
        mix.update(preload_docs=1024,
                   rate_per_s=40, warm_s=0.3,
                   replay={"ticks": 3, "writes_per_tick": 2})
    else:
        cfg.update(nodes=2000, edges=20000)
        mix.update(size={"min": 200, "max": 200}, warm_writes=3,
                   max_rate_per_s=100,
                   replay={"ticks": 3, "writes_per_tick": 1})
    return cfg, mix


def run(b: dict, name: str, trace: bool = False, root: Path = ROOT, **kw):
    torch.set_num_threads(1)
    cfg, mix = tiny(b, name, root)
    return harness.run_cell(b, name, kw.pop("seed", SEED),
                            kw.pop("seconds", SECONDS), trace, device="cpu",
                            root=root, cfg=cfg, mix=mix, **kw)
