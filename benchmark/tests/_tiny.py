"""Tiny sizes of the cells, for runs on the CPU with the port's plain
kernels: each configuration module's ``tiny`` cuts its cells (the widths
are cut there only; the chip runs the files as they are)."""

from __future__ import annotations

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


def config_fn(b: dict, name: str, fn: str, root: Path = ROOT):
    """Function ``fn`` of the configuration module of cell ``name``: each
    configuration brings its own ``tiny`` (its CPU cut) and ``alter`` (its
    planted fault), and no configuration falls back to another's."""
    c = harness.cell(b, name, root)
    path = c.config_dir / f"{c.config}.py"
    f = getattr(harness.load_module(path), fn, None)
    if not callable(f):
        raise AttributeError(f"{path} defines no function {fn}(): every "
                             f"configuration module brings tiny(cfg, mix) "
                             f"and alter(output)")
    return f


def tiny(b: dict, name: str, root: Path = ROOT):
    """``(cfg, mix)`` of cell ``name`` cut to a size the CPU runs in a
    second or two, by its configuration's ``tiny``."""
    c = harness.cell(b, name, root)
    return config_fn(b, name, "tiny", root)(c.cfg, c.mix)


def altered(b: dict, name: str, root: Path = ROOT):
    """A run's hook that hands the reference the output with one answer
    altered where it is produced, by the configuration's ``alter``."""
    alter = config_fn(b, name, "alter", root)

    def hook(dep, phase, out):
        return alter(out) if phase == "output" else out
    return hook


def run(b: dict, name: str, trace: bool = False, root: Path = ROOT, **kw):
    torch.set_num_threads(1)
    cfg, mix = tiny(b, name, root)
    return harness.run_cell(b, name, kw.pop("seed", SEED),
                            kw.pop("seconds", SECONDS), trace, device="cpu",
                            root=root, cfg=cfg, mix=mix, **kw)
