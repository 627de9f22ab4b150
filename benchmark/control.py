"""The control of a cell's comparison: the plain reference computed in
the precision below the configuration's, put in the program's place and
judged as the program's output is. A comparison that this control does
not fail could not tell a program that cut its precision from a sound
one. Run on a card at the cell's own size::

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 \\
        [--seconds 20] [--writes N]

``--writes`` caps the window's writes (a closed loop sends as many as its
ticks allow: give the count a run makes). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent


def readings(bench: dict, name: str, seed: int, seconds: float, device,
             *, cfg: Optional[dict] = None, mix: Optional[dict] = None,
             writes: Optional[int] = None) -> dict:
    """The cell's compared numbers for the control on one seed's inputs
    (the run's warm-up and window writes, all applied)."""
    import torch

    from benchmark import generator, harness

    c = harness.cell(bench, name)
    cfg = c.cfg if cfg is None else cfg
    mix = c.mix if mix is None else mix
    warm, window = generator.schedule(mix, seed, seconds)
    if writes is not None:
        window = window[:writes]
    dep = harness.load_module(c.config_dir / f"{c.config}.py").Deployment(
        cfg, mix, seed, device)
    dep.make_data(warm, window)
    ref = harness.load_module(HERE / "reference" / f"{c.config}.py")
    inputs = dep.inputs(len(warm), len(window))
    dev = torch.device(device)
    return ref.judge(cfg, inputs, ref.control(cfg, inputs, dev), dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--writes", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if str(HERE.parent) not in sys.path:
        sys.path.insert(0, str(HERE.parent))
    from benchmark import harness

    bench = harness.load_json(HERE.parent / "BENCHMARK.json")
    seconds = (args.seconds if args.seconds is not None
               else float(bench["run_seconds"]))
    limits = harness.cell(bench, args.workload).cfg["checks"]
    for seed in args.seeds:
        got = readings(bench, args.workload, seed, seconds, args.device,
                       writes=args.writes)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got, "limits": limits,
                          "fails": sorted(k for k in limits
                                          if got[k] > limits[k])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
