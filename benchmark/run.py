"""One run of one cell of ``BENCHMARK.json``, from the root of a checkout::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the reference compared,
beside its limit); the line before it holds the run's counts. The
checked numbers are also the last lines of standard error. A run on a
machine without the cards the cell asks for, or whose process has
loaded JAX or the JAX package, exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names a run must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "reflow_tpu")
#: a run keeps to the last this many CPUs the machine gives it, the same
#: ones in every run (``harness.pin_pump`` splits them among the threads)
CPUS = 4


def _pin_cpus() -> None:
    cpus = sorted(os.sched_getaffinity(0))
    if CPUS and len(cpus) > CPUS:
        os.sched_setaffinity(0, cpus[-CPUS:])


def _environment(trace: bool) -> None:
    """Caches at fixed paths inside the checkout, the program's knobs at
    their defaults (tracing on only for a traced run, every ticket
    sampled), one host thread a pool, and no JAX pulled in by a
    library."""
    cache = HERE / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    for k in [k for k in os.environ if k.startswith("REFLOW_")]:
        del os.environ[k]
    os.environ["USE_FLAX"] = "0"
    # one intra-op thread for the program's host-side torch and numpy
    # work: the pump, the sender and the watcher are the process's
    # threads, and a pool of one thread a core beside them makes the
    # host's times swing from run to run
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if trace:
        os.environ.update(REFLOW_TRACE="1", REFLOW_TRACE_SAMPLE="1",
                          REFLOW_TRACE_RING=str(1 << 20))


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_cpus()
    _environment(bool(args.trace))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    try:
        cell = harness.cell(bench, args.workload)
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            raise harness.Refused(
                f"{args.workload} needs {cell.chips} CUDA card(s); "
                f"this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        power = harness.power_limit()
        result = harness.run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  device="cuda", t_start=T_START,
                                  pin=bool(CPUS))
    except harness.Refused as e:
        _err(f"[bench] refused: {e}")
        return 2
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        _err(f"[bench] the run loaded {', '.join(found)}: no result")
        return 3
    run = result.pop("run")
    run["card"] = power
    writes = run.pop("writes")
    runs = HERE / ".cache" / "runs"
    runs.mkdir(parents=True, exist_ok=True)
    with open(runs / f"{args.workload}-{args.seed}-{args.trace}.json",
              "w") as f:
        json.dump({"run": run, "result": result, "writes": writes}, f)
    print(json.dumps({"run": run}), flush=True)
    _err(f"[bench] {args.workload} seed {args.seed}: card {power}; "
         f"{run['writes_due']} writes due, {run['writes_applied']} applied, "
         f"{run['freshness_samples']} freshness samples, lateness p50 "
         f"{run['lateness_ms_p50']} ms, max {run['lateness_ms_max']} ms")
    for k, v in result["checks"].items():
        _err(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
