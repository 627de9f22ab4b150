"""``python -m reflow_tpu_torch.proc`` — run one harness child role.

The process harness (``proc/harness.py``) spawns every child as this
module, so a "replica process" in a test is *exactly* what an operator
would start by hand::

    python -m reflow_tpu_torch.proc --role replica --name r0 \\
        --root /data/r0
    python -m reflow_tpu_torch.proc --role leader  --name leader \\
        --root /data/L
    python -m reflow_tpu_torch.proc --role producer --name p0 \\
        --index 0 --connect 127.0.0.1:45123

Protocol: JSON lines on stdout (first = ready line with the
OS-assigned addresses, last = exit status when ``--json``), JSON
commands on stdin (``{"cmd": "stop"}`` / ``attach`` / ``connect`` —
see ``proc/worker.py``).

The port's copy of ``reflow_tpu/proc/__main__.py``: the same argv.
"""

from __future__ import annotations

import argparse
import sys


def _addr(text: str):
    host, _, port = text.rpartition(":")
    return (host or "127.0.0.1", int(port))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m reflow_tpu_torch.proc",
        description="one multi-process deployment role "
                    "(docs/guide.md 'Multi-process deployment')")
    ap.add_argument("--role", required=True,
                    choices=("leader", "replica", "producer"))
    ap.add_argument("--name", required=True,
                    help="node name (fleet telemetry id, replica name, "
                         "producer batch-id prefix)")
    ap.add_argument("--root", default=None,
                    help="this node's state directory (WAL/mirror/ckpt; "
                         "leader and replica only)")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="ingest endpoint to submit to (producer only)")
    ap.add_argument("--telemetry", default=None, metavar="HOST:PORT",
                    help="TelemetryServer to ship fleet snapshots to")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for this node's listeners "
                         "(port 0: the OS assigns, the ready line "
                         "reports)")
    ap.add_argument("--workload", default="wordcount")
    ap.add_argument("--source", default=None,
                    help="source node to submit to (producer; default "
                         "the workload's)")
    ap.add_argument("--index", type=int, default=0,
                    help="producer index: seeds the deterministic "
                         "batch stream")
    ap.add_argument("--pace", type=float, default=0.0,
                    help="producer inter-batch sleep (s); paces a "
                         "many-process fleet on a small host")
    ap.add_argument("--fsync", default="tick",
                    help="leader WAL fsync policy (tick/record/...)")
    ap.add_argument("--epoch", type=int, default=0,
                    help="starting epoch (a promoted-elsewhere fleet "
                         "restarts above the fenced one)")
    ap.add_argument("--json", action="store_true",
                    help="print the exit-status JSON on clean shutdown")
    args = ap.parse_args(argv)

    if args.role in ("leader", "replica") and not args.root:
        ap.error(f"--role {args.role} requires --root")
    if args.role == "producer" and not args.connect:
        ap.error("--role producer requires --connect")

    from reflow_tpu_torch.proc import worker

    opts = {
        "name": args.name, "root": args.root, "host": args.host,
        "workload": args.workload, "index": args.index,
        "pace_s": args.pace,
        "fsync": args.fsync, "epoch": args.epoch,
        "telemetry": _addr(args.telemetry) if args.telemetry else None,
        "connect": _addr(args.connect) if args.connect else None,
    }
    if args.source:
        opts["source"] = args.source
    run = {"leader": worker.run_leader, "replica": worker.run_replica,
           "producer": worker.run_producer}[args.role]
    status = run(opts)
    if args.json:
        worker.emit(status)
    return 0 if status.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
