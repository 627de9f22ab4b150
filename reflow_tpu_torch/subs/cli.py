"""``python -m reflow_tpu_torch.subs`` — tail one standing query.

The operator-facing face of reactive reads (docs/guide.md "Reactive
reads"): dial a replica's subscription endpoint (the ``subs`` address
on its ready line / ``status``), register a standing query, and print
one line per applied commit window. Human mode renders the
reconstructed answer compactly; ``--json`` emits one
``reflow.sub/1`` document per update for scripting::

    python -m reflow_tpu_torch.subs --connect 127.0.0.1:45131 \\
        --sink out --kind topk --k 5
    python -m reflow_tpu_torch.subs --connect 127.0.0.1:45131 \\
        --sink out --kind lookup --key the,2 --json

Exit is clean on ``--rounds`` / ``--duration`` expiry or Ctrl-C; a
down link is survived silently (the subscriber resumes from its
cursor when the replica heals — gap-free, duplicate-free).

The port's copy of ``reflow_tpu/subs/cli.py`` (``python -m
reflow_tpu_torch.subs``), with the same flags and ``reflow.sub/1``
documents.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict

SUB_SCHEMA = "reflow.sub/1"

__all__ = ["SUB_SCHEMA", "main", "make_update", "render_update"]


def _addr(text: str):
    host, _, port = text.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _key(text: str):
    """Parse a ``--key`` operand. View keys are often ``(key, value)``
    pairs (the multiset the dataflow maintains), so a comma builds a
    tuple; numeric parts become floats (the dataflow's value type) —
    ``the,2`` means ``("the", 2.0)``."""
    parts = []
    for p in text.split(","):
        try:
            parts.append(float(p))
        except ValueError:
            parts.append(p)
    return tuple(parts) if len(parts) > 1 else parts[0]


def _json_rows(kind: str, value) -> Any:
    """The reconstructed answer in JSON-able shape: lookup is a bare
    number; view/topk are ``[key, weight]`` pairs (view sorted by key
    for stable diffs, topk in rank order; tuple keys become lists)."""
    if kind == "lookup":
        return value
    if kind == "view":
        items = sorted(value.items(), key=lambda it: str(it[0]))
    else:
        items = list(value)
    return [[list(kv) if isinstance(kv, tuple) else kv, w]
            for kv, w in items]


def make_update(sub, *, ts_wall: float) -> Dict[str, Any]:
    """One ``reflow.sub/1`` document from a live subscriber."""
    kind = sub.query.kind
    return {
        "schema": SUB_SCHEMA,
        "ts_wall": round(ts_wall, 3),
        "sink": sub.query.sink,
        "kind": kind,
        "params": list(sub.query.params),
        "horizon": sub.horizon,
        "rows": _json_rows(kind, sub.value()),
        "frames_applied": sub.frames_applied_total,
        "gaps": sub.gaps_total,
        "dups_skipped": sub.dups_skipped_total,
        "rebases": sub.rebases_total,
        "link": sub.conn_state,
    }


def render_update(update: Dict[str, Any], max_rows: int = 8) -> str:
    """One human line per update (pure; the tests call this)."""
    kind = update["kind"]
    rows = update["rows"]
    if kind == "lookup":
        body = f"value={rows}"
    else:
        shown = rows[:max_rows]
        cells = " ".join(f"{r[0]}={r[1]}" for r in shown)
        more = f" …(+{len(rows) - len(shown)})" \
            if len(rows) > len(shown) else ""
        body = f"rows={len(rows)}: {cells}{more}"
    return (f"h={update['horizon']} {update['sink']}/{kind} {body}  "
            f"[link={update['link']} frames={update['frames_applied']} "
            f"gaps={update['gaps']} dups={update['dups_skipped']}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m reflow_tpu_torch.subs",
        description="tail one standing query over the wire "
                    "(docs/guide.md 'Reactive reads')")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="a replica's subscription endpoint (the "
                         "'subs' address on its ready line)")
    ap.add_argument("--sink", required=True,
                    help="sink name the query stands against")
    ap.add_argument("--kind", default="topk",
                    choices=("view", "lookup", "topk"))
    ap.add_argument("--key", default=None,
                    help="the key to stand on (lookup only); a comma "
                         "builds a (key, value) tuple — 'the,2' "
                         "means ('the', 2.0)")
    ap.add_argument("--k", type=int, default=10,
                    help="result size (topk only)")
    ap.add_argument("--by", default="weight",
                    choices=("weight", "value"),
                    help="topk ranking: multiset weight or scalar "
                         "value")
    ap.add_argument("--min-horizon", type=int, default=0,
                    help="refuse snapshots below this horizon "
                         "(read-your-writes)")
    ap.add_argument("--rounds", type=int, default=0,
                    help="stop after N printed updates (0 = forever)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="stop after S seconds (0 = forever)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="long-poll wait per pump (s)")
    ap.add_argument("--name", default="reflow-sub")
    ap.add_argument("--json", action="store_true",
                    help="emit reflow.sub/1 JSON lines instead of "
                         "the human rendering")
    args = ap.parse_args(argv)

    if args.kind == "lookup" and not args.key:
        ap.error("--kind lookup requires --key")

    from reflow_tpu_torch.net.transport import TcpTransport
    from reflow_tpu_torch.subs.client import Subscriber

    host, port = _addr(args.connect)
    if args.kind == "lookup":
        params = (_key(args.key),)
    elif args.kind == "topk":
        params = (args.k, args.by)
    else:
        params = ()
    sub = Subscriber(TcpTransport(host), (host, port), args.sink,
                     kind=args.kind, params=params, name=args.name,
                     min_horizon=args.min_horizon)
    printed, last_h = 0, None
    deadline = (time.monotonic() + args.duration) if args.duration \
        else None
    try:
        while True:
            sub.pump(wait_s=args.interval)
            if sub.horizon >= 0 and sub.horizon != last_h:
                last_h = sub.horizon
                update = make_update(sub, ts_wall=time.time())
                line = json.dumps(update, sort_keys=True) \
                    if args.json else render_update(update)
                print(line, flush=True)
                printed += 1
                if args.rounds and printed >= args.rounds:
                    break
            if deadline is not None \
                    and time.monotonic() >= deadline:
                break
    except KeyboardInterrupt:
        pass
    finally:
        sub.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
