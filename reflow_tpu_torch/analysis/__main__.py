"""``python -m reflow_tpu_torch.analysis`` — reflow-lint over the port.

Usage::

    python -m reflow_tpu_torch.analysis               # every pass
    python -m reflow_tpu_torch.analysis --json        # reflow.lint/1
    python -m reflow_tpu_torch.analysis --passes locks,seams
    python -m reflow_tpu_torch.analysis --rules bare-assert
    python -m reflow_tpu_torch.analysis --list-rules

Exit codes: 0 clean, 1 findings, 2 usage/internal error. Waive a
finding inline with a reason::

    # reflow-lint: waive <rule> -- <why this is safe>

The port's counterpart of ``tools/reflow_lint.py``, with the same flags
but ``--hlo`` / ``--hlo-workloads`` (the port compiles no HLO).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m reflow_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=None,
                    help="repo root to lint (default: the checkout this "
                         "package lives in)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the reflow.lint/1 JSON report")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass subset (default: all)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule filter (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)      # a usage error exits 2

    from reflow_tpu_torch.analysis import core

    if args.list_rules:
        core.import_passes()
        for name in sorted(core.RULES):
            print(f"{name:28s} {core.RULES[name]}")
        return 0

    root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    passes = args.passes.split(",") if args.passes else None
    rules = args.rules.split(",") if args.rules else None
    try:
        report = core.run(root, passes=passes, rules=rules)
    except KeyError as e:
        print(f"reflow_lint: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        print(core.render_report(report))
    return 1 if report["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
