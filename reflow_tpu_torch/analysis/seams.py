"""Seam-hygiene pass: CrashInjector seam strings.

Every crash seam in the tree — a literal passed to ``_crash_point``,
``_chaos_point`` (the process harness's kill/respawn seams, scoped
``proc_*@<node>``) or ``CrashInjector.point`` — is a
differential-testing contract: recovery tests arm
``CrashInjector(at=N, only=<seam>)`` and assert the exactly-once
invariants around that exact cut. Two rules keep the contract honest:

- **seam-grammar** — the seam name must be ``lower_snake`` and, when a
  graph scope is attached, follow ``<seam>@<graph>``. Call sites that
  build the scope dynamically (``f"pool_window@{picked.name}"`` or the
  frontend's ``f"{name}@{self.name}"`` helper) are checked on their
  literal part: the seam prefix must end exactly at the ``@``.
- **seam-untested** — a seam no test file ever mentions is dead
  differential coverage: a crash cut nobody asserts on. The reference
  check is substring-based over the port's tests (a test arming
  ``"pump_before_tick@wal"`` covers the ``pump_before_tick`` seam).

The port's copy of ``reflow_tpu/analysis/seams.py``, with one intended
difference: a seam in ``reflow_tpu_torch/`` counts as tested only when
a port test, ``tests/test_torch_*.py``, names it. The JAX pass reads
all of ``tests/``, where a JAX test arming the reference's seam of the
same name would cover the port's seam without ever running it.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from reflow_tpu_torch.analysis.core import Corpus, Finding, register_pass

#: the test files whose text covers a port seam
TESTS = "tests/test_torch_"

_SEAM_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_SCOPED_RE = re.compile(r"^[a-z][a-z0-9_]*@[A-Za-z0-9_.-]+$")

RULES = {
    "seam-grammar": "crash seams must match <seam> or <seam>@<graph>",
    "seam-untested": "every crash seam needs >=1 test referencing it",
}


def _seam_literals(tree: ast.AST) -> List[Tuple[str, int, bool]]:
    """(seam_text, line, is_partial) for every seam-emitting call.
    ``is_partial`` marks f-strings whose graph part is dynamic — only
    the literal prefix is returned."""
    out: List[Tuple[str, int, bool]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        attr = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if attr not in ("_crash_point", "_chaos_point", "point"):
            continue
        if attr == "point":
            # only CrashInjector-ish receivers: self._crash.point(...)
            if not (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Attribute)
                    and "crash" in f.value.attr):
                continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append((arg.value, node.lineno, False))
        elif isinstance(arg, ast.JoinedStr):
            head = ""
            for part in arg.values:
                if isinstance(part, ast.Constant):
                    head += str(part.value)
                else:
                    break
            out.append((head, node.lineno, True))
    return out


@register_pass("seams", RULES)
def seam_pass(corpus: Corpus) -> List[Finding]:
    findings: List[Finding] = []
    tests_text = "\n".join(sf.text for sf in corpus.under("tests/")
                           if sf.path.startswith(TESTS))
    seen: Dict[str, Tuple[str, int]] = {}

    for sf in corpus.port():
        for seam, line, partial in _seam_literals(sf.tree):
            if partial:
                # dynamic graph scope: literal prefix must be
                # "<seam>@" (or empty — the scoping helper re-emitting
                # its argument, which was checked at ITS call sites)
                if seam and not (seam.endswith("@")
                                 and _SEAM_RE.match(seam[:-1])):
                    findings.append(Finding(
                        "seam-grammar", sf.path, line,
                        f"dynamic seam prefix {seam!r} must be "
                        f"'<seam>@' (lower_snake seam, then the "
                        f"graph scope)"))
                    continue
                base = seam[:-1] if seam else None
            else:
                if not (_SEAM_RE.match(seam) or _SCOPED_RE.match(seam)):
                    findings.append(Finding(
                        "seam-grammar", sf.path, line,
                        f"seam {seam!r} does not match <seam> or "
                        f"<seam>@<graph> (lower_snake)"))
                    continue
                base = seam.split("@", 1)[0]
            if base:
                seen.setdefault(base, (sf.path, line))

    for base in sorted(seen):
        if base not in tests_text:
            path, line = seen[base]
            findings.append(Finding(
                "seam-untested", path, line,
                f"crash seam {base!r} has no test referencing it — "
                f"arm CrashInjector(only={base!r}...) in a "
                f"tests/test_torch_*.py file and assert the recovery "
                f"invariant"))
    return findings
