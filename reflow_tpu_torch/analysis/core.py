"""reflow-lint core for the port: the corpus walker, waiver grammar,
pass registry, and the ``reflow.lint/1`` JSON report.

The port's copy of ``reflow_tpu/analysis/core.py``: the same grammar,
the same schema, and passes scoped to the port's tree
(:data:`PORT`). Passes are whole-corpus functions — several rules are
inherently cross-file (a crash seam defined in ``serve/frontend.py`` is
"tested" by a string in ``tests/test_torch_*.py``; the lock
held-before graph merges edges from every module) — so the framework
parses the tree once into a :class:`Corpus` and hands the same object
to every pass.

Waivers are inline and must carry a reason::

    os.fsync(fd)  # reflow-lint: waive lock-blocking-call -- fsync IS the
                  # committer's job; _sync_lock exists to serialize it

A waiver suppresses the named rule on its own line and the line it is
attached to (same line or the line directly above, so a finding on a
long statement can carry its waiver as a trailing or preceding
comment). A waiver without a ``-- reason`` is itself a finding
(``waiver-no-reason``): the whole point is that every suppression
explains itself to the next reader.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

#: directories the walker never descends into
SKIP_DIRS = {"__pycache__", ".git", ".claude", "node_modules", ".venv",
             "venv", "build", "dist", ".pytest_cache"}

#: the tree every port pass lints, and the part of it no pass looks at
PORT = "reflow_tpu_torch/"
ANALYSIS = "reflow_tpu_torch/analysis/"

_WAIVE_RE = re.compile(
    r"#\s*reflow-lint:\s*waive\s+([A-Za-z0-9_,-]+)(?:\s*--\s*(.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation, pointing at a source line."""

    rule: str
    path: str
    line: int
    msg: str

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "msg": self.msg}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


@dataclasses.dataclass
class SourceFile:
    """One parsed file: text, line list, AST (None on syntax error),
    and the waiver map ``line -> set of waived rule names``."""

    path: str            # repo-relative, forward slashes
    text: str
    tree: Optional[ast.AST]
    waivers: Dict[int, set]
    bad_waivers: List[int]  # waiver comments missing a reason

    @property
    def lines(self) -> List[str]:
        return self.text.splitlines()


class Corpus:
    """Every python file under the repo root, parsed once."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self.files: Dict[str, SourceFile] = {}
        for path in self._walk():
            rel = os.path.relpath(path, self.root).replace(os.sep, "/")
            try:
                text = open(path, encoding="utf-8",
                            errors="replace").read()
            except OSError:
                continue
            try:
                tree = ast.parse(text, filename=rel)
            except SyntaxError:
                tree = None  # compileall owns syntax; don't double-report
            waivers, bad = _parse_waivers(text)
            self.files[rel] = SourceFile(rel, text, tree, waivers, bad)

    def _walk(self) -> List[str]:
        out: List[str] = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in SKIP_DIRS
                                 and not d.endswith(".egg-info"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
        return out

    def port(self) -> List[SourceFile]:
        """The port's parsed files, the analysis package left out."""
        return [sf for sf in self.under(PORT)
                if sf.tree is not None and not sf.path.startswith(ANALYSIS)]

    def under(self, *prefixes: str) -> List[SourceFile]:
        """Files whose repo-relative path starts with any prefix."""
        return [f for p, f in sorted(self.files.items())
                if any(p == pre or p.startswith(pre.rstrip("/") + "/")
                       or (pre.endswith("/") and p.startswith(pre))
                       for pre in prefixes)]


def _parse_waivers(text: str) -> Tuple[Dict[int, set], List[int]]:
    waivers: Dict[int, set] = {}
    bad: List[int] = []
    for i, line in enumerate(text.splitlines(), start=1):
        m = _WAIVE_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if not (m.group(2) or "").strip():
            bad.append(i)
        # the waiver covers its own line and the next (a comment line
        # directly above the flagged statement)
        for ln in (i, i + 1):
            waivers.setdefault(ln, set()).update(rules)
    return waivers, bad


# -- pass registry ----------------------------------------------------------

#: rule name -> one-line description (the ``--list-rules`` catalog)
RULES: Dict[str, str] = {
    "waiver-no-reason": "a waiver comment must carry `-- <reason>`",
}

#: pass name -> (callable(Corpus) -> List[Finding], rules it emits)
PASSES: Dict[str, Tuple[Callable[[Corpus], List[Finding]], List[str]]] = {}


def register_pass(name: str, rules: Dict[str, str]):
    """Decorator: register a corpus pass and the rules it can emit."""
    def deco(fn: Callable[[Corpus], List[Finding]]):
        RULES.update(rules)
        PASSES[name] = (fn, list(rules))
        return fn
    return deco


def _waived(corpus: Corpus, f: Finding) -> bool:
    sf = corpus.files.get(f.path)
    return bool(sf and f.rule in sf.waivers.get(f.line, ()))


def import_passes() -> None:
    """Import every pass module, which registers its rules."""
    from reflow_tpu_torch.analysis import (envknobs,  # noqa: F401
                                           exceptions, locks,
                                           metrics_pass, seams, sockets,
                                           spans)


def run(root: str, *, passes: Optional[List[str]] = None,
        rules: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the selected passes over ``root``; returns the report dict
    (schema ``reflow.lint/1``). Findings on waived lines are dropped
    but counted; a waiver missing its reason is always a finding."""
    # passes self-register at import; import here so `import
    # reflow_tpu_torch.analysis.core` alone stays side-effect-light
    import_passes()

    corpus = Corpus(root)
    findings: List[Finding] = []
    waived = 0
    selected = passes if passes is not None else sorted(PASSES)
    for name in selected:
        if name not in PASSES:
            raise KeyError(f"unknown pass {name!r}; have {sorted(PASSES)}")
        fn, _ = PASSES[name]
        for f in fn(corpus):
            if rules is not None and f.rule not in rules:
                continue
            if _waived(corpus, f):
                waived += 1
            else:
                findings.append(f)
    if rules is None or "waiver-no-reason" in rules:
        for sf in corpus.files.values():
            for ln in sf.bad_waivers:
                findings.append(Finding(
                    "waiver-no-reason", sf.path, ln,
                    "waiver without `-- <reason>`: say why it is safe"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "schema": "reflow.lint/1",
        "root": corpus.root,
        "files_scanned": len(corpus.files),
        "passes": selected,
        "findings": [f.to_dict() for f in findings],
        "counts": counts,
        "waived": waived,
    }


def render_report(report: Dict[str, object]) -> str:
    lines = []
    for f in report["findings"]:
        lines.append(f"{f['path']}:{f['line']}: [{f['rule']}] {f['msg']}")
    n = len(report["findings"])
    lines.append(f"reflow-lint: {n} finding{'s' if n != 1 else ''} "
                 f"({report['waived']} waived) across "
                 f"{report['files_scanned']} files")
    return "\n".join(lines)


def to_json(report: Dict[str, object]) -> str:
    return json.dumps(report, indent=2, sort_keys=False)
