"""Span-catalog pass: every emitted span kind must be documented.

`tools/trace_inspect.py`, the flight recorder, and every post-mortem
reader key off span *names* — an undocumented kind is a dashboard tile
nobody can interpret and a `--require-chain` link nobody knows to ask
for. One rule machine-checks the contract:

- **span-kind-undocumented** — a span kind emitted anywhere in
  ``reflow_tpu_torch/`` (a string-literal first argument to
  ``trace.evt(...)`` or ``trace.span(...)``, an entry of
  ``obs.trace.STAGES`` or ``obs.trace.DEVICE_SPANS``, or a flight
  ``note("...")`` event) must appear backticked in a span catalog:
  ``docs/guide.md``'s, or the port's own, ``reflow_tpu_torch/obs/spans.md``. Dynamic families (``f"control.{...}"``) are
  documented by their prefix — a backticked token starting with
  ``control.`` covers the family.

The check is name-level on purpose: the catalog is the single place a
reader maps a trace row to semantics, so the lint points at the emit
site and asks for one line of prose, not a waiver.

The port's copy of ``reflow_tpu/analysis/spans.py``: the port emits the
reference's span kinds under the same names, so its emit sites are
held to the same catalog in ``docs/guide.md``; the spans only the port
emits are in its own catalog. The port has two emit sites more than the
reference: ``span("...")`` blocks and the card's spans
(``DEVICE_SPANS``).
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Optional, Set, Tuple

from reflow_tpu_torch.analysis.core import (PORT, Corpus, Finding,
                                            register_pass)

RULES = {
    "span-kind-undocumented": "span kind emitted in reflow_tpu_torch/ but "
                              "absent from the span catalogs "
                              "(docs/guide.md, reflow_tpu_torch/obs/"
                              "spans.md)",
}

#: the documents the catalogs live in, repo-relative: the JAX package's
#: and the port's own, for the spans only the port emits
_CATALOGS = (os.path.join("docs", "guide.md"),
             os.path.join("reflow_tpu_torch", "obs", "spans.md"))

_BACKTICK = re.compile(r"`([^`\n]+)`")


def _doc_tokens(root: str) -> Optional[Set[str]]:
    """The backticked tokens of every catalog found (None: none is)."""
    tokens: Optional[Set[str]] = None
    for rel in _CATALOGS:
        try:
            text = open(os.path.join(root, rel),
                        encoding="utf-8", errors="replace").read()
        except OSError:
            continue
        tokens = (tokens or set()) | set(_BACKTICK.findall(text))
    return tokens


def _evt_name(call: ast.Call) -> Optional[Tuple[str, bool]]:
    """``(name, is_prefix)`` for a span-emitting call, else None.

    Matches ``evt("name", ...)`` / ``<mod>.evt("name", ...)``,
    ``span("name", ...)`` / ``<mod>.span("name", ...)`` and flight
    ``note("name", ...)`` / ``<mod>.note("name", ...)``. An
    f-string first argument yields its leading constant text as a
    prefix family (``f"control.{kind}"`` -> ``("control.", True)``).
    """
    f = call.func
    attr = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    if attr not in ("evt", "note", "span") or not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.JoinedStr) and arg.values \
            and isinstance(arg.values[0], ast.Constant) \
            and isinstance(arg.values[0].value, str):
        return arg.values[0].value, True
    return None


def _stage_names(tree: ast.AST) -> List[Tuple[str, int]]:
    """String elements of the module-level ``STAGES = (...)`` and
    ``DEVICE_SPANS = (...)`` tuples — ``ticket_stages`` and the device
    spans' resolution emit them through a variable the call-site scan
    can't see."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name)
                        and t.id in ("STAGES", "DEVICE_SPANS")
                        for t in node.targets) \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            for el in node.value.elts:
                if isinstance(el, ast.Constant) \
                        and isinstance(el.value, str):
                    out.append((el.value, el.lineno))
    return out


@register_pass("spans", RULES)
def span_pass(corpus: Corpus) -> List[Finding]:
    tokens = _doc_tokens(corpus.root)
    if tokens is None:
        return []  # no catalog in this checkout; nothing to hold against
    findings: List[Finding] = []
    seen: Set[str] = set()

    def _check(name: str, is_prefix: bool, path: str, line: int) -> None:
        if name in seen:
            return
        seen.add(name)
        if is_prefix:
            ok = any(t.startswith(name) for t in tokens)
            what = f"span family `{name}*`"
        else:
            ok = name in tokens
            what = f"span kind `{name}`"
        if not ok:
            findings.append(Finding(
                "span-kind-undocumented", path, line,
                f"{what} is emitted here but not in a span catalog "
                f"(docs/guide.md, reflow_tpu_torch/obs/spans.md) — add "
                f"one backticked line saying what it measures"))

    for sf in corpus.under(PORT):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                hit = _evt_name(node)
                if hit is not None:
                    _check(hit[0], hit[1], sf.path, node.lineno)
        if sf.path == PORT + "obs/trace.py":
            for name, line in _stage_names(sf.tree):
                _check(name, False, sf.path, line)
    return findings
