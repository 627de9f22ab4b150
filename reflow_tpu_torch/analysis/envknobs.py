"""Env-knob pass: every ``REFLOW_*`` read goes through the registry.

``reflow_tpu_torch/utils/config.py`` is the single place the port may
read a ``REFLOW_*`` environment variable raw: it declares each knob
(type, default, one-line doc) and exposes typed accessors. Three rules
keep that true:

- **env-knob-direct** — ``os.environ.get("REFLOW_X")`` (or subscript)
  anywhere else. Direct reads fork the default value from the declared
  one and hide the knob from ``knob_table()`` / the docs.
- **env-knob-undeclared** — an accessor call (``env_flag("REFLOW_X")``
  …) naming a knob the registry does not declare. The accessors raise
  ``KeyError`` at runtime for these; the lint catches them before any
  code path runs.
- **env-knob-undocumented** — a declared knob whose name never appears
  in the port's section of ``README.md``. The section embeds
  ``knob_table()``'s rows, so a missing name means the table went stale.

Writes (``env["REFLOW_X"] = ...``, ``setdefault``) are exempt — a
harness builds child-process environments and that is the point.

The port's copy of ``reflow_tpu/analysis/envknobs.py``. It walks the
port's files only (``reflow_tpu_torch/``, ``chip_smoke.py`` and
``tests/test_torch_*.py``), against the port's registry: the rest of
the repository reads the JAX package's registry, which the JAX pass
holds it to.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from reflow_tpu_torch.analysis.core import (ANALYSIS, PORT, Corpus,
                                            Finding, register_pass)

RULES = {
    "env-knob-direct": "REFLOW_* must be read via utils/config.py "
                       "accessors",
    "env-knob-undeclared": "accessor call names a knob declare() never "
                           "registered",
    "env-knob-undocumented": "declared knob missing from the README's "
                             "port section",
}

_ACCESSORS = ("env_flag", "env_int", "env_float", "env_str")

#: the registry module, exempt from the read rules it defines
CONFIG = PORT + "utils/config.py"
#: files outside the package that belong to the port
PORT_EXTRA = ("chip_smoke.py",)
PORT_TESTS = "tests/test_torch_"
#: the heading that opens the port's section of README.md; the section
#: runs to the next heading of the same level
README_SECTION = "## The PyTorch/CUDA port"


def _first_str(arg: ast.expr) -> str:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return ""


def _walked(path: str) -> bool:
    if path == CONFIG or path.startswith(ANALYSIS):
        return False
    return path.startswith(PORT) or path in PORT_EXTRA \
        or path.startswith(PORT_TESTS)


def port_readme_section(root: str) -> Optional[str]:
    """The text of the README's port section, or None without one."""
    try:
        text = open(os.path.join(root, "README.md"),
                    encoding="utf-8").read()
    except OSError:
        return None
    lines = text.splitlines()
    start = next((i for i, ln in enumerate(lines)
                  if ln.startswith(README_SECTION)), None)
    if start is None:
        return None
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("## ")), len(lines))
    return "\n".join(lines[start:end])


@register_pass("envknobs", RULES)
def envknob_pass(corpus: Corpus) -> List[Finding]:
    findings: List[Finding] = []
    try:
        from reflow_tpu_torch.utils.config import KNOBS
        declared = set(KNOBS)
    except Exception:  # registry import broken: other rules still run
        declared = None

    for sf in corpus.files.values():
        if sf.tree is None or not _walked(sf.path):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            attr = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if attr == "get" and isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Attribute) and \
                    f.value.attr == "environ" and node.args:
                name = _first_str(node.args[0])
                if name.startswith("REFLOW_"):
                    findings.append(Finding(
                        "env-knob-direct", sf.path, node.lineno,
                        f"direct os.environ read of {name!r} — use "
                        f"the utils/config.py accessor so the default "
                        f"and doc stay single-sourced"))
            elif attr in _ACCESSORS and node.args:
                name = _first_str(node.args[0])
                if name.startswith("REFLOW_") and declared is not None \
                        and name not in declared:
                    findings.append(Finding(
                        "env-knob-undeclared", sf.path, node.lineno,
                        f"{attr}({name!r}) but the registry never "
                        f"declare()d it — add it to {CONFIG}"))
        # environ["REFLOW_X"] subscript READS (loads only)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    isinstance(node.value, ast.Attribute) and \
                    node.value.attr == "environ":
                name = _first_str(node.slice)
                if name.startswith("REFLOW_"):
                    findings.append(Finding(
                        "env-knob-direct", sf.path, node.lineno,
                        f"direct os.environ[{name!r}] read — use the "
                        f"utils/config.py accessor"))

    if declared:
        section = port_readme_section(corpus.root) or ""
        for name in sorted(declared):
            if name not in section:
                findings.append(Finding(
                    "env-knob-undocumented", CONFIG, 1,
                    f"knob {name} is declared but never mentioned in "
                    f"the README's port section — regenerate the knob "
                    f"table (knob_table())"))
    return findings
