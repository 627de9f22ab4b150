"""Metrics-hygiene pass: registration pairing, naming, and release
coverage.

- **metrics-unpaired** — a file that registers metric sources or gauges
  (``register_source(...)`` / ``reg.gauge(...)``) must also contain an
  unregister path (``unregister_source`` / ``unregister_prefix``).
  Sources and gauges hold lambdas that capture ``self``; a close/seal
  that does not unregister leaves the registry reading a dead object
  forever (and pins it in memory). The check is per-file by design:
  the unregister belongs next to the register (``publish_metrics`` /
  ``close`` live on the same class), not in some caller.
- **metrics-name** — metric name literals must be dotted lower_snake
  (``wal.fsync_rate``, ``serve.<graph>.depth``): one grammar means
  ``unregister_prefix(f"{key}.")`` and dashboards can rely on the
  separator. F-string names are checked on their literal fragments.
- **metrics-registry-mismatch** — a file whose registrations target a
  caller-supplied registry (the ``publish_metrics(registry=None)``
  convention binds it to ``reg``) while EVERY unregister in the file
  goes through the module-global ``REGISTRY``. The pairing rule above
  is satisfied, but gauges registered into a private registry (the
  fleet telemetry plane gives every node its own) are never released —
  exactly the leak shipped in the pre-fleet ``ReadTier``/``ship``
  close paths. The fix convention: store ``(reg, name)`` pairs and
  release on the registry that registered.
- **metrics-source-unreleased** — corpus-wide ``register_source``
  coverage: every ``register_source`` call anywhere in the tree (not
  just ``reflow_tpu_torch/``; the JAX package, which the JAX pass
  holds, left out) must be releasable — an
  ``unregister_source``/``unregister_prefix`` in the same file, or,
  for literal keys, a literal release fragment somewhere in the corpus
  that covers the key. Cross-file on purpose: a source registered by
  one module and sealed by another still counts, and a source nobody
  releases is a leak no per-file view can see. Files already flagged
  ``metrics-unpaired`` are not flagged again for the same leak.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from reflow_tpu_torch.analysis.core import (ANALYSIS, PORT, Corpus,
                                            Finding, register_pass)

_NAME_FRAG = re.compile(r"^[a-z0-9_.]*$")

RULES = {
    "metrics-unpaired": "register_source/gauge without an unregister "
                        "path in the same file",
    "metrics-name": "metric names must be dotted lower_snake",
    "metrics-registry-mismatch": "registrations on a caller-supplied "
                                 "registry but every unregister "
                                 "targets the global REGISTRY",
    "metrics-source-unreleased": "a register_source with no covering "
                                 "unregister anywhere in the corpus",
}

_REGISTERING = ("register_source", "gauge", "counter")
_UNREGISTERING = ("unregister_source", "unregister_prefix")

#: files the rules never apply to: the registry defines the API (it
#: can't pair it) and the analysis package only names the calls
_EXEMPT = (ANALYSIS, PORT + "obs/registry.py")
#: the JAX package: its sources and releases are the JAX pass's, and a
#: release literal there must not cover a source of the port
_REFERENCE = "reflow_tpu/"


def _name_fragments(arg: ast.expr) -> List[str]:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return [arg.value]
    if isinstance(arg, ast.JoinedStr):
        return [str(p.value) for p in arg.values
                if isinstance(p, ast.Constant)]
    return []


def _leading_literal(arg: ast.expr) -> Optional[str]:
    """The key's leading literal text, or None for a fully dynamic
    name (``register_source(key, ...)``)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr) and arg.values and isinstance(
            arg.values[0], ast.Constant):
        return str(arg.values[0].value)
    return None


def _receiver(call: ast.Call) -> Optional[str]:
    """The dotted receiver of ``recv.method(...)`` — ``"reg"``,
    ``"REGISTRY"``, ``"self.registry"`` — or None for a bare name."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    parts: List[str] = []
    v = f.value
    while isinstance(v, ast.Attribute):
        parts.append(v.attr)
        v = v.value
    if not isinstance(v, ast.Name):
        return None
    parts.append(v.id)
    return ".".join(reversed(parts))


def _calls(sf) -> Tuple[List[ast.Call], List[ast.Call]]:
    """(registering, unregistering) calls in one file."""
    registers: List[ast.Call] = []
    unregisters: List[ast.Call] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        attr = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if attr in _REGISTERING and node.args:
            registers.append(node)
        elif attr in _UNREGISTERING:
            unregisters.append(node)
    return registers, unregisters


@register_pass("metrics", RULES)
def metrics_pass(corpus: Corpus) -> List[Finding]:
    findings: List[Finding] = []
    unpaired_paths = set()  # already reported: don't double-flag below
    for sf in corpus.under(PORT):
        if sf.tree is None or sf.path.startswith(_EXEMPT):
            continue
        registers, unregisters = _calls(sf)
        for node in registers:
            for frag in _name_fragments(node.args[0]):
                if not _NAME_FRAG.match(frag):
                    findings.append(Finding(
                        "metrics-name", sf.path, node.lineno,
                        f"metric name fragment {frag!r} is not "
                        f"dotted lower_snake"))
        if registers and not unregisters:
            n = registers[0]
            unpaired_paths.add(sf.path)
            findings.append(Finding(
                "metrics-unpaired", sf.path, n.lineno,
                f"{len(registers)} metric registration(s) but no "
                f"unregister_source/unregister_prefix in this file — "
                f"the close/seal path must drop them or the registry "
                f"keeps reading a dead object"))
        reg_recvs = {_receiver(n) for n in registers}
        unreg_recvs = [_receiver(n) for n in unregisters]
        if (unreg_recvs
                and any(r not in (None, "REGISTRY") for r in reg_recvs)
                and all(r == "REGISTRY" for r in unreg_recvs)):
            n = registers[0]
            findings.append(Finding(
                "metrics-registry-mismatch", sf.path, n.lineno,
                f"registrations target "
                f"{sorted(r for r in reg_recvs if r)} but every "
                f"unregister goes through the global REGISTRY — "
                f"metrics registered into a caller-supplied registry "
                f"are never released; store (registry, name) pairs "
                f"and release on the registry that registered"))

    # -- corpus-wide register_source coverage (cross-file on purpose) --
    release_frags = set()
    files_with_release = set()
    sources: List[Tuple[object, ast.Call]] = []
    for sf in corpus.files.values():
        if sf.tree is None or sf.path.startswith(_EXEMPT) \
                or sf.path.startswith(("tests/", _REFERENCE)):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            attr = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if attr == "register_source" and node.args:
                sources.append((sf, node))
            elif attr in _UNREGISTERING:
                files_with_release.add(sf.path)
                if node.args:
                    lit = _leading_literal(node.args[0])
                    if lit:
                        release_frags.add(lit)
    for sf, node in sources:
        if sf.path in files_with_release:
            continue  # per-file pairing, the normal convention
        if sf.path in unpaired_paths:
            continue  # metrics-unpaired already flagged this file
        key = _leading_literal(node.args[0])
        covered = key is not None and any(
            key == frag or key.startswith(frag)
            or frag.startswith(key) for frag in release_frags)
        if not covered:
            findings.append(Finding(
                "metrics-source-unreleased", sf.path, node.lineno,
                f"register_source({key!r}) has no unregister in this "
                f"file and no covering unregister literal anywhere in "
                f"the corpus — the source outlives its object"))
    return findings
