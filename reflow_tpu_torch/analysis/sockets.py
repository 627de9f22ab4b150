"""Socket-timeout pass: no blocking socket call without a deadline.

The replication transport's contract (``net/transport.py``) is that no
wire operation can wait forever — a partitioned peer must surface as a
:class:`~reflow_tpu_torch.net.framing.TransportError` on a bounded clock, not
as a thread parked in ``recv`` until the heat death of the pod. One
rule machine-checks it:

- **socket-no-timeout** — a ``recv``/``recvfrom``/``accept``/
  ``connect`` call in ``reflow_tpu_torch/`` whose enclosing function never
  arms a deadline: no ``settimeout(...)`` call, and not a
  ``socket.create_connection(..., timeout=...)``. Scoped to files that
  actually ``import socket`` so unrelated objects with a ``connect``
  method (schedulers, clients) don't trip it.

The check is per enclosing function on purpose: that is the unit in
which a deadline discipline is visible to a reader, and the transport
code re-arms ``settimeout`` before every blocking call precisely so
each function is self-evidently bounded. Genuinely-blocking intent
(rare, e.g. a tool that wants to wait forever) takes the standard
waiver with a reason. The port's copy of
``reflow_tpu/analysis/sockets.py``.
"""

from __future__ import annotations

import ast
from typing import List

from reflow_tpu_torch.analysis.core import (PORT, Corpus, Finding,
                                            register_pass)

RULES = {
    "socket-no-timeout": "blocking socket call with no settimeout/"
                         "timeout= in its enclosing function",
}

#: blocking socket operations that honor the socket's timeout
_BLOCKING = {"recv", "recvfrom", "recv_into", "accept", "connect"}


def _imports_socket(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "socket" or a.name.startswith("socket.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module == "socket":
                return True
    return False


def _has_deadline(fn: ast.AST) -> bool:
    """Does this function arm any socket deadline? True on a
    ``settimeout`` call or a ``create_connection(..., timeout=...)``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        attr = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if attr == "settimeout":
            return True
        if attr == "create_connection" \
                and any(kw.arg == "timeout" for kw in node.keywords):
            return True
    return False


@register_pass("sockets", RULES)
def socket_pass(corpus: Corpus) -> List[Finding]:
    findings: List[Finding] = []
    for sf in corpus.under(PORT):
        if sf.tree is None or not _imports_socket(sf.tree):
            continue
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            armed = _has_deadline(fn)
            if armed:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) \
                        or not isinstance(node.func, ast.Attribute):
                    continue
                attr = node.func.attr
                if attr not in _BLOCKING:
                    continue
                if attr == "create_connection":
                    continue  # handled by _has_deadline
                if attr == "connect" \
                        and any(kw.arg == "timeout"
                                for kw in node.keywords):
                    continue
                findings.append(Finding(
                    "socket-no-timeout", sf.path, node.lineno,
                    f".{attr}() with no settimeout() in "
                    f"{fn.name}() — a partitioned peer would park "
                    f"this thread forever; arm a deadline (see "
                    f"net/transport.py) or waive with the blocking "
                    f"intent spelled out"))
    return findings
