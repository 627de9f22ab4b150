"""Lock-discipline pass: the static twin of the ``REFLOW_LOCKCHECK=1``
runtime monitor (utils/runtime.py).

Three rules, all keyed on the same ``named_lock("...")`` names the
runtime detector uses:

- **lock-unnamed** — a ``threading.Lock()`` / ``RLock()`` / bare
  ``Condition()`` created inside ``reflow_tpu_torch/``. Every lock on a
  concurrent path must come from :func:`named_lock` so both detectors
  can see it (a raw lock is invisible to the held-before graph).
- **lock-order-cycle** — nested ``with``-acquisitions are merged into a
  whole-repo held-before graph over lock *names* (dynamic per-instance
  names like ``serve.replica.<n>`` collapse to their literal prefix +
  ``*``); any strongly-connected component is a potential AB/BA
  deadlock. One level of same-class call expansion is applied (a method
  called while a lock is held contributes the locks IT acquires), so
  the common "helper that takes the other lock" shape is visible.
- **lock-blocking-call** — a call that can block or dispatch for a long
  time (``os.fsync``, ``time.sleep``, ``Future.result``,
  ``wait_durable``, ``block_until_ready``, scheduler ``tick``/
  ``tick_many``/``run_window``/``dispatch_staged``, thread ``join``)
  made while a named lock is held. These turn a mutex into a latency
  cliff for every other thread parked on it.
- **lock-wait-no-loop** — ``Condition.wait()`` outside a ``while``
  predicate loop (spurious wakeups make a bare ``wait`` a correctness
  bug; ``wait_for`` carries its own loop and is always fine).

The analysis is intra-file and syntactic by design: it cannot see
locks passed across modules or acquired via callbacks — that is
exactly what the runtime monitor is for. The two share the name
vocabulary so a static finding and a runtime raise point at the same
graph node.

The port's copy of ``reflow_tpu/analysis/locks.py``, scoped to
``reflow_tpu_torch/``; :func:`static_lock_edges` hands the merged
held-before graph to a caller that compares it with the runtime
monitor's (``chip_smoke.py``'s lockcheck leg).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from reflow_tpu_torch.analysis.core import Corpus, Finding, register_pass

#: attribute/function names that block (or dispatch a device program)
BLOCKING = {"fsync", "sleep", "result", "wait_durable",
            "block_until_ready", "tick", "tick_many", "run_window",
            "dispatch_staged"}

RULES = {
    "lock-unnamed": "locks in reflow_tpu_torch/ must come from "
                    "named_lock()",
    "lock-order-cycle": "nested lock acquisitions form an ordering cycle",
    "lock-blocking-call": "blocking/dispatch call while a lock is held",
    "lock-wait-no-loop": "Condition.wait() outside a while-predicate loop",
}


def _literal_prefix(node: ast.expr) -> Optional[str]:
    """The lock name for a named_lock() first argument: a constant
    string verbatim, an f-string collapsed to its literal prefix + '*'."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        head = ""
        for part in node.values:
            if isinstance(part, ast.Constant):
                head += str(part.value)
            else:
                return head + "*"
        return head
    if isinstance(node, ast.IfExp):  # f"..." if name else "..."
        a = _literal_prefix(node.body)
        return a if a is not None else _literal_prefix(node.orelse)
    return None


def _find_call(node: ast.expr, fn_name: str) -> Optional[ast.Call]:
    """The first call to ``fn_name`` anywhere inside ``node``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if (isinstance(f, ast.Name) and f.id == fn_name) or \
                    (isinstance(f, ast.Attribute) and f.attr == fn_name):
                return sub
    return None


class _ClassMap:
    """Per-class lock/condition attribute resolution."""

    def __init__(self) -> None:
        self.locks: Dict[str, str] = {}       # attr -> lock name
        self.conds: Dict[str, str] = {}       # cond attr -> lock name
        self.methods: Dict[str, ast.FunctionDef] = {}


def _scan_class(cls: ast.ClassDef, module_locks: Dict[str, str]
                ) -> _ClassMap:
    cm = _ClassMap()
    for fn in cls.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cm.methods[fn.name] = fn
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                tgt = node.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                call = _find_call(node.value, "named_lock")
                if call is not None and call.args:
                    name = _literal_prefix(call.args[0])
                    if name:
                        cm.locks[tgt.attr] = name
                    continue
                call = _find_call(node.value, "Condition")
                if call is not None:
                    if call.args:
                        arg = call.args[0]
                        if (isinstance(arg, ast.Attribute)
                                and isinstance(arg.value, ast.Name)
                                and arg.value.id == "self"
                                and arg.attr in cm.locks):
                            cm.conds[tgt.attr] = cm.locks[arg.attr]
                        else:
                            cm.conds[tgt.attr] = f"<{tgt.attr}>"
                    # bare Condition() handled by the unnamed scan
    cm.locks.update({k: v for k, v in module_locks.items()
                     if k not in cm.locks})
    return cm


def _lock_name_of(expr: ast.expr, cm: Optional[_ClassMap],
                  module_locks: Dict[str, str]) -> Optional[str]:
    """Resolve a with-item context expr to a lock name, via the class
    attr map (``self._lock`` / condition attrs) or module globals."""
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        if cm is not None:
            if expr.attr in cm.locks:
                return cm.locks[expr.attr]
            if expr.attr in cm.conds:
                return cm.conds[expr.attr]
        return None
    if isinstance(expr, ast.Name):
        return module_locks.get(expr.id)
    return None


def _walk_fn(fn: ast.FunctionDef, cm: Optional[_ClassMap],
             module_locks: Dict[str, str], path: str,
             edges: Dict[str, Set[str]],
             sites: Dict[Tuple[str, str], Tuple[str, int]],
             findings: List[Finding], *, expand: bool = True) -> None:
    """Intra-function held-stack walk; records edges/blocking findings."""

    def visit(node: ast.AST, held: List[str],
              loop_depth: int) -> None:
        if isinstance(node, ast.With):
            acquired: List[str] = []
            for item in node.items:
                name = _lock_name_of(item.context_expr, cm, module_locks)
                if name is not None:
                    for h in held:
                        if h != name:
                            edges.setdefault(h, set()).add(name)
                            sites.setdefault((h, name),
                                             (path, node.lineno))
                    acquired.append(name)
            for child in node.body:
                visit(child, held + acquired, loop_depth)
            return
        if isinstance(node, (ast.While, ast.For)):
            for child in ast.iter_child_nodes(node):
                visit(child, held, loop_depth + 1)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return  # nested defs run later, under unknown locks
        if isinstance(node, ast.Call) and held:
            f = node.func
            attr = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if attr == "wait":
                recv_name = _lock_name_of(
                    f.value, cm, module_locks) if isinstance(
                        f, ast.Attribute) else None
                if recv_name is not None and loop_depth == 0:
                    findings.append(Finding(
                        "lock-wait-no-loop", path, node.lineno,
                        f"Condition.wait() on {recv_name!r} outside a "
                        f"while-predicate loop (spurious wakeups); use "
                        f"`while pred: cv.wait()` or wait_for"))
            elif attr in BLOCKING:
                if not _is_str_method(f):
                    findings.append(Finding(
                        "lock-blocking-call", path, node.lineno,
                        f"call to {attr}() while holding "
                        f"{held!r} — blocks every thread parked on "
                        f"the lock"))
            elif (expand and cm is not None
                  and isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Name)
                  and f.value.id == "self" and attr in cm.methods):
                # one-level expansion: locks the callee acquires become
                # edges from everything currently held
                callee = cm.methods[attr]
                sub_edges: Dict[str, Set[str]] = {}
                _walk_fn(callee, cm, module_locks, path, sub_edges,
                         sites, [], expand=False)
                callee_locks: Set[str] = set(sub_edges)
                for tos in sub_edges.values():
                    callee_locks |= tos
                for node2 in ast.walk(callee):
                    if isinstance(node2, ast.With):
                        for item in node2.items:
                            nm = _lock_name_of(item.context_expr, cm,
                                               module_locks)
                            if nm is not None:
                                callee_locks.add(nm)
                for nm in callee_locks:
                    for h in held:
                        if h != nm:
                            edges.setdefault(h, set()).add(nm)
                            sites.setdefault((h, nm),
                                             (path, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, held, loop_depth)

    for stmt in fn.body:
        visit(stmt, [], 0)


def _is_str_method(f: ast.expr) -> bool:
    return (isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Constant)
            and isinstance(f.value.value, str))


def _sccs(edges: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan SCCs of the name graph; only components of size > 1 (or
    explicit self-loops) are cycles."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strong(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in sorted(edges.get(v, ())):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1 or v in edges.get(v, ()):
                out.append(sorted(comp))

    nodes = set(edges)
    for tos in edges.values():
        nodes |= tos
    for v in sorted(nodes):
        if v not in index:
            strong(v)
    return out


def _scan(corpus: Corpus) -> Tuple[Dict[str, Set[str]],
                                   Dict[Tuple[str, str], Tuple[str, int]],
                                   List[Finding]]:
    """The merged held-before graph over the port's files, the site of
    each edge, and the per-site findings (everything but cycles)."""
    findings: List[Finding] = []
    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[str, int]] = {}

    for sf in corpus.port():
        # unnamed locks
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("Lock", "RLock") and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "threading":
                findings.append(Finding(
                    "lock-unnamed", sf.path, node.lineno,
                    f"threading.{node.func.attr}() — use "
                    f"named_lock(...) so both lock-order detectors "
                    f"can see it"))
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "Condition" and not node.args:
                findings.append(Finding(
                    "lock-unnamed", sf.path, node.lineno,
                    "bare threading.Condition() allocates a hidden "
                    "RLock — pass a named_lock()"))
        # module-level named locks
        module_locks: Dict[str, str] = {}
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.targets[0], ast.Name):
                call = _find_call(node.value, "named_lock")
                if call is not None and call.args:
                    nm = _literal_prefix(call.args[0])
                    if nm:
                        module_locks[node.targets[0].id] = nm
        # held-stack walk per function/method
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                cm = _scan_class(node, module_locks)
                for m in cm.methods.values():
                    _walk_fn(m, cm, module_locks, sf.path, edges,
                             sites, findings)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                _walk_fn(node, None, module_locks, sf.path, edges,
                         sites, findings)
    return edges, sites, findings


def static_lock_edges(corpus: Corpus) -> Dict[str, Set[str]]:
    """The static held-before graph: lock name -> the names acquired
    while it is held. Dynamic names appear as their literal prefix +
    ``*`` (``serve.replica.*``)."""
    return _scan(corpus)[0]


@register_pass("locks", RULES)
def lock_pass(corpus: Corpus) -> List[Finding]:
    edges, sites, findings = _scan(corpus)
    for comp in _sccs(edges):
        where = []
        for a in comp:
            for b in comp:
                if b in edges.get(a, ()):
                    p, ln = sites[(a, b)]
                    where.append(f"{a}->{b} at {p}:{ln}")
        p, ln = sites[next((a, b) for a in comp for b in comp
                           if b in edges.get(a, ()))]
        findings.append(Finding(
            "lock-order-cycle", p, ln,
            f"held-before cycle over {comp}: " + "; ".join(where)))
    return findings
