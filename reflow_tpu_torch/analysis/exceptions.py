"""Exception-policy pass: no bare ``assert`` on runtime paths.

The PR-1 rule, now machine-enforced: ``python -O`` strips ``assert``
statements, so an invariant guarded by one silently stops being
checked in optimized deployments — and a tripped assert raises
``AssertionError`` with no context instead of the typed error the
caller could handle. Runtime code (everything under
``reflow_tpu_torch/`` except the analysis package itself) must raise a
real exception. The port's copy of ``reflow_tpu/analysis/exceptions.py``.

Tests are exempt (pytest rewrites asserts into rich diffs — there they
are the right tool), as are asserts inside ``TYPE_CHECKING`` blocks.
"""

from __future__ import annotations

import ast
from typing import List

from reflow_tpu_torch.analysis.core import Corpus, Finding, register_pass

RULES = {
    "bare-assert": "runtime code must raise typed errors, not assert "
                   "(python -O strips them)",
}


@register_pass("exceptions", RULES)
def exception_pass(corpus: Corpus) -> List[Finding]:
    findings: List[Finding] = []
    for sf in corpus.port():
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assert):
                findings.append(Finding(
                    "bare-assert", sf.path, node.lineno,
                    "bare assert on a runtime path — raise a typed "
                    "error instead (python -O strips asserts)"))
    return findings
