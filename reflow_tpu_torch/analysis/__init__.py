"""reflow_tpu_torch.analysis — reflow-lint for the port's tree.

The port's copy of ``reflow_tpu/analysis``: the same rules over
``reflow_tpu_torch/`` (lock naming, order and blocking calls under a
lock; crash-seam grammar and coverage by the port's tests; metrics
register/unregister pairing; the port's ``REFLOW_*`` knob registry; no
bare ``assert``; socket deadlines; documented span kinds), the same
waiver grammar and the same ``reflow.lint/1`` report. The HLO constant
audit (``reflow_tpu/analysis/constants.py``) has no counterpart: it
guards a tunnel runtime against HLO constants, and the port compiles
no HLO.

Entry point: ``python -m reflow_tpu_torch.analysis`` (``--json`` emits
the report). Library use::

    from reflow_tpu_torch.analysis import run
    report = run("/path/to/repo")          # every pass
    report["findings"]                      # list of dicts

The runtime twin of the lock pass is ``REFLOW_LOCKCHECK=1`` +
``named_lock`` in :mod:`reflow_tpu_torch.utils.runtime`;
:func:`reflow_tpu_torch.analysis.locks.static_lock_edges` gives the
static graph to compare with the runtime monitor's.
"""

from reflow_tpu_torch.analysis.core import (Corpus, Finding, PASSES, RULES,
                                            import_passes, render_report,
                                            run, to_json)

__all__ = ["Corpus", "Finding", "PASSES", "RULES", "import_passes",
           "render_report", "run", "to_json"]
