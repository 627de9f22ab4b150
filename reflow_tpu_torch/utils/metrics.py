"""Profiler labels for the window path.

The port's copy of ``profile_annotation`` from
``reflow_tpu/utils/metrics.py``: a named range around one block, so a
device trace lines a window's dispatch up against its device work. The
JAX package labels with ``jax.profiler.TraceAnnotation``; here the label
is a ``torch.profiler.record_function`` range, which shows in a
``torch.profiler`` trace beside the ``reflow::`` ranges the lowerings
emit.
"""

from __future__ import annotations

import contextlib
import warnings

__all__ = ["profile_annotation"]

#: warn once, then stay silent: dispatch-path annotation failures must
#: not spam a log line per window
_annotation_warned = False


@contextlib.contextmanager
def profile_annotation(name: str, *, enabled: bool = True):
    """Label a block with a ``torch.profiler.record_function`` range
    named ``name`` (the window dispatch uses ``reflow.window[K]``).

    ``enabled=False`` (and any profiler failure) degrades to running the
    block unannotated: annotation is observability, never correctness.
    Failures warn once per process.
    """
    global _annotation_warned
    if not enabled:
        yield
        return
    try:
        import torch

        ctx = torch.profiler.record_function(name)
        ctx.__enter__()
    except Exception as e:  # noqa: BLE001 - degrade to a no-op label
        if not _annotation_warned:
            _annotation_warned = True
            warnings.warn(
                f"torch.profiler unavailable ({e!r}); profile_annotation "
                f"is a no-op", RuntimeWarning, stacklevel=3)
        yield
        return
    try:
        yield
    finally:
        ctx.__exit__(None, None, None)
