"""Lock construction and the forced-sync hook.

Every lock on a concurrent path of the port is created through
:func:`named_lock`, as in the JAX package, so a lock-order detector can
later wrap them by name without touching the call sites. Here it returns
a plain ``threading.Lock`` / ``RLock``.

:func:`note_forced_sync` is where the scheduler reports a mid-stream
device->host readback. The scheduler counts them itself
(``DirtyScheduler.forced_syncs``); this hook keeps a process-wide total
for callers that watch several schedulers.
"""

from __future__ import annotations

import threading

__all__ = ["named_lock", "note_forced_sync", "forced_sync_total"]

_forced_syncs = 0


def named_lock(name: str, *, reentrant: bool = False):
    """The one way the port creates a lock on a concurrent path. ``name``
    identifies the lock in the held-before order (instances that can
    interact within one thread use distinct names)."""
    return threading.RLock() if reentrant else threading.Lock()


def note_forced_sync(context: str) -> None:
    """Record one mid-stream device readback (``context`` says where)."""
    global _forced_syncs
    _forced_syncs += 1


def forced_sync_total() -> int:
    """Forced readbacks noted in this process so far."""
    return _forced_syncs
