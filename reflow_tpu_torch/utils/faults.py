"""Fault seams: the delivery-contract error and simulated process death.

The port's copy of the part of ``reflow_tpu/utils/faults.py`` the ported
modules use:

- :class:`DeliveryError` — the host boundary refusing a batch that would
  break the delivery contract (the ingress queue raises it for keys
  outside its int32 slot range);
- :class:`CrashPoint` and :class:`CrashInjector` — process death at the
  N-th instrumented seam (the serve frontend's ``producer_*`` and
  ``pump_*`` seams).

The lossy transport, crash storms and WAL tearing wait for the
durability layers.
"""

from __future__ import annotations

from typing import List, Optional

from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["CrashInjector", "CrashPoint", "DeliveryError"]


class DeliveryError(RuntimeError):
    """The transport observed the scheduler violating the delivery
    contract (a duplicate accepted, or a first delivery rejected)."""


class CrashPoint(BaseException):
    """Simulated process death. Derives from BaseException so generic
    ``except Exception`` recovery paths can't accidentally 'survive'
    the kill — only the test harness catches it."""


class CrashInjector:
    """Raise :class:`CrashPoint` at the N-th instrumented crash seam.

    ``at`` counts every visited seam; ``only`` restricts counting to
    seams whose name contains the substring (e.g. ``"pump"`` to kill the
    serve frontend's pump thread). ``fired`` records whether the kill
    happened; ``fired_seam`` which seam it happened at. A named
    frontend scopes its seams as ``<seam>@<name>``.

    Seam visits are counted under a lock: the serve frontend fires its
    seams from N producer threads and the pump thread concurrently, and
    exactly ONE of them must die.
    """

    def __init__(self, at: int, *, only: Optional[str] = None):
        self.remaining = at
        self.only = only
        self.fired = False
        self.fired_seam: Optional[str] = None
        self.seams: List[str] = []
        self._lock = named_lock("faults.crash")

    def point(self, name: str) -> None:
        with self._lock:
            if self.fired or (self.only is not None
                              and self.only not in name):
                return
            self.seams.append(name)
            self.remaining -= 1
            if self.remaining <= 0:
                self.fired = True
                self.fired_seam = name
                raise CrashPoint(name)
