"""Per-link reconnect state machine: capped exponential backoff with
deterministic jitter (docs/guide.md "Replication over the wire").

The port's copy of ``reflow_tpu/net/backoff.py``: the same seed gives
the same delays.

One :class:`ReconnectPolicy` instance tracks one follower link through
the connection lifecycle::

    connecting -> healthy -> degraded -> unreachable
         ^___________________________________|   (on the next success)

State transitions are driven only by :meth:`ok` / :meth:`failed`, and
time only flows through the injected ``clock`` callable — so tests run
the whole machine on a fake clock with zero real sleeps
(tests/test_net.py). Thresholds and delays come from the
``REFLOW_NET_*`` knobs; jitter is drawn from a per-link RNG seeded by
``(seed, link name)`` so two runs with the same seed reconnect on the
same schedule.

The shipper never sleeps on this object: it polls :meth:`due` from its
existing pump cadence and skips the link while a backoff window is
open. That keeps one stalled follower from blocking the others — the
same reasoning as the per-follower cursors in ``wal/ship.py``.
"""

from __future__ import annotations

import random
import time
import zlib
from typing import Callable, Optional

from reflow_tpu_torch.utils.config import env_float, env_int

__all__ = ["ReconnectPolicy", "STATE_CONNECTING", "STATE_HEALTHY",
           "STATE_DEGRADED", "STATE_UNREACHABLE"]

STATE_CONNECTING = "connecting"
STATE_HEALTHY = "healthy"
STATE_DEGRADED = "degraded"
STATE_UNREACHABLE = "unreachable"


class ReconnectPolicy:
    """Failure-count state machine + backoff scheduler for one link.

    Not thread-safe by itself: the owning shipper/read-tier already
    serializes per-follower work, and tests drive it single-threaded.
    """

    def __init__(self, name: str, *,
                 base_s: Optional[float] = None,
                 cap_s: Optional[float] = None,
                 jitter: Optional[float] = None,
                 degraded_after: Optional[int] = None,
                 unreachable_after: Optional[int] = None,
                 seed: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.name = name
        self.base_s = env_float("REFLOW_NET_BACKOFF_BASE_S") \
            if base_s is None else base_s
        self.cap_s = env_float("REFLOW_NET_BACKOFF_CAP_S") \
            if cap_s is None else cap_s
        self.jitter = env_float("REFLOW_NET_BACKOFF_JITTER") \
            if jitter is None else jitter
        self.degraded_after = env_int("REFLOW_NET_DEGRADED_AFTER") \
            if degraded_after is None else degraded_after
        self.unreachable_after = env_int("REFLOW_NET_UNREACHABLE_AFTER") \
            if unreachable_after is None else unreachable_after
        if seed is None:
            seed = env_int("REFLOW_NET_FAULT_SEED")
        # crc32, not hash(): str hashing is salted per process and the
        # schedule must replay identically under the same seed
        self._rng = random.Random((seed << 32)
                                  ^ zlib.crc32(name.encode("utf-8")))
        self._clock = clock
        self.failures = 0          # consecutive, reset on success
        self.reconnects = 0        # successes that ended a failure run
        self.last_backoff_s = 0.0  # most recent scheduled delay
        self._retry_at = clock()   # next attempt allowed at this time
        self._state = STATE_CONNECTING

    @property
    def state(self) -> str:
        return self._state

    def ok(self) -> bool:
        """Record a successful exchange; returns True when this success
        ended a failure run (i.e. the link just *re*connected)."""
        recovered = self.failures > 0 or self._state == STATE_CONNECTING
        was_down = self.failures > 0
        if was_down:
            self.reconnects += 1
        self.failures = 0
        self.last_backoff_s = 0.0
        self._retry_at = self._clock()
        self._state = STATE_HEALTHY
        return recovered and was_down

    def failed(self) -> float:
        """Record a link failure; schedules the next attempt and
        returns the chosen backoff delay in seconds."""
        self.failures += 1
        if self.failures >= self.unreachable_after:
            self._state = STATE_UNREACHABLE
        elif self.failures >= self.degraded_after:
            self._state = STATE_DEGRADED
        raw = min(self.cap_s, self.base_s * (2 ** (self.failures - 1)))
        factor = 1.0 + self.jitter * self._rng.uniform(-1.0, 1.0)
        self.last_backoff_s = raw * factor
        self._retry_at = self._clock() + self.last_backoff_s
        return self.last_backoff_s

    def due(self) -> bool:
        """May the next attempt go out yet? (The caller polls this from
        its pump loop instead of sleeping.)"""
        return self._clock() >= self._retry_at

    def seconds_until_due(self) -> float:
        return max(0.0, self._retry_at - self._clock())

    def snapshot(self) -> dict:
        """State for ship-state.json's transport section and the
        ``replica.<name>.conn_state`` gauge."""
        return {
            "state": self._state,
            "failures": self.failures,
            "reconnects": self.reconnects,
            "last_backoff_s": round(self.last_backoff_s, 6),
        }
