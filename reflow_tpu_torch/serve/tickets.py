"""Tickets: the producer-facing completion objects of the frontend.

``IngestFrontend.submit`` returns a :class:`Ticket` immediately; the
pump thread resolves it once the micro-batch's fate is decided. A
ticket always resolves with a :class:`TicketResult` — admission-control
outcomes (dedup, backpressure rejection, shed) are *reported*, never
silently dropped — except when the frontend itself dies, in which case
``result()`` raises (:class:`PumpCrashed` / :class:`FrontendClosed`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

__all__ = ["APPLIED", "DEDUPED", "REJECTED", "SHED", "FrontendClosed",
           "PumpCrashed", "Ticket", "TicketResult"]

#: the batch folded into the graph at ``TicketResult.tick``
APPLIED = "applied"
#: the batch's id was already accepted (exactly-once dedup)
DEDUPED = "deduped"
#: backpressure refused admission (``reject`` policy, oversized batch,
#: or a ``block`` admission that timed out)
REJECTED = "rejected"
#: the ``shed-oldest`` policy evicted this already-admitted batch to
#: make room for a newer one — the upstream must re-send it
SHED = "shed"


class FrontendClosed(RuntimeError):
    """The frontend is closed (or closing): the submission was not
    admitted, and blocked producers have been released."""


class PumpCrashed(FrontendClosed):
    """The pump thread died mid-flight; the scheduler's durable state
    (if any) is whatever the WAL holds — recover and resubmit."""


@dataclasses.dataclass
class TicketResult:
    """Final fate of one submitted micro-batch."""

    status: str                  # APPLIED / DEDUPED / REJECTED / SHED
    batch_id: str
    #: scheduler tick the batch committed in (APPLIED only)
    tick: Optional[int] = None
    #: how many OTHER micro-batches were coalesced into the same feed
    #: entry (APPLIED only; >0 means the merge path engaged)
    coalesced_with: int = 0
    reason: Optional[str] = None
    #: WAL LSN the batch's window committed under (APPLIED on a durable
    #: scheduler only — resolution gated on ``wal.wait_durable(lsn)``)
    lsn: Optional[int] = None

    @property
    def applied(self) -> bool:
        return self.status == APPLIED


class Ticket:
    """Thread-safe future for one submission. Producers ``result()`` or
    poll ``done()``; only the frontend resolves it."""

    __slots__ = ("batch_id", "trace", "_event", "_result", "_error")

    def __init__(self, batch_id: str):
        self.batch_id = batch_id
        #: obs.trace.TraceCtx when tracing is enabled at submit time;
        #: the pump reads it to emit the ticket's stage timeline
        self.trace = None
        self._event = threading.Event()
        self._result: Optional[TicketResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> TicketResult:
        """Block until resolved. Raises the frontend's failure (e.g.
        :class:`PumpCrashed`) instead of returning when the batch's fate
        was never decided; raises ``TimeoutError`` on timeout."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"ticket {self.batch_id!r} unresolved after {timeout}s")
        if self._error is not None:
            raise self._error
        if self._result is None:
            raise RuntimeError(
                f"ticket {self.batch_id!r} resolved with neither result "
                f"nor error")
        return self._result

    # -- frontend side -----------------------------------------------------

    def _resolve(self, result: TicketResult) -> None:
        self._result = result
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()
