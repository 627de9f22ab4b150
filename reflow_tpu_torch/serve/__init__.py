"""Serving layer: backpressured multi-producer admission onto one
scheduler (:class:`IngestFrontend`), with its tickets, queues,
coalescing window and byte budget."""

from .budget import AdmissionBudget, BudgetShare
from .coalesce import CoalesceWindow, Feed, build_feeds
from .frontend import IngestFrontend
from .queues import batch_nbytes
from .tickets import (APPLIED, DEDUPED, REJECTED, SHED, FrontendClosed,
                      PumpCrashed, Ticket, TicketResult)

__all__ = ["AdmissionBudget", "BudgetShare", "CoalesceWindow", "Feed",
           "build_feeds", "IngestFrontend", "batch_nbytes", "APPLIED",
           "DEDUPED", "REJECTED", "SHED", "FrontendClosed", "PumpCrashed",
           "Ticket", "TicketResult"]
