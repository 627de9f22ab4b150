"""Serving layer: backpressured multi-producer admission onto one
scheduler (:class:`IngestFrontend`), with its tickets, queues,
coalescing window and byte budget; read replicas that follow a durable
leader's shipped log (:class:`ReplicaScheduler`), the read tier that
routes reads across them by published horizon (:class:`ReadTier`), and
epoch-fenced leader failover (:class:`FailoverCoordinator`)."""

from .budget import AdmissionBudget, BudgetShare
from .coalesce import CoalesceWindow, Feed, build_feeds
from .failover import (ElectionPolicy, FailoverCoordinator,
                       HighestHorizonElection)
from .frontend import IngestFrontend
from .queues import batch_nbytes
from .read import LeaderReadAdapter, ReadResult, ReadTier, StaleRead
from .replica import ReplicaScheduler
from .tickets import (APPLIED, DEDUPED, REJECTED, SHED, FrontendClosed,
                      PumpCrashed, Ticket, TicketResult)

__all__ = ["AdmissionBudget", "BudgetShare", "CoalesceWindow", "Feed",
           "build_feeds", "ElectionPolicy", "FailoverCoordinator",
           "HighestHorizonElection", "IngestFrontend", "batch_nbytes",
           "LeaderReadAdapter", "ReadResult", "ReadTier", "StaleRead",
           "ReplicaScheduler", "APPLIED", "DEDUPED", "REJECTED", "SHED",
           "FrontendClosed", "PumpCrashed", "Ticket", "TicketResult"]
