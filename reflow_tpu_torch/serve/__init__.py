"""Serving layer: backpressured multi-producer admission onto one
scheduler (:class:`IngestFrontend`), with its tickets, queues,
coalescing window and byte budget; many named graphs behind one shared
budget and one pump pool with deficit-weighted round-robin QoS
(:class:`ServeTier`), self-healing under the :class:`ControlPlane`;
ingestion over the wire (:class:`RpcIngestServer`,
:class:`RemoteProducer`); read replicas that follow a durable leader's
shipped log (:class:`ReplicaScheduler`), the read tier that routes reads
across them by published horizon (:class:`ReadTier`), and epoch-fenced
leader failover (:class:`FailoverCoordinator`)."""

from .budget import AdmissionBudget, BudgetShare
from .coalesce import CoalesceWindow, Feed, build_feeds
from .control import (Autoscaler, BrownoutLadder, CircuitBreaker,
                      ControlConfig, ControlPlane, SLOSpec,
                      load_slo_specs)
from .failover import (ElectionPolicy, FailoverCoordinator,
                       HighestHorizonElection)
from .frontend import IngestFrontend
from .queues import batch_nbytes
from .read import LeaderReadAdapter, ReadResult, ReadTier, StaleRead
from .replica import ReplicaScheduler
from .rpc import (RemoteProducer, RemoteTicket, RpcIngestServer,
                  SubmitAck, SubmitReq, TicketResolve)
from .tickets import (APPLIED, DEDUPED, REJECTED, SHED, FrontendClosed,
                      PumpCrashed, Ticket, TicketResult)
from .tier import GraphConfig, GraphHandle, ServeTier, dwrr_pick

__all__ = [
    "APPLIED", "DEDUPED", "REJECTED", "SHED",
    "AdmissionBudget", "Autoscaler", "BrownoutLadder", "BudgetShare",
    "CircuitBreaker", "CoalesceWindow", "ControlConfig", "ControlPlane",
    "ElectionPolicy", "FailoverCoordinator", "Feed", "FrontendClosed",
    "GraphConfig", "GraphHandle", "HighestHorizonElection",
    "IngestFrontend", "LeaderReadAdapter", "PumpCrashed", "ReadResult",
    "ReadTier", "RemoteProducer", "RemoteTicket", "ReplicaScheduler",
    "RpcIngestServer", "SLOSpec", "ServeTier", "StaleRead", "SubmitAck",
    "SubmitReq", "Ticket", "TicketResolve", "TicketResult",
    "batch_nbytes", "build_feeds", "dwrr_pick", "load_slo_specs",
]
