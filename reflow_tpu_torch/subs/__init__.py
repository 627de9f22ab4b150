"""Reactive reads: push-based standing queries with delta fan-out.

The incremental dataflow computes exactly what changed every commit
window; this package stops throwing that away. Clients register
standing queries (``view`` / ``lookup`` / ``topk``) against a replica
and receive only the per-query delta per window — over the wire or
in-process — with a one-integer cursor making reconnect resume
gap-free and duplicate-free. See docs/guide.md "Reactive reads".

The port's copy of ``reflow_tpu/subs/``: frames, requests and replies
are the JAX package's plain tuples, so either package's ``Subscriber``
resumes against the other's ``SubscriptionServer``.
"""

from reflow_tpu_torch.subs.client import Subscriber
from reflow_tpu_torch.subs.hub import SubHandle, SubscriptionHub
from reflow_tpu_torch.subs.query import (DeltaFrame, QueryState, StandingQuery,
                                   canon_query, merge_frames)
from reflow_tpu_torch.subs.wire import SubAck, SubscribeReq, SubscriptionServer

__all__ = ["Subscriber", "SubHandle", "SubscriptionHub", "DeltaFrame",
           "QueryState", "StandingQuery", "canon_query", "merge_frames",
           "SubAck", "SubscribeReq", "SubscriptionServer"]
