"""Operator library: Map, Filter, GroupBy, Reduce, Join, Union.

SURVEY.md §2 items 2–6. Each op defines pure functional incremental
semantics ``(state, in_deltas) -> (state', out_deltas)`` over the multiset
delta algebra (see ``delta.py``). The definitions here are the host-side
oracle semantics (exact, dict/Counter-based); the device executor lowers
the same ops to padded device tensors (``executors/cuda.py``, KnnIndex so
far) and is differentially tested against these.
"""

from reflow_tpu_torch.ops.core import (
    Op,
    Map,
    Filter,
    GroupBy,
    Reduce,
    Join,
    Union,
    REDUCERS,
)
from reflow_tpu_torch.ops.knn import KnnIndex

__all__ = ["Op", "Map", "Filter", "GroupBy", "Reduce", "Join", "Union",
           "KnnIndex", "REDUCERS"]
