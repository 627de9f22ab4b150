"""What several readers share: ticket stages of the window's writes, and
the scoring a k-NN tick needs."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from benchmark import kernel_counts

#: the profiler's names of the top-k kernel's two entries
TOPK = ("topk_cluster_kernel", "RowSource")
TOPK_MERGE = ("topk_cluster_kernel", "MergeSource")


def stage_ms(run, *names: str) -> List[float]:
    """Per applied window write, the summed ms of the named stages."""
    out = []
    for w in run.writes:
        st = run.stages.get(w.batch_id)
        if w.status == "applied" and st and all(n in st for n in names):
            out.append(sum(st[n] for n in names) * 1e3)
    return out


def freshness_ms(run) -> List[float]:
    """Per applied window write, the ms from its due time to the moment
    a read of the maintained table would return its effect."""
    return [(w.visible - w.due) * 1e3 for w in run.writes
            if w.status == "applied"]


def percentile(xs, p: float) -> Optional[float]:
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else None


def ticks(run, writes=None) -> Dict[int, List[dict]]:
    """The configuration's records of the applied window writes (or of
    ``writes``), by the tick that committed them."""
    out: Dict[int, List[dict]] = {}
    for w in run.writes if writes is None else writes:
        if w.status == "applied" and w.tick is not None:
            out.setdefault(w.tick, []).append(w.info)
    return out


def knn_tick_ops(cfg: dict, infos: List[dict]) -> int:
    """Scoring operations a k-NN tick needs: every live document on a
    rescan (an update or a delete in the tick), the inserted ones on an
    incremental tick."""
    q, dim = int(cfg["queries"]), int(cfg["dim"])
    if any(i["rescan"] for i in infos):
        docs = infos[-1]["live_after"]
    else:
        docs = sum(i["insert"] for i in infos)
    return kernel_counts.score_ops(q, dim, docs)
