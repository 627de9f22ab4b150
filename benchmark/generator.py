"""The one traffic generator: a mix's parameters in, a schedule of writes
out.

A mix is a JSON file under ``traffic/``. Every seed gets the same set of
write sizes, gaps and operations, in an order drawn from the seed, so
that seeds change the order of the work and not its amount.

Keys of a mix:

- ``loop``: ``"open"`` (writes due on a schedule, whatever the system
  does) or ``"closed"`` (one writer sends the next write when the last
  one is applied).
- ``rate_per_s`` (open): mean arrivals a second; the gaps are the
  quantiles of an exponential distribution (Poisson arrivals).
- ``warm_s`` (open) / ``warm_writes`` (closed): the warm-up's traffic,
  run through the same path before the window and counted as set-up.
- ``max_rate_per_s`` (closed): the writes made ready for the window are
  ``seconds`` times this; a run that uses them all fails.
- ``size``: ``{"min": a, "max": b}``, items a write, uniform.
- ``mix``: operation name -> share of the items; the configuration
  knows what each operation does.
- ``replay``: ``{"ticks": t, "writes_per_tick": w}``, the ticks the
  harness drives itself once the window is over, ``w`` writes coalesced
  into each, under the profiler (``harness._replay``). Their ``t x w``
  writes follow the window's in the schedule, a set of sizes and
  operations of their own, so every seed replays the same amount of
  work; in an open loop they are due after the window and never sent.
- Anything else (``ids``, ``preload_docs``) is read by
  the configuration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark import datagen


@dataclasses.dataclass
class Write:
    """One write of a schedule: when it is due (seconds from the start of
    its phase; None in a closed loop) and its items by operation."""

    due: Optional[float]
    ops: Dict[str, int]


def _sizes(n: int, lo: int, hi: int, r: np.random.Generator) -> np.ndarray:
    """``n`` sizes spread evenly over ``lo..hi``, in a seeded order."""
    span = hi - lo + 1
    s = lo + ((np.arange(n) + 0.5) * span / n).astype(np.int64)
    return r.permutation(np.minimum(s, hi))


def _split(sizes: np.ndarray, mix: Dict[str, float],
           r: np.random.Generator) -> List[Dict[str, int]]:
    """The items of all writes labelled by operation in the mix's shares
    (largest remainders), shuffled, and cut into the writes."""
    names = sorted(mix)
    total = int(sizes.sum())
    want = np.array([mix[k] for k in names], np.float64)
    want = want / want.sum() * total
    counts = np.floor(want).astype(np.int64)
    for j in np.argsort(-(want - counts))[:total - int(counts.sum())]:
        counts[j] += 1
    labels = r.permutation(np.repeat(np.arange(len(names)), counts))
    out, at = [], 0
    for s in sizes:
        c = np.bincount(labels[at:at + s], minlength=len(names))
        out.append({k: int(c[j]) for j, k in enumerate(names) if c[j]})
        at += s
    return out


def _phase(mix: dict, n: int, rate: Optional[float],
           r: np.random.Generator) -> List[Write]:
    if n <= 0:
        return []
    sizes = _sizes(n, int(mix["size"]["min"]), int(mix["size"]["max"]), r)
    ops = _split(sizes, mix["mix"], r)
    if rate is None:
        return [Write(None, o) for o in ops]
    q = (np.arange(n) + 0.5) / n
    gaps = r.permutation(-np.log1p(-q) / rate)
    due = np.cumsum(gaps) - gaps[0]
    return [Write(float(d), o) for d, o in zip(due, ops)]


def replay_size(mix: dict) -> Tuple[int, int]:
    """``(ticks, writes_per_tick)`` of the mix's replay."""
    r = mix["replay"]
    return int(r["ticks"]), int(r["writes_per_tick"])


def schedule(mix: dict, seed: int, seconds: float
             ) -> Tuple[List[Write], List[Write]]:
    """The warm-up's writes and the window's, for one run; the window's
    list ends with the replay's writes. In an open loop every write of
    the window proper is due before ``seconds`` (the gaps' quantiles sum
    to less), and the replay's are due from ``seconds`` on."""
    if mix["loop"] == "open":
        rate = float(mix["rate_per_s"])
        n_warm = int(round(rate * float(mix["warm_s"])))
        n_win = int(round(rate * seconds))
    elif mix["loop"] == "closed":
        rate = None
        n_warm = int(mix["warm_writes"])
        n_win = int(math.ceil(float(mix["max_rate_per_s"]) * seconds))
    else:
        raise ValueError(f"loop {mix['loop']!r} is neither open nor closed")
    ticks, per_tick = replay_size(mix)
    warm = _phase(mix, n_warm, rate, datagen.rng(seed, 1))
    window = _phase(mix, n_win, rate, datagen.rng(seed, 2))
    replay = _phase(mix, ticks * per_tick, rate, datagen.rng(seed, 3))
    if rate is not None:
        for w in replay:
            w.due += seconds
    return warm, window + replay
