"""Reading a device trace: ``torch.profiler`` (CUPTI) over ticks the
harness drives itself (``harness._replay``), reduced to device
intervals, busy time, the top device operations and the longest idle
gaps (named by the program's spans around them).

A trace that holds no device operation gives no device metric: the
harness never puts a host-derived number in a device metric's place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType

#: names of device-side copies of profiler ranges: spans, not operations
RANGE_PREFIXES = ("reflow::", "reflow.window")


def profiler() -> torch.profiler.profile:
    """A profiler of the card alone (CUPTI's records, no host operations:
    recording the host's operations made a traced tick 25 times slower).
    It is started and stopped on the thread that launches the traced
    work: with torch 2.11 on an H100 a profiler started on one thread
    lost the device operations that the frontend's pump thread launched
    (PERF.md), so the harness traces ticks it drives itself."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts = [torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


@dataclasses.dataclass
class Slice:
    """One traced slice: device operations ``(start us, end us, name)``,
    host operations likewise, the slice's wall seconds on the host clock,
    the scheduler's tick horizon at its two ends, and the configuration's
    records of the writes each traced tick carried."""

    device: List[Tuple[float, float, str]]
    host: List[Tuple[float, float, str]]
    window_s: float
    tick_a: int
    tick_b: int
    tick_infos: Dict[int, List[dict]] = dataclasses.field(
        default_factory=dict)

    def merged(self) -> List[List[float]]:
        out: List[List[float]] = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) / 1e6

    def kernel_us(self, *needles: str) -> Tuple[int, float]:
        """Launches and device microseconds of the operations whose name
        holds every needle."""
        hits = [b - a for a, b, n in self.device
                if all(x in n for x in needles)]
        return len(hits), sum(hits)

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest
        idle gaps named by the innermost span of the program's host
        threads around their middle."""
        by: Dict[str, float] = {}
        for a, b, name in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        m = self.merged()
        gaps = sorted(((m[i + 1][0] - m[i][1], m[i][1], m[i + 1][0])
                       for i in range(len(m) - 1)), reverse=True)[:n]
        out = []
        for g, a, b in gaps:
            mid = (a + b) / 2
            around = [(e - s, name) for s, e, name in self.host
                      if s <= mid <= e]
            out.append([min(around)[1] if around else "no program span",
                        g / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}


#: the marker the harness launches on an idle stream right before the
#: traced ticks: its device start is the host time it was launched at,
#: which places the program's spans (host clock) on the trace's clock
MARK_NUMEL = 7


def read(prof, window_s: float, tick_a: int, tick_b: int,
         mark_host_s: float, spans) -> Slice:
    """The slice's device operations, and the program's spans
    (``(name, ts_s, dur_s)`` on the host clock) placed on the trace's
    clock by the marker, the first device operation of the trace."""
    dev = []
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not e.name.startswith(RANGE_PREFIXES)):
            dev.append((e.time_range.start, e.time_range.end, e.name))
    dev.sort()
    host = []
    if dev:
        off = mark_host_s * 1e6 - dev[0][0]
        host = [(ts * 1e6 - off, (ts + dur) * 1e6 - off, name)
                for name, ts, dur in spans]
        dev = dev[1:]
    return Slice(dev, host, window_s, tick_a, tick_b)
