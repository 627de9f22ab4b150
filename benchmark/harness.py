"""The harness: one run of one cell, driven by data.

It knows no cell by name. It reads ``BENCHMARK.json`` and loads, by the
names found there:

- ``configs/<config>.json`` (the configuration as it is run) and
  ``configs/<config>.py`` (its ``Deployment``: builds the system and
  makes the data from the seed);
- ``traffic/<traffic>.json``, a mix that ``generator.py`` turns into a
  schedule of writes;
- ``reference/<config>.py``, the plain reference that judges the output;
- ``layer_metrics/<metric>.py`` for each per-layer metric of the cell.

A run: set-up (build, data, warm-up through the same path), then the
window of ``seconds``, then every write due in it is waited for, the
output is read, the program's state freed, and the reference judges the
output. Freshness of a write runs from the moment it was due to the
moment a read of the maintained table would return its effect: the
harness records a CUDA event on the program's stream when it sees the
write's ticket APPLIED, and the later of the two moments counts. Once
the window is over, every run replays the mix's ``replay`` ticks under
the profiler (``_replay``): the delta rows they carried over the
device's busy seconds are ``device_rows_per_s``. A traced run has the
program's spans on, every ticket sampled.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import queue
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import devtrace, generator

HERE = Path(__file__).resolve().parent
#: a write not resolved this long after the window closed has failed
RESOLVE_GRACE_S = 60.0
#: the sender's last word to the watcher
END = -1


#: threads of the frontend's pump (the program's thread that runs ticks)
PUMP_THREAD = "reflow-ingest-pump"


def pin_pump() -> None:
    """The pump thread alone on the first CPU of the process's set, every
    other thread of the process (the harness's, the CUDA runtime's) on
    the rest: each run then puts its threads on the same CPUs, where the
    scheduler would place them anew in every process."""
    cpus = sorted(os.sched_getaffinity(0))
    pumps = {t.native_id for t in threading.enumerate()
             if t.name == PUMP_THREAD}
    if len(cpus) < 2 or not pumps:
        return
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus[:1] if int(tid) in pumps
                                 else cpus[1:])
        except OSError:  # a thread that ended meanwhile
            pass


class Refused(RuntimeError):
    """The run cannot be made as asked (no card, a bad cell, traffic that
    would run out of ids); nothing is measured."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A benchmark module found by file name (names may hold ``-`` and
    ``.``, which an import statement cannot)."""
    if not path.exists():
        raise Refused(f"{path.relative_to(HERE.parent)} does not exist")
    name = "benchmark._found." + path.stem.replace("-", "_").replace(
        ".", "_") + "_" + path.parent.name
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with what its names point at."""

    name: str
    chips: int
    cfg: dict
    mix: dict
    config_dir: Path
    config: str
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(bench: dict, name: str, root: Path = HERE) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json "
                      f"(has {sorted(cells)})")
    w = cells[name]

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, int(w["chips"]),
                load_json(root / "configs" / f"{w['config']}.json"),
                load_json(root / "traffic" / f"{w['traffic']}.json"),
                root / "configs", w["config"],
                [m for m in bench["end_to_end"] if here(m)],
                [m for m in bench["per_layer"] if here(m)])


@dataclasses.dataclass
class WriteRec:
    """One write of the window: when it was due, sent, seen APPLIED and
    visible (host seconds), its status, tick and the configuration's
    record of it (items, rows, ...)."""

    due: float
    info: dict
    sent: float = float("nan")
    seen: float = float("nan")
    visible: float = float("nan")
    status: str = "unsent"
    tick: Optional[int] = None
    batch_id: str = ""
    ticket: object = None
    event: object = None


@dataclasses.dataclass
class Run:
    """What a finished run hands to the per-layer metrics' readers."""

    cell: Cell
    seconds: float
    t0: float
    writes: List[WriteRec]
    #: ticket stage seconds by batch id (traced runs)
    stages: Dict[str, Dict[str, float]]
    #: loop passes and ticks of the window's TickResults
    passes: int
    ticks: int
    #: the replayed ticks' device trace
    slice: Optional[devtrace.Slice]
    device_kind: str

    @property
    def in_window(self) -> List[WriteRec]:
        end = self.t0 + self.seconds
        return [w for w in self.writes
                if w.status == "applied" and w.visible <= end]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "unknown"


class _Clock:
    """Host time of CUDA events recorded on the program's stream."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        if not self.cuda:
            return
        torch.cuda.synchronize(device)
        best = None
        for _ in range(7):
            h0 = time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            ev.synchronize()
            h1 = time.perf_counter()
            if best is None or h1 - h0 < best[1] - best[0]:
                best = (h0, h1, ev)
        self.host0 = (best[0] + best[1]) / 2
        self.ev0 = best[2]

    def mark(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def host(self, ev) -> float:
        return self.host0 + self.ev0.elapsed_time(ev) / 1e3


def _settle(rec: WriteRec, deadline: float, clock: _Clock) -> None:
    """Wait for a write's ticket and stamp the moment it was seen."""
    try:
        res = rec.ticket.result(timeout=max(0.0,
                                            deadline - time.perf_counter()))
        rec.status = res.status
        rec.tick = res.tick
    except TimeoutError:
        rec.status = "unresolved"
    except Exception as e:  # noqa: BLE001 - a failed write is counted
        rec.status = f"error: {e!r}"[:200]
    rec.seen = time.perf_counter()
    rec.event = clock.mark()


def _open_loop(dep, phase: str, recs: List[WriteRec], t0: float,
               end: Optional[float], clock: _Clock) -> threading.Thread:
    """Send each write at its due time from one thread, up to ``end``, and
    watch the tickets from another; returns the watcher, which ends when
    every ticket sent has been seen or its deadline passed."""
    sent: "queue.SimpleQueue[int]" = queue.SimpleQueue()
    span = max((r.due for r in recs), default=0.0)
    deadline = t0 + span + RESOLVE_GRACE_S

    def send():
        for i, r in enumerate(recs):
            r.due = t0 + r.due
            if end is not None and r.due >= end:
                break
            wait = r.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            r.sent = time.perf_counter()
            r.batch_id = f"{phase}-{i}"
            r.ticket = dep.submit(phase, i, r.batch_id)
            sent.put(i)
        sent.put(END)

    def watch():
        i = sent.get()
        while i != END:
            _settle(recs[i], deadline, clock)
            seen, ev = recs[i].seen, recs[i].event
            # tickets sent before that moment and resolved by now share
            # the moment and the event
            i = sent.get()
            while (i != END and recs[i].sent <= seen
                   and recs[i].ticket.done()):
                _settle(recs[i], deadline, clock)
                recs[i].seen, recs[i].event = seen, ev
                i = sent.get()

    sender = threading.Thread(target=send, name="bench-sender", daemon=True)
    watcher = threading.Thread(target=watch, name="bench-watcher",
                               daemon=True)
    watcher.start()
    sender.start()
    watcher.sender = sender
    return watcher


def _closed_loop(dep, phase: str, recs: List[WriteRec], t0: float,
                 end: Optional[float], clock: _Clock) -> threading.Thread:
    """One writer: each write is due when the last one was seen applied.
    With ``end``, it stops sending at ``end``; the writes it made ready
    must last until then."""

    def write():
        due = t0
        for i, r in enumerate(recs):
            if end is not None and due >= end:
                return
            r.due = r.sent = due
            r.batch_id = f"{phase}-{i}"
            r.ticket = dep.submit(phase, i, r.batch_id)
            if i + 1 < len(recs) and hasattr(dep, "prepare"):
                dep.prepare(phase, i + 1)
            _settle(r, due + RESOLVE_GRACE_S, clock)
            due = r.seen
        if end is not None and due < end:
            raise Refused(f"the {len(recs)} writes made ready ran out "
                          f"before the window closed: raise the mix's "
                          f"max_rate_per_s")

    def guarded():
        try:
            write()
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            th.error = e

    th = threading.Thread(target=guarded, name="bench-writer", daemon=True)
    th.error = None
    th.start()
    return th


def _drive(dep, mix: dict, phase: str, recs: List[WriteRec], t0: float,
           end: Optional[float], clock: _Clock) -> threading.Thread:
    if mix["loop"] == "open":
        return _open_loop(dep, phase, recs, t0, end, clock)
    return _closed_loop(dep, phase, recs, t0, end, clock)


def _stages(recs: List[WriteRec]) -> Dict[str, Dict[str, float]]:
    from reflow_tpu_torch.obs import trace

    want = {r.batch_id for r in recs}
    out: Dict[str, Dict[str, float]] = {}
    for track, ev in trace.events():
        if not track.startswith("ticket/"):
            continue
        bid = track[len("ticket/"):]
        if bid in want and ev[0] in trace.STAGES:
            out.setdefault(bid, {})[ev[0]] = ev[2]
    return out


def _replay(dep, first: int, mix: dict, dev) -> devtrace.Slice:
    """The traced slice: with the pump paused after the window, the
    harness drives the mix's ``replay`` ticks itself (``writes_per_tick``
    of the schedule's next unsent writes coalesced into each; in an open
    loop, the replay's own writes), back to back under the profiler.
    These writes are part of the run's input like any other."""
    from reflow_tpu_torch import DeltaBatch

    ticks, per_tick = generator.replay_size(mix)
    n = min(ticks, (len(dep.info["window"]) - first) // per_tick)
    feeds, infos = [], []
    for t in range(n):
        idx = range(first + t * per_tick, first + (t + 1) * per_tick)
        feeds.append(DeltaBatch.concat([dep.batch("window", i)
                                        for i in idx]))
        infos.append([dep.info["window"][i] for i in idx])
    dep.fe.pause()
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof = devtrace.profiler()
        tick_a = dep.sched._tick
        prof.__enter__()
        mark = time.perf_counter()
        torch.zeros(devtrace.MARK_NUMEL, device=dev)
        for f in feeds:
            dep.sched.tick_many([{dep.source: f}])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        p1 = time.perf_counter()
        prof.__exit__(None, None, None)
    finally:
        dep.fe.resume()
    sl = devtrace.read(prof, p1 - mark, tick_a, dep.sched._tick, mark,
                       _spans(mark, p1))
    sl.tick_infos = {tick_a + 1 + t: i for t, i in enumerate(infos)}
    return sl


def _spans(t_a: float, t_b: float) -> List[tuple]:
    """The program's spans (ticket stages left out) that overlap ``[t_a,
    t_b]``, as ``(name, ts, dur)`` on the host clock."""
    from reflow_tpu_torch.obs import trace

    return [(ev[0], ev[1], ev[2]) for track, ev in trace.events()
            if not track.startswith("ticket/") and ev[1] < t_b
            and ev[1] + ev[2] > t_a]


def _set_tracing(on: bool) -> None:
    """Program spans on for a traced run, every ticket sampled, rings
    large enough for the window (the run's environment says the same
    before the program is imported)."""
    from reflow_tpu_torch.obs import trace

    if on:
        trace.SAMPLE_EVERY = 1
        trace.RING_CAPACITY = max(trace.RING_CAPACITY, 1 << 20)
        trace.reset()
        trace.enable()
    else:
        trace.disable()


def _host_probe(dev) -> Dict[str, float]:
    """The host's speed after the window, for the run's record: the
    median milliseconds of a fixed Python loop, and of 200 small launches
    on the card and a sync (the fused loop's work is such launches)."""
    py, launch = [], []
    for _ in range(5):
        a = time.perf_counter()
        x = 0
        for i in range(100_000):
            x += i * i
        py.append(time.perf_counter() - a)
        if dev.type == "cuda":
            t = torch.zeros(1, device=dev)
            torch.cuda.synchronize(dev)
            a = time.perf_counter()
            for _ in range(200):
                t = t + 1
            torch.cuda.synchronize(dev)
            launch.append(time.perf_counter() - a)
    out = {"python_ms": float(np.median(py)) * 1e3}
    if launch:
        out["launch_ms"] = float(np.median(launch)) * 1e3
    return out


def _percentile(xs, p: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), p))


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             *, device: str = "cuda", t_start: Optional[float] = None,
             root: Path = HERE, cfg: Optional[dict] = None,
             mix: Optional[dict] = None, hook=None,
             pin: bool = False) -> dict:
    """One run of cell ``name``. Returns the result object (the last line
    of a run) with ``"run"`` beside it (counts, lateness, the checks).
    ``cfg`` and ``mix`` replace the cell's files (the CPU tests run tiny
    sizes so). ``hook(dep, phase, output)`` is called after set-up
    (``"setup"``) and on the output read after the window (``"output"``,
    returning the output to judge); the tests plant faults through it.
    ``pin`` pins the threads (``pin_pump``) before the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = cell(bench, name, root)
    if cfg is not None:
        c.cfg = cfg
    if mix is not None:
        c.mix = mix
    dev = torch.device(device)
    dep_mod = load_module(c.config_dir / f"{c.config}.py")
    ref_mod = load_module(root / "reference" / f"{c.config}.py")
    readers = {m["name"]: load_module(root / "layer_metrics"
                                      / f"{m['name']}.py")
               for m in c.per_layer} if trace else {}
    _set_tracing(trace)
    # the window's schedule ends with the replay's writes (``_replay``)
    warm, window = generator.schedule(c.mix, seed, seconds)
    dep = dep_mod.Deployment(c.cfg, c.mix, seed, device)
    try:
        dep.setup(warm, window)
    except ValueError as e:
        if type(e).__name__ == "TrafficRefused":
            raise Refused(str(e)) from e
        raise
    if hook is not None:
        hook(dep, "setup", None)
    clock = _Clock(dev)
    # the warm-up: the schedule's first part through the same path
    warm_recs = [WriteRec(w.due or 0.0, i) for w, i in
                 zip(warm, dep.info["warm"])]
    th = _drive(dep, c.mix, "warm", warm_recs, time.perf_counter(), None,
                clock)
    th.join()
    if getattr(th, "error", None) is not None:
        raise th.error
    dep.fe.flush()
    bad = [r.status for r in warm_recs if r.status != "applied"]
    if bad:
        raise RuntimeError(f"warm-up writes not applied: {bad[:3]}")
    if trace:
        _set_tracing(True)
    if pin:
        pin_pump()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    clock = _Clock(dev)
    hist0 = len(dep.sched.history)
    # the collector stays off inside the window: its pauses stall every
    # thread, and the heap it would walk holds the generator's own
    # records; what set-up made is frozen out of later collections
    gc.collect()
    gc.freeze()
    gc.disable()

    # -- the window --------------------------------------------------------
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    end = t0 + seconds
    recs = [WriteRec(w.due or 0.0, i) for w, i in
            zip(window, dep.info["window"])]
    th = _drive(dep, c.mix, "window", recs, t0, end, clock)
    time.sleep(max(0.0, end - time.perf_counter()))
    th.join(timeout=RESOLVE_GRACE_S + 2 * seconds)
    if getattr(th, "error", None) is not None:
        raise th.error
    if getattr(th, "sender", None) is not None:
        th.sender.join(timeout=RESOLVE_GRACE_S)
    recs = [r for r in recs if r.ticket is not None and r.due < end]
    dep.fe.flush(timeout=RESOLVE_GRACE_S)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for r in recs:
        r.visible = (max(r.seen, clock.host(r.event))
                     if r.event is not None else r.seen)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    gc.enable()
    passes = []
    for res in dep.sched.history[hist0:]:
        res.block()
        passes.append(res.passes)
    hist = dep.sched.history
    ticks = (hist[-1].tick - (hist[hist0 - 1].tick if hist0 else 0)
             if len(hist) > hist0 else 0)
    stages = _stages(recs) if trace else {}
    n_sent = len(recs)
    sl = _replay(dep, n_sent, c.mix, dev)
    replayed = [i for v in sl.tick_infos.values() for i in v]
    n_sent += len(replayed)
    output = dep.output()
    if hook is not None:
        output = hook(dep, "output", output)
    probe = _host_probe(dev)
    inputs = dep.inputs(len(warm_recs), n_sent)
    dep.close()
    del dep
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- what the run measured ---------------------------------------------
    applied = [r for r in recs if r.status == "applied"]
    failed = len(recs) - len(applied)
    fresh_ms = [(r.visible - r.due) * 1e3 for r in applied]
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    run = Run(c, seconds, t0, recs, stages, sum(passes), ticks, sl, kind)
    checks = ref_mod.judge(c.cfg, inputs, output, dev)
    limits = c.cfg["checks"]
    correct = all(checks[k] <= limits[k] for k in limits)
    metrics: Dict[str, dict] = {}
    if not trace:
        values = {"setup_s": setup_s}
        values["ingest_rows_per_s"] = (sum(r.info["rows"]
                                           for r in run.in_window)
                                       / seconds)
        if sl.device:
            values["device_rows_per_s"] = (sum(i["rows"] for i in replayed)
                                           / sl.busy_s)
        for m in c.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in c.per_layer:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    late = [(r.sent - r.due) * 1e3 for r in recs]
    result = {
        "correct": correct, "attempted": len(recs), "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": c.chips,
                   "memory_peak_bytes": int(peak)},
    }
    if trace and sl.device:
        result["device"]["busy_s"] = sl.busy_s
        result["device"]["window_s"] = sl.window_s
        result["breakdown"] = sl.breakdown()
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    result["run"] = {
        "workload": name, "seed": seed, "seconds": seconds, "trace": trace,
        "setup_s": setup_s, "writes_due": len(recs),
        "writes_applied": len(applied),
        "writes_visible_in_window": len(run.in_window),
        "warm_writes": len(warm_recs),
        "ticks": ticks, "passes": sum(passes),
        "lateness_ms_p50": _percentile(late, 50) if late else None,
        "lateness_ms_max": max(late) if late else None,
        "freshness_samples": len(fresh_ms),
        "freshness_p50_ms": _percentile(fresh_ms, 50) if fresh_ms else None,
        "freshness_p95_ms": _percentile(fresh_ms, 95) if fresh_ms else None,
        "replay": {"ticks": len(sl.tick_infos), "writes": len(replayed),
                   "rows": sum(i["rows"] for i in replayed),
                   "busy_s": sl.busy_s if sl.device else None,
                   "window_s": sl.window_s},
        # a backlog that grows shows as a later third fresher than none
        "freshness_p50_ms_by_third": [
            _percentile(part, 50) if len(part) else None
            for part in np.array_split(np.asarray(fresh_ms), 3)],
        "statuses": sorted({r.status for r in recs}),
        "host_probe": probe,
        # each applied write's due time (s into the window) and freshness
        "writes": [[round(r.due - t0, 6), round(f, 4)]
                   for r, f in zip(applied, fresh_ms)],
    }
    return result
