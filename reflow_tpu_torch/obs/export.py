"""Exporters: trace rings → Chrome trace-event JSON (Perfetto-viewable).

``export_chrome_trace()`` snapshots every thread's ring and writes the
standard ``{"traceEvents": [...]}`` object: one ``"X"`` complete event
per span (``ts``/``dur`` in microseconds relative to the earliest
buffered event), one *track* per recording thread — pump workers,
producers — plus override tracks (``wal``, ``ticket/<batch_id>``)
surfaced as their own rows via ``thread_name`` metadata events. Open
the file at https://ui.perfetto.dev or ``chrome://tracing``.

``ticket_timelines()`` is the shared reader: given a chrome event list
it reconstructs each sampled ticket's stage durations and end-to-end
span. :func:`causal_groups` stitches the spans that share causality
tokens into one write's cross-process journey, and :func:`full_chains`
counts the journeys that carry every link of :data:`FULL_CHAIN`, the
follow-the-write chain from the producer's submit to the subscriber's
delivery.

The port's copy of ``reflow_tpu/obs/export.py``: the file layout is the
JAX package's, so ``tools/trace_inspect.py`` and the JAX
``ticket_timelines`` read a port trace as they read a JAX one. The chain
reader is the port's own copy of the grouping in
``tools/trace_inspect.py`` (the JAX tool imports the JAX package).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from . import trace

__all__ = ["FULL_CHAIN", "causal_groups", "chrome_events",
           "export_chrome_trace", "full_chains", "ticket_timelines"]

#: the canonical follow-the-write chain, producer keystroke to
#: subscriber-visible answer (``tools/trace_inspect.py``'s): a causal
#: group carrying all nine links is a *full chain*
FULL_CHAIN = ("producer_submit", "rpc_admit", "admission", "wal_append",
              "ship_segment", "net_send", "replica_replay",
              "sub_fanout", "sub_deliver")


def chrome_events() -> List[Dict[str, Any]]:
    """Snapshot all rings into a chrome trace-event list (metadata
    events first, then ``"X"`` spans). Empty when nothing was traced.

    A ring that wrapped has silently overwritten its oldest events —
    which can truncate a causal chain mid-window — so each wrapped
    ring's track carries a ``dropped_events`` metadata event with the
    exact overwrite count (``Ring.n`` counts every put ever, so drops
    are ``n - cap``); readers must treat such tracks as incomplete
    rather than assuming the window starts at the first surviving
    event. The card's ``device_tick`` spans (``trace.device_events``)
    are written too, on their ``device/<label>`` tracks, on the host
    clock of the rest."""
    return _snapshot()[0]


def _snapshot() -> tuple:
    """``(chrome_events, base_time_s)`` from one ring snapshot — the
    base is computed from the same events, so ``baseTimeS`` in the
    exported file can never drift from the ``ts`` values."""
    with trace._rings_lock:
        rings = list(trace._rings)
    dev = trace._device_ring()
    if dev is not None:
        rings.append(dev)
    raw = []
    dropped: Dict[str, int] = {}
    for r in rings:
        n = r.n
        if n > r.cap:
            dropped[r.track] = dropped.get(r.track, 0) + (n - r.cap)
        for ev in r.events():
            raw.append((r.track, ev))
    if not raw:
        return [], 0.0
    base = min(ev[1] for _t, ev in raw)
    tids: Dict[str, int] = {}
    for t in dropped:
        tids[t] = len(tids) + 1
    spans = []
    for ring_track, (name, ts, dur, track, args) in raw:
        t = track or ring_track
        tid = tids.get(t)
        if tid is None:
            tid = tids[t] = len(tids) + 1
        e = {"name": name, "ph": "X", "cat": "reflow",
             "ts": round((ts - base) * 1e6, 3),
             "dur": round(dur * 1e6, 3), "pid": 1, "tid": tid}
        if args:
            e["args"] = args
        spans.append(e)
    meta: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "reflow"}}]
    for t, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "name": "thread_name", "pid": 1,
                     "tid": tid, "args": {"name": t}})
    for t, count in sorted(dropped.items()):
        meta.append({"ph": "M", "name": "dropped_events", "pid": 1,
                     "tid": tids[t], "args": {"track": t,
                                              "count": count}})
    return meta + spans, base


def export_chrome_trace(path: Optional[str] = None) -> str:
    """Write the chrome trace JSON; returns the path written
    (``REFLOW_TRACE_OUT`` or ``reflow_trace.json`` by default).

    Besides the standard ``traceEvents``, the file carries two
    top-level keys that make multi-process merging possible:
    ``baseTimeS`` — the ``perf_counter()`` value every ``ts`` is
    relative to (processes on one host share the monotonic clock, so
    ``baseTimeS + ts/1e6`` is directly comparable across files) — and
    ``node`` — this process's fleet node id. Chrome/Perfetto ignore
    unknown top-level keys, so the file stays viewer-compatible."""
    from reflow_tpu_torch.obs.wire import node_id
    from reflow_tpu_torch.utils.config import env_str
    path = path or env_str("REFLOW_TRACE_OUT")
    events, base = _snapshot()
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms",
                   "baseTimeS": base,
                   "node": node_id()}, f)
    return path


def ticket_timelines(events: List[Dict[str, Any]]
                     ) -> Dict[str, Dict[str, Any]]:
    """Reconstruct per-ticket stage timelines from a chrome event list:
    ``{batch_id: {"stages": {name: dur_us}, "e2e_us": .., "sum_us": ..}}``
    where ``e2e_us`` spans the earliest start to the latest end of the
    ticket's events and ``sum_us`` totals its stage durations."""
    names: Dict[int, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev.get("tid", -1)] = ev.get("args", {}).get("name", "")
    out: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        track = names.get(ev.get("tid", -1), "")
        if not track.startswith("ticket/"):
            continue
        bid = track[len("ticket/"):]
        t = out.setdefault(bid, {"stages": {}, "_t0": None, "_t1": None})
        dur = float(ev.get("dur", 0.0))
        name = ev.get("name", "?")
        t["stages"][name] = t["stages"].get(name, 0.0) + dur
        s = float(ev.get("ts", 0.0))
        t["_t0"] = s if t["_t0"] is None else min(t["_t0"], s)
        t["_t1"] = (s + dur if t["_t1"] is None
                    else max(t["_t1"], s + dur))
    for t in out.values():
        t["e2e_us"] = (t.pop("_t1") or 0.0) - (t.pop("_t0") or 0.0)
        t["sum_us"] = sum(t["stages"].values())
    return out


def causal_groups(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Group the ``"X"`` spans of ``events`` (one file's, or several
    files' concatenated) by causality token: spans sharing an
    ``args.cause`` token, or listing it in ``args.causes``, are one
    write's journey, and tokens that ride one span together (a shipped
    chunk's own token beside the write tokens it carries) join their
    groups. Returns ``[{"tokens": set, "spans": {name: count}}]``."""
    parent: Dict[str, str] = {}

    def find(t: str) -> str:
        root = t
        while parent.setdefault(root, root) != root:
            root = parent[root]
        while parent[t] != root:
            parent[t], t = root, parent[t]
        return root

    tagged = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        a = ev.get("args") or {}
        tokens = [a["cause"]] if a.get("cause") else []
        tokens += [t for t in a.get("causes") or () if t not in tokens]
        if not tokens:
            continue
        for t in tokens[1:]:
            ra, rb = find(tokens[0]), find(t)
            if ra != rb:
                parent[rb] = ra
        find(tokens[0])
        tagged.append((tokens[0], ev.get("name", "?")))
    groups: Dict[str, Dict[str, Any]] = {}
    for t in parent:
        groups.setdefault(find(t), {"tokens": set(), "spans": {}})[
            "tokens"].add(t)
    for tok, name in tagged:
        spans = groups[find(tok)]["spans"]
        spans[name] = spans.get(name, 0) + 1
    return list(groups.values())


def full_chains(events: List[Dict[str, Any]],
                chain=FULL_CHAIN) -> List[Dict[str, Any]]:
    """The causal groups of ``events`` that carry every span of
    ``chain``."""
    return [g for g in causal_groups(events)
            if all(name in g["spans"] for name in chain)]
