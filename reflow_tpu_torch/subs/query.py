"""Standing queries and delta frames — the data model of reactive reads.

A *standing query* is a pull-path read (``view_at`` / ``lookup`` /
``top_k``) turned persistent: instead of recomputing the answer on
every call, the subscriber holds the answer locally and the hub pushes
only what changed per applied commit window. Three kinds:

- ``view``: the whole sink projection (``view_at``). Deltas are
  ``((key, value), dweight)`` rows — additive weight changes.
- ``lookup``: one key's aggregate weight (``lookup``). Deltas are the
  ``view`` rows filtered to that key.
- ``topk``: the ranked top-``k`` (``top_k``). Rank entries/exits don't
  compose additively, so topk frames always carry the full ranked list
  (absolute, not additive) and the client replaces wholesale.

**Frames and contiguity.** A :class:`DeltaFrame` spans the half-open
horizon interval ``(from_h, to_h]``. The hub skips empty windows (no
frame when nothing changed for the query), so consecutive frames are
contiguous *per query*: ``from_h`` is always the previous frame's
``to_h`` (or the snapshot horizon for the first). A client at local
horizon ``h`` applies a frame iff ``from_h <= h < to_h`` — the overlap
region ``(from_h, h]`` is provably changeless for this query (had it
changed, a frame ending there would have been emitted), so applying
the whole span is exact. ``to_h <= h`` means duplicate (skip, count);
``from_h > h`` means gap (count, rebase via snapshot). This rule is
what makes reconnect-resume duplicate-free *and* gap-free with only a
scalar cursor.

:class:`QueryState` is the client-side apply engine, shared by the
in-process :class:`~reflow_tpu_torch.subs.hub.SubHandle` and the wire
:class:`~reflow_tpu_torch.subs.client.Subscriber`; :func:`merge_frames` is
the conflation kernel the hub uses when a slow subscriber's outbox
overflows.

The port's copy of ``reflow_tpu/subs/query.py``. ``topk_rows`` is a
host ``heapq`` rank over a sink view (ties on ``str(pair)``), as in JAX;
it is not the top-k kernel. Untraced frames pickle byte-identically to
the JAX package's.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

KINDS = ("view", "lookup", "topk")


class StandingQuery(NamedTuple):
    """Canonical, hashable identity of a standing query. Subscribers
    with the same ``StandingQuery`` share one fan (one delta stream
    computed once, appended to every member's outbox)."""
    sink: str
    kind: str      # "view" | "lookup" | "topk"
    params: tuple  # () | (key,) | (k, by)


class DeltaFrame(NamedTuple):
    """One push over the interval ``(from_h, to_h]``.

    ``rows`` for view/lookup: ``((key_value_pair, dweight), ...)``
    (absolute weights when ``snapshot``); for topk: the full ranked
    ``((key_value_pair, weight), ...)`` — always absolute.

    ``cause`` is the optional tuple of causality tokens
    (``obs.trace.mint_cause``) of the sampled writes folded into this
    frame's window — the ``Shipment`` pattern extended to the push
    path: trailing + defaulted, trimmed off the wire form when None
    (:func:`frames_to_wire`) so tracing-off frames stay byte-identical
    to the pre-trace protocol."""
    from_h: int
    to_h: int
    kind: str
    rows: tuple
    snapshot: bool
    cause: Optional[tuple] = None


def canon_query(sink: str, kind: str, params: Sequence = ()) -> StandingQuery:
    """Validate and canonicalize into a hashable :class:`StandingQuery`.
    Lists (e.g. JSON-decoded keys) become tuples so equal queries hash
    equal across the wire."""
    if kind not in KINDS:
        raise ValueError(f"unknown query kind {kind!r} (want one of {KINDS})")
    p = tuple(params)
    if kind == "view":
        if p:
            raise ValueError("view query takes no params")
    elif kind == "lookup":
        if len(p) != 1:
            raise ValueError("lookup query wants params=(key,)")
        key = p[0]
        if isinstance(key, list):
            key = tuple(key)
        p = (key,)
    else:  # topk
        if len(p) == 1:
            p = (int(p[0]), "weight")
        if len(p) != 2 or p[1] not in ("weight", "value"):
            raise ValueError("topk query wants params=(k,) or "
                             "(k, 'weight'|'value')")
        p = (int(p[0]), p[1])
        if p[0] <= 0:
            raise ValueError("topk k must be positive")
    return StandingQuery(str(sink), kind, p)


def _rank_key(by: str):
    if by == "value":
        return lambda item: item[0][1]
    return lambda item: item[1]


def topk_rows(view: Dict, k: int, by: str) -> tuple:
    """Deterministic ranked tuple over a sink view mapping
    ``(key, value) -> weight``. Ties break on the string form of the
    pair so equal views always rank identically (frame-change detection
    and cross-path parity both rely on this)."""
    rank = _rank_key(by)
    top = heapq.nsmallest(k, view.items(),
                          key=lambda it: (-rank(it), str(it[0])))
    return tuple((kv, w) for kv, w in top)


def query_value(query: StandingQuery, view: Dict):
    """Evaluate ``query`` against a full sink view (the pull-path
    answer shape): dict for view, float for lookup, ranked tuple for
    topk."""
    if query.kind == "view":
        return dict(view)
    if query.kind == "lookup":
        return float(view.get(query.params[0], 0.0))
    return topk_rows(view, *query.params)


def snapshot_rows(query: StandingQuery, view: Dict) -> tuple:
    """Absolute rows for a snapshot frame of ``query``."""
    if query.kind == "view":
        return tuple(view.items())
    if query.kind == "lookup":
        key = query.params[0]
        return ((key, view[key]),) if key in view else ()
    return topk_rows(view, *query.params)


def delta_rows(query: StandingQuery, deltas: Dict, view: Dict,
               last_topk: Optional[tuple]) -> Optional[tuple]:
    """Rows for a delta frame, or ``None`` when this window is empty
    for the query (no frame emitted — contiguity is per query).

    ``deltas`` maps ``(key, value) -> dweight`` accumulated over the
    window; ``view`` is the post-window mirror; ``last_topk`` is the
    previously emitted ranked tuple for topk change detection."""
    if query.kind == "view":
        rows = tuple((kv, dw) for kv, dw in deltas.items() if dw != 0)
        return rows or None
    if query.kind == "lookup":
        key = query.params[0]
        dw = deltas.get(key, 0)
        return ((key, dw),) if dw != 0 else None
    ranked = topk_rows(view, *query.params)
    if last_topk is not None and ranked == last_topk:
        return None
    return ranked


class QueryState:
    """Client-side state of one standing query: applies frames by the
    contiguity rule, counts duplicates and gaps, reconstructs the
    current value. ``horizon`` is ``-1`` until the first snapshot."""

    __slots__ = ("query", "horizon", "applied", "dups_skipped", "gaps",
                 "rebases", "_view", "_weight", "_ranked")

    def __init__(self, query: StandingQuery):
        self.query = query
        self.horizon = -1
        self.applied = 0
        self.dups_skipped = 0
        self.gaps = 0
        self.rebases = 0
        self._view: Dict = {}
        self._weight = 0.0
        self._ranked: tuple = ()

    def apply(self, frame: DeltaFrame) -> bool:
        """Apply one frame. Returns True when the frame advanced local
        state; False for duplicates (skipped) and gaps (counted — the
        caller should request a rebase snapshot)."""
        if frame.snapshot:
            if frame.to_h == self.horizon:
                self.dups_skipped += 1
                return False
            # to_h < horizon is a deliberate rewind (replica bootstrap
            # / promote moved state non-monotonically) — accept it.
            self._load_snapshot(frame.rows)
            self.horizon = frame.to_h
            self.applied += 1
            self.rebases += 1
            return True
        if frame.to_h <= self.horizon:
            self.dups_skipped += 1
            return False
        if self.horizon < 0 or frame.from_h > self.horizon:
            self.gaps += 1
            return False
        self._apply_rows(frame.rows)
        self.horizon = frame.to_h
        self.applied += 1
        return True

    def note_horizon(self, horizon: int) -> None:
        """Advance past changeless windows: an empty poll that reports
        fan-out horizon ``h`` proves no frame was emitted in
        ``(local, h]``, i.e. the query's answer did not change there.
        No-op until the first snapshot has seeded state."""
        if self.horizon >= 0 and horizon > self.horizon:
            self.horizon = horizon

    def _load_snapshot(self, rows: tuple) -> None:
        q = self.query
        if q.kind == "view":
            self._view = {kv: w for kv, w in rows}
        elif q.kind == "lookup":
            self._weight = float(rows[0][1]) if rows else 0.0
        else:
            self._ranked = tuple(rows)

    def _apply_rows(self, rows: tuple) -> None:
        q = self.query
        if q.kind == "view":
            view = self._view
            for kv, dw in rows:
                w = view.get(kv, 0) + dw
                if w == 0:
                    view.pop(kv, None)
                else:
                    view[kv] = w
        elif q.kind == "lookup":
            key = q.params[0]
            for kv, dw in rows:
                if kv == key:
                    self._weight += dw
        else:
            self._ranked = tuple(rows)

    def value(self):
        """The reconstructed answer in the pull-path shape: dict /
        float / ranked tuple."""
        if self.query.kind == "view":
            return dict(self._view)
        if self.query.kind == "lookup":
            return float(self._weight)
        return self._ranked


def merge_frames(frames: Sequence[DeltaFrame]) -> DeltaFrame:
    """Conflate an ordered run of frames for one query into a single
    equivalent frame (the slow-subscriber escape hatch). Additive kinds
    fold deltas key-wise (restarting from the newest snapshot if one is
    present); topk keeps only the newest ranked list. The merged span
    covers ``(first.from_h, last.to_h]``."""
    if not frames:
        raise ValueError("merge_frames needs at least one frame")
    if len(frames) == 1:
        return frames[0]
    kind = frames[0].kind
    first, last = frames[0], frames[-1]
    cause = _merge_causes(frames)
    if kind == "topk":
        return DeltaFrame(first.from_h, last.to_h, kind, last.rows,
                          any(f.snapshot for f in frames), cause)
    start = 0
    snapshot = False
    for i in range(len(frames) - 1, -1, -1):
        if frames[i].snapshot:
            start, snapshot = i, True
            break
    acc: Dict = {}
    for f in frames[start:]:
        for kv, w in f.rows:
            acc[kv] = acc.get(kv, 0) + w
    rows = tuple((kv, w) for kv, w in acc.items() if w != 0)
    return DeltaFrame(first.from_h, last.to_h, kind, rows, snapshot,
                      cause)


def _merge_causes(frames: Sequence[DeltaFrame]) -> Optional[tuple]:
    """Union (ordered, deduplicated) of the merged frames' causality
    tokens — conflation must not orphan a sampled write's chain."""
    out: List = []
    for f in frames:
        for c in getattr(f, "cause", None) or ():
            if c not in out:
                out.append(c)
    return tuple(out) if out else None


def frames_to_wire(frames: Sequence[DeltaFrame]) -> Tuple[tuple, ...]:
    """Plain-tuple form for pickling over ``net/`` framing. Each
    frame's one trailing None (an unstamped ``cause``) is trimmed — the
    ``Shipment`` compat pattern — so tracing-off frames pickle
    byte-identically to the pre-``cause`` protocol, and
    :func:`frames_from_wire` refills the default."""
    out = []
    for f in frames:
        fields = tuple(f)
        if fields and fields[-1] is None:
            fields = fields[:-1]
        out.append(fields)
    return tuple(out)


def frames_from_wire(raw: Sequence[tuple]) -> List[DeltaFrame]:
    return [DeltaFrame(*t) for t in raw]
