"""CudaExecutor: one tick pass as eager PyTorch over device tensors.

The counterpart of ``reflow_tpu/executors/tpu.py``'s ``TpuExecutor``:
delta buffers and operator state live on the device; host batches cross
at graph sources (``to_device``) and sinks (``to_host``); each pass runs
the dirty plan's lowerings in order (``executors/lowerings.py``).

Iterative graphs: as in the JAX package, ``fixpoint=True`` (the default)
runs a whole tick in :meth:`run_tick_fixpoint` — the fused delta-vector
loop (``executors/linear_fixpoint.py``) when the loop region is declared
linear, else the row program (``executors/fixpoint.py``), else None and
the scheduler drives the passes itself. ``fixpoint=False`` always gives
the scheduler's host-driven loop; ``linear_fixpoint=False`` keeps the
row program. PyTorch has no device-side loop, so both programs check the
loop on the host, one packed readback a pass (``read_scalars``, counted
in ``loop_reads``); a readback that decides a branch (the Join's
compact-or-append, the fused loop's CSR rebuild) goes through
``read_branch`` and counts in ``host_syncs``. PyTorch runs eagerly, so
there is no compiled-program cache: the program objects are built once
per bound graph. :meth:`place` moves the executor to another device
between windows (the serving tier's tenant placement).

The window path (``tick_many``'s fused branch and the serve pump's
staged windows): :meth:`stage_window` writes a K-tick window's host
batches into the persistent slots of a ``DeviceIngressQueue``
(``executors/ingress_queue.py``), :meth:`dispatch_window` runs the K
ticks over those slots in one call, and :meth:`retire_window` frees the
queue generation. Where JAX ``lax.scan``s a jitted tick over donated
buffers, the port runs an eager K-tick loop over slot views on one
stream: no host readback between ticks beyond the ones the per-tick path
pays (a k-NN tick's path choice, a loop's per-pass reads). JAX also
shares its compiled loop-free window program across structurally
identical graphs; the port's is an eager pass built in microseconds, so
each executor keeps its own.

Refused at :meth:`bind` with "not ported yet": op kinds without a
lowering. A Map with ``params`` binds them as its state, a copy of the
tree on the executor's device (:meth:`update_params` swaps it with no
rebind). A min/max Reduce binds the bounded candidate buffer
(``lowerings.minmax_core``; :meth:`refresh_minmax` resets its latches
from a replay), and a Join whose left Spec is not unique binds the
two-arena multiset form.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do): on the CPU every kernel wrapper takes its plain PyTorch
version, because the tensors it is given lie on the CPU.

Seams for the mesh executors (``parallel/shard.py``, ``parallel/
topo.py``): :meth:`_lower` (one node's lowering), :meth:`build_pass_body`
and :meth:`run_region` (a pass or a fixpoint tick as a body of the SPMD
runtime, run here on one device with every collective the identity),
:meth:`_op_states`/:meth:`_set_op_states` (the state container the
programs thread: this executor's ``states`` dict), and
:meth:`_ingress_placement` (where ingress queue buffers live).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from reflow_tpu_torch.delta import DeltaBatch, torch_dtype
from reflow_tpu_torch.executors.arena import propagate_plan_caps
from reflow_tpu_torch.executors.base import Executor
from reflow_tpu_torch.executors.device_delta import (DeviceDelta,
                                                     bucket_capacity,
                                                     check_keys,
                                                     devices_of,
                                                     resolve_device,
                                                     to_device, to_host)
from reflow_tpu_torch.executors.fixpoint import (FixpointProgram, analyze,
                                                 slot_ingress)
from reflow_tpu_torch.executors.linear_fixpoint import (
    LinearFixpointProgram, analyze_linear, resid_state)
from reflow_tpu_torch.executors.lowerings import (DEVICE_REDUCERS,
                                                  LOWERINGS, join_state,
                                                  knn_state, lower_node,
                                                  minmax_refresh_core,
                                                  reduce_state)
from reflow_tpu_torch.graph import FlowGraph, GraphError, Node
from reflow_tpu_torch.obs import trace as _trace
from reflow_tpu_torch.parallel.spmd import SOLO, run_solo
from reflow_tpu_torch.utils.config import env_int
from reflow_tpu_torch.utils.metrics import profile_annotation
from reflow_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["CudaExecutor", "StagedWindow"]

#: op kinds whose lowering keeps no state
_STATELESS = ("map", "filter", "groupby", "union")


class StagedWindow:
    """A staged-but-not-yet-dispatched K-tick window: the ingress queue
    generation its slot writes landed in, the [K, cap] stack the window
    reads, and everything :meth:`CudaExecutor.dispatch_window` /
    :meth:`CudaExecutor.retire_window` need to finish the lifecycle.
    ``fresh`` is filled by dispatch (the stack the window hands back)
    and consumed by retire."""

    __slots__ = ("plan", "caps", "K", "max_iters", "queue", "gen", "stack",
                 "qsig", "fresh")

    def __init__(self, plan, caps, K, max_iters, queue, gen, stack, qsig):
        self.plan = plan
        self.caps = caps
        self.K = K
        self.max_iters = max_iters
        self.queue = queue
        self.gen = gen
        self.stack = stack
        self.qsig = qsig
        self.fresh = None


def _error_reason(node: Node) -> str:
    """What a set sticky ``error`` flag means on ``node`` (only a min/max
    Reduce's state and a Join's carry one): the Reduce's buffer was
    exhausted, or one of the Join's causes."""
    if node.op.kind == "reduce":
        return ("device min/max error: retraction churn exhausted a key's "
                "candidate buffer (the bounded exactness window — raise "
                "Reduce(candidates=...)), or a value's net weight passed "
                "2**30; this tick's state is invalid — re-run on the cpu "
                "executor or widen the buffer")
    if not node.inputs[0].spec.unique:
        return ("multiset join sticky error: an arena overflowed (live "
                "rows + appends exceeded capacity even after compaction — "
                "raise arena_capacity / left_arena_capacity), or a delta's "
                "key-matched pairs exceeded the product budget of "
                "product_slack x its capacity (raise product_slack); this "
                "tick's state is invalid")
    return ("join sticky error: the arena overflowed (live rows + "
            "appends exceeded capacity even after compaction — raise "
            "arena_capacity); or a downstream GroupBy's "
            "stable_key=True declaration was violated (its key_fn "
            "read the loop value — the fused fixpoint's dense tier "
            "caught a precomputed/runtime destination mismatch); "
            "this tick's state is invalid")


class CudaExecutor(Executor):
    name = "cuda"

    def __init__(self, *, device=None, fixpoint: bool = True,
                 linear_fixpoint: bool = True):
        super().__init__()
        #: where state, uploads and every lowering run
        self.device = resolve_device(device)
        #: device->host scalar readbacks made to decide a branch on the
        #: host (the k-NN full-vs-incremental choice, the Join's
        #: compact-before-append check, the fused loop's CSR rebuild);
        #: the scheduler folds them into its ``forced_syncs``
        self.host_syncs = 0
        #: the fixpoint programs' per-pass quiescence readbacks
        self.loop_reads = 0
        #: run whole ticks of iterative graphs in one call (False forces
        #: the scheduler's host-driven per-pass loop)
        self.fixpoint = fixpoint
        #: allow the fused delta-vector loop for declared-linear regions
        #: (False forces the row program)
        self.linear_fixpoint = linear_fixpoint
        self._reset_fixpoint()
        #: ONE persistent sorted-arena CSR cache per join node (derived
        #: state: dropped on bind and restore)
        self._csr_cache: Dict[int, dict] = {}
        #: full CSR rebuilds by cause: initial, gen (a compaction), shrunk
        #: (rcount below the cache's count), tail (the tail overflowed)
        self.csr_rebuilds: Counter = Counter()
        #: window path: ingress queues and loop-free window programs by
        #: (plan, caps[, K]) signature (dropped on a bind of another graph)
        self._window_cache: Dict[tuple, object] = {}
        #: per-source host batches above this row bound don't fit a
        #: reasonable queue slot: the scheduler falls back to the per-tick
        #: path instead
        self.megatick_max_rows = env_int("REFLOW_MEGATICK_MAX_ROWS")
        #: windows dispatched through the device ingress queue
        self.window_dispatches = 0
        #: Join arenas are split over this many shards (the static
        #: capacity check is per shard)
        self._arena_divisor = 1

    def fresh(self) -> "CudaExecutor":
        """A new, unbound executor on this one's device, with its loop
        options."""
        return type(self)(device=self.device, fixpoint=self.fixpoint,
                          linear_fixpoint=self.linear_fixpoint)

    def place(self, device) -> None:
        """Commit this executor to ``device``: every state tensor moves
        there (Map params trees and Join arenas included), and every
        later upload, ingress queue and lowering follows. ``device`` is a
        ``torch.device``, a string, or an index into the devices of this
        executor's kind (``devices_of``). The CSR cache, the window cache
        (ingress queues hold slot buffers and pinned staging for the old
        device) and the fixpoint program are dropped and rebuilt on use.
        Call between windows. A CUDA device with no card raises; the
        executor never moves to the CPU unless asked."""
        if isinstance(device, int):
            device = devices_of(self.device.type)[device]
        dev = resolve_device(device)
        self.device = dev
        self._csr_cache.clear()
        self._window_cache.clear()
        self._fx_program = None
        if self.states:
            self.states = {
                nid: tree_map(lambda t: t.to(dev)
                              if isinstance(t, torch.Tensor) else t, st)
                for nid, st in self.states.items()}

    #: the obs tag of this executor's device in spans and gauges: always
    #: the device's name (``"cuda:0"``, ``"cpu"``), never None
    @property
    def device_label(self) -> Optional[str]:
        return str(self.device)

    def _ingress_placement(self):
        """Where ingress queue buffers live: this executor's device (the
        sharded executor's is its ``(mesh, axis)``)."""
        return self.device

    def _op_states(self):
        """The state container the pass and fixpoint programs thread."""
        return self.states

    def _set_op_states(self, states) -> None:
        self.states = states

    def _reset_fixpoint(self) -> None:
        self._fx_structure = None
        self._fx_unsupported = not self.fixpoint
        self._linear_fixpoint = self.linear_fixpoint
        self._linear_structure = None
        self._fx_program = None

    def _note_sync(self) -> None:
        self.host_syncs += 1

    def read_branch(self, t: torch.Tensor) -> list:
        """Read a small tensor back to decide a host branch (counted in
        ``host_syncs``, so in the scheduler's ``forced_syncs``)."""
        self._note_sync()
        return t.tolist()

    def read_scalars(self, t: torch.Tensor) -> list:
        """A fixpoint loop's one packed readback of a pass."""
        self.loop_reads += 1
        return t.tolist()

    # -- bind: validate lowerability, build device state -------------------

    def bind(self, graph: FlowGraph) -> None:
        if graph is not self.graph:
            self._reset_fixpoint()
            self._window_cache.clear()
        # state is reset below: any sorted-arena cache is now stale
        self._csr_cache.clear()
        self.graph = graph
        self.states = {}
        for loop in graph.loops:
            if loop.defer_passes:
                # cross-tick residual deferral: the loop carries its
                # un-propagated emission deltas as dense observables —
                # semantic state, unlike the derived CSR cache
                if loop.spec.key_space <= 0:
                    raise GraphError(
                        f"{loop}: defer_passes needs key_space > 0")
                self.states[loop.id] = resid_state(loop.spec, self.device)
        for node in graph.nodes:
            if node.kind != "op":
                continue
            self._bind_op(node)

    def _bind_op(self, node: Node) -> None:
        op = node.op
        if op.kind not in LOWERINGS:
            raise GraphError(
                f"{node}: op kind {op.kind!r} is not ported yet to the "
                f"cuda executor (ported: {sorted(LOWERINGS)}); run it "
                f"on the cpu executor")
        if op.kind == "map" and op.params is not None:
            self.states[node.id] = {"params": self._copy_params(node,
                                                                op.params)}
            return
        if op.kind in _STATELESS:
            return
        in_specs = [i.spec for i in node.inputs]
        for s in in_specs:
            if s.key_space <= 0:
                raise GraphError(
                    f"{node}: the device lowering needs key_space > 0 "
                    f"on every keyed-op input Spec")
        if op.kind == "reduce":
            if op.how not in DEVICE_REDUCERS:
                raise GraphError(
                    f"{node}: reducer {op.how!r} has no device lowering "
                    f"yet (have {DEVICE_REDUCERS}); run it on the cpu "
                    f"executor")
            self.states[node.id] = reduce_state(in_specs[0], node.spec,
                                                self.device, op)
        elif op.kind == "join":
            if op.merge is None:
                # the default merge lowers to the flattened concatenation
                # of (va, vb); the out Spec must size it
                flat = (int(np.prod(in_specs[0].value_shape or (1,)))
                        + int(np.prod(in_specs[1].value_shape or (1,))))
                got = int(np.prod(node.spec.value_shape or (1,)))
                if got != flat:
                    raise GraphError(
                        f"{node}: default-merge device Join needs a spec "
                        f"with {flat} flat value elements (va ++ vb), got "
                        f"{node.spec.value_shape}")
            self.states[node.id] = join_state(op, in_specs[0], in_specs[1],
                                              self.device)
        else:  # knn
            for port, s in enumerate(in_specs):
                if tuple(s.value_shape) != (op.dim,):
                    raise GraphError(
                        f"{node}: knn input {port} value_shape "
                        f"{s.value_shape} != (dim={op.dim},)")
            D = in_specs[1].key_space
            if D > op.scan_chunk and D % op.scan_chunk:
                raise GraphError(
                    f"{node}: corpus key_space {D} must be a multiple "
                    f"of scan_chunk {op.scan_chunk}")
            self.states[node.id] = knn_state(op, *in_specs, self.device)

    def _copy_params(self, node: Node, params):
        """A Map's params tree copied onto this executor's device, leaf
        dtypes kept (lowerings update no params in place, but the caller's
        tensors stay the caller's). Numpy or torch leaves."""
        for leaf in tree_leaves(params):
            if not hasattr(leaf, "shape"):
                raise GraphError(
                    f"{node}: Map params leaves must be arrays, got "
                    f"{type(leaf).__name__}; close fn over static "
                    f"(shape-driving) config instead of passing it "
                    f"in params")

        def copy(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to(self.device, copy=True)
            # np.array copies: the tensor owns writable memory
            return torch.from_numpy(np.array(x)).to(self.device)

        return tree_map(copy, params)

    def update_params(self, node: Node, params) -> None:
        """Swap a params-bearing Map's parameter tree for a copy of
        ``params`` on this executor's device. Nothing is rebound: the
        next tick runs with the new values."""
        st = self.states.get(node.id)
        if st is None or "params" not in st:
            raise GraphError(f"{node} holds no params state")
        self.states[node.id] = {"params": self._copy_params(node, params)}

    # -- one pass ----------------------------------------------------------

    def _to_device_ingress(self, ingress) -> Dict[int, DeviceDelta]:
        """Host boundary in: upload host batches; pass device ones
        through (moved onto this executor's device if they are not)."""
        dev_ingress: Dict[int, DeviceDelta] = {}
        for nid, b in ingress.items():
            if isinstance(b, DeviceDelta):
                dev_ingress[nid] = DeviceDelta(*(t.to(self.device)
                                                 for t in b))
            else:
                node = self.graph.nodes[nid]
                dev_ingress[nid] = to_device(b, node.spec, device=self.device,
                                             source=f"source {node.name!r}")
        return dev_ingress

    def run_pass(self, plan: Sequence[Node],
                 ingress: Dict[int, DeltaBatch]) -> Dict[int, object]:
        t0 = time.perf_counter() if _trace.ENABLED else 0.0
        dev_ingress = self._to_device_ingress(ingress)
        # fail loudly BEFORE an append could be truncated
        self._track_arena(plan, {nid: d.capacity
                                 for nid, d in dev_ingress.items()})
        states, egress = self.build_pass_fn(list(plan))(
            self._op_states(), dev_ingress)
        self._set_op_states(states)
        if _trace.ENABLED:
            _trace.evt("device_dispatch", t0, time.perf_counter() - t0,
                       args={"kind": "pass", "device": str(self.device)})
        # everything stays device-resident: sink batches are materialized
        # by the scheduler once per tick
        return egress

    # -- whole-tick fixpoint -------------------------------------------------

    def run_tick_fixpoint(self, plan: Sequence[Node],
                          ingress: Dict[int, DeltaBatch], max_iters: int,
                          *, sync: bool = True):
        """Run an entire tick (phase A pass, the loop, the exit pass) in
        one call. Returns ``(sink_batches, passes, loop_rows, quiesced,
        extra_dirty, leftover)`` or None when the graph doesn't fit the
        fixpoint structure (the scheduler then drives the passes).

        The loop is checked on the host, so the tick's scalars are host
        values whatever ``sync`` says; ``leftover`` holds the row
        program's live carry after a ``max_iters`` halt (the scheduler
        stashes it, and the next tick resumes)."""
        if self._ensure_fx_program() is None:
            return None

        t0 = time.perf_counter() if _trace.ENABLED else 0.0
        dev_ingress = self._to_device_ingress(ingress)
        st = self._fx_structure
        self._track_arena(plan, {nid: d.capacity
                                 for nid, d in dev_ingress.items()})
        if st.exit_plan:
            self._track_arena(
                list(st.exit_plan),
                {n.id: 2 * n.inputs[0].spec.key_space for n in st.boundary})
        states, sink_egress, carry, iters, rows, converged = \
            self._fx_program(self._op_states(), plan, dev_ingress, max_iters)
        self._set_op_states(states)
        if _trace.ENABLED:
            _trace.evt("device_dispatch", t0, time.perf_counter() - t0,
                       args={"kind": "fixpoint", "device": str(self.device)})
        passes = 1 + iters + (1 if st.exit_plan else 0)
        # nodes the loop and exit passes ran beyond the phase-A plan (the
        # scheduler's dirty-set report), only if the loop iterated
        extra_dirty = (set(st.region_ids) | {n.id for n in st.exit_plan}
                       if iters > 0 else set())
        leftover = dict(carry) if carry and not converged else {}
        return ({sid: list(b) for sid, b in sink_egress.items()}, passes,
                rows, converged, extra_dirty, leftover)

    def _build_fixpoint(self):
        """The fused delta-vector program when the region's operator chain
        is declared linear, otherwise the row program."""
        if self._linear_fixpoint:
            if self._linear_structure is None:
                self._linear_structure = analyze_linear(self.graph,
                                                        self._fx_structure)
                if self._linear_structure is None:
                    self._linear_fixpoint = False
            if self._linear_structure is not None:
                try:
                    return LinearFixpointProgram(
                        self, structure=self._fx_structure,
                        linear=self._linear_structure)
                except ValueError:
                    # shapes don't fit the fused-f32 representation; use
                    # the row program below
                    self._linear_fixpoint = False
                    self._linear_structure = None
        return FixpointProgram(self, structure=self._fx_structure)

    def _ensure_fx_program(self):
        """The bound graph's fixpoint program, built on first use (None
        when the graph has no fixpoint structure)."""
        if self._fx_unsupported:
            return None
        if self._fx_structure is None:
            self._fx_structure = analyze(self.graph)
            if self._fx_structure is None:
                self._fx_unsupported = True
                return None
        if self._fx_program is None:
            self._fx_program = self._build_fixpoint()
        return self._fx_program

    # -- the window path: K ticks in one call ------------------------------

    def supports_window(self) -> bool:
        """Does the bound graph fit the window path? The scheduler's
        ``window_support`` and the serve frontend read this to decide
        whether the window path can engage at all. ``fixpoint=False``
        opts out (ticks stay per-tick), and sinks need per-tick host
        egress."""
        if self.graph is None or not self.fixpoint or self.graph.sinks:
            return False
        if not self.graph.loops:
            return True
        if self._fx_unsupported:
            return False
        if self._fx_structure is None:
            self._fx_structure = analyze(self.graph)
            if self._fx_structure is None:
                self._fx_unsupported = True
                return False
        return True

    def run_window(self, plan, feeds, max_iters):
        """One K-tick commit window in ONE call, fed from the ingress
        queue: each host batch is written into a persistent queue slot
        and the window's tick loop reads the slots in place. ``feeds`` is
        a list of K ``{node_id: batch}`` ingress dicts with identical node
        sets. As in JAX, each tick's fixpoint carry is dropped before the
        next: a row-program tick that halts at ``max_iters`` inside a
        window does not resume (its converged flag comes back False at
        ``block()``). Returns ``(passes_base, iters, rows, converged,
        extra_dirty)``, or None when the window doesn't fit
        (device-resident batches, rows above ``megatick_max_rows``, an
        unsupported graph) — the scheduler then runs the ticks one by
        one. The depth-1 composition of :meth:`stage_window` →
        :meth:`dispatch_window` → :meth:`retire_window`."""
        sw = self.stage_window(plan, feeds, max_iters)
        if sw is None:
            return None
        out = self.dispatch_window(sw)
        if out is None:
            return None
        self.retire_window(sw)
        return out

    def stage_window(self, plan, feeds, max_iters):
        """Front half of the window lifecycle: check the window fits the
        fused path, write every host batch into the ingress queue's
        staging generation, and SEAL that generation (the queue's next
        write rotates onto a free set, so a pipelined caller can stage
        window N+1 while N is in flight). Returns a
        :class:`StagedWindow`, or None when the window doesn't fit
        (nothing is staged or sealed then). A key outside int32 raises
        ``DeliveryError`` with nothing sealed.

        A successful stage guarantees the dispatch can engage: for loop
        graphs the fixpoint program is built here, so the caller may
        commit irreversible work (a WAL append) between stage and
        dispatch."""
        if not self.supports_window():
            return None
        K = len(feeds)
        node_ids = sorted(feeds[0])
        if any(sorted(f) != node_ids for f in feeds):
            return None
        caps: Dict[int, int] = {}
        for nid in node_ids:
            rows = 0
            for f in feeds:
                b = f[nid]
                if hasattr(b, "nonzero"):
                    # already device-resident: no host rows to write
                    # (and len() would read back) — the per-tick path
                    return None
                rows = max(rows, len(b))
            if rows > self.megatick_max_rows:
                return None
            caps[nid] = bucket_capacity(rows)

        if self.graph.loops:
            # build the fixpoint program NOW: dispatch must not be able to
            # refuse after the caller logged the staged window
            prog = self._ensure_fx_program()
            if prog is None or not hasattr(prog, "call_many"):
                return None

        qsig = ("ingress_q", tuple(n.id for n in plan),
                tuple(sorted(caps.items())), K)
        queue = self._window_cache.get(qsig)
        if queue is None:
            from reflow_tpu_torch.executors.ingress_queue import (
                DeviceIngressQueue)

            # negotiate capacity with the arena BEFORE reserving device
            # memory: impossible ingress sizes raise here, not mid-window
            self._track_arena(plan, caps)
            queue = DeviceIngressQueue(
                {nid: self.graph.nodes[nid].spec for nid in node_ids},
                caps, K, placement=self._ingress_placement())
            self._window_cache[qsig] = queue

        t_h0 = time.perf_counter() if _trace.ENABLED else 0.0
        for t, f in enumerate(feeds):
            for nid in node_ids:
                queue.write(t, nid, f[nid],
                            f"source {self.graph.nodes[nid].name!r}")
        if _trace.ENABLED:
            _trace.evt("queue_write", t_h0, time.perf_counter() - t_h0,
                       args={"ticks": K, "slots": K * len(node_ids),
                             "inflight": queue.in_flight})
        stack = queue.stacked()
        gen = queue.seal()
        return StagedWindow(plan, caps, K, max_iters, queue, gen, stack,
                            qsig)

    def dispatch_window(self, sw: StagedWindow):
        """Middle of the window lifecycle: the K ticks over the staged
        stack. The launches are asynchronous, so a pipelined caller
        returns here while the device still runs the window (the ticks'
        own host readbacks excepted) and can stage the next one. A window
        that fails raises; it is never retried on the per-tick path."""
        try:
            out = self._dispatch_many(sw)
        except Exception:
            # the window died part-way: drop the queue so the next window
            # allocates a fresh one instead of writing a generation that
            # was never retired
            self._window_cache.pop(sw.qsig, None)
            raise
        if out is None:
            # unreachable by construction (stage builds the program);
            # un-seal the generation
            sw.queue.cancel(sw.gen)
            return None
        self.window_dispatches += 1
        return out

    def retire_window(self, sw: StagedWindow) -> None:
        """Tail of the window lifecycle: hand the window's stack back to
        the ingress queue and free its generation. Off the critical path
        — a pipelined pump runs this after the NEXT window is staged."""
        sw.queue.retire(sw.gen, sw.fresh)
        sw.fresh = None

    def cancel_window(self, sw: StagedWindow) -> None:
        """Abandon a staged window whose dispatch never ran: the
        generation goes straight back to the free list."""
        sw.queue.cancel(sw.gen)

    def _dispatch_many(self, sw: StagedWindow):
        """The K ticks of a staged window: run the window program for
        its plan/caps over the [K, cap] ingress stack and return the
        scheduler-facing ``(passes_base, iters, rows, converged,
        extra_dirty)`` tuple (None when the fixpoint program has no
        ``call_many``). The stack the window hands back is parked on
        ``sw`` for the retire step; the call is labelled
        ``reflow.window[K]`` for a device trace."""
        plan, stack, caps, K = sw.plan, sw.stack, sw.caps, sw.K
        t_d0 = time.perf_counter() if _trace.ENABLED else 0.0
        if not self.graph.loops:
            # loop-free sink-free graph (e.g. streaming TF-IDF): one pass
            # a tick over the K slots, no per-tick egress by construction
            sig = ("pass_many", tuple(n.id for n in plan),
                   tuple(sorted(caps.items())))
            pass_fn = self._window_cache.get(sig)
            if pass_fn is None:
                pass_fn = self._window_cache[sig] = self.build_pass_fn(
                    list(plan))
            self._track_arena(plan, caps)
            states = self._op_states()
            with profile_annotation(f"reflow.window[{K}]"):
                for t in range(K):
                    states, egress = pass_fn(states, slot_ingress(stack, t))
                    if egress:
                        raise RuntimeError("loop-free sink-free pass "
                                           "produced egress")
            self._set_op_states(states)
            sw.fresh = stack
            if _trace.ENABLED:
                _trace.evt("device_dispatch", t_d0,
                           time.perf_counter() - t_d0,
                           args={"kind": "window", "ticks": K,
                                 "device": self.device_label})
            return K, 0, 0, True, set()

        prog = self._ensure_fx_program()
        if prog is None or not hasattr(prog, "call_many"):
            return None
        st = self._fx_structure
        self._track_arena(plan, caps)
        if st.exit_plan:
            self._track_arena(
                list(st.exit_plan),
                {n.id: 2 * n.inputs[0].spec.key_space for n in st.boundary})
        with profile_annotation(f"reflow.window[{K}]"):
            new_states, (iters, rows, conv), sw.fresh = prog.call_many(
                self._op_states(), plan, stack, K, sw.max_iters)
        if _trace.ENABLED:
            _trace.evt("device_dispatch", t_d0, time.perf_counter() - t_d0,
                       args={"kind": "window", "ticks": K,
                             "device": self.device_label})
        self._set_op_states(new_states)
        extra_dirty = set(st.region_ids) | {n.id for n in st.exit_plan}
        passes_base = K * (1 + (1 if st.exit_plan else 0))
        return passes_base, iters, rows, conv, extra_dirty

    def on_states_replaced(self) -> None:
        """The state tree was swapped wholesale (a restore): drop the
        sorted-arena CSR caches. Their (gen, rcount) validity test cannot
        tell two histories apart whose counters line up."""
        self._csr_cache.clear()

    def _lower(self, ctx, node: Node, state, ins):
        """One node's lowering as a region body: here on this executor's
        device with no collective (the sharded executor's keyed lowerings
        yield theirs)."""
        return lower_node(node, state, ins, on_sync=self._note_sync)
        yield  # pragma: no cover - makes this a generator

    def run_region(self, body, op_states, dev_ingress, *args):
        """Run a program body (a pass, a fixpoint tick) over the state
        container: here on one device, every collective the identity."""
        return run_solo(body(SOLO, op_states, dev_ingress, *args))

    def build_pass_fn(self, plan: Sequence[Node], extra_egress=()):
        """The pass over ``plan``: ``(states, ingress) -> (states',
        egress)`` over DeviceDelta inputs. Ingress seeds any node's output
        (sources/loops); sink inputs and loop back-edges are returned, and
        the outputs of the ``extra_egress`` node ids (a stage boundary)."""
        body = self.build_pass_body(plan, extra_egress)

        def pass_fn(states, ingress):
            return self.run_region(body, states, ingress)

        return pass_fn

    def build_pass_body(self, plan: Sequence[Node], extra_egress=()):
        """The pass over ``plan`` as a body of the SPMD runtime (one
        traversal for one device and for every shard of a mesh):
        ``body(ctx, states, ingress) -> (states', egress)``."""
        graph = self.graph
        sink_inputs = [(s.inputs[0].id, s.id) for s in graph.sinks]
        back_edges = [(l.back_input.id, l.id) for l in graph.loops
                      if l.back_input is not None]
        extra = tuple(extra_egress)

        def body(ctx, states, ingress):
            outs: Dict[int, DeviceDelta] = dict(ingress)
            new_states = dict(states)
            for node in plan:
                if node.id in outs or node.kind in ("source", "loop",
                                                    "sink"):
                    continue
                ins = [outs.get(i.id) for i in node.inputs]
                if all(x is None for x in ins):
                    continue
                out, st = yield from self._lower(
                    ctx, node, new_states.get(node.id), ins)
                if st is not None:
                    new_states[node.id] = st
                outs[node.id] = out
            egress: Dict[int, DeviceDelta] = {}
            for src_id, sink_id in sink_inputs:
                if src_id in outs:
                    egress[sink_id] = outs[src_id]
            for back_id, loop_id in back_edges:
                if back_id in outs:
                    egress[loop_id] = outs[back_id]
            for nid in extra:
                if nid in outs:
                    egress[nid] = outs[nid]
            return new_states, egress

        return body

    def check_host_batch(self, source: Node, batch: DeltaBatch) -> None:
        """Keys outside int32 or at or past the source Spec's
        ``key_space`` (``device_delta.check_keys``): the lowerings would
        drop such a row. The upload checks again."""
        check_keys(batch.keys, source.spec, f"source {source.name!r}")

    # -- host boundary out -------------------------------------------------

    def materialize(self, batch) -> DeltaBatch:
        if isinstance(batch, DeviceDelta):
            self.materialize_count += 1
            return to_host(batch)
        return batch

    def refresh_minmax(self, node: Node, batch: DeltaBatch) -> None:
        """Latch refresh of a min/max Reduce (``lowerings.
        minmax_refresh_core``): ``batch`` replays the full live multiset
        of every key it mentions; those keys' candidate buffers rebuild
        from it and their overflow latches reset, in place. The aggregate
        cannot change (a contradicting replay sets the sticky error).
        Call between ticks; the scheduler's wrapper checks the node."""
        d = to_device(batch, node.inputs[0].spec, device=self.device,
                      source=f"{node.name!r}'s refresh")
        self.states[node.id] = minmax_refresh_core(
            node.op, node.inputs[0].spec.key_space,
            tuple(node.spec.value_shape),
            torch_dtype(node.spec.value_dtype), self.states[node.id], d)

    def _error_reason(self, node: Node) -> str:
        return _error_reason(node)

    def check_errors(self) -> None:
        """Raise if a state's sticky ``error`` flag is set (a Join's arena
        or product budget, a min/max Reduce's buffer), naming the node
        kind's own cause. All flags come back in one readback."""
        flagged = [(nid, st["error"]) for nid, st in self.states.items()
                   if "error" in st]
        if not flagged:
            return
        vals = torch.stack([e.to(self.device) for _, e in flagged]
                           ).cpu().tolist()
        for (nid, _), v in zip(flagged, vals):
            if v:
                node = self.graph.nodes[nid]
                raise RuntimeError(f"{node}: {self._error_reason(node)}")

    def _track_arena(self, plan, ingress_caps: Dict[int, int]) -> None:
        """Static per-pass capacity sanity for Join arenas: reject one
        pass's right-delta capacity exceeding the whole arena. The dynamic
        high-water check is the Join lowering's (compact, else the sticky
        error)."""
        propagate_plan_caps(plan, ingress_caps, self._arena_divisor)

    def _node_state(self, nid: int):
        """One node's state tree as ``read_table`` reads it."""
        return self.states.get(nid)

    def read_table(self, node: Node):
        st = self._node_state(node.id)
        if st is None:
            raise KeyError(f"{node} holds no materialized state")
        if node.op.kind in ("reduce", "join"):
            if "error" in st and bool(st["error"]):
                raise RuntimeError(f"{node}: {self._error_reason(node)}")
            if "lkeys" in st:
                raise KeyError(
                    f"{node}: a multiset-left join has no unique left "
                    f"table to read; attach a sink to observe its output")
            if node.op.kind == "reduce":
                keys = st["emitted_has"].cpu().numpy().nonzero()[0]
                vals = st["emitted"]
            else:
                keys = (st["lw"] > 0).cpu().numpy().nonzero()[0]
                vals = st["lval"]
            vals = vals.float() if vals.dtype == torch.bfloat16 else vals
            vals = vals.cpu().numpy()
            return {int(k): vals[k] if vals.ndim > 1 else vals[k].item()
                    for k in keys}
        if node.op.kind == "knn":
            has = st["em_has"].cpu().numpy()
            rows = st["emitted"].cpu().numpy()
            return {int(q): rows[q] for q in has.nonzero()[0]}
        raise KeyError(f"{node} ({node.op.kind}) has no table to read")

    # -- checkpoint seam ---------------------------------------------------

    def state_snapshot(self) -> Dict[int, object]:
        """A copy of every node's state tensors, on the device (lowerings
        update some tables in place, so a reference would be overwritten
        by the next tick); a Map's params tree is copied leaf by leaf."""
        return {nid: tree_map(torch.clone, st)
                for nid, st in self.states.items()}

    def state_restore(self, snapshot: Dict[int, object]) -> None:
        """Adopt a snapshot (cloned onto this executor's device, so the
        snapshot stays valid for another restore)."""
        self.states = {nid: tree_map(lambda t: t.to(self.device, copy=True),
                                     st)
                       for nid, st in snapshot.items()}
        self.on_states_replaced()
