"""The port's pipelined window execution on the CPU: stage → dispatch →
retire with a bounded in-flight depth, through the port's
``IngestFrontend`` and ``DirtyScheduler``, against the port's depth-1
drive, the JAX window path and the CPU oracle.

The counterpart of ``tests/test_pipeline.py``, test for test:

- depth 2/4 drives produce tables exactly equal (bitwise) to the depth-1
  drive on identical batches; all equal the JAX window path's tables
  (small-integer sums, exact) and the per-tick CPU oracle;
- staging window N+1 never writes a buffer set a dispatched window reads
  (generation rotation), including when the pump crashes with windows
  dispatched but unretired — every ticket still resolves;
- a producer blocked on the admission budget wakes at STAGE-complete;
- the ingress queue refuses int64 keys outside the int32 slot range.

Determinism. The reference's ``test_depth_fuzz_parity`` runs its pump
thread and fails under load: its tables come out wrong, because the JAX
queue's reused host scratch is refilled under an asynchronous transfer
(``tests/test_torch_megatick.py`` says more). Here the pump is driven
in the test's own thread (``start=False``, then ``_take_window`` /
``_run_window`` / ``_finish_window``, or ``_pump_loop`` run inline), so
the window count, ``windows_pipelined`` and ``stage_overlap_frac`` are
fixed by the schedule and asserted exactly; the JAX twin's scratch
reuse is turned off for these runs.
"""

import threading
import time

import numpy as np
import pytest
import torch

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.executors.ingress_queue import \
    DeviceIngressQueue as JDeviceIngressQueue
from reflow_tpu_torch.delta import Spec
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.executors.ingress_queue import (DeviceIngressQueue,
                                                      slot_nbytes)
from reflow_tpu_torch.serve import CoalesceWindow, IngestFrontend, PumpCrashed
from reflow_tpu_torch.utils.faults import CrashInjector, DeliveryError

K_SPACE = 32
ROWS = 6


@pytest.fixture(autouse=True)
def _jax_scratch_copies(monkeypatch):
    import reflow_tpu.executors.ingress_queue as jiq

    monkeypatch.setattr(jiq, "_SCRATCH_REUSE_SAFE", False)


def _batch(rows, pkg=P):
    return pkg.DeltaBatch(np.array([r[0] for r in rows], np.int64),
                          np.array([r[1] for r in rows], np.float32),
                          np.array([r[2] for r in rows], np.int64))


def _graph(pkg=P):
    """source -> map -> reduce(sum): loop-free, sink-free, ONE source so
    every feed is uniform and the fused window path always engages."""
    g = pkg.FlowGraph("pipeline")
    spec = pkg.Spec((), np.float32, key_space=K_SPACE)
    s = g.source("s", spec)
    m = g.map(s, lambda v: v * np.float32(2), vectorized=True)
    r = g.reduce(m, "sum", tol=0.0)
    return g, s, r


def _rows(seed, n=8, rows=ROWS):
    rng = np.random.default_rng(seed)
    return [[(int(rng.integers(0, K_SPACE)), float(rng.integers(0, 8)), 1)
             for _ in range(rows)] for _ in range(n)]


def _mk_batches(seed, n=8, rows=ROWS, pkg=P):
    return [_batch(r, pkg) for r in _rows(seed, n, rows)]


def _table(sched, node, nd=None):
    return {int(k): (float(np.asarray(v).reshape(()))
                     if nd is None
                     else round(float(np.asarray(v).reshape(())), nd))
            for k, v in sched.read_table(node).items()}


def _oracle(batches):
    g, s, r = _graph()
    sched = P.DirtyScheduler(g, P.CpuExecutor())
    for b in batches:
        sched.push(s, b)
        sched.tick()
    return _table(sched, r, nd=3)


def _jax_window(seed, k, n=8):
    """The JAX window path over the same batches, windows of ``k``."""
    g, s, r = _graph(J)
    sched = J.DirtyScheduler(g, jget_executor("tpu"))
    batches = _mk_batches(seed, n, pkg=J)
    for lo in range(0, n, k):
        sched.tick_many([{s: b} for b in batches[lo:lo + k]]).block()
    assert sched.megatick_windows == n // k
    return _table(sched, r)


def _run_pump_once(fe):
    """One pump iteration in this thread: claim the whole backlog, run
    it (chunks of ``max_ticks`` ticks, pipelined up to ``depth``), and
    release the latch — what the pump thread does for one window."""
    with fe._lock:
        drained = fe._take_window()
    fe._run_window(drained)
    with fe._lock:
        fe._finish_window()


def _frontend_drive(batches, depth, k):
    """All batches queue, then one pump iteration drains them as one
    multi-chunk backlog (chunks of ``k`` ticks), which is what makes
    consecutive windows pipeline at depth > 1. Returns (exact table,
    sched, frontend)."""
    g, s, r = _graph()
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    fe = IngestFrontend(sched, start=False, depth=depth,
                        window=CoalesceWindow(max_rows=ROWS, max_ticks=k,
                                              max_latency_s=0.001))
    try:
        tks = [fe.submit(s, b) for b in batches]
        _run_pump_once(fe)
        assert all(t.result(timeout=0).applied for t in tks)
    finally:
        fe.close()
    return _table(sched, r), sched, fe


def _queue(sched) -> DeviceIngressQueue:
    qs = [q for key, q in sched.executor._window_cache.items()
          if key[0] == "ingress_q"]
    assert len(qs) == 1
    return qs[0]


def _ptrs(stack):
    return {t.data_ptr() for dd in stack.values() for t in dd}


# -- differential fuzz: depths x window sizes x seeds ----------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_fuzz_parity(seed, k):
    """Depth 2 and 4 are bit-for-bit depth 1 (same window program, same
    slot contents, same dispatch order), and all match the JAX window
    path and the oracle. The pump runs in this thread, so the window and
    overlap counts are fixed: every chunk but the first stages while the
    one before it is in flight."""
    batches = _mk_batches(seed)
    want = _oracle(batches)
    t1, s1, fe1 = _frontend_drive(batches, depth=1, k=k)
    t2, s2, fe2 = _frontend_drive(batches, depth=2, k=k)
    t4, s4, fe4 = _frontend_drive(batches, depth=4, k=k)
    assert t2 == t1 and t4 == t1          # EXACT float equality
    assert t1 == _jax_window(seed, k)     # integer sums: exact
    assert {key: round(v, 3) for key, v in t1.items()} == want
    n_windows = len(batches) // k
    for sched in (s1, s2, s4):
        assert sched.megatick_fallbacks == 0
        assert sched.megatick_windows == n_windows
    # depth 1 is literally the serial tick_many path; deeper drives
    # stage every chunk and overlap all but the first
    assert fe1.windows_staged == 0 and fe1.stage_overlap_frac == 0.0
    for fe in (fe2, fe4):
        assert fe.windows_staged == n_windows
        assert fe.windows_pipelined == n_windows - 1
        assert 0.0 < fe.stage_overlap_frac < 1.0
        assert not fe._inflight and fe._pending_res == 0
    assert _queue(s4).generations == min(4, n_windows)
    assert _queue(s2).generations == 2


# -- stage never touches an in-flight generation ---------------------------

def test_stage_rotates_off_inflight_generation():
    """While window A is dispatched-but-unretired, staging window B
    lands in a DIFFERENT buffer generation: no buffer of A's stack is
    reused, so B's slot writes can't corrupt what A reads."""
    g, s, red = _graph()
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    waves = [_mk_batches(5, n=2), _mk_batches(6, n=2)]

    h1 = sched.stage_window([{s: b} for b in waves[0]])
    assert h1 is not None
    bufs1 = _ptrs(h1.sw.stack)
    sched.dispatch_staged(h1)
    q = _queue(sched)
    assert q.in_flight == 1

    h2 = sched.stage_window([{s: b} for b in waves[1]])
    assert h2 is not None
    assert h2.sw.gen != h1.sw.gen
    assert not (bufs1 & _ptrs(h2.sw.stack))
    assert q.generations == 2
    sched.dispatch_staged(h2)
    assert q.in_flight == 2

    sched.retire_staged(h1)
    sched.retire_staged(h2)
    assert q.in_flight == 0
    assert sched.megatick_fallbacks == 0
    # both windows' rows landed: views equal the per-tick oracle and the
    # JAX window path over the same two waves
    assert _table(sched, red, nd=3) == _oracle(waves[0] + waves[1])
    jg, js, jr = _graph(J)
    jsched = J.DirtyScheduler(jg, jget_executor("tpu"))
    for seed in (5, 6):
        jsched.tick_many([{js: b} for b in
                          _mk_batches(seed, n=2, pkg=J)]).block()
    assert _table(sched, red) == _table(jsched, jr)


def test_depth1_pingpong_reuses_generation_zero():
    """The serial flow (seal -> dispatch -> retire -> seal) never
    allocates a second generation — one buffer set, as in JAX."""
    g, s, r = _graph()
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    jg, js, jr = _graph(J)
    jsched = J.DirtyScheduler(jg, jget_executor("tpu"))
    for seed in (7, 8, 9):
        sched.tick_many([{s: b} for b in _mk_batches(seed, n=2)]).block()
        jsched.tick_many([{js: b} for b in
                          _mk_batches(seed, n=2, pkg=J)]).block()
    q = _queue(sched)
    assert sched.megatick_windows == 3
    assert q.generations == 1
    assert q.in_flight == 0
    assert _table(sched, r) == _table(jsched, jr)
    assert _table(sched, r, nd=3) == _oracle(
        [b for seed in (7, 8, 9) for b in _mk_batches(seed, n=2)])


def test_crash_with_window_in_flight_fails_every_ticket():
    """Kill the pump between chunk dispatches (chunk 1 dispatched and
    unretired, chunk 2 about to stage): the crash path must fail BOTH
    chunks' tickets — the in-flight window's ids stay in the dedup
    mirror, so a replay after recovery dedups instead of double-folding.
    The pump loop runs in this thread, so the crash lands at the same
    seam every run."""
    g, s, _r = _graph()
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    crash = CrashInjector(2, only="pump_before_tick")
    fe = IngestFrontend(sched, crash=crash, depth=2, start=False,
                        window=CoalesceWindow(max_rows=ROWS, max_ticks=2,
                                              max_latency_s=0.001))
    tks = [fe.submit(s, b, batch_id=f"b{i}")
           for i, b in enumerate(_mk_batches(3, n=4))]
    fe._pump_loop()                 # returns once the crash failed it
    for t in tks:
        with pytest.raises(PumpCrashed):
            t.result(timeout=0)
    assert crash.fired and crash.fired_seam == "pump_before_tick"
    assert not fe._inflight
    assert fe._pending_res == 0
    assert sched.megatick_windows == 1      # chunk 1 did dispatch
    # executed-but-unresolved ids stay admitted: a resend dedups
    assert "b0" in fe._admitted and "b3" in fe._admitted
    fe.close()


# -- stage-complete budget release -----------------------------------------

def test_stage_release_unblocks_producer_before_retire():
    """A budget-blocked producer wakes when the current chunk finishes
    STAGING (its rows now live in the device queue), not when the window
    retires. Settling is stubbed out, so only the stage-complete release
    can unblock it."""
    g, s, r = _graph()
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    rows = 4
    fe = IngestFrontend(sched, start=False, depth=2, policy="block",
                        max_bytes=slot_nbytes(s.spec, rows),
                        window=CoalesceWindow(max_rows=rows, max_ticks=2,
                                              max_latency_s=0.001))
    mk = lambda v: _batch([(i, float(v), 1) for i in range(rows)])
    t1 = fe.submit(s, mk(1))
    admitted = threading.Event()
    t2_box = []

    def produce():
        t2_box.append(fe.submit(s, mk(2)))
        admitted.set()

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    time.sleep(0.05)
    assert not admitted.is_set()       # genuinely blocked on the budget
    real_settle = fe._settle_all
    fe._settle_all = lambda: None
    try:
        with fe._lock:
            drained = fe._take_window()
        fe._run_window(drained)
        assert fe._inflight            # dispatched, NOT retired
        assert admitted.wait(60), ("producer still blocked after "
                                   "stage-complete")
    finally:
        fe._settle_all = real_settle
    fe._settle_all()
    with fe._lock:
        fe._finish_window()
    _run_pump_once(fe)
    th.join(timeout=60)
    assert t1.result(timeout=0).applied
    assert t2_box[0].result(timeout=0).applied
    fe.close()
    # both batches folded once: every key i holds 2 * (1 + 2)
    assert _table(sched, r) == {i: 6.0 for i in range(rows)}


# -- ingress queue: generation rotation + key-range guard ------------------

def _unit_queue(k=2, cap=64, key_space=8, pkg=P):
    if pkg is J:
        spec = J.Spec((), np.float32, key_space=key_space)
        return JDeviceIngressQueue({0: spec}, {0: cap}, k), spec
    spec = Spec((), np.float32, key_space=key_space)
    return DeviceIngressQueue({0: spec}, {0: cap}, k, placement="cpu"), spec


def _fresh_stack(k, cap):
    return {0: DeviceDelta(torch.zeros((k, cap), dtype=torch.int32),
                           torch.zeros((k, cap), dtype=torch.float32),
                           torch.zeros((k, cap), dtype=torch.int32))}


def _jfresh_stack(k, cap):
    import jax.numpy as jnp
    from reflow_tpu.executors.device_delta import DeviceDelta as JDD

    return {0: JDD(jnp.zeros((k, cap), jnp.int32),
                   jnp.zeros((k, cap), jnp.float32),
                   jnp.zeros((k, cap), jnp.int32))}


def test_seal_rotates_and_retire_frees():
    """The rotation, step for step beside the JAX queue: same generation
    ids, counts and slot contents."""
    q, _spec = _unit_queue()
    jq, _ = _unit_queue(pkg=J)
    for qq, pkg in ((q, P), (jq, J)):
        qq.write(0, 0, _batch([(1, 2.0, 1)], pkg))
    st1 = q.stacked()
    g0, jg0 = q.seal(), jq.seal()
    assert g0 == jg0 and q.in_flight == jq.in_flight == 1
    for qq, pkg in ((q, P), (jq, J)):
        qq.write(0, 0, _batch([(2, 3.0, 1)], pkg))   # rotates onto a new gen
    st2 = q.stacked()
    assert q.generations == jq.generations == 2
    assert _ptrs(st1).isdisjoint(_ptrs(st2))
    # the sealed gen's contents are untouched by the new gen's writes
    assert int(st1[0].weights[0].sum()) == 1
    assert float(st1[0].values[0, 0]) == 2.0
    np.testing.assert_array_equal(st2[0].values.numpy(),
                                  np.asarray(jq.stacked()[0].values))
    q.retire(g0, _fresh_stack(2, 64))
    jq.retire(jg0, _jfresh_stack(2, 64))
    assert q.in_flight == jq.in_flight == 0
    with pytest.raises(ValueError):
        q.retire(g0, _fresh_stack(2, 64))   # no longer in flight
    with pytest.raises(ValueError):
        q.retire(99, _fresh_stack(2, 64))


def test_retire_validates_stack_keys():
    q, _spec = _unit_queue()
    q.write(0, 0, _batch([(1, 1.0, 1)]))
    g0 = q.seal()
    with pytest.raises(ValueError):
        q.retire(g0, {5: _fresh_stack(2, 64)[0]})
    # a stack of other buffers is adopted whole-dirty: the next window's
    # writes clear every row of every slot it does not fill
    q.retire(g0, {0: DeviceDelta(torch.ones((2, 64), dtype=torch.int32),
                                 torch.ones((2, 64)),
                                 torch.ones((2, 64), dtype=torch.int32))})
    q.write(0, 0, _batch([(3, 1.0, 1)]))
    q.write(1, 0, _batch([]))
    st = q.stacked()[0]
    assert st.weights.tolist()[0] == [1] + [0] * 63
    assert int(st.weights[1].abs().sum()) == 0


def test_cancel_returns_generation_without_adoption():
    q, _spec = _unit_queue()
    jq, _ = _unit_queue(pkg=J)
    for qq, pkg in ((q, P), (jq, J)):
        qq.write(0, 0, _batch([(1, 1.0, 1)], pkg))
        g0 = qq.seal()
        qq.cancel(g0)
        assert qq.in_flight == 0
        qq.write(1, 0, _batch([(2, 1.0, 1)], pkg))  # reuses g0
        assert qq.generations == 1
        assert qq._staging == g0


def test_rebind_requires_inflight_generation():
    q, _spec = _unit_queue()
    with pytest.raises(ValueError):
        q.rebind(_fresh_stack(2, 64))
    q.write(0, 0, _batch([(1, 1.0, 1)]))
    q.seal()
    q.rebind(_fresh_stack(2, 64))
    assert q.in_flight == 0


def test_int64_keys_beyond_int32_rejected():
    """Keys >= 2^31 would be silently wrapped by the int32 slot
    assignment (to a DIFFERENT key, corrupting the fold); the host
    boundary refuses them, as the JAX queue does."""
    q, _spec = _unit_queue(key_space=2 ** 40)
    jq, _ = _unit_queue(key_space=2 ** 40, pkg=J)
    from reflow_tpu.utils.faults import DeliveryError as JDeliveryError

    for bad in (2 ** 31, -2 ** 31 - 1):
        with pytest.raises(DeliveryError):
            q.write(0, 0, _batch([(bad, 1.0, 1)]))
        with pytest.raises(JDeliveryError):
            jq.write(0, 0, _batch([(bad, 1.0, 1)], J))
    # boundary values are fine
    q.write(0, 0, _batch([(2 ** 31 - 1, 1.0, 1)]))
    jq.write(0, 0, _batch([(2 ** 31 - 1, 1.0, 1)], J))
    assert q.writes == jq.writes == 1
    assert int(q.stacked()[0].keys[0, 0]) == 2 ** 31 - 1


def test_window_spans_recorded():
    """With tracing on, the window path records the spans
    ``obs.trace.WINDOW_SPANS`` names: the slot writes, one dispatch a
    window, the fused ``tick_many`` (staged on the pump's path), the
    pump's stage and retire, and one ``retire_wait`` a window, from its
    dispatch's end to its retire."""
    from reflow_tpu_torch.obs import trace

    g, s, _r = _graph()
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    fe = IngestFrontend(sched, start=False, depth=2,
                        window=CoalesceWindow(max_rows=ROWS, max_ticks=2,
                                              max_latency_s=0.001))
    trace.reset()
    trace.enable()
    try:
        for b in _mk_batches(4, n=4):
            fe.submit(s, b)
        _run_pump_once(fe)
        evs = [ev for _track, ev in trace.events()]
    finally:
        trace.disable()
        trace.reset()
        fe.close()
    names = {ev[0] for ev in evs}
    assert set(trace.WINDOW_SPANS) <= names
    fused = [ev[4] for ev in evs if ev[0] == "tick_many"]
    assert fused and all(a["fused"] and a["staged"] for a in fused)
    kinds = sorted(ev[4]["kind"] for ev in evs
                   if ev[0] == "device_dispatch")
    assert kinds == ["window", "window"]
    waits = sorted((ev for ev in evs if ev[0] == "retire_wait"),
                   key=lambda ev: ev[1])
    retires = sorted((ev for ev in evs if ev[0] == "window_retire"),
                     key=lambda ev: ev[1])
    execs = sorted((ev for ev in evs if ev[0] == "pump_execute"),
                   key=lambda ev: ev[1])
    assert len(waits) == len(retires) == len(execs) == 2
    for w, r, x in zip(waits, retires, execs):
        assert w[1] == pytest.approx(x[1] + x[2], abs=1e-9)
        assert w[1] + w[2] <= r[1]
        assert w[4]["ticks"] == w[4]["last"] - w[4]["first"] + 1
