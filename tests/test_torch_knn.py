"""The port's k-NN slice (reflow_tpu_torch) against the JAX package and
the CPU oracle, on the CPU at a small size.

The same delta stream — made with numpy from a seed — runs through the
port's ``DirtyScheduler`` on ``get_executor("cuda", device="cpu")`` (its
plain PyTorch path), through the JAX ``TpuExecutor`` on the CPU, and
through the port's ``CpuExecutor``. Tolerances: ids exact and scores
within 1e-5 in float32 (the same sums in another order differ by a few
ulp of a unit-range cosine); bf16/int8 tables are held by recall and a
1e-2 score bound (the bf16 inputs' own rounding scale).
"""

import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu import DeltaBatch as JDeltaBatch
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.workloads import knn as jknn
from reflow_tpu_torch.convert import states_from_jax, states_to_numpy
from reflow_tpu_torch.graph import FlowGraph, GraphError
from reflow_tpu_torch.workloads import knn as pknn

Q, D, DIM, K = 16, 256, 32, 4


class Run:
    """One package's scheduler over the k-NN graph, fed host batches."""

    def __init__(self, which, seed=0, **graph_kw):
        if which == "jax":
            self.kg = jknn.build_graph(Q, D, DIM, K, scan_chunk=D, **graph_kw)
            self.sched = JDirtyScheduler(self.kg.graph, jget_executor("tpu"))
            self.DB = JDeltaBatch
        else:
            self.kg = pknn.build_graph(Q, D, DIM, K, scan_chunk=D,
                                       **graph_kw)
            ex = (P.get_executor("cuda", device="cpu") if which == "port"
                  else P.CpuExecutor())
            self.sched = P.DirtyScheduler(self.kg.graph, ex)
            self.DB = P.DeltaBatch

    def push(self, src, keys, vals, w=1):
        keys = np.asarray(keys, np.int64)
        node = self.kg.queries if src == "q" else self.kg.docs
        self.sched.push(node, self.DB(keys, vals,
                                      np.full(len(keys), w, np.int64)))

    def tick(self):
        self.sched.tick()
        return self

    def table(self):
        return {int(q): np.asarray(r, np.float32)
                for q, r in self.sched.read_table(self.kg.index).items()}


def _stream(seed):
    """The tests/test_knn.py ``_drive`` sequence as (source, keys, values,
    weight) pushes per tick, made from one numpy seed."""
    rng = np.random.default_rng(seed)

    def vecs(n):
        return rng.standard_normal((n, DIM)).astype(np.float32)

    docs = {}

    def ins(ids):
        v = vecs(len(ids))
        docs.update(zip(map(int, ids), v))
        return ("d", ids, v, 1)

    def ret(ids):
        return ("d", ids, np.stack([docs.pop(int(i)) for i in ids]), -1)

    return [
        [("q", np.arange(Q), vecs(Q), 1), ins(np.arange(0, 64))],
        [ins(np.arange(64, 128))],               # incremental path
        [ret(np.arange(10, 30))],                # full rescan
        [ins(np.arange(128, 160))],              # incremental again
    ]


def _drive(run, ticks):
    for pushes in ticks:
        for p in pushes:
            run.push(*p)
        run.tick()
    return run


def _assert_tables(a, b, atol=1e-5):
    assert set(a) == set(b)
    for q in a:
        np.testing.assert_array_equal(a[q][:, 0], b[q][:, 0])
        np.testing.assert_allclose(a[q][:, 1], b[q][:, 1], atol=atol)


@pytest.mark.parametrize("seed", [0, 3])
def test_port_matches_jax_and_oracle(seed):
    ticks = _stream(seed)
    port = _drive(Run("port"), ticks).table()
    jax_ = _drive(Run("jax"), ticks).table()
    cpu = _drive(Run("cpu"), ticks).table()
    assert len(port) == Q
    _assert_tables(port, jax_)
    _assert_tables(port, cpu)


def test_host_branch_sync_counted():
    run = _drive(Run("port"), _stream(1))
    # per tick: the synchronous tick's readback + the k-NN lowering's
    # one host branch decision; then the read_table readback
    assert run.sched.forced_syncs == 2 * 4
    run.table()
    assert run.sched.forced_syncs == 2 * 4 + 1
    assert run.sched.executor.host_syncs == 4


def _edge_ticks(seed):
    rng = np.random.default_rng(seed)

    def vecs(n):
        return rng.standard_normal((n, DIM)).astype(np.float32)

    return [
        [("q", np.arange(Q), vecs(Q), 1), ("d", np.arange(48), vecs(48), 1)],
        # in-place doc update: re-insert live ids with new vectors
        [("d", np.arange(0, 12), vecs(12), 1)],
        # query retraction: those queries stop emitting
        [("q", np.arange(3), np.zeros((3, DIM), np.float32), -1)],
        [("d", np.arange(48, 64), vecs(16), 1)],
    ]


def test_in_place_update_and_query_retraction():
    ticks = _edge_ticks(5)
    port = _drive(Run("port"), ticks).table()
    _assert_tables(port, _drive(Run("jax"), ticks).table())
    _assert_tables(port, _drive(Run("cpu"), ticks).table())
    assert set(port) == set(range(3, Q))


@pytest.mark.parametrize("bad", [[D, D + 7], [-1, -3], [-D - 5]])
def test_out_of_range_doc_keys_match_jax(bad):
    """Keys outside [0, key_space): the JAX package wraps a negative key
    once, clamps its gathers and drops its scatters; the port reproduces
    that result on both paths and never indexes out of range."""
    rng = np.random.default_rng(9)
    base = [("q", np.arange(Q), rng.standard_normal((Q, DIM)
                                                    ).astype(np.float32), 1),
            ("d", np.arange(40), rng.standard_normal((40, DIM)
                                                     ).astype(np.float32), 1)]
    bad = np.asarray(bad)
    v = rng.standard_normal((len(bad), DIM)).astype(np.float32)
    for ticks in ([base, [("d", bad, v, 1)]],              # incremental
                  [base, [("d", bad, v, 1),                # rescan
                          ("d", np.arange(2), np.zeros((2, DIM),
                                                       np.float32), -1)]]):
        port = _drive(Run("port"), ticks).table()
        _assert_tables(port, _drive(Run("jax"), ticks).table())


@pytest.mark.parametrize("doc", ["bf16", "int8"])
def test_low_precision_tables_match_jax(doc):
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    qv = rng.standard_normal((Q, DIM)).astype(np.float32)
    raw = rng.standard_normal((160, DIM)).astype(np.float32)
    wire = jknn.quantize_int8(raw) if doc == "int8" else raw
    ticks = [[("q", np.arange(Q), qv, 1), ("d", np.arange(64), wire[:64], 1)],
             [("d", np.arange(64, 160), wire[64:], 1)],
             [("d", np.arange(10, 20), wire[10:20], -1)]]
    if doc == "int8":
        jkw = dict(dtype=jnp.bfloat16, doc_dtype=jnp.int8,
                   precision="default")
        pkw = dict(dtype=torch.bfloat16, doc_dtype=torch.int8,
                   precision="default")
    else:
        jkw = dict(dtype=jnp.bfloat16, precision="default")
        pkw = dict(dtype=torch.bfloat16, precision="default")
    port = _drive(Run("port", **pkw), ticks).table()
    jax_ = _drive(Run("jax", **jkw), ticks).table()
    assert set(port) == set(jax_) == set(range(Q))
    hits = sum(len(set(port[q][:, 0]) & set(jax_[q][:, 0])) for q in port)
    assert hits / (Q * K) >= 0.95
    for q in port:
        # the same bf16 operands, float32 sums in another order
        np.testing.assert_allclose(np.sort(port[q][:, 1]),
                                   np.sort(jax_[q][:, 1]), atol=1e-2)


def test_state_carried_from_jax_then_one_more_tick():
    """Run JAX to tick n, carry its state into the port, run one more
    tick in both: the tables match."""
    import jax.numpy as jnp

    ticks = _stream(4)
    jrun = _drive(Run("jax"), ticks[:3])
    np_states = {nid: {name: np.asarray(a.astype(jnp.float32)
                                        if a.dtype == jnp.bfloat16 else a)
                       for name, a in st.items()}
                 for nid, st in jrun.sched.executor.states.items()}
    prun = Run("port")
    prun.sched.executor.state_restore(
        states_from_jax(np_states, prun.kg.graph, device="cpu"))
    _drive(jrun, ticks[3:])
    _drive(prun, ticks[3:])
    _assert_tables(prun.table(), jrun.table())
    # and back: the port's state as numpy equals the JAX state after the
    # same tick, up to float32 sum order in the scores
    back = states_to_numpy(prun.sched.executor.states)
    for nid, st in jrun.sched.executor.states.items():
        for name, a in st.items():
            np.testing.assert_allclose(back[nid][name], np.asarray(a),
                                       atol=1e-5)


def test_states_from_jax_rejects_wrong_shape():
    run = Run("port")
    nid = run.kg.index.id
    st = states_to_numpy(run.sched.executor.states)
    st[nid]["dvec"] = st[nid]["dvec"][:-1]
    with pytest.raises(ValueError):
        states_from_jax(st, run.kg.graph, device="cpu")


def test_snapshot_survives_in_place_ticks():
    ticks = _stream(6)
    run = _drive(Run("port"), ticks[:2])
    ex = run.sched.executor
    snap = ex.state_snapshot()
    before = run.table()
    _drive(run, ticks[2:])
    ex.state_restore(snap)
    _assert_tables(run.table(), before, atol=0)
    _drive(run, ticks[2:])                     # the snapshot stays valid
    ex.state_restore(snap)
    _assert_tables(run.table(), before, atol=0)


def test_cuda_executor_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.get_executor("cuda")
    with pytest.raises(RuntimeError):
        P.get_executor("cuda", device="cuda")


def test_entry_points_without_device_need_a_card(monkeypatch):
    """The host boundary and the state carry default to the card too:
    with no card and no ``device=`` they raise rather than stay on the
    host."""
    from reflow_tpu_torch.delta import Spec as PSpec
    from reflow_tpu_torch.executors.device_delta import DeviceDelta, to_device

    run = Run("port")
    st = states_to_numpy(run.sched.executor.states)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = PSpec((DIM,), torch.float32, D)
    b = P.DeltaBatch(np.zeros(1, np.int64), np.zeros((1, DIM), np.float32),
                     np.ones(1, np.int64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_device(b, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDelta.empty(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        states_from_jax(st, run.kg.graph)


def test_unported_op_refused_at_bind():
    """Every op kind of the port has a device lowering, Map ``params``
    included; an op kind without one is what the cuda executor
    refuses."""
    from reflow_tpu_torch.delta import Spec
    from reflow_tpu_torch.ops.core import Op

    class Custom(Op):
        kind = "custom"

    g = FlowGraph("lo")
    src = g.source("s", Spec((), np.float32, key_space=8))
    g.add_op(Custom(), [src])
    with pytest.raises(GraphError, match="not ported yet"):
        P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_to_device_matches_jax_padding(dt):
    """The host boundary: the same batch pads to the same capacity, keys,
    weights (0 on padding rows, key 0) and values as the JAX package's."""
    import jax.numpy as jnp

    from reflow_tpu.delta import Spec as JSpec
    from reflow_tpu.executors.device_delta import to_device as jto_device
    from reflow_tpu_torch.delta import Spec as PSpec
    from reflow_tpu_torch.executors.device_delta import to_device, to_host

    rng = np.random.default_rng(2)
    n = 70
    vals = rng.standard_normal((n, DIM)).astype(np.float32)
    if dt == "int8":
        vals = jknn.quantize_int8(vals)
    jdt, pdt = {"f32": (np.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": (np.int8, torch.int8)}[dt]
    keys = rng.integers(0, D, n)
    w = rng.choice([-1, 1], n)
    pd = to_device(P.DeltaBatch(keys, vals, w), PSpec((DIM,), pdt, D),
                   device="cpu")
    jd = jto_device(JDeltaBatch(keys, vals, w), JSpec((DIM,), jdt, D))
    assert pd.capacity == jd.capacity == 128
    np.testing.assert_array_equal(pd.keys.numpy(), np.asarray(jd.keys))
    np.testing.assert_array_equal(pd.weights.numpy(), np.asarray(jd.weights))
    np.testing.assert_array_equal(pd.values.float().numpy(),
                                  np.asarray(jd.values.astype(jnp.float32)))
    assert pd.values.dtype == pdt and len(pd) == n
    back = to_host(pd)
    np.testing.assert_array_equal(back.keys, keys)
    np.testing.assert_array_equal(back.weights, w)


def test_to_device_refuses_weight_mass_beyond_float32():
    from reflow_tpu_torch.delta import Spec as PSpec
    from reflow_tpu_torch.executors.device_delta import to_device

    b = P.DeltaBatch(np.zeros(2, np.int64), np.zeros((2, DIM), np.float32),
                     np.array([1 << 23, 1 << 23]))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        to_device(b, PSpec((DIM,), torch.float32, D), device="cpu")
