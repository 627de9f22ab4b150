"""The port's min/max Reduce (the bounded candidate buffer,
``lowerings.minmax_core`` and ``minmax_refresh_core``) against the JAX
package's, on the CPU.

Both lowerings take identical random delta sequences made from a numpy
seed: inserts and retractions of existing rows, retractions of rows that
are not there (anti-rows), values on a small grid that holds ``-0.0``,
``+0.0``, ``inf`` and ``-inf``, scalar and ``V = 3`` vector rows, buffers
of 2 and 4 candidates, so that evictions, anti-rows, the ``over_lo``
watermark and the sticky error all occur. Tolerance: none. Every state
array is bit-equal after every step (floats compared as their bits), and
the emitted rows are equal as multisets. The port sizes its slot table
by ``min(C, K)`` where JAX sizes it by the capacity ``C``; the cases with
``K < C`` pin that the results are still the same.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu import FlowGraph as JFlowGraph
from reflow_tpu import Spec as JSpec
from reflow_tpu.executors import lowerings as jlow
from reflow_tpu.executors.device_delta import DeviceDelta as JDeviceDelta
from reflow_tpu_torch.executors import lowerings as plow
from reflow_tpu_torch.executors.device_delta import DeviceDelta

#: scalar value grid: repeats, both zeros and both infinities
GRID = np.array([-0.0, 0.0, 1.0, 2.0, 2.5, 3.0, -1.0, 7.0, np.inf, -np.inf],
                np.float32)


def _nodes(how, R, K, vshape):
    jg = JFlowGraph()
    jr = jg.reduce(jg.source("in", JSpec(vshape, np.float32, key_space=K)),
                   how, candidates=R)
    pg = P.FlowGraph()
    pr = pg.reduce(pg.source("in", P.Spec(vshape, np.float32, key_space=K)),
                   how, candidates=R)
    return jr, pr


def _states(jr, pr):
    return (jlow.reduce_state(jr.op, jr.inputs[0].spec, jr.spec),
            plow.reduce_state(pr.inputs[0].spec, pr.spec, "cpu", pr.op))


def _pair(keys, vals, w):
    return (JDeviceDelta(jnp.asarray(keys), jnp.asarray(vals),
                         jnp.asarray(w)),
            DeviceDelta(torch.from_numpy(keys.copy()),
                        torch.from_numpy(vals.copy()),
                        torch.from_numpy(w.copy())))


class Stream:
    """Random deltas over a host multiset model: inserts of grid values,
    retractions of present rows, and anti-rows."""

    def __init__(self, seed, K, vshape):
        self.rng = np.random.default_rng(seed)
        self.K, self.vshape = K, vshape
        self.live = []          # (key, value tuple) with multiplicity

    def value(self):
        if self.vshape == ():
            return (float(self.rng.choice(GRID)),)
        return tuple(float(x) for x in self.rng.choice(GRID[:5], 3))

    def step(self, cap, n_live):
        keys = np.zeros(cap, np.int32)
        vals = np.zeros((cap, 1 if self.vshape == () else 3), np.float32)
        w = np.zeros(cap, np.int32)
        for i in range(n_live):
            u = self.rng.random()
            if u < 0.5 or not self.live:
                k, v = int(self.rng.integers(0, self.K)), self.value()
                wt = int(self.rng.choice([1, 1, 2]))
                self.live.extend([(k, v)] * wt)
            elif u < 0.85:
                k, v = self.live.pop(int(self.rng.integers(len(self.live))))
                wt = -1
            else:
                k, v, wt = int(self.rng.integers(0, self.K)), self.value(), -1
            keys[i], vals[i], w[i] = k, v, wt
        vals = vals.reshape((cap,) + self.vshape)
        return _pair(keys, vals, w)


def _rows(d):
    """A delta's live rows as a multiset of (key, value bits)."""
    k, v, w = (np.asarray(x) for x in d)
    c = Counter()
    for i in np.nonzero(w)[0]:
        c[(int(k[i]), v[i].reshape(-1).view(np.uint32).tobytes())] += int(w[i])
    return c


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_states(jst, pst):
    assert set(jst) == set(pst)
    for name, a in jst.items():
        p = pst[name].numpy()
        assert p.dtype == np.asarray(a).dtype, name
        np.testing.assert_array_equal(_bits(p), _bits(a), err_msg=name)


def _run(how, R, K, cap, vshape, seed, steps=8, n_live=None):
    jr, pr = _nodes(how, R, K, vshape)
    jst, pst = _states(jr, pr)
    stream = Stream(seed, K, vshape)
    errors = []
    for _ in range(steps):
        jd, pd = stream.step(cap, n_live if n_live is not None
                             else cap * 3 // 4)
        jout, jst = jlow.minmax_core(jr.op, K, vshape, np.float32, jst, jd)
        pout, pst = plow.minmax_core(pr.op, K, vshape, torch.float32, pst,
                                     pd)
        assert pout.capacity == jout.capacity == 2 * K
        assert _rows(pout) == _rows(jout)
        _assert_states(jst, pst)
        errors.append(bool(pst["error"]))
    return jst, pst, errors, jr, pr, stream


@pytest.mark.parametrize("how", ["min", "max"])
@pytest.mark.parametrize("vshape", [(), (3,)])
@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("K,cap", [(16, 64), (256, 64)],
                         ids=["slots<C", "slots=C"])
def test_minmax_core_matches_jax(how, vshape, R, K, cap):
    """Eight steps of random deltas; the first case (K = 16 < C = 64)
    runs the port with fewer slots than JAX."""
    jst, pst, errors, *_ = _run(how, R, K, cap, vshape,
                                seed=R * 10 + K + len(vshape))
    if K < cap:
        # many rows a key: the stream reached the buffer's edges
        assert (~torch.isinf(pst["over_lo"])).any()
        assert pst["over_maybe_pos"].any()


def test_sticky_error_and_anti_rows_occur():
    """With two candidates and heavy retraction churn the buffer loses
    track: both packages set the sticky error at the same step, and
    negative-weight anti-rows sit in the buffer on the way."""
    seen_neg = False
    jr, pr = _nodes("min", 2, 8, ())
    jst, pst = _states(jr, pr)
    stream = Stream(5, 8, ())
    errs = []
    for _ in range(12):
        jd, pd = stream.step(64, 48)
        jout, jst = jlow.minmax_core(jr.op, 8, (), np.float32, jst, jd)
        pout, pst = plow.minmax_core(pr.op, 8, (), torch.float32, pst, pd)
        assert _rows(pout) == _rows(jout)
        _assert_states(jst, pst)
        seen_neg |= bool((pst["cand_w"] < 0).any())
        errs.append(bool(pst["error"]))
    assert seen_neg
    assert errs[-1] and not errs[0]


@pytest.mark.parametrize("kind", ["zero_rows", "all_dead"])
def test_empty_deltas(kind):
    """A zero-capacity delta and a delta whose rows all have weight 0
    leave the state as it was and emit nothing, in both packages."""
    for how in ("min", "max"):
        jst, pst, _, jr, pr, _ = _run(how, 2, 16, 64, (), seed=3, steps=3)
        cap = 0 if kind == "zero_rows" else 64
        jd, pd = _pair(np.arange(cap, dtype=np.int32) % 16,
                       np.full(cap, 5.0, np.float32),
                       np.zeros(cap, np.int32))
        before = {k: v.clone() for k, v in pst.items()}
        jout, jst = jlow.minmax_core(jr.op, 16, (), np.float32, jst, jd)
        pout, pst = plow.minmax_core(pr.op, 16, (), torch.float32, pst, pd)
        assert not _rows(pout) and not _rows(jout)
        _assert_states(jst, pst)
        for k, v in before.items():
            np.testing.assert_array_equal(_bits(v.numpy()),
                                          _bits(pst[k].numpy()), err_msg=k)


def _rows_of(vshape, vals):
    """Scalar values as value rows of ``vshape`` (``(v, v / 2, -v)``)."""
    vals = np.asarray(vals, np.float32)
    if vshape == ():
        return vals
    return np.stack([vals, vals / 2, -vals], axis=-1)


@pytest.mark.parametrize("vshape", [(), (3,)])
def test_refresh_matches_jax(vshape):
    """Keys 0-7 get values 1, 2, 3, 4 into two-candidate buffers (3 and
    4 are evicted: the latches set), then 3 and 4 are retracted, so each
    live multiset is {1, 2} again. A refresh from the true replay of keys
    0-3 clears their latches and leaves keys 4-7 latched, bit-equal to
    JAX, the error flag clear; a replay that contradicts the state (one
    row dropped) gives bit-equal states too, with the error set."""
    K, cap = 16, 64
    jr, pr = _nodes("min", 2, K, vshape)
    jst, pst = _states(jr, pr)
    keys = np.repeat(np.arange(8, dtype=np.int32), 4)
    vals = np.tile(np.array([1.0, 2.0, 3.0, 4.0], np.float32), 8)
    for w in (np.ones(32, np.int32), np.tile([0, 0, -1, -1], 8)):
        jd, pd = _pair(np.pad(keys, (0, cap - 32)),
                       np.pad(_rows_of(vshape, vals),
                              [(0, cap - 32)] + [(0, 0)] * len(vshape)),
                       np.pad(w.astype(np.int32), (0, cap - 32)))
        _, jst = jlow.minmax_core(jr.op, K, vshape, np.float32, jst, jd)
        _, pst = plow.minmax_core(pr.op, K, vshape, torch.float32, pst, pd)
    _assert_states(jst, pst)
    assert pst["over_maybe_pos"][:8].all() and not bool(pst["error"])

    def refresh(w_):
        ks = np.pad(np.repeat(np.arange(4, dtype=np.int32), 2), (0, 56))
        vs = np.pad(_rows_of(vshape, np.tile([1.0, 2.0], 4)),
                    [(0, 56)] + [(0, 0)] * len(vshape))
        j = jlow.minmax_refresh_core(
            jr.op, K, vshape, np.float32, dict(jst),
            JDeviceDelta(jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(w_)))
        p = plow.minmax_refresh_core(
            pr.op, K, vshape, torch.float32,
            {k: v.clone() for k, v in pst.items()},
            DeviceDelta(torch.from_numpy(ks), torch.from_numpy(vs),
                        torch.from_numpy(w_)))
        _assert_states(j, p)
        return p

    w = np.pad(np.ones(8, np.int32), (0, 56))
    p = refresh(w)
    assert not bool(p["error"])
    assert not p["over_maybe_pos"][:4].any() and p["over_maybe_pos"][4:8].all()
    assert torch.isinf(p["over_lo"][:4]).all()
    w[0] = 0        # key 0's replay without its minimum
    assert bool(refresh(w)["error"])


def test_refresh_contradiction_sets_error():
    """A replay whose minimum differs from the state's sets the sticky
    error in both packages."""
    K = 8
    jr, pr = _nodes("min", 4, K, ())
    jst, pst = _states(jr, pr)
    jd, pd = _pair(np.array([3, 3, 5] + [0] * 61, np.int32),
                   np.array([1.0, 2.0, 4.0] + [0.0] * 61, np.float32),
                   np.array([1, 1, 1] + [0] * 61, np.int32))
    _, jst = jlow.minmax_core(jr.op, K, (), np.float32, jst, jd)
    _, pst = plow.minmax_core(pr.op, K, (), torch.float32, pst, pd)
    assert not bool(pst["error"])
    # key 3's replay without its minimum 1.0
    jd, pd = _pair(np.array([3] + [0] * 63, np.int32),
                   np.array([2.0] + [0.0] * 63, np.float32),
                   np.array([1] + [0] * 63, np.int32))
    jst = jlow.minmax_refresh_core(jr.op, K, (), np.float32, jst, jd)
    pst = plow.minmax_refresh_core(pr.op, K, (), torch.float32, pst, pd)
    _assert_states(jst, pst)
    assert bool(pst["error"]) and bool(jst["error"])
