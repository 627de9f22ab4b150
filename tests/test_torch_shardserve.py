"""Sharded windows: the mesh tests of ``tests/test_shardserve.py``.

The port's ShardedCudaExecutor runs the SAME window protocol as the
single-device executor (``tick_many`` over the device ingress queue),
with the queue's capacity axis split over the mesh's shards; the tables
must equal the CPU per-tick oracle and the JAX sharded window path
exactly (integer-valued float32 sums), with no fallback. The placement
tests of that file are in ``test_torch_tier.py``.
"""

import numpy as np
import pytest

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.parallel import make_mesh as jmake_mesh
from reflow_tpu.parallel.shard import ShardedTpuExecutor
from reflow_tpu_torch.executors.device_delta import ShardedDelta
from reflow_tpu_torch.graph import GraphError
from reflow_tpu_torch.parallel import make_mesh
from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

from test_torch_megatick import (K_SPACE, _batch, _exact, _oracle,
                                 _rounded, _small_graph)


@pytest.fixture(autouse=True)
def _jax_scratch_copies(monkeypatch):
    # the reference queue's host scratch reuse races its asynchronous
    # transfers under load (see test_torch_megatick.py)
    import reflow_tpu.executors.ingress_queue as jiq

    monkeypatch.setattr(jiq, "_SCRATCH_REUSE_SAFE", False)


def _mixed_ticks(seed, n_ticks=4, rows=6):
    """Ragged insert/retract feeds with integer-valued payloads, so every
    sum is exact in float32 whatever the shards' order."""
    rng = np.random.default_rng(seed)
    ticks, inserted = [], []
    for t in range(n_ticks):
        tick = {}
        for s_ix in (0, 1):
            if s_ix == 1 and t % 2 == 1:
                continue
            rws = []
            for _ in range(rows):
                if inserted and rng.random() < 0.25:
                    k, v = inserted.pop(int(rng.integers(0, len(inserted))))
                    rws.append((k, v, -1))
                else:
                    k = int(rng.integers(0, K_SPACE))
                    v = float(rng.integers(0, 8))
                    rws.append((k, v, 1))
                    inserted.append((k, v))
            tick[s_ix] = rws
        ticks.append(tick)
    return ticks


def _sharded_window_drive(pkg, ticks, k, n):
    g, (s0, s1), r = _small_graph(pkg)
    ex = (ShardedCudaExecutor(make_mesh(n, device="cpu")) if pkg is P
          else ShardedTpuExecutor(jmake_mesh(n)))
    sched = pkg.DirtyScheduler(g, ex)
    srcs = {0: s0, 1: s1}
    results = [sched.tick_many(
        [{srcs[s_ix]: _batch(pkg, rows) for s_ix, rows in tick.items()}
         for tick in ticks[lo:lo + k]]) for lo in range(0, len(ticks), k)]
    for res in results:
        res.block()
    return _rounded(_exact(sched, r)), sched


@pytest.mark.parametrize("n,k,seed", [(2, 2, 7), (2, 4, 8),
                                      (4, 2, 9), (4, 4, 10)])
def test_sharded_window_parity_fuzz(n, k, seed):
    ticks = _mixed_ticks(seed, n_ticks=2 * k)
    want = _oracle(ticks)
    got, sched = _sharded_window_drive(P, ticks, k, n)
    assert got == want, f"n={n} k={k} seed={seed}"
    assert sched.megatick_fallbacks == 0
    assert sched.megatick_windows == 2
    assert sched.executor.device_label == f"mesh[{n}]"
    jgot, _ = _sharded_window_drive(J, ticks, k, n)
    assert got == jgot


def test_sharded_queue_buffers_are_sharded():
    """The queue under a sharded executor splits each source's capacity
    axis over the shards: one [K, cap/n] buffer per shard on its device,
    handed to the window as a ShardedDelta."""
    ticks = _mixed_ticks(31, n_ticks=2)
    _got, sched = _sharded_window_drive(P, ticks, k=2, n=2)
    ex = sched.executor
    qkeys = [key for key in ex._window_cache
             if isinstance(key, tuple) and key and key[0] == "ingress_q"]
    assert len(qkeys) == 1
    queue = ex._window_cache[qkeys[0]]
    stacked = queue.stacked()
    assert stacked
    for nid, dd in stacked.items():
        assert isinstance(dd, ShardedDelta) and len(dd) == 2
        for part, dev in zip(dd, ex.mesh.device_list):
            assert tuple(part.keys.shape) == (2, queue.caps[nid] // 2)
            assert part.keys.device == dev


def test_sharded_executor_refuses_single_device_placement():
    ex = ShardedCudaExecutor(make_mesh(2, device="cpu"))
    with pytest.raises(GraphError, match="mesh"):
        ex.place(0)
