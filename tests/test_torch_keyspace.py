"""Keys at or past a Spec's ``key_space``, and negative keys, op by op:
the port's ``"cuda"`` executor (at ``device="cpu"``) against the JAX
``"tpu"`` executor, on the CPU.

The device lowerings of both packages index dense tables by key. A key
at or past ``key_space`` drops out of a scatter and clamps in a gather;
a negative key wraps once (``-1`` is the last row), but for the min/max
Reduce, whose JAX slotting drops a delta's smallest key when it is
``-1``. The port's lowerings are held to JAX's on every keyed op for
such keys: a key past ``key_space`` from a GroupBy's re-key (the way it
reaches a lowering in a running graph) or a device batch pushed as it
is, a negative key also from a host push.

The CPU oracle keeps a row at or past ``key_space`` where the device
executors lose it, so the port refuses such a key with
``DeliveryError`` where a host batch is accepted (``push``,
``tick_many``, the durable scheduler before its log, the serving
frontend's ``submit`` as a rejected ticket) and again at every host
upload (``to_device``, the ingress queue's write, ``shard_batch``,
``shard_batch_process_local``); the JAX package drops it silently
(ROADMAP.md, reference caveats). Negative keys pass in both.
"""

import numpy as np
import pytest
import torch

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu_torch.executors.device_delta import (DeviceDelta,
                                                     bucket_capacity,
                                                     to_device)
from reflow_tpu_torch.executors.ingress_queue import DeviceIngressQueue
from reflow_tpu_torch.parallel import (make_mesh, shard_batch,
                                       shard_batch_process_local)
from reflow_tpu_torch.utils.faults import DeliveryError

#: the key_space of every keyed op's input below
K = 8
#: the k-NN's query and doc tables
Q, D, DIM = 4, 8, 4
F32 = np.float32

OPS = ["reduce_sum", "reduce_count", "reduce_mean", "reduce_min",
       "reduce_max", "join_unique", "join_multiset", "groupby_reduce",
       "knn_query", "knn_doc", "arena_append"]
#: a key equal to key_space, one past it, -1, and -2 (min/max wrap it
#: while they drop -1)
BAD = {"at": lambda n: n, "past": lambda n: n + 1, "neg1": lambda n: -1,
       "neg2": lambda n: -2}


def _port_device_batch(spec, keys, vals, weights):
    """A port device batch with these raw keys, built without the upload
    (whose check would refuse them): how a lowering meets a key a
    re-keying op produced."""
    n = len(keys)
    cap = bucket_capacity(n)
    vshape = tuple(spec.value_shape)
    k = torch.zeros(cap, dtype=torch.int32)
    v = torch.zeros((cap,) + vshape, dtype=torch.float32)
    w = torch.zeros(cap, dtype=torch.int32)
    k[:n] = torch.tensor(keys, dtype=torch.int32)
    v[:n] = torch.from_numpy(np.asarray(vals, F32).reshape((n,) + vshape))
    w[:n] = torch.tensor(weights, dtype=torch.int32)
    return DeviceDelta(k, v, w)


def _case(pkg, op, bad_of):
    """``(graph, ticks)``: each tick a list of ``(source, keys, values,
    weights)`` pushes; one key in them is out of range."""
    g = pkg.FlowGraph("ks")
    S = pkg.Spec
    bad = bad_of(K)
    if op.startswith("reduce_"):
        s = g.source("s", S((), F32, key_space=K))
        g.sink(g.reduce(s, op[len("reduce_"):]), "out")
        return g, [[(s, [1, bad, 3, bad], [1., 5., 2., 4.], [1, 1, 1, 1])],
                   [(s, [3, bad], [7., 5.], [1, -1])]]
    if op == "groupby_reduce":
        s = g.source("s", S((), F32, key_space=64))
        gb = g.group_by(s, lambda k, v: k + (k == 2) * (bad - 2),
                        vectorized=True, spec=S((), F32, key_space=K))
        g.sink(g.reduce(gb, "sum"), "out")
        return g, [[(s, [1, 2, 3, 2], [1., 5., 2., 4.], [1, 1, 1, 1])],
                   [(s, [2, 3], [5., 1.], [-1, 1])]]
    if op in ("join_unique", "join_multiset", "arena_append"):
        a = g.source("a", S((), F32, key_space=K,
                            unique=(op != "join_multiset")))
        b = g.source("b", S((), F32, key_space=K))
        g.sink(g.join(a, b, spec=S((2,), F32, key_space=K),
                      arena_capacity=64, name="j"), "out")
        if op == "arena_append":
            return g, [[(a, [1, 3, 7], [1., 2., 3.], [1, 1, 1])],
                       [(b, [1, bad, 3], [10., 20., 30.], [1, 1, 1])],
                       [(b, [bad], [20.], [-1])]]
        return g, [[(b, [1, 7, 3, 6], [10., 20., 30., 40.], [1, 1, 1, 1])],
                   [(a, [1, bad, 3], [1., 2., 3.], [1, 1, 1])],
                   [(a, [bad], [2.], [-1])]]
    if op in ("knn_query", "knn_doc"):
        q = g.source("q", S((DIM,), F32, key_space=Q))
        d = g.source("d", S((DIM,), F32, key_space=D))
        g.sink(g.knn(q, d, k=2, dim=DIM, scan_chunk=8), "out")
        rng = np.random.default_rng(0)
        qv = rng.standard_normal((3, DIM)).astype(F32)
        dv = rng.standard_normal((4, DIM)).astype(F32)
        if op == "knn_query":
            bq = bad_of(Q)
            return g, [[(d, [0, 1, 2, 5], dv, [1] * 4)],
                       [(q, [0, bq, 2], qv, [1] * 3)],
                       [(d, [6], dv[:1] * 2, [1])],
                       [(q, [bq], qv[1:2], [-1])]]
        bd = bad_of(D)
        return g, [[(q, [0, 1, 2], qv, [1] * 3)],
                   [(d, [0, bd, 2, 5], dv, [1] * 4)],
                   [(d, [7], dv[1:2] * 3, [1])],
                   [(d, [bd], dv[1:2], [-1])]]
    raise KeyError(op)


def _view(sched):
    """The sink's view as sorted (key, values, weight) rows."""
    rows = []
    for (k, v), w in sched.view("out").items():
        rows.append((int(k), np.atleast_1d(np.asarray(v, F32)).ravel(),
                     int(w)))
    return sorted(rows, key=lambda r: (r[0], tuple(r[1]), r[2]))


def _run(pkg, op, bad_of):
    g, ticks = _case(pkg, op, bad_of)
    if pkg is P:
        sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    else:
        sched = J.DirtyScheduler(g, jget_executor("tpu"))
    views = []
    for tick in ticks:
        for src, keys, vals, w in tick:
            if pkg is P and 0 < src.spec.key_space <= max(keys):
                # the push would refuse it: meet the lowering directly
                batch = _port_device_batch(src.spec, keys, vals, w)
            else:
                batch = pkg.DeltaBatch(np.array(keys, np.int64),
                                       np.asarray(vals, F32),
                                       np.array(w, np.int64))
            sched.push(src, batch)
        sched.tick()
        views.append(_view(sched))
    arena = None
    if op == "arena_append":
        st = sched.executor.states[g.nodes[2].id]
        n = int(np.asarray(st["rcount"]))
        arena = (n, np.asarray(st["rkeys"])[:n].tolist(),
                 np.asarray(st["rw"])[:n].tolist())
    return views, arena


@pytest.mark.parametrize("which", list(BAD))
@pytest.mark.parametrize("op", OPS)
def test_keyed_op_matches_jax_at_out_of_range_keys(op, which):
    """Every tick's sink view of the port's lowering equals JAX's: keys
    and weights exactly, values within 1e-5 (the k-NN's scores sum in
    another order); the arena's rows exactly."""
    got, got_arena = _run(P, op, BAD[which])
    want, want_arena = _run(J, op, BAD[which])
    assert len(got) == len(want)
    for t, (g_rows, w_rows) in enumerate(zip(got, want)):
        assert [(k, w) for k, _, w in g_rows] == \
            [(k, w) for k, _, w in w_rows], (t, g_rows, w_rows)
        for (_, gv, _), (_, wv, _) in zip(g_rows, w_rows):
            np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)
    assert got_arena == want_arena


@pytest.mark.parametrize("how", ["sum", "count", "mean", "min", "max"])
def test_minmax_drops_minus_one_where_sum_wraps_it(how):
    """The negative-key rule as it stands in both packages, for a host
    push (which accepts negative keys): a Reduce's key -1 wraps to the
    last row for sum/count/mean and drops for min/max (JAX's slotting
    sentinel); -2 wraps for all five. The oracle keeps both as they are
    (ROADMAP.md, reference caveats)."""
    for bad, want_key in ((-1, None if how in ("min", "max") else K - 1),
                          (-2, K - 2)):
        views = []
        for pkg in (P, J):
            views.append(_run(pkg, f"reduce_{how}", lambda n: bad)[0][0])
        keys = {k for k, _, _ in views[0]}
        assert keys == {k for k, _, _ in views[1]}
        assert keys == {1, 3} | ({want_key} if want_key is not None
                                 else set())


# -- the upload refuses keys at or past key_space -------------------------

def _spec(key_space=K):
    return P.Spec((), F32, key_space=key_space)


def _batch(keys):
    return P.DeltaBatch(np.array(keys, np.int64),
                        np.ones(len(keys), F32))


def _upload_to_device(keys):
    return to_device(_batch(keys), _spec(), device="cpu", source="source 's'")


def _upload_queue_write(keys):
    q = DeviceIngressQueue({0: _spec()}, {0: 64}, 2, placement="cpu")
    q.write(0, 0, _batch(keys), "source 's'")
    return q


def _upload_shard_batch(keys):
    mesh = make_mesh(2, device="cpu")
    return shard_batch([_batch([1]), _batch(keys)], _spec(), mesh)


def _upload_shard_batch_process_local(keys):
    mesh = make_mesh(2, device="cpu")
    return shard_batch_process_local(_batch(keys), _spec(), mesh,
                                     capacity=64)


def _reduce_sched(ex, how="sum", sink=True):
    g = P.FlowGraph()
    src = g.source("s", _spec())
    red = g.reduce(src, how)
    if sink:
        g.sink(red, "out")
    return P.DirtyScheduler(g, ex), src


def _upload_tick(keys):
    sched, src = _reduce_sched(P.get_executor("cuda", device="cpu"))
    sched.push(src, _batch(keys))
    sched.tick()
    return sched


def _upload_tick_many(keys):
    # a sink-free graph: its windows run through the device ingress queue
    sched, src = _reduce_sched(P.get_executor("cuda", device="cpu"),
                               sink=False)
    sched.tick_many([{src: _batch([1, 2])}, {src: _batch(keys)}])
    assert sched.megatick_windows == 1
    return sched


def _upload_sharded_tick(keys):
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    sched, src = _reduce_sched(ShardedCudaExecutor(make_mesh(2,
                                                             device="cpu")))
    sched.push(src, _batch(keys))
    sched.tick()
    return sched


UPLOADS = {"to_device": _upload_to_device,
           "queue_write": _upload_queue_write,
           "shard_batch": _upload_shard_batch,
           "shard_batch_process_local": _upload_shard_batch_process_local,
           "tick": _upload_tick,
           "tick_many": _upload_tick_many,
           "sharded_tick": _upload_sharded_tick}


@pytest.mark.parametrize("which", ["at", "past", "neg1"])
@pytest.mark.parametrize("path", list(UPLOADS))
def test_every_upload_refuses_keys_at_or_past_key_space(path, which):
    """A key at or past ``key_space`` raises ``DeliveryError`` naming the
    source (where the path knows it) and the ``key_space``; -1 passes, to
    wrap in the lowerings as JAX's does. The scheduler's paths refuse
    at the push; the bare uploads hold the same check."""
    keys = [1, 2, BAD[which](K)]
    if which == "neg1":
        assert UPLOADS[path](keys) is not None
        return
    with pytest.raises(DeliveryError) as e:
        UPLOADS[path](keys)
    msg = str(e.value)
    assert f"key {keys[-1]} is at or past the Spec's key_space {K}" in msg
    if path in ("to_device", "queue_write", "tick", "tick_many",
                "sharded_tick"):
        assert msg.startswith("source 's'"), msg
    else:
        assert msg.startswith("shard_batch"), msg


def test_undeclared_key_space_takes_any_int32_key():
    """A Spec with no ``key_space`` (0: a host-only graph) bounds no key:
    only the int32 range is checked."""
    d = to_device(_batch([1, 2 ** 31 - 1]), _spec(0), device="cpu")
    assert d.keys[:2].tolist() == [1, 2 ** 31 - 1]


@pytest.mark.parametrize("how", ["sum", "count", "mean", "min", "max"])
@pytest.mark.parametrize("which", ["at", "past"])
def test_jax_drops_what_the_port_refuses(how, which):
    """The reference caveat, pinned: the CPU oracle keeps a row whose key
    is at or past ``key_space``, the JAX device executor drops it with no
    error, and the port refuses it at the upload."""
    bad = BAD[which](K)
    keys = np.array([1, bad, 3], np.int64)
    vals = np.array([1.0, 5.0, 2.0], F32)
    views = {}
    for name, pkg, ex in (("oracle", P, P.CpuExecutor()),
                          ("jax", J, jget_executor("tpu"))):
        g = pkg.FlowGraph()
        src = g.source("s", pkg.Spec((), F32, key_space=K))
        g.sink(g.reduce(src, how), "out")
        sched = pkg.DirtyScheduler(g, ex)
        sched.push(src, pkg.DeltaBatch(keys, vals))
        sched.tick()
        views[name] = {int(k) for k in sched.view_dict("out")}
    assert views["oracle"] == {1, bad, 3}
    assert views["jax"] == {1, 3}
    sched, src = _reduce_sched(P.get_executor("cuda", device="cpu"), how)
    with pytest.raises(DeliveryError, match=f"key_space {K}"):
        sched.push(src, P.DeltaBatch(keys, vals))


# -- a refused batch leaves no trace --------------------------------------

def _sum_graph():
    g = P.FlowGraph()
    src = g.source("s", _spec())
    g.sink(g.reduce(src, "sum"), "out")
    return g, src


GOOD, BAD_ROWS, FIXED = [1, 2], [1, K], [1, 3]


def _oracle_view(batches):
    g, src = _sum_graph()
    sched = P.DirtyScheduler(g, P.CpuExecutor())
    for keys in batches:
        sched.push(src, _batch(keys))
    sched.tick()
    return sched.view_dict("out")


def test_push_refusal_holds_no_id_and_drops_no_other_batch():
    """``push`` refuses before the dedup window takes the id and before
    the pending buffers take the batch: a corrected resubmit under the
    same id is accepted, and the other sources' batches of the tick
    fold."""
    g, src = _sum_graph()
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    assert sched.push(src, _batch(GOOD), batch_id="a")
    with pytest.raises(DeliveryError, match="source 's'"):
        sched.push(src, _batch(BAD_ROWS), batch_id="b")
    assert "b" not in sched._seen_batch_ids
    assert sched.push(src, _batch(FIXED), batch_id="b")
    assert not sched.push(src, _batch(FIXED), batch_id="b")
    sched.tick()
    assert sched.view_dict("out") == _oracle_view([GOOD, FIXED])
    with pytest.raises(DeliveryError):
        sched.tick_many([{src: _batch(GOOD)}, {src: _batch(BAD_ROWS)}],
                        feed_ids=[{src: ["c"]}, {src: ["d"]}])
    assert "c" not in sched._seen_batch_ids and sched._tick == 1


@pytest.mark.parametrize("path", ["push", "tick_many"])
def test_durable_refusal_logs_nothing_and_recovers(path, tmp_path):
    """The durable scheduler refuses before its log: the WAL holds only
    the accepted batches, and ``recover`` of it into a fresh scheduler
    replays them to the live view."""
    from reflow_tpu_torch.wal import DurableScheduler, recover, scan_wal

    wal = str(tmp_path / "wal")
    g, src = _sum_graph()
    sched = DurableScheduler(g, P.get_executor("cuda", device="cpu"),
                             wal_dir=wal, committer="inline")
    sched.push(src, _batch(GOOD), batch_id="a")
    sched.tick()
    n0 = len(scan_wal(wal)[0])
    with pytest.raises(DeliveryError, match=f"key_space {K}"):
        if path == "push":
            sched.push(src, _batch(BAD_ROWS), batch_id="b")
        else:
            sched.tick_many([{src: _batch(BAD_ROWS)}],
                            feed_ids=[{src: ["b"]}])
    assert len(scan_wal(wal)[0]) == n0 and "b" not in sched._seen_batch_ids
    sched.push(src, _batch(FIXED), batch_id="b")
    sched.tick()
    live = sched.view_dict("out")
    assert live == _oracle_view([GOOD, FIXED])
    sched.close()
    g2, _ = _sum_graph()
    back = DurableScheduler(g2, P.get_executor("cuda", device="cpu"),
                            wal_dir=str(tmp_path / "wal2"),
                            committer="inline")
    recover(back, wal)
    assert back.view_dict("out") == live
    back.close()


def test_frontend_rejects_the_ticket_and_keeps_serving():
    """The serving frontend turns the refusal into that ticket's
    REJECTED, before its id is admitted: the frontend stays running, the
    other producers' tickets apply, and a corrected resubmit under the
    same id applies."""
    from reflow_tpu_torch.serve.tickets import APPLIED, REJECTED

    g, src = _sum_graph()
    sched = P.DirtyScheduler(g, P.get_executor("cuda", device="cpu"))
    with P.IngestFrontend(sched) as fe:
        t_good = fe.submit(src, _batch(GOOD), batch_id="a")
        t_bad = fe.submit(src, _batch(BAD_ROWS), batch_id="b")
        assert t_bad.result(timeout=60).status == REJECTED
        assert f"key_space {K}" in t_bad.result(timeout=60).reason
        t_fixed = fe.submit(src, _batch(FIXED), batch_id="b")
        fe.flush(timeout=60)
        assert t_good.result(timeout=60).status == APPLIED
        assert t_fixed.result(timeout=60).status == APPLIED
        assert fe.rejected == 1
    assert sched.view_dict("out") == _oracle_view([GOOD, FIXED])
