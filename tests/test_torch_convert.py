"""``states_from_jax`` carries a min/max Reduce, a multiset-left Join and
a Map's nested params tree (image-embed's ViT weights) from the JAX
package into the port mid-stream, on the CPU.

The JAX ``TpuExecutor`` runs the first ticks; its state, as numpy, is
carried into the port's ``cuda`` executor (``device="cpu"``) through
``states_from_jax``; then both packages take the same further ticks and
must stay in step: views and tables equal exactly, and every state array
bit-equal (the port's ``states_to_numpy`` against the JAX arrays).
"""

import numpy as np
import pytest

import reflow_tpu_torch as P
from reflow_tpu import DirtyScheduler as JDirtyScheduler
from reflow_tpu.executors import get_executor as jget_executor
from reflow_tpu.workloads import sssp as jsp
from reflow_tpu_torch.convert import states_from_jax, states_to_numpy
from reflow_tpu_torch.workloads import sssp as psp

N = 48


def _np_states(sched):
    return {nid: {name: np.asarray(a) for name, a in st.items()}
            for nid, st in sched.executor.states.items()}


def _assert_same_states(js, ps):
    back = states_to_numpy(ps.executor.states)
    jst = _np_states(js)
    assert set(back) == set(jst)
    for nid, st in jst.items():
        assert set(back[nid]) == set(st)
        for name, a in st.items():
            b = back[nid][name]
            assert b.dtype == a.dtype, name
            if a.dtype == np.float32:
                a, b = a.view(np.uint32), b.view(np.uint32)
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_minmax_state_carried_from_jax_mid_stream():
    """SSSP (the loop's min-Reduce and its unique-left Join): the cold
    build and a deletion tick in JAX, carried over, then a deletion and
    an insertion tick in both; passes, tables and states equal."""
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, N, 160), rng.integers(0, N, 160)
    w = rng.integers(1, 10, 160).astype(np.float32)
    jg, pg = jsp.build_graph(N, candidates=8), psp.build_graph(N,
                                                             candidates=8)
    js = JDirtyScheduler(jg.graph, jget_executor("tpu"),
                         max_loop_iters=jsp.max_loop_iters(N))
    js.push(jg.seeds, jsp.seed_batch(0))
    js.push(jg.edges, jsp.edge_batch(src, dst, w))
    js.tick()
    js.push(jg.edges, jsp.edge_batch(src[:5], dst[:5], w[:5], weight=-1))
    js.tick()
    ps = P.DirtyScheduler(pg.graph, P.get_executor("cuda", device="cpu"),
                          max_loop_iters=psp.max_loop_iters(N))
    ps.executor.state_restore(states_from_jax(_np_states(js), pg.graph,
                                              device="cpu"))
    _assert_same_states(js, ps)
    ns, nd = rng.integers(0, N, 10), rng.integers(0, N, 10)
    nw = rng.integers(1, 10, 10).astype(np.float32)
    for args, weight in (((src[5:12], dst[5:12], w[5:12]), -1),
                         ((ns, nd, nw), 1)):
        js.push(jg.edges, jsp.edge_batch(*args, weight=weight))
        ps.push(pg.edges, psp.edge_batch(*args, weight=weight))
        jr, pr = js.tick(), ps.tick()
        assert jr.passes == pr.passes and jr.quiesced and pr.quiesced
        assert ps.read_table(pg.best) == js.read_table(jg.best)
        _assert_same_states(js, ps)


def _multiset_graph(pkg_mod, arena):
    g = pkg_mod.FlowGraph("msj")
    a = g.source("a", pkg_mod.Spec((), np.float32, key_space=32))
    b = g.source("b", pkg_mod.Spec((), np.float32, key_space=32))
    j = g.join(a, b, spec=pkg_mod.Spec((2,), np.float32, key_space=32),
               arena_capacity=arena, left_arena_capacity=arena)
    g.sink(j, "out")
    return g, a, b


def test_multiset_join_state_carried_from_jax_mid_stream():
    """A multiset-left Join: three ticks of both sides in JAX, carried
    over, then four more in both with retractions, small arenas so both
    compact after the carry; sink deltas and states equal."""
    import reflow_tpu as J

    rng = np.random.default_rng(4)
    jg, ja, jb = _multiset_graph(J, 96)
    pg, pa, pb = _multiset_graph(P, 96)
    js = JDirtyScheduler(jg, jget_executor("tpu"))
    live = {"a": [], "b": []}

    def batch(DB, side):
        n = 12
        rows = [(int(rng.integers(0, 32)), float(rng.integers(0, 5)), 1)
                for _ in range(n)]
        for _ in range(6):
            if live[side]:
                k, v, _ = live[side].pop(int(rng.integers(len(live[side]))))
                rows.append((k, v, -1))
        live[side].extend(r for r in rows if r[2] > 0)
        return rows

    def to(DB, rows):
        return DB(np.array([r[0] for r in rows], np.int64),
                  np.array([r[1] for r in rows], np.float32),
                  np.array([r[2] for r in rows], np.int64))

    for _ in range(3):
        js.push(ja, to(J.DeltaBatch, batch(None, "a")))
        js.push(jb, to(J.DeltaBatch, batch(None, "b")))
        js.tick()
    ps = P.DirtyScheduler(pg, P.get_executor("cuda", device="cpu"))
    ps.executor.state_restore(states_from_jax(_np_states(js), pg,
                                              device="cpu"))
    _assert_same_states(js, ps)
    gens = []
    for _ in range(4):
        ra, rb = batch(None, "a"), batch(None, "b")
        js.push(ja, to(J.DeltaBatch, ra))
        js.push(jb, to(J.DeltaBatch, rb))
        ps.push(pa, to(P.DeltaBatch, ra))
        ps.push(pb, to(P.DeltaBatch, rb))
        jr, pr = js.tick(), ps.tick()
        jd, pd = jr.sink_deltas["out"], pr.sink_deltas["out"]
        assert sorted(zip(jd.keys.tolist(), map(tuple, np.asarray(
            jd.values).tolist()), jd.weights.tolist())) == \
            sorted(zip(pd.keys.tolist(), map(tuple, np.asarray(
                pd.values).tolist()), pd.weights.tolist()))
        _assert_same_states(js, ps)
        st = ps.executor.states[pg.nodes[2].id]
        gens.append((int(st["lgen"]), int(st["gen"])))
    assert gens[-1][0] >= 1 and gens[-1][1] >= 1


def test_params_map_state_carried_from_jax():
    """Image-embed (a Map with a nested params tree, the mean Reduce): two
    ticks in JAX, carried over; ``states_to_numpy`` gives back the JAX
    arrays bit for bit, tree structure included; then one more tick in
    both, whose centroids agree within the image-embed tests' 2e-3 (the
    two forwards differ only in summation order) and whose params stay
    bit-equal."""
    import jax

    from reflow_tpu.delta import DeltaBatch as JDeltaBatch
    from reflow_tpu.models import VIT_TINY, init_vit as jinit_vit
    from reflow_tpu.workloads import image_embed as jie
    from reflow_tpu_torch.models import init_vit
    from reflow_tpu_torch.utils.tree import tree_leaves, tree_map
    from reflow_tpu_torch.workloads import image_embed as pie

    jp, pp = jinit_vit(0, **VIT_TINY), init_vit(0, **VIT_TINY, device="cpu")
    jig, pig = jie.build_graph(32, 4, jp), pie.build_graph(32, 4, pp)
    js = JDirtyScheduler(jig.graph, jget_executor("tpu"))
    stream = jie.ImageStream(jp, seed=6)
    rng = np.random.default_rng(8)
    js.push(jig.images, stream.insert(np.arange(10), rng.integers(0, 4, 10)))
    js.tick()
    js.push(jig.images, JDeltaBatch.concat([
        stream.insert(np.arange(10, 16), rng.integers(0, 4, 6)),
        stream.move(2, (stream.groups[2] + 1) % 4)]))
    js.tick()
    jstates = {nid: jax.tree.map(np.asarray, st)
               for nid, st in js.executor.states.items()}
    emb = pig.embed.id
    assert isinstance(jstates[emb]["params"]["blocks"], list)

    ps = P.DirtyScheduler(pig.graph, P.get_executor("cuda", device="cpu"))
    ps.executor.state_restore(states_from_jax(jstates, pig.graph,
                                              device="cpu"))

    def bit_equal(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        return np.array_equal(a, b)

    back = states_to_numpy(ps.executor.states)
    assert set(back) == set(jstates)
    eq = tree_map(bit_equal, back, jstates)
    assert all(tree_leaves(eq)) and len(tree_leaves(eq)) == 29 + 4

    batch = stream.insert(np.arange(16, 22), rng.integers(0, 4, 6))
    js.push(jig.images, batch)
    ps.push(pig.images, P.DeltaBatch(batch.keys, batch.values,
                                     batch.weights))
    js.tick()
    ps.tick()
    jc, pc = js.read_table(jig.centroids), ps.read_table(pig.centroids)
    assert set(jc) == set(pc)
    for g in jc:
        np.testing.assert_allclose(pc[g], np.asarray(jc[g]), rtol=0,
                                   atol=2e-3)
    after = states_to_numpy(ps.executor.states)
    assert all(tree_leaves(tree_map(bit_equal, after[emb],
                                    jax.tree.map(np.asarray,
                                                 js.executor.states[emb]))))


def test_params_state_shape_is_checked():
    """A params leaf whose shape differs from the op's own is refused."""
    from reflow_tpu_torch.models import VIT_TINY, init_vit
    from reflow_tpu_torch.utils.tree import tree_map
    from reflow_tpu_torch.workloads import image_embed as pie

    pp = init_vit(0, **VIT_TINY, device="cpu")
    pig = pie.build_graph(32, 4, pp)
    ex = P.get_executor("cuda", device="cpu")
    P.DirtyScheduler(pig.graph, ex)
    states = states_to_numpy(ex.states)
    states[pig.embed.id]["params"]["blocks"][1]["w1"] = np.zeros((3, 3),
                                                                np.float32)
    with pytest.raises(ValueError, match="has shape"):
        states_from_jax(states, pig.graph, device="cpu")
    states = states_to_numpy(ex.states)
    states[pig.embed.id]["params"]["blocks"].pop()
    with pytest.raises(ValueError, match="tree structure differs"):
        states_from_jax(states, pig.graph, device="cpu")
    # the round trip itself is exact
    got = states_from_jax(states_to_numpy(ex.states), pig.graph,
                          device="cpu")
    tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                        b.numpy()),
             got, ex.states)
