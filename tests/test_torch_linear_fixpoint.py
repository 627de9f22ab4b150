"""The port's fused delta-vector loop (``reflow_tpu_torch/executors/
linear_fixpoint.py``) against the JAX package's, on the CPU.

The random linear-region grammar of ``tests/test_fuzz_linear_fixpoint.py``
— ``loop -> Join(linear_left) -> [GroupBy] -> [linear Maps] ->
Union(base) -> Reduce('sum', tol) -> close_loop`` with contracting
coefficients and churn that retracts exact edge rows — is built in both
packages from the same seeds and driven through five runs: the JAX
default (the fused loop), the port's fused loop, the port's row program,
the port under ``defer_passes=1`` plus ``drain``, and the port's CPU
oracle. All agree under the reference's tolerance (``rtol=5e-4,
atol=1e-3``: tol-gated emission lag amplifies through the contraction
in proportion to a key's value).

Also: each budget tier, the dense tiers and the tail give the same
contribution table on one frontier (``rtol=atol=1e-6``); the port picks
the tiers JAX's rule picks; a violated ``stable_key`` raises the sticky
error; dtypes that do not round-trip through float32 take the row
program.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import reflow_tpu as J
import reflow_tpu_torch as P
from reflow_tpu.executors import linear_fixpoint as jlf
from reflow_tpu.executors.tpu import TpuExecutor
from reflow_tpu_torch.executors import linear_fixpoint as plf
from reflow_tpu_torch.executors.device_delta import bucket_capacity
from reflow_tpu_torch.executors.fixpoint import FixpointProgram
from reflow_tpu_torch.executors.ingress_queue import DeviceIngressQueue
from reflow_tpu_torch.executors.linear_fixpoint import LinearFixpointProgram
from reflow_tpu_torch.workloads import pagerank as ppr

K = 64
N_EDGES = 320
CHURN_TICKS = 3
#: keys [K - EDGE_FREE, K) never receive edge contributions, so base
#: retractions on them make emissions vanish (and reappear)
EDGE_FREE = 8


def _int32(a):
    """An int32 cast for torch tensors, jax and numpy arrays alike."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.int32)
    return a.astype("int32")


def _merge_for(pkg):
    def merge(k, x, vb):
        """[dst, coef] routed-contribution merge (ndim-branching)."""
        if getattr(vb, "ndim", 1) <= 1:
            return np.asarray([vb[0], x * vb[1]])
        if pkg is J:
            return jnp.stack([vb[:, 0], x * vb[:, 1]], axis=-1)
        return torch.stack([vb[:, 0], x * vb[:, 1]], dim=-1)
    return merge


def build_linear_loop(pkg, rng: np.random.Generator, defer=None):
    """The grammar, drawing from ``rng`` in the JAX test's order ->
    (graph, base, edges, reduce, uses_groupby, map coefficients)."""
    rank_spec = pkg.Spec((), np.float32, key_space=K, unique=True)
    scalar = pkg.Spec((), np.float32, key_space=K)
    edge2 = pkg.Spec((2,), np.float32, key_space=K)
    use_groupby = bool(rng.random() < 0.7)
    stable = bool(rng.random() < 0.5)
    n_maps = int(rng.integers(0, 3))
    map_cs = [int(rng.integers(1, 3)) for _ in range(n_maps)]

    g = pkg.FlowGraph("linfuzz")
    base = g.source("base", scalar)
    edges = g.source("edges", edge2 if use_groupby else scalar)
    x = g.loop("x", rank_spec)
    if use_groupby:
        j = g.join(x, edges, merge=_merge_for(pkg), spec=edge2,
                   linear_left=True, arena_capacity=1 << 13)
        node = g.group_by(j, key_fn=lambda k, v: _int32(v[:, 0]),
                          value_fn=lambda k, v: v[:, 1],
                          vectorized=True, spec=scalar, stable_key=stable)
    else:
        # per-key decay: x'[k] = base[k] + coef_sum[k] * x[k]
        node = g.join(x, edges, merge=lambda k, xa, vb: xa * vb,
                      spec=scalar, linear_left=True, arena_capacity=1 << 13)
    for c in map_cs:
        node = g.map(node, lambda v, c=c: v * float(c), vectorized=True,
                     linear=True)
    u = g.union(node, base)
    red = g.reduce(u, "sum", tol=1e-4, spec=rank_spec)
    g.close_loop(x, red, defer_passes=defer)
    return g, base, edges, red, use_groupby, map_cs


def edge_rows(rng, n, use_groupby, map_scale, mass):
    """Random edges whose coefficients come out of each source's
    remaining contraction budget (0.9 / map_scale over all live edges);
    updates ``mass`` in place."""
    src = rng.integers(0, K, n)
    dst = rng.integers(0, K - EDGE_FREE, n)
    raw = rng.random(n) + 0.1
    per_src = np.zeros(K)
    np.add.at(per_src, src, raw)
    budget = np.maximum(0.9 / map_scale - mass, 0.0)
    coef = np.round(raw * budget[src] / per_src[src], 4).astype(np.float32)
    np.add.at(mass, src, np.abs(coef))
    vals = (np.stack([dst.astype(np.float32), coef], axis=1)
            if use_groupby else coef)
    return src.astype(np.int64), vals


def make_ticks(rng, use_groupby, map_scale):
    """Per tick, a list of (source name, keys, values, weights)."""
    mass = np.zeros(K)
    src, vals = edge_rows(rng, N_EDGES, use_groupby, map_scale, mass)
    bkeys = np.arange(K, dtype=np.int64)
    bvals = np.round(rng.random(K), 3).astype(np.float32) + 0.05
    ticks = [[("base", bkeys, bvals, np.ones(K, np.int64)),
              ("edges", src, vals, np.ones(N_EDGES, np.int64))]]
    live = list(range(N_EDGES))
    gone: set = set()
    for _ in range(CHURN_TICKS):
        n_ch = int(rng.integers(4, 20))
        pick = rng.choice(len(live), size=min(n_ch, len(live)),
                          replace=False)
        idx = [live[p] for p in sorted(pick, reverse=True)]
        for p in sorted(pick, reverse=True):
            live.pop(p)
        rcoef = vals[idx][:, 1] if use_groupby else vals[idx]
        np.add.at(mass, src[idx], -np.abs(rcoef.astype(np.float64)))
        nsrc, nvals = edge_rows(rng, len(idx), use_groupby, map_scale, mass)
        r_keys, r_vals = src[idx], vals[idx]
        src = np.concatenate([src, nsrc])
        vals = np.concatenate([vals, nvals])
        live.extend(range(len(src) - len(idx), len(src)))
        k_t = int(rng.integers(K - EDGE_FREE, K))
        w_t = -1 if k_t not in gone else 1
        (gone.discard if k_t in gone else gone.add)(k_t)
        ticks.append([
            ("edges", np.concatenate([r_keys, nsrc]),
             np.concatenate([r_vals, nvals]),
             np.concatenate([-np.ones(len(idx), np.int64),
                             np.ones(len(idx), np.int64)])),
            ("base", np.array([k_t], np.int64), bvals[k_t:k_t + 1],
             np.array([w_t], np.int64))])
    return ticks


def drive(pkg, executor, g, base, edges, red, ticks, deferred=False):
    sched = pkg.DirtyScheduler(g, executor, max_loop_iters=500)
    for tick in ticks:
        for name, k, v, w in tick:
            sched.push({"base": base, "edges": edges}[name],
                       pkg.DeltaBatch(k, v, w))
        r = sched.tick(sync=not deferred)
        if not deferred:
            assert r.quiesced
    if deferred:
        sched.drain(edges)
    return sched.read_table(red)


def as_vec(table):
    v = np.zeros(K)
    for k, val in table.items():
        v[int(k)] = float(np.asarray(val).reshape(()))
    return v


def _port(**kw):
    return P.get_executor("cuda", device="cpu", **kw)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_linear_loop_all_programs_agree(seed):
    rng = np.random.default_rng(100 + seed)
    graph_seed = int(rng.integers(0, 1 << 30))
    tick_seed = int(rng.integers(0, 1 << 30))
    _, _, _, _, use_groupby, map_cs = build_linear_loop(
        P, np.random.default_rng(graph_seed))
    map_scale = float(np.prod(map_cs)) if map_cs else 1.0
    ticks = make_ticks(np.random.default_rng(tick_seed), use_groupby,
                       map_scale)

    runs = {
        "jax_fused": (J, lambda: TpuExecutor(), None),
        "port_fused": (P, lambda: _port(), None),
        "port_row": (P, lambda: _port(linear_fixpoint=False), None),
        "port_defer1": (P, lambda: _port(), 1),
        "cpu": (P, lambda: P.CpuExecutor(), None),
    }
    tables, execs = {}, {}
    for name, (pkg, mk, defer) in runs.items():
        g, base, edges, red, _, _ = build_linear_loop(
            pkg, np.random.default_rng(graph_seed), defer=defer)
        ex = execs[name] = mk()
        tables[name] = drive(pkg, ex, g, base, edges, red, ticks,
                             deferred=defer is not None)
    what = f"seed {seed}: groupby={use_groupby}, maps={map_cs}"
    assert execs["jax_fused"]._linear_structure is not None, what
    for name in ("port_fused", "port_defer1"):
        assert execs[name]._linear_structure is not None, (name, what)
        assert isinstance(execs[name]._fx_program, LinearFixpointProgram)
    assert isinstance(execs["port_row"]._fx_program, FixpointProgram)

    ref = as_vec(tables["cpu"])
    for name in ("jax_fused", "port_fused", "port_row", "port_defer1"):
        np.testing.assert_allclose(as_vec(tables[name]), ref, rtol=5e-4,
                                   atol=1e-3, err_msg=f"{name}, {what}")
    np.testing.assert_allclose(as_vec(tables["port_fused"]),
                               as_vec(tables["jax_fused"]), rtol=5e-4,
                               atol=1e-3, err_msg=what)


# -- tiers ---------------------------------------------------------------------

def _jax_base_ix(tiers, nedges):
    """JAX's lax.switch index for the base tier (linear_fixpoint.py)."""
    n_fits = sum(((jnp.int32(t) >= nedges).astype(jnp.int32)
                  for t in tiers), jnp.zeros((), jnp.int32))
    return int(jnp.where(n_fits > 0, n_fits - 1, len(tiers)))


def _jax_tail_ix(tail_tiers, nt, base_dense, stable_dst):
    nt_fits = sum(((jnp.int32(t) >= nt).astype(jnp.int32)
                   for t in tail_tiers), jnp.zeros((), jnp.int32))
    skip = (nt == 0) if stable_dst else (base_dense or nt == 0)
    ix = int(jnp.where(skip, len(tail_tiers), jnp.maximum(nt_fits - 1, 0)))
    return None if ix == len(tail_tiers) else ix


@pytest.mark.parametrize("arena", [1 << 10, 1 << 13, 1 << 15, 36864,
                                   1_310_720])
def test_tier_choice_equals_jax(arena):
    tiers = plf._edge_budget_tiers(arena)
    assert tiers == jlf._edge_budget_tiers(arena)
    Ft = min(arena, max(2048, arena // 8))
    tail = plf._tail_tiers(Ft)
    assert tail == jlf._tail_tiers(Ft)
    probes = {0, 1, 2047, 2048, 2049, Ft, Ft + 1, arena, arena + 1}
    probes |= {t + d for t in tiers + tail for d in (-1, 0, 1)}
    for n in sorted(p for p in probes if p >= 0):
        assert plf.pick_base_tier(tiers, n) == _jax_base_ix(tiers, n), n
        for dense in (False, True):
            for stable in (False, True):
                if n <= Ft:
                    assert (plf.pick_tail_tier(tail, n, dense, stable)
                            == _jax_tail_ix(tail, n, dense, stable)), n


def _pagerank_sched(n, e, arena, seed=2, **kw):
    web = ppr.WebGraph.random(n, e, seed=seed)
    pg = ppr.build_graph(n, tol=1e-4, arena_capacity=arena)
    sched = P.DirtyScheduler(pg.graph, _port(**kw))
    sched.push(pg.teleport, ppr.teleport_batch(n))
    sched.push(pg.edges, web.initial_batch())
    sched.tick()
    sched.push(pg.edges, web.churn(0.05))
    sched.tick()
    return sched, pg


def test_every_tier_gives_the_same_table():
    """On one fixed frontier: each base budget tier that holds it, the
    destination-sorted dense tier and (base + tail) against the raw
    full-arena tier give the same contribution table."""
    n, e = 256, 8000
    sched, pg = _pagerank_sched(n, e, 1 << 16)
    ex = sched.executor
    prog = ex._fx_program
    assert isinstance(prog, LinearFixpointProgram) and prog.stable_dst
    assert prog.tiers == [16384, 8192, 4096, 2048]
    jst = ex.states[pg.join.id]
    csr = ex._csr_cache[pg.join.id]
    rc = int(jst["rcount"])
    assert csr["count"] < rc          # the churn tick's rows are a tail
    tail = prog._build_tail(jst, n, csr["count"], rc)
    g = torch.Generator().manual_seed(0)
    front = torch.rand(n, generator=g) < 0.15
    xw = torch.zeros(n, 2)
    xw[:, 0] = torch.where(front, torch.rand(n, generator=g), 0.0)
    xw[:, 1] = torch.where(front & (torch.rand(n, generator=g) < 0.2),
                           1.0, 0.0)
    nb = int(csr["deg"][front].sum())
    nt = int(tail["deg"][front].sum())
    assert 0 < nb <= 2048 and 0 < nt <= prog.tail_tiers[-1]

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

    fmask = torch.any(xw != 0, dim=1)
    sorted_rows = prog._dense_sorted_rows(csr, xw)
    dense_base, bad = prog._push_tab([sorted_rows], csr["dtgt"])
    assert not bool(bad)
    for EB in prog.tiers:
        tab, bad = prog._push_tab([prog._budget_rows(EB, csr, xw, fmask)])
        assert bad is None
        close(tab, dense_base)
    tail_rows = [prog._budget_rows(EB, tail, xw, fmask)
                 for EB in prog.tail_tiers]
    tails = [prog._push_tab([r])[0] for r in tail_rows]
    for t in tails[1:]:
        close(t, tails[0])
    raw = prog._push_tab([prog._dense_rows(jst, xw)])[0]
    close(dense_base + tails[0], raw)
    # a pass pushes its segments together: base and tail in one push
    for rows, dtgt in ((sorted_rows, csr["dtgt"]),
                       (prog._budget_rows(2048, csr, xw, fmask), None)):
        both, bad = prog._push_tab([rows, tail_rows[-1]], dtgt)
        assert bad is None or not bool(bad)
        close(both, raw)
    # ... and gathers base and tail at once when both take budget tiers
    joined = prog._joined(csr, tail)
    for EB in (2048 + prog.tail_tiers[-1], 16384 + prog.tail_tiers[0]):
        close(prog._push_tab([prog._budget_rows(EB, joined, xw, fmask)])[0],
              raw)


def test_violated_stable_key_raises_sticky_error():
    """A GroupBy declaring stable_key=True whose key_fn in fact reads the
    loop value fails loudly: the destination-sorted dense tier checks
    its precomputed destinations against the runtime keys."""
    rank_spec = P.Spec((), np.float32, key_space=K, unique=True)
    scalar = P.Spec((), np.float32, key_space=K)
    edge2 = P.Spec((2,), np.float32, key_space=K)

    def bad_key(k, v):
        # at CSR build the loop value is zero -> v[:, 1] == 0 -> dst; at
        # run time v[:, 1] = x * coef != 0 -> dst + 1
        return (v[:, 0] + (torch.abs(v[:, 1]) > 1e-12)).to(torch.int32) % K

    g = P.FlowGraph("badstable")
    base = g.source("base", scalar)
    edges = g.source("edges", edge2)
    x = g.loop("x", rank_spec)
    j = g.join(x, edges, merge=_merge_for(P), spec=edge2, linear_left=True,
               arena_capacity=1 << 10)
    gb = g.group_by(j, key_fn=bad_key, value_fn=lambda k, v: v[:, 1],
                    vectorized=True, spec=scalar, stable_key=True)
    u = g.union(gb, base)
    red = g.reduce(u, "sum", tol=1e-4, spec=rank_spec)
    g.close_loop(x, red)

    sched = P.DirtyScheduler(g, _port(), max_loop_iters=200)
    keys = np.arange(K, dtype=np.int64)
    sched.push(base, P.DeltaBatch(keys, np.full(K, 0.5, np.float32),
                                  np.ones(K, np.int64)))
    src = np.arange(K, dtype=np.int64)
    vals = np.stack([((src + 1) % K).astype(np.float32),
                     np.full(K, 0.5, np.float32)], axis=1)
    sched.push(edges, P.DeltaBatch(src, vals, np.ones(K, np.int64)))
    with pytest.raises(RuntimeError, match="stable_key"):
        sched.tick()
        sched.tick()
    assert isinstance(sched.executor._fx_program, LinearFixpointProgram)


@pytest.mark.parametrize("case", ["float64 values", "int32 arena values"])
def test_dtypes_that_do_not_round_trip_take_the_row_program(case):
    """The per-key decay graph of the grammar with values that float32
    columns would not carry exactly: the port (like JAX) builds the row
    program, and the result equals the CPU oracle."""
    vdt = np.float64 if case == "float64 values" else np.float32
    edt = np.float64 if case == "float64 values" else np.int32
    scale = 1.0 if case == "float64 values" else 0.1

    def build(pkg):
        rank = pkg.Spec((), vdt, key_space=16, unique=True)
        g = pkg.FlowGraph("decay")
        base = g.source("base", pkg.Spec((), vdt, key_space=16))
        edges = g.source("edges", pkg.Spec((), edt, key_space=16))
        x = g.loop("x", rank)
        j = g.join(x, edges, merge=lambda k, xa, vb: xa * vb,
                   spec=pkg.Spec((), vdt, key_space=16), linear_left=True,
                   arena_capacity=1 << 10)
        m = g.map(j, lambda v: v * scale, vectorized=True, linear=True,
                  spec=pkg.Spec((), vdt, key_space=16))
        red = g.reduce(g.union(m, base), "sum", tol=1e-6, spec=rank)
        g.close_loop(x, red)
        return g, base, edges, red

    keys = np.arange(16, dtype=np.int64)
    coef = (np.full(16, 0.25) if edt == np.float64
            else np.full(16, 3)).astype(edt)
    ticks = [[("base", keys, np.ones(16, vdt), np.ones(16, np.int64)),
              ("edges", keys, coef, np.ones(16, np.int64))]]
    vals = {}
    for name, pkg, mk in (("port", P, _port), ("cpu", P, P.CpuExecutor),
                          ("jax", J, TpuExecutor)):
        g, base, edges, red = build(pkg)
        ex = mk()
        table = drive(pkg, ex, g, base, edges, red, ticks)
        vals[name] = np.array([float(np.asarray(table[k]).reshape(()))
                               for k in range(16)])
        if name == "port":
            assert ex._linear_structure is None
            assert isinstance(ex._fx_program, FixpointProgram)
        elif name == "jax":
            assert ex._linear_structure is None
    np.testing.assert_allclose(vals["port"], vals["cpu"], atol=1e-5)
    np.testing.assert_allclose(vals["port"], vals["jax"], atol=1e-5)


def test_shard_context_refused():
    sched, _ = _pagerank_sched(64, 512, 1 << 12)
    ex = sched.executor
    ex.mesh = object()
    with pytest.raises(NotImplementedError, match="sharded"):
        LinearFixpointProgram(ex, structure=ex._fx_structure,
                              linear=ex._linear_structure)


def test_call_many_equals_single_calls():
    """``call_many`` over K PageRank churn ticks equals K single ticks
    state for state, bit for bit on the CPU — the Join's arena, the
    Reduce's tables and the persistent CSR cache (which a tail overflow
    rebuilds mid-window) — and equals the JAX ``call_many`` (through its
    window path) within 1e-6 relative (float32 sums: XLA fuses the
    scanned tick differently from the single-tick program)."""
    from reflow_tpu.workloads import pagerank as jpr

    n, e, K = 128, 1024, 4
    arena = 1 << 12

    def setup(pkg):
        mod = jpr if pkg is J else ppr
        web = mod.WebGraph.random(n, e, seed=2)
        pg = mod.build_graph(n, tol=1e-4, arena_capacity=arena)
        ex = TpuExecutor() if pkg is J else _port()
        sched = pkg.DirtyScheduler(pg.graph, ex)
        sched.push(pg.teleport, mod.teleport_batch(n))
        sched.push(pg.edges, web.initial_batch())
        sched.tick()
        return sched, pg, [web.churn(0.05) for _ in range(K)]

    one, pg1, churn = setup(P)
    many, pg2, churn2 = setup(P)
    ex1, ex2 = one.executor, many.executor
    prog = ex2._fx_program
    assert isinstance(prog, LinearFixpointProgram)
    # K single-tick calls, each at its own ingress capacity
    for b in churn:
        one.push(pg1.edges, b)
        one.tick(sync=False)
    # one call_many over the window's [K, cap] stack
    plan = many._dirty_plan([pg2.edges.id])
    eid = pg2.edges.id
    queue = DeviceIngressQueue(
        {eid: pg2.edges.spec},
        {eid: bucket_capacity(max(len(b) for b in churn2))}, K,
        placement=ex2.device)
    for t, b in enumerate(churn2):
        queue.write(t, eid, b)
    stack = queue.stacked()
    states, (iters, rows, conv), back = prog.call_many(
        ex2.states, plan, stack, K, many.max_loop_iters)
    ex2.states = states
    assert back is stack
    assert iters.tolist() == [r.passes - 1 for r in one.history[1:]]
    assert rows.tolist() == [r.deltas_in - len(b) for r, b in
                             zip(one.history[1:], churn)]
    assert conv.tolist() == [True] * K
    for nid, st in ex1.states.items():
        for key, t in st.items():
            assert torch.equal(t, ex2.states[nid][key]), (nid, key)
    c1, c2 = ex1._csr_cache[pg1.join.id], ex2._csr_cache[pg2.join.id]
    assert sorted(c1) == sorted(c2)
    for key in c1:
        if isinstance(c1[key], torch.Tensor):
            assert torch.equal(c1[key], c2[key]), key
        else:
            assert c1[key] == c2[key], key
    assert ex1.csr_rebuilds == ex2.csr_rebuilds

    jsched, jpg, jchurn = setup(J)
    jsched.tick_many([{jpg.edges: b} for b in jchurn]).block()
    assert jsched.megatick_windows == 1
    want = jpr.ranks_to_array(jsched.read_table(jpg.new_rank), n)
    got = ppr.ranks_to_array(many.read_table(pg2.new_rank), n)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
