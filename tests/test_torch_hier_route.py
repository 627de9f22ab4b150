"""Two-leg owner delivery on a 2-axis (dcn, delta) mesh: counterparts of
``tests/test_hier_route.py``.

On a (2, 4) mesh the routed path must deliver exactly the multiset the
rows hold, each live row on its key's owner, as the JAX router does on
its virtual mesh; and it must cross the dcn axis in ONE exchange. JAX
proves the second in the compiled HLO; the port's proof is the SPMD
runtime's tally: one ``all_to_all`` on the ``delta`` axis (the leg
inside each dcn row) and one on the ``dcn`` axis, and no other.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

from reflow_tpu.executors.device_delta import DeviceDelta as JDelta
from reflow_tpu.parallel import make_mesh as jmake_mesh
from reflow_tpu.parallel.shard import shard_map
from reflow_tpu.parallel.shard_lowerings import \
    deliver_to_owner as jdeliver
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.parallel import make_mesh, spmd
from reflow_tpu_torch.parallel.shard_lowerings import deliver_to_owner

N, N_DCN, N_ICI = 8, 2, 4
K = 1024
KL = K // N
C = 2048                     # global rows; 256 a shard: routing engages


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, C).astype(np.int32)
    vals = rng.standard_normal(C).astype(np.float32)
    w = rng.integers(-2, 3, C).astype(np.int32)     # dead rows included
    return keys, vals, w


def _port_route(mesh, axis, keys, vals, w, sizes=None):
    parts = [DeviceDelta(*(torch.from_numpy(a).chunk(N)[r].clone()
                           for a in (keys, vals, w))) for r in range(N)]

    def body(ctx, d):
        return (yield from deliver_to_owner(ctx, d, axis, N, KL, sizes))

    return spmd.run(mesh, body, [(p,) for p in parts], axis)


def _multiset(per_shard):
    """{(global key, value): weight} of the live rows, and whether every
    live row sits on its key's owner."""
    got, owned = {}, True
    for r, (k, v, ww) in enumerate(per_shard):
        live = ww != 0
        gk = r * KL + k
        owned &= bool(np.all(gk[live] // KL == r))
        for kk, vv, w1 in zip(gk[live], v[live], ww[live]):
            got[(int(kk), float(vv))] = got.get((int(kk), float(vv)),
                                                0) + int(w1)
    return {k: w for k, w in got.items() if w}, owned


def test_hier_route_delivers_exact_multiset():
    keys, vals, w = _rows()
    out = _port_route(make_mesh(N, dcn=N_DCN, device="cpu"),
                      ("dcn", "delta"), keys, vals, w, (N_DCN, N_ICI))
    assert not any(bool(e) for _, e in out)
    got, owned = _multiset([tuple(t.numpy() for t in d) for d, _ in out])
    assert owned
    exp = {}
    for k, v, ww in zip(keys, vals, w):
        if ww:
            exp[(int(k), float(v))] = exp.get((int(k), float(v)), 0) + int(ww)
    assert got == {k: v for k, v in exp.items() if v}

    # the JAX router on its (2, 4) virtual mesh delivers the same multiset
    jmesh = jmake_mesh(N, dcn=N_DCN)
    sh = NamedSharding(jmesh, JP(("dcn", "delta")))
    d = JDelta(*(jax.device_put(jnp.asarray(a), sh) for a in (keys, vals, w)))
    spec = JDelta(*(JP(("dcn", "delta")),) * 3)
    fn = shard_map(lambda dd: jdeliver(dd, ("dcn", "delta"), N, KL,
                                       sizes=(N_DCN, N_ICI)),
                   mesh=jmesh, in_specs=(spec,), out_specs=(spec, JP()),
                   check_vma=False)
    jd, _ = jax.jit(fn)(d)
    cols = [np.asarray(c).reshape(N, -1) for c in jd]
    jgot, jowned = _multiset([(cols[0][r], cols[1][r], cols[2][r])
                              for r in range(N)])
    assert jowned and jgot == got


def test_hier_route_one_dcn_leg_in_the_tally():
    keys, vals, w = _rows(1)
    spmd.reset_collective_tally()
    _port_route(make_mesh(N, dcn=N_DCN, device="cpu"), ("dcn", "delta"),
                keys, vals, w, (N_DCN, N_ICI))
    a2a = {ax: v for (kind, ax), v in spmd.collective_tally().items()
           if kind == "all_to_all"}
    assert set(a2a) == {("dcn",), ("delta",)}
    assert a2a[("dcn",)][0] == 1 and a2a[("delta",)][0] == 1


def test_flat_mesh_unchanged_single_leg():
    keys, vals, w = _rows(2)
    w = np.ones(C, np.int32)
    spmd.reset_collective_tally()
    out = _port_route(make_mesh(N, device="cpu"), "delta", keys, vals, w)
    a2a = {ax: v for (kind, ax), v in spmd.collective_tally().items()
           if kind == "all_to_all"}
    assert a2a == {("delta",): a2a[("delta",)]} and a2a[("delta",)][0] == 1
    got, owned = _multiset([tuple(t.numpy() for t in d) for d, _ in out])
    assert owned and sum(got.values()) == C
