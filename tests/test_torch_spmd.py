"""The port's single-controller SPMD runtime (``parallel/spmd.py``):
every collective against ``jax.lax``'s under ``shard_map``, and the
runtime's own contract (loud divergence, a shard's exception ending the
region, one readback a ``host_gather``, every shard its own result).

The JAX side runs on its 8-device virtual CPU mesh, the port on an
8-shard CPU mesh, on the same seeded numpy inputs: a 1-axis mesh, and a
(2, 4) ``(dcn, delta)`` mesh over the product axis and each axis alone.
Results are held exactly, sums within 1e-6 relative (XLA may add the
shards in another order; the port adds them in rank order).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from reflow_tpu.parallel import make_mesh as jmake_mesh
from reflow_tpu.parallel.shard import shard_map
from reflow_tpu_torch.parallel import make_mesh
from reflow_tpu_torch.parallel import spmd

N = 8
MESHES = [("flat", "delta"), ("dcn", ("dcn", "delta")), ("dcn", "delta"),
          ("dcn", "dcn")]
KINDS = ["psum", "pmax", "psum_scatter", "all_gather", "all_to_all",
         "ppermute", "axis_index"]


def _meshes(kind):
    if kind == "flat":
        return jmake_mesh(N), make_mesh(N, device="cpu")
    return (jmake_mesh(N, dcn=2), make_mesh(N, dcn=2, device="cpu"))


def _size(pmesh, axis):
    axes = axis if isinstance(axis, tuple) else (axis,)
    return int(np.prod([pmesh.shape[a] for a in axes]))


def _jax_op(kind, axis, size):
    lax = jax.lax
    perm = [(i, (i + 1) % size) for i in range(size)]
    return {
        "psum": lambda x: lax.psum(x, axis),
        "pmax": lambda x: lax.pmax(x, axis),
        "psum_scatter": lambda x: lax.psum_scatter(
            x, axis, scatter_dimension=0, tiled=True),
        "all_gather": lambda x: lax.all_gather(x, axis, tiled=True),
        "all_to_all": lambda x: lax.all_to_all(x, axis, 0, 0),
        "ppermute": lambda x: lax.ppermute(x, axis, perm),
        "axis_index": lambda x: x * 0 + lax.axis_index(axis),
    }[kind]


def _port_body(kind, axis, size):
    perm = [(i, (i + 1) % size) for i in range(size)]

    def body(ctx, x):
        if kind == "axis_index":
            return x * 0 + ctx.axis_index(axis)
        req = {"psum": ctx.psum, "pmax": ctx.pmax,
               "psum_scatter": ctx.psum_scatter,
               "all_gather": ctx.all_gather,
               "all_to_all": ctx.all_to_all}.get(kind)
        if req is not None:
            return (yield req(x, axis))
        return (yield ctx.ppermute(x, perm, axis))

    return body


@pytest.mark.parametrize("mesh_kind,axis", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_collective_matches_jax(kind, mesh_kind, axis):
    jmesh, pmesh = _meshes(mesh_kind)
    size = _size(pmesh, axis)
    rows = size * 2 if kind != "all_to_all" else size
    rng = np.random.default_rng(10 * KINDS.index(kind)
                                + MESHES.index((mesh_kind, axis)))
    x = rng.standard_normal((N * rows, 3)).astype(np.float32)
    all_axes = tuple(jmesh.axis_names)
    spec = JP(all_axes if len(all_axes) > 1 else all_axes[0])
    fn = shard_map(_jax_op(kind, axis, size), mesh=jmesh, in_specs=(spec,),
                   out_specs=spec, check_vma=False)
    want = np.asarray(jax.jit(fn)(x))

    xs = torch.from_numpy(x).chunk(N, 0)
    got = spmd.run(pmesh, _port_body(kind, axis, size),
                   [(t.clone(),) for t in xs], axis)
    got = torch.cat(got).numpy()
    assert got.shape == want.shape
    if kind in ("psum", "psum_scatter"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _mesh4():
    return make_mesh(4, device="cpu")


def test_mismatched_collective_raises():
    """Shard 2 asks for another collective at step 1: the region raises
    at once, naming the shard and the step (no hang)."""

    def body(ctx, x):
        x = yield ctx.psum(x)
        if ctx.rank == 2:
            x = yield ctx.pmax(x)
        else:
            x = yield ctx.psum(x)
        return x

    with pytest.raises(spmd.SpmdMismatch, match=r"step 1: shard 2"):
        spmd.run(_mesh4(), body, [(torch.ones(4),)] * 4, "delta")


def test_mismatched_shapes_raise():
    def body(ctx, x):
        return (yield ctx.all_gather(x[: 2 + (ctx.rank == 1)]))

    with pytest.raises(spmd.SpmdMismatch, match="shard 1"):
        spmd.run(_mesh4(), body, [(torch.ones(4),)] * 4, "delta")


def test_shard_returning_early_raises():
    def body(ctx, x):
        if ctx.rank == 3:
            return x
        return (yield ctx.psum(x))

    with pytest.raises(spmd.SpmdMismatch, match="shard 3 returned"):
        spmd.run(_mesh4(), body, [(torch.ones(4),)] * 4, "delta")


def test_shard_exception_ends_the_region():
    """A shard that raises ends the region: the error propagates and
    every other shard's body is closed (its cleanup runs)."""
    closed = []

    def body(ctx, x):
        try:
            x = yield ctx.psum(x)
            if ctx.rank == 1:
                raise ValueError("shard 1 failed")
            x = yield ctx.psum(x)
            return x
        finally:
            closed.append(ctx.rank)

    with pytest.raises(ValueError, match="shard 1 failed"):
        spmd.run(_mesh4(), body, [(torch.ones(4),)] * 4, "delta")
    assert sorted(closed) == [0, 1, 2, 3]


def test_host_gather_is_one_readback():
    reads = []

    def reader(t):
        reads.append(tuple(t.shape))
        return t.tolist()

    def body(ctx, x):
        rows = yield ctx.host_gather(x + ctx.rank, reader)
        return rows

    out = spmd.run(_mesh4(), body, [(torch.zeros(2),)] * 4, "delta")
    assert reads == [(4, 2)]
    assert all(o == [[float(r)] * 2 for r in range(4)] for o in out)
    assert spmd.run_solo(body(spmd.SOLO, torch.zeros(2))) == [[0.0, 0.0]]
    assert reads == [(4, 2), (2,)]


def test_results_are_each_shards_own():
    """A shard's result is its own tensor: an in-place update on one
    shard (the lowerings do that) leaves the others' untouched."""

    def body(ctx, x):
        y = yield ctx.psum(x)
        if ctx.rank == 0:
            y += 100
        z = yield ctx.all_gather(y[:1])
        return y, z

    out = spmd.run(_mesh4(), body, [(torch.ones(2),)] * 4, "delta")
    assert out[0][0].tolist() == [104.0, 104.0]
    assert all(o[0].tolist() == [4.0, 4.0] for o in out[1:])
    assert all(o[1].tolist() == [104.0, 4.0, 4.0, 4.0] for o in out)


def test_tally_counts_calls_and_bytes():
    spmd.reset_collective_tally()

    def body(ctx, x):
        x = yield ctx.psum(x)
        return (yield ctx.all_to_all((x, x.to(torch.int32))))

    spmd.run(_mesh4(), body, [(torch.ones(8),)] * 4, "delta")
    t = spmd.collective_tally()
    assert t[("psum", ("delta",))] == (1, 4 * 8 * 4)
    assert t[("all_to_all", ("delta",))] == (1, 4 * 8 * 8)


def test_run_solo_is_the_identity():
    def body(ctx, x):
        y = yield ctx.psum_scatter(x)
        z = yield ctx.ppermute(y, [(0, 0)])
        return z, ctx.axis_index(), ctx.n

    x = torch.arange(6.0)
    z, idx, n = spmd.run_solo(body(spmd.SOLO, x))
    assert z is x and idx == 0 and n == 1
