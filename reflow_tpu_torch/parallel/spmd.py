"""The SPMD runtime: shard bodies and the collectives between them, each
process stepping its own shards on one host thread.

The JAX package runs a sharded pass as one SPMD program under
``jax.shard_map``, its cross-shard combines as ``jax.lax``'s named-axis
collectives. The port has no such compiler, so this module stands in
for both. A region is a *body* run once per mesh shard. Each shard's
body is a Python generator that yields at every collective
(``x = yield ctx.psum(x)``; nested helpers are reached with ``yield
from``). :func:`run` steps every shard to its next collective in rank
order, checks that all of them asked for the same one (kind, axis,
parameters, leaf shapes and dtypes), computes every shard's result and
resumes them with it, until all of them return.

Why generators stepped by one thread, and not a thread per shard:

- **deterministic**: a float ``psum`` adds the shards in rank order, so
  a sharded run gives the same bits every time;
- **no lock, no barrier**: a barrier would hang when one shard raises;
  here an exception in any shard ends the region at once (the other
  shards' generators are closed) and propagates to the caller;
- **one stream per device**: the shards launch in rank order on the
  current stream, so ordering holds by launch order;
- **loud divergence**: when the shards' collective sequences differ
  (one finishes while another asks for a collective, or two ask for
  different ones), :class:`SpmdMismatch` names the shard and the step —
  the counterpart of XLA refusing a mismatched SPMD program.

The collectives, each over one mesh axis or over the flattened product
of several (dcn-major, ``jax.lax.axis_index``'s flat order):
``psum``, ``pmax``, ``psum_scatter`` (``scatter_dimension=0``,
``tiled=True``), ``all_gather`` (``tiled=True``, dim 0), ``all_to_all``
(``split_axis``, ``concat_axis``), ``ppermute`` (``perm`` pairs in
axis-index terms); :meth:`ShardCtx.axis_index` is a plain host int.
One more request has no JAX counterpart: :meth:`ShardCtx.host_gather`
reads every shard's small tensor back in ONE transfer and hands every
shard the full list of rows, so a host branch that must be uniform
across shards (a loop's quiescence, a k-NN tick's path) costs one
readback a region step, not one per shard.

Every result a shard receives is its own tensor (a copy where two
shards would otherwise share one): the port's lowerings update tables
in place, and a shared replica would be updated once per shard.

Payloads are a tensor or a tuple of tensors (a ``DeviceDelta`` is
exchanged as one request: its three columns travel together). Every
collective is tallied by kind and axis, calls and bytes
(:func:`collective_tally`); the tally is always on and costs one dict
update a collective.

:func:`run_solo` drives the same bodies on one device with no mesh:
every collective is the identity and ``host_gather`` one readback. The
single-device executor runs its fixpoint programs through it, so one
body serves both and the single-device path adds no device work.

A body may also yield a request it built without its context
(:func:`psum`): a Map function's tensor-parallel forward
(``models.vit.vit_forward_tp``) yields its psums over the model axis
that way, and the sharded Map lowering drives it with ``yield from``.

**Meshes across processes** (``parallel/dist.py``, a mesh from
``make_mesh(dcn=process_count())``): each process steps only its own
shards (``mesh.local_ranks``). A collective whose shard groups cross a
process boundary, and every ``host_gather``, is completed by ONE
exchange: every process sends its shards' payloads (CUDA payloads staged
through pinned host buffers) and receives every other's, then runs the
same combine over the full list in global rank order. A two-process run
therefore gives the single-controller run's bits. Each exchange carries
the step's collective key; when two processes disagree (or one
finished the region while another asks for a collective) every process
raises :class:`SpmdMismatch` naming the process, its first shard and the
step. The bytes that crossed the boundary are tallied by kind under the
axis ``(PROCESS_BOUNDARY,)``: calls are exchanges, bytes are those this
process sent plus those it received.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from reflow_tpu_torch.utils.runtime import named_lock

__all__ = ["Collective", "PROCESS_BOUNDARY", "ShardCtx", "SOLO",
           "SpmdMismatch", "collective_tally", "psum",
           "reset_collective_tally", "run", "run_solo"]

#: the tally's axis name for the bytes that crossed a process boundary
PROCESS_BOUNDARY = "process"


class SpmdMismatch(RuntimeError):
    """The shards of one region asked for different collectives (or one
    finished while another still asked for one)."""


# -- payload trees ------------------------------------------------------------

def _leaves(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        out: List[torch.Tensor] = []
        for y in x:
            out.extend(_leaves(y))
        return out
    raise TypeError(f"a collective's payload is a tensor or a tuple of "
                    f"tensors, not {type(x).__name__}")


def _rebuild(like, leaves: List[torch.Tensor]):
    """``like``'s structure with ``leaves`` in its leaf order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        parts = [build(y) for y in x]
        if hasattr(x, "_fields"):           # a NamedTuple (DeviceDelta)
            return type(x)(*parts)
        return type(x)(parts)

    return build(like)


def _signature(x) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(x))


# -- requests -------------------------------------------------------------------

class Collective:
    """One shard's request at a collective: ``kind``, the ``axis`` it
    runs over, the payload ``x`` and the kind's static ``params``."""

    __slots__ = ("kind", "axis", "x", "params")

    def __init__(self, kind: str, axis, x, params: tuple = ()):
        self.kind = kind
        self.axis = axis
        self.x = x
        self.params = params

    def key(self) -> tuple:
        """What every shard of the region must agree on."""
        return (self.kind, self.axis, self.params, _signature(self.x))

    def wire_key(self) -> str:
        """:meth:`key` as text another process can compare: a callable
        parameter (``host_gather``'s reader) by its name."""
        params = tuple(getattr(p, "__qualname__", p) if callable(p) else p
                       for p in self.params)
        sig = tuple((s, str(d)) for s, d in _signature(self.x))
        return repr((self.kind, self.axis, params, sig))

    def solo(self):
        """The result on a one-shard mesh: every collective is the
        identity, ``host_gather`` one readback."""
        if self.kind == "host_gather":
            (reader,) = self.params
            return [reader(self.x)]
        return self.x

    def __repr__(self) -> str:
        shapes = [tuple(t.shape) for t in _leaves(self.x)]
        return (f"{self.kind}(axis={self.axis!r}, params={self.params!r}, "
                f"shapes={shapes})")


def _axis_key(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def psum(x, axis) -> Collective:
    """A ``psum`` request over ``axis`` built without a shard context,
    for code a body reaches through ``yield from`` (a Map function's
    tensor-parallel forward)."""
    return Collective("psum", _axis_key(axis), x)


class ShardCtx:
    """One shard's view of a region: its flat ``rank`` over the mesh,
    its ``device``, and the requests its body yields. ``axis``
    is the region's default axis (a name or a tuple of names)."""

    def __init__(self, mesh, rank: int, axis):
        self.mesh = mesh
        self.rank = rank
        self.axis = axis
        self.n = 1 if mesh is None else mesh.size
        self.device = None if mesh is None else mesh.device_list[rank]
        #: True under :func:`run_solo` (one shard, no mesh)
        self.solo = mesh is None
        #: the first shard this process steps (rank 0 on one process)
        self.lead = mesh is None or rank == mesh.local_ranks[0]

    def _ax(self, axis) -> tuple:
        return _axis_key(self.axis if axis is None else axis)

    def axis_index(self, axis=None) -> int:
        """This shard's index along ``axis`` (flattened, first name
        major, for a tuple)."""
        if self.mesh is None:
            return 0
        return self.mesh.axis_index(self.rank, self._ax(axis))

    def psum(self, x, axis=None) -> Collective:
        return Collective("psum", self._ax(axis), x)

    def pmax(self, x, axis=None) -> Collective:
        return Collective("pmax", self._ax(axis), x)

    def psum_scatter(self, x, axis=None) -> Collective:
        """``jax.lax.psum_scatter(x, axis, scatter_dimension=0,
        tiled=True)``."""
        return Collective("psum_scatter", self._ax(axis), x)

    def all_gather(self, x, axis=None) -> Collective:
        """``jax.lax.all_gather(x, axis, tiled=True)`` along dim 0."""
        return Collective("all_gather", self._ax(axis), x)

    def all_to_all(self, x, axis=None, split_axis: int = 0,
                   concat_axis: int = 0) -> Collective:
        return Collective("all_to_all", self._ax(axis), x,
                          (split_axis, concat_axis))

    def ppermute(self, x, perm: Sequence[Tuple[int, int]],
                 axis=None) -> Collective:
        return Collective("ppermute", self._ax(axis), x,
                          (tuple(tuple(p) for p in perm),))

    def host_gather(self, x: torch.Tensor,
                    reader: Callable[[torch.Tensor], list]) -> Collective:
        """Every shard's ``x`` (same shape) read back in one transfer:
        ``reader`` gets the ``[n, *x.shape]`` stack once and each shard
        receives its list of rows (``rows[ctx.rank]`` is its own)."""
        return Collective("host_gather", (), x, (reader,))


#: the one-shard context the single-device executor's bodies run under
SOLO = ShardCtx(None, 0, None)


# -- the tally -------------------------------------------------------------------

_TALLY_LOCK = named_lock("parallel.spmd.tally")
_TALLY: Dict[Tuple[str, tuple], List[int]] = {}


def _note(kind: str, axis: tuple, nbytes: int) -> None:
    with _TALLY_LOCK:
        ent = _TALLY.setdefault((kind, axis), [0, 0])
        ent[0] += 1
        ent[1] += nbytes


def collective_tally() -> Dict[Tuple[str, tuple], Tuple[int, int]]:
    """``{(kind, axis names): (calls, bytes)}`` since the last reset:
    one call per region-wide collective, bytes summed over the payloads
    of the shards this process steps; under ``(PROCESS_BOUNDARY,)`` the
    exchanges across processes and the bytes they moved."""
    with _TALLY_LOCK:
        return {k: (v[0], v[1]) for k, v in _TALLY.items()}


def reset_collective_tally() -> None:
    with _TALLY_LOCK:
        _TALLY.clear()


# -- running a region ------------------------------------------------------------

def run_solo(gen):
    """Drive one body on one device: each collective is the identity,
    each ``host_gather`` one readback. A non-generator result passes
    through."""
    if not inspect.isgenerator(gen):
        return gen
    try:
        req = next(gen)
        while True:
            req = gen.send(req.solo())
    except StopIteration as stop:
        return stop.value


def run(mesh, body: Callable, args: Sequence[tuple], axis) -> list:
    """Run ``body(ctx, *args[i])`` once per shard this process holds
    (``mesh.local_ranks[i]``; every shard on one process) as one SPMD
    region; return those shards' results in the same order. ``axis`` is
    the shards' default collective axis. Raises :class:`SpmdMismatch`
    when the shards' collective sequences differ, here or in another
    process; an exception in any shard closes the others and
    propagates."""
    local = mesh.local_ranks
    n = len(local)
    if len(args) != n:
        raise ValueError(f"need one argument tuple per local shard ({n}), "
                         f"got {len(args)}")
    results: List[Any] = [None] * n
    gens: List[Any] = []
    try:
        for i, r in enumerate(local):
            g = body(ShardCtx(mesh, r, axis), *args[i])
            gens.append(g if inspect.isgenerator(g) else None)
            if gens[-1] is None:
                results[i] = g
        sends: List[Any] = [None] * n
        step = 0
        while True:
            reqs: List[Optional[Collective]] = [None] * n
            done = [g is None for g in gens]
            for i, g in enumerate(gens):
                if g is None:
                    continue
                try:
                    reqs[i] = g.send(sends[i])
                except StopIteration as stop:
                    results[i] = stop.value
                    gens[i] = None
                    done[i] = True
            if all(done):
                if mesh.process_count > 1:
                    _exchange(mesh, None, [], step)
                return results
            if any(done):
                a = done.index(True)
                b = done.index(False)
                raise SpmdMismatch(
                    f"SPMD region diverged at collective step {step}: "
                    f"shard {local[a]} returned while shard {local[b]} "
                    f"asked for {reqs[b]!r}")
            ref = reqs[0]
            if not isinstance(ref, Collective):
                raise SpmdMismatch(f"shard {local[0]} yielded {ref!r} at "
                                   f"step {step}, not a collective request")
            key = ref.key()
            for i in range(1, n):
                req = reqs[i]
                if not isinstance(req, Collective) or req.key() != key:
                    raise SpmdMismatch(
                        f"SPMD region diverged at collective step {step}: "
                        f"shard {local[i]} asked for {req!r} where shard "
                        f"{local[0]} asked for {ref!r}")
            sends = _perform(mesh, reqs, step)
            step += 1
    finally:
        for g in gens:
            if g is not None:
                g.close()


def _crosses(mesh, kind: str, axis: tuple) -> bool:
    """Does this collective need the other processes' payloads?"""
    if mesh.process_count == 1:
        return False
    if kind == "host_gather":
        return True
    return any(len({mesh.process_of(r) for r in g}) > 1
               for g in mesh.groups(axis))


def _exchange(mesh, ref: Optional[Collective], leaves: List[list],
              step: int) -> List[Optional[list]]:
    """One exchange across the processes of ``mesh``: this process's
    shards' payloads out, every shard's in (``[mesh.size]`` leaf lists
    in global rank order, this process's own tensors kept as they are).
    ``ref`` None says this process's shards finished the region."""
    from reflow_tpu_torch.parallel import dist

    header = ("done" if ref is None else ref.wire_key(), step)
    got, sent, received = dist.exchange(
        header, [t for ls in leaves for t in ls])
    heads = [h for h, _ in got]
    if len(set(heads)) > 1:
        me = mesh.process_index
        other = next(p for p, h in enumerate(heads) if h != heads[me])

        def says(p):
            what, _ = heads[p]
            return ("its shards returned" if what == "done"
                    else f"asked for {what}")

        raise SpmdMismatch(
            f"SPMD region diverged across processes at collective step "
            f"{step}: process {other} (shard "
            f"{mesh.ranks_of(other)[0]}) {says(other)} where process {me} "
            f"(shard {mesh.local_ranks[0]}) {says(me)}")
    if ref is None:
        return []
    _note(ref.kind, (PROCESS_BOUNDARY,), sent + received)
    like = leaves[0]
    out: List[Optional[list]] = [None] * mesh.size
    pos = {r: i for i, r in enumerate(mesh.local_ranks)}
    dev = mesh.device_list[mesh.local_ranks[0]]
    for p, (_, flat) in enumerate(got):
        for j, r in enumerate(mesh.ranks_of(p)):
            if r in pos:
                out[r] = leaves[pos[r]]
                continue
            row = flat[j * len(like):(j + 1) * len(like)]
            out[r] = [dist.unstage(b, t, dev) for b, t in zip(row, like)]
    return out


def _perform(mesh, reqs: List[Collective], step: int = 0) -> list:
    """Every local shard's result of one agreed collective."""
    ref = reqs[0]
    kind, axis = ref.kind, ref.axis
    local = mesh.local_ranks
    mine = [_leaves(q.x) for q in reqs]
    _note(kind, axis, sum(t.numel() * t.element_size()
                          for ls in mine for t in ls))
    if _crosses(mesh, kind, axis):
        leaves = _exchange(mesh, ref, mine, step)
    else:
        leaves = [None] * mesh.size
        for r, ls in zip(local, mine):
            leaves[r] = ls
    devs = mesh.device_list
    if kind == "host_gather":
        (reader,) = ref.params
        d0 = devs[local[0]]
        rows = reader(torch.stack([ls[0].to(d0) for ls in leaves]))
        return [rows] * len(local)
    out: List[Optional[list]] = [None] * mesh.size
    wanted = set(local)
    for group in mesh.groups(axis):
        if not wanted.intersection(group):
            continue
        m = len(group)
        per_leaf = []
        for li in range(len(leaves[group[0]])):
            xs = [leaves[r][li] for r in group]
            per_leaf.append(_combine(kind, ref.params, xs,
                                     [devs[r] for r in group], m))
        for j, r in enumerate(group):
            out[r] = [res[j] for res in per_leaf]
    return [_rebuild(q.x, out[r]) for q, r in zip(reqs, local)]


def _own(t: torch.Tensor, dev, first: bool) -> torch.Tensor:
    """``t`` as a shard's own tensor on ``dev``: the first receiver may
    take a freshly computed result itself, every other one a copy."""
    if first and t.device == dev:
        return t
    return t.to(dev, copy=True)


def _combine(kind: str, params: tuple, xs: List[torch.Tensor], devs,
             m: int) -> List[torch.Tensor]:
    """One leaf of one collective over one group of ``m`` shards
    (``xs`` in group order) -> each member's result."""
    d0 = xs[0].device
    if kind in ("psum", "pmax", "psum_scatter"):
        acc = xs[0].clone()
        for x in xs[1:]:
            x = x.to(d0)
            if kind == "pmax":
                acc = torch.maximum(acc, x)
            else:
                acc += x
        if kind == "psum_scatter":
            if acc.shape[0] % m:
                raise ValueError(f"psum_scatter: dim 0 ({acc.shape[0]}) is "
                                 f"not a multiple of the axis size {m}")
            parts = acc.chunk(m, 0)
            return [p.to(d) if p.device != d else p
                    for p, d in zip(parts, devs)]
        return [_own(acc, d, j == 0) for j, d in enumerate(devs)]
    if kind == "all_gather":
        cat = torch.cat([x.to(d0) for x in xs], 0)
        return [_own(cat, d, j == 0) for j, d in enumerate(devs)]
    if kind == "all_to_all":
        split_axis, concat_axis = params
        if xs[0].shape[split_axis] % m:
            raise ValueError(
                f"all_to_all: split axis {split_axis} "
                f"({xs[0].shape[split_axis]}) is not a multiple of the "
                f"axis size {m}")
        chunks = [x.chunk(m, split_axis) for x in xs]
        return [torch.cat([chunks[i][j].to(d) for i in range(m)],
                          concat_axis) for j, d in enumerate(devs)]
    if kind == "ppermute":
        (perm,) = params
        res: List[Optional[torch.Tensor]] = [None] * m
        for src, dst in perm:
            if res[dst] is not None:
                raise ValueError(f"ppermute: shard {dst} receives twice")
            res[dst] = xs[src].to(devs[dst], copy=True)
        return [r if r is not None else torch.zeros_like(xs[j], device=d)
                for j, (r, d) in enumerate(zip(res, devs))]
    raise ValueError(f"unknown collective {kind!r}")
