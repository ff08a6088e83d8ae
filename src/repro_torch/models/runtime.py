"""The distribution context, port of ``repro.models.runtime``, and the
explicit SPMD pieces that stand in for ``shard_map``.

Model code is mesh-agnostic. When a :class:`Runtime` is installed, the
layers that the JAX package distributes explicitly (the MoE's
expert-parallel all-to-all, the attention's head split, the split-KV
decode, the Mamba and RG-LRU blocks' channel split) run their rank
bodies; without one (unit tests, one-device runs) everything is the
plain local path, exactly as before.

There is one process per rank, and every rank runs the same program.
Outside the bodies each rank holds the *global* tensors, as the JAX
package's global program does, and computes them redundantly: GSPMD's
partition of the dense layers is a layout this port does not
reproduce. A body takes its shard of each input by a spec
(:func:`shard_in`, as ``shard_map``'s ``in_specs`` do), works on it
with collectives over the mesh's per-axis process groups, and hands
back the global result (:func:`shard_out`, ``out_specs``). The
gradients are JAX's transposes, so a backward through a body gives the
global gradient on every rank:

- ``shard_in``: the cotangent blocks are all-gathered back to the global
  shape, then summed over the mesh axes the spec does not name (a
  replicated input's contributions add up);
- ``shard_out``: the cotangent's own block, divided by the size of the
  axes the spec does not name (the output is the same on each of them);
- :func:`psum` transposes to a ``psum``; :func:`all_gather` (tiled) to
  :func:`psum_scatter` and back; the tiled :func:`all_to_all` with
  split and concat on axis 0 is its own transpose.

A collective over one rank is the identity and is not issued, so a
mesh of ``(1, 1, 1)`` (one card) runs the bodies with no communication.
``DIST_TRACES`` counts which body each Runtime-aware call took: the
distributed one (``<op>_dist``) or the JAX package's local fallback
(``<op>_fallback``, e.g. a width the model axis does not divide).

:func:`record_collectives` tallies every collective issued while it is
active, by the JAX package's kind names (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``): the count, the
output bytes on this rank and the group's size, the record the JAX dry
run parses out of the partitioned HLO (``parse_collectives``). With no
recorder active it costs one check a collective.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

DIST_TRACES: Dict[str, int] = {}


def dist_trace(name: str) -> None:
    DIST_TRACES[name] = DIST_TRACES.get(name, 0) + 1


def reset_dist_traces() -> None:
    DIST_TRACES.clear()


class P:
    """A partition spec, one entry a tensor dim: None (replicated), an
    axis name, or a tuple of axis names (the dim split over their product,
    major to minor; a one-name tuple is the name), as
    ``jax.sharding.PartitionSpec``. A sequence that
    compares equal to the plain tuple of its entries, and a leaf of a
    ``repro_torch.tree`` (not a tuple the tree would descend into)."""
    __slots__ = ("dims",)

    def __init__(self, *dims):
        # a one-name tuple is the name, an empty one None (as JAX's)
        self.dims = tuple(
            (d[0] if len(d) == 1 else (tuple(d) or None))
            if isinstance(d, (tuple, list)) else d for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.dims == other.dims
        return isinstance(other, tuple) and self.dims == other

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self.dims)) + ")"


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class Runtime:
    """A mesh (:class:`repro_torch.launch.mesh.Mesh`) with its client /
    data-parallel axes and its tensor / expert-parallel axis."""
    mesh: Any
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"

    @property
    def dp_size(self) -> int:
        return self.mesh.size(self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.mesh.size((self.tp_axis,))

    def index(self, axes) -> int:
        """This rank's position along ``axes`` (a name or a tuple)."""
        return self.mesh.index(spec_axes(axes))


_CURRENT: list = [None]


def set_runtime(rt: Optional[Runtime]) -> None:
    _CURRENT[0] = rt


def get_runtime() -> Optional[Runtime]:
    return _CURRENT[0]


@contextlib.contextmanager
def runtime(rt: Optional[Runtime]):
    prev = _CURRENT[0]
    _CURRENT[0] = rt
    try:
        yield
    finally:
        _CURRENT[0] = prev


def constrain(x, *spec):
    """The identity. The JAX package's ``with_sharding_constraint`` only
    tells GSPMD a layout; eager PyTorch has no partitioner to tell, and
    the explicit bodies place their shards themselves."""
    return x


# -- collectives ------------------------------------------------------------
class CollectiveRecord:
    """The collectives issued under :func:`record_collectives`: ``stats``
    by kind, ``{"count", "bytes", "gsize"}`` (bytes of the outputs on
    this rank, gsize the largest group), and ``calls``, one ``(kind,
    axes, bytes, gsize)`` a call."""

    def __init__(self):
        self.stats: Dict[str, Dict[str, int]] = {}
        self.calls: list = []

    def add(self, kind: str, axes, out: torch.Tensor, gsize: int) -> None:
        nbytes = out.numel() * out.element_size()
        e = self.stats.setdefault(kind, {"count": 0, "bytes": 0,
                                         "gsize": 0})
        e["count"] += 1
        e["bytes"] += nbytes
        e["gsize"] = max(e["gsize"], gsize)
        self.calls.append((kind, tuple(axes), nbytes, gsize))


_RECORDERS: list = []


@contextlib.contextmanager
def record_collectives():
    """A :class:`CollectiveRecord` of every collective issued inside."""
    rec = CollectiveRecord()
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _record(kind: str, axes, out: torch.Tensor, gsize: int) -> None:
    for rec in _RECORDERS:
        rec.add(kind, axes, out, gsize)


def _reduce_scatter(out, x, group):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, group=group)


def _all_gather(out, x, group):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _gather_dim(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The blocks of the ranks along ``axes`` concatenated on ``dim``."""
    n = mesh.size(axes)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    _all_gather(out, xt, mesh.group(axes))
    if _RECORDERS:
        _record("all-gather", axes, out, n)
    return out.movedim(0, dim)


def _scatter_dim(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The sum over the ranks along ``axes`` of ``x``, each rank keeping
    its block of ``dim``."""
    n = mesh.size(axes)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    _reduce_scatter(out, xt, mesh.group(axes))
    if _RECORDERS:
        _record("reduce-scatter", axes, out, n)
    return out.movedim(0, dim)


def _block(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    n = mesh.size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {axes} ({n} ranks)")
    w = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * w, w)


def _sum_over(x: torch.Tensor, mesh, axes, op=None) -> torch.Tensor:
    if mesh.size(axes) == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=mesh.group(axes))
    if _RECORDERS:
        _record("all-reduce", axes, x, mesh.size(axes))
    return x


def _unnamed(mesh, spec) -> Tuple[str, ...]:
    named = {a for e in spec for a in spec_axes(e)}
    return tuple(a for a in mesh.axis_names if a not in named)


class _ShardIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        for d, e in enumerate(spec):
            x = _block(x, d, mesh, spec_axes(e))
        return x

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.spec, ctx.mesh
        for d, e in enumerate(spec):
            g = _gather_dim(g, d, mesh, spec_axes(e))
        return _sum_over(g, mesh, _unnamed(mesh, spec)), None, None


class _ShardOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        for d, e in enumerate(spec):
            x = _gather_dim(x, d, mesh, spec_axes(e))
        return x

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.spec, ctx.mesh
        for d, e in enumerate(spec):
            g = _block(g, d, mesh, spec_axes(e))
        n = mesh.size(_unnamed(mesh, spec))
        return (g / n if n > 1 else g).contiguous(), None, None


def _tensor_spec(spec, ndim: int) -> P:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return P(*spec, *([None] * (ndim - len(spec))))


def shard_in(x: torch.Tensor, spec, rt: Runtime) -> torch.Tensor:
    """This rank's block of the global ``x`` by ``spec`` (``shard_map``'s
    ``in_specs``)."""
    return _ShardIn.apply(x, _tensor_spec(spec, x.ndim), rt.mesh)


def shard_out(x: torch.Tensor, spec, rt: Runtime) -> torch.Tensor:
    """The global tensor assembled from every rank's block ``x`` by
    ``spec`` (``shard_map``'s ``out_specs``)."""
    return _ShardOut.apply(x, _tensor_spec(spec, x.ndim), rt.mesh)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _sum_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, axes, rt: Runtime) -> torch.Tensor:
    return _PSum.apply(x, rt.mesh, spec_axes(axes))


def pmean(x: torch.Tensor, axes, rt: Runtime) -> torch.Tensor:
    axes = spec_axes(axes)
    return psum(x, axes, rt) / rt.mesh.size(axes)


def pmax(x: torch.Tensor, axes, rt: Runtime) -> torch.Tensor:
    """The elementwise max over ``axes`` (no gradient: the split-KV
    decode's running max)."""
    return _sum_over(x.detach(), rt.mesh, spec_axes(axes),
                     op=dist.ReduceOp.MAX)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return _gather_dim(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.mesh, ctx.axes), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return _scatter_dim(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.mesh, ctx.axes), None, None, None


def all_gather(x: torch.Tensor, axes, rt: Runtime, *, dim: int = 0):
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``."""
    return _AllGather.apply(x, dim, rt.mesh, spec_axes(axes))


def psum_scatter(x: torch.Tensor, axes, rt: Runtime, *, dim: int = 0):
    """``lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``."""
    return _PSumScatter.apply(x, dim, rt.mesh, spec_axes(axes))


def _a2a(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    if mesh.size(axes) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axes))
    if _RECORDERS:
        _record("all-to-all", axes, out, mesh.size(axes))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _a2a(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.mesh, ctx.axes), None, None


def all_to_all(x: torch.Tensor, axes, rt: Runtime) -> torch.Tensor:
    """``lax.all_to_all(x, axes, split_axis=0, concat_axis=0,
    tiled=True)``: block j of axis 0 goes to rank j, the blocks received
    are concatenated in rank order. Its own transpose."""
    return _AllToAll.apply(x, rt.mesh, spec_axes(axes))


def all_to_all_raw(x: torch.Tensor, axes, rt: Runtime) -> torch.Tensor:
    """:func:`all_to_all` without autograd (int8 payloads)."""
    return _a2a(x, _mesh_of(rt), spec_axes(axes))


def _mesh_of(rt_or_mesh):
    return rt_or_mesh.mesh if isinstance(rt_or_mesh, Runtime) else rt_or_mesh


def all_gather_raw(x: torch.Tensor, axes, rt, *, dim: int = 0):
    """:func:`all_gather` without autograd (frozen weights, metrics), over
    a Runtime's or a bare mesh's axes."""
    return _gather_dim(x, dim, _mesh_of(rt), spec_axes(axes))


def psum_scatter_raw(x: torch.Tensor, axes, rt, *, dim: int = 0):
    """:func:`psum_scatter` without autograd, over a Runtime's or a bare
    mesh's axes."""
    return _scatter_dim(x, dim, _mesh_of(rt), spec_axes(axes))
