"""The distribution context, port of ``repro.models.runtime``, and the
explicit SPMD pieces that stand in for ``shard_map`` and GSPMD.

Model code is mesh-agnostic. When a :class:`Runtime` is installed, the
layers that the JAX package distributes explicitly (the MoE's
expert-parallel all-to-all, the attention's head split, the split-KV
decode, the Mamba and RG-LRU blocks' channel split) run their rank
bodies; without one (unit tests, one-device runs) everything is the
plain local path, exactly as before.

There is one process per rank, and every rank runs the same program on
its blocks, the production layout GSPMD gives the JAX package: each
rank holds its blocks of the parameters by
``launch.shardings.param_specs_tree`` (``rank_params``), of the batch by
``batch_specs_tree`` (``rank_batch``) and of a decode's cache by
``cache_specs_tree`` (``rank_cache``). The activations are the rank's
batch block, replicated over ``model`` between the layers; the dense
linears run Megatron-style on the rank's weight block (:func:`linear_col`,
:func:`linear_row`; an N block whose input is itself split is
:func:`linear_col` with ``x_split``), the embedding and the head
vocab-parallel, and any other leaf the rules cut is gathered for its one
use (:func:`gather_at_use`). A model step runs under
:meth:`Runtime.step_view`: the bodies see no dp axes (the batch is cut
already) and their transposes sum over ``model`` only; the model sums
the loss and the trainables' gradients over the dp axes once, so every
rank holds the global loss and gradient. On a mesh of one rank every
block is the whole tensor.

A body takes its shard of each input by a spec (:func:`shard_in`, as
``shard_map``'s ``in_specs`` do), works on it with collectives over the
mesh's per-axis process groups, and hands back the result replicated
(:func:`shard_out`, ``out_specs``). The gradients are JAX's transposes,
so a backward through a body gives the global gradient on every rank:

- ``shard_in``: the cotangent blocks are all-gathered back to the global
  shape, then summed over the mesh axes the spec does not name (a
  replicated input's contributions add up);
- ``shard_out``: the cotangent's own block, divided by the size of the
  axes the spec does not name (the output is the same on each of them);
- :func:`psum` transposes to a ``psum``; :func:`all_gather` (tiled) to
  :func:`psum_scatter` and back; the tiled :func:`all_to_all` with
  split and concat on axis 0 is its own transpose;
- :func:`tp_copy` is the identity whose transpose is a ``psum`` (the
  input of a product each rank does on its own block) and
  :func:`tp_reduce` the ``psum`` whose transpose is the identity (a
  partial product summed into a replicated output).

Under a step view the axes in ``Runtime.cut_axes`` are left out of
every transpose's sum: the cotangent of a dp-block is that block's own.

A collective over one rank is the identity and is not issued, so a
mesh of ``(1, 1, 1)`` (one card) runs the bodies with no communication.
``DIST_TRACES`` counts which body each Runtime-aware call took: the
distributed one (``<op>_dist``), the JAX package's local fallback
(``<op>_fallback``, e.g. a width the model axis does not divide), each
linear's route (``linear_col_dist``,
``linear_row_dist``, ``linear_nsplit_dist``) and each gathered leaf
(``<leaf>_gather``).

:func:`record_collectives` tallies every collective issued while it is
active, by the JAX package's kind names (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``): the count, the
output bytes on this rank and the group's size, the record the JAX dry
run parses out of the partitioned HLO (``parse_collectives``). With no
recorder active it costs one check a collective.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
    data-parallel axes and its tensor / expert-parallel axis.
    ``cut_axes`` is set by :meth:`step_view` only: the axes the
    activations are already cut over."""
    mesh: Any
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    cut_axes: Tuple[str, ...] = ()

    def step_view(self) -> "Runtime":
        """The Runtime a model step runs its bodies under: no dp axes (the
        batch is this rank's block already) and those axes in
        ``cut_axes``, out of every transpose's sum. A view, or a Runtime
        with no dp axes, is its own view."""
        if self.cut_axes or not self.dp_axes:
            return self
        return dataclasses.replace(self, dp_axes=(),
                                   cut_axes=tuple(self.dp_axes))

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


def _unnamed(mesh, spec, skip=()) -> Tuple[str, ...]:
    named = {a for e in spec for a in spec_axes(e)}
    return tuple(a for a in mesh.axis_names
                 if a not in named and a not in skip)


def _keep(axes, skip) -> Tuple[str, ...]:
    return tuple(a for a in axes if a not in skip)


class _ShardIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, skip):
        ctx.spec, ctx.mesh, ctx.skip = spec, mesh, skip
        for d, e in enumerate(spec):
            x = _block(x, d, mesh, spec_axes(e))
        return x

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.spec, ctx.mesh
        for d, e in enumerate(spec):
            g = _gather_dim(g, d, mesh, spec_axes(e))
        return (_sum_over(g, mesh, _unnamed(mesh, spec, ctx.skip)),
                None, None, None)


class _ShardOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, skip):
        ctx.spec, ctx.mesh, ctx.skip = spec, mesh, skip
        for d, e in enumerate(spec):
            x = _gather_dim(x, d, mesh, spec_axes(e))
        return x

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.spec, ctx.mesh
        for d, e in enumerate(spec):
            g = _block(g, d, mesh, spec_axes(e))
        n = mesh.size(_unnamed(mesh, spec, ctx.skip))
        return (g / n if n > 1 else g).contiguous(), None, None, None


def _tensor_spec(spec, ndim: int, skip=()) -> P:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    spec = [_keep(spec_axes(e), skip) or None for e in spec]
    return P(*spec, *([None] * (ndim - len(spec))))


def shard_in(x: torch.Tensor, spec, rt: Runtime) -> torch.Tensor:
    """This rank's block of the global ``x`` by ``spec`` (``shard_map``'s
    ``in_specs``). Under a step view the cut axes are left out of the
    spec and of the transpose's sum."""
    return _ShardIn.apply(x, _tensor_spec(spec, x.ndim, rt.cut_axes),
                          rt.mesh, rt.cut_axes)


def shard_out(x: torch.Tensor, spec, rt: Runtime) -> torch.Tensor:
    """The global tensor assembled from every rank's block ``x`` by
    ``spec`` (``shard_map``'s ``out_specs``)."""
    return _ShardOut.apply(x, _tensor_spec(spec, x.ndim, rt.cut_axes),
                           rt.mesh, rt.cut_axes)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, back):
        ctx.mesh, ctx.back = mesh, back
        return _sum_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.mesh, ctx.back), None, None, None


def psum(x: torch.Tensor, axes, rt: Runtime) -> torch.Tensor:
    axes = spec_axes(axes)
    return _PSum.apply(x, rt.mesh, axes, _keep(axes, rt.cut_axes))


def tp_copy(x: torch.Tensor, rt: Runtime, axes=None) -> torch.Tensor:
    """The identity, whose transpose is a ``psum`` over ``axes`` (the
    model axis by default): ``x`` replicated there and each rank's use
    of it a partial of the whole (Megatron's copy to the tensor-parallel
    region)."""
    axes = spec_axes(rt.tp_axis if axes is None else axes)
    return _PSum.apply(x, rt.mesh, (), _keep(axes, rt.cut_axes))


def tp_reduce(x: torch.Tensor, rt: Runtime, axes=None) -> torch.Tensor:
    """A ``psum`` over ``axes`` (the model axis by default) whose
    transpose is the identity: the ranks' partials summed into an output
    replicated there, whose cotangent each rank holds whole (Megatron's
    reduce from the tensor-parallel region)."""
    return _PSum.apply(x, rt.mesh,
                       spec_axes(rt.tp_axis if axes is None else axes), ())


def _last(ndim: int, axis) -> P:
    return P(*([None] * (ndim - 1)), axis)


def linear_col(x, w, lo, mm, rt: Runtime, *, x_split: bool = False,
               gather: bool = False):
    """A column-parallel linear: ``w`` holds this rank's block of the
    output columns, ``lo`` the LoRA pair whole or None, ``mm(x, w,
    pair)`` the local product. ``x`` is replicated over the model axis
    (:func:`tp_copy`: its dx is the sum of the ranks' partials), or with
    ``x_split`` the rank's block of its last dim, all-gathered first
    (transpose: a reduce-scatter; the route of an N-split QTensor whose
    contraction dim is cut upstream). The rank takes B's column block
    (:func:`shard_in`: its backward gathers dB) and A whole (its dA a
    partial). Returns the rank's output columns, or with ``gather`` the
    whole output (:func:`shard_out`)."""
    tp = rt.tp_axis
    if x_split:
        dist_trace("linear_nsplit_dist")
        x = all_gather(x, tp, rt, dim=x.ndim - 1)
    else:
        dist_trace("linear_col_dist")
        x = tp_copy(x, rt)
    pair = None if lo is None else {
        "a": tp_copy(lo["a"], rt), "b": shard_in(lo["b"], P(None, tp), rt)}
    y = mm(x, w, pair)
    return shard_out(y, _last(y.ndim, tp), rt) if gather else y


def linear_row(x, w, lo, mm, rt: Runtime, *, x_split: bool = True):
    """A row-parallel linear: ``w`` holds this rank's block of the
    contraction rows, ``x`` the matching block of its last dim (or with
    ``x_split=False`` replicated, and cut here). The rank takes A's row
    block and B whole, so its fused partial is ``x_k W_k + s (x_k A_k)
    B``, and their :func:`tp_reduce` is the whole product."""
    dist_trace("linear_row_dist")
    tp = rt.tp_axis
    if not x_split:
        x = shard_in(x, _last(x.ndim, tp), rt)
    pair = None if lo is None else {
        "a": shard_in(lo["a"], P(tp, None), rt), "b": tp_copy(lo["b"], rt)}
    return tp_reduce(mm(x, w, pair), rt)


def gather_at_use(t: torch.Tensor, spec, rt, name: str) -> torch.Tensor:
    """A frozen leaf's block all-gathered whole by its ``spec``
    (:func:`all_gather_raw` on each cut dim) for its one use, traced as
    ``<name>_gather``; the caller drops it after the use."""
    if not any(spec_axes(e) for e in spec):
        return t
    dist_trace(f"{name}_gather")
    for d, e in enumerate(spec):
        if spec_axes(e):
            t = all_gather_raw(t.contiguous(), e, rt, dim=d)
    return t


def reblock(t: torch.Tensor, held, want, rt: Runtime,
            name: str) -> torch.Tensor:
    """A frozen block held by the spec ``held`` as the block of the spec
    ``want`` (the layout a body reads): itself when they agree, else
    gathered whole where it is cut (:func:`gather_at_use`) and cut by
    ``want``."""
    pad = lambda s: (None,) * (t.ndim - len(tuple(s))) + tuple(s)
    held, want = pad(held), pad(want)
    if held == want:
        return t
    whole = gather_at_use(t, P(*held), rt, name)
    for d, e in enumerate(want):
        whole = _block(whole, d, rt.mesh, spec_axes(e))
    return whole.contiguous()


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


def all_reduce_raw(x: torch.Tensor, axes, rt) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` without autograd (gradients,
    counts), over a Runtime's or a bare mesh's axes."""
    return _sum_over(x.detach(), _mesh_of(rt), spec_axes(axes))


def psum_scatter_raw(x: torch.Tensor, axes, rt, *, dim: int = 0):
    """:func:`psum_scatter` without autograd, over a Runtime's or a bare
    mesh's axes."""
    return _scatter_dim(x, dim, _mesh_of(rt), spec_axes(axes))
