"""Device meshes over ``torch.distributed``, port of ``repro.launch.mesh``.

One process per rank. A :class:`Mesh` lays the world's ranks out
row-major over named axes (the JAX package's ``("pod", "data",
"model")``), as a ``torch.distributed.device_mesh.DeviceMesh`` with those
names, and holds a process group for every set of its axes: a
collective over ``("pod", "data")`` runs among the ranks that share the
``model`` coordinate, in the order of their linear index over the named
axes, as a JAX collective over a tuple of axes does.

Single pod: ``(data=16, model=16)`` = 256 ranks; multi-pod ``(pod=2,
data=16, model=16)`` = 512, where ``pod`` carries only data and client
parallelism and the FL aggregation's reduce. Building a mesh needs a
process group whose world holds exactly its ranks: :func:`init_world`
makes the one-process world of one card (NCCL on the card, gloo on the
CPU), a launcher of several processes initializes its own. Nothing here
touches the process group at import.
"""
from __future__ import annotations

import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.runtime import P


def init_world(device=None) -> None:
    """The process group of a one-process world on ``device`` (the card
    unless the caller asks for the CPU): NCCL on the card, gloo on the
    CPU, over an in-process ``HashStore``. A world that is already up is
    kept; a failure raises (no fallback to a local path)."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def world_device_type() -> str:
    """``"cuda"`` when the default process group is NCCL, else ``"cpu"``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


class Mesh:
    """The world's ranks on named axes. ``shape`` maps each axis to its
    size; ``coords`` is this rank's coordinate on each."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        from torch.distributed.device_mesh import DeviceMesh
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axes {names} disagree")
        if not dist.is_initialized():
            raise RuntimeError("no process group: call init_world() or "
                               "torch.distributed.init_process_group first")
        n = int(np.prod(shape))
        world = dist.get_world_size()
        if world != n:
            raise RuntimeError(f"mesh {dict(zip(names, shape))} needs {n} "
                               f"ranks; the world has {world}")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.rank = dist.get_rank()
        self.coords = dict(zip(names, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        ids = torch.arange(n).reshape(shape)
        self.device_mesh = DeviceMesh(world_device_type(), ids,
                                      mesh_dim_names=names)
        self._groups: Dict[Tuple[str, ...], object] = {}
        # every rank creates every group, in one order (new_group is a
        # collective over the world)
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                if r == len(names):
                    self._groups[axes] = dist.group.WORLD
                    continue
                if r == 1:
                    self._groups[axes] = self.device_mesh.get_group(axes[0])
                    continue
                rest = [a for a in names if a not in axes]
                perm = [names.index(a) for a in rest + list(axes)]
                blocks = ids.permute(perm).reshape(
                    -1, int(np.prod([self.shape[a] for a in axes])))
                for row in blocks.tolist():
                    g = dist.new_group(sorted(row))
                    if self.rank in row:
                        self._groups[axes] = g

    def _canon(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} must follow the mesh's order "
                             f"{self.axis_names}")
        return axes

    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._canon(axes)]))

    def index(self, axes) -> int:
        """This rank's linear index over ``axes`` (major to minor)."""
        i = 0
        for a in self._canon(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        axes = self._canon(axes)
        if not axes:
            raise ValueError("a collective needs at least one axis")
        return self._groups[axes]

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; the world has {world}")
    return Mesh(shape, axes)


def make_debug_mesh(shape=(1, 2, 2), axes=("pod", "data", "model")) -> Mesh:
    """Small mesh for multi-rank CPU tests (gloo)."""
    return Mesh(shape, axes)


def make_data_mesh(n_shards: int = 0) -> Mesh:
    """Data-parallel-only mesh ``(data=n_shards,)``, the mesh the cohort and
    fleet-GAN engines split their cohort axis over; ``n_shards=0`` takes
    the whole world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_shards or world
    if world < n:
        raise RuntimeError(f"need {n} ranks for a (data={n}) mesh; the "
                           f"world has {world}")
    return Mesh((n,), ("data",))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def cohort_axis_size(mesh) -> int:
    """Number of mesh shards along the cohort (data-parallel) axes."""
    return mesh.size(dp_axes(mesh)) if dp_axes(mesh) else 1


def cohort_spec(mesh, ndim: int) -> P:
    """The spec that splits a leading cohort axis over the data-parallel
    axes and replicates the rest (``cohort_sharding``'s). The replicated
    placement (``replicated_sharding``'s) is the whole tensor on every
    rank, the port's default: it needs no spec."""
    dp = dp_axes(mesh)
    return P(dp if dp else None, *([None] * (ndim - 1)))


def cohort_rows(mesh, n: int) -> slice:
    """The contiguous rows of an ``n``-wide cohort axis this rank holds
    under :func:`cohort_spec` (``n`` a multiple of the shard count)."""
    s = cohort_axis_size(mesh)
    if n % s:
        raise ValueError(f"cohort width {n} does not split over {s} shards")
    i = mesh.index(dp_axes(mesh)) if dp_axes(mesh) else 0
    w = n // s
    return slice(i * w, (i + 1) * w)
