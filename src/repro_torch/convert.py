"""Move parameter trees between the JAX package and the port via numpy.

The port never imports JAX: :func:`tree_from_numpy` takes a tree whose
leaves are array-likes (numpy arrays, or JAX arrays, which ``np.array``
reads) and duck-types QTensors — any leaf with ``q``, ``scales``,
``bits``, ``mode``, ``block`` and ``orig_shape`` becomes a
:class:`~repro_torch.core.quant.QTensor`, stacked layer payloads and a
bf16 ``out_dtype`` included — so a test can hand over a JAX tree (a
``Model.init_params`` tree too) as it is. bf16 arrays cross bit for bit
(their 16-bit patterns are reinterpreted). :func:`tree_to_numpy` is the
inverse, except that bf16 tensors come back as float32 arrays (numpy has
no bf16 of its own). :func:`rank_tree_from_numpy` carries a JAX tree into
one rank's shard of a Runtime's mesh, by ``launch.shardings``' rules.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.core.quant import QTensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}
_QT_FIELDS = ("q", "scales", "bits", "mode", "block", "orig_shape")


def _is_qtensor_like(leaf) -> bool:
    return all(hasattr(leaf, f) for f in _QT_FIELDS)


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    return _DTYPES[np.dtype(d).name if not isinstance(d, str) else d]


def _tensor(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .astype(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.as_tensor(a, device=device)


def tree_from_numpy(tree, device=None):
    """A port tree (torch tensors on ``device``) from array-like leaves."""
    dev = resolve_device(device)

    def conv(leaf):
        if _is_qtensor_like(leaf):
            out_dtype = getattr(leaf, "out_dtype", None)
            return QTensor(
                q=_tensor(np.array(leaf.q), dev),
                scales=_tensor(np.array(leaf.scales), dev),
                bits=int(leaf.bits), mode=str(leaf.mode),
                block=int(leaf.block),
                out_dtype=torch.float32 if out_dtype is None
                else _torch_dtype(out_dtype),
                orig_shape=tuple(int(s) for s in leaf.orig_shape))
        return _tensor(np.array(leaf), dev)
    return tree_lib.tree_map(conv, tree)


def tree_to_numpy(tree):
    """numpy leaves from a port tree; a QTensor keeps its dataclass with
    numpy ``q``/``scales`` and ``out_dtype`` as a dtype name."""
    def conv(leaf):
        if isinstance(leaf, QTensor):
            return dataclasses.replace(
                leaf, q=leaf.q.cpu().numpy(), scales=leaf.scales.cpu().numpy(),
                out_dtype=str(leaf.out_dtype).replace("torch.", ""))
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.detach().cpu().numpy()
    return tree_lib.tree_map(conv, tree)


def tree_to(tree, device):
    """The same tree with every tensor (QTensor payloads included) on
    ``device``, dtypes unchanged: the card's weights on the CPU, say."""
    dev = torch.device(device)

    def move(leaf):
        if isinstance(leaf, QTensor):
            return dataclasses.replace(leaf, q=leaf.q.to(dev),
                                       scales=leaf.scales.to(dev))
        return leaf.to(dev)
    return tree_lib.tree_map(move, tree)


def rank_tree_from_numpy(tree, cfg, rt, device=None):
    """This rank's shard of a JAX model tree on ``device`` in the
    production layout: the leaves cross on the CPU,
    ``launch.shardings.rank_params`` cuts every leaf by the sharding
    rules (each block owning its storage), and only the blocks move to
    the device."""
    from repro_torch.launch.shardings import rank_params
    dev = resolve_device(device)
    return tree_to(rank_params(cfg, tree_from_numpy(tree, "cpu"), rt), dev)
