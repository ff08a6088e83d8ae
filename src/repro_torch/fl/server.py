"""FL server, port of ``repro.fl.server``: weighted aggregation of
(quantized) client updates.

    w_final = Σ_i (m_i / Σ_j m_j) · dequant(update_i)

applied in the trainable (LoRA/adapter) basis: updates are deltas, so the
new global trainables are w_global + Σ weighted deltas. The guards fail
loudly where the JAX ones do. The hierarchical form (``tree_partials``,
``aggregate_tree``) reduces each shard's rows of the cohort to a
partial sum and mass, then the partials; on a mesh (``mesh=``) each
rank holds and reduces only its own shard's rows, and the partials
cross the ranks in one all-reduce over the data-parallel group.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core.quant import (QTensor, dequantize, dequantize_tree,
                                    tree_bytes)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def check_weights(weights, n_updates: int):
    """Shared guard for ``aggregate`` / ``aggregate_stacked``: a
    mis-shaped or mis-normalized aggregation-weight vector silently
    rescales every update, so fail loudly instead. The shape is always
    checked; the values only when they are on the host (numpy, or a CPU
    tensor). A caller that hands over weights on the card has checked
    them on the host first (the cohort engine does, when it is built),
    as the JAX package's jitted round does with its traced weights."""
    shape = _shape(weights)
    if shape != (n_updates,):
        raise ValueError(
            f"aggregation weights shape {shape} != ({n_updates},) — one "
            "weight per committed update")
    if isinstance(weights, torch.Tensor):
        if weights.device.type != "cpu":
            return
        weights = weights.numpy()
    w = np.asarray(weights, np.float64)
    if not np.all(np.isfinite(w)) or np.any(w < 0):
        raise ValueError(f"aggregation weights must be finite and >= 0, "
                         f"got {w}")
    if abs(float(w.sum()) - 1.0) > 1e-3:
        raise ValueError(
            f"aggregation weights sum to {w.sum():.6f}, expected 1 "
            "(normalize m_i / sum m_j, or the staleness-discounted "
            "equivalent, before aggregating)")


def _leaf_shape(l) -> tuple:
    return tuple(l.orig_shape) if isinstance(l, QTensor) else _shape(l)


def check_delta(delta, ref=None, *, ctx: str = "client delta"):
    """Guard one client's update tree before it can touch the global
    model: every float leaf must be finite (for a QTensor leaf, its
    ``scales``), and with ``ref`` (the global trainable tree) the leaf
    count and every leaf's shape must match it."""
    leaves = list(tree_lib.flatten_with_path(delta))
    if ref is not None:
        ref_leaves = list(tree_lib.flatten_with_path(ref))
        if len(ref_leaves) != len(leaves):
            raise ValueError(
                f"{ctx}: tree has {len(leaves)} leaves, global trainable "
                f"has {len(ref_leaves)}")
        for (path, l), (_, rl) in zip(leaves, ref_leaves):
            if _leaf_shape(l) != _shape(rl):
                raise ValueError(
                    f"{ctx}: leaf {tree_lib.path_str(path)} has shape "
                    f"{_leaf_shape(l)}, global trainable expects "
                    f"{_shape(rl)}")
    for path, l in leaves:
        arr = torch.as_tensor(l.scales if isinstance(l, QTensor) else l)
        if arr.dtype.is_floating_point and not bool(torch.isfinite(arr).all()):
            raise ValueError(
                f"{ctx}: non-finite values at {tree_lib.path_str(path)} — "
                "refusing to aggregate a corrupt update into the global "
                "model")


def delta_ok(delta, ref=None) -> bool:
    """Tolerant form of :func:`check_delta` for skip-and-ledger paths."""
    try:
        check_delta(delta, ref)
        return True
    except ValueError:
        return False


def _apply(global_trainable, agg):
    return tree_lib.tree_map(
        lambda g, a: (g.to(torch.float32) + a).to(g.dtype),
        global_trainable, agg)


def aggregate(global_trainable, updates: Sequence[Tuple[float, object]]):
    """updates: list of (m_i, delta tree) — m_i is the client sample
    count (plain FedAvg) or any non-negative importance mass; weights are
    m_i normalized over the committed set."""
    masses = [float(m) for m, _ in updates]
    total = sum(masses)
    if not updates or total <= 0 or not np.all(np.isfinite(masses)) or \
            min(masses) < 0:
        raise ValueError(
            f"aggregate needs non-negative finite masses with a positive "
            f"total, got {masses}")
    ws = np.asarray(masses, np.float64) / total
    check_weights(ws.astype(np.float32), len(updates))
    acc = None
    for w, (_, delta) in zip(ws, updates):
        d = dequantize_tree(delta, torch.float32)
        w = float(w)
        acc = tree_lib.tree_map(lambda x: w * x, d) if acc is None else \
            tree_lib.tree_map(lambda a, x: a + w * x, acc, d)
    return _apply(global_trainable, acc)


def aggregate_stacked(global_trainable, weights, stacked_delta):
    """Batched FedAvg for the cohort engine: every delta leaf carries a
    leading cohort axis (possibly blockwise-quantized along its trailing
    dims), and the weighted sum is one ``tensordot`` per leaf.

    ``weights`` — (n_clients,) float32, already normalized."""
    leaves = tree_lib.leaves(stacked_delta)
    n = _leaf_shape(leaves[0])[0] if leaves else 0
    for l in leaves:
        if _leaf_shape(l)[0] != n:
            raise ValueError("stacked delta leaves disagree on the "
                             f"cohort axis: {_leaf_shape(l)[0]} vs {n}")
    check_weights(weights, n)

    def reduce_leaf(d):
        x = dequantize(d, torch.float32) if isinstance(d, QTensor) else \
            d.to(torch.float32)
        w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
        return torch.tensordot(w, x, dims=1)

    return _apply(global_trainable,
                  tree_lib.tree_map(reduce_leaf, stacked_delta))


def _check_masses(masses, n: int):
    if _shape(masses) != (n,):
        raise ValueError(
            f"masses shape {_shape(masses)} != ({n},) — one mass per "
            "stacked update")
    if isinstance(masses, torch.Tensor):
        if masses.device.type != "cpu":
            return
        masses = masses.numpy()
    m = np.asarray(masses, np.float64)
    if not np.all(np.isfinite(m)) or np.any(m < 0):
        raise ValueError(f"masses must be finite and >= 0, got {m}")


def _stack_len(stacked_delta) -> int:
    leaves = tree_lib.leaves(stacked_delta)
    n = _leaf_shape(leaves[0])[0] if leaves else 0
    for l in leaves:
        if _leaf_shape(l)[0] != n:
            raise ValueError("stacked delta leaves disagree on the "
                             f"cohort axis: {_leaf_shape(l)[0]} vs {n}")
    return n


def _f32(d) -> torch.Tensor:
    return dequantize(d, torch.float32) if isinstance(d, QTensor) else \
        d.to(torch.float32)


def tree_partials(masses, stacked_delta, *, n_shards: int = 0, mesh=None):
    """The shard-local stage of hierarchical FedAvg: the stacked cohort
    axis split into ``n_shards`` contiguous groups, each reduced to a
    partial weighted delta sum and its partial mass, the pair a shard
    uploads instead of its clients' deltas. ``masses`` are non-negative
    importance masses (they need not sum to 1: the global stage divides
    by the total). A cohort width that is not a shard multiple pads with
    zero-mass, zero-delta rows (exact).

    With ``mesh`` the cohort is split over its data-parallel ranks and
    ``masses`` and ``stacked_delta`` are this rank's rows: the rank
    reduces them to its partial, and one all-reduce over the dp group
    gives every rank all of them (``n_shards`` is the dp size).

    Returns ``(partials, mass_s)``: a delta-shaped tree whose leaves carry
    a leading ``(n_shards,)`` axis, and the ``(n_shards,)`` masses."""
    if mesh is None and n_shards < 1:
        raise ValueError(f"tree_partials needs n_shards >= 1, got "
                         f"{n_shards}")
    n = _stack_len(stacked_delta)
    _check_masses(masses, n)
    if mesh is not None:
        return _rank_partials(masses, stacked_delta, mesh, n_shards)
    pad = -(-n // n_shards) * n_shards - n
    leaves = tree_lib.leaves(stacked_delta)
    dev = _f32(leaves[0]).device if leaves else None
    m_r = torch.nn.functional.pad(
        torch.as_tensor(masses, dtype=torch.float32, device=dev), (0, pad)
    ).reshape(n_shards, -1)

    def leaf(d):
        x = _f32(d)
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        x = x.reshape(n_shards, -1, *x.shape[1:])
        return torch.einsum("sb,sb...->s...", m_r, x)

    return tree_lib.tree_map(leaf, stacked_delta), m_r.sum(1)


def _rank_partials(masses, stacked_delta, mesh, n_shards: int):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    dp = mesh_lib.dp_axes(mesh)
    s = mesh_lib.cohort_axis_size(mesh)
    if n_shards and n_shards != s:
        raise ValueError(f"n_shards {n_shards} != the mesh's {s} "
                         "data-parallel shards")
    i = mesh.index(dp) if dp else 0
    leaves = tree_lib.leaves(stacked_delta)
    dev = _f32(leaves[0]).device if leaves else None
    m = torch.as_tensor(masses, dtype=torch.float32, device=dev)
    mine = [torch.einsum("b,b...->...", m, _f32(d)) for d in leaves]
    mine.append(m.sum())
    # one flat buffer: row i holds this shard's partials, the rest zeros
    flat = torch.cat([t.reshape(-1) for t in mine])
    buf = flat.new_zeros((s, flat.numel()))
    buf[i] = flat
    if s > 1:
        dist.all_reduce(buf, group=mesh.group(dp))
    outs, o = [], 0
    for t in mine:
        outs.append(buf[:, o:o + t.numel()].reshape(s, *t.shape))
        o += t.numel()
    return tree_lib.from_leaves(stacked_delta, outs[:-1]), outs[-1]


def aggregate_tree(global_trainable, masses, stacked_delta, *,
                   n_shards: int = 0, mesh=None):
    """Hierarchical (two-level) FedAvg: clients -> shard-local partial sums
    (:func:`tree_partials`) -> the sum of the ``n_shards`` partials over
    the total mass. A re-association of :func:`aggregate_stacked` (tree
    == flat within fp tolerance); on a ``mesh`` no rank ever holds or
    reduces another shard's rows, only the small partials cross."""
    partials, mass_s = tree_partials(masses, stacked_delta,
                                     n_shards=n_shards, mesh=mesh)
    total = mass_s.sum()
    return _apply(global_trainable,
                  tree_lib.tree_map(lambda p: p.sum(0) / total, partials))


def secure_sum_bytes(updates) -> int:
    """Total uplink payload this round (comm-cost bookkeeping)."""
    return int(sum(tree_bytes(d) for _, d in updates))
