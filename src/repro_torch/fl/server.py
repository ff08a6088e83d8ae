"""FL server, port of ``repro.fl.server``: weighted aggregation of
(quantized) client updates.

    w_final = Σ_i (m_i / Σ_j m_j) · dequant(update_i)

applied in the trainable (LoRA/adapter) basis: updates are deltas, so the
new global trainables are w_global + Σ weighted deltas. The guards fail
loudly where the JAX ones do. The hierarchical form (``tree_partials``,
``aggregate_tree``) waits for ``ROADMAP.md`` Queue A item 6.
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


def secure_sum_bytes(updates) -> int:
    """Total uplink payload this round (comm-cost bookkeeping)."""
    return int(sum(tree_bytes(d) for _, d in updates))
