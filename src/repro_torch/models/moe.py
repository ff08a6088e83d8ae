"""Token-choice top-k MoE, port of ``repro.models.moe`` on one device.

``moe_ffn`` is the JAX package's path without a Runtime (``_moe_local``):
route every token to its top-k experts, give each token-copy a slot in
its expert's segment of a capacity-bounded (E, C, d) buffer
(``C = ceil(T·k·cf/E)``; a copy past the capacity is dropped and adds
nothing), run the experts as batched products over the buffer, and
combine the copies weighted by their renormalized gates. The routes are
the JAX package's exactly on the same inputs: the top-k is a stable
descending sort (``lax.top_k`` puts the lower index first among equal
probabilities), the slots come from a stable argsort and
``searchsorted``. The experts' weights (a quantized stack ``(E, G, B/2,
ff)`` in a QLoRA backbone) are decoded whole, as in the JAX package.
All of it is plain PyTorch on every device, as it is plain ``jnp`` in
the JAX package; profiler ranges name the decode (``moe.dequantize``)
and the expert products (``moe.experts``).

The expert-parallel path under a mesh (``shard_map``, the int8
all-to-all) comes with ROADMAP Queue A item 8.5.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import maybe_dequantize
from repro_torch.models.layers import _normal


def init_experts(generator, cfg: ModelConfig, dtype, device):
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": _normal(generator, (d, E), d, torch.float32, device),
        "wg": _normal(generator, (E, d, ff), d, dtype, device),
        "wu": _normal(generator, (E, d, ff), d, dtype, device),
        "wd": _normal(generator, (E, ff, d), ff, dtype, device),
    }


def _route(router_w, x2d, cfg: ModelConfig):
    """x2d: (T, d) -> (gates (T, k) renormalized, ids (T, k), the
    Switch-style balance loss)."""
    logits = x2d.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, ids = srt[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    density = F.one_hot(ids[:, 0], cfg.n_experts).to(torch.float32).mean(0)
    aux = cfg.n_experts * torch.sum(density * probs.mean(0))
    return gates, ids, aux


def _slot_assignment(ids_flat: torch.Tensor, E: int, C: int):
    """Capacity-bounded slot for every token-copy: ``(order, sorted_ids,
    slot, keep)``, the copies sorted by expert id (stably), ``slot`` the
    position within the expert's segment, ``keep`` whether slot < C."""
    order = torch.argsort(ids_flat, stable=True)
    sorted_ids = ids_flat[order]
    seg_start = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    slot = torch.arange(ids_flat.numel(), device=ids_flat.device) - seg_start
    return order, sorted_ids, slot, slot < C


def _moe_local(p, x2d, cfg: ModelConfig):
    T, d = x2d.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = max(1, math.ceil(T * k * cfg.capacity_factor / E))
    gates, ids, aux = _route(p["router"], x2d, cfg)
    order, sorted_ids, slot, keep = _slot_assignment(ids.reshape(-1), E, C)
    dst = torch.where(keep, slot, C)          # row C is the drop row
    buf = torch.zeros((E, C + 1, d), dtype=x2d.dtype, device=x2d.device) \
        .index_put((sorted_ids, dst), x2d[order // k])[:, :C]
    with torch.profiler.record_function("moe.dequantize"):
        wg, wu, wd = (maybe_dequantize(p[n], x2d.dtype)
                      for n in ("wg", "wu", "wd"))
    with torch.profiler.record_function("moe.experts"):
        h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
        out = torch.bmm(h, wd)
    y_sorted = F.pad(out, (0, 0, 0, 1))[sorted_ids, dst] * \
        keep[:, None].to(out.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    y = (y_sorted[inv].reshape(T, k, d) *
         gates[..., None].to(out.dtype)).sum(1)
    return y, aux


def moe_ffn(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux balance loss), the JAX package's
    path without a Runtime."""
    B, S, d = x.shape
    y, aux = _moe_local(p, x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d), aux
