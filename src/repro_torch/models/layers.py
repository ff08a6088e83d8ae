"""Transformer building blocks, port of ``repro.models.layers``: RMS
norm, RoPE, GQA attention (causal, sliding window) for train and
prefill, the ring-buffer KV cache with its int8 quantizer, one-token
``attention_decode``, and the MLPs.

Weights may be QTensors (the quantized backbone, paper §III-C); every
projection optionally carries a LoRA pair and then runs through the
fused LoRA op. Weights are bias-free. Cross-attention (the encdec
decoder's ``c``-prefixed weights against the encoder's output ``kv_x``,
not causal, no RoPE), the learned-position families' ``use_rope=False``
and a decode step that reads a fixed cache (``update_cache=False``, the
cross-attention's encoder K/V) follow the JAX package's options.

Under a Runtime (the production layout) the model passes ``specs``, the
layer's leaves' logical specs by ``launch.shardings.param_specs_tree``
(a QTensor's storage spec read as its weight's), and every projection runs on the
rank's block (:func:`tp_linear`): ``wq`` column-parallel when the model
axis divides the heads, else row-parallel (the contraction dim: q psum'd
whole and the attention's padded head split takes it from there),
``wk``/``wv`` column-parallel when it divides the KV heads, else whole,
``wo`` row-parallel (or by its fallback), ``wg``/``wu``
column-parallel and ``wd`` row-parallel; a QTensor whose contraction
split fell back to N (``_lift_qtensor``: its quant groups do not divide
the axis) gathers its split input and computes its N block. A decode
step's cache is the rank's block (the slots over ``model`` where the
axis divides them): the new row is written only on the rank that owns
slot ``pos % M`` (:func:`ring_write`) and the split-KV attention reads
the block it holds; a ring the axis does not divide is held whole,
written and read whole on every rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import spec
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora as lora_lib
from repro_torch.core.quant import _div
from repro_torch.kernels import ops as kops
from repro_torch.models import runtime as rt_lib
from repro_torch.models.runtime import P, spec_axes


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.to(torch.float32))
            ).to(x.dtype)


# ------------------------------------------------------------------ rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D) with D even; positions: (S,) or a 0-d tensor (one
    decode position). In fp32, cast back. theta is a fill on x's device:
    a tensor made from the host would wait for the card's stream."""
    D = x.shape[-1]
    half = D // 2
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32,
                                     device=x.device))
    freq = torch.exp(-log_theta * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32).reshape(-1)[:, None] * freq
    cos = torch.cos(ang)[None, :, None, :]          # (1, S, 1, half)
    sin = torch.sin(ang)[None, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ linear
def linear(x, w, lo=None, *, cfg: ModelConfig):
    return lora_lib.linear(x, w, lo, alpha=cfg.lora_alpha,
                           rank=cfg.lora_rank)


def _route(spec) -> str:
    """``"col"``, ``"row"`` or ``"whole"``: how a held 2-D weight is cut,
    read from its logical spec."""
    ls = (None, None) + tuple(spec)
    if spec_axes(ls[-1]):
        return "col"
    return "row" if spec_axes(ls[-2]) else "whole"


def tp_linear(x, w, lo, spec, cfg: ModelConfig, rt, *, x_split=False,
              gather=True):
    """:func:`linear` on the rank's block ``w`` held by ``spec`` (its
    logical spec) in the production layout: ``(y, split)``. ``x`` is
    replicated over the model axis, or with ``x_split`` the rank's block of its last dim (a
    column-parallel layer's output). A column block gives the rank's
    output columns (``split``), or the whole output with ``gather``; a
    row block the whole output, its partials summed; a whole weight the
    whole output (a split input gathered first)."""
    mm = lambda x_, w_, pair: linear(x_, w_, pair, cfg=cfg)
    route = _route(spec)
    if route == "col":
        y = rt_lib.linear_col(x, w, lo, mm, rt, x_split=x_split,
                              gather=gather)
        return y, not gather
    if route == "row":
        return rt_lib.linear_row(x, w, lo, mm, rt, x_split=x_split), False
    if x_split:
        x = rt_lib.shard_out(x, P(*([None] * (x.ndim - 1)), rt.tp_axis),
                             rt)
    return mm(x, w, lo), False


def _normal(generator, shape, fan_in, dtype, device):
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * (1.0 / math.sqrt(fan_in))).to(device=device, dtype=dtype)


# ------------------------------------------------------------------ attention
def init_attention(generator, cfg: ModelConfig, dtype, device, *,
                   cross: bool = False):
    """wq, wk, wv, wo (``cwq`` ... for the cross-attention)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    pre = "c" if cross else ""
    return {pre + "wq": _normal(generator, (d, qd), d, dtype, device),
            pre + "wk": _normal(generator, (d, kvd), d, dtype, device),
            pre + "wv": _normal(generator, (d, kvd), d, dtype, device),
            pre + "wo": _normal(generator, (qd, d), qd, dtype, device)}


def attention_specs(cfg: ModelConfig, dtype, *, cross: bool = False,
                    lead=()):
    """:func:`init_attention`'s leaves (stacked on ``lead``) as ``meta``
    tensors."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    f = lambda *sh: spec((*lead, *sh), dtype)
    pre = "c" if cross else ""
    return {pre + "wq": f(d, qd), pre + "wk": f(d, kvd),
            pre + "wv": f(d, kvd), pre + "wo": f(qd, d)}


def attention(p, x, positions, cfg: ModelConfig, *, lora=None, causal=True,
              window=None, kv_x=None, use_rope=True, prefix="", specs=None):
    """Full-sequence attention (train / prefill), port of
    ``repro.models.layers.attention``: self-attention over x, or
    cross-attention from x to ``kv_x`` (B, Skv, d) when given, with the
    weights and LoRA pairs named ``prefix + "wq"`` and so on. RoPE at
    ``positions`` applies to self-attention with ``use_rope``. Returns
    ``(out, (k, v))`` with the k and v (B, Skv, Hkv, D) that prefill
    caches (rotated when RoPE applies). In the production layout
    (``specs`` given) the rank's heads: k and v come back as the rank
    holds them (its KV heads when ``wk`` is column-parallel)."""
    if specs is not None:
        return _attention_tp(p, x, positions, cfg, lora or {}, causal, window,
                             kv_x, use_rope, prefix, specs,
                             rt_lib.get_runtime())
    B, S, _ = x.shape
    lo = lora or {}
    g = lambda n: lo.get(prefix + n)
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = linear(x, p[prefix + "wq"], g("wq"), cfg=cfg)
    k = linear(src, p[prefix + "wk"], g("wk"), cfg=cfg)
    v = linear(src, p[prefix + "wv"], g("wv"), cfg=cfg)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, Skv, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, Skv, cfg.n_kv_heads, cfg.head_dim)
    if use_rope and kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # cfg.calibrate asks for the JAX package's single-tile attention; the
    # port's op is one kernel launch on the card and one unchunked
    # product on the CPU either way, so the call is the same
    out = kops.flash_attention(q, k, v, causal=causal, window=window)
    y = linear(out.reshape(B, S, cfg.q_dim), p[prefix + "wo"], g("wo"),
               cfg=cfg)
    return y, (k, v)


def _attention_tp(p, x, positions, cfg, lo, causal, window, kv_x, use_rope,
                  prefix, specs, rt):
    B, S, _ = x.shape
    H, Hkv, D, m = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, rt.tp_size
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]

    def proj(name, inp, **kw):
        return tp_linear(inp, p[prefix + name], lo.get(prefix + name),
                         specs[prefix + name], cfg, rt, **kw)

    q, q_split = proj("wq", x, gather=False)
    k, k_split = proj("wk", src, gather=False)
    v, _ = proj("wv", src, gather=False)
    Hl = H // m if q_split else H
    q = q.reshape(B, S, Hl, D)
    k = k.reshape(B, Skv, -1, D)
    v = v.reshape(B, Skv, -1, D)
    if use_rope and kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if q_split:
        kh, vh = k, v
        if not k_split:
            # the rank's q heads meet their KV heads of the whole k and v,
            # whose gradients are the ranks' partials
            ids = torch.div(rt.index(rt.tp_axis) * Hl + torch.arange(
                Hl, device=q.device), H // Hkv, rounding_mode="floor")
            kh = rt_lib.tp_copy(k, rt).index_select(2, ids)
            vh = rt_lib.tp_copy(v, rt).index_select(2, ids)
        out = kops.flash_attention(q, kh, vh, causal=causal, window=window,
                                   heads_held=True)
    else:
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    y, _ = proj("wo", out.reshape(B, S, Hl * D), x_split=q_split)
    return y, (k, v)


# ------------------------------------------------------------------ kv cache
def ring_from_full(k, v, M: int, *, kv_quant: bool = False):
    """Full prefill K/V (B, S, Hkv, D) as a ring cache of M slots, port
    of ``repro.models.layers.ring_from_full``: slot s holds the largest
    position p < S with p % M == s, i.e. ``p = s + floor((S-1-s)/M)·M``
    (the last min(S, M) tokens), and ``slot_pos`` -1 when s >= S, so
    decoding goes on at position S with ``slot = pos % M`` for full and
    sliding-window caches alike. The numerator is negative when M > S,
    hence the floor division."""
    S = k.shape[1]
    s = torch.arange(M, device=k.device)
    p = s + torch.div(S - 1 - s, M, rounding_mode="floor") * M
    out = {"slot_pos": torch.where(s < S, p, -1).to(torch.int32)}
    if M != S:
        idx = p.clamp(0, S - 1)
        k, v = k.index_select(1, idx), v.index_select(1, idx)
    out["k"], ks = quant_kv(k, kv_quant)
    out["v"], vs = quant_kv(v, kv_quant)
    if kv_quant:
        out["k_scale"], out["v_scale"] = ks, vs
    return out


def quant_kv(x, enabled: bool):
    """Per-(token, head) absmax int8 quantization of K/V rows: x (..., D)
    -> (int8 payload, fp32 scale (..., 1)), or ``(x, None)`` when not
    ``enabled``. The division by 127 is IEEE on every device
    (``core.quant._div``), so the codes are the JAX package's eager
    ones bit for bit."""
    if not enabled:
        return x, None
    xf = x.to(torch.float32)
    s = _div(xf.abs().amax(-1, keepdim=True).clamp_min(1e-12), 127.0)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def dequant_kv(x, scale, dtype):
    if scale is None:
        return x.to(dtype)
    return (x.to(torch.float32) * scale).to(dtype)


def _kv_dtype(cfg: ModelConfig, dtype):
    return torch.int8 if cfg.kv_quant_bits == 8 else dtype


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device):
    """An empty ring KV cache for one layer (``max_len`` = the window for
    sliding-window attention); int8 rows and fp32 scales with
    ``cfg.kv_quant_bits == 8``."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kvd = _kv_dtype(cfg, dtype)
    c = {"k": torch.zeros(shape, dtype=kvd, device=device),
         "v": torch.zeros(shape, dtype=kvd, device=device),
         "slot_pos": torch.full((max_len,), -1, dtype=torch.int32,
                                device=device)}
    if cfg.kv_quant_bits == 8:
        c["k_scale"] = torch.zeros((*shape[:3], 1), device=device)
        c["v_scale"] = torch.zeros((*shape[:3], 1), device=device)
    return c


def kv_cache_specs(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   lead=()):
    """:func:`init_kv_cache`'s leaves (stacked on ``lead``) as ``meta``
    tensors."""
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": spec(shape, _kv_dtype(cfg, dtype)),
         "v": spec(shape, _kv_dtype(cfg, dtype)),
         "slot_pos": spec((*lead, max_len), torch.int32)}
    if cfg.kv_quant_bits == 8:
        c["k_scale"] = spec((*shape[:-1], 1))
        c["v_scale"] = spec((*shape[:-1], 1))
    return c


def ring_write(buf, dim: int, pos, val, rt, cut: bool = True) -> None:
    """Write ``val`` (size 1 on ``dim``) into the ring ``buf`` at slot
    ``pos % M``, in place with device ops. Under a Runtime ``rt`` with
    ``cut`` (the ring's slots split over the model axis: the held
    cache's ``slots_cut``, ``shardings.HeldCache``) ``buf`` is this
    rank's block of ``M / m`` slots and only the rank that owns the slot
    writes, at its local index; a ring held whole (``cut`` False: the
    model axis does not divide its slots) is written at ``pos % M`` on
    every rank, as the JAX package's replicated cache is."""
    M_l = buf.shape[dim]
    m = 1 if rt is None or not cut else rt.tp_size
    slot = torch.remainder(pos, M_l * m)
    idx = torch.remainder(slot, M_l).reshape(1).long()
    if m > 1:
        mine = torch.div(slot, M_l, rounding_mode="floor") == \
            rt.index(rt.tp_axis)
        val = torch.where(mine, val, buf.index_select(dim, idx))
    buf.index_copy_(dim, idx, val)


def attention_decode(p, x, pos, cache, cfg: ModelConfig, *, lora=None,
                     use_rope=True, prefix="", update_cache=True, specs=None,
                     slots_cut=True):
    """One-token attention against a ring cache, port of
    ``repro.models.layers.attention_decode``: x (B, 1, d); ``pos`` the
    absolute position as a 0-d integer tensor on x's device. With
    ``use_rope`` q and k are rotated at ``pos`` (keys are stored
    rotated). With ``update_cache`` the new k/v row (int8 with its scale
    when the cache holds ``k_scale``) goes to slot ``pos % M``, computed
    and written with device ops (``index_copy_`` into the cache's
    tensors, in place), so the step reads nothing back to the host;
    without it (the cross-attention's fixed encoder K/V) the cache is
    only read. Weights and LoRA pairs are named ``prefix + "wq"`` and so
    on. Returns ``(out, cache)``, the same dict, where the JAX function
    returns a new one. In the production layout (``specs`` given) the
    projections run on the rank's blocks, q, k and v gathered whole over
    the heads, and ``cache`` is the rank's block of slots, or the whole
    ring where ``slots_cut`` is False (:func:`ring_write`)."""
    B = x.shape[0]
    lo = lora or {}
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rt = rt_lib.get_runtime()

    def proj(inp, name):
        n = prefix + name
        if specs is None:
            return linear(inp, p[n], lo.get(n), cfg=cfg)
        return tp_linear(inp, p[n], lo.get(n), specs[n], cfg, rt)[0]

    q = proj(x, "wq").reshape(B, 1, H, D)
    if use_rope:
        q = rope(q, pos, cfg.rope_theta)
    if update_cache:
        k = proj(x, "wk").reshape(B, 1, Hkv, D)
        v = proj(x, "wv").reshape(B, 1, Hkv, D)
        if use_rope:
            k = rope(k, pos, cfg.rope_theta)
        quant = cfg.kv_quant_bits == 8 and "k_scale" in cache
        for name, val in (("k", k), ("v", v)):
            vq, vs = quant_kv(val, quant)
            ring_write(cache[name], 1, pos, vq.to(cache[name].dtype), rt,
                       slots_cut)
            if quant:
                ring_write(cache[name + "_scale"], 1, pos, vs, rt, slots_cut)
        ring_write(cache["slot_pos"], 0, pos, pos.reshape(1).to(torch.int32),
                   rt, slots_cut)
    out = kops.decode_attention(
        q, dequant_kv(cache["k"], cache.get("k_scale"), x.dtype),
        dequant_kv(cache["v"], cache.get("v_scale"), x.dtype),
        cache["slot_pos"][None], slots_cut=slots_cut)
    return proj(out.reshape(B, 1, cfg.q_dim), "wo"), cache


# ------------------------------------------------------------------ mlp
def init_mlp(generator, d: int, ff: int, kind: str, dtype, device):
    p = {"wu": _normal(generator, (d, ff), d, dtype, device),
         "wd": _normal(generator, (ff, d), ff, dtype, device)}
    if kind == "swiglu":
        p["wg"] = _normal(generator, (d, ff), d, dtype, device)
    return p


def mlp_specs(d: int, ff: int, kind: str, dtype, lead=()):
    """:func:`init_mlp`'s leaves (stacked on ``lead``) as ``meta``
    tensors."""
    f = lambda *sh: spec((*lead, *sh), dtype)
    p = {"wu": f(d, ff), "wd": f(ff, d)}
    if kind == "swiglu":
        p["wg"] = f(d, ff)
    return p


def mlp(p, x, cfg: ModelConfig, *, lora=None, kind=None, specs=None):
    """The config's MLP, or ``kind`` ("swiglu" | "gelu") when given (the
    MoE family's dense layers and shared experts are SwiGLU). In the
    production layout (``specs`` given) ``wg``/``wu`` give the rank's
    columns of h and ``wd`` sums them (or, stored split on N, gathers h
    and its output)."""
    lo = lora or {}
    if specs is not None:
        rt = rt_lib.get_runtime()
        lin = lambda inp, n, **kw: tp_linear(inp, p[n], lo.get(n), specs[n],
                                             cfg, rt, **kw)
        if (kind or cfg.mlp) == "swiglu":
            gt, split = lin(x, "wg", gather=False)
            h = F.silu(gt) * lin(x, "wu", gather=False)[0]
        else:
            up, split = lin(x, "wu", gather=False)
            h = F.gelu(up, approximate="tanh")
        return lin(h, "wd", x_split=split)[0]
    if (kind or cfg.mlp) == "swiglu":
        h = F.silu(linear(x, p["wg"], lo.get("wg"), cfg=cfg)) * \
            linear(x, p["wu"], lo.get("wu"), cfg=cfg)
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(linear(x, p["wu"], lo.get("wu"), cfg=cfg),
                   approximate="tanh")
    return linear(h, p["wd"], lo.get("wd"), cfg=cfg)
