"""Transformer building blocks for training, port of
``repro.models.layers``: RMS norm, RoPE, GQA attention (causal, sliding
window) and the MLPs.

Weights may be QTensors (the quantized backbone, paper §III-C); every
projection optionally carries a LoRA pair and then runs through the
fused LoRA op. Weights are bias-free. The ring-buffer caches,
``attention_decode`` and the int8 KV quantizer come with the zoo's
serving slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora as lora_lib
from repro_torch.kernels import ops as kops


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.to(torch.float32))
            ).to(x.dtype)


# ------------------------------------------------------------------ rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D) with D even; positions: (S,). In fp32, cast back."""
    D = x.shape[-1]
    half = D // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
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


def _normal(generator, shape, fan_in, dtype, device):
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * (1.0 / math.sqrt(fan_in))).to(device=device, dtype=dtype)


# ------------------------------------------------------------------ attention
def init_attention(generator, cfg: ModelConfig, dtype, device):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"wq": _normal(generator, (d, qd), d, dtype, device),
            "wk": _normal(generator, (d, kvd), d, dtype, device),
            "wv": _normal(generator, (d, kvd), d, dtype, device),
            "wo": _normal(generator, (qd, d), qd, dtype, device)}


def attention(p, x, positions, cfg: ModelConfig, *, lora=None):
    """Full-sequence causal self-attention with RoPE and the config's
    sliding window, if any (train)."""
    B, S, _ = x.shape
    lo = lora or {}
    q = linear(x, p["wq"], lo.get("wq"), cfg=cfg)
    k = linear(x, p["wk"], lo.get("wk"), cfg=cfg)
    v = linear(x, p["wv"], lo.get("wv"), cfg=cfg)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = kops.flash_attention(q, k, v, causal=True, window=cfg.window)
    return linear(out.reshape(B, S, cfg.q_dim), p["wo"], lo.get("wo"),
                  cfg=cfg)


# ------------------------------------------------------------------ mlp
def init_mlp(generator, d: int, ff: int, kind: str, dtype, device):
    p = {"wu": _normal(generator, (d, ff), d, dtype, device),
         "wd": _normal(generator, (ff, d), ff, dtype, device)}
    if kind == "swiglu":
        p["wg"] = _normal(generator, (d, ff), d, dtype, device)
    return p


def mlp(p, x, cfg: ModelConfig, *, lora=None):
    lo = lora or {}
    if cfg.mlp == "swiglu":
        h = F.silu(linear(x, p["wg"], lo.get("wg"), cfg=cfg)) * \
            linear(x, p["wu"], lo.get("wu"), cfg=cfg)
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(linear(x, p["wu"], lo.get("wu"), cfg=cfg),
                   approximate="tanh")
    return linear(h, p["wd"], lo.get("wd"), cfg=cfg)
