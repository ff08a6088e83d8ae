"""Attention-based adapter (paper §III-A), port of ``repro.core.adapter``.

    Att(D)   = softmax(Q K^T / sqrt(dh)) V
    F_net(a) = ReLU(W1 a + b1) W2 + b2
    CLIP_adapted(D) = Adapter(CLIP_pre(D))

One multi-head attention plus a 2-layer ReLU FFN on top of the frozen
backbone's hidden states, with residuals (wo/W2 zero-init). ``apply`` is
differentiable: a decoder LM runs it causally over the whole sequence,
and its Att(D) takes the flash-attention op's gradient. ``prefill`` and
``decode`` are not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops


def init(generator: torch.Generator, d: int, *, n_heads: int = 8,
         d_ff: int = 0, dtype=torch.float32, device=None):
    dev = resolve_device(device)
    d_ff = d_ff or d
    s = 1.0 / math.sqrt(d)

    def normal(*shape):
        return (torch.randn(shape, generator=generator, dtype=dtype,
                            device=generator.device) * s).to(dev)

    return {
        "wq": normal(d, d), "wk": normal(d, d), "wv": normal(d, d),
        "wo": torch.zeros((d, d), dtype=dtype, device=dev),
        "w1": normal(d, d_ff),
        "b1": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w2": torch.zeros((d_ff, d), dtype=dtype, device=dev),
        "b2": torch.zeros((d,), dtype=dtype, device=dev),
    }


def apply(params, x: torch.Tensor, *, n_heads: int = 8,
          causal: bool = True) -> torch.Tensor:
    """x: (B, S, d) hidden states -> (B, S, d). Att(D) runs through the
    flash-attention op (the CUDA kernel on the card; head dim d / n_heads,
    512 at Yi-9B width)."""
    B, S, d = x.shape
    dh = d // n_heads
    dt = x.dtype

    def proj(w):
        return (x @ w.to(dt)).reshape(B, S, n_heads, dh)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    a = kops.flash_attention(q, k, v, causal=causal and S > 1)
    a = a.reshape(B, S, d)
    x = x + a @ params["wo"].to(dt)
    h = torch.relu(x @ params["w1"].to(dt) + params["b1"].to(dt))
    return x + h @ params["w2"].to(dt) + params["b2"].to(dt)
