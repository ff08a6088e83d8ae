"""Attention-based adapter (paper §III-A), port of ``repro.core.adapter``.

    Att(D)   = softmax(Q K^T / sqrt(dh)) V
    F_net(a) = ReLU(W1 a + b1) W2 + b2
    CLIP_adapted(D) = Adapter(CLIP_pre(D))

One multi-head attention plus a 2-layer ReLU FFN on top of the frozen
backbone's hidden states, with residuals (wo/W2 zero-init). ``apply`` is
differentiable: a decoder LM runs it causally over the whole sequence,
and its Att(D) takes the flash-attention op's gradient.
``apply_stacked`` is the same function for a cohort of clients, each
with its own adapter: the projections are batched matmuls and the
attention folds the cohort into the batch (one flash-attention launch).
``prefill`` and ``decode`` are the serving path over a ring KV cache;
``specs`` and ``cache_specs`` give the dry run's shapes as ``meta``
tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device, spec
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


def specs(d: int, *, d_ff: int = 0, dtype=torch.float32):
    """:func:`init`'s leaves as ``meta`` tensors."""
    d_ff = d_ff or d
    f = lambda *sh: spec(sh, dtype)
    return {"wq": f(d, d), "wk": f(d, d), "wv": f(d, d), "wo": f(d, d),
            "w1": f(d, d_ff), "b1": f(d_ff), "w2": f(d_ff, d), "b2": f(d)}


def cache_specs(d: int, batch: int, window: int, dtype, *,
                n_heads: int = 8):
    """The ring cache of :func:`prefill` as ``meta`` tensors."""
    sh = (batch, window, n_heads, d // n_heads)
    return {"k": spec(sh, dtype), "v": spec(sh, dtype),
            "slot_pos": spec((window,), torch.int32)}


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
    return _ffn(params, x + a @ params["wo"].to(dt), dt)


def apply_stacked(params, x: torch.Tensor, *, n_heads: int = 8,
                  causal: bool = True) -> torch.Tensor:
    """:func:`apply` for C clients at once: every leaf of ``params``
    carries a leading client axis, and x is (C, B, S, d) -> (C, B, S, d).
    Client c's rows meet only client c's weights; Att(D) runs once over
    the (C·B, S, heads, d/heads) fold of the cohort."""
    C, B, S, d = x.shape
    dh = d // n_heads
    dt = x.dtype
    xf = x.reshape(C, B * S, d)

    def mm(h, w):
        return torch.matmul(h, w.to(dt))

    def proj(w):
        return mm(xf, w).reshape(C * B, S, n_heads, dh)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    a = kops.flash_attention(q, k, v, causal=causal and S > 1)
    xf = xf + mm(a.reshape(C, B * S, d), params["wo"])
    h = torch.relu(mm(xf, params["w1"]) + params["b1"].to(dt)[:, None])
    out = xf + mm(h, params["w2"]) + params["b2"].to(dt)[:, None]
    return out.reshape(C, B, S, d)


def _ffn(params, x, dt):
    h = torch.relu(x @ params["w1"].to(dt) + params["b1"].to(dt))
    return x + h @ params["w2"].to(dt) + params["b2"].to(dt)


def prefill(params, x: torch.Tensor, window: int, *, n_heads: int = 8):
    """Port of ``repro.core.adapter.prefill``: the adapter's output for
    the LAST position plus a ring KV cache of ``window`` slots over the
    final ``min(S, window)`` positions (empty slots when window > S), so
    decoding stays windowed. x: (B, S, d) -> ((B, 1, d), cache). The
    cache is whole; under a Runtime the model holds the rank's block of
    its slots (the split-KV attention here reads the whole ring on every
    rank, whose combine is its own value)."""
    from repro_torch.models import layers as mlayers
    B, S, d = x.shape
    dh = d // n_heads
    dt = x.dtype
    k = (x @ params["wk"].to(dt)).reshape(B, S, n_heads, dh)
    v = (x @ params["wv"].to(dt)).reshape(B, S, n_heads, dh)
    cache = mlayers.ring_from_full(k, v, window)
    last = x[:, -1:]
    q = (last @ params["wq"].to(dt)).reshape(B, 1, n_heads, dh)
    a = kops.decode_attention(q, cache["k"], cache["v"],
                              cache["slot_pos"][None]).reshape(B, 1, d)
    y = last + a @ params["wo"].to(dt)
    return _ffn(params, y, dt), cache


def decode(params, x: torch.Tensor, cache, pos, *, n_heads: int = 8,
           slots_cut: bool = True):
    """Port of ``repro.core.adapter.decode``: one token x (B, 1, d) at
    the absolute position ``pos`` (a 0-d integer tensor on x's device)
    against the ring cache. Its k/v row and ``slot_pos`` entry are
    written into slot ``pos % M`` in place with device ops; returns
    ``(out, cache)``, the same dict. Under a Runtime ``cache`` is the
    rank's block of slots, or the whole ring where ``slots_cut`` is False
    (``models.layers.ring_write``)."""
    from repro_torch.models import layers as mlayers
    from repro_torch.models import runtime as rt_lib
    B, _, d = x.shape
    dh = d // n_heads
    dt = x.dtype

    def proj(w):
        return (x @ params[w].to(dt)).reshape(B, 1, n_heads, dh)

    q = proj("wq")
    rt = rt_lib.get_runtime()
    for name in ("k", "v"):
        mlayers.ring_write(cache[name], 1, pos, proj("w" + name).to(
            cache[name].dtype), rt, slots_cut)
    mlayers.ring_write(cache["slot_pos"], 0, pos,
                       pos.reshape(1).to(torch.int32), rt, slots_cut)
    a = kops.decode_attention(q, cache["k"].to(dt), cache["v"].to(dt),
                              cache["slot_pos"][None],
                              slots_cut=slots_cut).reshape(B, 1, d)
    y = x + a @ params["wo"].to(dt)
    return _ffn(params, y, dt), cache
