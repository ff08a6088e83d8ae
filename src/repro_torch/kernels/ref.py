"""Plain PyTorch versions of the CUDA kernels, port of ``repro.kernels.ref``.

Each function here is the CPU path of its op (``kernels.ops``) and the
oracle its CUDA kernel is held against on the card. They repeat the
kernels' arithmetic in plain tensor ops and are no yardstick of speed.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import quant as qlib

NEG_INF = -1e30


# ------------------------------------------------------------------
# flash attention (causal / sliding-window / bidirectional), GQA-aware
# ------------------------------------------------------------------
def attention_probs(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                    window=None) -> torch.Tensor:
    """The masked ``softmax(QKᵀ/√D)`` of :func:`flash_attention` in fp32,
    ``(B, H, S, Skv)``, with kv head ``h // (H / Hkv)`` for query head h:
    masked keys carry probability 0 and a row with no valid key is all 0
    (``l`` floors at 1e-30), as in the Pallas kernel."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qf = q.to(torch.float32) * (1.0 / math.sqrt(D))
    kf = k.to(torch.float32).repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    return p / p.sum(-1, keepdim=True).clamp_min(1e-30)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Skv, Hkv, D) -> (B, S, H, D).

    Masked softmax(QK^T/sqrt(D))V in fp32 with the Pallas kernel's
    conventions (``kernels/flash_attention.py``, :func:`attention_probs`).
    On every row with at least one valid key this equals
    ``repro.kernels.ref.flash_attention``."""
    p = attention_probs(q, k, causal=causal, window=window)
    vf = v.to(torch.float32).repeat_interleave(q.shape[2] // v.shape[2],
                                               dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


# ------------------------------------------------------------------
# single-token attention against a ring KV cache (serving decode)
# ------------------------------------------------------------------
def _decode_scores(q, k_cache, slot_pos):
    """The masked scores ``(B, Hkv, G, M)`` in fp32 of one query token
    against the cache, query head h on kv head ``h // G``; empty slots
    (``slot_pos < 0``) hold NEG_INF."""
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, H // Hkv, D).to(torch.float32) * scale
    s = torch.einsum("bkgd,bpkd->bkgp", qg, k_cache.to(torch.float32))
    valid = (slot_pos >= 0)[:, None, None, :]
    return torch.where(valid, s, NEG_INF), valid


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor,
                             slot_pos: torch.Tensor) -> tuple:
    """Flash-decoding statistics ``(m, l, acc)`` over a slice of the cache
    slots, port of ``repro.kernels.ref.decode_attention_partial``: the
    running max ``m (B, Hkv, G)``, the sum ``l`` of ``exp(s - m)`` over
    the valid slots and ``acc (B, Hkv, G, D)``, their weighted sum of V,
    all fp32. Shapes as in :func:`decode_attention`, with any slot count;
    ``kernels.ops.combine_decode_partials`` merges slices."""
    s, valid = _decode_scores(q, k_cache, slot_pos)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkgp,bpkd->bkgd", p, v_cache.to(torch.float32))
    return m, p.sum(-1), acc


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     slot_pos: torch.Tensor) -> torch.Tensor:
    """One query token against a (ring-)cache, port of
    ``repro.kernels.ref.decode_attention``.

    q: (B, 1, H, D); caches: (B, M, Hkv, D) with H = G·Hkv (GQA);
    slot_pos: (B or 1, M) int, the absolute position held in each slot,
    -1 for an empty one. Keys are stored already position-encoded, so
    only the empty slots are masked. The softmax is fp32; the output
    (B, 1, H, D) has q's dtype. A row whose slots are all empty averages
    V uniformly, as ``jax.nn.softmax`` over all NEG_INF does."""
    B, _, H, D = q.shape
    s, _ = _decode_scores(q, k_cache, slot_pos)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgp,bpkd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)


# ------------------------------------------------------------------
# fused dequant-matmul (QLoRA backbone / serve-head hot path)
# ------------------------------------------------------------------
def quant_matmul(x: torch.Tensor, qt: qlib.QTensor) -> torch.Tensor:
    """x: (..., K) @ dequant(qt): (K, N) -> (..., N).

    ``qt`` may cover a K zero-padded to a block multiple (the odd-K
    ``blockwise_quant`` contract); x's contraction dim zero-pads to
    match. A stacked QTensor (q ``(T, G, ., N)``) contracts pairwise along
    the stack axis: x is ``(T, K)`` or ``(T, ..., K)``."""
    w = qlib.dequantize(qt, x.dtype)
    Kq, K = w.shape[-2], x.shape[-1]
    if Kq != K:
        if Kq < K or (Kq - K) >= qt.block:
            raise ValueError(
                f"quantized contraction dim {Kq} incompatible with "
                f"x's {K} (block {qt.block})")
        x = F.pad(x, (0, Kq - K))
    if w.ndim > 2:
        lead = tuple(w.shape[:-2])
        if tuple(x.shape[:len(lead)]) != lead:
            raise ValueError(
                f"stacked quant_matmul needs matching lead dims: x "
                f"{tuple(x.shape)} vs dequant(qt) {tuple(w.shape)}")
        mid = tuple(x.shape[len(lead):-1])
        x3 = x.reshape(*lead, -1, Kq)
        return torch.matmul(x3, w).reshape(*lead, *mid, w.shape[-1])
    return torch.matmul(x, w)


# ------------------------------------------------------------------
# fused LoRA matmul (the QLoRA arm's whole linear layer)
# ------------------------------------------------------------------
def lora_matmul(x: torch.Tensor, w, a: torch.Tensor, b: torch.Tensor, *,
                scale: float) -> torch.Tensor:
    """``y = x @ W(+dequant) + scale·(x@A)@B`` with fp32 accumulation,
    cast back to ``x.dtype``. ``w`` may be a QTensor or a dense matrix.
    ``a``/``b`` may carry a leading batch axis matching x's (one LoRA
    pair per row of a stacked tenant batch)."""
    xf = x.to(torch.float32)
    if isinstance(w, qlib.QTensor):
        base = quant_matmul(xf, w)
    else:
        base = torch.matmul(xf, w.to(torch.float32))
    h = torch.matmul(xf, a.to(torch.float32))
    delta = torch.matmul(h, b.to(torch.float32))
    return (base + scale * delta).to(x.dtype)


def quant_matmul_t(g: torch.Tensor, qt: qlib.QTensor, *,
                   out_dtype: torch.dtype = None) -> torch.Tensor:
    """``g (..., N) @ dequant(qt (Kq, N))ᵀ -> (..., Kq)`` in fp32, cast
    to ``out_dtype`` (default ``g.dtype``): the dx gemm of the LoRA VJP.
    The output covers the padded Kq (the odd-K contract); callers slice
    ``[..., :K]``."""
    if qt.q.ndim != 3:
        raise ValueError(f"quant_matmul_t takes one 2-D weight, got q "
                         f"{tuple(qt.q.shape)}")
    if g.shape[-1] != qt.q.shape[-1]:
        raise ValueError(f"contraction dim {g.shape[-1]} != quantized N "
                         f"{qt.q.shape[-1]}")
    w = qlib.dequantize(qt, torch.float32)
    return torch.matmul(g.to(torch.float32), w.t()).to(
        g.dtype if out_dtype is None else out_dtype)


# ------------------------------------------------------------------
# blockwise quantization (at-rest adapters, communication compression)
# ------------------------------------------------------------------
def blockwise_quant(x: torch.Tensor, *, bits: int = 8, block: int = 128,
                    mode: str = "linear") -> qlib.QTensor:
    """Same contract as the kernel, including odd K: a contraction dim
    not divisible by the block zero-pads to the next block multiple (pad
    rows never perturb a block's absmax scale), the payload covers the
    padded K, and ``orig_shape`` records the true shape."""
    *lead, K, N = x.shape
    blk = min(block, K)
    Kp = -(-K // blk) * blk
    if Kp == K:
        return qlib.quantize(x, bits=bits, block=block, mode=mode)
    qt = qlib.quantize(F.pad(x, (0, 0, 0, Kp - K)), bits=bits,
                       block=block, mode=mode)
    return dataclasses.replace(qt, orig_shape=tuple(x.shape))


# ------------------------------------------------------------------
# selective scan (Mamba-1 recurrence) — naive sequential oracle
# ------------------------------------------------------------------
def selective_scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor) -> tuple:
    """dt, x: (B, S, di); Bm, Cm: (B, S, N); A: (di, N); all fp32.
    ``h_t = exp(dt_t ⊗ A) ∘ h_{t-1} + (dt_t x_t) ⊗ B_t`` from h0 = 0 and
    ``y_t = ⟨h_t, C_t⟩``, one time step at a time. Returns
    ``(y (B, S, di), h_last (B, di, N))``."""
    B, S, di = x.shape
    h = torch.zeros((B, di, A.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h
