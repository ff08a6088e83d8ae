"""The RG-LRU recurrent block (RecurrentGemma / Griffin), port of
``repro.models.rglru`` on one device.

Recurrence (per channel): a_t = exp(c · log σ(Λ) · r_t),
h_t = a_t h_{t-1} + sqrt(1 − a_t²) · (i_t ⊙ x_t), with the recurrence
gate r_t and the input gate i_t from block-diagonal matrices (16 blocks,
one per head). ``rglru_block`` is the JAX package's path without a
Runtime: the projections are plain products in the model dtype (their
LoRA deltas einsums, as in the JAX package, not the fused LoRA kernel),
the depthwise causal conv is ``models.ssm._causal_conv``, the gates and
the recurrence run in fp32, the recurrence through
``models.ssm.chunked_linear_scan`` (plain in both packages). Profiler
ranges name the weights' decode (``rglru.dequantize``) and the scan
(``rglru.scan``).

A hybrid layer's dict holds the attention and MLP weights beside the
block's; only the block's quantized leaves are decoded (the JAX package
decodes the whole dict and XLA drops the unused decodes under ``jit``),
which gives the same numbers. The sharded path (``shard_map`` over the
LRU width) and ``cfg.calibrate`` come with the mesh and the dry run
(ROADMAP Queue A item 8.5).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import maybe_dequantize
from repro_torch.models.layers import _normal
from repro_torch.models.ssm import _causal_conv, _lora_delta, \
    chunked_linear_scan

_C = 8.0
GATE_BLOCKS = 16  # block-diagonal gate heads (w % 16 == 0 for all configs)
# the leaves of a layer dict that the block reads as matrices
BLOCK_WEIGHTS = ("wx", "wy", "w_rg", "w_ig", "out_proj")


def init_rglru(generator, cfg: ModelConfig, dtype, device):
    d, w, K = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.ssm_conv
    gb = GATE_BLOCKS
    wb = w // gb
    n = _normal
    return {
        "wx": n(generator, (d, w), d, dtype, device),
        "wy": n(generator, (d, w), d, dtype, device),
        "conv_w": n(generator, (K, w), K, dtype, device),
        "w_rg": n(generator, (gb, wb, wb), wb, dtype, device),
        "w_ig": n(generator, (gb, wb, wb), wb, dtype, device),
        "lam": torch.full((w,), 2.0, dtype=torch.float32, device=device),
        "out_proj": n(generator, (w, d), w, dtype, device),
    }


def rglru_cache_init(cfg: ModelConfig, batch: int, dtype, device):
    """An empty decode cache: the state ``h`` (B, w) in fp32 and the conv
    window's last K - 1 inputs ``conv`` (B, K - 1, w) in the model
    dtype."""
    w, K = cfg.lru_width or cfg.d_model, cfg.ssm_conv
    return {"h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, K - 1, w), dtype=dtype,
                                device=device)}


def _block_gate(wm, x32):
    """Block-diagonal matmul: x (..., gb·wb) × wm (gb, wb, wb), fp32."""
    gb, wb, _ = wm.shape
    xs = x32.reshape(*x32.shape[:-1], gb, wb)
    return torch.einsum("...gw,gwv->...gv", xs,
                        wm.to(torch.float32)).reshape(x32.shape)


def _gates(p, xc):
    """(a_t, b_t) of the recurrence from the post-conv activations, fp32."""
    x32 = xc.to(torch.float32)
    r = torch.sigmoid(_block_gate(p["w_rg"], x32))
    i = torch.sigmoid(_block_gate(p["w_ig"], x32))
    log_a = _C * r * F.logsigmoid(p["lam"])
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x32)
    return a, b


def _out(p, y, lo, cfg):
    out = y @ p["out_proj"].to(y.dtype)
    if lo.get("out_proj") is not None:
        out = out + _lora_delta(y, lo["out_proj"], cfg.lora_alpha,
                                cfg.lora_rank)
    return out


def _rglru_core(p, x, cfg: ModelConfig, h0, lo):
    """x: (B, S, d) -> (out, cache) with dense block weights ``p``."""
    B, S, _ = x.shape
    dtype = x.dtype
    alpha, rank = cfg.lora_alpha, cfg.lora_rank
    w = p["wx"].shape[-1]
    gate = F.gelu(x @ p["wy"].to(dtype) +
                  _lora_delta(x, lo.get("wy"), alpha, rank),
                  approximate="tanh")
    val = x @ p["wx"].to(dtype) + _lora_delta(x, lo.get("wx"), alpha, rank)
    xc = _causal_conv(p["conv_w"], val, dtype)
    a, b = _gates(p, xc)
    if h0 is None:
        h0 = torch.zeros((B, w), dtype=torch.float32, device=x.device)
    with torch.profiler.record_function("rglru.scan"):
        h_all, h_last = chunked_linear_scan(a, b, h0, cfg.scan_chunk)
    y = h_all.to(dtype) * gate
    K = cfg.ssm_conv
    tail = val[:, -(K - 1):, :] if S >= K - 1 else \
        F.pad(val, (0, 0, K - 1 - S, 0))
    return _out(p, y, lo, cfg), {"h": h_last, "conv": tail}


def _block_params(p):
    with torch.profiler.record_function("rglru.dequantize"):
        out = {k: maybe_dequantize(p[k]) for k in BLOCK_WEIGHTS}
    out["conv_w"], out["lam"] = p["conv_w"], p["lam"]
    return out


def rglru_block(p, x, cfg: ModelConfig, *, lora=None, h0=None):
    """x: (B, S, d) -> (y (B, S, d), cache {"h": h_last, "conv": tail})."""
    if cfg.calibrate:
        raise NotImplementedError(
            "cfg.calibrate (the dry run's single-chunk scan) is not ported "
            "yet; it comes with the dry run (ROADMAP Queue A item 8.5)")
    return _rglru_core(_block_params(p), x, cfg, h0, lora or {})


def rglru_decode(p, x, cache, cfg: ModelConfig, *, lora=None):
    """One token, port of ``repro.models.rglru.rglru_decode``: x (B, 1,
    d) -> (y (B, 1, d), {"h", "conv"}); the conv runs over ``cat(conv,
    val)`` and the state steps ``h = a·h + b`` in fp32."""
    p = _block_params(p)
    dtype = x.dtype
    lo = lora or {}
    alpha, rank = cfg.lora_alpha, cfg.lora_rank
    x0 = x[:, 0]
    gate = F.gelu(x0 @ p["wy"].to(dtype) +
                  _lora_delta(x0, lo.get("wy"), alpha, rank),
                  approximate="tanh")
    val = x0 @ p["wx"].to(dtype) + _lora_delta(x0, lo.get("wx"), alpha,
                                               rank)
    window = torch.cat([cache["conv"],
                        val[:, None, :].to(cache["conv"].dtype)], 1)
    xc = torch.einsum("bkd,kd->bd", window.to(dtype), p["conv_w"].to(dtype))
    a, b = _gates(p, xc)
    h = a * cache["h"] + b
    y = h.to(dtype) * gate
    return _out(p, y, lo, cfg)[:, None, :], {"h": h,
                                            "conv": window[:, 1:, :]}
