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
which gives the same numbers. Under a Runtime whose model axis divides
the LRU width and the 16 gate blocks (and whose dp axes divide the
batch), ``rglru_block`` runs the JAX package's width-parallel body on
each rank: its w / m channels and 16 / m gate blocks, the output
projection's partial summed over ``model`` (reduce-scattered back to
sequence shards with ``cfg.seq_shard``), checkpointed inside the body.
With ``cfg.calibrate`` (the dry run's cost calibration) the recurrence
is ``chunked_linear_scan`` in one chunk of the whole sequence, as in the
JAX package. ``rglru_specs`` and ``rglru_cache_specs`` give the dry
run's shapes as ``meta`` tensors. In the production layout the block's
leaves arrive as the rank's blocks (``shardings.rank_params``) and the
body takes them as they are, and ``rglru_decode`` runs on the rank's
channels of the weights and of the cache's ``h`` and ``conv``, as
``models.ssm``'s Mamba block does. Where the model axis divides the LRU
width but not the 16 gate blocks (m = 5 at width 320), the cache's state
is still cut over ``model`` (``shardings.rank_cache``): the decode
gathers the rank's ``h`` and ``conv`` whole, steps on the whole weights
and writes back the rank's block (``rglru_decode_gather``), the JAX
package's GSPMD decode on that cut.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch import spec
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import maybe_dequantize
from repro_torch.models import runtime as rt_lib
from repro_torch.models.layers import _normal
from repro_torch.models.runtime import P
from repro_torch.models.ssm import _causal_conv, _lora_delta, \
    body_weights, chunked_linear_scan

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


def rglru_specs(cfg: ModelConfig, dtype, lead=()):
    """:func:`init_rglru`'s leaves (stacked on ``lead``) as ``meta``
    tensors."""
    d, w, K = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.ssm_conv
    gb = GATE_BLOCKS
    wb = w // gb
    f = lambda *sh, dt=dtype: spec((*lead, *sh), dt)
    return {"wx": f(d, w), "wy": f(d, w), "conv_w": f(K, w),
            "w_rg": f(gb, wb, wb), "w_ig": f(gb, wb, wb),
            "lam": f(w, dt=torch.float32), "out_proj": f(w, d)}


def rglru_partition_specs(cfg: ModelConfig, tp_axis="model", lead=()):
    nl = (None,) * len(lead)
    return {"wx": P(*nl, None, tp_axis), "wy": P(*nl, None, tp_axis),
            "conv_w": P(*nl, None, tp_axis),
            "w_rg": P(*nl, tp_axis, None, None),
            "w_ig": P(*nl, tp_axis, None, None),
            "lam": P(*nl, tp_axis), "out_proj": P(*nl, tp_axis, None)}


def rglru_cache_init(cfg: ModelConfig, batch: int, dtype, device):
    """An empty decode cache: the state ``h`` (B, w) in fp32 and the conv
    window's last K - 1 inputs ``conv`` (B, K - 1, w) in the model
    dtype."""
    w, K = cfg.lru_width or cfg.d_model, cfg.ssm_conv
    return {"h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, K - 1, w), dtype=dtype,
                                device=device)}


def rglru_cache_specs(cfg: ModelConfig, batch: int, dtype, lead=()):
    """:func:`rglru_cache_init`'s leaves (stacked on ``lead``) as
    ``meta`` tensors."""
    w, K = cfg.lru_width or cfg.d_model, cfg.ssm_conv
    return {"h": spec((*lead, batch, w)),
            "conv": spec((*lead, batch, K - 1, w), dtype)}


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


def _out(p, y, lo, cfg, sl=None):
    out = y @ p["out_proj"].to(y.dtype)
    pair = lo.get("out_proj")
    if pair is not None:
        a = pair["a"] if sl is None else pair["a"].narrow(0, *sl)
        h = y.to(a.dtype) @ a
        out = out + ((h @ pair["b"]) * (cfg.lora_alpha / cfg.lora_rank)
                     ).to(y.dtype)
    return out


def _rglru_core(p, x, cfg: ModelConfig, h0, lo, *, shard=None):
    """x: (B, S, d) -> (out, cache) with dense block weights ``p``; with
    ``shard=(r, m)`` the weights are rank r's w / m channels and the output
    is a partial sum over the model axis."""
    B, S, _ = x.shape
    dtype = x.dtype
    alpha, rank = cfg.lora_alpha, cfg.lora_rank
    w = p["wx"].shape[-1]
    sl = None if shard is None else (shard[0] * w, w)
    gate = F.gelu(x @ p["wy"].to(dtype) +
                  _lora_delta(x, lo.get("wy"), alpha, rank, sl),
                  approximate="tanh")
    val = x @ p["wx"].to(dtype) + _lora_delta(x, lo.get("wx"), alpha, rank,
                                              sl)
    xc = _causal_conv(p["conv_w"], val, dtype)
    a, b = _gates(p, xc)
    if h0 is None:
        h0 = torch.zeros((B, w), dtype=torch.float32, device=x.device)
    with torch.profiler.record_function("rglru.scan"):
        h_all, h_last = chunked_linear_scan(
            a, b, h0, S if cfg.calibrate else cfg.scan_chunk)
    y = h_all.to(dtype) * gate
    K = cfg.ssm_conv
    tail = val[:, -(K - 1):, :] if S >= K - 1 else \
        F.pad(val, (0, 0, K - 1 - S, 0))
    return _out(p, y, lo, cfg, sl), {"h": h_last, "conv": tail}


def _block_params(p):
    with torch.profiler.record_function("rglru.dequantize"):
        out = {k: maybe_dequantize(p[k]) for k in BLOCK_WEIGHTS}
    out["conv_w"], out["lam"] = p["conv_w"], p["lam"]
    return out


def _rglru_dist(p, x, cfg: ModelConfig, lo, h0, rt, held=False):
    """The width-parallel body on each rank (``shard_map`` over the LRU
    width), as ``models.ssm._mamba_dist``: the rank's channels and gate
    blocks, the output's partial summed over ``model`` (reduce-scattered
    to sequence shards with ``cfg.seq_shard``), checkpointed inside.
    ``held``: ``p`` is the rank's blocks already."""
    B, S, _ = x.shape
    m, tp, dp = rt.tp_size, rt.tp_axis, rt.dp_axes
    pspec = rglru_partition_specs(cfg, tp)
    seq_out = tp if (cfg.seq_shard and S % m == 0 and S > 1) else None
    names = sorted(pspec)
    lo = {k: v for k, v in lo.items() if k in ("wx", "wy", "out_proj")}
    lo_names = sorted(lo)
    x_l = rt_lib.shard_in(x, P(dp, seq_out, None), rt)
    p_l = [p[k] if held else rt_lib.shard_in(p[k], pspec[k], rt)
           for k in names]
    lo_l = [rt_lib.shard_in(lo[k][f], P(), rt) for k in lo_names
            for f in ("a", "b")]
    h0_l = None if h0 is None else rt_lib.shard_in(h0, P(dp, tp), rt)
    r = rt.index(tp)

    def body(x_l, h0_l, *flat):
        pl = dict(zip(names, flat[:len(names)]))
        ll = {k: {"a": flat[len(names) + 2 * i],
                  "b": flat[len(names) + 2 * i + 1]}
              for i, k in enumerate(lo_names)}
        if seq_out:
            x_l = rt_lib.all_gather(x_l, tp, rt, dim=1)
        out, cache = _rglru_core(pl, x_l, cfg, h0_l, ll, shard=(r, m))
        if seq_out:
            out = rt_lib.psum_scatter(out, tp, rt, dim=1)
        else:
            out = rt_lib.psum(out, tp, rt)
        return out, cache["h"], cache["conv"]

    args = (x_l, h0_l, *p_l, *lo_l)
    if torch.is_grad_enabled():
        out, h, conv = checkpoint(body, *args, use_reentrant=False)
    else:
        out, h, conv = body(*args)
    return (rt_lib.shard_out(out, P(dp, seq_out, None), rt),
            {"h": rt_lib.shard_out(h, P(dp, tp), rt),
             "conv": rt_lib.shard_out(conv, P(dp, None, tp), rt)})


def _body_ok(cfg: ModelConfig, m: int) -> bool:
    w = cfg.lru_width or cfg.d_model
    return w % m == 0 and GATE_BLOCKS % m == 0


def rglru_block(p, x, cfg: ModelConfig, *, lora=None, h0=None, specs=None):
    """x: (B, S, d) -> (y (B, S, d), cache {"h": h_last, "conv": tail}).
    ``specs``: the leaves' specs in the production layout, whose blocks
    the body takes as they are (``ssm.body_weights``)."""
    p, lo = _block_params(p), lora or {}
    rt = rt_lib.get_runtime()
    if rt is None:
        return _rglru_core(p, x, cfg, h0, lo)
    held = specs is not None
    if not _body_ok(cfg, rt.tp_size) or x.shape[0] % rt.dp_size:
        rt_lib.dist_trace("rglru_block_fallback")
        if held:
            p = body_weights(p, specs, None, rt)
        return _rglru_core(p, x, cfg, h0, lo)
    rt_lib.dist_trace("rglru_block_dist")
    if held:
        p = body_weights(p, specs, rglru_partition_specs(cfg, rt.tp_axis),
                         rt)
    return _rglru_dist(p, x, cfg, lo, h0, rt, held=held)


def rglru_decode(p, x, cache, cfg: ModelConfig, *, lora=None, specs=None):
    """One token, port of ``repro.models.rglru.rglru_decode``: x (B, 1,
    d) -> (y (B, 1, d), {"h", "conv"}); the conv runs over ``cat(conv,
    val)`` and the state steps ``h = a·h + b`` in fp32. In the
    production layout (``specs`` given) the rank's channels and gate
    blocks of the weights and of ``cache``, the output's partials summed
    over ``model``."""
    p, lo = _block_params(p), lora or {}
    rt = rt_lib.get_runtime()
    if rt is None or specs is None:
        return _rglru_decode_core(p, x, cache, cfg, lo)
    if not _body_ok(cfg, rt.tp_size):
        if (cfg.lru_width or cfg.d_model) % rt.tp_size == 0:
            return _rglru_decode_gather(p, x, cache, cfg, lo, specs, rt)
        rt_lib.dist_trace("rglru_decode_fallback")
        return _rglru_decode_core(body_weights(p, specs, None, rt), x,
                                  cache, cfg, lo)
    rt_lib.dist_trace("rglru_decode_dist")
    p = body_weights(p, specs, rglru_partition_specs(cfg, rt.tp_axis), rt)
    out, st = _rglru_decode_core(p, x, cache, cfg, lo,
                                 sl_rank=rt.index(rt.tp_axis))
    return rt_lib.psum(out, rt.tp_axis, rt), st


def _rglru_decode_gather(p, x, cache, cfg: ModelConfig, lo, specs, rt):
    """The decode where ``model`` cuts the state's channels but not the
    gate blocks: the rank's ``h`` (B, w / m) and ``conv`` (B, K - 1, w /
    m) gathered whole at use, the step on the whole weights (the output
    whole on every rank), the rank's block of the new state returned, cut
    as ``shardings.rank_cache`` cuts it."""
    rt_lib.dist_trace("rglru_decode_gather")
    tp = rt.tp_axis
    whole = {"h": rt_lib.gather_at_use(cache["h"], P(None, tp), rt, "h"),
             "conv": rt_lib.gather_at_use(cache["conv"], P(None, None, tp),
                                          rt, "conv")}
    out, st = _rglru_decode_core(body_weights(p, specs, None, rt), x, whole,
                                 cfg, lo)
    wl, r = cache["h"].shape[-1], rt.index(tp)
    return out, {k: v.narrow(-1, r * wl, wl) for k, v in st.items()}


def _rglru_decode_core(p, x, cache, cfg: ModelConfig, lo, sl_rank=None):
    """:func:`rglru_decode` on dense weights; with ``sl_rank`` the weights
    are that rank's channels and the output a partial sum."""
    dtype = x.dtype
    alpha, rank = cfg.lora_alpha, cfg.lora_rank
    w = p["wx"].shape[-1]
    sl = None if sl_rank is None else (sl_rank * w, w)
    x0 = x[:, 0]
    gate = F.gelu(x0 @ p["wy"].to(dtype) +
                  _lora_delta(x0, lo.get("wy"), alpha, rank, sl),
                  approximate="tanh")
    val = x0 @ p["wx"].to(dtype) + _lora_delta(x0, lo.get("wx"), alpha,
                                               rank, sl)
    window = torch.cat([cache["conv"],
                        val[:, None, :].to(cache["conv"].dtype)], 1)
    xc = torch.einsum("bkd,kd->bd", window.to(dtype), p["conv_w"].to(dtype))
    a, b = _gates(p, xc)
    h = a * cache["h"] + b
    y = h.to(dtype) * gate
    return _out(p, y, lo, cfg, sl)[:, None, :], {"h": h,
                                                "conv": window[:, 1:, :]}
