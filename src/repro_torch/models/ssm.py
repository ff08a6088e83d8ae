"""The Mamba-1 selective-scan block (falcon-mamba) for training, port of
``repro.models.ssm``.

``mamba_block`` is the JAX package's single-device path (no Runtime, so
no shard_map over d_inner): every QTensor leaf of the layer is
dequantized, the projections are plain products (their LoRA deltas
einsums, as in the JAX package, not the fused LoRA kernel), the
depthwise causal conv is ``F.conv1d`` over a left pad of K - 1, and the
recurrence is ``kernels.ops.selective_scan``: the hand-written CUDA
kernel for a CUDA tensor, the plain time loop on the CPU, where the JAX
package runs its chunked associative scan; the two agree within the
JAX package's ref-vs-chunked bound. The dtype flow is the JAX package's:
x1 and z in the model dtype, the x_proj output, dt and the scan in fp32.
``mamba_block``'s ``{"h", "conv"}`` is the prefill's cache entry;
``mamba_decode`` steps it one token at a time.

``chunked_linear_scan`` is the elementwise recurrence ``h_t = a_t
h_{t-1} + b_t`` that the RG-LRU block runs (:mod:`repro_torch.models.
rglru`): plain PyTorch on every device, as it is plain ``jnp`` in the
JAX package (the ``selective_scan`` kernel computes the Mamba
recurrence, with a state dimension and a C readout, not this one).

A start state ``h0`` runs the recurrence from it in plain PyTorch
(``_scan_from``), as the JAX package takes its chunked scan, not the
kernel, when h0 is given. Under a Runtime whose model axis divides
d_inner (and whose dp axes divide the batch), ``mamba_block`` runs the
JAX package's channel-parallel body on each rank: its d_inner / m
channels of every projection, ``x_proj``'s partial summed over
``model``, the ``selective_scan`` kernel on the rank's channels, the
output projection's partial summed (or reduce-scattered back to
sequence shards with ``cfg.seq_shard``), checkpointed inside the body.
With ``cfg.calibrate`` (the dry run's cost calibration) the block runs
``_chunked_ssm_scan`` in one chunk of the whole sequence in place of the
kernel, as the JAX package takes its chunked scan then: plain PyTorch on
every device, the recurrence's step products counted once each.
``mamba_specs`` and ``mamba_cache_specs`` give the dry run's shapes as
``meta`` tensors.

Under a Runtime (the production layout: the layer's logical ``specs``
given) the layer's leaves arrive as the rank's blocks
(``shardings.rank_params`` cuts them by the same channel rule): the
body takes them as they are (a block held by another spec, the N-split
fallback of a quantized contraction split, is gathered and re-cut:
``runtime.reblock``), and ``mamba_decode`` runs on the rank's
channels of the weights and of the cache's ``h`` and ``conv``, the
``x_proj`` and output partials summed over ``model``. Where the model
axis does not divide d_inner the leaves are gathered whole and the
local path runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch import spec
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import maybe_dequantize
from repro_torch.kernels import ops as kops
from repro_torch.models import runtime as rt_lib
from repro_torch.models.layers import _normal
from repro_torch.models.runtime import P

# ---------------------------------------------------------------- scan util
def _comb(left, right):
    """(a2, b2)∘(a1, b1) = (a1·a2, a2·b1 + b2): the recurrence's step
    composition, associative."""
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _associative_scan(a, b):
    """Inclusive scan of ``_comb`` along axis 1 by doubling (Hillis-
    Steele): after the step of offset o every position holds the
    composition of the up to 2o steps ending at it."""
    n, o = a.shape[1], 1
    while o < n:
        a2, b2 = _comb((a[:, :-o], b[:, :-o]), (a[:, o:], b[:, o:]))
        a = torch.cat([a[:, :o], a2], 1)
        b = torch.cat([b[:, :o], b2], 1)
        o *= 2
    return a, b


def chunked_linear_scan(a, b, h0, chunk: int):
    """Elementwise linear recurrence h_t = a_t·h_{t-1} + b_t, port of
    ``repro.models.ssm.chunked_linear_scan``: a, b (B, S, ...), h0
    (B, ...). Within a chunk an associative scan, across chunks a
    sequential carry; S is padded to a multiple of the chunk with
    identity steps (a = 1, b = 0), sliced off after. Returns (h_all
    (B, S, ...), h_last)."""
    B, S = a.shape[0], a.shape[1]
    chunk = min(chunk, S)
    Sp = -(-S // chunk) * chunk
    if Sp != S:
        pad = [0, 0] * (a.ndim - 2) + [0, Sp - S]
        a = F.pad(a, pad, value=1.0)
        b = F.pad(b, pad)
    h, outs = h0, []
    for c in range(Sp // chunk):
        a_cum, b_scan = _associative_scan(a[:, c * chunk:(c + 1) * chunk],
                                          b[:, c * chunk:(c + 1) * chunk])
        h_full = b_scan + a_cum * h[:, None]
        outs.append(h_full)
        h = h_full[:, -1]
    h_all = torch.cat(outs, 1)[:, :S]
    return h_all, h_all[:, -1]


def _chunked_ssm_scan(dt, A, Bm, Cm, xc, h0, chunk: int):
    """The selective scan chunk by chunk, port of
    ``repro.models.ssm._chunked_ssm_scan``: within a chunk the associative
    scan of ``(exp(dt A), dt x B)``, across chunks the carried state, and
    ``y = (h·C).sum(N)`` per chunk, so the (B, chunk, di, N) states never
    outgrow one chunk. dt, xc (B, S, di); A (di, N); Bm, Cm (B, S, N); h0
    (B, di, N) fp32. S is padded to a multiple of the chunk with dt = 0
    steps (a = 1, b = 0: the state holds), sliced off after. Returns (y
    (B, S, di) fp32, h_last)."""
    S = xc.shape[1]
    chunk = min(chunk, S)
    pad = -(-S // chunk) * chunk - S
    if pad:
        z = lambda t: F.pad(t, (0, 0, 0, pad))
        dt, xc, Bm, Cm = z(dt), z(xc), z(Bm), z(Cm)
    h, ys = h0, []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        dtc = dt[:, sl]
        a = torch.exp(dtc[..., None] * A)                  # (B, L, di, N)
        b = (dtc * xc[:, sl])[..., None] * Bm[:, sl, None, :]
        a_cum, b_scan = _associative_scan(a, b)
        h_full = b_scan + a_cum * h[:, None]
        ys.append(torch.einsum("blen,bln->ble", h_full, Cm[:, sl]))
        h = h_full[:, -1]
    return torch.cat(ys, 1)[:, :S], h


# ---------------------------------------------------------------- params
def init_mamba(generator, cfg: ModelConfig, dtype, device):
    d, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.ssm_conv)
    f32 = torch.float32
    n = _normal
    return {
        "in_proj_x": n(generator, (d, di), d, dtype, device),
        "in_proj_z": n(generator, (d, di), d, dtype, device),
        "conv_w": n(generator, (K, di), K, dtype, device),
        "x_proj": n(generator, (di, R + 2 * N), di, dtype, device),
        "dt_proj": n(generator, (R, di), R, dtype, device),
        "dt_bias": torch.full((di,), -2.0, dtype=f32, device=device),
        "a_log": torch.log(torch.arange(1, N + 1, dtype=f32, device=device)
                           ).expand(di, N).contiguous(),
        "d_skip": torch.ones((di,), dtype=f32, device=device),
        "out_proj": n(generator, (di, d), di, dtype, device),
    }


def mamba_partition_specs(cfg: ModelConfig, tp_axis="model", lead=()):
    """Per-leaf specs: the d_inner dim over the tp axis. Shared by the
    sharding rules and the block's body (they must agree)."""
    nl = (None,) * len(lead)
    return {"in_proj_x": P(*nl, None, tp_axis),
            "in_proj_z": P(*nl, None, tp_axis),
            "conv_w": P(*nl, None, tp_axis),
            "x_proj": P(*nl, tp_axis, None),
            "dt_proj": P(*nl, None, tp_axis),
            "dt_bias": P(*nl, tp_axis),
            "a_log": P(*nl, tp_axis, None),
            "d_skip": P(*nl, tp_axis),
            "out_proj": P(*nl, tp_axis, None)}


def mamba_specs(cfg: ModelConfig, dtype, lead=()):
    """:func:`init_mamba`'s leaves (stacked on ``lead``) as ``meta``
    tensors."""
    d, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.ssm_conv)
    f = lambda *sh, dt=dtype: spec((*lead, *sh), dt)
    f32 = torch.float32
    return {"in_proj_x": f(d, di), "in_proj_z": f(d, di),
            "conv_w": f(K, di), "x_proj": f(di, R + 2 * N),
            "dt_proj": f(R, di), "dt_bias": f(di, dt=f32),
            "a_log": f(di, N, dt=f32), "d_skip": f(di, dt=f32),
            "out_proj": f(di, d)}


def mamba_cache_specs(cfg: ModelConfig, batch: int, dtype, lead=()):
    """:func:`mamba_cache_init`'s leaves (stacked on ``lead``) as
    ``meta`` tensors."""
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"h": spec((*lead, batch, di, N)),
            "conv": spec((*lead, batch, K - 1, di), dtype)}


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype, device):
    """An empty decode cache: the state ``h`` (B, di, N) in fp32 and the
    conv window's last K - 1 inputs ``conv`` (B, K - 1, di) in the model
    dtype."""
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"h": torch.zeros((batch, di, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, K - 1, di), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------- forward
def _causal_conv(conv_w: torch.Tensor, x1: torch.Tensor, dtype):
    """Depthwise causal conv over S. x1: (B, S, di); conv_w: (K, di).
    Both the JAX conv and ``F.conv1d`` are cross-correlations, so the
    (K, di) weight becomes torch's (di, 1, K) without a flip."""
    K, di = conv_w.shape
    w = conv_w.to(dtype).t().unsqueeze(1)
    xp = F.pad(x1.transpose(1, 2), (K - 1, 0))
    return F.conv1d(xp, w, groups=di).transpose(1, 2)


def _lora_delta(x: torch.Tensor, pair, alpha: float, rank: int, sl=None):
    """``(alpha/r)·(x@A)@B`` with ``h`` in the trainable dtype, cast to
    x's dtype; ``sl = (start, width)`` takes B's columns of a channel
    shard."""
    if pair is None:
        return 0.0
    h = x.to(pair["a"].dtype) @ pair["a"]
    b = pair["b"] if sl is None else pair["b"].narrow(1, *sl)
    return ((h @ b) * (alpha / rank)).to(x.dtype)


def _scan_from(dt, x, Bm, Cm, A, h0):
    """The selective scan from a start state ``h0`` (B, di, N), in plain
    PyTorch (fp32): the step ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
    ``y_t = h_t · C_t``. Returns (y (B, S, di), h_last)."""
    h, ys = h0.to(torch.float32), []
    for t in range(dt.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + \
            (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, 1), h


def _mamba_core(p, x: torch.Tensor, cfg: ModelConfig, lo, h0=None, *,
                shard=None, rt=None):
    """x: (B, S, d) -> (out, cache) with dense layer weights ``p``. With
    ``shard=(r, m)`` the weights are rank r's d_inner / m channels and the
    output is a partial sum over the model axis (the caller reduces)."""
    S = x.shape[1]
    dtype = x.dtype
    N, R, K = cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    alpha, rank = cfg.lora_alpha, cfg.lora_rank
    di_l = p["in_proj_x"].shape[-1]
    sl = None if shard is None else (shard[0] * di_l, di_l)

    x1 = x @ p["in_proj_x"].to(dtype) + _lora_delta(
        x, lo.get("in_proj_x"), alpha, rank, sl)
    z = x @ p["in_proj_z"].to(dtype)
    xc = F.silu(_causal_conv(p["conv_w"], x1, dtype))

    proj = (xc @ p["x_proj"].to(dtype)).to(torch.float32)
    if shard is not None:
        proj = rt_lib.psum(proj, rt.tp_axis, rt)
    dt_r, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    xcf = xc.to(torch.float32)
    with torch.profiler.record_function("mamba.scan"):
        if cfg.calibrate:
            if h0 is None:
                h0 = xcf.new_zeros((x.shape[0], di_l, N))
            y, h_last = _chunked_ssm_scan(dt, A, Bm, Cm, xcf, h0, S)
        elif h0 is None:
            y, h_last = kops.selective_scan(dt, xcf, Bm, Cm, A)
        else:
            y, h_last = _scan_from(dt, xcf, Bm, Cm, A, h0)
    y = y + p["d_skip"] * xcf
    y = y.to(dtype) * F.silu(z)
    out = y @ p["out_proj"].to(dtype)
    pair = lo.get("out_proj")
    if pair is not None:
        a = pair["a"] if sl is None else pair["a"].narrow(0, *sl)
        h = y.to(a.dtype) @ a
        out = out + ((h @ pair["b"]) * (alpha / rank)).to(dtype)
    tail = x1[:, -(K - 1):, :] if S >= K - 1 else \
        F.pad(x1, (0, 0, K - 1 - S, 0))
    return out, {"h": h_last, "conv": tail}


def body_weights(p, specs, want, rt):
    """A layer's dense leaves ``p`` (held by their logical ``specs`` in
    the production layout) as the blocks of ``want`` (a body's specs),
    or whole where ``want`` is None or lacks the leaf."""
    return {k: rt_lib.reblock(v, specs[k], (want or {}).get(
        k, P(*([None] * v.ndim))), rt, k) for k, v in p.items()}


def _mamba_dist(p, x, cfg: ModelConfig, lo, h0, rt, held=False):
    """The channel-parallel body on each rank (``shard_map`` over
    d_inner): the rank's channels of the dequantized weights, the
    sequence all-gathered in and the output reduce-scattered back when
    ``cfg.seq_shard`` splits it, else the output summed over ``model``;
    checkpointed inside, so the backward recomputes the body from its
    sharded inputs. ``held``: ``p`` is the rank's blocks already."""
    B, S, _ = x.shape
    m, tp, dp = rt.tp_size, rt.tp_axis, rt.dp_axes
    pspec = mamba_partition_specs(cfg, tp)
    seq_out = tp if (cfg.seq_shard and S % m == 0 and S > 1) else None
    names = sorted(pspec)
    lo = {k: v for k, v in lo.items() if k in ("in_proj_x", "out_proj")}
    lo_names = sorted(lo)
    x_l = rt_lib.shard_in(x, P(dp, seq_out, None), rt)
    p_l = [p[k] if held else rt_lib.shard_in(p[k], pspec[k], rt)
           for k in names]
    lo_l = [rt_lib.shard_in(lo[k][f], P(), rt) for k in lo_names
            for f in ("a", "b")]
    h0_l = None if h0 is None else rt_lib.shard_in(h0, P(dp, tp, None), rt)
    r = rt.index(tp)

    def body(x_l, h0_l, *flat):
        pl = dict(zip(names, flat[:len(names)]))
        ll = {k: {"a": flat[len(names) + 2 * i],
                  "b": flat[len(names) + 2 * i + 1]}
              for i, k in enumerate(lo_names)}
        if seq_out:
            x_l = rt_lib.all_gather(x_l, tp, rt, dim=1)
        out, cache = _mamba_core(pl, x_l, cfg, ll, h0_l, shard=(r, m), rt=rt)
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
            {"h": rt_lib.shard_out(h, P(dp, tp, None), rt),
             "conv": rt_lib.shard_out(conv, P(dp, None, tp), rt)})


def mamba_block(p, x: torch.Tensor, cfg: ModelConfig, *, lora=None,
                h0=None, specs=None):
    """x: (B, S, d) -> (y (B, S, d), cache {"h": h_last, "conv": tail}),
    from the start state ``h0`` (B, d_inner, N) when given, else zeros.
    The quantized leaves of ``p`` are dequantized to their output dtype
    first (QLoRA keeps them NF4 at rest). Profiler ranges name the
    decode (``mamba.dequantize``) and the scan (``mamba.scan``).
    ``specs``: the leaves' specs in the production layout."""
    with torch.profiler.record_function("mamba.dequantize"):
        p = {k: maybe_dequantize(v) for k, v in p.items()}
    lo = lora or {}
    rt = rt_lib.get_runtime()
    if rt is None:
        return _mamba_core(p, x, cfg, lo, h0)
    held = specs is not None
    if cfg.d_inner % rt.tp_size or x.shape[0] % rt.dp_size:
        rt_lib.dist_trace("mamba_block_fallback")
        if held:
            p = body_weights(p, specs, None, rt)
        return _mamba_core(p, x, cfg, lo, h0)
    rt_lib.dist_trace("mamba_block_dist")
    if held:
        p = body_weights(p, specs, mamba_partition_specs(cfg, rt.tp_axis),
                         rt)
    return _mamba_dist(p, x, cfg, lo, h0, rt, held=held)


def mamba_decode(p, x: torch.Tensor, cache, cfg: ModelConfig, *,
                 lora=None, specs=None):
    """One token, port of ``repro.models.ssm.mamba_decode``: x (B, 1, d)
    -> (y (B, 1, d), {"h", "conv"}). Every quantized leaf of ``p`` is
    dequantized first, as in the JAX package (range
    ``mamba.dequantize``); the conv runs over ``cat(conv, x1)``, the
    state steps ``h = exp(dt·A)·h + dt·x·B`` in fp32, and the returned
    window is the input one shifted by the new token. In the production
    layout (``specs`` given) the rank's channels of the weights and of
    ``cache``, whose states come back as the rank's block."""
    with torch.profiler.record_function("mamba.dequantize"):
        p = {k: maybe_dequantize(v) for k, v in p.items()}
    lo = lora or {}
    rt = rt_lib.get_runtime()
    if rt is None or specs is None:
        return _mamba_decode_core(p, x, cache, cfg, lo)
    if cfg.d_inner % rt.tp_size:
        rt_lib.dist_trace("mamba_decode_fallback")
        return _mamba_decode_core(body_weights(p, specs, None, rt), x,
                                  cache, cfg, lo)
    rt_lib.dist_trace("mamba_decode_dist")
    p = body_weights(p, specs, mamba_partition_specs(cfg, rt.tp_axis), rt)
    return _mamba_decode_core(p, x, cache, cfg, lo,
                              shard=(rt.index(rt.tp_axis), rt.tp_size),
                              rt=rt)


def _mamba_decode_core(p, x, cache, cfg: ModelConfig, lo, *, shard=None,
                       rt=None):
    """:func:`mamba_decode` on dense weights; with ``shard=(r, m)`` rank
    r's d_inner / m channels, the ``x_proj`` and output partials summed
    over the model axis."""
    dtype = x.dtype
    N, R = cfg.ssm_state, cfg.dt_rank
    alpha, rank = cfg.lora_alpha, cfg.lora_rank
    di_l = p["in_proj_x"].shape[-1]
    sl = None if shard is None else (shard[0] * di_l, di_l)
    x0 = x[:, 0]
    x1 = x0 @ p["in_proj_x"].to(dtype) + _lora_delta(
        x0, lo.get("in_proj_x"), alpha, rank, sl)
    z = x0 @ p["in_proj_z"].to(dtype)
    window = torch.cat([cache["conv"], x1[:, None, :].to(
        cache["conv"].dtype)], 1)
    xc = F.silu(torch.einsum("bkd,kd->bd", window.to(dtype),
                             p["conv_w"].to(dtype)))
    proj = (xc @ p["x_proj"].to(dtype)).to(torch.float32)
    if shard is not None:
        proj = rt_lib.psum(proj, rt.tp_axis, rt)
    dt_r, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    xcf = xc.to(torch.float32)
    h = torch.exp(dt[..., None] * A) * cache["h"] + \
        (dt * xcf)[..., None] * Bm[:, None, :]
    y = torch.einsum("ben,bn->be", h, Cm) + p["d_skip"] * xcf
    y = y.to(dtype) * F.silu(z)
    out = y @ p["out_proj"].to(dtype)
    pair = lo.get("out_proj")
    if pair is not None:
        a = pair["a"] if sl is None else pair["a"].narrow(0, *sl)
        out = out + (((y.to(a.dtype) @ a) @ pair["b"]) *
                     (alpha / rank)).to(dtype)
    if shard is not None:
        out = rt_lib.psum(out, rt.tp_axis, rt)
    return out[:, None, :], {"h": h, "conv": window[:, 1:, :]}
