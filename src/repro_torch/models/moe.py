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

Under a :class:`~repro_torch.models.runtime.Runtime` the layer runs the
JAX package's expert-parallel body (``_moe_dist_body``) on each rank:
the rank routes its own tokens (sequence-sharded over ``model``, or in
a decode step the batch split over ``model``), builds the ``(m, E_l,
C, d)`` send buffer with the capacity of its own token count, exchanges
it with the experts' owners by an all-to-all over ``model`` (int8 rows
and their fp32 scales with ``cfg.moe_dispatch_bits == 8``; the
cotangent rides back the same way), runs its ``E / m`` experts one at a
time, each expert's weights all-gathered over ``data`` (FSDP), and
sends the outputs home by the reverse all-to-all. A quantized expert's
products go through ``kernels.ops.quant_matmul``: on the card the
hand-written ``quant_matmul`` kernel decodes the NF4 codes in its tiles
(and its gradient for x is the ``quant_matmul_t`` kernel), so neither
the forward nor the backward ever holds a decoded expert; on the CPU
the plain version, the JAX package's ``dequantize`` and product. Under
a mesh of one rank this is a per-expert decode of the whole layer,
which is what lets Kimi-K2 run at full width on one card. The expert
weights may be whole ``(E, ...)`` or this rank's block ``(E / m, ...,
N / data)`` (``launch.shardings.rank_params``, the production layout's
holding); a whole one is cut at the body's entry. In the production
layout the body runs under the step's view: the tokens are the rank's
batch block already, and the balance loss is averaged over ``model``
here and over the dp axes by the model's loss. Profiler ranges:
``moe.dispatch`` (routing, slots, the send buffer and its all-to-all),
``moe.experts`` and ``moe.combine``. With ``cfg.calibrate`` (the dry
run's cost calibration) the body runs its experts as one batched
product over the rank's dequantized experts (each all-gathered whole
over ``data``) instead of the per-expert loop, as the JAX package's
calibrated body does. ``expert_specs`` gives the dry run's shapes as
``meta`` tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import spec
from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant as qlib
from repro_torch.core.quant import QTensor, maybe_dequantize
from repro_torch.kernels import ops as kops
from repro_torch.models import runtime as rt_lib
from repro_torch.models.layers import _normal
from repro_torch.models.runtime import P


class LazyExperts:
    """A stacked expert weight ``(E, K, N)`` drawn one expert at a time:
    ``w[j]`` draws expert j (in order, from the layer's generator), so a
    caller that quantizes each expert as it comes (``Model.init_params``)
    never holds the dense stack, 33.8 GB a layer at Kimi-K2's width."""

    def __init__(self, generator, shape, fan_in, dtype, device):
        self.generator, self.shape, self.fan_in = generator, tuple(shape), \
            fan_in
        self.dtype, self.device, self.ndim = dtype, device, len(shape)
        self._next = 0

    def __getitem__(self, j: int) -> torch.Tensor:
        if j != self._next:
            raise IndexError(f"experts are drawn in order: {j} after "
                             f"{self._next - 1}")
        self._next += 1
        return _normal(self.generator, self.shape[1:], self.fan_in,
                       self.dtype, self.device)


def init_experts(generator, cfg: ModelConfig, dtype, device, *,
                 lazy: bool = False):
    """The router and the stacked experts; with ``lazy`` the experts are
    :class:`LazyExperts`, drawn expert by expert when read."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": _normal(generator, (d, E), d, torch.float32, device)}
    for name, shape, fan in (("wg", (E, d, ff), d), ("wu", (E, d, ff), d),
                             ("wd", (E, ff, d), ff)):
        p[name] = LazyExperts(generator, shape, fan, dtype, device) if lazy \
            else _normal(generator, shape, fan, dtype, device)
    return p


def expert_specs(cfg: ModelConfig, dtype, lead=()):
    """:func:`init_experts`' leaves (stacked on ``lead``) as ``meta``
    tensors."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    f = lambda *sh: spec((*lead, *sh), dtype)
    return {"router": spec((*lead, d, E)), "wg": f(E, d, ff),
            "wu": f(E, d, ff), "wd": f(E, ff, d)}


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


def expert_partition_specs(params, tp_axis="model", fsdp_axis="data",
                           lead_scanned=True):
    """The spec tree of the (possibly quantized) expert params: the E dim
    over ``tp_axis``, the last dim over ``fsdp_axis``, the router
    replicated. ``lead_scanned``: the leaves carry a leading (L,) layer
    dim. A QTensor's spec is a QTensor of its storage's specs."""
    nlead = 1 if lead_scanned else 0

    def spec(ndim):
        dims = [None] * ndim
        dims[nlead] = tp_axis
        dims[-1] = fsdp_axis
        return P(*dims)

    out = {}
    for name, leaf in params.items():
        if "router" in name:
            out[name] = P(*([None] * leaf.ndim))
        elif isinstance(leaf, QTensor):
            out[name] = dataclasses.replace(leaf, q=spec(leaf.q.ndim),
                                            scales=spec(leaf.scales.ndim))
        else:
            out[name] = spec(leaf.ndim)
    return out


# ------------------------------------------------------------------ dist
def _q8_rows(x):
    """Per-row absmax int8 quantization of the dispatch payload: ``(q int8,
    s fp32 (..., 1))``, ``s = max(|x|, 1e-12) / 127`` and ``q =
    round(x / s)`` as IEEE divisions (``core.quant._div``), so the codes
    are the eager JAX function's bit for bit on every device."""
    xf = x.to(torch.float32)
    s = qlib._div(xf.abs().amax(-1, keepdim=True).clamp_min(1e-12), 127.0)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def _a2a_q8_value(x, rt):
    q, s = _q8_rows(x)
    q = rt_lib.all_to_all_raw(q, rt.tp_axis, rt)
    s = rt_lib.all_to_all_raw(s, rt.tp_axis, rt)
    return (q.to(torch.float32) * s).to(x.dtype)


class _A2AQ8(torch.autograd.Function):
    """The int8 all-to-all: per-row absmax quantize, exchange payload and
    scales over the model axis, dequantize. The backward is the same
    int8 exchange of the cotangent (the tiled all-to-all is its own
    transpose), so both directions ride the wire in int8."""

    @staticmethod
    def forward(ctx, x, rt):
        ctx.rt = rt
        return _a2a_q8_value(x, rt)

    @staticmethod
    def backward(ctx, g):
        return _a2a_q8_value(g, ctx.rt), None


def _a2a_maybe_q8(x, rt, enabled: bool, dtype):
    """The all-to-all over the model axis, with an int8 payload and fp32
    per-row scales when ``enabled``."""
    if not enabled:
        return rt_lib.all_to_all(x, rt.tp_axis, rt)
    return _A2AQ8.apply(x, rt).to(dtype)


def _expert(w, e: int):
    """Expert ``e`` of a stacked ``(E, K, N)`` weight or QTensor."""
    if isinstance(w, QTensor):
        return QTensor(q=w.q[e], scales=w.scales[e], bits=w.bits,
                       mode=w.mode, block=w.block, out_dtype=w.out_dtype,
                       orig_shape=tuple(w.orig_shape[1:]))
    return w[e]


def _gather_last(w, rt, axis: str):
    """One expert's weight all-gathered over ``axis`` on its last dim (a
    QTensor's ``q`` and ``scales`` both: the storage's last dim is N)."""
    n = rt.mesh.size((axis,))
    if n == 1:
        return w
    g = lambda t: rt_lib.all_gather_raw(t, axis, rt,
                                        dim=t.ndim - 1).contiguous()
    if isinstance(w, QTensor):
        return QTensor(q=g(w.q), scales=g(w.scales), bits=w.bits,
                       mode=w.mode, block=w.block, out_dtype=w.out_dtype,
                       orig_shape=(*w.orig_shape[:-1], w.orig_shape[-1] * n))
    return g(w)


def _matmul(x, w, dtype):
    if isinstance(w, QTensor):
        return kops.quant_matmul(x, w)
    return x @ w.to(dtype)


def _expert_mlp(x_e, wg, wu, wd, dtype):
    h = F.silu(_matmul(x_e, wg, dtype)) * _matmul(x_e, wu, dtype)
    return _matmul(h, wd, dtype)


def _rank_experts(w, n_last: int, cfg: ModelConfig, rt, fsdp_axis: str):
    """This rank's experts of ``w``: ``w`` itself when it is already the
    rank's block, else cut from the whole ``(E, ..., n_last)`` weight."""
    from repro_torch.launch.shardings import local_shard
    st = w.q if isinstance(w, QTensor) else w
    whole = st.shape[0] == cfg.n_experts and st.shape[-1] == n_last
    m, nd = rt.tp_size, rt.mesh.size((fsdp_axis,))
    if not whole or (m == 1 and nd == 1):
        return w
    spec = expert_partition_specs({"w": w}, rt.tp_axis, fsdp_axis,
                                  lead_scanned=False)["w"]
    return local_shard(w, spec, rt.mesh)


def _moe_dist_body(x_loc, p, cfg: ModelConfig, rt, fsdp_axis: str):
    """One rank's expert-parallel step. x_loc: (T_ls, d), the rank's
    tokens; ``p``'s experts are the rank's E / m (their last dim split
    over ``fsdp_axis``). Returns (y (T_ls, d), the rank's balance loss)."""
    T_ls, d = x_loc.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    m = rt.tp_size
    E_l = E // m
    C = max(1, math.ceil(T_ls * k * cfg.capacity_factor / E))
    dtype = x_loc.dtype
    q8 = cfg.moe_dispatch_bits == 8
    with torch.profiler.record_function("moe.dispatch"):
        gates, ids, aux = _route(p["router"], x_loc, cfg)
        order, sorted_ids, slot, keep = _slot_assignment(ids.reshape(-1),
                                                         E, C)
        dst = torch.where(keep, slot, C)
        send = torch.zeros((E, C + 1, d), dtype=dtype,
                           device=x_loc.device).index_put(
            (sorted_ids, dst), x_loc[order // k])[:, :C]
        # exchange slots with the experts' owners: (m, E_l, C, d)
        recv = _a2a_maybe_q8(send.reshape(m, E_l, C, d), rt, q8, dtype)
        toks = recv.transpose(0, 1).reshape(E_l, m * C, d)
    with torch.profiler.record_function("moe.experts"):
        if cfg.calibrate:
            # one batched product over the rank's experts, no loop
            wg, wu, wd = (maybe_dequantize(
                _gather_last(p[n], rt, fsdp_axis), dtype).to(dtype)
                for n in ("wg", "wu", "wd"))
            h = F.silu(torch.bmm(toks, wg)) * torch.bmm(toks, wu)
            y_experts = torch.bmm(h, wd)
        else:
            ys = []
            for e in range(E_l):
                w = [_gather_last(_expert(p[n], e), rt, fsdp_axis)
                     for n in ("wg", "wu", "wd")]
                ys.append(_expert_mlp(toks[e], *w, dtype))
            y_experts = torch.stack(ys)                    # (E_l, m*C, d)
    with torch.profiler.record_function("moe.combine"):
        y_back = y_experts.reshape(E_l, m, C, d).transpose(0, 1)
        y_home = _a2a_maybe_q8(y_back.contiguous(), rt, q8, dtype)
        y_buf = y_home.reshape(E, C, d)
        y_sorted = F.pad(y_buf, (0, 0, 0, 1))[sorted_ids, dst] * \
            keep[:, None].to(dtype)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        y = (y_sorted[inv].reshape(T_ls, k, d) *
             gates[..., None].to(dtype)).sum(1)
    return y, aux


def moe_ffn(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux balance loss). Without a Runtime
    the JAX package's local path; under one the expert-parallel body, on
    sequence shards over ``model`` when S > 1 divides, else (a decode
    step) on the batch split over ``model``, the balance loss averaged
    over every rank."""
    B, S, d = x.shape
    rt = rt_lib.get_runtime()
    if rt is None:
        y, aux = _moe_local(p, x.reshape(B * S, d), cfg)
        return y.reshape(B, S, d), aux
    m, dp, tp, fsdp = rt.tp_size, rt.dp_axes, rt.tp_axis, "data"
    n_last = {"wg": cfg.d_ff, "wu": cfg.d_ff, "wd": cfg.d_model}
    p = {"router": p["router"],
         **{n: _rank_experts(p[n], n_last[n], cfg, rt, fsdp)
            for n in n_last}}
    all_axes = tuple(dp) + (tp,)
    if S > 1 and S % m == 0:
        rt_lib.dist_trace("moe_ffn_dist_seq")
        spec = P(dp, tp, None)
        x_in = rt_lib.shard_in(x, spec, rt)
        y, aux = _moe_dist_body(x_in.reshape(-1, d), p, cfg, rt, fsdp)
        y = rt_lib.shard_out(y.reshape(x_in.shape), spec, rt)
    else:
        # a decode step: split the batch over the model axis inside
        rt_lib.dist_trace("moe_ffn_dist_decode")
        spec = P(dp, None, None)
        x_in = rt_lib.shard_in(x, spec, rt)
        Bl = x_in.shape[0]
        t = max(1, -(-Bl // m))
        r = rt.index(tp)
        x_pad = F.pad(x_in.reshape(Bl, d), (0, 0, 0, m * t - Bl))
        y_loc, aux = _moe_dist_body(x_pad[r * t:(r + 1) * t], p, cfg, rt,
                                    fsdp)
        y_all = rt_lib.all_gather(y_loc, tp, rt, dim=0)[:Bl]
        y = rt_lib.shard_out(y_all.reshape(x_in.shape), spec, rt)
    aux = rt_lib.shard_out(rt_lib.pmean(aux, all_axes, rt), P(), rt)
    return y, aux
