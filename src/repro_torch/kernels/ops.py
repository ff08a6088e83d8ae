"""Dispatch for the kernel ops, port of ``repro.kernels.ops``.

Each op dispatches on its tensor's device: a CPU tensor takes the plain
PyTorch version in ``kernels.ref``, a CUDA tensor launches the hand-
written kernel (built on first use) and raises if it cannot build or
launch. There is no fallback from the kernel to the plain version.

``KERNEL_TRACES`` counts which implementation each call took (the JAX
package counts at trace time; PyTorch runs eagerly, so here it is per
call), and every kernel wrapper keeps its own integer ``launches``.
``flash_attention``, ``lora_matmul`` and ``quant_matmul_t`` have a
tensor-core instantiation for bf16 and a CUDA-core one for fp32, chosen
by dtype in the wrapper; their bf16 calls are traced as
``<op>_cuda_tc``, fp32 as ``<op>_cuda``, and the wrappers count the
tensor-core launches in ``tc_launches``. ``quant_matmul`` counts its
GEMV launches (the serve head's route) in ``gemv_launches`` and its
tensor-core launches (a bf16 x past the GEMV's rows) in ``tc_launches``.

``lora_matmul``, ``flash_attention`` and ``selective_scan`` are
``torch.autograd.Function``s: the first ports the custom VJP of
``repro.kernels.ops.lora_matmul`` (its dx gemm is the ``quant_matmul_t``
kernel on the card); ``flash_attention`` gives its kernel a gradient
computed in plain PyTorch from the saved inputs, and ``selective_scan``
a backward kernel on the card (``selective_scan_bwd_cuda``) and the plain
reverse recurrence on the CPU (``selective_scan_bwd_ref``). The JAX
package differentiates the plain versions of both; it has no backward
kernel for either.

Before it launches, ``lora_matmul``'s tensor-core kernel and
``quant_matmul``'s GEMV (a 2-D weight) consult ``autotune.lookup`` for a
tuned split count or plan, as the JAX ops consult it for their tiles;
with an empty cache the kernels' own plans decide, as before.

Under a :class:`~repro_torch.models.runtime.Runtime`, ``flash_attention``
and ``decode_attention`` run the JAX package's explicit splits (the
query heads over the model axis; the cache slots over it, merged by the
log-sum-exp combine), the kernel on each rank's slice.
"""
from __future__ import annotations

from typing import Dict

import math

import torch

from repro_torch.core import quant as qlib
from repro_torch.kernels import autotune
from repro_torch.kernels import blockwise_quant as bq_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import lora_matmul as lm_kernel
from repro_torch.kernels import quant_matmul as qmm_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as ss_kernel
from repro_torch.models import runtime as rt_lib

KERNEL_TRACES: Dict[str, int] = {}

# the CUDA kernel wrappers, each with its ``launches`` count
KERNELS = {
    "quant_matmul": qmm_kernel.quant_matmul,
    "blockwise_quant": bq_kernel.blockwise_quant,
    "flash_attention": fa_kernel.flash_attention,
    "lora_matmul": lm_kernel.lora_matmul,
    "quant_matmul_t": lm_kernel.quant_matmul_t,
    "selective_scan": ss_kernel.selective_scan,
    "selective_scan_bwd": ss_kernel.selective_scan_bwd,
}


def trace_count(name: str, n: int = 1) -> None:
    KERNEL_TRACES[name] = KERNEL_TRACES.get(name, 0) + int(n)


def reset_kernel_traces() -> None:
    KERNEL_TRACES.clear()


# the wrappers with a tensor-core instantiation, each with ``tc_launches``
TC_KERNELS = {"flash_attention": fa_kernel.flash_attention,
              "lora_matmul": lm_kernel.lora_matmul,
              "quant_matmul_t": lm_kernel.quant_matmul_t}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def tc_launch_counts() -> Dict[str, int]:
    return {name: fn.tc_launches for name, fn in TC_KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in TC_KERNELS.values():
        fn.tc_launches = 0
    qmm_kernel.quant_matmul.gemv_launches = 0
    qmm_kernel.quant_matmul.tc_launches = 0


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"{op}: no kernel for device {t.device}")


# -- attention -----------------------------------------------------------
def flash_attention_bwd(q, k, v, do, *, causal=True, window=None):
    """The gradient of masked ``softmax(QKᵀ/√D)V`` for q (B, S, H, D), k/v
    (B, Skv, Hkv, D): P is recomputed from q, k and the masks
    (``ref.attention_probs``, not autograd through the forward), then
    ``dV = Pᵀ dO``, ``dS = P∘(dO Vᵀ − rowsum(P∘(dO Vᵀ)))`` (the rowsum
    equals ``rowsum(dO∘O)``, here without the rounding of the stored O),
    ``dQ = dS K/√D`` and ``dK = dSᵀ Q/√D``, GQA summed over each KV
    group; all in fp32, cast back to the inputs' dtypes. A row that sees
    no key has P = 0 and gets no gradient, as the forward gives it 0."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    p = ref.attention_probs(q, k, causal=causal, window=window)
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(G, dim=2)
    vf = v.to(torch.float32).repeat_interleave(G, dim=2)
    dof = do.to(torch.float32)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if G > 1:
        dk = dk.reshape(B, Skv, Hkv, G, D).sum(3)
        dv = dv.reshape(B, Skv, Hkv, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        if _on_cuda(q, "flash_attention"):
            trace_count("flash_attention_cuda_tc"
                        if fa_kernel.uses_tensor_cores(q)
                        else "flash_attention_cuda")
            return fa_kernel.flash_attention(q, k, v, causal=causal,
                                             window=window)
        trace_count("flash_attention_ref")
        return ref.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        trace_count("flash_attention_bwd")
        dq, dk, dv = flash_attention_bwd(q, k, v, do, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=None):
    """Masked GQA attention of q (B, S, H, D) over k, v (B, Skv, Hkv, D).
    Under a Runtime the JAX package's explicit split: the batch over the
    dp axes (when it divides), the query heads padded to a multiple of
    the model axis and split over it, each rank's heads with their KV
    heads gathered (``kv = clamp(head, H - 1) // (H / Hkv)``), the kernel
    on the rank's slice, the heads re-assembled and the padding cut."""
    rt = rt_lib.get_runtime()
    if rt is None:
        return _FlashAttention.apply(q, k, v, causal, window)
    rt_lib.dist_trace("flash_attention_dist")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    m, dp = rt.tp_size, rt.dp_axes
    if B % rt.dp_size:
        dp = ()
    dp = dp or None
    G = H // Hkv
    Hp = -(-H // m) * m
    if Hp != H:
        q = torch.nn.functional.pad(q, (0, 0, 0, Hp - H))
    Hl = Hp // m
    q_l = rt_lib.shard_in(q, rt_lib.P(dp, None, rt.tp_axis, None), rt)
    k_l = rt_lib.shard_in(k, rt_lib.P(dp, None, None, None), rt)
    v_l = rt_lib.shard_in(v, rt_lib.P(dp, None, None, None), rt)
    gids = rt.index(rt.tp_axis) * Hl + torch.arange(Hl, device=q.device)
    kv_ids = gids.clamp(0, H - 1) // G
    out = _FlashAttention.apply(q_l, k_l.index_select(2, kv_ids),
                                v_l.index_select(2, kv_ids), causal, window)
    out = rt_lib.shard_out(out, rt_lib.P(dp, None, rt.tp_axis, None), rt)
    return out[:, :, :H]


def decode_attention(q, k_cache, v_cache, slot_pos):
    """One query token (B, 1, H, D) against a ring KV cache (B, M, Hkv,
    D), port of ``repro.kernels.ops.decode_attention``
    (:func:`ref.decode_attention`). The JAX package computes it in plain
    ``jnp``, not Pallas, so the plain PyTorch version is its port on
    every device, traced as ``decode_attention_plain``; the profiler
    range ``decode_attention`` names its device time. Under a Runtime
    whose model axis divides the M slots, the split-KV body: each rank's
    slots give ``ref.decode_attention_partial``'s (max, sum, acc), merged
    by the log-sum-exp combine with a max and two sums over the model
    axis (the batch over the dp axes when it divides)."""
    rt = rt_lib.get_runtime()
    M = k_cache.shape[1]
    if rt is None or M % rt.tp_size:
        if rt is not None:
            rt_lib.dist_trace("decode_attention_fallback")
        trace_count("decode_attention_plain")
        with torch.profiler.record_function("decode_attention"):
            return ref.decode_attention(q, k_cache, v_cache, slot_pos)
    rt_lib.dist_trace("decode_attention_dist")
    trace_count("decode_attention_plain")
    B, _, H, D = q.shape
    tp, dp = rt.tp_axis, rt.dp_axes
    if B % rt.dp_size:
        dp = ()
    dp = dp or None
    with torch.profiler.record_function("decode_attention"):
        q_l = rt_lib.shard_in(q, rt_lib.P(dp, None, None, None), rt)
        kv = rt_lib.P(dp, tp, None, None)
        mi, li, acci = ref.decode_attention_partial(
            q_l, rt_lib.shard_in(k_cache, kv, rt),
            rt_lib.shard_in(v_cache, kv, rt),
            rt_lib.shard_in(slot_pos, rt_lib.P(None, tp), rt))
        mg = rt_lib.pmax(mi, tp, rt)
        corr = torch.exp(mi - mg)
        lg = rt_lib.psum(li * corr, tp, rt)
        accg = rt_lib.psum(acci * corr[..., None], tp, rt)
        out = accg / lg.clamp_min(1e-30)[..., None]
        out = out.reshape(q_l.shape[0], 1, H, D).to(q_l.dtype)
        return rt_lib.shard_out(out, rt_lib.P(dp, None, None, None), rt)


def combine_decode_partials(parts, dtype=torch.float32):
    """Merge ``ref.decode_attention_partial`` statistics ``(m, l, acc)``
    of disjoint slices of the cache slots into the attention output
    ``(B, 1, H, D)`` in ``dtype``: the log-sum-exp combine of
    ``repro.kernels.ops.decode_attention`` (its ``pmax``/``psum`` over
    the cache shards, ``ops.py:113-120``) as a plain function."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    corr = [torch.exp(mi - m) for mi, _, _ in parts]
    lg = sum(li * c for (_, li, _), c in zip(parts, corr))
    accg = sum(ai * c[..., None] for (_, _, ai), c in zip(parts, corr))
    out = accg / lg.clamp_min(1e-30)[..., None]
    B, Hkv, G, D = out.shape
    return out.reshape(B, 1, Hkv * G, D).to(dtype)


def _dx_through_w(g, qt: qlib.QTensor, K: int) -> torch.Tensor:
    """``g @ dequant(W)ᵀ`` for a frozen W's dx on the card, as (M, K)
    fp32: the ``quant_matmul_t`` kernel with fp32 out, sliced ``[:, :K]``
    (the payload covers K padded to the block). A bf16 g goes to its
    tensor-core kernel as it is (its fp32 copy holds the same values, so
    the products and their fp32 sum are the same), any other g as fp32
    to the CUDA-core kernel."""
    tc = lm_kernel.uses_tensor_cores(g)
    trace_count("quant_matmul_t_cuda_tc" if tc else "quant_matmul_t_cuda")
    g2 = g.reshape(-1, g.shape[-1])
    return lm_kernel.quant_matmul_t(g2 if tc else g2.to(torch.float32), qt,
                                    out_dtype=torch.float32)[:, :K]


def _qmm_kernel(x, qt: qlib.QTensor):
    """The ``quant_matmul`` kernel, at the tuned GEMV plan when the
    autotune cache holds one for this 2-D weight's shape."""
    if qt.q.ndim == 3:
        M, (G, _, N) = math.prod(x.shape[:-1]), qt.q.shape[-3:]
        tuned = autotune.lookup("quant_matmul", M, x.shape[-1], N,
                                bits=qt.bits, mode=qt.mode)
        if tuned is not None and qmm_kernel.takes_gemv(M, N, qt.q):
            return qmm_kernel._quant_matmul(
                x, qt, autotune.gemv_plan(M, G, N, tuned))
    return qmm_kernel.quant_matmul(x, qt)


def _lora_kernel(x, qt: qlib.QTensor, a, b, scale: float):
    """The ``lora_matmul`` kernel, at the tuned split count when the
    autotune cache holds one for this shape (a bf16 x: the tensor-core
    kernel, the only one that splits)."""
    splits = None
    if lm_kernel.uses_tensor_cores(x):
        splits = autotune.lookup("lora_matmul", math.prod(x.shape[:-1]),
                                 x.shape[-1], qt.q.shape[-1], bits=qt.bits,
                                 mode=qt.mode)
    if splits is None:
        return lm_kernel.lora_matmul(x, qt, a, b, scale=scale)
    return lm_kernel._lora_matmul(x, qt, a, b, scale, splits[0])


class _QuantMatmul(torch.autograd.Function):
    """``x @ dequant(W)`` on the card with a gradient for x: the forward
    is the ``quant_matmul`` kernel, the backward's ``g @ dequant(W)ᵀ``
    the ``quant_matmul_t`` kernel (``_dx_through_w``), as in
    ``_QLoraMatmul``. W is frozen
    and gets no gradient; nothing but W's QTensor is kept for the
    backward. The JAX package differentiates the plain version, whose
    dx is the same product."""

    @staticmethod
    def forward(ctx, x, qt):
        ctx.qt, ctx.shape, ctx.dtype = qt, x.shape, x.dtype
        return _qmm_kernel(x, qt)

    @staticmethod
    def backward(ctx, g):
        dx = _dx_through_w(g, ctx.qt, ctx.shape[-1])
        return dx.reshape(ctx.shape).to(ctx.dtype), None


def quant_matmul(x, qt: qlib.QTensor):
    """``x @ dequant(qt)``. On the card the ``quant_matmul`` kernel; with
    a gradient wanted for x (a frozen quantized projection without LoRA
    inside a trained model: the hybrid's and the encoder's MLPs, the
    MoE's dense layers and shared experts) through ``_QuantMatmul``,
    whose backward is the ``quant_matmul_t`` kernel. On the CPU the
    plain version, differentiated by autograd."""
    # qt.q.ndim == 3: a plain 2-D weight; 4: a stacked (per-user) one
    if _on_cuda(x, "quant_matmul"):
        trace_count("quant_matmul_cuda" if qt.q.ndim == 3
                    else "quant_matmul_cuda_stacked")
        if torch.is_grad_enabled() and x.requires_grad:
            if qt.q.ndim != 3:
                raise NotImplementedError(
                    "quant_matmul: a gradient through a stacked QTensor "
                    "has no kernel")
            return _QuantMatmul.apply(x, qt)
        return _qmm_kernel(x, qt)
    trace_count("quant_matmul_ref")
    return ref.quant_matmul(x, qt)


# -- fused LoRA linear -----------------------------------------------------
class _QLoraMatmul(torch.autograd.Function):
    """Port of the custom VJP at ``repro/kernels/ops.py:195-247`` for a
    QTensor W (frozen: the payload gets no gradient).

    On the card the forward is the fused kernel and the backward's dx
    through Wᵀ is the ``quant_matmul_t`` kernel (``_dx_through_w``);
    only x, A and B are saved, never a dequantized W (an fp32 W per layer
    would be 33 GB at Yi-9B and undo QLoRA). On the CPU it follows the
    JAX package's plain branch: the forward dequantizes W to fp32 and
    saves it for the backward's Wᵀ gemm. dA, dB and ``scale·gB Aᵀ`` are
    ``torch.matmul``, as the JAX package computes them outside any
    kernel."""

    @staticmethod
    def forward(ctx, x, a, b, qt, scale):
        ctx.qt, ctx.scale = qt, scale
        if _on_cuda(x, "lora_matmul"):
            trace_count("lora_matmul_cuda_tc"
                        if lm_kernel.uses_tensor_cores(x)
                        else "lora_matmul_cuda")
            ctx.save_for_backward(x, a, b)
            return _lora_kernel(x, qt, a, b, scale)
        trace_count("lora_matmul_ref")
        wd = qlib.dequantize(qt, torch.float32)[:x.shape[-1]]
        ctx.save_for_backward(x, a, b, wd)
        return ref.lora_matmul(x, wd, a, b, scale=scale)

    @staticmethod
    def backward(ctx, g):
        x, a, b, *wd = ctx.saved_tensors
        scale, K = ctx.scale, x.shape[-1]
        x2 = x.reshape(-1, K).to(torch.float32)
        g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
        af, bf = a.to(torch.float32), b.to(torch.float32)
        gb = g2 @ bf.t()                                  # (M, r)
        if wd:
            dxw = g2 @ wd[0].t()                          # (M, K) exactly
        else:
            dxw = _dx_through_w(g, ctx.qt, K)
        dx = (dxw + scale * gb @ af.t()).reshape(x.shape).to(x.dtype)
        da = (scale * (x2.t() @ gb)).to(a.dtype)
        db = (scale * ((x2 @ af).t() @ g2)).to(b.dtype)
        return dx, da, db, None, None


def lora_matmul(x, w, a, b, *, scale: float):
    """``y = x @ W + scale·(x@A)@B`` as one op with fp32 accumulation and
    a gradient for x, A and B (``_QLoraMatmul``). A dense W is plain
    PyTorch on every device (autograd gives dW too), as the JAX package
    computes that branch outside any Pallas kernel; its A/B may carry a
    leading batch axis (one pair per row of a stacked tenant batch)."""
    if isinstance(w, qlib.QTensor):
        return _QLoraMatmul.apply(x, a, b, w, float(scale))
    trace_count("lora_matmul_dense")
    return ref.lora_matmul(x, w, a, b, scale=float(scale))


def blockwise_quant(x, *, bits=8, block=128, mode="linear"):
    if _on_cuda(x, "blockwise_quant"):
        if x.ndim != 2 or mode != "linear":
            raise NotImplementedError(
                f"blockwise_quant kernel: ndim={x.ndim} mode={mode!r} "
                "(the kernel takes 2-D linear int8/int4)")
        trace_count("blockwise_quant_cuda")
        return bq_kernel.blockwise_quant(x, bits=bits, block=block)
    trace_count("blockwise_quant_ref")
    return ref.blockwise_quant(x, bits=bits, block=block, mode=mode)


# -- selective scan (Mamba-1) -----------------------------------------------
@torch.no_grad()
def selective_scan_bwd(dt, x, Bm, Cm, A, gy, gh_last, *, need_a=True):
    """The gradient of :func:`ref.selective_scan` for the cotangents gy
    ``(B, S, di)`` and gh_last ``(B, di, N)``, by the explicit reverse
    recurrence, time-major in fp32. The states are recomputed from the
    inputs (one in-place FMA per step), then
    ``g_t = gy_t ⊗ C_t + a_{t+1} ∘ g_{t+1}`` (plus gh_last at the last
    step) runs backwards the same way, and with ``q_t = g_t ∘ a_t ∘
    h_{t-1}`` (the gradient of ``dt_t ⊗ A``):
    ``d dt = Σ_n q A + x Σ_n g B``, ``dx = dt Σ_n g B``,
    ``dB = Σ_d g (dt x)``, ``dC = Σ_d gy h``, ``dA = Σ_{b,t} q dt``.
    Four (S, B, di, N) buffers live during the call; none is saved
    between forward and backward. ``dA`` is None unless ``need_a``. The
    CPU path of the op's backward and the card's oracle for its kernel
    (``kernels.selective_scan.selective_scan_bwd``)."""
    f32 = torch.float32
    dtT, xT, BT, CT, gyT = (t.to(f32).transpose(0, 1) for t in
                            (dt, x, Bm, Cm, gy))
    A = A.to(f32)
    S = dtT.shape[0]
    a = torch.exp(dtT[..., None] * A)                      # (S, B, di, N)
    h = ((dtT * xT)[..., None] * BT[:, :, None, :]).contiguous()
    g = (gyT[..., None] * CT[:, :, None, :]).contiguous()
    g[S - 1] += gh_last.to(f32)
    # per-step views made once: one launch per step, not four
    a_t, h_t, g_t = a.unbind(0), h.unbind(0), g.unbind(0)
    for t in range(1, S):                                  # h_t, in place
        h_t[t].addcmul_(a_t[t], h_t[t - 1])
    for t in range(S - 2, -1, -1):
        g_t[t].addcmul_(a_t[t + 1], g_t[t + 1])
    dC = torch.einsum("sbd,sbdn->sbn", gyT, h)
    q = a.mul_(g)                                          # reuses a
    q[1:] *= h[:-1]
    q[0] = 0.0
    gB = torch.einsum("sbdn,sbn->sbd", g, BT)
    ddt = torch.einsum("sbdn,dn->sbd", q, A) + xT * gB
    dx = dtT * gB
    dB = torch.einsum("sbdn,sbd->sbn", g, dtT * xT)
    dA = torch.einsum("sbdn,sbd->dn", q, dtT) if need_a else None
    back = lambda t, like: t.transpose(0, 1).to(like.dtype)
    return (back(ddt, dt), back(dx, x), back(dB, Bm), back(dC, Cm),
            None if dA is None else dA.to(A.dtype))


# The plain scans as operators: on real tensors each runs its plain
# version; on fake tensors (the dry run, ``launch.dryrun``) only shapes
# flow, one operator a call as on the card one kernel launch, where the
# plain time loop would trace S steps.
@torch.library.custom_op("repro_torch::selective_scan_plain",
                         mutates_args=())
def _scan_plain(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, A: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.selective_scan(dt, x, Bm, Cm, A)


@_scan_plain.register_fake
def _(dt, x, Bm, Cm, A):
    B, S, di = x.shape
    return (x.new_empty((B, S, di), dtype=torch.float32),
            x.new_empty((B, di, A.shape[-1]), dtype=torch.float32))


@torch.library.custom_op("repro_torch::selective_scan_bwd_plain",
                         mutates_args=())
def _scan_bwd_plain(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, A: torch.Tensor, gy: torch.Tensor,
                    gh_last: torch.Tensor, need_a: bool
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """:func:`selective_scan_bwd`; an unwanted dA comes back empty."""
    *d, dA = selective_scan_bwd(dt, x, Bm, Cm, A, gy, gh_last,
                                need_a=need_a)
    return (*d, A.new_empty(0) if dA is None else dA)


@_scan_bwd_plain.register_fake
def _(dt, x, Bm, Cm, A, gy, gh_last, need_a):
    return (torch.empty_like(dt), torch.empty_like(x), torch.empty_like(Bm),
            torch.empty_like(Cm),
            torch.empty_like(A) if need_a else A.new_empty(0))


class _SelectiveScan(torch.autograd.Function):
    """The scan with its gradient: the kernels on the card, the plain
    versions on the CPU. An unused output's cotangent arrives as None
    (``set_materialize_grads(False)``): the kernel skips a None gh_last,
    as the model leaves h_last unused."""

    @staticmethod
    def forward(ctx, dt, x, Bm, Cm, A):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, x, Bm, Cm, A)
        if _on_cuda(dt, "selective_scan"):
            trace_count("selective_scan_cuda")
            return ss_kernel.selective_scan(dt, x, Bm, Cm, A)
        trace_count("selective_scan_ref")
        return _scan_plain(dt, x, Bm, Cm, A)

    @staticmethod
    def backward(ctx, gy, gh_last):
        dt, x, Bm, Cm, A = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        need_a = ctx.needs_input_grad[4]
        if _on_cuda(dt, "selective_scan"):
            trace_count("selective_scan_bwd_cuda")
            return ss_kernel.selective_scan_bwd(dt, x, Bm, Cm, A, gy,
                                                gh_last, need_a=need_a)
        trace_count("selective_scan_bwd_ref")
        if gh_last is None:
            gh_last = torch.zeros((x.shape[0], x.shape[2], A.shape[1]),
                                  dtype=torch.float32, device=x.device)
        *d, dA = _scan_bwd_plain(dt, x, Bm, Cm, A, gy, gh_last, need_a)
        return (*d, dA if need_a else None)


def selective_scan(dt, x, Bm, Cm, A):
    """The Mamba-1 recurrence from h0 = 0, ``(y, h_last)``, fp32, with a
    gradient for every input (``_SelectiveScan``)."""
    return _SelectiveScan.apply(dt, x, Bm, Cm, A)
