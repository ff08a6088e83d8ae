"""CUDA fused LoRA linear and its dx gemm, port of
``repro.kernels.lora_matmul``.

``lora_matmul(x, qt, a, b, scale=s)`` computes ``x @ dequant(qt) +
s·(x@A)@B`` in one launch and ``quant_matmul_t(g, qt)`` computes ``g @
dequant(qt)ᵀ`` over the padded ``Kq`` (source: ``csrc/lora_matmul.cu``);
neither writes the dequantized weight. Their plain versions are
:func:`repro_torch.kernels.ref.lora_matmul` and
:func:`repro_torch.kernels.ref.quant_matmul_t`; ``kernels.ops`` takes
those for tensors on the CPU and puts both kernels behind the op's
``autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import check_qtensor

MAX_RANK = 32
_P = ctypes.c_void_p
_I = ctypes.c_int
_LORA_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
              ctypes.c_float, _I, _P)
_T_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)


def _factor(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"LoRA {name} {tuple(t.shape)}, expected {shape}")
    return t.to(torch.float32).contiguous()


def lora_matmul(x: torch.Tensor, qt: QTensor, a: torch.Tensor,
                b: torch.Tensor, *, scale: float) -> torch.Tensor:
    """``x (..., K) @ dequant(qt (Kq, N)) + scale·(x@A)@B -> (..., N)``;
    ``a`` (K, r), ``b`` (r, N). ``qt`` may cover a K zero-padded to a
    block multiple (the odd-K contract). fp32 accumulation, output in
    x's dtype."""
    fmt, G, rows, N = check_qtensor(x, qt, "lora_matmul", ndims=(3,))
    K = x.shape[-1]
    Kq = G * qt.block
    if Kq < K or (Kq - K) >= qt.block:
        raise ValueError(f"quantized contraction dim {Kq} incompatible with "
                         f"x's {K} (block {qt.block})")
    r = a.shape[-1]
    if r > MAX_RANK:
        raise NotImplementedError(f"lora_matmul kernel: rank {r} > "
                                  f"{MAX_RANK}")
    a32 = _factor(a, (K, r), "A")
    b32 = _factor(b, (r, N), "B")
    if a32.device != x.device or b32.device != x.device:
        raise ValueError("lora_matmul kernel needs A and B on x's device")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = build.function("lora_matmul", "lora_matmul_launch", _LORA_ARGS)
    build.check(fn(x2.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(),
                   a32.data_ptr(), b32.data_ptr(), y.data_ptr(), M, K, Kq,
                   N, r, qt.block, rows, fmt, float(scale),
                   int(x.dtype == torch.bfloat16),
                   torch.cuda.current_stream(x.device).cuda_stream),
                "lora_matmul")
    lora_matmul.launches += 1
    return y.reshape(*lead, N)


def quant_matmul_t(g: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``g (..., N) @ dequant(qt (Kq, N))ᵀ -> (..., Kq)``, fp32
    accumulation, output in g's dtype. The output covers the padded Kq;
    callers slice ``[..., :K]``."""
    fmt, G, rows, N = check_qtensor(g, qt, "quant_matmul_t", ndims=(3,))
    if g.shape[-1] != N:
        raise ValueError(f"contraction dim {g.shape[-1]} != quantized N {N}")
    Kq = G * qt.block
    lead = g.shape[:-1]
    g2 = g.reshape(-1, N).contiguous()
    M = g2.shape[0]
    o = torch.empty((M, Kq), dtype=g.dtype, device=g.device)
    fn = build.function("lora_matmul", "quant_matmul_t_launch", _T_ARGS)
    build.check(fn(g2.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(),
                   o.data_ptr(), M, Kq, N, qt.block, rows, fmt,
                   int(g.dtype == torch.bfloat16),
                   torch.cuda.current_stream(g.device).cuda_stream),
                "quant_matmul_t")
    quant_matmul_t.launches += 1
    return o.reshape(*lead, Kq)


lora_matmul.launches = 0
quant_matmul_t.launches = 0
