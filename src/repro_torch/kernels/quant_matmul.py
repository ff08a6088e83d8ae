"""CUDA fused dequant-matmul, port of ``repro.kernels.quant_matmul``.

``quant_matmul(x, qt)`` computes ``x @ dequant(qt)`` on the card without
writing the dequantized weight (source: ``csrc/quant_matmul.cu``). A
stacked QTensor (q ``(T, G, ., N)``) contracts pairwise along its stack
axis in one launch: the serve plane's per-user head matrices. The plain
version is :func:`repro_torch.kernels.ref.quant_matmul`; ``kernels.ops``
takes it for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QTensor
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_FMT = {(8, "linear"): 0, (4, "linear"): 1, (4, "nf4"): 2}


def check_qtensor(x: torch.Tensor, qt: QTensor, op: str, ndims=(3, 4)):
    """The checks every quantized-weight kernel makes before it launches:
    ``x`` and the payload on one CUDA device, f32/bf16 ``x``, a supported
    format with contiguous payload and scales of the right shapes.
    Returns ``(fmt, G, rows, N)``."""
    q, s = qt.q, qt.scales
    if not (x.is_cuda and q.device == x.device and s.device == x.device):
        raise ValueError(f"{op} kernel needs its input, q and scales on one "
                         f"CUDA device, got {x.device}/{q.device}/{s.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{op} kernel takes f32/bf16 input, got {x.dtype}")
    fmt = _FMT.get((qt.bits, qt.mode))
    want_q = torch.int8 if qt.bits == 8 else torch.uint8
    if fmt is None or q.dtype != want_q or s.dtype != torch.float32:
        raise TypeError(f"unsupported QTensor: bits={qt.bits} mode={qt.mode} "
                        f"q {q.dtype} scales {s.dtype}")
    if q.ndim not in ndims:
        raise NotImplementedError(f"{op} kernel: q.ndim={q.ndim} (takes "
                                  f"{ndims})")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{op} kernel needs contiguous q and scales")
    G, rows, N = q.shape[-3:]
    if tuple(s.shape[-3:]) != (G, 1, N) or rows != (
            qt.block if qt.bits == 8 else qt.block // 2):
        raise ValueError(f"QTensor payload {tuple(q.shape)} / scales "
                         f"{tuple(s.shape)} disagree with block {qt.block}")
    return fmt, G, rows, N


def quant_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x: (..., K) @ dequant(qt (K, N)) -> (..., N); for a stacked ``qt``
    x is ``(T, ..., K)``. fp32 accumulation, output in x's dtype."""
    q, s = qt.q, qt.scales
    fmt, G, rows, N = check_qtensor(x, qt, "quant_matmul")
    T = q.shape[0] if q.ndim == 4 else 1
    Kq, K = G * qt.block, x.shape[-1]
    if Kq != K:
        if Kq < K or (Kq - K) >= qt.block:
            raise ValueError(
                f"quantized contraction dim {Kq} incompatible with "
                f"x's {K} (block {qt.block})")
        x = F.pad(x, (0, Kq - K))
    if q.ndim == 4 and x.shape[0] != T:
        raise ValueError(f"stacked quant_matmul needs matching stack dims: "
                         f"x {tuple(x.shape)} vs q {tuple(q.shape)}")
    out_shape = (*x.shape[:-1], N)
    x3 = x.reshape(T, -1, Kq).contiguous()
    M = x3.shape[1]
    y = torch.empty((T, M, N), dtype=x.dtype, device=x.device)
    fn = build.function("quant_matmul", "quant_matmul_launch", _ARGS)
    build.check(fn(x3.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                   T, M, Kq, N, qt.block, rows, fmt,
                   int(x.dtype == torch.bfloat16),
                   torch.cuda.current_stream(x.device).cuda_stream),
                "quant_matmul")
    quant_matmul.launches += 1
    return y.reshape(out_shape)


quant_matmul.launches = 0
