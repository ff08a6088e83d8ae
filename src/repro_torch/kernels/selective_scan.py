"""CUDA selective scan, port of ``repro.kernels.selective_scan``.

``selective_scan(dt, x, Bm, Cm, A)`` runs the Mamba-1 recurrence from
h0 = 0 on the card (source: ``csrc/selective_scan.cu``) with the Pallas
kernel's layout: dt, x ``(B, S, di)``, Bm, Cm ``(B, S, N)``, A
``(di, N)``, all fp32; it returns ``(y (B, S, di), h_last (B, di, N))``.
Any S and di (the ragged edges are masked, where the Pallas kernel asserts
``di % block_d == 0`` and pads S), N up to 16. The plain version is
:func:`repro_torch.kernels.ref.selective_scan`; the gradient is
``kernels.ops.selective_scan``'s ``autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_N = 16
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)


def selective_scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor) -> tuple:
    """dt, x: (B, S, di); Bm, Cm: (B, S, N); A: (di, N) -> (y, h_last)."""
    ts = (dt, x, Bm, Cm, A)
    if not all(t.is_cuda and t.device == dt.device for t in ts):
        raise ValueError("selective_scan kernel needs dt, x, Bm, Cm, A on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("selective_scan kernel takes fp32, got "
                        f"{[str(t.dtype) for t in ts]}")
    if dt.ndim != 3 or x.shape != dt.shape or Bm.ndim != 3 or \
            Cm.shape != Bm.shape or Bm.shape[:2] != dt.shape[:2] or \
            A.shape != (dt.shape[2], Bm.shape[2]):
        raise ValueError(f"bad shapes dt {tuple(dt.shape)} x {tuple(x.shape)}"
                         f" Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} "
                         f"A {tuple(A.shape)}")
    B, S, di = dt.shape
    N = A.shape[1]
    if N > MAX_N:
        raise NotImplementedError(f"selective_scan kernel: N={N} > {MAX_N}")
    if min(B, S, di, N) < 1 or B > 65535:
        raise ValueError(f"selective_scan kernel: B={B} S={S} di={di} N={N}")
    dt, x, Bm, Cm, A = (t.contiguous() for t in ts)
    y = torch.empty_like(x)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=x.device)
    fn = build.function("selective_scan", "selective_scan_launch", _ARGS)
    build.check(fn(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                   A.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, di,
                   N, torch.cuda.current_stream(x.device).cuda_stream),
                "selective_scan")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
