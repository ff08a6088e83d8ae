"""CUDA selective scan and its gradient, port of
``repro.kernels.selective_scan``.

``selective_scan(dt, x, Bm, Cm, A)`` runs the Mamba-1 recurrence from
h0 = 0 on the card (source: ``csrc/selective_scan.cu``) with the Pallas
kernel's layout: dt, x ``(B, S, di)``, Bm, Cm ``(B, S, N)``, A
``(di, N)``, all fp32; it returns ``(y (B, S, di), h_last (B, di, N))``.
Any S and di (the ragged edges are masked, where the Pallas kernel asserts
``di % block_d == 0`` and pads S), N up to 16. The plain version is
:func:`repro_torch.kernels.ref.selective_scan`.

``selective_scan_bwd(dt, x, Bm, Cm, A, gy, gh_last)`` is its gradient on
the card, the same function as the plain ``kernels.ops.selective_scan_bwd``
(the gradient of the plain scan; the JAX package has no Pallas backward):
``(ddt, dx, dB, dC, dA)``, dA None unless ``need_a``. It recomputes the
states in the block from checkpoints taken every ``BWD_CHUNK`` steps and
sums dB, dC and dA from per-block partials in a fixed order, so two calls
give the same bits. ``kernels.ops.selective_scan``'s
``autograd.Function`` dispatches to both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_N = 16
THREADS = 128         # threads of one block
FWD_LANES = 2         # the forward's lanes per channel (csrc's FWD_LANES)
BWD_CHANNELS = THREADS  # the backward runs one thread a channel
BWD_CHUNK = 8         # the backward's time chunk: states kept per chunk
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P,) * 7 + (_I,) * 4 + (_P,)
_BWD_ARGS = (_P,) * 15 + (_I,) * 5 + (_P,)


def padded_n(N: int) -> int:
    """The kernels' state count per channel: N padded to 4, 8 or 16."""
    return 4 if N <= 4 else 8 if N <= 8 else 16


def bwd_chunks(S: int) -> int:
    return -(-S // BWD_CHUNK)


def _check(ts, names, what):
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"{what} kernel needs {', '.join(names)} on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{what} kernel takes fp32, got "
                        f"{[str(t.dtype) for t in ts]}")


def _check_shapes(dt, x, Bm, Cm, A, what):
    if dt.ndim != 3 or x.shape != dt.shape or Bm.ndim != 3 or \
            Cm.shape != Bm.shape or Bm.shape[:2] != dt.shape[:2] or \
            A.shape != (dt.shape[2], Bm.shape[2]):
        raise ValueError(f"bad shapes dt {tuple(dt.shape)} x {tuple(x.shape)}"
                         f" Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} "
                         f"A {tuple(A.shape)}")
    B, S, di = dt.shape
    N = A.shape[1]
    if N > MAX_N:
        raise NotImplementedError(f"{what} kernel: N={N} > {MAX_N}")
    if min(B, S, di, N) < 1 or B > 65535:
        raise ValueError(f"{what} kernel: B={B} S={S} di={di} N={N}")
    return B, S, di, N


def selective_scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor) -> tuple:
    """dt, x: (B, S, di); Bm, Cm: (B, S, N); A: (di, N) -> (y, h_last)."""
    ts = (dt, x, Bm, Cm, A)
    _check(ts, ("dt", "x", "Bm", "Cm", "A"), "selective_scan")
    B, S, di, N = _check_shapes(dt, x, Bm, Cm, A, "selective_scan")
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


def selective_scan_bwd(dt, x, Bm, Cm, A, gy, gh_last=None, *,
                       need_a: bool = True) -> tuple:
    """The gradient of the scan for cotangents gy ``(B, S, di)`` and
    gh_last ``(B, di, N)`` (None: zero) -> ``(ddt, dx, dB, dC, dA)``, dA
    None unless ``need_a``. One launch of the backward kernel and one of
    its partial sums; the scratch (checkpoints and partials) is
    allocated here."""
    ts = (dt, x, Bm, Cm, A, gy) + (() if gh_last is None else (gh_last,))
    _check(ts, ("dt", "x", "Bm", "Cm", "A", "gy", "gh_last")[:len(ts)],
           "selective_scan_bwd")
    B, S, di, N = _check_shapes(dt, x, Bm, Cm, A, "selective_scan_bwd")
    if gy.shape != dt.shape or (gh_last is not None and
                                gh_last.shape != (B, di, N)):
        raise ValueError(f"bad cotangent shapes gy {tuple(gy.shape)} gh_last "
                         f"{None if gh_last is None else tuple(gh_last.shape)}")
    dt, x, Bm, Cm, A, gy = (t.contiguous() for t in ts[:6])
    if gh_last is not None:
        gh_last = gh_last.contiguous()
    dev, f32 = x.device, torch.float32
    K, GX, NP = bwd_chunks(S), -(-di // BWD_CHANNELS), padded_n(N)
    ck = torch.empty(((K - 1) * B * N * di,), dtype=f32, device=dev)
    part_bc = torch.empty((GX, B, S, 2 * NP), dtype=f32, device=dev)
    part_a = torch.empty((B, N, di), dtype=f32, device=dev) if need_a \
        else None
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    dB = torch.empty((B, S, N), dtype=f32, device=dev)
    dC = torch.empty((B, S, N), dtype=f32, device=dev)
    dA = torch.empty((di, N), dtype=f32, device=dev) if need_a else None
    ptr = lambda t: None if t is None or t.numel() == 0 else t.data_ptr()
    fn = build.function("selective_scan", "selective_scan_bwd_launch",
                        _BWD_ARGS)
    build.check(fn(*map(ptr, (dt, x, Bm, Cm, A, gy, gh_last, ck, part_bc,
                              part_a, ddt, dx, dB, dC, dA)),
                   B, S, di, N, int(need_a),
                   torch.cuda.current_stream(dev).cuda_stream),
                "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return ddt, dx, dB, dC, dA


selective_scan_bwd.launches = 0


def occupancy(which: str, N: int = MAX_N, need_a: bool = False) -> int:
    """Resident blocks per SM the ``"fwd"`` or ``"bwd"`` kernel achieves
    at its registers and shared memory (CUDA's occupancy calculator)."""
    fn = build.function("selective_scan", "selective_scan_occupancy",
                        (_I, _I, _I, ctypes.POINTER(_I)))
    out = _I(0)
    build.check(fn(int(which == "bwd"), N, int(need_a), ctypes.byref(out)),
                "selective_scan_occupancy")
    return out.value
