"""CUDA fused dequant-matmul, port of ``repro.kernels.quant_matmul``.

``quant_matmul(x, qt)`` computes ``x @ dequant(qt)`` on the card without
writing the dequantized weight (source: ``csrc/quant_matmul.cu``). A
stacked QTensor (q ``(T, G, ., N)``) contracts pairwise along its stack
axis in one launch: the serve plane's per-user head matrices. The plain
version is :func:`repro_torch.kernels.ref.quant_matmul`; ``kernels.ops``
takes it for tensors on the CPU.

Two routes, chosen here and counted: a call with at most ``MAX_ROWS``
rows per user, N % 4 == 0 and a 4-byte aligned payload runs the GEMV
(``qmv_kernel``: K split across a thread-block cluster by :func:`plan`,
the partials summed through distributed shared memory in rank order;
``quant_matmul.gemv_launches`` counts it); any other call runs the
tiled ``qmm_kernel``. Neither stands in for the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QTensor
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_FMT = {(8, "linear"): 0, (4, "linear"): 1, (4, "nf4"): 2}

# The GEMV's constants (csrc/quant_matmul.cu, GV_*): 128 threads a CTA,
# 16 columns a thread (one 16-byte load of a code row), at most 12 CTAs
# a cluster (the largest size run on the card; more than 8 is a
# non-portable size). The plan's rule comes from the kernel's times
# under every plan at the serve shape with 1, 4 and 8 users on an
# NVIDIA H100 80GB HBM3 (700 W; scripts/torch_serve_kernels_ab.py
# --sweep, PERF.md): 128-column tiles (128-byte code rows) beat 64 and
# 256 at every user count, and the fastest cluster was the largest that
# kept the launch within about 3 CTAs an SM (576 CTAs ran 1.4-1.8x
# slower).
SMS = 132
MAX_ROWS = 4
THREADS = 128
COLS_PER_THREAD = 16
CLUSTER_MAX = 12
TILE_COLS = (64, 128)
MAX_CTAS = 3 * SMS


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """How the GEMV covers one call: ``tiles`` column tiles of ``cols``
    columns for each of ``users`` users, each tile a cluster of
    ``cluster`` CTAs, rank r owning quant groups ``groups[r] = (g0,
    g1)``, as ``qmv_kernel`` computes them (``r G / c``)."""
    users: int
    cols: int
    tiles: int
    cluster: int
    groups: tuple

    @property
    def ctas(self) -> int:
        return self.users * self.tiles * self.cluster


def group_ranges(G: int, c: int) -> tuple:
    return tuple((r * G // c, (r + 1) * G // c) for r in range(c))


@functools.lru_cache(maxsize=None)
def plan(T: int, M: int, G: int, N: int) -> GemvPlan:
    """The GEMV's column tile and cluster size for ``T`` users of ``M <=
    MAX_ROWS`` rows, ``G`` quant groups along K and N columns: 128-column
    tiles (64 for N <= 64), and the largest cluster size that divides G
    (every rank takes as many groups), stays within ``CLUSTER_MAX`` and
    keeps the launch within ``MAX_CTAS`` (1 if none does). M does not
    enter: the rows of a user share every code load."""
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"the GEMV takes 1-{MAX_ROWS} rows a user, got {M}")
    cols = TILE_COLS[0] if N <= TILE_COLS[0] else TILE_COLS[1]
    tiles = -(-N // cols)
    c = max(d for d in range(1, min(G, CLUSTER_MAX) + 1)
            if G % d == 0 and (d == 1 or T * tiles * d <= MAX_CTAS))
    return GemvPlan(users=T, cols=cols, tiles=tiles, cluster=c,
                    groups=group_ranges(G, c))


def gemv_smem_bytes(pl: GemvPlan, M: int, G: int, block: int) -> int:
    """Dynamic shared memory of one GEMV CTA under ``pl`` (the kernel's
    own count: partials, x's K slice and the slice's scales)."""
    fn = build.function("quant_matmul", "quant_matmul_gemv_smem", (_I,) * 5)
    return fn(M, G * block, block, pl.cols, pl.cluster)


def takes_gemv(M: int, N: int, q: torch.Tensor) -> bool:
    """Whether a call with M rows a user and payload ``q`` runs the GEMV
    (else the tiled kernel)."""
    return M <= MAX_ROWS and N % 4 == 0 and q.data_ptr() % 4 == 0


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
    return _quant_matmul(x, qt, None)


def _quant_matmul(x, qt, gemv_plan):
    """:func:`quant_matmul` with the GEMV's plan forced to ``gemv_plan``
    (None: :func:`plan`'s), for the checks and times of each plan."""
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
    gemv = takes_gemv(M, N, q)
    if gemv_plan is not None and not gemv:
        raise ValueError(f"quant_matmul: M={M}, N={N} takes the tiled "
                         "kernel, not the GEMV")
    pl = (gemv_plan or plan(T, M, G, N)) if gemv else None
    y = torch.empty((T, M, N), dtype=x.dtype, device=x.device)
    fn = build.function("quant_matmul", "quant_matmul_launch", _ARGS)
    build.check(fn(x3.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                   T, M, Kq, N, qt.block, rows, fmt,
                   int(x.dtype == torch.bfloat16),
                   pl.cols if gemv else 0, pl.cluster if gemv else 0,
                   torch.cuda.current_stream(x.device).cuda_stream),
                "quant_matmul")
    quant_matmul.launches += 1
    quant_matmul.gemv_launches += int(gemv)
    return y.reshape(out_shape)


quant_matmul.launches = 0
quant_matmul.gemv_launches = 0
