"""CUDA fused dequant-matmul, port of ``repro.kernels.quant_matmul``.

``quant_matmul(x, qt)`` computes ``x @ dequant(qt)`` on the card without
writing the dequantized weight (source: ``csrc/quant_matmul.cu``). A
stacked QTensor (q ``(T, G, ., N)``) contracts pairwise along its stack
axis in one launch: the serve plane's per-user head matrices. The plain
version is :func:`repro_torch.kernels.ref.quant_matmul`; ``kernels.ops``
takes it for tensors on the CPU.

Three routes, chosen here by :func:`route` and counted:
- ``"gemv"``: at most ``MAX_ROWS`` rows per user, N % 4 == 0 and a
  4-byte aligned payload (``gemv_kernel`` of ``csrc/gemv.cuh`` with the
  ``QmvOut`` epilogue: K split across a thread-block
  cluster by :func:`plan`, the partials summed through distributed
  shared memory in rank order; ``quant_matmul.gemv_launches``);
- ``"tc"``: any other bf16 call (``qmm_tc_kernel``: bf16 tensor cores,
  the row tile and split-K that :func:`plan_tc` picks;
  ``quant_matmul.tc_launches``);
- ``"tf32x3"``: any other fp32 call (``qmm_tf32_kernel`` of
  ``csrc/tf32_gemm.cuh``: 3xTF32 tensor cores, each weight decoded once
  a block into TF32 hi and lo tiles, chains of 4 k8 steps added in fp32,
  which keeps fp32 callers at 1e-5; the row tile and split-K that
  :func:`plan_tf32` picks; ``quant_matmul.tf32_launches``).
None stands in for another: a call the chosen kernel refuses raises.
The first fp32 design, ``qmm_kernel`` (fp32 CUDA cores, one 32 x 64
tile a block, no split), runs only when a caller forces ``"tiled"``
(the card's A/B); :func:`route_counts` reads every route's launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QTensor
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_TC_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_OCC_ARGS = (_I, _I, ctypes.POINTER(ctypes.c_int))
_FMT = {(8, "linear"): 0, (4, "linear"): 1, (4, "nf4"): 2}

# The GEMV's constants (csrc/gemv.cuh, GV_*): 128 threads a CTA,
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
    g1)``, as ``gemv_kernel`` computes them (``r G / c``)."""
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
    (else the tc or the tiled kernel, by dtype)."""
    return M <= MAX_ROWS and N % 4 == 0 and q.data_ptr() % 4 == 0


def route(M: int, N: int, q: torch.Tensor, dtype: torch.dtype) -> str:
    """The kernel a call with M rows a user, payload ``q`` and activation
    dtype ``dtype`` runs: ``"gemv"``, else ``"tc"`` for bf16 and
    ``"tf32x3"`` for fp32."""
    if takes_gemv(M, N, q):
        return "gemv"
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def route_counts() -> dict:
    """Every route's launches so far: the three routes' own counts and
    ``"tiled"``, the rest of ``launches`` (the first fp32 design, run
    only when forced)."""
    fn = quant_matmul
    out = {"gemv": fn.gemv_launches, "tc": fn.tc_launches,
           "tf32x3": fn.tf32_launches}
    out["tiled"] = fn.launches - sum(out.values())
    return out


# The tc route's tile (csrc/tc_tile.cuh, csrc/quant_matmul.cu namespace
# qtc): a block owns TC_BM x 128 outputs of one user and walks its split
# of K in 32-deep k-tiles; splits fall on multiples of lcm(block, 32), so
# every split owns whole quant groups and whole k-tiles. The cost model
# behind plan_tc() is fitted to the kernel's device times under every
# row tile and split count at the rows this route runs (M = 7, 256, 800,
# 6000; NF4 block 64; NVIDIA H100 80GB HBM3, 700 W;
# chip_smoke.qmm_tc_sweep, PERF.md): a launch costs TC_LAUNCH_US; at
# most TC_BLOCKS_PER_SM[bm] blocks of row tile bm are resident on an SM
# (registers), and with r of them resident a block takes TC_TILE_US[bm]
# = (a, b) as a + b r µs a k-tile; the split-K partials (fp32, written,
# read back, summed to bf16) move at TC_PARTIAL_BYTES_PER_US. Its pick is
# within 2% of the fastest measured plan at all seven shapes.
TC_BN, TC_BK = 128, 32
TC_ROW_TILES = (16, 64, 256)
TC_MIN_BLOCK = 16
TC_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
TC_MIN_TILES_PER_SPLIT = 2
TC_LAUNCH_US = 5.0
TC_TILE_US = {16: (0.45, 0.15), 64: (0.5, 0.2), 256: (1.15, 0.0)}
TC_BLOCKS_PER_SM = {16: 3, 64: 2, 256: 1}
TC_PARTIAL_BYTES_PER_US = 2.28e6


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """How a tensor-core route (tc, tf32x3) covers one call: for each of
    ``users`` users, ``tiles`` output tiles of ``bm`` x 128 times
    ``splits`` slices of the (padded) contraction, split z owning
    ``ranges[z] = (k0, k1)`` (multiples of ``unit``, as the kernels
    compute them)."""
    users: int
    bm: int
    tiles: int
    splits: int
    unit: int
    ranges: tuple

    @property
    def blocks(self) -> int:
        return self.users * self.tiles * self.splits


def split_ranges(Kq: int, unit: int, splits: int) -> tuple:
    """The (k0, k1) of each split, as ``qmm_tc_kernel`` computes them:
    split z owns units [z·nu/splits, (z+1)·nu/splits) of the ``nu =
    ceil(Kq / unit)`` units, the last cut at Kq."""
    nu = -(-Kq // unit)
    return tuple((z * nu // splits * unit,
                  min((z + 1) * nu // splits * unit, Kq))
                 for z in range(splits))


def tc_cost_us(T: int, M: int, Kq: int, N: int, block: int, bm: int,
               splits: int) -> float:
    """The model's time of one tc call: the launch, then the busiest SM
    runs ``ceil(blocks / (SMS · TC_BLOCKS_PER_SM[bm]))`` rounds of
    resident blocks, each a split's k-tiles at ``TC_TILE_US[bm]``, then
    the partials move."""
    unit = math.lcm(block, TC_BK)
    kt = -(-(-(-Kq // unit)) // splits) * unit // TC_BK
    blocks = T * -(-M // bm) * -(-N // TC_BN) * splits
    occ = TC_BLOCKS_PER_SM[bm]
    a, b = TC_TILE_US[bm]
    t = TC_LAUNCH_US + -(-blocks // (SMS * occ)) * kt * (
        a + b * min(occ, -(-blocks // SMS)))
    if splits > 1:
        t += (2 * splits + 0.5) * T * M * N * 4 / TC_PARTIAL_BYTES_PER_US
    return t


def tc_plans(T: int, M: int, Kq: int, N: int, block: int) -> list:
    """Every plan of the tc route for ``T`` users of ``M`` rows, a
    (padded) contraction of ``Kq`` quantized at ``block`` and N columns:
    each row tile with each split count of ``TC_SPLITS`` that leaves
    every split at least ``TC_MIN_TILES_PER_SPLIT`` k-tiles."""
    if block < TC_MIN_BLOCK or block & (block - 1) or Kq % block:
        raise NotImplementedError(
            f"quant_matmul tc route: block {block} is not a power of two "
            f">= {TC_MIN_BLOCK} dividing Kq {Kq}")
    unit = math.lcm(block, TC_BK)
    nu = -(-Kq // unit)
    out = []
    for bm in TC_ROW_TILES:
        for s in TC_SPLITS:
            if s > 1 and (nu < s or (nu // s) * unit // TC_BK
                          < TC_MIN_TILES_PER_SPLIT or T * s > 65535):
                break
            out.append(TcPlan(users=T, bm=bm,
                              tiles=-(-M // bm) * -(-N // TC_BN), splits=s,
                              unit=unit, ranges=split_ranges(Kq, unit, s)))
    return out


@functools.lru_cache(maxsize=None)
def plan_tc(T: int, M: int, Kq: int, N: int, block: int) -> TcPlan:
    """The row tile and split count of the tc route: of
    :func:`tc_plans`, the one :func:`tc_cost_us` finds least (ties to the
    fewer splits, then the larger tile)."""
    return min(tc_plans(T, M, Kq, N, block), key=lambda pl: (
        tc_cost_us(T, M, Kq, N, block, pl.bm, pl.splits), pl.splits, -pl.bm))


# The tf32x3 route's tile (csrc/tf32_gemm.cuh), shared with
# quant_matmul_t's fp32 route: a block owns a bm x 128 output tile of one
# user and walks its split of the contraction in 32-deep k-tiles. bm is
# 32 (two m16 rows) up to TF32_SMALL_ROWS rows a user, where the call
# reads W more than it multiplies (the MoE experts' 20 rows) and a second
# 32-row tile costs a second decode of W rather than 96 rows of zeros,
# and 128 past them. Where the output tiles do not fill the card's SMS,
# the contraction is split, one split more at a time, until the grid has
# SMS blocks, every split keeping TF32_MIN_TILES_PER_SPLIT k-tiles or
# more; splits fall on multiples of ``unit`` (lcm(block, 32) here: whole
# quant groups and whole k-tiles).
TF32_ROW_TILES = (32, 128)
TF32_SMALL_ROWS = 64
TF32_MIN_TILES_PER_SPLIT = 2
TF32_MAX_SPLITS = 64


@functools.lru_cache(maxsize=None)
def plan_tf32(T: int, M: int, C: int, O: int, unit: int) -> TcPlan:
    """The row tile and split count of a tf32x3 kernel for ``T`` users
    of ``M`` rows, a contraction of depth ``C`` and ``O`` output columns
    (``quant_matmul``: C = Kq, O = N; ``quant_matmul_t``: C = N, O = Kq),
    the splits on multiples of ``unit``."""
    bm = TF32_ROW_TILES[0] if M <= TF32_SMALL_ROWS else TF32_ROW_TILES[1]
    tiles = -(-M // bm) * -(-O // TC_BN)
    nu = -(-C // unit)
    splits = 1
    while T * tiles * splits < SMS:
        s = splits + 1
        if s > min(nu, TF32_MAX_SPLITS) or T * s > 65535 or \
                (nu // s) * unit // TC_BK < TF32_MIN_TILES_PER_SPLIT:
            break
        splits = s
    return TcPlan(users=T, bm=bm, tiles=tiles, splits=splits, unit=unit,
                  ranges=split_ranges(C, unit, splits))


def check_tc_block(block: int, op: str) -> None:
    """Raise unless ``block`` is a power of two >= 16, the quant blocks
    the tensor-core kernels take."""
    if block < TC_MIN_BLOCK or block & (block - 1):
        raise NotImplementedError(
            f"{op} tensor-core kernel: block {block} is not a power of "
            f"two >= {TC_MIN_BLOCK}")


def tf32_occupancy(op: str, fmt: int, bm: int) -> int:
    """Resident blocks an SM of a tf32x3 kernel (``op`` "quant_matmul"
    or "quant_matmul_t"; ``fmt`` 0 int8, else NF4) at row tile ``bm``,
    from its registers and shared memory (the card's occupancy query)."""
    lib, sym = {"quant_matmul": ("quant_matmul",
                                 "quant_matmul_tf32_occupancy"),
                "quant_matmul_t": ("lora_matmul",
                                   "quant_matmul_t_tf32_occupancy")}[op]
    out = ctypes.c_int(0)
    build.check(build.function(lib, sym, _OCC_ARGS)(fmt, bm,
                                                    ctypes.byref(out)),
                f"{op} tf32 occupancy")
    return out.value


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


def _quant_matmul(x, qt, gemv_plan, *, force=None, tc_plan=None,
                  tf32_plan=None):
    """:func:`quant_matmul` with the GEMV's plan forced to ``gemv_plan``,
    the tc route's to ``tc_plan`` or the tf32x3 route's to ``tf32_plan``
    (None: :func:`plan`'s, :func:`plan_tc`'s, :func:`plan_tf32`'s), for
    the checks and times of each plan; ``force="tiled"`` runs the first
    fp32 design, ``qmm_kernel``, on an fp32 or a bf16 x (the card's A/B
    against the tf32x3 and tc routes)."""
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
    how = route(M, N, q, x.dtype)
    if force is not None:
        if force != "tiled":
            raise ValueError(f"quant_matmul: only the tiled route can be "
                             f"forced, not {force!r}")
        how = force
    if gemv_plan is not None and how != "gemv":
        raise ValueError(f"quant_matmul: M={M}, N={N} takes the {how} "
                         "route, not the GEMV")
    if (tc_plan is not None and how != "tc") or (
            tf32_plan is not None and how != "tf32x3"):
        raise ValueError(f"quant_matmul: M={M}, N={N} takes the {how} "
                         "route, not the forced plan's")
    y = torch.empty((T, M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if how in ("tc", "tf32x3"):
        check_tc_block(qt.block, "quant_matmul")
        if how == "tc":
            pl = tc_plan or plan_tc(T, M, Kq, N, qt.block)
        else:
            pl = tf32_plan or plan_tf32(T, M, Kq, N,
                                        math.lcm(qt.block, TC_BK))
        ws = torch.empty((pl.splits, T, M, N), dtype=torch.float32,
                         device=x.device) if pl.splits > 1 else None
        fn = build.function("quant_matmul", {
            "tc": "quant_matmul_tc_launch",
            "tf32x3": "quant_matmul_tf32_launch"}[how], _TC_ARGS)
        rc = fn(x3.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(), T, M, Kq, N,
                qt.block, rows, fmt, pl.bm, pl.splits, pl.unit, stream)
    else:
        gemv = how == "gemv"
        pl = (gemv_plan or plan(T, M, G, N)) if gemv else None
        fn = build.function("quant_matmul", "quant_matmul_launch", _ARGS)
        rc = fn(x3.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                T, M, Kq, N, qt.block, rows, fmt,
                int(x.dtype == torch.bfloat16),
                pl.cols if gemv else 0, pl.cluster if gemv else 0, stream)
    build.check(rc, "quant_matmul")
    quant_matmul.launches += 1
    quant_matmul.gemv_launches += int(how == "gemv")
    quant_matmul.tc_launches += int(how == "tc")
    quant_matmul.tf32_launches += int(how == "tf32x3")
    return y.reshape(out_shape)


quant_matmul.launches = 0
quant_matmul.gemv_launches = 0
quant_matmul.tc_launches = 0
quant_matmul.tf32_launches = 0
