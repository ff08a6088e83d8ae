"""CUDA fused LoRA linear and its dx gemm, port of
``repro.kernels.lora_matmul``.

``lora_matmul(x, qt, a, b, scale=s)`` computes ``x @ dequant(qt) +
s·(x@A)@B`` in one launch (a bf16 call with split K adds a second,
``splitk_sum``) and ``quant_matmul_t(g, qt)`` computes ``g @
dequant(qt)ᵀ`` over the padded ``Kq`` (source: ``csrc/lora_matmul.cu``);
neither writes the dequantized weight. Their plain versions are
:func:`repro_torch.kernels.ref.lora_matmul` and
:func:`repro_torch.kernels.ref.quant_matmul_t`; ``kernels.ops`` takes
those for tensors on the CPU and puts both kernels behind the op's
``autograd.Function``.

``lora_matmul`` has three routes, chosen here by :func:`route` and
counted:
- ``"gemv"``: at most ``MAX_ROWS`` rows (a decode step's tokens), bf16
  or fp32 x (``csrc/lora_gemv.cu``: h = x@A in one small launch, then
  the serve GEMV's cluster split-K over the quantized W with s·h@B added
  by each column tile's leader; :func:`plan_gemv`;
  ``lora_matmul.gemv_launches``);
- ``"tc"``: any other bf16 call (``lora_matmul_tc_launch`` with the
  split-K that :func:`plan` picks; ``lora_matmul.tc_launches``);
- ``"tf32x3"``: any other fp32 call (``lora_tf32_kernel``,
  ``csrc/tf32_gemm.cuh``'s 3xTF32 body with the rank-r term beside it:
  h = x@A in the same chains as x@W, kept in shared memory, then
  scale·(h@B) added in fp32, at 1e-5; the split-K that
  :func:`plan_lora_tf32` picks; ``lora_matmul.tf32_launches``).
The first fp32 design, ``lora_kernel`` (fp32 CUDA cores, no split),
runs only when a caller forces ``"tiled"`` (the card's A/B);
:func:`route_counts` reads every route's launches.
``quant_matmul_t`` has two, by g's dtype (:func:`qmt_route`): bf16
``"tc"``, the bf16 tensor-core kernel (``quant_matmul_t_tc_launch`` with
the split over N that :func:`plan_t` picks; ``tc_launches``); fp32
``"tf32x3"``, ``qmt_tf32_kernel`` (``csrc/tf32_gemm.cuh``, shared with
``quant_matmul``'s fp32 route: 3xTF32 tensor cores, W decoded once a
block into TF32 hi and lo tiles, chains of 4 k8 steps added in fp32, at
1e-5; the row tile and split over N that :func:`plan_t_tf32` picks;
``tf32_launches``). The first fp32 design, ``qmt_kernel`` (fp32 CUDA
cores, no split), runs only when a caller forces ``"tiled"`` (the card's
A/B). No route stands in for another: an input the chosen kernel refuses
raises, and the tc route runs at decode rows only when a caller forces
it (the card's A/B).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import (TF32_MAX_SPLITS,
                                              TF32_MIN_TILES_PER_SPLIT,
                                              GemvPlan, TcPlan,
                                              check_qtensor, check_tc_block,
                                              group_ranges, plan_tf32)

MAX_RANK = 32
_P = ctypes.c_void_p
_I = ctypes.c_int
_LORA_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
              ctypes.c_float, _P)
_TC_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, _I, _I, _P)
_TF32_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
              ctypes.c_float, _I, _I, _P)
_OCC_ARGS = (_I, _I, ctypes.POINTER(ctypes.c_int))
_T_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_T_TC_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_GEMV_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
              _I, _I, _I, ctypes.c_float, _P)

# The tensor-core kernel's tile (csrc/lora_matmul.cu, namespace lt) and
# the cost model behind plan(), fitted to the kernel's times on an NVIDIA
# H100 80GB HBM3 (700 W) at the four Yi-9B shapes and split counts 1-16
# (PERF.md, PR 14; chip_smoke.py prints the planned count's time): one
# block (16 warps, 140-160 KB of shared memory) runs per SM and takes
# TILE_US per 256 x 128 x 32 tile, and the split-K partials (fp32,
# written, read back, summed to bf16) move at PARTIAL_BYTES_PER_US.
SMS = 132
BM, BN, BK = 256, 128, 32
SPLITS = (1, 2, 3, 4, 8, 16, 32)
MIN_TILES_PER_SPLIT = 4
TILE_US = 2.05
PARTIAL_BYTES_PER_US = 2.28e6
# quant_matmul_t's tensor-core kernel (namespace qmt): the same 256 x 128
# output tile and 32-deep k-tiles, the contraction along N, in the same
# model with its own constants, fitted to its times at split counts 1-16
# on the four Yi-9B shapes on the same card (PERF.md; chip_smoke.py
# prints them): within 5% of every time but wk/wv's at 1-2 splits
T_TILE_US = 1.77
T_PARTIAL_BYTES_PER_US = 2.7e6


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a tensor-core kernel covers one call: a grid of ``tiles``
    output tiles (BM x BN) times ``splits`` slices of the (padded)
    contraction dim, split z owning ``ranges[z] = (k0, k1)``; the ranges
    fall on multiples of ``unit`` (for ``lora_matmul`` lcm(block, BK):
    whole quant groups, whole k-tiles; for ``quant_matmul_t`` one k-tile
    of N) and cover the contraction once, in order."""
    tiles: int
    splits: int
    unit: int
    ranges: tuple

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits


def plan_cost_us(M: int, N: int, tiles: int, tiles_per_split: int,
                 splits: int, tile_us: float = TILE_US,
                 partial_rate: float = PARTIAL_BYTES_PER_US) -> float:
    """The model's time of one call with an (M, N) output: the busiest
    SM runs ``ceil(blocks / SMS)`` blocks one after another, then the
    partials move at ``partial_rate`` bytes per µs."""
    t = -(-tiles * splits // SMS) * tiles_per_split * tile_us
    if splits > 1:
        t += (2 * splits * M * N * 4 + M * N * 2) / partial_rate
    return t


def plan(M: int, K: int, N: int, block: int, *, granule: int = 0,
         tile_us: float = TILE_US,
         partial_rate: float = PARTIAL_BYTES_PER_US) -> Plan:
    """The split count for a contraction of depth K, padded to a
    multiple of ``block``, into an (M, N) output (``lora_matmul``:
    ``x (M, K) @ W (K, N)`` quantized at ``block``): the fewest of
    ``SPLITS`` whose modelled time (:func:`plan_cost_us` at ``tile_us``
    and ``partial_rate``) is within 2% of the least, and none that
    leaves a split fewer than 4 k-tiles. Splits fall on multiples of
    ``granule`` (default lcm(block, BK)). The ranges are those the
    kernels compute from (splits, unit)."""
    Kq = -(-K // block) * block
    unit = granule or math.lcm(block, BK)
    nu = -(-Kq // unit)
    tiles = -(-M // BM) * -(-N // BN)
    cost = {}
    for s in SPLITS:
        if s > 1 and (nu < s or (nu // s) * unit // BK < MIN_TILES_PER_SPLIT):
            break
        cost[s] = plan_cost_us(M, N, tiles, -(-nu // s) * unit // BK, s,
                               tile_us, partial_rate)
    least = min(cost.values())
    best = min(s for s, c in cost.items() if c <= 1.02 * least)
    return Plan(tiles=tiles, splits=best, unit=unit,
                ranges=split_ranges(Kq, unit, best))


def plan_t(M: int, Kq: int, N: int) -> Plan:
    """The split over N of ``quant_matmul_t``'s tensor-core kernel for
    ``g (M, N) @ W (Kq, N)ᵀ``: :func:`plan` with the contraction N
    (nothing to pad: N carries no quant group), the output (M, Kq), the
    granule one 32-wide k-tile and the kernel's own constants."""
    return plan(M, N, Kq, 1, granule=BK, tile_us=T_TILE_US,
                partial_rate=T_PARTIAL_BYTES_PER_US)


def plan_t_tf32(M: int, Kq: int, N: int):
    """The row tile and split over N of ``quant_matmul_t``'s tf32x3
    kernel for ``g (M, N) @ W (Kq, N)ᵀ``: ``quant_matmul.plan_tf32`` with
    the contraction N, the output columns Kq and the granule one 32-wide
    k-tile (a ``quant_matmul.TcPlan``)."""
    return plan_tf32(1, M, N, Kq, BK)


# The tf32x3 route's tile (csrc/lora_matmul.cu namespace ltf, the body of
# csrc/tf32_gemm.cuh): a block owns a 128 x 128 output tile (the paths'
# fp32 calls are 256 rows) and walks its split of K in 32-deep k-tiles;
# one block an SM (152-172 KB of shared memory, 255 registers). The
# split count is the one of least modelled time (lora_tf32_cost_us): the
# busiest SM runs ceil(blocks / SMS) waves of one block, each a split's
# k-tiles at LORA_TF32_TILE_US, then the (splits, M, N) fp32 partials
# are written and summed at the tc kernel's PARTIAL_BYTES_PER_US. The
# tile time was fitted to the kernel's device times at split counts 1-4
# (and the pick) at the paths' six 256-row shapes (NF4 block 64, r = 16;
# an NVIDIA H100 80GB HBM3 at 700 W; PERF.md row 4g;
# chip_smoke.check_fp32_gemms prints them): the model is within 5% of
# every time but wk/wv's 16 splits (14% under), and its pick the fastest
# count at each, where filling one wave and no more ran Yi-9B's wg/wu
# (172 tiles, two waves) 40% slower than its 3 splits.
LORA_TF32_BM = 128
LORA_TF32_TILE_US = 3.43


def lora_tf32_cost_us(M: int, N: int, tiles: int, nu: int, unit: int,
                      splits: int) -> float:
    """The model's time of one tf32x3 call with an (M, N) output and
    ``tiles`` output tiles, K in ``nu`` units of ``unit``, cut into
    ``splits``."""
    t = -(-tiles * splits // SMS) * (-(-nu // splits) * unit // BK) * \
        LORA_TF32_TILE_US
    if splits > 1:
        t += (2 * splits + 1) * M * N * 4 / PARTIAL_BYTES_PER_US
    return t


@functools.lru_cache(maxsize=None)
def plan_lora_tf32(M: int, K: int, N: int, block: int) -> TcPlan:
    """The split-K of ``lora_matmul``'s tf32x3 route for ``x (M, K) @
    W (K, N)`` quantized at ``block`` (K padded to a multiple of it): of
    the split counts up to ``TF32_MAX_SPLITS`` that leave every split
    ``TF32_MIN_TILES_PER_SPLIT`` k-tiles or more, on multiples of
    lcm(block, 32), the least :func:`lora_tf32_cost_us` (ties to fewer
    splits); a ``quant_matmul.TcPlan``."""
    Kq = -(-K // block) * block
    unit = math.lcm(block, BK)
    nu = -(-Kq // unit)
    tiles = -(-M // LORA_TF32_BM) * -(-N // BN)
    counts = [s for s in range(1, min(nu, TF32_MAX_SPLITS) + 1)
              if s == 1 or (nu // s) * unit // BK >= TF32_MIN_TILES_PER_SPLIT]
    splits = min(counts, key=lambda s: (
        lora_tf32_cost_us(M, N, tiles, nu, unit, s), s))
    return TcPlan(users=1, bm=LORA_TF32_BM, tiles=tiles, splits=splits,
                  unit=unit, ranges=split_ranges(Kq, unit, splits))


def tf32_occupancy(fmt: int, rp: int) -> int:
    """Resident blocks an SM of ``lora_tf32_kernel`` (``fmt`` 0 int8,
    else NF4; rank padded to ``rp``, 16 or 32) from its registers and
    shared memory (the card's occupancy query)."""
    out = ctypes.c_int(0)
    build.check(build.function("lora_matmul", "lora_matmul_tf32_occupancy",
                               _OCC_ARGS)(fmt, rp, ctypes.byref(out)),
                "lora_matmul tf32 occupancy")
    return out.value


def split_ranges(Kq: int, unit: int, splits: int) -> tuple:
    """The (k0, k1) of each split of a contraction of depth Kq, as
    ``lora_tc_kernel`` and ``qmt_tc_kernel`` compute them: split z owns
    units [z·nu/splits, (z+1)·nu/splits) of the ``nu = ceil(Kq / unit)``
    units, the last one cut at Kq."""
    nu = -(-Kq // unit)
    return tuple((z * nu // splits * unit,
                  min((z + 1) * nu // splits * unit, Kq))
                 for z in range(splits))


# The decode route (csrc/lora_gemv.cu, the GEMV of csrc/gemv.cuh): 128
# threads a CTA, 16 columns a thread, K split over a cluster of at most
# GEMV_CLUSTER_MAX CTAs (the portable size), at most GEMV_MAX_CTAS a
# launch; rows up to the kernel's template bound (1, 2, 4, 8); x@A in
# chunks of H_CHUNK rows of K (at most H_CHUNKS_MAX). plan_gemv's rule
# comes from the GEMV's device times under every plan at the decode
# steps' linears (Yi-9B, LLaVA-NeXT-34B, Kimi-K2's wq; 4 and 8 rows; an
# NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.check_lora_decode prints
# them, PERF.md): the faster plans ran in one wave of CTAs, the SM
# holding GEMV_CTAS_PER_SM of them (registers: chip_smoke.setup prints
# them by row bound; 3 is the 4-row instance's, taken for fewer rows too)
# or as many as its shared memory
# (GEMV_SMEM_SM, 1 KB a block reserved) holds; where no plan of
# 128-column tiles fits one wave, the fewest waves times groups a CTA
# streams. MAX_ROWS is the crossover against the tc route measured on
# the card (PERF.md).
MAX_ROWS = 8
GEMV_ROW_BOUNDS = (1, 2, 4, 8)
GEMV_THREADS = 128
GEMV_COLS_PER_THREAD = 16
GEMV_TILE_COLS = (64, 128)
GEMV_CLUSTER_MAX = 8
GEMV_MAX_CTAS = 6 * SMS
GEMV_SMEM_MAX = 232448          # the card's dynamic shared memory a block
GEMV_SMEM_SM = 233472           # ... an SM
GEMV_CTAS_PER_SM = {1: 3, 2: 3, 4: 3, 8: 2}   # by registers, per row bound
H_ROWS, H_LANES, H_COLS, H_CHUNK, H_CHUNKS_MAX = 8, 8, 32, 256, 128
H_STAGE_MAX = 49152          # x's chunk in the x@A launch's shared memory


def gemv_row_bound(M: int) -> int:
    """The kernel's template bound on the rows (its MR) for M rows."""
    return next(mr for mr in GEMV_ROW_BOUNDS if M <= mr)


def h_chunks(K: int) -> int:
    """The chunks of K that the x@A launch sums (``h_chunks``)."""
    return min(-(-K // H_CHUNK), H_CHUNKS_MAX)


def gemv_smem_bytes(M: int, G: int, block: int, cols: int,
                    cluster: int) -> int:
    """Dynamic shared memory of one GEMV CTA (``lora_gemv_smem``): the
    ranks' slots, x's K slice with its scales (the row lanes' partials
    reuse their buffer) and h."""
    mr = gemv_row_bound(M)
    gmax = -(-G // cluster)
    kxp = (gmax * block + 3) & ~3
    work = max(GEMV_THREADS * mr * GEMV_COLS_PER_THREAD,
               mr * kxp + gmax * cols)
    return 4 * (cluster * mr * cols + work + H_ROWS * H_COLS)


def gemv_plans(M: int, G: int, N: int, block: int) -> list:
    """Every ``(cols, cluster)`` the GEMV takes for M rows, G quant groups
    of ``block`` and N columns: each column tile, each cluster size up to
    ``GEMV_CLUSTER_MAX`` and G (rank r of c owns groups [r G / c, (r + 1)
    G / c)), a launch within ``GEMV_MAX_CTAS`` unless one CTA a tile,
    whose shared memory fits (none where the x@A launch's chunk of x
    would not)."""
    K = G * block
    if 4 * M * -(-K // h_chunks(K)) > H_STAGE_MAX:
        return []
    out = []
    for cols in GEMV_TILE_COLS:
        tiles = -(-N // cols)
        for c in range(1, min(G, GEMV_CLUSTER_MAX) + 1):
            if c > 1 and tiles * c > GEMV_MAX_CTAS:
                continue
            if gemv_smem_bytes(M, G, block, cols, c) <= GEMV_SMEM_MAX:
                out.append((cols, c))
    return out


def gemv_waves(M: int, G: int, N: int, block: int, cols: int,
               cluster: int) -> int:
    """The waves of CTAs a GEMV launch takes: its CTAs over the SMs'
    CTAs (``GEMV_CTAS_PER_SM`` by registers, fewer where shared memory
    holds fewer)."""
    smem = gemv_smem_bytes(M, G, block, cols, cluster) + 1024
    per_sm = min(GEMV_CTAS_PER_SM[gemv_row_bound(M)], GEMV_SMEM_SM // smem)
    return -(-(-(-N // cols) * cluster) // (SMS * per_sm))


@functools.lru_cache(maxsize=None)
def plan_gemv(M: int, G: int, N: int, block: int):
    """The GEMV's column tile and cluster (a ``quant_matmul.GemvPlan`` of
    one user) for M rows: of :func:`gemv_plans` with 128-column tiles (64
    for N <= 64), the largest cluster whose launch takes one wave
    (:func:`gemv_waves`), else the fewest waves times quant groups a CTA
    streams (ties to fewer CTAs); where the launch has fewer CTAs than
    the card has SMs, the plan with the most CTAs in one wave (the
    64-column tiles of a narrow N). None where no plan fits."""
    plans = gemv_plans(M, G, N, block)
    if not plans:
        return None
    ctas = lambda pc: -(-N // pc[0]) * pc[1]
    waves = lambda pc: gemv_waves(M, G, N, block, *pc)
    cols = GEMV_TILE_COLS[0] if N <= GEMV_TILE_COLS[0] else \
        GEMV_TILE_COLS[1]
    mine = [pc for pc in plans if pc[0] == cols]
    one = [pc for pc in mine if waves(pc) == 1]
    if one:
        pick = max(one, key=lambda pc: pc[1])
    elif mine:
        pick = min(mine, key=lambda pc: (waves(pc) * -(-G // pc[1]),
                                         ctas(pc)))
    else:
        pick = None
    if pick is None or ctas(pick) < SMS:
        pick = max((pc for pc in plans if waves(pc) == 1),
                   key=lambda pc: (ctas(pc), pc[0], pc[1]), default=pick)
    return gemv_plan_of(G, N, *pick)


def gemv_plan_of(G: int, N: int, cols: int, cluster: int):
    """The ``quant_matmul.GemvPlan`` of one user for ``(cols, cluster)``."""
    return GemvPlan(users=1, cols=cols, tiles=-(-N // cols),
                    cluster=cluster, groups=group_ranges(G, cluster))


def route(M: int, N: int, qt: QTensor, dtype: torch.dtype) -> str:
    """The kernel a call with M rows of ``dtype`` against ``qt`` runs:
    ``"gemv"`` at most ``MAX_ROWS`` rows with N % 4 == 0, a 4-byte aligned
    payload and a plan that fits; else ``"tc"`` for bf16, ``"tf32x3"``
    for fp32."""
    G = qt.q.shape[-3]
    if M <= MAX_ROWS and N % 4 == 0 and qt.q.data_ptr() % 4 == 0 and \
            plan_gemv(M, G, N, qt.block) is not None:
        return "gemv"
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def route_counts() -> dict:
    """``lora_matmul``'s launches so far by route: the three routes'
    own counts and ``"tiled"``, the rest (the first fp32 design, run only
    when forced)."""
    fn = lora_matmul
    out = {"gemv": fn.gemv_launches, "tc": fn.tc_launches,
           "tf32x3": fn.tf32_launches}
    out["tiled"] = fn.launches - sum(out.values())
    return out


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
    return _lora_matmul(x, qt, a, b, scale, None)


def _lora_matmul(x, qt, a, b, scale, splits, *, force=None,
                 gemv_plan=None):
    """:func:`lora_matmul` with the tc or tf32x3 route's split count
    forced to ``splits`` or the GEMV's plan to ``gemv_plan`` (None:
    :func:`plan`'s, :func:`plan_lora_tf32`'s, :func:`plan_gemv`'s), for
    the checks and times of each; ``force="tc"`` runs the bf16
    tensor-core kernel at the GEMV's rows too, ``force="tiled"`` the first
    fp32 design, ``lora_kernel``, on an fp32 x (the card's A/Bs)."""
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
    how = route(M, N, qt, x.dtype)
    if force is not None:
        if force != {torch.bfloat16: "tc"}.get(x.dtype, "tiled"):
            raise ValueError(f"lora_matmul: only the tc route (a bf16 x) or "
                             f"the tiled one (an fp32 x) can be forced, not "
                             f"{force!r} for a {x.dtype} x")
        how = force
    if (splits is not None and how not in ("tc", "tf32x3")) or (
            gemv_plan is not None and how != "gemv"):
        raise ValueError(f"lora_matmul: M={M}, N={N} takes the {how} route")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if how == "gemv":
        pl = gemv_plan or plan_gemv(M, G, N, qt.block)
        # the kernel's rows (its row bound) and the payload's pad rows of
        # K: zero
        mr = gemv_row_bound(M)
        if Kq != K or mr != M:
            x2 = torch.nn.functional.pad(x2, (0, Kq - K, 0, mr - M))
        hpart = torch.empty(h_chunks(K) * M * r, dtype=torch.float32,
                            device=x.device)
        fn = build.function("lora_gemv", "lora_gemv_launch", _GEMV_ARGS)
        rc = fn(x2.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(),
                a32.data_ptr(), b32.data_ptr(), y.data_ptr(),
                hpart.data_ptr(), M, K, Kq, N, r, qt.block, rows, fmt,
                int(x.dtype == torch.bfloat16), pl.cols, pl.cluster,
                float(scale), stream)
    elif how == "tc":
        check_tc_block(qt.block, "lora_matmul")
        rp = 16 if r <= 16 else 32      # A's rows padded to 16-byte chunks
        if r != rp or a32.data_ptr() % 16:
            a32 = torch.nn.functional.pad(a32, (0, rp - r))
        pl = plan(M, K, N, qt.block)
        n_split = pl.splits if splits is None else int(splits)
        ws = torch.empty((n_split, M, N), dtype=torch.float32,
                         device=x.device) if n_split > 1 else None
        fn = build.function("lora_matmul", "lora_matmul_tc_launch",
                            _TC_ARGS)
        rc = fn(x2.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(),
                a32.data_ptr(), b32.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(), M, K, Kq, N, r,
                qt.block, rows, fmt, float(scale), n_split, pl.unit, stream)
    elif how == "tf32x3":
        check_tc_block(qt.block, "lora_matmul")
        rp = 16 if r <= 16 else 32
        # x and A padded with zero rows to Kq (odd K); A's columns to rp,
        # in 16-byte rows
        if Kq != K or r != rp or a32.data_ptr() % 16:
            a32 = torch.nn.functional.pad(a32, (0, rp - r, 0, Kq - K))
        if Kq != K:
            x2 = torch.nn.functional.pad(x2, (0, Kq - K))
        pl = plan_lora_tf32(M, K, N, qt.block)
        n_split = pl.splits if splits is None else int(splits)
        ws = torch.empty((n_split, M, N), dtype=torch.float32,
                         device=x.device) if n_split > 1 else None
        fn = build.function("lora_matmul", "lora_matmul_tf32_launch",
                            _TF32_ARGS)
        rc = fn(x2.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(),
                a32.data_ptr(), b32.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(), M, Kq, N, r,
                qt.block, rows, fmt, float(scale), n_split, pl.unit, stream)
    else:
        fn = build.function("lora_matmul", "lora_matmul_launch", _LORA_ARGS)
        rc = fn(x2.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(),
                a32.data_ptr(), b32.data_ptr(), y.data_ptr(), M, K, Kq, N, r,
                qt.block, rows, fmt, float(scale), stream)
    build.check(rc, "lora_matmul")
    lora_matmul.launches += 1
    lora_matmul.tc_launches += int(how == "tc")
    lora_matmul.gemv_launches += int(how == "gemv")
    lora_matmul.tf32_launches += int(how == "tf32x3")
    return y.reshape(*lead, N)


def quant_matmul_t(g: torch.Tensor, qt: QTensor, *,
                   out_dtype: torch.dtype = None) -> torch.Tensor:
    """``g (..., N) @ dequant(qt (Kq, N))ᵀ -> (..., Kq)``, fp32
    accumulation, output in ``out_dtype`` (default g's dtype; a bf16 g
    may write fp32). The output covers the padded Kq; callers slice
    ``[..., :K]``."""
    return _quant_matmul_t(g, qt, out_dtype, None)


def qmt_route(dtype: torch.dtype) -> str:
    """The kernel a ``quant_matmul_t`` call with a ``dtype`` cotangent
    runs: ``"tc"`` for bf16, ``"tf32x3"`` for fp32."""
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def qmt_route_counts() -> dict:
    """``quant_matmul_t``'s launches so far by route: ``"tc"``,
    ``"tf32x3"`` and ``"tiled"``, the rest (the first fp32 design, run
    only when forced)."""
    fn = quant_matmul_t
    return {"tc": fn.tc_launches, "tf32x3": fn.tf32_launches,
            "tiled": fn.launches - fn.tc_launches - fn.tf32_launches}


def _quant_matmul_t(g, qt, out_dtype, splits, *, force=None):
    """:func:`quant_matmul_t` with the split count of its tensor-core
    route forced to ``splits`` (None: :func:`plan_t`'s for bf16,
    :func:`plan_t_tf32`'s for fp32), for the checks of each count;
    ``force="tiled"`` runs the first fp32 design, ``qmt_kernel`` (an fp32
    g; the card's A/B against the tf32x3 route)."""
    how = qmt_route(g.dtype)
    if force is not None:
        if force != "tiled" or how != "tf32x3":
            raise ValueError(f"quant_matmul_t: only the tiled route can be "
                             f"forced, and only for an fp32 g, not "
                             f"{force!r}")
        how = force
    if splits is not None and how == "tiled":
        raise ValueError("quant_matmul_t: the tiled route has no split")
    out_dtype = g.dtype if out_dtype is None else out_dtype
    if out_dtype != g.dtype and not (how == "tc" and
                                     out_dtype == torch.float32):
        raise TypeError(f"quant_matmul_t: out_dtype {out_dtype} for a "
                        f"{g.dtype} g (only a bf16 g may write fp32)")
    fmt, G, rows, N = check_qtensor(g, qt, "quant_matmul_t", ndims=(3,))
    if g.shape[-1] != N:
        raise ValueError(f"contraction dim {g.shape[-1]} != quantized N {N}")
    Kq = G * qt.block
    lead = g.shape[:-1]
    g2 = g.reshape(-1, N).contiguous()
    M = g2.shape[0]
    o = torch.empty((M, Kq), dtype=out_dtype, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if how == "tiled":
        fn = build.function("lora_matmul", "quant_matmul_t_launch", _T_ARGS)
        rc = fn(g2.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(),
                o.data_ptr(), M, Kq, N, qt.block, rows, fmt, stream)
    else:
        check_tc_block(qt.block, "quant_matmul_t")
        pl = plan_t(M, Kq, N) if how == "tc" else plan_t_tf32(M, Kq, N)
        n_split = pl.splits if splits is None else int(splits)
        ws = torch.empty((n_split, M, Kq), dtype=torch.float32,
                         device=g.device) if n_split > 1 else None
        wsp = None if ws is None else ws.data_ptr()
        if how == "tc":
            fn = build.function("lora_matmul", "quant_matmul_t_tc_launch",
                                _T_TC_ARGS)
            rc = fn(g2.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(),
                    o.data_ptr(), wsp, M, Kq, N, qt.block, rows, fmt,
                    int(out_dtype == torch.float32), n_split, pl.unit,
                    stream)
        else:
            fn = build.function("lora_matmul", "quant_matmul_t_tf32_launch",
                                _T_TC_ARGS)
            rc = fn(g2.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(),
                    o.data_ptr(), wsp, M, Kq, N, qt.block, rows, fmt,
                    pl.bm, n_split, pl.unit, stream)
    build.check(rc, "quant_matmul_t")
    quant_matmul_t.launches += 1
    quant_matmul_t.tc_launches += int(how == "tc")
    quant_matmul_t.tf32_launches += int(how == "tf32x3")
    return o.reshape(*lead, Kq)


lora_matmul.launches = 0
lora_matmul.tc_launches = 0
lora_matmul.gemv_launches = 0
lora_matmul.tf32_launches = 0
quant_matmul_t.launches = 0
quant_matmul_t.tc_launches = 0
quant_matmul_t.tf32_launches = 0
