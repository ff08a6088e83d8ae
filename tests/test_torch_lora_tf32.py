"""``lora_matmul``'s fp32 route (``"tf32x3"``), on the CPU.

An fp32 ``lora_matmul`` past the decode route's ``MAX_ROWS`` rows runs
``lora_tf32_kernel`` (``csrc/lora_matmul.cu``), the 3xTF32 body of
``csrc/tf32_gemm.cuh`` that ``qmm_tf32_kernel`` runs, with the rank-r
term beside it: a block owns a 128 x 128 output tile and walks its split
of K in 32-deep k-tiles; each weight is decoded once a block (code x fp32
scale) and split, with each x value, into TF32 hi = tf32_rna(v) and lo =
tf32_rna(v - hi); each k8 step adds lo·hi, hi·lo, hi·hi into a chain of 4
k8 steps (one k-tile) that starts from zero and is added to the fp32
accumulator. h = x @ A (r padded to 16 or 32 with zero columns) runs in
the same chains over the same k-tiles, each chain added to an fp32 h;
after the loop d = h @ B is each thread's fp32 fma chain over r and the
accumulator takes scale·d; each split does so with its own h, and the
splits' partials are added in split order. The kernel runs on the card
only (tests/test_torch_cuda.py, chip_smoke.py). Here:
- the route rule, the trace key and the counters resetting together;
- that forcing the first design (``"tiled"``) is for an fp32 x only;
- ``plan_lora_tf32`` covers every row, column and k-tile once, splits
  only on whole quant groups and k-tiles, and its picks at the paths'
  shapes;
- a plain numpy emulation of the kernel's arithmetic (TF32 rounding bit
  for bit, ``tests/test_torch_qmm_tf32.py``'s ``tf32x3_emulation``) held
  against the JAX package's Pallas ``lora_matmul`` in interpret mode
  within 1e-5 of the largest magnitude, in int8, int4 and NF4, odd K,
  ragged N, two row and column tiles, rank 20 (padded to 32), at the
  plan's, one and three splits;
- the plan's and the emulation's constants pinned to the CUDA sources."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.lora_matmul import lora_matmul as pallas_lora
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quant_matmul as qmm
from test_torch_flash_fp32 import fma
from test_torch_qmm_tf32 import (_kernel_ranges, decode,
                                 tf32x3_emulation)

CSRC = Path(lm.__file__).parent / "csrc"
GEMM = (CSRC / "tf32_gemm.cuh").read_text()
SRC = (CSRC / "lora_matmul.cu").read_text()
C = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                       GEMM + (CSRC / "tc_tile.cuh")
                                       .read_text())}
FORMATS = [(8, "linear"), (4, "linear"), (4, "nf4")]
SCALE = 2.0
f32 = np.float32
# the paths' fp32 shapes (M, K, N): phase 13's Qwen3-MoE wq and wo
# (PERF.md row 4g) and phase 4's full-width Yi-9B linears, NF4 block 64
PATH = [(256, 4096, 8192), (256, 8192, 4096), (256, 4096, 4096),
        (256, 4096, 512), (256, 4096, 11008), (256, 11008, 4096)]


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(f32)


# -- the route rule and the counters -----------------------------------

def test_routes_fp32_past_the_decode_rows_to_tf32x3():
    qt = ref.blockwise_quant(torch.from_numpy(_np(1, 256, 96)), bits=4,
                             block=64, mode="nf4")
    for M in (lm.MAX_ROWS + 1, 20, 256, 2048):
        assert lm.route(M, 96, qt, torch.float32) == "tf32x3"
        assert lm.route(M, 96, qt, torch.bfloat16) == "tc"
    for M in range(1, lm.MAX_ROWS + 1):
        assert lm.route(M, 96, qt, torch.float32) == "gemv"


def test_route_counters_reset_together():
    fn = lm.lora_matmul
    fn.launches, fn.gemv_launches, fn.tc_launches, fn.tf32_launches = \
        10, 1, 2, 3
    assert lm.route_counts() == {"gemv": 1, "tc": 2, "tf32x3": 3,
                                 "tiled": 4}
    ops.reset_launch_counts()
    assert lm.route_counts() == {"gemv": 0, "tc": 0, "tf32x3": 0,
                                 "tiled": 0}


@pytest.mark.parametrize("dtype,key", [
    (torch.float32, "lora_matmul_cuda_tf32x3"),
    (torch.bfloat16, "lora_matmul_cuda_tc")])
def test_the_op_traces_its_route(monkeypatch, dtype, key):
    """On the card (the kernel stood in for by its plain version) a call
    past the decode rows traces its dtype's route."""
    seen = []
    monkeypatch.setattr(ops, "_on_cuda", lambda t, op: True)
    monkeypatch.setattr(
        ops.lm_kernel, "lora_matmul",
        lambda x_, w, a_, b_, scale: seen.append(x_.dtype) or
        ref.lora_matmul(x_, w, a_, b_, scale=scale))
    qt = ref.blockwise_quant(torch.from_numpy(_np(2, 64, 32)), bits=4,
                             block=64, mode="nf4")
    x = torch.from_numpy(_np(3, lm.MAX_ROWS + 3, 64)).to(dtype)
    a, b = torch.from_numpy(_np(4, 64, 4)), torch.from_numpy(_np(5, 4, 32))
    ops.reset_kernel_traces()
    ops.lora_matmul(x, qt, a, b, scale=SCALE)
    assert ops.KERNEL_TRACES == {key: 1} and seen == [dtype]


def test_forcing_the_first_design_is_fp32_only(monkeypatch):
    """``force="tiled"`` runs ``lora_kernel`` for an fp32 x only, and
    ``force="tc"`` the bf16 kernel for a bf16 x only; the tiled route
    takes no split count. The checks come before any launch."""
    monkeypatch.setattr(lm, "check_qtensor",
                        lambda x, qt, op, ndims=(3, 4): (2, 1, 32, 32))
    qt = ref.blockwise_quant(torch.from_numpy(_np(6, 64, 32)), bits=4,
                             block=64, mode="nf4")
    a, b = torch.from_numpy(_np(7, 64, 4)), torch.from_numpy(_np(8, 4, 32))
    x = torch.from_numpy(_np(9, 20, 64))
    with pytest.raises(ValueError, match="can be forced"):
        lm._lora_matmul(x.to(torch.bfloat16), qt, a, b, SCALE, None,
                        force="tiled")
    with pytest.raises(ValueError, match="can be forced"):
        lm._lora_matmul(x, qt, a, b, SCALE, None, force="tc")
    with pytest.raises(ValueError, match="takes the tiled route"):
        lm._lora_matmul(x, qt, a, b, SCALE, 2, force="tiled")


# -- the plan -------------------------------------------------------------

def _grid_cover(pl, M, Kq, N, gran):
    """How often the launch visits each (row, contraction granule, output
    column): grid (N tiles, M tiles, splits), each block its split's
    k-tiles of its 128 x 128 tile."""
    seen = np.zeros((M, -(-Kq // gran), N), np.int32)
    for z, (kb, ke) in enumerate(_kernel_ranges(Kq, pl.unit, pl.splits)):
        for by in range(-(-M // pl.bm)):
            for bx in range(-(-N // C["BO"])):
                seen[by * pl.bm:(by + 1) * pl.bm, kb // gran:-(-ke // gran),
                     bx * C["BO"]:(bx + 1) * C["BO"]] += 1
    return seen


@pytest.mark.parametrize("M,K,N,block", [
    (256, 4096, 8192, 64), (256, 8192, 4096, 64), (256, 4096, 512, 64),
    (37, 200, 70, 64), (130, 256, 136, 16), (9, 1024, 256, 128),
    (300, 700, 130, 32)])
def test_plan_covers_every_row_ktile_column_once(M, K, N, block):
    pl = lm.plan_lora_tf32(M, K, N, block)
    Kq = -(-K // block) * block
    unit = math.lcm(block, C["BK"])
    assert (pl.users, pl.bm, pl.unit) == (1, lm.LORA_TF32_BM, unit)
    assert pl.tiles == -(-M // 128) * -(-N // 128)
    assert list(pl.ranges) == _kernel_ranges(Kq, unit, pl.splits)
    for k0, k1 in pl.ranges:       # whole units, at least 2 k-tiles
        assert k0 % unit == 0 and (k1 % unit == 0 or k1 == Kq)
        assert k1 - k0 >= qmm.TF32_MIN_TILES_PER_SPLIT * C["BK"] or \
            pl.splits == 1
    # the least modelled time of every legal count, ties to fewer: the
    # busiest SM's waves of a split's k-tiles, then the partials
    nu = -(-Kq // unit)
    legal = [s for s in range(1, min(nu, qmm.TF32_MAX_SPLITS) + 1)
             if s == 1 or (nu // s) * unit // C["BK"] >= 2]
    cost = {s: -(-pl.tiles * s // 132) * (-(-nu // s) * unit // C["BK"])
            * lm.LORA_TF32_TILE_US + (s > 1) * (2 * s + 1) * M * N * 4
            / lm.PARTIAL_BYTES_PER_US for s in legal}
    assert cost[pl.splits] == min(cost.values())
    assert all(cost[s] > cost[pl.splits] for s in legal if s < pl.splits)
    if M * K * N < 1e8:
        # every quant group (and, at block 16, half k-tile) once
        assert (_grid_cover(pl, M, Kq, N, min(block, C["BK"])) == 1).all()


def test_plan_picks_at_the_paths_shapes():
    picks = {(M, K, N): (lm.plan_lora_tf32(M, K, N, 64).splits,
                         lm.plan_lora_tf32(M, K, N, 64).blocks)
             for M, K, N in PATH}
    # the fastest of the counts timed on the card at each (PERF.md row 4g)
    assert picks == {
        (256, 4096, 8192): (1, 128),     # row 4g's wq: one wave already
        (256, 8192, 4096): (2, 128),     # row 4g's wo
        (256, 4096, 4096): (2, 128),     # Yi-9B wq/wo
        (256, 4096, 512): (16, 128),     # Yi-9B wk/wv
        (256, 4096, 11008): (3, 516),    # Yi-9B wg/wu: 172 tiles
        (256, 11008, 4096): (2, 128)}    # Yi-9B wd


# -- the kernel's arithmetic against the Pallas kernel ---------------------

def lora_tf32_emulation(x, w, a, b, scale, ranges):
    """``lora_tf32_kernel``'s sums for x (M, Kq) against w (Kq, N), a
    (Kq, RP) and b (r, N), all fp32: per split, x @ w and h = x @ a in
    ``gemm_tf32``'s chains over the split's k-tiles, then d = h @ b as an
    fma chain over r from zero and the accumulator's fma with scale·d;
    the splits' partials added in split order."""
    y = None
    for rg in ranges:
        acc = tf32x3_emulation(x[None], w[None], [rg])[0]
        h = tf32x3_emulation(x[None], a[None], [rg])[0]
        d = np.zeros_like(acc)
        for c in range(b.shape[0]):
            d = fma(h[:, c:c + 1], b[c:c + 1], d)
        acc = fma(f32(scale), d, acc)
        y = acc if y is None else (y + acc).astype(f32)
    return y


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("M,K,N,r", [
    (20, 640, 96, 16),      # reduced K: 10 quant groups, split 3 ways
    (37, 200, 70, 4),       # odd K (padded to 256), ragged N
    (130, 256, 136, 20),    # two row and column tiles, r padded to 32
])
def test_emulation_matches_jax_pallas(M, K, N, r, bits, mode):
    w = _np(41, K, N) / f32(np.sqrt(K))
    x = _np(42, M, K)
    a = _np(43, K, r) / f32(np.sqrt(K))
    b = _np(44, r, N) * f32(0.1)
    jqt = jref.blockwise_quant(jnp.asarray(w), bits=bits, block=64,
                               mode=mode)
    want = np.asarray(pallas_lora(jnp.asarray(x), jqt, jnp.asarray(a),
                                  jnp.asarray(b), scale=SCALE,
                                  interpret=True))
    wd = decode(np.asarray(jqt.q), np.asarray(jqt.scales), bits, mode)
    Kq, rp = wd.shape[0], 16 if r <= 16 else 32
    # the wrapper's padding: x and A to Kq rows, A to rp columns
    xp = np.pad(x, ((0, 0), (0, Kq - K)))
    ap = np.pad(a, ((0, Kq - K), (0, rp - r)))
    pl = lm.plan_lora_tf32(M, K, N, 64)
    for ranges in (pl.ranges, lm.split_ranges(Kq, pl.unit, 1),
                   lm.split_ranges(Kq, pl.unit, 3)):
        _close(lora_tf32_emulation(xp, wd, ap, b, SCALE, ranges), want)


# -- the constants the plan and the emulation assume ---------------------

def test_constants_are_the_cuda_sources():
    assert (C["BO"], C["BK"], C["KSTEP"], C["NT"]) == (lm.BN, lm.BK, 8, 256)
    assert lm.LORA_TF32_BM == 128 and C["MAX_SPLITS"] == 64
    # the row tile, the body and the padded rank
    assert "constexpr int BM = 128;             // the row tile" in SRC
    assert "tg::gemm_tf32<FMT, BM, false, RP>(p);" in SRC
    assert "return p.r <= 16 ? launch<FMT, 16>(p, st) : launch<FMT, 32>" \
        "(p, st);" in SRC
    assert "p.T = 1; p.M = M; p.C = Kq; p.O = N;" in SRC
    # splits on whole quant groups and k-tiles, in the GEMM's ranges
    assert "splits > tg::MAX_SPLITS || unit < 1 || unit % tt::BK || " \
        "unit % block ||" in SRC
    assert "const int kb = (int)((long long)z * nu / p.splits) * p.unit;" \
        in GEMM
    # h's chains: the same 4 k8 steps and three products, small ones
    # first, each chain added to h in fp32
    assert "tc::mma_tf32(hc, al, bh);\n          tc::mma_tf32(hc, ah, bl);" \
        "\n          tc::mma_tf32(hc, ah, bh);" in GEMM
    assert "for (int kk = 0; kk < CHAIN; ++kk) {" in GEMM
    assert "v0.x += hc[0];" in GEMM and "v1.y += hc[3];" in GEMM
    # d = h @ B as an fma chain over r from zero, then scale d
    assert "d[i][j][0] = fmaf(hv[i][0], bv[j][0], d[i][j][0]);" in GEMM
    assert "for (int c = 0; c < p.r; ++c) {" in GEMM
    assert "acc[i][j][e] += p.scale * d[i][j][e];" in GEMM
    # the rank padded with zero columns, A's rows zero past the split
    assert "static constexpr int LDL = RP + 8;" in GEMM
    assert "const bool ok = k0 + kk < ke;" in GEMM
