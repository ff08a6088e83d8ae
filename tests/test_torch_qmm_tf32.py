"""The fp32 routes of ``quant_matmul`` and ``quant_matmul_t`` (route
``"tf32x3"``), on the CPU.

An fp32 ``quant_matmul`` past the GEMV's rows (or off its layout) runs
``qmm_tf32_kernel`` and an fp32 ``quant_matmul_t`` runs
``qmt_tf32_kernel``, both the body of ``csrc/tf32_gemm.cuh``: a block
owns a bm x 128 output tile (bm 32 up to ``TF32_SMALL_ROWS`` rows a
user, else 128) and walks its split of the contraction in 32-deep
k-tiles; each weight is decoded once a block (code x fp32 scale) and
split, with each activation value, into TF32 hi = tf32_rna(v) and lo =
tf32_rna(v - hi); each k8 step adds lo·hi, hi·lo, hi·hi into a chain of
4 k8 steps (one k-tile) that starts from zero and is added to the fp32
accumulator; the splits' partials are added in split order. The kernels
run on the card only (tests/test_torch_cuda.py, chip_smoke.py). Here:
- the route rule: fp32 past 4 rows or off the GEMV's layout takes
  ``"tf32x3"``; ``quant_matmul_t`` by g's dtype;
- both plans (``quant_matmul.plan_tf32``, ``lora_matmul.plan_t_tf32``)
  cover every (user, row tile, column tile, quant group or k-tile) once,
  split only on whole groups and k-tiles, and pass 132 blocks at the
  paths' 20 rows;
- a plain numpy emulation of the kernels' arithmetic (TF32 rounding bit
  for bit, ``tests/test_torch_flash_fp32.py``'s ``tf32``) in the
  kernels' order of sums, held against the JAX package's Pallas
  ``quant_matmul`` and ``quant_matmul_t`` in interpret mode within 1e-5
  of the largest magnitude, for int8, int4 and NF4, odd K, ragged N, a
  stacked QTensor and the paths' 20-row shapes at reduced K;
- the counters and the trace keys;
- the plans' and emulations' constants pinned to the CUDA sources."""
import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.lora_matmul import quant_matmul_t as pallas_qmt
from repro.kernels.quant_matmul import quant_matmul as pallas_qmm
from repro_torch.core import quant as qlib
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quant_matmul as qmm
from test_torch_flash_fp32 import mma, split

CSRC = Path(qmm.__file__).parent / "csrc"
GEMM = (CSRC / "tf32_gemm.cuh").read_text()
TILE = (CSRC / "tc_tile.cuh").read_text()
QMM_SRC = (CSRC / "quant_matmul.cu").read_text()
QMT_SRC = (CSRC / "lora_matmul.cu").read_text()
C = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                       GEMM + TILE)}
FORMATS = [(8, "linear"), (4, "linear"), (4, "nf4")]
f32 = np.float32
# the paths' fp32 shapes (PERF.md rows 1d and 5e): the MoE expert's
# wg/wu product and its two dx shapes; the calibrated RecurrentGemma-2B
# MLP at 2048 rows: (M, C, O) = rows, contraction, output columns
QMM_PATH = [(20, 4096, 1536), (2048, 2560, 7680)]
QMT_PATH = [(20, 1536, 4096), (20, 4096, 1536), (2048, 7680, 2560),
            (2048, 2560, 7680)]


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(f32)


# -- the route rule and the counters -----------------------------------

def test_routes_fp32_past_the_gemv_to_tf32x3():
    q = torch.zeros((2, 32, 64), dtype=torch.uint8)
    for M in (5, 7, 20, 256, 2048):
        assert qmm.route(M, 64, q, torch.float32) == "tf32x3"
        assert qmm.route(M, 64, q, torch.bfloat16) == "tc"
    for M in range(1, qmm.MAX_ROWS + 1):
        assert qmm.route(M, 64, q, torch.float32) == "gemv"
        # off the GEMV's layout (N % 4 != 0)
        assert qmm.route(M, 70, q, torch.float32) == "tf32x3"
    assert lm.qmt_route(torch.float32) == "tf32x3"
    assert lm.qmt_route(torch.bfloat16) == "tc"


def test_route_counters_reset_together():
    fn, ft = qmm.quant_matmul, lm.quant_matmul_t
    fn.launches, fn.gemv_launches, fn.tc_launches, fn.tf32_launches = \
        10, 1, 2, 3
    ft.launches, ft.tc_launches, ft.tf32_launches = 7, 2, 4
    assert qmm.route_counts() == {"gemv": 1, "tc": 2, "tf32x3": 3,
                                  "tiled": 4}
    assert lm.qmt_route_counts() == {"tc": 2, "tf32x3": 4, "tiled": 1}
    ops.reset_launch_counts()
    assert qmm.route_counts() == {"gemv": 0, "tc": 0, "tf32x3": 0,
                                  "tiled": 0}
    assert lm.qmt_route_counts() == {"tc": 0, "tf32x3": 0, "tiled": 0}


@pytest.mark.parametrize("dtype,key", [
    (torch.float32, "quant_matmul_t_cuda_tf32x3"),
    (torch.bfloat16, "quant_matmul_t_cuda_tc")])
def test_dx_through_w_traces_its_route(monkeypatch, dtype, key):
    """On the card (the kernel stood in for by its plain version) a
    frozen weight's dx traces the route of its cotangent's dtype; any g
    that is not bf16 goes to the kernel as fp32."""
    seen = []
    monkeypatch.setattr(
        ops.lm_kernel, "quant_matmul_t",
        lambda g, qt, out_dtype=None: seen.append(g.dtype) or
        ref.quant_matmul_t(g, qt, out_dtype=out_dtype))
    qt = ref.blockwise_quant(torch.from_numpy(_np(3, 64, 32)), bits=8,
                             block=32)
    ops.reset_kernel_traces()
    g = torch.from_numpy(_np(4, 5, 32)).to(dtype)
    dx = ops._dx_through_w(g, qt, 60)
    assert ops.KERNEL_TRACES == {key: 1} and seen == [dtype]
    assert dx.shape == (5, 60) and dx.dtype == torch.float32


def test_forcing_the_first_design_is_fp32_only():
    g = torch.zeros((2, 32), dtype=torch.bfloat16)
    qt = ref.blockwise_quant(torch.from_numpy(_np(5, 64, 32)), bits=8,
                             block=32)
    with pytest.raises(ValueError, match="only for an fp32 g"):
        lm._quant_matmul_t(g, qt, None, None, force="tiled")
    with pytest.raises(ValueError, match="no split"):
        lm._quant_matmul_t(g.float(), qt, None, 2, force="tiled")


def test_tf32_plans_refuse_blocks_the_kernels_do_not_take():
    for block in (8, 48, 96):
        with pytest.raises(NotImplementedError, match=f"block {block}"):
            qmm.check_tc_block(block, "quant_matmul")


# -- the plans ----------------------------------------------------------

def _kernel_ranges(C_, unit, splits):
    """Split z's [kb, ke) as ``gemm_tf32`` computes it."""
    nu = (C_ + unit - 1) // unit
    return [(z * nu // splits * unit, min((z + 1) * nu // splits * unit,
                                          C_)) for z in range(splits)]


def _grid_cover(pl, T, M, C_, O, gran):
    """How often the launch visits each (user, row, contraction granule,
    output column): grid (O tiles, M tiles, T x splits), blockIdx.z = t x
    splits + z, each block its split's k-tiles of its (bm x 128) tile."""
    seen = np.zeros((T, M, -(-C_ // gran), O), np.int32)
    for bz in range(T * pl.splits):
        t, z = divmod(bz, pl.splits)
        kb, ke = _kernel_ranges(C_, pl.unit, pl.splits)[z]
        for by in range(-(-M // pl.bm)):
            for bx in range(-(-O // C["BO"])):
                seen[t, by * pl.bm:(by + 1) * pl.bm, kb // gran:-(-ke // gran),
                     bx * C["BO"]:(bx + 1) * C["BO"]] += 1
    return seen


def _check_plan(pl, T, M, C_, O, unit):
    assert pl.users == T and pl.bm in qmm.TF32_ROW_TILES
    assert pl.bm == (32 if M <= qmm.TF32_SMALL_ROWS else 128)
    assert pl.unit == unit and 1 <= pl.splits <= qmm.TF32_MAX_SPLITS
    assert pl.tiles == -(-M // pl.bm) * -(-O // C["BO"])
    assert list(pl.ranges) == _kernel_ranges(C_, unit, pl.splits)
    for k0, k1 in pl.ranges:       # whole units, at least 2 k-tiles
        assert k0 % unit == 0 and (k1 % unit == 0 or k1 == C_)
        assert k1 - k0 >= qmm.TF32_MIN_TILES_PER_SPLIT * C["BK"] or \
            pl.splits == 1
    # one split fewer would not have filled the card
    assert pl.splits == 1 or T * pl.tiles * (pl.splits - 1) < qmm.SMS


@pytest.mark.parametrize("T,M,K,N,block", [
    (1, 20, 4096, 1536, 64), (1, 2048, 2560, 7680, 64),
    (2, 20, 640, 96, 64), (1, 37, 200, 70, 64), (3, 300, 700, 130, 16),
    (1, 7, 1024, 256, 128), (1, 65, 512, 384, 32)])
def test_qmm_plan_covers_every_user_row_group_column_once(T, M, K, N,
                                                         block):
    Kq = -(-K // block) * block
    unit = math.lcm(block, C["BK"])
    pl = qmm.plan_tf32(T, M, Kq, N, unit)
    _check_plan(pl, T, M, Kq, N, unit)
    if M * K * N < 1e8:
        # every quant group (and, at block 16, half k-tile) once
        assert (_grid_cover(pl, T, M, Kq, N, min(block, C["BK"])) == 1).all()


@pytest.mark.parametrize("M,Kq,N", [
    (20, 1536, 4096), (20, 4096, 1536), (2048, 7680, 2560), (37, 256, 33),
    (256, 4096, 512), (5, 192, 20), (300, 384, 40)])
def test_qmt_plan_covers_every_row_ktile_column_once(M, Kq, N):
    pl = lm.plan_t_tf32(M, Kq, N)
    _check_plan(pl, 1, M, N, Kq, C["BK"])
    if M * Kq * N < 1e8:
        assert (_grid_cover(pl, 1, M, N, Kq, C["BK"]) == 1).all()


def test_plans_fill_the_card_at_the_paths_20_rows():
    pl = qmm.plan_tf32(1, 20, 4096, 1536, 64)
    assert (pl.bm, pl.tiles, pl.splits, pl.blocks) == (32, 12, 11, 132)
    assert lm.plan_t_tf32(20, 1536, 4096).blocks == 132     # 12 x 11
    assert lm.plan_t_tf32(20, 4096, 1536).blocks == 160     # 32 x 5
    for M, C_, O in QMM_PATH[1:]:
        pl = qmm.plan_tf32(1, M, C_, O, 64)
        assert (pl.bm, pl.splits, pl.blocks) == (128, 1, 16 * 60)
    for M, Kq, N in QMT_PATH[2:]:
        pl = lm.plan_t_tf32(M, Kq, N)
        assert pl.bm == 128 and pl.splits == 1 and pl.blocks >= qmm.SMS


# -- the kernels' arithmetic against the Pallas kernels -------------------

def decode(q, s, bits, mode):
    """The kernel's decoded weights: code x fp32 scale, (..., G, rows, N)
    -> (..., Kq, N)."""
    if bits == 8:
        codes = q.astype(f32)
    else:
        nib = np.stack([q >> 4, q & 0xF], axis=-2)
        nib = nib.reshape(*q.shape[:-2], 2 * q.shape[-2], q.shape[-1])
        codes = (qlib.NF4_CODE[nib].astype(f32) if mode == "nf4"
                 else nib.astype(f32) - 8)
    w = (codes * s).astype(f32)
    return w.reshape(*w.shape[:-3], -1, w.shape[-1])


def tf32x3_emulation(a, w, ranges):
    """``gemm_tf32``'s sums for a (T, M, C) against w (T, C, O), both
    fp32: per split, each 32-deep k-tile a chain from zero of its 4 k8
    steps (lo·hi, hi·lo, hi·hi each), the chain added to the split's fp32
    accumulator; the splits' partials added in split order. Rows and
    columns do not mix, so one pass covers every tile."""
    BK, KS = C["BK"], C["KSTEP"]
    Cp = -(-a.shape[-1] // BK) * BK
    a = np.pad(a, ((0, 0), (0, 0), (0, Cp - a.shape[-1])))
    w = np.pad(w, ((0, 0), (0, Cp - w.shape[1]), (0, 0)))
    a_hi, a_lo = split(a)
    w_hi, w_lo = split(w)
    y = None
    for k0, k1 in ranges:
        acc = np.zeros((a.shape[0], a.shape[1], w.shape[-1]), f32)
        for t0 in range(k0, k1, BK):
            ch = np.zeros_like(acc)
            for d in range(t0, t0 + BK, KS):
                if d >= k1:                 # zeros: an exact no-op
                    break
                sl = slice(d, d + KS)
                ch = mma(ch, a_lo[..., sl], w_hi[:, sl])
                ch = mma(ch, a_hi[..., sl], w_lo[:, sl])
                ch = mma(ch, a_hi[..., sl], w_hi[:, sl])
            acc = (acc + ch).astype(f32)
        y = acc if y is None else (y + acc).astype(f32)
    return y


def _jqt(w, bits, mode):
    return jref.blockwise_quant(jnp.asarray(w), bits=bits, block=64,
                                mode=mode)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("T,M,K,N", [
    (0, 20, 640, 96),       # the experts' 20 rows at reduced K: 10 splits
    (0, 37, 200, 70),       # odd K (padded to 256), ragged N
    (2, 20, 300, 70),       # a stacked QTensor, odd K, ragged N
    (0, 130, 256, 136)])    # two 128-row tiles, two column tiles
def test_qmm_emulation_matches_jax_pallas(T, M, K, N, bits, mode):
    lead = (T,) if T else ()
    w = _np(41, *lead, K, N) / f32(np.sqrt(K))
    x = _np(42, *lead, M, K)
    jqt = _jqt(w, bits, mode)
    users = [dataclasses.replace(jqt, q=jqt.q[t], scales=jqt.scales[t],
                                 orig_shape=jqt.orig_shape[1:])
             for t in range(T)] if T else [jqt]
    xs = x if T else x[None]
    want = np.stack([np.asarray(pallas_qmm(jnp.asarray(xs[t]), u,
                                           interpret=True))
                     for t, u in enumerate(users)])
    q, s = np.asarray(jqt.q), np.asarray(jqt.scales)
    wd = decode(q if T else q[None], s if T else s[None], bits, mode)
    Tn, Kq = max(T, 1), wd.shape[1]
    xp = np.pad(xs, ((0, 0), (0, 0), (0, Kq - K)))
    pl = qmm.plan_tf32(Tn, M, Kq, N, math.lcm(64, C["BK"]))
    for ranges in (pl.ranges, qmm.split_ranges(Kq, pl.unit, 1),
                   qmm.split_ranges(Kq, pl.unit, 3)):
        _close(tf32x3_emulation(xp, wd, ranges), want)


@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("M,K,N", [
    (20, 640, 96),          # the experts' dx at reduced width: 3 splits
    (20, 96, 640),          # ... and the other orientation: 20 splits
    (37, 200, 33),          # odd K (Kq 256), ragged N
    (130, 128, 70)])        # two 128-row tiles, N % 32 != 0
def test_qmt_emulation_matches_jax_pallas(M, K, N, bits, mode):
    w = _np(43, K, N) / f32(np.sqrt(K))
    g = _np(44, M, N)
    jqt = _jqt(w, bits, mode)
    want = np.asarray(pallas_qmt(jnp.asarray(g), jqt, interpret=True))
    wd = decode(np.asarray(jqt.q), np.asarray(jqt.scales), bits, mode)
    Kq = wd.shape[0]
    pl = lm.plan_t_tf32(M, Kq, N)
    for ranges in (pl.ranges, lm.split_ranges(N, C["BK"], 1),
                   lm.split_ranges(N, C["BK"], 3)):
        got = tf32x3_emulation(g[None], wd.T[None], ranges)[0]
        _close(got, want)


def test_the_decoded_weights_are_the_plain_versions():
    """code x fp32 scale, bitwise the port's dequantize, which the plain
    versions multiply by."""
    w = torch.from_numpy(_np(45, 200, 70))
    for bits, mode in FORMATS:
        qt = ref.blockwise_quant(w, bits=bits, block=64, mode=mode)
        got = decode(qt.q.numpy(), qt.scales.numpy(), bits, mode)
        want = qlib.dequantize(qt, torch.float32).numpy()
        np.testing.assert_array_equal(got[:want.shape[0]], want)


# -- the constants the plans and emulations assume -----------------------

def test_constants_are_the_cuda_sources():
    assert (C["BO"], C["BK"], C["KSTEP"], C["NT"]) == (qmm.TC_BN, qmm.TC_BK,
                                                       8, 256)
    assert "constexpr int CHAIN = BK / KSTEP;" in GEMM
    assert C["MAX_SPLITS"] == qmm.TF32_MAX_SPLITS
    assert C["MIN_BLOCK"] == qmm.TC_MIN_BLOCK
    # the row tiles both launchers take, and the plan's
    for src in (QMM_SRC, QMT_SRC):
        tiles = tuple(int(a) for a, b in re.findall(
            r"case (\d+): return launch_tile<FMT, (\d+)>\(p, st\);", src)
            if a == b)
        assert tiles == qmm.TF32_ROW_TILES == (32, 128)
    # 8 warps: 2 x 4 of 16 x 32 at bm 32, 4 x 2 of 32 x 64 at bm 128
    assert "static constexpr int WM = BM == 128 ? 4 : 2;" in GEMM
    assert "static constexpr int WN = 8 / WM;" in GEMM
    # the three products, small ones first; a chain a k-tile, added in fp32
    assert "tc::mma_tf32(ch[i][j], al[i], bh);\n          tc::mma_tf32(" \
        "ch[i][j], ah[i], bl);\n          tc::mma_tf32(ch[i][j], ah[i], " \
        "bh);" in GEMM
    assert "for (int e = 0; e < 4; ++e) acc[i][j][e] += ch[i][j][e];" in GEMM
    assert "for (int kk = 0; kk < CHAIN; ++kk) {" in GEMM
    # the splits' ranges and their sum in split order
    assert "const int kb = (int)((long long)z * nu / p.splits) * p.unit;" \
        in GEMM
    assert "for (int s = 1; s < splits; ++s) v += ws[s * mn + j];" in TILE
    # the weight: code * fp32 scale, then the TF32 split
    assert "wv[0][j] = ok ? (float)(int8_t)byte * sc[j] : 0.f;" in TILE
    assert "tc::split_tf32(wv[rr][0], h.x, l.x);" in TILE
    # splits on whole quant groups and k-tiles; the contraction and output
    assert "unit < 1 || unit % tt::BK || unit % block ||" in QMM_SRC
    assert "p.C = Kq; p.O = N;" in QMM_SRC and "p.C = N; p.O = Kq;" in \
        QMT_SRC
    assert "tg::gemm_tf32<FMT, BM, false>(p);" in QMM_SRC
    assert "tg::gemm_tf32<FMT, BM, true>(p);" in QMT_SRC
