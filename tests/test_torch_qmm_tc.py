"""The tc route of ``quant_matmul`` (a bf16 x past the GEMV's rows: the
tensor-core ``qmm_tc_kernel``), on the CPU.

The kernel runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py). Here:
- ``repro_torch.kernels.quant_matmul.plan_tc`` (the row tile and split-K)
  covers every (user, row tile, column tile, quant group) once, as the
  kernel's grid computes its ranges; it splits only on whole quant groups
  and whole k-tiles, fills the 132 SMs at the Kimi-K2 expert's 7 rows,
  takes one 256-row tile at RecurrentGemma-2B's 256, and at Whisper's
  6000 rows 256-row tiles that fill the card without a split (two at
  wd, whose 192 blocks leave a 1.45-wave tail);
- a plain emulation of the kernel's arithmetic (each weight code x fp32
  scale rounded to bf16, bf16 x, fp32 sums: 16-deep mma steps in k-tile
  order within a split, the splits added in split order, the result
  rounded to bf16) is held against the JAX package's
  ``repro.kernels.ref.quant_matmul`` on bf16 x for int8, int4 and NF4,
  odd K, ragged N and a stacked QTensor, within one bf16 ulp of the
  largest output (2^-7 of it: both sides round an fp32 sum of the same
  products to bf16, and the sums differ only in order); its decoded
  weights equal the JAX package's ``dequantize`` to bf16 bitwise;
- the routing rule: bf16 past 4 rows (or off the GEMV's layout) takes
  ``"tc"``, fp32 ``"tf32x3"`` (tests/test_torch_qmm_tf32.py), at most 4
  rows on the GEMV's layout ``"gemv"``;
- the constants the plan assumes are the CUDA sources'."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import quant as jquant
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import quant as qlib
from repro_torch.kernels import quant_matmul as qmm

torch.set_num_threads(1)
CSRC = Path(qmm.__file__).parent / "csrc"
FORMATS = [(8, "linear"), (4, "linear"), (4, "nf4")]
# the rows the route runs: Kimi-K2's experts, RecurrentGemma-2B's MLP,
# phase 2's large case, Whisper's encoder MLP (NF4 block 64)
TRAINER_SHAPES = [(7, 7168, 2048), (7, 2048, 7168), (256, 2560, 7680),
                  (256, 7680, 2560), (800, 768, 3072), (6000, 1024, 4096),
                  (6000, 4096, 1024)]


def _constants():
    tile = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", (CSRC / "tc_tile.cuh").read_text())}
    src = (CSRC / "quant_matmul.cu").read_text()
    bms = sorted(int(a) for a, b in re.findall(
        r"case (\d+): return launch<FMT, (\d+)>\(p, st\);", src) if a == b)
    max_splits = int(re.search(r"splits > (\d+) \|\|", src).group(1))
    return tile, tuple(bms), max_splits


def test_plan_constants_are_the_cuda_sources():
    tile, bms, max_splits = _constants()
    assert (qmm.TC_BN, qmm.TC_BK) == (tile["BN"], tile["BK"])
    assert qmm.TC_MIN_BLOCK == tile["MIN_BLOCK"]
    assert qmm.TC_ROW_TILES == bms == (16, 64, 256)
    assert max(qmm.TC_SPLITS) <= max_splits
    assert set(qmm.TC_TILE_US) == set(qmm.TC_BLOCKS_PER_SM) == set(bms)
    # the blocks an SM holds are the launch bounds' minimum (MINB)
    src = (CSRC / "quant_matmul.cu").read_text()
    minb = re.search(r"MINB = BM == 256 \? (\d+) : BM == 64 \? (\d+) : "
                     r"(\d+);", src).groups()
    assert tuple(int(v) for v in minb) == tuple(
        qmm.TC_BLOCKS_PER_SM[bm] for bm in (256, 64, 16))


def _kernel_ranges(Kq, unit, splits):
    """Split z's [kb, ke) as ``qmm_tc_kernel`` computes it."""
    nu = (Kq + unit - 1) // unit
    return [(z * nu // splits * unit, min((z + 1) * nu // splits * unit, Kq))
            for z in range(splits)]


def _grid_cover(pl, T, M, Kq, N, block):
    """How often the launch ``pl`` visits each (user, row, quant group,
    column): grid (N tiles, M tiles, T x splits), blockIdx.z = t x splits
    + z, each block its split's groups of its (bm x 128) tile."""
    seen = np.zeros((T, M, Kq // block, N), np.int32)
    ranges = _kernel_ranges(Kq, pl.unit, pl.splits)
    for bz in range(T * pl.splits):
        t, z = divmod(bz, pl.splits)
        kb, ke = ranges[z]
        for by in range(-(-M // pl.bm)):
            for bx in range(-(-N // qmm.TC_BN)):
                seen[t, by * pl.bm:(by + 1) * pl.bm, kb // block:
                     -(-ke // block), bx * qmm.TC_BN:(bx + 1) * qmm.TC_BN] += 1
    return seen


@pytest.mark.parametrize("T,M,K,N,block", [
    (1, 7, 1792, 512, 64), (2, 7, 640, 384, 64), (1, 37, 200, 33, 64),
    (2, 256, 200, 70, 64), (1, 300, 640, 260, 16), (1, 5, 4096, 96, 128),
    (3, 20, 1024, 128, 32)])
def test_plan_covers_every_user_row_group_column_once(T, M, K, N, block):
    Kq = -(-K // block) * block
    pl = qmm.plan_tc(T, M, Kq, N, block)
    assert pl.users == T and pl.bm in qmm.TC_ROW_TILES
    assert pl.splits in qmm.TC_SPLITS
    assert pl.unit == math.lcm(block, qmm.TC_BK)
    assert pl.tiles == -(-M // pl.bm) * -(-N // qmm.TC_BN)
    assert pl.blocks == T * pl.tiles * pl.splits
    assert list(pl.ranges) == _kernel_ranges(Kq, pl.unit, pl.splits)
    for k0, k1 in pl.ranges:      # whole quant groups, whole k-tiles
        assert k0 % block == 0 and k0 % qmm.TC_BK == 0 and k1 % block == 0
        assert k1 - k0 >= qmm.TC_MIN_TILES_PER_SPLIT * qmm.TC_BK or \
            pl.splits == 1
    assert (_grid_cover(pl, T, M, Kq, N, block) == 1).all()


@pytest.mark.parametrize("splits", qmm.TC_SPLITS)
@pytest.mark.parametrize("bm", qmm.TC_ROW_TILES)
def test_every_forced_plan_covers_once(bm, splits):
    """Every plan of ``tc_plans`` (the card sweep forces each) covers the
    Kimi-K2 expert cut (7 rows, 32 groups, where every row tile and
    split count qualifies) once."""
    T, M, Kq, N, block = 1, 7, 2048, 256, 64
    plans = {(p.bm, p.splits): p for p in qmm.tc_plans(T, M, Kq, N, block)}
    assert len(plans) == len(qmm.TC_ROW_TILES) * len(qmm.TC_SPLITS)
    pl = plans[(bm, splits)]
    assert pl.tiles == -(-M // bm) * -(-N // 128)
    assert list(pl.ranges) == _kernel_ranges(Kq, pl.unit, splits)
    assert (_grid_cover(pl, T, M, Kq, N, block) == 1).all()


@pytest.mark.parametrize("M,K,N", TRAINER_SHAPES)
def test_plan_at_the_trainer_rows(M, K, N):
    pl = qmm.plan_tc(1, M, K, N, 64)
    if M == 7:        # memory-bound: the split fills the SMs
        assert pl.bm == 16 and pl.blocks >= qmm.SMS
    if M == 256:      # one row tile: each weight decoded once per split
        assert pl.bm == 256 and pl.tiles == -(-N // 128)
    if M == 6000:     # the row tiles fill the card: no split, or two
        assert pl.bm == 256 and pl.tiles >= qmm.SMS
        assert pl.splits == (1 if N == 4096 else 2)


def test_plan_refuses_blocks_the_kernel_does_not_take():
    for block in (8, 48, 96):
        with pytest.raises(NotImplementedError):
            qmm.plan_tc(1, 64, block * 4, 128, block)


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bf16(a):
    """numpy fp32 -> bf16 (round to nearest even) -> fp32."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def decode_bf16(q, s, bits, mode):
    """The kernel's decoded tile, all of it: code x fp32 scale, rounded
    to bf16 (decode_words with one part). (T, G, rows, N) -> (T, Kq, N)."""
    if bits == 8:
        codes = q.astype(np.float32)
    else:
        nib = np.stack([q >> 4, q & 0xF], axis=-2)
        nib = nib.reshape(*q.shape[:-2], 2 * q.shape[-2], q.shape[-1])
        codes = (qlib.NF4_CODE[nib].astype(np.float32) if mode == "nf4"
                 else nib.astype(np.float32) - 8)
    w = _bf16(codes * s)
    return w.reshape(w.shape[0], -1, w.shape[-1])


def tc_emulation(x, w, pl):
    """``qmm_tc_kernel``'s sums for bf16-valued x (T, M, Kq) against the
    decoded w (T, Kq, N): per split, its k-tiles in order, each as two
    16-deep mma steps whose products add into fp32 accumulators; the
    splits added in split order (splitk_sum); the result rounded to
    bf16. Rows and columns do not mix, so one pass covers every tile."""
    T, M, Kq = x.shape
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y = torch.zeros((T, M, w.shape[-1]))
    for k0, k1 in pl.ranges:
        acc = torch.zeros_like(y)
        for k in range(k0, k1, 16):
            acc += torch.matmul(xt[:, :, k:k + 16], wt[:, k:k + 16])
        y += acc
    return _bf16(y.numpy())


@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("T,M,K,N", [
    (0, 7, 1792, 512),      # Kimi-K2's rows, K split
    (0, 256, 640, 384),     # a 256-row tile
    (0, 37, 200, 33),       # odd K (padded to 256), ragged N
    (2, 7, 640, 96),        # a stacked QTensor
    (2, 20, 100, 70)])      # stacked, odd K, ragged N
def test_tc_emulation_matches_jax_ref(T, M, K, N, bits, mode):
    lead = (T,) if T else ()
    w = _np(41, *lead, K, N) / np.float32(np.sqrt(K))
    x = _bf16(_np(42, *lead, M, K))
    jqt = jref.blockwise_quant(jnp.asarray(w), bits=bits, block=64,
                               mode=mode)
    want = np.asarray(jref.quant_matmul(jnp.asarray(x, jnp.bfloat16), jqt)
                      .astype(jnp.float32))
    q, s = np.asarray(jqt.q), np.asarray(jqt.scales)
    if not T:
        q, s = q[None], s[None]
    wd = decode_bf16(q, s, bits, mode)
    # the decoded tile is the JAX package's dequantize to bf16, bitwise
    jw = np.asarray(jquant.dequantize(jqt, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(wd, jw.reshape(wd.shape))
    Tn, Kq = max(T, 1), wd.shape[1]
    xp = np.pad(x.reshape(Tn, M, K), ((0, 0), (0, 0), (0, Kq - K)))
    pl = qmm.plan_tc(Tn, M, Kq, N, 64)
    for p in (pl, qmm.TcPlan(users=Tn, bm=pl.bm, tiles=pl.tiles, splits=3,
                             unit=pl.unit,
                             ranges=qmm.split_ranges(Kq, pl.unit, 3))):
        got = tc_emulation(xp, wd, p).reshape(want.shape)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -7 * np.abs(want).max())


def test_routes_by_rows_layout_and_dtype():
    bf, f32 = torch.bfloat16, torch.float32
    q = torch.zeros((2, 32, 64), dtype=torch.uint8)
    assert qmm.route(7, 64, q, bf) == "tc"
    assert qmm.route(256, 64, q, bf) == "tc"
    assert qmm.route(7, 64, q, f32) == "tf32x3"
    for M in range(1, qmm.MAX_ROWS + 1):
        assert qmm.route(M, 64, q, bf) == qmm.route(M, 64, q, f32) == "gemv"
        # off the GEMV's layout (N % 4 != 0): the kernel of the dtype
        assert qmm.route(M, 70, q, bf) == "tc"
        assert qmm.route(M, 70, q, f32) == "tf32x3"


def test_tc_launches_reset_with_the_others():
    from repro_torch.kernels import ops
    qmm.quant_matmul.tc_launches = 5
    ops.reset_launch_counts()
    assert qmm.quant_matmul.tc_launches == 0


def test_ops_counts_the_tc_route_on_the_card(monkeypatch):
    """On the card (``_on_cuda`` forced) ``ops.quant_matmul`` reaches the
    kernel wrapper, which counts the launch by route; here the wrapper
    stands in as its plain version."""
    from repro_torch.kernels import ops, ref
    seen = []

    def wrapper(x, qt):
        how = qmm.route(x.numel() // x.shape[-1], qt.q.shape[-1], qt.q,
                        x.dtype)
        seen.append(how)
        return ref.quant_matmul(x, qt)

    monkeypatch.setattr(ops, "_on_cuda", lambda t, op: True)
    monkeypatch.setattr(ops.qmm_kernel, "quant_matmul", wrapper)
    qt = convert.tree_from_numpy({"w": jref.blockwise_quant(
        jnp.asarray(_np(43, 64, 32)), bits=4, block=64, mode="nf4")},
        "cpu")["w"]
    for M, dt in ((7, torch.bfloat16), (7, torch.float32),
                  (3, torch.bfloat16)):
        ops.quant_matmul(torch.from_numpy(_np(44, M, 64)).to(dt), qt)
    assert seen == ["tc", "tf32x3", "gemv"]
