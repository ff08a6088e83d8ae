"""The serve path's two kernels, ``quant_matmul`` (its GEMV route) and
``blockwise_quant``, on the CPU.

Both kernels run on the card only (tests/test_torch_cuda.py,
chip_smoke.py). Here:
- ``repro_torch.kernels.quant_matmul.plan`` (the GEMV's column tile and
  thread-block cluster, K split across the cluster's CTAs by whole quant
  groups) covers every (user, group, column) once, stays within the
  cluster limit and fills the 132 SMs at the serve replay's shape;
- a plain emulation of the GEMV's summation order (each thread's code
  rows in order, the row lanes of a CTA in lane order, then the leader
  CTA's sum over ranks 0..c-1) is held against the JAX package's
  ``repro.kernels.ref.quant_matmul`` within 1e-5 in fp32;
- a plain emulation of the quantizer's tile algorithm (each thread's
  rows held from the absmax to the codes, the column absmax over the
  row threads, IEEE divisions, 4 codes a 32-bit word or a byte tail) is
  held bitwise against ``repro.kernels.ref.blockwise_quant``;
- the constants both emulations assume are the CUDA sources'."""
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import quant as jquant
from repro.kernels import ref as jref
from repro_torch.core import quant as qlib
from repro_torch.kernels import quant_matmul as qmm

CSRC = Path(qmm.__file__).parent / "csrc"
FORMATS = [(8, "linear"), (4, "linear"), (4, "nf4")]


def _consts(name):
    src = (CSRC / f"{name}.cu").read_text()
    return src, {k: int(v) for k, v in
                 re.findall(r"constexpr int (\w+) = (\d+);", src)}


BQ = _consts("blockwise_quant")[1]


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _grid_cover(pl, T, G, N):
    """How often the launch ``pl`` visits each (user, group, column):
    grid (tiles x cluster, T), rank = blockIdx.x % cluster."""
    seen = np.zeros((T, G, N), np.int32)
    for t in range(T):
        for bx in range(pl.tiles * pl.cluster):
            tile, rank = divmod(bx, pl.cluster)
            g0, g1 = pl.groups[rank]
            seen[t, g0:g1, tile * pl.cols:min(N, (tile + 1) * pl.cols)] += 1
    return seen


@pytest.mark.parametrize("G", [1, 2, 12, 16])
@pytest.mark.parametrize("N", [64, 96, 768, 3072])
@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_plan_covers_every_user_group_column_once(T, N, G):
    pl = qmm.plan(T, 1, G, N)
    assert pl.users == T and pl.cols in qmm.TILE_COLS
    assert pl.cols % qmm.COLS_PER_THREAD == 0
    assert qmm.THREADS % (pl.cols // qmm.COLS_PER_THREAD) == 0
    assert 1 <= pl.cluster <= min(G, qmm.CLUSTER_MAX) and G % pl.cluster == 0
    assert (pl.tiles - 1) * pl.cols < N <= pl.tiles * pl.cols
    assert pl.groups == qmm.group_ranges(G, pl.cluster)
    assert (_grid_cover(pl, T, G, N) == 1).all()
    assert pl.ctas == T * pl.tiles * pl.cluster
    assert pl.ctas <= qmm.MAX_CTAS or pl.cluster == 1
    # the plan is the same for every M the GEMV takes
    for M in range(2, qmm.MAX_ROWS + 1):
        assert qmm.plan(T, M, G, N) == pl


@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_plan_fills_the_card_at_the_serve_shape(T):
    """The serve head's 768 x 768, block 64 (12 groups): from two users
    on (the replay's family groups pad to 4 or 8 rows) the launch has at
    least one CTA per SM, the replay's T = 4 runs 288 CTAs (the old grid
    24); one user takes the largest cluster, 72 CTAs of one group each
    (the old grid 6), the fastest plan that the card measured there."""
    pl = qmm.plan(T, 1, 12, 768)
    assert pl.cols == 128 and pl.ctas <= qmm.MAX_CTAS
    if T > 1:
        assert pl.ctas >= qmm.SMS
    assert (pl.cluster, pl.ctas) == {1: (12, 72), 2: (12, 144),
                                     4: (12, 288), 8: (6, 288)}[T]


def test_plan_refuses_more_rows_than_the_gemv_takes():
    with pytest.raises(ValueError):
        qmm.plan(4, qmm.MAX_ROWS + 1, 12, 768)


def _decode(q, s, bits, mode):
    """Per K row, the weights the kernel forms: code x scale in fp32."""
    if bits == 8:
        codes = q.astype(np.float32)                      # (T, G, block, N)
    else:
        nib = np.stack([q >> 4, q & 0xF], axis=-2)        # (T, G, rows, 2, N)
        nib = nib.reshape(*q.shape[:-2], 2 * q.shape[-2], q.shape[-1])
        codes = (qlib.NF4_CODE[nib].astype(np.float32) if mode == "nf4"
                 else nib.astype(np.float32) - 8)
    w = codes * s                                         # fp32 products
    return w.reshape(w.shape[0], -1, w.shape[-1])         # (T, Kq, N)


def gemv_emulation(x, w, block, rows, pl):
    """The GEMV's sums for x (T, M, Kq) against the decoded w (T, Kq, N):
    rank r of a cluster covers groups ``pl.groups[r]``; in it, row lane
    l sums code rows l, l + lanes, ... (an int4 code row i covers K rows
    2i then 2i + 1); the CTA sums its lanes in order, the leader the
    ranks in order. Columns do not mix, so one pass covers every tile."""
    lanes = qmm.THREADS // (pl.cols // qmm.COLS_PER_THREAD)
    k_per_row = block // rows
    y = np.zeros((x.shape[0], x.shape[1], w.shape[-1]), np.float32)
    for g0, g1 in pl.groups:
        red = np.zeros_like(y)
        for lane in range(lanes):
            acc = np.zeros_like(y)
            for i in range(lane, (g1 - g0) * rows, lanes):
                for h in range(k_per_row):
                    k = g0 * block + k_per_row * i + h
                    acc = acc + x[:, :, k, None] * w[:, None, k, :]
            red = red + acc
        y = y + red
    return y


@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("T,M,K,N", [(4, 1, 768, 768), (1, 3, 256, 96),
                                     (2, 2, 320, 64)])
def test_gemv_summation_order_matches_jax_ref(T, M, K, N, bits, mode):
    w = _np(1, T, K, N) / np.sqrt(K)
    x = _np(2, T, M, K)
    jqt = jquant.quantize(jnp.asarray(w), bits=bits, block=64, mode=mode)
    q, s = np.asarray(jqt.q), np.asarray(jqt.scales)
    G, rows = q.shape[1], q.shape[2]
    pl = qmm.plan(T, M, G, N)
    got = gemv_emulation(x, _decode(q, s, bits, mode), 64, rows, pl)
    want = np.asarray(jref.quant_matmul(jnp.asarray(x), jqt))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def quantizer_tile(bits, block):
    """The quantizer launcher's ``bq_tile`` on the .cu's constants:
    ``(ct, rt)``, the CTA's column threads (4 columns each) and row
    threads for one quant group of ``block`` rows, or None where no tile
    holds the block."""
    units = block if bits == 8 else block // 2
    hold = BQ["PER8"] if bits == 8 else BQ["PER4"]
    if units <= BQ["ROW_THREADS"]:
        rt = units
    elif units <= BQ["ROW_THREADS"] * hold:
        rt = BQ["ROW_THREADS"]
    else:
        rt = -(-units // hold)
    ct = BQ["COL_THREADS"]
    while ct * rt > BQ["MAX_THREADS"] and ct > 1:
        ct //= 2
    return (ct, rt) if ct * rt <= BQ["MAX_THREADS"] else None


def quantizer_emulation(x, bits, block):
    """The quantizer kernel's tile algorithm on x (K, N): odd K zero-pads
    (the wrapper), thread (rt, ct) of a group holds rows (int8) or row
    pairs (int4) rt, rt + rt_n, ... of 4 columns, the column absmax is
    the max over the row threads, and 4 codes leave as one little-endian
    word (or the bytes before a ragged N). Returns (q, scales)."""
    K, N = x.shape
    block = min(block, K)
    Kp = -(-K // block) * block
    x = np.pad(x, ((0, Kp - K), (0, 0))).reshape(Kp // block, block, N)
    G = x.shape[0]
    ct, rt = quantizer_tile(bits, block)
    units = block if bits == 8 else block // 2
    hold = BQ["PER8"] if bits == 8 else BQ["PER4"]
    lvl = np.float32(127.0 if bits == 8 else 7.0)
    lo_c, hi_c = (-127, 127) if bits == 8 else (-8, 7)
    cols = 4 * ct * -(-N // (4 * ct))                   # the grid's columns
    xc = np.pad(x, ((0, 0), (0, 0), (0, cols - N)))     # loads past N: 0
    held = [[j for j in range(r, r + hold * rt, rt) if j < units]
            for r in range(rt)]
    assert sorted(sum(held, [])) == list(range(units))   # each row once
    rows_of = (lambda j: [j]) if bits == 8 else (lambda j: [2 * j, 2 * j + 1])
    part = np.stack([np.max([np.abs(xc[:, k]) for j in js for k in rows_of(j)]
                            + [np.zeros((G, cols), np.float32)], axis=0)
                     for js in held])                    # (rt, G, cols)
    amax = np.maximum(part.max(axis=0), np.float32(1e-12))
    scale = amax / lvl                                   # IEEE, fp32
    code = np.clip(np.rint(xc / scale[:, None, :]), lo_c, hi_c)
    if bits == 8:
        byte = code.astype(np.int8).view(np.uint8)
    else:
        u = (code + 8).astype(np.uint8)
        byte = (u[:, 0::2] << 4) | u[:, 1::2]
    words = byte.reshape(G, units, cols // 4, 4).astype(np.uint32)
    words = (words << np.array([0, 8, 16, 24], np.uint32)).sum(
        axis=-1, dtype=np.uint32)                        # one store each
    q = words.view(np.uint8).reshape(G, units, cols)[..., :N]
    q = q.view(np.int8) if bits == 8 else q
    return q, scale[:, None, :N]


@pytest.mark.parametrize("bits,block",
                         [(b, k) for b in (8, 4) for k in (2, 16, 64, 128)]
                         + [(8, 5)])
@pytest.mark.parametrize("K,N", [(768, 768), (100, 70), (768, 770)])
def test_quantizer_tile_algorithm_matches_jax_ref_bitwise(K, N, bits, block):
    x = _np(3, K, N)
    q, s = quantizer_emulation(x, bits, block)
    want = jref.blockwise_quant(jnp.asarray(x), bits=bits, block=block)
    np.testing.assert_array_equal(q, np.asarray(want.q))
    np.testing.assert_array_equal(s, np.asarray(want.scales))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizer_tile_takes_every_block_up_to_its_limit(bits):
    blocks = range(1 if bits == 8 else 2, 8193, 1 if bits == 8 else 2)
    hold = BQ["PER8"] if bits == 8 else BQ["PER4"]
    for block in blocks:
        ct, rt = quantizer_tile(bits, block)
        units = block if bits == 8 else block // 2
        assert ct * rt <= BQ["MAX_THREADS"] and units <= rt * hold
        assert ct in (1, 2, 4, 8) and rt >= 1
    assert quantizer_tile(bits, 64) == (8, 16)
    # the store's (768, 768) at block 64: 12 groups x 24 column tiles
    ct, _ = quantizer_tile(bits, 64)
    assert (768 // 64) * -(-768 // (4 * ct)) == 288
    assert quantizer_tile(bits, 8192 + 2) is None


def test_emulations_use_the_kernels_constants():
    src, c = _consts("quant_matmul")
    # the GEMV's CTA lives in csrc/gemv.cuh, shared with lora_gemv.cu
    hdr = (CSRC / "gemv.cuh").read_text()
    assert '#include "gemv.cuh"' in src
    src += hdr
    c.update({k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", hdr)})
    assert c["GV_THREADS"] == qmm.THREADS
    assert c["GV_CPT"] == qmm.COLS_PER_THREAD
    assert c["GV_CLUSTER_MAX"] == qmm.CLUSTER_MAX
    # the rank's groups, the lanes and the leader's order as emulated
    assert "const int g0 = rank * G / csize;" in src
    assert "const int lanes = GV_THREADS / tpc;" in src
    assert "for (int r = 0; r < lanes; ++r) v += part[r * per + o];" in src
    assert "float* dst = cluster.map_shared_rank(slots, 0) + rank * per;" \
        in src
    assert "for (int r = 0; r < csize; ++r) v += slots[r * per + o];" in src
    # the launcher refuses a tile whose threads do not split evenly
    assert "GV_THREADS % (cols / GV_CPT)" in src
    # the quantizer's tile rule and each thread's rows as emulated
    src, _ = _consts("blockwise_quant")
    assert ": units <= ROW_THREADS * hold ? ROW_THREADS" in src
    assert ": (units + hold - 1) / hold;" in src
    assert "*ct = COL_THREADS;" in src
    assert "while (*ct * *rt > MAX_THREADS && *ct > 1) *ct /= 2;" in src
    assert "!bq_tile(bits, block, &ct, &rt)" in src
    assert "const int j = rtid + p * rt;" in src


def test_gemv_byte_decode_is_exact():
    """The GEMV turns a code byte into its float by a byte permute into
    the mantissa of 2^23 and one subtraction (dequant.cuh): for every
    int8 code and every 4-bit code the result is the code itself."""
    src = (CSRC / "dequant.cuh").read_text()
    assert "__byte_perm(word, 0x4B000000u, 0x7540 | c)" in src
    assert "biased_byte(word ^ 0x80808080u, c) - 8388736.0f" in src
    assert "biased_byte(hi, c) - 8388616.0f" in src

    def biased(u):        # the permute: byte u under the exponent of 2^23
        return (np.uint32(0x4B000000) | np.asarray(u, np.uint32)).view(
            np.float32)

    b = np.arange(-128, 128).astype(np.int8)
    got = biased(b.view(np.uint8) ^ np.uint8(0x80)) - np.float32(8388736.0)
    np.testing.assert_array_equal(got, b.astype(np.float32))
    nib = np.arange(16)
    np.testing.assert_array_equal(biased(nib) - np.float32(8388616.0),
                                  (nib - 8).astype(np.float32))
