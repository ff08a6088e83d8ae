"""``flash_attention``'s fp32 routes, on the CPU.

An fp32 call runs one of two kernels (``csrc/flash_attention.cu``), by
the number of query rows S (``flash_attention.route``):
- ``"cuda_rows"`` up to ``ROWS_MAX_S`` (the FL round's and the serve
  oracle's S = 1): ``flash_rows_kernel``, one warp a (b, s, h) row, lane
  l holding dims 128 i + 4 l .. + 3 of each 128-dim chunk i; a score is
  the lane's fma chain over its dims (chunk by chunk) summed by a xor
  butterfly, keys taken ``ROW_KEYS`` at a time from the row's first
  valid key, the online softmax in expf of the q-scaled scores;
- ``"cuda_tf32x3"`` past it: ``flash_tf32x3_kernel``, 64-row q-tiles,
  32-key tiles from the band's first, ⌈Dp/128⌉ D-slices (Dp = D rounded
  up to 8) whose partial scores are summed in rank order, and Q Kᵀ and
  P V on TF32 tensor cores (m16n8k8) with each fp32 operand split as
  hi = tf32_rna(x), lo = tf32_rna(x - hi) and each product as lo·hi +
  hi·lo + hi·hi, accumulated in fp32 k8 step by k8 step in chains of 4
  k8 steps from zero (32 dims of a score, a key tile of P V), the
  chains added in fp32 (O as O·corr + P V); the softmax in exp2 of the
  scores times log2(e)/√D.
The kernels run on the card only (tests/test_torch_cuda.py,
chip_smoke.py). Here: the route rule, plain numpy emulations of both
kernels' algorithms (TF32 rounding bit for bit) held against the JAX
package's Pallas ``flash_attention`` in interpret mode within 1e-5 of
the largest magnitude, the routes' trace keys and counters, and the
emulations' constants pinned to the source."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

CSRC = Path(fa.__file__).parent / "csrc"
SRC = (CSRC / "flash_attention.cu").read_text()
MMA = (CSRC / "mma.cuh").read_text()
C = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SRC)}
f32, f64 = np.float32, np.float64
NEG_INF = f32(-1e30)


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(f32)


def tf32(x):
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, to nearest, ties
    away from zero (half an ulp added to the magnitude, then cut)."""
    b = np.asarray(x, f32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(f32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, f32) - hi)


def mma(acc, a, b):
    """acc + a @ b over one k8 step: the TF32 products are exact, their
    sum with the fp32 accumulator rounded once to fp32."""
    return (acc.astype(f64) + np.matmul(a.astype(f64), b.astype(f64))
            ).astype(f32)


def fma(a, b, c):
    return (f64(a) * f64(b) + f64(c)).astype(f32) if np.ndim(c) == 0 else \
        (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)
         ).astype(f32)


def _scale(D):
    return f32(1.0 / math.sqrt(D))


def tf32x3_emulation(q, k, v, *, causal, window):
    """``flash_tf32x3_kernel``'s algorithm for q (B, S, H, D), k/v (B, Skv,
    Hkv, D) in fp32: every (b, h) at once, one q-tile at a time."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    BQT, BKV, DV, KS = 16 * C["NWT"], C["BKV"], C["DV"], C["X_KSTEP"]
    CHAIN = C["X_CHAIN"]
    Dp = -(-D // KS) * KS
    nsl = -(-Dp // DV)
    pad = lambda t: np.pad(t, ((0, 0), (0, 0), (0, 0), (0, Dp - D)))
    q, k, v = pad(q), pad(k), pad(v)
    G = H // Hkv
    # (B * H, rows, Dp), each query head with its KV head
    qh = q.transpose(0, 2, 1, 3).reshape(B * H, S, Dp)
    kh = np.repeat(k.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Skv, Dp)
    vh = np.repeat(v.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Skv, Dp)
    scale_log2 = _scale(D) * f32(1.4426950408889634)
    perm = [0, 2, 4, 6, 1, 3, 5, 7]     # the keys of a k8 block in P V
    out = np.zeros((B * H, S, Dp), f32)
    for q0 in range(0, S, BQT):
        rows = np.arange(q0, min(q0 + BQT, S))
        k_end = min(Skv, rows[-1] + 1) if causal else Skv
        k_begin = (max(0, q0 - window + 1) // BKV) * BKV if window else 0
        m = np.full((B * H, len(rows)), NEG_INF, f32)
        l = np.zeros((B * H, len(rows)), f32)
        o = np.zeros((B * H, len(rows), Dp), f32)
        Q = qh[:, rows]
        for kt in range(k_begin, k_end, BKV):
            keys = np.arange(kt, kt + BKV)
            ok = keys < Skv
            Kt = np.where(ok[:, None], kh[:, np.minimum(keys, Skv - 1)], f32(0))
            Vt = np.where(ok[:, None], vh[:, np.minimum(keys, Skv - 1)], f32(0))
            s = np.zeros((B * H, len(rows), BKV), f32)
            for r in range(nsl):                    # partials in rank order
                part = np.zeros_like(s)
                end = min((r + 1) * DV, Dp)
                for d0 in range(r * DV, end, CHAIN * KS):
                    cs = np.zeros_like(s)            # one chain from zero
                    for d in range(d0, min(d0 + CHAIN * KS, end), KS):
                        q_hi, q_lo = split(Q[..., d:d + KS])
                        k_hi, k_lo = split(
                            Kt[..., d:d + KS].transpose(0, 2, 1))
                        cs = mma(cs, q_lo, k_hi)
                        cs = mma(cs, q_hi, k_lo)
                        cs = mma(cs, q_hi, k_hi)
                    part = (part + cs).astype(f32)
                s = (s + part).astype(f32)
            valid = np.broadcast_to(ok, s.shape).copy()
            if causal:
                valid &= rows[:, None] >= keys[None, :]
            if window:
                valid &= (rows[:, None] - keys[None, :]) < window
            s = np.where(valid, s * scale_log2, NEG_INF)
            m_new = np.maximum(m, s.max(-1))
            corr = np.exp2(m - m_new)
            p = np.where(s > NEG_INF, np.exp2(s - m_new[..., None]), f32(0))
            l = fma(l, corr, p.sum(-1, dtype=f32))
            pv = np.zeros_like(o)                    # the tile's chain
            for kk in range(0, BKV, KS):
                blk = [kk + j for j in perm]
                p_hi, p_lo = split(p[..., blk])
                v_hi, v_lo = split(Vt[:, blk])
                pv = mma(pv, p_lo, v_hi)
                pv = mma(pv, p_hi, v_lo)
                pv = mma(pv, p_hi, v_hi)
            o = fma(o, corr[..., None], pv)
            m = m_new
        out[:, rows] = o * (f32(1) / np.maximum(l, f32(1e-30)))[..., None]
    out = out.reshape(B, H, S, Dp).transpose(0, 2, 1, 3)
    return out[..., :D]


def _lanes(x, D):
    """(..., D) -> (..., 32 lanes, 4 NC): lane l's dims 128 i + 4 l + c at
    column 4 i + c, zero past D."""
    chunk = C["ROW_CHUNK"]
    nc = -(-D // chunk)
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, nc * chunk - D)])
    xp = xp.reshape(*x.shape[:-1], nc, 32, 4)
    return np.moveaxis(xp, -3, -2).reshape(*x.shape[:-1], 32, 4 * nc)


def rows_emulation(q, k, v, *, causal, window):
    """``flash_rows_kernel``'s algorithm, one (b, s, h) row at a time."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    KG = C["ROW_KEYS"]
    lane = np.arange(32)
    out = np.zeros((B, S, H, D), f32)
    for b in range(B):
        for h in range(H):
            hk = h // (H // Hkv)
            kl, vl = _lanes(k[b, :, hk], D), _lanes(v[b, :, hk], D)
            for s_ in range(S):
                ke = min(Skv, s_ + 1) if causal else Skv
                kb = max(0, s_ - window + 1) if window else 0
                ql = _lanes(q[b, s_, h] * _scale(D), D)        # (32, 4 NC)
                part = np.zeros((Skv, 32), f32)
                for j in range(ql.shape[1]):    # chunk by chunk, then c
                    part = fma(ql[:, j], kl[:, :, j], part)
                for off in (16, 8, 4, 2, 1):    # the xor butterfly
                    part = (part + part[:, lane ^ off]).astype(f32)
                sc = part[:, 0]
                m, l = NEG_INF, f32(0)
                acc = np.zeros((32, ql.shape[1]), f32)
                for k0 in range(kb, ke, KG):
                    nk = min(KG, ke - k0)
                    mx = max(m, sc[k0:k0 + nk].max())
                    corr = np.exp(f32(m - mx))
                    ps = f32(0)
                    p = [np.exp(f32(sc[k0 + j] - mx)) for j in range(nk)]
                    for pj in p:
                        ps = f32(ps + pj)
                    l = fma(l, corr, ps)
                    acc = (acc * corr).astype(f32)
                    for j, pj in enumerate(p):
                        acc = fma(pj, vl[k0 + j], acc)
                    m = mx
                inv = f32(1) / max(l, f32(1e-30))
                row = np.moveaxis((acc * inv).reshape(32, -1, 4), 1, 0)
                out[b, s_, h] = row.reshape(-1)[:D]
    return out


# (B, S, Skv, H, Hkv, D, causal, window): the round's S = 1 at both
# CLIP widths, the adapter's causal S = 5, a short S against a longer
# Skv, D = 512 with GQA and a window, a ragged S and D, D = 896 not
# causal with Skv != S (MQA), D = 1024 with GQA and a window, D % 4 != 0
CASES = [
    (4, 1, 1, 4, 4, 16, False, None),
    (4, 1, 1, 4, 4, 192, False, None),
    (1, 5, 5, 4, 4, 16, True, None),
    (1, 6, 70, 2, 1, 192, False, None),
    (1, 40, 40, 4, 2, 512, True, 8),
    (1, 77, 77, 2, 2, 600, True, None),
    (1, 100, 120, 2, 1, 896, False, None),
    (1, 77, 77, 4, 2, 1024, True, 20),
    (1, 33, 33, 2, 2, 530, False, 5),
]


@pytest.mark.parametrize("B,S,Skv,H,Hkv,D,causal,window", CASES)
def test_fp32_routes_algorithms_match_jax_pallas(B, S, Skv, H, Hkv, D,
                                                 causal, window):
    q, k, v = _np(1, B, S, H, D), _np(2, B, Skv, Hkv, D), \
        _np(3, B, Skv, Hkv, D)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, block_q=128, block_k=128,
                                   interpret=True))
    tol = 1e-5 * np.abs(want).max()
    got = tf32x3_emulation(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    got = rows_emulation(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = f32(1.0)
    ulp = f32(2.0 ** -10)                    # TF32's ulp at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                  one + 3 * ulp / 4, f32(3.0)], f32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one + ulp, -(one + ulp), one, one + ulp, 3.0],
                          f32))
    r = _np(7, 1000)
    hi, lo = split(r)
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0)
    assert np.all((lo.view(np.uint32) & 0x1FFF) == 0)
    # hi + lo carries about 22 bits: within 2^-21 of |x|
    assert np.all(np.abs((hi.astype(f64) + lo) - r) <= np.abs(r) * 2.0 ** -21)


def test_route_rule():
    for D in (1, 16, 192, 512, 513, 896, 1024):
        for S in range(1, 3 * fa.ROWS_MAX_S):
            assert fa.route(S, D, torch.float32) == (
                "cuda_rows" if S <= fa.ROWS_MAX_S else "cuda_tf32x3")
            assert fa.route(S, D, torch.bfloat16) == (
                "tc" if -(-D // 16) * 16 <= fa.MAX_D_STAGED else "tc_cluster")
    # the FL round's and the serve oracle's attention: S = 1, route 1
    assert fa.route(1, 192, torch.float32) == "cuda_rows"
    assert fa.route(1, 16, torch.float32) == "cuda_rows"
    # the fp32 step check's shapes and the LLaVA adapter's: route 2
    assert fa.route(64, 128, torch.float32) == "cuda_tf32x3"
    assert fa.route(640, 896, torch.float32) == "cuda_tf32x3"


@pytest.mark.parametrize("S,key", [(1, "flash_attention_cuda_rows"),
                                   (fa.ROWS_MAX_S + 1,
                                    "flash_attention_cuda_tf32x3")])
def test_fp32_routes_are_traced_by_route(monkeypatch, S, key):
    """On the card (``_on_cuda`` forced, the kernel stood in for by the
    plain version) an fp32 call traces its route's own key."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t, op: True)
    monkeypatch.setattr(
        ops.fa_kernel, "flash_attention",
        lambda q, k, v, causal, window: ref.flash_attention(
            q, k, v, causal=causal, window=window))
    q = torch.from_numpy(_np(25, 2, S, 4, 16))
    ops.reset_kernel_traces()
    ops.flash_attention(q, q, q, causal=True)
    assert ops.KERNEL_TRACES == {key: 1}


def test_route_counters_reset_together():
    fn = fa.flash_attention
    fn.rows_launches, fn.tf32_launches, fn.cluster_launches = 3, 2, 1
    fn.tc_launches = 5
    assert fa.route_counts() == {"tc_cluster": 1, "cuda_rows": 3,
                                 "cuda_tf32x3": 2, "tc": 4}
    ops.reset_launch_counts()
    assert fa.route_counts() == {"tc_cluster": 0, "cuda_rows": 0,
                                 "cuda_tf32x3": 0, "tc": 0}


def test_emulations_use_the_kernels_constants():
    # route 1: 8 rows a block, 4 keys together, a float4 a lane a chunk
    assert (C["ROW_WARPS"], C["ROW_KEYS"], C["ROW_CHUNK"]) == (8, 4, 128)
    assert "sc[j] = warp_sum(part);" in SRC
    assert "for (int c = 0; c < 4; ++c) part = fmaf(qr[i][c], kr[i][c], " \
        "part);" in SRC
    assert "for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, " \
        "o);" in SRC
    assert "qr[i][c] *= scale;" in SRC
    assert "const int kb = window > 0 ? max(0, s - window + 1) : 0;" in SRC
    assert "p[j] = j < nk ? expf(sc[j] - mx) : 0.f;" in SRC
    # route 2: 64-row q-tiles of 4 warps, 32-key tiles, 128-dim slices,
    # Dp = D rounded up to 8, a 2-stage ring, two blocks an SM
    assert (C["NWT"], C["BKV"], C["DV"]) == (4, 32, fa.DV)
    assert (C["X_STAGES"], C["X_KSTEP"], C["X_MIN_BLOCKS"]) == (2, 8, 2)
    assert C["X_CHAIN"] * C["X_KSTEP"] == C["BKV"] == 32
    # Q, the K/V ring, the cluster's partials and sums: 112 KB, fp32
    pf, nt = C["BKV"] // 8 * 4, 32 * C["NWT"]
    assert fa.TF32X3_SMEM_BYTES == 4 * (
        16 * C["NWT"] * C["DV"] + C["X_STAGES"] * 2 * C["BKV"] * C["DV"]
        + 2 * pf * nt) == 114688
    assert "for (int e = 0; e < 4; ++e) sc[n][e] += cs[n][e];" in SRC
    assert "o[dj][e] = o[dj][e] * cr[e / 2] + pv[e];" in SRC
    assert C["MAX_CLUSTER"] == fa.MAX_CLUSTER and C["MAXD"] == fa.MAX_D
    assert "p.Dp = (D + fx::X_KSTEP - 1) / fx::X_KSTEP * fx::X_KSTEP;" in SRC
    assert "p.nsl = (p.Dp + ft::DV - 1) / ft::DV;" in SRC
    # the three products, small ones first, for Q K^T and for P V
    assert "tc::mma_tf32(cs[n], ql, kh);\n            tc::mma_tf32(cs[n], " \
        "qh, kl);\n            tc::mma_tf32(cs[n], qh, kh);" in SRC
    assert "tc::mma_tf32(pv, pl[kk], vh);\n          tc::mma_tf32(pv, " \
        "ph[kk], vl);\n          tc::mma_tf32(pv, ph[kk], vh);" in SRC
    # P's keys 2c, 2c + 1 as A's k = c, c + 4; V read in the same order
    assert "tc::split_tf32(sc[kk][1], ph[kk][2], pl[kk][2]);" in SRC
    assert "tc::split_tf32(vst[sw(kk * 8 + c2 + 1, dj * 8 + g)], vh[1], " \
        "vl[1]);" in SRC
    # the split: round to nearest (ties away), then the exact remainder
    assert MMA.count('asm("cvt.rna.tf32.f32 %0, %1;\\n"') == 2
    assert "const float r = x - __uint_as_float(hi);" in MMA
    assert "m16n8k8.row.col.f32.tf32.tf32.f32" in MMA
    # the partials in rank order, the softmax in base 2, the band's tiles
    assert SRC.count("if (r < p.nsl) acc += v[r];") == 2
    assert SRC.count("p.scale_log2 = scale * 1.4426950408889634f;") == 2
    assert SRC.count("p.window > 0 ? (max(0, q0 - p.window + 1) / BKV) * "
                     "BKV : 0;") == 3
    # the wrapper's route numbers
    assert fa._F32_ROUTES == {"cuda_rows": 0, "cuda_tf32x3": 1}
    assert "if (route == 0) {" in SRC
