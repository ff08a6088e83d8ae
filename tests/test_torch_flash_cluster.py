"""``flash_attention``'s route above D = 512, on the CPU.

A bf16 call with D > 512 runs ``flash_tc_cluster_kernel``
(``csrc/flash_attention.cu``): the ⌈Dp/128⌉ D-slice blocks of one (b, h,
64-row q-tile) form a thread-block cluster, each forms the partial scores
of every 32-key tile over its 128 dims, the cluster adds the ranks'
partials in rank order (a reduce-scatter then an all-gather through
distributed shared memory), and each block runs the online softmax and
P V on its slice. The kernel runs on the card only
(tests/test_torch_cuda.py, chip_smoke.py); here the route's rule and
cluster size, and a plain fp32 emulation of the kernel's algorithm
(q-tiles of 64, key tiles of 32 from the band's first, the per-slice
partial scores summed in rank order, the masks, exp2 of the scaled
scores with the running max and sum, zero-padded D) held against the JAX
package's Pallas ``flash_attention`` in interpret mode within 1e-5, with
the emulation's constants pinned to the source."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as fa

CSRC = Path(fa.__file__).parent / "csrc"
SRC = (CSRC / "flash_attention.cu").read_text()
C = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SRC)}
NEG_INF = np.float32(-1e30)


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_route_and_cluster_size():
    for D in range(1, fa.MAX_D + 1):
        dp = -(-D // 16) * 16
        assert fa.route(64, D, torch.float32) == "cuda_tf32x3"
        assert fa.route(1, D, torch.float32) == "cuda_rows"
        assert fa.route(64, D, torch.bfloat16) == (
            "tc" if dp <= fa.MAX_D_STAGED else "tc_cluster")
        if fa.route(64, D, torch.bfloat16) == "tc_cluster":
            assert fa.cluster_size(D) == -(-dp // fa.DV)
            assert 5 <= fa.cluster_size(D) <= fa.MAX_CLUSTER
    assert fa.cluster_size(896) == 7 and fa.cluster_size(1024) == 8
    assert fa.cluster_size(513) == 5 and \
        fa.route(64, 512, torch.bfloat16) == "tc"


def cluster_emulation(q, k, v, *, causal, window):
    """The cluster route's algorithm for q (B, S, H, D), k/v (B, Skv, Hkv,
    D) in fp32, one (b, h, q-tile) at a time."""
    f32 = np.float32
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    BQT, BKV, DV = 16 * C["NWT"], C["BKV"], C["DV"]
    Dp = -(-D // 16) * 16
    nsl = -(-Dp // DV)
    pad = lambda t: np.pad(t, ((0, 0), (0, 0), (0, 0), (0, Dp - D)))
    q, k, v = pad(q), pad(k), pad(v)
    scale_log2 = f32(1.0 / math.sqrt(D)) * f32(1.4426950408889634)
    out = np.zeros((B, S, H, Dp), f32)
    for b in range(B):
        for h in range(H):
            hk = h // (H // Hkv)
            for q0 in range(0, S, BQT):
                rows = np.arange(q0, min(q0 + BQT, S))
                q_last = rows[-1]
                k_end = min(Skv, q_last + 1) if causal else Skv
                k_begin = (max(0, q0 - window + 1) // BKV) * BKV \
                    if window else 0
                m = np.full(len(rows), NEG_INF, f32)
                l = np.zeros(len(rows), f32)
                acc = np.zeros((len(rows), Dp), f32)
                for kt in range(k_begin, k_end, BKV):
                    keys = np.arange(kt, kt + BKV)
                    ok = keys < Skv
                    kk = np.where(ok[:, None], k[b, np.minimum(keys, Skv - 1),
                                                 hk], f32(0))
                    vv = np.where(ok[:, None], v[b, np.minimum(keys, Skv - 1),
                                                 hk], f32(0))
                    s = np.zeros((len(rows), BKV), f32)
                    for r in range(nsl):          # partials in rank order
                        sl = slice(r * DV, min((r + 1) * DV, Dp))
                        s = s + q[b, rows, h, sl] @ kk[:, sl].T
                    valid = np.broadcast_to(ok, s.shape).copy()
                    if causal:
                        valid &= rows[:, None] >= keys[None, :]
                    if window:
                        valid &= (rows[:, None] - keys[None, :]) < window
                    s = np.where(valid, s * scale_log2, NEG_INF)
                    m_new = np.maximum(m, s.max(1))
                    corr = np.exp2(m - m_new)
                    p = np.where(s > NEG_INF, np.exp2(s - m_new[:, None]),
                                 f32(0))
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ vv
                    m = m_new
                out[b, rows, h] = acc / np.maximum(l, f32(1e-30))[:, None]
    return out[..., :D]


@pytest.mark.parametrize("B,S,Skv,H,Hkv,D,causal,window", [
    (1, 70, 70, 2, 2, 544, True, None),     # S past one q-tile, nsl 5
    (1, 65, 65, 2, 1, 1024, True, None),    # ragged S, MQA, nsl 8
    (1, 40, 40, 4, 2, 600, True, 8),        # GQA, window, D % 16 != 0
    (1, 33, 50, 2, 2, 530, False, None),    # Skv > S, D % 8 != 0
    (2, 20, 20, 2, 2, 896, False, None),    # the adapter's D, not causal
])
def test_cluster_algorithm_matches_jax_pallas(B, S, Skv, H, Hkv, D, causal,
                                              window):
    q, k, v = _np(1, B, S, H, D), _np(2, B, Skv, Hkv, D), \
        _np(3, B, Skv, Hkv, D)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, block_q=16, block_k=16,
                                   interpret=True))
    got = cluster_emulation(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_emulation_uses_the_kernels_constants():
    assert (C["NWT"], C["BKV"], C["DV"]) == (4, 32, fa.DV)
    assert C["MAX_CLUSTER"] == fa.MAX_CLUSTER
    assert C["MAXD_FAST"] == fa.MAX_D_STAGED and C["MAXD"] == fa.MAX_D
    assert C["NS"] == 2                       # the cluster route's ring
    assert "constexpr int BQT = 16 * NWT;" in SRC
    assert "p.Dp = (D + 15) / 16 * 16;" in SRC
    assert "p.nsl = (p.Dp + ft::DV - 1) / ft::DV;" in SRC
    assert "if (p.Dp <= MAXD_FAST) return (int)ft::launch_tc<2>(p, B, S, st);" \
        in SRC
    # the band of key tiles a q-tile walks
    assert "p.window > 0 ? (max(0, q0 - p.window + 1) / BKV) * BKV : 0;" \
        in SRC
    # the partials summed in rank order by value f's owner, then gathered
    assert "for (int f = sl; f < PF; f += p.nsl) {" in SRC
    assert "if (r < p.nsl) acc += v[r];" in SRC
    assert "red + f * NT + tid,\n                                                    " \
        "f % p.nsl);" in SRC
    # the softmax in base 2 of the scaled sum, P V as hi + lo
    assert "p.scale_log2 = scale * 1.4426950408889634f;" in SRC
    assert "const float v = valid ? sc[n][2 * hh + e] * p.scale_log2 : " \
        "NEG_INF;" in SRC
    assert SRC.count("tc::split_bf16(sc[2 * kk + e / 2][2 * (e % 2)],") == 2
