"""``lora_matmul``'s decode route, on the CPU.

At decode rows (``M <= lora_matmul.MAX_ROWS``) the fused LoRA linear runs
``csrc/lora_gemv.cu``: ``h = x@A`` in one small launch (chunks of K, row
lanes summed in order, then the chunks in order by the GEMV's leader),
then the serve GEMV of ``csrc/gemv.cuh`` (K split over a thread-block
cluster; each CTA's row lanes summed in order, the ranks' partials summed
in rank order by the leader), to which the leader adds ``s·h@B``. The
kernels run on the card only (tests/test_torch_cuda.py, chip_smoke.py);
here the route's rule, the plan (every quant group and column covered
once, clusters of at most 8 CTAs, the shared memory within the card's),
and a plain fp32 emulation of the kernels' summation order held against
the JAX package's Pallas ``lora_matmul`` in interpret mode within 1e-5,
with the emulation's constants pinned to the sources; the op's trace key
and launch count for the route, and the autotune lookup of the route
that runs."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.lora_matmul import lora_matmul as pallas_lora
from repro_torch import convert
from repro_torch.core import quant as qlib
from repro_torch.kernels import autotune
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
CSRC = Path(lm.__file__).parent / "csrc"
SCALE = 2.0
# the decode steps' linears (K, N): Yi-9B, LLaVA-NeXT-34B, Kimi-K2's wq,
# and phase 16's rank blocks of Yi-9B (wq/wk/wv/wg/wu column blocks, wo and
# wd row blocks)
DECODE = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
          (7168, 7168), (7168, 1024), (7168, 20480), (20480, 7168),
          (7168, 8192), (4096, 256), (256, 4096), (4096, 688), (688, 4096)]


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _src(name):
    return (CSRC / name).read_text()


def _consts(text):
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("K,N", DECODE)
def test_plan_covers_every_group_and_column_once(M, K, N):
    G = -(-K // 64)
    pl = lm.plan_gemv(M, G, N, 64)
    assert pl is not None and 1 <= pl.cluster <= lm.GEMV_CLUSTER_MAX
    assert pl.cluster == 1 or pl.ctas <= lm.GEMV_MAX_CTAS
    assert lm.gemv_smem_bytes(M, G, 64, pl.cols, pl.cluster) <= \
        lm.GEMV_SMEM_MAX
    assert (pl.cols, pl.cluster) in lm.gemv_plans(M, G, N, 64)
    seen = np.zeros((G, N), np.int32)
    for bx in range(pl.tiles * pl.cluster):   # rank = blockIdx.x % cluster
        tile, rank = divmod(bx, pl.cluster)
        g0, g1 = pl.groups[rank]
        assert (g0, g1) == (rank * G // pl.cluster,
                            (rank + 1) * G // pl.cluster)
        seen[g0:g1, tile * pl.cols:min(N, (tile + 1) * pl.cols)] += 1
    assert (seen == 1).all()
    # a launch that reaches the card's SMs where a plan in one wave does
    assert pl.ctas >= min(lm.SMS, max(
        [-(-N // c) * k for c, k in lm.gemv_plans(M, G, N, 64)
         if lm.gemv_waves(M, G, N, 64, c, k) == 1], default=0))


def _qt(K, N, bits, mode, seed=3, block=64):
    w = _np(seed, K, N) / np.float32(np.sqrt(K))
    j = jref.blockwise_quant(jnp.asarray(w), bits=bits, block=block,
                             mode=mode)
    return j, convert.tree_from_numpy({"w": j}, "cpu")["w"]


def test_route_boundaries():
    _, qt = _qt(256, 96, 4, "nf4")
    for M in range(1, lm.MAX_ROWS + 1):
        assert lm.route(M, 96, qt, torch.bfloat16) == "gemv"
        assert lm.route(M, 96, qt, torch.float32) == "gemv"
    M = lm.MAX_ROWS + 1
    assert lm.route(M, 96, qt, torch.bfloat16) == "tc"
    assert lm.route(M, 96, qt, torch.float32) == "tf32x3"
    # N % 4 != 0 and a payload off 4-byte alignment leave the GEMV
    _, odd = _qt(256, 33, 4, "nf4")
    assert lm.route(4, 33, odd, torch.bfloat16) == "tc"
    flat = torch.zeros(qt.q.numel() + 1, dtype=qt.q.dtype)
    shifted = dataclasses.replace(qt, q=flat[1:].view(qt.q.shape))
    assert shifted.q.data_ptr() % 4 == 1
    assert lm.route(4, 96, shifted, torch.float32) == "tf32x3"
    # a K whose slice no cluster of 8 holds in shared memory
    assert lm.plan_gemv(8, 4096, 512, 64) is None
    _, wide = _qt(64, 8, 8, "linear")
    assert lm.route(4, 8, wide, torch.bfloat16) == "gemv"
    assert lm.MAX_ROWS == max(lm.GEMV_ROW_BOUNDS) == 8
    assert [lm.gemv_row_bound(M) for M in range(1, 9)] == \
        [1, 2, 4, 4, 8, 8, 8, 8]


def gemv_emulation(x, wd, a, b, block, rows, pl, scale):
    """The decode route's sums for x (M, Kq) (zero past K) against the
    decoded weight wd (Kq, N) and the pair A (K, r), B (r, N), in fp32:
    x@A by ``lora_h_kernel`` (chunk c of K, lane l summing rows k0 + l,
    k0 + l + 8, ... in order, the lanes then the chunks in order); x@W by
    the GEMV (rank r of a cluster over groups ``pl.groups[r]``, row lane
    l over code rows l, l + lanes, ..., an int4 code row covering K rows
    2i then 2i + 1; the lanes in order, then the ranks); then the
    leader's ``v + scale · Σ_j h[m, j] B[j, n]``."""
    f32 = np.float32
    M, K, r = x.shape[0], a.shape[0], a.shape[1]
    hc = lm.h_chunks(K)
    kc = -(-K // hc)
    h = np.zeros((M, r), f32)
    for c in range(hc):
        k0, k1 = c * kc, min(K, (c + 1) * kc)
        part = np.zeros((M, r), f32)
        for lane in range(lm.H_LANES):
            acc = np.zeros((M, r), f32)
            for k in range(k0 + lane, k1, lm.H_LANES):
                acc = acc + x[:, k, None] * a[None, k, :]
            part = part + acc
        h = h + part
    lanes = lm.GEMV_THREADS // (pl.cols // lm.GEMV_COLS_PER_THREAD)
    k_per_row = block // rows
    y = np.zeros((M, wd.shape[1]), f32)
    for g0, g1 in pl.groups:
        red = np.zeros_like(y)
        for lane in range(lanes):
            acc = np.zeros_like(y)
            for i in range(lane, (g1 - g0) * rows, lanes):
                for hh in range(k_per_row):
                    k = g0 * block + k_per_row * i + hh
                    acc = acc + x[:, k, None] * wd[None, k, :]
            red = red + acc
        y = y + red
    t = np.zeros_like(y)
    for j in range(r):
        t = t + h[:, j, None] * b[None, j, :]
    return y + f32(scale) * t


@pytest.mark.parametrize("bits,mode,M,K,N,r", [
    (4, "nf4", 4, 256, 96, 4), (8, "linear", 3, 200, 40, 20),
    (4, "linear", 8, 320, 64, 16), (4, "nf4", 1, 704, 136, 8)])
def test_gemv_summation_order_matches_jax_pallas(bits, mode, M, K, N, r):
    jqt, qt = _qt(K, N, bits, mode)
    x = _np(4, M, K)
    a, b = _np(5, K, r) / np.float32(np.sqrt(K)), _np(6, r, N)
    want = np.asarray(pallas_lora(jnp.asarray(x), jqt, jnp.asarray(a),
                                  jnp.asarray(b), scale=SCALE, block_m=8,
                                  block_n=32, interpret=True))
    wd = qlib.dequantize(qt, torch.float32).numpy()       # (Kq, N)
    Kq = wd.shape[0]
    G, rows = qt.q.shape[-3], qt.q.shape[-2]
    pl = lm.plan_gemv(M, G, N, qt.block)
    assert pl.cluster > 1 or G == 1
    got = gemv_emulation(np.pad(x, ((0, 0), (0, Kq - K))), wd, a, b,
                         qt.block, rows, pl, SCALE)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_emulation_uses_the_kernels_constants():
    gv, lg = _src("gemv.cuh"), _src("lora_gemv.cu")
    c = {**_consts(gv), **_consts(lg)}
    assert c["GV_THREADS"] == lm.GEMV_THREADS
    assert c["GV_CPT"] == lm.GEMV_COLS_PER_THREAD
    assert (c["HROWS"], c["HLANES"], c["HCOLS"], c["HCHUNK"],
            c["HCHUNKS_MAX"]) == (lm.H_ROWS, lm.H_LANES, lm.H_COLS,
                                  lm.H_CHUNK, lm.H_CHUNKS_MAX)
    assert lm.H_ROWS == lm.MAX_ROWS and lm.H_COLS == lm.MAX_RANK
    # x@A: each lane's rows in order, the lanes, then the chunks
    assert "for (int k = lane; k < n; k += HLANES) {" in lg
    assert "const int k0 = c * kc, n = min(K, k0 + kc) - k0;" in lg
    assert "for (int l = 0; l < HLANES; ++l) v += red[l][m][jj];" in lg
    assert "for (int c = 0; c < hchunks; ++c)\n        h += hpart[((size_t)c " \
        "* M + m) * r + j];" in lg
    assert "const int hc = h_chunks(K), kc = (K + hc - 1) / hc;" in lg
    assert c["HSTAGE_MAX"] == lm.H_STAGE_MAX
    # the GEMV's ranks, lanes and sums as emulated, then s·h@B
    assert "const int g0 = rank * G / csize;" in gv
    assert "const int lanes = GV_THREADS / tpc;" in gv
    assert "for (int r = 0; r < lanes; ++r) v += part[r * per + o];" in gv
    assert "for (int r = 0; r < csize; ++r) v += slots[r * per + o];" in gv
    assert "gv::gemv_kernel<T, FMT, MR, LMAX, LoraGemvOut<T>>" in lg
    assert "t = fmaf(hs[m * HCOLS + j], b[(size_t)j * N + n], t);" in lg
    assert "dq::store_f(y + (size_t)m * N + n, v + scale * t);" in lg
    # the launcher's refusals and row bounds, the plan's limits
    assert f"csize > {lm.GEMV_CLUSTER_MAX} ||" in lg
    assert "GV_THREADS % (cols / GV_CPT)" in lg
    assert "const int mr = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;" in lg
    # the shared memory the plan counts
    assert "return gv::gv_smem_floats(MR, cols, csize, kxp, gmax, true) +" \
        in lg
    assert "static constexpr bool kReuse = true;" in lg
    assert "? GV_THREADS * MR * GV_CPT : MR * kxp + gmax * cols);" in gv
    assert "constexpr bool REUSE = MR > 4 || Epilogue::kReuse;" in gv
    assert "return (gmax * block + 3) & ~3;" in gv


@pytest.mark.parametrize("rows,key", [(2, "lora_matmul_cuda_gemv"),
                                      (lm.MAX_ROWS, "lora_matmul_cuda_gemv"),
                                      (lm.MAX_ROWS + 1,
                                       "lora_matmul_cuda_tc")])
def test_decode_rows_are_traced_on_their_route(monkeypatch, rows, key):
    """On the card (``_on_cuda`` forced, the kernel stood in for by its
    plain version) a bf16 call of up to ``MAX_ROWS`` rows traces the
    decode route's key, past them the tensor cores'."""
    calls = []
    monkeypatch.setattr(ops, "_on_cuda", lambda t, op: True)
    monkeypatch.setattr(
        ops.lm_kernel, "lora_matmul",
        lambda x_, w, a_, b_, scale: calls.append(x_.shape) or
        ref.lora_matmul(x_, w, a_, b_, scale=scale))
    _, qt = _qt(64, 32, 4, "nf4")
    x = torch.from_numpy(_np(7, rows, 64)).to(torch.bfloat16)
    a, b = torch.from_numpy(_np(8, 64, 4)), torch.from_numpy(_np(9, 4, 32))
    ops.reset_kernel_traces()
    ops.lora_matmul(x, qt, a, b, scale=1.0)
    assert calls == [(rows, 64)]
    assert ops.KERNEL_TRACES == {key: 1}


def test_new_route_counters_reset_together():
    lm.lora_matmul.gemv_launches = 3
    ops.fa_kernel.flash_attention.cluster_launches = 2
    ops.reset_launch_counts()
    assert lm.lora_matmul.gemv_launches == 0
    assert ops.fa_kernel.flash_attention.cluster_launches == 0


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    autotune.clear()
    yield
    autotune.clear()


def test_autotune_reads_only_the_route_that_runs(cache, monkeypatch):
    """At decode rows a tc split count cached for the shape is not read
    (the call stays on the decode route, at its plan); a cached decode
    plan is; past the decode rows the tc split count is."""
    seen = []
    monkeypatch.setattr(lm, "lora_matmul",
                        lambda x, qt, a, b, *, scale: seen.append("plan"))
    monkeypatch.setattr(lm, "_lora_matmul",
                        lambda x, qt, a, b, scale, splits, gemv_plan=None:
                        seen.append((splits, gemv_plan and (
                            gemv_plan.cols, gemv_plan.cluster))))
    _, qt = _qt(256, 128, 4, "nf4")
    a, b = torch.zeros((256, 4)), torch.zeros((4, 128))
    x4 = torch.zeros((4, 256), dtype=torch.bfloat16)
    x16 = torch.zeros((16, 256), dtype=torch.bfloat16)
    for M in (4, 16):
        autotune._CACHE[autotune.key_for("lora_matmul", M, 256, 128, bits=4,
                                         mode="nf4")] = (2,)
    ops._lora_kernel(x4, qt, a, b, 2.0)
    assert seen == ["plan"]
    cands = autotune.lora_gemv_candidates(4, 256, 128, 64)
    assert (64, 2) in cands and all(c <= lm.GEMV_CLUSTER_MAX
                                    for _, c in cands)
    autotune._CACHE[autotune.key_for("lora_matmul_gemv", 4, 256, 128,
                                     bits=4, mode="nf4")] = (64, 2)
    ops._lora_kernel(x4, qt, a, b, 2.0)
    ops._lora_kernel(x16, qt, a, b, 2.0)
    assert seen[1:] == [(None, (64, 2)), (2, None)]
