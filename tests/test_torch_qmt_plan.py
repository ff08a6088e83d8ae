"""The split over N of the tensor-core ``quant_matmul_t`` kernel, on the CPU.

``repro_torch.kernels.lora_matmul.plan_t`` (the generalised ``plan`` with
the contraction N, a 32-wide k-tile granule and the kernel's own fitted
constants) picks how many slices of N the kernel's grid runs for the LoRA
backward's dx gemm ``g (M, N) @ dequant(W (Kq, N))ᵀ``; ``splitk_sum``
adds the fp32 partials in split order. The kernel runs on the card only
(tests/test_torch_cuda.py, chip_smoke.py); here the plan is checked at
the Yi-9B trainer's four linears and at edge shapes, a plain emulation
of the decomposition, per split ``g[:, n0:n1] @ dequant(W)[:, n0:n1]ᵀ``
summed in split order, is held against the JAX package's
``repro.core.quant.dequantize`` within 1e-5 in fp32, and the plain
version's ``out_dtype`` is checked: a bf16 g written in fp32 is exactly
the fp32 product of its upcast, which is why the trainer's backward can
hand the kernel its bf16 cotangent as it is."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import quant as jquant
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import quant as qlib
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ref

torch.set_num_threads(1)
YI = {  # (K, N) of the Yi-9B linears at M = 256 tokens: the backward's
    # dx gemm contracts over N into Kq = K columns
    "wq_wo": (4096, 4096), "wk_wv": (4096, 512),
    "wg_wu": (4096, 11008), "wd": (11008, 4096)}
# plan_t's pick at each, the fastest count measured on the card (PERF.md)
SPLITS = {"wq_wo": 4, "wk_wv": 4, "wg_wu": 4, "wd": 3}
EDGES = [  # (M, Kq, N)
    (37, 256, 20),          # N below one 32-wide k-tile
    (37, 256, 33),          # ragged N: a 1-column last tile
    (256, 11008, 4096),     # Kq = 11008: 86 column tiles
    (1, 4096, 4096),        # one row
    (9, 128, 96),           # M below the 256-row tile
    (256, 4096, 40),        # N % 16 != 0 (element staging of W)
]


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _covers(pl, N):
    """Splits fall on 32-column boundaries, run in order, and cover N
    exactly once."""
    assert pl.unit == lm.BK
    assert len(pl.ranges) == pl.splits and pl.splits in lm.SPLITS
    assert pl.ranges[0][0] == 0 and pl.ranges[-1][1] == N
    for (_, k1), (n0, _) in zip(pl.ranges, pl.ranges[1:]):
        assert k1 == n0
    for n0, n1 in pl.ranges:
        assert n0 % lm.BK == 0 and n0 < n1
    assert pl.ranges == lm.split_ranges(N, pl.unit, pl.splits)


@pytest.mark.parametrize("name", list(YI))
def test_plan_t_at_the_trainer_shapes(name):
    K, N = YI[name]
    pl = lm.plan_t(256, K, N)
    _covers(pl, N)
    assert pl.tiles == -(-K // lm.BN)        # M = 256 is one row of tiles
    assert pl.splits > 1                     # 32-86 tiles alone idle SMs
    assert pl.blocks >= 96
    assert min(n1 - n0 for n0, n1 in pl.ranges) >= 4 * lm.BK
    # the pick is the model's least time (within 2%) over the counts tried
    nu = -(-N // lm.BK)
    costs = {s: lm.plan_cost_us(256, K, pl.tiles, -(-nu // s), s,
                                lm.T_TILE_US, lm.T_PARTIAL_BYTES_PER_US)
             for s in lm.SPLITS if s == 1 or nu // s >= 4}
    assert pl.splits == SPLITS[name]
    assert costs[pl.splits] <= 1.02 * min(costs.values())


@pytest.mark.parametrize("M,Kq,N", EDGES)
def test_plan_t_at_edge_shapes(M, Kq, N):
    pl = lm.plan_t(M, Kq, N)
    _covers(pl, N)
    assert pl.tiles == -(-M // 256) * -(-Kq // 128)
    if N < 4 * lm.BK:
        assert pl.splits == 1


@pytest.mark.parametrize("splits", [None, 1, 2, 3])
@pytest.mark.parametrize("bits,mode,M,K,N", [
    (4, "nf4", 37, 200, 33), (8, "linear", 9, 256, 96),
    (4, "linear", 16, 448, 130), (4, "nf4", 5, 64, 20)])
def test_split_over_n_emulation_matches_the_jax_reference(bits, mode, M, K,
                                                          N, splits):
    """The kernel's decomposition in plain fp32 torch: each split's
    ``g_s @ dequant(W)_sᵀ`` over its columns of N, summed in split order,
    equals ``g @ repro.core.quant.dequantize(w)ᵀ`` over the padded Kq."""
    w, g = _np(41, K, N) / np.float32(np.sqrt(K)), _np(42, M, N)
    jqt = jref.blockwise_quant(jnp.asarray(w), bits=bits, block=64,
                               mode=mode)
    jw = np.asarray(jquant.dequantize(jqt, jnp.float32))       # (Kq, N)
    want = g @ jw.T
    qt = convert.tree_from_numpy({"w": jqt}, "cpu")["w"]
    wd = qlib.dequantize(qt, torch.float32)
    Kq = wd.shape[0]
    pl = lm.plan_t(M, Kq, N)
    ranges = pl.ranges if splits is None else \
        lm.split_ranges(N, pl.unit, splits)
    gt = torch.from_numpy(g)
    got = torch.zeros((M, Kq))
    for n0, n1 in ranges:
        got += gt[:, n0:n1] @ wd[:, n0:n1].t()
    assert got.shape == want.shape == (M, Kq)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits,mode", [(8, "linear"), (4, "linear"),
                                       (4, "nf4")])
def test_plain_quant_matmul_t_fp32_out_of_a_bf16_g_is_its_upcast_product(
        bits, mode):
    qt = ref.blockwise_quant(torch.from_numpy(_np(43, 200, 33)), bits=bits,
                             block=64, mode=mode)
    g = torch.from_numpy(_np(44, 37, 33)).to(torch.bfloat16)
    got = ref.quant_matmul_t(g, qt, out_dtype=torch.float32)
    want = ref.quant_matmul_t(g.float(), qt)
    assert got.dtype == torch.float32 and got.shape == (37, 256)
    assert torch.equal(got, want)
    # the default output dtype stays g's
    assert ref.quant_matmul_t(g, qt).dtype == torch.bfloat16


def test_wrapper_takes_fp32_out_only_from_a_bf16_g():
    """A bf16 g may write fp32 (the trainer's backward); an fp32 g writes
    fp32 only. The dtype check comes before any device check."""
    qt = ref.blockwise_quant(torch.from_numpy(_np(45, 64, 32)), bits=8,
                             block=32)
    g32 = torch.from_numpy(_np(46, 2, 32))
    with pytest.raises(TypeError, match="out_dtype"):
        lm.quant_matmul_t(g32, qt, out_dtype=torch.bfloat16)
    # past the dtype check, a CPU tensor is refused: no plain fallback
    for g, out in ((g32, None), (g32.to(torch.bfloat16), torch.float32),
                   (g32.to(torch.bfloat16), None)):
        with pytest.raises(ValueError, match="CUDA"):
            lm.quant_matmul_t(g, qt, out_dtype=out)
