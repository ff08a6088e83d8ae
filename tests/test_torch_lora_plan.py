"""The split-K plan of the tensor-core ``lora_matmul`` kernel, on the CPU.

``repro_torch.kernels.lora_matmul.plan`` picks, for a bf16 call, how many
slices of the contraction dim the kernel's grid runs (split z owning
``plan.ranges[z]``) and ``splitk_sum`` adds them in order. The kernel
runs on the card only (tests/test_torch_cuda.py, chip_smoke.py); here
the plan's arithmetic is checked at the Yi-9B trainer's four linears and
at edge shapes, and a plain emulation of the decomposition, per split
``x_s @ dequant(W)_s + scale·(x_s@A_s)@B`` summed in split order, is held
against the JAX package's ``repro.kernels.ref.lora_matmul`` within 1e-5
in fp32. The op's trace keys tell the bf16 (tensor-core) route from the
fp32 (CUDA-core) one."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import quant as qlib
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
YI = {  # (K, N) of the Yi-9B linears at M = 256 tokens, and their split
    "wq_wo": (4096, 4096, 4), "wk_wv": (4096, 512, 32),
    "wg_wu": (4096, 11008, 3), "wd": (11008, 4096, 4)}
# the shapes tests/test_torch_cuda.py runs on the card for each count
SPLIT_SHAPES = {1: (512, 512, 4096), 2: (64, 1024, 8192),
                3: (256, 4096, 11008), 4: (256, 4096, 4096),
                8: (64, 1024, 1024), 16: (64, 2048, 1024),
                32: (256, 4096, 512)}
EDGES = [  # (M, K, N, block)
    (37, 200, 33, 64),      # odd K (padded to 256), ragged N
    (9, 128, 96, 64),       # M below the 256-row tile
    (37, 201, 48, 64),      # K % 8 != 0
    (1, 4096, 4096, 64),    # one row
    (5, 96, 40, 32),        # block 32: unit 32
    (256, 4096, 512, 96),   # block 96: unit lcm(96, 32) = 96
    (256, 4096, 512, 16),   # the smallest block the kernel takes
]
SCALE = 2.0


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _covers(pl, K, block):
    """Splits fall on unit (whole-group, whole-tile) boundaries, run in
    order, and cover the padded K exactly once."""
    Kq = -(-K // block) * block
    assert pl.unit % block == 0 and pl.unit % lm.BK == 0
    assert len(pl.ranges) == pl.splits and pl.splits in lm.SPLITS
    assert pl.ranges[0][0] == 0 and pl.ranges[-1][1] == Kq
    for (k0, k1), (n0, _) in zip(pl.ranges, pl.ranges[1:]):
        assert k1 == n0
    for k0, k1 in pl.ranges:
        assert k0 % pl.unit == 0 and k0 % block == 0 and k0 < k1
        assert k1 % block == 0
    assert pl.ranges == lm.split_ranges(Kq, pl.unit, pl.splits)


@pytest.mark.parametrize("name", list(YI))
def test_plan_at_the_trainer_shapes(name):
    K, N, splits = YI[name]
    pl = lm.plan(256, K, N, 64)
    _covers(pl, K, 64)
    assert pl.splits == splits
    assert pl.tiles == -(-N // 128)          # M = 256 is one row of tiles
    assert pl.blocks >= 100            # the grid fills most of 132 SMs
    # every split keeps at least 4 k-tiles of 32
    assert min(k1 - k0 for k0, k1 in pl.ranges) >= 4 * lm.BK


@pytest.mark.parametrize("M,K,N,block", EDGES)
def test_plan_at_edge_shapes(M, K, N, block):
    pl = lm.plan(M, K, N, block)
    _covers(pl, K, block)
    assert pl.tiles == -(-M // 256) * -(-N // 128)


@pytest.mark.parametrize("splits", lm.SPLITS)
def test_plan_returns_each_split_count(splits):
    M, K, N = SPLIT_SHAPES[splits]
    pl = lm.plan(M, K, N, 64)
    assert pl.splits == splits
    _covers(pl, K, 64)


@pytest.mark.parametrize("splits", [None, 1, 2, 4])
@pytest.mark.parametrize("bits,mode,M,K,N", [
    (4, "nf4", 37, 200, 33), (8, "linear", 9, 256, 96),
    (4, "linear", 16, 448, 40)])
def test_split_k_emulation_matches_the_jax_reference(bits, mode, M, K, N,
                                                     splits):
    """The kernel's decomposition in plain fp32 torch: each split's base
    product and its own scale·h_s@B, summed in split order, equals
    ``repro.kernels.ref.lora_matmul`` on the same quantized weight."""
    w, x = _np(11, K, N) / np.float32(np.sqrt(K)), _np(12, M, K)
    a, b = _np(13, K, 4) / np.float32(np.sqrt(K)), _np(14, 4, N)
    jqt = jref.blockwise_quant(jnp.asarray(w), bits=bits, block=64,
                               mode=mode)
    want = np.asarray(jref.lora_matmul(jnp.asarray(x), jqt, jnp.asarray(a),
                                       jnp.asarray(b), scale=SCALE))
    qt = convert.tree_from_numpy({"w": jqt}, "cpu")["w"]
    wd = qlib.dequantize(qt, torch.float32)              # (Kq, N)
    Kq = wd.shape[0]
    pl = lm.plan(M, K, N, 64)
    ranges = pl.ranges if splits is None else \
        lm.split_ranges(Kq, pl.unit, splits)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, Kq - K))
    ap = torch.nn.functional.pad(torch.from_numpy(a), (0, 0, 0, Kq - K))
    bt = torch.from_numpy(b)
    got = torch.zeros((M, N))
    for k0, k1 in ranges:
        xs = xp[:, k0:k1]
        got += xs @ wd[k0:k1] + SCALE * ((xs @ ap[k0:k1]) @ bt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,lora_key,flash_key", [
    (torch.bfloat16, "lora_matmul_cuda_tc", "flash_attention_cuda_tc"),
    (torch.float32, "lora_matmul_cuda_tf32x3",
     "flash_attention_cuda_rows")])
def test_card_routes_are_traced_by_dtype(monkeypatch, dtype, lora_key,
                                         flash_key):
    """On the card (``_on_cuda`` forced, the kernels stood in for by their
    plain versions) bf16 calls past the decode route's rows trace the
    tensor-core keys and fp32 calls the 3xTF32 ``lora_matmul`` key and
    the attention's route at S = 5 (``"cuda_rows"``); both reach the same
    kernel wrapper."""
    calls = []
    monkeypatch.setattr(ops, "_on_cuda", lambda t, op: True)
    monkeypatch.setattr(
        ops.lm_kernel, "lora_matmul",
        lambda x_, w, a_, b_, scale: calls.append("lora_matmul") or
        ref.lora_matmul(x_, w, a_, b_, scale=scale))
    monkeypatch.setattr(
        ops.fa_kernel, "flash_attention",
        lambda q, k, v, causal, window: calls.append("flash_attention") or
        ref.flash_attention(q, k, v, causal=causal, window=window))
    x = torch.from_numpy(_np(21, lm.MAX_ROWS + 1, 64)).to(dtype)
    qt = ref.blockwise_quant(torch.from_numpy(_np(22, 64, 32)), bits=4,
                             block=64, mode="nf4")
    a, b = torch.from_numpy(_np(23, 64, 4)), torch.from_numpy(_np(24, 4, 32))
    q = torch.from_numpy(_np(25, 1, 5, 2, 16)).to(dtype)
    ops.reset_kernel_traces()
    ops.lora_matmul(x, qt, a, b, scale=1.0)
    ops.flash_attention(q, q, q, causal=True)
    assert calls == ["lora_matmul", "flash_attention"]
    assert ops.KERNEL_TRACES == {lora_key: 1, flash_key: 1}
    assert lm.route(lm.MAX_ROWS + 1, 32, qt, dtype) == \
        ("tc" if dtype == torch.bfloat16 else "tf32x3")


def test_launch_counters_reset_together():
    ops.reset_launch_counts()
    assert ops.tc_launch_counts() == {"flash_attention": 0,
                                      "lora_matmul": 0,
                                      "quant_matmul_t": 0}
    assert set(ops.TC_KERNELS) <= set(ops.KERNELS)
