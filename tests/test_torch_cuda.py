"""The port's CUDA kernels against their plain PyTorch versions, on the
card. This file imports neither JAX nor the JAX package, so it runs on a
machine with an H100 and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a Hopper GPU every test skips with its reason. Tolerances: fp32
1e-5 (TF32 off), bf16 2e-2 times the largest magnitude (the JAX
package's bf16 bound), ``blockwise_quant`` bitwise, ``selective_scan``,
its backward kernel and the op's gradient 1e-5 times each output's
largest magnitude (the JAX package's interpret-vs-plain bound), the
backward kernel and ``quant_matmul`` bitwise equal across two calls. bf16 ``flash_attention`` and
``lora_matmul`` run their tensor-core kernels; ``lora_matmul`` past its
decode rows, ``quant_matmul`` past the GEMV's 4 rows and
``quant_matmul_t`` pick by dtype: bf16 the tc routes (``quant_matmul_t``'s
held to 1e-4 of the largest magnitude in fp32 output: W enters as two
bf16 parts, about 16 bits), fp32 the 3xTF32 routes (``"tf32x3"``) at
1e-5 and bitwise equal across two calls, their first designs forced
beside them. ``lora_matmul`` at decode rows (up to
``MAX_ROWS``) runs its decode route in either dtype, and bf16
``flash_attention`` above D = 512 its cluster route, each bitwise equal
across two calls. fp32 ``flash_attention`` runs ``"cuda_rows"`` up to
``ROWS_MAX_S`` query rows and ``"cuda_tf32x3"`` past them; each, forced
at every fp32 case, is held at 1e-5 of the largest magnitude and
bitwise equal across two calls."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import blockwise_quant as bq_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import lora_matmul as lm_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qmm_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as ss_kernel

FORMATS = [(8, "linear"), (4, "linear"), (4, "nf4")]
F32, BF16 = torch.float32, torch.bfloat16
FLASH_CASES = [  # (B, S, H, Hkv, D, causal, window, dtype)
    (1, 1, 4, 4, 192, False, None, F32),   # the adapter at S=1, CLIP width
    # the federated round's adapter: a cohort of 5 x 32 rows at ViT-B/32
    # width, one client's 32 and the eval batch at CLIPConfig()'s D = 16
    (160, 1, 4, 4, 192, False, None, F32),
    (32, 1, 4, 4, 16, False, None, F32),
    (128, 1, 4, 4, 16, False, None, F32),
    (2, 40, 4, 2, 16, True, 8, F32),       # GQA, causal, sliding window
    (1, 33, 2, 2, 24, False, None, F32),   # D not a power of two
    (1, 5, 4, 4, 16, True, None, F32),     # the adapter's causal S=5
    (4, 64, 8, 8, 512, True, None, F32),   # the adapter at Yi-9B width
    (2, 40, 4, 2, 512, True, 8, F32),      # D=512 with GQA and a window
    # bf16: the tensor-core kernel
    (4, 64, 32, 4, 128, True, None, BF16),  # Yi-9B backbone, GQA 32/4
    (4, 64, 8, 8, 512, True, None, BF16),   # the adapter at Yi-9B width
    (1, 33, 2, 2, 72, False, None, BF16),   # D % 16 != 0: zero-padded
    (1, 33, 2, 2, 36, True, None, BF16),    # D % 8 != 0: element loads
    (2, 50, 4, 2, 64, True, 8, BF16),       # ragged S = 50, a window
    (2, 40, 4, 2, 512, False, None, BF16),  # GQA with D = 512
    (1, 1, 4, 4, 192, False, None, BF16),   # S = 1, three D slices
]
# the zoo's attention shapes, with a key length of their own:
# (B, S, Skv, H, Hkv, D, causal, window, dtype)
FLASH_KV_CASES = [
    # the adapter at LLaVA-NeXT-34B width: 576 patches + 64 tokens, D = 896
    (4, 640, 640, 8, 8, 896, True, None, F32),
    (4, 640, 640, 8, 8, 896, True, None, BF16),
    (2, 40, 40, 4, 2, 1024, True, 8, F32),     # D = 1024, GQA, a window
    (2, 40, 40, 4, 2, 1024, True, 8, BF16),
    (1, 33, 33, 2, 2, 600, False, None, BF16),  # D > 512, D % 16 != 0
    (1, 33, 33, 2, 2, 532, True, None, BF16),   # D > 512, D % 8 != 0
    (1, 33, 33, 2, 2, 777, False, None, F32),
    # Whisper-medium: the decoder's cross-attention to 1500 frames (not a
    # multiple of the key tile) and the encoder, both not causal
    (4, 64, 1500, 16, 16, 64, False, None, BF16),
    (4, 64, 1500, 16, 16, 64, False, None, F32),
    (4, 1500, 1500, 16, 16, 64, False, None, BF16),
    # RecurrentGemma-2B: MQA, 10 query heads a KV head, D = 256, window
    (4, 64, 64, 10, 1, 256, True, 2048, BF16),
    (4, 64, 64, 10, 1, 256, True, 2048, F32),
]
# (M, K, N) at which lora_matmul.plan returns each split count (NF4,
# block 64; tests/test_torch_lora_plan.py pins them on the CPU)
SPLIT_SHAPES = {1: (512, 512, 4096), 2: (64, 1024, 8192),
                3: (256, 4096, 11008), 4: (256, 4096, 4096),
                8: (64, 1024, 1024), 16: (64, 2048, 1024),
                32: (256, 4096, 512)}
LORA_CASES = [  # (M, K, N, bits, mode, dtype, rank)
    (256, 4096, 512, 4, "nf4", BF16, 16),     # Yi-9B wk/wv
    (37, 200, 33, 8, "linear", F32, 4),       # odd K, ragged N
    (37, 200, 33, 4, "linear", F32, 4),
    (9, 128, 96, 4, "nf4", F32, 20),          # rank padded to 32
    # bf16: the tensor-core kernel
    (256, 4096, 4096, 4, "nf4", BF16, 16),    # Yi-9B wq/wo
    (256, 4096, 11008, 4, "nf4", BF16, 16),   # Yi-9B wg/wu
    (256, 11008, 4096, 4, "nf4", BF16, 16),   # Yi-9B wd
    (37, 200, 33, 4, "nf4", BF16, 4),         # odd K, ragged N, r = 4
    (37, 201, 48, 4, "nf4", BF16, 4),         # K % 8 != 0: element loads
    (64, 512, 256, 8, "linear", BF16, 16),    # int8
    (64, 512, 256, 4, "linear", BF16, 16),    # int4
    (9, 128, 96, 4, "nf4", BF16, 20),         # r = 20 padded to 32, M < 128
    # the decode step: 4 streams x 1 token through the Yi-9B projections,
    # on the decode route
    (4, 4096, 4096, 4, "nf4", BF16, 16),      # wq/wo
    (4, 4096, 512, 4, "nf4", BF16, 16),       # wk/wv
    (4, 4096, 11008, 4, "nf4", BF16, 16),     # wg/wu
    (4, 11008, 4096, 4, "nf4", BF16, 16),     # wd
] + [(M, K, N, 4, "nf4", BF16, 16) for s, (M, K, N) in SPLIT_SHAPES.items()
     if s not in (3, 4, 32)]        # 3, 4, 32: wg/wu, wq/wo, wk/wv above
QMM_CASES = [  # (T, M, K, N): T users of M rows; T = 0 a plain 2-D weight
    (4, 3, 100, 70),       # ragged N: the tiled kernel; odd K pads
    (4, 1, 100, 96),       # the GEMV with an odd K
    (4, 6, 100, 128),      # the tiled kernel past 4 rows
    (0, 2, 100, 64),       # the GEMV on a plain 2-D weight
    (1, 1, 768, 768),      # one user: a cluster of 12 CTAs
    (1, 1, 1024, 768),     # 16 quant groups: a cluster of 8 CTAs
    (2, 2, 768, 768),
    (4, 1, 768, 768),      # the serve replay's shape
    (8, 4, 768, 768),
    (4, 3, 256, 100),      # N % 16 != 0: the GEMV's 4-byte code loads
]
QMM_TC_CASES = [  # (T, M, K, N) of the tc route, cut from the trainers'
    (0, 7, 1792, 512),     # Kimi-K2's expert rows, K split
    (0, 256, 640, 1920),   # RecurrentGemma-2B's MLP rows
    (2, 7, 640, 384),      # a stacked QTensor, T = 2
    (2, 256, 200, 70),     # stacked, odd K (padded to 256), ragged N
    (0, 37, 200, 33),      # odd K, N % 16 != 0: element copies
]
# (bits, block) of the quantizer: the store's 64 and the other blocks
# it can pick; odd blocks only at int8 (int4 packs row pairs)
BQ_BLOCKS = [(b, k) for b in (8, 4) for k in (2, 16, 64, 128)] + [(8, 5)]
SCAN_CASES = [  # (B, S, di, N)
    (4, 64, 8192, 16),     # the trainer's shape at Falcon-Mamba-7B width
    (1, 50, 520, 4),       # S and di off every block size, B = 1
    (2, 50, 520, 8),
    (2, 130, 33, 5),       # several time chunks, N padded to 8
]


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card (chip_smoke.py holds them against their plain "
                    "versions there)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("T,M,K,N", QMM_CASES)
def test_cuda_quant_matmul_matches_plain(cuda_device, T, M, K, N, bits,
                                         mode, dtype):
    """Every format and dtype, through the GEMV (M <= 4, N % 4 == 0), the
    tc kernel (bf16) or the 3xTF32 one (fp32), counted by route; two
    calls bitwise equal."""
    lead = (T,) if T else ()
    # the serve widths' weights at 1/sqrt(K), so outputs are O(1) as the
    # head's are; the K = 100 edge cases keep their unit weights
    w = _np(23, *lead, K, N) / (np.sqrt(K) if K > 100 else 1.0)
    w = torch.from_numpy(w).to(cuda_device)
    x = torch.from_numpy(_np(24, *lead, M, K)).to(cuda_device, dtype)
    qt = ref.blockwise_quant(w, bits=bits, block=64, mode=mode)
    fn = qmm_kernel.quant_matmul
    before = (fn.launches, fn.gemv_launches, fn.tc_launches,
              fn.tf32_launches)
    got = fn(x, qt)
    again = fn(x, qt)
    gemv = M <= qmm_kernel.MAX_ROWS and N % 4 == 0
    tc = not gemv and dtype == BF16
    tf32 = not gemv and dtype == F32
    assert (fn.launches - before[0], fn.gemv_launches - before[1],
            fn.tc_launches - before[2], fn.tf32_launches - before[3]) == \
        (2, 2 * int(gemv), 2 * int(tc), 2 * int(tf32))
    assert torch.equal(got, again)
    _close(got, ref.quant_matmul(x, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("M,K,N", [(37, 200, 96), (256, 512, 384)])
def test_cuda_quant_matmul_grad_matches_plain(cuda_device, M, K, N, dtype):
    """``ops.quant_matmul`` with a gradient wanted for x (a frozen NF4
    projection without LoRA): the ``quant_matmul`` kernel forward and the
    ``quant_matmul_t`` kernel's dx (tensor cores for a bf16 g), against
    autograd of the plain version; odd K = 200 takes the padded payload."""
    w = torch.from_numpy(_np(33, K, N) / np.sqrt(K)).to(cuda_device)
    qt = ref.blockwise_quant(w.to(BF16), bits=4, block=64, mode="nf4")
    x = torch.from_numpy(_np(34, M, K)).to(cuda_device, dtype)
    g = torch.from_numpy(_np(35, M, N)).to(cuda_device, dtype)
    ops.reset_kernel_traces()
    out = {}
    for side, fn in (("kernel", ops.quant_matmul), ("plain", ref.quant_matmul)):
        xr = x.detach().requires_grad_(True)
        y = fn(xr, qt)
        out[side] = (y.detach(), *torch.autograd.grad(y, xr, g))
    route = "quant_matmul_t_cuda_tc" if dtype == BF16 else \
        "quant_matmul_t_cuda_tf32x3"
    traces = dict(ops.KERNEL_TRACES)
    assert traces.get(route) == 1 and traces.get("quant_matmul_cuda") == 1, \
        traces
    for got, want in zip(out["kernel"], out["plain"]):
        assert got.dtype == dtype and got.shape == want.shape
        _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("T,M,K,N", QMM_TC_CASES)
def test_cuda_quant_matmul_tc_route_matches_plain(cuda_device, T, M, K, N,
                                                  bits, mode):
    """The tc route (bf16 x past 4 rows: ``qmm_tc_kernel``, the row tile
    and split that ``plan_tc`` picks) at reduced trainer shapes, a
    stacked T = 2, odd K and ragged N, against the plain version; counted
    as a tc launch, two calls bitwise equal, and the same within the
    bound under every row tile and split count."""
    lead = (T,) if T else ()
    w = torch.from_numpy(_np(35, *lead, K, N) / np.sqrt(K)).to(cuda_device)
    qt = ref.blockwise_quant(w, bits=bits, block=64, mode=mode)
    x = torch.from_numpy(_np(36, *lead, M, K)).to(cuda_device, BF16)
    fn = qmm_kernel.quant_matmul
    before = (fn.launches, fn.tc_launches, fn.gemv_launches)
    got = fn(x, qt)
    again = fn(x, qt)
    assert (fn.launches - before[0], fn.tc_launches - before[1],
            fn.gemv_launches - before[2]) == (2, 2, 0)
    assert got.dtype == BF16 and torch.equal(got, again)
    want = ref.quant_matmul(x, qt)
    _close(got, want)
    Kq = qt.q.shape[-3] * qt.block
    for pl in qmm_kernel.tc_plans(max(T, 1), M, Kq, N, 64):
        if pl.splits <= 3:
            _close(qmm_kernel._quant_matmul(x, qt, None, tc_plan=pl), want)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [64, 128, 256])
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 6, 12])
def test_cuda_quant_matmul_gemv_every_plan(cuda_device, cols, cluster):
    """The GEMV at the serve replay's shape (4 users, one row, 768 x
    768, 12 quant groups) with each column tile and cluster size forced,
    against the plain version."""
    w = torch.from_numpy(_np(31, 4, 768, 768) / np.sqrt(768)).to(cuda_device)
    x = torch.from_numpy(_np(32, 4, 1, 768)).to(cuda_device)
    qt = ref.blockwise_quant(w, bits=8, block=64)
    pl = qmm_kernel.GemvPlan(users=4, cols=cols, tiles=-(-768 // cols),
                             cluster=cluster,
                             groups=qmm_kernel.group_ranges(12, cluster))
    _close(qmm_kernel._quant_matmul(x, qt, pl), ref.quant_matmul(x, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [48, 80, 96])
def test_cuda_quant_matmul_gemv_refuses_uneven_tiles(cuda_device, cols):
    """A column tile whose 16-column threads do not divide the CTA's 128
    threads evenly is refused at launch, not run."""
    w = torch.from_numpy(_np(31, 4, 768, 768) / np.sqrt(768)).to(cuda_device)
    x = torch.from_numpy(_np(32, 4, 1, 768)).to(cuda_device)
    qt = ref.blockwise_quant(w, bits=8, block=64)
    pl = qmm_kernel.GemvPlan(users=4, cols=cols, tiles=-(-768 // cols),
                             cluster=1, groups=qmm_kernel.group_ranges(12, 1))
    with pytest.raises(RuntimeError, match="launch failed"):
        qmm_kernel._quant_matmul(x, qt, pl)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block", BQ_BLOCKS)
@pytest.mark.parametrize("K,N", [(768, 768), (100, 70), (768, 770)])
def test_cuda_blockwise_quant_bitwise(cuda_device, K, N, bits, block):
    x = torch.from_numpy(_np(25, K, N)).to(cuda_device)
    got = bq_kernel.blockwise_quant(x, bits=bits, block=block)
    want = ref.blockwise_quant(x, bits=bits, block=block)
    assert torch.equal(got.q, want.q) and torch.equal(got.scales, want.scales)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,dtype", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, B, S, H, Hkv, D,
                                            causal, window, dtype):
    q, k, v = (torch.from_numpy(_np(s, B, S, h, D)).to(cuda_device, dtype)
               for s, h in ((26, H), (27, Hkv), (28, Hkv)))
    before = fa_kernel.flash_attention.tc_launches
    counts = fa_kernel.route_counts()
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_kernel.flash_attention.tc_launches - before == \
        int(dtype == BF16)
    _took_route(counts, fa_kernel.route(S, D, dtype))
    _close(got, ref.flash_attention(q, k, v, causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Skv,H,Hkv,D,causal,window,dtype",
                         FLASH_KV_CASES)
def test_cuda_flash_attention_zoo_shapes_match_plain(
        cuda_device, B, S, Skv, H, Hkv, D, causal, window, dtype):
    q = torch.from_numpy(_np(26, B, S, H, D)).to(cuda_device, dtype)
    k, v = (torch.from_numpy(_np(s, B, Skv, Hkv, D)).to(cuda_device, dtype)
            for s in (27, 28))
    before = fa_kernel.flash_attention.tc_launches
    counts = fa_kernel.route_counts()
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_kernel.flash_attention.tc_launches - before == \
        int(dtype == BF16)
    _took_route(counts, fa_kernel.route(S, D, dtype))
    _close(got, ref.flash_attention(q, k, v, causal=causal, window=window))


def _took_route(before: dict, route: str):
    """The one launch since ``before`` was counted on ``route`` alone."""
    after = fa_kernel.route_counts()
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}


# the fp32 routes' cases at full size: (B, S, Skv, H, Hkv, D, causal,
# window): the round's cohort at both CLIP widths, the serve oracle,
# the adapter's causal S = 5, the fp32 step check's backbone and
# adapter, the LLaVA adapter, the cluster route's other widths (GQA, a
# window, not causal, a ragged S, D % 8 != 0 against a longer Skv), D %
# 4 != 0, Whisper's cross-attention
FLASH_F32_CASES = [
    (160, 1, 1, 4, 4, 192, False, None), (160, 1, 1, 4, 4, 16, False, None),
    (1, 1, 1, 4, 4, 192, False, None), (1, 5, 5, 4, 4, 16, True, None),
    (4, 64, 64, 32, 4, 128, True, None), (4, 64, 64, 8, 8, 512, True, None),
    (4, 640, 640, 8, 8, 896, True, None),
    (4, 640, 640, 8, 8, 1024, True, None),
    (2, 256, 256, 8, 2, 896, True, None), (2, 300, 300, 4, 4, 896, True, 64),
    (2, 77, 77, 4, 4, 600, True, None), (1, 50, 70, 2, 1, 530, False, None),
    (1, 33, 33, 2, 2, 777, False, None), (4, 64, 1500, 16, 16, 64, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["cuda_rows", "cuda_tf32x3"])
@pytest.mark.parametrize("B,S,Skv,H,Hkv,D,causal,window", FLASH_F32_CASES)
def test_cuda_flash_attention_fp32_routes_match_plain(
        cuda_device, how, B, S, Skv, H, Hkv, D, causal, window):
    """Either fp32 route, forced at any S, within 1e-5 of the plain
    version's largest magnitude (TF32 off), two calls bitwise equal, the
    launch counted on its route; the first design (``"cuda_v1"``) on the
    same inputs within the same bound."""
    q = torch.from_numpy(_np(26, B, S, H, D)).to(cuda_device)
    k, v = (torch.from_numpy(_np(s, B, Skv, Hkv, D)).to(cuda_device)
            for s in (27, 28))
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    tol = 1e-5 * want.abs().max().item()
    counts = fa_kernel.route_counts()
    got = fa_kernel._flash_attention(q, k, v, causal=causal, window=window,
                                     force=how)
    _took_route(counts, how)
    again = fa_kernel._flash_attention(q, k, v, causal=causal,
                                       window=window, force=how)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert (got - want).abs().max().item() <= tol
    if how == fa_kernel.route(S, D, F32):
        assert torch.equal(got, fa_kernel.flash_attention(
            q, k, v, causal=causal, window=window))
    if how == "cuda_rows":
        v1 = fa_kernel._flash_attention(q, k, v, causal=causal,
                                        window=window, force="cuda_v1")
        assert (v1 - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_flash_attention_fp32_refuses_other_routes(cuda_device):
    q = torch.from_numpy(_np(26, 1, 4, 2, 64)).to(cuda_device)
    for how in ("tc", "tc_single", "tc_cluster", "gemv"):
        with pytest.raises(ValueError, match="cannot be forced"):
            fa_kernel._flash_attention(q, q, q, force=how)
    with pytest.raises(ValueError, match="cannot be forced"):
        fa_kernel._flash_attention(q.to(BF16), q.to(BF16), q.to(BF16),
                                   force="cuda_tf32x3")
    assert fa_kernel.f32_occupancy("cuda_tf32x3") >= 1
    assert fa_kernel.f32_occupancy("cuda_rows") >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("M,K,N", [(37, 200, 33), (256, 2560, 768)])
def test_cuda_quant_matmul_gradient_matches_autograd_of_plain(
        cuda_device, M, K, N, dtype):
    """``ops.quant_matmul`` with a gradient wanted for x (a frozen NF4
    projection without LoRA in a trained model): the ``quant_matmul``
    kernel forward, ``quant_matmul_t`` backward, against autograd
    through the plain version."""
    qt, x, _, _ = _lora_inputs(cuda_device, M, K, N, 4, "nf4", dtype, 4)
    ct = torch.from_numpy(_np(34, M, N)).to(cuda_device, dtype)
    got, want = [], []
    for fn, out in ((ops.quant_matmul, got), (ref.quant_matmul, want)):
        xs = x.clone().requires_grad_(True)
        y = fn(xs, qt)
        (y.float() * ct.float()).sum().backward()
        out.extend([y.detach(), xs.grad])
    for g, w in zip(got, want):
        _close(g, w)


def _close(got, want):
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2e-2 * max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol


def _lora_inputs(dev, M, K, N, bits, mode, dtype, r):
    w = torch.from_numpy(_np(29, K, N) / np.sqrt(K)).to(dev)
    qt = ref.blockwise_quant(w, bits=bits, block=64, mode=mode)
    x = torch.from_numpy(_np(30, M, K)).to(dev).to(dtype)
    a = torch.from_numpy(_np(31, K, r) / np.sqrt(K)).to(dev)
    b = torch.from_numpy(_np(32, r, N)).to(dev)
    return qt, x, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bits,mode,dtype,r", LORA_CASES)
def test_cuda_lora_matmul_matches_plain(cuda_device, M, K, N, bits, mode,
                                        dtype, r):
    qt, x, a, b = _lora_inputs(cuda_device, M, K, N, bits, mode, dtype, r)
    route = lm_kernel.route(M, N, qt, dtype)
    assert route == ("gemv" if M <= lm_kernel.MAX_ROWS else
                     "tc" if dtype == BF16 else "tf32x3")
    before = lm_kernel.route_counts()
    got = lm_kernel.lora_matmul(x, qt, a, b, scale=2.0)
    after = lm_kernel.route_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    _close(got, ref.lora_matmul(x, qt, a, b, scale=2.0))


# fp32 lora_matmul's tf32x3 route: (M, K, N, bits, mode, rank): the paths'
# shapes (phase 13's Qwen3-MoE wq and wo, phase 4's Yi-9B linears) and
# the edges (int8, int4, odd K with ragged N, rank 20 padded to 32)
LORA_TF32_CASES = [
    (256, 4096, 8192, 4, "nf4", 16), (256, 8192, 4096, 4, "nf4", 16),
    (256, 4096, 512, 4, "nf4", 16), (256, 11008, 4096, 4, "nf4", 16),
    (64, 512, 256, 8, "linear", 16), (64, 512, 256, 4, "linear", 16),
    (37, 200, 33, 8, "linear", 4), (130, 256, 136, 4, "nf4", 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bits,mode,r", LORA_TF32_CASES)
def test_cuda_lora_matmul_tf32x3_route_matches_plain(cuda_device, M, K, N,
                                                     bits, mode, r):
    """``lora_tf32_kernel`` within 1e-5 of the plain version's largest
    magnitude, two calls bitwise equal, at the plan's split count and at
    1 and 3 splits; the first design (``force="tiled"``) beside it."""
    qt, x, a, b = _lora_inputs(cuda_device, M, K, N, bits, mode, F32, r)
    want = ref.lora_matmul(x, qt, a, b, scale=2.0)
    w = lm_kernel.lora_matmul
    before = w.tf32_launches
    got = lm_kernel.lora_matmul(x, qt, a, b, scale=2.0)
    again = lm_kernel.lora_matmul(x, qt, a, b, scale=2.0)
    assert w.tf32_launches - before == 2
    _close_rel(got, want)
    assert torch.equal(got, again)
    for splits in (1, 3):
        _close_rel(lm_kernel._lora_matmul(x, qt, a, b, 2.0, splits), want)
    _close_rel(lm_kernel._lora_matmul(x, qt, a, b, 2.0, None,
                                      force="tiled"), want)
    with pytest.raises(ValueError, match="can be forced"):
        lm_kernel._lora_matmul(x, qt, a, b, 2.0, None, force="tc")


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 32, 128])
@pytest.mark.parametrize("bits,mode", FORMATS)
def test_cuda_lora_matmul_bf16_other_blocks(cuda_device, block, bits, mode):
    """The tensor-core kernel at quant blocks other than the trainer's 64:
    two groups per 32-row tile (16), one (32), a group over four tiles
    (128); K = 200 leaves a partial last tile."""
    w = torch.from_numpy(_np(29, 200, 40) / np.sqrt(200)).to(cuda_device)
    qt = ref.blockwise_quant(w, bits=bits, block=block, mode=mode)
    x = torch.from_numpy(_np(30, 37, 200)).to(cuda_device, BF16)
    a = torch.from_numpy(_np(31, 200, 16) / np.sqrt(200)).to(cuda_device)
    b = torch.from_numpy(_np(32, 16, 40)).to(cuda_device)
    got = lm_kernel.lora_matmul(x, qt, a, b, scale=2.0)
    _close(got, ref.lora_matmul(x, qt, a, b, scale=2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", lm_kernel.SPLITS)
def test_cuda_lora_matmul_every_split_count(cuda_device, splits):
    """The tensor-core kernel with each split count forced at wk/wv's
    shape, against the plain version and against the unsplit kernel."""
    qt, x, a, b = _lora_inputs(cuda_device, 256, 4096, 512, 4, "nf4", BF16,
                               16)
    got = lm_kernel._lora_matmul(x, qt, a, b, 2.0, splits)
    _close(got, ref.lora_matmul(x, qt, a, b, scale=2.0))
    one = lm_kernel._lora_matmul(x, qt, a, b, 2.0, 1)
    _close(got, one)


@pytest.mark.cuda
def test_cuda_bf16_routes_are_traced_and_refusals_raise(cuda_device):
    """bf16 takes the tensor-core kernels under their own trace keys; an
    input the tensor-core kernel does not take raises and launches
    nothing else (no fallback to the CUDA-core kernel or the plain
    version)."""
    qt, x, a, b = _lora_inputs(cuda_device, 37, 200, 33, 4, "nf4", BF16, 4)
    q = torch.from_numpy(_np(26, 2, 40, 4, 64)).to(cuda_device, BF16)
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    ops.lora_matmul(x, qt, a, b, scale=2.0)
    ops.flash_attention(q, q, q, causal=True)
    assert ops.KERNEL_TRACES == {"lora_matmul_cuda_tc": 1,
                                 "flash_attention_cuda_tc": 1}
    assert ops.tc_launch_counts() == {"flash_attention": 1, "lora_matmul": 1,
                                      "quant_matmul_t": 0}
    w8 = ref.blockwise_quant(torch.from_numpy(_np(29, 64, 32)).to(
        cuda_device), bits=4, block=8, mode="nf4")
    with pytest.raises(NotImplementedError, match="block 8"):
        lm_kernel.lora_matmul(x[:, :64].contiguous(), w8, a[:64], b[:, :32],
                              scale=2.0)
    qd = torch.from_numpy(_np(26, 1, 4, 2, 1032)).to(cuda_device, BF16)
    with pytest.raises(NotImplementedError, match="D=1032"):
        fa_kernel.flash_attention(qd, qd, qd)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lora_matmul"] == 1
    assert ops.launch_counts()["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bits,mode,dtype,r", LORA_CASES[:4])
def test_cuda_quant_matmul_t_matches_plain(cuda_device, M, K, N, bits, mode,
                                           dtype, r):
    qt, _, _, _ = _lora_inputs(cuda_device, M, K, N, bits, mode, dtype, r)
    g = torch.from_numpy(_np(33, M, N)).to(cuda_device)
    got = lm_kernel.quant_matmul_t(g, qt)
    assert got.shape == (M, qt.q.shape[0] * qt.block)
    _close(got, ref.quant_matmul_t(g, qt))


QMT_CASES = [  # (M, K, N, bits, mode): bf16 g, the tensor-core kernel
    (256, 4096, 4096, 4, "nf4"),    # Yi-9B wq/wo's backward
    (256, 4096, 512, 4, "nf4"),     # wk/wv
    (256, 4096, 11008, 4, "nf4"),   # wg/wu
    (256, 11008, 4096, 4, "nf4"),   # wd
    (37, 200, 33, 4, "nf4"),        # odd K (Kq = 256), ragged N
    (37, 200, 33, 8, "linear"),
    (64, 512, 256, 8, "linear"),    # int8
    (64, 512, 256, 4, "linear"),    # int4
    (9, 128, 96, 4, "nf4"),         # M below the tile
    (300, 384, 40, 4, "nf4"),       # two row tiles; N % 16 != 0
    (5, 192, 20, 8, "linear"),      # N below one k-tile
]


def _qmt_inputs(dev, M, K, N, bits, mode, block=64):
    """W (K, N) quantized (an odd K pads to Kq), a bf16 g (M, N)."""
    w = torch.from_numpy(_np(47, K, N) / np.sqrt(K)).to(dev)
    qt = ref.blockwise_quant(w, bits=bits, block=block, mode=mode)
    g = torch.from_numpy(_np(48, M, N)).to(dev).to(BF16)
    return qt, g


LORA_GEMV_CASES = [  # (M, K, N, bits, mode, dtype, rank): decode rows
    (1, 4096, 4096, 4, "nf4", BF16, 16),
    (8, 11008, 4096, 4, "nf4", BF16, 16),    # phase 16's 8 rows
    (3, 7168, 1024, 4, "nf4", BF16, 16),     # LLaVA wk/wv, 64-column tiles
    (5, 200, 36, 4, "nf4", F32, 4),          # odd K, N % 16 != 0
    (2, 512, 256, 8, "linear", F32, 20),     # int8, rank 20
    (7, 201, 48, 4, "linear", BF16, 4),      # int4, K % 8 != 0
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bits,mode,dtype,r", LORA_GEMV_CASES)
def test_cuda_lora_matmul_decode_route_matches_plain(cuda_device, M, K, N,
                                                     bits, mode, dtype, r):
    """The decode route against the plain version (fp32 at 1e-5, bf16 at
    its bound), two calls bitwise equal, counted in ``gemv_launches``;
    the tc route forced on the same bf16 rows (the card's A/B) within
    the bound too."""
    qt, x, a, b = _lora_inputs(cuda_device, M, K, N, bits, mode, dtype, r)
    assert lm_kernel.route(M, N, qt, dtype) == "gemv"
    before = lm_kernel.lora_matmul.gemv_launches
    got = lm_kernel.lora_matmul(x, qt, a, b, scale=2.0)
    again = lm_kernel.lora_matmul(x, qt, a, b, scale=2.0)
    assert lm_kernel.lora_matmul.gemv_launches - before == 2
    assert torch.equal(got, again)
    want = ref.lora_matmul(x, qt, a, b, scale=2.0)
    _close(got, want)
    if dtype == BF16:
        _close(lm_kernel._lora_matmul(x, qt, a, b, 2.0, None, force="tc"),
               want)


FLASH_CLUSTER_CASES = [  # (B, S, Skv, H, Hkv, D, causal, window)
    (2, 200, 200, 4, 4, 896, True, None),    # the LLaVA adapter's D
    (1, 130, 130, 2, 1, 1024, False, None),  # eight slices, MQA
    (2, 77, 77, 4, 2, 600, True, 20),        # GQA, window, D % 16 != 0
    (1, 50, 70, 2, 2, 530, False, None),     # Skv > S, D % 8 != 0
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Skv,H,Hkv,D,causal,window",
                         FLASH_CLUSTER_CASES)
def test_cuda_flash_attention_cluster_route_matches_plain(
        cuda_device, B, S, Skv, H, Hkv, D, causal, window):
    """bf16 above D = 512: the cluster route (``cluster_launches``)
    within 1.6e-2 of the plain version's largest magnitude, two calls
    bitwise equal; the single-stage instantiation only when forced."""
    q = torch.from_numpy(_np(26, B, S, H, D)).to(cuda_device, BF16)
    k, v = (torch.from_numpy(_np(s, B, Skv, Hkv, D)).to(cuda_device, BF16)
            for s in (27, 28))
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    before = fa_kernel.flash_attention.cluster_launches
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    again = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_kernel.flash_attention.cluster_launches - before == 2
    assert torch.equal(got, again)
    tol = 1.6e-2 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    single = fa_kernel._flash_attention(q, k, v, causal=causal,
                                        window=window, force="tc_single")
    assert fa_kernel.flash_attention.cluster_launches - before == 2
    assert (single.float() - want.float()).abs().max().item() <= tol
    with pytest.raises(ValueError, match="forced"):
        fa_kernel._flash_attention(q.float(), k.float(), v.float(),
                                   force="tc_single")


def _close_qmt(got, want):
    """1e-4 of the largest magnitude: the bf16-g route's bound."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-4 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bits,mode", QMT_CASES)
def test_cuda_quant_matmul_t_bf16_matches_plain(cuda_device, M, K, N, bits,
                                                mode):
    qt, g = _qmt_inputs(cuda_device, M, K, N, bits, mode)
    before = lm_kernel.quant_matmul_t.tc_launches
    got = lm_kernel.quant_matmul_t(g, qt, out_dtype=F32)
    assert lm_kernel.quant_matmul_t.tc_launches - before == 1
    assert got.dtype == F32
    _close_qmt(got, ref.quant_matmul_t(g, qt, out_dtype=F32))
    # bf16 out: the same sums, rounded once
    got16 = lm_kernel.quant_matmul_t(g, qt)
    assert got16.dtype == BF16
    _close(got16, ref.quant_matmul_t(g, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", lm_kernel.SPLITS)
@pytest.mark.parametrize("M,K,N", [(256, 4096, 1024), (37, 200, 130)])
def test_cuda_quant_matmul_t_every_split_count(cuda_device, M, K, N,
                                               splits):
    """The tensor-core kernel with each split count forced (more splits
    than 32-column units leave some empty), against the plain version
    and the unsplit kernel, in fp32 and bf16 output."""
    qt, g = _qmt_inputs(cuda_device, M, K, N, 4, "nf4")
    got = lm_kernel._quant_matmul_t(g, qt, F32, splits)
    _close_qmt(got, ref.quant_matmul_t(g, qt, out_dtype=F32))
    _close_qmt(got, lm_kernel._quant_matmul_t(g, qt, F32, 1))
    _close(lm_kernel._quant_matmul_t(g, qt, BF16, splits),
           ref.quant_matmul_t(g, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 32, 128, 256])
@pytest.mark.parametrize("bits,mode", FORMATS)
def test_cuda_quant_matmul_t_bf16_other_blocks(cuda_device, block, bits,
                                               mode):
    """Quant blocks other than the trainer's 64: eight scale rows per
    128-row tile (16), four (32), one (128) and a group over two tiles
    (256); K = 700 pads to Kq = 704 (16, 32: a partial last column
    tile) or 768."""
    qt, g = _qmt_inputs(cuda_device, 37, 700, 72, bits, mode, block=block)
    _close_qmt(lm_kernel.quant_matmul_t(g, qt, out_dtype=F32),
               ref.quant_matmul_t(g, qt, out_dtype=F32))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bits,mode", QMT_CASES[4:6])
def test_cuda_quant_matmul_t_fp32_route_unchanged(cuda_device, M, K, N,
                                                  bits, mode):
    """An fp32 g takes the 3xTF32 route at 1e-5 and counts no bf16
    tensor-core launch; the first design, forced, still matches."""
    qt, g = _qmt_inputs(cuda_device, M, K, N, bits, mode)
    fn = lm_kernel.quant_matmul_t
    before = (fn.tc_launches, fn.tf32_launches)
    got = lm_kernel.quant_matmul_t(g.float(), qt)
    assert (fn.tc_launches, fn.tf32_launches) == (before[0], before[1] + 1)
    assert got.dtype == F32
    want = ref.quant_matmul_t(g.float(), qt)
    _close(got, want)
    _close(lm_kernel._quant_matmul_t(g.float(), qt, None, None,
                                     force="tiled"), want)


TF32_QMM_CASES = [  # (T, M, K, N): fp32 x past the GEMV's rows
    (0, 20, 1024, 384),    # the MoE experts' 20 rows at reduced width
    (0, 37, 200, 70),      # odd K (padded to 256), ragged N
    (2, 20, 300, 70),      # a stacked QTensor, odd K, ragged N
    (0, 300, 512, 136),    # three 128-row tiles, a partial column tile
    (4, 3, 100, 70),       # 3 rows off the GEMV's layout (N % 4 != 0)
]
TF32_QMT_CASES = [  # (M, K, N): fp32 g
    (20, 1024, 384),       # the experts' dx at reduced width
    (20, 384, 1024),
    (37, 200, 33),         # odd K (Kq 256), ragged N, N % 4 != 0
    (300, 384, 40),        # three row tiles, N % 16 != 0
]


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("T,M,K,N", TF32_QMM_CASES)
def test_cuda_quant_matmul_tf32x3_route_matches_plain(cuda_device, T, M, K,
                                                      N, bits, mode):
    """fp32 x past the GEMV's rows: ``qmm_tf32_kernel`` (route
    ``"tf32x3"``) within 1e-5 of the plain version's largest magnitude,
    counted in ``tf32_launches``, two calls bitwise equal, and within the
    bound under 1, 2 and 5 splits; the first design, forced, too."""
    lead = (T,) if T else ()
    w = torch.from_numpy(_np(51, *lead, K, N) / np.sqrt(K)).to(cuda_device)
    qt = ref.blockwise_quant(w, bits=bits, block=64, mode=mode)
    x = torch.from_numpy(_np(52, *lead, M, K)).to(cuda_device)
    before = qmm_kernel.route_counts()
    got = qmm_kernel.quant_matmul(x, qt)
    again = qmm_kernel.quant_matmul(x, qt)
    after = qmm_kernel.route_counts()
    assert {r: after[r] - before[r] for r in after} == {
        "gemv": 0, "tc": 0, "tf32x3": 2, "tiled": 0}
    assert got.dtype == F32 and torch.equal(got, again)
    want = ref.quant_matmul(x, qt)
    assert _rel(got, want) <= 1e-5
    Kq, unit = qt.q.shape[-3] * qt.block, 64
    for splits in (1, 2, 5):
        pl = qmm_kernel.TcPlan(
            users=max(T, 1), bm=32, tiles=0, splits=splits, unit=unit,
            ranges=qmm_kernel.split_ranges(Kq, unit, splits))
        for bm in (32, 128):
            pl = dataclasses.replace(pl, bm=bm)
            assert _rel(qmm_kernel._quant_matmul(x, qt, None, tf32_plan=pl),
                        want) <= 1e-5
    assert _rel(qmm_kernel._quant_matmul(x, qt, None, force="tiled"),
                want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("M,K,N", TF32_QMT_CASES)
def test_cuda_quant_matmul_t_tf32x3_route_matches_plain(cuda_device, M, K,
                                                        N, bits, mode):
    """fp32 g: ``qmt_tf32_kernel`` within 1e-5, counted in
    ``tf32_launches``, two calls bitwise equal, the same within the bound
    under 1, 2 and 7 splits over N; the first design, forced, too."""
    qt, g = _qmt_inputs(cuda_device, M, K, N, bits, mode)
    g = g.float()
    before = lm_kernel.qmt_route_counts()
    got = lm_kernel.quant_matmul_t(g, qt)
    again = lm_kernel.quant_matmul_t(g, qt)
    after = lm_kernel.qmt_route_counts()
    assert {r: after[r] - before[r] for r in after} == {
        "tc": 0, "tf32x3": 2, "tiled": 0}
    assert got.dtype == F32 and torch.equal(got, again)
    want = ref.quant_matmul_t(g, qt)
    assert _rel(got, want) <= 1e-5
    for splits in (1, 2, 7):
        assert _rel(lm_kernel._quant_matmul_t(g, qt, None, splits),
                    want) <= 1e-5
    assert _rel(lm_kernel._quant_matmul_t(g, qt, None, None, force="tiled"),
                want) <= 1e-5


@pytest.mark.cuda
def test_cuda_tf32x3_routes_refuse_a_block_they_do_not_take(cuda_device):
    """An fp32 call at a quant block the 3xTF32 kernels do not take (not
    a power of two >= 16) raises and launches nothing: no fallback to the
    first design or the plain version."""
    w = torch.from_numpy(_np(53, 96, 64)).to(cuda_device)
    x = torch.from_numpy(_np(54, 20, 96)).to(cuda_device)
    a = torch.from_numpy(_np(55, 96, 4)).to(cuda_device)
    b = torch.from_numpy(_np(56, 4, 64)).to(cuda_device)
    for block, bits in ((8, 4), (48, 8)):
        qt = ref.blockwise_quant(w, bits=bits, block=block)
        before = (qmm_kernel.quant_matmul.launches,
                  lm_kernel.quant_matmul_t.launches,
                  lm_kernel.lora_matmul.launches)
        with pytest.raises(NotImplementedError, match=f"block {block}"):
            qmm_kernel.quant_matmul(x, qt)
        with pytest.raises(NotImplementedError, match=f"block {block}"):
            lm_kernel.quant_matmul_t(x[:, :64].contiguous(), qt)
        with pytest.raises(NotImplementedError, match=f"block {block}"):
            lm_kernel.lora_matmul(x, qt, a, b, scale=2.0)
        assert (qmm_kernel.quant_matmul.launches,
                lm_kernel.quant_matmul_t.launches,
                lm_kernel.lora_matmul.launches) == before


@pytest.mark.cuda
def test_cuda_quant_matmul_t_bf16_refuses_a_block_it_does_not_take(
        cuda_device):
    """A bf16 g at a block the tensor-core kernel does not take raises
    and launches nothing: no fallback to the CUDA-core kernel."""
    qt, g = _qmt_inputs(cuda_device, 5, 64, 32, 4, "nf4", block=8)
    before = lm_kernel.quant_matmul_t.launches
    with pytest.raises(NotImplementedError, match="block 8"):
        lm_kernel.quant_matmul_t(g, qt, out_dtype=F32)
    assert lm_kernel.quant_matmul_t.launches == before


@pytest.mark.cuda
def test_cuda_lora_op_bf16_grads_match_the_cpu_route(cuda_device):
    """The bf16 autograd.Function on the card (tensor-core forward, the
    bf16 cotangent into quant_matmul_t's tensor-core kernel) against its
    CPU route (plain forward, the dequantized-W residual) on the same
    inputs, at the bf16 bound."""
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        qt, x, a, b = _lora_inputs(dev, 37, 200, 33, 4, "nf4", BF16, 4)
        ct = torch.from_numpy(_np(34, 37, 33)).to(dev)
        ts = [t.clone().requires_grad_(True) for t in (x, a, b)]
        ops.reset_kernel_traces()
        (ops.lora_matmul(ts[0], qt, ts[1], ts[2], scale=2.0) * ct).sum() \
            .backward()
        grads[dev.type] = [t.grad.cpu() for t in ts]
        if dev.type == "cuda":
            assert ops.KERNEL_TRACES == {"lora_matmul_cuda_tc": 1,
                                         "quant_matmul_t_cuda_tc": 1}
    assert grads["cuda"][0].dtype == BF16
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _close(got, want)


@pytest.mark.cuda
def test_cuda_lora_op_grads_match_the_cpu_route(cuda_device):
    """The autograd.Function on the card (fused kernel forward,
    quant_matmul_t backward) against its CPU route (plain forward with
    the dequantized-W residual) on the same inputs."""
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        qt, x, a, b = _lora_inputs(dev, 37, 200, 33, 4, "nf4",
                                   torch.float32, 4)
        ct = torch.from_numpy(_np(34, 37, 33)).to(dev)
        ts = [t.clone().requires_grad_(True) for t in (x, a, b)]
        ops.reset_kernel_traces()
        (ops.lora_matmul(ts[0], qt, ts[1], ts[2], scale=2.0) * ct).sum() \
            .backward()
        grads[dev.type] = [t.grad.cpu() for t in ts]
        if dev.type == "cuda":
            assert ops.KERNEL_TRACES == {"lora_matmul_cuda_tf32x3": 1,
                                         "quant_matmul_t_cuda_tf32x3": 1}
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,dtype", FLASH_CASES[1:])
def test_cuda_flash_attention_backward_matches_autograd_of_plain(
        cuda_device, B, S, H, Hkv, D, causal, window, dtype):
    q, k, v = (torch.from_numpy(_np(s, B, S, h, D)).to(cuda_device, dtype)
               for s, h in ((35, H), (36, Hkv), (37, Hkv)))
    ct = torch.from_numpy(_np(38, B, S, H, D)).to(cuda_device)
    got, want = [], []
    for fn, out in ((ops.flash_attention, got), (ref.flash_attention, want)):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*ts, causal=causal, window=window) * ct).sum().backward()
        out.extend(t.grad for t in ts)
    for g, w in zip(got, want):
        _close(g, w)


def _scan_inputs(dev, B, S, di, N):
    return (torch.from_numpy(np.abs(_np(39, B, S, di)) * 0.1).to(dev),
            torch.from_numpy(_np(40, B, S, di)).to(dev),
            torch.from_numpy(_np(41, B, S, N)).to(dev),
            torch.from_numpy(_np(42, B, S, N)).to(dev),
            -torch.from_numpy(np.abs(_np(43, di, N))).to(dev))


def _close_rel(got, want, rel=1e-5):
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N", SCAN_CASES)
def test_cuda_selective_scan_matches_plain(cuda_device, B, S, di, N):
    ins = _scan_inputs(cuda_device, B, S, di, N)
    y, h = ss_kernel.selective_scan(*ins)
    y0, h0 = ref.selective_scan(*ins)
    _close_rel(y, y0)
    _close_rel(h, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N", SCAN_CASES[1:])
def test_cuda_selective_scan_grads_match_autograd_of_plain(cuda_device, B, S,
                                                          di, N):
    """The op on the card (kernel forward, PyTorch-op backward) against
    autograd through the plain time loop, for both outputs' cotangents."""
    ins = _scan_inputs(cuda_device, B, S, di, N)
    gy = torch.from_numpy(_np(44, B, S, di)).to(cuda_device)
    gh = torch.from_numpy(_np(45, B, di, N)).to(cuda_device)
    grads = []
    for fn in (ops.selective_scan, ref.selective_scan):
        ts = [t.clone().requires_grad_(True) for t in ins]
        ops.reset_kernel_traces()
        grads.append(torch.autograd.grad(fn(*ts), ts, (gy, gh)))
        if fn is ops.selective_scan:
            assert ops.KERNEL_TRACES == {"selective_scan_cuda": 1,
                                         "selective_scan_bwd_cuda": 1}
    for got, want in zip(*grads):
        _close_rel(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("with_gh,need_a", [(False, False), (True, True),
                                            (True, False)])
@pytest.mark.parametrize("B,S,di,N", SCAN_CASES)
def test_cuda_selective_scan_bwd_matches_plain(cuda_device, B, S, di, N,
                                               with_gh, need_a):
    """The backward kernel against the plain reverse recurrence
    (``ops.selective_scan_bwd``) on the same inputs, as the trainer calls
    it (no h_last cotangent, A frozen) and with both; two calls give the
    same bits (fixed-order partial sums, no atomics)."""
    ins = _scan_inputs(cuda_device, B, S, di, N)
    gy = torch.from_numpy(_np(46, B, S, di)).to(cuda_device)
    gh = torch.from_numpy(_np(47, B, di, N)).to(cuda_device)
    ss_kernel.selective_scan_bwd.launches = 0
    got = ss_kernel.selective_scan_bwd(*ins, gy, gh if with_gh else None,
                                       need_a=need_a)
    again = ss_kernel.selective_scan_bwd(*ins, gy, gh if with_gh else None,
                                         need_a=need_a)
    want = ops.selective_scan_bwd(*ins, gy, gh if with_gh else
                                  torch.zeros_like(gh), need_a=need_a)
    assert ss_kernel.selective_scan_bwd.launches == 2
    assert (got[4] is None) == (not need_a)
    for g, g2, w in zip(got, again, want):
        if w is None:
            continue
        _close_rel(g, w)
        assert torch.equal(g, g2)


@pytest.mark.cuda
def test_cuda_selective_scan_bwd_refuses_what_it_does_not_take(cuda_device):
    ins = _scan_inputs(cuda_device, 1, 9, 40, 4)
    gy = torch.zeros((1, 9, 40), device=cuda_device)
    with pytest.raises(TypeError, match="fp32"):
        ss_kernel.selective_scan_bwd(*ins, gy.double())
    with pytest.raises(ValueError, match="cotangent"):
        ss_kernel.selective_scan_bwd(*ins, gy[:, :8])
    big = _scan_inputs(cuda_device, 1, 9, 40, 17)
    with pytest.raises(NotImplementedError, match="N=17"):
        ss_kernel.selective_scan_bwd(*big, gy)


# the federated round at a small size (tests/test_torch_simulator.py's)
FL_SMALL = dict(dataset="pacs", n_clients=3, rounds=2, local_steps=3,
                n_per_class=12, batch_size=8, lr=3e-3, gan_steps=4)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["fedclip", "qlora_nogan"])
def test_cuda_cohort_round_matches_sequential(cuda_device, arm):
    """One stacked round on the card against the sequential clients on
    the card, same weights and indices: tests/test_fl.py's oracle
    tolerances (leaves 5e-4, loss 1e-3 / 1e-4, accuracy 1e-5), bytes
    equal; the adapter's attention through the kernel only."""
    from repro_torch import convert
    from repro_torch import tree as tree_lib
    from repro_torch.core import clip as clip_lib
    from repro_torch.data.synthetic import class_tokens, make_dataset
    from repro_torch.fl import client as client_lib
    from repro_torch.fl import cohort as cohort_lib
    from repro_torch.fl import partition, server
    from repro_torch.fl import simulator as sim_lib
    from repro_torch.fl.strategies import STRATEGIES
    cfg = sim_lib.FLConfig(strategy=arm, **FL_SMALL)
    streams = sim_lib.seeded_streams(cfg)
    strat, ccfg = STRATEGIES[arm], clip_lib.CLIPConfig()
    frozen = sim_lib.pretrained_clip("pacs", ccfg, steps=20,
                                     init=streams.clip_init,
                                     device=cuda_device)
    data = make_dataset("pacs", n_per_class=12, seed=0)
    parts = partition.dirichlet_partition(data["labels"], 3, 0.5)
    clients = [client_lib.Client(cid=i, images=data["images"][p],
                                 labels=data["labels"][p], n_classes=7,
                                 strategy=strat) for i, p in enumerate(parts)]
    toks = torch.as_tensor(class_tokens(data["spec"], np.arange(7)),
                           dtype=torch.long, device=cuda_device)
    with torch.no_grad():
        class_emb = clip_lib.text_embedding(frozen, ccfg, toks)
    g0 = convert.tree_from_numpy(streams.trainable_init, cuda_device)
    engine = cohort_lib.CohortEngine(
        frozen=frozen, ccfg=ccfg, class_emb=class_emb, clients=clients,
        cfg=cohort_lib.CohortConfig(strategy=strat, local_steps=3,
                                    batch_size=8, lr=3e-3))
    key = cohort_lib.RoundKey(streams, (3, 0))
    ops.reset_kernel_traces()
    new, m = engine.run_round(g0, key)
    assert ops.KERNEL_TRACES.get("flash_attention_cuda_rows") == 3
    assert "flash_attention_ref" not in ops.KERNEL_TRACES
    idx = cohort_lib.round_indices(key, engine.lens, 3, 8)
    outs = [c.local_train(frozen, g0, class_emb, ccfg, steps=3, batch_size=8,
                          lr=3e-3, indices=idx[i])
            for i, c in enumerate(clients)]
    ups = [c.make_update(g0, tr) for c, (tr, _) in zip(clients, outs)]
    ref_tr = server.aggregate(g0, [(c.n, u) for c, (u, _) in
                                   zip(clients, ups)])
    want = dict(tree_lib.flatten_with_path(ref_tr))
    for path, leaf in tree_lib.flatten_with_path(new):
        torch.testing.assert_close(leaf, want[path], atol=5e-4, rtol=0)
    np.testing.assert_allclose(m["loss"].cpu().numpy(),
                               [o["loss"] for _, o in outs], atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(m["acc"].cpu().numpy(),
                               [o["acc"] for _, o in outs], atol=1e-5)
    assert m["uplink_bytes"] == sum(nb for _, nb in ups)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["fedclip", "qlora_nogan", "tripleplay"])
def test_cuda_run_federated_matches_cpu(cuda_device, arm):
    """``run_federated`` on the card against the CPU on the same streams.
    Each device pretrains its own CLIP (300 Adam steps), so the losses
    are held as tests/test_torch_simulator.py holds the port to the JAX
    package with its own pretraining (server loss 5e-3 and a client's
    last-step batch loss 1e-1 relative); accuracies within one sample,
    bytes equal; no plain attention on the card."""
    from repro_torch.fl import simulator as sim_lib
    cfg = sim_lib.FLConfig(strategy=arm, **FL_SMALL)
    streams = sim_lib.seeded_streams(cfg)
    ops.reset_kernel_traces()
    card = sim_lib.run_federated(cfg, device=cuda_device, streams=streams)
    assert "flash_attention_ref" not in ops.KERNEL_TRACES
    assert ops.KERNEL_TRACES.get("flash_attention_cuda_rows", 0) >= \
        cfg.rounds * cfg.local_steps
    cpu = sim_lib.run_federated(cfg, device="cpu", streams=streams)
    assert card.uplink_bytes == cpu.uplink_bytes
    for key in ("backbone_bytes", "footprint_bytes", "trainable_params"):
        assert card.meta[key] == cpu.meta[key]
    rel = lambda a, b: np.abs(np.subtract(a, b)) / np.abs(b)
    assert rel(card.server_loss, cpu.server_loss).max() <= 5e-3
    assert rel(card.client_loss, cpu.client_loss).max() <= 1e-1
    assert np.abs(np.subtract(card.server_acc, cpu.server_acc)).max() \
        <= 1 / 140 + 1e-12
    assert np.abs(np.subtract(card.client_acc, cpu.client_acc)).max() \
        <= 1 / 8 + 1e-12


@pytest.mark.cuda
def test_cuda_fleet_gan_matches_cpu(cuda_device):
    """The fleet GAN prep on the card against the CPU on the same
    streams (the GAN has no kernel of its own: cuBLAS gemm forms, TF32
    off): rebalancing labels bitwise, generator leaves within 2e-3 and
    images within 5e-3 (tests/test_fleetgan.py's bounds)."""
    from repro_torch.core import gan as gan_lib
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.fl import client as client_lib
    from repro_torch.fl import fleetgan
    from repro_torch.fl.strategies import STRATEGIES
    data = make_dataset("pacs", n_per_class=30, seed=0, longtail_gamma=4.0)
    streams = [gan_lib.SeededGANStream((0, 100 + i)) for i in range(3)]

    def clients():
        return [client_lib.Client(
            cid=i, images=data["images"][30 * i:30 * i + n],
            labels=data["labels"][30 * i:30 * i + n], n_classes=7,
            strategy=STRATEGIES["tripleplay"])
            for i, n in enumerate((24, 21, 5))]

    card, cpu = clients(), clients()
    fleetgan.prepare_gan_fleet(card, streams, steps=4, device=cuda_device)
    fleetgan.prepare_gan_fleet(cpu, streams, steps=4, device="cpu")
    for a, b in zip(card, cpu):
        if b.gan_params is None:
            assert a.gan_params is None
            continue
        np.testing.assert_array_equal(a.aug_labels, b.aug_labels)
        for k, v in b.gan_params["gen"].items():
            torch.testing.assert_close(a.gan_params["gen"][k].cpu(), v,
                                       atol=2e-3, rtol=0)
        np.testing.assert_allclose(a.aug_images, b.aug_images, atol=5e-3,
                                   rtol=0)


# the scheduler layer at tests/test_torch_sched_run.py's simulator size
SCHED_SMALL = dict(FL_SMALL, n_clients=4, rounds=3)


@pytest.mark.cuda
@pytest.mark.parametrize("arm,policy", [
    ("fedclip", dict(participation="sync-partial", clients_per_round=2,
                     trace="skewed")),
    ("fedclip", dict(participation="async", clients_per_round=1,
                     async_concurrency=2, trace="diurnal", chaos="heavy")),
    ("tripleplay", dict(participation="sync-partial", clients_per_round=3,
                        trace="diurnal", chaos="heavy"))])
def test_cuda_run_federated_sched_matches_cpu(cuda_device, arm, policy):
    """``run_federated`` under a partial or async policy, a trace and
    chaos, on the card against the CPU on the same streams: the draws'
    columns (participation, staleness, virtual time, class counts,
    bytes, fault ledger) equal, every commit's attention through the
    kernel; the card against its own sequential engine at the oracle
    tolerances (loss 1e-3 / 1e-4) on the first round."""
    from repro_torch.fl import simulator as sim_lib
    cfg = sim_lib.FLConfig(strategy=arm, **SCHED_SMALL, **policy)
    streams = sim_lib.seeded_streams(cfg)
    ops.reset_kernel_traces()
    card = sim_lib.run_federated(cfg, device=cuda_device, streams=streams)
    assert "flash_attention_ref" not in ops.KERNEL_TRACES
    assert ops.KERNEL_TRACES.get("flash_attention_cuda_rows", 0) >= \
        cfg.rounds * cfg.local_steps
    cpu = sim_lib.run_federated(cfg, device="cpu", streams=streams)
    seq = sim_lib.run_federated(
        sim_lib.FLConfig(strategy=arm, engine="sequential", **SCHED_SMALL,
                         **policy), device=cuda_device, streams=streams)
    for f in ("participation", "staleness", "vtime", "class_counts",
              "uplink_bytes"):
        assert getattr(card, f) == getattr(cpu, f) == getattr(seq, f), f
    assert card.meta.get("fault_ledger") == cpu.meta.get("fault_ledger") \
        == seq.meta.get("fault_ledger")
    assert all(np.isfinite(v).all() for v in card.client_loss)
    np.testing.assert_allclose(card.client_loss[0], seq.client_loss[0],
                               atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_subset_round_at_k_eq_n_is_the_full_round(cuda_device):
    """Sync-partial at K = N on a uniform trace is bitwise the full round
    on the card (the same batches, the identity gather, the same
    kernels); a bucketed K = 1 round's pad rows carry zero weight."""
    from repro_torch import convert
    from repro_torch import tree as tree_lib
    from repro_torch.core import clip as clip_lib
    from repro_torch.data.synthetic import class_tokens, make_dataset
    from repro_torch.fl import client as client_lib
    from repro_torch.fl import cohort as cohort_lib
    from repro_torch.fl import partition
    from repro_torch.fl import sched as sched_lib
    from repro_torch.fl import simulator as sim_lib
    from repro_torch.fl.strategies import STRATEGIES
    cfg = sim_lib.FLConfig(strategy="qlora_nogan", **FL_SMALL)
    streams = sim_lib.seeded_streams(cfg)
    strat, ccfg = STRATEGIES["qlora_nogan"], clip_lib.CLIPConfig()
    frozen = convert.tree_from_numpy(streams.clip_init, cuda_device)
    data = make_dataset("pacs", n_per_class=12, seed=0)
    parts = partition.dirichlet_partition(data["labels"], 3, 0.5)
    clients = [client_lib.Client(cid=i, images=data["images"][p],
                                 labels=data["labels"][p], n_classes=7,
                                 strategy=strat) for i, p in enumerate(parts)]
    toks = torch.as_tensor(class_tokens(data["spec"], np.arange(7)),
                           dtype=torch.long, device=cuda_device)
    with torch.no_grad():
        class_emb = clip_lib.text_embedding(frozen, ccfg, toks)
    g0 = convert.tree_from_numpy(streams.trainable_init, cuda_device)
    engine = cohort_lib.CohortEngine(
        frozen=frozen, ccfg=ccfg, class_emb=class_emb, clients=clients,
        cfg=cohort_lib.CohortConfig(strategy=strat, local_steps=3,
                                    batch_size=8, lr=3e-3))
    key = cohort_lib.RoundKey(streams, (3, 0))
    full, mf = engine.run_round(g0, key)
    part, mp = sched_lib.SyncPartialScheduler(
        executor=sched_lib.CohortExec(engine),
        trace=sched_lib.uniform_trace(3), local_steps=3,
        clients_per_round=3).step(g0, 0, key)
    for a, b in zip(tree_lib.leaves(full), tree_lib.leaves(part)):
        assert torch.equal(a, b)
    assert torch.equal(mf["loss"], mp["loss"])
    one, m1 = engine.run_subset_round(g0, [1], key)
    delta, _ = engine.run_wave(g0, [1], key)
    ref = sched_lib.CohortExec(engine).commit_buffer(
        g0, np.ones(1, np.float32), [cohort_lib.slice_client_delta(delta, 0)])
    for a, b in zip(tree_lib.leaves(one), tree_lib.leaves(ref)):
        assert torch.equal(a, b)
    assert m1["loss"].shape == (1,)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["pipelined", "barrier"])
def test_cuda_round_loop_waits_only_where_sync_traces_counts(cuda_device,
                                                             pipeline):
    """A fault-free sync-partial ``run_federated`` with a serve store
    refreshed every round, under ``set_sync_debug_mode("warn")``: every
    synchronizing call inside the round loop lies in a wait that
    ``SYNC_TRACES`` charges (``scripts/torch_loop_syncs.py`` classifies
    them); pipelined, the only charged wait is the one metric flush. The
    History is bitwise the run's without the store."""
    import dataclasses
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import torch_loop_syncs
    from repro_torch.fl import serve as serve_lib
    from repro_torch.fl import simulator as sim_lib
    cfg = sim_lib.FLConfig(strategy="fedclip", pipeline=pipeline,
                           participation="sync-partial", clients_per_round=2,
                           **SCHED_SMALL)
    plane = serve_lib.demo_plane(4, max_entries=3, device=cuda_device)
    store = serve_lib.AdapterStore(dict(plane["backing"]), max_entries=3,
                                   quant_bits=8, device=cuda_device)
    for uid in range(3):
        store.fetch(uid)
    bare = sim_lib.run_federated(cfg, device=cuda_device)
    torch.cuda.synchronize()
    with torch_loop_syncs.sync_warnings() as stacks:
        h = sim_lib.run_federated(cfg, device=cuda_device, serve_store=store)
    found = torch_loop_syncs.loop_sites(stacks, sim_lib)
    assert found["uncounted"] == 0, found["uncounted_sites"]
    assert h.meta["serve_refreshes"] == (cfg.rounds - 1) * 4
    if pipeline == "pipelined":
        assert h.meta["sync_counts"] == {"metrics_flush": 1}
    for f in dataclasses.fields(sim_lib.History):
        if f.name not in ("round_time_s", "meta"):
            assert getattr(h, f.name) == getattr(bare, f.name), f.name


@pytest.mark.cuda
def test_cuda_refresh_rows_are_an_evict_and_refetch(cuda_device):
    """On the card a refreshed resident's slab rows, re-quantized by the
    ``blockwise_quant`` kernel, are bitwise a cold store's fetch of the
    rebased tree; the rebase runs no plain quantizer."""
    from repro_torch import tree as tree_lib
    from repro_torch.core import quant as qlib
    from repro_torch.fl import serve as serve_lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    back = {u: {"adapter": {"wv": torch.randn(64, 64, generator=gen,
                                              device="cuda"),
                            "b2": torch.randn(64, generator=gen,
                                              device="cuda")}}
            for u in range(3)}
    store = serve_lib.AdapterStore(dict(back), max_entries=2, quant_bits=8,
                                   device=cuda_device)
    store.fetch(0)
    store.fetch(1)
    g = {"adapter": {"wv": torch.zeros(64, 64, device="cuda"),
                     "b2": torch.zeros(64, device="cuda")}}
    assert store.refresh_from_global(g) == 0
    ops.reset_kernel_traces()
    g2 = tree_lib.tree_map(lambda l: l + 0.5, g)
    assert store.refresh_from_global(g2) == 2
    assert ops.KERNEL_TRACES.get("blockwise_quant_cuda") == 2
    assert "blockwise_quant_ref" not in ops.KERNEL_TRACES

    def rows(s, uid):
        famk, slot = s.fetch(uid)
        out = []
        for l in tree_lib.leaves(serve_lib.take_rows(
                s.family(famk)["slabs"],
                torch.tensor([slot], device="cuda"))):
            out += [l.q, l.scales] if isinstance(l, qlib.QTensor) else [l]
        return out

    for uid in (0, 1):
        cold = serve_lib.AdapterStore({uid: store.backing[uid]},
                                      max_entries=1, quant_bits=8,
                                      device=cuda_device)
        for a, b in zip(rows(store, uid), rows(cold, uid)):
            assert torch.equal(a, b)
        torch.testing.assert_close(store.backing[uid]["adapter"]["wv"],
                                   back[uid]["adapter"]["wv"] + 0.5,
                                   atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_int8_gan_gemm_block_products_are_exact(cuda_device):
    """The int8 GAN gemm's block products on the card (fp32 products of
    int8 codes, TF32 off or on) are bitwise the int64 product on the
    CPU, and the gemm on the card equals the CPU's within 1e-6."""
    from repro_torch.kernels import gan_conv
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 300, 257, generator=gen)
    w = torch.randn(5, 257, 40, generator=gen)
    qx, _ = gan_conv._q8_rows(x, 64)
    qw, _ = gan_conv._q8_rows(w.transpose(-1, -2), 64)
    want = torch.matmul(qx.transpose(-3, -2).long(),
                        qw.transpose(-3, -2).transpose(-1, -2).long())
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        got = gan_conv.block_products(qx.cuda(), qw.cuda())
        assert torch.equal(got.cpu().long(), want)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = gan_conv.quant_gemm_int8(x.cuda(), w.cuda()).cpu()
    ref_out = gan_conv.quant_gemm_int8(x, w)
    assert (out - ref_out).abs().max() <= 1e-6 * ref_out.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("G,empty", [(1, 0), (4, 30), (8, 95)])
def test_cuda_decode_attention_matches_cpu(cuda_device, G, empty):
    """``ops.decode_attention`` (plain PyTorch on both devices, as the
    JAX package has it) on the card against the CPU at the Yi-9B decode
    shape (4 streams, 4 KV heads, a ring of 96 slots, some empty) in
    fp32 within 1e-5 and bf16 within the bf16 bound."""
    Hkv, M, D = 4, 96, 128
    q = torch.from_numpy(_np(40, 4, 1, G * Hkv, D))
    k = torch.from_numpy(_np(41, 4, M, Hkv, D))
    v = torch.from_numpy(_np(42, 4, M, Hkv, D))
    sp = torch.arange(M, dtype=torch.int32)
    sp[torch.randperm(M, generator=torch.Generator().manual_seed(0))[
        :empty]] = -1
    for dtype in (F32, BF16):
        ins = [t.to(dtype) for t in (q, k, v)]
        want = ops.decode_attention(*ins, sp[None])
        got = ops.decode_attention(*[t.to(cuda_device) for t in ins],
                                   sp[None].to(cuda_device))
        assert got.dtype == dtype
        _close(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "h2o-danube-3-4b",
                                  "falcon-mamba-7b"])
def test_cuda_decode_loop_makes_no_host_wait(cuda_device, arch):
    """The serving CLI's decode loop (``launch.serve.decode_loop``) at the
    reduced config with an NF4 backbone (an int8 KV cache for
    h2o-danube, its window wrapping) under
    ``set_sync_debug_mode("warn")``: no synchronizing call inside the
    loop; the LoRA projections through the kernel, no plain route.
    (Card against CPU: chip_smoke.py phase 12 (c).)"""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import torch_loop_syncs
    from repro_torch import convert
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = get_reduced(arch).replace(quant_bits=4, quant_mode="nf4",
                                    quant_block=64)
    if arch == "h2o-danube-3-4b":
        cfg = cfg.replace(kv_quant_bits=8)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 64))

    f, t = (convert.tree_to(params[k], cuda_device)
            for k in ("frozen", "trainable"))
    prompt = torch.as_tensor(toks, dtype=torch.int32, device=cuda_device)
    logits, cache = model.prefill(f, t, {"tokens": prompt}, max_len=80)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    pos = torch.full((), 64, dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    ops.reset_kernel_traces()
    with torch_loop_syncs.sync_warnings() as stacks:
        out = serve.decode_loop(model, f, t, cache, tok, pos, 16,
                                greedy=True)
        torch.cuda.synchronize()
    in_loop = [st for st in stacks if any(fr.name == "decode_loop"
                                          for fr in st)]
    assert not in_loop, [f"{st[-1].filename}:{st[-1].lineno}"
                         for st in in_loop]
    assert not [k for k in ops.KERNEL_TRACES if k.endswith("_ref")]
    if cfg.family == "dense":
        # 2 streams a step: the decode route
        assert ops.KERNEL_TRACES["lora_matmul_cuda_gemv"] == \
            7 * cfg.n_layers * 16
    assert len(out) == 16 and int(torch.cat(out, 1).max()) < cfg.vocab_size


# -- the mesh and the expert-parallel runtime on one card -----------------

@pytest.fixture
def nccl_world(cuda_device):
    """The NCCL world of one rank (``launch.mesh.init_world``) and its
    ``(pod=1, data=1, model=1)`` Runtime."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import runtime as rt_lib
    mesh_lib.init_world(cuda_device)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    mesh = mesh_lib.make_debug_mesh((1, 1, 1))
    return rt_lib.Runtime(mesh, ("pod", "data"), "model")


@pytest.mark.cuda
def test_cuda_nccl_world_of_one_runs_every_collective(nccl_world):
    """Each collective the bodies use, issued on the NCCL world group
    directly (the bodies skip collectives over one rank): all-to-all,
    all-gather, all-reduce, reduce-scatter, bf16, fp32 and int8."""
    import torch.distributed as dist
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        x = (torch.arange(12, device="cuda") % 7).to(dt)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        assert torch.equal(out, x)
        dist.all_gather_into_tensor(out, x)
        assert torch.equal(out, x)
        y = x.clone()
        dist.all_reduce(y)
        assert torch.equal(y, x)
        dist.reduce_scatter_tensor(out, x)
        assert torch.equal(out, x)
    assert nccl_world.tp_size == nccl_world.dp_size == 1


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_moe_under_the_runtime_matches_the_local_path(nccl_world,
                                                           quant):
    """Reduced Qwen3-MoE's layer through the expert-parallel body on the
    card (the per-expert loop; NF4 experts through the ``quant_matmul``
    kernel and its dx) against the local path: equal routes, output and
    input gradient within 1e-5 (fp32, TF32 off); the body traced as
    ``moe_ffn_dist_seq`` / ``moe_ffn_dist_decode``."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import quant as qlib
    from repro_torch.models import moe
    from repro_torch.models import runtime as rt_lib
    cfg = get_reduced("qwen3-moe-235b-a22b")
    g = torch.Generator(device="cuda").manual_seed(0)
    p = moe.init_experts(g, cfg, torch.float32, "cuda")
    if quant:
        p = {k: v if k == "router" else qlib.quantize(
            v, bits=4, block=64, mode="nf4") for k, v in p.items()}
    x = torch.randn((4, 8, cfg.d_model), generator=g, device="cuda") * 0.1
    rt_lib.reset_dist_traces()
    ops.reset_kernel_traces()
    out = {}
    for side, rt in (("local", None), ("dist", nccl_world)):
        xr = x.clone().requires_grad_(True)
        with rt_lib.runtime(rt):
            y, aux = moe.moe_ffn(p, xr, cfg)
            dx, = torch.autograd.grad((y * y).sum() + aux, xr)
            yd, _ = moe.moe_ffn(p, x[:, :1], cfg)
        out[side] = (y.detach(), aux.detach(), dx, yd)
    for a, b in zip(out["dist"], out["local"]):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= 1e-5, err
    assert rt_lib.DIST_TRACES == {"moe_ffn_dist_seq": 1,
                                  "moe_ffn_dist_decode": 1}
    if quant:
        assert ops.KERNEL_TRACES.get("quant_matmul_cuda", 0) > 0
        assert not [k for k in ops.KERNEL_TRACES if k.endswith("_ref")]


@pytest.mark.cuda
def test_cuda_mesh_of_one_cohort_round_matches_the_unsharded(nccl_world):
    """A ``qlora_nogan`` cohort round with ``CohortConfig(mesh=)`` on the
    mesh of one rank against the unsharded engine on the same weights
    and draws: the trainables within 1e-5, losses within 1e-4, uplink
    bytes equal (``chip_smoke.py`` phase 14 (d) runs it at ViT-B/32
    width)."""
    from repro_torch.core import clip as clip_lib
    from repro_torch.data.synthetic import class_tokens, make_dataset
    from repro_torch.fl import client as client_lib
    from repro_torch.fl import cohort as cohort_lib
    from repro_torch.fl import partition
    from repro_torch.fl.strategies import STRATEGIES
    strat = STRATEGIES["qlora_nogan"]
    ccfg = clip_lib.CLIPConfig()
    g = torch.Generator(device="cuda").manual_seed(3)
    frozen = clip_lib.init_clip(g, ccfg, device="cuda")
    data = make_dataset("pacs", n_per_class=10, seed=0, longtail_gamma=2.0)
    spec = data["spec"]
    with torch.no_grad():
        ce = clip_lib.text_embedding(frozen, ccfg, torch.as_tensor(
            class_tokens(spec, np.arange(spec.n_classes)), device="cuda"))
    parts = partition.dirichlet_partition(data["labels"], 4, 1.0, seed=0)
    tr = client_lib.init_trainable(g, ccfg, strat, device="cuda")
    key = cohort_lib.RoundKey(cohort_lib.SeededDraws(7), (3, 0))
    res = {}
    for name, mesh in (("local", None), ("mesh", nccl_world.mesh)):
        clients = [client_lib.Client(
            cid=i, images=data["images"][idx], labels=data["labels"][idx],
            n_classes=spec.n_classes, strategy=strat)
            for i, idx in enumerate(parts)]
        eng = cohort_lib.CohortEngine(
            frozen=frozen, ccfg=ccfg, class_emb=ce, clients=clients,
            cfg=cohort_lib.CohortConfig(strategy=strat, local_steps=3,
                                        batch_size=8, lr=3e-3, mesh=mesh))
        res[name] = eng.run_round(tr, key)
    (t0, m0), (t1, m1) = res["local"], res["mesh"]
    from repro_torch import tree as tree_lib
    for a, b in zip(tree_lib.leaves(t0), tree_lib.leaves(t1)):
        assert float((a - b).abs().max()) <= 1e-5
    assert float((m0["loss"] - m1["loss"]).abs().max()) <= 1e-4
    assert m0["uplink_bytes"] == m1["uplink_bytes"]
