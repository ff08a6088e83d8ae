"""The port's CUDA kernels against their plain PyTorch versions, on the
card. This file imports neither JAX nor the JAX package, so it runs on a
machine with an H100 and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a Hopper GPU every test skips with its reason. Tolerances: fp32
1e-5 (TF32 off), ``blockwise_quant`` bitwise."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import blockwise_quant as bq_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import quant_matmul as qmm_kernel
from repro_torch.kernels import ref

FORMATS = [(8, "linear"), (4, "linear"), (4, "nf4")]
FLASH_CASES = [  # (B, S, H, Hkv, D, causal, window)
    (1, 1, 4, 4, 192, False, None),    # the adapter at S=1, CLIP width
    (2, 40, 4, 2, 16, True, 8),        # GQA, causal, sliding window
    (1, 33, 2, 2, 24, False, None),    # D not a power of two
    (1, 5, 4, 4, 16, True, None),      # the adapter's causal S=5
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
@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("M,N", [(3, 70), (1, 96), (6, 128)])
def test_cuda_quant_matmul_matches_plain(cuda_device, bits, mode, M, N):
    # (1, 96): the GEMV path; (3, 70): the tiled path (ragged N);
    # (6, 128): the tiled path past 4 rows; odd K=100 pads in all three
    w = torch.from_numpy(_np(23, 4, 100, N)).to(cuda_device)
    x = torch.from_numpy(_np(24, 4, M, 100)).to(cuda_device)
    qt = ref.blockwise_quant(w, bits=bits, block=64, mode=mode)
    got = qmm_kernel.quant_matmul(x, qt)
    torch.testing.assert_close(got, ref.quant_matmul(x, qt), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_blockwise_quant_bitwise(cuda_device, bits):
    x = torch.from_numpy(_np(25, 100, 70)).to(cuda_device)
    got = bq_kernel.blockwise_quant(x, bits=bits, block=64)
    want = ref.blockwise_quant(x, bits=bits, block=64)
    assert torch.equal(got.q, want.q) and torch.equal(got.scales, want.scales)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, B, S, H, Hkv, D,
                                            causal, window):
    q, k, v = (torch.from_numpy(_np(s, B, S, h, D)).to(cuda_device)
               for s, h in ((26, H), (27, Hkv), (28, Hkv)))
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(
        got, ref.flash_attention(q, k, v, causal=causal, window=window),
        rtol=1e-5, atol=1e-5)
