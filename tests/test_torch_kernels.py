"""The port's kernel ops (repro_torch.kernels) against the JAX package.

On the CPU the port's ops take their plain PyTorch versions
(``repro_torch.kernels.ref``); these are held against the JAX Pallas
kernels run in interpret mode, as tests/test_kernels.py runs them
(fp32, 1e-5), and against ``repro.kernels.ref``. ``blockwise_quant``
equals the JAX eager reference bitwise; against the interpreted Pallas
kernel its payload is equal and its scales lie within 1 ulp (the
compiled kernel multiplies by 1/127 where the reference divides). The
CUDA kernels themselves are tested on the card by test_torch_cuda.py."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import quant as jq
from repro.kernels import ref as jref
from repro.kernels.blockwise_quant import blockwise_quant as pallas_bq
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.quant_matmul import quant_matmul as pallas_qmm
from repro_torch import convert
from repro_torch.kernels import blockwise_quant as bq_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import lora_matmul as lm_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qmm_kernel
from repro_torch.kernels import ref

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FORMATS = [(8, "linear"), (4, "linear"), (4, "nf4")]


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qt_pair(w, bits, mode, block):
    """The same QTensor for both packages (JAX eager quantizer, converted)."""
    j = jref.blockwise_quant(jnp.asarray(w), bits=bits, block=block, mode=mode)
    return j, convert.tree_from_numpy({"w": j}, "cpu")["w"]


# -- quant_matmul ------------------------------------------------------

@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("M,K,N,block", [(4, 128, 64, 64), (3, 100, 70, 64),
                                         (1, 64, 40, 32)])
def test_quant_matmul_plain_vs_pallas_interpret(bits, mode, M, K, N, block):
    x = _np(0, M, K)
    jqt, tqt = _qt_pair(_np(1, K, N) / np.sqrt(K), bits, mode, block)
    want = np.asarray(pallas_qmm(jnp.asarray(x), jqt, block_m=8, block_n=32,
                                 interpret=True))
    got = ref.quant_matmul(torch.from_numpy(x), tqt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jref.quant_matmul(jnp.asarray(x), jqt)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("x_lead", [(), (3,)])
def test_quant_matmul_stacked_matches_jax(x_lead):
    # the serve plane's per-user slabs: q (T, G, ., N), x (T, [M,] K)
    T, K, N = 4, 96, 48
    w = _np(2, T, K, N) / np.sqrt(K)
    jqt = jq.quantize(jnp.asarray(w), bits=8, block=32)
    tqt = convert.tree_from_numpy({"w": jqt}, "cpu")["w"]
    x = _np(3, T, *x_lead, K)
    want = np.asarray(jax.vmap(jref.quant_matmul)(jnp.asarray(x), jqt)) \
        if x_lead else np.asarray(jref.quant_matmul(jnp.asarray(x), jqt))
    got = ref.quant_matmul(torch.from_numpy(x), tqt).numpy()
    assert got.shape == (T, *x_lead, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- blockwise_quant ---------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N,block", [(128, 96, 64), (100, 70, 64),
                                       (64, 33, 16)])
def test_blockwise_quant_plain_bitwise_vs_jax_ref(bits, K, N, block):
    x = _np(4, K, N)
    j = jref.blockwise_quant(jnp.asarray(x), bits=bits, block=block)
    t = ref.blockwise_quant(torch.from_numpy(x), bits=bits, block=block)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    assert t.orig_shape == tuple(j.orig_shape) == (K, N)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N,block", [(128, 96, 64), (100, 70, 64)])
def test_blockwise_quant_plain_vs_pallas_interpret(bits, K, N, block):
    x = _np(5, K, N)
    p = pallas_bq(jnp.asarray(x), bits=bits, block=block, block_n=32,
                  interpret=True)
    t = ref.blockwise_quant(torch.from_numpy(x), bits=bits, block=block)
    np.testing.assert_array_max_ulp(t.scales.numpy(), np.asarray(p.scales),
                                    maxulp=1)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(p.q))


# -- flash_attention ---------------------------------------------------

FLASH_CASES = [  # (B, S, H, Hkv, D, causal, window)
    (1, 1, 4, 4, 16, False, None),     # the adapter at S=1
    (2, 40, 4, 2, 16, True, 8),        # GQA, causal, sliding window
    (1, 33, 2, 2, 24, False, None),    # D not a power of two
    (1, 5, 4, 4, 16, True, None),      # the adapter's causal S=5
]


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", FLASH_CASES)
def test_flash_attention_plain_vs_pallas_interpret(B, S, H, Hkv, D, causal,
                                                   window):
    q, k, v = _np(6, B, S, H, D), _np(7, B, S, Hkv, D), _np(8, B, S, Hkv, D)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, block_q=16, block_k=16,
                                   interpret=True))
    got = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # every row has a valid key, so the JAX blocked reference agrees too
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window)), rtol=1e-5, atol=1e-5)


def test_flash_attention_fully_masked_row_is_zero():
    # a window of 1 with the query past the keys: the Pallas kernel's
    # max(l, 1e-30) gives 0 for a row that sees no key
    q, k, v = (torch.from_numpy(_np(s, 1, 3, 2, 8)) for s in (9, 10, 11))
    out = ref.flash_attention(q, k[:, :1], v[:, :1], causal=True, window=1)
    assert torch.all(out[:, 1:] == 0) and torch.any(out[:, 0] != 0)


# -- lora_matmul (plain, both branches) --------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_lora_matmul_plain_vs_jax_ref(quantized):
    x, a, b = _np(12, 6, 64), _np(13, 64, 4), _np(14, 4, 32)
    w = _np(15, 64, 32) / 8
    jw, tw = (_qt_pair(w, 4, "nf4", 32) if quantized
              else (jnp.asarray(w), torch.from_numpy(w)))
    want = np.asarray(jref.lora_matmul(jnp.asarray(x), jw, jnp.asarray(a),
                                       jnp.asarray(b), scale=0.5))
    got = ops.lora_matmul(torch.from_numpy(x), tw, torch.from_numpy(a),
                          torch.from_numpy(b), scale=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- dispatch ----------------------------------------------------------

def test_ops_dispatch_cpu_tensors_to_plain_versions():
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    x = torch.from_numpy(_np(16, 2, 64))
    qt = ops.blockwise_quant(torch.from_numpy(_np(17, 64, 32)), bits=8,
                             block=32)
    np.testing.assert_array_equal(
        ops.quant_matmul(x, qt).numpy(), ref.quant_matmul(x, qt).numpy())
    q = torch.from_numpy(_np(18, 1, 3, 2, 8))
    ops.flash_attention(q, q, q, causal=True)
    assert ops.KERNEL_TRACES == {"blockwise_quant_ref": 1,
                                 "quant_matmul_ref": 1,
                                 "flash_attention_ref": 1}
    assert ops.launch_counts() == {"quant_matmul": 0, "blockwise_quant": 0,
                                   "flash_attention": 0, "lora_matmul": 0,
                                   "quant_matmul_t": 0, "selective_scan": 0,
                                   "selective_scan_bwd": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    # a wrapper launches its kernel or raises; it never computes on the CPU
    x = torch.from_numpy(_np(19, 64, 32))
    qt = ref.blockwise_quant(x, bits=8, block=32)
    with pytest.raises(ValueError, match="CUDA"):
        bq_kernel.blockwise_quant(x, bits=8, block=32)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel.quant_matmul(x[:2], qt)
    q = torch.from_numpy(_np(20, 1, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, q, q)
    a, b = torch.from_numpy(_np(25, 64, 4)), torch.from_numpy(_np(26, 4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        lm_kernel.lora_matmul(x[:2], qt, a, b, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        lm_kernel.quant_matmul_t(x[:2], qt)


def test_ops_refuse_unported_kernel_paths(monkeypatch):
    x = torch.from_numpy(_np(21, 2, 64))
    qt = ref.blockwise_quant(torch.from_numpy(_np(22, 64, 32)), bits=8,
                             block=32)
    a, b = torch.from_numpy(_np(23, 64, 4)), torch.from_numpy(_np(24, 4, 32))
    # a device with no kernel and no plain path
    with pytest.raises(NotImplementedError, match="no kernel"):
        ops.quant_matmul(x.to("meta"), qt)
    # a quantized W on the card routes to the fused LoRA kernel, and the
    # backward's dx to quant_matmul_t, never to the plain versions
    calls = []
    monkeypatch.setattr(ops, "_on_cuda", lambda t, op: True)
    monkeypatch.setattr(
        ops.lm_kernel, "lora_matmul",
        lambda x_, w, a_, b_, scale: calls.append("lora_matmul") or
        ref.lora_matmul(x_, w, a_, b_, scale=scale))
    cotangents = []
    monkeypatch.setattr(
        ops.lm_kernel, "quant_matmul_t",
        lambda g, w, out_dtype=None: calls.append("quant_matmul_t") or
        cotangents.append((g.dtype, out_dtype)) or
        ref.quant_matmul_t(g, w, out_dtype=out_dtype))
    ops.reset_kernel_traces()
    xg = x.clone().requires_grad_(True)
    ops.lora_matmul(xg, qt, a, b, scale=1.0).sum().backward()
    assert calls == ["lora_matmul", "quant_matmul_t"]
    # two rows: the decode route, either dtype
    assert ops.KERNEL_TRACES == {"lora_matmul_cuda_gemv": 1,
                                 "quant_matmul_t_cuda_tf32x3": 1}
    np.testing.assert_allclose(
        xg.grad.numpy(), (ref.quant_matmul_t(torch.ones(2, 32), qt)
                          + (torch.ones(2, 32) @ b.t()) @ a.t()).numpy(),
        rtol=1e-5, atol=1e-5)
    # a bf16 x: the backward hands the kernel the bf16 cotangent itself,
    # with an fp32 output, on the tensor-core route
    ops.reset_kernel_traces()
    calls.clear()
    xb = x.to(torch.bfloat16).requires_grad_(True)
    ops.lora_matmul(xb, qt, a, b, scale=1.0).sum().backward()
    assert calls == ["lora_matmul", "quant_matmul_t"]
    assert cotangents == [(torch.float32, torch.float32),
                          (torch.bfloat16, torch.float32)]
    assert ops.KERNEL_TRACES == {"lora_matmul_cuda_gemv": 1,
                                 "quant_matmul_t_cuda_tc": 1}
    np.testing.assert_allclose(
        xb.grad.float().numpy(),
        (ref.quant_matmul_t(torch.ones(2, 32), qt)
         + (torch.ones(2, 32) @ b.t()) @ a.t()).to(torch.bfloat16).float()
        .numpy(), rtol=1e-5, atol=1e-5)
    # blockwise_quant takes the reference op's branch: the kernel for 2-D
    # linear input, the plain quantizer for NF4 or input that is not 2-D,
    # bitwise the JAX package's ref.blockwise_quant
    monkeypatch.setattr(ops.bq_kernel, "blockwise_quant",
                        lambda x_, bits, block: calls.append("bq") or
                        ref.blockwise_quant(x_, bits=bits, block=block))
    w3 = _np(27, 3, 64, 32)
    for w, bits, mode in ((_np(22, 64, 32), 4, "nf4"), (w3, 8, "linear"),
                          (w3, 4, "nf4")):
        ops.reset_kernel_traces()
        calls.clear()
        got = ops.blockwise_quant(torch.from_numpy(w), bits=bits, block=32,
                                  mode=mode)
        want = jref.blockwise_quant(jnp.asarray(w), bits=bits, block=32,
                                    mode=mode)
        assert ops.KERNEL_TRACES == {"blockwise_quant_ref": 1} and not calls
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scales.numpy(),
                                      np.asarray(want.scales))
        assert tuple(got.orig_shape) == tuple(want.orig_shape)
    ops.reset_kernel_traces()
    ops.blockwise_quant(torch.from_numpy(_np(22, 64, 32)), bits=4, block=32)
    assert ops.KERNEL_TRACES == {"blockwise_quant_cuda": 1}
    assert calls == ["bq"]


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import sys; sys.path.insert(0, 'src'); sys.path.insert(0, '.')\n"
        "import repro_torch, repro_torch.fl.serve, repro_torch.convert\n"
        "import repro_torch.kernels.ops, chip_smoke\n"
        "import repro_torch.models, repro_torch.launch.train\n"
        "import repro_torch.configs\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
