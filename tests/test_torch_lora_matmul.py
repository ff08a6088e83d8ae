"""The port's fused LoRA linear against the JAX package, on the CPU.

The plain versions of ``lora_matmul`` and ``quant_matmul_t``
(``repro_torch.kernels.ref``, the CPU path and the oracle of the CUDA
kernels in ``csrc/lora_matmul.cu``) are held against the JAX Pallas
kernels run in interpret mode, over int8, int4 and NF4, an even and an
odd K (the padded-K contract) and a tile-aligned and a ragged N. The
``autograd.Function`` behind ``ops.lora_matmul`` is held against
``jax.grad`` of ``repro.kernels.ops.lora_matmul`` with the Pallas path
forced to interpret mode (so its VJP runs the interpreted
``quant_matmul_t``). Tolerances: 1e-5 in fp32; in bf16 2e-2 times the
largest magnitude, the JAX package's own bf16 bound
(tests/test_kernels.py). The kernels themselves run on the card only
(tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lora_matmul import lora_matmul as pallas_lora
from repro.kernels.lora_matmul import quant_matmul_t as pallas_qmt
from repro_torch import convert
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
FORMATS = [(8, "linear"), (4, "linear"), (4, "nf4")]
SHAPES = [(128, 96), (200, 33)]       # (K, N): even K / odd K, ragged N
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
M, R, SCALE = 9, 4, 2.0


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(arr, jdt, tdt):
    """The same values in both packages, rounded to the dtype once."""
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


def _qt(K, N, bits, mode, seed=3):
    w = _np(seed, K, N) / np.sqrt(K)
    j = jref.blockwise_quant(jnp.asarray(w), bits=bits, block=64, mode=mode)
    return j, convert.tree_from_numpy({"w": j}, "cpu")["w"]


def _close(got, want, tdt, what):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.to(torch.float32).numpy()
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(
            got, want, atol=2e-2 * max(1.0, float(np.abs(want).max())),
            err_msg=what)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("bits,mode", FORMATS)
def test_lora_matmul_plain_vs_pallas_interpret(bits, mode, K, N, jdt, tdt):
    jqt, tqt = _qt(K, N, bits, mode)
    jx, tx = _both(_np(0, M, K), jdt, tdt)
    a, b = _np(1, K, R) / np.sqrt(K), _np(2, R, N)
    want = pallas_lora(jx, jqt, jnp.asarray(a), jnp.asarray(b), scale=SCALE,
                       block_m=8, block_n=32, interpret=True)
    got = ref.lora_matmul(tx, tqt, torch.from_numpy(a), torch.from_numpy(b),
                          scale=SCALE)
    assert got.dtype == tdt and got.shape == (M, N)
    _close(got, want, tdt, "ref.lora_matmul")
    # the op's CPU route is the same plain arithmetic
    op = ops.lora_matmul(tx, tqt, torch.from_numpy(a), torch.from_numpy(b),
                         scale=SCALE)
    _close(op, want, tdt, "ops.lora_matmul")


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("bits,mode", FORMATS)
def test_quant_matmul_t_plain_vs_pallas_interpret(bits, mode, K, N, jdt,
                                                  tdt):
    jqt, tqt = _qt(K, N, bits, mode)
    jg, tg = _both(_np(4, M, N), jdt, tdt)
    want = pallas_qmt(jg, jqt, block_m=8, block_n=32, interpret=True)
    got = ref.quant_matmul_t(tg, tqt)
    Kq = tqt.q.shape[0] * tqt.block
    assert got.shape == (M, Kq) and got.dtype == tdt and Kq >= K
    _close(got, want, tdt, "quant_matmul_t")


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("bits,mode,K,N", [(8, "linear", 128, 96),
                                           (4, "linear", 200, 33),
                                           (4, "nf4", 200, 96)])
def test_lora_op_grads_vs_jax_grad(bits, mode, K, N, jdt, tdt, monkeypatch):
    """dx, dA, dB of the port's autograd.Function == jax.grad through the
    JAX package's custom VJP on its Pallas path (interpret mode)."""
    monkeypatch.setattr(jops, "_FORCE", "interpret")
    jqt, tqt = _qt(K, N, bits, mode)
    x, ct = _np(5, M, K), _np(6, M, N)
    a, b = _np(7, K, R) * 0.1, _np(8, R, N) * 0.1
    jx, tx = _both(x, jdt, tdt)

    def jloss(x, a, b):
        y = jops.lora_matmul(x, jqt, a, b, scale=SCALE)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jx, jnp.asarray(a),
                                              jnp.asarray(b))
    tx.requires_grad_(True)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    ops.reset_kernel_traces()
    y = ops.lora_matmul(tx, tqt, ta, tb, scale=SCALE)
    (y.to(torch.float32) * torch.from_numpy(ct)).sum().backward()
    assert ops.KERNEL_TRACES == {"lora_matmul_ref": 1}
    for got, w, name in zip((tx.grad, ta.grad, tb.grad), want,
                            ("dx", "dA", "dB")):
        assert got.dtype == (tdt if name == "dx" else torch.float32), name
        _close(got, w, got.dtype, name)


def test_lora_op_dense_w_grads_include_dw():
    """A dense W stays plain PyTorch: autograd gives dx, dW, dA and dB as
    the JAX package's VJP does for that branch."""
    x, w, ct = _np(9, 7, 32), _np(10, 32, 16), _np(11, 7, 16)
    a, b = _np(12, 32, 4) * 0.1, _np(13, 4, 16) * 0.1

    def jloss(x, w, a, b):
        y = jops.lora_matmul(x, w, a, b, scale=SCALE)
        return jnp.sum(y * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t) for t in (x, w, a, b)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (x, w, a, b)]
    (ops.lora_matmul(*ts[:2], *ts[2:], scale=SCALE)
     * torch.from_numpy(ct)).sum().backward()
    for t, w_, name in zip(ts, want, ("dx", "dW", "dA", "dB")):
        _close(t.grad, w_, torch.float32, name)
