"""The port's dense decoder (repro_torch.models) against the JAX package,
on the CPU, at reduced Yi-9B with an NF4 backbone (block 64).

Weights come from the JAX ``Model.init_params`` through
``repro_torch.convert``; the trainables get seeded numpy noise on both
sides so that the zero-init LoRA B and adapter wo/w2 carry gradient
through every path. In fp32, logits and grads agree within 1e-4 times
the largest magnitude (the layer stack sums in another order than
XLA's) and the loss within 1e-5; Adam on the same grads agrees within
1e-6. In bf16, logits and loss agree within 2e-2 (the JAX package's
bf16 bound); bf16 grads are held to the band that JAX's own bf16 grads
lie in around the fp32 grads. The port's own per-layer NF4 init is
bitwise equal to ``quantize_tree`` on the dense stack, and its remat
switch does not change a step. The flash-attention backward (PyTorch
ops, not autograd through the plain forward) is held against
``jax.grad`` of the JAX package's plain attention, up to the adapter's
D = 512."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_reduced
from repro.core import optim as joptim
from repro.core import quant as jq
from repro.kernels import ref as jref
from repro.models import build_model as j_build
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced
from repro_torch.core import optim, quant as qlib
from repro_torch.kernels import ops
from repro_torch.launch.train import synthetic_token_stream
from repro_torch.models import build_model

torch.set_num_threads(1)
NF4 = dict(quant_bits=4, quant_mode="nf4", quant_block=64)


def _cfgs(**kw):
    return (j_reduced("yi-9b").replace(**NF4, **kw),
            get_reduced("yi-9b").replace(**NF4, **kw))


def _perturbed(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda l: (l + jnp.asarray(rs.randn(*l.shape) * 0.05, l.dtype)), tree)


def _batch(seed=0, B=2, S=16, vocab=256):
    toks = synthetic_token_stream(np.random.RandomState(seed), vocab, 1,
                                  docs_per_client=B, seq=S)[0]
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]),
          "mask": jnp.ones(toks[:, 1:].shape, jnp.float32)}
    tb = {k: convert.tree_from_numpy({"v": v}, "cpu")["v"]
          for k, v in jb.items()}
    return jb, tb


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jm = j_build(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    frozen = params["frozen"]
    tr = _perturbed(params["trainable"], 1)
    return jm, build_model(tcfg), frozen, tr


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(jm):
    """``jax.value_and_grad`` of ``jm.loss_fn``, jitted once per model."""
    return jax.jit(jax.value_and_grad(
        lambda t, f, b: jm.loss_fn(f, t, b), has_aux=True))


def _to_port(tree):
    return convert.tree_from_numpy(tree, "cpu")


def _assert_tree_close(got_tree, want_tree, rel, what):
    got = dict(tree_lib.flatten_with_path(got_tree))
    want = dict(tree_lib.flatten_with_path(
        convert.tree_to_numpy(_to_port(want_tree))))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g = got[path].detach().to(torch.float32).numpy()
        scale = max(1e-6, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=rel * scale,
                                   err_msg=f"{what} {path}")


def test_per_layer_nf4_init_equals_quantize_tree_on_the_stack():
    _, cfg = _cfgs()
    quant = build_model(cfg).init_params(
        torch.Generator().manual_seed(3), device="cpu")["frozen"]["layers"]
    dense = build_model(cfg.replace(quant_bits=0)).init_params(
        torch.Generator().manual_seed(3), device="cpu")["frozen"]["layers"]
    want = qlib.quantize_tree(dense, bits=4, block=64, mode="nf4")
    for name, w in want.items():
        g = quant[name]
        if isinstance(w, qlib.QTensor):
            assert (g.bits, g.mode, g.block, g.out_dtype, g.orig_shape) == \
                (w.bits, w.mode, w.block, w.out_dtype, w.orig_shape), name
            assert torch.equal(g.q, w.q) and torch.equal(g.scales, w.scales)
        else:
            assert torch.equal(g, w), name
    assert isinstance(quant["wd"], qlib.QTensor) and quant["wd"].q.ndim == 4


def test_converted_frozen_tree_keeps_stacked_qtensors(pair):
    _, _, frozen, _ = pair
    tf = _to_port(frozen)
    wq = tf["layers"]["wq"]
    jwq = frozen["layers"]["wq"]
    assert isinstance(wq, qlib.QTensor) and wq.q.shape == jwq.q.shape
    assert wq.out_dtype == torch.float32 and wq.mode == "nf4"
    np.testing.assert_array_equal(wq.q.numpy(), np.asarray(jwq.q))


def test_logits_loss_and_grads_match_jax(pair):
    jm, tm, frozen, tr = pair
    jb, tb = _batch()
    jlogits, _ = jm.forward(frozen, tr, jb)
    (jloss, _), jgrads = _jax_grad_fn(jm)(tr, frozen, jb)
    tf, ttr = _to_port(frozen), _to_port(tr)
    ops.reset_kernel_traces()
    with torch.no_grad():
        logits, _ = tm.forward(tf, ttr, tb)
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    (loss, _), grads = tm.grads(tf, ttr, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_tree_close(grads, jgrads, 1e-4, "grad")
    # the CPU path takes the plain versions: every LoRA linear of the two
    # layers, the backbone's and the adapter's attention
    assert ops.KERNEL_TRACES["lora_matmul_ref"] >= 14
    assert ops.KERNEL_TRACES["flash_attention_ref"] >= 3
    assert ops.KERNEL_TRACES["flash_attention_bwd"] == 3


def test_one_adam_step_matches_jax_and_remat_changes_nothing(pair):
    """Adam with clipping on the same grads equals the JAX update (params
    and both moments), and a whole port train_step, remat on or off,
    gives the JAX step's loss and grad norm. The step's params are not
    compared elementwise end to end: at step 1 Adam divides each grad by
    its own magnitude, so a grad near eps=1e-8 turns a 1e-9 difference
    into a visible update difference."""
    jm, tm, frozen, tr = pair
    jb, tb = _batch(seed=1)
    (jloss, _), jgrads = _jax_grad_fn(jm)(tr, frozen, jb)
    jtr2, jopt2 = joptim.adam_update(jgrads, joptim.adam_init(tr), tr,
                                     lr=1e-3, grad_clip=1.0)
    ttr = _to_port(tr)
    tr2, opt2 = optim.adam_update(_to_port(jgrads), optim.adam_init(ttr),
                                  ttr, lr=1e-3, grad_clip=1.0)
    _assert_tree_close(tr2, jtr2, 1e-6, "params after one Adam step")
    _assert_tree_close(opt2.mu, jopt2.mu, 1e-6, "Adam mu")
    _assert_tree_close(opt2.nu, jopt2.nu, 1e-6, "Adam nu")
    assert int(opt2.step) == int(jopt2.step) == 1

    tf = _to_port(frozen)
    out = {}
    for remat in (True, False):
        tm.cfg = tm.cfg.replace(remat=remat)
        out[remat] = tm.train_step(tf, ttr, optim.adam_init(ttr), tb,
                                   lr=1e-3)
    tm.cfg = tm.cfg.replace(remat=True)
    (tr_a, opt_a, m_a), (tr_b, opt_b, m_b) = out[True], out[False]
    for a, b in zip(tree_lib.leaves(tr_a), tree_lib.leaves(tr_b)):
        assert torch.equal(a, b)
    assert torch.equal(m_a["grad_norm"], m_b["grad_norm"])
    # the JAX train_step's metrics: its loss and the grads' global norm
    np.testing.assert_allclose(float(m_a["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m_a["grad_norm"]),
                               float(joptim.global_norm(jgrads)), rtol=1e-4)


def _frozen_as(frozen, dtype):
    """The fixture's frozen tree with its bf16-able leaves (embedding,
    head, the QTensors' output type) in ``dtype``; norms stay fp32."""
    def one(leaf):
        if isinstance(leaf, jq.QTensor):
            return dataclasses.replace(leaf, out_dtype=dtype)
        return leaf if leaf.ndim < 2 else leaf.astype(dtype)
    return jax.tree.map(one, frozen,
                        is_leaf=lambda l: isinstance(l, jq.QTensor))


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_model_matches_jax(pair):
    """bf16 model dtype: logits within 2e-2 times their largest magnitude
    of the JAX package's, loss within 2e-2. The two packages round to
    bf16 at different places, so their bf16 grads differ by a few percent
    (norm) from each other and from the fp32 grads on the same weights;
    each port grad leaf must lie within twice JAX's own distance from
    those fp32 grads, plus 0.02."""
    jm, _, frozen, tr = pair
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jm16 = j_build(jcfg)
    f16 = _frozen_as(frozen, jnp.bfloat16)
    f32 = _frozen_as(f16, jnp.float32)       # the same values, in fp32
    jb, tb = _batch(seed=2)
    jlogits, _ = jm16.forward(f16, tr, jb)
    (jloss, _), jgrads = _jax_grad_fn(jm16)(tr, f16, jb)
    _, truth = _jax_grad_fn(jm)(tr, f32, jb)
    tf = _to_port(f16)
    assert tf["embed"].dtype == torch.bfloat16
    assert tf["layers"]["wq"].out_dtype == torch.bfloat16
    tm = build_model(tcfg)
    with torch.no_grad():
        logits, _ = tm.forward(tf, _to_port(tr), tb)
    assert logits.dtype == torch.bfloat16
    want = np.asarray(jlogits.astype(jnp.float32))
    np.testing.assert_allclose(logits.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max())
    (loss, _), grads = tm.grads(tf, _to_port(tr), tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    got = dict(tree_lib.flatten_with_path(grads))
    jg = dict(tree_lib.flatten_with_path(convert.tree_to_numpy(
        _to_port(jgrads))))
    t32 = dict(tree_lib.flatten_with_path(convert.tree_to_numpy(
        _to_port(truth))))
    for path, t in t32.items():
        g = got[path].to(torch.float32).numpy()
        assert _norm_rel(g, t) <= 2 * _norm_rel(jg[path], t) + 0.02, path


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", [
    (2, 5, 4, 2, 16, True, None),      # backbone-like GQA, causal
    (1, 7, 2, 2, 24, True, 3),         # sliding window
    (2, 3, 2, 2, 512, True, None),     # the adapter's D at Yi-9B width
    (1, 4, 2, 1, 8, False, None),      # bidirectional, one KV head
])
def test_flash_attention_backward_matches_jax_grad(B, S, H, Hkv, D, causal,
                                                   window):
    rs = np.random.RandomState(D + S)
    q, k, v = (rs.randn(B, S, h, D).astype(np.float32)
               for h in (H, Hkv, Hkv))
    ct = rs.randn(B, S, H, D).astype(np.float32)

    def jloss(q, k, v):
        o = jref.flash_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(o * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    (ops.flash_attention(*ts, causal=causal, window=window)
     * torch.from_numpy(ct)).sum().backward()
    for t, w, name in zip(ts, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
