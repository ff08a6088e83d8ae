"""The port's Mamba-1 path (repro_torch.models.ssm, the selective scan op
and the SSM family of repro_torch.models) against the JAX package, on
the CPU, at reduced Falcon-Mamba-7B with an NF4 backbone (block 64).

The plain scan (``repro_torch.kernels.ref.selective_scan``, the CPU
path and the card's oracle) is held against ``repro.kernels.ref`` and
the interpreted Pallas kernel within 1e-5, as tests/test_kernels.py
holds those two; its gradient (explicit reverse recurrence in PyTorch
ops) against ``jax.vjp`` of the JAX plain scan within 1e-5 of each
gradient's largest magnitude. ``mamba_block`` and the reduced model run
on weights converted from the JAX init, where the JAX package takes its
chunked associative scan on the CPU: the block's output within 1e-4 of
its largest magnitude (the JAX package's ref-vs-chunked bound), logits
and grads likewise, the loss within 1e-5, Adam on the same grads within
1e-6. The CUDA kernel is tested on the card by test_torch_cuda.py."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_reduced
from repro.core import optim as joptim
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as pallas_scan
from repro.models import build_model as j_build
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced
from repro_torch.core import optim, quant as qlib
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as ss_kernel
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.models import ssm

torch.set_num_threads(1)
NF4 = dict(quant_bits=4, quant_mode="nf4", quant_block=64)


def _scan_inputs(seed, B, S, di, N):
    rs = np.random.RandomState(seed)
    return (np.abs(rs.randn(B, S, di)).astype(np.float32) * 0.1,
            rs.randn(B, S, di).astype(np.float32),
            rs.randn(B, S, N).astype(np.float32),
            rs.randn(B, S, N).astype(np.float32),
            -np.abs(rs.randn(di, N)).astype(np.float32))


def _to_port(tree):
    return convert.tree_from_numpy(tree, "cpu")


# -- the scan ----------------------------------------------------------

@pytest.mark.parametrize("B,S,di,N,bd,ch", [
    (2, 64, 32, 8, 16, 16),
    (1, 50, 16, 4, 16, 32),    # S not a chunk multiple (the padding path)
    (2, 40, 64, 16, 32, 16),   # the full config's N
])
def test_plain_scan_matches_jax_ref_and_pallas_interpret(B, S, di, N, bd,
                                                         ch):
    ins = _scan_inputs(B * S + di, B, S, di, N)
    y, h = ref.selective_scan(*map(torch.from_numpy, ins))
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    assert y.dtype == h.dtype == torch.float32
    jins = tuple(map(jnp.asarray, ins))
    for want_y, want_h in (jref.selective_scan(*jins),
                           pallas_scan(*jins, block_d=bd, chunk=ch,
                                       interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-5)


@pytest.mark.parametrize("B,S,di,N,with_gh", [
    (2, 50, 16, 4, True),
    (1, 7, 40, 8, True),
    (2, 64, 32, 16, False),    # h_last unused, as in the model
])
def test_scan_gradient_matches_jax_vjp(B, S, di, N, with_gh):
    ins = _scan_inputs(S + di, B, S, di, N)
    rs = np.random.RandomState(S)
    gy = rs.randn(B, S, di).astype(np.float32)
    gh = rs.randn(B, di, N).astype(np.float32) * with_gh
    _, vjp = jax.vjp(jref.selective_scan, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    ops.reset_kernel_traces()
    y, h = ops.selective_scan(*ts)
    outs, cts = ((y, h), (torch.from_numpy(gy), torch.from_numpy(gh))) \
        if with_gh else ((y,), (torch.from_numpy(gy),))
    got = torch.autograd.grad(outs, ts, cts)
    assert ops.KERNEL_TRACES == {"selective_scan_ref": 1,
                                 "selective_scan_bwd_ref": 1}
    for g, w, name in zip(got, want, ("ddt", "dx", "dB", "dC", "dA")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    if not with_gh:   # a frozen A, as the model's -exp(a_log), skips dA
        ts2 = [torch.from_numpy(a).requires_grad_(i < 4)
               for i, a in enumerate(ins)]
        got2 = torch.autograd.grad(ops.selective_scan(*ts2)[0], ts2[:4],
                                   torch.from_numpy(gy))
        for g2, g in zip(got2, got):
            assert torch.equal(g2, g)


def test_scan_dispatch_and_kernel_wrapper_refuse_other_devices():
    ins = [torch.from_numpy(a) for a in _scan_inputs(0, 1, 3, 8, 4)]
    with pytest.raises(NotImplementedError, match="no kernel"):
        ops.selective_scan(*(t.to("meta") for t in ins))
    with pytest.raises(ValueError, match="CUDA"):
        ss_kernel.selective_scan(*ins)
    # the backward kernel's wrapper refuses CPU tensors too: no fallback
    gy = torch.ones((1, 3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ss_kernel.selective_scan_bwd(*ins, gy)
    with pytest.raises(ValueError, match="CUDA"):
        ss_kernel.selective_scan_bwd(*ins, gy, torch.zeros((1, 8, 4)),
                                     need_a=False)
    # on the CPU the op's backward takes the plain reverse recurrence
    ts = [t.clone().requires_grad_(True) for t in ins]
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    torch.autograd.grad(ops.selective_scan(*ts)[0].sum(), ts)
    assert ops.KERNEL_TRACES == {"selective_scan_ref": 1,
                                 "selective_scan_bwd_ref": 1}
    counts = ops.launch_counts()
    assert counts["selective_scan"] == counts["selective_scan_bwd"] == 0
    # y unused: its cotangent arrives as None and counts as zero
    ts = [t.clone().requires_grad_(True) for t in ins]
    got = torch.autograd.grad(ops.selective_scan(*ts)[1].sum(), ts)
    want = ops.selective_scan_bwd(*ins, torch.zeros((1, 3, 8)),
                                  torch.ones((1, 8, 4)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the block ---------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg = j_reduced("falcon-mamba-7b").replace(**NF4)
    jm = j_build(jcfg)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    tr = jax.tree.map(lambda l: l + jnp.asarray(
        rs.randn(*l.shape) * 0.05, l.dtype), params["trainable"])
    tm = build_model(get_reduced("falcon-mamba-7b").replace(**NF4))
    return jm, tm, params["frozen"], tr


@pytest.mark.parametrize("S", [2, 50])   # S < K - 1; S past one chunk
def test_mamba_block_matches_jax(pair, S):
    jm, tm, frozen, tr = pair
    cfg = jm.cfg
    p = jax.tree.map(lambda l: l[1], frozen["layers"])
    lo = jax.tree.map(lambda l: l[1], tr["lora"])
    x = np.random.RandomState(S).randn(2, S, cfg.d_model).astype(np.float32)
    want, jcache = jax.jit(lambda p_, x_, lo_: jssm.mamba_block(
        p_, x_, cfg, lora=lo_))(p, jnp.asarray(x), lo)
    got, cache = ssm.mamba_block(_to_port(p), torch.from_numpy(x), tm.cfg,
                                 lora=_to_port(lo))
    for g, w in ((got, want), (cache["h"], jcache["h"]),
                 (cache["conv"], jcache["conv"])):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())


def test_ssm_branches_off_the_training_path_raise(pair):
    """The dry run's calibrated scan (it raised until ROADMAP Queue A
    item 8.6 ported it) runs ``_chunked_ssm_scan`` in one chunk and
    gives the plain scan's output and state within 1e-5; a start state
    ``h0`` is ported (the mesh's body passes one) and matches the JAX
    block from the same state within its 1e-4 bound; the decode branch
    is ported (its parity is tests/test_torch_decode.py's) and steps an
    empty cache."""
    jm, tm, frozen, _ = pair
    p = jax.tree.map(lambda l: l[0], frozen["layers"])
    x = torch.zeros((1, 4, tm.cfg.d_model))
    xr = torch.randn((2, 40, tm.cfg.d_model),
                     generator=torch.Generator().manual_seed(4)) * 0.5
    got, gc = ssm.mamba_block(_to_port(p), xr, tm.cfg.replace(calibrate=True))
    want, wc = ssm.mamba_block(_to_port(p), xr, tm.cfg)
    for g, w in ((got, want), (gc["h"], wc["h"])):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    rs = np.random.RandomState(3)
    xh = (rs.randn(2, 6, tm.cfg.d_model) * 0.5).astype(np.float32)
    h0 = (rs.randn(2, tm.cfg.d_inner, tm.cfg.ssm_state) * 0.5).astype(
        np.float32)
    want, jc = jax.jit(lambda p_, x_, h_: jssm.mamba_block(
        p_, x_, jm.cfg, h0=h_))(p, jnp.asarray(xh), jnp.asarray(h0))
    got, gc = ssm.mamba_block(_to_port(p), torch.from_numpy(xh), tm.cfg,
                              h0=torch.from_numpy(h0))
    for g, w in ((got, want), (gc["h"], jc["h"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())
    cache = ssm.mamba_cache_init(tm.cfg, 1, torch.float32, "cpu")
    y, new = ssm.mamba_decode(_to_port(p), x[:, :1], cache, tm.cfg)
    assert y.shape == (1, 1, tm.cfg.d_model)
    assert new["h"].shape == (1, tm.cfg.d_inner, tm.cfg.ssm_state)
    assert new["conv"].shape == (1, tm.cfg.ssm_conv - 1, tm.cfg.d_inner)


# -- the model ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_grad_fn(jm):
    return jax.jit(jax.value_and_grad(
        lambda t, f, b: jm.loss_fn(f, t, b), has_aux=True))


def _batch(seed=0, B=2, S=16):
    toks = train.synthetic_token_stream(np.random.RandomState(seed), 256, 1,
                                        docs_per_client=B, seq=S)[0]
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]),
          "mask": jnp.ones(toks[:, 1:].shape, jnp.float32)}
    return jb, train.make_batch(toks, "cpu")


def _assert_tree_close(got_tree, want_tree, rel, what):
    got = dict(tree_lib.flatten_with_path(got_tree))
    want = dict(tree_lib.flatten_with_path(
        convert.tree_to_numpy(_to_port(want_tree))))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        np.testing.assert_allclose(
            got[path].detach().to(torch.float32).numpy(), w,
            atol=rel * max(1e-6, float(np.abs(w).max())),
            err_msg=f"{what} {path}")


def test_converted_ssm_tree_keeps_stacked_qtensors(pair):
    _, _, frozen, tr = pair
    layers = _to_port(frozen)["layers"]
    for name in ("in_proj_x", "in_proj_z", "x_proj", "dt_proj", "out_proj"):
        j, t = frozen["layers"][name], layers[name]
        assert isinstance(t, qlib.QTensor) and t.q.ndim == 4, name
        assert (t.bits, t.mode, t.block, t.orig_shape) == \
            (j.bits, j.mode, j.block, tuple(j.orig_shape)), name
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    for name in ("conv_w", "dt_bias", "a_log", "d_skip", "ln1"):
        assert isinstance(layers[name], torch.Tensor), name
    assert sorted(_to_port(tr)["lora"]) == ["in_proj_x", "out_proj"]


def test_per_layer_nf4_init_equals_quantize_tree_on_the_stack():
    cfg = get_reduced("falcon-mamba-7b").replace(**NF4)
    init = lambda c: build_model(c).init_params(
        torch.Generator().manual_seed(3), device="cpu")["frozen"]["layers"]
    quant, dense = init(cfg), init(cfg.replace(quant_bits=0))
    want = qlib.quantize_tree(dense, bits=4, block=64, mode="nf4")
    assert sorted(quant) == sorted(want)
    n_quantized = 0
    for name, w in want.items():
        g = quant[name]
        if isinstance(w, qlib.QTensor):
            n_quantized += 1
            assert (g.bits, g.mode, g.block, g.out_dtype, g.orig_shape) == \
                (w.bits, w.mode, w.block, w.out_dtype, w.orig_shape), name
            assert torch.equal(g.q, w.q) and torch.equal(g.scales, w.scales)
        else:
            assert torch.equal(g, w), name
    assert n_quantized == 5      # in_proj_x/z, x_proj, dt_proj, out_proj


def test_logits_loss_and_grads_match_jax(pair):
    jm, tm, frozen, tr = pair
    jb, tb = _batch()
    jlogits, _ = jax.jit(jm.forward)(frozen, tr, jb)
    (jloss, _), jgrads = _jax_grad_fn(jm)(tr, frozen, jb)
    tf, ttr = _to_port(frozen), _to_port(tr)
    with torch.no_grad():
        logits, _ = tm.forward(tf, ttr, tb)
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    ops.reset_kernel_traces()
    (loss, _), grads = tm.grads(tf, ttr, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_tree_close(grads, jgrads, 1e-4, "grad")
    # each layer's scan: forward, remat recompute, backward
    assert ops.KERNEL_TRACES["selective_scan_ref"] == 4
    assert ops.KERNEL_TRACES["selective_scan_bwd_ref"] == 2


def test_one_adam_step_matches_jax_and_remat_changes_nothing(pair):
    """Adam on the same grads equals the JAX update; a port train_step
    gives the same params with remat on or off (the JAX package does not
    rematerialize SSM layers on one device) and the JAX loss and grad
    norm."""
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

    tf = _to_port(frozen)
    out = {}
    for remat in (True, False):
        m = build_model(dataclasses.replace(tm.cfg, remat=remat))
        out[remat] = m.train_step(tf, ttr, optim.adam_init(ttr), tb, lr=1e-3)
    (tr_a, _, m_a), (tr_b, _, m_b) = out[True], out[False]
    for a, b in zip(tree_lib.leaves(tr_a), tree_lib.leaves(tr_b)):
        assert torch.equal(a, b)
    assert torch.equal(m_a["grad_norm"], m_b["grad_norm"])
    np.testing.assert_allclose(float(m_a["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m_a["grad_norm"]),
                               float(joptim.global_norm(jgrads)), rtol=1e-4)


def test_main_trains_falcon_mamba_on_the_cpu(capsys):
    tr = train.main(["--arch", "falcon-mamba-7b", "--rounds", "2",
                     "--clients", "2", "--local-steps", "1", "--seq", "16"],
                    device="cpu")
    out = capsys.readouterr().out
    assert "arch=falcon-mamba-reduced family=ssm" in out
    assert "round 0:" in out and "round 1:" in out
    assert sorted(tr["lora"]) == ["in_proj_x", "out_proj"]
    assert all(torch.isfinite(leaf).all() for leaf in tree_lib.leaves(tr))
