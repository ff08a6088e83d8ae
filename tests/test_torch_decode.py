"""The port's serving path (``kernels.ops.decode_attention`` and its
partial form, ``models.layers``' ring KV cache, ``core.adapter.prefill``
/ ``decode``, ``Model.prefill`` / ``decode_step`` / ``init_cache``,
``models.ssm.mamba_decode``) and ``grad_accum`` against the JAX package,
on the CPU, at the reduced configs.

Weights come from the JAX ``init_params(PRNGKey(0))`` through
``repro_torch.convert``, the trainables perturbed with seeded numpy
noise so that the zero-init LoRA B and adapter wo/w2 carry signal;
tokens are numpy from a seed and the same tokens are fed to both
packages at every step. Held: ``decode_attention``, its partials and
their log-sum-exp combine within 1e-5 in fp32; ``ring_from_full``'s
slot positions and rows bitwise; ``quant_kv`` bitwise against the JAX
quantizer run eagerly (under ``jax.jit`` XLA multiplies by 1/127);
the adapter's prefill and decode within 1e-5; the dense models' logits
within 1e-5 of the largest logit and their caches leaf for leaf (the
int8 codes bitwise) over a prefill and four decode steps; Falcon-Mamba
within 1e-4 of the largest magnitude, the ref-vs-chunked-scan bound of
tests/test_torch_ssm.py (the JAX package prefills with its chunked scan
on the CPU). With an int8 KV cache the prefill's logits hold at 1e-5,
but a one-ulp difference in a K/V element before quantization moves its
int8 code by one step where it lies on a rounding boundary, so the
decode logits are held to 2e-3 and the codes to one step at under 0.1%
of the entries. The JAX package's own serve contracts
(``test_serve_consistency``, ``test_serving_pipeline_deterministic``,
the int8-KV and ``grad_accum`` tests of ``test_perf_features.py``) are
restated on the port, each beside the JAX package's numbers."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_reduced
from repro.core import adapter as jadapter
from repro.core import optim as joptim
from repro.kernels import ref as jref
from repro.models import build_model as j_build
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced
from repro_torch.core import adapter, optim
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.models import layers

torch.set_num_threads(2)
NF4 = dict(quant_bits=4, quant_mode="nf4", quant_block=64)
P, STEPS = 20, 4          # prompt length and decode steps of the model tests


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, want):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(float(np.abs(w).max()), 1e-30))


def _slot_pos(B, M, seed, empty):
    """(B, M) positions with ``empty`` slots a row at -1 (at least one
    valid slot a row)."""
    rs = np.random.RandomState(seed)
    sp = rs.permutation(4 * M)[:M].astype(np.int32)[None].repeat(B, 0)
    for b in range(B):
        sp[b, rs.permutation(M)[:empty]] = -1
    return sp


# -- decode_attention -------------------------------------------------

@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("empty", [0, 5, 10])      # 10 of 11: one valid
def test_decode_attention_and_partials_match_jax(G, empty):
    B, M, Hkv, D = 2, 11, 2, 16
    q, k, v = _np(1, B, 1, G * Hkv, D), _np(2, B, M, Hkv, D), \
        _np(3, B, M, Hkv, D)
    sp = _slot_pos(B, M, 4, empty)
    want = jref.decode_attention(*map(jnp.asarray, (q, k, v, sp)))
    ops.reset_kernel_traces()
    got = ops.decode_attention(*map(_t, (q, k, v, sp)))
    assert ops.KERNEL_TRACES == {"decode_attention_plain": 1}
    assert got.shape == (B, 1, G * Hkv, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the partial form on three slices of the slots, combined
    cuts = [(0, 4), (4, 9), (9, M)]
    parts = []
    for lo, hi in cuts:
        args = (q, k[:, lo:hi], v[:, lo:hi], sp[:, lo:hi])
        jp = jref.decode_attention_partial(*map(jnp.asarray, args))
        tp = ref.decode_attention_partial(*map(_t, args))
        for g, w in zip(tp, jp):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)
        parts.append(tp)
    comb = ops.combine_decode_partials(parts)
    np.testing.assert_allclose(comb.numpy(), np.asarray(want), atol=1e-5)


def test_decode_attention_broadcasts_one_slot_row_and_keeps_bf16():
    q, k, v = _np(5, 3, 1, 4, 8), _np(6, 3, 7, 2, 8), _np(7, 3, 7, 2, 8)
    sp = _slot_pos(1, 7, 8, 3)
    want = jref.decode_attention(*map(jnp.asarray, (q, k, v, sp)))
    got = ops.decode_attention(*map(_t, (q, k, v, sp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got16 = ops.decode_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                                 _t(v).bfloat16(), _t(sp))
    assert got16.dtype == torch.bfloat16


# -- the ring KV cache -------------------------------------------------

@pytest.mark.parametrize("S,M", [(5, 9), (9, 9), (13, 4)])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_ring_from_full_matches_jax(S, M, kv_quant):
    k, v = _np(9, 2, S, 2, 8), _np(10, 2, S, 2, 8)
    want = jlayers.ring_from_full(jnp.asarray(k), jnp.asarray(v), M,
                                  kv_quant=kv_quant)
    got = layers.ring_from_full(_t(k), _t(v), M, kv_quant=kv_quant)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].dtype == convert._tensor(w, "cpu").dtype, name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 37.0])
def test_quant_kv_is_bitwise_the_eager_jax_quantizer(scale):
    x = _np(11, 3, 5, 4, 64) * scale
    x[0, 0, 0] = 0.0                        # an all-zero row: the 1e-12 floor
    wq, ws = jlayers.quant_kv(jnp.asarray(x), True)
    gq, gs = layers.quant_kv(_t(x), True)
    assert gq.dtype == torch.int8 and gs.shape == (3, 5, 4, 1)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(
        layers.dequant_kv(gq, gs, torch.float32).numpy(),
        np.asarray(jlayers.dequant_kv(wq, ws, jnp.float32)))
    same, none = layers.quant_kv(_t(x), False)
    assert none is None and torch.equal(same, _t(x))


# -- the adapter's serve path -------------------------------------------

@pytest.fixture(scope="module")
def adapter_params():
    rs = np.random.RandomState(12)
    p = jadapter.init(jax.random.PRNGKey(3), 64, n_heads=4)
    return jax.tree.map(
        lambda l: l + jnp.asarray(rs.randn(*l.shape) * 0.1, l.dtype), p)


@pytest.mark.parametrize("S,window", [(9, 16), (9, 9), (12, 5)])
def test_adapter_prefill_and_decode_match_jax(adapter_params, S, window):
    x = _np(13, 2, S + 3, 64)
    tp = convert.tree_from_numpy(adapter_params, "cpu")
    wy, wc = jadapter.prefill(adapter_params, jnp.asarray(x[:, :S]), window,
                              n_heads=4)
    gy, gc = adapter.prefill(tp, _t(x[:, :S]), window, n_heads=4)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-5)
    for i in range(3):
        pos = S + i
        wy, wc = jadapter.decode(adapter_params, jnp.asarray(x[:, pos:pos + 1]),
                                 wc, jnp.asarray(pos, jnp.int32), n_heads=4)
        gy, gc2 = adapter.decode(tp, _t(x[:, pos:pos + 1]), gc,
                                 torch.tensor(pos, dtype=torch.int32),
                                 n_heads=4)
        assert gc2 is gc                     # updated in place
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-5)
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(gc[name].numpy(), np.asarray(wc[name]),
                                   atol=1e-5, err_msg=name)


# -- the models ---------------------------------------------------------

CASES = {
    "yi": ("yi-9b", {}),
    "yi_kv8": ("yi-9b", dict(kv_quant_bits=8)),
    "danube": ("h2o-danube-3-4b", {}),
    "danube_kv8": ("h2o-danube-3-4b", dict(kv_quant_bits=8)),
    "mamba": ("falcon-mamba-7b", {}),
    "mamba_nf4": ("falcon-mamba-7b", NF4),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX model, port model, JAX frozen, JAX trainables, JAX prefill and
    decode jitted once)."""
    arch, kw = CASES[name]
    jm = j_build(j_reduced(arch).replace(**kw))
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    tr = jax.tree.map(lambda l: l + jnp.asarray(
        rs.randn(*l.shape) * 0.05, l.dtype), params["trainable"])
    pre = jax.jit(jm.prefill, static_argnames=("max_len",))
    return (jm, build_model(get_reduced(arch).replace(**kw)),
            params["frozen"], tr, pre, jax.jit(jm.decode_step))


def _tokens(seed, B, S, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


def _run_both(name, B=2, max_len=None, steps=STEPS, seed=3):
    """The prompt, then ``steps`` teacher-forced decode steps in both
    packages; returns the per-step logits and the final caches."""
    jm, tm, jf, jt, jpre, jdec = _case(name)
    toks = _tokens(seed, B, P + steps)
    max_len = max_len or P + steps
    tf, tt = convert.tree_from_numpy(jf, "cpu"), convert.tree_from_numpy(
        jt, "cpu")
    jl, jc = jpre(jf, jt, {"tokens": jnp.asarray(toks[:, :P])},
                  max_len=max_len)
    tl, tc = tm.prefill(tf, tt, {"tokens": _t(toks[:, :P])}, max_len=max_len)
    out = [(tl, jl)]
    for i in range(steps):
        step = toks[:, P + i:P + i + 1]
        jl, jc = jdec(jf, jt, jc, jnp.asarray(step),
                      jnp.asarray(P + i, jnp.int32))
        tl, tc2 = tm.decode_step(tf, tt, tc, _t(step),
                                 torch.tensor(P + i, dtype=torch.int32))
        assert tc2 is tc
        out.append((tl, jl))
    return out, tc, jc


def _assert_cache(got, want, *, codes_step=False, atol_rel=1e-5):
    want = dict(tree_lib.flatten_with_path(convert.tree_to_numpy(
        convert.tree_from_numpy(want, "cpu"))))
    got = dict(tree_lib.flatten_with_path(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
        elif g.dtype == torch.int8:
            d = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
            if codes_step:
                assert d.max() <= 1 and (d > 0).mean() < 1e-3, path
            else:
                assert d.max() == 0, path
        else:
            assert _rel(g.float().numpy(), w) <= atol_rel, path


@pytest.mark.parametrize("name", ["yi", "danube"])
def test_dense_prefill_and_decode_match_jax(name):
    # danube's window of 64 is cut to 16 slots: max_len < P + STEPS wraps
    max_len = 16 if name == "danube" else None
    out, tc, jc = _run_both(name, max_len=max_len)
    for i, (g, w) in enumerate(out):
        assert g.shape == (2, 256) and g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= 1e-5, (i, _rel(g.numpy(), w))
    _assert_cache(tc, jc)
    if name == "danube":
        assert tc["scan"]["kv"]["k"].shape[2] == 16


def test_int8_kv_decode_matches_jax_within_a_code_step():
    out, tc, jc = _run_both("danube_kv8", max_len=16)
    assert _rel(out[0][0].numpy(), out[0][1]) <= 1e-5     # prefill
    for g, w in out[1:]:
        assert _rel(g.numpy(), w) <= 2e-3
    _assert_cache(tc, jc, codes_step=True, atol_rel=2e-3)


@pytest.mark.parametrize("name", ["mamba", "mamba_nf4"])
def test_ssm_prefill_and_mamba_decode_match_jax(name):
    out, tc, jc = _run_both(name)
    for i, (g, w) in enumerate(out):
        assert _rel(g.numpy(), w) <= 1e-4, i
    _assert_cache(tc, jc, atol_rel=1e-4)
    assert tc["scan"]["ssm"]["h"].dtype == torch.float32


@pytest.mark.parametrize("name", ["yi", "danube_kv8", "mamba"])
def test_init_cache_matches_jax(name):
    jm, tm, *_ = _case(name)
    _assert_cache(tm.init_cache(3, 40, device="cpu"), jm.init_cache(3, 40))


def test_mamba_decode_steps_the_block_state():
    """``mamba_decode`` from ``mamba_block``'s cache gives the block's
    output at the next position (and the JAX decode's)."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm
    jm, tm, jf, jt, *_ = _case("mamba")
    cfg = jm.cfg
    p = jax.tree.map(lambda l: l[0], jf["layers"])
    lo = jax.tree.map(lambda l: l[0], jt["lora"])
    x = _np(14, 2, 7, cfg.d_model)
    tp, tlo = convert.tree_from_numpy(p, "cpu"), convert.tree_from_numpy(
        lo, "cpu")
    full, _ = ssm.mamba_block(tp, _t(x), tm.cfg, lora=tlo)
    _, cache = ssm.mamba_block(tp, _t(x[:, :6]), tm.cfg, lora=tlo)
    got, new = ssm.mamba_decode(tp, _t(x[:, 6:]), cache, tm.cfg, lora=tlo)
    assert _rel(got.numpy(), full[:, 6:].numpy()) <= 1e-5
    _, jcache = jax.jit(lambda p_, x_, lo_: jssm.mamba_block(
        p_, x_, cfg, lora=lo_))(p, jnp.asarray(x[:, :6]), lo)
    want, jnew = jax.jit(lambda p_, x_, c_, lo_: jssm.mamba_decode(
        p_, x_, c_, cfg, lora=lo_))(p, jnp.asarray(x[:, 6:]), jcache, lo)
    assert _rel(got.numpy(), want) <= 1e-4
    for k in ("h", "conv"):
        assert _rel(new[k].numpy(), jnew[k]) <= 1e-4, k


# -- the JAX package's serve contracts, restated -------------------------

@pytest.mark.parametrize("name", ["yi", "danube", "mamba"])
def test_serve_consistency(name):
    """tests/test_models_smoke.py::test_serve_consistency: prefill(S-1)
    + decode(last) equals the training forward's last logits (< 5e-3),
    and both are the JAX package's within 1e-5 (1e-4 for the SSM)."""
    jm, tm, jf, jt, jpre, jdec = _case(name)
    S = 33
    toks = _tokens(5, 2, S)
    tf, tt = convert.tree_from_numpy(jf, "cpu"), convert.tree_from_numpy(
        jt, "cpu")
    with torch.no_grad():
        want, _ = tm.forward(tf, tt, {"tokens": _t(toks)})
    _, cache = tm.prefill(tf, tt, {"tokens": _t(toks[:, :-1])}, max_len=S)
    got, _ = tm.decode_step(tf, tt, cache, _t(toks[:, -1:]),
                            torch.tensor(S - 1, dtype=torch.int32))
    assert _rel(got.numpy(), want[:, -1].numpy()) < 5e-3
    _, jc = jpre(jf, jt, {"tokens": jnp.asarray(toks[:, :-1])}, max_len=S)
    jl, _ = jdec(jf, jt, jc, jnp.asarray(toks[:, -1:]),
                 jnp.asarray(S - 1, jnp.int32))
    assert _rel(got.numpy(), jl) <= (1e-4 if name == "mamba" else 1e-5)


def test_serving_pipeline_deterministic():
    """tests/test_system.py::test_serving_pipeline_deterministic: greedy
    decode twice from the same prefill gives identical tokens, and they
    are the JAX package's."""
    jm, tm, jf, jt, jpre, jdec = _case("danube")
    toks = np.random.RandomState(0).randint(0, 256, (2, 16)).astype(np.int32)
    tf, tt = convert.tree_from_numpy(jf, "cpu"), convert.tree_from_numpy(
        jt, "cpu")

    def gen():
        logits, cache = tm.prefill(tf, tt, {"tokens": _t(toks)}, max_len=24)
        t = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out = [t]
        for i in range(4):
            logits, cache = tm.decode_step(
                tf, tt, cache, t, torch.tensor(16 + i, dtype=torch.int32))
            t = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(t)
        return torch.cat(out, 1).numpy()

    logits, cache = jpre(jf, jt, {"tokens": jnp.asarray(toks)}, max_len=24)
    t = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [t]
    for i in range(4):
        logits, cache = jdec(jf, jt, cache, t, jnp.asarray(16 + i, jnp.int32))
        t = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(t)
    a, b = gen(), gen()
    assert (a == b).all()
    np.testing.assert_array_equal(a, np.asarray(jnp.concatenate(want, 1)))


def test_int8_kv_cache_close_to_fp():
    """tests/test_perf_features.py::test_int8_kv_cache_close_to_fp on the
    port (int8 against fp KV under 5e-2), beside the JAX package's."""
    rel = {}
    for pkg in ("port", "jax"):
        got = {}
        for name in ("yi", "yi_kv8"):
            jm, tm, jf, jt, jpre, jdec = _case(name)
            toks = _tokens(6, 2, 17)
            if pkg == "jax":
                _, c = jpre(jf, jt, {"tokens": jnp.asarray(toks[:, :-1])},
                            max_len=17)
                out, _ = jdec(jf, jt, c, jnp.asarray(toks[:, -1:]),
                              jnp.asarray(16, jnp.int32))
                got[name] = np.asarray(out)
                continue
            tf, tt = convert.tree_from_numpy(jf, "cpu"), \
                convert.tree_from_numpy(jt, "cpu")
            _, c = tm.prefill(tf, tt, {"tokens": _t(toks[:, :-1])},
                              max_len=17)
            out, _ = tm.decode_step(tf, tt, c, _t(toks[:, -1:]),
                                    torch.tensor(16, dtype=torch.int32))
            got[name] = out.numpy()
        rel[pkg] = got
        assert _rel(got["yi_kv8"], got["yi"]) < 0.05
    assert _rel(rel["port"]["yi"], rel["jax"]["yi"]) <= 1e-5
    assert _rel(rel["port"]["yi_kv8"], rel["jax"]["yi_kv8"]) <= 2e-3


def test_int8_kv_cache_is_int8():
    """tests/test_perf_features.py::test_int8_kv_cache_is_int8: the
    cache's k is int8 with scales beside it, as in the JAX package."""
    jm, tm, jf, jt, jpre, _ = _case("danube_kv8")
    toks = _tokens(7, 2, 16)
    _, cache = tm.prefill(convert.tree_from_numpy(jf, "cpu"),
                          convert.tree_from_numpy(jt, "cpu"),
                          {"tokens": _t(toks)}, max_len=32)
    _, jc = jpre(jf, jt, {"tokens": jnp.asarray(toks)}, max_len=32)
    assert cache["scan"]["kv"]["k"].dtype == torch.int8
    assert jc["scan"]["kv"]["k"].dtype == jnp.int8
    assert sorted(cache["scan"]["kv"]) == sorted(jc["scan"]["kv"])
    assert "k_scale" in cache["scan"]["kv"]


def test_grad_accum_matches_single_shot():
    """tests/test_perf_features.py::test_grad_accum_matches_single_shot
    on the port (loss within 1e-3, trainables within 5e-3 of one shot),
    and the port's accumulated step against the JAX package's: loss and
    grad norm within 1e-5 relative, trainables after Adam within 1e-5
    (a tenth of lr: Adam turns a 1e-5 relative difference in a gradient
    that is fp32 noise into a move of up to lr on that element)."""
    jm, tm, jf, jt, *_ = _case("yi")
    toks = _tokens(8, 4, 17)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]),
          "mask": jnp.ones((4, 16), jnp.float32)}
    tb = {k: convert._tensor(np.asarray(v), "cpu") for k, v in jb.items()}
    tf, tt = convert.tree_from_numpy(jf, "cpu"), convert.tree_from_numpy(
        jt, "cpu")
    m4 = build_model(tm.cfg.replace(grad_accum=4))
    opt = optim.adam_init(tt)
    tr1, _, a = tm.train_step(tf, tt, opt, tb)
    tr4, _, b = m4.train_step(tf, tt, opt, tb)
    assert abs(float(a["loss"]) - float(b["loss"])) < 1e-3
    assert float(b["aux"]) == 0.0 and float(b["ce"]) == float(b["loss"])
    d = max(float((x - y).abs().max()) for x, y in zip(
        tree_lib.leaves(tr1), tree_lib.leaves(tr4)))
    assert d < 5e-3
    jm4 = j_build(jm.cfg.replace(grad_accum=4))
    jtr4, _, jb4 = jax.jit(jm4.train_step)(jf, jt, joptim.adam_init(jt), jb)
    for key in ("loss", "grad_norm"):
        assert abs(float(b[key]) - float(jb4[key])) <= 1e-5 * abs(
            float(jb4[key])), key
    want = dict(tree_lib.flatten_with_path(convert.tree_to_numpy(
        convert.tree_from_numpy(jtr4, "cpu"))))
    for path, leaf in tree_lib.flatten_with_path(tr4):
        np.testing.assert_allclose(leaf.numpy(), want[path], atol=1e-5,
                                   err_msg=str(path))
