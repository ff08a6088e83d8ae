"""The port's encoder-decoder family (the encoder, cross-attention, the
learned positions without RoPE and the ``"ckv"`` cache entry of
repro_torch.models) against the JAX package, on the CPU, at reduced
Whisper-medium (2 encoder and 2 decoder layers over 32 frames).

Weights come from the JAX ``init_params(PRNGKey(0))`` through
``repro_torch.convert``, the trainables perturbed with seeded numpy
noise. Tolerances, fp32: cross-attention and its decode against the
encoder's fixed K/V within 1e-5 of the largest output; the model's
logits, grads (leaf by leaf), prefill and decode logits and caches
within 1e-4 of the largest magnitude, as tests/test_torch_configs.py
holds the dense decoders; the loss within 1e-5; Adam on the same grads
within 1e-6; the serve-consistency property within 5e-3; the NF4
backbone (the encoder's stack included) bitwise. The trainer's CLI
builds a text-only batch in both packages, so for this family both
fail for want of frames."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_zoo import NF4, Case, check_nf4_backbone, jax_trainer_main, rel, \
    to_port
from repro.models import layers as jlayers
from repro_torch.core import quant as qlib
from repro_torch.launch import train
from repro_torch.models import layers
from repro_torch.models.model import _layer_slice

torch.set_num_threads(1)
ARCH = "whisper-medium"


@functools.lru_cache(maxsize=None)
def _case(name):
    return Case(ARCH, **(NF4 if name == "nf4" else {}))


def test_cross_attention_and_its_decode_match_jax():
    c = _case("fp32")
    cfg = c.jcfg
    p = jax.tree.map(lambda l: l[0], c.frozen["layers"])
    lo = jax.tree.map(lambda l: l[0], c.tr["lora"])
    tp, tlo = _layer_slice(c.tf["layers"], 0), to_port(lo)
    rs = np.random.RandomState(8)
    x = rs.randn(2, 5, cfg.d_model).astype(np.float32)
    enc = rs.randn(2, cfg.n_frames, cfg.d_model).astype(np.float32)
    pos = jnp.arange(5)
    want, (jk, jv) = jax.jit(lambda p_, x_, e_, l_: jlayers.attention(
        p_, x_, pos, cfg, lora=l_, prefix="c", causal=False, kv_x=e_,
        use_rope=False))(p, jnp.asarray(x), jnp.asarray(enc), lo)
    got, (k, v) = layers.attention(
        tp, torch.from_numpy(x), torch.arange(5), c.cfg, lora=tlo,
        prefix="c", causal=False, kv_x=torch.from_numpy(enc), use_rope=False)
    assert got.shape == (2, 5, cfg.d_model) and k.shape[1] == cfg.n_frames
    assert rel(got.numpy(), want) <= 1e-5
    assert rel(k.numpy(), jk) <= 1e-5 and rel(v.numpy(), jv) <= 1e-5
    # one token against the fixed encoder K/V: the cache is only read
    cache = {"k": k, "v": v, "slot_pos": torch.arange(cfg.n_frames,
                                                      dtype=torch.int32)}
    before = {n: t.clone() for n, t in cache.items()}
    y, _ = layers.attention_decode(
        tp, torch.from_numpy(x[:, 4:]), torch.tensor(4, dtype=torch.int32),
        cache, c.cfg, lora=tlo, prefix="c", use_rope=False,
        update_cache=False)
    assert all(torch.equal(cache[n], before[n]) for n in cache)
    assert rel(y.numpy(), got[:, 4:].numpy()) <= 1e-5
    jy, _ = jax.jit(lambda p_, x_, c_, l_: jlayers.attention_decode(
        p_, x_, jnp.asarray(4, jnp.int32), c_, cfg, lora=l_, prefix="c",
        use_rope=False, update_cache=False))(
            p, jnp.asarray(x[:, 4:]),
            {"k": jk, "v": jv, "slot_pos": jnp.arange(cfg.n_frames,
                                                      dtype=jnp.int32)}, lo)
    assert rel(y.numpy(), jy) <= 1e-5


def test_forward_loss_grads_and_step_match_jax():
    """On the NF4 backbone (the encoder's MLP without LoRA included)."""
    grads = _case("nf4").check_train()
    assert sorted(grads["enc_lora"]) == ["wk", "wo", "wq", "wv"]
    assert {"cwq", "cwk", "cwv", "cwo", "wu", "wd"} <= set(grads["lora"])


def test_prefill_and_decode_match_jax():
    cache = _case("fp32").check_decode()
    ckv = cache["scan"]["ckv"]
    assert ckv["k"].shape[2] == _case("fp32").cfg.n_frames
    np.testing.assert_array_equal(ckv["slot_pos"][0].numpy(),
                                  np.arange(_case("fp32").cfg.n_frames))


def test_serve_consistency():
    _case("fp32").check_serve_consistency()


def test_nf4_backbone_is_bitwise_quantize_tree():
    frozen = check_nf4_backbone(ARCH)
    assert isinstance(frozen["enc_layers"]["wu"], qlib.QTensor)
    assert not isinstance(frozen["pos_embed"], qlib.QTensor)


def test_trainer_cli_fails_for_want_of_frames_in_both_packages(monkeypatch):
    argv = ["--arch", ARCH, "--rounds", "1", "--clients", "1",
            "--local-steps", "1", "--seq", "16"]
    with pytest.raises(KeyError, match="frames"):
        jax_trainer_main(argv, monkeypatch)
    with pytest.raises(KeyError, match="frames"):
        train.main(argv, device="cpu")
