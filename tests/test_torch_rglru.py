"""The port's RG-LRU hybrid (repro_torch.models.rglru,
``models.ssm.chunked_linear_scan`` and the hybrid family of
repro_torch.models) against the JAX package, on the CPU, at reduced
RecurrentGemma-2B (3 layers: RG-LRU, RG-LRU, local attention with a
window of 64).

Weights come from the JAX ``init_params(PRNGKey(0))`` through
``repro_torch.convert``, the trainables perturbed with seeded numpy
noise. Tolerances, all fp32: ``chunked_linear_scan`` within 1e-5 of the
largest state (the doubling scan sums in another order than
``lax.associative_scan``); ``rglru_block`` and ``rglru_decode`` on NF4
weights within 1e-5 of their largest output; the model's logits, grads
(leaf by leaf), prefill and decode logits and caches within 1e-4 of the
largest magnitude, as tests/test_torch_configs.py holds the dense
decoders; the loss and the balance aux within 1e-5; Adam on the same
grads within 1e-6; the serve-consistency property within 5e-3; the NF4
backbone bitwise."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_zoo import (NF4, Case, check_client_update, check_nf4_backbone,
                      rel, to_port)
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.core import quant as qlib
from repro_torch.models import rglru, ssm
from repro_torch.models.model import _layer_slice

torch.set_num_threads(1)
ARCH = "recurrentgemma-2b"


@functools.lru_cache(maxsize=None)
def _case(name):
    return Case(ARCH, **(NF4 if name == "nf4" else {}))


@pytest.mark.parametrize("B,S,W,chunk", [(2, 64, 32, 16), (1, 50, 8, 16),
                                         (2, 7, 16, 32), (3, 33, 4, 1)])
def test_chunked_linear_scan_matches_jax(B, S, W, chunk):
    rs = np.random.RandomState(B * S + W)
    a = rs.uniform(0.5, 1.0, (B, S, W)).astype(np.float32)
    b = rs.randn(B, S, W).astype(np.float32)
    h0 = rs.randn(B, W).astype(np.float32)
    want_all, want_last = jssm.chunked_linear_scan(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk)
    got_all, got_last = ssm.chunked_linear_scan(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0), chunk)
    assert got_all.shape == (B, S, W) and got_last.shape == (B, W)
    assert rel(got_all.numpy(), want_all) <= 1e-5
    assert rel(got_last.numpy(), want_last) <= 1e-5
    # the plain loop
    h, loop = torch.from_numpy(h0), []
    for t in range(S):
        h = torch.from_numpy(a[:, t]) * h + torch.from_numpy(b[:, t])
        loop.append(h)
    assert rel(got_all.numpy(), torch.stack(loop, 1).numpy()) <= 1e-5


def test_rglru_block_and_decode_match_jax_on_nf4_weights():
    c = _case("nf4")
    cfg = c.jcfg
    p = jax.tree.map(lambda l: l[0], c.frozen["layers"])
    lo = {k: jax.tree.map(lambda l: l[0], v)
          for k, v in c.tr["lora"].items() if k in ("wx", "wy", "out_proj")}
    tp = _layer_slice(c.tf["layers"], 0)
    assert isinstance(tp["wx"], qlib.QTensor) and tp["wx"].q.ndim == 3
    tlo = to_port(lo)
    x = np.random.RandomState(7).randn(2, 9, cfg.d_model).astype(np.float32)
    want, jcache = jax.jit(lambda p_, x_, l_: jrglru.rglru_block(
        p_, x_, cfg, lora=l_))(p, jnp.asarray(x[:, :8]), lo)
    got, cache = rglru.rglru_block(tp, torch.from_numpy(x[:, :8]), c.cfg,
                                   lora=tlo)
    assert rel(got.numpy(), want) <= 1e-5
    for k in ("h", "conv"):
        assert rel(cache[k].numpy(), jcache[k]) <= 1e-5, k
    jy, jnew = jax.jit(lambda p_, x_, c_, l_: jrglru.rglru_decode(
        p_, x_, c_, cfg, lora=l_))(p, jnp.asarray(x[:, 8:]), jcache, lo)
    y, new = rglru.rglru_decode(tp, torch.from_numpy(x[:, 8:]), cache, c.cfg,
                                lora=tlo)
    assert rel(y.numpy(), jy) <= 1e-5
    for k in ("h", "conv"):
        assert rel(new[k].numpy(), jnew[k]) <= 1e-5, k
    # the decode steps the block's state: the 9-token block's last output
    full, _ = rglru.rglru_block(tp, torch.from_numpy(x), c.cfg, lora=tlo)
    assert rel(y.numpy(), full[:, 8:].numpy()) <= 1e-5


def test_forward_loss_grads_and_step_match_jax():
    """On the NF4 backbone (the RG-LRU block's projections, the MLP
    without LoRA and the attention decoded from the same codes)."""
    grads = _case("nf4").check_train()
    # the hybrid trains attention and RG-LRU LoRA, no MLP LoRA
    assert sorted(grads["lora"]) == ["out_proj", "wk", "wo", "wq", "wv",
                                     "wx", "wy"]


def test_prefill_and_decode_match_jax():
    cache = _case("fp32").check_decode()
    # every layer carries both entries: the dummies stay empty
    kinds = _case("fp32").cfg.layer_kinds()
    for i, kind in enumerate(kinds):
        if kind == "attn":
            assert not cache["scan"]["lru"]["h"][i].any()
        else:
            assert (cache["scan"]["kv"]["slot_pos"][i] == -1).all()


def test_serve_consistency():
    _case("fp32").check_serve_consistency()


def test_nf4_backbone_is_bitwise_quantize_tree():
    frozen = check_nf4_backbone(ARCH)
    # the block-diagonal gates stay dense (QLoRA's skip list), the
    # projections are stacked QTensors
    assert not isinstance(frozen["layers"]["w_rg"], qlib.QTensor)
    assert isinstance(frozen["layers"]["out_proj"], qlib.QTensor)


def test_trainer_runs_the_hybrid():
    check_client_update(_case("nf4"))


def test_calibrate_still_refuses_naming_item_8_5():
    """The dry run's calibrated scan (it raised until the dry run's
    slice, item 8.6, ported it): one chunk of the whole sequence gives
    the chunked block's output and state within 1e-5 of the largest, on
    a sequence of 80 > scan_chunk steps."""
    c = _case("fp32")
    tp = _layer_slice(c.tf["layers"], 0)
    x = torch.randn((2, 80, c.cfg.d_model),
                    generator=torch.Generator().manual_seed(2)) * 0.5
    y, st = rglru.rglru_block(tp, x, c.cfg.replace(calibrate=True))
    y0, st0 = rglru.rglru_block(tp, x, c.cfg)
    assert c.cfg.scan_chunk < 80
    for g, w in ((y, y0), (st["h"], st0["h"]), (st["conv"], st0["conv"])):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
