"""The port's token-choice MoE (repro_torch.models.moe and the moe family
of repro_torch.models) against the JAX package, on the CPU, at reduced
Qwen3-MoE-235B-A22B (4 experts, top-2); reduced Kimi-K2's first dense
layer and shared expert are tests/test_torch_moe_kimi.py's.

The routes are held exactly: ``_route``'s expert ids (the stable top-k,
ties to the lower index as ``lax.top_k`` breaks them), ``_slot_assignment``'s
order, slots and drops, and the same copies dropped by ``_moe_local`` at
capacity factors 1.25 and 0.05; the gates and the balance aux within
1e-6, ``_moe_local``'s output within 1e-5 of its largest magnitude. The
models run on the JAX ``init_params(PRNGKey(0))`` through
``repro_torch.convert``, trainables perturbed: logits, grads (leaf by
leaf), prefill and decode logits and caches within 1e-4 of the largest
magnitude (fp32), loss and aux within 1e-5, Adam on the same grads
within 1e-6; the serve-consistency property within 5e-3 at a no-drop
capacity factor of 8, as the JAX package's test runs it (the decode
against the JAX package's is held by the prefill and decode test); the NF4
backbone's stacked expert payloads (L, E, G, B/2, N) bitwise."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_zoo import (NF4, Case, check_client_update, check_nf4_backbone,
                      rel, to_port)
from repro.configs import get_reduced as j_reduced
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced
from repro_torch.core import quant as qlib
from repro_torch.models import moe

torch.set_num_threads(1)
QWEN = "qwen3-moe-235b-a22b"


@functools.lru_cache(maxsize=None)
def _case(arch, name):
    return Case(arch, **(NF4 if name == "nf4" else {}))


def _experts(cf, seed=0, ties=False):
    jcfg = j_reduced(QWEN).replace(capacity_factor=cf)
    p = jmoe.init_experts(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if ties:  # two experts with the same router column: equal probs
        r = np.array(p["router"])
        r[:, 3] = r[:, 1]
        p = {**p, "router": jnp.asarray(r)}
    return jcfg, get_reduced(QWEN).replace(capacity_factor=cf), p


@pytest.mark.parametrize("ties", [False, True])
def test_route_and_slots_are_the_jax_routes(ties):
    jcfg, cfg, p = _experts(1.25, ties=ties)
    x = np.random.RandomState(1).randn(48, jcfg.d_model).astype(np.float32)
    jg, jids, jaux = jmoe._route(p["router"], jnp.asarray(x), jcfg)
    g, ids, aux = moe._route(torch.from_numpy(np.array(p["router"])),
                             torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if ties:   # expert 3 never outranks its twin 1
        assert ((ids == 1).any(1) | ~(ids == 3).any(1)).all()
    C = 5
    want = jmoe._slot_assignment(jids.reshape(-1), jcfg.n_experts, C)
    got = moe._slot_assignment(ids.reshape(-1), cfg.n_experts, C)
    for gv, wv in zip(got, want):
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert not got[3].all()          # some copies are dropped at C = 5


@pytest.mark.parametrize("cf", [1.25, 0.05, 8.0])
@pytest.mark.parametrize("dtype", ["fp32", "nf4"])
def test_moe_local_matches_jax(cf, dtype):
    jcfg, cfg, p = _experts(cf, seed=2)
    if dtype == "nf4":
        from repro.core import quant as jq
        p = {k: (v if k == "router" else jq.quantize(v, bits=4, block=64,
                                                     mode="nf4"))
             for k, v in p.items()}
    x = np.random.RandomState(3).randn(2, 24, jcfg.d_model).astype(
        np.float32)
    want, jaux = jmoe.moe_ffn(p, jnp.asarray(x), jcfg)
    got, aux = moe.moe_ffn(to_port(p), torch.from_numpy(x), cfg)
    assert rel(got.numpy(), want) <= 1e-5
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # the same copies are dropped: each token's output is zero in both
    # exactly where all its copies were dropped
    np.testing.assert_array_equal(
        (got.abs().sum(-1) == 0).numpy(),
        np.asarray(jnp.abs(want).sum(-1) == 0))


def test_moe_local_backward_reaches_the_tokens():
    """The gradient w.r.t. the tokens flows through the kept copies only
    (the experts are frozen): autograd of the port against ``jax.vjp``."""
    jcfg, cfg, p = _experts(1.25, seed=4)
    x = np.random.RandomState(5).randn(1, 16, jcfg.d_model).astype(
        np.float32)
    ct = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    want = jax.jit(lambda x_, c_: jax.vjp(
        lambda y: jmoe.moe_ffn(p, y, jcfg)[0], x_)[1](c_)[0])(
            jnp.asarray(x), jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    (moe.moe_ffn(to_port(p), xt, cfg)[0] * torch.from_numpy(ct)).sum() \
        .backward()
    assert rel(xt.grad.numpy(), want) <= 1e-5


def test_forward_loss_grads_and_step_match_jax():
    """On the NF4 backbone: the experts decoded from the same codes in
    both packages."""
    grads = _case(QWEN, "nf4").check_train()
    assert sorted(grads["lora"]) == ["wk", "wo", "wq", "wv"]


def test_prefill_and_decode_match_jax():
    _case(QWEN, "fp32").check_decode()


def test_serve_consistency():
    _case(QWEN, "fp32").check_serve_consistency(capacity_factor=8.0)


def test_nf4_backbone_is_bitwise_quantize_tree():
    frozen = check_nf4_backbone(QWEN)
    wg = frozen["layers"]["moe"]["wg"]
    cfg = get_reduced(QWEN)
    assert isinstance(wg, qlib.QTensor) and wg.q.shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model // 64, 32, cfg.d_ff)
    assert not isinstance(frozen["layers"]["moe"]["router"], qlib.QTensor)


def test_trainer_runs_the_moe():
    check_client_update(_case(QWEN, "nf4"))
