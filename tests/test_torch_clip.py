"""The port's model math (repro_torch.core.{clip, adapter, lora},
repro_torch.fl.client) against the JAX package on converted weights, at
the tiny default CLIPConfig (2 layers, width 64). Tolerance: 1e-5 on
features, 1e-4 absolute on logits (exp(logit_scale) ~ 14.3 amplifies
fp32 noise)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import adapter as jadapter
from repro.core import clip as jclip
from repro.core import lora as jlora
from repro.data import synthetic as jsynth
from repro.fl import client as jclient
from repro.fl.strategies import STRATEGIES as JSTRATEGIES
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import adapter as tadapter
from repro_torch.core import clip as tclip
from repro_torch.core import lora as tlora
from repro_torch.data import synthetic as tsynth
from repro_torch.fl import client as tclient
from repro_torch.fl.strategies import STRATEGIES

torch.set_num_threads(1)
CFG_J = jclip.CLIPConfig()
CFG_T = tclip.CLIPConfig()


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _perturb(tree, seed):
    """numpy tree + seeded noise on every leaf (wo, w2, LoRA b non-zero)."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda l: (np.asarray(l) + 0.1 * rs.randn(*np.shape(l)))
        .astype(np.float32), tree)


@pytest.fixture(scope="module")
def weights():
    frozen_j = jclip.init_clip(jax.random.PRNGKey(0), CFG_J)
    frozen_t = convert.tree_from_numpy(frozen_j, "cpu")
    tr_np = _perturb(jclient.init_trainable(
        jax.random.PRNGKey(1), CFG_J, JSTRATEGIES["qlora_nogan"]), 2)
    toks = jsynth.class_tokens(jsynth.SPECS["pacs"], np.arange(7))
    ce_j = jclip.text_embedding(frozen_j, CFG_J, jnp.asarray(toks))
    return {"frozen_j": frozen_j, "frozen_t": frozen_t, "tr_np": tr_np,
            "tr_j": jax.tree.map(jnp.asarray, tr_np),
            "tr_t": convert.tree_from_numpy(tr_np, "cpu"),
            "toks": toks, "ce_j": ce_j,
            "images": _np(3, 3, 32, 32, 3)}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _shapes(tree):
    return [(tree_lib.path_str(p), tuple(l.shape))
            for p, l in tree_lib.flatten_with_path(tree)]


def test_init_layouts_match_jax():
    fj = jclip.init_clip(jax.random.PRNGKey(0), CFG_J)
    ft = tclip.init_clip(torch.Generator().manual_seed(0), CFG_T,
                         device="cpu")
    assert _shapes(ft) == _shapes(convert.tree_from_numpy(fj, "cpu"))
    for arm in ("fedclip", "qlora_nogan"):
        tj = jclient.init_trainable(jax.random.PRNGKey(1), CFG_J,
                                    JSTRATEGIES[arm])
        tt = tclient.init_trainable(torch.Generator().manual_seed(1), CFG_T,
                                    STRATEGIES[arm], device="cpu")
        assert _shapes(tt) == _shapes(convert.tree_from_numpy(tj, "cpu"))
        # zero-init wo / w2 / LoRA b: training starts at the backbone
        assert not tt["adapter"]["wo"].any() and not tt["adapter"]["w2"].any()


@pytest.mark.parametrize("with_lora", [False, True])
def test_encode_image(weights, with_lora):
    lora_j = weights["tr_j"]["lora"] if with_lora else None
    lora_t = weights["tr_t"]["lora"] if with_lora else None
    want = jclip.encode_image(weights["frozen_j"], CFG_J,
                              jnp.asarray(weights["images"]), lora=lora_j)
    got = tclip.encode_image(weights["frozen_t"], CFG_T,
                             torch.from_numpy(weights["images"]),
                             lora=lora_t)
    _close(got, want, 1e-5)


def test_text_embedding(weights):
    got = tclip.text_embedding(weights["frozen_t"], CFG_T,
                               torch.from_numpy(weights["toks"]).long())
    _close(got, weights["ce_j"], 1e-5)


@pytest.mark.parametrize("S,causal", [(1, False), (5, True)])
def test_adapter_apply(weights, S, causal):
    x = _np(4, 2, S, 64)
    want = jadapter.apply(weights["tr_j"]["adapter"], jnp.asarray(x),
                          n_heads=4, causal=causal)
    got = tadapter.apply(weights["tr_t"]["adapter"], torch.from_numpy(x),
                         n_heads=4, causal=causal)
    _close(got, want, 1e-5)


def test_lora_linear_apply_merge(weights):
    x = _np(5, 3, 64)
    w = _np(6, 64, 64) / 8
    pair_np = {"a": _np(7, 64, 4), "b": _np(8, 4, 64)}
    pj = jax.tree.map(jnp.asarray, pair_np)
    pt = convert.tree_from_numpy(pair_np, "cpu")
    _close(tlora.linear(torch.from_numpy(x), torch.from_numpy(w), pt,
                        alpha=8.0, rank=4),
           jlora.linear(jnp.asarray(x), jnp.asarray(w), pj, alpha=8.0,
                        rank=4), 1e-5)
    _close(tlora.apply(torch.from_numpy(x), pt, alpha=8.0, rank=4),
           jlora.apply(jnp.asarray(x), pj, alpha=8.0, rank=4), 1e-5)
    _close(tlora.merge(torch.from_numpy(w), pt, alpha=8.0, rank=4),
           jlora.merge(jnp.asarray(w), pj, alpha=8.0, rank=4), 1e-5)


def test_head_and_forward_logits(weights):
    feat = _np(9, 3, 64)
    ce_t = torch.from_numpy(np.asarray(weights["ce_j"]))
    _close(tclient.head_logits(weights["frozen_t"], weights["tr_t"],
                               torch.from_numpy(feat), ce_t),
           jclient.head_logits(weights["frozen_j"], weights["tr_j"],
                               jnp.asarray(feat), weights["ce_j"]), 1e-4)
    _close(tclient.forward_logits(weights["frozen_t"], weights["tr_t"], CFG_T,
                                  torch.from_numpy(weights["images"]), ce_t),
           jclient.forward_logits(weights["frozen_j"], weights["tr_j"], CFG_J,
                                  jnp.asarray(weights["images"]),
                                  weights["ce_j"]), 1e-4)


def test_synthetic_data_is_bitwise_the_reference():
    a = tsynth.make_dataset("pacs", n_per_class=6, seed=3)
    b = jsynth.make_dataset("pacs", n_per_class=6, seed=3)
    for k in ("images", "labels", "domains", "tokens"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["spec"].n_classes == b["spec"].n_classes == 7
