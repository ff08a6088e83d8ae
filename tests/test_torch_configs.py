"""The port's config registry (repro_torch.configs) and its other dense
decoders against the JAX package, on the CPU.

Every config of the JAX package equals the port's field for field,
reduced and full, and ``ARCHS`` is the JAX package's. Each zoo family
(hybrid, moe with and without dense layers, encdec, vlm) builds the JAX
package's ``init_params`` tree at its reduced NF4 config: the same leaf
paths, shapes and dtypes, the same QTensor fields; the dry run's
``calibrate`` runs and gives the uncalibrated forward's logits. The
sliding-window
(h2o-danube-3-4b, window 64 under a 80-token sequence) and GELU
(starcoder2-15b) decoders give the JAX package's logits and loss on the
same weights, in fp32, within 1e-4 times the largest logit."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import build_model as j_build
from repro_torch import configs, convert
from repro_torch.models import build_model

torch.set_num_threads(1)
DENSE = ("yi-9b", "h2o-danube-3-4b", "codeqwen1.5-7b", "starcoder2-15b",
         "clip-b32")
ZOO = ("recurrentgemma-2b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
       "whisper-medium", "llava-next-34b")
PORTED = DENSE + ("falcon-mamba-7b",) + ZOO
NF4 = dict(quant_bits=4, quant_mode="nf4", quant_block=64)


@pytest.mark.parametrize("arch", PORTED)
def test_dense_configs_equal_the_jax_package(arch):
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_reduced, jconfigs.get_reduced)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    assert get(arch).q_dim == jget(arch).q_dim
    assert get(arch).layer_kinds() == jget(arch).layer_kinds()


def test_archs_are_the_jax_packages():
    assert configs.ARCHS == jconfigs.ARCHS


def _leaves(tree):
    from repro.core import quant as jq
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda l: isinstance(l, jq.QTensor))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", ZOO)
def test_unported_families_raise_naming_their_slice(arch):
    """The family's reduced NF4 ``init_params`` tree is the JAX
    package's leaf for leaf (paths, shapes, dtypes, QTensor fields), and
    the dry run's ``calibrate`` (ported since; it once raised naming its
    slice) gives the uncalibrated forward's logits within 1e-5 of the
    largest, on a sequence longer than the scans' chunk."""
    from repro.core import quant as jq
    from repro_torch import tree as tree_lib
    from repro_torch.core import quant as qlib
    jcfg = jconfigs.get_reduced(arch).replace(**NF4)
    want = _leaves(jax.eval_shape(j_build(jcfg).init_params,
                                  jax.random.PRNGKey(0)))
    model = build_model(configs.get_reduced(arch).replace(**NF4))
    got = dict(tree_lib.flatten_with_path(
        model.init_params(torch.Generator().manual_seed(0), device="cpu")))
    assert sorted(got) == sorted(want)
    dt = lambda d: str(d).replace("torch.", "")
    for path, w in want.items():
        g = got[path]
        if isinstance(w, jq.QTensor):
            assert isinstance(g, qlib.QTensor), path
            assert (g.bits, g.mode, g.block, tuple(g.orig_shape),
                    dt(g.out_dtype)) == (w.bits, w.mode, w.block,
                                         tuple(w.orig_shape),
                                         str(np.dtype(w.out_dtype))), path
            for f in ("q", "scales"):
                gt, wt = getattr(g, f), getattr(w, f)
                assert tuple(gt.shape) == wt.shape, (path, f)
                assert dt(gt.dtype) == str(wt.dtype), (path, f)
        else:
            assert tuple(g.shape) == w.shape, path
            assert dt(g.dtype) == str(w.dtype), path
    cfg = configs.get_reduced(arch)
    cal = build_model(cfg.replace(calibrate=True, unroll_layers=True))
    params = cal.init_params(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 40),
                                     generator=g, dtype=torch.int32)}
    if jcfg.family == "encdec":
        batch["frames"] = torch.randn((1, jcfg.n_frames, jcfg.d_model),
                                      generator=g) * 0.02
    with torch.no_grad():
        got, _ = cal.forward(params["frozen"], params["trainable"], batch)
        want, _ = build_model(cfg).forward(params["frozen"],
                                           params["trainable"], batch)
    assert float((got - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "starcoder2-15b"])
def test_window_and_gelu_decoders_match_jax(arch):
    jcfg = jconfigs.get_reduced(arch)
    jm = j_build(jcfg)
    params = jm.init_params(jax.random.PRNGKey(1))
    rs = np.random.RandomState(2)
    tr = jax.tree.map(lambda l: l + jnp.asarray(
        rs.randn(*l.shape) * 0.05, l.dtype), params["trainable"])
    toks = rs.randint(0, jcfg.vocab_size, (2, 81)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    jlogits, _ = jm.forward(params["frozen"], tr, jb)
    jloss, _ = jm.loss_fn(params["frozen"], tr, jb)
    tm = build_model(configs.get_reduced(arch))
    tf, ttr = (convert.tree_from_numpy(t, "cpu")
               for t in (params["frozen"], tr))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}
    with torch.no_grad():
        logits, _ = tm.forward(tf, ttr, tb)
        loss, _ = tm.loss_fn(tf, ttr, tb)
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
