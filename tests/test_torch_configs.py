"""The port's config registry (repro_torch.configs) and its other dense
decoders against the JAX package, on the CPU.

Every config the port carries (the dense decoders and the Mamba-1
falcon-mamba-7b) equals the JAX package's field for field, reduced and
full; an arch of a family that is not ported raises
NotImplementedError naming the slice that brings it. The sliding-window
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
PORTED = DENSE + ("falcon-mamba-7b",)


@pytest.mark.parametrize("arch", PORTED)
def test_dense_configs_equal_the_jax_package(arch):
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_reduced, jconfigs.get_reduced)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    assert get(arch).q_dim == jget(arch).q_dim
    assert get(arch).layer_kinds() == jget(arch).layer_kinds()


@pytest.mark.parametrize("arch", sorted(set(jconfigs.ARCHS) - set(PORTED)))
def test_unported_families_raise_naming_their_slice(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        configs.get_config(arch)
    # the model refuses such a family too, given its config data
    cfg = configs.ModelConfig(**dataclasses.asdict(jconfigs.get_reduced(arch)))
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg)


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
