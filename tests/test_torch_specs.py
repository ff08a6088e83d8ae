"""The port's spec helpers (``Model.param_specs``, ``cache_specs``,
``input_specs``, ``optim.adam_specs`` and the layer helpers under them)
against the JAX package's ``ShapeDtypeStruct`` trees: for every arch at
its full config, a dense and an NF4 backbone, the same paths, shapes,
dtypes and QTensor statics, leaf for leaf (the JAX side is shapes only,
nothing compiled). At the reduced configs the specs also equal the
shapes and dtypes of what ``init_params`` and ``init_cache`` build.
Also ``QTensor.shape``, ``optim.sgd_update`` and
``optim.cosine_schedule`` against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.core import optim as joptim
from repro.core.quant import QTensor as JQ
from repro.core.quant import quantize as jquantize
from repro.models import build_model as j_build
from repro_torch import tree as tree_lib
from repro_torch.configs import INPUT_SHAPES, get_config, get_reduced
from repro_torch.core import optim
from repro_torch.core import quant as qlib
from repro_torch.core.quant import QTensor
from repro_torch.models import build_model

NF4 = dict(quant_bits=4, quant_mode="nf4")


def _jflat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda l: isinstance(l, JQ))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name",
                                                              None)))
                  for k in path): leaf for path, leaf in flat}


def _jdesc(leaf):
    if isinstance(leaf, JQ):
        return ("Q", tuple(leaf.q.shape), str(leaf.q.dtype),
                tuple(leaf.scales.shape), leaf.bits, leaf.mode, leaf.block,
                str(jnp.dtype(leaf.out_dtype)), tuple(leaf.orig_shape))
    return tuple(leaf.shape), str(leaf.dtype)


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tdesc(leaf):
    if isinstance(leaf, QTensor):
        return ("Q", tuple(leaf.q.shape), _name(leaf.q.dtype),
                tuple(leaf.scales.shape), leaf.bits, leaf.mode, leaf.block,
                _name(leaf.out_dtype), tuple(leaf.orig_shape))
    return tuple(leaf.shape), _name(leaf.dtype)


def _same(got_tree, want_tree, what):
    got = {tuple(p): _tdesc(l)
           for p, l in tree_lib.flatten_with_path(got_tree)}
    want = {p: _jdesc(l) for p, l in _jflat(want_tree).items()}
    assert sorted(got) == sorted(want), (what, set(got) ^ set(want))
    for path, w in want.items():
        assert got[path] == w, (what, path, got[path], w)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch, quant):
    jcfg, cfg = j_config(arch), get_config(arch)
    if quant:
        jcfg, cfg = jcfg.replace(**NF4), cfg.replace(**NF4)
    jm, tm = j_build(jcfg), build_model(cfg)
    jp, tp = jm.param_specs(), tm.param_specs()
    _same(tp, jp, "param_specs")
    # every spec is shape only
    for leaf in tree_lib.leaves(tp):
        for t in ((leaf.q, leaf.scales) if isinstance(leaf, QTensor)
                  else (leaf,)):
            assert t.device.type == "meta"
    dec = J_SHAPES["decode_32k"]
    B, S = dec.global_batch, dec.seq_len
    _same(tm.cache_specs(B, S), jm.cache_specs(B, S), "cache_specs")
    for name, shape in J_SHAPES.items():
        _same(tm.input_specs(INPUT_SHAPES[name]), jm.input_specs(shape),
              f"input_specs {name}")
    _same(optim.adam_specs(tp["trainable"])._asdict(),
          joptim.adam_specs(jp["trainable"])._asdict(), "adam_specs")


def _shape_desc(tree):
    return {tuple(p): _tdesc(l)
            for p, l in tree_lib.flatten_with_path(tree)}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_init_shapes(arch, quant):
    cfg = get_reduced(arch)
    if quant:
        cfg = cfg.replace(**NF4, quant_block=64)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    assert _shape_desc(model.param_specs()) == _shape_desc(params)
    assert _shape_desc(optim.adam_specs(model.param_specs()["trainable"])) \
        == _shape_desc(optim.adam_init(params["trainable"]))
    for batch, ctx in ((2, 24), (3, 7)):
        assert _shape_desc(model.cache_specs(batch, ctx)) == \
            _shape_desc(model.init_cache(batch, ctx, device="cpu"))


def test_qtensor_shape_sgd_and_cosine_schedule_equal_jax():
    """``QTensor.shape``/``ndim`` are the logical shape's, as the JAX
    QTensor's; ``optim.sgd_update`` and ``optim.cosine_schedule`` (host
    ints and device tensors) equal the JAX package's."""
    w = np.random.RandomState(0).randn(3, 128, 24).astype(np.float32)
    qt = qlib.quantize(torch.from_numpy(w), bits=4, block=64, mode="nf4")
    jqt = jquantize(jnp.asarray(w), bits=4, block=64, mode="nf4")
    assert qt.shape == tuple(jqt.shape) == (3, 128, 24)
    assert qt.ndim == jqt.ndim == 3
    rs = np.random.RandomState(1)
    p = {"a": rs.randn(5, 3).astype(np.float32),
         "b": rs.randn(4).astype(np.float32)}
    g = {"a": rs.randn(5, 3).astype(np.float32),
         "b": rs.randn(4).astype(np.float32)}
    want = joptim.sgd_update(jax.tree.map(jnp.asarray, g),
                             jax.tree.map(jnp.asarray, p), lr=0.3)
    got = optim.sgd_update({k: torch.from_numpy(v) for k, v in g.items()},
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           lr=0.3)
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    jsched = joptim.cosine_schedule(1e-3, 10, 100)
    sched = optim.cosine_schedule(1e-3, 10, 100)
    for step in (0, 3, 10, 11, 55, 100, 140):
        want = float(jsched(jnp.asarray(step, jnp.int32)))
        assert sched(step) == pytest.approx(want, rel=1e-6, abs=1e-12)
        assert float(sched(torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(want, rel=1e-6, abs=1e-12)
