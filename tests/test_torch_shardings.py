"""The port's sharding rules (``repro_torch.launch.shardings``) against the
JAX package's (``repro.launch.shardings``), as pure Python over shapes:
for every arch, a dense and an NF4 backbone, and a model axis of 2 and
16, the port's ``param_specs_tree`` equals the JAX one leaf for leaf as
tuples (a QTensor's ``q`` and ``scales`` specs both), and so do
``cache_specs_tree`` and ``batch_specs_tree``; the trainables are
replicated. The shapes are the JAX package's full-config spec trees
(``Model.param_specs``, ``cache_specs``), handed to the port as ``meta``
tensors. Also ``local_shard`` and ``rank_params`` on a small tree."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS, get_config
from repro.core.quant import QTensor as JQ
from repro.launch import shardings as jsh
from repro.models import build_model
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as t_config
from repro_torch.core.quant import QTensor
from repro_torch.launch import shardings as sh
from repro_torch.models.runtime import P


def _mesh(m):
    try:
        return AbstractMesh((16, m), ("data", "model"))
    except TypeError:       # jax<=0.4.x: a tuple of (name, size) pairs
        return AbstractMesh((("data", 16), ("model", m)))


class _Shape:
    """What the port's rules read of a mesh: ``shape[axis]``."""

    def __init__(self, m):
        self.shape = {"data": 16, "model": m}


def _meta(tree):
    """The JAX spec tree as a port tree of ``meta`` tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    if isinstance(tree, JQ):
        return QTensor(q=_meta(tree.q), scales=_meta(tree.scales),
                       bits=tree.bits, mode=tree.mode, block=tree.block,
                       out_dtype=torch.float32,
                       orig_shape=tuple(tree.orig_shape))
    return torch.empty(tuple(tree.shape), device="meta")


def _jflat(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda l: isinstance(l, (JP, JQ)))[0]
    out = {}
    for path, leaf in flat:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        out[keys] = leaf
    return out


def _same(got, want, path):
    if isinstance(want, JQ):
        assert isinstance(got, QTensor), path
        assert tuple(got.q) == tuple(want.q), (path, got.q, want.q)
        assert tuple(got.scales) == tuple(want.scales), path
        return
    assert isinstance(got, P), (path, got)
    assert tuple(got) == tuple(want), (path, got, want)


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("quant", [None, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, quant, m):
    cfg = get_config(arch)
    tcfg = t_config(arch)
    if quant:
        cfg = cfg.replace(quant_bits=4, quant_mode="nf4")
        tcfg = tcfg.replace(quant_bits=4, quant_mode="nf4")
    specs = build_model(cfg).param_specs()
    want = _jflat(jsh.param_specs_tree(cfg, specs, _mesh(m)))
    got = dict(tree_lib.flatten_with_path(
        sh.param_specs_tree(tcfg, _meta(specs), _Shape(m))))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _same(got[path], w, path)
    for path, g in got.items():
        if path[0] == "trainable":      # FL communicates these
            assert g == P() or (isinstance(g, QTensor) and g.q == P()), path


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_jax(arch, m):
    cfg = get_config(arch)
    cache = build_model(cfg).cache_specs(128, 32768)
    for dp in (("data",), ("pod", "data")):
        mesh_shape = {"data": 16, "model": m, "pod": 2}
        jmesh = _mesh(m) if dp == ("data",) else _pod_mesh(m)
        tm = _Shape(m)
        tm.shape = mesh_shape
        want = _jflat(jsh.cache_specs_tree(cfg, cache, jmesh, dp))
        got = dict(tree_lib.flatten_with_path(
            sh.cache_specs_tree(t_config(arch), _meta(cache), tm, dp)))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            _same(got[path], w, path)
        batch = {"tokens": jax.ShapeDtypeStruct((96, 64), np.int32),
                 "odd": jax.ShapeDtypeStruct((7, 3), np.float32),
                 "scalar": jax.ShapeDtypeStruct((), np.float32)}
        want = _jflat(jsh.batch_specs_tree(cfg, batch, jmesh, dp))
        got = dict(tree_lib.flatten_with_path(sh.batch_specs_tree(
            t_config(arch), {k: torch.empty(v.shape, device="meta")
                             for k, v in batch.items()}, tm, dp)))
        for path, w in want.items():
            _same(got[path], w, path)


def _pod_mesh(m):
    try:
        return AbstractMesh((2, 16, m), ("pod", "data", "model"))
    except TypeError:
        return AbstractMesh((("pod", 2), ("data", 16), ("model", m)))


class _Rank:
    """A mesh stand-in at one rank's coordinates."""

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords
        self.axis_names = tuple(shape)

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def test_local_shard_and_rank_params_cut_the_experts_only():
    """``rank_params`` cuts every leaf by ``param_specs_tree`` (the
    experts over ``model`` and ``data``, the dense ``wq`` over ``model``,
    its NF4 twin on its storage's N, the router whole), each block
    contiguous and owning its storage, and the ranks' blocks reassemble
    every whole leaf bitwise."""
    from repro_torch.core import quant as qlib
    w = torch.randn(3, 8, 128, 64)               # (L, E, K, N) experts
    qt = qlib.quantize(w, bits=4, block=64, mode="nf4")
    dense = torch.randn(3, 128, 64)
    tree = {"layers": {"moe": {"wg": qt, "router": torch.randn(3, 128, 8)},
                       "wq": dense,
                       "wo": qlib.quantize(torch.randn(3, 256, 128),
                                           bits=4, block=64, mode="nf4")}}
    cfg = t_config("qwen3-moe-235b-a22b")
    shape = {"data": 2, "model": 4}
    specs = sh.param_specs_tree(cfg, tree, _Shape(4))
    assert tuple(specs["layers"]["wq"]) == (None, None, "model")
    assert tuple(specs["layers"]["wo"].q) == (None, "model", None, None)
    cuts = {}
    for d in range(2):
        for m in range(4):
            rt = type("RT", (), {"mesh": _Rank(shape, {"data": d,
                                                        "model": m})})
            cut = sh.rank_params(cfg, tree, rt)
            c = cut["layers"]["moe"]["wg"]
            assert c.q.shape == (3, 2, 2, 32, 32)    # G = 128 / 64
            assert c.orig_shape == (3, 2, 128, 32)
            assert cut["layers"]["wq"].shape == (3, 128, 16)
            assert cut["layers"]["wo"].q.shape == (3, 1, 32, 128)
            assert cut["layers"]["wo"].orig_shape == (3, 64, 128)
            assert cut["layers"]["moe"]["router"] is \
                tree["layers"]["moe"]["router"]
            for leaf in (c.q, c.scales, cut["layers"]["wq"],
                         cut["layers"]["wo"].q):
                assert leaf.is_contiguous()
                assert leaf.untyped_storage().nbytes() == \
                    leaf.numel() * leaf.element_size()
            cuts[(d, m)] = cut
    full = qlib.dequantize(qt)
    for (d, m), cut in cuts.items():
        torch.testing.assert_close(
            qlib.dequantize(cut["layers"]["moe"]["wg"]),
            full[:, 2 * m:2 * m + 2, :, 32 * d:32 * d + 32], rtol=0, atol=0)
    wq = torch.cat([cuts[(0, m)]["layers"]["wq"] for m in range(4)], -1)
    assert torch.equal(wq, dense)
    wo = torch.cat([qlib.dequantize(cuts[(1, m)]["layers"]["wo"])
                    for m in range(4)], 1)
    assert torch.equal(wo, qlib.dequantize(tree["layers"]["wo"]))


def test_rank_tree_from_numpy_carries_jax_experts_into_a_rank_shard():
    """A JAX MoE layer stack (NF4 experts) converted straight into each
    rank's shard: the blocks are the whole conversion's, bit for bit."""
    from repro import configs as jconfigs
    from repro.core import quant as jquant
    from repro.models import moe as jmoe
    from repro_torch import convert
    jcfg = jconfigs.get_reduced("qwen3-moe-235b-a22b")
    p = jmoe.init_experts(jax.random.PRNGKey(0), jcfg, jax.numpy.float32)
    tree = {"layers": {"moe": {
        k: (jquant.quantize(v[None], bits=4, block=64, mode="nf4")
            if k != "router" else v[None]) for k, v in p.items()}}}
    whole = convert.tree_from_numpy(tree, "cpu")
    for m in range(2):
        rt = type("RT", (), {"mesh": _Rank({"data": 2, "model": 2},
                                           {"data": 1, "model": m})})
        got = convert.rank_tree_from_numpy(
            tree, t_config("qwen3-moe-235b-a22b"), rt, "cpu")
        for n in ("wg", "wu", "wd"):
            want = sh.local_shard(whole["layers"]["moe"][n],
                                  sh._expert_leaf_spec(
                                      whole["layers"]["moe"][n]), rt.mesh)
            g = got["layers"]["moe"][n]
            assert torch.equal(g.q, want.q) and torch.equal(g.scales,
                                                            want.scales)
            assert g.q.shape[1] == jcfg.n_experts // 2
        assert torch.equal(got["layers"]["moe"]["router"],
                           whole["layers"]["moe"]["router"])


def test_cohort_spec_and_rows_follow_jax_cohort_sharding():
    """``mesh.cohort_spec`` is the spec of the JAX ``cohort_sharding``
    (the cohort axis over the data-parallel axes), and ``cohort_rows``
    gives each rank its contiguous block of it, in the dp index order."""
    from jax.sharding import Mesh as JMesh
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    for names, shape in ((("pod", "data", "model"), (2, 2, 2)),
                         (("data", "model"), (4, 2)), (("data",), (8,))):
        jm = JMesh(np.array(jax.devices()[:1]).reshape((1,) * len(names)),
                   names)
        for ndim in (1, 3):
            want = tuple(jmesh.cohort_sharding(jm, ndim).spec)
            got = tmesh.cohort_spec(_Rank(dict(zip(names, shape)),
                                          {}), ndim)
            assert tuple(got) == want, (names, got, want)
        rows = []
        for coords in np.ndindex(*shape):
            r = _Rank(dict(zip(names, shape)), dict(zip(names, coords)))
            rows.append((r.index(tmesh.dp_axes(r)),
                         tmesh.cohort_rows(r, 16)))
        for i, sl in rows:
            w = 16 // tmesh.cohort_axis_size(_Rank(dict(zip(names, shape)),
                                                   {}))
            assert sl == slice(i * w, (i + 1) * w)
