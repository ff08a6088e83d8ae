"""The port's checkpointing (``repro_torch.ckpt``), data pipeline
(``repro_torch.data.pipeline``), QLoRA double quantization
(``core.quant.double_quantize``) and the trainer's ``--ckpt`` against the
JAX package, on the CPU.

``tests/test_ckpt_pipeline.py``'s nine tests are restated on the port,
each beside the JAX package's result. The on-disk format is shared: a
checkpoint of fp32, int32, int8 and NF4 leaves (and an Adam state)
written by either package loads in the other bitwise; the port's bf16
leaves round-trip as their 2-byte patterns, and it reads the JAX
package's bf16 leaves. ``ArrayDataset``, ``client_streams`` and
``lm_sequences`` draw the JAX package's batches bitwise; double
quantization's int8 codes, scales and means are the JAX package's bitwise
(its quantizer run eagerly; the mean in XLA's summation order). A
trainer run resumed from ``--ckpt`` is bitwise the straight run."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import ckpt as jckpt
from repro.core import optim as joptim
from repro.core import quant as jq
from repro.data import pipeline as jpl
from repro_torch import ckpt
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import optim
from repro_torch.core import quant as q
from repro_torch.data import pipeline as pl
from repro_torch.launch import train

torch.set_num_threads(2)


def _leaves_equal(got, want):
    g = [l for _, l in tree_lib.flatten_with_path(got)]
    w = [l for _, l in tree_lib.flatten_with_path(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(a, q.QTensor):
            assert (a.bits, a.mode, a.block, a.out_dtype, a.orig_shape) == \
                (b.bits, b.mode, b.block, b.out_dtype, b.orig_shape)
            assert torch.equal(a.q, b.q) and torch.equal(a.scales, b.scales)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


# -- tests/test_ckpt_pipeline.py, restated ---------------------------------

def test_checkpoint_roundtrip_plain(tmp_path, rng):
    tree = {"a": torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
            "nest": {"b": torch.arange(5, dtype=torch.int32)},
            "lst": [torch.ones((2,)), torch.zeros((3,))]}
    p = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(p, tree, extra={"round": 7})
    back, extra = ckpt.load_checkpoint(p, tree)
    assert extra["round"] == 7
    _leaves_equal(back, tree)
    # the JAX package reads the port's file
    jback, jextra = jckpt.load_checkpoint(
        p, jax.tree.map(np.asarray, convert.tree_to_numpy(tree)))
    assert jextra == extra
    for x, y in zip(jax.tree.leaves(jback),
                    tree_lib.leaves(convert.tree_to_numpy(tree))):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_checkpoint_roundtrip_qtensor(tmp_path, rng):
    w = rng.randn(128, 16).astype(np.float32)
    qt = q.quantize(torch.from_numpy(w), bits=4, block=64, mode="nf4")
    p = str(tmp_path / "ckq.npz")
    ckpt.save_checkpoint(p, {"w": qt})
    back, _ = ckpt.load_checkpoint(p, {"w": qt})
    assert isinstance(back["w"], q.QTensor)
    assert back["w"].bits == 4 and back["w"].mode == "nf4"
    _leaves_equal(back, {"w": qt})
    torch.testing.assert_close(q.dequantize(back["w"]), q.dequantize(qt),
                               atol=0, rtol=0)
    # the JAX package's NF4 quantizer writes the same payload
    jqt = jq.quantize(jnp.asarray(w), bits=4, block=64, mode="nf4")
    np.testing.assert_array_equal(np.asarray(jqt.q), back["w"].q.numpy())


def test_checkpoint_shape_mismatch_raises(tmp_path):
    p = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(p, {"a": torch.ones((3,))})
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(p, {"a": torch.ones((4,))})
    with pytest.raises(ValueError):
        jckpt.load_checkpoint(p, {"a": jnp.ones((4,))})


def test_fl_state_roundtrip(tmp_path, rng):
    tr = {"adapter": torch.from_numpy(rng.randn(8, 8).astype(np.float32))}
    p = str(tmp_path / "fl.npz")
    ckpt.save_fl_state(p, round_idx=12, global_trainable=tr,
                       client_sizes=[10, 20])
    tr2, opt2, rnd, sizes = ckpt.restore_fl_state(p, like_trainable=tr)
    assert rnd == 12 and sizes == [10, 20] and opt2 is None
    assert torch.equal(tr["adapter"], tr2["adapter"])
    jtr, jopt, jrnd, jsizes = jckpt.restore_fl_state(
        p, like_trainable={"adapter": jnp.zeros((8, 8))})
    assert (jrnd, jsizes, jopt) == (rnd, sizes, None)
    np.testing.assert_array_equal(np.asarray(jtr["adapter"]),
                                  tr["adapter"].numpy())


def test_dataset_epochs_cover_everything():
    data = {"x": np.arange(17), "y": np.arange(17) * 2}
    seen = []
    for b, jb in zip(pl.ArrayDataset(data, seed=0).batches(4, epochs=1),
                     jpl.ArrayDataset(data, seed=0).batches(4, epochs=1)):
        assert len(b["x"]) == 4
        np.testing.assert_array_equal(b["x"], jb["x"])
        seen.extend(b["x"].tolist())
    assert len(seen) == 16 and len(set(seen)) == 16  # drop-remainder


def test_dataset_split_disjoint():
    data = {"x": np.arange(100)}
    a, b = pl.ArrayDataset(data).split([0.8, 0.2])
    ja, jb = jpl.ArrayDataset(data).split([0.8, 0.2])
    assert a.n == 80 and b.n == 20
    assert not set(a.data["x"]) & set(b.data["x"])
    np.testing.assert_array_equal(a.data["x"], ja.data["x"])
    np.testing.assert_array_equal(b.data["x"], jb.data["x"])


def test_client_streams_respect_partition():
    data = {"x": np.arange(30)}
    parts = [np.arange(0, 10), np.arange(10, 30)]
    s0, s1 = pl.client_streams(data, parts, batch_size=4)
    j0, j1 = jpl.client_streams(data, parts, batch_size=4)
    for s, j, rng_ in ((s0, j0, range(10)), (s1, j1, range(10, 30))):
        for _ in range(6):                      # past an epoch's end
            b, jb = next(s), next(j)
            assert set(b["x"]) <= set(rng_)
            np.testing.assert_array_equal(b["x"], jb["x"])


def test_prefetch_preserves_order():
    batches = [{"x": np.full((2,), i)} for i in range(5)]
    out = list(pl.prefetch(iter(batches), device="cpu"))
    want = list(jpl.prefetch(iter(batches)))
    assert [int(b["x"][0]) for b in out] == list(range(5))
    assert [int(b["x"][0]) for b in want] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)


def test_double_quantization(rng):
    w = rng.randn(512, 32).astype(np.float32)
    qt = q.quantize(torch.from_numpy(w), bits=4, block=64)
    dq = q.double_quantize(qt)
    back = q.double_dequantize(dq)
    # payload identical; scales within int8 error of the originals
    assert torch.equal(qt.q, back.q)
    rel = float((qt.scales - back.scales).abs().max() /
                (qt.scales.abs().max() + 1e-12))
    assert rel < 0.02
    # end-to-end weight error stays close to single quantization
    e1 = float((torch.from_numpy(w) - q.dequantize(qt)).abs().max())
    e2 = float((torch.from_numpy(w) - q.dequantize(back)).abs().max())
    assert e2 < 1.25 * e1 + 1e-4
    # and it actually saves bytes vs f32 scales
    assert q.double_quant_bytes(dq) - qt.q.numel() < qt.scales.numel() * 4 / 2
    # the JAX package's, bitwise
    jd = jq.double_quantize(jq.quantize(jnp.asarray(w), bits=4, block=64))
    for k in ("q", "s_q", "s_scale", "s_mean"):
        np.testing.assert_array_equal(dq[k].numpy(), np.asarray(jd[k]), k)
    assert q.double_quant_bytes(dq) == jq.double_quant_bytes(jd)


# -- beyond the restated nine ------------------------------------------------

@pytest.mark.parametrize("shape,bits,mode,block", [
    ((1024, 96), 4, "nf4", 256),     # 1 536 scales: 6 blocks of 256
    ((704, 33), 8, "linear", 256),   # a padded last block
    ((1024, 96), 4, "nf4", 64)])
def test_double_quantize_bitwise_the_jax_package(shape, bits, mode, block):
    w = np.random.RandomState(3).randn(*shape).astype(np.float32) * 0.02
    jqt = jq.quantize(jnp.asarray(w), bits=bits, block=64, mode=mode)
    jd = jq.double_quantize(jqt, block=block)
    dq = q.double_quantize(convert.tree_from_numpy({"w": jqt}, "cpu")["w"],
                           block=block)
    for k in ("s_q", "s_scale", "s_mean"):
        np.testing.assert_array_equal(dq[k].numpy(), np.asarray(jd[k]), k)
    np.testing.assert_array_equal(
        q.double_dequantize(dq).scales.numpy(),
        np.asarray(jq.double_dequantize(jd).scales))
    assert dq["meta"]["scales_shape"] == jd["meta"]["scales_shape"]


def _cross_tree(seed):
    """A JAX tree of fp32, int32, int8 and stacked NF4 leaves, plus an
    Adam state (a NamedTuple)."""
    rs = np.random.RandomState(seed)
    w = jnp.asarray(rs.randn(2, 128, 16).astype(np.float32))
    tr = {"lora": {"a": jnp.asarray(rs.randn(4, 3).astype(np.float32))},
          "ids": jnp.arange(5, dtype=jnp.int32),
          "codes": jnp.asarray(rs.randint(-127, 128, (3, 4)), jnp.int8),
          "layers": [jq.quantize(w, bits=4, block=64, mode="nf4")]}
    opt = joptim.adam_init({"a": tr["lora"]["a"]})
    return {"tree": tr, "opt": opt}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_loads_in_the_other_package(tmp_path, writer):
    jtree = _cross_tree(4)
    ttree = {"tree": convert.tree_from_numpy(jtree["tree"], "cpu"),
             "opt": optim.AdamState(*(convert.tree_from_numpy(
                 list(jtree["opt"]), "cpu")))}
    p = str(tmp_path / "x.npz")
    if writer == "jax":
        jckpt.save_checkpoint(p, jtree, extra={"round": 3})
        got, extra = ckpt.load_checkpoint(p, ttree)
        assert extra == {"round": 3}
        assert isinstance(got["opt"], optim.AdamState)
        _leaves_equal(got, ttree)
    else:
        ckpt.save_checkpoint(p, ttree, extra={"round": 3})
        got, extra = jckpt.load_checkpoint(p, jtree)
        assert extra == {"round": 3}
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        back = jax.tree_util.tree_flatten(
            got, is_leaf=lambda l: isinstance(l, jq.QTensor))[0]
        assert any(isinstance(l, jq.QTensor) and l.mode == "nf4"
                   for l in back)


def test_bf16_leaves_round_trip_without_ml_dtypes(tmp_path):
    x = torch.randn(6, 5).to(torch.bfloat16)
    p = str(tmp_path / "b.npz")
    ckpt.save_checkpoint(p, {"x": x})
    with np.load(p) as data:
        assert data["x"].dtype == np.uint16       # the 2-byte pattern
    back, _ = ckpt.load_checkpoint(p, {"x": x})
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)
    # the JAX package's bf16 leaves (stored as 2-byte voids) read back
    jp = str(tmp_path / "j.npz")
    jx = jnp.asarray(np.linspace(-3, 3, 30, dtype=np.float32).reshape(6, 5),
                     jnp.bfloat16)
    jckpt.save_checkpoint(jp, {"x": jx})
    got, _ = ckpt.load_checkpoint(jp, {"x": x})
    assert got["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["x"].float().numpy(),
                                  np.asarray(jx, np.float32))


def test_train_resume_from_ckpt_is_bitwise_the_straight_run(tmp_path,
                                                           capsys):
    """``--ckpt``, as in the JAX package's trainer: 2 rounds, then a run
    to 3 that resumes at round 2, equal bit for bit to 3 straight rounds;
    the manifest is the one the JAX package's ``restore_fl_state``
    reads."""
    args = ["--rounds", "2", "--clients", "2", "--local-steps", "1",
            "--seq", "16"]
    ck = str(tmp_path / "fl.npz")
    train.main(args + ["--ckpt", ck], device="cpu")
    args[1] = "3"
    resumed = train.main(args + ["--ckpt", ck], device="cpu")
    assert f"resumed from {ck} at round 2" in capsys.readouterr().out
    straight = train.main(args, device="cpu")
    _leaves_equal(resumed, straight)
    like = jax.tree.map(np.asarray, convert.tree_to_numpy(straight))
    jtr, _, rnd, sizes = jckpt.restore_fl_state(ck, like_trainable=like)
    assert rnd == 3 and sizes == [64, 64]
    for a, b in zip(jax.tree.leaves(jtr), tree_lib.leaves(like)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_lm_sequences_bitwise_the_jax_package():
    kw = dict(n_docs=5, seq=12, bias_lo=3, bias_hi=40)
    got = pl.lm_sequences(np.random.RandomState(2), 64, **kw)
    want = jpl.lm_sequences(np.random.RandomState(2), 64, **kw)
    for k in ("tokens", "labels"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
