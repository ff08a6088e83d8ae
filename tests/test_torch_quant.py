"""The port's blockwise quantizer (repro_torch.core.quant) against the JAX
package's (repro.core.quant): payloads, scales and byte counts bitwise,
for int8, int4 and NF4, with stacked lead dims and odd blocks.
Inputs are numpy arrays from a seed, handed to both."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import quant as jq
from repro_torch import convert
from repro_torch.core import quant as tq

torch.set_num_threads(1)

FORMATS = [(8, "linear"), (4, "linear"), (4, "nf4")]


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_same(t: tq.QTensor, j):
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    assert t.q.numpy().dtype == np.asarray(j.q).dtype
    assert (t.bits, t.mode, t.block) == (j.bits, j.mode, j.block)
    assert t.orig_shape == tuple(j.orig_shape)


@pytest.mark.parametrize("bits,mode", FORMATS)
@pytest.mark.parametrize("shape,block", [((128, 48), 64), ((3, 96, 20), 32),
                                         ((2, 2, 64, 8), 16), ((8, 5), 128)])
def test_quantize_dequantize_bitwise(bits, mode, shape, block):
    x = _np(0, *shape)
    j = jq.quantize(jnp.asarray(x), bits=bits, block=block, mode=mode)
    t = tq.quantize(torch.from_numpy(x), bits=bits, block=block, mode=mode)
    _assert_same(t, j)
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(j)))


def test_quantize_odd_block_int8():
    x = _np(1, 45, 12)
    j = jq.quantize(jnp.asarray(x), bits=8, block=45)
    t = tq.quantize(torch.from_numpy(x), bits=8, block=45)
    _assert_same(t, j)
    with pytest.raises(ValueError, match="divisible"):
        tq.quantize(torch.from_numpy(x), bits=8, block=40)


def test_pack4_unpack4_bitwise():
    v = np.random.RandomState(2).randint(-8, 8, (3, 16, 7)).astype(np.int8)
    pt = tq.pack4(torch.from_numpy(v))
    pj = np.asarray(jq.pack4(jnp.asarray(v)))
    np.testing.assert_array_equal(pt.numpy(), pj)
    # the hi nibble holds the even row
    assert ((pt.numpy() >> 4).astype(np.int8) - 8 == v[:, 0::2]).all()
    np.testing.assert_array_equal(tq.unpack4(pt).numpy(), v)


def test_quantize_tree_and_tree_bytes_bitwise():
    tree = {"adapter": {"w1": _np(3, 96, 64), "b1": _np(4, 64)},
            "lora": {"a": _np(5, 2, 96, 4)},
            "odd": _np(6, 45, 128),          # _pick_block -> 45: int8
            "small": _np(7, 8, 8)}           # below min_size: stays fp
    for bits, mode in FORMATS:
        j = jq.quantize_tree(_jax_tree(tree),
                             bits=bits, block=64, mode=mode, min_size=256)
        t = tq.quantize_tree(convert.tree_from_numpy(tree, "cpu"),
                             bits=bits, block=64, mode=mode, min_size=256)
        for path in (("adapter", "w1"), ("odd",)):
            _assert_same(_get(t, path), _get(j, path))
        assert isinstance(t["adapter"]["b1"], torch.Tensor)
        assert isinstance(t["lora"]["a"], torch.Tensor)       # skip "lora"
        assert isinstance(t["small"], torch.Tensor)
        assert _get(t, ("odd",)).bits == 8
        assert tq.tree_bytes(t) == jq.tree_bytes(j)
        deq = tq.dequantize_tree(t, torch.float32)
        np.testing.assert_array_equal(
            deq["adapter"]["w1"].numpy(),
            np.asarray(jq.dequantize_tree(j, jnp.float32)["adapter"]["w1"]))


def test_convert_round_trip_keeps_qtensor():
    j = jq.quantize(jnp.asarray(_np(8, 64, 16)), bits=4, block=32)
    t = convert.tree_from_numpy({"w": j}, "cpu")["w"]
    _assert_same(t, j)
    back = convert.tree_to_numpy({"w": t})["w"]
    np.testing.assert_array_equal(back.q, np.asarray(j.q))
    assert back.out_dtype == "float32"


def _jax_tree(v):
    if isinstance(v, dict):
        return {k: _jax_tree(x) for k, x in v.items()}
    return jnp.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
