"""The port's explicit SPMD bodies (``repro_torch.models.runtime`` and the
Runtime paths of ``models/{moe,ssm,rglru,model}.py`` and
``kernels/ops.py``) on a gloo world of 8 ranks laid out ``(pod=2,
data=2, model=2)``, the JAX package's own distributed test layout
(tests/test_distributed.py), against the JAX package's *local* paths.

One world runs every check (``_torch_dist_worker.model_bodies``, one
thread a rank, a FileStore rendezvous, a timeout); the JAX references
are computed here, on the same numpy inputs, reduced fp32 configs:

- the MoE (reduced Qwen3-MoE, capacity factor 8 as the JAX test uses:
  under a mesh the capacity is per rank): sequence-sharded and decode
  outputs, NF4 experts and experts given as each rank's pre-cut shard
  (``shardings.rank_params``), within 1e-5 of the largest magnitude;
  the dispatch's int8 codes and scales bitwise the eager JAX
  ``_q8_rows``, and the int8 all-to-all's output within the int8 bound;
- ``flash_attention`` (GQA 6/3 and MQA with its 5 heads padded to 6,
  window 8, causal), the split-KV ``decode_attention`` (on the rank's
  block of the slots, and on a whole cache whose slots the model axis
  does not divide), ``mamba_block`` (y and h, with and without sequence
  sharding, from zero and from a start state) and ``rglru_block``,
  ``decode_step`` of reduced Yi-9B on the rank's blocks
  (``shardings.rank_params`` / ``rank_cache`` / ``rank_batch``, the
  rows gathered over dp): within 1e-5 of the largest magnitude;
- gradients through every body against the port's local autograd in the
  same rank, within 1e-5 of the largest magnitude (JAX's transposes:
  ``psum`` to ``psum``, the tiled all-gather to a reduce-scatter, the
  all-to-all to itself);
- a full ``train_step`` of reduced Yi-9B on the rank's blocks: loss and
  gradients against the port's local step and JAX's local step within
  1e-5, identical on every rank;
- ``DIST_TRACES``: which body each call took (the model's linears by
  their tensor-parallel routes), the local fallbacks where the JAX
  package falls back (a batch the dp axes do not divide).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist_worker import spawn
from repro.configs import get_reduced as j_reduced
from repro.core import quant as jq
from repro.kernels import ref as jref
from repro.models import build_model as j_build
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced
from repro_torch.core import optim

torch.set_num_threads(1)
QWEN = "qwen3-moe-235b-a22b"


def _t(a):
    return convert.tree_from_numpy(a, "cpu")


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _lora(rs, d_in, d_out, r):
    return {"a": (rs.randn(d_in, r) * 0.1).astype(np.float32),
            "b": (rs.randn(r, d_out) * 0.1).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _world():
    """The JAX references and the one 8-rank world's results."""
    inp, want = {}, {}
    # -- MoE ---------------------------------------------------------------
    jcfg = j_reduced(QWEN).replace(capacity_factor=8.0)
    p = jmoe.init_experts(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 8, jcfg.d_model)) * 0.1)
    ffn = jax.jit(lambda p_, x_: jmoe.moe_ffn(p_, x_, jcfg)[0])
    want["moe"] = ffn(p, jnp.asarray(x))
    want["moe_decode"] = ffn(p, jnp.asarray(x[:, :1]))
    pq = {k: (jq.quantize(v, bits=4, block=64, mode="nf4")
              if k != "router" else v) for k, v in p.items()}
    want["moe_nf4"] = ffn(pq, jnp.asarray(x))
    inp.update(moe_cfg=get_reduced(QWEN).replace(capacity_factor=8.0),
               moe_p=_t(p), moe_pq=_t(pq), moe_x=torch.from_numpy(x))
    rs = np.random.RandomState(5)
    rows = np.concatenate([rs.randn(6, 32) * 10.0 ** e
                           for e in (-3, 0, 2)]).astype(np.float32)
    rows[0] = 0.0
    want["q8"] = jmoe._q8_rows(jnp.asarray(rows))      # eager, as tested
    inp["q8_rows"] = torch.from_numpy(rows)
    # -- attention ---------------------------------------------------------
    for name, H, Hkv in (("fa_gqa", 6, 3), ("fa_mqa", 5, 1)):
        r = np.random.RandomState(H)
        q, k, v = (r.randn(4, 16, h, 16).astype(np.float32)
                   for h in (H, Hkv, Hkv))
        want[name] = jref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                          causal=True, window=8)
        inp[name] = tuple(map(torch.from_numpy, (q, k, v)))
    for name, M in (("dec_attn", 8), ("dec_attn_odd", 7)):
        r = np.random.RandomState(M)
        q = r.randn(4, 1, 4, 8).astype(np.float32)
        kc, vc = (r.randn(4, M, 2, 8).astype(np.float32) for _ in range(2))
        sp = np.arange(M, dtype=np.int32)[None]
        sp[0, 2] = -1
        want[name] = jref.decode_attention(*map(jnp.asarray, (q, kc, vc, sp)))
        inp[name] = tuple(map(torch.from_numpy, (q, kc, vc, sp)))
    # -- recurrent blocks --------------------------------------------------
    for name, arch, init, lo_names in (
            ("mamba", "falcon-mamba-7b", jssm.init_mamba,
             ("in_proj_x", "out_proj")),
            ("rglru", "recurrentgemma-2b", jrglru.init_rglru,
             ("wx", "wy", "out_proj"))):
        jc = j_reduced(arch)
        pb = init(jax.random.PRNGKey(0), jc, jnp.float32)
        d, w = jc.d_model, (jc.d_inner if name == "mamba"
                            else jc.lru_width or jc.d_model)
        r = np.random.RandomState(7)
        shapes = {"in_proj_x": (d, w), "out_proj": (w, d), "wx": (d, w),
                  "wy": (d, w)}
        lo = {n: _lora(r, *shapes[n], jc.lora_rank) for n in lo_names}
        xb = (r.randn(4, 8, d) * 0.1).astype(np.float32)
        block = jssm.mamba_block if name == "mamba" else jrglru.rglru_block
        run = jax.jit(lambda p_, x_, lo_, jc=jc, block=block: block(
            p_, x_, jc, lora=lo_))
        # the local path does not read seq_shard
        want[f"{name}_True"] = want[f"{name}_False"] = run(
            pb, jnp.asarray(xb), lo)
        want[f"{name}_fallback"] = run(pb, jnp.asarray(xb[:2]), lo)
        inp[name] = (get_reduced(arch), _t(pb), _t(lo), torch.from_numpy(xb))
    h0 = (np.random.RandomState(8).randn(4, j_reduced("falcon-mamba-7b")
                                         .d_inner, 8) * 0.3).astype(np.float32)
    jc = j_reduced("falcon-mamba-7b")
    want["mamba_h0"] = jax.jit(lambda p_, x_, lo_, h_: jssm.mamba_block(
        p_, x_, jc, lora=lo_, h0=h_))(
        jssm.init_mamba(jax.random.PRNGKey(0), jc, jnp.float32),
        jnp.asarray(inp["mamba"][3].numpy()), tree_lib.tree_map(
            lambda t: jnp.asarray(t.numpy()), inp["mamba"][2]),
        jnp.asarray(h0))
    inp["mamba_h0"] = torch.from_numpy(h0)
    # -- the dense model: decode step and train step -----------------------
    jc = j_reduced("yi-9b").replace(seq_shard=True)
    jm = j_build(jc)
    params = jm.init_params(jax.random.PRNGKey(1))
    r = np.random.RandomState(0)
    tr = jax.tree.map(lambda l: l + jnp.asarray(
        r.randn(*l.shape) * 0.05, l.dtype), params["trainable"])
    toks = r.randint(0, jc.vocab_size, (4, 17)).astype(np.int32)
    _, cache = jax.jit(lambda f, t, b: jm.prefill(f, t, b, max_len=32))(
        params["frozen"], tr, {"tokens": jnp.asarray(toks[:, :16])})
    want["yi_decode"] = jax.jit(jm.decode_step)(
        params["frozen"], tr, cache, jnp.asarray(toks[:, :1]),
        jnp.asarray(16, jnp.int32))[0]
    tc = get_reduced("yi-9b").replace(seq_shard=True)
    inp["yi_decode"] = (tc, _t(params["frozen"]), _t(tr), _t(cache),
                        torch.from_numpy(toks[:, :1]),
                        torch.tensor(16, dtype=torch.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": np.ones((4, 16), np.float32)}
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda t, b: jm.loss_fn(params["frozen"], t, b), has_aux=True))(
            tr, jax.tree.map(jnp.asarray, batch))
    want["yi_train"] = (loss, g)
    inp["yi_train"] = (tc, _t(params["frozen"]), _t(tr),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    res = spawn("model_bodies", 8, inp, timeout=400)
    return inp, want, res


@pytest.fixture(scope="module")
def world():
    return _world()


def test_world_is_the_jax_debug_mesh_and_every_rank_agrees(world):
    _, _, res = world
    assert len(res) == 8
    for r in res[1:]:
        for key in ("moe_dist", "moe_decode", "dec_attn", "yi_decode"):
            assert torch.equal(r[key], res[0][key]), key
        assert torch.equal(r["yi_train"]["loss"][1],
                           res[0]["yi_train"]["loss"][1])


def test_moe_sequence_sharded_and_decode_match_jax_local(world):
    _, want, res = world
    for r in res:
        _close(r["moe_dist"], want["moe"])
        _close(r["moe_local"], want["moe"])
        _close(r["moe_decode"], want["moe_decode"])
        _close(r["moe_precut"], want["moe"])
        _close(r["moe_nf4_dist"], want["moe_nf4"])
        _close(r["moe_nf4_local"], want["moe_nf4"])
        # each rank holds E / model experts and d_ff / data columns
        assert r["moe_cut_shapes"]["wg"] == (2, 256, 64)
        assert r["moe_cut_shapes"]["wd"] == (2, 128, 128)


def test_moe_gradient_through_the_all_to_all(world):
    """The gradient of the output (the aux loss is the mean of the ranks'
    own, the JAX body's ``pmean``, so it is left out): the all-to-all's
    transpose, the output all-gather's and the per-expert products
    against the local autograd."""
    inp, _, res = world
    from repro_torch.models import moe
    x = inp["moe_x"].clone().requires_grad_(True)
    y, _ = moe.moe_ffn(inp["moe_p"], x, inp["moe_cfg"])
    gl, = torch.autograd.grad((y * y).sum(), x)
    for r in res:
        _close(r["moe_dx_local"], gl.numpy(), 1e-6)
        _close(r["moe_dx_dist"], gl.numpy())
        # the int8 wire carries the cotangent too: near, not equal
        _close(r["moe_q8_dx"], gl.numpy(), 5e-2)


def test_moe_int8_dispatch_codes_are_the_eager_jax_codes_bitwise(world):
    _, want, res = world
    jqc, jsc = (np.asarray(a) for a in want["q8"])
    for r in res:
        q, s = r["q8_codes"]
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), jqc)
        np.testing.assert_array_equal(s.numpy(), jsc)
        # the int8 wire moves each dispatched and returned row by at most
        # one code step of its absmax: a few hundredths of the output
        for key, ref_key in (("moe_q8", "moe"), ("moe_q8_decode",
                                                 "moe_decode")):
            _close(r[key], want[ref_key], 4e-2)


@pytest.mark.parametrize("name", ["fa_gqa", "fa_mqa"])
def test_flash_attention_head_split_matches_jax(world, name):
    _, want, res = world
    for r in res:
        out, gl, gd = r[name]
        _close(out, want[name])
        for a, b in zip(gd, gl):
            _close(a, b.numpy())


def test_decode_attention_split_kv_matches_jax(world):
    _, want, res = world
    for r in res:
        _close(r["dec_attn"], want["dec_attn"])
        _close(r["dec_attn_odd"], want["dec_attn_odd"])


@pytest.mark.parametrize("name", ["mamba", "rglru"])
@pytest.mark.parametrize("seq", [True, False])
def test_recurrent_block_matches_jax(world, name, seq):
    _, want, res = world
    wy, wc = want[f"{name}_{seq}"]
    for r in res:
        (y, cache), gl, gd = r[f"{name}_{seq}"]
        _close(y, wy)
        _close(cache["h"], wc["h"])
        _close(cache["conv"], wc["conv"])
        for a, b in zip(gd, gl):
            _close(a, b.numpy())
        fy, _ = r[f"{name}_fallback"]
        _close(fy, want[f"{name}_fallback"][0])


def test_mamba_block_from_a_start_state_matches_jax(world):
    _, want, res = world
    wy, wc = want["mamba_h0"]
    for r in res:
        for key in ("mamba_h0_dist", "mamba_h0_local"):
            y, cache = r[key]
            _close(y, wy, 1e-4)
            _close(cache["h"], wc["h"], 1e-4)


def test_decode_step_matches_jax(world):
    _, want, res = world
    for r in res:
        _close(r["yi_decode"], want["yi_decode"])


def test_train_step_matches_local_and_jax(world):
    inp, want, res = world
    tr = inp["yi_train"][2]
    wl, wg = want["yi_train"]
    flat_w = dict(tree_lib.flatten_with_path(
        jax.tree.map(np.asarray, wg)))
    for r in res:
        yt = r["yi_train"]
        (ll, ld), (gl, gd) = yt["loss"], yt["grads"]
        assert abs(float(ld) - float(ll)) <= 1e-5 * abs(float(ll))
        assert abs(float(ld) - float(wl)) <= 1e-5 * abs(float(wl))
        for path, g in tree_lib.flatten_with_path(gd):
            w = flat_w[path]
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale, path
        for (path, a), b in zip(tree_lib.flatten_with_path(gd),
                                tree_lib.leaves(gl)):
            _close(a, b.numpy())
        # the Adam update of the rank's gradient, held above against the
        # local and the JAX gradients (the tensor-parallel partial sums
        # round differently from the local products, and an element whose
        # gradient is near zero moves by about lr on that rounding)
        t_dist = yt["after"]
        step, _ = optim.adam_update(gd, optim.adam_init(tr), tr, lr=1e-3,
                                    grad_clip=1.0)
        for a, b in zip(tree_lib.leaves(t_dist), tree_lib.leaves(step)):
            _close(a, b.numpy(), 1e-6)


def test_dist_traces_name_each_body_and_fallback(world):
    _, _, res = world
    for r in res:
        tr = r["dist_traces"]
        for name in ("moe_ffn_dist_seq", "moe_ffn_dist_decode",
                     "flash_attention_dist", "decode_attention_dist",
                     "flash_attention_heads_dist", "linear_col_dist",
                     "linear_row_dist", "embed_vocab_dist", "mamba_block_dist",
                     "mamba_block_fallback", "rglru_block_dist",
                     "rglru_block_fallback"):
            assert tr.get(name, 0) >= 1, (name, tr)
