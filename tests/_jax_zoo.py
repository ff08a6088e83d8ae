"""Shared pieces of the zoo families' parity tests
(tests/test_torch_{rglru,moe,encdec,vlm}.py): one reduced config built in
both packages on the JAX package's weights, the JAX side's step, prefill
and decode jitted once, and the comparisons. A helper module, not
collected."""
from __future__ import annotations

import contextlib
import io
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_reduced
from repro.core import optim as joptim
from repro.core import quant as jq
from repro.launch import train as jtrain
from repro.models import build_model as j_build
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced
from repro_torch.core import optim, quant as qlib
from repro_torch.launch import train
from repro_torch.models import build_model

NF4 = dict(quant_bits=4, quant_mode="nf4", quant_block=64)
ARCH_OF = {j_reduced(a).name: a for a in ("recurrentgemma-2b",
                                          "qwen3-moe-235b-a22b",
                                          "kimi-k2-1t-a32b",
                                          "whisper-medium",
                                          "llava-next-34b")}


def to_port(tree):
    return convert.tree_from_numpy(tree, "cpu")


def rel(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(float(np.abs(w).max()), 1e-30))


def assert_tree_close(got_tree, want_tree, rtol, what):
    """Leaf for leaf (same paths), each within ``rtol`` of the JAX leaf's
    largest magnitude; int leaves equal."""
    got = dict(tree_lib.flatten_with_path(got_tree))
    want = dict(tree_lib.flatten_with_path(
        convert.tree_to_numpy(to_port(want_tree))))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, (what, path)
        if not g.dtype.is_floating_point:
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{what} {path}")
            continue
        scale = max(1e-6, float(np.abs(w).max()))
        np.testing.assert_allclose(g.detach().to(torch.float32).numpy(), w,
                                   atol=rtol * scale, rtol=0,
                                   err_msg=f"{what} {path}")


class Case:
    """``arch``'s reduced config (with ``replace``) in both packages on
    the JAX ``init_params(PRNGKey(seed))``, the trainables perturbed with
    seeded numpy noise so that the zero-init LoRA B and adapter wo/w2
    carry signal; the JAX step functions jitted once."""

    def __init__(self, arch, seed=0, **replace):
        self.jcfg = j_reduced(arch).replace(**replace)
        self.cfg = get_reduced(arch).replace(**replace)
        self.jm = j_build(self.jcfg)
        self.tm = build_model(self.cfg)
        params = jax.jit(self.jm.init_params)(jax.random.PRNGKey(seed))
        rs = np.random.RandomState(seed + 1)
        self.frozen = params["frozen"]
        self.tr = jax.tree.map(lambda l: l + jnp.asarray(
            rs.randn(*l.shape) * 0.05, l.dtype), params["trainable"])
        self.tf, self.ttr = to_port(self.frozen), to_port(self.tr)
        jm = self.jm
        self.grad_fn = jax.jit(jax.value_and_grad(
            lambda t, f, b: jm.loss_fn(f, t, b), has_aux=True))
        self.forward = jax.jit(jm.forward)
        self.prefill = jax.jit(jm.prefill, static_argnames=("max_len",))
        self.decode = jax.jit(jm.decode_step)

    def batch(self, seed, B=2, S_tok=17, train_=True):
        """(JAX batch, port batch): tokens, plus labels and mask over the
        whole sequence (patches included) with ``train_``, plus the
        family's frames or image embeddings, numpy from ``seed``."""
        cfg = self.jcfg
        rs = np.random.RandomState(seed)
        S = S_tok + (cfg.n_patches if cfg.family == "vlm" else 0)
        b = {"tokens": rs.randint(0, cfg.vocab_size, (B, S_tok))
             .astype(np.int32)}
        if train_:
            b["labels"] = rs.randint(0, cfg.vocab_size, (B, S)) \
                .astype(np.int32)
            b["mask"] = (rs.rand(B, S) > 0.1).astype(np.float32)
        if cfg.family == "vlm":
            b["image_embeds"] = (rs.randn(B, cfg.n_patches, cfg.d_model)
                                 * 0.02).astype(np.float32)
        if cfg.family == "encdec":
            b["frames"] = (rs.randn(B, cfg.n_frames, cfg.d_model)
                           * 0.02).astype(np.float32)
        return ({k: jnp.asarray(v) for k, v in b.items()},
                {k: torch.from_numpy(v) for k, v in b.items()})

    # ------------------------------------------------------------ checks
    def check_train(self, seed=3, rtol=1e-4):
        """forward's logits and aux, loss_fn, the grads (each leaf within
        ``rtol`` of its largest magnitude), one Adam step on the same
        grads (1e-6) and ``train_step``'s loss and grad norm."""
        jb, tb = self.batch(seed)
        jlogits, jaux = self.forward(self.frozen, self.tr, jb)
        (jloss, jparts), jgrads = self.grad_fn(self.tr, self.frozen, jb)
        with torch.no_grad():
            logits, aux = self.tm.forward(self.tf, self.ttr, tb)
        want = np.asarray(jlogits)
        assert logits.shape == want.shape
        np.testing.assert_allclose(logits.numpy(), want,
                                   atol=rtol * np.abs(want).max())
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                                   atol=1e-7)
        (loss, parts), grads = self.tm.grads(self.tf, self.ttr, tb)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                                   rtol=1e-5, atol=1e-7)
        assert_tree_close(grads, jgrads, rtol, "grad")
        jtr2, jopt2 = joptim.adam_update(jgrads, joptim.adam_init(self.tr),
                                         self.tr, lr=1e-3, grad_clip=1.0)
        tr2, opt2 = optim.adam_update(to_port(jgrads),
                                      optim.adam_init(self.ttr), self.ttr,
                                      lr=1e-3, grad_clip=1.0)
        assert_tree_close(tr2, jtr2, 1e-6, "params after one Adam step")
        assert_tree_close(opt2.nu, jopt2.nu, 1e-6, "Adam nu")
        _, _, m = self.tm.train_step(self.tf, self.ttr,
                                     optim.adam_init(self.ttr), tb, lr=1e-3)
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(joptim.global_norm(jgrads)),
                                   rtol=1e-4)
        return grads

    def check_decode(self, P=9, steps=4, seed=5, rtol=1e-4):
        """A prefill of P tokens (after the patches / against the frames)
        and ``steps`` teacher-forced decode steps in both packages: every
        step's logits within ``rtol`` of the largest, the caches leaf for
        leaf. Returns the port's final cache."""
        cfg = self.jcfg
        jb, tb = self.batch(seed, S_tok=P + steps, train_=False)
        off = cfg.n_patches if cfg.family == "vlm" else 0
        max_len = off + P + steps
        pre = lambda b: {**b, "tokens": b["tokens"][:, :P]}
        jl, jc = self.prefill(self.frozen, self.tr, pre(jb), max_len=max_len)
        tl, tc = self.tm.prefill(self.tf, self.ttr, pre(tb), max_len=max_len)
        assert rel(tl.numpy(), jl) <= rtol, ("prefill", rel(tl.numpy(), jl))
        for i in range(steps):
            tok = jb["tokens"][:, P + i:P + i + 1]
            jl, jc = self.decode(self.frozen, self.tr, jc, tok,
                                 jnp.asarray(off + P + i, jnp.int32))
            tl, tc2 = self.tm.decode_step(
                self.tf, self.ttr, tc, torch.from_numpy(np.array(tok)),
                torch.tensor(off + P + i, dtype=torch.int32))
            assert tc2 is tc
            assert rel(tl.numpy(), jl) <= rtol, (i, rel(tl.numpy(), jl))
        assert_tree_close(tc, jc, rtol, "cache")
        init = self.tm.init_cache(2, max_len, device="cpu")
        want = self.jm.init_cache(2, max_len)
        assert_tree_close(init, want, 0.0, "init_cache")
        return tc

    def check_serve_consistency(self, seed=6, S_tok=17, **replace):
        """tests/test_models_smoke.py::test_serve_consistency on the port,
        on the case's weights with the config's ``replace`` (MoE: a
        no-drop capacity factor, as there): prefill(S-1) + decode(last)
        equals the training forward's last logits within 5e-3."""
        cfg = self.jcfg
        tm = build_model(self.cfg.replace(**replace))
        _, tb = self.batch(seed, S_tok=S_tok)
        S = S_tok + (cfg.n_patches if cfg.family == "vlm" else 0)
        with torch.no_grad():
            want, _ = tm.forward(self.tf, self.ttr, tb)
        pre = {k: v for k, v in tb.items()
               if k in ("tokens", "image_embeds", "frames")}
        pre["tokens"] = tb["tokens"][:, :-1]
        _, cache = tm.prefill(self.tf, self.ttr, pre, max_len=S)
        got, _ = tm.decode_step(self.tf, self.ttr, cache,
                                tb["tokens"][:, -1:],
                                torch.tensor(S - 1, dtype=torch.int32))
        assert rel(got.numpy(), want[:, -1].numpy()) < 5e-3


def check_nf4_backbone(arch):
    """The NF4 backbone: the JAX package's dense layer trees quantized by
    both packages' ``quantize_tree`` bitwise equal, and the port's own
    per-layer draw-and-quantize init bitwise its ``quantize_tree`` of
    its dense init (QTensor fields included, experts' and gates'
    leading dims too). Returns the port's quantized frozen tree."""
    jm = j_build(j_reduced(arch))
    dense = jax.jit(jm.init_params)(jax.random.PRNGKey(0))["frozen"]
    keys = [k for k in ("layers", "dense_layers", "enc_layers") if k in dense]
    quantize = jax.jit(lambda t: jq.quantize_tree(t, bits=4, block=64,
                                                  mode="nf4"))
    for k in keys:
        want = quantize(dense[k])
        got = qlib.quantize_tree(to_port(dense[k]), bits=4, block=64,
                                 mode="nf4")
        _equal_trees(got, to_port(want))
    cfg = get_reduced(arch)
    quant = build_model(cfg.replace(**NF4)).init_params(
        torch.Generator().manual_seed(3), device="cpu")["frozen"]
    plain = build_model(cfg).init_params(
        torch.Generator().manual_seed(3), device="cpu")["frozen"]
    for k in keys:
        _equal_trees(quant[k], qlib.quantize_tree(plain[k], bits=4,
                                                  block=64, mode="nf4"))
    return quant


def _equal_trees(got_tree, want_tree):
    got = dict(tree_lib.flatten_with_path(got_tree))
    want = dict(tree_lib.flatten_with_path(want_tree))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, qlib.QTensor):
            assert isinstance(g, qlib.QTensor), path
            assert (g.bits, g.mode, g.block, g.out_dtype,
                    tuple(g.orig_shape)) == (w.bits, w.mode, w.block,
                                             w.out_dtype,
                                             tuple(w.orig_shape)), path
            assert torch.equal(g.q, w.q) and torch.equal(g.scales, w.scales), \
                path
        else:
            assert torch.equal(g, w), path


def check_client_update(c: Case):
    """One client's local step (2 x 16 tokens, int8 uplink) through the
    port's ``client_update`` on the case's weights: its loss is the JAX
    package's loss on the same batch within 1e-5, and its uplink's byte
    count the JAX quantizer's on the same tree; then the port's trainer
    CLI runs one round of the arch's reduced NF4 config on the CPU."""
    arch = ARCH_OF[c.jcfg.name]
    data = jtrain.synthetic_token_stream(np.random.RandomState(0),
                                         c.jcfg.vocab_size, 1, seq=16)[0]
    _, tbytes, tloss, _, _ = train.client_update(
        c.tm, c.tf, c.ttr, data, steps=1, batch=2, lr=1e-3, comm_bits=8,
        seed=0)
    toks = data[np.random.RandomState(0).randint(0, len(data), 2)]
    (jloss, _), _ = c.grad_fn(c.tr, c.frozen, {
        "tokens": toks[:, :-1], "labels": toks[:, 1:],
        "mask": np.ones(toks[:, 1:].shape, np.float32)})
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5)
    jdelta = jq.quantize_tree(jax.tree.map(jnp.zeros_like, c.tr), bits=8,
                              block=64, min_size=256, skip_names=("slot",))
    assert tbytes == jq.tree_bytes(jdelta)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", arch, "--rounds", "1", "--clients", "2",
                    "--local-steps", "1", "--seq", "16"], device="cpu")
    out = buf.getvalue()
    assert f"family={c.cfg.family}" in out and "round 0:" in out, out


def jax_trainer_main(argv, monkeypatch):
    """The JAX package's trainer CLI with ``argv``."""
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with contextlib.redirect_stdout(io.StringIO()):
        jtrain.main()
