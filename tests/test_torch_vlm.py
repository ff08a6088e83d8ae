"""The port's VLM family (image embeddings prepended to the tokens,
labels and mask over patches and tokens, decode positions offset by the
patches) against the JAX package, on the CPU, at reduced LLaVA-NeXT-34B
(16 patches, 2 layers).

Weights come from the JAX ``init_params(PRNGKey(0))`` through
``repro_torch.convert``, the trainables perturbed with seeded numpy
noise. Tolerances, fp32: logits, grads (leaf by leaf), prefill and
decode logits and caches within 1e-4 of the largest magnitude, as
tests/test_torch_configs.py holds the dense decoders; the loss within
1e-5; Adam on the same grads within 1e-6; the serve-consistency
property within 5e-3; the NF4 backbone bitwise. The trainer's CLI
trains text-only in both packages (its batch has no image embeddings)."""
import functools

import numpy as np
import torch

from _jax_zoo import NF4, Case, check_client_update, check_nf4_backbone

torch.set_num_threads(1)
ARCH = "llava-next-34b"


@functools.lru_cache(maxsize=None)
def _case(name):
    return Case(ARCH, **(NF4 if name == "nf4" else {}))


def test_forward_loss_grads_and_step_match_jax():
    """On the NF4 backbone, over 16 patches and 17 tokens."""
    c = _case("nf4")
    grads = c.check_train()
    assert {"wg", "wu", "wd"} <= set(grads["lora"])
    _, tb = c.batch(0)
    assert tb["labels"].shape[1] == c.cfg.n_patches + tb["tokens"].shape[1]


def test_prefill_and_decode_match_jax():
    """The prompt after 16 patches; decode positions from 16 + 9."""
    c = _case("fp32")
    cache = c.check_decode(P=9, steps=4)
    # the ring holds patches and tokens: 16 + 9 + 4 slots, all written
    sp = cache["scan"]["kv"]["slot_pos"][0]
    np.testing.assert_array_equal(sp.numpy(),
                                  np.arange(c.cfg.n_patches + 13))


def test_text_only_batch_is_the_dense_path():
    """Without image embeddings the VLM is its text decoder, as in the
    JAX package (its trainer's batches are text-only)."""
    c = _case("fp32")
    jb, tb = c.batch(2, S_tok=12, train_=False)
    jb = {"tokens": jb["tokens"]}
    jl, _ = c.forward(c.frozen, c.tr, jb)
    with torch.no_grad():
        tl, _ = c.tm.forward(c.tf, c.ttr, {"tokens": tb["tokens"]})
    assert tl.shape == (2, 12, c.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=1e-4 * np.abs(np.asarray(jl)).max())


def test_serve_consistency():
    _case("fp32").check_serve_consistency()


def test_nf4_backbone_is_bitwise_quantize_tree():
    check_nf4_backbone(ARCH)


def test_trainer_runs_the_vlm_text_only():
    check_client_update(_case("nf4"))
