"""The port's MoE family with unrolled dense layers and a shared expert
(reduced Kimi-K2: one first dense layer, 4 experts top-2, one shared
expert) against the JAX package, on the CPU; the routing modules and
reduced Qwen3-MoE are tests/test_torch_moe.py's.

The model runs on the JAX ``init_params(PRNGKey(0))`` through
``repro_torch.convert``, trainables perturbed. Tolerances (fp32):
logits, grads (leaf by leaf), prefill and decode logits and caches
within 1e-4 of the largest magnitude, loss and aux within 1e-5, Adam on
the same grads within 1e-6; the serve-consistency property within 5e-3
at a no-drop capacity factor of 8, as the JAX package's test runs it;
the NF4 backbone bitwise, the dense layer's list included."""
import functools

import torch

from _jax_zoo import NF4, Case, check_client_update, check_nf4_backbone
from repro_torch.core import quant as qlib

torch.set_num_threads(1)
KIMI = "kimi-k2-1t-a32b"


@functools.lru_cache(maxsize=None)
def _case(name):
    return Case(KIMI, **(NF4 if name == "nf4" else {}))


def test_forward_loss_grads_and_step_match_jax():
    """On the NF4 backbone: the experts, the dense layer and the shared
    expert (frozen projections without LoRA) decoded from the same codes
    in both packages."""
    grads = _case("nf4").check_train()
    assert sorted(grads["lora"]) == ["wk", "wo", "wq", "wv"]
    assert isinstance(grads["dense_lora"], list) and \
        len(grads["dense_lora"]) == 1


def test_prefill_and_decode_match_jax():
    cache = _case("fp32").check_decode()
    assert cache["dense"]["kv"]["k"].shape[0] == 1


def test_serve_consistency():
    _case("fp32").check_serve_consistency(capacity_factor=8.0)


def test_nf4_backbone_is_bitwise_quantize_tree():
    frozen = check_nf4_backbone(KIMI)
    assert isinstance(frozen["dense_layers"], list)
    assert isinstance(frozen["dense_layers"][0]["wd"], qlib.QTensor)
    assert isinstance(frozen["layers"]["shared"]["wd"], qlib.QTensor)
    assert frozen["layers"]["moe"]["wd"].q.ndim == 5


def test_trainer_runs_the_moe_with_dense_layers():
    check_client_update(_case("nf4"))
