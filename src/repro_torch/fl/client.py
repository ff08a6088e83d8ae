"""FL client, port of ``repro.fl.client``: the trainable tree and the
forward to zero-shot class logits. ``Client`` and local training come
with the training slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.core import adapter as adapter_lib
from repro_torch.core import clip as clip_lib
from repro_torch.fl.strategies import Strategy

LORA_RANK = 4


def init_trainable(generator: torch.Generator, ccfg: clip_lib.CLIPConfig,
                   strategy: Strategy, device=None):
    """The attention adapter, plus rank-4 LoRA pairs on wq/wk/wv/wo of
    every vision block (stacked on the layer axis) for LoRA arms."""
    dev = resolve_device(device)
    d = ccfg.d_model
    tr: Dict[str, Any] = {"adapter": adapter_lib.init(
        generator, d, n_heads=4, d_ff=d, device=dev)}
    if strategy.use_lora:
        L = ccfg.vision_layers

        def pair():
            a = torch.randn((L, d, LORA_RANK), generator=generator,
                            device=generator.device) * (1 / math.sqrt(d))
            return {"a": a.to(dev),
                    "b": torch.zeros((L, LORA_RANK, d), device=dev)}

        tr["lora"] = {n: pair() for n in ("wq", "wk", "wv", "wo")}
    return tr


def head_logits(frozen, trainable, feat, class_emb):
    """Pooled backbone features -> zero-shot class logits through the
    trainable adapter head."""
    feat = adapter_lib.apply(trainable["adapter"], feat[:, None, :],
                             n_heads=4, causal=False)[:, 0]
    emb = feat @ frozen["proj_v"]
    return clip_lib.zero_shot_logits(emb, class_emb, frozen["logit_scale"])


def forward_logits(frozen, trainable, ccfg, images, class_emb):
    """images -> zero-shot class logits through backbone+adapter."""
    lora = trainable.get("lora")
    feat = clip_lib.encode_image(frozen, ccfg, images, lora=lora)
    return head_logits(frozen, trainable, feat, class_emb)
