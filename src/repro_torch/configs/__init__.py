"""Architecture config registry, port of ``repro.configs``.

``get_config(arch_id)`` returns the exact assigned configuration and
``get_reduced(arch_id)`` the CPU smoke-test variant of the same family.
The port carries every config of the JAX package: the dense decoders,
the Mamba-1 SSM ``falcon-mamba-7b``, the RG-LRU hybrid
``recurrentgemma-2b``, the MoE ``qwen3-moe-235b-a22b`` and
``kimi-k2-1t-a32b``, the encoder-decoder ``whisper-medium``, the VLM
``llava-next-34b`` and ``clip-b32``'s trunk, so ``ARCHS`` is
``repro.configs.ARCHS``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape,  # noqa: F401
                                      ModelConfig)

_MODULES = {
    "yi-9b": "yi_9b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "whisper-medium": "whisper_medium",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llava-next-34b": "llava_next_34b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "starcoder2-15b": "starcoder2_15b",
    "clip-b32": "clip_b32",
}

ARCHS = tuple(k for k in _MODULES if k != "clip-b32")


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
