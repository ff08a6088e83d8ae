"""Architecture config registry, port of ``repro.configs``.

``get_config(arch_id)`` returns the exact assigned configuration and
``get_reduced(arch_id)`` the CPU smoke-test variant of the same family.
The port carries the configs of the families it runs (the dense
decoders, the Mamba-1 SSM ``falcon-mamba-7b``, and ``clip-b32``'s
trunk); an arch of a family that is not
ported yet raises ``NotImplementedError`` naming the ROADMAP slice that
brings it.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape,  # noqa: F401
                                      ModelConfig)

_MODULES = {
    "yi-9b": "yi_9b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "starcoder2-15b": "starcoder2_15b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "clip-b32": "clip_b32",
}

# arch -> (family, the ROADMAP slice that ports it)
_UNPORTED = {
    "qwen3-moe-235b-a22b": ("moe", "the large-model zoo's other families "
                            "(ROADMAP Queue A item 8.4)"),
    "kimi-k2-1t-a32b": ("moe", "the large-model zoo's other families "
                        "(ROADMAP Queue A item 8.4)"),
    "recurrentgemma-2b": ("hybrid", "the large-model zoo's other families "
                          "(ROADMAP Queue A item 8.4)"),
    "whisper-medium": ("encdec", "the large-model zoo's other families "
                       "(ROADMAP Queue A item 8.4)"),
    "llava-next-34b": ("vlm", "the large-model zoo's other families "
                       "(ROADMAP Queue A item 8.4)"),
}

ARCHS = tuple(k for k in (*_MODULES, *_UNPORTED) if k != "clip-b32")


def _module(arch: str):
    if arch in _UNPORTED:
        fam, slice_ = _UNPORTED[arch]
        raise NotImplementedError(
            f"{arch}: the {fam} family is not ported yet; it comes with "
            f"{slice_}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted((*_MODULES, *_UNPORTED))}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
