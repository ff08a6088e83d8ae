"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

Module names mirror ``src/repro/`` one for one, so every port module
names its counterpart there. Parameter trees are nested dicts in the JAX
tree layout (stacked ``blocks`` with a leading layer axis), so weights
convert structurally (:mod:`repro_torch.convert`). The Pallas TPU kernels
on the ported path are hand-written CUDA C++ for ``sm_90a`` under
``repro_torch/kernels/csrc`` with a plain PyTorch version beside each one
(``repro_torch.kernels.ref``), which is also the CPU path.

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit device they raise.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point works on: ``device`` when given, else
    the current CUDA device. Never silently the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return torch.device("cuda")


def spec(shape, dtype=torch.float32) -> torch.Tensor:
    """A shape-only stand-in for a tensor (the JAX package's
    ``ShapeDtypeStruct``): a ``meta`` tensor, sizes and dtype, no data."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")
