"""Low-rank adaptation, port of ``repro.core.lora``.

A LoRA pair for a frozen weight W (k, n) is {A: (k, r), B: (r, n)}; the
effective weight is W + (alpha/r)·A@B. A is Kaiming-init, B zero-init so
training starts at the pretrained function. A pair may carry a leading
batch axis (A ``(T, k, r)``) to give every row of a stacked tenant batch
its own factors. ``linear`` is differentiable in x, A and B: with a
quantized W its gradient runs through the ``autograd.Function`` of
``kernels.ops.lora_matmul`` (the fused kernels on the card).
"""
from __future__ import annotations

import math

import torch

from repro_torch import spec
from repro_torch.core.quant import QTensor, maybe_dequantize
from repro_torch.kernels import ops as kops


def init_pair(generator: torch.Generator, k: int, n: int, rank: int, *,
              dtype=torch.float32, lead=(), device=None):
    """A ``(*lead, k, rank)`` drawn N(0, 1/k) from ``generator``, B
    ``(*lead, rank, n)`` zeros, on ``device`` (the generator's device
    when None)."""
    dev = generator.device if device is None else torch.device(device)
    a = torch.randn((*lead, k, rank), generator=generator,
                    device=generator.device) * (1.0 / math.sqrt(k))
    return {"a": a.to(device=dev, dtype=dtype),
            "b": torch.zeros((*lead, rank, n), dtype=dtype, device=dev)}


def pair_specs(k: int, n: int, rank: int, *, dtype=torch.float32, lead=()):
    """The shapes of :func:`init_pair`'s pair as ``meta`` tensors (the
    dry run's parameter trees)."""
    return {"a": spec((*lead, k, rank), dtype),
            "b": spec((*lead, rank, n), dtype)}


def apply(x: torch.Tensor, lora, *, alpha: float, rank: int) -> torch.Tensor:
    """The low-rank delta (alpha/r)·(x@A)@B in fp32, cast back to x's
    dtype (x and both factors are upcast, as in the JAX package)."""
    s = alpha / rank
    xf = x.to(torch.float32)
    h = torch.matmul(xf, lora["a"].to(torch.float32))
    d = torch.matmul(h, lora["b"].to(torch.float32))
    return (d * s).to(x.dtype)


def linear(x: torch.Tensor, w, lora=None, *, alpha: float = 32.0,
           rank: int = 16) -> torch.Tensor:
    """y = x @ W(+dequant) [+ LoRA delta]; ``w`` may be a QTensor. With a
    LoRA pair the base and the delta go through the one fused op
    (``kernels.ops.lora_matmul``), fp32 accumulation."""
    if lora is not None:
        kops.trace_count("lora_linear_fused")
        return kops.lora_matmul(x, w, lora["a"], lora["b"],
                                scale=alpha / rank)
    if isinstance(w, QTensor):
        return kops.quant_matmul(x, w)
    return torch.matmul(x, w.to(x.dtype))


def merge(w, lora, *, alpha: float, rank: int) -> torch.Tensor:
    """Fold the LoRA delta into a dense weight (for deployment/eval)."""
    wd = maybe_dequantize(w, torch.float32)
    return wd + (alpha / rank) * lora["a"].to(torch.float32) @ \
        lora["b"].to(torch.float32)
