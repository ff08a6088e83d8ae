"""Low-rank adaptation, port of ``repro.core.lora`` (forward only).

A LoRA pair for a frozen weight W (k, n) is {A: (k, r), B: (r, n)}; the
effective weight is W + (alpha/r)·A@B. A pair may carry a leading batch
axis (A ``(T, k, r)``) to give every row of a stacked tenant batch its own
factors. The ``autograd.Function`` for the fused op's gradient comes with
the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor, maybe_dequantize
from repro_torch.kernels import ops as kops


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
