"""Dispatch for the kernel ops, port of ``repro.kernels.ops``.

Each op dispatches on its tensor's device: a CPU tensor takes the plain
PyTorch version in ``kernels.ref``, a CUDA tensor launches the hand-
written kernel (built on first use) and raises if it cannot build or
launch. There is no fallback from the kernel to the plain version.

``KERNEL_TRACES`` counts which implementation each call took (the JAX
package counts at trace time; PyTorch runs eagerly, so here it is per
call), and every kernel wrapper keeps its own integer ``launches``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import quant as qlib
from repro_torch.kernels import blockwise_quant as bq_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import quant_matmul as qmm_kernel
from repro_torch.kernels import ref

KERNEL_TRACES: Dict[str, int] = {}

# the CUDA kernel wrappers, each with its ``launches`` count
KERNELS = {
    "quant_matmul": qmm_kernel.quant_matmul,
    "blockwise_quant": bq_kernel.blockwise_quant,
    "flash_attention": fa_kernel.flash_attention,
}


def trace_count(name: str, n: int = 1) -> None:
    KERNEL_TRACES[name] = KERNEL_TRACES.get(name, 0) + int(n)


def reset_kernel_traces() -> None:
    KERNEL_TRACES.clear()


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"{op}: no kernel for device {t.device}")


def flash_attention(q, k, v, *, causal=True, window=None):
    if _on_cuda(q, "flash_attention"):
        trace_count("flash_attention_cuda")
        return fa_kernel.flash_attention(q, k, v, causal=causal,
                                         window=window)
    trace_count("flash_attention_ref")
    return ref.flash_attention(q, k, v, causal=causal, window=window)


def quant_matmul(x, qt: qlib.QTensor):
    # qt.q.ndim == 3: a plain 2-D weight; 4: a stacked (per-user) one
    if _on_cuda(x, "quant_matmul"):
        trace_count("quant_matmul_cuda" if qt.q.ndim == 3
                    else "quant_matmul_cuda_stacked")
        return qmm_kernel.quant_matmul(x, qt)
    trace_count("quant_matmul_ref")
    return ref.quant_matmul(x, qt)


def lora_matmul(x, w, a, b, *, scale: float):
    """``y = x @ W + scale·(x@A)@B`` with fp32 accumulation. A dense W
    is plain PyTorch on every device, as the JAX package computes that
    branch outside any Pallas kernel. A QTensor W on the card needs the
    fused LoRA kernel, which is not ported yet."""
    if isinstance(w, qlib.QTensor) and _on_cuda(x, "lora_matmul"):
        raise NotImplementedError(
            "lora_matmul with a quantized W on CUDA: fused LoRA kernel not "
            "yet ported")
    trace_count("lora_matmul_ref")
    return ref.lora_matmul(x, w, a, b, scale=float(scale))


def blockwise_quant(x, *, bits=8, block=128, mode="linear"):
    if _on_cuda(x, "blockwise_quant"):
        if x.ndim != 2 or mode != "linear":
            raise NotImplementedError(
                f"blockwise_quant kernel: ndim={x.ndim} mode={mode!r} "
                "(the kernel takes 2-D linear int8/int4)")
        trace_count("blockwise_quant_cuda")
        return bq_kernel.blockwise_quant(x, bits=bits, block=block)
    trace_count("blockwise_quant_ref")
    return ref.blockwise_quant(x, bits=bits, block=block, mode=mode)
