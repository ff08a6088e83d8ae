"""CUDA flash attention, port of ``repro.kernels.flash_attention``.

``flash_attention(q, k, v)`` runs blocked online-softmax attention on
the card (source: ``csrc/flash_attention.cu``) with the Pallas kernel's
layout and masks: q ``(B, S, H, D)``, k/v ``(B, Skv, Hkv, D)``, GQA
through ``h // (H / Hkv)``, causal, sliding ``window``, and a key
length ``Skv`` of its own (cross-attention). Any D up to 1024 (the
adapter's D is 192 at CLIP ViT-B/32 width, 512 at Yi-9B width and 896 at
LLaVA-NeXT-34B width); above 512 both instantiations take a path of
their own with fewer keys staged at a time (``csrc/flash_attention.cu``).
The plain version is :func:`repro_torch.kernels.ref.flash_attention`; the
gradient is ``kernels.ops.flash_attention``'s ``autograd.Function``.
Two instantiations, chosen here by dtype and counted: bf16 runs the
tensor-core kernel (``flash_attention_tc_launch``; ``tc_launches``
counts it), fp32 the CUDA-core one (``flash_attention_launch``), which
keeps fp32 callers at 1e-5. Neither stands in for the other: an input
the chosen kernel refuses raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

MAX_D = 1024
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
         _P)


def uses_tensor_cores(t: torch.Tensor) -> bool:
    """Whether a call on ``t``'s dtype takes the tensor-core kernel."""
    return t.dtype == torch.bfloat16


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Skv, Hkv, D) -> (B, S, H, D)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}/{k.device}/{v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one f32/bf16 dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, S, H, D = q.shape
    _, Skv, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or H % Hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if D > MAX_D:
        raise NotImplementedError(f"flash_attention kernel: D={D} > {MAX_D}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    tc = uses_tensor_cores(q)
    fn = build.function("flash_attention", "flash_attention_tc_launch" if tc
                        else "flash_attention_launch", _ARGS)
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   B, S, Skv, H, Hkv, D, 1.0 / math.sqrt(D), int(causal),
                   0 if window is None else int(window),
                   torch.cuda.current_stream(q.device).cuda_stream),
                "flash_attention")
    flash_attention.launches += 1
    flash_attention.tc_launches += int(tc)
    return o


flash_attention.launches = 0
flash_attention.tc_launches = 0
