"""CUDA flash attention, port of ``repro.kernels.flash_attention``.

``flash_attention(q, k, v)`` runs blocked online-softmax attention on
the card (source: ``csrc/flash_attention.cu``) with the Pallas kernel's
layout and masks: q ``(B, S, H, D)``, k/v ``(B, Skv, Hkv, D)``, GQA
through ``h // (H / Hkv)``, causal, sliding ``window``, and a key
length ``Skv`` of its own (cross-attention). Any D up to 1024 (the
adapter's D is 192 at CLIP ViT-B/32 width, 512 at Yi-9B width and 896 at
LLaVA-NeXT-34B width); above 512 the fp32 kernel stages fewer keys at a
time (``csrc/flash_attention.cu``).
The plain version is :func:`repro_torch.kernels.ref.flash_attention`; the
gradient is ``kernels.ops.flash_attention``'s ``autograd.Function``.
Three routes, chosen here by :func:`route` and counted: bf16 runs the
tensor-core kernels (``flash_attention_tc_launch``; ``tc_launches``
counts them), up to D = 512 ``flash_tc_kernel`` (``"tc"``), above it
``flash_tc_cluster_kernel`` (``"tc_cluster"``: the ⌈Dp/128⌉ D-slice
blocks of a q-tile as one thread-block cluster that forms each score
block once, its slices' partial scores summed in rank order through
distributed shared memory; ``cluster_launches``); fp32 runs the
CUDA-core one (``flash_attention_launch``, ``"cuda"``), which keeps fp32
callers at 1e-5. None stands in for another: an input the chosen kernel
refuses raises. ``_flash_attention(..., force="tc_single")`` runs the
earlier single-stage D > 512 instantiation on a bf16 input, only for the
card's A/B against the cluster route.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

MAX_D = 1024
# the tensor-core kernels' D: up to MAX_D_STAGED the two-stage
# flash_tc_kernel, above it the cluster of D-slice blocks, DV columns of
# the output (and dims of the scores) a block (csrc/flash_attention.cu)
MAX_D_STAGED = 512
DV = 128
MAX_CLUSTER = 8
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
         _P)
_TC_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
            _I, _P)
_TC_ROUTES = {"tc": 0, "tc_cluster": 0, "tc_single": 1}


def uses_tensor_cores(t: torch.Tensor) -> bool:
    """Whether a call on ``t``'s dtype takes the tensor-core kernel."""
    return t.dtype == torch.bfloat16


def cluster_size(D: int) -> int:
    """The D-slice blocks of one q-tile, the cluster of the D > 512 route:
    ⌈Dp / 128⌉ with Dp = D rounded up to 16."""
    return -(-(-(-D // 16) * 16) // DV)


def route(D: int, dtype: torch.dtype) -> str:
    """The kernel a call of head dim D and ``dtype`` runs: ``"cuda"`` for
    fp32, else ``"tc"`` up to D = 512 and ``"tc_cluster"`` above."""
    if dtype != torch.bfloat16:
        return "cuda"
    return "tc" if -(-D // 16) * 16 <= MAX_D_STAGED else "tc_cluster"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Skv, Hkv, D) -> (B, S, H, D)."""
    return _flash_attention(q, k, v, causal=causal, window=window)


def _flash_attention(q, k, v, *, causal=True, window=None, force=None):
    """:func:`flash_attention` on :func:`route`'s kernel, or with
    ``force="tc_single"`` on the single-stage tensor-core instantiation
    (a bf16 input; the card's A/B)."""
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
    how = route(D, q.dtype)
    if force is not None:
        if force != "tc_single" or how == "cuda":
            raise ValueError(f"flash_attention: only the single-stage "
                             f"tensor-core route can be forced, and only "
                             f"for bf16, not {force!r} on {q.dtype}")
        how = force
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S,
            Skv, H, Hkv, D, 1.0 / math.sqrt(D), int(causal),
            0 if window is None else int(window)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if how == "cuda":
        fn = build.function("flash_attention", "flash_attention_launch",
                            _ARGS)
        rc = fn(*args, stream)
    else:
        fn = build.function("flash_attention", "flash_attention_tc_launch",
                            _TC_ARGS)
        rc = fn(*args, _TC_ROUTES[how], stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.tc_launches += int(how != "cuda")
    flash_attention.cluster_launches += int(how == "tc_cluster")
    return o


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.cluster_launches = 0
