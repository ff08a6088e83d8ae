"""CUDA flash attention, port of ``repro.kernels.flash_attention``.

``flash_attention(q, k, v)`` runs blocked online-softmax attention on
the card (source: ``csrc/flash_attention.cu``) with the Pallas kernel's
layout and masks: q ``(B, S, H, D)``, k/v ``(B, Skv, Hkv, D)``, GQA
through ``h // (H / Hkv)``, causal, sliding ``window``, and a key
length ``Skv`` of its own (cross-attention). Any D up to 1024 (the
adapter's D is 192 at CLIP ViT-B/32 width, 512 at Yi-9B width and 896 at
LLaVA-NeXT-34B width).
The plain version is :func:`repro_torch.kernels.ref.flash_attention`; the
gradient is ``kernels.ops.flash_attention``'s ``autograd.Function``.
Four routes, chosen here by :func:`route` and each counted:
- bf16 runs the tensor-core kernels (``flash_attention_tc_launch``;
  ``tc_launches`` counts every bf16 launch): up to D = 512
  ``flash_tc_kernel`` (``"tc"``), above it ``flash_tc_cluster_kernel``
  (``"tc_cluster"``, ``cluster_launches``: the ⌈Dp/128⌉ D-slice blocks
  of a q-tile as one thread-block cluster that forms each score block
  once, its slices' partial scores summed in rank order through
  distributed shared memory);
- fp32 (``flash_attention_f32_launch``) up to ``ROWS_MAX_S`` query rows
  runs ``flash_rows_kernel`` (``"cuda_rows"``, ``rows_launches``: one
  warp a query row, K and V read straight from device memory; the FL
  round's and the serve oracle's S = 1), past it ``flash_tf32x3_kernel``
  (``"cuda_tf32x3"``, ``tf32_launches``: the cluster route's structure
  on TF32 tensor cores with each fp32 operand split into two TF32 parts,
  three products a pair), both held at 1e-5.
None stands in for another: an input the chosen kernel refuses raises.
``_flash_attention(..., force=)`` runs another kernel on the same
inputs, only for the card's A/B: ``"tc_single"`` the earlier
single-stage D > 512 instantiation on a bf16 input, ``"cuda_v1"`` the
first fp32 design (``flash_kernel``), ``"cuda_rows"`` / ``"cuda_tf32x3"``
either fp32 route at any S (the crossover that sets ``ROWS_MAX_S``).
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
_F32_ROUTES = {"cuda_rows": 0, "cuda_tf32x3": 1}
# the fp32 routes' rule: S <= ROWS_MAX_S query rows take "cuda_rows", set
# from the crossover against "cuda_tf32x3" timed on the H100
# (chip_smoke.check_flash_fp32's sweep)
ROWS_MAX_S = 8
# flash_tf32x3_kernel's shared memory: Q, a 2-stage K/V ring and the
# cluster's partial and summed scores, fp32 (two blocks an SM)
TF32X3_SMEM_BYTES = 4 * (64 * DV + 2 * 2 * 32 * DV + 2 * 16 * 128)
# each route's own count on the wrapper (``tc_launches`` counts every
# bf16 launch, these three first)
ROUTE_COUNTS = {"tc_cluster": "cluster_launches", "cuda_rows": "rows_launches",
                "cuda_tf32x3": "tf32_launches"}


def route_counts() -> dict:
    """Every route's launches so far: the three routes' own counts, and
    ``"tc"`` the bf16 launches off the cluster route (``"tc_single"``
    among them when forced). A forced ``"cuda_v1"`` is in ``launches``
    only."""
    fn = flash_attention
    out = {r: getattr(fn, a) for r, a in ROUTE_COUNTS.items()}
    out["tc"] = fn.tc_launches - fn.cluster_launches
    return out


def cluster_size(D: int) -> int:
    """The D-slice blocks of one q-tile, the cluster of the D > 512 route:
    ⌈Dp / 128⌉ with Dp = D rounded up to 16."""
    return -(-(-(-D // 16) * 16) // DV)


def route(S: int, D: int, dtype: torch.dtype) -> str:
    """The kernel a call of S query rows, head dim D and ``dtype`` runs:
    bf16 ``"tc"`` up to D = 512 and ``"tc_cluster"`` above; fp32
    ``"cuda_rows"`` up to ``ROWS_MAX_S`` rows and ``"cuda_tf32x3"``
    past them."""
    if dtype != torch.bfloat16:
        return "cuda_rows" if S <= ROWS_MAX_S else "cuda_tf32x3"
    return "tc" if -(-D // 16) * 16 <= MAX_D_STAGED else "tc_cluster"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Skv, Hkv, D) -> (B, S, H, D)."""
    return _flash_attention(q, k, v, causal=causal, window=window)


def _flash_attention(q, k, v, *, causal=True, window=None, force=None):
    """:func:`flash_attention` on :func:`route`'s kernel, or on the kernel
    ``force`` names, of the input's dtype (the card's A/B): bf16
    ``"tc_single"``; fp32 ``"cuda_v1"``, ``"cuda_rows"`` or
    ``"cuda_tf32x3"``."""
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
    how = route(S, D, q.dtype)
    if force is not None:
        forcible = ("tc_single",) if q.dtype == torch.bfloat16 else \
            ("cuda_v1", *_F32_ROUTES)
        if force not in forcible:
            raise ValueError(f"flash_attention: {force!r} cannot be forced "
                             f"on {q.dtype}; routes: {forcible}")
        how = force
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S,
            Skv, H, Hkv, D, 1.0 / math.sqrt(D), int(causal),
            0 if window is None else int(window)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if how == "cuda_v1":
        fn = build.function("flash_attention", "flash_attention_launch",
                            _ARGS)
        rc = fn(*args, stream)
    elif how in _F32_ROUTES:
        fn = build.function("flash_attention", "flash_attention_f32_launch",
                            _TC_ARGS)
        rc = fn(*args, _F32_ROUTES[how], stream)
    else:
        fn = build.function("flash_attention", "flash_attention_tc_launch",
                            _TC_ARGS)
        rc = fn(*args, _TC_ROUTES[how], stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.tc_launches += int(how in _TC_ROUTES)
    flash_attention.cluster_launches += int(how == "tc_cluster")
    flash_attention.rows_launches += int(how == "cuda_rows")
    flash_attention.tf32_launches += int(how == "cuda_tf32x3")
    return o


def f32_occupancy(how: str) -> int:
    """Resident blocks an SM of an fp32 route's kernel at its registers
    and shared memory (CUDA's occupancy calculator; the rows route at
    D = 1024)."""
    fn = build.function("flash_attention", "flash_attention_f32_occupancy",
                        (_I, ctypes.POINTER(_I)))
    out = _I(0)
    build.check(fn(_F32_ROUTES[how], ctypes.byref(out)),
                "flash_attention_f32_occupancy")
    return out.value


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.cluster_launches = 0
flash_attention.rows_launches = 0
flash_attention.tf32_launches = 0
