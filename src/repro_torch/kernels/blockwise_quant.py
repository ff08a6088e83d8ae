"""CUDA blockwise absmax quantization, port of
``repro.kernels.blockwise_quant``.

``blockwise_quant(x, bits, block)`` quantizes a ``(K, N)`` tensor into
the :class:`~repro_torch.core.quant.QTensor` layout on the card (source:
``csrc/blockwise_quant.cu``); payload and scales equal the plain version
(:func:`repro_torch.kernels.ref.blockwise_quant`) bit for bit. Odd K
zero-pads to a block multiple, as in the JAX kernel. The kernel reads
every input element once and holds it in a register from the absmax
through to its code; its launcher picks the threads for the block and
refuses a block past 8192 rows.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QTensor
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _I, _I, _I, _I, _P)


def blockwise_quant(x: torch.Tensor, *, bits: int = 8,
                    block: int = 128) -> QTensor:
    """x: (K, N) -> QTensor with blocks of ``block`` along K (linear
    int8 or packed int4)."""
    if not x.is_cuda:
        raise ValueError(f"blockwise_quant kernel needs a CUDA tensor, "
                         f"got {x.device}")
    if x.ndim != 2:
        raise ValueError(f"blockwise_quant kernel takes a 2-D tensor, "
                         f"got shape {tuple(x.shape)}")
    if not x.dtype.is_floating_point:
        raise TypeError(f"blockwise_quant needs a float tensor, got {x.dtype}")
    if bits not in (4, 8):
        raise ValueError(f"unsupported bits={bits}")
    K, N = x.shape
    block = min(block, K)
    if bits == 4 and block % 2:
        raise ValueError(f"int4 packs row pairs: block {block} is odd")
    Kp = -(-K // block) * block
    xf = x.to(torch.float32)
    if Kp != K:
        xf = F.pad(xf, (0, 0, 0, Kp - K))
    xf = xf.contiguous()
    G = Kp // block
    rows = block if bits == 8 else block // 2
    q = torch.empty((G, rows, N), device=x.device,
                    dtype=torch.int8 if bits == 8 else torch.uint8)
    s = torch.empty((G, 1, N), device=x.device, dtype=torch.float32)
    fn = build.function("blockwise_quant", "blockwise_quant_launch", _ARGS)
    build.check(fn(xf.data_ptr(), q.data_ptr(), s.data_ptr(), G, N, block,
                   bits, torch.cuda.current_stream(x.device).cuda_stream),
                "blockwise_quant")
    blockwise_quant.launches += 1
    return QTensor(q=q, scales=s, bits=bits, mode="linear", block=block,
                   out_dtype=x.dtype, orig_shape=(K, N))


blockwise_quant.launches = 0
