"""Blockwise quantization (int8 / int4 / NF4), port of ``repro.core.quant``.

Layout for a weight of shape (..., K, N) with block B along K, identical
to the JAX package so payloads compare bitwise:
  q      : (..., G, B, N) int8      [8-bit]        G = K // B
           (..., G, B//2, N) uint8  [4-bit packed; hi nibble = even row]
  scales : (..., G, 1, N) float32   absmax / levels

Every op is plain fp32 PyTorch: ``absmax / 127.0`` is an IEEE division
on every device (:func:`_div`) and ``torch.round`` rounds half to even
like ``jnp.round``, so the payload and scales equal the JAX eager
quantizer bit for bit. Double
quantization is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_lib

# NF4 codebook (QLoRA, Dettmers et al. 2023) — quantiles of N(0,1), ±1 ends.
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], dtype=np.float32)


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor
    scales: torch.Tensor
    bits: int
    mode: str           # "linear" | "nf4"
    block: int
    out_dtype: Any      # torch dtype
    orig_shape: tuple

    def nbytes_packed(self) -> int:
        return self.q.numel() * self.q.element_size() + \
            self.scales.numel() * self.scales.element_size()


_CODES: dict = {}


def _code(device) -> torch.Tensor:
    """The NF4 codebook on ``device``, copied there once: a fresh copy
    per call is a blocking host-to-device transfer, which on the card
    drains the stream before every dequantize."""
    dev = torch.device(device)
    code = _CODES.get(dev)
    if code is None:
        code = _CODES[dev] = torch.as_tensor(NF4_CODE, device=dev)
    return code


def _div(x: torch.Tensor, levels: float) -> torch.Tensor:
    """``x / levels``, IEEE-rounded on every device. PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which can
    land one ulp off; a 0-d tensor on x's device keeps the true division
    that the JAX package and the CUDA kernel use."""
    return x / x.new_tensor(levels)


def _blocked(x: torch.Tensor, block: int):
    *lead, K, N = x.shape
    block = min(block, K)
    if K % block:
        raise ValueError(
            f"contraction dim {K} not divisible by block {block}")
    return x.reshape(*lead, K // block, block, N), block


def pack4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values in [-8, 7] two-per-uint8 along axis -2."""
    u = (q + 8).to(torch.uint8)
    hi, lo = u[..., 0::2, :], u[..., 1::2, :]
    return (hi << 4) | lo


def unpack4(p: torch.Tensor) -> torch.Tensor:
    hi = (p >> 4).to(torch.int8) - 8
    lo = (p & 0xF).to(torch.int8) - 8
    *lead, Bh, N = p.shape
    out = torch.stack([hi, lo], dim=-2)            # (..., Bh, 2, N)
    return out.reshape(*lead, 2 * Bh, N)


def quantize(x: torch.Tensor, *, bits: int = 4, block: int = 128,
             mode: str = "linear") -> QTensor:
    orig_shape = tuple(x.shape)
    out_dtype = x.dtype
    xb, block = _blocked(x.to(torch.float32), block)
    absmax = xb.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12)
    if mode == "nf4":
        if bits != 4:
            raise ValueError("nf4 is a 4-bit codebook")
        scales = absmax
        normed = xb / scales                               # [-1, 1]
        idx = torch.argmin(
            (normed[..., None] - _code(x.device)).abs(), dim=-1
        ).to(torch.int8) - 8
        q = pack4(idx)
    elif bits == 8:
        scales = _div(absmax, 127.0)
        q = torch.clamp(torch.round(xb / scales), -127, 127).to(torch.int8)
    elif bits == 4:
        scales = _div(absmax, 7.0)
        q = pack4(torch.clamp(torch.round(xb / scales), -8, 7)
                  .to(torch.int8))
    else:
        raise ValueError(f"unsupported bits={bits}")
    return QTensor(q=q, scales=scales, bits=bits, mode=mode, block=block,
                   out_dtype=out_dtype, orig_shape=orig_shape)


def dequantize(qt: QTensor, dtype=None) -> torch.Tensor:
    dtype = dtype or qt.out_dtype
    if qt.bits == 4:
        vals = unpack4(qt.q)
        if qt.mode == "nf4":
            vals = _code(qt.q.device)[(vals + 8).to(torch.long)]
        else:
            vals = vals.to(torch.float32)
    else:
        vals = qt.q.to(torch.float32)
    x = vals * qt.scales
    # shape from the live arrays, as in the JAX package: a sliced or
    # stacked QTensor dequantizes by its payload, not its orig_shape
    *lead, G, B, N = x.shape
    return x.reshape(*lead, G * B, N).to(dtype)


def maybe_dequantize(w, dtype=None):
    return dequantize(w, dtype) if isinstance(w, QTensor) else w


# param-name fragments never quantized (QLoRA keeps these full-precision)
DEFAULT_SKIP = ("router", "conv", "dt_bias", "a_log", "d_skip", "lam",
                "ln", "norm", "embed", "pos", "head", "bias", "lora",
                "slot", "w_rg", "w_ig")


def _quantizable(path: str, shape, dtype, min_size: int,
                 skip_names=DEFAULT_SKIP) -> bool:
    if any(s in path.lower() for s in skip_names):
        return False
    if len(shape) < 2 or int(np.prod(shape)) < min_size:
        return False
    return bool(dtype.is_floating_point)


def _pick_block(K: int, block: int) -> int:
    b = min(block, K)
    while K % b:
        b //= 2
    return max(b, 1)


def quantize_tree(params, *, bits: int, block: int = 128,
                  mode: str = "linear", min_size: int = 4096,
                  skip_names=DEFAULT_SKIP):
    """Quantize every eligible >=2-D leaf; norms, biases, embeddings and
    other skip-listed names stay full precision (filtered by path)."""
    def one(path, leaf):
        if isinstance(leaf, QTensor) or not _quantizable(
                tree_lib.path_str(path), leaf.shape, leaf.dtype, min_size,
                skip_names):
            return leaf
        b = _pick_block(leaf.shape[-2], block)
        eff_bits, eff_mode = bits, mode
        if b % 2:
            eff_bits, eff_mode = 8, "linear"  # can't pack odd blocks
        return quantize(leaf, bits=eff_bits, block=b, mode=eff_mode)
    return tree_lib.map_with_path(one, params)


def qtensor_specs(shape, dtype, *, bits: int, block: int = 128,
                  mode: str = "linear") -> QTensor:
    """The QTensor ``quantize`` would return for ``shape``, its payload
    and scales on the ``meta`` device: sizes only, no data."""
    *lead, K, N = shape
    b = _pick_block(K, block)
    if b % 2:
        bits, mode = 8, "linear"
    G = K // b
    meta = torch.device("meta")
    if bits == 4:
        q = torch.empty((*lead, G, b // 2, N), dtype=torch.uint8, device=meta)
    else:
        q = torch.empty((*lead, G, b, N), dtype=torch.int8, device=meta)
    scales = torch.empty((*lead, G, 1, N), dtype=torch.float32, device=meta)
    return QTensor(q=q, scales=scales, bits=bits, mode=mode, block=b,
                   out_dtype=dtype, orig_shape=tuple(shape))


def quantize_tree_specs(specs, *, bits: int, block: int = 128,
                        mode: str = "linear", min_size: int = 4096,
                        skip_names=DEFAULT_SKIP):
    """The shape-only analogue of ``quantize_tree`` over a tree of
    ``meta`` tensors."""
    def one(path, leaf):
        if isinstance(leaf, QTensor) or not _quantizable(
                tree_lib.path_str(path), leaf.shape, leaf.dtype, min_size,
                skip_names):
            return leaf
        return qtensor_specs(tuple(leaf.shape), leaf.dtype, bits=bits,
                             block=block, mode=mode)
    return tree_lib.map_with_path(one, specs)


def dequantize_tree(params, dtype=None):
    return tree_lib.tree_map(
        lambda l: dequantize(l, dtype) if isinstance(l, QTensor) else l,
        params)


def tree_bytes(params) -> int:
    """True communicated/stored bytes of a (possibly quantized) tree."""
    total = 0
    for leaf in tree_lib.leaves(params):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes_packed()
        else:
            total += leaf.numel() * leaf.element_size()
    return int(total)
