"""Gemm forms of the GAN's 4x4 / stride-2 convolutions, port of
``repro.kernels.gan_conv``.

The reference writes both convolutions of the DCGAN in ``core.gan`` as
dense gemms over phase-decomposed (sub-pixel) layouts, with hand-written
VJPs, so that a cohort of per-client kernels lowers to batched gemms.
The port keeps the same forms and the same backward formulas as
``torch.autograd.Function``s:

- ``conv4x4_s2``: the input's four stride-2 phases give the 16 kernel
  taps as shifted views concatenated on channels (im2col), and the conv
  is one ``(b*oh*ow, 16*ci) @ (16*ci, co)`` gemm; its ``dx`` is the
  transposed conv with the flipped, channel-transposed kernel and its
  ``dw`` one gemm against the saved patch matrix.
- ``convT4x4_s2``: the reference's semantics, ``out[2i+2-a, 2j+2-c] +=
  x[i,j] . w[a,c]`` (``lax.conv_transpose`` without
  ``transpose_kernel``). For ``co >= 8`` the four output phases are one
  gemm over four shifted input copies; for narrow outputs (the to-RGB
  layer) the contribution tensor ``x @ w (ci, 16co)`` is overlap-added
  into the phases. Its ``dx`` is the strided conv with the flipped
  kernel and its ``dw`` one gemm against the transposed patch matrix.

Shapes are NHWC with even spatial dims and HWIO kernels ``(4, 4, ci,
co)``, stride 2, SAME padding (1 on each side). Both functions take an
optional leading client axis, ``x (C, b, h, w, ci)`` with ``w (C, 4, 4,
ci, co)``, contracted with ``torch.bmm``: the fleet engine trains C
per-client GANs with one launch per gemm (the port has no ``vmap``).
These products are plain PyTorch: the JAX package computes them outside
any Pallas kernel.

The int8 quantized-compute forms (``GANConfig.conv_impl="gemm_int8"``)
run the same gemm forms through :func:`quant_gemm_int8`: both operands
blockwise-int8 along the contraction dim, exact int8 x int8 block
products, fp32 accumulation of the scaled partials. CUDA has no int8
``matmul``, so a block product is an fp32 product of the int8 codes:
each term is at most 127² and a block of 64 sums to at most
64·127² < 2²⁴, so every partial is an exact integer in fp32 (and under
TF32, where the codes are exact too) in any summation order. Their
gradients are straight-through, through the same quantized gemms over
the true cotangents, as the reference's ``custom_vjp``s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant as qlib

# For output position i, a SAME-padded 4x4/stride-2 window covers input
# rows 2i-1 .. 2i+2: tap a lives in phase (a+1) % 2 at offset -1/0/0/+1
_TAP = {0: (1, -1), 1: (0, 0), 2: (1, 0), 3: (0, 1)}


def _phase_split(x):
    """(C, b, h, w, c) -> (C, b, 2, 2, h//2, w//2, c) stride-2 phases."""
    C, b, h, w, c = x.shape
    return x.reshape(C, b, h // 2, 2, w // 2, 2, c).permute(
        0, 1, 3, 5, 2, 4, 6)


def _pad_hw(x, top, bottom, left, right):
    """Zero-pad the two spatial axes of a (..., h, w, c) tensor."""
    return F.pad(x, (0, 0, left, right, top, bottom))


def _im2col(x):
    """(C, b, h, w, ci) -> (C, b, h//2, w//2, 16*ci) patch matrix of the
    SAME-padded 4x4/stride-2 windows, tap-major (a, c, ci) to match
    ``w.reshape(16*ci, co)``."""
    C, b, h, ww, ci = x.shape
    oh, ow = h // 2, ww // 2
    ph = _pad_hw(_phase_split(x), 1, 1, 1, 1)
    taps = []
    for a in range(4):
        p, da = _TAP[a]
        for c in range(4):
            q, dc = _TAP[c]
            taps.append(ph[:, :, p, q, 1 + da:1 + da + oh, 1 + dc:1 + dc + ow])
    return torch.cat(taps, dim=-1)


def _flip_T(w):
    """(C, 4, 4, ci, co) -> spatially flipped, channel-transposed
    (C, 4, 4, co, ci): the kernel of the transposed linear map."""
    return w.flip(1, 2).transpose(3, 4)


def _mm(a, w):
    """(C, ..., K) @ (C, K, N) -> (C, ..., N), one ``bmm``."""
    C, K = a.shape[0], a.shape[-1]
    out = torch.bmm(a.reshape(C, -1, K), w)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def _interleave(g, co):
    """(C, b, H, W, 2, 2, co) phase blocks -> (C, b, 2H, 2W, co)."""
    C, b, H, W = g.shape[:4]
    return g.permute(0, 1, 2, 4, 3, 5, 6).reshape(C, b, 2 * H, 2 * W, co)


def _convT_phase(x, w, co, mm=_mm):
    """convT as one gemm (``mm``) over shifted copies: the four
    output-phase kernels concatenated on the output axis."""
    C, b, h, ww, ci = x.shape
    xs = torch.cat([_pad_hw(x, s, 1 - s, t, 1 - t)
                    for s in (0, 1) for t in (0, 1)], dim=-1)
    wt = torch.cat([
        torch.cat([w[:, 3 - (p + 2 * s), 3 - (q + 2 * t)]
                   for s in (0, 1) for t in (0, 1)], dim=1)
        for p in (0, 1) for q in (0, 1)], dim=2)          # (C, 4ci, 4co)
    return _interleave(mm(xs, wt).reshape(C, b, h + 1, ww + 1, 2, 2, co),
                       co)


def _convT_contrib(x, w, co, mm=_mm):
    """convT through the contribution tensor ``x @ w (ci, 16co)`` (one
    gemm with a healthy contraction dim even when ``co`` is tiny),
    overlap-added into the output phases."""
    C, b, h, ww, ci = x.shape
    contrib = mm(x, w.permute(0, 3, 1, 2, 4).reshape(C, ci, 16 * co)) \
        .reshape(C, b, h, ww, 4, 4, co)
    phases = []
    for p in (0, 1):
        for q in (0, 1):
            acc = 0
            for s in (0, 1):
                for t in (0, 1):
                    acc = acc + _pad_hw(
                        contrib[:, :, :, :, 3 - (p + 2 * s), 3 - (q + 2 * t)],
                        s, 1 - s, t, 1 - t)
            phases.append(acc)
    g = torch.stack(phases, dim=4).reshape(C, b, h + 1, ww + 1, 2, 2, co)
    return _interleave(g, co)


def _convT(x, w, mm=_mm):
    """Raw convT forward on the client-axis layout (also the ``dx`` of
    ``conv4x4_s2``), its gemm through ``mm``."""
    h, ww, co = x.shape[2], x.shape[3], w.shape[-1]
    form = _convT_contrib if co < 8 else _convT_phase
    return form(x, w, co, mm)[:, :, 1:2 * h + 1, 1:2 * ww + 1]


def _im2col_T(g):
    """Patch matrix of the transposed map: for ``g (C, b, 2h, 2w, co)``
    returns ``(C, b, h, w, 16*co)`` whose tap-(a, c) block is
    ``g_pad[2i+2-a, 2j+2-c]``."""
    C, b, H2, W2, co = g.shape
    h, w = H2 // 2, W2 // 2
    ph = _phase_split(_pad_hw(g, 1, 1, 1, 1))
    taps = []
    # tap a gathers rows 2i+3-a of the padded grid: phase (3-a) % 2,
    # phase-row offset (3-a) // 2
    for a in range(4):
        p, s = (3 - a) % 2, (3 - a) // 2
        for c in range(4):
            q, t = (3 - c) % 2, (3 - c) // 2
            taps.append(ph[:, :, p, q, s:s + h, t:t + w])
    return torch.cat(taps, dim=-1)


def _stack(x, w, name):
    """Check the geometry and give ``x``/``w`` a leading client axis;
    returns (x, w, whether it was added)."""
    single = x.ndim == 4
    if single:
        x, w = x[None], w[None]
    if x.ndim != 5 or w.ndim != 5 or w.shape[0] != x.shape[0] or \
            tuple(w.shape[1:3]) != (4, 4) or w.shape[3] != x.shape[4]:
        raise ValueError(f"{name} needs x (C, b, h, w, ci) with w (C, 4, 4, "
                         f"ci, co), or both without C; got x "
                         f"{tuple(x.shape)} w {tuple(w.shape)}")
    return x, w, single


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        C, ci, co = x.shape[0], x.shape[-1], w.shape[-1]
        cols = _im2col(x)
        # the patch matrix is what dw contracts against: carried, not
        # recomputed
        ctx.save_for_backward(cols, w)
        return _mm(cols, w.reshape(C, 16 * ci, co))

    @staticmethod
    def backward(ctx, g):
        cols, w = ctx.saved_tensors
        C, ci, co = w.shape[0], w.shape[3], w.shape[4]
        # dx[r] = sum_{i,a: 2i+a-1=r} g[i] . w[a]: the convT with the
        # flipped/transposed kernel
        dx = _convT(g, _flip_T(w))
        dw = torch.bmm(cols.reshape(C, -1, 16 * ci).transpose(1, 2),
                       g.reshape(C, -1, co)).reshape(C, 4, 4, ci, co)
        return dx, dw


class _ConvT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _convT(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        C, ci, co = w.shape[0], w.shape[3], w.shape[4]
        # dx[i] = sum_a g[2i+2-a] . w[a]: the stride-2 conv of g with the
        # flipped/transposed kernel
        dx = _mm(_im2col(g), _flip_T(w).reshape(C, 16 * co, ci))
        # dw[a] = sum_i x[i] (x) g[2i+2-a]
        dw = torch.bmm(x.reshape(C, -1, ci).transpose(1, 2),
                       _im2col_T(g).reshape(C, -1, 16 * co))
        return dx, dw.reshape(C, ci, 4, 4, co).permute(0, 2, 3, 1, 4)


def conv4x4_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME, stride-2 correlation of ``x (b, h, w, ci)`` with ``w (4, 4,
    ci, co)`` -> ``(b, h//2, w//2, co)`` (or all with a leading client
    axis); equals ``lax.conv_general_dilated`` with NHWC/HWIO layouts."""
    x, w, single = _stack(x, w, "conv4x4_s2")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"conv4x4_s2 needs even spatial dims, got "
                         f"{tuple(x.shape)}")
    out = _Conv.apply(x, w)
    return out[0] if single else out


def convT4x4_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME, stride-2 transposed convolution of ``x (b, h, w, ci)`` with
    ``w (4, 4, ci, co)`` -> ``(b, 2h, 2w, co)`` (or all with a leading
    client axis); equals ``lax.conv_transpose`` (``transpose_kernel=
    False``) with NHWC/HWIO layouts."""
    x, w, single = _stack(x, w, "convT4x4_s2")
    out = _ConvT.apply(x, w)
    return out[0] if single else out


# -- int8 quantized compute (conv_impl="gemm_int8") ------------------
INT8_BLOCK = 64


def _q8_rows(x, blk):
    """(..., M, K) -> int8 codes (..., M, G, blk) + fp32 absmax scales
    (..., M, G), blockwise along the contraction dim (zero-padded to a
    block multiple; pad columns quantize to exact zeros). The scale's
    division is ``core.quant._div``'s, IEEE on every device."""
    K = x.shape[-1]
    Kp = -(-K // blk) * blk
    if Kp != K:
        x = F.pad(x, (0, Kp - K))
    xg = x.reshape(*x.shape[:-1], Kp // blk, blk)
    s = qlib._div(xg.abs().amax(dim=-1), 127.0)
    safe = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xg / safe[..., None]), -127, 127)
    return q.to(torch.int8), s


def block_products(qx, qw):
    """Every K-block's product of int8 codes, ``qx (..., M, G, b)`` by
    ``qw (..., N, G, b)`` -> ``(..., G, M, N)`` fp32: one batched fp32
    matmul whose sums are exact integers (see the module docstring)."""
    a = qx.transpose(-3, -2).to(torch.float32)
    b = qw.transpose(-3, -2).transpose(-1, -2).to(torch.float32)
    return torch.matmul(a, b)


def quant_gemm_int8(x: torch.Tensor, w: torch.Tensor,
                    blk: int = INT8_BLOCK) -> torch.Tensor:
    """Quantized-compute ``x (..., M, K) @ w (..., K, N) -> (..., M, N)``
    fp32: both operands blockwise-int8 along K (per-row x per-column
    absmax scales), exact block products, and the scaled partials
    accumulated in fp32 over the blocks in ascending order, as the
    reference's ``lax.scan`` does. Leading dims (a client axis) batch."""
    K = x.shape[-1]
    if w.shape[-2] != K or x.shape[:-2] != w.shape[:-2]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} "
                         f"w {tuple(w.shape)}")
    b = min(blk, K)
    qx, sx = _q8_rows(x.to(torch.float32), b)       # (.., M, G, b), (.., M, G)
    qw, sw = _q8_rows(w.to(torch.float32).transpose(-1, -2), b)
    part = block_products(qx, qw) * sx.transpose(-1, -2)[..., None] * \
        sw.transpose(-1, -2)[..., None, :]          # (.., G, M, N)
    acc = torch.zeros(part.shape[:-3] + part.shape[-2:], dtype=torch.float32,
                      device=part.device)
    for g in range(part.shape[-3]):
        acc = acc + part[..., g, :, :]
    return acc


def _mm_q8(a, w):
    """:func:`_mm` through :func:`quant_gemm_int8`."""
    C, K = a.shape[0], a.shape[-1]
    out = quant_gemm_int8(a.reshape(C, -1, K), w)
    return out.reshape(*a.shape[:-1], w.shape[-1])


class _ConvI8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        C, ci, co = x.shape[0], x.shape[-1], w.shape[-1]
        cols = _im2col(x)
        ctx.save_for_backward(cols, w)
        return _mm_q8(cols, w.reshape(C, 16 * ci, co)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        # straight-through: the conv's transposes through the same
        # quantized gemms, over the true cotangent
        cols, w = ctx.saved_tensors
        C, ci, co = w.shape[0], w.shape[3], w.shape[4]
        dx = _convT(g, _flip_T(w), mm=_mm_q8)
        dw = quant_gemm_int8(cols.reshape(C, -1, 16 * ci).transpose(1, 2),
                             g.reshape(C, -1, co).to(torch.float32))
        return dx, dw.reshape(C, 4, 4, ci, co).to(w.dtype)


class _ConvTI8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _convT(x, w, mm=_mm_q8).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        C, ci, co = w.shape[0], w.shape[3], w.shape[4]
        dx = _mm_q8(_im2col(g), _flip_T(w).reshape(C, 16 * co, ci))
        dw = quant_gemm_int8(
            x.reshape(C, -1, ci).transpose(1, 2).to(torch.float32),
            _im2col_T(g).reshape(C, -1, 16 * co))
        return dx.to(x.dtype), dw.reshape(C, ci, 4, 4, co).permute(
            0, 2, 3, 1, 4).to(w.dtype)


def conv4x4_s2_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`conv4x4_s2` with the patch-matrix gemm in int8 quantized
    compute (fp32 accumulation); the same shapes and geometry."""
    x, w, single = _stack(x, w, "conv4x4_s2_int8")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"conv4x4_s2_int8 needs even spatial dims, got "
                         f"{tuple(x.shape)}")
    out = _ConvI8.apply(x, w)
    return out[0] if single else out


def convT4x4_s2_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`convT4x4_s2` with the phase/contribution gemm in int8
    quantized compute (fp32 accumulation)."""
    x, w, single = _stack(x, w, "convT4x4_s2_int8")
    out = _ConvTI8.apply(x, w)
    return out[0] if single else out


def _to_nchw(x):
    """(C, b, h, w, c) -> (b, C*c, h, w): clients as channel groups."""
    C, b, h, w, c = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(b, C * c, h, w)


def _from_nchw(y, C):
    """(b, C*c, h, w) -> (C, b, h, w, c)."""
    b, Cc, h, w = y.shape
    return y.reshape(b, C, Cc // C, h, w).permute(1, 0, 3, 4, 2)


def conv4x4_s2_lax(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`conv4x4_s2` through ``F.conv2d`` (cuDNN on the card): the
    reference's ``conv_impl="lax"``. A client axis becomes channel
    groups; the result is NHWC again before any flatten."""
    x, w, single = _stack(x, w, "conv4x4_s2_lax")
    C, ci, co = x.shape[0], x.shape[-1], w.shape[-1]
    wk = w.permute(0, 4, 3, 1, 2).reshape(C * co, ci, 4, 4)
    out = _from_nchw(F.conv2d(_to_nchw(x), wk, stride=2, padding=1,
                              groups=C), C)
    return out[0] if single else out


def convT4x4_s2_lax(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`convT4x4_s2` through ``F.conv_transpose2d``. PyTorch's op
    is the gradient of ``conv2d``, ``out[2i-1+a'] += x[i] . k[a']``, so
    the reference's ``out[2i+2-a] += x[i] . w[a]`` is it with the kernel
    flipped spatially (``k[a'] = w[3-a']``) and laid out (ci, co, 4, 4)."""
    x, w, single = _stack(x, w, "convT4x4_s2_lax")
    C, ci, co = x.shape[0], x.shape[-1], w.shape[-1]
    wk = w.flip(1, 2).permute(0, 3, 4, 1, 2).reshape(C * ci, co, 4, 4)
    out = _from_nchw(F.conv_transpose2d(_to_nchw(x), wk, stride=2, padding=1,
                                        groups=C), C)
    return out[0] if single else out

