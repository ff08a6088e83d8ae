"""Batched cohort execution, port of ``repro.fl.cohort``: only the hoisted
frozen prefix (``encode_rows``) that serving shares with training. The
cohort engine itself comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import clip as clip_lib
from repro_torch.fl import runtime as runtime_lib


def encode_rows(frozen, ccfg, *, use_lora: bool, rows: torch.Tensor,
                runtime=None, chunk: int = 512) -> torch.Tensor:
    """Encode ``(n, H, W, ch)`` image rows through the trainable-
    independent prefix of the forward: the whole frozen backbone (pooled
    features) for adapter-only arms, the patch embedding (tokens) for
    LoRA arms. Full chunks run at ``chunk`` rows; the ragged tail pads to
    its power-of-two bucket, so any row count reuses O(log chunk)
    programs."""
    runtime = runtime or runtime_lib.ProgramRuntime()
    n = rows.shape[0]

    def build():
        if use_lora:
            return lambda fz, x: clip_lib.embed_patches(fz, ccfg, x)
        return lambda fz, x: clip_lib.encode_image(fz, ccfg, x)

    def encode(piece):
        args = (frozen, piece)
        return runtime.compile("stage_encode", build, args,
                               static_key=(ccfg, use_lora))(*args)

    out = [encode(rows[i:i + chunk])
           for i in range(0, n - n % chunk, chunk)]
    tail = n % chunk
    if tail:
        ck = runtime_lib.bucket_rows(tail, chunk)
        out.append(encode(runtime_lib.pad_leading(rows[n - tail:], ck))[:tail])
    return torch.cat(out) if len(out) != 1 else out[0][:n]
