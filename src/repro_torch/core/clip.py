"""CLIP-style dual encoder, port of ``repro.core.clip`` (forward only).

A ViT image encoder and a causal text transformer sharing one
``d_model``; zero-shot classification = cosine(image embedding, class-
prompt text embeddings). The parameter tree has the JAX package's layout
(``blocks`` stacked along a leading layer axis), so weights convert
structurally. The block's own attention is plain einsum + softmax, as in
the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import lora as lora_lib


@dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 32
    patch: int = 8
    channels: int = 3
    vision_layers: int = 2
    text_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    d_ff: int = 128
    vocab: int = 512
    max_text_len: int = 8
    proj_dim: int = 32

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


def _normal(generator, shape, std, device):
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * std).to(device)


def _init_blocks(generator, L, d, d_ff, device):
    s = lambda f: 1.0 / math.sqrt(f)
    return {"ln1": torch.zeros((L, d), device=device),
            "ln2": torch.zeros((L, d), device=device),
            "wq": _normal(generator, (L, d, d), s(d), device),
            "wk": _normal(generator, (L, d, d), s(d), device),
            "wv": _normal(generator, (L, d, d), s(d), device),
            "wo": _normal(generator, (L, d, d), s(d), device),
            "wu": _normal(generator, (L, d, d_ff), s(d), device),
            "wd": _normal(generator, (L, d_ff, d), s(d_ff), device)}


def init_clip(generator: torch.Generator, cfg: CLIPConfig, device=None):
    """Seeded CLIP parameters. Draws on ``generator``'s device, stores on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    d = cfg.d_model
    pdim = cfg.patch * cfg.patch * cfg.channels
    g = generator
    vision = {
        "patch_embed": _normal(g, (pdim, d), 1.0 / math.sqrt(pdim), dev),
        "cls": _normal(g, (d,), 0.02, dev),
        "pos": _normal(g, (cfg.n_patches + 1, d), 0.02, dev),
        "blocks": _init_blocks(g, cfg.vision_layers, d, cfg.d_ff, dev),
        "ln": torch.zeros((d,), device=dev),
    }
    text = {
        "embed": _normal(g, (cfg.vocab, d), 0.02, dev),
        "pos": _normal(g, (cfg.max_text_len, d), 0.02, dev),
        "blocks": _init_blocks(g, cfg.text_layers, d, cfg.d_ff, dev),
        "ln": torch.zeros((d,), device=dev),
    }
    return {"vision": vision, "text": text,
            "proj_v": _normal(g, (d, cfg.proj_dim), 1.0 / math.sqrt(d), dev),
            "proj_t": _normal(g, (d, cfg.proj_dim), 1.0 / math.sqrt(d), dev),
            "logit_scale": torch.tensor(math.log(1 / 0.07), device=dev)}


def _ln(x, w, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1 + w)


# TriplePlay's fixed LoRA scaling alpha/r for the CLIP blocks
LORA_SCALE = 2.0


def _block(p, x, n_heads, causal=False, lora=None):
    B, S, d = x.shape
    dh = d // n_heads

    def lin(name, h):
        la = None if lora is None else lora.get(name)
        if la is not None:
            r = la["a"].shape[-1]
            return lora_lib.linear(h, p[name], la,
                                   alpha=LORA_SCALE * r, rank=r)
        return lora_lib.linear(h, p[name])

    h = _ln(x, p["ln1"])
    q = lin("wq", h).reshape(B, S, n_heads, dh)
    k = lin("wk", h).reshape(B, S, n_heads, dh)
    v = lin("wv", h).reshape(B, S, n_heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if causal:
        tril = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        s = torch.where(tril, s, -1e30)
    a = torch.softmax(s, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, d)
    x = x + lin("wo", o)
    h = _ln(x, p["ln2"])
    return x + lora_lib.linear(F.gelu(
        lora_lib.linear(h, p["wu"]), approximate="tanh"), p["wd"])


def _run_blocks(blocks, x, n_heads, causal, lora=None):
    """``blocks`` and ``lora`` leaves carry the layer axis first. A LoRA
    leaf may be ``(L, T, ., .)``: per-row factors for a stacked tenant
    batch of T rows."""
    L = blocks["wq"].shape[0]
    for i in range(L):
        bp = {k: v[i] for k, v in blocks.items()}
        bl = None if lora is None else {
            n: {f: t[i] for f, t in pair.items()} for n, pair in lora.items()}
        x = _block(bp, x, n_heads, causal, bl)
    return x


def patchify(images, patch):
    """(B, H, W, C) -> (B, n_patches, patch*patch*C)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, -1)


def embed_patches(params, cfg: CLIPConfig, images):
    """(B, H, W, C) -> (B, n_patches + 1, d) embedded tokens (patch
    projection + cls + positions); independent of any trainable."""
    v = params["vision"]
    x = patchify(images, cfg.patch) @ v["patch_embed"]
    cls = v["cls"].expand(x.shape[0], 1, cfg.d_model)
    return torch.cat([cls, x], dim=1) + v["pos"][None]


def encode_tokens(params, cfg: CLIPConfig, x, *, lora=None,
                  pool: bool = True):
    """Vision tower over pre-embedded tokens from ``embed_patches``."""
    v = params["vision"]
    x = _run_blocks(v["blocks"], x, cfg.n_heads, False, lora)
    x = _ln(x, v["ln"])
    return x[:, 0] if pool else x            # cls token


def encode_image(params, cfg: CLIPConfig, images, *, lora=None,
                 pool: bool = True):
    return encode_tokens(params, cfg, embed_patches(params, cfg, images),
                         lora=lora, pool=pool)


def encode_text(params, cfg: CLIPConfig, tokens):
    t = params["text"]
    x = t["embed"][tokens] + t["pos"][None, :tokens.shape[1]]
    x = _run_blocks(t["blocks"], x, cfg.n_heads, True)
    x = _ln(x, t["ln"])
    return x[:, -1]                            # last token


def text_embedding(params, cfg: CLIPConfig, tokens):
    return encode_text(params, cfg, tokens) @ params["proj_t"]


def zero_shot_logits(img_emb, class_text_emb, logit_scale):
    ie = img_emb / (img_emb.norm(dim=-1, keepdim=True) + 1e-8)
    te = class_text_emb / (class_text_emb.norm(dim=-1, keepdim=True) + 1e-8)
    return torch.exp(logit_scale) * ie @ te.T
