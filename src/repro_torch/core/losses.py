"""Loss functions, port of ``repro.core.losses``: LM/classification
cross-entropy, accuracy and the CLIP symmetric contrastive (InfoNCE)
loss."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits (..., V), integer labels (...). Mean over unmasked items,
    computed in fp32 whatever the model dtype."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, -1) == labels).to(torch.float32).mean()


def clip_contrastive(img_emb: torch.Tensor, txt_emb: torch.Tensor,
                     logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over a batch of paired embeddings (B, d)."""
    img = img_emb / (img_emb.norm(dim=-1, keepdim=True) + 1e-8)
    txt = txt_emb / (txt_emb.norm(dim=-1, keepdim=True) + 1e-8)
    logits = torch.exp(logit_scale) * img @ txt.T          # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (cross_entropy(logits, labels) +
                  cross_entropy(logits.T, labels))
