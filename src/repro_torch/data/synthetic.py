"""Synthetic long-tailed, domain-shifted image datasets, port of
``repro.data.synthetic``.

Plain numpy, so this copy reproduces the JAX package's data bit for bit
(same ``RandomState`` streams). Each class has a latent prototype
texture; each domain applies a distinct colour transform; samples add
prototype jitter and pixel noise; class 0 is the long tail.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_classes: int
    n_domains: int
    image_size: int = 32
    # token ids for the class prompt "a photo of a <class>" stand-in
    text_len: int = 8


SPECS = {
    "pacs": DatasetSpec("pacs", n_classes=7, n_domains=4),
    "officehome": DatasetSpec("officehome", n_classes=16, n_domains=4),
}


def class_tokens(spec: DatasetSpec, labels: np.ndarray) -> np.ndarray:
    """Deterministic class-prompt token sequences (vocab 512)."""
    base = np.array([1, 2, 3, 4, 0, 0, 0, 0], np.int32)  # "a photo of a"
    toks = np.tile(base, (len(labels), 1))
    toks[:, 4] = 10 + labels          # class word
    toks[:, 5] = 5                    # eos
    return toks


def _prototype(rng, spec, c):
    g = np.linspace(-1, 1, spec.image_size)
    xx, yy = np.meshgrid(g, g)
    f1, f2 = rng.uniform(1, 4, 2)
    ph = rng.uniform(0, 2 * np.pi, 2)
    base = np.sin(f1 * np.pi * xx + ph[0]) * np.cos(f2 * np.pi * yy + ph[1])
    blob = np.exp(-((xx - rng.uniform(-.5, .5)) ** 2 +
                    (yy - rng.uniform(-.5, .5)) ** 2) / rng.uniform(.1, .4))
    proto = np.stack([base, blob, base * blob], -1)
    return proto / (np.abs(proto).max() + 1e-6)


def _domain_transform(rng, spec, d):
    mix = rng.uniform(-1, 1, (3, 3))
    mix = mix / np.abs(mix).sum(1, keepdims=True)
    bias = rng.uniform(-0.3, 0.3, 3)
    return mix, bias


def make_dataset(name: str, *, n_per_class: int = 60, seed: int = 0,
                 longtail_gamma: float = 8.0):
    """Returns dict(images (N,32,32,3) float32 [-1,1], labels, domains,
    tokens). Class 0 is underrepresented by ``longtail_gamma``x."""
    spec = SPECS[name]
    rng = np.random.RandomState(seed)
    protos = [_prototype(rng, spec, c) for c in range(spec.n_classes)]
    doms = [_domain_transform(rng, spec, d) for d in range(spec.n_domains)]
    images, labels, domains = [], [], []
    for c in range(spec.n_classes):
        n_c = max(4, int(n_per_class / (longtail_gamma if c == 0 else 1)))
        for _ in range(n_c):
            d = rng.randint(spec.n_domains)
            mix, bias = doms[d]
            img = protos[c] * rng.uniform(0.7, 1.3)
            img = img + 0.25 * _prototype(rng, spec, c) * rng.randn()
            img = np.einsum("hwc,cd->hwd", img, mix) + bias
            img = img + 0.15 * rng.randn(*img.shape)
            images.append(np.clip(img, -1, 1))
            labels.append(c)
            domains.append(d)
    images = np.asarray(images, np.float32)
    labels = np.asarray(labels, np.int32)
    domains = np.asarray(domains, np.int32)
    order = rng.permutation(len(labels))
    images, labels, domains = images[order], labels[order], domains[order]
    return {"images": images, "labels": labels, "domains": domains,
            "tokens": class_tokens(spec, labels), "spec": spec}
