"""FL client, port of ``repro.fl.client``: the trainable tree, the
forward to zero-shot class logits, and :class:`Client`, whose
``local_train`` is the sequential reference path that the cohort engine
is held to.

Per round a client runs local Adam steps on the adapter (+ vision LoRA)
against the zero-shot class-prompt head and returns its *update* (the
delta of its trainables), blockwise-quantized when the strategy
compresses communication. For the ``tripleplay`` arm,
``Client.prepare_gan`` first trains the client's conditional GAN and
synthesizes the rebalancing set that ``pool()`` adds to its samples.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch import tree as tree_lib
from repro_torch.core import adapter as adapter_lib
from repro_torch.core import clip as clip_lib
from repro_torch.core import gan as gan_lib
from repro_torch.core import losses, optim
from repro_torch.core.quant import tree_bytes
from repro_torch.fl import strategies as strategies_lib
from repro_torch.fl.strategies import Strategy

LORA_RANK = 4


def init_trainable(generator: torch.Generator, ccfg: clip_lib.CLIPConfig,
                   strategy: Strategy, device=None):
    """The attention adapter, plus rank-4 LoRA pairs on wq/wk/wv/wo of
    every vision block (stacked on the layer axis) for LoRA arms."""
    dev = resolve_device(device)
    d = ccfg.d_model
    tr: Dict[str, Any] = {"adapter": adapter_lib.init(
        generator, d, n_heads=4, d_ff=d, device=dev)}
    if strategy.use_lora:
        L = ccfg.vision_layers

        def pair():
            a = torch.randn((L, d, LORA_RANK), generator=generator,
                            device=generator.device) * (1 / math.sqrt(d))
            return {"a": a.to(dev),
                    "b": torch.zeros((L, LORA_RANK, d), device=dev)}

        tr["lora"] = {n: pair() for n in ("wq", "wk", "wv", "wo")}
    return tr


def head_logits(frozen, trainable, feat, class_emb):
    """Pooled backbone features -> zero-shot class logits through the
    trainable adapter head."""
    feat = adapter_lib.apply(trainable["adapter"], feat[:, None, :],
                             n_heads=4, causal=False)[:, 0]
    emb = feat @ frozen["proj_v"]
    return clip_lib.zero_shot_logits(emb, class_emb, frozen["logit_scale"])


def forward_logits(frozen, trainable, ccfg, images, class_emb):
    """images -> zero-shot class logits through backbone+adapter."""
    lora = trainable.get("lora")
    feat = clip_lib.encode_image(frozen, ccfg, images, lora=lora)
    return head_logits(frozen, trainable, feat, class_emb)


def _local_step(frozen, trainable, opt_state, batch, class_emb, ccfg, lr):
    """One local Adam step (grad clip 1.0) on a batch of images."""
    images, labels = batch

    def loss_fn(tr):
        logits = forward_logits(frozen, tr, ccfg, images, class_emb)
        return (losses.cross_entropy(logits, labels),
                losses.accuracy(logits.detach(), labels))

    (loss, acc), grads = optim.value_and_grad(loss_fn, trainable)
    trainable, opt_state = optim.adam_update(grads, opt_state, trainable,
                                             lr=lr, grad_clip=1.0)
    return trainable, opt_state, loss, acc


@dataclass
class Client:
    cid: int
    images: np.ndarray
    labels: np.ndarray
    n_classes: int
    strategy: Strategy
    gan_params: Optional[dict] = None
    gan_cfg: Optional[gan_lib.GANConfig] = None
    aug_images: Optional[np.ndarray] = None
    aug_labels: Optional[np.ndarray] = None
    # availability-trace heterogeneity hook: this client runs
    # ``step_mult`` x the configured local steps per round
    step_mult: int = 1

    @property
    def n(self) -> int:
        return len(self.labels)

    def local_steps_for(self, base_steps: int) -> int:
        """Per-round local step count under this client's trace-assigned
        compute multiplier."""
        return int(base_steps) * max(1, int(self.step_mult))

    def prepare_gan(self, stream: gan_lib.GANStream, *, steps: int = 150,
                    device=None):
        """Train the local conditional GAN on ``device`` (the card unless
        the caller asks for the CPU) with the draws of ``stream`` and
        synthesize a rebalancing set so every class reaches the local
        max count (paper §III-B). The sequential per-client path: one
        step at a time, the fleet engine's oracle
        (``fl.fleetgan.prepare_gan_fleet``) on the same stream."""
        dev = resolve_device(device)
        cfg = self.gan_cfg = gan_lib.GANConfig(n_classes=self.n_classes)
        idx, z, z2 = gan_lib.train_draws(
            stream, cfg, self.n, steps, strategies_lib.gan_batch_size(self.n))
        as_t = lambda a: torch.as_tensor(a, device=dev)
        self.gan_params, _ = gan_lib.train_gan(
            convert.tree_from_numpy(stream.init(cfg), dev), cfg,
            as_t(np.asarray(self.images, np.float32)),
            as_t(np.asarray(self.labels, np.int64)), as_t(idx), as_t(z),
            as_t(z2))
        need = gan_lib.rebalance_labels(self.labels, self.n_classes)
        if len(need) == 0:
            self.aug_images = np.zeros((0, *self.images.shape[1:]),
                                       np.float32)
            self.aug_labels = np.zeros((0,), np.int32)
            return
        with torch.no_grad():
            imgs = gan_lib.synthesize(
                as_t(gan_lib.synth_draws(stream, cfg, len(need))),
                self.gan_params["gen"], cfg, as_t(need.astype(np.int64)))
        self.aug_images = imgs.cpu().numpy().astype(np.float32)
        self.aug_labels = need

    def pool(self):
        """Local training pool: real samples + GAN rebalancing set."""
        if self.strategy.use_gan and self.aug_images is not None and \
                len(self.aug_labels):
            return (np.concatenate([self.images, self.aug_images]),
                    np.concatenate([self.labels, self.aug_labels]))
        return self.images, self.labels

    def local_train(self, frozen, trainable, class_emb, ccfg, *,
                    steps: int, batch_size: int, lr: float, seed: int = 0,
                    indices: Optional[np.ndarray] = None):
        """Sequential reference path, one step per batch, on the device
        of ``class_emb``. ``indices`` — optional (steps, batch) pool-index
        matrix replacing the seeded ``np.random.RandomState`` sampling,
        so the cohort engine's index stream can drive this path as its
        oracle. Returns ``(trainable, {"loss", "acc"})``, the last
        step's values as floats."""
        imgs, labs = self.pool()
        if indices is None:
            rng = np.random.RandomState(seed)
            # full batch_size even when the pool is smaller (bootstrap
            # resampling), as the cohort engine draws
            indices = rng.randint(0, len(labs), (steps, batch_size))
        dev = class_emb.device
        imgs_t = torch.as_tensor(np.asarray(imgs, np.float32), device=dev)
        labs_t = torch.as_tensor(np.asarray(labs), dtype=torch.long,
                                 device=dev)
        idx_t = torch.as_tensor(np.array(indices), dtype=torch.long,
                                device=dev)
        opt = optim.adam_init(trainable)
        loss = acc = 0.0
        for idx in idx_t:
            trainable, opt, loss, acc = _local_step(
                frozen, trainable, opt, (imgs_t[idx], labs_t[idx]),
                class_emb, ccfg, lr)
        return trainable, {"loss": float(loss), "acc": float(acc)}

    def make_update(self, before, after):
        """Delta of trainables, quantized per strategy. Returns
        (update_tree, payload_bytes)."""
        delta = tree_lib.tree_map(lambda a, b: (a - b).to(torch.float32),
                                  after, before)
        delta = self.strategy.comm_quantize(delta)
        return delta, tree_bytes(delta)
