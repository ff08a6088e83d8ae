"""Conditional GAN for long-tail rebalancing (paper §III-B), port of
``repro.core.gan``.

A small class-conditional DCGAN over 32x32 images: the generator learns
the client's local distribution; under-represented classes are then
over-sampled with synthetic images. Trained client-side, so raw data
never leaves the client.

    min_G max_D V(D,G) = E_x[log D(x)] + E_z[log(1 - D(G(z)))]

with the non-saturating generator objective and feature matching.

Every function takes an optional leading client axis: parameter leaves
``(C, ...)``, ``z (C, B, z_dim)``, labels ``(C, B)``, and one loss per
client, each client's own gradient (no term couples two clients). That
is how the fleet engine (``fl.fleetgan``) trains a cohort of GANs in one
program, where the JAX package uses ``jax.vmap``.

The JAX package draws the GAN's randomness with threefry inside its
programs (init key, per-step batch indices and noise, synthesis noise).
The port takes every draw as an input: :class:`SeededGANStream` is the
standalone source, and a test injects the JAX package's draws through
the same three methods (see ``GANStream``). ``gan_scan`` and
``gan_scan_bucketed`` therefore take pre-drawn ``z``/``z2``; the
bucketed form pads the minibatch to a shared bucket and computes every
batch-mean loss as the masked mean ``sum(per_row * mask) / n_true``, so
padded rows contribute exactly zero gradient. A step with ``active``
False is a bitwise no-op on the params and both Adam states (step
counters included).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Tuple

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import convert, resolve_device
from repro_torch.core import optim
from repro_torch.kernels import gan_conv


@dataclass(frozen=True)
class GANConfig:
    image_size: int = 32
    channels: int = 3
    n_classes: int = 7
    z_dim: int = 32
    g_dim: int = 32
    d_dim: int = 32
    lr: float = 2e-4
    # "lax" (F.conv2d / F.conv_transpose2d) | "gemm" (kernels.gan_conv's
    # phase-decomposed gemms) | "gemm_int8" (the same gemms in int8
    # quantized compute)
    conv_impl: str = "lax"


class GANStream(Protocol):
    """One client's GAN draws, as numpy: the initial parameter tree, the
    training draws for ``steps`` steps of minibatch ``batch`` from a pool
    of ``n`` (indices in [0, n) and both noise tensors), and the
    synthesis noise for ``m`` rows. Each method is a pure function of
    its arguments, so every engine sees the same draws."""

    def init(self, cfg: GANConfig): ...

    def train(self, cfg: GANConfig, n: int, steps: int, batch: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]: ...

    def synth(self, cfg: GANConfig, m: int) -> np.ndarray: ...


@dataclass(frozen=True)
class SeededGANStream:
    """The standalone :class:`GANStream`: CPU ``torch.Generator``s seeded
    from ``words`` and a tag per kind of draw (0 init, 1 training, 2
    synthesis)."""
    words: Tuple[int, ...]

    def _gen(self, tag: int) -> torch.Generator:
        return torch.Generator().manual_seed(int(np.random.SeedSequence(
            [*self.words, tag]).generate_state(1)[0]))

    def init(self, cfg: GANConfig):
        return convert.tree_to_numpy(init_gan(self._gen(0), cfg,
                                              device="cpu"))

    def train(self, cfg, n, steps, batch):
        g = self._gen(1)
        idx = torch.randint(0, int(n), (steps, batch), generator=g)
        z = torch.randn((steps, batch, cfg.z_dim), generator=g)
        z2 = torch.randn((steps, batch, cfg.z_dim), generator=g)
        return idx.numpy(), z.numpy(), z2.numpy()

    def synth(self, cfg, m):
        return torch.randn((m, cfg.z_dim), generator=self._gen(2)).numpy()


def train_draws(stream: GANStream, cfg: GANConfig, n: int, steps: int,
                batch: int):
    """``stream.train``'s ``(idx, z, z2)``, checked, since the stream may
    be injected: ``idx (steps, batch)`` in [0, n), ``z``/``z2`` ``(steps,
    batch, z_dim)``."""
    idx, z, z2 = (np.asarray(a) for a in stream.train(cfg, n, steps, batch))
    want = (steps, batch, cfg.z_dim)
    if idx.shape != want[:2] or z.shape != want or z2.shape != want:
        raise ValueError(f"GAN stream gave idx {idx.shape}, z {z.shape}, z2 "
                         f"{z2.shape}; want {want[:2]} and {want}")
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"GAN stream drew indices outside a pool of {n}")
    return idx.astype(np.int64), z.astype(np.float32), z2.astype(np.float32)


def synth_draws(stream: GANStream, cfg: GANConfig, m: int) -> np.ndarray:
    """``stream.synth``'s ``(m, z_dim)`` noise, checked."""
    z = np.asarray(stream.synth(cfg, m))
    if z.shape != (m, cfg.z_dim):
        raise ValueError(f"GAN stream gave synthesis noise {z.shape}, want "
                         f"{(m, cfg.z_dim)}")
    return z.astype(np.float32)


def init_gan(gen: torch.Generator, cfg: GANConfig, device=None):
    """Seeded parameters in the JAX package's tree layout. Draws on
    ``gen``'s device, stores on ``device``."""
    dev = resolve_device(device)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=gen.device) *
                std).to(dev)

    s = lambda f: 1.0 / math.sqrt(f)
    g0, d0 = cfg.g_dim, cfg.d_dim
    generator = {
        "emb": normal((cfg.n_classes, cfg.z_dim), 0.1),
        "fc": normal((2 * cfg.z_dim, 4 * 4 * 2 * g0), s(2 * cfg.z_dim)),
        "c1": normal((4, 4, 2 * g0, g0), 0.05),            # 4 -> 8
        "c2": normal((4, 4, g0, g0), 0.05),                # 8 -> 16
        "c3": normal((4, 4, g0, cfg.channels), 0.05),      # 16 -> 32
    }
    disc = {
        "c1": normal((4, 4, cfg.channels, d0), 0.05),
        "c2": normal((4, 4, d0, 2 * d0), 0.05),
        "c3": normal((4, 4, 2 * d0, 4 * d0), 0.05),
        "fc": normal((4 * 4 * 4 * d0, 1), s(4 * 4 * 4 * d0)),
        "emb": normal((cfg.n_classes, 4 * 4 * 4 * d0), 0.01),
    }
    return {"gen": generator, "disc": disc}


def _pick(impl, gemm, lax, gemm_int8):
    if impl == "gemm":
        return gemm
    if impl == "lax":
        return lax
    if impl == "gemm_int8":
        return gemm_int8
    raise ValueError(f"unknown conv_impl {impl!r} "
                     "(expected lax | gemm | gemm_int8)")


def _convT(x, w, impl="lax"):
    return _pick(impl, gan_conv.convT4x4_s2, gan_conv.convT4x4_s2_lax,
                 gan_conv.convT4x4_s2_int8)(x, w)


def _conv(x, w, impl="lax"):
    return _pick(impl, gan_conv.conv4x4_s2, gan_conv.conv4x4_s2_lax,
                 gan_conv.conv4x4_s2_int8)(x, w)


def _lookup(table, labels):
    """Rows of an embedding table by label, through ``F.embedding``
    (whose backward sums a label's repeats in a fixed order); a stacked
    table ``(C, n, k)`` is indexed per client by ``(C, B)`` labels."""
    if table.ndim == 2:
        return F.embedding(labels, table)
    C, n = table.shape[:2]
    off = torch.arange(C, device=labels.device)[:, None] * n
    return F.embedding(labels + off, table.reshape(C * n, -1))


def generate(gen, cfg: GANConfig, z, labels):
    """z: (B, z_dim); labels: (B,) -> images (B, 32, 32, 3) in [-1, 1]
    (each with a leading client axis for stacked ``gen``)."""
    y = _lookup(gen["emb"], labels)
    h = torch.cat([z, y], -1) @ gen["fc"]
    h = F.relu(h).reshape(*z.shape[:-1], 4, 4, 2 * cfg.g_dim)
    h = F.relu(_convT(h, gen["c1"], cfg.conv_impl))
    h = F.relu(_convT(h, gen["c2"], cfg.conv_impl))
    return torch.tanh(_convT(h, gen["c3"], cfg.conv_impl))


def discriminate(disc, cfg: GANConfig, images, labels, *,
                 with_features: bool = False):
    impl = cfg.conv_impl
    h = F.leaky_relu(_conv(images, disc["c1"], impl), 0.2)
    h = F.leaky_relu(_conv(h, disc["c2"], impl), 0.2)
    h = F.leaky_relu(_conv(h, disc["c3"], impl), 0.2)
    feat = h.reshape(*images.shape[:-3], -1)         # NHWC order
    logit = (feat @ disc["fc"])[..., 0]
    proj = torch.sum(feat * _lookup(disc["emb"], labels), -1)  # projection
    if with_features:
        return logit + proj, feat
    return logit + proj


def _train_step_core(params, opt_states, batch, cfg: GANConfig, z, z2,
                     batch_mean, feat_mean):
    """The one alternating D/G update body of every granularity.
    ``batch_mean`` reduces per-row loss terms over the batch and
    ``feat_mean`` averages feature rows: the plain means for the exact
    paths, masked forms for the bucketed one. With a client axis each
    loss is ``(C,)`` and the backward runs on their sum."""
    images, labels = batch
    stacked = z.ndim == 3

    def bce(logits, target):
        return batch_mean(torch.clamp_min(logits, 0) - logits * target +
                          torch.log1p(torch.exp(-torch.abs(logits))))

    with torch.no_grad():
        fake = generate(params["gen"], cfg, z, labels)

    def d_loss(disc):
        lr_ = discriminate(disc, cfg, images, labels)
        lf = discriminate(disc, cfg, fake, labels)
        loss = bce(lr_, 1.0) + bce(lf, 0.0)
        return loss.sum(), loss.detach()

    (_, dl), dg = optim.value_and_grad(d_loss, params["disc"])
    disc, d_opt = optim.adam_update(dg, opt_states["disc"], params["disc"],
                                    lr=cfg.lr, b1=0.5, stacked=stacked)

    with torch.no_grad():
        _, feat_r = discriminate(disc, cfg, images, labels,
                                 with_features=True)

    def g_loss(gen):
        fake = generate(gen, cfg, z2, labels)
        lf, feat_f = discriminate(disc, cfg, fake, labels,
                                  with_features=True)
        # feature matching (Salimans et al. 2016): anchors G's statistics
        # to the data manifold
        fm = torch.mean((feat_mean(feat_r) - feat_mean(feat_f)) ** 2, -1)
        loss = bce(lf, 1.0) + 10.0 * fm
        return loss.sum(), loss.detach()

    (_, gl), gg = optim.value_and_grad(g_loss, params["gen"])
    gen, g_opt = optim.adam_update(gg, opt_states["gen"], params["gen"],
                                   lr=cfg.lr, b1=0.5, stacked=stacked)
    return ({"gen": gen, "disc": disc}, {"gen": g_opt, "disc": d_opt},
            {"d_loss": dl, "g_loss": gl})


def train_step_impl(params, opt_states, batch, cfg: GANConfig, z, z2):
    """One alternating D/G update on an exact batch; ``z``/``z2`` are the
    step's noise at the batch's shape."""
    return _train_step_core(params, opt_states, batch, cfg, z, z2,
                            batch_mean=lambda t: t.mean(-1),
                            feat_mean=lambda f: f.mean(-2))


def train_step_bucketed(params, opt_states, batch, cfg: GANConfig, z, z2,
                        n_true):
    """One alternating D/G update on a minibatch padded to a shared
    bucket: rows ``>= n_true`` (0-d, or ``(C,)`` per client) of ``batch``
    and ``z``/``z2`` are padding. Every batch-mean loss is the masked mean
    ``sum(per_row * mask) / n_true`` and the feature statistics are
    masked means, so a padded row's every term is multiplied by exactly
    0.0 before the reduction."""
    B = z.shape[-2]
    n = torch.as_tensor(n_true, dtype=torch.float32, device=z.device)
    mask = (torch.arange(B, device=z.device) < n[..., None]).to(torch.float32)
    return _train_step_core(
        params, opt_states, batch, cfg, z, z2,
        batch_mean=lambda t: torch.sum(t * mask, -1) / n,
        feat_mean=lambda f: torch.sum(f * mask[..., None], -2) / n[..., None])


def adam_init(params, *, stacked: bool = False):
    """Zero Adam states for both networks."""
    return {k: optim.adam_init(params[k], stacked=stacked)
            for k in ("gen", "disc")}


def _scan(step, params, opt_states, images, labels, idx, z, z2, active):
    """The loop of :func:`gan_scan` / :func:`gan_scan_bucketed`:
    ``step(params, opt, batch, z_t, z2_t)`` per step; with ``active``,
    a False step keeps the params and both Adam states bitwise."""
    stacked = idx.ndim == 3
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None] \
        if stacked else None
    d_l, g_l = [], []
    for t in range(idx.shape[-2]):
        ix = idx[..., t, :]
        batch = (images[rows, ix], labels[rows, ix]) if stacked else \
            (images[ix], labels[ix])
        p2, o2, m = step(params, opt_states, batch, z[..., t, :, :],
                         z2[..., t, :, :])
        if active is not None:
            live = active[..., t]
            kept = {k: optim.keep_where(live, p2[k], o2[k], params[k],
                                        opt_states[k]) for k in p2}
            p2 = {k: v[0] for k, v in kept.items()}
            o2 = {k: v[1] for k, v in kept.items()}
        params, opt_states = p2, o2
        d_l.append(m["d_loss"])
        g_l.append(m["g_loss"])
    return params, opt_states, {"d_loss": torch.stack(d_l, -1),
                                "g_loss": torch.stack(g_l, -1)}


def gan_scan(params, opt_states, cfg: GANConfig, images, labels, idx, z,
             z2, *, active=None):
    """GAN training as a loop of :func:`train_step_impl` over pre-drawn
    batch indices ``idx (steps, batch)`` and noise ``z``/``z2`` ``(steps,
    batch, z_dim)`` (with a client axis: ``images (C, P, ...)``, ``idx
    (C, steps, batch)``, ``z (C, steps, batch, z_dim)``). ``active``:
    optional per-step bool ``(steps,)`` or ``(C, steps)``; a False step
    is a bitwise no-op, its metrics still emitted (on the kept params).
    Returns ``(params, opt_states, {"d_loss", "g_loss"})``, the metrics
    ``(steps,)`` or ``(C, steps)``."""
    step = lambda p, o, b, za, zb: train_step_impl(p, o, b, cfg, za, zb)
    return _scan(step, params, opt_states, images, labels, idx, z, z2,
                 active)


def gan_scan_bucketed(params, opt_states, cfg: GANConfig, images, labels,
                      idx, z, z2, n_true, *, active=None):
    """:func:`gan_scan` on minibatches padded to a shared bucket: every
    step is :func:`train_step_bucketed` with true batch size ``n_true``
    (0-d, or ``(C,)``)."""
    step = lambda p, o, b, za, zb: train_step_bucketed(p, o, b, cfg, za, zb,
                                                       n_true)
    return _scan(step, params, opt_states, images, labels, idx, z, z2,
                 active)


def rebalance_labels(labels, n_classes: int) -> np.ndarray:
    """Labels of the synthetic samples that top every class up to the
    local max count (paper §III-B): the host-side ``need`` computation
    shared by ``Client.prepare_gan`` and the fleet engine."""
    hist = np.bincount(np.asarray(labels), minlength=n_classes)
    target = hist.max() if len(hist) else 0
    if not target:
        return np.array([], np.int32)
    return np.concatenate([
        np.full(max(0, int(target - hist[c])), c, np.int32)
        for c in range(n_classes)])


def train_gan(params, cfg: GANConfig, images, labels, idx, z, z2):
    """Train from ``params`` on a client's local data with the pre-drawn
    ``idx``/``z``/``z2`` (one step each); returns ``(params, metrics)``,
    the last step's losses."""
    params, _, ms = gan_scan(params, adam_init(params), cfg, images, labels,
                             idx, z, z2)
    return params, {k: v[-1] for k, v in ms.items()}


def synthesize(z, gen, cfg: GANConfig, labels):
    """Synthetic images for ``labels`` from the noise ``z``."""
    return generate(gen, cfg, z, labels)
