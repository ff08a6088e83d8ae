"""The JAX package's GAN draws as a port ``GANStream``, shared by the
port's GAN tests: for a client key ``k`` (the simulator's ``fold_in(rng,
GAN_RNG_OFFSET + i)``), the init of ``split(k)[0]``, the indices and
noise of ``gan_key_stream(k, steps)`` at the true batch, and the
synthesis noise of ``fold_in(k, 1)`` — bitwise what the JAX package's
``Client.prepare_gan`` and fleet engine consume."""
import dataclasses
from functools import partial

import jax
import numpy as np

from repro.core import gan as jgan


def jax_cfg(cfg):
    """The JAX package's GANConfig for a port one."""
    return jgan.GANConfig(**dataclasses.asdict(cfg))


# init_gan compiles in seconds under jit and ten times that eagerly
_init = jax.jit(jgan.init_gan, static_argnums=1)


@partial(jax.jit, static_argnums=(2, 3, 4))
def _train(key, n, steps, batch, z_dim):
    _, kbs, kss = jgan.gan_key_stream(key, steps)
    return (jgan.gan_batch_indices(kbs, n, batch),
            *jgan.gan_z_stream(kss, batch, z_dim))


class JaxGANStream:
    def __init__(self, key):
        self.key = key

    def init(self, cfg):
        k0, _ = jax.random.split(self.key)
        return jax.tree.map(np.asarray, _init(k0, jax_cfg(cfg)))

    def train(self, cfg, n, steps, batch):
        return tuple(np.asarray(a) for a in _train(self.key, n, steps, batch,
                                                   cfg.z_dim))

    def synth(self, cfg, m):
        return np.asarray(jax.random.normal(
            jax.random.fold_in(self.key, 1), (m, cfg.z_dim)))
