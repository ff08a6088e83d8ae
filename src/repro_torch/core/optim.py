"""Adam with global-norm clipping, port of ``repro.core.optim``.

Optimizer state is a tree mirroring the parameter tree. Updates are
functional, as in the JAX package: ``adam_update`` returns new tensors
and leaves its inputs alone, so a client's starting point (the global
trainables) survives its local steps. The cohort engine's ``adam_scan``
and ``step_mask`` come with the FL-round slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_lib


class AdamState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Any
    nu: Any


def adam_init(params) -> AdamState:
    leaves = tree_lib.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                     tree_lib.tree_map(zeros, params),
                     tree_lib.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_lib.leaves(tree)))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, *, lr: float, b1=0.9,
                b2=0.999, eps=1e-8, grad_clip=0.0):
    """Returns ``(new_params, new_state)``. The bias corrections are fp32
    on the state's device, as the JAX package computes them. (The JAX
    version also takes a weight decay and an ``lr`` schedule; no caller
    uses either, so the port leaves them out.)"""
    step = state.step + 1
    if grad_clip:
        gnorm = global_norm(grads)
        scale = torch.clamp_max(grad_clip / (gnorm + 1e-9), 1.0)
        grads = tree_lib.tree_map(lambda g: g * scale, grads)
    mu = tree_lib.tree_map(
        lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state.mu, grads)
    nu = tree_lib.tree_map(
        lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
        state.nu, grads)
    stepf = step.to(torch.float32)
    f32 = lambda c: torch.tensor(c, dtype=torch.float32, device=step.device)
    mu_hat_scale = 1.0 / (1 - f32(b1) ** stepf)
    nu_hat_scale = 1.0 / (1 - f32(b2) ** stepf)

    def upd(p, m, v):
        u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + eps)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_params = tree_lib.tree_map(upd, params, mu, nu)
    return new_params, AdamState(step, mu, nu)
