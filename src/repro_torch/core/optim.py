"""Adam with global-norm clipping, port of ``repro.core.optim``.

Optimizer state is a tree mirroring the parameter tree. Updates are
functional, as in the JAX package: ``adam_update`` returns new tensors
and leaves its inputs alone, so a client's starting point (the global
trainables) survives its local steps.

``stacked=True`` is the cohort engine's form of what the JAX engine gets
from ``jax.vmap``: every leaf carries a leading client axis, the step
counter is one per client, and the gradient clip takes each client's
norm over all of its leaves, never the norm of the stacked tree.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree as tree_lib


class AdamState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Any
    nu: Any


def adam_init(params, *, stacked: bool = False) -> AdamState:
    """Zero moments; the step counter is a 0-d int32, or one per client
    (shape ``(C,)``) for a ``stacked`` tree."""
    leaves = tree_lib.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    step_shape = (leaves[0].shape[0],) if stacked else ()
    return AdamState(torch.zeros(step_shape, dtype=torch.int32, device=dev),
                     tree_lib.tree_map(zeros, params),
                     tree_lib.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_lib.leaves(tree)))


def row_norms(tree) -> torch.Tensor:
    """Per client of a stacked tree: the norm over all of its leaves,
    shape ``(C,)``."""
    return torch.sqrt(sum(
        torch.sum(torch.square(l.to(torch.float32)).reshape(l.shape[0], -1),
                  dim=1) for l in tree_lib.leaves(tree)))


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``v`` (0-d or ``(C,)``) shaped to broadcast over ``like``'s
    trailing dims."""
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, *, lr: float, b1=0.9,
                b2=0.999, eps=1e-8, grad_clip=0.0, stacked: bool = False):
    """Returns ``(new_params, new_state)``. The bias corrections are fp32
    on the state's device, as the JAX package computes them. (The JAX
    version also takes a weight decay and an ``lr`` schedule; no caller
    uses either, so the port leaves them out.) ``stacked``: one update
    per client of a leading client axis (clip, counter and bias
    corrections per client; see the module docstring)."""
    step = state.step + 1
    if grad_clip:
        gnorm = row_norms(grads) if stacked else global_norm(grads)
        scale = torch.clamp_max(grad_clip / (gnorm + 1e-9), 1.0)
        grads = tree_lib.tree_map(lambda g: g * _rows(scale, g), grads)
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
        u = (m * _rows(mu_hat_scale, m)) / (
            torch.sqrt(v * _rows(nu_hat_scale, v)) + eps)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_params = tree_lib.tree_map(upd, params, mu, nu)
    return new_params, AdamState(step, mu, nu)


def value_and_grad(loss_fn: Callable, params):
    """``((loss, aux), grads)`` of ``loss_fn(params) -> (loss, aux)``, the
    form of ``jax.value_and_grad(..., has_aux=True)``: autograd through
    detached copies of the leaves, so ``params`` stays out of any graph.
    A leaf the loss does not reach gets a zero gradient, as in JAX."""
    live = tree_lib.tree_map(lambda l: l.detach().requires_grad_(True),
                             params)
    with torch.enable_grad():
        loss, aux = loss_fn(live)
        leaves = tree_lib.leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return (loss.detach(), aux), tree_lib.from_leaves(params, grads)


def _where(live: torch.Tensor, new, old):
    return tree_lib.tree_map(
        lambda a, b: torch.where(_rows(live, a), a, b), new, old)


def adam_scan(grad_fn: Callable, params, state: AdamState, xs, *, lr: float,
              b1=0.9, b2=0.999, eps=1e-8, grad_clip=0.0, active=None,
              stacked: bool = False):
    """The local-training loop: one ``adam_update`` per leading element
    of ``xs``. ``grad_fn(params, x) -> (grads, aux)``; returns
    ``(params, state, aux)`` with every tensor of ``aux`` stacked over
    the steps, as the JAX package's ``lax.scan`` form returns it.

    ``active`` — optional bool tensor, one entry per step (shape
    ``(S,)``, or ``(S, C)`` per client of a ``stacked`` tree). A step
    with ``active[t]`` False keeps the old params and the whole optimizer
    state (moments and step counter) through ``torch.where``, so a scan
    of S steps with the first s active is bitwise s steps. Its aux is
    still emitted (evaluated on the kept params); callers index the last
    active entry."""
    auxs = []
    for t in range(len(xs)):
        g, aux = grad_fn(params, xs[t])
        p2, s2 = adam_update(g, state, params, lr=lr, b1=b1, b2=b2,
                             eps=eps, grad_clip=grad_clip, stacked=stacked)
        if active is not None:
            live = active[t]
            p2 = _where(live, p2, params)
            s2 = AdamState(torch.where(live, s2.step, state.step),
                           _where(live, s2.mu, state.mu),
                           _where(live, s2.nu, state.nu))
        params, state = p2, s2
        auxs.append(aux)
    if auxs and isinstance(auxs[0], tuple):
        aux = tuple(torch.stack(a) for a in zip(*auxs))
    else:
        aux = torch.stack(auxs) if auxs else None
    return params, state, aux


def step_mask(n_steps, length: int, device=None) -> torch.Tensor:
    """The canonical ``active`` mask: the first ``n_steps`` of ``length``
    steps live, the tail a no-op. ``n_steps`` may be a ``(C,)`` tensor of
    per-client counts, giving an ``(length, C)`` mask. Cutting a run at
    ``s`` this way is bitwise running exactly ``s`` steps (params, both
    moments and the step counter)."""
    n = torch.as_tensor(n_steps, device=device)
    t = torch.arange(length, device=n.device)
    return t.reshape((length,) + (1,) * n.ndim) < n
