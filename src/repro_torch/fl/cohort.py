"""Batched cohort execution, port of ``repro.fl.cohort``: a federated
round of every client's local training as one stacked program.

The JAX engine runs a round as ``jax.vmap`` over clients of a
``lax.scan`` over local steps. The port has no ``vmap`` over its kernels
(the flash-attention op launches a hand-written kernel), so it stacks
the clients explicitly:

 - every trainable leaf gains a leading client axis ``(C, ...)``;
 - each client's pool is staged once, padded to ``(C, P, ...)``, and
   hoists every trainable-independent prefix of the forward: pooled
   backbone features for adapter-only arms, embedded patch tokens for
   LoRA arms (:func:`stage_encoded_pools`);
 - a local step gathers each client's batch ``(C, B, ...)``, runs the
   adapter with per-client batched matmuls and one flash-attention
   launch over the ``(C·B, 1, heads, d/heads)`` fold of the cohort, the
   LoRA blocks with per-row factors, and takes one ``backward`` of the
   sum over clients of each client's mean cross-entropy — no term
   couples two clients, so each gets exactly its own gradient;
 - Adam runs per client (``optim.adam_update(stacked=True)``: each
   client's own gradient clip and step counter, as under ``vmap``);
 - the uplink quantizes the stacked deltas along trailing dims with the
   per-client block choice, bitwise each client's own quantization
   (:func:`comm_quantize_stacked`), and FedAvg is one ``tensordot`` per
   leaf (``server.aggregate_stacked``).

Batch indices come from outside the program, as in the JAX package: a
:class:`RoundKey` names the stream and the round, and
:func:`round_indices` draws the same indices for the engine and for the
sequential oracle (``Client.local_train``). Subset rounds, async waves,
fleet-GAN pools and meshes raise: ``ROADMAP.md`` Queue A items 4 and 6.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import adapter as adapter_lib
from repro_torch.core import clip as clip_lib
from repro_torch.core import optim, quant
from repro_torch.core.quant import tree_bytes
from repro_torch.data.synthetic import stage_client_pools
from repro_torch.fl import client as client_lib
from repro_torch.fl import runtime as runtime_lib
from repro_torch.fl import server
from repro_torch.fl import strategies as strategies_lib
from repro_torch.fl.strategies import Strategy


@dataclass(frozen=True)
class CohortConfig:
    """Static round-execution parameters."""
    strategy: Strategy
    local_steps: int
    batch_size: int
    lr: float
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded cohort is not ported (one card; "
                "ROADMAP.md Queue A item 8)")


@dataclass(frozen=True)
class RoundKey:
    """The port's stand-in for a round's PRNG key: the stream that draws
    batch indices, ``draw(rnd, lens, steps, batch) -> (C, steps, batch)``,
    and the round it draws for (-1: the warm-up round)."""
    draw: Callable
    rnd: int


def seeded_index_stream(seed: int) -> Callable:
    """A batch-index stream for standalone runs: a CPU
    ``torch.Generator`` seeded from (``seed``, round) draws client i's
    ``(steps, batch)`` indices in [0, lens[i]), clients in order. A pure
    function of its arguments, so every executor sees the same batches."""
    def draw(rnd, lens, steps, batch):
        words = [seed, 4] if rnd < 0 else [seed, 3, rnd]
        g = torch.Generator().manual_seed(
            int(np.random.SeedSequence(words).generate_state(1)[0]))
        return np.stack([torch.randint(0, int(n), (steps, batch),
                                       generator=g).numpy() for n in lens])
    return draw


def round_indices(key: RoundKey, lens, steps: int, batch: int) -> np.ndarray:
    """One round's per-client batch indices, ``(C, steps, batch)``,
    client i's in [0, lens[i]); checked, since the stream may be
    injected."""
    lens = np.asarray(lens, np.int32)
    idx = np.asarray(key.draw(key.rnd, lens, steps, batch))
    if idx.shape != (len(lens), steps, batch):
        raise ValueError(f"index stream gave shape {idx.shape}, want "
                         f"{(len(lens), steps, batch)}")
    if idx.size and (idx.min() < 0 or np.any(
            idx.reshape(len(lens), -1).max(1) >= lens)):
        raise ValueError("index stream drew outside a client's pool")
    return idx.astype(np.int64)


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


@torch.no_grad()
def stage_encoded_pools(frozen, ccfg, *, use_lora: bool, imgs,
                        chunk: int = 512, runtime=None) -> torch.Tensor:
    """Encode padded client pools ``(C, P, H, W, ch)`` (numpy or a
    tensor) via :func:`encode_rows` on the frozen tree's device and
    reshape back to the cohort layout."""
    dev = frozen["proj_v"].device
    imgs = torch.as_tensor(imgs, dtype=torch.float32, device=dev)
    C, P = imgs.shape[:2]
    staged = encode_rows(frozen, ccfg, use_lora=use_lora,
                         rows=imgs.reshape(C * P, *imgs.shape[2:]),
                         runtime=runtime, chunk=chunk)
    return staged.reshape(C, P, *staged.shape[1:])


def client_logits(frozen, ccfg, trainable, x, class_emb, *,
                  use_lora: bool):
    """One client's forward from its *staged* input to zero-shot class
    logits: ``x`` is pooled backbone features (adapter-only arms) or
    embedded patch tokens (LoRA arms)."""
    feat = clip_lib.encode_tokens(frozen, ccfg, x,
                                  lora=trainable.get("lora")) \
        if use_lora else x
    return client_lib.head_logits(frozen, trainable, feat, class_emb)


def cohort_logits(frozen, ccfg, trainable, x, class_emb, *,
                  use_lora: bool):
    """:func:`client_logits` for C clients at once: ``trainable`` leaves
    carry a leading client axis, ``x`` is ``(C, B, ...)`` staged input,
    the result ``(C, B, n_classes)``. The LoRA blocks run on the
    ``(C·B, ...)`` fold with per-row factors ``(L, C·B, ., .)``, client
    c's expanded over its B rows (autograd sums them back per client)."""
    C, B = x.shape[:2]
    if use_lora:
        def rows(t):                       # (C, L, k, n) -> (L, C·B, k, n)
            t = t.transpose(0, 1)[:, :, None]
            return t.expand(t.shape[0], C, B, *t.shape[3:]).reshape(
                t.shape[0], C * B, *t.shape[3:])
        lora = tree_lib.tree_map(rows, trainable["lora"])
        feat = clip_lib.encode_tokens(
            frozen, ccfg, x.reshape(C * B, *x.shape[2:]), lora=lora)
        x = feat.reshape(C, B, -1)
    feat = adapter_lib.apply_stacked(trainable["adapter"], x[:, :, None, :],
                                     n_heads=4, causal=False)[:, :, 0]
    emb = feat @ frozen["proj_v"]
    return clip_lib.zero_shot_logits(emb, class_emb, frozen["logit_scale"])


def _client_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per client of ``(C, B, V)`` logits: ``losses.cross_entropy`` of its
    B rows, shape ``(C,)``."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean(-1)


def slice_client_delta(stacked_delta, i: int):
    """Client ``i``'s delta from a stacked (possibly quantized) delta
    tree; a QTensor leaf keeps per-client metadata, so ``tree_bytes``
    reports the true per-client uplink payload."""
    def f(l):
        if isinstance(l, quant.QTensor):
            return quant.QTensor(
                q=l.q[i], scales=l.scales[i], bits=l.bits, mode=l.mode,
                block=l.block, out_dtype=l.out_dtype,
                orig_shape=tuple(l.orig_shape[1:]))
        return l[i]
    return tree_lib.tree_map(f, stacked_delta)


def comm_quantize_stacked(delta, strategy: Strategy):
    """Uplink-quantize a stacked delta tree (leading cohort axis) with
    the semantics of each client quantizing its own delta: eligibility
    and block come from the *per-client* leaf shape, and the blockwise
    absmax runs along trailing dims only, so the leading axis is inert
    and the payload is bitwise each client's own."""
    if not strategy.comm_bits:
        return delta

    def one(path, leaf):
        per_client = tuple(leaf.shape[1:])
        if not quant._quantizable(tree_lib.path_str(path), per_client,
                                  leaf.dtype, strategies_lib.COMM_MIN_SIZE,
                                  strategies_lib.COMM_SKIP):
            return leaf
        b = quant._pick_block(per_client[-2], strategies_lib.COMM_BLOCK)
        bits = 8 if b % 2 else strategy.comm_bits
        return quant.quantize(leaf, bits=bits, block=b, mode="linear")
    return tree_lib.map_with_path(one, delta)


class CohortEngine:
    """One-program-per-round federated executor, built once per
    simulation from the instantiated clients; ``run_round`` advances the
    global trainables and returns per-client last-step loss/acc."""

    def __init__(self, *, frozen, ccfg, class_emb,
                 clients: Sequence[client_lib.Client], cfg: CohortConfig,
                 runtime=None, gan_job=None):
        if gan_job is not None:
            self._merge_gan_features(gan_job, clients)
        self.cfg = cfg
        self.runtime = runtime if runtime is not None else \
            runtime_lib.ProgramRuntime()
        self.n_clients = len(clients)
        empty = [c.cid for c in clients if len(c.pool()[1]) == 0]
        if empty:
            raise ValueError(
                f"clients {empty} have empty pools; federated rounds "
                "(sequential or cohort) need every participant to hold "
                "data — drop them from the cohort")
        imgs, labs, lens = stage_client_pools([c.pool() for c in clients])
        self.client_n = np.asarray([c.n for c in clients], np.float32)
        weights = self.client_n / self.client_n.sum()
        server.check_weights(weights, self.n_clients)   # on the host
        self.step_mult = np.asarray(
            [c.local_steps_for(1) for c in clients], np.int32)
        if self.step_mult.max() > strategies_lib.MAX_STEP_MULT:
            raise ValueError(
                f"client step multipliers {self.step_mult.max()} exceed "
                f"strategies.MAX_STEP_MULT={strategies_lib.MAX_STEP_MULT}")
        self.max_steps = cfg.local_steps * int(self.step_mult.max())
        self._het = bool(self.step_mult.max() > 1)

        dev = class_emb.device
        self.pool_staged = stage_encoded_pools(
            frozen, ccfg, use_lora=cfg.strategy.use_lora, imgs=imgs,
            runtime=self.runtime)
        self.pool_labs = torch.as_tensor(labs, dtype=torch.long, device=dev)
        self.lens = np.asarray(lens, np.int32)
        self.weights = torch.as_tensor(weights, dtype=torch.float32,
                                       device=dev)
        self.frozen = frozen
        self.class_emb = class_emb
        self.ccfg = ccfg
        self._uplink_per_client: Optional[int] = None
        self._static_key = (cfg.strategy, ccfg, cfg.local_steps,
                            cfg.batch_size, cfg.lr, self._het,
                            self.max_steps)

    def _merge_gan_features(self, gan_job, clients):
        raise NotImplementedError(
            "fleet-GAN pools (the tripleplay arm) are not ported yet "
            "(ROADMAP.md Queue A item 4)")

    def _sample_idx(self, key: RoundKey, lens, steps: int) -> torch.Tensor:
        """Per-round batch indices through the runtime cache (kind
        ``sample_idx``), as a long tensor on the engine's device."""
        batch = self.cfg.batch_size

        def build():
            return lambda k, l: round_indices(k, l, steps, batch)

        idx = self.runtime.run("sample_idx", build, (key, lens),
                               static_key=(steps, batch))
        return torch.as_tensor(idx, dtype=torch.long,
                               device=self.pool_labs.device)

    # -- uplink accounting --------------------------------------------
    def per_client_uplink_bytes(self, global_tr) -> int:
        """One client's (quantized) delta payload: shape-only (``meta``
        tensors through ``quant.quantize_tree_specs``), exact for every
        participant because the quantization is leading-axis-inert."""
        if self._uplink_per_client is None:
            specs = tree_lib.tree_map(
                lambda g: torch.empty(g.shape, dtype=torch.float32,
                                      device="meta"), global_tr)
            if self.cfg.strategy.comm_bits:
                specs = quant.quantize_tree_specs(
                    specs, bits=self.cfg.strategy.comm_bits,
                    block=strategies_lib.COMM_BLOCK,
                    min_size=strategies_lib.COMM_MIN_SIZE,
                    skip_names=strategies_lib.COMM_SKIP)
            self._uplink_per_client = tree_bytes(specs)
        return self._uplink_per_client

    def uplink_bytes(self, global_tr) -> int:
        """Full-cohort round uplink: n_clients x per-client delta size."""
        return self.n_clients * self.per_client_uplink_bytes(global_tr)

    # -- the round ------------------------------------------------------
    def _train_cohort(self, global_tr, staged, labs, idx, frozen,
                      class_emb):
        """Broadcast the global trainables over the cohort, run every
        client's local steps, and return (stacked quantized deltas,
        last-step loss, last-step acc)."""
        C = idx.shape[0]
        use_lora = self.cfg.strategy.use_lora
        ccfg = self.ccfg
        cohort_tr = tree_lib.tree_map(
            lambda g: g.expand(C, *g.shape).contiguous(), global_tr)
        rows = torch.arange(C, device=idx.device)[:, None]

        def grad_fn(t, ixt):
            bx, by = staged[rows, ixt], labs[rows, ixt]

            def loss_fn(tt):
                logits = cohort_logits(frozen, ccfg, tt, bx, class_emb,
                                       use_lora=use_lora)
                ce = _client_ce(logits, by)
                acc = (torch.argmax(logits.detach(), -1) == by).to(
                    torch.float32).mean(-1)
                return ce.sum(), (ce.detach(), acc)

            (_, aux), g = optim.value_and_grad(loss_fn, t)
            return g, aux

        tr, _, (ls, accs) = optim.adam_scan(
            grad_fn, cohort_tr, optim.adam_init(cohort_tr, stacked=True),
            idx.transpose(0, 1), lr=self.cfg.lr, grad_clip=1.0,
            stacked=True)
        delta = tree_lib.tree_map(
            lambda a, g: (a - g[None]).to(torch.float32), tr, global_tr)
        return comm_quantize_stacked(delta, self.cfg.strategy), ls[-1], \
            accs[-1]

    def _build_round(self):
        def round_fn(global_tr, idx, pool_staged, pool_labs, weights,
                     frozen, class_emb):
            delta, loss, acc = self._train_cohort(
                global_tr, pool_staged, pool_labs, idx, frozen, class_emb)
            return server.aggregate_stacked(global_tr, weights, delta), \
                loss, acc

        return round_fn

    def run_subset_round(self, global_tr, sel, key, n_steps=None):
        raise NotImplementedError(
            "subset rounds (sync-partial participation) are not ported "
            "yet (ROADMAP.md Queue A item 6)")

    def run_wave(self, global_tr, sel, key, n_steps=None):
        raise NotImplementedError(
            "async waves are not ported yet (ROADMAP.md Queue A item 6)")

    def run_round(self, global_tr, key: RoundKey):
        """Advance one full-cohort federated round. Returns
        (new_global_trainables, metrics) where metrics carries per-client
        last-step loss/acc (device tensors) and the round's uplink byte
        count."""
        if self._het:
            raise ValueError(
                "run_round is the homogeneous (unmasked) full-cohort "
                f"program, but clients carry step_mult {self.step_mult}")
        uplink = self.uplink_bytes(global_tr)
        idx = self._sample_idx(key, self.lens, self.cfg.local_steps)
        args = (global_tr, idx, self.pool_staged, self.pool_labs,
                self.weights, self.frozen, self.class_emb)
        new_tr, loss, acc = self.runtime.run(
            "full_round", self._build_round, args,
            static_key=self._static_key)
        return new_tr, {"loss": loss, "acc": acc, "uplink_bytes": uplink}
