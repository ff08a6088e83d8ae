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
sequential oracle (``Client.local_train``). A pending fleet-GAN job
(``gan_job``) lands in the staged pools as in the reference: raw rows
and zero rows reserved for the synthetic ones are staged first, then
the job is resolved and its rows encoded into their slots.

Subset rounds (``run_subset_round``, sync-partial participation) and
async waves (``run_wave``) run the same local training on a selection of
K clients: it is gathered from the staged pools at a power-of-two
bucketed width (``runtime.bucket_width``; pad rows train on client 0's
pool at index 0 and carry zero aggregation weight), with batch indices
drawn at the true K before any padding. Heterogeneous step counts (a
trace's multipliers, or chaos cuts with ``CohortConfig.force_het``) mask
the tail of the fixed-length scan per client (``optim.step_mask``).

With ``CohortConfig.mesh`` (a :class:`repro_torch.launch.mesh.Mesh`; one
process a rank) the cohort axis is split over the mesh's data-parallel
ranks: each rank stages and trains its contiguous rows of the cohort
(``mesh.cohort_rows``), FedAvg runs hierarchically
(``server.aggregate_tree(mesh=)``: each rank reduces its own rows, one
all-reduce of the shards' partials), and the metrics are all-gathered.
Subset and wave widths bucket to shard multiples; a rank's rows of a
selection are fetched from their owners by a reduce-scatter of the
owner-filled rows (exact: every other rank adds zeros), and a wave's
deltas are all-gathered for the scheduler. The batch indices stay
host-side draws at the true width, so a round is mesh-invariant.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import runtime as rt_lib


@dataclass(frozen=True)
class CohortConfig:
    """Static round-execution parameters."""
    strategy: Strategy
    local_steps: int
    batch_size: int
    lr: float
    mesh: Any = None
    # stage the masked (heterogeneous-step) programs even when every
    # client's trace multiplier is 1: chaos cuts step counts per client
    force_het: bool = False



@dataclass(frozen=True)
class RoundKey:
    """The port's stand-in for a PRNG key: ``draws`` serves the run's
    random draws and ``path`` is the tuple of ``jax.random.fold_in`` tags
    from the run's root key that names this key (in ``run_federated``:
    the warm-up key ``(4,)``, round r's ``(3, r)``, the chaos key
    ``(5,)``), so an injected stream can rebuild the JAX package's key.
    ``draws`` has ``batch_indices(path, lens, steps, batch)``,
    ``choice(path, n, k, p)``, ``uniform(path, n)`` and
    ``normal(path, n)`` (``simulator.Streams``, or :class:`SeededDraws`);
    every draw is checked here, since it may be injected."""
    draws: Any
    path: Tuple[int, ...] = ()

    def fold(self, tag: int) -> "RoundKey":
        """The key ``jax.random.fold_in(key, tag)`` would give."""
        return RoundKey(self.draws, self.path + (int(tag),))

    def _fn(self, kind: str):
        fn = getattr(self.draws, kind, None)
        if fn is None:
            raise ValueError(f"the run's draws cannot serve a {kind} draw "
                             f"(key path {self.path})")
        return fn

    def choice(self, n: int, k: int, p) -> np.ndarray:
        """``k`` distinct positions in [0, n), drawn without replacement
        with probabilities ``p``."""
        pick = np.asarray(self._fn("choice")(
            self.path, int(n), int(k), np.asarray(p, np.float64)))
        if pick.shape != (k,) or len(np.unique(pick)) != k or (
                k and (pick.min() < 0 or pick.max() >= n)):
            raise ValueError(f"choice stream gave {pick} for {k} distinct "
                             f"of {n}")
        return pick.astype(np.int64)

    def _vector(self, kind: str, n: int) -> np.ndarray:
        v = np.asarray(self._fn(kind)(self.path, int(n)))
        if v.shape != (n,) or v.dtype != np.float32 or \
                not np.isfinite(v).all():
            raise ValueError(f"{kind} stream gave {v.dtype}{v.shape}, want "
                             f"finite float32 ({n},)")
        return v

    def uniform(self, n: int) -> np.ndarray:
        """``(n,)`` float32 in [0, 1), as ``jax.random.uniform``."""
        u = self._vector("uniform", n)
        if n and (u.min() < 0 or u.max() >= 1):
            raise ValueError("uniform stream drew outside [0, 1)")
        return u

    def normal(self, n: int) -> np.ndarray:
        """``(n,)`` float32 standard normal, as ``jax.random.normal``."""
        return self._vector("normal", n)


class SeededDraws:
    """Draws for standalone runs: each from a CPU ``torch.Generator``
    seeded from (``seed``, *path) through ``np.random.SeedSequence``
    (the kinds other than batch indices add a spawn key of their own), so
    each is a pure function of its arguments and every executor sees the
    same draws."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def _gen(self, path, kind: int = 0) -> torch.Generator:
        ss = np.random.SeedSequence([self.seed, *path],
                                    spawn_key=(kind,) if kind else ())
        return torch.Generator().manual_seed(int(ss.generate_state(1)[0]))

    def batch_indices(self, path, lens, steps, batch) -> np.ndarray:
        """Client i's ``(steps, batch)`` indices in [0, lens[i]), clients
        in order."""
        g = self._gen(path)
        return np.stack([torch.randint(0, int(n), (steps, batch),
                                       generator=g).numpy() for n in lens])

    def choice(self, path, n, k, p) -> np.ndarray:
        return torch.multinomial(torch.as_tensor(p, dtype=torch.float64), k,
                                 replacement=False,
                                 generator=self._gen(path, 1)).numpy()

    def uniform(self, path, n) -> np.ndarray:
        return torch.rand(n, generator=self._gen(path, 2)).numpy()

    def normal(self, path, n) -> np.ndarray:
        return torch.randn(n, generator=self._gen(path, 3)).numpy()


def round_indices(key: RoundKey, lens, steps: int, batch: int) -> np.ndarray:
    """One round's per-client batch indices, ``(C, steps, batch)``,
    client i's in [0, lens[i]); checked, since the stream may be
    injected. For subset rounds pass ``lens[sel]`` (and the engine's
    ``max_steps``): the engine and the sequential oracle then see the
    same batches."""
    lens = np.asarray(lens, np.int32)
    idx = np.asarray(key._fn("batch_indices")(key.path, lens, steps, batch))
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
        if gan_job is not None and cfg.mesh is not None:
            # the pending-job overlap scatters into the staged rows of
            # every client; a sharded engine resolves the job first
            gan_job.resolve()
            gan_job = None
        if gan_job is not None:
            # the job's rebalancing labels are known at launch, so the
            # pool layout is final now: stage the raw rows and zero rows
            # reserved for the synthetic ones (overwritten in feature
            # space once the job resolves, below)
            pools = []
            for i, c in enumerate(clients):
                nd = gan_job.need.get(i, np.zeros((0,), np.int32))
                pools.append((
                    np.concatenate([np.asarray(c.images, np.float32),
                                    np.zeros((len(nd), *c.images.shape[1:]),
                                             np.float32)]),
                    np.concatenate([np.asarray(c.labels, np.int32), nd])))
        else:
            pools = [c.pool() for c in clients]
        imgs, labs, lens = stage_client_pools(pools)
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
        self._het = bool(self.step_mult.max() > 1 or cfg.force_het)

        # the cohort's data-parallel shards: this rank stages and trains
        # its contiguous rows ``_own`` of the cohort
        self.mesh = cfg.mesh
        if cfg.mesh is not None:
            self.shards = mesh_lib.cohort_axis_size(cfg.mesh)
            if self.n_clients % self.shards:
                raise ValueError(
                    f"cohort of {self.n_clients} clients not divisible by "
                    f"the mesh's {self.shards} data-parallel shards")
            self._own = mesh_lib.cohort_rows(cfg.mesh, self.n_clients)
        else:
            self.shards, self._own = 1, slice(0, self.n_clients)
        dev = class_emb.device
        self.pool_staged = stage_encoded_pools(
            frozen, ccfg, use_lora=cfg.strategy.use_lora,
            imgs=imgs[self._own], runtime=self.runtime)
        self.pool_labs = torch.as_tensor(labs[self._own], dtype=torch.long,
                                         device=dev)
        self.lens = np.asarray(lens, np.int32)
        self.weights = torch.as_tensor(weights[self._own],
                                       dtype=torch.float32, device=dev)
        self.frozen = frozen
        self.class_emb = class_emb
        self.ccfg = ccfg
        self._uplink_per_client: Optional[int] = None
        self._static_key = (cfg.strategy, ccfg, cfg.local_steps,
                            cfg.batch_size, cfg.lr, self._het,
                            self.max_steps)
        if gan_job is not None:
            self._merge_gan_features(gan_job, clients)

    @torch.no_grad()
    def _merge_gan_features(self, gan_job, clients):
        """Land a pending fleet-GAN job in the staged pools: resolve it,
        encode the synthesized rows through ``encode_rows`` and scatter
        them into their reserved slots, right after each client's raw
        rows (the layout ``Client.pool()`` gives)."""
        gan_job.resolve()
        # a client dropped between launch and resolve delivered no rows:
        # its reserved slots stay out of its sampling bound
        for i in sorted(gan_job.dropped):
            if len(gan_job.need.get(i, ())):
                self.lens[i] = clients[i].n
        aug = [(i, c.aug_images) for i, c in enumerate(clients)
               if c.aug_images is not None and len(c.aug_images)]
        if not aug:
            return
        dev = self.pool_staged.device
        rows = torch.as_tensor(np.concatenate([a for _, a in aug]),
                               dtype=torch.float32, device=dev)
        feats = encode_rows(self.frozen, self.ccfg,
                            use_lora=self.cfg.strategy.use_lora, rows=rows,
                            runtime=self.runtime)
        ci = np.concatenate([np.full(len(a), i) for i, a in aug])
        ri = np.concatenate([clients[i].n + np.arange(len(a))
                             for i, a in aug])
        self.pool_staged[torch.as_tensor(ci, device=dev),
                         torch.as_tensor(ri, device=dev)] = feats

    def _sample_idx(self, key: RoundKey, lens, steps: int) -> torch.Tensor:
        """Batch indices through the runtime cache (kind ``sample_idx``,
        one program per selection width), as a long tensor on the
        engine's device."""
        batch = self.cfg.batch_size

        def build():
            return lambda k, l: round_indices(k, l, steps, batch)

        idx = self.runtime.run("sample_idx", build, (key, lens),
                               static_key=(steps, batch))
        return runtime_lib.upload(idx, self.pool_labs.device, torch.long)

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
    def _train_cohort(self, global_tr, staged, labs, rows, idx, n_steps,
                      frozen, class_emb):
        """Broadcast the global trainables over the cohort and run every
        client's local steps: client c trains on staged pool row
        ``rows[c]`` at batch indices ``idx[c]`` (``(C, S, B)``). With
        ``n_steps`` (``(C,)``) the steps past client c's count are masked
        (``optim.step_mask``: bitwise no-ops) and its loss/acc are taken
        at step ``n_steps[c] - 1``; without, at the last step. Returns
        (stacked quantized deltas, loss, acc)."""
        C, S = idx.shape[:2]
        use_lora = self.cfg.strategy.use_lora
        ccfg = self.ccfg
        cohort_tr = tree_lib.tree_map(
            lambda g: g.expand(C, *g.shape).contiguous(), global_tr)
        pick = rows[:, None]

        def grad_fn(t, ixt):
            bx, by = staged[pick, ixt], labs[pick, ixt]

            def loss_fn(tt):
                logits = cohort_logits(frozen, ccfg, tt, bx, class_emb,
                                       use_lora=use_lora)
                ce = _client_ce(logits, by)
                acc = (torch.argmax(logits.detach(), -1) == by).to(
                    torch.float32).mean(-1)
                return ce.sum(), (ce.detach(), acc)

            (_, aux), g = optim.value_and_grad(loss_fn, t)
            return g, aux

        active = None if n_steps is None else optim.step_mask(n_steps, S)
        tr, _, (ls, accs) = optim.adam_scan(
            grad_fn, cohort_tr, optim.adam_init(cohort_tr, stacked=True),
            idx.transpose(0, 1), lr=self.cfg.lr, grad_clip=1.0,
            active=active, stacked=True)
        delta = tree_lib.tree_map(
            lambda a, g: (a - g[None]).to(torch.float32), tr, global_tr)
        if n_steps is None:
            loss, acc = ls[-1], accs[-1]
        else:
            last, cols = n_steps - 1, torch.arange(C, device=idx.device)
            loss, acc = ls[last, cols], accs[last, cols]
        return comm_quantize_stacked(delta, self.cfg.strategy), loss, acc

    def _aggregate(self, global_tr, weights, delta):
        """In-program FedAvg: flat (``aggregate_stacked``, the K = N
        identity depends on it) on one shard, hierarchical on a mesh of
        several (``aggregate_tree``: each rank reduces its own rows, only
        the shards' partials cross the ranks)."""
        if self.shards > 1:
            return server.aggregate_tree(global_tr, weights, delta,
                                         mesh=self.mesh)
        return server.aggregate_stacked(global_tr, weights, delta)

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a cohort-axis tensor, in cohort order."""
        if self.shards == 1:
            return t
        return rt_lib.all_gather_raw(t.contiguous(),
                                     mesh_lib.dp_axes(self.mesh), self.mesh)

    def _gather_delta(self, delta):
        """A stacked delta tree of every rank's rows (a wave's, for the
        scheduler's buffer)."""
        if self.shards == 1:
            return delta

        def f(l):
            if isinstance(l, quant.QTensor):
                q, sc = self._gather_rows(l.q), self._gather_rows(l.scales)
                return quant.QTensor(
                    q=q, scales=sc, bits=l.bits, mode=l.mode, block=l.block,
                    out_dtype=l.out_dtype,
                    orig_shape=(q.shape[0], *l.orig_shape[1:]))
            return self._gather_rows(l)
        return tree_lib.tree_map(f, delta)

    @torch.no_grad()
    def _fetch_rows(self, sel: np.ndarray):
        """This rank's rows of a B-wide selection ``sel`` (client
        positions) of the staged pools and labels, from the ranks that own
        them: each rank fills the rows it owns (zeros elsewhere) and a
        reduce-scatter over the dp ranks hands every rank its block."""
        dp = mesh_lib.dp_axes(self.mesh)
        start, stop = self._own.start, self._own.stop
        mine = np.where((sel >= start) & (sel < stop))[0]
        dev = self.pool_staged.device
        src = torch.as_tensor(sel[mine] - start, device=dev)
        at = torch.as_tensor(mine, device=dev)
        out = []
        for pool in (self.pool_staged, self.pool_labs):
            buf = pool.new_zeros((len(sel), *pool.shape[1:]))
            buf[at] = pool[src]
            out.append(rt_lib.psum_scatter_raw(buf, dp, self.mesh))
        return out

    def _build_round(self):
        def round_fn(global_tr, idx, pool_staged, pool_labs, weights,
                     frozen, class_emb):
            rows = torch.arange(idx.shape[0], device=idx.device)
            delta, loss, acc = self._train_cohort(
                global_tr, pool_staged, pool_labs, rows, idx, None, frozen,
                class_emb)
            return self._aggregate(global_tr, weights, delta), loss, acc

        return round_fn

    def _build_subset_round(self):
        """Sync-partial round at a bucketed width: train the selected
        rows of the staged pools, quantize, and FedAvg in the program
        with the host-normalized subset weights (zero for pad rows)."""
        het = self._het

        def round_fn(global_tr, sel, n_steps, idx, pool_staged, pool_labs,
                     weights, frozen, class_emb):
            delta, loss, acc = self._train_cohort(
                global_tr, pool_staged, pool_labs, sel, idx,
                n_steps if het else None, frozen, class_emb)
            return self._aggregate(global_tr, weights, delta), loss, acc

        return round_fn

    def _build_wave(self):
        """Async wave: the same local training, stopped before
        aggregation; returns the stacked quantized deltas for the
        scheduler to buffer and commit later."""
        het = self._het

        def wave_fn(global_tr, sel, n_steps, idx, pool_staged, pool_labs,
                    frozen, class_emb):
            return self._train_cohort(
                global_tr, pool_staged, pool_labs, sel, idx,
                n_steps if het else None, frozen, class_emb)

        return wave_fn

    def _subset_inputs(self, sel, key: RoundKey, n_steps=None):
        """Canonicalize a selection (sorted: a subset is a set, so K = N
        is the identity) and its step counts, draw its batch indices at
        the true width K, and pad the cohort-axis inputs to the width
        bucket B (a shard multiple on a mesh): pad rows gather client 0's
        pool at index 0 and run one step (the drawn rows are untouched,
        so the sample stream is exactly the unbucketed one). On a mesh
        each input is this rank's rows of the bucket, its pools fetched
        from their owners. Returns (sel, K, B, pools, labels, device rows
        into them, device n_steps, device idx)."""
        sel = np.asarray(sel, np.int64)
        order = np.argsort(sel, kind="stable")
        sel = sel[order]
        if len(sel) == 0 or len(np.unique(sel)) != len(sel) or \
                sel.min() < 0 or sel.max() >= self.n_clients:
            raise ValueError(f"invalid client subset {sel}")
        if n_steps is None:
            n_steps = self.cfg.local_steps * self.step_mult[sel]
        else:
            # the scheduler's step counts, reordered with the selection;
            # a profile the staged program cannot honor fails loudly
            n_steps = np.asarray(n_steps, np.int64)[order]
            if n_steps.shape != sel.shape:
                raise ValueError(
                    f"n_steps shape {n_steps.shape} != sel {sel.shape}")
            if n_steps.min() < 1 or n_steps.max() > self.max_steps:
                raise ValueError(
                    f"n_steps {n_steps} outside [1, {self.max_steps}] "
                    "(engine staged with max step multiplier "
                    f"{int(self.step_mult.max())})")
            if not self._het and np.any(n_steps != self.cfg.local_steps):
                raise ValueError(
                    "engine was staged homogeneous (every client "
                    "step_mult==1) but the scheduler requested "
                    f"heterogeneous step counts {n_steps}; set "
                    "Client.step_mult before building the engine")
        K = len(sel)
        B = runtime_lib.bucket_width(K, self.n_clients, shards=self.shards)
        idx = runtime_lib.pad_leading(
            self._sample_idx(key, self.lens[sel], self.max_steps), B)
        dev = self.pool_labs.device
        sel_p = np.concatenate([sel, np.zeros(B - K, np.int64)])
        steps_p = np.concatenate([n_steps, np.ones(B - K, np.int64)])
        if self.mesh is None:
            return (sel, K, B, self.pool_staged, self.pool_labs,
                    runtime_lib.upload(sel_p, dev),
                    runtime_lib.upload(steps_p, dev), idx)
        r = mesh_lib.cohort_rows(self.mesh, B)
        staged, labs = self._fetch_rows(sel_p)
        return (sel, K, B, staged, labs,
                torch.arange(staged.shape[0], device=dev),
                runtime_lib.upload(steps_p[r], dev), idx[r])

    def _rank_weights(self, weights: np.ndarray) -> torch.Tensor:
        w = weights if self.mesh is None else \
            weights[mesh_lib.cohort_rows(self.mesh, len(weights))]
        return runtime_lib.upload(np.ascontiguousarray(w),
                                  self.pool_labs.device)

    def run_subset_round(self, global_tr, sel, key: RoundKey, n_steps=None):
        """Sync-partial round over client positions ``sel`` (a set):
        weights are the selected clients' sample counts renormalized over
        the subset, zero for the pad rows of the width bucket.
        ``n_steps`` optionally overrides the per-client step counts
        (aligned with ``sel``). Returns (new global trainables, metrics:
        loss/acc sliced to the true K on the device, uplink bytes K x the
        per-client payload, the sorted ``sel``)."""
        sel, K, B, staged, labs, rows, steps_d, idx = self._subset_inputs(
            sel, key, n_steps)
        weights = np.zeros(B, np.float32)
        weights[:K] = self.client_n[sel] / self.client_n[sel].sum()
        server.check_weights(weights, B)
        args = (global_tr, rows, steps_d, idx, staged, labs,
                self._rank_weights(weights), self.frozen, self.class_emb)
        new_tr, loss, acc = self.runtime.run(
            "subset_round", self._build_subset_round, args,
            static_key=self._static_key)
        loss, acc = self._gather_rows(loss), self._gather_rows(acc)
        return new_tr, {"loss": loss[:K], "acc": acc[:K],
                        "uplink_bytes": K * self.per_client_uplink_bytes(
                            global_tr), "sel": sel}

    def run_wave(self, global_tr, sel, key: RoundKey, n_steps=None):
        """Train client positions ``sel`` from ``global_tr`` without
        committing: returns (stacked quantized delta tree, metrics). The
        true clients occupy rows [0, K) of the width bucket (slice them
        with :func:`slice_client_delta`); pad rows are never committed."""
        sel, K, B, staged, labs, rows, steps_d, idx = self._subset_inputs(
            sel, key, n_steps)
        args = (global_tr, rows, steps_d, idx, staged, labs, self.frozen,
                self.class_emb)
        delta, loss, acc = self.runtime.run(
            "wave_round", self._build_wave, args,
            static_key=self._static_key)
        loss, acc = self._gather_rows(loss), self._gather_rows(acc)
        return self._gather_delta(delta), {
            "loss": loss[:K], "acc": acc[:K],
            "uplink_bytes": K * self.per_client_uplink_bytes(global_tr),
            "sel": sel}

    def run_round(self, global_tr, key: RoundKey):
        """Advance one full-cohort federated round. Returns
        (new_global_trainables, metrics) where metrics carries per-client
        last-step loss/acc (device tensors) and the round's uplink byte
        count."""
        if self._het:
            raise ValueError(
                "run_round is the homogeneous (unmasked) full-cohort "
                f"program, but clients carry step_mult {self.step_mult}"
                " - use run_subset_round(sel=arange(n_clients)) so the "
                "masked scan honors the heterogeneous step counts")
        uplink = self.uplink_bytes(global_tr)
        idx = self._sample_idx(key, self.lens, self.cfg.local_steps)
        args = (global_tr, idx[self._own], self.pool_staged, self.pool_labs,
                self.weights, self.frozen, self.class_emb)
        new_tr, loss, acc = self.runtime.run(
            "full_round", self._build_round, args,
            static_key=self._static_key)
        loss, acc = self._gather_rows(loss), self._gather_rows(acc)
        return new_tr, {"loss": loss, "acc": acc, "uplink_bytes": uplink}
