"""Fleet-GAN engine, port of ``repro.fl.fleetgan``: every client's
conditional GAN (paper §III-B) trained and sampled as stacked programs.

The JAX engine runs ``gan.gan_scan_bucketed`` under one ``jax.vmap``
over the cohort. The port stacks the clients by hand (``core.gan``
takes a leading client axis, and ``kernels.gan_conv`` contracts it with
``torch.bmm``), so each GAN step of the whole fleet is one launch per
gemm:

- per-client pools are padded to one shape (``stage_client_pools``) and
  batch indices are drawn in ``[0, n_i)``, so padded rows are never
  sampled;
- clients below ``strategies.GAN_MIN_POOL`` ride the stacked program with
  an all-False ``active`` mask: their every step is a bitwise no-op on
  params and both Adam states, and nothing is written back to them;
- the minibatch is ``strategies.gan_batch_size(n)``; the bucketed path
  pads every client's minibatch to the cohort's largest and corrects the
  means (``gan.train_step_bucketed``); ``FleetGANConfig(bucket_batches=
  False)`` trains each batch-size group exactly (``gan.gan_scan``).

Draws: client i's init, indices, noise and synthesis noise come from
its ``GANStream`` (``core.gan``), the same object ``Client.prepare_gan``
consumes, so the sequential loop is this engine's oracle on identical
draws. The stream's arrays are drawn on the host and copied to the card
from pinned memory without waiting.

Execution is two-phase, as in the reference: :func:`launch_gan_fleet`
queues init, training and synthesis on the device with no host sync and
returns a :class:`FleetGANJob` whose rebalancing labels (``need``) are
known at once, so the cohort engine can lay out its pools; only
``job.resolve()`` waits (one sync, counted in ``SYNC_TRACES`` as
``gan_resolve``) and writes the results onto the clients.
:func:`prepare_gan_fleet` is the blocking composition.

With ``FleetGANConfig.mesh`` (one process a rank) the stacked cohort is
split over the mesh's data-parallel ranks: its width pads up to a shard
multiple with rider rows that ride exactly like ineligible clients
(client 0's init, zero draws, all-False ``active``, never written back),
each rank trains and samples its contiguous rows, and the trained params,
losses and images are all-gathered. Every draw comes from the clients'
streams at their true shapes before the pad, so the result is the
unsharded fleet's bit for bit when every shard holds two rows or more
(on the CPU a batched product of a single matrix takes MKL's
single-matrix path, which sums in another order).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.core import gan as gan_lib
from repro_torch.data.synthetic import stage_client_pools
from repro_torch.fl import runtime as runtime_lib
from repro_torch.fl import strategies as strategies_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import runtime as rt_lib

# module-level default so standalone callers share one ledger; the
# simulator passes its per-run runtime instead
_DEFAULT_RUNTIME = runtime_lib.ProgramRuntime()


@dataclass(frozen=True)
class FleetGANConfig:
    """Fleet-engine execution knobs: ``conv_impl`` for every stacked GAN
    program (``"gemm"``, the default, ``"lax"`` or ``"gemm_int8"``);
    ``bucket_batches``
    pads every client's minibatch to one bucket (one program), False
    trains each batch-size group through the exact ``gan.gan_scan``.
    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) splits the stacked
    cohort over its data-parallel ranks; it needs ``bucket_batches``."""
    conv_impl: str = "gemm"
    bucket_batches: bool = True
    mesh: Any = None


def default_runtime() -> runtime_lib.ProgramRuntime:
    """The runtime standalone calls build through."""
    return _DEFAULT_RUNTIME


def clear_cache():
    """Drop the default runtime's program cache and ledger."""
    _DEFAULT_RUNTIME.clear()


@dataclass
class FleetGANReport:
    """What one fleet prep did: population split, the train programs'
    (batch bucket, cohort width) groups, and the build/prep timing."""
    n_clients: int
    n_eligible: int
    n_synth: int = 0
    n_dropped: int = 0   # eligible clients lost between launch/resolve
    groups: List[Tuple[int, int]] = field(default_factory=list)
    compile_time_s: float = 0.0
    prep_time_s: float = 0.0
    d_loss: Dict[int, float] = field(default_factory=dict)
    g_loss: Dict[int, float] = field(default_factory=dict)


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to the card from pinned memory without
    waiting on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _init_build(dev):
    def init(stacked_np):
        params = tree_lib.tree_map(lambda l: _upload(l, dev), stacked_np)
        return params, gan_lib.adam_init(params, stacked=True)
    return init


def _train_build(cfg):
    return lambda p, o, imgs, labs, idx, z, z2, n_true, active: \
        gan_lib.gan_scan_bucketed(p, o, cfg, imgs, labs, idx, z, z2, n_true,
                                  active=active)


def _train_exact_build(cfg):
    return lambda p, o, imgs, labs, idx, z, z2: gan_lib.gan_scan(
        p, o, cfg, imgs, labs, idx, z, z2)


def _synth_build(cfg):
    @torch.no_grad()
    def synth(gens, z, labs):
        return gan_lib.generate(gens, cfg, z, labs)
    return synth


@dataclass
class FleetGANJob:
    """A launched (possibly still computing) fleet-GAN prep. ``need``
    maps client position -> rebalancing labels (known at launch);
    ``resolve()`` waits for the device work, writes ``gan_cfg`` /
    ``gan_params`` / ``aug_images`` / ``aug_labels`` onto the clients and
    finalizes the report."""
    report: FleetGANReport
    need: Dict[int, np.ndarray]
    _clients: Sequence = ()
    _cfg: Optional[gan_lib.GANConfig] = None
    _runtime: Optional[runtime_lib.ProgramRuntime] = None
    _gan_snapshot: Tuple[int, float] = (0, 0.0)
    _launch_wall_s: float = 0.0
    _params: Optional[dict] = None          # stacked trained params
    _ms: Optional[dict] = None              # stacked per-step metrics
    _eligible: Sequence[bool] = ()
    _synth: Sequence = ()                   # [(pos, need, synth row)]
    _synth_out: Optional[torch.Tensor] = None
    _resolved: bool = False
    _dropped: set = field(default_factory=set)

    @property
    def resolved(self) -> bool:
        return self._resolved

    @property
    def dropped(self) -> frozenset:
        return frozenset(self._dropped)

    def mark_dropped(self, positions) -> None:
        """Client positions that dropped between launch and resolve:
        their device work already ran, but nothing is written back to
        them (no GAN params, no synthesized rows)."""
        if self._resolved:
            raise RuntimeError(
                "cannot drop clients from an already-resolved fleet-GAN "
                "job — mark dropouts between launch and resolve")
        self._dropped.update(int(p) for p in positions)

    def resolve(self) -> FleetGANReport:
        if self._resolved:
            return self.report
        t0 = time.perf_counter()
        rep = self.report
        if self._params is not None:
            self._runtime.sync((self._params["gen"], self._ms,
                                self._synth_out), tag="gan_resolve")
            d_l = self._ms["d_loss"].cpu().numpy()
            g_l = self._ms["g_loss"].cpu().numpy()
            rep.n_dropped = sum(
                1 for i in self._dropped
                if 0 <= i < len(self._clients) and self._eligible[i])
            for i, c in enumerate(self._clients):
                if not self._eligible[i] or i in self._dropped:
                    continue
                c.gan_cfg = self._cfg
                c.gan_params = tree_lib.tree_map(lambda l: l[i].clone(),
                                                 self._params)
                rep.d_loss[i] = float(d_l[i, -1])
                rep.g_loss[i] = float(g_l[i, -1])
                if len(self.need[i]) == 0:
                    c.aug_images = np.zeros((0, *c.images.shape[1:]),
                                            np.float32)
                    c.aug_labels = np.zeros((0,), np.int32)
        if self._synth:
            imgs = self._synth_out.cpu().numpy().astype(np.float32)
            for pos, nd, row in self._synth:
                if pos in self._dropped:
                    continue      # synthesized, never delivered
                self._clients[pos].aug_images = imgs[row, :len(nd)]
                self._clients[pos].aug_labels = nd
                rep.n_synth += len(nd)
        if self._runtime is not None:
            _, t0c = self._gan_snapshot
            _, t1c = self._runtime.subtotal("gan_")
            rep.compile_time_s = t1c - t0c
        rep.prep_time_s = (self._launch_wall_s +
                           (time.perf_counter() - t0) - rep.compile_time_s)
        # the per-client results now live on the clients: drop the
        # stacked buffers
        self._params = self._ms = self._synth_out = None
        self._resolved = True
        return rep


def launch_gan_fleet(clients: Sequence, streams: Sequence, *, steps: int,
                     conv_impl: str = "gemm",
                     fleet_cfg: Optional[FleetGANConfig] = None,
                     runtime: Optional[runtime_lib.ProgramRuntime] = None,
                     device=None) -> FleetGANJob:
    """Queue the whole fleet's GAN init, training and synthesis on
    ``device`` (the card unless the caller asks for the CPU) without a
    host sync, and return the pending job. ``streams[i]`` is client i's
    ``GANStream`` (the simulator's ``Streams.gan(i)``); ``fleet_cfg``'s
    ``conv_impl`` wins over the keyword when given."""
    t_launch = time.perf_counter()
    if fleet_cfg is not None:
        conv_impl = fleet_cfg.conv_impl
    bucketed = fleet_cfg.bucket_batches if fleet_cfg is not None else True
    mesh = fleet_cfg.mesh if fleet_cfg is not None else None
    if mesh is not None and not bucketed:
        raise ValueError(
            "mesh-sharded fleet-GAN requires bucket_batches=True — the "
            "per-group exact path scatters trained groups back by row")
    shards = mesh_lib.cohort_axis_size(mesh) if mesh is not None else 1
    rt = runtime if runtime is not None else _DEFAULT_RUNTIME
    rep = FleetGANReport(n_clients=len(clients), n_eligible=0)
    job = FleetGANJob(report=rep, need={}, _clients=clients, _runtime=rt,
                      _gan_snapshot=rt.subtotal("gan_"))
    if not clients:
        job._launch_wall_s = time.perf_counter() - t_launch
        return job
    if len(streams) != len(clients):
        raise ValueError(
            f"need one GAN stream per client (ineligible ones included): "
            f"got {len(streams)} streams for {len(clients)} clients")
    n_classes = clients[0].n_classes
    if any(c.n_classes != n_classes for c in clients):
        raise ValueError("fleet-GAN cohort must share one class space")
    if any(c.n == 0 for c in clients):
        raise ValueError("fleet-GAN cohort contains empty clients — "
                         "drop them before GAN prep (simulator does)")
    cfg = gan_lib.GANConfig(n_classes=n_classes, conv_impl=conv_impl)
    job._cfg = cfg
    eligible = [c.n >= strategies_lib.GAN_MIN_POOL for c in clients]
    job._eligible = eligible
    rep.n_eligible = int(sum(eligible))
    if rep.n_eligible == 0:       # empty-after-filter: nothing to train
        job._launch_wall_s = time.perf_counter() - t_launch
        return job
    for i, c in enumerate(clients):
        job.need[i] = gan_lib.rebalance_labels(c.labels, n_classes) \
            if eligible[i] else np.zeros((0,), np.int32)

    dev = resolve_device(device)
    C = len(clients)
    n_b = np.asarray([strategies_lib.gan_batch_size(c.n) for c in clients],
                     np.int64)
    B = int(n_b[np.asarray(eligible)].max())
    pool_i, pool_l, lens = stage_client_pools(
        [(c.images, c.labels) for c in clients])
    # every client's init (ineligible riders too: they ride masked)
    inits = [s.init(cfg) for s in streams]
    # a mesh pads the cohort to a shard multiple: the pad rows ride like
    # ineligible clients (client 0's init, zero draws, masked steps) and
    # each rank takes its contiguous rows ``own``
    Cp = runtime_lib.shard_multiple(C, shards)
    own = mesh_lib.cohort_rows(mesh, Cp) if mesh is not None else \
        slice(0, C)
    if Cp > C:
        inits += [inits[0]] * (Cp - C)
        pool_i = np.concatenate([pool_i, np.zeros(
            (Cp - C, *pool_i.shape[1:]), pool_i.dtype)])
        pool_l = np.concatenate([pool_l, np.zeros(
            (Cp - C, *pool_l.shape[1:]), pool_l.dtype)])
    pool_i = _upload(pool_i[own], dev)
    pool_l = _upload(pool_l[own].astype(np.int64), dev)
    stacked = tree_lib.tree_map(lambda *ls: np.stack(ls)[own], inits[0],
                                *inits[1:])
    params, opt = rt.run("gan_init", lambda: _init_build(dev), (stacked,),
                         static_key=(cfg, str(dev)))
    by_batch: Dict[int, List[int]] = {}
    for i in range(C):
        if eligible[i]:
            by_batch.setdefault(int(n_b[i]), []).append(i)

    if bucketed:
        # draws at each client's true batch, padded to the bucket;
        # ineligible riders' draws stay zero (their steps are masked)
        idx = np.zeros((Cp, steps, B), np.int64)
        z = np.zeros((Cp, steps, B, cfg.z_dim), np.float32)
        z2 = np.zeros_like(z)
        for i, c in enumerate(clients):
            if eligible[i]:
                b = int(n_b[i])
                idx[i, :, :b], z[i, :, :b], z2[i, :, :b] = \
                    gan_lib.train_draws(streams[i], cfg, c.n, steps, b)
        active = np.repeat(np.asarray(list(eligible) + [False] * (Cp - C))
                           [:, None], steps, axis=1)
        n_bp = np.concatenate([n_b, np.full(Cp - C, B, np.int64)])
        targs = (params, opt, pool_i, pool_l, _upload(idx[own], dev),
                 _upload(z[own], dev), _upload(z2[own], dev),
                 _upload(n_bp[own], dev), _upload(active[own], dev))
        params, _, ms = rt.run("gan_train", lambda: _train_build(cfg), targs,
                               static_key=(cfg,))
        if mesh is not None:
            gather = lambda l: rt_lib.all_gather_raw(
                l.contiguous(), mesh_lib.dp_axes(mesh), mesh)
            params = tree_lib.tree_map(gather, params)
            ms = tree_lib.tree_map(gather, ms)
        rep.groups.append((B, C))
    else:
        # each batch-size group through the exact gan_scan; ineligible
        # clients are left out and keep their init params (never
        # written back)
        d_l = torch.zeros((C, steps), device=dev)
        g_l = torch.zeros((C, steps), device=dev)
        for batch, pos in sorted(by_batch.items()):
            draws = [gan_lib.train_draws(streams[i], cfg, clients[i].n,
                                         steps, batch) for i in pos]
            pos_t = _upload(np.asarray(pos, np.int64), dev)
            gp = tree_lib.tree_map(lambda l: l[pos_t], params)
            targs = (gp, gan_lib.adam_init(gp, stacked=True), pool_i[pos_t],
                     pool_l[pos_t]) + tuple(
                         _upload(np.stack(a), dev) for a in zip(*draws))
            gp, _, ms_g = rt.run("gan_train",
                                 lambda: _train_exact_build(cfg), targs,
                                 static_key=(cfg, "exact"))
            params = tree_lib.tree_map(lambda l, g: l.index_copy(0, pos_t, g),
                                       params, gp)
            d_l = d_l.index_copy(0, pos_t, ms_g["d_loss"])
            g_l = g_l.index_copy(0, pos_t, ms_g["g_loss"])
            rep.groups.append((batch, len(pos)))
        ms = {"d_loss": d_l, "g_loss": g_l}
    job._params, job._ms = params, ms

    # synthesis: every client's noise at its exact row count, then one
    # stacked generate with the rows padded to a power of two
    synth = [(i, job.need[i], gan_lib.synth_draws(streams[i], cfg,
                                                  len(job.need[i])))
             for i in range(C) if eligible[i] and len(job.need[i])]
    if synth:
        M = runtime_lib.pow2_ceil(max(len(nd) for _, nd, _ in synth))
        z_pad = np.zeros((len(synth), M, cfg.z_dim), np.float32)
        lab_pad = np.zeros((len(synth), M), np.int64)
        for r, (_, nd, zs) in enumerate(synth):
            z_pad[r, :len(nd)], lab_pad[r, :len(nd)] = zs, nd
        src = np.asarray([i for i, _, _ in synth], np.int64)
        # a mesh pads the synthesis rows to a shard multiple at the end
        # (client 0's generator on zero noise and labels, never delivered)
        Sp = runtime_lib.shard_multiple(len(synth), shards)
        if Sp > len(synth):
            extra = Sp - len(synth)
            z_pad = np.concatenate([z_pad, np.zeros(
                (extra, *z_pad.shape[1:]), np.float32)])
            lab_pad = np.concatenate([lab_pad, np.zeros(
                (extra, M), np.int64)])
            src = np.concatenate([src, np.full(extra, src[0])])
        part = mesh_lib.cohort_rows(mesh, Sp) if mesh is not None else \
            slice(0, Sp)
        rows = _upload(src[part], dev)
        gens = tree_lib.tree_map(lambda l: l[rows], params["gen"])
        out = rt.dispatch(
            "gan_synth", lambda: _synth_build(cfg),
            (gens, _upload(z_pad[part], dev), _upload(lab_pad[part], dev)),
            static_key=(cfg,)).out
        if mesh is not None:
            out = rt_lib.all_gather_raw(out.contiguous(),
                                        mesh_lib.dp_axes(mesh), mesh)
        job._synth_out = out
        job._synth = [(i, nd, row) for row, (i, nd, _) in enumerate(synth)]
    job._launch_wall_s = time.perf_counter() - t_launch
    return job


def prepare_gan_fleet(clients: Sequence, streams: Sequence, *, steps: int,
                      conv_impl: str = "gemm",
                      fleet_cfg: Optional[FleetGANConfig] = None,
                      runtime: Optional[runtime_lib.ProgramRuntime] = None,
                      device=None) -> FleetGANReport:
    """Train + synthesize every eligible client's GAN as stacked programs
    and write the results onto the clients: the fleet equivalent of

        for i, c in enumerate(clients):
            if c.n >= strategies.GAN_MIN_POOL:
                c.prepare_gan(streams[i], steps=steps)

    The blocking composition of :func:`launch_gan_fleet` and
    ``resolve()``."""
    return launch_gan_fleet(clients, streams, steps=steps,
                            conv_impl=conv_impl, fleet_cfg=fleet_cfg,
                            runtime=runtime, device=device).resolve()
