"""End-to-end federated simulation of the paper's experiments, port of
``repro.fl.simulator``.

Builds a synthetic PACS/Office-Home-like long-tail dataset, partitions it
non-IID (Dirichlet) across clients, instantiates a frozen CLIP
(pretrained here on a balanced synthetic corpus; NF4-quantized and
dequantized for the QLoRA arm), and runs communication rounds of local
training + weighted aggregation, recording server accuracy, per-client
loss/acc, uplink bytes and the footprint-based utilization proxy.

Rounds run through one scheduler path (``Scheduler.step``) on the
stacked cohort engine (``engine="cohort"``, the default) or the
per-client sequential oracle; ``pipeline="pipelined"`` defers metric
materialization to bulk flushes and gives bitwise the ``"barrier"``
loop's History.

The JAX package draws four things with ``jax.random``: the CLIP init,
the global trainables' init, the warm-up round's batch indices and each
round's. The port takes them as :class:`Streams` (``streams=``), so a
test can inject the JAX package's draws; with ``streams=None``,
:func:`seeded_streams` draws them with ``torch.Generator``s seeded from
the run's seed. The ``tripleplay`` arm (GAN), partial and async
participation, other traces, chaos and ``serve_store`` raise until
their ``ROADMAP.md`` items (Queue A items 4, 6 and 7).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch import tree as tree_lib
from repro_torch.core import clip as clip_lib
from repro_torch.core import losses, optim
from repro_torch.core.quant import dequantize_tree, quantize_tree, tree_bytes
from repro_torch.data.synthetic import class_tokens, make_dataset, make_eval_set
from repro_torch.fl import client as client_lib
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl import partition
from repro_torch.fl import runtime as runtime_lib
from repro_torch.fl import sched as sched_lib
from repro_torch.fl.strategies import STRATEGIES


@dataclass
class FLConfig:
    dataset: str = "pacs"
    strategy: str = "tripleplay"
    n_clients: int = 5
    rounds: int = 30
    local_steps: int = 8
    batch_size: int = 32
    lr: float = 2e-3
    alpha: float = 0.5            # Dirichlet non-IID concentration
    n_per_class: int = 60
    longtail_gamma: float = 8.0
    gan_steps: int = 150
    seed: int = 0
    eval_every: int = 1
    engine: str = "cohort"        # "cohort" | "sequential"
    gan_engine: str = "fleet"
    participation: str = "full"   # "full" (ported) | "sync-partial" | "async"
    clients_per_round: int = 0
    staleness_beta: float = 0.5
    async_concurrency: int = 0
    trace: Any = None             # None | "uniform" (ported)
    chaos: Any = None             # None (ported)
    # LRU bound on the run's program runtime (0 = unbounded); only used
    # when no runtime= is passed in
    runtime_cache_entries: int = 0
    # "pipelined" defers metric materialization to bulk flushes;
    # "barrier" materializes every round before the next (the oracle).
    # History values are bitwise identical.
    pipeline: str = "pipelined"
    # pipelined: flush the metric ring every M rounds (0 = at run end)
    metrics_flush_every: int = 0


@dataclass
class History:
    rounds: List[int] = field(default_factory=list)
    server_acc: List[float] = field(default_factory=list)
    tail_acc: List[float] = field(default_factory=list)   # class 0 (long tail)
    server_loss: List[float] = field(default_factory=list)
    client_loss: List[List[float]] = field(default_factory=list)
    client_acc: List[List[float]] = field(default_factory=list)
    uplink_bytes: List[int] = field(default_factory=list)
    round_time_s: List[float] = field(default_factory=list)
    util_proxy: List[float] = field(default_factory=list)
    participation: List[List[int]] = field(default_factory=list)
    staleness: List[List[int]] = field(default_factory=list)
    vtime: List[float] = field(default_factory=list)
    class_counts: List[List[int]] = field(default_factory=list)
    class_staleness: List[List[float]] = field(default_factory=list)
    class_acc: List[List[float]] = field(default_factory=list)
    meta: Dict = field(default_factory=dict)


@dataclass(frozen=True)
class Streams:
    """The run's random draws: ``clip_init`` and ``trainable_init`` are
    numpy trees (the backbone before pretraining, the global trainables),
    ``batch_indices(rnd, lens, steps, batch) -> (C, steps, batch)`` draws
    the batch indices of round ``rnd`` (-1: the warm-up round)."""
    clip_init: Any
    trainable_init: Any
    batch_indices: Callable


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(1)[0])


def seeded_streams(cfg: FLConfig, ccfg=None) -> Streams:
    """Standalone draws from ``torch.Generator``s: the CLIP init from seed
    1234 (as the JAX package's ``init_clip(PRNGKey(1234))``), the
    trainables from (cfg.seed, 2), batch indices from
    ``cohort.seeded_index_stream(cfg.seed)``."""
    ccfg = ccfg or clip_lib.CLIPConfig()
    clip_init = clip_lib.init_clip(torch.Generator().manual_seed(1234),
                                   ccfg, device="cpu")
    tr_init = client_lib.init_trainable(
        torch.Generator().manual_seed(_seed(cfg.seed, 2)), ccfg,
        STRATEGIES[cfg.strategy], device="cpu")
    return Streams(convert.tree_to_numpy(clip_init),
                   convert.tree_to_numpy(tr_init),
                   cohort_lib.seeded_index_stream(cfg.seed))


_CLIP_CACHE: Dict = {}


def _digest(tree) -> str:
    h = hashlib.sha1()
    for path, leaf in tree_lib.flatten_with_path(tree):
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(f"{tree_lib.path_str(path)}{a.shape}{a.dtype}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def clip_cache_key(dataset: str, ccfg, *, seed: int = 1234,
                   steps: int = 300, batch: int = 64, init=None,
                   device=None):
    """The key of ``_CLIP_CACHE`` under which :func:`pretrained_clip`
    keeps its result for these arguments."""
    return (dataset, seed, steps, batch, ccfg, str(resolve_device(device)),
            None if init is None else _digest(init))


def pretrained_clip(dataset: str, ccfg: clip_lib.CLIPConfig, *,
                    seed: int = 1234, steps: int = 300, batch: int = 64,
                    runtime=None, init=None, device=None):
    """CLIP_pre stand-in: contrastively pretrain the dual encoder on a
    large balanced synthetic corpus (the repository ships no CLIP
    weights). ``init`` is the numpy tree to start from (default
    ``init_clip`` on a ``torch.Generator`` seeded with ``seed``); the
    batch indices are the JAX package's ``RandomState(seed)`` draw. One
    ``adam_scan`` run (kind ``clip_pretrain``), cached per (dataset,
    seed, steps, batch, config, device, init), so all arms of a process
    share the exact same frozen backbone."""
    dev = resolve_device(device)
    key = clip_cache_key(dataset, ccfg, seed=seed, steps=steps, batch=batch,
                         init=init, device=dev)
    if key in _CLIP_CACHE:
        return _CLIP_CACHE[key]
    rt = runtime if runtime is not None else runtime_lib.ProgramRuntime()
    pre = make_dataset(dataset, n_per_class=80, seed=seed,
                       longtail_gamma=1.0)
    params = clip_lib.init_clip(torch.Generator(device=dev).manual_seed(seed),
                                ccfg, device=dev) if init is None \
        else convert.tree_from_numpy(init, dev)
    opt = optim.adam_init(params)
    n = len(pre["labels"])
    idx = torch.as_tensor(np.random.RandomState(seed).randint(
        0, n, (steps, batch)), dtype=torch.long, device=dev)
    imgs = torch.as_tensor(pre["images"], device=dev)
    toks = torch.as_tensor(pre["tokens"], dtype=torch.long, device=dev)

    def build():
        def train(params, opt, imgs, toks, idx):
            def grad_fn(p, ix):
                (loss, _), g = optim.value_and_grad(
                    lambda q: (clip_lib.contrastive_loss(
                        q, ccfg, imgs[ix], toks[ix]), None), p)
                return g, loss
            return optim.adam_scan(grad_fn, params, opt, idx, lr=1e-3,
                                   grad_clip=1.0)[:2]
        return train

    params, _ = rt.run("clip_pretrain", build, (params, opt, imgs, toks, idx),
                       static_key=(ccfg,))
    _CLIP_CACHE[key] = params
    return params


@torch.no_grad()
def _eval_stats(frozen, trainable, ccfg, class_emb, imgs, labs, mask):
    """Summed eval statistics over fixed-shape (n_batches, batch, ...)
    tensors; padding rows carry mask 0."""
    acc, loss, tail_hit, tail_n = (
        torch.zeros((), device=imgs.device) for _ in range(4))
    for im, y, m in zip(imgs, labs, mask):
        logits = client_lib.forward_logits(frozen, trainable, ccfg, im,
                                           class_emb)
        pred = torch.argmax(logits, -1)
        n = torch.sum(m)
        tail = (y == 0) * m
        acc = acc + torch.sum((pred == y) * m)
        loss = loss + losses.cross_entropy(logits, y, m) * n
        tail_hit = tail_hit + torch.sum((pred == 0) * tail)
        tail_n = tail_n + torch.sum(tail)
    return acc, loss, tail_hit, tail_n


def _eval_pack(eval_set, batch=128, device=None):
    """Stage the eval set once as fixed-shape tensors ``(n_batches,
    batch, ...)`` with a validity mask. Returns ``(imgs, labs, mask,
    n_true)``."""
    dev = resolve_device(device)
    imgs, labs = eval_set["images"], eval_set["labels"]
    n = len(labs)
    nb = -(-n // batch)
    pad = nb * batch - n
    imgs_p = np.concatenate(
        [imgs, np.zeros((pad, *imgs.shape[1:]), imgs.dtype)])
    labs_p = np.concatenate([labs, np.zeros((pad,), labs.dtype)])
    mask = np.concatenate([np.ones(n, np.float32),
                           np.zeros(pad, np.float32)])
    return (torch.as_tensor(imgs_p.reshape(nb, batch, *imgs.shape[1:]),
                            device=dev),
            torch.as_tensor(labs_p.reshape(nb, batch), dtype=torch.long,
                            device=dev),
            torch.as_tensor(mask.reshape(nb, batch), device=dev), n)


def _eval_dispatch(frozen, trainable, ccfg, class_emb, pack, runtime):
    """Server eval (kind ``server_eval``) without waiting: a runtime
    Handle over the summed device statistics."""
    args = (frozen, trainable, class_emb, pack[0], pack[1], pack[2])

    def build():
        return lambda fz, tr, ce, im, lb, mk: _eval_stats(
            fz, tr, ccfg, ce, im, lb, mk)

    return runtime.dispatch("server_eval", build, args, static_key=(ccfg,))


def _eval_finalize(ev_out, n: int):
    """Normalize summed eval statistics into (acc, loss, tail_acc): the
    one place the eval floats materialize, in both pipeline modes."""
    acc, loss, tail_hit, tail_n = ev_out
    return (float(acc) / n, float(loss) / n,
            float(tail_hit) / max(float(tail_n), 1.0))


def _server_eval(frozen, trainable, ccfg, class_emb, eval_set,
                 batch=128, runtime=None):
    """Blocking server eval through a program runtime."""
    rt = runtime if runtime is not None else runtime_lib.ProgramRuntime()
    pack = _eval_pack(eval_set, batch, device=class_emb.device)
    h = _eval_dispatch(frozen, trainable, ccfg, class_emb, pack, rt)
    return _eval_finalize(h.result(), pack[3])


def run_federated(cfg: FLConfig, *, runtime=None, serve_store=None,
                  device=None, streams: Streams = None) -> History:
    """Run the federated simulation on ``device`` (the card unless the
    caller asks for the CPU) with the draws of ``streams`` (default
    :func:`seeded_streams`)."""
    strat = STRATEGIES[cfg.strategy]
    if cfg.pipeline not in ("pipelined", "barrier"):
        raise ValueError(f"unknown pipeline mode {cfg.pipeline!r}")
    if cfg.engine not in ("cohort", "sequential"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if strat.use_gan:
        raise NotImplementedError(
            f"strategy {cfg.strategy!r}: GAN rebalancing is not ported yet "
            "(ROADMAP.md Queue A item 4)")
    if serve_store is not None:
        raise NotImplementedError(
            "serve_store: the port's AdapterStore has no "
            "refresh_from_global yet (ROADMAP.md Queue A item 7)")
    if cfg.participation != "full":
        if cfg.participation in ("sync-partial", "async"):
            raise NotImplementedError(
                f"participation={cfg.participation!r} (ROADMAP.md Queue A "
                "item 6)")
        raise ValueError(
            f"unknown participation policy {cfg.participation!r}")
    sched_lib.resolve_chaos(cfg.chaos)        # None, or it raises
    dev = resolve_device(device)
    streams = streams if streams is not None else seeded_streams(cfg)

    data = make_dataset(cfg.dataset, n_per_class=cfg.n_per_class,
                        seed=cfg.seed, longtail_gamma=cfg.longtail_gamma)
    eval_set = make_eval_set(cfg.dataset, seed=cfg.seed + 1)
    spec = data["spec"]
    # non-IID partition: Dirichlet over classes
    parts = partition.dirichlet_partition(
        data["labels"], cfg.n_clients, cfg.alpha, seed=cfg.seed)
    clients = [client_lib.Client(
        cid=i, images=data["images"][idx], labels=data["labels"][idx],
        n_classes=spec.n_classes, strategy=strat)
        for i, idx in enumerate(parts)]
    # a very skewed Dirichlet draw can leave a shard empty; such a client
    # cannot train and would get weight 0 anyway
    clients = [c for c in clients if c.n > 0]
    trace = sched_lib.resolve_trace(cfg.trace, len(clients), seed=cfg.seed)
    for i, c in enumerate(clients):
        c.step_mult = int(trace.step_mult[i])

    rt = runtime if runtime is not None else runtime_lib.ProgramRuntime(
        max_entries=cfg.runtime_cache_entries)
    ccfg = clip_lib.CLIPConfig()
    frozen = pretrained_clip(cfg.dataset, ccfg, seed=1234, runtime=rt,
                             init=streams.clip_init, device=dev)
    if strat.backbone_bits:
        # QLoRA: the vision tower stored NF4 blockwise, dequantized for
        # the round (the dense-W branch of every LoRA linear)
        q = quantize_tree(frozen["vision"], bits=strat.backbone_bits,
                          mode=strat.backbone_mode, block=64, min_size=1024)
        backbone_bytes = tree_bytes(q)
        frozen = dict(frozen, vision=dequantize_tree(q))
    else:
        backbone_bytes = tree_bytes(frozen["vision"])

    # class-prompt embeddings from the frozen text tower (computed once)
    with torch.no_grad():
        proto = torch.as_tensor(class_tokens(spec, np.arange(spec.n_classes)),
                                dtype=torch.long, device=dev)
        class_emb = clip_lib.text_embedding(frozen, ccfg, proto)
    global_tr = convert.tree_from_numpy(streams.trainable_init, dev)

    if cfg.engine == "cohort":
        engine = cohort_lib.CohortEngine(
            frozen=frozen, ccfg=ccfg, class_emb=class_emb, clients=clients,
            cfg=cohort_lib.CohortConfig(
                strategy=strat, local_steps=cfg.local_steps,
                batch_size=cfg.batch_size, lr=cfg.lr),
            runtime=rt)
        executor = sched_lib.CohortExec(engine)
    else:
        executor = sched_lib.SequentialExec(
            clients=clients, frozen=frozen, ccfg=ccfg,
            class_emb=class_emb, local_steps=cfg.local_steps,
            batch_size=cfg.batch_size, lr=cfg.lr)

    trainable_params = sum(l.numel() for l in tree_lib.leaves(global_tr))
    frozen_params = sum(l.numel() for l in tree_lib.leaves(frozen))
    hist = History(meta={
        "strategy": strat.name, "dataset": cfg.dataset,
        "n_clients": cfg.n_clients,
        "n_clients_active": len(clients),
        "engine": cfg.engine,
        "trainable_params": int(trainable_params),
        "frozen_params": int(frozen_params),
        "backbone_bytes": int(backbone_bytes),
        # the client's resident working set (backbone storage +
        # trainables + their Adam moments) over the fp32-everything one
        "footprint_bytes": int(backbone_bytes + trainable_params * 12),
        "util_proxy_const": float(
            (backbone_bytes + trainable_params * 12) /
            (frozen_params * 4 + trainable_params * 12)),
    })

    sched = sched_lib.make_scheduler(
        cfg.participation, executor=executor, trace=trace,
        local_steps=cfg.local_steps,
        clients_per_round=cfg.clients_per_round,
        staleness_beta=cfg.staleness_beta,
        concurrency=cfg.async_concurrency,
        client_n=[c.n for c in clients], chaos=None)
    hist.meta.update({
        "participation": sched.name,
        "clients_per_round": sched.k,
        "trace": trace.name,
        "staleness_beta": float(cfg.staleness_beta),
        "device_classes": int(trace.n_device_classes),
    })

    # run every program the policy dispatches once before the clock
    # starts, so round_time_s is steady-state
    sched.warmup(global_tr, cohort_lib.RoundKey(streams.batch_indices, -1))

    def _compile_meta():
        _, gan_t = rt.subtotal("gan_")
        hist.meta["n_compiles"] = rt.n_compiles
        hist.meta["n_compiles_by_kind"] = {
            k: int(v["n_compiles"]) for k, v in sorted(rt.stats().items())}
        hist.meta["compile_time_s"] = rt.compile_time_s - gan_t

    _compile_meta()

    cids = np.asarray([c.cid for c in clients])
    n_dc = int(trace.n_device_classes)
    dclass = np.asarray(trace.device_class, np.int64)
    pipelined = cfg.pipeline == "pipelined"
    hist.meta["pipeline"] = cfg.pipeline

    def _record_round(m):
        # one code path for both pipeline modes, so deferred metrics
        # give bitwise the barrier values
        hist.uplink_bytes.append(int(m["uplink_bytes"]))
        hist.client_loss.append([float(v) for v in m["loss"]])
        hist.client_acc.append([float(v) for v in m["acc"]])
        hist.participation.append([int(cids[p]) for p in m["participation"]])
        hist.staleness.append([int(s) for s in m["staleness"]])
        hist.vtime.append(float(m["vtime"]))
        pos = np.asarray(m["participation"], np.int64)
        stal = np.asarray(m["staleness"], np.float64)
        accs = np.asarray([float(v) for v in m["acc"]], np.float64)
        counts, c_stal, c_acc = [], [], []
        for d in range(n_dc):
            in_d = dclass[pos] == d if len(pos) else np.zeros(0, bool)
            k_d = int(in_d.sum())
            counts.append(k_d)
            c_stal.append(float(stal[in_d].mean()) if k_d else 0.0)
            c_acc.append(float(accs[in_d].mean()) if k_d else 0.0)
        hist.class_counts.append(counts)
        hist.class_staleness.append(c_stal)
        hist.class_acc.append(c_acc)

    def _record_eval(rnd, ev_out):
        acc, loss, tail = _eval_finalize(ev_out, ev_pack[3])
        hist.rounds.append(rnd)
        hist.server_acc.append(acc)
        hist.server_loss.append(loss)
        hist.tail_acc.append(tail)

    ev_pack = _eval_pack(eval_set, device=dev)
    round_keys = [(r, cohort_lib.RoundKey(streams.batch_indices, r))
                  for r in range(cfg.rounds)]
    prepared = sched.prepare_rounds(round_keys) if pipelined else 0

    ring: List[Dict] = []
    loop_syncs = 0

    def _flush_ring():
        if not ring:
            return
        rt.sync([(e["m"]["loss"], e["m"]["acc"],
                  None if e["eval"] is None else e["eval"].out)
                 for e in ring], tag="metrics_flush")
        for e in ring:
            _record_round(e["m"])
            hist.round_time_s.append(e["t"])
            hist.util_proxy.append(hist.meta["util_proxy_const"])
            if e["eval"] is not None:
                _record_eval(e["rnd"], e["eval"].out)
        ring.clear()

    sync0 = dict(runtime_lib.SYNC_TRACES)
    t_loop = time.time()
    for rnd, key in round_keys:
        t0 = time.time()
        global_tr, m = sched.step(global_tr, rnd, key)
        do_eval = rnd % cfg.eval_every == 0 or rnd == cfg.rounds - 1
        if pipelined:
            ev = _eval_dispatch(frozen, global_tr, ccfg, class_emb,
                                ev_pack, rt) if do_eval else None
            ring.append({"rnd": rnd, "m": m, "eval": ev,
                         "t": time.time() - t0})
            if cfg.metrics_flush_every and \
                    len(ring) >= cfg.metrics_flush_every:
                _flush_ring()
                loop_syncs += 1
        else:
            runtime_lib.sync_count("round_barrier")
            loop_syncs += 1
            _record_round(m)
            hist.round_time_s.append(time.time() - t0)
            hist.util_proxy.append(hist.meta["util_proxy_const"])
            if do_eval:
                ev = _eval_dispatch(frozen, global_tr, ccfg, class_emb,
                                    ev_pack, rt)
                _record_eval(rnd, ev.result())
    _flush_ring()
    hist.meta["loop_wall_s"] = time.time() - t_loop
    hist.meta["sync_counts"] = {
        k: v - sync0.get(k, 0)
        for k, v in runtime_lib.SYNC_TRACES.items()
        if v - sync0.get(k, 0)}
    hist.meta["loop_syncs"] = int(loop_syncs)
    hist.meta["syncs_per_round"] = loop_syncs / max(cfg.rounds, 1)
    hist.meta["prepared_rounds"] = int(prepared)
    _compile_meta()
    hist.meta["n_cache_evictions"] = int(rt.n_evictions)
    return hist
