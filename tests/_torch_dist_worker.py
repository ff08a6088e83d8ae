"""Spawned gloo worlds for the port's distributed CPU tests (a helper
module, not collected).

``spawn(case, world, inputs)`` starts ``world`` processes, one a rank,
rendezvousing over a ``FileStore`` in a fresh temporary directory (no
port), each with one thread; every rank runs ``CASES[case](inputs)``
and saves what it returns. The parent waits at most ``timeout``
seconds: a hung collective fails the test instead of hanging the run.
Returns the ranks' results in rank order. ``start(...)`` is the same
without the wait (``.wait()`` later), so the parent can compute its
references while the ranks run. The ranks import torch and
``repro_torch`` only; the tests compute their JAX references in the
parent and pass tensors in ``inputs``.
"""
from __future__ import annotations

import hashlib
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _rank_main(rank, world, tmp, case):
    torch.set_num_threads(1)
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "store"),
            rank=rank, world_size=world)
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        res = CASES[case](inputs)
        torch.save(res, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _World:
    """A started world: :meth:`wait` joins its ranks (at most ``timeout``
    seconds after the start) and returns their results in rank order."""

    def __init__(self, case: str, world: int, inputs, timeout: float):
        self.case, self.world = case, world
        self.tmp = tempfile.TemporaryDirectory()
        torch.save(inputs or {}, os.path.join(self.tmp.name, "inputs.pt"))
        self.ctx = mp.start_processes(_rank_main,
                                      args=(world, self.tmp.name, case),
                                      nprocs=world, join=False,
                                      start_method="spawn")
        self.deadline = time.time() + timeout
        self.timeout = timeout

    def wait(self):
        case, world, tmp = self.case, self.world, self.tmp.name
        try:
            while not self.ctx.join(timeout=1.0):
                if time.time() > self.deadline:
                    raise TimeoutError(f"{case}: world of {world} did not "
                                       f"finish in {self.timeout} s")
        except mp.ProcessRaisedException:
            pass
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
        try:
            res = []
            for r in range(world):
                path = os.path.join(tmp, f"rank{r}.pt")
                if not os.path.exists(path):
                    raise RuntimeError(f"{case}: rank {r} wrote no result")
                res.append(torch.load(path, weights_only=False))
        finally:
            self.tmp.cleanup()
        errs = [r["error"] for r in res
                if isinstance(r, dict) and "error" in r]
        if errs:
            raise RuntimeError(f"{case} failed on a rank:\n{errs[0]}")
        return res


def start(case: str, world: int, inputs=None, timeout: float = 300.0):
    """:func:`spawn` without the wait: the ranks run while the caller
    computes its references; ``.wait()`` gives their results."""
    return _World(case, world, inputs, timeout)


def spawn(case: str, world: int, inputs=None, timeout: float = 300.0):
    return start(case, world, inputs, timeout).wait()


# -- cases ----------------------------------------------------------------
def _rt():
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import runtime as rt_lib
    mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"))
    return rt_lib.Runtime(mesh=mesh, dp_axes=("pod", "data"),
                          tp_axis="model")


def _grads(fn, args):
    """``fn(*args)``'s output and the gradient of ``sum(out**2)`` w.r.t.
    every tensor in ``args`` (``args``' leaves made to require grad)."""
    args = [a.detach().requires_grad_(True) for a in args]
    with torch.enable_grad():
        out = fn(*args)
        y = out[0] if isinstance(out, tuple) else out
        gs = torch.autograd.grad((y * y).sum(), args)
    return out, [g.detach() for g in gs]


def _local_and_dist(rt, fn, args):
    from repro_torch.models import runtime as rt_lib
    local = _grads(fn, args)
    with rt_lib.runtime(rt):
        dist_ = _grads(fn, args)
    return local, dist_


def _detach(x):
    if isinstance(x, dict):
        return {k: _detach(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_detach(v) for v in x)
    return x.detach() if isinstance(x, torch.Tensor) else x


def model_bodies(inp):
    """Every Runtime body on the (2, 2, 2) mesh against the port's local
    path in the same process; the outputs come back for the parent to
    hold against the JAX package's local paths."""
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings
    from repro_torch.models import moe, rglru, ssm
    from repro_torch.models import runtime as rt_lib
    from repro_torch.models import build_model
    from repro_torch.core import optim
    rt = _rt()
    out = {}
    rt_lib.reset_dist_traces()

    # the MoE: sequence-sharded, decode, NF4 experts, pre-cut shards, int8
    cfg, p, x = inp["moe_cfg"], inp["moe_p"], inp["moe_x"]
    f = lambda x_: moe.moe_ffn(p, x_, cfg)
    (yl, gl), (yd, gd) = _local_and_dist(rt, f, [x])
    out["moe_local"], out["moe_dist"] = _detach(yl[0]), _detach(yd[0])
    out["moe_aux"] = _detach(yd[1])
    out["moe_dx_local"], out["moe_dx_dist"] = gl[0], gd[0]
    with rt_lib.runtime(rt):
        with torch.no_grad():
            out["moe_decode"] = moe.moe_ffn(p, x[:, :1], cfg)[0]
            cut = shardings.rank_params(cfg, {"moe": {
                k: (v[None] if k != "router" else v) for k, v in p.items()}},
                rt)["moe"]
            cut = {k: (v[0] if k != "router" else v) for k, v in cut.items()}
            out["moe_precut"] = moe.moe_ffn(cut, x, cfg)[0]
            out["moe_cut_shapes"] = {k: tuple(v.shape) for k, v in
                                     cut.items()}
            q8 = cfg.replace(moe_dispatch_bits=8)
            out["moe_q8"] = moe.moe_ffn(p, x, q8)[0]
            out["moe_q8_decode"] = moe.moe_ffn(p, x[:, :1], q8)[0]
            pq = inp["moe_pq"]
            out["moe_nf4_dist"] = moe.moe_ffn(pq, x, cfg)[0]
        _, gq8 = _grads(lambda x_: moe.moe_ffn(p, x_, q8), [x])
        out["moe_q8_dx"] = gq8[0]
    with torch.no_grad():
        out["moe_nf4_local"] = moe.moe_ffn(inp["moe_pq"], x, cfg)[0]
    # the send buffer's int8 codes, as the body quantizes them
    codes = moe._q8_rows(inp["q8_rows"])
    out["q8_codes"] = (codes[0], codes[1])

    # attention: GQA (6 heads, 3 KV) and MQA with padded heads (5, 1)
    for name in ("fa_gqa", "fa_mqa"):
        q, k, v = inp[name]
        fn = lambda q_, k_, v_: ops.flash_attention(q_, k_, v_, causal=True,
                                                    window=8)
        (ol, gl), (od, gd) = _local_and_dist(rt, fn, [q, k, v])
        out[name] = (_detach(od), gl, gd)

    # split-KV decode attention on the rank's block of the slots, and on
    # a slot count the model axis does not divide (held whole)
    q, kc, vc, sp = inp["dec_attn"]
    kv = rt_lib.P(None, "model", None, None)
    with rt_lib.runtime(rt), torch.no_grad():
        out["dec_attn"] = ops.decode_attention(
            q, shardings.local_shard(kc, kv, rt.mesh),
            shardings.local_shard(vc, kv, rt.mesh),
            shardings.local_shard(sp, rt_lib.P(None, "model"), rt.mesh))
        out["dec_attn_odd"] = ops.decode_attention(*inp["dec_attn_odd"])

    # the recurrent blocks, with and without sequence sharding
    for name, block in (("mamba", ssm.mamba_block),
                        ("rglru", rglru.rglru_block)):
        cfg_b, p_b, lo_b, x_b = inp[name]
        for seq in (True, False):
            c = cfg_b.replace(seq_shard=seq)
            lo_leaves = tree_lib.leaves(lo_b)

            def fn(x_, *ls, c=c):
                lo_ = tree_lib.from_leaves(lo_b, list(ls))
                return block(p_b, x_, c, lora=lo_)
            (ol, gl), (od, gd) = _local_and_dist(rt, fn, [x_b, *lo_leaves])
            out[f"{name}_{seq}"] = (_detach(od), gl, gd)
        with rt_lib.runtime(rt), torch.no_grad():
            out[f"{name}_fallback"] = block(p_b, x_b[:2], cfg_b, lora=lo_b)
    h0 = inp["mamba_h0"]
    cfg_b, p_b, lo_b, x_b = inp["mamba"]
    with torch.no_grad():
        out["mamba_h0_local"] = ssm.mamba_block(p_b, x_b, cfg_b, lora=lo_b,
                                                h0=h0)
        with rt_lib.runtime(rt):
            out["mamba_h0_dist"] = ssm.mamba_block(p_b, x_b, cfg_b,
                                                   lora=lo_b, h0=h0)

    # the dense model on the rank's blocks: a decode step (its batch rows'
    # logits gathered over dp) and a full train step
    ycfg, fz, tr, cache, tok, pos = inp["yi_decode"]
    model = build_model(ycfg)
    held = shardings.rank_params(ycfg, {"frozen": fz, "trainable": tr}, rt)
    with rt_lib.runtime(rt):
        logits = model.decode_step(
            held["frozen"], held["trainable"],
            shardings.rank_cache(ycfg, cache, rt),
            shardings.rank_batch(ycfg, {"tokens": tok}, rt)["tokens"],
            pos)[0]
    out["yi_decode"] = rt_lib.all_gather_raw(logits, rt.dp_axes, rt)
    ycfg, fz, tr, batch = inp["yi_train"]
    model = build_model(ycfg)
    (ll, pl), gl = model.grads(fz, tr, batch)
    held = shardings.rank_params(ycfg, {"frozen": fz, "trainable": tr}, rt)
    hb = shardings.rank_batch(ycfg, batch, rt)
    with rt_lib.runtime(rt):
        (ld, pd), gd = model.grads(held["frozen"], held["trainable"], hb)
        t2, _, _ = model.train_step(held["frozen"], held["trainable"],
                                    optim.adam_init(tr), hb, lr=1e-3)
    out["yi_train"] = dict(loss=(ll, ld), grads=(gl, gd), after=t2)
    out["dist_traces"] = dict(rt_lib.DIST_TRACES)
    return out


def _draws_digest():
    """A digest of every host-side draw the engines consume."""
    from repro_torch.core import gan as gan_lib
    from repro_torch.fl import cohort as cohort_lib
    from repro_torch.fl.sched.policies import SyncPartialScheduler
    from repro_torch.fl.sched.traces import resolve_trace
    h = hashlib.sha256()
    d = cohort_lib.SeededDraws(5)
    sched = SyncPartialScheduler(
        executor=object(), trace=resolve_trace("skewed-het", 16, seed=0),
        local_steps=2, clients_per_round=5)
    c = sched.select(0, cohort_lib.RoundKey(d, (3, 0)))
    h.update(np.asarray(c.sel).tobytes())
    h.update(np.asarray(c.n_steps).tobytes())
    idx = cohort_lib.round_indices(cohort_lib.RoundKey(d, (3, 1)),
                                   [7, 9, 13, 21, 5], 4, 8)
    h.update(idx.tobytes())
    cfg = gan_lib.GANConfig(n_classes=7)
    for i in range(3):
        s = gan_lib.SeededGANStream((0, 1000 + i))
        for leaf in _flat(s.init(cfg)):
            h.update(leaf)
        for a in gan_lib.train_draws(s, cfg, 17, 6, 8):
            h.update(np.asarray(a).tobytes())
        h.update(np.asarray(gan_lib.synth_draws(s, cfg, 5)).tobytes())
    return h.hexdigest()


def _flat(tree):
    from repro_torch import tree as tree_lib
    return [np.asarray(l).tobytes() for l in tree_lib.leaves(tree)]


def draws(inp):
    return {"world": dist.get_world_size(), "digest": _draws_digest()}


class FixedDraws:
    """Batch indices drawn ahead (by the JAX package, in the parent),
    served by their key path."""

    def __init__(self, by_path):
        self.by_path = by_path

    def batch_indices(self, path, lens, steps, batch):
        return self.by_path[tuple(path)]


def _cohort_clients(spec):
    from repro_torch.fl import client as client_lib
    from repro_torch.fl.strategies import STRATEGIES
    strat = STRATEGIES[spec["arm"]]
    return strat, [client_lib.Client(
        cid=i, images=im, labels=lb, n_classes=spec["n_classes"],
        strategy=strat) for i, (im, lb) in enumerate(spec["data"])]


def _gan_clients(spec):
    from repro_torch.core import gan as gan_lib
    from repro_torch.fl import client as client_lib
    from repro_torch.fl.strategies import STRATEGIES
    clients = [client_lib.Client(cid=i, images=im, labels=lb, n_classes=7,
                                 strategy=STRATEGIES["tripleplay"])
               for i, (im, lb) in enumerate(spec["data"])]
    return clients, [gan_lib.SeededGANStream((0, 1000 + i))
                     for i in range(len(clients))]


def cohort_mesh(inp):
    """The cohort engine's full and subset rounds on a data mesh of 4
    shards (``(data=4, model=2)``: each shard replicated over ``model``)
    and the fleet GAN on the same mesh, each beside the unsharded engine
    in the same process; the host draws' digest."""
    from repro_torch import tree as tree_lib
    from repro_torch.fl import cohort as cohort_lib
    from repro_torch.fl import fleetgan
    from repro_torch.fl import runtime as runtime_lib
    from repro_torch.launch.mesh import Mesh
    res = {"digest": _draws_digest(), "world": dist.get_world_size()}
    spec = inp["cohort"]
    draws = FixedDraws(spec["indices"])
    mesh4 = Mesh((4, 2), ("data", "model"))
    for name, mesh in (("local", None), ("mesh", mesh4)):
        strat, clients = _cohort_clients(spec)
        eng = cohort_lib.CohortEngine(
            frozen=spec["frozen"], ccfg=spec["ccfg"],
            class_emb=spec["class_emb"], clients=clients,
            cfg=cohort_lib.CohortConfig(
                strategy=strat, local_steps=spec["steps"], batch_size=8,
                lr=3e-3, mesh=mesh))
        out = {"shards": eng.shards, "rows": eng.pool_staged.shape[0]}
        for label, sel, path in spec["rounds"]:
            key = cohort_lib.RoundKey(draws, path)
            if sel is None:
                t, m = eng.run_round(spec["global"], key)
            else:
                t, m = eng.run_subset_round(spec["global"], sel, key)
            out[label] = (_detach(t), _detach(m))
        res[name] = out
    # the fleet GAN on the 4 data shards (5 clients pad to 8: 3 rider
    # rows, 2 rows a shard) beside the unsharded fleet
    for name, mesh in (("fleet_local", None), ("fleet_mesh", mesh4)):
        clients, streams = _gan_clients(inp["fleet"])
        rep = fleetgan.prepare_gan_fleet(
            clients, streams, steps=inp["fleet"]["steps"],
            fleet_cfg=fleetgan.FleetGANConfig(mesh=mesh),
            runtime=runtime_lib.ProgramRuntime(), device="cpu")
        res[name] = dict(
            n_eligible=rep.n_eligible, n_synth=rep.n_synth,
            groups=list(rep.groups),
            params=[None if c.gan_params is None else
                    [l.clone() for l in tree_lib.leaves(c.gan_params)]
                    for c in clients],
            images=[c.aug_images for c in clients],
            labels=[c.aug_labels for c in clients])
    return res


def moe_calibrate(inp):
    """The MoE body on the (2, 2, 2) mesh with ``cfg.calibrate`` (one
    batched product over the rank's experts) and without (the
    per-expert loop): outputs, balance losses and dx, fp32 and NF4
    experts."""
    from repro_torch.models import moe
    from repro_torch.models import runtime as rt_lib
    rt = _rt()
    cfg, x = inp["cfg"], inp["x"]
    out = {}
    for name in ("p", "pq"):
        p = inp[name]
        for cal in (False, True):
            c = cfg.replace(calibrate=cal)
            with rt_lib.runtime(rt):
                (y, aux), (dx,) = _grads(lambda x_: moe.moe_ffn(p, x_, c),
                                         [x])
            out[(name, cal)] = (_detach(y), _detach(aux), dx)
    return out


def _counting_collectives():
    """Wrap the ``torch.distributed`` collectives the Runtime calls so
    each call appends ``(kind, output bytes, group size)``: a count made
    apart from the Runtime's recorder."""
    calls = []

    def wrap(name, kind, out_arg):
        fn = getattr(dist, name, None)
        if fn is None:
            return

        def counted(*args, **kw):
            res = fn(*args, **kw)
            out = args[out_arg]
            calls.append((kind, out.numel() * out.element_size(),
                          dist.get_world_size(kw.get("group"))))
            return res
        setattr(dist, name, counted)

    # the functions models.runtime resolves, one for each kind
    gather = "all_gather_single" if hasattr(dist, "all_gather_single") \
        else "all_gather_into_tensor"
    scatter = "reduce_scatter_single" if hasattr(
        dist, "reduce_scatter_single") else "reduce_scatter_tensor"
    for name, kind in (("all_reduce", "all-reduce"),
                       ("all_to_all_single", "all-to-all"),
                       (gather, "all-gather"),
                       (scatter, "reduce-scatter")):
        wrap(name, kind, 0)
    return calls


def collectives(inp):
    """The collective recorder against an independent count of the
    ``torch.distributed`` calls, over the MoE body (sequence-sharded and
    decode, int8 dispatch) and the attention head split, forward and
    backward; then the federated aggregation's three schedules on this
    rank's client's delta, each with its record."""
    from repro_torch.launch import dryrun
    from repro_torch.models import moe
    from repro_torch.kernels import ops
    from repro_torch.models import runtime as rt_lib
    rt = _rt()
    calls = _counting_collectives()
    cfg, p, x = inp["moe_cfg"], inp["moe_p"], inp["moe_x"]
    q, k, v = inp["fa"]
    out = {}
    with rt_lib.runtime(rt), rt_lib.record_collectives() as rec:
        _grads(lambda x_: moe.moe_ffn(p, x_, cfg), [x])
        _grads(lambda x_: moe.moe_ffn(p, x_, cfg.replace(
            moe_dispatch_bits=8)), [x])
        with torch.no_grad():
            moe.moe_ffn(p, x[:, :1], cfg)
        _grads(lambda q_, k_, v_: ops.flash_attention(q_, k_, v_,
                                                      causal=True),
               [q, k, v])
    out["calls"], out["stats"] = list(calls), rec.stats
    out["rec_calls"] = list(rec.calls)
    deltas, w = inp["deltas"], inp["w"]
    local = dryrun.client_block(deltas, rt.index(rt.dp_axes))
    for name, fn in dryrun.SCHEDULES.items():
        with torch.no_grad(), rt_lib.record_collectives() as r:
            res = fn(local, w, rt)
        out[name] = (res, r.stats, list(r.calls))
    return out


def _blocks_err(tree, whole, specs, mesh) -> float:
    """The largest error of ``tree``'s leaves against ``whole``'s blocks by
    ``specs``, relative to each block's largest magnitude (inf where a
    shape, a dtype or a QTensor's fields differ): 0.0 when every leaf is
    its block bit for bit."""
    from repro_torch import tree as tree_lib
    from repro_torch.core.quant import QTensor
    from repro_torch.launch import shardings
    err = 0.0
    for got, w, sp in zip(tree_lib.leaves(tree), tree_lib.leaves(whole),
                          tree_lib.leaves(specs)):
        want = shardings.local_shard(w, sp, mesh)
        pairs = [(got, want)]
        if isinstance(w, QTensor):
            if tuple(got.orig_shape) != tuple(want.orig_shape):
                return float("inf")
            pairs = [(got.q, want.q), (got.scales, want.scales)]
        for a, b in pairs:
            if a.shape != b.shape or a.dtype != b.dtype:
                return float("inf")
            if not torch.equal(a, b):
                a, b = a.double(), b.double()
                err = max(err, float((a - b).abs().max()) /
                          max(float(b.abs().max()), 1e-30))
    return err


def tensor_parallel(inp):
    """The production layout on a gloo world (``inp["mesh"]``: shape and
    axis names): for each case, the rank's blocks of the params, the
    batch and the cache (``rank_params`` / ``rank_batch`` /
    ``rank_cache``, checked against ``param_specs_tree`` /
    ``batch_specs_tree`` / ``cache_specs_tree``), then ``grads`` and one
    ``train_step``, a prefill and teacher-forced decode steps on them.
    Returns each case's results and the ``DIST_TRACES``."""
    from repro_torch.core import optim
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import Mesh, dp_axes
    from repro_torch.models import build_model
    from repro_torch.models import runtime as rt_lib
    shape, axes = inp["mesh"]
    mesh = Mesh(shape, axes)
    dp = dp_axes(mesh)
    rt = rt_lib.Runtime(mesh=mesh, dp_axes=dp, tp_axis="model")
    out = {}
    for case in inp["cases"]:
        cfg, name = case["cfg"], case["name"]
        model = build_model(cfg)
        params = {"frozen": case["frozen"], "trainable": case["trainable"]}
        rt_lib.reset_dist_traces()
        held = sh.rank_params(cfg, params, rt)
        batch = sh.rank_batch(cfg, case["batch"], rt)
        res = {
            "params_blocks": _blocks_err(
                held, params, sh.param_specs_tree(cfg, params, mesh), mesh),
            "batch_blocks": _blocks_err(
                batch, case["batch"], sh.batch_specs_tree(
                    cfg, case["batch"], mesh, dp), mesh)}
        fz, tr = held["frozen"], held["trainable"]
        with rt_lib.runtime(rt):
            if not case.get("decode_only"):
                (loss, parts), grads = model.grads(fz, tr, batch)
                after, _, metrics = model.train_step(
                    fz, tr, optim.adam_init(tr), batch, lr=1e-3)
                res.update(loss=loss, parts=parts, grads=_detach(grads),
                           after=_detach(after), metrics=_detach(metrics))
            pre = sh.rank_batch(cfg, case["prefill"], rt)
            logits, cache = model.prefill(fz, tr, pre,
                                          max_len=case["max_len"])
            res["cache_blocks"] = _blocks_err(
                cache, case["cache"], sh.cache_specs_tree(
                    cfg, case["cache"], mesh, dp), mesh) if \
                "cache" in case else None
            if cfg.grad_accum > 1:
                res["accum"] = _detach(model._accumulated(
                    fz, tr, batch, rt.step_view()))
            steps = [logits]
            toks = [(sh.rank_batch(cfg, {"tokens": tok}, rt)["tokens"], pos)
                    for tok, pos in case["decode"]]
            res["slots_cut"] = dict(cache.slots_cut)
            for tok, pos in toks:
                steps.append(model.decode_step(fz, tr, cache, tok, pos)[0])
            if case.get("decode_only"):
                # the same steps from the rank's block of the JAX cache
                held_c = sh.rank_cache(cfg, case["cache"], rt)
                res["rank_cache_slots_cut"] = dict(held_c.slots_cut)
                res["kv_slots"] = (held_c["scan"]["kv"]["k"].shape[2],
                                   held_c["adapter"]["k"].shape[1])
                before = dict(rt_lib.DIST_TRACES)
                res["logits_rank_cache"] = [_detach(model.decode_step(
                    fz, tr, held_c, tok, pos)[0]) for tok, pos in toks]
                res["decode_traces"] = {
                    k: n - before.get(k, 0)
                    for k, n in rt_lib.DIST_TRACES.items()
                    if n > before.get(k, 0)}
        res.update(logits=[_detach(s) for s in steps],
                   traces=dict(rt_lib.DIST_TRACES),
                   dp_index=rt.index(dp) if dp else 0)
        out[name] = res
    return out


def rglru_mesh(inp):
    """Reduced RecurrentGemma in the production layout on a model axis
    that cuts its LRU width but not its 16 gate blocks: the rank's
    parameter blocks (``rank_params``), a prefill, then teacher-forced
    decode steps from the prefill's held cache, and the same steps from
    ``rank_cache`` of the JAX package's prefill cache (``inp["cache"]``).
    Returns the logits, the held RG-LRU state (``h``, ``conv``) after the
    prefill and after each step, each stretch's ``DIST_TRACES`` and the
    cache's block against the JAX prefill's."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import Mesh, dp_axes
    from repro_torch.models import build_model
    from repro_torch.models import runtime as rt_lib
    mesh = Mesh(*inp["mesh"])
    dp = dp_axes(mesh)
    rt = rt_lib.Runtime(mesh=mesh, dp_axes=dp, tp_axis="model")
    cfg = inp["cfg"]
    model = build_model(cfg)
    held = sh.rank_params(cfg, {"frozen": inp["frozen"],
                                "trainable": inp["trainable"]}, rt)
    fz, tr = held["frozen"], held["trainable"]
    lru = lambda c: {k: v.detach().clone()
                     for k, v in c["scan"]["lru"].items()}

    def run(cache, toks):
        logits, states, traces = [], [], []
        for tok, pos in toks:
            rt_lib.reset_dist_traces()
            logits.append(model.decode_step(fz, tr, cache, tok, pos)[0]
                          .detach())
            states.append(lru(cache))
            traces.append(dict(rt_lib.DIST_TRACES))
        return logits, states, traces

    with rt_lib.runtime(rt):
        rt_lib.reset_dist_traces()
        pre = sh.rank_batch(cfg, inp["prefill"], rt)
        first, cache = model.prefill(fz, tr, pre, max_len=inp["max_len"])
        res = {"prefill_traces": dict(rt_lib.DIST_TRACES),
               "prefill": [first.detach(), lru(cache)],
               "cache_blocks": _blocks_err(
                   cache, inp["cache"], sh.cache_specs_tree(
                       cfg, inp["cache"], mesh, dp), mesh)}
        toks = [(sh.rank_batch(cfg, {"tokens": tok}, rt)["tokens"], pos)
                for tok, pos in inp["decode"]]
        res["decode"] = run(cache, toks)
        res["decode_rank_cache"] = run(sh.rank_cache(cfg, inp["cache"], rt),
                                       toks)
    res.update(model_index=rt.index("model"),
               dp_index=rt.index(dp) if dp else 0)
    return res


CASES = {"model_bodies": model_bodies, "draws": draws,
         "cohort_mesh": cohort_mesh, "moe_calibrate": moe_calibrate,
         "collectives": collectives, "tensor_parallel": tensor_parallel,
         "rglru_mesh": rglru_mesh}
