"""The multi-pod dry run, port of ``repro.launch.dryrun``: trace one step
of every (arch x input shape x mesh) on the production mesh without
allocating, and record its memory, FLOP, byte and collective accounting.

Usage (the CPU is enough; nothing touches a card):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dry.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fed-agg --mesh multi

The JAX dry run lowers against ``ShapeDtypeStruct`` stand-ins on 512
placeholder devices and reads XLA's analyses. The port runs the same
program as one rank of a *fake* world (:func:`init_fake_world`: a
``torch.distributed`` process group of 256 or 512 ranks whose
collectives move nothing) with the production :class:`Runtime` (the
production layout), on fake CPU tensors (``FakeTensorMode``) made
from the model's spec trees (``Model.param_specs``, ``input_specs``;
never ``init_params``, which draws weights), cut to the rank's blocks
by ``shardings.rank_params``, ``rank_batch`` and ``rank_cache``.
Every op runs its plain PyTorch version on the fake tensors, as the JAX
dry run lowers the plain ``jnp`` versions on CPU placeholder devices:
sizes flow, no data does. The record (:func:`run_one`) keeps the JAX
record's keys:

- ``argument_bytes``: the rank's params, optimizer state, batch and
  cache as the port holds them in the production layout (``shardings.
  rank_params``, ``rank_batch``, ``rank_cache``: ``dense_layout`` is
  ``"tensor"``). ``argument_bytes_rules``: the per-device bytes of the
  same arguments under ``shardings.param_specs_tree`` /
  ``batch_specs_tree`` / ``cache_specs_tree`` on the production mesh
  (the optimizer state replicated), which is what GSPMD gives the JAX
  package; the two are equal;
- ``output_bytes``: the step's outputs made during the step;
  ``temp_bytes``: the peak of live storage made during the step, beyond
  the arguments and less the outputs (a tally of storages at dispatch,
  each freed when its last tensor is);
- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count. It
  counts the matmul class only (mm, bmm, addmm, convolutions, attention
  products), where XLA's ``cost_analysis`` counts every op;
- ``bytes``: each ATen op's input plus output bytes (views excluded),
  XLA's "bytes accessed" definition before fusion;
- ``collectives``: ``models.runtime.record_collectives``'s tally by
  kind (count, output bytes on the rank, group size); ``routes``: the
  ``KERNEL_TRACES`` and ``DIST_TRACES`` of the step;
- ``params_total`` / ``params_active`` and the ``*_cal`` keys of
  :func:`calibrated_costs`.

Eager counts are exact, with no loop counted once, so the calibration
(depth 1 and 2, extrapolated) reproduces the full-depth count where the
layers are alike; it is kept for the JAX record's keys and for the
configs too deep to trace quickly.

:func:`fed_agg_dryrun` runs the federated aggregation's three schedules
(``psum``, ``gather``, ``hierarchical``) as SPMD functions over the
Runtime's collectives and records their wire bytes.

The process group is started by :func:`main` or by the caller, never at
import: a process has one default group.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import weakref
from fractions import Fraction
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import optim
from repro_torch.core import quant as qlib
from repro_torch.core.quant import QTensor
from repro_torch.kernels import ops as kops
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import runtime as rt_lib

# long_500k needs sub-quadratic attention: run for the SSM / hybrid / SWA
# architectures, skip for pure full-attention ones
LONG_OK = {"falcon-mamba-7b", "recurrentgemma-2b", "h2o-danube-3-4b"}


def init_fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks (this process rank 0): its
    collectives return at once and move nothing. A fake world of another
    size is replaced; any other initialized world raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a fake world; this "
                               f"process has a {dist.get_backend()} one")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def _config(arch, *, quant_bits=0, quant_mode="linear", kv_quant=0,
            grad_accum=1, trainable_dtype="", extra_cfg=None):
    cfg = get_config(arch)
    if quant_bits and not cfg.quant_bits:
        cfg = cfg.replace(quant_bits=quant_bits, quant_mode=quant_mode)
    if kv_quant and not cfg.kv_quant_bits:
        cfg = cfg.replace(kv_quant_bits=kv_quant)
    if grad_accum > 1:
        cfg = cfg.replace(grad_accum=grad_accum)
    if trainable_dtype:
        cfg = cfg.replace(trainable_dtype=trainable_dtype)
    if extra_cfg:
        cfg = cfg.replace(**extra_cfg)
    return cfg


# -- fake tensors and byte counts --------------------------------------------
def _fake(tree):
    """A spec tree (``meta`` tensors, QTensors of them) as CPU tensors,
    made inside the caller's ``FakeTensorMode``: no storage is
    allocated."""
    def one(leaf):
        if isinstance(leaf, QTensor):
            return QTensor(q=one(leaf.q), scales=one(leaf.scales),
                           bits=leaf.bits, mode=leaf.mode, block=leaf.block,
                           out_dtype=leaf.out_dtype,
                           orig_shape=tuple(leaf.orig_shape))
        return torch.empty(tuple(leaf.shape), dtype=leaf.dtype)
    return tree_lib.tree_map(one, tree)


def _leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def _spec_bytes(t, spec, mesh) -> int:
    """The bytes of one device's block of ``t`` by ``spec`` (a dim split
    over n ranks holds ceil(dim / n) of it)."""
    n = t.element_size()
    for d, size in enumerate(t.shape):
        e = spec[d] if d < len(spec) else None
        parts = mesh.size(rt_lib.spec_axes(e)) if e is not None else 1
        n *= -(-int(size) // parts)
    return n


def rules_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of ``tree`` laid out by the spec tree ``specs``
    (a QTensor's spec a QTensor of its storage's specs)."""
    total = 0
    for leaf, spec in zip(tree_lib.leaves(tree), tree_lib.leaves(specs)):
        if isinstance(leaf, QTensor):
            total += _spec_bytes(leaf.q, spec.q, mesh) + \
                _spec_bytes(leaf.scales, spec.scales, mesh)
        else:
            total += _spec_bytes(leaf, spec, mesh)
    return total


class _Account:
    """A dispatch mode over fake tensors: ``bytes`` sums each ATen op's
    input and output bytes (views and non-ATen ops excluded); ``live``
    and ``peak`` follow the storages made under it, each counted once
    from its first output until it is freed. Storages of ``args`` are
    arguments and not counted."""

    def __init__(self, args):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                outer._see(func, args, kwargs, out)
                return out

        self.mode = Mode()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: set = set()
        self._args = [_storage(t) for t in _tensors(args)]
        self._arg_ids = {id(s) for s in self._args}

    def _see(self, func, args, kwargs, out):
        from torch.utils._pytree import tree_flatten
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if func.namespace == "aten" and not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_leaf_bytes(t) for t in ins + outs)
        for t in outs:
            st = _storage(t)
            k = id(st)
            if k in self._seen or k in self._arg_ids:
                continue
            self._seen.add(k)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, k, n)

    def _free(self, k, n):
        self.live -= n
        self._seen.discard(k)

    def made(self, tree) -> int:
        """Bytes of the storages of ``tree`` that the step made."""
        ids, n = set(), 0
        for t in _tensors(tree):
            st = _storage(t)
            if id(st) in self._arg_ids or id(st) in ids:
                continue
            ids.add(id(st))
            n += st.nbytes()
        return n


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _tensors(tree):
    out = []
    for leaf in tree_lib.leaves(tree):
        if isinstance(leaf, QTensor):
            out += [leaf.q, leaf.scales]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _tree_bytes(tree) -> int:
    return sum(_leaf_bytes(t) for t in _tensors(tree))


# -- one step -----------------------------------------------------------------
def trace_step(arch: str, shape_name, *, multi_pod: bool,
               quant_bits: int = 0, quant_mode: str = "linear",
               seq_shard: bool = True, remat: bool = True,
               kv_quant: int = 0, grad_accum: int = 1,
               trainable_dtype: str = "", extra_cfg=None,
               cfg_override=None, local: bool = False) -> Dict[str, Any]:
    """One step of ``arch`` at ``shape_name`` (a key of
    ``INPUT_SHAPES`` or an ``InputShape``), traced under
    ``FakeTensorMode`` as one rank of the production mesh (a fake world
    of 256, or 512 with ``multi_pod``), the counterpart of the JAX
    ``lower_step``. ``local`` traces it on one device with no mesh and no
    Runtime (a card's run). Returns the counts :func:`run_one` records."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    shape = shape_name if isinstance(shape_name, InputShape) else \
        INPUT_SHAPES[shape_name]
    cfg = cfg_override or _config(
        arch, quant_bits=quant_bits, quant_mode=quant_mode,
        kv_quant=kv_quant, grad_accum=grad_accum,
        trainable_dtype=trainable_dtype, extra_cfg=extra_cfg)
    cfg = cfg.replace(seq_shard=seq_shard, remat=remat)
    model = build_model(cfg)
    specs = model.param_specs()
    batch_specs = model.input_specs(shape)
    rt = mesh = None
    if not local:
        init_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        rt = rt_lib.Runtime(mesh=mesh, dp_axes=dp_axes(mesh),
                            tp_axis="model")
        # the layout's spec trees are built from meta tensors: made here,
        # outside the trace, they are not counted as the step's storage
        model.held_specs(rt)
    opt_specs = optim.adam_specs(specs["trainable"]) \
        if shape.kind == "train" else None
    rules = None
    if mesh is not None:
        dp = rt.dp_axes
        pspec = sh.param_specs_tree(cfg, specs, mesh)
        cache_specs = batch_specs.get("cache")
        plain = {k: v for k, v in batch_specs.items() if k != "cache"}
        rules = rules_bytes(specs, pspec, mesh) + rules_bytes(
            plain, sh.batch_specs_tree(cfg, plain, mesh, dp), mesh)
        if opt_specs is not None:
            rules += _tree_bytes(opt_specs)           # replicated
        if cache_specs is not None:
            rules += rules_bytes(cache_specs, sh.cache_specs_tree(
                cfg, cache_specs, mesh, dp), mesh)

    # the step's routes alone; the caller's counts are put back after
    saved = dict(kops.KERNEL_TRACES), dict(rt_lib.DIST_TRACES)
    kops.reset_kernel_traces()
    rt_lib.reset_dist_traces()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake(specs)
        batch = _fake(batch_specs)
        if rt is not None:
            params = sh.rank_params(cfg, params, rt)
            cache = batch.pop("cache", None)
            batch = sh.rank_batch(cfg, batch, rt)
            if cache is not None:
                batch["cache"] = sh.rank_cache(cfg, cache, rt)
        frozen, tr = params["frozen"], params["trainable"]
        opt = None if opt_specs is None else optim.AdamState(
            *(_fake(x) for x in opt_specs))
        args = (params, batch, opt)
        acct = _Account(args)
        with contextlib.ExitStack() as stack:
            stack.enter_context(rt_lib.runtime(rt))
            coll = stack.enter_context(rt_lib.record_collectives())
            flops = stack.enter_context(FlopCounterMode(display=False))
            stack.enter_context(acct.mode)
            if shape.kind == "train":
                out = model.train_step(frozen, tr, opt, batch)
            elif shape.kind == "prefill":
                out = model.prefill(frozen, tr, batch)
            else:
                out = model.decode_step(frozen, tr, batch["cache"],
                                        batch["tokens"], batch["pos"])
        output_bytes = acct.made(out)
        del out
    trace_s = time.perf_counter() - t0
    routes = {"kernel": dict(kops.KERNEL_TRACES),
              "dist": dict(rt_lib.DIST_TRACES)}
    for counts, old in zip((kops.KERNEL_TRACES, rt_lib.DIST_TRACES), saved):
        counts.clear()
        counts.update(old)
    arg_bytes = _tree_bytes(params) + _tree_bytes(batch) + (
        0 if opt is None else _tree_bytes(opt))
    return {"cfg": cfg, "shape": shape, "argument_bytes": arg_bytes,
            "argument_bytes_rules": arg_bytes if rules is None else rules,
            "output_bytes": output_bytes,
            "temp_bytes": max(0, acct.peak - output_bytes),
            "flops": int(flops.get_total_flops()), "bytes": acct.bytes,
            "collectives": {k: dict(v) for k, v in coll.stats.items()},
            "routes": routes, "trace_s": trace_s}


def _exact(x):
    x = Fraction(x)
    return int(x) if x.denominator == 1 else float(x)


def calibrated_costs(arch: str, shape_name, *, multi_pod: bool,
                     quant_bits: int = 0, quant_mode: str = "linear",
                     seq_shard: bool = True, remat: bool = True,
                     kv_quant: int = 0, grad_accum: int = 1,
                     trainable_dtype: str = "", extra_cfg=None,
                     base=None, local: bool = False) -> dict:
    """Per-step costs extrapolated in depth, as the JAX dry run
    calibrates them: two variants of ``n_layers = first_k_dense + reps *
    len(attn_pattern)`` (encoder layers likewise) for reps 1 and 2, with
    ``unroll_layers`` and ``calibrate`` on and ``grad_accum`` 1, then
    ``cost(L) = c1 + (c2 - c1)(reps - 1)``, exact in integers where the
    depth is a whole number of patterns. ``base`` overrides the config."""
    base = base or _config(arch, quant_bits=quant_bits,
                           quant_mode=quant_mode, kv_quant=kv_quant,
                           grad_accum=grad_accum,
                           trainable_dtype=trainable_dtype,
                           extra_cfg=extra_cfg)
    pat = len(base.attn_pattern)
    reps = Fraction(base.n_layers - base.first_k_dense, pat)

    def one(r):
        cfg = base.replace(
            n_layers=base.first_k_dense + r * pat,
            encoder_layers=(r * pat if base.encoder_layers else 0),
            unroll_layers=True, calibrate=True, grad_accum=1)
        return trace_step(arch, shape_name, multi_pod=multi_pod,
                          seq_shard=seq_shard, remat=remat,
                          cfg_override=cfg, local=local)

    t1, t2 = one(1), one(2)
    ex = lambda a, b: _exact(a + (b - a) * (reps - 1))
    coll = {}
    for kind in set(t1["collectives"]) | set(t2["collectives"]):
        e1 = t1["collectives"].get(kind, {"count": 0, "bytes": 0, "gsize": 0})
        e2 = t2["collectives"].get(kind, {"count": 0, "bytes": 0, "gsize": 0})
        coll[kind] = {"count": round(ex(e1["count"], e2["count"])),
                      "bytes": ex(e1["bytes"], e2["bytes"]),
                      "gsize": max(e1["gsize"], e2["gsize"])}
    return {"flops_cal": ex(t1["flops"], t2["flops"]),
            "bytes_cal": ex(t1["bytes"], t2["bytes"]),
            "collectives_cal": coll}


def run_one(arch: str, shape_name, *, multi_pod: bool,
            quant_bits: int = 0, quant_mode: str = "linear",
            seq_shard: bool = True, remat: bool = True,
            kv_quant: int = 0, grad_accum: int = 1,
            trainable_dtype: str = "", extra_cfg=None,
            verbose: bool = True, calibrate: bool = True,
            cfg_override=None, local: bool = False) -> dict:
    """The record of one combination (the module docstring lists its
    keys)."""
    kw = dict(multi_pod=multi_pod, seq_shard=seq_shard, remat=remat)
    cfg_kw = dict(quant_bits=quant_bits, quant_mode=quant_mode,
                  kv_quant=kv_quant, grad_accum=grad_accum,
                  trainable_dtype=trainable_dtype, extra_cfg=extra_cfg)
    t = trace_step(arch, shape_name, cfg_override=cfg_override, local=local,
                   **kw, **cfg_kw)
    cfg, shape = t["cfg"], t["shape"]
    mesh = "local" if local else ("2x16x16" if multi_pod else "16x16")
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh,
        "n_devices": 1 if local else (512 if multi_pod else 256),
        "quant_bits": cfg.quant_bits, "quant_mode": cfg.quant_mode,
        "seq_shard": seq_shard, "remat": remat,
        "kv_quant": cfg.kv_quant_bits, "grad_accum": cfg.grad_accum,
        "trainable_dtype": cfg.trainable_dtype,
        "extra_cfg": extra_cfg or {}, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "n_layers": cfg.n_layers,
        "flops": t["flops"], "bytes": t["bytes"],
        "argument_bytes": t["argument_bytes"],
        "argument_bytes_rules": t["argument_bytes_rules"],
        "output_bytes": t["output_bytes"], "temp_bytes": t["temp_bytes"],
        "collectives": t["collectives"],
        "params_total": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
        "routes": t["routes"],
        "dense_layout": "local" if local else "tensor",
        "trace_s": round(t["trace_s"], 2),
    }
    if calibrate:
        t0 = time.perf_counter()
        rec.update(calibrated_costs(arch, shape_name, base=cfg, local=local,
                                    **kw))
        rec["calibrate_s"] = round(time.perf_counter() - t0, 2)
    if verbose:
        gib = lambda n: f"{n / 2**30:.2f}GiB"
        print(f"== {arch} x {shape.name} x {mesh}"
              f"{' q' + str(cfg.quant_bits) if cfg.quant_bits else ''} ==")
        print(f"  memory: args={gib(rec['argument_bytes'])} (rules "
              f"{gib(rec['argument_bytes_rules'])}) "
              f"out={gib(rec['output_bytes'])} "
              f"temp={gib(rec['temp_bytes'])} (per rank)")
        print(f"  flops={rec['flops']:.4e} bytes={rec['bytes']:.4e}"
              + (f" calibrated flops={rec['flops_cal']:.4e} "
                 f"bytes={rec['bytes_cal']:.4e}" if calibrate else ""))
        print("  collectives: " + (", ".join(
            f"{k}:{v['count']}x {v['bytes'] / 2**20:.1f}MiB"
            for k, v in sorted(rec["collectives"].items())) or "none"))
        print(f"  trace {rec['trace_s']}s", flush=True)
    return rec


# -- federated aggregation ----------------------------------------------------
def _dequant(leaf):
    if isinstance(leaf, QTensor):
        return qlib.dequantize(leaf, torch.float32)
    return leaf.to(torch.float32)


def _map(fn, tree):
    return tree_lib.tree_map(fn, tree)


def fed_agg_psum(deltas, w, rt):
    """The GSPMD-style schedule: this rank's client's delta (each leaf
    with a leading client axis of 1, a QTensor or fp32) dequantized,
    weighted by ``w[client] / sum(w)`` and all-reduced in fp32 over the
    client (dp) axes. Returns the weighted mean, the same on every
    rank."""
    dp = rt.dp_axes
    wi = w[rt.index(dp)] / w.sum()
    return _map(lambda l: rt_lib.psum(_dequant(l)[0] * wi, dp, rt), deltas)


def _gather_clients(leaf, axes, rt):
    g = lambda t: rt_lib.all_gather_raw(t.contiguous(), axes, rt, dim=0)
    if isinstance(leaf, QTensor):
        q, s = g(leaf.q), g(leaf.scales)
        return QTensor(q=q, scales=s, bits=leaf.bits, mode=leaf.mode,
                       block=leaf.block, out_dtype=leaf.out_dtype,
                       orig_shape=(q.shape[0], *leaf.orig_shape[1:]))
    return g(leaf)


def fed_agg_gather(deltas, w, rt):
    """The compressed-wire schedule: the payloads (int8 codes and their
    scales, or fp32) all-gathered over the client axes, then dequantized
    and weight-summed on every rank."""
    dp = rt.dp_axes
    wn = w / w.sum()

    def one(l):
        d = _dequant(_gather_clients(l, dp, rt))
        return torch.einsum("c...,c->...", d, wn)
    return _map(one, deltas)


def fed_agg_hierarchical(deltas, w, rt, *, block: int = 64):
    """The hierarchical schedule (needs a ``pod`` axis): an fp32 psum of
    the weighted deltas within each pod over ``data``, the pod sums
    re-quantized to int8 in blocks of ``block`` (absmax / 127) and
    all-gathered across pods, then summed and divided by ``sum(w)``:
    only int8 codes and scales cross pods."""
    wi = w[rt.index(rt.dp_axes)]

    def one(l):
        pod_sum = rt_lib.psum(_dequant(l)[0] * wi, "data", rt)
        flat = pod_sum.reshape(-1)
        pad = (-flat.numel()) % block
        flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
        s = qlib._div(flat.abs().amax(-1, keepdim=True).clamp_min(1e-12),
                      127.0)
        q = torch.clamp(torch.round(flat / s), -127, 127).to(torch.int8)
        qg = rt_lib.all_gather_raw(q[None], "pod", rt, dim=0)
        sg = rt_lib.all_gather_raw(s[None], "pod", rt, dim=0)
        tot = (qg.to(torch.float32) * sg).sum(0).reshape(-1)
        return tot[:pod_sum.numel()].reshape(pod_sum.shape) / w.sum()
    return _map(one, deltas)


SCHEDULES = {"psum": fed_agg_psum, "gather": fed_agg_gather,
             "hierarchical": fed_agg_hierarchical}


def stacked_delta_specs(trainable_specs, n_clients: int, comm_bits: int):
    """The trainables' deltas stacked on a leading client axis, each
    leaf of at least 2 dims and 256 elements quantized per client to
    ``comm_bits`` in blocks of 64 (the JAX dry run's stack), as
    ``meta`` tensors."""
    def one(s):
        shape = (n_clients, *s.shape)
        if comm_bits and len(s.shape) >= 2 and s.numel() >= 256:
            return qlib.qtensor_specs(shape, torch.float32, bits=comm_bits,
                                      block=64)
        return torch.empty(shape, device="meta")
    return tree_lib.tree_map(one, trainable_specs)


def client_block(tree, i: int = 0):
    """Client ``i``'s block (a leading axis of 1) of a tree stacked on a
    client axis, a QTensor's payload and scales both."""
    def one(leaf):
        if isinstance(leaf, QTensor):
            return QTensor(q=leaf.q[i:i + 1], scales=leaf.scales[i:i + 1],
                           bits=leaf.bits, mode=leaf.mode, block=leaf.block,
                           out_dtype=leaf.out_dtype,
                           orig_shape=(1, *leaf.orig_shape[1:]))
        return leaf[i:i + 1]
    return tree_lib.tree_map(one, tree)


def fed_agg_dryrun(arch: str, *, multi_pod: bool = True,
                   comm_bits: int = 8, verbose: bool = True) -> dict:
    """The federated aggregation at production scale: every (pod, data)
    slice holds one client's (optionally int8) LoRA + adapter delta; each
    schedule runs on fake tensors as one rank of the fake world, and
    ``collective_bytes_<schedule>`` is its wire bytes on the rank
    (collectives' outputs), ``cross_pod_bytes_<schedule>`` the part in
    collectives over groups that span pods. ``hierarchical`` needs the
    multi-pod mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rt = rt_lib.Runtime(mesh=mesh, dp_axes=dp_axes(mesh), tp_axis="model")
    n_clients = mesh.size(rt.dp_axes)
    tr = build_model(get_config(arch)).param_specs()["trainable"]
    local = client_block(stacked_delta_specs(tr, n_clients, comm_bits))
    out = {"arch": arch, "comm_bits": comm_bits, "n_clients": n_clients,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    names = ["psum", "gather"] + (["hierarchical"] if multi_pod else [])
    with FakeTensorMode():
        deltas = _fake(local)
        w = torch.empty((n_clients,))
        for name in names:
            with rt_lib.record_collectives() as rec:
                SCHEDULES[name](deltas, w, rt)
            total = sum(c[2] for c in rec.calls)
            cross = sum(c[2] for c in rec.calls
                        if "pod" in c[1] and mesh.shape.get("pod", 1) > 1)
            out[f"collective_bytes_{name}"] = total
            out[f"cross_pod_bytes_{name}"] = cross
            out[f"collectives_{name}"] = rec.stats
            if verbose:
                print(f"fed-agg {arch} ({out['mesh']}, {n_clients} clients, "
                      f"comm_bits={comm_bits}, {name}): "
                      f"wire={total / 2**20:.2f}MiB/rank "
                      f"cross-pod={cross / 2**20:.2f}MiB", flush=True)
    return out


# -- the CLI ------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--quant", type=int, default=0, choices=[0, 4, 8])
    ap.add_argument("--quant-mode", default="linear",
                    choices=["linear", "nf4"])
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--kv-quant", type=int, default=0, choices=[0, 8])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--no-calibrate", action="store_true",
                    help="skip the depth-1/2 calibration traces")
    ap.add_argument("--all", action="store_true",
                    help="full sweep: every arch x shape")
    ap.add_argument("--fed-agg", action="store_true",
                    help="trace the federated aggregation instead")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    def write(rec):
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    if args.fed_agg:
        archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
        for arch in archs:
            for bits in (0, args.quant or 8):
                write(fed_agg_dryrun(arch, multi_pod=args.mesh != "single",
                                     comm_bits=bits))
        return 0

    archs = list(ARCHS) if args.arch == "all" or args.all else \
        args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" or args.all else \
        args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    records, failures = [], []
    t_all = time.perf_counter()
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                if shape == "long_500k" and arch not in LONG_OK:
                    print(f"-- skip {arch} x long_500k (full attention)",
                          flush=True)
                    continue
                try:
                    rec = run_one(arch, shape, multi_pod=mp,
                                  quant_bits=args.quant,
                                  quant_mode=args.quant_mode,
                                  seq_shard=not args.no_seq_shard,
                                  remat=not args.no_remat,
                                  kv_quant=args.kv_quant,
                                  grad_accum=args.grad_accum,
                                  calibrate=not args.no_calibrate)
                    records.append(rec)
                    write(rec)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)[:500]))
                    print(f"!! FAIL {arch} x {shape} x "
                          f"{'multi' if mp else 'single'}: {e!r}"[:600],
                          flush=True)
    print(f"\n{len(records)} ok, {len(failures)} failed in "
          f"{time.perf_counter() - t_all:.1f} s")
    for f in failures:
        print("  FAIL", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
