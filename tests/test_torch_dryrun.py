"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

- In a subprocess (a fake world of 256 or 512 ranks must own its
  process's default group), with a timeout: ``run_one``'s records of a
  train, prefill and decode step of the reduced Yi-9B on the production
  16 x 16 mesh carry every key; ``argument_bytes_rules`` equals the
  per-device bytes of the JAX package's ``param_specs_tree`` /
  ``batch_specs_tree`` / ``cache_specs_tree`` layout on a mesh
  stand-in (the optimizer state replicated), computed here from the JAX
  spec trees, and ``argument_bytes``, what the port's rank holds in the
  production layout, equals it; so it does for every family's reduced
  config at train, prefill and decode; the fed-agg CLI exits 0 and its
  records carry each schedule's bytes.
- In this process (no world: a one-device trace): at a reduced dense
  config of depth 4, ``calibrated_costs``' extrapolated flops and bytes
  equal the full-depth count exactly; a trace of an NF4 step leaves the
  process's real computations (the NF4 codebook cache) and its route
  counts as they were.
- On the 8-rank gloo harness: the collective recorder's tally equals an
  independent count of the ``torch.distributed`` calls the MoE body and
  the attention head split issue, forward and backward; the three
  fed-agg schedules on (2, 2, 2) ranks: ``psum`` and ``gather`` equal the
  plain weighted mean of the dequantized deltas within 1e-6,
  ``hierarchical`` is within its int8 re-quantization bound, and
  ``gather``'s recorded bytes are the int8 payloads plus their scales.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from _torch_dist_worker import SRC, spawn
from repro.configs import get_reduced as j_reduced
from repro.core import optim as joptim
from repro.core.quant import QTensor as JQ
from repro.launch import shardings as jsh
from repro.models import build_model as j_build
from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.core import quant as qlib
from repro_torch.launch import dryrun
from repro_torch.models import build_model, moe

KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "flops", "bytes",
        "argument_bytes", "argument_bytes_rules", "output_bytes",
        "temp_bytes", "collectives", "params_total", "params_active",
        "routes", "dense_layout", "flops_cal", "bytes_cal",
        "collectives_cal"}
SHAPES = {"train": (64, 32), "prefill": (64, 32), "decode": (64, 32)}

SCRIPT = r"""
import json, sys
from repro_torch.configs import get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
cfg = get_reduced("yi-9b")
out = {}
for kind, (S, B) in json.loads(sys.argv[1]).items():
    out[kind] = dryrun.run_one("yi-9b", InputShape(kind, S, B, kind),
                               multi_pod=False, cfg_override=cfg,
                               verbose=False)
out["fed_agg"] = dryrun.fed_agg_dryrun("yi-9b", multi_pod=True,
                                       verbose=False)
out["cli"] = dryrun.main(["--fed-agg", "--arch", "yi-9b", "--mesh",
                          "multi"])
print("RECORDS " + json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _records():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(SHAPES)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("RECORDS ")]
    return json.loads(line[-1][len("RECORDS "):])


def _mesh():
    try:
        return AbstractMesh((16, 16), ("data", "model"))
    except TypeError:       # jax<=0.4.x: a tuple of (name, size) pairs
        return AbstractMesh((("data", 16), ("model", 16)))


def _device_bytes(tree, specs, mesh):
    """Per-device bytes of a JAX spec tree under a PartitionSpec tree."""
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda l: isinstance(l, JQ))
    pspecs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda l: isinstance(l, (JQ, PartitionSpec)))
    total = 0

    def one(shape, dtype, spec):
        n = np.dtype(dtype).itemsize
        for d, size in enumerate(shape):
            e = spec[d] if d < len(spec) else None
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            parts = int(np.prod([mesh.shape[a] for a in axes]))
            n *= -(-size // parts)
        return n

    for leaf, spec in zip(leaves, pspecs):
        if isinstance(leaf, JQ):
            total += one(leaf.q.shape, leaf.q.dtype, spec.q)
            total += one(leaf.scales.shape, leaf.scales.dtype, spec.scales)
        else:
            total += one(leaf.shape, leaf.dtype, spec)
    return total


def _jax_rules_bytes(kind, S, B):
    """What GSPMD gives the JAX package: its spec trees laid out by its
    sharding rules on a 16 x 16 mesh stand-in."""
    from repro.configs import InputShape as JShape
    cfg = j_reduced("yi-9b")
    model = j_build(cfg)
    mesh = _mesh()
    dp = ("data",)
    specs = model.param_specs()
    total = _device_bytes(specs, jsh.param_specs_tree(cfg, specs, mesh),
                          mesh)
    batch = model.input_specs(JShape(kind, S, B, kind))
    cache = batch.pop("cache", None)
    total += _device_bytes(batch, jsh.batch_specs_tree(cfg, batch, mesh, dp),
                           mesh)
    if kind == "train":
        opt = joptim.adam_specs(specs["trainable"])
        total += sum(np.dtype(l.dtype).itemsize * int(np.prod(l.shape))
                     for l in jax.tree_util.tree_leaves(opt))
    if cache is not None:
        total += _device_bytes(cache, jsh.cache_specs_tree(cfg, cache, mesh,
                                                           dp), mesh)
    return total


@pytest.mark.parametrize("kind", list(SHAPES))
def test_record_keys_and_argument_bytes(kind):
    rec = _records()[kind]
    assert KEYS <= set(rec), KEYS - set(rec)
    S, B = SHAPES[kind]
    assert rec["argument_bytes_rules"] == _jax_rules_bytes(kind, S, B)
    # the rank holds its blocks of every argument: what GSPMD gives
    assert rec["argument_bytes"] == rec["argument_bytes_rules"]
    assert rec["dense_layout"] == "tensor"
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["flops_cal"] == rec["flops"]   # 2 layers: reps 1 and 2
    assert rec["output_bytes"] > 0 and rec["temp_bytes"] >= 0
    # every op its plain version on the fake tensors; the attention
    # through the Runtime's head split (the decode's split-KV body)
    kern, dist_ = rec["routes"]["kernel"], rec["routes"]["dist"]
    assert "lora_matmul_dense" in kern
    assert not any("_cuda" in k for k in kern)   # no card route
    if kind == "decode":
        assert "decode_attention_plain" in kern
        assert "decode_attention_dist" in dist_
    else:
        assert "flash_attention_ref" in kern
        assert "flash_attention_dist" in dist_
    assert "all-gather" in rec["collectives"]
    for v in rec["collectives"].values():
        assert v["count"] > 0 and v["gsize"] in (16, 256)


FAMILY_SCRIPT = r"""
import json
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.core import quant as qlib
from repro_torch.launch import dryrun
from repro_torch.models import build_model
out = {}
for arch in ARCHS:
    cfg = get_reduced(arch)
    if cfg.n_experts:
        cfg = cfg.replace(n_experts=16)      # one expert a model rank
    whole = qlib.tree_bytes(build_model(cfg).param_specs())
    for kind in ("train", "prefill", "decode"):
        rec = dryrun.trace_step(arch, InputShape(kind, 64, 32, kind),
                                multi_pod=False, cfg_override=cfg)
        out[arch + "/" + kind] = [rec["argument_bytes"],
                                  rec["argument_bytes_rules"],
                                  rec["temp_bytes"], whole]
print("RECORDS " + json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _family_records():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", FAMILY_SCRIPT],
                         capture_output=True, text=True, timeout=400,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("RECORDS ")]
    return json.loads(line[-1][len("RECORDS "):])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(dryrun.ARCHS))
def test_every_family_holds_its_rules_bytes(arch, kind):
    """Each family's reduced config on the 16 x 16 fake world: the rank
    holds exactly the bytes the sharding rules give a device (params,
    Adam state, batch and cache; the MoE with 16 experts, one a model
    rank). A decode step's temporaries stay below half the whole
    model's bytes: the layout's spec trees, built from the whole model's
    meta tensors, are not counted as the step's storage (they were, at
    about the whole model's bytes)."""
    got, rules, temp, whole = _family_records()[f"{arch}/{kind}"]
    assert got == rules
    if kind == "decode":
        assert temp < whole // 2, (temp, whole)


def test_fed_agg_records():
    recs = _records()
    assert recs["cli"] == 0
    fa = recs["fed_agg"]
    assert fa["n_clients"] == 32 and fa["mesh"] == "2x16x16"
    for s in ("psum", "gather", "hierarchical"):
        assert fa[f"collective_bytes_{s}"] > 0
    # a psum over (pod, data) and the gather both span pods; the
    # hierarchical schedule sends only its int8 exchange across
    assert fa["cross_pod_bytes_psum"] == fa["collective_bytes_psum"]
    assert fa["cross_pod_bytes_gather"] == fa["collective_bytes_gather"]
    assert 0 < fa["cross_pod_bytes_hierarchical"] < \
        fa["collective_bytes_hierarchical"]
    assert fa["cross_pod_bytes_hierarchical"] < fa["cross_pod_bytes_gather"]


def test_calibrated_costs_extrapolate_exactly():
    cfg = get_reduced("yi-9b").replace(n_layers=4)
    shape = InputShape("t", 32, 2, "train")
    full = dryrun.trace_step("yi-9b", shape, multi_pod=False, local=True,
                             cfg_override=cfg.replace(unroll_layers=True,
                                                      calibrate=True))
    plain = dryrun.trace_step("yi-9b", shape, multi_pod=False, local=True,
                              cfg_override=cfg)
    cal = dryrun.calibrated_costs("yi-9b", shape, multi_pod=False,
                                  base=cfg, local=True)
    assert cal["flops_cal"] == full["flops"] == plain["flops"]
    assert cal["bytes_cal"] == full["bytes"] == plain["bytes"]
    assert isinstance(cal["flops_cal"], int)
    assert full["collectives"] == {} and cal["collectives_cal"] == {}
    # one device: the arguments are what the port holds, every op plain
    assert full["argument_bytes"] == full["argument_bytes_rules"]
    assert set(full["routes"]["kernel"]) >= {"flash_attention_ref",
                                             "lora_matmul_dense"}


@functools.lru_cache(maxsize=None)
def _world():
    g = torch.Generator().manual_seed(0)
    cfg = get_reduced("qwen3-moe-235b-a22b").replace(capacity_factor=8.0)
    p = moe.init_experts(g, cfg, torch.float32, "cpu")
    x = torch.randn((4, 8, cfg.d_model), generator=g) * 0.1
    fa = (torch.randn((4, 8, 6, 16), generator=g),
          torch.randn((4, 8, 3, 16), generator=g),
          torch.randn((4, 8, 3, 16), generator=g))
    # 4 clients' deltas (pod x data), per-client int8 at block 64
    deltas = {"lora": {"a": torch.randn((4, 2, 128, 8), generator=g) * 0.1,
                       "b": torch.randn((4, 2, 8, 96), generator=g)},
              "b1": torch.randn((4, 16), generator=g)}
    deltas = tree_lib.tree_map(
        lambda l: qlib.quantize(l, bits=8, block=64)
        if l.ndim >= 3 else l, deltas)
    w = torch.tensor([3.0, 1.0, 2.0, 5.0])
    inp = {"moe_cfg": cfg, "moe_p": p, "moe_x": x, "fa": fa,
           "deltas": deltas, "w": w}
    return inp, spawn("collectives", 8, inp, timeout=400)


def test_recorder_equals_the_collectives_issued():
    _, res = _world()
    for r in res:
        want: dict = {}
        for kind, nbytes, gsize in r["calls"]:
            e = want.setdefault(kind, {"count": 0, "bytes": 0, "gsize": 0})
            e["count"] += 1
            e["bytes"] += nbytes
            e["gsize"] = max(e["gsize"], gsize)
        assert r["stats"] == want
        assert {"all-to-all", "all-gather", "all-reduce"} <= set(want)
        assert [(k, b, g) for k, _, b, g in r["rec_calls"]] == r["calls"]


def test_fed_agg_schedules_on_gloo():
    inp, res = _world()
    w = inp["w"].numpy()
    deq = {k: qlib.dequantize(v, torch.float32).numpy()
           if isinstance(v, qlib.QTensor) else v.numpy()
           for k, v in tree_lib.flatten_with_path(inp["deltas"])}
    want = {k: np.einsum("c...,c->...", d, w / w.sum())
            for k, d in deq.items()}
    for r in res:
        for name in ("psum", "gather"):
            got = dict(tree_lib.flatten_with_path(r[name][0]))
            for k, v in want.items():
                err = np.abs(got[k].numpy() - v).max() / np.abs(v).max()
                assert err <= 1e-6, (name, k, err)
        got = dict(tree_lib.flatten_with_path(r["hierarchical"][0]))
        for k, v in want.items():
            # two pod sums, each re-quantized at half a code of its
            # block's absmax / 127
            pods = [np.einsum("c...,c->...", deq[k][2 * i:2 * i + 2],
                              w[2 * i:2 * i + 2]) for i in range(2)]
            bound = sum(np.abs(p).max() / 254 for p in pods) / w.sum()
            assert np.abs(got[k].numpy() - v).max() <= bound + 1e-7, k
        # gather's wire: every client's int8 codes and fp32 scales, and
        # the fp32 leaf, gathered over the four clients
        payload = sum(
            (l.q.numel() * l.q.element_size() +
             l.scales.numel() * l.scales.element_size())
            if isinstance(l, qlib.QTensor) else l.numel() * l.element_size()
            for l in tree_lib.leaves(inp["deltas"]))
        stats = r["gather"][1]
        assert set(stats) == {"all-gather"}
        assert stats["all-gather"]["bytes"] == payload
        # psum: one fp32 all-reduce a leaf
        assert set(r["psum"][1]) == {"all-reduce"}
        assert r["psum"][1]["all-reduce"]["count"] == len(want)


def test_a_trace_leaves_no_fake_state():
    """A trace of an NF4 step (the codebook first made under the fake
    mode) leaves the process's real computations and its route counts as
    they were."""
    from repro_torch.kernels import ops
    qlib._CODES.clear()
    ops.reset_kernel_traces()
    ops.KERNEL_TRACES["before"] = 1
    cfg = get_reduced("yi-9b").replace(quant_bits=4, quant_mode="nf4",
                                       quant_block=64, n_layers=1)
    t = dryrun.trace_step("yi-9b", InputShape("t", 16, 2, "train"),
                          multi_pod=False, local=True, cfg_override=cfg)
    assert "lora_matmul_ref" in t["routes"]["kernel"]
    assert ops.KERNEL_TRACES == {"before": 1}
    ops.reset_kernel_traces()
    w = torch.randn((64, 8), generator=torch.Generator().manual_seed(0))
    got = qlib.dequantize(qlib.quantize(w, bits=4, block=64, mode="nf4"))
    assert type(got) is torch.Tensor and torch.isfinite(got).all()
