#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA H100: the serving
plane, the federated QLoRA trainer on Yi-9B and on Falcon-Mamba-7B, and
the paper's federated CLIP round (``run_federated``).

    python3 chip_smoke.py

Phases (a failed phase raises and the script exits non-zero):
 1. set-up: the card's name and power limit, TF32 off, and a build of
    every CUDA kernel from ``src/repro_torch/kernels/csrc``;
 2. each kernel against its plain PyTorch version on the card, at the
    serve path's and the trainer's shapes and at edge shapes, with times
    beside its bound; the attention gradient against autograd through
    the plain attention;
 3. the serving plane at CLIP ViT-B/32 width (seeded weights): 16 users,
    half adapter-only and half LoRA, an int8-at-rest store with
    evictions, a Zipf request trace replayed through ``ServeEngine``, and
    the per-request ``serve_sequential`` oracle; then one flight at int4
    and one unquantized. The kernel launch counts are zeroed just before
    this phase and read right after it;
 4. one ``train_step``'s gradients at full Yi-9B width with 2 layers
    (NF4 backbone, seeded weights, 4 x 64 tokens) on the card with the
    kernels and on the CPU with the plain versions, on the same weights;
 5. the federated QLoRA trainer (``repro_torch.launch.train``) on Yi-9B
    at full width and depth: NF4 block 64, int8 uplink, 2 rounds x 2
    clients x 2 local steps of 4 x 64 tokens, through ``client_update``
    and ``aggregate``; launch counts zeroed just before and read right
    after; then one step under the profiler;
 6. phase 4 at full Falcon-Mamba-7B width with 2 layers;
 7. phase 5 on Falcon-Mamba-7B at full width and depth (64 Mamba
    layers, every scan through the ``selective_scan`` kernel and its
    gradient through ``selective_scan_bwd``), with the peak device
    memory; the profiled step's top device entries name the ATen op
    and the region (``record_function`` range or backward node) that
    launched them;
 8. ``repro_torch.fl.simulator.run_federated`` through its entry point
    at the JAX package's ``CLIPConfig()`` and the paper preset's round
    settings (pacs, 5 clients, 10 local steps, batch 32, 60 samples a
    class, lr 3e-3): 3 cohort rounds, pipelined, for ``fedclip`` and
    ``qlora_nogan``, each run's launch counts zeroed just before it and
    read right after; its History printed and checked (finite, uplink
    bytes 5 x the per-client payload), then one sequential round on the
    same streams and the first round's trainables, cohort against the
    sequential oracle, at ``tests/test_fl.py``'s tolerances;
 9. one full-participation round at CLIP ViT-B/32 width (seeded
    weights; the pacs images repeated 7 x along each spatial axis to
    224 x 224), both arms through ``CohortEngine``, ``FullSyncScheduler``
    and ``SequentialExec``, cohort against sequential; launch counts
    zeroed before the arms and read after them; each cohort round
    profiled, with the peak device memory; then a 2-vision-layer cut of
    the round on the card against the CPU on the same weights.
Phase 2 also holds ``selective_scan`` and its backward kernel
``selective_scan_bwd`` at the trainer's shape and at edge shapes (the
backward against the plain ``ops.selective_scan_bwd``, bitwise equal
across two calls), and the op's gradient (both kernels) against autograd
through the plain scan; phase 7 must show 128 forward and 64 backward
scan kernels per local step. bf16 calls of ``flash_attention``,
``lora_matmul`` and ``quant_matmul_t`` (a bf16 cotangent) run their
tensor-core kernels and fp32 calls their CUDA-core ones; each row prints
the route it took, and the bf16 trainer must launch only the tensor-core
kernels of the three.
``quant_matmul`` is timed at the shape that every serve replay launch
has (4 users x 1 row, 768 x 768, block 64), each row with the route it
took (the cluster split-K GEMV or the tiled kernel), the GEMV's plan and
two calls held bitwise equal, and phase 3 counts the replay's
``quant_matmul`` launches by users, route and planned CTAs, and requires
the GEMV for every one. ``flash_attention`` is also held at the
federated round's fp32 shapes (S = Skv = 1, 4 heads, D = 16 and 192,
batches of 32, 128 and 160 rows) with its gradient at (160, 1, 4, 192);
phases 8 and 9 require at least a launch a local step and no plain
attention, and its ``launches`` in the ``kernels`` record sum every
path's.
The last two lines are the ``kernels`` record and the device record.
It needs one card, imports nothing of JAX, and runs nothing on the CPU
in place of a kernel.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import clip as clip_lib  # noqa: E402
from repro_torch.core import optim  # noqa: E402
from repro_torch.core import quant as qlib  # noqa: E402
from repro_torch.data.synthetic import (SPECS, class_tokens,  # noqa: E402
                                        make_dataset)
from repro_torch.fl import client as client_lib  # noqa: E402
from repro_torch.fl import cohort as cohort_lib  # noqa: E402
from repro_torch.fl import partition  # noqa: E402
from repro_torch.fl import sched as sched_lib  # noqa: E402
from repro_torch.fl import serve as serve_lib  # noqa: E402
from repro_torch.fl import simulator as sim_lib  # noqa: E402
from repro_torch.fl.strategies import STRATEGIES  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import blockwise_quant as bq_kernel  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import lora_matmul as lm_kernel  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm_kernel  # noqa: E402
from repro_torch.kernels import selective_scan as ss_kernel  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# H100 SXM data-sheet rates (dense): HBM bytes/s and the peak operation
# rate for the operands' type (fp32 outside the tensor cores, bf16)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}

# CLIP ViT-B/32 (arXiv:2103.00020): 224/32 -> 50 tokens, width 768,
# 12 layers, 12 heads, d_ff 3072, vocab 49408, context 77, embed 512
VIT_B32 = clip_lib.CLIPConfig(
    image_size=224, patch=32, vision_layers=12, text_layers=12,
    d_model=768, n_heads=12, d_ff=3072, vocab=49408, max_text_len=77,
    proj_dim=512)

# the NF4 backbone as launch/train.py --quant 4 sets it up: Yi-9B
# (arXiv:2403.04652) and Falcon-Mamba-7B (arXiv:2410.05355)
CLI_NF4 = dict(quant_bits=4, quant_mode="nf4", quant_block=64)
# the trainer's LoRA linears at Yi-9B width: (K, N)
YI_LINEARS = {"wq_wo": (4096, 4096), "wk_wv": (4096, 512),
              "wg_wu": (4096, 11008), "wd": (11008, 4096)}

REPLACES = {
    "quant_matmul": "src/repro/kernels/quant_matmul.py:66",
    "blockwise_quant": "src/repro/kernels/blockwise_quant.py:38",
    "flash_attention": "src/repro/kernels/flash_attention.py:72",
    "lora_matmul": "src/repro/kernels/lora_matmul.py:64",
    "quant_matmul_t": "src/repro/kernels/lora_matmul.py:146",
    "selective_scan": "src/repro/kernels/selective_scan.py:54",
    # the JAX package has no Pallas backward: its gradient is autodiff
    "selective_scan_bwd": "jax.vjp of src/repro/kernels/selective_scan.py:54",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}
SOURCES["quant_matmul_t"] = SOURCES["lora_matmul"]
SOURCES["selective_scan_bwd"] = SOURCES["selective_scan"]
SERVE_KERNELS = ("quant_matmul", "blockwise_quant", "flash_attention")
# the kernels each trainer's main path launches
TRAIN_KERNELS = {"yi-9b": ("lora_matmul", "quant_matmul_t", "flash_attention"),
                 "falcon-mamba-7b": ("selective_scan", "selective_scan_bwd",
                                     "flash_attention")}
# the scan's trainer shape at Falcon-Mamba-7B width: (B, S, d_inner, N)
MAMBA_SCAN = (4, 64, 8192, 16)
# LoRA linears of a dense block (wq, wk, wv, wo, wg, wu, wd): one
# quant_matmul_t launch each per local step
DENSE_LORA_LINEARS = 7
# the federated round's attention: the adapter's Att(D) at S = Skv = 1,
# 4 heads, fp32, no mask, as (B, D): D = d_model / 4 (16 at the JAX
# package's CLIPConfig(), 192 at ViT-B/32), B = one client's batch (32,
# the sequential oracle), the cohort's 5 x 32 (160) or the eval batch
FL_ATTENTION = [(32, 16), (160, 16), (128, 16), (32, 192), (160, 192),
                (128, 192)]
# the per-round settings of the paper preset (benchmarks/fl_common.py,
# PRESET["paper"] and fl_config; batch 32 is FLConfig's default)
FL_PAPER = dict(dataset="pacs", n_clients=5, local_steps=10, batch_size=32,
                n_per_class=60, lr=3e-3)
FL_ARMS = ("fedclip", "qlora_nogan")
# cohort vs sequential: tests/test_fl.py's oracle tolerances for the
# losses and accuracies; a trainable leaf is held in norm to UPDATE_REL of
# its round's update (the two behind the adapter's ReLU to GATED_REL),
# its largest difference reported beside leaf_atol (``round_diffs``)
ORACLE = dict(leaf_atol=5e-4, loss_atol=1e-3, loss_rtol=1e-4, acc_atol=1e-5)
UPDATE_REL, GATED_REL = 2e-2, 1e-1


# -- measurement helpers -----------------------------------------------

def timings(fn, iters: int = 50) -> tuple:
    """(device ms, call ms) per call of ``fn()``. Device time is the sum
    of the card's kernel and copy activities that ``torch.profiler``
    records over ``iters`` calls (what the kernels themselves take);
    call time comes from CUDA events around ``iters`` back-to-back calls
    and includes the host's dispatch, which bounds it at small shapes.
    A profiler session that records no device activity is repeated, up
    to three sessions; device time is None if none records any."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    call_ms = t0.elapsed_time(t1) / iters
    dev_us = 0.0
    for _ in range(3):   # a profiler session now and then records nothing
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if dev_us > 0:
            break
    return (dev_us / 1e3 / iters if dev_us > 0 else None), call_ms


def timed(row: dict, key: str, fn) -> None:
    """Store ``fn``'s device time under ``key`` and its call time under
    ``key`` + "_call" (the device time falls back to the call time, and
    says so, if the profiler saw no device activity)."""
    dev, call = timings(fn)
    row[key] = dev if dev is not None else call
    row[key + "_call"] = call
    if dev is None:
        row[key + "_source"] = "cuda events (profiler saw no device time)"


def bound(nbytes: float, nops: float, dtype) -> tuple:
    """(least time in ms, what bounds it): bytes over HBM rate vs
    operations over the peak rate for the operands' type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def routed(wrapper, run) -> tuple:
    """``run()``'s result and the route its launch took, read from the
    kernel wrapper's own count of tensor-core launches."""
    before = wrapper.tc_launches
    out = run()
    return out, ("tensor cores" if wrapper.tc_launches > before
                 else "cuda cores")


def report(row: dict) -> None:
    print("  " + " ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in row.items()), flush=True)


# -- phase 1: set-up ---------------------------------------------------

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """One line for a kernel source's ptxas report: its kernels' largest
    register count, spill bytes and static shared memory."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)]
    return (f"{len(regs)} kernels, registers <= {max(regs, default=0)}, "
            f"spill stores <= {max(spills, default=0)} B, static smem <= "
            f"{max(smem, default=0)} B")


def ptxas_kernels(log: str) -> dict:
    """Per kernel name (template instances merged): the largest register
    count and spill-store bytes in a source's ptxas report."""
    out: dict = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        m = re.search(r"\d([a-z_]+_(?:kernel|sum))", mangled)
        name = m.group(1) if m else mangled[:40]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        r0, s0 = out.get(name, (0, 0))
        out[name] = (max(r0, int(regs.group(1)) if regs else 0),
                     max(s0, int(spill.group(1)) if spill else 0))
    return out


def setup() -> None:
    print(card_line(), flush=True)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (sm_90), got sm_{cap[0]}{cap[1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    took = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{k}={v:.1f}s" for k, v in took.items()), flush=True)
    for name, log in build.BUILD_LOG.items():
        print(f"  ptxas {name}: {ptxas_summary(log)}", flush=True)
        if name in ("lora_matmul", "selective_scan", "quant_matmul",
                    "blockwise_quant"):
            print("    per kernel (registers, spill store bytes): " + " ".join(
                f"{k}={v}" for k, v in ptxas_kernels(log).items()), flush=True)
    print(f"  selective_scan blocks per SM (N = 16): forward "
          f"{ss_kernel.occupancy('fwd')} ({ss_kernel.FWD_LANES} lanes a "
          f"channel), backward {ss_kernel.occupancy('bwd')} (with dA "
          f"{ss_kernel.occupancy('bwd', need_a=True)}; one thread a "
          f"channel)", flush=True)


# -- phase 2: kernels against their plain versions ---------------------

def gemv_route(run) -> tuple:
    """``run()``'s result and the route its ``quant_matmul`` launch took,
    read from the wrapper's own count of GEMV launches."""
    before = qmm_kernel.quant_matmul.gemv_launches
    out = run()
    return out, ("gemv" if qmm_kernel.quant_matmul.gemv_launches > before
                 else "tiled")


def gemv_plan_row(T, M, G, N, block) -> dict:
    """The GEMV's plan for a call, as a row prints it."""
    pl = qmm_kernel.plan(max(T, 1), M, G, N)
    return {"plan_cols": pl.cols, "plan_cluster": pl.cluster,
            "plan_ctas": pl.ctas,
            "smem_B": qmm_kernel.gemv_smem_bytes(pl, M, G, block)}


def check_quant_matmul(gen) -> dict:
    """Every format and dtype at the serve replay's shape (4 users x 1
    row, 768x768, block 64; every replay launch has this shape), one and
    eight users, one large shape and the odd-K / ragged-N edge; two calls
    must be bitwise equal. Returns the replay-shape int8 record."""
    dev = "cuda"
    cases = [  # (name, T, M, K, N, bits, mode, dtype)
        ("serve_t4_int8", 4, 1, 768, 768, 8, "linear", torch.float32),
        ("serve_t1_int8", 1, 1, 768, 768, 8, "linear", torch.float32),
        ("serve_t8_int8", 8, 1, 768, 768, 8, "linear", torch.float32),
        ("serve_t4_int4", 4, 1, 768, 768, 4, "linear", torch.float32),
        ("serve_t4_nf4", 4, 1, 768, 768, 4, "nf4", torch.float32),
        ("serve_t4_int8_bf16", 4, 1, 768, 768, 8, "linear", torch.bfloat16),
        ("large_int8", 0, 800, 768, 3072, 8, "linear", torch.float32),
        ("large_nf4_bf16", 0, 800, 768, 3072, 4, "nf4", torch.bfloat16),
        ("gemv_m3_nf4", 4, 3, 256, 96, 4, "nf4", torch.float32),
        ("gemv_oddK_int4", 0, 2, 100, 64, 4, "linear", torch.float32),
        ("oddK_raggedN_int8", 0, 5, 100, 70, 8, "linear", torch.float32),
        ("oddK_raggedN_int4", 0, 5, 100, 70, 4, "linear", torch.float32),
    ]
    main = None
    for name, T, M, K, N, bits, mode, dtype in cases:
        lead = (T,) if T else ()
        w = torch.randn((*lead, K, N), generator=gen, device=dev) / K ** 0.5
        if K % 64:   # the odd-K contract: payload covers the padded K
            qt = ref.blockwise_quant(w, bits=bits, block=64, mode=mode)
        else:
            qt = qlib.quantize(w, bits=bits, block=64, mode=mode)
        x = torch.randn((*lead, M, K), generator=gen, device=dev).to(dtype)
        got, route = gemv_route(lambda: qmm_kernel.quant_matmul(x, qt))
        again = qmm_kernel.quant_matmul(x, qt)
        want = ref.quant_matmul(x, qt)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, want)
        tol = 1e-5 if dtype == torch.float32 else 1.6e-2
        if not (rel_e <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"quant_matmul {name}: rel err {rel_e} > {tol}")
        if not torch.equal(got, again):
            raise AssertionError(f"quant_matmul {name}: two calls differ")
        G = qt.q.shape[-3]
        Kq = G * qt.block
        b_ms, b_by = bound(nbytes(x, qt.q, qt.scales, got),
                           2.0 * max(T, 1) * M * Kq * N, dtype)
        row = {"case": name, "route": route, "max_abs_err": abs_e,
               "rel_err": rel_e, "repeat_bitwise": True,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if route == "gemv":
            row.update(gemv_plan_row(T, M, G, N, qt.block))
        timed(row, "ms", lambda: qmm_kernel.quant_matmul(x, qt))
        timed(row, "plain_ms", lambda: ref.quant_matmul(x, qt))
        report({"quant_matmul": 1, **row})
        if name == "serve_t4_int8":
            main = row
    return main


def check_blockwise_quant(gen) -> dict:
    """int8 and int4 at the store's (768, 768) block 64 and block 128, at
    the odd (100, 70) and the ragged N = 770; payload and scales must
    equal the plain version bitwise."""
    main = None
    for K, N, block in ((768, 768, 64), (768, 768, 128), (100, 70, 64),
                        (768, 770, 64)):
        for bits in (8, 4):
            x = torch.randn((K, N), generator=gen, device="cuda")
            got = bq_kernel.blockwise_quant(x, bits=bits, block=block)
            want = ref.blockwise_quant(x, bits=bits, block=block)
            torch.cuda.synchronize()
            if not (torch.equal(got.q, want.q) and
                    torch.equal(got.scales, want.scales) and
                    got.orig_shape == want.orig_shape):
                raise AssertionError(
                    f"blockwise_quant ({K},{N}) int{bits} block {block}: not "
                    f"bitwise equal ({(got.q != want.q).sum().item()} codes, "
                    f"{(got.scales != want.scales).sum().item()} scales)")
            b_ms, b_by = bound(nbytes(x, got.q, got.scales),
                               3.0 * x.numel(), torch.float32)
            row = {"case": f"({K},{N})_int{bits}_block{block}",
                   "max_abs_err": (got.scales - want.scales).abs().max().item(),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            timed(row, "ms", lambda: bq_kernel.blockwise_quant(
                x, bits=bits, block=block))
            timed(row, "plain_ms", lambda: ref.blockwise_quant(
                x, bits=bits, block=block))
            report({"blockwise_quant": 1, **row})
            if (K, N, block, bits) == (768, 768, 64, 8):
                main = row
    return main


def _valid_pairs(S, Skv, causal, window) -> int:
    qp = np.arange(S)[:, None]
    kp = np.arange(Skv)[None, :]
    m = np.ones((S, Skv), bool)
    if causal:
        m &= qp >= kp
    if window is not None:
        m &= (qp - kp) < window
    return int(m.sum())


def check_flash_attention(gen) -> dict:
    """The serve oracle's (1, 1, 4, 192) and a (2, 300, 8, 64) GQA
    (Hkv=2) causal window-64 case, plus bf16 runs (the tensor-core
    kernel): long S, D % 8 != 0 (element loads) and a ragged S = 50
    with a window."""
    cases = [  # (name, B, S, H, Hkv, D, causal, window, dtype)
        ("serve_1x1x4x192", 1, 1, 4, 4, 192, False, None, torch.float32),
        ("gqa_causal_w64", 2, 300, 8, 2, 64, True, 64, torch.float32),
        ("bidir_d256", 1, 77, 4, 4, 256, False, None, torch.float32),
        ("gqa_causal_bf16", 2, 300, 8, 2, 64, True, None, torch.bfloat16),
        ("d36_causal_bf16", 1, 33, 2, 2, 36, True, None, torch.bfloat16),
        ("s50_w8_gqa_bf16", 2, 50, 4, 2, 64, True, 8, torch.bfloat16),
    ]
    main = None
    for name, B, S, H, Hkv, D, causal, window, dtype in cases:
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
        run = lambda: fa_kernel.flash_attention(q, k, v, causal=causal,
                                                window=window)
        got, route = routed(fa_kernel.flash_attention, run)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, want)
        tol = 1e-5 if dtype == torch.float32 else 1.6e-2
        if not (rel_e <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {name}: rel err {rel_e} > {tol}")
        # the one PyTorch call computing the same function, timed only
        G = H // Hkv
        qt_, kt_, vt_ = (t.transpose(1, 2).contiguous() for t in (
            q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
        b_ms, b_by = bound(nbytes(q, k, v, got),
                           4.0 * B * H * D * _valid_pairs(S, S, causal, window),
                           dtype)
        row = {"case": name, "route": route, "max_abs_err": abs_e,
               "rel_err": rel_e, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        timed(row, "ms", run)
        timed(row, "plain_ms", lambda: ref.flash_attention(
            q, k, v, causal=causal, window=window))
        if window is None:   # SDPA has no sliding window
            time_sdpa_backends(row, qt_, kt_, vt_, causal)
        report({"flash_attention": 1, **row})
        if name.startswith("serve"):
            main = row
    return main


def _tol(dtype) -> float:
    """fp32: 1e-5 of the largest magnitude (TF32 off); bf16: 2e-2 of it,
    the JAX package's bf16 bound (tests/test_kernels.py)."""
    return 1e-5 if dtype == torch.float32 else 2e-2


def check_lora_kernels(gen) -> tuple:
    """``lora_matmul`` and ``quant_matmul_t`` at the trainer's four Yi-9B
    (K, N) pairs (M = 4 x 64 tokens, NF4 block 64, bf16 x and g, rank
    16) and at int8, int4, fp32, odd K = 200 and ragged N = 33, K = 201
    (element loads of x), rank 20 (padded to 32) and M below the tile.
    bf16 calls take the tensor-core kernels with ``plan``'s / ``plan_t``'s
    split count, printed beside them; ``quant_matmul_t`` with a bf16 g
    writes fp32, as the trainer's backward calls it, and is held to 1e-4
    of the largest magnitude (its fp32-g route to 1e-5). At the Yi shapes
    a dense bf16 ``torch.matmul`` of the same (M, K, N) is timed as
    context for ``lora_matmul`` (not a yardstick: it reads a dense W),
    and the fp32-g route of ``quant_matmul_t`` (the trainer's before this
    kernel) on the same values. Returns the two records at the wg/wu
    shape (the largest per-call work)."""
    dev = "cuda"
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, 256, K, N, 4, "nf4", bf16, 16)
             for name, (K, N) in YI_LINEARS.items()] + [
        ("int8_f32", 64, 512, 256, 8, "linear", f32, 16),
        ("int4_f32", 64, 512, 256, 4, "linear", f32, 16),
        ("int8_bf16", 64, 512, 256, 8, "linear", bf16, 16),
        ("int4_bf16", 64, 512, 256, 4, "linear", bf16, 16),
        ("nf4_bf16_oddK_raggedN", 37, 200, 33, 4, "nf4", bf16, 4),
        ("nf4_bf16_K201", 37, 201, 48, 4, "nf4", bf16, 4),
        ("nf4_bf16_r20_M9", 9, 128, 96, 4, "nf4", bf16, 20),
        ("int8_f32_oddK_raggedN", 37, 200, 33, 8, "linear", f32, 4),
    ]
    main = {}
    for name, M, K, N, bits, mode, dtype, r in cases:
        w = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
             ).to(torch.bfloat16)
        qt = ref.blockwise_quant(w, bits=bits, block=64, mode=mode)
        x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
        a = torch.randn((K, r), generator=gen, device=dev) / K ** 0.5
        b = torch.randn((r, N), generator=gen, device=dev) * 0.05
        g = torch.randn((M, N), generator=gen, device=dev).to(dtype)
        Kq = qt.q.shape[-3] * qt.block
        for kname, wrapper, run, plain, tol, nops, ins in (
                ("lora_matmul", lm_kernel.lora_matmul,
                 lambda: lm_kernel.lora_matmul(x, qt, a, b, scale=2.0),
                 lambda: ref.lora_matmul(x, qt, a, b, scale=2.0), _tol(dtype),
                 2.0 * M * (Kq * N + K * r + r * N), (x, a, b)),
                ("quant_matmul_t", lm_kernel.quant_matmul_t,
                 lambda: lm_kernel.quant_matmul_t(g, qt, out_dtype=f32),
                 lambda: ref.quant_matmul_t(g, qt, out_dtype=f32),
                 1e-4 if dtype == bf16 else 1e-5, 2.0 * M * Kq * N, (g,))):
            got, route = routed(wrapper, run)
            want = plain()
            torch.cuda.synchronize()
            abs_e, rel_e = rel_err(got, want)
            if not (rel_e <= tol and torch.isfinite(got).all()):
                raise AssertionError(f"{kname} {name}: rel err {rel_e} > {tol}")
            b_ms, b_by = bound(nbytes(*ins, qt.q, qt.scales, got), nops,
                               ins[0].dtype)
            row = {"case": name, "route": route}
            if dtype == bf16:
                if route != "tensor cores":
                    raise AssertionError(f"{kname} {name}: bf16 took {route}")
                row["splits"] = (lm_kernel.plan(M, K, N, qt.block)
                                 if kname == "lora_matmul" else
                                 lm_kernel.plan_t(M, Kq, N)).splits
            row.update(max_abs_err=abs_e, rel_err=rel_e, tol=tol,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            timed(row, "ms", run)
            timed(row, "plain_ms", plain)
            if name in YI_LINEARS and kname == "lora_matmul":
                timed(row, "dense_bf16_ms", lambda: x @ w)
            if name in YI_LINEARS and kname == "quant_matmul_t":
                g32 = g.float()
                timed(row, "fp32_g_ms",
                      lambda: lm_kernel.quant_matmul_t(g32, qt))
            report({kname: 1, **row})
            if name == "wg_wu":
                main[kname] = row
    print("  library: no single PyTorch call computes x @ dequant(W_q) + "
          "s(x@A)@B or g @ dequant(W_q)^T from the quantized payload "
          "(library_ms = null)", flush=True)
    return main["lora_matmul"], main["quant_matmul_t"]


def qmt_split_sweep(gen, counts=(1, 2, 3, 4, 8, 16)) -> None:
    """``quant_matmul_t``'s tensor-core kernel (bf16 g, fp32 out) at the
    four Yi-9B shapes with each split count forced: the device time of
    each, beside ``plan_t``'s modelled time and its pick (the data its
    tile-time constant is fitted to), each count held to the plain
    version at 1e-4."""
    f32 = torch.float32
    for name, (K, N) in YI_LINEARS.items():
        w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
        qt = ref.blockwise_quant(w, bits=4, block=64, mode="nf4")
        g = torch.randn((256, N), generator=gen, device="cuda").to(
            torch.bfloat16)
        Kq = qt.q.shape[-3] * qt.block
        want = ref.quant_matmul_t(g, qt, out_dtype=f32)
        pl = lm_kernel.plan_t(256, Kq, N)
        ms, model = {}, {}
        for s_ in counts:
            run = lambda: lm_kernel._quant_matmul_t(g, qt, f32, s_)
            rel_e = rel_err(run(), want)[1]
            if not rel_e <= 1e-4:
                raise AssertionError(f"quant_matmul_t {name} at {s_} splits: "
                                     f"rel err {rel_e}")
            dev_ms, call_ms = timings(run, iters=20)
            ms[s_] = round(dev_ms if dev_ms is not None else call_ms, 5)
            tiles_per_split = -(-(-(-N // lm_kernel.BK)) // s_)
            model[s_] = round(lm_kernel.plan_cost_us(
                256, Kq, pl.tiles, tiles_per_split, s_,
                lm_kernel.T_TILE_US, lm_kernel.T_PARTIAL_BYTES_PER_US) / 1e3, 5)
        report({"quant_matmul_t_splits": name, "planned": pl.splits,
                "device_ms": ms, "model_ms": model})


def time_sdpa_backends(row: dict, q, k, v, causal: bool) -> None:
    """Time ``scaled_dot_product_attention`` on (B, H, S, D) inputs under
    each backend that accepts them, one at a time
    (``torch.nn.attention.sdpa_kernel``); a backend that refuses the
    shape or dtype is reported as such. ``row["library_ms"]`` is the
    fastest, ``row["library"]`` its name, ``row["sdpa_ms"]`` every
    backend's device time."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION),
                          ("math", SDPBackend.MATH)):
        def run(backend=backend):
            with sdpa_kernel(backend):
                return sdpa(q, k, v, is_causal=causal)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                run()
                torch.cuda.synchronize()
        except RuntimeError:
            times[name] = "refused"
            continue
        t: dict = {}
        timed(t, "ms", run)
        times[name] = t["ms"]
    ran = {n: t for n, t in times.items() if not isinstance(t, str)}
    best = min(ran, key=ran.get) if ran else None
    row["library_ms"] = ran[best] if best else None
    row["library"] = f"sdpa/{best}" if best else "sdpa: every backend refused"
    row["sdpa_ms"] = {n: (f"{t:.4g}" if not isinstance(t, str) else t)
                      for n, t in times.items()}


def check_flash_train(gen) -> dict:
    """The trainer's two attention shapes, bf16 and causal: the backbone
    (4, 64, 32, 128) with 4 KV heads and the adapter (4, 64, 8, 512);
    forward against the plain version, the autograd.Function's backward
    against autograd through the plain version. Returns the adapter's
    forward record."""
    cases = [("backbone_gqa_d128", 4, 64, 32, 4, 128),
             ("adapter_d512", 4, 64, 8, 8, 512)]
    main = None
    for name, B, S, H, Hkv, D in cases:
        dt = torch.bfloat16
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
        do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
        run = lambda: fa_kernel.flash_attention(q, k, v, causal=True)
        got, route = routed(fa_kernel.flash_attention, run)
        want = ref.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, want)
        if not (rel_e <= _tol(dt) and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {name}: rel err {rel_e}")
        if route != "tensor cores":
            raise AssertionError(f"flash_attention {name}: bf16 took {route}")
        pairs = _valid_pairs(S, S, True, None)
        b_ms, b_by = bound(nbytes(q, k, v, got), 4.0 * B * H * D * pairs, dt)
        row = {"case": name, "route": route, "max_abs_err": abs_e,
               "rel_err": rel_e, "bound_ms": b_ms, "bound_by": b_by}
        timed(row, "ms", run)
        timed(row, "plain_ms", lambda: ref.flash_attention(q, k, v,
                                                           causal=True))
        G = H // Hkv
        qt_, kt_, vt_ = (t.transpose(1, 2).contiguous() for t in (
            q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
        time_sdpa_backends(row, qt_, kt_, vt_, True)
        report({"flash_attention": 1, **row})

        # backward: the Function's PyTorch-op gradient vs autograd of plain
        grads = []
        for fn in (ops.flash_attention, ref.flash_attention):
            ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            (fn(*ts, causal=True).float() * do.float()).sum().backward()
            grads.append([t.grad for t in ts])
        errs = [rel_err(g_, w_)[1] for g_, w_ in zip(*grads)]
        if not max(errs) <= _tol(dt):
            raise AssertionError(f"flash_attention backward {name}: rel "
                                 f"errs dq/dk/dv {errs}")
        brow = {"case": name + "_bwd", "rel_err_dq_dk_dv": max(errs)}
        b_ms, b_by = bound(nbytes(q, k, v, do, q, k, v),
                           10.0 * B * H * D * pairs, dt)
        brow.update(bound_ms=b_ms, bound_by=b_by)
        timed(brow, "ms", lambda: ops.flash_attention_bwd(q, k, v, do,
                                                          causal=True))

        def plain_bwd():
            ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
            torch.autograd.grad(ref.flash_attention(*ts, causal=True), ts, do)
        timed(brow, "plain_ms", plain_bwd)
        report({"flash_attention_bwd (PyTorch ops)": 1, **brow})
        if name == "adapter_d512":
            main = row
    return main


def _scan_inputs(gen, B, S, di, N):
    """Seeded fp32 scan inputs on the card: dt > 0 (a softplus output),
    A < 0 (``-exp(a_log)``)."""
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    return (r(B, S, di).abs() * 0.1, r(B, S, di), r(B, S, N), r(B, S, N),
            -r(di, N).abs())


def _peak_beyond(fn) -> int:
    """Device bytes ``fn()`` holds at its peak beyond what was allocated
    before it (its outputs and scratch)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def scan_bwd_ops(B, S, di, N, need_a) -> float:
    """Operations of the scan's gradient: per (b, t, d, n) the forward
    recompute (dt A, exp, a h, dt x B, +: 5) and the reverse step
    (g = gy C + carry: 2, a g, q = a g h: 2, q A and g B summed over n: 4,
    g dt x and gy h summed over d: 4; q dt summed for dA: 2); per
    (b, t, d) dt x, dt log2 e, ddt and dx: 4."""
    return B * S * di * ((18.0 + 2.0 * need_a) * N + 4)


def check_selective_scan(gen) -> tuple:
    """``selective_scan`` against the plain time loop at the trainer's
    Falcon-Mamba-7B shape and at edge shapes (S = 50, di = 520, N = 4
    and 8, B = 1; S = 130 over several chunks, di = 33, N = 5): y and
    h_last within 1e-5 of each output's largest magnitude. Then at the
    same shapes the backward kernel ``selective_scan_bwd`` against the
    plain ``ops.selective_scan_bwd`` on the same inputs, as the trainer
    calls it (no h_last cotangent, A frozen) and with both (dA on): each
    of ddt, dx, dB, dC (dA) within 1e-5 of its largest magnitude, and two
    calls bitwise equal; at the trainer's shape with times, a bound and
    the peak device bytes beyond the inputs of both. Last the op's
    gradient (both kernels) against autograd through the plain scan.
    Returns the trainer-shape forward and backward records."""
    cases = [("trainer", *MAMBA_SCAN), ("S50_di520_N4_B1", 1, 50, 520, 4),
             ("S50_di520_N8", 2, 50, 520, 8), ("S130_di33_N5", 2, 130, 33, 5)]
    main = {}
    for name, B, S, di, N in cases:
        ins = _scan_inputs(gen, B, S, di, N)
        run = lambda: ss_kernel.selective_scan(*ins)
        (y, h), (y0, h0) = run(), ref.selective_scan(*ins)
        torch.cuda.synchronize()
        (ey, ry), (eh, rh) = rel_err(y, y0), rel_err(h, h0)
        if not (max(ry, rh) <= 1e-5 and torch.isfinite(y).all()):
            raise AssertionError(f"selective_scan {name}: rel err y {ry} "
                                 f"h_last {rh} > 1e-5")
        # per (b, t, d, n): dt*A, exp, a*h, dx*B, +, h*C, +; per (b, t, d):
        # dt*x
        b_ms, b_by = bound(nbytes(*ins, y, h), B * S * di * (7.0 * N + 1),
                           torch.float32)
        row = {"case": name, "max_abs_err": max(ey, eh),
               "rel_err_y": ry, "rel_err_h_last": rh,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        timed(row, "ms", run)
        timed(row, "plain_ms", lambda: ref.selective_scan(*ins))
        report({"selective_scan": 1, **row})
        if name == "trainer":
            main["selective_scan"] = row
    print("  library: no single PyTorch call computes the selective scan "
          "(library_ms = null)", flush=True)

    names = ("ddt", "dx", "dB", "dC", "dA")
    for name, B, S, di, N in cases:
        ins = _scan_inputs(gen, B, S, di, N)
        gy = torch.randn((B, S, di), generator=gen, device="cuda")
        gh = torch.randn((B, di, N), generator=gen, device="cuda")
        for with_gh, need_a in ((False, False), (True, True)):
            run = lambda: ss_kernel.selective_scan_bwd(
                *ins, gy, gh if with_gh else None, need_a=need_a)
            plain = lambda: ops.selective_scan_bwd(
                *ins, gy, gh if with_gh else torch.zeros_like(gh),
                need_a=need_a)
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            errs = {n: rel_err(g, w) for n, g, w in zip(names, got, want)
                    if w is not None}
            worst = max(r for _, r in errs.values())
            if not (worst <= 1e-5 and
                    all(torch.isfinite(g).all() for g in got if g is not None)):
                raise AssertionError(f"selective_scan_bwd {name} gh={with_gh}"
                                     f" dA={need_a}: rel errs {errs}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None):
                raise AssertionError(f"selective_scan_bwd {name}: two calls "
                                     "differ")
            row = {"case": name + ("" if with_gh else "_as_trainer"),
                   "gh_last": with_gh, "need_a": need_a,
                   "max_abs_err": max(a for a, _ in errs.values()),
                   "rel_err": worst, "bitwise_repeat": True}
            if name == "trainer" and not with_gh:
                outs = [t for t in got if t is not None]
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes(*ins, gy, *outs), scan_bwd_ops(B, S, di, N, need_a),
                    torch.float32)
                row["library_ms"] = None
                timed(row, "ms", run)
                timed(row, "plain_ms", plain)
                row["peak_bytes_beyond_inputs"] = _peak_beyond(run)
                row["plain_peak_bytes_beyond_inputs"] = _peak_beyond(plain)
                main["selective_scan_bwd"] = row
            report({"selective_scan_bwd": 1, **row})
    print("  library: no single PyTorch call computes the scan's gradient "
          "(library_ms = null)", flush=True)

    # the op (both kernels) against autograd through the plain time loop
    B, S, di, N = MAMBA_SCAN
    ins = _scan_inputs(gen, B, S, di, N)
    gy = torch.randn((B, S, di), generator=gen, device="cuda")
    gh = torch.randn((B, di, N), generator=gen, device="cuda")

    def grads(fn):
        ts = [t.detach().requires_grad_(True) for t in ins]
        return torch.autograd.grad(fn(*ts), ts, (gy, gh))
    ops.reset_kernel_traces()
    got = grads(ops.selective_scan)
    if ops.KERNEL_TRACES != {"selective_scan_cuda": 1,
                             "selective_scan_bwd_cuda": 1}:
        raise AssertionError(f"the scan op's routes: {ops.KERNEL_TRACES}")
    errs = [rel_err(g, w)[1] for g, w in zip(got, grads(ref.selective_scan))]
    if not max(errs) <= 1e-5:
        raise AssertionError(f"selective_scan gradient: rel errs ddt/dx/dB/"
                             f"dC/dA {errs} > 1e-5")

    def autograd_plain():
        ts = [t.detach().requires_grad_(i < 4) for i, t in enumerate(ins)]
        torch.autograd.grad(ref.selective_scan(*ts)[0], ts[:4], gy)
    brow = {"case": "trainer_op_grad", "rel_err_grads": max(errs)}
    timed(brow, "autograd_plain_ms", autograd_plain)
    report({"selective_scan gradient (op vs autograd of plain)": 1, **brow})
    return main["selective_scan"], main["selective_scan_bwd"]


# -- phase 3: the serving plane ----------------------------------------

def perturbed(tree, gen, device):
    """A seeded perturbation of every leaf so that the zero-init wo, w2
    and LoRA b are non-zero and every quantized matrix moves the logits
    (a smoke harness: the repository ships no trained weights)."""
    def f(leaf):
        std = 0.2 / leaf.shape[-2] ** 0.5 if leaf.ndim >= 2 else 0.02
        noise = torch.randn(leaf.shape, generator=gen, device=gen.device)
        return leaf + (noise * std).to(device)
    return tree_lib.tree_map(f, tree)


def build_plane(device, cfg, *, n_users: int, seed: int):
    gen = torch.Generator(device=device).manual_seed(seed)
    frozen = clip_lib.init_clip(gen, cfg, device=device)
    spec = SPECS["pacs"]
    toks = torch.as_tensor(class_tokens(spec, np.arange(spec.n_classes)),
                           dtype=torch.long, device=device)
    class_emb = clip_lib.text_embedding(frozen, cfg, toks)
    backing = {}
    for uid in range(n_users):
        arm = "fedclip" if uid < n_users // 2 else "qlora_nogan"
        tr = client_lib.init_trainable(gen, cfg, STRATEGIES[arm],
                                       device=device)
        backing[uid] = perturbed(tr, gen, device)
    return frozen, class_emb, backing


def make_engine(frozen, cfg, class_emb, backing, *, quant_bits, max_entries,
                max_batch, device):
    store = serve_lib.AdapterStore(backing, max_entries=max_entries,
                                   quant_bits=quant_bits, device=device)
    return serve_lib.ServeEngine(
        frozen=frozen, ccfg=cfg, class_emb=class_emb, store=store,
        cfg=serve_lib.ServeConfig(max_batch=max_batch))


def profile_replay(engine, trace, images) -> dict:
    """Replay the trace a second time (the store is warm) with the card's
    activity traced: wall time, device busy time (the sum of kernel and
    copy intervals on the one stream), the idle share, and the kernels
    that take the most device time."""
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec = serve_lib.replay(engine, trace, images, collect_logits=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == cuda:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall, "flights": rec["n_flights"],
            "top_us": [(name[:60], round(us, 1)) for name, us in top]}


@contextlib.contextmanager
def record_quant_matmul():
    """Count the ``quant_matmul`` kernel launches made inside the block
    by (users T, rows a user M, route, the plan's CTAs; 0 for the tiled
    route), read around each call of the op ``ops.quant_matmul``, which
    the serve engine calls; the kernel wrapper and its counts are left
    as they are."""
    calls: collections.Counter = collections.Counter()
    op, wrapper = ops.quant_matmul, qmm_kernel.quant_matmul

    def recorded(x, qt):
        before = (wrapper.launches, wrapper.gemv_launches)
        y = op(x, qt)
        if wrapper.launches > before[0]:
            T = qt.q.shape[0] if qt.q.ndim == 4 else 1
            M = x.numel() // (T * x.shape[-1])
            gemv = wrapper.gemv_launches > before[1]
            ctas = qmm_kernel.plan(T, M, qt.q.shape[-3],
                                   qt.q.shape[-1]).ctas if gemv else 0
            calls[(T, M, "gemv" if gemv else "tiled", ctas)] += 1
        return y

    ops.quant_matmul = recorded
    try:
        yield calls
    finally:
        ops.quant_matmul = op


def serve_phase(device, cfg, *, n_users=16, n_requests=96, max_entries=12,
                max_batch=8, seed=0) -> dict:
    """Replay a Zipf trace through the int8 plane and the sequential
    oracle; then one flight at int4 and one unquantized. Returns the
    kernel launch counts of the replay + oracle run and the results."""
    frozen, class_emb, backing = build_plane(device, cfg, n_users=n_users,
                                             seed=seed)
    trace = serve_lib.zipf_request_trace(n_users, n_requests, seed=seed,
                                         rate=200.0, period=1.0,
                                         amplitude=0.5)
    rs = np.random.RandomState(seed)
    s = cfg.image_size
    images = rs.uniform(-1, 1, (n_requests, s, s, cfg.channels)) \
        .astype(np.float32)
    reqs = [(int(u), im) for u, im in zip(trace.uid, images)]
    engine = make_engine(frozen, cfg, class_emb, backing, quant_bits=8,
                         max_entries=max_entries, max_batch=max_batch,
                         device=device)

    ops.reset_launch_counts()
    with record_quant_matmul() as qmm_calls:
        rec = serve_lib.replay(engine, trace, images)
    after_replay = ops.launch_counts()
    t0 = time.perf_counter()
    oracle = serve_lib.serve_sequential(frozen, cfg, class_emb, backing,
                                        reqs, device=device)
    oracle_s = time.perf_counter() - t0
    launches = ops.launch_counts()

    logits = rec["logits"]
    if logits.shape != (n_requests, SPECS["pacs"].n_classes) or \
            not np.isfinite(logits).all():
        raise AssertionError(f"bad serve logits {logits.shape}")
    err8 = float(np.max(np.abs(logits - oracle)))
    if not err8 < 5e-2:
        raise AssertionError(f"int8 plane vs oracle: {err8} >= 5e-2")

    # one flight at int4: against the oracle on the dequantized int4
    # trees (same weights, so fp tolerance) and, for scale, the fp32 one
    flight = reqs[:max_batch]
    eng4 = make_engine(frozen, cfg, class_emb, backing, quant_bits=4,
                       max_entries=max_entries, max_batch=max_batch,
                       device=device)
    out4, _ = eng4.serve(flight)
    deq4 = {uid: qlib.dequantize_tree(serve_lib.quantize_at_rest(
        backing[uid], bits=4), torch.float32) for uid, _ in flight}
    err4_deq = float(np.max(np.abs(out4 - serve_lib.serve_sequential(
        frozen, cfg, class_emb, deq4, flight, device=device))))
    err4_fp = float(np.max(np.abs(out4 - oracle[:max_batch])))
    if not err4_deq < 1e-3:
        raise AssertionError(f"int4 plane vs dequantized oracle: {err4_deq}")
    eng0 = make_engine(frozen, cfg, class_emb, backing, quant_bits=0,
                       max_entries=max_entries, max_batch=max_batch,
                       device=device)
    out0, _ = eng0.serve(flight)
    err0 = float(np.max(np.abs(out0 - oracle[:max_batch])))
    if not err0 < 1e-4:
        raise AssertionError(f"unquantized plane vs oracle: {err0} >= 1e-4")
    profile = profile_replay(engine, trace, images) \
        if torch.device(device).type == "cuda" else None
    return {"profile": profile, "launches": launches,
            "after_replay": after_replay, "qmm_calls": dict(qmm_calls),
            "rec": rec, "err_int8": err8, "err_int4_vs_dequant": err4_deq,
            "err_int4_vs_fp32": err4_fp, "err_fp32": err0,
            "oracle_s": oracle_s, "store": engine.store.stats(),
            "bytes_at_rest": engine.store.bytes_at_rest()}


# -- phase 4: a full-width step on the card against the CPU ------------

def _leaf_errs(got_tree, want_tree) -> dict:
    """Per trainable leaf: max |card - CPU| over max |CPU|."""
    want = dict(tree_lib.flatten_with_path(want_tree))
    return {"/".join(map(str, path)): rel_err(g.cpu(), want[path])[1]
            for path, g in tree_lib.flatten_with_path(got_tree)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# trainable leaves whose gradient passes the adapter's ReLU gate
RELU_GATED = ("adapter/w1", "adapter/b1")


def _leaf_norm_errs(got_tree, want_tree) -> dict:
    """Per trainable leaf: ||card - CPU|| / ||CPU||."""
    want = dict(tree_lib.flatten_with_path(want_tree))
    out = {}
    for path, g in tree_lib.flatten_with_path(got_tree):
        w = want[path].float()
        out["/".join(map(str, path))] = (
            (g.cpu().float() - w).norm() / w.norm().clamp_min(1e-30)).item()
    return out


def step_check_phase(seed: int = 0, n_layers: int = 2, device="cuda",
                     arch: str = "yi-9b") -> dict:
    """One ``train_step``'s loss and gradients at the full width of
    ``arch`` (Yi-9B or Falcon-Mamba-7B) with
    ``n_layers`` layers (NF4 backbone, seeded weights with the zero-init
    LoRA B and adapter wo/w2 perturbed so every path carries gradient,
    one batch of 4 x 64 tokens): on the card through the kernels and on
    the CPU through the plain versions, on the same weights, once with
    an fp32 and once with the trainer's bf16 model dtype. The loss agrees
    within 1e-3, the grad norm and every grad leaf within 2e-2, a leaf
    measured as
    ||card - CPU|| / ||CPU||, except the two leaves behind the adapter's
    ReLU in bf16, which are reported only. A pre-activation within
    rounding of zero takes that ReLU the other way on the other device
    and moves the unit's w1 column and b1 entry for that token: a few
    such units in fp32 (3.8% of the w1 leaf's largest entry on an H100,
    the loss bit-equal), many more in bf16, where both devices round
    every activation to 8 bits (6% in norm on w1 on an H100, every other
    leaf within 1.6%, loss and grad norm within 1e-4, at Yi-9B). The
    largest
    elementwise difference over a leaf's largest magnitude is reported
    beside each leaf. ``device`` is the card except in a rehearsal on
    the CPU."""
    out = {}
    for dname in ("float32", "bfloat16"):
        cfg = get_config(arch).replace(n_layers=n_layers, dtype=dname,
                                       **CLI_NF4)
        model = build_model(cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = model.init_params(gen, device=device)
        frozen = params["frozen"]
        tr = perturbed(params["trainable"], gen, device)
        toks = train_lib.synthetic_token_stream(
            np.random.RandomState(seed), cfg.vocab_size, 1,
            docs_per_client=4, seq=64)[0]
        ops.reset_kernel_traces()
        t0 = time.perf_counter()
        (loss_d, _), g_d = model.grads(frozen, tr,
                                       train_lib.make_batch(toks, device))
        _sync(device)
        card_s = time.perf_counter() - t0
        traces = dict(ops.KERNEL_TRACES)
        bad = [k for k in traces if k.endswith("_ref")]
        if bad and torch.device(device).type == "cuda":
            raise AssertionError(f"card step took plain routes: {bad}")
        t0 = time.perf_counter()
        (loss_h, _), g_h = model.grads(convert.tree_to(frozen, "cpu"),
                                       convert.tree_to(tr, "cpu"),
                                       train_lib.make_batch(toks, "cpu"))
        cpu_s = time.perf_counter() - t0
        del frozen, params
        errs = _leaf_errs(g_d, g_h)
        norm_errs = _leaf_norm_errs(g_d, g_h)
        gn_d = float(optim.global_norm(g_d))
        gn_h = float(optim.global_norm(g_h))
        res = {"arch": arch, "dtype": dname, "layers": n_layers,
               "loss_card": float(loss_d), "loss_cpu": float(loss_h),
               "loss_rel": abs(float(loss_d) - float(loss_h))
               / abs(float(loss_h)),
               "grad_norm_card": gn_d, "grad_norm_cpu": gn_h,
               "grad_norm_rel": abs(gn_d - gn_h) / gn_h,
               "worst_leaf": max(norm_errs, key=norm_errs.get),
               "worst_leaf_norm_rel": max(norm_errs.values()),
               "worst_leaf_maxabs": max(errs, key=errs.get),
               "worst_leaf_maxabs_rel": max(errs.values()), "card_s": card_s,
               "cpu_s": cpu_s, "traces": traces, "leaf_rel": errs,
               "leaf_norm_rel": norm_errs}
        held = {k: v for k, v in norm_errs.items()
                if dname == "float32" or k not in RELU_GATED}
        res["worst_held_leaf"] = max(held, key=held.get)
        res["worst_held_leaf_norm_rel"] = max(held.values())
        if not (res["loss_rel"] <= 1e-3 and res["grad_norm_rel"] <= 2e-2
                and max(held.values()) <= 2e-2):
            raise AssertionError(f"full-width step card vs CPU: {res}")
        out[dname] = res
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


# -- phase 5: the federated QLoRA trainer at full width and depth -------

def _region(e) -> str:
    """The innermost ``record_function`` range or autograd backward node
    around the CPU event ``e``."""
    while e is not None:
        if e.is_user_annotation:
            return e.name
        if e.name.startswith("autograd::engine::evaluate_function: "):
            return "backward " + e.name.split(": ", 1)[1]
        e = e.cpu_parent
    return "-"


def profile_step(model, frozen, tr, toks, kernels) -> dict:
    """One local step under the profiler (:func:`profile_run`)."""
    batch = train_lib.make_batch(toks, "cuda")
    opt = optim.adam_init(tr)
    return profile_run(
        lambda: model.train_step(frozen, tr, opt, batch, lr=1e-3), kernels)


def profile_run(run, kernels) -> dict:
    """``run()`` under the profiler: wall, device busy time, idle
    share, the top device entries, the launches of each of ``kernels``
    (and how many of them took a tensor-core kernel), and what the host
    dispatched: the ATen ops called from Python (not
    from inside another op) and the device activities they caused.
    Each top device entry names the ops that launched it, with the
    region each ran in (a ``record_function`` range of the model, such
    as ``mamba.dequantize``, or a backward node), and ``regions_ms``
    sums the device time by region."""
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    tc_launches = ops.tc_launch_counts()
    by_name: dict = {}
    host_ops = device_ops = 0
    events = prof.events()
    # a record_function range also appears on the device timeline as a
    # span over its kernels: not device work of its own
    ranges = {e.name for e in events
              if e.device_type != cuda and e.is_user_annotation}
    for e in events:
        if e.device_type == cuda and (e.is_user_annotation or
                                      e.name in ranges):
            continue
        if e.device_type == cuda:
            device_ops += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
        elif e.name.startswith("aten::") and not (
                e.cpu_parent and e.cpu_parent.name.startswith("aten::")):
            host_ops += 1
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the launching op and region of each kernel (by correlation id)
    launched_by: dict = {}
    regions: dict = {}
    for e in events:
        if e.device_type != cuda and e.kernels:
            where = (e.name, _region(e))
            for k in e.kernels:
                d = launched_by.setdefault(k.name, {})
                d[where] = d.get(where, 0.0) + k.duration
                regions[where[1]] = regions.get(where[1], 0.0) + k.duration
    top_by = []
    for n, us in top:
        srcs = sorted(launched_by.get(n, {}).items(), key=lambda kv: -kv[1])
        top_by.append((n[:60], round(us / 1e3, 2),
                       [(op, reg, round(t / 1e3, 2)) for (op, reg), t in
                        srcs[:3]]))
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall, "host_aten_ops": host_ops,
            "device_activities": device_ops,
            "launches": {k: launches[k] for k in kernels},
            "tc_launches": {k: n for k, n in tc_launches.items()
                            if k in kernels},
            "top_ms": top_by,
            "regions_ms": [(r, round(us / 1e3, 2)) for r, us in sorted(
                regions.items(), key=lambda kv: -kv[1])[:12]]}


def train_phase(*, arch="yi-9b", rounds=2, clients=2, steps=2, batch=4,
                seq=64, n_layers=None, seed=0, device="cuda") -> dict:
    """``repro_torch.launch.train``'s main path on ``arch`` (Yi-9B or
    Falcon-Mamba-7B): init, then ``rounds`` of ``clients`` x
    ``client_update`` and ``aggregate``. The launch counts are zeroed
    just before the rounds and read right after. Every per-round mean
    loss must be finite and every uplink's byte count must equal
    ``tree_bytes`` of its quantized delta; on the card every kernel of
    the arch's path must have launched and no op may have taken its
    plain version, and on Falcon-Mamba-7B every local step must trace
    two forward scan kernels per layer (the forward and its remat
    recompute) and one backward scan kernel. A rehearsal on the CPU passes ``device="cpu"``, a smaller
    ``n_layers`` and gets no profile."""
    on_card = torch.device(device).type == "cuda"
    kernels = TRAIN_KERNELS[arch]
    cfg = get_config(arch).replace(**CLI_NF4)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    model = build_model(cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    # what earlier phases leave allocated counts in the peak below
    allocated_at_start = torch.cuda.memory_allocated() if on_card else None
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device=device).manual_seed(seed), device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    frozen, tr = params["frozen"], params["trainable"]
    res = {"arch": arch, "layers": cfg.n_layers, "init_s": init_s,
           "backbone_bytes": qlib.tree_bytes(frozen),
           "layer_stack_bytes": qlib.tree_bytes(frozen["layers"]),
           "trainable_bytes": qlib.tree_bytes(tr), "rounds": []}
    data = train_lib.synthetic_token_stream(
        np.random.RandomState(seed), cfg.vocab_size, clients, seq=seq)

    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    n_steps = 0
    for rnd in range(rounds):
        t0 = time.perf_counter()
        updates, losses, uplink = [], [], 0
        for c in range(clients):
            d, nb, loss, ns, _ = train_lib.client_update(
                model, frozen, tr, data[c], steps=steps, batch=batch,
                lr=1e-3, comm_bits=8, seed=rnd * 100 + c)
            if nb != qlib.tree_bytes(d):
                raise AssertionError(f"uplink {nb} != tree_bytes")
            updates.append((len(data[c]), d))
            losses.append(loss)
            uplink += nb
            n_steps += ns
        tr = train_lib.aggregate(tr, updates)
        _sync(device)
        wall = time.perf_counter() - t0
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"round {rnd}: non-finite losses {losses}")
        res["rounds"].append({"round": rnd, "mean_loss": float(np.mean(losses)),
                              "uplink_bytes": uplink, "wall_s": wall,
                              "s_per_local_step": wall / (clients * steps)})
    launches = ops.launch_counts()
    traces = dict(ops.KERNEL_TRACES)
    res.update(launches=launches, traces=traces, steps=n_steps,
               max_memory_allocated=torch.cuda.max_memory_allocated()
               if on_card else None, allocated_at_start=allocated_at_start,
               profile=None)
    if not on_card:
        return res
    ref_routes = [k for k in traces if k.endswith("_ref")]
    if ref_routes:
        raise AssertionError(f"the trainer took plain routes: {ref_routes}")
    for name in kernels:
        if launches[name] < 1:
            raise AssertionError(f"the trainer launched no {name} kernel")
    # the bf16 model's attention and LoRA linears take the tensor cores
    tc = ops.tc_launch_counts()
    for name in set(kernels) & set(tc):
        if cfg.dtype == "bfloat16" and tc[name] != launches[name]:
            raise AssertionError(f"{name}: {tc[name]} of {launches[name]} "
                                 "launches on tensor cores in a bf16 model")
    res["tc_launches"] = tc
    if "quant_matmul_t" in kernels and cfg.dtype == "bfloat16":
        per_step = traces.get("quant_matmul_t_cuda_tc", 0) / n_steps
        if "quant_matmul_t_cuda" in traces or \
                per_step != DENSE_LORA_LINEARS * cfg.n_layers:
            raise AssertionError(
                f"quant_matmul_t: {per_step} tensor-core launches per local "
                f"step (want {DENSE_LORA_LINEARS * cfg.n_layers}), traces "
                f"{traces}")
    if arch == "falcon-mamba-7b":
        # each layer: the forward, its remat recompute and the backward
        want = {"selective_scan_cuda": 2 * cfg.n_layers,
                "selective_scan_bwd_cuda": cfg.n_layers}
        per_step = {k: traces.get(k, 0) / n_steps for k in want}
        if per_step != want or \
                launches["selective_scan"] != want["selective_scan_cuda"] \
                * n_steps or launches["selective_scan_bwd"] != \
                want["selective_scan_bwd_cuda"] * n_steps:
            raise AssertionError(
                f"scan traces per local step {per_step} (want {want}), "
                f"launches {launches} in {n_steps} local steps")
    idx = np.random.RandomState(seed).randint(0, len(data[0]), batch)
    res["profile"] = profile_step(model, frozen, tr, data[0][idx], kernels)
    return res


def step_check_report(arch: str) -> None:
    """Phases 4 and 6: ``step_check_phase`` on the card, reported."""
    print(f"full-width {arch} step (2 layers), card vs CPU:", flush=True)
    t0 = time.perf_counter()
    for res in step_check_phase(arch=arch).values():
        report({k: v for k, v in res.items()
                if k not in ("traces", "leaf_rel", "leaf_norm_rel")})
        for key, what in (("leaf_norm_rel", "|card-cpu|/|cpu|"),
                          ("leaf_rel", "max|card-cpu|/max|cpu|")):
            print(f"  per-leaf {what}: " + " ".join(
                f"{k}={v:.3g}" for k, v in res[key].items()), flush=True)
    report({"step_check_phase_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()


def trainer_report(arch: str) -> dict:
    """Phases 5 and 7: ``train_phase`` on the card, reported. Returns the
    launches of the arch's kernels over the rounds."""
    print(f"federated QLoRA trainer, {arch} full width and depth:",
          flush=True)
    t0 = time.perf_counter()
    tres = train_phase(arch=arch)
    kernels = TRAIN_KERNELS[arch]
    report({"layers": tres["layers"], "init_s": tres["init_s"],
            "backbone_bytes": tres["backbone_bytes"],
            "layer_stack_bytes": tres["layer_stack_bytes"],
            "trainable_bytes": tres["trainable_bytes"],
            "max_memory_allocated": tres["max_memory_allocated"],
            "allocated_at_start": tres["allocated_at_start"],
            "phase_s": time.perf_counter() - t0})
    for r in tres["rounds"]:
        report(r)
    launches = {k: tres["launches"][k] for k in kernels}
    report({"launches_train": launches, "tc_launches": tres["tc_launches"],
            "local_steps": tres["steps"],
            "launches_per_step": {k: n / tres["steps"]
                                  for k, n in launches.items()},
            "traces": tres["traces"]})
    prof = tres["profile"]
    report({k: v for k, v in prof.items()
            if k not in ("top_ms", "regions_ms")})
    print("  step top device time (ms), each with its launching ops "
          "(op, region, ms):", flush=True)
    for n, ms, srcs in prof["top_ms"]:
        print(f"    {ms} {n}: {srcs}", flush=True)
    print(f"  step device time by region (ms): {prof['regions_ms']}",
          flush=True)
    del tres
    torch.cuda.empty_cache()
    return launches


def check_flash_round(gen) -> dict:
    """``flash_attention`` at the federated round's shapes (``FL_ATTENTION``:
    fp32, S = Skv = 1, 4 heads, no mask) against the plain version at
    1e-5, with times, bounds and every SDPA backend; then the op's
    gradient at the cohort's ViT-B/32 shape (160, 1, 4, 192) against
    autograd through the plain version. Returns the rows by (B, D)."""
    rows = {}
    for B, D in FL_ATTENTION:
        q, k, v = (torch.randn((B, 1, 4, D), generator=gen, device="cuda")
                   for _ in range(3))
        run = lambda: fa_kernel.flash_attention(q, k, v, causal=False)
        got, route = routed(fa_kernel.flash_attention, run)
        want = ref.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, want)
        if not (rel_e <= 1e-5 and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention round ({B},1,4,{D}): rel "
                                 f"err {rel_e} > 1e-5")
        b_ms, b_by = bound(nbytes(q, k, v, got), 4.0 * B * 4 * D,
                           torch.float32)
        row = {"case": f"round_{B}x1x4x{D}", "route": route,
               "max_abs_err": abs_e, "rel_err": rel_e, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        timed(row, "ms", run)
        timed(row, "plain_ms", lambda: ref.flash_attention(q, k, v,
                                                           causal=False))
        time_sdpa_backends(row, *(t.transpose(1, 2).contiguous()
                                  for t in (q, k, v)), False)
        report({"flash_attention": 1, **row})
        rows[(B, D)] = row

    B, D = 160, 192
    q, k, v, do = (torch.randn((B, 1, 4, D), generator=gen, device="cuda")
                   for _ in range(4))
    grads = []
    for fn in (ops.flash_attention, ref.flash_attention):
        ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*ts, causal=False) * do).sum().backward()
        grads.append([t.grad for t in ts])
    errs = [rel_err(g_, w_)[0] for g_, w_ in zip(*grads)]
    if not max(errs) <= 1e-5:
        raise AssertionError(f"flash_attention round backward: abs errs "
                             f"dq/dk/dv {errs}")
    brow = {"case": f"round_{B}x1x4x{D}_bwd", "abs_err_dq_dk_dv": max(errs)}
    brow["bound_ms"], brow["bound_by"] = bound(
        nbytes(q, k, v, do, q, k, v), 10.0 * B * 4 * D, torch.float32)
    timed(brow, "ms", lambda: ops.flash_attention_bwd(q, k, v, do,
                                                      causal=False))

    def plain_bwd():
        ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
        torch.autograd.grad(ref.flash_attention(*ts, causal=False), ts, do)
    timed(brow, "plain_ms", plain_bwd)
    report({"flash_attention_bwd (PyTorch ops)": 1, **brow})
    return rows


# -- phases 8 and 9: the paper's federated round -----------------------

def nf4_round_trip(frozen) -> tuple:
    """The QLoRA arm's backbone as ``run_federated`` sets it up: the
    vision tower NF4, block 64, then dequantized for the round. Returns
    (frozen, the NF4 tower's bytes)."""
    q = qlib.quantize_tree(frozen["vision"], bits=4, mode="nf4", block=64,
                           min_size=1024)
    return dict(frozen, vision=qlib.dequantize_tree(q)), qlib.tree_bytes(q)


@torch.no_grad()
def class_embedding(frozen, ccfg, device):
    spec = SPECS["pacs"]
    toks = torch.as_tensor(class_tokens(spec, np.arange(spec.n_classes)),
                           dtype=torch.long, device=device)
    return clip_lib.text_embedding(frozen, ccfg, toks)


def fl_clients(data, n_clients, alpha, seed, strat, repeat=1):
    """``run_federated``'s clients: a Dirichlet partition, empty shards
    dropped; each image repeated ``repeat`` times along both spatial
    axes (this script's way to 224 x 224 inputs from the 32 x 32 data)."""
    imgs = data["images"]
    if repeat > 1:
        imgs = np.repeat(np.repeat(imgs, repeat, axis=1), repeat, axis=2)
    parts = partition.dirichlet_partition(data["labels"], n_clients, alpha,
                                          seed=seed)
    clients = [client_lib.Client(
        cid=i, images=imgs[p], labels=data["labels"][p],
        n_classes=data["spec"].n_classes, strategy=strat)
        for i, p in enumerate(parts)]
    return [c for c in clients if c.n > 0]


def round_diffs(got_tree, want_tree, base_tree) -> dict:
    """Two rounds' trainables from the same start ``base_tree`` (trees on
    any devices), per leaf: the largest |got - want|, how many elements
    lie beyond ``ORACLE["leaf_atol"]``, and ||got - want|| over the norm
    of the round's own update of the leaf, which is held to
    ``UPDATE_REL`` (``GATED_REL`` for the two leaves behind the adapter's
    ReLU, ``RELU_GATED``). Adam's step is about ``lr`` whatever a
    gradient's size, so an element whose gradient sits within fp32
    rounding of zero in some step (behind the zero-init wo, w2 and LoRA
    b) can move by up to ``lr`` differently in two computations that
    round differently; and a pre-activation within rounding of zero
    takes the ReLU the other way in the other computation, moving its
    unit's column of w1 and entry of b1 for that token."""
    want = {tree_lib.path_str(p): l for p, l in
            tree_lib.flatten_with_path(want_tree)}
    base = {tree_lib.path_str(p): l for p, l in
            tree_lib.flatten_with_path(base_tree)}
    leaves = {}
    for p, g in tree_lib.flatten_with_path(got_tree):
        k = tree_lib.path_str(p)
        w = want[k].to(g.device).float()
        d = (g.float() - w).abs()
        step = (w - base[k].to(g.device).float()).norm().item()
        leaves[k] = (d.max().item(), int((d > ORACLE["leaf_atol"]).sum()),
                     d.norm().item() / step if step else d.norm().item())
    worst = max(leaves, key=lambda k: leaves[k][0])
    return {"worst_leaf": worst, "worst_leaf_abs": leaves[worst][0],
            "elements_beyond_atol": sum(v[1] for v in leaves.values()),
            "worst_update_rel": max(v[2] for v in leaves.values()),
            "leaf_abs_n_rel": {k: (float(f"{v[0]:.3g}"), v[1],
                                   float(f"{v[2]:.3g}"))
                               for k, v in leaves.items()},
            "ok": all(v[2] <= (GATED_REL if k in RELU_GATED else UPDATE_REL)
                      for k, v in leaves.items())}


def oracle_round(frozen, ccfg, class_emb, clients, global_tr, strat, key, *,
                 steps, batch, lr, device) -> dict:
    """One full-participation round through ``FullSyncScheduler`` on the
    stacked ``CohortEngine`` and on ``SequentialExec`` (every client's
    ``local_train``, then ``server.aggregate``), on the same batch
    indices; the leaves held as ``round_diffs`` holds them, losses and
    accuracies at ``ORACLE``'s tolerances, bytes equal."""
    engine = cohort_lib.CohortEngine(
        frozen=frozen, ccfg=ccfg, class_emb=class_emb, clients=clients,
        cfg=cohort_lib.CohortConfig(strategy=strat, local_steps=steps,
                                    batch_size=batch, lr=lr))
    trace = sched_lib.uniform_trace(len(clients))
    coh = sched_lib.FullSyncScheduler(
        executor=sched_lib.CohortExec(engine), trace=trace, local_steps=steps)
    seq = sched_lib.FullSyncScheduler(
        executor=sched_lib.SequentialExec(
            clients=clients, frozen=frozen, ccfg=ccfg, class_emb=class_emb,
            local_steps=steps, batch_size=batch, lr=lr),
        trace=trace, local_steps=steps)
    _sync(device)
    t0 = time.perf_counter()
    tr_c, m_c = coh.step(global_tr, 0, key)
    _sync(device)
    cohort_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr_s, m_s = seq.step(global_tr, 0, key)
    _sync(device)
    seq_s = time.perf_counter() - t0
    loss_c, acc_c = m_c["loss"].cpu().numpy(), m_c["acc"].cpu().numpy()
    diffs = round_diffs(tr_c, tr_s, global_tr)
    res = {"clients": len(clients), "pool": int(engine.pool_staged.shape[1]),
           "cohort_round_s": cohort_s, "sequential_round_s": seq_s,
           **diffs,
           "loss_abs": float(np.abs(loss_c - m_s["loss"]).max()),
           "acc_abs": float(np.abs(acc_c - m_s["acc"]).max()),
           "uplink_bytes": m_c["uplink_bytes"],
           "per_client_uplink_bytes":
               engine.per_client_uplink_bytes(global_tr),
           "mean_loss": float(loss_c.mean())}
    if not (res.pop("ok") and np.allclose(
            loss_c, m_s["loss"], atol=ORACLE["loss_atol"],
            rtol=ORACLE["loss_rtol"]) and res["acc_abs"] <= ORACLE["acc_atol"]
            and m_c["uplink_bytes"] == m_s["uplink_bytes"] ==
            engine.uplink_bytes(global_tr) and np.isfinite(loss_c).all()):
        raise AssertionError(f"cohort round vs sequential oracle: {res}")
    res.update(engine=engine, tr=tr_c)
    return res


def like_run(cfg, device, streams) -> tuple:
    """The frozen backbone, class embeddings, clients and global
    trainables that ``run_federated(cfg, device, streams)`` trains (its
    pretrained CLIP is the cached one)."""
    strat = STRATEGIES[cfg.strategy]
    ccfg = clip_lib.CLIPConfig()
    data = make_dataset(cfg.dataset, n_per_class=cfg.n_per_class,
                        seed=cfg.seed, longtail_gamma=cfg.longtail_gamma)
    clients = fl_clients(data, cfg.n_clients, cfg.alpha, cfg.seed, strat)
    frozen = sim_lib.pretrained_clip(cfg.dataset, ccfg, seed=1234,
                                     init=streams.clip_init, device=device)
    if strat.backbone_bits:
        frozen = nf4_round_trip(frozen)[0]
    return (frozen, ccfg, class_embedding(frozen, ccfg, device), clients,
            convert.tree_from_numpy(streams.trainable_init, device), strat)


def fl_round_phase(device="cuda", rounds=3, **settings) -> dict:
    """Phase 8: ``run_federated`` through its entry point, both arms, at
    the paper preset's per-round settings (``FL_PAPER``, overridable for
    a rehearsal) and the JAX package's ``CLIPConfig()``: ``rounds`` cohort
    rounds, pipelined. Launch counts are zeroed just before each run and
    read right after it. Every History value must be finite and every
    round's uplink ``n_clients x per_client_uplink_bytes``; then one
    round of ``engine="sequential"`` on the same streams against the
    cohort run's first round, and the first round's trainables through
    ``oracle_round``, at the oracle tolerances."""
    on_card = torch.device(device).type == "cuda"
    st = {**FL_PAPER, **settings}
    out = {}
    for arm in FL_ARMS:
        cfg = sim_lib.FLConfig(strategy=arm, rounds=rounds, engine="cohort",
                               pipeline="pipelined", **st)
        streams = sim_lib.seeded_streams(cfg)
        ops.reset_kernel_traces()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        h = sim_lib.run_federated(cfg, device=device, streams=streams)
        _sync(device)
        run_s = time.perf_counter() - t0
        launches, traces = ops.launch_counts(), dict(ops.KERNEL_TRACES)
        hs = sim_lib.run_federated(
            dataclasses.replace(cfg, rounds=1, engine="sequential"),
            device=device, streams=streams)
        fz, ccfg, ce, clients, g0, strat = like_run(cfg, device, streams)
        orc = oracle_round(fz, ccfg, ce, clients, g0, strat,
                           cohort_lib.RoundKey(streams.batch_indices, 0),
                           steps=cfg.local_steps, batch=cfg.batch_size,
                           lr=cfg.lr, device=device)
        per_client = orc["per_client_uplink_bytes"]
        vals = [h.server_acc, h.tail_acc, h.server_loss, h.client_loss,
                h.client_acc]
        if not all(np.isfinite(np.asarray(v, np.float64)).all()
                   for v in vals) or len(h.server_acc) != rounds:
            raise AssertionError(f"{arm}: bad History {h}")
        n_act = h.meta["n_clients_active"]
        if h.uplink_bytes != [n_act * per_client] * rounds:
            raise AssertionError(f"{arm}: uplink {h.uplink_bytes} != "
                                 f"{n_act} x {per_client}")
        seq_vs = {
            "client_loss_abs": float(np.abs(np.subtract(
                h.client_loss[0], hs.client_loss[0])).max()),
            "client_acc_abs": float(np.abs(np.subtract(
                h.client_acc[0], hs.client_acc[0])).max()),
            "server_loss_abs": abs(h.server_loss[0] - hs.server_loss[0]),
            "server_acc_abs": abs(h.server_acc[0] - hs.server_acc[0])}
        if not (np.allclose(h.client_loss[0], hs.client_loss[0],
                            atol=ORACLE["loss_atol"],
                            rtol=ORACLE["loss_rtol"])
                and np.allclose(h.server_loss[0], hs.server_loss[0],
                                atol=ORACLE["loss_atol"],
                                rtol=ORACLE["loss_rtol"])
                and seq_vs["client_acc_abs"] <= ORACLE["acc_atol"]
                and hs.uplink_bytes[0] == h.uplink_bytes[0]):
            raise AssertionError(f"{arm}: sequential round vs cohort: "
                                 f"{seq_vs}")
        if on_card:
            want = rounds * cfg.local_steps
            if traces.get("flash_attention_cuda", 0) < want or \
                    launches["flash_attention"] < want or \
                    "flash_attention_ref" in traces:
                raise AssertionError(
                    f"{arm}: flash_attention launches {launches} traces "
                    f"{traces} (want >= {want} kernel launches, no plain "
                    "route)")
        orc.pop("engine"), orc.pop("tr")
        out[arm] = {"history": h, "meta": h.meta, "run_s": run_s,
                    "launches": launches, "traces": traces,
                    "sequential_vs_cohort": seq_vs, "oracle": orc}
    return out


def vit_round_phase(device="cuda", ccfg=VIT_B32, *, steps=10, batch=32,
                    n_clients=5, n_per_class=60, seed=0, cut_layers=2,
                    profile=True) -> dict:
    """Phase 9: one full-participation round at ``ccfg``'s width (CLIP
    ViT-B/32), seeded weights, both arms, through ``CohortEngine``,
    ``FullSyncScheduler`` and ``SequentialExec`` (``oracle_round``).
    The data: 5 clients of a Dirichlet(0.5) partition of
    ``make_dataset("pacs", n_per_class=60)``, each 32 x 32 image
    repeated along both spatial axes to the config's image size. Launch
    counts are zeroed before the arms and read after them; on the card
    each arm's cohort round is then profiled, and a ``cut_layers``-
    vision-layer cut of the same round runs on the card (kernel) and on
    the CPU (plain path) on the same weights and indices."""
    on_card = torch.device(device).type == "cuda"
    data = make_dataset("pacs", n_per_class=n_per_class, seed=seed)
    repeat = ccfg.image_size // data["images"].shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    frozen0 = clip_lib.init_clip(gen, ccfg, device=device)
    key = cohort_lib.RoundKey(cohort_lib.seeded_index_stream(seed), 0)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    arms = {}
    for arm in FL_ARMS:
        strat = STRATEGIES[arm]
        frozen = nf4_round_trip(frozen0)[0] if strat.backbone_bits \
            else frozen0
        ce = class_embedding(frozen, ccfg, device)
        clients = fl_clients(data, n_clients, 0.5, seed, strat, repeat)
        g0 = client_lib.init_trainable(gen, ccfg, strat, device=device)
        orc = oracle_round(frozen, ccfg, ce, clients, g0, strat, key,
                           steps=steps, batch=batch, lr=3e-3, device=device)
        arms[arm] = dict(orc, frozen=frozen, class_emb=ce,
                         client_list=clients, global_tr=g0, strat=strat)
    launches, traces = ops.launch_counts(), dict(ops.KERNEL_TRACES)
    res = {"launches": launches, "traces": traces, "arms": {},
           "max_memory_allocated": torch.cuda.max_memory_allocated()
           if on_card else None}
    if on_card and (launches["flash_attention"] < 2 * steps or
                    traces.get("flash_attention_cuda", 0) < 2 * steps or
                    "flash_attention_ref" in traces):
        raise AssertionError(f"ViT-B/32 round: flash_attention launches "
                             f"{launches} traces {traces}")
    for arm, a in arms.items():
        row = {k: v for k, v in a.items() if k not in (
            "engine", "tr", "frozen", "class_emb", "client_list",
            "global_tr", "strat")}
        if on_card and profile:
            row["profile"] = profile_run(
                lambda: a["engine"].run_round(a["global_tr"], key),
                ("flash_attention",))
        row["cut"] = cut_check(a, ccfg, cut_layers, gen, key, steps=steps,
                               batch=batch, device=device)
        res["arms"][arm] = row
    return res


def cut_check(a, ccfg, layers, gen, key, *, steps, batch, device) -> dict:
    """The round of ``a`` with the vision tower cut to ``layers`` blocks,
    on ``device`` and on the CPU on the same weights and batch indices:
    leaves as ``round_diffs`` holds them, losses at the oracle's loss
    tolerance, each client's accuracy within one of its ``batch``
    samples."""
    ccfg2 = dataclasses.replace(ccfg, vision_layers=layers)
    fz = a["frozen"]
    fz2 = dict(fz, vision=dict(fz["vision"], blocks={
        k: v[:layers] for k, v in fz["vision"]["blocks"].items()}))
    g2 = client_lib.init_trainable(gen, ccfg2, a["strat"], device=device)
    outs = {}
    for dev in (device, "cpu"):
        fzd, ced, gd = (convert.tree_to(t, dev)
                        for t in (fz2, a["class_emb"], g2))
        eng = cohort_lib.CohortEngine(
            frozen=fzd, ccfg=ccfg2, class_emb=ced, clients=a["client_list"],
            cfg=cohort_lib.CohortConfig(strategy=a["strat"],
                                        local_steps=steps, batch_size=batch,
                                        lr=3e-3))
        t0 = time.perf_counter()
        tr, m = eng.run_round(gd, key)
        _sync(dev)
        outs[dev] = (tr, m["loss"].cpu().numpy(), m["acc"].cpu().numpy(),
                     time.perf_counter() - t0)
    (tr_d, l_d, a_d, s_d), (tr_h, l_h, a_h, s_h) = outs[device], outs["cpu"]
    res = {"layers": layers, **round_diffs(tr_d, tr_h, g2),
           "loss_abs": float(np.abs(l_d - l_h).max()),
           "acc_abs": float(np.abs(a_d - a_h).max()),
           "device_round_s": s_d, "cpu_round_s": s_h}
    if not (res.pop("ok") and np.allclose(
            l_d, l_h, atol=ORACLE["loss_atol"], rtol=ORACLE["loss_rtol"])
            and res["acc_abs"] <= 1.0 / batch + 1e-6):
        raise AssertionError(f"{layers}-layer round, card vs CPU: {res}")
    return res


def fl_round_report() -> int:
    """Phase 8 on the card, reported. Returns its flash_attention
    launches."""
    print("federated round (run_federated), CLIPConfig(), paper preset's "
          "round settings, 3 cohort rounds pipelined:", flush=True)
    t0 = time.perf_counter()
    res = fl_round_phase()
    n = 0
    for arm, r in res.items():
        h, m = r["history"], r["meta"]
        for i in range(len(h.rounds)):
            report({"arm": arm, "round": h.rounds[i],
                    "server_acc": h.server_acc[i], "tail_acc": h.tail_acc[i],
                    "server_loss": h.server_loss[i],
                    "mean_client_loss": float(np.mean(h.client_loss[i])),
                    "uplink_bytes": h.uplink_bytes[i],
                    "round_time_s": h.round_time_s[i]})
        report({"arm": arm, "run_s": r["run_s"],
                **{k: m[k] for k in (
                    "n_clients_active", "backbone_bytes", "footprint_bytes",
                    "util_proxy_const", "trainable_params", "frozen_params",
                    "n_compiles", "n_compiles_by_kind", "compile_time_s",
                    "sync_counts", "loop_wall_s")}})
        report({"arm": arm, "launches": r["launches"],
                "traces": r["traces"]})
        report({"arm": arm, "sequential_round_vs_cohort":
                r["sequential_vs_cohort"]})
        report({"arm": arm, "oracle": r["oracle"]})
        n += r["launches"]["flash_attention"]
    report({"fl_round_phase_s": time.perf_counter() - t0})
    return n


def vit_round_report() -> int:
    """Phase 9 on the card, reported. Returns its flash_attention
    launches."""
    print("federated round at CLIP ViT-B/32 width (seeded weights), "
          "cohort vs sequential, then a 2-layer cut card vs CPU:",
          flush=True)
    t0 = time.perf_counter()
    res = vit_round_phase()
    report({"launches": res["launches"], "traces": res["traces"],
            "max_memory_allocated": res["max_memory_allocated"]})
    for arm, r in res["arms"].items():
        prof = r.pop("profile", None)
        cut = r.pop("cut")
        report({"arm": arm, **r})
        report({"arm": arm, "cut": cut})
        if prof is not None:
            report({"arm": arm, **{k: v for k, v in prof.items()
                                   if k not in ("top_ms", "regions_ms")}})
            print(f"  {arm} round top device time (ms), each with its "
                  "launching ops (op, region, ms):", flush=True)
            for name, ms, srcs in prof["top_ms"]:
                print(f"    {ms} {name}: {srcs}", flush=True)
            print(f"  {arm} round device time by region (ms): "
                  f"{prof['regions_ms']}", flush=True)
    report({"vit_round_phase_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    return res["launches"]["flash_attention"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    setup()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    print("kernels vs plain versions:", flush=True)
    main_rows = {"quant_matmul": check_quant_matmul(gen),
                 "blockwise_quant": check_blockwise_quant(gen)}
    check_flash_attention(gen)      # the serve shapes
    main_rows["flash_attention"] = check_flash_train(gen)
    check_flash_round(gen)          # the federated round's shapes
    main_rows["lora_matmul"], main_rows["quant_matmul_t"] = \
        check_lora_kernels(gen)
    qmt_split_sweep(gen)
    main_rows["selective_scan"], main_rows["selective_scan_bwd"] = \
        check_selective_scan(gen)

    print("serve plane at CLIP ViT-B/32 width:", flush=True)
    t0 = time.perf_counter()
    res = serve_phase("cuda", VIT_B32)
    rec = res["rec"]
    launches = res["launches"]
    report({"requests": rec["n_requests"], "flights": rec["n_flights"],
            "buckets": sorted({f["bucket"] for f in rec["flights"]}),
            "throughput_wall": rec["throughput_wall"],
            "lat_v_p50": rec["lat_v_p50"], "lat_v_p99": rec["lat_v_p99"],
            "hits": rec["store"]["hits"], "misses": rec["store"]["misses"],
            "evictions": rec["store"]["evictions"],
            "bytes_at_rest": res["bytes_at_rest"],
            "oracle_s": res["oracle_s"]})
    report({"err_int8": res["err_int8"],
            "err_int4_vs_dequant": res["err_int4_vs_dequant"],
            "err_int4_vs_fp32": res["err_int4_vs_fp32"],
            "err_fp32": res["err_fp32"],
            "phase_s": time.perf_counter() - t0})
    prof = res["profile"]
    report({"replay2_wall_s": prof["wall_s"],
            "replay2_device_busy_s": prof["device_busy_s"],
            "replay2_idle_share": prof["idle_share"],
            "replay2_flights": prof["flights"]})
    print(f"  replay2 top device time (us): {prof['top_us']}", flush=True)
    report({"launches_replay": res["after_replay"],
            "launches_replay_and_oracle": launches})
    for name in ("quant_matmul", "blockwise_quant"):
        if res["after_replay"][name] < 1:
            raise AssertionError(f"the replay launched no {name} kernel")
    qmm_calls = res["qmm_calls"]
    print("  replay quant_matmul launches by (users T, rows M, route, plan "
          "CTAs): " + " ".join(f"{k}={n}" for k, n in sorted(qmm_calls.items())),
          flush=True)
    if sum(qmm_calls.values()) != res["after_replay"]["quant_matmul"]:
        raise AssertionError("the replay's quant_matmul calls and launches "
                             "disagree")
    for (T, M, route, ctas), n in qmm_calls.items():
        if route != "gemv" or ctas < qmm_kernel.SMS:
            raise AssertionError(f"{n} replay quant_matmul launches at T={T} "
                                 f"took the {route} route with {ctas} CTAs")
    for name in SERVE_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the serve path launched no {name} kernel")
    serve_launches = launches
    del res
    torch.cuda.empty_cache()

    step_check_report("yi-9b")
    yi_launches = trainer_report("yi-9b")
    step_check_report("falcon-mamba-7b")
    mamba_launches = trainer_report("falcon-mamba-7b")
    fl_launches = fl_round_report()
    vit_launches = vit_round_report()

    print(card_line(), flush=True)
    # flash_attention runs on every path: its launches over all of them
    flash = {"serve": serve_launches["flash_attention"],
             "yi-9b": yi_launches["flash_attention"],
             "falcon-mamba-7b": mamba_launches["flash_attention"],
             "fl_round": fl_launches, "vit_round": vit_launches}
    print(f"flash_attention launches by path: {flash}", flush=True)
    launches = {**serve_launches, **yi_launches,
                "flash_attention": sum(flash.values()),
                "selective_scan": mamba_launches["selective_scan"],
                "selective_scan_bwd": mamba_launches["selective_scan_bwd"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for name, row in main_rows.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
