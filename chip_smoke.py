#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA H100: the serving
plane, the federated QLoRA trainer on Yi-9B and on Falcon-Mamba-7B, the
paper's federated CLIP round (``run_federated``), its GAN included, the
trainer-to-store handoff that feeds the serving plane, token serving
(prefill and decode) on the two trainers' models, the zoo's other
families (RecurrentGemma-2B, Qwen3-MoE, Whisper-medium, LLaVA-NeXT-34B)
through training, prefill and decode, and the mesh runtime's explicit
bodies (Kimi-K2 at full width through the expert-parallel body).

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
 4. one ``train_step``'s gradients at full Yi-9B width with 1 layer
    (NF4 backbone, seeded weights, 4 x 64 tokens) on the card with the
    kernels and on the CPU with the plain versions, on the same weights;
 5. the federated QLoRA trainer (``repro_torch.launch.train``) on Yi-9B
    at full width and depth: NF4 block 64, int8 uplink, 2 rounds x 2
    clients x 2 local steps of 4 x 64 tokens, through ``client_update``
    and ``aggregate``; launch counts zeroed just before and read right
    after; then one step under the profiler;
 6. phase 4 at full Falcon-Mamba-7B width with 1 layer;
 7. phase 5 on Falcon-Mamba-7B at full width and depth (64 Mamba
    layers, every scan through the ``selective_scan`` kernel and its
    gradient through ``selective_scan_bwd``), with the peak device
    memory; the profiled step's top device entries name the ATen op
    and the region (``record_function`` range or backward node) that
    launched them;
 8. first the ``tripleplay`` arm's GAN alone (``GANConfig()``, the
    clients below): the fleet engine against the sequential
    ``Client.prepare_gan`` loop and the card against the CPU at 3 GAN
    steps (labels bitwise, generator leaves within 2e-3, images within
    5e-3), the fleet at 150 steps (every needed row delivered, finite
    losses; wall time, then profiled: device busy, idle share, ATen
    ops), and the GAN's convolutions through cuDNN against the gemm
    forms with TF32 off; then ``repro_torch.fl.simulator.run_federated``
    through its entry point at the JAX package's ``CLIPConfig()`` and
    the paper preset's round settings (pacs, 5 clients, 5 local steps
    (cut from 10), batch 32, 60 samples a class, lr 3e-3, 150 GAN
    steps): 2 cohort rounds, pipelined, for ``fedclip``, ``qlora_nogan`` and
    ``tripleplay`` (fleet GAN), each run's launch counts zeroed just
    before it and read right after; its History printed and checked
    (finite, uplink bytes 5 x the per-client payload, the GAN meta), then
    one sequential round on the same streams and the first round's
    trainables, cohort against the sequential oracle, at
    ``tests/test_fl.py``'s tolerances; for tripleplay also 2 rounds of
    the sequential engine after the sequential GAN engine;
 9. one full-participation round at CLIP ViT-B/32 width (seeded
    weights; the pacs images repeated 7 x along each spatial axis to
    224 x 224; tripleplay's fleet GAN trained on the 32 x 32 pools and
    its rows repeated likewise, 30 GAN steps), 5 local steps of 32 (cut
    from 10), the three arms through
    ``CohortEngine``, ``FullSyncScheduler`` and ``SequentialExec``,
    cohort against sequential; launch counts zeroed before the arms and
    read after them; each cohort round profiled, with the peak device
    memory; then a 2-vision-layer cut of the round, 3 local steps deep,
    on the card against the CPU on the same weights;
10. the scheduler layer (``fl.sched``: partial and async participation,
    availability traces, chaos fault injection) through
    ``run_federated``: (a) Fig. 7's sweep (``benchmarks/fig7_scalability.py``)
    at ``CLIPConfig()``: tripleplay (fleet GAN, 30 steps), 10 clients of
    48 a class, skewed trace, K in {2, 5} under sync-partial and async,
    2 commits each, cohort engine, pipelined, each run twice (the draws'
    columns must repeat), every History checked (finite, participation
    K wide, staleness 0 / >= 0, virtual time non-decreasing, uplink K x
    the per-client payload); one commit of each policy cohort against
    the sequential clients, and sync-partial at K = N = 10 on a uniform
    trace bitwise the full round; (b) the reference's fault study
    (``benchmarks/fl_round_bench.py``: fedclip, 8 clients of 24 a class,
    diurnal trace, dropout 0.25, stragglers 0.5, uplink loss 0.1, K = 3,
    6 rounds, both policies), then tripleplay under ``"heavy"`` (fleet
    GAN, 30 steps): each run
    twice and on the sequential engine, the same participation, virtual
    time, bytes and fault ledger (non-empty; GAN drops for tripleplay);
    (c) ``qlora_nogan`` at ViT-B/32 width on phase 9's clients, 5 local
    steps: a sync-partial round at K = 3 (bucket 4, one pad row) and an async
    commit (buffer 2, concurrency 4), cohort against sequential, then
    each profiled with the peak device memory. Launch counts are zeroed
    before each run of (a) and (b) and before (c), and read right after;
11. the trainer-to-store handoff: (a) ``demo_plane(8, max_entries=6)``
    at ``CLIPConfig()``, then ``run_federated`` (fedclip, sync-partial
    K = 2, the paper preset's round settings, 3 rounds) pipelined and
    barrier with a store over the plane's users (six resident, int8)
    and without: the Histories equal, 16 refreshes, the refreshed rows
    bitwise a cold store's fetch, both modes' backings bitwise equal; a
    Zipf trace of 48 requests replayed against the refreshed store and
    held to ``serve_sequential`` at the int8 bound (5e-2); (b) at CLIP
    ViT-B/32 width on phase 9's clients, the backing from
    ``personalized_trainables`` of a ``qlora_nogan`` wave (5 local
    steps), a store of 4
    (evictions), ``refresh_from_global`` before and after one
    ``FullSyncScheduler`` round (timed; its ``blockwise_quant``
    launches), a replay held to the oracle (its ``quant_matmul``
    launches; no plain route in either), the refresh again and the
    replay profiled; (c) ``repro_torch.launch.serve.main(["--adapters",
    "8", "--requests", "48"])``; (d) the synchronizing calls inside the
    round loop of a fault-free sync-partial run, by site, beside
    ``SYNC_TRACES`` (``scripts/torch_loop_syncs.py``): none outside a
    counted wait. Launch counts are zeroed before each run and replay.
12. token serving and the train-side pieces: (a) ``repro_torch.launch.
    serve.main`` in its token mode on Yi-9B at full width and depth, NF4
    (4 streams, prompt 64, 16 tokens): every projection of the prefill
    and of each decode step through ``lora_matmul``'s tensor-core kernel,
    the prefill's attention through ``flash_attention``'s, no plain
    route; prefill ms, decode ms a token and tokens a second; one decode
    step profiled beside its bound (the bytes it must read), with
    ``decode_attention``'s device ms; the decode loop run again under
    ``set_sync_debug_mode("warn")``: no synchronizing call inside it;
    (b) the same on Falcon-Mamba-7B (the prefill's 64 scans through
    ``selective_scan``; a decode step's device time by region,
    ``mamba.dequantize`` against the rest); (c) prefill of 4 x 64 and 8
    decode steps on the card against the CPU on the same weights and
    tokens: a 1-layer full-width Yi-9B and Falcon-Mamba (bf16, within
    2e-2), and the reduced h2o-danube with an int8 KV cache, 32 steps,
    its window of 64 wrapping (the prefill within 1e-4, the steps within
    the JAX package's int8-KV bound, 5e-2); (d) the trainer's
    ``--ckpt`` at its reduced config, 2 rounds then a resume to 3,
    bitwise 3 straight rounds, and a ``grad_accum=4`` step against one
    shot. Launch counts are zeroed before each run and read after.
13. the zoo's hybrid, MoE, encdec and VLM families, NF4, seeded
    weights: (a) RecurrentGemma-2B at full width and depth through
    ``launch/serve.py``'s token mode (4 streams, prompt 64, 16 tokens),
    a decode step profiled, then the trainer's rounds (1 x 2 clients x 2
    local steps of 4 x 64 tokens) on the same weights, a step profiled
    (``rglru.scan`` is ``chunked_linear_scan``'s region); (b) the same on
    Qwen3-MoE-235B-A22B at full width, 4 of its 94 layers, with the share
    of token-copies dropped at capacity factor 1.25 (regions
    ``moe.dequantize`` and ``moe.experts``); (c) Whisper-medium's token
    mode and 2 ``Model.train_step``s on frames (4, 1500, 1024); (d)
    LLaVA-NeXT-34B's (30 of its 60 layers) with 576 image patches before 64
    tokens, the adapter's attention at D = 896; (e) bf16 full-width cuts
    of (a) (3 layers), (c) (2 + 2 layers, 250 frames) and (d) (1 layer,
    8 patches, 2 sequences) card against CPU (logits, loss and the gradients' norm
    within 2e-2; each gradient leaf and each trainable after one Adam
    step within 2e-2 of an fp32 CPU witness on the same weights, or
    within twice the CPU's bf16 distance to it), and the reduced fp32
    configs of all five archs (forward, gradients, an Adam step, prefill
    and 4 decode steps within 1e-4; the MoEs' expert ids and kept slots
    equal). Phase 2 (f) holds ``flash_attention`` at the zoo's shapes
    (the D = 896 adapter in both dtypes, Whisper's cross-attention to
    1500 frames and its encoder, RecurrentGemma's MQA under its window),
    and (g) ``quant_matmul`` and its dx (``quant_matmul_t``) at the
    projections phase 13 runs without LoRA (RecurrentGemma's MLP at 256
    and 4 rows, Whisper's encoder MLP at 6000, Kimi-K2's reduced dense
    layer in fp32). Launch counts are zeroed before each run and read
    after.
14. the mesh and the expert-parallel runtime (``models/runtime.py``,
    ``launch/mesh.py``): (a) the NCCL world of one rank, its ``(pod=1,
    data=1, model=1)`` Runtime and each collective on the world group;
    (b) Kimi-K2 at full width (1 dense + 2 MoE layers) through
    ``launch/serve.py``'s token mode under the Runtime (4 streams, prompt
    64, 8 tokens: the expert-parallel body's per-expert loop, every
    expert product through ``quant_matmul``), a decode step profiled by
    region (``moe.dispatch``, ``moe.experts``, ``moe.combine``) beside
    its bound, one ``train_step`` on 4 x 64 tokens with its peak memory,
    and one Falcon-Mamba-7B block through its channel-parallel body
    against the local path; (c) inside phase 13, Qwen3-MoE's 4 layers
    under the Runtime and without it (routes equal, logits, loss and
    gradients within phase 13's bf16 bounds; the same with the int8
    dispatch); (d) ``run_federated(mesh=)`` (``qlora_nogan``, 1 round)
    and a ViT-B/32-width cohort round with ``CohortConfig(mesh=)``
    against the unsharded engine; (e) the fleet GAN with
    ``FleetGANConfig(mesh=)``, 3 steps, bitwise the unsharded fleet;
    (f) each kernel the bodies launched at the rank bodies' shapes
    against its plain version.
15. the dry run and the autotuner: (a) ``cfg.calibrate`` with
    ``unroll_layers`` at full width against the same config without, on
    the same weights: Yi-9B NF4 at 1 and 2 layers on a 4 x 64 step
    (bf16, phase 13's bounds), Falcon-Mamba-7B (the single-chunk scan
    against the ``selective_scan`` kernels) and RecurrentGemma-2B (one
    chunk of 512 against two of 256), fp32 within the JAX package's
    chunked-vs-plain scan bound (1e-4), and inside phase 13 its
    Qwen3-MoE under the Runtime of one in fp32, the batched expert
    product against the per-expert loop (routes equal); launches of each
    side; (b) ``launch/dryrun.py``'s account of phase 5's profiled Yi-9B
    step, traced here on fake tensors: its ``argument_bytes`` equal to
    the step's resident parameter, Adam and batch bytes, its peak beside
    ``max_memory_allocated``, its FLOPs over the step's busy seconds as a
    share of 989 TFLOP/s; (c) the production dry run's CLI (``yi-9b``
    ``train_4k`` on the 16 x 16 fake world, ``--fed-agg`` on 2 x 16 x 16)
    in processes of their own, beside (a)-(b); (d) ``kernels/autotune``'s
    sweep of ``lora_matmul``'s split count at Yi-9B's four decode shapes,
    each count's ms beside ``plan``'s pick, a second sweep a pure hit,
    and the winner through the op within the bf16 bound. The autotune
    cache is a fresh file of the run's own (``REPRO_TORCH_AUTOTUNE_
    CACHE``), so no phase reads a stale winner.
    The GAN phase (before phase 8) also runs the six convolutions
    through the int8 gemms against the fp32 gemm forms, timed, with the
    block products bitwise an int64 product on the CPU, and the int8
    fleet GAN at 3 steps card against CPU.
Phase 2 also holds ``selective_scan`` and its backward kernel
``selective_scan_bwd`` at the trainer's shape and at edge shapes (the
backward against the plain ``ops.selective_scan_bwd``, bitwise equal
across two calls), and the op's gradient (both kernels) against autograd
through the plain scan; phase 7 must show 128 forward and 64 backward
scan kernels per local step; phase 2 also holds ``lora_matmul`` at
the decode step's shapes (M = 4 rows, the four Yi-9B (K, N) pairs, NF4,
bf16). bf16 calls of ``flash_attention``,
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
phases 8, 9 and 10 require at least a launch a local step and no plain
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
import functools
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import clip as clip_lib  # noqa: E402
from repro_torch.core import gan as gan_lib  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.core import optim  # noqa: E402
from repro_torch.core import quant as qlib  # noqa: E402
from repro_torch.data.synthetic import (SPECS, class_tokens,  # noqa: E402
                                        make_dataset)
from repro_torch.fl import client as client_lib  # noqa: E402
from repro_torch.fl import cohort as cohort_lib  # noqa: E402
from repro_torch.fl import fleetgan, partition  # noqa: E402
from repro_torch.fl import sched as sched_lib  # noqa: E402
from repro_torch.fl import serve as serve_lib  # noqa: E402
from repro_torch.fl import simulator as sim_lib  # noqa: E402
from repro_torch.fl.strategies import (GAN_MIN_POOL,  # noqa: E402
                                       GAN_RNG_OFFSET, STRATEGIES)
from repro_torch.kernels import gan_conv  # noqa: E402
from repro_torch.kernels import autotune, build, ops, ref  # noqa: E402
from repro_torch.kernels import blockwise_quant as bq_kernel  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import lora_matmul as lm_kernel  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm_kernel  # noqa: E402
from repro_torch.kernels import selective_scan as ss_kernel  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
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
    # quant_matmul's tensor-core route (bf16 x past 4 rows), qmm_tc_kernel
    "quant_matmul_tc": "src/repro/kernels/quant_matmul.py:66",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}
SOURCES["quant_matmul_t"] = SOURCES["lora_matmul"]
SOURCES["quant_matmul_tc"] = SOURCES["quant_matmul"]
SOURCES["selective_scan_bwd"] = SOURCES["selective_scan"]
SERVE_KERNELS = ("quant_matmul", "blockwise_quant", "flash_attention")
# the kernels each trainer's main path launches
TRAIN_KERNELS = {"yi-9b": ("lora_matmul", "quant_matmul_t", "flash_attention"),
                 "falcon-mamba-7b": ("selective_scan", "selective_scan_bwd",
                                     "flash_attention"),
                 # the hybrid's MLP has no LoRA: quant_matmul forward,
                 # quant_matmul_t for its input's gradient
                 "recurrentgemma-2b": ("lora_matmul", "quant_matmul_t",
                                       "flash_attention", "quant_matmul"),
                 "qwen3-moe-235b-a22b": ("lora_matmul", "quant_matmul_t",
                                         "flash_attention")}
# the scan's trainer shape at Falcon-Mamba-7B width: (B, S, d_inner, N)
MAMBA_SCAN = (4, 64, 8192, 16)
# LoRA linears of a dense block (wq, wk, wv, wo, wg, wu, wd): one
# quant_matmul_t launch each per local step
DENSE_LORA_LINEARS = 7


def qmt_per_step(cfg) -> int:
    """``quant_matmul_t`` launches a local step: one for every frozen
    quantized projection that a gradient passes, i.e. every LoRA linear
    (``lora_matmul``'s backward) and every projection without LoRA
    behind one (``ops.quant_matmul``'s): a dense or VLM block's LoRA
    linears (7 with SwiGLU); an encdec decoder layer's 10 and an encoder
    layer's 4 plus its MLP; a hybrid attention layer's 4 plus every
    hybrid layer's MLP (the RG-LRU block's own projections are plain
    products of decoded weights); a MoE layer's attention 4, plus 3 for
    a shared expert and a first dense layer's MLP."""
    from repro_torch.models.model import _lora_targets
    L = cfg.n_layers
    mlp = 3 if cfg.mlp == "swiglu" else 2
    if cfg.family in ("dense", "vlm", "encdec"):
        enc = (4 + mlp) * cfg.encoder_layers
        return len(_lora_targets(cfg)) * L + enc
    if cfg.family == "hybrid":
        return 4 * cfg.layer_kinds().count("attn") + mlp * L
    if cfg.family == "moe":
        shared = (L - cfg.first_k_dense) if cfg.n_shared_experts else 0
        return 4 * L + 3 * (cfg.first_k_dense + shared)
    raise ValueError(cfg.family)


# the federated round's attention: the adapter's Att(D) at S = Skv = 1,
# 4 heads, fp32, no mask, as (B, D): D = d_model / 4 (16 at the JAX
# package's CLIPConfig(), 192 at ViT-B/32), B = one client's batch (32,
# the sequential oracle), the cohort's 5 x 32 (160) or the eval batch
FL_ATTENTION = [(32, 16), (160, 16), (128, 16), (32, 192), (160, 192),
                (128, 192)]
# the per-round settings of the paper preset (benchmarks/fl_common.py,
# PRESET["paper"] and fl_config; batch 32 is FLConfig's default), the
# local steps cut from 10 to 5 for the script's time
FL_PAPER = dict(dataset="pacs", n_clients=5, local_steps=5, batch_size=32,
                n_per_class=60, lr=3e-3)
FL_ARMS = ("fedclip", "qlora_nogan", "tripleplay")
# the tripleplay arm's GAN held to its sequential oracle and the card to
# the CPU: tests/test_fleetgan.py's bounds on the generator's leaves and
# the synthesized images, at GAN_CHECK_STEPS
GAN_BOUNDS = dict(gen_atol=2e-3, img_atol=5e-3)
# the int8 GAN's images, card against CPU: the JAX package's int8 bound
# (tests/test_kernels.py holds each int8 conv within 3e-2 of the fp32
# one's largest value; images lie in [-1, 1]), see gan_int8_phase
INT8_GAN_IMG_ATOL = 3e-2
GAN_CHECK_STEPS = 3
# the GAN's six convolutions at GANConfig() and its minibatch of 64:
# (op, batch, input side, ci, co), discriminator then generator
GAN_CONVS = [("conv", 64, 32, 3, 32), ("conv", 64, 16, 32, 64),
             ("conv", 64, 8, 64, 128), ("convT", 64, 4, 64, 32),
             ("convT", 64, 8, 32, 32), ("convT", 64, 16, 32, 3)]
# cohort vs sequential: tests/test_fl.py's oracle tolerances for the
# losses and accuracies; a trainable leaf is held in norm to UPDATE_REL of
# its round's update (the two behind the adapter's ReLU to GATED_REL),
# its largest difference reported beside leaf_atol (``round_diffs``)
ORACLE = dict(leaf_atol=5e-4, loss_atol=1e-3, loss_rtol=1e-4, acc_atol=1e-5)
UPDATE_REL, GATED_REL = 2e-2, 1e-1


# -- measurement helpers -----------------------------------------------

class _profile(torch.profiler.profile):
    """``torch.profiler.profile`` without the trace's distributed metadata:
    with a process group up (phases 13-15) gathering it takes seconds a
    session, and no trace is exported here."""

    def _get_distributed_info(self):
        return None


def timings(fn, iters: int = 50, budget_s: float = 0.1) -> tuple:
    """(device ms, call ms) per call of ``fn()``. Device time is the sum
    of the card's kernel and copy activities that ``torch.profiler``
    records over the timed calls (what the kernels themselves take);
    call time comes from CUDA events around back-to-back calls and
    includes the host's dispatch, which bounds it at small shapes.
    Each loop makes ``iters`` calls, or as many as fit in ``budget_s``
    by the three warm-up calls' wall time, at least 5 (a plain version
    that dispatches thousands of small ops a call would otherwise spend
    most of the script's time building the profiler's events). A
    profiler session that records no device activity is repeated, up
    to three sessions; device time is None if none records any."""
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - w0) / 3
    iters = max(5, min(iters, int(budget_s / max(per_call, 1e-9))))
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
        with _profile(
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

def qmm_route(run) -> tuple:
    """``run()``'s result and the route its ``quant_matmul`` launch took
    (``"gemv"``, ``"tc"`` or ``"tiled"``), read from the wrapper's own
    counts of GEMV and tensor-core launches."""
    fn = qmm_kernel.quant_matmul
    before = (fn.gemv_launches, fn.tc_launches)
    out = run()
    if fn.gemv_launches > before[0]:
        return out, "gemv"
    return out, "tc" if fn.tc_launches > before[1] else "tiled"


def path_launches() -> dict:
    """``ops.launch_counts()`` with the tc route's own count beside
    ``quant_matmul``'s (``ops.reset_launch_counts`` zeroes both)."""
    return {**ops.launch_counts(),
            "quant_matmul_tc": qmm_kernel.quant_matmul.tc_launches}


def gemv_plan_row(T, M, G, N, block) -> dict:
    """The GEMV's plan for a call, as a row prints it."""
    pl = qmm_kernel.plan(max(T, 1), M, G, N)
    return {"plan_cols": pl.cols, "plan_cluster": pl.cluster,
            "plan_ctas": pl.ctas,
            "smem_B": qmm_kernel.gemv_smem_bytes(pl, M, G, block)}


# the tc route's cases (phase 2 (a)): every training shape of PERF.md
# rows 1b and 1c in NF4 and int8, bf16 x, block 64: (name, M, K, N)
QMM_TC_SHAPES = [
    ("rgemma_wg_wu", 256, 2560, 7680), ("rgemma_wd", 256, 7680, 2560),
    ("whisper_enc_wu", 6000, 1024, 4096), ("whisper_enc_wd", 6000, 4096, 1024),
    ("kimi_expert_wg_wu", 7, 7168, 2048), ("kimi_expert_wd", 7, 2048, 7168),
]


def check_quant_matmul(gen) -> tuple:
    """Every format and dtype at the serve replay's shape (4 users x 1
    row, 768x768, block 64; every replay launch has this shape), one and
    eight users, one large shape and the odd-K / ragged-N edges; then the
    tc route (bf16 x past 4 rows) at every training shape of PERF.md rows
    1b and 1c in NF4 and int8. Two calls must be bitwise equal; bf16
    within 1.6e-2 of the largest magnitude, fp32 1e-5. Each tc row also
    times the fp32 route's ``qmm_kernel`` on the same bf16 inputs
    (``tiled_ms``, forced: the wrapper never picks it for bf16). Returns
    the replay-shape int8 record and the Kimi-K2 expert's NF4 tc record."""
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
        ("oddK_raggedN_nf4_bf16", 2, 37, 200, 70, 4, "nf4", torch.bfloat16),
    ] + [(f"{name}_{tag}", 0, M, K, N, bits, mode, torch.bfloat16)
         for name, M, K, N in QMM_TC_SHAPES
         for tag, bits, mode in (("nf4", 4, "nf4"), ("int8", 8, "linear"))]
    main = tc_main = None
    for name, T, M, K, N, bits, mode, dtype in cases:
        lead = (T,) if T else ()
        w = torch.randn((*lead, K, N), generator=gen, device=dev) / K ** 0.5
        if K % 64:   # the odd-K contract: payload covers the padded K
            qt = ref.blockwise_quant(w, bits=bits, block=64, mode=mode)
        else:
            qt = qlib.quantize(w, bits=bits, block=64, mode=mode)
        del w
        x = torch.randn((*lead, M, K), generator=gen, device=dev).to(dtype)
        got, route = qmm_route(lambda: qmm_kernel.quant_matmul(x, qt))
        again = qmm_kernel.quant_matmul(x, qt)
        want = ref.quant_matmul(x, qt)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, want)
        tol = 1e-5 if dtype == torch.float32 else 1.6e-2
        if not (rel_e <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"quant_matmul {name}: rel err {rel_e} > {tol}")
        if not torch.equal(got, again):
            raise AssertionError(f"quant_matmul {name}: two calls differ")
        if route != qmm_kernel.route(M, N, qt.q, dtype):
            raise AssertionError(f"quant_matmul {name}: took {route}")
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
        if route == "tc":
            pl = qmm_kernel.plan_tc(max(T, 1), M, Kq, N, qt.block)
            row.update(plan_bm=pl.bm, plan_splits=pl.splits,
                       plan_blocks=pl.blocks)
            timed(row, "tiled_ms", lambda: qmm_kernel._quant_matmul(
                x, qt, None, force="tiled"))
        report({"quant_matmul": 1, **row})
        if name == "serve_t4_int8":
            main = row
        if name == "kimi_expert_wg_wu_nf4":
            tc_main = row
        del x, qt, got, again, want
    torch.cuda.empty_cache()
    return main, tc_main


# the tc route's plan sweep: the rows it runs (M = 7, 256, 800, 6000),
# NF4 block 64, bf16 x: (M, K, N)
QMM_TC_SWEEP = [(7, 7168, 2048), (7, 2048, 7168), (256, 2560, 7680),
                (256, 7680, 2560), (800, 768, 3072), (6000, 1024, 4096),
                (6000, 4096, 1024)]


def queued_ms(run, iters: int = 20) -> float:
    """Device ms per call of ``run()``: CUDA events around ``iters``
    calls queued behind a ~3 ms sleep kernel, so the host has enqueued
    them all before the first runs and its dispatch does not show (the
    launches' own gaps on the card do)."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    t0.record()
    for _ in range(iters):
        run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def qmm_tc_sweep(gen, iters: int = 20) -> None:
    """The tc route's device time (``queued_ms``) under every row tile
    and split count that ``plan_tc`` considers, at the rows it runs,
    beside the plan's pick and its model's time: the data
    ``TC_TILE_US`` / ``TC_BLOCKS_PER_SM`` are fitted to (refit them when
    the kernel changes)."""
    dev = "cuda"
    for M, K, N in QMM_TC_SWEEP:
        w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
        qt = qlib.quantize(w, bits=4, block=64, mode="nf4")
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        pick = qmm_kernel.plan_tc(1, M, K, N, 64)
        times = {}
        for pl in qmm_kernel.tc_plans(1, M, K, N, 64):
            times[(pl.bm, pl.splits)] = queued_ms(
                lambda: qmm_kernel._quant_matmul(x, qt, None, tc_plan=pl),
                iters)
        best = min(times, key=times.get)
        report({"qmm_tc_sweep": f"{M}x{K}x{N}",
                "plan": f"{pick.bm}/{pick.splits}",
                "plan_ms": times[(pick.bm, pick.splits)],
                "model_ms": qmm_kernel.tc_cost_us(1, M, K, N, 64, pick.bm,
                                                  pick.splits) / 1e3,
                "best": f"{best[0]}/{best[1]}", "best_ms": times[best]})
        print("    ms by row tile/splits: " + " ".join(
            f"{bm}/{s}={t:.4g}" for (bm, s), t in times.items()), flush=True)
        del w, qt, x
    torch.cuda.empty_cache()


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


def check_lora_decode(gen) -> dict:
    """``lora_matmul`` at the decode step's shapes: the four Yi-9B (K, N)
    pairs at M = 4 rows (one token of 4 streams), NF4 block 64, bf16 x,
    rank 16, against the plain version at the bf16 bound, with device,
    call and plain ms beside the bound (bytes: the quantized W dominates
    at M = 4). The tensor-core kernel computes a 256-row tile, so at
    M = 4 it keeps 1/64 of the rows it computes. Returns the rows by
    shape."""
    rows = {}
    for name, (K, N) in YI_LINEARS.items():
        w = (torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
             ).to(torch.bfloat16)
        qt = ref.blockwise_quant(w, bits=4, block=64, mode="nf4")
        x = torch.randn((4, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        a = torch.randn((K, 16), generator=gen, device="cuda") / K ** 0.5
        b = torch.randn((16, N), generator=gen, device="cuda") * 0.05
        run = lambda: lm_kernel.lora_matmul(x, qt, a, b, scale=2.0)
        plain = lambda: ref.lora_matmul(x, qt, a, b, scale=2.0)
        got, route = routed(lm_kernel.lora_matmul, run)
        abs_e, rel_e = rel_err(got, plain())
        if route != "tensor cores" or not (
                rel_e <= _tol(torch.bfloat16) and torch.isfinite(got).all()):
            raise AssertionError(f"lora_matmul decode {name}: {route}, rel "
                                 f"err {rel_e}")
        Kq = qt.q.shape[-3] * qt.block
        b_ms, b_by = bound(nbytes(x, a, b, qt.q, qt.scales, got),
                           2.0 * 4 * (Kq * N + K * 16 + 16 * N),
                           torch.bfloat16)
        row = {"case": f"decode_{name}", "M": 4, "route": route,
               "splits": lm_kernel.plan(4, K, N, qt.block).splits,
               "max_abs_err": abs_e, "rel_err": rel_e, "bound_ms": b_ms,
               "bound_by": b_by}
        timed(row, "ms", run)
        timed(row, "plain_ms", plain)
        report({"lora_matmul": 1, **row})
        rows[name] = row
    return rows


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
    with _profile(
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
    by (users T, rows a user M, route ``"gemv"`` / ``"tc"`` / ``"tiled"``,
    the plan's CTAs (0 for the tiled route), x's dtype), read around each
    call of the op ``ops.quant_matmul``, which the serve engine and the
    models call; the kernel wrapper and its counts are left as they
    are."""
    calls: collections.Counter = collections.Counter()
    op, wrapper = ops.quant_matmul, qmm_kernel.quant_matmul

    def recorded(x, qt):
        before = wrapper.launches
        y, route = qmm_route(lambda: op(x, qt))
        if wrapper.launches > before:
            T = qt.q.shape[0] if qt.q.ndim == 4 else 1
            M = x.numel() // (T * x.shape[-1])
            G, N = qt.q.shape[-3], qt.q.shape[-1]
            ctas = 0
            if route == "gemv":
                ctas = qmm_kernel.plan(T, M, G, N).ctas
            elif route == "tc":
                ctas = qmm_kernel.plan_tc(T, M, G * qt.block, N,
                                          qt.block).blocks
            calls[(T, M, route, ctas, str(x.dtype).split(".")[-1])] += 1
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
    with _profile(activities=[
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


def report_profile(what: str, prof: dict) -> None:
    report({what + "_" + k: v for k, v in prof.items()
            if k not in ("top_ms", "regions_ms")})
    print(f"  {what} top device time (ms), each with its launching ops "
          "(op, region, ms):", flush=True)
    for n, ms, srcs in prof["top_ms"]:
        print(f"    {ms} {n}: {srcs}", flush=True)
    print(f"  {what} device time by region (ms): {prof['regions_ms']}",
          flush=True)


def train_phase(*, arch="yi-9b", rounds=2, clients=2, steps=2, batch=4,
                seq=64, n_layers=None, seed=0, device="cuda",
                params=None) -> dict:
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
    ``n_layers`` and gets no profile. ``params`` (the same config's
    ``init_params`` from ``seed``, say the token mode's) skips the init."""
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
    if params is None:
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
    launches = path_launches()
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
    if "quant_matmul" in kernels and launches["quant_matmul_tc"] < 1:
        raise AssertionError("the bf16 trainer's quant_matmul took no tc "
                             "launch")
    # the bf16 model's attention and LoRA linears take the tensor cores
    tc = ops.tc_launch_counts()
    for name in set(kernels) & set(tc):
        if cfg.dtype == "bfloat16" and tc[name] != launches[name]:
            raise AssertionError(f"{name}: {tc[name]} of {launches[name]} "
                                 "launches on tensor cores in a bf16 model")
    res["tc_launches"] = tc
    if "quant_matmul_t" in kernels and cfg.dtype == "bfloat16":
        per_step = traces.get("quant_matmul_t_cuda_tc", 0) / n_steps
        if "quant_matmul_t_cuda" in traces or per_step != qmt_per_step(cfg):
            raise AssertionError(
                f"quant_matmul_t: {per_step} tensor-core launches per local "
                f"step (want {qmt_per_step(cfg)}), traces {traces}")
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
    # what the profiled step holds: params, Adam state and its batch
    res["step"] = {"cfg": cfg, "batch": batch, "seq": seq,
                   "resident_bytes": qlib.tree_bytes(frozen) +
                   qlib.tree_bytes(tr) + qlib.tree_bytes(
                       tuple(optim.adam_init(tr))) + qlib.tree_bytes(
                       train_lib.make_batch(data[0][idx], device))}
    return res


def step_check_report(arch: str) -> None:
    """Phases 4 and 6: ``step_check_phase`` on the card, reported."""
    print(f"full-width {arch} step (1 layer), card vs CPU:", flush=True)
    t0 = time.perf_counter()
    for res in step_check_phase(arch=arch, n_layers=1).values():
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
    _STEP5[arch] = {**tres["step"], "busy_s": prof["device_busy_s"],
                    "wall_s": prof["wall_s"],
                    "max_memory_allocated": tres["max_memory_allocated"]}
    del tres
    torch.cuda.empty_cache()
    return launches


# phases 5 and 7's profiled step (config, shape, resident bytes, busy
# time), for the dry run's account in phase 15 (b)
_STEP5: dict = {}


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
    pretrained CLIP is the cached one; a GAN arm's clients rebalanced by
    the fleet engine on the run's GAN streams)."""
    strat = STRATEGIES[cfg.strategy]
    ccfg = clip_lib.CLIPConfig()
    data = make_dataset(cfg.dataset, n_per_class=cfg.n_per_class,
                        seed=cfg.seed, longtail_gamma=cfg.longtail_gamma)
    clients = fl_clients(data, cfg.n_clients, cfg.alpha, cfg.seed, strat)
    if strat.use_gan:
        fleetgan.prepare_gan_fleet(
            clients, [streams.gan(i) for i in range(len(clients))],
            steps=cfg.gan_steps, device=device)
    frozen = sim_lib.pretrained_clip(cfg.dataset, ccfg, seed=1234,
                                     init=streams.clip_init, device=device)
    if strat.backbone_bits:
        frozen = nf4_round_trip(frozen)[0]
    return (frozen, ccfg, class_embedding(frozen, ccfg, device), clients,
            convert.tree_from_numpy(streams.trainable_init, device), strat)


def gan_clients(**settings) -> tuple:
    """Phase 8's clients for the tripleplay arm (``FL_PAPER``, 5 clients
    of a Dirichlet(0.5) partition, 60 samples a class before the long
    tail) and their GAN streams, as ``run_federated`` builds them."""
    cfg = sim_lib.FLConfig(strategy="tripleplay", **{**FL_PAPER, **settings})
    data = make_dataset(cfg.dataset, n_per_class=cfg.n_per_class,
                        seed=cfg.seed, longtail_gamma=cfg.longtail_gamma)
    clients = fl_clients(data, cfg.n_clients, cfg.alpha, cfg.seed,
                         STRATEGIES["tripleplay"])
    streams = sim_lib.seeded_streams(cfg).gan
    return clients, [streams(i) for i in range(len(clients))]


def gan_need(clients) -> int:
    """The synthetic rows the eligible clients need (the local max count
    of every class)."""
    return sum(len(gan_lib.rebalance_labels(c.labels, c.n_classes))
               for c in clients if c.n >= GAN_MIN_POOL)


def gan_diffs(want, got) -> dict:
    """Two GAN preps of the same clients: eligibility and rebalancing
    labels equal (else it raises), the largest generator-leaf and
    synthesized-image differences, and whether they are within
    ``GAN_BOUNDS``."""
    gen = img = 0.0
    for i, (a, b) in enumerate(zip(want, got)):
        if (a.gan_params is None) != (b.gan_params is None):
            raise AssertionError(f"client {i}: GAN eligibility differs")
        if a.gan_params is None:
            continue
        if not np.array_equal(a.aug_labels, b.aug_labels):
            raise AssertionError(f"client {i}: rebalancing labels differ")
        for (p, la), (_, lb) in zip(
                tree_lib.flatten_with_path(a.gan_params["gen"]),
                tree_lib.flatten_with_path(b.gan_params["gen"])):
            gen = max(gen, (la.cpu() - lb.cpu()).abs().max().item())
        if len(a.aug_labels):
            img = max(img, float(np.abs(a.aug_images - b.aug_images).max()))
    return {"gen_leaf_abs": gen, "image_abs": img,
            "ok": gen <= GAN_BOUNDS["gen_atol"] and
            img <= GAN_BOUNDS["img_atol"]}


def check_gan_convs(gen) -> list:
    """The GAN's convolutions (``GAN_CONVS``) with the fleet's axis of 5
    clients, ``conv_impl="lax"`` (cuDNN, TF32 off) against ``"gemm"``
    (cuBLAS): outputs and both gradients within 1e-5 of the largest
    value, each form's forward + backward timed."""
    clients = 5
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for the GAN's parity")
    fns = {"conv": (gan_conv.conv4x4_s2, gan_conv.conv4x4_s2_lax),
           "convT": (gan_conv.convT4x4_s2, gan_conv.convT4x4_s2_lax)}
    rows = []
    for op, b, hw, ci, co in GAN_CONVS:
        out_hw = hw // 2 if op == "conv" else hw * 2
        x = torch.randn((clients, b, hw, hw, ci), generator=gen,
                        device="cuda")
        w = torch.randn((clients, 4, 4, ci, co), generator=gen,
                        device="cuda") * 0.05
        ct = torch.randn((clients, b, out_hw, out_hw, co), generator=gen,
                         device="cuda")

        def run(fn):
            xt, wt = (t.detach().requires_grad_(True) for t in (x, w))
            out = fn(xt, wt)
            gx, gw = torch.autograd.grad(out, (xt, wt), ct)
            return out.detach(), gx, gw

        got, want = run(fns[op][0]), run(fns[op][1])
        torch.cuda.synchronize()
        errs = [rel_err(g_, w_)[1] for g_, w_ in zip(got, want)]
        row = {"case": f"{op}_C{clients}x{b}x{hw}x{hw}x{ci}->{co}",
               "rel_err_out_dx_dw": [float(f"{e:.3g}") for e in errs]}
        if not (max(errs) <= 1e-5 and all(torch.isfinite(t).all()
                                          for t in got)):
            raise AssertionError(f"GAN {row['case']}: lax vs gemm {errs}")
        timed(row, "gemm_ms", lambda: run(fns[op][0]))
        timed(row, "lax_ms", lambda: run(fns[op][1]))
        report(row)
        rows.append(row)
    return rows


def check_gan_convs_int8(gen) -> list:
    """The GAN's convolutions (``GAN_CONVS``, 5 clients) through the int8
    gemms (``conv_impl="gemm_int8"``) against the fp32 gemm forms, TF32
    off: output and gradients within the reference's int8 bound (3e-2 of
    the largest value, ``tests/test_kernels.py``), each timed; the block
    products of every int8 gemm on the card bitwise the int64 product of
    the same codes on the CPU."""
    clients = 5
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for the GAN's parity")
    fns = {"conv": (gan_conv.conv4x4_s2_int8, gan_conv.conv4x4_s2),
           "convT": (gan_conv.convT4x4_s2_int8, gan_conv.convT4x4_s2)}
    products = []
    block_products = gan_conv.block_products

    def recorded(qx, qw):
        p = block_products(qx, qw)
        products.append((qx, qw, p))
        return p

    rows = []
    for op, b, hw, ci, co in GAN_CONVS:
        out_hw = hw // 2 if op == "conv" else hw * 2
        x = torch.randn((clients, b, hw, hw, ci), generator=gen,
                        device="cuda")
        w = torch.randn((clients, 4, 4, ci, co), generator=gen,
                        device="cuda") * 0.05
        ct = torch.randn((clients, b, out_hw, out_hw, co), generator=gen,
                         device="cuda")

        def run(fn):
            xt, wt = (t.detach().requires_grad_(True) for t in (x, w))
            out = fn(xt, wt)
            gx, gw = torch.autograd.grad(out, (xt, wt), ct)
            return out.detach(), gx, gw

        products.clear()
        gan_conv.block_products = recorded
        try:
            got = run(fns[op][0])
        finally:
            gan_conv.block_products = block_products
        want = run(fns[op][1])
        torch.cuda.synchronize()
        exact = all(torch.equal(p.cpu().long(), torch.matmul(
            qx.cpu().transpose(-3, -2).long(),
            qw.cpu().transpose(-3, -2).transpose(-1, -2).long()))
            for qx, qw, p in products)
        errs = [rel_err(g_, w_)[1] for g_, w_ in zip(got, want)]
        row = {"case": f"int8 {op}_C{clients}x{b}x{hw}x{hw}x{ci}->{co}",
               "rel_err_vs_fp32_out_dx_dw": [float(f"{e:.3g}") for e in errs],
               "int8_gemms": len(products),
               "block_products_exact": exact}
        if not (exact and max(errs) < 3e-2 and all(
                torch.isfinite(t).all() for t in got)):
            raise AssertionError(f"GAN {row['case']}: {row}")
        timed(row, "int8_ms", lambda: run(fns[op][0]))
        timed(row, "gemm_ms", lambda: run(fns[op][1]))
        report(row)
        rows.append(row)
    return rows


def gan_int8_phase(device="cuda", *, check_steps=GAN_CHECK_STEPS,
                   **settings) -> dict:
    """The fleet GAN with ``conv_impl="gemm_int8"`` on phase 8's clients
    at ``check_steps``, the card against the CPU, timed: labels bitwise,
    the generator's leaves within ``GAN_BOUNDS``, the images within
    ``INT8_GAN_IMG_ATOL``. The int8 gemms are bitwise on both devices
    for equal inputs, but the fp32 reductions around them (the
    discriminator's head, the losses) sum in another order on each, and
    a code then moves by one step; over 10 steps that moved an image by
    5.6e-3 on the card, past ``GAN_BOUNDS``' 5e-3 for the fp32 gemms."""
    _, streams = gan_clients(**settings)
    card, host = gan_clients(**settings)[0], gan_clients(**settings)[0]
    _sync(device)
    t0 = time.perf_counter()
    rep = fleetgan.prepare_gan_fleet(card, streams, steps=check_steps,
                                     conv_impl="gemm_int8", device=device)
    _sync(device)
    res = {"steps": check_steps, "card_s": time.perf_counter() - t0,
           "n_synth": rep.n_synth}
    t0 = time.perf_counter()
    fleetgan.prepare_gan_fleet(host, streams, steps=check_steps,
                               conv_impl="gemm_int8", device="cpu")
    res["cpu_s"] = time.perf_counter() - t0
    res["card_vs_cpu"] = d = gan_diffs(host, card)
    d.pop("ok")
    if not (d["gen_leaf_abs"] <= GAN_BOUNDS["gen_atol"] and
            d["image_abs"] <= INT8_GAN_IMG_ATOL):
        raise AssertionError(f"int8 GAN, card vs CPU: {res}")
    return res


def gan_phase(device="cuda", *, check_steps=GAN_CHECK_STEPS, steps=150,
              profile_steps=5, profile=True, **settings) -> dict:
    """The tripleplay arm's GAN prep on phase 8's clients at the
    reference's ``GANConfig()``: the fleet engine against the sequential
    ``Client.prepare_gan`` loop at ``check_steps`` (labels bitwise, the
    generator and images within ``GAN_BOUNDS``), the card against the
    CPU likewise, then the fleet at the full ``steps``: finite losses,
    every needed row delivered, and its wall time; then a prep of
    ``profile_steps`` under the profiler (a window of the same steps:
    building the profiler's events of all 150 steps, about 1.8 million,
    takes minutes on the host) for the device busy time, idle share and
    ATen ops a step."""
    on_card = torch.device(device).type == "cuda"
    fresh = lambda: gan_clients(**settings)[0]
    _, streams = gan_clients(**settings)
    fleet, seq = fresh(), fresh()
    fleetgan.prepare_gan_fleet(fleet, streams, steps=check_steps,
                               device=device)
    for c, st in zip(seq, streams):
        if c.n >= GAN_MIN_POOL:
            c.prepare_gan(st, steps=check_steps, device=device)
    res = {"clients": [c.n for c in fleet], "need": gan_need(fleet),
           "fleet_vs_sequential": gan_diffs(seq, fleet)}
    if on_card:
        host = fresh()
        fleetgan.prepare_gan_fleet(host, streams, steps=check_steps,
                                   device="cpu")
        res["card_vs_cpu"] = gan_diffs(host, fleet)
    for k in ("fleet_vs_sequential", "card_vs_cpu"):
        if k in res and not res[k].pop("ok"):
            raise AssertionError(f"GAN {k} at {check_steps} steps: {res[k]}")
    full = fresh()
    _sync(device)
    t0 = time.perf_counter()
    rep = fleetgan.prepare_gan_fleet(full, streams, steps=steps,
                                     device=device)
    _sync(device)
    res["prep_s"] = time.perf_counter() - t0
    res.update(steps=steps, n_eligible=rep.n_eligible, n_synth=rep.n_synth,
               groups=rep.groups, prep_time_s=rep.prep_time_s,
               d_loss=rep.d_loss, g_loss=rep.g_loss)
    losses = list(rep.d_loss.values()) + list(rep.g_loss.values())
    imgs = [c.aug_images for c in full if c.aug_images is not None]
    if not (rep.n_synth == res["need"] > 0 and np.isfinite(losses).all()
            and all(np.isfinite(a).all() and np.abs(a).max() <= 1.0
                    for a in imgs)
            and all(l.device.type == torch.device(device).type
                    for c in full if c.gan_params is not None
                    for l in tree_lib.leaves(c.gan_params))):
        raise AssertionError(f"GAN prep at {steps} steps: {res}")
    if on_card and profile:
        again = fresh()
        res["profile"] = dict(steps=profile_steps, **profile_run(
            lambda: fleetgan.prepare_gan_fleet(again, streams,
                                               steps=profile_steps,
                                               device=device), ()))
    return res


def gan_report() -> None:
    """The GAN phase on the card, reported; the convolutions' cuDNN form
    against the gemm form with it."""
    print("tripleplay GAN (GANConfig(), phase 8's 5 clients): fleet vs "
          "sequential and card vs CPU at 3 steps, then 150 steps, then a "
          "profiled window:", flush=True)
    t0 = time.perf_counter()
    res = gan_phase()
    prof = res.pop("profile")
    report({k: res[k] for k in ("clients", "need", "fleet_vs_sequential",
                                "card_vs_cpu")})
    report({k: v for k, v in res.items() if k not in (
        "clients", "need", "fleet_vs_sequential", "card_vs_cpu")})
    report({"gan_profiled_" + k: v for k, v in prof.items()
            if k not in ("top_ms", "regions_ms", "launches", "tc_launches")})
    print(f"  GAN prep top device time (ms), each with its launching ops: "
          f"{prof['top_ms']}", flush=True)
    print("  the GAN's convolutions, lax (cuDNN) vs gemm (cuBLAS), "
          "forward + backward:", flush=True)
    check_gan_convs(torch.Generator(device="cuda").manual_seed(7))
    print("  the GAN's convolutions through the int8 gemms (gemm_int8) vs "
          "fp32 gemm, forward + backward:", flush=True)
    check_gan_convs_int8(torch.Generator(device="cuda").manual_seed(8))
    report({"gan_int8_fleet": "gemm_int8", **gan_int8_phase()})
    report({"gan_phase_s": time.perf_counter() - t0})


def fl_round_phase(device="cuda", rounds=2, **settings) -> dict:
    """Phase 8: ``run_federated`` through its entry point, the three
    arms, at the paper preset's per-round settings (``FL_PAPER``,
    overridable for a rehearsal) and the JAX package's ``CLIPConfig()``:
    ``rounds`` cohort rounds, pipelined (tripleplay: the fleet GAN at
    ``gan_steps``, 150 unless overridden). Launch counts are zeroed just
    before each run and read right after it. Every History value must be
    finite and every round's uplink ``n_clients x
    per_client_uplink_bytes``; then one round of ``engine="sequential"``
    on the same streams against the cohort run's first round, and the
    first round's trainables through ``oracle_round``, at the oracle
    tolerances. For tripleplay the GAN meta must count every eligible
    client and every needed row, and ``rounds`` rounds of the sequential
    engine with the sequential GAN engine run as well (their History is
    reported beside the cohort run's, checked finite, with the same
    eligibility and uplink)."""
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
        gan = {}
        if strat.use_gan:
            n_el = sum(c.n >= GAN_MIN_POOL for c in clients)
            if (h.meta["gan_eligible"], h.meta["gan_synth"]) != (
                    n_el, gan_need(clients)) or \
                    hs.meta["gan_synth"] != h.meta["gan_synth"]:
                raise AssertionError(f"{arm}: GAN meta {h.meta} (want "
                                     f"{n_el} eligible, "
                                     f"{gan_need(clients)} rows)")
            t0 = time.perf_counter()
            hss = sim_lib.run_federated(
                dataclasses.replace(cfg, engine="sequential",
                                    gan_engine="sequential"),
                device=device, streams=streams)
            _sync(device)
            gan = {"seq_seq_run_s": time.perf_counter() - t0,
                   "seq_seq_meta": {k: v for k, v in hss.meta.items()
                                    if k.startswith("gan_")},
                   "seq_seq_server_acc": hss.server_acc,
                   "seq_seq_tail_acc": hss.tail_acc,
                   "seq_seq_server_loss": hss.server_loss,
                   "seq_seq_vs_cohort_fleet_client_loss_rel": float(np.max(
                       np.abs(np.subtract(hss.client_loss, h.client_loss)) /
                       np.abs(h.client_loss)))}
            if not (all(np.isfinite(np.asarray(v, np.float64)).all()
                        for v in (hss.server_loss, hss.client_loss,
                                  hss.server_acc, hss.tail_acc))
                    and hss.uplink_bytes == h.uplink_bytes
                    and hss.meta["gan_eligible"] == n_el):
                raise AssertionError(f"{arm}: sequential + sequential GAN "
                                     f"run {hss}")
        orc = oracle_round(fz, ccfg, ce, clients, g0, strat,
                           cohort_lib.RoundKey(streams, (3, 0)),
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
                    "sequential_vs_cohort": seq_vs, "oracle": orc, **gan}
    return out


def rebalanced_clients(data, n_clients, alpha, seed, strat, repeat, *,
                       gan_steps, device) -> list:
    """``fl_clients`` at ``repeat`` x the data's side with a GAN arm's
    rebalancing set: the fleet GAN (which consumes only 32 x 32 images)
    trained on the 32 x 32 pools with the seeded GAN streams of
    ``run_federated``, its synthetic rows then repeated like the real
    ones."""
    small = fl_clients(data, n_clients, alpha, seed, strat)
    fleetgan.prepare_gan_fleet(
        small, [gan_lib.SeededGANStream((seed, GAN_RNG_OFFSET + i))
                for i in range(len(small))], steps=gan_steps, device=device)
    big = fl_clients(data, n_clients, alpha, seed, strat, repeat)
    for b, c in zip(big, small):
        if c.aug_images is not None:
            b.aug_images = np.repeat(np.repeat(c.aug_images, repeat, axis=1),
                                     repeat, axis=2)
            b.aug_labels = c.aug_labels
    return big


def vit_round_phase(device="cuda", ccfg=VIT_B32, *, steps=5, batch=32,
                    n_clients=5, n_per_class=60, seed=0, cut_layers=2,
                    cut_steps=3, gan_steps=30, profile=True) -> dict:
    """Phase 9: one full-participation round at ``ccfg``'s width (CLIP
    ViT-B/32), seeded weights, the three arms, through ``CohortEngine``,
    ``FullSyncScheduler`` and ``SequentialExec`` (``oracle_round``).
    The data: 5 clients of a Dirichlet(0.5) partition of
    ``make_dataset("pacs", n_per_class=60)``, each 32 x 32 image
    repeated along both spatial axes to the config's image size
    (tripleplay: the fleet GAN's rows too, ``rebalanced_clients``).
    Launch counts are zeroed before the arms and read after them; on the
    card each arm's cohort round is then profiled, and a ``cut_layers``-
    vision-layer cut of the round, ``cut_steps`` local steps deep, runs
    on the card (kernel) and on the CPU (plain path) on the same weights
    and indices."""
    on_card = torch.device(device).type == "cuda"
    data = make_dataset("pacs", n_per_class=n_per_class, seed=seed)
    repeat = ccfg.image_size // data["images"].shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    frozen0 = clip_lib.init_clip(gen, ccfg, device=device)
    key = cohort_lib.RoundKey(cohort_lib.SeededDraws(seed), (3, 0))
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
        clients = rebalanced_clients(
            data, n_clients, 0.5, seed, strat, repeat, gan_steps=gan_steps,
            device=device) if strat.use_gan else \
            fl_clients(data, n_clients, 0.5, seed, strat, repeat)
        # the GAN arm draws its trainables from a generator of its own,
        # so adding it leaves the other arms' draws (and their cuts') as
        # they were
        arm_gen = torch.Generator(device=device).manual_seed(seed + 1) \
            if strat.use_gan else gen
        g0 = client_lib.init_trainable(arm_gen, ccfg, strat, device=device)
        orc = oracle_round(frozen, ccfg, ce, clients, g0, strat, key,
                           steps=steps, batch=batch, lr=3e-3, device=device)
        arms[arm] = dict(orc, frozen=frozen, class_emb=ce, gen=arm_gen,
                         client_list=clients, global_tr=g0, strat=strat)
    launches, traces = ops.launch_counts(), dict(ops.KERNEL_TRACES)
    res = {"launches": launches, "traces": traces, "arms": {},
           "max_memory_allocated": torch.cuda.max_memory_allocated()
           if on_card else None}
    want = len(FL_ARMS) * steps
    if on_card and (launches["flash_attention"] < want or
                    traces.get("flash_attention_cuda", 0) < want or
                    "flash_attention_ref" in traces):
        raise AssertionError(f"ViT-B/32 round: flash_attention launches "
                             f"{launches} traces {traces}")
    for arm, a in arms.items():
        row = {k: v for k, v in a.items() if k not in (
            "engine", "tr", "frozen", "class_emb", "client_list",
            "global_tr", "strat", "gen")}
        if on_card and profile:
            row["profile"] = profile_run(
                lambda: a["engine"].run_round(a["global_tr"], key),
                ("flash_attention",))
        row["cut"] = cut_check(a, ccfg, cut_layers, a["gen"], key,
                               steps=cut_steps, batch=batch, device=device)
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


# -- phase 10: the scheduler layer --------------------------------------

# Fig. 7's scheduler sweep (benchmarks/fig7_scalability.py: N = 10, 48 a
# class, skewed trace, K of N under both policies) at the paper preset's
# round settings, 2 commits each (cut from 12), the GAN's prep cut from
# 150 steps to 30 (phase 8 runs the 150)
SCHED_SWEEP = dict(dataset="pacs", strategy="tripleplay", n_clients=10,
                   n_per_class=48, local_steps=10, batch_size=32, lr=3e-3,
                   gan_steps=30, trace="skewed", rounds=2)
SCHED_KS = (2, 5)
SCHED_POLICIES = ("sync-partial", "async")
# the reference's fault study (benchmarks/fl_round_bench.py:661-682);
# tripleplay's GAN prep cut from 150 steps to 30 as in the sweep
FAULT_STUDY = dict(dataset="pacs", n_clients=8, n_per_class=24,
                   local_steps=6, batch_size=32, lr=3e-3, trace="diurnal",
                   clients_per_round=3, rounds=6, gan_steps=30)
FAULT_CHAOS = sched_lib.ChaosConfig(dropout_prob=0.25, straggler_sigma=0.5,
                                    uplink_loss_prob=0.1)


def _finite(*vals) -> bool:
    return all(np.isfinite(np.asarray(v, np.float64)).all() for v in vals
               if len(v))


def _columns(h) -> dict:
    """The host-side History columns a run's draws decide."""
    return {"participation": h.participation, "staleness": h.staleness,
            "vtime": h.vtime, "uplink_bytes": h.uplink_bytes,
            "class_counts": h.class_counts,
            "fault_ledger": h.meta.get("fault_ledger")}


def sched_run(cfg, device, streams) -> dict:
    """``run_federated(cfg)`` with the launch counts and traces zeroed
    just before it and read right after it; on the card every cohort
    commit (sync round or async wave) must launch ``flash_attention`` at
    least once a local step, none on the plain route."""
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    h = sim_lib.run_federated(cfg, device=device, streams=streams)
    _sync(device)
    run_s = time.perf_counter() - t0
    launches, traces = ops.launch_counts(), dict(ops.KERNEL_TRACES)
    if torch.device(device).type == "cuda" and cfg.engine == "cohort":
        want = cfg.rounds * cfg.local_steps
        if launches["flash_attention"] < want or \
                traces.get("flash_attention_cuda", 0) < want or \
                "flash_attention_ref" in traces:
            raise AssertionError(
                f"{cfg.strategy} {cfg.participation}: flash_attention "
                f"launches {launches} traces {traces} (want >= {want})")
    if not _finite(h.server_acc, h.tail_acc, h.server_loss,
                   *h.client_loss, *h.client_acc) or \
            len(h.vtime) != cfg.rounds or \
            any(b < a for a, b in zip(h.vtime, h.vtime[1:])):
        raise AssertionError(f"{cfg.strategy} {cfg.participation}: bad "
                             f"History {_columns(h)}")
    return {"history": h, "run_s": run_s,
            "flash_launches": launches["flash_attention"]}


def commit_vs_sequential(mk, engine, seq, g0, key, device) -> dict:
    """One ``step`` (a sync round or an async commit) of the scheduler
    ``mk(executor)`` builds, through the stacked engine and through the
    sequential clients from ``g0`` on ``key``: the trainables held by
    ``round_diffs``, the committed clients' losses and accuracies at the
    oracle tolerances, participation and bytes equal (else it raises).
    Returns the row, with the cohort step's wall time."""
    _sync(device)
    t0 = time.perf_counter()
    tr_c, m_c = mk(sched_lib.CohortExec(engine)).step(g0, 0, key)
    _sync(device)
    cohort_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr_s, m_s = mk(seq).step(g0, 0, key)
    _sync(device)
    seq_s = time.perf_counter() - t0
    vals = lambda m, f: np.asarray([float(v) for v in m[f]])
    row = {"cohort_s": cohort_s, "sequential_s": seq_s,
           **round_diffs(tr_c, tr_s, g0),
           "participation": [int(c) for c in m_c["participation"]],
           "loss_abs": float(np.abs(vals(m_c, "loss") -
                                    vals(m_s, "loss")).max()),
           "acc_abs": float(np.abs(vals(m_c, "acc") - vals(m_s, "acc")).max()),
           "uplink_bytes": m_c["uplink_bytes"]}
    if not (row.pop("ok") and list(m_c["participation"]) ==
            list(m_s["participation"]) and np.allclose(
                vals(m_c, "loss"), vals(m_s, "loss"),
                atol=ORACLE["loss_atol"], rtol=ORACLE["loss_rtol"])
            and row["acc_abs"] <= ORACLE["acc_atol"]
            and m_c["uplink_bytes"] == m_s["uplink_bytes"]):
        raise AssertionError(f"cohort vs sequential: {row}")
    return row


def sched_oracle(cfg, device, streams, k) -> dict:
    """On the clients, backbone and trainables ``run_federated(cfg)``
    builds: one commit of each policy at width ``k`` through the stacked
    engine and through the sequential clients, held as ``oracle_round``
    holds a round; and sync-partial at K = N on a uniform trace against
    the full round, bitwise."""
    fz, ccfg, ce, clients, g0, strat = like_run(cfg, device, streams)
    engine = cohort_lib.CohortEngine(
        frozen=fz, ccfg=ccfg, class_emb=ce, clients=clients,
        cfg=cohort_lib.CohortConfig(strategy=strat,
                                    local_steps=cfg.local_steps,
                                    batch_size=cfg.batch_size, lr=cfg.lr))
    seq = sched_lib.SequentialExec(
        clients=clients, frozen=fz, ccfg=ccfg, class_emb=ce,
        local_steps=cfg.local_steps, batch_size=cfg.batch_size, lr=cfg.lr)
    trace = sched_lib.resolve_trace(cfg.trace, len(clients), seed=cfg.seed)
    key = cohort_lib.RoundKey(streams, (3, 0))
    out = {"per_client_uplink_bytes": engine.per_client_uplink_bytes(g0)}
    for policy in SCHED_POLICIES:
        mk = lambda ex: sched_lib.make_scheduler(
            policy, executor=ex, trace=trace, local_steps=cfg.local_steps,
            clients_per_round=k, client_n=[c.n for c in clients])
        res = {"k": k, **commit_vs_sequential(mk, engine, seq, g0, key,
                                              device)}
        if res["uplink_bytes"] != k * out["per_client_uplink_bytes"]:
            raise AssertionError(f"{policy} commit uplink: {res}")
        out[policy] = res
    n = len(clients)
    tr_f, m_f = engine.run_round(g0, key)
    tr_p, m_p = sched_lib.SyncPartialScheduler(
        executor=sched_lib.CohortExec(engine),
        trace=sched_lib.uniform_trace(n), local_steps=cfg.local_steps,
        clients_per_round=n).step(g0, 0, key)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(tr_f), tree_lib.leaves(tr_p))) and \
        torch.equal(m_f["loss"], m_p["loss"]) and \
        torch.equal(m_f["acc"], m_p["acc"])
    if not same or list(m_p["participation"]) != list(range(n)):
        raise AssertionError("sync-partial at K = N is not bitwise the "
                             "full round")
    out["k_eq_n_bitwise"] = {"n": n, "equal": same}
    return out


def sched_sweep_phase(device="cuda", **settings) -> dict:
    """Phase 10 (a): Fig. 7's scheduler sweep through ``run_federated``
    (``SCHED_SWEEP``, overridable for a rehearsal): K in ``SCHED_KS``
    under both policies, cohort engine, pipelined, each run twice (the
    draws' columns must repeat); every History checked (finite,
    participation K wide, staleness 0 for sync and >= 0 for async,
    ``vtime`` non-decreasing, uplink K x the per-client payload); then
    ``sched_oracle`` at the largest K."""
    st = {**SCHED_SWEEP, **settings}
    base = sim_lib.FLConfig(engine="cohort", pipeline="pipelined", **st)
    streams = sim_lib.seeded_streams(base)
    orc = sched_oracle(base, device, streams, max(SCHED_KS))
    per_client = orc["per_client_uplink_bytes"]
    out = {"oracle": orc, "runs": {}, "flash_launches": 0}
    for policy in SCHED_POLICIES:
        for k in SCHED_KS:
            cfg = dataclasses.replace(base, participation=policy,
                                      clients_per_round=k)
            runs = [sched_run(cfg, device, streams) for _ in range(2)]
            h = runs[0]["history"]
            if _columns(h) != _columns(runs[1]["history"]):
                raise AssertionError(f"{policy} K={k}: two runs differ: "
                                     f"{_columns(h)} vs "
                                     f"{_columns(runs[1]['history'])}")
            if any(len(p) != k for p in h.participation) or \
                    h.uplink_bytes != [k * per_client] * cfg.rounds or \
                    any(t != 0 if policy == "sync-partial" else t < 0
                        for row in h.staleness for t in row):
                raise AssertionError(f"{policy} K={k}: {_columns(h)} "
                                     f"(per-client payload {per_client})")
            out["runs"][(policy, k)] = runs
            out["flash_launches"] += sum(r["flash_launches"] for r in runs)
    return out


def fault_study_phase(device="cuda", **settings) -> dict:
    """Phase 10 (b): the reference's fault study through ``run_federated``
    (``FAULT_STUDY``: fedclip under ``FAULT_CHAOS``), then tripleplay
    under ``"heavy"``, both policies, each cohort run twice (columns and
    ledger must repeat) and once on the sequential engine (the same
    participation, virtual time, bytes and ledger; the first round's
    client losses at the oracle tolerance). Every ledger must be
    non-empty, tripleplay's with GAN drops: it runs at seed 1, since at
    seed 0 the heavy preset's GAN-drop draw (p = 0.25) drops no eligible
    client (its smallest uniform over the 8 clients is 0.268)."""
    st = {**FAULT_STUDY, **settings}
    out = {"runs": {}, "flash_launches": 0}
    for arm, chaos, seed in (("fedclip", FAULT_CHAOS, 0),
                             ("tripleplay", "heavy", 1)):
        for policy in SCHED_POLICIES:
            cfg = sim_lib.FLConfig(strategy=arm, participation=policy,
                                   chaos=chaos, engine="cohort", seed=seed,
                                   **st)
            streams = sim_lib.seeded_streams(cfg)
            runs = [sched_run(cfg, device, streams) for _ in range(2)]
            seq = sched_run(dataclasses.replace(cfg, engine="sequential"),
                            device, streams)
            h, hs = runs[0]["history"], seq["history"]
            led = h.meta["fault_ledger"]
            if _columns(h) != _columns(runs[1]["history"]) or \
                    _columns(h) != _columns(hs):
                raise AssertionError(f"{arm} {policy}: runs or engines "
                                     f"differ: {_columns(h)} vs "
                                     f"{_columns(runs[1]['history'])} vs "
                                     f"{_columns(hs)}")
            if not sum(led.values()) or (arm == "tripleplay" and
                                         not led["gan_dropped"]):
                raise AssertionError(f"{arm} {policy}: ledger {led}")
            first = next((i for i, r in enumerate(h.client_loss) if r), None)
            if first is not None and not np.allclose(
                    h.client_loss[first], hs.client_loss[first],
                    atol=ORACLE["loss_atol"], rtol=ORACLE["loss_rtol"]):
                raise AssertionError(f"{arm} {policy}: round {first} client "
                                     f"losses {h.client_loss[first]} vs "
                                     f"sequential {hs.client_loss[first]}")
            out["runs"][(arm, policy)] = runs + [seq]
            out["flash_launches"] += sum(r["flash_launches"] for r in runs)
    return out


def vit_sched_phase(device="cuda", ccfg=VIT_B32, *, steps=5, batch=32,
                    n_clients=5, n_per_class=60, seed=0,
                    profile=True) -> dict:
    """Phase 10 (c): ``qlora_nogan`` at ``ccfg``'s width (CLIP ViT-B/32)
    on phase 9's clients (seeded weights, images repeated to the config's
    size): one sync-partial round at K = 3 (width bucket 4: a pad row of
    zero weight) and one async commit (buffer 2, concurrency 4: waves of
    4 and of 2 in bucket 4), each through the stacked engine and the
    sequential clients, held by ``round_diffs``; launch counts zeroed
    before and read after; then each profiled, with the peak device
    memory."""
    on_card = torch.device(device).type == "cuda"
    data = make_dataset("pacs", n_per_class=n_per_class, seed=seed)
    repeat = ccfg.image_size // data["images"].shape[1]
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    strat = STRATEGIES["qlora_nogan"]
    frozen = nf4_round_trip(clip_lib.init_clip(gen, ccfg, device=device))[0]
    ce = class_embedding(frozen, ccfg, device)
    clients = fl_clients(data, n_clients, 0.5, seed, strat, repeat)
    g0 = client_lib.init_trainable(gen, ccfg, strat, device=device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    engine = cohort_lib.CohortEngine(
        frozen=frozen, ccfg=ccfg, class_emb=ce, clients=clients,
        cfg=cohort_lib.CohortConfig(strategy=strat, local_steps=steps,
                                    batch_size=batch, lr=3e-3))
    seq = sched_lib.SequentialExec(
        clients=clients, frozen=frozen, ccfg=ccfg, class_emb=ce,
        local_steps=steps, batch_size=batch, lr=3e-3)
    trace = sched_lib.uniform_trace(len(clients))
    key = cohort_lib.RoundKey(cohort_lib.SeededDraws(seed), (3, 0))
    cases = {"sync-partial": (3, 0), "async": (2, 4)}

    def mk(policy, ex):
        k, conc = cases[policy]
        return sched_lib.make_scheduler(
            policy, executor=ex, trace=trace, local_steps=steps,
            clients_per_round=k, concurrency=conc,
            client_n=[c.n for c in clients])

    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    res = {"policies": {}}
    for policy in cases:
        res["policies"][policy] = {
            "k": cases[policy][0],
            **commit_vs_sequential(functools.partial(mk, policy), engine,
                                   seq, g0, key, device)}
    res["launches"] = ops.launch_counts()
    res["traces"] = dict(ops.KERNEL_TRACES)
    # programs: sync a bucket-4 round; async a wave of 4, one of 2 in 4
    want = 3 * steps
    if on_card and (res["launches"]["flash_attention"] < want or
                    res["traces"].get("flash_attention_cuda", 0) < want or
                    "flash_attention_ref" in res["traces"]):
        raise AssertionError(f"ViT-B/32 scheduler: flash_attention "
                             f"launches {res['launches']} traces "
                             f"{res['traces']}")
    if on_card and profile:
        for policy in cases:
            res["policies"][policy]["profile"] = profile_run(
                lambda: mk(policy, sched_lib.CohortExec(engine)).step(
                    g0, 0, key), ("flash_attention",))
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
        if on_card else None
    return res


def sched_report() -> int:
    """Phase 10 on the card, reported (each case once: the repeat runs
    and the sequential engine were checked equal on the draws' columns;
    their times beside run 0's). Returns its flash_attention launches."""
    print(f"scheduler layer (participation, traces, chaos), {card_line()}:",
          flush=True)
    t_all = t0 = time.perf_counter()
    rnd = lambda xs: [round(x, 4) for x in xs]
    sweep = sched_sweep_phase()
    orc = sweep["oracle"]
    for policy in SCHED_POLICIES:
        report({"sweep_oracle": policy, **{k: v for k, v in orc[policy].items()
                                           if k != "leaf_abs_n_rel"}})
    report({"k_eq_n_bitwise": orc["k_eq_n_bitwise"],
            "per_client_uplink_bytes": orc["per_client_uplink_bytes"]})
    for (policy, k), runs in sweep["runs"].items():
        h = runs[0]["history"]
        report({"sweep": f"{policy} K={k}",
                "run_s": rnd(r["run_s"] for r in runs),
                "round_time_s": [rnd(r["history"].round_time_s)
                                 for r in runs],
                "gan_prep_time_s": rnd(r["history"].meta["gan_prep_time_s"]
                                       for r in runs),
                "server_acc": rnd(h.server_acc),
                "server_loss": rnd(h.server_loss),
                "flash_launches": runs[0]["flash_launches"],
                **{c: v for c, v in _columns(h).items()
                   if c not in ("fault_ledger", "class_counts")}})
    n = sweep["flash_launches"]
    report({"sweep_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    study = fault_study_phase()
    for (arm, policy), runs in study["runs"].items():
        h = runs[0]["history"]
        report({"fault_study": f"{arm} {policy}",
                "run_s_cohort_cohort_sequential": rnd(r["run_s"]
                                                      for r in runs),
                "round_time_s": [rnd(r["history"].round_time_s)
                                 for r in runs],
                "server_acc": rnd(h.server_acc),
                "flash_launches": runs[0]["flash_launches"],
                **_columns(h)})
        report({"fault_study": f"{arm} {policy}", "device_class_report": [
            {k: round(v, 4) for k, v in r.items()}
            for r in h.meta["device_class_report"]]})
    n += study["flash_launches"]
    report({"fault_study_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    vit = vit_sched_phase()
    report({"vit_launches": vit["launches"], "vit_traces": vit["traces"],
            "max_memory_allocated": vit["max_memory_allocated"]})
    for policy, row in vit["policies"].items():
        prof = row.pop("profile", None)
        report({"vit": policy, **{k: v for k, v in row.items()
                                  if k != "leaf_abs_n_rel"}})
        if prof is not None:
            report({"vit": policy, **{k: v for k, v in prof.items()
                                      if k not in ("top_ms", "regions_ms")}})
            print(f"  {policy} top device time (ms), with launching ops: "
                  f"{prof['top_ms'][:5]}", flush=True)
    n += vit["launches"]["flash_attention"]
    report({"vit_sched_phase_s": time.perf_counter() - t0,
            "sched_phase_s": time.perf_counter() - t_all,
            "flash_launches": n, "card": card_line()})
    torch.cuda.empty_cache()
    return n


def fl_round_report() -> int:
    """Phase 8 on the card, reported. Returns its flash_attention
    launches."""
    print("federated round (run_federated), CLIPConfig(), paper preset's "
          "round settings, 2 cohort rounds pipelined:", flush=True)
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
        if "seq_seq_meta" in r:
            report({"arm": arm, **{k: m[k] for k in m
                                   if k.startswith("gan_")}})
            report({"arm": arm, **{k: v for k, v in r.items()
                                   if k.startswith("seq_seq")}})
        n += r["launches"]["flash_attention"]
    report({"fl_round_phase_s": time.perf_counter() - t0})
    return n


def vit_round_report() -> int:
    """Phase 9 on the card, reported. Returns its flash_attention
    launches."""
    print("federated round at CLIP ViT-B/32 width (seeded weights), "
          "cohort vs sequential, then a 2-layer 3-step cut card vs CPU:",
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


# -- phase 11: the trainer-to-store handoff ----------------------------

# a fault-free sync-partial run at the paper preset's round settings
HANDOFF = dict(FL_PAPER, strategy="fedclip", participation="sync-partial",
               clients_per_round=2)
HANDOFF_USERS, HANDOFF_ENTRIES = 8, 6
INT8_BOUND = 5e-2
LOOP_SYNCS = Path(__file__).resolve().parent / "scripts" / \
    "torch_loop_syncs.py"


def same_history(a, b) -> bool:
    """Two Histories equal in every field but the wall times and meta."""
    return all(getattr(a, f.name) == getattr(b, f.name)
               for f in dataclasses.fields(sim_lib.History)
               if f.name not in ("round_time_s", "meta"))


def slab_rows(store, uid) -> list:
    """``uid``'s slab rows (fetched), payloads and scales apart."""
    famk, slot = store.fetch(uid)
    out = []
    for l in tree_lib.leaves(serve_lib.take_rows(
            store.family(famk)["slabs"],
            torch.tensor([slot], device=store.device))):
        out += [l.q, l.scales] if isinstance(l, qlib.QTensor) else [l]
    return out


def refetch_equal(store) -> bool:
    """Every resident's slab rows bitwise a cold store's fetch of its
    backing tree: a refresh is an evict-and-refetch."""
    for uid in store.resident():
        cold = serve_lib.AdapterStore({uid: store.backing[uid]},
                                      max_entries=1,
                                      quant_bits=store.quant_bits,
                                      device=store.device)
        if not all(torch.equal(a, b) for a, b in
                   zip(slab_rows(store, uid), slab_rows(cold, uid))):
            return False
    return True


def replay_vs_oracle(frozen, ccfg, class_emb, store, trace, images,
                     device) -> dict:
    """Replay ``trace`` through a ``ServeEngine`` over ``store`` (launch
    counts zeroed just before, read right after) and hold the logits to
    ``serve_sequential`` on the store's backing at the int8 bound."""
    engine = serve_lib.ServeEngine(
        frozen=frozen, ccfg=ccfg, class_emb=class_emb, store=store,
        cfg=serve_lib.ServeConfig(max_batch=min(16, store.max_entries)))
    ops.reset_launch_counts()
    ops.reset_kernel_traces()
    rec = serve_lib.replay(engine, trace, images)
    launches, traces = ops.launch_counts(), dict(ops.KERNEL_TRACES)
    reqs = [(int(u), im) for u, im in zip(trace.uid, images)]
    oracle = serve_lib.serve_sequential(frozen, ccfg, class_emb,
                                        store.backing, reqs, device=device)
    err = float(np.max(np.abs(rec["logits"] - oracle)))
    if not (np.isfinite(rec["logits"]).all() and err < INT8_BOUND):
        raise AssertionError(f"replay after the refresh vs oracle: {err}")
    return {"engine": engine, "rec": rec, "err_int8": err,
            "launches": launches, "traces": traces}


def kernels_ran(launches, traces, names) -> bool:
    """Each kernel of ``names`` launched and no plain route taken."""
    return all(launches[n] > 0 for n in names) and not any(
        k.endswith("_ref") for k in traces)


def handoff_phase(device="cuda", rounds=3, n_requests=48,
                  **settings) -> dict:
    """Phase 11 (a): ``demo_plane(8, max_entries=6)`` at ``CLIPConfig()``;
    ``run_federated`` (fedclip, sync-partial K = 2, the paper preset's
    round settings) in both loop modes with a store over the plane's
    users (six resident, int8) and without one: the Histories equal,
    ``serve_refreshes`` = (rounds - 1) x 8, the resident rows bitwise a
    cold store's fetch, both modes' backings bitwise equal; then a Zipf
    trace replayed against the refreshed store and held to
    ``serve_sequential`` at the int8 bound."""
    on_card = torch.device(device).type == "cuda"
    plane = serve_lib.demo_plane(HANDOFF_USERS, max_entries=HANDOFF_ENTRIES,
                                 device=device)
    res, stores = {"runs": {}}, {}
    for pipeline in ("pipelined", "barrier"):
        cfg = sim_lib.FLConfig(pipeline=pipeline, rounds=rounds,
                               **{**HANDOFF, **settings})
        store = serve_lib.AdapterStore(
            dict(plane["backing"]), max_entries=HANDOFF_ENTRIES,
            quant_bits=8, device=device)
        for uid in range(HANDOFF_ENTRIES):
            store.fetch(uid)
        bare = sim_lib.run_federated(cfg, device=device)
        ops.reset_launch_counts()
        ops.reset_kernel_traces()
        _sync(device)
        t0 = time.perf_counter()
        h = sim_lib.run_federated(cfg, device=device, serve_store=store)
        _sync(device)
        run_s = time.perf_counter() - t0
        launches, traces = ops.launch_counts(), dict(ops.KERNEL_TRACES)
        row = {"run_s": run_s, "round_time_s": h.round_time_s,
               "loop_wall_s": h.meta["loop_wall_s"],
               "serve_refreshes": h.meta["serve_refreshes"],
               "sync_counts": h.meta["sync_counts"],
               "same_history_as_bare": same_history(h, bare),
               "store": store.stats(),
               "refresh_is_refetch": refetch_equal(store),
               "launches": {k: launches[k] for k in SERVE_KERNELS}}
        if not (row["same_history_as_bare"] and row["refresh_is_refetch"]
                and row["serve_refreshes"] == (rounds - 1) * HANDOFF_USERS
                and (not on_card or kernels_ran(
                    launches, traces, ("blockwise_quant",
                                       "flash_attention")))):
            raise AssertionError(f"run_federated with a serve store, "
                                 f"{pipeline}: {row} {traces}")
        res["runs"][pipeline] = row
        stores[pipeline] = store
    for uid in range(HANDOFF_USERS):
        for a, b in zip(tree_lib.leaves(stores["pipelined"].backing[uid]),
                        tree_lib.leaves(stores["barrier"].backing[uid])):
            if not torch.equal(a, b):
                raise AssertionError(f"user {uid}: the loop modes refreshed "
                                     "the store differently")
    trace = serve_lib.zipf_request_trace(HANDOFF_USERS, n_requests, seed=0,
                                         rate=200.0, period=1.0,
                                         amplitude=0.5)
    images = serve_lib.request_images(plane, trace, seed=0)
    rep = replay_vs_oracle(plane["frozen"], plane["ccfg"],
                           plane["class_emb"], stores["pipelined"], trace,
                           images, device)
    # the serve head has no attention (at S = 1 Att(D) is V, exactly)
    if on_card and not kernels_ran(rep["launches"], rep["traces"],
                                   ("quant_matmul", "blockwise_quant")):
        raise AssertionError(f"replay: {rep['launches']} {rep['traces']}")
    res.update(err_int8=rep["err_int8"], replay_launches=rep["launches"],
               flights=rep["rec"]["n_flights"],
               replay_store=rep["rec"]["store"])
    return res


def vit_handoff_phase(device="cuda", ccfg=VIT_B32, *, steps=5, batch=32,
                      n_clients=5, n_per_class=60, seed=0, max_entries=4,
                      n_requests=48, profile=True) -> dict:
    """Phase 11 (b): at ``ccfg``'s width (CLIP ViT-B/32) on phase 9's
    clients, the backing is ``personalized_trainables`` of one
    ``qlora_nogan`` wave (one family: ``refresh_from_global`` rebases
    every user by one global tree); a store of ``max_entries`` (int8,
    evictions) warmed by a replay; ``refresh_from_global`` before and
    after one ``FullSyncScheduler`` round, timed (host and device) with
    the launches it made; then a replay held to the oracle at the int8
    bound, and on the card profiled."""
    on_card = torch.device(device).type == "cuda"
    strat = STRATEGIES["qlora_nogan"]
    data = make_dataset("pacs", n_per_class=n_per_class, seed=seed)
    repeat = ccfg.image_size // data["images"].shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    frozen = nf4_round_trip(clip_lib.init_clip(gen, ccfg, device=device))[0]
    ce = class_embedding(frozen, ccfg, device)
    clients = fl_clients(data, n_clients, 0.5, seed, strat, repeat)
    g0 = client_lib.init_trainable(gen, ccfg, strat, device=device)
    engine = cohort_lib.CohortEngine(
        frozen=frozen, ccfg=ccfg, class_emb=ce, clients=clients,
        cfg=cohort_lib.CohortConfig(strategy=strat, local_steps=steps,
                                    batch_size=batch, lr=3e-3))
    draws = cohort_lib.SeededDraws(seed)
    _sync(device)
    t0 = time.perf_counter()
    backing = serve_lib.personalized_trainables(
        engine, g0, cohort_lib.RoundKey(draws, (2,)))
    _sync(device)
    res = {"users": len(backing), "wave_s": time.perf_counter() - t0}
    store = serve_lib.AdapterStore(dict(backing), max_entries=max_entries,
                                   quant_bits=8, device=device)
    trace = serve_lib.zipf_request_trace(len(backing), n_requests, seed=seed,
                                         rate=200.0, period=1.0,
                                         amplitude=0.5)
    pool = data["images"][np.random.RandomState(seed).randint(
        0, len(data["images"]), trace.n)]
    images = np.repeat(np.repeat(pool, repeat, axis=1), repeat, axis=2)
    warm = replay_vs_oracle(frozen, ccfg, ce, store, trace, images, device)
    if store.refresh_from_global(g0) != 0:
        raise AssertionError("the first refresh rewrote slots")
    sched = sched_lib.FullSyncScheduler(
        executor=sched_lib.CohortExec(engine),
        trace=sched_lib.uniform_trace(len(clients)), local_steps=steps)
    g1, _ = sched.step(g0, 0, cohort_lib.RoundKey(draws, (3, 0)))
    _sync(device)
    ops.reset_launch_counts()
    ops.reset_kernel_traces()
    t0 = time.perf_counter()
    n_res = store.refresh_from_global(g1)
    host_s = time.perf_counter() - t0
    _sync(device)
    res.update(refresh_host_s=host_s,
               refresh_wall_s=time.perf_counter() - t0,
               refreshed_resident=n_res,
               refresh_launches=ops.launch_counts()["blockwise_quant"],
               refresh_traces=dict(ops.KERNEL_TRACES),
               refresh_is_refetch=refetch_equal(store),
               warm_evictions=warm["rec"]["store"]["evictions"])
    rep = replay_vs_oracle(frozen, ccfg, ce, store, trace, images, device)
    res.update(err_int8=rep["err_int8"], replay_launches=rep["launches"],
               flights=rep["rec"]["n_flights"],
               replay_store=rep["rec"]["store"])
    if not (n_res == len(store) == max_entries and res["refresh_is_refetch"]
            and res["warm_evictions"] > 0 and (not on_card or (
                kernels_ran({"blockwise_quant": res["refresh_launches"]},
                            res["refresh_traces"], ("blockwise_quant",))
                and kernels_ran(rep["launches"], rep["traces"],
                                ("quant_matmul", "blockwise_quant"))))):
        raise AssertionError(f"ViT-B/32 handoff: {res} {rep['traces']}")
    if on_card and profile:
        # the device's share of a refresh: the same refresh again under
        # the profiler (the global has not moved since, so the backing
        # stays as it is and the residents re-quantize to the same rows)
        res["refresh_again"] = profile_run(
            lambda: store.refresh_from_global(g1), ("blockwise_quant",))
        res["profile"] = profile_replay(rep["engine"], trace, images)
    return res


def cli_phase(device="cuda", argv=("--adapters", "8", "--requests", "48")):
    """Phase 11 (c): ``repro_torch.launch.serve.main`` (the ``--adapters``
    mode) through its entry point; its replay's logits finite."""
    from repro_torch.launch import serve as serve_cli
    out = serve_cli.main(list(argv), device=device)
    rec = out["rec"]
    if not np.isfinite(rec["logits"]).all():
        raise AssertionError("the --adapters replay gave non-finite logits")
    return {"flights": rec["n_flights"], "lat_v_p50": rec["lat_v_p50"],
            "lat_v_p99": rec["lat_v_p99"], "wall_s": rec["wall_s"],
            "store": rec["store"]}


def load_loop_syncs():
    """``scripts/torch_loop_syncs.py`` as a module (its
    ``sync_warnings``)."""
    spec = importlib.util.spec_from_file_location("torch_loop_syncs",
                                                  LOOP_SYNCS)
    tls = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tls)
    return tls


def loop_syncs_phase(device="cuda", rounds=3) -> dict:
    """Phase 11 (d): the synchronizing calls inside the round loop of a
    fault-free sync-partial ``run_federated`` (pipelined, with a store
    refreshed every round, and barrier) from
    ``set_sync_debug_mode("warn")``, by site, beside ``SYNC_TRACES``
    (``scripts/torch_loop_syncs.py``); none may lie outside a wait that
    ``SYNC_TRACES`` charges."""
    tls = load_loop_syncs()
    store = tls.demo_store(device)
    res = {"pipelined": tls.measure(rounds=rounds, store=store,
                                    device=device),
           "barrier": tls.measure(rounds=rounds, pipeline="barrier",
                                  device=device)}
    for mode, r in res.items():
        if r["uncounted"]:
            raise AssertionError(f"{mode}: uncounted host waits in the "
                                 f"round loop: {r['uncounted_sites']}")
    if res["pipelined"]["sync_counts"] != {"metrics_flush": 1}:
        raise AssertionError(f"pipelined ledger {res['pipelined']}")
    return res


def handoff_report() -> dict:
    """Phase 11 on the card, reported. Returns its launches."""
    print(f"trainer-to-store handoff (run_federated(serve_store=), "
          f"personalized_trainables, demo_plane, --adapters), "
          f"{card_line()}:", flush=True)
    t_all = t0 = time.perf_counter()
    a = handoff_phase()
    # the phase's launches: the runs', the refresh's and the replays'
    launches = collections.Counter()
    for mode, row in a.pop("runs").items():
        report({"handoff": mode, **row})
        launches.update(row["launches"])
    launches.update(a["replay_launches"])
    report({"handoff_replay": "CLIPConfig()", **a})
    report({"handoff_a_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    b = vit_handoff_phase()
    prof = b.pop("profile", None)
    again = b.pop("refresh_again", None)
    report({"handoff_vit": "ViT-B/32", **b})
    if again is not None:
        report({"handoff_vit_refresh_profiled_" + k: v
                for k, v in again.items() if k not in ("top_ms",
                                                        "regions_ms")})
        print(f"  ViT-B/32 refresh, top device time (ms): "
              f"{again['top_ms'][:5]}", flush=True)
    launches.update({"blockwise_quant": b["refresh_launches"]})
    launches.update(b["replay_launches"])
    if prof is not None:
        report({"handoff_vit_replay_" + k: v for k, v in prof.items()
                if k != "top_us"})
        print(f"  ViT-B/32 replay after the refresh, top device time (us): "
              f"{prof['top_us']}", flush=True)
    report({"handoff_b_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    report({"handoff_cli": "--adapters 8 --requests 48", **cli_phase()})
    report({"handoff_c_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    d = loop_syncs_phase()
    for mode, r in d.items():
        report({"loop_syncs": mode, **{k: v for k, v in r.items()
                                       if k != "round_time_s"}})
    report({"handoff_d_s": time.perf_counter() - t0,
            "handoff_phase_s": time.perf_counter() - t_all,
            "card": card_line()})
    torch.cuda.empty_cache()
    return launches


# -- phase 12: token serving and the train-side pieces ------------------

# the serving CLI's token mode as phase 12 drives it: 4 streams, a prompt
# of 64, 16 tokens generated (the prefill's and 15 decode steps)
SERVE_TOKENS = dict(batch=4, prompt=64, gen=16)
# where phase 12 (d) writes its checkpoint: the gitignored build/
PHASE12_DIR = Path(__file__).resolve().parent / "build" / "phase12"


def serve_argv(arch: str) -> list:
    t = SERVE_TOKENS
    return ["--arch", arch, "--full-config", "--quant", "4", "--batch",
            str(t["batch"]), "--prompt-len", str(t["prompt"]), "--gen",
            str(t["gen"])]


def decode_step_bound(frozen, tr, cache) -> tuple:
    """(ms, "bytes") for one decode step: the layer weights, the head,
    the trainables and the cache, each read once, over the card's
    memory rate (the step's operations, 2 a weight a stream, are far
    below the bf16 peak)."""
    n = qlib.tree_bytes(frozen["layers"]) + nbytes(frozen["head"]) + \
        qlib.tree_bytes(tr) + qlib.tree_bytes(cache)
    return n / HBM_BYTES_S * 1e3, "bytes", n


def check_token_routes(cfg, G, launches, tc, traces) -> None:
    """The token mode's routes over a prefill and G - 1 decode steps: no
    plain route; a dense model's 7 projections a layer a step through
    ``lora_matmul``'s tensor-core kernel and the prefill's attention
    through ``flash_attention``'s; an SSM's prefill scans through
    ``selective_scan``; ``decode_attention`` (plain in both packages)
    once a layer a decode step plus the adapter's once a step."""
    L = cfg.n_layers
    bad = [k for k in traces if k.endswith("_ref")]
    if bad:
        raise AssertionError(f"{cfg.name} serving took plain routes: {bad}")
    want = {"decode_attention_plain": 1 + (G - 1) * (
        (L if cfg.family == "dense" else 0) + 1)}
    if cfg.family == "dense":
        n = DENSE_LORA_LINEARS * L * G
        want.update(lora_matmul_cuda_tc=n, flash_attention_cuda_tc=L)
        ok = launches["lora_matmul"] == tc["lora_matmul"] == n and \
            launches["flash_attention"] == L
    else:
        want.update(selective_scan_cuda=L)
        ok = launches["selective_scan"] == L
    if not ok or {k: traces.get(k, 0) for k in want} != want:
        raise AssertionError(f"{cfg.name}: launches {launches}, tensor-core "
                             f"{tc}, traces {traces}; want {want}")


def token_serve_phase(arch: str, device="cuda") -> dict:
    """Phase 12 (a) / (b): ``repro_torch.launch.serve.main`` in its token
    mode on ``arch`` at full width and depth with an NF4 backbone
    (``serve_argv``), the launch counts zeroed just before and read right
    after. Yi-9B: every projection through ``lora_matmul``'s tensor-core
    kernel (7 x 48 a step: the prefill's and each decode step's), the
    prefill's 48 attentions through ``flash_attention``'s; Falcon-Mamba:
    the prefill's 64 scans through ``selective_scan``. No plain route.
    Then, from a fresh prefill: one decode step profiled (device busy,
    idle share, top entries, device ms by region, ``decode_attention``'s
    included), and the decode loop (``serve.decode_loop``) run again
    under ``set_sync_debug_mode("warn")``: no synchronizing call may come
    from inside it."""
    from repro_torch.launch import serve as serve_cli
    t = SERVE_TOKENS
    B, P, G = t["batch"], t["prompt"], t["gen"]
    cfg = get_config(arch)
    L = cfg.n_layers
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    out = serve_cli.main(serve_argv(arch), device=device)
    launches = ops.launch_counts()
    tc = ops.tc_launch_counts()
    traces = dict(ops.KERNEL_TRACES)
    toks = out["tokens"]
    if toks.shape != (B, G) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{arch}: tokens {toks.shape} out of range")
    on_card = torch.device(device).type == "cuda"
    if on_card:                 # a rehearsal on the CPU takes plain routes
        check_token_routes(cfg, G, launches, tc, traces)
    res = {"arch": arch, "layers": L, "tokens_row0": toks[0, :8].tolist(),
           "prefill_ms": out["prefill_s"] * 1e3,
           "prefill_tok_s": B * P / out["prefill_s"],
           "decode_ms_per_token": out["decode_s"] / (G - 1) * 1e3,
           "decode_tok_s": B * (G - 1) / out["decode_s"],
           "launches": launches, "traces": traces}
    model, params, prompt = out["model"], out["params"], out["prompt"]
    frozen, tr = params["frozen"], params["trainable"]
    del out

    def fresh():
        logits, cache = model.prefill(frozen, tr, {"tokens": prompt},
                                      max_len=P + G)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        return cache, tok, torch.full((), P, dtype=torch.int32,
                                      device=device)

    _sync(device)
    t0 = time.perf_counter()
    cache, tok, pos = fresh()           # warm: the CLI's was the first call
    _sync(device)
    res["prefill_warm_ms"] = (time.perf_counter() - t0) * 1e3
    res["bound_ms"], res["bound_by"], res["bound_bytes"] = \
        decode_step_bound(frozen, tr, cache)
    if not on_card:
        return res
    prof = profile_run(lambda: model.decode_step(frozen, tr, cache, tok, pos),
                       ("lora_matmul",) if cfg.family == "dense" else
                       ("selective_scan",))
    res["profile"] = prof
    res["decode_attention_ms"] = dict(prof["regions_ms"]).get(
        "decode_attention", 0.0)
    cache, tok, pos = fresh()
    tls = load_loop_syncs()
    torch.cuda.synchronize()
    with tls.sync_warnings() as stacks:
        serve_cli.decode_loop(model, frozen, tr, cache, tok, pos, G - 1,
                              greedy=True)
        torch.cuda.synchronize()
    loop = [st for st in stacks if any(
        f.name == "decode_loop" and f.filename.endswith("serve.py")
        for f in st)]
    res["syncs_in_decode_loop"] = len(loop)
    res["syncs_outside_loop"] = len(stacks) - len(loop)
    if loop:
        where = collections.Counter(f"{Path(st[-1].filename).name}:"
                                    f"{st[-1].lineno}" for st in loop)
        raise AssertionError(f"{arch}: {len(loop)} synchronizing calls "
                             f"inside the decode loop: {dict(where)}")
    del model, params, frozen, tr, cache
    torch.cuda.empty_cache()
    return res


def decode_check_phase(arch: str, *, n_layers=2, prompt=64, steps=8,
                       seed=0, device="cuda", **replace) -> dict:
    """Phase 12 (c): ``Model.prefill`` of 4 x ``prompt`` tokens and
    ``steps`` decode steps on the card (through the kernels) and on the
    CPU (the plain versions) on the same weights and the same tokens
    (numpy from ``seed``; the decode steps fed the same tokens on both
    sides): ``arch`` with an NF4 backbone at full width with ``n_layers``
    layers, or at its reduced config (``n_layers=None``), with
    ``replace``. The logits of every step agree within 2e-2 of the
    largest in bf16 (the step checks' bound) and 1e-4 in fp32; with an
    int8 KV cache the decode steps within 5e-2, the JAX package's bound
    for int8 against fp KV (tests/test_perf_features.py): a K/V element
    at a rounding boundary can take codes one step apart on the two
    devices, which moves it by its row's scale, as much as the int8
    rounding error itself."""
    cfg = (get_config(arch).replace(n_layers=n_layers) if n_layers else
           get_reduced(arch)).replace(**CLI_NF4, **replace)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init_params(gen, device=device)
    frozen = params["frozen"]
    tr = perturbed(params["trainable"], gen, device)
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (4, prompt + steps)).astype(np.int32)
    tol = 2e-2 if cfg.dtype == "bfloat16" else 1e-4
    step_tol = 5e-2 if cfg.kv_quant_bits == 8 else tol

    def run(f, t, dev):
        tk = torch.as_tensor(toks, device=dev)
        logits, cache = model.prefill(f, t, {"tokens": tk[:, :prompt]},
                                      max_len=prompt + steps)
        out = [logits.float().cpu()]
        for i in range(steps):
            logits, cache = model.decode_step(
                f, t, cache, tk[:, prompt + i:prompt + i + 1],
                torch.full((), prompt + i, dtype=torch.int32, device=dev))
            out.append(logits.float().cpu())
        return out

    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = run(frozen, tr, device)
    _sync(device)
    card_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    traces = dict(ops.KERNEL_TRACES)
    bad = [k for k in traces if k.endswith("_ref")]
    if bad and torch.device(device).type == "cuda":
        raise AssertionError(f"{arch} card decode took plain routes: {bad}")
    t0 = time.perf_counter()
    cpu = run(convert.tree_to(frozen, "cpu"), convert.tree_to(tr, "cpu"),
              "cpu")
    cpu_s = time.perf_counter() - t0
    errs = [rel_err(a, b)[1] for a, b in zip(card, cpu)]
    res = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "window": cfg.window, "kv_quant_bits": cfg.kv_quant_bits,
           "steps": steps, "prefill_rel": errs[0],
           "worst_step_rel": max(errs[1:]), "tol": tol,
           "step_tol": step_tol, "card_s": card_s, "cpu_s": cpu_s,
           "launches": launches}
    if cfg.window and prompt + steps <= cfg.window:
        raise AssertionError("the ring must wrap: prompt + steps > window")
    if not (errs[0] <= tol and max(errs[1:]) <= step_tol):
        raise AssertionError(f"decode card vs CPU: {res}, per step {errs}")
    del params, frozen, tr
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def train_side_phase(device="cuda") -> dict:
    """Phase 12 (d): the trainer's ``--ckpt`` at its reduced config on the
    card, 2 rounds then a run to 3 that resumes, bitwise 3 straight
    rounds; and one ``train_step`` with ``grad_accum=4`` against
    ``grad_accum=1`` on the same 4 x 16 tokens (NF4 backbone), within
    tests/test_perf_features.py's bounds (loss 1e-3, trainables 5e-3)."""
    import shutil
    args = ["--rounds", "2", "--clients", "2", "--local-steps", "2"]
    shutil.rmtree(PHASE12_DIR, ignore_errors=True)
    ck = str(PHASE12_DIR / "fl.npz")
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        train_lib.main(args + ["--ckpt", ck], device=device)
        args[1] = "3"
        resumed = train_lib.main(args + ["--ckpt", ck], device=device)
        straight = train_lib.main(args, device=device)
    launches = ops.launch_counts()
    shutil.rmtree(PHASE12_DIR, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(resumed), tree_lib.leaves(straight)))
    if not same:
        raise AssertionError("the resumed trainer differs from the "
                             "straight run")
    cfg = get_reduced("yi-9b").replace(**CLI_NF4)
    m1, m4 = build_model(cfg), build_model(cfg.replace(grad_accum=4))
    params = m1.init_params(torch.Generator(device=device).manual_seed(0),
                            device=device)
    tr = perturbed(params["trainable"],
                   torch.Generator(device=device).manual_seed(1), device)
    toks = train_lib.synthetic_token_stream(
        np.random.RandomState(0), cfg.vocab_size, 1, docs_per_client=4,
        seq=16)[0]
    batch = train_lib.make_batch(toks, device)
    opt = optim.adam_init(tr)
    ops.reset_launch_counts()
    tr1, _, a = m1.train_step(params["frozen"], tr, opt, batch)
    tr4, _, b = m4.train_step(params["frozen"], tr, opt, batch)
    for k, v in ops.launch_counts().items():
        launches[k] += v
    loss_d = abs(float(a["loss"]) - float(b["loss"]))
    leaf_d = max(float((x - y).abs().max()) for x, y in zip(
        tree_lib.leaves(tr1), tree_lib.leaves(tr4)))
    if not (loss_d < 1e-3 and leaf_d < 5e-3):
        raise AssertionError(f"grad_accum=4 vs 1: loss {loss_d}, leaves "
                             f"{leaf_d}")
    return {"resume_bitwise": same, "grad_accum_loss_diff": loss_d,
            "grad_accum_leaf_diff": leaf_d, "launches": launches}


def token_serve_report() -> collections.Counter:
    """Phase 12 on the card, reported. Returns its launches."""
    print(f"token serving (launch/serve.py token mode, prefill + decode, "
          f"ring KV / SSM caches) and the train-side pieces, "
          f"{card_line()}:", flush=True)
    launches = collections.Counter()
    t_all = time.perf_counter()
    for arch in ("yi-9b", "falcon-mamba-7b"):
        t0 = time.perf_counter()
        res = token_serve_phase(arch)
        launches.update(res.pop("launches"))
        prof = res.pop("profile")
        report({"serve_tokens": arch, **res})
        report_profile("decode_step", prof)
        report({"serve_tokens_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    for arch, kw in (("yi-9b", dict(n_layers=1)),
                     ("falcon-mamba-7b", dict(n_layers=1)),
                     ("h2o-danube-3-4b", dict(n_layers=None, steps=32,
                                              kv_quant_bits=8))):
        res = decode_check_phase(arch, **kw)
        launches.update(res.pop("launches"))
        report({"decode_card_vs_cpu": arch, **res})
    report({"decode_check_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    res = train_side_phase()
    launches.update(res.pop("launches"))
    report({"train_side": "--ckpt resume, grad_accum=4", **res,
            "train_side_s": time.perf_counter() - t0})
    report({"phase12_s": time.perf_counter() - t_all, "card": card_line()})
    torch.cuda.empty_cache()
    return launches


# -- phase 13: the zoo's hybrid, MoE, encdec and VLM families ----------

# the zoo's configurations at full width (phase 13): RecurrentGemma-2B
# (arXiv:2402.19427), Qwen3-MoE-235B-A22B (hf:Qwen/Qwen3-30B-A3B config
# shape), Whisper-medium (arXiv:2212.04356), LLaVA-NeXT-34B
# (hf:llava-hf/llava-v1.6-mistral-7b-hf); Qwen3's depth is cut to fit one
# card (NF4 is about 1.4 GB a layer) and the script's time, LLaVA's to
# half (60 -> 30) to make room in the script's time for phase 15
QWEN_LAYERS = 4
LLAVA_LAYERS = 30
ZOO_KERNELS = {
    "recurrentgemma-2b": TRAIN_KERNELS["recurrentgemma-2b"],
    "qwen3-moe-235b-a22b": TRAIN_KERNELS["qwen3-moe-235b-a22b"],
    "whisper-medium": ("lora_matmul", "quant_matmul_t", "flash_attention",
                       "quant_matmul"),
    "llava-next-34b": ("lora_matmul", "quant_matmul_t", "flash_attention"),
}
# phase 2 (f): flash_attention at the zoo's shapes,
# (name, B, S, Skv, H, Hkv, D, causal, window, dtype)
FLASH_ZOO = [
    ("llava_adapter_d896_bf16", 4, 640, 640, 8, 8, 896, True, None,
     torch.bfloat16),
    ("llava_adapter_d896_fp32", 4, 640, 640, 8, 8, 896, True, None,
     torch.float32),
    ("whisper_cross_skv1500", 4, 64, 1500, 16, 16, 64, False, None,
     torch.bfloat16),
    ("whisper_encoder", 4, 1500, 1500, 16, 16, 64, False, None,
     torch.bfloat16),
    ("rgemma_mqa_w2048", 4, 64, 64, 10, 1, 256, True, 2048, torch.bfloat16),
]


def check_flash_zoo(gen) -> list:
    """Phase 2 (f): ``flash_attention`` at the zoo's shapes against its
    plain version: the LLaVA-NeXT-34B adapter at D = 896 in both dtypes
    (the single-stage tensor-core path and the BK = 16 CUDA-core path),
    Whisper's cross-attention to 1500 frames and its encoder (neither
    causal), RecurrentGemma's MQA (10 query heads a KV head) under its
    2048 window. Each row: the errors, device / call / plain ms, every
    SDPA backend (the fastest is ``library_ms``; the window of 2048
    covers the whole 64-token sequence, so causal SDPA is the same
    function) and the bound."""
    rows = []
    for name, B, S, Skv, H, Hkv, D, causal, window, dt in FLASH_ZOO:
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Skv, Hkv, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Skv, Hkv, D), generator=gen, device="cuda").to(dt)
        run = lambda: fa_kernel.flash_attention(q, k, v, causal=causal,
                                                window=window)
        got, route = routed(fa_kernel.flash_attention, run)
        plain = lambda: ref.flash_attention(q, k, v, causal=causal,
                                            window=window)
        want = plain()
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, want)
        tol = _tol(dt) if dt == torch.bfloat16 else 1e-5
        if not (rel_e <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {name}: rel err {rel_e}")
        want_route = "tensor cores" if dt == torch.bfloat16 else "cuda cores"
        if route != want_route:
            raise AssertionError(f"flash_attention {name}: took {route}")
        pairs = _valid_pairs(S, Skv, causal, window)
        b_ms, b_by = bound(nbytes(q, k, v, got), 4.0 * B * H * D * pairs, dt)
        row = {"case": name, "route": route, "max_abs_err": abs_e,
               "rel_err": rel_e, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        timed(row, "ms", run)
        timed(row, "plain_ms", plain)
        G = H // Hkv
        qt_, kt_, vt_ = (t.transpose(1, 2).contiguous() for t in (
            q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
        if window is None or window >= S:
            time_sdpa_backends(row, qt_, kt_, vt_, causal)
        report({"flash_attention": 1, **row})
        rows.append(row)
        del q, k, v, got, want, qt_, kt_, vt_
    torch.cuda.empty_cache()
    return rows


# phase 2 (g): quant_matmul and its dx at the zoo's projections without
# LoRA (NF4 block 64), (name, M, K, N, dtype, with a backward)
QMM_ZOO = [
    ("rgemma_mlp_wg_wu", 256, 2560, 7680, torch.bfloat16, True),
    ("rgemma_mlp_wd", 256, 7680, 2560, torch.bfloat16, True),
    ("rgemma_decode_wg_wu", 4, 2560, 7680, torch.bfloat16, False),
    ("rgemma_decode_wd", 4, 7680, 2560, torch.bfloat16, False),
    ("whisper_enc_wu", 6000, 1024, 4096, torch.bfloat16, True),
    ("whisper_enc_wd", 6000, 4096, 1024, torch.bfloat16, True),
    ("kimi_reduced_dense_wg_wu", 32, 256, 512, torch.float32, True),
    ("kimi_reduced_dense_wd", 32, 512, 256, torch.float32, True),
]


def check_quant_matmul_zoo(gen) -> list:
    """Phase 2 (g): ``quant_matmul`` where phase 13 runs it, a frozen NF4
    projection without LoRA: RecurrentGemma's MLP in a training step or a
    prefill (4 x 64 rows) and in a decode step (4 rows), Whisper's encoder
    MLP over 4 x 1500 frames, and Kimi-K2's reduced dense layer in fp32.
    The forward (the kernel) is held against the plain version, and where
    the path takes a gradient, ``ops.quant_matmul``'s dx (``_QuantMatmul``,
    whose backward is the ``quant_matmul_t`` kernel) against autograd of
    the plain version, both at ``check_quant_matmul``'s bounds (bf16
    1.6e-2 of the largest magnitude, fp32 1e-5). Each kernel's row gives
    device, call and plain ms and the bound; no single PyTorch call
    computes either from the quantized payload (library_ms null)."""
    dev, f32 = "cuda", torch.float32
    rows = []
    for name, M, K, N, dt, backward in QMM_ZOO:
        w = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
             ).to(torch.bfloat16)
        qt = ref.blockwise_quant(w, bits=4, block=64, mode="nf4")
        x = torch.randn((M, K), generator=gen, device=dev).to(dt)
        g = torch.randn((M, N), generator=gen, device=dev).to(dt)
        Kq = qt.q.shape[-3] * qt.block
        tol = 1e-5 if dt == f32 else 1.6e-2
        fwd = lambda: qmm_kernel.quant_matmul(x, qt)
        got, route = qmm_route(fwd)
        want = ref.quant_matmul(x, qt)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, want)
        if not (rel_e <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"quant_matmul {name}: rel err {rel_e} > {tol}")
        b_ms, b_by = bound(nbytes(x, qt.q, qt.scales, got),
                           2.0 * M * Kq * N, dt)
        row = {"case": name, "route": route, "max_abs_err": abs_e,
               "rel_err": rel_e, "tol": tol, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        timed(row, "ms", fwd)
        timed(row, "plain_ms", lambda: ref.quant_matmul(x, qt))
        report({"quant_matmul": 1, **row})
        rows.append(row)
        if not backward:
            continue
        ops.reset_kernel_traces()
        dx = {}
        for side, fn in (("kernel", ops.quant_matmul),
                         ("plain", ref.quant_matmul)):
            xr = x.detach().requires_grad_(True)
            with torch.enable_grad():
                dx[side], = torch.autograd.grad(fn(xr, qt), xr, g)
        torch.cuda.synchronize()
        tc = dt == torch.bfloat16
        want_trace = "quant_matmul_t_cuda_tc" if tc else "quant_matmul_t_cuda"
        if ops.KERNEL_TRACES.get(want_trace, 0) != 1:
            raise AssertionError(f"quant_matmul {name}: the dx took "
                                 f"{dict(ops.KERNEL_TRACES)}")
        abs_e, rel_e = rel_err(dx["kernel"], dx["plain"])
        if not (rel_e <= tol and torch.isfinite(dx["kernel"]).all()):
            raise AssertionError(f"quant_matmul {name} dx: rel err {rel_e} "
                                 f"> {tol}")
        gk = g if tc else g.float()
        run = lambda: lm_kernel.quant_matmul_t(gk, qt, out_dtype=f32)
        dxw = run()
        b_ms, b_by = bound(nbytes(gk, qt.q, qt.scales, dxw),
                           2.0 * M * Kq * N, gk.dtype)
        row = {"case": name + "_dx", "route": "tensor cores" if tc
               else "cuda cores", "max_abs_err": abs_e, "rel_err": rel_e,
               "tol": tol, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        timed(row, "ms", run)
        timed(row, "plain_ms",
              lambda: ref.quant_matmul_t(gk, qt, out_dtype=f32))
        report({"quant_matmul_t": 1, **row})
        rows.append(row)
        del dx, dxw
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def cut_depth(module, arch: str, n_layers):
    """``module.get_config(arch)`` with its depth cut to ``n_layers``
    (None: as it is), for a CLI that builds the full config itself."""
    orig = module.get_config
    if n_layers:
        module.get_config = lambda a: orig(a).replace(n_layers=n_layers) \
            if a == arch else orig(a)
    try:
        yield
    finally:
        module.get_config = orig


@contextlib.contextmanager
def moe_routes(record_ids: bool = False):
    """Count the MoE's kept and dropped token-copies (device sums, read
    at the end) and, with ``record_ids``, keep every call's expert ids
    and slots, by wrapping ``models.moe``'s ``_route`` and
    ``_slot_assignment`` (which ``_moe_local`` looks up at call time)."""
    from repro_torch.models import moe as moe_lib
    route, slots = moe_lib._route, moe_lib._slot_assignment
    rec = {"kept": [], "copies": 0, "ids": [], "slots": []}

    def rec_route(*a, **k):
        out = route(*a, **k)
        if record_ids:
            rec["ids"].append(out[1].detach().clone())
        return out

    def rec_slots(ids_flat, E, C):
        out = slots(ids_flat, E, C)
        rec["kept"].append(out[3].sum())
        rec["copies"] += out[3].numel()
        if record_ids:
            rec["slots"].append(torch.where(out[3], out[2], -1).clone())
        return out

    moe_lib._route, moe_lib._slot_assignment = rec_route, rec_slots
    try:
        yield rec
    finally:
        moe_lib._route, moe_lib._slot_assignment = route, slots


def zoo_token_phase(arch: str, device="cuda", n_layers=None) -> dict:
    """Phase 13, token mode: ``repro_torch.launch.serve.main`` on
    ``arch`` at full width (depth cut to ``n_layers`` when given), NF4
    (``serve_argv``), the launch counts zeroed just before and read right
    after; no plain route, every kernel of the family's path launched,
    the bf16 ones on tensor cores. Then from a fresh prefill one decode
    step profiled (device busy, idle share, the top entries, device ms by
    region) beside its bound. Returns the record and what the trainer
    needs (the model and its weights)."""
    from repro_torch.launch import serve as serve_cli
    B, G = SERVE_TOKENS["batch"], SERVE_TOKENS["gen"]
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with cut_depth(serve_cli, arch, n_layers), \
            contextlib.redirect_stdout(sys.stderr):
        out = serve_cli.main(serve_argv(arch), device=device)
    wall = time.perf_counter() - t0
    launches, tc = path_launches(), ops.tc_launch_counts()
    traces = dict(ops.KERNEL_TRACES)
    model = out["model"]
    cfg = model.cfg
    toks = out["tokens"]
    if toks.shape != (B, G) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{arch}: tokens {toks.shape} out of range")
    on_card = torch.device(device).type == "cuda"
    serve_kernels = ("lora_matmul", "flash_attention") + (
        ("quant_matmul",) if cfg.family in ("hybrid", "encdec") else ())
    if on_card:
        bad = [k for k in traces if k.endswith("_ref")]
        miss = [k for k in serve_kernels + (
            ("quant_matmul_tc",) if "quant_matmul" in serve_kernels else ())
            if launches[k] < 1]
        not_tc = [k for k in ("lora_matmul", "flash_attention")
                  if tc[k] != launches[k]]
        if bad or miss or not_tc:
            raise AssertionError(f"{arch} token mode: plain routes {bad}, "
                                 f"no launch of {miss}, off the tensor "
                                 f"cores {not_tc}; {launches} {traces}")
    res = {"arch": arch, "layers": cfg.n_layers, "wall_s": wall,
           "tokens_row0": toks[0, :8].tolist(),
           "prefill_ms": out["prefill_s"] * 1e3,
           "decode_ms_per_token": out["decode_s"] / (G - 1) * 1e3,
           "decode_tok_s": B * (G - 1) / out["decode_s"],
           "launches": launches, "traces": traces}
    params = out["params"]
    frozen, tr = params["frozen"], params["trainable"]
    batch, max_len = out["batch"], out["max_len"]
    pos = torch.full((), out["pos0"], dtype=torch.int32, device=device)
    del out
    logits, cache = model.prefill(frozen, tr, batch, max_len=max_len)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    res["bound_ms"], res["bound_by"], res["bound_bytes"] = \
        decode_step_bound(frozen, tr, cache)
    if on_card:
        prof = profile_run(
            lambda: model.decode_step(frozen, tr, cache, tok, pos),
            serve_kernels)
        res["profile"] = prof
    del cache, logits
    return res, model, params


def zoo_train_phase(arch: str, model, params, device="cuda") -> dict:
    """Phase 13 (a) / (b): ``train_phase`` on the token mode's model and
    weights, 1 round x 2 clients x 2 local steps of 4 x 64 tokens; for
    the MoE the share of token-copies dropped at its capacity factor."""
    with moe_routes() as rec:
        res = train_phase(arch=arch, rounds=1, clients=2, steps=2,
                          n_layers=model.cfg.n_layers, params=params,
                          device=device)
    if rec["copies"]:
        res["moe_copies"] = rec["copies"]
        res["moe_dropped_share"] = 1.0 - float(
            torch.stack(rec["kept"]).sum()) / rec["copies"]
    return res


def zoo_batch(cfg, device, *, batch=4, seq=64, seed=0) -> dict:
    """A training batch of ``batch`` x ``seq`` tokens (the trainer's
    synthetic stream) with the family's inputs: Whisper's frames (B,
    1500, d); LLaVA's image embeddings (B, 576, d) before the tokens,
    the labels and mask spanning both (the patches masked out). Seeded
    numpy, 0.02 x N(0, 1) as the serve CLI draws them."""
    toks = train_lib.synthetic_token_stream(
        np.random.RandomState(seed), cfg.vocab_size, 1,
        docs_per_client=batch, seq=seq)[0]
    b = train_lib.make_batch(toks, device)
    rs = np.random.RandomState(seed + 1)
    if cfg.family == "encdec":
        b["frames"] = torch.as_tensor(
            (rs.randn(batch, cfg.n_frames, cfg.d_model) * 0.02).astype(
                np.float32), device=device)
    if cfg.family == "vlm":
        P = cfg.n_patches
        b["image_embeds"] = torch.as_tensor(
            (rs.randn(batch, P, cfg.d_model) * 0.02).astype(np.float32),
            device=device)
        pad = torch.zeros((batch, P), dtype=b["labels"].dtype, device=device)
        b["labels"] = torch.cat([pad, b["labels"]], 1)
        b["mask"] = torch.cat([pad.to(torch.float32), b["mask"]], 1)
    return b


def zoo_step_phase(arch: str, model, params, device="cuda",
                   steps=2) -> dict:
    """Phase 13 (c) / (d): ``Model.train_step`` on ``zoo_batch`` (4 x 64
    tokens, Whisper's frames, LLaVA's 576 patches), ``steps`` Adam steps
    from the token mode's weights, the launch counts zeroed just before
    and read right after: finite losses, no plain route, every kernel of
    the family's path launched, the bf16 ones on tensor cores and
    ``quant_matmul_t`` ``qmt_per_step`` times a step. On the card an
    encoder-decoder's third step runs under the profiler (device busy,
    idle share, top entries by region)."""
    cfg = model.cfg
    frozen, tr = params["frozen"], params["trainable"]
    b = zoo_batch(cfg, device)
    opt = optim.adam_init(tr)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        tr, opt, m = model.train_step(frozen, tr, opt, b, lr=1e-3)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    launches, tc = path_launches(), ops.tc_launch_counts()
    traces = dict(ops.KERNEL_TRACES)
    kernels = ZOO_KERNELS[arch]
    want_qmt = qmt_per_step(cfg) * steps
    bad = [k for k in traces if k.endswith("_ref")]
    miss = [k for k in kernels + (("quant_matmul_tc",) if "quant_matmul"
                                  in kernels else ()) if launches[k] < 1]
    not_tc = [k for k in tc if k in kernels and tc[k] != launches[k]]
    if not np.all(np.isfinite(losses)) or (on_card and (
            bad or miss or not_tc or
            traces.get("quant_matmul_t_cuda_tc", 0) != want_qmt)):
        raise AssertionError(
            f"{arch} train_step: losses {losses}, plain routes {bad}, no "
            f"launch of {miss}, off the tensor cores {not_tc}, "
            f"quant_matmul_t {traces.get('quant_matmul_t_cuda_tc')} (want "
            f"{want_qmt}); {launches}")
    prof = None
    if on_card and cfg.family == "encdec":   # one more step, profiled
        prof = profile_run(lambda: model.train_step(frozen, tr, opt, b,
                                                    lr=1e-3), kernels)
    return {"arch": arch, "layers": cfg.n_layers, "profile": prof,
            "rows": int(b["mask"].numel()), "losses": losses,
            "s_per_step": walls, "launches": launches, "traces": traces,
            "max_memory_allocated": torch.cuda.max_memory_allocated()
            if on_card else None}


def _to_fp32(tree):
    """``tree`` with every floating tensor in fp32 and every QTensor
    decoding to fp32 (payloads unchanged): the same weights for an fp32
    model."""
    def f(leaf):
        if isinstance(leaf, qlib.QTensor):
            return dataclasses.replace(leaf, out_dtype=torch.float32)
        return leaf.float() if leaf.is_floating_point() else leaf
    return tree_lib.tree_map(f, tree)


def zoo_cut_check(arch: str, n_layers: int, *, batch=4, seq=64, seed=0,
                  device="cuda", **replace) -> dict:
    """Phase 13 (e), full width: ``arch`` in bf16 with an NF4 backbone,
    cut to ``n_layers`` (and ``replace``), on seeded weights (trainables
    perturbed) and phase 4's 4 x 64 tokens, one forward and its backward
    and one Adam step (lr 1e-3) on each of three sides: on the card
    through the kernels, on the CPU through the plain versions, and on
    the CPU in fp32 on the same weights (the witness). The card against
    the CPU: the logits within 2e-2 of the largest, the loss within 1e-3
    and the gradients' global norm within 2e-2 (phase 4's bounds). Each
    gradient leaf and each trainable leaf after the step: its distance to
    the fp32 witness in norm, ||x - x32|| / ||x32||, on the card within
    2e-2 (phase 4's bound) or within twice the CPU's own bf16 distance,
    whichever is larger; the two leaves behind the adapter's ReLU are
    reported only, as phase 4 reports them. bf16 rounding of the
    backbone's output moves a leaf away from fp32 on both devices alike
    (the adapter's attention projections take their gradient through the
    softmax's cancellation: 2-3% card against CPU), so the witness tells
    it from a kernel's fault, which moves the card alone. Remat is off on
    every side: it changes no number and saves the CPU a forward."""
    cfg = get_config(arch).replace(n_layers=n_layers, remat=False,
                                   **CLI_NF4, **replace)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init_params(gen, device=device)
    frozen = params["frozen"]
    tr = perturbed(params["trainable"], gen, device)
    b = zoo_batch(cfg, device, batch=batch, seq=seq, seed=seed)
    out = {}
    for side, dev in (("card", device), ("cpu", "cpu"), ("fp32", "cpu")):
        f, t = (frozen, tr) if side == "card" else (
            convert.tree_to(frozen, "cpu"), convert.tree_to(tr, "cpu"))
        m = model
        if side == "fp32":
            f, t = _to_fp32(f), _to_fp32(t)
            m = build_model(cfg.replace(dtype="float32"))
        bb = {k: v.to(dev) for k, v in b.items()}
        ops.reset_kernel_traces()
        t0 = time.perf_counter()
        live = tree_lib.tree_map(lambda l: l.detach().requires_grad_(True), t)
        with torch.enable_grad():
            logits, aux = m.forward(f, live, bb)
            loss = losses.cross_entropy(logits, bb["labels"], bb["mask"]) \
                + 0.01 * aux
            g = tree_lib.from_leaves(live, torch.autograd.grad(
                loss, tree_lib.leaves(live)))
        t2, _ = optim.adam_update(g, optim.adam_init(t), t, lr=1e-3,
                                  grad_clip=1.0)
        _sync(dev)
        out[side] = dict(logits=logits.detach().float().cpu(),
                         loss=float(loss.detach()), grads=g, tr=t2,
                         s=time.perf_counter() - t0,
                         traces=dict(ops.KERNEL_TRACES))
        del live, logits
    card, cpu, w32 = out["card"], out["cpu"], out["fp32"]
    bad = [k for k in card["traces"] if k.endswith("_ref")]
    if bad and torch.device(device).type == "cuda":
        raise AssertionError(f"{arch} card step took plain routes: {bad}")
    gn_card = float(optim.global_norm(card["grads"]))
    gn_cpu = float(optim.global_norm(cpu["grads"]))
    res = {"arch": arch, "layers": n_layers, "dtype": cfg.dtype,
           "rows": int(b["mask"].numel()),
           "logits_rel": rel_err(card["logits"], cpu["logits"])[1],
           "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "grad_norm_rel": abs(gn_card - gn_cpu) / gn_cpu,
           "logits_rel_fp32": {s: rel_err(out[s]["logits"], w32["logits"])[1]
                               for s in ("card", "cpu")}}
    failed = []
    for what in ("grads", "tr"):
        e_card = _leaf_norm_errs(card[what], w32[what])
        e_cpu = _leaf_norm_errs(cpu[what], w32[what])
        held = {k: (e_card[k], e_cpu[k], max(2e-2, 2 * e_cpu[k]))
                for k in e_card if k not in RELU_GATED}
        worst = max(held, key=lambda k: held[k][0] / held[k][2])
        failed += [f"{what} {k} {v}" for k, v in held.items() if v[0] > v[2]]
        res[f"{what}_worst_held_leaf"] = worst
        res[f"{what}_worst_held_leaf_card_cpu_bound"] = held[worst]
        res[f"{what}_relu_gated_card_cpu"] = {k: (e_card[k], e_cpu[k])
                                              for k in RELU_GATED}
        res[f"{what}_leaf_to_fp32_card_cpu"] = {
            k: (round(e_card[k], 5), round(e_cpu[k], 5)) for k in e_card}
    res.update(card_s=card["s"], cpu_s=cpu["s"], fp32_s=w32["s"])
    if not (res["logits_rel"] <= 2e-2 and res["loss_rel"] <= 1e-3 and
            res["grad_norm_rel"] <= 2e-2) or failed:
        raise AssertionError(f"{arch} full-width cut card vs CPU: {failed} "
                             f"{res}")
    del params, frozen, tr, out
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def zoo_reduced_check(arch: str, *, prompt=12, steps=4, seed=0,
                      device="cuda") -> dict:
    """Phase 13 (e), reduced: ``arch``'s reduced fp32 config (TF32 off)
    on seeded weights on the card and on the CPU: the forward's logits,
    the grads and one Adam step's trainables, a prefill of ``prompt``
    tokens and ``steps`` decode steps, all within 1e-4 of the largest
    magnitude (a leaf in norm); for the MoE the expert ids and the kept
    slots of every routing call equal."""
    cfg = get_reduced(arch)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init_params(gen, device=device)
    tr0 = perturbed(params["trainable"], gen, device)
    b = zoo_batch(cfg, device, batch=2, seq=prompt + steps, seed=seed)
    off = cfg.n_patches if cfg.family == "vlm" else 0
    out = {}
    for side, dev in (("card", device), ("cpu", "cpu")):
        f, t = (params["frozen"], tr0) if side == "card" else (
            convert.tree_to(params["frozen"], "cpu"),
            convert.tree_to(tr0, "cpu"))
        bb = {k: v.to(dev) for k, v in b.items()}
        ops.reset_kernel_traces()
        with moe_routes(record_ids=True) as rec:
            with torch.no_grad():
                logits, aux = model.forward(f, t, bb)
            (loss, _), g = model.grads(f, t, bb)
            t2, _ = optim.adam_update(g, optim.adam_init(t), t, lr=1e-3,
                                      grad_clip=1.0)
            pre = {k: v for k, v in bb.items()
                   if k in ("image_embeds", "frames")}
            pre["tokens"] = bb["tokens"][:, :prompt]
            lg, cache = model.prefill(f, t, pre,
                                      max_len=off + prompt + steps)
            dec = [lg.cpu()]
            for i in range(steps):
                lg, cache = model.decode_step(
                    f, t, cache, bb["tokens"][:, prompt + i:prompt + i + 1],
                    torch.full((), off + prompt + i, dtype=torch.int32,
                               device=dev))
                dec.append(lg.cpu())
        out[side] = dict(logits=logits.cpu(), loss=float(loss), grads=g,
                         tr=t2, dec=dec, traces=dict(ops.KERNEL_TRACES),
                         ids=[x.cpu() for x in rec["ids"]],
                         slots=[x.cpu() for x in rec["slots"]])
    card, cpu = out["card"], out["cpu"]
    bad = [k for k in card["traces"] if k.endswith("_ref")]
    if bad and torch.device(device).type == "cuda":
        raise AssertionError(f"{arch} reduced card run took plain routes: "
                             f"{bad}")
    g_err = _leaf_norm_errs(card["grads"], cpu["grads"])
    t_err = _leaf_norm_errs(card["tr"], cpu["tr"])
    dec_err = [rel_err(a, c)[1] for a, c in zip(card["dec"], cpu["dec"])]
    routes_equal = len(card["ids"]) == len(cpu["ids"]) and all(
        torch.equal(a, c) for a, c in zip(card["ids"] + card["slots"],
                                          cpu["ids"] + cpu["slots"]))
    res = {"arch": cfg.name, "logits_rel":
           rel_err(card["logits"], cpu["logits"])[1],
           "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "worst_grad_norm_rel": max(g_err.values()),
           "worst_trainable_norm_rel": max(t_err.values()),
           "prefill_rel": dec_err[0], "worst_decode_rel": max(dec_err[1:]),
           "routing_calls": len(card["ids"]), "routes_equal": routes_equal}
    if not (max(res["logits_rel"], res["loss_rel"], res["prefill_rel"],
                res["worst_decode_rel"], res["worst_grad_norm_rel"],
                res["worst_trainable_norm_rel"]) <= 1e-4 and routes_equal):
        raise AssertionError(f"{arch} reduced card vs CPU: {res}")
    return res


def zoo_report() -> collections.Counter:
    """Phase 13 on the card, reported. Returns its launches."""
    print(f"the zoo's hybrid, MoE, encdec and VLM families, {card_line()}:",
          flush=True)
    launches = collections.Counter()
    t_all = time.perf_counter()
    for arch, cut in (("recurrentgemma-2b", None),
                      ("qwen3-moe-235b-a22b", QWEN_LAYERS),
                      ("whisper-medium", None),
                      ("llava-next-34b", LLAVA_LAYERS)):
        t0 = time.perf_counter()
        full = get_config(arch).n_layers
        if cut:
            why = "NF4 ≈ 1.4 GB a layer, the script's time" \
                if arch == "qwen3-moe-235b-a22b" else "the script's time"
            print(f"  reduced: n_layers {full}->{cut} ({why})", flush=True)
        res, model, params = zoo_token_phase(arch, n_layers=cut)
        launches.update(res.pop("launches"))
        prof = res.pop("profile")
        report({"zoo_tokens": arch, **res})
        report_profile("decode_step", prof)
        if arch == "qwen3-moe-235b-a22b":
            # phase 14 (c) on these weights: no second 128-expert init
            _QWEN14[0] = qwen_runtime_check(model, params, mesh_runtime())
            # phase 15 (a) on the same weights
            _QWEN15[0] = qwen_calibrate_check(model, params, mesh_runtime())
        if arch in TRAIN_KERNELS:
            tres = zoo_train_phase(arch, model, params)
            launches.update(tres.pop("launches"))
            tprof = tres.pop("profile")
            for r in tres.pop("rounds"):
                report(r)
            report({"zoo_trainer": arch, **tres})
            report_profile("train_step", tprof)
        else:
            sres = zoo_step_phase(arch, model, params)
            launches.update(sres.pop("launches"))
            sprof = sres.pop("profile")
            report({"zoo_train_step": arch, **sres})
            if sprof is not None:
                report_profile("train_step", sprof)
        del model, params
        torch.cuda.empty_cache()
        report({"zoo_arch_s": time.perf_counter() - t0, "arch": arch})
    zoo_checks()
    report({"phase13_s": time.perf_counter() - t_all, "card": card_line()})
    torch.cuda.empty_cache()
    return launches


def zoo_checks() -> None:
    """Phase 13 (e) on the card, reported: the full-width bf16 cuts and
    the reduced fp32 configs against the CPU."""
    t0 = time.perf_counter()
    for arch, n in (("recurrentgemma-2b", 3), ("whisper-medium", 2),
                    ("llava-next-34b", 1)):
        replace = {"n_patches": 8} if arch == "llava-next-34b" else {}
        if arch == "whisper-medium":
            replace = {"encoder_layers": 2, "n_frames": 250}
        batch = 2 if arch == "llava-next-34b" else 4
        print(f"  card vs CPU cut: {arch} {n} layers {replace} batch "
              f"{batch}", flush=True)
        report({"zoo_cut_card_vs_cpu": arch,
                **zoo_cut_check(arch, n, batch=batch, **replace)})
    for arch in ("recurrentgemma-2b", "qwen3-moe-235b-a22b",
                 "kimi-k2-1t-a32b", "whisper-medium", "llava-next-34b"):
        report({"zoo_reduced_card_vs_cpu": arch, **zoo_reduced_check(arch)})
    report({"zoo_checks_s": time.perf_counter() - t0})


# -- phase 14: the mesh and the expert-parallel runtime ----------------

# Kimi-K2 (hf:moonshotai/Kimi-K2-Instruct config shape: d_model 7168, 64
# heads x 128, 8 KV heads, 384 experts at d_ff 2048, top 8 + 1 shared,
# one dense first layer at 18432, vocab 163840) at full width through
# the Runtime's expert-parallel body on a mesh of one rank, depth cut to
# the dense layer and two MoE layers (NF4 experts about 9.5 GB a MoE
# layer); the token mode's 4 streams, a prompt of 64, 8 tokens
KIMI = "kimi-k2-1t-a32b"
KIMI_LAYERS = 3
KIMI_TOKENS = dict(batch=4, prompt=64, gen=8)
# the kernels the Runtime's bodies launch at full width: the attention's
# LoRA projections, the head-split attention, the frozen NF4 expert, dense
# and shared-expert products; the train step adds their dx
KIMI_KERNELS = ("lora_matmul", "flash_attention", "quant_matmul")
_RT: list = [None]
_QWEN14: list = [None]      # phase 14 (c), run inside phase 13
_QWEN15: list = [None]      # phase 15 (a)'s Qwen3-MoE, run inside phase 13


def mesh_runtime(device="cuda"):
    """Phase 14 (a): the process group of one rank (NCCL on the card,
    ``launch.mesh.init_world``) and its ``(pod=1, data=1, model=1)``
    Runtime, made once."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import runtime as rt_lib
    if _RT[0] is None:
        mesh_lib.init_world(device)
        _RT[0] = rt_lib.Runtime(mesh_lib.make_debug_mesh((1, 1, 1)),
                                ("pod", "data"), "model")
    return _RT[0]


def nccl_check(rt) -> dict:
    """Phase 14 (a): the world's backend, size and mesh, and each
    collective the bodies use issued on the world group (the bodies skip
    collectives over one rank), fp32, bf16 and int8."""
    import torch.distributed as dist
    dev = torch.device("cuda" if dist.get_backend() == "nccl" else "cpu")
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        x = (torch.arange(4096, device=dev) % 113).to(dt)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        ok = torch.equal(out, x)
        dist.all_gather_into_tensor(out, x)
        ok &= torch.equal(out, x)
        y = x.clone()
        dist.all_reduce(y)
        ok &= torch.equal(y, x)
        dist.reduce_scatter_tensor(out, x)
        ok &= torch.equal(out, x)
        if not ok:
            raise AssertionError(f"a collective over the world moved {dt}")
    return {"backend": dist.get_backend(), "world_size":
            dist.get_world_size(), "mesh": dict(rt.mesh.shape),
            "dp_axes": rt.dp_axes, "tp_axis": rt.tp_axis}


def _linear_ops(cfg, rows: int) -> float:
    """2 x rows x K x N over a MoE model's projections outside the
    experts: each layer's attention, the dense layers' MLP, the shared
    experts, the head."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    attn = d * qd * 2 + d * kvd * 2
    dense = 3 * d * cfg.dense_d_ff * cfg.first_k_dense
    shared = 3 * d * cfg.d_ff * cfg.n_shared_experts * \
        (cfg.n_layers - cfg.first_k_dense)
    return 2.0 * rows * (attn * cfg.n_layers + dense + shared +
                         d * cfg.vocab_size)


def _expert_ops(cfg, tokens: int) -> float:
    """2 x rows x K x N of the expert products the capacity buffers hold:
    every expert runs ``C = ceil(T k cf / E)`` rows (a mesh of one)."""
    C = max(1, -(-int(tokens * cfg.experts_per_token * cfg.capacity_factor)
                 // cfg.n_experts))
    return 2.0 * cfg.n_experts * C * 3 * cfg.d_model * cfg.d_ff * \
        (cfg.n_layers - cfg.first_k_dense)


def kimi_phase(rt, device="cuda", n_layers=KIMI_LAYERS) -> dict:
    """Phase 14 (b): Kimi-K2 at full width through ``launch/serve.py``'s
    token mode under the Runtime (the launch counts and ``DIST_TRACES``
    zeroed just before, read just after), a decode step profiled beside
    its bound, then one ``train_step`` on 4 x 64 tokens: the peak memory
    of each, the routes (no plain route, every kernel of the path
    launched) and the bodies taken (the expert-parallel body at prefill
    and in every decode step)."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import runtime as rt_lib
    t = KIMI_TOKENS
    argv = ["--arch", KIMI, "--full-config", "--quant", "4", "--batch",
            str(t["batch"]), "--prompt-len", str(t["prompt"]), "--gen",
            str(t["gen"])]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    rt_lib.reset_dist_traces()
    t0 = time.perf_counter()
    with cut_depth(serve_cli, KIMI, n_layers), rt_lib.runtime(rt), \
            contextlib.redirect_stdout(sys.stderr):
        out = serve_cli.main(argv, device=device)
    wall = time.perf_counter() - t0
    launches, tc = path_launches(), ops.tc_launch_counts()
    traces, dist_tr = dict(ops.KERNEL_TRACES), dict(rt_lib.DIST_TRACES)
    model, params = out["model"], out["params"]
    cfg = model.cfg
    G, n_moe = t["gen"], cfg.n_layers - cfg.first_k_dense
    toks = out["tokens"]
    bad = [k for k in traces if k.endswith("_ref")]
    miss = [k for k in KIMI_KERNELS + ("quant_matmul_tc",)
            if launches[k] < 1]
    want_dist = {"moe_ffn_dist_seq": n_moe,
                 "moe_ffn_dist_decode": n_moe * (G - 1)}
    if toks.shape != (t["batch"], G) or toks.max() >= cfg.vocab_size or \
            any(dist_tr.get(k) != v for k, v in want_dist.items()) or \
            (on_card and (bad or miss)):
        raise AssertionError(f"Kimi-K2 token mode: plain routes {bad}, no "
                             f"launch of {miss}, bodies {dist_tr}; "
                             f"{launches}")
    res = {"arch": KIMI, "layers": cfg.n_layers, "wall_s": wall,
           "tokens_row0": toks[0].tolist(),
           "prefill_ms": out["prefill_s"] * 1e3,
           "decode_ms_per_token": out["decode_s"] / (G - 1) * 1e3,
           "decode_tok_s": t["batch"] * (G - 1) / out["decode_s"],
           "launches": launches, "tc_launches": tc, "dist_traces": dist_tr,
           "serve_max_memory_allocated": torch.cuda.max_memory_allocated()
           if on_card else None}
    frozen, tr = params["frozen"], params["trainable"]
    batch, max_len = out["batch"], out["max_len"]
    del out
    with rt_lib.runtime(rt):
        logits, cache = model.prefill(frozen, tr, batch, max_len=max_len)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        pos = torch.full((), t["prompt"], dtype=torch.int32, device=device)
        n_bytes = qlib.tree_bytes(frozen) - nbytes(frozen["embed"]) + \
            qlib.tree_bytes(tr) + qlib.tree_bytes(cache)
        res["decode_bound_ms"] = n_bytes / HBM_BYTES_S * 1e3
        res["decode_bound_by"] = "bytes"
        if on_card:
            res["profile"] = profile_run(
                lambda: model.decode_step(frozen, tr, cache, tok, pos),
                KIMI_KERNELS)
    del cache, logits
    # one train step on 4 x 64 tokens (it fits at 3 layers: about 25 GB
    # of weights, the per-expert products saving no decoded W)
    b = zoo_batch(cfg, device)
    rows = int(b["mask"].numel())
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_traces()
    ops.reset_launch_counts()
    rt_lib.reset_dist_traces()
    t0 = time.perf_counter()
    with rt_lib.runtime(rt):
        _, _, m = model.train_step(frozen, tr, optim.adam_init(tr), b,
                                   lr=1e-3)
        loss = float(m["loss"])
    res["train_step_s"] = time.perf_counter() - t0
    tl, ttr = path_launches(), dict(ops.KERNEL_TRACES)
    if not np.isfinite(loss) or (on_card and (
            [k for k in ttr if k.endswith("_ref")] or
            [k for k in KIMI_KERNELS + ("quant_matmul_t", "quant_matmul_tc")
             if tl[k] < 1])):
        raise AssertionError(f"Kimi-K2 train_step: loss {loss}, {tl} {ttr}")
    ops_step = 3.0 * (_linear_ops(cfg, rows) + _expert_ops(cfg, rows))
    b_ms, b_by = bound(qlib.tree_bytes(frozen) + qlib.tree_bytes(tr) * 4,
                       ops_step, torch.bfloat16)
    res.update(train_layers=cfg.n_layers, train_rows=rows, train_loss=loss,
               train_launches=tl, train_dist_traces=dict(rt_lib.DIST_TRACES),
               train_bound_ms=b_ms, train_bound_by=b_by,
               train_max_memory_allocated=torch.cuda.max_memory_allocated()
               if on_card else None)
    del params, frozen, tr, model
    if on_card:
        torch.cuda.empty_cache()
    return res


def qwen_runtime_check(model, params, rt, device="cuda", prompt=64) -> dict:
    """Phase 14 (c), on phase 13's Qwen3-MoE (4 layers, full width, its
    weights): a prefill and a decode step and the gradients of a 4 x 64
    token step, under the Runtime and without it, first in fp32 on the
    same weights (the NF4 payloads decoding to fp32, TF32 off): the
    expert ids and kept slots of every routing call equal, the logits
    within 1e-4 of the largest, the loss within 1e-5, every gradient leaf
    in norm within 1e-4. Then in bf16 as phase 13 runs it, where the
    body's per-expert ``quant_matmul`` kernel rounds differently from the
    local path's decode and ``bmm``: the first MoE layer's routes equal
    (the same input), the later layers' distances reported (a token whose
    top-8 sits at a near tie flips, and at capacity 1.25 a flip moves
    other tokens' slots); and under ``moe_dispatch_bits=8`` (the int8
    all-to-all's quantize and decode, on the wire even over one rank's
    identity exchange) the distance to the unquantized dispatch. The
    dropped share is the local path's."""
    from repro_torch.models import runtime as rt_lib
    cfg = model.cfg
    b = zoo_batch(cfg, device)
    pre = {"tokens": b["tokens"][:, :prompt - 1]}
    nxt = b["tokens"][:, prompt - 1:prompt]
    pos = torch.full((), prompt - 1, dtype=torch.int32, device=device)
    cfg32 = cfg.replace(dtype="float32")
    f32, t32 = _to_fp32(params["frozen"]), _to_fp32(params["trainable"])
    runs = (("fp32_local", None, build_model(cfg32), f32, t32),
            ("fp32_dist", rt, build_model(cfg32), f32, t32),
            ("local", None, model, params["frozen"], params["trainable"]),
            ("dist", rt, model, params["frozen"], params["trainable"]),
            ("dist_q8", rt, build_model(cfg.replace(moe_dispatch_bits=8)),
             params["frozen"], params["trainable"]))
    out = {}
    for side, r, m, frozen, tr in runs:
        with moe_routes(record_ids=True) as rec, rt_lib.runtime(r):
            t0 = time.perf_counter()
            lg, cache = m.prefill(frozen, tr, pre, max_len=prompt + 4)
            lg2, _ = m.decode_step(frozen, tr, cache, nxt, pos)
            (loss, _), g = m.grads(frozen, tr, b)
            _sync(device)
            out[side] = dict(logits=torch.cat([lg, lg2]).float().cpu(),
                             loss=float(loss),
                             grads=convert.tree_to(g, "cpu"),
                             ids=[x.cpu() for x in rec["ids"]],
                             slots=[x.cpu() for x in rec["slots"]],
                             kept=float(torch.stack(rec["kept"]).sum()),
                             copies=rec["copies"],
                             s=time.perf_counter() - t0)
        del cache, g
    del f32, t32
    L = cfg.n_layers
    res = {"arch": cfg.name, "layers": L,
           "dropped_share": 1.0 - out["local"]["kept"] /
           out["local"]["copies"]}
    for side, ref_side in (("fp32_dist", "fp32_local"), ("dist", "local"),
                           ("dist_q8", "local")):
        o, w = out[side], out[ref_side]
        errs = _leaf_norm_errs(o["grads"], w["grads"])
        same = lambda i: torch.equal(o["ids"][i], w["ids"][i]) and \
            torch.equal(o["slots"][i], w["slots"][i])
        res[side] = {
            "routes_equal": len(o["ids"]) == len(w["ids"]) and all(
                same(i) for i in range(len(w["ids"]))),
            # the first MoE layer of the prefill, the decode step and the
            # step's forward: the same input on both sides
            "first_layer_routes_equal": all(same(i) for i in (0, L, 2 * L)),
            "logits_rel": rel_err(o["logits"], w["logits"])[1],
            "loss_rel": abs(o["loss"] - w["loss"]) / abs(w["loss"]),
            "worst_grad_leaf_norm_rel": max(errs.values()),
            "s": o["s"], "s_without": w["s"]}
    d32, d = res["fp32_dist"], res["dist"]
    if not (d32["routes_equal"] and d32["logits_rel"] <= 1e-4 and
            d32["loss_rel"] <= 1e-5 and
            d32["worst_grad_leaf_norm_rel"] <= 1e-4 and
            d["first_layer_routes_equal"]):
        raise AssertionError(f"Qwen3-MoE under the Runtime: {res}")
    return res


def vit_mesh_round(rt, device="cuda", *, steps=10, batch=32, n_clients=5,
                   n_per_class=60, seed=0) -> dict:
    """Phase 14 (d), ViT-B/32 width: one ``qlora_nogan`` round of phase
    9's clients (seeded weights, the NF4 round trip) through
    ``CohortEngine`` with ``CohortConfig(mesh=)`` and without, on the
    same draws: every trainable leaf within 1e-5 of its largest
    magnitude, losses within 1e-4, uplink bytes equal."""
    strat = STRATEGIES["qlora_nogan"]
    data = make_dataset("pacs", n_per_class=n_per_class, seed=seed)
    repeat = VIT_B32.image_size // data["images"].shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    frozen = nf4_round_trip(clip_lib.init_clip(gen, VIT_B32,
                                               device=device))[0]
    ce = class_embedding(frozen, VIT_B32, device)
    g0 = client_lib.init_trainable(gen, VIT_B32, strat, device=device)
    key = cohort_lib.RoundKey(cohort_lib.SeededDraws(seed), (3, 0))
    res = {}
    for name, mesh in (("local", None), ("mesh", rt.mesh)):
        eng = cohort_lib.CohortEngine(
            frozen=frozen, ccfg=VIT_B32, class_emb=ce,
            clients=fl_clients(data, n_clients, 0.5, seed, strat, repeat),
            cfg=cohort_lib.CohortConfig(strategy=strat, local_steps=steps,
                                        batch_size=batch, lr=3e-3,
                                        mesh=mesh))
        t0 = time.perf_counter()
        tr, m = eng.run_round(g0, key)
        _sync(device)
        res[name] = (tr, m, time.perf_counter() - t0)
        del eng
    (t0_, m0, s0), (t1, m1, s1) = res["local"], res["mesh"]
    leaf = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(tree_lib.leaves(t1), tree_lib.leaves(t0_)))
    out = {"worst_leaf_rel": leaf,
           "loss_max_abs": float((m1["loss"] - m0["loss"]).abs().max()),
           "uplink_bytes": (m1["uplink_bytes"], m0["uplink_bytes"]),
           "round_s_mesh": s1, "round_s_local": s0}
    if not (leaf <= 1e-5 and out["loss_max_abs"] <= 1e-4 and
            m1["uplink_bytes"] == m0["uplink_bytes"]):
        raise AssertionError(f"ViT-B/32 mesh round: {out}")
    return out


def cohort_mesh_phase(rt, device="cuda") -> dict:
    """Phase 14 (d): ``run_federated`` (``qlora_nogan``, the paper
    preset's round settings at its ``CLIPConfig()``, 1 round) with
    ``mesh=`` (``CohortConfig.mesh``) and without: the History's losses
    and accuracies within 1e-5 relative, its uplink bytes equal; then
    :func:`vit_mesh_round` at ViT-B/32 width."""
    cfg = sim_lib.FLConfig(strategy="qlora_nogan", rounds=1, **FL_PAPER)
    h = {}
    for name, mesh in (("local", None), ("mesh", rt.mesh)):
        t0 = time.perf_counter()
        h[name] = (sim_lib.run_federated(cfg, device=device, mesh=mesh),
                   time.perf_counter() - t0)
    (a, sa), (b, sb) = h["mesh"], h["local"]
    num = lambda x: np.asarray(x, np.float64)
    rel = max(float(np.abs(num(getattr(a, f)) - num(getattr(b, f))).max()
                    / max(np.abs(num(getattr(b, f))).max(), 1e-30))
              for f in ("server_acc", "server_loss", "client_loss",
                        "client_acc"))
    res = {"run_federated_rel": rel, "uplink_bytes": (a.uplink_bytes,
                                                      b.uplink_bytes),
           "run_s_mesh": sa, "run_s_local": sb}
    if not (rel <= 1e-5 and a.uplink_bytes == b.uplink_bytes):
        raise AssertionError(f"run_federated with a mesh: {res}")
    res["vit_b32"] = vit_mesh_round(rt, device)
    return res


def fleet_mesh_phase(rt, device="cuda", steps=GAN_CHECK_STEPS) -> dict:
    """Phase 14 (e): the fleet GAN of phase 8's tripleplay clients with
    ``FleetGANConfig(mesh=)``, ``steps`` steps, against the unsharded
    fleet on the same streams: every eligible client's trained leaves,
    its synthesized images and labels bitwise equal."""
    out = {}
    for name, mesh in (("local", None), ("mesh", rt.mesh)):
        clients, streams = gan_clients()
        t0 = time.perf_counter()
        rep = fleetgan.prepare_gan_fleet(
            clients, streams, steps=steps,
            fleet_cfg=fleetgan.FleetGANConfig(mesh=mesh), device=device)
        out[name] = (clients, rep, time.perf_counter() - t0)
    (ca, ra, sa), (cb, rb, sb) = out["mesh"], out["local"]
    same = ra.n_eligible == rb.n_eligible and ra.n_synth == rb.n_synth
    for x, y in zip(ca, cb):
        if (x.gan_params is None) != (y.gan_params is None):
            same = False
        elif x.gan_params is not None:
            same &= all(torch.equal(p, q) for p, q in zip(
                tree_lib.leaves(x.gan_params), tree_lib.leaves(y.gan_params)))
            same &= np.array_equal(x.aug_images, y.aug_images) and \
                np.array_equal(x.aug_labels, y.aug_labels)
    res = {"bitwise": bool(same), "eligible": ra.n_eligible,
           "synth": ra.n_synth, "prep_s_mesh": sa, "prep_s_local": sb}
    if not same:
        raise AssertionError(f"fleet GAN with a mesh: {res}")
    return res


def mamba_body_phase(rt, device="cuda", seq=64, batch=4) -> dict:
    """Phase 14 (b'): one Falcon-Mamba-7B block at full width (d_inner
    8192, NF4) through its channel-parallel body under the Runtime and
    through the local path, a forward and a backward on 4 x 64 tokens:
    the output and the input's gradient within 2e-2 of the largest
    (bf16), the ``selective_scan`` kernel and its backward launched in
    the body, the body traced as ``mamba_block_dist``."""
    from repro_torch.models import runtime as rt_lib
    from repro_torch.models import ssm
    cfg = get_config("falcon-mamba-7b").replace(**CLI_NF4)
    model = build_model(cfg.replace(n_layers=1))
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, device=device)
    p = {k: v[0] if not isinstance(v, qlib.QTensor) else dataclasses.replace(
        v, q=v.q[0], scales=v.scales[0], orig_shape=tuple(v.orig_shape[1:]))
        for k, v in params["frozen"]["layers"].items()}
    x = (torch.randn((batch, seq, cfg.d_model), generator=gen,
                     device=device) * 0.1).to(torch.bfloat16)
    out = {}
    for side, r in (("local", None), ("dist", rt)):
        ops.reset_launch_counts()
        rt_lib.reset_dist_traces()
        xr = x.clone().requires_grad_(True)
        with rt_lib.runtime(r):
            y, _ = ssm.mamba_block(p, xr, cfg)
            dx, = torch.autograd.grad(y.float().square().sum(), xr)
        _sync(device)
        out[side] = (y.detach().float(), dx.float(), path_launches(),
                     dict(rt_lib.DIST_TRACES))
    (y1, d1, l1, t1), (y0, d0, _, _) = out["dist"], out["local"]
    res = {"y_rel": rel_err(y1, y0)[1], "dx_rel": rel_err(d1, d0)[1],
           "launches": l1, "dist_traces": t1}
    on_card = torch.device(device).type == "cuda"
    if not (res["y_rel"] <= 2e-2 and res["dx_rel"] <= 2e-2 and
            t1 == {"mamba_block_dist": 1}) or (on_card and (
                l1["selective_scan"] < 1 or l1["selective_scan_bwd"] < 1)):
        raise AssertionError(f"Falcon-Mamba block under the Runtime: {res}")
    del params, p
    return res


# phase 14 (f): the kernels at the shapes the rank bodies give them,
# (name, kernel, M, K, N, dtype, with a dx) for the expert products
KIMI_EXPERT_MM = [
    ("kimi_expert_wg_wu_prefill", 7, 7168, 2048, True),
    ("kimi_expert_wd_prefill", 7, 2048, 7168, True),
    ("kimi_expert_wg_wu_decode", 1, 7168, 2048, False),
    ("kimi_expert_wd_decode", 1, 2048, 7168, False),
]


def check_phase14_kernels(gen) -> list:
    """Phase 14 (f): each kernel the bodies launched, at the shapes the
    rank bodies give it, against its plain version: ``quant_matmul`` at
    a Kimi-K2 expert (NF4, bf16; 7 capacity rows at 4 x 64 tokens, the
    GEMV's 1 row in a decode step) and its dx (``quant_matmul_t``),
    ``lora_matmul`` at Kimi-K2's wq (7168 x 8192, 256 rows and 4),
    ``flash_attention`` at the head-split body's (4, 64, 64, 128) with
    the KV heads expanded per query head, ``selective_scan`` at the
    Mamba body's (4, 64, 8192, 16). bf16 within 1.6e-2 (quant_matmul) or
    2e-2 of the largest magnitude, fp32 1e-5."""
    dev, bf = "cuda", torch.bfloat16
    rows = []
    for name, M, K, N, backward in KIMI_EXPERT_MM:
        w = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
             ).to(bf)
        qt = ref.blockwise_quant(w, bits=4, block=64, mode="nf4")
        x = torch.randn((M, K), generator=gen, device=dev).to(bf)
        fwd = lambda: qmm_kernel.quant_matmul(x, qt)
        got, route = qmm_route(fwd)
        want = ref.quant_matmul(x, qt)
        abs_e, rel_e = rel_err(got, want)
        if not (rel_e <= 1.6e-2 and torch.isfinite(got).all()):
            raise AssertionError(f"quant_matmul {name}: rel err {rel_e}")
        b_ms, b_by = bound(nbytes(x, qt.q, qt.scales, got), 2.0 * M * K * N,
                           bf)
        row = {"kernel": "quant_matmul", "case": name, "route": route,
               "max_abs_err": abs_e, "rel_err": rel_e, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        timed(row, "ms", fwd)
        timed(row, "plain_ms", lambda: ref.quant_matmul(x, qt))
        report({"phase14_kernel": 1, **row})
        rows.append(row)
        if not backward:
            continue
        gq = torch.randn((M, N), generator=gen, device=dev).to(bf)
        run = lambda: lm_kernel.quant_matmul_t(gq, qt, out_dtype=torch.float32)
        got = run()
        want = ref.quant_matmul_t(gq, qt, out_dtype=torch.float32)
        abs_e, rel_e = rel_err(got, want)
        if not rel_e <= 1.6e-2:
            raise AssertionError(f"quant_matmul_t {name}: rel err {rel_e}")
        b_ms, b_by = bound(nbytes(gq, qt.q, qt.scales, got),
                           2.0 * M * K * N, bf)
        row = {"kernel": "quant_matmul_t", "case": name + "_dx",
               "route": "tensor cores", "max_abs_err": abs_e,
               "rel_err": rel_e, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        timed(row, "ms", run)
        timed(row, "plain_ms", lambda: ref.quant_matmul_t(
            gq, qt, out_dtype=torch.float32))
        report({"phase14_kernel": 1, **row})
        rows.append(row)
    # Kimi-K2's wq with its rank-16 LoRA pair
    for M in (256, 4):
        K, N, r = 7168, 8192, 16
        w = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
             ).to(bf)
        qt = ref.blockwise_quant(w, bits=4, block=64, mode="nf4")
        x = torch.randn((M, K), generator=gen, device=dev).to(bf)
        a = torch.randn((K, r), generator=gen, device=dev) * 0.01
        bb = torch.randn((r, N), generator=gen, device=dev) * 0.01
        run = lambda: lm_kernel.lora_matmul(x, qt, a, bb, scale=2.0)
        got = run()
        plain = lambda: ref.lora_matmul(x, qt, a, bb, scale=2.0)
        want = plain()
        abs_e, rel_e = rel_err(got.float(), want.float())
        if not rel_e <= _tol(bf):
            raise AssertionError(f"lora_matmul kimi wq M={M}: {rel_e}")
        b_ms, b_by = bound(nbytes(x, qt.q, qt.scales, a, bb, got),
                           2.0 * M * K * N, bf)
        row = {"kernel": "lora_matmul", "case": f"kimi_wq_M{M}",
               "route": "tensor cores", "max_abs_err": abs_e,
               "rel_err": rel_e, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        timed(row, "ms", run)
        timed(row, "plain_ms", plain)
        report({"phase14_kernel": 1, **row})
        rows.append(row)
    # the head-split body's attention: Kimi-K2's 64 heads of 128, each
    # with its KV head gathered (64 KV heads after the expansion)
    B, S, H, D = 4, 64, 64, 128
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(bf)
    kv = torch.randn((B, S, 8, D), generator=gen, device=dev).to(bf)
    ids = torch.arange(H, device=dev) // 8
    k, v = kv.index_select(2, ids), kv.flip(1).index_select(2, ids)
    run = lambda: fa_kernel.flash_attention(q, k, v, causal=True)
    got, route = routed(fa_kernel.flash_attention, run)
    plain = lambda: ref.flash_attention(q, k, v, causal=True)
    abs_e, rel_e = rel_err(got, plain())
    if not rel_e <= _tol(bf):
        raise AssertionError(f"flash_attention kimi body: {rel_e}")
    b_ms, b_by = bound(nbytes(q, k, v, got),
                       4.0 * B * H * D * _valid_pairs(S, S, True, None), bf)
    row = {"kernel": "flash_attention", "case": "kimi_body_4x64x64x128",
           "route": route, "max_abs_err": abs_e, "rel_err": rel_e,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    timed(row, "ms", run)
    timed(row, "plain_ms", plain)
    time_sdpa_backends(row, *(t.transpose(1, 2).contiguous()
                              for t in (q, k, v)), True)
    report({"phase14_kernel": 1, **row})
    rows.append(row)
    # the Mamba body's scan: d_inner / m channels at m = 1
    dt, xs, Bm, Cm, A = _scan_inputs(gen, 4, 64, 8192, 16)
    run = lambda: ss_kernel.selective_scan(dt, xs, Bm, Cm, A)
    got = run()
    plain = lambda: ref.selective_scan(dt, xs, Bm, Cm, A)
    want = plain()
    abs_e, rel_e = rel_err(got[0], want[0])
    if not rel_e <= 1e-5:
        raise AssertionError(f"selective_scan mamba body: {rel_e}")
    b_ms, b_by = bound(nbytes(dt, xs, Bm, Cm, A, *got), 0.0, torch.float32)
    row = {"kernel": "selective_scan", "case": "mamba_body_4x64x8192x16",
           "route": "cuda cores", "max_abs_err": abs_e, "rel_err": rel_e,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    timed(row, "ms", run)
    timed(row, "plain_ms", plain)
    report({"phase14_kernel": 1, **row})
    rows.append(row)
    torch.cuda.empty_cache()
    return rows


def runtime_report(qwen_res=None) -> collections.Counter:
    """Phase 14 on the card, reported. Returns its launches (the main
    paths' only: (b) and the Mamba body)."""
    print(f"the mesh and the expert-parallel runtime, {card_line()}:",
          flush=True)
    t_all = time.perf_counter()
    rt = mesh_runtime()
    report({"phase14_world": 1, **nccl_check(rt)})
    launches = collections.Counter()
    full = get_config(KIMI).n_layers
    print(f"  reduced: n_layers {full}->{KIMI_LAYERS} (1 dense + 2 MoE; NF4 "
          "experts ≈ 9.5 GB a MoE layer)", flush=True)
    kres = kimi_phase(rt)
    launches.update(kres.pop("launches"))
    launches.update(kres["train_launches"])
    prof = kres.pop("profile")
    report({"phase14_kimi": KIMI, **kres})
    report_profile("kimi_decode_step", prof)
    mres = mamba_body_phase(rt)
    launches.update(mres.pop("launches"))
    report({"phase14_mamba_body": 1, **mres})
    if qwen_res is not None:
        report({"phase14_qwen3": 1, **qwen_res})
    report({"phase14_cohort_mesh": 1, **cohort_mesh_phase(rt)})
    report({"phase14_fleet_mesh": 1, **fleet_mesh_phase(rt)})
    gen = torch.Generator(device="cuda").manual_seed(1414)
    check_phase14_kernels(gen)
    report({"phase14_s": time.perf_counter() - t_all, "card": card_line()})
    return launches


# -- phase 15: the dry run's calibrated paths and account; the autotuner --

# (arch, layers, model dtype, tokens a sequence, bound): Yi-9B at phase
# 13's bf16 bounds; Falcon-Mamba-7B and RecurrentGemma-2B in fp32 at the
# JAX package's chunked-vs-plain scan bound (1e-4, tests/test_kernels.py)
CALIBRATED = (("yi-9b", 1, "bfloat16", 64, 2e-2),
              ("yi-9b", 2, "bfloat16", 64, 2e-2),
              ("falcon-mamba-7b", 2, "float32", 64, 1e-4),
              # 512 tokens: two of the config's 256-step chunks
              ("recurrentgemma-2b", 3, "float32", 512, 1e-4))
H100_BF16_FLOPS = 989e12


def calibrated_check(arch: str, n_layers: int, dtype: str, seq: int,
                     tol: float, *, seed=0, device="cuda") -> dict:
    """Phase 15 (a): one 4 x ``seq`` step at ``arch``'s full width with
    ``n_layers`` layers (NF4 block 64, seeded weights, the trainables
    perturbed) with ``calibrate`` and ``unroll_layers`` against the same
    config without, on the same weights: the logits (no grad), the loss
    and every gradient leaf. The logits and the gradients' norm within
    ``tol`` of the plain side's (the logits relative to their largest
    magnitude), the loss within ``tol`` (bf16: phase 13's 1e-3), every
    gradient leaf in norm within phase 13's 2e-2 but the two behind the
    adapter's ReLU (reported: a pre-activation within rounding of zero
    flips the gate, as in phase 4); the worst leaf is reported. The
    launches of each side by kernel (zeroed before each, read after):
    the calibrated Mamba scan is plain PyTorch, so its side launches no
    ``selective_scan``."""
    cfg = get_config(arch).replace(n_layers=n_layers, dtype=dtype, **CLI_NF4)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = build_model(cfg).init_params(gen, device=device)
    frozen, tr = params["frozen"], perturbed(params["trainable"], gen,
                                             device)
    b = zoo_batch(cfg, device, seq=seq, seed=seed)
    out = {}
    for side, c in (("plain", cfg),
                    ("calibrated", cfg.replace(calibrate=True,
                                               unroll_layers=True))):
        m = build_model(c)
        ops.reset_launch_counts()
        ops.reset_kernel_traces()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = m.forward(frozen, tr, b)
        (loss, _), g = m.grads(frozen, tr, b)
        _sync(device)
        out[side] = dict(logits=logits.float(), loss=float(loss), grads=g,
                         s=time.perf_counter() - t0,
                         launches={k: n for k, n in path_launches().items()
                                   if n},
                         traces=dict(ops.KERNEL_TRACES))
    c, p = out["calibrated"], out["plain"]
    errs = _leaf_norm_errs(c["grads"], convert.tree_to(p["grads"], "cpu"))
    gn_c = float(optim.global_norm(c["grads"]))
    gn_p = float(optim.global_norm(p["grads"]))
    res = {"arch": arch, "layers": n_layers, "dtype": dtype, "seq": seq,
           "tol": tol, "logits_rel": rel_err(c["logits"], p["logits"])[1],
           "loss_rel": abs(c["loss"] - p["loss"]) / abs(p["loss"]),
           "grad_norm_rel": abs(gn_c - gn_p) / gn_p,
           "worst_grad_leaf": max(errs, key=errs.get),
           "worst_grad_leaf_norm_rel": max(errs.values()),
           "relu_gated_norm_rel": {k: errs[k] for k in RELU_GATED},
           "launches_plain": p["launches"],
           "launches_calibrated": c["launches"],
           "s_plain": p["s"], "s_calibrated": c["s"]}
    loss_tol = 1e-3 if dtype == "bfloat16" else tol
    held_errs = {k: v for k, v in errs.items() if k not in RELU_GATED}
    held = max(held_errs.values())
    res["worst_held_leaf"] = max(held_errs, key=held_errs.get)
    res["worst_held_leaf_norm_rel"] = held
    if on_card(device) and any(k.endswith("_ref") for k in c["traces"]):
        raise AssertionError(f"calibrated {arch} took plain kernel routes: "
                             f"{c['traces']}")
    if not (res["logits_rel"] <= tol and res["loss_rel"] <= loss_tol and
            res["grad_norm_rel"] <= tol and
            held <= 2e-2):
        raise AssertionError(f"calibrated vs plain {arch}: {res}")
    del out, params, frozen, tr
    return res


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def qwen_calibrate_check(model, params, rt, device="cuda") -> dict:
    """Phase 15 (a) on phase 13's Qwen3-MoE (4 layers, full width, its
    weights), in fp32 under the world-of-one Runtime: the expert-parallel
    body's batched expert product (``calibrate``: the rank's 128 experts
    decoded and multiplied at once) against its per-expert loop (the
    ``quant_matmul`` kernel an expert), forward on a 4 x 64 batch: every
    routing call's expert ids and kept slots equal, the logits within
    1e-4 of the largest and the loss within 1e-5 (phase 14 (c)'s fp32
    bounds). Launches by kernel of each side."""
    from repro_torch.models import runtime as rt_lib
    cfg32 = model.cfg.replace(dtype="float32")
    f32, t32 = _to_fp32(params["frozen"]), _to_fp32(params["trainable"])
    b = zoo_batch(cfg32, device)
    out = {}
    for side, c in (("loop", cfg32),
                    ("batched", cfg32.replace(calibrate=True,
                                              unroll_layers=True))):
        m = build_model(c)
        ops.reset_launch_counts()
        with moe_routes(record_ids=True) as rec, rt_lib.runtime(rt), \
                torch.no_grad():
            t0 = time.perf_counter()
            logits, aux = m.forward(f32, t32, b)
            loss = losses.cross_entropy(logits, b["labels"], b["mask"])
            _sync(device)
            out[side] = dict(logits=logits.float(), loss=float(loss),
                             ids=rec["ids"], slots=rec["slots"],
                             s=time.perf_counter() - t0,
                             launches={k: n for k, n in
                                       path_launches().items() if n})
        del logits
    lo, ba = out["loop"], out["batched"]
    same = len(lo["ids"]) == len(ba["ids"]) and all(
        torch.equal(a, b_) for a, b_ in zip(lo["ids"], ba["ids"])) and all(
        torch.equal(a, b_) for a, b_ in zip(lo["slots"], ba["slots"]))
    res = {"arch": model.cfg.name, "layers": model.cfg.n_layers,
           "routes_equal": same, "routing_calls": len(lo["ids"]),
           "logits_rel": rel_err(ba["logits"], lo["logits"])[1],
           "loss_rel": abs(ba["loss"] - lo["loss"]) / abs(lo["loss"]),
           "launches_loop": lo["launches"], "launches_batched": ba["launches"],
           "s_loop": lo["s"], "s_batched": ba["s"]}
    del f32, t32, out
    torch.cuda.empty_cache()
    if not (same and res["logits_rel"] <= 1e-4 and res["loss_rel"] <= 1e-5):
        raise AssertionError(f"Qwen3-MoE batched experts vs loop: {res}")
    return res


def dryrun_account_phase(arch: str = "yi-9b") -> dict:
    """Phase 15 (b): the dry run's account of phase 5's profiled Yi-9B
    step (the trainer's config, NF4 block 64, 4 x 64 tokens), traced in
    this process on one device (``local``: fake CPU tensors, no mesh),
    beside the card: the resident parameter, Adam and batch bytes of the
    real step must equal the dry run's ``argument_bytes`` exactly; its
    ``flops`` over the profiled step's device-busy seconds as a share of
    the H100's bf16 peak; the dry run's peak (arguments, outputs and
    temporaries) beside phase 5's ``max_memory_allocated`` (which also
    holds the rounds' deltas and the profiler's step)."""
    st = _STEP5[arch]
    cfg = st["cfg"]
    shape = InputShape("trainer", st["seq"], st["batch"], "train")
    rec = dryrun.run_one(arch, shape, multi_pod=False, local=True,
                         cfg_override=cfg, seq_shard=cfg.seq_shard,
                         remat=cfg.remat, verbose=False)
    res = {"arch": arch, "layers": cfg.n_layers,
           "argument_bytes": rec["argument_bytes"],
           "resident_bytes": st["resident_bytes"],
           "output_bytes": rec["output_bytes"],
           "temp_bytes": rec["temp_bytes"],
           "peak_bytes": rec["argument_bytes"] + rec["output_bytes"] +
           rec["temp_bytes"],
           "max_memory_allocated": st["max_memory_allocated"],
           "flops": rec["flops"], "flops_cal": rec["flops_cal"],
           "bytes": rec["bytes"], "busy_s": st["busy_s"],
           "wall_s": st["wall_s"],
           "flops_per_busy_s": rec["flops"] / st["busy_s"],
           "share_of_989_tflops": rec["flops"] / st["busy_s"]
           / H100_BF16_FLOPS,
           "trace_s": rec["trace_s"], "calibrate_s": rec["calibrate_s"],
           "card": card_line()}
    if res["argument_bytes"] != res["resident_bytes"]:
        raise AssertionError(f"dry run argument_bytes {rec['argument_bytes']}"
                             f" != the step's resident {st['resident_bytes']}")
    return res


DRYRUN_CLI = (("--arch", "yi-9b", "--shape", "train_4k", "--mesh", "single"),
              ("--fed-agg", "--arch", "yi-9b", "--mesh", "multi"))


def dryrun_cli_start() -> tuple:
    """Phase 15 (c), started: the production dry run through its CLI,
    each in a process of its own (a process has one default group, and
    phase 14's NCCL world is up in this one), both at once and beside
    (a)-(b): Yi-9B's train_4k step on the 16 x 16 fake world and the
    federated aggregation on the 2 x 16 x 16 one."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    runs = []
    for i, argv in enumerate(DRYRUN_CLI):
        out = os.path.join(tmp, f"{i}.jsonl")
        runs.append((argv, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", out], env=env, cwd=str(root),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return tmp, runs, time.perf_counter()


def dryrun_cli_finish(started, timeout: float = 300.0) -> list:
    """Phase 15 (c), waited for: both runs must exit 0; returns their
    records and the wall seconds from the start."""
    tmp, runs, t0 = started
    recs = []
    for argv, out, proc in runs:
        text, _ = proc.communicate(timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"dryrun {' '.join(argv)} exited "
                                 f"{proc.returncode}:\n{text[-3000:]}")
        with open(out) as f:
            recs += [(argv, json.loads(line)) for line in f]
    return recs, time.perf_counter() - t0


def dryrun_cli_stop(started) -> None:
    """Kill what is left of phase 15 (c)'s processes; remove their
    records."""
    tmp, runs, _ = started
    for _, _, proc in runs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    shutil.rmtree(tmp, ignore_errors=True)


def autotune_phase(gen, iters: int = 50) -> list:
    """Phase 15 (d): ``autotune.sweep`` of ``lora_matmul``'s split count
    at Yi-9B's four decode shapes (4 rows, NF4 block 64, bf16 x, rank
    16), each candidate's ms (a synchronize around ``iters`` calls)
    beside ``plan``'s pick; a second sweep of each must be a pure hit
    (nothing timed, nothing charged), and a call through the op at the
    winner (``ops._lora_kernel``, which looks the winner up) within the
    bf16 bound of the plain version (phase 2's)."""
    from repro_torch.fl import runtime as runtime_lib
    rt = runtime_lib.ProgramRuntime()
    rows = []
    for name, (K, N) in YI_LINEARS.items():
        w = (torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
             ).to(torch.bfloat16)
        qt = ref.blockwise_quant(w, bits=4, block=64, mode="nf4")
        x = torch.randn((4, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        a = torch.randn((K, 16), generator=gen, device="cuda") / K ** 0.5
        b = torch.randn((16, N), generator=gen, device="cuda") * 0.05
        build_fn = lambda s: lambda: lm_kernel._lora_matmul(x, qt, a, b,
                                                           2.0, s)
        cands = autotune.lora_candidates(4, K, N, qt.block)
        r1 = autotune.sweep("lora_matmul", build_fn, 4, K, N, bits=4,
                            mode="nf4", candidates=cands, runtime=rt,
                            iters=iters)
        charged = rt.compile_time_s
        r2 = autotune.sweep("lora_matmul", build_fn, 4, K, N, bits=4,
                            mode="nf4", candidates=cands, runtime=rt,
                            iters=iters)
        if not r1.swept or r2.swept or r2.best != r1.best or \
                rt.compile_time_s != charged:
            raise AssertionError(f"autotune {name}: second sweep not a pure "
                                 f"hit ({r1}, {r2})")
        got = ops._lora_kernel(x, qt, a, b, 2.0)
        abs_e, rel_e = rel_err(got, ref.lora_matmul(x, qt, a, b, scale=2.0))
        if not (rel_e <= _tol(torch.bfloat16) and torch.isfinite(got).all()):
            raise AssertionError(f"autotune {name}: the winner's rel err "
                                 f"{rel_e}")
        pick = lm_kernel.plan(4, K, N, qt.block).splits
        rows.append({"case": f"decode_{name}", "K": K, "N": N,
                     "plan_splits": pick,
                     "plan_ms": r1.timings[str(pick)] * 1e3,
                     "best_splits": r1.best[0],
                     "best_ms": r1.timings[str(r1.best[0])] * 1e3,
                     "ms_by_splits": {k: round(v * 1e3, 5)
                                      for k, v in r1.timings.items()},
                     "sweep_s": r1.time_s, "second_sweep_swept": r2.swept,
                     "max_abs_err": abs_e, "rel_err": rel_e})
    rows.append({"charged": rt.stats(), "key": r1.key})
    return rows


def dryrun_report() -> collections.Counter:
    """Phase 15 on the card, reported: (c) the production dry run's CLI
    started in two processes, then (a) the calibrated paths (Qwen3-MoE's
    ran inside phase 13), (b) the dry run's account of phase 5's step,
    (d) the autotuner, and (c) waited for. Returns (a)'s launches (its
    two sides, each zeroed before and read after)."""
    print(f"the dry run and the autotuner, {card_line()}:", flush=True)
    t_all = time.perf_counter()
    cli = dryrun_cli_start()
    try:
        launches = collections.Counter()
        for arch, n_layers, dtype, seq, tol in CALIBRATED:
            res = calibrated_check(arch, n_layers, dtype, seq, tol)
            launches.update(res["launches_plain"])
            launches.update(res["launches_calibrated"])
            report({"phase15_calibrated": arch, **res})
            torch.cuda.empty_cache()
        if _QWEN15[0] is not None:
            q = _QWEN15[0]
            launches.update(q["launches_loop"])
            launches.update(q["launches_batched"])
            report({"phase15_calibrated": "qwen3-moe-235b-a22b", **q})
        report({"phase15_a_s": time.perf_counter() - t_all})
        t0 = time.perf_counter()
        report({"phase15_account": 1, **dryrun_account_phase()})
        report({"phase15_b_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(1515)
        for row in autotune_phase(gen):
            report({"phase15_autotune": 1, **row})
        report({"phase15_d_s": time.perf_counter() - t0})
        recs, cli_s = dryrun_cli_finish(cli)
        for argv, rec in recs:
            print(f"  dryrun {' '.join(argv)}: {json.dumps(rec)}",
                  flush=True)
        report({"phase15_c_wall_s": cli_s,
                "phase15_s": time.perf_counter() - t_all,
                "card": card_line()})
    finally:
        dryrun_cli_stop(cli)
    return launches


def check_qmm_routes(phases: dict) -> None:
    """Print each phase's ``quant_matmul`` launches (its paths and its
    checks) by (users, rows, route, plan CTAs, dtype) and fail if a bf16
    call past 4 rows took another route than "tc" or an fp32 one past 4
    rows another than "tiled"."""
    for phase, calls in phases.items():
        print(f"  phase {phase} quant_matmul launches by (users T, rows M, "
              "route, plan CTAs, dtype): " + " ".join(
                  f"{k}={n}" for k, n in sorted(calls.items())), flush=True)
        for (T, M, route, ctas, dtype), n in calls.items():
            want = {"bfloat16": "tc", "float32": "tiled"}[dtype] \
                if M > qmm_kernel.MAX_ROWS else None
            if want is not None and route != want:
                raise AssertionError(f"phase {phase}: {n} {dtype} "
                                     f"quant_matmul calls at M={M} took "
                                     f"{route}, not {want}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    # a fresh autotune cache: no phase reads a stale winner
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        tune_dir, "autotune.json")
    autotune.clear()
    try:
        return _main()
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def clock(t_start: float, what: str) -> None:
    """The script's wall time so far, printed after each phase: where its
    time limit goes."""
    print(f"clock: {time.perf_counter() - t_start:.1f} s after {what}",
          flush=True)


def _main() -> int:
    t_start = time.perf_counter()
    setup()
    clock(t_start, "the build")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    print("kernels vs plain versions:", flush=True)
    main_rows = {}
    main_rows["quant_matmul"], main_rows["quant_matmul_tc"] = \
        check_quant_matmul(gen)
    main_rows["blockwise_quant"] = check_blockwise_quant(gen)
    check_flash_attention(gen)      # the serve shapes
    main_rows["flash_attention"] = check_flash_train(gen)
    check_flash_round(gen)          # the federated round's shapes
    main_rows["lora_matmul"], main_rows["quant_matmul_t"] = \
        check_lora_kernels(gen)
    qmt_split_sweep(gen)
    qmm_tc_sweep(gen)
    check_lora_decode(gen)          # the decode step's shapes (phase 12)
    main_rows["selective_scan"], main_rows["selective_scan_bwd"] = \
        check_selective_scan(gen)
    check_flash_zoo(gen)            # the zoo's shapes (phase 13)
    check_quant_matmul_zoo(gen)     # the zoo's projections without LoRA
    clock(t_start, "phase 2")

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
          "CTAs, dtype): " + " ".join(f"{k}={n}" for k, n in sorted(qmm_calls.items())),
          flush=True)
    if sum(qmm_calls.values()) != res["after_replay"]["quant_matmul"]:
        raise AssertionError("the replay's quant_matmul calls and launches "
                             "disagree")
    for (T, M, route, ctas, _), n in qmm_calls.items():
        if route != "gemv" or ctas < qmm_kernel.SMS:
            raise AssertionError(f"{n} replay quant_matmul launches at T={T} "
                                 f"took the {route} route with {ctas} CTAs")
    for name in SERVE_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the serve path launched no {name} kernel")
    serve_launches = launches
    del res
    torch.cuda.empty_cache()
    clock(t_start, "phase 3")

    step_check_report("yi-9b")
    yi_launches = trainer_report("yi-9b")
    step_check_report("falcon-mamba-7b")
    mamba_launches = trainer_report("falcon-mamba-7b")
    clock(t_start, "phases 4-7")
    gan_report()
    clock(t_start, "the GAN phase")
    fl_launches = fl_round_report()
    clock(t_start, "phase 8")
    vit_launches = vit_round_report()
    clock(t_start, "phase 9")
    sched_launches = sched_report()
    clock(t_start, "phase 10")
    handoff_launches = handoff_report()
    clock(t_start, "phase 11")
    tokens_launches = token_serve_report()
    clock(t_start, "phase 12")
    # phases 13-15 run quant_matmul at the trainers' rows: every call
    # recorded by route and dtype (a bf16 call past 4 rows takes "tc")
    qmm_phases = {}
    with record_quant_matmul() as qmm_phases[13]:
        zoo_launches = zoo_report()
    clock(t_start, "phase 13")
    with record_quant_matmul() as qmm_phases[14]:
        rt_launches = runtime_report(_QWEN14[0])
    clock(t_start, "phase 14")
    with record_quant_matmul() as qmm_phases[15]:
        dry_launches = dryrun_report()
    clock(t_start, "phase 15")
    check_qmm_routes(qmm_phases)

    print(card_line(), flush=True)
    # flash_attention runs on every path: its launches over all of them
    flash = {"serve": serve_launches["flash_attention"],
             "yi-9b": yi_launches["flash_attention"],
             "falcon-mamba-7b": mamba_launches["flash_attention"],
             "fl_round": fl_launches, "vit_round": vit_launches,
             "sched": sched_launches,
             "handoff": handoff_launches["flash_attention"],
             "tokens": tokens_launches["flash_attention"],
             "zoo": zoo_launches["flash_attention"]}
    print(f"flash_attention launches by path: {flash}", flush=True)
    # the serve kernels run on two paths: the replay (phase 3) and the
    # trainer-fed store (phase 11)
    serve_paths = {name: {"serve": serve_launches[name],
                          "handoff": handoff_launches[name]}
                   for name in ("quant_matmul", "blockwise_quant")}
    print(f"serve kernel launches by path: {serve_paths}", flush=True)
    # phase 12 runs lora_matmul, the scans and (its trainer) quant_matmul_t
    print(f"phase 12 launches: {dict(tokens_launches)}", flush=True)
    # phase 13 runs lora_matmul, quant_matmul_t and (the hybrid's and the
    # encoder's MLPs) quant_matmul
    print(f"phase 13 launches: {dict(zoo_launches)}", flush=True)
    # phase 14 runs the bodies' kernels: lora_matmul, flash_attention,
    # quant_matmul and its dx, the scans in the Mamba body
    print(f"phase 14 launches: {dict(rt_launches)}", flush=True)
    # phase 15 (a) runs the calibrated paths and their plain sides
    print(f"phase 15 launches: {dict(dry_launches)}", flush=True)
    launches = {**serve_launches, **yi_launches,
                **{name: sum(p.values()) for name, p in serve_paths.items()},
                "flash_attention": sum(flash.values()),
                "selective_scan": mamba_launches["selective_scan"],
                "selective_scan_bwd": mamba_launches["selective_scan_bwd"]}
    for name in ("lora_matmul", "quant_matmul_t", "selective_scan",
                 "selective_scan_bwd"):
        launches[name] += tokens_launches[name]
    for name in ("lora_matmul", "quant_matmul_t", "quant_matmul",
                 "blockwise_quant", "selective_scan", "selective_scan_bwd"):
        launches[name] += zoo_launches[name] + rt_launches[name]
    launches["flash_attention"] += rt_launches["flash_attention"]
    # the tc route runs on phases 13-15's paths
    launches["quant_matmul_tc"] = (zoo_launches["quant_matmul_tc"] +
                                   rt_launches["quant_matmul_tc"])
    if launches["quant_matmul_tc"] < 1:
        raise AssertionError("phases 13-14 launched no tc quant_matmul")
    for name in main_rows:
        launches[name] += dry_launches[name]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for name, row in main_rows.items()]}), flush=True)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
