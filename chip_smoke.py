#!/usr/bin/env python3
"""Drive the PyTorch port's serving plane once on one NVIDIA H100.

    python3 chip_smoke.py

Phases (a failed phase raises and the script exits non-zero):
 1. set-up: the card's name and power limit, TF32 off, and a build of
    every CUDA kernel from ``src/repro_torch/kernels/csrc``;
 2. each kernel against its plain PyTorch version on the card, at the
    serve path's shapes and at edge shapes, with times beside its bound;
 3. the serving plane at CLIP ViT-B/32 width (seeded weights): 16 users,
    half adapter-only and half LoRA, an int8-at-rest store with
    evictions, a Zipf request trace replayed through ``ServeEngine``, and
    the per-request ``serve_sequential`` oracle; then one flight at int4
    and one unquantized. The kernel launch counts are zeroed just before
    this phase and read right after it.
The last two lines are the ``kernels`` record and the device record.
It needs one card, imports nothing of JAX, and runs nothing on the CPU
in place of a kernel.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.core import clip as clip_lib  # noqa: E402
from repro_torch.core import quant as qlib  # noqa: E402
from repro_torch.data.synthetic import SPECS, class_tokens  # noqa: E402
from repro_torch.fl import client as client_lib  # noqa: E402
from repro_torch.fl import serve as serve_lib  # noqa: E402
from repro_torch.fl.strategies import STRATEGIES  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import blockwise_quant as bq_kernel  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm_kernel  # noqa: E402

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

REPLACES = {
    "quant_matmul": "src/repro/kernels/quant_matmul.py:66",
    "blockwise_quant": "src/repro/kernels/blockwise_quant.py:38",
    "flash_attention": "src/repro/kernels/flash_attention.py:72",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}


# -- measurement helpers -----------------------------------------------

def timings(fn, iters: int = 50) -> tuple:
    """(device ms, call ms) per call of ``fn()``. Device time is the sum
    of the card's kernel and copy activities that ``torch.profiler``
    records over ``iters`` calls (what the kernels themselves take);
    call time comes from CUDA events around ``iters`` back-to-back calls
    and includes the host's dispatch, which bounds it at small shapes.
    Device time is None when the profiler records no device activity."""
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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
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


def report(row: dict) -> None:
    print("  " + " ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in row.items()), flush=True)


# -- phase 1: set-up ---------------------------------------------------

def setup() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)


# -- phase 2: kernels against their plain versions ---------------------

def check_quant_matmul(gen) -> dict:
    """Every format and dtype at the serve shape (8 users x 1 row,
    768x768, block 64), one large shape and the odd-K / ragged-N edge.
    Returns the serve-shape int8 record."""
    dev = "cuda"
    cases = [  # (name, T, M, K, N, bits, mode, dtype)
        ("serve_int8", 8, 1, 768, 768, 8, "linear", torch.float32),
        ("serve_int4", 8, 1, 768, 768, 4, "linear", torch.float32),
        ("serve_nf4", 8, 1, 768, 768, 4, "nf4", torch.float32),
        ("serve_int8_bf16", 8, 1, 768, 768, 8, "linear", torch.bfloat16),
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
        if T:
            x = x[:, 0] if M == 1 else x     # (T, K): one row per user
        got = qmm_kernel.quant_matmul(x, qt)
        want = ref.quant_matmul(x, qt)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, want)
        tol = 1e-5 if dtype == torch.float32 else 1.6e-2
        if not (rel_e <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"quant_matmul {name}: rel err {rel_e} > {tol}")
        Kq = qt.q.shape[-3] * qt.block
        b_ms, b_by = bound(nbytes(x, qt.q, qt.scales, got),
                           2.0 * max(T, 1) * M * Kq * N, dtype)
        row = {"case": name, "max_abs_err": abs_e, "rel_err": rel_e,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        timed(row, "ms", lambda: qmm_kernel.quant_matmul(x, qt))
        timed(row, "plain_ms", lambda: ref.quant_matmul(x, qt))
        report({"quant_matmul": 1, **row})
        if name == "serve_int8":
            main = row
    return main


def check_blockwise_quant(gen) -> dict:
    """int8 and int4 at the store's (768, 768) block 64 and at the odd
    (100, 70); payload and scales must equal the plain version bitwise."""
    main = None
    for K, N in ((768, 768), (100, 70)):
        for bits in (8, 4):
            x = torch.randn((K, N), generator=gen, device="cuda")
            got = bq_kernel.blockwise_quant(x, bits=bits, block=64)
            want = ref.blockwise_quant(x, bits=bits, block=64)
            torch.cuda.synchronize()
            if not (torch.equal(got.q, want.q) and
                    torch.equal(got.scales, want.scales) and
                    got.orig_shape == want.orig_shape):
                raise AssertionError(
                    f"blockwise_quant ({K},{N}) int{bits}: not bitwise equal "
                    f"({(got.q != want.q).sum().item()} codes, "
                    f"{(got.scales != want.scales).sum().item()} scales)")
            b_ms, b_by = bound(nbytes(x, got.q, got.scales),
                               3.0 * x.numel(), torch.float32)
            row = {"case": f"({K},{N})_int{bits}",
                   "max_abs_err": (got.scales - want.scales).abs().max().item(),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            timed(row, "ms", lambda: bq_kernel.blockwise_quant(
                x, bits=bits, block=64))
            timed(row, "plain_ms", lambda: ref.blockwise_quant(
                x, bits=bits, block=64))
            report({"blockwise_quant": 1, **row})
            if (K, N, bits) == (768, 768, 8):
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
    (Hkv=2) causal window-64 case, plus a bf16 run."""
    cases = [  # (name, B, S, H, Hkv, D, causal, window, dtype)
        ("serve_1x1x4x192", 1, 1, 4, 4, 192, False, None, torch.float32),
        ("gqa_causal_w64", 2, 300, 8, 2, 64, True, 64, torch.float32),
        ("bidir_d256", 1, 77, 4, 4, 256, False, None, torch.float32),
        ("gqa_causal_bf16", 2, 300, 8, 2, 64, True, None, torch.bfloat16),
    ]
    main = None
    for name, B, S, H, Hkv, D, causal, window, dtype in cases:
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
        run = lambda: fa_kernel.flash_attention(q, k, v, causal=causal,
                                                window=window)
        got = run()
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
        row = {"case": name, "max_abs_err": abs_e, "rel_err": rel_e,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        timed(row, "ms", run)
        timed(row, "plain_ms", lambda: ref.flash_attention(
            q, k, v, causal=causal, window=window))
        if window is None:   # SDPA has no sliding window
            sdpa = torch.nn.functional.scaled_dot_product_attention
            timed(row, "library_ms",
                  lambda: sdpa(qt_, kt_, vt_, is_causal=causal))
        report({"flash_attention": 1, **row})
        if name.startswith("serve"):
            main = row
    return main


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
            "after_replay": after_replay,
            "rec": rec, "err_int8": err8, "err_int4_vs_dequant": err4_deq,
            "err_int4_vs_fp32": err4_fp, "err_fp32": err0,
            "oracle_s": oracle_s, "store": engine.store.stats(),
            "bytes_at_rest": engine.store.bytes_at_rest()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    setup()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    print("kernels vs plain versions:", flush=True)
    main_rows = {"quant_matmul": check_quant_matmul(gen),
                 "blockwise_quant": check_blockwise_quant(gen),
                 "flash_attention": check_flash_attention(gen)}

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
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the serve path launched no {name} kernel")

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
