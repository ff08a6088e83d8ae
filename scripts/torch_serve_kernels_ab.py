#!/usr/bin/env python3
"""Time the serving plane's two kernels of the PyTorch port,
``quant_matmul`` and ``blockwise_quant``, in two source trees on one
card, in turns, at the shapes the serve replay launches (and the GEMV at a Kimi-K2
expert's decode row).

    python3 scripts/torch_serve_kernels_ab.py OTHER_TREE [--order ABBA]
        [--serve] [--memory]
    python3 scripts/torch_serve_kernels_ab.py --sweep

OTHER_TREE is another checkout of this repository (for example the
parent commit unpacked with ``git archive``). Each turn runs in its own
process with that tree's ``chip_smoke.py`` and ``src/`` first on the
path, so it builds and loads that tree's kernels; ``--order`` names the
turns, ``A`` the other tree and ``B`` this one (default ``ABBA``). A turn
times every case with ``chip_smoke.timings`` (device ms from the
profiler, call ms from CUDA events, 50 back-to-back calls on the same
inputs, so the 2-3 MB of operands stay in the 50 MB L2 as they do
between the replay's gather and its head) and with :func:`host_us` (the
host's time to issue one call), and prints one JSON line.

``--serve``: a turn also runs that tree's ``chip_smoke.serve_phase`` with
its own defaults (the Zipf trace at CLIP ViT-B/32 width through an int8
store, its oracle checks), its profiled replay taken twice, and reports
each replay's wall and device busy seconds and the device ms of the two
kernels in it (by kernel name: ``qmv_kernel`` or ``QmvOut``, ``qmm_kernel``,
``bq_kernel``).

``--memory``: one more turn per label, each in a fresh process: that
tree's ``chip_smoke.train_phase`` on Yi-9B, then on Falcon-Mamba-7B, with
their ``max_memory_allocated``.

The last line is the table of device ms, host us and the other readings
by case and turn. ``--sweep`` instead times this tree's GEMV under every
plan (column tile x cluster size) at the serve shape. It needs one card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (name, T users, M rows a user, K, N, bits, mode, x dtype); T = 4 is
# the replay's every launch (a family group pads to MIN_COHORT_BUCKET)
QMM_CASES = [
    ("serve_t4_int8", 4, 1, 768, 768, 8, "linear", "float32"),
    ("serve_t1_int8", 1, 1, 768, 768, 8, "linear", "float32"),
    ("serve_t8_int8", 8, 1, 768, 768, 8, "linear", "float32"),
    # the same GEMV at a Kimi-K2 expert's one decode row (NF4, bf16 x)
    ("kimi_expert_wg_wu", 1, 1, 7168, 2048, 4, "nf4", "bfloat16"),
    ("kimi_expert_wd", 1, 1, 2048, 7168, 4, "nf4", "bfloat16"),
]
BQ_CASES = [(768, 768, 8), (768, 768, 4)]     # the store's (K, N, bits)
# a kernel by the names it has had: the GEMV is gemv_kernel with the
# QmvOut epilogue since the decode route of lora_matmul shares it
KERNEL_NAMES = {"qmv_kernel": ("qmv_kernel", "QmvOut"),
                "qmm_kernel": ("qmm_kernel",), "bq_kernel": ("bq_kernel",)}


def host_us(torch, fn, calls: int = 200, repeats: int = 15) -> tuple:
    """The host's time to issue one call of ``fn`` (us): median and min
    over ``repeats`` runs of ``calls`` back-to-back calls, the card
    drained between runs and outside the timed span. At these shapes
    the card finishes a call's kernel before the host has issued the
    next, so the queue stays short and this is the host's dispatch."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per), min(per)


def replays_profiler(cs, torch):
    """A stand-in for ``chip_smoke.profile_replay`` that replays twice
    under the profiler and keeps, per replay, wall and device busy
    seconds and the port kernels' device ms and launches by name."""
    cuda = torch.autograd.DeviceType.CUDA

    def profile(engine, trace, images) -> dict:
        out = []
        for _ in range(2):
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                cs.serve_lib.replay(engine, trace, images,
                                    collect_logits=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy, kern = 0.0, {k: [0.0, 0] for k in KERNEL_NAMES}
            for e in prof.events():
                if e.device_type != cuda:
                    continue
                us = e.time_range.elapsed_us()
                busy += us
                for k, names in KERNEL_NAMES.items():
                    if any(n in e.name for n in names):
                        kern[k][0] += us / 1e3
                        kern[k][1] += 1
            out.append({"wall_s": wall, "device_busy_s": busy / 1e6,
                        "kernel_ms_and_launches": kern})
        return {"replays": out}
    return profile


def kernels_turn(cs, torch, serve: bool) -> dict:
    cs.build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    for name, T, M, K, N, bits, mode, dt in QMM_CASES:
        w = torch.randn((T, K, N), generator=gen, device="cuda") / K ** 0.5
        qt = cs.qlib.quantize(w, bits=bits, block=64, mode=mode)
        x = torch.randn((T, M, K), generator=gen, device="cuda").to(
            getattr(torch, dt))
        want = cs.ref.quant_matmul(x, qt)
        _, rel = cs.rel_err(cs.qmm_kernel.quant_matmul(x, qt), want)
        run = lambda: cs.qmm_kernel.quant_matmul(x, qt)  # noqa: E731
        dev, call = cs.timings(run)
        rows[name] = {"ms": dev, "call_ms": call,
                      "host_us": host_us(torch, run), "rel_err": rel}
    for K, N, bits in BQ_CASES:
        x = torch.randn((K, N), generator=gen, device="cuda")
        run = lambda: cs.bq_kernel.blockwise_quant(  # noqa: E731
            x, bits=bits, block=64)
        got = run()
        want = cs.ref.blockwise_quant(x, bits=bits, block=64)
        equal = bool(torch.equal(got.q, want.q)
                     and torch.equal(got.scales, want.scales))
        dev, call = cs.timings(run)
        rows[f"bq_({K},{N})_int{bits}"] = {
            "ms": dev, "call_ms": call, "host_us": host_us(torch, run),
            "bitwise": equal}
    rec = {"rows": rows}
    if serve:
        cs.profile_replay = replays_profiler(cs, torch)
        res = cs.serve_phase("cuda", cs.VIT_B32)
        rec["serve"] = res["profile"]["replays"]
        rec["serve_errs"] = {k: res[k] for k in (
            "err_int8", "err_int4_vs_dequant", "err_fp32")}
    return rec


def memory_turn(cs, torch) -> dict:
    cs.build.build_all()
    out = {}
    for arch in ("yi-9b", "falcon-mamba-7b"):
        before = torch.cuda.memory_allocated()
        res = cs.train_phase(arch=arch)
        out[arch] = {"max_memory_allocated": res["max_memory_allocated"],
                     "allocated_before": before}
        del res
        torch.cuda.empty_cache()
    return {"memory": out}


def sweep() -> None:
    """The GEMV's device time under every plan (column tile x cluster
    size dividing the 12 quant groups) at the serve shape with 1, 4 and
    8 users, int8; the one ``quant_matmul.plan`` picks is marked. Beside
    it, the device time of a 1-element fill, the card's floor for any
    one launch in this measurement."""
    sys.path.insert(0, str(HERE))
    import torch
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    qmm = cs.qmm_kernel
    buf = torch.empty(1, device="cuda")
    cs.report({"launch_floor_fill_ms": cs.timings(lambda: buf.zero_())[0]})
    gen = torch.Generator(device="cuda").manual_seed(1234)
    G, K, N = 12, 768, 768
    for T in (1, 4, 8):
        w = torch.randn((T, K, N), generator=gen, device="cuda") / K ** 0.5
        qt = cs.qlib.quantize(w, bits=8, block=64)
        x = torch.randn((T, 1, K), generator=gen, device="cuda")
        want = cs.ref.quant_matmul(x, qt)
        pick = qmm.plan(T, 1, G, N)
        times = {}
        for cols in (64, 128, 256):
            for c in (1, 2, 3, 4, 6, 12):
                pl = qmm.GemvPlan(users=T, cols=cols, tiles=-(-N // cols),
                                  cluster=c, groups=qmm.group_ranges(G, c))
                run = lambda: qmm._quant_matmul(x, qt, pl)  # noqa: E731
                _, rel = cs.rel_err(run(), want)
                if rel > 1e-5:
                    raise AssertionError(f"GEMV plan ({cols}, {c}) at T={T}: "
                                         f"rel err {rel}")
                times[f"{cols}x{c}{'*' if pl == pick else ''}"] = \
                    cs.timings(run)[0]
        print(f"quant_matmul GEMV at T={T} by plan (cols x cluster, * the "
              f"pick; device ms): " + " ".join(
                  f"{k}={v:.4g}" for k, v in times.items()), flush=True)


def child(tree: str, mode: str) -> None:
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"tree": tree, "card": cs.card_line()}
    if mode == "memory":
        rec.update(memory_turn(cs, torch))
    else:
        rec.update(kernels_turn(cs, torch, serve=mode == "serve"))
    print(json.dumps(rec), flush=True)


def run_turns(trees: dict, order: str, mode: str) -> list:
    turns = []
    for label in order:
        out = subprocess.run(
            [sys.executable, __file__, "--child", trees[label], mode],
            capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            raise SystemExit(out.returncode)
        turns.append((label, json.loads(out.stdout.strip().splitlines()[-1])))
    return turns


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2])
        return 0
    if argv[:1] == ["--sweep"]:
        sweep()
        return 0
    trees = {"A": str(Path(argv[0]).resolve()), "B": str(HERE)}
    order = argv[argv.index("--order") + 1] if "--order" in argv else "ABBA"
    turns = run_turns(trees, order, "serve" if "--serve" in argv
                      else "kernels")
    table = {case: [(label, t["rows"][case]["ms"], t["rows"][case]["host_us"])
                    for label, t in turns]
             for case in turns[0][1]["rows"]}
    if "--serve" in argv:
        table["serve_device_busy_s"] = [
            (label, [r["device_busy_s"] for r in t["serve"]])
            for label, t in turns]
    if "--memory" in argv:
        table["max_memory_allocated"] = [
            (label, {a: m["max_memory_allocated"]
                     for a, m in t["memory"].items()})
            for label, t in run_turns(trees, order, "memory")]
    print(json.dumps({"device_ms_host_us_by_turn": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
