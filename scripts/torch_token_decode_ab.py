"""Prefill and decode times of the token mode for the families whose
steps call ``quant_matmul`` (RecurrentGemma-2B's MLP, Kimi-K2's experts),
run bare and under ``chip_smoke.record_quant_matmul`` (the per-call route
recorder that ``chip_smoke.py`` wraps around phases 13-15), for the
checkout at ROOT. Full width, seeded weights, NF4, the depth cuts and
token counts of ``chip_smoke.py`` (Kimi-K2 at 3 layers on an NCCL world
of one rank).

    python3 scripts/torch_token_decode_ab.py ROOT [--repeat 2]

Needs one CUDA card. Prints one line a run: the tree, the arch, whether
the recorder was on, prefill ms and decode ms a token (serve's own
timers, synchronized), then the card's name and power limit. To compare
two commits, unpack both and run parent, change, change, parent in one
call."""
import argparse
import contextlib
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import runtime as rt_lib
    cs.setup()
    rt = cs.mesh_runtime("cuda")

    def rgemma():
        argv = cs.serve_argv("recurrentgemma-2b")
        with contextlib.redirect_stdout(sys.stderr):
            return serve_cli.main(argv, device="cuda"), cs.SERVE_TOKENS["gen"]

    def kimi():
        t = cs.KIMI_TOKENS
        argv = ["--arch", cs.KIMI, "--full-config", "--quant", "4",
                "--batch", str(t["batch"]), "--prompt-len", str(t["prompt"]),
                "--gen", str(t["gen"])]
        with cs.cut_depth(serve_cli, cs.KIMI, cs.KIMI_LAYERS), \
                rt_lib.runtime(rt), contextlib.redirect_stdout(sys.stderr):
            return serve_cli.main(argv, device="cuda"), t["gen"]

    for name, run in (("recurrentgemma-2b", rgemma), ("kimi-k2", kimi)):
        for rep in range(args.repeat):
            for recorded in (False, True):
                ctx = cs.record_quant_matmul() if recorded else \
                    contextlib.nullcontext({})
                t0 = time.perf_counter()
                with ctx as calls:
                    out, G = run()
                wall = time.perf_counter() - t0
                print(f"tree={os.path.basename(root)} arch={name} rep={rep} "
                      f"recorded={recorded} "
                      f"prefill_ms={out['prefill_s'] * 1e3:.4g} "
                      f"decode_ms_per_token="
                      f"{out['decode_s'] / (G - 1) * 1e3:.4g} "
                      f"wall_s={wall:.4g} "
                      f"recorded_calls={sum(dict(calls).values())}",
                      flush=True)
                del out
                torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
