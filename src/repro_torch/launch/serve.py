"""Serving CLI, port of ``repro.launch.serve``: prefill a prompt batch,
then decode against the ring KV (or SSM state) cache; or, with
``--adapters``, the personalized-adapter serving plane.

Usage (on the card; ``main(argv, device="cpu")`` runs it on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
      --full-config --quant 4 --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --adapters 8 --requests 48

The token mode builds ``--arch`` (the reduced config, or the full one
with ``--full-config``; ``--quant 4`` an NF4 backbone at block 64) on
seeded weights, draws the prompt from ``np.random.RandomState(0)`` as
the JAX package does, prefills with room for ``P + G`` tokens and
decodes G - 1 more, greedy or sampled from a ``torch.Generator`` seeded
by ``--seed``. A vlm arch's image embeddings (its ``n_patches`` before
the prompt, which the cache and the positions count) and an encdec
arch's audio frames are drawn from the same ``RandomState(0)`` after the
prompt, in the JAX package's order. Inside the decode loop the position
advances on the device and the tokens stay there until the loop ends,
so the loop makes no host read. Every family of the zoo runs.

``--adapters N`` is the personalized-adapter serving plane
(:mod:`repro_torch.fl.serve`): train N per-user adapter trees
(``demo_plane``), replay a Zipf/diurnal request trace through the
multi-tenant batched engine, and print virtual-latency percentiles and
the cache and program ledgers.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.fl.runtime import upload
from repro_torch.models import build_model


def select_token(logits: torch.Tensor, *, greedy: bool,
                 temperature: float = 1.0,
                 generator: torch.Generator = None) -> torch.Tensor:
    """One decode step's token choice over ``logits (B, V)``: argmax when
    ``greedy``, else temperature-scaled categorical sampling from
    ``generator`` (required). Returns ``(B, 1)`` int32."""
    if greedy:
        tok = torch.argmax(logits, -1)
    else:
        if generator is None:
            raise ValueError("sampling needs a torch.Generator")
        if temperature <= 0:
            raise ValueError("temperature must be > 0 when sampling")
        probs = torch.softmax(logits.to(torch.float32) / temperature, -1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return tok[:, None].to(torch.int32)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--quant", type=int, default=0, choices=[0, 4, 8])
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--greedy", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="argmax decode (default); --no-greedy samples")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="sampling temperature (with --no-greedy)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adapters", type=int, default=0, metavar="N",
                    help="serve N personalized adapter tenants instead "
                         "of the token-decode path")
    ap.add_argument("--requests", type=int, default=64,
                    help="trace length for --adapters mode")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="serve flight cap for --adapters mode")
    ap.add_argument("--cache-entries", type=int, default=0,
                    help="adapter-cache capacity (0 = full population)")
    return ap


def run_adapter_mode(args, device=None) -> dict:
    """The ``--adapters`` mode on ``device``; prints the reference's lines
    and returns the replay's record and the plane."""
    from repro_torch.fl import serve as serve_lib

    n = args.adapters
    cap = args.cache_entries or None
    plane = serve_lib.demo_plane(
        n, mixed=n >= 2, seed=args.seed, quant_bits=args.quant or 8,
        max_entries=cap, max_batch=args.max_batch, device=device)
    trace = serve_lib.zipf_request_trace(
        n, args.requests, seed=args.seed, rate=200.0, period=1.0,
        amplitude=0.5)
    images = serve_lib.request_images(plane, trace, seed=args.seed)
    rec = serve_lib.replay(plane["engine"], trace, images)
    st = plane["store"].stats()
    print(f"adapters={n} requests={rec['n_requests']} "
          f"concurrency={rec['concurrency']} trace={rec['trace']}")
    print(f"flights={rec['n_flights']} "
          f"lat_v p50={rec['lat_v_p50']*1e3:.2f}ms "
          f"p99={rec['lat_v_p99']*1e3:.2f}ms "
          f"throughput={rec['throughput_v']:.0f} req/vs")
    print(f"cache: hits={st['hits']} misses={st['misses']} "
          f"evictions={st['evictions']} "
          f"hit_rate={rec['store']['hit_rate']:.2f} "
          f"bytes_at_rest={plane['store'].bytes_at_rest()}")
    for kind, row in sorted(plane["runtime"].stats().items()):
        print(f"ledger {kind}: {row}")
    return {"rec": rec, "plane": plane}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_loop(model, frozen, trainable, cache, tok, pos, steps: int, *,
                greedy: bool, temperature: float = 1.0,
                generator: torch.Generator = None) -> list:
    """``steps`` decode steps from token ``tok`` (B, 1) at position
    ``pos`` (a 0-d int32 tensor on the model's device), each choosing the
    next token with :func:`select_token`. ``pos`` advances on the
    device and the tokens stay there: the loop reads nothing back to the
    host. Returns the chosen tokens, one (B, 1) tensor a step."""
    out = []
    for _ in range(steps):
        logits, cache = model.decode_step(frozen, trainable, cache, tok, pos)
        tok = select_token(logits, greedy=greedy, temperature=temperature,
                           generator=generator)
        out.append(tok)
        pos = pos + 1
    return out


def run_token_mode(args, device) -> dict:
    """The token-decode mode on ``device``: prints the JAX package's
    lines and returns the tokens (B, G), the prefill and decode times in
    seconds and what a caller needs to step the model again (``model``,
    ``params``, ``prompt``, the prefill's ``batch`` and ``max_len``, the
    first decode position ``pos0``)."""
    cfg = (get_config if args.full_config else get_reduced)(args.arch)
    if args.quant:
        cfg = cfg.replace(quant_bits=args.quant, quant_mode="nf4",
                          quant_block=64)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(0), device=device)
    frozen, tr = params["frozen"], params["trainable"]

    B, P, G = args.batch, args.prompt_len, args.gen
    n_img = cfg.n_patches if cfg.family == "vlm" else 0
    rng = np.random.RandomState(0)
    prompt = upload(rng.randint(0, cfg.vocab_size, (B, P)), device,
                    torch.int32)
    batch = {"tokens": prompt}
    if cfg.family == "vlm":
        batch["image_embeds"] = upload(
            (rng.randn(B, cfg.n_patches, cfg.d_model) * 0.02).astype(
                np.float32), device, torch.float32)
    if cfg.family == "encdec":
        batch["frames"] = upload(
            (rng.randn(B, cfg.n_frames, cfg.d_model) * 0.02).astype(
                np.float32), device, torch.float32)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    choose = dict(greedy=args.greedy, temperature=args.temperature,
                  generator=gen)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(frozen, tr, batch, max_len=n_img + P + G)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    tok = select_token(logits, **choose)
    pos = torch.full((), n_img + P, dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    out = decode_loop(model, frozen, tr, cache, tok, pos, G - 1, **choose)
    _sync(device)
    t_decode = time.perf_counter() - t0
    toks = torch.cat([tok, *out], 1).cpu().numpy()
    mode = "greedy" if args.greedy else f"sample(T={args.temperature:g})"
    print(f"arch={cfg.name} batch={B} prompt={P} gen={G} mode={mode}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({B*P/t_prefill:.0f} tok/s)")
    print(f"decode : {t_decode*1e3:.1f} ms total, "
          f"{B*(G-1)/max(t_decode,1e-9):.0f} tok/s")
    print("sample token ids:", toks[0, :16].tolist(), flush=True)
    return {"tokens": toks, "prefill_s": t_prefill, "decode_s": t_decode,
            "model": model, "params": params, "prompt": prompt,
            "batch": batch, "max_len": n_img + P + G, "pos0": n_img + P}


def main(argv=None, device=None):
    """The serving CLI; ``device`` (the card unless given) is for callers
    that run it on the CPU."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    if args.adapters:
        return run_adapter_mode(args, dev)
    return run_token_mode(args, dev)


if __name__ == "__main__":
    main()
