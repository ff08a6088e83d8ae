"""Serving CLI, port of ``repro.launch.serve``.

Usage (on the card; ``main(argv, device="cpu")`` runs it on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --adapters 8 --requests 48

``--adapters N`` is the personalized-adapter serving plane
(:mod:`repro_torch.fl.serve`): train N per-user adapter trees
(``demo_plane``), replay a Zipf/diurnal request trace through the
multi-tenant batched engine, and print virtual-latency percentiles and
the cache and program ledgers. The token-decode mode (prefill, then
decode against a ring KV cache) is not ported yet: it raises, naming
``ROADMAP.md`` Queue A item 8.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device


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


def main(argv=None, device=None):
    """The serving CLI; ``device`` (the card unless given) is for callers
    that run it on the CPU."""
    args = build_parser().parse_args(argv)
    if not args.adapters:
        raise NotImplementedError(
            "the token-decode mode (prefill and decode with ring caches) "
            "is not ported yet: ROADMAP.md Queue A item 8, part 2")
    return run_adapter_mode(args, resolve_device(device))


if __name__ == "__main__":
    main()
