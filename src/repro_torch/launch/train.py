"""Federated training entry point, port of ``repro.launch.train``.

Runs TriplePlay federated fine-tuning of an assigned backbone: every FL
client holds a frozen (optionally NF4/int4-quantized) copy of the model
and trains only LoRA + adapter on its local token stream; each round the
quantized client deltas are weighted-averaged into the global trainables.

Usage, on the card (the full Yi-9B fits one H100 with an NF4 backbone):
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
      --full-config --quant 4
and on the CPU at the reduced size, from Python:
  from repro_torch.launch.train import main
  main(["--arch", "yi-9b", "--rounds", "2"], device="cpu")
Every arch of the zoo trains as in the JAX package: the client's batch
is text only, so a vlm arch trains its text decoder and an encdec arch
(whisper-medium) fails for want of ``frames``, in both packages.
``--ckpt PATH`` saves the FL server state (round, global trainables,
client sizes; ``repro_torch.ckpt``) after every round and resumes from
PATH when it exists, as the JAX package's trainer does.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.ckpt import restore_fl_state, save_fl_state
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import optim
from repro_torch.core.quant import dequantize_tree, quantize_tree, tree_bytes
from repro_torch.models import build_model


def synthetic_token_stream(rng, vocab, n_clients, docs_per_client=64,
                           seq=128):
    """Per-client token corpora with client-specific n-gram statistics
    (non-IID: each client favours a different token sub-range). numpy
    only, so it equals the JAX package's stream bit for bit."""
    out = []
    for c in range(n_clients):
        lo = (c * vocab) // (2 * n_clients)
        hi = lo + vocab // 2
        toks = rng.randint(lo, hi, (docs_per_client, seq + 1))
        # inject structure: repeat bigrams so there is something to learn
        toks[:, 2::2] = toks[:, 1:-1:2]
        out.append(toks.astype(np.int32))
    return out


def local_steps_for(n_docs: int, *, base_steps: int, batch: int,
                    epochs: float = 0.0) -> int:
    """Per-client local step count: ``epochs`` E > 0 sizes the round so
    the client covers its corpus E times at this batch size; E == 0 keeps
    the flat ``base_steps``."""
    if epochs <= 0:
        return int(base_steps)
    return max(1, -(-int(round(epochs * n_docs)) // int(batch)))


def make_batch(toks: np.ndarray, device) -> dict:
    t = torch.as_tensor(toks, dtype=torch.int32, device=device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:],
            "mask": torch.ones(t[:, 1:].shape, dtype=torch.float32,
                               device=device)}


def client_update(model, frozen, global_tr, data, *, steps, batch, lr,
                  comm_bits, seed):
    """One client's local round; returns ``(delta, uplink_bytes, loss,
    n_steps, n_samples)``. The batch indices come from
    ``np.random.RandomState(seed)``, as in the JAX package. The uplink
    quantizes every delta leaf of at least 256 elements, the LoRA
    factors included, in blocks of 64."""
    rng = np.random.RandomState(seed)
    dev = tree_lib.leaves(global_tr)[0].device
    tr = global_tr
    opt = optim.adam_init(tr)
    loss = 0.0
    for _ in range(steps):
        idx = rng.randint(0, len(data), batch)
        tr, opt, m = model.train_step(frozen, tr, opt,
                                      make_batch(data[idx], dev), lr=lr)
        loss = float(m["loss"])
    delta = tree_lib.tree_map(lambda a, b: (a - b).to(torch.float32), tr,
                              global_tr)
    if comm_bits:
        delta = quantize_tree(delta, bits=comm_bits, block=64,
                              min_size=256, skip_names=("slot",))
    return delta, tree_bytes(delta), loss, int(steps), int(steps * batch)


def aggregate(global_tr, updates):
    """FedAvg of the (dequantized) deltas, weighted by client data size."""
    total = sum(m for m, _ in updates)
    acc = None
    for m, d in updates:
        dd = dequantize_tree(d, torch.float32)
        w = m / total
        acc = tree_lib.tree_map(lambda x: w * x, dd) if acc is None else \
            tree_lib.tree_map(lambda a, x: a + w * x, acc, dd)
    return tree_lib.tree_map(
        lambda g, a: (g.to(torch.float32) + a).to(g.dtype), global_tr, acc)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-epochs", type=float, default=0.0,
                    help="size each client's round to cover its corpus "
                         "this many times; 0 = flat --local-steps")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--quant", type=int, default=4, choices=[0, 4, 8],
                    help="backbone quantization bits (QLoRA)")
    ap.add_argument("--comm-bits", type=int, default=8, choices=[0, 4, 8])
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-reduced) architecture")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint path; saves the FL server state every "
                         "round and resumes from it if present")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """The trainer's CLI; ``device`` (the card unless given) is for
    callers that run it on the CPU."""
    args = parse_args(argv)
    dev = resolve_device(device)
    cfg = (get_config if args.full_config else get_reduced)(args.arch)
    if args.quant:
        cfg = cfg.replace(quant_bits=args.quant, quant_mode="nf4",
                          quant_block=64)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    frozen, global_tr = params["frozen"], params["trainable"]
    frozen_bytes = tree_bytes(frozen)
    print(f"arch={cfg.name} family={cfg.family} "
          f"backbone={frozen_bytes/2**20:.1f}MiB "
          f"(quant_bits={cfg.quant_bits}) trainable="
          f"{tree_bytes(global_tr)/2**20:.2f}MiB device={dev}", flush=True)

    rng = np.random.RandomState(0)
    data = synthetic_token_stream(rng, cfg.vocab_size, args.clients,
                                  seq=args.seq)
    start_round = 0
    if args.ckpt and os.path.exists(args.ckpt):
        global_tr, _, start_round, _ = restore_fl_state(
            args.ckpt, like_trainable=global_tr)
        print(f"resumed from {args.ckpt} at round {start_round}")
    total_steps = total_samples = total_uplink = 0
    for rnd in range(start_round, args.rounds):
        t0 = time.time()
        updates, losses, payload = [], [], 0
        rnd_steps = rnd_samples = 0
        for c in range(args.clients):
            steps_c = local_steps_for(len(data[c]),
                                      base_steps=args.local_steps,
                                      batch=args.batch,
                                      epochs=args.local_epochs)
            d, nbytes, loss, n_steps, n_samples = client_update(
                model, frozen, global_tr, data[c], steps=steps_c,
                batch=args.batch, lr=args.lr, comm_bits=args.comm_bits,
                seed=rnd * 100 + c)
            updates.append((len(data[c]), d))
            losses.append(loss)
            payload += nbytes
            rnd_steps += n_steps
            rnd_samples += n_samples
        global_tr = aggregate(global_tr, updates)
        total_steps += rnd_steps
        total_samples += rnd_samples
        total_uplink += payload
        if args.ckpt:
            save_fl_state(args.ckpt, round_idx=rnd + 1,
                          global_trainable=global_tr,
                          client_sizes=[len(d) for d in data])
        epochs_covered = rnd_samples / max(1, sum(len(d) for d in data))
        print(f"round {rnd}: mean client loss={np.mean(losses):.4f} "
              f"uplink={payload/2**20:.2f}MiB "
              f"local_steps={rnd_steps} epochs={epochs_covered:.2f} "
              f"({time.time()-t0:.1f}s)", flush=True)
    print(f"done: total_local_steps={total_steps} "
          f"total_samples={total_samples} "
          f"total_uplink={total_uplink/2**20:.2f}MiB")
    return global_tr


if __name__ == "__main__":
    main()
