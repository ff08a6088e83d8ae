#!/usr/bin/env python3
"""Measure whether one federated round at CLIP ViT-B/32 width is
determined by its inputs to fp32 precision.

    python3 scripts/torch_round_branches.py [--probes 3] [--eps-log2 -22]

Builds the tripleplay round of ``chip_smoke.py``'s phase 9 (seeded
ViT-B/32 weights, NF4 backbone, 5 clients rebalanced by the fleet GAN,
10 local steps of 32 rows) with the global trainables drawn third from
phase 9's generator, after the fedclip and qlora_nogan arms' draws. It
runs the round on the stacked cohort engine and on the sequential
oracle, then ``--probes`` more times on the oracle with every input
image element times 1 +- 2^eps_log2 (seeded signs). It prints each
pair's distance as ``chip_smoke.round_diffs`` measures it (the largest
per-leaf ||a - b|| over the norm of the round's update), the largest
last-step loss and accuracy differences, and the card's name and power
limit. Where the oracle's own perturbed runs land as far from it as the
cohort does, and close to the cohort, the round has two branches that
rounding picks between. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def perturbed(clients, eps: float, seed: int) -> list:
    """Copies of ``clients`` whose images and rebalancing rows are each
    element times 1 +- ``eps``, signs from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    jitter = lambda a: None if a is None else (a * (1 + eps * np.sign(
        rs.randn(*a.shape)))).astype(np.float32)
    return [dataclasses.replace(c, images=jitter(c.images),
                                aug_images=jitter(c.aug_images))
            for c in clients]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probes", type=int, default=3)
    ap.add_argument("--eps-log2", type=float, default=-22.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cs.setup()
    ccfg, dev, steps, batch, seed = cs.VIT_B32, "cuda", 10, 32, 0
    data = cs.make_dataset("pacs", n_per_class=60, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frozen0 = cs.clip_lib.init_clip(gen, ccfg, device=dev)
    strat = cs.STRATEGIES["tripleplay"]
    for arm in ("fedclip", "qlora_nogan"):   # phase 9's earlier draws
        cs.client_lib.init_trainable(gen, ccfg, cs.STRATEGIES[arm],
                                     device=dev)
    g0 = cs.client_lib.init_trainable(gen, ccfg, strat, device=dev)
    frozen = cs.nf4_round_trip(frozen0)[0]
    ce = cs.class_embedding(frozen, ccfg, dev)
    clients = cs.rebalanced_clients(data, 5, 0.5, seed, strat, 7,
                                    gan_steps=150, device=dev)
    key = cs.cohort_lib.RoundKey(cs.cohort_lib.SeededDraws(seed), (3, 0))
    trace = cs.sched_lib.uniform_trace(len(clients))

    def sequential(cl):
        return cs.sched_lib.FullSyncScheduler(
            executor=cs.sched_lib.SequentialExec(
                clients=cl, frozen=frozen, ccfg=ccfg, class_emb=ce,
                local_steps=steps, batch_size=batch, lr=3e-3),
            trace=trace, local_steps=steps).step(g0, 0, key)

    engine = cs.cohort_lib.CohortEngine(
        frozen=frozen, ccfg=ccfg, class_emb=ce, clients=clients,
        cfg=cs.cohort_lib.CohortConfig(strategy=strat, local_steps=steps,
                                       batch_size=batch, lr=3e-3))
    rounds = {"cohort": cs.sched_lib.FullSyncScheduler(
        executor=cs.sched_lib.CohortExec(engine), trace=trace,
        local_steps=steps).step(g0, 0, key), "oracle": sequential(clients)}
    for k in range(args.probes):
        rounds[f"oracle_probe{k}"] = sequential(
            perturbed(clients, 2.0 ** args.eps_log2, k))

    def host(m, name):
        v = m[name]
        return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    print(cs.card_line())
    names = list(rounds)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (ta, ma), (tb, mb) = rounds[a], rounds[b]
            d = cs.round_diffs(ta, tb, g0)
            cs.report({"pair": f"{a} vs {b}",
                       "worst_update_rel": d["worst_update_rel"],
                       "worst_leaf": d["worst_leaf"],
                       "loss_abs": float(np.abs(host(ma, "loss") -
                                                host(mb, "loss")).max()),
                       "acc_abs": float(np.abs(host(ma, "acc") -
                                               host(mb, "acc")).max())})
    return 0


if __name__ == "__main__":
    sys.exit(main())
