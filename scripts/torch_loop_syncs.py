#!/usr/bin/env python3
"""Count the synchronizing CUDA calls inside the round loop of the
PyTorch port's ``run_federated`` on one card, site by site, beside the
loop's ``SYNC_TRACES`` ledger.

    python3 scripts/torch_loop_syncs.py [--src OTHER_TREE/src] [--store]
        [--rounds 3] [--pipeline pipelined|barrier]

The run is fault-free and sync-partial: fedclip, the JAX package's
``CLIPConfig()``, the paper preset's round settings (pacs, 5 clients, 10
local steps of 32, 60 a class, lr 3e-3), K = 2. It runs under
``torch.cuda.set_sync_debug_mode("warn")``, so PyTorch warns at every
call that waits for the device: a copy from pageable host memory,
``.item()``, a synchronize. Each warning's Python stack is kept. A
warning whose stack passes through the round loop of ``run_federated``
(its ``for rnd`` loop and the flush after it) is counted at its site,
the innermost frame in the port's package; it is ``counted`` when the
stack passes through a wait that ``SYNC_TRACES`` charges (the metric
ring's flush, the barrier's reads, ``Handle.result``,
``ProgramRuntime.sync``). ``--store`` refreshes a serve store
(``demo_plane(8, max_entries=6)``, six residents) every round. ``--src``
measures another tree's port, for example the parent commit unpacked
with ``git archive``; the JSON line carries the run's losses and
accuracies, so two trees' runs can be held equal. Prints one JSON line.
It needs one card.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

# the functions whose waits SYNC_TRACES charges (simulator.py's metric
# ring and barrier reads, runtime.py's counted waits)
COUNTED = ("_flush_ring", "_record_round", "_record_eval", "result", "sync")
ROUNDS_SETTINGS = dict(dataset="pacs", strategy="fedclip", n_clients=5,
                       local_steps=10, batch_size=32, n_per_class=60,
                       lr=3e-3, participation="sync-partial",
                       clients_per_round=2)


@contextlib.contextmanager
def sync_warnings():
    """Record the Python stack of every synchronizing CUDA call made
    inside the block (``set_sync_debug_mode("warn")``)."""
    import torch

    stacks = []
    show = warnings.showwarning

    def keep(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            stacks.append(traceback.extract_stack()[:-1])
        else:
            show(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield stacks
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = show


def loop_lines(sim) -> tuple:
    """The first and last line of ``run_federated``'s round loop: the
    ``for rnd`` statement, its body, and the ``_flush_ring()`` call right
    after it (the loop's last flush)."""
    src, start = inspect.getsourcelines(sim.run_federated)
    indent = lambda s: len(s) - len(s.lstrip())
    first = next(i for i, s in enumerate(src)
                 if s.strip().startswith("for rnd, key in round_keys"))
    last = next(i for i in range(first + 1, len(src))
                if src[i].strip() and indent(src[i]) <= indent(src[first]))
    if src[last].strip() != "_flush_ring()":
        raise ValueError(f"the round loop ends at {src[last].strip()!r}, "
                         "not at its flush")
    return start + first, start + last


def loop_sites(stacks, sim) -> dict:
    """The loop's synchronizing calls from :func:`sync_warnings`' stacks:
    their count, the uncounted ones, and both by site."""
    first, last = loop_lines(sim)
    sim_file = str(Path(sim.__file__).resolve())
    pkg = str(Path(sim.__file__).resolve().parents[1])
    sites, uncounted = Counter(), Counter()
    for st in stacks:
        if not any(str(Path(f.filename).resolve()) == sim_file and
                   f.name == "run_federated" and first <= f.lineno <= last
                   for f in st):
            continue
        own = [f for f in st if str(Path(f.filename).resolve()).startswith(pkg)]
        f = own[-1]
        site = (f"{Path(f.filename).resolve().relative_to(Path(pkg).parent)}"
                f":{f.lineno} {f.name}")
        sites[site] += 1
        if not any(g.name in COUNTED for g in own):
            uncounted[site] += 1
    return {"in_loop": sum(sites.values()),
            "uncounted": sum(uncounted.values()),
            "sites": dict(sites), "uncounted_sites": dict(uncounted)}


def measure(*, rounds: int = 3, pipeline: str = "pipelined",
            store=None, device="cuda") -> dict:
    """One run of ``ROUNDS_SETTINGS`` under :func:`sync_warnings`, with
    ``store`` as its ``serve_store`` when given."""
    import torch
    from repro_torch.fl import simulator as sim

    cfg = sim.FLConfig(rounds=rounds, pipeline=pipeline, **ROUNDS_SETTINGS)
    kw = {} if store is None else {"serve_store": store}
    sim.run_federated(cfg, device=device)      # pretrains, warms the caches
    torch.cuda.synchronize()
    with sync_warnings() as stacks:
        t0 = time.perf_counter()
        h = sim.run_federated(cfg, device=device, **kw)
        wall = time.perf_counter() - t0
    return dict(loop_sites(stacks, sim), pipeline=pipeline, rounds=rounds,
                store=store is not None, all_warnings=len(stacks),
                sync_counts=h.meta["sync_counts"],
                loop_syncs=h.meta["loop_syncs"],
                loop_wall_s=h.meta["loop_wall_s"],
                round_time_s=h.round_time_s, run_s=wall,
                serve_refreshes=h.meta.get("serve_refreshes"),
                # the run's results, to hold two trees' runs equal
                client_loss=h.client_loss, server_loss=h.server_loss,
                server_acc=h.server_acc, participation=h.participation)


def demo_store(device="cuda"):
    """A serve store over ``demo_plane(8)``'s users, six resident."""
    from repro_torch.fl import serve

    plane = serve.demo_plane(8, max_entries=6, device=device)
    store = serve.AdapterStore(dict(plane["backing"]), max_entries=6,
                               quant_bits=8, device=device)
    for uid in range(6):
        store.fetch(uid)
    return store


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--store", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--pipeline", default="pipelined")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_loop_syncs: needs a CUDA device", file=sys.stderr)
        return 2
    store = demo_store() if args.store else None
    res = measure(rounds=args.rounds, pipeline=args.pipeline, store=store)
    res["src"] = args.src
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[:1]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
