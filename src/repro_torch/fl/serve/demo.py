"""A small end-to-end serving plane built from the training stack, port of
``repro.fl.serve.demo``.

One function that the CLI's ``--adapters`` mode, ``chip_smoke.py`` and
the tests share: partition a synthetic dataset over ``n_users``, train
one cohort wave per tenant family (adapter-only, and LoRA when
``mixed``), hand the personalized trees to an :class:`AdapterStore`, and
wrap a :class:`ServeEngine` over it, everything through one
``ProgramRuntime`` so the plane's ledger covers the handoff and serving.

The JAX package draws the CLIP init, each family's global trainables and
the wave's batch indices with ``jax.random`` from ``seed``. The port
takes them as :class:`DemoStreams` (``streams=``), so a test can inject
the JAX package's draws; with ``streams=None``,
:func:`seeded_demo_streams` draws them with CPU ``torch.Generator``s, the
same draws on the card and on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.core import clip as clip_lib
from repro_torch.data.synthetic import class_tokens, make_dataset
from repro_torch.fl import client as client_lib
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl import runtime as runtime_lib
from repro_torch.fl.serve import engine as engine_lib
from repro_torch.fl.serve import store as store_lib
from repro_torch.fl.strategies import STRATEGIES


@dataclass(frozen=True)
class DemoStreams:
    """The plane's draws: ``clip_init`` is the numpy CLIP tree (the JAX
    package's ``init_clip(PRNGKey(seed))``), ``trainable_init(arm)`` a
    family's numpy global trainables (``init_trainable(PRNGKey(seed + 1),
    ...)``, one key for both families) and ``wave`` the ``cohort.RoundKey``
    of every family's personalization wave (``PRNGKey(seed + 2)``)."""
    clip_init: Any
    trainable_init: Callable[[str], Any]
    wave: cohort_lib.RoundKey


def seeded_demo_streams(seed: int, ccfg=None) -> DemoStreams:
    """Standalone draws: the CLIP from a generator seeded with ``seed``,
    the trainables from (``seed``, 1), the wave's batch indices from
    ``cohort.SeededDraws(seed)`` at key path ``(2,)``."""
    ccfg = ccfg or clip_lib.CLIPConfig()
    clip_init = convert.tree_to_numpy(clip_lib.init_clip(
        torch.Generator().manual_seed(seed), ccfg, device="cpu"))
    tr_seed = int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])

    def trainable_init(arm):
        return convert.tree_to_numpy(client_lib.init_trainable(
            torch.Generator().manual_seed(tr_seed), ccfg, STRATEGIES[arm],
            device="cpu"))

    return DemoStreams(clip_init, trainable_init,
                       cohort_lib.RoundKey(cohort_lib.SeededDraws(seed), (2,)))


def _train_family(frozen, ccfg, class_emb, data, *, arm: str, uids,
                  streams: DemoStreams, local_steps: int, batch_size: int,
                  lr: float, runtime, device) -> Dict[int, Any]:
    """Round-robin shards of the dataset over one tenant family's users,
    one personalization wave; returns uid -> fp32 trainable."""
    strat = STRATEGIES[arm]
    n = len(uids)
    labels = data["labels"]
    clients = []
    for j, _ in enumerate(uids):
        sl = np.arange(j, len(labels), n)[:24]
        clients.append(client_lib.Client(
            cid=j, images=data["images"][sl], labels=labels[sl],
            n_classes=data["spec"].n_classes, strategy=strat))
    engine = cohort_lib.CohortEngine(
        frozen=frozen, ccfg=ccfg, class_emb=class_emb, clients=clients,
        cfg=cohort_lib.CohortConfig(strategy=strat, local_steps=local_steps,
                                    batch_size=batch_size, lr=lr),
        runtime=runtime)
    global_tr = convert.tree_from_numpy(streams.trainable_init(arm), device)
    return store_lib.personalized_trainables(engine, global_tr, streams.wave,
                                             uid_offset=min(uids))


def demo_plane(n_users: int = 8, *, mixed: bool = False, seed: int = 0,
               quant_bits: int = 8, max_entries: Optional[int] = None,
               max_batch: int = 16, local_steps: int = 2,
               batch_size: int = 8, lr: float = 3e-3,
               n_per_class: int = 20,
               runtime: Optional[runtime_lib.ProgramRuntime] = None,
               device=None, streams: Optional[DemoStreams] = None
               ) -> Dict[str, Any]:
    """A ready-to-serve plane over ``n_users`` personalized tenants on
    ``device`` (the card unless the caller asks for the CPU). ``mixed``
    splits the population into an adapter-only (fedclip) half and a LoRA
    (qlora_nogan) half: two slab families in one store. ``max_entries``
    defaults to the population (no evictions); shrink it to exercise the
    LRU."""
    dev = resolve_device(device)
    rt = runtime if runtime is not None else runtime_lib.ProgramRuntime()
    ccfg = clip_lib.CLIPConfig()
    streams = streams if streams is not None else \
        seeded_demo_streams(seed, ccfg)
    frozen = convert.tree_from_numpy(streams.clip_init, dev)
    data = make_dataset("pacs", n_per_class=n_per_class, seed=seed,
                        longtail_gamma=4.0)
    spec = data["spec"]
    with torch.no_grad():
        class_emb = clip_lib.text_embedding(frozen, ccfg, torch.as_tensor(
            class_tokens(spec, np.arange(spec.n_classes)), dtype=torch.long,
            device=dev))

    kw = dict(streams=streams, local_steps=local_steps,
              batch_size=batch_size, lr=lr, runtime=rt, device=dev)
    if mixed:
        n_a = max(1, n_users // 2)
        backing = _train_family(frozen, ccfg, class_emb, data,
                                arm="fedclip", uids=range(n_a), **kw)
        backing.update(_train_family(
            frozen, ccfg, class_emb, data, arm="qlora_nogan",
            uids=range(n_a, n_users), **kw))
    else:
        backing = _train_family(frozen, ccfg, class_emb, data,
                                arm="fedclip", uids=range(n_users), **kw)

    cap = n_users if max_entries is None else int(max_entries)
    store = store_lib.AdapterStore(backing, max_entries=cap,
                                   quant_bits=quant_bits, runtime=rt,
                                   device=dev)
    engine = engine_lib.ServeEngine(
        frozen=frozen, ccfg=ccfg, class_emb=class_emb, store=store,
        cfg=engine_lib.ServeConfig(max_batch=min(max_batch, cap)))
    return {"engine": engine, "store": store, "backing": backing,
            "frozen": frozen, "ccfg": ccfg, "class_emb": class_emb,
            "runtime": rt, "n_users": n_users,
            "n_classes": spec.n_classes,
            # request inputs: per-request images drawn from the dataset
            "images": data["images"]}


def request_images(plane: Dict[str, Any], trace, *, seed: int = 0):
    """Deterministic per-request input images for a trace: request i gets
    a seeded draw from the demo dataset (``np.random.RandomState``, as the
    JAX package draws them)."""
    rs = np.random.RandomState(seed)
    pool = plane["images"]
    return pool[rs.randint(0, len(pool), trace.n)]
