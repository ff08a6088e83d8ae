"""ServeEngine: multi-tenant batched inference over personalized adapters,
port of ``repro.fl.serve.engine``.

A flight of R ragged requests (each a ``(uid, image)``) is answered by
one program per tenant family:

 1. every uid is fetched through the :class:`~repro_torch.fl.serve.store
    .AdapterStore` (LRU admit/evict, quantized-at-rest slabs);
 2. rows group by slab family (adapter-only vs LoRA tenants);
 3. the request axis pads to ``bucket_width(R, max_batch)``;
 4. the hoisted frozen CLIP prefix runs once over the padded rows
    (``cohort.encode_rows``: pooled features for adapter-only, patch
    tokens for LoRA);
 5. the slot rows are gathered (``store.take_rows``) into trees with an
    explicit leading **user axis**, and the per-user head runs over it:
    each quantized matrix is one stacked ``quant_matmul`` launch for the
    whole group (the JAX package ``vmap``s a per-user program instead).

The head is ``quant_head_logits``. At S=1 the adapter's softmax is over
one position and identically 1, so Att(D) reduces exactly to the value
path ``x @ wv``; the head uses that closed form. The oracle
:func:`serve_sequential` answers one request at a time through
``client.forward_logits`` on the fp32 backing trees (whose adapter runs
the flash-attention kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.core import clip as clip_lib
from repro_torch.core import quant as qlib
from repro_torch.fl import client as client_lib
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl import runtime as runtime_lib
from repro_torch.fl.serve import store as store_lib
from repro_torch.kernels import ops as kops

SERVE_KIND = "serve_batch"


def _mm(x, w):
    """Contraction against a possibly quantized-at-rest weight: QTensor
    leaves dequantize in-kernel through ``quant_matmul``."""
    if isinstance(w, qlib.QTensor):
        return kops.quant_matmul(x, w)
    return torch.matmul(x, w)


def quant_head_logits(frozen, trainable, feat, class_emb):
    """``client.head_logits`` for T pooled feature rows ``(T, d)`` against
    T stacked per-user adapter trees (leading user axis on every leaf)
    -> ``(T, n_classes)``. Uses the exact S=1 reduction Att(D) == V,
    which leaves four quantizable contractions."""
    a = trainable["adapter"]
    x = feat[:, None, :]
    v = _mm(x, a["wv"])
    x = x + _mm(v, a["wo"])
    h = torch.relu(_mm(x, a["w1"]) + a["b1"][:, None, :])
    x = x + _mm(h, a["w2"]) + a["b2"][:, None, :]
    emb = x[:, 0] @ frozen["proj_v"]
    return clip_lib.zero_shot_logits(emb, class_emb, frozen["logit_scale"])


@dataclass(frozen=True)
class ServeConfig:
    """Static serve-plane parameters."""
    max_batch: int = 64       # requests per dispatch (= bucket ceiling)


class ServeEngine:
    """Batched request executor over an :class:`AdapterStore`; runs on
    the store's device."""

    def __init__(self, *, frozen, ccfg, class_emb,
                 store: store_lib.AdapterStore,
                 cfg: ServeConfig = ServeConfig()):
        if cfg.max_batch < 1:
            raise ValueError(f"max_batch={cfg.max_batch} must be >= 1")
        if cfg.max_batch > store.max_entries:
            # a flight wider than the store would evict its own residents
            raise ValueError(
                f"max_batch={cfg.max_batch} exceeds the store's "
                f"max_entries={store.max_entries} — a single flight "
                "must fit in the resident set")
        self.frozen = frozen
        self.ccfg = ccfg
        self.class_emb = class_emb
        self.store = store
        self.cfg = cfg
        self.device = store.device
        self.runtime = store.runtime
        self.n_requests = 0   # requests answered by the batched plane
        self.n_dispatches = 0  # serve programs run

    # -- the serve program ---------------------------------------------
    def _build_serve(self, use_lora: bool):
        ccfg = self.ccfg

        def fn(slabs, slots, staged, frozen, class_emb):
            tr = store_lib.take_rows(slabs, slots)
            if use_lora:
                # (T, L, ...) -> (L, T, ...): per-layer factors per user
                lora = tree_lib.tree_map(lambda l: l.transpose(0, 1),
                                         tr["lora"])
                feat = clip_lib.encode_tokens(frozen, ccfg, staged,
                                              lora=lora)
            else:
                feat = staged
            return quant_head_logits(frozen, tr, feat, class_emb)

        return lambda: fn

    def _serve_group(self, famk, rows: List[Tuple[int, Any]]):
        """One family's share of a flight: rows is [(slot, image)] in
        request order, len <= max_batch."""
        fam = self.store.family(famk)
        use_lora = fam["use_lora"]
        G = len(rows)
        B = runtime_lib.bucket_width(G, self.cfg.max_batch)
        imgs = np.stack([im for _, im in rows]).astype(np.float32)
        # pad the request axis before the prefix encode so both programs
        # see only bucket shapes
        imgs = runtime_lib.pad_leading(
            torch.as_tensor(imgs, device=self.device), B)
        # pad slots with row 0's (a valid resident row; sliced off)
        slots = np.full(B, rows[0][0], np.int64)
        slots[:G] = [s for s, _ in rows]
        staged = cohort_lib.encode_rows(
            self.frozen, self.ccfg, use_lora=use_lora, rows=imgs,
            runtime=self.runtime)
        args = (fam["slabs"], torch.as_tensor(slots, device=self.device),
                staged, self.frozen, self.class_emb)
        out = self.runtime.compile(
            SERVE_KIND, self._build_serve(use_lora), args,
            static_key=(self.ccfg, use_lora, self.store.quant_bits,
                        famk))(*args)
        self.n_dispatches += 1
        self.runtime.count(SERVE_KIND, "n_groups")
        return out.cpu().numpy()[:G], B

    def serve(self, requests: Sequence[Tuple[int, Any]]):
        """Answer ``[(uid, image), ...]`` -> (logits ``(R, n_classes)``
        in request order, flight info). Flights wider than ``max_batch``
        split in arrival order."""
        if not len(requests):
            raise ValueError("empty request flight")
        logits: List[Any] = [None] * len(requests)
        info: Dict[str, Any] = {"n_requests": len(requests),
                                "flights": 0, "groups": 0,
                                "buckets": []}
        for lo in range(0, len(requests), self.cfg.max_batch):
            flight = requests[lo:lo + self.cfg.max_batch]
            # fetch in request order: LRU guarantees a flight's own
            # residents are never evicted by its later admissions
            placed = [self.store.fetch(uid) for uid, _ in flight]
            groups: "Dict[Tuple, List[int]]" = {}
            for j, (famk, _) in enumerate(placed):
                groups.setdefault(famk, []).append(j)
            for famk, rows_j in groups.items():
                out, B = self._serve_group(
                    famk, [(placed[j][1], flight[j][1]) for j in rows_j])
                for o, j in zip(out, rows_j):
                    logits[lo + j] = o
                info["groups"] += 1
                info["buckets"].append(B)
            info["flights"] += 1
            self.runtime.count(SERVE_KIND, "n_flights")
            self.runtime.count(SERVE_KIND, "n_requests", len(flight))
            self.n_requests += len(flight)
        return np.stack(logits), info


# -- sequential oracle -------------------------------------------------

def serve_sequential(frozen, ccfg, class_emb, backing, requests, *,
                     device=None):
    """Per-user reference plane: one request at a time, the full
    ``encode -> adapter -> logits`` forward on the fp32 backing tree.
    The batched engine must match it to tolerance (fp noise when the
    store is unquantized)."""
    dev = resolve_device(device)
    out = []
    for uid, img in requests:
        tr = tree_lib.tree_map(lambda l: torch.as_tensor(l, device=dev),
                               backing[int(uid)])
        x = torch.as_tensor(np.asarray(img, np.float32), device=dev)[None]
        out.append(client_lib.forward_logits(
            frozen, tr, ccfg, x, class_emb)[0].cpu().numpy())
    return np.stack(out)
