"""AdapterStore: device-resident cache of per-user personalized params,
port of ``repro.fl.serve.store``.

The store keeps the resident users' trainable trees stacked along a
leading **slot axis**, so a serve group personalizes with one gather
(``take_rows``) instead of a per-user host->device copy. Eligible 2-D
adapter matrices are quantized at rest through ``ops.blockwise_quant``
(the CUDA kernel on the card) and never dequantized into a dense slab:
the serve head contracts against them through ``ops.quant_matmul``.
Biases and LoRA factors stay fp. Slabs group by **family** (tree
structure + leaf geometry); slots are per family, while the LRU order
and ``max_entries`` are global. Evicted users re-quantize
deterministically from the host backing on their next fetch, so eviction
is a latency event, never a correctness one. Slab rows are written in
place (the JAX package rebuilds the slab with ``.at[slot].set``).

The trainer hands its output over in two ways: :func:`personalized_trainables`
trains one wave of a built cohort engine and returns each user's tree,
and :meth:`AdapterStore.refresh_from_global` rebases every backed user by
the global model's movement between two calls (``run_federated`` calls
it once a committed round), re-quantizing the resident slots.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.core import quant as qlib
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl import runtime as runtime_lib
from repro_torch.kernels import ops as kops

# At-rest quantization layout: block along the contraction dim,
# small-leaf floor, and "lora" in the skip set.
SERVE_BLOCK = 64
SERVE_MIN_SIZE = 256
SERVE_SKIP = ("slot", "lora")

STORE_KIND = "serve_store"


def quantize_at_rest(tree, *, bits: int):
    """Quantize a per-user trainable tree for storage: every eligible
    >=2-D leaf goes blockwise int8/int4 (``bits`` 0 keeps the tree fp).
    2-D leaves run through ``kernels.ops.blockwise_quant``; higher-rank
    eligible leaves take the plain quantizer with the same layout, as in
    the JAX package."""
    if bits == 0:
        return tree
    if bits not in (4, 8):
        raise ValueError(f"at-rest bits must be 0, 4 or 8, got {bits}")

    def one(path, leaf):
        if not qlib._quantizable(tree_lib.path_str(path), leaf.shape,
                                 leaf.dtype, SERVE_MIN_SIZE, SERVE_SKIP):
            return leaf
        b = qlib._pick_block(leaf.shape[-2], SERVE_BLOCK)
        eff_bits = 8 if b % 2 else bits      # odd blocks can't pack
        if leaf.ndim == 2:
            return kops.blockwise_quant(leaf, bits=eff_bits, block=b,
                                        mode="linear")
        return qlib.quantize(leaf, bits=eff_bits, block=b, mode="linear")
    return tree_lib.map_with_path(one, tree)


def _is_q(l) -> bool:
    return isinstance(l, qlib.QTensor)


def take_rows(slabs, slots: torch.Tensor):
    """Gather slot rows out of a slab tree (leading slot axis on every
    data array). QTensor leaves gather ``q``/``scales`` and keep the
    per-user metadata, so the result is a stacked per-user tree."""
    def f(l):
        if _is_q(l):
            return qlib.QTensor(
                q=l.q.index_select(0, slots),
                scales=l.scales.index_select(0, slots),
                bits=l.bits, mode=l.mode, block=l.block,
                out_dtype=l.out_dtype, orig_shape=l.orig_shape)
        return l.index_select(0, slots)
    return tree_lib.tree_map(f, slabs)


def _slab_like(qtree, capacity: int):
    """Zero slab tree with ``capacity`` slots per leaf."""
    def f(l):
        if _is_q(l):
            return qlib.QTensor(
                q=l.q.new_zeros((capacity,) + tuple(l.q.shape)),
                scales=l.scales.new_zeros(
                    (capacity,) + tuple(l.scales.shape)),
                bits=l.bits, mode=l.mode, block=l.block,
                out_dtype=l.out_dtype, orig_shape=l.orig_shape)
        return l.new_zeros((capacity,) + tuple(l.shape))
    return tree_lib.tree_map(f, qtree)


def _slab_set(slabs, slot: int, qtree) -> None:
    def f(s, l):
        if _is_q(s):
            s.q[slot] = l.q
            s.scales[slot] = l.scales
        else:
            s[slot] = l
    tree_lib.tree_map(f, slabs, qtree)


def _family_key(qtree) -> Tuple:
    """Hashable slab-family identity: paths, QTensor metadata and the
    geometry of every data leaf."""
    sig = []
    for path, l in tree_lib.flatten_with_path(qtree):
        if _is_q(l):
            sig.append((path, "q", l.bits, l.mode, l.block,
                        str(l.out_dtype), tuple(l.orig_shape),
                        tuple(l.q.shape), str(l.q.dtype),
                        tuple(l.scales.shape)))
        else:
            sig.append((path, tuple(l.shape), str(l.dtype)))
    return tuple(sig)


class AdapterStore:
    """LRU cache of quantized per-user trainables in stacked device
    slabs. ``backing`` maps uid -> fp32 trainable tree (torch tensors or
    numpy arrays); a miss quantizes from it and writes one slot, a hit is
    bookkeeping. ``max_entries`` is the global resident capacity; each
    family allocates ``max_entries`` slots when it first appears."""

    def __init__(self, backing: Mapping[int, Any], *, max_entries: int,
                 quant_bits: int = 8,
                 runtime: Optional[runtime_lib.ProgramRuntime] = None,
                 device=None):
        if max_entries < 1:
            raise ValueError(f"max_entries={max_entries} must be >= 1")
        if quant_bits not in (0, 4, 8):
            raise ValueError(f"quant_bits={quant_bits} must be 0, 4 or 8")
        self.device = resolve_device(device)
        self.backing = backing
        self.max_entries = int(max_entries)
        self.quant_bits = int(quant_bits)
        self.runtime = runtime if runtime is not None else \
            runtime_lib.ProgramRuntime()
        # uid -> (family key, slot); OrderedDict order IS the LRU order
        self._res: "OrderedDict[int, Tuple[Tuple, int]]" = OrderedDict()
        self._fams: Dict[Tuple, Dict[str, Any]] = {}
        # the last global tree refresh_from_global saw: a copy, never the
        # caller's tensors, which the caller may go on to change
        self._base = None

    def _on_device(self, tree):
        return tree_lib.tree_map(
            lambda l: runtime_lib.upload(l, self.device)
            if isinstance(l, np.ndarray)
            else torch.as_tensor(l, device=self.device), tree)

    def _quantized(self, tree):
        return quantize_at_rest(self._on_device(tree), bits=self.quant_bits)

    # -- residency -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._res)

    def resident(self) -> Tuple[int, ...]:
        """Resident uids, least-recently-used first."""
        return tuple(self._res)

    def fetch(self, uid: int) -> Tuple[Tuple, int]:
        """Return (family key, slot) for ``uid``, admitting (and, at
        capacity, evicting the global LRU) on a miss. A fetched user moves
        to MRU, so admissions later in one flight never evict it."""
        uid = int(uid)
        ent = self._res.get(uid)
        if ent is not None:
            self._res.move_to_end(uid)
            self.runtime.count(STORE_KIND, "hits")
            return ent
        self.runtime.count(STORE_KIND, "misses")
        if uid not in self.backing:
            raise KeyError(f"uid {uid} has no trained adapter in the "
                           "backing map")
        qtree = self._quantized(self.backing[uid])
        famk = _family_key(qtree)
        fam = self._fams.get(famk)
        if fam is None:
            fam = {"slabs": _slab_like(qtree, self.max_entries),
                   "free": list(range(self.max_entries - 1, -1, -1)),
                   "use_lora": "lora" in self.backing[uid]}
            self._fams[famk] = fam
        if len(self._res) >= self.max_entries:
            _, (old_famk, old_slot) = self._res.popitem(last=False)
            self._fams[old_famk]["free"].append(old_slot)
            self.runtime.count(STORE_KIND, "evictions")
        slot = fam["free"].pop()
        _slab_set(fam["slabs"], slot, qtree)
        self._res[uid] = (famk, slot)
        return famk, slot

    # -- serve-program inputs ------------------------------------------
    def family(self, famk: Tuple) -> Dict[str, Any]:
        """Family record: ``slabs`` and ``use_lora``."""
        return self._fams[famk]

    # -- refresh (trainer -> store handoff) ----------------------------
    def refresh(self, updates: Mapping[int, Any]) -> int:
        """Install new trainable snapshots: the backing map always
        updates; a resident uid also gets its slab slot rewritten through
        the same deterministic at-rest path a miss takes. Residency, slot
        assignment and LRU order are untouched. Returns the number of
        resident slots rewritten."""
        if not isinstance(self.backing, dict):
            self.backing = dict(self.backing)
        n_res = 0
        for uid, tree in updates.items():
            uid = int(uid)
            self.backing[uid] = tree
            ent = self._res.get(uid)
            if ent is None:
                continue
            famk, slot = ent
            qtree = self._quantized(tree)
            if _family_key(qtree) != famk:
                raise ValueError(
                    f"refresh for uid {uid} changes its slab family "
                    "(tree structure / leaf geometry must be stable)")
            _slab_set(self._fams[famk]["slabs"], slot, qtree)
            n_res += 1
        self.runtime.count(STORE_KIND, "refreshes", len(updates))
        self.runtime.count(STORE_KIND, "refreshed_resident", n_res)
        return n_res

    def refresh_from_global(self, new_global) -> int:
        """Continuous trainer->store refresh: rebase every backed user by
        the global model's movement since the last call, ``new_i = old_i +
        (new_global - base)`` in fp32, keeping each user's personalization,
        then :meth:`refresh`. ``new_global`` is copied at once, so a caller
        that changes it afterwards leaves the snapshot as it was. The first
        call only records the snapshot and returns 0. Backing trees held as
        numpy move to the store's device on the first call, so no rebase
        copies from the host; nothing here reads a device value, so on the
        card the call queues its work and returns."""
        snap = tree_lib.tree_map(lambda l: l.detach().clone(),
                                 self._on_device(new_global))
        base, self._base = self._base, snap
        if not isinstance(self.backing, dict):
            self.backing = dict(self.backing)
        for uid, tree in self.backing.items():
            self.backing[uid] = self._on_device(tree)
        if base is None:
            return 0
        updates = {
            uid: tree_lib.tree_map(lambda o, nw, b: o + (nw - b), tree, snap,
                                   base)
            for uid, tree in self.backing.items()}
        return self.refresh(updates)

    # -- accounting ----------------------------------------------------
    def stats(self) -> Dict[str, int]:
        k = self.runtime.stats().get(STORE_KIND, {})
        return {"hits": int(k.get("hits", 0)),
                "misses": int(k.get("misses", 0)),
                "evictions": int(k.get("evictions", 0)),
                "refreshes": int(k.get("refreshes", 0)),
                "refreshed_resident": int(k.get("refreshed_resident", 0)),
                "resident": len(self._res),
                "families": len(self._fams)}

    def hit_rate(self) -> float:
        s = self.stats()
        n = s["hits"] + s["misses"]
        return s["hits"] / n if n else 0.0

    def bytes_at_rest(self) -> int:
        """Stored bytes of the occupied slots (packed QTensor payloads +
        fp leaves): per-resident-user cost x residency."""
        total = 0
        per_fam: Dict[Tuple, int] = {}
        for famk, _ in self._res.values():
            if famk not in per_fam:
                slabs = self._fams[famk]["slabs"]
                per_fam[famk] = qlib.tree_bytes(take_rows(
                    slabs, torch.zeros(1, dtype=torch.long,
                                       device=self.device)))
            total += per_fam[famk]
        return int(total)


def personalized_trainables(engine, global_tr, key, *,
                            uid_offset: int = 0) -> Dict[int, Any]:
    """Train every client of a built :class:`~repro_torch.fl.cohort
    .CohortEngine` one wave from ``global_tr`` (``run_wave``, batch
    indices from ``key``, a ``cohort.RoundKey``) and return the
    **personalized** per-user trees ``global + dequant(delta_i)`` in fp32:
    the training->serving handoff. Uids are client positions plus
    ``uid_offset``, so tenant families can share one backing map."""
    sel = np.arange(engine.n_clients)
    delta, _ = engine.run_wave(global_tr, sel, key)
    out = {}
    for i in range(engine.n_clients):
        d = qlib.dequantize_tree(cohort_lib.slice_client_delta(delta, i),
                                 torch.float32)
        out[uid_offset + i] = tree_lib.tree_map(
            lambda g, dd: (g + dd).to(torch.float32), global_tr, d)
    return out
