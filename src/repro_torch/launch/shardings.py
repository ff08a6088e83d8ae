"""Sharding rules, port of ``repro.launch.shardings``: partition specs for
parameters, batches and caches on a mesh, as pure Python over shapes.

Megatron-style tensor parallelism over ``model`` with a contraction-dim
fallback when a head or vocab dim does not divide (LLaVA's 56 heads),
FSDP-style 2-D sharding for the MoE experts (E over ``model``, the last
dim over ``data``: ``moe.expert_partition_specs``, which the expert-
parallel body reads its shards by), sequence and slot sharding for long
caches, and replication for everything small (LoRA, adapter, norms,
router: the trainable set TriplePlay communicates). A spec is the
port's :class:`~repro_torch.models.runtime.P`; a QTensor leaf's spec is
a QTensor whose ``q`` and ``scales`` are specs of its storage. The rules
work on real tensors and on shape-only ones (``meta`` tensors).

:func:`local_shard` cuts a rank's block out of a whole tensor or
QTensor by a spec. Under a Runtime the port holds every tree as the
rank's blocks (the production layout): :func:`rank_params`
cuts every leaf by :func:`param_specs_tree`, :func:`rank_batch` by
:func:`batch_specs_tree`, :func:`rank_cache` by :func:`cache_specs_tree`,
each block contiguous and owning its storage, so the whole tree can be
freed. :func:`hold_model_dims` cuts what a step makes on the rank (a
prefill's cache entries) over the model axis only, its batch being the
rank's block already; :func:`logical_spec` reads a QTensor leaf's spec
as its logical tensor's. A held cache is a :class:`HeldCache`: its
blocks, and for each ring whether its slots were cut (a ring the model
axis does not divide is held whole, as GSPMD holds it), which a decode
step reads to write and attend the ring.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import QTensor
from repro_torch.models.runtime import P, spec_axes

REPLICATED_FRAGMENTS = (
    "lora", "adapter", "ln", "norm", "router", "dt_bias", "a_log",
    "d_skip", "lam", "bias", "slot_pos")


def _div(n: int, m: int) -> bool:
    return n % m == 0


def _shape(leaf) -> tuple:
    return tuple(int(s) for s in leaf.shape)


def _base_rule(cfg: ModelConfig, name: str, shape, m: int) -> P:
    """Spec for the *logical* (unquantized) 2-D weight."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if name in ("embed",):
        V, d = shape
        if _div(V, m):
            return P("model", None)
        return P(None, "model") if _div(d, m) else P()
    if name in ("head",):
        d, V = shape
        if _div(V, m):
            return P(None, "model")
        return P("model", None) if _div(d, m) else P()
    if name in ("pos_embed", "enc_pos"):
        return P(None, "model") if _div(shape[-1], m) else P()
    if name in ("wq", "cwq"):
        return P(None, "model") if _div(H, m) else \
            (P("model", None) if _div(shape[0], m) else P())
    if name in ("wk", "wv", "cwk", "cwv"):
        return P(None, "model") if _div(Hkv, m) else P()
    if name in ("wo", "cwo"):
        return P("model", None) if _div(H, m) else \
            (P(None, "model") if _div(shape[-1], m) else P())
    if name in ("wu", "wg", "w1"):
        return P(None, "model") if _div(shape[-1], m) else P()
    if name in ("wd", "w2"):
        return P("model", None) if _div(shape[0], m) else P()
    # fallback: shard the largest divisible dim
    dims = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if _div(shape[i], m):
            dims[i] = "model"
            break
    return P(*dims)


def _lift_qtensor(spec: P, q_shape, m: int) -> P:
    """Map a 2-D weight spec (K, N) onto QTensor storage (…, G, B, N):
    the contraction-dim split lands on the quant-group dim G when G
    divides the mesh, else on N."""
    ndim = len(q_shape)
    lead = ndim - 3
    G, N = q_shape[lead], q_shape[-1]
    sK = spec[0] if len(spec) > 0 else None
    sN = spec[1] if len(spec) > 1 else None
    dims = [None] * ndim
    if sK is not None and G % m == 0:
        dims[lead] = sK
    elif sK is not None and sN is None and N % m == 0:
        dims[-1] = sK
    if sN is not None and N % m == 0:
        dims[-1] = sN
    return P(*dims)


def _qspec(leaf: QTensor, q, scales) -> QTensor:
    return dataclasses.replace(leaf, q=q, scales=scales)


def _recurrent_rules(cfg: ModelConfig, m: int):
    """Exact-name specs for the Mamba and RG-LRU leaves, the ones their
    bodies take their shards by."""
    from repro_torch.models.rglru import GATE_BLOCKS, rglru_partition_specs
    from repro_torch.models.ssm import mamba_partition_specs
    rules = {}
    if cfg.family == "ssm" and cfg.d_inner % m == 0:
        rules.update(mamba_partition_specs(cfg, "model"))
    if cfg.family == "hybrid":
        w = cfg.lru_width or cfg.d_model
        if w % m == 0 and GATE_BLOCKS % m == 0:
            rules.update(rglru_partition_specs(cfg, "model"))
    return rules


def _mesh_size(mesh, axis: str) -> int:
    return int(mesh.shape[axis])


def _expert_spec(ndim: int) -> P:
    dims = [None] * ndim
    dims[1] = "model"        # (L, E, ...) stacked
    dims[-1] = "data"
    return P(*dims)


def param_specs_tree(cfg: ModelConfig, params: Any, mesh):
    """The spec tree for a (possibly quantized, possibly stacked) param
    tree on ``mesh`` (anything with ``shape[axis]``)."""
    m = _mesh_size(mesh, "model")
    recurrent = _recurrent_rules(cfg, m)

    def one(path, leaf):
        keys = [str(k) for k in path]
        pstr = "/".join(keys).lower()
        name = next((k for k in reversed(keys)
                     if not k.isdigit() and k not in ("q", "scales", "a",
                                                      "b")),
                    keys[-1] if keys else "")
        isq = isinstance(leaf, QTensor)
        if name in recurrent and "lora" not in pstr:
            base = recurrent[name]
            if isq:
                if len(base) == 2:
                    return _qspec(leaf, _lift_qtensor(base, _shape(leaf.q), m),
                                  _lift_qtensor(base, _shape(leaf.scales), m))
                return _qspec(leaf, P(), P())
            pad = len(leaf.shape) - len(base)
            return P(*([None] * pad), *base)
        if any(f in pstr for f in REPLICATED_FRAGMENTS):
            return _qspec(leaf, P(), P()) if isq else P()
        if "moe" in pstr and name in ("wg", "wu", "wd"):
            return _expert_leaf_spec(leaf)
        if isq:
            spec = _base_rule(cfg, name, tuple(leaf.orig_shape[-2:]), m)
            return _qspec(leaf, _lift_qtensor(spec, _shape(leaf.q), m),
                          _lift_qtensor(spec, _shape(leaf.scales), m))
        shape = _shape(leaf)
        if len(shape) == 0 or min(shape) == 0:
            return P()
        stacked = name not in ("embed", "head", "pos_embed", "enc_pos") and \
            len(shape) >= 3
        core = shape[1:] if stacked else shape
        if len(core) == 1:
            spec = P("model") if _div(core[0], m) and core[0] >= m and \
                name not in REPLICATED_FRAGMENTS else P()
        else:
            spec = _base_rule(cfg, name, core[-2:], m)
            if len(core) > 2:
                spec = P(*([None] * (len(core) - 2)), *spec)
        return P(None, *spec) if stacked else spec

    return tree_lib.map_with_path(one, params)


def _dp_size(mesh, dp) -> int:
    n = 1
    for a in dp:
        n *= _mesh_size(mesh, a)
    return n


def batch_specs_tree(cfg: ModelConfig, batch: Any, mesh, dp):
    """Input batch specs: the batch dim over the dp axes when it divides."""
    dp_sz = _dp_size(mesh, dp)

    def spec(x):
        if len(x.shape) == 0:
            return P()
        lead = dp if _div(x.shape[0], dp_sz) else None
        return P(lead, *([None] * (len(x.shape) - 1)))
    return tree_lib.tree_map(spec, batch)


def cache_specs_tree(cfg: ModelConfig, cache: Any, mesh, dp):
    """KV / state cache specs: batch over dp, the slot or channel dim over
    ``model`` when they divide."""
    m = _mesh_size(mesh, "model")
    dp_sz = _dp_size(mesh, dp)

    def one(path, leaf):
        keys = [str(k) for k in path]
        name = keys[-1]
        sh = _shape(leaf)
        bdp = lambda B: dp if _div(B, dp_sz) else None
        mm = lambda n: "model" if _div(n, m) else None
        if name == "slot_pos":
            return P(*([None] * (len(sh) - 1)), mm(sh[-1]))
        if "adapter" in keys:            # (B, M, h, dh)
            return P(bdp(sh[0]), mm(sh[1]), None, None)
        if name in ("k", "v", "k_scale", "v_scale"):   # (L, B, M, Hkv, D|1)
            return P(None, bdp(sh[1]), mm(sh[2]), None, None)
        if name == "h" and len(sh) == 4:      # ssm state (L, B, di, N)
            return P(None, bdp(sh[1]), mm(sh[2]), None)
        if name == "h" and len(sh) == 3:      # lru state (L, B, w)
            return P(None, bdp(sh[1]), mm(sh[2]))
        if name == "conv":                    # (L, B, K-1, width)
            return P(None, bdp(sh[1]), None, mm(sh[-1]))
        return P(*([None] * len(sh)))
    return tree_lib.map_with_path(one, cache)


# -- a rank's shard -------------------------------------------------------
def _cut(t, spec: P, mesh):
    for d, e in enumerate(spec):
        axes = spec_axes(e)
        if not axes:
            continue
        n = mesh.size(axes)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        w = t.shape[d] // n
        t = t.narrow(d, mesh.index(axes) * w, w)
    return t


def local_shard(leaf, spec, mesh):
    """This rank's block of a whole tensor or QTensor by ``spec`` (for a
    QTensor, the spec QTensor :func:`param_specs_tree` gives: its ``q``
    and ``scales`` cut by theirs, ``orig_shape`` the block's logical
    shape). Views, not copies; ``.contiguous()`` them to own the block."""
    if isinstance(leaf, QTensor):
        q, s = _cut(leaf.q, spec.q, mesh), _cut(leaf.scales, spec.scales,
                                                mesh)
        orig = list(leaf.orig_shape)
        lead = len(orig) - 2
        # the storage is (*lead, G, B, N): its group dim G splits K
        orig[:lead] = q.shape[:lead]
        orig[-1] = q.shape[-1]
        orig[lead] = min(orig[lead], q.shape[-3] * leaf.block)
        return dataclasses.replace(leaf, q=q, scales=s,
                                   orig_shape=tuple(orig))
    return _cut(leaf, spec, mesh)


def _expert_leaf_spec(leaf):
    if isinstance(leaf, QTensor):
        return _qspec(leaf, _expert_spec(leaf.q.ndim),
                      _expert_spec(leaf.scales.ndim))
    return _expert_spec(leaf.ndim)


def _own(t):
    """``t`` contiguous and owning its storage (a block of a whole tensor
    would keep the whole alive)."""
    if t.is_contiguous() and t.untyped_storage().nbytes() == \
            t.numel() * t.element_size():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _cut_tree(tree, specs, mesh):
    def one(leaf, spec):
        if isinstance(leaf, QTensor):
            if not any(spec_axes(e) for e in (*spec.q, *spec.scales)):
                return leaf
            b = local_shard(leaf, spec, mesh)
            return dataclasses.replace(b, q=_own(b.q), scales=_own(b.scales))
        if not any(spec_axes(e) for e in spec):
            return leaf
        return _own(_cut(leaf, spec, mesh))
    specs_flat = tree_lib.leaves(specs)
    leaves = tree_lib.leaves(tree)
    return tree_lib.from_leaves(tree, [one(l, s) for l, s in
                                       zip(leaves, specs_flat)])


def rank_params(cfg: ModelConfig, params: Any, rt):
    """A model tree (``{"frozen", "trainable"}``, or any subtree) as this
    rank of ``rt`` holds it in the production layout: every leaf cut by
    :func:`param_specs_tree` (a QTensor by its storage's specs, the
    experts E over ``model`` and their last dim over ``data``), the
    replicated ones kept as they are."""
    return _cut_tree(params, param_specs_tree(cfg, params, rt.mesh),
                     rt.mesh)


def rank_batch(cfg: ModelConfig, batch: Any, rt):
    """The rank's block of an input batch by :func:`batch_specs_tree`
    (the batch dim over the dp axes where it divides)."""
    return _cut_tree(batch, batch_specs_tree(cfg, batch, rt.mesh,
                                             rt.dp_axes), rt.mesh)


class HeldCache(dict):
    """A decode cache as this rank holds it (:func:`rank_cache`, or a
    prefill under a Runtime): the tree of its blocks, and ``slots_cut``,
    for each ring of the tree (``"kv"``, ``"ckv"``, ``"adapter"``),
    whether :func:`cache_specs_tree` cut its slots over the model axis.
    A ring the model axis does not divide is held whole on every rank,
    as GSPMD holds it; its held block alone would not say so (``M / m``
    slots of a cut ring and ``M`` of a whole one can have one shape)."""

    def __init__(self, tree, slots_cut):
        super().__init__(tree)
        self.slots_cut = dict(slots_cut)


def ring_cuts(specs) -> dict:
    """For each ring of a cache spec tree (its ``slot_pos`` leaves: the
    adapter's, the layers' ``kv`` and the encoder's ``ckv``), whether its
    slots are cut over ``model``."""
    out = {}
    for path, spec in tree_lib.flatten_with_path(specs):
        keys = [str(k) for k in path]
        if keys[-1] == "slot_pos":
            ring = "adapter" if "adapter" in keys else keys[-2]
            out[ring] = spec[len(spec) - 1] is not None
    return out


def held_cache(cfg: ModelConfig, tree: Any, whole_specs: Any, rt):
    """``tree``, a cache already in this rank's blocks, as a
    :class:`HeldCache` whose rings are cut as :func:`cache_specs_tree`
    cuts the whole cache ``whole_specs`` (its leaves or ``meta``
    specs)."""
    return HeldCache(tree, ring_cuts(cache_specs_tree(
        cfg, whole_specs, rt.mesh, ())))


def rank_cache(cfg: ModelConfig, cache: Any, rt):
    """The rank's block of a decode cache by :func:`cache_specs_tree`
    (the batch over the dp axes, the slots or channels over ``model``
    where they divide), as a :class:`HeldCache`."""
    specs = cache_specs_tree(cfg, cache, rt.mesh, rt.dp_axes)
    return HeldCache(_cut_tree(cache, specs, rt.mesh), ring_cuts(specs))


def hold_model_dims(cfg: ModelConfig, cache: Any, rt):
    """A cache tree the step made on this rank (its batch dim the rank's
    block already) cut by :func:`cache_specs_tree`'s entries over the
    model axis only: a prefill's entries as ``rank_cache`` would hold
    them."""
    specs = cache_specs_tree(cfg, cache, rt.mesh, ())
    keep = lambda spec: P(*[e if rt.tp_axis in spec_axes(e) else None
                            for e in spec])
    return _cut_tree(cache, tree_lib.tree_map(keep, specs), rt.mesh)


def logical_spec(spec) -> P:
    """The spec of a leaf's logical (dequantized) tensor: a QTensor spec's
    storage ``(…, G, B, N)`` read as ``(…, K, N)``, its group dim G
    splitting K; a plain spec as it is."""
    if isinstance(spec, QTensor):
        q = tuple(spec.q)
        return P(*q[:-3], q[-3], q[-1]) if len(q) >= 3 else P()
    return spec
