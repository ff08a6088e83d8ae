"""The model facade for every assigned architecture family, port of
``repro.models.model``: the dense decoders, the Mamba-1 SSM, the
RG-LRU/attention hybrid, the token-choice MoE (with unrolled
``first_k_dense`` layers and shared experts), the encoder-decoder with
cross-attention and learned positions, and the VLM with image
embeddings prepended to the tokens.

A ``Model`` exposes:
  init_params(generator, device) -> {"frozen", "trainable": {"lora", "adapter"}}
  forward(frozen, trainable, batch) -> logits, aux        (train shapes)
  loss_fn(...)    -> loss, parts          (ce + 0.01 · the MoE aux loss)
  grads(...)      -> (loss, parts), grads w.r.t. the trainables
  train_step(...) -> one TriplePlay local client step (LoRA+adapter),
                     over ``cfg.grad_accum`` microbatches
  prefill(frozen, trainable, batch, max_len) -> last logits, cache
  decode_step(frozen, trainable, cache, tokens, pos) -> logits, cache
  init_cache(batch, context_len, device) -> an empty cache
  param_specs(), cache_specs(batch, context_len), input_specs(shape)
                  -> the same trees as ``meta`` tensors (the dry run)

A batch holds ``tokens`` (and ``labels``/``mask`` to train), plus
``frames`` (B, n_frames, d) for the encdec family and optionally
``image_embeds`` (B, P, d) for the vlm family, whose labels and mask
then span the P patches and the tokens.

The frozen backbone may be quantized (cfg.quant_bits in {0, 8, 4}, linear
or NF4 blocks); only the LoRA pairs and the paper's attention adapter
are trained, as on a TriplePlay client. Trees keep the JAX package's layout
(``layers`` stacked with a leading layer axis, a quantized leaf as a
stacked QTensor ``(L, [E,] G, B[/2], N)``; ``dense_layers`` and
``dense_lora`` lists; ``enc_layers``/``enc_lora`` stacked), so weights
convert structurally (:mod:`repro_torch.convert`). The JAX ``lax.scan``
over the stack is a Python loop over per-layer slices in one of the JAX
package's three modes, ``"train"``, ``"prefill"`` and ``"decode"``, and
the hybrid pattern's ``lax.cond`` a Python branch on
``cfg.layer_kinds()``. In training ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``), as
the JAX scan body is checkpointed, and each encoder layer; a hybrid
layer checkpoints its attention and its MLP, not its RG-LRU block, as
the JAX package does on one device. The SSM and RG-LRU blocks are
:mod:`repro_torch.models.ssm` and :mod:`repro_torch.models.rglru`, the
experts :mod:`repro_torch.models.moe`.

The serving cache keeps the JAX package's tree, ``{"scan": per-layer
entries stacked on a leading layer axis, ["dense": the same for the
first_k_dense layers,] "adapter": the adapter's ring cache}``; an entry
is ``{"kv": ring cache}``, ``{"ssm": {"h", "conv"}}``, the hybrid's
``{"kv", "lru": {"h", "conv"}}`` (an attention layer's ``lru`` and an
RG-LRU layer's ``kv`` are the JAX package's zero dummies) or the
encdec's ``{"kv", "ckv": the encoder's K/V, slot_pos 0..n_frames-1}``,
so it converts leaf for leaf. A decode step writes the new token's rows
into those stacked buffers in place and returns the same dict; the step
computes its slot from the 0-d ``pos`` tensor on the device and reads
nothing back to the host; a layer's dummy entry is never written, so it
keeps the zeros the JAX step writes there. ``prefill`` and
``decode_step`` build no autograd graph.

Under a :class:`~repro_torch.models.runtime.Runtime` (a mesh over
``torch.distributed``, one process a rank) the same methods run the
JAX package's explicit bodies: the MoE's expert-parallel all-to-all,
the attention's head split, the split-KV decode, the Mamba and RG-LRU
blocks' channel split, in the production layout: each rank holds its
blocks of the parameters, the batch and a decode's cache
(``launch.shardings.rank_params``, ``rank_batch``, ``rank_cache``), as
GSPMD places the JAX package's: the dense linears
run tensor-parallel on the rank's weight blocks (``layers.tp_linear``),
the embedding and the head vocab-parallel (the loss's max, sum of
exponentials and target logit reduced over ``model``, the logits never
gathered whole), the learned positions gathered at use. The loss is the
global mean, its sum and count reduced over the dp axes, and the
trainables' gradients are summed over them, so every rank holds the
JAX global program's loss, gradient and Adam update; ``prefill`` and
``decode_step`` give the logits of the rank's batch rows, whole over
the vocabulary, and the cache as the rank holds it (a
``shardings.HeldCache``: its rings' slots cut over ``model`` where the
axis divides them, else whole; a decode step reads which from it). The layer
stack's sharding constraints are identities; an SSM layer checkpoints
inside its body under a Runtime, as the JAX package's does, instead of
as a whole.

For the dry run (:mod:`repro_torch.launch.dryrun`) ``param_specs``,
``cache_specs`` and ``input_specs`` give the trees' shapes as ``meta``
tensors (the JAX package's ``ShapeDtypeStruct`` trees, leaf for leaf),
and ``cfg.calibrate`` takes the single-chunk scans and the MoE body's
batched experts. ``cfg.unroll_layers`` is accepted and changes
nothing: the port's layer loop is a Python loop already, so every layer
is traced and counted as the JAX package's unrolled stack is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import types
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, spec
from repro_torch import tree as tree_lib
from repro_torch.configs.base import ATTN, InputShape, ModelConfig
from repro_torch.core import adapter as adapter_lib
from repro_torch.core import lora as lora_lib
from repro_torch.core import losses, optim
from repro_torch.core import quant as qlib
from repro_torch.launch import shardings as sh
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import runtime as rt_lib
from repro_torch.models import ssm as ssm_lib

# largest fp32 slice quantized at once: the NF4 search holds 16 floats
# an element
_QUANT_SLICE = 1 << 24


def split(generator: torch.Generator, n: int, device) -> list:
    """``n`` independent generators on ``device``, seeded from
    ``generator`` (the port's counterpart of ``jax.random.split``)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def _lora_targets(cfg: ModelConfig) -> Dict[str, tuple]:
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    fam = cfg.family
    t: Dict[str, tuple] = {}
    if fam != "ssm":
        t.update(wq=(d, qd), wk=(d, kvd), wv=(d, kvd), wo=(qd, d))
    if fam in ("dense", "vlm", "encdec"):
        t.update(wu=(d, ff), wd=(ff, d))
        if cfg.mlp == "swiglu":
            t["wg"] = (d, ff)
    if fam == "encdec":
        t.update(cwq=(d, qd), cwk=(d, kvd), cwv=(d, kvd), cwo=(qd, d))
    if fam == "ssm":
        t.update(in_proj_x=(d, cfg.d_inner), out_proj=(cfg.d_inner, d))
    if fam == "hybrid":
        w = cfg.lru_width or d
        t.update(wx=(d, w), wy=(d, w), out_proj=(w, d))
    return t


def _enc_lora_targets(cfg: ModelConfig) -> Dict[str, tuple]:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return dict(wq=(d, qd), wk=(d, kvd), wv=(d, kvd), wo=(qd, d))


def _init_lora(cfg: ModelConfig, targets, generator, device, lead=()):
    tdt = getattr(torch, cfg.trainable_dtype)
    return {n: lora_lib.init_pair(g, k, nn, cfg.lora_rank, dtype=tdt,
                                  lead=lead)
            for (n, (k, nn)), g in zip(sorted(targets.items()),
                                       split(generator, len(targets),
                                             device))}


def _init_layer(cfg: ModelConfig, generator, dtype, device, *,
                dense_ff: int = 0, encoder: bool = False):
    """One backbone layer of the arch family (an MLP layer of width
    ``dense_ff`` for the MoE's first_k_dense layers, an encoder layer
    with ``encoder``), drawn from its own generator."""
    fam = cfg.family
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": torch.zeros((d,), device=device)}
    if fam == "ssm":
        p.update(ssm_lib.init_mamba(generator, cfg, dtype, device))
        return p
    p["ln2"] = torch.zeros((d,), device=device)
    p.update(L.init_attention(generator, cfg, dtype, device))
    if encoder:
        p.update(L.init_mlp(generator, d, cfg.d_ff, cfg.mlp, dtype, device))
        return p
    if fam == "encdec":
        p["lnc"] = torch.zeros((d,), device=device)
        p.update(L.init_attention(generator, cfg, dtype, device, cross=True))
        p.update(L.init_mlp(generator, d, cfg.d_ff, cfg.mlp, dtype, device))
        return p
    if fam == "hybrid":
        p.update(rglru_lib.init_rglru(generator, cfg, dtype, device))
        p.update(L.init_mlp(generator, d, cfg.d_ff, cfg.mlp, dtype, device))
        return p
    if fam == "moe" and not dense_ff:
        p["moe"] = moe_lib.init_experts(generator, cfg, dtype, device,
                                        lazy=True)
        if cfg.n_shared_experts:
            p["shared"] = L.init_mlp(generator, d,
                                     cfg.d_ff * cfg.n_shared_experts,
                                     "swiglu", dtype, device)
        return p
    kind = "swiglu" if fam == "moe" else cfg.mlp
    p.update(L.init_mlp(generator, d, dense_ff or cfg.d_ff, kind, dtype,
                        device))
    return p


def _lora_specs(cfg: ModelConfig, targets, lead=()):
    tdt = getattr(torch, cfg.trainable_dtype)
    return {n: lora_lib.pair_specs(k, nn, cfg.lora_rank, dtype=tdt,
                                   lead=lead)
            for n, (k, nn) in sorted(targets.items())}


def _layer_specs(cfg: ModelConfig, dtype, lead=(), *, dense_ff: int = 0,
                 encoder: bool = False):
    """:func:`_init_layer`'s leaves (stacked on ``lead``) as ``meta``
    tensors."""
    fam = cfg.family
    d = cfg.d_model
    f1 = spec((*lead, d))
    p: Dict[str, Any] = {"ln1": f1}
    if fam == "ssm":
        p.update(ssm_lib.mamba_specs(cfg, dtype, lead))
        return p
    p.update(L.attention_specs(cfg, dtype, lead=lead))
    p["ln2"] = f1
    if encoder:
        p.update(L.mlp_specs(d, cfg.d_ff, cfg.mlp, dtype, lead))
        return p
    if fam == "encdec":
        p["lnc"] = f1
        p.update(L.attention_specs(cfg, dtype, cross=True, lead=lead))
        p.update(L.mlp_specs(d, cfg.d_ff, cfg.mlp, dtype, lead))
        return p
    if fam == "hybrid":
        p.update(rglru_lib.rglru_specs(cfg, dtype, lead))
        p.update(L.mlp_specs(d, cfg.d_ff, cfg.mlp, dtype, lead))
        return p
    if fam == "moe" and not dense_ff:
        p["moe"] = moe_lib.expert_specs(cfg, dtype, lead)
        if cfg.n_shared_experts:
            p["shared"] = L.mlp_specs(d, cfg.d_ff * cfg.n_shared_experts,
                                      "swiglu", dtype, lead)
        return p
    kind = "swiglu" if fam == "moe" else cfg.mlp
    p.update(L.mlp_specs(d, dense_ff or cfg.d_ff, kind, dtype, lead))
    return p


def _quant_plan(cfg: ModelConfig, path: str, shape, dtype):
    """``(bits, mode, block)`` with which ``quantize_tree`` would quantize
    the stacked leaf at ``path`` (its keys joined by "/") of this shape,
    or None to keep it."""
    if not cfg.quant_bits or not qlib._quantizable(path, shape, dtype, 4096):
        return None
    b = qlib._pick_block(shape[-2], cfg.quant_block)
    if b % 2:
        return 8, "linear", b           # odd blocks do not pack
    return cfg.quant_bits, cfg.quant_mode, b


def _quantize_into(q, scales, w, *, bits, mode, block):
    """``quantize(w)`` written into the payload ``q`` and ``scales`` a
    slice at a time: one matrix of a leading stack, then at most
    ``_QUANT_SLICE`` elements of its columns. Blocks run along K inside
    each column, so the result is ``quantize(w)``'s bit for bit."""
    if w.ndim > 2:
        for j in range(w.shape[0]):
            _quantize_into(q[j], scales[j], w[j], bits=bits, mode=mode,
                           block=block)
        return
    K, N = w.shape
    step = max(1, _QUANT_SLICE // K)
    for c0 in range(0, N, step):
        qt = qlib.quantize(w[:, c0:c0 + step], bits=bits, block=block,
                           mode=mode)
        q[..., c0:c0 + step] = qt.q
        scales[..., c0:c0 + step] = qt.scales


def _layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree; a stacked QTensor gives the QTensor
    of that layer (views of its payload and scales)."""
    def one(leaf):
        if isinstance(leaf, qlib.QTensor):
            return qlib.QTensor(q=leaf.q[i], scales=leaf.scales[i],
                                bits=leaf.bits, mode=leaf.mode,
                                block=leaf.block, out_dtype=leaf.out_dtype,
                                orig_shape=tuple(leaf.orig_shape[1:]))
        return leaf[i]
    return tree_lib.tree_map(one, tree)


def _read_specs(tree, stacked: bool = True):
    """A layer tree's specs as the layers read them: each leaf's logical
    spec (``shardings.logical_spec``), a stacked tree's as one layer's
    (the leading layer dim, never cut, dropped)."""
    def one(spec):
        ls = tuple(sh.logical_spec(spec))
        return rt_lib.P(*(ls[1:] if stacked else ls))
    return tree_lib.tree_map(one, tree)


def _step_view():
    """The view a step runs under a Runtime (``Runtime.step_view``), or
    None."""
    rt = rt_lib.get_runtime()
    return None if rt is None else rt.step_view()


def _within(view):
    """The step view installed for a step, or (None) the Runtime as it is."""
    return rt_lib.runtime(view) if view is not None else \
        contextlib.nullcontext()


def _dp(cfg):
    rt = rt_lib.get_runtime()
    return rt.dp_axes if rt else ("data",)


def _seq_axis(cfg, S):
    rt = rt_lib.get_runtime()
    if rt is None or not cfg.seq_shard or S <= 1 or S % rt.tp_size:
        return None
    return rt.tp_axis


def _remat(fn, on: bool):
    return functools.partial(checkpoint, fn, use_reentrant=False) if on \
        else fn


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_scanned = cfg.n_layers - cfg.first_k_dense
        self.kinds = cfg.layer_kinds()[cfg.first_k_dense:]
        self._held_specs: Dict[int, Any] = {}

    def held_specs(self, rt) -> Dict[str, Any]:
        """The production layout's specs on ``rt``'s model axis:
        ``param_specs_tree`` of :meth:`param_specs` (``"params"``), and the
        logical specs the layers read: one layer's of the stack, the dense
        layers' and the encoder's (``"layer"``, ``"dense"``, ``"enc"``)."""
        m = rt.tp_size
        if m not in self._held_specs:
            specs = sh.param_specs_tree(
                self.cfg, self.param_specs(),
                types.SimpleNamespace(shape={"model": m}))
            fz = specs["frozen"]
            self._held_specs[m] = {
                "params": specs, "layer": _read_specs(fz["layers"]),
                "dense": _read_specs(fz["dense_layers"], stacked=False)
                if "dense_layers" in fz else None,
                "enc": _read_specs(fz["enc_layers"])
                if "enc_layers" in fz else None}
        return self._held_specs[m]

    def _specs(self, key: str):
        rt = rt_lib.get_runtime()
        return None if rt is None else self.held_specs(rt)[key]

    # ---------------------------------------------------------- params
    def _init_layers(self, generator, dtype, device, n: int, **kw):
        """The stacked tree of ``n`` layers, drawn one layer at a time
        (a MoE layer's experts one expert at a time, after the layer's
        other leaves: ``moe.LazyExperts``). With ``cfg.quant_bits`` each
        matrix is quantized as soon as it is drawn and written into
        preallocated stacked payloads, so no dense stack (and no
        whole-matrix NF4 search) is ever held: the result equals
        ``quantize_tree`` of the dense stack bit for bit, since blocks run
        along K inside each matrix."""
        cfg = self.cfg
        out: Dict[tuple, Any] = {}
        for i, g in enumerate(split(generator, n, device)):
            layer = _init_layer(cfg, g, dtype, device, **kw)
            for path, w in tree_lib.flatten_with_path(layer):
                shape = (n, *w.shape)
                plan = _quant_plan(cfg, tree_lib.path_str(path), shape,
                                   w.dtype)
                if plan is None:
                    if path not in out:
                        out[path] = torch.empty(shape, dtype=w.dtype,
                                                device=device)
                    if isinstance(w, moe_lib.LazyExperts):
                        for j in range(w.shape[0]):
                            out[path][i, j] = w[j]
                    else:
                        out[path][i] = w
                    continue
                bits, mode, block = plan
                spec = qlib.qtensor_specs(shape, w.dtype, bits=bits,
                                          block=block, mode=mode)
                if path not in out:
                    out[path] = dataclasses.replace(
                        spec, q=torch.empty(spec.q.shape, dtype=spec.q.dtype,
                                            device=device),
                        scales=torch.empty(spec.scales.shape,
                                           dtype=torch.float32,
                                           device=device))
                _quantize_into(out[path].q[i], out[path].scales[i], w,
                               bits=bits, mode=mode, block=block)
            del layer
        tree: Dict[str, Any] = {}
        for path, leaf in out.items():
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return tree

    def init_params(self, generator: torch.Generator, device=None):
        cfg = self.cfg
        dev = resolve_device(device)
        dt = getattr(torch, cfg.dtype)
        tdt = getattr(torch, cfg.trainable_dtype)
        g_emb, g_head, g_lay, g_lora, g_ad = split(generator, 5, dev)
        d, V = cfg.d_model, cfg.vocab_size
        frozen: Dict[str, Any] = {
            "embed": (torch.randn((V, d), generator=g_emb, device=dev)
                      * 0.02).to(dt),
            "head": L._normal(g_head, (d, V), d, dt, dev),
            "final_norm": torch.zeros((d,), device=dev),
        }
        frozen["layers"] = self._init_layers(g_lay, dt, dev, self.n_scanned)
        trainable = {
            "lora": _init_lora(cfg, _lora_targets(cfg), g_lora, dev,
                               lead=(self.n_scanned,)),
            "adapter": adapter_lib.init(g_ad, d, n_heads=cfg.adapter_heads,
                                        d_ff=cfg.adapter_d_ff, dtype=tdt,
                                        device=dev),
        }
        if cfg.use_rope and not cfg.first_k_dense and not cfg.encoder_layers:
            return {"frozen": frozen, "trainable": trainable}
        g_pos, g_dense, g_enc, g_dlora, g_elora = split(generator, 5, dev)
        if not cfg.use_rope:
            frozen["pos_embed"] = (torch.randn(
                (cfg.max_pos, d), generator=g_pos, device=dev) * 0.02).to(dt)
        if cfg.first_k_dense:
            frozen["dense_layers"] = [
                _layer_slice(self._init_layers(g, dt, dev, 1,
                                               dense_ff=cfg.dense_d_ff), 0)
                for g in split(g_dense, cfg.first_k_dense, dev)]
            trainable["dense_lora"] = [
                _init_lora(cfg, _lora_targets(cfg), g, dev)
                for g in split(g_dlora, cfg.first_k_dense, dev)]
        if cfg.encoder_layers:
            g_el, g_ep = split(g_enc, 2, dev)
            frozen["enc_layers"] = self._init_layers(
                g_el, dt, dev, cfg.encoder_layers, encoder=True)
            frozen["enc_pos"] = (torch.randn(
                (cfg.n_frames, d), generator=g_ep, device=dev) * 0.02).to(dt)
            frozen["enc_final_norm"] = torch.zeros((d,), device=dev)
            trainable["enc_lora"] = _init_lora(
                cfg, _enc_lora_targets(cfg), g_elora, dev,
                lead=(cfg.encoder_layers,))
        return {"frozen": frozen, "trainable": trainable}

    def param_specs(self):
        """:meth:`init_params`'s tree as ``meta`` tensors (a quantized
        leaf a QTensor of ``meta`` payload and scales), the JAX
        package's ``param_specs`` leaf for leaf: what the dry run traces
        against, since it never draws weights."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        d, V = cfg.d_model, cfg.vocab_size
        frozen: Dict[str, Any] = {"embed": spec((V, d), dt),
                                  "head": spec((d, V), dt),
                                  "final_norm": spec((d,))}
        if not cfg.use_rope:
            frozen["pos_embed"] = spec((cfg.max_pos, d), dt)
        frozen["layers"] = _layer_specs(cfg, dt, lead=(self.n_scanned,))
        if cfg.first_k_dense:
            frozen["dense_layers"] = [
                _layer_specs(cfg, dt, dense_ff=cfg.dense_d_ff)
                for _ in range(cfg.first_k_dense)]
        if cfg.encoder_layers:
            frozen["enc_layers"] = _layer_specs(
                cfg, dt, lead=(cfg.encoder_layers,), encoder=True)
            frozen["enc_pos"] = spec((cfg.n_frames, d), dt)
            frozen["enc_final_norm"] = spec((d,))
        if cfg.quant_bits:
            for key in ("layers", "dense_layers", "enc_layers"):
                if key in frozen:
                    frozen[key] = qlib.quantize_tree_specs(
                        frozen[key], bits=cfg.quant_bits,
                        block=cfg.quant_block, mode=cfg.quant_mode)
        tdt = getattr(torch, cfg.trainable_dtype)
        trainable: Dict[str, Any] = {
            "lora": _lora_specs(cfg, _lora_targets(cfg),
                                lead=(self.n_scanned,)),
            "adapter": adapter_lib.specs(d, d_ff=cfg.adapter_d_ff,
                                         dtype=tdt)}
        if cfg.first_k_dense:
            trainable["dense_lora"] = [
                _lora_specs(cfg, _lora_targets(cfg))
                for _ in range(cfg.first_k_dense)]
        if cfg.encoder_layers:
            trainable["enc_lora"] = _lora_specs(
                cfg, _enc_lora_targets(cfg), lead=(cfg.encoder_layers,))
        return {"frozen": frozen, "trainable": trainable}

    # ---------------------------------------------------------- blocks
    def _block(self, p, lo, positions, enc_out, x, mode="train", cache=None,
               pos=None, cache_len=None, kind=ATTN, specs=None, rings=None):
        """One layer of kind ``kind`` in ``mode`` (``"train"``,
        ``"prefill"`` or ``"decode"``). Returns ``(x, entry, aux)``: the
        layer's cache entry from a prefill, the cache views ``cache``
        updated in place by a decode, None in training; aux is the MoE
        layer's balance loss, else None. ``rings``: a decode's
        ``HeldCache.slots_cut`` (None: every ring cut, as without a
        Runtime it does not matter)."""
        cfg = self.cfg
        rings = rings or {}
        fam = cfg.family
        decode = mode == "decode"
        remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
        B = x.shape[0]
        dt = x.dtype

        def attn_part(x):
            xin = L.rms_norm(x, p["ln1"])
            if decode:
                h, kv = L.attention_decode(p, xin, pos, cache["kv"], cfg,
                                           lora=lo, use_rope=cfg.use_rope,
                                           specs=specs,
                                           slots_cut=rings.get("kv", True))
            else:
                h, (k, v) = L.attention(p, xin, positions, cfg, lora=lo,
                                        causal=True, window=cfg.window,
                                        use_rope=cfg.use_rope, specs=specs)
                kv = L.ring_from_full(
                    *self._whole_heads(k, v), cache_len,
                    kv_quant=cfg.kv_quant_bits == 8) \
                    if mode == "prefill" else None
            return x + h, kv

        if fam == "ssm":
            xin = L.rms_norm(x, p["ln1"])
            if decode:
                h, st = ssm_lib.mamba_decode(p, xin, cache["ssm"], cfg,
                                             lora=lo, specs=specs)
                cache["ssm"]["h"].copy_(st["h"])
                cache["ssm"]["conv"].copy_(st["conv"])
                entry = cache
            else:
                h, st = ssm_lib.mamba_block(p, xin, cfg, lora=lo,
                                            specs=specs)
                entry = {"ssm": st} if mode == "prefill" else None
            return x + h, entry, None

        if fam == "hybrid":
            entry = cache if decode else None
            if kind == ATTN:
                x, kv = _remat(attn_part, remat)(x)
                if mode == "prefill":
                    entry = {"kv": kv, "lru": rglru_lib.rglru_cache_init(
                        cfg, B, dt, x.device)}
            else:
                xin = L.rms_norm(x, p["ln1"])
                if decode:
                    h, st = rglru_lib.rglru_decode(p, xin, cache["lru"], cfg,
                                                   lora=lo, specs=specs)
                    cache["lru"]["h"].copy_(st["h"])
                    cache["lru"]["conv"].copy_(st["conv"])
                else:
                    h, st = rglru_lib.rglru_block(p, xin, cfg, lora=lo,
                                                  specs=specs)
                    if mode == "prefill":
                        entry = {"kv": L.init_kv_cache(
                            cfg, B, cache_len, dt, x.device), "lru": st}
                x = x + h
            mlp_fn = lambda h: L.mlp(p, L.rms_norm(h, p["ln2"]), cfg, lora=lo,
                                     specs=specs)
            return x + _remat(mlp_fn, remat)(x), entry, None

        # the attention families: dense / moe / vlm / encdec
        x, kv = attn_part(x)
        entry = cache if decode else ({"kv": kv} if mode == "prefill"
                                      else None)
        if fam == "encdec":
            xin = L.rms_norm(x, p["lnc"])
            if decode:
                h, _ = L.attention_decode(p, xin, pos, cache["ckv"], cfg,
                                          lora=lo, prefix="c", use_rope=False,
                                          update_cache=False, specs=specs,
                                          slots_cut=rings.get("ckv", True))
            else:
                h, (ck, cv) = L.attention(p, xin, positions, cfg, lora=lo,
                                          prefix="c", causal=False,
                                          kv_x=enc_out, use_rope=False,
                                          specs=specs)
                if mode == "prefill":
                    ck, cv = self._whole_heads(ck, cv)
                    entry["ckv"] = {"k": ck, "v": cv, "slot_pos": torch.arange(
                        ck.shape[1], dtype=torch.int32, device=x.device)}
            x = x + h
        aux = None
        if fam == "moe" and "moe" in p:
            xin = L.rms_norm(x, p["ln2"])
            y, aux = moe_lib.moe_ffn(p["moe"], xin, cfg)
            if cfg.n_shared_experts:
                y = y + L.mlp(p["shared"], xin, cfg, kind="swiglu",
                              specs=None if specs is None
                              else specs["shared"])
            x = x + y
        else:
            x = x + L.mlp(p, L.rms_norm(x, p["ln2"]), cfg, lora=lo,
                          kind="swiglu" if fam == "moe" else cfg.mlp,
                          specs=specs)
        return x, entry, aux

    def _whole_heads(self, k, v):
        """A prefill's k and v over all their heads: in the production
        layout a column-parallel ``wk`` gives the rank its KV heads, and
        the cache holds every head of its slots."""
        rt = rt_lib.get_runtime()
        if rt is None or k.shape[2] == self.cfg.n_kv_heads:
            return k, v
        g = lambda t: rt_lib.all_gather_raw(t.contiguous(), rt.tp_axis, rt,
                                            dim=2)
        return g(k), g(v)

    def _hold(self, entry, stacked=True):
        """A prefill's layer entry (or, not ``stacked``, the adapter's
        ring) as the rank holds it under a Runtime: its slots or channels
        cut over ``model``."""
        rt = rt_lib.get_runtime()
        if rt is None or entry is None:
            return entry
        if not stacked:
            return sh.hold_model_dims(self.cfg, {"adapter": entry},
                                      rt)["adapter"]
        one = tree_lib.tree_map(lambda t: t[None], entry)
        return tree_lib.tree_map(lambda t: t[0],
                                 sh.hold_model_dims(self.cfg, one, rt))

    def _stack(self, frozen, trainable, x, positions, enc_out=None,
               mode="train", cache=None, pos=None, cache_len=None,
               rings=None):
        """The layer loop: the first_k_dense layers unrolled, then the
        stack. Returns ``(x, aux, cache)``: aux summed over the stack's
        MoE layers; a prefill's entries stacked on a leading layer axis,
        a decode's ``cache`` (updated in place), None in training."""
        cfg = self.cfg
        aux = torch.zeros((), device=x.device)
        kw = dict(mode=mode, pos=pos, cache_len=cache_len, rings=rings)
        dp, seq_ax = _dp(cfg), _seq_axis(cfg, x.shape[1])
        dense = []
        dense_specs, layer_specs = self._specs("dense"), self._specs("layer")
        for i in range(cfg.first_k_dense):
            c = None if cache is None else _layer_slice(cache["dense"], i)
            x, entry, _ = self._block(frozen["dense_layers"][i],
                                      trainable["dense_lora"][i], positions,
                                      enc_out, x, cache=c,
                                      specs=None if dense_specs is None
                                      else dense_specs[i], **kw)
            dense.append(self._hold(entry) if mode == "prefill" else entry)
            x = rt_lib.constrain(x, dp, seq_ax, None)
        # unbind once: the backward stacks each leaf's per-layer grads
        lora = {n: {f: torch.unbind(t, 0) for f, t in pair.items()}
                for n, pair in trainable["lora"].items()}
        # a hybrid layer checkpoints its parts, an SSM layer under a
        # Runtime inside its body
        inner = cfg.family == "hybrid" or (
            cfg.family == "ssm" and rt_lib.get_runtime() is not None)
        remat = mode == "train" and cfg.remat and torch.is_grad_enabled() \
            and not inner
        entries = []
        for i in range(self.n_scanned):
            p = _layer_slice(frozen["layers"], i)
            lo = {n: {f: ts[i] for f, ts in pair.items()}
                  for n, pair in lora.items()}
            c = None if cache is None else _layer_slice(cache["scan"], i)
            fn = functools.partial(self._block, p, lo, positions, enc_out,
                                   cache=c, kind=self.kinds[i],
                                   specs=layer_specs, **kw)
            x, entry, a = _remat(fn, remat)(x)
            x = rt_lib.constrain(x, dp, seq_ax, None)
            if a is not None:
                aux = aux + a
            entries.append(self._hold(entry) if mode == "prefill"
                           else entry)
        if mode == "prefill":
            stack = lambda es: tree_lib.tree_map(
                lambda *ls: torch.stack(ls), es[0], *es[1:])
            cache = {"scan": stack(entries)}
            if dense:
                cache["dense"] = stack(dense)
        return x, aux, cache

    def _encode(self, frozen, trainable, frames):
        """The encdec family's encoder over ``frames`` (B, n_frames, d):
        learned positions, bidirectional attention without RoPE, the
        MLP, a final norm."""
        cfg = self.cfg
        x = frames.to(getattr(torch, cfg.dtype)) + self._gathered(
            frozen, "enc_pos")[None]
        positions = torch.arange(x.shape[1], device=x.device)
        lora = {n: {f: torch.unbind(t, 0) for f, t in pair.items()}
                for n, pair in trainable["enc_lora"].items()}
        remat = cfg.remat and torch.is_grad_enabled()
        specs = self._specs("enc")

        def body(p, lo, x):
            h, _ = L.attention(p, L.rms_norm(x, p["ln1"]), positions, cfg,
                               lora=lo, causal=False, use_rope=False,
                               specs=specs)
            x = x + h
            return x + L.mlp(p, L.rms_norm(x, p["ln2"]), cfg, lora=lo,
                             specs=specs)

        for i in range(cfg.encoder_layers):
            p = _layer_slice(frozen["enc_layers"], i)
            lo = {n: {f: ts[i] for f, ts in pair.items()}
                  for n, pair in lora.items()}
            x = _remat(functools.partial(body, p, lo), remat)(x)
        return L.rms_norm(x, frozen["enc_final_norm"])

    def _gathered(self, frozen, name, rows=None):
        """A learned-position table (``pos_embed``, ``enc_pos``), or its
        ``rows`` (an index tensor), whole over d: in the production layout
        the rank's d block gathered at use."""
        t = frozen[name] if rows is None else frozen[name].index_select(
            0, rows)
        rt = rt_lib.get_runtime()
        if rt is None:
            return t
        return rt_lib.gather_at_use(
            t, self.held_specs(rt)["params"]["frozen"][name], rt, name)

    def _embed(self, frozen, tokens):
        dt = getattr(torch, self.cfg.dtype)
        rt = rt_lib.get_runtime()
        if rt is None:
            return frozen["embed"][tokens.long()].to(dt)
        # (vocab, d) specs; a table held whole may have an empty spec
        sv, sd = (*self.held_specs(rt)["params"]["frozen"]["embed"],
                  None, None)[:2]
        e = frozen["embed"]
        if not rt_lib.spec_axes(sv):
            # whole, or the d-split fallback gathered at use
            return rt_lib.gather_at_use(e[tokens.long()], rt_lib.P(
                None, None, sd), rt, "embed").to(dt)
        # vocab-parallel: the rank's rows, zero outside, summed over model
        rt_lib.dist_trace("embed_vocab_dist")
        Vl = e.shape[0]
        local = tokens.long() - rt.index(rt.tp_axis) * Vl
        inside = (local >= 0) & (local < Vl)
        rows = e[local.clamp(0, Vl - 1)] * inside[..., None].to(e.dtype)
        return rt_lib.tp_reduce(rows, rt).to(dt)

    def _embed_inputs(self, frozen, batch):
        """The tokens' embeddings, after the image embeddings (vlm), plus
        the learned positions when the config has no RoPE; and the
        positions 0..S-1."""
        cfg = self.cfg
        x = self._embed(frozen, batch["tokens"])
        if cfg.family == "vlm" and "image_embeds" in batch:
            x = torch.cat([batch["image_embeds"].to(x.dtype), x], 1)
        positions = torch.arange(x.shape[1], device=x.device)
        if not cfg.use_rope:
            x = x + self._gathered(frozen, "pos_embed", positions.clamp(
                max=cfg.max_pos - 1))[None]
        return x, positions

    def _encoder_out(self, frozen, trainable, batch):
        if self.cfg.family != "encdec":
            return None
        return self._encode(frozen, trainable, batch["frames"])

    def _head(self, frozen, x):
        """``(logits, vocab_split)``: in the production layout a
        vocab-parallel head gives the rank's block of the vocabulary."""
        rt = rt_lib.get_runtime()
        if rt is None:
            return x @ frozen["head"].to(x.dtype), False
        spec = self.held_specs(rt)["params"]["frozen"]["head"]
        return L.tp_linear(x, frozen["head"], None, sh.logical_spec(spec),
                           self.cfg, rt, gather=False)

    def _whole_vocab(self, logits, split: bool):
        if not split:
            return logits
        rt = rt_lib.get_runtime()
        return rt_lib.shard_out(logits, rt_lib.P(
            *([None] * (logits.ndim - 1)), rt.tp_axis), rt)

    def _forward(self, frozen, trainable, batch):
        cfg = self.cfg
        enc_out = self._encoder_out(frozen, trainable, batch)
        x, positions = self._embed_inputs(frozen, batch)
        x, aux, _ = self._stack(frozen, trainable, x, positions, enc_out)
        x = L.rms_norm(x, frozen["final_norm"])
        x = adapter_lib.apply(trainable["adapter"], x,
                              n_heads=cfg.adapter_heads, causal=True)
        logits, split = self._head(frozen, x)
        return rt_lib.constrain(logits, _dp(cfg),
                                _seq_axis(cfg, logits.shape[1]), None), \
            split, aux

    def forward(self, frozen, trainable, batch):
        """Training-shape forward. Returns (logits, aux); aux is the MoE
        balance loss summed over the stack's layers, zero for the other
        families. In the production layout the logits of the rank's batch
        rows, whole over the vocabulary, and the global aux."""
        view = _step_view()
        with _within(view):
            logits, split, aux = self._forward(frozen, trainable, batch)
            if view is not None:
                logits = self._whole_vocab(logits, split)
                aux = self._dp_mean(aux, view)
        return logits, aux

    # ---------------------------------------------------------- training
    @staticmethod
    def _dp_mean(v, view):
        """The mean over the dp axes of a per-block value, reduced with an
        identity transpose: each block's share carries its own gradient."""
        n = view.mesh.size(view.cut_axes)
        return rt_lib.tp_reduce(v / n if n > 1 else v, view,
                                axes=view.cut_axes)

    @staticmethod
    def _count(batch):
        """The batch's count of loss tokens: its mask's sum, or its labels'
        number, in fp32."""
        mask = batch.get("mask")
        if mask is None:
            return torch.full((), float(batch["labels"].numel()),
                              device=batch["labels"].device)
        return torch.sum(mask.to(torch.float32))

    def _share(self, frozen, trainable, batch, view, count, blocks):
        """The rank's shares of the global loss in the production layout,
        ``(ce, aux)``: its block's masked sum of the token losses over the
        global ``count`` (the vocab-parallel log-sum-exp, its max, sum of
        exponentials and target logit reduced over ``model``, when the
        head is vocab-parallel) and its aux over the number of dp
        ``blocks`` that hold the batch. Summed over dp they are the
        global values, and each share's gradient is its block's part of
        the global gradient."""
        logits, split, aux = self._forward(frozen, trainable, batch)
        lf = logits.to(torch.float32)
        labels, mask = batch["labels"], batch.get("mask")
        if split:
            tp = view.tp_axis
            mx = rt_lib.pmax(lf.amax(-1), tp, view)
            se = rt_lib.tp_reduce(torch.exp(lf - mx[..., None]).sum(-1),
                                  view)
            lse = torch.log(se) + mx
            Vl = lf.shape[-1]
            local = labels.long() - view.index(tp) * Vl
            inside = (local >= 0) & (local < Vl)
            pick = torch.gather(lf, -1, local.clamp(0, Vl - 1)[..., None])
            gold = rt_lib.tp_reduce(pick[..., 0] * inside.to(lf.dtype),
                                    view)
        else:
            lse = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        nll = lse - gold
        num = nll.sum() if mask is None else torch.sum(
            nll * mask.to(torch.float32))
        return num / torch.clamp_min(count, 1.0), aux / blocks

    def loss_fn(self, frozen, trainable, batch):
        view = _step_view()
        if view is None:
            logits, aux = self.forward(frozen, trainable, batch)
            ce = losses.cross_entropy(logits, batch["labels"],
                                      batch.get("mask"))
            return ce + 0.01 * aux, {"ce": ce, "aux": aux}
        dp = view.cut_axes
        with rt_lib.runtime(view):
            ce, aux = self._share(
                frozen, trainable, batch, view,
                rt_lib.all_reduce_raw(self._count(batch), dp, view),
                view.mesh.size(dp))
            # summed over dp with an identity transpose: each rank's
            # gradient stays its share's
            ce = rt_lib.tp_reduce(ce, view, axes=dp)
            aux = rt_lib.tp_reduce(aux, view, axes=dp)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def grads(self, frozen, trainable, batch):
        """``((loss, parts), grads)`` w.r.t. every trainable leaf, as
        ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them. In the
        production layout each rank's gradient is its batch block's
        share, summed over the dp axes here: the global gradient on every
        rank."""
        tr = tree_lib.tree_map(lambda l: l.detach().requires_grad_(True),
                               trainable)
        flat = list(tree_lib.flatten_with_path(tr))
        view = _step_view()
        # the backward's recomputed layers run under the forward's view
        with torch.enable_grad(), _within(view):
            loss, parts = self.loss_fn(frozen, tr, batch)
            gs = torch.autograd.grad(loss, [l for _, l in flat])
        if view is not None:
            gs = [rt_lib.all_reduce_raw(g, view.cut_axes, view) for g in gs]
        by_path = {path: g for (path, _), g in zip(flat, gs)}
        grads = tree_lib.map_with_path(lambda path, _: by_path[path], tr)
        parts = {k: v.detach() for k, v in parts.items()}
        return (loss.detach(), parts), grads

    def _accumulated(self, frozen, trainable, batch, view):
        """``(loss, grads)`` of ``cfg.grad_accum`` microbatches in the
        production layout. Microbatch i is the JAX package's: rows [i·B/A,
        (i+1)·B/A) of the global batch of B = dp x the rank's rows; each
        rank computes its shares of the microbatches its block meets,
        over each microbatch's global count and number of blocks, and
        accumulates ``acc + g / A`` in fp32; the loss and the gradients
        are summed over dp once."""
        A, dp = self.cfg.grad_accum, view.cut_axes
        n = view.mesh.size(dp)
        j = view.mesh.index(dp) if dp else 0
        Bl = batch["labels"].shape[0]
        if (n * Bl) % A:
            raise ValueError(f"a batch of {n * Bl} rows does not split "
                             f"into {A} microbatches")
        Bm = n * Bl // A
        pieces = [(max(i * Bm, j * Bl) - j * Bl,
                   min((i + 1) * Bm, (j + 1) * Bl) - j * Bl)
                  for i in range(A)]
        dev = batch["labels"].device
        mbs = [{k: v[a:b] for k, v in batch.items()} if b > a else None
               for a, b in pieces]
        counts = rt_lib.all_reduce_raw(torch.stack([
            self._count(mb) if mb is not None else
            torch.zeros((), device=dev) for mb in mbs]), dp, view)
        blocks = rt_lib.all_reduce_raw(torch.tensor(
            [float(mb is not None) for mb in mbs], device=dev), dp, view)
        tr = tree_lib.tree_map(lambda l: l.detach().requires_grad_(True),
                               trainable)
        leaves = tree_lib.leaves(tr)
        acc = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
               for l in leaves]
        loss = torch.zeros((), device=dev)
        for i, mb in enumerate(mbs):
            if mb is None:
                continue
            with torch.enable_grad(), _within(view):
                ce, aux = self._share(frozen, tr, mb, view, counts[i],
                                      blocks[i])
                share = ce + 0.01 * aux
                gs = torch.autograd.grad(share, leaves)
            acc = [a + qlib._div(g, float(A)) for a, g in zip(acc, gs)]
            loss = loss + qlib._div(share.detach(), float(A))
        grads = tree_lib.from_leaves(tr, [
            rt_lib.all_reduce_raw(a, dp, view) for a in acc])
        return rt_lib.all_reduce_raw(loss, dp, view), grads

    def train_step(self, frozen, trainable, opt_state, batch, *, lr=1e-4):
        """One TriplePlay local client step: grads w.r.t. LoRA+adapter
        only, then Adam with global-norm clipping at 1.0. With
        ``cfg.grad_accum`` A > 1 the batch is split into A microbatches
        along its leading axis; their grads are accumulated as ``acc +
        g / A`` in fp32 and the loss as ``loss / A``, as the JAX
        package's scan does (its ``parts`` are then the mean loss and a
        zero aux). In the production layout the batch is the rank's
        block and every rank takes the same global step."""
        A = self.cfg.grad_accum
        view = _step_view()
        if A > 1 and view is not None:
            loss, grads = self._accumulated(frozen, trainable, batch, view)
            parts = {"ce": loss, "aux": torch.zeros_like(loss)}
        elif A > 1:
            grads = tree_lib.tree_map(
                lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device), trainable)
            loss = 0.0
            for i in range(A):
                mb = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])[i]
                      for k, v in batch.items()}
                (li, _), g = self.grads(frozen, trainable, mb)
                grads = tree_lib.tree_map(
                    lambda a, b: a + qlib._div(b, float(A)), grads, g)
                loss = loss + qlib._div(li, float(A))
            parts = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            (loss, parts), grads = self.grads(frozen, trainable, batch)
        trainable, opt_state = optim.adam_update(
            grads, opt_state, trainable, lr=lr, grad_clip=1.0)
        metrics = {"loss": loss, **parts,
                   "grad_norm": optim.global_norm(grads)}
        return trainable, opt_state, metrics

    # ---------------------------------------------------------- serving
    def effective_cache_len(self, context_len: int) -> int:
        if self.cfg.window:
            return min(context_len, self.cfg.window)
        return context_len

    @torch.no_grad()
    def prefill(self, frozen, trainable, batch, max_len: int | None = None):
        """The prompt ``batch["tokens"]`` (B, S), after its
        ``image_embeds`` (vlm) and against its ``frames`` (encdec),
        through the stack. Returns (last-token logits (B, V), cache).
        ``max_len`` sizes the cache (default: the prompt's length,
        patches included); pass the serving context length so that later
        ``decode_step`` calls have room (a sliding-window arch caps it at
        the window). In the production layout the logits of the rank's
        batch rows, whole over the vocabulary, and the cache as the rank
        holds it (``shardings.rank_cache``'s blocks)."""
        with _within(_step_view()):
            return self._prefill(frozen, trainable, batch, max_len)

    def _prefill(self, frozen, trainable, batch, max_len):
        cfg = self.cfg
        enc_out = self._encoder_out(frozen, trainable, batch)
        x, positions = self._embed_inputs(frozen, batch)
        S = x.shape[1]
        x, _, cache = self._stack(frozen, trainable, x, positions, enc_out,
                                  "prefill", cache_len=self.effective_cache_len(
                                      max_len or S))
        x = L.rms_norm(x, frozen["final_norm"])
        x, ring = adapter_lib.prefill(
            trainable["adapter"], x, min(max_len or S, cfg.adapter_window),
            n_heads=cfg.adapter_heads)
        cache["adapter"] = self._hold(ring, stacked=False)
        rt = rt_lib.get_runtime()
        if rt is not None:
            cache = sh.held_cache(cfg, cache, self.cache_specs(
                x.shape[0], max_len or S), rt)
        return self._whole_vocab(*self._head(frozen, x))[:, 0], cache

    @torch.no_grad()
    def decode_step(self, frozen, trainable, cache, tokens, pos):
        """tokens: (B, 1); pos: the tokens' absolute position (patches
        included), a 0-d integer tensor on the model's device. Returns
        (logits (B, V), cache), the cache updated in place. In the
        production layout ``cache`` is the rank's block and the logits are
        its batch rows', whole over the vocabulary."""
        with _within(_step_view()):
            return self._decode_step(frozen, trainable, cache, tokens, pos)

    @staticmethod
    def _rings(cache):
        """Whether each ring of a decode's cache has its slots cut over
        the model axis (``shardings.HeldCache.slots_cut``); None without
        a Runtime or with a model axis of one, where a whole ring and a
        cut one are the same."""
        rt = rt_lib.get_runtime()
        if rt is None or rt.tp_size == 1:
            return None
        if not isinstance(cache, sh.HeldCache):
            raise ValueError(
                "decode_step under a Runtime takes the cache as the rank "
                "holds it (shardings.rank_cache, or a prefill under the "
                "Runtime): a held block alone does not say whether its "
                "slots were cut")
        return cache.slots_cut

    def _decode_step(self, frozen, trainable, cache, tokens, pos):
        cfg = self.cfg
        rings = self._rings(cache)
        x = self._embed(frozen, tokens)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        if not cfg.use_rope:
            # index_select with a 1-element index: indexing by the 0-d
            # pos would read it back to the host
            x = x + self._gathered(frozen, "pos_embed", pos.clamp(
                max=cfg.max_pos - 1).reshape(1).long())[None]
        x, _, cache = self._stack(frozen, trainable, x, None, None,
                                  "decode", cache=cache, pos=pos, rings=rings)
        x = L.rms_norm(x, frozen["final_norm"])
        x, _ = adapter_lib.decode(
            trainable["adapter"], x, cache["adapter"], pos,
            n_heads=cfg.adapter_heads,
            slots_cut=(rings or {}).get("adapter", True))
        return self._whole_vocab(*self._head(frozen, x))[:, 0], cache

    def init_cache(self, batch: int, context_len: int, device=None):
        """An empty cache (zeros, ``slot_pos`` -1) for ``batch`` streams
        of up to ``context_len`` tokens, on the card unless ``device``."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = getattr(torch, cfg.dtype)
        if cfg.family == "ssm":
            one = {"ssm": ssm_lib.mamba_cache_init(cfg, batch, dt, dev)}
        else:
            one = {"kv": L.init_kv_cache(
                cfg, batch, self.effective_cache_len(context_len), dt, dev)}
            if cfg.family == "hybrid":
                one["lru"] = rglru_lib.rglru_cache_init(cfg, batch, dt, dev)
            if cfg.family == "encdec":
                one["ckv"] = L.init_kv_cache(cfg, batch, cfg.n_frames, dt,
                                             dev)
        stack = lambda n: tree_lib.tree_map(
            lambda a: a.expand(n, *a.shape).clone(), one)
        out = {"scan": stack(self.n_scanned)}
        if cfg.first_k_dense:
            out["dense"] = stack(cfg.first_k_dense)
        Ma = min(context_len, cfg.adapter_window)
        nh = cfg.adapter_heads
        shape = (batch, Ma, nh, cfg.d_model // nh)
        out["adapter"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                          "v": torch.zeros(shape, dtype=dt, device=dev),
                          "slot_pos": torch.full((Ma,), -1,
                                                 dtype=torch.int32,
                                                 device=dev)}
        return out


    def _entry_specs(self, batch: int, M: int, dt):
        """One layer's cache entry as ``meta`` tensors."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return {"ssm": ssm_lib.mamba_cache_specs(cfg, batch, dt)}
        entry = {"kv": L.kv_cache_specs(cfg, batch, M, dt)}
        if cfg.family == "hybrid":
            entry["lru"] = rglru_lib.rglru_cache_specs(cfg, batch, dt)
        if cfg.family == "encdec":
            entry["ckv"] = L.kv_cache_specs(cfg, batch, cfg.n_frames, dt)
        return entry

    def cache_specs(self, batch: int, context_len: int):
        """:meth:`init_cache`'s tree as ``meta`` tensors."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        one = self._entry_specs(batch, self.effective_cache_len(context_len),
                                dt)
        stack = lambda n: tree_lib.tree_map(
            lambda s: spec((n, *s.shape), s.dtype), one)
        out = {"scan": stack(self.n_scanned)}
        if cfg.first_k_dense:
            out["dense"] = stack(cfg.first_k_dense)
        out["adapter"] = adapter_lib.cache_specs(
            cfg.d_model, batch, min(context_len, cfg.adapter_window), dt,
            n_heads=cfg.adapter_heads)
        return out

    def input_specs(self, shape: InputShape) -> Dict[str, Any]:
        """Every input of one step at ``shape`` (an entry of
        ``configs.INPUT_SHAPES``) as ``meta`` tensors: the train batch,
        the prompt, or a decode step's token, position and cache."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "decode":
            return {"tokens": spec((B, 1), i32), "pos": spec((), i32),
                    "cache": self.cache_specs(B, S)}
        S_text = S - cfg.n_patches if cfg.family == "vlm" else S
        out = {"tokens": spec((B, S_text), i32)}
        if shape.kind == "train":
            out["labels"] = spec((B, S), i32)
            out["mask"] = spec((B, S))
        if cfg.family == "vlm":
            out["image_embeds"] = spec((B, cfg.n_patches, cfg.d_model), dt)
        if cfg.family == "encdec":
            out["frames"] = spec((B, cfg.n_frames, cfg.d_model), dt)
        return out


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
