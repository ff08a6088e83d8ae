"""The model facade for the dense decoder and Mamba-1 SSM families, port
of ``repro.models.model``.

A ``Model`` exposes:
  init_params(generator, device) -> {"frozen", "trainable": {"lora", "adapter"}}
  forward(frozen, trainable, batch) -> logits, aux        (train shapes)
  loss_fn(...)    -> loss, parts
  grads(...)      -> (loss, parts), grads w.r.t. the trainables
  train_step(...) -> one TriplePlay local client step (LoRA+adapter),
                     over ``cfg.grad_accum`` microbatches
  prefill(frozen, trainable, batch, max_len) -> last logits, cache
  decode_step(frozen, trainable, cache, tokens, pos) -> logits, cache
  init_cache(batch, context_len, device) -> an empty cache

The frozen backbone may be quantized (cfg.quant_bits in {0, 8, 4}, linear
or NF4 blocks); only the LoRA pairs and the paper's attention adapter are
trained, as on a TriplePlay client. Trees keep the JAX package's layout:
the layer weights are stacked with a leading layer axis (a quantized one
as a stacked QTensor ``(L, G, B[/2], N)``) and the LoRA leaves likewise,
so weights convert structurally (:mod:`repro_torch.convert`). The JAX
``lax.scan`` over the stack is a Python loop over per-layer slices in
one of the JAX package's three modes, ``"train"``, ``"prefill"`` and
``"decode"``. In training ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``), as the
JAX scan body is checkpointed. An SSM layer is ``x + mamba_block(
rms_norm(x))`` (:mod:`repro_torch.models.ssm`); on one device the JAX
package does not rematerialize it, so there the checkpoint changes
memory only.

The serving cache keeps the JAX package's tree, ``{"scan": {"kv": ring
cache} or {"ssm": {"h", "conv"}}, stacked on a leading layer axis,
"adapter": the adapter's ring cache}``, so it converts leaf for leaf. A
decode step writes the new token's rows into those stacked buffers in
place and returns the same dict; the step computes its slot from the
0-d ``pos`` tensor on the device and reads nothing back to the host.
``prefill`` and ``decode_step`` build no autograd graph. The layer
stack's constraint hooks for a device mesh are no-ops on one card and
are not ported; the hybrid, moe, encdec and vlm families come with
ROADMAP Queue A item 8.4.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapter as adapter_lib
from repro_torch.core import lora as lora_lib
from repro_torch.core import losses, optim
from repro_torch.core import quant as qlib
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib


def split(generator: torch.Generator, n: int, device) -> list:
    """``n`` independent generators on ``device``, seeded from
    ``generator`` (the port's counterpart of ``jax.random.split``)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def _lora_targets(cfg: ModelConfig) -> Dict[str, tuple]:
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    if cfg.family == "ssm":
        return dict(in_proj_x=(d, cfg.d_inner), out_proj=(cfg.d_inner, d))
    t = dict(wq=(d, qd), wk=(d, kvd), wv=(d, kvd), wo=(qd, d),
             wu=(d, ff), wd=(ff, d))
    if cfg.mlp == "swiglu":
        t["wg"] = (d, ff)
    return t


def _init_layer(cfg: ModelConfig, generator, dtype, device):
    """One backbone layer, drawn from its own generator."""
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": torch.zeros((d,), device=device)}
    if cfg.family == "ssm":
        p.update(ssm_lib.init_mamba(generator, cfg, dtype, device))
        return p
    p["ln2"] = torch.zeros((d,), device=device)
    p.update(L.init_attention(generator, cfg, dtype, device))
    p.update(L.init_mlp(generator, d, cfg.d_ff, cfg.mlp, dtype, device))
    return p


def _quant_plan(cfg: ModelConfig, name: str, shape, dtype):
    """``(bits, mode, block)`` with which ``quantize_tree`` would quantize
    the stacked leaf ``name`` of this shape, or None to keep it."""
    if not cfg.quant_bits or not qlib._quantizable(name, shape, dtype, 4096):
        return None
    b = qlib._pick_block(shape[-2], cfg.quant_block)
    if b % 2:
        return 8, "linear", b           # odd blocks do not pack
    return cfg.quant_bits, cfg.quant_mode, b


def _layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree; a stacked QTensor gives the 3-D
    QTensor of that layer (views of its payload and scales)."""
    def one(leaf):
        if isinstance(leaf, qlib.QTensor):
            return qlib.QTensor(q=leaf.q[i], scales=leaf.scales[i],
                                bits=leaf.bits, mode=leaf.mode,
                                block=leaf.block, out_dtype=leaf.out_dtype,
                                orig_shape=tuple(leaf.orig_shape[1:]))
        return leaf[i]
    return tree_lib.tree_map(one, tree)


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "ssm") or not cfg.use_rope:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family"
                f"{'' if cfg.use_rope else ' without RoPE'} is not ported "
                "yet (they come with the zoo's later slices; see ROADMAP "
                "Queue A item 8.4)")
        self.cfg = cfg

    # ---------------------------------------------------------- params
    def _init_layers(self, generator, dtype, device):
        """The stacked layer tree, drawn one layer at a time. With
        ``cfg.quant_bits`` each matrix is quantized as soon as it is drawn
        and written into preallocated stacked payloads, so no dense stack
        (and no full-stack NF4 search) is ever held: the result equals
        ``quantize_tree`` of the dense stack bit for bit, since blocks run
        along K inside each layer."""
        cfg = self.cfg
        Lyr = cfg.n_layers
        out: Dict[str, Any] = {}
        for i, g in enumerate(split(generator, Lyr, device)):
            layer = _init_layer(cfg, g, dtype, device)
            for name, w in layer.items():
                shape = (Lyr, *w.shape)
                plan = _quant_plan(cfg, name, shape, w.dtype)
                if plan is None:
                    if name not in out:
                        out[name] = torch.empty(shape, dtype=w.dtype,
                                                device=device)
                    out[name][i] = w
                    continue
                bits, mode, block = plan
                qt = qlib.quantize(w, bits=bits, block=block, mode=mode)
                if name not in out:
                    out[name] = qlib.QTensor(
                        q=torch.empty((Lyr, *qt.q.shape), dtype=qt.q.dtype,
                                      device=device),
                        scales=torch.empty((Lyr, *qt.scales.shape),
                                           dtype=qt.scales.dtype,
                                           device=device),
                        bits=bits, mode=mode, block=qt.block,
                        out_dtype=w.dtype, orig_shape=shape)
                out[name].q[i] = qt.q
                out[name].scales[i] = qt.scales
            del layer
        return out

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
        frozen["layers"] = self._init_layers(g_lay, dt, dev)
        trainable = {
            "lora": {n: lora_lib.init_pair(g, k, nn, cfg.lora_rank,
                                           dtype=tdt, lead=(cfg.n_layers,))
                     for (n, (k, nn)), g in zip(
                         sorted(_lora_targets(cfg).items()),
                         split(g_lora, len(_lora_targets(cfg)), dev))},
            "adapter": adapter_lib.init(g_ad, d, n_heads=cfg.adapter_heads,
                                        d_ff=cfg.adapter_d_ff, dtype=tdt,
                                        device=dev),
        }
        return {"frozen": frozen, "trainable": trainable}

    # ---------------------------------------------------------- forward
    def _block(self, p, lo, positions, x, mode="train", cache=None,
               pos=None, cache_len=None):
        """One layer in ``mode`` (``"train"``, ``"prefill"`` or
        ``"decode"``). Returns ``(x, entry)``: the layer's cache entry
        from a prefill, the cache views ``cache`` updated in place by a
        decode, None in training."""
        cfg = self.cfg
        entry = None
        xin = L.rms_norm(x, p["ln1"])
        if cfg.family == "ssm":
            if mode == "decode":
                h, st = ssm_lib.mamba_decode(p, xin, cache["ssm"], cfg,
                                             lora=lo)
                cache["ssm"]["h"].copy_(st["h"])
                cache["ssm"]["conv"].copy_(st["conv"])
                entry = cache
            else:
                h, st = ssm_lib.mamba_block(p, xin, cfg, lora=lo)
                entry = {"ssm": st} if mode == "prefill" else None
            return x + h, entry
        if mode == "decode":
            h, _ = L.attention_decode(p, xin, pos, cache["kv"], cfg, lora=lo)
            entry = cache
        else:
            h, (k, v) = L.attention(p, xin, positions, cfg, lora=lo)
            if mode == "prefill":
                entry = {"kv": L.ring_from_full(
                    k, v, cache_len, kv_quant=cfg.kv_quant_bits == 8)}
        x = x + h
        return x + L.mlp(p, L.rms_norm(x, p["ln2"]), cfg, lora=lo), entry

    def _stack(self, frozen, trainable, x, positions, mode="train",
               cache=None, pos=None, cache_len=None):
        """The layer loop. Returns ``(x, cache)``: a prefill's entries
        stacked on a leading layer axis, a decode's ``cache`` (updated in
        place), None in training."""
        cfg = self.cfg
        # unbind once: the backward stacks each leaf's per-layer grads
        lora = {n: {f: torch.unbind(t, 0) for f, t in pair.items()}
                for n, pair in trainable["lora"].items()}
        entries = []
        for i in range(cfg.n_layers):
            p = _layer_slice(frozen["layers"], i)
            lo = {n: {f: ts[i] for f, ts in pair.items()}
                  for n, pair in lora.items()}
            c = None if cache is None else _layer_slice(cache["scan"], i)
            fn = functools.partial(self._block, p, lo, positions, mode=mode,
                                   cache=c, pos=pos, cache_len=cache_len)
            if mode == "train" and cfg.remat and torch.is_grad_enabled():
                x, _ = checkpoint(fn, x, use_reentrant=False)
            else:
                x, entry = fn(x)
                entries.append(entry)
        if mode == "prefill":
            return x, {"scan": tree_lib.tree_map(
                lambda *ls: torch.stack(ls), entries[0], *entries[1:])}
        return x, cache

    def _embed(self, frozen, tokens):
        return frozen["embed"][tokens.long()].to(getattr(torch,
                                                         self.cfg.dtype))

    def forward(self, frozen, trainable, batch):
        """Training-shape forward. Returns (logits, aux); aux is the MoE
        balance loss, zero for the dense family."""
        cfg = self.cfg
        x = self._embed(frozen, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._stack(frozen, trainable, x, positions)
        x = L.rms_norm(x, frozen["final_norm"])
        x = adapter_lib.apply(trainable["adapter"], x,
                              n_heads=cfg.adapter_heads, causal=True)
        logits = x @ frozen["head"].to(x.dtype)
        return logits, torch.zeros((), device=x.device)

    # ---------------------------------------------------------- training
    def loss_fn(self, frozen, trainable, batch):
        logits, aux = self.forward(frozen, trainable, batch)
        ce = losses.cross_entropy(logits, batch["labels"], batch.get("mask"))
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def grads(self, frozen, trainable, batch):
        """``((loss, parts), grads)`` w.r.t. every trainable leaf, as
        ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them."""
        tr = tree_lib.tree_map(lambda l: l.detach().requires_grad_(True),
                               trainable)
        flat = list(tree_lib.flatten_with_path(tr))
        with torch.enable_grad():
            loss, parts = self.loss_fn(frozen, tr, batch)
            gs = torch.autograd.grad(loss, [l for _, l in flat])
        by_path = {path: g for (path, _), g in zip(flat, gs)}
        grads = tree_lib.map_with_path(lambda path, _: by_path[path], tr)
        parts = {k: v.detach() for k, v in parts.items()}
        return (loss.detach(), parts), grads

    def train_step(self, frozen, trainable, opt_state, batch, *, lr=1e-4):
        """One TriplePlay local client step: grads w.r.t. LoRA+adapter
        only, then Adam with global-norm clipping at 1.0. With
        ``cfg.grad_accum`` A > 1 the batch is split into A microbatches
        along its leading axis; their grads are accumulated as ``acc +
        g / A`` in fp32 and the loss as ``loss / A``, as the JAX
        package's scan does (its ``parts`` are then the mean loss and a
        zero aux)."""
        A = self.cfg.grad_accum
        if A > 1:
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
        """The prompt ``batch["tokens"]`` (B, S) through the stack.
        Returns (last-token logits (B, V), cache). ``max_len`` sizes the
        cache (default: the prompt length); pass the serving context
        length so that later ``decode_step`` calls have room (a
        sliding-window arch caps it at the window)."""
        cfg = self.cfg
        x = self._embed(frozen, batch["tokens"])
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        x, cache = self._stack(frozen, trainable, x, positions, "prefill",
                               cache_len=self.effective_cache_len(
                                   max_len or S))
        x = L.rms_norm(x, frozen["final_norm"])
        x, cache["adapter"] = adapter_lib.prefill(
            trainable["adapter"], x, min(max_len or S, cfg.adapter_window),
            n_heads=cfg.adapter_heads)
        return (x @ frozen["head"].to(x.dtype))[:, 0], cache

    @torch.no_grad()
    def decode_step(self, frozen, trainable, cache, tokens, pos):
        """tokens: (B, 1); pos: the tokens' absolute position, a 0-d
        integer tensor on the model's device. Returns (logits (B, V),
        cache), the cache updated in place."""
        cfg = self.cfg
        x = self._embed(frozen, tokens)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        x, cache = self._stack(frozen, trainable, x, None, "decode",
                               cache=cache, pos=pos)
        x = L.rms_norm(x, frozen["final_norm"])
        x, _ = adapter_lib.decode(trainable["adapter"], x, cache["adapter"],
                                  pos, n_heads=cfg.adapter_heads)
        return (x @ frozen["head"].to(x.dtype))[:, 0], cache

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
        Ma = min(context_len, cfg.adapter_window)
        nh = cfg.adapter_heads
        shape = (batch, Ma, nh, cfg.d_model // nh)
        return {"scan": tree_lib.tree_map(
                    lambda a: a.expand(cfg.n_layers, *a.shape).clone(), one),
                "adapter": {"k": torch.zeros(shape, dtype=dt, device=dev),
                            "v": torch.zeros(shape, dtype=dt, device=dev),
                            "slot_pos": torch.full((Ma,), -1,
                                                   dtype=torch.int32,
                                                   device=dev)}}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
