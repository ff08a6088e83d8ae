"""The RG-LRU decode on a model axis that cuts the LRU width but not its
16 gate blocks.

``shardings.cache_specs_tree`` cuts the RG-LRU state (``h`` (L, B, w),
``conv`` (L, B, K - 1, w)) over ``model`` wherever the model axis m
divides the width w, as the JAX package's rules do; its width-parallel
body needs m to divide the 16 gate blocks too. At m = 5 and w = 320 the
decode (``models.rglru.rglru_decode``) gathers the rank's state whole at
use, steps on the whole weights and writes back the rank's block
(``rglru_decode_gather``), where the JAX package runs its GSPMD decode.

A spawned gloo world of 5 ranks on ``("model",)``
(``_torch_dist_worker.rglru_mesh``) runs reduced RecurrentGemma with
``lru_width`` 320 in the production layout: a prefill of 8 tokens, then
two teacher-forced decode steps, from the prefill's held cache and from
``rank_cache`` of the JAX package's prefill cache. Against the JAX
package's prefill and decode on the same numpy inputs (host CPU, fp32,
within 1e-5 of the largest magnitude): every step's logits on every
rank, and each rank's held block of the RG-LRU state after the prefill
and after each step; ``DIST_TRACES`` shows the new body at every RG-LRU
layer of every step, and neither the width-parallel body nor the whole-
state fallback.
"""
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_zoo import Case, to_port
from _torch_dist_worker import start
from repro_torch.launch import shardings as sh
from repro_torch.models import rglru

torch.set_num_threads(1)
M_AXIS, WIDTH, B, P, STEPS, MAX_LEN = 5, 320, 2, 8, 2, 16


def _rel(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(float(np.abs(w).max()), 1e-30))


@functools.lru_cache(maxsize=None)
def _world():
    """The ranks' results and the JAX package's logits and RG-LRU state
    after the prefill and after each decode step."""
    c = Case("recurrentgemma-2b", lru_width=WIDTH)
    jb, _ = c.batch(11, B=B, S_tok=P + STEPS, train_=False)
    pj = {"tokens": jb["tokens"][:, :P]}
    toks = [jb["tokens"][:, P + i:P + i + 1] for i in range(STEPS)]
    jl, jc = c.prefill(c.frozen, c.tr, pj, max_len=MAX_LEN)
    lru = lambda cache: {k: np.asarray(v)
                         for k, v in cache["scan"]["lru"].items()}
    ranks = start("rglru_mesh", M_AXIS, {
        "mesh": ((M_AXIS,), ("model",)), "cfg": c.cfg, "frozen": c.tf,
        "trainable": c.ttr, "cache": to_port(jc), "max_len": MAX_LEN,
        "prefill": {"tokens": torch.from_numpy(np.array(pj["tokens"]))},
        "decode": [(torch.from_numpy(np.array(t)),
                    torch.tensor(P + i, dtype=torch.int32))
                   for i, t in enumerate(toks)]}, timeout=400)
    want = [(np.asarray(jl), lru(jc))]
    for i, tok in enumerate(toks):
        jl, jc = c.decode(c.frozen, c.tr, jc, tok,
                          jnp.asarray(P + i, jnp.int32))
        want.append((np.asarray(jl), lru(jc)))
    return c.cfg, want, ranks.wait()


def _check_state(got, want, r, what):
    """A rank's held RG-LRU state: its block of the channels."""
    wl = WIDTH // M_AXIS
    for k in ("h", "conv"):
        g = got[k].numpy()
        assert g.shape[-1] == wl, (what, k, g.shape)
        assert _rel(g, want[k][..., r * wl:(r + 1) * wl]) <= 1e-5, (what, k)


def test_the_width_splits_over_the_model_axis_but_not_the_gate_blocks():
    assert WIDTH % M_AXIS == 0 and WIDTH % rglru.GATE_BLOCKS == 0
    assert rglru.GATE_BLOCKS % M_AXIS != 0
    cfg, _, _ = _world()
    assert not rglru._body_ok(cfg, M_AXIS)
    # no raise is left for a width that the model axis divides
    assert "NotImplementedError" not in inspect.getsource(rglru.rglru_decode)


@pytest.mark.parametrize("source", ["decode", "decode_rank_cache"])
def test_decode_logits_and_state_are_the_jax_decode(source):
    """Every decode step's logits (whole on every rank: the model axis
    is the only one) and each rank's block of the state after it, from
    the prefill's held cache and from ``rank_cache`` of the JAX
    package's."""
    _, want, res = _world()
    for r in res:
        logits, states, _ = r[source]
        assert len(logits) == STEPS
        for step, (g, st) in enumerate(zip(logits, states)):
            wl, ws = want[step + 1]
            assert _rel(g.numpy(), wl) <= 1e-5, (source, step)
            _check_state(st, ws, r["model_index"], (source, step))


def test_prefill_holds_the_state_cut_as_rank_cache_cuts_it():
    """The prefill's logits, and its held cache exactly the JAX cache's
    blocks by ``cache_specs_tree`` (the RG-LRU state cut over
    ``model``) within 1e-5, as ``rank_cache`` gives the decode."""
    cfg, want, res = _world()
    for r in res:
        g, st = r["prefill"]
        assert _rel(g.numpy(), want[0][0]) <= 1e-5
        _check_state(st, want[0][1], r["model_index"], "prefill")
        assert r["cache_blocks"] <= 1e-5
        # the prefill's fallback body returns whole state; the model holds
        # its block
        assert r["prefill_traces"].get("rglru_block_fallback", 0) >= 1


def test_dist_traces_show_the_gather_body_at_every_rglru_layer():
    cfg, _, res = _world()
    n_lru = sum(k == "rglru" for k in cfg.layer_kinds())
    assert n_lru >= 1
    for r in res:
        for source in ("decode", "decode_rank_cache"):
            for traces in r[source][2]:
                assert traces.get("rglru_decode_gather") == n_lru, traces
                assert traces.get("h_gather") == n_lru
                assert traces.get("conv_gather") == n_lru
                assert "rglru_decode_dist" not in traces
                assert "rglru_decode_fallback" not in traces


def test_the_cache_rule_cuts_the_state_at_this_width():
    """``cache_specs_tree`` cuts ``h`` and ``conv`` over ``model`` at
    width 320 on 5 ranks (the cut the decode gathers)."""
    class _Mesh:
        axis_names = ("model",)
        shape = {"model": M_AXIS}

        def size(self, axes):
            return M_AXIS if axes else 1

    cfg, _, _ = _world()
    L = cfg.n_layers
    specs = sh.cache_specs_tree(cfg, {"scan": {"lru": {
        "h": torch.empty((L, B, WIDTH), device="meta"),
        "conv": torch.empty((L, B, cfg.ssm_conv - 1, WIDTH),
                            device="meta")}}}, _Mesh(), ())
    lru_specs = specs["scan"]["lru"]
    assert tuple(lru_specs["h"])[-1] == "model"
    assert tuple(lru_specs["conv"])[-1] == "model"
