"""The dry run's calibrated paths (``cfg.calibrate`` with
``cfg.unroll_layers``) against the JAX package's with the same flags and
against the port's own uncalibrated path: at the reduced fp32 configs of
the dense, SSM, hybrid and encdec families, the logits, the loss and
every gradient leaf agree within 1e-5 of the leaf's largest magnitude
(sequences longer than the scan chunk, so the single-chunk scans differ
from the chunked ones in their order of work). ``_chunked_ssm_scan``
equals the JAX one at several chunk sizes, a padded one among them, and
the MoE body's batched expert product equals its per-expert loop on the
8-rank gloo harness, fp32 and NF4 experts, forward and dx."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_zoo import Case, assert_tree_close, rel
from _torch_dist_worker import spawn
from repro.core import losses as jlosses
from repro.models import ssm as jssm
from repro_torch.configs import get_reduced
from repro_torch.core import quant as qlib
from repro_torch.models import build_model, moe, ssm

# arch -> tokens a sequence (the recurrent families' scan_chunk is 32)
FAMILIES = {"yi-9b": 17, "falcon-mamba-7b": 40, "recurrentgemma-2b": 40,
            "whisper-medium": 17}
TOL = 1e-5


def _close(got, want, what):
    assert rel(got.detach().numpy(), np.asarray(want)) <= TOL, \
        (what, rel(got.detach().numpy(), np.asarray(want)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_calibrated_step_equals_jax_and_uncalibrated(arch):
    case = Case(arch, calibrate=True, unroll_layers=True)
    assert case.cfg.calibrate and case.jcfg.calibrate
    jb, tb = case.batch(3, S_tok=FAMILIES[arch])
    jm = case.jm

    def loss_and_logits(tr, frozen, b):     # one compile for both
        logits, aux = jm.forward(frozen, tr, b)
        ce = jlosses.cross_entropy(logits, b["labels"], b.get("mask"))
        return ce + 0.01 * aux, logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(case.tr, case.frozen, jb)
    with torch.no_grad():
        logits, _ = case.tm.forward(case.tf, case.ttr, tb)
    (loss, _), grads = case.tm.grads(case.tf, case.ttr, tb)
    _close(logits, jlogits, "logits vs JAX")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert_tree_close(grads, jgrads, TOL, "grads vs JAX")

    plain = build_model(case.cfg.replace(calibrate=False,
                                         unroll_layers=False))
    with torch.no_grad():
        logits_p, _ = plain.forward(case.tf, case.ttr, tb)
    (loss_p, _), grads_p = plain.grads(case.tf, case.ttr, tb)
    _close(logits, logits_p.numpy(), "logits vs uncalibrated")
    np.testing.assert_allclose(float(loss), float(loss_p), rtol=TOL)
    for (path, g), (_, gp) in zip(
            sorted(_flat(grads).items()), sorted(_flat(grads_p).items())):
        _close(g, gp.numpy(), ("grad vs uncalibrated", path))


def _flat(tree):
    from repro_torch import tree as tree_lib
    return dict(tree_lib.flatten_with_path(tree))


@pytest.mark.parametrize("chunk", [4, 6, 20, 64])
def test_chunked_ssm_scan_equals_jax(chunk):
    B, S, di, N = 2, 20, 12, 5
    rs = np.random.RandomState(chunk)
    dt = np.log1p(np.exp(rs.randn(B, S, di))).astype(np.float32) * 0.3
    A = -np.exp(rs.randn(di, N) * 0.3).astype(np.float32)
    Bm, Cm = (rs.randn(B, S, N).astype(np.float32) for _ in range(2))
    xc = rs.randn(B, S, di).astype(np.float32)
    h0 = rs.randn(B, di, N).astype(np.float32) * 0.1
    jy, jh = jssm._chunked_ssm_scan(*(jnp.asarray(a) for a in
                                      (dt, A, Bm, Cm, xc, h0)), chunk)
    y, h = ssm._chunked_ssm_scan(*(torch.from_numpy(a) for a in
                                   (dt, A, Bm, Cm, xc, h0)), chunk)
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    _close(y, jy, "y")
    _close(h, jh, "h_last")
    # and the plain time loop from h0
    yl, hl = ssm._scan_from(*(torch.from_numpy(a) for a in
                              (dt, xc, Bm, Cm, A, h0)))
    _close(y, yl.numpy(), "y vs the time loop")
    _close(h, hl.numpy(), "h_last vs the time loop")


@functools.lru_cache(maxsize=None)
def _moe_world():
    cfg = get_reduced("qwen3-moe-235b-a22b").replace(capacity_factor=8.0)
    g = torch.Generator().manual_seed(0)
    p = moe.init_experts(g, cfg, torch.float32, "cpu")
    pq = {k: (qlib.quantize(v, bits=4, block=64, mode="nf4")
              if k != "router" else v) for k, v in p.items()}
    x = torch.randn((4, 8, cfg.d_model), generator=g) * 0.1
    return spawn("moe_calibrate", 8, {"cfg": cfg, "p": p, "pq": pq, "x": x},
                 timeout=400)


@pytest.mark.parametrize("weights", ["p", "pq"])
def test_moe_batched_experts_equal_loop(weights):
    for res in _moe_world():
        y, aux, dx = res[(weights, False)]
        yc, auxc, dxc = res[(weights, True)]
        _close(yc, y.numpy(), "y")
        np.testing.assert_allclose(float(auxc), float(aux), rtol=1e-6)
        _close(dxc, dx.numpy(), "dx")
