"""The port's federated QLoRA trainer (repro_torch.launch.train) against
the JAX package's (repro.launch.train), on the CPU at reduced Yi-9B with
an NF4 backbone (block 64).

The token streams are numpy in both packages and equal bit for bit. A
client's local round runs on the same weights (the JAX init, converted)
and the same batch indices (``RandomState(seed)`` in both): its int8
uplink has the same byte count. At each local step the port's gradients
at the JAX package's parameters agree with the JAX gradients within
1e-5 of each leaf's largest magnitude. Each dequantized delta leaf lies
within one int8 step (the leaf's largest quantization scale) of the JAX
package's, but for at most 0.1% of the elements whose gradient stays
well above Adam's eps at every step, and every element within the range
of the local updates. FedAvg of the same quantized deltas agrees to
fp32 rounding.
The two-round loss decrease of tests/test_system.py holds on the port."""
import os

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_reduced as j_reduced
from repro.core import optim as joptim
from repro.core import quant as jq
from repro.launch import train as jtrain
from repro.models import build_model as j_build
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced
from repro_torch.core import quant as qlib
from repro_torch.launch import train
from repro_torch.models import build_model

torch.set_num_threads(1)
NF4 = dict(quant_bits=4, quant_mode="nf4", quant_block=64)


def _flat_np(tree):
    return dict(tree_lib.flatten_with_path(convert.tree_to_numpy(tree)))


@pytest.mark.parametrize("vocab,n_clients,docs,seq", [(256, 2, 64, 48),
                                                      (64000, 4, 8, 64)])
def test_synthetic_token_stream_bitwise(vocab, n_clients, docs, seq):
    want = jtrain.synthetic_token_stream(np.random.RandomState(0), vocab,
                                         n_clients, docs_per_client=docs,
                                         seq=seq)
    got = train.synthetic_token_stream(np.random.RandomState(0), vocab,
                                       n_clients, docs_per_client=docs,
                                       seq=seq)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_docs,base,batch,epochs", [
    (64, 2, 4, 0.0), (64, 2, 4, 1.0), (10, 3, 4, 2.5), (1, 5, 8, 0.5)])
def test_local_steps_for_matches_jax(n_docs, base, batch, epochs):
    assert train.local_steps_for(n_docs, base_steps=base, batch=batch,
                                 epochs=epochs) == \
        jtrain.local_steps_for(n_docs, base_steps=base, batch=batch,
                               epochs=epochs)


@pytest.fixture(scope="module")
def round_pair():
    """One round of two clients in both packages on the same weights."""
    jcfg = j_reduced("yi-9b").replace(**NF4)
    jm = j_build(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    frozen, tr = params["frozen"], params["trainable"]
    data = jtrain.synthetic_token_stream(np.random.RandomState(0),
                                         jcfg.vocab_size, 2, seq=16)
    kw = dict(steps=2, batch=4, lr=1e-3, comm_bits=8)
    jout = [jtrain.client_update(jm, frozen, tr, data[c], seed=c, **kw)
            for c in range(2)]
    tm = build_model(get_reduced("yi-9b").replace(**NF4))
    tf, ttr = (convert.tree_from_numpy(t, "cpu") for t in (frozen, tr))
    tout = [train.client_update(tm, tf, ttr, data[c], seed=c, **kw)
            for c in range(2)]
    # each client's steps again along the JAX trajectory: the JAX
    # gradients and the port's at the same (JAX) parameters, per step
    grad_fn = jax.jit(jax.value_and_grad(
        lambda t, f, b: jm.loss_fn(f, t, b), has_aux=True))
    step_fn = jax.jit(lambda f, t, o, b: jm.train_step(f, t, o, b,
                                                       lr=kw["lr"]))
    grads = []
    for c in range(2):
        rng, jt = np.random.RandomState(c), tr
        jopt = joptim.adam_init(jt)
        per_step = []
        for _ in range(kw["steps"]):
            toks = data[c][rng.randint(0, len(data[c]), kw["batch"])]
            jb = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                  "mask": np.ones(toks[:, 1:].shape, np.float32)}
            _, jg = grad_fn(jt, frozen, jb)
            jt_np, jg = (jax.tree.map(np.asarray, t) for t in (jt, jg))
            _, tg = tm.grads(tf, convert.tree_from_numpy(jt_np, "cpu"),
                             train.make_batch(toks, "cpu"))
            per_step.append((_flat_np(convert.tree_from_numpy(jg, "cpu")),
                             _flat_np(tg)))
            jt, jopt, _ = step_fn(frozen, jt, jopt, jb)
        grads.append(per_step)
    return tr, ttr, data, jout, tout, grads


def test_client_update_uplink_matches_jax(round_pair):
    _, _, _, jout, tout, grads = round_pair
    kw_lr, eps = 1e-3, 1e-8       # the trainer's lr, Adam's eps
    for (jd, jbytes, jloss, jsteps, jn), (td, tbytes, tloss, tsteps, tn), \
            per_step in zip(jout, tout, grads):
        # before Adam: the same gradients at the same parameters
        for jg, tg in per_step:
            for path, w in jg.items():
                np.testing.assert_allclose(
                    tg[path], w, rtol=0,
                    atol=1e-5 * max(1e-30, float(np.abs(w).max())),
                    err_msg=f"grad {path}")
        assert tbytes == jbytes == jq.tree_bytes(jd) == qlib.tree_bytes(td)
        assert (tsteps, tn) == (jsteps, jn) == (2, 8)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
        # the LoRA factors are quantized on the uplink too
        assert isinstance(td["lora"]["wq"]["a"], qlib.QTensor)
        assert td["lora"]["wq"]["a"].bits == 8
        got = _flat_np(qlib.dequantize_tree(td, torch.float32))
        want = _flat_np(convert.tree_from_numpy(
            jq.dequantize_tree(jd, np.float32), "cpu"))
        steps = {}
        for path, leaf in tree_lib.flatten_with_path(
                convert.tree_from_numpy(jd, "cpu")):
            steps[path] = float(leaf.scales.max()) if isinstance(
                leaf, qlib.QTensor) else 0.0
        for path, w in want.items():
            err = np.abs(got[path] - w)
            tol = steps[path] + 1e-6 * max(1.0, float(np.abs(w).max()))
            # Adam divides each grad by its own magnitude: where a grad
            # sits near eps (the adapter's wq/wk at the second step,
            # behind wo's first update; w1 before the zero-init w2 has
            # moved) the fp32 noise of the step before, carried in the
            # parameters, moves the update by up to its whole range.
            # Those elements are held only to the range of 2 steps'
            # updates; the rest to one int8 step
            well = np.ones(w.shape, bool)
            for jg, _ in per_step:
                well &= (np.abs(jg[path]) >= 100 * eps) | (jg[path] == 0)
            # the one-step bound holds most of every leaf (97.5% or more
            # here), so it cannot pass by holding nothing
            assert well.mean() >= 0.9, (path, well.mean())
            assert (err > tol)[well].mean() <= 1e-3, path
            assert err.max() <= 2 * kw_lr * 2 + tol, path


def test_aggregate_matches_jax(round_pair):
    jtr, ttr, data, jout, _, _ = round_pair
    # the same quantized deltas into both aggregators
    jup = [(len(data[c]), jout[c][0]) for c in range(2)]
    tup = [(m, convert.tree_from_numpy(d, "cpu")) for m, d in jup]
    want = _flat_np(convert.tree_from_numpy(jtrain.aggregate(jtr, jup),
                                            "cpu"))
    got = _flat_np(train.aggregate(ttr, tup))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))


def test_two_rounds_reduce_the_clients_loss():
    """tests/test_system.py::test_federated_llm_round_on_assigned_arch on
    the port, with its own seeded init."""
    cfg = get_reduced("yi-9b").replace(**NF4)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    frozen, tr = params["frozen"], params["trainable"]
    data = train.synthetic_token_stream(np.random.RandomState(0),
                                        cfg.vocab_size, 2, seq=48)
    losses = []
    for rnd in range(2):
        updates = []
        for c in range(2):
            d, _, loss, n_steps, n_samples = train.client_update(
                model, frozen, tr, data[c], steps=8, batch=8, lr=5e-3,
                comm_bits=8, seed=rnd * 10 + c)
            assert n_steps == 8 and n_samples == 64
            updates.append((len(data[c]), d))
            losses.append(loss)
        tr = train.aggregate(tr, updates)
    assert np.mean(losses[-2:]) < np.mean(losses[:2])


def test_main_runs_on_the_cpu_and_refuses_ckpt(capsys, tmp_path):
    """The CLI runs on the CPU; ``--ckpt`` (no longer refused) saves the
    server state after the round (resume: tests/test_torch_ckpt_pipeline.py)."""
    ck = str(tmp_path / "x.ckpt")
    tr = train.main(["--rounds", "1", "--clients", "2", "--local-steps",
                     "1", "--seq", "16", "--ckpt", ck], device="cpu")
    out = capsys.readouterr().out
    assert "arch=yi-9b-reduced family=dense" in out and "round 0:" in out
    assert isinstance(tr["lora"]["wq"]["a"], torch.Tensor)
    assert os.path.exists(ck) and os.path.exists(ck + ".json")
