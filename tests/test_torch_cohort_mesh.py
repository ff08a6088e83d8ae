"""The port's mesh-sharded cohort engine and fleet GAN
(``CohortConfig.mesh``, ``FleetGANConfig.mesh``) on gloo worlds, against
the JAX package's *unsharded* engine and the port's own unsharded one.

One world of 8 ranks (``_torch_dist_worker.cohort_mesh``):

- the cohort engine on a mesh ``(data=4, model=2)``, 4 data-parallel
  shards of an 8-client ``qlora_nogan`` cohort (the JAX tests' reduced
  CLIP): a full round and two subset rounds (K = 2 buckets to the shard
  multiple 4, K = 5 to 8), the JAX package's batch indices injected.
  Against the port's unsharded engine: leaves within 1e-5, losses within
  1e-4, uplink bytes equal, the selection equal; against the JAX
  unsharded engine at the port's oracle tolerances (leaves atol 5e-4,
  loss atol 1e-3 / rtol 1e-4, accuracy 1e-5: two frameworks' fp32
  rounding through Adam, tests/_jax_sched_stream.py), bytes equal. The
  JAX package's own sharded-round test fails in the JAX package (ROADMAP
  Queue C), so nothing here depends on it;
- the fleet GAN on the same 4 data shards (5 clients pad to 8: three
  rider rows, two rows a shard), 4 steps, bitwise the unsharded fleet:
  every client's trained leaves, synthesized images and labels (a shard
  of one row would not be: on the CPU a batched product of one matrix
  with one column takes MKL's single-matrix path, which sums in another
  order);
- the host draws (selections, batch indices, GAN inits and noise) are
  bitwise the same at world sizes 1 (here), 2, 4 and 8.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_sched_stream import (ACC_ATOL, LOSS_ATOL, LOSS_RTOL,
                               assert_trees)
from _torch_dist_worker import _draws_digest, spawn
from repro.core import clip as jclip
from repro.data import synthetic as jsynth
from repro.fl import client as jclient
from repro.fl import cohort as jcohort
from repro.fl import partition as jpartition
from repro.fl.strategies import STRATEGIES as JSTRATEGIES
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import clip as tclip

torch.set_num_threads(1)
N_CLIENTS, STEPS, BATCH = 8, 2, 8
ROUNDS = [("full", None, (3, 0)), ("subset2", [1, 4], (3, 1)),
          ("subset5", [0, 2, 4, 6, 7], (3, 2))]


def _fold(path):
    k = jax.random.PRNGKey(0)
    for t in path:
        k = jax.random.fold_in(k, t)
    return k


@functools.lru_cache(maxsize=None)
def _world():
    strat = JSTRATEGIES["qlora_nogan"]
    ccfg = jclip.CLIPConfig()
    frozen = jclip.init_clip(jax.random.PRNGKey(3), ccfg)
    data = jsynth.make_dataset("pacs", n_per_class=16, seed=0,
                               longtail_gamma=2.0)
    spec = data["spec"]
    class_emb = jclip.text_embedding(frozen, ccfg, jnp.asarray(
        jsynth.class_tokens(spec, np.arange(spec.n_classes))))
    parts = jpartition.dirichlet_partition(data["labels"], N_CLIENTS, 1.0,
                                           seed=0)
    pools = [(data["images"][p], data["labels"][p]) for p in parts]
    clients = [jclient.Client(cid=i, images=im, labels=lb,
                              n_classes=spec.n_classes, strategy=strat)
               for i, (im, lb) in enumerate(pools)]
    tr = jclient.init_trainable(jax.random.PRNGKey(1), ccfg, strat)
    eng = jcohort.CohortEngine(
        frozen=frozen, ccfg=ccfg, class_emb=class_emb, clients=clients,
        cfg=jcohort.CohortConfig(strategy=strat, local_steps=STEPS,
                                 batch_size=BATCH, lr=3e-3, donate=False))
    lens = np.asarray([len(c.pool()[1]) for c in clients])
    want, indices = {}, {}
    for label, sel, path in ROUNDS:
        key = _fold(path)
        if sel is None:
            want[label] = eng.run_round(tr, key)
            idx = jcohort.round_indices(key, lens, STEPS, BATCH)
        else:
            want[label] = eng.run_subset_round(tr, sel, key)
            idx = jcohort.round_indices(key, lens[np.sort(sel)],
                                        eng.max_steps, BATCH)
        indices[path] = np.asarray(idx)
    inp = {"cohort": dict(
        arm="qlora_nogan", n_classes=spec.n_classes, data=pools,
        frozen=convert.tree_from_numpy(frozen, "cpu"), ccfg=tclip.CLIPConfig(),
        class_emb=torch.from_numpy(np.array(class_emb)),
        steps=STEPS, rounds=ROUNDS, indices=indices)}
    inp["cohort"]["global"] = convert.tree_from_numpy(tr, "cpu")
    rs = np.random.RandomState(0)
    inp["fleet"] = dict(steps=4, data=[
        (rs.rand(n, 32, 32, 3).astype(np.float32),
         (np.arange(n) % 3).astype(np.int32))
        for n in (40, 21, 12, 9, 5)])
    res = spawn("cohort_mesh", 8, inp, timeout=400)
    return want, res


@pytest.fixture(scope="module")
def world():
    return _world()


def _leaves(tree):
    return [l.detach().numpy() if isinstance(l, torch.Tensor)
            else np.asarray(l) for l in tree_lib.leaves(tree)]


def test_engine_splits_the_cohort_over_the_data_shards(world):
    _, res = world
    for r in res:
        assert r["local"]["shards"] == 1 and r["mesh"]["shards"] == 4
        assert r["local"]["rows"] == N_CLIENTS
        assert r["mesh"]["rows"] == N_CLIENTS // 4


@pytest.mark.parametrize("label", [r[0] for r in ROUNDS])
def test_sharded_round_matches_the_unsharded_engines(world, label):
    want, res = world
    wt, wm = want[label]
    for r in res:
        (tm, mm), (tl, ml) = r["mesh"][label], r["local"][label]
        for a, b in zip(_leaves(tm), _leaves(tl)):
            assert float(np.abs(a - b).max()) <= 1e-5
        assert float((mm["loss"] - ml["loss"]).abs().max()) <= 1e-4
        assert mm["uplink_bytes"] == ml["uplink_bytes"] == wm["uplink_bytes"]
        if "sel" in wm:
            assert list(mm["sel"]) == list(np.asarray(wm["sel"]))
        assert_trees(tm, wt)
        for k, kw in (("loss", dict(atol=LOSS_ATOL, rtol=LOSS_RTOL)),
                      ("acc", dict(atol=ACC_ATOL))):
            np.testing.assert_allclose(mm[k].numpy(), np.asarray(wm[k]),
                                       **kw)
        # every rank ends the round with the same global trainables
        for a, b in zip(_leaves(tm), _leaves(res[0]["mesh"][label][0])):
            np.testing.assert_array_equal(a, b)


def test_sharded_fleet_gan_is_bitwise_the_unsharded_fleet(world):
    _, res = world
    for r in res:
        lo, me = r["fleet_local"], r["fleet_mesh"]
        assert lo["n_eligible"] == me["n_eligible"] == 4
        assert lo["n_synth"] == me["n_synth"] > 0
        assert lo["groups"] == me["groups"]     # the true width, not padded
        for pa, pb in zip(lo["params"], me["params"]):
            assert (pa is None) == (pb is None)  # the rider stays untouched
            if pa is not None:
                for a, b in zip(pa, pb):
                    assert torch.equal(a, b)
        for a, b in zip(lo["images"] + lo["labels"],
                        me["images"] + me["labels"]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world_size", [1, 2, 4, 8])
def test_host_draws_are_bitwise_the_same_at_every_world_size(world,
                                                             world_size):
    _, res = world
    here = _draws_digest()
    if world_size == 8:
        got = [r["digest"] for r in res]
    elif world_size == 1:
        got = [here]
    else:
        got = [r["digest"] for r in spawn("draws", world_size,
                                          timeout=120)]
    assert got == [here] * world_size
