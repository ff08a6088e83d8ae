"""The JAX package's keyed draws as the port's, shared by the port's
scheduler and simulator tests (a helper module, not collected).

A port ``RoundKey`` names a key by the ``fold_in`` tags from a root key
(``run_federated``'s root is ``PRNGKey(seed)``: the warm-up key
``(4,)``, round r's ``(3, r)``, the chaos key ``(5,)``). ``JaxDraws``
rebuilds that key and draws from it as the JAX package does: batch
indices with ``cohort.round_indices``, selections with
``jax.random.choice(..., replace=False, p=...)`` (``p`` as the float32
``jnp.asarray`` the JAX scheduler passes), and ``jax.random.uniform`` /
``normal`` vectors. ``jax_streams(cfg)`` is the whole run's draws as a
port ``Streams``; ``on_jax_backbone`` runs both packages with the port on
the JAX package's pretrained CLIP. ``fl_setup`` builds the JAX tests'
small FL instance in both packages, and the ``assert_*`` helpers hold
the port's results to the JAX package's at the oracle tolerances
(leaves atol 5e-4, loss atol 1e-3 / rtol 1e-4, accuracy 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _jax_gan_stream import JaxGANStream
from repro.core import clip as jclip
from repro.data import synthetic as jsynth
from repro.fl import client as jclient
from repro.fl import cohort as jcohort
from repro.fl import partition as jpartition
from repro.fl import sched as jsched
from repro.fl import simulator as jsim
from repro.fl.strategies import GAN_RNG_OFFSET
from repro.fl.strategies import STRATEGIES as JSTRATEGIES
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import clip as tclip
from repro_torch.core import gan as tgan
from repro_torch.fl import client as tclient
from repro_torch.fl import cohort as tcohort
from repro_torch.fl import sched as tsched
from repro_torch.fl import simulator as tsim

LEAF_ATOL, LOSS_ATOL, LOSS_RTOL, ACC_ATOL = 5e-4, 1e-3, 1e-4, 1e-5
# the two leaves behind the adapter's ReLU: a pre-activation within fp32
# rounding of zero takes the ReLU the other way in the other framework,
# moving its unit's column of w1 (and entry of b1) by about lr at that
# step; over chained commits that can exceed LEAF_ATOL at an element, so
# these leaves are held in norm to GATED_REL of their own update (as
# chip_smoke.round_diffs holds them)
RELU_GATED, GATED_REL = ("adapter/w1", "adapter/b1"), 1e-1


class JaxDraws:
    def __init__(self, root):
        self.root = root

    def key(self, path):
        k = self.root
        for t in path:
            k = jax.random.fold_in(k, int(t))
        return k

    def batch_indices(self, path, lens, steps, batch):
        return jcohort.round_indices(self.key(path), lens, steps, batch)

    def choice(self, path, n, k, p):
        return np.asarray(jax.random.choice(self.key(path), n, (k,),
                                            replace=False,
                                            p=jnp.asarray(p)))

    def uniform(self, path, n):
        return np.asarray(jax.random.uniform(self.key(path), (n,)))

    def normal(self, path, n):
        return np.asarray(jax.random.normal(self.key(path), (n,)))


def jax_streams(cfg):
    """The JAX package's draws for ``cfg`` (a port or JAX ``FLConfig``)
    as port ``Streams``: the CLIP init ``init_clip(PRNGKey(1234))``, the
    trainables ``init_trainable(fold_in(rng, 2))``, the keyed draws of
    ``rng = PRNGKey(cfg.seed)`` and client i's GAN key
    ``fold_in(rng, GAN_RNG_OFFSET + i)``."""
    rng = jax.random.PRNGKey(cfg.seed)
    d = JaxDraws(rng)
    return tsim.Streams(
        clip_init=jax.tree.map(np.asarray, jclip.init_clip(
            jax.random.PRNGKey(1234), jclip.CLIPConfig())),
        trainable_init=jax.tree.map(np.asarray, jclient.init_trainable(
            jax.random.fold_in(rng, 2), jclip.CLIPConfig(),
            JSTRATEGIES[cfg.strategy])),
        batch_indices=d.batch_indices, choice=d.choice, uniform=d.uniform,
        normal=d.normal,
        gan=lambda i: JaxGANStream(jax.random.fold_in(
            rng, GAN_RNG_OFFSET + i)))


def jax_config(**kw):
    """A JAX ``FLConfig`` from port-style keyword settings (a port
    ``ChaosConfig`` or trace object passes through as its JAX twin's
    fields)."""
    chaos = kw.get("chaos")
    if chaos is not None and not isinstance(chaos, str):
        kw["chaos"] = jsched.ChaosConfig(**dataclasses.asdict(chaos))
    return jsim.FLConfig(**kw)


def on_jax_backbone(runtime=None, **kw):
    """``(want, got)``: the JAX package's run of the settings ``kw`` and
    the port's on the JAX package's draws and pretrained backbone (placed
    in the port's cache under the key its run looks up), so what is left
    is the rounds themselves. ``runtime`` is the JAX run's program
    runtime (share one to share compiles across runs)."""
    jcfg = jax_config(**kw)
    want = jsim.run_federated(jcfg, runtime=runtime)
    return want, port_on_jax_backbone(jcfg, **kw)


def port_on_jax_backbone(jcfg, serve_store=None, **kw):
    """The port's run of ``kw`` (with ``serve_store``) on the JAX draws of
    ``jcfg`` and the JAX package's pretrained backbone."""
    streams = jax_streams(jcfg)
    key = tsim.clip_cache_key(jcfg.dataset, tclip.CLIPConfig(),
                              init=streams.clip_init, device="cpu")
    own = tsim._CLIP_CACHE.get(key)
    tsim._CLIP_CACHE[key] = convert.tree_from_numpy(
        jsim.pretrained_clip(jcfg.dataset, jclip.CLIPConfig()), "cpu")
    try:
        return tsim.run_federated(tsim.FLConfig(**kw), device="cpu",
                                  streams=streams, serve_store=serve_store)
    finally:
        if own is None:
            del tsim._CLIP_CACHE[key]
        else:
            tsim._CLIP_CACHE[key] = own


_SETUPS = {}


def fl_setup(arm, *, n_clients=3, n_per_class=12, steps=4, batch=8,
             lr=3e-3, step_mult=None, force_het=False):
    """``tests/test_sched.py``'s (and with ``n_clients=4, n_per_class=14,
    force_het=True`` ``tests/test_chaos.py``'s) FL instance in both
    packages on the same weights: the JAX engine and executor, the
    port's engine and its sequential executor over shared clients.
    tripleplay's rebalancing rows come from the port's ``prepare_gan``
    (25 steps) and are handed to the JAX clients too, so both engines
    train on the same pools. Cached per argument set."""
    key = (arm, n_clients, n_per_class, steps, batch, lr,
           None if step_mult is None else tuple(step_mult), force_het)
    if key in _SETUPS:
        return _SETUPS[key]
    strat_j, strat_t = JSTRATEGIES[arm], tsim.STRATEGIES[arm]
    ccfg_j, ccfg_t = jclip.CLIPConfig(), tclip.CLIPConfig()
    frozen_j = jclip.init_clip(jax.random.PRNGKey(3), ccfg_j)
    data = jsynth.make_dataset("pacs", n_per_class=n_per_class, seed=0,
                               longtail_gamma=4.0)
    spec = data["spec"]
    class_emb_j = jclip.text_embedding(frozen_j, ccfg_j, jnp.asarray(
        jsynth.class_tokens(spec, np.arange(spec.n_classes))))
    parts = jpartition.dirichlet_partition(data["labels"], n_clients, 0.5,
                                           seed=0)
    mk = lambda lib, strat: [lib.Client(
        cid=i, images=data["images"][p], labels=data["labels"][p],
        n_classes=spec.n_classes, strategy=strat)
        for i, p in enumerate(parts)]
    clients_j, clients_t = mk(jclient, strat_j), mk(tclient, strat_t)
    for cj, ct, m in zip(clients_j, clients_t,
                         step_mult or [1] * n_clients):
        cj.step_mult = ct.step_mult = int(m)
    if strat_t.use_gan:
        for i, (cj, ct) in enumerate(zip(clients_j, clients_t)):
            if ct.n >= 8:
                ct.prepare_gan(tgan.SeededGANStream((0, 100 + i)), steps=25,
                               device="cpu")
                cj.aug_images, cj.aug_labels = ct.aug_images, ct.aug_labels
    global_j = jclient.init_trainable(jax.random.PRNGKey(1), ccfg_j, strat_j)
    frozen_t = convert.tree_from_numpy(frozen_j, "cpu")
    class_emb_t = torch.from_numpy(np.array(class_emb_j))
    eng_j = jcohort.CohortEngine(
        frozen=frozen_j, ccfg=ccfg_j, class_emb=class_emb_j,
        clients=clients_j, cfg=jcohort.CohortConfig(
            strategy=strat_j, local_steps=steps, batch_size=batch, lr=lr,
            donate=False, force_het=force_het))
    eng_t = tcohort.CohortEngine(
        frozen=frozen_t, ccfg=ccfg_t, class_emb=class_emb_t,
        clients=clients_t, cfg=tcohort.CohortConfig(
            strategy=strat_t, local_steps=steps, batch_size=batch, lr=lr,
            force_het=force_het))
    seq = lambda pkg, clients, fz, ce, ccfg: pkg.SequentialExec(
        clients=clients, frozen=fz, ccfg=ccfg, class_emb=ce,
        local_steps=steps, batch_size=batch, lr=lr)
    out = dict(
        clients_j=clients_j, clients_t=clients_t, global_j=global_j,
        global_t=convert.tree_from_numpy(global_j, "cpu"), eng_j=eng_j,
        eng_t=eng_t, cohort_j=jsched.CohortExec(eng_j),
        cohort_t=tsched.CohortExec(eng_t),
        seq_j=seq(jsched, clients_j, frozen_j, class_emb_j, ccfg_j),
        seq_t=seq(tsched, clients_t, frozen_t, class_emb_t, ccfg_t))
    _SETUPS[key] = out
    return out


def keys(seed):
    """The JAX key ``PRNGKey(seed)`` and the port's key for its draws."""
    k = jax.random.PRNGKey(seed)
    return k, tcohort.RoundKey(JaxDraws(k))


def as_numpy(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)


def flat(tree):
    """path -> float64 numpy of a port or JAX tree."""
    if not isinstance(tree_lib.leaves(tree)[0], torch.Tensor):
        tree = jax.tree.map(np.asarray, tree)
    return {tree_lib.path_str(p): as_numpy(l).astype(np.float64)
            for p, l in tree_lib.flatten_with_path(tree)}


def assert_trees(got, want, atol=LEAF_ATOL, exact=False):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in g:
        if exact:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0,
                                       err_msg=k)


def assert_chain(got, want, base):
    """Trees after several chained commits from ``base``: every leaf at
    ``LEAF_ATOL`` elementwise but the ReLU-gated ones, held in norm."""
    g, w, b = flat(got), flat(want), flat(base)
    for k in g:
        if k in RELU_GATED:
            d = np.linalg.norm(g[k] - w[k])
            assert d <= GATED_REL * np.linalg.norm(w[k] - b[k]), (k, d)
        else:
            np.testing.assert_allclose(g[k], w[k], atol=LEAF_ATOL, rtol=0,
                                       err_msg=k)


def assert_metrics(mt, mj):
    """A step's metrics: losses and accuracies at the oracle tolerances,
    uplink bytes and participation equal."""
    np.testing.assert_allclose(np.asarray([float(v) for v in mt["loss"]]),
                               np.asarray(mj["loss"], np.float64),
                               atol=LOSS_ATOL, rtol=LOSS_RTOL)
    np.testing.assert_allclose(np.asarray([float(v) for v in mt["acc"]]),
                               np.asarray(mj["acc"], np.float64),
                               atol=ACC_ATOL)
    assert int(mt["uplink_bytes"]) == int(mj["uplink_bytes"])
    assert list(mt["participation"]) == list(mj["participation"])
