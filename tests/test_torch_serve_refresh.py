"""The trainer-to-store handoff of the port's serving plane
(``AdapterStore.refresh_from_global``, ``__len__``, ``hit_rate``,
``run_federated(serve_store=)``) against the JAX package's, on the CPU.

Held bitwise: the rebased backing against the JAX store's from the same
numpy backing and globals, a refreshed resident's slab rows against a
cold store's fetch of the same tree (an evict-and-refetch), the
snapshot against later changes of the global passed in, and the store's
ledger over one fetch sequence. ``run_federated`` (fedclip,
sync-partial, K = 2, 3 rounds, both loop modes) refreshes the store
every committed round after the first, leaves the History bitwise what
it is without the store, and ends with the JAX package's backing
within 1e-5 relative in norm over each user's tree (every element at
the whole-round leaf tolerance), on the JAX package's backbone and
draws (``tests/_jax_sched_stream.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_sched_stream import LEAF_ATOL, jax_config, port_on_jax_backbone
from repro.core import clip as jclip
from repro.fl import client as jclient
from repro.fl import runtime as jruntime
from repro.fl import simulator as jsim
from repro.fl.serve import store as jstore
from repro.fl.strategies import STRATEGIES as JSTRATEGIES
from repro_torch import tree as tree_lib
from repro_torch.core import quant as tq
from repro_torch.fl import simulator as tsim
from repro_torch.fl.serve import store as tstore

torch.set_num_threads(2)
SIM = dict(dataset="pacs", strategy="fedclip", n_clients=4, rounds=3,
           local_steps=3, n_per_class=12, batch_size=8, lr=3e-3,
           participation="sync-partial", clients_per_round=2)
BACKED = 3


def _tiny_backing(n=3, seed=0):
    """``tests/test_pipeline.py``'s backing as numpy: (64, 32) weights and
    (32,) biases."""
    rs = np.random.RandomState(seed)
    return {i: {"w": rs.randn(64, 32).astype(np.float32),
                "b": rs.randn(32).astype(np.float32)} for i in range(n)}


def _np_tree(tree):
    return {tree_lib.path_str(p): np.asarray(
        l.numpy() if isinstance(l, torch.Tensor) else l)
        for p, l in tree_lib.flatten_with_path(tree)}


def _stores(back, **kw):
    j = jstore.AdapterStore({u: jax.tree.map(jnp.asarray, t)
                             for u, t in back.items()},
                            runtime=jruntime.ProgramRuntime(), **kw)
    t = tstore.AdapterStore(dict(back), device="cpu", **kw)
    return j, t


def _rows(store, uid):
    """The slab rows of ``uid`` (fetched), payloads and scales apart."""
    famk, slot = store.fetch(uid)
    out = []
    for l in tree_lib.leaves(tstore.take_rows(store.family(famk)["slabs"],
                                              torch.tensor([slot]))):
        out += [l.q, l.scales] if isinstance(l, tq.QTensor) else [l]
    return [t.numpy() for t in out]


@pytest.mark.parametrize("quant_bits", [0, 8])
def test_refresh_from_global_rebases_bitwise_as_jax(quant_bits):
    back = _tiny_backing()
    js, ts = _stores(back, max_entries=2, quant_bits=quant_bits)
    for s in (js, ts):
        s.fetch(2)
        s.fetch(0)
    rs = np.random.RandomState(1)
    g0 = {"w": rs.randn(64, 32).astype(np.float32),
          "b": rs.randn(32).astype(np.float32)}
    g1 = {k: (v + rs.randn(*v.shape).astype(np.float32) * 0.1)
          for k, v in g0.items()}
    assert js.refresh_from_global(jax.tree.map(jnp.asarray, g0)) == 0
    assert ts.refresh_from_global(
        {k: torch.tensor(v) for k, v in g0.items()}) == 0
    assert ts.stats()["refreshes"] == 0
    nj = js.refresh_from_global(jax.tree.map(jnp.asarray, g1))
    nt = ts.refresh_from_global({k: torch.tensor(v) for k, v in g1.items()})
    assert nt == nj == 2
    for uid in back:
        got, want = _np_tree(ts.backing[uid]), _np_tree(js.backing[uid])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            # the reference's order of operations: old + (new - base)
            np.testing.assert_array_equal(
                got[k], back[uid][k] + (g1[k] - g0[k]))
    assert ts.stats() == js.stats()
    assert ts.bytes_at_rest() == js.bytes_at_rest()


def test_refreshed_rows_are_an_evict_and_refetch():
    """A refreshed resident's slab rows are bitwise what a cold store
    quantizes the rebased tree to (the JAX package's
    ``test_store_refresh_matches_evict_and_refetch``, through the
    rebase)."""
    back = _tiny_backing()
    store = tstore.AdapterStore(dict(back), max_entries=3, quant_bits=8,
                                device="cpu")
    for uid in back:
        store.fetch(uid)
    g0 = {"w": torch.zeros(64, 32), "b": torch.zeros(32)}
    store.refresh_from_global(g0)
    n = store.refresh_from_global({"w": g0["w"] + 0.25,
                                   "b": g0["b"] - 0.5})
    assert n == 3 and store.stats()["refreshed_resident"] == 3
    for uid in back:
        cold = tstore.AdapterStore({uid: store.backing[uid]}, max_entries=1,
                                   quant_bits=8, device="cpu")
        for a, b in zip(_rows(store, uid), _rows(cold, uid)):
            np.testing.assert_array_equal(a, b)
    assert store.resident() == (0, 1, 2)       # fetched in order again


def test_snapshot_is_a_copy_of_the_global():
    back = _tiny_backing()
    store = tstore.AdapterStore(dict(back), max_entries=2, quant_bits=0,
                                device="cpu")
    g = {"w": torch.zeros(64, 32), "b": torch.zeros(32)}
    store.refresh_from_global(g)
    g["w"] += 1.0                              # the caller reuses its tensor
    g["b"].add_(2.0)
    assert float(store._base["w"].abs().max()) == 0.0
    assert float(store._base["b"].abs().max()) == 0.0
    store.refresh_from_global(g)
    for uid in back:
        np.testing.assert_array_equal(store.backing[uid]["w"].numpy(),
                                      back[uid]["w"] + np.float32(1.0))
        np.testing.assert_array_equal(store.backing[uid]["b"].numpy(),
                                      back[uid]["b"] + np.float32(2.0))


def test_len_hit_rate_and_stats_match_jax():
    back = _tiny_backing(4)
    js, ts = _stores(back, max_entries=2, quant_bits=8)
    assert len(ts) == len(js) == 0
    assert ts.hit_rate() == js.hit_rate() == 0.0
    for uid in (0, 1, 0, 2, 3, 3, 1, 0, 2):
        js.fetch(uid)
        ts.fetch(uid)
        assert len(ts) == len(js)
        assert ts.hit_rate() == js.hit_rate()
        assert ts.stats() == js.stats()
        assert ts.resident() == js.resident()
    assert ts.stats()["evictions"] > 0 and 0 < ts.hit_rate() < 1


def _assert_close(got, want):
    """A tree after whole rounds against the JAX package's: within 1e-5
    relative in norm over the tree, and every element within the
    whole-round leaf tolerance (``tests/_jax_sched_stream.LEAF_ATOL``;
    Adam moves an element whose gradient is fp32 noise by about lr, so a
    leaf is not held elementwise to 1e-5 of its largest value)."""
    assert got.keys() == want.keys()
    diff = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2.0) for k in want))
    norm = np.sqrt(sum(np.sum(want[k] ** 2.0) for k in want))
    assert diff <= 1e-5 * norm, (diff, norm)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=LEAF_ATOL, rtol=0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def fedclip_backing():
    ccfg = jclip.CLIPConfig()
    return {i: jax.tree.map(np.array, jclient.init_trainable(
        jax.random.PRNGKey(100 + i), ccfg, JSTRATEGIES["fedclip"]))
        for i in range(BACKED)}


@pytest.fixture(scope="module")
def jax_run(fedclip_backing):
    """The JAX package's run with a store (pipelined) and its backing."""
    store = jstore.AdapterStore(
        {u: jax.tree.map(jnp.asarray, t) for u, t in fedclip_backing.items()},
        max_entries=2, quant_bits=0)
    h = jsim.run_federated(jax_config(**SIM), serve_store=store)
    return h, store


@pytest.mark.parametrize("pipeline", ["pipelined", "barrier"])
def test_run_federated_refreshes_serve_store(fedclip_backing, jax_run,
                                             pipeline):
    want_h, want_store = jax_run
    assert want_h.meta["serve_refreshes"] == (SIM["rounds"] - 1) * BACKED
    cfg = dict(SIM, pipeline=pipeline)
    # two residents, int8 at rest: their slots are rewritten every round
    store = tstore.AdapterStore(dict(fedclip_backing), max_entries=2,
                                quant_bits=8, device="cpu")
    store.fetch(0)
    store.fetch(2)
    with_store = port_on_jax_backbone(jax_config(**cfg),
                                      serve_store=store, **cfg)
    without = port_on_jax_backbone(jax_config(**cfg), **cfg)
    assert with_store.meta["serve_refreshes"] == \
        (SIM["rounds"] - 1) * BACKED
    assert store.stats()["refreshed_resident"] == (SIM["rounds"] - 1) * 2
    for f in dataclasses.fields(tsim.History):
        if f.name not in ("round_time_s", "meta"):
            assert getattr(with_store, f.name) == getattr(without, f.name), \
                f.name
    assert with_store.meta["sync_counts"] == without.meta["sync_counts"]
    assert set(with_store.meta) == set(want_h.meta)
    for uid in fedclip_backing:
        got, want = _np_tree(store.backing[uid]), \
            _np_tree(want_store.backing[uid])
        _assert_close(got, want)
        if uid in (0, 2):
            cold = tstore.AdapterStore({uid: store.backing[uid]},
                                       max_entries=1, quant_bits=8,
                                       device="cpu")
            for a, b in zip(_rows(store, uid), _rows(cold, uid)):
                np.testing.assert_array_equal(a, b)
