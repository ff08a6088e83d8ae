"""The port's serving plane (repro_torch.fl.serve) against the JAX
package's (repro.fl.serve) over the same backing trees: per-user trees
from ``repro.fl.client.init_trainable`` plus a seeded numpy perturbation
(no training), mixed adapter-only and LoRA families, and at-rest
quantization at 0, 4 and 8 bits. Logits agree to 1e-4; store counts,
bytes at rest, flight schedules and virtual latencies are equal."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import clip as jclip
from repro.data import synthetic as jsynth
from repro.fl import client as jclient
from repro.fl import runtime as jruntime
from repro.fl import serve as jserve
from repro.fl.serve import engine as jengine
from repro.fl.serve import store as jstore
from repro.fl.strategies import STRATEGIES as JSTRATEGIES
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import clip as tclip
from repro_torch.core import quant as tq
from repro_torch.fl import client as tclient
from repro_torch.fl import runtime as truntime
from repro_torch.fl import serve as tserve
from repro_torch.fl.serve import engine as tengine
from repro_torch.fl.serve import store as tstore
from repro_torch.fl.strategies import STRATEGIES

torch.set_num_threads(1)
N_USERS = 6
CFG = jclip.CLIPConfig()
UIDS = [0, 3, 1, 4, 2, 5, 0, 3, 5, 1]


@pytest.fixture(scope="module")
def plane():
    frozen_j = jclip.init_clip(jax.random.PRNGKey(0), CFG)
    toks = jsynth.class_tokens(jsynth.SPECS["pacs"], np.arange(7))
    ce_j = jclip.text_embedding(frozen_j, CFG, jnp.asarray(toks))
    rs = np.random.RandomState(0)
    backing_np = {}
    for uid in range(N_USERS):
        arm = "fedclip" if uid < N_USERS // 2 else "qlora_nogan"
        tr = jclient.init_trainable(jax.random.PRNGKey(uid + 1), CFG,
                                    JSTRATEGIES[arm])
        backing_np[uid] = jax.tree.map(
            lambda l: (np.asarray(l) + 0.05 * rs.randn(*np.shape(l)))
            .astype(np.float32), tr)
    return {"frozen_j": frozen_j, "ce_j": ce_j,
            "frozen_t": convert.tree_from_numpy(frozen_j, "cpu"),
            "ce_t": torch.tensor(np.asarray(ce_j)),
            "backing_np": backing_np,
            "backing_j": {u: jax.tree.map(jnp.asarray, t)
                          for u, t in backing_np.items()},
            "images": rs.uniform(-1, 1, (16, 32, 32, 3)).astype(np.float32)}


def _engines(plane, *, quant_bits, max_entries=4, max_batch=4):
    sj = jstore.AdapterStore(plane["backing_j"], max_entries=max_entries,
                             quant_bits=quant_bits,
                             runtime=jruntime.ProgramRuntime())
    ej = jengine.ServeEngine(frozen=plane["frozen_j"], ccfg=CFG,
                             class_emb=plane["ce_j"], store=sj,
                             cfg=jengine.ServeConfig(max_batch=max_batch))
    st = tstore.AdapterStore(plane["backing_np"], max_entries=max_entries,
                             quant_bits=quant_bits, device="cpu")
    et = tengine.ServeEngine(frozen=plane["frozen_t"], ccfg=CFG,
                             class_emb=plane["ce_t"], store=st,
                             cfg=tengine.ServeConfig(max_batch=max_batch))
    return ej, et


def _requests(plane, uids, seed=0):
    rs = np.random.RandomState(seed)
    pool = plane["images"]
    return [(int(u), pool[rs.randint(0, len(pool))]) for u in uids]


def _counts(stats):
    return {k: stats[k] for k in ("hits", "misses", "evictions",
                                  "resident", "families")}


@pytest.mark.parametrize("quant_bits", [0, 4, 8])
def test_engine_matches_jax(plane, quant_bits):
    ej, et = _engines(plane, quant_bits=quant_bits)
    reqs = _requests(plane, UIDS, seed=1)
    out_j, info_j = ej.serve(reqs)
    out_t, info_t = et.serve(reqs)
    assert out_t.shape == out_j.shape == (len(reqs), 7)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-4)
    assert info_t == info_j
    assert _counts(et.store.stats()) == _counts(ej.store.stats())
    assert et.store.stats()["evictions"] > 0
    assert et.store.bytes_at_rest() == ej.store.bytes_at_rest()
    assert et.n_dispatches == ej.n_dispatches < et.n_requests


def test_replay_matches_jax(plane):
    trace_j = jserve.zipf_request_trace(N_USERS, 18, seed=4, rate=300.0,
                                        period=1.0, amplitude=0.5)
    trace_t = tserve.zipf_request_trace(N_USERS, 18, seed=4, rate=300.0,
                                        period=1.0, amplitude=0.5)
    np.testing.assert_array_equal(trace_t.uid, trace_j.uid)
    np.testing.assert_array_equal(trace_t.t, trace_j.t)
    images = plane["images"][np.random.RandomState(4).randint(0, 16, 18)]
    ej, et = _engines(plane, quant_bits=8)
    rj = jserve.replay(ej, trace_j, images)
    rt = tserve.replay(et, trace_t, images)
    assert rt["n_flights"] == rj["n_flights"]
    for key in ("n", "bucket", "groups", "start_v"):
        assert [f[key] for f in rt["flights"]] == \
            [f[key] for f in rj["flights"]]
    np.testing.assert_array_equal(rt["lat_v"], rj["lat_v"])
    assert rt["store"] == rj["store"]
    np.testing.assert_allclose(rt["logits"], rj["logits"], rtol=0, atol=1e-4)


def test_serve_sequential_matches_jax_and_the_unquantized_plane(plane):
    reqs = _requests(plane, [5, 0, 2, 4, 3], seed=2)
    seq_j = jengine.serve_sequential(plane["frozen_j"], CFG, plane["ce_j"],
                                     plane["backing_j"], reqs)
    seq_t = tengine.serve_sequential(plane["frozen_t"], CFG, plane["ce_t"],
                                     plane["backing_np"], reqs, device="cpu")
    np.testing.assert_allclose(seq_t, seq_j, rtol=0, atol=1e-4)
    # the S=1 closed-form head is an exact rewrite: fp noise only
    _, et = _engines(plane, quant_bits=0)
    out, _ = et.serve(reqs)
    np.testing.assert_allclose(out, seq_t, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_at_rest_bitwise(plane, bits):
    for uid in (0, N_USERS - 1):
        qj = jstore.quantize_at_rest(plane["backing_j"][uid], bits=bits)
        qt = tstore.quantize_at_rest(
            convert.tree_from_numpy(plane["backing_np"][uid], "cpu"),
            bits=bits)
        qj_t = convert.tree_from_numpy(qj, "cpu")
        for (pt, lt), (pj, lj) in zip(tree_lib.flatten_with_path(qt),
                                      tree_lib.flatten_with_path(qj_t)):
            assert pt == pj and type(lt) is type(lj)
            if isinstance(lt, tq.QTensor):
                assert torch.equal(lt.q, lj.q)
                assert torch.equal(lt.scales, lj.scales)
                assert (lt.bits, lt.block) == (lj.bits, lj.block)
            else:
                assert torch.equal(lt, lj)         # biases, LoRA stay fp
        assert tq.tree_bytes(qt) == tq.tree_bytes(qj_t)


def test_entry_points_raise_without_a_gpu(plane, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclip.init_clip(gen, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclient.init_trainable(gen, CFG, STRATEGIES["fedclip"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstore.AdapterStore(plane["backing_np"], max_entries=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.serve_sequential(plane["frozen_t"], CFG, plane["ce_t"],
                                 plane["backing_np"],
                                 _requests(plane, [0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tree_from_numpy({"w": np.zeros(2)})


def test_bad_configs_rejected(plane):
    with pytest.raises(ValueError, match="max_entries"):
        tstore.AdapterStore(plane["backing_np"], max_entries=0, device="cpu")
    with pytest.raises(ValueError, match="quant_bits"):
        tstore.AdapterStore(plane["backing_np"], max_entries=2,
                            quant_bits=3, device="cpu")
    store = tstore.AdapterStore(plane["backing_np"], max_entries=2,
                                device="cpu")
    with pytest.raises(ValueError, match="max_entries"):
        tengine.ServeEngine(frozen=plane["frozen_t"], ccfg=CFG,
                            class_emb=plane["ce_t"], store=store,
                            cfg=tengine.ServeConfig(max_batch=4))
    with pytest.raises(KeyError, match="no trained adapter"):
        store.fetch(N_USERS + 7)


def test_lru_order_and_refresh(plane):
    s = tstore.AdapterStore(plane["backing_np"], max_entries=3,
                            device="cpu")
    for u in (0, 1, 2):
        s.fetch(u)
    assert s.resident() == (0, 1, 2)
    s.fetch(0)                       # hit: 0 becomes MRU
    assert s.resident() == (1, 2, 0)
    s.fetch(3)                       # evicts 1 (global LRU)
    assert 1 not in s.resident() and s.resident()[-1] == 3
    # a refreshed resident holds bitwise what evict + refetch produces
    new = jax.tree.map(lambda l: l * 2, plane["backing_np"][0])
    assert s.refresh({0: new}) == 1
    famk, slot = s._res[0]
    fresh = tstore.AdapterStore({0: new}, max_entries=1, device="cpu")
    fk, fslot = fresh.fetch(0)
    pick = torch.tensor([slot])
    for a, b in zip(tree_lib.leaves(tstore.take_rows(s.family(famk)["slabs"],
                                                     pick)),
                    tree_lib.leaves(tstore.take_rows(
                        fresh.family(fk)["slabs"], torch.tensor([fslot])))):
        if isinstance(a, tq.QTensor):
            assert torch.equal(a.q, b.q) and torch.equal(a.scales, b.scales)
        else:
            assert torch.equal(a, b)


def test_request_size_sweep_reuses_one_serve_program(plane):
    rt = truntime.ProgramRuntime()
    store = tstore.AdapterStore(plane["backing_np"], max_entries=N_USERS,
                                runtime=rt, device="cpu")
    eng = tengine.ServeEngine(frozen=plane["frozen_t"], ccfg=CFG,
                              class_emb=plane["ce_t"], store=store,
                              cfg=tengine.ServeConfig(max_batch=4))
    for r in (2, 3, 4):              # all bucket to width 4
        eng.serve(_requests(plane, [0, 1, 2, 0][:r], seed=r))
    st = rt.stats()[tengine.SERVE_KIND]
    assert st["n_compiles"] == 1
    assert st["n_groups"] == 3 and st["n_requests"] == 9


def test_trace_json_roundtrip(tmp_path):
    tr = tserve.zipf_request_trace(5, 12, seed=9)
    p = tmp_path / "trace.json"
    tserve.save_request_trace(tr, p)
    back = tserve.load_request_trace(p)
    np.testing.assert_array_equal(tr.uid, back.uid)
    np.testing.assert_allclose(tr.t, back.t)
    assert back.n_users == 5 and back.name == tr.name
    with pytest.raises(ValueError, match="nondecreasing"):
        tserve.RequestTrace(uid=np.asarray([0, 1]),
                            t=np.asarray([1.0, 0.5]), n_users=2)
