"""The port's demo serving plane (``fl.serve.demo``: ``demo_plane``,
``request_images``; ``personalized_trainables``) and serving CLI
(``launch.serve``) against the JAX package's, on the CPU at the
reference's demo sizes (``CLIPConfig()``, 20 a class, 2 local steps).

The JAX package's draws (``init_clip(PRNGKey(seed))``, the families'
``init_trainable(PRNGKey(seed + 1))`` and the wave's ``PRNGKey(seed + 2)``
batch indices) are injected as ``DemoStreams``. Held: the personalized
trees within 1e-5 relative in norm over each user's tree (every element
at the whole-round leaf tolerance: Adam moves an element whose gradient
is fp32 noise by about lr); replay logits within 1e-5 of the largest
logit unquantized; on the JAX plane's backing at int8 the slab payloads
and scales bitwise and the logits within 1e-5; on each package's own
trained backing the int8 logits within the int8 bound (5e-2), since a
training difference of 1e-6 can move a code by one step; the store's
ledger, ``bytes_at_rest``, the flight schedule and ``request_images``
exactly; the CLI's printed lines (but the ledger's compile times)."""
import ast
import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_sched_stream import LEAF_ATOL, JaxDraws
from repro.core import clip as jclip
from repro.fl import client as jclient
from repro.fl import runtime as jruntime
from repro.fl import serve as jserve
from repro.fl.serve import engine as jengine
from repro.fl.serve import store as jstore
from repro.fl.strategies import STRATEGIES as JSTRATEGIES
from repro.launch import serve as jlaunch
from repro_torch import tree as tree_lib
from repro_torch.core import quant as tq
from repro_torch.fl import cohort as tcohort
from repro_torch.fl import serve as tserve
from repro_torch.fl.serve import store as tstore
from repro_torch.launch import serve as tlaunch

torch.set_num_threads(2)
N_USERS, CAP, SEED = 4, 3, 0
INT8_BOUND = 5e-2


def jax_demo_streams(seed):
    """The JAX package's demo draws as port ``DemoStreams``."""
    ccfg = jclip.CLIPConfig()
    return tserve.DemoStreams(
        clip_init=jax.tree.map(np.asarray, jclip.init_clip(
            jax.random.PRNGKey(seed), ccfg)),
        trainable_init=lambda arm: jax.tree.map(
            np.asarray, jclient.init_trainable(
                jax.random.PRNGKey(seed + 1), ccfg, JSTRATEGIES[arm])),
        wave=tcohort.RoundKey(JaxDraws(jax.random.PRNGKey(seed + 2))))


@pytest.fixture(scope="module")
def planes():
    """``demo_plane(4, mixed=True, max_entries=3)`` in both packages,
    unquantized, the port on the JAX package's draws; and a Zipf trace
    with its images."""
    pj = jserve.demo_plane(N_USERS, mixed=True, max_entries=CAP,
                           quant_bits=0, seed=SEED,
                           runtime=jruntime.ProgramRuntime())
    streams = jax_demo_streams(SEED)
    pt = tserve.demo_plane(N_USERS, mixed=True, max_entries=CAP,
                           quant_bits=0, seed=SEED, device="cpu",
                           streams=streams)
    trace_j = jserve.zipf_request_trace(N_USERS, 16, seed=2, rate=200.0,
                                        period=1.0, amplitude=0.5)
    trace_t = tserve.zipf_request_trace(N_USERS, 16, seed=2, rate=200.0,
                                        period=1.0, amplitude=0.5)
    return {"j": pj, "t": pt, "streams": streams, "trace_j": trace_j,
            "trace_t": trace_t,
            "images": tserve.request_images(pt, trace_t, seed=2)}


def _np_tree(tree):
    return {tree_lib.path_str(p): np.asarray(
        l.numpy() if isinstance(l, torch.Tensor) else l, np.float64)
        for p, l in tree_lib.flatten_with_path(tree)}


def _jax_int8_plane(pj, backing):
    """What the JAX ``demo_plane(..., quant_bits=8)`` builds after its
    training (which does not depend on ``quant_bits``), over ``backing``."""
    store = jstore.AdapterStore({u: jax.tree.map(jnp.asarray, t)
                                 for u, t in backing.items()},
                                max_entries=CAP, quant_bits=8,
                                runtime=jruntime.ProgramRuntime())
    return jengine.ServeEngine(
        frozen=pj["frozen"], ccfg=pj["ccfg"], class_emb=pj["class_emb"],
        store=store, cfg=jengine.ServeConfig(max_batch=CAP))


def _assert_replays(rt, rj, atol):
    assert rt["n_flights"] == rj["n_flights"]
    for key in ("n", "bucket", "groups", "start_v"):
        assert [f[key] for f in rt["flights"]] == \
            [f[key] for f in rj["flights"]]
    np.testing.assert_array_equal(rt["lat_v"], rj["lat_v"])
    assert rt["store"] == rj["store"]
    assert rt["logits"].shape == rj["logits"].shape
    assert np.abs(rt["logits"] - rj["logits"]).max() <= atol


def test_personalized_trainables_match_jax(planes):
    """The planes' backings are ``personalized_trainables`` of one wave
    a family (uids 0-1 fedclip, 2-3 qlora_nogan, LoRA factors int8 on
    the uplink), on the JAX wave key's draws."""
    bj, bt = planes["j"]["backing"], planes["t"]["backing"]
    assert sorted(bt) == sorted(bj) == list(range(N_USERS))
    for uid in bj:
        got, want = _np_tree(bt[uid]), _np_tree(
            jax.tree.map(np.asarray, bj[uid]))
        assert got.keys() == want.keys()
        diff = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
        norm = np.sqrt(sum(np.sum(want[k] ** 2) for k in want))
        assert diff <= 1e-5 * norm, (uid, diff, norm)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=LEAF_ATOL,
                                       rtol=0, err_msg=f"{uid} {k}")
    assert ("lora" in bt[2]) and ("lora" not in bt[0])
    for leaf in tree_lib.leaves(bt[3]):
        assert leaf.dtype == torch.float32


def test_request_images_bitwise(planes):
    want = jserve.request_images(planes["j"], planes["trace_j"], seed=2)
    np.testing.assert_array_equal(planes["images"], want)
    np.testing.assert_array_equal(planes["t"]["images"],
                                  planes["j"]["images"])


def test_demo_plane_replay_matches_jax_unquantized(planes):
    pj, pt = planes["j"], planes["t"]
    assert pt["engine"].cfg.max_batch == pj["engine"].cfg.max_batch == CAP
    assert (pt["n_users"], pt["n_classes"]) == (pj["n_users"],
                                                pj["n_classes"])
    rj = jserve.replay(pj["engine"], planes["trace_j"], planes["images"])
    rt = tserve.replay(pt["engine"], planes["trace_t"], planes["images"])
    _assert_replays(rt, rj, 1e-5 * np.abs(rj["logits"]).max())
    assert rt["store"]["evictions"] > 0
    assert pt["store"].stats() == pj["store"].stats()
    assert pt["store"].bytes_at_rest() == pj["store"].bytes_at_rest()
    assert len(pt["store"]) == len(pj["store"])
    assert pt["store"].hit_rate() == pj["store"].hit_rate()


def test_int8_plane_on_the_jax_backing(planes):
    """Both stores at int8 over the JAX plane's trained backing: each
    user's slab rows bitwise, the replay's logits within 1e-5."""
    pj, pt = planes["j"], planes["t"]
    back = {u: jax.tree.map(np.array, t) for u, t in pj["backing"].items()}
    ej = _jax_int8_plane(pj, back)
    st = tstore.AdapterStore(back, max_entries=CAP, quant_bits=8,
                             device="cpu")
    et = tserve.ServeEngine(frozen=pt["frozen"], ccfg=pt["ccfg"],
                            class_emb=pt["class_emb"], store=st,
                            cfg=tserve.ServeConfig(max_batch=CAP))
    rj = jserve.replay(ej, planes["trace_j"], planes["images"])
    rt = tserve.replay(et, planes["trace_t"], planes["images"])
    _assert_replays(rt, rj, 1e-5 * np.abs(rj["logits"]).max())
    assert st.stats() == ej.store.stats()
    assert st.bytes_at_rest() == ej.store.bytes_at_rest()
    for uid in st.resident():
        famk_t, slot_t = st._res[uid]
        famk_j, slot_j = ej.store._res[uid]
        rows_t = tstore.take_rows(st.family(famk_t)["slabs"],
                                  torch.tensor([slot_t]))
        rows_j = jstore.take_rows(ej.store.family(famk_j)["slabs"],
                                  jnp.asarray([slot_j]))
        leaves_j = jax.tree.leaves(rows_j, is_leaf=lambda l: isinstance(
            l, jstore.qlib.QTensor))
        n_q = 0
        for lt, lj in zip(tree_lib.leaves(rows_t), leaves_j):
            if isinstance(lt, tq.QTensor):
                np.testing.assert_array_equal(lt.q.numpy(), np.asarray(lj.q))
                np.testing.assert_array_equal(lt.scales.numpy(),
                                              np.asarray(lj.scales))
                n_q += 1
            else:
                np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        assert n_q > 0


def test_int8_plane_on_each_packages_backing(planes):
    """``demo_plane(..., quant_bits=8)`` against the JAX package's: the
    logits within the int8 bound, the ledger and bytes equal."""
    pj = planes["j"]
    pt8 = tserve.demo_plane(N_USERS, mixed=True, max_entries=CAP,
                            quant_bits=8, seed=SEED, device="cpu",
                            streams=planes["streams"])
    ej = _jax_int8_plane(pj, pj["backing"])
    rj = jserve.replay(ej, planes["trace_j"], planes["images"])
    rt = tserve.replay(pt8["engine"], planes["trace_t"], planes["images"])
    _assert_replays(rt, rj, INT8_BOUND)
    assert pt8["store"].stats() == ej.store.stats()
    assert pt8["store"].bytes_at_rest() == ej.store.bytes_at_rest()


def test_standalone_plane_is_seeded_and_defaults_to_the_population():
    a = tserve.demo_plane(3, mixed=False, quant_bits=8, local_steps=1,
                          device="cpu", n_per_class=8, max_batch=16)
    b = tserve.demo_plane(3, mixed=False, quant_bits=8, local_steps=1,
                          device="cpu", n_per_class=8, max_batch=16)
    assert a["store"].max_entries == 3 and a["engine"].cfg.max_batch == 3
    for uid in range(3):
        for x, y in zip(tree_lib.leaves(a["backing"][uid]),
                        tree_lib.leaves(b["backing"][uid])):
            assert torch.equal(x, y)


def test_select_token():
    logits = torch.tensor(np.random.RandomState(0).randn(5, 11),
                          dtype=torch.float32)
    greedy = tlaunch.select_token(logits, greedy=True)
    want = np.asarray(jlaunch.select_token(jnp.asarray(logits.numpy()),
                                           greedy=True))
    assert greedy.dtype == torch.int32 and greedy.shape == (5, 1)
    np.testing.assert_array_equal(greedy.numpy(), want)
    draw = lambda seed, t: tlaunch.select_token(
        logits, greedy=False, temperature=t,
        generator=torch.Generator().manual_seed(seed))
    a, b = draw(3, 1.0), draw(3, 1.0)
    assert torch.equal(a, b) and a.shape == (5, 1) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 11
    # many draws differ; a cold temperature is the argmax
    assert len({tuple(draw(s, 1.0).flatten().tolist())
                for s in range(8)}) > 1
    assert torch.equal(draw(4, 1e-4), greedy)
    with pytest.raises(ValueError, match="Generator"):
        tlaunch.select_token(logits, greedy=False)
    with pytest.raises(ValueError, match="temperature"):
        tlaunch.select_token(logits, greedy=False, temperature=0.0,
                             generator=torch.Generator())


def test_parser_defaults_match_jax():
    want = vars(jlaunch.build_parser().parse_args([]))
    assert vars(tlaunch.build_parser().parse_args([])) == want
    argv = ["--adapters", "6", "--requests", "9", "--no-greedy", "--quant",
            "4", "--cache-entries", "5", "--max-batch", "3"]
    assert vars(tlaunch.build_parser().parse_args(argv)) == \
        vars(jlaunch.build_parser().parse_args(argv))


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def test_adapter_mode_prints_the_reference_lines():
    argv = ["--adapters", "4", "--requests", "12"]
    want = _printed(lambda: jlaunch.run_adapter_mode(
        jlaunch.build_parser().parse_args(argv)))
    got = _printed(lambda: tlaunch.main(argv, device="cpu"))
    assert got[:3] == want[:3]
    ledger = lambda lines: {
        ln.split(":")[0]: {k: v for k, v in ast.literal_eval(
            ln.split(": ", 1)[1]).items() if k != "compile_time_s"}
        for ln in lines[3:]}
    assert ledger(got) == ledger(want)


def test_token_mode_raises_naming_the_queue_item(monkeypatch):
    """The token mode runs every family; here the RG-LRU hybrid
    (recurrentgemma-2b reduced) on the JAX package's weights decodes the
    JAX CLI's token ids and prints its lines (the other families:
    tests/test_torch_serve_tokens.py)."""
    from test_torch_serve_tokens import ARGV, _jax_run, _port_run
    argv = ["--arch", "recurrentgemma-2b"] + ARGV
    want_lines, want = _jax_run(argv, monkeypatch)
    got_lines, out = _port_run(argv, monkeypatch)
    np.testing.assert_array_equal(out["tokens"], want)
    assert got_lines[0] == want_lines[0] and got_lines[3] == want_lines[3]
