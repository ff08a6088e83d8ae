"""The port's federated-round modules against the JAX package, on the CPU
at the tiny default CLIPConfig (2+2 layers, width 64): the same numpy
inputs and the JAX package's own draws (weights, batch indices) go
through both.

Tolerances: numpy-only modules (partition, synthetic data) and quantized
payloads bitwise; single fp32 ops ≤ 1e-5; training (local steps, a whole
round) at ``tests/test_fl.py``'s oracle tolerances: leaves atol 5e-4,
loss atol 1e-3 / rtol 1e-4, accuracy 1e-5, bytes equal. Within the port
the masked ``adam_scan`` cut at s is bitwise s steps."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import clip as jclip
from repro.core import losses as jlosses
from repro.core import optim as joptim
from repro.core import quant as jquant
from repro.data import synthetic as jsynth
from repro.fl import client as jclient
from repro.fl import cohort as jcohort
from repro.fl import partition as jpartition
from repro.fl import server as jserver
from repro.fl.strategies import STRATEGIES as JSTRATEGIES
from _jax_sched_stream import JaxDraws
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import adapter as tadapter
from repro_torch.core import clip as tclip
from repro_torch.core import gan as tgan
from repro_torch.core import losses as tlosses
from repro_torch.core import optim as toptim
from repro_torch.core import quant as tquant
from repro_torch.data import synthetic as tsynth
from repro_torch.fl import client as tclient
from repro_torch.fl import cohort as tcohort
from repro_torch.fl import fleetgan
from repro_torch.fl import partition as tpartition
from repro_torch.fl import server as tserver
from repro_torch.fl.strategies import STRATEGIES

torch.set_num_threads(2)
CFG_J = jclip.CLIPConfig()
CFG_T = tclip.CLIPConfig()
ARMS = ("fedclip", "qlora_nogan")
# tests/test_fl.py's oracle tolerances for a whole round
LEAF_ATOL, LOSS_ATOL, LOSS_RTOL, ACC_ATOL = 5e-4, 1e-3, 1e-4, 1e-5


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flat(tree):
    """path -> numpy array of a JAX or port tree; a QTensor contributes
    its payload and scales."""
    out = {}
    for path, leaf in tree_lib.flatten_with_path(tree):
        key = tree_lib.path_str(path)
        if hasattr(leaf, "scales"):
            for f in ("q", "scales"):
                v = getattr(leaf, f)
                out[f"{key}/{f}"] = v.cpu().numpy() if isinstance(
                    v, torch.Tensor) else np.asarray(v)
        else:
            out[key] = leaf.detach().cpu().numpy() if isinstance(
                leaf, torch.Tensor) else np.asarray(leaf)
    return out


def _jtree(tree):
    """A JAX tree as nested dicts of numpy arrays (QTensors kept)."""
    return jax.tree.map(np.asarray, tree)


def _assert_trees(got, want, atol, *, rtol=0.0):
    g, w = _flat(got), _flat(_jtree(want) if not isinstance(
        next(iter(tree_lib.leaves(want))), torch.Tensor) else want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol,
                                   err_msg=k)


# -- numpy-only modules: bitwise ----------------------------------------

@pytest.mark.parametrize("seed,n_clients,alpha", [
    (0, 3, 0.5), (1, 5, 0.1), (2, 8, 10.0), (7, 4, 0.5)])
def test_dirichlet_partition_bitwise(seed, n_clients, alpha):
    labels = np.random.RandomState(seed).randint(0, 7, 300)
    want = jpartition.dirichlet_partition(labels, n_clients, alpha,
                                          seed=seed)
    got = tpartition.dirichlet_partition(labels, n_clients, alpha,
                                         seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 3])
def test_domain_partition_and_histogram_bitwise(seed):
    rs = np.random.RandomState(seed)
    domains, labels = rs.randint(0, 4, 200), rs.randint(0, 7, 200)
    want = jpartition.domain_partition(domains, 4, seed=seed)
    got = tpartition.domain_partition(domains, 4, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            tpartition.class_histogram(labels, g, 7),
            jpartition.class_histogram(labels, w, 7))


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_make_eval_set_bitwise(seed):
    a = tsynth.make_eval_set("pacs", n_per_class=5, seed=seed)
    b = jsynth.make_eval_set("pacs", n_per_class=5, seed=seed)
    for k in ("images", "labels", "domains", "tokens"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 4])
def test_stage_client_pools_bitwise(seed):
    data = tsynth.make_dataset("pacs", n_per_class=8, seed=seed)
    parts = tpartition.dirichlet_partition(data["labels"], 4, 0.5,
                                           seed=seed)
    pools = [(data["images"][p], data["labels"][p]) for p in parts]
    for g, w in zip(tsynth.stage_client_pools(pools),
                    jsynth.stage_client_pools(pools)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- fp32 ops: 1e-5 ------------------------------------------------------

@pytest.fixture(scope="module")
def clip_weights():
    frozen_j = jclip.init_clip(jax.random.PRNGKey(3), CFG_J)
    return {"frozen_j": frozen_j,
            "frozen_t": convert.tree_from_numpy(frozen_j, "cpu")}


def test_clip_contrastive():
    img, txt = _np(1, 6, 32), _np(2, 6, 32)
    want = jlosses.clip_contrastive(jnp.asarray(img), jnp.asarray(txt),
                                    jnp.asarray(2.5))
    got = tlosses.clip_contrastive(torch.from_numpy(img),
                                   torch.from_numpy(txt), torch.tensor(2.5))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_lora", [False, True])
def test_image_embedding(clip_weights, with_lora):
    lora_np = _jtree(jclient.init_trainable(
        jax.random.PRNGKey(5), CFG_J, JSTRATEGIES["qlora_nogan"]))["lora"]
    lora_np = jax.tree.map(lambda l: l + 0.1 * _np(6, *l.shape), lora_np)
    imgs = _np(7, 3, 32, 32, 3)
    want = jclip.image_embedding(
        clip_weights["frozen_j"], CFG_J, jnp.asarray(imgs),
        lora=jax.tree.map(jnp.asarray, lora_np) if with_lora else None)
    got = tclip.image_embedding(
        clip_weights["frozen_t"], CFG_T, torch.from_numpy(imgs),
        lora=convert.tree_from_numpy(lora_np, "cpu") if with_lora else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_contrastive_loss_and_grad(clip_weights):
    data = jsynth.make_dataset("pacs", n_per_class=4, seed=1,
                               longtail_gamma=1.0)
    imgs, toks = data["images"][:8], data["tokens"][:8]
    lj, gj = jax.value_and_grad(jclip.contrastive_loss)(
        clip_weights["frozen_j"], CFG_J, jnp.asarray(imgs),
        jnp.asarray(toks))
    (lt, _), gt = toptim.value_and_grad(
        lambda p: (tclip.contrastive_loss(p, CFG_T, torch.from_numpy(imgs),
                                          torch.from_numpy(toks).long()),
                   None), clip_weights["frozen_t"])
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5, atol=1e-5)
    g, w = _flat(gt), _flat(_jtree(gj))
    for k in g:
        scale = max(np.abs(w[k]).max(), 1e-30)
        assert np.abs(g[k] - w[k]).max() / scale <= 1e-5, k


def _quad_problem():
    """A small two-leaf least-squares problem and its per-step batches."""
    params = {"w": _np(1, 6, 4), "b": _np(2, 4)}
    xs = _np(3, 5, 8, 6)
    ys = _np(4, 5, 8, 4)
    return params, xs, ys


def _port_quad_scan(active=None):
    params, xs, ys = _quad_problem()
    p = convert.tree_from_numpy(params, "cpu")

    def grad_fn(p, t):
        x, y = torch.from_numpy(xs[t]), torch.from_numpy(ys[t])
        (loss, _), g = toptim.value_and_grad(
            lambda q: (((x @ q["w"] + q["b"] - y) ** 2).mean(), None), p)
        return g, loss

    return toptim.adam_scan(grad_fn, p, toptim.adam_init(p),
                            torch.arange(len(xs)), lr=3e-2, grad_clip=1.0,
                            active=active)


def test_adam_scan_matches_jax():
    params, xs, ys = _quad_problem()

    def grad_fn(p, t):
        x, y = jnp.asarray(xs)[t], jnp.asarray(ys)[t]
        loss, g = jax.value_and_grad(
            lambda q: jnp.mean((x @ q["w"] + q["b"] - y) ** 2))(p)
        return g, loss

    pj = jax.tree.map(jnp.asarray, params)
    wp, ws, wl = joptim.adam_scan(grad_fn, pj, joptim.adam_init(pj),
                                  jnp.arange(len(xs)), lr=3e-2,
                                  grad_clip=1.0)
    gp, gs, gl = _port_quad_scan()
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5,
                               atol=1e-5)
    for got, want in ((gp, wp), (gs.mu, ws.mu), (gs.nu, ws.nu)):
        _assert_trees(got, want, 1e-5, rtol=1e-5)
    assert int(gs.step) == int(ws.step) == len(xs)


@pytest.mark.parametrize("s", [0, 2, 4])
def test_masked_adam_scan_cut_is_bitwise_s_steps(s):
    """Within the port: a 5-step scan masked after s steps is bitwise an
    s-step scan (params, both moments, the counter)."""
    cut = _port_quad_scan(active=toptim.step_mask(s, 5))
    params, xs, ys = _quad_problem()
    p = convert.tree_from_numpy(params, "cpu")
    state = toptim.adam_init(p)
    for t in range(s):
        x, y = torch.from_numpy(xs[t]), torch.from_numpy(ys[t])
        (_, _), g = toptim.value_and_grad(
            lambda q: (((x @ q["w"] + q["b"] - y) ** 2).mean(), None), p)
        p, state = toptim.adam_update(g, state, p, lr=3e-2, grad_clip=1.0)
    for got, want in ((cut[0], p), (cut[1].mu, state.mu),
                      (cut[1].nu, state.nu)):
        for k, v in _flat(got).items():
            np.testing.assert_array_equal(v, _flat(want)[k], err_msg=k)
    assert int(cut[1].step) == int(state.step) == s


def test_stacked_adam_is_per_client_adam():
    """``adam_update(stacked=True)``: each client's own clip, counter and
    step, against the unstacked update per client (1e-6: the clip norm is
    one fp32 reduction in another order)."""
    rs = np.random.RandomState(0)
    params = {"w": rs.randn(3, 6, 4).astype(np.float32),
              "b": rs.randn(3, 4).astype(np.float32)}
    grads = {"w": (rs.randn(3, 6, 4) * [[[0.01]], [[5.0]], [[1.0]]])
             .astype(np.float32), "b": rs.randn(3, 4).astype(np.float32)}
    p, g = (convert.tree_from_numpy(t, "cpu") for t in (params, grads))
    st = toptim.adam_init(p, stacked=True)
    assert st.step.shape == (3,)
    sp, ss = toptim.adam_update(g, st, p, lr=1e-2, grad_clip=1.0,
                                stacked=True)
    sp, ss = toptim.adam_update(g, ss, sp, lr=1e-2, grad_clip=1.0,
                                stacked=True)
    for c in range(3):
        pc = {k: v[c] for k, v in p.items()}
        gc = {k: v[c] for k, v in g.items()}
        s1 = toptim.adam_init(pc)
        pc, s1 = toptim.adam_update(gc, s1, pc, lr=1e-2, grad_clip=1.0)
        pc, s1 = toptim.adam_update(gc, s1, pc, lr=1e-2, grad_clip=1.0)
        for k in pc:
            np.testing.assert_allclose(sp[k][c].numpy(), pc[k].numpy(),
                                       rtol=1e-6, atol=1e-6)
        assert int(ss.step[c]) == int(s1.step) == 2


# -- server ------------------------------------------------------------------

def _deltas(n, bits):
    rs = np.random.RandomState(n + bits)
    out = []
    for _ in range(n):
        d = {"adapter": {"w": (rs.randn(64, 32) * 0.01).astype(np.float32),
                         "b": (rs.randn(32) * 0.01).astype(np.float32)}}
        out.append(d)
    return out


def _quant_j(d, bits):
    dj = jax.tree.map(jnp.asarray, d)
    return jquant.quantize_tree(dj, bits=bits, block=64, min_size=256,
                                skip_names=("slot",)) if bits else dj


def _quant_t(d, bits):
    dt = convert.tree_from_numpy(d, "cpu")
    return tquant.quantize_tree(dt, bits=bits, block=64, min_size=256,
                                skip_names=("slot",)) if bits else dt


@pytest.mark.parametrize("bits", [0, 8])
def test_aggregate_matches_jax(bits):
    g = {"adapter": {"w": _np(1, 64, 32), "b": _np(2, 32)}}
    ds = _deltas(3, bits)
    masses = [5, 2, 9]
    want = jserver.aggregate(jax.tree.map(jnp.asarray, g),
                             [(m, _quant_j(d, bits))
                              for m, d in zip(masses, ds)])
    got = tserver.aggregate(convert.tree_from_numpy(g, "cpu"),
                            [(m, _quant_t(d, bits))
                             for m, d in zip(masses, ds)])
    _assert_trees(got, want, 1e-6)
    assert tserver.secure_sum_bytes([(1, _quant_t(d, bits)) for d in ds]) \
        == jserver.secure_sum_bytes([(1, _quant_j(d, bits)) for d in ds])


@pytest.mark.parametrize("bits", [0, 8])
def test_aggregate_stacked_matches_jax(bits):
    g = {"adapter": {"w": _np(1, 64, 32), "b": _np(2, 32)}}
    stacked = jax.tree.map(lambda *l: np.stack(l), *_deltas(4, bits))
    w = np.asarray([0.1, 0.4, 0.3, 0.2], np.float32)
    want = jserver.aggregate_stacked(jax.tree.map(jnp.asarray, g),
                                     jnp.asarray(w), _quant_j(stacked, bits))
    got = tserver.aggregate_stacked(convert.tree_from_numpy(g, "cpu"),
                                    torch.from_numpy(w),
                                    _quant_t(stacked, bits))
    _assert_trees(got, want, 1e-6)


@pytest.mark.parametrize("weights,n", [
    ([0.5, 0.5], 3), ([0.5, 0.6], 2), ([1.2, -0.2], 2),
    ([np.nan, 1.0], 2), ([0.25, 0.25, 0.5], 3)])
def test_check_weights_raises_where_jax_does(weights, n):
    w = np.asarray(weights, np.float32)
    outcomes = []
    for check, arr in ((jserver.check_weights, w),
                       (tserver.check_weights, w),
                       (tserver.check_weights, torch.from_numpy(w))):
        try:
            check(arr, n)
            outcomes.append("ok")
        except ValueError:
            outcomes.append("raised")
    assert outcomes[0] == outcomes[1] == outcomes[2]
    assert outcomes[0] == ("ok" if weights == [0.25, 0.25, 0.5] else
                           "raised")


@pytest.mark.parametrize("case", ["ok", "nan", "inf_scales", "shape",
                                  "leaves"])
def test_check_delta_raises_where_jax_does(case):
    ref = {"a": _np(1, 64, 16), "b": _np(2, 16)}
    d = {"a": _np(3, 64, 16) * 0.01, "b": _np(4, 16) * 0.01}
    if case == "nan":
        d["b"][3] = np.nan
    if case == "shape":
        d["b"] = d["b"][:8]
    if case == "leaves":
        d["c"] = d["b"]
    dj = jax.tree.map(jnp.asarray, d)
    dt = convert.tree_from_numpy(d, "cpu")
    if case == "inf_scales":
        dj = jquant.quantize_tree(dj, bits=8, block=64, min_size=256)
        dt = tquant.quantize_tree(dt, bits=8, block=64, min_size=256)
        dj["a"].scales = dj["a"].scales.at[0, 0, 0].set(jnp.inf)
        dt["a"].scales[0, 0, 0] = float("inf")
    outcomes = []
    for check, delta in ((jserver.check_delta, dj),
                         (tserver.check_delta, dt)):
        try:
            check(delta, ref)
            outcomes.append("ok")
        except ValueError:
            outcomes.append("raised")
    assert outcomes[0] == outcomes[1] == ("ok" if case == "ok" else
                                          "raised")
    assert tserver.delta_ok(dt, ref) == (case == "ok")


# -- clients, the uplink, the cohort round -------------------------------

STEPS, BATCH, LR = 4, 8, 3e-3


def _setup(arm):
    """A small FL instance in both packages on the same weights."""
    strat_j, strat_t = JSTRATEGIES[arm], STRATEGIES[arm]
    frozen_j = jclip.init_clip(jax.random.PRNGKey(3), CFG_J)
    if strat_j.backbone_bits:
        q = jquant.quantize_tree(frozen_j["vision"], bits=4, mode="nf4",
                                 block=64, min_size=1024)
        frozen_j = dict(frozen_j, vision=jquant.dequantize_tree(q))
    data = jsynth.make_dataset("pacs", n_per_class=12, seed=0,
                               longtail_gamma=4.0)
    spec = data["spec"]
    toks = jsynth.class_tokens(spec, np.arange(spec.n_classes))
    class_emb_j = jclip.text_embedding(frozen_j, CFG_J, jnp.asarray(toks))
    parts = jpartition.dirichlet_partition(data["labels"], 3, 0.5, seed=0)
    clients_j = [jclient.Client(
        cid=i, images=data["images"][p], labels=data["labels"][p],
        n_classes=spec.n_classes, strategy=strat_j)
        for i, p in enumerate(parts)]
    clients_t = [tclient.Client(
        cid=i, images=data["images"][p], labels=data["labels"][p],
        n_classes=spec.n_classes, strategy=strat_t)
        for i, p in enumerate(parts)]
    global_j = jclient.init_trainable(jax.random.PRNGKey(1), CFG_J, strat_j)
    return {
        "strat_j": strat_j, "strat_t": strat_t,
        "frozen_j": frozen_j,
        "frozen_t": convert.tree_from_numpy(frozen_j, "cpu"),
        "class_emb_j": class_emb_j,
        "class_emb_t": torch.from_numpy(np.array(class_emb_j)),
        "clients_j": clients_j, "clients_t": clients_t,
        "global_j": global_j,
        "global_t": convert.tree_from_numpy(global_j, "cpu"),
        "key": jax.random.PRNGKey(42)}


@pytest.fixture(scope="module", params=ARMS)
def fl(request):
    """One round of the JAX engine and its sequential oracle, and the
    same round through the port's engine and its sequential clients, on
    the JAX draws."""
    arm = request.param
    s = _setup(arm)
    eng_j = jcohort.CohortEngine(
        frozen=s["frozen_j"], ccfg=CFG_J, class_emb=s["class_emb_j"],
        clients=s["clients_j"], cfg=jcohort.CohortConfig(
            strategy=s["strat_j"], local_steps=STEPS, batch_size=BATCH,
            lr=LR, donate=False))
    new_j, m_j = eng_j.run_round(s["global_j"], s["key"])
    idx = jcohort.round_indices(s["key"], np.asarray(eng_j.lens), STEPS,
                                BATCH)
    eng_t = tcohort.CohortEngine(
        frozen=s["frozen_t"], ccfg=CFG_T, class_emb=s["class_emb_t"],
        clients=s["clients_t"], cfg=tcohort.CohortConfig(
            strategy=s["strat_t"], local_steps=STEPS, batch_size=BATCH,
            lr=LR))
    key_t = tcohort.RoundKey(JaxDraws(s["key"]))
    new_t, m_t = eng_t.run_round(s["global_t"], key_t)
    seq_t = [c.local_train(s["frozen_t"], s["global_t"], s["class_emb_t"],
                           CFG_T, steps=STEPS, batch_size=BATCH, lr=LR,
                           indices=idx[i])
             for i, c in enumerate(s["clients_t"])]
    upd_t = [c.make_update(s["global_t"], tr)
             for c, (tr, _) in zip(s["clients_t"], seq_t)]
    return dict(s, arm=arm, eng_j=eng_j, eng_t=eng_t, new_j=new_j, m_j=m_j,
                new_t=new_t, m_t=m_t, idx=idx, key_t=key_t, seq_t=seq_t,
                upd_t=upd_t)


def test_round_indices_are_the_injected_draw(fl):
    got = tcohort.round_indices(fl["key_t"], fl["eng_t"].lens, STEPS, BATCH)
    np.testing.assert_array_equal(got, fl["idx"])
    bad = tcohort.RoundKey(SimpleNamespace(
        batch_indices=lambda *a: fl["idx"] + 10_000))
    with pytest.raises(ValueError):
        tcohort.round_indices(bad, fl["eng_t"].lens, STEPS, BATCH)
    with pytest.raises(ValueError, match="cannot serve a choice"):
        bad.choice(3, 2, [0.5, 0.25, 0.25])


def test_client_local_train_and_update_match_jax(fl):
    """``Client.local_train`` + ``make_update`` for each client against the
    JAX client on the same indices: the trained leaves, the last step's
    loss and accuracy, the dequantized update and its bytes."""
    for i, (cj, (tr_t, m_t), (upd_t, nb_t)) in enumerate(zip(
            fl["clients_j"], fl["seq_t"], fl["upd_t"])):
        tr_j, m_j = cj.local_train(
            fl["frozen_j"], fl["global_j"], fl["class_emb_j"], CFG_J,
            steps=STEPS, batch_size=BATCH, lr=LR, indices=fl["idx"][i])
        _assert_trees(tr_t, tr_j, LEAF_ATOL)
        np.testing.assert_allclose(m_t["loss"], m_j["loss"],
                                   atol=LOSS_ATOL, rtol=LOSS_RTOL)
        np.testing.assert_allclose(m_t["acc"], m_j["acc"], atol=ACC_ATOL)
        upd_j, nb_j = cj.make_update(fl["global_j"], tr_j)
        assert nb_t == nb_j
        _assert_trees(tquant.dequantize_tree(upd_t, torch.float32),
                      jquant.dequantize_tree(upd_j, jnp.float32),
                      LEAF_ATOL)


def test_local_train_default_sampling_is_the_jax_draw(fl):
    """Without injected indices both clients draw
    ``RandomState(seed).randint`` and train on the same batches."""
    cj, ct = fl["clients_j"][0], fl["clients_t"][0]
    tr_j, m_j = cj.local_train(fl["frozen_j"], fl["global_j"],
                               fl["class_emb_j"], CFG_J, steps=2,
                               batch_size=BATCH, lr=LR, seed=7)
    tr_t, m_t = ct.local_train(fl["frozen_t"], fl["global_t"],
                               fl["class_emb_t"], CFG_T, steps=2,
                               batch_size=BATCH, lr=LR, seed=7)
    _assert_trees(tr_t, tr_j, LEAF_ATOL)
    np.testing.assert_allclose(m_t["loss"], m_j["loss"], atol=LOSS_ATOL,
                               rtol=LOSS_RTOL)


def test_cohort_round_matches_jax_engine(fl):
    _assert_trees(fl["new_t"], fl["new_j"], LEAF_ATOL)
    np.testing.assert_allclose(fl["m_t"]["loss"].numpy(),
                               np.asarray(fl["m_j"]["loss"]),
                               atol=LOSS_ATOL, rtol=LOSS_RTOL)
    np.testing.assert_allclose(fl["m_t"]["acc"].numpy(),
                               np.asarray(fl["m_j"]["acc"]), atol=ACC_ATOL)
    assert fl["m_t"]["uplink_bytes"] == int(fl["m_j"]["uplink_bytes"])


def test_cohort_round_matches_port_sequential(fl):
    """The port's own oracle contract: the stacked round equals its
    clients' sequential ``local_train`` + ``server.aggregate``."""
    ref = tserver.aggregate(fl["global_t"], [
        (c.n, u) for c, (u, _) in zip(fl["clients_t"], fl["upd_t"])])
    _assert_trees(fl["new_t"], ref, LEAF_ATOL)
    np.testing.assert_allclose(fl["m_t"]["loss"].numpy(),
                               [m["loss"] for _, m in fl["seq_t"]],
                               atol=LOSS_ATOL, rtol=LOSS_RTOL)
    np.testing.assert_allclose(fl["m_t"]["acc"].numpy(),
                               [m["acc"] for _, m in fl["seq_t"]],
                               atol=ACC_ATOL)
    assert fl["m_t"]["uplink_bytes"] == tserver.secure_sum_bytes(
        [(1, u) for u, _ in fl["upd_t"]])


def test_comm_quantize_stacked_is_per_client_quantize(fl):
    rs = np.random.RandomState(3)
    stacked = tree_lib.tree_map(
        lambda g: torch.from_numpy(
            (rs.randn(3, *g.shape) * 0.01).astype(np.float32)),
        fl["global_t"])
    q = tcohort.comm_quantize_stacked(stacked, fl["strat_t"])
    for i in range(3):
        per = fl["strat_t"].comm_quantize(
            tree_lib.tree_map(lambda l: l[i], stacked))
        got = _flat(tcohort.slice_client_delta(q, i))
        want = _flat(per)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert tquant.tree_bytes(tcohort.slice_client_delta(q, i)) == \
            tquant.tree_bytes(per) == \
            fl["eng_t"].per_client_uplink_bytes(fl["global_t"])
    # and the stacked payload is the JAX package's, bitwise
    qj = jcohort.comm_quantize_stacked(
        jax.tree.map(jnp.asarray, convert.tree_to_numpy(stacked)),
        fl["strat_j"])
    got, want = _flat(q), _flat(_jtree(qj))
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_per_client_uplink_bytes_match_jax(fl):
    assert fl["eng_t"].per_client_uplink_bytes(fl["global_t"]) == \
        fl["eng_j"].per_client_uplink_bytes(fl["global_j"]) == \
        fl["upd_t"][0][1]
    assert fl["eng_t"].uplink_bytes(fl["global_t"]) == \
        3 * fl["upd_t"][0][1]


def test_staged_pools_match_jax(fl):
    want = np.asarray(jcohort.stage_encoded_pools(
        fl["frozen_j"], CFG_J, use_lora=fl["strat_j"].use_lora,
        imgs=jsynth.stage_client_pools(
            [c.pool() for c in fl["clients_j"]])[0]))
    np.testing.assert_allclose(fl["eng_t"].pool_staged.numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_adapter_apply_stacked_is_per_client_apply(fl):
    rs = np.random.RandomState(4)
    stacked = tree_lib.tree_map(
        lambda g: g.expand(3, *g.shape) + torch.from_numpy(
            (rs.randn(3, *g.shape) * 0.1).astype(np.float32)),
        fl["global_t"]["adapter"])
    x = torch.from_numpy(_np(5, 3, 6, 1, 64))
    got = tadapter.apply_stacked(stacked, x, n_heads=4, causal=False)
    for c in range(3):
        want = tadapter.apply({k: v[c] for k, v in stacked.items()}, x[c],
                              n_heads=4, causal=False)
        np.testing.assert_allclose(got[c].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_unported_engine_paths_raise(fl):
    """What the engine refuses, as the JAX engine does: a malformed
    subset, a step profile it was not staged for, a cohort its mesh's
    data-parallel shards do not divide, and a mesh-sharded fleet GAN
    without bucketed batches. The mesh itself is ported (Queue A item
    8.5; tests/test_torch_cohort_mesh.py), and so are the int8 GAN gemms
    (Queue B item 9): the fleet trains with them."""
    for sel in ([0, 0], [3], []):
        with pytest.raises(ValueError, match="invalid client subset"):
            fl["eng_t"].run_subset_round(fl["global_t"], sel, fl["key_t"])
    with pytest.raises(ValueError, match="staged homogeneous"):
        fl["eng_t"].run_wave(fl["global_t"], [0, 1], fl["key_t"],
                             n_steps=[STEPS, STEPS - 1])
    # a mesh of 2 data-parallel shards (what the engine reads of a
    # launch.mesh.Mesh) against the fixture's 3 clients
    two = SimpleNamespace(axis_names=("data",), size=lambda axes: 2,
                          index=lambda axes: 0)
    with pytest.raises(ValueError, match="not divisible"):
        tcohort.CohortEngine(
            frozen=fl["eng_t"].frozen, ccfg=fl["eng_t"].ccfg,
            class_emb=fl["eng_t"].class_emb, clients=fl["clients_t"],
            cfg=tcohort.CohortConfig(strategy=fl["strat_t"], local_steps=1,
                                     batch_size=2, lr=1e-3, mesh=two))
    with pytest.raises(ValueError, match="bucket_batches"):
        fleetgan.launch_gan_fleet(
            [copy.copy(fl["clients_t"][0])], [tgan.SeededGANStream((0,))],
            steps=1, fleet_cfg=fleetgan.FleetGANConfig(
                mesh=two, bucket_batches=False), device="cpu")
    # a copy: the fleet writes its results onto the client
    client = copy.copy(fl["clients_t"][0])
    rep = fleetgan.prepare_gan_fleet(
        [client], [tgan.SeededGANStream((0,))], steps=1,
        conv_impl="gemm_int8", device="cpu")
    assert rep.n_clients == 1
    assert all(np.isfinite(v) for v in rep.d_loss.values())
