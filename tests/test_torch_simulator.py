"""The port's ``run_federated`` against the JAX package's, on the CPU at a
small size (3 clients, 2 rounds, 3 local steps, ``n_per_class=12``,
batch 8; the tiny default CLIPConfig), with the JAX package's draws
injected as ``Streams``: the CLIP init ``init_clip(PRNGKey(1234))``, the
trainables ``init_trainable(fold_in(PRNGKey(seed), 2))`` and the batch
indices of the warm-up key ``fold_in(rng, 4)`` and the round keys
``fold_in(fold_in(rng, 3), r)``.

Held in every comparison: uplink bytes, the meta byte and parameter
counts and the meta keys equal; accuracies within one sample (server and
tail accuracy within one eval sample, a client's last-step batch
accuracy within one of its 8). Losses, relative per History entry:
 - each package pretraining its own CLIP (300 Adam steps, the backbones
   within ``PRETRAIN_TOL`` of each other per leaf): ``OWN_LOSS_TOL``
   for the server loss and ``OWN_CLIENT_LOSS_TOL`` for a client's
   last-step batch loss (measured worst: 5.7e-4 and 2.0e-2, the latter
   qlora_nogan, whose NF4 codes amplify the backbones' difference);
 - the port on the JAX package's pretrained backbone: ``LOSS_TOL``
   (measured worst 7.3e-6).
The ``tripleplay`` arm (4 GAN steps), its GAN draws injected too
(``tests/_jax_gan_stream.py``), on the JAX package's backbone:
``GAN_LOSS_TOL`` relative (the trained generators agree to the fleet
engine's 2e-3, not bitwise, so the synthetic rows differ slightly), the
``gan_*`` counts equal. Within the port: pipelined == barrier bitwise,
cohort == sequential at ``tests/test_fl.py``'s oracle tolerances, the
fleet GAN engine == the sequential one within ``GAN_LOSS_TOL``, the
scheduler options that once raised now run (a malformed value raises);
the JAX draws come from ``tests/_jax_sched_stream.py``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from _jax_sched_stream import jax_streams, on_jax_backbone
from repro.core import clip as jclip
from repro.fl import simulator as jsim
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import clip as tclip
from repro_torch.core import gan as tgan
from repro_torch.fl import runtime as truntime
from repro_torch.fl import simulator as tsim

torch.set_num_threads(2)
ARMS = ("fedclip", "qlora_nogan")
ALL_ARMS = ARMS + ("tripleplay",)
SMALL = dict(dataset="pacs", n_clients=3, rounds=2, local_steps=3,
             n_per_class=12, batch_size=8, lr=3e-3, gan_steps=4)
# losses: relative, per History entry (the measured worst is printed)
OWN_LOSS_TOL, OWN_CLIENT_LOSS_TOL = 5e-3, 1e-1
LOSS_TOL = 1e-4
GAN_LOSS_TOL = 1e-3
# pretrained_clip after 300 Adam steps: per leaf, max |port - JAX| over
# max |JAX|
PRETRAIN_TOL = 1e-3
EXACT_META = ("strategy", "dataset", "n_clients", "n_clients_active",
              "engine", "trainable_params", "frozen_params",
              "backbone_bytes", "footprint_bytes", "util_proxy_const",
              "participation", "clients_per_round", "trace",
              "staleness_beta", "device_classes", "pipeline",
              "prepared_rounds")
GAN_META = ("gan_engine", "gan_eligible", "gan_synth", "gan_groups")


def _run_port(arm, streams=None, **kw):
    cfg = tsim.FLConfig(strategy=arm, **{**SMALL, **kw})
    return tsim.run_federated(cfg, device="cpu", streams=streams)


@pytest.fixture(scope="module", params=ARMS)
def pair(request):
    arm = request.param
    jcfg = jsim.FLConfig(strategy=arm, **SMALL)
    want = jsim.run_federated(jcfg)
    streams = jax_streams(jcfg)
    got = _run_port(arm, streams)
    return {"arm": arm, "want": want, "got": got, "streams": streams}


def _on_jax_backbone(arm):
    """The JAX package's run and the port's on the JAX package's
    pretrained backbone: what is left is the rounds themselves."""
    want, got = on_jax_backbone(strategy=arm, **SMALL)
    return {"arm": arm, "want": want, "got": got}


@pytest.fixture(scope="module", params=ARMS)
def pair_same_backbone(request):
    return _on_jax_backbone(request.param)


@pytest.fixture(scope="module")
def tripleplay_pair():
    return _on_jax_backbone("tripleplay")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


def _check_history(pair, server_tol, client_tol):
    got, want = pair["got"], pair["want"]
    assert got.rounds == want.rounds
    assert got.uplink_bytes == want.uplink_bytes
    assert got.participation == want.participation
    assert got.staleness == want.staleness and got.vtime == want.vtime
    for key in EXACT_META:
        assert got.meta[key] == want.meta[key], key
    assert set(got.meta) == set(want.meta)
    worst = {"client_loss": float(_rel(got.client_loss,
                                       want.client_loss).max()),
             "server_loss": float(_rel(got.server_loss,
                                       want.server_loss).max())}
    print(f"{pair['arm']}: worst relative loss differences {worst}")
    assert worst["server_loss"] <= server_tol, worst
    assert worst["client_loss"] <= client_tol, worst
    n_eval = 7 * 20
    assert np.abs(np.subtract(got.server_acc, want.server_acc)).max() \
        <= 1.0 / n_eval + 1e-12
    assert np.abs(np.subtract(got.client_acc, want.client_acc)).max() \
        <= 1.0 / SMALL["batch_size"] + 1e-12
    assert np.abs(np.subtract(got.tail_acc, want.tail_acc)).max() \
        <= 1.0 / 20 + 1e-12


def test_history_matches_jax(pair):
    _check_history(pair, OWN_LOSS_TOL, OWN_CLIENT_LOSS_TOL)


def test_history_on_the_jax_backbone_matches_jax(pair_same_backbone):
    _check_history(pair_same_backbone, LOSS_TOL, LOSS_TOL)


def test_tripleplay_history_on_the_jax_backbone_matches_jax(tripleplay_pair):
    """The fleet GAN on the JAX package's draws, then the rounds on the
    rebalanced pools: the same eligibility, synthetic row count and
    bucket, and the History within ``GAN_LOSS_TOL``."""
    _check_history(tripleplay_pair, GAN_LOSS_TOL, GAN_LOSS_TOL)
    got, want = tripleplay_pair["got"].meta, tripleplay_pair["want"].meta
    for key in GAN_META:
        assert got[key] == want[key], key


def test_pretrained_clip_matches_jax(pair):
    """300 Adam steps of contrastive pretraining from the same init and
    the same ``RandomState`` batches."""
    ccfg = jclip.CLIPConfig()
    want = jsim.pretrained_clip("pacs", ccfg, seed=1234)
    got = tsim.pretrained_clip("pacs", tclip.CLIPConfig(), seed=1234,
                               init=pair["streams"].clip_init, device="cpu")
    w = dict(tree_lib.flatten_with_path(jax.tree.map(np.asarray, want)))
    errs = {}
    for path, leaf in tree_lib.flatten_with_path(got):
        ref = w[path]
        errs[tree_lib.path_str(path)] = float(
            np.abs(leaf.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30))
    worst = max(errs, key=errs.get)
    print(f"pretrained_clip worst leaf {worst}: {errs[worst]:.3g} "
          f"(bound {PRETRAIN_TOL})")
    assert errs[worst] <= PRETRAIN_TOL


def test_pretrained_clip_is_repeatable():
    """Two pretraining runs in one process are bitwise equal (the text
    tower's embedding gradient sums a token's repeats in a fixed order)."""
    cfg = tsim.FLConfig(**SMALL, strategy="fedclip")
    init = tsim.seeded_streams(cfg).clip_init
    runs = []
    for _ in range(2):
        key = tsim.clip_cache_key("pacs", tclip.CLIPConfig(), steps=30,
                                  init=init, device="cpu")
        tsim._CLIP_CACHE.pop(key, None)
        runs.append(tsim.pretrained_clip("pacs", tclip.CLIPConfig(),
                                         steps=30, init=init, device="cpu"))
    for (p, a), (_, b) in zip(tree_lib.flatten_with_path(runs[0]),
                              tree_lib.flatten_with_path(runs[1])):
        assert torch.equal(a, b), tree_lib.path_str(p)


def _same_history(a, b):
    for f in dataclasses.fields(tsim.History):
        if f.name in ("round_time_s", "meta"):
            continue
        assert getattr(a, f.name) == getattr(b, f.name), f.name


@pytest.mark.parametrize("arm", ALL_ARMS)
def test_pipelined_history_is_bitwise_barrier(arm):
    pipe = _run_port(arm, pipeline="pipelined")
    bar = _run_port(arm, pipeline="barrier")
    _same_history(pipe, bar)
    assert pipe.meta["sync_counts"] == {"metrics_flush": 1}
    assert pipe.meta["prepared_rounds"] == SMALL["rounds"]
    assert bar.meta["sync_counts"]["round_barrier"] == SMALL["rounds"]
    assert bar.meta["sync_counts"]["handle_wait:server_eval"] == \
        SMALL["rounds"]


@pytest.mark.parametrize("arm", ALL_ARMS)
def test_cohort_history_matches_sequential(arm):
    """The port's oracle contract end to end, on its default streams (for
    tripleplay both run the fleet GAN engine: the same pools)."""
    coh = _run_port(arm, engine="cohort")
    seq = _run_port(arm, engine="sequential")
    assert coh.uplink_bytes == seq.uplink_bytes
    np.testing.assert_allclose(coh.client_loss, seq.client_loss,
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(coh.client_acc, seq.client_acc, atol=1e-5)
    np.testing.assert_allclose(coh.server_loss, seq.server_loss,
                               atol=1e-3, rtol=1e-4)
    round_kinds = lambda h: {k: n for k, n in h.meta["n_compiles_by_kind"]
                             .items() if not k.startswith("gan_")}
    assert round_kinds(seq) == {"server_eval": 1}
    assert set(round_kinds(coh)) >= {
        "full_round", "sample_idx", "server_eval", "stage_encode"}
    if arm == "tripleplay":
        assert coh.meta["gan_synth"] == seq.meta["gan_synth"] > 0


def test_fleet_gan_engine_matches_sequential_gan_engine():
    """The stacked GAN prep against the per-client ``prepare_gan`` loop,
    end to end, and the ``gan_*`` meta each engine reports."""
    fleet = _run_port("tripleplay", gan_engine="fleet")
    seq = _run_port("tripleplay", gan_engine="sequential")
    assert fleet.uplink_bytes == seq.uplink_bytes
    for name in ("client_loss", "server_loss"):
        assert _rel(getattr(fleet, name), getattr(seq, name)).max() <= \
            GAN_LOSS_TOL, name
    n_eval = 7 * 20
    assert np.abs(np.subtract(fleet.server_acc, seq.server_acc)).max() \
        <= 1.0 / n_eval + 1e-12
    assert {k for k in fleet.meta if k.startswith("gan_")} == {
        "gan_engine", "gan_eligible", "gan_synth", "gan_groups",
        "gan_prep_time_s", "gan_compile_time_s"}
    assert {k for k in seq.meta if k.startswith("gan_")} == {
        "gan_engine", "gan_eligible", "gan_prep_time_s"}
    assert (fleet.meta["gan_engine"], seq.meta["gan_engine"]) == \
        ("fleet", "sequential")
    assert fleet.meta["gan_eligible"] == seq.meta["gan_eligible"] >= 1
    assert fleet.meta["gan_groups"] and fleet.meta["gan_synth"] > 0
    assert fleet.meta["gan_prep_time_s"] > 0 and \
        seq.meta["gan_prep_time_s"] > 0
    assert fleet.meta["gan_compile_time_s"] >= 0
    # class-0 (long tail) accuracy is tracked every eval round
    assert len(fleet.tail_acc) == len(fleet.rounds) == SMALL["rounds"]
    assert all(0.0 <= t <= 1.0 for t in fleet.tail_acc)
    assert not any(k.startswith("gan_") for k in _run_port("fedclip").meta)


def test_metrics_flush_every_counts_its_syncs():
    h = _run_port("fedclip", rounds=3, metrics_flush_every=2)
    assert h.meta["loop_syncs"] == 1
    assert h.meta["sync_counts"] == {"metrics_flush": 2}
    assert len(h.server_acc) == len(h.client_loss) == 3


@pytest.mark.parametrize("change", [
    ({"strategy": "tripleplay", "chaos": "light"}, {"chaos": "lite"}),
    ({"participation": "sync-partial", "clients_per_round": 2},
     {"clients_per_round": -1}),
    ({"participation": "async", "clients_per_round": 1},
     {"async_concurrency": 1, "clients_per_round": 2}),
    ({"trace": "skewed"}, {"trace": "zipf"}),
    ({"chaos": "light"}, {"chaos": 0.1})])
def test_unported_options_raise(change):
    """The options that raised until the scheduler layer was ported (the
    participation policies, traces and chaos) now run, and a malformed
    value of each (the pair's second half) raises ``ValueError`` before
    any round runs."""
    change, bad = change
    cfg = tsim.FLConfig(**{**SMALL, "strategy": "fedclip", **change})
    h = tsim.run_federated(cfg, device="cpu")
    assert len(h.client_loss) == len(h.vtime) == SMALL["rounds"]
    assert h.meta["participation"] == {
        "sync-partial": "sync-partial", "async": "async"}.get(
            change.get("participation"), "full-sync")
    assert ("fault_ledger" in h.meta) == ("chaos" in change)
    with pytest.raises(ValueError):
        tsim.run_federated(dataclasses.replace(cfg, **bad), device="cpu")


def test_bad_options_and_serve_store_raise():
    """Bad options raise; ``serve_store`` is ported (ROADMAP.md Queue A
    item 7): the store is refreshed after every committed round but the
    first (``tests/test_torch_serve_refresh.py`` holds it against the
    JAX package's)."""
    from repro_torch.fl.serve import AdapterStore
    for change in ({"participation": "everyone"}, {"engine": "vmap"},
                   {"pipeline": "eager"}):
        with pytest.raises(ValueError):
            tsim.run_federated(tsim.FLConfig(**{**SMALL, "strategy":
                                                "fedclip", **change}),
                               device="cpu")
    cfg = tsim.FLConfig(**SMALL, strategy="fedclip")
    backing = {u: tsim.seeded_streams(dataclasses.replace(cfg, seed=u))
               .trainable_init for u in range(2)}
    store = AdapterStore(backing, max_entries=1, quant_bits=8, device="cpu")
    h = tsim.run_federated(cfg, device="cpu", serve_store=store)
    assert h.meta["serve_refreshes"] == (cfg.rounds - 1) * len(backing)
    with pytest.raises(ValueError, match="gan_engine"):
        tsim.run_federated(tsim.FLConfig(**{**SMALL, "strategy": "tripleplay",
                                            "gan_engine": "bogus"}),
                           device="cpu")
    cfg = tsim.FLConfig(**SMALL, strategy="tripleplay")
    with pytest.raises(ValueError, match="Streams.gan"):
        tsim.run_federated(cfg, device="cpu", streams=dataclasses.replace(
            tsim.seeded_streams(cfg), gan=None))


def test_no_device_and_no_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.run_federated(tsim.FLConfig(**SMALL, strategy="fedclip"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.pretrained_clip("pacs", tclip.CLIPConfig())


def test_program_runtime_ledger_and_lru():
    rt = truntime.ProgramRuntime(max_entries=2)
    x = torch.zeros(3)
    for n in (1, 2, 3, 1):
        rt.run("k", lambda: (lambda t: t + 1), (torch.zeros(n),))
    assert rt.n_compiles == 4 and rt.n_evictions == 2
    assert rt.stats()["k"]["n_evicted"] == 2
    truntime.reset_sync_traces()
    h = rt.dispatch("e", lambda: (lambda t: t * 2), (x,))
    assert not h.done
    h.result()
    h.result()
    assert h.done
    assert truntime.SYNC_TRACES == {"handle_wait": 1,
                                    "handle_wait:e": 1}
    assert rt.subtotal("e") == (1, rt.stats()["e"]["compile_time_s"])
    with pytest.raises(ValueError):
        truntime.ProgramRuntime(max_entries=-1)


def test_seeded_streams_are_deterministic():
    cfg = tsim.FLConfig(**SMALL, strategy="qlora_nogan")
    a, b = tsim.seeded_streams(cfg), tsim.seeded_streams(cfg)
    for x, y in ((a.clip_init, b.clip_init),
                 (a.trainable_init, b.trainable_init)):
        for (p, l), (_, m) in zip(tree_lib.flatten_with_path(x),
                                  tree_lib.flatten_with_path(y)):
            np.testing.assert_array_equal(l, m, err_msg=str(p))
    lens = np.asarray([5, 9, 3], np.int32)
    i0 = a.batch_indices((3, 0), lens, 3, 8)
    np.testing.assert_array_equal(i0, b.batch_indices((3, 0), lens, 3, 8))
    assert i0.shape == (3, 3, 8) and (i0.max(axis=(1, 2)) < lens).all()
    assert not np.array_equal(i0, a.batch_indices((3, 1), lens, 3, 8))
    p = np.asarray([0.1, 0.2, 0.3, 0.4])
    for kind, args in (("choice", (4, 2, p)), ("uniform", (5,)),
                       ("normal", (5,))):
        x = getattr(a, kind)((3, 0, 101), *args)
        np.testing.assert_array_equal(x, getattr(b, kind)((3, 0, 101), *args))
        assert not np.array_equal(x, getattr(a, kind)((3, 1, 101), *args))
    assert "lora" in convert.tree_from_numpy(a.trainable_init, "cpu")
    gcfg = tgan.GANConfig()
    for x, y in zip(a.gan(1).train(gcfg, 9, 2, 9), b.gan(1).train(gcfg, 9, 2,
                                                                  9)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.gan(0).synth(gcfg, 3), a.gan(1).synth(gcfg, 3))
