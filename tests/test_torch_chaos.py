"""The port's chaos layer (``fl.sched.chaos`` and the policies' fault
paths) against the JAX package's, on the CPU at ``tests/test_chaos.py``'s
sizes (4 clients of pacs, 14 a class, 4 local steps of 8, the engine
staged with ``force_het``), with the JAX package's draws injected
(``tests/_jax_sched_stream.py``): every fault vector is the JAX
schedule's uniform or normal draw at the same ``fold_in`` path.

Tolerances: fault schedules (dropout cuts, straggler multipliers, dark
windows, lost and corrupt uplinks, GAN drops), participation, virtual
time, uplink bytes and the fault ledger exactly; trained leaves, losses
and accuracies at ``tests/test_chaos.py``'s oracle tolerances (leaves
atol 5e-4, loss atol 1e-3 / rtol 1e-4; after chained commits the two
ReLU-gated adapter leaves in norm, ``assert_chain``). Within the port:
a masked Adam scan and a masked GAN scan cut at s are bitwise s steps
(the reference's own test of the Adam case compares two XLA programs and
fails; the port runs the same eager ops either way), a prorated chaos
commit is bitwise the hand-built one, and async chaos runs are bitwise
repeatable. ``run_federated`` under chaos is held in
``tests/test_torch_sched_run.py`` and ``tests/test_torch_sched_gan.py``."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from _jax_sched_stream import (JaxDraws, assert_chain, assert_metrics,
                               assert_trees, fl_setup, keys)
from repro.core import quant as jquant
from repro.fl import sched as jsched
from repro.fl.sched import chaos as jchaos
from repro_torch import tree as tree_lib
from repro_torch.core import gan as tgan
from repro_torch.core import optim as toptim
from repro_torch.core import quant as tquant
from repro_torch.fl import cohort as tcohort
from repro_torch.fl import server as tserver
from repro_torch.fl import sched as tsched
from repro_torch.fl.sched import chaos as tchaos

torch.set_num_threads(2)
N_CLIENTS = 4
STEPS = 4


def _setup(arm="fedclip"):
    return fl_setup(arm, n_clients=N_CLIENTS, n_per_class=14, steps=STEPS,
                    force_het=True)


def _chaos(pkg, trace, seed=0, **kw):
    """A schedule of ``pkg`` on ``PRNGKey(seed)``: the JAX key itself, or
    the port's key for its draws."""
    key = jax.random.PRNGKey(seed)
    if pkg is tsched:
        key = tcohort.RoundKey(JaxDraws(key))
    return pkg.ChaosSchedule(pkg.ChaosConfig(**kw), key, trace)


# -- config + schedule draws ----------------------------------------------

def test_chaos_config_validation_and_presets():
    for bad in (dict(dropout_prob=1.5), dict(unavail_len=0),
                dict(max_retries=0), dict(retry_backoff=0.0),
                dict(class_mult=(1.0, -2.0))):
        with pytest.raises(ValueError):
            tsched.ChaosConfig(**bad)
    assert tsched.resolve_chaos(None) is None
    cfg = tsched.ChaosConfig(dropout_prob=0.2)
    assert tsched.resolve_chaos(cfg) is cfg
    assert {k: dataclasses.asdict(v) for k, v in
            tsched.CHAOS_PRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in jsched.CHAOS_PRESETS.items()}
    assert dataclasses.asdict(tsched.ChaosConfig()) == \
        dataclasses.asdict(jsched.ChaosConfig())
    assert tsched.FaultLedger().as_dict() == jsched.FaultLedger().as_dict()
    with pytest.raises(ValueError, match="preset"):
        tsched.resolve_chaos("cataclysmic")
    with pytest.raises(ValueError):
        tsched.resolve_chaos(42)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_fault_draws_are_the_jax_schedule(seed):
    """Every fault the port draws equals the JAX schedule's on the same
    key: cut points, straggler multipliers (with per-class multipliers),
    dark windows, lost and corrupt uplinks (round and async dispatch
    tags), GAN drops."""
    kw = dict(dropout_prob=0.5, unavail_prob=0.3, unavail_len=2,
              straggler_sigma=0.4, class_mult=(1.0, 2.0, 4.0),
              uplink_loss_prob=0.5, corrupt_prob=0.5)
    tt, tj = tsched.diurnal_trace(8, seed=seed), \
        jsched.diurnal_trace(8, seed=seed)
    a, b = _chaos(tsched, tt, seed, **kw), _chaos(jsched, tj, seed, **kw)
    full = np.asarray([6, 6, 1, 2, 6, 3, 6, 6], np.int64)
    for tag in (0, 3, tchaos.ASYNC_TAG0 + 2):
        for sel in (np.arange(8), np.array([1, 5, 6])):
            for x, y in zip(a.cut_steps(tag, sel, full[sel]),
                            b.cut_steps(tag, sel, full[sel])):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(a.straggler_mult(tag, sel),
                                          b.straggler_mult(tag, sel))
        for cid in range(8):
            for attempt in (0, 1, 2):
                assert a.uplink_lost(tag, cid, attempt) == \
                    b.uplink_lost(tag, cid, attempt)
            assert a.corrupt_uplink(tag, cid) == b.corrupt_uplink(tag, cid)
    for rnd in (0, 1, 4, 5):
        np.testing.assert_array_equal(a.dark_mask(rnd), b.dark_mask(rnd))
    np.testing.assert_array_equal(a.gan_dropouts(), b.gan_dropouts())
    assert tchaos.ASYNC_TAG0 == jchaos.ASYNC_TAG0


def test_fault_schedule_is_population_shaped_and_deterministic():
    """A client's fault does not depend on who else is in the cohort
    (draws over the population, cohorts index them), and two schedules
    of one (config, key, trace) agree."""
    tr = tsched.uniform_trace(8)
    kw = dict(dropout_prob=0.5, straggler_sigma=0.4, uplink_loss_prob=0.5,
              corrupt_prob=0.5)
    a, b = _chaos(tsched, tr, 7, **kw), _chaos(tsched, tr, 7, **kw)
    full = np.full(8, 6, np.int64)
    cut_a, drop_a = a.cut_steps(3, np.arange(8), full)
    sub = np.array([1, 5, 6])
    cut_s, drop_s = b.cut_steps(3, sub, full[sub])
    np.testing.assert_array_equal(cut_s, cut_a[sub])
    np.testing.assert_array_equal(drop_s, drop_a[sub])
    np.testing.assert_array_equal(a.straggler_mult(2, sub),
                                  b.straggler_mult(2, np.arange(8))[sub])


def test_cut_steps_bounds_and_single_step_clients():
    tr = tsched.uniform_trace(16)
    ch = _chaos(tsched, tr, dropout_prob=1.0)
    full = np.full(16, 6, np.int64)
    cut, dropped = ch.cut_steps(0, np.arange(16), full)
    assert dropped.all() and (cut >= 1).all() and (cut <= 5).all()
    cut1, drop1 = ch.cut_steps(0, np.arange(16), np.ones(16, np.int64))
    assert not drop1.any() and (cut1 == 1).all()
    cut0, drop0 = _chaos(tsched, tr, dropout_prob=0.0).cut_steps(
        0, np.arange(16), full)
    np.testing.assert_array_equal(cut0, full)
    assert not drop0.any()


def test_dark_windows_persist_and_cache():
    tr = tsched.uniform_trace(64)
    ch = _chaos(tsched, tr, unavail_prob=0.3, unavail_len=3)
    starts = {r: ch._u(tchaos._DARK_TAG, r) < 0.3 for r in range(8)}
    for rnd in range(5, 8):
        expect = np.zeros(64, bool)
        for r in range(rnd - 2, rnd + 1):
            expect |= starts[r]
        np.testing.assert_array_equal(ch.dark_mask(rnd), expect)
        np.testing.assert_array_equal(ch.dark_mask(rnd), ch.dark_mask(rnd))
    assert not _chaos(tsched, tr, unavail_prob=0.0).dark_mask(3).any()


def test_uplink_loss_is_bounded_by_max_retries():
    ch = _chaos(tsched, tsched.uniform_trace(8), uplink_loss_prob=1.0,
                max_retries=3)
    for cid in range(8):
        assert ch.uplink_lost(0, cid, 0) and ch.uplink_lost(0, cid, 2)
        assert not ch.uplink_lost(0, cid, 3)
        assert not ch.uplink_lost(0, cid, 7)


def test_corrupt_delta_and_check_delta_guard():
    """One NaN delta poisons an aggregate irreversibly; ``check_delta``
    catches it first, on plain and quantized trees. The poisoned leaf is
    the JAX package's (the first float leaf in sorted order)."""
    g = {"w": torch.zeros(4), "b": torch.zeros(2)}
    d = {"w": torch.ones(4), "b": torch.ones(2)}
    bad = tchaos.corrupt_delta(d)
    assert list(bad) == list(d)
    nan = [k for k, v in bad.items() if torch.isnan(v).any()]
    jbad = jchaos.corrupt_delta({k: jnp.asarray(v.numpy())
                                 for k, v in d.items()})
    assert nan == [k for k, v in jbad.items() if np.isnan(v).any()] == ["b"]
    assert torch.isnan(tserver.aggregate(g, [(1.0, bad), (1.0, d)])["b"]
                       ).any()
    assert tserver.delta_ok(d, g) and not tserver.delta_ok(bad, g)
    with pytest.raises(ValueError, match="non-finite"):
        tserver.check_delta(bad, g, ctx="client 0 delta")
    with pytest.raises(ValueError, match="shape"):
        tserver.check_delta({"w": torch.ones(5), "b": torch.ones(2)}, g)
    with pytest.raises(ValueError, match="leaves"):
        tserver.check_delta({"w": torch.ones(4)}, g)
    q = tquant.quantize_tree({"w": torch.ones(64, 64)}, bits=8, block=64,
                             min_size=0)
    qbad = tchaos.corrupt_delta(q)
    assert torch.isnan(qbad["w"].scales).all()
    assert torch.equal(qbad["w"].q, q["w"].q)
    assert not tserver.delta_ok(qbad)
    assert np.isnan(np.asarray(jchaos.corrupt_delta(jquant.quantize_tree(
        {"w": jnp.ones((64, 64))}, bits=8, mode="int", block=64,
        min_size=0))["w"].scales)).all()
    with pytest.raises(ValueError, match="no float leaf"):
        tchaos.corrupt_delta({"i": torch.ones(3, dtype=torch.int32)})


# -- partial-work recovery: masked scans cut at s are s steps ------------

@settings(max_examples=8, deadline=None)
@given(st.integers(0, 6), st.integers(0, 2 ** 16), st.booleans())
def test_cut_at_s_is_bitwise_running_s_steps_adam(s, seed, stacked):
    """``optim.step_mask``'s contract: a fixed-length masked
    ``adam_scan`` cut at step s (per client when stacked) is bitwise a
    scan of exactly s steps: params, both moments and the step
    counter."""
    S = 6
    rs = np.random.RandomState(seed)
    lead = (3,) if stacked else ()
    params = {"w": torch.from_numpy(rs.randn(*lead, 5).astype(np.float32))}
    xs = torch.from_numpy(rs.randn(S, *lead, 5).astype(np.float32))

    def grad_fn(p, x):
        return {"w": 2 * (p["w"] - x)}, torch.sum(p["w"])

    def run(xs_, active=None):
        return toptim.adam_scan(
            grad_fn, params, toptim.adam_init(params, stacked=stacked), xs_,
            lr=0.1, grad_clip=1.0, active=active, stacked=stacked)

    n = torch.tensor([s, max(s - 1, 0), min(s + 1, S)]) if stacked \
        else torch.tensor(s)
    p_cut, s_cut, _ = run(xs, toptim.step_mask(n, S))
    for c in range(3 if stacked else 1):
        k = int(n[c]) if stacked else s
        sl = (lambda t: t[c]) if stacked else (lambda t: t)
        p_ref, s_ref, _ = toptim.adam_scan(
            grad_fn, {"w": sl(params["w"])},
            toptim.adam_init({"w": sl(params["w"])}), xs[:k, c] if stacked
            else xs[:k], lr=0.1, grad_clip=1.0)
        assert torch.equal(sl(p_cut["w"]), p_ref["w"])
        assert torch.equal(sl(s_cut.step), s_ref.step)
        assert torch.equal(sl(s_cut.mu["w"]), s_ref.mu["w"])
        assert torch.equal(sl(s_cut.nu["w"]), s_ref.nu["w"])


@pytest.mark.parametrize("s", [0, 1, 3, 4])
def test_cut_at_s_is_bitwise_running_s_steps_gan(s):
    """The same contract for the bucketed GAN scan the fleet engine
    runs: cut at s, bitwise a scan of s steps, and the masked tail's
    inputs do not matter (the reference holds its shorter scan only to
    fp32 noise, since XLA compiles the two lengths apart)."""
    S, B, n_true = 4, 8, 5
    cfg = tgan.GANConfig(n_classes=3, z_dim=8, g_dim=8, d_dim=8)
    params = tgan.init_gan(torch.Generator().manual_seed(s), cfg,
                           device="cpu")
    opt = tgan.adam_init(params)
    rs = np.random.RandomState(s)
    images = torch.from_numpy(rs.randn(16, 32, 32, 3).astype(np.float32))
    labels = torch.zeros(16, dtype=torch.long)
    idx = torch.from_numpy(rs.randint(0, 16, (S, B)))
    z = torch.from_numpy(rs.randn(S, B, cfg.z_dim).astype(np.float32))
    z2 = torch.from_numpy(rs.randn(S, B, cfg.z_dim).astype(np.float32))
    mask = toptim.step_mask(s, S)
    cut = tgan.gan_scan_bucketed(params, opt, cfg, images, labels, idx, z,
                                 z2, n_true, active=mask)
    garb = tgan.gan_scan_bucketed(
        params, opt, cfg, images, labels, idx,
        torch.where(mask[:, None, None], z, 1e6),
        torch.where(mask[:, None, None], z2, -1e6), n_true, active=mask)
    ref = tgan.gan_scan_bucketed(params, opt, cfg, images, labels, idx[:s],
                                 z[:s], z2[:s], n_true) if s else (params, opt)
    state = lambda o: {k: (v.step, v.mu, v.nu) for k, v in o.items()}
    for other in (garb, ref):
        for a, b in zip(tree_lib.leaves((cut[0], state(cut[1]))),
                        tree_lib.leaves((other[0], state(other[1])))):
            assert torch.equal(a, b)


# -- scheduler-level chaos: parity, proration, retries --------------------

_CHAOS_KW = dict(dropout_prob=0.6, straggler_sigma=0.4,
                 uplink_loss_prob=0.4, corrupt_prob=0.0, max_retries=2)


def _run_sync(pkg, ex, g, *, policy="sync-partial", seed=11, rounds=3,
              k=2, **kw):
    tr = pkg.uniform_trace(N_CLIENTS)
    ch = _chaos(pkg, tr, seed, **kw)
    if policy == "full":
        sched = pkg.FullSyncScheduler(executor=ex, trace=tr,
                                      local_steps=STEPS, chaos=ch)
    else:
        sched = pkg.SyncPartialScheduler(executor=ex, trace=tr,
                                         local_steps=STEPS,
                                         clients_per_round=k, chaos=ch)
    log = []
    for rnd in range(rounds):
        g, m = sched.step(g, rnd, keys(rnd)[0 if pkg is jsched else 1])
        log.append(m)
    return g, log, ch.ledger.as_dict()


def _same_log(a, b):
    for ma, mb in zip(a, b):
        assert ma["vtime"] == mb["vtime"]
        assert list(ma["staleness"]) == list(mb["staleness"])
        assert_metrics(ma, mb)


@pytest.mark.parametrize("policy,kw", [
    ("sync-partial", _CHAOS_KW),
    ("full", dict(dropout_prob=0.5, unavail_prob=0.4, unavail_len=1))])
def test_sync_chaos_matches_jax_and_sequential_oracle(policy, kw):
    """Sync rounds under one fault schedule on the JAX draws: the
    stacked engine (masked scans), the port's sequential clients (fewer
    steps) and the JAX engine see the same faults: the same
    participation, virtual time, uplink bytes and ledger, and the
    globals at the oracle tolerance."""
    s = _setup()
    gc, log_c, led_c = _run_sync(tsched, s["cohort_t"], s["global_t"],
                                 policy=policy, **kw)
    gs, log_s, led_s = _run_sync(tsched, s["seq_t"], s["global_t"],
                                 policy=policy, **kw)
    gj, log_j, led_j = _run_sync(jsched, s["cohort_j"], s["global_j"],
                                 policy=policy, **kw)
    assert led_c == led_s == led_j
    assert led_c["n_dropped"] + led_c["uplinks_lost"] + \
        led_c["client_rounds_dark"] > 0
    _same_log(log_c, log_s)
    _same_log(log_c, log_j)
    assert_chain(gc, gs, s["global_t"])
    assert_chain(gc, gj, s["global_t"])


def _run_async(pkg, ex, g, clients, seed=3, rounds=4):
    tr = pkg.uniform_trace(N_CLIENTS)
    ch = _chaos(pkg, tr, seed, dropout_prob=0.4, straggler_sigma=0.5,
                uplink_loss_prob=0.5, max_retries=2)
    sched = pkg.AsyncBufferedScheduler(
        executor=ex, trace=tr, local_steps=STEPS, clients_per_round=1,
        staleness_beta=0.5, concurrency=2,
        client_n=[c.n for c in clients], chaos=ch)
    log = []
    for rnd in range(rounds):
        g, m = sched.step(g, rnd, keys(rnd)[0 if pkg is jsched else 1])
        log.append(m)
    return g, log, ch.ledger.as_dict()


def test_async_chaos_determinism_and_parity():
    """Async under chaos (dispatch-tagged faults, lost uplinks re-queued
    with backoff on the virtual clock): bitwise repeatable, and the
    stacked engine, the sequential clients and the JAX engine agree on
    participation, staleness, virtual time, bytes and ledger."""
    s = _setup()
    g1, log1, led1 = _run_async(tsched, s["cohort_t"], s["global_t"],
                                s["clients_t"])
    g2, log2, led2 = _run_async(tsched, s["cohort_t"], s["global_t"],
                                s["clients_t"])
    assert_trees(g1, g2, exact=True)
    assert led1 == led2
    gs, log_s, led_s = _run_async(tsched, s["seq_t"], s["global_t"],
                                  s["clients_t"])
    gj, log_j, led_j = _run_async(jsched, s["cohort_j"], s["global_j"],
                                  s["clients_j"])
    assert led1 == led_s == led_j
    assert led1["uplinks_lost"] > 0 and led1["n_retries"] > 0
    for other in (log2, log_s, log_j):
        _same_log(log1, other)
    assert_chain(g1, gs, s["global_t"])
    assert_chain(g1, gj, s["global_t"])


def test_sync_chaos_commit_weights_are_prorated():
    """A dropped client's delta commits with its mass scaled by its
    completed-step fraction: the chaos step is bitwise a hand-built wave
    + ``commit_buffer`` with cut/full-prorated, renormalized masses."""
    s = _setup()
    tr = tsched.uniform_trace(N_CLIENTS)
    _, key = keys(21)
    mk = lambda ch: tsched.SyncPartialScheduler(
        executor=s["cohort_t"], trace=tr, local_steps=STEPS,
        clients_per_round=3, chaos=ch)
    got, m = mk(_chaos(tsched, tr, 9, dropout_prob=0.7)).step(
        s["global_t"], 0, key)
    ch = _chaos(tsched, tr, 9, dropout_prob=0.7)
    cohort = mk(ch).select(0, key)
    full = np.asarray(cohort.n_steps, np.int64)
    cut, dropped = ch.cut_steps(0, cohort.sel, full)
    assert dropped.any()
    deltas, _ = s["cohort_t"].run_wave(
        s["global_t"], tsched.Cohort(cohort.sel, cut.astype(np.int32),
                                     cohort.staleness), key)
    w = s["cohort_t"].client_masses()[cohort.sel] * (cut / full)
    ref = s["cohort_t"].commit_buffer(
        s["global_t"], (w / w.sum()).astype(np.float32), deltas)
    assert_trees(got, ref, exact=True)
    assert list(m["participation"]) == list(cohort.sel)


def test_sync_lost_uplink_retries_next_round_and_delivers():
    """Every client loses attempts 0 and 1 (re-selected first each next
    round, nothing committed); the attempt at ``max_retries`` is forced
    through."""
    s = _setup()
    g, log, led = _run_sync(tsched, s["cohort_t"], s["global_t"], seed=1,
                            uplink_loss_prob=1.0, max_retries=2)
    parts = [list(m["participation"]) for m in log]
    assert parts[0] == [] and parts[1] == [] and len(parts[2]) == 2
    assert (led["commits_skipped"], led["uplinks_lost"],
            led["n_retries"]) == (2, 4, 4)
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(g), tree_lib.leaves(s["global_t"])))


def test_strict_mode_raises_on_corrupt_uplink():
    s = _setup()
    with pytest.raises(ValueError, match="non-finite"):
        _run_sync(tsched, s["cohort_t"], s["global_t"], seed=2, rounds=1,
                  corrupt_prob=1.0, tolerate_corrupt=False)
    g, log, led = _run_sync(tsched, s["cohort_t"], s["global_t"], seed=2,
                            rounds=1, corrupt_prob=1.0)
    assert (led["deltas_corrupt"], led["deltas_skipped"],
            led["commits_skipped"]) == (2, 2, 1)
    assert list(log[0]["participation"]) == []
    assert_trees(g, s["global_t"], exact=True)
