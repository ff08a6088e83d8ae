"""The port's scheduler layer (``fl.sched`` traces and policies, the
cohort engine's subset rounds and waves) against the JAX package's, on
the CPU at ``tests/test_sched.py``'s sizes (3 clients of pacs, 12 a
class, 4 local steps of 8, the tiny default CLIPConfig), with the JAX
package's draws injected (``tests/_jax_sched_stream.py``): batch
indices, selections and async jitter at the same ``fold_in`` paths.

Tolerances: traces (numpy-only), selections, participation, staleness,
virtual time and uplink bytes exactly; trained leaves, losses and
accuracies at ``tests/test_sched.py``'s oracle tolerances (leaves atol
5e-4, loss atol 1e-3 / rtol 1e-4, accuracy 1e-5; after chained commits
the two ReLU-gated adapter leaves in norm, ``assert_chain``); within the
port the K = N subset round is bitwise the full round, and two async
runs bitwise each other. ``run_federated`` is held in
``tests/test_torch_sched_run.py``."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from _jax_sched_stream import (JaxDraws, assert_chain, assert_metrics,
                               assert_trees, fl_setup, keys)
from repro.fl import sched as jsched
from repro_torch import tree as tree_lib
from repro_torch.fl import cohort as tcohort
from repro_torch.fl import runtime as truntime
from repro_torch.fl import sched as tsched
from repro_torch.fl import server as tserver
from repro_torch.fl.strategies import MAX_STEP_MULT

torch.set_num_threads(2)
N_CLIENTS = 3
STEPS = 4


def _setup(arm, step_mult=None):
    return fl_setup(arm, n_clients=N_CLIENTS, steps=STEPS,
                    step_mult=step_mult)


def _trace(pkg, n=N_CLIENTS, step_mult=None):
    base = pkg.uniform_trace(n)
    return pkg.AvailabilityTrace(
        availability=base.availability, speed=base.speed,
        step_mult=base.step_mult if step_mult is None
        else np.asarray(step_mult, np.int32))

# -- traces: numpy-only, bitwise ------------------------------------------

@pytest.mark.parametrize("spec,n,seed", [
    ("uniform", 5, 0), ("skewed", 8, 3), ("skewed", 10, 0),
    ("skewed-het", 64, 1), ("diurnal", 12, 4), ("diurnal", 8, 0)])
def test_traces_are_the_jax_traces_bitwise(spec, n, seed):
    got = tsched.resolve_trace(spec, n, seed=seed)
    want = jsched.resolve_trace(spec, n, seed=seed)
    for f in ("availability", "speed", "step_mult", "device_class",
              "phase"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.name, got.period, got.amplitude, got.n_device_classes) == (
        want.name, want.period, want.amplitude, want.n_device_classes)
    for t in (0.0, 5.5, 13.0):
        np.testing.assert_array_equal(got.availability_at(t),
                                      want.availability_at(t))
        np.testing.assert_array_equal(got.selection_probs(t),
                                      want.selection_probs(t))


def test_trace_files_round_trip_between_packages(tmp_path):
    tr = tsched.diurnal_trace(12, seed=4, max_step_mult=3)
    tsched.save_trace(tr, tmp_path / "port.json")
    jsched.save_trace(jsched.diurnal_trace(12, seed=4, max_step_mult=3),
                      tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    for got in (tsched.load_trace(tmp_path / "jax.json"),
                tsched.resolve_trace(str(tmp_path / "port.json"), 12)):
        for f in ("availability", "speed", "step_mult", "device_class",
                  "phase"):
            np.testing.assert_array_equal(getattr(got, f), getattr(tr, f))
        assert (got.period, got.amplitude) == (tr.period, tr.amplitude)
    with pytest.raises(ValueError):
        tsched.resolve_trace(str(tmp_path / "port.json"), 5)
    with pytest.raises(ValueError):
        tsched.resolve_trace(tr, 4)
    with pytest.raises(ValueError):
        tsched.resolve_trace("zipf", 4)
    with pytest.raises(ValueError):
        tsched.AvailabilityTrace(availability=np.ones(2), speed=np.ones(2),
                                 step_mult=np.array([1, MAX_STEP_MULT + 1]))
    with pytest.raises(ValueError):
        tsched.AvailabilityTrace(availability=np.ones(2), speed=np.ones(2),
                                 step_mult=np.ones(2, np.int32),
                                 amplitude=1.0, period=10.0)


def test_staleness_weights_match_jax_and_beta0_is_fedavg():
    m = np.array([10, 30, 60], np.float64)
    tau = np.array([0, 2, 5], np.float64)
    for beta in (0.0, 0.5, 0.7):
        got = tsched.staleness_weights(m, tau, beta)
        np.testing.assert_array_equal(
            got, jsched.staleness_weights(m, tau, beta))
    np.testing.assert_allclose(tsched.staleness_weights(m, tau, 0.0),
                               m / m.sum(), rtol=1e-6)
    w = tsched.staleness_weights([1, 1, 1], [0, 1, 3], beta=0.7)
    assert w[0] > w[1] > w[2]
    with pytest.raises(ValueError):
        tsched.staleness_weights([0.0, 0.0], [0, 0], beta=0.5)


# -- subset rounds and waves against the JAX engine -----------------------

@pytest.mark.parametrize("arm", ["fedclip", "tripleplay"])
def test_sync_partial_matches_jax_engine_and_sequential_oracle(arm):
    """One K=2 sync-partial round on the JAX draws (the selection from
    ``fold_in(key, 101)``, batches from the key): the port's stacked
    engine against the JAX engine, and against the port's sequential
    clients restricted to the subset."""
    s = _setup(arm)
    kj, kt = keys(7)
    mk = lambda pkg, ex: pkg.SyncPartialScheduler(
        executor=ex, trace=_trace(pkg), local_steps=STEPS,
        clients_per_round=2)
    new_j, mj = mk(jsched, s["cohort_j"]).step(s["global_j"], 0, kj)
    new_t, mt = mk(tsched, s["cohort_t"]).step(s["global_t"], 0, kt)
    new_s, ms = mk(tsched, s["seq_t"]).step(s["global_t"], 0, kt)
    assert_metrics(mt, mj)
    assert_trees(new_t, new_j)
    assert_metrics(mt, ms)
    assert_trees(new_t, new_s)


def test_sync_partial_at_K_N_reproduces_full_round_exactly():
    """K=N with a uniform trace selects the identity cohort with the
    full round's batch key: the subset program (the gather of every row
    and the same math) is bitwise the full round, as is the full-sync
    policy; and the round is the JAX package's at the oracle
    tolerances."""
    s = _setup("fedclip")
    kj, kt = keys(11)
    ref, mref = s["eng_t"].run_round(s["global_t"], kt)
    partial = tsched.SyncPartialScheduler(
        executor=s["cohort_t"], trace=_trace(tsched), local_steps=STEPS,
        clients_per_round=N_CLIENTS)
    full = tsched.FullSyncScheduler(executor=s["cohort_t"],
                                    trace=_trace(tsched), local_steps=STEPS)
    for sched in (partial, full):
        new, m = sched.step(s["global_t"], 0, kt)
        assert_trees(new, ref, exact=True)
        assert torch.equal(m["loss"], mref["loss"])
        assert torch.equal(m["acc"], mref["acc"])
        assert m["uplink_bytes"] == mref["uplink_bytes"]
        assert list(m["participation"]) == list(range(N_CLIENTS))
    want, _ = s["eng_j"].run_round(s["global_j"], kj)
    assert_trees(ref, want)


def test_uplink_accounting_under_partial_participation():
    """Uplink bytes are exactly K x the per-client quantized payload (the
    quantization is leading-axis-inert), as the JAX package counts."""
    s = _setup("tripleplay")
    per_client = s["eng_t"].per_client_uplink_bytes(s["global_t"])
    assert per_client == s["eng_j"].per_client_uplink_bytes(s["global_j"])
    for k in (1, 2, 3):
        kj, kt = keys(k)
        mk = lambda pkg, ex: pkg.SyncPartialScheduler(
            executor=ex, trace=_trace(pkg), local_steps=STEPS,
            clients_per_round=k)
        _, mt = mk(tsched, s["cohort_t"]).step(s["global_t"], 0, kt)
        _, mj = mk(jsched, s["cohort_j"]).step(s["global_j"], 0, kj)
        assert mt["uplink_bytes"] == k * per_client == int(mj["uplink_bytes"])
        assert list(mt["participation"]) == list(mj["participation"])
        assert len(mt["participation"]) == len(mt["loss"]) == k


def test_bucketed_subset_pads_with_zero_weight():
    """K=1 of 3 runs at the width bucket 3: the pad rows train on client
    0's pool but carry weight 0, so the subset round is bitwise the
    wave's one true delta committed alone, and the metrics are sliced to
    K."""
    s = _setup("fedclip")
    _, kt = keys(5)
    assert truntime.bucket_width(1, N_CLIENTS) == N_CLIENTS
    new, m = s["eng_t"].run_subset_round(s["global_t"], [2], kt)
    delta, mw = s["eng_t"].run_wave(s["global_t"], [2], kt)
    assert tree_lib.leaves(delta)[0].shape[0] == N_CLIENTS
    assert m["loss"].shape == mw["loss"].shape == (1,)
    assert torch.equal(m["loss"], mw["loss"])
    ref = s["cohort_t"].commit_buffer(
        s["global_t"], np.ones(1, np.float32),
        [tcohort.slice_client_delta(delta, 0)])
    assert_trees(new, ref, exact=True)


def _async(pkg, ex, trace, clients, **kw):
    return pkg.AsyncBufferedScheduler(
        executor=ex, trace=trace, local_steps=STEPS, clients_per_round=1,
        staleness_beta=0.5, concurrency=2,
        client_n=[c.n for c in clients], **kw)


def test_async_matches_jax_and_is_bit_deterministic():
    """Async (skewed trace, buffer 1, concurrency 2), 4 commits on the
    JAX draws (selection 101/102, dispatch keys 103/104, jitter 107):
    participation, staleness and virtual commit times equal to the JAX
    package's; the trained globals at the oracle tolerance (the
    ReLU-gated leaves in norm, ``_assert_chain``); two port runs bitwise
    each other."""
    s = _setup("fedclip")

    def run(pkg, ex, g, keyf):
        sched = _async(pkg, ex, pkg.skewed_trace(N_CLIENTS, seed=5),
                       s["clients_t"])
        log = []
        for rnd in range(4):
            g, m = sched.step(g, rnd, keyf(rnd))
            log.append((list(m["participation"]), list(m["staleness"]),
                        m["vtime"], int(m["uplink_bytes"])))
        return g, log

    g1, log1 = run(tsched, s["cohort_t"], s["global_t"],
                   lambda r: keys(r)[1])
    g2, log2 = run(tsched, s["cohort_t"], s["global_t"],
                   lambda r: keys(r)[1])
    gj, logj = run(jsched, s["cohort_j"], s["global_j"],
                   lambda r: keys(r)[0])
    assert log1 == log2 == logj
    assert_trees(g1, g2, exact=True)
    assert_chain(g1, gj, s["global_t"])
    assert any(t > 0 for (_, taus, _, _) in log1 for t in taus)


def test_async_rotates_through_idle_population():
    """Freed slots back-fill from the idle clients, so clients outside
    the first draw rotate in; the sequence is the JAX package's."""
    s = _setup("fedclip")
    seen, parts = set(), {}
    for pkg, ex, g in ((tsched, s["cohort_t"], s["global_t"]),
                       (jsched, s["cohort_j"], s["global_j"])):
        sched = _async(pkg, ex, pkg.skewed_trace(N_CLIENTS, seed=2),
                       s["clients_t"])
        parts[pkg] = []
        for rnd in range(8):
            g, m = sched.step(g, rnd, keys(rnd)[0 if pkg is jsched else 1])
            parts[pkg].append([int(c) for c in m["participation"]])
        seen.update(c for p in parts[pkg] for c in p)
    assert parts[tsched] == parts[jsched]
    assert seen == set(range(N_CLIENTS))


def test_async_beta0_commit_equals_fedavg_aggregate():
    """A β=0 buffer commit is sample-count FedAvg over the buffered
    deltas: the stacked commit equals ``server.aggregate`` and the JAX
    package's commit."""
    s = _setup("fedclip")
    kj, kt = keys(3)
    mk = lambda pkg: pkg.Cohort(sel=np.array([0, 2], np.int32),
                                n_steps=np.full(2, STEPS, np.int32),
                                staleness=np.array([3, 1], np.int32))
    deltas, _ = s["cohort_t"].run_wave(s["global_t"], mk(tsched), kt)
    masses = [s["clients_t"][0].n, s["clients_t"][2].n]
    w0 = tsched.staleness_weights(masses, [3, 1], beta=0.0)
    got = s["cohort_t"].commit_buffer(s["global_t"], w0, deltas)
    assert_trees(got, tserver.aggregate(s["global_t"],
                                         list(zip(masses, deltas))),
                  atol=1e-6)
    assert_trees(got, s["seq_t"].commit_buffer(s["global_t"], w0, deltas),
                  atol=1e-6)
    deltas_j, _ = s["cohort_j"].run_wave(s["global_j"], mk(jsched), kj)
    assert_trees(got, s["cohort_j"].commit_buffer(s["global_j"], w0,
                                                   deltas_j))


def test_heterogeneous_local_steps_parity():
    """Step multipliers [2, 1, 1]: the stacked program masks the tail of
    its fixed-length scan per client, the sequential clients run fewer
    steps, the JAX engine masks its scan; all three agree."""
    mult = [2, 1, 1]
    s = _setup("fedclip", step_mult=mult)
    assert s["eng_t"].max_steps == STEPS * 2
    kj, kt = keys(9)
    mk = lambda pkg, ex: pkg.FullSyncScheduler(
        executor=ex, trace=_trace(pkg, step_mult=mult), local_steps=STEPS)
    new_t, mt = mk(tsched, s["cohort_t"]).step(s["global_t"], 0, kt)
    new_s, ms = mk(tsched, s["seq_t"]).step(s["global_t"], 0, kt)
    new_j, mj = mk(jsched, s["cohort_j"]).step(s["global_j"], 0, kj)
    assert_metrics(mt, ms)
    assert_trees(new_t, new_s)
    assert_metrics(mt, mj)
    assert_trees(new_t, new_j)


def test_engine_rejects_untraced_heterogeneity():
    s = _setup("fedclip")       # staged with every step_mult == 1
    sched = tsched.FullSyncScheduler(
        executor=s["cohort_t"], trace=_trace(tsched, step_mult=[2, 1, 1]),
        local_steps=STEPS)
    with pytest.raises(ValueError, match="staged homogeneous|outside \\[1,"):
        sched.step(s["global_t"], 0, keys(0)[1])


def test_sequential_rejects_untraced_heterogeneity():
    s = _setup("fedclip")
    sched = tsched.FullSyncScheduler(
        executor=s["seq_t"], trace=_trace(tsched, step_mult=[2, 1, 1]),
        local_steps=STEPS)
    with pytest.raises(ValueError, match="exceed the staged maximum"):
        sched.step(s["global_t"], 0, keys(0)[1])


def test_run_round_rejects_heterogeneous_engine():
    s = _setup("fedclip", step_mult=[2, 1, 1])
    with pytest.raises(ValueError, match="homogeneous"):
        s["eng_t"].run_round(s["global_t"], keys(0)[1])


def test_policy_factory_refusals():
    with pytest.raises(ValueError, match="meaningless"):
        tsched.make_scheduler("full", executor=None, trace=_trace(tsched),
                              local_steps=STEPS, clients_per_round=2)
    with pytest.raises(ValueError, match="client_n"):
        tsched.make_scheduler("async", executor=None, trace=_trace(tsched),
                              local_steps=STEPS)
    with pytest.raises(ValueError, match="below buffer"):
        tsched.make_scheduler("async", executor=None, trace=_trace(tsched),
                              local_steps=STEPS, clients_per_round=2,
                              concurrency=1, client_n=[1, 2, 3])
    with pytest.raises(ValueError, match="unknown participation"):
        tsched.make_scheduler("lottery", executor=None,
                              trace=_trace(tsched), local_steps=STEPS)


def test_injected_draws_are_checked():
    """A draw that cannot be served, or that breaks its contract, raises
    where it is taken."""
    good = JaxDraws(jax.random.PRNGKey(0))
    bad = {"choice": lambda path, n, k, p: np.zeros(k, np.int64),
           "uniform": lambda path, n: np.full(n, 1.5, np.float32),
           "normal": lambda path, n: np.zeros(n, np.float64)}
    for kind, fn in bad.items():
        draws = SimpleNamespace()
        key = tcohort.RoundKey(draws, (1,))
        with pytest.raises(ValueError, match="cannot serve"):
            getattr(key, kind)(*((3, 2, [0.2, 0.3, 0.5]) if kind == "choice"
                                 else (3,)))
        setattr(draws, kind, fn)
        with pytest.raises(ValueError):
            getattr(key, kind)(*((3, 2, [0.2, 0.3, 0.5]) if kind == "choice"
                                 else (3,)))
    key = tcohort.RoundKey(good, (3, 1)).fold(101)
    assert key.path == (3, 1, 101)
    np.testing.assert_array_equal(
        key.uniform(6), np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(0), 3), 1), 101), (6,))))
