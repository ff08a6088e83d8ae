"""The port's ``run_federated`` under the scheduler layer against the JAX
package's, on the CPU at ``tests/test_sched.py``'s and
``tests/test_chaos.py``'s simulator sizes (pacs, 4 clients, 3 rounds of 3
local steps of 8, 12 a class; the tiny default CLIPConfig), the
``fedclip`` arm, with the JAX package's draws injected
(``tests/_jax_sched_stream.py``) and the port on the JAX package's
pretrained backbone, so what is compared is the rounds themselves.

Held exactly: who committed when (participation, staleness, virtual
time), the per-device-class columns, the uplink bytes, the fault ledger,
the chaos and fairness meta, the meta keys. Losses within ``LOSS_TOL``
relative per History entry (measured worst printed), accuracies within
one sample. Within the port: pipelined == barrier bitwise with one
counted host sync, two chaos runs bitwise, the cohort engine against the
sequential one at ``tests/test_chaos.py``'s tolerances."""
import dataclasses

import numpy as np
import pytest
import torch

from _jax_sched_stream import LOSS_ATOL, LOSS_RTOL, on_jax_backbone
from repro.fl import runtime as jruntime
from repro_torch.fl import sched as tsched
from repro_torch.fl import simulator as tsim

torch.set_num_threads(2)
SIM = dict(dataset="pacs", strategy="fedclip", n_clients=4, rounds=3,
           local_steps=3, n_per_class=12, batch_size=8, lr=3e-3)
LOSS_TOL = 1e-5
CHAOS = tsched.ChaosConfig(dropout_prob=0.5, straggler_sigma=0.5,
                           uplink_loss_prob=0.5, max_retries=2)
EXACT = ("rounds", "participation", "staleness", "vtime", "class_counts",
         "class_staleness", "uplink_bytes")
EXACT_META = ("participation", "clients_per_round", "trace",
              "staleness_beta", "device_classes", "prepared_rounds",
              "n_clients_active", "chaos", "fault_ledger",
              "device_class_report")


@pytest.fixture(scope="module")
def jax_runtime():
    """One JAX program runtime for the module's runs (shared compiles)."""
    return jruntime.ProgramRuntime()


def _check(want, got):
    for f in EXACT:
        assert getattr(got, f) == getattr(want, f), f
    assert set(got.meta) == set(want.meta)
    for k in EXACT_META:
        if k in want.meta and k != "device_class_report":
            assert got.meta[k] == want.meta[k], k
    if "device_class_report" in want.meta:
        for a, b in zip(got.meta["device_class_report"],
                        want.meta["device_class_report"]):
            assert a.keys() == b.keys()
            for k in ("device_class", "population_share",
                      "participation_share", "mean_staleness"):
                assert a[k] == b[k], k
            assert abs(a["mean_client_acc"] - b["mean_client_acc"]) <= \
                1.0 / SIM["batch_size"] + 1e-9
    rel = lambda a, b: np.max(np.abs(np.subtract(a, b)) /
                              np.maximum(np.abs(b), 1e-12))
    worst = {"client_loss": max([float(rel(a, b)) for a, b in zip(
        got.client_loss, want.client_loss) if len(b)] or [0.0]),
        "server_loss": float(rel(got.server_loss, want.server_loss))}
    print(f"worst relative loss differences {worst}")
    assert max(worst.values()) <= LOSS_TOL, worst
    for a, b in zip(got.client_acc, want.client_acc):
        np.testing.assert_allclose(a, b, atol=1.0 / SIM["batch_size"] + 1e-9)
    np.testing.assert_allclose(got.server_acc, want.server_acc,
                               atol=1.0 / 140 + 1e-9)


@pytest.fixture(scope="module")
def trace_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "diurnal.json"
    tsched.save_trace(tsched.diurnal_trace(4, seed=3, max_step_mult=2), path)
    return str(path)


CASES = {
    "sync-partial": dict(participation="sync-partial", clients_per_round=2,
                         trace="skewed"),
    "async": dict(participation="async", clients_per_round=1,
                  async_concurrency=2, trace="diurnal"),
    "sync-partial-chaos": dict(participation="sync-partial",
                               clients_per_round=2, trace="skewed",
                               chaos=CHAOS),
    "async-chaos": dict(participation="async", clients_per_round=1,
                        async_concurrency=2, trace="diurnal",
                        chaos=dataclasses.replace(
                            CHAOS, dropout_prob=0.0, uplink_loss_prob=0.4,
                            class_mult=(1.0, 2.0, 4.0))),
    "full-heavy": dict(participation="full", trace="uniform",
                       chaos="heavy"),
    "file-trace-light": dict(participation="sync-partial",
                             clients_per_round=3, chaos="light"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_history_matches_jax(jax_runtime, trace_file, case):
    """Each policy, with and without chaos, on a seeded trace or a trace
    file (with step multipliers), against the JAX package's run."""
    kw = dict(SIM, **CASES[case])
    if case == "file-trace-light":
        kw["trace"] = trace_file
    want, got = on_jax_backbone(runtime=jax_runtime, **kw)
    _check(want, got)
    if case != "async-chaos":     # there: stragglers, no counted fault
        assert ("chaos" in kw) == (
            sum(got.meta.get("fault_ledger", {}).values()) > 0)


def test_chaos_run_is_bit_deterministic_with_one_wave_program():
    """A seeded chaos run is bitwise repeatable, reports a non-empty
    ledger and runs one wave program (the masked one, ``force_het``):
    chaos adds no program kind and never takes the fault-free path."""
    cfg = tsim.FLConfig(**SIM, **CASES["sync-partial-chaos"])
    h1 = tsim.run_federated(cfg, device="cpu")
    h2 = tsim.run_federated(cfg, device="cpu")
    for f in dataclasses.fields(tsim.History):
        if f.name not in ("round_time_s", "meta"):
            assert getattr(h1, f.name) == getattr(h2, f.name), f.name
    assert h1.meta["fault_ledger"] == h2.meta["fault_ledger"]
    assert sum(h1.meta["fault_ledger"].values()) > 0
    kinds = h1.meta["n_compiles_by_kind"]
    assert kinds.get("wave_round") == 1 and "subset_round" not in kinds
    assert h1.meta["chaos"]["dropout_prob"] == 0.5
    assert all(b > a for a, b in zip(h1.vtime, h1.vtime[1:]))
    assert h1.meta["n_cache_evictions"] == 0


@pytest.mark.parametrize("case", ["sync-partial", "async", "async-chaos"])
def test_pipelined_is_barrier_and_cohort_is_sequential(case):
    """Within the port: pipelined == barrier bitwise, with one counted
    host sync (the final flush) and the fault-free sync-partial
    selections pre-drawn; the cohort engine against the sequential one
    (participation, staleness, virtual time, bytes, ledger exactly;
    losses at the oracle tolerance)."""
    cfg = tsim.FLConfig(**SIM, **CASES[case])
    pipe = tsim.run_federated(cfg, device="cpu")
    bar = tsim.run_federated(dataclasses.replace(cfg, pipeline="barrier"),
                             device="cpu")
    seq = tsim.run_federated(dataclasses.replace(cfg, engine="sequential"),
                             device="cpu")
    for f in dataclasses.fields(tsim.History):
        if f.name not in ("round_time_s", "meta"):
            assert getattr(pipe, f.name) == getattr(bar, f.name), f.name
    assert pipe.meta["sync_counts"] == {"metrics_flush": 1}
    assert pipe.meta["prepared_rounds"] == (
        SIM["rounds"] if case == "sync-partial" else 0)
    for f in ("participation", "staleness", "vtime", "uplink_bytes"):
        assert getattr(seq, f) == getattr(pipe, f), f
    assert seq.meta.get("fault_ledger") == pipe.meta.get("fault_ledger")
    for a, b in zip(pipe.client_loss, seq.client_loss):
        np.testing.assert_allclose(a, b, atol=LOSS_ATOL, rtol=LOSS_RTOL)
    kinds = pipe.meta["n_compiles_by_kind"]
    assert kinds.get("subset_round" if case == "sync-partial"
                     else "wave_round") == 1
    assert "full_round" not in kinds
