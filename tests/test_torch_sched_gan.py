"""The ``tripleplay`` arm (client-side GAN rebalancing) under the
scheduler layer: the port's ``run_federated`` against the JAX package's,
on the CPU at the simulator tests' size (pacs, 4 clients, 12 a class, 3
local steps of 8, 4 GAN steps), with the JAX package's draws injected
(``tests/_jax_sched_stream.py``, the GAN's through
``tests/_jax_gan_stream.py``) and the port on the JAX package's
pretrained backbone. The JAX runs share one program runtime, so the
fleet GAN compiles once.

Held exactly: participation, staleness, virtual time, the per-class
columns, uplink bytes, the fault ledger (``gan_dropped`` included) and
the GAN meta counts. Losses within ``LOSS_TOL`` relative (measured
worst 7.8e-6: the trained generators agree to the fleet engine's 2e-3,
not bitwise, so the synthetic rows differ slightly, but the rounds on
them agree this closely), accuracies within one sample.
Under chaos the clients drawn by ``gan_dropouts`` deliver no rows: the
fleet job discards them and the sequential GAN engine never trains
them, and the two GAN engines agree (within ``GAN_ENGINE_TOL``, as
``tests/test_torch_simulator.py`` holds the two engines)."""
import numpy as np
import pytest
import torch

from _jax_sched_stream import on_jax_backbone
from repro.fl import runtime as jruntime
from repro_torch.fl import sched as tsched
from repro_torch.fl import simulator as tsim

torch.set_num_threads(2)
SIM = dict(dataset="pacs", strategy="tripleplay", n_clients=4, rounds=3,
           local_steps=3, n_per_class=12, batch_size=8, lr=3e-3,
           gan_steps=4)
LOSS_TOL, GAN_ENGINE_TOL = 1e-5, 1e-3
GAN_META = ("gan_engine", "gan_eligible", "gan_synth", "gan_groups")
CASES = {
    "async": dict(participation="async", clients_per_round=2,
                  trace="skewed"),
    "sync-partial-heavy": dict(participation="sync-partial",
                               clients_per_round=3, trace="diurnal",
                               chaos="heavy"),
    "full-gan-drop": dict(participation="full", rounds=1,
                          chaos=tsched.ChaosConfig(dropout_prob=0.9)),
}


@pytest.fixture(scope="module")
def jax_runtime():
    return jruntime.ProgramRuntime()


def _rel(a, b):
    return float(np.max(np.abs(np.subtract(a, b)) /
                        np.maximum(np.abs(b), 1e-12)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tripleplay_history_matches_jax(jax_runtime, case):
    kw = {**SIM, **CASES[case]}
    want, got = on_jax_backbone(runtime=jax_runtime, **kw)
    for f in ("rounds", "participation", "staleness", "vtime",
              "class_counts", "uplink_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert set(got.meta) == set(want.meta)
    for k in GAN_META + ("participation", "clients_per_round", "trace",
                         "prepared_rounds"):
        assert got.meta[k] == want.meta[k], k
    assert got.meta.get("fault_ledger") == want.meta.get("fault_ledger")
    worst = max(_rel(a, b) for a, b in zip(
        got.client_loss + [got.server_loss],
        want.client_loss + [want.server_loss]) if len(b))
    print(f"{case}: worst relative loss difference {worst}")
    assert worst <= LOSS_TOL
    np.testing.assert_allclose(got.server_acc, want.server_acc,
                               atol=1.0 / 140 + 1e-9)
    if case == "full-gan-drop":
        assert got.meta["fault_ledger"]["gan_dropped"] > 0


def test_gan_drop_is_engine_independent():
    """The GAN drop is drawn once a run: the fleet GAN engine (its job
    discards the dropped clients' rows) and the sequential one (which
    skips their ``prepare_gan``) count the same drops, train the same
    eligible rest, and give the same rounds."""
    cfg = tsim.FLConfig(**{**SIM, **CASES["full-gan-drop"]})
    fleet = tsim.run_federated(cfg, device="cpu")
    seq = tsim.run_federated(
        tsim.FLConfig(**{**SIM, **CASES["full-gan-drop"],
                         "gan_engine": "sequential"}), device="cpu")
    led = fleet.meta["fault_ledger"]
    assert led == seq.meta["fault_ledger"] and led["gan_dropped"] > 0
    assert fleet.meta["gan_eligible"] - led["gan_dropped"] == \
        seq.meta["gan_eligible"]
    assert fleet.participation == seq.participation
    for a, b in zip(fleet.client_loss, seq.client_loss):
        np.testing.assert_allclose(a, b, rtol=GAN_ENGINE_TOL)
