"""The port's fleet-GAN engine (``fl.fleetgan``) against its sequential
oracle (``Client.prepare_gan``) and against the JAX package's fleet
engine with the JAX package's draws injected, on the CPU at the JAX
tests' sizes (pacs, 30 a class, longtail_gamma 4; 10 GAN steps).

Held as ``tests/test_fleetgan.py`` holds the reference: rebalancing
labels and the staged pool layout bitwise, generator leaves within 2e-3
and synthesized images within 5e-3 (Adam turns fp32 noise on near-zero
gradients into lr-sized moves, so trained params are not bitwise across
two computations of one step)."""
import numpy as np
import pytest
import torch

import jax

from _jax_gan_stream import JaxGANStream
from repro.data.synthetic import make_dataset as jmake_dataset
from repro.data.synthetic import stage_client_pools as jstage
from repro.fl import client as jclient
from repro.fl import fleetgan as jfleet
from repro.fl.strategies import STRATEGIES as JSTRATEGIES
from repro_torch import tree as tree_lib
from repro_torch.core import clip as tclip
from repro_torch.core import gan as tgan
from repro_torch.data.synthetic import make_dataset, stage_client_pools
from repro_torch.fl import client as tclient
from repro_torch.fl import cohort as tcohort
from repro_torch.fl import fleetgan
from repro_torch.fl import runtime as truntime
from repro_torch.fl import strategies as tstrategies
from repro_torch.fl.strategies import STRATEGIES

torch.set_num_threads(2)
MIN = tstrategies.GAN_MIN_POOL
GEN_ATOL, IMG_ATOL = 2e-3, 5e-3


def _mk_clients(sizes, *, strategy="tripleplay", mod=None):
    """Clients holding consecutive slices of one dataset (the reference
    test's construction), as port clients or, with ``mod``, JAX ones."""
    lib = mod or tclient
    data = (jmake_dataset if mod else make_dataset)(
        "pacs", n_per_class=30, seed=0, longtail_gamma=4.0)
    strat = (JSTRATEGIES if mod else STRATEGIES)[strategy]
    out, start = [], 0
    for i, n in enumerate(sizes):
        sl = slice(start, start + n)
        start += n
        out.append(lib.Client(cid=i, images=data["images"][sl],
                              labels=data["labels"][sl],
                              n_classes=data["spec"].n_classes,
                              strategy=strat))
    return out


def _streams(n, base=100):
    return [tgan.SeededGANStream((0, base + i)) for i in range(n)]


def _fleet(clients, streams, **kw):
    return fleetgan.prepare_gan_fleet(clients, streams, device="cpu", **kw)


def _gen_leaves(params):
    return {tree_lib.path_str(p): np.asarray(
        l.numpy() if isinstance(l, torch.Tensor) else l)
        for p, l in tree_lib.flatten_with_path(params["gen"])}


def _assert_like(A, B, err=""):
    """B's GAN results held to A's: eligibility, labels and pool layout
    bitwise, generator leaves and images at the reference's bounds."""
    for i, (a, b) in enumerate(zip(A, B)):
        if a.n < MIN:
            assert a.gan_params is None and b.gan_params is None
            assert b.aug_images is None and b.aug_labels is None
            continue
        np.testing.assert_array_equal(a.aug_labels, b.aug_labels,
                                      err_msg=f"{err}client {i} labels")
        ga, gb = _gen_leaves(a.gan_params), _gen_leaves(b.gan_params)
        assert ga.keys() == gb.keys()
        for k in ga:
            np.testing.assert_allclose(ga[k], gb[k], atol=GEN_ATOL, rtol=0,
                                       err_msg=f"{err}client {i} gen/{k}")
        if len(a.aug_labels):
            np.testing.assert_allclose(a.aug_images, b.aug_images,
                                       atol=IMG_ATOL, rtol=0,
                                       err_msg=f"{err}client {i} images")
    ia, la, na = stage_client_pools([c.pool() for c in A])
    ib, lb, nb = stage_client_pools([c.pool() for c in B])
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(na, nb)
    for i, c in enumerate(A):
        np.testing.assert_array_equal(ia[i, :c.n], ib[i, :c.n])
    np.testing.assert_allclose(ia, ib, atol=IMG_ATOL, rtol=0)


@pytest.mark.parametrize("sizes", [(24, 24, 24), (40, 21, 5)],
                         ids=["uniform", "skewed"])
def test_fleet_matches_sequential_prepare_gan(sizes):
    """The stacked engine against the per-client loop on the same
    streams; the skewed case's n < MIN client rides fully masked and
    keeps its GAN fields unset."""
    steps = 10
    A, B = _mk_clients(sizes), _mk_clients(sizes)
    streams = _streams(len(sizes))
    for c, s in zip(A, streams):
        if c.n >= MIN:
            c.prepare_gan(s, steps=steps, device="cpu")
    rep = _fleet(B, streams, steps=steps)
    assert rep.n_eligible == sum(c.n >= MIN for c in A)
    assert rep.groups == [(max(tstrategies.gan_batch_size(n) for n in sizes
                               if n >= MIN), len(sizes))]
    assert rep.n_synth == sum(len(c.aug_labels) for c in B if c.n >= MIN)
    assert sorted(rep.d_loss) == [i for i, n in enumerate(sizes) if n >= MIN]
    _assert_like(A, B)


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX package's fleet prep of a skewed cohort (an ineligible
    rider included) and the port's on the JAX package's draws."""
    sizes, steps = (40, 21, 5), 10
    keys = [jax.random.PRNGKey(100 + i) for i in range(len(sizes))]
    J = _mk_clients(sizes, mod=jclient)
    jrep = jfleet.prepare_gan_fleet(J, keys, steps=steps)
    T = _mk_clients(sizes)
    trep = _fleet(T, [JaxGANStream(k) for k in keys], steps=steps)
    return J, T, jrep, trep


def test_fleet_matches_jax_fleet(jax_fleet):
    J, T, jrep, trep = jax_fleet
    assert (trep.n_eligible, trep.n_synth, trep.groups) == \
        (jrep.n_eligible, jrep.n_synth, [tuple(g) for g in jrep.groups])
    _assert_like(J, T, "jax vs port: ")
    for i in jrep.d_loss:
        assert trep.d_loss[i] == pytest.approx(jrep.d_loss[i], abs=2e-2)
        assert trep.g_loss[i] == pytest.approx(jrep.g_loss[i], abs=2e-2)
    # the staged layouts of the two packages' pools, bitwise
    lj = jstage([c.pool() for c in J])
    lt = stage_client_pools([c.pool() for c in T])
    np.testing.assert_array_equal(lj[1], lt[1])
    np.testing.assert_array_equal(lj[2], lt[2])


def test_bucket_optout_matches_bucketed_and_sequential():
    """``bucket_batches=False`` trains each batch-size group exactly (one
    program per group) and agrees with the bucketed prep and with the
    sequential loop."""
    sizes, steps = (24, 21, 24), 6
    streams = _streams(3, base=300)
    A, B, S = (_mk_clients(sizes) for _ in range(3))
    rt_a, rt_b = truntime.ProgramRuntime(), truntime.ProgramRuntime()
    rep_a = _fleet(A, streams, steps=steps, runtime=rt_a)
    rep_b = _fleet(B, streams, steps=steps, runtime=rt_b,
                   fleet_cfg=fleetgan.FleetGANConfig(bucket_batches=False))
    for c, s in zip(S, streams):
        c.prepare_gan(s, steps=steps, device="cpu")
    assert rt_a.stats()["gan_train"]["n_compiles"] == 1
    assert rt_b.stats()["gan_train"]["n_compiles"] == 2
    assert rep_b.groups == [(21, 1), (24, 2)]
    assert sorted(rep_b.d_loss) == sorted(rep_a.d_loss) == [0, 1, 2]
    for i in rep_a.d_loss:
        assert rep_a.d_loss[i] == pytest.approx(rep_b.d_loss[i], abs=2e-2)
    _assert_like(A, B, "bucketed vs exact: ")
    _assert_like(S, B, "sequential vs exact: ")


def test_bucket_optout_skips_ineligible_clients():
    clients = _mk_clients((24, 5, 12))
    rep = _fleet(clients, _streams(3), steps=4,
                 fleet_cfg=fleetgan.FleetGANConfig(bucket_batches=False))
    assert rep.n_eligible == 2 and sum(g for _, g in rep.groups) == 2
    assert clients[1].gan_params is None and clients[1].aug_images is None
    assert clients[0].gan_params is not None
    assert clients[2].gan_params is not None and 1 not in rep.d_loss


def test_default_runtime_ledger_and_clear_cache():
    """Standalone preps build through the module's default runtime, whose
    ledger carries the ``gan_*`` kinds until ``clear_cache``."""
    fleetgan.clear_cache()
    _fleet(_mk_clients((24, 12)), _streams(2), steps=1)
    stats = fleetgan.default_runtime().stats()
    assert {"gan_init", "gan_train", "gan_synth"} <= set(stats)
    fleetgan.clear_cache()
    assert fleetgan.default_runtime().stats() == {}
    assert fleetgan.default_runtime().n_compiles == 0


def test_fleet_empty_after_filter():
    clients = _mk_clients((5, 3, 6))
    rep = _fleet(clients, _streams(3), steps=5)
    assert rep.n_eligible == 0 and rep.groups == [] and rep.n_synth == 0
    for c in clients:
        assert c.gan_params is None and c.gan_cfg is None
        assert c.aug_images is None and c.aug_labels is None


def test_fleet_refusals():
    clients = _mk_clients((10, 9))
    with pytest.raises(ValueError, match="one GAN stream per client"):
        _fleet(clients, _streams(1), steps=3)
    mixed = _mk_clients((10, 9))
    mixed[1].n_classes += 1
    with pytest.raises(ValueError, match="one class space"):
        _fleet(mixed, _streams(2), steps=3)
    clients[1].images = clients[1].images[:0]
    clients[1].labels = clients[1].labels[:0]
    with pytest.raises(ValueError, match="empty"):
        _fleet(clients, _streams(2), steps=3)


def test_launch_waits_only_in_resolve_and_drops_deliver_nothing():
    clients = _mk_clients((24, 12))
    truntime.reset_sync_traces()
    job = fleetgan.launch_gan_fleet(clients, _streams(2), steps=2,
                                    device="cpu")
    assert truntime.SYNC_TRACES == {} and not job.resolved
    assert set(job.need) == {0, 1} and clients[0].gan_params is None
    job.mark_dropped([1])
    rep = job.resolve()
    assert truntime.SYNC_TRACES == {"gan_resolve": 1}
    assert rep.n_dropped == 1 and job.dropped == {1}
    assert clients[1].gan_params is None and clients[1].aug_images is None
    assert clients[0].gan_params is not None
    assert rep.n_synth == len(job.need[0])
    assert job.resolve() is rep
    with pytest.raises(RuntimeError, match="already-resolved"):
        job.mark_dropped([0])


def test_pending_job_stages_like_resolved_pools():
    """A pending job handed to the cohort engine: raw rows and reserved
    rows staged first, the synthetic rows encoded into their slots on
    resolve. The staged pool equals an engine built on the resolved
    clients' pools; a client dropped between launch and resolve keeps
    its raw length as its sampling bound."""
    ccfg = tclip.CLIPConfig()
    frozen = tclip.init_clip(torch.Generator().manual_seed(0), ccfg,
                             device="cpu")
    class_emb = torch.randn((7, ccfg.proj_dim),
                            generator=torch.Generator().manual_seed(1))
    cfg = tcohort.CohortConfig(strategy=STRATEGIES["tripleplay"],
                               local_steps=1, batch_size=4, lr=1e-3)
    sizes = (24, 12, 5)

    def engine(clients, job=None):
        return tcohort.CohortEngine(frozen=frozen, ccfg=ccfg,
                                    class_emb=class_emb, clients=clients,
                                    cfg=cfg, gan_job=job)

    A, B = _mk_clients(sizes), _mk_clients(sizes)
    job = fleetgan.launch_gan_fleet(A, _streams(3), steps=2, device="cpu")
    ea = engine(A, job)
    _fleet(B, _streams(3), steps=2)
    eb = engine(B)
    np.testing.assert_array_equal(ea.lens, eb.lens)
    assert torch.equal(ea.pool_labs, eb.pool_labs)
    np.testing.assert_allclose(ea.pool_staged.numpy(), eb.pool_staged.numpy(),
                               atol=1e-5, rtol=0)
    D = _mk_clients(sizes)
    job = fleetgan.launch_gan_fleet(D, _streams(3), steps=2, device="cpu")
    job.mark_dropped([0])
    assert engine(D, job).lens[0] == D[0].n < ea.lens[0]
