"""The port's hierarchical FedAvg (``repro_torch.fl.server.tree_partials``
and ``aggregate_tree``) against the JAX package's, on the CPU: the same
stacked delta trees (a quantized leaf beside plain ones) and masses
through both packages, the partials, masses and aggregated trees within
1e-6; tree against the port's flat ``aggregate_stacked`` within 1e-5 as
a hypothesis property over cohort widths, shard counts (dividing or
not) and zero masses, as tests/test_runtime.py holds the JAX pair; the
pad rows exactly zero; every guard raising where the JAX one does. The
mesh form (``mesh=``, each rank its own rows, one all-reduce) is held by
tests/test_torch_cohort_mesh.py's sharded rounds."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.core import quant as jq
from repro.fl import server as jserver
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import quant as tq
from repro_torch.fl import server


def _delta(rs, n):
    raw = {"adapter": rs.randn(n, 6, 3).astype(np.float32),
           "bias": rs.randn(n, 5).astype(np.float32),
           "lora": rs.randn(n, 8, 8).astype(np.float32)}
    j = {k: jnp.asarray(v) for k, v in raw.items()}
    j["lora"] = jq.quantize(j["lora"], bits=8, block=4, mode="linear")
    t = {k: torch.from_numpy(v) for k, v in raw.items()}
    t["lora"] = tq.quantize(t["lora"], bits=8, block=4, mode="linear")
    return j, t


def _global(rs):
    return {"adapter": rs.randn(6, 3).astype(np.float32),
            "bias": rs.randn(5).astype(np.float32),
            "lora": rs.randn(8, 8).astype(np.float32)}


def _masses(rs, n):
    m = rs.rand(n).astype(np.float32) * 10
    m[rs.rand(n) < 0.25] = 0.0
    if m.sum() == 0:
        m[0] = 1.0
    return m


@pytest.mark.parametrize("n,n_shards", [(8, 4), (5, 4), (3, 1), (7, 3),
                                        (4, 8)])
def test_tree_partials_and_aggregate_match_jax(n, n_shards):
    rs = np.random.RandomState(n * 10 + n_shards)
    jd, td = _delta(rs, n)
    masses = _masses(rs, n)
    jp, jm = jserver.tree_partials(jnp.asarray(masses), jd,
                                   n_shards=n_shards)
    tp, tm = server.tree_partials(masses, td, n_shards=n_shards)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    for k in ("adapter", "bias", "lora"):
        assert tp[k].shape == np.asarray(jp[k]).shape
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    g = _global(rs)
    want = jserver.aggregate_tree({k: jnp.asarray(v) for k, v in g.items()},
                                  jnp.asarray(masses), jd, n_shards=n_shards)
    got = server.aggregate_tree(convert.tree_from_numpy(g, "cpu"),
                                torch.from_numpy(masses), td,
                                n_shards=n_shards)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 12), st.integers(1, 8), st.integers(0, 10 ** 6))
def test_tree_aggregation_matches_flat(n, n_shards, seed):
    """``aggregate_tree`` re-associates ``aggregate_stacked``: any masses
    (zeros included), any shard split (one the width does not divide
    too), within fp tolerance."""
    rs = np.random.RandomState(seed)
    _, td = _delta(rs, n)
    masses = _masses(rs, n)
    g = convert.tree_from_numpy(_global(rs), "cpu")
    flat = server.aggregate_stacked(g, masses / masses.sum(), td)
    tree = server.aggregate_tree(g, torch.from_numpy(masses), td,
                                 n_shards=n_shards)
    for (path, a), b in zip(tree_lib.flatten_with_path(flat),
                            tree_lib.leaves(tree)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=str(path))


def test_tree_partials_pad_rows_are_exact_zero():
    """A width of 5 over 4 shards pads to 8: the all-pad shard's partials
    and mass are exactly zero, and a zero-mass row adds exactly zero."""
    rs = np.random.RandomState(0)
    _, td = _delta(rs, 5)
    masses = np.asarray([2.0, 1.0, 0.0, 3.0, 1.5], np.float32)
    partials, mass_s = server.tree_partials(masses, td, n_shards=4)
    np.testing.assert_array_equal(mass_s.numpy(), [3.0, 3.0, 1.5, 0.0])
    for leaf in tree_lib.leaves(partials):
        assert torch.all(leaf[-1] == 0.0)
    for k in ("adapter", "bias", "lora"):
        d = td[k]
        dq = tq.dequantize(d, torch.float32) if isinstance(d, tq.QTensor) \
            else d
        assert torch.equal(partials[k][1], 3.0 * dq[3])


@pytest.mark.parametrize("case", ["no_shards", "short_masses",
                                  "negative_mass", "nan_mass",
                                  "ragged_leaves"])
def test_guards_raise_where_jax_does(case):
    rs = np.random.RandomState(1)
    jd, td = _delta(rs, 4)
    masses = np.ones(4, np.float32)
    kw = {"n_shards": 2}
    if case == "no_shards":
        kw = {"n_shards": 0}
    elif case == "short_masses":
        masses = masses[:3]
    elif case == "negative_mass":
        masses[1] = -1.0
    elif case == "nan_mass":
        masses[2] = np.nan
    else:
        jd = dict(jd, bias=jd["bias"][:3])
        td = dict(td, bias=td["bias"][:3])
    with pytest.raises(ValueError):
        jserver.tree_partials(masses, jd, **kw)
    with pytest.raises(ValueError):
        server.tree_partials(masses, td, **kw)
    with pytest.raises(ValueError):
        server.aggregate_tree({k: torch.zeros(1) for k in td}, masses, td,
                              **kw)


def test_commit_buffer_of_a_sharded_engine_is_hierarchical():
    """``CohortExec.commit_buffer`` on an engine of several shards commits
    the async buffer through ``aggregate_tree`` (its size need not divide
    the shards), as the JAX executor does: against the JAX executor on
    the same buffer, and within 1e-5 of the flat commit."""
    from types import SimpleNamespace
    from repro.fl import cohort as jcohort
    from repro.fl import sched as jsched
    from repro_torch.fl import cohort as tcohort
    from repro_torch.fl import sched as tsched
    rs = np.random.RandomState(2)
    jd, td = _delta(rs, 4)
    jdel = [jcohort.slice_client_delta(jd, i) for i in range(4)]
    tdel = [tcohort.slice_client_delta(td, i) for i in range(4)]
    w = _masses(rs, 4)
    w = w / w.sum()
    g = _global(rs)
    want = jsched.CohortExec(SimpleNamespace(shards=3)).commit_buffer(
        {k: jnp.asarray(v) for k, v in g.items()}, w, jdel)
    ex = tsched.CohortExec(SimpleNamespace(shards=3,
                                           pool_labs=torch.zeros(1)))
    got = ex.commit_buffer(convert.tree_from_numpy(g, "cpu"), w, tdel)
    flat = tsched.CohortExec(SimpleNamespace(
        shards=1, pool_labs=torch.zeros(1))).commit_buffer(
            convert.tree_from_numpy(g, "cpu"), w, tdel)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), flat[k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
