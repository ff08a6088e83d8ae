"""The port's int8 quantized-compute GAN gemms
(``kernels.gan_conv.quant_gemm_int8`` and the ``conv_impl="gemm_int8"``
convolutions) against the JAX package's, on the CPU at the JAX tests'
small sizes.

Held bitwise: ``_q8_rows``' codes and scales, and the block products
(exact integers) against an int64 product. Within 1e-5: the gemm's
output relative to its largest value (K < 64, an odd K that pads, a
zero row), each conv form's output and its VJP against ``jax.vjp`` of
the JAX ``custom_vjp`` (``tests/test_torch_gan.py``'s bounds for the
gemm forms), one GAN step's losses and discriminator gradients, and the
losses of three steps of ``gan_scan`` on the JAX package's draws (the
generator's leaves at ``tests/test_torch_fleetgan.py``'s 2e-3). The
fleet engine with ``gemm_int8`` against the sequential GAN loop on the
same config and draws at those bounds.

The op-level JAX calls run eagerly, as the JAX package's own int8 tests
(``tests/test_kernels.py``) run them. Under ``jax.jit`` XLA turns
``_q8_rows``' ``max|x| / 127.0`` into a multiply by the reciprocal,
which can land one ulp off and move a code by one step (a 1e-3 change
of a conv's output); the port divides as the eager reference does
(``core.quant._div``) and is bitwise its codes and scales. The GAN step
and scan are compared with the JAX package's jitted programs, as its
engines run them."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_gan_stream import JaxGANStream, jax_cfg
from repro.core import gan as jgan
from repro.core import optim as joptim
from repro.kernels import gan_conv as jconv
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import gan as tgan
from repro_torch.core import optim as toptim
from repro_torch.data.synthetic import make_dataset
from repro_torch.fl import client as tclient
from repro_torch.fl import fleetgan
from repro_torch.fl import strategies as tstrategies
from repro_torch.fl.strategies import STRATEGIES
from repro_torch.kernels import gan_conv as tconv

torch.set_num_threads(2)
SMALL = tgan.GANConfig(n_classes=3, g_dim=8, d_dim=8, z_dim=8,
                       conv_impl="gemm_int8")
TOL = 1e-5
GEN_ATOL, IMG_ATOL = 2e-3, 5e-3
GEN_GRAD_REL = 2e-2


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-30)


# (M, K, N): a single short block, an odd K past two blocks (padding),
# whole blocks
GEMMS = [(5, 40, 7), (9, 131, 6), (16, 128, 24)]


@pytest.mark.parametrize("M,K,N", GEMMS)
def test_q8_rows_and_quant_gemm_match_jax(M, K, N):
    x, w = _np(0, M, K), _np(1, K, N, scale=0.3)
    x[2] = 0.0                              # a zero row: scale 0, codes 0
    b = min(tconv.INT8_BLOCK, K)
    for a in (x, w.T):
        qj, sj = jconv._q8_rows(jnp.asarray(a), b)
        qt, st = tconv._q8_rows(torch.tensor(a), b)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    want = np.asarray(jconv.quant_gemm_int8(jnp.asarray(x), jnp.asarray(w)))
    got = tconv.quant_gemm_int8(torch.tensor(x), torch.tensor(w)).numpy()
    assert got.dtype == np.float32 and got.shape == (M, N)
    assert _rel(got, want) <= TOL
    np.testing.assert_array_equal(got[2], np.zeros(N, np.float32))


def test_block_products_are_exact_integers():
    """Every block's fp32 product of int8 codes equals the int64 product
    (the largest codes, so the sums reach 64 * 127**2)."""
    rs = np.random.RandomState(3)
    qx = torch.tensor(rs.randint(-127, 128, (2, 6, 3, 64)), dtype=torch.int8)
    qw = torch.tensor(rs.randint(-127, 128, (2, 5, 3, 64)), dtype=torch.int8)
    qx[0, 0, 0] = 127
    qw[0, 0, 0] = 127
    got = tconv.block_products(qx, qw)
    want = torch.matmul(qx.transpose(-3, -2).long(),
                        qw.transpose(-3, -2).transpose(-1, -2).long())
    assert got.dtype == torch.float32
    assert int(want.abs().max()) == 64 * 127 ** 2
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.float32))
    assert torch.equal(got.long(), want)


CONV = {"conv": (tconv.conv4x4_s2_int8, jconv.conv4x4_s2_int8),
        "convT": (tconv.convT4x4_s2_int8, jconv.convT4x4_s2_int8)}
# tests/test_kernels.py's int8 shapes: (b, hw, ci, co); convT's last is
# the narrow overlap-add form (co < 8)
SHAPES = {"conv": [(2, 16, 6, 12), (2, 8, 16, 24)],
          "convT": [(2, 8, 16, 16), (2, 16, 16, 3)]}


@pytest.mark.parametrize("op,shape", [(op, s) for op in ("conv", "convT")
                                      for s in SHAPES[op]])
def test_int8_conv_forms_and_vjps_match_jax(op, shape):
    b, hw, ci, co = shape
    ohw = hw // 2 if op == "conv" else hw * 2
    x, w = _np(0, b, hw, hw, ci), _np(1, 4, 4, ci, co, scale=0.05)
    ct = _np(2, b, ohw, ohw, co)
    tfn, jfn = CONV[op]
    # eager, as every JAX-side call of this file (see the module
    # docstring)
    out, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    want, jgx, jgw = (np.asarray(a) for a in (out,) + vjp(jnp.asarray(ct)))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tfn(xt, wt)
    (out * torch.tensor(ct)).sum().backward()
    assert out.shape == want.shape
    assert _rel(out.detach().numpy(), want) <= TOL
    assert _rel(xt.grad.numpy(), jgx) <= TOL
    assert _rel(wt.grad.numpy(), jgw) <= TOL


def test_client_axis_is_a_per_client_loop():
    """A leading client axis quantizes each client's rows on their own:
    bitwise the per-client calls."""
    C = 3
    for op, fn in (("conv", tconv.conv4x4_s2_int8),
                   ("convT", tconv.convT4x4_s2_int8)):
        b, hw, ci, co = SHAPES[op][1]
        x, w = _np(3, C, b, hw, hw, ci), _np(4, C, 4, 4, ci, co, scale=0.05)
        got = fn(torch.tensor(x), torch.tensor(w))
        for c in range(C):
            want = fn(torch.tensor(x[c]), torch.tensor(w[c]))
            assert torch.equal(got[c], want), op


def _params(seed=0, cfg=SMALL):
    tree = tgan.SeededGANStream((seed,)).init(cfg)
    return jax.tree.map(jnp.asarray, tree), convert.tree_from_numpy(tree,
                                                                    "cpu")


def _batch(n=6, seed=0):
    rs = np.random.RandomState(seed)
    imgs = np.tanh(rs.randn(n, 32, 32, 3)).astype(np.float32)
    labs = rs.randint(0, SMALL.n_classes, n).astype(np.int32)
    return imgs, labs


class _Recorder:
    def __init__(self, fn, to_np):
        self.fn, self.to_np, self.grads = fn, to_np, []

    def __call__(self, grads, *a, **kw):
        self.grads.append(self.to_np(grads))
        return self.fn(grads, *a, **kw)


def test_int8_train_step_matches_jax(monkeypatch):
    """One GAN step from the same params and noise against the JAX
    package's jitted step: losses within 1e-5 relative and the
    discriminator's gradients (as handed to Adam) within 1e-5 of each
    leaf's largest value, as ``tests/test_torch_gan.py`` holds the gemm
    forms; the generator's in norm (see below)."""
    jp, tp = _params()
    imgs, labs = _batch()
    jrec = _Recorder(joptim.adam_update, lambda g: g)
    trec = _Recorder(toptim.adam_update, convert.tree_to_numpy)
    monkeypatch.setattr(joptim, "adam_update", jrec)
    monkeypatch.setattr(toptim, "adam_update", trec)
    jcfg = jax_cfg(SMALL)
    kz, kz2 = jax.random.split(jax.random.PRNGKey(11))
    z = np.array(jax.random.normal(kz, (len(labs), SMALL.z_dim)))
    z2 = np.array(jax.random.normal(kz2, (len(labs), SMALL.z_dim)))

    @jax.jit
    def jax_step(jp, imgs, labs):
        jrec.grads.clear()
        jopt = {k: joptim.adam_init(jp[k]) for k in ("gen", "disc")}
        m = jgan.train_step_impl(jp, jopt, (imgs, labs), jcfg,
                                 jax.random.PRNGKey(11))[2]
        return m, list(jrec.grads)

    jm, jgrads = jax_step(jp, imgs, labs)
    _, _, tm = tgan.train_step_impl(
        tp, tgan.adam_init(tp),
        (torch.tensor(imgs), torch.tensor(labs, dtype=torch.long)), SMALL,
        torch.tensor(z), torch.tensor(z2))
    for k in ("d_loss", "g_loss"):
        assert _rel(tm[k].numpy(), jm[k]) <= TOL, k
    assert len(trec.grads) == len(jgrads) == 2
    (t_disc, t_gen), (j_disc, j_gen) = trec.grads, jax.tree.map(np.asarray,
                                                               jgrads)
    want = dict(tree_lib.flatten_with_path(j_disc))
    for path, g in tree_lib.flatten_with_path(t_disc):
        assert _rel(g, want[path]) <= TOL, tree_lib.path_str(path)
    # the generator's gradient crosses the discriminator's quantized
    # backward on a cotangent that differs by fp32 rounding: a code there
    # can move by one step (1/127 of its block's scale), so these leaves
    # are held in norm to GEN_GRAD_REL
    want = dict(tree_lib.flatten_with_path(j_gen))
    for path, g in tree_lib.flatten_with_path(t_gen):
        w = want[path]
        assert np.linalg.norm(g - w) <= GEN_GRAD_REL * np.linalg.norm(w), \
            tree_lib.path_str(path)


def test_int8_gan_scan_matches_jax_on_its_draws():
    """Three steps of the sequential GAN engine at the small config on
    the JAX package's draws (its jitted ``gan_scan``): every step's
    losses within 1e-5 relative, the generator's leaves within 2e-3."""
    steps, batch = 3, 6
    imgs, labs = _batch(12, seed=1)
    key = jax.random.PRNGKey(5)
    stream = JaxGANStream(key)
    init = stream.init(SMALL)
    idx, z, z2 = stream.train(SMALL, len(labs), steps, batch)
    jcfg = jax_cfg(SMALL)
    _, _, kss = jgan.gan_key_stream(key, steps)
    jp = jax.tree.map(jnp.asarray, init)
    jopt = {k: joptim.adam_init(jp[k]) for k in ("gen", "disc")}
    want_p, _, want_m = jax.jit(lambda p, o: jgan.gan_scan(
        p, o, jcfg, jnp.asarray(imgs), jnp.asarray(labs), jnp.asarray(idx),
        kss))(jp, jopt)
    tp = convert.tree_from_numpy(init, "cpu")
    got_p, _, got_m = tgan.gan_scan(
        tp, tgan.adam_init(tp), SMALL, torch.tensor(imgs),
        torch.tensor(labs, dtype=torch.long),
        torch.tensor(idx, dtype=torch.long), torch.tensor(z),
        torch.tensor(z2))
    for k in ("d_loss", "g_loss"):
        assert _rel(got_m[k].numpy(), want_m[k]) <= TOL, k
    want = dict(tree_lib.flatten_with_path(
        jax.tree.map(np.asarray, want_p["gen"])))
    for path, leaf in tree_lib.flatten_with_path(got_p["gen"]):
        np.testing.assert_allclose(leaf.numpy(), want[path], atol=GEN_ATOL,
                                   rtol=0, err_msg=tree_lib.path_str(path))


def _clients(sizes):
    data = make_dataset("pacs", n_per_class=30, seed=0, longtail_gamma=4.0)
    out, start = [], 0
    for i, n in enumerate(sizes):
        sl = slice(start, start + n)
        start += n
        out.append(tclient.Client(
            cid=i, images=data["images"][sl], labels=data["labels"][sl],
            n_classes=data["spec"].n_classes,
            strategy=STRATEGIES["tripleplay"]))
    return out


def test_int8_fleet_matches_the_sequential_gan_engine(monkeypatch):
    """``prepare_gan_fleet(conv_impl="gemm_int8")`` at ``GANConfig()``
    widths, 3 steps, against each client's sequential ``prepare_gan``
    with the same config (``GANConfig`` patched to default to
    ``gemm_int8``) on the same draws: labels bitwise, generator leaves
    within 2e-3 and images within 5e-3."""
    monkeypatch.setattr(tgan, "GANConfig", functools.partial(
        tgan.GANConfig, conv_impl="gemm_int8"))
    sizes, steps = (40, 21, 5), 3
    streams = [tgan.SeededGANStream((0, 100 + i)) for i in range(3)]
    A, B = _clients(sizes), _clients(sizes)
    for c, s in zip(A, streams):
        if c.n >= tstrategies.GAN_MIN_POOL:
            c.prepare_gan(s, steps=steps, device="cpu")
            assert c.gan_cfg.conv_impl == "gemm_int8"
    rep = fleetgan.prepare_gan_fleet(B, streams, steps=steps,
                                     conv_impl="gemm_int8", device="cpu")
    assert rep.n_eligible == 2
    for a, b in zip(A, B):
        if a.n < tstrategies.GAN_MIN_POOL:
            assert b.gan_params is None and b.aug_images is None
            continue
        np.testing.assert_array_equal(a.aug_labels, b.aug_labels)
        ga = dict(tree_lib.flatten_with_path(a.gan_params["gen"]))
        for path, leaf in tree_lib.flatten_with_path(b.gan_params["gen"]):
            np.testing.assert_allclose(leaf.numpy(), ga[path].numpy(),
                                       atol=GEN_ATOL, rtol=0)
        np.testing.assert_allclose(b.aug_images, a.aug_images,
                                   atol=IMG_ATOL, rtol=0)


def test_int8_unknown_impl_and_geometry_refused():
    with pytest.raises(ValueError, match="conv_impl"):
        tgan.generate(_params()[1]["gen"],
                      dataclasses.replace(SMALL, conv_impl="fft"),
                      torch.zeros(2, SMALL.z_dim),
                      torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError, match="even spatial"):
        tconv.conv4x4_s2_int8(torch.zeros(1, 5, 4, 3),
                              torch.zeros(4, 4, 3, 8))
    with pytest.raises(ValueError, match="contraction mismatch"):
        tconv.quant_gemm_int8(torch.zeros(2, 8), torch.zeros(7, 3))
