"""The port's GAN (``core.gan``, ``kernels.gan_conv``) against the JAX
package's, on the CPU at the JAX tests' small sizes.

Tolerances: the conv forms' outputs within 1e-5 and their gradients
within 1e-5 of the largest gradient magnitude; generate/discriminate on
converted JAX params within 1e-5; one GAN step from the same params
with the JAX package's noise injected: losses within 1e-5 relative and
the gradients (taken at equal params, recorded where each package
hands them to Adam) within 1e-5 of each leaf's largest value. The
client-axis forms equal per-client loops within 1e-6 of the largest
value; masked steps are bitwise no-ops; ``rebalance_labels`` and
``gan_batch_size`` are bitwise the reference's."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro.core import gan as jgan
from repro.core import optim as joptim
from repro.fl import strategies as jstrategies
from repro.kernels import gan_conv as jconv
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.core import gan as tgan
from repro_torch.core import optim as toptim
from repro_torch.fl import strategies as tstrategies
from repro_torch.kernels import gan_conv as tconv

torch.set_num_threads(2)
SMALL = tgan.GANConfig(n_classes=3, g_dim=8, d_dim=8, z_dim=8)
TOL = 1e-5


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _lax_conv(x, w):
    return lax.conv_general_dilated(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _lax_convT(x, w):
    return lax.conv_transpose(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


CONV = {("conv", "gemm"): (tconv.conv4x4_s2, jconv.conv4x4_s2),
        ("conv", "lax"): (tconv.conv4x4_s2_lax, _lax_conv),
        ("convT", "gemm"): (tconv.convT4x4_s2, jconv.convT4x4_s2),
        ("convT", "lax"): (tconv.convT4x4_s2_lax, _lax_convT)}
# the JAX tests' shapes: (b, hw, ci, co); convT's last is the narrow
# overlap-add form (co < 8)
SHAPES = {"conv": [(3, 32, 3, 16), (2, 16, 16, 24), (2, 8, 32, 48)],
          "convT": [(3, 4, 48, 16), (2, 8, 16, 16), (2, 16, 16, 3)]}


def _port_grads(fn, x, w, ct):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = fn(xt, wt)
    (out * torch.tensor(ct)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("op,impl,shape", [
    (op, impl, s) for op in ("conv", "convT") for impl in ("gemm", "lax")
    for s in SHAPES[op]])
def test_conv_forms_match_jax_with_grads(op, impl, shape):
    b, hw, ci, co = shape
    ohw = hw // 2 if op == "conv" else hw * 2
    x, w = _np(0, b, hw, hw, ci), _np(1, 4, 4, ci, co, scale=0.05)
    ct = _np(2, b, ohw, ohw, co)
    tfn, jfn = CONV[op, impl]

    @jax.jit
    def jax_side(x, w):
        out, vjp = jax.vjp(jfn, x, w)
        return (out,) + vjp(jnp.asarray(ct))

    want, jgx, jgw = (np.asarray(a) for a in jax_side(x, w))
    got, gx, gw = _port_grads(tfn, x, w, ct)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for g, r in ((gx, jgx), (gw, jgw)):
        assert np.abs(g - r).max() <= TOL * np.abs(r).max()


@pytest.mark.parametrize("op,impl", list(CONV))
def test_client_axis_is_a_per_client_loop(op, impl):
    b, hw, ci, co = SHAPES[op][2]
    C = 3
    ohw = hw // 2 if op == "conv" else hw * 2
    x, w = _np(3, C, b, hw, hw, ci), _np(4, C, 4, 4, ci, co, scale=0.05)
    ct = _np(5, C, b, ohw, ohw, co)
    fn = CONV[op, impl][0]
    got = _port_grads(fn, x, w, ct)
    for c in range(C):
        want = _port_grads(fn, x[c], w[c], ct[c])
        for g, r in zip(got, want):
            assert np.abs(g[c] - r).max() <= 1e-6 * np.abs(r).max()


def _params(seed=0, cfg=SMALL):
    """One numpy parameter tree in both packages (JAX, port)."""
    tree = tgan.SeededGANStream((seed,)).init(cfg)
    return jax.tree.map(jnp.asarray, tree), convert.tree_from_numpy(tree,
                                                                    "cpu")


def _jcfg(cfg):
    return jgan.GANConfig(**dataclasses.asdict(cfg))


def _batch(n=6, seed=0):
    rs = np.random.RandomState(seed)
    imgs = np.tanh(rs.randn(n, 32, 32, 3)).astype(np.float32)
    labs = rs.randint(0, SMALL.n_classes, n).astype(np.int32)
    return imgs, labs


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-30)


@pytest.mark.parametrize("impl", ["gemm", "lax"])
def test_generate_and_discriminate_match_jax(impl):
    cfg = dataclasses.replace(SMALL, conv_impl=impl)
    jp, tp = _params()
    imgs, labs = _batch()
    z = _np(7, len(labs), cfg.z_dim)
    jcfg = _jcfg(cfg)
    want = np.asarray(jax.jit(lambda g, z, y: jgan.generate(g, jcfg, z, y))(
        jp["gen"], z, labs))
    got = tgan.generate(tp["gen"], cfg, torch.tensor(z),
                        torch.tensor(labs, dtype=torch.long))
    assert got.shape == (len(labs), 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    wl, wf = jax.jit(lambda d, x, y: jgan.discriminate(
        d, jcfg, x, y, with_features=True))(jp["disc"], imgs, labs)
    gl, gf = tgan.discriminate(tp["disc"], cfg, torch.tensor(imgs),
                               torch.tensor(labs, dtype=torch.long),
                               with_features=True)
    assert _rel(gf.numpy(), wf) <= TOL and _rel(gl.numpy(), wl) <= TOL


class _Recorder:
    """Wraps a package's ``adam_update`` to record the gradients each
    call is handed (disc first, then gen)."""

    def __init__(self, fn, to_np):
        self.fn, self.to_np, self.grads = fn, to_np, []

    def __call__(self, grads, *a, **kw):
        self.grads.append(self.to_np(grads))
        return self.fn(grads, *a, **kw)


def _step_pair(monkeypatch, cfg, bucketed):
    """One GAN step in each package from the same params and noise:
    (port losses, JAX losses, port grads, JAX grads), grads as
    [disc, gen] numpy trees."""
    jp, tp = _params()
    imgs, labs = _batch()
    B = len(labs)
    n_true = 4 if bucketed else B
    kz, kz2 = jax.random.split(jax.random.PRNGKey(11))
    z = np.array(jax.random.normal(kz, (B, cfg.z_dim)))
    z2 = np.array(jax.random.normal(kz2, (B, cfg.z_dim)))
    if bucketed:
        z[n_true:] = z2[n_true:] = 0.0
    jrec = _Recorder(joptim.adam_update, lambda g: g)
    trec = _Recorder(toptim.adam_update, convert.tree_to_numpy)
    monkeypatch.setattr(joptim, "adam_update", jrec)
    monkeypatch.setattr(toptim, "adam_update", trec)
    jcfg = _jcfg(cfg)

    @jax.jit
    def jax_step(jp, imgs, labs, z, z2):
        # the recorded (traced) gradients leave the program as outputs
        jrec.grads.clear()
        jopt = {k: joptim.adam_init(jp[k]) for k in ("gen", "disc")}
        if bucketed:
            m = jgan.train_step_bucketed(jp, jopt, (imgs, labs), jcfg, z,
                                         z2, n_true)[2]
        else:
            # train_step_impl draws z, z2 from split(key): the same draws
            m = jgan.train_step_impl(jp, jopt, (imgs, labs), jcfg,
                                     jax.random.PRNGKey(11))[2]
        return m, list(jrec.grads)

    jm, jgrads = jax_step(jp, imgs, labs, z, z2)
    topt = tgan.adam_init(tp)
    tb = (torch.tensor(imgs), torch.tensor(labs, dtype=torch.long))
    if bucketed:
        _, _, tm = tgan.train_step_bucketed(tp, topt, tb, cfg,
                                            torch.tensor(z),
                                            torch.tensor(z2), n_true)
    else:
        _, _, tm = tgan.train_step_impl(tp, topt, tb, cfg, torch.tensor(z),
                                        torch.tensor(z2))
    return tm, jm, trec.grads, jax.tree.map(np.asarray, jgrads)


@pytest.mark.parametrize("impl,bucketed", [("lax", False), ("gemm", False),
                                           ("gemm", True)])
def test_train_step_matches_jax(monkeypatch, impl, bucketed):
    cfg = dataclasses.replace(SMALL, conv_impl=impl)
    tm, jm, tg, jg = _step_pair(monkeypatch, cfg, bucketed)
    for k in ("d_loss", "g_loss"):
        assert _rel(tm[k].numpy(), jm[k]) <= TOL, k
    assert len(tg) == len(jg) == 2          # disc, then gen
    for tgrads, jgrads in zip(tg, jg):
        want = dict(tree_lib.flatten_with_path(jgrads))
        for path, g in tree_lib.flatten_with_path(tgrads):
            assert _rel(g, want[path]) <= TOL, tree_lib.path_str(path)


def test_bucketed_step_ignores_its_padding():
    """The padded rows of a bucketed step contribute exactly zero: the
    step equals the exact step on the true rows (to reassociation)."""
    cfg = dataclasses.replace(SMALL, conv_impl="gemm")
    _, tp = _params()
    imgs, labs = _batch()
    n = 4
    z, z2 = _np(8, len(labs), cfg.z_dim), _np(9, len(labs), cfg.z_dim)
    z[n:] = z2[n:] = 0.0
    tb = (torch.tensor(imgs), torch.tensor(labs, dtype=torch.long))
    pb, _, mb = tgan.train_step_bucketed(tp, tgan.adam_init(tp), tb, cfg,
                                         torch.tensor(z), torch.tensor(z2),
                                         n)
    pe, _, me = tgan.train_step_impl(
        tp, tgan.adam_init(tp), (tb[0][:n], tb[1][:n]), cfg,
        torch.tensor(z[:n]), torch.tensor(z2[:n]))
    for k in mb:
        assert _rel(mb[k].numpy(), me[k].numpy()) <= TOL
    for (p, a), (_, b) in zip(tree_lib.flatten_with_path(pb),
                              tree_lib.flatten_with_path(pe)):
        # Adam turns a near-zero gradient's rounding into an lr-sized
        # move, so the params after one step agree to about lr
        assert np.abs(a.numpy() - b.numpy()).max() <= 2 * cfg.lr, p


def _scan_inputs(stacked, steps=4, batch=5, n=12):
    cfg = dataclasses.replace(SMALL, conv_impl="gemm")
    C = 2 if stacked else None
    lead = (C,) if stacked else ()
    imgs = torch.tensor(np.tanh(_np(10, *lead, n, 32, 32, 3)))
    labs = torch.tensor(np.random.RandomState(11).randint(
        0, 3, (*lead, n)), dtype=torch.long)
    idx = torch.tensor(np.random.RandomState(12).randint(
        0, n, (*lead, steps, batch)), dtype=torch.long)
    z = torch.tensor(_np(13, *lead, steps, batch, cfg.z_dim))
    z2 = torch.tensor(_np(14, *lead, steps, batch, cfg.z_dim))
    params = [_params(s)[1] for s in range(C or 1)]
    if stacked:
        params = tree_lib.tree_map(lambda *ls: torch.stack(ls), *params)
    else:
        params = params[0]
    return cfg, params, tgan.adam_init(params, stacked=stacked), imgs, \
        labs, idx, z, z2


def _tree_equal(a, b):
    for (p, x), (_, y) in zip(tree_lib.flatten_with_path(a),
                              tree_lib.flatten_with_path(b)):
        assert torch.equal(x, y), tree_lib.path_str(p)


def _state_tree(opt):
    return {k: {"step": s.step, "mu": s.mu, "nu": s.nu}
            for k, s in opt.items()}


@pytest.mark.parametrize("stacked", [False, True])
def test_masked_steps_are_bitwise_noops(stacked):
    """All-False: params and both Adam states (step counters included)
    bitwise untouched. With the first k steps live (per client when
    stacked), bitwise k steps: the masked tail's inputs do not matter."""
    cfg, params, opt, imgs, labs, idx, z, z2 = _scan_inputs(stacked)
    steps = idx.shape[-2]
    off = torch.zeros(idx.shape[:-1], dtype=torch.bool)
    p0, o0, ms = tgan.gan_scan(params, opt, cfg, imgs, labs, idx, z, z2,
                               active=off)
    _tree_equal(p0, params)
    _tree_equal(_state_tree(o0), _state_tree(opt))
    assert torch.isfinite(ms["d_loss"]).all()
    k = torch.tensor([2, 3]) if stacked else torch.tensor(2)
    live = torch.arange(steps) < k[..., None]
    p1, o1, _ = tgan.gan_scan(params, opt, cfg, imgs, labs, idx, z, z2,
                              active=live)
    scrambled = torch.where(live[..., None], idx, 0)
    p2, o2, _ = tgan.gan_scan(params, opt, cfg, imgs, labs, scrambled,
                              z * live[..., None, None],
                              z2 * live[..., None, None], active=live)
    _tree_equal(p1, p2)
    _tree_equal(_state_tree(o1), _state_tree(o2))
    assert (o1["gen"].step == k.to(torch.int32)).all()


def test_rebalance_labels_and_gan_batch_size_match_jax():
    rs = np.random.RandomState(0)
    for n_classes in (1, 3, 7):
        for n in (0, 1, 9, 40):
            labels = rs.randint(0, n_classes, n).astype(np.int32)
            want = jgan.rebalance_labels(labels, n_classes)
            got = tgan.rebalance_labels(labels, n_classes)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    for n in (1, 7, 8, 63, 64, 65, 1000):
        assert tstrategies.gan_batch_size(n) == jstrategies.gan_batch_size(n)


def test_seeded_stream_is_a_pure_function():
    s = tgan.SeededGANStream((0, 100))
    cfg = SMALL
    for a, b in zip(s.train(cfg, 13, 3, 5), s.train(cfg, 13, 3, 5)):
        np.testing.assert_array_equal(a, b)
    idx, z, z2 = tgan.train_draws(s, cfg, 13, 3, 5)
    assert idx.shape == (3, 5) and idx.max() < 13 and z.shape == (3, 5, 8)
    assert not np.array_equal(z, z2)
    np.testing.assert_array_equal(s.synth(cfg, 4), s.synth(cfg, 4))
    init = s.init(cfg)
    assert init["disc"]["fc"].shape == (4 * 4 * 4 * cfg.d_dim, 1)
    other = tgan.SeededGANStream((0, 101)).init(cfg)
    assert not np.array_equal(init["gen"]["fc"], other["gen"]["fc"])
    with pytest.raises(ValueError, match="outside a pool"):
        tgan.train_draws(_OutOfPool(), cfg, 13, 3, 5)


class _OutOfPool:
    """A stream whose indices fall one past the pool."""

    def train(self, cfg, n, steps, batch):
        z = np.zeros((steps, batch, cfg.z_dim))
        return np.full((steps, batch), n), z, z


def test_gemm_int8_is_refused():
    """The int8 gemms are ported (Queue B item 9): ``gemm_int8`` generates
    as the JAX package's does (eager, as its int8 tests run it; the int8
    forms themselves are held in ``tests/test_torch_gan_int8.py``), and
    an unknown ``conv_impl`` is still refused."""
    cfg = dataclasses.replace(SMALL, conv_impl="gemm_int8")
    jp, tp = _params()
    z = _np(7, 2, cfg.z_dim)
    labs = np.asarray([0, 2], np.int32)
    want = np.asarray(jgan.generate(jp["gen"], _jcfg(cfg), jnp.asarray(z),
                                    jnp.asarray(labs)))
    got = tgan.generate(tp["gen"], cfg, torch.tensor(z),
                        torch.tensor(labs, dtype=torch.long))
    assert got.shape == (2, 32, 32, 3)
    assert _rel(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="conv_impl"):
        tgan.generate(tp["gen"], dataclasses.replace(SMALL, conv_impl="fft"),
                      torch.zeros(2, cfg.z_dim),
                      torch.zeros(2, dtype=torch.long))
