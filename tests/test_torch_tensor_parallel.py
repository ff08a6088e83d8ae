"""The production layout on a rank (a :class:`Runtime`): each rank holds
its blocks of the parameters, the batch and the cache by the sharding
rules, and ``Model.grads`` / ``train_step`` / ``prefill`` /
``decode_step`` compute on them with the collectives the layout needs.

Two spawned gloo worlds of 8 ranks (``_torch_dist_worker.
tensor_parallel``, one spawn a world): ``(pod=2, data=2, model=2)``,
the JAX package's own distributed layout, runs reduced Yi-9B (every
linear split: ``wq``/``wk``/``wv`` by heads, ``wo`` and ``wd`` by rows,
the embedding and the head by the vocabulary), RecurrentGemma-2B (its
RG-LRU and its decode on the rank's channels, one KV head held whole)
and Qwen3-MoE with a dense layer and a shared expert; ``(data=2,
model=4)`` runs Falcon-Mamba-7B (its Mamba body and decode on the
rank's channels; with ``grad_accum`` 4, each rank's rows two of the
global batch's four microbatches) and a Yi-9B variant that reaches the
fallbacks (6 heads the model axis does not divide: ``wq`` row-split;
one KV head: ``wk``/``wv`` whole; a vocabulary of 250: the embedding
split on d and gathered, the head row-split; d_ff 320), in fp32 and
with an NF4 backbone, whose ``wd`` has 5 quant groups and is stored
split on N (its input gathered, its N block computed), and reduced Yi-9B
decoding from a cache of 18 slots, which the model axis (4) does not
divide: both its rings (the layers' KV and the adapter's) are held whole
on every rank, written at ``pos % 18`` and read whole (this case runs
only the prefill and the decode, from the prefill's held cache and from
``rank_cache`` of the JAX package's).

Against the JAX package on the same numpy inputs (fp32, within 1e-5 of
the largest magnitude): the loss, every gradient, the prefill's and
every decode step's logits of the rank's batch rows against its local
step; with ``grad_accum`` the loss and grad norm against its
``train_step`` and the gradients against the mean of its microbatch
gradients. The MoE's balance loss is the mean of the ranks' own (the
JAX body's ``pmean``), so its loss, balance loss and gradients are
held against the JAX package's own distributed program on the same
mesh (8 host CPU devices, in a subprocess run beside the ranks), its
logits against the local step. The loss, the gradients and the Adam
update (Adam of those gradients) are identical on every rank. Each
rank's parameter and batch trees are exactly their blocks by
``param_specs_tree`` / ``batch_specs_tree``, and the prefill's cache is
its block of the JAX cache by ``cache_specs_tree``; ``DIST_TRACES``
names each route.
"""
import functools
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_zoo import Case, to_port
from _torch_dist_worker import start
from repro_torch import tree as tree_lib
from repro_torch.core import optim

torch.set_num_threads(1)
B, S, P, STEPS, MAX_LEN = 4, 16, 8, 3, 16
FALLBACK = dict(n_heads=6, n_kv_heads=1, d_ff=320, vocab_size=250)
NF4 = dict(quant_bits=4, quant_mode="nf4", quant_block=64)
WORLDS = {
    "2x2x2": (((2, 2, 2), ("pod", "data", "model")), {
        "yi": ("yi-9b", {}),
        "rg": ("recurrentgemma-2b", {}),
        "moe": ("qwen3-moe-235b-a22b", dict(
            capacity_factor=8.0, first_k_dense=1, n_shared_experts=1,
            dense_d_ff=512))}),
    "2x4": (((2, 4), ("data", "model")), {
        "fm": ("falcon-mamba-7b", dict(grad_accum=4)),
        "fallback": ("yi-9b", FALLBACK),
        "fallback_nf4": ("yi-9b", {**FALLBACK, **NF4}),
        "ring": ("yi-9b", {})}),
}
# cases that run only the prefill and the decode, at their own cache size
DECODE_ONLY = {"ring": 18}
CASES = [(w, c) for w, (_, cs) in WORLDS.items() for c in cs]
TRAIN_CASES = [(w, c) for w, c in CASES if c not in DECODE_ONLY]
# held against the JAX package's distributed program on the world's mesh
JAX_DISTRIBUTED = ("moe",)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX package's loss and gradients on its debug mesh (8 host CPU
# devices; XLA_FLAGS must be set before JAX starts, hence a process)
DIST_STEP = """
import pickle, sys
import jax
import numpy as np
from _jax_zoo import Case, to_port
from repro.launch.mesh import make_debug_mesh
from repro.models import runtime as jrt
from repro_torch import tree as tree_lib

args, out = sys.argv[1], sys.argv[2]
with open(args, "rb") as f:
    arch, replace, seed, b, s, (shape, axes) = pickle.load(f)
c = Case(arch, **replace)
jb, _ = c.batch(seed, B=b, S_tok=s)
mesh = make_debug_mesh(shape, axes)
rt = jrt.Runtime(mesh=mesh, dp_axes=tuple(a for a in axes if a != "model"),
                 tp_axis="model")
with jrt.runtime(rt), mesh:
    (loss, parts), g = jax.jit(jax.value_and_grad(
        lambda t, f, b_: c.jm.loss_fn(f, t, b_), has_aux=True))(
            c.tr, c.frozen, jb)
res = dict(loss=float(loss), ce=float(parts["ce"]), aux=float(parts["aux"]),
           grads={p: np.asarray(t) for p, t in
                  tree_lib.flatten_with_path(to_port(g))})
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def _rel(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(float(np.abs(w).max()), 1e-30))


def _flat(grads):
    return dict(tree_lib.flatten_with_path(jax.tree.map(np.asarray,
                                                        to_port(grads))))


class _DistStep:
    """:data:`DIST_STEP` started for one case; :meth:`wait` gives its
    loss, balance loss and gradients."""

    def __init__(self, arch, replace, mesh):
        self.tmp = tempfile.TemporaryDirectory()
        args = os.path.join(self.tmp.name, "args.pkl")
        self.out = os.path.join(self.tmp.name, "out.pkl")
        with open(args, "wb") as f:
            pickle.dump((arch, replace, 11, B, S, mesh), f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(ROOT, "src"),
                        os.path.join(ROOT, "tests")]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(DIST_STEP), args,
             self.out], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def wait(self, timeout=400):
        try:
            _, err = self.proc.communicate(timeout=timeout)
            assert self.proc.returncode == 0, err[-3000:]
            with open(self.out, "rb") as f:
                return pickle.load(f)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
            self.tmp.cleanup()


def _jax_case(name, arch, replace):
    """One case's inputs for the ranks (the JAX package's weights) and a
    function that computes its JAX references."""
    c = Case(arch, **replace)
    jb, tb = c.batch(11, B=B, S_tok=S)
    pj = {k: v[:, :P] if k == "tokens" else v for k, v in jb.items()
          if k in ("tokens", "frames")}
    toks = [jb["tokens"][:, P + i:P + i + 1] for i in range(STEPS)]
    max_len = DECODE_ONLY.get(name, MAX_LEN)
    _, jc = c.prefill(c.frozen, c.tr, pj, max_len=max_len)
    inp = dict(name=name, cfg=c.cfg, frozen=c.tf, trainable=c.ttr, batch=tb,
               prefill={k: torch.from_numpy(np.array(v))
                        for k, v in pj.items()},
               max_len=max_len, cache=to_port(jc),
               decode_only=name in DECODE_ONLY,
               decode=[(torch.from_numpy(np.array(t)),
                        torch.tensor(P + i, dtype=torch.int32))
                       for i, t in enumerate(toks)])

    def want():
        jl, jc = c.prefill(c.frozen, c.tr, pj, max_len=max_len)
        logits = [np.asarray(jl)]
        for i, tok in enumerate(toks):
            jl, jc = c.decode(c.frozen, c.tr, jc, tok,
                              jnp.asarray(P + i, jnp.int32))
            logits.append(np.asarray(jl))
        res = dict(logits=logits, family=c.cfg.family)
        if name in DECODE_ONLY:
            return res
        (jloss, jparts), jgrads = c.grad_fn(c.tr, c.frozen, jb)
        res.update(loss=float(jloss), ce=float(jparts["ce"]),
                   grads=_flat(jgrads), trainable=c.ttr)
        A = c.cfg.grad_accum
        if A > 1:
            # the JAX package's accumulation: its train_step's loss and
            # grad norm, and the mean of its microbatches' gradients
            # (microbatch i is rows [i B / A, (i + 1) B / A))
            from repro.core import optim as joptim
            _, _, m = jax.jit(functools.partial(c.jm.train_step, lr=1e-3))(
                c.frozen, c.tr, joptim.adam_init(c.tr), jb)
            acc = None
            for i in range(A):
                _, g = c.grad_fn(c.tr, c.frozen, {
                    k: v[i * B // A:(i + 1) * B // A]
                    for k, v in jb.items()})
                g = {k: v / np.float32(A) for k, v in _flat(g).items()}
                acc = g if acc is None else {k: acc[k] + g[k] for k in acc}
            res["accum"] = (float(m["loss"]), float(m["grad_norm"]), acc)
        return res
    return inp, want


@functools.lru_cache(maxsize=None)
def _worlds():
    """Each world's references and results: the JAX distributed steps
    and both worlds started, the cases made, and the local references
    computed while they run, the JAX compiles in threads (XLA compiles
    without the GIL)."""
    dist = {name: _DistStep(*WORLDS[w][1][name], WORLDS[w][0])
            for w, name in CASES if name in JAX_DISTRIBUTED}
    with ThreadPoolExecutor(4) as pool:
        made = {w: {name: pool.submit(_jax_case, name, arch, replace)
                    for name, (arch, replace) in cases.items()}
                for w, (_, cases) in WORLDS.items()}
        started = {}
        for w, fs in made.items():
            cases = {name: f.result() for name, f in fs.items()}
            started[w] = start("tensor_parallel", 8, {
                "mesh": WORLDS[w][0],
                "cases": [inp for inp, _ in cases.values()]}, timeout=400)
            made[w] = {name: pool.submit(want)
                       for name, (_, want) in cases.items()}
        wants = {w: {name: f.result() for name, f in fs.items()}
                 for w, fs in made.items()}
    for w, name in CASES:
        if name in dist:
            wants[w][name].update(dist[name].wait())
    return {w: (wants[w], ranks.wait()) for w, ranks in started.items()}


def _world(world):
    return _worlds()[world]


def _leaf(t):
    return t.detach().numpy()


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_train_step_is_the_jax_global_step_on_every_rank(world, name):
    wants, res = _world(world)
    want = wants[name]
    first = res[0][name]
    for r in res:
        got = r[name]
        # every rank the same global loss and gradient
        assert torch.equal(got["loss"], first["loss"])
        for (path, g), g0 in zip(tree_lib.flatten_with_path(got["grads"]),
                                 tree_lib.leaves(first["grads"])):
            assert torch.equal(g, g0), path
        assert abs(float(got["parts"]["ce"]) - want["ce"]) <= \
            1e-5 * abs(want["ce"])
        assert abs(float(got["loss"]) - want["loss"]) <= \
            1e-5 * abs(want["loss"])
        if "aux" in want:
            # the MoE's balance loss, the mean of the ranks' own
            assert abs(float(got["parts"]["aux"]) - want["aux"]) <= \
                1e-5 * abs(want["aux"])
        ref = want["grads"]
        grads = dict(tree_lib.flatten_with_path(got["grads"]))
        assert sorted(grads) == sorted(ref)
        for path, w in ref.items():
            assert _rel(_leaf(grads[path]), w) <= 1e-5, (name, path)
        # the Adam update of those gradients (the accumulated ones with
        # grad_accum), the same on every rank (an element whose gradient
        # is near zero moves by about lr on a gradient's rounding, so the
        # step is held on the rank's gradient)
        loss, grads = got.get("accum", (got["loss"], got["grads"]))
        step, _ = optim.adam_update(grads,
                                    optim.adam_init(want["trainable"]),
                                    want["trainable"], lr=1e-3,
                                    grad_clip=1.0)
        for a, b, a0 in zip(tree_lib.leaves(got["after"]),
                            tree_lib.leaves(step),
                            tree_lib.leaves(first["after"])):
            assert torch.equal(a, a0)
            assert _rel(_leaf(a), _leaf(b)) <= 1e-6
        np.testing.assert_allclose(float(got["metrics"]["loss"]),
                                   float(loss), rtol=1e-6)


def test_grad_accum_takes_the_global_microbatches():
    """``cfg.grad_accum`` = 4 on the (data=2, model=4) world: each rank's
    two rows are two of the global batch's four microbatches; the loss
    and the grad norm are the JAX package's ``train_step``'s, every
    gradient the mean of its microbatches' gradients, the same on every
    rank."""
    wants, res = _world("2x4")
    wl, wn, wg = wants["fm"]["accum"]
    first = res[0]["fm"]["accum"]
    for r in res:
        loss, grads = r["fm"]["accum"]
        assert torch.equal(loss, first[0])
        assert abs(float(loss) - wl) <= 1e-5 * abs(wl)
        gn = float(r["fm"]["metrics"]["grad_norm"])
        assert abs(gn - wn) <= 1e-5 * abs(wn)
        flat = dict(tree_lib.flatten_with_path(grads))
        assert sorted(flat) == sorted(wg)
        for path, w in wg.items():
            assert _rel(_leaf(flat[path]), w) <= 1e-5, path


@pytest.mark.parametrize("world,name", CASES)
def test_prefill_and_decode_logits_are_the_jax_rows(world, name):
    """The prefill's and each decode step's logits of the rank's batch
    rows (its dp block), whole over the vocabulary."""
    wants, res = _world(world)
    for r in res:
        got = r[name]
        i = got["dp_index"]
        for step, (g, w) in enumerate(zip(got["logits"],
                                          wants[name]["logits"])):
            rows = w[i * g.shape[0]:(i + 1) * g.shape[0]]
            assert _rel(_leaf(g), rows) <= 1e-5, (name, step)


@pytest.mark.parametrize("world,name", CASES)
def test_each_rank_holds_its_blocks(world, name):
    _, res = _world(world)
    for r in res:
        got = r[name]
        assert got["params_blocks"] == 0.0      # bit for bit
        assert got["batch_blocks"] == 0.0
        assert got["cache_blocks"] <= 1e-5      # the JAX prefill's cache


@pytest.mark.parametrize("world", list(WORLDS))
def test_dist_traces_name_each_route(world):
    _, res = _world(world)
    want = {
        "2x2x2": {"yi": ("linear_col_dist", "linear_row_dist",
                         "embed_vocab_dist", "flash_attention_heads_dist",
                         "decode_attention_dist"),
                  "rg": ("rglru_block_dist", "rglru_decode_dist",
                         "flash_attention_heads_dist", "linear_col_dist"),
                  "moe": ("moe_ffn_dist_seq", "moe_ffn_dist_decode",
                          "linear_row_dist")},
        "2x4": {"fm": ("mamba_block_dist", "mamba_decode_dist",
                       "embed_vocab_dist"),
                "fallback": ("embed_gather", "flash_attention_dist",
                             "linear_row_dist", "linear_col_dist"),
                "fallback_nf4": ("linear_nsplit_dist", "embed_gather"),
                "ring": ("decode_attention_whole",)},
    }[world]
    for r in res:
        for name, routes in want.items():
            traces = r[name]["traces"]
            for route in routes:
                assert traces.get(route, 0) >= 1, (name, route, traces)
    if world == "2x4":
        # the fp32 fallback's wd is row-split, its NF4 twin's stored on N
        assert "linear_nsplit_dist" not in res[0]["fallback"]["traces"]


def test_a_ring_the_model_axis_does_not_divide_is_held_whole():
    """Reduced Yi-9B on (data=2, model=4) with a cache of 18 slots: the
    prefill's held cache and ``rank_cache`` of the JAX package's cache
    both hold the KV and adapter rings whole (``slots_cut`` False), and
    the decode steps from the latter give the JAX package's logits of the
    rank's rows within 1e-5; each step reads the rings with no combine
    over ``model`` (``decode_attention_whole``, never ``_dist``)."""
    wants, res = _world("2x4")
    for r in res:
        got = r["ring"]
        assert got["slots_cut"] == {"kv": False, "adapter": False}
        assert got["rank_cache_slots_cut"] == {"kv": False, "adapter": False}
        assert got["kv_slots"] == (DECODE_ONLY["ring"],) * 2
        # each decode step reads its two rings whole (2 layers + adapter)
        assert got["decode_traces"].get("decode_attention_whole") == \
            3 * STEPS
        assert "decode_attention_dist" not in got["decode_traces"]
        i = got["dp_index"]
        for step, (g, w) in enumerate(zip(got["logits_rank_cache"],
                                          wants["ring"]["logits"][1:])):
            rows = w[i * g.shape[0]:(i + 1) * g.shape[0]]
            assert _rel(_leaf(g), rows) <= 1e-5, step
