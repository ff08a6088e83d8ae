"""The port's serving CLI in its token mode (``launch.serve.main``
without ``--adapters``: prefill, then greedy decode against the ring KV
or SSM state cache) against the JAX package's ``repro.launch.serve.main``
on the CPU, at the reduced configs of the dense, SSM, encdec and vlm
families.

Both CLIs draw the prompt from ``np.random.RandomState(0)``; the port's
model is given the JAX package's ``init_params(PRNGKey(0))`` converted
through ``repro_torch.convert`` (its own init draws from a
``torch.Generator``). Held: every decoded token id of every row equal
(the JAX ones recorded at its ``select_token``), the printed header and
sample-id lines equal, and the timing lines in the JAX package's form."""
import contextlib
import io
import sys

import numpy as np
import pytest
import torch

import jax

from repro.launch import serve as jlaunch
from repro.models import build_model as j_build
from repro.configs import get_reduced as j_reduced
from repro_torch import convert
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build_model

torch.set_num_threads(2)
ARGV = ["--batch", "2", "--prompt-len", "16", "--gen", "8"]


def _jax_run(argv, monkeypatch):
    """The JAX CLI's printed lines and every token it chose, (B, G)."""
    chosen = []
    pick = jlaunch.select_token

    def record(*args, **kwargs):
        tok = pick(*args, **kwargs)
        chosen.append(np.asarray(tok))
        return tok

    monkeypatch.setattr(jlaunch, "select_token", record)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jlaunch.main()
    monkeypatch.setattr(jlaunch, "select_token", pick)
    return buf.getvalue().splitlines(), np.concatenate(chosen, 1)


def _port_run(argv, monkeypatch):
    """The port's CLI on the JAX package's weights: its printed lines and
    its result."""
    cfg_args = tlaunch.build_parser().parse_args(argv)
    jparams = j_build(j_reduced(cfg_args.arch)).init_params(
        jax.random.PRNGKey(0))

    def with_jax_weights(cfg):
        model = build_model(cfg)
        model.init_params = lambda generator, device=None: \
            convert.tree_from_numpy(jparams, device)
        return model

    monkeypatch.setattr(tlaunch, "build_model", with_jax_weights)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tlaunch.main(argv, device="cpu")
    return buf.getvalue().splitlines(), out


@pytest.mark.parametrize("arch", ["yi-9b", "h2o-danube-3-4b",
                                  "falcon-mamba-7b"])
def test_token_mode_decodes_the_jax_token_ids(arch, monkeypatch):
    argv = ["--arch", arch] + ARGV
    want_lines, want = _jax_run(argv, monkeypatch)
    got_lines, out = _port_run(argv, monkeypatch)
    assert out["tokens"].shape == (2, 8) and out["tokens"].dtype == np.int32
    np.testing.assert_array_equal(out["tokens"], want)
    assert got_lines[0] == want_lines[0]          # arch, batch, prompt, gen
    assert got_lines[3] == want_lines[3]          # sample token ids
    for g, w in zip(got_lines[1:3], want_lines[1:3]):
        assert g.split(":")[0] == w.split(":")[0]
        assert g.endswith("tok/s)") == w.endswith("tok/s)")
    assert out["prefill_s"] > 0 and out["decode_s"] > 0


def test_token_mode_samples_from_a_seeded_generator():
    """``--no-greedy`` draws from a ``torch.Generator`` seeded by
    ``--seed``: the same seed gives the same ids, and both runs decode
    through the model the JAX package's CLI runs (same vocab, same
    prompt draw)."""
    argv = ["--arch", "yi-9b", "--no-greedy", "--temperature", "0.7"] + ARGV
    with contextlib.redirect_stdout(io.StringIO()):
        a = tlaunch.main(argv + ["--seed", "3"], device="cpu")
        b = tlaunch.main(argv + ["--seed", "3"], device="cpu")
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].max() < j_reduced("yi-9b").vocab_size
    np.testing.assert_array_equal(
        a["prompt"].numpy(),
        np.random.RandomState(0).randint(0, j_reduced("yi-9b").vocab_size,
                                         (2, 16)))


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_token_mode_refuses_the_families_of_item_8_4(arch, monkeypatch):
    """The encdec and vlm archs, which the token mode runs: their frames
    and image embeddings drawn after the prompt from the same
    ``RandomState(0)``, the vlm's positions after its patches; every
    decoded id and the printed lines are the JAX CLI's."""
    argv = ["--arch", arch] + ARGV
    want_lines, want = _jax_run(argv, monkeypatch)
    got_lines, out = _port_run(argv, monkeypatch)
    np.testing.assert_array_equal(out["tokens"], want)
    assert got_lines[0] == want_lines[0] and got_lines[3] == want_lines[3]
    cfg = j_reduced(arch)
    extra = "image_embeds" if cfg.family == "vlm" else "frames"
    n = cfg.n_patches if cfg.family == "vlm" else cfg.n_frames
    assert out["batch"][extra].shape == (2, n, cfg.d_model)
    assert out["pos0"] == 16 + (cfg.n_patches if cfg.family == "vlm" else 0)
