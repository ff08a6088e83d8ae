"""The selective scan's backward kernel, its algorithm on the CPU.

``kernels/csrc/selective_scan.cu``'s ``scan_bwd_kernel`` runs on the card
only (tests/test_torch_cuda.py, chip_smoke.py hold it against the plain
``kernels.ops.selective_scan_bwd`` there). Here a plain PyTorch
emulation of its decomposition is held against ``jax.vjp`` of the JAX
package's ``repro.kernels.ref.selective_scan`` within 1e-5 of each
gradient's largest magnitude: S padded with zero steps to whole
``BWD_CHUNK``-step chunks, a forward pass keeping h at every chunk's end,
then chunk by chunk from the end the chunk's states recomputed from its
checkpoint and the reverse recurrence over them (``exp(dt A)`` as
``exp2((dt log2 e) A)``), dB and dC summed per block of ``BWD_CHANNELS``
channels and the blocks added in order, dA summed per batch row and the
rows added in order. Ragged S (not a chunk multiple, and one chunk),
ragged di (a partial channel block), N of 4, 5 and 16, with and without
an h_last cotangent, dA on and off."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import selective_scan as ss_kernel

torch.set_num_threads(1)
LOG2E = 1.4426950408889634
CSRC = Path(ss_kernel.__file__).parent / "csrc" / "selective_scan.cu"


def emulate_bwd(dt, x, Bm, Cm, A, gy, gh_last, *, need_a):
    """The backward kernel's algorithm in fp32 PyTorch ops."""
    B, S, di = dt.shape
    N = A.shape[1]
    L, CB = ss_kernel.BWD_CHUNK, ss_kernel.BWD_CHANNELS
    K, GX = ss_kernel.bwd_chunks(S), -(-di // CB)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, K * L - S))
    dt, x, gy, Bm, Cm = map(pad, (dt, x, gy, Bm, Cm))   # zero steps past S
    a = torch.exp2((dt * LOG2E)[..., None] * A)          # (B, KL, di, N)
    u = dt * x
    inject = lambda t: u[:, t, :, None] * Bm[:, t, None, :]

    h, ck = torch.zeros((B, di, N)), []
    for t in range((K - 1) * L):                         # pass 1
        h = a[:, t] * h + inject(t)
        if t % L == L - 1:
            ck.append(h)
    carry = gh_last.clone()
    ddt, dx = torch.zeros_like(dt), torch.zeros_like(dt)
    part_bc = torch.zeros((GX, B, K * L, 2, N))
    part_a = torch.zeros((B, di, N))
    blocks = lambda v: torch.nn.functional.pad(
        v, (0, 0, 0, GX * CB - di)).reshape(B, GX, CB, N).sum(2)
    for k in range(K - 1, -1, -1):
        h0 = ck[k - 1] if k else torch.zeros((B, di, N))
        hs, h = [], h0
        for tt in range(L):                              # the recompute
            h = a[:, k * L + tt] * h + inject(k * L + tt)
            hs.append(h)
        for tt in range(L - 1, -1, -1):                  # the reverse
            t = k * L + tt
            hp = hs[tt - 1] if tt else h0
            g = gy[:, t, :, None] * Cm[:, t, None, :] + carry
            ag = a[:, t] * g
            q = ag * hp
            gb = (g * Bm[:, t, None, :]).sum(-1)
            ddt[:, t] = (q * A).sum(-1) + x[:, t] * gb
            dx[:, t] = dt[:, t] * gb
            part_a += q * dt[:, t, :, None]
            part_bc[:, :, t, 0] = blocks(g * u[:, t, :, None]).transpose(0, 1)
            part_bc[:, :, t, 1] = blocks(gy[:, t, :, None] * hs[tt]
                                         ).transpose(0, 1)
            carry = ag
    dbc = part_bc[0]
    for gx in range(1, GX):                              # blocks in order
        dbc = dbc + part_bc[gx]
    dA = None
    if need_a:
        dA = part_a[0]
        for b in range(1, B):                            # rows in order
            dA = dA + part_a[b]
    return (ddt[:, :S], dx[:, :S], dbc[:, :S, 0], dbc[:, :S, 1], dA)


def _inputs(seed, B, S, di, N):
    rs = np.random.RandomState(seed)
    return (np.abs(rs.randn(B, S, di)).astype(np.float32) * 0.1,
            rs.randn(B, S, di).astype(np.float32),
            rs.randn(B, S, N).astype(np.float32),
            rs.randn(B, S, N).astype(np.float32),
            -np.abs(rs.randn(di, N)).astype(np.float32))


@pytest.mark.parametrize("need_a", [True, False])
@pytest.mark.parametrize("with_gh", [True, False])
@pytest.mark.parametrize("B,S,di,N", [
    (2, 21, 33, 4),      # ragged S and di, one partial channel block
    (1, 50, 130, 5),     # two channel blocks, N padded to 8
    (2, 17, 40, 16),     # the trainer's N
    (1, 5, 16, 16),      # S below one chunk: no checkpoint
])
def test_backward_kernel_algorithm_matches_jax_vjp(B, S, di, N, with_gh,
                                                   need_a):
    ins = _inputs(B * S + di + N, B, S, di, N)
    rs = np.random.RandomState(S + N)
    gy = rs.randn(B, S, di).astype(np.float32)
    gh = rs.randn(B, di, N).astype(np.float32) * with_gh
    _, vjp = jax.vjp(jref.selective_scan, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    got = emulate_bwd(*map(torch.from_numpy, ins), torch.from_numpy(gy),
                      torch.from_numpy(gh), need_a=need_a)
    names = ("ddt", "dx", "dB", "dC", "dA")
    for g, w, name in zip(got, want, names):
        if g is None:
            assert name == "dA" and not need_a
            continue
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_emulation_uses_the_kernels_chunk_and_block():
    """The emulation's decomposition is the kernel's: its chunk length
    and channels per block are the CUDA source's constants."""
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["L"]) == ss_kernel.BWD_CHUNK
    assert int(consts["CB"]) == ss_kernel.THREADS
    assert int(consts["FWD_LANES"]) == ss_kernel.FWD_LANES
    # the backward runs one thread a channel: a block spans CB channels
    assert ss_kernel.BWD_CHANNELS == ss_kernel.THREADS
    assert "const dim3 grid((di + CB - 1) / CB, B);" in src
    assert [ss_kernel.padded_n(n) for n in (1, 4, 5, 8, 9, 16)] == \
        [4, 4, 8, 8, 16, 16]
    assert ss_kernel.bwd_chunks(64) == 8 and ss_kernel.bwd_chunks(65) == 9
    assert math.ceil(8192 / ss_kernel.BWD_CHANNELS) == 64
