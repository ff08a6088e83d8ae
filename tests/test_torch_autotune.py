"""The port's kernel autotuner (``repro_torch.kernels.autotune``),
restating ``tests/test_kernels.py::test_autotune_sweep_caches_and_
charges``: a sweep times every candidate, caches the winner and charges
its wall time to the runtime's ledger as ``autotune_<kernel>``; a second
sweep is a pure hit that charges nothing; the JSON file reloads after
``clear()``; M buckets to a power of two; ``lookup`` never sweeps. With
an empty cache the ops take the kernels' own plans (the launch path
passes no tuned split or plan) and the CPU traces are unchanged; with a
cached winner they pass it. On the card (``cuda``) a tuned split count
runs ``lora_matmul`` within its bf16 bound."""
import json

import pytest
import torch

from repro_torch.core import quant as qlib
from repro_torch.fl import runtime as runtime_lib
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels import lora_matmul as lm_kernel
from repro_torch.kernels import quant_matmul as qmm_kernel


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", path)
    autotune.clear()
    yield path
    autotune.clear()


def test_sweep_caches_and_charges(cache):
    rt = runtime_lib.ProgramRuntime()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((16, 128), generator=g)
    qt = qlib.quantize(torch.randn((128, 64), generator=g), bits=8,
                       block=64)
    calls = []

    def build(splits):
        calls.append(splits)
        return lambda: ref.quant_matmul(x, qt)

    r1 = autotune.sweep("lora_matmul", build, 16, 128, 64, bits=8,
                        mode="linear", runtime=rt, path=cache,
                        candidates=((1,), (2,)), iters=1)
    assert r1.swept and r1.n_candidates == 2 and calls == [1, 2]
    assert r1.best in ((1,), (2,)) and set(r1.timings) == {"1", "2"}
    assert rt.stats()["autotune_lora_matmul"]["n_compiles"] == 2
    t1 = rt.compile_time_s
    assert t1 > 0 and t1 == pytest.approx(r1.time_s)
    # a second sweep: a pure hit, nothing timed, nothing charged
    r2 = autotune.sweep("lora_matmul", build, 16, 128, 64, bits=8,
                        mode="linear", runtime=rt, path=cache,
                        candidates=((1,), (2,)), iters=1)
    assert not r2.swept and r2.best == r1.best and calls == [1, 2]
    assert rt.stats()["autotune_lora_matmul"]["n_compiles"] == 2
    assert rt.compile_time_s == t1
    # lookup returns the winner without sweeping; M buckets to pow2
    assert autotune.lookup("lora_matmul", 16, 128, 64, bits=8,
                           mode="linear") == r1.best
    assert autotune.lookup("lora_matmul", 13, 128, 64, bits=8,
                           mode="linear") == r1.best
    assert autotune.lookup("lora_matmul", 17, 128, 64, bits=8,
                           mode="linear") is None
    # an unseen shape falls back to the default, still without sweeping
    assert autotune.lookup("lora_matmul", 16, 256, 64, bits=8,
                           mode="linear", default=(7,)) == (7,)
    assert calls == [1, 2]
    # the file holds the winner under the backend's key; a fresh
    # in-process cache reloads it
    with open(cache) as f:
        disk = json.load(f)
    assert disk == {r1.key: list(r1.best)} and r1.key.startswith("cpu/")
    autotune.clear()
    assert autotune.lookup("lora_matmul", 16, 128, 64, bits=8,
                           mode="linear") == r1.best
    autotune.clear(in_process_only=False)
    assert autotune.lookup("lora_matmul", 16, 128, 64, bits=8,
                           mode="linear") is None


def test_key_buckets_rows_and_keeps_the_rest():
    k = autotune.key_for("quant_matmul", 3, 768, 768, bits=4, mode="nf4",
                         backend="b")
    assert k == "b/quant_matmul/M4/K768/N768/b4nf4"
    assert autotune._pow2_bucket(1) == 1 and autotune._pow2_bucket(5) == 8
    assert autotune.cache_path().endswith("autotune.json")


def test_candidates_are_the_plans_options():
    # Yi-9B's decode shapes: K 4096 / 11008 at NF4 block 64
    for K, N in ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096)):
        cands = autotune.lora_candidates(4, K, N, 64)
        pick = lm_kernel.plan(4, K, N, 64).splits
        assert (pick,) in cands and cands[0] == (1,)
        assert all(s in lm_kernel.SPLITS for (s,) in cands)
    g = autotune.gemv_candidates(4, 12, 768)
    pl = qmm_kernel.plan(1, 4, 12, 768)
    assert (pl.cols, pl.cluster) in g
    tuned = autotune.gemv_plan(4, 12, 768, (pl.cols, pl.cluster))
    assert tuned == pl


def test_empty_cache_takes_the_plans(cache, monkeypatch):
    """The launch path's choice with an empty cache and with a winner,
    with the kernels replaced by recorders (no card here)."""
    seen = []
    monkeypatch.setattr(lm_kernel, "lora_matmul",
                        lambda x, qt, a, b, *, scale: seen.append("plan"))
    monkeypatch.setattr(lm_kernel, "_lora_matmul",
                        lambda x, qt, a, b, scale, splits:
                        seen.append(("tuned", splits)))
    monkeypatch.setattr(qmm_kernel, "quant_matmul",
                        lambda x, qt: seen.append("gemv plan"))
    monkeypatch.setattr(qmm_kernel, "_quant_matmul",
                        lambda x, qt, pl: seen.append(("gemv", pl.cols,
                                                       pl.cluster)))
    monkeypatch.setattr(qmm_kernel, "takes_gemv", lambda M, N, q: True)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 256), generator=g).to(torch.bfloat16)
    # lora_matmul's split count is its tensor-core kernel's, past the
    # decode route's rows
    xl = torch.randn((16, 256), generator=g).to(torch.bfloat16)
    qt = qlib.quantize(torch.randn((256, 128), generator=g), bits=4,
                       block=64, mode="nf4")
    a, b = torch.zeros((256, 4)), torch.zeros((4, 128))
    ops._lora_kernel(xl, qt, a, b, 2.0)
    ops._qmm_kernel(x, qt)
    assert seen == ["plan", "gemv plan"]
    autotune._CACHE[autotune.key_for("lora_matmul", 16, 256, 128, bits=4,
                                     mode="nf4")] = (2,)
    autotune._CACHE[autotune.key_for("quant_matmul", 4, 256, 128, bits=4,
                                     mode="nf4")] = (64, 2)
    ops._lora_kernel(xl, qt, a, b, 2.0)
    ops._qmm_kernel(x, qt)
    assert seen[2:] == [("tuned", 2), ("gemv", 64, 2)]
    # fp32 x takes the CUDA-core kernel, which does not split
    ops._lora_kernel(xl.float(), qt, a, b, 2.0)
    assert seen[4] == "plan"


def test_cpu_routes_unchanged(cache):
    g = torch.Generator().manual_seed(2)
    x = torch.randn((4, 128), generator=g)
    qt = qlib.quantize(torch.randn((128, 64), generator=g), bits=8,
                       block=64)
    autotune._CACHE[autotune.key_for("lora_matmul", 4, 128, 64, bits=8,
                                     mode="linear")] = (2,)
    ops.reset_kernel_traces()
    y = ops.lora_matmul(x, qt, torch.zeros((128, 4)), torch.zeros((4, 64)),
                        scale=1.0)
    ops.quant_matmul(x, qt)
    assert dict(ops.KERNEL_TRACES) == {"lora_matmul_ref": 1,
                                       "quant_matmul_ref": 1}
    torch.testing.assert_close(y, ref.quant_matmul(x, qt), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU and nvcc to build the "
                    "lora_matmul kernel")


@pytest.mark.cuda
def test_tuned_split_on_the_card(cache, hopper):
    g = torch.Generator(device="cuda").manual_seed(3)
    M, K, N, r = 16, 4096, 4096, 16        # past the decode route's rows
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    qt = qlib.quantize(torch.randn((K, N), generator=g, device="cuda")
                       * 0.02, bits=4, block=64, mode="nf4")
    a = torch.randn((K, r), generator=g, device="cuda") * 0.02
    b = torch.randn((r, N), generator=g, device="cuda") * 0.02
    cands = autotune.lora_candidates(M, K, N, 64)
    res = autotune.sweep(
        "lora_matmul",
        lambda s: lambda: lm_kernel._lora_matmul(x, qt, a, b, 2.0, s),
        M, K, N, bits=4, mode="nf4", candidates=cands, iters=5)
    assert res.swept and res.best in cands
    assert not autotune.sweep("lora_matmul", None, M, K, N, bits=4,
                              mode="nf4", candidates=cands).swept
    got = ops._lora_kernel(x, qt, a, b, 2.0).float()
    want = ref.lora_matmul(x.float(), qlib.dequantize(qt, torch.float32),
                           a, b, scale=2.0)
    assert float((got - want).abs().max()) <= \
        2e-2 * float(want.abs().max())
