"""Per-shape tuning of the CUDA kernels' launch plans, port of
``repro.kernels.autotune``.

The JAX package sweeps the Pallas kernels' ``(block_m, block_n)`` tiles.
The port's kernels have their own tunables, each chosen by a cost model
fitted on the card unless a tuned winner is cached:

- ``lora_matmul``: the tensor-core kernel's split-K count
  (``kernels.lora_matmul.plan``), a value ``(splits,)``;
- ``lora_matmul_gemv``: the decode route's plan, ``(cols, cluster)``
  (``kernels.lora_matmul.plan_gemv``);
- ``quant_matmul``: the serve GEMV's plan, ``(cols, cluster)``: the
  column tile and the thread-block cluster size along K
  (``kernels.quant_matmul.plan``), for a 2-D weight.

A sweep times each candidate once per ``(backend, kernel, shape
bucket)`` and caches the fastest, in process and as JSON
(``REPRO_TORCH_AUTOTUNE_CACHE``, default
``~/.cache/repro_torch/autotune.json``), so later processes start warm.
The backend is the card's name and compute capability (``cpu`` without
a card). The contract is the JAX package's:

- ``lookup`` never sweeps: it returns the cached winner or the default
  (None: the kernel's own plan), a dict probe on the launch path, so
  with an empty cache every route and split is what the plans give;
- ``sweep`` on a cached key is a pure hit: no timing and no charge;
- a sweep's wall time is charged to the runtime's ledger
  (``ProgramRuntime.charge``) as ``autotune_<kernel>``.

M (rows) buckets to powers of two so ragged row counts share an entry;
K, N, bits and mode are exact. Clear the cache with :func:`clear`
(``in_process_only=False`` also removes the file) or by deleting the
file.
"""
from __future__ import annotations

import functools
import json
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_CACHE: Dict[str, Tuple[int, ...]] = {}
_LOADED: set = set()


def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


@functools.lru_cache(maxsize=None)
def _backend() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability(0)
    return f"{torch.cuda.get_device_name(0)} sm{major}{minor}"


def _pow2_bucket(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


def key_for(kernel: str, M: int, K: int, N: int, *, bits: int = 0,
            mode: str = "", backend: Optional[str] = None) -> str:
    """Cache key: backend + kernel + bucketed shape signature."""
    backend = backend or _backend()
    return "/".join((backend, kernel, f"M{_pow2_bucket(M)}", f"K{K}",
                     f"N{N}", f"b{bits}{mode}"))


def _load(path: str) -> None:
    if path in _LOADED:
        return
    _LOADED.add(path)
    try:
        with open(path) as f:
            disk = json.load(f)
    except (OSError, ValueError):
        return
    for k, v in disk.items():
        _CACHE.setdefault(k, tuple(int(x) for x in v))


def _save(path: str) -> None:
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({k: list(v) for k, v in sorted(_CACHE.items())}, f,
                      indent=1)
    except OSError:
        pass                      # persistence is best-effort


def clear(*, in_process_only: bool = True) -> None:
    """Drop the in-process cache; the JSON file is left alone unless
    ``in_process_only=False``."""
    _CACHE.clear()
    _LOADED.clear()
    if not in_process_only:
        try:
            os.remove(cache_path())
        except OSError:
            pass


def lookup(kernel: str, M: int, K: int, N: int, *, bits: int = 0,
           mode: str = "", default=None, path: Optional[str] = None):
    """The cached winner for this shape bucket, or ``default``. Never
    sweeps and never times: safe on the launch path."""
    path = path or cache_path()
    _load(path)
    if not _CACHE:
        return default
    return _CACHE.get(key_for(kernel, M, K, N, bits=bits, mode=mode),
                      default)


@dataclass
class SweepResult:
    key: str
    best: Tuple[int, ...]
    swept: bool              # False: a cache hit (nothing timed)
    n_candidates: int
    time_s: float
    timings: Dict[str, float]


def _wait(out) -> None:
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def sweep(kernel: str, build: Callable[..., Callable[[], object]],
          M: int, K: int, N: int, *, candidates: Sequence[Tuple[int, ...]],
          bits: int = 0, mode: str = "", runtime=None,
          path: Optional[str] = None, iters: int = 20) -> SweepResult:
    """Time ``build(*candidate)()`` for each candidate and cache the
    fastest for this ``(backend, kernel, shape bucket)``. ``build``
    returns a no-argument callable running the kernel at that candidate
    on its operands; each is called once to warm (a first call builds the
    kernel), then ``iters`` times between two synchronizes. A key already
    cached (in process or in the file) returns at once: nothing timed,
    nothing charged. Otherwise the sweep's wall time is charged to
    ``runtime`` as ``autotune_<kernel>``, one event a candidate."""
    path = path or cache_path()
    _load(path)
    key = key_for(kernel, M, K, N, bits=bits, mode=mode)
    hit = _CACHE.get(key)
    if hit is not None:
        return SweepResult(key=key, best=hit, swept=False, n_candidates=0,
                           time_s=0.0, timings={})
    cands = [tuple(int(v) for v in c) for c in candidates]
    if not cands:
        raise ValueError(f"empty candidate list for {kernel}")
    t_sweep = time.perf_counter()
    timings: Dict[str, float] = {}
    best, best_t = None, math.inf
    for c in cands:
        fn = build(*c)
        _wait(fn())
        t0 = time.perf_counter()
        for _ in range(max(1, iters)):
            out = fn()
        _wait(out)
        dt = (time.perf_counter() - t0) / max(1, iters)
        timings["x".join(map(str, c))] = dt
        if dt < best_t:
            best, best_t = c, dt
    total = time.perf_counter() - t_sweep
    _CACHE[key] = best
    _save(path)
    if runtime is not None:
        runtime.charge(f"autotune_{kernel}", total, n=len(cands))
    return SweepResult(key=key, best=best, swept=True,
                       n_candidates=len(cands), time_s=total,
                       timings=timings)


# -- the port's tunables ------------------------------------------------------
def lora_candidates(M: int, K: int, N: int, block: int) -> tuple:
    """``lora_matmul``'s split counts for this call that its tensor-core
    kernel takes: every count of ``lora_matmul.SPLITS`` that ``plan``
    would consider (each split at least ``MIN_TILES_PER_SPLIT`` k-tiles),
    as 1-tuples."""
    from repro_torch.kernels import lora_matmul as lm
    Kq = -(-K // block) * block
    unit = math.lcm(block, lm.BK)
    nu = -(-Kq // unit)
    return tuple((s,) for s in lm.SPLITS if s == 1 or (
        nu >= s and (nu // s) * unit // lm.BK >= lm.MIN_TILES_PER_SPLIT))


def lora_gemv_candidates(M: int, K: int, N: int, block: int) -> tuple:
    """``lora_matmul``'s decode-route plans ``(cols, cluster)`` for M
    rows, K and N that its GEMV takes (``lora_matmul.gemv_plans``)."""
    from repro_torch.kernels import lora_matmul as lm
    return tuple(lm.gemv_plans(M, -(-K // block), N, block))


def gemv_candidates(M: int, G: int, N: int) -> tuple:
    """The GEMV's ``(cols, cluster)`` plans for one user of M rows, G
    quant groups and N columns that it takes: each column tile, each
    cluster size dividing G up to ``CLUSTER_MAX`` within ``MAX_CTAS``."""
    from repro_torch.kernels import quant_matmul as qm
    out = []
    for cols in qm.TILE_COLS:
        tiles = -(-N // cols)
        for c in range(1, min(G, qm.CLUSTER_MAX) + 1):
            if G % c == 0 and (c == 1 or tiles * c <= qm.MAX_CTAS):
                out.append((cols, c))
    return tuple(out)


def gemv_plan(M: int, G: int, N: int, tuned) -> object:
    """The ``quant_matmul.GemvPlan`` of one user for a tuned ``(cols,
    cluster)``."""
    from repro_torch.kernels import quant_matmul as qm
    cols, c = tuned
    return qm.GemvPlan(users=1, cols=cols, tiles=-(-N // cols), cluster=c,
                       groups=qm.group_ranges(G, c))
