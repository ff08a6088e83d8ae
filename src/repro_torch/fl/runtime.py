"""Bucketed program runtime, port of ``repro.fl.runtime`` reduced to what
the serving plane calls.

PyTorch runs eagerly, so "compiling" a program is building its callable
once: :class:`ProgramRuntime` caches the built callable by (kind, static
key, argument shapes/dtypes) and keeps the JAX package's ledger
(``n_compiles`` per kind, plus auxiliary counters charged through
:meth:`ProgramRuntime.count`). Shape bucketing is unchanged, so a
request-size sweep builds O(log max_batch) programs as in the reference.
CUDA-graph capture and ``Handle`` come later.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.quant import QTensor

# Cohort-width buckets below this floor are not worth separate programs.
MIN_COHORT_BUCKET = 4


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"pow2_ceil needs n >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def bucket_width(k: int, n: int, *,
                 min_bucket: int = MIN_COHORT_BUCKET) -> int:
    """Bucket for a selection of ``k`` out of ``n``: the next power of two
    (floored at ``min_bucket``), clamped to ``n``; ``k == n`` never pads."""
    if not 1 <= k <= n:
        raise ValueError(f"selection width {k} out of range for {n}")
    if k >= n:
        return n
    return min(n, max(min_bucket, pow2_ceil(k)))


def bucket_rows(n: int, cap: int) -> int:
    """Row-count bucket for chunked row-wise programs: the next power of
    two, clamped to ``cap``."""
    if n < 1:
        raise ValueError(f"bucket_rows needs n >= 1, got {n}")
    return min(int(cap), pow2_ceil(n))


def pad_leading(arr: torch.Tensor, width: int, fill=0) -> torch.Tensor:
    """Zero-(or ``fill``-)pad ``arr`` along axis 0 to ``width`` rows."""
    n = arr.shape[0]
    if n == width:
        return arr
    if n > width:
        raise ValueError(f"cannot pad {n} rows down to {width}")
    pad = torch.full((width - n,) + tuple(arr.shape[1:]), fill,
                     dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def _sig(args) -> Tuple:
    out = []
    for leaf in tree_lib.leaves(args):
        if isinstance(leaf, QTensor):
            out.append(("q", tuple(leaf.q.shape), str(leaf.q.dtype),
                        tuple(leaf.scales.shape)))
        else:
            out.append((tuple(getattr(leaf, "shape", ())),
                        str(getattr(leaf, "dtype", type(leaf).__name__))))
    return tuple(out)


class ProgramRuntime:
    """One program cache + accounting ledger for the serving plane."""

    def __init__(self):
        self._progs: Dict[Tuple, Callable] = {}
        self._kinds: Dict[str, Dict[str, float]] = {}

    def compile(self, kind: str, build: Callable[[], Callable], args, *,
                static_key: Tuple = ()) -> Callable:
        """The program ``build()`` for ``args``' shapes, built (and charged
        to ``kind``) only on a cache miss. ``static_key`` must capture
        everything the program closes over that the shapes do not show."""
        key = (kind, static_key, _sig(args))
        fn = self._progs.get(key)
        if fn is None:
            t0 = time.perf_counter()
            fn = self._progs[key] = build()
            k = self._kinds.setdefault(
                kind, {"n_compiles": 0, "compile_time_s": 0.0})
            k["n_compiles"] += 1
            k["compile_time_s"] += time.perf_counter() - t0
        return fn

    def count(self, kind: str, counter: str, n: int = 1) -> None:
        """Charge ``n`` to an auxiliary per-kind counter in the ledger."""
        k = self._kinds.setdefault(
            kind, {"n_compiles": 0, "compile_time_s": 0.0})
        k[counter] = int(k.get(counter, 0)) + int(n)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self._kinds.items()}
