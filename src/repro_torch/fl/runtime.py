"""Bucketed program runtime, port of ``repro.fl.runtime``.

PyTorch runs eagerly, so "compiling" a program is building its callable
once: :class:`ProgramRuntime` caches the built callable by (kind, static
key, argument shapes/dtypes), bounded by an LRU of ``max_entries``, and
keeps the JAX package's ledger under the same names (``n_compiles`` and
``compile_time_s`` per kind, ``n_evicted``, auxiliary counters charged
through :meth:`ProgramRuntime.count`), so ``History.meta`` has the same
keys. Shape bucketing is unchanged, so a request-size sweep builds
O(log max_batch) programs as in the reference.

``dispatch`` returns a :class:`Handle` over the outputs without waiting:
on the card the ops are queued on the stream, and ``Handle.result()`` /
``ProgramRuntime.sync`` are the counted points where the host waits
(``SYNC_TRACES``). The port frees nothing the caller holds, so there is
no buffer donation and no donation hazard. CUDA-graph capture waits for
``ROADMAP.md`` Queue A item 5.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.quant import QTensor

# Host-sync ledger: the counted points where the host waits on the
# device, by tag (the ``KERNEL_TRACES`` pattern).
SYNC_TRACES: Dict[str, int] = {}


def sync_count(tag: str, n: int = 1) -> None:
    """Charge ``n`` host-sync events to ``tag`` in ``SYNC_TRACES``."""
    SYNC_TRACES[tag] = SYNC_TRACES.get(tag, 0) + int(n)


def reset_sync_traces() -> None:
    SYNC_TRACES.clear()


def _wait(tree) -> None:
    """Block until the device work behind ``tree``'s tensors is done."""
    devs = set()
    for leaf in tree_lib.leaves(tree):
        t = leaf.q if isinstance(leaf, QTensor) else leaf
        if isinstance(t, torch.Tensor) and t.is_cuda:
            devs.add(t.device)
    for d in devs:
        torch.cuda.synchronize(d)

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


class Handle:
    """Non-blocking view of a dispatched program's outputs. ``out`` is
    the output tree (its device work possibly still queued);
    ``result()`` waits for it once, counting the wait in ``SYNC_TRACES``
    (tags ``handle_wait`` and ``handle_wait:<kind>``)."""

    __slots__ = ("kind", "_out", "_done")

    def __init__(self, out, *, kind: str = "anon"):
        self.kind = kind
        self._out = out
        self._done = False

    @property
    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            sync_count("handle_wait")
            sync_count(f"handle_wait:{self.kind}")
            _wait(self._out)
            self._done = True
        return self._out

    @property
    def out(self):
        return self._out


class ProgramRuntime:
    """One program cache + accounting ledger shared by a run's engines.
    ``max_entries`` bounds the cache with LRU eviction (0 = unbounded);
    an evicted program is built again (and charged again) on its next
    use, and evictions count per kind as ``n_evicted``."""

    def __init__(self, max_entries: int = 0):
        if max_entries < 0:
            raise ValueError(f"max_entries={max_entries} must be >= 0 "
                             "(0 disables eviction)")
        self.max_entries = int(max_entries)
        self._progs: "OrderedDict[Tuple, Callable]" = OrderedDict()
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
            while self.max_entries and len(self._progs) > self.max_entries:
                old_key, _ = self._progs.popitem(last=False)
                ok = self._kinds.setdefault(
                    old_key[0], {"n_compiles": 0, "compile_time_s": 0.0})
                ok["n_evicted"] = int(ok.get("n_evicted", 0)) + 1
        else:
            self._progs.move_to_end(key)
        return fn

    def dispatch(self, kind: str, build, args, *,
                 static_key: Tuple = ()) -> Handle:
        """Build-or-hit, then call without waiting on the device."""
        out = self.compile(kind, build, args, static_key=static_key)(*args)
        return Handle(out, kind=kind)

    def run(self, kind: str, build, args, *, static_key: Tuple = ()):
        """The handle-free form of :meth:`dispatch`: the output tree."""
        return self.dispatch(kind, build, args, static_key=static_key).out

    def sync(self, tree, tag: str = "sync"):
        """Wait for a tree of device tensors in bulk, charging one
        host-sync event to ``tag``; non-tensor leaves pass through."""
        sync_count(tag)
        _wait(tree)
        return tree

    def count(self, kind: str, counter: str, n: int = 1) -> None:
        """Charge ``n`` to an auxiliary per-kind counter in the ledger."""
        k = self._kinds.setdefault(
            kind, {"n_compiles": 0, "compile_time_s": 0.0})
        k[counter] = int(k.get(counter, 0)) + int(n)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self._kinds.items()}

    @property
    def n_compiles(self) -> int:
        return sum(int(v["n_compiles"]) for v in self._kinds.values())

    @property
    def compile_time_s(self) -> float:
        return sum(v["compile_time_s"] for v in self._kinds.values())

    @property
    def n_evictions(self) -> int:
        """Total LRU evictions (0 while the cache is unbounded)."""
        return sum(int(v.get("n_evicted", 0)) for v in self._kinds.values())

    def subtotal(self, prefix: str) -> Tuple[int, float]:
        """(n_compiles, compile_time_s) summed over kinds starting with
        ``prefix``."""
        n, t = 0, 0.0
        for k, v in self._kinds.items():
            if k.startswith(prefix):
                n += int(v["n_compiles"])
                t += v["compile_time_s"]
        return n, t
