"""Batching pipeline: shuffled epochs, client streams, host-side
prefetch, port of ``repro.data.pipeline``.

``ArrayDataset``, ``client_streams`` and ``lm_sequences`` are numpy and
draw what the JAX package draws, bit for bit: deterministic per-seed
order, epochs without replacement, drop-remainder batching.
``prefetch`` uploads the next batch from a host thread while the
current one computes, through :func:`repro_torch.fl.runtime.upload`
(pinned memory, ``non_blocking=True`` on the card).
"""
from __future__ import annotations

import threading
from queue import Queue
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.fl.runtime import upload


class ArrayDataset:
    """Dict of equal-length arrays with shuffled epoch iteration."""

    def __init__(self, data: Dict[str, np.ndarray], *, seed: int = 0):
        lens = {k: len(v) for k, v in data.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"arrays of unequal length: {lens}")
        self.data = data
        self.n = next(iter(lens.values()))
        self._rng = np.random.RandomState(seed)

    def batches(self, batch_size: int, *, epochs: Optional[int] = None,
                drop_remainder: bool = True) -> Iterator[Dict]:
        epoch = 0
        while epochs is None or epoch < epochs:
            order = self._rng.permutation(self.n)
            stop = self.n - (self.n % batch_size if drop_remainder else 0)
            for i in range(0, stop, batch_size):
                idx = order[i:i + batch_size]
                yield {k: v[idx] for k, v in self.data.items()}
            epoch += 1

    def split(self, fractions, *, seed: int = 0):
        """Deterministic subset split (e.g. train/eval)."""
        rng = np.random.RandomState(seed)
        order = rng.permutation(self.n)
        out, lo = [], 0
        for f in fractions:
            hi = lo + int(round(f * self.n))
            sel = order[lo:hi]
            out.append(ArrayDataset(
                {k: v[sel] for k, v in self.data.items()}, seed=seed))
            lo = hi
        return out


def client_streams(data: Dict[str, np.ndarray], parts, *, batch_size: int,
                   seed: int = 0):
    """One infinite batch iterator per FL client from a partition
    (``repro_torch.fl.partition`` output)."""
    streams = []
    for i, idx in enumerate(parts):
        ds = ArrayDataset({k: v[idx] for k, v in data.items()},
                          seed=seed * 1000 + i)
        bs = min(batch_size, max(1, len(idx)))
        streams.append(ds.batches(bs, epochs=None))
    return streams


def prefetch(it: Iterator, size: int = 2, device=None) -> Iterator:
    """Upload each batch of ``it`` (a tree of numpy arrays) to ``device``
    (the card unless given) from a host thread, up to ``size`` ahead of
    the consumer. An exception in ``it`` is raised to the consumer."""
    dev = resolve_device(device)
    q: Queue = Queue(maxsize=size)
    end = object()
    failed = []

    def worker():
        try:
            for x in it:
                q.put(tree_lib.tree_map(lambda a: upload(a, dev), x))
        except BaseException as e:     # handed to the consumer below
            failed.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        x = q.get()
        if x is end:
            if failed:
                raise failed[0]
            return
        yield x


def lm_sequences(rng: np.random.RandomState, vocab: int, *, n_docs: int,
                 seq: int, bias_lo: int = 0, bias_hi: Optional[int] = None):
    """Structured synthetic LM corpus (learnable bigram repeats) within a
    token sub-range, for non-IID FL client corpora."""
    hi = bias_hi or vocab
    toks = rng.randint(bias_lo, hi, (n_docs, seq + 1))
    toks[:, 2::2] = toks[:, 1:-1:2]
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
