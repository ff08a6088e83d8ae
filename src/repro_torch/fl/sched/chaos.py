"""Deterministic fault injection for the round scheduler (the chaos
layer), port of ``repro.fl.sched.chaos``.

Clients drop out mid-round after part of their local steps, go dark for
whole rounds, straggle by device class, and lose or corrupt their uplink
payloads. Every fault is drawn as a deterministic schedule, a pure
function of (chaos key, fault kind, round or dispatch tag, client
position), so a chaos run is as reproducible as a fault-free one and the
stacked engine and the sequential oracle, which share one
:class:`ChaosSchedule` through the scheduler, see the same faults.

Draws: every fault vector is a uniform or normal draw over the whole
population ``(n,)`` at the key ``fold(fold(chaos key, kind tag), tag,
...)``; cohorts index into it, so a client's fault does not depend on who
else was selected. The key is a ``cohort.RoundKey``: in ``run_federated``
the run's key path ``(5,)``, whose draws the JAX package makes with
``jax.random`` and a test can inject.

Recovery, as the schedulers implement it:
- mid-round dropout: the client's work is cut at its last completed step
  ``s`` (the engines' masked scans make that exact) and its delta
  commits with its sample count prorated by ``s / full``;
- dark windows keep a client out of selection for ``unavail_len``
  rounds;
- stragglers stretch virtual durations (sync rounds wait for the
  slowest, async commits reorder);
- a lost uplink is not committed; the client re-sends with bounded
  exponential backoff, and the attempt at ``max_retries`` always
  delivers;
- a corrupt uplink has its quantization scales poisoned to NaN;
  ``server.check_delta`` rejects it (strict mode) or the scheduler skips
  it and counts it (``tolerate_corrupt``).

Every injected fault increments the :class:`FaultLedger` that
``History.meta["fault_ledger"]`` reports.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core.quant import QTensor

# fold_in tags separating the fault streams; primes disjoint from the
# scheduler's selection/dispatch/jitter tags (101/103/107)
_DROP_TAG = 211      # mid-round dropout indicator
_CUT_TAG = 223       # dropout cut-point fraction
_STRAG_TAG = 227     # lognormal straggler multiplier
_LOST_TAG = 229      # uplink loss indicator (per attempt)
_CORR_TAG = 233      # uplink corruption indicator
_DARK_TAG = 239      # unavailability-window starts (per round)
_GAN_TAG = 241       # dropout between GAN launch and resolve

# async dispatches tag their fault draws by a monotone dispatch sequence
# offset far above any round index, so sync (round-tagged) and async
# (dispatch-tagged) streams never collide
ASYNC_TAG0 = 1 << 20


@dataclass(frozen=True)
class ChaosConfig:
    """Fault-injection knobs. Probabilities are per client per round
    (sync) or per dispatch (async); zeros disable that fault."""
    dropout_prob: float = 0.0      # mid-round dropout (partial work)
    unavail_prob: float = 0.0      # dark-window start probability
    unavail_len: int = 2           # dark-window length in rounds
    straggler_sigma: float = 0.0   # lognormal slowdown sigma
    class_mult: Tuple[float, ...] = ()   # per-device-class speed mult
    uplink_loss_prob: float = 0.0  # delta lost in flight (per attempt)
    corrupt_prob: float = 0.0      # delta scales poisoned to NaN
    max_retries: int = 3           # lost-uplink retries before forced ok
    retry_backoff: float = 2.0     # virtual secs, doubled per attempt
    tolerate_corrupt: bool = True  # skip-and-ledger vs raise

    def __post_init__(self):
        for name in ("dropout_prob", "unavail_prob", "uplink_loss_prob",
                     "corrupt_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} outside [0, 1]")
        if self.unavail_len < 1:
            raise ValueError(f"unavail_len={self.unavail_len} < 1")
        if self.max_retries < 1:
            raise ValueError(f"max_retries={self.max_retries} < 1")
        if self.retry_backoff <= 0:
            raise ValueError(
                f"retry_backoff={self.retry_backoff} must be positive")
        if any(m <= 0 for m in self.class_mult):
            raise ValueError(
                f"class_mult entries must be positive: {self.class_mult}")


CHAOS_PRESETS: Dict[str, ChaosConfig] = {
    "light": ChaosConfig(dropout_prob=0.1, straggler_sigma=0.3,
                         uplink_loss_prob=0.05),
    "heavy": ChaosConfig(dropout_prob=0.25, unavail_prob=0.15,
                         straggler_sigma=0.6, uplink_loss_prob=0.15,
                         corrupt_prob=0.05),
}


def resolve_chaos(spec) -> Optional[ChaosConfig]:
    """Accept None | a preset name | a :class:`ChaosConfig`."""
    if spec is None:
        return None
    if isinstance(spec, ChaosConfig):
        return spec
    if isinstance(spec, str):
        if spec in CHAOS_PRESETS:
            return CHAOS_PRESETS[spec]
        raise ValueError(f"unknown chaos preset {spec!r} "
                         f"(have {sorted(CHAOS_PRESETS)})")
    raise ValueError(f"unknown chaos spec {spec!r}")


@dataclass
class FaultLedger:
    """Per-run fault counters, reported as
    ``History.meta["fault_ledger"]``. A summary: the schedule itself is
    replayable from (config, key)."""
    n_dropped: int = 0               # mid-round dropouts
    partial_steps_recovered: int = 0  # local steps salvaged from them
    n_retries: int = 0               # lost-uplink re-sends
    uplinks_lost: int = 0            # lost delivery attempts
    deltas_corrupt: int = 0          # payloads poisoned in flight
    deltas_skipped: int = 0          # rejected by check_delta (tolerant)
    commits_skipped: int = 0         # rounds with zero surviving deltas
    client_rounds_dark: int = 0      # client-rounds inside dark windows
    gan_dropped: int = 0             # clients lost between GAN launch
                                     # and resolve (aug discarded)

    def as_dict(self) -> Dict[str, int]:
        return {k: int(v) for k, v in dataclasses.asdict(self).items()}

    def total(self) -> int:
        """Total injected faults: zero means the run took the fault-free
        path."""
        return sum(self.as_dict().values())


class ChaosSchedule:
    """Deterministic per-client fault schedule plus its ledger, shared by
    a scheduler and its executor. ``key`` is a ``cohort.RoundKey``."""

    def __init__(self, cfg: ChaosConfig, key, trace):
        self.cfg = cfg
        self.trace = trace
        self.n = trace.n
        self._key = key
        self.ledger = FaultLedger()
        self._dark_starts: Dict[int, np.ndarray] = {}

    # -- raw streams ---------------------------------------------------
    def _k(self, *tags):
        k = self._key
        for t in tags:
            k = k.fold(t)
        return k

    def _u(self, *tags) -> np.ndarray:
        """Uniform(0,1) vector over the full population."""
        return np.asarray(self._k(*tags).uniform(self.n), np.float64)

    def _g(self, *tags) -> np.ndarray:
        """Standard-normal vector over the full population."""
        return np.asarray(self._k(*tags).normal(self.n), np.float64)

    # -- fault draws ---------------------------------------------------
    def cut_steps(self, tag: int, sel, n_steps):
        """Mid-round dropout: ``(cut, dropped)``, each selected client's
        completed step count. A dropped client cuts uniformly in
        ``[1, full - 1]`` (never zero steps, which is a dark window, and
        never its last); the others keep their full count."""
        sel = np.asarray(sel, np.int64)
        full = np.asarray(n_steps, np.int64)
        p = self.cfg.dropout_prob
        if p <= 0 or len(sel) == 0:
            return full.copy(), np.zeros(len(sel), bool)
        dropped = (self._u(_DROP_TAG, tag)[sel] < p) & (full > 1)
        frac = self._u(_CUT_TAG, tag)[sel]
        cut = np.where(dropped,
                       1 + np.floor(frac * (full - 1)).astype(np.int64),
                       full)
        return cut, dropped

    def straggler_mult(self, tag: int, sel) -> np.ndarray:
        """Per-dispatch duration multiplier: a lognormal slowdown times
        the client's device-class multiplier."""
        sel = np.asarray(sel, np.int64)
        out = np.ones(len(sel), np.float64)
        if self.cfg.straggler_sigma > 0:
            out = np.exp(
                self.cfg.straggler_sigma * self._g(_STRAG_TAG, tag))[sel]
        if len(self.cfg.class_mult):
            cm = np.asarray(self.cfg.class_mult, np.float64)
            dc = np.asarray(self.trace.device_class, np.int64)[sel]
            out = out * cm[np.clip(dc, 0, len(cm) - 1)]
        return out

    def dark_mask(self, rnd: int) -> np.ndarray:
        """Clients dark at round ``rnd``: a window started within the
        last ``unavail_len`` rounds. Window starts are drawn once per
        round and cached."""
        if self.cfg.unavail_prob <= 0:
            return np.zeros(self.n, bool)
        dark = np.zeros(self.n, bool)
        for r in range(max(0, rnd - self.cfg.unavail_len + 1), rnd + 1):
            starts = self._dark_starts.get(r)
            if starts is None:
                starts = self._u(_DARK_TAG, r) < self.cfg.unavail_prob
                self._dark_starts[r] = starts
            dark |= starts
        return dark

    def uplink_lost(self, tag: int, cid: int, attempt: int) -> bool:
        """Did client ``cid``'s delivery attempt ``attempt`` (0 = first
        send) lose its payload? The attempt at ``max_retries`` always
        delivers."""
        if self.cfg.uplink_loss_prob <= 0 or \
                attempt >= self.cfg.max_retries:
            return False
        return bool(self._u(_LOST_TAG, tag, attempt)[int(cid)] <
                    self.cfg.uplink_loss_prob)

    def corrupt_uplink(self, tag: int, cid: int) -> bool:
        if self.cfg.corrupt_prob <= 0:
            return False
        return bool(self._u(_CORR_TAG, tag)[int(cid)] <
                    self.cfg.corrupt_prob)

    def gan_dropouts(self) -> np.ndarray:
        """Clients that drop between fleet-GAN launch and resolve (their
        synthesized rows are discarded). Drawn once a run."""
        if self.cfg.dropout_prob <= 0:
            return np.zeros(self.n, bool)
        return self._u(_GAN_TAG, 0) < self.cfg.dropout_prob


def corrupt_delta(delta):
    """Poison the first float leaf (in the tree's sorted flattening
    order) of a possibly quantized client delta with NaN: for a QTensor
    leaf its ``scales``, the bytes a flipped wire bit would hit. Tree
    structure and shapes are kept, so only ``server.check_delta``'s
    finiteness guard catches it."""
    target = None
    for path, leaf in tree_lib.flatten_with_path(delta):
        if isinstance(leaf, QTensor) or (
                isinstance(leaf, torch.Tensor) and
                leaf.dtype.is_floating_point):
            target = path
            break
    if target is None:
        raise ValueError("corrupt_delta: no float leaf to poison")

    def f(path, leaf):
        if path != target:
            return leaf
        if isinstance(leaf, QTensor):
            return dataclasses.replace(
                leaf, scales=torch.full_like(leaf.scales, float("nan")))
        return torch.full_like(leaf, float("nan"))

    return tree_lib.map_with_path(f, delta)
