"""Client availability / heterogeneity traces for the round scheduler,
port of ``repro.fl.sched.traces``.

A trace bundles per-client vectors the policies consume:
``availability`` (selection propensity, diurnally modulated when
``period > 0``), ``speed`` (virtual seconds a local step, the async
event times), ``step_mult`` (local-step multipliers, at most
``strategies.MAX_STEP_MULT``) and ``device_class`` (the chaos layer's
straggler classes and ``History``'s per-class columns).

Plain numpy (``np.random.RandomState``), deterministic in (n, seed), so
the port's traces are bitwise the JAX package's. They round-trip
through JSON (``save_trace`` / ``load_trace``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from repro_torch.fl.strategies import MAX_STEP_MULT


@dataclass(frozen=True)
class AvailabilityTrace:
    availability: np.ndarray   # (n,) float > 0, selection propensity
    speed: np.ndarray          # (n,) float > 0, virtual secs / local step
    step_mult: np.ndarray      # (n,) int in [1, MAX_STEP_MULT]
    name: str = "custom"
    device_class: Any = None   # (n,) small int >= 0; default all-0
    phase: Any = None          # (n,) diurnal phase in [0, 1); default 0
    period: float = 0.0        # diurnal period in virtual secs; 0 = off
    amplitude: float = 0.0     # diurnal modulation depth in [0, 1)

    def __post_init__(self):
        n = len(self.availability)
        if not (len(self.speed) == len(self.step_mult) == n):
            raise ValueError("trace vectors disagree on n_clients")
        if np.any(np.asarray(self.availability) <= 0) or \
                np.any(np.asarray(self.speed) <= 0):
            raise ValueError("availability and speed must be positive")
        m = np.asarray(self.step_mult)
        if np.any(m < 1) or np.any(m > MAX_STEP_MULT):
            raise ValueError(
                f"step_mult must lie in [1, {MAX_STEP_MULT}], got {m}")
        dc = np.zeros(n, np.int32) if self.device_class is None else \
            np.asarray(self.device_class, np.int32)
        ph = np.zeros(n, np.float64) if self.phase is None else \
            np.asarray(self.phase, np.float64)
        if len(dc) != n or len(ph) != n:
            raise ValueError("device_class/phase disagree on n_clients")
        if np.any(dc < 0):
            raise ValueError(f"device_class must be >= 0, got {dc}")
        if not 0.0 <= float(self.amplitude) < 1.0:
            raise ValueError(
                f"amplitude={self.amplitude} outside [0, 1)")
        object.__setattr__(self, "device_class", dc)
        object.__setattr__(self, "phase", ph)

    @property
    def n(self) -> int:
        return len(self.availability)

    @property
    def n_device_classes(self) -> int:
        return int(np.max(self.device_class)) + 1

    def availability_at(self, t: float = 0.0) -> np.ndarray:
        """Selection propensity at virtual time ``t``: the static vector,
        diurnally modulated when ``period > 0``."""
        a = np.asarray(self.availability, np.float64)
        if self.period <= 0 or self.amplitude <= 0:
            return a
        cyc = np.sin(2.0 * np.pi * (float(t) / float(self.period) +
                                    np.asarray(self.phase, np.float64)))
        return a * (1.0 + float(self.amplitude) * cyc)

    def selection_probs(self, t: float = 0.0) -> np.ndarray:
        a = self.availability_at(t)
        return (a / a.sum()).astype(np.float64)


def uniform_trace(n: int) -> AvailabilityTrace:
    """Idealized population: always available, unit speed, homogeneous
    local steps."""
    return AvailabilityTrace(
        availability=np.ones(n, np.float64),
        speed=np.ones(n, np.float64),
        step_mult=np.ones(n, np.int32),
        name="uniform")


def skewed_trace(n: int, seed: int = 0, *, zipf: float = 1.2,
                 speed_sigma: float = 0.6,
                 max_step_mult: int = 1) -> AvailabilityTrace:
    """Long-tail population: Zipf-distributed availability (a few clients
    dominate participation), lognormal speeds, and optional
    heterogeneous local-step multipliers. Deterministic in (n, seed)."""
    rs = np.random.RandomState(seed)
    avail = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** zipf
    rs.shuffle(avail)
    speed = np.exp(rs.normal(0.0, speed_sigma, n))
    mmax = int(np.clip(max_step_mult, 1, MAX_STEP_MULT))
    mult = rs.randint(1, mmax + 1, n).astype(np.int32)
    return AvailabilityTrace(availability=avail, speed=speed,
                             step_mult=mult, name=f"skewed(seed={seed})")


def diurnal_trace(n: int, seed: int = 0, *, period: float = 24.0,
                  amplitude: float = 0.8,
                  class_speed: Sequence[float] = (1.0, 2.0, 4.0),
                  zipf: float = 1.2, speed_sigma: float = 0.25,
                  max_step_mult: int = 1) -> AvailabilityTrace:
    """Fleet-realism population: Zipf base availability under a diurnal
    cycle (per-client phases in [0, 1)), a device-class mix whose classes
    differ in base speed by ``class_speed`` (class 0 fastest), lognormal
    within-class speed spread, and optional heterogeneous step
    multipliers. Deterministic in (n, seed)."""
    rs = np.random.RandomState(seed)
    avail = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** zipf
    rs.shuffle(avail)
    dc = rs.randint(0, len(class_speed), n).astype(np.int32)
    speed = np.asarray(class_speed, np.float64)[dc] * \
        np.exp(rs.normal(0.0, speed_sigma, n))
    phase = rs.rand(n)
    mmax = int(np.clip(max_step_mult, 1, MAX_STEP_MULT))
    mult = rs.randint(1, mmax + 1, n).astype(np.int32)
    return AvailabilityTrace(
        availability=avail, speed=speed, step_mult=mult,
        name=f"diurnal(seed={seed})", device_class=dc, phase=phase,
        period=float(period), amplitude=float(amplitude))


def save_trace(trace: AvailabilityTrace, path) -> None:
    """Write a trace as JSON, so a scenario replays from a file."""
    payload = {
        "name": trace.name,
        "availability": [float(v) for v in trace.availability],
        "speed": [float(v) for v in trace.speed],
        "step_mult": [int(v) for v in trace.step_mult],
        "device_class": [int(v) for v in trace.device_class],
        "phase": [float(v) for v in trace.phase],
        "period": float(trace.period),
        "amplitude": float(trace.amplitude),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def load_trace(path) -> AvailabilityTrace:
    """Load a trace written by :func:`save_trace` (validated again in
    ``__post_init__``)."""
    with open(path) as f:
        d = json.load(f)
    return AvailabilityTrace(
        availability=np.asarray(d["availability"], np.float64),
        speed=np.asarray(d["speed"], np.float64),
        step_mult=np.asarray(d["step_mult"], np.int32),
        name=str(d.get("name", "custom")),
        device_class=np.asarray(d["device_class"], np.int32)
        if "device_class" in d else None,
        phase=np.asarray(d["phase"], np.float64)
        if "phase" in d else None,
        period=float(d.get("period", 0.0)),
        amplitude=float(d.get("amplitude", 0.0)))


def resolve_trace(spec, n: int, *, seed: int = 0) -> AvailabilityTrace:
    """Accept None | "uniform" | "skewed" | "skewed-het" | "diurnal" | a
    ``.json`` trace-file path | an :class:`AvailabilityTrace` (validated
    against n). "skewed-het" adds heterogeneous local-step multipliers
    (up to ``MAX_STEP_MULT``) to the skewed profile."""
    if spec is None or spec == "uniform":
        return uniform_trace(n)
    if spec == "skewed":
        return skewed_trace(n, seed=seed)
    if spec == "skewed-het":
        return skewed_trace(n, seed=seed, max_step_mult=MAX_STEP_MULT)
    if spec == "diurnal":
        return diurnal_trace(n, seed=seed)
    if isinstance(spec, str) and spec.endswith(".json"):
        spec = load_trace(spec)
    if isinstance(spec, AvailabilityTrace):
        if spec.n != n:
            raise ValueError(
                f"trace built for {spec.n} clients, population has {n}")
        return spec
    raise ValueError(f"unknown trace spec {spec!r}")
