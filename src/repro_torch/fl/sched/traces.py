"""Client availability traces, port of ``repro.fl.sched.traces`` reduced
to :class:`AvailabilityTrace` (its diurnal ``availability_at`` is the
request-trace driver's rate modulator) and the uniform trace that the
full-participation round runs under. Plain numpy. The skewed and
diurnal traces and trace files wait for ``ROADMAP.md`` Queue A item 6.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

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


def uniform_trace(n: int) -> AvailabilityTrace:
    """Idealized population: always available, unit speed, homogeneous
    local steps."""
    return AvailabilityTrace(
        availability=np.ones(n, np.float64),
        speed=np.ones(n, np.float64),
        step_mult=np.ones(n, np.int32),
        name="uniform")


def resolve_trace(spec, n: int, *, seed: int = 0) -> AvailabilityTrace:
    """``None`` or ``"uniform"``; any other spec raises (the skewed and
    diurnal traces, trace files and custom traces are ``ROADMAP.md``
    Queue A item 6)."""
    if spec is None or spec == "uniform":
        return uniform_trace(n)
    raise NotImplementedError(
        f"trace {spec!r}: the port runs the uniform trace only so far "
        "(ROADMAP.md Queue A item 6)")
