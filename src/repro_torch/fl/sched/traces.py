"""Client availability traces, port of ``repro.fl.sched.traces`` reduced
to :class:`AvailabilityTrace` and its diurnal ``availability_at``, which
the request-trace driver uses as its rate modulator. Plain numpy.
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

    def availability_at(self, t: float = 0.0) -> np.ndarray:
        """Selection propensity at virtual time ``t``: the static vector,
        diurnally modulated when ``period > 0``."""
        a = np.asarray(self.availability, np.float64)
        if self.period <= 0 or self.amplitude <= 0:
            return a
        cyc = np.sin(2.0 * np.pi * (float(t) / float(self.period) +
                                    np.asarray(self.phase, np.float64)))
        return a * (1.0 + float(self.amplitude) * cyc)
