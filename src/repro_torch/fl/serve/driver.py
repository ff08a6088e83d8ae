"""Deterministic request-trace driver for the serving plane, port of
``repro.fl.serve.driver``.

A :class:`RequestTrace` is a Zipf-popularity user stream with
exponential interarrivals whose rate is diurnally modulated through the
scheduler's one-row ``AvailabilityTrace``. :func:`replay` drives a
:class:`~repro_torch.fl.serve.engine.ServeEngine` through the trace on
the virtual clock (``sched.events.EventQueue``): the server admits the
earliest pending request, drains every arrival at or before that
dispatch point into the flight (up to ``max_batch``), and advances a
service-cost model ``service_v = c0 + c1 * bucket``, so flights, queue
depths and virtual latencies are a pure function of (trace, engine
config, cost model). Wall time per dispatch is recorded beside it.
Plain numpy and the standard library: the same trace gives the same
schedule as the JAX package.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.fl import runtime as runtime_lib
from repro_torch.fl.sched.events import EventQueue
from repro_torch.fl.sched.traces import AvailabilityTrace

# virtual service-cost model: a dispatch costs c0 + c1 * bucket seconds
SERVICE_C0 = 2e-3
SERVICE_C1 = 5e-4


@dataclass(frozen=True)
class RequestTrace:
    """``uid[i]`` arrives at virtual time ``t[i]`` (nondecreasing);
    ``n_users`` is the population size the uids index into."""
    uid: np.ndarray
    t: np.ndarray
    n_users: int
    name: str = "custom"

    def __post_init__(self):
        uid = np.asarray(self.uid, np.int64)
        t = np.asarray(self.t, np.float64)
        if uid.shape != t.shape or uid.ndim != 1:
            raise ValueError("uid and t must be equal-length vectors")
        if len(t) and np.any(np.diff(t) < 0):
            raise ValueError("arrival times must be nondecreasing")
        if len(uid) and (uid.min() < 0 or uid.max() >= self.n_users):
            raise ValueError(f"uids outside [0, {self.n_users})")
        object.__setattr__(self, "uid", uid)
        object.__setattr__(self, "t", t)

    @property
    def n(self) -> int:
        return len(self.uid)

    def concurrency(self) -> int:
        """Distinct users in the trace."""
        return len(np.unique(self.uid))


def zipf_request_trace(n_users: int, n_requests: int, *, seed: int = 0,
                       zipf: float = 1.1, rate: float = 32.0,
                       period: float = 0.0, amplitude: float = 0.0,
                       phase: float = 0.25) -> RequestTrace:
    """Zipf-popularity request stream with exponential interarrivals at
    base ``rate`` per virtual second, diurnally modulated when
    ``period > 0``. Deterministic in (n_users, n_requests, seed)."""
    if n_users < 1 or n_requests < 1:
        raise ValueError("need at least one user and one request")
    rs = np.random.RandomState(seed)
    pop = 1.0 / np.arange(1, n_users + 1, dtype=np.float64) ** zipf
    rs.shuffle(pop)
    pop /= pop.sum()
    uids = rs.choice(n_users, size=n_requests, p=pop)
    mod = AvailabilityTrace(
        availability=np.ones(1), speed=np.ones(1),
        step_mult=np.ones(1, np.int32), phase=np.asarray([phase]),
        period=float(period), amplitude=float(amplitude),
        name="request-rate")
    t, now = np.zeros(n_requests), 0.0
    for i in range(n_requests):
        r = rate * float(mod.availability_at(now)[0])
        now += rs.exponential(1.0 / r)
        t[i] = now
    name = f"zipf(seed={seed})" if period <= 0 else \
        f"zipf-diurnal(seed={seed})"
    return RequestTrace(uid=uids, t=t, n_users=n_users, name=name)


def save_request_trace(trace: RequestTrace, path) -> None:
    with open(path, "w") as f:
        json.dump({"name": trace.name, "n_users": int(trace.n_users),
                   "uid": [int(u) for u in trace.uid],
                   "t": [float(v) for v in trace.t]}, f, indent=1)


def load_request_trace(path) -> RequestTrace:
    with open(path) as f:
        d = json.load(f)
    return RequestTrace(uid=np.asarray(d["uid"], np.int64),
                        t=np.asarray(d["t"], np.float64),
                        n_users=int(d["n_users"]),
                        name=str(d.get("name", "custom")))


def replay(engine, trace: RequestTrace, images, *,
           service: Tuple[float, float] = (SERVICE_C0, SERVICE_C1),
           collect_logits: bool = True) -> Dict[str, Any]:
    """Replay ``trace`` through ``engine`` on the virtual clock;
    ``images[i]`` is request i's input. Returns per-request virtual
    latency (+ p50/p99), the flight schedule, wall time per dispatch,
    throughput, and the store's hit/miss/eviction delta."""
    if len(images) != trace.n:
        raise ValueError(
            f"images ({len(images)}) must align with the trace rows "
            f"({trace.n})")
    c0, c1 = service
    q = EventQueue()
    for i, at in enumerate(trace.t):
        q.push(float(at), i)
    s0 = engine.store.stats()
    lat_v = np.zeros(trace.n)
    logits = [None] * trace.n if collect_logits else None
    flights = []
    free_v = 0.0
    wall_total = 0.0
    while len(q):
        at, rid, _ = q.pop()
        start = max(free_v, at)
        batch = [rid]
        # drain everything that arrived by the dispatch point
        while len(q) and len(batch) < engine.cfg.max_batch:
            t_next, _, _ = q.peek()
            if t_next > start:
                break
            _, r, _ = q.pop()
            batch.append(r)
        B = runtime_lib.bucket_width(len(batch), engine.cfg.max_batch)
        done = start + c0 + c1 * B
        w0 = time.perf_counter()
        out, info = engine.serve(
            [(int(trace.uid[r]), images[r]) for r in batch])
        wall = time.perf_counter() - w0
        wall_total += wall
        for j, r in enumerate(batch):
            lat_v[r] = done - trace.t[r]
            if collect_logits:
                logits[r] = out[j]
        flights.append({"start_v": start, "n": len(batch), "bucket": B,
                        "groups": info["groups"], "wall_s": wall})
        free_v = done
    s1 = engine.store.stats()
    makespan_v = free_v - float(trace.t[0]) if trace.n else 0.0
    rec = {
        "trace": trace.name,
        "n_requests": trace.n,
        "concurrency": trace.concurrency(),
        "n_flights": len(flights),
        "flights": flights,
        "lat_v": lat_v,
        "lat_v_p50": float(np.percentile(lat_v, 50)),
        "lat_v_p99": float(np.percentile(lat_v, 99)),
        "throughput_v": trace.n / max(makespan_v, 1e-12),
        "wall_s": wall_total,
        "throughput_wall": trace.n / max(wall_total, 1e-12),
        "store": {k: s1[k] - s0[k]
                  for k in ("hits", "misses", "evictions")},
    }
    rec["store"]["hit_rate"] = (
        rec["store"]["hits"] /
        max(rec["store"]["hits"] + rec["store"]["misses"], 1))
    if collect_logits:
        rec["logits"] = np.stack(logits)
    return rec
