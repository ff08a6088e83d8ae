"""Round-scheduler policies, port of ``repro.fl.sched.policies``: the
full-participation path.

A ``Scheduler`` sits between the simulator and the round executor:
``select(rnd, key) -> Cohort`` picks the participating clients (sorted
positions, their local-step counts and staleness), the executor trains
them — the stacked cohort engine (``CohortExec``) or the per-client
reference loop (``SequentialExec``) — and the sync policies land the
update inside the round (weighted FedAvg). ``step(global_tr, rnd, key)``
is the driver the simulator calls once per History row.

Ported: ``FullSyncScheduler`` (every client, every round) and the
fault-free selection, pre-drawing, step and warm-up of
``SyncPartialScheduler`` that it inherits. Drawing K < N clients,
the async policy and chaos wait for ``ROADMAP.md`` Queue A item 6.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl import runtime as runtime_lib
from repro_torch.fl import server
from repro_torch.fl.sched.traces import AvailabilityTrace

_ITEM6 = "(ROADMAP.md Queue A item 6)"


@dataclass(frozen=True)
class Cohort:
    """One scheduled unit of local work: client positions (sorted), their
    local step counts, and the server-version staleness of their base
    model."""
    sel: np.ndarray
    n_steps: np.ndarray
    staleness: np.ndarray


# ---------------------------------------------------------------------
# executors: how a scheduled cohort actually trains
# ---------------------------------------------------------------------

class CohortExec:
    """Stacked-engine executor: one program per cohort call."""
    kind = "cohort"

    def __init__(self, engine):
        self.engine = engine

    def run_sync(self, global_tr, cohort: Cohort, key):
        return self.engine.run_subset_round(global_tr, cohort.sel, key,
                                            n_steps=cohort.n_steps)

    def run_full(self, global_tr, key):
        """The gather-free full-cohort program (homogeneous steps)."""
        return self.engine.run_round(global_tr, key)

    def client_masses(self) -> np.ndarray:
        """Per-client sample counts over the full population."""
        return np.asarray(self.engine.client_n, np.float64)


class SequentialExec:
    """Reference executor: per-client loop over ``Client.local_train``,
    driven by the *same* batch-index stream as the stacked engine
    (``cohort.round_indices``), so the two executors are parity oracles
    for each other."""
    kind = "sequential"

    def __init__(self, *, clients, frozen, ccfg, class_emb, local_steps,
                 batch_size, lr):
        self.clients = list(clients)
        self.frozen = frozen
        self.ccfg = ccfg
        self.class_emb = class_emb
        self.local_steps = local_steps
        self.batch_size = batch_size
        self.lr = lr
        self.lens = np.asarray(
            [len(c.pool()[1]) for c in self.clients], np.int64)
        self.max_steps = local_steps * max(
            c.local_steps_for(1) for c in self.clients)

    def _train(self, global_tr, cohort: Cohort, key):
        idx = cohort_lib.round_indices(
            key, self.lens[cohort.sel], self.max_steps, self.batch_size)
        if int(np.max(cohort.n_steps)) > self.max_steps:
            raise ValueError(
                f"n_steps {cohort.n_steps} exceed the staged maximum "
                f"{self.max_steps}; set Client.step_mult to match the "
                "trace before building the executor")
        outs = []
        for j, ci in enumerate(np.asarray(cohort.sel)):
            c = self.clients[int(ci)]
            n_j = int(cohort.n_steps[j])
            tr_after, m = c.local_train(
                self.frozen, global_tr, self.class_emb, self.ccfg,
                steps=n_j, batch_size=self.batch_size, lr=self.lr,
                indices=idx[j][:n_j])
            upd, nbytes = c.make_update(global_tr, tr_after)
            outs.append((c, upd, nbytes, m))
        metrics = {
            "loss": np.asarray([o[3]["loss"] for o in outs]),
            "acc": np.asarray([o[3]["acc"] for o in outs]),
            "uplink_bytes": int(sum(o[2] for o in outs)),
            "sel": np.asarray(cohort.sel)}
        return outs, metrics

    def run_sync(self, global_tr, cohort: Cohort, key):
        outs, metrics = self._train(global_tr, cohort, key)
        new_tr = server.aggregate(
            global_tr, [(o[0].n, o[1]) for o in outs])
        return new_tr, metrics

    def client_masses(self) -> np.ndarray:
        return np.asarray([c.n for c in self.clients], np.float64)


# ---------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------

class Scheduler:
    """Base policy machinery. Subclasses implement ``select``; ``step`` is
    the simulator-facing driver producing exactly one committed
    aggregation per call."""
    name = "base"

    def __init__(self, *, executor, trace: AvailabilityTrace,
                 local_steps: int, clients_per_round: int = 0,
                 chaos=None):
        if chaos is not None:
            raise NotImplementedError(f"chaos fault injection {_ITEM6}")
        self.exec = executor
        self.trace = trace
        self.local_steps = local_steps
        self.n = trace.n
        k = clients_per_round or self.n
        if not (1 <= k <= self.n):
            raise ValueError(
                f"clients_per_round={clients_per_round} out of range for "
                f"{self.n} active clients")
        self.k = k
        self._mult = np.asarray(trace.step_mult, np.int32)
        # pre-drawn selections (pipelined mode): rnd -> Cohort
        self._presel: Dict[int, Cohort] = {}

    # -- helpers ------------------------------------------------------
    def _cohort_for(self, sel, staleness=None) -> Cohort:
        sel = np.asarray(sel, np.int32)
        order = np.argsort(sel, kind="stable")
        sel = sel[order]
        stal = np.zeros(len(sel), np.int32) if staleness is None else \
            np.asarray(staleness, np.int32)[order]
        return Cohort(sel=sel,
                      n_steps=self.local_steps * self._mult[sel],
                      staleness=stal)

    def _draw_clients(self, key, k: int, rnd: int = 0,
                      pool=None) -> np.ndarray:
        """k distinct client positions from ``pool`` (default: everyone).
        Only the degenerate draw (k covers the pool) is ported."""
        if pool is None:
            pool = np.arange(self.n, dtype=np.int32)
        pool = np.asarray(pool, np.int32)
        if k >= len(pool):
            return pool
        raise NotImplementedError(
            f"availability-weighted draws of {k} of {len(pool)} clients "
            f"{_ITEM6}")

    # -- policy surface ----------------------------------------------
    def select(self, rnd: int, key) -> Cohort:
        raise NotImplementedError

    def prepare_rounds(self, round_keys) -> int:
        return 0

    def commit(self, global_tr, updates, round_tag):
        """Sync policies aggregate inside the round: identity."""
        return global_tr

    def step(self, global_tr, rnd: int, key):
        raise NotImplementedError

    def warmup(self, global_tr, key):
        raise NotImplementedError


class SyncPartialScheduler(Scheduler):
    """K of N clients per round as one subset round; the update lands in
    the round with subset-renormalized FedAvg weights. The port has the
    fault-free form only, and its K < N draw raises."""
    name = "sync-partial"

    def select(self, rnd: int, key) -> Cohort:
        pre = self._presel.pop(rnd, None)
        return pre if pre is not None else self._select_now(rnd, key)

    def prepare_rounds(self, round_keys) -> int:
        """Pre-draw the selections for ``round_keys`` (``(rnd, key)``
        pairs), so the round loop never waits on one."""
        for rnd, key in round_keys:
            self._presel[rnd] = self._select_now(rnd, key)
        return len(round_keys)

    def _select_now(self, rnd: int, key) -> Cohort:
        return self._cohort_for(self._draw_clients(key, self.k, rnd))

    def step(self, global_tr, rnd: int, key):
        cohort = self.select(rnd, key)
        new_tr, m = self.exec.run_sync(global_tr, cohort, key)
        new_tr = self.commit(new_tr, None, rnd)
        m = dict(m, participation=cohort.sel,
                 staleness=cohort.staleness, vtime=float(rnd + 1))
        return new_tr, m

    def warmup(self, global_tr, key):
        if self.exec.kind != "cohort":
            return    # the sequential oracle builds no round program
        cohort = self._cohort_for(np.arange(self.k, dtype=np.int32))
        copy = tree_lib.tree_map(torch.clone, global_tr)
        out = self.exec.run_sync(copy, cohort, key)
        runtime_lib._wait(out[0])


class FullSyncScheduler(SyncPartialScheduler):
    """Every client, every round: the degenerate sync-partial policy
    (K = N, identity selection). With a homogeneous step profile on the
    cohort executor it dispatches the gather-free full-round program."""
    name = "full-sync"

    def __init__(self, *, executor, trace, local_steps, chaos=None):
        super().__init__(executor=executor, trace=trace,
                         local_steps=local_steps, clients_per_round=0,
                         chaos=chaos)

    def _select_now(self, rnd: int, key) -> Cohort:
        return self._cohort_for(np.arange(self.n, dtype=np.int32))

    def _gather_free(self) -> bool:
        return self.exec.kind == "cohort" and int(self._mult.max()) == 1

    def step(self, global_tr, rnd: int, key):
        if not self._gather_free():
            return super().step(global_tr, rnd, key)
        cohort = self.select(rnd, key)
        new_tr, m = self.exec.run_full(global_tr, key)
        m = dict(m, participation=cohort.sel,
                 staleness=cohort.staleness, vtime=float(rnd + 1))
        return new_tr, m

    def warmup(self, global_tr, key):
        if not self._gather_free():
            return super().warmup(global_tr, key)
        copy = tree_lib.tree_map(torch.clone, global_tr)
        out = self.exec.run_full(copy, key)
        runtime_lib._wait(out[0])


def make_scheduler(participation: str, *, executor, trace,
                   local_steps: int, clients_per_round: int = 0,
                   staleness_beta: float = 0.5, concurrency: int = 0,
                   client_n: Optional[Sequence[float]] = None,
                   chaos=None):
    """Policy factory keyed by ``FLConfig.participation``."""
    if participation == "full":
        if clients_per_round not in (0, trace.n):
            raise ValueError(
                f"clients_per_round={clients_per_round} is meaningless "
                "for participation='full' (every client trains every "
                "round) — use 'sync-partial' or 'async'")
        return FullSyncScheduler(executor=executor, trace=trace,
                                 local_steps=local_steps, chaos=chaos)
    if participation in ("sync-partial", "async"):
        raise NotImplementedError(
            f"participation={participation!r} {_ITEM6}")
    raise ValueError(f"unknown participation policy {participation!r}")
