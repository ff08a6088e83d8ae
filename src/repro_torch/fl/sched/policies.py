"""Round-scheduler policies, port of ``repro.fl.sched.policies``: who
trains when, and how updates land.

A ``Scheduler`` sits between the simulator and the round executor:

 - ``select(rnd, key) -> Cohort`` picks the participating clients
   (sorted positions, their local-step counts and staleness);
 - the executor trains them: the stacked cohort engine (``CohortExec``)
   or the per-client reference loop (``SequentialExec``);
 - the sync policies land the update inside the round (FedAvg over the
   subset's renormalized weights); the async policy buffers per-client
   deltas and commits M at a time with staleness-discounted weights
   ``w_i ∝ m_i (1+τ_i)^(-β)`` (FedBuff).

``step(global_tr, rnd, key)`` is the driver the simulator calls once per
History row: one sync round, or one async buffer flush.

Every random draw goes through the ``cohort.RoundKey`` the simulator
passes in, at the JAX package's ``fold_in`` tags: selection
``fold(key, 101)``, async dispatch ``fold(key, 103)`` (``102`` / ``104``
at back-fill) and jitter ``fold(dispatch key, 107)``. Batch indices of
a sync round come from the round key itself (so sync-partial at K = N
draws the full round's batches), those of an async wave from its
dispatch key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core.quant import QTensor
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl import runtime as runtime_lib
from repro_torch.fl import server
from repro_torch.fl.sched import chaos as chaos_lib
from repro_torch.fl.sched.events import EventQueue
from repro_torch.fl.sched.traces import AvailabilityTrace

# fold_in tags separating a round key's streams; batch indices use the
# raw round key
_SEL_TAG = 101
_DISPATCH_TAG = 103
_JITTER_TAG = 107


@dataclass(frozen=True)
class Cohort:
    """One scheduled unit of local work: client positions (sorted), their
    local step counts, and the server-version staleness of their base
    model."""
    sel: np.ndarray
    n_steps: np.ndarray
    staleness: np.ndarray

    @property
    def k(self) -> int:
        return len(self.sel)


def staleness_weights(masses, staleness, beta: float) -> np.ndarray:
    """FedBuff-style aggregation weights ``w_i ∝ m_i (1+τ_i)^(-β)``,
    normalized to sum 1; at β = 0 exactly sample-count FedAvg."""
    m = np.asarray(masses, np.float64)
    tau = np.asarray(staleness, np.float64)
    w = m * (1.0 + tau) ** (-float(beta))
    total = w.sum()
    if not np.isfinite(total) or total <= 0:
        raise ValueError(
            f"degenerate staleness weights: masses={m}, tau={tau}")
    return (w / total).astype(np.float32)


# ---------------------------------------------------------------------
# executors: how a scheduled cohort actually trains
# ---------------------------------------------------------------------

def stack_client_deltas(deltas: Sequence):
    """Restack per-client delta trees (``cohort.slice_client_delta``'s)
    on a fresh leading cohort axis, QTensor metadata as
    ``comm_quantize_stacked`` gives it, for ``server.aggregate_stacked``."""
    def f(*leaves):
        l0 = leaves[0]
        if isinstance(l0, QTensor):
            return QTensor(
                q=torch.stack([l.q for l in leaves]),
                scales=torch.stack([l.scales for l in leaves]),
                bits=l0.bits, mode=l0.mode, block=l0.block,
                out_dtype=l0.out_dtype,
                orig_shape=(len(leaves),) + tuple(l0.orig_shape))
        return torch.stack(leaves)

    return tree_lib.tree_map(f, *deltas)


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

    def run_wave(self, global_tr, cohort: Cohort, key):
        delta, m = self.engine.run_wave(global_tr, cohort.sel, key,
                                        n_steps=cohort.n_steps)
        return [cohort_lib.slice_client_delta(delta, j)
                for j in range(cohort.k)], m

    def commit_buffer(self, global_tr, weights, deltas):
        w = np.asarray(weights, np.float32)
        server.check_weights(w, len(deltas))          # on the host
        dev = self.engine.pool_labs.device
        stacked = stack_client_deltas(deltas)
        if getattr(self.engine, "shards", 1) > 1:
            # a mesh-sharded engine commits hierarchically, as its rounds
            # aggregate (the buffer's size need not divide the shard
            # count: aggregate_tree zero-pads)
            return server.aggregate_tree(
                global_tr, runtime_lib.upload(w, dev), stacked,
                n_shards=self.engine.shards)
        return server.aggregate_stacked(
            global_tr, runtime_lib.upload(w, dev), stacked)

    def client_masses(self) -> np.ndarray:
        """Per-client sample counts over the full population (the m_i of
        every weighting rule; chaos prorates them by completed steps)."""
        return np.asarray(self.engine.client_n, np.float64)


class SequentialExec:
    """Reference executor: per-client loop over ``Client.local_train``,
    driven by the *same* batch-index stream as the stacked engine
    (``cohort.round_indices``), so the two executors are parity oracles
    for each other under every policy."""
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

    def run_wave(self, global_tr, cohort: Cohort, key):
        outs, metrics = self._train(global_tr, cohort, key)
        return [o[1] for o in outs], metrics

    def commit_buffer(self, global_tr, weights, deltas):
        # server.aggregate renormalizes masses; the weights already sum
        # to 1, so they pass through unchanged
        return server.aggregate(
            global_tr, list(zip(np.asarray(weights, np.float64), deltas)))

    def client_masses(self) -> np.ndarray:
        return np.asarray([c.n for c in self.clients], np.float64)


# ---------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------

class Scheduler:
    """Base policy machinery. Subclasses implement ``select`` and (for
    buffered policies) ``commit``; ``step`` is the simulator-facing
    driver producing exactly one committed aggregation per call."""
    name = "base"

    def __init__(self, *, executor, trace: AvailabilityTrace,
                 local_steps: int, clients_per_round: int = 0,
                 chaos: Optional[chaos_lib.ChaosSchedule] = None):
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
        # one fault schedule serves both executors (None = fault-free)
        self.chaos = chaos
        if chaos is not None and chaos.n != self.n:
            raise ValueError(
                f"chaos schedule built for {chaos.n} clients, trace has "
                f"{self.n}")
        # lost-uplink retry queue (sync policies): cid -> next attempt
        # number; retried clients are re-selected first the next round
        self._retryq: Dict[int, int] = {}
        # sync virtual clock under chaos: a barrier round lasts as long
        # as its slowest (straggler-stretched) participant
        self._vt = 0.0
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
        """Availability-weighted draw of k distinct client positions from
        ``pool`` (default: everyone) at the trace's propensity at virtual
        time ``rnd``."""
        if pool is None:
            pool = np.arange(self.n, dtype=np.int32)
        pool = np.asarray(pool, np.int32)
        if k >= len(pool):
            return pool
        probs = np.asarray(self.trace.availability_at(float(rnd)),
                           np.float64)[pool]
        return pool[key.choice(len(pool), k, probs / probs.sum())]

    # -- policy surface ----------------------------------------------
    def select(self, rnd: int, key) -> Cohort:
        raise NotImplementedError

    def prepare_rounds(self, round_keys) -> int:
        """Pre-draw the selections of ``round_keys`` (``(rnd, key)``
        pairs) so the round loop never waits on one; only stateless
        policies can (the base declines, returning 0)."""
        return 0

    def commit(self, global_tr, updates, round_tag):
        """Sync policies aggregate inside the round: identity."""
        return global_tr

    def step(self, global_tr, rnd: int, key):
        raise NotImplementedError

    def warmup(self, global_tr, key):
        """Build every program this policy dispatches, on a throwaway
        copy of the global trainables, before the clock starts."""
        raise NotImplementedError


class SyncPartialScheduler(Scheduler):
    """K of N clients per round (availability-weighted) as one subset
    round; the update lands in the round with subset-renormalized FedAvg
    weights. K = N with a uniform trace is the full round exactly."""
    name = "sync-partial"

    def select(self, rnd: int, key) -> Cohort:
        pre = self._presel.pop(rnd, None)
        return pre if pre is not None else self._select_now(rnd, key)

    def prepare_rounds(self, round_keys) -> int:
        if self.chaos is not None:
            # chaos selection depends on the retry queue: stateful
            return 0
        for rnd, key in round_keys:
            self._presel[rnd] = self._select_now(rnd, key)
        return len(round_keys)

    def _select_now(self, rnd: int, key) -> Cohort:
        ksel = key.fold(_SEL_TAG)
        if self.chaos is None:
            return self._cohort_for(self._draw_clients(ksel, self.k, rnd))
        # chaos: dark-window clients are out of the draw, and lost-uplink
        # clients are re-selected first (bounded retry across rounds)
        ch = self.chaos
        dark = ch.dark_mask(rnd)
        ch.ledger.client_rounds_dark += int(dark.sum())
        pool = np.where(~dark)[0].astype(np.int32)
        if len(pool) == 0:
            # nobody reachable: take everyone rather than stall the run
            pool = np.arange(self.n, dtype=np.int32)
        forced = np.asarray(
            sorted(c for c in self._retryq if not dark[c]),
            np.int32)[:self.k]
        rest = pool[~np.isin(pool, forced)]
        k_rest = self.k - len(forced)
        drawn = self._draw_clients(ksel, k_rest, rnd, pool=rest) \
            if k_rest > 0 and len(rest) else np.zeros((0,), np.int32)
        sel = np.concatenate([forced, drawn]) if len(forced) else drawn
        if len(sel) == 0:
            sel = forced if len(forced) else pool[:1]
        return self._cohort_for(sel)

    def _chaos_step(self, global_tr, rnd: int, key):
        """One sync round under fault injection, run as a wave so each
        client's delta is on hand for uplink loss and corruption; the
        survivors commit with sample counts prorated by completed steps,
        renormalized over the committed set."""
        ch = self.chaos
        cohort = self.select(rnd, key)
        full = np.asarray(cohort.n_steps, np.int64)
        cut, dropped = ch.cut_steps(rnd, cohort.sel, full)
        ch.ledger.n_dropped += int(dropped.sum())
        ch.ledger.partial_steps_recovered += int(cut[dropped].sum())
        work = Cohort(sel=cohort.sel, n_steps=cut.astype(np.int32),
                      staleness=cohort.staleness)
        deltas, m = self.exec.run_wave(global_tr, work, key)
        # the barrier waits for the slowest straggler-stretched client
        dur = (np.asarray(self.trace.speed, np.float64)[cohort.sel] *
               cut * ch.straggler_mult(rnd, cohort.sel))
        self._vt += float(dur.max()) if len(dur) else 1.0
        attempts = np.asarray([self._retryq.get(int(c), 0)
                               for c in cohort.sel], np.int64)
        ch.ledger.n_retries += int((attempts > 0).sum())
        masses = self.exec.client_masses()[cohort.sel] * \
            (cut / np.maximum(full, 1))
        keep, kept_deltas, kept_masses = [], [], []
        for j, cid in enumerate(np.asarray(cohort.sel)):
            cid = int(cid)
            if ch.uplink_lost(rnd, cid, int(attempts[j])):
                ch.ledger.uplinks_lost += 1
                self._retryq[cid] = int(attempts[j]) + 1
                continue
            self._retryq.pop(cid, None)
            d = deltas[j]
            if ch.corrupt_uplink(rnd, cid):
                ch.ledger.deltas_corrupt += 1
                d = chaos_lib.corrupt_delta(d)
            if not server.delta_ok(d, global_tr):
                if not ch.cfg.tolerate_corrupt:
                    server.check_delta(
                        d, global_tr,
                        ctx=f"client {cid} delta (round {rnd})")
                ch.ledger.deltas_skipped += 1
                continue
            keep.append(j)
            kept_deltas.append(d)
            kept_masses.append(masses[j])
        if keep:
            w = np.asarray(kept_masses, np.float64)
            w = (w / w.sum()).astype(np.float32)
            new_tr = self.exec.commit_buffer(global_tr, w, kept_deltas)
        else:
            ch.ledger.commits_skipped += 1
            new_tr = global_tr
        m = {
            "loss": [m["loss"][j] for j in keep],
            "acc": [m["acc"][j] for j in keep],
            "uplink_bytes": int(m["uplink_bytes"]),
            "participation": np.asarray(cohort.sel)[
                np.asarray(keep, np.int64)],
            "staleness": np.zeros(len(keep), np.int32),
            "vtime": float(self._vt)}
        return new_tr, m

    def step(self, global_tr, rnd: int, key):
        if self.chaos is not None:
            return self._chaos_step(global_tr, rnd, key)
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
        if self.chaos is not None:
            # chaos rounds dispatch the wave program (host-side commit)
            runtime_lib._wait(self.exec.run_wave(copy, cohort, key)[0])
            return
        runtime_lib._wait(self.exec.run_sync(copy, cohort, key)[0])


class FullSyncScheduler(SyncPartialScheduler):
    """Every client, every round: the degenerate sync-partial policy
    (K = N, identity selection). With a homogeneous step profile on the
    cohort executor and no chaos it dispatches the gather-free
    full-round program."""
    name = "full-sync"

    def __init__(self, *, executor, trace, local_steps, chaos=None):
        super().__init__(executor=executor, trace=trace,
                         local_steps=local_steps, clients_per_round=0,
                         chaos=chaos)

    def _select_now(self, rnd: int, key) -> Cohort:
        if self.chaos is None:
            return self._cohort_for(np.arange(self.n, dtype=np.int32))
        # everyone reachable: dark windows shrink the cohort
        dark = self.chaos.dark_mask(rnd)
        self.chaos.ledger.client_rounds_dark += int(dark.sum())
        sel = np.where(~dark)[0].astype(np.int32)
        if len(sel) == 0:
            sel = np.arange(self.n, dtype=np.int32)
        return self._cohort_for(sel)

    def _gather_free(self) -> bool:
        return self.exec.kind == "cohort" and \
            int(self._mult.max()) == 1 and self.chaos is None

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
        runtime_lib._wait(self.exec.run_full(copy, key)[0])


class AsyncBufferedScheduler(Scheduler):
    """FedBuff-style asynchronous aggregation on a virtual clock.

    ``concurrency`` clients train at once; a job dispatched with
    ``n_steps_i`` steps finishes ``speed[i] * n_steps_i * (1 + 0.1 u)``
    virtual seconds later (``u`` uniform from the dispatch key). Finished
    updates enter a buffer in finish order with staleness ``τ =
    server_version - base_version``; a full buffer commits with weights
    ``w_i ∝ m_i (1+τ_i)^(-β)``, and the freed slots back-fill with an
    availability-weighted draw from the idle population (neither in
    flight nor buffered), trained from the new global. Local training
    runs as stacked waves of width ``concurrency`` (the first) and
    ``buffer_size`` (every back-fill). One ``step`` = one commit = one
    History row."""
    name = "async"

    def __init__(self, *, executor, trace, local_steps,
                 clients_per_round: int = 0, staleness_beta: float = 0.5,
                 concurrency: int = 0, client_n: Sequence[float],
                 chaos=None):
        super().__init__(executor=executor, trace=trace,
                         local_steps=local_steps,
                         clients_per_round=clients_per_round, chaos=chaos)
        self.buffer_size = self.k
        self.concurrency = min(self.n, concurrency or 2 * self.k)
        if self.concurrency < self.buffer_size:
            raise ValueError(
                f"async concurrency {self.concurrency} below buffer "
                f"size {self.buffer_size}: the buffer could never fill")
        self.beta = float(staleness_beta)
        self.client_n = np.asarray(client_n, np.float64)
        self.queue = EventQueue()
        self.version = 0
        self._inflight: Dict[int, dict] = {}
        self._buffer: List[dict] = []
        self._started = False
        # monotone dispatch counter: async chaos draws are tagged per
        # dispatch, so the fault schedule is a function of dispatch order
        self._dseq = 0
        self._committed: List[dict] = []

    # -- event-loop internals -----------------------------------------
    def _durations(self, sel: np.ndarray, n_steps: np.ndarray, key,
                   tag=None):
        u = key.fold(_JITTER_TAG).uniform(len(sel))
        speed = np.asarray(self.trace.speed)[sel]
        dur = speed * np.asarray(n_steps, np.float64) * (1.0 + 0.1 * u)
        if self.chaos is not None and tag is not None:
            dur = dur * self.chaos.straggler_mult(tag, sel)
        return dur

    def _dispatch(self, global_tr, sel, key):
        """Run one wave for ``sel`` from the current global model (batch
        indices from the dispatch ``key``) and schedule the finish
        events. Under chaos the dispatch draws its faults first:
        dropouts cut step counts, stragglers stretch finish times, and
        each entry keeps its completed-step fraction for the commit."""
        cohort = self._cohort_for(sel)
        scale = np.ones(cohort.k, np.float64)
        tag = None
        if self.chaos is not None:
            ch = self.chaos
            tag = chaos_lib.ASYNC_TAG0 + self._dseq
            self._dseq += 1
            full = np.asarray(cohort.n_steps, np.int64)
            cut, dropped = ch.cut_steps(tag, cohort.sel, full)
            ch.ledger.n_dropped += int(dropped.sum())
            ch.ledger.partial_steps_recovered += int(cut[dropped].sum())
            scale = cut / np.maximum(full, 1)
            cohort = Cohort(sel=cohort.sel, n_steps=cut.astype(np.int32),
                            staleness=cohort.staleness)
        deltas, m = self.exec.run_wave(global_tr, cohort, key)
        durations = self._durations(cohort.sel, cohort.n_steps, key, tag)
        for j, ci in enumerate(cohort.sel):
            ci = int(ci)
            self.queue.push(self.queue.now + float(durations[j]), ci)
            # loss/acc stay device scalars until the simulator's ring
            # flush: reading one here would wait on the device
            self._inflight[ci] = {
                "delta": deltas[j], "base_version": self.version,
                "loss": m["loss"][j], "acc": m["acc"][j],
                "bytes": m["uplink_bytes"] // cohort.k,
                "scale": float(scale[j]), "tag": tag}

    def _fill_buffer(self):
        """Drain finish events until the buffer holds ``buffer_size``
        updates, in finish order. Under chaos a lost uplink re-queues
        with exponential backoff, its attempt count in the event tag;
        the attempt at ``max_retries`` always delivers."""
        while len(self._buffer) < self.buffer_size:
            if not len(self.queue):
                raise RuntimeError(
                    "async event queue drained with an unfilled buffer")
            t, cid, attempt = self.queue.pop()
            job = self._inflight[cid]
            if self.chaos is not None and \
                    self.chaos.uplink_lost(job["tag"], cid, attempt):
                ch = self.chaos
                ch.ledger.uplinks_lost += 1
                ch.ledger.n_retries += 1
                self.queue.push(
                    t + ch.cfg.retry_backoff * (2.0 ** attempt), cid,
                    attempt + 1)
                continue
            del self._inflight[cid]
            self._buffer.append(dict(job, cid=cid,
                                     tau=self.version -
                                     job["base_version"], finish=t,
                                     attempts=attempt))

    def _backfill_draw(self, key, rnd: int = 0) -> np.ndarray:
        """Pick ``buffer_size`` idle clients to dispatch next,
        availability-weighted at the current virtual time; under chaos
        dark clients are left out when enough lit ones remain."""
        busy = set(self._inflight) | {e["cid"] for e in self._buffer}
        idle = np.asarray([i for i in range(self.n) if i not in busy],
                          np.int32)
        k = self.buffer_size
        if self.chaos is not None and len(idle):
            dark = self.chaos.dark_mask(rnd)
            self.chaos.ledger.client_rounds_dark += int(dark[idle].sum())
            lit = idle[~dark[idle]]
            if len(lit) >= k:
                idle = lit
        if len(idle) < k:
            raise RuntimeError(
                f"{len(idle)} idle clients cannot back-fill {k} slots")
        if len(idle) == k:
            return idle
        probs = np.asarray(self.trace.availability_at(self.queue.now),
                           np.float64)[idle]
        return idle[key.choice(len(idle), k, probs / probs.sum())]

    def select(self, rnd: int, key) -> Cohort:
        """The next commit's cohort (fills the buffer from pending finish
        events; dispatches nothing)."""
        self._fill_buffer()
        entries = self._buffer[:self.buffer_size]
        return self._cohort_for([e["cid"] for e in entries],
                                staleness=[e["tau"] for e in entries])

    def commit(self, global_tr, updates, round_tag):
        """Staleness-discounted buffer flush in finish order. Under chaos
        the masses are prorated by completed steps, corrupt deltas are
        skipped and counted (or raise, strict mode), and a flush with no
        survivor leaves the global and the server version as they
        were."""
        entries = updates
        if self.chaos is not None:
            ch = self.chaos
            kept = []
            for e in entries:
                d = e["delta"]
                if ch.corrupt_uplink(e["tag"], e["cid"]):
                    ch.ledger.deltas_corrupt += 1
                    d = chaos_lib.corrupt_delta(d)
                if not server.delta_ok(d, global_tr):
                    if not ch.cfg.tolerate_corrupt:
                        server.check_delta(
                            d, global_tr,
                            ctx=f"async client {e['cid']} delta")
                    ch.ledger.deltas_skipped += 1
                    continue
                kept.append(e)
            self._committed = kept
            if not kept:
                ch.ledger.commits_skipped += 1
                return global_tr
            entries = kept
            masses = self.client_n[[e["cid"] for e in entries]] * \
                np.asarray([e["scale"] for e in entries], np.float64)
        else:
            self._committed = list(entries)
            masses = self.client_n[[e["cid"] for e in entries]]
        w = staleness_weights(masses, [e["tau"] for e in entries],
                              self.beta)
        new_tr = self.exec.commit_buffer(
            global_tr, w, [e["delta"] for e in entries])
        self.version += 1
        return new_tr

    def step(self, global_tr, rnd: int, key):
        if not self._started:
            pool = None
            if self.chaos is not None:
                dark = self.chaos.dark_mask(rnd)
                self.chaos.ledger.client_rounds_dark += int(dark.sum())
                lit = np.where(~dark)[0].astype(np.int32)
                if len(lit) >= self.concurrency:
                    pool = lit
            sel = self._draw_clients(key.fold(_SEL_TAG), self.concurrency,
                                     rnd, pool=pool)
            self._dispatch(global_tr, sel, key.fold(_DISPATCH_TAG))
            self._started = True
        self._fill_buffer()
        entries = self._buffer[:self.buffer_size]
        self._buffer = self._buffer[self.buffer_size:]
        new_tr = self.commit(global_tr, entries, rnd)
        # back-fill the freed slots from the idle population, training
        # from the new global at the current virtual time
        sel = self._backfill_draw(key.fold(_SEL_TAG + 1), rnd)
        self._dispatch(new_tr, sel, key.fold(_DISPATCH_TAG + 1))
        # metrics cover the committed set; uplink bytes count every
        # delivery attempt of the flushed entries
        logged = self._committed if self.chaos is not None else entries
        m = {
            "loss": [e["loss"] for e in logged],
            "acc": [e["acc"] for e in logged],
            "uplink_bytes": int(sum(
                e["bytes"] * (1 + e.get("attempts", 0))
                for e in entries)),
            "participation": np.asarray([e["cid"] for e in logged],
                                        np.int32),
            "staleness": np.asarray([e["tau"] for e in logged], np.int32),
            "vtime": float(self.queue.now)}
        return new_tr, m

    def warmup(self, global_tr, key):
        if self.exec.kind != "cohort":
            return
        copy = tree_lib.tree_map(torch.clone, global_tr)
        for width in sorted({self.concurrency, self.buffer_size}):
            cohort = self._cohort_for(np.arange(width, dtype=np.int32))
            runtime_lib._wait(self.exec.run_wave(copy, cohort, key)[0])


def make_scheduler(participation: str, *, executor, trace,
                   local_steps: int, clients_per_round: int = 0,
                   staleness_beta: float = 0.5, concurrency: int = 0,
                   client_n: Optional[Sequence[float]] = None,
                   chaos: Optional[chaos_lib.ChaosSchedule] = None):
    """Policy factory keyed by ``FLConfig.participation``."""
    if participation == "full":
        if clients_per_round not in (0, trace.n):
            raise ValueError(
                f"clients_per_round={clients_per_round} is meaningless "
                "for participation='full' (every client trains every "
                "round) — use 'sync-partial' or 'async'")
        return FullSyncScheduler(executor=executor, trace=trace,
                                 local_steps=local_steps, chaos=chaos)
    if participation == "sync-partial":
        return SyncPartialScheduler(
            executor=executor, trace=trace, local_steps=local_steps,
            clients_per_round=clients_per_round, chaos=chaos)
    if participation == "async":
        if client_n is None:
            raise ValueError("async scheduling needs per-client sample "
                             "counts (client_n) for FedBuff weighting")
        return AsyncBufferedScheduler(
            executor=executor, trace=trace, local_steps=local_steps,
            clients_per_round=clients_per_round,
            staleness_beta=staleness_beta, concurrency=concurrency,
            client_n=client_n, chaos=chaos)
    raise ValueError(f"unknown participation policy {participation!r}")
