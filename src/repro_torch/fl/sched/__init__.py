"""Federated round scheduler, port of ``repro.fl.sched``: who trains
when, and how updates land.

Three policies share one API (``Scheduler.select`` / ``commit`` /
``step`` / ``warmup``): ``full-sync`` (every client every round, the
degenerate sync-partial policy), ``sync-partial`` (K of N clients a
round, availability-weighted, as one subset round on the stacked
engine's staged pools at a power-of-two bucketed width) and ``async``
(FedBuff-style buffered asynchrony on a deterministic virtual clock,
stacked waves a dispatch, staleness-discounted commits, freed slots
back-filled from the idle population).

The chaos layer (``chaos``) injects fleet faults into all three:
mid-round dropout with exact partial work through the engines' masked
scans, dark windows, device-class stragglers, lost and corrupt uplinks
with bounded retry, and the GAN drop between launch and resolve; all
drawn at the true population shape through the run's injected draws and
counted in a ``FaultLedger``.
"""
from repro_torch.fl.sched.chaos import (CHAOS_PRESETS, ChaosConfig,
                                        ChaosSchedule, FaultLedger,
                                        corrupt_delta, resolve_chaos)
from repro_torch.fl.sched.events import EventQueue
from repro_torch.fl.sched.policies import (AsyncBufferedScheduler, Cohort,
                                           CohortExec, FullSyncScheduler,
                                           Scheduler, SequentialExec,
                                           SyncPartialScheduler,
                                           make_scheduler,
                                           stack_client_deltas,
                                           staleness_weights)
from repro_torch.fl.sched.traces import (AvailabilityTrace, diurnal_trace,
                                         load_trace, resolve_trace,
                                         save_trace, skewed_trace,
                                         uniform_trace)

__all__ = [
    "AsyncBufferedScheduler", "AvailabilityTrace", "CHAOS_PRESETS",
    "ChaosConfig", "ChaosSchedule", "Cohort", "CohortExec",
    "EventQueue", "FaultLedger", "FullSyncScheduler", "Scheduler",
    "SequentialExec", "SyncPartialScheduler", "corrupt_delta",
    "diurnal_trace", "load_trace", "make_scheduler", "resolve_chaos",
    "resolve_trace", "save_trace", "skewed_trace",
    "stack_client_deltas", "staleness_weights", "uniform_trace",
]
