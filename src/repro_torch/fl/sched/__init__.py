"""Federated round scheduler, port of ``repro.fl.sched``: who trains
when, and how updates land.

A ``Scheduler`` turns "run R rounds" into a participation policy over a
round executor (the stacked cohort engine or the sequential per-client
oracle). The port has the full-sync policy (every client every round,
the degenerate sync-partial policy) and the uniform trace; sync-partial
and async participation, the other traces and chaos fault injection
raise until ``ROADMAP.md`` Queue A item 6.
"""
from repro_torch.fl.sched.events import EventQueue
from repro_torch.fl.sched.policies import (Cohort, CohortExec,
                                           FullSyncScheduler, Scheduler,
                                           SequentialExec,
                                           SyncPartialScheduler,
                                           make_scheduler)
from repro_torch.fl.sched.traces import (AvailabilityTrace, resolve_trace,
                                         uniform_trace)


def resolve_chaos(spec):
    """``None`` (fault-free) only; a preset or config raises."""
    if spec is None:
        return None
    raise NotImplementedError(
        f"chaos {spec!r}: fault injection is not ported yet "
        "(ROADMAP.md Queue A item 6)")


__all__ = [
    "AvailabilityTrace", "Cohort", "CohortExec", "EventQueue",
    "FullSyncScheduler", "Scheduler", "SequentialExec",
    "SyncPartialScheduler", "make_scheduler", "resolve_chaos",
    "resolve_trace", "uniform_trace",
]
