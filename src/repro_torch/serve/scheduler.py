"""Request schedulers — estee's static-vs-online split, at request level.

The shapes mirror estee (SNIPPETS.md snippet 2): every scheduler gets
``init(simulator)`` and reacts to ``schedule(new_ready, new_finished)``
events; a ``StaticScheduler`` emits its whole plan once; a
``TracingScheduler`` records whatever its inner scheduler emits; and
``make_static_scheduler(cls)`` freezes an online policy by running a
traced *offline* simulation and replaying the recorded admissions.

A schedule result is a sequence of ``Admission(rid, wave)`` records — the
policy decision is the admission *order*, and the simulator derives the
timing from the hard constraints (arrival, KV budget, batch cap,
head-of-line order).  ``wave`` encodes formation semantics:

  * ``wave == 0`` — continuous: admit as soon as constraints allow;
  * ``wave >= 1`` — one-shot batch: every same-wave request must have
    arrived and every lower-wave request must have *completed* before any
    member is admitted (the static baseline's formation + drain waste).

Because timing is constraint-derived, replaying a traced admission
sequence through ``FixedScheduler`` reproduces the original run exactly —
the frozen-schedule acceptance test (and the ``srv.replay-drift`` rule)
pin that down.
"""
from __future__ import annotations

from typing import NamedTuple


class Admission(NamedTuple):
    """One scheduling decision: admit request ``rid`` under ``wave``
    semantics (0 = continuous, >=1 = atomic one-shot wave)."""

    rid: int
    wave: int = 0


class SchedulerBase:
    """React to request-level events; emit ``Admission`` records."""

    name = "base"

    def init(self, simulator) -> None:
        self.simulator = simulator

    def schedule(self, new_ready, new_finished):
        return ()


class StaticScheduler(SchedulerBase):
    """Offline planner: computes the whole admission plan once (it may
    inspect the simulator's full workload — it is an *offline* policy) and
    stays silent afterwards."""

    def init(self, simulator) -> None:
        super().init(simulator)
        self.scheduled = False

    def schedule(self, new_ready, new_finished):
        if self.scheduled:
            return ()
        self.scheduled = True
        return self.static_schedule()

    def static_schedule(self):
        raise NotImplementedError()


class FixedScheduler(StaticScheduler):
    """Replay a pre-recorded admission sequence (e.g. a frozen trace)."""

    name = "fixed"

    def __init__(self, schedules):
        self.schedules = [Admission(*a) for a in schedules]

    def static_schedule(self):
        return list(self.schedules)


class StaticBatchScheduler(StaticScheduler):
    """The one-shot baseline: FIFO waves of at most ``max_batch`` requests
    (each wave also sized to the KV budget), wave *k+1* forming only after
    wave *k* fully drains and every member has arrived."""

    name = "static"

    def static_schedule(self):
        sim = self.simulator
        plan, wave, batch, kv = [], 1, 0, 0
        for r in sim.requests:
            need = sim.request_kv(r)
            if batch and (batch + 1 > sim.params.max_batch
                          or kv + need > sim.params.kv_budget):
                wave += 1
                batch = kv = 0
            plan.append(Admission(r.rid, wave))
            batch += 1
            kv += need
        return plan


class FifoOnlineScheduler(SchedulerBase):
    """Continuous batching: every newly-arrived request is offered for
    admission immediately (wave 0); the simulator's KV-aware admission
    control decides *when* it actually joins the running batch."""

    name = "online-fifo"

    def schedule(self, new_ready, new_finished):
        return [Admission(r.rid, 0) for r in new_ready]


class TracingScheduler(SchedulerBase):
    """Record every admission an inner scheduler emits, in emission
    order — the trace ``make_static_scheduler`` freezes."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self.name = f"traced-{scheduler.name}"

    def init(self, simulator) -> None:
        self.schedules: list[Admission] = []
        self.scheduler.init(simulator)

    def schedule(self, new_ready, new_finished):
        results = list(self.scheduler.schedule(new_ready, new_finished))
        self.schedules += results
        return results


def make_static_scheduler(cls):
    """Freeze an online policy: run a traced offline simulation of the
    same workload, then replay the recorded admission sequence as a static
    plan.  Deterministic simulator + constraint-derived timing ⇒ the
    frozen run completes every request at the identical time."""

    class Static(StaticScheduler):
        name = f"static-{cls.name}"

        def __init__(self, *args, **kwargs):
            self.scheduler = cls(*args, **kwargs)

        def static_schedule(self):
            tracer = TracingScheduler(self.scheduler)
            offline = self.simulator.respawn(tracer)
            offline.run()
            return list(tracer.schedules)

    return Static
