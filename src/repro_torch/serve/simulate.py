"""The request-level serving simulator — continuous batching on the event
timeline.

``ServeSim`` runs one engine: at every iteration the running batch is
grouped by (arch, bucket), each group costs
``ceil(n / tile_batch) × makespan`` of its pre-compiled block
(``simulate_kernel_graph``'s modeled makespan, via the ``ServingPool``
artifacts — the inner per-step cost oracle), and every member advances one
step (first the prefill, then one decode token per iteration).  Admission
happens only at iteration boundaries and is **KV-aware**: a request joins
the batch when its padded KV footprint fits the byte budget and the batch
cap, in the order the scheduler decided (head-of-line).  The iteration
timeline itself is laid on the fabric ``EventSim`` — one FIFO "engine"
resource, one task per iteration — so the run is auditable by
``verify_task_graph`` exactly like the collective timelines.

Everything is deterministic: seeded workload in, bit-identical
p50/p99/goodput out, on any machine.  Every time here is modelled (the
cost model of the compiled target), not measured on a card.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field

from ..fabric.simulate import EventSim
from .bucket import bucket_for
from .workload import percentile

TRACE_SCHEMA = 1


@dataclass(frozen=True)
class ServeParams:
    """Engine/admission knobs (all modeled)."""

    max_batch: int = 8          # requests per iteration, hard cap
    kv_budget: int = 1 << 20    # KV-cache bytes the engine may hold
    tile_batch: int = 4         # requests one block replay serves at once
    slo_mult: float = 8.0       # SLO = slo_mult x the request's solo time

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class RequestRecord:
    """Per-request lifecycle: arrive → admit → bucket → … → complete."""

    rid: int
    arch: str
    arrival: float
    prompt_len: int
    decode_len: int
    bucket: int
    kv_bytes: int
    admitted: float | None = None
    completed: float | None = None

    @property
    def latency(self) -> float | None:
        if self.completed is None:
            return None
        return self.completed - self.arrival

    @property
    def tokens(self) -> int:
        return self.prompt_len + self.decode_len

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class _Live:
    """A request currently in the running batch."""

    record: RequestRecord
    steps_left: int
    wave: int


@dataclass
class ServeResult:
    """One simulated run: records, per-iteration timeline, metrics, and
    the auditable EventSim task pairs."""

    scheduler: str
    params: ServeParams
    buckets: tuple
    records: list = field(default_factory=list)
    iterations: list = field(default_factory=list)
    metrics: dict = field(default_factory=dict)
    tasks: list = field(default_factory=list)

    def completion_times(self) -> dict[int, float]:
        return {r.rid: r.completed for r in self.records
                if r.completed is not None}

    def trace(self) -> dict:
        """The serializable run trace ``repro_torch.verify.serve`` checks."""
        return {"schema": TRACE_SCHEMA, "scheduler": self.scheduler,
                "params": self.params.to_dict(),
                "buckets": list(self.buckets),
                "requests": [r.to_dict() for r in self.records],
                "iterations": [dict(i) for i in self.iterations],
                "metrics": dict(self.metrics)}


class ServeSim:
    """Drive one scheduler over one workload against one warmed pool."""

    def __init__(self, requests, pool, scheduler, params: ServeParams):
        self.requests = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self.pool = pool
        self.scheduler = scheduler
        self.params = params
        self._by_rid = {r.rid: r for r in self.requests}

    def respawn(self, scheduler) -> "ServeSim":
        """A fresh simulator over the same workload/pool/params — what
        ``make_static_scheduler`` traces offline."""
        return ServeSim(self.requests, self.pool, scheduler, self.params)

    # -- per-request oracle --------------------------------------------------
    def request_kv(self, req) -> int:
        return self.pool.route(req).kv_bytes

    def solo_time(self, req) -> float:
        """Service time of the request alone on an idle engine: one block
        replay per step (prefill + each decode token)."""
        return (1 + req.decode_len) * self.pool.route(req).makespan

    def _iteration_cost(self, running: dict) -> float:
        groups: dict[tuple, int] = {}
        for lv in running.values():
            key = (lv.record.arch, lv.record.bucket)
            groups[key] = groups.get(key, 0) + 1
        cost = 0.0
        for (arch, bucket) in sorted(groups):
            n = groups[(arch, bucket)]
            cost += (math.ceil(n / self.params.tile_batch)
                     * self.pool.get(arch, bucket).makespan)
        return cost

    # -- admission control ---------------------------------------------------
    def _admit(self, pending, running, records, now) -> list[int]:
        """Pop head-of-line admissions whose constraints hold at ``now``:
        arrived, wave formed (wave >= 1: all members arrived, all lower
        waves drained), batch cap, KV budget."""
        admitted = []
        while pending:
            adm = pending[0]
            req = self._by_rid[adm.rid]
            if req.arrival > now:
                break
            if adm.wave >= 1:
                same = [a for a in pending if a.wave == adm.wave]
                if any(self._by_rid[a.rid].arrival > now for a in same):
                    break
                if any(lv.wave < adm.wave for lv in running.values()):
                    break
            if len(running) + 1 > self.params.max_batch:
                break
            need = self.request_kv(req)
            if self._kv_used + need > self.params.kv_budget:
                break
            pending.pop(0)
            rec = records[req.rid]
            rec.admitted = now
            running[req.rid] = _Live(record=rec,
                                     steps_left=1 + req.decode_len,
                                     wave=adm.wave)
            self._kv_used += need
            admitted.append(req.rid)
        return admitted

    # -- the run -------------------------------------------------------------
    def run(self) -> ServeResult:
        self.scheduler.init(self)
        records = {}
        for r in self.requests:
            b = bucket_for(r.prompt_len, self.pool.buckets)
            records[r.rid] = RequestRecord(
                rid=r.rid, arch=r.arch, arrival=r.arrival,
                prompt_len=r.prompt_len, decode_len=r.decode_len,
                bucket=b, kv_bytes=self.pool.get(r.arch, b).kv_bytes)
        pending: list = []
        running: dict[int, _Live] = {}
        iterations: list[dict] = []
        self._kv_used = 0
        esim = EventSim()
        prev_tid = None
        t = 0.0
        i_next = 0
        it = 0
        just_admitted: list[int] = []

        def collect_ready(now):
            nonlocal i_next
            ready = []
            while i_next < len(self.requests) \
                    and self.requests[i_next].arrival <= now:
                ready.append(self.requests[i_next])
                i_next += 1
            return ready

        while True:
            if not running:
                if i_next < len(self.requests):
                    t = max(t, self.requests[i_next].arrival)
                    new_ready = collect_ready(t)
                    pending += list(self.scheduler.schedule(new_ready, []))
                    just_admitted += self._admit(pending, running, records, t)
                    continue
                # no arrivals left: one final decision point, then either
                # the batch runs or whatever is still pending is starved —
                # the loop ends cleanly and srv.starvation flags the trace.
                pending += list(self.scheduler.schedule([], []))
                just_admitted += self._admit(pending, running, records, t)
                if not running:
                    break
            duration = self._iteration_cost(running)
            tid = f"iter:{it}"
            esim.add(tid, resource="engine", duration=duration,
                     deps=(prev_tid,) if prev_tid else (), ready=t)
            start, end = esim.run()[tid]
            if start != t:      # EventSim is the timing authority
                raise AssertionError(
                    f"iteration {it} start {start} != boundary {t}")
            iterations.append({
                "i": it, "start": start, "duration": duration,
                "running": sorted(running), "admitted": sorted(just_admitted),
                "kv_used": self._kv_used})
            just_admitted = []
            prev_tid, t, it = tid, end, it + 1
            finished = []
            for rid in list(running):
                lv = running[rid]
                lv.steps_left -= 1
                if lv.steps_left == 0:
                    lv.record.completed = t
                    self._kv_used -= lv.record.kv_bytes
                    finished.append(self._by_rid[rid])
                    del running[rid]
            new_ready = collect_ready(t)
            pending += list(self.scheduler.schedule(new_ready, finished))
            just_admitted += self._admit(pending, running, records, t)

        recs = [records[r.rid] for r in self.requests]
        metrics = self._metrics(recs, t, it)
        return ServeResult(
            scheduler=getattr(self.scheduler, "name", "?"),
            params=self.params, buckets=self.pool.buckets, records=recs,
            iterations=iterations, metrics=metrics, tasks=esim.tasks)

    def _metrics(self, recs, makespan: float, iterations: int) -> dict:
        done = [r for r in recs if r.completed is not None]
        lats = [r.latency for r in done]
        good_tokens = 0
        for r in done:
            slo = self.params.slo_mult * self.solo_time(self._by_rid[r.rid])
            if r.latency <= slo:
                good_tokens += r.tokens
        return {
            "n_requests": len(recs), "completed": len(done),
            "starved": len(recs) - len(done),
            "iterations": iterations, "makespan_s": makespan,
            "p50_latency_s": percentile(lats, 50.0),
            "p99_latency_s": percentile(lats, 99.0),
            "good_tokens": good_tokens,
            "goodput_tps": (good_tokens / makespan) if makespan > 0 else 0.0,
        }


def simulate_serving(requests, pool, scheduler,
                     params: ServeParams | None = None) -> ServeResult:
    """One-call entry: run ``scheduler`` over ``requests`` against the
    warmed ``pool``."""
    return ServeSim(requests, pool, scheduler,
                    params or ServeParams()).run()
