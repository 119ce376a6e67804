"""``repro_torch.serve`` — deterministic online serving on top of
CompiledGraph, the port of the JAX package's ``repro.serve``.

The serving tier puts heavy request traffic against the compiled stack.
Four pieces:

  * ``workload``  — seeded Poisson/burst request generators (mixed
    prompt/decode lengths, multiple model families);
  * ``bucket``    — the shape-bucketed ``ServingPool``: pre-trace +
    pre-compile the (arch × bucket) lattice of whole-block
    ``CompiledGraph``s through the artifact cache, admission-verifying
    every artifact (``verify_graph``/``verify_placement``) before it may
    serve;
  * ``scheduler`` — estee's static-vs-online split at request level:
    ``StaticBatchScheduler`` one-shot waves vs ``FifoOnlineScheduler``
    continuous batching, plus ``TracingScheduler``/``make_static_scheduler``
    to freeze an online policy into a replayable plan;
  * ``simulate``  — the KV-aware request-level event loop on the fabric
    ``EventSim``, with each bucket's simulated graph makespan as the
    per-step cost oracle.

``python -m repro_torch.serve`` (or ``repro-torch servesim``) is the CLI.
Every latency, makespan and goodput it reports is modelled: the per-step
cost is the fabric simulator's makespan of the compiled block on the
target's cost model, not a time measured on a card.
"""
from __future__ import annotations

from .bucket import (DEFAULT_BUCKETS, ServingPool, WarmedArtifact,
                     bucket_for, kv_bytes)
from .scheduler import (Admission, FifoOnlineScheduler, FixedScheduler,
                        SchedulerBase, StaticBatchScheduler, StaticScheduler,
                        TracingScheduler, make_static_scheduler)
from .simulate import (ServeParams, ServeResult, ServeSim, simulate_serving)
from .workload import (DEFAULT_DECODE_LENS, DEFAULT_PROMPT_LENS, Request,
                       generate_requests, percentile)

__all__ = [
    "Request", "generate_requests", "percentile", "DEFAULT_PROMPT_LENS",
    "DEFAULT_DECODE_LENS", "DEFAULT_BUCKETS", "ServingPool",
    "WarmedArtifact", "bucket_for", "kv_bytes", "Admission",
    "SchedulerBase", "StaticScheduler", "FixedScheduler",
    "StaticBatchScheduler", "FifoOnlineScheduler", "TracingScheduler",
    "make_static_scheduler", "ServeParams", "ServeResult", "ServeSim",
    "simulate_serving",
]
