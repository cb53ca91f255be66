"""Check-serving subsystem: a persistent, multi-tenant checking service.

The port of the JAX package's ``serve`` package on the port's ladder,
checkers and services.  Every one-shot entry point pays its own launch,
small histories waste ladder lanes, and nothing arbitrates concurrent
callers for the device.  This package is the serving layer on top of
the checker pipeline — the shape that made batched decoding practical
(continuously pack independent small requests into one padded launch;
cf. arXiv:2010.02164's streaming batched beam search) applied to the
WGL ladder:

  * ``CheckService`` — admission queue (per-request priority, deadline,
    client id), a batching scheduler that packs compatible queued
    histories into shared ``parallel.batch.batch_analysis`` launches
    keyed by padded geometry, per-request result demux via futures, and
    explicit backpressure (bounded queue depth, ``QueueFull`` with a
    retry-after estimate).
  * Graceful drain: shutdown checkpoints still-queued work through
    ``store.checkpoint`` so a restarted operator can finish it with
    ``resume_drained``; the drain dirs are the JAX package's, and each
    package resumes the other's.
  * ``serve.*`` telemetry (queue depth, admission latency, batch
    occupancy, padding waste, per-request end-to-end latency) into the
    obs tables (``telemetry.json``'s "serve" section, and
    ``obs.critpath.decompose_requests``).

Scheduling is delegated to ``serve.sched``: admission into
latency-class queues (``interactive`` fast path vs ``batch`` tier,
per-class backpressure/retry-after), CONTINUOUS packing (rung-boundary
admission into running ladders via ``batch_analysis(admission=...)``),
and placement on a mesh of logical shards (``devices=N`` /
``verify_placement``).

Self-healing is delegated to ``serve.health``: poison-request
quarantine (bisect a non-transiently failing shared launch, quarantine
the poison member by history fingerprint), a circuit breaker (K
consecutive batch failures → ``ServiceUnavailable`` + retry-after,
half-open probe), a hung-launch watchdog (EWMA-derived wall-clock caps,
abandon-and-retry on reduced placement), shard-loss re-placement (mesh
health probes, shrink to survivors + parity re-probe), a crash-safe
fsync'd admission journal replayed by ``start()``, and idempotent
resubmission.  ``serve.slo`` evaluates burn-rate objectives over the
live metrics registry.

Exposure: this Python API (``submit(history, ...) -> Future[verdict]``).
Not ported yet: the fleet router (``serve.fleet``, ROADMAP A10.4; its
``SharedQuarantine`` is here, in ``serve.health``), the HTTP API of the
JAX package's ``web`` module (A10.3) and the ``serve --check`` CLI
(A10.11).

Streaming (``checker.streaming``): beside the request queues the
service runs a bounded lane of OPEN op-streams — ``stream_open`` /
``stream_feed`` / ``stream_close`` feed an incremental checker epoch by
epoch and surface verdict-on-violation while the test still runs;
per-stream durable checkpoints under ``stream_dir`` make a killed
stream resumable with identical verdicts.
"""

from jepsen_tpu_torch.serve import health, sched
from jepsen_tpu_torch.serve.service import (
    MODELS,
    CheckFuture,
    CheckRequest,
    CheckService,
    QueueFull,
    ServiceClosed,
    ServiceUnavailable,
    StreamSession,
    model_by_name,
    resume_drained,
)

__all__ = [
    "MODELS",
    "CheckFuture",
    "CheckRequest",
    "CheckService",
    "QueueFull",
    "ServiceClosed",
    "ServiceUnavailable",
    "StreamSession",
    "health",
    "model_by_name",
    "resume_drained",
    "sched",
]
