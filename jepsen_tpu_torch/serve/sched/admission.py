"""Admission: latency-class queues, per-class backpressure, tagging.

The class decides the SERVING PATH, never the verdict:

  * ``interactive`` — small histories a caller is blocked on.  Served
    by the speculative greedy single-rung fast path (per-request host
    witness walks; ``wgl_cpu.greedy_walk``, which never touches the
    device): a likely-valid history resolves in one cheap scan,
    everything the walk can't finish escalates into the batch tier's
    full ladder.
    The speculation is free soundness-wise — the greedy walk never
    refutes, so a wrong guess costs latency, not correctness.
  * ``batch`` — everything else: throughput-bound work that rides the
    (continuous) ladder.

Each class keeps its own queue depth and its own batch-wall EWMA, so
``retry_after`` estimates are computed per class — with one shared
EWMA a queue-full interactive request would get an estimate dominated
by batch-tier residence times, telling a 3 ms caller to come back in
ladder units.

Geometry batchability is tagged HERE, at admission: requests checked by
a graph checker (elle's ``CycleChecker`` family sets
``geometry_batchable = False``) have no padded-kernel geometry to share,
so they must never occupy a geometry bucket in the packable queue —
they are routed to a host side lane instead, which keeps graph work
from stalling ladder work.
"""

from __future__ import annotations

import time

from jepsen_tpu_torch.obs import metrics

#: the latency classes, in fast-path-first service order.
CLASSES = ("interactive", "batch")

#: EWMA seeds: an interactive wave is one greedy launch (~ms warm); a
#: batch is a full ladder.  Both converge to measured values quickly —
#: the seeds only shape the first retry-after hints.
_EWMA_SEED = {"interactive": 0.02, "batch": 1.0}
_EWMA_ALPHA = 0.3


def geometry_batchable(checker) -> bool:
    """Whether a checker's work shares padded-kernel geometry (and so
    may pack into shared ladder launches).  Graph checkers opt out via
    a ``geometry_batchable = False`` class attribute."""
    return bool(getattr(checker, "geometry_batchable", True))


def graph_batch_key(checker) -> tuple:
    """The graph lane's batch-compatibility key — the graph analogue of
    ``parallel.batch.bucket_geometry``: queued graph requests sharing
    this key are served by ONE ``check_batch`` call (one vectorized
    inference pass + one host-SCC sweep) instead of per-request checks.

    Checkers advertise compatibility via a ``batch_key()`` method
    (elle's checkers key on their config: workload, anomalies,
    additional graphs, key-order assumptions, engine); anything without
    one gets a per-instance key and is served unbatched — correctness
    first, batching by explicit contract."""
    key = getattr(checker, "batch_key", None)
    if callable(key):
        try:
            return ("graph",) + tuple(key())
        except Exception:  # noqa: BLE001 — a broken key means no sharing
            pass
    return ("graph", type(checker).__name__, id(checker))


def classify(requested: str | None, *, B: int, interactive_max_b: int = 0) -> str:
    """The request's latency class.  An explicit ``requested`` class
    wins (validated); otherwise a history with at most
    ``interactive_max_b`` barriers auto-routes interactive (0 disables
    auto-routing — the library default, so embedding callers see one
    batch tier unless they opt in)."""
    if requested is not None:
        if requested not in CLASSES:
            raise ValueError(
                f"unknown latency class {requested!r}; expected one of {CLASSES}"
            )
        return requested
    if interactive_max_b > 0 and 0 < B <= interactive_max_b:
        return "interactive"
    return "batch"


class AdmissionQueues:
    """Per-class bounded queues + per-class batch-wall EWMAs.

    NOT thread-safe by itself: the owning ``CheckService`` serializes
    every call under its own lock (the queues are one shared structure
    with the service's admission/scheduler state, and a second lock
    here would only add ordering hazards)."""

    def __init__(self, max_queue: int, *, max_interactive: int | None = None):
        self.max_queue = int(max_queue)
        #: optional dedicated bound for the interactive tier (None:
        #: only the shared max_queue bounds it).  A full batch tier
        #: must not starve interactive admission when a dedicated
        #: allowance is configured.
        self.max_interactive = (
            int(max_interactive) if max_interactive is not None else None
        )
        self.queues: dict[str, list] = {c: [] for c in CLASSES}  # guarded-by: caller
        self.ewma_s: dict[str, float] = dict(_EWMA_SEED)  # guarded-by: caller

    # -- depth / admission ------------------------------------------------

    def depth(self, tier: str | None = None) -> int:
        if tier is not None:
            return len(self.queues[tier])
        return sum(len(q) for q in self.queues.values())

    def over_limit(self, tier: str, reserved: int) -> bool:
        """Would admitting one more ``tier`` request breach its bound?
        ``reserved`` counts slots held by in-flight submits (packing
        off-lock)."""
        if self.depth() + reserved >= self.max_queue:
            # A dedicated interactive allowance keeps the fast lane
            # admitting while the shared queue is full of batch work.
            if not (
                tier == "interactive"
                and self.max_interactive is not None
                and self.depth("interactive") < self.max_interactive
            ):
                return True
        if (
            tier == "interactive"
            and self.max_interactive is not None
            and self.depth("interactive") >= self.max_interactive
        ):
            return True
        return False

    def push(self, req) -> None:
        self.queues[req.tier].append(req)
        self._sync_depth_gauges()

    def remove(self, reqs) -> None:
        taken = {id(r) for r in reqs}
        for q in self.queues.values():
            q[:] = [r for r in q if id(r) not in taken]
        self._sync_depth_gauges()

    def requeue(self, req, tier: str) -> None:
        """Re-enter a request into ``tier``'s queue (fast-path
        escalation: ``req.tier`` stays what admission decided, so
        latency accounting still attributes the request to its class)."""
        self.queues[tier].append(req)
        self._sync_depth_gauges()

    def take_expired(self) -> list:
        """Pull queued requests whose deadline has passed, all classes
        (the caller resolves them outside the service lock)."""
        expired = []
        for tier, q in self.queues.items():
            live = []
            for r in q:
                if r.deadline is not None and r.deadline.expired():
                    expired.append(r)
                else:
                    live.append(r)
            self.queues[tier] = live
        if expired:
            self._sync_depth_gauges()
        return expired

    def drain_all(self) -> list:
        """Remove and return every queued request (shutdown)."""
        out = []
        for tier in CLASSES:
            out.extend(self.queues[tier])
            self.queues[tier] = []
        self._sync_depth_gauges()
        return out

    def _sync_depth_gauges(self) -> None:
        # Refreshed on every mutation so the live per-class gauge can't
        # stick at a stale depth between scrapes (the aggregate
        # serve.queue_depth obs gauge is the service's job).
        for tier in CLASSES:
            metrics.set_gauge(
                "serve.class_queue_depth", len(self.queues[tier]), tier=tier
            )

    # -- retry-after ------------------------------------------------------

    def record_wall(self, tier: str, seconds: float) -> None:
        """Fold one service cycle's wall clock into ``tier``'s EWMA (an
        interactive fast-path wave, or a batch-tier slot-recycle cycle:
        one ladder RUNG under continuous admission — joiners enter and
        lanes free at rung boundaries, so that is the cadence a
        retry-after should quote — the whole ladder otherwise)."""
        self.ewma_s[tier] = (
            (1 - _EWMA_ALPHA) * self.ewma_s[tier] + _EWMA_ALPHA * float(seconds)
        )

    def retry_after(self, tier: str, max_batch: int) -> float:
        """Backpressure hint for ``tier``: ITS queue depth over batch
        width, in units of ITS recent cycle EWMA — an interactive
        rejection quotes fast-path waves, a batch rejection quotes
        ladder batches."""
        waves = max(1.0, self.depth(tier) / max(1, max_batch))
        return round(max(0.02, waves * self.ewma_s[tier]), 3)

    # -- introspection ----------------------------------------------------

    def describe(self, max_batch: int) -> dict:
        """The per-class block in the queue-status document."""
        return {
            tier: {
                "queued": self.depth(tier),
                "ewma_s": round(self.ewma_s[tier], 4),
                "retry_after_hint_s": self.retry_after(tier, max_batch),
            }
            for tier in CLASSES
        }


class WaveTimer:
    """A tiny context manager folding one cycle's wall into a class
    EWMA (kept here so the service's scheduler reads as policy, not
    bookkeeping)."""

    def __init__(self, queues: AdmissionQueues, tier: str):
        self.queues = queues
        self.tier = tier

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.queues.record_wall(self.tier, time.monotonic() - self._t0)
        return False
