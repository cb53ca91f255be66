"""The CheckService: scheduled checking over batch_analysis.

The port of the JAX package's ``serve.service`` on the port's ladder
(``parallel.batch``), checkers and services.  It keeps the JAX names,
signatures, ``serve.*`` telemetry names and attribute keys, and its
drain, journal and evidence files are the JAX package's, so either
package resumes the other's drain dir.  The service's ``device`` check
opt (the card unless "cpu") reaches every lane: the ladder, the
placement's mesh and its probe, the graph lane's checkers and the
streams.  A service built with ``device="cpu"`` puts nothing on a card;
one built without it runs on the card and fails its launches when
there is none.  The HTTP surfaces named below (``GET /check/<id>``,
``POST /stream``, the 429 and 503 mappings, ``/metrics``) are those of
the JAX package's ``web`` module, which fronts these methods; the
port's waits for ROADMAP A10.3.

Request lifecycle::

    submit() ──admission──▶ queued(class) ──scheduler──▶ running ──demux──▶ done
        │ (queue full)         │ (deadline up)             ▲ (rung joiners)
        ▼                      ▼                           │
    QueueFull(retry_after   expired (unknown)   drained (checkpoint)
      per class)

The scheduler is split along the three decisions it makes
(``jepsen_tpu_torch.serve.sched``):

  * **admission** — requests land in a latency-class queue
    (``interactive`` or ``batch``; ``sched.admission``), each with its
    own backpressure and retry-after EWMA.  Graph-shaped work (elle
    checkers: ``geometry_batchable = False``) is tagged
    non-geometry-batchable and runs on a host side lane, never
    occupying a geometry bucket.
  * **packing** — the interactive tier is served by a speculative
    greedy single-rung fast path (one batched witness-walk launch;
    walk-complete histories resolve there, the rest escalate to the
    batch tier).  The batch tier runs CONTINUOUS batching: one
    ``batch_analysis`` ladder per compatibility group —
    ``(model, padded B, bucketed P, bucketed G)`` via
    ``parallel.batch.bucket_geometry`` — with a ``sched.RungFeeder``
    admitting geometry-compatible queued requests into the RUNNING
    ladder at rung boundaries as resolved members free lane slots
    (streaming batched beam search, arXiv:2010.02164).  Verdicts demux
    the moment the ladder decides them.
  * **placement** — packed batches launch with a mesh of N logical
    shards when configured (``devices=`` / ``mesh=``;
    ``sched.Placement``): the ladder's exhausted lanes then take the
    mesh rescue (the rungs themselves run on the one card, ROADMAP C4),
    with a verdict-parity check against a launch without the mesh
    available at ``verify_placement=True``.

Per-request deadlines bound the QUEUE wait: a request whose
``faults.Deadline`` expires while queued resolves ``unknown``
(``deadline-exceeded``) without consuming batch lanes — expiry degrades
only that request, never the shared batch.  A request already riding a
launch when its budget runs out still gets its verdict (it costs the
batch nothing extra); the result carries ``"deadline-overrun": True``.

Soundness is inherited unchanged from ``batch_analysis``: the service
only arbitrates WHICH histories share a launch (and where it runs),
never how they are decided.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Mapping, Sequence

from jepsen_tpu_torch import faults, obs, store
from jepsen_tpu_torch import models as m
from jepsen_tpu_torch.obs import metrics
from jepsen_tpu_torch.obs import provenance as _prov
from jepsen_tpu_torch.parallel import mesh as _mesh
from jepsen_tpu_torch.serve import health as _health
from jepsen_tpu_torch.store import durable as _durable
from jepsen_tpu_torch.serve import slo as _slo
from jepsen_tpu_torch.serve.sched import admission as _sched_adm
from jepsen_tpu_torch.serve.sched import packing as _sched_pack
from jepsen_tpu_torch.serve.sched import placement as _sched_place

logger = logging.getLogger(__name__)

#: models a request may name over HTTP / in a drain file (model classes
#: with argument-free constructors, keyed by their ClassVar name).
MODELS = {
    cls.name: cls
    for cls in (
        m.Register, m.CASRegister, m.Mutex, m.UnorderedQueue,
        m.FIFOQueue, m.MonotonicCounter,
    )
}

#: completed request records kept for GET /check/<id> (oldest evicted).
_KEEP_DONE = 1024

#: drain metadata file (model name + histories + request ids), written
#: next to the store.checkpoint files so resume_drained can rebuild the
#: exact batch_analysis call the scheduler would have made.  Written as
#: a store.durable envelope (checksummed + versioned); pre-envelope
#: drain dirs resume through the registered legacy migration.
DRAIN_META = "drained.json"
KIND_DRAIN = "drain-meta"

_durable.register_kind(KIND_DRAIN, 1)


@_durable.register_migration(KIND_DRAIN, 0)
def _drain_v0_to_v1(payload):
    # v0 was the bare meta dict — same fields, no checksum.
    return dict(payload), 1


def model_by_name(name: str) -> m.Model:
    """A fresh default-constructed model instance for a registry name."""
    try:
        return MODELS[name]()
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(MODELS)}"
        ) from None


#: Continuous ladders: once ANOTHER geometry group's queued batch-tier
#: request has waited this long, the running ladder stops admitting
#: joiners and drains — the cross-group face of the bounded-wait
#: contract ``parallel.batch._STARVE_SECONDS`` gives members inside a
#: ladder.  Same magnitude on purpose: both bound "how long a steady
#: stream may defer someone else's launch".
_GROUP_STARVE_S = 5.0


class QueueFull(Exception):
    """Admission rejected: ``tier``'s queue is at its depth bound.

    ``retry_after`` estimates (seconds) when a slot should free up —
    THAT CLASS's queue depth over batch width times ITS recent cycle
    wall-clock EWMA (an interactive rejection is quoted in fast-path
    waves, a batch rejection in ladder batches — never each other's).
    The HTTP layer maps this to 429 + a Retry-After header."""

    def __init__(self, depth: int, limit: int, retry_after: float,
                 tier: str = "batch"):
        self.depth = depth
        self.limit = limit
        self.retry_after = retry_after
        self.tier = tier
        super().__init__(
            f"check queue full ({depth}/{limit}, {tier} tier); retry "
            f"after ~{retry_after:.2f}s"
        )


class ServiceClosed(Exception):
    """Submit after shutdown began: the service no longer admits work."""


class ServiceUnavailable(Exception):
    """Admission rejected: the circuit breaker is open (K consecutive
    batch failures).  ``retry_after`` is the breaker cooldown remainder
    — the HTTP layer maps this to 503 + Retry-After, distinct from the
    backpressure 429 (the queue has room; the DEVICE is the problem)."""

    def __init__(self, retry_after: float):
        self.retry_after = retry_after
        super().__init__(
            "check service circuit breaker is open; retry after "
            f"~{retry_after:.1f}s"
        )


class CheckFuture(Future):
    """The verdict future ``submit`` returns; resolves to the same
    knossos-shaped result dict ``batch_analysis`` produces.  ``id`` keys
    ``GET /check/<id>``."""

    id: str


class CheckRequest:
    """One admitted request's record (the HTTP status object)."""

    __slots__ = (
        "id", "seq", "model", "history", "priority", "deadline", "client",
        "group", "future", "status", "result", "t_submit", "t_done",
        "t_start", "t_launch", "t_launch_end",
        "trace_id", "ctx", "tier", "kind", "checker", "escalated", "fp",
        "idem_key",
    )

    def __init__(self, *, seq, model, history, priority, deadline, client,
                 group, trace_id=None, tier="batch", kind="ladder",
                 checker=None, request_id=None, fp=None):
        # ``request_id`` preserves identity across a crash-safe restart
        # (journal replay): GET /check/<id> keeps working after the
        # process that minted the id died.
        self.id = request_id or uuid.uuid4().hex[:12]
        self.fp = fp  # history fingerprint (quarantine/journal identity)
        self.seq = seq
        self.model = model
        self.history = history
        self.priority = priority
        self.deadline = deadline
        self.client = client
        self.group = group
        self.tier = tier          # latency class (fixed once queued)
        self.kind = kind          # "ladder" | "graph"
        self.checker = checker    # graph requests: the Checker instance
        self.escalated = False    # fast path couldn't finish; rode the ladder
        self.idem_key = None      # idempotency key (service sets + settles)
        self.future = CheckFuture()
        self.future.id = self.id
        self.status = "queued"
        self.result: dict | None = None
        self.t_submit = time.monotonic()
        self.t_done: float | None = None
        # Lifecycle stamps for the per-request latency decomposition
        # (the "latency" block on results and GET /check/<id>):
        # picked out of the class queue / joined at a rung boundary,
        # the shared launch began, the shared launch returned.
        self.t_start: float | None = None
        self.t_launch: float | None = None
        self.t_launch_end: float | None = None
        # The request's trace identity + the admission thread's span
        # context, captured HERE so the scheduler thread's demux events
        # re-attach to it (obs.attach) — parent links and the trace id
        # survive the admission -> scheduler -> demux thread hops.
        self.trace_id = trace_id or obs.new_trace_id()
        self.ctx = obs.capture(trace=self.trace_id)

    def describe(self) -> dict:
        """The JSONable status document (GET /check/<id>)."""
        out = {
            "id": self.id,
            "status": self.status,
            "client": self.client,
            "priority": self.priority,
            "class": self.tier,
            "model": self.model.name if self.model is not None else None,
            "trace_id": self.trace_id,
        }
        if self.kind == "graph":
            out["checker"] = type(self.checker).__name__
            out["geometry_batchable"] = False
        if self.escalated:
            out["escalated"] = True
        if self.result is not None:
            out["result"] = self.result
        if self.t_done is not None:
            out["latency_s"] = round(self.t_done - self.t_submit, 6)
            out["latency"] = self.latency()
        return out

    def latency(self) -> dict:
        """The per-request latency decomposition block: class-queue
        wait, packing/placement overhead, shared-launch residence, the
        confirm/demux tail after the launch returned, and the residual
        (``other_s``).  A request that never reached a launch (queue
        expiry, quarantine hit, trivial fast path) attributes its whole
        lifetime to ``queue_s`` — it spent it queued.  The stages sum
        to ``total_s`` exactly — the live counterpart of
        ``obs.critpath.decompose_requests`` over the recorded spans
        (expiry emits a ``serve.admission`` span so the two agree)."""
        done = self.t_done if self.t_done is not None else time.monotonic()
        total = max(0.0, done - self.t_submit)
        pack = launch = confirm = 0.0
        # never picked out of the queue (expired / drained / quarantine):
        # the whole lifetime was queue wait
        queue = total
        if self.t_start is not None:
            queue = min(total, max(0.0, self.t_start - self.t_submit))
            t_launch = self.t_launch if self.t_launch is not None \
                else self.t_start
            pack = max(0.0, min(t_launch, done) - self.t_start)
            if self.t_launch is not None:
                l_end = min(done, self.t_launch_end
                            if self.t_launch_end is not None else done)
                launch = max(0.0, l_end - self.t_launch)
                confirm = max(0.0, done - max(self.t_launch, l_end))
        other = total - (queue + pack + launch + confirm)
        if other < -1e-9:
            launch = max(0.0, launch + other)
            other = 0.0
        return {
            "queue_s": round(queue, 6),
            "pack_s": round(pack, 6),
            "launch_s": round(launch, 6),
            "confirm_s": round(confirm, 6),
            "other_s": round(max(0.0, other), 6),
            "total_s": round(total, 6),
        }

    def resolve(self, result: dict, status: str = "done") -> bool:
        """Resolve the future once; later attempts are no-ops (a zombie
        batch finishing after shutdown already drained its requests must
        not raise InvalidStateError in the scheduler; a client may also
        have cancel()ed the future).  Returns whether THIS call resolved
        it."""
        if self.future.done():
            return False
        self.status = status
        self.t_done = time.monotonic()
        # Every settled result carries the per-request latency
        # decomposition (satellite contract: CheckFuture.result() and
        # GET /check/<id> expose the same block).
        result = {**result, "latency": self.latency()}
        self.result = result
        try:
            self.future.set_result(result)
        except Exception:  # noqa: BLE001 — lost the race; first write won
            return False
        return True


class StreamSession:
    """One open op-stream's serving record (the ``/stream/<id>``
    surface).  The wrapped ``checker.streaming.StreamingChecker`` is NOT
    thread-safe, so every feed/finalize runs under the session's own
    lock — never the service lock, which would stall admission behind a
    device launch."""

    __slots__ = ("id", "client", "checker", "trace_id", "lock",
                 "t_open", "t_last", "t_close", "closed", "evidence_done")

    def __init__(self, *, checker, client: str, trace_id: str | None):
        self.id = checker.stream_id
        self.client = client
        self.checker = checker
        self.trace_id = trace_id or obs.new_trace_id()
        self.lock = threading.Lock()
        self.t_open = time.monotonic()
        self.t_last = self.t_open
        self.t_close: float | None = None
        self.closed = False
        self.evidence_done = False

    def describe(self) -> dict:
        """The status document behind GET /stream/<id>."""
        out = self.checker.status()
        out["client"] = self.client
        out["trace_id"] = self.trace_id
        out["closed?"] = self.closed
        out["age_s"] = round(time.monotonic() - self.t_open, 3)
        return out


class CheckService:
    """A persistent multi-tenant check service over ``batch_analysis``.

    ``capacity``/``devices``/``mesh``/``**check_opts`` configure the ONE
    ladder every batch runs (requests carry no per-request ladder knobs
    — a shared launch needs a shared config; per-request opts are
    priority, deadline, latency class, and client id).  ``max_queue``
    bounds admission (``QueueFull`` beyond it) with an optional
    dedicated ``max_interactive_queue`` allowance so batch backlog
    can't starve the fast lane.  ``max_batch`` bounds lanes per launch.
    ``interactive_max_b`` auto-routes histories with at most that many
    barriers to the interactive tier (0, the library default, keeps
    auto-routing off — callers opt in per request with
    ``class_="interactive"``).  ``continuous`` enables rung-boundary
    admission into running ladders (the default; False restores
    window-then-launch batching for A/B).  ``devices=N`` places every
    launch on a mesh of N logical shards of the service's device;
    ``verify_placement`` re-runs the first batch with the mesh without
    it and reports any verdict disagreement.  ``drain_dir`` is where shutdown checkpoints
    still-queued work (None: drained requests resolve unknown without a
    checkpoint).

    The STREAMING lane (``checker.streaming``; HTTP ``POST /stream``)
    runs beside the request queues: up to ``max_streams`` open
    op-streams, each an incremental checker with carried frontier state,
    fed in epochs via ``stream_feed`` and emitting verdict-on-violation
    before the stream ends.  ``stream_dir`` roots per-stream durable
    checkpoints so a SIGKILL'd stream resumes mid-history with identical
    verdicts.  A rejected open raises ``QueueFull(tier="stream")``
    quoted from the stream lane's own session-duration EWMA.

    ``start()`` spawns the scheduler thread (and pre-forks the
    confirmation worker pool, so the first confirmed-unknown request
    doesn't eat pool fork latency); tests drive ``step()`` directly for
    deterministic single-batch control.

    Self-healing (``serve.health``): a non-transiently failing shared
    launch is BISECTED (``poison_bisect``, default on) so only the
    poison member(s) degrade — they land in a TTL'd quarantine registry
    (``quarantine_ttl_s``) keyed by history fingerprint and repeat
    offenders resolve unknown at admission without touching a launch;
    ``breaker_threshold`` consecutive batch failures open a circuit
    breaker (submit raises ``ServiceUnavailable`` → HTTP 503 +
    Retry-After; after ``breaker_cooldown_s`` one probe batch half-opens
    it); ``watchdog_factor`` (None: off) caps each batch's wall clock at
    ``factor ×`` the launch-time EWMA (clamped to
    ``[watchdog_floor_s, watchdog_cap_s]``) and retries a hung launch
    once on reduced placement; ``journal_dir`` (None: off) keeps an
    fsync'd admission journal replayed by ``start()`` after a crash;
    ``health_probe_every_s`` (None: off) probes the mesh's devices and
    shrinks placement to the survivors when one fails."""

    def __init__(
        self,
        *,
        capacity: int | Sequence[int] = (64, 512, 4096),
        mesh=None,
        devices: int | None = None,
        max_queue: int = 256,
        max_interactive_queue: int | None = None,
        max_batch: int = 64,
        batch_window_s: float = 0.002,
        interactive_max_b: int = 0,
        continuous: bool = True,
        verify_placement: bool = False,
        warm_pool: bool = True,
        max_streams: int = 8,
        stream_dir: str | Path | None = None,
        drain_dir: str | Path | None = None,
        evidence_dir: str | Path | None = None,
        journal_dir: str | Path | None = None,
        journal_shared: bool = False,
        idempotency_dir: str | Path | None = None,
        idempotency_shared: bool = False,
        idempotency_ttl_s: float = 3600.0,
        quarantine_dir: str | Path | None = None,
        quarantine_ttl_s: float = 900.0,
        poison_bisect: bool = True,
        breaker_threshold: int = 5,
        breaker_cooldown_s: float = 30.0,
        watchdog_factor: float | None = None,
        watchdog_floor_s: float = 30.0,
        watchdog_cap_s: float = 600.0,
        health_probe_every_s: float | None = None,
        slo_specs=None,
        slo_fast_window_s: float = _slo.FAST_WINDOW_S,
        slo_slow_window_s: float = _slo.SLOW_WINDOW_S,
        **check_opts,
    ):
        for k in ("capacity", "mesh", "deadline", "checkpoint_dir", "resume",
                  "admission"):
            if k in check_opts:
                raise TypeError(
                    f"{k!r} is service-level configuration, not a check opt"
                )
        self.capacity = capacity
        self._placement = _sched_place.Placement(
            devices=devices, mesh=mesh, device=check_opts.get("device"))
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.batch_window_s = float(batch_window_s)
        self.interactive_max_b = int(interactive_max_b)
        self.continuous = bool(continuous)
        self.verify_placement = bool(verify_placement)
        self.warm_pool = warm_pool
        # -- the streaming lane (checker.streaming) ----------------------
        #: concurrent open op-streams admitted before POST /stream gets a
        #: 429.  Streams hold carried device state for their whole
        #: lifetime, so the lane is bounded separately from the request
        #: queues — and its Retry-After is quoted from STREAM-session
        #: wall clocks, never the batch ladder's cycle EWMA (the
        #: per-class rule, applied to the new lane).
        self.max_streams = int(max_streams)
        #: per-stream checkpoint root (None: streams are memory-only and
        #: a SIGKILL loses them; with a dir, POST /stream resume=true
        #: reconstructs a killed stream mid-history).
        self.stream_dir = Path(stream_dir) if stream_dir is not None else None
        self._streams: dict[str, StreamSession] = {}  # guarded-by: _lock [rw]
        #: stream-session duration EWMA (seconds), folded on every close
        #: — the stream lane's own retry-after basis.  Seeded at a
        #: plausible short-session wall so the first rejection quotes
        #: something sane rather than a batch-tier number.
        self._stream_ewma_s = 5.0                # guarded-by: _lock
        self.drain_dir = Path(drain_dir) if drain_dir is not None else None
        #: durable evidence-bundle directory (None: in-memory ring only).
        #: Every settled request's bundle is retrievable via
        #: ``get_evidence(id)`` / GET /evidence/<id> either way.
        self.evidence_dir = (Path(evidence_dir)
                             if evidence_dir is not None else None)
        self._evidence: dict[str, dict] = {}     # guarded-by: _lock [rw]
        # Warm the host-fingerprint cache off the request path: the
        # first evidence bundle would otherwise eat a cold ~10ms
        # import inside a request's measured lifetime.
        _prov.machine_fingerprint()
        self._check_opts = dict(check_opts)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # AdmissionQueues is caller-serialized: every self._adm call in
        # this class runs under self._lock / self._cond (its fields
        # carry the caller-guarded annotation in admission.py).
        self._adm = _sched_adm.AdmissionQueues(
            self.max_queue, max_interactive=max_interactive_queue
        )
        # admission slots held while packing off-lock
        self._reserved = 0                       # guarded-by: _lock
        self._requests: dict[str, CheckRequest] = {}  # guarded-by: _lock [rw]
        self._seq = itertools.count()  # thread-safe under the GIL (next())
        self._closed = False                     # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._fp_thread: threading.Thread | None = None
        self._graph_pool: ThreadPoolExecutor | None = None  # guarded-by: _lock [rw]
        # requests on the device
        self._inflight: list[CheckRequest] = []  # guarded-by: _lock [rw]
        self._t_start = time.monotonic()
        self._parity_checked = False             # guarded-by: _lock [rw]
        self._totals = {                         # guarded-by: _lock [rw]
            "submitted": 0, "completed": 0, "rejected": 0, "expired": 0,
            "drained": 0, "batches": 0, "batch_errors": 0,
            "fastpath_resolved": 0, "escalated": 0, "graphs": 0,
            "graph_batches": 0,
            "quarantined": 0, "poison_isolated": 0, "bisect_launches": 0,
            "watchdog_trips": 0, "journal_replayed": 0,
            "devices_replaced": 0, "breaker_rejected": 0, "drain_errors": 0,
            "idempotent_hits": 0,
            "streams_opened": 0, "streams_closed": 0,
            "streams_rejected": 0, "streams_resumed": 0,
        }
        # -- the self-healing layer (serve.health) ----------------------
        #: with ``quarantine_dir``, the registry is the FLEET-wide
        #: durable store (serve.health.SharedQuarantine): a history
        #: poisoned by any replica sharing the dir is refused at
        #: admission here on its first local offense.
        self.quarantine = (
            _health.SharedQuarantine(ttl_s=quarantine_ttl_s,
                                     dir=quarantine_dir)
            if quarantine_dir is not None
            else _health.Quarantine(ttl_s=quarantine_ttl_s)
        )
        self.poison_bisect = bool(poison_bisect)
        self.breaker = _health.CircuitBreaker(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s
        )
        self._watchdog = (
            _health.LaunchWatchdog(
                factor=watchdog_factor, floor_s=watchdog_floor_s,
                cap_s=watchdog_cap_s,
            )
            if watchdog_factor else None
        )
        self.journal = (
            _health.AdmissionJournal(journal_dir, shared=journal_shared)
            if journal_dir is not None else None
        )
        #: the idempotent-resubmission registry: in-memory always (a
        #: duplicate within one process dedups regardless), journaled
        #: when ``idempotency_dir`` is set so it survives SIGKILL, and
        #: cross-process atomic when ``idempotency_shared`` marks the
        #: dir as fleet-shared (per-key advisory file locks).
        self.idempotency = _health.IdempotencyMap(
            idempotency_dir, ttl_s=idempotency_ttl_s,
            shared=idempotency_shared,
        )
        #: keys with a submit currently mid-_admit (claim taken, request
        #: not yet in _requests): count per key — the live signal that
        #: stops a concurrent duplicate from treating the claim as
        #: stale, however long the admission's journal fsync stalls.
        self._idem_admitting: dict[str, int] = {}  # guarded-by: _lock [rw]
        self.health_probe_every_s = health_probe_every_s
        self._t_probe = 0.0                      # guarded-by: _lock [rw]
        # -- the live SLO burn-rate engine (serve.slo) -------------------
        #: ``slo_specs``: a spec list, an --slo-file path, or None (the
        #: built-in defaults).  Evaluated from the scheduler loop (at
        #: most once per _SLO_EVAL_S) and from every step(); GET /alerts
        #: and the serve_slo_burn_rate{slo=,window=} gauges read it.
        self.slo = _slo.SloEngine(
            slo_specs, fast_window_s=slo_fast_window_s,
            slow_window_s=slo_slow_window_s,
        )
        self._t_slo = 0.0                        # guarded-by: _lock [rw]
        self._recovered = False  # start()-serialized (pre-thread)
        # per-batch occupancy accumulator
        self._occ_sum = 0.0                      # guarded-by: _lock [rw]
        #: continuous-occupancy accumulators: live lane-seconds over
        #: launched lane-slot-seconds across every rung — the
        #: device-TIME-utilization aggregate the ≥ 0.80 gate reads
        #: (each rung weighted by its wall clock; see RungFeeder).
        self._rung_lane_sum = 0.0                # guarded-by: _lock [rw]
        self._rung_slot_sum = 0.0                # guarded-by: _lock [rw]
        self._rungs = 0                          # guarded-by: _lock [rw]

    @property
    def mesh(self):
        """The placement mesh (None: single-device)."""
        return self._placement.mesh

    @property
    def _batch_ewma_s(self) -> float:
        # Back-compat alias (stats key batch_ewma_s): the batch tier's
        # cycle EWMA now lives in the admission queues, per class.
        with self._lock:
            return self._adm.ewma_s["batch"]

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    def submit(
        self,
        history: Sequence[Mapping],
        *,
        model: m.Model | None = None,
        priority: int = 0,
        deadline=None,
        client: str = "anon",
        trace_id: str | None = None,
        class_: str | None = None,
        checker=None,
        idempotency_key: str | None = None,
    ) -> CheckFuture:
        """Admit one history; returns a future resolving to its verdict.

        ``model`` defaults to ``CASRegister()``.  ``priority``: higher
        runs first (FIFO within a priority).  ``deadline``: seconds (or
        a ``faults.Deadline``) bounding the queue wait.  ``class_``:
        the latency class — ``"interactive"`` (greedy fast path, p50 in
        single-launch units) or ``"batch"``; None auto-routes small
        histories when ``interactive_max_b`` is configured, else batch.
        ``checker``: a graph checker instance (elle ``CycleChecker`` &
        co.) instead of a ladder model — tagged non-geometry-batchable
        at admission and run on the host side lane, never occupying a
        geometry bucket.  ``trace_id`` joins this request to a caller's
        existing trace (HTTP clients pass it in the POST body); None
        mints a fresh id.  ``idempotency_key``: a caller-chosen token
        making resubmission safe — a duplicate submit (a retry after a
        timeout / 429 / breaker 503, even across a SIGKILL restart when
        ``idempotency_dir`` + ``journal_dir`` are set) attaches to the
        in-flight request's future or returns the already-settled
        result, under the ORIGINAL request id, instead of running the
        check again.  Raises ``QueueFull`` (backpressure, with a
        per-class retry-after) or ``ServiceClosed``."""
        # Coerce every argument BEFORE reserving a slot: a reservation
        # leaked past a bad-argument raise would shrink admission
        # capacity forever.
        if checker is None:
            model = model if model is not None else m.CASRegister()
        deadline = faults.Deadline.coerce(deadline)
        history = list(history)
        priority = int(priority)
        client = str(client)
        trace_id = str(trace_id) if trace_id is not None else None
        if class_ is not None and class_ not in _sched_adm.CLASSES:
            raise ValueError(
                f"unknown latency class {class_!r}; expected one of "
                f"{_sched_adm.CLASSES}"
            )
        idem_key = (str(idempotency_key)
                    if idempotency_key is not None else None)
        idem_req_id = None
        idem_fp = None
        if idem_key is None:
            return self._admit(
                model=model, history=history, priority=priority,
                deadline=deadline, client=client, trace_id=trace_id,
                class_=class_, checker=checker,
            )
        # Claim-before-admit: the claim is atomic in the map, so two
        # racing duplicates can't both reach a launch.  The claim holds
        # the request id we WOULD mint; if this submit fails admission
        # (queue full, breaker, bad input), the claim is released so
        # the client's retry runs fresh.  The history fingerprint rides
        # the entry so key REUSE across different histories is rejected
        # instead of handing this caller someone else's verdict.
        idem_req_id = uuid.uuid4().hex[:12]
        if checker is None:
            idem_fp = _health.history_fingerprint(history)
        with self._lock:
            self._idem_admitting[idem_key] = \
                self._idem_admitting.get(idem_key, 0) + 1
        try:
            hit = self._idem_claim(idem_key, idem_req_id, client, idem_fp)
            if hit is not None:
                return hit
            try:
                return self._admit(
                    model=model, history=history, priority=priority,
                    deadline=deadline, client=client, trace_id=trace_id,
                    class_=class_, checker=checker, idem_key=idem_key,
                    request_id=idem_req_id, fp_hint=idem_fp,
                )
            except BaseException as e:
                # A simulated crash (faults.CrashPoint) must leave the
                # SIGKILL disk state — the key stays bound, exactly as
                # a real kill would leave it; every OTHER failure
                # releases the claim so the client's retry runs fresh.
                if not isinstance(e, faults.CrashPoint):
                    self.idempotency.release(idem_key, idem_req_id)
                raise
        finally:
            with self._lock:
                n = self._idem_admitting.get(idem_key, 0) - 1
                if n <= 0:
                    self._idem_admitting.pop(idem_key, None)
                else:
                    self._idem_admitting[idem_key] = n

    #: safety cap on how long a duplicate waits for a same-key submit
    #: that is mid-admission.  The live "is someone admitting this key"
    #: signal is the ``_idem_admitting`` counter (exact, no clock); the
    #: cap only bounds the wait against a pathologically wedged
    #: admission so the duplicate eventually treats the entry as stale.
    _IDEM_ADMIT_WAIT_CAP_S = 60.0

    def _idem_claim(self, key: str, new_req_id: str, client: str,
                    fp: str | None) -> CheckFuture | None:
        """The duplicate-submit check: None means the claim is OURS (a
        fresh request proceeds under ``new_req_id``); a future means
        this key is already live — the in-flight original's future, or
        a fresh future pre-resolved with the settled result (original
        request id either way).  Raises ValueError when the key is
        bound to a DIFFERENT history's fingerprint — key reuse must
        never hand this caller someone else's verdict."""
        t0 = time.monotonic()
        while True:
            entry = self.idempotency.claim(key, new_req_id, fp=fp)
            if entry is None:
                return None
            if (fp is not None and entry.get("fp")
                    and entry["fp"] != fp):
                raise ValueError(
                    f"idempotency_key {key!r} is already bound to a "
                    "submission with a DIFFERENT history; reusing a key "
                    "across histories would return the wrong verdict — "
                    "pick a fresh key per logical request"
                )
            if entry.get("result") is not None:
                fut = CheckFuture()
                fut.id = str(entry["req_id"])
                fut.set_result(entry["result"])
                self._count_idem_hit(client)
                return fut
            with self._lock:
                req = self._requests.get(str(entry["req_id"]))
                admitting = self._idem_admitting.get(key, 0)
            if req is not None:
                self._count_idem_hit(client)
                return req.future
            if (admitting > 1
                    and time.monotonic() - t0 < self._IDEM_ADMIT_WAIT_CAP_S):
                # Claimed but not yet registered, and another submit of
                # THIS key (the original) is verifiably mid-_admit on a
                # live thread (the counter includes us, so > 1 means
                # someone else): wait for it to land in _requests or
                # release — rebinding now would run the check twice.
                # The counter, not a clock: a stalled journal fsync in
                # the original's _admit cannot fake staleness.
                time.sleep(0.005)
                continue
            # Genuinely stale: the bound request evaporated unsettled
            # (evicted, or a crash without the journal).  CAS the key
            # onto our fresh request; a lost race means someone else
            # just did — loop and read their entry.
            if self.idempotency.rebind(key, entry["req_id"], new_req_id):
                return None

    def _count_idem_hit(self, client: str) -> None:
        with self._lock:
            self._totals["idempotent_hits"] += 1
        # mirrors to /metrics as jepsen_tpu_serve_idempotent_hits_total
        obs.counter("serve.idempotent_hits", client=client)

    def _idem_watch(self, req: CheckRequest, key: str | None) -> None:
        """Wire a request to settle its idempotency entry: a DONE
        verdict is recorded against the key (duplicates for the next
        TTL window get it without a run); any other terminal status —
        expired, drained, quarantined, batch error — RELEASES the key
        instead: the check never (usefully) ran, so a retry should run
        it, and none of those paths can double-run anything."""
        if key is None:
            return
        req.idem_key = key

        def _done(f):
            try:
                if not f.cancelled() and req.status == "done":
                    # req_id-CAS'd: if a fleet router rebound this key
                    # to another replica's request after fencing us,
                    # our late verdict is discarded, not published
                    self.idempotency.settle(key, req.result,
                                            req_id=req.id)
                else:
                    self.idempotency.release(key, req.id)
            except Exception:  # noqa: BLE001 — bookkeeping must not
                # break the resolve path
                logger.exception("idempotency settle failed for key %r",
                                 key)

        req.future.add_done_callback(_done)

    def _admit(
        self,
        *,
        model,
        history,
        priority,
        deadline,
        client,
        trace_id,
        class_,
        checker,
        idem_key=None,
        request_id=None,
        fp_hint=None,
    ) -> CheckFuture:
        """The admission body behind ``submit`` (arguments already
        coerced, idempotency claim already held by the caller;
        ``fp_hint`` is the history fingerprint the claim path already
        computed, so it isn't hashed twice)."""
        if not self.breaker.allow():
            # The breaker gates ADMISSION, not the queue: K consecutive
            # batch failures mean the device isn't serving — queueing
            # more work would only grow the blast radius.  503-shaped,
            # with the cooldown remainder as the retry hint.
            with self._lock:
                self._totals["breaker_rejected"] += 1
            obs.counter("serve.breaker_rejected", client=client)
            raise ServiceUnavailable(self.breaker.retry_after())
        fp = None
        if checker is None:
            fp = fp_hint or _health.history_fingerprint(history)
            q = self.quarantine.check(fp)
            if q is not None:
                # Repeat offender: skip straight to rejection — this
                # fingerprint already poisoned a shared launch, and the
                # registry entry is still live.  Resolved as an
                # attributable unknown (never queued, never packed), so
                # the caller learns WHY without costing anyone else a
                # bisection.
                req = CheckRequest(
                    seq=next(self._seq), model=model, history=history,
                    priority=priority, deadline=deadline, client=client,
                    group=None, trace_id=trace_id,
                    tier=class_ or "batch", fp=fp, request_id=request_id,
                )
                self._idem_watch(req, idem_key)
                with self._lock:
                    if self._closed:
                        raise ServiceClosed(
                            "check service is shutting down")
                    self._totals["submitted"] += 1
                    self._totals["completed"] += 1
                    self._totals["quarantined"] += 1
                    self._remember(req)
                with obs.attach(req.ctx):
                    obs.counter("serve.submitted", client=client,
                                tier=req.tier)
                    obs.counter("serve.quarantine_hit", client=client)
                    obs.counter("serve.completed")
                metrics.inc("serve.verdicts", verdict="unknown")
                qres = {
                    "valid?": "unknown",
                    "quarantined": True,
                    "cause": (
                        "quarantined history (repeat poison "
                        f"offender): {q['cause']}"
                    ),
                }
                self._bundle(req, qres, [{
                    "event": "fault.quarantine-hit",
                    "error": str(q["cause"]),
                }])
                req.resolve(qres, status="quarantined")
                dt = time.monotonic() - req.t_submit
                metrics.observe("serve.request_latency_seconds", dt)
                return req.future
        #: the tier used for the pre-pack depth check; auto-routing can
        #: only move a request INTO the interactive tier after packing,
        #: and only when that tier has room (checked again below).
        pre_tier = class_ or "batch"
        with self._lock:
            if self._closed:
                raise ServiceClosed("check service is shutting down")
            if self._adm.over_limit(pre_tier, self._reserved):
                self._totals["rejected"] += 1
                obs.counter("serve.rejected", client=client, tier=pre_tier)
                metrics.inc("serve.rejections", tier=pre_tier)
                if (pre_tier == "interactive"
                        and self._adm.max_interactive is not None
                        and (self._adm.depth("interactive")
                             >= self._adm.max_interactive)):
                    # The dedicated interactive bound is what tripped:
                    # quote ITS depth/limit, not the shared queue's
                    # (a "full at 10/256" rejection reads as a bug).
                    depth, limit = (self._adm.depth("interactive"),
                                    self._adm.max_interactive)
                else:
                    depth, limit = (self._adm.depth() + self._reserved,
                                    self.max_queue)
                raise QueueFull(
                    depth, limit,
                    self._adm.retry_after(pre_tier, self.max_batch),
                    tier=pre_tier,
                )
            # Hold the slot while packing off-lock: two racing submitters
            # must not both pass the depth check into a full queue.
            self._reserved += 1
        try:
            if checker is not None:
                if _sched_adm.geometry_batchable(checker):
                    # The admission tag is the routing contract: the
                    # side lane exists for work that CANNOT share
                    # padded-kernel geometry (elle's CycleChecker
                    # family sets geometry_batchable = False).  A
                    # checker that doesn't opt out is asking for
                    # geometry batching the service can only do from
                    # model= + history — reject loudly instead of
                    # silently serving it unbatched.
                    raise ValueError(
                        f"{type(checker).__name__} does not set "
                        "geometry_batchable = False; checker-based "
                        "submissions ride the host side lane, so "
                        "geometry-batchable work must be submitted as "
                        "model= + history for the service to pack it"
                    )
                # Graph work: no kernel geometry — grouped by the
                # checker's COLUMN-SHAPE key instead, so compatible
                # queued requests share one batched inference pass
                # (sched.graph_batch_key; the graph bucket_geometry).
                group: tuple | None = _sched_adm.graph_batch_key(checker)
                pack = None
                kind = "graph"
                tier = class_ or "batch"
            else:
                group, pack = self._group_of(model, history)
                kind = "ladder"
                if pack is None:
                    # Untensorizable: no geometry, no fast path — the
                    # ladder's CPU fallback decides it on the batch tier
                    # regardless of the requested class.
                    tier = "batch"
                else:
                    tier = _sched_adm.classify(
                        class_, B=int(pack["B"]),
                        interactive_max_b=self.interactive_max_b,
                    )
            req = CheckRequest(
                seq=next(self._seq), model=model, history=history,
                priority=priority, deadline=deadline, client=client,
                group=group, trace_id=trace_id, tier=tier, kind=kind,
                checker=checker, fp=fp, request_id=request_id,
            )
            self._idem_watch(req, idem_key)
            if (self.journal is not None and kind == "ladder"
                    and group is not None):
                # Journal BEFORE the queue push: a crash between the
                # two replays a request nobody queued (harmless — it
                # just runs) instead of losing one somebody admitted.
                # The idempotency key rides along so a post-crash
                # duplicate still binds to the replayed request.
                self.journal.record(
                    req_id=req.id, seq=req.seq, model_name=model.name,
                    history=req.history, priority=req.priority,
                    client=req.client, tier=req.tier,
                    trace_id=req.trace_id,
                    deadline_s=(deadline.remaining()
                                if deadline is not None else None),
                    idempotency_key=idem_key,
                )
        except BaseException:
            with self._lock:
                self._reserved -= 1
            raise
        with self._cond:
            self._reserved -= 1
            if self._closed and group is not None:
                # shutdown() began while we were packing off-lock: its
                # drain already snapshotted the queue, so appending now
                # would strand this request unresolved forever.  The
                # just-written journal entry goes too — a restart must
                # not replay a request this client was told was
                # rejected.
                self._totals["rejected"] += 1
                obs.counter("serve.rejected", client=client, tier=tier)
                self._journal_done(req)
                raise ServiceClosed("check service is shutting down")
            self._totals["submitted"] += 1
            self._remember(req)
            if group is None:
                self._totals["completed"] += 1
            else:
                if (class_ is None and req.tier == "interactive"
                        and self._adm.max_interactive is not None
                        and (self._adm.depth("interactive")
                             >= self._adm.max_interactive)):
                    # Auto-routing must not bypass the dedicated
                    # interactive bound: a full fast lane demotes
                    # opportunistic traffic to the batch tier instead of
                    # overfilling it (explicit class_="interactive" was
                    # depth-checked at admission and rejected there).
                    req.tier = "batch"
                self._adm.push(req)
                if kind == "graph":
                    self._sync_graph_depth()
                self._cond.notify_all()
            with obs.attach(req.ctx):
                obs.counter("serve.submitted", client=client, tier=tier)
                self._gauge_queue_depth()
        if group is None:
            # Trivial fast path: no barriers -> valid, no lanes spent.
            # Resolved OUTSIDE the lock: set_result runs done-callbacks
            # synchronously, and a callback re-entering the service
            # (submit/stats) must not deadlock on a held lock.
            tres = {"valid?": True}
            self._bundle(req, tres,
                         [{"event": "serve.trivial", "barriers": 0}])
            req.resolve(tres)
            with obs.attach(req.ctx):
                obs.counter("serve.completed")
            metrics.inc("serve.verdicts", verdict="true")
            dt = time.monotonic() - req.t_submit
            metrics.observe("serve.request_latency_seconds", dt)
            metrics.observe("serve.class_request_latency_seconds", dt,
                            tier=tier)
        return req.future

    def _group_of(self, model: m.Model, history) -> tuple[tuple | None, dict | None]:
        """The batch-compatibility key ``(model, padded geometry)`` plus
        the pack it was computed from.  A None group means trivially
        valid (no device work); untensorizable histories get their own
        group so ``batch_analysis`` decides them the same way it would
        for a direct caller (CPU fallback or unknown).

        The pack is returned so admission can classify by barrier
        count; it is then dropped — the interactive greedy walk runs on
        the raw history, and ``batch_analysis`` re-packs at launch (its
        checkpoint fingerprint and confirmation paths key on the raw
        histories)."""
        from jepsen_tpu_torch.ops import wgl
        from jepsen_tpu_torch.parallel import batch

        try:
            p = wgl.pack(model, list(history))
        except wgl.NotTensorizable:
            return (model, "untensorizable"), None
        if p["B"] == 0:
            return None, p
        return (model, *batch.bucket_geometry(p["B"], p["P"], p["G"])), p

    def _retry_after(self) -> float:
        """Back-compat backpressure hint (batch tier)."""
        with self._lock:
            return self._adm.retry_after("batch", self.max_batch)

    # holds: _lock
    def _gauge_queue_depth(self) -> None:
        """Queue-depth gauges: the shared total plus one series per
        latency class (``serve.queue_depth.<tier>``) — the per-class
        Perfetto counter lanes and the live registry read these."""
        obs.gauge("serve.queue_depth", self._adm.depth())
        for tier in _sched_adm.CLASSES:
            obs.gauge("serve.queue_depth." + tier, self._adm.depth(tier))

    # holds: _lock
    def _remember(self, req: CheckRequest) -> None:
        self._requests[req.id] = req
        if len(self._requests) > self.max_queue + _KEEP_DONE:
            done = [
                i for i, r in self._requests.items()
                if r.status not in ("queued", "running")
            ]
            for i in done[: len(done) - _KEEP_DONE]:
                del self._requests[i]

    # ------------------------------------------------------------------
    # Scheduling
    # ------------------------------------------------------------------

    def start(self) -> "CheckService":
        """Spawn the scheduler thread; idempotent.  Also turns on the
        live metrics registry (obs.metrics) — a started service is a
        serving process, and /metrics should reflect it."""
        if self._thread is not None:
            return self
        metrics.enable_mirror()
        # Reclaim *.tmp orphans crashed writers left in the durable
        # dirs this service owns (store.durable.sweep_tmp counts them
        # as durable.tmp_swept).  The journal/idempotency dirs are
        # exclusively ours — a starting service means their previous
        # writer is dead, so no age gate; the drain dir may be shared
        # with a concurrently-draining sibling, so its sweep keeps the
        # age gate.
        if self.journal is not None:
            _durable.sweep_tmp(
                self.journal.dir,
                min_age_s=60.0 if self.journal.shared else 0.0,
                what="serve.journal")
        if self.idempotency.dir is not None:
            # a SHARED dir has live sibling writers — keep the age gate
            # so their in-flight tmp files survive this start
            _durable.sweep_tmp(
                self.idempotency.dir,
                min_age_s=60.0 if self.idempotency.shared else 0.0,
                what="serve.idempotency")
        qdir = getattr(self.quarantine, "dir", None)
        if qdir is not None:
            _durable.sweep_tmp(qdir, what="serve.quarantine")
        if self.drain_dir is not None and self.drain_dir.is_dir():
            _durable.sweep_tmp(self.drain_dir, what="serve.drain")
            for sub in self.drain_dir.iterdir():
                if sub.is_dir():
                    _durable.sweep_tmp(sub, what="serve.drain")
        self.recover()
        if self.warm_pool and self._check_opts.get(
                "confirm_refutations", True) is True:
            # Satellite contract: pre-fork the confirmation workers at
            # service start so the first confirmed-unknown request
            # doesn't eat the pool's spawn+init latency (~seconds).
            from jepsen_tpu_torch.parallel import batch

            batch.warm_confirm_pool(self._check_opts.get("confirm_workers"))
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="check-service", daemon=True
        )
        self._thread.start()
        # The interactive tier gets its OWN service thread: a greedy
        # fast-path wave is host work of a few ms, and riding the
        # scheduler loop would bound its latency by the batch tier's
        # rung wall clock.  The wave never touches the device, so it
        # contends with the ladder for nothing but the host.
        self._fp_thread = threading.Thread(
            target=self._fastpath_loop, name="check-service-fastpath",
            daemon=True,
        )
        self._fp_thread.start()
        return self

    def recover(self) -> int:
        """Replay the admission journal (crash-safe restart): every
        admitted-but-unfinished request a previous process journaled is
        re-admitted here, KEEPING its request id — a client polling
        ``GET /check/<id>`` across the crash still finds its request.
        Called by ``start()``; step()-driven tests call it directly.
        Idempotent per service instance.  Returns requests replayed."""
        if self._recovered:
            return 0
        self._recovered = True
        # The idempotency map replays FIRST — and regardless of whether
        # an admission journal exists: a service configured with only
        # idempotency_dir still owes duplicates their settled results
        # across a restart.  With a journal, the map's entries point at
        # the request ids about to be resurrected, so a duplicate
        # arriving mid-recovery binds to the replayed request, not a
        # fresh run.
        self.idempotency.replay()
        if self.journal is None:
            return 0
        n = 0
        for e in self.journal.replay():
            try:
                model = model_by_name(str(e["model"]))
                history = list(e["history"])
                group, _pack = self._group_of(model, history)
            except Exception:  # noqa: BLE001 — one bad entry must not
                # block the rest of the queue from recovering
                logger.exception("journal replay failed for entry %s",
                                 e.get("id"))
                continue
            tier = e.get("class") or "batch"
            if tier not in _sched_adm.CLASSES:
                tier = "batch"
            req = CheckRequest(
                seq=next(self._seq), model=model, history=history,
                priority=int(e.get("priority") or 0),
                deadline=faults.Deadline.coerce(e.get("deadline_s")),
                client=str(e.get("client") or "anon"), group=group,
                trace_id=e.get("trace_id"), tier=tier,
                request_id=str(e.get("id") or "") or None,
                fp=_health.history_fingerprint(history),
            )
            idem_key = e.get("idempotency_key")
            if idem_key:
                # Re-bind the key to the resurrected request: the idem
                # journal normally already points at this id, but if
                # ITS entry was lost/corrupt the admission journal is
                # the backup copy of the binding.
                existing = self.idempotency.claim(idem_key, req.id,
                                                  fp=req.fp)
                if (existing is not None and existing.get("result") is None
                        and existing["req_id"] != req.id):
                    self.idempotency.rebind(idem_key, existing["req_id"],
                                            req.id)
                self._idem_watch(req, str(idem_key))
            with self._cond:
                self._totals["submitted"] += 1
                self._totals["journal_replayed"] += 1
                self._remember(req)
                if group is None:
                    self._totals["completed"] += 1
                else:
                    self._adm.push(req)
                    self._cond.notify_all()
            with obs.attach(req.ctx):
                obs.counter("serve.journal_replayed", client=req.client)
            if group is None:
                tres = {"valid?": True}
                self._bundle(req, tres,
                             [{"event": "serve.trivial", "barriers": 0}])
                req.resolve(tres)
                self.journal.resolve(req.id)
            n += 1
        if n:
            logger.info("admission journal replayed %d request(s)", n)
        return n

    def _journal_done(self, r: CheckRequest) -> None:
        """Drop a settled request's journal entry (terminal statuses
        only reach here via resolve() call sites)."""
        if self.journal is not None and r.kind == "ladder":
            self.journal.resolve(r.id)

    #: minimum seconds between SLO evaluations (loop ticks AND step():
    #: a busy scheduler cycling at ms scale must not pay a full
    #: evaluation per cycle; within one step, members settle BEFORE the
    #: evaluation, so the first evaluation after a batch already sees
    #: its latencies — step-driven tests stay deterministic).
    _SLO_EVAL_S = 1.0

    def _maybe_eval_slo(self) -> None:
        """Throttled SLO evaluation for the scheduler loop: the burn
        windows are minutes wide, so sub-second sampling buys nothing —
        but an IDLE service must keep evaluating (a breach's burn rate
        decays back under threshold only if samples keep arriving)."""
        now = time.monotonic()
        with self._lock:
            if now - self._t_slo < self._SLO_EVAL_S:
                return
            self._t_slo = now
        try:
            self.slo.evaluate()
        except Exception:  # noqa: BLE001 — a broken spec must not take
            logger.exception("SLO evaluation failed")  # down the scheduler

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._adm.depth() == 0 and not self._stop.is_set():
                    # bounded wait, then fall out to the SLO tick below
                    # (an idle service still samples its objectives)
                    self._cond.wait(timeout=0.2)
                stopping = self._stop.is_set()
                idle = self._adm.depth() == 0
            if stopping:
                return
            self._maybe_eval_slo()
            if idle:
                continue
            if self.batch_window_s > 0:
                # The pile-in window: let concurrent submitters coalesce
                # into this batch instead of each paying its own launch.
                # Rung-boundary admission makes this window nearly moot
                # (latecomers join the running ladder), so it stays tiny.
                time.sleep(self.batch_window_s)
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the scheduler must survive
                logger.exception("check-service batch step failed")

    def _fastpath_loop(self) -> None:
        while True:
            with self._cond:
                # Wait for LADDER-kind interactive work specifically: a
                # graph request parked in the interactive queue belongs
                # to the side lane (step()/rung boundaries), and a bare
                # depth check would busy-spin on it — the wave below
                # takes only ladder requests and would never drain it.
                while (not self._stop.is_set() and not any(
                        r.kind == "ladder"
                        for r in self._adm.queues["interactive"])):
                    self._cond.wait(timeout=0.2)
                if self._stop.is_set():
                    return
            # No coalesce window and no yield-to-the-ladder: the host
            # greedy walk batches nothing (per-request host work) and
            # contends with nothing (no kernel launch), so the lowest-
            # latency move is always to serve the queue immediately.
            try:
                self._interactive_wave()
            except Exception:  # noqa: BLE001 — the fast lane must survive
                logger.exception("check-service fast-path wave failed")

    def step(self) -> int:
        """Process one scheduler cycle synchronously: expire overdue
        queued requests, dispatch graph side-lane work, serve one
        interactive fast-path wave, then run one (continuous) batch-tier
        ladder.  Returns requests handled.  The scheduler loop calls
        this; tests call it directly for deterministic control."""
        self._probe_placement()
        with self._cond:
            expired = self._adm.take_expired()
            self._totals["expired"] += len(expired)
        self._resolve_expired(expired)
        handled = len(expired)
        handled += self._step_graphs()
        handled += self._interactive_wave()
        handled += self._step_batch()
        self._maybe_eval_slo()
        return handled

    def _resolve_expired(self, expired: list[CheckRequest]) -> None:
        # Expired futures resolve outside the lock (done-callbacks may
        # re-enter the service); the shared batch is untouched.
        for r in expired:
            with obs.attach(r.ctx):
                obs.counter("serve.expired", client=r.client, tier=r.tier)
            metrics.inc("serve.verdicts", verdict="unknown")
            xres = {
                "valid?": "unknown",
                "cause": (
                    "deadline-exceeded: request budget expired while "
                    "queued (the shared batch is unaffected)"
                ),
            }
            self._bundle(r, xres,
                         [{"event": "fault.deadline", "at": "queue"}])
            r.resolve(xres, status="expired")
            with obs.attach(r.ctx):
                # the whole lifetime WAS queue wait — record the
                # admission span over the SAME interval the live
                # latency block uses (t_done - t_submit, which includes
                # the evidence-bundle build) so the offline
                # decomposition (critpath.decompose_requests) and the
                # live block agree that queue_s == total_s
                obs.span_event(
                    "serve.admission", r.t_done - r.t_submit,
                    client=r.client, tier=r.tier, expired=True,
                )
                # the end-to-end span every settled request gets — an
                # expired lifecycle must decompose offline too
                obs.span_event(
                    "serve.request", r.t_done - r.t_submit,
                    client=r.client, verdict="unknown", tier=r.tier,
                    expired=True,
                )
            self._journal_done(r)

    # -- graph side lane ---------------------------------------------------

    def _step_graphs(self) -> int:
        """Dispatch queued non-geometry-batchable (graph) requests to
        the host side lane, BATCHED by column-shape key: requests whose
        checkers share a ``graph_batch_key`` are served by one
        ``check_batch`` call (one vectorized inference pass + one
        host-SCC sweep), demuxed per request afterwards.  Each group is
        one task on a small thread pool when the scheduler thread runs
        (graph checks must not stall ladder work), inline when tests
        drive ``step()`` directly (determinism)."""
        with self._cond:
            gq = [
                r for q in self._adm.queues.values() for r in q
                if r.kind == "graph"
            ]
            self._adm.remove(gq)
            t_pick = time.monotonic()
            for r in gq:
                r.status = "running"
                r.t_start = t_pick
            self._sync_graph_depth()
        groups: dict[tuple, list[CheckRequest]] = {}
        for r in gq:
            groups.setdefault(r.group, []).append(r)
        for rs in groups.values():
            pool = None
            if self._thread is not None:
                # Lazy pool creation is racy without the lock: the
                # scheduler thread and a continuous ladder's rung poll
                # (running on the watchdog worker thread) both dispatch
                # graphs, and two creators would leak a pool.  A CLOSED
                # service must not mint a fresh pool either — shutdown
                # already swapped the old one out, and a pool created
                # after that swap would never be joined.
                with self._lock:
                    if not self._closed:
                        if self._graph_pool is None:
                            self._graph_pool = ThreadPoolExecutor(
                                max_workers=2,
                                thread_name_prefix="check-graph",
                            )
                        pool = self._graph_pool
            if pool is not None:
                try:
                    pool.submit(self._run_graph_batch, rs)
                    continue
                except RuntimeError:
                    # the pool we grabbed shut down between the locked
                    # read and the submit (close() joins outside the
                    # lock) — serve the group inline instead
                    pass
            self._run_graph_batch(rs)
        return len(gq)

    def _sync_graph_depth(self) -> None:
        """Refresh the graph-lane queue-depth gauge (caller holds the
        lock)."""
        depth = sum(
            1 for q in self._adm.queues.values() for r in q
            if r.kind == "graph"
        )
        metrics.set_gauge("serve.graph_queue_depth", depth)

    def _run_graph_batch(self, rs: list[CheckRequest]) -> None:
        """One shared graph-lane dispatch: a single ``check_batch`` for
        the whole compatibility group when the checker supports it,
        per-request ``check_safe`` otherwise (and as the fallback when
        the shared pass fails — one poison graph must degrade alone,
        never its batchmates)."""
        chk = rs[0].checker
        results = None
        if len(rs) > 1 and hasattr(chk, "check_batch"):
            trace_ids = [r.trace_id for r in rs]
            t0 = time.monotonic()
            for r in rs:
                r.t_launch = t0
            try:
                with obs.attach(trace=trace_ids, parent="serve.graph_batch"):
                    with obs.span(
                        "serve.graph_batch", requests=len(rs),
                        checker=type(chk).__name__, trace_ids=trace_ids,
                    ):
                        results = chk.check_batch(
                            {"name": "serve"},
                            [list(r.history) for r in rs],
                            self._graph_opts(),
                        )
                if results is None or len(results) != len(rs):
                    results = None
            except Exception:  # noqa: BLE001 — fall back per request
                logger.exception(
                    "graph-lane batch failed; retrying per request"
                )
                results = None
            if results is not None:
                metrics.observe("serve.graph_batch_seconds",
                                time.monotonic() - t0)
                metrics.inc("serve.graph_batch_requests", len(rs))
                obs.counter("serve.graph_batches")
                with self._lock:
                    self._totals["graph_batches"] += 1
        if results is None:
            for r in rs:
                self._run_graph(r)
            return
        with self._lock:
            self._totals["graphs"] += len(rs)
        obs.counter("serve.graphs", len(rs))
        t_end = time.monotonic()
        for r, res in zip(rs, results):
            r.t_launch_end = t_end
            self._settle_member(
                r, res,
                extra_path=[{"event": "serve.graph-lane", "batched": True}],
            )

    def _graph_opts(self) -> dict:
        """The graph lane's check opts: the service's device choice,
        which a checker built without its own ``device`` takes."""
        dev = self._check_opts.get("device")
        return {} if dev is None else {"device": dev}

    def _run_graph(self, r: CheckRequest) -> None:
        from jepsen_tpu_torch import checker as _checker

        r.t_launch = time.monotonic()
        with obs.attach(r.ctx):
            with obs.span(
                "serve.graph", checker=type(r.checker).__name__,
                client=r.client,
            ):
                # check_safe owns the Checker.check contract: a None
                # result means valid, exceptions become an attributable
                # unknown — one bad graph request degrades alone, never
                # the side lane.
                res = _checker.check_safe(
                    r.checker, {"name": "serve"}, list(r.history),
                    self._graph_opts(),
                )
        with self._lock:
            self._totals["graphs"] += 1
        obs.counter("serve.graphs")
        r.t_launch_end = time.monotonic()
        self._settle_member(
            r, res,
            extra_path=[{"event": "serve.graph-lane", "batched": False}],
        )

    # -- interactive fast path ---------------------------------------------

    def _interactive_wave(self) -> int:
        """One speculative greedy wave over the interactive queue: a
        host-side witness walk per request (``wgl_cpu.greedy_walk`` —
        one beam lane, returning-op first, no backtracking; the host
        counterpart of the ladder's rung-0 greedy kernel).  Walks that
        complete resolve True (a full linearization IS a constructive
        witness — the same verdict rung 0 of a one-shot ladder would
        return); walks that stick escalate into the batch tier, where
        the full ladder decides them.  The walk never touches the
        device, so an interactive request's latency is bounded by
        microseconds of host work — not by a beam rung mid-flight on
        the device (the device wave this replaced measured 10–30 ms
        when racing a rung for host cores, on top of a bounded yield).
        Returns requests RESOLVED here (escalations are in flight)."""
        from jepsen_tpu_torch.checker import wgl_cpu

        with self._cond:
            wave = [
                r for r in self._adm.queues["interactive"]
                if r.kind == "ladder"
            ]
            if not wave:
                return 0
            wave.sort(key=lambda r: (-r.priority, r.seq))
            wave = wave[: self.max_batch]
            self._adm.remove(wave)
            for r in wave:
                r.status = "running"
            self._inflight.extend(wave)
            self._gauge_queue_depth()
        t0 = time.monotonic()
        for r in wave:
            r.t_start = t0
            with obs.attach(r.ctx):
                obs.span_event(
                    "serve.admission", t0 - r.t_submit, client=r.client,
                    tier="interactive",
                )
            metrics.observe("serve.admission_latency_seconds",
                            t0 - r.t_submit)
            metrics.observe("serve.class_admission_latency_seconds",
                            t0 - r.t_submit, tier="interactive")
        with _sched_adm.WaveTimer(self._adm, "interactive"):
            with obs.span(
                "serve.fastpath", requests=len(wave), engine="host-greedy",
                trace_ids=[r.trace_id for r in wave],
            ) as sp:
                t_walk = time.monotonic()
                for r in wave:
                    r.t_launch = t_walk
                flags = []
                for r in wave:
                    try:
                        flags.append(
                            wgl_cpu.greedy_walk(r.model, r.history) is True
                        )
                    except Exception:  # noqa: BLE001 — a failed walk
                        # escalates its member; the ladder decides it
                        logger.exception("interactive greedy walk failed")
                        flags.append(False)
                sp.set(resolved=sum(flags),
                       escalated=len(wave) - sum(flags))
        t_wave_end = time.monotonic()
        for r in wave:
            r.t_launch_end = t_wave_end
        resolved = 0
        for r, ok in zip(wave, flags):
            if ok:
                resolved += 1
                with self._cond:
                    if r in self._inflight:
                        self._inflight.remove(r)
                self._settle_member(
                    r, {"valid?": True, "fastpath": "greedy"},
                    extra_path=[{"event": "serve.fastpath",
                                 "engine": "host-greedy"}],
                )
            else:
                r.escalated = True
                # the fast-path stamps are void — the batch tier will
                # re-stamp the ladder lifecycle it actually rides
                r.t_start = r.t_launch = r.t_launch_end = None
                with self._cond:
                    self._inflight.remove(r)
                    r.status = "queued"
                    self._adm.requeue(r, "batch")
                    self._cond.notify_all()
        with self._lock:
            self._totals["fastpath_resolved"] += resolved
            self._totals["escalated"] += len(wave) - resolved
        if resolved:
            obs.counter("serve.fastpath_resolved", resolved)
        if len(wave) - resolved:
            obs.counter("serve.fastpath_escalated", len(wave) - resolved)
        return resolved

    # -- batch tier (continuous ladder) -------------------------------------

    def _step_batch(self) -> int:
        """Run one batch-tier ladder over the lead compatibility group
        (continuous: a RungFeeder admits compatible latecomers at rung
        boundaries).  Returns requests settled."""
        with self._cond:
            q = [
                r for r in self._adm.queues["batch"] if r.kind == "ladder"
            ]
            if not q:
                return 0
            q.sort(key=lambda r: (-r.priority, r.seq))
            lead = q[0]
            batch_reqs = [r for r in q if r.group == lead.group]
            batch_reqs = batch_reqs[: self.max_batch]
            self._adm.remove(batch_reqs)
            for r in batch_reqs:
                r.status = "running"
            self._inflight.extend(batch_reqs)
            self._gauge_queue_depth()
        t_start = time.monotonic()
        for r in batch_reqs:
            r.t_start = t_start
            # Re-attach each request's admission-thread context: the
            # scheduler thread's per-request events carry the request's
            # trace id, not the scheduler's.
            with obs.attach(r.ctx):
                obs.span_event(
                    "serve.admission", t_start - r.t_submit,
                    client=r.client, tier=r.tier,
                )
            metrics.observe("serve.admission_latency_seconds",
                            t_start - r.t_submit)
            metrics.observe("serve.class_admission_latency_seconds",
                            t_start - r.t_submit, tier=r.tier)
        feeder = (
            _sched_pack.RungFeeder(self, lead.group, batch_reqs)
            if self.continuous else None
        )
        try:
            self._run_batch(batch_reqs, feeder)
        finally:
            members = feeder.members if feeder is not None else batch_reqs
            with self._lock:
                for r in members:
                    if r in self._inflight:
                        self._inflight.remove(r)
        return len(members)

    def _admit_joiners(self, feeder, *, stage: int, lanes: int) -> list:
        """The RungFeeder's poll body: a bounded mid-ladder service
        opportunity.  Expire overdue queued requests, serve one
        interactive wave (this is what bounds interactive latency by a
        RUNG, not a batch), then hand geometry-compatible batch-tier
        requests to the running ladder — at most ``max_batch - lanes``,
        so recycled lane slots are what joiners consume."""
        # The rung boundary is where device-loss re-placement lands: a
        # probe failure shrinks placement for the NEXT batch and closes
        # this feeder so the running ladder drains instead of growing
        # on a degraded mesh.
        self._probe_placement()
        if self._placement.generation != feeder.placement_gen:
            feeder.close()
        with self._cond:
            expired = self._adm.take_expired()
            self._totals["expired"] += len(expired)
        self._resolve_expired(expired)
        with self._lock:
            interactive_waiting = self._adm.depth("interactive") > 0
        if interactive_waiting:
            # The rung boundary is an interactive service opportunity
            # whether or not the dedicated fast-path thread runs: the
            # ladder pausing here means the wave launches uncontended,
            # and an interactive request is never stuck behind more than
            # ONE rung even if the fast-path thread is mid-wave.  (The
            # two pickers take disjoint requests under the lock.)
            self._interactive_wave()
        if self._thread is not None:
            # Graph work dispatches to its thread pool, so the rung
            # boundary is its service opportunity too — a continuous
            # ladder with a steady joiner stream would otherwise pin
            # queued graph requests behind the whole ladder lifetime
            # (inline/step() callers keep their deterministic ordering:
            # graphs there run in step() itself).
            self._step_graphs()
        if not self.continuous or self._closed or feeder.closed:
            return []
        with self._cond:
            now = time.monotonic()
            other_wait = max(
                (now - r.t_submit
                 for r in self._adm.queues["batch"]
                 if r.kind == "ladder" and r.group != feeder.group),
                default=0.0,
            )
            if other_wait > _GROUP_STARVE_S:
                # Another geometry group has waited a full starvation
                # bound: stop feeding this ladder so it drains and the
                # next scheduler cycle serves that group — the
                # cross-GROUP face of the bounded-wait contract
                # parallel.batch._STARVE_SECONDS gives members inside a
                # ladder (a steady same-group stream must not hold the
                # device forever).
                return []
            # Joiners may grow the ladder past the feeder's initial
            # pad_lanes: pad widths are power-of-2 bucketed, so growth
            # changes the compiled shape at most log2(max_batch /
            # pad_lanes) times per ladder and every width re-warms for
            # the process lifetime — clamping the budget to the initial
            # width instead was measured at 0.70-0.73 occupancy against
            # ~0.90 (overflow seeded extra narrow ladders all day to
            # dodge a once-per-shape compile).
            budget = self.max_batch - int(lanes)
            if budget <= 0:
                return []
            q = [
                r for r in self._adm.queues["batch"]
                if r.kind == "ladder" and r.group == feeder.group
            ]
            q.sort(key=lambda r: (-r.priority, r.seq))
            joiners = q[:budget]
            self._adm.remove(joiners)
            for r in joiners:
                r.status = "running"
            self._inflight.extend(joiners)
            if joiners:
                self._gauge_queue_depth()
        t = time.monotonic()
        for r in joiners:
            # a joiner enters the RUNNING launch at its join boundary:
            # queue wait ends and launch residence begins here
            r.t_start = r.t_launch = t
            with obs.attach(r.ctx):
                obs.span_event(
                    "serve.admission", t - r.t_submit, client=r.client,
                    tier=r.tier, joined_at_rung=stage,
                )
            metrics.observe("serve.admission_latency_seconds",
                            t - r.t_submit)
            metrics.observe("serve.class_admission_latency_seconds",
                            t - r.t_submit, tier=r.tier)
        return joiners

    def _probe_placement(self) -> None:
        """Mesh health probe (interval-gated by ``health_probe_every_s``):
        a tiny per-device op through the ``faults.INJECT``-seamed
        ``Placement.probe``.  On a failed device, shrink placement to
        the survivors — the NEXT batch launches on the reduced mesh —
        and re-arm the parity probe so the first reduced launch is
        verified against single-device execution."""
        if (self.health_probe_every_s is None
                or self._placement.mesh is None):
            return
        now = time.monotonic()
        with self._lock:
            # Check-and-set atomically: the scheduler thread and a
            # continuous ladder's rung poll (on the watchdog worker
            # thread) both reach here, and two passing the interval
            # gate together would double-probe the mesh.
            if now - self._t_probe < self.health_probe_every_s:
                return
            self._t_probe = now
        try:
            healthy, failed = self._placement.probe()
        except Exception:  # noqa: BLE001 — a broken probe must not
            # take down the scheduler; it retries next interval
            logger.exception("placement health probe itself failed")
            return
        if not failed:
            return
        if not healthy:
            # Every device failed: nothing to shrink TO.  Leave
            # placement alone — the launches will fail, the breaker
            # will open, and the operator sees both.
            logger.error("ALL %d devices failed the placement health "
                         "probe; placement unchanged", len(failed))
            obs.counter("serve.placement_probe_all_failed",
                        devices=len(failed))
            return
        self._placement.shrink_to(healthy)
        with self._lock:
            self._totals["devices_replaced"] += len(failed)
            self._parity_checked = False
        metrics.inc("serve.devices_lost", len(failed))
        metrics.set_gauge("serve.placement_devices", len(healthy))
        obs.counter("serve.placement_replaced", lost=len(failed),
                    devices=len(healthy))
        logger.warning(
            "device loss: placement shrunk to %d device(s) after %d "
            "failed health probe(s); parity probe re-armed",
            len(healthy), len(failed),
        )

    def _bundle(self, r: CheckRequest, res: dict,
                extra_path: Sequence[Mapping] | None = None) -> None:
        """Build + retain this request's evidence bundle
        (``obs.provenance``) BEFORE its future resolves, so the verdict
        the client reads already carries the ``evidence`` pointer.  The
        bundle id IS the request id — GET /evidence/<id> and GET
        /check/<id> share a key.  Bundles land in the in-memory ring
        (bounded like the request registry) and, when ``evidence_dir``
        is set, as durable envelopes on disk.  Never raises — evidence
        is observability, not the verdict."""
        try:
            path = [{"event": "serve.request", "tier": r.tier,
                     "client": r.client}]
            if r.escalated:
                path.append({"event": "serve.escalated"})
            if extra_path:
                path.extend(dict(e) for e in extra_path)
            bundle = _prov.build_bundle(
                history=list(r.history), result=res, source="serve",
                model=r.model,
                checker=(type(r.checker).__name__
                         if r.checker is not None else None),
                trace_id=r.trace_id, bundle_id=r.id, extra_path=path,
            )
            written = None
            if self.evidence_dir is not None:
                written = _prov.write_bundle(self.evidence_dir, bundle)
            with self._lock:
                self._evidence[r.id] = bundle
                if len(self._evidence) > _KEEP_DONE:
                    drop = list(self._evidence)[
                        : len(self._evidence) - _KEEP_DONE]
                    for k in drop:
                        del self._evidence[k]
            res["evidence"] = {"id": bundle["id"],
                               "digest": bundle["digest"]}
            if written is not None:
                res["evidence"]["path"] = str(written)
            else:
                # write_bundle counts the persisted case; the
                # in-memory-only emission counts here so the
                # provenance.* rollup sees every served bundle.
                obs.counter("provenance.bundle", source="serve",
                            verdict=bundle["verdict"])
        except Exception:  # noqa: BLE001 — see docstring
            logger.exception("evidence bundle emission failed for %s",
                             r.id)
            obs.counter("provenance.emit_error", error="serve")

    def get_evidence(self, request_id: str) -> dict | None:
        """The evidence bundle behind GET /evidence/<id>: the in-memory
        ring first, then the durable ``evidence_dir`` copy (a restart
        empties the ring; the disk envelope survives)."""
        with self._lock:
            b = self._evidence.get(request_id)
        if b is not None:
            return b
        if self.evidence_dir is not None:
            p = self.evidence_dir / f"{request_id}.json"
            if p.is_file():
                try:
                    return _prov.read_bundle(p)
                except _durable.DurableError:
                    return None
        return None

    # ------------------------------------------------------------------
    # Streaming sessions (checker.streaming — POST /stream)
    # ------------------------------------------------------------------

    def _stream_retry_after(self) -> float:  # holds: _lock
        """Stream-lane Retry-After quote: active sessions over lane
        width times the STREAM-session duration EWMA — the same shape
        as ``AdmissionQueues.retry_after`` but fed exclusively from
        stream wall clocks, never the batch ladder's cycle EWMA.
        Caller holds ``_lock``."""
        active = sum(1 for s in self._streams.values() if not s.closed)
        waves = max(1.0, active / max(1, self.max_streams))
        return round(max(0.02, waves * self._stream_ewma_s), 3)

    def _stream_opts(self) -> dict:
        """Scan parameters a stream shares with the service's ladder
        config (dedup backend, spill, closure depth) — a stream compiles
        no kernel geometry the batch path wouldn't."""
        keep = ("dedup_backend", "spill", "fast", "rounds",
                "chunk_barriers", "max_groups", "max_procs", "device")
        return {k: self._check_opts[k] for k in keep
                if k in self._check_opts}

    def stream_open(self, *, model=None, stream_id: str | None = None,
                    resume: bool = False, client: str = "http",
                    trace_id: str | None = None) -> dict:
        """Open (or re-open) an incremental checking stream.

        Admission is bounded by ``max_streams``; beyond it raises
        ``QueueFull(tier="stream")`` quoted from the stream lane's own
        duration EWMA.  ``resume=True`` with a ``stream_dir`` checkpoint
        reconstructs a SIGKILL'd stream mid-history (the feeder then
        continues from the returned ``ops`` count).  Re-opening an id
        that is already active is idempotent and returns its status.

        Streams are replica-sticky (carried frontier state): the fleet
        router does not front this surface.  Shutdown leaves open
        streams un-finalized on purpose — finalizing would classify
        still-pending invokes as crashed and CHANGE the eventual
        verdict; the per-feed checkpoint is the durable state."""
        from jepsen_tpu_torch.checker import streaming as _streaming
        from jepsen_tpu_torch.store import checkpoint as _ckpt

        if model is None or isinstance(model, str):
            model = model_by_name(model or "cas-register")
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is shutting down")
            live = self._streams.get(stream_id) if stream_id else None
            if live is not None and not live.closed:
                return live.describe()
            active = sum(1 for s in self._streams.values() if not s.closed)
            if active >= self.max_streams:
                self._totals["streams_rejected"] += 1
                retry = self._stream_retry_after()
                obs.counter("stream.rejected")
                raise QueueFull(active, self.max_streams, retry,
                                tier="stream")
        sid = stream_id or uuid.uuid4().hex[:16]
        ckdir = (self.stream_dir / sid
                 if self.stream_dir is not None else None)
        sc = None
        if resume and ckdir is not None and _ckpt.stream_exists(ckdir):
            try:
                sc = _streaming.StreamingChecker.resume(
                    ckdir, model, device=self._check_opts.get("device"))
                with self._lock:
                    self._totals["streams_resumed"] += 1
            except _ckpt.CheckpointError as e:
                logger.warning("unreadable stream checkpoint in %s (%s); "
                               "opening fresh", ckdir, e)
                obs.counter("fault.checkpoint.mismatch",
                            reason="unreadable")
        if sc is None:
            sc = _streaming.StreamingChecker(
                model, capacity=self.capacity, checkpoint_dir=ckdir,
                stream_id=sid, **self._stream_opts(),
            )
        sess = StreamSession(checker=sc, client=client, trace_id=trace_id)
        with self._lock:
            # lost an open race for the same id: first one wins
            live = self._streams.get(sess.id)
            if live is not None and not live.closed:
                return live.describe()
            self._streams[sess.id] = sess
            self._totals["streams_opened"] += 1
            active = sum(1 for s in self._streams.values() if not s.closed)
        obs.counter("stream.opened", resumed=str(sc.ops_consumed > 0))
        metrics.set_gauge("stream.active", active)
        self._stream_gauges(sess)
        return sess.describe()

    _STREAM_GAUGES = ("stream.ops_fed", "stream.epochs",
                      "stream.frontier_rows", "stream.rescans")

    def _stream_gauges(self, sess: StreamSession) -> None:
        """Live per-stream progress gauges, labelled ``stream=<id>``.
        Cardinality is bounded: at most ``max_streams`` concurrent label
        sets, and :meth:`stream_close` removes the series so a finished
        stream's last values don't render forever."""
        sc = sess.checker
        metrics.set_gauge("stream.ops_fed", sc.ops_consumed, stream=sess.id)
        metrics.set_gauge("stream.epochs", sc.epochs, stream=sess.id)
        metrics.set_gauge("stream.frontier_rows", sc.frontier_rows,
                          stream=sess.id)
        metrics.set_gauge("stream.rescans", sc.rescans, stream=sess.id)

    def _stream_get(self, stream_id: str) -> StreamSession:
        with self._lock:
            sess = self._streams.get(stream_id)
        if sess is None:
            raise KeyError(f"unknown stream {stream_id!r}")
        return sess

    def stream_feed(self, stream_id: str, ops, seq: int | None = None) -> dict:
        """Feed one epoch of ops into a stream; returns its status doc
        (a verdict-on-violation shows up here the moment the frontier
        dies).  ``seq`` is the count of ops the CLIENT believes it has
        already delivered before this chunk: overlap with the stream's
        consumed count is dropped (idempotent re-feeds after a
        kill/resume), a gap is refused — silently skipping unseen ops
        would corrupt the verdict."""
        sess = self._stream_get(stream_id)
        ops = [dict(o) for o in ops]
        with sess.lock:
            if sess.closed:
                raise ValueError(f"stream {stream_id!r} is closed")
            if seq is not None:
                have = sess.checker.ops_consumed
                if seq > have:
                    raise ValueError(
                        f"sequence gap: stream has {have} ops, chunk "
                        f"starts at {seq}")
                if seq < have:
                    ops = ops[have - seq:]
            sess.t_last = time.monotonic()
            with obs.attach(obs.capture(trace=sess.trace_id)):
                status = sess.checker.feed(ops)
            self._stream_gauges(sess)
            if sess.checker.terminal:
                self._stream_bundle(sess, status)
        return status

    def stream_close(self, stream_id: str) -> dict:
        """End of stream: finalize (still-pending invokes classify as
        crashed, exactly the post-hoc treatment), emit the evidence
        bundle, fold the session wall into the stream lane's EWMA, and
        return ``{"result": ..., **status}``.  Idempotent."""
        sess = self._stream_get(stream_id)
        with sess.lock:
            if not sess.closed:
                with obs.attach(obs.capture(trace=sess.trace_id)):
                    result = sess.checker.finalize()
                sess.closed = True
                sess.t_close = time.monotonic()
                wall = sess.t_close - sess.t_open
                status = sess.checker.status()
                self._stream_bundle(sess, status)
                with self._lock:
                    self._totals["streams_closed"] += 1
                    self._stream_ewma_s += _sched_adm._EWMA_ALPHA * (
                        wall - self._stream_ewma_s)
                    active = sum(1 for s in self._streams.values()
                                 if not s.closed)
                    self._prune_streams()
                obs.counter("stream.closed",
                            verdict=str(result.get("valid?")).lower())
                obs.span_event("stream.session", wall, stream=sess.id,
                               verdict=str(result.get("valid?")),
                               ops=sess.checker.ops_consumed)
                metrics.set_gauge("stream.active", active)
                for g in self._STREAM_GAUGES:
                    metrics.REGISTRY.remove(g, stream=sess.id)
            else:
                result = sess.checker.result
                status = sess.checker.status()
        out = dict(sess.describe())
        out["result"] = result
        if "evidence" in status:
            out["evidence"] = status["evidence"]
        else:
            # the bundle may have been emitted at the MID-STREAM verdict
            # (feed time) — the pointer then lives in the evidence ring
            with self._lock:
                bundle = self._evidence.get(sess.id)
            if bundle is not None:
                out["evidence"] = {"id": bundle["id"],
                                   "digest": bundle["digest"]}
        return out

    def stream_status(self, stream_id: str) -> dict:
        """The status doc behind GET /stream/<id> (404s via KeyError)."""
        return self._stream_get(stream_id).describe()

    def _stream_bundle(self, sess: StreamSession, status: dict) -> None:
        """Evidence for a terminal stream, emitted ONCE — at the
        mid-stream verdict when one fires, else at close.  Lands in the
        same ring + ``evidence_dir`` as request bundles (GET
        /evidence/<stream-id>).  Never raises; caller holds the session
        lock."""
        if sess.evidence_done or not sess.checker.terminal:
            return
        sess.evidence_done = True
        try:
            bundle = sess.checker.evidence(trace_id=sess.trace_id)
            if bundle is None:
                return
            written = None
            if self.evidence_dir is not None:
                written = _prov.write_bundle(self.evidence_dir, bundle)
            with self._lock:
                self._evidence[sess.id] = bundle
                if len(self._evidence) > _KEEP_DONE:
                    drop = list(self._evidence)[
                        : len(self._evidence) - _KEEP_DONE]
                    for k in drop:
                        del self._evidence[k]
            status["evidence"] = {"id": bundle["id"],
                                  "digest": bundle["digest"]}
            if written is not None:
                status["evidence"]["path"] = str(written)
            else:
                obs.counter("provenance.bundle", source="stream",
                            verdict=bundle["verdict"])
        except Exception:  # noqa: BLE001 — observability, not the verdict
            logger.exception("stream evidence emission failed for %s",
                             sess.id)
            obs.counter("provenance.emit_error", error="stream")

    def _prune_streams(self) -> None:  # holds: _lock
        """Bound the closed-session registry (caller holds ``_lock``);
        active sessions are bounded by admission and never pruned."""
        done = [sid for sid, s in self._streams.items() if s.closed]
        if len(done) > _KEEP_DONE:
            for sid in done[: len(done) - _KEEP_DONE]:
                del self._streams[sid]

    def _settle_member(self, r: CheckRequest, res: dict,
                       status: str = "done",
                       extra_path: Sequence[Mapping] | None = None) -> bool:
        """Resolve one request's future with its verdict (idempotent —
        the ladder's early demux and the final settle loop may both
        reach a member).  Annotates mid-flight deadline overrun and
        emits the per-request telemetry + evidence bundle."""
        if r.deadline is not None and r.deadline.expired():
            # Launched before the budget ran out: the verdict is
            # already paid for, so hand it over — annotated, so an
            # SLA-bound caller can still discount it.
            res = {**res, "deadline-overrun": True}
        if not r.future.done():
            self._bundle(r, res, extra_path)
        if not r.resolve(res, status=status):
            return False
        with obs.attach(r.ctx):
            obs.span_event(
                "serve.request", r.t_done - r.t_submit, client=r.client,
                verdict=str(res.get("valid?")), tier=r.tier,
            )
        metrics.observe("serve.request_latency_seconds",
                        r.t_done - r.t_submit)
        metrics.observe("serve.class_request_latency_seconds",
                        r.t_done - r.t_submit, tier=r.tier)
        metrics.inc("serve.verdicts", verdict=str(res.get("valid?")).lower())
        with self._lock:
            self._totals["completed"] += 1
        obs.counter("serve.completed")
        self._journal_done(r)
        return True

    def _run_batch(self, batch_reqs: list[CheckRequest], feeder) -> None:
        from jepsen_tpu_torch.parallel import batch

        model = batch_reqs[0].model
        n = len(batch_reqs)
        mesh = self._placement.mesh
        n_pad = batch.padded_batch(n, mesh)
        geom = batch_reqs[0].group[1:]
        trace_ids = [r.trace_id for r in batch_reqs]
        metrics.set_gauge("serve.batch_occupancy", round(n / n_pad, 4))
        metrics.set_gauge("serve.batch_padding_waste",
                          round(1.0 - n / n_pad, 4))
        metrics.set_gauge("serve.batch_requests", n)
        hung = False
        with self._placement.span(requests=n, tier="batch"):
            with obs.span(
                "serve.batch", requests=n, padded=n_pad,
                occupancy=round(n / n_pad, 4),
                padding_waste=round(1.0 - n / n_pad, 4),
                model=model.name, geometry=str(geom),
                trace_ids=trace_ids, continuous=feeder is not None,
            ) as sp:
                t0 = time.monotonic()
                for r in batch_reqs:
                    r.t_launch = t0

                def _launch():
                    # The serve-level fault-injection seam: unlike the
                    # per-kernel INJECT calls inside the ladder, this
                    # one names WHICH members share the launch (history
                    # fingerprints), so poison-request fault scenarios
                    # compose through faults.inject_scope without
                    # monkeypatching the ladder.
                    hook = faults.INJECT
                    if hook is not None:
                        hook({"what": "serve.batch",
                              "members": [r.fp for r in batch_reqs],
                              "lanes": n}, 0)
                    # The shared-batch trace scope: everything the
                    # launch emits (ladder stages, confirmations, fault
                    # retries) carries the member trace ids, so one
                    # request's journey is findable inside the shared
                    # work.  Attached HERE (inside the callable) so it
                    # holds on the watchdog worker thread too.
                    with obs.attach(trace=trace_ids, parent="serve.batch"):
                        return batch.batch_analysis(
                            model, [r.history for r in batch_reqs],
                            capacity=self.capacity, mesh=mesh,
                            admission=feeder,
                            **self._check_opts,
                        )

                try:
                    if self._watchdog is not None:
                        results = self._watchdog.run(_launch)
                    else:
                        results = _launch()
                    err = None
                except _health.HungLaunch as e:
                    # The launch blew its wall-clock cap: the worker
                    # thread may still be running — abandon it (its
                    # late verdicts lose the first-write-wins race) and
                    # close the feeder so it can't pull new joiners
                    # into a zombie ladder.
                    logger.warning(
                        "check-service batch hung (%s); abandoning and "
                        "retrying on reduced placement", e,
                    )
                    results, err, hung = None, e, True
                    if feeder is not None:
                        feeder.close()
                except Exception as e:  # noqa: BLE001 — degrade the batch's
                    # requests, never the service (the scheduler lives on)
                    logger.exception("check-service batch failed")
                    results, err = None, e
                dt = time.monotonic() - t0
                if feeder is not None:
                    sp.set(
                        joined=feeder.joined, members=len(feeder.members),
                        rungs=feeder.rungs,
                        continuous_occupancy=feeder.mean_occupancy,
                    )
        members = list(feeder.members) if feeder is not None else batch_reqs
        t_launch_end = time.monotonic()
        for r in members:
            if r.t_launch_end is None:
                r.t_launch_end = t_launch_end
        # Per-device bubble attribution.  The port's lanes are not
        # spread over the mesh's shards (ROADMAP C4), and every shard
        # lies on one card: that card's bubble is exactly 1 − occupancy,
        # one gauge under its index.
        for did in dict.fromkeys(_mesh.mesh_device_ids(mesh)):
            metrics.set_gauge("serve.device_bubble_ratio",
                              round(1.0 - n / n_pad, 4), device=str(did))
        metrics.observe("serve.batch_seconds", dt)
        with self._lock:
            # The batch-tier retry-after quotes SLOT-RECYCLE cadence: a
            # continuous ladder lives as long as joiners keep coming
            # (minutes, under steady arrival), but lanes free at every
            # rung — feeding the whole-ladder wall into the EWMA would
            # tell a rejected client to come back a ladder-lifetime
            # later for a slot that frees in milliseconds.
            cycles = feeder.rungs if (feeder is not None
                                      and feeder.rungs) else 1
            self._adm.record_wall("batch", dt / cycles)
            self._totals["batches"] += 1
            self._occ_sum += n / n_pad
            if feeder is not None:
                self._rung_lane_sum += feeder.lane_sum
                self._rung_slot_sum += feeder.slot_sum
                self._rungs += feeder.rungs
            if err is not None:
                self._totals["batch_errors"] += 1
        metrics.inc("serve.batches")
        if err is not None:
            metrics.inc("serve.batch_errors")
            obs.counter("serve.batch_error", error=faults.describe(err))
            if hung:
                self._retry_hung(model, members, err)
                return
            unresolved = [r for r in members if not r.future.done()]
            if (self.poison_bisect and len(unresolved) > 0
                    and faults.error_kind(err) is None):
                # A NON-transient shared-launch failure (transients and
                # OOM already retried/halved inside the ladder): bisect
                # the member set so only the poison member(s) degrade —
                # everyone else gets their real verdict from the
                # succeeding halves.
                self._bisect_poison(model, unresolved, err, mesh)
                return
            opened = self.breaker.record_failure()
            if opened:
                obs.counter("serve.breaker_opened",
                            failures=self.breaker.consecutive_failures)
                logger.error(
                    "circuit breaker OPEN after %d consecutive batch "
                    "failures (cooldown %.0fs)",
                    self.breaker.consecutive_failures,
                    self.breaker.cooldown_s,
                )
            metrics.set_gauge("serve.breaker_open",
                              self.breaker.state == "open")
            for r in unresolved:
                metrics.inc("serve.verdicts", verdict="unknown")
                eres = {
                    "valid?": "unknown",
                    "cause": (
                        "service batch failed: "
                        f"{faults.describe(err)}"
                    ),
                }
                self._bundle(r, eres, [{
                    "event": "fault.batch-error",
                    "error": faults.describe(err),
                }])
                r.resolve(eres, status="error")
                self._journal_done(r)
            return
        self.breaker.record_success()
        metrics.set_gauge("serve.breaker_open", False)
        # Settle every member the ladder's early demux didn't (unknowns
        # and confirmation leftovers); _settle_member is idempotent so
        # already-resolved members are skipped.
        for r, res in zip(members, results):
            self._settle_member(r, res)
        if self.verify_placement and mesh is not None:
            with self._lock:
                # claim-under-lock: a device-loss shrink re-arms the
                # probe concurrently, and two batches racing the bare
                # flag could both (or neither) run the parity check
                run_parity = not self._parity_checked
                self._parity_checked = True
            if run_parity:
                self._verify_placement(model, [r.history for r in members],
                                       results)

    def _bisect_poison(self, model, members: list[CheckRequest],
                       err: BaseException, mesh) -> None:
        """Blast-radius isolation for a poisoned shared launch: bisect
        ``members`` with bounded relaunches (serve.health.bisect_poison)
        — innocents settle with the verdicts the succeeding halves
        produce; the isolated poison member(s) resolve unknown and land
        in the TTL'd quarantine registry so repeat offenders skip
        straight to rejection."""
        from jepsen_tpu_torch.parallel import batch

        cause0 = faults.describe(err)

        def launch(reqs: list[CheckRequest]) -> list[dict]:
            def _go():
                hook = faults.INJECT
                if hook is not None:
                    hook({"what": "serve.batch",
                          "members": [r.fp for r in reqs],
                          "lanes": len(reqs)}, 0)
                return batch.batch_analysis(
                    model, [r.history for r in reqs],
                    capacity=self.capacity, mesh=mesh, **self._check_opts,
                )

            if self._watchdog is not None:
                # A poison member may WEDGE a relaunch instead of
                # raising; without the cap one bisection step would
                # hang the scheduler forever.  HungLaunch is an
                # Exception, so bisect_poison treats it as this
                # group's failure signature and keeps isolating.
                return self._watchdog.run(_go)
            return _go()

        with obs.span("serve.poison_bisect", members=len(members),
                      error=cause0) as sp:
            poison, good, launches = _health.bisect_poison(launch, members)
            sp.set(poison=len(poison), launches=launches)
        with self._lock:
            self._totals["bisect_launches"] += launches
            self._totals["poison_isolated"] += len(poison)
            self._totals["quarantined"] += len(poison)
        metrics.inc("serve.poison_bisect_launches", launches)
        metrics.inc("serve.poison_isolated", len(poison))
        for r, res in good.items():
            self._settle_member(r, res)
        for r in poison:
            if r.fp:
                self.quarantine.add(r.fp, cause0)
            with obs.attach(r.ctx):
                obs.counter("serve.quarantined", client=r.client,
                            error=cause0)
            self._settle_member(
                r,
                {
                    "valid?": "unknown",
                    "quarantined": True,
                    "cause": (
                        "poisoned shared launch (isolated by bisection): "
                        f"{cause0}; fingerprint quarantined for "
                        f"{self.quarantine.ttl_s:.0f}s"
                    ),
                },
                status="quarantined",
                extra_path=[{"event": "fault.poison-bisect",
                             "error": cause0}],
            )
        logger.warning(
            "poison bisection: %d member(s) quarantined, %d innocent "
            "verdict(s) recovered in %d relaunch(es) (%s)",
            len(poison), len(good), launches, cause0,
        )
        # The breaker reads the bisection outcome as the device's
        # health: recovered innocent verdicts prove the device serves
        # (the REQUEST was the problem); an all-poison outcome is
        # indistinguishable from a broken device and counts against it.
        if good:
            self.breaker.record_success()
        else:
            self.breaker.record_failure()
        metrics.set_gauge("serve.breaker_open", self.breaker.state == "open")

    def _retry_hung(self, model, members: list[CheckRequest],
                    err: BaseException) -> None:
        """Cancel-and-retry for a hung launch: the abandoned worker
        thread keeps whatever device it wedged; the still-unresolved
        members retry ONCE on reduced placement (single device, no
        continuous admission, a doubled watchdog cap).  A retry that
        also fails degrades only these members."""
        from jepsen_tpu_torch.parallel import batch

        with self._lock:
            self._totals["watchdog_trips"] += 1
        metrics.inc("serve.watchdog_trips")
        obs.counter("serve.watchdog_trip", error=faults.describe(err))
        self.breaker.record_failure()
        retry = [r for r in members if not r.future.done()]
        if not retry:
            return

        def _relaunch():
            return batch.batch_analysis(
                model, [r.history for r in retry],
                capacity=self.capacity, mesh=None, **self._check_opts,
            )

        try:
            cap = (self._watchdog.timeout_s() * 2
                   if self._watchdog is not None else None)
            if self._watchdog is not None:
                results = self._watchdog.run(_relaunch, cap)
            else:  # pragma: no cover — hung implies a watchdog exists
                results = _relaunch()
        except Exception as e2:  # noqa: BLE001 — bounded degradation:
            # these members only, with both failures named
            for r in retry:
                metrics.inc("serve.verdicts", verdict="unknown")
                hres = {
                    "valid?": "unknown",
                    "cause": (
                        f"hung launch ({faults.describe(err)}); "
                        "reduced-placement retry failed: "
                        f"{faults.describe(e2)}"
                    ),
                }
                self._bundle(r, hres, [
                    {"event": "fault.watchdog-trip",
                     "error": faults.describe(err)},
                    {"event": "fault.retry-failed",
                     "error": faults.describe(e2)},
                ])
                r.resolve(hres, status="error")
                self._journal_done(r)
            return
        for r, res in zip(retry, results):
            self._settle_member(r, res)
        self.breaker.record_success()
        metrics.set_gauge("serve.breaker_open", False)
        obs.counter("serve.watchdog_retry_ok", requests=len(retry))

    def _verify_placement(self, model, histories, sharded_results) -> None:
        """The placement parity check (first sharded batch only): the
        SAME histories one-shot on a single device must produce the
        same verdicts.  A mismatch is reported loudly (counter + log)
        but never degrades the already-delivered verdicts — placement
        bugs are for operators, crashes are not a remedy."""
        from jepsen_tpu_torch.parallel import batch

        try:
            single = batch.batch_analysis(
                model, histories, capacity=self.capacity, mesh=None,
                **self._check_opts,
            )
        except Exception as e:  # noqa: BLE001 — the probe is best-effort,
            # but a swallowed probe failure left operators thinking
            # parity was verified: count it and name the error
            logger.exception("placement parity probe failed")
            metrics.inc("serve.placement_probe_errors")
            obs.counter("serve.placement_probe_error",
                        error=faults.describe(e))
            return
        got = [r["valid?"] for r in sharded_results]
        want = [r["valid?"] for r in single]
        if got == want:
            obs.counter("serve.placement_parity_ok",
                        histories=len(histories))
            logger.info("placement parity verified over %d histories "
                        "(%d devices)", len(histories),
                        self._placement.n_devices)
        else:
            obs.counter("serve.placement_parity_mismatch")
            metrics.inc("serve.placement_parity_mismatch")
            logger.error(
                "PLACEMENT PARITY MISMATCH: mesh verdicts %s != "
                "single-device %s", got, want,
            )

    # ------------------------------------------------------------------
    # Introspection (GET /queue, GET /check/<id>)
    # ------------------------------------------------------------------

    def get(self, request_id: str) -> CheckRequest | None:
        with self._lock:
            return self._requests.get(request_id)

    @staticmethod
    def _spill_stats() -> dict:
        from jepsen_tpu_torch.ops import spill as _spill

        return _spill.stats_snapshot()

    def stats(self) -> dict:
        """The queue-status document (GET /queue, web panel)."""
        with self._lock:
            queued = [r for q in self._adm.queues.values() for r in q]
            by_client: dict[str, int] = {}
            for r in queued:
                by_client[r.client] = by_client.get(r.client, 0) + 1
            groups = len({r.group for r in queued})
            t = dict(self._totals)
            return {
                "queue_depth": self._adm.depth(),
                "graph_queue_depth": sum(
                    1 for r in queued if r.kind == "graph"
                ),
                "queue_groups": groups,
                "running": len(self._inflight),
                "max_queue": self.max_queue,
                "max_batch": self.max_batch,
                "closed": self._closed,
                "by_client": by_client,
                "classes": self._adm.describe(self.max_batch),
                "placement": self._placement.describe(),
                "continuous": self.continuous,
                "batch_ewma_s": round(self._adm.ewma_s["batch"], 4),
                "avg_occupancy": round(
                    self._occ_sum / t["batches"], 4) if t["batches"] else None,
                "continuous_occupancy": round(
                    self._rung_lane_sum / self._rung_slot_sum, 4
                ) if self._rung_slot_sum else None,
                # raw device-time accumulators behind continuous_occupancy
                # (live lane-seconds / launched lane-slot-seconds): a
                # load harness snapshots these around a measured window
                # to get steady-state occupancy with warmup (compile
                # rungs) excluded.
                "rung_lane_s": round(self._rung_lane_sum, 6),
                "rung_slot_s": round(self._rung_slot_sum, 6),
                "retry_after_hint_s": self._adm.retry_after(
                    "batch", self.max_batch),
                # -- streaming lane (checker.streaming) -----------------
                # its retry-after hint comes from the stream-session
                # duration EWMA, NOT the batch ladder's cycle EWMA (the
                # per-class quoting rule extends to the new lane).
                "streams": {
                    "active": sum(1 for s in self._streams.values()
                                  if not s.closed),
                    "max_streams": self.max_streams,
                    "ewma_s": round(self._stream_ewma_s, 4),
                    "retry_after_hint_s": self._stream_retry_after(),
                },
                "uptime_s": round(time.monotonic() - self._t_start, 3),
                # -- self-healing layer (serve.health) ------------------
                "breaker": self.breaker.describe(),
                "quarantine": self.quarantine.describe(),
                "idempotency": self.idempotency.describe(),
                "journal_depth": (
                    self.journal.depth() if self.journal is not None
                    else None
                ),
                "journal_errors": (
                    self.journal.errors if self.journal is not None
                    else None
                ),
                "watchdog_timeout_s": (
                    round(self._watchdog.timeout_s(), 3)
                    if self._watchdog is not None else None
                ),
                # -- bounded-memory layer (ops.spill) -------------------
                # process-wide spill/factorization totals: how much exact
                # frontier state moved to host RAM and how many crashed
                # groups factored away, plus reduced-size retry launches
                # excluded from the watchdog EWMA baseline.  (spill is
                # imported lazily: it pulls ops.hashing and with it
                # torch, which this module defers to function bodies by
                # design.)
                "memory": {
                    **self._spill_stats(),
                    "retry_launches": faults.retry_launch_count(),
                },
                **t,
            }

    # ------------------------------------------------------------------
    # Shutdown / drain
    # ------------------------------------------------------------------

    def shutdown(self, *, drain: bool = True, wait: bool = False,
                 join_timeout: float = 600.0) -> dict:
        """Stop admitting, stop the scheduler, settle EVERY admitted
        request.

        ``wait=True`` finishes ALL queued work first (every future gets
        its real verdict).  Otherwise the in-flight batch is given
        ``join_timeout`` seconds to complete and the still-queued
        remainder is DRAINED: with a ``drain_dir``, each compatibility
        group's histories + a resumable ``store.checkpoint`` land on
        disk (finish later with ``resume_drained``); the futures
        resolve unknown with the checkpoint path in ``cause``.  A batch
        still on the device after ``join_timeout`` has its requests
        drained too (resolve() is first-write-wins, so the zombie
        batch's late verdicts are discarded harmlessly).  Closing also
        stops rung-boundary admission — a running continuous ladder
        finishes its current members but takes no new joiners.  Returns
        a summary dict."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if wait:
            # Settle the backlog before stopping the scheduler.  If the
            # scheduler thread isn't running, step() here.
            while True:
                with self._lock:
                    empty = self._adm.depth() == 0 and not self._inflight
                if empty:
                    break
                if self._thread is None:
                    self.step()
                else:
                    time.sleep(0.01)
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                logger.warning(
                    "scheduler still mid-batch after %.0fs; draining its "
                    "requests (late verdicts will be discarded)",
                    join_timeout,
                )
            self._thread = None
        if self._fp_thread is not None:
            self._fp_thread.join(timeout=30.0)
            self._fp_thread = None
        with self._lock:
            pool, self._graph_pool = self._graph_pool, None
        if pool is not None:
            # joined outside the lock: queued graph batches take it in
            # _settle_member, and a held lock here would deadlock them
            pool.shutdown(wait=True)
        with self._lock:
            # _inflight is non-empty only when the join timed out: those
            # requests were admitted and must still settle (drain below).
            remaining = list(self._inflight) + self._adm.drain_all()
            self._inflight = []
        remaining = [r for r in remaining if not r.future.done()]
        summary = {"drained": 0, "checkpoints": []}
        if remaining:
            if drain:
                summary = self._drain(remaining)
            else:
                for r in remaining:
                    dres = {"valid?": "unknown",
                            "cause": "service shut down before this "
                                     "request was checked"}
                    self._bundle(r, dres, [{"event": "serve.drained",
                                            "checkpoint": False}])
                    r.resolve(dres, status="drained")
                    # Keep the journal entry under drain=False too?  No:
                    # the caller explicitly declined a resumable drain,
                    # so a restart re-running these would contradict the
                    # resolution the client was handed.
                    self._journal_done(r)
                summary["drained"] = len(remaining)
        with self._lock:
            self._totals["drained"] += summary["drained"]
        return summary

    def _drain(self, remaining: list[CheckRequest]) -> dict:
        """Checkpoint still-queued work, one group per subdir: the
        histories + request ids (DRAIN_META) and a resumable
        ``store.checkpoint`` written by the real ladder machinery (a
        zero-budget ``batch_analysis`` trips its deadline at stage 0 and
        persists config + fingerprint + pending set — exactly the state
        ``resume=True`` re-enters).  Graph requests have no ladder state
        to checkpoint; they resolve unknown without one."""
        from jepsen_tpu_torch.parallel import batch

        groups: dict[tuple | None, list[CheckRequest]] = {}
        for r in remaining:
            groups.setdefault(r.group, []).append(r)
        out = {"drained": len(remaining), "checkpoints": []}
        # Timestamped group dirs: a second drain into the same drain_dir
        # (service restarted with the same --drain-dir, drained again)
        # must never overwrite an earlier drain's checkpoint.
        stamp = store.time_str()
        for gi, (group, rs) in enumerate(sorted(
                groups.items(), key=lambda kv: kv[1][0].seq)):
            sub = None
            checkpointable = not (group and group[0] == "graph")
            if self.drain_dir is not None and checkpointable:
                sub = self.drain_dir / f"{stamp}-g{gi:02d}"
                try:
                    sub.mkdir(parents=True, exist_ok=True)
                    meta = {
                        "model": rs[0].model.name,
                        "ids": [r.id for r in rs],
                        "clients": [r.client for r in rs],
                        "histories": [
                            store._jsonable(list(r.history)) for r in rs
                        ],
                    }
                    _durable.write_record(sub / DRAIN_META, KIND_DRAIN, meta)
                    batch.batch_analysis(
                        rs[0].model, [r.history for r in rs],
                        capacity=self.capacity, mesh=self._placement.mesh,
                        checkpoint_dir=sub, deadline=faults.Deadline(0.0),
                        **self._check_opts,
                    )
                    out["checkpoints"].append(str(sub))
                except Exception as e:  # noqa: BLE001 — drain stays
                    # best-effort (the futures below still resolve),
                    # but the failure is COUNTED and carried on each
                    # affected request instead of vanishing into a log
                    # nobody tails: an operator trusting "drained means
                    # resumable" must see when it wasn't.
                    logger.exception("drain checkpoint failed for %s", sub)
                    drain_err = faults.describe(e)
                    with self._lock:
                        self._totals["drain_errors"] += 1
                    metrics.inc("serve.drain_errors")
                    for r in rs:
                        with obs.attach(r.ctx):
                            obs.counter("serve.drain_error",
                                        client=r.client, error=drain_err)
                    sub = None
            cause = "service shut down before this request was checked"
            if sub is not None:
                cause += f"; resumable drain checkpoint: {sub}"
            elif self.drain_dir is not None and checkpointable:
                cause += (
                    "; drain checkpoint FAILED (not resumable): "
                    f"{drain_err}"
                )
            for r in rs:
                with obs.attach(r.ctx):
                    obs.counter("serve.drained", client=r.client)
                metrics.inc("serve.verdicts", verdict="unknown")
                dres = {"valid?": "unknown", "cause": cause}
                self._bundle(r, dres, [{"event": "serve.drained",
                                        "checkpoint": sub is not None}])
                r.resolve(dres, status="drained")
                if sub is not None:
                    # the drain checkpoint supersedes the journal entry
                    # (resume_drained is the recovery path now); a
                    # FAILED drain keeps the entry — the journal is the
                    # only copy of the request left.
                    self._journal_done(r)
        return out


def resume_drained(drain_dir: str | Path, **kw) -> list[dict]:
    """Finish work a shutdown drained: for each group subdir, reload the
    histories from DRAIN_META (verified + migrated by ``store.durable``;
    pre-envelope drain dirs still resume) and re-enter the saved
    checkpoint (``batch_analysis(resume=True)`` — the saved ladder
    config wins).  Returns [{"dir", "model", "ids", "results"}] per
    group; a group whose meta is CORRUPT is quarantined aside and
    reported as {"dir", "error": <corruption report>} instead of being
    silently skipped — the operator learns which group's work is gone,
    the rest still resume."""
    from jepsen_tpu_torch.parallel import batch

    out = []
    root = Path(drain_dir)
    for sub in sorted(p for p in root.iterdir() if p.is_dir()):
        meta_p = sub / DRAIN_META
        if not meta_p.is_file():
            continue
        try:
            meta = _durable.read_verified(meta_p, KIND_DRAIN).payload
        except _durable.DurableError as e:
            logger.warning("corrupt drain meta %s: %s", meta_p, e)
            out.append({"dir": str(sub), "error": e.report})
            continue
        model = model_by_name(meta["model"])
        results = batch.batch_analysis(
            model, meta["histories"], checkpoint_dir=sub, resume=True, **kw
        )
        out.append({
            "dir": str(sub), "model": meta["model"],
            "ids": meta.get("ids", []), "results": results,
        })
    return out
