"""Self-healing for the check service: blast-radius isolation primitives.

The port of the JAX package's ``serve.health`` (stdlib, ``obs`` and
``store`` only: it imports without torch).  A long-lived multi-tenant
service shares launches, and sharing a launch also shares its
failures.  This module is the policy layer that
keeps one bad input, one lost device, or one wedged launch from
degrading everyone else — four pillars, composed by
``serve.service.CheckService``:

  * **Poison quarantine** (``bisect_poison`` + ``Quarantine``) — when a
    shared ``batch_analysis`` launch fails NON-transiently (transient
    and OOM faults are already retried/halved inside the ladder by
    ``jepsen_tpu_torch.faults``), the member set is bisected with bounded
    relaunches: innocent members get their real verdicts from the
    succeeding halves, and the member(s) whose presence makes launches
    fail are quarantined — unknown verdict with the cause, plus a
    TTL'd registry entry keyed by history fingerprint so a repeat
    offender skips straight to rejection instead of poisoning another
    shared launch.  Isolating a single poison member costs O(log n)
    relaunches.
  * **Circuit breaker** (``CircuitBreaker``) — K consecutive batch
    failures open the breaker: admission returns 503 + retry-after
    instead of queueing work the device can't serve; after a cooldown
    the breaker half-opens and one probe batch decides whether to
    close it again.
  * **Hung-launch watchdog** (``LaunchWatchdog``) — per-launch
    wall-clock caps derived from the EWMA of recorded launch times
    (``faults.launch_seconds_ewma``, fed by ``parallel.batch._launch``);
    a launch that exceeds its cap raises ``HungLaunch`` so the service
    can cancel (abandon — first-write-wins result demux discards the
    zombie's late verdicts) and retry on reduced placement.
  * **Crash-safe restart** (``AdmissionJournal``) — an fsync'd,
    checksummed journal of admitted-but-unfinished requests
    (``store.durable`` envelopes over ``store._atomic_write``, one file
    per request in the drain-dir format) replayed by
    ``CheckService.start()``: a service crash loses no admitted
    request, and replayed requests keep their ids so ``GET
    /check/<id>`` keeps working across the restart.  Corrupt entries
    quarantine aside with a machine-readable report instead of
    blocking (or silently shrinking) the replay.
  * **Idempotent resubmission** (``IdempotencyMap``) — a journaled
    TTL'd ``idempotency_key`` registry: the retry behavior the
    backpressure 429s / breaker 503s / wait timeouts instruct can
    never double-run a check — duplicates attach to the in-flight
    future or get the settled result, original request id preserved,
    across a SIGKILL restart.

Nothing here decides verdicts: quarantine and watchdog degradation
resolve only to attributable ``unknown``s, never to a flipped verdict.
"""

from __future__ import annotations

import contextlib
import logging
import math
import threading
import time
from pathlib import Path
from typing import Callable, Mapping, Sequence

from jepsen_tpu_torch import obs, store
from jepsen_tpu_torch.store import checkpoint as _ckpt
from jepsen_tpu_torch.store import durable as _durable

logger = logging.getLogger(__name__)

#: durable-record kinds this layer persists (see store.durable): the
#: admission journal's per-request entries, the idempotency map's
#: per-key entries, and the shared quarantine registry's per-
#: fingerprint entries.  All are envelope v1; journal/idem carry a
#: legacy (pre-envelope, version 0) migration so a pre-durable journal
#: replays unchanged.
KIND_JOURNAL = "admission-journal"
KIND_IDEM = "idempotency-entry"
KIND_QUAR = "quarantine-entry"

_durable.register_kind(KIND_JOURNAL, 1)
_durable.register_kind(KIND_IDEM, 1)
_durable.register_kind(KIND_QUAR, 1)


@_durable.register_migration(KIND_JOURNAL, 0)
def _journal_v0_to_v1(payload):
    # v0 was the bare entry dict — same fields, no checksum.
    return dict(payload), 1


@_durable.register_migration(KIND_IDEM, 0)
def _idem_v0_to_v1(payload):
    # pre-envelope idem entries (e.g. hand-restored by an operator)
    # read as payload-only version 0 — same fields
    return dict(payload), 1


def history_fingerprint(history) -> str:
    """The quarantine/journal identity of one history (the same sha256
    the checkpoint layer uses, over a single-history list)."""
    return _ckpt.fingerprint([history])


# ---------------------------------------------------------------------------
# Poison quarantine
# ---------------------------------------------------------------------------

class Quarantine:
    """A TTL'd registry of poison-history fingerprints.

    ``add`` records a fingerprint with its cause; ``check`` returns the
    live entry (or None) so admission can reject a repeat offender
    before it reaches a shared launch.  Entries expire after ``ttl_s``
    — a poison verdict is evidence, not a life sentence (the failure
    may have been environmental) — and expired entries are purged
    lazily on access.  Thread-safe."""

    def __init__(self, ttl_s: float = 900.0):
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        #: fp -> {"cause", "expires", "hits", "added"}
        self._entries: dict[str, dict] = {}      # guarded-by: _lock [rw]

    def __len__(self) -> int:
        with self._lock:
            self._purge_locked()
            return len(self._entries)

    # holds: _lock
    def _purge_locked(self) -> None:
        now = time.monotonic()
        dead = [fp for fp, e in self._entries.items() if e["expires"] <= now]
        for fp in dead:
            del self._entries[fp]

    def add(self, fp: str, cause: str) -> None:
        with self._lock:
            self._purge_locked()
            self._entries[fp] = {
                "cause": str(cause)[:300],
                "expires": time.monotonic() + self.ttl_s,
                "hits": 0,
                "added": time.time(),
            }

    def check(self, fp: str) -> dict | None:
        """The live entry for ``fp`` (hit-counted), or None.  A hit
        refreshes the TTL — a fingerprint still being submitted is
        still worth remembering."""
        with self._lock:
            self._purge_locked()
            e = self._entries.get(fp)
            if e is not None:
                e["hits"] += 1
                e["expires"] = time.monotonic() + self.ttl_s
            return e

    def describe(self) -> dict:
        with self._lock:
            self._purge_locked()
            return {
                "entries": len(self._entries),
                "ttl_s": self.ttl_s,
                "hits": sum(e["hits"] for e in self._entries.values()),
            }


class SharedQuarantine(Quarantine):
    """``Quarantine`` semantics over a shared fsync'd directory: the
    fleet-wide poison registry.

    One ``store.durable`` enveloped file per fingerprint.  ``add``
    writes the entry (under the fingerprint's advisory file lock, see
    ``store.durable.file_lock``) so EVERY replica pointed at the same
    ``quarantine_dir`` refuses the history at admission — on its FIRST
    local offense, not after poisoning its own shared launch too.
    ``check`` consults the in-memory registry first; a miss costs one
    ``stat`` on the fingerprint's path (O(1), no directory scan), and a
    disk hit is adopted into memory, counted as the
    ``fleet.quarantine_hits`` counter.

    Expiry on disk is WALL clock (``expires`` epoch seconds — replicas
    don't share a monotonic clock); the in-memory mirror keeps the
    superclass's monotonic TTL.  Corrupt entries count on ``errors``
    and read as absent — a broken registry file must degrade to
    "launch and decide", never to refusing service."""

    def __init__(self, ttl_s: float = 900.0, dir: str | Path | None = None):  # noqa: A002
        super().__init__(ttl_s)
        if dir is None:
            raise ValueError("SharedQuarantine requires a directory; "
                             "use Quarantine for in-memory-only")
        self.dir = Path(dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.errors = 0
        self.disk_hits = 0

    def _fp_path(self, fp: str) -> Path:
        # fingerprints are sha256 hex; 40 chars of it is filename-safe
        # and collision-negligible (the payload keeps the full fp and
        # check() verifies it before trusting the entry)
        return self.dir / f"quar-{str(fp)[:40]}.json"

    def add(self, fp: str, cause: str) -> None:
        super().add(fp, cause)
        now = time.time()
        payload = {
            "fp": str(fp), "cause": str(cause)[:300],
            "added": now, "expires": now + self.ttl_s,
        }
        p = self._fp_path(fp)
        try:
            with _durable.file_lock(Path(str(p) + ".lock"), timeout_s=10.0):
                _durable.write_record(p, KIND_QUAR, payload)
        except Exception:  # noqa: BLE001 — registry persistence is a
            # fleet-wide aid; THIS replica still quarantines in memory
            self.errors += 1
            logger.warning("shared quarantine write failed for %s",
                           fp, exc_info=True)

    def check(self, fp: str) -> dict | None:
        e = super().check(fp)
        if e is not None:
            return e
        p = self._fp_path(fp)
        if not p.exists():
            return None
        try:
            with _durable.file_lock(Path(str(p) + ".lock"), timeout_s=10.0):
                rr = _durable.read_verified(p, KIND_QUAR)
        except _durable.DurableError:
            self.errors += 1
            return None
        except Exception:  # noqa: BLE001 — lock timeout / IO error
            self.errors += 1
            logger.warning("shared quarantine read failed for %s",
                           fp, exc_info=True)
            return None
        d = rr.payload
        if not isinstance(d, dict) or d.get("fp") != str(fp):
            self.errors += 1
            return None
        if float(d.get("expires") or 0) <= time.time():
            with contextlib.suppress(OSError):
                p.unlink()
            return None
        entry = {
            "cause": str(d.get("cause") or "")[:300],
            # adopted with a FULL local TTL — same refresh-on-hit
            # semantics a locally-added entry gets
            "expires": time.monotonic() + self.ttl_s,
            "hits": 1,
            "added": float(d.get("added") or time.time()),
        }
        with self._lock:
            self._entries[str(fp)] = entry
        self.disk_hits += 1
        obs.counter("fleet.quarantine_hits")
        return dict(entry)

    def describe(self) -> dict:
        out = super().describe()
        out.update(shared=True, dir=str(self.dir),
                   disk_hits=self.disk_hits, errors=self.errors)
        return out


def bisect_launch_budget(n: int) -> int:
    """The relaunch budget ``bisect_poison`` defaults to: enough to
    isolate one poison member among ``n`` — both bisection paths at
    every level, ~2·(log2(n)+1) — with one extra level of slack for a
    second offender before the remainder is quarantined as a group."""
    levels = max(1, math.ceil(math.log2(max(2, n)))) + 1
    return 3 * levels


def bisect_poison(
    launch: Callable[[list], list],
    members: Sequence,
    *,
    max_launches: int | None = None,
) -> tuple[list, dict, int]:
    """Isolate the poison member(s) of a failed shared launch.

    ``launch(subset)`` re-runs the shared work over ``subset`` and
    returns one result per member (or raises — the failure signature
    being bisected).  Returns ``(poison, results, launches)``: the
    members whose presence makes launches fail, a ``{member: result}``
    map for every innocent member (their REAL verdicts, recovered from
    the succeeding halves), and the relaunch count.

    Classic group testing: a failing group of one is poison; a failing
    group of many splits in half and recurses.  A single poison member
    among n costs O(log n) relaunches.  ``max_launches`` (default
    ``bisect_launch_budget(n)``) bounds the degradation: when the
    budget runs out, the still-unresolved group is quarantined TOGETHER
    (conservative — innocents in it degrade to unknown, never to a
    wrong verdict)."""
    members = list(members)
    budget = (
        bisect_launch_budget(len(members))
        if max_launches is None else int(max_launches)
    )
    poison: list = []
    results: dict = {}
    launches = 0
    stack: list[list] = [members]
    while stack:
        group = stack.pop()
        if not group:
            continue
        if launches >= budget:
            # Budget exhausted: quarantine the rest as a group rather
            # than launch forever against a pathological failure mix.
            poison.extend(group)
            continue
        launches += 1
        try:
            out = launch(list(group))
        except Exception:  # noqa: BLE001 — the signature being bisected
            if len(group) == 1:
                poison.append(group[0])
            else:
                mid = (len(group) + 1) // 2
                # push the back half first so the front half (older
                # members) is served next — deterministic order
                stack.append(group[mid:])
                stack.append(group[:mid])
            continue
        for mem, res in zip(group, out):
            results[mem] = res
    return poison, results, launches


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Closed → (K consecutive failures) → open → (cooldown) →
    half-open → one probe success closes / failure re-opens.

    ``allow()`` is the admission gate: False means reject now (the HTTP
    layer returns 503 + Retry-After ``retry_after()``).  While OPEN the
    gate stays shut until ``cooldown_s`` elapses; the first ``allow()``
    after that transitions to HALF-OPEN and admits exactly ONE probe —
    further ``allow()`` calls stay rejected until a batch outcome is
    recorded, so a retry stampede at cooldown expiry can't refill the
    queue with doomed work against a still-broken device.  Thread-safe;
    the owning service calls ``record_failure``/``record_success`` per
    batch outcome."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 30.0):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self.state = "closed"                    # guarded-by: _lock [rw]
        self.consecutive_failures = 0            # guarded-by: _lock [rw]
        self.opened_at: float | None = None      # guarded-by: _lock [rw]
        self.opens = 0                           # guarded-by: _lock [rw]
        # half-open admissions left before outcome
        self._probe_budget = 0                   # guarded-by: _lock [rw]

    def allow(self) -> bool:
        with self._lock:
            if self.state == "open":
                if (time.monotonic() - self.opened_at) >= self.cooldown_s:
                    self.state = "half-open"
                    self._probe_budget = 1
            if self.state == "half-open":
                if self._probe_budget > 0:
                    self._probe_budget -= 1
                    return True
                return False
            return self.state == "closed"

    def retry_after(self) -> float:
        with self._lock:
            if self.state == "half-open":
                # a probe is in flight; its outcome decides shortly
                return 0.5
            if self.state != "open" or self.opened_at is None:
                return 0.0
            return max(
                0.0, self.cooldown_s - (time.monotonic() - self.opened_at)
            )

    def record_failure(self) -> bool:
        """One batch failed; returns True when THIS failure opened (or
        re-opened) the breaker."""
        with self._lock:
            self.consecutive_failures += 1
            if self.state == "half-open" or (
                self.state == "closed"
                and self.consecutive_failures >= self.threshold
            ):
                self.state = "open"
                self.opened_at = time.monotonic()
                self.opens += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            if self.state in ("half-open", "open"):
                # an open breaker can see a success when a probe batch
                # admitted just before the trip completes late — either
                # way the device demonstrably serves again
                self.state = "closed"
                self.opened_at = None

    def describe(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "opens": self.opens,
                "retry_after_s": round(
                    max(0.0, self.cooldown_s
                        - (time.monotonic() - self.opened_at))
                    if self.state == "open" and self.opened_at is not None
                    else 0.0, 3),
            }


# ---------------------------------------------------------------------------
# Hung-launch watchdog
# ---------------------------------------------------------------------------

class HungLaunch(Exception):
    """A watched launch exceeded its wall-clock cap.  The worker thread
    may STILL be running (a CUDA launch cannot be cancelled from
    Python: the abandoned ladder keeps the card until it ends, and the
    retry queues behind it on the stream) — the caller abandons it and
    retries on reduced placement; first-write-wins result demux
    discards the zombie's late output."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        super().__init__(f"launch exceeded its {timeout_s:.1f}s watchdog cap")


class LaunchWatchdog:
    """Per-launch wall-clock caps derived from the launch-time EWMA.

    ``timeout_s()`` is ``factor ×`` the process launch EWMA
    (``faults.launch_seconds_ewma``), clamped to ``[floor_s, cap_s]`` —
    a healthy ladder's launches are milliseconds-to-seconds, so a
    multi-minute one is wedged, not slow.  ``run(fn)`` executes ``fn``
    on a daemon worker thread and raises ``HungLaunch`` when the cap
    passes first."""

    def __init__(self, factor: float = 16.0, floor_s: float = 30.0,
                 cap_s: float = 600.0):
        self.factor = float(factor)
        self.floor_s = float(floor_s)
        self.cap_s = float(cap_s)
        self.trips = 0

    def timeout_s(self) -> float:
        from jepsen_tpu_torch import faults

        ewma = faults.launch_seconds_ewma()
        t = self.factor * ewma if ewma is not None else self.floor_s
        return min(self.cap_s, max(self.floor_s, t))

    def run(self, fn: Callable[[], object], timeout_s: float | None = None):
        """``fn()``'s result, or ``HungLaunch`` after the cap.  ``fn``'s
        own exception re-raises on this thread."""
        timeout_s = self.timeout_s() if timeout_s is None else float(timeout_s)
        box: dict = {}
        done = threading.Event()

        def _work():
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(
            target=_work, name="launch-watchdog-worker", daemon=True
        )
        t.start()
        if not done.wait(timeout_s):
            self.trips += 1
            raise HungLaunch(timeout_s)
        if "error" in box:
            raise box["error"]
        return box["result"]


# ---------------------------------------------------------------------------
# Crash-safe admission journal
# ---------------------------------------------------------------------------

class AdmissionJournal:
    """An fsync'd, CHECKSUMMED record of admitted-but-unfinished
    requests.

    One JSON file per request in the ``store.durable`` envelope
    (``store._atomic_write`` underneath: tmp + fsync + rename + dir
    fsync), in the drain-dir format (model name + history + request
    identity + idempotency key) so ``replay()`` can rebuild the exact
    submission.  ``record`` on admission, ``resolve`` when the request
    settles (any terminal status — done, expired, quarantined,
    drained); whatever files remain after a crash ARE the lost queue,
    replayed by ``CheckService.start()``.  A corrupt entry — atomic
    renames rule out torn writes, but bit rot, partial copies, and
    operators hand-editing the dir do not go away — is QUARANTINED
    aside (``<name>.corrupt-<n>``), counted, and its corruption report
    kept on ``corrupt_reports`` for the stats surface; the rest of the
    queue still replays.  Write failures are counted and logged, never
    raised into admission — journaling is a recovery aid, not an
    admission gate.

    ``depth()`` is a CACHED counter (maintained at record/resolve,
    reconciled against the directory at ``replay()``) — it used to
    re-glob the journal dir on every stats call, which made ``GET
    /queue`` an O(queue-depth) directory walk.

    ``shared=True`` serializes record/resolve/replay across PROCESSES
    under a directory-level advisory lock (``journal.lock``,
    ``store.durable.file_lock``): a journal dir handed between fleet
    replicas (rollout successor replaying while the predecessor's last
    resolves land) can't interleave a replay with a half-applied
    mutation.  Off by default — a journal dir owned by exactly one
    process pays no extra syscalls."""

    def __init__(self, journal_dir: str | Path, *, shared: bool = False):
        self.dir = Path(journal_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.shared = bool(shared)
        self.errors = 0
        self.corrupt_reports: list[dict] = []    # guarded-by: _lock [rw]
        self._lock = threading.Lock()
        self._depth = self._glob_depth()         # guarded-by: _lock [rw]

    @contextlib.contextmanager
    def _dir_lock(self):
        if not self.shared:
            yield
            return
        with _durable.file_lock(self.dir / "journal.lock", timeout_s=30.0):
            yield

    def _glob_depth(self) -> int:
        try:
            return sum(1 for _ in self.dir.glob("req-*.json"))
        except OSError:
            return 0

    def _path(self, req_id: str) -> Path:
        return self.dir / f"req-{req_id}.json"

    def record(self, *, req_id: str, seq: int, model_name: str, history,
               priority: int, client: str, tier: str,
               trace_id: str, deadline_s: float | None,
               idempotency_key: str | None = None) -> bool:
        entry = {
            "id": req_id, "seq": int(seq), "model": model_name,
            "history": store._jsonable(list(history)),
            "priority": int(priority), "client": str(client),
            "class": str(tier), "trace_id": str(trace_id),
            "deadline_s": deadline_s,
        }
        if idempotency_key is not None:
            entry["idempotency_key"] = str(idempotency_key)
        try:
            with self._dir_lock():
                existed = self._path(req_id).exists()
                _durable.write_record(self._path(req_id), KIND_JOURNAL, entry)
            if not existed:
                with self._lock:
                    self._depth += 1
            return True
        except Exception:  # noqa: BLE001 — see docstring
            self.errors += 1
            logger.warning("admission journal write failed for %s",
                           req_id, exc_info=True)
            return False

    def resolve(self, req_id: str) -> None:
        try:
            with self._dir_lock():
                self._path(req_id).unlink()
        except FileNotFoundError:
            return  # already resolved (or never journaled): depth unchanged
        except OSError:
            self.errors += 1
            logger.warning("admission journal unlink failed for %s",
                           req_id, exc_info=True)
            return
        with self._lock:
            self._depth = max(0, self._depth - 1)

    def depth(self) -> int:
        with self._lock:
            return self._depth

    def replay(self) -> list[dict]:
        """Every surviving VERIFIED entry, in admission (seq) order.
        Corrupt entries are quarantined aside with their reports
        collected; the cached depth is reconciled against what is
        actually on disk afterwards (quarantined files leave the
        glob)."""
        out = []
        with self._dir_lock():
            entries = sorted(self.dir.glob("req-*.json"))
        for p in entries:
            try:
                rr = _durable.read_verified(p, KIND_JOURNAL)
                out.append(rr.payload)
            except _durable.DurableError as e:
                self.errors += 1
                with self._lock:
                    self.corrupt_reports.append(e.report)
                logger.warning("corrupt journal entry %s quarantined: %s",
                               p, e)
        out.sort(key=lambda e: e.get("seq", 0))
        with self._lock:
            self._depth = self._glob_depth()
        return out


# ---------------------------------------------------------------------------
# Idempotent resubmission
# ---------------------------------------------------------------------------

class IdempotencyMap:
    """A TTL'd ``idempotency_key -> (request id, settled result)`` map,
    optionally journaled to disk so it survives a SIGKILL restart.

    The service's retry story actively INSTRUCTS clients to resubmit:
    backpressure 429s, breaker 503s and wait timeouts all carry
    Retry-After hints — and a naive resubmit after a timeout whose
    first attempt was actually admitted double-runs the check.  This
    map closes that hole: ``claim`` atomically either binds a fresh
    key to the new request id or hands back the live entry (the caller
    then attaches the duplicate to the in-flight future, or returns
    the settled result — under the ORIGINAL request id).  ``settle``
    records the verdict against the key; entries expire ``ttl_s`` after
    their last write (wall clock, so expiry works across restarts).

    With a ``dir``, every bind/settle is persisted as one
    ``store.durable`` enveloped file per key and ``replay()`` reloads
    the map at service start — a duplicate submitted AFTER a crash
    still attaches to the journal-replayed in-flight request (same id)
    or gets the previously settled result.  Corrupt entries are
    quarantined aside and counted (``errors``); persistence failures
    never fail a submit.

    ``shared=True`` makes the dir a FLEET-wide map: claim / rebind /
    settle / release become read-modify-writes of the key's entry file
    under a per-key advisory ``fcntl`` lock (a ``.lock`` sidecar,
    ``store.durable.file_lock``), with the on-disk entry as the source
    of truth.  Without it, two PROCESSES pointed at the same dir can
    both claim a key — the in-process ``_lock`` only arbitrates
    threads — and a router resubmitting a fenced replica's in-flight
    work through its idempotency keys could double-run a check.  With
    it, a cross-process duplicate claim loses atomically: the loser
    reads the winner's live entry and attaches (or, if the winner died
    unsettled, rebinds under the same lock).  ``settle`` takes an
    optional ``req_id`` CAS so a fenced-but-still-running zombie
    replica whose request was rebound elsewhere can never overwrite
    the binding's verdict of record."""

    def __init__(self, dir: str | Path | None = None,  # noqa: A002
                 ttl_s: float = 3600.0, *, shared: bool = False):
        self.dir = Path(dir) if dir is not None else None
        self.shared = bool(shared) and self.dir is not None
        self.ttl_s = float(ttl_s)
        self.errors = 0
        self._lock = threading.Lock()
        #: key -> {"key", "req_id", "ts", "result"}
        self._entries: dict[str, dict] = {}      # guarded-by: _lock [rw]
        #: monotonic state-transition stamp (every mutation bumps it)
        self._seq = 0                            # guarded-by: _lock [rw]
        #: the IO side: disk writes happen OUTSIDE ``_lock`` (an fsync
        #: under the map lock would stall every stats()/lookup() behind
        #: disk latency — the hazard class the journal depth cache just
        #: removed) but serialized under ``_io_lock`` with a per-key
        #: last-written seq, so an older snapshot can never overwrite a
        #: newer state on disk.
        self._io_lock = threading.Lock()
        self._written: dict[str, int] = {}       # guarded-by: _io_lock [rw]
        if self.dir is not None:
            self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        import hashlib as _hashlib

        digest = _hashlib.sha256(key.encode()).hexdigest()[:24]
        return self.dir / f"idem-{digest}.json"

    # -- shared (cross-process) mode helpers ---------------------------

    def _key_lock(self, key: str):
        # sidecar lock file, never unlinked (see durable.file_lock) —
        # and never matched by replay()'s "idem-*.json" glob
        return _durable.file_lock(
            Path(str(self._path(key)) + ".lock"), timeout_s=30.0
        )

    # holds: the key's file lock
    def _read_disk_locked(self, key: str) -> dict | None:
        """The live on-disk entry for ``key``, or None.  An expired
        file is deleted here (safe: we hold its lock); a corrupt one
        reads as absent and counts on ``errors`` (read_verified has
        already quarantined it aside)."""
        p = self._path(key)
        if not p.exists():
            return None
        try:
            rr = _durable.read_verified(p, KIND_IDEM)
        except _durable.DurableError:
            self.errors += 1
            return None
        e = rr.payload
        if not isinstance(e, dict) or "key" not in e:
            self.errors += 1
            return None
        if time.time() - float(e.get("ts") or 0) > self.ttl_s:
            with contextlib.suppress(OSError):
                p.unlink()
            return None
        return {
            "key": str(e["key"]), "req_id": str(e.get("req_id") or ""),
            "ts": float(e.get("ts") or time.time()),
            "result": e.get("result"), "fp": e.get("fp"),
        }

    # holds: the key's file lock
    def _write_disk_locked(self, key: str, snapshot: dict) -> None:
        try:
            _durable.write_record(self._path(key), KIND_IDEM, snapshot)
        except Exception:  # noqa: BLE001 — same contract as _persist
            self.errors += 1
            logger.warning("idempotency entry write failed for key %r",
                           key, exc_info=True)

    # holds: the key's file lock
    def _sync_memory_locked(self, key: str, disk: dict | None) -> None:
        """Make the in-memory mirror agree with the disk truth just
        read under the lock (another process may have moved the key)."""
        with self._lock:
            if disk is None:
                self._entries.pop(key, None)
            else:
                self._entries[key] = dict(disk)
            self._seq += 1

    # holds: _lock
    def _purge_locked(self) -> list[str]:
        """Drop expired entries from memory; returns the expired keys
        so the caller can reclaim their DISK files outside the lock
        (a long-lived service must not grow one idem file per key it
        ever saw until the next restart)."""
        now = time.time()
        dead = [k for k, e in self._entries.items()
                if now - e["ts"] > self.ttl_s]
        for k in dead:
            del self._entries[k]
            self._seq += 1
        return dead

    def _unlink_keys(self, keys) -> None:
        """Reclaim dead keys' disk files.  A racing in-flight persist
        (snapshot taken before the key died) may recreate a file after
        this unlink; that residue is harmless — replay() either sees
        an expired ts and deletes it, or an unsettled binding to a
        request that never ran, which the rebind-after-grace path runs
        fresh.  What must NOT leak is ``_written``: popping the key
        here is what keeps the seq map bounded by live entries.

        Shared mode re-checks the DISK ts under the key's file lock
        before unlinking: this replica's memory expiring a key says
        nothing about a sibling replica having refreshed it since."""
        if self.dir is None or not keys:
            return
        if self.shared:
            for k in keys:
                try:
                    with self._key_lock(k):
                        # reads the disk entry; an expired one is
                        # unlinked inside, a live (refreshed-elsewhere)
                        # one is left alone
                        self._read_disk_locked(k)
                except Exception:  # noqa: BLE001 — lock timeout/IO
                    self.errors += 1
            with self._io_lock:
                for k in keys:
                    self._written.pop(k, None)
            return
        with self._io_lock:
            for k in keys:
                try:
                    self._path(k).unlink(missing_ok=True)
                except OSError:
                    self.errors += 1
                self._written.pop(k, None)

    def _persist(self, key: str, seq: int, snapshot: dict) -> None:
        """Write one entry snapshot taken at state-transition ``seq``.
        Runs outside the map lock; ``_io_lock`` + the per-key
        last-written seq enforce that disk state never goes BACKWARD
        even when two transitions race to the writer — in-memory order
        and on-disk order agree, which is what replay() trusts."""
        if self.dir is None:
            return
        with self._io_lock:
            if self._written.get(key, 0) >= seq:
                return  # a newer state for this key already landed
            self._written[key] = seq
            try:
                _durable.write_record(self._path(key), KIND_IDEM, snapshot)
            except Exception:  # noqa: BLE001 — persistence is a recovery
                # aid; the in-memory map still dedups within this process
                self.errors += 1
                logger.warning("idempotency entry write failed for key %r",
                               key, exc_info=True)

    def claim(self, key: str, req_id: str,
              fp: str | None = None) -> dict | None:
        """Atomically bind ``key`` to ``req_id`` — unless a live entry
        already holds it, in which case THAT entry (a copy) is returned
        and nothing is written.  None means the claim is ours.  ``fp``
        (the history fingerprint) is stored on the entry so the caller
        can detect KEY REUSE across different histories — without it a
        key collision would hand one caller another history's
        verdict."""
        key = str(key)
        if self.shared:
            # Cross-process atomicity: the entry FILE is the claim
            # token.  Under the key's advisory lock, read disk truth —
            # a live entry (ours from an earlier claim, or a sibling
            # replica's) loses the claim; absence binds us, and the
            # write lands BEFORE the lock releases, so no second
            # process can observe the gap two in-process claims never
            # had.
            with self._lock:
                dead = self._purge_locked()
            with self._key_lock(key):
                disk = self._read_disk_locked(key)
                if disk is not None:
                    self._sync_memory_locked(key, disk)
                    claimed = None
                else:
                    e = {"key": key, "req_id": str(req_id),
                         "ts": time.time(), "result": None, "fp": fp}
                    self._sync_memory_locked(key, e)
                    self._write_disk_locked(key, dict(e))
                    claimed = dict(e)
            self._unlink_keys(dead)
            return None if claimed is not None else dict(disk)
        with self._lock:
            dead = self._purge_locked()
            e = self._entries.get(key)
            if e is not None:
                snapshot, seq = dict(e), None
            else:
                self._seq += 1
                seq = self._seq
                e = {"key": key, "req_id": str(req_id), "ts": time.time(),
                     "result": None, "fp": fp}
                self._entries[key] = e
                snapshot = dict(e)
        self._unlink_keys(dead)
        if seq is None:
            return snapshot
        self._persist(key, seq, snapshot)
        return None

    def rebind(self, key: str, old_req_id: str, new_req_id: str) -> bool:
        """CAS a STALE entry (its request evaporated — e.g. evicted
        before settling, or bound by a replica that died) onto a new
        request id.  False when the entry changed underneath (someone
        else rebound or settled it)."""
        key = str(key)
        if self.shared:
            with self._key_lock(key):
                disk = self._read_disk_locked(key)
                if disk is None or disk["req_id"] != str(old_req_id) \
                        or disk["result"] is not None:
                    self._sync_memory_locked(key, disk)
                    return False
                disk["req_id"] = str(new_req_id)
                disk["ts"] = time.time()
                self._sync_memory_locked(key, disk)
                self._write_disk_locked(key, dict(disk))
            return True
        with self._lock:
            e = self._entries.get(key)
            if e is None or e["req_id"] != str(old_req_id) \
                    or e["result"] is not None:
                return False
            e["req_id"] = str(new_req_id)
            e["ts"] = time.time()
            self._seq += 1
            seq, snapshot = self._seq, dict(e)
        self._persist(key, seq, snapshot)
        return True

    def settle(self, key: str, result: Mapping | None,
               req_id: str | None = None) -> None:
        """Record the settled verdict against ``key`` (refreshes the
        TTL: a settled entry answers duplicates for a full window after
        the verdict, not after the submit).  With ``req_id``, settle
        only if the key is still bound to THAT request — the fence/
        rebind race guard: a zombie replica finishing a request whose
        key the router already rebound elsewhere must discard its
        verdict, not publish it over the binding of record."""
        key = str(key)
        if self.shared:
            with self._key_lock(key):
                disk = self._read_disk_locked(key)
                if disk is None or (req_id is not None
                                    and disk["req_id"] != str(req_id)):
                    self._sync_memory_locked(key, disk)
                    return
                disk["result"] = store._jsonable(dict(result)) \
                    if result is not None else None
                disk["ts"] = time.time()
                self._sync_memory_locked(key, disk)
                self._write_disk_locked(key, dict(disk))
            return
        with self._lock:
            e = self._entries.get(key)
            if e is None or (req_id is not None
                             and e["req_id"] != str(req_id)):
                return
            e["result"] = store._jsonable(dict(result)) \
                if result is not None else None
            e["ts"] = time.time()
            self._seq += 1
            seq, snapshot = self._seq, dict(e)
        self._persist(key, seq, snapshot)

    def release(self, key: str, req_id: str) -> None:
        """Drop OUR unsettled claim (the submit it covered failed
        admission) so the client's retry isn't answered with a request
        that never existed."""
        key = str(key)
        if self.shared:
            with self._key_lock(key):
                disk = self._read_disk_locked(key)
                if disk is None or disk["req_id"] != str(req_id) \
                        or disk["result"] is not None:
                    self._sync_memory_locked(key, disk)
                    return
                self._sync_memory_locked(key, None)
                try:
                    self._path(key).unlink(missing_ok=True)
                except OSError:
                    self.errors += 1
            with self._io_lock:
                self._written.pop(key, None)
            return
        with self._lock:
            e = self._entries.get(key)
            if e is None or e["req_id"] != str(req_id) \
                    or e["result"] is not None:
                return
            del self._entries[key]
            self._seq += 1
        self._unlink_keys([key])

    def lookup(self, key: str) -> dict | None:
        with self._lock:
            dead = self._purge_locked()
            e = self._entries.get(str(key))
            out = dict(e) if e is not None else None
        self._unlink_keys(dead)
        return out

    def depth(self) -> int:
        with self._lock:
            dead = self._purge_locked()
            n = len(self._entries)
        self._unlink_keys(dead)
        return n

    def replay(self) -> int:
        """Reload the journaled map (service start).  Expired files are
        deleted, corrupt ones quarantined + counted; returns live
        entries loaded."""
        if self.dir is None:
            return 0
        n = 0
        now = time.time()
        for p in sorted(self.dir.glob("idem-*.json")):
            try:
                rr = _durable.read_verified(p, KIND_IDEM)
            except _durable.DurableError as e:
                self.errors += 1
                logger.warning("corrupt idempotency entry %s quarantined: "
                               "%s", p, e)
                continue
            e = rr.payload
            if not isinstance(e, dict) or "key" not in e:
                self.errors += 1
                continue
            if now - float(e.get("ts") or 0) > self.ttl_s:
                with contextlib.suppress(OSError):
                    p.unlink()
                continue
            with self._lock:
                self._entries[str(e["key"])] = {
                    "key": str(e["key"]),
                    "req_id": str(e.get("req_id") or ""),
                    "ts": float(e.get("ts") or now),
                    "result": e.get("result"),
                    # fp must survive the restart or key-reuse-across-
                    # histories rejection silently turns off after it
                    "fp": e.get("fp"),
                }
            n += 1
        return n

    def describe(self) -> dict:
        with self._lock:
            dead = self._purge_locked()
            out = {
                "entries": len(self._entries),
                "settled": sum(1 for e in self._entries.values()
                               if e["result"] is not None),
                "ttl_s": self.ttl_s,
                "errors": self.errors,
                "journaled": self.dir is not None,
                "shared": self.shared,
            }
        self._unlink_keys(dead)
        return out
