"""Fault tolerance for the checker pipeline: retry, degrade, deadline.

The port's copy of the JAX package's ``faults``.  Long device jobs die
(out-of-memory, transient runtime errors, dead worker pools), and a
multi-minute checker ladder must survive them.  This module is the
policy layer the launch sites thread through:

  * ``error_kind(e)`` classifies an exception for the retry policy:
    ``"oom"`` (halve the work and relaunch), ``"transient"`` (back off
    and retry the same launch) or ``None`` (not a recognized device
    fault: the caller re-raises, so a code bug stays loud).  On the card
    an out-of-memory is ``torch.OutOfMemoryError`` ("CUDA out of
    memory"), and the kernels' wrappers raise ``RuntimeError("... CUDA
    error <rc> (...)")`` with the runtime's code.  A sticky CUDA error
    (an illegal address, an unspecified launch failure, a device-side
    assert, an uncorrectable ECC error, ...) poisons the context: every
    later launch fails too, so retrying it or degrading only its lanes
    cannot work, and it classifies as ``None``.  The JAX package's XLA
    marker strings classify as they do there, so an injected fault takes
    the same path in both packages.
  * ``call_with_retry(fn, ctx)`` runs one device launch under that
    policy: transient faults retry with exponential backoff (env knobs
    below); an OOM and a launch still failing raise ``LaunchFailure``
    for the caller to handle (``parallel.batch`` halves the sub-batch on
    an OOM and degrades only the failing lanes to ``"unknown"``;
    ``ops.wgl.chunked_analysis`` degrades the single history).
  * ``Deadline`` is the wall-clock check budget (the test map's
    ``"check-deadline"``, threaded through ``checker.check_safe`` and
    ``Compose`` as opts key ``"deadline"``): stage and chunk boundaries
    poll ``expired()``; on expiry the ladder checkpoints
    (``store.checkpoint``) and marks the remaining histories
    ``unknown``.

Env knobs, the JAX package's names (read per call):

  JEPSEN_TPU_LAUNCH_RETRIES   transient retries per launch (default 3)
  JEPSEN_TPU_RETRY_BASE_S     first backoff delay (default 0.25)
  JEPSEN_TPU_RETRY_MAX_S      backoff cap (default 8.0)

``INJECT`` is the fault-injection seam: when set to a callable it runs
as ``INJECT(ctx, attempt)`` before every launch attempt and may raise a
synthetic fault.  Install injectors with ``inject_scope`` (thread-safe,
nesting) and a ``seeded_injector`` (a deterministic fault schedule per
seed) rather than assigning ``INJECT``.  The durable-write steps of
``store._atomic_write`` announce themselves through the same seam.

The JAX package's ``fault.*`` counters and metrics are left out with the
telemetry.  This module imports neither torch nor anything that does:
the spawned confirmation workers import it.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import re
import threading
import time
import traceback
from typing import Callable, Mapping

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.obs import metrics as _metrics

#: fault-injection hook: ``INJECT(ctx, attempt)`` runs before each launch
#: attempt and may raise (classified exactly like a real launch error).
#: The durable-write seams announce themselves here too
#: (``store._atomic_write``: ctx ``what="store.atomic_write"``, ``step``
#: in post-tmp / post-fsync / post-rename / pre-dir-fsync).  Injectors
#: aimed at launches must filter on ctx ``what``.
INJECT: Callable[[dict, int], None] | None = None


class CrashPoint(BaseException):
    """A simulated process death at a durable-write step.

    Raised by a crashpoint injector inside a write seam;
    ``store._atomic_write`` performs no cleanup for it (unlike ordinary
    exceptions, whose tmp file is unlinked), so the files on disk are
    exactly what a SIGKILL at that step leaves.  A ``BaseException`` on
    purpose: ``except Exception`` guards around checkpoint writes must
    not swallow a simulated death."""

    def __init__(self, step: str, path: str = "?"):
        self.step = step
        self.path = path
        super().__init__(f"simulated crash at {step} writing {path}")


#: serializes INJECT install/restore (inject_scope); re-entrant so a
#: scope may nest inside another on the same thread.
_INJECT_LOCK = threading.RLock()

#: the live inject_scope entries, oldest first.  The installed hook is
#: rebuilt from this stack on every enter and exit, and an exiting scope
#: removes only its own entry, so overlapping scopes on different
#: threads may exit in any order.
_INJECT_STACK: list = []
#: whatever was assigned to INJECT directly before the first scope
#: entered; restored when the last scope exits.
_INJECT_BASE: Callable[[dict, int], None] | None = None


def _set_inject(fn) -> None:
    global INJECT
    INJECT = fn


def _rebuild_inject() -> None:
    entries = (
        [(_INJECT_BASE, True)] if _INJECT_BASE is not None else []
    ) + list(_INJECT_STACK)
    start = 0
    for i, (_fn, comp) in enumerate(entries):
        if not comp:
            start = i  # a shadowing scope hides everything before it
    chain = [fn for fn, _comp in entries[start:]]
    if not chain:
        _set_inject(None)
    elif len(chain) == 1:
        _set_inject(chain[0])
    else:
        def chained(ctx, attempt, _fns=tuple(chain)):
            for f in _fns:
                f(ctx, attempt)
        _set_inject(chained)


@contextlib.contextmanager
def inject_scope(injector: Callable[[dict, int], None], *,
                 compose: bool = True):
    """Install a fault injector for the scope (thread-safe, re-entrant).

    With ``compose`` (the default) the injectors of enclosing scopes keep
    running first, then this one; ``compose=False`` shadows them for the
    scope.  Each exit removes only its own layer; a direct ``INJECT``
    assignment made before the first scope is restored when the last
    one exits, even if a body raises."""
    entry = [injector, bool(compose)]  # a list: a unique identity per enter
    global _INJECT_BASE
    with _INJECT_LOCK:
        if not _INJECT_STACK:
            _INJECT_BASE = INJECT
        _INJECT_STACK.append(entry)
        _rebuild_inject()
    try:
        yield injector
    finally:
        with _INJECT_LOCK:
            for i in range(len(_INJECT_STACK) - 1, -1, -1):
                if _INJECT_STACK[i] is entry:
                    del _INJECT_STACK[i]
                    break
            if not _INJECT_STACK:
                _set_inject(_INJECT_BASE)
                _INJECT_BASE = None
            else:
                _rebuild_inject()


def seeded_injector(
    seed: int,
    *,
    transient_rate: float = 0.25,
    oom_rate: float = 0.15,
    what: str | None = None,
) -> Callable[[dict, int], None]:
    """A deterministic randomized fault schedule for ``inject_scope``.

    Each decision is a hash of ``(seed, the ctx's what, stage, engine,
    capacity, lanes, attempt)``, not a shared RNG stream, so one seed
    gives one fault plan however launches interleave, and the JAX
    package's injector with the same seed gives the same plan.  First
    attempts fail transiently at ``transient_rate`` (the retries then
    succeed); first attempts of more than one lane run out of memory at
    ``oom_rate`` on top.  ``what`` restricts the schedule to launch
    sites whose ctx ``what`` starts with it; without it the durable-write
    seams (``store.``, ``ledger.``) are skipped."""

    def _roll(ctx: Mapping, attempt: int) -> float:
        key = "|".join((
            str(seed), str(ctx.get("what")), str(ctx.get("stage")),
            str(ctx.get("engine")), str(ctx.get("capacity")),
            str(ctx.get("lanes")), str(attempt),
        ))
        h = hashlib.sha256(key.encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def inject(ctx, attempt):
        w = str(ctx.get("what") or "")
        if what is not None and not w.startswith(what):
            return
        if what is None and w.startswith(("store.", "ledger.")):
            return  # write seams fault only when targeted explicitly
        if attempt != 0:
            return  # retries always succeed: the plan tests recovery
        r = _roll(ctx, attempt)
        if r < transient_rate:
            raise RuntimeError(
                "INTERNAL: injected transient fault (seeded_injector "
                f"seed={seed})"
            )
        if r < transient_rate + oom_rate and int(ctx.get("lanes") or 0) > 1:
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: injected OOM (seeded_injector "
                f"seed={seed})"
            )

    return inject


#: launch-wall EWMA (record_launch_seconds / launch_seconds_ewma): the
#: smoothed full-size launch wall time.  None until a launch is recorded.
_LAUNCH_EWMA_ALPHA = 0.2
_launch_ewma_s: float | None = None
_retry_launch_count = 0
_launch_ewma_lock = threading.Lock()


def record_launch_seconds(seconds: float, *, retry: bool = False) -> None:
    """Fold one device launch's wall clock into the process-wide launch
    EWMA.  ``retry=True`` marks a reduced-size (OOM-halved or spill
    retry) launch: it is counted (``retry_launch_count``) but kept out of
    the baseline."""
    global _launch_ewma_s, _retry_launch_count
    with _launch_ewma_lock:
        if retry:
            _retry_launch_count += 1
            return
        if _launch_ewma_s is None:
            _launch_ewma_s = float(seconds)
        else:
            _launch_ewma_s = (
                (1 - _LAUNCH_EWMA_ALPHA) * _launch_ewma_s
                + _LAUNCH_EWMA_ALPHA * float(seconds)
            )


def launch_seconds_ewma() -> float | None:
    """The smoothed per-launch wall clock of full-size launches (None
    before any launch)."""
    with _launch_ewma_lock:
        return _launch_ewma_s


def retry_launch_count() -> int:
    """How many reduced-size launches were kept out of the EWMA."""
    with _launch_ewma_lock:
        return _retry_launch_count


# ---------------------------------------------------------------------------
# OOM spill policy: free device memory before shrinking the work
# ---------------------------------------------------------------------------

#: registered spillers, called in order by try_oom_spill.  A spiller
#: takes the launch ctx and returns truthy when it freed something.
_OOM_SPILLERS: list[Callable[[Mapping], object]] = []
_OOM_SPILLERS_LOCK = threading.Lock()


def register_oom_spiller(fn: Callable[[Mapping], object]) -> None:
    """Register a device-memory spiller for the OOM policy (idempotent
    per function object)."""
    with _OOM_SPILLERS_LOCK:
        if fn not in _OOM_SPILLERS:
            _OOM_SPILLERS.append(fn)


def unregister_oom_spiller(fn: Callable[[Mapping], object]) -> None:
    with _OOM_SPILLERS_LOCK:
        if fn in _OOM_SPILLERS:
            _OOM_SPILLERS.remove(fn)


def try_oom_spill(ctx: Mapping | None = None) -> bool:
    """The OOM ladder's first rung: before halving the sub-batch, ask the
    registered spillers to free device memory so that the same launch can
    retry at full size.  Returns True iff any spiller freed something.
    A spiller that raises is skipped: halving still backstops it."""
    ctx = dict(ctx or {})
    with _OOM_SPILLERS_LOCK:
        spillers = list(_OOM_SPILLERS)
    freed = False
    for fn in spillers:
        try:
            freed = bool(fn(ctx)) or freed
        except Exception:  # noqa: BLE001 — see docstring
            continue
    if freed:
        # mirrors as jepsen_tpu_fault_oom_spill_total
        obs.counter("fault.oom.spill", what=str(ctx.get("what") or "launch"))
    return freed


def release(e: BaseException) -> None:
    """Drop the frames the tracebacks of ``e`` and of its ``__cause__``
    chain hold, and with them the locals of the failed attempt: on the
    card those are the tensors of the launch that ran out of memory,
    which the caching allocator cannot reuse while a traceback keeps
    them alive.  Frames still executing are left as they are."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if e.__traceback__ is not None:
            traceback.clear_frames(e.__traceback__)
            e.__traceback__ = None
        e = e.__cause__


#: substrings that mark an exception as out-of-memory (halve, don't
#: retry the same shape).  "CUDA out of memory" is the card's.
OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "OOM",
    "Attempting to allocate",
)

#: substrings that mark an exception as transient (retry with backoff).
TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "ABORTED",
    "INTERNAL",
    "DEADLINE_EXCEEDED",
    "worker process crashed",
    "restarted",
    "Socket closed",
    "connection reset",
    "failed to connect",
    "Unable to initialize backend",
)

#: the CUDA runtime's messages of sticky errors: the context is
#: poisoned, every later launch fails, so nothing may retry or degrade
#: around them.
STICKY_MARKERS = (
    "illegal memory access",
    "an illegal instruction",
    "unspecified launch failure",
    "device-side assert",
    "uncorrectable ECC error",
    "misaligned address",
    "invalid program counter",
)

#: the cudaError_t code of an out-of-memory, as the kernels' wrappers
#: report it ("CUDA error <rc>"); every other code (a sticky error such
#: as 700, an illegal address, or 719, a launch failure, or a launch the
#: code got wrong) is not a fault to retry.
CUDA_OOM_CODE = 2  # cudaErrorMemoryAllocation

_CUDA_RC = re.compile(r"CUDA error (\d+)")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def describe(e: BaseException) -> str:
    """One-line, bounded rendering of an exception for ``cause``
    strings."""
    s = f"{type(e).__name__}: {e}"
    return s if len(s) <= 300 else s[:297] + "..."


def error_kind(e: BaseException) -> str | None:
    """Classify ``e`` for the launch retry policy (module doc).

    Only RuntimeError/OSError lineages qualify (``torch.OutOfMemoryError``
    and the JAX package's XlaRuntimeError subclass RuntimeError), so a
    ValueError from bad arguments is never retried or degraded.  A
    sticky CUDA error is ``None`` whatever else its message says."""
    if not isinstance(e, (RuntimeError, OSError)):
        return None
    msg = f"{type(e).__name__}: {e}"
    rc = _CUDA_RC.search(msg)
    if rc is not None:
        return "oom" if int(rc.group(1)) == CUDA_OOM_CODE else None
    if any(m in msg for m in STICKY_MARKERS):
        return None
    if type(e).__name__ == "OutOfMemoryError":
        return "oom"
    if any(m in msg for m in OOM_MARKERS):
        return "oom"
    if any(m in msg for m in TRANSIENT_MARKERS):
        return "transient"
    return None


class LaunchFailure(Exception):
    """A device launch failed under the retry policy.

    ``kind`` is ``"oom"`` (raised at once: retrying the same shape would
    run out again; the caller halves the work) or ``"transient"`` (the
    backoff retries are spent; the caller degrades the affected lanes).
    ``cause`` is the final underlying exception."""

    def __init__(self, kind: str, cause: BaseException, what: str = "launch"):
        self.kind = kind
        self.cause = cause
        self.what = what
        super().__init__(f"{what} failed ({kind}): {describe(cause)}")


def call_with_retry(
    fn: Callable,
    ctx: Mapping | None = None,
    *,
    retries: int | None = None,
    base_s: float | None = None,
    max_s: float | None = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Run one device launch under the retry policy (module doc).

    ``ctx`` annotates the injection hook: ``what`` (the launch site),
    ``stage``/``engine``/``capacity``/``lanes`` (whatever the call site
    knows).  Returns ``fn()``'s value; raises ``LaunchFailure`` on an OOM
    or when the retries are spent, and re-raises unclassified
    exceptions untouched."""
    ctx = dict(ctx or {})
    what = str(ctx.get("what") or "launch")
    retries = _env_int("JEPSEN_TPU_LAUNCH_RETRIES", 3) if retries is None else retries
    base_s = _env_float("JEPSEN_TPU_RETRY_BASE_S", 0.25) if base_s is None else base_s
    max_s = _env_float("JEPSEN_TPU_RETRY_MAX_S", 8.0) if max_s is None else max_s
    attempt = 0
    while True:
        try:
            hook = INJECT
            if hook is not None:
                hook(ctx, attempt)
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            kind = error_kind(e)
            if kind is None:
                raise
            # live fault series, labeled by kind and launch site (a retry
            # needs none: the counter below mirrors by name)
            if kind == "oom":
                _metrics.inc("fault.launch_failures", kind="oom", what=what)
                raise LaunchFailure("oom", e, what) from e
            if attempt >= retries:
                _metrics.inc("fault.launch_failures", kind="transient",
                             what=what)
                raise LaunchFailure("transient", e, what) from e
            delay = min(max_s, base_s * (2 ** attempt))
            attempt += 1
            obs.counter(
                "fault.launch.retry", what=what, attempt=attempt,
                delay_s=round(delay, 3), error=describe(e),
                **{k: ctx[k] for k in ("stage", "engine", "capacity", "lanes")
                   if k in ctx},
            )
            sleep(delay)


class Deadline:
    """A wall-clock check budget, shared by every checker in a compose.

    Constructed once (``checker.resolve_opts`` wraps the raw
    ``"check-deadline"`` seconds value exactly once per check) so that
    parallel checkers and nested engines all see one budget."""

    __slots__ = ("seconds", "_t0")

    def __init__(self, seconds: float, *, start: float | None = None):
        self.seconds = float(seconds)
        self._t0 = time.monotonic() if start is None else start

    @classmethod
    def coerce(cls, v) -> "Deadline | None":
        """None passes through; a Deadline passes through; a number
        becomes a fresh Deadline starting now."""
        if v is None or isinstance(v, cls):
            return v
        return cls(float(v))

    def remaining(self) -> float:
        return self.seconds - (time.monotonic() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clamp(self, timeout: float) -> float:
        """Bound a wait by the budget: min(timeout, remaining), floored
        at 0."""
        return max(0.0, min(timeout, self.remaining()))

    def __repr__(self):
        return f"Deadline({self.seconds}s, {self.remaining():.3f}s left)"
