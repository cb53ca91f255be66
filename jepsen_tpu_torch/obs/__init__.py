"""Telemetry: structured spans, counters and gauges, and verdict
provenance (:mod:`jepsen_tpu_torch.obs.provenance`).

The port's copy of the JAX package's ``obs`` core, with the JAX
package's event names and attribute keys at the same places: every
layer of the port emits through one zero-dependency API —

  * ``span(name, **attrs)``   — a context manager timing a region with
    monotonic wall times; spans nest (the enclosing span becomes the
    ``parent``) and accept late attributes via ``.set(...)``;
  * ``counter(name, n)``      — a monotonically accumulated count;
  * ``gauge(name, value)``    — a point-in-time measurement;
  * ``event(name, **attrs)``  — a bare structured event.

Events stream append-only into ``telemetry.jsonl`` in the active
recording directory (one JSON object per line, readable after a crash;
opening a new recording replaces a prior stream), and on close a
rolled-up ``telemetry.json`` lands next to it: per-phase wall time,
per-checker time and verdict, the ladder's stage table, the critical
path (``obs.summary``, ``obs.critpath``).  ``obs.trace`` exports the
stream as Chrome/Perfetto JSON with one lane per device.

To record a run of the port, wrap any entry point::

    with obs.recording(directory):
        batch.batch_analysis(model, histories)

The API is PROCESS-GLOBAL with a no-op fast path: when no recording is
active, ``span()`` returns a shared singleton and ``counter``/``gauge``
return immediately after one global read, so call sites need no guards
of their own.  A span's time is the host's: a ``ladder.launch`` span
closes when the launch's results are on the host, and no call site
synchronizes the card only to time a span.  Call sites whose sampling
itself costs something (``torch.cuda.memory_allocated``) ask
``observing()`` first.

Trace context: ``new_trace_id()`` mints a trace id; ``capture()``
snapshots the current thread's span context into a picklable ``Ctx``
and ``attach(ctx)`` installs it on another thread, so parent links and
trace ids survive thread hops.  While a trace is attached, every event
carries a top-level ``"trace"`` field.  When ``obs.metrics.MIRROR`` is
on, ``counter``/``gauge`` also land in the process-global Prometheus
registry (``obs.metrics``).

Toggles: the test-map key ``"telemetry?"`` wins (``enabled_for``);
otherwise the env var ``JEPSEN_TPU_TELEMETRY`` (``0``/``false``/``off``
disable), the JAX package's name.  Stdlib only: ``faults``,
``store.durable`` and ``store.checkpoint`` import this package and
must stay importable without torch.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Mapping

from jepsen_tpu_torch.obs import metrics as _metrics
from jepsen_tpu_torch.obs.summary import summarize

__all__ = [
    "ENV_VAR", "Ctx", "Recorder", "active", "attach", "capture", "counter",
    "enabled_for", "env_enabled", "event", "gauge", "new_trace_id",
    "observing", "recording", "span", "span_event", "summarize",
]

ENV_VAR = "JEPSEN_TPU_TELEMETRY"

_FALSY = {"0", "false", "no", "off"}

#: the active recorder; None is the disabled fast path.
_RECORDER: "Recorder | None" = None

_STACK = threading.local()  # per-thread open-span stack (for parent links)


def env_enabled(default: bool = True) -> bool:
    """The JEPSEN_TPU_TELEMETRY env toggle."""
    v = os.environ.get(ENV_VAR)
    if v is None:
        return default
    return v.strip().lower() not in _FALSY


def enabled_for(test: Mapping | None) -> bool:
    """Resolve the toggle for a test map: ``"telemetry?"`` wins, then the
    env var, then the default (on)."""
    if test is not None:
        v = test.get("telemetry?")
        if v is not None:
            return bool(v)
    return env_enabled(True)


def active() -> "Recorder | None":
    """The currently-installed recorder, or None."""
    return _RECORDER


def observing() -> bool:
    """Whether ANY sink is live — a recording or the live metrics
    mirror.  The gate for call sites whose sampling itself costs
    something (e.g. device-memory reads at stage boundaries)."""
    return _RECORDER is not None or _metrics.MIRROR


# ---------------------------------------------------------------------------
# Trace context: ids + the cross-thread/process handoff
# ---------------------------------------------------------------------------


def new_trace_id() -> str:
    """A fresh request trace id (16 hex chars)."""
    return uuid.uuid4().hex[:16]


class Ctx:
    """A picklable span-context snapshot: the parent span name and the
    active trace (one id, or a list of member ids for shared-batch
    work).  Produced by ``capture()``, installed by ``attach()``."""

    __slots__ = ("parent", "trace")

    def __init__(self, parent: str | None = None, trace=None):
        self.parent = parent
        self.trace = trace

    def __repr__(self):
        return f"Ctx(parent={self.parent!r}, trace={self.trace!r})"


def capture(*, trace=None, parent: str | None = None) -> Ctx:
    """Snapshot the current thread's span context for a later
    ``attach()`` on another thread (or after a queue/process hop).
    ``trace``/``parent`` override the captured values — the serving
    layer captures at admission with ``trace=<the request's id>``."""
    if parent is None:
        stack = getattr(_STACK, "spans", None)
        parent = stack[-1].name if stack else getattr(_STACK, "parent", None)
    if trace is None:
        trace = getattr(_STACK, "trace", None)
    return Ctx(parent, trace)


@contextlib.contextmanager
def attach(ctx: Ctx | None = None, *, trace=None, parent: str | None = None):
    """Install a captured context on THIS thread: spans opened inside
    parent to ``ctx.parent`` (when they have no enclosing local span)
    and every event emitted inside carries ``ctx.trace``.  Nests —
    the previous context is restored on exit.  Works with no recorder
    installed (the thread-local write is ~free), so call sites don't
    need their own telemetry guards."""
    if ctx is None:
        ctx = Ctx(parent, trace)
    else:
        ctx = Ctx(
            ctx.parent if parent is None else parent,
            ctx.trace if trace is None else trace,
        )
    prev_parent = getattr(_STACK, "parent", None)
    prev_trace = getattr(_STACK, "trace", None)
    _STACK.parent = ctx.parent
    _STACK.trace = ctx.trace
    try:
        yield ctx
    finally:
        _STACK.parent = prev_parent
        _STACK.trace = prev_trace


def _stamp(ev: dict) -> dict:
    """Attach the thread's active trace (if any) to an outgoing event."""
    tr = getattr(_STACK, "trace", None)
    if tr is not None:
        ev["trace"] = tr
    return ev


def _stamp_thread(ev: dict) -> dict:
    """Attach the emitting thread's id to a span event.  The flight
    analyzer (obs.critpath) nests span instances by interval
    containment WITHIN a thread — a single thread's overlapping spans
    are always genuinely nested, while same-interval spans on
    different threads are concurrent work that must never be charged
    inside each other."""
    ev["thread"] = threading.get_ident()
    return ev


class Recorder:
    """Appends events to ``<dir>/telemetry.jsonl``; ``close()`` rolls them
    up into ``<dir>/telemetry.json``.  Thread-safe (checkers run composed
    in a thread pool).

    A new recording TRUNCATES any previous telemetry.jsonl in the
    directory: the jsonl is the rollup's source of truth, so re-analyzing
    a stored run must replace the stream, not append a second one the
    summarizer would double-count."""

    def __init__(self, directory: Path | str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "telemetry.jsonl"
        self.events: list[dict] = []
        self.summary: dict | None = None
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._fh = open(self.path, "w", encoding="utf-8")
        # t0 is the wall-clock epoch the monotonic event offsets hang off
        # (every event's "t" is seconds after it): epoch = t0 + t.  With
        # pid + host in the header, traces from different processes,
        # machines, and runs can be time-aligned (obs.trace uses it).
        t0 = time.time()
        try:
            host = socket.gethostname()
        except OSError:  # pragma: no cover — hostname lookup failed
            host = "?"
        self.emit({"type": "meta", "version": 1, "wall-clock": t0,
                   "t0": t0, "pid": os.getpid(), "host": host})

    def now(self) -> float:
        """Seconds since the recording opened (monotonic)."""
        return time.monotonic() - self._t0

    def emit(self, ev: dict) -> None:
        line = json.dumps(ev, separators=(",", ":"), default=str)
        with self._lock:
            self.events.append(ev)
            self._fh.write(line + "\n")
            # per-line flush: a process killed by a signal never closes
            # its recorder, and a reader may follow the stream live — a
            # block-buffered stream would trail reality by up to one
            # stdio buffer
            self._fh.flush()

    def close(self) -> dict:
        with self._lock:
            self._fh.flush()
            self._fh.close()
        self.summary = summarize(self.events)
        tmp = self.dir / "telemetry.json.tmp"
        tmp.write_text(json.dumps(self.summary, indent=1, default=str))
        os.replace(tmp, self.dir / "telemetry.json")
        return self.summary


@contextlib.contextmanager
def recording(directory: Path | str | None, *, enabled: bool = True):
    """Install a process-global recorder writing into ``directory``.

    Nesting passes through: when a recording is already active, the inner
    call yields the outer recorder and closes nothing — spans just keep
    accumulating into the one file.  With
    ``enabled=False`` (or no directory) nothing is installed and nothing
    is written.
    """
    global _RECORDER
    if not enabled or directory is None:
        yield _RECORDER
        return
    if _RECORDER is not None:
        yield _RECORDER
        return
    r = Recorder(directory)
    _RECORDER = r
    try:
        yield r
    finally:
        _RECORDER = None
        r.close()


class _NoopSpan:
    """The disabled fast path: one shared instance, no state, no writes."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_r", "name", "attrs", "_start")

    def __init__(self, r: Recorder, name: str, attrs: dict):
        self._r = r
        self.name = name
        self.attrs = attrs
        self._start = 0.0

    def set(self, **attrs):
        """Attach attributes discovered mid-span (verdicts, counts)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = getattr(_STACK, "spans", None)
        if stack is None:
            stack = _STACK.spans = []
        stack.append(self)
        self._start = self._r.now()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = self._r.now() - self._start
        stack = getattr(_STACK, "spans", None)
        if stack and stack[-1] is self:
            stack.pop()
        # parent: the enclosing local span, else an attach()ed handoff
        # context's parent (the cross-thread link)
        parent = stack[-1].name if stack else getattr(_STACK, "parent", None)
        ev: dict[str, Any] = _stamp_thread(_stamp({
            "type": "span", "name": self.name, "t": round(self._start, 6),
            "dur": round(dur, 6),
        }))
        if parent is not None:
            ev["parent"] = parent
        if exc_type is not None:
            ev["err"] = exc_type.__name__
        if self.attrs:
            ev["attrs"] = self.attrs
        self._r.emit(ev)
        return False


def span(name: str, **attrs):
    """Time a region: ``with obs.span("phase.analyze", n=3) as sp: ...``.
    Returns the shared no-op singleton when telemetry is off."""
    r = _RECORDER
    if r is None:
        return NOOP_SPAN
    return _Span(r, name, attrs)


def span_event(name: str, seconds: float, **attrs) -> None:
    """Emit an already-measured span directly (for regions with multiple
    exit paths where a context manager would force restructuring).  The
    event is identical to a ``span()`` one, minus the parent link."""
    r = _RECORDER
    if r is None:
        return
    now = r.now()
    ev: dict[str, Any] = _stamp_thread(_stamp({
        "type": "span", "name": name,
        "t": round(max(0.0, now - seconds), 6), "dur": round(seconds, 6),
    }))
    if attrs:
        ev["attrs"] = attrs
    r.emit(ev)


def counter(name: str, n: int = 1, **attrs) -> None:
    """Accumulate a count (summed per name in the summary).  Also feeds
    the live Prometheus registry when its mirror is on — by NAME only
    (attrs would be unbounded label cardinality)."""
    r = _RECORDER
    if _metrics.MIRROR:
        _metrics.REGISTRY.inc(name, n)
    if r is None:
        return
    ev: dict[str, Any] = _stamp({"type": "counter", "name": name,
                                 "t": round(r.now(), 6), "n": n})
    if attrs:
        ev["attrs"] = attrs
    r.emit(ev)


def gauge(name: str, value, **attrs) -> None:
    """Record a point-in-time value (last write per name wins in the
    summary; every sample stays in the JSONL).  Numeric values also
    feed the live Prometheus registry when its mirror is on."""
    r = _RECORDER
    if _metrics.MIRROR:
        _metrics.REGISTRY.set(name, value)
    if r is None:
        return
    ev: dict[str, Any] = _stamp({"type": "gauge", "name": name,
                                 "t": round(r.now(), 6), "value": value})
    if attrs:
        ev["attrs"] = attrs
    r.emit(ev)


def event(name: str, **attrs) -> None:
    """A bare structured event (kept in the JSONL, not summarized)."""
    r = _RECORDER
    if r is None:
        return
    ev: dict[str, Any] = _stamp({"type": "event", "name": name,
                                 "t": round(r.now(), 6)})
    if attrs:
        ev["attrs"] = attrs
    r.emit(ev)
