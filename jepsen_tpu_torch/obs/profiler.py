"""A bounded ``torch.profiler`` capture hook for long-lived processes.

A serving process can't be restarted under a profiler every time an
operator wants a device timeline, and an unattended capture left
running fills memory and disk.  This hook wraps the profiler in a
start/stop pair that is:

  * **bounded** — every capture auto-stops after ``max_seconds`` (a
    watchdog timer), so a forgotten start can cost at most one window;
  * **exclusive** — one capture at a time; a second start reports the
    running one instead of corrupting it;
  * **lazy** — torch is imported only when a capture actually starts,
    so mounting the hook costs nothing (web.py serves plain stores
    without dragging in the accelerator stack).

The port's copy of the JAX package's ``obs.profiler``, with the same
bound, exclusivity and status documents.  Driven over HTTP
(``POST /profile/start`` with an optional ``{"seconds": n}`` body,
``POST /profile/stop``, ``GET /profile`` for status).  Captures land in
timestamped subdirectories of ``DIR``; where the JAX package writes an
xplane for TensorBoard, each capture here writes ``trace.json``, a
Chrome trace-event document (load it at ui.perfetto.dev or
chrome://tracing).  What a capture records is fixed by the host
(``capture_config``): where a card exists, the card's kernels, copies
and sets alone (CUPTI's activity is process-wide, so the check
service's kernels launched from its scheduler thread are in it); on a
host without one, the host's torch ops of every thread.
``device_summary`` reads a capture's device kernels and busy share.

One thread owns the profiler: ``torch.profiler.profile`` must be
started and stopped on the same thread, and the hook is started from
one HTTP handler thread and stopped from another, or from its watchdog
timer.  So ``start_trace`` and ``stop_trace`` hand their work to a
dedicated daemon thread and wait for it.  A start is refused, as an
error in its status document, while another ``torch.profiler`` session
runs anywhere in the process, and CUPTI is kept up between captures
(``TEARDOWN_CUPTI=0`` unless the environment sets it): a process that
will be profiled while it serves is best started with that setting, so
that no earlier session of its own tears CUPTI down.  A stop holds the GIL while kineto
processes and writes the capture (PERF.md gives its cost a device
event on an H100): a capture of a busy service is kept short.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
from pathlib import Path

__all__ = ["ProfilerHook", "TRACE_FILE", "capture_config", "device_summary"]

#: The Chrome trace-event file each capture writes into its directory.
TRACE_FILE = "trace.json"

class _Owner:
    """The one thread that starts and stops ``torch.profiler`` captures
    (module doc).  ``call(fn)`` runs ``fn`` there and returns its value,
    or raises what it raised."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.prof = None  # the running torch.profiler.profile
        self.dir: str | None = None  # the running capture's directory

    def _loop(self):
        while True:
            fn, box, done = self._q.get()
            try:
                box["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — handed back
                box["error"] = e
            done.set()

    def call(self, fn):
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="profiler-owner", daemon=True)
                self._thread.start()
        box: dict = {}
        done = threading.Event()
        self._q.put((fn, box, done))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("value")


_OWNER = _Owner()


def capture_config() -> dict:
    """``torch.profiler.profile``'s arguments for a capture: the card's
    activity alone where a card exists, else the host's torch ops of
    every thread (on the owner thread alone they would hold nothing)."""
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig

    if torch.cuda.is_available():
        return {"activities": [ProfilerActivity.CUDA]}
    return {"activities": [ProfilerActivity.CPU],
            "experimental_config": _ExperimentalConfig(
                profile_all_threads=True)}


def _start(log_dir: str) -> None:
    import torch.autograd.profiler as autograd_profiler
    from torch.profiler import profile

    if _OWNER.prof is not None:
        raise RuntimeError("a torch.profiler capture is already running")
    if getattr(autograd_profiler, "_is_profiler_enabled", False):
        raise RuntimeError("another torch.profiler session is running in "
                           "this process")
    # CUPTI stays up between captures: its teardown at a stop and its
    # re-initialisation at the next start would run while the service's
    # threads launch kernels (torch keeps it up under CUDA graphs for a
    # like reason).  An operator's own setting wins.
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    prof = profile(**capture_config())
    prof.start()
    _OWNER.prof, _OWNER.dir = prof, str(log_dir)


def _stop() -> None:
    prof, log_dir = _OWNER.prof, _OWNER.dir
    if prof is None:
        raise RuntimeError("no torch.profiler capture is running")
    _OWNER.prof = _OWNER.dir = None
    prof.stop()  # waits for the card's queued work first
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


def _trace_api():
    """(start_trace, stop_trace) — a seam so tests can drive the hook
    without paying a real profiler capture.  Both run on the profiler's
    owner thread."""
    import torch.profiler  # noqa: F401 — fail here, not on the owner thread

    def start_trace(log_dir):
        _OWNER.call(lambda: _start(log_dir))

    def stop_trace():
        _OWNER.call(_stop)

    return start_trace, stop_trace


#: Chrome trace-event categories of device work in a torch.profiler
#: capture: kernels, copies and sets.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


#: One device event as kineto writes it (libkineto's Chrome trace
#: logger puts ph, cat, name, pid, tid, ts and dur first, in that order,
#: on one line or on several):
#: the fast read of a capture too large to load as one JSON document.
_KINETO_DEVICE_EVENT = re.compile(
    rb'"ph": "X",\s*"cat": "(kernel|gpu_memcpy|gpu_memset)",\s*'
    rb'"name": "((?:[^"\\]|\\.)*)",\s*"pid": [^,]*,\s*"tid": [^,]*,\s*'
    rb'"ts": ([-0-9.eE+]+),\s*"dur": ([-0-9.eE+]+)')


#: Every device event's category, whatever its layout: the pattern's
#: read is used only when it found each of these.
_DEVICE_CAT = re.compile(rb'"cat":\s*"(?:kernel|gpu_memcpy|gpu_memset)"')


def _device_events(data: bytes):
    """``(cat, name, ts_us, dur_us)`` of every device event in a Chrome
    trace: the kineto layout by pattern (a capture of a ladder holds
    ~10^6 events, a gigabyte of JSON), and as JSON where the pattern
    missed any device event."""
    found = [(m.group(1).decode(), json.loads(m.group(2).join((b'"', b'"'))),
              float(m.group(3)), float(m.group(4)))
             for m in _KINETO_DEVICE_EVENT.finditer(data)]
    if found and len(found) == sum(1 for _ in _DEVICE_CAT.finditer(data)):
        return found
    doc = json.loads(data)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [(ev.get("cat"), str(ev.get("name")), float(ev.get("ts") or 0.0),
             float(ev.get("dur") or 0.0))
            for ev in events
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]


def device_summary(trace_path, *, wall_s: float | None = None) -> dict:
    """A capture's device work: launches per kernel name, the summed
    seconds of kernels and copies, their union (``busy_s``: overlapping
    streams counted once) and the busy share of ``wall_s`` (by default
    the span from the first to the last device event)."""
    kernels: dict[str, int] = {}
    spans = []
    for cat, name, t0, dur in _device_events(Path(trace_path).read_bytes()):
        spans.append((t0, t0 + dur))
        if cat == "kernel":
            kernels[name] = kernels.get(name, 0) + 1
    spans.sort()
    sum_us = sum(b - a for a, b in spans)
    busy_us = 0.0
    cur = None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy_us += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy_us += cur[1] - cur[0]
    window_us = (spans[-1][1] - spans[0][0]) if spans else 0.0
    wall = float(wall_s) if wall_s is not None else window_us / 1e6
    return {
        "kernels": dict(sorted(kernels.items())),
        "device_events": len(spans),
        "sum_s": round(sum_us / 1e6, 9),
        "busy_s": round(busy_us / 1e6, 9),
        "wall_s": round(wall, 9),
        "busy_share": round(busy_us / 1e6 / wall, 6) if wall > 0 else None,
    }


class ProfilerHook:
    """One process's profiler control surface (module doc)."""

    def __init__(self, directory: str | Path, max_seconds: float = 120.0):
        self.dir = Path(directory)
        self.max_seconds = float(max_seconds)
        self._lock = threading.Lock()
        self._timer: threading.Timer | None = None
        self._active_dir: str | None = None
        self._gen = 0  # capture generation; stale watchdogs no-op on it
        self._t_start = 0.0
        self._deadline = 0.0

    def status(self) -> dict:
        with self._lock:
            return self._status_locked()

    def _status_locked(self) -> dict:
        out = {
            "profiling": self._active_dir is not None,
            "dir": str(self.dir),
            "max_seconds": self.max_seconds,
        }
        if self._active_dir is not None:
            out["capture_dir"] = self._active_dir
            out["elapsed_s"] = round(time.monotonic() - self._t_start, 3)
            out["auto_stop_in_s"] = round(
                max(0.0, self._deadline - time.monotonic()), 3)
        return out

    def start(self, seconds: float | None = None) -> dict:
        """Start a capture bounded at ``min(seconds, max_seconds)``;
        idempotent-ish: a second start while one is running returns the
        running capture's status with ``"error"`` set."""
        with self._lock:
            if self._active_dir is not None:
                return {**self._status_locked(),
                        "error": "capture already running"}
            bound = self.max_seconds
            if seconds is not None:
                try:
                    bound = min(float(seconds), self.max_seconds)
                except (TypeError, ValueError):
                    return {**self._status_locked(),
                            "error": f"bad seconds value {seconds!r}"}
            bound = max(0.1, bound)
            capture_dir = self.dir / time.strftime("profile-%Y%m%dT%H%M%S")
            try:
                capture_dir.mkdir(parents=True, exist_ok=True)
                start_trace, _stop = _trace_api()
                start_trace(str(capture_dir))
            except Exception as e:  # noqa: BLE001 — surface, don't crash
                return {**self._status_locked(),
                        "error": f"profiler start failed: {e!r}"}
            self._active_dir = str(capture_dir)
            self._gen += 1
            self._t_start = time.monotonic()
            self._deadline = self._t_start + bound
            # The watchdog is pinned to THIS capture's generation: a
            # timer that fires concurrently with a manual stop (cancel()
            # can't recall a callback already blocked on the lock) must
            # not kill the NEXT capture an operator starts meanwhile.
            self._timer = threading.Timer(bound, self.stop,
                                          kwargs={"gen": self._gen})
            self._timer.daemon = True
            self._timer.start()
            out = self._status_locked()
            out["seconds"] = bound
            return out

    def stop(self, gen: int | None = None) -> dict:
        """Stop the running capture; a stop with nothing running is a
        no-op status report.  ``gen`` is the watchdog's capture
        generation — a stale watchdog (its capture already stopped
        manually) no-ops instead of truncating a newer capture."""
        with self._lock:
            if self._active_dir is None:
                return self._status_locked()
            if gen is not None and gen != self._gen:
                return self._status_locked()  # stale watchdog
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            capture_dir = self._active_dir
            elapsed = round(time.monotonic() - self._t_start, 3)
            try:
                _start, stop_trace = _trace_api()
                stop_trace()
            except Exception as e:  # noqa: BLE001 — a failed stop must
                # still clear the state or the hook wedges shut
                self._active_dir = None
                return {**self._status_locked(),
                        "error": f"profiler stop failed: {e!r}",
                        "capture_dir": capture_dir}
            self._active_dir = None
            out = self._status_locked()
            out["stopped"] = {"capture_dir": capture_dir,
                              "elapsed_s": elapsed}
            return out
