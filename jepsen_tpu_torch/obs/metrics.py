"""Process-global live metrics: the service-level counterpart of a run's
``telemetry.jsonl``.

The port's copy of the JAX package's ``obs.metrics``.  A recording
observes one run and dies with it; a serving process needs metrics that
live as long as the process and can be scraped while requests are in
flight.  This module is that registry: counters, gauges and
fixed-bucket histograms, rendered as Prometheus text exposition
(:func:`render`, byte for byte the JAX package's for the same calls).

Two feeds populate it:

  * the **obs mirror**: when ``MIRROR`` is on (:func:`enable_mirror`),
    every ``obs.counter``/``obs.gauge`` call also lands here under its
    event name (``frontier.spill_rows`` →
    ``jepsen_tpu_frontier_spill_rows_total``), so the fault, retry,
    spill and durable-record counters the port emits surface with no
    extra call sites;
  * **explicit calls** (:func:`inc`, :func:`set_gauge`, :func:`observe`)
    for what spans cannot mirror: latency histograms such as the
    streaming checker's ``serve.stream_detect_latency_seconds``, and the
    ``frontier.undecidable`` count (events do not mirror).  They are
    gated on the same flag, so a library user who never serves pays
    nothing.

Metric names keep the JAX package's ``jepsen_tpu_`` prefix, so one
scrape configuration reads either package.  Stdlib only: ``obs``,
``faults`` and ``store.durable`` import this module and must stay
importable without torch.  Everything is thread-safe; label sets are
expected to be tiny (verdict, fault kind), never unbounded (no trace
ids or error strings as labels).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Mapping

__all__ = [
    "LATENCY_BUCKETS", "MIRROR", "REGISTRY", "Registry", "enable_mirror",
    "inc", "metric_name", "observe", "render", "set_gauge",
]

#: whether the live registry is fed at all (see module doc).  One module
#: attribute read on the obs fast path when everything is off.
MIRROR = False

#: default histogram bounds: request latencies from sub-ms admission
#: waits to multi-minute ladder runs.  +Inf is implicit.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "jepsen_tpu_"


def metric_name(name: str) -> str:
    """An obs event name as a Prometheus metric name:
    ``serve.queue_depth`` → ``jepsen_tpu_serve_queue_depth``."""
    n = _NAME_RE.sub("_", str(name))
    if not n.startswith(_PREFIX):
        n = _PREFIX + n
    return n


def _escape_label(v) -> str:
    return (
        str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _labels_key(labels: Mapping) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labels_str(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


class Registry:
    """Thread-safe counters / gauges / histograms, keyed on
    ``(name, sorted-label-pairs)``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        # (name, labels) -> {"bounds": tuple, "buckets": [int]*len+1,
        #                    "sum": float, "count": int}
        self._hists: dict[tuple[str, tuple], dict] = {}

    def inc(self, name: str, n: float = 1, **labels) -> None:
        key = (metric_name(name), _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def set(self, name: str, value, **labels) -> None:
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            return  # gauges mirror arbitrary obs values; only numbers scrape
        key = (metric_name(name), _labels_key(labels))
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, value: float, *, buckets=LATENCY_BUCKETS,
                **labels) -> None:
        key = (metric_name(name), _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = {
                    "bounds": tuple(buckets),
                    "buckets": [0] * (len(buckets) + 1),
                    "sum": 0.0, "count": 0,
                }
            i = 0
            for i, b in enumerate(h["bounds"]):
                if value <= b:
                    break
            else:
                i = len(h["bounds"])
            h["buckets"][i] += 1
            h["sum"] += value
            h["count"] += 1

    def remove(self, name: str, **labels) -> None:
        """Drop one series (all three families) so a stale value stops
        rendering — used when a publisher's source no longer carries a
        previously-exported label set."""
        key = (metric_name(name), _labels_key(labels))
        with self._lock:
            self._counters.pop(key, None)
            self._gauges.pop(key, None)
            self._hists.pop(key, None)

    def get(self, name: str, **labels):
        """A counter or gauge's current value; None when the series
        doesn't exist."""
        key = (metric_name(name), _labels_key(labels))
        with self._lock:
            if key in self._counters:
                return self._counters[key]
            return self._gauges.get(key)

    def histogram(self, name: str, **labels) -> dict | None:
        key = (metric_name(name), _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            return None if h is None else {
                "count": h["count"], "sum": h["sum"],
            }

    def histogram_buckets(self, name: str, **labels) -> dict | None:
        """The full bucket view (bounds + per-bucket counts + count/sum)
        — what splits a latency histogram into good/bad at a
        threshold.  None when the series doesn't exist."""
        key = (metric_name(name), _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            return None if h is None else {
                "bounds": tuple(h["bounds"]),
                "buckets": list(h["buckets"]),
                "count": h["count"], "sum": h["sum"],
            }

    def snapshot(self) -> dict:
        """A JSONable dump: {"counters": {...}, "gauges": {...},
        "histograms": {name: {"count", "sum", "mean"}}}."""
        with self._lock:
            out = {
                "counters": {
                    k + _labels_str(lk): v
                    for (k, lk), v in sorted(self._counters.items())
                },
                "gauges": {
                    k + _labels_str(lk): v
                    for (k, lk), v in sorted(self._gauges.items())
                },
                "histograms": {
                    k + _labels_str(lk): {
                        "count": h["count"], "sum": round(h["sum"], 6),
                        "mean": round(h["sum"] / h["count"], 6)
                        if h["count"] else None,
                    }
                    for (k, lk), h in sorted(self._hists.items())
                },
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def render(self) -> str:
        """Prometheus text exposition format (0.0.4): counters get a
        ``_total`` suffix, histograms the ``_bucket``/``_sum``/``_count``
        triple with cumulative ``le`` buckets."""
        lines: list[str] = []
        with self._lock:
            by_family: dict[str, list[str]] = {}

            def fam(name: str, kind: str) -> list[str]:
                rows = by_family.get(name)
                if rows is None:
                    rows = by_family[name] = [f"# TYPE {name} {kind}"]
                return rows

            for (name, lk), v in sorted(self._counters.items()):
                n = name if name.endswith("_total") else name + "_total"
                fam(n, "counter").append(f"{n}{_labels_str(lk)} {_num(v)}")
            for (name, lk), v in sorted(self._gauges.items()):
                fam(name, "gauge").append(f"{name}{_labels_str(lk)} {_num(v)}")
            for (name, lk), h in sorted(self._hists.items()):
                rows = fam(name, "histogram")
                cum = 0
                for b, cnt in zip(h["bounds"], h["buckets"]):
                    cum += cnt
                    lb = _labels_str(lk + (("le", _num(b)),))
                    rows.append(f"{name}_bucket{lb} {cum}")
                cum += h["buckets"][-1]
                lb = _labels_str(lk + (("le", "+Inf"),))
                rows.append(f"{name}_bucket{lb} {cum}")
                rows.append(f"{name}_sum{_labels_str(lk)} {_num(h['sum'])}")
                rows.append(f"{name}_count{_labels_str(lk)} {h['count']}")
            for name in sorted(by_family):
                lines.extend(by_family[name])
        return "\n".join(lines) + ("\n" if lines else "")


def _num(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


#: the process-global registry :func:`render` renders.
REGISTRY = Registry()


def enable_mirror(on: bool = True) -> None:
    """Turn the live registry's feeds on (module doc).  Idempotent; a
    serving process flips it at start, and tests that flip it turn it
    off again before they return."""
    global MIRROR
    MIRROR = bool(on)


def inc(name: str, n: float = 1, **labels) -> None:
    """Explicit labeled counter; no-op unless the registry is enabled."""
    if MIRROR:
        REGISTRY.inc(name, n, **labels)


def set_gauge(name: str, value, **labels) -> None:
    if MIRROR:
        REGISTRY.set(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    """Explicit histogram observation (latencies, ratios); no-op unless
    the registry is enabled."""
    if MIRROR:
        REGISTRY.observe(name, value, **labels)


def render() -> str:
    return REGISTRY.render()
