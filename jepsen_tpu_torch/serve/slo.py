"""Live SLO burn-rate engine: declarative objectives evaluated
continuously from the process metrics registry.

The port of the JAX package's ``serve.slo`` (stdlib only, on the
port's ``obs.metrics``).

An SLO here is a JSON-able spec dict; the engine samples the live
registry (``jepsen_tpu_torch.obs.metrics``), keeps a bounded ring of
``(timestamp, per-slo cumulative good/bad counts)`` samples, and
computes **burn rates** over two windows — fast (default 5 min) and
slow (default 1 h): ``burn = bad_fraction / error_budget`` where the
budget is ``1 − target``.  Burn 1.0 means eating the budget exactly as
fast as allowed; an alert FIRES when BOTH windows exceed the spec's
``burn_threshold`` (the classic multi-window rule: the fast window
catches the breach quickly, the slow window keeps one spike from
paging).  With less history than a window, the window degrades to
"since the oldest sample" — a young process alerts on sustained
breaches without waiting an hour.

Spec kinds:

  * ``latency`` — a latency histogram (``metric`` + ``labels``) with
    ``threshold_s`` and ``target`` (fraction of requests that must be
    at or under the threshold; 0.5 = a p50 objective, 0.95 = p95).
    Bad events are histogram observations above the FIRST bucket bound
    at/above ``threshold_s`` — a threshold between bounds snaps UP
    (conservative toward silence; align thresholds with
    ``metrics.LATENCY_BUCKETS`` for exact semantics).
  * ``ratio`` — two counters: ``bad`` over ``total`` events must stay
    under ``1 − target`` (e.g. queue-deadline expiries over
    submissions: the batch deadline-hit rate).
  * ``gauge_floor`` — a gauge sampled per evaluation must stay at or
    above ``floor``; each evaluation contributes one good/bad event
    (``target`` bounds the below-floor sample fraction).

Surfaces: the ``serve_slo_burn_rate{slo=,window=}`` gauges +
``serve_slo_alerts`` count and ``SloEngine.alerts()``, which ``web``
serves as ``GET /alerts``.
``CheckService`` evaluates the engine from its scheduler loop (and from
every ``step()``, so step-driven tests are deterministic).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Mapping, Sequence

from jepsen_tpu_torch.obs import metrics

__all__ = ["DEFAULT_SLOS", "SloEngine", "load_specs"]

#: the built-in objectives (conservative: a healthy CPU-backend service
#: must not page).  Override any of them — or add your own — with a
#: ``--slo-file`` JSON list; a spec with the same name replaces the
#: default.
DEFAULT_SLOS: tuple[dict, ...] = (
    {"name": "interactive-p50", "kind": "latency",
     "metric": "serve.class_request_latency_seconds",
     "labels": {"tier": "interactive"},
     "threshold_s": 0.025, "target": 0.50},
    {"name": "interactive-p95", "kind": "latency",
     "metric": "serve.class_request_latency_seconds",
     "labels": {"tier": "interactive"},
     "threshold_s": 0.25, "target": 0.95},
    {"name": "batch-deadline", "kind": "ratio",
     "bad": "serve.expired", "total": "serve.submitted",
     "target": 0.99},
    # Collapse detector, deliberately forgiving: per-rung occupancy
    # legitimately dips on underfull tail rungs, so the floor is low
    # and the target allows 75% of (changed) samples below it — only a
    # sustained occupancy collapse burns budget.
    {"name": "occupancy-floor", "kind": "gauge_floor",
     "metric": "serve.continuous_occupancy",
     "floor": 0.1, "target": 0.25},
)

#: default burn-rate windows (seconds): the multi-window pair.
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0

#: default alert threshold: burning budget faster than allowed.
BURN_THRESHOLD = 1.0

_KINDS = ("latency", "ratio", "gauge_floor")


def load_specs(path: str | Path) -> list[dict]:
    """An ``--slo-file``: a JSON list of spec dicts.  Specs are merged
    OVER the defaults by name (same name replaces; new names append) —
    a file tuning one threshold doesn't silently drop the rest."""
    specs = json.loads(Path(path).read_text(encoding="utf-8"))
    if isinstance(specs, Mapping):
        specs = specs.get("slos", [])
    if not isinstance(specs, list):
        raise ValueError(f"{path}: expected a JSON list of SLO specs")
    merged = {s["name"]: dict(s) for s in DEFAULT_SLOS}
    for s in specs:
        if not isinstance(s, Mapping) or not s.get("name"):
            raise ValueError(f"{path}: every SLO spec needs a 'name'")
        merged[str(s["name"])] = dict(s)
    return list(merged.values())


#: fields a spec must carry per kind — checked at CONSTRUCTION so a
#: typo'd --slo-file fails the service start loudly instead of
#: KeyError-ing inside every evaluation while the pager reads "ok".
_REQUIRED = {
    "latency": ("metric", "threshold_s"),
    "ratio": ("bad", "total"),
    "gauge_floor": ("metric", "floor"),
}


def _validate(spec: Mapping) -> dict:
    s = dict(spec)
    kind = s.get("kind")
    if kind not in _KINDS:
        raise ValueError(
            f"SLO {s.get('name')!r}: unknown kind {kind!r}; expected one "
            f"of {_KINDS}")
    missing = [k for k in _REQUIRED[kind] if s.get(k) is None]
    if missing:
        raise ValueError(
            f"SLO {s.get('name')!r}: kind {kind!r} requires "
            f"{', '.join(missing)}")
    target = float(s.get("target", 0.99))
    if not 0.0 < target < 1.0:
        raise ValueError(
            f"SLO {s.get('name')!r}: target must be in (0, 1), got {target}")
    if kind == "latency":
        thr = float(s["threshold_s"])
        if thr <= 0:
            raise ValueError(
                f"SLO {s.get('name')!r}: threshold_s must be > 0")
        s["threshold_s"] = thr
    if kind == "gauge_floor":
        s["floor"] = float(s["floor"])
    s["target"] = target
    s.setdefault("burn_threshold", BURN_THRESHOLD)
    return s


class _Ring:
    """Bounded sample ring for one engine: (ts, {slo: (bad, total)}).

    Pushes closer than ``coalesce_s`` to the previous sample REPLACE
    it (cumulative counts: the newest supersedes) — a busy scheduler
    evaluating per cycle must not grow the ring past
    ``keep_s / coalesce_s`` entries or make the window scans pay for
    its cycle rate."""

    def __init__(self, keep_s: float, coalesce_s: float = 1.0):
        self.keep_s = keep_s
        self.coalesce_s = coalesce_s
        self.samples: deque[tuple[float, dict]] = deque()

    def push(self, ts: float, counts: dict) -> None:
        if (len(self.samples) > 1
                and ts - self.samples[-1][0] < self.coalesce_s):
            self.samples[-1] = (ts, counts)
        else:
            self.samples.append((ts, counts))
        horizon = ts - self.keep_s
        while len(self.samples) > 2 and self.samples[1][0] < horizon:
            # keep one sample older than the horizon so the slow window
            # always has a baseline to delta against
            self.samples.popleft()

    def window_delta(self, name: str, now: float,
                     window_s: float) -> tuple[float, float]:
        """(bad, total) accumulated inside the window (delta vs the
        newest sample at/older than the window start; degrades to
        since-oldest when history is shorter than the window).  Scans
        from the NEWEST sample backward so the cost is the window's
        sample count, not the ring's."""
        if not self.samples:
            return 0.0, 0.0
        newest = self.samples[-1][1].get(name, (0.0, 0.0))
        base = None
        start = now - window_s
        for ts, counts in reversed(self.samples):
            if ts <= start:
                base = counts.get(name, (0.0, 0.0))
                break
        if base is None:
            base = self.samples[0][1].get(name, (0.0, 0.0))
        return max(0.0, newest[0] - base[0]), max(0.0, newest[1] - base[1])


class SloEngine:
    """Evaluate a set of SLO specs against the live registry.

    Thread-safe: ``evaluate()`` serializes on an internal lock (the
    scheduler loop, ``step()``-driven tests, and a load harness's
    final settle evaluation may all call it); ``alerts()`` reads the
    newest snapshot via a single attribute load of an immutable dict,
    safe from HTTP handler threads without the lock."""

    def __init__(self, specs: Sequence[Mapping] | str | Path | None = None,
                 *, registry: metrics.Registry | None = None,
                 fast_window_s: float = FAST_WINDOW_S,
                 slow_window_s: float = SLOW_WINDOW_S):
        if specs is None:
            specs = DEFAULT_SLOS
        elif isinstance(specs, (str, Path)):
            specs = load_specs(specs)
        self.specs = [_validate(s) for s in specs]
        self.registry = registry if registry is not None else metrics.REGISTRY
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._ring = _Ring(keep_s=self.slow_window_s * 1.25)
        #: serializes evaluate(): ring pushes, gauge-change tracking,
        #: and firing-state transitions are read-modify-write.
        self._eval_lock = threading.Lock()
        #: last raw value seen per gauge_floor spec (sample-on-change:
        #: a gauge HOLDS its last write between batches, and an idle
        #: service re-sampling a stale tail-rung value must not
        #: accumulate it into the burn windows as fresh evidence).
        self._gauge_last: dict[str, float] = {}
        self._firing_since: dict[str, float] = {}
        #: the newest evaluation snapshot (immutable; read by alerts()).
        self._last: dict = {"evaluated_at": None, "slos": []}
        # Baseline sample at construction: cumulative counts that
        # predate the engine (a registry shared with earlier traffic)
        # must not read as in-window burn — only what happens AFTER
        # the engine attaches counts against the windows.
        baseline: dict[str, tuple[float, float]] = {}
        for spec in self.specs:
            c = (self._counts(spec)
                 if spec["kind"] != "gauge_floor" else None)
            baseline[spec["name"]] = c if c is not None else (0.0, 0.0)
        # -inf timestamp: the baseline sorts before any evaluation
        # clock (tests drive evaluate() with their own ``now``) and is
        # only ever the fallback delta base, never evicted.
        self._ring.push(float("-inf"), baseline)

    # -- cumulative counts per spec ------------------------------------

    def _counts(self, spec: Mapping) -> tuple[float, float] | None:
        """Cumulative (bad, total) events for a spec, or None when the
        underlying series doesn't exist yet (no traffic)."""
        kind = spec["kind"]
        if kind == "latency":
            h = self.registry.histogram_buckets(
                spec["metric"], **(spec.get("labels") or {}))
            if h is None:
                return None
            # The histogram can't resolve between bucket bounds, so the
            # effective threshold SNAPS UP to the first bound at/above
            # threshold_s: requests in the bucket containing the
            # threshold count GOOD.  Conservative toward silence —
            # a misaligned spec must never page on a healthy service.
            thr = float(spec["threshold_s"])
            good = 0
            for bound, n in zip(h["bounds"], h["buckets"]):
                good += n
                if bound >= thr - 1e-12:
                    break
            return float(h["count"] - good), float(h["count"])
        if kind == "ratio":
            bad = self.registry.get(spec["bad"]) or 0.0
            total = self.registry.get(spec["total"])
            if total is None:
                return None
            return float(bad), float(total)
        # gauge_floor: one good/bad event per CHANGED sample — a gauge
        # holds its last write, so an unchanged value is no new evidence
        v = self.registry.get(spec["metric"], **(spec.get("labels") or {}))
        if v is None:
            return None
        prev = (self._ring.samples[-1][1].get(spec["name"], (0.0, 0.0))
                if self._ring.samples else (0.0, 0.0))
        last = self._gauge_last.get(spec["name"])
        self._gauge_last[spec["name"]] = float(v)
        if last is not None and float(v) == last:
            return prev
        below = 1.0 if float(v) < float(spec["floor"]) else 0.0
        return prev[0] + below, prev[1] + 1.0

    # -- evaluation -----------------------------------------------------

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Take one sample, recompute every SLO's fast/slow burn rates,
        update the ``serve.slo_burn_rate`` gauges and the alert states,
        and return the per-SLO rows."""
        with self._eval_lock:
            return self._evaluate_locked(now)

    def _evaluate_locked(self, now: float | None) -> list[dict]:
        now = time.monotonic() if now is None else float(now)
        counts: dict[str, tuple[float, float]] = {}
        missing: set[str] = set()
        for spec in self.specs:
            try:
                c = self._counts(spec)
            except Exception:  # noqa: BLE001 — one broken spec must not
                # stop the other objectives from being monitored
                c = None
            if c is None:
                missing.add(spec["name"])
                # carry the previous cumulative forward so a series
                # that appears later deltas from zero, not from junk
                c = (self._ring.samples[-1][1].get(
                    spec["name"], (0.0, 0.0)) if self._ring.samples
                    else (0.0, 0.0))
            counts[spec["name"]] = c
        self._ring.push(now, counts)
        rows: list[dict] = []
        firing = 0
        for spec in self.specs:
            name = spec["name"]
            budget = 1.0 - spec["target"]
            burns = {}
            for window, w_s in (("fast", self.fast_window_s),
                                ("slow", self.slow_window_s)):
                bad, total = self._ring.window_delta(name, now, w_s)
                frac = (bad / total) if total > 0 else 0.0
                burns[window] = round(frac / budget, 4) if budget else 0.0
            alerting = (
                name not in missing
                and burns["fast"] >= spec["burn_threshold"]
                and burns["slow"] >= spec["burn_threshold"]
            )
            if alerting:
                firing += 1
                self._firing_since.setdefault(name, now)
            else:
                self._firing_since.pop(name, None)
            row = {
                "slo": name,
                "kind": spec["kind"],
                "target": spec["target"],
                "budget": round(budget, 6),
                "burn_fast": burns["fast"],
                "burn_slow": burns["slow"],
                "burn_threshold": spec["burn_threshold"],
                "state": "firing" if alerting else (
                    "no-data" if name in missing else "ok"),
            }
            if alerting:
                row["firing_for_s"] = round(
                    now - self._firing_since[name], 3)
            rows.append(row)
            metrics.set_gauge("serve.slo_burn_rate", burns["fast"],
                              slo=name, window="fast")
            metrics.set_gauge("serve.slo_burn_rate", burns["slow"],
                              slo=name, window="slow")
        metrics.set_gauge("serve.slo_alerts", firing)
        self._last = {
            "evaluated_at": now,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "slos": rows,
        }
        return rows

    def alerts(self) -> dict:
        """The ``GET /alerts`` document: currently-firing alerts plus
        the full per-SLO burn table from the newest evaluation."""
        last = self._last
        return {
            "alerts": [r for r in last["slos"] if r["state"] == "firing"],
            "slos": last["slos"],
            "evaluated_at": last["evaluated_at"],
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
        }
