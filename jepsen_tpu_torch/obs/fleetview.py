"""The fleet flight recorder: one trace, one timeline, one metrics plane.

The port's copy of the JAX package's ``obs.fleetview``, with equal text
and documents.  A fleet router (``serve.fleet``) makes the checker a
multi-process fleet, but every observability surface is per-process:
each replica has its own recorder stream, its own Prometheus registry,
its own SLO burn engine.  This module is the cross-process glue:

  * **Metrics federation** — ``federate()`` takes the router process's
    own exposition plus one raw scrape per replica and re-exports every
    replica series with a ``replica=`` label, alongside
    ``jepsen_tpu_fleet_*`` rollups: counters and histogram buckets SUM
    across replicas (a fleet processed the union of the work), gauges
    are deliberately NOT summed (two replicas at queue depth 3 are not
    a fleet at depth 6 in any operationally useful sense — the labeled
    per-replica series carry them instead).
  * **Fleet-level SLO burn** — ``FederatedRegistry`` is a read-only,
    ``obs.metrics.Registry``-shaped view (``get`` /
    ``histogram_buckets``) over parsed replica scrapes plus an optional
    live base registry, so the stock ``serve.slo.SloEngine`` runs
    UNCHANGED on fleet-aggregate bad/total counts: a one-replica
    brownout burns the fleet budget proportionally to its traffic share
    instead of only tripping that replica's local alert.
  * **Timeline merging** — ``merge_trace_events()`` clock-aligns N
    recorder streams on their ``meta`` t0-epoch headers
    (obs.trace.align_streams) and emits ONE Perfetto document: one
    process group per stream (router + each replica, named and
    pid-renumbered so same-host pids can't collide), counter tracks per
    replica, and a request's router-side ``fleet.route`` span linked to
    its replica-side ``serve.request`` span by the shared trace id.

Stdlib-only, like the rest of ``obs`` — the web layer serves
``federate()`` output from ``GET /metrics`` when a fleet is mounted.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping

from jepsen_tpu_torch.obs import metrics as _metrics
from jepsen_tpu_torch.obs.trace import align_streams, to_trace_events

__all__ = [
    "FederatedRegistry",
    "FleetSlo",
    "federate",
    "merge_trace_events",
    "parse_exposition",
]

#: fleet rollup series are the original family with this prefix swapped
#: in for ``jepsen_tpu_`` (``jepsen_tpu_serve_submitted_total`` →
#: ``jepsen_tpu_fleet_serve_submitted_total``).
ROLLUP_PREFIX = "jepsen_tpu_fleet_"


# ---------------------------------------------------------------------------
# Prometheus text-exposition parsing (the inverse of metrics.render())
# ---------------------------------------------------------------------------


def _parse_labels(s: str) -> tuple[tuple[str, str], ...]:
    """``k="v",k2="v2"`` → label pairs, undoing ``_escape_label``."""
    out: list[tuple[str, str]] = []
    i, n = 0, len(s)
    while i < n:
        eq = s.index("=", i)
        key = s[i:eq].strip().strip(",")
        i = eq + 1
        if i >= n or s[i] != '"':
            raise ValueError(f"malformed label value at {s[i:]!r}")
        i += 1
        buf: list[str] = []
        while i < n:
            c = s[i]
            if c == "\\" and i + 1 < n:
                nxt = s[i + 1]
                buf.append({"n": "\n"}.get(nxt, nxt))
                i += 2
                continue
            if c == '"':
                i += 1
                break
            buf.append(c)
            i += 1
        out.append((key, "".join(buf)))
        while i < n and s[i] in ", ":
            i += 1
    return tuple(out)


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text format 0.0.4 (the subset
    ``obs.metrics.Registry.render`` emits) into ``{"types": {family:
    kind}, "samples": [(name, labels, value), ...]}`` with labels as a
    tuple of pairs in source order.  Unparseable lines are counted in
    ``"skipped"``, not fatal — a half-written scrape from a dying
    replica must not take the federation down with it."""
    types: dict[str, str] = {}
    samples: list[tuple[str, tuple, float]] = []
    skipped = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                lbl, _, val = rest.rpartition("}")
                labels = _parse_labels(lbl)
            else:
                name, _, val = line.partition(" ")
                labels = ()
            samples.append((name.strip(), labels, float(val)))
        except (ValueError, IndexError):
            skipped += 1
    return {"types": types, "samples": samples, "skipped": skipped}


def _family_of(name: str, types: Mapping[str, str]) -> tuple[str, str]:
    """``(family, kind)`` for one sample name.  Histogram samples carry
    ``_bucket``/``_sum``/``_count`` suffixes over a base-family TYPE;
    counter TYPE lines already include the ``_total`` suffix."""
    if name in types:
        return name, types[name]
    for suf in ("_bucket", "_sum", "_count"):
        if name.endswith(suf):
            base = name[: -len(suf)]
            if types.get(base) == "histogram":
                return base, "histogram"
    if name.endswith("_total"):
        return name, "counter"
    return name, types.get(name, "gauge")


def _rollup_name(name: str) -> str:
    base = (name[len(_metrics._PREFIX):]
            if name.startswith(_metrics._PREFIX) else name)
    return ROLLUP_PREFIX + base


def _num(v: float) -> str:
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# Metrics federation (router GET /metrics)
# ---------------------------------------------------------------------------


def federate(base_text: str, scrapes: Mapping[str, str], *,
             errors: Mapping[str, str] | None = None) -> str:
    """One exposition for the whole fleet.

    ``base_text`` is the router process's own registry render (router
    counters, and — for in-process LocalReplicas — the shared process
    registry their observations already merged into); it passes through
    unlabeled.  ``scrapes`` maps replica name → that replica's raw
    ``GET /metrics`` text; every one of its samples is re-exported with
    a ``replica="<name>"`` label.  On top, ``jepsen_tpu_fleet_*``
    rollups aggregate ACROSS the scrapes: counters sum, histogram
    bucket/sum/count triples sum bucket-wise (what makes a fleet-level
    latency SLO expressible), gauges are not rolled up.  ``errors``
    (replica → reason) marks failed scrapes: the replica gets
    ``jepsen_tpu_fleet_scrape_up{replica=...} 0`` instead of silently
    vanishing from the page."""
    errors = dict(errors or {})
    families: dict[str, dict] = {}   # family -> {"kind": k, "rows": [str]}

    def fam(family: str, kind: str) -> list[str]:
        f = families.get(family)
        if f is None:
            f = families[family] = {"kind": kind, "rows": []}
        return f["rows"]

    base = parse_exposition(base_text)
    for name, labels, value in base["samples"]:
        family, kind = _family_of(name, base["types"])
        fam(family, kind).append(
            f"{name}{_metrics._labels_str(labels)} {_num(value)}")

    # rollup accumulators, keyed on (rollup family, sample suffix,
    # replica-stripped labels)
    roll_counters: dict[tuple, float] = {}
    roll_hists: dict[tuple, float] = {}
    roll_kinds: dict[str, str] = {}

    for rep in sorted(scrapes):
        parsed = parse_exposition(scrapes[rep])
        for name, labels, value in parsed["samples"]:
            family, kind = _family_of(name, parsed["types"])
            labeled = tuple(
                [(k, v) for k, v in labels if k != "replica"]
                + [("replica", rep)])
            # histograms keep le LAST so the bucket rows stay shaped
            # like the registry's own render
            if labels and labels[-1][0] == "le":
                labeled = tuple(
                    [(k, v) for k, v in labeled if k != "le"]
                    + [("le", dict(labels)["le"])])
            fam(family, kind).append(
                f"{name}{_metrics._labels_str(labeled)} {_num(value)}")
            if family.startswith(ROLLUP_PREFIX):
                continue  # a replica that is itself a router: its
                # fleet-level series don't re-roll
            bare = tuple((k, v) for k, v in labels if k != "replica")
            if kind == "counter":
                key = (_rollup_name(family), bare)
                roll_counters[key] = roll_counters.get(key, 0.0) + value
                roll_kinds[_rollup_name(family)] = "counter"
            elif kind == "histogram":
                suffix = name[len(family):]
                key = (_rollup_name(family), suffix, bare)
                roll_hists[key] = roll_hists.get(key, 0.0) + value
                roll_kinds[_rollup_name(family)] = "histogram"
            # gauges: intentionally no rollup (see module docstring)

    for (family, labels), value in sorted(roll_counters.items()):
        fam(family, "counter").append(
            f"{family}{_metrics._labels_str(labels)} {_num(value)}")
    for (family, suffix, labels), value in sorted(roll_hists.items()):
        fam(family, "histogram").append(
            f"{family}{suffix}{_metrics._labels_str(labels)} {_num(value)}")

    up_rows = fam(ROLLUP_PREFIX + "scrape_up", "gauge")
    for rep in sorted(set(scrapes) | set(errors)):
        ok = 0 if rep in errors else 1
        up_rows.append(
            f"{ROLLUP_PREFIX}scrape_up{{replica=\"{rep}\"}} {ok}")
    fam(ROLLUP_PREFIX + "scrape_errors", "gauge").append(
        f"{ROLLUP_PREFIX}scrape_errors {len(errors)}")

    lines: list[str] = []
    for family in sorted(families):
        f = families[family]
        lines.append(f"# TYPE {family} {f['kind']}")
        lines.extend(f["rows"])
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Fleet-level SLO burn: a registry-shaped view over replica scrapes
# ---------------------------------------------------------------------------


class FederatedRegistry:
    """A read-only ``obs.metrics.Registry`` lookalike whose series are
    the SUM across parsed per-replica scrapes (plus an optional live
    base registry for the in-process side).  Only the two methods the
    SLO burn engine reads are implemented — ``get`` and
    ``histogram_buckets`` — which is exactly what lets the stock
    ``SloEngine`` compute FLEET burn with zero changes: its windowed
    good/bad deltas ride on aggregated cumulative counts.

    ``get`` on a gauge returns the MEAN across sources (a floor SLO on
    occupancy should read fleet-average capacity use, proportional to
    the brownout's share — the same proportionality rule as the
    bad-count aggregation)."""

    def __init__(self, base=None):
        self._base = base
        self._sources: dict[str, dict] = {}

    def update(self, scrapes: Mapping[str, str]) -> None:
        """Replace the parsed view with fresh raw scrapes (replica name
        → exposition text).  A replica absent from ``scrapes`` drops
        out of the aggregate — a fenced replica stops contributing to
        fleet burn the moment the router stops scraping it."""
        sources: dict[str, dict] = {}
        for rep, text in scrapes.items():
            parsed = parse_exposition(text)
            counters: dict[tuple, float] = {}
            gauges: dict[tuple, float] = {}
            hists: dict[tuple, dict] = {}
            for name, labels, value in parsed["samples"]:
                family, kind = _family_of(name, parsed["types"])
                bare = tuple(sorted(
                    (k, v) for k, v in labels if k not in ("le",)))
                if kind == "counter":
                    counters[(family, bare)] = value
                elif kind == "histogram":
                    h = hists.setdefault(
                        (family, bare),
                        {"le": {}, "sum": 0.0, "count": 0.0})
                    if name.endswith("_bucket"):
                        le = dict(labels).get("le", "+Inf")
                        h["le"][float(le)] = value
                    elif name.endswith("_sum"):
                        h["sum"] = value
                    elif name.endswith("_count"):
                        h["count"] = value
                else:
                    gauges[(family, bare)] = value
            sources[str(rep)] = {
                "counters": counters, "gauges": gauges, "hists": hists,
            }
        self._sources = sources

    def get(self, name: str, **labels):
        prom = _metrics.metric_name(name)
        lk = _metrics._labels_key(labels)
        ckey = (prom if prom.endswith("_total") else prom + "_total", lk)
        csum, hits = 0.0, 0
        gvals: list[float] = []
        for src in self._sources.values():
            if ckey in src["counters"]:
                csum += src["counters"][ckey]
                hits += 1
            elif (prom, lk) in src["gauges"]:
                gvals.append(src["gauges"][(prom, lk)])
        base_v = self._base.get(name, **labels) if self._base else None
        if hits:
            return csum + (float(base_v) if base_v is not None else 0.0)
        if gvals:
            if base_v is not None:
                gvals.append(float(base_v))
            return sum(gvals) / len(gvals)
        return base_v

    def histogram_buckets(self, name: str, **labels) -> dict | None:
        prom = _metrics.metric_name(name)
        lk = _metrics._labels_key(labels)
        bounds: set[float] = set()
        views: list[dict] = []
        for src in self._sources.values():
            h = src["hists"].get((prom, lk))
            if h is not None and h["le"]:
                views.append(h)
                bounds.update(b for b in h["le"] if math.isfinite(b))
        base_h = (self._base.histogram_buckets(name, **labels)
                  if self._base else None)
        if base_h is not None:
            bounds.update(base_h["bounds"])
        if not views and base_h is None:
            return None
        ordered = tuple(sorted(bounds))
        buckets = [0.0] * (len(ordered) + 1)
        total_count, total_sum = 0.0, 0.0
        for h in views:
            # cumulative le rows → per-bucket counts on the union grid
            prev = 0.0
            cum_by_le = dict(sorted(h["le"].items()))
            inf_cum = cum_by_le.get(math.inf, h["count"])
            for i, b in enumerate(ordered):
                cum = cum_by_le.get(b, prev)
                buckets[i] += max(0.0, cum - prev)
                prev = max(prev, cum)
            buckets[-1] += max(0.0, inf_cum - prev)
            total_count += h["count"]
            total_sum += h["sum"]
        if base_h is not None:
            idx = {b: i for i, b in enumerate(ordered)}
            for b, cnt in zip(base_h["bounds"], base_h["buckets"]):
                buckets[idx[b]] += cnt
            buckets[-1] += base_h["buckets"][-1]
            total_count += base_h["count"]
            total_sum += base_h["sum"]
        return {"bounds": ordered, "buckets": buckets,
                "count": total_count, "sum": total_sum}


class FleetSlo:
    """Fleet-level SLO burn: the stock ``serve.slo.SloEngine`` running
    over a ``FederatedRegistry``.  Construct it BEFORE traffic (the
    engine's construction-time baseline is what keeps pre-existing
    cumulative counts from reading as instantaneous burn) and call
    ``evaluate(scrapes)`` with fresh per-replica raw expositions on
    each pass — the router does this from ``alerts()``."""

    def __init__(self, specs=None, *, base_registry=None,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0):
        from jepsen_tpu_torch.serve import slo as _slo  # lazy: obs must not
        # import serve at module load (layering)
        self.registry = FederatedRegistry(base=base_registry)
        self.engine = _slo.SloEngine(
            specs, registry=self.registry,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s)

    def evaluate(self, scrapes: Mapping[str, str], now=None) -> list:
        self.registry.update(scrapes)
        return self.engine.evaluate(now)

    def alerts(self) -> dict:
        return self.engine.alerts()


# ---------------------------------------------------------------------------
# Merged Perfetto timeline (one process group per recorder stream)
# ---------------------------------------------------------------------------


def merge_trace_events(streams: Iterable) -> dict:
    """N recorder streams → one Perfetto document.

    ``streams``: ``(label, events)`` or ``(label, events, skipped)``
    per recorder (the router's plus one per replica).  Each stream is
    clock-aligned on its ``meta`` t0 epoch (``align_streams``), then
    rendered through the stock single-stream converter and rewritten
    into its own process group: a synthetic pid per stream (recorder
    pids can collide across hosts and a dead replica's pid can be
    reused), the process named ``<label> (host, pid N)``, and every
    timestamp shifted by the stream's epoch offset.  Request lanes,
    device lanes, stream lanes, and counter tracks all stay per-stream
    — counter tracks per replica fall out of the process split.  The
    cross-process request story lives in the trace ids: a hop-spanning
    request's ``fleet.route`` (router group) and ``serve.request``
    (replica group) rows share one ``args.trace``, and
    ``otherData.cross_process_traces`` lists them."""
    aligned, info = align_streams(streams)
    out: list[dict] = []
    skipped = 0
    groups = []
    for i, a in enumerate(aligned):
        doc = to_trace_events(a["events"], skipped_lines=a["skipped"])
        pid = i + 1
        meta = a["meta"]
        pname = (f"{a['label']} ({meta.get('host', '?')}, "
                 f"pid {meta.get('pid', '?')})")
        off_us = a["offset_s"] * 1e6
        for row in doc["traceEvents"]:
            row = dict(row)
            row["pid"] = pid
            if row.get("ph") == "M" and row.get("name") == "process_name":
                row["args"] = {"name": pname}
            if "ts" in row:
                row["ts"] = round(row["ts"] + off_us, 1)
            out.append(row)
        out.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                    "args": {"sort_index": i}})
        skipped += a["skipped"]
        groups.append({
            "label": a["label"], "pid": pid, "host": meta.get("host"),
            "recorder_pid": meta.get("pid"),
            "t0": meta.get("t0", meta.get("wall-clock")),
            "offset_s": a["offset_s"],
            "requests": doc["otherData"]["requests"],
            "devices": doc["otherData"]["devices"],
            "streams": doc["otherData"].get("streams", 0),
        })
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "t0": info["t0"],
            "processes": groups,
            "offsets": info["offsets"],
            "missing_t0": info["missing_t0"],
            "cross_process_traces": info["cross_process_traces"],
            "residual_skew_s": info["residual_skew_s"],
            "skew_pairs": info["skew_pairs"],
            "requests": sum(g["requests"] for g in groups),
            "devices": sum(g["devices"] for g in groups),
            "streams": sum(g["streams"] for g in groups),
            "skipped_lines": skipped,
        },
    }
