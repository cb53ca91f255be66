"""Web UI: browse stored test runs + the check-serving HTTP API.

The port's copy of the JAX package's ``web``, with the same routes,
status codes, JSON bodies and pages; the check API fronts the port's
``serve.CheckService``, whose ladders run on the card.

Mirrors ``jepsen.web`` (reference: jepsen/src/jepsen/web.clj): a tiny HTTP
app over the store directory — a home table of runs colored by validity
(web.clj:25-41,128-158), directory listings and file serving with a
path-traversal guard (web.clj:235-284, 328-333), and zip download of a
whole test directory (web.clj:286-327).  stdlib http.server; no deps.

When a ``jepsen_tpu_torch.serve.CheckService`` is mounted
(``make_server(..., check_service=svc)``) the app also serves the check
API:

  POST /check        submit a history ({"history": [...], "model": ...,
                     "priority", "deadline", "client", "trace_id",
                     "class", "wait", "idempotency_key"}); "class"
                     picks the latency tier ("interactive": the
                     speculative greedy fast path; "batch": the
                     continuous ladder — the default);
                     "idempotency_key" makes resubmission safe: a
                     duplicate submit (retry after a timeout / 429 /
                     503, even across a service restart) attaches to
                     the original request — same id — or returns its
                     settled result instead of re-running the check;
                     202 + request id + trace id, 200 + result with
                     "wait": true, 429 + Retry-After on backpressure
                     (the estimate is computed per latency class)
  GET  /check/<id>   request status / result (includes the trace_id and
                     the per-request "latency" decomposition block)
  GET  /evidence/<id>  the request's verdict-provenance evidence bundle
                     (obs.provenance): decision path, engine resolution,
                     witness, config + machine fingerprint — same id as
                     /check/<id>; audit with tools/evidence.py
  GET  /queue        queue-status JSON incl. per-class queue depths and
                     retry-after EWMAs (the home page shows a panel)
  POST /stream       open an incremental checking stream
                     (checker.streaming).  Body is NDJSON: a header
                     line ({"model": ..., "stream_id": ..., "resume":
                     bool, "client", "trace_id"}), then zero or more op
                     lines, then an optional {"end": true} trailer —
                     one POST can open, feed, and close a whole
                     replayed history.  A single JSON object with an
                     inline "ops" list works too.  Returns the stream
                     status doc: "valid?" goes False/True the MOMENT a
                     verdict exists (verdict-on-violation), honest
                     "unknown" before that.  429 + Retry-After when
                     the stream lane is full — quoted from the stream
                     lane's own session-duration EWMA, never the batch
                     ladder's
  POST /stream/<id>  feed one epoch of ops (NDJSON op lines with an
                     optional leading {"seq": N} offset line, or JSON
                     {"ops": [...], "seq": N}).  "seq" = ops the client
                     already delivered: overlap is dropped (idempotent
                     re-feed after kill/resume), a gap is refused 409
  POST /stream/<id>/close   end of stream: finalize (pending invokes
                     classify as crashed, exactly post-hoc), emit the
                     evidence bundle, return the final result
  GET  /stream/<id>  stream status (ops consumed, settled barriers,
                     verdict + detection metadata once terminal).
                     Streams are replica-sticky (carried device state):
                     the fleet router does NOT front this surface
  GET  /alerts       the live SLO burn-rate engine's alert document
                     (jepsen_tpu_torch.serve.slo): firing alerts + the
                     per-objective fast/slow-window burn table (the
                     home page shows a panel)

When a ``jepsen_tpu_torch.serve.fleet.FleetRouter`` is mounted instead
(``make_server(..., fleet=router)`` / ``jepsen-tpu serve --check
--replicas N``) the SAME check API fronts the whole replica fleet:
submissions route by geometry affinity, 429 re-quotes Retry-After as
the MIN across live replicas, 503 means every replica's breaker is
open, /readyz is 200 while ANY replica can take work, and two admin
endpoints appear:

  GET  /fleet          fleet status: per-replica state/stats + router
                       totals (routed/spilled/fenced/resubmitted/
                       rollouts/parked)
  POST /fleet/rollout  zero-downtime rollout: cycle local replicas
                       through drain → successor (journal replay +
                       resume_drained) → swap; body may name specific
                       replicas ({"names": [...]})

Oversized ``POST /check`` bodies are rejected 413 BEFORE the JSON parse
(``make_server(..., max_request_mb=)`` / ``serve --max-request-mb``) so
one hostile payload can't balloon the process ahead of admission
validation; an open circuit breaker (``serve.health``) rejects 503 with
a Retry-After distinct from the backpressure 429.

Operational endpoints (always mounted):

  GET  /healthz          liveness: 200 while the process serves HTTP
  GET  /readyz           readiness: 200 when a check service is
                         mounted, admitting, and its circuit breaker
                         is not open; 503 (with the reason) otherwise
                         — the probe pair an orchestrator points at a
                         serving pod

Observability endpoints (always mounted):

  GET  /metrics          live Prometheus text (jepsen_tpu_torch.obs.metrics):
                         queue depth, batch occupancy/padding waste,
                         admission + end-to-end latency histograms,
                         fault/retry counters, verdicts by outcome,
                         device-buffer bytes — the home page shows a
                         self-refreshing panel
  GET  /trace/<t>/<ts>   a run's telemetry.jsonl as Chrome/Perfetto
                         trace-event JSON (one lane per request trace
                         id; linked from the run page)
  GET  /perf             the perf trajectory: per-metric history over
                         the perf-regression ledger (obs.regress —
                         bench / loadgen / tier-1-budget records,
                         sparkline + recent values per metric, plus
                         perfwatch compete verdicts); the newest
                         record per kind also rides /metrics as
                         jepsen_tpu_perf_headline{kind,metric} gauges
  GET  /profile          torch.profiler capture-hook status; POST
  POST /profile/start    /profile/start {"seconds": n} and POST
  POST /profile/stop     /profile/stop drive a bounded device-profile
                         capture (serve --profile-dir)

The home/suite run index is cached keyed on store-directory mtimes so
the dashboard stays cheap while the service is under load: validity is
re-read for a run only when its directory's mtime changes (results.json
and run.jepsen land via rename, which bumps it).
"""

from __future__ import annotations

import html
import io
import json
import logging
import math
import mimetypes
import os
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import unquote

from jepsen_tpu_torch import faults, obs, store
from jepsen_tpu_torch.obs import fleetview as obs_fleetview
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import regress as obs_regress
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.obs.summary import _mb

logger = logging.getLogger(__name__)

VALID_COLORS = {True: "#6DB6FE", False: "#FFAA26", "unknown": "#FEB5DA"}

#: run-index caches: full index keyed on the store dir's mtime signature,
#: per-run validity keyed on that run dir's mtime (see run_index).  The
#: lock serializes rebuilds — dashboard requests run on
#: ThreadingHTTPServer threads.
_INDEX_CACHE: dict[str, tuple[tuple, list]] = {}
_VALID_CACHE: dict[str, tuple[int, object]] = {}
_INDEX_LOCK = threading.Lock()


def _valid_of(run_dir: Path):
    """Cheap validity peek: the run.jepsen footer index when present
    (store/format.py — nothing but the footer block is read), else
    results.json's valid? key — the role
    of the reference's PartialMap lazy reads (web.clj:61-94,
    store/format.clj:113-129)."""
    run = run_dir / "run.jepsen"
    if run.exists():
        from jepsen_tpu_torch.store import format as fmt

        try:
            return fmt.read_index(run).get("valid?")
        except (fmt.CorruptFile, OSError):
            pass
    p = run_dir / "results.json"
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text()).get("valid?")
    except Exception:  # noqa: BLE001
        return "unknown"


def run_index(store_dir=None) -> list[tuple[str, str, Path, object]]:
    """(name, timestamp, run_dir, valid?) rows for every stored run,
    cached on mtimes: the home/suite pages used to rescan the store dir
    AND re-open every run's footer/results.json per request — under
    serving load that made the dashboard the most expensive endpoint.
    The full index is reused while the directory tree's mtime signature
    is unchanged; a run's validity is re-read only when its own dir
    mtime moves (artifacts land via rename, which bumps it)."""
    base = store.base_dir({"store-dir": store_dir} if store_dir else None)
    sig: list = []
    entries: list[tuple[str, str, Path, int]] = []
    if base.exists():
        try:
            sig.append(base.stat().st_mtime_ns)
        except OSError:
            pass
        for name, ts, run, mt in store.iter_runs(store_dir=store_dir):
            sig.append((name, ts, mt))
            entries.append((name, ts, run, mt))
    key = str(base)
    with _INDEX_LOCK:
        cached = _INDEX_CACHE.get(key)
        if cached is not None and cached[0] == tuple(sig):
            return cached[1]
        rows = []
        live = set()
        now_ns = time.time_ns()
        for name, ts, run, mt in entries:
            ck = str(run)
            live.add(ck)
            vc = _VALID_CACHE.get(ck)
            if vc is not None and vc[0] == mt:
                v = vc[1]
            else:
                v = _valid_of(run)
                # Don't cache a validity read off a just-modified run
                # dir: a second artifact landing within the same mtime
                # tick would be indistinguishable, baking a stale
                # verdict in forever.  Quiet-for-2s runs cache normally.
                if now_ns - mt > 2_000_000_000:
                    _VALID_CACHE[ck] = (mt, v)
            rows.append((name, ts, run, v))
        # Evict deleted runs on each rebuild so a long-lived server
        # watching a churning store doesn't leak cache entries.  The
        # separator-suffixed prefix keeps a sibling store ("store2")
        # from being evicted by "store"'s rebuilds.
        prefix = key.rstrip(os.sep) + os.sep
        for ck in [k for k in _VALID_CACHE
                   if k.startswith(prefix) and k not in live]:
            del _VALID_CACHE[ck]
        if not entries or now_ns - max(mt for *_e, mt in entries) > 2_000_000_000:
            _INDEX_CACHE[key] = (tuple(sig), rows)
        else:
            # An actively-written run shares the stale-tick hazard at
            # the index level too: keep rebuilding (cheap — quiet runs'
            # validity stays cached) until the store is 2s quiet, and
            # drop any older cached index so its stale sig can't serve.
            _INDEX_CACHE.pop(key, None)
        return rows


def queue_panel_html(service) -> str:
    """The home page's check-service queue-status panel: the process
    totals plus one row per latency class (queue depth and retry-after
    EWMA are PER CLASS — an interactive rejection is quoted in
    fast-path waves, a batch one in ladder batches)."""
    if service is None:
        return ""
    s = service.stats()
    cells = "".join(
        f"<td><b>{html.escape(str(s.get(k)))}</b><br>"
        f"<small>{html.escape(label)}</small></td>"
        for k, label in (
            ("queue_depth", "queued"), ("running", "running"),
            ("submitted", "submitted"), ("completed", "completed"),
            ("rejected", "rejected"), ("expired", "expired"),
            ("batches", "batches"), ("batch_ewma_s", "batch ewma (s)"),
            ("continuous_occupancy", "rung occupancy"),
            ("fastpath_resolved", "fastpath"),
            ("graph_queue_depth", "graphs queued"),
            ("graph_batches", "graph batches"),
        )
    )
    class_rows = ""
    for tier, c in sorted((s.get("classes") or {}).items()):
        class_rows += (
            f"<tr><td>{html.escape(tier)}</td>"
            f"<td>{html.escape(str(c.get('queued')))}</td>"
            f"<td>{html.escape(str(c.get('ewma_s')))}</td>"
            f"<td>{html.escape(str(c.get('retry_after_hint_s')))}</td></tr>"
        )
    placement = s.get("placement") or {}
    return (
        "<h2>check service</h2>"
        "<table style='border:1px solid #ddd'><tr>"
        + cells
        + "</tr></table>"
        "<table style='border:1px solid #ddd;margin-top:6px'>"
        "<tr><th>class</th><th>queued</th><th>cycle ewma (s)</th>"
        "<th>retry-after (s)</th></tr>"
        + class_rows
        + "</table>"
        f"<p>placement: {html.escape(str(placement.get('devices', 1)))} "
        f"device(s){' (lane-sharded)' if placement.get('sharded') else ''}"
        " — <a href='/queue'>queue JSON</a></p>"
    )


def slo_panel_html(service) -> str:
    """The home page's SLO burn-rate panel: one row per objective with
    its fast/slow-window burn and alert state (firing rows red)."""
    if service is None or getattr(service, "slo", None) is None:
        return ""
    doc = service.slo.alerts()
    if not doc["slos"]:
        return ""
    rows = ""
    for r in doc["slos"]:
        color = {"firing": "#FFAA26", "no-data": "#eee"}.get(r["state"], "")
        style = f" style='background:{color}'" if color else ""
        rows += (
            f"<tr{style}><td>{html.escape(r['slo'])}</td>"
            f"<td>{html.escape(r['kind'])}</td>"
            f"<td>{r['target']}</td>"
            f"<td>{r['burn_fast']}</td><td>{r['burn_slow']}</td>"
            f"<td>{html.escape(r['state'])}</td></tr>"
        )
    firing = len(doc["alerts"])
    head = (f"{firing} alert(s) FIRING" if firing else "all objectives ok")
    return (
        "<h2>SLO burn rates</h2>"
        f"<p>{head} — <a href='/alerts'>alerts JSON</a> "
        f"(fast window {doc['fast_window_s']:.0f}s, slow "
        f"{doc['slow_window_s']:.0f}s; burn 1.0 = eating budget exactly "
        "as fast as allowed)</p>"
        "<table style='border:1px solid #ddd'>"
        "<tr><th>slo</th><th>kind</th><th>target</th>"
        "<th>burn (fast)</th><th>burn (slow)</th><th>state</th></tr>"
        + rows + "</table>"
    )


def metrics_panel_html() -> str:
    """The home page's live-metrics panel: the current Prometheus text,
    self-refreshing via a tiny fetch loop (the server-rendered snapshot
    stands in when JS is off).  Rendered only when the live registry is
    enabled (a serving process)."""
    if not obs_metrics.MIRROR:
        return ""
    snap = html.escape(obs_metrics.render() or "(no samples yet)")
    return (
        "<h2>live metrics</h2>"
        "<details open><summary><a href='/metrics'>/metrics</a> "
        "(refreshes every 2s)</summary>"
        "<pre id='live-metrics' style='background:#f6f6f6;padding:8px;"
        f"max-height:340px;overflow:auto'>{snap}</pre></details>"
        "<script>async function _lm(){try{const r=await fetch('/metrics');"
        "document.getElementById('live-metrics').textContent="
        "await r.text();}catch(e){}}setInterval(_lm,2000);</script>"
    )


def home_html(store_dir=None, check_service=None) -> str:
    rows = []
    by_name: dict[str, list] = {}
    for name, ts, d, v in run_index(store_dir):
        by_name.setdefault(name, []).append((ts, d, v))
    for name in sorted(by_name):
        for ts, d, v in sorted(by_name[name], reverse=True):
            color = VALID_COLORS.get(v, "#eee")
            rows.append(
                f"<tr style='background:{color}'>"
                f"<td>{html.escape(name)}</td>"
                f"<td><a href='/files/{html.escape(name)}/{html.escape(ts)}/'>"
                f"{html.escape(ts)}</a></td>"
                f"<td>{html.escape(str(v))}</td>"
                f"<td><a href='/zip/{html.escape(name)}/{html.escape(ts)}'>zip</a></td>"
                f"</tr>"
            )
    return (
        "<html><head><title>jepsen-tpu</title>"
        "<style>body{font-family:sans-serif}table{border-collapse:collapse}"
        "td,th{padding:4px 12px;text-align:left}</style></head><body>"
        "<h1>jepsen-tpu results</h1>"
        + queue_panel_html(check_service)
        + slo_panel_html(check_service)
        + metrics_panel_html()
        + "<p><a href='/suite'>suite overview</a> — "
        "<a href='/perf'>perf trajectory</a></p>"
        "<table><tr><th>test</th><th>time</th><th>valid?</th><th></th></tr>"
        + "".join(rows)
        + "</table></body></html>"
    )


def suite_html(store_dir=None) -> str:
    """The test-all comparison view: one row per test NAME, its runs as
    a compact validity strip (latest first) — scanning a suite's health
    at a glance, the role of the reference's test-all summary over the
    home table's run-by-run listing."""
    rows = []
    by_name: dict[str, dict] = {}
    for name, ts, d, v in run_index(store_dir):
        by_name.setdefault(name, {})[ts] = (d, v)
    for name in sorted(by_name):
        runs = by_name[name]
        cells = []
        ordered = sorted(runs.items(), reverse=True)
        n_valid = 0
        for ts, (d, v) in ordered:
            n_valid += v is True
            color = VALID_COLORS.get(v, "#eee")
            cells.append(
                f"<a href='/files/{html.escape(name)}/{html.escape(ts)}/' "
                f"title='{html.escape(ts)}: {html.escape(str(v))}' "
                f"style='display:inline-block;width:14px;height:22px;"
                f"background:{color};margin-right:2px'></a>"
            )
        rows.append(
            f"<tr><td><a href='/files/{html.escape(name)}/'>{html.escape(name)}</a></td>"
            f"<td>{n_valid}/{len(ordered)} valid</td>"
            f"<td>{''.join(cells)}</td></tr>"
        )
    return (
        "<html><head><title>jepsen-tpu suite</title>"
        "<style>body{font-family:sans-serif}table{border-collapse:collapse}"
        "td,th{padding:4px 12px;text-align:left;vertical-align:middle}</style>"
        "</head><body><h1>suite overview</h1>"
        "<p><a href='/'>all runs</a></p>"
        "<table><tr><th>test</th><th>record</th><th>runs (newest first)</th></tr>"
        + "".join(rows)
        + "</table></body></html>"
    )


def _sparkline(values: list[float], width: int = 260, height: int = 36) -> str:
    """An inline-SVG trend line for a metric's ledger history (oldest to
    newest, left to right).  Flat series render as a midline."""
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    n = len(values)
    pts = " ".join(
        f"{(i * (width - 4) / max(1, n - 1) + 2):.1f},"
        f"{(height - 4 - (v - lo) / span * (height - 8) + 2):.1f}"
        for i, v in enumerate(values)
    )
    return (
        f"<svg width='{width}' height='{height}' "
        "style='background:#f6f6f6;vertical-align:middle'>"
        f"<polyline points='{pts}' fill='none' stroke='#4477aa' "
        "stroke-width='1.5'/>"
        f"<circle cx='{(width - 2):.1f}' "
        f"cy='{(height - 4 - (values[-1] - lo) / span * (height - 8) + 2):.1f}'"
        " r='2.5' fill='#cc3311'/></svg>"
    )


def perf_html(store_dir=None) -> str:
    """The perf-trajectory page: per-metric history over the perf ledger
    (obs.regress), one sparkline + recent-values table per (kind,
    metric), grouped by machine fingerprint — the BENCH_r0*.json
    trajectory, readable instead of write-only.  Competition verdicts
    (``perfwatch compete``) list below the trends."""
    base = store.base_dir({"store-dir": store_dir} if store_dir else None)
    path = obs_regress.ledger_path(store_dir=base)
    records = obs_regress.read_records(path)
    parts = ["<html><head><title>jepsen-tpu perf trajectory</title>"
             "<style>body{font-family:sans-serif}table{border-collapse:"
             "collapse}td,th{padding:2px 10px;text-align:left;"
             "border-bottom:1px solid #ddd}</style></head><body>"
             "<h1>perf trajectory</h1>"
             f"<p><a href='/'>all runs</a> — ledger: "
             f"<code>{html.escape(str(path))}</code> "
             f"({len(records)} records)</p>"]
    if not records:
        parts.append("<p>(empty ledger — run bench.py, tools/loadgen.py or "
                     "the tier-1 budget gate to populate it)</p>")
        return "".join(parts) + "</body></html>"
    # (kind, fingerprint_key, metric) -> [(ts, value, sha)] oldest-first
    series: dict[tuple, list] = {}
    competes = []
    for r in records:
        if r.get("kind") == "compete":
            competes.append(r)
            continue
        if r.get("outage"):
            continue
        sha = (r.get("git") or {}).get("sha", "?")[:10]
        axes = r.get("axes") or {}
        ax = ",".join(f"{k}={v}" for k, v in sorted(axes.items()))
        for name, v in (r.get("metrics") or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                # str() everything: a hand-written/foreign record missing
                # fingerprint_key must not make sorted() compare None
                # against str and 500 the whole page
                key = (str(r.get("kind")), str(r.get("fingerprint_key")),
                       ax, str(name))
                series.setdefault(key, []).append((r.get("ts"), float(v), sha))
    last_kind = None
    for (kind, fkey, ax, name) in sorted(series):
        pts = series[(kind, fkey, ax, name)]
        if kind != last_kind:
            parts.append(f"<h2>{html.escape(str(kind))}</h2>")
            last_kind = kind
        vals = [v for _, v, _ in pts]
        label = html.escape(name) + (f" <small>[{html.escape(ax)}]</small>"
                                     if ax else "")
        newest = pts[-1]
        parts.append(
            f"<p><b>{label}</b> <small>on {html.escape(str(fkey))}</small>"
            f"<br>{_sparkline(vals)} latest <b>{newest[1]:.6g}</b> "
            f"@ {html.escape(newest[2])} ({len(pts)} points, "
            f"min {min(vals):.6g}, max {max(vals):.6g})</p>"
        )
        rows = "".join(
            f"<tr><td>{time.strftime('%Y-%m-%d %H:%M', time.localtime(ts or 0))}"
            f"</td><td>{html.escape(sha)}</td><td>{v:.6g}</td></tr>"
            for ts, v, sha in reversed(pts[-10:])
        )
        parts.append(
            "<details><summary>recent values</summary>"
            "<table><tr><th>time</th><th>git</th><th>value</th></tr>"
            + rows + "</table></details>"
        )
    if competes:
        parts.append("<h2>competition verdicts</h2>"
                     "<table><tr><th>time</th><th>axis</th><th>winner</th>"
                     "<th>margin</th><th>decisive?</th><th>git</th></tr>")
        for r in reversed(competes):
            v = r.get("extra") or {}
            parts.append(
                "<tr><td>"
                + time.strftime("%Y-%m-%d %H:%M",
                                time.localtime(float(r.get("ts") or 0)))
                + f"</td><td>{html.escape(str(v.get('axis')))}</td>"
                f"<td>{html.escape(str(v.get('winner')))}</td>"
                f"<td>{html.escape(str(v.get('margin_pct')))}%</td>"
                f"<td>{'yes' if v.get('decisive') else 'no (within noise)'}"
                "</td>"
                f"<td>{html.escape((r.get('git') or {}).get('sha', '?')[:10])}"
                "</td></tr>"
            )
        parts.append("</table>")
    return "".join(parts) + "</body></html>"


def _serve_mod():
    """Lazy jepsen_tpu_torch.serve import: plain store browsing must not drag
    in the checker stack (serve pulls parallel.batch pulls torch)."""
    from jepsen_tpu_torch import serve

    return serve


def _parse_stream_body(raw: bytes) -> tuple[dict, list, bool, int | None]:
    """Parse a ``POST /stream`` body into ``(header, ops, end, seq)``.

    The body is NDJSON — one JSON object per line.  Lines carrying a
    ``type``/``process`` key are history ops; ``{"end": true}`` marks
    end-of-stream; anything else is a header/control line whose keys
    merge into the header (``ops`` may inline an op list, ``seq`` sets
    the idempotent feed offset).  A single JSON document like
    ``{"model": ..., "ops": [...], "end": true}`` is therefore parsed
    by the same rules.  Raises ``ValueError`` on malformed input."""
    header: dict = {}
    ops: list = []
    end = False
    seq: int | None = None
    for ln in raw.decode("utf-8", "replace").splitlines():
        ln = ln.strip()
        if not ln:
            continue
        try:
            obj = json.loads(ln)
        except json.JSONDecodeError as e:
            raise ValueError(f"bad NDJSON line: {e}") from None
        if not isinstance(obj, dict):
            raise ValueError("each NDJSON line must be a JSON object")
        if "type" in obj or "process" in obj:
            ops.append(obj)
            continue
        obj = dict(obj)
        inline = obj.pop("ops", None)
        if inline is not None:
            if not isinstance(inline, list):
                raise ValueError("ops must be a list of op maps")
            ops.extend(dict(o) for o in inline)
        if obj.pop("end", False):
            end = True
        s = obj.pop("seq", None)
        if s is not None:
            seq = int(s)
        header.update(obj)
    return header, ops, end, seq


def _safe_resolve(base: Path, rel: str) -> Path | None:
    """Path-traversal guard (web.clj:328-333)."""
    target = (base / rel).resolve()
    base = base.resolve()
    if base == target or base in target.parents:
        return target
    return None


def _telemetry_table(headers: list, rows: list[list]) -> str:
    head = "".join(f"<th>{html.escape(str(c))}</th>" for c in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in r) + "</tr>"
        for r in rows
    )
    return (
        "<table style='border-collapse:collapse;margin-bottom:12px'>"
        f"<tr>{head}</tr>{body}</table>"
    )


def telemetry_html(run_dir: Path, rel: str | None = None) -> str:
    """The run page's phase / checker / ladder-stage timing tables,
    rendered from the run's ``telemetry.json`` (the obs.summary rollup).
    ``rel`` (the run's path under the store root) adds the Perfetto
    trace-export download link.  Empty string when the run carries no
    telemetry."""
    p = Path(run_dir) / "telemetry.json"
    if not p.exists():
        return ""
    try:
        s = json.loads(p.read_text())
    except (OSError, ValueError):
        return ""
    parts = [f"<h2>telemetry</h2><p>total wall: {s.get('wall_s', 0)} s</p>"]
    if rel and (Path(run_dir) / "telemetry.jsonl").exists():
        href = "/trace/" + html.escape(rel.strip("/"))
        parts.append(
            f"<p><a href='{href}'>trace.json</a> — Perfetto/Chrome "
            "trace-event export (one lane per request; load at "
            "ui.perfetto.dev)</p>"
        )
    ev_dir = Path(run_dir) / "evidence"
    if rel and ev_dir.is_dir():
        n_ev = sum(1 for _ in ev_dir.glob("*.json"))
        if n_ev:
            href = "/files/" + html.escape(rel.strip("/")) + "/evidence/"
            parts.append(
                f"<p><a href='{href}'>evidence bundles</a> — {n_ev} "
                "verdict provenance bundle(s): decision path, engine "
                "resolution, and witness per verdict (audit with "
                "<code>tools/evidence.py verify|replay</code>)</p>"
            )
    if s.get("phases"):
        parts.append("<h3>phases</h3>")
        parts.append(_telemetry_table(
            ["phase", "wall (s)", "count"],
            [[p_["phase"], p_["wall_s"], p_["count"]] for p_ in s["phases"]],
        ))
    if s.get("checkers"):
        parts.append("<h3>checkers</h3>")
        parts.append(_telemetry_table(
            ["checker", "seconds", "count", "valid?"],
            [[c["checker"], c["seconds"], c["count"], c.get("valid")]
             for c in s["checkers"]],
        ))
    if s.get("serve"):
        sv = s["serve"]
        parts.append("<h3>check service</h3>")
        rows = [[k, sv[k]] for k in (
            "batches", "requests", "batch_wall_s", "avg_batch_requests",
            "avg_occupancy", "avg_padding_waste", "submitted", "completed",
            "rejected", "expired", "drained") if k in sv]
        for key, label in (("admission", "admission wait"),
                           ("request", "request latency")):
            if key in sv:
                rows.append([f"{label} mean (s)", sv[key]["mean_s"]])
                rows.append([f"{label} max (s)", sv[key]["max_s"]])
        parts.append(_telemetry_table(["serve", "value"], rows))
    if s.get("ladder"):
        parts.append("<h3>ladder stages</h3>")
        parts.append(_telemetry_table(
            ["stage", "engine", "capacity", "lanes", "seconds", "resolved",
             "refuted", "unknowns left", "launches", "compile (s)",
             "execute (s)", "peak frontier", "lossy", "dedup",
             "device MB (peak)"],
            [[r.get("stage"), r.get("engine"), r.get("capacity"),
              r.get("lanes"), r.get("seconds"), r.get("resolved", ""),
              r.get("refuted", ""), r.get("unknowns_remaining", ""),
              r.get("launches", ""), r.get("compile_s", ""),
              r.get("execute_s", ""), r.get("peak_frontier", ""),
              r.get("lossy", ""), r.get("dedup", ""),
              _mb(r.get("device_bytes_peak"))] for r in s["ladder"]],
        ))
    if s.get("critpath", {}).get("spans"):
        cp = s["critpath"]
        parts.append(
            f"<h3>critical path ({cp.get('total_s', 0)} s on-path of "
            f"{cp.get('wall_s', 0)} s wall)</h3>")
        parts.append(_telemetry_table(
            ["span", "critpath (s)", "inclusive (s)", "count", "slack (s)"],
            [[r.get("span"), r.get("cp_s"), r.get("total_s"),
              r.get("count"), r.get("slack_s")]
             for r in cp["spans"]],
        ))
    if s.get("dedup"):
        parts.append("<h3>dedup rounds (sort vs bucket probe)</h3>")
        parts.append(_telemetry_table(
            ["backend", "candidates", "capacity", "probes", "per round (µs)"],
            [[d.get("backend"), d.get("candidates"), d.get("capacity"),
              d.get("probes"), d.get("per_round_us")] for d in s["dedup"]],
        ))
    if s.get("elle"):
        parts.append("<h3>elle inference (column-native substages)</h3>")
        parts.append(_telemetry_table(
            ["stage", "seconds", "count", "max (s)"],
            [[e.get("stage"), e.get("seconds"), e.get("count"),
              e.get("max_s")] for e in s["elle"]],
        ))
    if s.get("faults"):
        parts.append("<h3>faults (retries / degradations / checkpoints / deadline)</h3>")
        parts.append(_telemetry_table(
            ["fault", "count", "seconds", "detail"],
            [[f.get("fault"), f.get("count"), f.get("seconds", ""),
              f.get("detail", "")] for f in s["faults"]],
        ))
    if s.get("counters"):
        parts.append("<h3>counters</h3>")
        parts.append(_telemetry_table(
            ["counter", "total"], sorted(s["counters"].items())
        ))
    return "".join(parts)


class Handler(BaseHTTPRequestHandler):
    store_dir = None
    check_service = None  # a jepsen_tpu_torch.serve.CheckService, or None
    #: a jepsen_tpu_torch.serve.fleet.FleetRouter, or None.  When mounted it
    #: fronts /check, /queue, /alerts, /readyz and the /fleet admin
    #: surface; 429s re-quote Retry-After as the MIN across live
    #: replicas and 503 means EVERY replica's breaker is open.
    fleet = None
    profiler = None  # a jepsen_tpu_torch.obs.profiler.ProfilerHook, or None
    #: request-body bound for POST /check, enforced on Content-Length
    #: BEFORE the body is read or parsed (413 beyond it).
    max_request_bytes = 32 * 1024 * 1024
    t_start = time.monotonic()

    def log_message(self, fmt, *args):  # quiet
        logger.debug("web: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype="text/html; charset=utf-8",
              headers=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj, headers=None):
        self._send(
            code, json.dumps(obj, default=str).encode(),
            "application/json; charset=utf-8", headers,
        )

    # ------------------------------------------------------------------
    # Check-serving API (jepsen_tpu_torch.serve)
    # ------------------------------------------------------------------

    def do_POST(self):  # noqa: N802 - stdlib API
        try:
            path = unquote(self.path.split("?")[0])
            if path in ("/profile/start", "/profile/stop"):
                self._handle_profile(path)
                return
            if path == "/fleet/rollout":
                self._handle_rollout()
                return
            if path == "/stream" or path.startswith("/stream/"):
                self._handle_stream(path)
                return
            if path != "/check":
                self._send(404, b"not found")
                return
            svc = self.fleet or self.check_service
            if svc is None:
                self._send_json(
                    503, {"error": "no check service mounted "
                                   "(start with serve --check)"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                self._send_json(400, {"error": "bad Content-Length"})
                return
            if length < 0:
                # rfile.read(-1) would read until EOF — a hostile
                # keep-alive client could wedge this handler thread
                # with no size bound at all
                self._send_json(400, {"error": "bad Content-Length"})
                return
            if length > self.max_request_bytes:
                # Reject BEFORE reading/parsing: one hostile payload
                # must not balloon the process ahead of admission
                # validation.  The connection is closed (the unread
                # body would otherwise wedge keep-alive).
                obs_metrics.inc("serve.oversized_rejected")
                self._send_json(
                    413,
                    {"error": "request body too large",
                     "bytes": length, "limit": self.max_request_bytes},
                    headers={"Connection": "close"},
                )
                self.close_connection = True
                return
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                history = body["history"]
                if not isinstance(history, list):
                    raise TypeError("history must be a list of op maps")
                model = _serve_mod().model_by_name(
                    body.get("model", "cas-register"))
                priority = int(body.get("priority") or 0)
                client = str(body.get("client") or "http")
                latency_class = body.get("class")
                if latency_class is not None:
                    latency_class = str(latency_class)
                trace_id = body.get("trace_id")
                if trace_id is not None:
                    trace_id = str(trace_id)
                idem_key = body.get("idempotency_key")
                if idem_key is not None:
                    idem_key = str(idem_key)
                deadline = body.get("deadline")
                if deadline is not None:
                    deadline = faults.Deadline.coerce(float(deadline))
                wait_timeout = body.get("wait_timeout")
                wait_timeout = (
                    300.0 if wait_timeout is None
                    else min(float(wait_timeout), 3600.0)
                )
            except (KeyError, TypeError, ValueError) as e:
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            try:
                # idempotency_key makes the retry behavior this API
                # actively instructs (429/503 Retry-After, 202-then-poll
                # timeouts) safe: a duplicate submit attaches to the
                # original request — same id — instead of re-running it.
                fut = svc.submit(
                    history, model=model, priority=priority,
                    deadline=deadline, client=client, trace_id=trace_id,
                    class_=latency_class, idempotency_key=idem_key,
                )
            except (KeyError, TypeError, ValueError, IndexError) as e:
                # malformed op dicts surface from pack() at admission —
                # client input, not an internal error
                self._send_json(400, {"error": f"bad history: {e!r}"})
                return
            except _serve_mod().QueueFull as e:
                # The 429-style contract: bounded queue, explicit
                # rejection with a retry hint — never unbounded buffering.
                self._send_json(
                    429,
                    {"error": "queue full", "depth": e.depth,
                     "limit": e.limit, "retry_after_s": e.retry_after},
                    headers={"Retry-After": max(1, math.ceil(e.retry_after))},
                )
                return
            except _serve_mod().ServiceUnavailable as e:
                # Circuit breaker open: the DEVICE isn't serving (K
                # consecutive batch failures) — distinct from the 429
                # backpressure case where the queue is merely full.
                self._send_json(
                    503,
                    {"error": "circuit breaker open",
                     "retry_after_s": e.retry_after},
                    headers={"Retry-After": max(1, math.ceil(e.retry_after))},
                )
                return
            except _serve_mod().ServiceClosed:
                self._send_json(503, {"error": "service shutting down"})
                return
            req = svc.get(fut.id)
            # the fleet router's get() returns the describe() document
            # directly; the single service returns the request object
            tid = (req.get("trace_id") if isinstance(req, dict)
                   else req.trace_id if req is not None else None)
            if body.get("wait"):
                import concurrent.futures

                # A request deadline bounds the HTTP wait too (plus a
                # short grace so the queue-expiry unknown lands).
                timeout = wait_timeout
                if deadline is not None:
                    timeout = deadline.clamp(wait_timeout) + 1.0
                try:
                    result = fut.result(timeout=timeout)
                except concurrent.futures.TimeoutError:
                    self._send_json(
                        202, {"id": fut.id, "status": "pending",
                              "trace_id": tid, "href": f"/check/{fut.id}"})
                    return
                self._send_json(
                    200, {"id": fut.id, "trace_id": tid, "result": result})
            elif fut.done():
                # Already settled at submit time: an idempotent
                # duplicate of a finished request (whose original may
                # have been evicted — the 202 href would 404 forever),
                # or a trivially-valid history.  Hand the result over.
                self._send_json(
                    200, {"id": fut.id, "trace_id": tid,
                          "result": fut.result()})
            else:
                self._send_json(
                    202, {"id": fut.id, "status": "queued",
                          "trace_id": tid, "href": f"/check/{fut.id}"})
        except BrokenPipeError:  # pragma: no cover
            pass
        except Exception:  # noqa: BLE001 - pragma: no cover
            logger.exception("web POST handler error")
            self._send_json(500, {"error": "internal error"})

    def _read_body(self) -> bytes | None:
        """Bounded request-body read (the POST /check Content-Length
        rules: 400 on a bad length, 413 + connection close beyond
        ``max_request_bytes`` BEFORE any parse).  Replies itself and
        returns None when the body was refused."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self._send_json(400, {"error": "bad Content-Length"})
            return None
        if length < 0:
            self._send_json(400, {"error": "bad Content-Length"})
            return None
        if length > self.max_request_bytes:
            obs_metrics.inc("serve.oversized_rejected")
            self._send_json(
                413,
                {"error": "request body too large",
                 "bytes": length, "limit": self.max_request_bytes},
                headers={"Connection": "close"},
            )
            self.close_connection = True
            return None
        return self.rfile.read(length)

    def _handle_stream(self, path: str) -> None:
        """POST /stream[/<id>[/close]] — the streaming lane (NDJSON op
        ingestion into ``CheckService.stream_*``; protocol in the
        module docstring).  Streams are replica-sticky (each holds a
        carried frontier), so this surface always talks to the LOCAL
        check service, never the fleet router."""
        svc = self.check_service
        if svc is None:
            self._send_json(
                503, {"error": "no check service mounted (start with "
                               "serve --check; streams are replica-"
                               "sticky and never fleet-routed)"})
            return
        raw = self._read_body()
        if raw is None:
            return
        try:
            header, ops, end, seq = _parse_stream_body(raw)
        except ValueError as e:
            self._send_json(400, {"error": f"bad stream body: {e}"})
            return
        serve = _serve_mod()
        try:
            if path == "/stream":
                try:
                    status = svc.stream_open(
                        model=header.get("model"),
                        stream_id=header.get("stream_id"),
                        resume=bool(header.get("resume")),
                        client=str(header.get("client") or "http"),
                        trace_id=header.get("trace_id"),
                    )
                except (KeyError, ValueError) as e:
                    # unknown model / malformed header — client input
                    self._send_json(400, {"error": f"bad stream: {e}"})
                    return
                sid = status["stream-id"]
                if ops:
                    status = svc.stream_feed(sid, ops, seq=seq)
                if end:
                    status = svc.stream_close(sid)
                status.setdefault("href", f"/stream/{sid}")
                self._send_json(200, status)
                return
            parts = [p for p in path.split("/") if p]
            if len(parts) == 3 and parts[2] == "close":
                self._send_json(200, svc.stream_close(parts[1]))
                return
            if len(parts) != 2:
                self._send(404, b"not found")
                return
            status = svc.stream_feed(parts[1], ops, seq=seq)
            if end:
                status = svc.stream_close(parts[1])
            self._send_json(200, status)
        except KeyError as e:
            self._send_json(404, {"error": str(e)})
        except ValueError as e:
            # closed stream / sequence gap: the stream exists but the
            # feed conflicts with its state
            self._send_json(409, {"error": str(e)})
        except serve.QueueFull as e:
            # Stream-lane backpressure: same 429 contract as /check,
            # but the quote comes from the STREAM lane's session EWMA.
            self._send_json(
                429,
                {"error": "stream lane full", "depth": e.depth,
                 "limit": e.limit, "retry_after_s": e.retry_after,
                 "tier": e.tier},
                headers={"Retry-After": max(1, math.ceil(e.retry_after))},
            )
        except serve.ServiceClosed:
            self._send_json(503, {"error": "service shutting down"})

    def _handle_profile(self, path: str) -> None:
        """POST /profile/start|stop — the bounded torch.profiler capture
        hook (obs.profiler, mounted via serve --profile-dir)."""
        if self.profiler is None:
            self._send_json(
                503, {"error": "no profiler mounted "
                               "(start with serve --profile-dir)"})
            return
        if path.endswith("/start"):
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:
                self._send_json(400, {"error": "bad JSON body"})
                return
            doc = self.profiler.start(body.get("seconds"))
        else:
            doc = self.profiler.stop()
        self._send_json(409 if doc.get("error") else 200, doc)

    def _handle_rollout(self) -> None:
        """POST /fleet/rollout — cycle the fleet's local replicas with
        zero downtime (serve.fleet.FleetRouter.rollout): drain each to
        checkpoint, start its successor (journal replay +
        resume_drained), swap, no 5xx, no verdict loss.  Body may name
        specific replicas: {"names": ["r0"]}."""
        if self.fleet is None:
            self._send_json(503, {"error": "no fleet mounted "
                                           "(start with serve --replicas N)"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
        except ValueError:
            self._send_json(400, {"error": "bad JSON body"})
            return
        names = body.get("names")
        try:
            doc = self.fleet.rollout(names=names)
        except ValueError as e:
            self._send_json(409, {"error": str(e)})
            return
        self._send_json(200, doc)

    def _federated_metrics(self, base_text: str) -> str:
        """The fleet-wide exposition: this process's registry (router
        counters + the in-process replicas' shared series) plus one
        scrape per live replica, re-labeled and rolled up by
        obs.fleetview.federate.  A replica whose scrape fails is marked
        down (jepsen_tpu_fleet_scrape_up 0), never a 500 — the scrape
        endpoint must outlive any single replica."""
        scrapes: dict[str, str] = {}
        errors: dict[str, str] = {}
        try:
            replicas = self.fleet.replicas()
        except Exception:  # noqa: BLE001 — federation is additive only
            return base_text
        for name, rep in replicas.items():
            try:
                scrapes[name] = rep.scrape_metrics()
            except Exception as e:  # noqa: BLE001 — mark it down
                errors[name] = str(e)
        try:
            return obs_fleetview.federate(base_text, scrapes,
                                          errors=errors)
        except Exception:  # noqa: BLE001 — a malformed scrape must not
            logger.exception("metrics federation failed")
            return base_text

    def do_GET(self):  # noqa: N802 - stdlib API
        try:
            path = unquote(self.path.split("?")[0])
            base = store.base_dir({"store-dir": self.store_dir} if self.store_dir else None)
            if path == "/metrics":
                # Prometheus text exposition: the live registry, fed by
                # the obs mirror + the serving layer's explicit series.
                # The perf ledger's newest record per kind rides along as
                # jepsen_tpu_perf_headline{kind,metric} gauges (refreshed
                # only when the ledger file changed).  With a fleet
                # mounted the page FEDERATES: live replica scrapes are
                # re-exported with replica= labels plus
                # jepsen_tpu_fleet_* rollups (obs.fleetview), so one
                # scrape covers the whole fleet.
                try:
                    obs_regress.publish_gauges(store_dir=base)
                except Exception:  # noqa: BLE001 — a corrupt ledger must
                    pass  # not take down the scrape endpoint
                text = obs_metrics.render()
                if self.fleet is not None:
                    text = self._federated_metrics(text)
                self._send(
                    200, text.encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/telemetry":
                # Recorder-stream discovery: where THIS process's
                # telemetry.jsonl lives + the t0 epoch the merger
                # clock-aligns on.  Subprocess replicas answer this so
                # the router's GET /fleet can announce every stream.
                rec = obs._RECORDER
                if rec is None:
                    self._send_json(200, {"recording": False})
                else:
                    meta = rec.events[0] if rec.events else {}
                    self._send_json(200, {
                        "recording": True, "dir": str(rec.dir),
                        "jsonl": str(rec.path), "t0": meta.get("t0"),
                        "pid": meta.get("pid"), "host": meta.get("host"),
                    })
            elif path == "/healthz":
                # Liveness: this handler running IS the signal.
                self._send_json(
                    200,
                    {"ok": True,
                     "uptime_s": round(time.monotonic() - self.t_start, 3)},
                )
            elif path == "/readyz":
                # Readiness: mounted + admitting + breaker not open.
                # With a fleet mounted, ready while ANY replica can
                # take work — one replica's breaker is not an outage.
                if self.fleet is not None:
                    ok, info = self.fleet.ready()
                    self._send_json(
                        200 if ok else 503, {"ready": ok, **info})
                    return
                svc = self.check_service
                if svc is None:
                    self._send_json(
                        503, {"ready": False, "reason": "no check service"})
                elif getattr(svc, "_closed", False):
                    self._send_json(
                        503, {"ready": False, "reason": "shutting down"})
                else:
                    br = svc.breaker.describe()
                    if br["state"] == "open":
                        self._send_json(
                            503,
                            {"ready": False, "reason": "circuit breaker open",
                             "breaker": br},
                            headers={"Retry-After":
                                     max(1, math.ceil(br["retry_after_s"]))},
                        )
                    else:
                        self._send_json(
                            200, {"ready": True, "breaker": br})
            elif path == "/profile":
                if self.profiler is None:
                    self._send_json(503, {"error": "no profiler mounted"})
                else:
                    self._send_json(200, self.profiler.status())
            elif path.startswith("/trace/"):
                target = _safe_resolve(base, path[len("/trace/"):])
                jsonl = target / "telemetry.jsonl" if target else None
                if jsonl is None or not jsonl.is_file():
                    self._send(404, b"not found")
                else:
                    try:
                        events, skipped = obs_trace.read_jsonl_events(jsonl)
                    except (OSError, ValueError) as e:
                        self._send_json(500, {"error": f"unreadable "
                                                       f"telemetry: {e}"})
                        return
                    body = json.dumps(
                        obs_trace.to_trace_events(
                            events, skipped_lines=skipped),
                        separators=(",", ":"), default=str,
                    ).encode()
                    self._send(
                        200, body, "application/json; charset=utf-8",
                        headers={"Content-Disposition":
                                 'attachment; filename="trace.json"'},
                    )
            elif path in ("/", "/index.html"):
                self._send(
                    200, home_html(self.store_dir, self.check_service).encode()
                )
            elif path == "/suite":
                self._send(200, suite_html(self.store_dir).encode())
            elif path == "/perf":
                self._send(200, perf_html(self.store_dir).encode())
            elif path == "/queue":
                front = self.fleet or self.check_service
                if front is None:
                    self._send_json(503, {"error": "no check service mounted"})
                else:
                    self._send_json(200, front.stats())
            elif path == "/fleet":
                # Fleet status: per-replica state/stats + router totals
                # (routed/spilled/fenced/resubmitted/rollouts/parked).
                if self.fleet is None:
                    self._send_json(
                        503, {"error": "no fleet mounted "
                                       "(start with serve --replicas N)"})
                else:
                    self._send_json(200, self.fleet.stats())
            elif path == "/alerts":
                # The live SLO burn-rate engine's alert document:
                # currently-firing alerts plus the full per-SLO burn
                # table (fast/slow windows) — loadgen's acceptance
                # gates and operators' pagers both read this.  A fleet
                # answers the merged per-replica document.
                if self.fleet is not None:
                    self._send_json(200, self.fleet.alerts())
                    return
                svc = self.check_service
                if svc is None or getattr(svc, "slo", None) is None:
                    self._send_json(503, {"error": "no check service mounted"})
                else:
                    self._send_json(200, svc.slo.alerts())
            elif path.startswith("/check/"):
                front = self.fleet or self.check_service
                if front is None:
                    self._send_json(503, {"error": "no check service mounted"})
                else:
                    req = front.get(path[len("/check/"):])
                    if req is None:
                        self._send_json(404, {"error": "unknown request id"})
                    else:
                        self._send_json(
                            200,
                            req if isinstance(req, dict) else req.describe())
            elif path.startswith("/stream/"):
                # Replica-sticky: streams hold carried frontier state,
                # so status always reads the LOCAL service (no fleet).
                svc = self.check_service
                if svc is None:
                    self._send_json(503, {"error": "no check service mounted"})
                else:
                    try:
                        self._send_json(
                            200, svc.stream_status(path[len("/stream/"):]))
                    except KeyError:
                        self._send_json(404, {"error": "unknown stream id"})
            elif path.startswith("/evidence/"):
                # The verdict's evidence bundle (obs.provenance): the
                # full decision path + witness for one served request,
                # keyed by the SAME id as GET /check/<id>.  Audit it
                # offline with tools/evidence.py verify / replay.
                front = self.fleet or self.check_service
                if front is None:
                    self._send_json(503, {"error": "no check service mounted"})
                else:
                    bundle = front.get_evidence(
                        path[len("/evidence/"):])
                    if bundle is None:
                        self._send_json(
                            404, {"error": "no evidence bundle for that "
                                           "request id"})
                    else:
                        self._send_json(200, bundle)
            elif path.startswith("/files/"):
                target = _safe_resolve(base, path[len("/files/"):])
                if target is None or not target.exists():
                    self._send(404, b"not found")
                elif target.is_dir():
                    entries = sorted(target.iterdir())
                    items = "".join(
                        f"<li><a href='{html.escape(e.name)}{'/' if e.is_dir() else ''}'>"
                        f"{html.escape(e.name)}</a></li>"
                        for e in entries
                    )
                    # The run page: a run dir with telemetry renders its
                    # phase/stage timing tables above the file listing
                    # (+ the Perfetto trace-export link).
                    tele = telemetry_html(target, rel=path[len("/files/"):])
                    self._send(
                        200,
                        (
                            "<html><head><style>body{font-family:sans-serif}"
                            "td,th{padding:2px 10px;text-align:left;"
                            "border-bottom:1px solid #ddd}</style></head>"
                            f"<body>{tele}<ul>{items}</ul></body></html>"
                        ).encode(),
                    )
                else:
                    guessed, _ = mimetypes.guess_type(str(target))
                    if guessed is None or guessed.startswith("text/"):
                        # Serve unknown/plain files readably in-browser,
                        # but html (timeline.html!) as real html.
                        guessed = guessed or "text/plain"
                        ctype = f"{guessed}; charset=utf-8"
                    else:
                        ctype = guessed
                    self._send(200, target.read_bytes(), ctype)
            elif path.startswith("/zip/"):
                target = _safe_resolve(base, path[len("/zip/"):])
                if target is None or not target.is_dir():
                    self._send(404, b"not found")
                else:
                    buf = io.BytesIO()
                    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                        for f in sorted(target.rglob("*")):
                            if f.is_file():
                                z.write(f, f.relative_to(target.parent))
                    self._send(200, buf.getvalue(), "application/zip")
            else:
                self._send(404, b"not found")
        except BrokenPipeError:  # pragma: no cover
            pass
        except Exception:  # noqa: BLE001 - pragma: no cover
            logger.exception("web handler error")
            self._send(500, b"internal error")


def make_server(host="0.0.0.0", port=8080, store_dir=None,
                check_service=None, profiler=None,
                max_request_mb: float = 32.0,
                fleet=None) -> ThreadingHTTPServer:
    # A mounted web server IS a serving process: turn the live metrics
    # registry on so /metrics (and the home panel) have data to show.
    obs_metrics.enable_mirror()
    handler = type(
        "BoundHandler", (Handler,),
        {"store_dir": store_dir, "check_service": check_service,
         "fleet": fleet, "profiler": profiler,
         "max_request_bytes": int(max_request_mb * 1024 * 1024),
         "t_start": time.monotonic()},
    )
    return ThreadingHTTPServer((host, port), handler)


def serve(host="0.0.0.0", port=8080, store_dir=None, check_service=None,
          profiler=None, max_request_mb: float = 32.0, fleet=None):
    """Blocking server (web.clj:385-390).  With a ``check_service`` the
    check API mounts and shutdown drains it (checkpointing queued work);
    with a ``fleet`` (serve.fleet.FleetRouter) the check API fronts the
    whole replica fleet instead (+ GET /fleet, POST /fleet/rollout);
    with a ``profiler`` (obs.profiler.ProfilerHook) the /profile
    endpoints drive bounded device captures."""
    srv = make_server(host, port, store_dir, check_service, profiler,
                      max_request_mb=max_request_mb, fleet=fleet)
    logger.info("serving store on http://%s:%d", host, port)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        if profiler is not None:
            profiler.stop()
        if fleet is not None:
            fleet.shutdown(drain=True)
        elif check_service is not None:
            check_service.shutdown(drain=True)


if __name__ == "__main__":  # pragma: no cover — exercised via subprocess
    import argparse

    ap = argparse.ArgumentParser(description="Serve the store web UI.")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--store-dir", default=None)
    a = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    serve(a.host, a.port, a.store_dir)
