"""Roll a telemetry event stream up into the ``telemetry.json`` summary.

The port's copy of the JAX package's ``obs.summary``: the same event
stream gives the same summary, key for key, and :func:`format_summary`
the same text.  The summary has a fixed shape that performance work
reports against; ``chip_smoke.py`` prints its ladder table from a run
on the card.

  {"version": 1,
   "wall_s":   <last event end, seconds since recording start>,
   "phases":   [{"phase", "wall_s", "count"}, ...]      # phase.* spans
   "checkers": [{"checker", "seconds", "count", "valid"}, ...]
   "serve":    {"batches", "requests", "batch_wall_s", "avg_batch_requests",
                "avg_occupancy", "avg_padding_waste",
                "continuous_occupancy", "rungs", "rung_joined",  # rung-
                                       # boundary admission (continuous
                                       # batching)
                "admission": {"count", "mean_s", "max_s"},
                "request":   {"count", "mean_s", "max_s"},
                "request_by_class": {tier: {"count", "mean_s", "max_s"}},
                "fastpath_resolved", "fastpath_escalated",
                "submitted", "completed", "rejected", "expired", "drained"}
                                                        # serve.* events
   "fleet":    {"routed", "spilled", "parked", "fenced", "resubmitted",
                "rollouts", "replicas", "replicas_healthy",
                "rollout": {"count", "total_s", "max_s"}}
                               # fleet.* events (the front-door router,
                               # a front-door router): placement +
                               # spill volume, fence/resubmission churn,
                               # and zero-downtime rollout spans
   "streams":  {"opened", "closed", "rejected", "ops", "rescans",
                "epochs": {"count", "total_s", "max_s"},
                "session": {"count", "total_s", "max_s"},
                "verdicts": {verdict: count}}
                               # stream.* events (checker.streaming +
                               # the serving layer's stream sessions):
                               # online-checking volume, epoch scan
                               # time, and mid-stream verdict census
   "ladder":   [{"stage", "engine", "capacity", "lanes", "seconds",
                 "resolved", "refuted", "unknowns_remaining",
                 "launches", "compile_launches", "compile_s",
                 "execute_s", "peak_frontier", "lossy", "dedup"}, ...]
   "dedup":    [{"backend", "candidates", "capacity", "probes",
                 "per_round_us", "interpret"?}, ...]    # dedup.round spans
                               # ("interpret": True marks timings of a
                               # kernel's plain version on the CPU, which
                               # must never compare against card rows)
   "elle":     [{"stage", "seconds", "count", "max_s"}, ...]
                               # elle.* inference substage spans (nodes /
                               # anomalies / edges / scc / infer_batch —
                               # the column-native inference pipeline)
   "memory":   {"device_bytes_peak", "spill_rows", "spill_bytes",
                "spill_merges", "factorizations", "undecidable",
                "oom_spills"}          # bounded-memory layer (ops.spill)
   "faults":   [{"fault", "count", "seconds", "detail"}, ...]  # fault.* events
   "critpath": {"wall_s", "total_s",
                "spans": [{"span", "cp_s", "count", "total_s",
                           "slack_s"}, ...]}
                               # critical-path rollup (obs.critpath):
                               # what bounds wall clock, ranked, in
                               # critical seconds beside inclusive time
   "telemetry": {"skipped_lines"}  # truncated/corrupt jsonl lines the
                               # tolerant reader dropped (present only
                               # when nonzero)
   "counters": {name: total}
   "gauges":   {name: last value}
   "spans":    {name: {"count", "total_s", "max_s"}}}

The ladder table mirrors parallel.batch_analysis's capacity-escalation
stages: one row per rung with the quantities the beam-search literature
instruments (frontier occupancy, truncation/loss, per-stage utilization)
plus the compile-vs-execute split ("compile_s" sums launches that hit a
fresh (engine, shape) bucket — compile + first execute; "execute_s" sums
warm launches).

The faults table aggregates every ``fault.*`` event the fault-tolerance
layer emits (``faults`` / ``parallel.batch``): launch retries, OOM
lane halvings, degraded launches, checkpoint saves/loads, confirmation
resubmits, and deadline trips — one row per fault kind with its count,
total seconds (for the span-shaped ones, e.g. checkpoint writes), and
the last event's detail attributes.

The serve section aggregates the check-serving subsystem's ``serve.*``
events (a check service): shared-batch count/occupancy/padding waste
from ``serve.batch`` spans, admission-wait and end-to-end request
latency from ``serve.admission``/``serve.request`` span events, and the
admission counters (submitted/completed/rejected/expired/drained).
Empty dict when a run never touched the service.

The fleet section aggregates the front-door router's ``fleet.*`` events
(a front-door router): routing volume (``fleet.routed`` summed over
replica labels) vs load-spill (``fleet.spilled``) and no-replica parking
(``fleet.parked``), failure-containment churn (``fleet.fenced``,
``fleet.resubmitted``), rollout counts/spans, and the last-seen replica
census gauges.  Empty dict for single-service runs.
"""

from __future__ import annotations

from typing import Iterable, Mapping

#: ladder.stage span attributes copied verbatim into the stage table.
_STAGE_KEYS = (
    "resolved", "refuted", "unknowns_remaining", "launches",
    "compile_launches", "compile_s", "execute_s", "peak_frontier", "lossy",
    "dedup", "degraded", "device_bytes_peak",
    # fused-update rungs: the routing gate's verdict ("pallas_routed",
    # the JAX package's name, kept so one table reads both packages)
    # and, on mesh rungs, the shard count.  The JAX package's VMEM keys
    # (tile, VMEM bytes and budget, interpret, mesh feasibility) have
    # no counterpart in the port, whose gate has no VMEM term; they are
    # copied when present, so a JAX stream summarizes the same here.
    "pallas_routed", "pallas_tile", "pallas_vmem_bytes", "pallas_interpret",
    "mesh_devices", "pallas_vmem_budget_bytes", "pallas_mesh_feasible",
)


def _r(x: float) -> float:
    return round(float(x), 6)


#: attrs copied (last write wins) into a fault row's "detail" string.
_FAULT_DETAIL_KEYS = (
    "what", "engine", "capacity", "stage", "lanes", "lanes_from", "lanes_to",
    "at", "unresolved", "error", "reason", "history", "barrier",
)


def _fault_detail(attrs: Mapping) -> str:
    parts = [f"{k}={attrs[k]}" for k in _FAULT_DETAIL_KEYS if k in attrs]
    return " ".join(parts)


def summarize(events: Iterable[Mapping], *, skipped_lines: int = 0) -> dict:
    events = list(events)
    spans: dict[str, dict] = {}
    phases: list[dict] = []
    phase_by_name: dict[str, dict] = {}
    checkers: dict[str, dict] = {}
    ladder: list[dict] = []
    dedup: dict[tuple, dict] = {}
    faults: dict[str, dict] = {}
    counters: dict[str, float] = {}
    gauges: dict[str, object] = {}
    serve_batch = {"count": 0, "requests": 0, "wall": 0.0, "occ": 0.0,
                   "waste": 0.0}
    serve_lat = {
        "serve.admission": {"count": 0, "total": 0.0, "max": 0.0},
        "serve.request": {"count": 0, "total": 0.0, "max": 0.0},
    }
    #: per-latency-class end-to-end latency (serve.request "tier" attr).
    serve_class: dict[str, dict] = {}
    #: continuous-batching accumulators: per-rung occupancy is averaged
    #: weighted by rung count (serve.batch spans carry the per-ladder
    #: mean + rung count; joiners admitted at rung boundaries).
    serve_cont = {"rungs": 0, "occ": 0.0, "joined": 0}
    #: bounded-memory accumulators (frontier.* counters/events + the
    #: device.buffer_bytes gauge's MAX — the gauges section keeps only
    #: the last write, which understates a run's true high-water mark).
    mem = {"device_bytes_peak": 0, "undecidable": 0}
    #: verdict-provenance accumulators (the provenance.* counter family:
    #: evidence bundles emitted per source/verdict + emission errors).
    prov = {"bundles": 0, "emit_errors": 0, "by_source": {}, "by_verdict": {}}
    #: streaming-verdict census (stream.verdict span events).
    stream_verdicts: dict[str, int] = {}
    wall = 0.0

    def _fault_row(name: str) -> dict:
        return faults.setdefault(
            name, {"fault": name[len("fault."):], "count": 0, "seconds": 0.0,
                   "detail": ""}
        )
    for ev in events:
        et = ev.get("type")
        t = float(ev.get("t") or 0.0)
        if et == "span":
            name = str(ev.get("name"))
            dur = float(ev.get("dur") or 0.0)
            wall = max(wall, t + dur)
            s = spans.setdefault(name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += dur
            s["max_s"] = max(s["max_s"], dur)
            attrs = ev.get("attrs") or {}
            if name.startswith("phase."):
                p = phase_by_name.get(name)
                if p is None:
                    p = phase_by_name[name] = {
                        "phase": name[len("phase."):], "wall_s": 0.0, "count": 0,
                    }
                    phases.append(p)  # first-seen order = lifecycle order
                p["wall_s"] += dur
                p["count"] += 1
                if ev.get("err"):
                    p["error"] = ev["err"]
            elif name == "checker.check":
                cn = str(attrs.get("checker", "?"))
                c = checkers.setdefault(
                    cn, {"checker": cn, "seconds": 0.0, "count": 0, "valid": None}
                )
                c["seconds"] += dur
                c["count"] += 1
                if "valid" in attrs:
                    c["valid"] = attrs["valid"]
                if ev.get("err"):
                    c["error"] = ev["err"]
            elif name == "ladder.stage":
                row = {
                    "stage": attrs.get("stage"),
                    "engine": attrs.get("engine"),
                    "capacity": attrs.get("capacity"),
                    "lanes": attrs.get("lanes"),
                    "seconds": _r(dur),
                }
                for k in _STAGE_KEYS:
                    if k in attrs:
                        row[k] = attrs[k]
                ladder.append(row)
            elif name in ("dedup.round", "dedup.mesh_round"):
                # per-round dedup timing probes (ops.hashing.
                # dedup_round_probe / sharded.mesh_round_probe): one
                # table row per (backend, shape, mesh width), averaging
                # repeated probes
                key = (
                    attrs.get("backend"), attrs.get("candidates"),
                    attrs.get("capacity"), attrs.get("mesh_devices"),
                )
                d = dedup.setdefault(key, {
                    "backend": attrs.get("backend"),
                    "candidates": attrs.get("candidates"),
                    "capacity": attrs.get("capacity"),
                    "probes": 0, "_total_us": 0.0,
                })
                if attrs.get("mesh_devices") is not None:
                    d["mesh_devices"] = int(attrs["mesh_devices"])
                d["probes"] += 1
                d["_total_us"] += float(attrs.get("per_round_us") or dur * 1e6)
                if "interpret" in attrs:
                    # probes tag their execution mode so plain-version
                    # rows never read as card rows in the rollup
                    d["interpret"] = bool(attrs["interpret"])
            elif name == "serve.batch":
                serve_batch["count"] += 1
                serve_batch["requests"] += int(attrs.get("requests") or 0)
                serve_batch["wall"] += dur
                serve_batch["occ"] += float(attrs.get("occupancy") or 0.0)
                serve_batch["waste"] += float(attrs.get("padding_waste") or 0.0)
                rungs = int(attrs.get("rungs") or 0)
                if rungs and attrs.get("continuous_occupancy") is not None:
                    serve_cont["rungs"] += rungs
                    serve_cont["occ"] += (
                        float(attrs["continuous_occupancy"]) * rungs
                    )
                serve_cont["joined"] += int(attrs.get("joined") or 0)
            elif name == "stream.verdict":
                v = str(attrs.get("verdict") or "?")
                stream_verdicts[v] = stream_verdicts.get(v, 0) + 1
            elif name in serve_lat:
                sl = serve_lat[name]
                sl["count"] += 1
                sl["total"] += dur
                sl["max"] = max(sl["max"], dur)
                if name == "serve.request" and attrs.get("tier"):
                    sc = serve_class.setdefault(
                        str(attrs["tier"]),
                        {"count": 0, "total": 0.0, "max": 0.0},
                    )
                    sc["count"] += 1
                    sc["total"] += dur
                    sc["max"] = max(sc["max"], dur)
            if name.startswith("fault."):
                f = _fault_row(name)
                f["count"] += 1
                f["seconds"] += dur
                if attrs:
                    f["detail"] = _fault_detail(attrs)
        elif et == "counter":
            wall = max(wall, t)
            name = str(ev.get("name"))
            counters[name] = counters.get(name, 0) + (ev.get("n") or 1)
            if name == "provenance.bundle":
                n = ev.get("n") or 1
                a = ev.get("attrs") or {}
                prov["bundles"] += n
                src = str(a.get("source") or "?")
                prov["by_source"][src] = prov["by_source"].get(src, 0) + n
                vd = str(a.get("verdict") or "?")
                prov["by_verdict"][vd] = prov["by_verdict"].get(vd, 0) + n
            elif name == "provenance.emit_error":
                prov["emit_errors"] += ev.get("n") or 1
            if name.startswith("fault."):
                f = _fault_row(name)
                f["count"] += ev.get("n") or 1
                if ev.get("attrs"):
                    f["detail"] = _fault_detail(ev["attrs"])
        elif et == "gauge":
            wall = max(wall, t)
            name = str(ev.get("name"))
            gauges[name] = ev.get("value")
            if name == "device.buffer_bytes":
                try:
                    mem["device_bytes_peak"] = max(
                        mem["device_bytes_peak"], int(ev.get("value") or 0))
                except (TypeError, ValueError):
                    pass
        elif et == "event":
            wall = max(wall, t)
            name = str(ev.get("name"))
            if name == "frontier.undecidable":
                mem["undecidable"] += 1
            if name.startswith("fault."):
                f = _fault_row(name)
                f["count"] += 1
                if ev.get("attrs"):
                    f["detail"] = _fault_detail(ev["attrs"])
    for p in phases:
        p["wall_s"] = _r(p["wall_s"])
    out_checkers = sorted(checkers.values(), key=lambda c: -c["seconds"])
    for c in out_checkers:
        c["seconds"] = _r(c["seconds"])
    ladder.sort(key=lambda r: (r["stage"] is None, r["stage"]))
    out_dedup = []
    for d in dedup.values():
        d["per_round_us"] = round(d.pop("_total_us") / max(1, d["probes"]), 1)
        out_dedup.append(d)
    out_dedup.sort(key=lambda d: (str(d["backend"]), d["candidates"] or 0))
    for name, s in spans.items():
        s["total_s"] = _r(s["total_s"])
        s["max_s"] = _r(s["max_s"])
    out_faults = [faults[k] for k in sorted(faults)]
    for f in out_faults:
        f["seconds"] = _r(f["seconds"])
    serve: dict = {}
    if serve_batch["count"]:
        nb = serve_batch["count"]
        serve.update(
            batches=nb,
            requests=serve_batch["requests"],
            batch_wall_s=_r(serve_batch["wall"]),
            avg_batch_requests=round(serve_batch["requests"] / nb, 2),
            avg_occupancy=round(serve_batch["occ"] / nb, 4),
            avg_padding_waste=round(serve_batch["waste"] / nb, 4),
        )
    if serve_cont["rungs"]:
        serve["continuous_occupancy"] = round(
            serve_cont["occ"] / serve_cont["rungs"], 4
        )
        serve["rungs"] = serve_cont["rungs"]
    if serve_cont["joined"]:
        serve["rung_joined"] = serve_cont["joined"]
    for span_name, out_key in (("serve.admission", "admission"),
                               ("serve.request", "request")):
        sl = serve_lat[span_name]
        if sl["count"]:
            serve[out_key] = {
                "count": sl["count"],
                "mean_s": _r(sl["total"] / sl["count"]),
                "max_s": _r(sl["max"]),
            }
    if serve_class:
        serve["request_by_class"] = {
            tier: {
                "count": sc["count"],
                "mean_s": _r(sc["total"] / sc["count"]),
                "max_s": _r(sc["max"]),
            }
            for tier, sc in sorted(serve_class.items())
        }
    memory: dict = {}
    mem_counters = {
        "spill_rows": "frontier.spill_rows",
        "spill_bytes": "frontier.spill_bytes",
        "spill_merges": "frontier.spill_merges",
        "factorizations": "frontier.factorizations",
        "oom_spills": "fault.oom.spill",
    }
    for out_key, cname in mem_counters.items():
        if cname in counters:
            memory[out_key] = counters[cname]
    if mem["device_bytes_peak"]:
        memory["device_bytes_peak"] = mem["device_bytes_peak"]
    if mem["undecidable"]:
        memory["undecidable"] = mem["undecidable"]
    elle = [
        {"stage": name[len("elle."):], "seconds": s["total_s"],
         "count": s["count"], "max_s": s["max_s"]}
        for name, s in spans.items() if name.startswith("elle.")
    ]
    for cname in ("submitted", "completed", "rejected", "expired", "drained",
                  "fastpath_resolved", "fastpath_escalated",
                  "graphs", "graph_batches",
                  # self-healing layer (serve.health)
                  "quarantined", "quarantine_hit", "breaker_rejected",
                  "breaker_opened", "watchdog_trip", "journal_replayed",
                  "placement_replaced", "drain_error"):
        if f"serve.{cname}" in counters:
            serve[cname] = counters[f"serve.{cname}"]
    fleet: dict = {}
    for cname in ("routed", "spilled", "parked", "fenced", "resubmitted",
                  "rollouts"):
        if f"fleet.{cname}" in counters:
            fleet[cname] = counters[f"fleet.{cname}"]
    for gname in ("replicas", "replicas_healthy"):
        if f"fleet.{gname}" in gauges:
            fleet[gname] = gauges[f"fleet.{gname}"]
    if "fleet.rollout" in spans:
        ro = spans["fleet.rollout"]
        fleet["rollout"] = {"count": ro["count"], "total_s": ro["total_s"],
                            "max_s": ro["max_s"]}
    streams: dict = {}
    for cname, out_key in (("stream.opened", "opened"),
                           ("stream.closed", "closed"),
                           ("stream.rejected", "rejected"),
                           ("stream.ops", "ops"),
                           ("stream.rescan", "rescans")):
        if cname in counters:
            streams[out_key] = counters[cname]
    for sname, out_key in (("stream.epoch", "epochs"),
                           ("stream.session", "session")):
        if sname in spans:
            sp = spans[sname]
            streams[out_key] = {"count": sp["count"],
                                "total_s": sp["total_s"],
                                "max_s": sp["max_s"]}
    if stream_verdicts:
        streams["verdicts"] = dict(sorted(stream_verdicts.items()))
    from jepsen_tpu_torch.obs import critpath as _critpath

    out = {
        "version": 1,
        "wall_s": _r(wall),
        "phases": phases,
        "checkers": out_checkers,
        "serve": serve,
        "fleet": fleet,
        "streams": streams,
        "ladder": ladder,
        "dedup": out_dedup,
        "elle": elle,
        "memory": memory,
        "provenance": (
            {k: v for k, v in prov.items() if v}
            if prov["bundles"] or prov["emit_errors"] else {}
        ),
        "faults": out_faults,
        "critpath": _critpath.critpath_rollup(events),
        "counters": counters,
        "gauges": gauges,
        "spans": spans,
    }
    if skipped_lines:
        out["telemetry"] = {"skipped_lines": int(skipped_lines)}
    return out


# ---------------------------------------------------------------------------
# Text rendering
# ---------------------------------------------------------------------------


def _mb(b) -> str:
    """Bytes as a compact MB cell ('' when the stage never sampled;
    sub-0.1MB footprints keep three decimals so CPU-backend samples
    don't render as an ambiguous 0.0)."""
    if not b:
        return ""
    mb = float(b) / 1e6
    return str(round(mb, 1 if mb >= 0.1 else 3))


def _fmt_row(cells, widths) -> str:
    return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()


def _table(headers: list[str], rows: list[list]) -> str:
    widths = [
        max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
        for i, h in enumerate(headers)
    ]
    lines = [_fmt_row(headers, widths), _fmt_row(["-" * w for w in widths], widths)]
    lines += [_fmt_row(r, widths) for r in rows]
    return "\n".join(lines)


def format_summary(summary: Mapping) -> str:
    """Human-readable phase / checker / ladder tables for a summary dict."""
    parts: list[str] = [f"telemetry summary (wall {summary.get('wall_s', 0)} s)"]
    if summary.get("phases"):
        parts.append("\nphases:")
        parts.append(_table(
            ["phase", "wall_s", "count"],
            [[p["phase"], p["wall_s"], p["count"]] for p in summary["phases"]],
        ))
    if summary.get("checkers"):
        parts.append("\ncheckers:")
        parts.append(_table(
            ["checker", "seconds", "count", "valid?"],
            [[c["checker"], c["seconds"], c["count"], c.get("valid")]
             for c in summary["checkers"]],
        ))
    if summary.get("serve"):
        s = summary["serve"]
        parts.append("\ncheck service:")
        rows = [[k, s[k]] for k in (
            "batches", "requests", "batch_wall_s", "avg_batch_requests",
            "avg_occupancy", "avg_padding_waste", "continuous_occupancy",
            "rungs", "rung_joined", "fastpath_resolved",
            "fastpath_escalated", "submitted", "completed",
            "rejected", "expired", "drained") if k in s]
        for key, label in (("admission", "admission wait"),
                           ("request", "request latency")):
            if key in s:
                lat = s[key]
                rows.append([f"{label} mean_s", lat["mean_s"]])
                rows.append([f"{label} max_s", lat["max_s"]])
        for tier, lat in (s.get("request_by_class") or {}).items():
            rows.append([f"request[{tier}] mean_s", lat["mean_s"]])
            rows.append([f"request[{tier}] max_s", lat["max_s"]])
        parts.append(_table(["serve", "value"], rows))
    if summary.get("fleet"):
        fle = summary["fleet"]
        parts.append("\nfleet (front-door router):")
        rows = [[k, fle[k]] for k in (
            "routed", "spilled", "parked", "fenced", "resubmitted",
            "rollouts", "replicas", "replicas_healthy") if k in fle]
        if "rollout" in fle:
            rows.append(["rollout total_s", fle["rollout"]["total_s"]])
            rows.append(["rollout max_s", fle["rollout"]["max_s"]])
        parts.append(_table(["fleet", "value"], rows))
    if summary.get("streams"):
        st = summary["streams"]
        parts.append("\nstreams (online checking):")
        rows = [[k, st[k]] for k in (
            "opened", "closed", "rejected", "ops", "rescans") if k in st]
        for key, label in (("epochs", "epoch"), ("session", "session")):
            if key in st:
                rows.append([f"{label} count", st[key]["count"]])
                rows.append([f"{label} total_s", st[key]["total_s"]])
                rows.append([f"{label} max_s", st[key]["max_s"]])
        for vd, n in (st.get("verdicts") or {}).items():
            rows.append([f"verdict[{vd}]", n])
        parts.append(_table(["stream", "value"], rows))
    if summary.get("ladder"):
        headers = ["stage", "engine", "capacity", "lanes", "seconds",
                   "resolved", "refuted", "unknowns", "launches",
                   "compile_s", "execute_s", "peak", "lossy", "dedup",
                   "dev_MB"]
        rows = []
        for r in summary["ladder"]:
            rows.append([
                r.get("stage"), r.get("engine"), r.get("capacity"),
                r.get("lanes"), r.get("seconds"), r.get("resolved", ""),
                r.get("refuted", ""), r.get("unknowns_remaining", ""),
                r.get("launches", ""), r.get("compile_s", ""),
                r.get("execute_s", ""), r.get("peak_frontier", ""),
                r.get("lossy", ""), r.get("dedup", ""),
                _mb(r.get("device_bytes_peak")),
            ])
        parts.append("\nladder stages:")
        parts.append(_table(headers, rows))
    if summary.get("dedup"):
        parts.append("\ndedup rounds (per-round probe, per backend; "
                     "interp=True marks Pallas-interpreter timings):")
        parts.append(_table(
            ["backend", "candidates", "capacity", "probes", "per_round_us",
             "interp"],
            [[d.get("backend"), d.get("candidates"), d.get("capacity"),
              d.get("probes"), d.get("per_round_us"),
              d.get("interpret", "")]
             for d in summary["dedup"]],
        ))
    if summary.get("elle"):
        parts.append("\nelle inference (column-native substages):")
        parts.append(_table(
            ["stage", "seconds", "count", "max_s"],
            [[e.get("stage"), e.get("seconds"), e.get("count"),
              e.get("max_s")] for e in summary["elle"]],
        ))
    if summary.get("memory"):
        mm = summary["memory"]
        parts.append("\nmemory (host spill / factorization / device peak):")
        rows = [[k, mm[k]] for k in (
            "device_bytes_peak", "spill_rows", "spill_bytes", "spill_merges",
            "factorizations", "oom_spills", "undecidable") if k in mm]
        parts.append(_table(["memory", "value"], rows))
    if summary.get("provenance"):
        pv = summary["provenance"]
        parts.append("\nverdict provenance (evidence bundles emitted):")
        rows = [["bundles", pv.get("bundles", 0)]]
        for src, n in sorted((pv.get("by_source") or {}).items()):
            rows.append([f"bundles[{src}]", n])
        for vd, n in sorted((pv.get("by_verdict") or {}).items()):
            rows.append([f"verdict[{vd}]", n])
        if pv.get("emit_errors"):
            rows.append(["emit_errors", pv["emit_errors"]])
        parts.append(_table(["provenance", "value"], rows))
    if summary.get("critpath", {}).get("spans"):
        cp = summary["critpath"]
        parts.append(
            f"\ncritical path ({cp.get('total_s', 0)} s on-path of "
            f"{cp.get('wall_s', 0)} s wall):")
        parts.append(_table(
            ["span", "critpath_s", "inclusive_s", "count", "slack_s"],
            [[r.get("span"), r.get("cp_s"), r.get("total_s"),
              r.get("count"), r.get("slack_s")]
             for r in cp["spans"]],
        ))
    if summary.get("telemetry", {}).get("skipped_lines"):
        parts.append(
            f"\ntelemetry: {summary['telemetry']['skipped_lines']} "
            "malformed jsonl line(s) skipped")
    if summary.get("faults"):
        parts.append("\nfaults (retries / degradations / checkpoints / deadline):")
        parts.append(_table(
            ["fault", "count", "seconds", "detail"],
            [[f.get("fault"), f.get("count"), f.get("seconds", ""),
              f.get("detail", "")] for f in summary["faults"]],
        ))
    if summary.get("counters"):
        parts.append("\ncounters:")
        parts.append(_table(
            ["counter", "total"],
            [[k, v] for k, v in sorted(summary["counters"].items())],
        ))
    if summary.get("gauges"):
        parts.append("\ngauges:")
        parts.append(_table(
            ["gauge", "value"],
            [[k, v] for k, v in sorted(summary["gauges"].items())],
        ))
    return "\n".join(parts) + "\n"
