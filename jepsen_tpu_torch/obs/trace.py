"""Convert a telemetry event stream into Chrome/Perfetto trace-event JSON.

The port's copy of the JAX package's ``obs.trace``: the same stream
exports to the same JSON.  On the card every launch span carries
``devices=[0]``, so the export has one ``device 0`` lane.

The ``telemetry.jsonl`` stream is already span-shaped (monotonic start +
duration, parent links, trace ids); this module maps it onto the Chrome
trace-event format (the JSON Perfetto and ``chrome://tracing`` load):

  * one LANE (tid) per request trace id — every event stamped with that
    single ``"trace"`` carries the request's journey (HTTP admission →
    queued wait → demux) on its own row, named after the id;
  * one LANE per DEVICE — device-attributed LAUNCH spans
    (``ladder.launch``, ``sharded.launch``, ``sharded.lane_launch``;
    the lane-shard placement stamps every member device) render once
    per device on a ``device N`` row with a stable
    ``thread_sort_index``, so a multi-device run reads as a per-chip
    timeline instead of interleaved garbage (``ladder.stage`` carries
    the attr too but stays on the ladder lane — its launches already
    paint the device lanes);
  * a shared **ladder** lane (tid 0) for remaining process/shared-batch
    spans (``serve.batch``, confirmation drains) — their member trace
    ids ride along in ``args`` so a lane's request can be found from
    the shared span and vice versa;
  * counter tracks (``ph: "C"``) for the live gauges (queue depth —
    total AND one track per latency class (``serve.queue_depth.*``),
    unknowns remaining, device buffer bytes), on their own dedicated
    lane instead of the device lane.

Timestamps are microseconds since the recording opened; the header
``meta`` event's ``t0`` epoch (obs.Recorder) is preserved in
``otherData`` so traces from different processes can be aligned, and
``otherData.skipped_lines`` reports truncated/corrupt jsonl lines the
tolerant reader dropped.

Stdlib-only.  To export a recorded run::

    events, skipped = read_jsonl_events("<dir>/telemetry.jsonl")
    trace = to_trace_events(events, skipped_lines=skipped)
    Path("trace.json").write_text(json.dumps(trace))
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Mapping

from jepsen_tpu_torch.obs.critpath import span_devices as _span_devices

__all__ = ["align_streams", "merge_aligned_events", "read_jsonl_events",
           "to_trace_events"]

#: gauges worth a Perfetto counter track (point samples over time).
_COUNTER_GAUGES = {
    "serve.queue_depth",
    "ladder.unknowns_remaining",
    "device.buffer_bytes",
    "confirm.queue_latency_s",
    "serve.rung_occupancy",
}

#: gauge-name prefixes that are counter-track families (one track per
#: member name — the latency-class queue lanes).
_COUNTER_PREFIXES = ("serve.queue_depth.",)

_LADDER_TID = 0
#: the dedicated counter-track lane.
_COUNTER_TID = 1
#: device lanes: tid = _DEVICE_TID_BASE + device id.
_DEVICE_TID_BASE = 1000
#: request lanes start here (arrival order).
_REQUEST_TID_BASE = 2000
#: stream lanes (one per live stream session id) start here.
_STREAM_TID_BASE = 3000

#: span names eligible for per-device rendering (device-attributed
#: launches; ladder.stage stays on the ladder lane — its launches
#: already render per device and duplicating the enclosing stage would
#: double-paint the timeline).
_DEVICE_SPAN_NAMES = {"ladder.launch", "sharded.lane_launch",
                      "sharded.launch"}


def read_jsonl_events(path: Path | str) -> tuple[list[dict], int]:
    """Tolerant ``telemetry.jsonl`` reader: a crashed process may leave
    the LAST line truncated mid-write — skip unparseable lines instead
    of failing the whole stream.  Returns ``(events, skipped)`` so the
    skip count travels with the data (``summarize(...,
    skipped_lines=)`` reports it as ``telemetry.skipped_lines``).  Raises
    ``FileNotFoundError`` for a missing file and ``ValueError`` when
    not a single line parses (a clearly-not-telemetry input deserves a
    loud error, not an empty trace)."""
    path = Path(path)
    text = path.read_text()
    events: list[dict] = []
    skipped = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        if isinstance(ev, dict):
            events.append(ev)
        else:
            skipped += 1
    if not events and skipped:
        raise ValueError(
            f"{path}: no parseable telemetry events "
            f"({skipped} malformed line(s))"
        )
    return events, skipped


def _stream_meta(events: Iterable[Mapping]) -> dict:
    return next((e for e in events if e.get("type") == "meta"), {})


#: router-side spans whose start must precede the replica-side request
#: span under the same trace — the ordering invariant clock alignment
#: is supposed to restore (align_streams measures its violations as
#: residual skew).
_ROUTER_REQUEST_SPANS = ("fleet.route", "fleet.resubmit")
_REPLICA_REQUEST_SPANS = ("serve.request", "serve.admission")


def align_streams(streams: Iterable) -> tuple[list[dict], dict]:
    """Clock-align N recorder streams onto one common epoch.

    Each recorder's event ``t`` fields are monotonic offsets from ITS
    OWN open; the ``meta`` header's ``t0`` epoch (obs.Recorder) is what
    makes them comparable: epoch time = t0 + t.  This rebases every
    stream onto the EARLIEST t0 (offset = t0_i - min t0) — the fix for
    the old single-recorder assumption where merging streams with
    differing ``t0`` silently interleaved unrelated clocks.

    ``streams``: iterable of ``(label, events)`` or ``(label, events,
    skipped)``.  Returns ``(aligned, info)``:

      * ``aligned`` — one dict per stream: ``label``, ``meta``,
        ``offset_s`` (seconds added to every event ``t``), ``skipped``,
        and ``events`` (rebased COPIES; the input is not mutated).
      * ``info`` — ``t0`` (the common epoch), ``offsets`` per label,
        ``missing_t0`` (labels aligned at offset 0 because their meta
        header carried no epoch), ``cross_process_traces`` (trace ids
        whose events landed in more than one stream — the hop-spanning
        requests), and ``residual_skew_s``: the largest POST-ALIGNMENT
        causality violation between a router-side ``fleet.route``/
        ``fleet.resubmit`` span and the same trace's replica-side
        ``serve.request`` start (0.0 when the epochs agree; wall clocks
        are not monotonic across hosts, so the residue is reported, not
        hidden).
    """
    rows: list[dict] = []
    for s in streams:
        label, events = s[0], list(s[1])
        skipped = int(s[2]) if len(s) > 2 else 0
        meta = _stream_meta(events)
        t0 = meta.get("t0", meta.get("wall-clock"))
        rows.append({"label": str(label), "meta": meta, "skipped": skipped,
                     "t0": float(t0) if t0 is not None else None,
                     "raw": events})
    known = [r["t0"] for r in rows if r["t0"] is not None]
    ref = min(known) if known else 0.0
    missing = [r["label"] for r in rows if r["t0"] is None]

    aligned: list[dict] = []
    trace_streams: dict[str, set[int]] = {}
    route_starts: dict[str, float] = {}   # trace -> earliest router span t
    request_starts: dict[str, float] = {}  # trace -> earliest replica span t
    for i, r in enumerate(rows):
        off = (r["t0"] - ref) if r["t0"] is not None else 0.0
        events = []
        for ev in r["raw"]:
            if "t" in ev:
                ev = {**ev, "t": round(float(ev["t"] or 0.0) + off, 6)}
            events.append(ev)
            tr = ev.get("trace")
            if isinstance(tr, str):
                trace_streams.setdefault(tr, set()).add(i)
                if ev.get("type") == "span":
                    name, t = str(ev.get("name")), float(ev.get("t") or 0.0)
                    if name in _ROUTER_REQUEST_SPANS:
                        route_starts[tr] = min(
                            route_starts.get(tr, t), t)
                    elif name in _REPLICA_REQUEST_SPANS:
                        request_starts[tr] = min(
                            request_starts.get(tr, t), t)
        aligned.append({"label": r["label"], "meta": r["meta"],
                        "offset_s": round(off, 6), "skipped": r["skipped"],
                        "events": events})

    skew = 0.0
    pairs = 0
    for tr, t_route in route_starts.items():
        t_req = request_starts.get(tr)
        if t_req is None or len(trace_streams.get(tr, ())) < 2:
            continue
        pairs += 1
        # the route span opens before the replica accepts; a replica
        # span that reads as STARTING EARLIER is clock skew
        skew = max(skew, t_route - t_req)
    info = {
        "t0": ref if known else None,
        "offsets": {a["label"]: a["offset_s"] for a in aligned},
        "missing_t0": missing,
        "cross_process_traces": sorted(
            tr for tr, ss in trace_streams.items() if len(ss) > 1),
        "residual_skew_s": round(max(0.0, skew), 6),
        "skew_pairs": pairs,
    }
    return aligned, info


def merge_aligned_events(aligned: Iterable[Mapping]) -> list[dict]:
    """One time-ordered event list from ``align_streams`` output — what
    the summarizer and the per-request decomposition consume.  Only the
    reference stream's ``meta`` header survives (a merged stream has
    exactly one epoch; N meta rows would re-introduce the ambiguity the
    alignment just removed)."""
    aligned = list(aligned)
    merged: list[dict] = []
    kept_meta = False
    for a in sorted(aligned, key=lambda a: a.get("offset_s") or 0.0):
        for ev in a["events"]:
            if ev.get("type") == "meta":
                if kept_meta:
                    continue
                kept_meta = True
            merged.append(ev)
    merged.sort(key=lambda ev: (ev.get("type") != "meta",
                                float(ev.get("t") or 0.0)))
    return merged


def _us(t) -> float:
    return round(float(t or 0.0) * 1e6, 1)


def to_trace_events(events: Iterable[Mapping], *,
                    skipped_lines: int = 0) -> dict:
    """Map a telemetry event stream to ``{"traceEvents": [...]}``
    (Chrome trace-event JSON; Perfetto-loadable)."""
    events = list(events)
    meta = next((e for e in events if e.get("type") == "meta"), {})
    pid = int(meta.get("pid") or 1)
    out: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid,
         "args": {"name": f"jepsen-tpu ({meta.get('host', '?')})"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": _LADDER_TID,
         "args": {"name": "ladder/shared"}},
        # stable ordering: ladder lane on top, then one lane per device,
        # then the counter tracks, requests below in arrival order
        {"ph": "M", "name": "thread_sort_index", "pid": pid,
         "tid": _LADDER_TID, "args": {"sort_index": -1000}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": _COUNTER_TID,
         "args": {"name": "counters"}},
        {"ph": "M", "name": "thread_sort_index", "pid": pid,
         "tid": _COUNTER_TID, "args": {"sort_index": -100}},
    ]
    lanes: dict[str, int] = {}
    device_lanes: dict[int, int] = {}
    stream_lanes: dict[str, int] = {}

    def stream_lane(sid: str) -> int:
        """One lane per live stream session: the ``stream.*`` spans
        (epoch advances, verdict latches, session wall) render as a
        per-stream timeline instead of riding the session's request
        lane."""
        tid = stream_lanes.get(sid)
        if tid is None:
            tid = stream_lanes[sid] = _STREAM_TID_BASE + len(stream_lanes)
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": f"stream {sid}"},
            })
            out.append({
                "ph": "M", "name": "thread_sort_index", "pid": pid,
                "tid": tid, "args": {"sort_index": -500 + len(stream_lanes)},
            })
        return tid

    def lane_of(trace) -> int:
        """tid for one request's lane; shared (list) traces and
        untraced events ride the ladder lane."""
        if not isinstance(trace, str):
            return _LADDER_TID
        tid = lanes.get(trace)
        if tid is None:
            tid = lanes[trace] = _REQUEST_TID_BASE + len(lanes)
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": f"request {trace}"},
            })
        return tid

    def device_lane(dev: int) -> int:
        tid = device_lanes.get(dev)
        if tid is None:
            tid = device_lanes[dev] = _DEVICE_TID_BASE + dev
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": f"device {dev}"},
            })
            out.append({
                "ph": "M", "name": "thread_sort_index", "pid": pid,
                "tid": tid, "args": {"sort_index": -900 + dev},
            })
        return tid

    for ev in events:
        et = ev.get("type")
        tr = ev.get("trace")
        if et == "span":
            name = str(ev.get("name"))
            args = dict(ev.get("attrs") or {})
            if tr is not None:
                args["trace"] = tr
            if ev.get("parent"):
                args["parent"] = ev["parent"]
            if ev.get("err"):
                args["err"] = ev["err"]
            sid = args.get("stream")
            tid = (stream_lane(str(sid))
                   if name.startswith("stream.") and sid is not None
                   else lane_of(tr))
            row = {
                "ph": "X", "name": name, "pid": pid,
                "tid": tid, "ts": _us(ev.get("t")),
                "dur": max(1.0, _us(ev.get("dur"))), "args": args,
            }
            devs = (_span_devices(ev)
                    if name in _DEVICE_SPAN_NAMES else [])
            if devs:
                # device-attributed launches render once per member
                # device — the per-chip timeline
                for d in devs:
                    out.append({**row, "tid": device_lane(d)})
            else:
                out.append(row)
        elif et == "gauge":
            name = str(ev.get("name"))
            v = ev.get("value")
            track = (name in _COUNTER_GAUGES
                     or name.startswith(_COUNTER_PREFIXES))
            if track and isinstance(v, (int, float)):
                out.append({
                    "ph": "C", "name": name, "pid": pid,
                    "tid": _COUNTER_TID,
                    "ts": _us(ev.get("t")), "args": {"value": v},
                })
        elif et == "event":
            name = str(ev.get("name"))
            args = dict(ev.get("attrs") or {})
            if tr is not None:
                args["trace"] = tr
            sid = args.get("stream")
            tid = (stream_lane(str(sid))
                   if name.startswith("stream.") and sid is not None
                   else lane_of(tr))
            out.append({
                "ph": "i", "name": name, "pid": pid,
                "tid": tid, "ts": _us(ev.get("t")), "s": "t",
                "args": args,
            })
        # counters are cumulative noise at trace zoom; the summary has them
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "t0": meta.get("t0", meta.get("wall-clock")),
            "host": meta.get("host"),
            "pid": meta.get("pid"),
            "requests": len(lanes),
            "devices": len(device_lanes),
            "streams": len(stream_lanes),
            "skipped_lines": int(skipped_lines),
        },
    }
