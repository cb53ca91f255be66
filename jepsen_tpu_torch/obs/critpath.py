"""Flight analyzer: latency decomposition, critical-path extraction,
and per-device bubble attribution over a telemetry event stream.

The port's copy of the JAX package's ``obs.critpath``, equal to it on
the same event stream.  The span stream records WHAT happened; this
module answers WHY a request took what it took and WHERE the idle time
lives — the analysis layer between ``telemetry.jsonl`` and a scheduling decision:

  * ``decompose_requests(events)`` — reconstruct each request's
    lifecycle from its trace id (admission → class-queue wait →
    pack/rung-join wait → shared-launch residence → confirm/demux
    tail) into a ``{stage: seconds}`` breakdown whose sum reconciles
    EXACTLY with the recorded ``serve.request`` end-to-end latency
    (the residual the span algebra can't attribute is named
    ``other_s``, never silently dropped).
  * ``critical_path(events)`` — over the run's span DAG (interval
    containment + the parent links ``obs.Ctx`` propagation records),
    the chain of span segments that bounds wall clock, per-span
    critical seconds (self time on the path, children excluded), and
    per-span slack (how much later a span could have finished without
    moving wall clock).  Total critical seconds ≤ run wall clock by
    construction.
  * ``device_timeline(events)`` — per-device busy/idle fractions and
    the bubble ratio from device-attributed launch spans
    (``ladder.launch``/``ladder.stage`` carry a ``devices`` attr; a
    ``lane_shard`` placement stamps every member device), plus an
    imbalance figure (max − min busy fraction).  The port runs on one
    card, and every launch span stamps that card's index once, logical
    mesh shards included (``parallel.mesh``), so busy time is never
    counted once per shard.

Stdlib-only and pure over event dicts: ``obs.summary`` embeds the
critical-path rollup in every ``telemetry.json``, and the
``format_*`` functions render the three tables as text.
"""

from __future__ import annotations

from typing import Iterable, Mapping

__all__ = [
    "LAUNCH_SPANS", "Span", "critical_path", "decompose_requests",
    "device_timeline", "extract_spans", "format_critpath",
    "format_devices", "format_requests",
]

#: span names that represent a request's shared-launch residence, in
#: the order the decomposition searches them (a request rides exactly
#: one of these per lifecycle).
LAUNCH_SPANS = ("serve.batch", "serve.fastpath", "serve.graph_batch",
                "serve.graph")

#: interval tolerance: event ``t``/``dur`` are QUANTIZED to 1 µs by the
#: recorder (round(x, 6)), so containment/ordering comparisons must
#: absorb up to ~1 µs of rounding slop on each endpoint — a tolerance
#: below the quantization would misread genuinely nested spans as
#: concurrent roots and corrupt the attribution.
#: (Sub-2 µs segments fall below timestamp resolution and are dropped.)
_EPS = 2e-6


class Span:
    """One span instance from the stream (events carry name-based
    parent links only; instances are resolved by interval
    containment)."""

    __slots__ = ("name", "t", "dur", "end", "parent", "attrs", "trace",
                 "thread", "children", "cp_s", "slack_s")

    def __init__(self, ev: Mapping):
        self.name = str(ev.get("name"))
        self.t = float(ev.get("t") or 0.0)
        self.dur = max(0.0, float(ev.get("dur") or 0.0))
        self.end = self.t + self.dur
        self.parent = ev.get("parent")
        self.attrs = ev.get("attrs") or {}
        self.trace = ev.get("trace")
        self.thread = ev.get("thread")
        self.children: list[Span] = []
        self.cp_s = 0.0        # seconds on the critical path (self time)
        self.slack_s = None    # filled by critical_path

    def __repr__(self):  # pragma: no cover — debugging aid
        return f"Span({self.name!r}, t={self.t:.6f}, dur={self.dur:.6f})"


def extract_spans(events: Iterable[Mapping]) -> list["Span"]:
    """Every span-shaped event as a ``Span``, stream order preserved."""
    return [Span(ev) for ev in events if ev.get("type") == "span"]


# ---------------------------------------------------------------------------
# Per-request latency decomposition
# ---------------------------------------------------------------------------


def decompose_requests(events: Iterable[Mapping]) -> dict[str, dict]:
    """``{trace_id: {route_s, queue_s, pack_s, launch_s, confirm_s,
    other_s, total_s, tier, verdict, launch_span}}`` for every request
    whose end-to-end ``serve.request`` span landed in the stream.

    Stage algebra (every request's stages SUM to its ``total_s``):

      * ``route_s``   — the router hop (fleet deployments only): the
        ``fleet.route`` span stamped with this trace starts at router
        admission; the replica-side ``serve.request`` span starts at
        replica accept.  With the two recorder streams clock-aligned
        (obs.trace.align_streams), the gap between those starts IS the
        hop cost, and ``total_s`` grows by exactly it — reconciling
        router-side and replica-side stamps instead of trusting either
        alone.  0 when no route span carries the trace (single-process
        runs, or the router stream wasn't merged in).
      * ``queue_s``   — the ``serve.admission`` span: submit → picked
        into a wave/batch (the class-queue wait; a rung joiner's
        admission ends at its join boundary).
      * ``pack_s``    — picked → the shared launch span's start
        (service-side packing / placement / feeder overhead).
      * ``launch_s``  — residence inside the shared launch span
        (``serve.batch`` / ``serve.fastpath`` / ``serve.graph*``),
        clipped to the request's own lifetime.
      * ``confirm_s`` — the post-launch tail: the request outlived the
        shared span (confirmation drain, late demux).
      * ``other_s``   — the residual the spans above don't cover
        (e.g. a request resolved with no launch span at all: trivial
        fast paths, quarantine hits, queue expiry).
    """
    spans = extract_spans(events)
    requests: dict[str, Span] = {}
    admissions: dict[str, Span] = {}
    routes: dict[str, Span] = {}
    #: trace id -> the launch spans stamped with it (one indexing pass:
    #: the per-request loop must not scan every launch's member list —
    #: long recordings carry thousands of both).
    launches_by_tid: dict[str, list[Span]] = {}
    for s in spans:
        if s.name == "serve.request" and isinstance(s.trace, str):
            requests[s.trace] = s
        elif s.name == "serve.admission" and isinstance(s.trace, str):
            admissions[s.trace] = s
        elif s.name == "fleet.route" and isinstance(s.trace, str):
            # earliest route attempt wins: resubmission re-routes open
            # later and must not shrink the measured hop
            if s.trace not in routes or s.t < routes[s.trace].t:
                routes[s.trace] = s
        elif s.name in LAUNCH_SPANS:
            members = s.trace if s.trace is not None else ()
            if isinstance(members, str):
                members = (members,)
            extra = (s.attrs or {}).get("trace_ids") or ()
            seen = set()
            for tid in list(members) + list(extra):
                if isinstance(tid, str) and tid not in seen:
                    seen.add(tid)
                    launches_by_tid.setdefault(tid, []).append(s)
    out: dict[str, dict] = {}
    for tid, req in requests.items():
        total = req.dur
        t_sub, t_done = req.t, req.end
        # router hop: route span start (router admission) → request
        # span start (replica accept).  Only a route that genuinely
        # precedes the request counts — a negative gap is residual
        # clock skew the alignment already reported, not a stage.
        route = 0.0
        rt = routes.get(tid)
        if rt is not None and rt.t <= t_sub + _EPS:
            route = max(0.0, t_sub - rt.t)
            total += route
        adm = admissions.get(tid)
        queue = min(total, adm.dur) if adm is not None else 0.0
        t_picked = t_sub + queue
        # the launch span this request rode: the first one stamped with
        # its trace that overlaps its post-queue lifetime
        ride = None
        for ls in launches_by_tid.get(tid, ()):
            if ls.end > t_picked - _EPS and ls.t < t_done + _EPS:
                if ride is None or ls.t < ride.t:
                    ride = ls
        pack = launch = confirm = 0.0
        if ride is not None:
            l_start = max(t_picked, ride.t)
            l_end = min(ride.end, t_done)
            pack = max(0.0, min(ride.t, t_done) - t_picked)
            launch = max(0.0, l_end - l_start)
            confirm = max(0.0, t_done - max(ride.end, t_picked))
        other = total - (route + queue + pack + launch + confirm)
        if other < 0:
            # float rounding (event "t"/"dur" are rounded to µs): fold
            # the deficit back into the launch residence so the stages
            # still sum exactly
            launch = max(0.0, launch + other)
            other = 0.0
        row = {
            "route_s": round(route, 6),
            "queue_s": round(queue, 6),
            "pack_s": round(pack, 6),
            "launch_s": round(launch, 6),
            "confirm_s": round(confirm, 6),
            "other_s": round(other, 6),
            "total_s": round(total, 6),
            "tier": (req.attrs or {}).get("tier"),
            "verdict": (req.attrs or {}).get("verdict"),
            "launch_span": ride.name if ride is not None else None,
        }
        out[tid] = row
    return out


# ---------------------------------------------------------------------------
# Critical-path extraction
# ---------------------------------------------------------------------------


#: span names EXCLUDED from the critical-path structure: per-request
#: lifecycle measurements (serve.request covers submit→resolve and
#: would swallow the execution spans it merely re-measures — the
#: decomposition is their consumer, not the path).
_PATH_EXCLUDE = {"serve.request", "serve.admission", "fleet.route",
                 "fleet.resubmit", "fleet.spill"}


def _build_forest(spans: list[Span]) -> list[Span]:
    """Nest span instances by INTERVAL CONTAINMENT WITHIN A THREAD (a
    stack sweep over start-sorted spans per thread group, O(n log n)):
    a span's parent is the smallest open same-thread span whose
    interval contains it.  A single thread's overlapping spans are
    always genuinely nested; same-interval spans on DIFFERENT threads
    are concurrent work (parallel arms, confirm drains, graph-pool
    tasks) that must never be charged inside each other — they stay
    roots and the backward sweep arbitrates between them.  The
    recorded name-based parent links are cross-thread breadcrumbs, not
    timing structure.  Events without a ``thread`` stamp (pre-analyzer
    recordings) fall back to one containment-only group."""
    groups: dict[object, list[Span]] = {}
    for s in spans:
        groups.setdefault(s.thread, []).append(s)
    roots: list[Span] = []
    for members in groups.values():
        ordered = sorted(members, key=lambda s: (s.t, -s.dur))
        stack: list[Span] = []
        for s in ordered:
            while stack and stack[-1].end < s.end - _EPS:
                stack.pop()
            if stack and stack[-1].t <= s.t + _EPS \
                    and stack[-1].end + _EPS >= s.end:
                stack[-1].children.append(s)
            else:
                roots.append(s)
            stack.append(s)
    return roots


def _sweep(candidates: list[Span], t_lo: float, t_hi: float,
           segments: list[tuple[Span, float, float, float]]) -> float:
    """Backward critical-path sweep over ``[t_lo, t_hi]``: starting
    from the window's end, repeatedly pick the span that finished last
    at/closest before the cursor (among covering spans, the
    latest-STARTING one — the deepest active work), put its on-path
    segment on the chain, and jump the cursor to that span's start.
    Gaps (no span active) advance past silently — they are the
    enclosing scope's self time.  Each chosen segment recurses into the
    span's children; the child-covered seconds ride in the segment
    tuple so self time needs no quadratic post-pass.  Returns the
    seconds this level's segments cover (the caller's child coverage).

    O(n log n): candidates enter a start-keyed heap as the cursor
    crosses their end (end-sorted walk), and a span whose start the
    cursor has passed can never be eligible again, so every span is
    pushed and popped at most once.  This runs inside every
    ``summarize()``/``Recorder.close()`` — long recordings carry tens
    of thousands of spans."""
    import heapq

    cands = sorted(
        (s for s in candidates if s.end > t_lo + _EPS and s.t < t_hi - _EPS),
        key=lambda s: s.end,
    )
    heap: list[tuple[float, int, Span]] = []  # (-start, seq, span)
    i = len(cands) - 1
    seq = 0
    cursor = t_hi
    covered = 0.0
    while cursor > t_lo + _EPS:
        while i >= 0 and cands[i].end >= cursor - _EPS:
            heapq.heappush(heap, (-cands[i].t, seq, cands[i]))
            seq += 1
            i -= 1
        while heap and -heap[0][0] >= cursor - _EPS:
            heapq.heappop(heap)  # started at/after the cursor: done
        if not heap:
            if i < 0:
                break  # pure gap back to t_lo: scope self time
            cursor = cands[i].end  # jump the gap to the next span's end
            continue
        best = heap[0][2]
        seg_hi = min(best.end, cursor)
        seg_lo = max(best.t, t_lo)
        if seg_hi > seg_lo + _EPS:
            child_cov = (
                _sweep(best.children, seg_lo, seg_hi, segments)
                if best.children else 0.0
            )
            segments.append((best, seg_lo, seg_hi, child_cov))
            covered += seg_hi - seg_lo
        cursor = seg_lo
    return covered


def critical_path(events: Iterable[Mapping]) -> dict:
    """The run's critical path:

      {"wall_s": <last span end>,
       "total_s": <sum of on-path self seconds, ≤ wall_s>,
       "path": [{"span", "t", "end", "cp_s"}, ...],  # chain, time order
       "by_span": {name: {"cp_s", "count", "total_s"}},  # ranked
       "slack": {name: max slack seconds for off-path instances}}

    ``cp_s`` per segment is the segment's SELF time: the part of its
    on-path interval its own on-path children don't cover — so summing
    ``cp_s`` over the path (or ``by_span``) never double-counts nested
    spans and never exceeds wall clock.  ``slack`` estimates how much
    later an off-path span could have finished before it would have
    touched the path (the gap to the next on-path segment start, or to
    the end of the run)."""
    spans = [s for s in extract_spans(events)
             if s.name not in _PATH_EXCLUDE]
    if not spans:
        return {"wall_s": 0.0, "total_s": 0.0, "path": [], "by_span": {},
                "slack": {}}
    roots = _build_forest(spans)
    t_lo = min(s.t for s in spans)
    wall = max(s.end for s in spans)
    segments: list[tuple[Span, float, float, float]] = []
    _sweep(roots, t_lo, wall, segments)
    path = []
    on_path: set[int] = set()
    by_span: dict[str, dict] = {}
    total = 0.0
    for s, lo, hi, child_cov in segments:
        self_s = max(0.0, (hi - lo) - child_cov)
        s.cp_s += self_s
        on_path.add(id(s))
        total += self_s
        path.append({"span": s.name, "t": round(lo, 6), "end": round(hi, 6),
                     "cp_s": round(self_s, 6)})
        row = by_span.setdefault(
            s.name, {"cp_s": 0.0, "count": 0, "total_s": 0.0})
        row["cp_s"] += self_s
        row["count"] += 1
    path.sort(key=lambda seg: seg["t"])
    for s in spans:
        row = by_span.get(s.name)
        if row is not None:
            row["total_s"] += s.dur
    # slack for off-path spans: gap to the next on-path segment start
    starts = sorted(seg["t"] for seg in path)
    slack: dict[str, float] = {}
    for s in spans:
        if id(s) in on_path:
            s.slack_s = 0.0
            continue
        nxt = next((t for t in starts if t >= s.end - _EPS), wall)
        s.slack_s = max(0.0, nxt - s.end)
        if s.name not in slack or s.slack_s > slack[s.name]:
            slack[s.name] = round(s.slack_s, 6)
    for row in by_span.values():
        row["cp_s"] = round(row["cp_s"], 6)
        row["total_s"] = round(row["total_s"], 6)
    return {
        "wall_s": round(wall - t_lo, 6),
        "total_s": round(min(total, wall - t_lo), 6),
        "path": path,
        "by_span": dict(sorted(by_span.items(),
                               key=lambda kv: -kv[1]["cp_s"])),
        "slack": slack,
    }


# ---------------------------------------------------------------------------
# Per-device timeline + bubble attribution
# ---------------------------------------------------------------------------

#: span names whose ``devices`` attr places device work on the timeline.
_DEVICE_SPANS = ("ladder.launch", "sharded.lane_launch", "sharded.launch")


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    lo, hi = intervals[0]
    for a, b in intervals[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (hi - lo)


def span_devices(span: Mapping | Span) -> list[int]:
    """The device ids a span's work ran on (``devices`` list or a
    single ``device`` attr), [] when unattributed."""
    attrs = span.attrs if isinstance(span, Span) else (
        span.get("attrs") or {})
    devs = attrs.get("devices")
    if devs is None and attrs.get("device") is not None:
        devs = [attrs["device"]]
    if devs is None:
        return []
    out = []
    for d in devs if isinstance(devs, (list, tuple)) else [devs]:
        try:
            out.append(int(d))
        except (TypeError, ValueError):
            continue
    return out


def device_timeline(events: Iterable[Mapping]) -> dict:
    """Per-device busy/idle/bubble fractions over the observed device
    window:

      {"window_s": <first device-span start → last end>,
       "devices": {id: {"busy_s", "idle_s", "busy_frac", "idle_frac",
                        "launches"}},
       "bubble_ratio": <mean idle fraction>,
       "imbalance": <max − min busy fraction>}

    Busy time per device is the interval UNION of the launch spans
    attributed to it (overlapping launches never double-count), so
    ``busy_frac + idle_frac == 1`` per device by construction.  The
    bubble ratio is the device-mean idle fraction — on a single-bucket
    load it equals 1 − occupancy, which is what the live
    ``serve_device_bubble_ratio`` gauge asserts against."""
    per_dev: dict[int, list[tuple[float, float]]] = {}
    counts: dict[int, int] = {}
    t_lo, t_hi = None, None
    for ev in events:
        if ev.get("type") != "span" or ev.get("name") not in _DEVICE_SPANS:
            continue
        devs = span_devices(ev)
        if not devs:
            continue
        t = float(ev.get("t") or 0.0)
        end = t + max(0.0, float(ev.get("dur") or 0.0))
        t_lo = t if t_lo is None else min(t_lo, t)
        t_hi = end if t_hi is None else max(t_hi, end)
        for d in devs:
            per_dev.setdefault(d, []).append((t, end))
            counts[d] = counts.get(d, 0) + 1
    if not per_dev:
        return {"window_s": 0.0, "devices": {}, "bubble_ratio": None,
                "imbalance": None}
    window = max(_EPS, t_hi - t_lo)
    devices: dict[int, dict] = {}
    fracs = []
    for d in sorted(per_dev):
        busy = min(window, _union_seconds(per_dev[d]))
        frac = busy / window
        fracs.append(frac)
        devices[d] = {
            "busy_s": round(busy, 6),
            "idle_s": round(window - busy, 6),
            "busy_frac": round(frac, 6),
            "idle_frac": round(1.0 - frac, 6),
            "launches": counts[d],
        }
    return {
        "window_s": round(window, 6),
        "devices": devices,
        "bubble_ratio": round(1.0 - sum(fracs) / len(fracs), 6),
        "imbalance": round(max(fracs) - min(fracs), 6),
    }


# ---------------------------------------------------------------------------
# Summary embedding + text rendering
# ---------------------------------------------------------------------------


def critpath_rollup(events: Iterable[Mapping], top: int = 16) -> dict:
    """The compact critical-path section ``telemetry.json`` carries:
    total on-path seconds, wall, and the top spans by critical seconds
    (with slack for the off-path view)."""
    cp = critical_path(events)
    rows = [
        {"span": name, "cp_s": row["cp_s"], "count": row["count"],
         "total_s": row["total_s"],
         "slack_s": cp["slack"].get(name, 0.0)}
        for name, row in list(cp["by_span"].items())[:top]
    ]
    return {"wall_s": cp["wall_s"], "total_s": cp["total_s"], "spans": rows}


def _fmt_table(headers: list[str], rows: list[list]) -> str:
    widths = [
        max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows
        else len(str(h))
        for i, h in enumerate(headers)
    ]
    def line(cells):
        return "  ".join(
            str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()
    return "\n".join(
        [line(headers), line(["-" * w for w in widths])]
        + [line(r) for r in rows])


def format_requests(decomp: Mapping[str, Mapping]) -> str:
    """The per-request decomposition as a text table."""
    if not decomp:
        return "(no serve.request spans in this stream)\n"
    rows = [
        [tid, d.get("tier") or "", d.get("route_s", 0.0), d["queue_s"],
         d["pack_s"], d["launch_s"], d["confirm_s"], d["other_s"],
         d["total_s"], d.get("verdict") or ""]
        for tid, d in sorted(decomp.items(),
                             key=lambda kv: -kv[1]["total_s"])
    ]
    return _fmt_table(
        ["trace", "tier", "route_s", "queue_s", "pack_s", "launch_s",
         "confirm_s", "other_s", "total_s", "verdict"], rows) + "\n"


def format_critpath(cp: Mapping) -> str:
    """The critical-path rollup as a text table."""
    spans = cp.get("spans") or [
        {"span": n, **row, "slack_s": (cp.get("slack") or {}).get(n, 0.0)}
        for n, row in (cp.get("by_span") or {}).items()
    ]
    head = (f"critical path: {cp.get('total_s', 0)} s on-path of "
            f"{cp.get('wall_s', 0)} s wall\n")
    if not spans:
        return head + "(no spans)\n"
    rows = [
        [r["span"], r["cp_s"], r.get("total_s", ""), r.get("count", ""),
         r.get("slack_s", "")]
        for r in spans
    ]
    return head + _fmt_table(
        ["span", "critpath_s", "inclusive_s", "count", "slack_s"],
        rows) + "\n"


def format_devices(tl: Mapping) -> str:
    """The per-device timeline as a text table."""
    devices = tl.get("devices") or {}
    if not devices:
        return "(no device-attributed spans in this stream)\n"
    rows = [
        [d, row["busy_s"], row["idle_s"], row["busy_frac"],
         row["idle_frac"], row["launches"]]
        for d, row in sorted(devices.items())
    ]
    return (
        f"device window {tl['window_s']} s — bubble ratio "
        f"{tl['bubble_ratio']}, imbalance {tl['imbalance']}\n"
        + _fmt_table(
            ["device", "busy_s", "idle_s", "busy_frac", "idle_frac",
             "launches"], rows) + "\n")
