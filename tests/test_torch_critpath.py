"""The port's pure telemetry modules (``obs.summary``, ``obs.critpath``,
``obs.trace``) against the JAX package's, at tolerance 0.

Each stream goes through both packages: the hand-built streams of
tests/test_critpath.py (request decomposition, a fork-join critical
path, a device timeline), seeded random streams that reach every
section of the summary, the trace export's lanes and counter tracks,
and streams the JAX package recorded of its own ladder on the
histories of tests/test_obs.py and tests/test_critpath.py.  The
summary and its text, the critical path, the request decomposition,
the device timeline, the rollup, the three text tables, the trace
export and the stream alignment must be equal, and the port's
``summarize`` of a JAX recording must equal the JAX package's own
``telemetry.json``.
"""

import json
import random

import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu import obs as jobs
from jepsen_tpu.obs import critpath as jcp
from jepsen_tpu.obs import summary as jsum
from jepsen_tpu.obs import trace as jtr
from jepsen_tpu.parallel import batch as jb
from jepsen_tpu_torch.obs import critpath as tcp
from jepsen_tpu_torch.obs import summary as tsum
from jepsen_tpu_torch.obs import trace as ttr
from test_critpath import mixed_histories
from test_obs import _mixed_histories


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each
    for the module, so that no worker's torch pool oversubscribes the
    cores the others' tests (wall-clock floors among them) run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------

#: tests/test_critpath.py's synthetic streams, verbatim.
DECOMPOSE = [
    {"type": "span", "name": "serve.admission", "t": 0.0, "dur": 0.1,
     "trace": "r1", "attrs": {"tier": "batch"}},
    {"type": "span", "name": "serve.batch", "t": 0.12, "dur": 0.5,
     "trace": ["r1", "r2"], "attrs": {"trace_ids": ["r1", "r2"]}},
    {"type": "span", "name": "serve.request", "t": 0.0, "dur": 0.7,
     "trace": "r1", "attrs": {"tier": "batch", "verdict": "False"}},
    {"type": "span", "name": "serve.admission", "t": 0.2, "dur": 0.1,
     "trace": "r2", "attrs": {"tier": "batch", "joined_at_rung": 1}},
    {"type": "span", "name": "serve.request", "t": 0.2, "dur": 0.3,
     "trace": "r2", "attrs": {"tier": "batch", "verdict": "True"}},
    {"type": "span", "name": "serve.request", "t": 0.0, "dur": 0.4,
     "trace": "r3", "attrs": {"tier": "batch", "verdict": "unknown"}},
]
FORK_JOIN = [
    {"type": "span", "name": "stage.a", "t": 0.0, "dur": 1.0, "thread": 1},
    {"type": "span", "name": "arm.long", "t": 0.1, "dur": 0.8, "thread": 2},
    {"type": "span", "name": "arm.short", "t": 0.1, "dur": 0.4, "thread": 3},
    {"type": "span", "name": "drain.tail", "t": 0.9, "dur": 0.6, "thread": 1},
    {"type": "span", "name": "serve.request", "t": 0.0, "dur": 1.5,
     "trace": "r"},
]
QUANTIZED = [
    {"type": "span", "name": "stage", "t": 0.0, "dur": 0.099999, "thread": 1},
    {"type": "span", "name": "launch", "t": 0.000001, "dur": 0.099999,
     "thread": 1},
]
DEVICES = [
    {"type": "span", "name": "ladder.launch", "t": 0.0, "dur": 0.6,
     "attrs": {"devices": [0, 1]}},
    {"type": "span", "name": "ladder.launch", "t": 0.4, "dur": 0.6,
     "attrs": {"devices": [0]}},
    {"type": "span", "name": "sharded.lane_launch", "t": 0.5, "dur": 0.2,
     "attrs": {"devices": [0]}},
]
#: tests/test_obs.py's trace-export stream, as its recording writes it.
TRACE_LANES = [
    {"type": "meta", "version": 1, "wall-clock": 1000.0, "t0": 1000.0,
     "pid": 11, "host": "h"},
    {"type": "span", "name": "serve.admission", "t": 0.0, "dur": 0.01,
     "trace": "req-1", "thread": 1, "attrs": {"client": "a"}},
    {"type": "span", "name": "serve.admission", "t": 0.01, "dur": 0.02,
     "trace": "req-2", "thread": 1, "attrs": {"client": "b"}},
    {"type": "span", "name": "ladder.stage", "t": 0.03, "dur": 0.1,
     "trace": ["req-1", "req-2"], "thread": 1, "attrs": {"stage": 0}},
    {"type": "span", "name": "ladder.launch", "t": 0.05, "dur": 0.08,
     "trace": ["req-1", "req-2"], "thread": 1,
     "attrs": {"engine": "async", "devices": [0, 3]}},
    {"type": "gauge", "name": "device.buffer_bytes", "t": 0.13,
     "trace": ["req-1", "req-2"], "value": 1234},
    {"type": "span", "name": "serve.batch", "t": 0.03, "dur": 0.11,
     "thread": 1, "attrs": {"trace_ids": ["req-1", "req-2"]}},
    {"type": "gauge", "name": "serve.queue_depth", "t": 0.15, "value": 2},
    {"type": "gauge", "name": "serve.queue_depth.interactive", "t": 0.15,
     "value": 1},
    {"type": "gauge", "name": "serve.queue_depth.batch", "t": 0.15,
     "value": 1},
    {"type": "event", "name": "stream.rescan", "t": 0.16,
     "attrs": {"stream": "s1"}},
    {"type": "span", "name": "stream.epoch", "t": 0.16, "dur": 0.01,
     "thread": 1, "attrs": {"stream": "s1", "epoch": 1}},
]

_SPANS = [
    ("phase.run", {}), ("phase.analyze", {}),
    ("checker.check", {"checker": "linear", "valid": True}),
    ("checker.check", {"checker": "elle", "valid": False}),
    ("ladder.stage", {"stage": 0, "engine": "greedy", "capacity": 1,
                      "lanes": 6, "resolved": 4, "refuted": 0,
                      "unknowns_remaining": 2, "launches": 1,
                      "compile_launches": 1, "compile_s": 0.2,
                      "execute_s": 0.0, "peak_frontier": 1, "lossy": 2,
                      "dedup": "sort", "degraded": 0,
                      "device_bytes_peak": 12345, "devices": [0]}),
    ("ladder.stage", {"stage": 1, "engine": "async", "capacity": 64,
                      "lanes": 2, "pallas_routed": False, "mesh_devices": 1,
                      "dedup": "fused", "launches": 2,
                      "compile_launches": 0}),
    ("ladder.launch", {"engine": "async", "capacity": 64, "lanes": 2,
                       "devices": [0], "compiled": False}),
    ("sharded.launch", {"devices": [0, 1, 2, 3], "capacity": 256}),
    ("sharded.mesh_launch", {"devices": [0], "mesh_devices": 4}),
    ("dedup.round", {"backend": "sort", "candidates": 208, "capacity": 16,
                     "rounds": 5, "per_round_us": 120.5}),
    ("dedup.round", {"backend": "fused", "candidates": 208, "capacity": 16,
                     "rounds": 5, "interpret": True}),
    ("dedup.mesh_round", {"backend": "fused", "mesh_devices": 4,
                          "candidates": 832, "capacity": 64}),
    ("serve.batch", {"requests": 3, "occupancy": 0.75, "padding_waste": 0.25,
                     "rungs": 2, "continuous_occupancy": 0.5, "joined": 1,
                     "trace_ids": ["r1", "r2"]}),
    ("serve.admission", {"tier": "batch"}),
    ("serve.request", {"tier": "interactive", "verdict": "True"}),
    ("fleet.route", {}), ("fleet.rollout", {}),
    ("stream.epoch", {"stream": "s1", "epoch": 2}),
    ("stream.verdict", {"stream": "s1", "verdict": "false"}),
    ("stream.session", {"stream": "s2"}),
    ("elle.scc", {"backend": "host", "nodes": 12}),
    ("elle.nodes", {"workload": "list-append"}),
    ("fault.checkpoint.save", {"stage": 1, "pending": 2}),
    ("wgl.chunked", {"valid": True, "chunks": 2}),
]
_COUNTERS = [
    ("fault.launch.retry", {"what": "ladder.async", "attempt": 1}),
    ("fault.oom.spill", {"what": "launch"}),
    ("provenance.bundle", {"source": "checker", "verdict": "true"}),
    ("provenance.emit_error", {"error": "OSError"}),
    ("frontier.spill_rows", {}), ("frontier.spill_bytes", {}),
    ("frontier.spill_merges", {}), ("frontier.factorizations", {}),
    ("serve.submitted", {}), ("serve.quarantined", {}),
    ("fleet.routed", {"replica": "a"}), ("stream.opened", {}),
    ("stream.ops", {"stream": "s1"}), ("stream.rescan", {}),
    ("wgl.chunk.escalations", {}), ("ladder.compile_cache.miss", {}),
]
_GAUGES = [
    ("device.buffer_bytes", {"at": "ladder-stage"}),
    ("ladder.unknowns_remaining", {"final": True}),
    ("serve.queue_depth", {}), ("serve.queue_depth.batch", {}),
    ("fleet.replicas", {}), ("fleet.replicas_healthy", {}),
    ("confirm.queue_latency_s", {"history": 3}),
]
_EVENTS = [
    ("frontier.undecidable", {"barrier": 7, "capacity": 64}),
    ("fault.deadline", {"at": "ladder-stage", "stage": 2}),
    ("stream.verdict", {"stream": "s1"}),
]


def random_stream(seed: int) -> list[dict]:
    """A seeded stream of every event kind, reaching every section of the
    summary, with nested and concurrent spans on three threads and
    request traces."""
    rng = random.Random(seed)
    evs = [{"type": "meta", "version": 1, "wall-clock": 5000.0 + seed,
            "t0": 5000.0 + seed, "pid": 100 + seed, "host": f"h{seed}"}]
    for _ in range(rng.randint(30, 90)):
        t = round(rng.uniform(0, 5), 6)
        kind = rng.choice(("span", "span", "counter", "gauge", "event"))
        trace = rng.choice((None, None, "r1", "r2", "r3", ["r1", "r2"]))
        if kind == "span":
            name, attrs = rng.choice(_SPANS)
            ev = {"type": "span", "name": name, "t": t,
                  "dur": round(rng.uniform(0, 1.5), 6),
                  "thread": rng.choice((1, 2, 3))}
            if rng.random() < 0.2:
                ev["err"] = "ValueError"
            if rng.random() < 0.3:
                ev["parent"] = rng.choice(("phase.run", "ladder.stage"))
        elif kind == "counter":
            name, attrs = rng.choice(_COUNTERS)
            ev = {"type": "counter", "name": name, "t": t,
                  "n": rng.randint(1, 5)}
        elif kind == "gauge":
            name, attrs = rng.choice(_GAUGES)
            ev = {"type": "gauge", "name": name, "t": t,
                  "value": rng.choice((rng.randint(0, 10**6),
                                       round(rng.random(), 4)))}
        else:
            name, attrs = rng.choice(_EVENTS)
            ev = {"type": "event", "name": name, "t": t}
        if attrs:
            ev["attrs"] = dict(attrs)
        if trace is not None:
            ev["trace"] = trace
        evs.append(ev)
    return evs


_RECORDED: dict = {}


def recorded(which: str, tmp_path_factory) -> tuple[list[dict], dict]:
    """A stream the JAX package recorded of its own ladder (the histories
    of tests/test_obs.py or tests/test_critpath.py), with the summary
    its recording wrote, once per process."""
    if which not in _RECORDED:
        d = tmp_path_factory.mktemp(f"jax-{which}")
        hists = _mixed_histories() if which == "obs" else mixed_histories()
        with jobs.recording(d) as rec:
            jb.batch_analysis(jm.CASRegister(None), hists,
                              capacity=(16, 64) if which == "obs" else (64, 256),
                              confirm_refutations=False)
        events, skipped = jtr.read_jsonl_events(d / "telemetry.jsonl")
        assert skipped == 0
        _RECORDED[which] = (events,
                            json.loads((d / "telemetry.json").read_text()))
    return _RECORDED[which]


STREAMS = {
    "decompose": DECOMPOSE, "fork-join": FORK_JOIN, "quantized": QUANTIZED,
    "devices": DEVICES, "trace-lanes": TRACE_LANES, "empty": [],
    "meta-only": [{"type": "meta", "version": 1}],
    **{f"random-{s}": random_stream(s) for s in range(6)},
}


def _streams(name, tmp_path_factory):
    if name.startswith("recorded-"):
        return recorded(name[len("recorded-"):], tmp_path_factory)[0]
    return STREAMS[name]


ALL = list(STREAMS) + ["recorded-obs", "recorded-critpath"]

# ---------------------------------------------------------------------------
# Equality, stream by stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL)
def test_summary_and_text_equal(name, tmp_path_factory):
    events = _streams(name, tmp_path_factory)
    for skipped in (0, 3):
        js = jsum.summarize(events, skipped_lines=skipped)
        ts = tsum.summarize(events, skipped_lines=skipped)
        assert ts == js
        assert tsum.format_summary(ts) == jsum.format_summary(js)
    assert tsum._mb(12_345_678) == jsum._mb(12_345_678)
    assert tsum._mb(4321) == jsum._mb(4321) and tsum._mb(0) == jsum._mb(0)


@pytest.mark.parametrize("name", ALL)
def test_critpath_equal(name, tmp_path_factory):
    events = _streams(name, tmp_path_factory)
    cp = tcp.critical_path(events)
    assert cp == jcp.critical_path(events)
    assert tcp.format_critpath(cp) == jcp.format_critpath(cp)
    roll = tcp.critpath_rollup(events)
    assert roll == jcp.critpath_rollup(events)
    assert tcp.format_critpath(roll) == jcp.format_critpath(roll)
    assert tcp.critpath_rollup(events, top=2) == jcp.critpath_rollup(events,
                                                                      top=2)
    dec = tcp.decompose_requests(events)
    assert dec == jcp.decompose_requests(events)
    assert tcp.format_requests(dec) == jcp.format_requests(dec)
    tl = tcp.device_timeline(events)
    assert tl == jcp.device_timeline(events)
    assert tcp.format_devices(tl) == jcp.format_devices(tl)
    spans = [e for e in events if e.get("type") == "span"]
    assert [tcp.span_devices(e) for e in spans] == [
        jcp.span_devices(e) for e in spans]
    assert [vars_of(s) for s in tcp.extract_spans(events)] == [
        vars_of(s) for s in jcp.extract_spans(events)]


def vars_of(span) -> tuple:
    return (span.name, span.t, span.dur, span.end, span.parent, span.attrs,
            span.trace, span.thread)


@pytest.mark.parametrize("name", ALL)
def test_trace_export_equal(name, tmp_path_factory, tmp_path):
    events = _streams(name, tmp_path_factory)
    assert ttr.to_trace_events(events, skipped_lines=2) == \
        jtr.to_trace_events(events, skipped_lines=2)
    # the tolerant reader, on the stream with a torn last line
    p = tmp_path / "telemetry.jsonl"
    p.write_text("".join(json.dumps(e) + "\n" for e in events)
                 + '{"type":"span","name":"torn"')
    assert outcome(ttr.read_jsonl_events, p) == outcome(
        jtr.read_jsonl_events, p)


def outcome(fn, *args):
    """``fn(*args)``, or the type and text of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 — compared, not handled
        return type(e).__name__, str(e)


def test_stream_alignment_equal(tmp_path_factory):
    """Two random streams with different epochs, and a router and a
    replica stream sharing a trace id: the aligned copies, the merged
    stream and the alignment report are the JAX package's."""
    a, b = random_stream(7), random_stream(8)
    router = [{"type": "meta", "t0": 100.0},
              {"type": "span", "name": "fleet.route", "t": 0.5, "dur": 0.2,
               "trace": "x"}]
    replica = [{"type": "meta", "t0": 100.3},
               {"type": "span", "name": "serve.request", "t": 0.1,
                "dur": 0.4, "trace": "x"}]
    no_t0 = [{"type": "span", "name": "phase.run", "t": 0.0, "dur": 1.0}]
    for streams in ([("a", a), ("b", b, 2)],
                    [("router", router), ("replica", replica),
                     ("bare", no_t0)]):
        ja, jinfo = jtr.align_streams(streams)
        ta, tinfo = ttr.align_streams(streams)
        assert (ta, tinfo) == (ja, jinfo)
        merged = ttr.merge_aligned_events(ta)
        assert merged == jtr.merge_aligned_events(ja)
        assert tsum.summarize(merged) == jsum.summarize(merged)
        assert tcp.decompose_requests(merged) == jcp.decompose_requests(merged)


@pytest.mark.parametrize("which", ["obs", "critpath"])
def test_port_summary_of_a_jax_recording(which, tmp_path_factory):
    """The port's summarize of a stream the JAX package recorded is the
    JAX package's own telemetry.json."""
    events, rolled = recorded(which, tmp_path_factory)
    ts = tsum.summarize(events)
    assert json.loads(json.dumps(ts, default=str)) == rolled
    assert rolled["ladder"] and ts["critpath"]["spans"]
    assert tsum.format_summary(rolled) == jsum.format_summary(rolled)


def test_summary_renders_without_the_vmem_keys():
    """A port ladder row carries "pallas_routed" and "mesh_devices" but
    none of the JAX package's VMEM keys; the table renders, and the row
    keeps what the stream had (ROADMAP C4)."""
    row = {"stage": 1, "engine": "async", "capacity": 2048, "lanes": 8,
           "pallas_routed": True, "mesh_devices": 1, "launches": 1,
           "compile_launches": 0, "device_bytes_peak": 90_200_000}
    ev = [{"type": "span", "name": "ladder.stage", "t": 0.0, "dur": 1.0,
           "attrs": row}]
    s = tsum.summarize(ev)
    assert s == jsum.summarize(ev)
    [out] = s["ladder"]
    assert out["pallas_routed"] is True and "pallas_vmem_bytes" not in out
    txt = tsum.format_summary(s)
    assert "ladder stages:" in txt and "90.2" in txt
