"""The port's telemetry API (``jepsen_tpu_torch.obs``) and its live
metrics registry (``obs.metrics``), against the JAX package's.

The API contract of tests/test_obs.py on the port: span nesting and
late attributes, the jsonl round trip and its summary, an exception
recorded, the no-op path (checked by structure, not by the clock: the
shared singleton, no file, no event), nested recordings, a new
recording replacing an old one, the env toggle and ``enabled_for``,
``capture``/``attach`` across threads and the metrics mirror.  The
same API calls under both packages' recordings give the same events
once the clock is taken out, and the same registry calls render the
same Prometheus text.

Every test opens and closes its recordings with the context manager,
and leaves the mirror as it found it.
"""

import json
import os
import threading
import time

import pytest
import torch

from jepsen_tpu import obs as jobs
from jepsen_tpu.obs import metrics as jmetrics
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.obs import metrics
from jepsen_tpu_torch.obs.summary import summarize


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each
    for the module, so that no worker's torch pool oversubscribes the
    cores the others' tests (wall-clock floors among them) run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _mirror_off():
    """Both packages' mirrors off for the test, restored after it."""
    saved = metrics.MIRROR, jmetrics.MIRROR
    metrics.enable_mirror(False)
    jmetrics.enable_mirror(False)
    yield
    metrics.enable_mirror(saved[0])
    jmetrics.enable_mirror(saved[1])


def read_jsonl(d):
    return [json.loads(line)
            for line in (d / "telemetry.jsonl").read_text().splitlines()
            if line]


def test_recorder_header_epoch_pid_host(tmp_path):
    before = time.time()
    with obs.recording(tmp_path):
        obs.event("x")
    after = time.time()
    meta = read_jsonl(tmp_path)[0]
    assert meta["type"] == "meta" and meta["version"] == 1
    assert before <= meta["t0"] <= after
    assert meta["wall-clock"] == meta["t0"]
    assert meta["pid"] == os.getpid()
    assert isinstance(meta["host"], str) and meta["host"]


def test_span_nesting_attrs_and_jsonl_roundtrip(tmp_path):
    with obs.recording(tmp_path) as rec:
        with obs.span("outer", a=1) as sp:
            with obs.span("inner"):
                pass
            sp.set(b="two")
        obs.counter("hits", 3, tag="x")
        obs.gauge("depth", 7)
        obs.event("note", detail="d")
        obs.span_event("done", 0.25, k=1)
    events = read_jsonl(tmp_path)
    by_name = {e.get("name"): e for e in events[1:]}
    inner, outer = by_name["inner"], by_name["outer"]
    assert inner["parent"] == "outer" and "parent" not in outer
    assert outer["attrs"] == {"a": 1, "b": "two"}
    assert outer["dur"] >= inner["dur"] >= 0
    assert inner["thread"] == outer["thread"] == threading.get_ident()
    assert by_name["hits"]["n"] == 3 and by_name["hits"]["attrs"] == {"tag": "x"}
    assert by_name["depth"]["value"] == 7
    assert by_name["note"]["attrs"] == {"detail": "d"}
    assert by_name["done"]["dur"] == 0.25 and "parent" not in by_name["done"]
    rolled = json.loads((tmp_path / "telemetry.json").read_text())
    assert rolled == summarize(events) == rec.summary
    assert rolled["counters"] == {"hits": 3}
    assert rolled["gauges"] == {"depth": 7}


def test_span_exception_recorded(tmp_path):
    with obs.recording(tmp_path):
        with pytest.raises(ValueError):
            with obs.span("boom", k=1):
                raise ValueError("x")
    ev = [e for e in read_jsonl(tmp_path) if e.get("name") == "boom"][0]
    assert ev["err"] == "ValueError" and ev["attrs"] == {"k": 1}


def test_noop_path_is_structural(tmp_path, monkeypatch):
    """With nothing recording: every span is the one shared singleton,
    ``set`` returns it, counters, gauges and events emit nothing and
    open no file, and a disabled recording installs nothing."""
    monkeypatch.chdir(tmp_path)
    assert obs.active() is None and not obs.observing()
    assert obs.span("a") is obs.span("b", x=1) is obs.NOOP_SPAN
    with obs.span("a") as sp:
        assert sp is obs.NOOP_SPAN and sp.set(k=2) is sp
    assert not hasattr(obs.NOOP_SPAN, "__dict__")  # no per-call state
    emitted = []
    monkeypatch.setattr(obs.Recorder, "emit",
                        lambda self, ev: emitted.append(ev))
    obs.counter("c")
    obs.gauge("g", 1)
    obs.event("e")
    obs.span_event("s", 0.1)
    with obs.recording(tmp_path / "sub", enabled=False) as rec:
        assert rec is None and obs.span("x") is obs.NOOP_SPAN
        obs.counter("c")
    with obs.recording(None) as rec:
        assert rec is None
    assert emitted == [] and list(tmp_path.iterdir()) == []


def test_recording_nests_passthrough(tmp_path):
    with obs.recording(tmp_path) as outer:
        with obs.recording(tmp_path / "inner") as inner:
            assert inner is outer
            obs.counter("both")
        assert obs.active() is outer
        obs.counter("both")
    assert obs.active() is None
    assert not (tmp_path / "inner").exists()
    rolled = json.loads((tmp_path / "telemetry.json").read_text())
    assert rolled["counters"] == {"both": 2}


def test_new_recording_replaces_previous_stream(tmp_path):
    with obs.recording(tmp_path):
        obs.counter("hits")
    with obs.recording(tmp_path):
        obs.counter("hits")
    events = read_jsonl(tmp_path)
    assert sum(1 for e in events if e.get("type") == "meta") == 1
    assert summarize(events)["counters"] == {"hits": 1}
    rolled = json.loads((tmp_path / "telemetry.json").read_text())
    assert rolled["counters"] == {"hits": 1}


def test_env_toggle_and_enabled_for(monkeypatch):
    assert obs.ENV_VAR == jobs.ENV_VAR == "JEPSEN_TPU_TELEMETRY"
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    assert obs.env_enabled(True) and not obs.env_enabled(False)
    for off in ("0", "false", "off", "NO", " no "):
        monkeypatch.setenv(obs.ENV_VAR, off)
        assert not obs.env_enabled(True)
    monkeypatch.setenv(obs.ENV_VAR, "1")
    assert obs.env_enabled(False)
    assert not obs.enabled_for({"telemetry?": False})
    monkeypatch.setenv(obs.ENV_VAR, "0")
    assert obs.enabled_for({"telemetry?": True})
    assert not obs.enabled_for({}) and not obs.enabled_for(None)
    for v in (None, "0", "1", "off"):
        if v is None:
            monkeypatch.delenv(obs.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(obs.ENV_VAR, v)
        for test in (None, {}, {"telemetry?": True}, {"telemetry?": False},
                     {"telemetry?": None}):
            assert obs.enabled_for(test) == jobs.enabled_for(test)


def test_capture_attach_crosses_threads(tmp_path):
    with obs.recording(tmp_path):
        with obs.span("root"):
            ctx = obs.capture(trace="tr-1")
        assert ctx.parent == "root" and ctx.trace == "tr-1"
        assert repr(ctx) == "Ctx(parent='root', trace='tr-1')"

        def other():
            with obs.attach(ctx):
                with obs.span("hop"):
                    with obs.span("nested"):
                        pass
                obs.counter("hits")
                obs.gauge("depth", 1)
            obs.counter("outside")

        t = threading.Thread(target=other)
        t.start()
        t.join()
        with obs.attach(trace=["tr-1", "tr-2"]):
            obs.event("shared")
        with obs.attach(ctx, parent="p2"):
            assert obs.capture().parent == "p2"
            assert obs.capture().trace == "tr-1"
    by_name = {e.get("name"): e for e in read_jsonl(tmp_path)[1:]}
    assert by_name["hop"]["parent"] == "root"
    assert by_name["hop"]["trace"] == "tr-1"
    assert by_name["nested"]["parent"] == "hop"
    assert by_name["hits"]["trace"] == "tr-1"
    assert by_name["depth"]["trace"] == "tr-1"
    assert "trace" not in by_name["outside"]
    assert "trace" not in by_name["root"]
    assert by_name["shared"]["trace"] == ["tr-1", "tr-2"]
    assert by_name["hop"]["thread"] != by_name["root"]["thread"]
    tid = obs.new_trace_id()
    assert len(tid) == 16 and int(tid, 16) >= 0 and tid != obs.new_trace_id()


def test_metrics_mirror(tmp_path):
    """The mirror feeds the registry by name with no recording open;
    ``observing`` reports it; the explicit feeds are no-ops with it off."""
    before = metrics.REGISTRY.get("mirror.test.hits") or 0
    obs.counter("mirror.test.hits", 5)
    metrics.inc("mirror.test.explicit")
    metrics.observe("mirror.test.lat", 0.1)
    assert (metrics.REGISTRY.get("mirror.test.hits") or 0) == before
    assert metrics.REGISTRY.get("mirror.test.explicit") is None
    assert metrics.REGISTRY.histogram("mirror.test.lat") is None
    metrics.enable_mirror(True)
    assert obs.observing() and obs.active() is None
    obs.counter("mirror.test.hits", 5)
    obs.gauge("mirror.test.depth", 9)
    obs.gauge("mirror.test.name", "not a number")
    metrics.set_gauge("mirror.test.g", 2, kind="x")
    metrics.observe("mirror.test.lat", 0.1)
    assert metrics.REGISTRY.get("mirror.test.hits") == before + 5
    assert metrics.REGISTRY.get("mirror.test.depth") == 9
    assert metrics.REGISTRY.get("mirror.test.name") is None
    assert metrics.REGISTRY.get("mirror.test.g", kind="x") == 2
    assert metrics.REGISTRY.histogram("mirror.test.lat")["count"] >= 1
    assert "jepsen_tpu_mirror_test_hits_total" in metrics.render()
    for name in ("mirror.test.hits", "mirror.test.depth", "mirror.test.lat"):
        metrics.REGISTRY.remove(name)
    metrics.REGISTRY.remove("mirror.test.g", kind="x")
    assert metrics.REGISTRY.get("mirror.test.depth") is None
    assert metrics.metric_name("a.b-c") == jmetrics.metric_name("a.b-c")
    assert metrics.metric_name("jepsen_tpu_x") == "jepsen_tpu_x"


def _registry_calls(mod, case: int):
    """One seeded sequence of registry calls on a fresh ``mod.Registry``."""
    import random

    rng = random.Random(case)
    r = mod.Registry()
    names = ["serve.verdicts", "fault.launch_failures", "lat", "a-b.c",
             "jepsen_tpu_already", "q"]
    for _ in range(40):
        op = rng.choice(("inc", "set", "observe", "remove"))
        name = rng.choice(names)
        labels = rng.choice(({}, {"verdict": "true"}, {"kind": 'o"m\\\n'},
                             {"what": "ladder.async", "kind": "oom"}))
        if op == "inc":
            r.inc(name, rng.choice((1, 2, 0.5)), **labels)
        elif op == "set":
            r.set(name, rng.choice((3, 2.5, True, "text", float("inf"),
                                    -float("inf"), 1e16)), **labels)
        elif op == "observe":
            r.observe(name, rng.choice((0.0004, 0.2, 7.0, 1000.0)),
                      buckets=rng.choice(((0.01, 1.0),
                                          mod.LATENCY_BUCKETS)), **labels)
        else:
            r.remove(name, **labels)
    return r


@pytest.mark.parametrize("case", range(6))
def test_registry_render_matches_jax(case):
    t, j = _registry_calls(metrics, case), _registry_calls(jmetrics, case)
    assert t.render() == j.render()
    assert t.snapshot() == j.snapshot()
    for name in ("serve.verdicts", "lat", "q"):
        assert t.get(name) == j.get(name)
        assert t.histogram(name) == j.histogram(name)
        assert t.histogram_buckets(name) == j.histogram_buckets(name)
    t.reset()
    assert t.render() == ""


def _api_script(o, d):
    """The same API calls, under package ``o``'s recording in ``d``."""
    with o.recording(d) as rec:
        with o.span("phase.run", n=3) as sp:
            with o.span("ladder.stage", stage=0):
                o.counter("fault.launch.retry", what="x", attempt=1)
            sp.set(valid=True)
        try:
            with o.span("checker.check", checker="boom"):
                raise KeyError("k")
        except KeyError:
            pass
        ctx = o.capture(trace="t1", parent="phase.run")
        with o.attach(ctx):
            o.gauge("serve.queue_depth", 4)
            o.span_event("serve.request", 0.5, tier="batch", verdict="True")
            with o.span("serve.batch"):
                o.event("fault.deadline", at="ladder-stage")
        o.gauge("device.buffer_bytes", 123, at="wgl-chunk")
        o.counter("provenance.bundle", 2, source="checker", verdict="true")
    return rec.events, rec.summary


def _untimed(events):
    return [{k: v for k, v in e.items()
             if k not in ("t", "dur", "thread", "t0", "wall-clock", "pid",
                          "host")}
            for e in events]


def test_api_streams_match_jax(tmp_path):
    """The same calls give the same events under both packages (the
    clock and the header's process fields aside) and the same summary
    wherever it does not read the clock."""
    te, ts = _api_script(obs, tmp_path / "port")
    je, js = _api_script(jobs, tmp_path / "jax")
    assert _untimed(te) == _untimed(je)
    for key in ("faults", "counters", "gauges", "provenance", "memory"):
        assert ts[key] == js[key]
    assert [{k: v for k, v in c.items() if k != "seconds"}
            for c in ts["checkers"]] == [
        {k: v for k, v in c.items() if k != "seconds"}
        for c in js["checkers"]]
    assert [c["checker"] for c in ts["checkers"]] == ["boom"]
    assert ts["checkers"][0]["error"] == "KeyError"
