"""The web app (``web``) in the port against the JAX package.

Each package's server listens on ``127.0.0.1:0`` in a thread and mounts
its own ``CheckService`` on the CPU (the port with ``device="cpu"``,
both under "sort", request ids and bundle machine blocks pinned alike,
as tests/test_torch_serve.py's ``both`` pins them).  Each gets one
request script: ``/healthz``, ``/readyz``, ``POST /check`` with
``"wait"`` and async with an idempotency key, the key's resubmission,
``GET /check/<id>``, ``/evidence/<id>``, ``/queue``, ``/alerts``, a
413, a 429 with Retry-After, streams opened, fed, overlapped, gapped
(409) and closed, ``/metrics``, ``/profile`` and ``/trace/<t>/<ts>``.
Status codes and JSON bodies are equal once the keys that read the
clock are dropped and each run's directory is named alike.  Then the
store browser over one store written by ``save_0``..``save_2``: the
home, suite, perf and run (telemetry) pages are equal once times are
normalized, the path-traversal guard answers 404 and ``/zip/`` holds
the same member names.
"""

import http.client
import io
import json
import re
import threading
import time
import zipfile

import pytest
import torch

from jepsen_tpu import store as jstore
from jepsen_tpu import web as jweb
from jepsen_tpu.obs import metrics as jmet
from jepsen_tpu.obs import provenance as jprov
from jepsen_tpu.obs import regress as jreg
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import web as tweb
from jepsen_tpu_torch.obs import metrics as tmet
from jepsen_tpu_torch.obs import provenance as tprov
from jepsen_tpu_torch.obs import regress as treg
from jepsen_tpu_torch.ops import hashing as thashing
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history
from test_torch_serve import CLOCK_KEYS, MACHINE, PKG, first_diff, pin_ids, svc_kw

WEB = {"jax": jweb, "port": tweb}
STORE = {"jax": jstore, "port": tstore}
MET = {"jax": jmet, "port": tmet}
REG = {"jax": jreg, "port": treg}

#: more keys that read the clock or name a thread, at any depth
CLOCK = CLOCK_KEYS | {
    "latency", "submitted_at", "started_at", "finished_at", "t_submit",
    "ts", "wall_s", "elapsed_s", "uptime_s", "detected_at",
    "detect_latency_s", "burn_fast", "burn_slow", "created", "age",
    "evaluated_at", "queue_wait_s", "last_batch_s", "time", "latency_s",
    "firing_for_s"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for the module (module fixtures included): the
    host's cores are shared with other test processes, wall-clock floors
    among them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fast retries; the port under "sort"; bundle machine blocks
    pinned; the metrics mirrors restored after."""
    monkeypatch.setenv("JEPSEN_TPU_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("JEPSEN_TPU_RETRY_MAX_S", "0.002")
    monkeypatch.setattr(thashing, "DEDUP_BACKEND", "sort")
    monkeypatch.setattr(jprov, "machine_fingerprint", lambda: dict(MACHINE))
    monkeypatch.setattr(tprov, "machine_fingerprint", lambda: dict(MACHINE))
    saved = jmet.MIRROR, tmet.MIRROR
    yield
    jmet.enable_mirror(saved[0])
    tmet.enable_mirror(saved[1])


def _scrub(x, d):
    """``x`` without clock keys, with run directory ``d`` named "D"."""
    if isinstance(x, dict):
        return {k: _scrub(v, d) for k, v in x.items() if k not in CLOCK}
    if isinstance(x, list):
        return [_scrub(v, d) for v in x]
    if isinstance(x, str):
        return x.replace(str(d), "D")
    return x


class Client:
    """One server's HTTP surface: ``(status, headers, body)`` per call,
    never raising on an error status."""

    def __init__(self, srv):
        self.port = srv.server_address[1]

    def call(self, method, path, body=None, ctype="application/json"):
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        headers = {"Content-Type": ctype} if body is not None else {}
        c.request(method, path, body=body, headers=headers)
        r = c.getresponse()
        out = (r.status, dict(r.getheaders()), r.read())
        c.close()
        return out

    def json(self, method, path, obj=None, ndjson=None):
        body = None
        ctype = "application/json"
        if ndjson is not None:
            body = "\n".join(json.dumps(ln) for ln in ndjson).encode()
            ctype = "application/x-ndjson"
        elif obj is not None:
            body = json.dumps(obj).encode()
        status, headers, raw = self.call(method, path, body, ctype)
        try:
            doc = json.loads(raw)
        except ValueError:
            doc = raw.decode()
        return status, headers, doc


def serving(P, name, d, **kw):
    srv = WEB[name].make_server("127.0.0.1", 0, str(d / "store"), **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _poll(cl, rid, timeout=120):
    deadline = time.monotonic() + timeout
    while True:
        st, _h, doc = cl.json("GET", f"/check/{rid}")
        if doc.get("status") in ("done", "error") or time.monotonic() > deadline:
            return st, doc
        time.sleep(0.02)


def _hists():
    good = valid_register_history(30, 3, seed=0, info_rate=0.1)
    bad = corrupt(valid_register_history(30, 3, seed=2, info_rate=0.1), seed=2)
    return good, bad


TELEMETRY = [
    {"type": "meta", "version": 1, "wall-clock": 1000.0, "t0": 1000.0,
     "pid": 12, "host": "h"},
    {"type": "span", "name": "serve.request", "t": 0.35, "dur": 0.1,
     "trace": "T1", "attrs": {"tier": "batch", "verdict": "true"}},
    {"type": "span", "name": "ladder.launch", "t": 0.36, "dur": 0.05,
     "attrs": {"devices": [0], "engine": "async"}},
    {"type": "counter", "name": "serve.completed", "t": 0.5, "n": 1},
]


def _check_script(P, name, d):
    """The check API's request script against package ``name``."""
    good, bad = _hists()
    (d / "store" / "run" / "t1").mkdir(parents=True)
    (d / "store" / "run" / "t1" / "telemetry.jsonl").write_text(
        "\n".join(json.dumps(e) for e in TELEMETRY) + "\n")
    MET[name].REGISTRY.reset()
    svc = P.sv.CheckService(max_streams=1, batch_window_s=0.01,
                            evidence_dir=d / "ev", **svc_kw(P)).start()
    srv = serving(P, name, d, check_service=svc, max_request_mb=0.05)
    cl = Client(srv)
    out = []

    def rec(label, status, headers, doc):
        out.append((label, status, "Retry-After" in headers, _scrub(doc, d)))
        return doc

    try:
        rec("healthz", *cl.json("GET", "/healthz"))
        rec("readyz", *cl.json("GET", "/readyz"))
        rec("profile-none", *cl.json("GET", "/profile"))
        rec("profile-start-none", *cl.json("POST", "/profile/start", {}))
        doc = rec("wait", *cl.json("POST", "/check", {
            "history": good, "wait": True, "class": "interactive",
            "client": "curl", "trace_id": "trace-w"}))
        assert doc["result"]["valid?"] is True
        doc = rec("async", *cl.json("POST", "/check", {
            "history": bad, "class": "batch", "idempotency_key": "k1"}))
        rid = doc["id"]
        st, got = _poll(cl, rid)
        rec("poll", st, {}, got)
        assert got["status"] == "done" and got["result"]["valid?"] is False
        doc = rec("resubmit", *cl.json("POST", "/check", {
            "history": bad, "class": "batch", "idempotency_key": "k1"}))
        assert doc["id"] == rid
        ev = rec("evidence", *cl.json("GET", f"/evidence/{rid}"))
        assert P.prov.verify_bundle(ev)["ok"] is True
        rec("evidence-404", *cl.json("GET", "/evidence/nope"))
        rec("check-404", *cl.json("GET", "/check/deadbeef"))
        rec("queue", *cl.json("GET", "/queue"))
        svc.slo.evaluate()  # both at one logical point, not the loop's tick
        st, headers, doc = cl.json("GET", "/alerts")
        # a latency objective's state reads the clock (its threshold is
        # tens of milliseconds): compared where the clock cannot reach
        clocked = {r["slo"] for r in doc["slos"] if r["kind"] == "latency"}
        doc["slos"] = [{k: v for k, v in r.items()
                        if r["slo"] not in clocked or k != "state"}
                       for r in doc["slos"]]
        doc["alerts"] = [a for a in doc["alerts"]
                         if a.get("slo") not in clocked]
        rec("alerts", st, headers, doc)
        status, headers, raw = cl.call(
            "POST", "/check", json.dumps({"history": [],
                                          "pad": "x" * 60000}).encode())
        rec("413", status, headers, json.loads(raw))
        rec("400-model", *cl.json("POST", "/check", {"history": [],
                                                     "model": "nope"}))
        rec("400-history", *cl.json("POST", "/check", {"history": "nope"}))
        rec("404-post", *cl.json("POST", "/nowhere", {}))
        # streams: one-shot, then open / feed / overlap / gap / close
        rec("stream-oneshot", *cl.json("POST", "/stream", ndjson=[
            {"model": "cas-register"}, *bad, {"end": True}]))
        rec("stream-open", *cl.json("POST", "/stream", ndjson=[
            {"model": "cas-register", "stream_id": "h1"}]))
        rec("stream-feed", *cl.json("POST", "/stream/h1", ndjson=[
            {"seq": 0}, *bad[:10]]))
        rec("stream-overlap", *cl.json("POST", "/stream/h1", ndjson=[
            {"seq": 5}, *bad[5:14]]))
        rec("stream-status", *cl.json("GET", "/stream/h1"))
        rec("stream-full", *cl.json("POST", "/stream", ndjson=[
            {"stream_id": "h2"}]))
        rec("stream-gap", *cl.json("POST", "/stream/h1", ndjson=[
            {"seq": 25}, *bad[25:]]))
        rec("stream-tail", *cl.json("POST", "/stream/h1", ndjson=[
            {"seq": 14}, *bad[14:]]))
        doc = rec("stream-close", *cl.json("POST", "/stream/h1/close", {}))
        assert doc["result"]["valid?"] is False
        rec("stream-404", *cl.json("POST", "/stream/nope", ndjson=bad[:2]))
        rec("stream-get-404", *cl.json("GET", "/stream/nope"))
        rec("trace", *cl.json("GET", "/trace/run/t1"))
        rec("trace-404", *cl.json("GET", "/trace/run/none"))
        rec("telemetry-off", *cl.json("GET", "/telemetry"))
        status, headers, raw = cl.call("GET", "/metrics")
        text = raw.decode()
        # device.buffer_bytes: the port on the CPU has no allocator count
        # and emits none (ROADMAP C4); the compile- and runner-cache hit or
        # miss series follow what this process launched before the script
        series = sorted({re.sub(r"[ {].*", "", ln) for ln in text.splitlines()
                         if ln and not ln.startswith("#")
                         and not re.search(r"_cache_(hit|miss)_total", ln)}
                        - {"jepsen_tpu_device_buffer_bytes"})
        counters = sorted(ln for ln in text.splitlines() if re.match(
            r"jepsen_tpu_serve_(submitted|completed|verdicts|oversized)", ln))
        out.append(("metrics", status, headers["Content-Type"], series,
                    counters))
        # backpressure on a service with no scheduler: one fills it
        svc2 = P.sv.CheckService(max_queue=1, **svc_kw(P))
        srv.RequestHandlerClass.check_service = svc2
        rec("fill", *cl.json("POST", "/check", {"history": good}))
        rec("429", *cl.json("POST", "/check", {"history": bad}))
        srv.RequestHandlerClass.check_service = svc
        svc2.shutdown(drain=False)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.shutdown(drain=False)
    return out


def test_check_api_answers_like_the_jax_package(monkeypatch, tmp_path):
    out = {}
    for name in ("jax", "port"):
        pin_ids(monkeypatch)
        d = tmp_path / name
        d.mkdir()
        out[name] = _check_script(PKG[name], name, d)
    assert [r[0] for r in out["port"]] == [r[0] for r in out["jax"]]
    diffs = [f"{lj}: " + first_diff(j, p)
             for (lj, *j), (_lp, *p) in zip(out["jax"], out["port"]) if j != p]
    assert not diffs, "\n".join(diffs)
    codes = {label: status for label, status, *_ in out["port"]}
    assert codes["wait"] == 200 and codes["async"] == 202
    assert codes["resubmit"] == 200 and codes["413"] == 413
    assert codes["429"] == 429 and codes["stream-gap"] == 409
    assert codes["stream-full"] == 429 and codes["trace"] == 200
    assert dict((lb, ra) for lb, _s, ra, *_ in out["port"])["429"] is True


def _write_store(name, base):
    """Three runs through ``save_0``..``save_2`` (one refuted, one cut
    after ``save_1``), a run's telemetry.json, and a perf ledger."""
    store = STORE[name]
    good, bad = _hists()
    for tname, ts, hist, valid, phases in (
            ("reg", "20260101T000000.000Z", good, True, 3),
            ("reg", "20260101T000001.000Z", bad, False, 3),
            ("other", "20260101T000002.000Z", good, None, 2)):
        t = {"name": tname, "start-time-str": ts, "store-dir": str(base),
             "history": hist, "results": {"valid?": valid}}
        store.save_0(t)
        if phases > 1:
            store.save_1(t)
        if phases > 2:
            store.save_2(t)
    run = base / "reg" / "20260101T000000.000Z"
    (run / "telemetry.json").write_text(json.dumps({
        "wall_s": 1.5, "phases": [{"phase": "analyze", "wall_s": 1.0,
                                   "count": 1}],
        "ladder": [{"stage": 0, "engine": "greedy", "capacity": 1,
                    "lanes": 2, "seconds": 0.5, "device_bytes_peak": 2 ** 20}],
        "serve": {"batches": 1, "requests": 2,
                  "request": {"mean_s": 0.2, "max_s": 0.3}},
        "critpath": {"total_s": 1.0, "wall_s": 1.5, "spans": [
            {"span": "ladder.stage", "cp_s": 0.5, "total_s": 0.5,
             "count": 1, "slack_s": 0.0}]},
        "counters": {"serve.completed": 2}}))
    (run / "telemetry.jsonl").write_text(
        "\n".join(json.dumps(e) for e in TELEMETRY) + "\n")
    (run / "evidence").mkdir()
    (run / "evidence" / "b.json").write_text("{}")
    reg = REG[name]
    fp = {"torch": "t", "backend": "cpu", "host": "h"}
    for v in (100.0, 110.0):
        rec = reg.make_record("bench", {"ops_per_s": v}, fp=fp)
        rec["ts"], rec["git"] = 1.7e9, {"sha": "abc"}
        reg.append_record(rec, base / "perf-ledger.jsonl")
    comp = reg.run_competition("dedup_backend", ["sort", "bucket"],
                               runner=lambda v: [0.2] if v == "sort" else [0.1])
    comp["ts"], comp["git"] = 1.7e9, {"sha": "abc"}
    comp["fingerprint_key"] = "k"
    reg.append_record(comp, base / "perf-ledger.jsonl")


def _norm_page(text, d):
    text = text.replace(str(d), "D")
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d", "TIME", text)
    return re.sub(r"on [0-9a-f]{12}<", "on KEY<", text)


def _browse(name, d, monkeypatch):
    base = d / "store"
    _write_store(name, base)
    monkeypatch.delenv(REG[name].ENV_LEDGER, raising=False)
    WEB[name]._INDEX_CACHE.clear()
    WEB[name]._VALID_CACHE.clear()
    srv = serving(None, name, d)
    MET[name].REGISTRY.reset()
    cl = Client(srv)
    out = {}
    try:
        for path in ("/", "/index.html", "/suite", "/perf",
                     "/files/reg/20260101T000000.000Z/", "/files/reg/",
                     "/files/reg/20260101T000000.000Z/history.txt",
                     "/files/reg/20260101T000000.000Z/test.json",
                     "/files/..%2f..%2fetc/passwd", "/files/nope",
                     "/zip/..%2f..", "/readyz", "/queue", "/alerts",
                     "/evidence/x", "/check/x", "/fleet", "/nowhere"):
            status, headers, raw = cl.call("GET", path)
            body = raw.decode("utf-8", "replace")
            out[path] = (status, headers.get("Content-Type"),
                         _norm_page(body, d))
        status, headers, raw = cl.call(
            "GET", "/zip/reg/20260101T000000.000Z")
        names = sorted(zipfile.ZipFile(io.BytesIO(raw)).namelist())
        out["zip"] = (status, headers.get("Content-Type"), names)
        out["rows"] = [(n, ts, v) for n, ts, _d, v in
                       WEB[name].run_index(str(base))]
    finally:
        srv.shutdown()
        srv.server_close()
    return out


def test_store_pages_are_equal(monkeypatch, tmp_path):
    out = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        out[name] = _browse(name, d, monkeypatch)
    for key in out["jax"]:
        if out["port"][key] != out["jax"][key]:
            pytest.fail(f"{key}: " + first_diff(out["jax"][key],
                                                out["port"][key]))
    got = out["port"]
    assert got["rows"] == [("other", "20260101T000002.000Z", None),
                           ("reg", "20260101T000000.000Z", True),
                           ("reg", "20260101T000001.000Z", False)]
    assert got["/files/..%2f..%2fetc/passwd"][0] == 404
    assert got["/zip/..%2f.."][0] == 404
    assert got["/"][0] == 200 and "reg" in got["/"][2]
    assert "<svg" in got["/perf"][2] and "competition verdicts" in got["/perf"][2]
    assert "ladder stages" in got["/files/reg/20260101T000000.000Z/"][2]
    assert got["zip"][0] == 200
    assert "20260101T000000.000Z/run.jepsen" in " ".join(got["zip"][2])


def test_web_store_browsing_loads_no_torch():
    """Browsing a store through the port's web app imports no torch (the
    service is reached lazily)."""
    import subprocess
    import sys

    code = ("import json, sys, tempfile\n"
            "from jepsen_tpu_torch import web\n"
            "d = tempfile.mkdtemp()\n"
            "web.home_html(d); web.suite_html(d); web.perf_html(d)\n"
            "print(json.dumps([k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'jax', 'jepsen_tpu')]))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parent.parent))
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
