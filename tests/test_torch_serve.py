"""The port's check service (``jepsen_tpu_torch.serve``) against the JAX
package's ``CheckService`` on the same submissions.

Each case of tests/test_serve.py that needs no HTTP server runs here in
both packages, and what the two return is compared: per request the
verdict, ``status``, ``quarantined`` and ``cause``; the deterministic
keys of ``stats()`` (the clock's EWMAs, retry-after hints and uptimes
out) and of each result's latency block (which keys are present); and,
where a case records, the ``serve.*`` events once normalized as
tests/test_torch_telemetry.py normalizes a stream.  Request and trace
ids (``uuid.uuid4``) and the evidence bundles' machine block are pinned
alike in both packages, and the port runs under the JAX package's
default "sort" backend, so ids, traces and evidence digests are equal.
The port runs on the CPU (``device="cpu"``).  Shapes: the (30, 3)
register histories of tests/test_serve.py at capacity (64, 256).

The helpers here (``PKG``, ``both``, ``outcome``, ``stats_core``,
``serve_stream``) are shared by the other ``test_torch_serve_*`` files.
"""

import itertools
import json
import threading
import types
import uuid

import numpy as np
import pytest
import torch

from jepsen_tpu import faults as jf
from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu import obs as jobs
from jepsen_tpu import serve as jsv
from jepsen_tpu.obs import metrics as jmet
from jepsen_tpu.obs import provenance as jprov
from jepsen_tpu.parallel import batch as jb
from jepsen_tpu.serve import health as jhealth
from jepsen_tpu_torch import faults as tf
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import obs as tobs
from jepsen_tpu_torch import serve as tsv
from jepsen_tpu_torch.obs import metrics as tmet
from jepsen_tpu_torch.obs import provenance as tprov
from jepsen_tpu_torch.ops import hashing as thashing
from jepsen_tpu_torch.parallel import batch as tb
from jepsen_tpu_torch.serve import health as thealth
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history
from test_torch_telemetry import normalize

CAP = (64, 256)
MACHINE = {"host": "h", "cpu": "c", "python": "3"}

PKG = {
    "jax": types.SimpleNamespace(
        name="jax", sv=jsv, m=jm, faults=jf, obs=jobs, batch=jb,
        health=jhealth, history=jh, prov=jprov, dev={}),
    "port": types.SimpleNamespace(
        name="port", sv=tsv, m=tm, faults=tf, obs=tobs, batch=tb,
        health=thealth, history=th, prov=tprov, dev={"device": "cpu"}),
}

#: keys of stats() and of the status documents that read the clock
#: (EWMAs, retry-after quotes, ages, a stream's detection time), or the
#: process-wide spill totals, at any depth.
CLOCK_KEYS = {"batch_ewma_s", "continuous_occupancy", "rung_lane_s",
              "rung_slot_s", "retry_after_hint_s", "uptime_s", "ewma_s",
              "retry_after_s", "watchdog_timeout_s", "memory", "dir",
              "age_s", "seconds", "epoch_seconds"}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """One torch thread; fast retries; the port under the JAX package's
    default backend; both packages' bundle machine blocks pinned; the
    injectors and the metrics mirrors restored after (a started service
    turns its package's mirror on)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("JEPSEN_TPU_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("JEPSEN_TPU_RETRY_MAX_S", "0.002")
    monkeypatch.setattr(thashing, "DEDUP_BACKEND", "sort")
    monkeypatch.setattr(jprov, "machine_fingerprint", lambda: dict(MACHINE))
    monkeypatch.setattr(tprov, "machine_fingerprint", lambda: dict(MACHINE))
    saved = jmet.MIRROR, tmet.MIRROR
    yield
    torch.set_num_threads(n)
    jf.INJECT = None
    tf.INJECT = None
    jmet.enable_mirror(saved[0])
    tmet.enable_mirror(saved[1])


def pin_ids(monkeypatch):
    """``uuid.uuid4`` as a counter (request, trace, stream and bundle
    ids), restarted for each package's run: the ids are equal in the
    two runs, and distinct in the 12- and 16-hex-digit prefixes the
    service cuts."""
    counter = itertools.count(1)
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=next(counter) << 96))


def svc_kw(P, **kw):
    """The suite's service configuration in package ``P`` (the port on
    the CPU)."""
    return dict(capacity=CAP, warm_pool=False, **P.dev, **kw)


def direct(P, hists, **kw):
    """A direct ``batch_analysis`` over ``hists`` in package ``P``."""
    return P.batch.batch_analysis(P.m.CASRegister(None), hists, capacity=CAP,
                                  **P.dev, **kw)


def mixed_histories(n=6):
    hists = []
    for i in range(n):
        hist = valid_register_history(30, 3, seed=i, info_rate=0.1)
        if i % 3 == 2:
            hist = corrupt(hist, seed=i)
        hists.append(hist)
    return hists


def stats_core(st):
    """``stats()`` without its clock-read keys (``CLOCK_KEYS``)."""
    if isinstance(st, dict):
        return {k: stats_core(v) for k, v in st.items() if k not in CLOCK_KEYS}
    return st


def outcome(svc, futs, timeout=60, scrub=None):
    """Per request: verdict, status, quarantined, cause (``scrub``
    replaced by "DIR") and the latency block's keys; the evidence
    pointer's id and digest."""
    out = []
    for f in futs:
        r = f.result(timeout=timeout)
        cause = r.get("cause")
        if scrub is not None and isinstance(cause, str):
            cause = cause.replace(str(scrub), "DIR")
        req = svc.get(f.id)
        ev = r.get("evidence") or {}
        out.append({
            "valid?": r["valid?"], "status": req.status if req else None,
            "quarantined": r.get("quarantined"), "cause": cause,
            "latency": sorted(r.get("latency") or {}),
            "evidence": (ev.get("id"), ev.get("digest")),
        })
    return out


#: serve-event attributes that read the clock.
SERVE_CLOCK_ATTRS = {"seconds", "continuous_occupancy"}


def serve_stream(events, d):
    """The ``serve.*`` (and the stream lane's ``stream.*``) events of a
    recording, normalized (tests/test_torch_telemetry.py's cuts, the
    clock-read serve attributes out)."""
    picked = []
    for e in events:
        if not str(e.get("name", "")).startswith(("serve.", "stream.")):
            continue
        e = dict(e)
        e["attrs"] = {k: v for k, v in (e.get("attrs") or {}).items()
                      if k not in SERVE_CLOCK_ATTRS}
        picked.append(e)
    return normalize(picked, d)


def first_diff(a, b, path="") -> str:
    """Where ``a`` and ``b`` first differ, with both values."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in list(a) + [k for k in b if k not in a]:
            if a.get(k) != b.get(k):
                return first_diff(a.get(k), b.get(k), f"{path}[{k!r}]")
    if (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
            and len(a) == len(b)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_diff(x, y, f"{path}[{i}]")
    return f"{path or '.'}: jax {a!r} != port {b!r}"


def both(monkeypatch, tmp_path, run, record=False):
    """``run(P, d)`` in each package (ids pinned alike, ``d`` a fresh
    directory, under a recording of ``d / "rec"`` when ``record``);
    asserts the two returns equal (and the normalized serve streams)
    and returns the port's."""
    out, streams = {}, {}
    for name in ("jax", "port"):
        pin_ids(monkeypatch)
        P = PKG[name]
        d = tmp_path / name
        d.mkdir()
        if record:
            with P.obs.recording(d / "rec") as rec:
                out[name] = run(P, d)
            streams[name] = serve_stream(rec.events, d)
        else:
            out[name] = run(P, d)
    if out["port"] != out["jax"]:
        pytest.fail("the packages differ at "
                    + first_diff(out["jax"], out["port"]))
    if record:
        got, want = streams["port"], streams["jax"]
        if got != want:
            diff = {k: (want[k], got[k]) for k in set(want) | set(got)
                    if want[k] != got[k]}
            pytest.fail("serve streams differ (jax, port): "
                        + json.dumps(diff, indent=1))
        assert got
    return out["port"]


# ---------------------------------------------------------------------------
# tests/test_serve.py's cases
# ---------------------------------------------------------------------------


def test_submit_batches_with_verdict_parity(monkeypatch, tmp_path):
    """Six submissions share ONE launch in each package; verdicts equal
    a direct batch_analysis and the JAX service's, as do statuses,
    evidence digests, stats and the serve stream."""
    hists = mixed_histories(6)

    def run(P, d):
        want = [r["valid?"] for r in direct(P, hists)]
        svc = P.sv.CheckService(evidence_dir=d / "ev", **svc_kw(P))
        futs = [svc.submit(hh, client=f"tenant-{i % 2}")
                for i, hh in enumerate(hists)]
        depth = svc.stats()["queue_depth"]
        svc.step()
        got = outcome(svc, futs)
        assert [g["valid?"] for g in got] == want
        st = svc.stats()
        assert st["batches"] == 1 and st["completed"] == 6
        files = {p.name: p.read_bytes() for p in sorted((d / "ev").iterdir())}
        # a fresh service reads the bundles back from the durable dir
        fresh = P.sv.CheckService(evidence_dir=d / "ev", **svc_kw(P))
        back = [fresh.get_evidence(f.id)["digest"] for f in futs]
        assert back == [g["evidence"][1] for g in got]
        return depth, got, stats_core(st), files

    depth, _, _, files = both(monkeypatch, tmp_path, run, record=True)
    assert depth == 6 and len(files) == 6


def test_trivial_and_untensorizable_fast_paths(monkeypatch, tmp_path):
    def run(P, d):
        svc = P.sv.CheckService(**svc_kw(P))
        f_triv = svc.submit([])
        assert f_triv.done() and f_triv.result()["valid?"] is True
        assert svc.stats()["queue_depth"] == 0
        fifo_hist = [P.history.op(P.history.INVOKE, 0, "enqueue", 1),
                     P.history.op(P.history.OK, 0, "enqueue", 1)]
        f_fifo = svc.submit(fifo_hist, model=P.m.FIFOQueue())
        svc.step()
        assert f_fifo.result(timeout=10)["valid?"] is True
        return outcome(svc, [f_triv, f_fifo]), stats_core(svc.stats())

    both(monkeypatch, tmp_path, run)


def test_priority_orders_batches(monkeypatch, tmp_path):
    wide = [valid_register_history(30, 12, seed=s, info_rate=0.1)
            for s in (2, 3)]
    hists = mixed_histories(4)

    def run(P, d):
        svc = P.sv.CheckService(max_batch=2, **svc_kw(P))
        f_low = [svc.submit(hh, priority=0, client="batch") for hh in wide]
        f_high = [svc.submit(hh, priority=5, client="interactive")
                  for hh in hists[2:]]
        svc.step()
        order = [[f.done() for f in f_high], [f.done() for f in f_low]]
        svc.step()
        assert all(f.done() for f in f_low)
        assert svc.stats()["batches"] == 2
        return order, outcome(svc, f_high + f_low), stats_core(svc.stats())

    order, _, _ = both(monkeypatch, tmp_path, run, record=True)
    assert order == [[True, True], [False, False]]


def test_backpressure_rejects_not_buffers(monkeypatch, tmp_path):
    hists = mixed_histories(3)

    def run(P, d):
        svc = P.sv.CheckService(max_queue=2, **svc_kw(P))
        svc.submit(hists[0])
        svc.submit(hists[1])
        with pytest.raises(P.sv.QueueFull) as ei:
            svc.submit(hists[2])
        assert ei.value.retry_after > 0
        rej = (ei.value.depth, ei.value.limit, ei.value.tier)
        st = stats_core(svc.stats())
        svc.step()
        svc.submit(hists[2])
        return rej, st, svc.stats()["queue_depth"]

    rej, st, depth = both(monkeypatch, tmp_path, run)
    assert rej == (2, 2, "batch") and st["rejected"] == 1 and depth == 1


def test_bad_submit_releases_admission_slot(monkeypatch, tmp_path):
    def run(P, d):
        svc = P.sv.CheckService(max_queue=1, **svc_kw(P))
        for _ in range(3):
            with pytest.raises(ValueError):
                svc.submit([], priority="high")
        f = svc.submit([])
        return outcome(svc, [f]), stats_core(svc.stats())

    got, _ = both(monkeypatch, tmp_path, run)
    assert got[0]["valid?"] is True


def test_done_callback_may_reenter_service(monkeypatch, tmp_path):
    def run(P, d):
        svc = P.sv.CheckService(**svc_kw(P))
        seen = []
        f = svc.submit([])
        f.add_done_callback(lambda fut: seen.append(svc.stats()["queue_depth"]))
        f2 = svc.submit(mixed_histories(1)[0], deadline=P.faults.Deadline(0.0))
        f2.add_done_callback(lambda fut: seen.append(svc.stats()["expired"]))
        svc.step()
        return seen, outcome(svc, [f, f2])

    seen, _ = both(monkeypatch, tmp_path, run, record=True)
    assert seen == [0, 1]


def test_geometry_groups_batch_separately(monkeypatch, tmp_path):
    small = valid_register_history(30, 3, seed=1, info_rate=0.1)
    wide = valid_register_history(30, 12, seed=2, info_rate=0.1)

    def run(P, d):
        svc = P.sv.CheckService(**svc_kw(P))
        f1, f2 = svc.submit(small), svc.submit(wide)
        groups = svc.stats()["queue_groups"]
        svc.step()
        svc.step()
        return groups, outcome(svc, [f1, f2]), stats_core(svc.stats())

    groups, got, st = both(monkeypatch, tmp_path, run)
    assert groups == 2 and st["batches"] == 2
    assert [g["valid?"] for g in got] == [True, True]


def test_deadline_expiry_degrades_only_that_request(monkeypatch, tmp_path):
    hists = mixed_histories(3)

    def run(P, d):
        svc = P.sv.CheckService(**svc_kw(P))
        f_dead = svc.submit(hists[0], deadline=P.faults.Deadline(0.0))
        f_live = [svc.submit(hh) for hh in hists[1:]]
        svc.step()
        want = [r["valid?"] for r in direct(P, hists[1:])]
        got = outcome(svc, [f_dead] + f_live)
        assert [g["valid?"] for g in got[1:]] == want
        return got, stats_core(svc.stats())

    got, st = both(monkeypatch, tmp_path, run, record=True)
    assert got[0]["valid?"] == "unknown" and got[0]["status"] == "expired"
    assert "deadline-exceeded" in got[0]["cause"]
    assert st["expired"] == 1 and st["batches"] == 1


def _drain_files(root):
    """Every file of a drain dir (the checkpoint pair and the durable
    drain meta), by path relative to ``root``, with the group's
    timestamped name replaced."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = p.relative_to(root).parts
            out["/".join(("GROUP",) + rel[1:])] = p.read_bytes()
    return out


def test_drain_checkpoints_and_resume_matches_direct(monkeypatch, tmp_path):
    """Shutdown with queued work drains it into a resumable checkpoint,
    whose files (the store.checkpoint pair and the durable drain meta)
    are the JAX package's byte for byte; resume_drained in each package
    gives the direct verdicts."""
    hists = mixed_histories(4)
    drain = tmp_path / "drain"  # one path for both: causes name it

    def run(P, d):
        svc = P.sv.CheckService(drain_dir=drain, **svc_kw(P))
        futs = [svc.submit(hh, client="t") for hh in hists]
        summary = svc.shutdown(drain=True)
        assert summary["drained"] == 4 and len(summary["checkpoints"]) == 1
        got = outcome(svc, futs)
        with pytest.raises(P.sv.ServiceClosed):
            svc.submit(hists[0])
        files = _drain_files(drain)
        groups = P.sv.resume_drained(drain, **P.dev)
        assert len(groups) == 1
        want = [r["valid?"] for r in direct(P, hists)]
        assert [r["valid?"] for r in groups[0]["results"]] == want
        drain.rename(d / "drain")
        return got, files, stats_core(svc.stats()), groups[0]["ids"]

    monkeypatch.setattr(jsv.service.store, "time_str", lambda: "T")
    monkeypatch.setattr(tsv.service.store, "time_str", lambda: "T")
    got, files, _, _ = both(monkeypatch, tmp_path, run)
    assert all(f"resumable drain checkpoint: {drain}/T-g00" in g["cause"]
               for g in got)
    assert {"GROUP/drained.json"} < set(files)


def test_shutdown_wait_finishes_backlog(monkeypatch, tmp_path):
    hists = mixed_histories(3)

    def run(P, d):
        svc = P.sv.CheckService(**svc_kw(P))
        futs = [svc.submit(hh) for hh in hists]
        svc.shutdown(drain=True, wait=True)
        got = outcome(svc, futs)
        assert [g["valid?"] for g in got] == [
            r["valid?"] for r in direct(P, hists)]
        return got, stats_core(svc.stats())

    both(monkeypatch, tmp_path, run)


def test_threaded_service_concurrent_submitters():
    """The started scheduler: 8 concurrent submitters get the direct
    verdicts in each package, in far fewer launches than callers (the
    grouping follows the threads' timing, so only the verdicts are
    compared across packages)."""
    hists = mixed_histories(8)
    verdicts = {}
    for name in ("jax", "port"):
        P = PKG[name]
        want = [r["valid?"] for r in direct(P, hists)]
        svc = P.sv.CheckService(batch_window_s=0.05, **svc_kw(P)).start()
        try:
            futs = [None] * 8

            def one(i):
                futs[i] = svc.submit(hists[i], client=f"c{i}")

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            got = [futs[i].result(timeout=60)["valid?"] for i in range(8)]
            assert got == want
            assert svc.stats()["batches"] <= 4
            verdicts[name] = got
        finally:
            svc.shutdown(drain=False)
    assert verdicts["port"] == verdicts["jax"]


def test_serve_telemetry_rollup(monkeypatch, tmp_path):
    """The summaries' serve sections (latencies aside) and the
    normalized serve streams are equal; the port's renders the check
    service block."""
    hists = mixed_histories(3)
    sections = {}

    def run(P, d):
        svc = P.sv.CheckService(max_queue=2, **svc_kw(P))
        futs = [svc.submit(hh) for hh in hists[:2]]
        with pytest.raises(P.sv.QueueFull):
            svc.submit(hists[2])
        svc.step()
        return outcome(svc, futs)

    for name in ("jax", "port"):
        pin_ids(monkeypatch)
        P = PKG[name]
        with P.obs.recording(tmp_path / name) as rec:
            run(P, tmp_path / name)
        sv_ = dict(rec.summary["serve"])
        for k in ("admission", "request"):
            sv_[k] = (sv_[k]["count"], sorted(sv_[k]))
        sv_["request_by_class"] = {t: (v["count"], sorted(v)) for t, v in
                                   sv_["request_by_class"].items()}
        sv_.pop("batch_wall_s")
        sections[name] = (sv_, rec.summary["counters"].get("serve.completed"),
                          serve_stream(rec.events, tmp_path / name))
    assert sections["port"] == sections["jax"]
    s = sections["port"][0]
    assert s["batches"] == 1 and s["requests"] == 2
    assert s["avg_occupancy"] == 0.25 and s["avg_padding_waste"] == 0.75
    assert s["submitted"] == 2 and s["rejected"] == 1
    assert sections["port"][1] == 2
    from jepsen_tpu_torch.obs.summary import format_summary

    assert "check service" in format_summary(rec.summary)


# ---------------------------------------------------------------------------
# serve.slo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_slo_engine_matches_jax(tmp_path, seed):
    """``SloEngine`` over its own registry in each package, fed the same
    sample sequence (request latencies per class, submissions and
    expiries, an occupancy gauge) and evaluated at the same injected
    times: every row, burn rate, state and the alerts document equal;
    ``load_specs`` merges a file over the defaults alike."""
    from jepsen_tpu.serve import slo as jslo
    from jepsen_tpu_torch.serve import slo as tslo

    spec_file = tmp_path / "slo.json"
    spec_file.write_text(json.dumps([
        {"name": "interactive-p50", "kind": "latency",
         "metric": "serve.class_request_latency_seconds",
         "labels": {"tier": "interactive"}, "threshold_s": 0.01,
         "target": 0.5, "burn_threshold": 1.5},
        {"name": "batch-p90", "kind": "latency",
         "metric": "serve.class_request_latency_seconds",
         "labels": {"tier": "batch"}, "threshold_s": 2.0, "target": 0.9},
    ]))
    out = {}
    for name, S, M in (("jax", jslo, jmet), ("port", tslo, tmet)):
        rng = np.random.default_rng(seed)
        reg = M.Registry()
        eng = S.SloEngine(S.load_specs(spec_file), registry=reg,
                          fast_window_s=30.0, slow_window_s=300.0)
        rows = [eng.evaluate(now=0.0)]
        t = 0.0
        for _ in range(60):
            t += float(rng.integers(1, 20))
            for _k in range(int(rng.integers(0, 6))):
                tier = ("interactive", "batch")[int(rng.integers(0, 2))]
                reg.observe("serve.class_request_latency_seconds",
                            float(rng.choice([0.002, 0.02, 0.3, 3.0])),
                            tier=tier)
                reg.inc("serve.submitted")
                if rng.random() < 0.05:
                    reg.inc("serve.expired")
            if rng.random() < 0.5:
                reg.set("serve.continuous_occupancy",
                        float(rng.choice([0.05, 0.5, 0.9])))
            rows.append(eng.evaluate(now=t))
        out[name] = (rows, eng.alerts(), [s["name"] for s in eng.specs])
        for bad in ({"name": "x", "kind": "nope"},
                    {"name": "y", "kind": "ratio", "bad": "a"},
                    {"name": "z", "kind": "latency", "metric": "m",
                     "threshold_s": 1, "target": 1.5}):
            with pytest.raises(ValueError) as ei:
                S.SloEngine([bad], registry=reg)
            out[name] += (str(ei.value),)
    assert out["port"] == out["jax"]
    states = {r["state"] for rs in out["port"][0] for r in rs}
    assert "firing" in states and "ok" in states
    assert len(out["port"][2]) == 5  # 4 defaults, one replaced, one added


# ---------------------------------------------------------------------------
# Beyond tests/test_serve.py: streams and idempotent resubmission
# ---------------------------------------------------------------------------


def test_stream_lane_matches_jax(monkeypatch, tmp_path):
    """An op stream through the service in each package: fed in epochs,
    a corrupted history is refuted mid-stream; the status documents
    (ages aside), the closing result, the evidence digest and the
    per-stream checkpoint files are equal; a second open beyond
    ``max_streams`` is refused on the stream tier; a killed stream
    resumes from its checkpoint with the same verdict."""
    hist = mixed_histories(3)[2]

    def run(P, d):
        svc = P.sv.CheckService(max_streams=1, stream_dir=d / "streams",
                                **svc_kw(P))
        sid = svc.stream_open(model=P.m.CASRegister(None))["stream-id"]
        with pytest.raises(P.sv.QueueFull) as ei:
            svc.stream_open(model=P.m.CASRegister(None))
        docs = []
        for k in range(0, len(hist) // 2, 16):
            docs.append(stats_core(svc.stream_feed(sid, hist[k: k + 16],
                                                   seq=k)))
        files = {str(p.relative_to(d)): p.read_bytes()
                 for p in sorted((d / "streams").rglob("*")) if p.is_file()}
        # a second service resumes the killed stream from its checkpoint
        svc2 = P.sv.CheckService(stream_dir=d / "streams", **svc_kw(P))
        opened = stats_core(svc2.stream_open(
            model=P.m.CASRegister(None), stream_id=sid, resume=True))
        svc2.stream_feed(sid, hist[len(hist) // 2:], seq=len(hist) // 2)
        closed = stats_core(svc2.stream_close(sid))
        closed["result"] = {k: v for k, v in closed["result"].items()
                            if k != "provenance"}
        return (ei.value.tier, docs, files, opened, closed,
                stats_core(svc2.stats())["streams_resumed"])

    tier, docs, files, opened, closed, resumed = both(
        monkeypatch, tmp_path, run, record=True)
    assert tier == "stream" and files and resumed == 1
    assert opened["ops"] == 32  # two epochs of 16 before the kill
    assert closed["result"]["valid?"] is False and closed["evidence"]


def test_idempotent_resubmission_matches_jax(monkeypatch, tmp_path):
    """A duplicate submit under one idempotency key attaches to the
    in-flight request, then gets the settled result under the original
    id, across a restart when the map is journaled; a key reused for
    another history is refused."""
    hists = mixed_histories(2)

    def run(P, d):
        kw = svc_kw(P, idempotency_dir=d / "idem", journal_dir=d / "journal")
        svc = P.sv.CheckService(**kw)
        f1 = svc.submit(hists[0], idempotency_key="k")
        f2 = svc.submit(hists[0], idempotency_key="k")
        same = f1 is f2
        with pytest.raises(ValueError, match="DIFFERENT history"):
            svc.submit(hists[1], idempotency_key="k")
        svc.step()
        first = outcome(svc, [f1])
        svc2 = P.sv.CheckService(**kw)
        svc2.recover()
        f3 = svc2.submit(hists[0], idempotency_key="k")
        return (same, first, f3.id == f1.id, f3.result()["valid?"],
                stats_core(svc.stats())["idempotent_hits"],
                stats_core(svc2.stats()))

    same, _, same_id, v, hits, st2 = both(monkeypatch, tmp_path, run)
    assert same and same_id and v is True and hits == 1
    assert st2["idempotent_hits"] == 1


def test_store_time_str_matches_jax():
    """The drain dirs' timestamp, as the JAX package's store forms it."""
    import datetime

    from jepsen_tpu import store as jstore
    from jepsen_tpu_torch import store as tstore

    for t in (datetime.datetime(2026, 1, 2, 3, 4, 5, 678901),
              datetime.datetime(1999, 12, 31, 23, 59, 59)):
        assert tstore.time_str(t) == jstore.time_str(t)
    assert len(tstore.time_str()) == len(jstore.time_str())
