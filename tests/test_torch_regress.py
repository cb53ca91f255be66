"""The performance-regression observatory (``obs.regress``) in the port
against the JAX package.

The cases of tests/test_perfwatch.py that exercise ``regress`` run in
both packages on the same records (made once, read by both), and what
each returns is compared at tolerance 0: the ledger's records, the
noise band and metric direction, ``compare_records``, ``gate``'s
verdict and report, ``stage_rollup``, ``diff_stage_tables`` and its
text, ``run_competition`` with a stub runner, and the registry text
``publish_gauges`` renders.  Each package reads the other's ledger.
The port's fingerprint names torch, so the packages' keys never meet.
One ``_default_runner("dedup_backend")`` run on the CPU shows each axis
value reaching its own backend in the ladder's stage rows.
"""

import json

import pytest
import torch

from jepsen_tpu.obs import metrics as jmet
from jepsen_tpu.obs import regress as jreg
from jepsen_tpu_torch import obs as tobs
from jepsen_tpu_torch.obs import metrics as tmet
from jepsen_tpu_torch.obs import regress as treg

REG = {"jax": jreg, "port": treg}
MET = {"jax": jmet, "port": tmet}

#: a pinned fingerprint (tests/test_perfwatch.py's)
FP = {"jax": "0.4.0", "jaxlib": "0.4.0", "backend": "cpu",
      "device_kind": "cpu", "device_count": 8, "cpu": "test-cpu",
      "host": "test-host", "python": "3.10"}
FP_OTHER = {**FP, "device_kind": "TPU v4", "backend": "tpu"}
GIT = {"sha": "0123456789abcdef", "dirty": False}


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
def _pinned(monkeypatch):
    """git pinned alike in both packages (no subprocess per record); the
    metrics mirrors restored after."""
    for r in REG.values():
        monkeypatch.setattr(r, "git_info", lambda: dict(GIT))
    saved = jmet.MIRROR, tmet.MIRROR
    yield
    jmet.enable_mirror(saved[0])
    tmet.enable_mirror(saved[1])


def _bench(value, *, fp=FP, stages=None, reg=jreg, **extra):
    return reg.make_record(
        "bench", {"fixed_work_configs_per_s": value, **extra},
        stages=stages, fp=fp)


def _write(reg, path, records):
    for r in records:
        reg.append_record(r, path)
    return path


def _drop_ts(rec):
    return {k: v for k, v in rec.items() if k != "ts"}


def test_records_are_equal_but_for_the_fingerprint_key():
    """``make_record`` builds the same record in both packages; only the
    fingerprint key differs (the key fields name each stack)."""
    kw = dict(stages={"a": 1.0}, axes={"x": 1}, extra={"e": [1]}, fp=FP)
    j = jreg.make_record("bench", {"m": 1.5, "flag": True}, **kw)
    t = treg.make_record("bench", {"m": 1.5, "flag": True}, **kw)
    assert j.pop("fingerprint_key") != t.pop("fingerprint_key")
    assert _drop_ts(j) == _drop_ts(t)
    assert treg._KEY_FIELDS == ("torch", "cuda", "backend", "device_kind",
                                "device_count", "cpu", "host")


@pytest.mark.parametrize("writer", sorted(REG))
def test_each_package_reads_the_others_ledger(tmp_path, writer):
    w = REG[writer]
    p = _write(w, tmp_path / "ledger.jsonl",
               [_bench(100.0, reg=w), _bench(101.0, reg=w)])
    with open(p, "a") as fh:
        fh.write("not json at all\n")
        fh.write('{"kind": "bench", "metrics": {"fixed_work_configs_per_s"')
    got = {k: r.read_records_checked(p) for k, r in REG.items()}
    assert got["port"] == got["jax"]
    recs, skipped = got["port"]
    assert len(recs) == 2 and skipped == 2
    assert recs[0]["metrics"]["fixed_work_configs_per_s"] == 100.0
    assert recs[0]["fingerprint_key"] == w.fingerprint_key(FP)
    # a bit flip in a sealed line is caught by both readers
    lines = p.read_text().splitlines()
    lines[0] = lines[0].replace("100.0", "100.5")
    p.write_text("\n".join(lines) + "\n")
    assert (treg.read_records_checked(p)[1] == jreg.read_records_checked(p)[1]
            == 3)


def test_ledger_disabled_by_env(tmp_path, monkeypatch):
    for name, r in REG.items():
        monkeypatch.setenv(r.ENV_LEDGER, "off")
        assert r.ledger_path() is None
        assert r.append_record(_bench(1.0)) is None
        assert r.read_records() == []
        monkeypatch.setenv(r.ENV_LEDGER, str(tmp_path / f"{name}.jsonl"))
        assert r.append_record(_bench(1.0)) == tmp_path / f"{name}.jsonl"
        assert len(r.read_records()) == 1
        assert r.ledger_path(store_dir="s") == tmp_path / f"{name}.jsonl"
        monkeypatch.delenv(r.ENV_LEDGER)
        assert str(r.ledger_path(store_dir="s")) == "s/perf-ledger.jsonl"


def test_port_fingerprint_names_torch():
    fp = treg.fingerprint()
    for k in ("host", "cpu", "python", "backend", "torch"):
        assert fp[k]
    assert fp["torch"] == torch.__version__
    assert fp["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert "jax" not in fp and "jaxlib" not in fp
    assert treg.fingerprint_key(FP) == treg.fingerprint_key(dict(FP))
    assert treg.fingerprint_key(FP) != treg.fingerprint_key(FP_OTHER)
    assert treg.fingerprint(probe_devices=False)["backend"] == "unprobed"
    # the same machine's records never share a key across the packages
    assert treg.fingerprint_key(fp) != jreg.fingerprint_key(jreg.fingerprint(
        probe_devices=False))


@pytest.mark.parametrize("values", [
    [100.0, 100.0, 100.0], [100, 80, 120, 90, 110], [], [0.0, 0.0],
    [1.5, 2.5, 3.25, -1.0]])
def test_noise_band(values):
    for kw in ({}, {"k_sigma": 2.0, "rel_floor": 0.1}):
        assert treg.noise_band(values, **kw) == jreg.noise_band(values, **kw)


@pytest.mark.parametrize("name", [
    "fixed_work_configs_per_s", "service_rps", "serve_occupancy",
    "vs_baseline", "tier1_headroom_s", "tier1_wall_s", "service_p95_s",
    "ladder[0] fast@128", "compete_margin_pct"])
def test_metric_direction(name):
    assert treg.metric_direction(name) == jreg.metric_direction(name)


def _tier1(s):
    return jreg.make_record("tier1", {"tier1_wall_s": s}, fp=FP)


def _loadgen(rps, **axes):
    return jreg.make_record("loadgen", {"service_rps": rps}, fp=FP,
                            axes=axes or None)


def _waste(w):
    return jreg.make_record(
        "loadgen", {"serve_padding_waste": w, "service_rps": 100.0}, fp=FP)


def _outage():
    r = _bench(0.0)
    r["outage"] = True
    return r


#: tests/test_perfwatch.py's gate scenarios, as record sequences
GATES = {
    "injected-regression": lambda: [_bench(v) for v in
                                    (1000.0, 1004.0, 997.0, 1002.0, 900.0)],
    "clean-backtoback": lambda: [_bench(1000.0), _bench(1004.0)],
    "improvement": lambda: [_bench(1000.0), _bench(1001.0), _bench(1200.0)],
    "time-creep": lambda: [_tier1(800.0), _tier1(802.0), _tier1(799.0),
                           _tier1(880.0)],
    "time-drop": lambda: [_tier1(800.0), _tier1(802.0), _tier1(720.0)],
    "fingerprint-scoped": lambda: [_bench(1000.0, fp=FP_OTHER)] * 3
    + [_bench(500.0)],
    "axes-scoped": lambda: [_loadgen(100.0), _loadgen(100.0),
                            _loadgen(60.0, chaos="7")],
    "zero-median": lambda: [_waste(0.0), _waste(0.0), _waste(0.0001)],
    "outage": lambda: [_bench(1000.0), _outage(), _bench(1003.0)],
    "empty": lambda: [],
}


@pytest.mark.parametrize("scenario", sorted(GATES))
def test_gate_and_compare_records(tmp_path, scenario):
    """The same ledger gated by both packages: equal verdicts, reports
    and comparison rows."""
    p = _write(jreg, tmp_path / "l.jsonl", GATES[scenario]())
    out = {}
    for name, r in REG.items():
        recs = r.read_records(p)
        rows = {}
        for kind in ("bench", "tier1", "loadgen"):
            newest, hist = r.latest_and_history(recs, kind)
            rows[kind] = (newest, hist, None if newest is None else
                          r.compare_records(newest, hist))
            if newest is not None:
                rows[kind + "-text"] = r.format_comparison(
                    kind, newest, rows[kind][2])
        out[name] = (r.gate(recs), rows,
                     r.gate(recs, kinds=["bench"], k_sigma=2.0,
                            metrics=["fixed_work_configs_per_s"]))
    assert out["port"] == out["jax"]
    ok, report = out["port"][0]
    if scenario in ("injected-regression", "time-creep"):
        assert not ok and "REGRESSED" in report
    else:
        assert ok, report


SUMMARY_A = {
    "ladder": [
        {"stage": 0, "engine": "fast", "capacity": 128, "seconds": 1.0},
        {"stage": 1, "engine": "fast", "capacity": 512, "seconds": 4.0},
    ],
    "spans": {
        "ladder.stage": {"count": 2, "total_s": 5.0, "max_s": 4.0},
        "ladder.confirm.drain": {"count": 1, "total_s": 0.5, "max_s": 0.5},
        "phase.analyze": {"count": 1, "total_s": 6.0, "max_s": 6.0},
    },
    "critpath": {"total_s": 5.5, "spans": [
        {"span": "ladder.stage", "cp_s": 5.0}, {"span": "bad"}]},
    "dedup": [{"backend": "sort", "candidates": 2176, "capacity": 128,
               "probes": 2, "per_round_us": 850.0}],
    "serve": {"avg_occupancy": 0.9, "continuous_occupancy": 0.5,
              "request": {"count": 4, "mean_s": 0.2, "max_s": 0.4}},
    "gauges": {"confirm.queue_latency_s": 0.01},
    "memory": {"spill_rows": 128},
}
SUMMARY_B = json.loads(json.dumps(SUMMARY_A))
SUMMARY_B["ladder"][1]["seconds"] = 6.0
SUMMARY_B["spans"]["ladder.confirm.drain"]["total_s"] = 1.0
SUMMARY_B["spans"]["new.span"] = {"total_s": 0.25}


def test_stage_rollup_and_attribution():
    out = {}
    for name, r in REG.items():
        a, am = r.stage_rollup(SUMMARY_A)
        b, bm = r.stage_rollup(SUMMARY_B)
        rows = r.diff_stage_tables(a, b)
        out[name] = (a, am, b, bm, rows,
                     r.diff_stage_tables(a, b, min_delta_s=0.6),
                     r.format_stage_diff(rows, a_label="prior", b_label="new"),
                     r.format_stage_diff([]),
                     r.attribution({"stages": b}, {"stages": a}, top=2),
                     r.stage_rollup(None), r.stage_rollup({"ladder": [
                         {"seconds": "x"}], "spans": {"s": None}}))
    assert out["port"] == out["jax"]
    assert out["port"][4][0]["span"] == "ladder[1] fast@512"


def test_gate_report_carries_attribution(tmp_path):
    a, _ = jreg.stage_rollup(SUMMARY_A)
    b, _ = jreg.stage_rollup(SUMMARY_B)
    p = _write(jreg, tmp_path / "l.jsonl", [
        _bench(1000.0, stages=a), _bench(1001.0, stages=a),
        _bench(900.0, stages=b)])
    got = {n: r.gate(r.read_records(p)) for n, r in REG.items()}
    assert got["port"] == got["jax"]
    assert not got["port"][0] and "top moving spans" in got["port"][1]


@pytest.mark.parametrize("times", [
    {"sort": [0.50, 0.505, 0.498], "bucket": [0.30, 0.302, 0.299]},
    {"sort": [0.50, 0.51, 0.49], "bucket": [0.498, 0.51, 0.492]},
    {"sort": [0.2], "bucket": [0.2]},
])
def test_competition_with_a_stub_runner(tmp_path, times):
    """Equal verdict records (the fingerprint is each machine's); a
    duplicate value fails before any run in both."""
    recs = {n: r.run_competition("dedup_backend", ["sort", "bucket"],
                                 runner=lambda v: times[v])
            for n, r in REG.items()}
    core = {n: {k: v for k, v in _drop_ts(rec).items()
                if k not in ("fingerprint", "fingerprint_key")}
            for n, rec in recs.items()}
    assert core["port"] == core["jax"]
    for r in REG.values():
        with pytest.raises(ValueError):
            r.run_competition("dedup_backend", ["sort", "sort"],
                              runner=lambda v: [0.1])
    p = _write(treg, tmp_path / "l.jsonl", list(recs.values()))
    assert treg.gate(treg.read_records(p)) == jreg.gate(jreg.read_records(p))


def test_competition_stamps_the_fused_arm_like_pallas():
    """The ``pallas_interpret`` stamp keeps the JAX package's key: on the
    CPU both packages stamp True, the port for its "fused" arm as the
    JAX package for its "pallas" arm."""
    stub = lambda v: [0.1] if v == "bucket" else [0.2]  # noqa: E731
    j = jreg.run_competition("dedup_backend", ["pallas", "bucket"], runner=stub)
    t = treg.run_competition("dedup_backend", ["fused", "bucket"], runner=stub,
                             workload={"device": "cpu"})
    assert j["extra"]["pallas_interpret"] is True
    assert t["extra"]["pallas_interpret"] is True
    assert "pallas_interpret" not in treg.run_competition(
        "dedup_backend", ["sort", "bucket"], runner=stub)["extra"]


def _headline_lines(text):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith("jepsen_tpu_perf_headline{"))


def test_publish_gauges_renders_equal_registry_text(tmp_path):
    """One ledger published by both packages: equal headline series,
    the age gauges present, and a newest record that drops a metric
    retracts its series in both."""
    led = tmp_path / "perf-ledger.jsonl"
    for v in (1000.0, 1010.0, 990.0):
        jreg.append_record(_bench(v, ops_per_s=v * 1.5), led)
    old = _tier1(800.0)
    old["ts"] -= 1000.0
    jreg.append_record(old, led)
    texts = {}
    for step in range(2):
        if step:
            jreg.append_record(_bench(985.0), led)
        for name, r in REG.items():
            met = MET[name]
            met.enable_mirror()
            met.REGISTRY.reset()
            r._PUBLISH_CACHE.clear()
            r._PUBLISHED.clear()
            assert r.publish_gauges(store_dir=tmp_path)
            assert r.publish_gauges(store_dir=tmp_path)  # the mtime cache
            text = met.render()
            assert "jepsen_tpu_perf_headline_age_seconds" in text
            assert met.REGISTRY.get("perf.headline_age_seconds",
                                    kind="tier1") >= 1000.0
            texts[name, step] = _headline_lines(text)
        assert texts["port", step] == texts["jax", step]
    assert ('jepsen_tpu_perf_headline{kind="bench",'
            'metric="fixed_work_configs_per_s"} 985') in texts["port", 1]
    assert not any('metric="ops_per_s"' in ln for ln in texts["port", 1])
    assert not treg.publish_gauges(tmp_path / "absent.jsonl")


def test_default_runner_reaches_each_backend(tmp_path):
    """The built-in workload on the CPU: the "bucket" and "sort" axis
    values each reach their own backend (the ladder's stage rows name
    it), and the runner restores the environment."""
    import os

    runner = treg._default_runner(
        "dedup_backend", histories=3, repeats=1, device="cpu")
    seen = {}
    for value in ("bucket", "sort"):
        d = tmp_path / value
        with tobs.recording(d):
            times = runner(value)
        assert len(times) == 1 and times[0] > 0
        seen[value] = {
            json.loads(ln)["attrs"]["dedup"]
            for ln in (d / "telemetry.jsonl").read_text().splitlines()
            if json.loads(ln).get("name") == "ladder.stage"}
    assert seen == {"bucket": {"bucket"}, "sort": {"sort"}}
    assert "JEPSEN_TPU_DEDUP_BACKEND" not in os.environ
