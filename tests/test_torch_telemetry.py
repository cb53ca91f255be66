"""The port's instrumented paths against the JAX package's telemetry.

Each scenario runs the same inputs through both packages, each under its
own ``obs.recording``, and compares the two ``telemetry.jsonl`` streams
once normalized: the multiset of (kind, name) with every event's
attribute keys and deterministic values, and the rolled-up ladder
table's deterministic columns.  The normalizer takes out, by name:

  * the clock (``t``, ``dur``, the thread id, the header) and the
    timing attributes (``compile_s``, ``execute_s``, ``per_round_us``,
    ``delay_s``, the confirmation queue latency's value);
  * the JAX package's VMEM keys, which the port's gate has no
    counterpart for (``pallas_tile``, ``pallas_vmem_bytes``,
    ``pallas_vmem_budget_bytes``, ``pallas_interpret``,
    ``pallas_mesh_feasible``), and ``interpret`` (ROADMAP C4);
  * on the CPU, ``device.buffer_bytes`` and ``device_bytes_peak``: the
    port has no allocator count there (``wgl.device_buffer_bytes`` is
    None), where the JAX package sums its live arrays;
  * each run's directory, in every string (checkpoint and quarantine
    paths);

and it reads the JAX package's "pallas" backend as the port's "fused",
and folds ``wgl.runner_cache.hit``/``miss`` into one name: the JAX
package's runner caches hold jitted programs for the life of the
process, so which lookup misses depends on what ran before in it.  The
ladder's own compile/execute split does not: both packages' seen-shape
sets are cleared before each run, so ``compiled`` and
``compile_launches`` are compared.
"""

import collections
import json

import numpy as np
import pytest
import torch

from jepsen_tpu import checker as jc
from jepsen_tpu import faults as jf
from jepsen_tpu import models as jm
from jepsen_tpu import obs as jobs
from jepsen_tpu.checker import elle as je
from jepsen_tpu.checker import linearizable as jlin
from jepsen_tpu.checker import streaming as jst
from jepsen_tpu.obs import provenance as jprov
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.parallel import batch as jb
from jepsen_tpu.store import durable as jdur
from jepsen_tpu_torch import checker as tc
from jepsen_tpu_torch import faults as tf
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import obs as tobs
from jepsen_tpu_torch.checker import elle as te
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import streaming as tst
from jepsen_tpu_torch.obs import provenance as tprov
from jepsen_tpu_torch.ops import hashing as thashing
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.parallel import batch as tb
from jepsen_tpu_torch.store import durable as tdur
from jepsen_tpu_torch.testing import gentxn
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history
from test_obs import _mixed_histories
from test_torch_elle import CASES, txn_hist
from test_torch_resume import TripAfter

PKG = {
    "jax": dict(obs=jobs, batch=jb, wgl=jwgl, faults=jf, lin=jlin, st=jst,
                elle=je, checker=jc, prov=jprov, dur=jdur, model=jm),
    "port": dict(obs=tobs, batch=tb, wgl=twgl, faults=tf, lin=tlin, st=tst,
                 elle=te, checker=tc, prov=tprov, dur=tdur, model=tm),
}

#: attributes whose values read the clock, or that only one package has
#: (module doc).
DROP_ATTRS = {"compile_s", "execute_s", "per_round_us", "delay_s",
              "pallas_tile", "pallas_vmem_bytes", "pallas_vmem_budget_bytes",
              "pallas_interpret", "pallas_mesh_feasible", "interpret",
              "device_bytes_peak"}

#: the ladder table's columns that do not read the clock.
LADDER_COLUMNS = ("stage", "engine", "capacity", "lanes", "resolved",
                  "refuted", "unknowns_remaining", "launches",
                  "compile_launches", "peak_frontier", "lossy", "dedup",
                  "degraded", "pallas_routed", "mesh_devices")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """One torch thread, fast retries, no injector and both mirrors off
    (restored after), and both packages' process-global seen-shape and
    probe sets emptied, so that no count depends on what ran before."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("JEPSEN_TPU_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("JEPSEN_TPU_RETRY_MAX_S", "0.002")
    # the JAX package's default backend, where a path takes the default
    monkeypatch.setattr(thashing, "DEDUP_BACKEND", "sort")
    from jepsen_tpu.obs import metrics as jmet
    from jepsen_tpu_torch.obs import metrics as tmet

    saved = jmet.MIRROR, tmet.MIRROR
    jmet.enable_mirror(False)
    tmet.enable_mirror(False)
    yield
    torch.set_num_threads(n)
    jf.INJECT = None
    tf.INJECT = None
    jmet.enable_mirror(saved[0])
    tmet.enable_mirror(saved[1])


def _reset_process_sets():
    for b in (jb, tb):
        b._SEEN_SHAPES.clear()
        b._PROBED_DEDUP_SHAPES.clear()
    twgl._RUNNER_KEYS.clear()


def _scrub(x, d: str):
    if isinstance(x, str):
        return x.replace(d, "DIR")
    if isinstance(x, dict):
        return {k: _scrub(v, d) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_scrub(v, d) for v in x]
    return x


def normalize(events, d) -> collections.Counter:
    """The stream as a multiset of (kind, name, attrs, value, err, parent)
    with the module doc's cuts."""
    out = collections.Counter()
    for e in events:
        if e.get("type") == "meta" or e.get("name") == "device.buffer_bytes":
            continue
        name = e["name"]
        if name.startswith("wgl.runner_cache."):
            name = "wgl.runner_cache"
        attrs = {k: v for k, v in (e.get("attrs") or {}).items()
                 if k not in DROP_ATTRS}
        for k in ("dedup", "backend", "active_backend"):
            if attrs.get(k) == "pallas":
                attrs[k] = "fused"
        if isinstance(attrs.get("stream"), str):
            attrs["stream"] = "STREAM"  # a random id per stream
        value = (None if name == "confirm.queue_latency_s"
                 else e.get("value", e.get("n")))
        row = [e["type"], name, attrs, value, e.get("err"), e.get("parent"),
               e.get("trace")]
        out[json.dumps(_scrub(row, str(d)), sort_keys=True, default=str)] += 1
    return out


def ladder_table(summary) -> list:
    rows = []
    for r in summary["ladder"]:
        row = {k: r.get(k) for k in LADDER_COLUMNS}
        if row["dedup"] == "pallas":
            row["dedup"] = "fused"
        rows.append(row)
    return rows


def record_both(tmp_path, run):
    """Run ``run(pkg, P, d)`` under each package's recording in its own
    directory ``d``; returns {pkg: (result, events, summary, d)}."""
    out = {}
    for pkg in ("jax", "port"):
        _reset_process_sets()
        P = PKG[pkg]
        d = tmp_path / pkg
        d.mkdir()
        with P["obs"].recording(d / "rec") as rec:
            res = run(pkg, P, d)
        assert P["obs"].active() is None
        out[pkg] = (res, rec.events, rec.summary, d)
    return out


def assert_same(out, names=()):
    """The two streams normalized equal, their ladder tables equal, and
    each name of ``names`` present."""
    (_, je_, js, jd), (_, te_, ts, td) = out["jax"], out["port"]
    want, got = normalize(je_, jd), normalize(te_, td)
    if got != want:
        diff = {k: (want[k], got[k]) for k in set(want) | set(got)
                if want[k] != got[k]}
        pytest.fail(f"streams differ (jax, port): {json.dumps(diff, indent=1)}")
    assert ladder_table(ts) == ladder_table(js)
    kinds = {e.get("name") for e in te_}
    for name in names:
        assert name in kinds, name
    return ts


def _cpu(pkg, kw=None):
    kw = dict(kw or {})
    if pkg == "port":
        kw["device"] = "cpu"
    return kw


def _backend(pkg, backend):
    return "pallas" if pkg == "jax" and backend == "fused" else backend


# ---------------------------------------------------------------------------
# The ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["sort", "fused"])
def test_async_ladder_stage_table(tmp_path, backend):
    """tests/test_obs.py's ladder ((16, 64), every third history
    corrupted, worker confirmations): the same events, launches and
    stage rows, and the dedup probe of the recorded run."""
    hists = _mixed_histories()

    def run(pkg, P, d):
        return P["batch"].batch_analysis(
            P["model"].CASRegister(None), hists, capacity=(16, 64),
            dedup_backend=_backend(pkg, backend), **_cpu(pkg))

    out = record_both(tmp_path, run)
    ts = assert_same(out, ("ladder.pack", "ladder.launch", "ladder.stage",
                           "ladder.compile_cache.miss", "confirm.submitted",
                           "ladder.confirm.drain", "dedup.round",
                           "ladder.unknowns_remaining"))
    assert [r["valid?"] for r in out["port"][0]] == [
        r["valid?"] for r in out["jax"][0]]
    for row in ts["ladder"]:
        assert row["launches"] >= 1 and row["compile_launches"] >= 1
    launches = [e for e in out["port"][1] if e.get("name") == "ladder.launch"]
    assert launches and all(e["attrs"]["devices"] == [0] for e in launches)
    if backend == "fused":
        assert all(r.get("pallas_routed") is False
                   for r in ts["ladder"] if r["engine"] == "async")


def test_sync_engine_with_exact_stage(tmp_path):
    hists = _mixed_histories(8)

    def run(pkg, P, d):
        return P["batch"].batch_analysis(
            P["model"].CASRegister(None), hists, engine="sync",
            capacity=(2,), exact_escalation=(64,), greedy_first=False,
            cpu_fallback=False,
            confirm_refutations=False, dedup_backend="sort", **_cpu(pkg))

    out = record_both(tmp_path, run)
    ts = assert_same(out, ("ladder.stage",))
    assert {r["engine"] for r in ts["ladder"]} >= {"sync", "exact"}


def test_device_confirmation_and_unknowns(tmp_path):
    """Device confirmation's exact launch, its span, and the final
    unknowns gauge of a ladder that leaves lanes undecided."""
    hists = _mixed_histories(6)

    def run(pkg, P, d):
        return P["batch"].batch_analysis(
            P["model"].CASRegister(None), hists, capacity=(4, 16),
            exact_escalation=(), cpu_fallback=False,
            confirm_refutations="device",
            dedup_backend="sort", **_cpu(pkg))

    out = record_both(tmp_path, run)
    assert_same(out, ("ladder.confirm.device",))


# ---------------------------------------------------------------------------
# The single-history path, the checkers, the stream and Elle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("corrupted", [False, True])
def test_chunked_with_spill_budget(tmp_path, corrupted):
    """tests/test_torch_chunked.py's spill history under a 0.25 MB
    frontier budget: slices, the host ring, the merge and the chunk
    counters."""
    hist = valid_register_history(40, 4, seed=4100 + corrupted,
                                  info_rate=0.35)
    if corrupted:
        hist = corrupt(hist, seed=1)

    def run(pkg, P, d):
        return P["wgl"].analysis(P["model"].CASRegister(None), hist,
                                 capacity=(16,), chunk_barriers=8,
                                 frontier_budget_mb=0.25,
                                 dedup_backend="sort", **_cpu(pkg))

    out = record_both(tmp_path, run)
    ts = assert_same(out, ("wgl.chunked",))
    assert out["port"][0]["valid?"] == out["jax"][0]["valid?"]
    if not corrupted:
        assert ts["memory"]["spill_rows"] > 0


def test_check_safe_compose_and_linearizable(tmp_path):
    """``check_safe`` over a Compose of a raising checker, the optimist
    and ``linearizable`` under "wgl" and "competition": one
    ``checker.check`` span per check, the error counted."""
    good = valid_register_history(20, 3, seed=4, info_rate=0.1)
    bad = corrupt(valid_register_history(20, 3, seed=5, info_rate=0.1),
                  seed=5)

    def run(pkg, P, d):
        c = P["checker"]

        class Boom(c.Checker):
            def check(self, test, history, opts):
                raise RuntimeError("boom")

        opts = {"device": "cpu"} if pkg == "port" else {}
        comp = c.compose({"boom": Boom(), "ok": c.unbridled_optimism(),
                          "wgl": P["lin"].linearizable(
                              {"model": "cas-register", "algorithm": "wgl",
                               **opts})})
        out = [c.check_safe(comp, {}, good)]
        for h in (good, bad):
            for alg in ("wgl", "competition"):
                out.append(c.check_safe(P["lin"].linearizable(
                    {"model": "cas-register", "algorithm": alg, **opts}),
                    {}, h))
        return [r["valid?"] for r in out]

    out = record_both(tmp_path, run)
    ts = assert_same(out, ("checker.check", "checker.errors"))
    assert out["port"][0] == out["jax"][0]
    assert {c["checker"] for c in ts["checkers"]} >= {"boom", "ok"}


@pytest.mark.parametrize("corrupted", [False, True])
def test_streaming_checker(tmp_path, corrupted):
    hist = valid_register_history(30, 3, seed=7, info_rate=0.1)
    if corrupted:
        hist = corrupt(hist, seed=7)

    def run(pkg, P, d):
        res, _sc = P["st"].stream_check(P["model"].CASRegister(None), hist,
                                        feed_ops=8, capacity=(64, 256),
                                        **_cpu(pkg))
        return res["valid?"]

    out = record_both(tmp_path, run)
    ts = assert_same(out, ("stream.ops", "stream.epoch", "stream.verdict"))
    assert out["port"][0] == out["jax"][0]
    assert ts["streams"]["verdicts"]


ELLE = [c for c in CASES if c[0] in ("append-valid", "append-G1c",
                                     "append-G-single", "wr-G1c",
                                     "wr-sequential")]


@pytest.mark.parametrize("engine", ["columns", "loops"])
def test_elle_both_engines(tmp_path, engine):
    """Elle's list-append and rw-register checkers, ``check`` and
    ``check_batch``, with host SCC: the inference substages, the
    classification and a nil final write that the columns engine hands
    to the loops."""
    hists = [(kind, kw, txn_hist(*txns)) for _n, kind, kw, txns in ELLE]
    nil = txn_hist((0, [["w", "x", None]]), (1, [["r", "x", None]]))
    appends = [gentxn.append_history(24, n_keys=3, n_procs=4, seed=s)
               for s in range(3)]

    def run(pkg, P, d):
        e = P["elle"]
        cpu = {"device": "cpu"} if pkg == "port" else {}
        out = [getattr(e, kind)(engine=engine, **kw).check({}, h, cpu)
               for kind, kw, h in hists]
        out.append(e.wr_register(engine=engine, sequential_keys=True).check(
            {}, nil, cpu))
        out += e.list_append(engine=engine).check_batch({}, appends, cpu)
        return [r["valid?"] for r in out]

    out = record_both(tmp_path, run)
    names = ("elle.scc", "elle.infer_batch") + (
        ("elle.nodes", "elle.anomalies", "elle.edges",
         "elle.columns_fallback") if engine == "columns" else ())
    assert_same(out, names)
    assert out["port"][0] == out["jax"][0]


# ---------------------------------------------------------------------------
# Faults, checkpoints, durable records and evidence
# ---------------------------------------------------------------------------


def test_deadline_trip_and_checkpoint_mismatch(tmp_path):
    """A deadline that trips at its third poll with a checkpoint, then a
    resume against other histories (the stale pair quarantined)."""
    hists = _mixed_histories(6)
    other = _mixed_histories(5)

    def run(pkg, P, d):
        kw = dict(capacity=(16, 64), cpu_fallback=False,
                  confirm_refutations=False, dedup_backend="sort",
                  checkpoint_dir=d / "ck", **_cpu(pkg))
        model = P["model"].CASRegister(None)
        tripped = P["batch"].batch_analysis(
            model, hists, deadline=TripAfter(P["faults"], 1), **kw)
        fresh = P["batch"].batch_analysis(model, other, resume=True, **kw)
        return ([r["valid?"] for r in tripped], [r["valid?"] for r in fresh])

    out = record_both(tmp_path, run)
    ts = assert_same(out, ("fault.deadline", "fault.deadline.trip",
                           "fault.checkpoint.save",
                           "fault.checkpoint.quarantined",
                           "fault.checkpoint.mismatch"))
    assert out["port"][0] == out["jax"][0]
    assert {f["fault"] for f in ts["faults"]} >= {"deadline", "deadline.trip"}


def test_chunked_deadline_and_resume(tmp_path):
    hist = valid_register_history(40, 4, seed=4100, info_rate=0.35)

    def run(pkg, P, d):
        kw = dict(capacity=(16,), chunk_barriers=8, spill=True,
                  dedup_backend="sort", checkpoint_dir=d / "ck", **_cpu(pkg))
        model = P["model"].CASRegister(None)
        a = P["wgl"].analysis(model, hist,
                              deadline=TripAfter(P["faults"], 2), **kw)
        b = P["wgl"].analysis(model, hist, resume=True, **kw)
        c = P["wgl"].analysis(model, hist, resume=True, **kw)
        return a["valid?"], b["valid?"], c["valid?"]

    out = record_both(tmp_path, run)
    assert_same(out, ("fault.deadline.trip", "fault.checkpoint.load"))
    assert out["port"][0] == out["jax"][0]


class _Oom(RuntimeError):
    pass


def test_oom_spill_and_halving_under_inject_scope(tmp_path):
    """Injected out-of-memory errors: the first launch of stage 1 spills
    (a spiller that frees, then the same launch again) and fails again,
    so it halves; the counters and the stage's ``degraded`` column."""
    hists = _mixed_histories(6)

    def run(pkg, P, d):
        faults = P["faults"]
        seen = []

        def inject(ctx, attempt):
            if ctx.get("stage") == 1 and len(seen) < 2:
                seen.append(ctx["lanes"])
                raise _Oom("RESOURCE_EXHAUSTED: out of memory")

        def frees(ctx):
            return True

        faults.register_oom_spiller(frees)
        try:
            with faults.inject_scope(inject):
                res = P["batch"].batch_analysis(
                    P["model"].CASRegister(None), hists, capacity=(16, 64),
                    cpu_fallback=False, confirm_refutations=False,
                    dedup_backend="sort", **_cpu(pkg))
        finally:
            faults.unregister_oom_spiller(frees)
        return [r["valid?"] for r in res], seen

    out = record_both(tmp_path, run)
    ts = assert_same(out, ("fault.oom.spill", "fault.launch.oom_spill_retry",
                           "fault.launch.oom_halving"))
    assert out["port"][0] == out["jax"][0]
    assert ts["memory"]["oom_spills"] >= 1


@pytest.mark.parametrize("mode", ["crc", "garbage"])
def test_corrupt_durable_record(tmp_path, mode):
    def run(pkg, P, d):
        dur = P["dur"]
        p = d / "r.json"
        dur.register_kind("t-obs", 1)
        dur.write_record(p, "t-obs", {"n": 1})
        if mode == "crc":
            doc = json.loads(p.read_text())
            doc["payload"]["n"] = 2
            p.write_text(json.dumps(doc))
        else:
            p.write_text("garbage {{{")
        with pytest.raises(dur.DurableError):
            dur.read_verified(p, "t-obs")
        (d / "x.tmp").write_text("orphan")
        return dur.sweep_tmp(d, min_age_s=0)

    out = record_both(tmp_path, run)
    assert_same(out, ("durable.corrupt", "durable.tmp_swept"))
    assert out["port"][0] == out["jax"][0] == 1


def test_evidence_bundles(tmp_path, monkeypatch):
    """``linearizable`` with a store directory emits a bundle per check
    (``provenance.bundle`` by source and verdict), and the summary's
    provenance section counts them; a write that fails counts
    ``provenance.emit_error``."""
    good = valid_register_history(16, 2, seed=1)
    bad = corrupt(valid_register_history(16, 2, seed=2), seed=2)
    machine = {"host": "h", "cpu": "c", "python": "3"}
    monkeypatch.setattr(jprov, "machine_fingerprint", lambda: dict(machine))
    monkeypatch.setattr(tprov, "machine_fingerprint", lambda: dict(machine))

    def run(pkg, P, d):
        test = {"name": "ev", "start-time-str": "t", "store-dir": str(d)}
        opts = {"device": "cpu"} if pkg == "port" else {}
        out = [P["checker"].check_safe(P["lin"].linearizable(
            {"model": "cas-register", "algorithm": "wgl", **opts}), test, h)
            for h in (good, bad)]
        (d / "blocked").write_text("a file where a directory must go")
        assert P["prov"].write_bundle(d / "blocked" / "sub",
                                      {"id": "x"}) is None
        return [r["valid?"] for r in out]

    out = record_both(tmp_path, run)
    ts = assert_same(out, ("provenance.bundle", "provenance.emit_error"))
    assert ts["provenance"]["bundles"] == 2
    assert ts["provenance"]["emit_errors"] == 1
