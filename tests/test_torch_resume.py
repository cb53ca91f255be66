"""The engines' services in the port against the JAX package's:
checkpoints and resume, deadlines, launch retry with OOM halving, and the
confirmation pool's resubmit.

The shared shapes of tests/test_fault_tolerance.py: ``make_histories(5,
40, 5, 900, 0.3)`` (every other history corrupted) at capacity (16, 64,
512), and its kill test's (5, 50, 6, 950, 0.35) at (16, 256).  Both
packages run the "sort" dedup backend (the port on the CPU), where the
ladder is bit-identical: at the same kill point the checkpoint pair the
port writes is byte-for-byte the JAX package's, carried frontiers
included, and each package resumes the other's.  Under the port's
default "fused" backend the one field that differs by design is the
config's ``dedup`` (the port's name of its fused CUDA update), and the
carried frontiers hold the same rows.  Tolerance 0: verdicts, causes,
bytes and arrays.
"""

import json
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
import torch

from jepsen_tpu import faults as jf
from jepsen_tpu import models as jm
from jepsen_tpu.checker import streaming as jst
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.parallel import batch as jb
from jepsen_tpu.store import checkpoint as jck
from jepsen_tpu_torch import faults as tf
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import streaming as tst
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.parallel import batch as tb
from jepsen_tpu_torch.store import checkpoint as tck
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history


class FakeXlaRuntimeError(RuntimeError):
    """Name and RuntimeError lineage of the JAX runtime's errors."""


class Killed(BaseException):
    """A process death mid-ladder: nothing in the pipeline catches it."""


KW = dict(capacity=(16, 64, 512), cpu_fallback=False, exact_escalation=(),
          confirm_refutations=False, dedup_backend="sort")
KILL_KW = dict(KW, capacity=(16, 256))

_CACHE: dict = {}


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("JEPSEN_TPU_RETRY_MAX_S", "0.002")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jf.INJECT = None
    tf.INJECT = None


def make_histories(n=5, ops=40, procs=5, seed0=900, info=0.3):
    key = (n, ops, procs, seed0, info)
    if key not in _CACHE:
        hists, expect = [], []
        for i in range(n):
            hist = valid_register_history(ops, procs, seed=seed0 + i,
                                          info_rate=info)
            if i % 2:
                hist = corrupt(hist, seed=i)
                expect.append(wgl_cpu.sweep_analysis(
                    tm.CASRegister(None), hist)["valid?"])
            else:
                expect.append(True)
            hists.append(hist)
        _CACHE[key] = (hists, expect)
    return _CACHE[key]


def run(pkg, hists, **kw):
    """batch_analysis of ``pkg`` ("jax" or "port"; the port on the CPU)."""
    if pkg == "jax":
        return jb.batch_analysis(jm.CASRegister(None), hists, **kw)
    return tb.batch_analysis(tm.CASRegister(None), hists, device="cpu", **kw)


def verdicts(res):
    return [r["valid?"] for r in res]


def clean(pkg="jax", key=(5, 40, 5, 900, 0.3), **kw):
    ck = (pkg, key, tuple(sorted(kw.items())))
    if ck not in _CACHE:
        _CACHE[ck] = run(pkg, make_histories(*key)[0], **{**KW, **kw})
    return _CACHE[ck]


def _kill_at_stage(n):
    def inject(ctx, attempt):
        if ctx.get("stage", 0) >= n:
            raise Killed()
    return inject


def _killed_run(pkg, hists, d, **kw):
    faults = jf if pkg == "jax" else tf
    with faults.inject_scope(_kill_at_stage(2)):
        with pytest.raises(Killed):
            run(pkg, hists, checkpoint_dir=d, **kw)


# ---------------------------------------------------------------------------
# Checkpoint and resume
# ---------------------------------------------------------------------------


def test_kill_mid_ladder_then_resume_identical(tmp_path):
    """Killed after stage 1's checkpoint, the resumed port run gives the
    uninterrupted run's verdicts (the port's and the JAX package's),
    seals a complete checkpoint, and resuming again is idempotent."""
    hists, _ = make_histories(5, 50, 6, 950, 0.35)
    want = verdicts(run("jax", hists, **KILL_KW))
    assert verdicts(run("port", hists, **KILL_KW)) == want
    _killed_run("port", hists, tmp_path, **KILL_KW)
    saved = tck.load(tmp_path)
    assert saved["stage"] >= 1 and not saved["complete"]
    resumed = run("port", hists, checkpoint_dir=tmp_path, resume=True,
                  **KILL_KW)
    assert verdicts(resumed) == want
    assert tck.load(tmp_path)["complete"]
    again = run("port", hists, checkpoint_dir=tmp_path, resume=True, **KILL_KW)
    assert verdicts(again) == want
    assert all(r["provenance"]["path"][0]["event"] == "checkpoint.restored"
               for r in again)


@pytest.mark.parametrize("dedup", ["sort", "bucket"])
def test_checkpoint_pair_at_kill_point_matches_jax(tmp_path, dedup):
    """At the same kill point both packages write the same checkpoint
    pair, byte for byte (carried frontiers bit-equal), and each resumes
    the other's to the same verdicts."""
    hists, _ = make_histories(5, 50, 6, 950, 0.35)
    kw = dict(KILL_KW, dedup_backend=dedup)
    for pkg in ("jax", "port"):
        _killed_run(pkg, hists, tmp_path / pkg, **kw)
    for name in (tck.CKPT_JSON, tck.CKPT_NPZ):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    assert tck.load(tmp_path / "port")["resumes"]
    want = verdicts(run("jax", hists, **kw))
    for src in ("jax", "port"):
        for pkg in ("jax", "port"):
            d = tmp_path / f"{pkg}-from-{src}"
            d.mkdir()
            for name in (tck.CKPT_JSON, tck.CKPT_NPZ):
                (d / name).write_bytes((tmp_path / src / name).read_bytes())
            got = run(pkg, hists, checkpoint_dir=d, resume=True, **kw)
            assert verdicts(got) == want, (pkg, src)


#: Checkpoint fields that differ by design between the port under its
#: default backend and the JAX package under "sort", with the reason.
DESIGN_DIFFERENCES = {
    # the port's name of its fused CUDA update; the JAX package names its
    # own backend
    ("config", "dedup"): ("fused", "sort"),
}


def test_default_backend_checkpoint_differs_only_by_design(tmp_path):
    """Under the port's default "fused" the checkpoint payload equals the
    JAX package's under "sort" but for ``DESIGN_DIFFERENCES``, and each
    carried frontier holds the same alive rows."""
    hists, _ = make_histories(5, 50, 6, 950, 0.35)
    kw = dict(KILL_KW)
    _killed_run("jax", hists, tmp_path / "jax", **kw)
    kw["dedup_backend"] = None
    _killed_run("port", hists, tmp_path / "port", **kw)
    j = json.loads((tmp_path / "jax" / tck.CKPT_JSON).read_text())["payload"]
    t = json.loads((tmp_path / "port" / tck.CKPT_JSON).read_text())["payload"]
    for (a, b), (tv, jv) in DESIGN_DIFFERENCES.items():
        assert (t[a][b], j[a][b]) == (tv, jv)
        t[a][b] = j[a][b]
    assert t == j
    jr, tr = jck.load(tmp_path / "jax")["resumes"], tck.load(
        tmp_path / "port")["resumes"]
    assert sorted(jr) == sorted(tr) and jr
    for i in jr:
        rows = []
        for bs, st, fo, fc, al in (jr[i], tr[i]):
            rows.append((bs, sorted((int(s), tuple(f), tuple(c))
                                    for s, f, c, a in zip(st, fo, fc, al)
                                    if a)))
        assert rows[0] == rows[1]


def test_resume_config_overrides_caller_args(tmp_path):
    hists, expect = make_histories()
    run("port", hists, checkpoint_dir=tmp_path, deadline=tf.Deadline(0.0), **KW)
    saved = tck.load(tmp_path)
    assert saved["config"]["capacity"] == list(KW["capacity"])
    assert saved["pending"] and not saved["complete"]
    res = run("port", hists, capacity=(4,), cpu_fallback=False,
              exact_escalation=(), confirm_refutations=False,
              checkpoint_dir=tmp_path, resume=True)
    assert verdicts(res) == expect == verdicts(clean())


def test_fingerprint_mismatch_quarantines_and_runs_fresh(tmp_path):
    hists_a, _ = make_histories()
    hists_b, expect_b = make_histories(2, seed0=2000)
    run("port", hists_a, checkpoint_dir=tmp_path, **KW)
    res = run("port", hists_b, checkpoint_dir=tmp_path, resume=True, **KW)
    assert verdicts(res) == expect_b
    assert list(tmp_path.glob(f"{tck.CKPT_JSON}.corrupt-*"))
    assert tck.load(tmp_path)["config"]["fingerprint"] == tck.fingerprint(hists_b)


@pytest.mark.parametrize("step", ["post-tmp", "post-rename"])
def test_crash_at_a_checkpoint_write_then_resume(tmp_path, step):
    """A death at a write step of the second checkpoint write, then a
    resume: the verdicts of an uninterrupted run."""
    hists, _ = make_histories()
    seen = {"n": 0}

    def crash(ctx, attempt):
        if (ctx.get("what") == "store.atomic_write" and ctx["step"] == step
                and tck.CKPT_JSON in ctx["path"]):
            seen["n"] += 1
            if seen["n"] == 2:
                raise tf.CrashPoint(step, ctx["path"])

    with tf.inject_scope(crash):
        with pytest.raises(tf.CrashPoint):
            run("port", hists, checkpoint_dir=tmp_path, **KW)
    res = run("port", hists, checkpoint_dir=tmp_path, resume=True, **KW)
    assert verdicts(res) == verdicts(clean())


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------


def test_deadline_zero_degrades_then_resume_completes(tmp_path):
    """A spent deadline: every history unknown with cause
    deadline-exceeded and the checkpoint's path, as in the JAX package;
    a resume without a deadline finishes with the clean verdicts."""
    hists, expect = make_histories()
    got = run("port", hists, checkpoint_dir=tmp_path / "port",
              deadline=tf.Deadline(0.0), **KW)
    want = run("jax", hists, checkpoint_dir=tmp_path / "jax",
               deadline=jf.Deadline(0.0), **KW)
    assert len(got) == len(hists)
    for g, w in zip(got, want):
        assert g["valid?"] == w["valid?"] == "unknown"
        assert g["cause"].replace(str(tmp_path / "port"), "D") == w[
            "cause"].replace(str(tmp_path / "jax"), "D")
        assert "checker-checkpoint.json" in g["cause"]
        assert g["provenance"]["path"] == w["provenance"]["path"]
    resumed = run("port", hists, checkpoint_dir=tmp_path / "port",
                  resume=True, **KW)
    assert verdicts(resumed) == expect


class TripAfter:
    """A deadline that expires at its N-th poll: a deterministic trip in
    the middle of a run (each package's Deadline subclassed)."""

    def __new__(cls, faults, polls):
        class _Trip(faults.Deadline):
            __slots__ = ("polls", "seen")

            def expired(self):
                self.seen += 1
                return self.seen > self.polls

        d = _Trip(3600.0)
        d.polls, d.seen = polls, 0
        return d


def test_chunked_deadline_and_checkpoint_match_jax(tmp_path):
    """wgl.analysis with spill, tripped after two chunk polls, writes the
    JAX package's chunk checkpoint pair byte for byte and the same
    deadline-exceeded unknown; the resume gives the uninterrupted
    verdict and the JAX package's resumed result (its launches count
    the tripped run's too), and resuming the finished run returns it
    again."""
    hist = valid_register_history(40, 4, seed=4100, info_rate=0.35)
    kw = dict(capacity=(16,), chunk_barriers=8, spill=True,
              dedup_backend="sort")
    want = jwgl.analysis(jm.CASRegister(None), hist, **kw)
    tripped = {
        "jax": jwgl.analysis(jm.CASRegister(None), hist,
                             checkpoint_dir=tmp_path / "jax",
                             deadline=TripAfter(jf, 2), **kw),
        "port": twgl.analysis(tm.CASRegister(None), hist, device="cpu",
                              checkpoint_dir=tmp_path / "port",
                              deadline=TripAfter(tf, 2), **kw),
    }
    for pkg, r in tripped.items():
        assert r["valid?"] == "unknown" and "deadline-exceeded" in r["cause"]
        assert "resumable checkpoint" in r["cause"]
    assert tripped["port"]["provenance"]["path"] == tripped["jax"][
        "provenance"]["path"]
    for name in (tck.CHUNK_JSON, tck.CHUNK_NPZ):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    resumed = twgl.analysis(tm.CASRegister(None), hist, device="cpu",
                            checkpoint_dir=tmp_path / "port", resume=True, **kw)
    jresumed = jwgl.analysis(jm.CASRegister(None), hist,
                             checkpoint_dir=tmp_path / "jax", resume=True, **kw)
    assert resumed["valid?"] == want["valid?"] is True
    assert resumed["kernel"] == jresumed["kernel"]
    assert resumed["provenance"]["path"] == jresumed["provenance"]["path"]
    again = twgl.analysis(tm.CASRegister(None), hist, device="cpu",
                          checkpoint_dir=tmp_path / "port", resume=True, **kw)
    assert again == resumed


def test_chunked_persistent_fault_degrades_like_jax(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_LAUNCH_RETRIES", "0")
    hist = valid_register_history(30, 3, seed=5, info_rate=0.2)

    def inject(ctx, attempt):
        if ctx.get("what") == "wgl.chunk":
            raise FakeXlaRuntimeError("INTERNAL: kernel fault")

    out = []
    for faults, wgl, model, kw in ((jf, jwgl, jm, {}),
                                   (tf, twgl, tm, {"device": "cpu"})):
        with faults.inject_scope(inject):
            out.append(wgl.analysis(model.CASRegister(None), hist,
                                    capacity=(64,), **kw))
    want, got = out
    assert got["valid?"] == "unknown"
    assert got["cause"] == want["cause"]
    assert got["cause"].startswith("device launch failed: FakeXlaRuntimeError")
    assert got["provenance"]["path"] == want["provenance"]["path"]
    assert got["kernel"] == want["kernel"]


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------


def _bad_history():
    return corrupt(valid_register_history(30, 3, seed=2, info_rate=0.1), seed=2)


def test_stream_sigkill_resume_matches_jax(tmp_path):
    """A stream killed after 15 ops and resumed from its checkpoint gives
    the uninterrupted stream's verdict and op, and its parity digest is
    the JAX package's."""
    hist = _bad_history()
    digests = []
    for pkg, st, model, kw in (
            ("jax", jst, jm, {}), ("port", tst, tm, {"device": "cpu"})):
        ref, ref_sc = st.stream_check(model.CASRegister(None), hist,
                                      feed_ops=8, capacity=(64, 256), **kw)
        d = tmp_path / pkg
        sc = st.StreamingChecker(model.CASRegister(None), capacity=(64, 256),
                                 checkpoint_dir=d, **kw)
        sc.feed(hist[:15])
        consumed = sc.ops_consumed
        del sc
        res, sc2 = st.stream_check(model.CASRegister(None), hist, feed_ops=8,
                                   capacity=(64, 256), checkpoint_dir=d,
                                   resume=True, **kw)
        assert sc2.ops_consumed >= consumed
        assert (res["valid?"], (res.get("op") or {}).get("index")) == (
            ref["valid?"], (ref.get("op") or {}).get("index"))
        digests.append((st.parity_digest(sc2.evidence()),
                        st.parity_digest(ref_sc.evidence())))
    assert digests[0] == digests[1] and digests[1][0] == digests[1][1]
    with pytest.raises(tck.CheckpointError):
        tst.StreamingChecker.resume(tmp_path / "port", tm.FIFOQueue())


# ---------------------------------------------------------------------------
# Launch faults
# ---------------------------------------------------------------------------


def _with_injector(pkg, inject, hists, **kw):
    faults = jf if pkg == "jax" else tf
    with faults.inject_scope(inject):
        return run(pkg, hists, **kw)


def test_transient_fault_retried_verdicts_unchanged():
    hists, _ = make_histories()
    hits = []

    def inject(ctx, attempt):
        if ctx.get("stage") == 1 and attempt < 1:
            hits.append(attempt)
            raise FakeXlaRuntimeError("INTERNAL: transient scheduler error")

    res = _with_injector("port", inject, hists, **KW)
    assert hits and verdicts(res) == verdicts(clean())


def test_injected_oom_halves_with_verdicts_unchanged():
    """Every multi-lane launch of an async rung runs out of memory: the
    port halves down to single lanes, as the JAX package does, with the
    same verdicts and the same halving events on each history's path."""
    hists, _ = make_histories()

    def inject(ctx, attempt):
        if ctx.get("engine") in ("sync", "async") and ctx.get("lanes", 0) > 1:
            raise FakeXlaRuntimeError("RESOURCE_EXHAUSTED: ran out of hbm")

    stats = {}
    got = _with_injector("port", inject, hists, stats=stats, **KW)
    want = _with_injector("jax", inject, hists, **KW)
    assert verdicts(got) == verdicts(want) == verdicts(clean())
    assert stats["oom_halvings"] > 0 and any(r["halvings"] for r in stats["rungs"])
    for g, w in zip(got, want):
        assert g["provenance"]["path"] == w["provenance"]["path"]


def test_persistent_fault_degrades_only_its_lanes(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_LAUNCH_RETRIES", "1")
    hists, expect = make_histories()

    def inject(ctx, attempt):
        if ctx.get("engine") in ("sync", "async"):
            raise FakeXlaRuntimeError("UNAVAILABLE: chip is gone")

    got = _with_injector("port", inject, hists, **KW)
    want = _with_injector("jax", inject, hists, **KW)
    assert [(r["valid?"], r.get("cause")) for r in got] == [
        (r["valid?"], r.get("cause")) for r in want]
    for r, e in zip(got, expect):
        assert r["valid?"] in (e, "unknown")
        if r["valid?"] == "unknown":
            assert "device launch failed" in r["cause"]
            assert "UNAVAILABLE" in r["cause"]
    assert any(r["valid?"] == "unknown" for r in got)


def test_failed_launch_lanes_stay_unknown_under_cpu_fallback(monkeypatch):
    """A launch that fails after its retries leaves its lanes unknown
    even with ``cpu_fallback``: no sweep runs in its place.  The JAX
    package sweeps them (ROADMAP C4); the port keeps the failure."""
    monkeypatch.setenv("JEPSEN_TPU_LAUNCH_RETRIES", "1")
    hists, expect = make_histories()

    def inject(ctx, attempt):
        if ctx.get("engine") in ("sync", "async"):
            raise FakeXlaRuntimeError("UNAVAILABLE: chip is gone")

    def no_sweep(*a, **kw):
        raise AssertionError("the CPU sweep ran in a failed launch's place")

    monkeypatch.setattr(wgl_cpu, "sweep_analysis", no_sweep)
    got = _with_injector("port", inject, hists, **dict(KW, cpu_fallback=True))
    unknown = [r for r in got if r["valid?"] == "unknown"]
    assert unknown
    for r, e in zip(got, expect):
        assert r["valid?"] in (e, "unknown")
    for r in unknown:
        assert r["cause"].startswith("device launch failed")
        assert "UNAVAILABLE" in r["cause"]
        assert "cpu-fallback" not in [e["event"]
                                      for e in r["provenance"]["path"]]


@pytest.mark.parametrize("seed", [1, 4])
def test_seeded_faults_give_the_jax_packages_verdicts(seed):
    """Under one seeded fault schedule both packages take the same
    retries and halvings: the same verdicts, each the clean verdict."""
    hists, _ = make_histories()
    kw = dict(KW, confirm_refutations=False)
    got = _with_injector("port", tf.seeded_injector(seed, oom_rate=0.4),
                         hists, **kw)
    want = _with_injector("jax", jf.seeded_injector(seed, oom_rate=0.4),
                          hists, **kw)
    assert verdicts(got) == verdicts(want) == verdicts(clean())


def test_broken_pool_confirmation_resubmitted_once(monkeypatch):
    """An in-flight confirmation that dies with its pool is resubmitted
    once against the rebuilt pool, and the verdicts survive."""
    from jepsen_tpu_torch import _confirm_worker as cw

    hists, expect = make_histories()
    assert False in expect

    class ExplodingFuture:
        def result(self, timeout=None):
            raise BrokenProcessPool("worker died mid-sweep")

    class GoodFuture:
        def __init__(self, res):
            self._res = res

        def result(self, timeout=None):
            return self._res

    class ExplodingPool:
        def submit(self, fn, *a, **kw):
            return ExplodingFuture()

    class GoodPool:
        def submit(self, fn, *a, **kw):
            assert fn is cw.confirm_refutation
            return GoodFuture(cw.confirm_refutation(*a, **kw))

    pools = [ExplodingPool(), GoodPool()]
    state = {"n": 0}

    def fake_pool(workers=None):
        return pools[min(state["n"], 1)]

    def fake_drop():
        state["n"] += 1

    monkeypatch.setattr(tb, "_CONFIRM_POOL", pools[0])
    monkeypatch.setattr(tb, "confirm_pool", fake_pool)
    monkeypatch.setattr(tb, "_drop_confirm_pool", fake_drop)
    res = run("port", hists, capacity=(64, 256), cpu_fallback=False,
              exact_escalation=(), dedup_backend="sort")
    assert verdicts(res) == expect
    assert state["n"] >= 1
    resubmitted = [r for r in res if any(
        e["event"] == "confirm.resubmit" for e in r["provenance"]["path"])]
    assert resubmitted and all(r["confirmed?"] for r in resubmitted)
