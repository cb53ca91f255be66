"""The port's self-healing layer (``jepsen_tpu_torch.serve.health``) and
its service integration, against the JAX package's on the same inputs.

The pure primitives run at tolerance 0 in both packages, each module's
clock replaced by one scripted clock: ``bisect_poison`` (isolation,
launch counts and order, the budget), ``CircuitBreaker``,
``Quarantine`` and ``SharedQuarantine`` (TTLs, hits, the shared files
byte for byte), ``LaunchWatchdog`` (under one pinned launch EWMA),
``AdmissionJournal`` and ``IdempotencyMap`` (returns, and their files
byte for byte).  The cases of tests/test_serve_health.py that drive the
service (poison quarantine, the breaker, the hung-launch watchdog, the
placement probe) run in both packages through ``test_torch_serve.both``.
``inject_scope`` and the seeded injector have their counterparts in
tests/test_torch_faults.py, and the web health endpoints wait with the
HTTP API.

Beyond the JAX cases: a hung launch's zombie settling late is dropped
(first write wins), a drain dir written by either package is finished
by the other's ``resume_drained``, a service built with ``device="cpu"``
asks torch for no CUDA tensor on any lane, and one built without it
fails its launches where there is no card instead of running on the
CPU.
"""

import math
import threading
import time
import types

import pytest
import torch

from jepsen_tpu.serve import health as jhealth
from jepsen_tpu_torch.serve import health as thealth
from test_torch_serve import (  # noqa: F401 — _isolated is autouse here too
    CAP, PKG, _isolated, both, direct, mixed_histories, outcome, pin_ids,
    stats_core, svc_kw,
)

HEALTH = {"jax": jhealth, "port": thealth}


class Clock:
    """A scripted clock for a module's ``time``: ``monotonic`` and
    ``time`` read it, ``advance`` moves it."""

    def __init__(self):
        self.t = 1000.0

    def advance(self, s):
        self.t += s

    def namespace(self):
        return types.SimpleNamespace(monotonic=lambda: self.t,
                                     time=lambda: 1.7e9 + self.t,
                                     sleep=time.sleep)


def each_health(monkeypatch, run):
    """``run(H, clock)`` in each package's health module under its own
    scripted clock; asserts equal returns and gives the port's."""
    out = {}
    for name, H in HEALTH.items():
        clock = Clock()
        monkeypatch.setattr(H, "time", clock.namespace())
        out[name] = run(H, clock)
    assert out["port"] == out["jax"]
    return out["port"]


# ---------------------------------------------------------------------------
# Pure primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("poison", [[11], [2, 5], [0, 1, 2, 3]])
@pytest.mark.parametrize("n", [8, 16])
def test_bisect_poison_matches_jax(monkeypatch, poison, n):
    def run(H, clock):
        members = list(range(n))
        launches = []

        def launch(group):
            launches.append(list(group))
            if any(x in poison for x in group):
                raise ValueError("poison present")
            return [f"v{g}" for g in group]

        bad, good, k = H.bisect_poison(launch, members)
        return bad, good, k, launches, H.bisect_launch_budget(n)

    bad, good, k, launches, budget = each_health(monkeypatch, run)
    assert sorted(bad) == [p for p in poison if p < n]
    assert set(good) == set(range(n)) - set(poison)
    assert k == len(launches) <= budget
    if len(poison) == 1:
        assert k <= 2 * (math.ceil(math.log2(n)) + 1)


def test_bisect_poison_budget_exhaustion(monkeypatch):
    def run(H, clock):
        def always_fails(group):
            raise ValueError("x")

        return H.bisect_poison(always_fails, list(range(8)), max_launches=0)

    bad, good, n = each_health(monkeypatch, run)
    assert bad == list(range(8)) and not good and n == 0


def test_circuit_breaker_open_halfopen_close(monkeypatch):
    def run(H, clock):
        b = H.CircuitBreaker(threshold=2, cooldown_s=0.05)
        trace = [b.allow(), b.state, b.record_failure(), b.record_failure(),
                 b.state, b.allow(), b.retry_after()]
        clock.advance(0.06)
        trace += [b.allow(), b.state, b.record_failure(), b.state]
        clock.advance(0.06)
        trace += [b.allow()]
        b.record_success()
        trace += [b.state, b.consecutive_failures, b.describe()]
        return trace

    t = each_health(monkeypatch, run)
    assert t[:6] == [True, "closed", False, True, "open", False]
    assert 0 < t[6] <= 0.05
    assert t[7:11] == [True, "half-open", True, "open"]
    assert t[12] == "closed" and t[14]["opens"] == 2


def test_quarantine_ttl_and_hit_refresh(monkeypatch, tmp_path):
    """The in-memory registry, and the shared one over a directory (its
    files byte for byte, and each package adopting the other's entry)."""
    def run(H, clock):
        q = H.Quarantine(ttl_s=0.08)
        q.add("fp-a", "bad history")
        e = q.check("fp-a")
        trace = [e, len(q), q.describe()]
        clock.advance(0.12)
        trace += [q.check("fp-a"), len(q)]
        d = tmp_path / H.__name__.split(".")[0]
        sq = H.SharedQuarantine(ttl_s=60.0, dir=d)
        sq.add("fp-b", "poison")
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        other = H.SharedQuarantine(ttl_s=60.0, dir=d)
        trace += [other.check("fp-b"), other.disk_hits, files,
                  {k: v for k, v in other.describe().items() if k != "dir"}]
        clock.advance(61.0)
        trace += [H.SharedQuarantine(ttl_s=60.0, dir=d).check("fp-b")]
        return trace

    t = each_health(monkeypatch, run)
    assert t[0]["cause"] == "bad history" and t[0]["hits"] == 1
    assert t[1] == 1 and t[3] is None and t[4] == 0
    assert t[5]["cause"] == "poison" and t[6] == 1 and t[9] is None


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_shared_quarantine_across_packages(tmp_path, writer, reader):
    HEALTH[writer].SharedQuarantine(ttl_s=60.0, dir=tmp_path).add(
        "fp", "poisoned elsewhere")
    hit = HEALTH[reader].SharedQuarantine(ttl_s=60.0, dir=tmp_path).check("fp")
    assert hit is not None and hit["cause"] == "poisoned elsewhere"


def test_launch_watchdog_trips_and_passes(monkeypatch):
    from jepsen_tpu import faults as jf
    from jepsen_tpu_torch import faults as tf

    for f in (jf, tf):
        monkeypatch.setattr(f, "launch_seconds_ewma", lambda: 0.02)

    def run(H, clock):
        w = H.LaunchWatchdog(factor=4.0, floor_s=0.05, cap_s=0.2)
        out = [w.run(lambda: "fine", 1.0)]
        with pytest.raises(H.HungLaunch) as ei:
            w.run(lambda: time.sleep(0.5), 0.1)
        out += [str(ei.value), ei.value.timeout_s, w.trips]
        with pytest.raises(ZeroDivisionError):
            w.run(lambda: 1 / 0, 1.0)
        out += [w.timeout_s(),
                H.LaunchWatchdog(factor=100.0, floor_s=0.05,
                                 cap_s=0.5).timeout_s()]
        return out

    out = each_health(monkeypatch, run)
    assert out[0] == "fine" and out[3] == 1
    assert out[4] == 0.08 and out[5] == 0.5


def test_admission_journal_roundtrip(monkeypatch, tmp_path):
    def run(H, clock):
        d = tmp_path / H.__name__.split(".")[0]
        j = H.AdmissionJournal(d)
        hist = [{"type": "invoke", "process": 0, "f": "write", "value": 1}]
        ok = j.record(req_id="abc", seq=3, model_name="cas-register",
                      history=hist, priority=1, client="c1", tier="batch",
                      trace_id="t1", deadline_s=None)
        j.record(req_id="def", seq=1, model_name="cas-register", history=hist,
                 priority=0, client="c2", tier="interactive", trace_id="t2",
                 deadline_s=4.5, idempotency_key="k")
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        entries = j.replay()
        (d / "req-zzz.json").write_text("{not json")
        again = j.replay()
        report = {k: str(v).replace(str(d), "DIR")
                  for k, v in j.corrupt_reports[0].items()}
        j.resolve("abc")
        j.resolve("abc")
        return ok, files, entries, len(again), j.errors, report, j.depth()

    ok, files, entries, n, errors, report, depth = each_health(
        monkeypatch, run)
    assert ok and len(files) == 2
    assert [e["id"] for e in entries] == ["def", "abc"]
    assert n == 2 and errors == 1 and report["reason"] == "unparseable"
    assert depth == 1


@pytest.mark.parametrize("shared", [False, True])
def test_idempotency_map_matches_jax(monkeypatch, tmp_path, shared):
    """Claims, a duplicate, a stale rebind, settle (and a fenced late
    settle), release, lookup, TTL expiry, and a replay into a fresh
    map: equal returns, and equal files, in both packages."""
    def run(H, clock):
        d = tmp_path / f"{H.__name__.split('.')[0]}-{shared}"
        m = H.IdempotencyMap(d, ttl_s=10.0, shared=shared)
        t = [m.claim("k1", "r1", fp="fa"), m.claim("k1", "r2", fp="fa"),
             m.claim("k2", "r3")]
        t += [m.rebind("k2", "r3", "r4"), m.rebind("k2", "r3", "r5")]
        m.settle("k1", {"valid?": True}, req_id="r1")
        m.settle("k2", {"valid?": False}, req_id="r3")  # fenced: k2 is r4's
        t += [m.lookup("k1"), m.lookup("k2")]
        m.claim("k3", "r6")
        m.release("k3", "r6")
        t += [m.lookup("k3"), m.depth(), m.describe()]
        files = {p.name: p.read_bytes() for p in sorted(d.glob("idem-*"))}
        fresh = H.IdempotencyMap(d, ttl_s=10.0, shared=shared)
        t += [fresh.replay(), fresh.lookup("k1"), files]
        clock.advance(11.0)
        t += [fresh.lookup("k1"), fresh.claim("k1", "r7"), fresh.depth()]
        return t

    t = each_health(monkeypatch, run)
    assert t[0] is None and t[1]["req_id"] == "r1" and t[2] is None
    assert t[3] is True and t[4] is False
    assert t[5]["result"] == {"valid?": True} and t[6]["result"] is None
    assert t[7] is None and t[10] == 2 and t[11]["result"] == {"valid?": True}
    assert t[13] is None and t[14] is None


def test_history_fingerprint_matches_jax():
    for h in mixed_histories(4) + [[]]:
        assert thealth.history_fingerprint(h) == jhealth.history_fingerprint(h)


# ---------------------------------------------------------------------------
# Service integration (tests/test_serve_health.py's cases)
# ---------------------------------------------------------------------------


def test_service_poison_quarantine_end_to_end(monkeypatch, tmp_path):
    hists = mixed_histories(4)  # index 2 corrupt

    def run(P, d):
        want = [r["valid?"] for r in direct(P, hists)]
        poison_fp = P.health.history_fingerprint(hists[1])

        def poison_inj(ctx, attempt):
            if (ctx.get("what") == "serve.batch"
                    and poison_fp in (ctx.get("members") or ())):
                raise ValueError("injected poison member failure")

        svc = P.sv.CheckService(quarantine_ttl_s=60.0, **svc_kw(P))
        with P.faults.inject_scope(poison_inj):
            futs = [svc.submit(hh) for hh in hists]
            svc.step()
        got = outcome(svc, futs)
        for i in (0, 2, 3):
            assert got[i]["valid?"] == want[i]
        st = stats_core(svc.stats())
        again = outcome(svc, [svc.submit(hists[1])])
        return got, st, again, stats_core(svc.stats())

    got, st, again, st2 = both(monkeypatch, tmp_path, run, record=True)
    assert got[1]["valid?"] == "unknown" and got[1]["quarantined"] is True
    assert "bisection" in got[1]["cause"] and got[1]["status"] == "quarantined"
    assert st["poison_isolated"] == 1
    assert 0 < st["bisect_launches"] <= thealth.bisect_launch_budget(4)
    assert st["breaker"]["state"] == "closed"
    assert again[0]["quarantined"] is True
    assert "repeat poison" in again[0]["cause"]
    assert st2["bisect_launches"] == st["bisect_launches"]
    assert st2["quarantined"] == 2 and st2["quarantine"]["entries"] == 1


def test_breaker_opens_rejects_and_half_open_recovers(monkeypatch, tmp_path):
    hists = mixed_histories(2)

    def failing(*a, **kw):
        raise RuntimeError("UNAVAILABLE: injected transient device loss")

    def run(P, d):
        real = P.batch.batch_analysis
        svc = P.sv.CheckService(breaker_threshold=2, breaker_cooldown_s=5.0,
                                poison_bisect=True, **svc_kw(P))
        monkeypatch.setattr(P.batch, "batch_analysis", failing)
        failed = []
        for _ in range(2):
            f = svc.submit(hists[0])
            svc.step()
            failed += outcome(svc, [f])
        state = svc.breaker.state
        with pytest.raises(P.sv.ServiceUnavailable) as ei:
            svc.submit(hists[0])
        assert 0 < ei.value.retry_after <= 5.0
        rejected = svc.stats()["breaker_rejected"]
        svc.breaker.cooldown_s = 0.0
        monkeypatch.setattr(P.batch, "batch_analysis", real)
        f = svc.submit(hists[0])
        probe = svc.breaker.state
        svc.step()
        return failed, state, rejected, probe, outcome(svc, [f]), \
            svc.breaker.state, stats_core(svc.stats())

    failed, state, rejected, probe, ok, closed, _ = both(
        monkeypatch, tmp_path, run, record=True)
    assert all(r["valid?"] == "unknown" and r["status"] == "error"
               for r in failed)
    assert state == "open" and rejected == 1 and probe == "half-open"
    assert ok[0]["valid?"] is True and closed == "closed"


def test_watchdog_hung_launch_cancel_and_retry(monkeypatch, tmp_path):
    """A launch that blows its cap is abandoned and retried on reduced
    placement; the callers get the direct verdicts.  The abandoned
    launch (a host sleep standing in for a wedged CUDA launch, which
    cannot be cancelled) later tries to demux a verdict of its own for
    every member through the ladder's early-demux hook: first write
    wins, so each caller keeps the retry's verdict and nothing is
    counted twice."""
    hists = mixed_histories(3)

    def run(P, d):
        want = [r["valid?"] for r in direct(P, hists,
                                            confirm_refutations=False)]
        real = P.batch.batch_analysis
        calls = {"n": 0}
        woke = threading.Event()

        def slow_once(model, histories, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                time.sleep(1.2)
                for i in range(len(histories)):
                    kw["admission"].on_result(i, {"valid?": "zombie"})
                woke.set()
                return [{"valid?": "zombie"}] * len(histories)
            return real(model, histories, **kw)

        monkeypatch.setattr(P.batch, "batch_analysis", slow_once)
        svc = P.sv.CheckService(watchdog_factor=1e-6, watchdog_floor_s=0.3,
                                watchdog_cap_s=0.5, confirm_refutations=False,
                                **svc_kw(P))
        futs = [svc.submit(hh) for hh in hists]
        svc.step()
        got = outcome(svc, futs)
        assert [g["valid?"] for g in got] == want
        st = stats_core(svc.stats())
        assert woke.wait(10)
        assert outcome(svc, futs) == got
        assert stats_core(svc.stats()) == st
        return got, st, calls["n"]

    got, st, n = both(monkeypatch, tmp_path, run)
    assert st["watchdog_trips"] == 1 and n >= 2
    assert st["completed"] == 3


def test_placement_probe_shrinks_to_survivors(monkeypatch, tmp_path):
    """devices=8 in both packages (8 virtual CPU devices in the JAX
    package, 8 logical shards of the CPU in the port): a failed probe
    of device 5 shrinks the placement to the 7 others, re-arms the
    parity probe, and a healthy probe changes nothing further."""
    def run(P, d):
        def dev_inj(ctx, attempt):
            if (ctx.get("what") == "placement.probe"
                    and int(ctx.get("device", -1)) == 5):
                raise RuntimeError("injected device loss")

        svc = P.sv.CheckService(devices=8, health_probe_every_s=0.0,
                                **svc_kw(P))
        before = svc.stats()["placement"]
        svc._parity_checked = True
        with P.faults.inject_scope(dev_inj):
            svc._probe_placement()
        st = stats_core(svc.stats())
        rearmed = svc._parity_checked is False
        gen = svc._placement.generation
        svc._t_probe = 0.0
        svc._probe_placement()
        return before, st, rearmed, gen, svc._placement.generation

    before, st, rearmed, gen, gen2 = both(monkeypatch, tmp_path, run,
                                          record=True)
    assert before["devices"] == 8
    assert st["devices_replaced"] == 1 and st["placement"]["devices"] == 7
    assert st["placement"]["lost_devices"] == 1
    assert rearmed and gen == 1 and gen2 == 1


# ---------------------------------------------------------------------------
# Across packages, and the device choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_drain_resumes_across_packages(monkeypatch, tmp_path, writer, reader):
    """A drain dir one package's shutdown wrote is finished by the
    other's ``resume_drained`` with the direct verdicts."""
    hists = mixed_histories(4)
    pin_ids(monkeypatch)
    W, R = PKG[writer], PKG[reader]
    svc = W.sv.CheckService(drain_dir=tmp_path / "drain", **svc_kw(W))
    ids = [svc.submit(hh, client="t").id for hh in hists]
    assert svc.shutdown(drain=True)["drained"] == 4
    groups = R.sv.resume_drained(tmp_path / "drain", **R.dev)
    assert len(groups) == 1 and groups[0]["ids"] == ids
    assert [r["valid?"] for r in groups[0]["results"]] == [
        r["valid?"] for r in direct(R, hists)]


class _NoCuda(torch.overrides.TorchFunctionMode):
    """Records every torch call that names a CUDA device."""

    def __init__(self):
        super().__init__()
        self.cuda_calls = []

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in list(args) + list(kwargs.values()):
            if (isinstance(a, (str, torch.device))
                    and str(a).startswith("cuda")):
                self.cuda_calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **kwargs)


def test_cpu_service_asks_for_no_cuda_tensor(monkeypatch, tmp_path):
    """With torch told a card is present, a service built with
    ``device="cpu"`` runs its ladder with a mesh of 4 shards and the
    placement's probe, its graph lane on the "device" cycle backend and
    a stream, and names a CUDA device in no torch call."""
    from jepsen_tpu_torch.checker import elle
    from jepsen_tpu_torch.testing import gentxn

    P = PKG["port"]
    hists = mixed_histories(4)
    want = [r["valid?"] for r in direct(P, hists)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(elle, "CYCLE_BACKEND", "device")
    mode = _NoCuda()
    with mode:
        svc = P.sv.CheckService(devices=4, verify_placement=True,
                                health_probe_every_s=0.0, **svc_kw(P))
        futs = [svc.submit(hh) for hh in hists]
        txns = [gentxn.append_history(12, n_keys=2, n_procs=3, seed=s)
                for s in range(3)]
        gfuts = [svc.submit(t, checker=elle.ListAppendChecker())
                 for t in txns]
        svc.step()
        sid = svc.stream_open(model=P.m.CASRegister(None))["stream-id"]
        svc.stream_feed(sid, hists[2])
        closed = svc.stream_close(sid)
    assert [f.result(timeout=30)["valid?"] for f in futs] == want
    assert all(f.result(timeout=30)["valid?"] is True for f in gfuts)
    assert closed["result"]["valid?"] == want[2]
    assert svc.stats()["placement"]["devices"] == 4
    assert mode.cuda_calls == []


def test_service_without_device_needs_a_card(monkeypatch, tmp_path):
    """Without ``device`` the service runs on the card: where there is
    none (torch told so) its launches fail (an attributable unknown naming the missing
    device, never a verdict computed on the CPU), its mesh cannot be
    built, and a stream cannot open."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P = PKG["port"]
    svc = P.sv.CheckService(capacity=CAP, warm_pool=False,
                            poison_bisect=False)
    f = svc.submit(mixed_histories(1)[0])
    svc.step()
    r = f.result(timeout=30)
    assert r["valid?"] == "unknown" and "CUDA" in r["cause"]
    with pytest.raises(RuntimeError, match="CUDA"):
        P.sv.CheckService(capacity=CAP, warm_pool=False, devices=4).mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        svc.stream_open(model=P.m.CASRegister(None))
