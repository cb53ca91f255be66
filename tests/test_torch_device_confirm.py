"""Device confirmation (``confirm_refutations="device"``, ROADMAP queue
A5) in the port's ladder against the JAX package's.

After the ladder drains, every fast-rung refutation is confirmed by one
batched exact launch per capacity over its failure prefix: a lossless
exact death is final (``confirmed?``), anything else takes the bounded
sweep.  On tests/test_parallel.py's shapes ((30, 3) histories, every
third corrupted, at (64, 256) and at (256,)) the port's verdicts, ops
and ``confirmed?`` flags equal the JAX package's in device mode and the
port's own worker mode.  A spent deadline before the confirmations
degrades each refutation to unknown with its checkpoint, as in the JAX
package, and a resume finishes them.  A confirming launch that fails
after its retries leaves its refutations unknown with the failure as
cause, where the JAX package sweeps them (ROADMAP C4).
"""

import pytest
import torch

from jepsen_tpu import faults as jf
from jepsen_tpu import models as jm
from jepsen_tpu.parallel import batch as jb
from jepsen_tpu_torch import faults as tf
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.parallel import batch as tb
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history
from test_torch_resume import TripAfter


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def histories_mixed(n=9):
    hists, expect = [], []
    for i in range(n):
        hist = valid_register_history(30, 3, seed=i, info_rate=0.1)
        if i % 3 == 2:
            hist = corrupt(hist, seed=i)
            expect.append(wgl_cpu.sweep_analysis(tm.CASRegister(None),
                                                 hist)["valid?"])
        else:
            expect.append(True)
        hists.append(hist)
    return hists, expect


def _summary(res):
    return [(r["valid?"], (r.get("op") or {}).get("index"),
             r.get("confirmed?")) for r in res]


@pytest.mark.parametrize("capacity", [(64, 256), (256,)])
@pytest.mark.parametrize("dedup", ["sort", "fused"])
def test_device_confirmation_matches_jax(capacity, dedup):
    hists, expect = histories_mixed(9)
    kw = dict(capacity=capacity, cpu_fallback=False, exact_escalation=(),
              confirm_refutations="device")
    want = jb.batch_analysis(jm.CASRegister(None), hists, **kw)
    stats = {}
    got = tb.batch_analysis(tm.CASRegister(None), hists, device="cpu",
                            dedup_backend=dedup, stats=stats, **kw)
    assert _summary(got) == _summary(want)
    assert [r["valid?"] for r in got] == expect
    assert stats["device_confirm"]["refutations"] == expect.count(False)
    assert stats["device_confirm"]["launches"] >= 1
    for r in got:
        if r["valid?"] is False:
            assert r["confirmed?"] is True
            assert {"event": "confirm.device", "outcome": "refuted-final"} in (
                r["provenance"]["path"])
    wrk = tb.batch_analysis(tm.CASRegister(None), hists, device="cpu",
                            dedup_backend=dedup, confirm_workers=2,
                            **{**kw, "confirm_refutations": True})
    assert _summary(wrk) == _summary(got)
    tb.shutdown_confirm_pool()


def test_deadline_before_device_confirmation_then_resume(tmp_path):
    """The budget runs out after the last rung, before the confirming
    launches: each refutation is unknown with the checkpoint's path, as
    in the JAX package; a resume confirms them."""
    hists, expect = histories_mixed(9)
    kw = dict(capacity=(64, 256), cpu_fallback=False, exact_escalation=(),
              confirm_refutations="device", dedup_backend="sort")
    stats = {}
    tb.batch_analysis(tm.CASRegister(None), hists, device="cpu", stats=stats,
                      **kw)
    # one poll per rung run; the next one finds the budget spent
    polls = len(stats["rungs"])
    out = {}
    for pkg, faults, mod, model in (("jax", jf, jb, jm), ("port", tf, tb, tm)):
        extra = {"device": "cpu"} if pkg == "port" else {}
        got = mod.batch_analysis(model.CASRegister(None), hists,
                                 checkpoint_dir=tmp_path / pkg,
                                 deadline=TripAfter(faults, polls), **kw,
                                 **extra)
        resumed = mod.batch_analysis(model.CASRegister(None), hists,
                                     checkpoint_dir=tmp_path / pkg,
                                     resume=True, **kw, **extra)
        out[pkg] = ([(r["valid?"], (r.get("cause") or "").split(
            "; resumable checkpoint")[0]) for r in got], _summary(resumed))
    assert out["port"] == out["jax"]
    assert any(c.startswith("device refutation; deadline-exceeded")
               for _v, c in out["port"][0])
    assert [v for v, _o, _c in out["port"][1]] == expect


def test_failed_confirmation_launch_leaves_refutations_unknown(monkeypatch):
    """The exact confirming launch fails on every attempt: each
    refutation it carried is unknown, naming the failure, and no sweep
    runs in the launch's place, ``cpu_fallback`` or not."""
    monkeypatch.setenv("JEPSEN_TPU_LAUNCH_RETRIES", "1")
    monkeypatch.setenv("JEPSEN_TPU_RETRY_BASE_S", "0.001")
    hists, expect = histories_mixed(9)

    def inject(ctx, attempt):
        if ctx.get("what") == "ladder.confirm":
            raise RuntimeError("UNAVAILABLE: chip is gone")

    def no_sweep(*a, **kw):
        raise AssertionError("the CPU sweep ran in a failed launch's place")

    monkeypatch.setattr(wgl_cpu, "sweep_analysis", no_sweep)
    stats = {}
    with tf.inject_scope(inject):
        got = tb.batch_analysis(
            tm.CASRegister(None), hists, device="cpu", capacity=(64, 256),
            cpu_fallback=True, exact_escalation=(), dedup_backend="sort",
            confirm_refutations="device", stats=stats)
    assert stats["device_confirm"]["launches"] == 0
    assert stats["device_confirm"]["refutations"] == expect.count(False)
    for r, e in zip(got, expect):
        if e is False:
            assert r["valid?"] == "unknown"
            assert r["cause"].startswith(
                "device refutation; exact confirmation launch failed")
            assert "UNAVAILABLE" in r["cause"]
            events = [p["event"] for p in r["provenance"]["path"]]
            assert "fault.launch-degraded" in events
            assert "cpu-fallback" not in events
        else:
            assert r["valid?"] == e
