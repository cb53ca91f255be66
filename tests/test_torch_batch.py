"""The slice as a whole: the port's capacity ladder against the JAX
package's, on the same histories.

Port ``batch_analysis(device="cpu")`` (fused and bucket backends) and
JAX ``batch_analysis(dedup_backend="pallas")`` at capacity (64, 256),
with the wide floor lowered to 64 in both packages so their fused
updates run, must give identical verdicts per history; every ``True``
is re-checked by the port's exact sweep.
"""

import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.ops import wide_kernel as wk
from jepsen_tpu.parallel import batch_analysis as jax_batch_analysis
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.ops import wide_kernel as twk
from jepsen_tpu_torch.parallel import batch as tbatch
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on one host: one torch
    thread each keeps them from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def wide_floor(monkeypatch):
    monkeypatch.setenv(wk.PALLAS_MIN_CAPACITY_ENV, "64")
    monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "64")
    yield
    jwgl.evict_runner_caches()


def _histories():
    """Valid and corrupted CAS histories, some info-heavy enough to
    overflow the 64-row rung and resume at 256."""
    hs = []
    for i in range(10):
        hh = valid_register_history(40, 5, seed=100 + i,
                                    info_rate=0.4 if i % 2 else 0.15)
        if i % 3 == 2:
            hh = corrupt(hh, seed=i)
        hs.append(hh)
    return hs


def test_ladder_verdicts_identical_to_jax(wide_floor):
    """Per-history verdicts identical to the JAX ladder under "pallas",
    for both port backends; the ladder really escalates (the 256 rung
    runs, from carried frontiers); every True agrees with the exact
    sweep (verdicts compared exactly)."""
    hists = _histories()
    kw = dict(capacity=(64, 256), cpu_fallback=False, exact_escalation=())
    want = [r["valid?"] for r in jax_batch_analysis(
        jm.CASRegister(None), hists, dedup_backend="pallas", **kw)]
    assert True in want and False in want
    for dedup in ("fused", "bucket"):
        stats = {}
        got = tbatch.batch_analysis(tm.CASRegister(None), hists,
                                    dedup_backend=dedup, device="cpu",
                                    confirm_workers=2, stats=stats, **kw)
        assert [r["valid?"] for r in got] == want, dedup
        rungs = [(r["engine"], r["capacity"], r["lanes"]) for r in stats["rungs"]]
        assert rungs[0][0] == "greedy" and rungs[-1][1] == 256, rungs
        assert rungs[-1][2] > 0
        for r in got:
            if r["valid?"] is False:
                assert r.get("confirmed?") is True
    for hh, v in zip(hists, want):
        if v is True:
            assert wgl_cpu.sweep_analysis(tm.CASRegister(None), hh)["valid?"] is True


def test_unconfirmed_and_fallback_paths():
    """confirm_refutations=False reports the device's refutation
    unconfirmed; cpu_fallback decides what the ladder leaves unknown;
    histories that pack to no barrier are True (verdicts exact)."""
    model = tm.CASRegister(None)
    bad = corrupt(valid_register_history(20, 3, seed=4, info_rate=0.1), seed=4)
    heavy = valid_register_history(40, 5, seed=101, info_rate=0.4)
    (r,) = tbatch.batch_analysis(model, [bad], capacity=(64,),
                                 confirm_refutations=False, cpu_fallback=False,
                                 device="cpu")
    assert r["valid?"] is False and "confirmed?" not in r
    res = tbatch.batch_analysis(model, [heavy, []], capacity=(8,),
                                greedy_first=False, cpu_fallback=True,
                                device="cpu")
    assert res[0]["valid?"] == wgl_cpu.sweep_analysis(model, heavy)["valid?"]
    assert res[1]["valid?"] is True
    res = tbatch.batch_analysis(model, [heavy], capacity=(8,),
                                greedy_first=False, cpu_fallback=False,
                                device="cpu")
    assert res[0]["valid?"] == "unknown"
    assert "exhausted" in res[0]["cause"]
