"""The port's "sync" engine, exact escalation stages and mesh fallback
against the JAX package's, on the same histories.

``batch_analysis(engine="sync")`` at the suite's shared (30, 3)@(64,
256) shape and ``exact_escalation=(256,)`` behind a (8,) rung on the
(40, 5) histories of tests/test_parallel.py, under "sort" and under
"fused" (the JAX package's "pallas"), give the JAX package's results per
history: verdict, op and stats, compared exactly.  ``mesh_kernel_analysis``
on one shard, and on four shards at a geometry the mesh stage refuses,
falls back to ``wgl.analysis(fast=True)`` and equals the JAX package's
fallback; the ladder's mesh rescue takes that fallback instead of
raising.
"""

import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.ops import wide_kernel as wk
from jepsen_tpu.parallel import batch_analysis as jax_batch_analysis
from jepsen_tpu.parallel import make_mesh as jax_make_mesh
from jepsen_tpu.parallel import sharded as jsh
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wide_kernel as twk
from jepsen_tpu_torch.parallel import batch as tbatch
from jepsen_tpu_torch.parallel import sharded as tsh
from jepsen_tpu_torch.parallel.mesh import make_mesh
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hists_30_3(n=9):
    """tests/test_parallel.py's mixed histories: every third corrupted."""
    out = []
    for i in range(n):
        hh = valid_register_history(30, 3, seed=i, info_rate=0.1)
        out.append(corrupt(hh, seed=i) if i % 3 == 2 else hh)
    return out


def hists_40_5():
    """tests/test_parallel.py's exact-stage histories: every other
    corrupted."""
    out = []
    for i in range(6):
        hh = valid_register_history(40, 5, seed=500 + i, info_rate=0.2)
        out.append(corrupt(hh, seed=i) if i % 2 else hh)
    return out


def _strip(res):
    return [{k: v for k, v in r.items() if k != "provenance"} for r in res]


def _both(hists, backend, **kw):
    """(JAX results, port results) of one ladder, without confirmation
    or the CPU fallback, so every verdict is the engines' own."""
    kw = dict(cpu_fallback=False, confirm_refutations=False, **kw)
    jb = "pallas" if backend == "fused" else backend
    jkw = {k: v for k, v in kw.items() if k != "stats"}
    want = _strip(jax_batch_analysis(jm.CASRegister(None), hists,
                                     dedup_backend=jb, **jkw))
    got = _strip(tbatch.batch_analysis(tm.CASRegister(None), hists,
                                       dedup_backend=backend, device="cpu",
                                       **kw))
    return want, got


@pytest.mark.parametrize("backend", ["sort", "fused"])
def test_sync_engine_matches_jax(backend):
    """The barrier-scan rungs at (64, 256): results identical per
    history; refutations are found (and left unconfirmed here)."""
    want, got = _both(hists_30_3(), backend, capacity=(64, 256),
                      engine="sync", exact_escalation=())
    assert got == want
    assert any(r["valid?"] is False for r in got)
    assert all(r["valid?"] is not True or "kernel" in r for r in got)


@pytest.mark.parametrize("backend", ["sort", "fused"])
def test_exact_escalation_matches_jax(backend):
    """A (8,) async rung leaves stragglers to the exact stage at 256;
    the results equal the JAX package's per history, and agree with the
    exact sweep."""
    hists = hists_40_5()
    stats: dict = {}
    want, got = _both(hists, backend, capacity=(8,), exact_escalation=(256,),
                      stats=stats)
    assert got == want
    exact = [r for r in stats["rungs"] if r["engine"] == "exact"]
    assert exact and exact[0]["lanes"] > 0 and exact[0]["capacity"] == 256
    assert exact[0]["resolved"] + exact[0]["refuted"] > 0
    for hh, r in zip(hists, got):
        truth = wgl_cpu.sweep_analysis(tm.CASRegister(None), hh)["valid?"]
        assert r["valid?"] in (truth, "unknown")


def test_sync_then_exact_ladder_matches_jax():
    """engine="sync" at (16, 64) then exact at 256, in one ladder."""
    want, got = _both(hists_40_5(), "fused", capacity=(16, 64),
                      engine="sync", exact_escalation=(256,))
    assert got == want


@pytest.mark.parametrize("case", ["one-shard", "infeasible"])
def test_mesh_fallback_matches_jax(case, monkeypatch):
    """mesh_kernel_analysis falls back to wgl.analysis(fast=True) on one
    shard and where the geometry is infeasible (the wide floor above the
    rung); the port's result equals its own chunked engine and the JAX
    package's fallback on the same history, decision path included (the
    engine blocks name each package's own fused backend)."""
    hist = corrupt(valid_register_history(20, 3, seed=0, info_rate=0.1), seed=0)
    if case == "one-shard":
        pmesh, jmesh, cap = make_mesh(1, device="cpu"), jax_make_mesh(1), 64
    else:
        monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "4096")
        monkeypatch.setenv(wk.PALLAS_MIN_CAPACITY_ENV, "4096")
        pmesh, jmesh, cap = (make_mesh(4, device="cpu"),
                             jax_make_mesh(4, axis="frontier"), 256)
    got = tsh.mesh_kernel_analysis(tm.CASRegister(None), hist, pmesh,
                                   capacity=(cap,))
    chunked = twgl.analysis(tm.CASRegister(None), hist, capacity=(cap,),
                            fast=True, dedup_backend="fused", device="cpu")
    want = jsh.mesh_kernel_analysis(jm.CASRegister(None), hist, jmesh,
                                    capacity=(cap,))
    paths = [r.pop("provenance")["path"] for r in (got, chunked, want)]
    assert paths[0] == paths[1] == paths[2]
    assert got == chunked == want
    assert got["valid?"] is False and got["provisional?"] is True
    jwgl.evict_runner_caches()


def test_mesh_rescue_takes_the_fallback(monkeypatch):
    """With the mesh stage infeasible at the rescue capacity, the ladder's
    rescue runs the chunked fallback at 4 x 16 rows instead of raising:
    lanes the (16,) rung left undecided are decided, and every verdict
    agrees with the sweep."""
    monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "1000000")
    hists = hists_40_5()
    stats: dict = {}
    res = tbatch.batch_analysis(
        tm.CASRegister(None), hists, capacity=(16,), cpu_fallback=False,
        confirm_refutations=True, device="cpu", mesh=make_mesh(4, device="cpu"),
        stats=stats)
    rescue = stats["mesh_rescue"]
    assert rescue["lanes"] > 0 and rescue["resolved"] > 0
    for hh, r in zip(hists, res):
        truth = wgl_cpu.sweep_analysis(tm.CASRegister(None), hh)["valid?"]
        assert r["valid?"] in (truth, "unknown")
    tbatch.shutdown_confirm_pool()
