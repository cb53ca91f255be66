"""Rung admission (continuous batching) in the port's ladder against the
JAX package's, with the same scripted feeder.

A feeder (its own copy of tests/test_serve_sched.py's) hands histories
to the running ladder at chosen polls; they join at rung 0 and must get
the verdicts of a one-shot call, in admission order, with decided
verdicts demuxed early.  The port (on the CPU, "sort" backend) must
poll, report its rungs and demux exactly as the JAX package does on the
same inputs (the reports' seconds aside).  A deadline that trips in the
middle of an admitted run checkpoints the grown membership; a resume
over the grown list gives the one-shot verdicts in both packages.
Shapes: tests/test_serve_sched.py's (30, 3) histories at (64, 256).
"""

import pytest
import torch

from jepsen_tpu import faults as jf
from jepsen_tpu import models as jm
from jepsen_tpu.parallel import batch as jb
from jepsen_tpu_torch import faults as tf
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.parallel import batch as tb
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history
from test_torch_resume import TripAfter

KW = dict(capacity=(64, 256), dedup_backend="sort", cpu_fallback=False,
          exact_escalation=(), confirm_refutations=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mixed_histories(n=6):
    hists = []
    for i in range(n):
        hist = valid_register_history(30, 3, seed=i, info_rate=0.1)
        if i % 3 == 2:
            hist = corrupt(hist, seed=i)
        hists.append(hist)
    return hists


class ScriptedFeeder:
    """A deterministic rung-admission hook: ``waves[k]`` joins at the
    k-th poll; records every poll, rung report and early verdict."""

    def __init__(self, waves: dict, pad_lanes=None):
        self.waves = dict(waves)
        self.polls = []
        self.rungs = []
        self.early: dict = {}
        if pad_lanes is not None:
            self.pad_lanes = pad_lanes

    def poll(self, *, stage, lanes):
        k = len(self.polls)
        self.polls.append((stage, lanes))
        return self.waves.pop(k, [])

    def on_result(self, i, result):
        self.early[i] = result

    def on_rung(self, **kw):
        self.rungs.append(kw)


def run(pkg, hists, **kw):
    if pkg == "jax":
        return jb.batch_analysis(jm.CASRegister(None), hists, **kw)
    return tb.batch_analysis(tm.CASRegister(None), hists, device="cpu", **kw)


def _admitted(pkg, waves, pad_lanes=None, **kw):
    hists = mixed_histories(6)
    feeder = ScriptedFeeder({k: [hists[i] for i in v]
                             for k, v in waves.items()}, pad_lanes)
    first = [hists[i] for i in range(6) if not any(i in v for v in waves.values())]
    res = run(pkg, first, admission=feeder, **{**KW, **kw})
    rungs = [{k: v for k, v in r.items() if k != "seconds"}
             for r in feeder.rungs]
    early = {i: (r["valid?"], (r.get("op") or {}).get("index"))
             for i, r in feeder.early.items()}
    return ([(r["valid?"], (r.get("op") or {}).get("index")) for r in res],
            feeder.polls, rungs, early,
            [r["provenance"]["path"] for r in res])


@pytest.mark.parametrize("waves,pad", [
    ({1: [4, 5]}, None),            # two join at the second poll
    ({0: [3], 2: [4, 5]}, None),    # one at once, two after a rung
    ({1: [4, 5]}, 16),              # a fixed lane width
])
def test_admission_matches_jax(waves, pad):
    """Verdicts, polls, per-rung reports, early results and decision
    paths equal the JAX package's; the verdicts equal a one-shot call's
    in admission order."""
    got = _admitted("port", waves, pad)
    assert got == _admitted("jax", waves, pad)
    order = [i for i in range(6) if not any(i in v for v in waves.values())]
    order += [i for k in sorted(waves) for i in waves[k]]
    direct = run("port", mixed_histories(6), **KW)
    assert [v for v, _ in got[0]] == [direct[i]["valid?"] for i in order]
    polls, rungs, early = got[1], got[2], got[3]
    assert len(polls) >= 2 and rungs
    assert all(0 < r["lanes"] <= r["padded"] for r in rungs)
    assert early and all(got[0][i] == v for i, v in early.items())


def test_worker_confirmed_admission_matches_one_shot():
    """With worker confirmation (confirmations demuxed at rung
    boundaries) the admitted verdicts still equal the one-shot call's."""
    hists = mixed_histories(6)
    feeder = ScriptedFeeder({1: hists[4:]})
    kw = dict(KW, confirm_refutations=True)
    got = run("port", hists[:4], admission=feeder, confirm_workers=2, **kw)
    direct = run("port", hists, confirm_workers=2, **kw)
    assert [r["valid?"] for r in got] == [r["valid?"] for r in direct]
    assert [r.get("confirmed?") for r in got] == [
        r.get("confirmed?") for r in direct]
    for i, r in feeder.early.items():
        assert r["valid?"] == got[i]["valid?"]
    tb.shutdown_confirm_pool()


def test_deadline_mid_admission_then_resume_over_the_grown_list(tmp_path):
    """A deadline trips at the second stage of an admitted run: the
    checkpoint holds the grown membership's fingerprint, and a resume
    over the grown list (original members, then the joiners) gives the
    one-shot verdicts, as in the JAX package."""
    hists = mixed_histories(6)
    out = {}
    for pkg, faults in (("jax", jf), ("port", tf)):
        feeder = ScriptedFeeder({1: hists[4:]})
        d = tmp_path / pkg
        tripped = run(pkg, hists[:4], admission=feeder, checkpoint_dir=d,
                      deadline=TripAfter(faults, 1), **KW)
        assert len(tripped) == 6
        assert any("deadline-exceeded" in (r.get("cause") or "")
                   for r in tripped)
        resumed = run(pkg, hists, checkpoint_dir=d, resume=True, **KW)
        out[pkg] = ([(r["valid?"], r.get("cause", "").split(";")[0])
                     for r in tripped], [r["valid?"] for r in resumed])
    assert out["port"] == out["jax"]
    direct = run("port", hists, **KW)
    assert out["port"][1] == [r["valid?"] for r in direct]
