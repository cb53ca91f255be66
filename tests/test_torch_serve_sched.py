"""The port's scheduler (``jepsen_tpu_torch.serve.sched``) and the service
paths it drives, against the JAX package's on the same inputs.

The cases of tests/test_serve_sched.py that exercise the service run in
both packages through ``test_torch_serve.both`` (verdicts, statuses,
causes, stats and, where recorded, the normalized serve streams
compared).  The two ladder-only cases there
(``test_rung_admission_verdict_parity``,
``test_mid_ladder_drain_with_membership_churn``) already have their
counterparts in tests/test_torch_admission.py.  The JAX case's greedy
fast-path wave through ``lane_shard`` has none: the port does not place
lanes across shards (ROADMAP B4), and its service's fast path is the
host walk.

The pure parts run at tolerance 0 on the same inputs: ``classify`` and
``AdmissionQueues`` (depths, limits, per-class EWMAs and retry-after
quotes under an injected clock), ``padded_batch(n, mesh)`` for n in
1..130 on meshes of 1, 3 and 4, and the placement's probe and shrink on
logical shards, where every shard is the same device.  A journal written
by either package is replayed by the other.
"""

import threading
import types

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from jepsen_tpu.checker import elle as jelle
from jepsen_tpu.parallel import batch as jb
from jepsen_tpu.serve import sched as jsched
from jepsen_tpu.serve.sched import admission as jadm
from jepsen_tpu_torch.checker import elle as telle
from jepsen_tpu_torch.parallel import batch as tb
from jepsen_tpu_torch.parallel import mesh as tmesh
from jepsen_tpu_torch.serve import sched as tsched
from jepsen_tpu_torch.serve.sched import admission as tadm
from test_torch_serve import (  # noqa: F401 — _isolated is autouse here too
    CAP, PKG, _isolated, both, direct, mixed_histories, outcome, pin_ids,
    stats_core, svc_kw,
)

SCHED = {"jax": jsched, "port": tsched}
ELLE = {"jax": jelle, "port": telle}
ADM = {"jax": jadm, "port": tadm}


def test_fastpath_and_batch_tier_isolation(monkeypatch, tmp_path):
    hists = mixed_histories(6)  # indices 2, 5 corrupt

    def run(P, d):
        want = [r["valid?"] for r in direct(P, hists)]
        svc = P.sv.CheckService(**svc_kw(P))
        futs = [svc.submit(hh, class_="interactive" if i < 4 else "batch")
                for i, hh in enumerate(hists)]
        queued = {t: c["queued"] for t, c in svc.stats()["classes"].items()}
        svc.step()
        got = outcome(svc, futs)
        assert [g["valid?"] for g in got] == want
        fast = [f.result().get("fastpath") for f in futs[:4]]
        docs = [stats_core(svc.get(f.id).describe()) for f in futs]
        for doc in docs:
            doc.pop("latency_s")
            doc.pop("latency")
            doc["result"] = {k: v for k, v in doc["result"].items()
                             if k != "latency"}
        return queued, fast, got, docs, stats_core(svc.stats())

    queued, fast, _, docs, st = both(monkeypatch, tmp_path, run, record=True)
    assert queued == {"interactive": 4, "batch": 2}
    assert fast == ["greedy", "greedy", None, "greedy"]
    assert st["fastpath_resolved"] == 3 and st["escalated"] == 1
    assert docs[2]["escalated"] is True and docs[0]["class"] == "interactive"


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("case", range(4))
def test_admission_queues_match_jax(monkeypatch, case):
    """``classify`` and ``AdmissionQueues`` on one scripted sequence of
    pushes, walls, wave timers, expiries and removals (the clock
    injected into both modules): every depth, limit check, EWMA,
    retry-after quote and description equal."""
    out = {}
    for name in ("jax", "port"):
        A = ADM[name]
        clock = _Clock()
        monkeypatch.setattr(A, "time", types.SimpleNamespace(monotonic=clock))
        q = A.AdmissionQueues(6, max_interactive=None if case % 2 else 3)
        r = np.random.default_rng(case)
        trace = []

        class Req:
            def __init__(self, seq, tier, dl):
                self.seq, self.tier, self.deadline = seq, tier, dl

        class DL:
            def __init__(self, at):
                self.at = at

            def expired(self):
                return clock.t >= self.at

        live = []
        for step in range(40):
            op = int(r.integers(0, 6))
            tier = A.CLASSES[int(r.integers(0, 2))]
            clock.t += float(r.integers(0, 5)) * 0.25
            if op == 0:
                b = int(r.integers(0, 40))
                cls = A.classify(None if r.integers(0, 2) else tier, B=b,
                                 interactive_max_b=int(r.integers(0, 20)))
                req = Req(step, cls, DL(clock.t + float(r.integers(1, 4)))
                          if r.integers(0, 2) else None)
                over = q.over_limit(cls, int(r.integers(0, 2)))
                if not over:
                    q.push(req)
                    live.append(req)
                trace.append(("push", cls, over))
            elif op == 1:
                q.record_wall(tier, float(r.integers(1, 100)) * 0.01)
                trace.append(("wall", tier))
            elif op == 2:
                with A.WaveTimer(q, tier):
                    clock.t += 0.5
                trace.append(("wave", tier))
            elif op == 3:
                trace.append(("expired", [x.seq for x in q.take_expired()]))
            elif op == 4 and live:
                gone = live[: int(r.integers(1, 3))]
                q.remove([x for x in gone if x in q.queues[x.tier]])
                live = live[len(gone):]
                trace.append(("remove", [x.seq for x in gone]))
            trace.append((q.depth(), {t: q.depth(t) for t in A.CLASSES},
                          {t: q.retry_after(t, 4) for t in A.CLASSES},
                          q.describe(4), dict(q.ewma_s)))
        trace.append([x.seq for x in q.drain_all()])
        out[name] = trace
    assert out["port"] == out["jax"]


def test_retry_after_is_computed_per_class(monkeypatch, tmp_path):
    q = tsched.AdmissionQueues(8)
    q.record_wall("batch", 4.0)
    q.record_wall("interactive", 0.004)
    assert q.retry_after("batch", 4) > 0.5
    assert q.retry_after("interactive", 4) < 0.1

    def run(P, d):
        svc = P.sv.CheckService(max_queue=1, **svc_kw(P))
        svc._adm.record_wall("batch", 4.0)
        svc._adm.record_wall("interactive", 0.004)
        svc.submit(mixed_histories(1)[0])
        with pytest.raises(P.sv.QueueFull) as ei:
            svc.submit(mixed_histories(2)[1], class_="interactive")
        with pytest.raises(P.sv.QueueFull) as eb:
            svc.submit(mixed_histories(2)[1], class_="batch")
        svc2 = P.sv.CheckService(max_queue=1, max_interactive_queue=2,
                                 **svc_kw(P))
        svc2.submit(mixed_histories(1)[0])
        f = svc2.submit(mixed_histories(2)[1], class_="interactive")
        return ((ei.value.tier, ei.value.retry_after, ei.value.depth,
                 ei.value.limit),
                (eb.value.tier, eb.value.retry_after), f.done(),
                svc2.stats()["classes"]["interactive"]["queued"])

    ei, eb, done, queued = both(monkeypatch, tmp_path, run)
    assert ei[0] == "interactive" and ei[1] < 0.1
    assert eb[0] == "batch" and eb[1] > 0.5
    assert not done and queued == 1


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_padded_batch_matches_jax(shards):
    jmesh = JMesh(np.array(jax.devices()[:shards]), ("histories",))
    tmesh_ = tmesh.make_mesh(shards, device="cpu")
    for n in range(1, 131):
        assert tb.padded_batch(n, tmesh_) == jb.padded_batch(n, jmesh), n
        assert tb.padded_batch(n) == jb.padded_batch(n), n


def test_mesh_placement_verdict_agreement():
    """``assert_parity`` on the port's mesh of 4 logical shards: the
    verdicts with and without the mesh equal each other, the direct
    ones, and the JAX package's on its 8-device mesh."""
    hists = mixed_histories(6)
    P = PKG["port"]
    want = [r["valid?"] for r in direct(P, hists)]
    got = tsched.assert_parity(P.m.CASRegister(None), hists,
                               mesh=tmesh.make_mesh(4, device="cpu"),
                               capacity=CAP, device="cpu")
    assert [r["valid?"] for r in got] == want
    jgot = jsched.assert_parity(PKG["jax"].m.CASRegister(None), hists,
                                mesh=jb.make_mesh(), capacity=CAP)
    assert [r["valid?"] for r in jgot] == want


def test_service_mesh_placement_end_to_end(monkeypatch, tmp_path):
    hists = mixed_histories(4)

    def run(P, d):
        want = [r["valid?"] for r in direct(P, hists)]
        svc = P.sv.CheckService(devices=4, verify_placement=True,
                                **svc_kw(P))
        futs = [svc.submit(hh) for hh in hists]
        svc.step()
        got = outcome(svc, futs)
        assert [g["valid?"] for g in got] == want
        assert svc._parity_checked
        return got, stats_core(svc.stats())

    _, st = both(monkeypatch, tmp_path, run, record=True)
    assert st["placement"] == {"devices": 4, "sharded": True,
                               "mesh_kernel": True}


@pytest.mark.parametrize("fail", [[2], [0, 3]])
def test_placement_probe_shrinks_by_shard_index(fail):
    """A probe with injected failures on logical shards of one device
    reports them by index, and ``shrink_to`` the survivors keeps exactly
    the others: a port mesh of 4 shrinks to 4 - len(fail), ``lost``
    names the failed shards' original indices, and a second shrink
    keeps naming original indices."""
    from jepsen_tpu_torch import faults

    pl = tsched.Placement(devices=4, device="cpu")
    assert pl.n_devices == 4 and pl.probe() == ([0, 1, 2, 3], [])

    def inj(ctx, attempt):
        if ctx.get("what") == "placement.probe" and ctx["device"] in fail:
            raise RuntimeError("injected shard loss")

    with faults.inject_scope(inj):
        healthy, failed = pl.probe()
    assert failed == fail and healthy == [i for i in range(4) if i not in fail]
    pl.shrink_to(healthy)
    assert pl.n_devices == 4 - len(fail) and pl.generation == 1
    assert pl.lost == fail
    assert pl.mesh.device == pl.mesh.devices[0] and pl.mesh.size == len(healthy)
    assert pl.describe() == {"devices": len(healthy), "sharded": True,
                             "mesh_kernel": len(healthy) > 1,
                             "lost_devices": len(fail), "generation": 1}
    survivors = [i for i in range(4) if i not in fail]
    pl.shrink_to([0])
    assert pl.lost == fail + survivors[1:] and pl.generation == 2


def test_graph_requests_skip_geometry_buckets(monkeypatch, tmp_path):
    hists = mixed_histories(2)

    def analyzer(history):
        n = len(history)
        rel = np.zeros((n, n), bool)
        for i in range(n - 1):
            rel[i, i + 1] = True
        if n >= 2:
            rel[n - 1, 0] = True  # a cycle
        return list(history), {"order": rel}, None

    def run(P, d):
        S, E = SCHED[P.name], ELLE[P.name]
        ck = E.CycleChecker(analyzer)
        assert S.geometry_batchable(ck) is False
        assert S.geometry_batchable(object()) is True
        want = [r["valid?"] for r in direct(P, hists)]
        svc = P.sv.CheckService(**svc_kw(P))
        fg = svc.submit([{"type": "ok", "process": i, "f": "w", "value": i}
                         for i in range(3)], checker=ck)
        fl = [svc.submit(hh) for hh in hists]
        groups = {r.group for q in svc._adm.queues.values() for r in q}
        assert S.graph_batch_key(ck) in groups
        svc.step()
        got = outcome(svc, [fg] + fl)
        assert got[0]["valid?"] is False
        assert [g["valid?"] for g in got[1:]] == want
        doc = svc.get(fg.id).describe()
        return (got, stats_core(svc.stats()), doc["geometry_batchable"],
                doc["checker"], S.graph_batch_key(ck)[0])

    _, st, batchable, name, tag = both(monkeypatch, tmp_path, run,
                                       record=True)
    assert st["graphs"] == 1 and st["batches"] == 1
    assert batchable is False and name == "CycleChecker" and tag == "graph"


def _journal_files(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("req-*.json"))}


def test_journal_replay_restart_recovery(monkeypatch, tmp_path):
    """Crash-safe restart in each package: the journal files are equal
    byte for byte, and a fresh service replays them under the original
    ids with the direct verdicts."""
    hists = mixed_histories(6)

    def run(P, d):
        want = [r["valid?"] for r in direct(P, hists)]
        jd = d / "journal"
        svc1 = P.sv.CheckService(journal_dir=jd, **svc_kw(P))
        futs1 = [svc1.submit(hh, client=f"c{i}", priority=i % 2)
                 for i, hh in enumerate(hists)]
        ids = [f.id for f in futs1]
        assert svc1.journal.depth() == 6
        files = _journal_files(jd)
        svc2 = P.sv.CheckService(journal_dir=jd, **svc_kw(P))
        assert svc2.recover() == 6 and svc2.recover() == 0
        assert svc2.stats()["journal_replayed"] == 6
        while svc2.stats()["queue_depth"]:
            svc2.step()
        got = []
        for i, rid in enumerate(ids):
            req = svc2.get(rid)
            assert req is not None and req.future.done()
            assert req.result["valid?"] == want[i] and req.client == f"c{i}"
            got.append((rid, req.result["valid?"], req.status))
        assert svc2.journal.depth() == 0
        assert P.sv.CheckService(journal_dir=jd, **svc_kw(P)).recover() == 0
        return files, got, stats_core(svc2.stats())

    both(monkeypatch, tmp_path, run)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_replays_across_packages(monkeypatch, tmp_path, writer,
                                         reader):
    """A journal one package's crashed service left is replayed by the
    other's, under the original ids, with the direct verdicts."""
    hists = mixed_histories(4)
    jd = tmp_path / "journal"
    pin_ids(monkeypatch)
    W, R = PKG[writer], PKG[reader]
    svc1 = W.sv.CheckService(journal_dir=jd, **svc_kw(W))
    ids = [svc1.submit(hh, client=f"c{i}").id for i, hh in enumerate(hists)]
    svc2 = R.sv.CheckService(journal_dir=jd, **svc_kw(R))
    assert svc2.recover() == 4
    while svc2.stats()["queue_depth"]:
        svc2.step()
    want = [r["valid?"] for r in direct(R, hists)]
    assert [svc2.get(rid).result["valid?"] for rid in ids] == want
    assert svc2.journal.depth() == 0


def test_continuous_service_coalesces_latecomers():
    """Latecomers join the running ladder (or at worst the next batch)
    in each package: the direct verdicts in at most two launches (the
    grouping follows the threads' timing, so only verdicts are compared
    across packages)."""
    hists = mixed_histories(6)
    verdicts = {}
    for name in ("jax", "port"):
        P = PKG[name]
        want = [r["valid?"] for r in direct(P, hists)]
        svc = P.sv.CheckService(batch_window_s=0, **svc_kw(P))
        futs = [svc.submit(hh) for hh in hists[:3]]
        stepped = threading.Event()

        def run():
            stepped.set()
            while svc.stats()["queue_depth"] or svc.stats()["running"]:
                svc.step()

        th = threading.Thread(target=run)
        th.start()
        assert stepped.wait(5)
        futs += [svc.submit(hh) for hh in hists[3:]]
        th.join(timeout=120)
        assert not th.is_alive()
        got = [f.result(timeout=30)["valid?"] for f in futs]
        assert got == want
        assert svc.stats()["batches"] <= 2
        verdicts[name] = got
    assert verdicts["port"] == verdicts["jax"]
