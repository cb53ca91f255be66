"""The check service's graph lane in the port against the JAX package's:
column-shape-keyed packing of Elle requests (one shared ``check_batch``
per compatibility group), per-request demux, fallback isolation, the
lane's queue-depth gauge and the batch-key contract, on the same small
list-append histories in both packages (the port's service on the CPU).
Host work only: inference and host SCC.  The live-service smoke of
tests/test_serve_graphs.py is marked slow there and has no counterpart
here.
"""

from jepsen_tpu.checker import elle as jelle
from jepsen_tpu.obs import metrics as jmet
from jepsen_tpu.serve import sched as jsched
from jepsen_tpu_torch.checker import elle as telle
from jepsen_tpu_torch.obs import metrics as tmet
from jepsen_tpu_torch.serve import sched as tsched
from test_torch_serve import (  # noqa: F401 — _isolated is autouse here too
    _isolated, both, outcome, stats_core,
)

ELLE = {"jax": jelle, "port": telle}
SCHED = {"jax": jsched, "port": tsched}
METRICS = {"jax": jmet, "port": tmet}


def append_hist(seed, n=8, anomaly=False):
    """tests/test_serve_graphs.py's small list-append history;
    ``anomaly=True`` plants a G1c-style wr cycle."""
    if anomaly:
        txns = [
            (0, [["append", "x", 1], ["r", "y", [2]]]),
            (1, [["append", "y", 2], ["r", "x", [1]]]),
        ]
    else:
        state: list = []
        txns = []
        for i in range(n):
            state = state + [i]
            txns.append((i % 3, [["append", "x", i], ["r", "x", list(state)]]))
    hist = []
    for p, value in txns:
        inv = [[f, k, None if f == "r" else v] for f, k, v in value]
        hist.append({"type": "invoke", "process": p, "f": "txn", "value": inv})
        hist.append({"type": "ok", "process": p, "f": "txn", "value": value})
    for i, op in enumerate(hist):
        op["index"] = i
        op["time"] = i + seed * 1000
    return hist


def _svc(P, **kw):
    return P.sv.CheckService(batch_window_s=0, warm_pool=False, **P.dev, **kw)


def test_closed_service_serves_graphs_inline_without_new_pool(monkeypatch,
                                                              tmp_path):
    def run(P, d):
        svc = _svc(P, max_queue=8)
        fut = svc.submit(append_hist(1), checker=ELLE[P.name].list_append())
        with svc._cond:
            svc._closed = True
        svc._thread = object()
        try:
            svc._step_graphs()
        finally:
            svc._thread = None
        assert svc._graph_pool is None
        return outcome(svc, [fut])

    got = both(monkeypatch, tmp_path, run)
    assert got[0]["valid?"] is True


def test_graph_lane_batches_compatible_requests(monkeypatch, tmp_path):
    hists = [append_hist(s) for s in range(4)] + [append_hist(9, anomaly=True)]

    def run(P, d):
        E = ELLE[P.name]
        calls = {"batch": 0, "sizes": []}
        orig = E.ListAppendChecker.check_batch

        def counting(self, test, histories, opts):
            calls["batch"] += 1
            calls["sizes"].append(len(histories))
            return orig(self, test, histories, opts)

        monkeypatch.setattr(E.ListAppendChecker, "check_batch", counting)
        svc = _svc(P, max_queue=32)
        futs = [svc.submit(hh, checker=E.list_append()) for hh in hists]
        f_other = svc.submit(append_hist(5), checker=E.list_append(
            additional_graphs=["realtime"]))
        depth = svc.stats()["graph_queue_depth"]
        svc.step()
        got = outcome(svc, futs + [f_other])
        types_ = futs[-1].result()["anomaly-types"]
        direct = [E.list_append().check({"name": "direct"}, hh, P.dev)
                  for hh in hists]
        assert [g["valid?"] for g in got[:-1]] == [x["valid?"] for x in direct]
        assert types_ == direct[-1]["anomaly-types"]
        return depth, calls, got, types_, stats_core(svc.stats())

    depth, calls, got, _, st = both(monkeypatch, tmp_path, run, record=True)
    assert depth == 6 and calls == {"batch": 1, "sizes": [5]}
    assert got[4]["valid?"] is False and got[5]["valid?"] is True
    assert st["graphs"] == 6 and st["graph_batches"] >= 1
    assert st["graph_queue_depth"] == 0


def test_graph_batch_key_contract():
    """The same keys in both packages, grouping by checker config (and
    by analyzer identity for CycleChecker); a checker without a
    batch_key is never shared."""
    keys = {}
    for name in ("jax", "port"):
        E, S = ELLE[name], SCHED[name]

        def analyzer(_h):
            return [], [], None

        c1, c2 = E.CycleChecker(analyzer), E.CycleChecker(analyzer)
        assert S.graph_batch_key(c1) == S.graph_batch_key(c2)

        class Bare:
            geometry_batchable = False

            def check(self, test, history, opts):
                return {"valid?": True}

        assert S.graph_batch_key(Bare()) != S.graph_batch_key(Bare())
        ks = [S.graph_batch_key(c) for c in (
            E.list_append(), E.list_append(),
            E.list_append(additional_graphs=["realtime"]), E.wr_register(),
            E.wr_register(linearizable_keys=True),
            E.wr_register(sequential_keys=True))]
        assert ks[0] == ks[1] and len(set(ks[1:])) == 5
        keys[name] = ks + [S.graph_batch_key(c1)[:2]]
    assert keys["port"] == keys["jax"]


def test_graph_batch_failure_falls_back_per_request(monkeypatch, tmp_path):
    def run(P, d):
        class Flaky(ELLE[P.name].ListAppendChecker):
            def check_batch(self, test, histories, opts):
                raise RuntimeError("shared pass exploded")

        svc = _svc(P, max_queue=16)
        chk = Flaky()
        futs = [svc.submit(append_hist(s), checker=chk) for s in range(3)]
        svc.step()
        return outcome(svc, futs), stats_core(svc.stats())

    got, st = both(monkeypatch, tmp_path, run, record=True)
    assert all(g["valid?"] is True for g in got)
    assert st["graph_batches"] == 0


def test_graph_lane_queue_depth_metric(monkeypatch, tmp_path):
    """The graph-lane depth rides the metrics registry as a live gauge,
    rendered alike in both packages."""
    def run(P, d):
        M = METRICS[P.name]
        M.enable_mirror()
        svc = _svc(P, max_queue=16)
        futs = [svc.submit(append_hist(s), checker=ELLE[P.name].list_append())
                for s in range(3)]
        before = M.render()
        svc.step()
        got = outcome(svc, futs)
        after = M.render()
        depth = [ln for t in (before, after) for ln in t.splitlines()
                 if ln.startswith("jepsen_tpu_serve_graph_queue_depth ")]
        return depth, got

    depth, _ = both(monkeypatch, tmp_path, run)
    assert depth == ["jepsen_tpu_serve_graph_queue_depth 3",
                     "jepsen_tpu_serve_graph_queue_depth 0"]
