"""The port's Elle path against the JAX package's.

Graph inference (``checker.txn_graph`` under the "columns" and "loops"
engines, ``checker.txn_columns``), the checkers (``checker.elle``:
``list_append``, ``wr_register``, ``cycle_checker``) under ``check`` and
``check_batch`` with the host and device cycle backends, their ``elle/``
anomaly files, ``independent.checker`` over them, and the port's copies
of ``txn``, the history columns and the transaction generator.

Inputs: the hand-built histories of tests/test_elle.py, the randomized
adversarial histories of tests/test_elle_columns.py (fail/info/nil
values, duplicates, intermediate writes) and the BASELINE config 3
shape in miniature, made from seeds with ``random``.  The port's device
backend runs with ``device="cpu"``.  Tolerance 0: every comparison is of
graphs, anomaly dicts, rendered prose, result dicts or files.  The JAX
checkers set ``"evidence"`` when a store is configured and the port's do
not (ROADMAP C5), so results are compared without that key.
"""

import pathlib
import random
import sys

import numpy as np
import pytest
import torch

from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import txn as jtxn
from jepsen_tpu.checker import elle as je
from jepsen_tpu.checker import txn_columns as jtc
from jepsen_tpu.checker import txn_graph as jtg
from jepsen_tpu.store import format as jfmt
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import txn as ttxn
from jepsen_tpu_torch.checker import elle as te
from jepsen_tpu_torch.checker import txn_columns as ttc
from jepsen_tpu_torch.checker import txn_graph as ttg
from jepsen_tpu_torch.testing import gentxn as tgen
from test_elle_columns import adversarial_append, adversarial_wr

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

import gentxn as jgen  # noqa: E402

CPU = {"device": "cpu"}
BACKENDS = ("host", "device")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    """Both packages' CYCLE_BACKEND set alike, as the JAX tests'
    monkeypatch does."""
    monkeypatch.setattr(je, "CYCLE_BACKEND", request.param)
    monkeypatch.setattr(te, "CYCLE_BACKEND", request.param)
    return request.param


def _strip(res):
    if isinstance(res, dict):
        return {k: _strip(v) for k, v in res.items() if k != "evidence"}
    if isinstance(res, list):
        return [_strip(v) for v in res]
    return res


def txn_hist(*txns):
    """tests/test_elle.py's history constructor: each arg is (process,
    value) or (process, value, type)."""
    hist = []
    for item in txns:
        p, value = item[0], item[1]
        typ = item[2] if len(item) > 2 else "ok"
        invoke_value = [[f, k, None if f == "r" else v] for f, k, v in value]
        hist.append({"type": "invoke", "process": p, "f": "txn", "value": invoke_value})
        hist.append({"type": typ, "process": p, "f": "txn", "value": value})
    for i, op in enumerate(hist):
        op["index"] = i
        op["time"] = i
    return hist


# (name, checker constructor, its kwargs, txns): tests/test_elle.py's
# hand-built histories
CASES = [
    ("append-empty", "list_append", {}, ()),
    ("append-valid", "list_append", {}, (
        (0, [["append", "x", 1]]),
        (1, [["r", "x", [1]], ["append", "x", 2]]),
        (0, [["r", "x", [1, 2]]]))),
    ("append-G0", "list_append", {}, (
        (0, [["append", "x", 1], ["append", "y", 1]]),
        (1, [["append", "x", 2], ["append", "y", 2]]),
        (2, [["r", "x", [1, 2]], ["r", "y", [2, 1]]]))),
    ("append-G1a", "list_append", {}, (
        (0, [["append", "x", 1]], "fail"),
        (1, [["r", "x", [1]]]))),
    ("append-G1b", "list_append", {}, (
        (0, [["append", "x", 1], ["append", "x", 2]]),
        (1, [["r", "x", [1]]]))),
    ("append-G1c", "list_append", {}, (
        (0, [["append", "x", 1], ["r", "y", [2]]]),
        (1, [["append", "y", 2], ["r", "x", [1]]]))),
    ("append-G-single", "list_append", {}, (
        (0, [["r", "x", []], ["r", "y", [2]]]),
        (1, [["append", "x", 1], ["append", "y", 2]]),
        (2, [["r", "x", [1]]]))),
    ("append-G2", "list_append", {}, (
        (0, [["r", "x", []], ["append", "y", 1]]),
        (1, [["r", "y", []], ["append", "x", 1]]),
        (2, [["r", "x", [1]], ["r", "y", [1]]]))),
    ("append-internal", "list_append", {}, (
        (0, [["r", "x", [1]], ["append", "x", 2], ["r", "x", [1, 3]]]),
        (1, [["append", "x", 1]]),
        (2, [["append", "x", 3]]))),
    ("append-internal-ok", "list_append", {}, (
        (0, [["r", "x", [1]], ["append", "x", 2], ["r", "x", [1, 2]]]),
        (1, [["append", "x", 1]]))),
    ("append-duplicates", "list_append", {}, (
        (0, [["append", "x", 1]]),
        (1, [["append", "x", 1]]))),
    ("append-incompatible", "list_append", {}, (
        (0, [["r", "x", [1, 2]]]),
        (1, [["r", "x", [2, 1]]]),
        (2, [["append", "x", 1]]),
        (3, [["append", "x", 2]]))),
    ("append-failed-excluded", "list_append", {}, (
        (0, [["append", "x", 1]], "fail"),
        (1, [["append", "x", 2]]),
        (2, [["r", "x", [2]]]))),
    ("append-info-visible", "list_append", {}, (
        (0, [["append", "x", 1]], "info"),
        (1, [["r", "x", [1]]]))),
    ("append-stale", "list_append", {}, (
        (0, [["append", "x", 1]]),
        (1, [["r", "x", []]]),
        (2, [["r", "x", [1]]]))),
    ("append-stale-realtime", "list_append",
     {"additional_graphs": ["realtime"]}, (
        (0, [["append", "x", 1]]),
        (1, [["r", "x", []]]),
        (2, [["r", "x", [1]]]))),
    ("append-process", "list_append",
     {"additional_graphs": ["process"], "anomalies": ["G1"]}, (
        (0, [["append", "x", 1], ["r", "y", [2]]]),
        (1, [["append", "y", 2], ["r", "x", [1]]]),
        (0, [["r", "x", [1]]]))),
    ("wr-valid", "wr_register", {}, (
        (0, [["w", "x", 1]]),
        (1, [["r", "x", 1]]))),
    ("wr-G1c", "wr_register", {}, (
        (0, [["w", "x", 1], ["r", "y", 2]]),
        (1, [["w", "y", 2], ["r", "x", 1]]))),
    ("wr-G1a", "wr_register", {}, (
        (0, [["w", "x", 1]], "fail"),
        (1, [["r", "x", 1]]))),
    ("wr-G1b", "wr_register", {}, (
        (0, [["w", "x", 1], ["w", "x", 2]]),
        (1, [["r", "x", 1]]))),
    ("wr-internal", "wr_register", {}, (
        (0, [["w", "x", 1], ["r", "x", 2]]),
        (1, [["w", "x", 2]]))),
    ("wr-linearizable-G-single", "wr_register",
     {"linearizable_keys": True, "additional_graphs": ["realtime"]}, (
        (0, [["w", "x", 1]]),
        (1, [["w", "x", 2]]),
        (2, [["r", "x", 1]]))),
    ("wr-sequential", "wr_register", {"sequential_keys": True}, (
        (0, [["w", "x", 1]]),
        (1, [["w", "x", 2]]),
        (2, [["r", "x", 1]]))),
    ("wr-duplicates", "wr_register", {}, (
        (0, [["w", "x", 1]]),
        (1, [["w", "x", 1]]))),
]


def _pair(kind: str, kw: dict):
    return getattr(je, kind)(**kw), getattr(te, kind)(**kw)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_hand_built_histories(case, backend):
    """Each hand-built history: the port's result dict (valid?,
    anomaly-types, anomalies with their rendered cycles, not, also-not,
    provenance) equals the JAX package's, under ``check``."""
    _name, kind, kw, txns = case
    jchk, tchk = _pair(kind, kw)
    hist = txn_hist(*txns)
    want = jchk.check({}, hist, {})
    got = tchk.check({}, hist, CPU)
    assert _strip(got) == _strip(want)
    assert got["provenance"]["engine"]["cycle_backend"] == backend


@pytest.mark.parametrize("kind", ["list_append", "wr_register"])
def test_hand_built_batch(kind, backend):
    """The same histories in one ``check_batch``: equal to the JAX
    package's batch and to the port's per-history checks."""
    cases = [c for c in CASES if c[1] == kind and not c[2]]
    hists = [txn_hist(*c[3]) for c in cases]
    jchk, tchk = _pair(kind, {})
    got = tchk.check_batch({}, hists, CPU)
    assert _strip(got) == _strip(jchk.check_batch({}, hists, {}))
    assert got == [tchk.check({}, hh, CPU) for hh in hists]


def test_device_argument_wins_over_opts(monkeypatch):
    """The checker's own ``device`` is used before ``opts["device"]``;
    with neither, the device backend runs on the card (refused here)."""
    monkeypatch.setattr(te, "CYCLE_BACKEND", "device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hist = txn_hist(*CASES[5][3])
    chk = te.list_append(device="cpu")
    assert chk.check({}, hist, {"device": "cuda"})["valid?"] is False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.list_append().check({}, hist, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.list_append().check_batch({}, [hist], {})
    # the host backend never touches a device
    monkeypatch.setattr(te, "CYCLE_BACKEND", "host")
    assert te.list_append().check({}, hist, {})["valid?"] is False


# ---------------------------------------------------------------------------
# Inference: the two engines of both packages
# ---------------------------------------------------------------------------


def _assert_graphs_equal(a, b):
    """Two TxnGraphs (either package): the same matrices, nodes,
    anomalies in order, edge arrays and rendered explanation of every
    edge."""
    for et in ("ww", "wr", "rw", "extra"):
        np.testing.assert_array_equal(getattr(a, et), getattr(b, et), err_msg=et)
    assert len(a.nodes) == len(b.nodes)
    for x, y in zip(a.nodes, b.nodes):
        assert (x.id, x.op, x.invoke_index, x.complete_index, x.ok) == (
            y.id, y.op, y.invoke_index, y.complete_index, y.ok)
    assert a.anomalies == b.anomalies
    for et in ("ww", "wr", "rw", "extra"):
        np.testing.assert_array_equal(
            np.asarray(a.edge_arrays()[et]).reshape(-1, 2),
            np.asarray(b.edge_arrays()[et]).reshape(-1, 2), err_msg=et)
    for et in ("ww", "wr", "rw"):
        for i, j in np.argwhere(getattr(a, et)):
            assert a.explain(et, int(i), int(j)) == b.explain(et, int(i), int(j))


def _append_graphs(hist, ag=()):
    return [jtg.list_append_graph(hist, ag, engine="columns"),
            jtg.list_append_graph_loops(hist, ag),
            ttg.list_append_graph(hist, ag, engine="columns"),
            ttg.list_append_graph(hist, ag, engine="loops")]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("ag", [(), ("realtime",), ("process",)])
def test_list_append_inference_randomized(seed, ag):
    """Adversarial list-append histories: both engines of the port equal
    both of the JAX package's; the column engine's explanations are
    lazy; the graphs check alike."""
    hist = adversarial_append(35, seed + 17 * len(ag))
    graphs = _append_graphs(hist, ag)
    assert isinstance(graphs[2].explanations, ttc.LazyExplanations)
    for g in graphs[1:]:
        _assert_graphs_equal(graphs[0], g)
    want = je.DEFAULT_ANOMALIES + ["duplicate-elements", "incompatible-order"]
    res = je.check_graph(graphs[0], want)
    assert te.check_graph(graphs[2], want) == res
    assert te.check_graph(graphs[3], want) == res
    assert te.check_graph(graphs[2], want, backend="device", device="cpu") == \
        je.check_graph(graphs[0], want, backend="device")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [{}, {"sequential_keys": True},
                                {"linearizable_keys": True},
                                {"linearizable_keys": True,
                                 "ag": ("realtime", "process")}],
                         ids=["plain", "sequential", "linearizable", "lin-rt-proc"])
def test_rw_register_inference_randomized(seed, kw):
    """Adversarial rw-register histories under each version-order
    assumption: the port's graphs equal the JAX package's."""
    kw = dict(kw)
    ag = kw.pop("ag", ())
    hist = adversarial_wr(35, 200 + seed)
    graphs = [jtg.rw_register_graph(hist, ag, engine="columns", **kw),
              jtg.rw_register_graph_loops(hist, ag, **kw),
              ttg.rw_register_graph(hist, ag, engine="columns", **kw),
              ttg.rw_register_graph(hist, ag, engine="loops", **kw)]
    for g in graphs[1:]:
        _assert_graphs_equal(graphs[0], g)
    want = je.DEFAULT_ANOMALIES + ["duplicate-writes"]
    assert te.check_graph(graphs[2], want) == je.check_graph(graphs[0], want)


@pytest.mark.parametrize("seed", range(3))
def test_config3_shape_in_miniature(seed, backend):
    """gentxn's serializable-by-construction multi-key appends (100
    txns, 6 keys, 8 processes) and the corrupted copy: the port's
    generator gives the tools generator's histories, and the checkers'
    results and graphs are the JAX package's."""
    hist = tgen.append_history(100, n_keys=6, n_procs=8, seed=seed)
    assert hist == jgen.append_history(100, n_keys=6, n_procs=8, seed=seed)
    bad = tgen.corrupt_wr(hist, seed=seed + 1)
    assert bad == jgen.corrupt_wr(hist, seed=seed + 1)
    for hh in (hist, bad):
        _assert_graphs_equal(jtg.list_append_graph(hh, ()),
                             ttg.list_append_graph(hh, ()))
        assert _strip(te.list_append().check({}, hh, CPU)) == _strip(
            je.list_append().check({}, hh, {}))
    assert te.list_append().check({}, hist, CPU)["valid?"] is True


def test_non_int_values_fall_back_to_loops():
    """String elements can't ride int64 columns: the column engine
    refuses, the front door falls back, and both packages agree."""
    hist = []
    t = 0
    for p, el in ((0, "a"), (1, "b")):
        t += 1
        hist.append(th.op(th.INVOKE, p, "txn", [["append", "x", el]], time=t))
        t += 1
        hist.append(th.op("ok", p, "txn", [["append", "x", el]], time=t))
    hist.append(th.op(th.INVOKE, 0, "txn", [["r", "x", None]], time=t + 1))
    hist.append(th.op("ok", 0, "txn", [["r", "x", ["a", "b"]]], time=t + 2))
    hist = th.index(hist)
    with pytest.raises(ttc.NotColumnizable):
        ttc.list_append_graph_columns(hist, ())
    g = ttg.list_append_graph(hist, ())
    assert not isinstance(g.explanations, ttc.LazyExplanations)
    _assert_graphs_equal(jtg.list_append_graph(hist, ()), g)


def test_engine_resolution(monkeypatch):
    """The same env name and resolution as the JAX package."""
    assert ttg.ENGINE_ENV == jtg.ENGINE_ENV == "JEPSEN_TPU_ELLE_ENGINE"
    assert ttg.resolve_engine(None) == "columns"
    monkeypatch.setenv(ttg.ENGINE_ENV, "loops")
    assert ttg.resolve_engine(None) == "loops"
    g = ttg.list_append_graph(adversarial_append(10, 1), ())
    assert not isinstance(g.explanations, ttc.LazyExplanations)
    with pytest.raises(ValueError):
        ttg.resolve_engine("quantum")
    assert te.list_append()._prov_engine() == je.list_append()._prov_engine()


# ---------------------------------------------------------------------------
# Column histories
# ---------------------------------------------------------------------------


def _stored(tmp_path, hist):
    """A history through the JAX store's .jepsen file, as both packages'
    ColumnHistory."""
    f = tmp_path / "run.jepsen"
    w = jfmt.Writer(f)
    w.write_test({"name": "t", "start-time-str": "s"})
    w.write_history(hist)
    w.write_results({"valid?": True})
    w.close()
    cols, fs, extras = jfmt.read_columns(f)
    return jh.ColumnHistory(cols, fs, extras), th.ColumnHistory(cols, fs, extras)


@pytest.mark.parametrize("seed", range(3))
def test_column_history_inference(tmp_path, seed):
    """Inference straight off stored columns: the port's ColumnHistory
    materializes the JAX package's ops, its column engine builds no op
    dict in bulk, and the graphs equal the JAX package's."""
    hist = adversarial_append(40, 7 + seed)
    jch, tch = _stored(tmp_path, hist)
    assert th.index(tch) is tch
    g = ttg.list_append_graph(tch, (), engine="columns")
    assert tch._complete is False
    _assert_graphs_equal(jtg.list_append_graph(jch, (), engine="columns"), g)
    _assert_graphs_equal(jtg.list_append_graph_loops(hist, ()), g)
    assert tch.materialized() == jch.materialized()
    assert th.materialize(tch) == jch.materialized()
    assert tch[3] == jch[3] and tch[-1] == jch[-1] and tch[1:4] == jch[1:4]
    assert tch == jch.materialized() and repr(tch) == repr(jch)


def test_column_history_negative_client_pid(tmp_path):
    """Only the nemesis's -1 maps back to "nemesis": a client of pid -2
    keeps its transactions (and the wr edge) in both packages."""
    hist = [
        {"type": "invoke", "process": -2, "f": "txn", "value": [["append", 0, 1]]},
        {"type": "ok", "process": -2, "f": "txn", "value": [["append", 0, 1]]},
        {"type": "invoke", "process": 3, "f": "txn", "value": [["r", 0, None]]},
        {"type": "ok", "process": 3, "f": "txn", "value": [["r", 0, [1]]]},
    ]
    for i, o in enumerate(hist):
        o["index"] = o["time"] = i
    jch, tch = _stored(tmp_path, hist)
    g = ttc.list_append_graph_columns(tch, ())
    assert g.n == 2 and g.wr.sum() == 1
    _assert_graphs_equal(jtc.list_append_graph_columns(jch, ()), g)


@pytest.mark.parametrize("seed", range(4))
def test_pair_index_codes_and_nodes(seed):
    """The vectorized pairing equals ``history.pair_index`` of both
    packages on histories with nemesis ops and orphan invokes, and a
    caller's pair index threads through ``txn_nodes``."""
    hist = adversarial_append(30, 300 + seed)
    rng = random.Random(seed)
    for o in (th.op(th.INVOKE, th.NEMESIS, "kill", None),
              th.op("info", th.NEMESIS, "kill", None),
              th.op(th.INVOKE, 99, "txn", [["r", 0, None]])):
        hist.insert(rng.randrange(len(hist)), o)
    hist = th.index([dict(o) for o in hist])
    want = jh.pair_index(hist)
    np.testing.assert_array_equal(th.pair_index(hist), want)
    np.testing.assert_array_equal(ttc.NodeColumns(hist).pair,
                                  np.asarray(want, np.int64))
    a = ttg.txn_nodes(hist, th.pair_index(hist))
    b = jtg.txn_nodes(hist)
    assert [(x.op, x.invoke_index, x.ok) for x in a] == [
        (y.op, y.invoke_index, y.ok) for y in b]


# ---------------------------------------------------------------------------
# Witness recovery, the lattice and the generic cycle checker
# ---------------------------------------------------------------------------


def _bare_graphs(n, anomalies=None):
    """An edgeless n-node graph in each package."""
    z = np.zeros((n, n), bool)
    ops = [th.op(th.OK, p, "txn", []) for p in range(n)]
    return tuple(
        m.TxnGraph(nodes=[m.TxnNode(i, ops[i], i, i, True) for i in range(n)],
                   ww=z, wr=z, rw=z, extra=z, explanations={},
                   anomalies=dict(anomalies or {}))
        for m in (jtg, ttg))


_NO_HINTS = {"G0": None, "G1c": None, "G-single": None, "G2": None}


@pytest.mark.parametrize("flags,hints,anomalies,requested", [
    ({"G1c": True}, {}, None, ["G2"]),
    ({"G1c": True}, {"G1c": (0, 1)}, None, ["G2"]),
    ({"G1c": True}, {}, {"G1a": [{"op": {"type": "ok"}}]}, ["G2", "G1a"]),
    ({"G0": True}, {"G0": (1, 1)}, None, ["G2", "G1"]),
    ({"G2": True, "G-single": True}, {"G2": (0, 2)}, None, ["G2"]),
], ids=["no-hint", "no-return-path", "with-g1a", "stale-g0", "gated-g2"])
def test_unwitnessed_flags_never_clean_true(flags, hints, anomalies, requested):
    """A flag without a recoverable witness surfaces as unknown (or with
    the inference anomaly, False) with ``unwitnessed-flags``: the same
    result in both packages."""
    f = {"G0": False, "G1c": False, "G-single": False, "G2": False, **flags}
    hs = {**_NO_HINTS, **hints}
    jg, tg_ = _bare_graphs(3, anomalies)
    got = te._merge_flags(tg_, f, hs, requested)
    assert got == je._merge_flags(jg, f, hs, requested)
    assert got["valid?"] is not True


def test_consistency_lattice():
    """The model lattice and every anomaly's ruled-out models, and the
    expansion of each requested anomaly, equal the JAX package's."""
    assert te._STRONGER_DIRECT == je._STRONGER_DIRECT
    assert te.STRONGER_MODELS == je.STRONGER_MODELS
    assert te.ANOMALY_RULES_OUT == je.ANOMALY_RULES_OUT
    names = sorted(je.ANOMALY_RULES_OUT)
    rng = random.Random(0)
    for k in range(len(names) + 1):
        types = rng.sample(names, k)
        assert te.models_ruled_out(types) == je.models_ruled_out(types)
    for req in (["G2"], ["G1"], ["G-single", "internal"], ["G1c"], ["x"]):
        assert te.expand_anomalies(req) == je.expand_anomalies(req)


def _nodes(n):
    return [th.op(th.OK, i, "txn", i, index=i) for i in range(n)]


def _edge_analyzer(nodes, edges):
    def analyzer(_history):
        return (nodes, [(a, b, "dep") for a, b in edges],
                lambda a, b, r: f"{r}: {a}->{b}")
    return analyzer


def _matrix_analyzer(_history):
    nodes = _nodes(3)
    ww = np.zeros((3, 3), bool)
    ww[0, 1] = ww[1, 2] = True
    rt = np.zeros((3, 3), bool)
    rt[2, 0] = True
    return nodes, {"ww": ww, "rt": rt}, None


_N_BIG = 1024 + 5
CYCLE_CASES = {
    "acyclic": _edge_analyzer(_nodes(4), [(0, 1), (1, 2), (2, 3)]),
    "cycle": _edge_analyzer(_nodes(4), [(0, 1), (1, 2), (2, 0)]),
    "self-loop": _edge_analyzer(_nodes(3), [(0, 1), (2, 2)]),
    "over-threshold": _edge_analyzer(
        _nodes(_N_BIG), [(i, i + 1) for i in range(_N_BIG - 1)] + [(_N_BIG - 1, 0)]),
    "matrix": _matrix_analyzer,
    "bare-matrix": lambda _h: (_nodes(3), np.eye(3, k=1, dtype=bool) | np.eye(3, k=-2, dtype=bool), None),
    "empty": lambda _h: ([], [], None),
}


@pytest.mark.parametrize("name", sorted(CYCLE_CASES))
@pytest.mark.parametrize("pin", BACKENDS)
def test_cycle_checker(name, pin):
    """``cycle_checker`` on edge-list, matrix and bare-matrix analyzers,
    a self-loop, an empty graph and a ring over SCC_THRESHOLD (always
    host): the result equals the JAX package's under each pinned
    backend, and the module default stays "host"."""
    analyzer = CYCLE_CASES[name]
    want = je.cycle_checker(analyzer, backend=pin).check({}, [], {})
    got = te.cycle_checker(analyzer, backend=pin, device="cpu").check({}, [], {})
    assert _strip(got) == _strip(want)
    assert te.CYCLE_BACKEND == "host"
    many = te.CycleChecker(analyzer, backend=pin).check_batch({}, [[], []], CPU)
    assert many == [got, got]


def test_cycle_checker_refuses_unknown_backend():
    with pytest.raises(ValueError):
        te.CycleChecker(lambda _h: ([], [], None), backend="quantum")
    with pytest.raises(ValueError):
        te.check_graph(_bare_graphs(2)[1], ["G2"], backend="quantum")


def test_cycle_checker_unwitnessed_flag_is_unknown(monkeypatch):
    """A flag without a witness answers unknown, never True."""
    nodes = _nodes(3)
    analyzer = (lambda _h: (nodes, np.zeros((3, 3), bool), None))
    for mod in (je, te):
        monkeypatch.setattr(mod.CycleChecker, "_find_cycle",
                            staticmethod(lambda *a, **k: (True, None)))
    got = te.cycle_checker(analyzer).check({}, [], CPU)
    assert got["valid?"] == "unknown" and got["unwitnessed-flags"] == ["cycle"]
    assert _strip(got) == _strip(je.cycle_checker(analyzer).check({}, [], {}))


@pytest.mark.parametrize("pin", BACKENDS)
def test_realtime_analyzer(pin):
    """The built-in realtime analyzer on a real history: the same nodes,
    relation and prose as the JAX package's, and an acyclic verdict (a
    realtime order is an interval order: it has no cycle)."""
    rng = random.Random(4)
    ops = []
    for i in range(12):
        p = rng.randrange(3)
        ops.append(th.op(th.INVOKE, p, "w", i, time=2 * i))
        ops.append(th.op(rng.choice([th.OK, th.OK, th.INFO]), p, "w", i, time=2 * i + 1))
    hist = th.index(ops)
    tn, trel, tex = te.realtime_analyzer(hist)
    jn, jrel, jex = je.realtime_analyzer(hist)
    assert tn == jn
    np.testing.assert_array_equal(trel["realtime"], jrel["realtime"])
    assert tex(0, 1, "realtime") == jex(0, 1, "realtime")
    got = te.cycle_checker(te.realtime_analyzer, backend=pin).check({}, hist, CPU)
    assert got["valid?"] is True
    assert _strip(got) == _strip(
        je.cycle_checker(je.realtime_analyzer, backend=pin).check({}, hist, {}))


# ---------------------------------------------------------------------------
# elle/ files and independent.checker
# ---------------------------------------------------------------------------


def _tree(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_text()
            for p in sorted(root.rglob("*.txt"))}


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in (
    "append-G0", "append-G1a", "append-G1c", "append-G2", "append-internal",
    "append-incompatible", "wr-G1b", "wr-linearizable-G-single",
    "wr-duplicates")], ids=lambda c: c[0])
def test_anomaly_files(tmp_path, case, backend):
    """With a store configured, the port writes the JAX package's elle/
    files, byte for byte."""
    _name, kind, kw, txns = case
    jchk, tchk = _pair(kind, kw)
    hist = txn_hist(*txns)
    jtest = {"name": "e", "start-time-str": "t", "store-dir": str(tmp_path / "j")}
    ttest = {**jtest, "store-dir": str(tmp_path / "t")}
    want = jchk.check(jtest, hist, {})
    got = tchk.check(ttest, hist, CPU)
    assert _strip(got) == _strip(want)
    jdir = tmp_path / "j" / "e" / "t" / "elle"
    tdir = tmp_path / "t" / "e" / "t" / "elle"
    assert tdir.is_dir() and _tree(tdir) == _tree(jdir)
    assert te.render_anomaly("x", {"a": 1}) == je.render_anomaly("x", {"a": 1})
    assert te.render_anomaly("x", 5) == je.render_anomaly("x", 5)


def _keyed(hists, tuple_):
    out = []
    t = 0
    for k, hh in enumerate(hists):
        for op in hh:
            op = dict(op)
            op["value"] = tuple_(k, op["value"])
            op["time"] = (t := t + 1)
            out.append(op)
    return th.index(out)


def test_independent_checker_reaches_check_batch(tmp_path, backend):
    """``independent.checker(list_append())`` hands every key to one
    ``check_batch`` call, which returns; the per-key results and elle/
    files equal the JAX package's."""
    subs = [txn_hist(*c[3]) for c in CASES if c[1] == "list_append" and not c[2]]
    calls = {"batch": 0, "returned": 0}
    inner = te.list_append()
    orig = inner.check_batch

    def counting(test, histories, opts):
        calls["batch"] += 1
        out = orig(test, histories, opts)
        calls["returned"] += 1
        return out

    inner.check_batch = counting
    jtest = {"name": "i", "start-time-str": "t", "store-dir": str(tmp_path / "j")}
    ttest = {**jtest, "store-dir": str(tmp_path / "t")}
    want = jind.checker(je.list_append()).check(jtest, _keyed(subs, jind.tuple_), {})
    got = tind.checker(inner).check(ttest, _keyed(subs, tind.tuple_), CPU)
    assert calls == {"batch": 1, "returned": 1}
    assert got["valid?"] is False
    assert _strip(got) == _strip(want)
    jdir, tdir = tmp_path / "j" / "i" / "t", tmp_path / "t" / "i" / "t"
    assert _tree(tdir) == _tree(jdir)
    assert any(p.endswith("G1c.txt") for p in _tree(tdir))


def test_per_key_batch_device_equals_host(monkeypatch):
    """The 3c shape in miniature (16 per-key histories of 48
    transactions over 3 keys and 8 processes, seeds 1000+i): one
    check_batch on the device backend equals the host backend's, the
    JAX package's, and the per-history checks; the batch is one
    classification of one 128-node bucket."""
    from jepsen_tpu_torch.ops import closure as tcl

    hists = [tgen.append_history(48, n_keys=3, n_procs=8, seed=1000 + i)
             for i in range(16)]
    host = te.list_append().check_batch({}, hists, CPU)
    monkeypatch.setattr(te, "CYCLE_BACKEND", "device")
    monkeypatch.setattr(je, "CYCLE_BACKEND", "device")
    tcl.reset_counts()
    dev = te.list_append().check_batch({}, hists, CPU)
    assert tcl.BUCKET_LAUNCHES == {128: 1}
    strip_backend = lambda rs: [{k: v for k, v in r.items() if k != "provenance"}
                                for r in rs]
    assert strip_backend(dev) == strip_backend(host)
    assert all(r["valid?"] is True for r in dev)
    assert _strip(dev) == _strip(je.list_append().check_batch({}, hists, {}))
    bad = [tgen.corrupt_wr(hh, seed=6) for hh in hists[:4]]
    got = te.list_append().check_batch({}, bad, CPU)
    assert _strip(got) == _strip(je.list_append().check_batch({}, bad, {}))
    assert got == [te.list_append().check({}, hh, CPU) for hh in bad]


# ---------------------------------------------------------------------------
# The host copies: txn, history columns, gentxn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_txn_folds_match(seed):
    """``txn``'s generators and folds give the JAX package's outputs."""
    tg_, jg_ = (ttxn.wr_txns(random.Random(seed), key_count=3),
                jtxn.wr_txns(random.Random(seed), key_count=3))
    ta, ja = (ttxn.append_txns(random.Random(seed)),
              jtxn.append_txns(random.Random(seed)))
    for _ in range(60):
        t1, j1 = next(tg_), next(jg_)
        assert t1 == j1 and next(ta) == next(ja)
        txn = [[f, k, v if f != "r" else rng_v] for (f, k, v), rng_v in
               zip(t1, range(len(t1)))]
        for fn in ("ext_reads", "ext_writes", "int_write_mops"):
            assert getattr(ttxn, fn)(txn) == getattr(jtxn, fn)(txn)
    hist = txn_hist(*CASES[8][3])
    assert list(ttxn.op_mops(hist)) == list(jtxn.op_mops(hist))
    count = lambda s, _o, m: s + (1 if ttxn.is_read(m) else 0)
    assert ttxn.reduce_mops(count, 0, hist) == jtxn.reduce_mops(count, 0, hist)


def test_history_additions_match():
    """``decode_register_value`` and the packed type codes."""
    nil = int(th.NIL)
    for v1, v2 in ((nil, nil), (3, nil), (nil, 4), (5, 6), (-7, nil)):
        assert th.decode_register_value(None, v1, v2) == \
            jh.decode_register_value(None, v1, v2)
    assert th.TYPE_CODES == jh.TYPE_CODES and th.NEMESIS_PID == jh.NEMESIS_PID
    plain = [th.op(th.OK, 0, "txn", [])]
    assert th.materialize(plain) is plain


@pytest.mark.parametrize("seed", range(3))
def test_gentxn_matches_tools(seed):
    """``testing.gentxn`` gives tools/gentxn.py's histories and Tarjan
    verdicts, at BASELINE config 3's per-key and multi-key shapes."""
    for n, keys, procs in ((48, 3, 8), (200, 50, 16)):
        hist = tgen.append_history(n, n_keys=keys, n_procs=procs, seed=seed)
        assert hist == jgen.append_history(n, n_keys=keys, n_procs=procs, seed=seed)
        assert tgen.corrupt_wr(hist, seed=6) == jgen.corrupt_wr(hist, seed=6)
    rng = random.Random(seed)
    for _ in range(20):
        n = rng.randrange(1, 12)
        edges = [(rng.randrange(n), rng.randrange(n)) for _ in range(rng.randrange(15))]
        assert tgen.tarjan_has_cycle(n, edges) == jgen.tarjan_has_cycle(n, edges)
