"""The port's checker front end against the JAX package's.

The checker protocol (``checker``), the CPU oracles of ``wgl_cpu`` (the
DFS, the greedy walk with its recorded witness, the brute-force
enumerator), ``linear_svg``, the in-memory provenance (fingerprints,
``attach``, bundle digests), the linearizable checker under its four
algorithms, and ``independent.checker`` with its batch path and its
per-key fallback.  The inputs are the suite's shared shapes, made from a
seed: ``(30, 3)`` CAS-register histories (every third corrupted) at
capacity ``(64, 256)`` and the 4-key ``(16, 2)`` history of
tests/test_parallel.py.  The port runs with ``"device": "cpu"`` (its
plain kernel versions).  Tolerance 0 everywhere: the outputs compared
are verdicts, ops, strings and sha256 digests.

The services the checkers pass to the engines (a deadline, the ladder's
checkpoints and resume, stream checkpoints) give the JAX package's
verdicts, causes and checkpoint cursors.
"""

import dataclasses
import json
import random

import pytest
import torch

from jepsen_tpu import checker as jc
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jm
from jepsen_tpu.checker import linear_svg as jsvg
from jepsen_tpu.checker import linearizable as jlin
from jepsen_tpu.checker import wgl_cpu as jcpu
from jepsen_tpu.obs import provenance as jprov
from jepsen_tpu_torch import checker as tc
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import linear_svg as tsvg
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import wgl_cpu as tcpu
from jepsen_tpu_torch.obs import provenance as tprov
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history

CAP = (64, 256)
ALGORITHMS = ("wgl", "sweep", "tpu", "competition")
#: the decision-path events the competition records itself
COMPETITION_EVENTS = {"fault.deadline", "engine.greedy", "cpu-fallback",
                      "async.capacity", "confirm.sweep", "engine.dfs",
                      "route.chunked-exact"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each."""
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


def keyed_history(ind):
    """tests/test_parallel.py's 4-key history: (16, 2) histories of keys
    0-3, key 2 corrupted, values wrapped with ``ind.tuple_``."""
    hist = []
    t = 0
    for k in range(4):
        sub = valid_register_history(16, 2, seed=k, info_rate=0.1)
        if k == 2:
            sub = corrupt(sub, seed=k)
        for o in sub:
            o = dict(o)
            o["value"] = ind.tuple_(k, o["value"])
            o["time"] = (t := t + 1)
            hist.append(o)
    return jh.index(hist)


def _norm(x):
    """Results with each package's model objects as (name, fields), so
    that the two packages' results compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _norm(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, frozenset):
        return sorted(x)
    return x


# ---------------------------------------------------------------------------
# wgl_cpu: the DFS, the greedy walk with its witness, the brute oracle
# ---------------------------------------------------------------------------


def _wgl_cases() -> dict:
    """The hand-written histories of tests/test_wgl_cpu.py (model name,
    ops), its random brute-force and crash-heavy histories (a sample),
    and mixed_histories(6)."""
    I, O, F, N = "invoke", "ok", "fail", "info"
    cases = {
        "empty": ("cas", []),
        "sequential-rw": ("cas", [(I, 0, "write", 1), (O, 0, "write", 1),
                                  (I, 0, "read", None), (O, 0, "read", 1)]),
        "stale-read": ("cas", [(I, 0, "write", 1), (O, 0, "write", 1),
                               (I, 0, "write", 2), (O, 0, "write", 2),
                               (I, 1, "read", None), (O, 1, "read", 1)]),
        "concurrent-read": ("cas", [(I, 0, "write", 1), (O, 0, "write", 1),
                                    (I, 0, "write", 2), (I, 1, "read", None),
                                    (O, 1, "read", 2), (O, 0, "write", 2)]),
        "failed-op": ("cas", [(I, 0, "write", 1), (O, 0, "write", 1),
                              (I, 0, "write", 9), (F, 0, "write", 9),
                              (I, 1, "read", None), (O, 1, "read", 9)]),
        "info-op": ("cas", [(I, 0, "write", 1), (O, 0, "write", 1),
                            (I, 0, "write", 9), (N, 0, "write", 9),
                            (I, 1, "read", None), (O, 1, "read", 9)]),
        "info-late": ("cas", [(I, 0, "write", 9), (N, 0, "write", 9),
                              (I, 1, "write", 1), (O, 1, "write", 1),
                              (I, 1, "read", None), (O, 1, "read", 9)]),
        "cas": ("cas", [(I, 0, "write", 0), (O, 0, "write", 0),
                        (I, 1, "cas", [0, 5]), (O, 1, "cas", [0, 5]),
                        (I, 0, "read", None), (O, 0, "read", 5)]),
        "cas-bad": ("cas", [(I, 0, "write", 1), (O, 0, "write", 1),
                            (I, 1, "cas", [0, 5]), (O, 1, "cas", [0, 5])]),
        "mutex-double-acquire": ("mutex", [(I, 0, "acquire", None),
                                           (O, 0, "acquire", None),
                                           (I, 1, "acquire", None),
                                           (O, 1, "acquire", None)]),
    }
    rng = random.Random(45100)
    for trial in range(12):
        hist, live = [], {}
        while len(hist) < 16:
            p = rng.randrange(3)
            if p in live:
                f, v = live.pop(p)
                outcome = rng.choice([O, O, F, N])
                if f == "read":
                    v = rng.randrange(3) if outcome == O else None
                hist.append((outcome, p, f, v))
            else:
                f = rng.choice(["read", "write", "cas"])
                v = (None if f == "read" else rng.randrange(3) if f == "write"
                     else [rng.randrange(3), rng.randrange(3)])
                live[p] = (f, v)
                hist.append((I, p, f, v))
        cases[f"random-{trial}"] = ("cas", hist)
    rng = random.Random(20260731)
    for trial in range(8):
        hist, live, n_ops = [], {}, 0
        while n_ops < 9:
            p = rng.randrange(4)
            if p in live:
                f, v = live.pop(p)
                outcome = rng.choice([O, N, N, F])
                if f == "read":
                    v = rng.randrange(2) if outcome == O else None
                hist.append((outcome, p, f, v))
            else:
                f = rng.choice(["read", "write", "write"])
                v = None if f == "read" else rng.randrange(2)
                live[p] = (f, v)
                hist.append((I, p, f, v))
                n_ops += 1
        cases[f"crash-heavy-{trial}"] = ("cas", hist)
    for i, hist in enumerate(mixed_histories(6)):
        cases[f"mixed-{i}"] = ("cas", hist)
    return cases


WGL_CASES = _wgl_cases()


def _wgl_case(name):
    model, ops = WGL_CASES[name]
    if ops and isinstance(ops[0], dict):
        hist = ops
    else:
        hist = jh.index([jh.op(*o) for o in ops])
    models = ((jm.CASRegister(None), tm.CASRegister(None)) if model == "cas"
              else (jm.Mutex(), tm.Mutex()))
    return hist, models


@pytest.mark.parametrize("case", sorted(WGL_CASES))
def test_wgl_cpu_engines_match_jax(case):
    """dfs_analysis, greedy_walk with its recorded witness, and
    brute_analysis give the JAX package's results."""
    hist, (jmod, tmod) = _wgl_case(case)
    assert _norm(tcpu.dfs_analysis(tmod, hist)) == _norm(jcpu.dfs_analysis(jmod, hist))
    assert tcpu.analysis is tcpu.dfs_analysis
    jrec, trec = [], []
    assert tcpu.greedy_walk(tmod, hist, record=trec) == jcpu.greedy_walk(
        jmod, hist, record=jrec)
    assert trec == jrec
    assert tcpu.greedy_walk(tmod, hist, max_steps=3) == jcpu.greedy_walk(
        jmod, hist, max_steps=3)
    assert tcpu.brute_analysis(tmod, hist) == jcpu.brute_analysis(jmod, hist)


def test_dfs_budget_unknown_matches_jax():
    """Past ``max_visited`` both DFS engines answer the same unknown."""
    hist = []
    for p in range(12):
        hist += [jh.op("invoke", p, "write", p), jh.op("info", p, "write", p)]
    hist = jh.index(hist + [jh.op("invoke", 50, "read", None),
                            jh.op("ok", 50, "read", 5)])
    want = jcpu.dfs_analysis(jm.CASRegister(None), hist, max_visited=3)
    got = tcpu.dfs_analysis(tm.CASRegister(None), hist, max_visited=3)
    assert got["valid?"] == "unknown" and _norm(got) == _norm(want)


# ---------------------------------------------------------------------------
# The protocol: tests/test_checker_core.py's cases, both packages
# ---------------------------------------------------------------------------


def _merge_valid(c, h):
    out = [c.merge_valid([]), c.merge_valid([True, True]),
           c.merge_valid([True, c.UNKNOWN]), c.merge_valid([c.UNKNOWN, False]),
           c.merge_valid([False, True])]
    try:
        c.merge_valid([None])
    except ValueError:
        out.append("ValueError")
    return out


def _check_safe_wraps(c, h):
    class Boom(c.Checker):
        def check(self, test, history, opts):
            raise RuntimeError("kaboom")

    r = c.check_safe(Boom(), {}, [])
    return {**r, "error": "kaboom" in r["error"]}


def _check_safe_none(c, h):
    return c.check_safe(c.noop(), {}, [])


def _compose(c, h):
    r = c.compose({"a": c.unbridled_optimism(),
                   "b": c.unbridled_optimism()}).check({}, [], {})

    class Nope(c.Checker):
        def check(self, test, history, opts):
            return {"valid?": False, "why": "because"}

    r2 = c.compose({"good": c.unbridled_optimism(), "bad": Nope()}).check({}, [], {})
    return [r, r2]


def _compose_contains(c, h):
    class Boom(c.Checker):
        def check(self, test, history, opts):
            raise ValueError("x")

    r = c.compose({"boom": Boom(), "ok": c.unbridled_optimism()}).check({}, [], {})
    r["boom"]["error"] = r["boom"]["error"].splitlines()[-1]
    return r


def _concurrency_limit(c, h):
    return c.concurrency_limit(2, c.unbridled_optimism()).check({}, [], {})


def _stats(c, h):
    hist = [
        h.op(h.INVOKE, 0, "read", None), h.op(h.OK, 0, "read", 1),
        h.op(h.INVOKE, 1, "write", 2), h.op(h.FAIL, 1, "write", 2),
        h.op(h.INFO, h.NEMESIS, "start", None),
    ]
    return c.stats().check({}, hist, {})


def _unhandled(c, h):
    err = {"class": "TimeoutException", "message": "too slow"}
    hist = [
        h.op(h.INFO, 0, "read", None, exception=err),
        h.op(h.INFO, 1, "read", None, exception=err),
        h.op(h.OK, 2, "read", 1),
        h.op(h.INFO, 3, "write", 1, exception=KeyError("k")),
    ]
    r = c.unhandled_exceptions().check({}, hist, {})
    return [r, c.unhandled_exceptions().check({}, [], {})]


def _names(c, h):
    @c.checker
    def my_check(test, history, opts):
        return {"valid?": True, "n": len(history)}

    return [c.checker_name(my_check), repr(my_check), my_check({}, [1, 2]),
            c.checker_name(c.stats()), c.checker_name(c.FnChecker(len, "ln"))]


def _resolve_opts(c, h):
    unset = c.resolve_opts({"x": 1})
    budget = c.resolve_opts({"check-deadline": 5})
    kept = c.resolve_opts({"deadline": budget["deadline"]})
    return [unset, type(budget["deadline"]).__name__, budget["deadline"].seconds,
            kept["deadline"] is budget["deadline"],
            c.resolve_opts({"deadline": 2.5})["deadline"].seconds,
            c.resolve_opts(None)]


def _compose_shares_deadline(c, h):
    seen = []

    class Look(c.Checker):
        def check(self, test, history, opts):
            seen.append(opts["deadline"])
            return {"valid?": True}

    c.compose({"a": Look(), "b": Look()}).check({}, [], {"check-deadline": 9})
    return [len(seen), seen[0] is seen[1], seen[0].seconds]


PROTOCOL_CASES = {f.__name__.strip("_"): f for f in (
    _merge_valid, _check_safe_wraps, _check_safe_none, _compose,
    _compose_contains, _concurrency_limit, _stats, _unhandled, _names,
    _resolve_opts, _compose_shares_deadline)}


@pytest.mark.parametrize("case", sorted(PROTOCOL_CASES))
def test_protocol_matches_jax(case):
    fn = PROTOCOL_CASES[case]
    got = fn(tc, th)
    want = fn(jc, jh)
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        want, sort_keys=True, default=str)


@pytest.mark.parametrize("i", [2, 5, 0])
def test_linear_svg_matches_jax(i):
    """render_failure gives the JAX package's text for the op the sweep
    refutes at (or none), with and without a cause."""
    hist = mixed_histories(6)[i]
    op = jcpu.sweep_analysis(jm.CASRegister(None), hist).get("op")
    for cause, window in (("", 24), ("a <cause> & more", 6)):
        assert tsvg.render_failure(hist, op, cause, window) == jsvg.render_failure(
            hist, op, cause, window)
    assert tsvg.render_failure([], None) == jsvg.render_failure([], None)


def test_linear_svg_written_on_failure(tmp_path):
    """A failed check renders linear.svg into the test's store directory
    (tests/test_checker_core.py's case), with the JAX package's text."""
    hist = jh.index([
        jh.op("invoke", 0, "write", 1, time=10), jh.op("ok", 0, "write", 1, time=20),
        jh.op("invoke", 1, "read", None, time=30), jh.op("ok", 1, "read", 99, time=40),
    ])
    svgs = []
    for pkg, lin, model in (("jax", jlin, jm.CASRegister(None)),
                            ("port", tlin, tm.CASRegister(None))):
        t = {"name": "linsvg", "start-time-str": pkg, "store-dir": str(tmp_path)}
        res = lin.linearizable({"model": model, "device": "cpu"} if pkg == "port"
                               else {"model": model}).check(t, hist, {})
        assert res["valid?"] is False
        path = tmp_path / "linsvg" / pkg / "linear.svg"
        assert res["svg"] == str(path)
        svgs.append(path.read_text())
    assert svgs[1] == svgs[0]
    assert svgs[1].startswith("<svg") and "#D0021B" in svgs[1]


# ---------------------------------------------------------------------------
# Provenance: fingerprints, attach, bundle digests
# ---------------------------------------------------------------------------


def test_history_fingerprint_matches_jax():
    hists = mixed_histories(6) + [keyed_history(tind), [], [
        jh.op("info", "nemesis", "start", ("a", 1)), jh.op("invoke", 0, "cas", (1, 2))]]
    for hh in hists:
        assert tprov.history_fingerprint(hh) == jprov.history_fingerprint(hh)


ATTACH_CASES = {
    "reattach-same-path": [dict(path=[{"event": "a"}], engine={"engine": "x"})] * 3,
    "prepend-outer": [dict(path=[{"event": "inner", "n": 1}],
                           engine={"engine": "inner"}, config={"c": 1}),
                      dict(path=[{"event": "outer"}], engine={"engine": "outer",
                                                             "k": 2})],
    "grow-prefix": [dict(path=[{"event": "a"}]),
                    dict(path=[{"event": "a"}, {"event": "b"}]),
                    dict(path=[{"event": "a"}, {"event": "b"}])],
    "dedupe-shared": [dict(path=[{"event": "a"}, {"event": "b"}]),
                      dict(path=[{"event": "b"}, {"event": "c"}])],
    "truncate": [dict(path=[{"event": "e", "i": i} for i in range(200)])],
    "empty": [dict(), dict(config={"fast": True})],
}


@pytest.mark.parametrize("case", sorted(ATTACH_CASES))
def test_attach_matches_jax(case):
    """attach's idempotence, prepending, fill-only-missing and truncation
    give the JAX package's provenance blocks."""
    results = []
    for prov in (jprov, tprov):
        res = {"valid?": True}
        for kw in ATTACH_CASES[case]:
            assert prov.attach(res, **kw) is res
        results.append(res)
    assert results[1] == results[0]
    rec_j, rec_t = jprov.PathRecorder(), tprov.PathRecorder()
    for r in (rec_j, rec_t):
        for i in range(tprov.MAX_PATH + 3):
            r.add("ev", i=i)
    assert rec_t.entries == rec_j.entries and len(rec_t.entries) == tprov.MAX_PATH


def _bundle_results(hist, i):
    op = hist[7]
    return [
        {"valid?": True},
        {"valid?": False, "op": op, "kernel": {"launches": 3, "bar-opid": 7}},
        {"valid?": "unknown", "cause": "budget; resumable checkpoint: /x"},
        {"valid?": True, "provenance": {
            "path": [{"event": "engine.greedy", "seconds": 0.1 * i,
                      "outcome": "valid"}],
            "engine": {"engine": "greedy", "lanes": 8},
            "config": {"capacity": [64, 256], "fingerprint": "f", "rounds": 8}}},
    ]


@pytest.mark.parametrize("i", range(6))
def test_bundle_digest_matches_jax(i):
    """build_bundle's digest (witness walk included) and bundle_digest of
    a payload are the JAX package's, byte for byte."""
    hist = mixed_histories(6)[i]
    for res in _bundle_results(hist, i):
        kw = dict(history=hist, result=res, source="check", checker="linearizable",
                  bundle_id="b", extra_path=[{"event": "serve.admit", "id": 3}])
        bj = jprov.build_bundle(model=jm.CASRegister(None), **kw)
        bt = tprov.build_bundle(model=tm.CASRegister(None), **kw)
        assert bt["digest"] == bj["digest"]
        assert json.dumps(bt["witness"], default=str) == json.dumps(
            bj["witness"], default=str)
        assert tprov.bundle_digest(bt) == jprov.bundle_digest(bj)
    assert tprov.verdict_str(None) == jprov.verdict_str(None) == "unknown"
    assert "python" in tprov.machine_fingerprint()


# ---------------------------------------------------------------------------
# The linearizable checker, its four algorithms
# ---------------------------------------------------------------------------


def _summary(res, alg):
    out = {
        "valid?": res.get("valid?"),
        "op": (res.get("op") or {}).get("index"),
        "confirmed?": res.get("confirmed?"),
        "engine": res["provenance"]["engine"]["engine"],
    }
    if alg == "competition":
        out["path"] = [jprov._strip(e) for e in res["provenance"]["path"]
                       if e["event"] in COMPETITION_EVENTS]
    return out


def _check_both(hist, alg, kernel_opts, jmodel=None, tmodel=None, opts=None):
    jmodel = jmodel or jm.CASRegister(None)
    tmodel = tmodel or tm.CASRegister(None)
    want = jlin.linearizable({"model": jmodel, "algorithm": alg,
                              "kernel-opts": kernel_opts}).check({}, hist, opts or {})
    got = tlin.linearizable({"model": tmodel, "algorithm": alg, "device": "cpu",
                             "kernel-opts": kernel_opts}).check({}, hist, opts or {})
    return _summary(want, alg), _summary(got, alg)


@pytest.mark.parametrize("i", range(6))
@pytest.mark.parametrize("alg", ALGORITHMS)
def test_linearizable_matches_jax(alg, i):
    """valid?, the op's index, confirmed?, the engine's name and (for
    the competition) the decision path equal the JAX checker's."""
    want, got = _check_both(mixed_histories(6)[i], alg, {"capacity": CAP})
    assert got == want


COMPETITION_ROUTES = {
    # the greedy walk skipped, a 2-row async rung that loses rows on the
    # valid history: the DFS decides
    "dfs-after-lossy-async": {"greedy-first": False, "async-capacity": 2,
                              "capacity": CAP},
    # no rung before the DFS
    "dfs-only": {"greedy-first": False, "async-capacity": (), "capacity": CAP},
    # string values have no int32 encoding: the CPU DFS is the only engine
    "not-tensorizable": {"capacity": CAP},
}


def _string_valued(hist):
    """A copy of ``hist`` whose register values are strings."""
    def s(v):
        if isinstance(v, list):
            return [s(x) for x in v]
        return None if v is None else f"v{v}"
    return [{**o, "value": s(o["value"])} for o in hist]


@pytest.mark.parametrize("route", sorted(COMPETITION_ROUTES))
@pytest.mark.parametrize("i", [1, 2])
def test_competition_routes_match_jax(route, i):
    hist = mixed_histories(6)[i]
    if route == "not-tensorizable":
        hist = _string_valued(hist)
    want, got = _check_both(hist, "competition", COMPETITION_ROUTES[route])
    assert got == want
    assert got["engine"] in ("wgl-dfs", "async")


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("i", [2, 5])
def test_competition_reaches_chunked_engine_like_jax(monkeypatch, i, fast):
    """When the DFS is undecided the competition ends on the chunked
    engine in both packages (on corrupted histories, which the greedy
    walk cannot decide, with no async rung and the DFS budget cut to 1
    configuration in both)."""
    for cpu in (jcpu, tcpu):
        dfs = cpu.dfs_analysis
        monkeypatch.setattr(cpu, "analysis",
                            lambda model, hist, dfs=dfs: dfs(model, hist, max_visited=1))
    want, got = _check_both(mixed_histories(6)[i], "competition",
                            {"async-capacity": (), "capacity": CAP, "fast": fast})
    assert got == want
    assert got["path"][-1] == {"event": "route.chunked-exact"}


@pytest.mark.parametrize("i", [23, 27])
def test_competition_async_rungs_lose_bench_history_like_jax(monkeypatch, i):
    """Bench histories 23 and 27 (100 ops, 8 processes, 30 % :info, 8
    values, corrupted), which the bench ladder refutes at 2048 rows: the
    competition's default async rungs (256, 1024) lose rows on them in
    both packages, so both go on to the DFS and the chunked engine (the
    DFS budget cut to 1 configuration in both, the chunked ladder at the
    suite's capacity) and answer unknown with the same path."""
    for cpu in (jcpu, tcpu):
        dfs = cpu.dfs_analysis
        monkeypatch.setattr(cpu, "analysis",
                            lambda model, hist, dfs=dfs: dfs(model, hist, max_visited=1))
    hist = corrupt(valid_register_history(100, 8, seed=i, info_rate=0.3,
                                          n_values=8), seed=i)
    want, got = _check_both(hist, "competition", {"capacity": CAP})
    assert got == want
    assert got["valid?"] == "unknown"
    assert got["path"][1:3] == [
        {"event": "async.capacity", "capacity": c, "outcome": "unknown"}
        for c in (256, 1024)]


def test_linearizable_kernel_opts_and_model_errors_match_jax():
    """A kernel-opts key the engine lacks raises TypeError in both, an
    unknown algorithm ValueError, a missing model ValueError."""
    hist = mixed_histories(6)[1]
    for lin, model, extra in ((jlin, "cas-register", {}),
                              (tlin, "cas-register", {"device": "cpu"})):
        with pytest.raises(TypeError):
            lin.linearizable({"model": model, "algorithm": "tpu",
                              "kernel-opts": {"bogus": 1}, **extra}).check({}, hist, {})
        with pytest.raises(ValueError):
            lin.linearizable({"model": model, "algorithm": "nope", **extra}).check(
                {}, hist, {})
        with pytest.raises(ValueError):
            lin.linearizable({})
    chk = tlin.linearizable({"model": "cas-register", "device": "cpu"})
    assert isinstance(chk.model, tm.CASRegister) and chk.algorithm == "competition"
    assert tlin.Linearizable._truncate({"configs": list(range(20)),
                                        "final-paths": range(30)}) == {
        "configs": list(range(10)), "final-paths": list(range(10))}


# ---------------------------------------------------------------------------
# independent.checker: the batch path, the per-key fallback, the store
# ---------------------------------------------------------------------------


def _independent_summary(res):
    return {
        "valid?": res["valid?"],
        "failures": res["failures"],
        "keys": {k: (r.get("valid?"), (r.get("op") or {}).get("index"))
                 for k, r in res["results"].items()},
    }


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_independent_check_batch_matches_jax(alg):
    """independent.checker over the 4-key history: one check_batch call
    in the port, and the JAX package's valid?, failures and per-key
    verdicts and ops."""
    calls = []

    class Counting(tlin.Linearizable):
        def check_batch(self, test, histories, opts):
            calls.append(len(histories))
            return super().check_batch(test, histories, opts)

    want = jind.checker(jlin.linearizable({"model": jm.CASRegister(None),
                                           "algorithm": alg})).check(
        {"name": "t"}, keyed_history(jind), {})
    got = tind.checker(Counting({"model": tm.CASRegister(None), "algorithm": alg,
                                 "device": "cpu"})).check(
        {"name": "t"}, keyed_history(tind), {})
    assert calls == [4]
    assert _independent_summary(got) == _independent_summary(want)
    assert got["failures"] == [2] and got["valid?"] is False


def test_independent_batch_failure_falls_back_per_key():
    """A check_batch that raises falls back to the per-key check path,
    whose results equal the JAX package's fallback."""

    def raising(base):
        class Raising(base):
            def check_batch(self, test, histories, opts):
                raise RuntimeError("batch down")
        return Raising

    want = jind.checker(raising(jlin.Linearizable)({
        "model": jm.CASRegister(None)})).check({}, keyed_history(jind), {})
    got = tind.checker(raising(tlin.Linearizable)({
        "model": tm.CASRegister(None), "device": "cpu"})).check(
        {}, keyed_history(tind), {})
    assert _independent_summary(got) == _independent_summary(want)
    assert all("error" not in r for r in got["results"].values())


def test_independent_history_surgery_matches_jax():
    hist = keyed_history(tind) + [jh.op("info", "nemesis", "start", None)]
    assert tind.history_keys(hist) == jind.history_keys(hist) == [0, 1, 2, 3]
    for k in range(4):
        assert tind.subhistory(k, hist) == jind.subhistory(k, hist)
    v = tind.tuple_(5, [1, 2])
    assert v == jind.tuple_(5, [1, 2]) and tind.is_tuple(v) and not tind.is_tuple([1, 2])
    assert (tind.tuple_key(v), tind.tuple_value(v)) == (5, [1, 2])


def test_independent_writes_per_key_artifacts(tmp_path):
    """With a store, each key's results.json and history.jsonl land in
    independent/<key>/, with the JAX package's verdicts and history
    lines."""
    for pkg, ind, lin, model, extra in (
            ("jax", jind, jlin, jm.CASRegister(None), {}),
            ("port", tind, tlin, tm.CASRegister(None), {"device": "cpu"})):
        t = {"name": "ind", "start-time-str": pkg, "store-dir": str(tmp_path)}
        ind.checker(lin.linearizable({"model": model, **extra})).check(
            t, keyed_history(ind), {})
    for k in range(4):
        dj = tmp_path / "ind" / "jax" / "independent" / str(k)
        dt = tmp_path / "ind" / "port" / "independent" / str(k)
        rj = json.loads((dj / "results.json").read_text())
        rt = json.loads((dt / "results.json").read_text())
        assert rt["valid?"] == rj["valid?"]
        assert (dt / "history.jsonl").read_text() == (dj / "history.jsonl").read_text()
        assert (dt / "history.txt").read_text() == (dj / "history.txt").read_text()


# ---------------------------------------------------------------------------
# The services the checkers pass to the engines (deadlines, checkpoints,
# resume), once refused, now run
# ---------------------------------------------------------------------------


def _service_cases():
    """Each case runs one service through a package's checkers:
    ``run(lin, streaming, checker_mod, faults, model, hist, d)`` gives
    what is compared between the packages."""
    def lin_of(lin, model, alg):
        return lin.linearizable({"model": model, "algorithm": alg,
                                 "kernel-opts": {"capacity": CAP}})

    def tpu_deadline(lin, st, chk, faults, model, hist, d):
        c = lin_of(lin, model, "tpu")
        spent = chk.check_safe(c, {}, hist, {"deadline": faults.Deadline(0.0)})
        return [chk.check_safe(c, {}, hist, {"check-deadline": 60})["valid?"],
                spent["valid?"], spent["cause"]]

    def batch_deadline(lin, st, chk, faults, model, hist, d):
        c = lin_of(lin, model, "competition")
        hs = mixed_histories(6)
        ok = c.check_batch({}, hs, {"deadline": faults.Deadline(60.0)})
        spent = c.check_batch({}, hs, {"deadline": faults.Deadline(0.0)})
        return ([r["valid?"] for r in ok], [r["valid?"] for r in spent],
                [r["cause"].startswith("deadline-exceeded") for r in spent])

    def batch_checkpoint(lin, st, chk, faults, model, hist, d):
        c = lin_of(lin, model, "competition")
        out = c.check_batch({}, mixed_histories(6), {"checkpoint-dir": d})
        doc = json.loads((d / "checker-checkpoint.json").read_text())
        return ([r["valid?"] for r in out], doc["payload"]["complete"],
                doc["payload"]["stage"])

    def batch_resume(lin, st, chk, faults, model, hist, d):
        c = lin_of(lin, model, "tpu")
        hs = mixed_histories(6)
        c.check_batch({}, hs, {"checkpoint-dir": d,
                               "deadline": faults.Deadline(0.0)})
        out = c.check_batch({}, hs, {"checkpoint-dir": d, "resume?": True})
        return [r["valid?"] for r in out]

    def stream_checkpoint(lin, st, chk, faults, model, hist, d):
        sc = st.StreamingChecker(model, checkpoint_dir=d, **_stream_kw(st))
        for k in range(0, len(hist), 16):
            sc.feed(hist[k:k + 16])
        res = sc.finalize()
        doc = json.loads((d / "stream-checkpoint.json").read_text())["payload"]
        return res["valid?"], doc["advanced"], doc["epochs"], len(doc["ops"])

    def stream_resume(lin, st, chk, faults, model, hist, d):
        sc = st.StreamingChecker(model, checkpoint_dir=d, **_stream_kw(st))
        sc.feed(hist[:len(hist) // 2])
        del sc  # the process dies here
        sc = st.StreamingChecker.resume(d, model, **_stream_kw(st, True))
        at = sc.ops_consumed
        sc.feed(hist[at:])
        return at, sc.finalize()["valid?"]

    def stream_check_resume(lin, st, chk, faults, model, hist, d):
        st.stream_check(model, hist[:len(hist) // 2], checkpoint_dir=d,
                        **_stream_kw(st))
        res, sc = st.stream_check(model, hist, checkpoint_dir=d, resume=True,
                                  **_stream_kw(st))
        return res["valid?"], sc.ops_consumed, sc.epochs

    return {
        "tpu-deadline": tpu_deadline,
        "batch-deadline": batch_deadline,
        "batch-checkpoint-dir": batch_checkpoint,
        "batch-resume": batch_resume,
        "stream-checkpoint-dir": stream_checkpoint,
        "stream-resume": stream_resume,
        "stream-check-resume": stream_check_resume,
    }


def _stream_kw(st, resume=False):
    """The port's checkers run on the CPU when asked; the JAX package's
    take no device."""
    if st.__name__.startswith("jepsen_tpu_torch"):
        return {"device": "cpu"}
    return {}


@pytest.mark.parametrize("case", ["tpu-deadline", "batch-deadline",
                                  "batch-checkpoint-dir", "batch-resume",
                                  "stream-checkpoint-dir", "stream-resume",
                                  "stream-check-resume"])
def test_refusals_name_a6_and_become_unknown(case, tmp_path):
    """The options the checkers once refused (queue A6) now run, and give
    what the JAX package gives on the same history: a 60 s deadline
    decides, a spent one is the deadline-exceeded unknown; the batch
    checkpoint is written complete and a resume over a deadline-tripped
    one finishes the ladder; a stream's checkpoint records its cursor,
    and a stream resumed mid-history decides as an uninterrupted one."""
    from jepsen_tpu import faults as jfaults
    from jepsen_tpu.checker import streaming as jst
    from jepsen_tpu_torch import faults as tfaults
    from jepsen_tpu_torch.checker import streaming as tst

    run = _service_cases()[case]
    hist = mixed_histories(6)[2]
    tlin_dev = _CpuLinearizable()
    want = run(jlin, jst, jc, jfaults, jm.CASRegister(None), hist,
               tmp_path / "jax")
    got = run(tlin_dev, tst, tc, tfaults, tm.CASRegister(None), hist,
              tmp_path / "port")
    assert got == want


class _CpuLinearizable:
    """The port's ``linearizable`` with ``"device": "cpu"``."""

    @staticmethod
    def linearizable(opts):
        return tlin.linearizable({**opts, "device": "cpu"})


def test_unset_deadline_is_not_refused():
    """resolve_opts leaves an unset deadline unset, so check_safe of the
    "tpu" checker decides instead of refusing."""
    chk = tlin.linearizable({"model": "cas-register", "algorithm": "tpu",
                             "device": "cpu", "kernel-opts": {"capacity": CAP}})
    assert tc.check_safe(chk, {}, mixed_histories(6)[2])["valid?"] is False
