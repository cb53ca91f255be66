"""Evidence bundles on disk (``obs.provenance.emit``) in the port against
the JAX package's.

With a store configured (``name``, ``start-time-str``, ``store-dir`` in
the test map) the linearizable checker (``check``, and ``check_batch``
under ``independent.checker``) and the Elle checkers write one bundle
per result under ``<test-dir>/evidence/``.  A bundle's id is random and
its machine block names the host, so both are pinned alike in the two
packages; the files are then equal byte for byte, and the results'
``"evidence"`` pointers carry equal digests.  ``verify_bundle`` passes
on each (in both packages), and a tampered bundle gives the same report
in both.  Shapes: the (30, 3) histories of tests/test_torch_checker.py
at capacity (64, 256), the port on the CPU under the JAX package's
default "sort" backend.
"""

import itertools
import json
import pathlib
import sys
import uuid

import pytest
import torch

from jepsen_tpu import independent as jind
from jepsen_tpu import models as jm
from jepsen_tpu.checker import elle as je
from jepsen_tpu.checker import linearizable as jlin
from jepsen_tpu.obs import provenance as jprov
from jepsen_tpu.store import durable as jd
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import elle as te
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.obs import provenance as tprov
from jepsen_tpu_torch.ops import hashing as thashing
from jepsen_tpu_torch.store import durable as td
from jepsen_tpu_torch.testing import gentxn as tgen
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

import gentxn as jgen  # noqa: E402

CAP = (64, 256)
MACHINE = {"host": "h", "cpu": "c", "python": "3"}


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """One torch thread; the bundle id and machine block pinned alike in
    both packages; the port's default backend set to the JAX package's
    ("sort"), which the batch ladder records in its provenance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(jprov, "machine_fingerprint", lambda: dict(MACHINE))
    monkeypatch.setattr(tprov, "machine_fingerprint", lambda: dict(MACHINE))
    monkeypatch.setattr(thashing, "DEDUP_BACKEND", "sort")
    yield
    torch.set_num_threads(n)


def _ids(monkeypatch):
    counter = itertools.count()
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=(next(counter) + 1) << 64))


def mixed_histories(n=6):
    hists = []
    for i in range(n):
        hist = valid_register_history(30, 3, seed=i, info_rate=0.1)
        if i % 3 == 2:
            hist = corrupt(hist, seed=i)
        hists.append(hist)
    return hists


def keyed_history(ind):
    hist = []
    for k in range(3):
        sub = valid_register_history(16, 2, seed=k, info_rate=0.1)
        if k == 1:
            sub = corrupt(sub, seed=k)
        for o in sub:
            hist.append({**o, "value": ind.tuple_(k, o.get("value"))})
    for i, o in enumerate(hist):
        o["index"] = i
    return hist


def _test_map(tmp_path, pkg):
    return {"name": "ev", "start-time-str": pkg, "store-dir": str(tmp_path)}


def _files(tmp_path, pkg):
    root = tmp_path / "ev" / pkg
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("evidence/*.json"))}


def _pointers(res):
    if isinstance(res, dict):
        out = {k: _pointers(v) for k, v in res.items() if k != "evidence"}
        if "evidence" in res:
            out["evidence"] = (res["evidence"]["id"], res["evidence"]["digest"])
        return out
    if isinstance(res, list):
        return [_pointers(v) for v in res]
    return res


def _check_both(tmp_path, monkeypatch, run):
    out = {}
    for pkg in ("jax", "port"):
        _ids(monkeypatch)
        res = _pointers(run(pkg, _test_map(tmp_path, pkg)))
        # the two packages' model objects and store directories aside
        out[pkg] = json.dumps(res, default=repr, sort_keys=True).replace(
            str(tmp_path / "ev" / pkg), "DIR")
    got, want = _files(tmp_path, "port"), _files(tmp_path, "jax")
    assert got and list(got) == list(want)
    for name in got:
        assert got[name] == want[name], name
    assert out["port"] == out["jax"]
    for p in sorted((tmp_path / "ev" / "port").rglob("evidence/*.json")):
        assert tprov.verify_bundle(p)["ok"], p
        assert jprov.verify_bundle(p)["ok"], p
    return got


@pytest.mark.parametrize("alg", ["competition", "tpu", "wgl"])
def test_linearizable_check_bundles_match_jax(tmp_path, monkeypatch, alg):
    hists = mixed_histories(3)

    def run(pkg, test):
        lin, model, extra = ((jlin, jm, {}) if pkg == "jax"
                             else (tlin, tm, {"device": "cpu"}))
        chk = lin.linearizable({"model": model.CASRegister(None),
                                "algorithm": alg,
                                "kernel-opts": {"capacity": CAP}, **extra})
        return [chk.check(test, hh, {}) for hh in hists]

    got = _check_both(tmp_path, monkeypatch, run)
    assert len(got) == len(mixed_histories(3))


@pytest.mark.parametrize("alg", ["competition", "wgl"])
def test_independent_check_batch_bundles_match_jax(tmp_path, monkeypatch, alg):
    def run(pkg, test):
        lin, ind, model, extra = (
            (jlin, jind, jm, {}) if pkg == "jax"
            else (tlin, tind, tm, {"device": "cpu"}))
        chk = ind.checker(lin.linearizable({
            "model": model.CASRegister(None), "algorithm": alg,
            "kernel-opts": {"capacity": CAP}, **extra}))
        return chk.check(test, keyed_history(ind), {})

    got = _check_both(tmp_path, monkeypatch, run)
    assert len(got) == 3  # one bundle per key


@pytest.mark.parametrize("batch", [False, True])
def test_elle_bundles_match_jax(tmp_path, monkeypatch, batch):
    def run(pkg, test):
        elle, gen, ind, extra = ((je, jgen, jind, {}) if pkg == "jax"
                                 else (te, tgen, tind, {"device": "cpu"}))
        hists = [gen.append_history(30, n_keys=3, n_procs=4, seed=s)
                 for s in range(2)]
        chk = elle.list_append()
        if batch:
            return chk.check_batch(test, hists, extra)
        return [chk.check(test, hh, extra) for hh in hists]

    _check_both(tmp_path, monkeypatch, run)


def _tamper(path, how):
    doc = json.loads(path.read_text())
    if how == "envelope":
        doc["payload"]["verdict"] = "true" if doc["payload"][
            "verdict"] == "false" else "false"
        path.write_text(json.dumps(doc))
    elif how == "digest":
        doc["payload"]["decision_path"].append({"event": "forged"})
        path.write_text(td.dumps_record(tprov.KIND_BUNDLE, doc["payload"]))
    else:  # a witness that does not step
        w = doc["payload"]["witness"]
        w["order"] = list(reversed(w["order"]))
        doc["payload"]["digest"] = tprov.bundle_digest(doc["payload"])
        path.write_text(td.dumps_record(tprov.KIND_BUNDLE, doc["payload"]))


@pytest.mark.parametrize("how", ["envelope", "digest", "witness"])
def test_tampered_bundle_reports_like_jax(tmp_path, monkeypatch, how):
    """A tampered bundle fails verify with a report, the same report in
    both packages: a flipped verdict breaks the envelope CRC (and the
    file is quarantined), a forged path breaks the digest, and a
    reordered linearization no longer steps."""
    hist = mixed_histories(1)[0]
    reports = {}
    for pkg, prov, d in (("jax", jprov, jd), ("port", tprov, td)):
        _ids(monkeypatch)
        chk = tlin.linearizable({"model": tm.CASRegister(None),
                                 "algorithm": "wgl", "device": "cpu"})
        res = chk.check(_test_map(tmp_path, pkg), hist, {})
        p = pathlib.Path(res["evidence"]["path"])
        assert prov.verify_bundle(p)["ok"]
        _tamper(p, how)
        rep = prov.verify_bundle(p)
        assert not rep["ok"] and rep["errors"]
        if "envelope" in rep:
            rep["envelope"] = {k: v for k, v in rep["envelope"].items()
                               if k in ("reason", "artifact")}
            rep["errors"] = [e.split(" at ")[0] for e in rep["errors"]]
        reports[pkg] = rep
    assert reports["port"] == reports["jax"]
    if how == "envelope":
        assert reports["port"]["envelope"]["reason"] == "crc-mismatch"
        assert list((tmp_path / "ev" / "port" / "evidence").glob("*.corrupt-*"))


def test_iter_and_read_bundles(tmp_path, monkeypatch):
    _ids(monkeypatch)
    chk = tlin.linearizable({"model": tm.CASRegister(None), "algorithm": "wgl",
                             "device": "cpu"})
    test = _test_map(tmp_path, "port")
    outs = [chk.check(test, hh, {}) for hh in mixed_histories(3)]
    run_dir = tmp_path / "ev" / "port"
    found = list(tprov.iter_bundles(run_dir))
    assert [p.name for p, _b in found] == sorted(
        pathlib.Path(o["evidence"]["path"]).name for o in outs)
    for p, b in found:
        assert b == tprov.read_bundle(p) == jprov.read_bundle(p)
    # no store coordinates: nothing written, the bundle still returned
    res = {"valid?": True}
    b = tprov.emit({}, mixed_histories(1)[0], res, source="check")
    assert b["verdict"] == "true" and "evidence" not in res
