"""The port's durable records (``store.durable``, ``store.checkpoint``,
the write seams of ``store._atomic_write``) against the JAX package's.

The envelope bytes of the same payload are the JAX package's, and each
package reads the other's records; a CRC mismatch quarantines to the
same ``<name>.corrupt-<n>`` slot with the same report; migrations,
legacy reads, ``seal_line``/``check_line``, ``sweep_tmp``'s age gate and
the crashpoint seam's steps match.  The checkpoint pairs (ladder, chunk,
stream) written by either package load in the other.  Tolerance 0: the
outputs are bytes, reports and arrays.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from jepsen_tpu import faults as jf
from jepsen_tpu import store as jstore
from jepsen_tpu.store import checkpoint as jck
from jepsen_tpu.store import durable as jd
from jepsen_tpu_torch import faults as tf
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.store import checkpoint as tck
from jepsen_tpu_torch.store import durable as td


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each
    for the module, so that no worker's torch pool oversubscribes the
    cores the others' tests (wall-clock floors among them) run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PAYLOADS = {
    "flat": {"a": [1, 2], "b": "x"},
    "nested": {"z": {"y": [1.5, None, True]}, "a": ("t", 1)},
    "numpy": {"n": np.int64(7), "f": np.float32(0.5),
              "arr": np.arange(3, dtype=np.int32)},
    "unicode": {"name": "héllo", "k": {"3": [{"valid?": "unknown"}]}},
}

PKGS = {"jax": (jd, jstore, jf), "port": (td, tstore, tf)}


@pytest.fixture(autouse=True)
def _kinds():
    for d in (jd, td):
        d.register_kind("t-round", 3)
        d.register_kind("t-crc", 1)
        d.register_kind("t-mig", 2)
        d.register_migration("t-mig", 0,
                             lambda pl: ({**pl, "upgraded": True}, 2))
    yield
    jf.INJECT = None
    tf.INJECT = None


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_dumps_record_bytes_match_jax(name):
    pl = PAYLOADS[name]
    files = {"x.npz": {"crc32": 5, "bytes": 9}}
    for kw in ({}, {"files": files}, {"version": 4, "indent": None}):
        assert td.dumps_record("t-round", pl, **kw) == jd.dumps_record(
            "t-round", pl, **kw)
    assert td.canonical_bytes(pl) == jd.canonical_bytes(pl)
    assert td.payload_crc(pl) == jd.payload_crc(pl)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_envelope(tmp_path, writer, reader):
    wd, rd = PKGS[writer][0], PKGS[reader][0]
    sib = tmp_path / "data.bin"
    sib.write_bytes(b"generation-1")
    p = tmp_path / "r.json"
    wd.write_record(p, "t-round", {"a": [1, 2], "b": "x"},
                    files={"data.bin": wd.file_digest(sib)})
    rr = rd.read_verified(p, "t-round")
    assert rr.payload == {"a": [1, 2], "b": "x"}
    assert (rr.version, rr.legacy, rr.migrated) == (3, False, False)
    assert rr.files == {"data.bin": {"crc32": wd.file_digest(sib)["crc32"],
                                     "bytes": 12}}


def _corruption(tmp_path, pkg, mode):
    d = PKGS[pkg][0]
    base = tmp_path / pkg
    base.mkdir()
    p = base / "c.json"
    sib = base / "data.bin"
    sib.write_bytes(b"generation-1")
    d.write_record(p, "t-crc", {"n": 12345},
                   files={"data.bin": d.file_digest(sib)})
    if mode == "crc":
        doc = json.loads(p.read_text())
        doc["payload"]["n"] = 54321
        p.write_text(json.dumps(doc))
    elif mode == "sibling":
        sib.write_bytes(b"generation-2!!")
    elif mode == "kind":
        d.write_record(p, "t-round", {"n": 1})
    else:
        p.write_text("garbage {{{")
    with pytest.raises(d.DurableError) as ei:
        d.read_verified(p, "t-crc")
    rep = dict(ei.value.report)
    rep["path"] = os.path.relpath(rep["path"], base)
    rep["quarantined_to"] = [os.path.relpath(q, base)
                             for q in rep.get("quarantined_to", ())]
    rep.pop("error", None)  # the JSON parser's message
    return rep, sorted(x.name for x in base.iterdir())


@pytest.mark.parametrize("mode", ["crc", "sibling", "kind", "unparseable"])
def test_corruption_quarantine_matches_jax(tmp_path, mode):
    """The report and the files left on disk (quarantined aside to
    ``<name>.corrupt-<n>``) are the JAX package's."""
    got = _corruption(tmp_path, "port", mode)
    assert got == _corruption(tmp_path, "jax", mode)
    assert got[0]["quarantined_to"]


def test_migrations_and_future_versions_match_jax(tmp_path):
    for pkg, (d, _s, _f) in PKGS.items():
        base = tmp_path / pkg
        base.mkdir()
        (base / "legacy.json").write_text(json.dumps({"old_field": 7}))
        rr = d.read_verified(base / "legacy.json", "t-mig")
        assert (rr.legacy, rr.migrated, rr.version) == (True, True, 0)
        assert rr.payload == {"old_field": 7, "upgraded": True}
        d.write_record(base / "f.json", "t-mig", {"x": 1}, version=9)
        with pytest.raises(d.DurableError) as ei:
            d.read_verified(base / "f.json", "t-mig")
        assert ei.value.reason == "no-migration-path"
        assert (base / "f.json").exists()


def test_seal_and_check_line_match_jax():
    recs = [{"kind": "bench", "metrics": {"x": 1.5}}, {"k": [1, {"a": None}]}]
    for r in recs:
        sealed = td.seal_line(r)
        assert sealed == jd.seal_line(r)
        assert td.check_line(sealed) == jd.check_line(sealed) == (True, False)
        bad = dict(sealed, tampered=1)
        assert td.check_line(bad) == jd.check_line(bad) == (False, False)
    assert td.check_line({"kind": "bench"}) == (True, True)
    assert td.check_line([1]) == jd.check_line([1]) == (False, False)


def _sweep(tmp_path, d):
    tmp_path.mkdir()
    old = tmp_path / "a.json.x1.tmp"
    old.write_text("torn")
    os.utime(old, (time.time() - 3600, time.time() - 3600))
    (tmp_path / "b.json.x2.tmp").write_text("in-flight")
    (tmp_path / "real.json").write_text("{}")
    first = d.sweep_tmp(tmp_path, min_age_s=60.0)
    left = sorted(x.name for x in tmp_path.iterdir())
    second = d.sweep_tmp(tmp_path, min_age_s=0.0)
    return first, left, second, sorted(x.name for x in tmp_path.iterdir())


def test_sweep_tmp_age_gate_matches_jax(tmp_path):
    got = _sweep(tmp_path / "port", td)
    assert got == _sweep(tmp_path / "jax", jd)
    assert got[0] == 1 and got[2] == 1


def _seam_steps(tmp_path, store_mod, faults_mod):
    steps = []

    def watch(ctx, attempt):
        if ctx.get("what") == "store.atomic_write":
            steps.append(ctx["step"])

    with faults_mod.inject_scope(watch):
        store_mod._atomic_write(tmp_path / "x.json", "{}")

    def crash(ctx, attempt):
        if ctx.get("what") == "store.atomic_write" and ctx["step"] == "post-tmp":
            raise faults_mod.CrashPoint(ctx["step"], ctx["path"])

    with faults_mod.inject_scope(crash):
        with pytest.raises(faults_mod.CrashPoint):
            store_mod._atomic_write(tmp_path / "y.json", "data")
    return steps, (tmp_path / "y.json").exists(), len(
        list(tmp_path.glob("y.json.*.tmp")))


def test_crashpoint_seam_matches_jax(tmp_path):
    """Every write step announces itself, and a CrashPoint leaves what a
    SIGKILL leaves: the tmp present, the target absent."""
    for sub in ("port", "jax"):
        (tmp_path / sub).mkdir()
    got = _seam_steps(tmp_path / "port", tstore, tf)
    assert got == _seam_steps(tmp_path / "jax", jstore, jf)
    assert got == (["post-tmp", "post-fsync", "post-rename",
                    "pre-dir-fsync"], False, 1)


def test_file_lock_excludes_and_times_out(tmp_path):
    lock = tmp_path / "k.lock"
    with td.file_lock(lock, timeout_s=1.0):
        with pytest.raises(TimeoutError):
            with td.file_lock(lock, timeout_s=0.05):
                pass
    with td.file_lock(lock, timeout_s=0.05):
        pass


# ---------------------------------------------------------------------------
# Checkpoint pairs across the packages
# ---------------------------------------------------------------------------


def _ladder_args():
    rng = np.random.default_rng(5)
    resumes = {
        3: (7, rng.integers(0, 9, 16).astype(np.int32),
            rng.integers(0, 2**32, (16, 1), dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 3, (16, 4)).astype(np.int16),
            rng.random(16) < 0.5),
    }
    return dict(
        config={"engine": "async", "capacity": [16, 64], "fingerprint": "fp",
                "dedup": "sort", "frontier_budget_mb": None},
        stage=2,
        results={0: {"valid?": True}, 1: {"valid?": "unknown", "cause": "x"}},
        pending=[3],
        confirms={2: {"res": {"valid?": False}, "op_pos": 9}},
        device_confirms=[{"i": 4, "failed_at": 5, "cap": 64,
                          "res": {"valid?": False}}],
        resumes=resumes,
        rungs={3: 2},
    )


def _frontier():
    rng = np.random.default_rng(9)
    return (rng.integers(0, 9, 12).astype(np.int32),
            rng.integers(0, 2**32, (12, 2), dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 3, (12, 3)).astype(np.int16))


@pytest.mark.parametrize("pair", ["ladder", "chunk", "stream"])
def test_checkpoint_pairs_match_jax(tmp_path, pair):
    """The same save writes the same bytes in both packages, and each
    loads the other's pair to the same values."""
    saves = {
        "ladder": lambda ck, d: ck.save(d, **_ladder_args()),
        "chunk": lambda ck, d: ck.save_chunked(
            d, config={"fingerprint": "f", "capacity": [64]}, barrier=12,
            cap_idx=1, frontier=_frontier(), lossy=False, verified=12,
            launches=5, spill_rows=3, spill_bytes=96, spill_spent=2),
        "stream": lambda ck, d: ck.save_stream(
            d, config={"model": "cas-register"},
            ops=[{"type": "invoke", "process": 0, "f": "read", "value": None}],
            advanced=4, cap_idx=0, frontier=_frontier(),
            group_keys=[(1, 2, 3)], lossy=True, verified=4, launches=2,
            epochs=3),
    }
    loads = {"ladder": "load", "chunk": "load_chunked", "stream": "load_stream"}
    for pkg, ck in (("jax", jck), ("port", tck)):
        saves[pair](ck, tmp_path / pkg)
    jfiles = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert jfiles == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in jfiles:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    for src in ("jax", "port"):
        a = getattr(jck, loads[pair])(tmp_path / src)
        b = getattr(tck, loads[pair])(tmp_path / src)
        assert a.pop("path") == b.pop("path")
        assert json.dumps(a, default=_arr, sort_keys=True) == json.dumps(
            b, default=_arr, sort_keys=True)


def _arr(x):
    a = np.asarray(x)
    return [str(a.dtype), a.tolist()]


def test_legacy_v1_checkpoint_migrates_in_the_port(tmp_path):
    legacy = {
        "version": 1, "complete": True,
        "config": {"engine": "sync", "fingerprint": "zz"},
        "stage": 3, "results": {"0": {"valid?": True}}, "pending": [],
        "confirms": {}, "device_confirms": [], "resumes": [], "rungs": {},
    }
    (tmp_path / tck.CKPT_JSON).write_text(json.dumps(legacy))
    out = tck.load(tmp_path)
    assert out["complete"] and out["results"][0]["valid?"] is True
    assert out == {**jck.load(tmp_path), "path": out["path"]}


def test_fingerprints_match_jax():
    from jepsen_tpu import history as jh
    from jepsen_tpu_torch import history as th

    hists = [[{"type": "invoke", "process": 0, "f": "write", "value": 3},
              {"type": "ok", "process": 0, "f": "write", "value": 3}],
             [], [{"type": "info", "process": "nemesis", "f": "start",
                   "value": ("a", 1)}]]
    assert tck.fingerprint(hists) == jck.fingerprint(hists)
    cols = {k: np.arange(4, dtype=np.int64) for k in
            ("index", "type", "process", "f", "value1", "value2", "time")}
    cols["type"] = np.array([0, 1, 0, 1], np.int64)
    jc = jh.ColumnHistory(cols, ["read"], {})
    tc = th.ColumnHistory(cols, ["read"], {})
    assert tck.fingerprint([tc]) == jck.fingerprint([jc])
