"""The run store (``store``, ``store.format``, ``native``) in the port
against the JAX package.

Every case of tests/test_store_format.py that writes or reads a block
file runs through both packages, and each package reads the file the
other wrote: ``scan``, ``read_index``, ``read`` and ``read_columns``
are compared (``np.savez`` stamps zip times into history chunks, so
reads are compared, not bytes), a file cut before its footer included.
The store's phases (``save_0``..``save_2``) and readers (``iter_runs``,
``tests``, ``load``, ``load_dir``, ``peek_dir``, ``latest``,
``delete``, ``capture_logging``) give equal files and results on the
same test map, and the port's C ``blockio`` path and its Python path
write byte-identical files from the same payloads.  Tolerance 0
throughout.
"""

import json
import logging
import struct
import zlib

import numpy as np
import pytest
import torch

from jepsen_tpu import core, generator as gen, testkit
from jepsen_tpu import history as jh
from jepsen_tpu import store as jstore
from jepsen_tpu.checker import unbridled_optimism
from jepsen_tpu.store import format as jfmt
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import native as tnative
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.store import format as tfmt

PKG = {"jax": (jh, jstore, jfmt), "port": (th, tstore, tfmt)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for the module (module fixtures included): the
    host's cores are shared with other test processes, wall-clock floors
    among them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk_history(h, n=20):
    """tests/test_store_format.py's history, in package ``h``."""
    ops = []
    for i in range(n):
        ops.append(h.op(h.INVOKE, i % 3, "write", i, time=i * 10))
        ops.append(h.op(h.OK, i % 3, "write", i, time=i * 10 + 5))
    ops.append(h.op(h.INFO, h.NEMESIS, "start-partition", "majority", time=999))
    o = h.op(h.INFO, h.NEMESIS, "check-offsets", None, time=1000)
    o["clock-offsets"] = {"n1": 0.25}
    ops.append(o)
    ops.append(h.op(h.OK, 1, "cas", [3, 4], time=1001))
    ops.append(h.op(h.OK, 2, "read", None, time=1002))
    ops.append(h.op(h.OK, 2, "txn", [["append", 1, 2]], time=1003))
    ops.append(h.op(h.OK, 0, "write", True, time=1004))
    ops.append(h.op(h.OK, 0, "write", [1, None], time=1005))
    ops.append(h.op(h.INVOKE, -2, "write", 7, time=1006))
    ops.append(h.op(h.OK, 0, "write", (5, 6), time=1007))
    return h.index(ops)


def _roundtrip(h, fmt, path):
    w = fmt.Writer(path)
    w.write_test({"name": "rt", "start-time-str": "t0", "nodes": ["n1"]})
    w.write_history(mk_history(h))
    w.write_results({"valid?": False, "why": "because"})
    w.close()


def _chunked(h, fmt, path):
    w = fmt.Writer(path)
    w.write_test({"name": "big", "start-time-str": "t0"})
    w.write_history(h.index([h.op(h.OK, i % 5, "write", i, time=i)
                             for i in range(fmt.CHUNK_OPS + 100)]))
    w.write_results({"valid?": True})
    w.close()


def _torn(h, fmt, path):
    w = fmt.Writer(path)
    w.write_test({"name": "crashy", "start-time-str": "t0"})
    w.write_history(mk_history(h))
    with open(path, "ab") as f:
        f.write(struct.pack("<IIB", 99999, 0, fmt.T_RESULTS))
        f.write(b"only-part-of-a-block")


def _cut_before_footer(h, fmt, path):
    _roundtrip(h, fmt, path)
    idx = fmt.scan(path)
    footer = [b for b in fmt.read_index(path)["blocks"]]
    assert footer == idx["blocks"]
    data = path.read_bytes()
    last = idx["blocks"][-1]
    cut = data[: last["offset"] + 9 + last["len"]]
    # keep the header's footer offset: the reader must notice it is gone
    path.write_bytes(cut)


def _reopen(h, fmt, path):
    fmt.Writer(path).write_test({"name": "phases", "start-time-str": "t0"})
    w2 = fmt.Writer(path)
    w2.write_test({"name": "phases", "start-time-str": "t0"})
    w2.write_history(mk_history(h, 5))
    w3 = fmt.Writer(path)
    w3.write_results({"valid?": True})
    w3.close()


CASES = {"roundtrip": _roundtrip, "chunked": _chunked, "torn": _torn,
         "cut-before-footer": _cut_before_footer, "reopen": _reopen}


def _reads(pkg, path):
    """Everything package ``pkg`` reads from ``path``."""
    h, _store, fmt = PKG[pkg]
    idx = fmt.read_index(path)
    full = fmt.read(path, idx)
    cols, fs, extras = fmt.read_columns(path, idx)
    ch = h.ColumnHistory(cols, fs, extras)
    return {
        "scan": fmt.scan(path), "index": idx, "read": full,
        "no-history": fmt.read(path, idx, history=False),
        "cols": {k: v.tolist() for k, v in cols.items()},
        "dtypes": sorted({str(v.dtype) for v in cols.values()}),
        "fs": fs, "extras": extras, "column-ops": list(ch),
    }


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer", sorted(PKG))
def test_each_package_reads_the_others_file(tmp_path, writer, case):
    h, _store, fmt = PKG[writer]
    path = tmp_path / "run.jepsen"
    CASES[case](h, fmt, path)
    jax_reads, port_reads = _reads("jax", path), _reads("port", path)
    assert port_reads == jax_reads
    # the assertions of tests/test_store_format.py, on the port's reads
    hist = jax_reads["read"].get("history")
    if case in ("roundtrip", "cut-before-footer"):
        assert port_reads["index"]["name"] == "rt"
        assert port_reads["index"]["op-count"] == len(mk_history(th))
        assert port_reads["read"]["history"] == mk_history(th)
        if case == "roundtrip":
            assert port_reads["index"]["valid?"] is False
            assert port_reads["read"]["results"] == {"valid?": False,
                                                     "why": "because"}
    elif case == "chunked":
        assert sum(1 for b in port_reads["index"]["blocks"]
                   if b["type"] == tfmt.T_HISTORY) == 2
    elif case == "torn":
        assert port_reads["index"]["name"] == "crashy"
        assert port_reads["index"].get("valid?") is None
        assert hist == mk_history(th)
    elif case == "reopen":
        assert port_reads["index"]["valid?"] is True
        assert hist == mk_history(th, 5)
    assert port_reads["column-ops"] == (hist or [])


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_corrupt_magic(tmp_path, pkg):
    fmt = PKG[pkg][2]
    p = tmp_path / "bad.jepsen"
    p.write_bytes(b"NOTJEPSEN")
    with pytest.raises(fmt.CorruptFile):
        fmt.read_index(p)
    with pytest.raises(fmt.CorruptFile):
        fmt.scan(p)


def test_chunk_payloads_are_equal():
    """A history chunk's bytes, but for the npz's zip times, are equal in
    the two packages: the same columns, sidecar and framing."""
    jp = jfmt._pack_chunk(mk_history(jh))
    tp = tfmt._pack_chunk(mk_history(th))
    n, side = struct.unpack_from("<II", tp)
    assert (n, side) == struct.unpack_from("<II", jp)
    assert tp[: 8 + side] == jp[: 8 + side]
    jc, tc = jfmt._chunk_columns(jp), tfmt._chunk_columns(tp)
    assert jc[1:] == tc[1:]
    for k in jfmt._COLS:
        assert jc[0][k].dtype == tc[0][k].dtype
        assert (jc[0][k] == tc[0][k]).all()


def _writes(fmt, path, payload):
    """The Writer's blocks from fixed payloads: test, results, one
    history chunk's bytes, and the footer."""
    w = fmt.Writer(path)
    w.write_test({"name": "n", "start-time-str": "t"})
    w._append(fmt.T_HISTORY, payload)
    w.index["op-count"] = 7
    w.write_results({"valid?": True})
    w.close()
    return path.read_bytes()


def test_native_blockio_writes_the_python_paths_bytes(tmp_path, monkeypatch):
    ext = tnative.blockio()
    assert ext is not None, "gcc builds the C path on this host"
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.library_path().exists()
    payload = b"\x00\x01jepsen-block-payload" * 65
    assert ext.crc32(payload) == zlib.crc32(payload)
    p1 = tmp_path / "c.bin"
    p1.write_bytes(b"")
    with open(p1, "r+b") as f:
        assert ext.append_block(f.fileno(), tfmt.T_HISTORY, payload) == (
            0, len(payload))
    with open(p1, "rb") as f:
        assert tfmt._read_block(f, 0) == (tfmt.T_HISTORY, payload)

    chunk = tfmt._pack_chunk(mk_history(th))
    c_bytes = _writes(tfmt, tmp_path / "c.jepsen", chunk)
    monkeypatch.setattr(tnative, "blockio", lambda: None)
    py_bytes = _writes(tfmt, tmp_path / "py.jepsen", chunk)
    assert c_bytes == py_bytes
    # and the JAX package's Python path writes them too
    import jepsen_tpu.native as jnative

    monkeypatch.setattr(jnative, "blockio", lambda: None)
    assert _writes(jfmt, tmp_path / "jax.jepsen", chunk) == c_bytes


def _test_map(h, base, name="st", ts="20260101T000000.000Z", **kw):
    hist = mk_history(h, 6)
    return {"name": name, "start-time-str": ts, "store-dir": str(base),
            "nodes": ["n1", "n2"], "concurrency": 3, "client": object(),
            "history": hist, "results": {"valid?": True, "count": 12},
            **kw}


def _tree(base):
    """Every file under ``base`` with its bytes (``run.jepsen`` by its
    reads), and every symlink with its target."""
    out = {}
    for p in sorted(base.rglob("*")):
        rel = str(p.relative_to(base))
        if p.is_symlink():
            out[rel] = ("link", str(p.readlink()))
        elif p.name == "run.jepsen":
            r = _reads("jax", p)
            out[rel] = ("run", json.dumps(
                {k: r[k] for k in ("index", "read", "fs", "extras", "cols")},
                sort_keys=True, default=str))
        elif p.name.endswith(".log"):
            # the log's lines without their clock stamp
            out[rel] = ("log", [ln.split(" ", 2)[2] for ln in
                                p.read_text().splitlines()])
        elif p.is_file():
            out[rel] = ("file", p.read_bytes())
    return out


def _norm(x, base):
    return json.loads(json.dumps(x, default=str).replace(str(base), "BASE"))


def _store_run(pkg, base):
    h, store, _fmt = PKG[pkg]
    t1 = _test_map(h, base)
    t2 = _test_map(h, base, ts="20260101T000001.000Z",
                   results={"valid?": False})
    t3 = _test_map(h, base, name="other")
    for t in (t1, t2, t3):
        store.save_0(t)
        store.save_1(t)
        store.save_2(t)
    # a run cut after save_1 (no results, an unsealed block file)
    t4 = _test_map(h, base, name="cut", ts="20260101T000002.000Z")
    store.save_0(t4)
    store.save_1(t4)
    with store.capture_logging(t1, "jepsen.log") as log_path:
        logging.getLogger("jepsen.test").warning("captured %d", 7)
    out = {
        "serializable": store.serializable_test(t1),
        "iter_runs": [(n, ts, str(d), type(mt).__name__)
                      for n, ts, d, mt in store.iter_runs(store_dir=str(base))],
        "tests": store.tests(store_dir=str(base)),
        "tests-st": store.tests("st", store_dir=str(base)),
        "peek": [store.peek_dir(store.test_dir(t)) for t in (t1, t2, t3, t4)],
        "log": "captured 7" in log_path.read_text(),
    }
    loads = []
    for t in (t1, t2, t4):
        got = store.load(t["name"], t["start-time-str"], store_dir=str(base))
        hist = got.pop("history", None)
        loads.append((got, type(hist).__name__, list(hist or [])))
    out["load"] = loads
    latest = store.latest(store_dir=str(base))
    out["latest"] = (latest["name"], latest["start-time-str"],
                     list(latest["history"]))
    # load_dir's JSON fallback: a run with no block file
    (store.test_dir(t3) / "run.jepsen").unlink()
    fb = store.load_dir(store.test_dir(t3))
    out["fallback"] = fb
    out["tree"] = _tree(base)
    store.delete("other", store_dir=str(base))
    out["after-delete"] = store.tests(store_dir=str(base))
    store.delete(store_dir=str(base))
    out["gone"] = base.exists()
    return _norm(out, base)


def test_store_phases_and_readers_are_equal(tmp_path):
    # equal-length roots: block offsets in run.jepsen follow the test
    # map's store-dir
    jax_out = _store_run("jax", tmp_path / "j" / "store")
    port_out = _store_run("port", tmp_path / "p" / "store")
    assert port_out == jax_out
    assert port_out["log"] is True
    assert [p["valid?"] for p in port_out["peek"]] == [True, False, True, None]
    assert port_out["load"][0][1] == "ColumnHistory"


@pytest.mark.parametrize("reader", sorted(PKG))
def test_each_package_loads_the_others_store(tmp_path, reader):
    """A store the other package wrote, read back: peek, load and the
    run index equal what the writer itself reads."""
    writer = "jax" if reader == "port" else "port"
    base = tmp_path / "s"
    h, wstore, _ = PKG[writer]
    t = _test_map(h, base)
    wstore.save_0(t)
    wstore.save_1(t)
    wstore.save_2(t)
    rstore = PKG[reader][1]
    d = rstore.test_dir(t)
    assert rstore.peek_dir(d) == wstore.peek_dir(d)
    got, want = rstore.load_dir(d), wstore.load_dir(d)
    assert list(got.pop("history")) == list(want.pop("history"))
    assert got == want
    assert list(rstore.iter_runs(str(base))) == list(wstore.iter_runs(str(base)))


def test_port_reads_a_jax_core_run(tmp_path):
    """A run stored by the JAX package's ``core.run_test`` (the noop test
    of tests/test_store_format.py): the port's ``peek_dir`` and
    ``load_dir`` equal the JAX package's."""
    t = testkit.noop_test(
        name="fmt-e2e", concurrency=2, client=testkit.atom_client(),
        generator=gen.clients(gen.limit(10, gen.repeat(lambda: {"f": "read"}))),
        checker=unbridled_optimism(),
    )
    t["store-dir"] = str(tmp_path)
    completed = core.run_test(t)
    d = jstore.test_dir(completed)
    assert tstore.peek_dir(d) == jstore.peek_dir(d)
    assert tstore.peek_dir(d)["valid?"] is True
    got, want = tstore.load_dir(d), jstore.load_dir(d)
    assert list(got.pop("history")) == list(want.pop("history")) == [
        dict(o) for o in completed["history"]]
    assert got == want


def test_column_history_packs_like_the_dicts(tmp_path):
    """The zero-copy read (tests/test_store_format.py's
    ``read_columns``): the port's ``ColumnHistory`` over the JAX
    package's file packs into the barrier tables the dict read packs."""
    from jepsen_tpu_torch import models as tm
    from jepsen_tpu_torch.ops import wgl as twgl

    hist = []
    for i in range(40):
        p = i % 3
        hist.append(jh.op(jh.INVOKE, p, "write", i % 5))
        hist.append(jh.op(jh.OK, p, "write", i % 5))
    hist.append(jh.op(jh.INFO, jh.NEMESIS, "kill", {"n1": "killed"}))
    hist.append(jh.op(jh.INVOKE, 0, "cas", [1, 2]))
    hist.append(jh.op(jh.OK, 0, "cas", [1, 2]))
    hist = jh.index([{**o, "time": k} for k, o in enumerate(hist)])
    f = tmp_path / "run.jepsen"
    w = jfmt.Writer(f)
    w.write_test({"name": "zc", "start-time-str": "t"})
    w.write_history(hist)
    w.write_results({"valid?": True})
    w.close()
    dicts = tfmt.read(f)["history"]
    ch = th.ColumnHistory(*tfmt.read_columns(f))
    assert ch.positional()
    assert list(ch) == dicts
    model = tm.CASRegister(None)
    p1, p2 = twgl.pack(model, dicts), twgl.pack(model, ch)
    for a, b in zip(p1["bar"], p2["bar"]):
        assert (np.asarray(a) == np.asarray(b)).all()
