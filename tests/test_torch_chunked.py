"""The port's chunked single-history engine with host spill, and its
single-history entry points, against the JAX package's.

``wgl.analysis`` (exact and fast, under "sort" and "fused"), the spill
differential (spill on, off, and under a frontier budget), the
undecidability report, ``scan_barrier_range``, ``greedy_analysis`` and
``analysis_async`` run with ``device="cpu"`` on the histories of
tests/test_spill.py (``valid_register_history(40, 4, info_rate=0.35)``,
corrupted and not, at capacity 16 in chunks of 8 barriers) and of
tests/test_wgl_tpu.py, and must give the JAX package's results: the
same verdict, op and every kernel stat (tolerance 0).  The JAX results
are compared without their ``provenance`` trail, which the port leaves
out, and without the report's ``device_buffer_bytes``, a gauge of each
package's own allocator.  For the fused route both packages' wide floors
are lowered to 64 together; the JAX side then runs its Pallas kernel in
interpret mode.  The spill helpers (``merge_frontiers``, ``HostRing``,
``factor_packed``) are held to the JAX package's on the same inputs.
"""

import json

import numpy as np
import pytest
import torch

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu.ops import spill as jspill
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.ops import wide_kernel as wk
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.ops import spill as tspill
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wide_kernel as twk
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history

SPILL_CAPS = (16,)
SPILL_CHUNK = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spill_hist(seed: int, corrupt_seed=None):
    hh = valid_register_history(40, 4, seed=seed, info_rate=0.35)
    if corrupt_seed is not None:
        hh = corrupt(hh, seed=corrupt_seed)
    return hh


def _strip(res: dict) -> dict:
    """A result without its provenance trail (each package's names its
    own dedup backend; the trails are compared in
    tests/test_torch_resume.py) and the report's allocator gauge (its
    cause renders the report, so it is compared through the report)."""
    res = dict(res)
    res.pop("provenance", None)
    if "undecidability" in res:
        res["undecidability"] = {k: v for k, v in res["undecidability"].items()
                                 if k != "device_buffer_bytes"}
        assert res.pop("cause").startswith("undecidable under fixed memory: ")
    return res


def _both(hist, jax_backend=None, model="cas", **kw):
    """(JAX result, port result) of ``analysis`` on one history."""
    jmod = jm.CASRegister(None) if model == "cas" else model[0]
    tmod = tm.CASRegister(None) if model == "cas" else model[1]
    jkw = dict(kw)
    if jax_backend is not None:
        jkw["dedup_backend"] = jax_backend
    want = _strip(jwgl.analysis(jmod, hist, **jkw))
    got = _strip(twgl.analysis(tmod, hist, device="cpu", **kw))
    return want, got


HISTS = {
    "spill-4100": lambda: spill_hist(4100),
    "spill-4101-bad": lambda: spill_hist(4101, 1),
    "spill-4102": lambda: spill_hist(4102),
    "spill-4102-bad": lambda: spill_hist(4102, 2),
}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", sorted(HISTS))
def test_analysis_matches_jax_sort(name, fast):
    """analysis under "sort", exact and fast, with the capacity ladder
    climbing (16, 64) in 8-barrier chunks: verdict, op and stats."""
    want, got = _both(HISTS[name](), capacity=(16, 64),
                      chunk_barriers=SPILL_CHUNK, fast=fast,
                      dedup_backend="sort")
    assert got == want
    if fast and got["valid?"] is False:
        assert got["provisional?"] is True


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["spill-4100", "spill-4101-bad"])
def test_analysis_matches_jax_fused(name, fast, monkeypatch):
    """analysis under "fused" against the JAX package's "pallas" with
    both wide floors at 64, so the fast engine's rounds at capacity 64
    take the fused update in both packages (the Pallas kernel in
    interpret mode there, the plain version here); the exact engine
    rides the bucket partition in both."""
    monkeypatch.setenv(wk.PALLAS_MIN_CAPACITY_ENV, "64")
    monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "64")
    want, got = _both(HISTS[name](), jax_backend="pallas", capacity=(64,),
                      chunk_barriers=16, fast=fast, dedup_backend="fused")
    assert got == want
    jwgl.evict_runner_caches()


@pytest.mark.parametrize("mode", ["spill-on", "spill-off", "budget"])
@pytest.mark.parametrize("name", ["spill-4100", "spill-4101-bad"])
def test_spill_differential_matches_jax(name, mode):
    """The spill differential of tests/test_spill.py: spill on (slices,
    the host ring, the merge; spill rows > 0 on the valid history),
    spill off, and a 0.25 MB frontier budget, each equal to the JAX
    package's run, verdicts included; spill off is never more decisive
    than spill on."""
    kw = {"spill-on": dict(spill=True), "spill-off": dict(spill=False),
          "budget": dict(frontier_budget_mb=0.25)}[mode]
    hist = HISTS[name]()
    want, got = _both(hist, capacity=SPILL_CAPS, chunk_barriers=SPILL_CHUNK,
                      **kw)
    assert got == want
    if mode == "spill-on" and name == "spill-4100":
        assert got["kernel"]["spill-rows"] > 0, "workload must actually spill"
    if mode == "spill-off":
        on = _strip(twgl.analysis(tm.CASRegister(None), hist, device="cpu",
                                  capacity=SPILL_CAPS,
                                  chunk_barriers=SPILL_CHUNK, spill=True))
        assert got["valid?"] in (on["valid?"], "unknown")


@pytest.mark.parametrize("seed", [0, 1])
def test_analysis_matches_jax_wgl_tpu_histories(seed):
    """tests/test_wgl_tpu.py's adversarial decreasing ladder (64, 8) in
    8-barrier chunks, which hands a carried frontier larger than the
    rung to the next chunk (truncation is loss)."""
    hist = valid_register_history(120, 6, seed=seed, info_rate=0.3)
    if seed % 2:
        hist = corrupt(hist, seed=seed)
    want, got = _both(hist, capacity=(64, 8), chunk_barriers=8)
    assert got == want


@pytest.mark.parametrize("fast", [False, True])
def test_analysis_matches_jax_config2_prefix(fast):
    """The first 300 ops of BASELINE config 2's history (10,000 ops, 32
    processes, 5 % :info, seed 0; P = 32): both packages lose rows at
    capacity 128 in the same chunk and keep the same witness."""
    hist = th.index([dict(o) for o in valid_register_history(
        10000, 32, seed=0, info_rate=0.05)[:300]])
    want, got = _both(hist, capacity=(128,), chunk_barriers=64, fast=fast,
                      dedup_backend="sort")
    assert got == want and got["kernel"]["lossy?"] is True


def test_undecidable_report_matches_jax():
    """tests/test_spill.py's exhaustion: a single barrier whose closure
    exceeds capacity 8 gives unknown with the same report."""
    ops = []
    t = 0
    for v in range(1, 13):
        t += 1
        ops.append(jh.op(jh.INVOKE, v, "write", v, time=t))
    t += 1
    ops.append(jh.op(jh.INVOKE, 0, "read", None, time=t))
    t += 1
    ops.append(jh.op(jh.OK, 0, "read", 99, time=t))
    for v in range(1, 13):
        t += 1
        ops.append(jh.op(jh.INFO, v, "write", v, time=t))
    hist = jh.index(ops)
    res = twgl.analysis(tm.CASRegister(None), hist, capacity=(8,),
                        device="cpu")
    prefix = "undecidable under fixed memory: "
    assert res["cause"].startswith(prefix)
    assert json.loads(res["cause"][len(prefix):]) == res["undecidability"]
    want, got = _both(hist, capacity=(8,))
    assert got == want and got["valid?"] == "unknown"
    assert got["undecidability"]["growth_rate"] > 1.0


def test_factorization_matches_jax():
    """factor_packed drops the independent crashed adds of a NIL-read
    counter history as the JAX package does, keeps the value-read ones,
    and the factored chunked verdicts equal the JAX package's."""
    def counter_history(mod, crashed, with_value_read):
        ops, t = [], 0
        for i, v in enumerate(crashed):
            t += 1
            ops.append(mod.op(mod.INVOKE, 10 + i, "add", v, time=t))
        t += 1
        ops.append(mod.op(mod.INVOKE, 0, "add", 1, time=t))
        t += 1
        ops.append(mod.op(mod.OK, 0, "add", 1, time=t))
        t += 1
        ops.append(mod.op(mod.INVOKE, 1, "read", None, time=t))
        t += 1
        ops.append(mod.op(mod.OK, 1, "read", 1 if with_value_read else None,
                          time=t))
        for i, v in enumerate(crashed):
            t += 1
            ops.append(mod.op(mod.INFO, 10 + i, "add", v, time=t))
        return mod.index(ops)

    for reads in (False, True):
        for adds in ([3, 5], [1, 2, 3]):
            hj = counter_history(jh, adds, reads)
            ht = counter_history(th, adds, reads)
            jp, jn = jspill.factor_packed(jwgl.pack(jm.MonotonicCounter(0), hj))
            tp, tn = tspill.factor_packed(twgl.pack(tm.MonotonicCounter(0), ht))
            assert tn == jn and tp["G"] == jp["G"], (reads, adds)
            assert (np.asarray(tp["grp_open"]) == np.asarray(jp["grp_open"])).all()
            if not reads:
                assert tn == len(adds)
            want = _strip(jwgl.chunked_analysis(
                jm.MonotonicCounter(0), hj, jwgl.pack(jm.MonotonicCounter(0), hj),
                [64], factor_groups=True))
            got = _strip(twgl.chunked_analysis(
                tm.MonotonicCounter(0), ht, twgl.pack(tm.MonotonicCounter(0), ht),
                [64], factor_groups=True, device="cpu"))
            assert got == want, (reads, adds)


def test_merge_frontiers_and_host_ring_match_jax():
    """merge_frontiers gives the JAX package's rows and stats (fok in as
    int32 bit patterns, out the same bits); HostRing accounts rows and
    bytes as the JAX package does, masked pushes at pop, discards
    never."""
    rng = np.random.default_rng(3)
    n = 160
    state = rng.integers(0, 12, n).astype(np.int32)
    fok = rng.integers(0, 4, (n, 2)).astype(np.uint32)
    fok[::7, 1] |= np.uint32(1 << 31)
    fcr = rng.integers(0, 3, (n, 3)).astype(np.int16)
    src = rng.integers(0, n, n // 2)
    state[: n // 2], fok[: n // 2] = state[src], fok[src]
    parts_j = [(state[:90], fok[:90], fcr[:90]), (state[90:], fok[90:], fcr[90:])]
    parts_t = [(s, f.view(np.int32), c) for s, f, c in parts_j]
    js, jf, jc, jstats = jspill.merge_frontiers(parts_j)
    ts, tf, tc, tstats = tspill.merge_frontiers(parts_t)
    assert tstats == jstats and tstats["rows_out"] < n
    assert (ts == js).all() and (tf.view(np.uint32) == jf).all() and (tc == jc).all()

    rings = [jspill.HostRing(W=1, G=2), tspill.HostRing(W=1, G=2)]
    st = np.arange(5, dtype=np.int32)
    fo = np.zeros((5, 1), np.uint32)
    fc = np.zeros((5, 2), np.int16)
    al = np.array([True, False, True, False, False])
    for ring, conv in zip(rings, (np.asarray, torch.from_numpy)):
        assert ring.push(st, fo, fc) == 5
        assert ring.push(conv(st), conv(fo.view(np.int32)), conv(fc),
                         conv(al)) == 0
        out = ring.pop_all()
        assert out[0].shape[0] == 7 and (out[0] == np.r_[st, 0, 2]).all()
        ring.push(st, fo, fc)
        ring.discard()
        assert ring.pop_all() is None
    assert (rings[1].rows_total, rings[1].bytes_total) == (
        rings[0].rows_total, rings[0].bytes_total) == (12, 12 * tspill.row_bytes(1, 2))
    assert tspill.budget_rows(0.25, 1, 16, 8) == jspill.budget_rows(0.25, 1, 16, 8)
    assert tspill.stats_snapshot()["spill_merges"] >= 1


def test_scan_barrier_range_two_ranges_equal_one_scan():
    """Two consecutive ranges, the frontier threaded between them, end
    where one whole-range scan ends (the same surviving rows), and each
    equals the JAX package's scan of the same range from the same
    frontier; a corrupted history dies at the JAX package's barrier."""
    for hist, dies in ((spill_hist(4100), False), (spill_hist(4101, 1), True)):
        jp = jwgl.pack(jm.CASRegister(None), hist)
        tp = twgl.pack(tm.CASRegister(None), hist)
        B0 = jp["B"]
        jp, tp = jwgl.pad_packed(jp, B=B0), twgl.pad_packed(tp, B=B0)
        W, G = tp["W"], tp["G"]
        f0 = (np.array([tp["init_state"]], np.int32), np.zeros((1, W), np.int32),
              np.zeros((1, G), np.int16))
        kw = dict(capacities=(16, 64), chunk_barriers=SPILL_CHUNK, spill=True)
        whole = twgl.scan_barrier_range(tp, f0, 0, B0, device="cpu", **kw)
        jwhole = jwgl.scan_barrier_range(jp, f0, 0, B0, **kw)
        assert whole["failed_barrier"] == jwhole["failed_barrier"]
        assert (whole["failed_barrier"] is not None) == dies
        mid = B0 // 2
        a = twgl.scan_barrier_range(tp, f0, 0, mid, device="cpu", **kw)
        ja = jwgl.scan_barrier_range(jp, f0, 0, mid, **kw)
        for x, y in zip(a["frontier"], ja["frontier"]):
            assert (np.asarray(x).astype(np.int64)
                    == np.asarray(y).astype(np.int64)).all()
        if a["failed_barrier"] is not None:
            assert a["failed_barrier"] == whole["failed_barrier"]
            continue
        b = twgl.scan_barrier_range(tp, ja["frontier"], mid, B0, device="cpu",
                                    cap_idx=a["cap_idx"], lossy=a["lossy"], **kw)
        assert b["failed_barrier"] == whole["failed_barrier"]
        if not dies:
            rows = [{(int(s), tuple(f), tuple(c)) for s, f, c in zip(*r["frontier"])}
                    for r in (whole, b)]
            assert rows[0] == rows[1] and rows[0]


@pytest.mark.parametrize("seed", range(4))
def test_greedy_and_async_analysis_match_jax(seed):
    """greedy_analysis (True or stuck, with the same stats and op) and
    analysis_async at capacity 64 under "sort" (verdict, op and stats)
    equal the JAX package's."""
    hist = valid_register_history(40, 5, seed=seed, info_rate=0.2)
    if seed % 2:
        hist = corrupt(hist, seed=seed)
    for fn in ("greedy_analysis", "analysis_async"):
        kw = {} if fn == "greedy_analysis" else dict(capacity=64,
                                                     dedup_backend="sort")
        want = getattr(jwgl, fn)(jm.CASRegister(None), hist, **kw)
        got = getattr(twgl, fn)(tm.CASRegister(None), hist, device="cpu", **kw)
        assert got == want, fn


def test_services_refuse_and_device_defaults_to_the_card(tmp_path):
    """The services run as in the JAX package: a spent deadline gives its
    deadline-exceeded unknown at barrier 0, a 60 s one and a chunk
    checkpoint directory decide as the JAX package does, and a resume
    from that finished checkpoint returns the saved result.  Every entry
    point defaults to the card, which this host lacks."""
    from jepsen_tpu import faults as jfaults
    from jepsen_tpu_torch import faults as tfaults

    hist = spill_hist(4100)
    kw = dict(capacity=SPILL_CAPS, dedup_backend="sort")
    want = jwgl.analysis(jm.CASRegister(None), hist,
                         deadline=jfaults.Deadline(0.0), **kw)
    got = twgl.analysis(tm.CASRegister(None), hist, device="cpu",
                        deadline=tfaults.Deadline(0.0), **kw)
    assert want["valid?"] == got["valid?"] == "unknown"
    assert got["cause"] == want["cause"]
    assert got["cause"].startswith("deadline-exceeded")
    assert got["provenance"]["path"] == want["provenance"]["path"]
    want = _strip(jwgl.analysis(jm.CASRegister(None), hist, deadline=60.0,
                                checkpoint_dir=tmp_path / "jax", **kw))
    for opts in (dict(deadline=60.0), dict(checkpoint_dir=tmp_path / "port"),
                 dict(checkpoint_dir=tmp_path / "port", resume=True)):
        got = _strip(twgl.analysis(tm.CASRegister(None), hist, device="cpu",
                                   **opts, **kw))
        assert got == want, opts
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (twgl.analysis, twgl.greedy_analysis, twgl.analysis_async):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(tm.CASRegister(None), hist)
