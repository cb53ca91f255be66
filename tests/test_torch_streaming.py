"""The port's streaming checker against its own post-hoc ladder and
against the JAX package's streaming checker.

``stream_check`` must give the verdict and witness op of the port's
post-hoc ``batch_analysis`` on the same history, and an evidence bundle
whose ``parity_digest`` equals the post-hoc bundle's (the contract of
tests/test_streaming.py); the port's stream digest must also equal the
JAX package's stream digest for the same history (fingerprint, verdict,
cause, model, checker and witness agree across the packages).  Then the
mid-stream detection with the terminal latch, a valid stream surviving
to finalize, an idempotent finalize, and the ``fused`` backend's
mid-stream refutation on the plain versions.  The inputs are the
suite's ``(30, 3)`` CAS-register histories at capacity ``(64, 256)``;
the port runs with ``device="cpu"``.  Tolerance 0: verdicts, ops and
sha256 digests.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.checker import streaming as js
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import streaming as ts
from jepsen_tpu_torch.obs import provenance as tprov
from jepsen_tpu_torch.parallel.batch import batch_analysis
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history

CAP = (64, 256)


@pytest.fixture(scope="module", autouse=True)
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


def bad_history(seed=2):
    return corrupt(valid_register_history(30, 3, seed=seed, info_rate=0.1),
                   seed=seed)


@pytest.fixture(scope="module")
def posthoc():
    """The port's post-hoc ladder over mixed_histories(6)."""
    return batch_analysis(tm.CASRegister(None), mixed_histories(6), capacity=CAP,
                          device="cpu")


def _op_index(res):
    return (res.get("op") or {}).get("index")


@pytest.mark.parametrize("feed_ops", [8, 5])
@pytest.mark.parametrize("i", range(6))
def test_stream_matches_posthoc_and_digest(posthoc, i, feed_ops):
    """Verdict, witness op and parity digest equal the port's post-hoc
    ladder's on the same history."""
    model = tm.CASRegister(None)
    hist = mixed_histories(6)[i]
    res, sc = ts.stream_check(model, hist, feed_ops=feed_ops, capacity=CAP,
                              device="cpu")
    assert (res["valid?"], _op_index(res)) == (posthoc[i]["valid?"],
                                               _op_index(posthoc[i]))
    bs = sc.evidence()
    bp = tprov.build_bundle(history=hist, result=posthoc[i], source="posthoc",
                            model=model, checker="linearizable")
    assert bs is not None and ts.parity_digest(bs) == ts.parity_digest(bp)
    assert res["provenance"]["engine"]["engine"] == "streaming"


@pytest.mark.parametrize("i", range(6))
def test_stream_digest_matches_jax_stream(i):
    """The port's stream bundle digests like the JAX package's stream
    bundle of the same history, and both reach the same verdict, op,
    settled-barrier count and epoch count."""
    hist = mixed_histories(6)[i]
    rj, sj = js.stream_check(jm.CASRegister(None), hist, feed_ops=8, capacity=CAP)
    rt, st = ts.stream_check(tm.CASRegister(None), hist, feed_ops=8, capacity=CAP,
                             device="cpu")
    assert (rt["valid?"], _op_index(rt)) == (rj["valid?"], _op_index(rj))
    assert ts.parity_digest(st.evidence()) == js.parity_digest(sj.evidence())
    for key in ("settled-barriers", "epochs", "verified-barriers", "lossy?"):
        assert rt["kernel"][key] == rj["kernel"][key], key
    assert st.status()["settled-barriers"] == sj.status()["settled-barriers"]


def test_midstream_detection_and_terminal_latch():
    """A violation latches the verdict the moment its barrier settles,
    before the stream ends; later ops never move it, and finalize is an
    idempotent no-op on a terminal stream (tests/test_streaming.py)."""
    hist = bad_history()
    sc = ts.StreamingChecker(tm.CASRegister(None), capacity=CAP, device="cpu")
    assert sc.status()["valid?"] == UNKNOWN
    detected_at = None
    for j in range(0, len(hist), 8):
        sc.feed(hist[j:j + 8])
        if sc.terminal:
            detected_at = sc.ops_consumed
            break
    assert detected_at is not None and detected_at < len(hist)
    st = sc.status()
    assert st["terminal?"] is True and st["valid?"] is False
    det = sc.detection
    assert det is not None and det["ops"] <= detected_at
    verdict = dict(sc.result)
    sc.feed(hist[detected_at:])
    assert sc.status()["ops"] == len(hist)
    assert sc.result == verdict
    assert sc.finalize() == verdict
    assert sc.finalize() == verdict


def test_valid_stream_survives_to_finalize():
    hist = valid_register_history(30, 3, seed=0, info_rate=0.1)
    sc = ts.StreamingChecker(tm.CASRegister(None), capacity=CAP, device="cpu")
    for j in range(0, len(hist), 8):
        st = sc.feed(hist[j:j + 8])
        assert st["valid?"] == UNKNOWN and not sc.terminal
    assert sc.evidence() is None
    assert sc.finalize()["valid?"] is True
    assert sc.status()["terminal?"] is True
    assert sc.finalize()["valid?"] is True


@pytest.mark.parametrize("seed", [2, 5])
def test_fast_fused_stream_refutes_midstream_like_jax(monkeypatch, seed):
    """``fast`` under the fused backend ("pallas" in the JAX package; both
    packages' wide floors lowered to 64, so that the 64-row rung takes
    it; the JAX side runs its Pallas kernel in interpret mode, the port
    its plain versions) refutes mid-stream at the JAX stream's op."""
    from jepsen_tpu.ops import wide_kernel as jwk
    from jepsen_tpu_torch.ops import wide_kernel as twk

    monkeypatch.setenv(jwk.PALLAS_MIN_CAPACITY_ENV, "64")
    monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "64")
    hist = bad_history(seed)
    kw = dict(capacity=CAP, fast=True, feed_ops=8)
    rj, sj = js.stream_check(jm.CASRegister(None), hist, dedup_backend="pallas", **kw)
    rt, st = ts.stream_check(tm.CASRegister(None), hist, dedup_backend="fused",
                             device="cpu", **kw)
    assert (rt["valid?"], _op_index(rt)) == (rj["valid?"], _op_index(rj))
    assert rt["valid?"] is False and rt["provisional?"] is True
    assert st.detection["ops"] < len(hist)
    assert ts.parity_digest(st.evidence()) == js.parity_digest(sj.evidence())


def test_remap_fcr_matches_jax():
    fcr = np.array([[1, 0, 2], [0, 0, 3]], np.int16)
    old = [(0, 1, 2), (1, 5, 6), (2, 7, 8)]
    for new in ([(2, 7, 8), (0, 1, 2), (3, 3, 3)], [(0, 1, 2)], old[::-1]):
        got = ts._remap_fcr(fcr, old, new, len(new) + 1)
        want = js._remap_fcr(fcr, old, new, len(new) + 1)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
