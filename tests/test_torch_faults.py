"""The port's fault policy (``jepsen_tpu_torch.faults``) against the JAX
package's ``faults``.

The classification of exceptions, the retry policy (its backoff
delays, its ``LaunchFailure``), the injection seam (``inject_scope``
nesting, ``seeded_injector`` schedules), the launch-time EWMA and the
OOM-spiller registry give the JAX package's answers on the same inputs.
The port adds the CUDA errors: an out-of-memory is "oom", and a sticky
error (the context is poisoned) classifies as ``None`` so that nobody
retries or degrades around it.  Tolerance 0: the outputs are strings,
kinds and delays.
"""

import json
import pathlib
import subprocess
import sys
import weakref

import pytest
import torch

from jepsen_tpu import faults as jf
from jepsen_tpu_torch import faults as tf


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each
    for the module, so that no worker's torch pool oversubscribes the
    cores the others' tests (wall-clock floors among them) run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parent.parent


class FakeXlaRuntimeError(RuntimeError):
    """Name and RuntimeError lineage of the JAX runtime's errors."""


#: exceptions both packages classify alike
SHARED = [
    FakeXlaRuntimeError("RESOURCE_EXHAUSTED: hbm"),
    FakeXlaRuntimeError("INTERNAL: scheduler"),
    RuntimeError("TPU worker process crashed or restarted"),
    ConnectionResetError("connection reset"),
    ValueError("INTERNAL looking but wrong type"),
    RuntimeError("some other bug"),
    RuntimeError("UNAVAILABLE: tunnel"),
    RuntimeError("Attempting to allocate 2.0G"),
    OSError("failed to connect to the chip"),
    KeyError("INTERNAL"),
    # the card's errors that the JAX markers already read the same way
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure"),
    RuntimeError("CUDA error: device-side assert triggered"),
    RuntimeError("wk_keep_mask failed: CUDA error 2 (out of memory)"),
]

#: the port's CUDA cases where the JAX markers alone would answer
#: otherwise, each with the port's kind: a sticky error whose message
#: happens to carry a transient marker, and the wrappers' codes
CUDA_ONLY = [
    (RuntimeError("INTERNAL: CUDA error: an illegal memory access was "
                  "encountered"), None),
    (RuntimeError("ABORTED: CUDA error: uncorrectable ECC error "
                  "encountered"), None),
    (RuntimeError("wk_fused_tail failed: CUDA error 700 (an illegal memory "
                  "access was encountered)"), None),
    (RuntimeError("wk_mesh_exchange failed: CUDA error 719 (unspecified "
                  "launch failure)"), None),
    (RuntimeError("wk_keep_mask failed: CUDA error 1 (invalid argument; "
                  "RESOURCE_EXHAUSTED)"), None),
    (RuntimeError("wk_keep_mask failed: CUDA error 2 (out of memory; "
                  "INTERNAL)"), "oom"),
    (type("OutOfMemoryError", (RuntimeError,), {})("allocator refused"),
     "oom"),
]


@pytest.fixture(autouse=True)
def _clean_inject():
    yield
    jf.INJECT = None
    tf.INJECT = None


@pytest.mark.parametrize("i", range(len(SHARED)))
def test_error_kind_matches_jax(i):
    e = SHARED[i]
    assert tf.error_kind(e) == jf.error_kind(e)
    assert tf.describe(e) == jf.describe(e)


@pytest.mark.parametrize("i", range(len(CUDA_ONLY)))
def test_error_kind_of_cuda_errors(i):
    """Sticky errors (illegal address, launch failure, ECC, assert) are
    never retried or degraded; the wrappers' codes classify by code."""
    e, kind = CUDA_ONLY[i]
    assert tf.error_kind(e) == kind


def test_real_oom_and_sticky_kinds():
    assert tf.error_kind(torch.OutOfMemoryError("CUDA out of memory")) == "oom"
    for msg in ("misaligned address", "an illegal instruction was "
                "encountered", "unspecified launch failure"):
        assert tf.error_kind(RuntimeError(f"CUDA error: {msg}")) is None


def _retry_trace(mod, errors, **kw):
    """Run ``mod.call_with_retry`` over a function raising ``errors`` in
    turn, then returning "ok": (outcome, calls, sleeps)."""
    calls, sleeps = [], []

    def fn():
        calls.append(1)
        if len(calls) <= len(errors):
            raise errors[len(calls) - 1]
        return "ok"

    try:
        out = mod.call_with_retry(fn, {"what": "t"}, sleep=sleeps.append, **kw)
    except mod.LaunchFailure as lf:
        out = (lf.kind, lf.what, str(lf), type(lf.cause).__name__)
    except Exception as e:  # noqa: BLE001 — the re-raised foreign error
        out = ("raised", type(e).__name__)
    return out, len(calls), sleeps


RETRY_CASES = {
    "backoff-then-ok": ([FakeXlaRuntimeError("UNAVAILABLE: hiccup")] * 2,
                        dict(retries=3, base_s=0.5, max_s=8.0)),
    "oom-at-once": ([FakeXlaRuntimeError("RESOURCE_EXHAUSTED: oom")] * 5,
                    dict(retries=5, base_s=0, max_s=0)),
    "exhausted": ([FakeXlaRuntimeError("ABORTED: preempted")] * 9,
                  dict(retries=2, base_s=0.25, max_s=0.4)),
    "foreign": ([ValueError("a real bug")], dict(retries=5)),
    "cuda-oom": ([torch.OutOfMemoryError("CUDA out of memory")],
                 dict(retries=3, base_s=0, max_s=0)),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_call_with_retry_matches_jax(case):
    errors, kw = RETRY_CASES[case]
    assert _retry_trace(tf, errors, **kw) == _retry_trace(jf, errors, **kw)


def test_call_with_retry_env_knobs(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_LAUNCH_RETRIES", "1")
    monkeypatch.setenv("JEPSEN_TPU_RETRY_BASE_S", "0.125")
    errors = [FakeXlaRuntimeError("INTERNAL: x")] * 3
    got = _retry_trace(tf, errors)
    assert got == _retry_trace(jf, errors)
    assert got[0][0] == "transient" and got[2] == [0.125]


def test_sticky_cuda_error_is_reraised():
    """A sticky error leaves call_with_retry untouched, on the first
    attempt: nothing retries on a poisoned context."""
    calls = []

    def fn():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered (INTERNAL)")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        tf.call_with_retry(fn, retries=5, base_s=0, max_s=0)
    assert len(calls) == 1


def _schedule(mod, seed, **kw):
    inj = mod.seeded_injector(seed, **kw)
    out = []
    for what in ("ladder.async", "ladder.greedy", "wgl.chunk",
                 "store.atomic_write", "ladder.confirm"):
        for stage in range(4):
            for lanes in (1, 3, 8):
                for attempt in (0, 1):
                    ctx = dict(what=what, stage=stage, engine="async",
                               capacity=64 << stage, lanes=lanes)
                    try:
                        inj(ctx, attempt)
                        out.append(None)
                    except RuntimeError as e:
                        out.append((str(e), mod.error_kind(e)))
    return out


@pytest.mark.parametrize("seed,kw", [(0, {}), (7, {}),
                                     (3, dict(transient_rate=0.5,
                                              oom_rate=0.3)),
                                     (11, dict(what="ladder."))])
def test_seeded_injector_schedule_matches_jax(seed, kw):
    got = _schedule(tf, seed, **kw)
    assert got == _schedule(jf, seed, **kw)
    assert any(x is not None for x in got)


def test_inject_scope_nesting_matches_jax():
    """Scopes compose in order, a shadowing scope hides the earlier
    ones, and a direct assignment made before the first scope comes back
    after the last one exits, in both packages."""
    def run(mod):
        seen = []

        def rec(tag):
            return lambda ctx, attempt: seen.append((tag, attempt))

        mod.INJECT = rec("base")
        with mod.inject_scope(rec("a")):
            mod.INJECT({}, 0)
            with mod.inject_scope(rec("b"), compose=False):
                mod.INJECT({}, 1)
            with mod.inject_scope(rec("c")):
                mod.INJECT({}, 2)
        mod.INJECT({}, 3)
        mod.INJECT = None
        return seen

    assert run(tf) == run(jf)


def test_launch_ewma_and_spillers():
    """The EWMA ignores reduced (retry) launches and counts them; the
    spiller registry is idempotent, skips a spiller that raises, and
    reports whether anything was freed."""
    n0 = tf.retry_launch_count()
    for s in (1.0, 2.0):
        tf.record_launch_seconds(s)
    tf.record_launch_seconds(100.0, retry=True)
    assert tf.retry_launch_count() == n0 + 1
    assert tf.launch_seconds_ewma() is not None and tf.launch_seconds_ewma() < 100

    def broken(ctx):
        raise RuntimeError("spiller bug")

    def frees(ctx):
        return ctx.get("what") == "x"

    for mod in (tf, jf):
        for fn in (broken, frees, frees):
            mod.register_oom_spiller(fn)
        try:
            assert mod.try_oom_spill({"what": "x"}) is True
            assert mod.try_oom_spill({"what": "y"}) is False
        finally:
            mod.unregister_oom_spiller(broken)
            mod.unregister_oom_spiller(frees)


def test_release_drops_the_failed_attempts_locals():
    """release() frees what the failed attempt's frames held (on the
    card, the tensors of a launch that ran out of memory)."""
    class Big:
        pass

    ref = []

    def attempt():
        big = Big()
        ref.append(weakref.ref(big))
        raise torch.OutOfMemoryError("CUDA out of memory")

    try:
        tf.call_with_retry(attempt, {"what": "t"}, retries=0)
    except tf.LaunchFailure as lf:
        assert lf.kind == "oom"
        assert ref[0]() is not None  # the traceback keeps it alive
        tf.release(lf)
        assert ref[0]() is None


def test_faults_and_stores_import_without_torch():
    """faults, store.durable and store.checkpoint (and the provenance
    module that writes bundles through them) import in a fresh
    interpreter without torch or jax."""
    code = (
        "import json, sys\n"
        "import jepsen_tpu_torch.faults, jepsen_tpu_torch.store.durable\n"
        "import jepsen_tpu_torch.store.checkpoint\n"
        "import jepsen_tpu_torch.obs.provenance\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('torch', 'jax'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
