"""The bounded profiler hook (``obs.profiler.ProfilerHook``) in the port
against the JAX package.

Under the ``_trace_api`` seam (tests/test_obs.py's profiler case) both
hooks make the same calls and return the same status documents, clock
keys dropped: bounded (seconds clamp to ``max_seconds``), exclusive (a
second start reports, never corrupts), generation-safe (a stale
watchdog no-ops instead of stopping the next capture), and a failing
profiler start or stop surfaced as an error without wedging the hook.
Then one real ``torch.profiler`` capture on the CPU, started on one
thread and stopped by the hook's own watchdog on another, writes its
Chrome trace into the capture directory within its bound, with the
tiny torch op that ran in it; a start while another torch.profiler
session runs in the process is refused with an error, and a capture
after such a session (on another thread) runs cleanly.  The device
summary reads kineto's layout by pattern and falls back to JSON where
the pattern missed a device event.
"""

import json
import threading
import time
from pathlib import Path

import pytest
import torch

from jepsen_tpu.obs import profiler as jprof
from jepsen_tpu_torch.obs import profiler as tprof

PKG = {"jax": jprof, "port": tprof}

#: status keys that read the clock
CLOCK = {"elapsed_s", "auto_stop_in_s", "capture_dir", "dir"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for the module (module fixtures included): the
    host's cores are shared with other test processes, wall-clock floors
    among them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scrub(doc):
    if isinstance(doc, dict):
        return {k: _scrub(v) for k, v in doc.items() if k not in CLOCK}
    return doc


def _script(prof, tmp_path, monkeypatch, fail=None):
    """tests/test_obs.py's call sequence on package ``prof``'s hook;
    ``fail`` makes the seam's start or stop raise."""
    calls = []

    def start(d):
        if fail == "start":
            raise RuntimeError("no profiler")
        calls.append(("start", str(d).startswith(str(tmp_path))))

    def stop():
        calls.append(("stop",))
        if fail == "stop":
            raise RuntimeError("stop failed")

    monkeypatch.setattr(prof, "_trace_api", lambda: (start, stop))
    h = prof.ProfilerHook(tmp_path, max_seconds=60)
    docs = [h.status(), h.start(5), h.start(), h.status()]
    stale_gen = h._gen
    docs += [h.stop(), h.stop(), h.start(5), h.stop(gen=stale_gen),
             h.stop(), h.start(999), h.stop(), h.start("x"), h.status()]
    return [_scrub(d) for d in docs], calls


@pytest.mark.parametrize("fail", [None, "start", "stop"])
def test_seam_calls_and_status_documents_are_equal(tmp_path, monkeypatch, fail):
    got = {name: _script(p, tmp_path / name, monkeypatch, fail)
           for name, p in PKG.items()}
    assert repr(got["port"]) == repr(got["jax"])
    docs, calls = got["port"]
    if fail is None:
        assert docs[1]["profiling"] is True and docs[1]["seconds"] == 5
        assert docs[2]["error"] == "capture already running"
        assert docs[7]["profiling"] is True  # the stale watchdog no-ops
        assert docs[9]["seconds"] == 60  # the bound clamps over-asks
        assert [c[0] for c in calls] == ["start", "stop"] * 3
        assert all(c[1] for c in calls if c[0] == "start")


def test_real_capture_on_the_cpu(tmp_path):
    """A capture started on one thread and auto-stopped by its watchdog
    on another: ``trace.json`` lands in the capture directory, holds the
    op that ran meanwhile, and the hook is free again."""
    h = tprof.ProfilerHook(tmp_path, max_seconds=1.0)
    box = {}
    t = threading.Thread(target=lambda: box.update(doc=h.start(0.5)))
    t.start()
    t.join()
    assert box["doc"]["profiling"] is True, box["doc"]
    x = torch.ones(16, 16)
    for _ in range(3):
        x = x @ x
    deadline = time.monotonic() + 10.0
    while h.status()["profiling"] and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not h.status()["profiling"]
    trace = tmp_path.glob("profile-*/" + tprof.TRACE_FILE)
    trace = list(trace)
    assert len(trace) == 1
    names = {e.get("name") for e in json.loads(trace[0].read_text())
             ["traceEvents"]}
    assert "aten::mm" in names
    summary = tprof.device_summary(trace[0])
    assert summary["device_events"] == 0 and summary["busy_share"] is None
    again = h.start(0.2)
    assert "error" not in again
    assert h.stop()["profiling"] is False


def _capture_on_threads(h, seconds=5.0):
    """``h.start`` on one thread, an op on this one, ``h.stop`` on a
    third: the stop's status document."""
    box = {}
    t = threading.Thread(target=lambda: box.update(doc=h.start(seconds)))
    t.start()
    t.join()
    assert box["doc"]["profiling"] is True, box["doc"]
    x = torch.ones(8, 8)
    for _ in range(2):
        x = x @ x
    t = threading.Thread(target=lambda: box.update(doc=h.stop()))
    t.start()
    t.join()
    return box["doc"]


def test_another_session_refuses_a_start_and_a_later_capture_runs(tmp_path):
    """A ``torch.profiler`` session on the main thread, as a caller's own
    timing makes: a hook start meanwhile is refused with an error (two
    sessions in one process are never run together) and leaves the hook
    free; after the session, a capture started and stopped on two other
    threads writes its trace."""
    from torch.profiler import ProfilerActivity, profile

    h = tprof.ProfilerHook(tmp_path, max_seconds=5.0)
    with profile(activities=[ProfilerActivity.CPU]):
        torch.ones(4) + 1
        doc = h.start(1.0)
    assert "another torch.profiler session" in doc["error"], doc
    assert h.status()["profiling"] is False
    stopped = _capture_on_threads(h)
    assert stopped["profiling"] is False and "error" not in stopped
    trace = Path(stopped["stopped"]["capture_dir"]) / tprof.TRACE_FILE
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert "aten::mm" in names


def test_device_summary_counts_kernels_and_merges_overlaps(tmp_path):
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30,
         "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 99},
    ]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(doc))
    s = tprof.device_summary(p, wall_s=100e-6)
    assert s["kernels"] == {"k_a": 2}
    assert s["device_events"] == 3
    assert s["sum_s"] == 25e-6 and s["busy_s"] == 20e-6
    assert s["busy_share"] == 0.2


@pytest.mark.parametrize("sep", [" ", "\n    "])
def test_device_summary_reads_kineto_layout_by_pattern(tmp_path, sep):
    """A capture in kineto's layout (fields on one line or one a line)
    reads by the pattern, equal to reading it as JSON."""
    rows = [("kernel", 'void (anonymous namespace)::k_hash_keys<4>(int, "q")',
             100.5, 3.25),
            ("cpu_op", "aten::add", 99.0, 10.0),
            ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 104.0, 1.5),
            ("kernel", "k_compact1", 200.0, 2.0)]
    body = ",\n".join(
        "  {" + sep + f'"ph": "X",{sep}"cat": "{cat}",{sep}'
        f'"name": {json.dumps(name)},{sep}"pid": 1,{sep}"tid": 7,{sep}'
        f'"ts": {ts},{sep}"dur": {dur}{sep},{sep}"args": {{"x": 1}}' + "\n  }"
        for cat, name, ts, dur in rows)
    p = tmp_path / "t.json"
    p.write_text('{\n  "schemaVersion": 1,\n  "traceEvents": [\n' + body
                 + '\n]}\n')
    assert tprof._KINETO_DEVICE_EVENT.search(p.read_bytes())
    s = tprof.device_summary(p)
    assert s["kernels"] == {
        'void (anonymous namespace)::k_hash_keys<4>(int, "q")': 1,
        "k_compact1": 1}
    assert s["device_events"] == 3
    assert s["busy_s"] == pytest.approx(6.75e-6)
    assert s["wall_s"] == pytest.approx(101.5e-6)
    # the same events as JSON in another key order read alike
    doc = json.loads(p.read_text())
    q = tmp_path / "plain.json"
    q.write_text(json.dumps(doc, sort_keys=True))
    assert not tprof._KINETO_DEVICE_EVENT.search(q.read_bytes())
    assert tprof.device_summary(q) == s


def test_device_summary_reads_json_where_the_pattern_misses_events(tmp_path):
    """Kineto's layout with one device event whose fields come in
    another order: the pattern finds the others only, so the whole
    trace is read as JSON and no event is dropped."""
    rows = ['{"ph": "X", "cat": "kernel", "name": "k_a", "pid": 1, '
            '"tid": 7, "ts": 0, "dur": 10}',
            '{"ph": "X", "cat": "kernel", "name": "k_b", "pid": 1, '
            '"tid": 7, "extra": 1, "ts": 20, "dur": 5}',
            '{"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 1, '
            '"tid": 7, "ts": 30, "dur": 2}']
    p = tmp_path / "t.json"
    p.write_text('{"traceEvents": [\n' + ",\n".join(rows) + "\n]}")
    assert len(tprof._KINETO_DEVICE_EVENT.findall(p.read_bytes())) == 2
    s = tprof.device_summary(p)
    assert s["kernels"] == {"k_a": 1, "k_b": 1}
    assert s["device_events"] == 3
    assert s["busy_s"] == pytest.approx(17e-6)
