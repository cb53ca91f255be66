"""Persistence: where test runs live on disk.

The port's copy of the JAX package's ``store`` package, which mirrors
``jepsen.store`` (reference: jepsen/src/jepsen/store.clj): each run gets
``<store-dir>/<name>/<start-time-str>/`` (store.clj:33-68) holding the
test map, the history and the results, with ``latest`` symlinks at both
levels (store.clj:282-319).  Writes happen in three phases, as in the
reference's crash-safety story (store.clj:375-420):

  save_0 — initial test map, before anything runs
  save_1 — the history, as soon as the run ends (pre-analysis: a crash in
           a checker must never lose the history)
  save_2 — the results, and the block file sealed

Formats: the test map and results are JSON (live objects stripped,
``serializable_test``); the history is JSON-lines plus the
human-readable ``history.txt``; ``run.jepsen`` is the block file of
``store.format``, which the JAX package reads and writes alike.  The
readers (``iter_runs``, ``tests``, ``load``, ``load_dir``, ``peek_dir``,
``latest``) serve the web UI.  ``store.durable`` wraps artifacts in
checksummed envelopes (and holds ``canonical_bytes``, what checksums and
digests hash), and ``store.checkpoint`` keeps the engines' checkpoints
and the histories' ``fingerprint``.

Every ``_atomic_write`` step announces itself through
``faults.INJECT`` (the crashpoint seam, as in the JAX package).  The
package imports no torch: the confirmation workers import it.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Mapping, Sequence

logger = logging.getLogger(__name__)

BASE_DIR = Path("store")

#: Test-map keys that can't/shouldn't be serialized (functions, live
#: objects) — store.clj:92-104.
NONSERIALIZABLE_KEYS = (
    "db", "os", "net", "client", "nemesis", "checker", "generator", "remote",
    "sessions", "barrier", "store",
)


def base_dir(test_or_opts: Mapping | None = None) -> Path:
    if test_or_opts and test_or_opts.get("store-dir"):
        return Path(test_or_opts["store-dir"])
    return BASE_DIR


def time_str(t: _dt.datetime | None = None) -> str:
    """Directory-name timestamp (store.clj:45-50)."""
    t = t or _dt.datetime.now()
    return t.strftime("%Y%m%dT%H%M%S.%f")[:-3] + "Z"


def test_dir(test: Mapping) -> Path:
    return base_dir(test) / str(test["name"]) / str(test["start-time-str"])


def _jsonable(x: Any):
    if isinstance(x, Mapping):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in x]
    from jepsen_tpu_torch import history as _h

    if isinstance(x, _h.ColumnHistory):
        return [_jsonable(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    import numpy as np

    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def serializable_test(test: Mapping) -> dict:
    """The test map minus live objects (store.clj:92-104)."""
    return _jsonable({k: v for k, v in test.items() if k not in NONSERIALIZABLE_KEYS})


def _fsync_dir(d: Path) -> None:
    """fsync a directory so a just-renamed entry survives a power cut."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:  # pragma: no cover - platforms without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - fs without dir fsync
        pass
    finally:
        os.close(fd)


def _write_seam(step: str, path) -> None:
    """The crashpoint seam: each ``_atomic_write`` step announces itself
    through ``faults.INJECT`` (ctx ``what="store.atomic_write"``, ``step``
    one of post-tmp, post-fsync, post-rename, pre-dir-fsync), so a test
    can die at exactly that step."""
    from jepsen_tpu_torch import faults

    hook = faults.INJECT
    if hook is not None:
        hook({"what": "store.atomic_write", "step": step,
              "path": str(path)}, 0)


def _atomic_write(path: Path, data: str | bytes):
    """tmp + fsync + rename + dir fsync: a reader never sees a torn file,
    and a completed write survives a power cut.  The tmp name is unique
    per writer (mkstemp), so concurrent writers of one path stay
    last-writer-wins, each write atomic; a crashed writer's ``*.tmp`` is
    reclaimed by ``durable.sweep_tmp``.  A ``faults.CrashPoint`` raised
    in a write seam simulates a death at that step: no cleanup runs."""
    from jepsen_tpu_torch import faults

    path = Path(path)
    fd, tmp = tempfile.mkstemp(
        dir=str(path.parent or "."), prefix=path.name + ".", suffix=".tmp"
    )
    binary = isinstance(data, (bytes, bytearray))
    try:
        with os.fdopen(fd, "wb" if binary else "w") as f:
            f.write(data)
            f.flush()
            _write_seam("post-tmp", path)
            os.fsync(f.fileno())
        _write_seam("post-fsync", path)
        os.chmod(tmp, 0o644)  # mkstemp's 0600 would hide artifacts from other readers
        os.replace(tmp, path)
    except BaseException as e:
        if not isinstance(e, faults.CrashPoint):
            with contextlib.suppress(OSError):
                os.unlink(tmp)
        raise
    _write_seam("post-rename", path)
    _write_seam("pre-dir-fsync", path)
    _fsync_dir(path.parent)


def _write_json(path: Path, obj):
    _atomic_write(path, json.dumps(_jsonable(obj), indent=1))


def write_history(d: Path, history: Sequence[Mapping]):
    """history.jsonl (machine) + history.txt (human), as store.clj:384-399
    writes both forms."""
    lines = [json.dumps(_jsonable(o), separators=(",", ":")) for o in history]
    _atomic_write(d / "history.jsonl", "\n".join(lines) + ("\n" if lines else ""))
    txt = []
    for o in history:
        txt.append(
            f"{o.get('index', ''):>8} {str(o.get('process', '')):>8} "
            f"{o.get('type', ''):<8} {str(o.get('f', '')):<16} {o.get('value', '')!r}"
        )
    _atomic_write(d / "history.txt", "\n".join(txt) + ("\n" if txt else ""))


def _run_file(d: Path) -> Path:
    return d / "run.jepsen"


def save_0(test: Mapping) -> Mapping:
    """Write the initial test map; returns test with paths filled
    (store.clj:375-382)."""
    from jepsen_tpu_torch.store import format as fmt

    d = test_dir(test)
    d.mkdir(parents=True, exist_ok=True)
    # Store open is the sweep point for ``*.tmp`` orphans a crashed
    # writer left in this run dir (age-gated: a concurrently-writing
    # composed checker's live tmp survives).
    from jepsen_tpu_torch.store import durable as _durable

    _durable.sweep_tmp(d, what="store")
    _write_json(d / "test.json", serializable_test(test))
    w = fmt.Writer(_run_file(d))
    w.write_test(test)
    update_symlinks(test)
    return test


def save_1(test: Mapping) -> Mapping:
    """Write the history immediately after the run — BEFORE analysis, so a
    crash in a checker can never lose it (store.clj:384-399)."""
    from jepsen_tpu_torch.store import format as fmt

    d = test_dir(test)
    d.mkdir(parents=True, exist_ok=True)
    _write_json(d / "test.json", serializable_test(test))
    write_history(d, test.get("history") or [])
    w = fmt.Writer(_run_file(d))
    if not any(b["type"] == fmt.T_TEST for b in w.index["blocks"]):
        w.write_test(test)
    w.write_history(test.get("history") or [])
    return test


def save_2(test: Mapping) -> Mapping:
    """Write the results and seal the block file (store.clj:401-419)."""
    from jepsen_tpu_torch.store import format as fmt

    d = test_dir(test)
    d.mkdir(parents=True, exist_ok=True)
    _write_json(d / "results.json", test.get("results") or {})
    w = fmt.Writer(_run_file(d))
    # A dir stored before the block format (or whose file was lost) gets a
    # complete file, not a results-only one that would shadow the JSON
    # artifacts in load_dir.
    if not any(b["type"] == fmt.T_TEST for b in w.index["blocks"]):
        w.write_test(test)
    if not any(b["type"] == fmt.T_HISTORY for b in w.index["blocks"]) and test.get("history"):
        w.write_history(test["history"])
    w.write_results(test.get("results") or {})
    w.close()
    update_symlinks(test)
    return test


def update_symlinks(test: Mapping):
    """Maintain <name>/latest and store/latest (store.clj:282-319)."""
    d = test_dir(test)
    for link in (d.parent / "latest", base_dir(test) / "latest"):
        try:
            if link.is_symlink() or link.exists():
                link.unlink()
            link.parent.mkdir(parents=True, exist_ok=True)
            link.symlink_to(os.path.relpath(d, link.parent))
        except OSError:  # pragma: no cover - symlinks may be unsupported
            logger.debug("couldn't update symlink %s", link, exc_info=True)


# ---------------------------------------------------------------------------
# Reading (store.clj:121-246)
# ---------------------------------------------------------------------------


def iter_runs(store_dir=None):
    """Yield ``(name, timestamp, run_dir, mtime_ns)`` for every stored
    run — the ONE store-directory enumeration (dir, non-symlink, two
    levels) that ``tests()`` and the web dashboard's cached run index
    both consume, so what counts as "a run" can never diverge between
    the API and the UI."""
    base = base_dir({"store-dir": store_dir} if store_dir else None)
    if not base.exists():
        return
    for name_dir in sorted(base.iterdir()):
        if not name_dir.is_dir() or name_dir.is_symlink():
            continue
        for run in sorted(name_dir.iterdir()):
            if not run.is_dir() or run.is_symlink():
                continue
            try:
                mt = run.stat().st_mtime_ns
            except OSError:
                continue
            yield name_dir.name, run.name, run, mt


def tests(name: str | None = None, store_dir=None) -> dict:
    """{name: {timestamp: path}} of stored runs (store.clj:121-160)."""
    out: dict = {}
    for n, ts, run, _mt in iter_runs(store_dir=store_dir):
        if name is not None and n != name:
            continue
        out.setdefault(n, {})[ts] = run
    return out


def load(name: str, timestamp: str, store_dir=None) -> dict:
    """Load a stored test (test map + history + results)
    (store.clj:196-246)."""
    base = base_dir({"store-dir": store_dir} if store_dir else None)
    d = base / name / timestamp
    return load_dir(d)


def load_dir(d: Path) -> dict:
    d = Path(d)
    run = d / "run.jepsen"
    if run.exists():
        from jepsen_tpu_torch.store import format as fmt

        try:
            idx = fmt.read_index(run)
            test = fmt.read(run, index=idx, history=False)
            cols, fs, extras = fmt.read_columns(run, index=idx)
            from jepsen_tpu_torch import history as _history

            if len(cols["index"]):
                # the zero-copy path: ops materialize lazily; kernels and
                # vectorized consumers read the columns directly
                test["history"] = _history.ColumnHistory(cols, fs, extras)
            test["dir"] = str(d)
            return test
        except fmt.CorruptFile:
            logger.warning("corrupt %s; falling back to JSON artifacts", run)
    test = json.loads((d / "test.json").read_text()) if (d / "test.json").exists() else {}
    hist_path = d / "history.jsonl"
    if hist_path.exists():
        test["history"] = [
            json.loads(line) for line in hist_path.read_text().splitlines() if line
        ]
    res_path = d / "results.json"
    if res_path.exists():
        test["results"] = json.loads(res_path.read_text())
    test["dir"] = str(d)
    return test


def peek_dir(d: Path) -> dict:
    """Cheap metadata read: name / start-time / valid? / op-count WITHOUT
    loading history or results — the block file footer when present
    (store/format.py read_index), else the small JSON artifacts.  This is
    what the web test table and `test-all` summaries use."""
    d = Path(d)
    run = d / "run.jepsen"
    if run.exists():
        from jepsen_tpu_torch.store import format as fmt

        try:
            idx = fmt.read_index(run)
            return {
                "name": idx.get("name"),
                "start-time-str": idx.get("start-time"),
                "valid?": idx.get("valid?"),
                "op-count": idx.get("op-count"),
                "dir": str(d),
            }
        except fmt.CorruptFile:
            pass
    out: dict = {"dir": str(d)}
    try:
        t = json.loads((d / "test.json").read_text())
        out["name"] = t.get("name")
        out["start-time-str"] = t.get("start-time-str")
    except (OSError, ValueError):
        pass
    try:
        out["valid?"] = json.loads((d / "results.json").read_text()).get("valid?")
    except (OSError, ValueError):
        out.setdefault("valid?", None)
    return out


def latest(store_dir=None) -> dict | None:
    """The most recent run across all tests (store.clj:282-291)."""
    base = base_dir({"store-dir": store_dir} if store_dir else None)
    link = base / "latest"
    if link.exists():
        return load_dir(link.resolve())
    newest = None
    for name, runs in tests(store_dir=store_dir).items():
        for ts, path in runs.items():
            if newest is None or ts > newest[0]:
                newest = (ts, path)
    return load_dir(newest[1]) if newest else None


def delete(name: str | None = None, store_dir=None):
    """Delete stored runs (store.clj:248-266)."""
    base = base_dir({"store-dir": store_dir} if store_dir else None)
    target = base / name if name else base
    if target.exists():
        shutil.rmtree(target)


@contextlib.contextmanager
def capture_logging(test: Mapping, filename: str = "jepsen.log"):
    """Tee the harness log to ``store/<name>/<time>/<filename>`` for the
    duration (reference: jepsen/src/jepsen/store.clj:436-464 — unilog
    writes the run's console log to jepsen.log so a stored run carries
    its own post-mortem record; jepsen.web serves it).

    The file captures INFO+ regardless of the console level; existing
    handlers keep their previous effective threshold so console output
    is unchanged.
    """
    d = test_dir(test)
    d.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(d / filename, encoding="utf-8")
    handler.setLevel(logging.INFO)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-7s [%(name)s] %(message)s")
    )
    root = logging.getLogger()
    old_level = root.level
    bumped: list[tuple[logging.Handler, int]] = []
    if root.getEffectiveLevel() > logging.INFO:
        # Lower the root gate so INFO records reach our handler, but pin
        # the previous threshold onto the other handlers.
        for hh in root.handlers:
            if hh.level < root.getEffectiveLevel():
                bumped.append((hh, hh.level))
                hh.setLevel(root.getEffectiveLevel())
        root.setLevel(logging.INFO)
    root.addHandler(handler)
    try:
        yield d / filename
    finally:
        root.removeHandler(handler)
        handler.close()
        root.setLevel(old_level)
        for hh, lvl in bumped:
            hh.setLevel(lvl)
