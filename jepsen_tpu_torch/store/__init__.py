"""The run store's paths and writes that the checkers use.

A copy of the part of the JAX package's ``store`` package that the
checkers, the engines and the check service need: a test's directory
(``<store-dir>/<name>/<start-time-str>``), the directory-name
timestamp (``time_str``, which stamps the service's drain dirs), atomic
JSON and history writes and the JSON form of what they write
(``_jsonable``).
``store.durable`` wraps artifacts in checksummed envelopes (and holds
``canonical_bytes``, what checksums and digests hash), and
``store.checkpoint`` keeps the engines' checkpoints and the histories'
``fingerprint``; the test-map phases (``save_0``..``save_2``), the block
file format and the readers wait for ROADMAP queue A10.

Every ``_atomic_write`` step announces itself through
``faults.INJECT`` (the crashpoint seam, as in the JAX package).  The
package imports no torch: the confirmation workers import it.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Mapping, Sequence

BASE_DIR = Path("store")


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
