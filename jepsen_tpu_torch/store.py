"""The run store's paths and writes that the checkers use.

A copy of the part of the JAX package's ``store`` that the checkers
need: a test's directory (``<store-dir>/<name>/<start-time-str>``),
atomic JSON and history writes, and the canonical JSON forms the
evidence digests hash (``fingerprint``, the list-of-dicts branch of
``store.checkpoint.fingerprint``; ``canonical_bytes``, of
``store.durable``).  The rest of the store (checkpoints, durable
envelopes, evidence bundles on disk) is ROADMAP queue A6.
"""

from __future__ import annotations

import hashlib
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


def test_dir(test: Mapping) -> Path:
    return base_dir(test) / str(test["name"]) / str(test["start-time-str"])


def _jsonable(x: Any):
    if isinstance(x, Mapping):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
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


def _atomic_write(path: Path, data: str | bytes):
    """tmp + fsync + rename + dir fsync: a reader never sees a torn file,
    and a completed write survives a power cut.  The tmp name is unique
    per writer (mkstemp), so concurrent writers of one path stay
    last-writer-wins, each write atomic."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(
        dir=str(path.parent or "."), prefix=path.name + ".", suffix=".tmp"
    )
    binary = isinstance(data, (bytes, bytearray))
    try:
        with os.fdopen(fd, "wb" if binary else "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o644)  # mkstemp's 0600 would hide artifacts from other readers
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
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


def fingerprint(histories: Sequence[Sequence[Mapping]]) -> str:
    """A stable identity for the checked inputs: sha256 over every op's
    (type, process, f, value) in order, per history."""
    h = hashlib.sha256()
    for hist in histories:
        h.update(b"\x00")
        for o in hist:
            h.update(
                json.dumps(
                    [
                        _jsonable(o.get("type")),
                        _jsonable(o.get("process")),
                        _jsonable(o.get("f")),
                        _jsonable(o.get("value")),
                    ],
                    separators=(",", ":"),
                    default=str,
                ).encode()
            )
    return h.hexdigest()


def canonical_bytes(payload) -> bytes:
    """Sorted-key, separator-free canonical JSON of a payload (stable
    across dict insertion order and whitespace): what digests hash."""
    return json.dumps(
        _jsonable(payload), sort_keys=True, separators=(",", ":"), default=str,
    ).encode()
