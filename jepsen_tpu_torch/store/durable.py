"""Durable records: checksummed, versioned, migratable persistence.

The port's copy of the JAX package's ``store.durable``.  Every durable
artifact (the ladder, chunk and stream checkpoints of
``store.checkpoint``, the evidence bundles of ``obs.provenance``) rides
``store._atomic_write``'s tmp + fsync + rename + dir-fsync contract,
which protects against torn writes but not against bit rot, hand edits
or a version bump.  This module is the envelope they share:

  * ``write_record`` wraps a JSON payload in ``{durable, kind, version,
    crc32, payload, files}``: a CRC32 over the canonical payload bytes,
    a schema version, the artifact kind and, for json/npz pairs, a
    per-sibling-file digest manifest, so a checkpoint's json proves
    which npz it belongs to.
  * ``read_verified`` detects truncation, bit flips, kind confusion and
    stale siblings; a corrupt artifact is quarantined aside
    (``<name>.corrupt-<n>``, kept as evidence) and the raised
    ``DurableError`` carries a machine-readable report.  Files without
    an envelope read through the migration path below.
  * A migration registry keyed by ``(kind, version)`` upgrades old
    payloads in memory at read time.
  * ``seal_line``/``check_line`` give append-only JSONL files a
    per-record checksum (one extra ``"crc"`` key per line).
  * ``file_lock`` is an exclusive advisory lock across processes, and
    ``sweep_tmp`` reclaims the ``*.tmp`` orphans a crashed writer left,
    gated on age so a live writer's tmp is never swept.

The bytes written equal the JAX package's for the same payload, and each
package reads the other's records.  The JAX package's ``durable.*``
counters are left out with the telemetry.  Imports no torch.
"""

from __future__ import annotations

import contextlib
import json
import os
import zlib
from pathlib import Path
from typing import Callable, Mapping

from jepsen_tpu_torch import obs

#: envelope schema marker (the outer format; payload schemas version
#: independently per kind).
ENVELOPE = 1

#: current payload version per registered kind (``register_kind``).
CURRENT: dict[str, int] = {}

#: ``(kind, from_version) -> fn(payload) -> (payload, to_version)``
#: upgrade steps, chained by ``read_verified`` until the payload reaches
#: ``CURRENT[kind]``.
MIGRATIONS: dict[tuple[str, int], Callable] = {}


def register_kind(kind: str, version: int) -> None:
    """Declare ``kind``'s current payload version."""
    CURRENT[str(kind)] = int(version)


def register_migration(kind: str, from_version: int,
                       fn: Callable | None = None):
    """Register an upgrade step for ``(kind, from_version)``: ``fn``
    takes the old payload dict and returns ``(new_payload,
    new_version)``.  Usable as a decorator."""
    def _reg(f):
        MIGRATIONS[(str(kind), int(from_version))] = f
        return f

    return _reg if fn is None else _reg(fn)


class DurableError(Exception):
    """A durable artifact failed verification or has no migration path.

    ``report`` is the machine-readable report; ``reason`` its short code
    (``missing`` / ``unreadable`` / ``unparseable`` / ``crc-mismatch`` /
    ``wrong-kind`` / ``missing-sibling`` / ``sibling-crc-mismatch`` /
    ``no-migration-path``)."""

    def __init__(self, message: str, report: Mapping):
        self.report = dict(report)
        self.reason = str(self.report.get("reason") or "corrupt")
        super().__init__(message)


class ReadResult:
    """What ``read_verified`` returns: the (possibly migrated) payload
    and where it came from."""

    __slots__ = ("payload", "kind", "version", "migrated", "legacy",
                 "path", "files")

    def __init__(self, *, payload, kind, version, migrated, legacy, path,
                 files):
        self.payload = payload
        self.kind = kind
        self.version = version      # version as read, before migration
        self.migrated = migrated    # a migration step ran
        self.legacy = legacy        # a file without an envelope
        self.path = path
        self.files = files          # the envelope's sibling manifest


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------


def canonical_bytes(payload) -> bytes:
    """Sorted-key, separator-free canonical JSON of a payload (stable
    across dict insertion order and whitespace): what the payload CRC
    and the evidence digests hash."""
    from jepsen_tpu_torch import store as _store

    return json.dumps(
        _store._jsonable(payload), sort_keys=True, separators=(",", ":"),
        default=str,
    ).encode()


def payload_crc(payload) -> int:
    return zlib.crc32(canonical_bytes(payload)) & 0xFFFFFFFF


def digest_bytes(data: bytes) -> dict:
    """The manifest entry for a sibling file written as ``data``."""
    return {"crc32": zlib.crc32(data) & 0xFFFFFFFF, "bytes": len(data)}


def file_digest(path) -> dict:
    """Streamed ``digest_bytes`` of a file on disk."""
    crc = 0
    n = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return {"crc32": crc & 0xFFFFFFFF, "bytes": n}


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def envelope(kind: str, payload, *, version: int | None = None,
             files: Mapping[str, Mapping] | None = None) -> dict:
    """The envelope dict for ``payload``: checksum, version and kind, and
    the sibling-file digest manifest."""
    v = CURRENT.get(str(kind)) if version is None else int(version)
    if v is None:
        raise KeyError(f"unregistered durable kind {kind!r}; call "
                       "register_kind first or pass version=")
    doc = {
        "durable": ENVELOPE,
        "kind": str(kind),
        "version": int(v),
        "crc32": payload_crc(payload),
        "payload": payload,
    }
    if files:
        doc["files"] = {str(k): dict(d) for k, d in files.items()}
    return doc


def dumps_record(kind: str, payload, *, version: int | None = None,
                 files: Mapping[str, Mapping] | None = None,
                 indent: int | None = 1) -> str:
    from jepsen_tpu_torch import store as _store

    return json.dumps(
        _store._jsonable(envelope(kind, payload, version=version,
                                  files=files)),
        indent=indent, default=str,
    )


def write_record(path, kind: str, payload, *, version: int | None = None,
                 files: Mapping[str, Mapping] | None = None) -> Path:
    """Persist an enveloped record atomically (``store._atomic_write``)."""
    from jepsen_tpu_torch import store as _store

    path = Path(path)
    _store._atomic_write(
        path, dumps_record(kind, payload, version=version, files=files)
    )
    return path


# ---------------------------------------------------------------------------
# Quarantine
# ---------------------------------------------------------------------------


def quarantine_path(path) -> Path:
    """The first free ``<name>.corrupt-<n>`` slot next to ``path``."""
    path = Path(path)
    n = 0
    while True:
        cand = path.with_name(f"{path.name}.corrupt-{n}")
        if not cand.exists():
            return cand
        n += 1


def quarantine_file(path, *, reason: str = "corrupt",
                    kind: str = "?") -> str | None:
    """Move a corrupt artifact aside to ``<name>.corrupt-<n>`` (evidence
    for the operator, out of every reader's glob).  Returns the
    quarantine path, or None when the move itself failed (the original
    stays, and readers keep rejecting it on its checksum)."""
    path = Path(path)
    try:
        dest = quarantine_path(path)
        os.replace(path, dest)
    except OSError:
        obs.counter("durable.quarantine_error", kind=kind, reason=reason)
        return None
    obs.counter("durable.corrupt", kind=kind, reason=reason,
                path=str(path), quarantined_to=str(dest))
    return str(dest)


def _report(kind: str, path, reason: str, **extra) -> dict:
    out = {"artifact": str(kind), "path": str(path), "reason": reason}
    out.update(extra)
    return out


def _corrupt(kind: str, path, reason: str, *, quarantine: bool = True,
             siblings: list | None = None, **extra) -> DurableError:
    """Quarantine ``path`` (and any named siblings) and build the
    DurableError carrying the report."""
    quarantined = []
    if quarantine:
        for p in [path] + list(siblings or ()):
            if Path(p).exists():
                q = quarantine_file(p, reason=reason, kind=kind)
                if q:
                    quarantined.append(q)
    rep = _report(kind, path, reason, quarantined_to=quarantined, **extra)
    return DurableError(
        f"corrupt {kind} at {path}: {reason}"
        + (f" (quarantined to {', '.join(quarantined)})" if quarantined
           else ""),
        rep,
    )


# ---------------------------------------------------------------------------
# Reading and migration
# ---------------------------------------------------------------------------


def read_verified(path, kind: str, *, quarantine: bool = True,
                  legacy_version: Callable | int | None = None) -> ReadResult:
    """Read, verify and migrate one enveloped JSON artifact.

    Verification: the JSON parses, the envelope names this ``kind``, the
    payload CRC matches, and every sibling in the ``files`` manifest
    exists with matching size and CRC.  A failure quarantines the
    artifact (and the listed siblings) and raises ``DurableError`` with
    the report.  A file without an envelope is a legacy artifact: its
    whole document is the payload and its version is ``legacy_version``
    (an int, or a callable over the document; by default the document's
    own ``"version"``, else 0), carried forward by the migration
    registry.  ``reason="no-migration-path"`` means a version this build
    cannot read; nothing is quarantined for that."""
    path = Path(path)
    if not path.exists():
        raise DurableError(f"no {kind} at {path}",
                           _report(kind, path, "missing"))
    try:
        raw = path.read_bytes()
    except OSError as e:
        raise DurableError(f"unreadable {path}: {e}",
                           _report(kind, path, "unreadable",
                                   error=str(e))) from e
    try:
        # strict decode, then parse: bytes outside UTF-8 are as corrupt
        # as bad JSON
        doc = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise _corrupt(kind, path, "unparseable", quarantine=quarantine,
                       error=str(e)) from e
    if not isinstance(doc, dict):
        raise _corrupt(kind, path, "unparseable", quarantine=quarantine,
                       error="top-level JSON is not an object")
    legacy = "durable" not in doc or "payload" not in doc
    migrated = False
    files = {}
    if legacy:
        payload = doc
        if callable(legacy_version):
            version = int(legacy_version(doc))
        elif legacy_version is not None:
            version = int(legacy_version)
        else:
            v = doc.get("version")
            version = int(v) if isinstance(v, (int, float)) else 0
    else:
        if doc.get("kind") != kind:
            raise _corrupt(kind, path, "wrong-kind", quarantine=quarantine,
                           found_kind=doc.get("kind"))
        payload = doc.get("payload")
        want = doc.get("crc32")
        got = payload_crc(payload)
        if want != got:
            raise _corrupt(kind, path, "crc-mismatch",
                           quarantine=quarantine,
                           expected_crc=want, actual_crc=got)
        version = int(doc.get("version") or 0)
        files = doc.get("files") or {}
        for name, want_d in files.items():
            sib = path.parent / name
            if not sib.exists():
                raise _corrupt(kind, path, "missing-sibling",
                               quarantine=quarantine, sibling=name)
            got_d = file_digest(sib)
            if (int(want_d.get("bytes", -1)) != got_d["bytes"]
                    or int(want_d.get("crc32", -1)) != got_d["crc32"]):
                raise _corrupt(
                    kind, path, "sibling-crc-mismatch",
                    quarantine=quarantine, siblings=[sib], sibling=name,
                    expected=dict(want_d), actual=got_d,
                )
    current = CURRENT.get(kind)
    read_version = version
    while current is not None and version != current:
        fn = MIGRATIONS.get((kind, version))
        if fn is None:
            raise DurableError(
                f"{kind} at {path} is version {version}; this build "
                f"reads version {current} and has no migration from "
                f"{version}",
                _report(kind, path, "no-migration-path",
                        found_version=version, current_version=current),
            )
        payload, version = fn(payload)
        version = int(version)
        migrated = True
    if migrated:
        obs.counter("durable.migrated", kind=kind,
                    from_version=read_version, to_version=version)
    return ReadResult(payload=payload, kind=kind, version=read_version,
                      migrated=migrated, legacy=legacy, path=str(path),
                      files=files)


# ---------------------------------------------------------------------------
# Per-record checksums of JSONL files
# ---------------------------------------------------------------------------


def seal_line(record: Mapping) -> dict:
    """``record`` plus a ``"crc"`` key: CRC32 over the canonical bytes of
    the record without the crc key (so sealing is idempotent)."""
    out = {k: v for k, v in dict(record).items() if k != "crc"}
    out["crc"] = payload_crc(out)
    return out


def check_line(record: Mapping) -> tuple[bool, bool]:
    """``(ok, legacy)`` for one parsed JSONL record: lines without a
    ``"crc"`` pass as legacy; sealed lines must match their checksum."""
    if not isinstance(record, Mapping):
        return False, False
    if "crc" not in record:
        return True, True
    body = {k: v for k, v in record.items() if k != "crc"}
    return record["crc"] == payload_crc(body), False


# ---------------------------------------------------------------------------
# Cross-process advisory locking
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def file_lock(path, *, timeout_s: float | None = None):
    """Exclusive ``fcntl.flock`` advisory lock on ``path`` (created if
    missing) for the scope: the cross-process companion of in-process
    locks.  The lock file is a sidecar, never the record itself
    (``write_record`` replaces records by rename, and a lock on a
    renamed-away inode excludes nobody), and is never unlinked.
    ``timeout_s`` bounds the wait (``TimeoutError`` after it); None
    blocks."""
    import fcntl  # POSIX only; imported here so importing never fails

    path = Path(path)
    fd = os.open(str(path), os.O_RDWR | os.O_CREAT, 0o644)
    try:
        if timeout_s is None:
            fcntl.flock(fd, fcntl.LOCK_EX)
        else:
            import time as _time

            deadline = _time.monotonic() + float(timeout_s)
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except OSError:
                    if _time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"file_lock timed out after {timeout_s}s: {path}"
                        ) from None
                    _time.sleep(0.005)
        yield
    finally:
        with contextlib.suppress(OSError):
            fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


# ---------------------------------------------------------------------------
# Orphaned-tmp sweep
# ---------------------------------------------------------------------------


def sweep_tmp(d, *, min_age_s: float = 60.0, what: str = "store") -> int:
    """Remove the ``*.tmp`` orphans a crashed writer left in ``d``.
    ``min_age_s`` gates on mtime so a live concurrent writer's tmp is
    never swept (0 for a directory the caller owns alone).  ``what``
    names the caller (the JAX package's telemetry label).  Returns the
    count removed."""
    d = Path(d)
    if not d.is_dir():
        return 0
    import time as _time

    now = _time.time()
    n = 0
    for p in d.glob("*.tmp"):
        try:
            if min_age_s > 0 and now - p.stat().st_mtime < min_age_s:
                continue
        except OSError:
            continue
        with contextlib.suppress(OSError):
            p.unlink()
            n += 1
    if n:
        obs.counter("durable.tmp_swept", n, what=what, dir=str(d))
    return n
