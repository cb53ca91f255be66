"""Checkpoint and resume: the engines' durable state on disk.

The port's copy of the JAX package's ``store.checkpoint``; the files it
writes are the JAX package's, and each package loads the other's.
``parallel.batch_analysis`` persists the ladder's durable state after
every stage, so a killed run resumes at the saved rung with the saved
frontiers and gives the verdicts of an uninterrupted run:

  ``checker-checkpoint.json``  the control state: the ladder config
      (engine, capacity ladders, rounds, dedup backend, confirmation
      mode) with a history fingerprint, the stage cursor, the verdicts
      so far, the pending set, in-flight confirmation descriptors and
      queued device confirmations.
  ``checker-checkpoint.npz``   the pending lanes' carried-frontier
      snapshots ((bsnap, state, fok, fcr, alive), host numpy arrays),
      keyed by history index.

``ops.wgl.chunked_analysis`` keeps a chunk pair (the carried frontier,
host-spilled rows included, and the scan cursor) and the streaming
checker a stream pair (the op stream consumed so far, the settled
cursor and the carried frontier).

Each pair rides ``store._atomic_write`` and the ``store.durable``
envelope: the json carries a CRC32 over its payload and a digest of the
npz it belongs to, which is written first.  A crash between the two, bit
rot or a hand edit is detected at load: the pair is quarantined aside
(``<name>.corrupt-<n>``) and ``CheckpointError`` carries the report
(``.report``); the caller runs fresh, which reproduces the uninterrupted
verdicts.  Version-1 files load through the migration registry.

On resume the saved config wins over the caller's arguments (verdict
identity needs the original ladder), and a fingerprint that does not
match the histories given quarantines the stale pair and runs fresh.
Imports no torch: arrays are numpy on disk.
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from jepsen_tpu_torch import store as _store
from jepsen_tpu_torch.store import durable as _durable

CKPT_JSON = "checker-checkpoint.json"
CKPT_NPZ = "checker-checkpoint.npz"

#: payload version 2 = the durable-envelope era (checksummed json with
#: an npz digest manifest); version 1 was the bare pre-envelope doc,
#: readable through the migration below.
VERSION = 2

#: chunked-scan (single-history) checkpoint pair: the carried — possibly
#: HOST-SPILLED, so row count is unbounded — frontier between chunk
#: scans, plus the scan cursor.  Separate files from the ladder
#: checkpoint: the two can coexist in one run directory (a ladder's
#: unsafe-shape fallback runs chunked scans inside a checkpointed
#: ladder).
CHUNK_JSON = "chunk-checkpoint.json"
CHUNK_NPZ = "chunk-checkpoint.npz"

CHUNK_VERSION = 2

#: per-stream incremental checkpoint pair (checker.streaming): the op
#: stream consumed so far, the settled-scan cursor, and the carried
#: frontier between epochs.  Unlike the chunk pair the OPS THEMSELVES
#: ride the json — a streaming resume has no stored history to re-read,
#: the checkpoint IS the source of truth for what was fed, so the
#: feeder only needs the consumed-op count to continue.
STREAM_JSON = "stream-checkpoint.json"
STREAM_NPZ = "stream-checkpoint.npz"

STREAM_VERSION = 1

KIND_LADDER = "ladder-checkpoint"
KIND_CHUNK = "chunk-checkpoint"
KIND_STREAM = "stream-checkpoint"

_durable.register_kind(KIND_LADDER, VERSION)
_durable.register_kind(KIND_CHUNK, CHUNK_VERSION)
_durable.register_kind(KIND_STREAM, STREAM_VERSION)


@_durable.register_migration(KIND_LADDER, 1)
def _ladder_v1_to_v2(payload):
    # v1 was the bare doc with its own "version" key and no checksums;
    # the field shapes are otherwise identical.
    payload = {k: v for k, v in dict(payload).items() if k != "version"}
    return payload, 2


@_durable.register_migration(KIND_CHUNK, 1)
def _chunk_v1_to_v2(payload):
    payload = {k: v for k, v in dict(payload).items() if k != "version"}
    return payload, 2


class CheckpointError(Exception):
    """Missing, torn, corrupt, or version-incompatible checkpoint.

    ``report`` (when present) is the durable layer's machine-readable
    corruption report — consumers embed it in their ``cause`` / fault
    telemetry instead of a bare string."""

    def __init__(self, message: str, report: dict | None = None):
        self.report = report
        super().__init__(message)


def json_path(d) -> Path:
    return Path(d) / CKPT_JSON


def exists(d) -> bool:
    return json_path(d).exists()


def fingerprint(histories: Sequence[Sequence[Mapping]]) -> str:
    """A stable identity for the checked inputs: sha256 over every op's
    (type, process, f, value) in order, per history.

    A stored ``ColumnHistory`` hashes its SoA columns DIRECTLY —
    iterating it would materialize every op dict, defeating the store's
    zero-copy path on 50k-op runs.  The two paths therefore fingerprint
    the same content differently; that is fine — the fingerprint only
    has to be stable for the same input source (a resume re-reads the
    same stored run), and a spurious mismatch merely means a fresh run,
    never a wrong resume."""
    h = hashlib.sha256()
    for hist in histories:
        h.update(b"\x00")
        cols = getattr(hist, "cols", None)
        if cols is not None and hasattr(hist, "fs"):
            for name in ("type", "process", "f", "value1", "value2"):
                if name in cols:
                    h.update(np.ascontiguousarray(np.asarray(cols[name])).tobytes())
            h.update(json.dumps(list(hist.fs), default=str).encode())
            extras = getattr(hist, "extras", None) or {}
            if extras:
                h.update(
                    json.dumps(_store._jsonable(extras), sort_keys=True,
                               default=str).encode()
                )
            continue
        for o in hist:
            h.update(
                json.dumps(
                    [
                        _store._jsonable(o.get("type")),
                        _store._jsonable(o.get("process")),
                        _store._jsonable(o.get("f")),
                        _store._jsonable(o.get("value")),
                    ],
                    separators=(",", ":"),
                    default=str,
                ).encode()
            )
    return h.hexdigest()


def save(
    d,
    *,
    config: Mapping,
    stage: int,
    results: Mapping[int, Mapping],
    pending: Sequence[int],
    confirms: Mapping[int, Mapping] | None = None,
    device_confirms: Sequence[Mapping] | None = None,
    resumes: Mapping[int, tuple] | None = None,
    rungs: Mapping[int, int] | None = None,
    complete: bool = False,
) -> Path:
    """Atomically persist one stage boundary's state; returns the json
    path.  ``resumes`` maps history index -> (bsnap, state, fok, fcr,
    alive); ``confirms`` maps history index -> {"res", "op_pos"} for
    in-flight worker confirmations (resubmitted on resume);
    ``device_confirms`` is the queued device-confirmation descriptors
    [{"i", "failed_at", "cap", "res"}].  ``rungs`` optionally maps a
    pending history index -> its NEXT ladder-stage index — continuous
    batching admits members at rung boundaries, so pending members may
    sit at different rungs; a member absent from the map resumes at
    ``stage`` (the pre-continuous behavior, and what old checkpoints
    decode to).  ``complete`` marks a finished run — resuming it
    returns the saved results without device work."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    resumes = dict(resumes or {})
    files = None
    if resumes:
        arrays = {}
        for i, (bsnap, st, fo, fc, al) in resumes.items():
            arrays[f"{i}_bsnap"] = np.asarray(bsnap, np.int32)
            arrays[f"{i}_st"] = np.asarray(st)
            arrays[f"{i}_fo"] = np.asarray(fo)
            arrays[f"{i}_fc"] = np.asarray(fc)
            arrays[f"{i}_al"] = np.asarray(al)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        data = buf.getvalue()
        _store._atomic_write(d / CKPT_NPZ, data)
        # The json's manifest digests THIS npz: load() can prove the
        # pair belongs together (a crash between the two writes, or a
        # corrupted sibling, is detected instead of assumed away).
        files = {CKPT_NPZ: _durable.digest_bytes(data)}
    doc = {
        "complete": bool(complete),
        "config": config,
        "stage": int(stage),
        "results": {str(i): r for i, r in (results or {}).items()},
        "pending": [int(i) for i in pending],
        "confirms": {str(i): c for i, c in (confirms or {}).items()},
        "device_confirms": list(device_confirms or ()),
        "resumes": sorted(int(i) for i in resumes),
        "rungs": {str(i): int(r) for i, r in (rungs or {}).items()},
    }
    _durable.write_record(
        json_path(d), KIND_LADDER, _store._jsonable(doc), files=files
    )
    return json_path(d)


def chunk_json_path(d) -> Path:
    return Path(d) / CHUNK_JSON


def chunked_exists(d) -> bool:
    return chunk_json_path(d).exists()


def save_chunked(
    d,
    *,
    config: Mapping,
    barrier: int,
    cap_idx: int,
    frontier: tuple,
    lossy: bool,
    verified: int,
    launches: int,
    spill_rows: int = 0,
    spill_bytes: int = 0,
    spill_spent: int = 0,
    result: Mapping | None = None,
) -> Path:
    """Persist one chunk boundary of a spill-capable chunked scan
    (ops.wgl.chunked_analysis).  ``frontier`` is the carried
    (state, fok, fcr) host arrays — spilled rows included, so the row
    axis is unbounded; a kill -9 between chunks (or mid-spill: the
    merge happens before the save) then a resume reproduces
    uninterrupted verdicts.  ``config`` must carry the history
    fingerprint plus the scan parameters verdict identity depends on.
    ``result`` marks a FINISHED run (idempotent resume: the saved
    verdict returns without device work).  npz before json, atomically,
    same torn-write reasoning as the ladder checkpoint."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    st, fo, fc = frontier
    buf = io.BytesIO()
    np.savez(buf, st=np.asarray(st), fo=np.asarray(fo), fc=np.asarray(fc))
    data = buf.getvalue()
    _store._atomic_write(d / CHUNK_NPZ, data)
    doc = {
        "config": config,
        "barrier": int(barrier),
        "cap_idx": int(cap_idx),
        "lossy": bool(lossy),
        "verified": int(verified),
        "launches": int(launches),
        "spill_rows": int(spill_rows),
        "spill_bytes": int(spill_bytes),
        "spill_spent": int(spill_spent),
        "result": result,
    }
    _durable.write_record(
        chunk_json_path(d), KIND_CHUNK, _store._jsonable(doc),
        files={CHUNK_NPZ: _durable.digest_bytes(data)},
    )
    return chunk_json_path(d)


def stream_json_path(d) -> Path:
    return Path(d) / STREAM_JSON


def stream_exists(d) -> bool:
    return stream_json_path(d).exists()


def save_stream(
    d,
    *,
    config: Mapping,
    ops: Sequence[Mapping],
    advanced: int,
    cap_idx: int,
    frontier: tuple,
    group_keys: Sequence[Sequence[int]],
    lossy: bool,
    verified: int,
    launches: int,
    epochs: int,
    result: Mapping | None = None,
) -> Path:
    """Persist one stream epoch boundary (checker.streaming).  ``ops``
    is the FULL op stream consumed so far (the resume source of truth);
    ``advanced`` is the settled-barrier cursor the carried ``frontier``
    (state, fok, fcr) sits at; ``group_keys`` are the (f_code, v1, v2)
    triples naming the frontier's fcr columns, so a resume can remap
    them onto the re-packed vocabulary.  ``config`` must carry the scan
    parameters verdict identity depends on (model name, capacity
    ladder, rounds, chunk size, dedup backend, fast flag).  ``result``
    marks a TERMINAL stream (verdict already emitted): resuming it
    returns the saved verdict without device work.  npz before json,
    atomically, same torn-write reasoning as the chunk pair."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    st, fo, fc = frontier
    buf = io.BytesIO()
    np.savez(buf, st=np.asarray(st), fo=np.asarray(fo), fc=np.asarray(fc))
    data = buf.getvalue()
    _store._atomic_write(d / STREAM_NPZ, data)
    doc = {
        "config": config,
        "ops": [dict(o) for o in ops],
        "advanced": int(advanced),
        "cap_idx": int(cap_idx),
        "group_keys": [[int(x) for x in k] for k in group_keys],
        "lossy": bool(lossy),
        "verified": int(verified),
        "launches": int(launches),
        "epochs": int(epochs),
        "result": result,
    }
    _durable.write_record(
        stream_json_path(d), KIND_STREAM, _store._jsonable(doc),
        files={STREAM_NPZ: _durable.digest_bytes(data)},
    )
    return stream_json_path(d)


def load_stream(d) -> dict:
    """Load a stream checkpoint; raises CheckpointError (with the
    durable layer's ``.report`` when applicable) on a missing, torn,
    corrupt, or unmigratable pair.  Corrupt pairs are quarantined aside
    by the durable layer before the raise."""
    p = stream_json_path(d)
    try:
        rr = _durable.read_verified(p, KIND_STREAM)
    except _durable.DurableError as e:
        raise CheckpointError(str(e), e.report) from e
    doc = rr.payload
    npz = Path(d) / STREAM_NPZ
    if not npz.exists():
        raise CheckpointError(
            f"{p} references missing {STREAM_NPZ}",
            {"artifact": KIND_STREAM, "path": str(npz),
             "reason": "missing-sibling"})
    try:
        with np.load(npz) as a:
            frontier = (a["st"], a["fo"], a["fc"])
    except (OSError, ValueError, KeyError) as e:
        q = _durable.quarantine_file(npz, reason="npz-unreadable",
                                     kind=KIND_STREAM)
        raise CheckpointError(
            f"unreadable {npz}: {e}",
            {"artifact": KIND_STREAM, "path": str(npz),
             "reason": "npz-unreadable", "quarantined_to": q}) from e
    return {
        "config": doc.get("config") or {},
        "ops": list(doc.get("ops") or ()),
        "advanced": int(doc.get("advanced") or 0),
        "cap_idx": int(doc.get("cap_idx") or 0),
        "group_keys": [tuple(int(x) for x in k)
                       for k in (doc.get("group_keys") or ())],
        "lossy": bool(doc.get("lossy")),
        "verified": int(doc.get("verified") or 0),
        "launches": int(doc.get("launches") or 0),
        "epochs": int(doc.get("epochs") or 0),
        "result": doc.get("result"),
        "frontier": frontier,
        "path": str(p),
    }


def _quarantine_pair(d, names, kind: str, reason: str) -> list[str]:
    out = []
    for name in names:
        p = Path(d) / name
        if p.exists():
            q = _durable.quarantine_file(p, reason=reason, kind=kind)
            if q:
                out.append(q)
    return out


def quarantine(d, *, reason: str = "stale") -> list[str]:
    """Move the ladder checkpoint pair in ``d`` aside
    (``<name>.corrupt-<n>``) — the fingerprint-mismatch / corruption
    path: the files must leave the resume glob so a LATER ``--resume``
    can't pick the stale state back up, but they stay on disk as
    evidence.  Returns the quarantine paths."""
    return _quarantine_pair(d, (CKPT_JSON, CKPT_NPZ), KIND_LADDER, reason)


def quarantine_chunked(d, *, reason: str = "stale") -> list[str]:
    """``quarantine`` for the chunked-scan checkpoint pair."""
    return _quarantine_pair(d, (CHUNK_JSON, CHUNK_NPZ), KIND_CHUNK, reason)


def quarantine_stream(d, *, reason: str = "stale") -> list[str]:
    """``quarantine`` for the per-stream checkpoint pair."""
    return _quarantine_pair(d, (STREAM_JSON, STREAM_NPZ), KIND_STREAM,
                            reason)


def load_chunked(d) -> dict:
    """Load a chunked-scan checkpoint; raises CheckpointError (with the
    durable layer's ``.report`` when applicable) on a missing, torn,
    corrupt, or unmigratable file.  Corrupt pairs are quarantined
    aside by the durable layer before the raise."""
    p = chunk_json_path(d)
    try:
        rr = _durable.read_verified(p, KIND_CHUNK)
    except _durable.DurableError as e:
        raise CheckpointError(str(e), e.report) from e
    doc = rr.payload
    npz = Path(d) / CHUNK_NPZ
    if not npz.exists():
        # legacy pairs carry no manifest; enveloped ones already proved
        # the sibling exists with matching digest
        raise CheckpointError(
            f"{p} references missing {CHUNK_NPZ}",
            {"artifact": KIND_CHUNK, "path": str(npz),
             "reason": "missing-sibling"})
    try:
        with np.load(npz) as a:
            frontier = (a["st"], a["fo"], a["fc"])
    except (OSError, ValueError, KeyError) as e:
        q = _durable.quarantine_file(npz, reason="npz-unreadable",
                                     kind=KIND_CHUNK)
        raise CheckpointError(
            f"unreadable {npz}: {e}",
            {"artifact": KIND_CHUNK, "path": str(npz),
             "reason": "npz-unreadable", "quarantined_to": q}) from e
    return {
        "config": doc.get("config") or {},
        "barrier": int(doc.get("barrier") or 0),
        "cap_idx": int(doc.get("cap_idx") or 0),
        "lossy": bool(doc.get("lossy")),
        "verified": int(doc.get("verified") or 0),
        "launches": int(doc.get("launches") or 0),
        "spill_rows": int(doc.get("spill_rows") or 0),
        "spill_bytes": int(doc.get("spill_bytes") or 0),
        "spill_spent": int(doc.get("spill_spent") or 0),
        "result": doc.get("result"),
        "frontier": frontier,
        "path": str(p),
    }


def load(d) -> dict:
    """Load a checkpoint back into live shapes: int-keyed results/
    confirms, resume tuples rebuilt from the npz.  Raises
    CheckpointError (with the durable layer's ``.report`` when
    applicable) on a missing, torn, corrupt, or unmigratable file;
    corrupt json/npz pairs are quarantined aside before the raise."""
    p = json_path(d)
    try:
        rr = _durable.read_verified(p, KIND_LADDER)
    except _durable.DurableError as e:
        raise CheckpointError(str(e), e.report) from e
    doc = rr.payload
    out = {
        "complete": bool(doc.get("complete")),
        "config": doc.get("config") or {},
        "stage": int(doc.get("stage") or 0),
        "results": {int(i): r for i, r in (doc.get("results") or {}).items()},
        "pending": [int(i) for i in doc.get("pending") or ()],
        "confirms": {int(i): c for i, c in (doc.get("confirms") or {}).items()},
        "device_confirms": list(doc.get("device_confirms") or ()),
        "resumes": {},
        "rungs": {int(i): int(r) for i, r in (doc.get("rungs") or {}).items()},
        "path": str(p),
    }
    want = [int(i) for i in doc.get("resumes") or ()]
    if want:
        npz = Path(d) / CKPT_NPZ
        if not npz.exists():
            raise CheckpointError(
                f"{p} references missing {CKPT_NPZ}",
                {"artifact": KIND_LADDER, "path": str(npz),
                 "reason": "missing-sibling"})
        try:
            with np.load(npz) as a:
                for i in want:
                    try:
                        out["resumes"][i] = (
                            int(a[f"{i}_bsnap"]),
                            a[f"{i}_st"],
                            a[f"{i}_fo"],
                            a[f"{i}_fc"],
                            a[f"{i}_al"],
                        )
                    except KeyError as e:
                        raise CheckpointError(
                            f"{CKPT_NPZ} is missing frontier arrays for "
                            f"lane {i}",
                            {"artifact": KIND_LADDER, "path": str(npz),
                             "reason": "missing-lane", "lane": i},
                        ) from e
        except (OSError, ValueError) as e:
            # torn legacy npz (enveloped pairs already passed the digest)
            q = _durable.quarantine_file(npz, reason="npz-unreadable",
                                         kind=KIND_LADDER)
            raise CheckpointError(
                f"unreadable {npz}: {e}",
                {"artifact": KIND_LADDER, "path": str(npz),
                 "reason": "npz-unreadable", "quarantined_to": q}) from e
    return out
