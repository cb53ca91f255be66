"""Verdict provenance: the decision path a verdict took, and evidence
bundles built in memory.

The port's copy of the in-memory part of the JAX package's
``obs.provenance``.  A result carries a ``provenance`` block
(:func:`attach`: the decision path, the engine, the config); a bundle
(:func:`build_bundle`) adds the history's fingerprint, the verdict, the
model, the checker and the constructive witness, and its digest
(:func:`bundle_digest`) is a sha256 over the stability core with the
volatile attributes stripped, so the same history checked along the
same decision path digests the same wherever it ran.  The digest is
byte-for-byte the JAX package's for the same payload.

Writing bundles to disk, reading, verifying and replaying them wait for
the durable store (ROADMAP queue A6).  This module imports no torch.
"""

from __future__ import annotations

import hashlib
import logging
import json
import platform
import socket
import uuid
from typing import Mapping, Sequence

from jepsen_tpu_torch import store

logger = logging.getLogger(__name__)

#: embed the raw history in the bundle when it has at most this many
#: ops; larger histories keep only the fingerprint and op count.
MAX_EMBED_OPS = 4096

#: decision-path entries kept per bundle; overflow is truncated with a
#: marker entry.
MAX_PATH = 128

#: skip constructive-witness extraction (the greedy re-walk) past this
#: many ops.
WITNESS_WALK_MAX_OPS = 2048

#: attribute names stripped (recursively) from the digest's stability
#: core: timings, lane widths, buffer peaks, machine/trace identity —
#: everything that varies between a served batch member and the same
#: history replayed sequentially along the same decision path.
_DIGEST_STRIP = frozenset({
    "seconds", "latency", "lanes", "lanes_from", "lanes_to", "launches",
    "padded", "trace_id", "trace", "machine", "id", "digest", "source",
    "joined_at_rung", "frontier-peak", "peak_frontier", "chunks",
    "spill-rows", "spill-bytes", "device_bytes_peak", "queue_latency_s",
    "history_ops", "svg", "evidence",
    # confirm.resolved's mode records which confirm pool happened to be
    # free, not what was decided.
    "mode",
})


def history_fingerprint(history) -> str:
    """The canonical content fingerprint of one history."""
    return store.fingerprint([history])


def machine_fingerprint() -> dict:
    """Host fingerprint: host name, processor and Python version.  It
    never probes a device (the digest strips it anyway)."""
    return {
        "host": socket.gethostname(),
        "cpu": platform.processor() or platform.machine(),
        "python": platform.python_version(),
    }


def verdict_str(v) -> str:
    """Canonical verdict string: True → "true", False → "false",
    anything else (UNKNOWN, None, "unknown") → "unknown"."""
    if v is True:
        return "true"
    if v is False:
        return "false"
    return "unknown"


# ---------------------------------------------------------------------------
# Decision-path attachment (pure dict plumbing; producers call this)
# ---------------------------------------------------------------------------


def attach(result: dict, path: Sequence[Mapping] | None = None, *,
           engine: Mapping | None = None,
           config: Mapping | None = None) -> dict:
    """Merge decision-path provenance into a result dict (in place).

    ``path`` entries are prepended before any entries already on the
    result (an outer ladder's events precede an inner engine's own).
    ``engine``/``config`` fill only missing keys — the innermost
    producer knows its resolution best.  Idempotent for a fixed ``path``
    list: callers re-attach freely, the last attach before the result
    leaves the producer wins.
    """
    prov = result.get("provenance")
    existing = list(prov.get("path", ())) if isinstance(prov, Mapping) else []
    new = [dict(e) for e in (path or ())]
    # idempotence: drop the existing prefix if it is exactly a prior
    # attach of the same (possibly shorter) producer list
    if new and existing[: len(new)] == new:
        merged = existing
    else:
        seen = {json.dumps(e, sort_keys=True, default=str) for e in new}
        merged = new + [
            e for e in existing
            if json.dumps(e, sort_keys=True, default=str) not in seen
        ]
    if len(merged) > MAX_PATH:
        merged = merged[:MAX_PATH] + [
            {"event": "path.truncated", "dropped": len(merged) - MAX_PATH}
        ]
    out = {"path": merged}
    eng = dict(prov.get("engine", ())) if isinstance(prov, Mapping) else {}
    for k, v in (engine or {}).items():
        eng.setdefault(k, v)
    if eng:
        out["engine"] = eng
    cfg = dict(prov.get("config", ())) if isinstance(prov, Mapping) else {}
    for k, v in (config or {}).items():
        cfg.setdefault(k, v)
    if cfg:
        out["config"] = cfg
    result["provenance"] = out
    return result


class PathRecorder:
    """A bounded per-verdict decision-path accumulator.  ``add`` is
    cheap and never raises; ``entries`` hands the list to
    :func:`attach`."""

    __slots__ = ("entries",)

    def __init__(self):
        self.entries: list[dict] = []

    def add(self, event: str, **attrs) -> None:
        if len(self.entries) >= MAX_PATH:
            return
        e = {"event": str(event)}
        e.update(attrs)
        self.entries.append(e)


# ---------------------------------------------------------------------------
# Bundle construction
# ---------------------------------------------------------------------------


def _extract_witness(model, history, result: Mapping) -> dict | None:
    """The constructive payload that makes a verdict auditable.

    * valid (linearizable): re-run the host greedy walk recording the
      fired effective ops — a full linearization order that steps.
    * refuted (linearizable): the barrier op the engine killed on.
    * refuted with anomalies: the anomaly cycles.
    """
    v = result.get("valid?")
    if v is False:
        if result.get("anomalies"):
            return {"type": "cycle", "anomalies": result["anomalies"]}
        if result.get("op") is not None:
            return {"type": "refutation", "op": result["op"]}
        return None
    if v is not True:
        return None
    if result.get("anomaly-types") is not None or model is None:
        return None  # absence of cycles has no walk
    if history is None or len(history) > WITNESS_WALK_MAX_OPS:
        return None
    try:
        from jepsen_tpu_torch.checker import wgl_cpu

        order: list[dict] = []
        ok = wgl_cpu.greedy_walk(model, history, record=order)
        if ok is True:
            return {"type": "linearization", "order": order}
    except Exception:  # noqa: BLE001 — witness extraction is best-effort
        logger.debug("witness extraction failed", exc_info=True)
    return None


def _strip(x):
    if isinstance(x, Mapping):
        return {
            str(k): _strip(v) for k, v in x.items()
            if str(k) not in _DIGEST_STRIP
        }
    if isinstance(x, (list, tuple)):
        return [_strip(v) for v in x]
    return x


def _stable_cause(cause) -> str | None:
    """Causes sometimes embed run-local paths ("resumable checkpoint:
    /tmp/..."); the digest keeps only the stable prefix."""
    if cause is None:
        return None
    return str(cause).split("; resumable checkpoint:", 1)[0]


def bundle_digest(payload: Mapping) -> str:
    """sha256 over the bundle's stability core — same history + same
    decision path ⇒ same digest, wherever it ran."""
    core = {
        "history_fingerprint": payload.get("history_fingerprint"),
        "verdict": payload.get("verdict"),
        "cause": _stable_cause(payload.get("cause")),
        "model": payload.get("model"),
        "checker": payload.get("checker"),
        "decision_path": _strip(payload.get("decision_path") or []),
        "engine": _strip(payload.get("engine") or {}),
        "config": _strip(payload.get("config") or {}),
        "witness": _strip(payload.get("witness") or {}),
    }
    return hashlib.sha256(store.canonical_bytes(core)).hexdigest()


def build_bundle(*, history, result: Mapping, source: str,
                 model=None, checker: str | None = None,
                 trace_id=None, config: Mapping | None = None,
                 extra_path: Sequence[Mapping] | None = None,
                 bundle_id: str | None = None) -> dict:
    """Assemble one evidence-bundle payload (no I/O).

    ``result`` may carry a ``provenance`` block from :func:`attach`;
    ``extra_path`` entries are prepended before it.  The returned
    payload's ``digest`` field is the stability-core digest.
    """
    prov = result.get("provenance") or {}
    path = [dict(e) for e in (extra_path or ())]
    path += [dict(e) for e in prov.get("path", ())]
    engine = dict(prov.get("engine", ()))
    cfg = dict(config or prov.get("config", ()))
    cfg.pop("fingerprint", None)  # batch-level; not per-history-stable
    v = result.get("valid?")
    payload = {
        "id": bundle_id or uuid.uuid4().hex[:16],
        "source": str(source),
        "model": getattr(model, "name", None) if model is not None else None,
        "checker": checker,
        "history_fingerprint": history_fingerprint(history)
        if history is not None else None,
        "history_ops": len(history) if history is not None else None,
        "verdict": verdict_str(v),
        "cause": result.get("cause"),
        "decision_path": path,
        "engine": engine,
        "config": cfg,
        "witness": _extract_witness(model, history, result),
        "machine": machine_fingerprint(),
        "trace_id": trace_id,
    }
    if history is not None and len(history) <= MAX_EMBED_OPS:
        payload["history"] = [dict(op) for op in history]
    payload["digest"] = bundle_digest(payload)
    return payload
