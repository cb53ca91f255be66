"""Verdict provenance: the decision path a verdict took, and durable
evidence bundles.

The port's copy of the JAX package's ``obs.provenance``.  A result
carries a ``provenance`` block (:func:`attach`: the decision path, the
engine, the config); a bundle (:func:`build_bundle`) adds the history's
fingerprint, the verdict, the model, the checker and the constructive
witness, and its digest (:func:`bundle_digest`) is a sha256 over the
stability core with the volatile attributes stripped, so the same
history checked along the same decision path digests the same wherever
it ran.  :func:`emit` writes a checker's bundle under the run's store
directory (``<test-dir>/evidence/<id>.json``, a ``store.durable``
envelope) and sets the result's ``"evidence"``; :func:`verify_bundle`
audits one (envelope CRC, digest, history fingerprint, and the witness
re-stepped through the model or the claimed cycle re-chained).  Digests
and envelopes are byte-for-byte the JAX package's for the same payload.

Each bundle written counts ``provenance.bundle`` (by source and
verdict), and a failed build or write ``provenance.emit_error``
(``obs``).  ``replay_bundle`` (re-running a bundle's history pinned to
its engine, for ``tools/evidence.py``) waits for the command line
(ROADMAP queue A10).  This module imports no torch.
"""

from __future__ import annotations

import hashlib
import logging
import json
import platform
import socket
import uuid
from pathlib import Path
from typing import Mapping, Sequence

from jepsen_tpu_torch import obs

logger = logging.getLogger(__name__)

#: durable envelope kind of evidence bundles (payload version 1).
KIND_BUNDLE = "evidence-bundle"

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


def _register() -> None:
    from jepsen_tpu_torch.store import durable

    durable.register_kind(KIND_BUNDLE, 1)


_register()


def history_fingerprint(history) -> str:
    """The canonical content fingerprint of one history: the sha256 the
    checkpoints key their resume on."""
    from jepsen_tpu_torch.store import checkpoint

    return checkpoint.fingerprint([history])


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
    from jepsen_tpu_torch.store import durable

    return hashlib.sha256(durable.canonical_bytes(core)).hexdigest()


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


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


def write_bundle(directory, payload: Mapping) -> Path | None:
    """Persist one bundle durably as ``<dir>/<id>.json`` (an envelope:
    CRC, kind, version), counted as ``provenance.bundle``.  Returns None
    instead of raising when the write fails, counted as
    ``provenance.emit_error``: an evidence write must not lose the
    verdict it documents."""
    from jepsen_tpu_torch.store import durable

    try:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{payload['id']}.json"
        durable.write_record(path, KIND_BUNDLE, payload)
        obs.counter("provenance.bundle", source=payload.get("source"),
                    verdict=payload.get("verdict"))
        return path
    except Exception as e:  # noqa: BLE001 — see docstring
        logger.warning("evidence bundle write failed: %s", e)
        obs.counter("provenance.emit_error", error=type(e).__name__)
        return None


def read_bundle(path) -> dict:
    """Read and verify one bundle's envelope.  Raises
    ``store.durable.DurableError`` (with its ``.report``) on a corrupt or
    tampered envelope, which is quarantined aside."""
    from jepsen_tpu_torch.store import durable

    return durable.read_verified(path, KIND_BUNDLE).payload


def iter_bundles(run_dir):
    """Yield ``(path, payload)`` for every readable bundle under a run
    directory's ``evidence/`` folder (corrupt ones are skipped with a
    warning: they are quarantined already)."""
    from jepsen_tpu_torch.store import durable

    d = Path(run_dir)
    ev = d / "evidence" if (d / "evidence").is_dir() else d
    for p in sorted(ev.glob("*.json")):
        try:
            yield p, read_bundle(p)
        except durable.DurableError as e:
            logger.warning("skipping corrupt bundle %s: %s", p, e)


def emit(test: Mapping | None, history, result: dict, *, source: str,
         model=None, checker: str | None = None,
         config: Mapping | None = None, opts: Mapping | None = None,
         trace_id=None) -> dict | None:
    """A checker's emission: build a bundle for ``result`` and write it
    under the run's store directory (``<test-dir>/evidence/<id>.json``,
    below ``opts["subdirectory"]`` when set).  A test map without store
    coordinates (``name``, ``start-time-str``) writes nothing, and the
    in-memory provenance stays on the result.  Sets ``result["evidence"]
    = {id, digest, path}`` on success; returns the bundle; never
    raises."""
    try:
        bundle = build_bundle(
            history=history, result=result, source=source, model=model,
            checker=checker, config=config, trace_id=trace_id,
        )
    except Exception as e:  # noqa: BLE001 — provenance never loses verdicts
        logger.warning("evidence bundle build failed: %s", e)
        obs.counter("provenance.emit_error", error=type(e).__name__)
        return None
    test = test or {}
    if not (test.get("name") and test.get("start-time-str")):
        return bundle
    from jepsen_tpu_torch import store

    d = store.test_dir(test)
    sub = (opts or {}).get("subdirectory")
    d = d / sub if sub else d
    path = write_bundle(d / "evidence", bundle)
    if path is not None:
        result["evidence"] = {
            "id": bundle["id"], "digest": bundle["digest"],
            "path": str(path),
        }
    return bundle


# ---------------------------------------------------------------------------
# Verify: structural audit and witness re-validation
# ---------------------------------------------------------------------------


def _check_linearization(model, history, order: Sequence[Mapping]) -> list[str]:
    """Re-step the model through a claimed linearization: every step must
    be consistent, and the order must fire every completed effective op
    that ``wgl_cpu.prepare`` derives from the history and nothing more
    often than the history offers (a crashed op may be absent)."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.checker import wgl_cpu

    errors: list[str] = []
    state = model
    for n, op in enumerate(order):
        state = state.step(op)
        if m.is_inconsistent(state):
            errors.append(
                f"witness step {n} inconsistent: f={op.get('f')!r} "
                f"value={op.get('value')!r} ({state.msg})"
            )
            return errors
    _events, eff_ops, crashed = wgl_cpu.prepare(model, history)

    def _key(op):
        return (op.get("f"), json.dumps(op.get("value"), sort_keys=True,
                                        default=str))

    want: dict = {}
    want_ok: dict = {}
    got: dict = {}
    for i, op in eff_ops.items():
        want[_key(op)] = want.get(_key(op), 0) + 1
        if i not in crashed:
            want_ok[_key(op)] = want_ok.get(_key(op), 0) + 1
    for op in order:
        got[_key(op)] = got.get(_key(op), 0) + 1
    for k, n in got.items():
        if n > want.get(k, 0):
            errors.append(f"witness fires op {k} {n}x but history has "
                          f"{want.get(k, 0)}")
    for k, n in want_ok.items():
        if got.get(k, 0) < n:
            errors.append(
                f"witness omits completed op {k} ({got.get(k, 0)} fired, "
                f"{n} required)"
            )
    return errors


def _check_cycle(anomalies: Mapping) -> list[str]:
    """A claimed cycle must cycle: every step's ``to`` is the next step's
    ``from``, and the last closes back to the first."""
    errors: list[str] = []
    for name, cycles in (anomalies or {}).items():
        for ci, c in enumerate(cycles or ()):
            steps = c.get("steps") or []
            if not steps:
                errors.append(f"anomaly {name}[{ci}]: no steps")
                continue
            for si, st in enumerate(steps):
                nxt = steps[(si + 1) % len(steps)]
                if st.get("to") != nxt.get("from"):
                    errors.append(
                        f"anomaly {name}[{ci}]: step {si} does not chain "
                        f"(to != next.from) — the claimed cycle does not "
                        "cycle"
                    )
                    break
            cyc = c.get("cycle")
            if cyc and len(cyc) != len(steps):
                errors.append(
                    f"anomaly {name}[{ci}]: {len(cyc)} ops vs "
                    f"{len(steps)} steps"
                )
    return errors


_REQUIRED = ("id", "source", "verdict", "history_fingerprint",
             "decision_path", "engine", "digest")


def verify_bundle(bundle, *, path=None) -> dict:
    """Audit one bundle; returns ``{"ok": bool, "checks": [...],
    "errors": [...]}``.  ``bundle`` is a payload dict or a path (then the
    envelope CRC is checked first, and a tampered envelope fails with
    the durable layer's report under ``"envelope"``)."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.store import durable

    checks: list[str] = []
    errors: list[str] = []
    report = {"ok": False, "checks": checks, "errors": errors}
    if not isinstance(bundle, Mapping):
        path = bundle
        try:
            bundle = read_bundle(path)
        except durable.DurableError as e:
            errors.append(f"envelope: {e}")
            report["envelope"] = e.report
            return report
        checks.append("envelope-crc")
    for k in _REQUIRED:
        if bundle.get(k) in (None, ""):
            errors.append(f"missing required field: {k}")
    if errors:
        return report
    checks.append("required-fields")
    if bundle_digest(bundle) != bundle["digest"]:
        errors.append("digest mismatch: stability core was altered after "
                      "the digest was computed")
        return report
    checks.append("digest")
    history = bundle.get("history")
    if history is not None:
        if history_fingerprint(history) != bundle["history_fingerprint"]:
            errors.append("history fingerprint mismatch: embedded history "
                          "was altered")
            return report
        checks.append("history-fingerprint")
    witness = bundle.get("witness")
    if witness:
        wt = witness.get("type")
        if wt == "linearization":
            if bundle.get("model") and history is not None:
                model = m.model(bundle["model"])
                errs = _check_linearization(
                    model, history, witness.get("order") or ())
                if errs:
                    errors.extend(errs)
                    return report
                checks.append("witness-linearization")
            else:
                checks.append("witness-linearization-skipped")
        elif wt == "cycle":
            errs = _check_cycle(witness.get("anomalies") or {})
            if errs:
                errors.extend(errs)
                return report
            checks.append("witness-cycle")
        elif wt == "refutation":
            op = witness.get("op")
            if history is not None and op is not None:
                fv = (op.get("f"), op.get("process"))
                if not any((o.get("f"), o.get("process")) == fv
                           for o in history):
                    errors.append("refutation op not present in history")
                    return report
            checks.append("witness-refutation")
    elif bundle["verdict"] == "false":
        errors.append("refuted verdict carries no witness payload")
        return report
    report["ok"] = True
    return report
