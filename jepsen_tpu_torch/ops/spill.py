"""Honest exhaustion: the machine-readable record of why fixed memory
could not decide a history.

A copy of the JAX package's ``ops/spill.py`` report helpers
(``undecidability_report``, ``undecidable_cause``), without its
telemetry counters.  The rest of that module (host-spill frontiers,
the LSH merge, group factorization) waits for the chunked engine
(ROADMAP queue A3).
"""

from __future__ import annotations

import json


def undecidability_report(
    *,
    capacity: int,
    frontier_rows: int,
    peak_frontier: int,
    barrier: int,
    barriers_total: int,
    budget_mb: float | None = None,
    budget_rows: int | None = None,
    spill_rows: int = 0,
    spill_bytes: int = 0,
    factor_count: int = 0,
    device_buffer_bytes: int | None = None,
    mesh_devices: int | None = None,
    per_device_rows: int | None = None,
    reason: str = "closure-overflow",
) -> dict:
    """Why fixed memory could not decide: the growth rate (peak frontier
    over frontier rows at the exhausted barrier), spill volume, and the
    budget in force.  ``mesh_devices``/``per_device_rows`` are set when
    the exhausted stage was the mesh-spanning one, so the report cites
    the mesh capacity (shards × per-shard rows)."""
    rep = {
        "reason": str(reason),
        "capacity": int(capacity),
        "frontier_rows": int(frontier_rows),
        "peak_frontier": int(peak_frontier),
        "growth_rate": round(float(peak_frontier) / max(1, frontier_rows), 3),
        "barrier": int(barrier),
        "barriers_total": int(barriers_total),
        "spill_rows": int(spill_rows),
        "spill_bytes": int(spill_bytes),
        "factor_count": int(factor_count),
    }
    if budget_mb is not None:
        rep["budget_mb"] = float(budget_mb)
    if budget_rows is not None:
        rep["budget_rows"] = int(budget_rows)
    if device_buffer_bytes is not None:
        rep["device_buffer_bytes"] = int(device_buffer_bytes)
    if mesh_devices is not None:
        rep["mesh_devices"] = int(mesh_devices)
        if per_device_rows is not None:
            rep["per_device_rows"] = int(per_device_rows)
            rep["mesh_capacity_rows"] = int(mesh_devices) * int(per_device_rows)
    return rep


def undecidable_cause(report: dict) -> str:
    """The ``cause`` string for an undecidable unknown: a fixed prefix
    (machine-greppable) and the report as compact json."""
    return "undecidable under fixed memory: " + json.dumps(
        report, sort_keys=True, separators=(",", ":"))
