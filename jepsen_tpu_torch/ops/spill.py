"""Bounded-memory frontier management for the chunked engine.

The port of the JAX package's ``ops/spill.py``, with its ``frontier.*``
telemetry counters (mirrored by name into ``obs.metrics``) beside the
process totals:

  * the frontier budget (``resolve_budget_mb``, ``budget_rows``): how
    many device frontier rows a ``frontier_budget_mb`` buys at a
    geometry, so that the chunked engine skips rungs that do not fit;
  * ``HostRing``: slice survivors on their way to the host.  A CUDA
    tensor is copied into pinned host memory on a side stream as it is
    pushed, so the copy runs while the next slice computes; ``pop_all``
    waits on each copy's event before it reads;
  * ``merge_frontiers``: the exact union of host frontier parts, with
    dedup and domination run only among rows of equal (state, fok) class
    hash (``hashing.np_class_hash``);
  * crashed-op group factorization (``factor_packed``): a crashed group
    that is trace-independent of every op is removed, so G shrinks and
    the verdict is unchanged;
  * honest exhaustion (``undecidability_report``): the machine-readable
    record of why fixed memory could not decide.

Host frontiers here are numpy ``(state int32, fok int32 bit patterns,
fcr int16)``; a uint32 fok (the JAX package's) is taken as well.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.convert import fok_bits
from jepsen_tpu_torch.obs import metrics as _metrics
from jepsen_tpu_torch.ops import hashing

FRONTIER_BUDGET_ENV = "JEPSEN_TPU_FRONTIER_BUDGET_MB"

#: Working-set multiplier: a rung at capacity F materializes the
#: F·(1+P+G)-row candidate table plus sort scratch and the 2C prune
#: buffer; ~3x the candidate table covers it (a low estimate only spills
#: earlier).
_WORKING_SET_FACTOR = 3

#: Process-wide spill and factorization totals.
_TOTALS = {
    "spill_rows": 0, "spill_bytes": 0, "spill_merges": 0,
    "factorizations": 0, "undecidable_reports": 0,
}
_TOTALS_LOCK = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _TOTALS_LOCK:
        _TOTALS[key] += n


def stats_snapshot() -> dict:
    """The process-wide bounded-memory totals, as a plain dict."""
    with _TOTALS_LOCK:
        return dict(_TOTALS)


def row_bytes(W: int, G: int) -> int:
    """Device bytes per frontier row: int32 state, W fok words, G int16
    counts and the alive byte."""
    return 4 + 4 * W + 2 * G + 1


def resolve_budget_mb(budget_mb: float | None = None) -> float | None:
    """Explicit argument > JEPSEN_TPU_FRONTIER_BUDGET_MB > None (no
    budget: the capacity ladder alone bounds device rows)."""
    if budget_mb is not None:
        return float(budget_mb)
    v = os.environ.get(FRONTIER_BUDGET_ENV)
    if v:
        try:
            return float(v)
        except ValueError:
            pass
    return None


def budget_rows(budget_mb: float | None, W: int, G: int, P: int) -> int | None:
    """The device frontier rows ``budget_mb`` buys at this geometry under
    the rung working-set model (an F-row rung holds F·(1+P+G) candidate
    rows, times ``_WORKING_SET_FACTOR``).  Never below 1."""
    if budget_mb is None:
        return None
    per_row = row_bytes(W, G) * (1 + P + G) * _WORKING_SET_FACTOR
    return max(1, int(budget_mb * 1e6) // max(1, per_row))


# ---------------------------------------------------------------------------
# Host spill ring
# ---------------------------------------------------------------------------


class _Pending:
    """One pushed part: host arrays, or CUDA tensors being copied into
    pinned host buffers on a side stream (``event`` marks the end)."""

    __slots__ = ("arrays", "event")

    def __init__(self, arrays, event=None):
        self.arrays = arrays
        self.event = event

    def host(self):
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return tuple(None if a is None else
                     (a.numpy() if hasattr(a, "numpy") else np.asarray(a))
                     for a in self.arrays)


def _start_copy(tensors):
    """Copy CUDA tensors into pinned host tensors on a side stream that
    first waits for the producer's stream; returns (host tensors, the
    event that marks the copies done).  ``record_stream`` keeps the
    caching allocator from reusing the sources before the copies run."""
    import torch

    src_stream = torch.cuda.current_stream(tensors[0].device)
    side = torch.cuda.Stream(device=tensors[0].device)
    side.wait_stream(src_stream)
    out = []
    with torch.cuda.stream(side):
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(side)
            out.append(h)
        event = torch.cuda.Event()
        event.record(side)
    return tuple(out), event


class HostRing:
    """A host-side ring of spilled frontier rows.

    ``push`` takes numpy arrays, CPU tensors or CUDA tensors.  CUDA
    tensors start their device-to-host copies at push time (pinned
    buffers, side stream, one event per push), so the copies overlap the
    next device-bound slice; rows become host arrays only at ``pop_all``,
    which waits on each event.  Nothing is dropped: host memory is the
    spill medium, and the row and byte totals are the spill volume the
    undecidability report cites."""

    def __init__(self, W: int, G: int):
        self.W = int(W)
        self.G = int(G)
        self._entries: list[_Pending] = []
        self.rows = 0
        self.rows_total = 0
        self.bytes_total = 0

    def push(self, state, fok, fcr, alive=None) -> int:
        """Spill rows (masked by ``alive`` when given) into the ring;
        returns the row count accounted now (a masked push is accounted
        at pop, when its alive count is on the host)."""
        arrays = (state, fok, fcr, alive)
        if getattr(state, "is_cuda", False):
            host, event = _start_copy(arrays)
            self._entries.append(_Pending(host, event))
        else:
            self._entries.append(_Pending(arrays))
        if alive is not None:
            return 0
        n = int(state.shape[0])
        self._account(n)
        return n

    def _account(self, n: int) -> None:
        if n <= 0:
            return
        nbytes = n * row_bytes(self.W, self.G)
        self.rows += n
        self.rows_total += n
        self.bytes_total += nbytes
        _count("spill_rows", n)
        _count("spill_bytes", nbytes)
        # mirrored by name (jepsen_tpu_frontier_spill_bytes_total)
        obs.counter("frontier.spill_rows", n)
        obs.counter("frontier.spill_bytes", nbytes)

    def discard(self) -> None:
        """Drop pending entries without accounting them as spill (a
        capacity-escalation retry discards an attempt's outputs)."""
        self._entries = []
        self.rows = 0

    def pop_all(self):
        """Materialize and drain every spilled row, in push order:
        (state, fok int32 bits, fcr) host arrays, or None when empty."""
        if not self._entries:
            return None
        parts = []
        for entry in self._entries:
            st, fo, fc, al = entry.host()
            if al is not None:
                sel = np.flatnonzero(al)
                st, fo, fc = st[sel], fo[sel], fc[sel]
                self._account(int(sel.size))
            parts.append((st, fok_bits(fo), fc))
        self._entries = []
        self.rows = 0
        if len(parts) == 1:
            return parts[0]
        return (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts], axis=0),
            np.concatenate([p[2] for p in parts], axis=0),
        )


# ---------------------------------------------------------------------------
# Class-bucketed exact merge (dedup + domination on the host)
# ---------------------------------------------------------------------------


def merge_frontiers(parts) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Union host frontier parts into one exact antichain.

    ``parts``: iterable of (state [n], fok [n, W], fcr [n, G]) host
    arrays.  Rows sort by the 64-bit (state, fok) class hash, then exact
    duplicate and domination kills run only within runs of equal hash
    (identical classes always share it, so the result is globally
    exact).  Within a class the antichain keeps the pointwise-minimal
    rows, the first copy in input order on ties, as ``exact_prune``
    does.  Survivors keep input order.

    Returns (state, fok int32 bits, fcr, stats) with stats = {"rows_in",
    "rows_out", "buckets"}.
    """
    parts = [p for p in parts if p is not None and p[0].shape[0]]
    if not parts:
        z = np.zeros(0, np.int32)
        return z, np.zeros((0, 1), np.int32), np.zeros((0, 1), np.int16), {
            "rows_in": 0, "rows_out": 0, "buckets": 0}
    state = np.concatenate([np.asarray(p[0], np.int32) for p in parts])
    fok = np.concatenate([fok_bits(p[1]) for p in parts], axis=0)
    fcr = np.concatenate([np.asarray(p[2], np.int16) for p in parts], axis=0)
    n = state.shape[0]
    h1, h2 = hashing.np_class_hash(state, fok)
    order = np.lexsort((np.arange(n), h2, h1))
    sh1, sh2 = h1[order], h2[order]
    new_run = np.ones(n, bool)
    new_run[1:] = (sh1[1:] != sh1[:-1]) | (sh2[1:] != sh2[:-1])
    starts = np.flatnonzero(new_run)
    ends = np.append(starts[1:], n)
    keep = np.ones(n, bool)  # in sorted order
    for lo, hi in zip(starts, ends):
        if hi - lo == 1:
            continue
        idx = order[lo:hi]  # input order within the run (lexsort is stable)
        bst, bfo, bfc = state[idx], fok[idx], fcr[idx]
        # the exact class split inside the run: kills stay content-decided
        same = (bst[:, None] == bst[None, :]) & (
            bfo[:, None, :] == bfo[None, :, :]).all(-1)
        le = (bfc[:, None, :] <= bfc[None, :, :]).all(-1)
        lt = (bfc[:, None, :] < bfc[None, :, :]).any(-1)
        k = hi - lo
        earlier = np.arange(k)[:, None] < np.arange(k)[None, :]
        killer = same & le & (lt | earlier)
        np.fill_diagonal(killer, False)
        keep[lo:hi] = ~killer.any(axis=0)
    sel = order[keep]
    sel.sort()
    stats = {"rows_in": int(n), "rows_out": int(sel.size),
             "buckets": int(starts.size)}
    _count("spill_merges")
    obs.counter("frontier.spill_merges")
    return state[sel], fok[sel], fcr[sel], stats


# ---------------------------------------------------------------------------
# Crashed-op group factorization
# ---------------------------------------------------------------------------


def _np_step(step):
    """The port's torch model step as a function of numpy arrays (CPU
    tensors in, numpy out)."""
    import torch

    def run(state, f, v1, v2):
        args = [torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))
                for a in (state, f, v1, v2)]
        nxt, legal = step(*args)
        return nxt.numpy(), legal.numpy()

    return run


def _distinct_ops(packed) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every distinct (f, v1, v2) op the packed history can fire:
    returning ops (active barriers), open ok movers and live crashed
    groups."""
    bar_f, bar_v1, bar_v2, _slot = packed["bar"]
    mov_f, mov_v1, mov_v2, mov_open = packed["mov"]
    grp_f, grp_v1, grp_v2 = packed["grp"]
    act = np.asarray(packed["bar_active"], bool)
    mo = np.asarray(mov_open, bool)
    live = np.asarray(packed["grp_open"]).max(axis=0) > 0
    triples = np.concatenate([
        np.stack([np.asarray(bar_f)[act], np.asarray(bar_v1)[act],
                  np.asarray(bar_v2)[act]], axis=1),
        np.stack([np.asarray(mov_f)[mo], np.asarray(mov_v1)[mo],
                  np.asarray(mov_v2)[mo]], axis=1),
        np.stack([np.asarray(grp_f)[live], np.asarray(grp_v1)[live],
                  np.asarray(grp_v2)[live]], axis=1),
    ]).astype(np.int64)
    return np.unique(triples, axis=0).T


def reachable_states(step, init_state: int, ops, max_states: int = 256,
                     depth_cap: int = 64):
    """Tabulate the states reachable from ``init_state`` in at most
    ``depth_cap`` fires of the distinct ``ops`` with the tensor model's
    ``step`` (a host BFS with per-state minimum depth).  Returns (states
    sorted, min depth aligned, closed?), ``closed`` meaning a fixpoint
    below the cap, or None when more than ``max_states`` states
    appear."""
    run = _np_step(step)
    f, v1, v2 = (np.asarray(a, np.int32) for a in ops)
    depth = {int(init_state): 0}
    frontier = np.array([init_state], np.int32)
    closed = False
    for d in range(1, depth_cap + 1):
        nxt, legal = run(frontier[:, None], f[None, :], v1[None, :],
                         v2[None, :])
        nxt = nxt[legal]
        new = [int(s) for s in np.unique(nxt) if int(s) not in depth]
        if not new:
            closed = True
            break
        if len(depth) + len(new) > max_states:
            return None
        for s in new:
            depth[s] = d
        frontier = np.asarray(new, np.int32)
    states = np.array(sorted(depth), np.int32)
    depths = np.array([depth[int(s)] for s in states], np.int32)
    return states, depths, closed


def independent_groups(packed, max_states: int = 256) -> list[int]:
    """Live crashed-group indices that are trace-independent of every
    distinct op of the history (themselves included) over the reachable
    state set: each preserves the other's legality and they commute
    where both are legal.  Such a group's fires commute to the end of
    any witness and drop, so removing the group keeps the verdict
    exactly.  Returns [] when the state space is not tabulable."""
    try:
        f, v1, v2 = _distinct_ops(packed)
    except Exception:  # noqa: BLE001 — malformed tables: skip, never fail
        return []
    if f.size == 0 or f.size > 128:
        return []
    fire_budget = int(np.asarray(packed["bar_active"], bool).sum())
    fire_budget += int(np.asarray(packed["grp_open"]).max(axis=0).sum())
    tab = reachable_states(
        packed["step"], int(packed["init_state"]), (f, v1, v2),
        max_states, depth_cap=fire_budget + 2)
    if tab is None:
        return []
    states, depths, closed = tab
    S = states.size
    O = f.size
    N, L = _np_step(packed["step"])(
        states[:, None], f[None, :], v1[None, :], v2[None, :])
    # row of each next state in the table; the successors of the deepest
    # states may fall outside it, and are only read from interior states
    Nrow = np.clip(np.searchsorted(states, N), 0, S - 1)
    in_vocab = states[Nrow] == N
    Nrow = np.where(L & in_vocab, Nrow, 0)
    interior = (
        np.ones(S, bool) if closed else depths <= max(0, fire_budget)
    )
    if closed is False and not (in_vocab | ~L)[interior].all():
        return []

    def independent(a: int, b: int) -> bool:
        La, Lb = L[:, a] & interior, L[:, b] & interior
        if not np.array_equal(L[Nrow[:, a], b][La], L[:, b][La]):
            return False
        if not np.array_equal(L[Nrow[:, b], a][Lb], L[:, a][Lb]):
            return False
        both = La & Lb
        return np.array_equal(N[Nrow[:, a], b][both], N[Nrow[:, b], a][both])

    grp_f, grp_v1, grp_v2 = (np.asarray(a) for a in packed["grp"])
    live = np.asarray(packed["grp_open"]).max(axis=0) > 0
    keys = {tuple(t): i for i, t in enumerate(np.stack([f, v1, v2], axis=1))}
    out = []
    for g in np.flatnonzero(live):
        a = keys.get((int(grp_f[g]), int(grp_v1[g]), int(grp_v2[g])))
        if a is None:
            continue
        if all(independent(a, b) for b in range(O)):
            out.append(int(g))
    return out


def factor_packed(packed, max_states: int = 256) -> tuple[dict, int]:
    """Remove the independent crashed-op groups from a packed problem:
    each is a factor decided closed-form (fire nothing), so the returned
    pack keeps only the other groups' columns and G shrinks.  The input
    is not mutated.  Returns (packed', groups removed)."""
    try:
        drop = independent_groups(packed, max_states)
    except Exception:  # noqa: BLE001 — an optimization: never a crash
        drop = []
    if not drop:
        return packed, 0
    G0 = packed["G"]
    keep = [g for g in range(G0) if g not in set(drop)]
    grp_f, grp_v1, grp_v2 = (np.asarray(a) for a in packed["grp"])
    grp_open = np.asarray(packed["grp_open"])
    if keep:
        k = np.asarray(keep, np.int64)
        new_grp = (grp_f[k].copy(), grp_v1[k].copy(), grp_v2[k].copy())
        new_open = grp_open[:, k].copy()
    else:  # every group removed: keep one inert zero column
        new_grp = (np.zeros(1, grp_f.dtype), np.zeros(1, grp_v1.dtype),
                   np.zeros(1, grp_v2.dtype))
        new_open = np.zeros((grp_open.shape[0], 1), grp_open.dtype)
    out = dict(packed)
    out["grp"] = new_grp
    out["grp_open"] = new_open
    out["G"] = new_open.shape[1]
    _count("factorizations", len(drop))
    obs.counter("frontier.factorizations", len(drop))
    return out, len(drop)


# ---------------------------------------------------------------------------
# Honest exhaustion
# ---------------------------------------------------------------------------


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
    _count("undecidable_reports")
    obs.event(
        "frontier.undecidable", barrier=rep["barrier"],
        capacity=rep["capacity"], growth_rate=rep["growth_rate"],
        spill_bytes=rep["spill_bytes"], factor_count=rep["factor_count"],
    )
    _metrics.inc("frontier.undecidable")
    return rep


def undecidable_cause(report: dict) -> str:
    """The ``cause`` string for an undecidable unknown: a fixed prefix
    (machine-greppable) and the report as compact json."""
    return "undecidable under fixed memory: " + json.dumps(
        report, sort_keys=True, separators=(",", ":"))
