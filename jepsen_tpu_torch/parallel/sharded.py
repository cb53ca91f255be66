"""One history across a mesh: the mesh-spanning wide stage's engine.

The port of the JAX package's mesh-kernel path in
``parallel/sharded.py``: ``mesh_update`` (the eager global-table entry
to ``ops.wide_kernel.mesh_frontier_update``) and
``mesh_kernel_analysis`` (``_run_core_mesh``'s barrier scan).  The JAX
engine is one ``shard_map`` program per device; here the shards are the
leading axis of every table (``parallel.mesh``), and the scan is a host
loop.  Per barrier, closure rounds run while any shard grew, up to
``rounds``: a round is ``ops.wgl.expand_candidates`` on every shard and
then the mesh-spanning update.  Then the barrier's return filter
applies.  "Dead", the peak and growth are global, as the JAX package's
psums make them.  Each round reads its flags back once, and nothing
else syncs the host.

On a mesh of fewer than two shards, or at a geometry the mesh stage
cannot take, ``mesh_kernel_analysis`` falls back to the chunked engine
(``wgl.analysis`` with the fast engine under "fused"), as the JAX
package does.

Not ported yet: the context-parallel path without the kernel
(``_route``, ``sharded_analysis``, ``mesh_round_probe``; ROADMAP queue
A4) and lane placement (``lane_shard``, queue B4).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from jepsen_tpu_torch import models as m
from jepsen_tpu_torch.ops import spill, wgl, wide_kernel
from jepsen_tpu_torch.parallel.mesh import Mesh


def mesh_update(mesh: Mesh, state, fok, fcr, alive, cost, capacity: int, *,
                window: int = 4, n_parents: int | None = None,
                max_count: int | None = None):
    """Eager global-table entry to the mesh-spanning stage (tests,
    probes): split the ``[n]`` candidate table row-wise into the mesh's
    D shards, with the global child bit ``index >= n_parents``, and run
    ``wide_kernel.mesh_frontier_update``.  ``capacity`` is global (split
    evenly); ``cost`` is accepted and unused.  Returns the per-shard
    outputs (state', fok', fcr', alive', child' as ``[D, capacity / D]``)
    with the global overflow flag and fingerprint, in the tuple order of
    the JAX package's ``mesh_update``.  Positions are those of each
    shard's class-hash owner slice, as in the JAX package; the content
    set, child bits, overflow and fingerprint are what a single-shard
    update at the same global capacity gives."""
    D = mesh.size
    n = int(state.shape[0])
    if n % D or int(capacity) % D:
        raise ValueError(f"{n} rows and capacity {capacity} must split "
                         f"evenly into {D} shards")
    dev = mesh.device
    first = n if n_parents is None else int(n_parents)
    child = torch.arange(n, device=dev) >= first

    def shard(t):
        t = t.to(dev)
        return t.reshape(D, n // D, *t.shape[1:]).contiguous()

    return wide_kernel.mesh_frontier_update(
        mesh, shard(state), shard(fok), shard(fcr), shard(alive), None,
        int(capacity) // D, window=window, max_count=max_count,
        child=shard(child),
    )


def _mesh_rung_geometry(cap: int, D: int, packed: dict) -> tuple[int, int, bool]:
    """(Fl, max_count, feasible) for one rung of ``cap`` total rows on
    ``D`` shards: Fl is the per-shard frontier slice, rounded up to the
    fused update's 64-row granule."""
    Fl = max(8, (int(cap) + D - 1) // D)
    Fl = ((Fl + 63) // 64) * 64
    max_count = int(packed["mov"][0].shape[-1]) + 1
    n_loc = Fl * (1 + int(packed["P"]) + int(packed["G"]))
    feasible = wide_kernel.mesh_feasible(D * n_loc, D * Fl, max_count, D)
    return Fl, max_count, feasible


def _run_core_mesh(mesh: Mesh, packed: dict, Fl: int, R: int, window: int):
    """The barrier scan on ``mesh`` at ``Fl`` rows per shard; returns
    (valid, failed_at, lossy, peak) as host values."""
    dev = mesh.device
    D = mesh.size
    P, G, W = int(packed["P"]), int(packed["G"]), int(packed["W"])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    step = packed["step"]
    eye_g = torch.eye(G, dtype=torch.int16, device=dev)
    slot_lane = t(packed["slot_lane"]).long()
    slot_onehot = t(packed["slot_onehot"])
    slot_mask = slot_onehot.sum(1, dtype=torch.int32)
    mov = [t(a) for a in packed["mov"]]
    grp = [t(a).expand(D, G) for a in packed["grp"]]
    grp_open = t(packed["grp_open"])
    bar_slot = packed["bar"][3]
    bar_bits = wgl._bit(t(bar_slot))
    w_iota = torch.arange(W, device=dev)

    state = torch.full((D, Fl), int(packed["init_state"]), dtype=torch.int32,
                       device=dev)
    fok = torch.zeros(D, Fl, W, dtype=torch.int32, device=dev)
    fcr = torch.zeros(D, Fl, G, dtype=torch.int16, device=dev)
    alive = torch.zeros(D, Fl, dtype=torch.bool, device=dev)
    alive[0, 0] = True  # the initial config lives on shard 0 only
    failed = torch.full((), -1, dtype=torch.int64, device=dev)
    peak = torch.ones((), dtype=torch.int64, device=dev)
    lossy = False
    for b in range(int(packed["B"])):
        if not packed["bar_active"][b]:
            continue
        xmov = [a[b].expand(D, P) for a in mov]
        xgrp_open = grp_open[b].expand(D, G)
        for _r in range(R):
            cat = wgl.expand_candidates(
                step, eye_g, slot_lane, slot_mask, slot_onehot,
                state, fok, fcr, alive, *xmov, *grp, xgrp_open,
            )
            state, fok, fcr, alive, ovf, _fp, child = (
                wide_kernel.mesh_frontier_update(
                    mesh, *cat[:4], None, Fl, window=window, n_parents=Fl,
                    max_count=P + 1,
                ))
            # The round's one host sync.  A failure recorded at an
            # earlier barrier ends the scan: this round ran on an empty
            # frontier, which the JAX scan skips.
            grew, ovf_h, failed_h, _ = torch.stack([
                (alive & child).any().long(), ovf.long(), failed, peak,
            ]).tolist()
            if failed_h >= 0:
                return False, failed_h, lossy, int(peak)
            lossy = lossy or bool(ovf_h)
            if not grew:
                break
        else:
            lossy = True  # closure rounds exhausted while still growing
        lane = int(bar_slot[b]) // 32
        bit = bar_bits[b]
        alive = alive & ((fok[..., lane] & bit) != 0)
        fok = fok & ~torch.where(w_iota == lane, bit, 0)
        n_alive = alive.sum()
        failed = torch.where((n_alive == 0) & (failed < 0), b, failed)
        peak = torch.maximum(peak, n_alive)
    failed_h, peak_h, any_alive = torch.stack(
        [failed, peak, alive.any().long()]).tolist()
    return bool(any_alive), failed_h, lossy, peak_h


def mesh_kernel_analysis(
    model: m.Model,
    history: Sequence[dict],
    mesh: Mesh,
    capacity: int | Sequence[int] = (8192,),
    rounds: int = 8,
    window: int = 4,
    max_groups: int = 64,
    max_procs: int = 128,
) -> dict:
    """Decide one history with the mesh-spanning fused wide stage across
    every shard of ``mesh``.  ``capacity`` is the total frontier size
    per rung (split evenly over the shards).

    As in the JAX package: kills are hash-decided, so a False verdict is
    marked ``provisional?`` (callers confirm refutations before
    reporting them); True is a constructive witness; an exhausted
    ladder returns ``unknown`` whose undecidability report cites the
    mesh capacity (shards × per-shard rows).  On fewer than two shards,
    or where a rung's geometry is infeasible, the history goes to the
    chunked engine on the mesh's device instead
    (``wgl.analysis(fast=True, dedup_backend="fused")`` at the same
    capacities and rounds), as in the JAX package."""
    D = mesh.size
    try:
        packed = wgl.pack(model, history)
    except wgl.NotTensorizable as e:
        return {"valid?": "unknown", "cause": f"not tensorizable: {e}"}
    if packed["B"] == 0:
        return {"valid?": True}
    if packed["G"] > max_groups:
        return {"valid?": "unknown", "cause": f"{packed['G']} crashed-op groups exceeds {max_groups}"}
    if packed["P"] > max_procs:
        return {"valid?": "unknown", "cause": f"{packed['P']} process slots exceeds {max_procs}"}
    packed = wgl.pad_packed(packed)

    capacities = [capacity] if isinstance(capacity, int) else list(capacity)
    if D < 2 or any(not _mesh_rung_geometry(cap, D, packed)[2]
                    for cap in capacities):
        return wgl.analysis(
            model, history, capacity=tuple(int(c) for c in capacities),
            rounds=int(rounds), max_groups=max_groups, max_procs=max_procs,
            fast=True, dedup_backend="fused", device=mesh.device,
        )

    interpret = mesh.device.type != "cuda"
    result = None
    for cap in capacities:
        Fl, _mc, _ok = _mesh_rung_geometry(cap, D, packed)
        valid, failed_at, lossy, peak = _run_core_mesh(
            mesh, packed, Fl, int(rounds), int(window))
        stats = {
            "frontier-peak": int(peak),
            "capacity": Fl * D,
            "per-device-capacity": Fl,
            "devices": D,
            "mesh_devices": D,
            "lossy?": lossy,
            "interpret": interpret,
            "failed-at": failed_at,
        }
        if failed_at < 0 and valid:
            return {"valid?": True, "kernel": stats}
        op = history[int(packed["bar_opid"][failed_at])] if failed_at >= 0 else None
        if not lossy:
            return {"valid?": False, "op": op, "kernel": stats,
                    "provisional?": True}
        result = {"valid?": "unknown", "op": op, "kernel": stats}
    rep = spill.undecidability_report(
        capacity=int(max(capacities)),
        frontier_rows=stats["capacity"],
        peak_frontier=stats["frontier-peak"],
        barrier=failed_at if failed_at >= 0 else int(packed["B"]),
        barriers_total=int(packed["B"]),
        mesh_devices=D,
        per_device_rows=stats["per-device-capacity"],
        reason="mesh-capacity",
    )
    result["undecidability"] = rep
    result["cause"] = spill.undecidable_cause(rep)
    return result
