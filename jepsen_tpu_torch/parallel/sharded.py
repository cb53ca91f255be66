"""One history across a mesh: the context-parallel path and the
mesh-spanning wide stage's engine.

The port of the JAX package's ``parallel/sharded.py`` on the port's
``Mesh`` of logical shards.  The JAX engines are one ``shard_map``
program per device; here the shards are the leading axis of every table
(``parallel.mesh``), and the scans are host loops.

The context-parallel path (``sharded_analysis``, ``_run_core_sharded``,
``_route``) shards one history's frontier: each shard owns ``Fl`` rows,
and per closure round every shard expands its rows, routes every
candidate to shard ``hash(state, fok) % D`` (the JAX package's
``lax.all_to_all``, here the ported exchange kernel,
``ops.wide_kernel.mesh_exchange``, whose slot ``s`` of shard ``me`` goes
to shard ``(me + s) % D``), so that equal configurations meet on one
shard, and runs the exact ``frontier_update`` per shard; the global
fingerprint (a sum over shards) decides the fixpoint and any shard's
overflow or routing spill the loss.  ``mesh_round_probe`` times one
mesh-spanning update at a rung's shape.

The mesh-kernel path: ``mesh_update`` (the eager global-table entry to
``ops.wide_kernel.mesh_frontier_update``) and ``mesh_kernel_analysis``
(``_run_core_mesh``'s barrier scan).  Per barrier, closure rounds run while any shard grew, up to
``rounds``: a round is ``ops.wgl.expand_candidates`` on every shard and
then the mesh-spanning update.  Then the barrier's return filter
applies.  "Dead", the peak and growth are global, as the JAX package's
psums make them.  Each round reads its flags back once, and nothing
else syncs the host.

On a mesh of fewer than two shards, or at a geometry the mesh stage
cannot take, ``mesh_kernel_analysis`` falls back to the chunked engine
(``wgl.analysis`` with the fast engine under "fused"), as the JAX
package does.

``forget_mesh`` is the check service's device-loss hook (its
placement calls it on shrinking); the port keeps no per-mesh runner, so
it drops nothing.  Not ported: lane placement (``lane_shard``), which
waits with the cross-card mesh (ROADMAP queue B4); on one card it
places nothing.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from jepsen_tpu_torch import models as m
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.ops import hashing, spill, wgl, wide_kernel
from jepsen_tpu_torch.parallel.mesh import Mesh

#: The exact update's dedup backend on the context-parallel path: the
#: JAX package's ``frontier_update`` default, so that each shard keeps
#: the rows the JAX package keeps.
SHARDED_DEDUP = "sort"


def mesh_device_ids(mesh: Mesh) -> list[int]:
    """The card index a mesh's launches stamp on their spans' ``devices``
    attribute: the logical shards of ``parallel.mesh`` share one card,
    which is stamped once, so a per-device timeline counts its busy
    time once (the JAX package stamps each device of its mesh)."""
    return [mesh.device.index or 0]


def forget_mesh(mesh: Mesh) -> int:
    """Evict every cached runner built for ``mesh`` (the check
    service's placement calls it when it shrinks away from a lost
    shard); returns the number of cache entries dropped.  The JAX
    package caches jitted runners per mesh; the port builds its mesh
    stage's launches per call and keeps no state per mesh, so there is
    nothing to drop and the count is 0."""
    del mesh
    return 0


def _route(mesh: Mesh, C: int, state, fok, fcr, alive, cost):
    """Exchange every shard's candidate rows so that each lands on shard
    ``hash(state, fok) % D`` (the JAX package's ``_route``, every shard
    at once).  Each shard fills D fixed buckets of ``C`` rows, one per
    target, with its alive rows in (target, cost, index) order (the
    cheapest ``C`` per target; more is a spill), and the buckets are
    swapped through ``wide_kernel.mesh_exchange``.  Inputs are ``[D, n,
    ...]``; returns the received ``[D, D * C, ...]`` rows in source-shard
    order (state, fok, fcr, alive, cost) and the global spill flag."""
    D = mesh.size
    n = state.shape[1]
    W, G = fok.shape[2], fcr.shape[2]
    dev = state.device
    h = hashing.hash_rows(
        [state] + [fok[..., k] for k in range(W)], wide_kernel.MESH_ROUTE_SEED)
    target = h % D
    dead = (~alive).to(torch.int64)
    # a stable sort by (dead, target, cost): one key, ties by index
    cost64 = cost.to(torch.int64)
    cmax = int(cost64.max()) + 1 if n else 1
    key = ((dead * D + target) * cmax + cost64) * n + torch.arange(
        n, device=dev)
    order = torch.argsort(key, dim=1)
    st_t = target.gather(1, order)
    sd = dead.gather(1, order)
    shard = torch.arange(D, device=dev)
    onehot = (st_t[..., None] == shard) & (sd == 0)[..., None]
    counts = onehot.sum(1)  # [D source, D target]
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(n, device=dev) - starts.gather(1, st_t)
    keep = (sd == 0) & (rank < C)
    spilled = bool((counts > C).any())
    # pre-rotated slots: shard me's slot s holds its rows for (me + s) % D
    slot = (st_t - shard[:, None]) % D
    flat = torch.where(keep, slot * C + rank, D * C)
    cols = torch.cat([
        state.gather(1, order)[..., None].to(torch.int32),
        fok.gather(1, order[..., None].expand(-1, -1, W)).to(torch.int32),
        fcr.gather(1, order[..., None].expand(-1, -1, G)).to(torch.int32),
        keep[..., None].to(torch.int32),
        cost.gather(1, order)[..., None].to(torch.int32),
    ], 2)
    NC = cols.shape[2]
    send = torch.zeros(D, D * C + 1, NC, dtype=torch.int32, device=dev)
    send.scatter_(1, flat[..., None].expand(-1, -1, NC), cols)
    send = send[:, : D * C].reshape(D, D, C, NC).contiguous()
    recv = wide_kernel.mesh_exchange(mesh, send)
    # shard r's slot s came from source (r - s) % D: un-rotate into
    # source order
    src_slot = (shard[:, None] - shard[None, :]) % D  # [r, src] -> slot
    rows = recv.gather(
        1, src_slot[..., None, None].expand(-1, -1, C, NC)).reshape(D, D * C, NC)
    return (rows[..., 0], rows[..., 1:1 + W],
            rows[..., 1 + W:1 + W + G].to(fcr.dtype),
            rows[..., 1 + W + G] != 0, rows[..., 2 + W + G], spilled)


def _run_core_sharded(mesh: Mesh, packed: dict, Fl: int, R: int):
    """The context-parallel barrier scan on ``mesh`` at ``Fl`` rows per
    shard (bucket capacity ``C = 2 * Fl`` bounds the exchange); returns
    (valid, failed_at, lossy, peak) as host values.  Per barrier,
    closure rounds run while the global fingerprint changes, up to
    ``R``; a barrier still changing after ``R`` rounds is loss."""
    dev = mesh.device
    D = mesh.size
    C = 2 * Fl
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
    alive[0, 0] = True  # the initial config starts on shard 0 only
    failed = -1
    peak = 1
    lossy = False
    for b in range(int(packed["B"])):
        if not packed["bar_active"][b]:
            continue
        xmov = [a[b].expand(D, P) for a in mov]
        xgrp_open = grp_open[b].expand(D, G)
        fp = [hashing.MASK32] * 3  # the JAX package's all-ones start
        changed = True
        r = 0
        while r < R and changed:
            cat = wgl.expand_candidates(
                step, eye_g, slot_lane, slot_mask, slot_onehot,
                state, fok, fcr, alive, *xmov, *grp, xgrp_open,
            )
            cost = wgl._candidate_cost(cat[1], cat[2])
            *routed, spilled = _route(mesh, C, *cat[:4], cost)
            state, fok, fcr, alive, ovf, fp_local = hashing.frontier_update(
                *routed, Fl, dedup_backend=SHARDED_DEDUP)
            fp2 = (fp_local.sum(0) & hashing.MASK32).tolist()
            lossy = lossy or spilled or bool(ovf.any())
            changed = fp2 != fp
            fp = fp2
            r += 1
        lossy = lossy or changed  # closure rounds exhausted still growing
        lane = int(bar_slot[b]) // 32
        bit = bar_bits[b]
        alive = alive & ((fok[..., lane] & bit) != 0)
        fok = fok & ~torch.where(w_iota == lane, bit, 0)
        n_alive = int(alive.sum())
        if n_alive == 0:
            failed = b
            break
        peak = max(peak, n_alive)
    return failed < 0 and bool(alive.any()), failed, lossy, peak


def sharded_analysis(
    model: m.Model,
    history: Sequence[dict],
    mesh: Mesh,
    capacity: int | Sequence[int] = (1024, 8192),
    rounds: int = 8,
    max_groups: int = 64,
    max_procs: int = 128,
) -> dict:
    """Decide one history with its frontier sharded over ``mesh``'s
    shards (the JAX package's ``sharded_analysis``).  ``capacity`` is the
    total frontier size, split evenly over the shards; a sequence widens
    like ``ops.wgl.analysis``.  Kills are content-decided (the exact
    update), so False is final when no shard lost rows; True is a
    constructive witness; an exhausted ladder is ``unknown``.  Runs on
    the mesh's device."""
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
    result = None
    dev_ids = mesh_device_ids(mesh)
    for cap in capacities:
        Fl = max(8, (int(cap) + D - 1) // D)
        with obs.span("sharded.launch", devices=dev_ids, capacity=Fl * D):
            valid, failed_at, lossy, peak = _run_core_sharded(
                mesh, packed, Fl, int(rounds))
        stats = {
            "frontier-peak": int(peak),
            "capacity": Fl * D,
            "devices": D,
            "lossy?": bool(lossy),
        }
        if failed_at < 0 and valid:
            return {"valid?": True, "kernel": stats}
        op = history[int(packed["bar_opid"][failed_at])] if failed_at >= 0 else None
        if not lossy:
            return {"valid?": False, "op": op, "kernel": stats}
        result = {
            "valid?": "unknown",
            "cause": "frontier capacity or closure rounds exhausted",
            "op": op,
            "kernel": stats,
        }
    return result


def mesh_round_probe(mesh: Mesh, capacity: int, P_: int, G: int, W: int = 1,
                     rounds: int = 3, seed: int = 0) -> dict:
    """Time one mesh-spanning update per round at a rung's global
    candidate shape (``hashing.probe_candidates``): ``{"mesh": seconds
    per round, "occupancy": wide_kernel.mesh_occupancy(...)}``, with
    ``"mesh"`` None at a shape the mesh stage cannot take (counted as
    ``dedup.mesh_fallback``).  On the card the rounds run between CUDA
    events after one untimed call; on the CPU the host clock times them.
    It emits one ``dedup.mesh_round`` span (mesh_devices,
    candidates, capacity, rounds, per_round_us, and ``interpret``: True
    where the wrappers ran their plain versions)."""
    D = mesh.size
    occ = wide_kernel.mesh_occupancy(
        int(capacity), P_, G, W=W, max_count=P_ + 1, devices=D)
    if not occ["feasible"]:
        obs.counter("dedup.mesh_fallback", capacity=int(capacity),
                    mesh_devices=D)
        return {"mesh": None, "occupancy": occ}
    dev = mesh.device
    tables = [torch.from_numpy(a).to(dev) for a in
              hashing.probe_candidates(int(capacity), P_, G, W, seed)]
    n = int(tables[0].shape[0])
    cost = torch.zeros(n, dtype=torch.int32, device=dev)

    def update():
        return mesh_update(mesh, *tables, cost, int(capacity), window=4,
                           n_parents=int(capacity), max_count=P_ + 1)

    update()  # the first call outside the timed window
    rounds = max(1, int(rounds))
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            update()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / rounds
    else:
        t0 = time.perf_counter()
        for _ in range(rounds):
            update()
        dt = (time.perf_counter() - t0) / rounds
    obs.span_event(
        "dedup.mesh_round", dt, backend="fused", mesh_devices=D,
        candidates=n, capacity=int(capacity), rounds=rounds,
        per_round_us=round(dt * 1e6, 1), interpret=dev.type != "cuda",
    )
    return {"mesh": dt, "occupancy": occ}


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
        obs.counter("dedup.mesh_fallback", mesh_devices=D,
                    capacity=int(max(capacities)))
        return wgl.analysis(
            model, history, capacity=tuple(int(c) for c in capacities),
            rounds=int(rounds), max_groups=max_groups, max_procs=max_procs,
            fast=True, dedup_backend="fused", device=mesh.device,
        )

    interpret = mesh.device.type != "cuda"
    dev_ids = mesh_device_ids(mesh)
    result = None
    for cap in capacities:
        Fl, _mc, _ok = _mesh_rung_geometry(cap, D, packed)
        with obs.span("sharded.mesh_launch", devices=dev_ids, mesh_devices=D,
                      capacity=Fl * D, per_device_capacity=Fl,
                      interpret=interpret):
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
