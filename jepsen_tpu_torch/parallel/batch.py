"""Batched linearizability checking: the capacity ladder.

The port of the JAX package's ``parallel.batch.batch_analysis`` main
path.  Every history is packed to common (B, P, G) buckets and stacked,
and one batched engine launch checks a sub-batch of lanes:

  1. rung 0, the greedy witness walk (``wgl.greedy_run``): most valid
     lanes resolve here;
  2. the capacity rungs, each re-batching only the lanes still pending:
     the async engine (``wgl.run_async``; with ``carry_frontier`` a lane
     resumes at its saved exact pre-loss frontier instead of re-running
     from barrier 0) or the barrier-scan "sync" engine
     (``wgl.batched_runner``);
  3. the exact stages (``exact_escalation``): the barrier-scan engine
     with the exact update (``wgl.exact_batched_runner``), sub-batched
     by a lane-row budget; their refutations are final;
  4. the fast rungs' refutations are hash-decided, so each is confirmed
     by the exact CPU sweep in a spawned worker process, concurrently
     with the remaining rungs;
  5. with a mesh of two or more shards and the fused backend, the lanes
     the last stage leaves undecided get one run of the mesh-spanning
     stage at shards × the top rung (the mesh rescue).

``True`` is sound from every rung (a surviving frontier is a witness);
``False`` is reported only once the exact sweep confirms it, or from an
exact stage.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Sequence

import numpy as np
import torch

from jepsen_tpu_torch import _confirm_worker
from jepsen_tpu_torch import models as m
from jepsen_tpu_torch._platform import resolve_device
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.ops import hashing, wgl
from jepsen_tpu_torch.parallel import sharded
from jepsen_tpu_torch.parallel.mesh import CROSS_CARD, Mesh

#: Reused across batch_analysis calls (spawn startup is ~seconds).
#: Workers run only the torch-free ``_confirm_worker`` tasks.
_CONFIRM_POOL: ProcessPoolExecutor | None = None

#: Engine frontier rows per launch (the JAX package's budgets); the
#: carried-frontier variant halves it because the resume snapshot
#: doubles the engine's resident frontier, and the exact engine's sort
#: and domination buffers take a quarter.
_FAST_LANE_BUDGET = 64 * 1024
_CARRY_LANE_BUDGET = 32 * 1024
_EXACT_LANE_BUDGET = 16 * 1024

#: The padded-geometry buckets every batched launch quantizes to.
P_BUCKETS = (8, 16, 32, 64, 128)
G_BUCKETS = (4, 8, 16, 32, 64)


def bucket_geometry(B: int, P: int, G: int) -> tuple[int, int, int]:
    """The padded (B, P, G) bucket a packed history launches at."""
    return (
        wgl.pad_B(B),
        wgl._bucket(P, list(P_BUCKETS)),
        wgl._bucket(G, list(G_BUCKETS)),
    )


def padded_batch(n: int) -> int:
    """The padded lane count a launch of ``n`` lanes runs at: the next
    power of two, floor 8.  Padded lanes replicate the last lane."""
    return 1 << max(3, (n - 1).bit_length())


def _stays_pending(valid, fat, lossy) -> bool:
    """Whether one lane's (valid, failed_at, lossy) outcome leaves it
    pending for the next rung: neither resolved True nor a lossless
    refutation.  The one predicate behind both the snapshot fetch and
    the classification."""
    if fat < 0 and valid:
        return False  # resolved True
    if fat >= 0 and not lossy:
        return False  # lossless refutation (confirmation-bound)
    return True


def _resolve_confirmation(res: dict, cpu_res: dict) -> dict:
    """Fold an exact-sweep confirmation verdict into the device result."""
    if cpu_res["valid?"] is False:
        return {**res, "confirmed?": True}
    if cpu_res["valid?"] is True:
        # a hash collision killed a live config; the sweep's witness wins
        return cpu_res
    return {
        "valid?": "unknown",
        "cause": (
            "device refutation; exact confirmation inconclusive: "
            + str(cpu_res.get("cause", "budget exceeded"))
        ),
        "kernel": res.get("kernel"),
    }


def _default_workers(workers: int | None) -> int:
    return workers or min(8, os.cpu_count() or 1)


def confirm_pool(workers: int | None = None) -> ProcessPoolExecutor:
    """The process pool of confirmation workers (spawned, torch-free)."""
    global _CONFIRM_POOL
    if _CONFIRM_POOL is None:
        _CONFIRM_POOL = ProcessPoolExecutor(
            max_workers=_default_workers(workers),
            mp_context=multiprocessing.get_context("spawn"),
        )
    return _CONFIRM_POOL


def shutdown_confirm_pool() -> None:
    """Stop the confirmation workers (a later call spawns new ones)."""
    global _CONFIRM_POOL
    if _CONFIRM_POOL is not None:
        _CONFIRM_POOL.shutdown(wait=True, cancel_futures=True)
        _CONFIRM_POOL = None


def warm_confirm_pool(workers: int | None = None) -> list[dict]:
    """Spawn the confirmation workers ahead of a timed run; returns each
    worker's ``_confirm_worker.probe``."""
    pool = confirm_pool(workers)
    futs = [pool.submit(_confirm_worker.probe)
            for _ in range(_default_workers(workers))]
    return [f.result() for f in futs]


def _submit_confirmation(workers, *args):
    """Submit one confirmation, rebuilding a broken pool once.  Returns
    the future, or None when no worker could take the job."""
    for _ in range(2):
        try:
            return confirm_pool(workers).submit(
                _confirm_worker.confirm_refutation, *args)
        except BrokenProcessPool:
            _drop_confirm_pool()
    return None


def _drop_confirm_pool() -> None:
    """Forget a broken pool so the next submit spawns a new one."""
    global _CONFIRM_POOL
    if _CONFIRM_POOL is not None:
        _CONFIRM_POOL.shutdown(wait=False, cancel_futures=True)
        _CONFIRM_POOL = None


def _stack(packs: list[dict], B: int, P: int, G: int) -> dict:
    padded = [wgl.pad_packed(p, B=B, P=P, G=G) for p in packs]
    out = {
        "init_state": np.stack([p["init_state"] for p in padded]),
        "n_active": np.array([p["bar_active"].sum() for p in packs], np.int32),
        "bar_active": np.stack([p["bar_active"] for p in padded]),
    }
    for i, name in enumerate(["bar_f", "bar_v1", "bar_v2", "bar_slot"]):
        out[name] = np.stack([p["bar"][i] for p in padded])
    for i, name in enumerate(["mov_f", "mov_v1", "mov_v2", "mov_open"]):
        out[name] = np.stack([p["mov"][i] for p in padded])
    for i, name in enumerate(["grp_f", "grp_v1", "grp_v2"]):
        out[name] = np.stack([p["grp"][i] for p in padded])
    out["grp_open"] = np.stack([p["grp_open"] for p in padded])
    return out


def _pad_lanes(a: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad the lane axis to ``n_pad`` by replicating the last lane."""
    n = a.shape[0]
    if n_pad == n:
        return a
    return np.concatenate([a, np.repeat(a[-1:], n_pad - n, axis=0)], axis=0)


def _launch(st_engine: str, batch_cap: int, sub: list[dict],
            sub_resumes, dedup: str, device, rounds: int):
    """Stack ``sub`` to common bucket shapes and run one batched engine
    launch ("greedy", "async", "sync" or "exact"); returns (valid,
    failed_at, lossy, peak) as host arrays of len(sub), the padded lane
    count, and the async engine's resume snapshot as device tensors (or
    None)."""
    B, P, G = bucket_geometry(
        max(p["B"] for p in sub), max(p["P"] for p in sub),
        max(p["G"] for p in sub),
    )
    W = (P + 31) // 32
    stacked = _stack(sub, B, P, G)
    n = len(sub)
    n_pad = padded_batch(n)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(_pad_lanes(a, n_pad))).to(device)

    tables = {k: dev(stacked[k]) for k in wgl.TABLE_ORDER}
    slot_lane, slot_onehot = wgl._slot_tables(P, W)
    slot_lane = torch.from_numpy(slot_lane).long().to(device)
    slot_onehot = torch.from_numpy(slot_onehot).to(device)
    n_active = dev(stacked["n_active"])
    step = sub[0]["step"]
    if st_engine == "greedy":
        finished, _stuck, _fired = wgl.greedy_run(
            step, B, dev(stacked["init_state"]), n_active, tables,
            slot_lane, slot_onehot)
        finished = finished.cpu().numpy()[:n]
        # unresolved = lossy -> stays pending for the beam ladder
        return (finished, np.full(n, -1, np.int32), ~finished,
                np.ones(n, np.int32)), n_pad, None
    if st_engine in ("sync", "exact"):
        runner = (wgl.batched_runner if st_engine == "sync"
                  else wgl.exact_batched_runner)
        tables["bar_active"] = dev(stacked["bar_active"])
        out = runner(step, batch_cap, int(rounds), dev(stacked["init_state"]),
                     tables, slot_lane, slot_onehot, dedup=dedup)
        out = torch.stack([o.to(torch.int64) for o in out], 1).cpu().numpy()[:n]
        return (out[:, 0].astype(bool), out[:, 1].astype(np.int32),
                out[:, 2].astype(bool), out[:, 3].astype(np.int32)), n_pad, None
    F = batch_cap
    bptr0, st0, fo0, fc0, al0 = wgl.fresh_frontier(
        n, F, W, G, stacked["init_state"])
    if sub_resumes is not None:
        for j, r in enumerate(sub_resumes):
            if r is not None:
                bptr0[j], st0[j], fo0[j], fc0[j], al0[j] = wgl.pad_resume(r, F, W, G)
    # Tick budget from the MAX REMAINING barriers: resumed lanes skip
    # their verified prefix.
    b_rem = int(max(1, (stacked["n_active"] - bptr0).max()))
    b_rem = 1 << max(5, (b_rem - 1).bit_length())
    T = wgl.async_ticks(min(b_rem, B), batch_cap)
    out = wgl.run_async(
        step, F, T, dev(bptr0), dev(st0), dev(fo0), dev(fc0), dev(al0),
        n_active, tables, slot_lane, slot_onehot, dedup=dedup,
    )
    valid, failed_at, lossy, peak = (x.cpu().numpy()[:n] for x in out[:4])
    return (valid, failed_at, lossy, peak), n_pad, out[4:]


def _mesh_rescue(model, histories, packs, idxs, exhausted, results, mesh,
                 top_cap, confirm_refutations, confirm_max_configs, stats,
                 rounds):
    """One run of the mesh-spanning stage, at shards × ``top_cap``, for
    each lane the ladder left undecided (the JAX package's order and
    semantics).  Updates ``results``; returns the lanes still
    undecided."""
    D = mesh.size
    rescue_cap = top_cap * D
    t0 = time.perf_counter()
    still = []
    for k in exhausted:
        i = idxs[k]
        r = sharded.mesh_kernel_analysis(model, histories[i], mesh,
                                         capacity=(rescue_cap,),
                                         rounds=rounds)
        if r["valid?"] is True:
            results[i] = r
        elif r["valid?"] is False and not confirm_refutations:
            results[i] = r  # unconfirmed: carries provisional?
        elif r["valid?"] is False:
            # the chunked fallback's refutations carry no failed-at:
            # then the sweep runs the whole history
            fat = int(r.get("kernel", {}).get("failed-at", -1))
            op_pos = int(packs[k]["bar_opid"][fat]) if fat >= 0 else None
            cpu_res = wgl_cpu.sweep_analysis(
                model, histories[i], max_configs=confirm_max_configs,
                stop_at_index=op_pos)
            results[i] = _resolve_confirmation(r, cpu_res)
            if results[i]["valid?"] == "unknown":
                still.append(k)
        else:
            # unknown at mesh capacity: the mesh-capacity report becomes
            # the attributable cause
            if r.get("cause"):
                results[i] = r
            still.append(k)
    if stats is not None:
        stats["mesh_rescue"] = dict(
            capacity=rescue_cap, shards=D, lanes=len(exhausted),
            resolved=len(exhausted) - len(still),
            seconds=time.perf_counter() - t0,
        )
    return still


def batch_analysis(
    model: m.Model,
    histories: Sequence[Sequence[dict]],
    capacity: int | Sequence[int] = (64, 512, 4096),
    rounds: int = 8,
    carry_frontier: bool = True,
    greedy_first: bool = True,
    confirm_refutations: bool = True,
    cpu_fallback: bool = True,
    exact_escalation: Sequence[int] = (),
    dedup_backend: str | None = None,
    device=None,
    confirm_workers: int | None = None,
    confirm_max_configs: int = 2_000_000,
    engine: str = "async",
    mesh=None,
    checkpoint_dir=None,
    deadline=None,
    admission=None,
    stats: dict | None = None,
) -> list[dict]:
    """Check many histories against one model on the capacity ladder.

    ``capacity`` lists the fast rungs of ``engine``: "async" (the
    lane-asynchronous engine, the default) or "sync" (the barrier-scan
    engine, whose closure takes at most ``rounds`` rounds per barrier).
    Each rung re-batches only the lanes still pending, sub-batched to the
    lane budget and padded to a power of two.  ``exact_escalation``
    appends exact stages at those capacities (the barrier-scan engine
    with the exact update, ``rounds`` per barrier, sub-batched by
    ``_EXACT_LANE_BUDGET`` rows); their refutations are final.
    ``greedy_first`` prepends the greedy witness walk.
    ``carry_frontier`` resumes escalated async lanes from their
    snapshots.
    ``confirm_refutations`` confirms every refutation with the exact
    sweep in worker processes (False reports them unconfirmed).
    ``cpu_fallback`` decides the lanes the ladder leaves unknown with the
    exact sweep, in process.  ``dedup_backend``: "fused" (the default;
    the fused CUDA update on wide rungs), "bucket" or "sort".  ``device``: the
    card unless the caller asks for "cpu" (with a mesh and no device,
    the mesh's device).  ``mesh``: a ``parallel.mesh.Mesh``; the ladder
    runs on ``device`` (its lanes are not placed across shards, which
    would mean nothing on one card), and with two or more shards under
    "fused" the lanes the last stage leaves undecided get the mesh
    rescue before ``cpu_fallback``: ``mesh_kernel_analysis`` at shards ×
    the top rung (``wgl.analysis`` where the mesh stage is infeasible); True lands, False is confirmed in process by the exact
    sweep (or stays provisional when ``confirm_refutations`` is False),
    unknown keeps its mesh-capacity cause.  ``stats``, when given, is
    filled with per-rung records (stage, engine, capacity, lanes,
    padded, seconds, resolved, refuted, unknowns) and, when the rescue
    ran, ``mesh_rescue`` (capacity, shards, lanes, resolved, seconds).

    Not in this port yet, and refused rather than ignored: a mesh across
    cards, checkpoints, deadlines, rung admission (``wgl.SERVICES_QUEUE``)
    and device confirmation.

    Returns one result per history, in order.
    """
    if engine not in ("sync", "async"):
        raise ValueError(f"unknown engine {engine!r}; expected 'sync' or 'async'")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise NotImplementedError(
            "mesh must be a parallel.mesh.Mesh of logical shards on one "
            f"device; other meshes are not ported ({CROSS_CARD})")
    for name, val in (("checkpoint_dir", checkpoint_dir),
                      ("deadline", deadline), ("admission", admission)):
        if val is not None:
            raise NotImplementedError(
                f"{name} is not ported ({wgl.SERVICES_QUEUE})")
    if confirm_refutations not in (True, False):
        raise NotImplementedError(
            f"confirm_refutations={confirm_refutations!r}: only worker "
            "confirmation (True) or none (False) is ported")
    dedup = hashing.resolve_dedup_backend(dedup_backend)
    if device is None and mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    histories = list(histories)
    results: list[dict | None] = [None] * len(histories)
    packs: list[dict] = []
    idxs: list[int] = []
    t_pack = time.perf_counter()
    for i, hist in enumerate(histories):
        try:
            p = wgl.pack(model, hist)
        except wgl.NotTensorizable as e:
            results[i] = {"valid?": "unknown", "cause": f"not tensorizable: {e}"}
            continue
        if p["B"] == 0:
            results[i] = {"valid?": True}
        else:
            packs.append(p)
            idxs.append(i)
    rung_stats: list[dict] = []
    if stats is not None:
        stats["pack_s"] = time.perf_counter() - t_pack
        stats["rungs"] = rung_stats

    batch_caps = [capacity] if isinstance(capacity, int) else list(capacity)
    batch_caps = [int(c) for c in batch_caps]
    exact_caps = [int(c) for c in (exact_escalation or ())]
    stages = ([(engine, c) for c in batch_caps]
              + [("exact", c) for c in exact_caps])
    if greedy_first and stages:
        stages = [("greedy", 1)] + stages
    pending = list(range(len(packs)))
    resumes: dict[int, tuple] = {}
    confirm_futs: dict[int, tuple] = {}  # hist idx -> (future, result, op_pos)
    for si, (st_engine, batch_cap) in enumerate(stages):
        if not pending:
            break
        t_stage = time.perf_counter()
        group = pending
        if st_engine == "exact":
            budget = _EXACT_LANE_BUDGET
        elif st_engine == "async" and carry_frontier:
            budget = _CARRY_LANE_BUDGET
        else:
            budget = _FAST_LANE_BUDGET
        fetch_snaps = (st_engine == "async" and carry_frontier
                       and any(e == "async" for e, _ in stages[si + 1:]))
        lanes_cap = max(1, budget // batch_cap)
        lane_out: dict[int, tuple] = {}
        padded = 0
        for s0 in range(0, len(group), lanes_cap):
            part = group[s0: s0 + lanes_cap]
            sub_res = ([resumes.get(k) for k in part]
                       if st_engine == "async" and carry_frontier else None)
            (v, fat, lz, pk), n_pad, snap = _launch(
                st_engine, batch_cap, [packs[k] for k in part], sub_res,
                dedup, device, rounds)
            padded += n_pad
            for j, k in enumerate(part):
                lane_out[k] = (v[j], fat[j], lz[j], pk[j])
            if fetch_snaps and snap is not None:
                local = [j for j in range(len(part))
                         if _stays_pending(v[j], fat[j], lz[j])]
                if local:
                    sel = torch.tensor(local, device=device)
                    bs, sst, sfo, sfc, sal = (a[sel].cpu().numpy() for a in snap)
                    for t, j in enumerate(local):
                        resumes[part[j]] = (int(bs[t]), sst[t], sfo[t],
                                            sfc[t], sal[t])
            del snap
        still = []
        n_true = n_refuted = 0
        for k in group:
            valid_k, fat_k, lossy_k, peak_k = lane_out[k]
            i = idxs[k]
            kstats = {"frontier-peak": int(peak_k), "capacity": batch_cap,
                      "lossy?": bool(lossy_k)}
            if not _stays_pending(valid_k, fat_k, lossy_k) and fat_k < 0:
                n_true += 1
                results[i] = {"valid?": True, "kernel": kstats}
            elif not _stays_pending(valid_k, fat_k, lossy_k):
                n_refuted += 1
                op_pos = int(packs[k]["bar_opid"][int(fat_k)])
                res = {"valid?": False, "op": histories[i][op_pos],
                       "kernel": kstats}
                results[i] = res  # final from an exact stage
                if st_engine != "exact" and confirm_refutations:
                    fut = _submit_confirmation(
                        confirm_workers, model, list(histories[i]),
                        confirm_max_configs, op_pos)
                    confirm_futs[i] = (fut, res, op_pos)
            else:
                still.append(k)
                results[i] = {
                    "valid?": "unknown",
                    "cause": "frontier capacity or closure rounds exhausted",
                    "kernel": kstats,
                }
        pending = still
        rung_stats.append(dict(
            stage=si, engine=st_engine, capacity=batch_cap,
            lanes=len(group), padded=padded,
            seconds=time.perf_counter() - t_stage, resolved=n_true,
            refuted=n_refuted, unknowns=len(still),
        ))

    if (pending and batch_caps and dedup == "fused" and mesh is not None
            and mesh.size > 1):
        pending = _mesh_rescue(model, histories, packs, idxs, pending,
                               results, mesh, max(batch_caps + exact_caps),
                               confirm_refutations, confirm_max_configs,
                               stats, rounds)

    if pending:
        if exact_caps:
            note = (f"capacity ladder {tuple(batch_caps)} and exact "
                    f"escalation {tuple(exact_caps)} exhausted")
        else:
            note = (f"capacity ladder {tuple(batch_caps)} exhausted with no "
                    "exact-escalation stages")
        for k in pending:
            r = results[idxs[k]]
            if r is not None and r.get("valid?") == "unknown" and r.get("cause"):
                r["cause"] = f"{r['cause']}; {note}"

    if cpu_fallback:
        for i, r in enumerate(results):
            if (r is not None and r["valid?"] == "unknown"
                    and i not in confirm_futs):
                results[i] = wgl_cpu.sweep_analysis(model, histories[i])

    t_drain = time.perf_counter()
    for i, (fut, dev_res, op_pos) in confirm_futs.items():
        cpu_res = None
        for attempt in range(2):
            if fut is None:
                break
            try:
                cpu_res = fut.result()
                break
            except BrokenProcessPool:
                # the task died with its pool: one resubmit on a new pool
                _drop_confirm_pool()
                fut = (_submit_confirmation(
                    confirm_workers, model, list(histories[i]),
                    confirm_max_configs, op_pos) if attempt == 0 else None)
        if cpu_res is None:
            if cpu_fallback:
                cpu_res = wgl_cpu.sweep_analysis(
                    model, histories[i], max_configs=confirm_max_configs,
                    stop_at_index=op_pos)
            else:
                results[i] = {
                    "valid?": "unknown",
                    "cause": "device refutation; confirmation worker failed",
                    "kernel": dev_res.get("kernel"),
                }
                continue
        results[i] = _resolve_confirmation(dev_res, cpu_res)
    if stats is not None:
        stats["confirm_drain_s"] = time.perf_counter() - t_drain
    return [r if r is not None else {"valid?": "unknown"} for r in results]
