"""Batched linearizability checking: the capacity ladder.

The port of the JAX package's ``parallel.batch.batch_analysis``.  Every
history is packed to common (B, P, G) buckets and stacked, and one
batched engine launch checks a sub-batch of lanes:

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
     with the remaining rungs, or (``confirm_refutations="device"``) by
     one batched exact launch per capacity over the failure prefixes
     after the ladder drains;
  5. with a mesh of two or more shards and the fused backend, the lanes
     the last stage leaves undecided get one run of the mesh-spanning
     stage at shards × the top rung (the mesh rescue).

``True`` is sound from every rung (a surviving frontier is a witness);
``False`` is reported only once it is confirmed, or from an exact
stage.

The services, as in the JAX package: every launch runs under
``faults.call_with_retry`` (an out-of-memory first frees the card's
cached memory and retries, then halves the sub-batch, floor one lane; a
launch still failing degrades only its lanes); ``checkpoint_dir`` and
``resume`` (``store.checkpoint``); a ``deadline`` polled at stage
boundaries; rung admission (``admission``: continuous batching); and a
per-history decision path (``obs.provenance``) on every result.

Telemetry (``obs``), with the JAX package's names and keys: a
``ladder.launch`` span per launch (engine, capacity, lanes, the card's
index as ``devices``, and ``compiled``: the launch's (engine, padded
shape) bucket was new to the process), one ``ladder.stage`` span per
rung with its launch count, compile/execute split and device-memory
high-water mark, the ``ladder.unknowns_remaining`` gauge, and the
``confirm.*``, ``fault.*`` and ``dedup.*`` names.  There is no jit, so
``compile_s`` holds a bucket's first-touch costs: the allocator's
growth and, on the process's first launch, the kernels' build and load.
"""

from __future__ import annotations

import gc
import logging
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures.process import BrokenProcessPool
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from jepsen_tpu_torch import _confirm_worker, faults, obs
from jepsen_tpu_torch import models as m
from jepsen_tpu_torch._platform import resolve_device
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.convert import fok_bits
from jepsen_tpu_torch.obs import provenance as _prov
from jepsen_tpu_torch.ops import hashing, wgl
from jepsen_tpu_torch.parallel import sharded
from jepsen_tpu_torch.parallel.mesh import CROSS_CARD, Mesh
from jepsen_tpu_torch.store import checkpoint as _ckpt

logger = logging.getLogger(__name__)

#: (step, engine, shape...) buckets already launched in this process (the
#: JAX package's keys): a launch whose bucket is new lands in the stage
#: table's compile_s column, a warm one in execute_s.
_SEEN_SHAPES: set[tuple] = set()

#: dedup shapes already probed in this process (the dedup.round probe a
#: recorded run ends with): one probe per shape per process.
_PROBED_DEDUP_SHAPES: set[tuple] = set()

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

#: Continuous ladders: how long a pending member may sit skipped at its
#: rung before that rung preempts lowest-rung-first selection (the JAX
#: package's bound).
_STARVE_SECONDS = 5.0


def bucket_geometry(B: int, P: int, G: int) -> tuple[int, int, int]:
    """The padded (B, P, G) bucket a packed history launches at."""
    return (
        wgl.pad_B(B),
        wgl._bucket(P, list(P_BUCKETS)),
        wgl._bucket(G, list(G_BUCKETS)),
    )


def padded_batch(n: int, mesh: Mesh | None = None) -> int:
    """The padded lane count a launch of ``n`` lanes runs at: the next
    power of two, floor 8.  Padded lanes replicate the last lane.  With a
    ``mesh``, rounded up to a multiple of its shard count, as the JAX
    package rounds its lane-sharded launches (the check service reports
    occupancy and pins its ladders' ``pad_lanes`` from it)."""
    n_pad = 1 << max(3, (n - 1).bit_length())
    if mesh is not None:
        n_pad = -(-n_pad // mesh.size) * mesh.size
    return n_pad


def _halved_pad(n: int) -> int:
    """The padded lane count of an OOM-halved launch: the next power of
    two with no floor, so that a launch halved below 8 lanes really
    holds less.  (The JAX package floors every launch at 8 lanes for
    compile reuse; here a halved launch would otherwise run out of
    memory again at the same size.)"""
    return 1 << max(0, (n - 1).bit_length())


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
    (pool, future), the pool being the one the future came from, or
    (None, None) when no worker could take the job."""
    for _ in range(2):
        try:
            pool = confirm_pool(workers)
            return pool, pool.submit(_confirm_worker.confirm_refutation, *args)
        except BrokenProcessPool:
            _drop_confirm_pool()
    return None, None


def _drop_confirm_pool() -> None:
    """Forget a broken pool so the next submit spawns a new one."""
    global _CONFIRM_POOL
    if _CONFIRM_POOL is not None:
        _CONFIRM_POOL.shutdown(wait=False, cancel_futures=True)
        _CONFIRM_POOL = None


def _device_oom_spiller(ctx) -> bool:
    """The OOM spiller (``faults.register_oom_spiller``): collect the
    garbage that still holds a failed attempt's tensors and return the
    caching allocator's free blocks to the card.  True when the reserved
    memory shrank; always False without a card in use."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return False
    gc.collect()
    before = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() < before


faults.register_oom_spiller(_device_oom_spiller)


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
            sub_resumes, dedup: str, device, rounds: int,
            pad_to: int | None = None, halved: bool = False,
            acc: dict | None = None):
    """Stack ``sub`` to common bucket shapes and run one batched engine
    launch ("greedy", "async", "sync" or "exact"); returns (valid,
    failed_at, lossy, peak) as host arrays of len(sub), the padded lane
    count, and the async engine's resume snapshot as device tensors (or
    None).  The lane axis pads to ``padded_batch``, or up to ``pad_to``
    (continuous batching's fixed width), or for a ``halved`` launch to
    ``_halved_pad``.  ``acc``, when given, receives the launch's
    (engine, shape) bucket as ``"_key"`` (the JAX package's key)."""
    acc = {} if acc is None else acc
    B, P, G = bucket_geometry(
        max(p["B"] for p in sub), max(p["P"] for p in sub),
        max(p["G"] for p in sub),
    )
    W = (P + 31) // 32
    stacked = _stack(sub, B, P, G)
    n = len(sub)
    n_pad = _halved_pad(n) if halved else padded_batch(n)
    if pad_to is not None and pad_to > n_pad:
        n_pad = int(pad_to)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(_pad_lanes(a, n_pad))).to(device)

    tables = {k: dev(stacked[k]) for k in wgl.TABLE_ORDER}
    slot_lane, slot_onehot = wgl._slot_tables(P, W)
    slot_lane = torch.from_numpy(slot_lane).long().to(device)
    slot_onehot = torch.from_numpy(slot_onehot).to(device)
    n_active = dev(stacked["n_active"])
    step = sub[0]["step"]
    if st_engine == "greedy":
        acc["_key"] = (step, "greedy", B, P, G, W, n_pad)
        wgl.runner_cache_counter((step, B, P, G, W), "greedy")
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
        acc["_key"] = (step, st_engine, batch_cap, int(rounds), B, P, G, W,
                       n_pad, dedup)
        wgl.runner_cache_counter(
            (step, batch_cap, int(rounds), P, G, W, st_engine == "sync",
             dedup), st_engine)
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
    # Tick budget from the max remaining barriers: resumed lanes skip
    # their verified prefix.
    b_rem = int(max(1, (stacked["n_active"] - bptr0).max()))
    b_rem = 1 << max(5, (b_rem - 1).bit_length())
    T = wgl.async_ticks(min(b_rem, B), batch_cap)
    acc["_key"] = (step, "async", batch_cap, T, B, P, G, W, n_pad, dedup)
    wgl.runner_cache_counter((step, batch_cap, T, B, P, G, W, dedup), "async")
    out = wgl.run_async(
        step, F, T, dev(bptr0), dev(st0), dev(fo0), dev(fc0), dev(al0),
        n_active, tables, slot_lane, slot_onehot, dedup=dedup,
    )
    valid, failed_at, lossy, peak = (x.cpu().numpy()[:n] for x in out[:4])
    return (valid, failed_at, lossy, peak), n_pad, out[4:]


def _checkpoint_resume(resume: tuple) -> tuple:
    """A carried-frontier snapshot as the checkpoint holds it: host
    numpy with fok as the JAX package's uint32 bitsets."""
    bs, st, fo, fc, al = resume
    return int(bs), st, np.asarray(fo).view(np.uint32), fc, al


def batch_analysis(
    model: m.Model,
    histories: Sequence[Sequence[dict]],
    capacity: int | Sequence[int] = (64, 512, 4096),
    rounds: int = 8,
    carry_frontier: bool = True,
    greedy_first: bool = True,
    confirm_refutations: bool | str = True,
    cpu_fallback: bool = True,
    exact_escalation: Sequence[int] = (),
    dedup_backend: str | None = None,
    device=None,
    confirm_workers: int | None = None,
    confirm_max_configs: int = 2_000_000,
    engine: str = "async",
    mesh=None,
    checkpoint_dir=None,
    resume: bool = False,
    deadline=None,
    admission=None,
    frontier_budget_mb: float | None = None,
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
    snapshots.  ``dedup_backend``: "fused" (the default; the fused CUDA
    update on wide rungs), "bucket" or "sort".  ``device``: the card
    unless the caller asks for "cpu" (with a mesh and no device, the
    mesh's device).

    Confirmation: with ``confirm_refutations=True`` every fast-rung
    refutation is confirmed by the exact sweep in worker processes
    (a broken pool is rebuilt and the task resubmitted once);
    ``"device"`` confirms on the card instead: one batched exact launch
    per capacity over the failure prefixes after the ladder drains (a
    lossless exact death is final; a surviving or lossy lane takes the
    bounded sweep in process; a confirming launch that fails leaves its
    refutations unknown); False reports them unconfirmed.
    ``cpu_fallback`` decides the lanes the ladder leaves unknown with the
    exact sweep, in process (not the lanes of a failed launch).

    ``mesh``: a ``parallel.mesh.Mesh``; the ladder runs on ``device``
    (its lanes are not placed across shards, which would mean nothing on
    one card), and with two or more shards under "fused" the lanes the
    last stage leaves undecided get the mesh rescue before
    ``cpu_fallback``: ``mesh_kernel_analysis`` at shards × the top rung
    (``wgl.analysis`` where the mesh stage is infeasible); True lands,
    False is confirmed in process by the exact sweep (or stays
    provisional when ``confirm_refutations`` is False), unknown keeps its
    mesh-capacity cause.

    Fault tolerance (``faults``): every launch runs under the retry
    policy.  Transient errors retry with backoff; an out-of-memory first
    drops the failed attempt's tensors, returns the allocator's cached
    blocks to the card (``faults.try_oom_spill``) and retries the same
    launch once, then halves the sub-batch (and the stage's lane budget
    for the rest of the run), floor one lane; a launch still failing
    degrades only its lanes to ``"unknown"`` with a ``cause`` naming the
    error; neither ``cpu_fallback`` nor a sweep decides them in its
    place.  ``checkpoint_dir`` persists the ladder's state after every
    stage (``store.checkpoint``: verdicts so far, the pending set, the
    carried frontiers copied to the host, in-flight confirmations);
    ``resume=True`` reloads it and re-enters the ladder at the saved
    rung, so a kill mid-ladder and a resume give the verdicts of an
    uninterrupted run, on the card or the CPU whichever wrote it.  The
    saved config wins over the caller's arguments, a fingerprint that
    does not match the histories quarantines the stale pair and runs
    fresh, and a complete checkpoint returns its saved results.
    ``deadline`` (seconds or a ``faults.Deadline``) is polled at stage
    boundaries: on expiry the ladder checkpoints, marks the remaining
    histories ``unknown`` with cause ``deadline-exceeded`` and a pointer
    to the checkpoint, and still returns a complete list.
    ``frontier_budget_mb`` is recorded in the config and otherwise
    inert, with a warning: the chunked exact paths it caps are not on
    this ladder in the port, whose exact stages always take the batched
    runner (ROADMAP C4).

    Continuous batching (``admission``): an object whose ``poll(stage=,
    lanes=)`` is called at every rung boundary and may return new
    histories; they join the running ladder at rung 0 and run the rung
    sequence a one-shot call would, and their results are appended in
    admission order.  Optional hooks: ``on_result(i, result)`` the
    moment history ``i`` is decided, ``on_rung(stage=, engine=,
    capacity=, lanes=, padded=, seconds=)`` after each rung, and
    ``pad_lanes``, a fixed lane width every rung launch pads up to.

    ``stats``, when given, is filled with per-rung records (stage,
    engine, capacity, lanes, padded, seconds, resolved, refuted,
    unknowns, degraded, halvings), ``oom_spill_retries``,
    ``oom_halvings``, ``confirm_drain_s``, ``device_confirm`` (launches,
    refutations, seconds) when device confirmation ran, and, when the
    rescue ran, ``mesh_rescue`` (capacity, shards, lanes, resolved,
    seconds).

    Not in this port: a mesh across cards (``mesh`` must be the port's
    ``Mesh``).  Returns one result per history, in order.
    """
    if engine not in ("sync", "async"):
        raise ValueError(f"unknown engine {engine!r}; expected 'sync' or 'async'")
    if confirm_refutations not in (True, False, "device"):
        raise ValueError(
            f"unknown confirm_refutations {confirm_refutations!r}; "
            "expected True (worker sweeps), False, or 'device'")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise NotImplementedError(
            "mesh must be a parallel.mesh.Mesh of logical shards on one "
            f"device; other meshes are not ported ({CROSS_CARD})")
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
    obs.span_event("ladder.pack", time.perf_counter() - t_pack,
                   histories=len(histories), tensorizable=len(packs))
    rung_stats: list[dict] = []
    if stats is None:
        stats = {}
    stats["pack_s"] = time.perf_counter() - t_pack
    stats["rungs"] = rung_stats
    stats["oom_spill_retries"] = 0
    stats["oom_halvings"] = 0

    batch_caps = [capacity] if isinstance(capacity, int) else list(capacity)
    batch_caps = [int(c) for c in batch_caps]
    exact_caps = [int(c) for c in (exact_escalation or ())]

    # ------------------------------------------------------------------
    # Checkpoint and resume (store.checkpoint).
    # ------------------------------------------------------------------
    checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir is not None else None
    deadline = faults.Deadline.coerce(deadline)
    deadline_tripped = False
    trip_checkpointed = False  # a resumable trip checkpoint is on disk
    fp_dirty = False  # rung admission grew `histories` since fp was taken
    no_fallback: set[int] = set()  # history idxs the CPU fallback skips
    start_stage = 0
    restored = None
    fp = None
    if checkpoint_dir is not None or resume:
        fp = _ckpt.fingerprint(histories)
    if resume and checkpoint_dir is not None and _ckpt.exists(checkpoint_dir):
        t_load = time.perf_counter()
        try:
            restored = _ckpt.load(checkpoint_dir)
        except _ckpt.CheckpointError as e:
            # a corrupt pair is quarantined already; running fresh gives
            # the uninterrupted verdicts
            logger.warning("unreadable checkpoint in %s (%s); running fresh",
                           checkpoint_dir, e)
            obs.counter("fault.checkpoint.mismatch",
                        reason=getattr(e, "report", None) and
                        e.report.get("reason") or "unreadable",
                        report=getattr(e, "report", None))
        if restored is not None and restored["config"].get("fingerprint") != fp:
            quarantined = _ckpt.quarantine(checkpoint_dir,
                                           reason="stale-fingerprint")
            logger.warning(
                "checkpoint in %s was written for different histories; "
                "running fresh; stale files quarantined: %s",
                checkpoint_dir, quarantined)
            obs.counter("fault.checkpoint.quarantined",
                        reason="fingerprint", files=quarantined)
            obs.counter("fault.checkpoint.mismatch", reason="fingerprint")
            restored = None
        if restored is not None:
            # the saved config wins: verdict identity needs the original
            # ladder
            cfg = restored["config"]
            engine = cfg.get("engine", engine)
            batch_caps = [int(c) for c in cfg.get("capacity", batch_caps)]
            exact_caps = [int(c) for c in cfg.get("exact_escalation", exact_caps)]
            rounds = int(cfg.get("rounds", rounds))
            greedy_first = bool(cfg.get("greedy_first", greedy_first))
            carry_frontier = bool(cfg.get("carry_frontier", carry_frontier))
            dedup = cfg.get("dedup", dedup)
            confirm_refutations = cfg.get(
                "confirm_refutations", confirm_refutations)
            frontier_budget_mb = cfg.get(
                "frontier_budget_mb", frontier_budget_mb)
            start_stage = int(restored["stage"])
            obs.span_event(
                "fault.checkpoint.load", time.perf_counter() - t_load,
                stage=start_stage, pending=len(restored["pending"]),
                complete=restored["complete"],
            )
            if restored["complete"]:
                # a finished run: its verdicts, no device work; each
                # records the restore in its provenance
                for i, r in restored["results"].items():
                    if 0 <= i < len(results):
                        if isinstance(r, dict):
                            _prov.attach(
                                r,
                                [{"event": "checkpoint.restored",
                                  "complete": True, "stage": start_stage}],
                                engine={"engine": engine,
                                        "dedup_backend": dedup},
                            )
                        results[i] = r
                return [r if r is not None else {"valid?": "unknown"}
                        for r in results]
    config = {
        "engine": engine, "capacity": list(batch_caps),
        "exact_escalation": list(exact_caps), "rounds": int(rounds),
        "greedy_first": bool(greedy_first),
        "carry_frontier": bool(carry_frontier), "dedup": dedup,
        "confirm_refutations": confirm_refutations, "fingerprint": fp,
        "frontier_budget_mb": frontier_budget_mb,
    }
    if frontier_budget_mb is not None:
        logger.warning(
            "frontier_budget_mb=%s is recorded but not honoured: the port's "
            "exact stages always take the batched runner (ROADMAP C4)",
            frontier_budget_mb)

    # ------------------------------------------------------------------
    # Provenance: a bounded decision path per history, attached to every
    # result before it leaves the ladder.
    # ------------------------------------------------------------------
    prov_cfg = {k: v for k, v in config.items() if k != "fingerprint"}
    prov_engine: dict = {"engine": engine, "dedup_backend": dedup,
                         "greedy_first": bool(greedy_first)}
    prov_paths: dict[int, list] = {}

    def _pv(i: int, event: str, **attrs) -> None:
        lst = prov_paths.setdefault(i, [])
        if len(lst) < _prov.MAX_PATH:
            lst.append({"event": event, **attrs})

    def _attach_prov(i: int) -> None:
        r = results[i]
        if isinstance(r, dict):
            _prov.attach(r, prov_paths.get(i, []), engine=prov_engine,
                         config=prov_cfg)

    def _notify(i: int) -> None:
        """Hand a decided verdict (True, or a final False) to the
        admission hook the moment it is final."""
        if admission is None:
            return
        r = results[i]
        if r is None or r.get("valid?") == "unknown":
            return
        _attach_prov(i)
        try:
            admission.on_result(i, r)
        except Exception:  # noqa: BLE001 — a broken feeder must not lose
            # the ladder; the verdict still lands in the returned list
            logger.exception("rung-admission on_result failed (history %d)", i)

    if restored is not None:
        for _pi in range(len(histories)):
            _pv(_pi, "checkpoint.restored", stage=start_stage)

    #: the card every launch of this ladder runs on: its index, stamped
    #: once on launch and stage spans (logical mesh shards share it)
    _dev_ids = [device.index or 0]

    #: per-stage launch accounting for the telemetry stage table
    launch_acc: dict = {}

    def _reset_launch_acc() -> None:
        launch_acc.update(
            launches=0, compile_launches=0, compile_s=0.0, execute_s=0.0,
            device_bytes_peak=0,
        )

    _reset_launch_acc()

    def _launch_obs(st_engine: str, batch_cap: int, sub: list[dict],
                    sub_resumes=None, pad_to: int | None = None,
                    halved: bool = False):
        """``_launch`` under a ``ladder.launch`` span, which closes once
        the launch's results are on the host: counts the launch as
        compile (a bucket new to the process) or execute, and, when
        observing, samples the card's allocated bytes after it (the
        stage's memory high-water mark)."""
        with obs.span("ladder.launch", engine=st_engine, capacity=batch_cap,
                      lanes=len(sub), devices=_dev_ids) as sp:
            t0 = time.perf_counter()
            out = _launch(st_engine, batch_cap, sub, sub_resumes, dedup,
                          device, rounds, pad_to, halved, acc=launch_acc)
            dt = time.perf_counter() - t0
            key = launch_acc.pop("_key", None)
            compiled = key is not None and key not in _SEEN_SHAPES
            if key is not None:
                _SEEN_SHAPES.add(key)
            launch_acc["launches"] += 1
            if compiled:
                launch_acc["compile_launches"] += 1
                launch_acc["compile_s"] += dt
            else:
                launch_acc["execute_s"] += dt
            obs.counter(
                "ladder.compile_cache.miss" if compiled
                else "ladder.compile_cache.hit",
                engine=st_engine,
            )
            sp.set(compiled=compiled)
            if obs.observing():
                db = wgl.device_buffer_bytes(device)
                if db is not None and db > launch_acc["device_bytes_peak"]:
                    launch_acc["device_bytes_peak"] = db
        return out

    def _emit_stage(t_stage: float, stage_attrs: dict, **extra) -> None:
        """One ladder.stage span per rung: wall time, lanes in, verdict
        counts, the stage's compile/execute launch split and its
        device-memory high-water mark."""
        mem = {}
        if launch_acc.get("device_bytes_peak"):
            mem["device_bytes_peak"] = launch_acc["device_bytes_peak"]
            obs.gauge("device.buffer_bytes", launch_acc["device_bytes_peak"],
                      at="ladder-stage", stage=stage_attrs.get("stage"))
        obs.span_event(
            "ladder.stage", time.perf_counter() - t_stage,
            devices=_dev_ids,
            launches=launch_acc["launches"],
            compile_launches=launch_acc["compile_launches"],
            compile_s=round(launch_acc["compile_s"], 6),
            execute_s=round(launch_acc["execute_s"], 6),
            **mem, **stage_attrs, **extra,
        )

    stages = ([(engine, c) for c in batch_caps]
              + [("exact", c) for c in exact_caps])
    if greedy_first and stages:
        stages = [("greedy", 1)] + stages
    pending = list(range(len(packs)))
    resumes: dict[int, tuple] = {}  # pack idx -> carried frontier (host)
    #: hist idx -> (pool, future, device result, t_submit, op_pos)
    confirm_futs: dict = {}
    device_confirms: list[tuple] = []  # (pack idx, failed_at, cap, result)
    confirm_degraded: set[int] = set()  # confirmations the deadline cut
    if restored is not None:
        # Re-enter where the checkpoint left off: verdicts so far, the
        # pending set, each pending lane's carried frontier; in-flight
        # worker confirmations are resubmitted, queued device
        # confirmations re-queue.
        pack_of = {i: k for k, i in enumerate(idxs)}
        for i, r in restored["results"].items():
            if 0 <= i < len(results):
                results[i] = r
        pending = [pack_of[i] for i in restored["pending"] if i in pack_of]
        for i, (bs, st, fo, fc, al) in restored["resumes"].items():
            if i in pack_of:
                resumes[pack_of[i]] = (bs, np.asarray(st, np.int32),
                                       fok_bits(fo), np.asarray(fc, np.int16),
                                       np.asarray(al, bool))
        for i, info in restored["confirms"].items():
            pool, fut = _submit_confirmation(
                confirm_workers, model, list(histories[i]),
                confirm_max_configs, int(info["op_pos"]))
            obs.counter("confirm.submitted")
            confirm_futs[i] = (pool, fut, info["res"], time.perf_counter(),
                               int(info["op_pos"]), obs.capture())
            results[i] = info["res"]
        for e in restored["device_confirms"]:
            if e["i"] in pack_of:
                device_confirms.append(
                    (pack_of[e["i"]], int(e["failed_at"]), int(e["cap"]),
                     e["res"]))
                results[e["i"]] = e["res"]

    #: per-pack rung cursor: stages[rungs[k]] is pack k's next rung.
    #: Without admission every pack walks the ladder together; a pack
    #: admitted mid-ladder enters at rung 0 and runs the same sequence.
    rungs: dict[int, int] = {k: start_stage for k in pending}
    if restored is not None and restored.get("rungs"):
        pack_of = {i: k for k, i in enumerate(idxs)}
        for i, r in restored["rungs"].items():
            if i in pack_of:
                rungs[pack_of[i]] = int(r)

    def _save_checkpoint(next_stage: int, complete: bool = False):
        """Persist the ladder's state at a stage boundary; a failed save
        is logged and never fails the analysis."""
        if checkpoint_dir is None:
            return None
        nonlocal fp_dirty
        if fp_dirty:
            # admission grew the membership: fingerprint the histories as
            # they are now, so a resume over the grown list matches
            config["fingerprint"] = _ckpt.fingerprint(histories)
            fp_dirty = False
        t0 = time.perf_counter()
        try:
            path = _ckpt.save(
                checkpoint_dir,
                config=config,
                stage=next_stage,
                results={i: r for i, r in enumerate(results) if r is not None},
                pending=[idxs[k] for k in pending],
                confirms={
                    i: {"res": res, "op_pos": op_pos}
                    for i, (_p, _f, res, _t, op_pos, _c)
                    in confirm_futs.items()
                },
                device_confirms=[
                    {"i": idxs[k], "failed_at": fat, "cap": cap, "res": res}
                    for k, fat, cap, res in device_confirms
                ],
                resumes={idxs[k]: _checkpoint_resume(resumes[k])
                         for k in pending if k in resumes},
                rungs={idxs[k]: rungs.get(k, next_stage) for k in pending},
                complete=complete,
            )
        except Exception:  # noqa: BLE001 — see docstring
            logger.warning("couldn't write checker checkpoint to %s",
                           checkpoint_dir, exc_info=True)
            obs.counter("fault.checkpoint.error")
            return None
        obs.span_event(
            "fault.checkpoint.save", time.perf_counter() - t0,
            stage=next_stage, pending=len(pending), complete=complete,
        )
        return path

    early_confirmed: set[int] = set()  # resolved at a rung boundary

    def _poll_confirmations() -> None:
        """Resolve the worker confirmations that already finished cleanly
        (continuous batching); failures wait for the final drain."""
        done = [
            i for i, e in confirm_futs.items()
            if e[1] is not None and e[1].done()
            and not e[1].cancelled() and e[1].exception() is None
        ]
        for i in done:
            _pool, fut, dev_res, t_submit, _op_pos, ctx = confirm_futs.pop(i)
            early_confirmed.add(i)
            with obs.attach(ctx):
                obs.gauge(
                    "confirm.queue_latency_s",
                    round(time.perf_counter() - t_submit, 6), history=i,
                )
                results[i] = _resolve_confirmation(dev_res, fut.result())
            _pv(i, "confirm.resolved", mode="worker",
                outcome=_prov.verdict_str(results[i].get("valid?")))
            _notify(i)

    def _poll_admission() -> None:
        """Ask the admission hook for histories to join at rung 0; each
        gets result index len(histories).  A broken hook means no
        joiners, never a lost ladder."""
        nonlocal fp_dirty
        if admission is None:
            return
        min_rung = min((rungs[k] for k in pending), default=0)
        try:
            new_hists = admission.poll(stage=min_rung, lanes=len(pending))
        except Exception:  # noqa: BLE001 — see docstring
            logger.exception(
                "rung-admission poll failed; continuing without joiners")
            new_hists = None
        for hist in new_hists or ():
            i = len(histories)
            histories.append(list(hist))
            results.append(None)
            fp_dirty = True
            try:
                p = wgl.pack(model, histories[i])
            except wgl.NotTensorizable as e:
                results[i] = {
                    "valid?": "unknown", "cause": f"not tensorizable: {e}"}
                continue
            if p["B"] == 0:
                results[i] = {"valid?": True}
                _notify(i)
                continue
            k = len(packs)
            packs.append(p)
            idxs.append(i)
            pending.append(k)
            rungs[k] = 0
            _pv(i, "admission.joined", at_stage=min_rung)
            obs.counter("ladder.rung_admission", stage=min_rung)

    pad_lanes = getattr(admission, "pad_lanes", None)
    pad_lanes = int(pad_lanes) if pad_lanes else None

    #: OOM halvings shrink the stage lane budget for the rest of the run.
    budget_scale = 1.0
    exhausted: list[int] = []  # packs that ran out of rungs unresolved
    starve: dict[int, float] = {}  # pack idx -> first skipped launch
    while pending or admission is not None:
        _poll_admission()
        if admission is not None:
            _poll_confirmations()
        past = [k for k in pending if rungs[k] >= len(stages)]
        if past:
            exhausted.extend(past)
            pending = [k for k in pending if rungs[k] < len(stages)]
        if not pending:
            if admission is not None and confirm_futs:
                # linger while live worker confirmations run: keep
                # demuxing them and admitting joiners
                live = any(
                    e[1] is not None and not e[1].done()
                    for e in confirm_futs.values()
                )
                if live and (deadline is None or not deadline.expired()):
                    time.sleep(0.001)
                    continue
            break  # drained, and the hook (if any) had nothing
        si = min(rungs[k] for k in pending)
        if admission is not None and starve:
            waiting = [k for k in pending if k in starve]
            if waiting:
                k_worst = min(waiting, key=lambda k: starve[k])
                if time.perf_counter() - starve[k_worst] > _STARVE_SECONDS:
                    si = rungs[k_worst]
        group = [k for k in pending if rungs[k] == si]
        rest = [k for k in pending if rungs[k] != si]
        if admission is not None:
            for k in group:
                starve.pop(k, None)
            t_skip = time.perf_counter()
            for k in rest:
                starve.setdefault(k, t_skip)
        st_engine, batch_cap = stages[si]
        if deadline is not None and deadline.expired():
            # checkpoint first (the placeholders keep their resumable
            # causes), then mark every remaining history unknown; the
            # CPU fallback skips them
            deadline_tripped = True
            ck = _save_checkpoint(si)
            trip_checkpointed = ck is not None
            obs.event("fault.deadline", at="ladder-stage", stage=si,
                      unresolved=len(pending))
            obs.counter("fault.deadline.trip")
            note = f"; resumable checkpoint: {ck}" if ck else ""
            for k in pending:
                i = idxs[k]
                prev = results[i]
                _pv(i, "fault.deadline", at="ladder-stage", stage=si)
                results[i] = {
                    "valid?": "unknown",
                    "cause": (
                        "deadline-exceeded: check budget exhausted before "
                        f"ladder stage {si}{note}"
                    ),
                }
                if isinstance(prev, dict) and prev.get("kernel"):
                    results[i]["kernel"] = prev["kernel"]
                no_fallback.add(i)
            obs.gauge("ladder.unknowns_remaining", len(pending), final=True)
            pending = []
            break
        _reset_launch_acc()
        t_stage = time.perf_counter()
        stage_attrs = dict(stage=si, engine=st_engine, capacity=batch_cap,
                           lanes=len(group), dedup=dedup)
        if dedup == "fused" and st_engine in ("async", "sync") and group:
            # the fused update's routing gate at the rung's widest pack
            # (the JAX package's "pallas_routed"); a rung it routes away
            # from the kernel is counted, so the stage rows never read
            # as kernel rungs when they were not
            from jepsen_tpu_torch.ops import wide_kernel as _wk

            _pP = max(packs[k]["P"] for k in group)
            _pG = max(packs[k]["G"] for k in group)
            _routed = _wk.fused_feasible(batch_cap * (1 + _pP + _pG),
                                         batch_cap, _pP + 1)
            stage_attrs.update(
                pallas_routed=_routed,
                mesh_devices=mesh.size if mesh is not None else 1)
            if not _routed:
                obs.counter("dedup.pallas_fallback",
                            stage=si, capacity=batch_cap)
        if st_engine == "exact":
            budget = _EXACT_LANE_BUDGET
        elif st_engine == "async" and carry_frontier:
            budget = _CARRY_LANE_BUDGET
        else:
            budget = _FAST_LANE_BUDGET
        fetch_snaps = (st_engine == "async" and carry_frontier
                       and any(e == "async" for e, _ in stages[si + 1:]))
        lane_out: dict[int, tuple] = {}
        degraded: list[tuple[int, str]] = []  # (pack idx, cause)
        counts = {"launch_s": 0.0, "halvings": 0}

        def _launch_ft(part: list[int], pad_to: int | None = None,
                       halved: bool = False, spilled: bool = False) -> None:
            """Launch one sub-batch under the fault policy (see the
            docstring of batch_analysis): transient errors retry inside
            ``faults.call_with_retry``; an OOM drops the failed attempt's
            tensors, asks the spillers to free device memory and retries
            the same launch once, then halves the part recursively (and
            the stage's lane budget with it); a part that still fails
            degrades only its lanes.  A successful part lands its
            verdicts in ``lane_out`` and copies its pending lanes'
            snapshots to the host at once (one part's snapshot is on the
            card at a time)."""
            nonlocal budget_scale
            sub_res = ([resumes.get(k) for k in part]
                       if st_engine == "async" and carry_frontier else None)
            ctx = dict(what=f"ladder.{st_engine}", stage=si,
                       engine=st_engine, capacity=batch_cap, lanes=len(part))
            t0 = time.perf_counter()
            try:
                out = faults.call_with_retry(
                    lambda: _launch_obs(st_engine, batch_cap,
                                        [packs[k] for k in part], sub_res,
                                        pad_to, halved),
                    ctx)
                failure = None
            except faults.LaunchFailure as lf:
                failure = (lf.kind, faults.describe(lf.cause))
                faults.release(lf)
            dt = time.perf_counter() - t0
            counts["launch_s"] += dt
            if failure is None:
                faults.record_launch_seconds(dt, retry=halved or spilled)
            else:
                kind, cause = failure
                if kind == "oom" and not spilled and faults.try_oom_spill(ctx):
                    # freed device memory: the same shape once more at
                    # full size before shrinking any work
                    obs.counter(
                        "fault.launch.oom_spill_retry", stage=si,
                        engine=st_engine, capacity=batch_cap,
                        lanes=len(part),
                    )
                    stats["oom_spill_retries"] += 1
                    for k in part:
                        _pv(idxs[k], "fault.oom-spill-retry", stage=si,
                            engine=st_engine, capacity=batch_cap)
                    _launch_ft(part, pad_to, halved, spilled=True)
                    return
                if kind == "oom" and len(part) > 1:
                    mid = (len(part) + 1) // 2
                    budget_scale = max(budget_scale / 2, 1.0 / max(1, budget))
                    obs.counter(
                        "fault.launch.oom_halving", stage=si,
                        engine=st_engine, capacity=batch_cap,
                        lanes_from=len(part), lanes_to=mid,
                    )
                    stats["oom_halvings"] += 1
                    counts["halvings"] += 1
                    for k in part:
                        _pv(idxs[k], "fault.oom-halving", stage=si,
                            engine=st_engine, capacity=batch_cap)
                    # the fixed continuous pad is dropped: replaying the
                    # halves at the width that just failed would fail; the
                    # failed attempt's memory goes back to the card first
                    # (not a recovery, so not a fault.oom.spill)
                    _device_oom_spiller(ctx)
                    _launch_ft(part[:mid], halved=True, spilled=spilled)
                    _launch_ft(part[mid:], halved=True, spilled=spilled)
                    return
                obs.counter(
                    "fault.launch.degraded", stage=si, engine=st_engine,
                    capacity=batch_cap, lanes=len(part), error=cause,
                )
                for k in part:
                    _pv(idxs[k], "fault.launch-degraded", stage=si,
                        engine=st_engine, capacity=batch_cap, error=cause)
                degraded.extend((k, cause) for k in part)
                return
            (v, fat, lz, pk), n_pad, snap = out
            del out
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
            del snap  # free the device snapshot before the next launch
            launched_pad[0] += n_pad

        s0 = 0
        launched_pad = [0]
        while s0 < len(group):
            lanes_cap = max(1, int(budget * budget_scale) // batch_cap)
            part = group[s0: s0 + lanes_cap]
            pad_to = (min(pad_lanes, padded_batch(lanes_cap))
                      if pad_lanes is not None else None)
            _launch_ft(part, pad_to)
            s0 += lanes_cap
        if admission is not None and hasattr(admission, "on_rung"):
            try:
                admission.on_rung(
                    stage=si, engine=st_engine, capacity=batch_cap,
                    lanes=len(group), padded=launched_pad[0],
                    seconds=counts["launch_s"],
                )
            except Exception:  # noqa: BLE001 — a reporting hook only
                logger.exception("rung-admission on_rung failed")
        for k, cause in degraded:
            # a failed launch costs exactly its own lanes, which stay
            # unknown: nothing runs on the CPU in the launch's place
            results[idxs[k]] = {
                "valid?": "unknown",
                "cause": f"device launch failed: {cause}",
            }
            no_fallback.add(idxs[k])
        still = []
        n_true = n_refuted = 0
        peak_max = n_lossy = 0
        for k in group:
            if k not in lane_out:
                continue  # degraded this stage
            valid_k, fat_k, lossy_k, peak_k = lane_out[k]
            i = idxs[k]
            kstats = {"frontier-peak": int(peak_k), "capacity": batch_cap,
                      "lossy?": bool(lossy_k)}
            peak_max = max(peak_max, int(peak_k))
            n_lossy += bool(lossy_k)
            pending_lane = _stays_pending(valid_k, fat_k, lossy_k)
            if not pending_lane and fat_k < 0:
                n_true += 1
                _pv(i, "ladder.stage", stage=si, engine=st_engine,
                    capacity=batch_cap, outcome="valid")
                results[i] = {"valid?": True, "kernel": kstats}
                _notify(i)
            elif not pending_lane:
                n_refuted += 1
                op_pos = int(packs[k]["bar_opid"][int(fat_k)])
                res = {"valid?": False, "op": histories[i][op_pos],
                       "kernel": kstats}
                _pv(i, "ladder.stage", stage=si, engine=st_engine,
                    capacity=batch_cap, outcome="refuted",
                    confirm=("none" if st_engine == "exact"
                             or not confirm_refutations
                             else str(confirm_refutations)))
                if st_engine == "exact" or not confirm_refutations:
                    results[i] = res  # content-decided, or opted out: final
                    _notify(i)
                elif confirm_refutations == "device":
                    device_confirms.append((k, int(fat_k), batch_cap, res))
                    results[i] = res  # placeholder; resolved below
                else:
                    pool, fut = _submit_confirmation(
                        confirm_workers, model, list(histories[i]),
                        confirm_max_configs, op_pos)
                    obs.counter("confirm.submitted")
                    confirm_futs[i] = (pool, fut, res, time.perf_counter(),
                                       op_pos, obs.capture())
                    results[i] = res  # placeholder; resolved below
            else:
                still.append(k)
                _pv(i, "ladder.stage", stage=si, engine=st_engine,
                    capacity=batch_cap, outcome="pending",
                    lossy=bool(lossy_k))
                results[i] = {
                    "valid?": "unknown",
                    "cause": "frontier capacity or closure rounds exhausted",
                    "kernel": kstats,
                }
        for k in still:
            rungs[k] = si + 1
        pending = sorted(rest + still)
        _emit_stage(
            t_stage, stage_attrs, resolved=n_true, refuted=n_refuted,
            unknowns_remaining=len(still), peak_frontier=peak_max,
            lossy=n_lossy, degraded=len(degraded),
        )
        obs.gauge("ladder.unknowns_remaining", len(still), stage=si,
                  capacity=batch_cap)
        rung_stats.append(dict(
            stage=si, engine=st_engine, capacity=batch_cap,
            lanes=len(group), padded=launched_pad[0],
            seconds=time.perf_counter() - t_stage, resolved=n_true,
            refuted=n_refuted, unknowns=len(still), degraded=len(degraded),
            halvings=counts["halvings"],
        ))
        _save_checkpoint(min(rungs[k] for k in pending) if pending else si + 1)

    if (exhausted and batch_caps and dedup == "fused" and mesh is not None
            and mesh.size > 1):
        # The mesh rescue: one run of the mesh-spanning stage at shards ×
        # the top rung for each lane the ladder left undecided.
        D = mesh.size
        rescue_cap = max(batch_caps + exact_caps) * D
        t_rescue = time.perf_counter()
        still_exhausted = []
        for k in exhausted:
            i = idxs[k]
            if deadline is not None and deadline.expired():
                still_exhausted.append(k)
                continue
            _pv(i, "route.mesh-kernel", capacity=rescue_cap, mesh_devices=D)
            r = sharded.mesh_kernel_analysis(model, histories[i], mesh,
                                             capacity=(rescue_cap,),
                                             rounds=int(rounds))
            if r["valid?"] is True:
                results[i] = r
                no_fallback.add(i)
                _pv(i, "mesh-kernel.resolved", outcome="valid")
                _notify(i)
                continue
            if r["valid?"] is False:
                if not confirm_refutations:
                    results[i] = r  # unconfirmed: carries provisional?
                    no_fallback.add(i)
                    _pv(i, "mesh-kernel.resolved",
                        outcome="refuted-provisional")
                    _notify(i)
                    continue
                # the chunked fallback's refutations carry no failed-at:
                # then the sweep runs the whole history
                fat = int(r.get("kernel", {}).get("failed-at", -1))
                op_pos = int(packs[k]["bar_opid"][fat]) if fat >= 0 else None
                cpu_res = wgl_cpu.sweep_analysis(
                    model, histories[i], max_configs=confirm_max_configs,
                    stop_at_index=op_pos)
                results[i] = _resolve_confirmation(r, cpu_res)
                decided = results[i].get("valid?") != "unknown"
                _pv(i, "mesh-kernel.resolved" if decided
                    else "mesh-kernel.unconfirmed",
                    outcome=_prov.verdict_str(results[i].get("valid?")))
                if decided:
                    no_fallback.add(i)
                    _notify(i)
                    continue
                still_exhausted.append(k)
                continue
            # unknown at mesh capacity: the mesh-capacity report becomes
            # the attributable cause
            if r.get("cause"):
                results[i] = r
            _pv(i, "mesh-kernel.exhausted")
            still_exhausted.append(k)
        stats["mesh_rescue"] = dict(
            capacity=rescue_cap, shards=D, lanes=len(exhausted),
            resolved=len(exhausted) - len(still_exhausted),
            seconds=time.perf_counter() - t_rescue,
        )
        obs.span_event(
            "ladder.mesh_rescue", stats["mesh_rescue"]["seconds"],
            capacity=rescue_cap, mesh_devices=D, lanes=len(exhausted),
            resolved=stats["mesh_rescue"]["resolved"],
        )
        exhausted = still_exhausted

    if exhausted:
        # the lanes the whole ladder left undecided: a final gauge, and a
        # cause in each unknown result
        obs.gauge("ladder.unknowns_remaining", len(exhausted), final=True)
        if exact_caps:
            note = (f"capacity ladder {tuple(batch_caps)} and exact "
                    f"escalation {tuple(exact_caps)} exhausted")
        else:
            note = (f"capacity ladder {tuple(batch_caps)} exhausted with no "
                    "exact-escalation stages")
        for k in exhausted:
            i = idxs[k]
            _pv(i, "ladder.exhausted")
            r = results[i]
            if r is not None and r.get("valid?") == "unknown" and r.get("cause"):
                r["cause"] = f"{r['cause']}; {note}"

    device_resolved: set[int] = set()

    def _finish_confirmation(k: int, fat: int, res: dict,
                             exact_died: bool) -> None:
        """Resolve one device confirmation: a lossless exact death makes
        the refutation final; otherwise the bounded sweep decides, unless
        the deadline has expired."""
        nonlocal deadline_tripped
        i = idxs[k]
        device_resolved.add(i)
        if exact_died:
            res["confirmed?"] = True
            _pv(i, "confirm.device", outcome="refuted-final")
            results[i] = res
            _notify(i)
            return
        if deadline is not None and deadline.expired():
            deadline_tripped = True
            _pv(i, "fault.deadline", at="device-confirm")
            results[i] = {
                "valid?": "unknown",
                "cause": ("device refutation; deadline-exceeded before "
                          "exact confirmation"),
                "kernel": res.get("kernel"),
            }
            return
        op_pos = int(packs[k]["bar_opid"][fat])
        cpu_res = wgl_cpu.sweep_analysis(
            model, histories[i], max_configs=confirm_max_configs,
            stop_at_index=op_pos)
        results[i] = _resolve_confirmation(res, cpu_res)
        _pv(i, "confirm.resolved", mode="device-sweep",
            outcome=_prov.verdict_str(results[i].get("valid?")))
        _notify(i)

    if device_confirms and deadline is not None and deadline.expired():
        # the budget died before the exact confirmations ran: each
        # refutation degrades to unknown, its descriptor in the
        # checkpoint for a resume (a stage trip's checkpoint has it
        # already and must not be overwritten)
        deadline_tripped = True
        if not trip_checkpointed:
            ck = _save_checkpoint(len(stages))
            trip_checkpointed = ck is not None
        else:
            ck = _ckpt.json_path(checkpoint_dir) if checkpoint_dir else None
        obs.event("fault.deadline", at="device-confirm",
                  unresolved=len(device_confirms))
        obs.counter("fault.deadline.trip")
        note = f"; resumable checkpoint: {ck}" if ck else ""
        for k, _fat, _cap, res in device_confirms:
            _pv(idxs[k], "fault.deadline", at="device-confirm")
            results[idxs[k]] = {
                "valid?": "unknown",
                "cause": ("device refutation; deadline-exceeded before exact "
                          f"confirmation{note}"),
                "kernel": res.get("kernel"),
            }
            no_fallback.add(idxs[k])
        device_confirms = []
    if device_confirms:
        # One batched exact launch per capacity over the failure
        # prefixes: content-decided kills make a lossless exact death a
        # final refutation; a surviving or lossy lane (the rare
        # hash-collision case) takes the bounded sweep.
        _reset_launch_acc()
        t_conf = time.perf_counter()
        n_conf_launches = 0
        by_cap: dict[int, list[tuple]] = {}
        for k, fat, cap, res in device_confirms:
            by_cap.setdefault(cap, []).append((k, fat, res))
        for cap, cgroup in sorted(by_cap.items()):
            masked = []
            for k, fat, res in cgroup:
                p = dict(packs[k])
                act = p["bar_active"].copy()
                act[fat + 1:] = False  # refutation needs only the prefix
                p["bar_active"] = act
                masked.append(p)
            lanes_cap = max(1, _EXACT_LANE_BUDGET // cap)
            for s0 in range(0, len(cgroup), lanes_cap):
                sub = masked[s0: s0 + lanes_cap]
                ctx = dict(what="ladder.confirm", engine="exact",
                           capacity=cap, lanes=len(sub))
                try:
                    (gvalid, gfailed, glossy, _pk), _n, _s = (
                        faults.call_with_retry(
                            lambda: _launch_obs("exact", cap, sub), ctx))
                    n_conf_launches += 1
                except faults.LaunchFailure as lf:
                    # no halving and no sweep in the launch's place: each
                    # refutation it carried is unknown with the failure
                    cause = faults.describe(lf.cause)
                    faults.release(lf)
                    obs.counter("fault.launch.degraded", what="ladder.confirm",
                                capacity=cap, lanes=len(sub), error=cause)
                    for (k, _fat, res) in cgroup[s0: s0 + lanes_cap]:
                        i = idxs[k]
                        _pv(i, "fault.launch-degraded", at="device-confirm",
                            capacity=cap, error=cause)
                        results[i] = {
                            "valid?": "unknown",
                            "cause": ("device refutation; exact confirmation "
                                      f"launch failed: {cause}"),
                            "kernel": res.get("kernel"),
                        }
                        device_resolved.add(i)
                        no_fallback.add(i)
                    continue
                for (k, fat, res), _v, f2, lz in zip(
                        cgroup[s0: s0 + lanes_cap], gvalid, gfailed, glossy):
                    _finish_confirmation(k, fat, res, f2 >= 0 and not lz)
        stats["device_confirm"] = dict(
            refutations=len(device_confirms), launches=n_conf_launches,
            seconds=time.perf_counter() - t_conf)
        obs.span_event(
            "ladder.confirm.device", stats["device_confirm"]["seconds"],
            refutations=len(device_confirms), launches=launch_acc["launches"],
        )
        device_confirms = []  # resolved; keep them out of later checkpoints

    if cpu_fallback:
        t_fb = time.perf_counter()
        n_fb = 0
        for i, r in enumerate(results):
            if deadline is not None and deadline.expired():
                # the budget is spent: the remaining unknowns keep their
                # causes
                if not deadline_tripped:
                    deadline_tripped = True
                    obs.counter("fault.deadline.trip")
                    obs.event("fault.deadline", at="cpu-fallback")
                break
            if (r is not None and r["valid?"] == "unknown"
                    and i not in confirm_futs and i not in device_resolved
                    and i not in early_confirmed and i not in no_fallback):
                n_fb += 1
                results[i] = wgl_cpu.sweep_analysis(model, histories[i])
                _pv(i, "cpu-fallback", engine="sweep",
                    outcome=_prov.verdict_str(results[i].get("valid?")))
                _notify(i)
        if n_fb:
            obs.span_event("ladder.cpu-fallback", time.perf_counter() - t_fb,
                           histories=n_fb)

    def _degrade_confirmation(i: int, dev_res: dict, e: BaseException) -> None:
        """A confirmation worker died twice: degrade this history only.
        With ``cpu_fallback`` (and budget left) the sweep re-runs in
        process."""
        _pv(i, "confirm.degraded", error=type(e).__name__)
        if cpu_fallback and not (deadline is not None and deadline.expired()):
            try:
                results[i] = wgl_cpu.sweep_analysis(
                    model, histories[i], max_configs=confirm_max_configs)
                return
            except Exception as e2:  # noqa: BLE001
                results[i] = {
                    "valid?": "unknown",
                    "cause": ("device refutation; confirmation sweep raised: "
                              f"{e2!r}"),
                    "kernel": dev_res.get("kernel"),
                }
                return
        results[i] = {
            "valid?": "unknown",
            "cause": f"device refutation; confirmation worker failed: {e!r}",
            "kernel": dev_res.get("kernel"),
        }

    t_drain = time.perf_counter()
    for i, (pool, fut, dev_res, t_submit, op_pos, ctx) in confirm_futs.items():
        with obs.attach(ctx):
            # the submit-time context: every event this resolution
            # emits carries the originating trace
            resubmitted = False
            cpu_res = None
            while True:
                try:
                    if fut is None:
                        raise BrokenProcessPool(
                            "no confirmation worker available")
                    timeout = None
                    if deadline is not None:
                        # a small grace so that nearly-done sweeps land
                        timeout = max(5.0, deadline.remaining())
                    cpu_res = fut.result(timeout=timeout)
                    break
                except FutureTimeout:
                    deadline_tripped = True
                    confirm_degraded.add(i)
                    obs.counter("fault.deadline.trip")
                    obs.event("fault.deadline", at="confirm-drain", history=i)
                    _pv(i, "fault.deadline", at="confirm-drain")
                    results[i] = {
                        "valid?": "unknown",
                        "cause": ("device refutation; deadline-exceeded "
                                  "before the confirmation sweep finished"),
                        "kernel": dev_res.get("kernel"),
                    }
                    break
                except BrokenProcessPool:
                    # reset only the pool the failure came from, and only
                    # while it is still the installed one
                    if pool is not None and pool is _CONFIRM_POOL:
                        _drop_confirm_pool()
                    if not resubmitted:
                        # the task died with its pool: one resubmit
                        resubmitted = True
                        obs.counter("fault.confirm.resubmit", history=i)
                        _pv(i, "confirm.resubmit")
                        pool, fut = _submit_confirmation(
                            confirm_workers, model, list(histories[i]),
                            confirm_max_configs, op_pos)
                        continue
                    _degrade_confirmation(
                        i, dev_res,
                        BrokenProcessPool("confirmation worker failed twice"))
                    break
                except Exception as e:  # noqa: BLE001 — a dead worker
                    # must not lose the other histories' verdicts
                    _degrade_confirmation(i, dev_res, e)
                    break
            if cpu_res is not None:
                obs.gauge(
                    "confirm.queue_latency_s",
                    round(time.perf_counter() - t_submit, 6), history=i,
                )
                results[i] = _resolve_confirmation(dev_res, cpu_res)
                _pv(i, "confirm.resolved", mode="worker",
                    outcome=_prov.verdict_str(results[i].get("valid?")))
        _notify(i)
    stats["confirm_drain_s"] = time.perf_counter() - t_drain
    if confirm_futs:
        obs.span_event("ladder.confirm.drain", stats["confirm_drain_s"],
                       confirmations=len(confirm_futs))

    if packs and batch_caps and obs.active() is not None:
        # a recorded run ends with the per-round dedup timing at its
        # first rung's candidate shape, every backend (one dedup.round
        # span each), once per shape per process
        pP = wgl._bucket(max(p["P"] for p in packs), list(P_BUCKETS))
        pG = wgl._bucket(max(p["G"] for p in packs), list(G_BUCKETS))
        shape = (batch_caps[0], pP, pG)
        if shape not in _PROBED_DEDUP_SHAPES:
            _PROBED_DEDUP_SHAPES.add(shape)
            t_probe = time.perf_counter()
            hashing.dedup_round_probe(batch_caps[0], pP, pG, (pP + 31) // 32,
                                      device=device)
            obs.span_event(
                "ladder.dedup-probe", time.perf_counter() - t_probe,
                capacity=batch_caps[0], active_backend=dedup,
            )

    if checkpoint_dir is not None and not trip_checkpointed:
        # the final checkpoint: complete unless a deadline left resumable
        # work (degraded confirmations keep their descriptors)
        confirm_futs = {
            i: t for i, t in confirm_futs.items() if i in confirm_degraded
        }
        _save_checkpoint(
            len(stages),
            complete=not deadline_tripped and not confirm_degraded,
        )
    out = [r if r is not None else {"valid?": "unknown"} for r in results]
    for i, r in enumerate(out):
        _prov.attach(r, prov_paths.get(i, []), engine=prov_engine,
                     config=prov_cfg)
    return out
