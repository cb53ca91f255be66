#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository.  It imports only the port (never
jax or the JAX package), builds the CUDA kernels from the sources in the
checkout (one nvcc per source, all started together), and then:

  1. prints the card's name and power limit (nvidia-smi);
  2. holds each kernel against its plain PyTorch version on the card, at
     the bench wide-rung shapes (capacity 2048, P = 8, G = 16 and 32, 8
     lanes), on a class-heavy table of the G = 32 shape (big (state, fok)
     classes, so that the domination prune kills), a copy-heavy one
     (buckets of ~2,600 copies of one row) and one small shape: the
     results must be identical (integer and bit outputs, tolerance 0);
     times both with CUDA events, the fused update's tail
     (``wk_fused_tail`` after one keep mask) apart from it, each
     kernel's device time, and the keep mask's sort stage beside one
     stable ``torch.sort`` of the same bucket keys (a yardstick the port
     never calls); then, untimed and at tolerance 0, small tables at the
     geometries the bench does not reach (G = 4, 8 and 64, probe and
     class-heavy rows; P = 40 and 128, so W = 2 and 4) and the keep
     mask's edge tables of tests/test_torch_keep_sort.py (1,000 copies of
     a row, copies ``window`` and ``window + 1`` bucket-mates apart, one
     bucket for every alive row, none or one row alive, a ragged row
     count, 22 bucket bits, 20,000 rows with three copy groups), each
     through both kernels;
  3. the exchange kernel against its plain version at the bench mesh
     rescue shapes (4 shards, rcap 19,200 / 31,488 rows of 20 / 36
     int32 columns) and a small one (tolerance 0), timed beside its
     bound, its plain version and one PyTorch gather of the same
     permutation; then the fused update with an explicit child column
     against its plain version on the received-table shape (4 lanes of
     125,952 rows, capacity 2048, G = 32);
  4. the cross-path contract: ``mesh_update`` on 4 shards at the bench
     rescue shape (global capacity 8192, P = 8, G = 32) and the
     single-shard fused update at capacity 8192 on the same table give
     the same alive content with child bits, overflow flag and
     fingerprint;
  5. runs the bench ladder: 128 CAS-register histories of 100 ops, 8
     processes, 30 % :info, 8 values, every 4th corrupted (seeds
     0-127), capacity ladder (128, 512, 2048), no exact stages, no CPU
     fallback, the fused backend, on the card; every kernel's launch
     count must be > 0 in that run.  That run keeps a copy of the inputs
     of its fused update call with the most alive candidate rows (a
     stand-in for ``wide_kernel.fused_frontier_update``, compared on the
     card without a host sync), and that captured ladder table is then
     held and timed as the tables of phase 2 are;
  6. checks the verdicts of the first 48 histories against the exact CPU
     sweep (100,000-configuration budget): no disagreement among
     verdicts that are not "unknown";
  7. runs the same ladder with ``mesh=make_mesh(4)``: the lanes it
     leaves undecided get the mesh rescue at 4 x 2048 rows on 4 logical
     shards of the card.  Every kernel, the exchange included, must
     launch in that run; the lanes the rescue took must be those the
     ladder of phase 5 left unknown, the others' verdicts unchanged,
     and the rescued verdicts must agree with the exact sweep
     (2,000,000-configuration budget).  For comparison it runs those
     lanes on a single-shard rung at the rescue's total capacity and at
     twice it (one card gives the mesh no capacity a single shard
     lacks).  Then the mesh engine alone at the rescue capacity on the
     first 8 histories the greedy walk left to the frontier rungs: at
     least one verdict decided, and no disagreement with the exact
     sweep (100,000-configuration budget).
  8. the single-history path (``wgl.analysis``, the chunked engine), with
     the launch counts set to 0 before it and read after it (keep mask
     and fused update must launch): (a) BASELINE config 2, a 10,000-op
     CAS-register history of 32 processes (5 % :info, seed 0; 7,091
     barriers, P = 32, G = 30 padded to 32), on the fast engine under
     "fused" at capacity (1024, 4096): it may not refute it, and the
     greedy witness walk must answer True (its closures outgrow 4,096
     rows within the first 32 barriers, so the frontier engines lose
     rows: PERF.md); then a 2,000-op, 32-process history (seed 1, 1,417
     barriers) on the fast engine at (1024, 2048, 4096), without and
     with spill, and on its default ladder (128, 1024, 4096), which
     climbs from a rung below the fused floor into the fused kernel
     (config 2 on that ladder loses rows as at (1024, 4096), in ~4
     times the time, so this history takes its place): all three must
     answer True, the last at 4,096 rows with fused launches (the
     spill=False run keeps a copy of its fused call with the most alive
     rows at each rung); (b) config 2 corrupted,
     fast at (1024, 4096) and exact (``fast=False``) at 128 rows (the
     exact update at 4,096 rows costs ~0.16 s a barrier): the two
     verdicts (and, when False, the failing ops) must agree, and with
     the exact CPU sweep where it decides within 100,000 configurations
     on the prefix that ends at the fast engine's failing op; beside
     them, the frontier of the fast engine after each 16 barriers of
     config 2 (an exact union of 4096-row slices until a closure
     outgrows one) and the exact and fast engines' seconds per barrier
     at 4096 rows over 16 barriers of the corrupted copy; then the
     corrupted bench histories 3 and 7, fast and exact at (1024, 4096):
     both engines must refute each, at the op where the sweep of phase
     6 does; (c) the 2,000-op history under a 30 MB
     frontier budget, which leaves the rungs 1024 and 2048 usable, so
     that the carried frontier spills to the host: spill rows > 0 and
     the verdict of spill=False (True); (d) the first 32 bench histories
     through ``batch_analysis(engine="sync", exact_escalation=(2048,))``:
     no disagreement with phase 5's ladder nor with phase 6's sweep
     where both decide; (e) ``mesh_kernel_analysis`` on
     ``make_mesh(1)``, which falls back to the chunked engine: equal to
     ``wgl.analysis(fast=True)`` and to the sweep's verdict on a bench
     history the sweep decided.  Each run prints its seconds, chunks,
     chunk scans and host syncs per barrier.  Last, after the counts
     are read, the exact update's domination prune is held against a
     dense yardstick of every pair's counts (identical masks) and timed
     beside it at 4096 and 8192 rows, and the captured fused calls at
     1024, 2048 and 4096 rows (one lane, P = G = 32) are held against
     the plain versions (tolerance 0) and timed as the tables of phase 2
     are.  No history length is cut.
  9. the checker front end, through the port's checkers only, with the
     launch counts set to 0 before each sub-phase and read after it: (a)
     the 128 bench histories as the keys 0-127 of one history (each
     value wrapped with ``independent.tuple_``, 12,800 invoke/complete
     pairs) through ``independent.checker(linearizable({"model":
     "cas-register", "algorithm": "competition", "kernel-opts":
     {"capacity": (128, 512, 2048)}}))``: ``check_batch`` called once
     and returning, each key's verdict phase 5's where phase 5 decided,
     and unknown or the exact sweep's (2,000,000 configurations) where
     it did not; (b) those undecided keys again with ``"mesh":
     make_mesh(4)`` in ``kernel-opts`` (the exchange must launch); (c)
     ``check`` under "competition" on bench histories 0-31 (in 4 spawned
     processes, each on the card, started with the phase and running
     beside (a), (b) and (d): the CPU DFS that some histories reach
     takes ~100 s each), with phase 5's verdict wherever phase 5
     decided, save on histories 23 and 27, which the competition leaves
     unknown at its default async rungs (256, 1024) as the JAX package's
     does (tests/test_torch_checker.py), never contradicting phase 6's
     sweep, with the count of histories each engine decided; (d) "tpu"
     with ``{"capacity": (1024, 2048, 4096), "fast": True}`` on phase
     8's 2,000-op history (True) and bench histories 3 and 7 (refuted at
     the sweep's ops); (e) ``stream_check`` in 64-op epochs, fast under
     "fused" at (1024, 4096), on the (d) histories (True at finalize; 3
     and 7 refuted before their last op, at the sweep's op), then at the
     streaming checker's default capacity on bench histories 0-31 (in
     the same 4 processes) against the post-hoc ladder at the same
     capacity: wherever the stream decides, the same verdict, op and
     ``parity_digest`` as the ladder with its CPU fallback; a stream
     left unknown (its exact engine at 256 rows loses rows on some
     corrupted bench histories) must be one that the ladder's rungs,
     without the fallback, leave unknown too.  The keep mask and the
     fused update must launch in (a), (d) and (e). The checks of (a)-(d) go through
     ``checker.check_safe``, which turns an exception (a kernel that
     fails to build or launch) into a result with an ``error``; any
     ``error`` in a result fails the run (a stream raises instead).
 10. Elle, the checkers of transactional histories, each sub-phase on a
     line with its seconds and the card's name and power limit: (a)
     BASELINE config 3, ``list_append()`` on the 10,000-transaction
     history (50 keys, 16 processes, seed 5): True, with inference and
     classification timed apart, and the "columns" and "loops" engines
     equal on the graph (matrices, edge arrays, nodes, anomalies, every
     edge's explanation) and the result (the graph is over
     ``SCC_THRESHOLD``, so host SCC classifies it under either
     backend); (b) its ``corrupt_wr(seed=6)`` copy: False with
     anomaly-types ``["incompatible-order"]``; (c) config 3c, 1,024
     per-key histories of 48 transactions (3 keys, 8 processes, seeds
     1000+i) through one ``ListAppendChecker.check_batch`` with
     ``elle.CYCLE_BACKEND`` "device", then "host": one call each, which
     returns, and all 1,024 results equal; then the cycle phase on the
     same graphs, on the card (its ``pad``, ``h2d``, ``closure`` and
     ``d2h`` seconds, and the bucket's batched classification timed with
     CUDA events beside its bf16 bound) and on host SCC, flags and hints
     equal; (d) graphs of 128, 512 and 1,024 nodes with one planted G0,
     G1c, G-single and G2 cycle each, and their acyclic controls:
     ``classify_graph`` and ``check_graph`` on the card, on the CPU path
     and on host SCC equal, flags and hints included; the closure on the
     card equal to ``transitive_closure_np`` and to
     ``transitive_closure_sharded`` on ``make_mesh(4)``; then
     ``cycle_checker(realtime_analyzer, backend="device")`` True on a
     real history (a realtime order has no cycle) and False once a
     claimed order reverses one realtime pair; (e) the cycle phase on
     both backends at 1,024 x 48, 256 x 128 and 64 x 700 transactions,
     flags and hints equal, seconds recorded and nothing asserted on
     speed.  An ``elle_json:`` line carries the seconds and the
     crossover table.
 11. the services, each sub-phase on the bench workload of phase 5
     unless named otherwise, with the launch counts set to 0 before each
     and read after it, on a line with its seconds and the card's name
     and power limit: (a) a real kill: a child process (``--ladder-child
     DIR``) runs the ladder with a checkpoint directory and is SIGKILLed
     (its process group) once the checkpoint reaches stage 2; the ladder
     resumed here gives phase 5's verdicts, every result recording the
     restore, and the resume's seconds are printed beside phase 5's
     ladder seconds; (b) a ``faults.Deadline`` of a third of phase 5's
     ladder seconds: every history still undecided is unknown with cause
     ``deadline-exceeded`` naming the checkpoint, the rest phase 5's,
     and a resume gives phase 5's verdicts; (c) a real out-of-memory:
     the lanes phase 5 took to the 2048 rung are launched alone at their
     padded width and at half of it, and ``torch.cuda.set_per_process_
     memory_fraction`` caps the process halfway between the two peaks of
     reserved memory (printed); a ladder stopped at the 2048 rung's
     boundary (a deadline that expires at that rung's poll) resumes
     under the cap, so that the rung's launch runs out of memory and
     must halve (the halvings printed; at least one at 2048), with phase
     5's verdicts; the fraction is restored, then a
     ``seeded_injector`` schedule of transient faults and injected
     out-of-memory errors, counted by kind as they are raised (at least
     one): each verdict phase 5's or an unknown naming the fault; (d)
     ``confirm_refutations="device"`` over the histories phase 5
     refuted: each refuted again and confirmed, by exactly one exact
     launch per capacity and lane budget, final on the card (its
     ``confirm.device`` event) or, where its exact lane was lossy or
     survived, by the bounded sweep after that launch (the counts of
     each printed per capacity), the exact runner's seconds beside
     phase 5's confirm drain; (e) ``sharded_analysis`` on ``make_mesh(4)`` at
     4096 rows over bench histories 3 and 7 (corrupted) and a 250-op,
     8-process history (5 % :info, seed 500): the verdicts and failing
     ops of ``wgl.analysis(fast=True)`` at the same capacity, and the
     exchange launched, the counts read around each ``sharded_analysis``
     call alone (the reference's own launches stay out); (f) ``check_safe``
     of ``independent.checker(linearizable(competition))`` with a store
     directory on bench keys 0-7: a bundle per key, ``verify_bundle``
     passing on each, its digest the in-memory bundle's.  (d) also
     prints each exact lane the bounded sweep then decided: its
     capacity, whether it was lossy or survived its prefix, and its
     failing barrier and peak.
 12. the telemetry core (``obs``), each sub-phase under its own
     ``obs.recording`` in a temporary directory, with the launch counts
     set to 0 before each and read after it, on ``telemetry[...]``
     lines: (a) phase 5's ladder, all 128 histories: phase 5's
     verdicts and kernel launches (the recorded run ends with the dedup
     probe at the first rung's shape, whose keep-mask launches are
     counted apart), ``telemetry.jsonl`` and ``telemetry.json``
     written, one ``ladder.stage`` row per rung with ``launches`` >= 1,
     compile and execute launches summing to it and
     ``device_bytes_peak`` > 0, ``devices == [0]`` on every
     ``ladder.launch`` span, and the last ``ladder.unknowns_remaining``
     phase 5's unknown count; it prints the recorded seconds beside
     phase 5's, the summary's ladder table, device 0's busy share
     (``critpath.device_timeline``), the critical path's five longest
     spans, the event count and the jsonl's size; (b)
     ``wgl.analysis(fast=True)`` on bench histories 3 and 7 corrupted
     on the default ladder (128, 1024, 4096): refuted, ``wgl.chunk.*``
     counters and ``device.buffer_bytes`` gauges at "wgl-chunk" above
     0; (c) ``check_safe`` of ``independent.checker(linearizable
     ("tpu"))`` on bench keys 0-7, one ``checker.check`` span and no
     verdict against phase 5's, then config 3c's ``check_batch`` with
     the cycle phase on the card, ``elle.scc`` spans with
     ``backend="device"``; (d) (a)'s stream exported by ``obs.trace``
     loads as JSON with one ``device 0`` lane holding every
     ``ladder.launch`` and counter tracks for
     ``ladder.unknowns_remaining`` and ``device.buffer_bytes``; (e) no
     recording open after the phase, so every other phase runs the
     no-op path.
 13. the check service (``serve.CheckService``) on the card with phase
     5's ladder options, the launch counts set to 0 before each
     sub-phase and read after it, on ``serve[...]`` lines: (a) four
     tenants of 32 bench histories (two ``interactive``, two ``batch``)
     submitted at once, with phase 5's verdicts where it decided, the
     per-class admission and request latencies and the request
     decomposition; (b) a second wave joining the running ladder at a
     rung boundary; (c) a drain and its ``resume_drained``; (d) a poison
     member bisected and quarantined; (e) ``devices=4`` with the mesh
     rescue and a lost shard; (f) config 3c's first 64 graphs on the
     graph lane; (g) bench 3 as a stream, refuted.
 14. the check service's HTTP API (``web``) on the card, in the process
     that ran phases 1-13, on phase 5's histories and results, the
     launch counts set to 0 before each sub-phase and read after it, on
     ``web[...]`` lines: (a) ``web.make_server`` on 127.0.0.1 with a
     ``CheckService`` (phase 5's ladder options) and an
     ``obs.profiler.ProfilerHook`` mounted, ``/healthz`` and ``/readyz``
     200; (b) bench 19 (which phase 5 takes through every rung) as one
     batch ``POST /check`` with ``"wait"``, phase 5's verdict, under two
     captures of the card's activity: ``POST /profile/start {"seconds":
     1}`` a second into its ladder, stopped by the hook's watchdog on its
     timer thread, and ``POST /profile/start {"seconds": 60}`` at its
     first fused update, stopped by ``POST /profile/stop`` when the
     request returns (a capture of all of (c) would hold ~10^6 launches,
     and a stop holds the GIL while it writes them); phase 2 has run
     ``torch.profiler`` on the main thread before, and the hook runs its
     captures on a thread of its own; (c) bench 0-15 as
     ``interactive`` requests with ``"wait": true`` and bench 16-31 as
     ``batch`` requests polled by ``GET /check/<id>``, all at once: phase
     5's verdicts where it decided, an idempotent resubmission given its
     id back, ``GET /evidence/<id>`` of a refuted one passing
     ``provenance.verify_bundle``, ``/queue`` and ``/alerts`` parsed, an
     oversized body refused 413, the keep mask and the fused update
     launched, per class the latency over HTTP beside the service's
     own (batch requests: their POST and last GET round trips, the
     client's poll wait apart), and ``/healthz``'s round trip under the
     wave against (a)'s; (d) bench 3 as one NDJSON ``POST /stream``: refuted; (e) the
     captures read back: the top rung's holds kernels of
     ``wide_kernel.cu`` launched from the service's scheduler thread, and
     each capture's device busy share over the hook's window (its
     elapsed time when stopped: the watchdog's bound for the first) is
     printed; (f) bench 0-7 and phase
     5's results stored as a run through ``save_0``..``save_2``, listed by
     ``GET /`` with the validity its footer holds and served by
     ``/zip/``; (g) an ``obs.regress`` record of the phase's numbers and a
     ``run_competition("dedup_backend", ["fused", "bucket"], repeats=2)``
     appended to the store's ledger, the fused update launched in the
     "fused" arm only, ``GET /perf`` rendering both and ``/metrics``
     carrying ``jepsen_tpu_perf_headline``.

It prints a ``{"kernels": [...]}`` JSON line (launches from the mesh
ladder of phase 7, from phase 8 as ``single_history_launches``, from
phase 9's sub-phases as ``checker_launches``, from phase 11's as
``services_launches``, from phase 12's as ``telemetry_launches``, from
phase 13's as ``serve_launches`` and from phase 14's as
``web_launches``;
times at the G = 32 shapes, and as ``single_<rows>_ms`` at phase 8's
captured shapes) and the card line, and as its last line
``{"ok": true, "device": {...}}``.  Before those lines it stops every
process of the run that still runs (its orphans included: it makes
itself their parent) and prints them on a ``processes:`` line; a run
that fails stops them too.  It exits non-zero,
printing no result, without a CUDA device or outside the repository.

    python3 chip_smoke.py --entry-times ROOT

only times the kernels' entry points of the port package in ROOT (a
checkout of another commit, or ``.``) at the bench shapes; run it for
two trees in turns (parent, change, change, parent) to compare them on
one card.
"""

from __future__ import annotations

import faulthandler
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

N_HISTORIES = 128
OPS_PER_HISTORY = 100
PROCS = 8
INFO_RATE = 0.3
N_VALUES = 8
CORRUPT_EVERY = 4
CAPS = (128, 512, 2048)
CPU_MAX_CONFIGS = 100_000
CPU_SAMPLE = 48
MESH_SHARDS = 4
RESCUE_MAX_CONFIGS = 2_000_000
MESH_ENGINE_LANES = 8

#: Phase 8: BASELINE config 2 (10k-op etcd-style linearizable register,
#: 32 concurrent processes), its corrupted copy's sweep budget, the
#: spill history and its budget, and the batch stages' lanes.
SINGLE_OPS = 10_000
SINGLE_PROCS = 32
SINGLE_INFO = 0.05
SINGLE_CAPS = (1024, 4096)
SINGLE_DEFAULT_LADDER = (128, 1024, 4096)
SINGLE_SWEEP_CONFIGS = CPU_MAX_CONFIGS
GROWTH_STEPS = 4
EXACT_COST_BARRIERS = 16
EXACT_SINGLE_CAPS = (128,)
SPILL_OPS = 2000
SPILL_CAPS = (1024, 2048, 4096)
SPILL_BUDGET_MB = 30.0
DECIDED_BENCH = (3, 7)
SYNC_LANES = 32
EXACT_CAPS = (2048,)

#: Phase 9: the checker front end: histories per-history checks run on,
#: the "tpu" algorithm's kernel-opts, the streams' epoch size and fast
#: ladder, and the post-hoc ladder the default-capacity streams are
#: held to (the streaming checker's default capacity).
CHECKER_HISTORIES = 32
CHECKER_WORKERS = 4
TPU_OPTS = {"capacity": (1024, 2048, 4096), "fast": True}
STREAM_FEED_OPS = 64
STREAM_CAPS = (1024, 4096)
STREAM_POSTHOC_CAPS = (64, 256)
#: Bench histories that phase 5's ladder refutes and the competition,
#: at its default kernel-opts, leaves unknown: its async rungs (256,
#: 1024) lose rows, the CPU DFS exhausts its budget and the chunked
#: exact rungs lose rows, as the JAX package's competition does on them.
COMPETITION_UNDECIDED = (23, 27)

#: Phase 10: Elle.  BASELINE config 3 (tools/benchmarks.py:122-190):
#: the 10k-transaction list-append history (50 keys, 16 processes, seed
#: 5), its corrupted copy (seed 6) and the per-key shape 3c (1,024
#: histories of 48 transactions over 3 keys and 8 processes, seeds
#: 1000+i); the planted-cycle graph sizes; the crossover shapes
#: (graphs, transactions each) and their seeds.
ELLE_TXNS = 10_000
ELLE_KEYS = 50
ELLE_PROCS = 16
ELLE_SEED = 5
ELLE_CORRUPT_SEED = 6
PER_KEY_GRAPHS = 1024
PER_KEY_TXNS = 48
PER_KEY_KEYS = 3
PER_KEY_PROCS = 8
PER_KEY_SEED = 1000
PLANTED_SIZES = (128, 512, 1024)
CROSSOVER = ((1024, 48), (256, 128), (64, 700))
CROSSOVER_SEED = 3000

#: Phase 13: the check service.  Four tenants of 32 bench histories
#: each (two interactive, two batch); the rung join's and the drain's
#: waves; the poison bisection's members; the shards of the placement
#: and the one its probe fails; config 3c's graphs on the graph lane.
SERVE_CLASSES = ("interactive", "interactive", "batch", "batch")
SERVE_TENANT_HISTORIES = 32
SERVE_WAVE = 32
SERVE_POISON_MEMBERS = 8
SERVE_SHARDS = 4
SERVE_LOST_SHARD = 2
SERVE_GRAPHS = 64

#: Phase 14: the HTTP API.  Bench histories 0-15 as interactive waits
#: and 16-31 as batch requests, each batch request polled every
#: WEB_POLL_S (faster polling from 16 threads starves the scheduler
#: thread of the GIL, and the ladder slows several-fold); the server's
#: request-body bound; the profiled request (bench 19, which phase 5
#: takes through every rung) and its two captures (one second of the
#: narrow rungs, begun a second into its ladder, and its top rung); the
#: interval of the /healthz probe under (c)'s wave; the phase's time limit;
#: the stored run's keys; the competition's
#: workload (6 histories of 100 ops and 8 processes at one 1024-row
#: rung, the fused floor, so the fused arm must reach the kernel); the
#: kernels of wide_kernel.cu the top-rung capture must hold one of.
WEB_INTERACTIVE = 16
WEB_BATCH = 16
WEB_MAX_REQUEST_MB = 1.0
WEB_PROFILE_S = 60
WEB_PROFILE_NARROW_S = 1.0
WEB_PROFILE_NARROW_DELAY_S = 1.0
WEB_PROFILE_HISTORY = 19
WEB_POLL_S = 0.2
WEB_HEALTH_PROBE_S = 0.5
WEB_LIMIT_S = 360
WEB_RUN_KEYS = 8
COMPETE_WORKLOAD = {"histories": 6, "ops": 100, "procs": 8,
                    "capacity": (1024,)}
WIDE_KERNEL_NAMES = ("k_hash_keys", "k_bin_sort_kill", "k_exclusive_scan",
                     "k_compact1", "k_compact2", "k_prune_tiles",
                     "k_prune_list", "k_scan_hist", "k_radix_scatter",
                     "k_chunk_count", "k_class_scatter")

#: H100 SXM published peaks (dense): HBM bytes/s, and the 32-bit
#: non-tensor rate used for the kernels' integer compare/hash work.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: bf16 dense tensor-core rate (the closure's products).
BF16_FLOPS_PER_S = 989e12

#: int ops per hashed column per lane: one xor, then fmix32's 3
#: xor-shifts (2 ops each) and 2 multiplies.
HASH_OPS_PER_COL = 9


#: prctl's option that makes a process the parent of its orphaned
#: descendants (linux/prctl.h).
PR_SET_CHILD_SUBREAPER = 36


def _adopt_orphans() -> None:
    """Make this process the parent of every descendant whose own parent
    ends before it (Linux's child subreaper), so that
    ``_stop_descendants`` finds it."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1,
                                                0, 0, 0)
    except (OSError, AttributeError):
        pass


def _descendants() -> dict:
    """{pid: (parent pid, state, command line)} of every process under
    this one, read from /proc."""
    procs = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            stat = Path(f"/proc/{name}/stat").read_text()
            cmd = Path(f"/proc/{name}/cmdline").read_bytes()
        except OSError:
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        procs[int(name)] = (int(ppid), state, cmd.replace(b"\0", b" ")
                            .decode(errors="replace").strip())
    out: dict = {}
    frontier = [os.getpid()]
    while frontier:
        parent = frontier.pop()
        for pid, v in procs.items():
            if v[0] == parent and pid not in out:
                out[pid] = v
                frontier.append(pid)
    return out


def _stop_descendants() -> list[str]:
    """Stop every process of this run that still runs, apart from the
    multiprocessing resource tracker, which ends with this process (its
    pipe closes), and reap the ended ones left to this process; returns
    one description per process it had to stop."""
    import signal

    me = os.getpid()

    def running() -> dict:
        for pid, (ppid, state, _cmd) in _descendants().items():
            if state == "Z" and ppid == me:
                try:
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass
        return {pid: v for pid, v in _descendants().items()
                if v[1] != "Z" and not (
                    v[0] == me and "multiprocessing.resource_tracker" in v[2])}

    left = running()
    stopped = [f"pid {pid} (parent {v[0]}): {v[2][:200]}"
               for pid, v in sorted(left.items())]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            try:
                os.kill(pid, sig)
            except OSError:
                pass
        deadline = time.monotonic() + 5.0
        while left and time.monotonic() < deadline:
            time.sleep(0.05)
            left = running()
        if not left:
            break
    return stopped


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def _launch_counts(wk) -> dict:
    """Each kernel's launches since the last ``wk.reset_counts()``."""
    return {"keep_mask": wk.KEEP_LAUNCHES,
            "fused_frontier_update": wk.FUSED_LAUNCHES,
            "mesh_exchange": wk.EXCHANGE_LAUNCHES}


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA
    events around ``iters`` calls after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 20) -> float:
    """Milliseconds per call of ``fn`` on the card alone: one call
    captured in a CUDA graph and replayed ``iters`` times between CUDA
    events, so that the host's work per call (Python, allocation,
    launches) is not in it.  ``_time_ms`` times calls as a caller makes
    them, and is the larger of the two when the host is slower."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_us(fn, iters: int = 5) -> tuple[str, dict]:
    """The device microseconds per call of each CUDA kernel one call of
    ``fn`` runs (torch.profiler): a line, largest first, and a dict by
    kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0)
                   or getattr(e, "self_cuda_time_total", 0)) / iters
        if us > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            rows.append((us, name.replace("void ", "").split("(")[0][:40]))
    line = ", ".join(f"{name} {us:.2f}" for us, name in sorted(rows, reverse=True))
    return line, {name: us for us, name in rows}


def _tables(capacity: int, P: int, G: int, lanes: int, dev, W: int = 1):
    """A [lanes, capacity*(1+P+G)] candidate table of probe rows with W
    fok words, one seed per lane."""
    import numpy as np
    import torch

    from jepsen_tpu_torch.ops import hashing

    rows = [hashing.probe_candidates(capacity, P, G, W, seed=s)
            for s in range(lanes)]
    return tuple(torch.from_numpy(np.stack([r[k] for r in rows])).to(dev)
                 for k in range(4))


def _class_heavy(capacity: int, P: int, G: int, lanes: int, dev):
    """A [lanes, capacity*(1+P+G)] candidate table whose 2C buffer holds
    big (state, fok) classes, one seed per lane: half the rows fall in 8
    classes (2 states x 4 fok values: hundreds of buffer rows each), the
    rest spread over 64 states x 2^16 fok values (thousands of small
    classes), so that a class super-bucket's list holds several classes.
    Each row's counts are a level in [0, m] plus sparse +1 noise, clipped
    to m = P + 1, so that rows of one class dominate each other often;
    half the rows copy another row, about 15 % are dead."""
    import numpy as np
    import torch

    m = P + 1
    out = []
    for s in range(lanes):
        rng = np.random.default_rng(1000 + s)
        n = capacity * (1 + P + G)
        big = rng.random(n) < 0.5
        st = np.where(big, rng.integers(0, 2, n), rng.integers(0, 64, n))
        fo = np.where(big, rng.integers(0, 4, n), rng.integers(0, 1 << 16, n))
        lvl = rng.integers(0, m + 1, (n, 1))
        fc = np.minimum(m, lvl + (rng.random((n, G)) < 0.15))
        src = rng.integers(0, n, n // 2)
        st[: n // 2], fo[: n // 2], fc[: n // 2] = st[src], fo[src], fc[src]
        out.append((st.astype(np.int32), fo.astype(np.int32)[:, None],
                    fc.astype(np.int16), rng.random(n) < 0.85))
    return tuple(torch.from_numpy(np.stack([r[k] for r in out])).to(dev)
                 for k in range(4))


def _copy_heavy(capacity: int, P: int, G: int, lanes: int, dev):
    """A [lanes, capacity*(1+P+G)] probe table (``_tables``) in which a
    quarter of each lane's rows, at random positions, are alive copies
    of 8 distinct rows of the lane: 8 buckets of ~2,600 copies at the
    bench G = 32 shape.  One seed per lane."""
    import numpy as np
    import torch

    from jepsen_tpu_torch.ops import hashing

    out = []
    for s in range(lanes):
        st, fo, fc, al = hashing.probe_candidates(capacity, P, G, 1, seed=s)
        rng = np.random.default_rng(2000 + s)
        n = st.shape[0]
        src = rng.choice(n, 8, replace=False)
        pos = rng.choice(n, n // 4, replace=False)
        pick = src[rng.integers(0, 8, pos.size)]
        st[pos], fo[pos], fc[pos], al[pos] = st[pick], fo[pick], fc[pick], True
        out.append((st, fo, fc, al))
    return tuple(torch.from_numpy(np.stack([r[k] for r in out])).to(dev)
                 for k in range(4))


class _Capture:
    """Stands in for ``wide_kernel.fused_frontier_update`` during a run
    and keeps, for each capacity, a copy of the inputs of its call with
    the most alive candidate rows (``calls``: capacity -> [key, tables,
    count]).  Calls of one shape are compared on the card
    (``torch.where`` on the alive counts), so the run takes no extra
    host sync; a call of a larger shape replaces the copy."""

    def __init__(self, wk):
        self.fn = wk.fused_frontier_update
        self.calls: dict = {}

    def __call__(self, state, fok, fcr, alive, cost, capacity, window=4,
                 n_parents=None, max_count=None, child=None):
        import torch

        if child is None:
            key = (tuple(state.shape), tuple(fok.shape), tuple(fcr.shape),
                   capacity, window, n_parents, max_count)
            cnt = alive.sum()
            args = (state, fok, fcr, alive)
            old = self.calls.get(capacity)
            if old is None or (key != old[0] and state.numel()
                               > old[1][0].numel()):
                self.calls[capacity] = [key, [t.clone() for t in args], cnt]
            elif key == old[0]:
                more = cnt > old[2]
                for t, x in zip(old[1], args):
                    t.copy_(torch.where(more, x, t))
                old[2] = torch.maximum(old[2], cnt)
        return self.fn(state, fok, fcr, alive, cost, capacity, window=window,
                       n_parents=n_parents, max_count=max_count, child=child)


def check_captured(wk, capture, tag, capacity=None, timed=True) -> dict:
    """The captured fused update call at ``capacity`` (default: the
    largest captured table), held against the plain versions and, when
    ``timed``, timed as the bench tables are."""
    if not capture.calls:
        raise AssertionError(f"{tag}: the run made no fused update call")
    if capacity is None:
        capacity = max(capture.calls,
                       key=lambda c: capture.calls[c][1][0].numel())
    key, tables, count = capture.calls[capacity]
    _s, _f, _g, capacity, window, n_parents, max_count = key
    st = tables[0]
    print(f"captured[{tag}]: the fused call with the most alive candidate "
          f"rows: {int(count)} of {st.numel()} (lanes {st.shape[0]}, "
          f"capacity {capacity}, n_parents {n_parents}, max_count "
          f"{max_count})", flush=True)
    return check_fused_table(tag, wk, *tables, capacity, n_parents, max_count,
                             window, timed)


def _max_abs_err(a, b) -> float:
    """Largest absolute difference of two result tuples (integer and
    bool outputs, compared as int64)."""
    import torch

    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return float(err)


def _work(state, fok, fcr, alive, capacity: int, part: str):
    """(bytes, ops) the function must move and do on these inputs: each
    input read once and each output written once; the two row-hash
    lanes of every row.  ``part``: "keep" (the keep mask), "fused" (the
    fused update: also the fingerprint hashes of its output rows and the
    pairwise domination tests within each (state, fok) class of its 2C
    buffer, this data's class sizes) or "tail" (the fused update after
    the keep mask: the keep mask and the buffer's rows in, the class
    hash of each buffer row, the domination tests, the outputs and
    their fingerprint)."""
    import torch

    from jepsen_tpu_torch.ops import wide_kernel as wk

    L, n = state.shape
    W, G = fok.shape[2], fcr.shape[2]
    row_in = 4 + 4 * W + 2 * G + 1
    cols = 1 + W + G
    if part == "keep":
        nbytes = L * n * row_in + L * n + 4 * L  # + keep mask, overflow flag
        return nbytes, L * n * 2 * cols * HASH_OPS_PER_COL
    C = capacity
    out_bytes = L * (C * (row_in + 1) + 8 + 12)
    if part == "fused":
        nbytes = L * n * row_in + out_bytes
        ops = L * n * 2 * cols * HASH_OPS_PER_COL
    else:
        nbytes = L * n + out_bytes  # the keep mask in
        ops = 0
    keep, _ovf = wk.keep_mask_ref(state, fok, fcr, alive)
    for l in range(L):
        sel = keep[l].nonzero().squeeze(1)[: 2 * C]
        key = torch.cat([state[l, sel, None], fok[l, sel]], 1)
        _u, counts = torch.unique(key, dim=0, return_counts=True)
        pairs = int((counts * (counts - 1)).sum())
        ops += pairs * 2 * G + min(int(sel.numel()), C) * 2 * cols * HASH_OPS_PER_COL
        if part == "tail":
            nbytes += int(sel.numel()) * (row_in - 1)
            ops += int(sel.numel()) * (1 + W) * HASH_OPS_PER_COL
    return nbytes, ops


def _bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


#: The keep mask's sort stage: the kernels of its sort passes (the
#: first pass's histogram is made by the hash pass and is not in it; the
#: bins' kernel also runs the kill, which is in it).
SORT_KERNELS = ("k_scan_hist", "k_radix_scatter", "k_bin_sort_kill")


def _bucket_keys(st, fo, fc, al):
    """The keep mask's sort keys as one PyTorch sort would take them:
    each row's bucket (top bucket bits of h1), dead rows keyed past
    every bucket, [L, n] int64."""
    import torch

    from jepsen_tpu_torch.ops import hashing

    h1, _h2 = hashing.row_hashes(st, fo, fc)
    _ibits, bbits = hashing._bucket_bits(st.shape[1])
    return torch.where(al, h1 >> (32 - bbits), 1 << bbits)


def check_kernels(dev, wk) -> dict:
    """Phase 2: each kernel against its plain version; returns the
    bench-shape measurements per kernel."""
    import torch

    shapes = [("small", 64, 4, 3, 2, _tables), ("bench-G16", 2048, 8, 16, 8, _tables),
              ("bench-G32", 2048, 8, 32, 8, _tables),
              ("class-heavy", 2048, 8, 32, 8, _class_heavy),
              ("copy-heavy", 2048, 8, 32, 8, _copy_heavy)]
    out = {}
    for tag, C, P, G, lanes, make in shapes:
        out[tag] = check_fused_table(tag, wk, *make(C, P, G, lanes, dev), C,
                                     C, P + 1, timed=tag != "small")
    # the geometries the bench does not reach: hash and prune instances
    # at G = 4, 8, 64 (k_hash_keys<1>/<8>, k_prune_tiles<2>/<4>/<32>)
    # and fok widths W = 2 and 4
    for tag, C, P, G, W, make in (
            ("probe-G4", 64, 8, 4, 1, _tables), ("class-G4", 64, 8, 4, 1, _class_heavy),
            ("probe-G8", 64, 8, 8, 1, _tables), ("class-G8", 64, 8, 8, 1, _class_heavy),
            ("probe-G64", 64, 8, 64, 1, _tables), ("class-G64", 64, 8, 64, 1, _class_heavy),
            ("probe-P40-W2", 64, 40, 4, 2, _tables),
            ("probe-P128-W4", 64, 128, 8, 4, _tables)):
        tables = (make(C, P, G, 2, dev, W) if make is _tables
                  else make(C, P, G, 2, dev))
        check_fused_table(tag, wk, *tables, C, C, P + 1, timed=False)
    for tag, tables in _keep_edge_tables(dev):
        check_fused_table(tag, wk, *tables, 64, 64, 5, timed=False)
    return out


def _cu_constant(name: str) -> int:
    """A ``constexpr int`` of the keep mask's CUDA source."""
    import re

    from jepsen_tpu_torch.ops import _build

    src = (_build.CSRC / "wide_kernel.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _bucket_mates(n: int, G: int, need: int = 8):
    """``need`` distinct rows (states, fok and fcr zero) whose h1 falls
    in one bucket of an n-row table."""
    import numpy as np

    from jepsen_tpu_torch.ops import hashing

    _ibits, bbits = hashing._bucket_bits(n)
    st = np.arange(1 << 22, dtype=np.int32)
    cols = [st, np.zeros_like(st)] + [np.zeros(st.size, np.int16)] * G
    bucket = hashing.np_hash_rows(cols, hashing.HASH_SEED_1) >> np.uint32(32 - bbits)
    order = np.argsort(bucket, kind="stable")
    b = bucket[order]
    start = np.r_[0, np.flatnonzero(b[1:] != b[:-1]) + 1]
    size = np.diff(np.r_[start, b.size])
    k = int(np.argmax(size >= need))
    return st[order[start[k]:start[k] + need]]


def _keep_edge_tables(dev):
    """The keep mask's edge tables of tests/test_torch_keep_sort.py (G =
    3, window 4), one lane each, on the card: (tag, tables)."""
    import numpy as np
    import torch

    G, window = 3, 4

    def probe(n, seed):
        rng = np.random.default_rng(seed)
        st = rng.integers(0, 64, n).astype(np.int32)
        fo = rng.integers(0, 1 << 16, (n, 1)).astype(np.int32)
        fc = rng.integers(0, 4, (n, G)).astype(np.int16)
        src = rng.integers(0, n, n // 4)
        st[: n // 4], fo[: n // 4], fc[: n // 4] = st[src], fo[src], fc[src]
        return st, fo, fc, rng.random(n) < 0.8

    out = []
    st, fo, fc, al = probe(4096, 1)
    pos = np.random.default_rng(2).choice(4096, 1000, replace=False)
    st[pos], fo[pos], fc[pos], al[pos] = st[5], fo[5], fc[5], True
    out.append(("copies-1000", (st, fo, fc, al)))
    mates = _bucket_mates(2048, G)
    for tag, gap in (("mates-window", window - 1), ("mates-window+1", window)):
        st, fo, fc, al = probe(2048, 3)
        pos = 100 + 3 * np.arange(gap + 2)
        st[pos] = np.r_[mates[0], mates[1:gap + 1], mates[0]]
        fo[pos], fc[pos], al[pos] = 0, 0, True
        out.append((tag, (st, fo, fc, al)))
    st, fo, fc, al = probe(4096, 4)
    mates = _bucket_mates(4096, G)
    pick = np.random.default_rng(5).integers(0, mates.size, 4096)
    st[:], fo[:], fc[:] = mates[pick], 0, 0
    out.append(("one-bucket", (st, fo, fc, al)))
    st, fo, fc, al = probe(1024, 6)
    out.append(("all-dead", (st, fo, fc, np.zeros_like(al))))
    st, fo, fc, al = probe(1024, 7)
    al[:] = False
    al[700] = True
    out.append(("one-alive", (st, fo, fc, al)))
    out.append(("ragged", probe(_cu_constant("kTileRows") * 3 + 77, 8)))
    out.append(("bbits22", probe(512, 9)))
    st, fo, fc, al = probe(20000, 12)
    pos = np.random.default_rng(13).choice(20000, 5000, replace=False)
    src = np.array([3, 17, 400])[np.arange(5000) % 3]
    st[pos], fo[pos], fc[pos], al[pos] = st[src], fo[src], fc[src], True
    out.append(("large-copies", (st, fo, fc, al)))
    return [(tag, tuple(torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
                        for a in t)) for tag, t in out]


def check_fused_table(tag, wk, st, fo, fc, al, C, n_parents, m, window=4,
                      timed=True) -> dict:
    """Both kernels against their plain versions on one table (tolerance
    0); when ``timed``, each timed beside its plain version and its
    bound, and the fused update's tail (``wk_fused_tail`` after one
    ``wk_keep_mask``) timed apart from it.  Returns the measurements."""
    import torch

    lanes, n = st.shape
    G = fc.shape[2]
    keep_k = wk.keep_mask(st, fo, fc, al, window)
    keep_r = wk.keep_mask_ref(st, fo, fc, al, window)
    torch.cuda.synchronize()
    err_keep = _max_abs_err(keep_k, keep_r)
    fused_k = wk.fused_frontier_update(st, fo, fc, al, None, C, window,
                                       n_parents=n_parents, max_count=m)
    fused_r = wk.fused_frontier_update_ref(st, fo, fc, al, C, window,
                                           n_parents, m)
    torch.cuda.synchronize()
    err_fused = _max_abs_err(fused_k, fused_r)
    keep_l, _ovf, chunks = wk._launch_keep(st, fo, fc, al, window, True)
    m_k = min(m, wk.hashing.MXU_PRUNE_MAX_COUNT)
    tail_k = wk._launch_tail(st, fo, fc, keep_l, chunks, C, n_parents, m_k)
    torch.cuda.synchronize()
    err_tail = _max_abs_err(tail_k, fused_r)
    alive_rows = int(fused_r[3].sum())
    ovf = int(fused_r[4].sum())
    print(f"kernels[{tag}]: lanes={lanes} n={n} C={C} G={G} "
          f"keep max_abs_err={err_keep} fused max_abs_err={err_fused} "
          f"tail max_abs_err={err_tail} (tolerance 0; alive out rows "
          f"{alive_rows}, overflowed lanes {ovf})", flush=True)
    if err_keep != 0 or err_fused != 0 or err_tail != 0:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version")
    if not timed:
        return {}
    keep_ms = _time_ms(lambda: wk.keep_mask(st, fo, fc, al, window), 20)
    keep_plain = _time_ms(lambda: wk.keep_mask_ref(st, fo, fc, al, window), 3, 1)
    fused_ms = _time_ms(lambda: wk.fused_frontier_update(
        st, fo, fc, al, None, C, window, n_parents=n_parents, max_count=m), 20)
    fused_plain = _time_ms(lambda: wk.fused_frontier_update_ref(
        st, fo, fc, al, C, window, n_parents, m), 2, 1)
    def tail():
        return wk._launch_tail(st, fo, fc, keep_l, chunks, C, n_parents, m_k)

    tail_ms = _time_ms(tail, 20)
    keep_dev = _device_ms(lambda: wk.keep_mask(st, fo, fc, al, window))
    fused_dev = _device_ms(lambda: wk.fused_frontier_update(
        st, fo, fc, al, None, C, window, n_parents=n_parents, max_count=m))
    tail_dev = _device_ms(tail)
    kb, kbb = _bound_ms(*_work(st, fo, fc, al, C, "keep"))
    fb, fbb = _bound_ms(*_work(st, fo, fc, al, C, "fused"))
    tb, tbb = _bound_ms(*_work(st, fo, fc, al, C, "tail"))
    print(f"timing[{tag}]: keep_mask {keep_ms:.4f} ms per call, "
          f"{keep_dev:.4f} ms on the card (plain {keep_plain:.4f} ms, bound "
          f"{kb:.4f} ms by {kbb}); fused_frontier_update {fused_ms:.4f} ms "
          f"per call, {fused_dev:.4f} ms on the card (plain "
          f"{fused_plain:.4f} ms, bound {fb:.4f} ms by {fbb}); fused tail "
          f"{tail_ms:.4f} ms per call, {tail_dev:.4f} ms on the card (bound "
          f"{tb:.4f} ms by {tbb})", flush=True)
    keep_line, keep_us = _kernel_us(lambda: wk.keep_mask(st, fo, fc, al, window))
    print(f"keep_kernels[{tag}]: us per call {keep_line}", flush=True)
    print(f"tail_kernels[{tag}]: us per call {_kernel_us(tail)[0]}", flush=True)
    # the sort stage against one stable PyTorch sort of the same keys
    key = _bucket_keys(st, fo, fc, al)
    sort_ms = _time_ms(lambda: torch.sort(key, dim=-1, stable=True), 20)
    sort_dev = _device_ms(lambda: torch.sort(key, dim=-1, stable=True))
    stage_us = sum(us for name, us in keep_us.items()
                   if name.startswith(SORT_KERNELS))
    print(f"sort_stage[{tag}]: sort passes {stage_us:.2f} us on the card; "
          f"torch.sort(stable=True) of the [{lanes}, {n}] bucket keys "
          f"{sort_ms:.4f} ms per call, {sort_dev:.4f} ms on the card", flush=True)
    return {
        "keep_mask": dict(max_abs_err=err_keep, ms=keep_ms, device_ms=keep_dev,
                          plain_ms=keep_plain, bound_ms=kb, bound_by=kbb,
                          sort_stage_ms=stage_us / 1e3,
                          sort_library_ms=sort_dev),
        "fused_frontier_update": dict(max_abs_err=max(err_keep, err_fused),
                                      ms=fused_ms, device_ms=fused_dev,
                                      plain_ms=fused_plain, bound_ms=fb,
                                      bound_by=fbb),
        "fused_tail": dict(max_abs_err=err_tail, ms=tail_ms,
                           device_ms=tail_dev, bound_ms=tb, bound_by=tbb),
    }


def check_exchange(dev, wk, mesh_mod) -> dict:
    """Phase 3a: the exchange kernel against its plain version; returns
    the G = 32 rescue-shape measurements."""
    import torch

    shapes = [("small", 3, 7, 5), ("rescue-G16", MESH_SHARDS, 19200, 20),
              ("rescue-G32", MESH_SHARDS, 31488, 36)]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for tag, D, rcap, nc in shapes:
        mesh = mesh_mod.make_mesh(D)
        send = torch.randint(-2**31, 2**31 - 1, (D, D, rcap, nc),
                             dtype=torch.int32, device=dev, generator=gen)
        got = wk.mesh_exchange(mesh, send)
        ref = wk.mesh_exchange_ref(send)
        # the library yardstick: one advanced-index gather by (source, slot)
        slot = torch.arange(D, device=dev)
        src = (slot[:, None] - slot[None, :]) % D
        lib = send[src, slot[None, :]]
        torch.cuda.synchronize()
        err = _max_abs_err((got,), (ref,))
        print(f"exchange[{tag}]: D={D} rcap={rcap} NC={nc} max_abs_err={err} "
              f"(tolerance 0; library gather max_abs_err "
              f"{_max_abs_err((lib,), (ref,))})", flush=True)
        if err != 0 or not torch.equal(lib, ref):
            raise AssertionError(f"{tag}: exchange disagrees with its plain version")
        if tag == "small":
            continue
        ms = _time_ms(lambda: wk.mesh_exchange(mesh, send), 50)
        plain = _time_ms(lambda: wk.mesh_exchange_ref(send), 20)
        lib_ms = _time_ms(lambda: send[src, slot[None, :]], 50)
        dev_ms = _device_ms(lambda: wk.mesh_exchange(mesh, send), 50)
        lib_dev = _device_ms(lambda: send[src, slot[None, :]], 50)
        bound, by = _bound_ms(2 * send.numel() * 4, 0)
        print(f"timing[{tag}]: mesh_exchange {ms:.4f} ms per call, "
              f"{dev_ms:.4f} ms on the card (plain {plain:.4f} ms, library "
              f"gather {lib_ms:.4f} ms per call, {lib_dev:.4f} ms on the "
              f"card, bound {bound:.4f} ms by {by}: {2 * send.numel() * 4} "
              f"bytes)", flush=True)
        out[tag] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                        plain_ms=plain, library_ms=lib_ms, bound_ms=bound,
                        bound_by=by)
    return out["rescue-G32"]


def check_fused_child(dev, wk) -> None:
    """Phase 3b: the fused update with an explicit child column against
    its plain version on the received-table shape of the G = 32 rescue
    (4 lanes of 125,952 rows, capacity 2048)."""
    import torch

    C, P, G = 2048, 8, 32
    st, fo, fc, al = _tables(3072, P, G, MESH_SHARDS, dev)  # 3072*41 rows
    gen = torch.Generator(device=dev).manual_seed(1)
    child = torch.rand(st.shape, device=dev, generator=gen) < 0.5
    got = wk.fused_frontier_update(st, fo, fc, al, None, C, max_count=P + 1,
                                   child=child)
    ref = wk.fused_frontier_update_ref(st, fo, fc, al, C, 4, None, P + 1,
                                       child=child)
    torch.cuda.synchronize()
    err = _max_abs_err(got, ref)
    ms = _time_ms(lambda: wk.fused_frontier_update(
        st, fo, fc, al, None, C, max_count=P + 1, child=child), 10)
    print(f"fused_child[received-G32]: lanes={st.shape[0]} n={st.shape[1]} "
          f"C={C} max_abs_err={err} (tolerance 0; alive out rows "
          f"{int(ref[3].sum())}, child out rows {int(ref[6].sum())}); "
          f"{ms:.4f} ms", flush=True)
    if err != 0:
        raise AssertionError("fused update with child= disagrees with its "
                             "plain version")


def entry_times(dev, wk, mesh_mod) -> dict:
    """``--entry-times``: the public entry points of the imported port
    package (``keep_mask``, ``fused_frontier_update``, ``mesh_exchange``)
    at the bench shapes, per call (``_time_ms``) and on the card alone
    (``_device_ms``; null where a graph cannot capture the call), and the
    keep mask's kernels' device µs, for a side-by-side run of two commits
    in one call on one card."""
    import torch

    out = {"module": wk.__file__}
    for tag, make, G in (("bench-G16", _tables, 16), ("bench-G32", _tables, 32),
                         ("class-heavy", _class_heavy, 32),
                         ("copy-heavy", _copy_heavy, 32)):
        st, fo, fc, al = make(2048, 8, G, 8, dev)

        def fused():
            return wk.fused_frontier_update(st, fo, fc, al, None, 2048,
                                            n_parents=2048, max_count=9)

        def keep():
            return wk.keep_mask(st, fo, fc, al)

        out[tag] = {"keep_ms": _time_ms(keep, 20), "keep_device_ms": _device_ms(keep),
                    "fused_ms": _time_ms(fused, 20),
                    "fused_device_ms": _device_ms(fused),
                    "keep_kernels_us": _kernel_us(keep)[1]}
    for tag, rcap, nc in (("rescue-G16", 19200, 20), ("rescue-G32", 31488, 36)):
        mesh = mesh_mod.make_mesh(MESH_SHARDS)
        send = torch.randint(-2**31, 2**31 - 1, (MESH_SHARDS, MESH_SHARDS, rcap, nc),
                             dtype=torch.int32, device=dev)

        def exchange():
            return wk.mesh_exchange(mesh, send)

        try:
            dev_ms = _device_ms(exchange, 50)
        except RuntimeError:
            dev_ms = None
        out[tag] = {"exchange_ms": _time_ms(exchange, 50),
                    "exchange_device_ms": dev_ms}
    return out


def _pool_table(n: int, P: int, G: int, pool: int, seed: int, dev):
    """An [n]-row candidate table drawn from ``pool`` distinct rows (80 %
    alive): few enough contents that neither path overflows, so the
    cross-path contract compares survivors, not just flags."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    st = rng.integers(0, 64, pool).astype(np.int32)
    fo = rng.integers(0, 1 << 16, (pool, (P + 31) // 32)).astype(np.int32)
    fc = rng.integers(0, 4, (pool, G)).astype(np.int16)
    pick = rng.integers(0, pool, n)
    alive = rng.random(n) < 0.8
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (st[pick], fo[pick], fc[pick], alive))


def check_cross_path(dev, wk, mesh_mod, sharded) -> float:
    """Phase 4: ``mesh_update`` on 4 shards against the single-shard
    fused update at the same global capacity on the same table; returns
    the mesh stage's ms per call."""
    import torch

    C, P, G = 8192, 8, 32
    n = C * (1 + P + G)
    st, fo, fc, al = _pool_table(n, P, G, 1500, 7, dev)
    mesh = mesh_mod.make_mesh(MESH_SHARDS)
    got = sharded.mesh_update(mesh, st, fo, fc, al, None, C, n_parents=C,
                              max_count=P + 1)
    one = wk.fused_frontier_update(st, fo, fc, al, None, C, n_parents=C,
                                   max_count=P + 1)
    torch.cuda.synchronize()

    def content(state, fok, fcr, alive, child):
        keys = torch.cat([state.reshape(-1, 1), fok.reshape(state.numel(), -1),
                          fcr.reshape(state.numel(), -1).to(torch.int32),
                          child.reshape(-1, 1).to(torch.int32)], 1)
        return torch.unique(keys[alive.reshape(-1)], dim=0)

    a = content(*got[:4], got[6])
    b = content(*one[:4], one[6])
    same = a.shape == b.shape and torch.equal(a, b)
    fp_same = torch.equal(got[5], one[5])
    ms = _time_ms(lambda: sharded.mesh_update(
        mesh, st, fo, fc, al, None, C, n_parents=C, max_count=P + 1), 5)
    print(f"cross_path[rescue-G32]: n={n} C={C} shards={MESH_SHARDS}: "
          f"alive rows {a.shape[0]} vs {b.shape[0]}, content with child "
          f"bits equal {same}, overflow {bool(got[4])} vs {bool(one[4])}, "
          f"fp {got[5].tolist()} vs {one[5].tolist()}; mesh_update "
          f"{ms:.4f} ms", flush=True)
    if not same or not fp_same or bool(got[4]) != bool(one[4]) or bool(got[4]):
        raise AssertionError("mesh and single-shard paths disagree")
    return ms


def run_mesh_ladder(batch, wk, mesh_mod, model, hists, plain_results):
    """Phase 7: the bench ladder with the mesh rescue on 4 logical
    shards; returns the launch counts and the results of that run."""
    stats: dict = {}
    wk.reset_counts()
    t0 = time.perf_counter()
    results = batch.batch_analysis(
        model, hists, capacity=CAPS, exact_escalation=(), cpu_fallback=False,
        dedup_backend="fused", device="cuda", stats=stats,
        mesh=mesh_mod.make_mesh(MESH_SHARDS),
    )
    seconds = time.perf_counter() - t0
    counts = _launch_counts(wk)
    rescue = stats.get("mesh_rescue")
    print(f"mesh_ladder: {seconds:.3f} s, launches {counts}", flush=True)
    print("mesh_rescue: " + json.dumps(
        {**(rescue or {}), "exchange_launches": counts["mesh_exchange"]}),
        flush=True)
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} was not launched on the mesh path")
    took = [i for i, r in enumerate(plain_results) if r["valid?"] == "unknown"]
    if rescue is None or rescue["lanes"] != len(took):
        raise AssertionError(f"the rescue took {rescue} lanes; the ladder "
                             f"left {len(took)} unknown")
    moved = [i for i, (a, b) in enumerate(zip(plain_results, results))
             if i not in took and a["valid?"] != b["valid?"]]
    if moved:
        raise AssertionError(f"verdicts off the rescue changed: {moved}")
    pool = batch.confirm_pool()
    futs = [pool.submit(batch._confirm_worker.sweep, model, hists[i],
                        RESCUE_MAX_CONFIGS) for i in took]
    cpu = [f.result() for f in futs]
    verdicts = [(i, results[i]["valid?"], c["valid?"]) for i, c in zip(took, cpu)]
    disagree = sum(1 for _i, d, c in verdicts
                   if "unknown" not in (d, c) and d != c)
    print(f"mesh_verdicts: rescued lanes [history, mesh ladder, exact sweep] "
          f"{json.dumps(verdicts)}: {disagree} disagreements", flush=True)
    if disagree:
        raise AssertionError(f"{disagree} rescued verdict disagreements")
    # What one card can show: the same lanes on a single-shard rung at
    # the rescue's total capacity and at twice it, from barrier 0.
    for cap in (CAPS[-1] * MESH_SHARDS, 2 * CAPS[-1] * MESH_SHARDS):
        t0 = time.perf_counter()
        single = batch.batch_analysis(
            model, [hists[i] for i in took], capacity=(cap,),
            greedy_first=False, carry_frontier=False, cpu_fallback=False,
            confirm_refutations=False, dedup_backend="fused", device="cuda")
        print(f"single_shard[{cap}]: rescued lanes {took} -> "
              f"{json.dumps([r['valid?'] for r in single])} in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    return counts, results


def check_mesh_engine(batch, sharded, mesh_mod, model, hists, plain_results):
    """Phase 7b: the mesh engine alone at the rescue capacity on the
    first histories the greedy walk left to the frontier rungs, against
    the exact sweep; at least one verdict must be decided, so that the
    check holds decided mesh verdicts to the sweep."""
    hard = [i for i, r in enumerate(plain_results)
            if (r.get("kernel") or {}).get("capacity", 0) >= CAPS[0]][:MESH_ENGINE_LANES]
    mesh = mesh_mod.make_mesh(MESH_SHARDS)
    pool = batch.confirm_pool()
    futs = [pool.submit(batch._confirm_worker.sweep, model, hists[i],
                        CPU_MAX_CONFIGS) for i in hard]
    t0 = time.perf_counter()
    got = [sharded.mesh_kernel_analysis(model, hists[i], mesh,
                                        capacity=(CAPS[-1] * MESH_SHARDS,))
           for i in hard]
    seconds = time.perf_counter() - t0
    cpu = [f.result() for f in futs]
    rows = [(i, g["valid?"], c["valid?"]) for i, g, c in zip(hard, got, cpu)]
    decided = sum(1 for _i, g, c in rows if "unknown" not in (g, c))
    disagree = sum(1 for _i, g, c in rows if "unknown" not in (g, c) and g != c)
    print(f"mesh_engine: {len(hard)} lanes at {CAPS[-1] * MESH_SHARDS} rows "
          f"on {MESH_SHARDS} shards in {seconds:.3f} s, [history, mesh, exact "
          f"sweep] {json.dumps(rows)}: {decided} decided by both, "
          f"{disagree} disagreements", flush=True)
    if disagree or not decided:
        raise AssertionError(f"mesh engine: {disagree} disagreements, "
                             f"{decided} decided")


def _single(wgl, wk, model, hist, tag, B, **kw) -> dict:
    """One ``wgl.analysis`` run on the card, printed with its seconds,
    chunks, chunk scans, host syncs per barrier and kernel launches."""
    import torch

    s0, k0, f0 = wgl.SCAN_SYNCS, wk.KEEP_LAUNCHES, wk.FUSED_LAUNCHES
    t0 = time.perf_counter()
    res = wgl.analysis(model, hist, device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k = res.get("kernel") or {}
    syncs = wgl.SCAN_SYNCS - s0
    row = {"valid": res["valid?"], "seconds": seconds,
           "chunks": k.get("chunks"), "chunk_scans": k.get("launches"),
           "capacity": k.get("capacity"), "frontier_peak": k.get("frontier-peak"),
           "lossy": k.get("lossy?"), "spill_rows": k.get("spill-rows"),
           "verified_barriers": k.get("verified-barriers"),
           "host_syncs": syncs, "syncs_per_barrier": syncs / max(1, B),
           "keep_launches": wk.KEEP_LAUNCHES - k0,
           "fused_launches": wk.FUSED_LAUNCHES - f0,
           "op_index": (res.get("op") or {}).get("index")}
    print(f"single[{tag}]: " + json.dumps(row), flush=True)
    return res


def _dense_kills(state, fok, fcr, alive, chunk_rows: int):
    """A yardstick the port does not call: ``dominate``'s kill mask with
    the counts compared over every pair of a chunk ([L, f, chunk, G]),
    not only over the pairs of one (state, fok) class."""
    import torch

    L, f = state.shape
    killed = torch.zeros(L, f, dtype=torch.bool, device=state.device)
    for lo in range(0, f, chunk_rows):
        hi = min(f, lo + chunk_rows)
        same = ((state[:, :, None] == state[:, None, lo:hi])
                & (fok[:, :, None, :] == fok[:, None, lo:hi, :]).all(-1)
                & alive[:, :, None] & alive[:, None, lo:hi])
        le = (fcr[:, :, None, :] <= fcr[:, None, lo:hi, :]).all(-1)
        lt = (fcr[:, :, None, :] < fcr[:, None, lo:hi, :]).any(-1)
        killed[:, lo:hi] = (same & le & lt).any(1)
    return killed


def check_pairwise(dev) -> None:
    """The exact update's domination prune (``hashing.dominate``: class
    compares over every pair of a chunk, count compares over the pairs
    of one class) at the exact stages' buffer shapes (2C = 4096 and
    8192 rows of G = 32, one and eight lanes, probe and class-heavy
    rows), held against the dense yardstick (identical masks) and timed
    beside it with CUDA events."""
    from jepsen_tpu_torch.ops import hashing

    for f in (4096, 8192):
        for lanes in (1, 8):
            for kind, make in (("probe", _tables), ("class-heavy", _class_heavy)):
                st, fo, fc, al = (t[:, :f].contiguous()
                                  for t in make(f // 2, 32, 32, lanes, dev))
                chunk = hashing._pairwise_chunk(f, 32, lanes, 1 << 26)
                got = hashing.dominate(st, fo, fc, al)
                want = al & ~_dense_kills(st, fo, fc, al, chunk)
                equal = bool((got == want).all())
                ms = _time_ms(lambda: hashing.dominate(st, fo, fc, al), 3, 1)
                dense = _time_ms(lambda: _dense_kills(st, fo, fc, al, chunk),
                                 3, 1)
                print(f"pairwise[f={f},lanes={lanes},{kind}]: dominate "
                      f"{ms:.3f} ms per call, dense yardstick {dense:.3f} ms "
                      f"(alive {int(al.sum())}, equal masks {equal})",
                      flush=True)
                if not equal:
                    raise AssertionError("dominate differs from the dense "
                                         "compare")


def _growth_and_exact_cost(wgl, model, hist, bad) -> None:
    """Phase 8's two measurements of the engines on config 2: the
    frontier after each of the first GROWTH_STEPS ranges of 16 barriers
    (``scan_barrier_range``, fast, 4096-row slices, spill on: an exact
    union as long as no closure outgrows a slice), and the exact
    engine's seconds per barrier at 4096 rows over EXACT_COST_BARRIERS
    barriers of the corrupted copy."""
    import numpy as np
    import torch

    p = wgl.pad_packed(wgl.pack(model, hist), B=wgl.pack(model, hist)["B"])
    f = (np.array([p["init_state"]], np.int32),
         np.zeros((1, p["W"]), np.int32), np.zeros((1, p["G"]), np.int16))
    rows = []
    for k in range(GROWTH_STEPS):
        r = wgl.scan_barrier_range(p, f, 16 * k, 16 * (k + 1),
                                   capacities=(SINGLE_CAPS[-1],),
                                   chunk_barriers=16, fast=True, spill=True,
                                   device="cuda")
        f = r["frontier"]
        rows.append([16 * (k + 1), int(f[0].shape[0]), r["peak"], r["lossy"]])
        if r["lossy"] or r["failed_barrier"] is not None:
            break
    print(f"single[growth]: [barriers, frontier rows, peak, lost rows] "
          f"{json.dumps(rows)}", flush=True)
    p = wgl.pad_packed(wgl.pack(model, bad), B=wgl.pack(model, bad)["B"])
    f = (np.array([p["init_state"]], np.int32),
         np.zeros((1, p["W"]), np.int32), np.zeros((1, p["G"]), np.int16))
    for fast in (True, False):
        t0 = time.perf_counter()
        r = wgl.scan_barrier_range(p, f, 0, EXACT_COST_BARRIERS,
                                   capacities=(SINGLE_CAPS[-1],),
                                   fast=fast, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"single[cost]: {'fast' if fast else 'exact'} engine at "
              f"{SINGLE_CAPS[-1]} rows, {EXACT_COST_BARRIERS} barriers in "
              f"{dt:.3f} s ({dt / EXACT_COST_BARRIERS:.4f} s a barrier), "
              f"peak {r['peak']}, lost rows {r['lossy']}", flush=True)


def run_single_history(batch, wk, wgl, sharded, mesh_mod, genhist, model,
                       hists, ladder_results, cpu_sample) -> tuple:
    """Phase 8: the single-history path on the card (see the module
    docstring); returns the kernels' launch counts of the phase and the
    measurements of its captured fused calls at each capacity."""
    import torch

    hist = genhist.valid_register_history(SINGLE_OPS, SINGLE_PROCS, seed=0,
                                          info_rate=SINGLE_INFO)
    bad = genhist.corrupt(hist, seed=0)
    h2 = genhist.valid_register_history(SPILL_OPS, SINGLE_PROCS, seed=1,
                                        info_rate=SINGLE_INFO)
    packed = wgl.pack(model, hist)
    B = packed["B"]
    B2 = wgl.pack(model, h2)["B"]
    print(f"single: {SINGLE_OPS}-op history, {SINGLE_PROCS} processes: "
          f"B={B} P={packed['P']} G={packed['G']} W={packed['W']}; "
          f"{SPILL_OPS}-op history: B={B2}", flush=True)
    capture = _Capture(wk)
    wk.reset_counts()
    t_phase = time.perf_counter()
    # (a) the greedy walk (a witness), then the fast engine under
    # "fused", which may lose rows on this history (its closures outgrow
    # 4096 rows), never refute it
    t0 = time.perf_counter()
    g = wgl.greedy_analysis(model, hist, device="cuda")
    print(f"single[valid-greedy]: {g['valid?']} in "
          f"{time.perf_counter() - t0:.3f} s, {json.dumps(g.get('kernel'))}",
          flush=True)
    if g["valid?"] is not True:
        raise AssertionError(f"the greedy walk answered {g['valid?']}")
    r = _single(wgl, wk, model, hist, "valid-fast-fused", B, fast=True,
                capacity=SINGLE_CAPS, dedup_backend="fused")
    if r["valid?"] is False:
        raise AssertionError("the valid history was refuted")
    # a history the frontier engines decide: True, and unchanged by
    # spill (without a budget, an overflowing chunk slices and bisects)
    # (spill=False keeps a copy of its fused calls' inputs, one per
    # rung, to hold the kernels at this path's shapes below)
    decided = {}
    for tag, kw in (("decided-valid", dict(spill=False)),
                    ("decided-valid-spill", dict(spill=True))):
        if tag == "decided-valid":
            wk.fused_frontier_update = capture
        try:
            r = _single(wgl, wk, model, h2, tag, B2, capacity=SPILL_CAPS,
                        fast=True, **kw)
        finally:
            wk.fused_frontier_update = capture.fn
        decided[tag] = r["valid?"]
    # the same history on the fast engine's default ladder: it climbs
    # from 128 rows (below the fused floor) through 1024 to 4096
    f0 = wk.FUSED_LAUNCHES
    r = _single(wgl, wk, model, h2, "decided-valid-default-ladder", B2,
                fast=True)
    decided["decided-valid-default-ladder"] = r["valid?"]
    climbed = ((r.get("kernel") or {}).get("capacity"), wk.FUSED_LAUNCHES - f0)
    if set(decided.values()) != {True}:
        raise AssertionError(f"the decided history gave {decided}")
    if climbed[0] != SINGLE_DEFAULT_LADDER[-1] or climbed[1] <= 0:
        raise AssertionError(f"the default ladder ended at {climbed[0]} rows "
                             f"with {climbed[1]} fused launches")
    # why config 2 stays undecided: the exact union of the fast
    # engine's survivors over its first barriers, in 4096-row slices
    _growth_and_exact_cost(wgl, model, hist, bad)
    # (b) the corrupted copy, fast then exact, against the sweep
    fast = _single(wgl, wk, model, bad, "corrupt-fast-fused", B,
                   capacity=SINGLE_CAPS, fast=True, dedup_backend="fused")
    # the sweep of the prefix up to the fast engine's failing op (the
    # whole history if it found none) runs in a worker meanwhile
    sweep_fut = batch.confirm_pool().submit(
        batch._confirm_worker.confirm_refutation, model, bad,
        SINGLE_SWEEP_CONFIGS, (fast.get("kernel") or {}).get("bar-opid"))
    exact = _single(wgl, wk, model, bad, "corrupt-exact", B,
                    capacity=EXACT_SINGLE_CAPS, fast=False)
    sweep = sweep_fut.result()
    print(f"single[corrupt]: fast {fast['valid?']}, exact "
          f"{exact['valid?']}, exact sweep {sweep['valid?']} (budget "
          f"{SINGLE_SWEEP_CONFIGS} configurations)", flush=True)
    _agree("corrupt", fast, exact, sweep)
    # corrupted bench histories that both engines refute, at the same op,
    # as the exact sweep of phase 6 does (a 32-process history's first
    # closure outgrows even 16,384 rows, so no frontier engine refutes
    # one: PERF.md)
    for i in DECIDED_BENCH:
        Bi = wgl.pack(model, hists[i])["B"]
        f = _single(wgl, wk, model, hists[i], f"decided-corrupt-{i}-fast", Bi,
                    capacity=SINGLE_CAPS, fast=True)
        e = _single(wgl, wk, model, hists[i], f"decided-corrupt-{i}-exact", Bi,
                    capacity=SINGLE_CAPS, fast=False)
        _agree(f"decided-corrupt-{i}", f, e, cpu_sample[i])
        if (f["valid?"], e["valid?"], cpu_sample[i]["valid?"]) != (False,) * 3:
            raise AssertionError(f"bench history {i} was not refuted by "
                                 "both engines and the sweep")
    # (c) spill under a frontier budget that leaves the rungs 1024 and
    # 2048 usable, so that the frontier outgrows the device and spills:
    # the verdict of spill=False on the whole ladder
    on = _single(wgl, wk, model, h2, "spill-budget", B2, capacity=SPILL_CAPS,
                 fast=True, frontier_budget_mb=SPILL_BUDGET_MB)
    if on["kernel"]["spill-rows"] <= 0:
        raise AssertionError("the budgeted run did not spill")
    if on["valid?"] != decided["decided-valid"]:
        raise AssertionError(f"the budgeted spilled run gave {on['valid?']}, "
                             f"spill=False {decided['decided-valid']}")
    # (d) the sync engine and the exact stage on the bench histories
    stats: dict = {}
    t0 = time.perf_counter()
    sync = batch.batch_analysis(
        model, hists[:SYNC_LANES], capacity=CAPS, engine="sync",
        exact_escalation=EXACT_CAPS, cpu_fallback=False,
        dedup_backend="fused", device="cuda", stats=stats)
    seconds = time.perf_counter() - t0
    rows = [[i, s["valid?"], ladder_results[i]["valid?"],
             cpu_sample[i]["valid?"] if i < len(cpu_sample) else None]
            for i, s in enumerate(sync)]
    disagree = [r for r in rows
                if any(a is not None and "unknown" not in (r[1], a)
                       and r[1] != a for a in r[2:])]
    for rung in stats["rungs"]:
        print("single[sync-rung]: " + json.dumps(rung), flush=True)
    print(f"single[sync-exact]: {SYNC_LANES} bench histories in "
          f"{seconds:.3f} s, unknowns "
          f"{sum(1 for s in sync if s['valid?'] == 'unknown')}, "
          f"[history, sync+exact, phase-5 ladder, sweep] disagreeing "
          f"{json.dumps(disagree)}", flush=True)
    if disagree:
        raise AssertionError(f"{len(disagree)} sync/exact disagreements")
    # (e) the mesh fallback on one shard, on a history the frontier
    # rungs decided, held against the exact sweep (the fallback is
    # wgl.analysis itself, so its equality with wgl.analysis is its
    # routing, not a check of the engine)
    k = next(i for i, r in enumerate(ladder_results)
             if (r.get("kernel") or {}).get("capacity", 0) >= CAPS[0]
             and i < len(cpu_sample) and cpu_sample[i]["valid?"] != "unknown")
    mesh_res = sharded.mesh_kernel_analysis(model, hists[k], mesh_mod.make_mesh(1),
                                            capacity=(CAPS[-1],))
    chunked = wgl.analysis(model, hists[k], capacity=(CAPS[-1],), fast=True,
                           dedup_backend="fused", device="cuda")
    print(f"single[mesh-fallback]: history {k} on make_mesh(1): "
          f"{mesh_res['valid?']}, exact sweep {cpu_sample[k]['valid?']}, "
          f"equal to wgl.analysis(fast=True) {mesh_res == chunked}", flush=True)
    if mesh_res != chunked or mesh_res["valid?"] != cpu_sample[k]["valid?"]:
        raise AssertionError("the mesh fallback differs from wgl.analysis "
                             "or from the exact sweep")
    counts = _launch_counts(wk)
    print(f"single: phase {time.perf_counter() - t_phase:.3f} s, launches "
          f"{counts}", flush=True)
    for name in ("keep_mask", "fused_frontier_update"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the "
                                 "single-history path")
    # the kernels at this path's own shapes (one lane, P = G = 32): its
    # captured fused calls at each rung, held against the plain versions
    # (after the counts are read: comparisons are not the path's launches)
    check_pairwise(torch.device("cuda"))
    measured = {}
    for cap in SPILL_CAPS:
        if cap not in capture.calls:
            raise AssertionError(f"no fused update call at {cap} rows")
        measured[cap] = check_captured(wk, capture, f"single-{cap}", cap)
    return counts, measured


def _agree(tag, fast, exact, sweep) -> None:
    """The exact engine's verdict (and failing op, when False) equals
    the fast engine's, and the sweep's wherever the sweep decides."""
    if exact["valid?"] != fast["valid?"] or (
            exact["valid?"] is False
            and exact["op"]["index"] != fast["op"]["index"]):
        raise AssertionError(f"{tag}: the exact and fast verdicts disagree")
    if sweep["valid?"] != "unknown" and (
            sweep["valid?"] != exact["valid?"]
            or (exact["valid?"] is False
                and sweep["op"]["index"] != exact["op"]["index"])):
        raise AssertionError(f"{tag}: the exact verdict or failing op "
                             "disagrees with the sweep")


def _keyed(independent, hists, keys) -> list[dict]:
    """One history of the bench histories of ``keys``, key by key, each
    value wrapped with ``independent.tuple_`` (as
    tests/test_parallel.py builds its 4-key history)."""
    out = []
    t = 0
    for k in keys:
        for o in hists[k]:
            t += 1
            out.append({**o, "value": independent.tuple_(k, o["value"]),
                        "time": t})
    return [{**o, "index": i} for i, o in enumerate(out)]


def _errors(x, where: str = "") -> list[str]:
    """Where a result tree holds an ``error`` (a swallowed exception)."""
    out = []
    if isinstance(x, dict):
        if x.get("error") is not None:
            out.append(where or "/")
        for k, v in x.items():
            out += _errors(v, f"{where}/{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            out += _errors(v, f"{where}/{i}")
    return out


def _op_index(res) -> int | None:
    return (res.get("op") or {}).get("index")


def _pool_worker_init() -> None:
    """Phase 9's spawned processes share the host's cores: one torch
    thread each."""
    import torch

    torch.set_num_threads(1)


def _competition_check(hist) -> tuple[dict, dict, float]:
    """Phase 9(c)'s task in a spawned process: ``check_safe`` of the
    "competition" checker on one history, on the card, with the launch
    counts and the seconds of that check."""
    from jepsen_tpu_torch import checker
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.ops import wide_kernel as wk

    wk.reset_counts()
    t0 = time.perf_counter()
    r = checker.check_safe(lin.linearizable(
        {"model": "cas-register", "algorithm": "competition"}), {}, hist)
    return r, _launch_counts(wk), time.perf_counter() - t0


def _default_stream(hist) -> tuple[dict, str | None, dict]:
    """Phase 9(e)'s task in a spawned process: ``stream_check`` of one
    history at the streaming checker's default capacity, on the card,
    with the stream's parity digest and the launch counts of the
    stream."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.checker import streaming
    from jepsen_tpu_torch.ops import wide_kernel as wk

    wk.reset_counts()
    rs, sc = streaming.stream_check(m.CASRegister(None), hist,
                                    feed_ops=STREAM_FEED_OPS)
    bundle = sc.evidence()
    return (rs, None if bundle is None else streaming.parity_digest(bundle),
            _launch_counts(wk))


def run_checkers(batch, wk, mesh_mod, genhist, model, hists, ladder_results,
                 cpu_sample) -> dict:
    """Phase 9: the checker front end on the card (see the module
    docstring); returns the keep mask's, the fused update's and the
    exchange's launch counts of each sub-phase."""
    from jepsen_tpu_torch import checker, independent
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.checker import streaming
    from jepsen_tpu_torch.obs import provenance

    def no_errors(tag, res) -> None:
        errs = _errors(res)
        if errs:
            raise AssertionError(f"checkers[{tag}]: errors at {errs[:5]}")

    class CountingLinearizable(lin.Linearizable):
        """Counts the check_batch calls and the ones that returned."""

        def __init__(self, opts):
            super().__init__(opts)
            self.calls = self.returned = 0

        def check_batch(self, test, histories, opts):
            self.calls += 1
            out = super().check_batch(test, histories, opts)
            self.returned += 1
            return out

    launches: dict = {}
    seconds: dict = {}
    undecided = [k for k, r in enumerate(ladder_results)
                 if r["valid?"] == "unknown"]
    pool = batch.confirm_pool()
    sweeps = {k: pool.submit(batch._confirm_worker.sweep, model, hists[k],
                             RESCUE_MAX_CONFIGS) for k in undecided}
    t_phase = time.perf_counter()

    # (c) and the default-capacity streams of (e) run in CHECKER_WORKERS
    # spawned processes, each on the card, side by side with (a), (b),
    # (d) and the fast streams in this process: their host work is
    # Python (the CPU DFS the competition reaches on some histories takes
    # 5,000,000 nodes, ~100 s each; an exact stream is host-bound)
    ex = ProcessPoolExecutor(max_workers=CHECKER_WORKERS,
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_pool_worker_init)
    try:
        comp_futs = [ex.submit(_competition_check, hh)
                     for hh in hists[:CHECKER_HISTORIES]]
        stream_futs = [ex.submit(_default_stream, hh)
                       for hh in hists[:CHECKER_HISTORIES]]

        # (a) the batch path: every bench history as one key of one
        # history, through independent.checker and the competition's
        # check_batch
        keyed = _keyed(independent, hists, range(N_HISTORIES))
        chk = CountingLinearizable({"model": "cas-register",
                                    "algorithm": "competition",
                                    "kernel-opts": {"capacity": CAPS}})
        wk.reset_counts()
        t0 = time.perf_counter()
        res = checker.check_safe(independent.checker(chk), {}, keyed)
        seconds["a"] = time.perf_counter() - t0
        launches["a"] = _launch_counts(wk)
        no_errors("a", res)
        if (chk.calls, chk.returned) != (1, 1):
            raise AssertionError(f"check_batch called {chk.calls} times, "
                                 f"returned {chk.returned} times (expected "
                                 "once)")
        sweep = {k: f.result() for k, f in sweeps.items()}
        wrong = []
        rows = [[k, res["results"][k]["valid?"], sweep[k]["valid?"]]
                for k in undecided]
        for k in range(N_HISTORIES):
            got = res["results"][k]["valid?"]
            want = ladder_results[k]["valid?"]
            if want == "unknown":
                want = sweep[k]["valid?"]
                if got != "unknown" and want != "unknown" and got != want:
                    wrong.append([k, got, want])
            elif got != want:
                wrong.append([k, got, want])
        print(f"checkers[a]: {len(keyed) // 2} invoke/complete pairs, "
              f"{N_HISTORIES} keys, valid? {res['valid?']}, "
              f"{len(res['failures'])} failures, check_batch calls "
              f"{chk.calls}, phase-5 unknowns [key, checker, sweep] "
              f"{json.dumps(rows)}, {seconds['a']:.3f} s, launches "
              f"{launches['a']}", flush=True)
        if wrong:
            raise AssertionError(f"checkers[a]: [key, checker, phase 5 or "
                                 f"sweep] disagreeing {wrong}")

        # (b) the keys phase 5 left unknown, with the mesh rescue
        if not undecided:
            raise AssertionError("phase 5 left no key unknown: no mesh key "
                                 "to run")
        mchk = CountingLinearizable({
            "model": "cas-register", "algorithm": "competition",
            "kernel-opts": {"capacity": CAPS,
                            "mesh": mesh_mod.make_mesh(MESH_SHARDS)}})
        wk.reset_counts()
        t0 = time.perf_counter()
        resb = checker.check_safe(independent.checker(mchk), {},
                                  _keyed(independent, hists, undecided))
        seconds["b"] = time.perf_counter() - t0
        launches["b"] = _launch_counts(wk)
        no_errors("b", resb)
        rows = [[k, resb["results"][k]["valid?"], sweep[k]["valid?"]]
                for k in undecided]
        print(f"checkers[b]: mesh keys [key, checker, sweep] "
              f"{json.dumps(rows)}, check_batch calls {mchk.calls}, "
              f"{seconds['b']:.3f} s, launches {launches['b']}", flush=True)
        if mchk.returned != 1 or launches["b"]["mesh_exchange"] <= 0:
            raise AssertionError("checkers[b]: the batch path or the exchange "
                                 "did not run")
        if any("unknown" not in (g, w) and g != w for _k, g, w in rows):
            raise AssertionError("checkers[b]: a mesh key disagrees with the "
                                 "sweep")

        # (d) "tpu": the chunked engine, fast, from the checker
        h2 = genhist.valid_register_history(SPILL_OPS, SINGLE_PROCS, seed=1,
                                            info_rate=SINGLE_INFO)
        refuted = {i: (hists[i], _op_index(cpu_sample[i]))
                   for i in DECIDED_BENCH}
        tchk = lin.linearizable({"model": "cas-register", "algorithm": "tpu",
                                 "kernel-opts": TPU_OPTS})
        wk.reset_counts()
        t0 = time.perf_counter()
        r2 = checker.check_safe(tchk, {}, h2)
        rd = {i: checker.check_safe(tchk, {}, hh)
              for i, (hh, _op) in refuted.items()}
        seconds["d"] = time.perf_counter() - t0
        launches["d"] = _launch_counts(wk)
        no_errors("d", [r2, *rd.values()])
        got = {str(SPILL_OPS): r2["valid?"],
               **{i: [r["valid?"], _op_index(r)] for i, r in rd.items()}}
        print(f"checkers[d]: tpu {json.dumps(TPU_OPTS)}: {json.dumps(got)} "
              f"(sweep ops "
              f"{json.dumps({i: op for i, (_h, op) in refuted.items()})}), "
              f"{seconds['d']:.3f} s, launches {launches['d']}", flush=True)
        if r2["valid?"] is not True or any(
                got[i] != [False, op] for i, (_h, op) in refuted.items()):
            raise AssertionError("checkers[d]: a tpu verdict is not the "
                                 "sweep's")

        # (e) streaming: the (d) histories fast under "fused" here, bench
        # histories 0-31 at the default capacity in the workers
        wk.reset_counts()
        t0 = time.perf_counter()
        kw = dict(feed_ops=STREAM_FEED_OPS, capacity=STREAM_CAPS, fast=True,
                  dedup_backend="fused")
        rs, sc = streaming.stream_check(model, h2, **kw)
        streamed = {str(SPILL_OPS): [rs["valid?"], sc.detection]}
        if rs["valid?"] is not True:
            raise AssertionError(f"checkers[e]: the {SPILL_OPS}-op stream "
                                 f"gave {rs['valid?']}")
        for i, (hh, op) in refuted.items():
            rs, sc = streaming.stream_check(model, hh, **kw)
            det = sc.detection or {}
            streamed[i] = [rs["valid?"], _op_index(rs), det.get("ops"),
                           len(hh)]
            if (rs["valid?"], _op_index(rs)) != (False, op) or not (
                    det.get("ops", len(hh)) < len(hh)):
                raise AssertionError(f"checkers[e]: history {i} streamed to "
                                     f"{streamed[i]}, sweep op {op}")
        seconds["e_fast"] = time.perf_counter() - t0
        launches["e"] = _launch_counts(wk)
        # the post-hoc ladder at the streams' capacity: with its CPU
        # fallback (what the decided streams are held to: verdict, op and
        # parity digest), and without it (where it decides, a stream must
        # too: the streams' exact engine loses rows only where the
        # ladder's rungs do)
        t0 = time.perf_counter()
        post = batch.batch_analysis(model, hists[:CHECKER_HISTORIES],
                                    capacity=STREAM_POSTHOC_CAPS,
                                    device="cuda")
        post_rungs = batch.batch_analysis(model, hists[:CHECKER_HISTORIES],
                                          capacity=STREAM_POSTHOC_CAPS,
                                          cpu_fallback=False, device="cuda")
        seconds["e_posthoc"] = time.perf_counter() - t0

        # (c) the competition, one history per task: phase 5's verdict
        # wherever phase 5 decided, save on the histories named in
        # COMPETITION_UNDECIDED (left unknown by the JAX package's
        # competition too), and never the sweep's contrary
        engines: dict = {}
        slow = []  # [history, engine, verdict, seconds] past the greedy walk
        wrong, excused = [], []
        launches["c"] = dict.fromkeys(launches["a"], 0)
        for i, fut in enumerate(comp_futs):
            r, n, sec = fut.result()
            no_errors(f"c-{i}", r)
            for name, c in n.items():
                launches["c"][name] += c
            eng = r["provenance"]["engine"]["engine"]
            engines[eng] = engines.get(eng, 0) + 1
            if eng != "greedy":
                slow.append([i, eng, r["valid?"], round(sec, 3)])
            want5 = ladder_results[i]["valid?"]
            if want5 != "unknown" and r["valid?"] != want5:
                if r["valid?"] == "unknown" and i in COMPETITION_UNDECIDED:
                    excused.append([i, want5])
                else:
                    wrong.append([i, r["valid?"], "phase 5", want5])
            want6 = cpu_sample[i]["valid?"]
            if "unknown" not in (r["valid?"], want6) and r["valid?"] != want6:
                wrong.append([i, r["valid?"], "sweep", want6])
        seconds["c"] = time.perf_counter() - t_phase
        print(f"checkers[c]: competition on bench histories 0-"
              f"{CHECKER_HISTORIES - 1} ({CHECKER_WORKERS} processes): "
              f"decided by engine {json.dumps(engines)}, "
              f"{seconds['c']:.3f} s from the phase's start, launches "
              f"{launches['c']}; past the greedy walk [history, engine, "
              f"verdict, seconds] {json.dumps(slow)}; unknown where phase 5 "
              f"decided, as in the JAX package [history, phase 5] "
              f"{json.dumps(excused)}", flush=True)
        if wrong:
            raise AssertionError(f"checkers[c]: [history, competition, against, "
                                 f"verdict] disagreeing {wrong}")

        # (e) the default-capacity streams against the post-hoc ladders
        mismatch, lost, undecided_streams = [], [], []
        for i, fut in enumerate(stream_futs):
            rs, digest, n = fut.result()
            no_errors(f"e-{i}", rs)
            for name, c in n.items():
                launches["e"][name] += c
            if rs["valid?"] == "unknown":
                undecided_streams.append([i, post[i]["valid?"],
                                          post_rungs[i]["valid?"]])
                if post_rungs[i]["valid?"] != "unknown":
                    lost.append(i)
            elif (rs["valid?"], _op_index(rs)) != (
                    post[i]["valid?"], _op_index(post[i])) or digest != (
                    streaming.parity_digest(provenance.build_bundle(
                        history=hists[i], result=post[i], source="posthoc",
                        model=model, checker="linearizable"))):
                mismatch.append([i, rs["valid?"], _op_index(rs),
                                 post[i]["valid?"], _op_index(post[i])])
        seconds["e"] = time.perf_counter() - t_phase
        print(f"checkers[e]: fast fused streams (feed {STREAM_FEED_OPS} ops, "
              f"capacity {list(STREAM_CAPS)}) [verdict, op, ops at "
              f"detection, ops]: {json.dumps(streamed, default=str)} "
              f"({seconds['e_fast']:.3f} s); default-capacity streams of "
              f"bench histories 0-{CHECKER_HISTORIES - 1} "
              f"({CHECKER_WORKERS} processes) against the post-hoc ladder at "
              f"{list(STREAM_POSTHOC_CAPS)} ({seconds['e_posthoc']:.3f} s for "
              f"both ladders): {CHECKER_HISTORIES - len(undecided_streams)} "
              f"streams decided, {len(mismatch)} of them with another "
              f"verdict, op or parity digest {mismatch}; undecided streams "
              f"[history, ladder, ladder without CPU fallback] "
              f"{json.dumps(undecided_streams)}, of them decided by the "
              f"ladder's rungs {lost}; {seconds['e']:.3f} s from the "
              f"phase's start, launches {launches['e']}", flush=True)
        if mismatch or lost:
            raise AssertionError(f"checkers[e]: stream and post-hoc "
                                 f"mismatching {mismatch}, unknown where the "
                                 f"ladder's rungs decided {lost}")
    finally:
        ex.shutdown(cancel_futures=True)

    for sub in ("a", "d", "e"):
        for name in ("keep_mask", "fused_frontier_update"):
            if launches[sub][name] <= 0:
                raise AssertionError(f"checkers[{sub}]: {name} was not "
                                     "launched")
    print(f"checkers: phase {time.perf_counter() - t_phase:.3f} s ((c) and "
          f"(e)'s default streams beside (a), (b), (d)), seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}",
          flush=True)
    return launches


def _result_core(res) -> dict:
    """An Elle result without its provenance block (which names the
    cycle backend and the inference engine that ran)."""
    return {k: v for k, v in res.items() if k != "provenance"}


def _graph_diff(a, b) -> list[str]:
    """Where two TxnGraphs differ: matrices, edge arrays, nodes,
    anomalies, the rendered explanation of every edge."""
    import numpy as np

    bad = []
    for et in ("ww", "wr", "rw", "extra"):
        if not np.array_equal(getattr(a, et), getattr(b, et)):
            bad.append(et)
        if not np.array_equal(np.asarray(a.edge_arrays()[et]).reshape(-1, 2),
                              np.asarray(b.edge_arrays()[et]).reshape(-1, 2)):
            bad.append(f"edges[{et}]")
    if [(x.op, x.invoke_index, x.ok) for x in a.nodes] != [
            (y.op, y.invoke_index, y.ok) for y in b.nodes]:
        bad.append("nodes")
    if a.anomalies != b.anomalies:
        bad.append("anomalies")
    for et in ("ww", "wr", "rw"):
        for i, j in np.asarray(a.edge_arrays()[et]).reshape(-1, 2):
            if a.explain(et, int(i), int(j)) != b.explain(et, int(i), int(j)):
                bad.append(f"explain[{et}]")
                break
    return bad


def _planted_graphs(tg, hmod, n: int, seed: int):
    """Two TxnGraphs of n nodes: random forward (acyclic) edges of every
    type among nodes 12..n-1 plus one G0, one G1c, one G-single and one
    G2 cycle on nodes 1-11; and the acyclic control, the same graph
    without the planted cycles."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(4):
        m = np.triu(rng.random((n, n)) < 2.0 / n, k=1)
        m[:12, :] = False
        m[:, :12] = False
        mats.append(m)
    control = [m.copy() for m in mats]
    ww, wr, rw, _extra = mats
    ww[1, 2] = ww[2, 1] = True          # G0
    ww[4, 5] = wr[5, 4] = True          # G1c
    ww[7, 8] = rw[8, 7] = True          # G-single
    rw[10, 11] = rw[11, 10] = True      # G2: two rw edges
    nodes = [tg.TxnNode(i, hmod.op(hmod.OK, i % 8, "txn", [], index=i), i, i, True)
             for i in range(n)]

    def graph(m):
        return tg.TxnGraph(nodes=nodes, ww=m[0], wr=m[1], rw=m[2], extra=m[3],
                           explanations={}, anomalies={})

    return graph(mats), graph(control)


def _claimed_order_analyzer(elle):
    """The realtime analyzer plus a "claimed" relation that puts one op
    before another which completed before it was invoked: a cycle
    through realtime (a realtime order alone has none, being an
    interval order)."""
    import numpy as np

    def analyzer(history):
        nodes, rel, explain_rt = elle.realtime_analyzer(history)
        rt = rel["realtime"]
        claimed = np.zeros_like(rt)
        pairs = np.argwhere(rt)
        a, b = (int(x) for x in pairs[len(pairs) // 2])
        claimed[b, a] = True

        def explain(i, j, r):
            if r == "claimed":
                return (f"op {nodes[i].get('index')} is claimed to precede "
                        f"op {nodes[j].get('index')}")
            return explain_rt(i, j, r)

        return nodes, {"realtime": rt, "claimed": claimed}, explain

    return analyzer


def run_elle(dev, card: str) -> dict:
    """Phase 10: Elle on the card (see the module docstring); returns
    its seconds and the crossover table."""
    import numpy as np
    import torch

    from jepsen_tpu_torch import history as hmod
    from jepsen_tpu_torch.checker import elle, scc
    from jepsen_tpu_torch.checker import txn_graph as tg
    from jepsen_tpu_torch.ops import closure as cl
    from jepsen_tpu_torch.parallel.mesh import make_mesh
    from jepsen_tpu_torch.testing import gentxn

    class CountingListAppend(elle.ListAppendChecker):
        """Counts the check_batch calls and the ones that returned."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.calls = self.returned = 0

        def check_batch(self, test, histories, opts):
            self.calls += 1
            out = super().check_batch(test, histories, opts)
            self.returned += 1
            return out

    seconds: dict = {}
    t_phase = time.perf_counter()
    # the first product on the card creates the cuBLAS handle: no timing
    # below carries it
    z = np.zeros((4, 4), bool)
    cl.classify_graphs([(z, z, z, z)], device=dev)

    # (a) config 3, the columns engine against the loops
    hist = gentxn.append_history(ELLE_TXNS, n_keys=ELLE_KEYS,
                                 n_procs=ELLE_PROCS, seed=ELLE_SEED)
    chk = elle.list_append(device=dev)
    t0 = time.perf_counter()
    res = chk.check({}, hist, {})
    t_check = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = tg.list_append_graph(hist, (), engine="columns")
    t_infer = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_g = elle.check_graph(g, chk.anomalies, device=dev)
    t_classify = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_loops = tg.list_append_graph(hist, (), engine="loops")
    t_loops = time.perf_counter() - t0
    diff = _graph_diff(g, g_loops)
    res_loops = elle.list_append(engine="loops", device=dev).check({}, hist, {})
    seconds["a"] = time.perf_counter() - t_phase
    edges = {et: len(g.edge_arrays()[et]) for et in ("ww", "wr", "rw")}
    print(f"elle[a]: config 3 ({ELLE_TXNS} txns, {ELLE_KEYS} keys, "
          f"{ELLE_PROCS} processes, seed {ELLE_SEED}): valid? "
          f"{res['valid?']}, {g.n} nodes, edges {json.dumps(edges)}; check "
          f"{t_check:.3f} s = inference {t_infer:.3f} s (columns; loops "
          f"{t_loops:.3f} s) + classification {t_classify:.3f} s (host SCC: "
          f"{g.n} nodes > SCC_THRESHOLD {elle.SCC_THRESHOLD}, so under "
          f"backend=\"device\" too: "
          f"{not elle._device_classify(g.n, 'device')}); columns vs loops "
          f"graph differences {diff}, results equal "
          f"{_result_core(res_loops) == _result_core(res)}; {card}", flush=True)
    if (res["valid?"] is not True or diff
            or _result_core(res_g) != _result_core(res)
            or _result_core(res_loops) != _result_core(res)):
        raise AssertionError(f"elle[a]: config 3 valid? {res['valid?']}, "
                             f"engines differ at {diff}")
    del g_loops

    # (b) config 3b
    t0 = time.perf_counter()
    rb = chk.check({}, gentxn.corrupt_wr(hist, seed=ELLE_CORRUPT_SEED), {})
    seconds["b"] = time.perf_counter() - t0
    print(f"elle[b]: config 3b (corrupt_wr seed {ELLE_CORRUPT_SEED}): valid? "
          f"{rb['valid?']}, anomaly-types {rb.get('anomaly-types')}, "
          f"{seconds['b']:.3f} s; {card}", flush=True)
    if rb["valid?"] is not False or rb.get("anomaly-types") != ["incompatible-order"]:
        raise AssertionError(f"elle[b]: {rb['valid?']} {rb.get('anomaly-types')}")
    del hist, g

    # (c) config 3c: one check_batch per backend, then the cycle phase's
    # split on the same graphs
    t_c = time.perf_counter()
    hists = [gentxn.append_history(PER_KEY_TXNS, n_keys=PER_KEY_KEYS,
                                   n_procs=PER_KEY_PROCS, seed=PER_KEY_SEED + i)
             for i in range(PER_KEY_GRAPHS)]
    outs, batch_s, launches = {}, {}, {}
    prev = elle.CYCLE_BACKEND
    try:
        for backend in ("device", "host"):
            elle.CYCLE_BACKEND = backend
            c = CountingListAppend(device=dev)
            cl.reset_counts()
            t0 = time.perf_counter()
            outs[backend] = c.check_batch({}, hists, {})
            batch_s[backend] = time.perf_counter() - t0
            launches[backend] = dict(cl.BUCKET_LAUNCHES)
            if (c.calls, c.returned) != (1, 1):
                raise AssertionError(f"elle[c]: check_batch called {c.calls} "
                                     f"times, returned {c.returned} times")
    finally:
        elle.CYCLE_BACKEND = prev
    equal = [_result_core(r) for r in outs["device"]] == [
        _result_core(r) for r in outs["host"]]
    valid = sum(1 for r in outs["host"] if r["valid?"] is True)
    t0 = time.perf_counter()
    graphs = tg.list_append_graphs(hists)
    t_infer = time.perf_counter() - t0
    mats = [(gg.ww, gg.wr, gg.rw, gg.extra) for gg in graphs]
    split: list = []
    t0 = time.perf_counter()
    dev_out = cl.classify_graphs(mats, device=dev, timings=split)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_out = [scc.classify_graph_scc(*m, edges=gg.edge_arrays())
                for m, gg in zip(mats, graphs)]
    t_host = time.perf_counter() - t0
    size = cl._pad_to(max(m[0].shape[0] for m in mats))
    steps = cl._n_steps(size)
    x = torch.from_numpy(cl._pad_stack(mats, range(len(mats)), size)).to(dev)
    closure_ms = _time_ms(
        lambda: cl.classify_cycles_batch(x[0], x[1], x[2], x[3], steps, device=dev),
        iters=5)
    flops = 3 * steps * len(mats) * 2 * size ** 3
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    del x
    seconds["c"] = time.perf_counter() - t_c
    print(f"elle[c]: config 3c ({PER_KEY_GRAPHS} histories of {PER_KEY_TXNS} "
          f"txns, {PER_KEY_KEYS} keys, {PER_KEY_PROCS} processes, seeds "
          f"{PER_KEY_SEED}+i), one ListAppendChecker.check_batch each: device "
          f"{batch_s['device']:.3f} s (closure launches per bucket "
          f"{json.dumps(launches['device'])}), host {batch_s['host']:.3f} s "
          f"(launches {json.dumps(launches['host'])}); {valid} valid; results "
          f"equal {equal}; cycle phase on the same graphs (inference "
          f"{t_infer:.3f} s): device {t_dev:.4f} s "
          f"{json.dumps([{k: (round(v, 6) if isinstance(v, float) else v) for k, v in r.items()} for r in split])}, "
          f"host SCC {t_host:.4f} s, flags and hints equal "
          f"{dev_out == host_out}; the bucket's classification "
          f"{closure_ms:.4f} ms on the card (CUDA events; {flops / 1e9:.1f} "
          f"GFLOP of bf16 products, bound {bound_ms:.4f} ms); {card}", flush=True)
    if not equal or dev_out != host_out or any(v != 1 for v in launches["device"].values()) \
            or not launches["device"] or launches["host"]:
        raise AssertionError(f"elle[c]: results equal {equal}, flags equal "
                             f"{dev_out == host_out}, launches {launches}")

    # (d) planted cycles: the card, the CPU path and host SCC
    t_d = time.perf_counter()
    requested = ["G2", "G1", "internal"]
    rows = []
    for n in PLANTED_SIZES:
        planted, control = _planted_graphs(tg, hmod, n, seed=n)
        for name, gg, want in (("planted", planted, True), ("control", control, False)):
            m = (gg.ww, gg.wr, gg.rw, gg.extra)
            on_card = cl.classify_graph(*m, device=dev)
            on_cpu = cl.classify_graph(*m, device="cpu")
            on_host = scc.classify_graph_scc(*m)
            r_dev = elle.check_graph(gg, requested, backend="device", device=dev)
            r_cpu = elle.check_graph(gg, requested, backend="device", device="cpu")
            r_host = elle.check_graph(gg, requested, backend="host")
            ok = (on_card == on_cpu == on_host and r_dev == r_cpu == r_host
                  and all(on_card[0][k] is want for k in on_card[0])
                  and (r_dev["valid?"] is not want))
            rows.append([n, name, on_card[0] == {k: want for k in on_card[0]},
                         on_card[1], r_dev.get("anomaly-types"), ok])
            if not ok:
                raise AssertionError(f"elle[d]: {n} {name}: card {on_card}, cpu "
                                     f"{on_cpu}, host {on_host}")
        full = planted.ww | planted.wr | planted.rw | planted.extra
        size, steps = cl._pad_to(n), cl._n_steps(n)
        c_dev = cl.transitive_closure(cl.pad_adj(full, size), steps, device=dev)
        c_dev = c_dev.cpu().numpy()[:n, :n] > 0
        oracle = cl.transitive_closure_np(full)
        sharded = cl.transitive_closure_sharded(full, make_mesh(MESH_SHARDS, device=dev))
        if not (np.array_equal(c_dev, oracle) and np.array_equal(sharded, c_dev)):
            raise AssertionError(f"elle[d]: closures differ at {n} nodes")
        rows.append([n, "closure", "card = numpy oracle = sharded on "
                     f"make_mesh({MESH_SHARDS})", int(oracle.sum())])
    rt_hist = gentxn.append_history(200, n_keys=5, n_procs=8, seed=7)
    r_rt = elle.cycle_checker(elle.realtime_analyzer, backend="device",
                              device=dev).check({}, rt_hist, {})
    r_claim = elle.cycle_checker(_claimed_order_analyzer(elle), backend="device",
                                 device=dev).check({}, rt_hist, {})
    r_claim_host = elle.cycle_checker(_claimed_order_analyzer(elle),
                                      backend="host").check({}, rt_hist, {})
    seconds["d"] = time.perf_counter() - t_d
    print(f"elle[d]: planted cycles [nodes, graph, flags, hints, anomaly-types, "
          f"card = cpu = host] {json.dumps(rows)}; cycle_checker("
          f"realtime_analyzer, backend=\"device\") valid? {r_rt['valid?']}; "
          f"with a claimed order against realtime valid? {r_claim['valid?']} "
          f"(cycle of {len(r_claim.get('anomalies', {}).get('cycle', [{}])[0].get('cycle', []))} "
          f"ops; host backend equal {_result_core(r_claim) == _result_core(r_claim_host)}), "
          f"{seconds['d']:.3f} s; {card}", flush=True)
    if (r_rt["valid?"] is not True or r_claim["valid?"] is not False
            or _result_core(r_claim) != _result_core(r_claim_host)):
        raise AssertionError(f"elle[d]: realtime {r_rt['valid?']}, claimed "
                             f"{r_claim['valid?']}")

    # (e) crossover: the cycle phase on both backends at the JAX
    # package's shapes, warm (one untimed classification of the shape
    # first); nothing is asserted on speed
    t_e = time.perf_counter()
    table = []
    for n_graphs, txns in CROSSOVER:
        if (n_graphs, txns) == (PER_KEY_GRAPHS, PER_KEY_TXNS):
            gs = graphs
        else:
            gs = tg.list_append_graphs([
                gentxn.append_history(txns, n_keys=PER_KEY_KEYS,
                                      n_procs=PER_KEY_PROCS,
                                      seed=CROSSOVER_SEED + i)
                for i in range(n_graphs)])
        ms = [(gg.ww, gg.wr, gg.rw, gg.extra) for gg in gs]
        cl.classify_graphs(ms, device=dev)
        split = []
        t0 = time.perf_counter()
        d_out = cl.classify_graphs(ms, device=dev, timings=split)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        h_out = [scc.classify_graph_scc(*m, edges=gg.edge_arrays())
                 for m, gg in zip(ms, gs)]
        t_host = time.perf_counter() - t0
        if d_out != h_out:
            raise AssertionError(f"elle[e]: {n_graphs}x{txns}: device and host "
                                 "flags or hints differ")
        stage = {k: sum(r[k] for r in split) for k in ("pad", "h2d", "closure", "d2h")}
        row = {"graphs": n_graphs, "txns": txns,
               "sizes": sorted({r["size"] for r in split}),
               "products": sum(r["products"] for r in split),
               "gflop": sum(3 * r["steps"] * r["graphs"] * 2 * r["size"] ** 3
                            for r in split) / 1e9,
               "device_s": t_dev, **{f"{k}_s": v for k, v in stage.items()},
               "host_s": t_host, "host_over_device": t_host / t_dev,
               "flagged": sum(1 for f, _ in h_out if any(f.values()))}
        table.append(row)
        print(f"elle[e]: crossover {n_graphs} x {txns} txns: device "
              f"{t_dev:.4f} s (pad {stage['pad']:.4f}, h2d {stage['h2d']:.4f}, "
              f"closure {stage['closure']:.4f}, d2h {stage['d2h']:.4f}; "
              f"{row['gflop']:.1f} GFLOP in {row['products']} batched "
              f"products), host SCC {t_host:.4f} s, host/device "
              f"{row['host_over_device']:.2f}, {row['flagged']} graphs "
              f"flagged; {card}", flush=True)
    seconds["e"] = time.perf_counter() - t_e
    total = time.perf_counter() - t_phase
    print(f"elle: phase {total:.3f} s, seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}",
          flush=True)
    return {"seconds": seconds, "crossover": table, "phase_s": total}


#: Phase 11: the services.  The checkpoint stage the killed child must
#: reach, the share of phase 5's ladder seconds the deadline gets, the
#: seeded fault schedule, the context-parallel histories' capacity
#: ladder and the extra history's shape, and the evidence run's keys.
KILL_AT_STAGE = 2
DEADLINE_SHARE = 1 / 3
FAULT_SEED = 11
SHARDED_CAPS = (4096,)
SHARDED_EXTRA = (250, 8, 0.05, 500)  # ops, processes, :info rate, seed
EVIDENCE_KEYS = 8


def _bench_histories(genhist) -> list:
    """The bench workload of phase 5 (seeds 0-127, every 4th corrupted)."""
    hists = []
    for i in range(N_HISTORIES):
        hh = genhist.valid_register_history(
            OPS_PER_HISTORY, PROCS, seed=i, info_rate=INFO_RATE,
            n_values=N_VALUES)
        if i % CORRUPT_EVERY == CORRUPT_EVERY - 1:
            hh = genhist.corrupt(hh, seed=i)
        hists.append(hh)
    return hists


LADDER_KW = dict(capacity=CAPS, exact_escalation=(), cpu_fallback=False,
                 dedup_backend="fused", device="cuda")


def ladder_child(checkpoint_dir: str) -> int:
    """``--ladder-child DIR``: the bench ladder of phase 5 with a
    checkpoint directory, in a process of its own that phase 11(a)
    kills."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.parallel import batch
    from jepsen_tpu_torch.testing import genhist

    batch.batch_analysis(m.CASRegister(None), _bench_histories(genhist),
                         checkpoint_dir=checkpoint_dir, **LADDER_KW)
    return 0


def _checkpoint_stage(d) -> tuple[int, bool] | None:
    """The (stage, complete) of the ladder checkpoint in ``d``, read
    without verification (a verifying read quarantines a pair caught
    between its two writes), or None before the first save."""
    from jepsen_tpu_torch.store import checkpoint as ckpt

    try:
        doc = json.loads(ckpt.json_path(d).read_text())["payload"]
    except (OSError, ValueError, KeyError):
        return None
    return int(doc["stage"]), bool(doc["complete"])


def _kill_mid_ladder(d) -> tuple[int, float]:
    """Start the ladder child, SIGKILL its process group once its
    checkpoint reaches ``KILL_AT_STAGE``; returns (stage, seconds from
    the start to the kill)."""
    import signal

    log = open(Path(d).parent / "child.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ladder-child",
         str(d)], stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        while True:
            st = _checkpoint_stage(d)
            if st is not None and st[1]:
                raise AssertionError("services[a]: the child finished before "
                                     "it was killed")
            if st is not None and st[0] >= KILL_AT_STAGE:
                break
            if proc.poll() is not None:
                raise AssertionError(
                    f"services[a]: the ladder child exited {proc.returncode}: "
                    + (Path(d).parent / "child.log").read_text()[-2000:])
            if time.perf_counter() - t0 > 300:
                raise AssertionError("services[a]: no stage-"
                                     f"{KILL_AT_STAGE} checkpoint in 300 s")
            time.sleep(0.02)
        seconds = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        log.close()
    return _checkpoint_stage(d)[0], seconds


def _verdicts(res) -> list:
    return [r["valid?"] for r in res]


def _oom_fraction(batch, wgl, model, hists, ladder_results, dev) -> dict:
    """The memory fraction at which the 2048 rung's launch runs out of
    memory while its halves fit: the lanes phase 5 decided (or left) at
    that rung, launched alone at their padded width and at half of it,
    each peak of reserved memory read after emptying the cache; the cap
    lies halfway between the two peaks."""
    import torch

    top = CAPS[-1]
    lanes = [i for i, r in enumerate(ladder_results)
             if (r.get("kernel") or {}).get("capacity") == top]
    packs = [wgl.pack(model, hists[i]) for i in lanes]
    total = torch.cuda.get_device_properties(dev).total_memory

    def peak(sub, halved) -> int:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        batch._launch("async", top, sub, None, "fused", dev, 8, halved=halved)
        torch.cuda.synchronize()
        out = torch.cuda.max_memory_reserved() - base
        torch.cuda.empty_cache()
        return out

    full = peak(packs, False)
    half = peak(packs[: (len(packs) + 1) // 2], True)
    base = torch.cuda.memory_reserved()
    if not (0 < half < full):
        raise AssertionError(f"services[c]: the halved launch holds {half} "
                             f"bytes against {full}: halving cannot help")
    cap = base + (half + full) // 2
    return {"lanes": len(lanes), "padded": batch.padded_batch(len(lanes)),
            "full_bytes": full, "half_bytes": half, "base_bytes": base,
            "device_buffer_bytes": wgl.device_buffer_bytes(dev),
            "total_bytes": total, "fraction": cap / total}


def run_services(dev, batch, wk, wgl, sharded, mesh_mod, genhist, model,
                 hists, ladder_results, ladder_seconds, ladder_stats,
                 card: str) -> dict:
    """Phase 11: the services on the card (see the module docstring);
    returns the kernels' launch counts of each sub-phase."""
    import tempfile

    import torch

    from jepsen_tpu_torch import checker, faults, independent
    from jepsen_tpu_torch import history as hmod
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.obs import provenance
    from jepsen_tpu_torch.store import checkpoint as ckpt

    want = _verdicts(ladder_results)
    launches: dict = {}
    seconds: dict = {}
    t_phase = time.perf_counter()

    def held(tag, got) -> None:
        bad = [[i, g, w] for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad:
            raise AssertionError(f"services[{tag}]: [history, got, phase 5] "
                                 f"disagreeing {bad[:10]}")

    with tempfile.TemporaryDirectory(prefix="chip-smoke-services-") as tmp:
        tmp = Path(tmp)
        # (a) a real kill: the ladder in a child process, SIGKILLed once
        # its checkpoint passed stage 1, then resumed here
        t_sub = time.perf_counter()
        d = tmp / "kill" / "ckpt"
        d.parent.mkdir()
        stage, t_kill = _kill_mid_ladder(d)
        saved = ckpt.load(d)
        wk.reset_counts()
        t0 = time.perf_counter()
        res = batch.batch_analysis(model, hists, checkpoint_dir=d, resume=True,
                                   **LADDER_KW)
        t_resume = time.perf_counter() - t0
        launches["a"] = _launch_counts(wk)
        held("a", _verdicts(res))
        restored = sum(1 for r in res if r["provenance"]["path"]
                       and r["provenance"]["path"][0]["event"]
                       == "checkpoint.restored")
        if restored != len(res) or not ckpt.load(d)["complete"]:
            raise AssertionError(f"services[a]: {restored} of {len(res)} "
                                 "results restored, or no complete checkpoint")
        print(f"services[a]: child killed at checkpoint stage {stage} "
              f"({t_kill:.3f} s after its start; {len(saved['pending'])} "
              f"pending, {len(saved['resumes'])} carried frontiers, "
              f"{len(saved['confirms'])} confirmations in flight); resume "
              f"{t_resume:.3f} s against phase 5's ladder "
              f"{ladder_seconds:.3f} s; verdicts equal phase 5's; launches "
              f"{launches['a']}; {card}", flush=True)
        seconds["a"] = time.perf_counter() - t_sub

        # (b) a deadline of a third of phase 5's ladder seconds, then a
        # resume without one
        d = tmp / "deadline"
        budget = ladder_seconds * DEADLINE_SHARE
        wk.reset_counts()
        t_sub = t0 = time.perf_counter()
        res = batch.batch_analysis(model, hists, checkpoint_dir=d,
                                   deadline=faults.Deadline(budget),
                                   **LADDER_KW)
        t_trip = time.perf_counter() - t0
        undecided = [i for i, r in enumerate(res) if r["valid?"] == "unknown"]
        bad = [i for i in undecided
               if "deadline-exceeded" not in res[i].get("cause", "")
               or ckpt.CKPT_JSON not in res[i].get("cause", "")]
        wrong = [i for i, r in enumerate(res)
                 if r["valid?"] != "unknown" and r["valid?"] != want[i]]
        if bad or wrong or not undecided:
            raise AssertionError(f"services[b]: without the deadline cause "
                                 f"{bad[:10]}, disagreeing {wrong[:10]}, "
                                 f"{len(undecided)} undecided")
        t0 = time.perf_counter()
        res = batch.batch_analysis(model, hists, checkpoint_dir=d, resume=True,
                                   **LADDER_KW)
        t_resume = time.perf_counter() - t0
        seconds["b"] = time.perf_counter() - t_sub
        launches["b"] = _launch_counts(wk)
        held("b", _verdicts(res))
        print(f"services[b]: deadline {budget:.3f} s: returned in "
              f"{t_trip:.3f} s with {len(undecided)} histories unknown "
              f"(deadline-exceeded, checkpoint named), the rest phase 5's; "
              f"resume {t_resume:.3f} s, verdicts equal phase 5's; "
              f"launches {launches['b']}; {card}", flush=True)

        # (c) a real out-of-memory at the 2048 rung's launch, then seeded
        # transient faults.  The ladder first runs to the 2048 rung's
        # boundary (a deadline that expires at that rung's poll, the
        # ladder polling once per rung), so that the cap meets the 2048
        # rung alone: halvings at an earlier rung would shrink the lane
        # budget of every later one.
        class TripAtTopRung(faults.Deadline):
            __slots__ = ("polls",)

            def expired(self):
                self.polls += 1
                return self.polls > len(CAPS)

        d = tmp / "oom"
        trip = TripAtTopRung(3600.0)
        trip.polls = 0
        t_sub = t0 = time.perf_counter()
        batch.batch_analysis(model, hists, checkpoint_dir=d, deadline=trip,
                             **LADDER_KW)
        t_pre = time.perf_counter() - t0
        pre = ckpt.load(d)
        if pre["stage"] != len(CAPS) or pre["complete"]:
            raise AssertionError(f"services[c]: checkpoint at stage "
                                 f"{pre['stage']}, not the {CAPS[-1]} rung")
        frac = _oom_fraction(batch, wgl, model, hists, ladder_results, dev)
        print("services[c]: memory cap " + json.dumps(frac), flush=True)
        st: dict = {}
        wk.reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(frac["fraction"])
        t0 = time.perf_counter()
        try:
            res = batch.batch_analysis(model, hists, checkpoint_dir=d,
                                       resume=True, stats=st, **LADDER_KW)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        t_capped = time.perf_counter() - t0
        held("c", _verdicts(res))
        halved = {r["capacity"]: r["halvings"] for r in st["rungs"]}
        if not halved.get(CAPS[-1]):
            raise AssertionError(f"services[c]: the {CAPS[-1]} rung did not "
                                 f"halve: {halved}")
        # the schedule's faults, counted by kind as they are raised, so
        # that a schedule that injected nothing fails the check
        seeded = faults.seeded_injector(FAULT_SEED, what="ladder.")
        fired: dict = {}

        def counted(ctx, attempt):
            try:
                seeded(ctx, attempt)
            except Exception as e:
                kind = faults.error_kind(e) or "other"
                fired[kind] = fired.get(kind, 0) + 1
                raise

        st_inj: dict = {}
        t0 = time.perf_counter()
        with faults.inject_scope(counted):
            res = batch.batch_analysis(model, hists, stats=st_inj, **LADDER_KW)
        t_inj = time.perf_counter() - t0
        seconds["c"] = time.perf_counter() - t_sub
        launches["c"] = _launch_counts(wk)
        faulted = [i for i, r in enumerate(res) if r["valid?"] != want[i]]
        bad = [i for i in faulted if res[i]["valid?"] != "unknown"
               or "injected" not in res[i].get("cause", "")]
        if bad:
            raise AssertionError(f"services[c]: injected faults changed "
                                 f"verdicts {bad[:10]}")
        if not fired:
            raise AssertionError(f"services[c]: seed {FAULT_SEED} injected "
                                 "no fault into the ladder's launches")
        print(f"services[c]: ladder to the {CAPS[-1]} rung {t_pre:.3f} s "
              f"({len(pre['pending'])} lanes pending); its resume under the "
              f"cap {t_capped:.3f} s, halvings per rung "
              f"{json.dumps(halved)}, spill retries "
              f"{st['oom_spill_retries']}, verdicts equal phase 5's; seeded "
              f"faults (seed {FAULT_SEED}) {t_inj:.3f} s, injected by kind "
              f"{json.dumps(fired)}, halvings {st_inj['oom_halvings']}, "
              f"spill retries {st_inj['oom_spill_retries']}, {len(faulted)} "
              f"unknown naming the fault, the rest phase 5's; launches "
              f"{launches['c']}; {card}", flush=True)

        # (d) device confirmation, over the histories phase 5 refuted:
        # one exact launch per capacity (per lane budget) confirms them
        refuted = [i for i, v in enumerate(want) if v is False]
        st = {}
        lanes: list = []  # (capacity, exact failed_at, lossy, peak) per lane
        plain_launch = batch._launch

        def exact_lanes(st_engine, cap, sub, *a, **k):
            out = plain_launch(st_engine, cap, sub, *a, **k)
            if st_engine == "exact":
                (_v, fat, lz, pk), _n, _s = out
                lanes.extend((cap, int(f), bool(z), int(p))
                             for f, z, p in zip(fat, lz, pk))
            return out

        wk.reset_counts()
        batch._launch = exact_lanes
        t0 = time.perf_counter()
        try:
            res = batch.batch_analysis(model, [hists[i] for i in refuted],
                                       confirm_refutations="device",
                                       stats=st, **LADDER_KW)
        finally:
            batch._launch = plain_launch
        seconds["d"] = time.perf_counter() - t0
        launches["d"] = _launch_counts(wk)
        bad = [[i, r["valid?"]] for i, r in zip(refuted, res)
               if r["valid?"] is not False]
        if bad:
            raise AssertionError(f"services[d]: [history, got] where phase 5 "
                                 f"refuted {bad[:10]}")
        dc = st.get("device_confirm") or {}
        by_cap: dict = {}
        for r in res:
            cap = int(r["kernel"]["capacity"])
            by_cap[cap] = by_cap.get(cap, 0) + 1
        expect = sum(-(-n // max(1, batch._EXACT_LANE_BUDGET // cap))
                     for cap, n in by_cap.items())
        # each refutation is final on the card (a lossless exact death)
        # or, where its exact lane was lossy or survived, decided by the
        # bounded sweep after that launch ran; a failed launch would
        # leave it unknown
        final: dict = {}
        swept: dict = {}
        for r in res:
            ev = r["provenance"]["path"]
            cap = int(r["kernel"]["capacity"])
            if {"event": "confirm.device", "outcome": "refuted-final"} in ev:
                final[cap] = final.get(cap, 0) + 1
            elif any(e["event"] == "confirm.resolved"
                     and e.get("mode") == "device-sweep" for e in ev):
                swept[cap] = swept.get(cap, 0) + 1
        # each exact lane that did not die losslessly (a refutation the
        # bounded sweep then decided): its capacity, and whether it was
        # lossy or survived its prefix
        swept_lanes = [
            {"capacity": cap, "exact": "lossy" if lz else "survived",
             "failed_at": fat, "peak": pk}
            for cap, fat, lz, pk in lanes if not (fat >= 0 and not lz)]
        if (dc.get("refutations") != len(refuted)
                or dc.get("launches") != expect or not final
                or sum(final.values()) + sum(swept.values()) != len(refuted)
                or len(swept_lanes) != sum(swept.values())
                or not all(r.get("confirmed?") for r in res)):
            raise AssertionError(
                f"services[d]: {dc.get('refutations')} refutations, "
                f"{dc.get('launches')} exact launches against {expect} for "
                f"capacities {by_cap}; by capacity {final} final on the card, "
                f"{swept} swept, of {len(refuted)}; swept exact lanes "
                f"{swept_lanes}")
        print(f"services[d]: device-confirmed ladder over phase 5's "
              f"{len(refuted)} refuted histories {seconds['d']:.3f} s; exact "
              f"runner {dc['launches']} launches (refutations per capacity "
              f"{json.dumps(by_cap)}), {dc['seconds']:.3f} s; final on the "
              f"card per capacity {json.dumps(final)}, by the bounded sweep "
              f"after a lossy or surviving exact lane {json.dumps(swept)}; "
              f"against phase 5's confirm drain "
              f"{ladder_stats['confirm_drain_s']:.3f} s; verdicts equal "
              f"phase 5's; launches {launches['d']}; {card}", flush=True)
        print("services[d]: swept exact lanes (capacity, lossy or "
              "survived, failed-at barrier, peak rows): "
              + json.dumps(swept_lanes), flush=True)

        # (e) context-parallel: one history's frontier over 4 shards
        mesh4 = mesh_mod.make_mesh(MESH_SHARDS)
        ops, procs, info, seed = SHARDED_EXTRA
        extra = genhist.valid_register_history(ops, procs, seed=seed,
                                               info_rate=info,
                                               n_values=N_VALUES)
        cases = [(f"bench {k}", hists[k]) for k in DECIDED_BENCH]
        cases.append((f"{ops}-op", extra))
        t0 = time.perf_counter()
        rows = []
        launches["e"] = {}
        for tag, hh in cases:
            # the context-parallel path's own launches: the reference
            # below runs the chunked engine, whose launches stay out
            wk.reset_counts()
            t1 = time.perf_counter()
            got = sharded.sharded_analysis(model, hh, mesh4,
                                           capacity=SHARDED_CAPS)
            t2 = time.perf_counter()
            for name, n in _launch_counts(wk).items():
                launches["e"][name] = launches["e"].get(name, 0) + n
            ref = wgl.analysis(model, hh, capacity=SHARDED_CAPS, fast=True)
            rows.append([tag, got["valid?"], ref["valid?"],
                         got.get("kernel", {}).get("frontier-peak"),
                         round(t2 - t1, 3)])
            if got["valid?"] != ref["valid?"] or _op_index(got) != _op_index(ref):
                raise AssertionError(f"services[e]: {tag}: sharded "
                                     f"{got['valid?']} against wgl.analysis "
                                     f"{ref['valid?']}")
        seconds["e"] = time.perf_counter() - t0
        if launches["e"]["mesh_exchange"] <= 0:
            raise AssertionError("services[e]: the exchange never launched")
        print(f"services[e]: sharded_analysis on {MESH_SHARDS} shards at "
              f"{SHARDED_CAPS} [history, sharded, wgl.analysis fast, peak, s] "
              f"{json.dumps(rows)}; {seconds['e']:.3f} s with the references; "
              f"launches {launches['e']}; {card}", flush=True)

        # (f) evidence bundles from check_safe with a store
        test = {"name": "services", "start-time-str": "f",
                "store-dir": str(tmp / "store")}
        keys = range(EVIDENCE_KEYS)
        keyed = _keyed(independent, hists, keys)
        chk = independent.checker(lin.linearizable({
            "model": "cas-register", "algorithm": "competition",
            "kernel-opts": {"capacity": CAPS}}))
        wk.reset_counts()
        t0 = time.perf_counter()
        res = checker.check_safe(chk, test, keyed)
        seconds["f"] = time.perf_counter() - t0
        launches["f"] = _launch_counts(wk)
        errs = _errors(res)
        if errs:
            raise AssertionError(f"services[f]: errors at {errs[:5]}")
        for k in keys:
            r = res["results"][k]
            if r["valid?"] != want[k] and want[k] != "unknown":
                raise AssertionError(f"services[f]: key {k} {r['valid?']} "
                                     f"against phase 5's {want[k]}")
            ev = r.get("evidence")
            if not ev:
                raise AssertionError(f"services[f]: key {k} has no evidence")
            rep = provenance.verify_bundle(ev["path"])
            sub = hmod.index(independent.subhistory(k, keyed))
            mem = provenance.build_bundle(
                history=sub, result=r, source="check_batch",
                model=lin.linearizable({"model": "cas-register"}).model,
                checker="linearizable")
            disk = provenance.read_bundle(ev["path"])
            if not rep["ok"] or not (ev["digest"] == disk["digest"]
                                     == mem["digest"]):
                raise AssertionError(f"services[f]: key {k}: verify "
                                     f"{rep}, digests {ev['digest']}, "
                                     f"{disk['digest']}, {mem['digest']}")
        print(f"services[f]: {EVIDENCE_KEYS} keys, {len(keys)} bundles "
              f"written, verify_bundle passes on each, digests equal the "
              f"in-memory bundles'; {seconds['f']:.3f} s; launches "
              f"{launches['f']}; {card}", flush=True)

    total = time.perf_counter() - t_phase
    print(f"services: phase {total:.3f} s, seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}; "
          f"{card}", flush=True)
    for name in ("keep_mask", "fused_frontier_update"):
        if not any(c[name] for c in launches.values()):
            raise AssertionError(f"services: {name} never launched")
    return launches


def run_telemetry(dev, batch, wk, wgl, genhist, model, hists,
                  ladder_results, ladder_seconds, ladder_counts,
                  card: str) -> dict:
    """Phase 12: the telemetry core on the card (see the module
    docstring); returns the kernels' launch counts of each sub-phase."""
    import tempfile

    from jepsen_tpu_torch import checker, independent, obs
    from jepsen_tpu_torch.checker import elle
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.obs import critpath, summary, trace
    from jepsen_tpu_torch.testing import gentxn

    launches: dict = {}
    seconds: dict = {}
    t_phase = time.perf_counter()
    if obs.active() is not None or obs.observing():
        raise AssertionError("telemetry: a recording or the metrics mirror "
                             "was open before phase 12")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_obs_")
    root = Path(tmp.name)
    try:
        # (a) the bench ladder of phase 5 under a recording
        wk.reset_counts()
        st: dict = {}
        t0 = time.perf_counter()
        with obs.recording(root / "a") as rec:
            res = batch.batch_analysis(model, hists, stats=st, **LADDER_KW)
        seconds["a"] = time.perf_counter() - t0
        launches["a"] = _launch_counts(wk)
        events = rec.events
        rolled = json.loads((root / "a" / "telemetry.json").read_text())
        jsonl = root / "a" / "telemetry.jsonl"
        if _verdicts(res) != _verdicts(ladder_results):
            raise AssertionError(
                "telemetry[a]: verdicts differ from phase 5's")
        # a recorded run ends with the dedup probe at its first rung's
        # shape; its keep-mask launches (one untimed call and ``rounds``
        # timed ones of the kernel-routed "fused" probe) are not the
        # ladder's
        probe = sum(int(e["attrs"]["rounds"]) + 1 for e in events
                    if e.get("name") == "dedup.round"
                    and e["attrs"].get("interpret") is False)
        ladder_only = dict(launches["a"],
                           keep_mask=launches["a"]["keep_mask"] - probe)
        for name in ("keep_mask", "fused_frontier_update"):
            if ladder_only[name] != ladder_counts[name]:
                raise AssertionError(
                    f"telemetry[a]: {name} launched {ladder_only[name]} "
                    f"times (probe {probe} excluded), phase 5 "
                    f"{ladder_counts[name]}")
        rows = rolled["ladder"]
        if [(r["stage"], r["engine"], r["capacity"]) for r in rows] != [
                (r["stage"], r["engine"], r["capacity"]) for r in st["rungs"]]:
            raise AssertionError(f"telemetry[a]: stage rows {rows} against "
                                 f"the rungs {st['rungs']}")
        for r in rows:
            n_exec = r["launches"] - r["compile_launches"]
            if (r["launches"] < 1 or n_exec < 0
                    or r["compile_launches"] + n_exec != r["launches"]
                    or not r.get("device_bytes_peak", 0) > 0):
                raise AssertionError(f"telemetry[a]: stage row {r}")
        launch_spans = [e for e in events if e.get("type") == "span"
                        and e["name"] == "ladder.launch"]
        if not launch_spans or any(e["attrs"].get("devices") != [0]
                                   for e in launch_spans):
            raise AssertionError("telemetry[a]: ladder.launch spans without "
                                 "devices == [0]")
        unknowns = sum(1 for r in ladder_results if r["valid?"] == "unknown")
        final = [e["value"] for e in events if e.get("type") == "gauge"
                 and e["name"] == "ladder.unknowns_remaining"]
        if not final or final[-1] != unknowns:
            raise AssertionError(f"telemetry[a]: final unknowns_remaining "
                                 f"{final[-1:]} against phase 5's {unknowns}")
        tl = critpath.device_timeline(events)
        cp = rolled["critpath"]["spans"][:5]
        print(f"telemetry[a]: the bench ladder recorded {seconds['a']:.3f} s "
              f"against phase 5's {ladder_seconds:.3f} s (unrecorded; the "
              f"recorded run adds the dedup probe); verdicts and kernel "
              f"launches phase 5's ({probe} probe keep-mask launches "
              f"apart); {len(events)} events, telemetry.jsonl "
              f"{jsonl.stat().st_size} bytes; device 0 busy "
              f"{tl['devices'][0]['busy_s']} of {tl['window_s']} s "
              f"({tl['devices'][0]['busy_frac']}) over "
              f"{tl['devices'][0]['launches']} launches; launches "
              f"{launches['a']}; {card}", flush=True)
        text = summary.format_summary(rolled).splitlines()
        at = text.index("ladder stages:")
        for line in text[at:at + 2 + len(rows) + 1]:
            print("telemetry[a]: " + line, flush=True)
        print("telemetry[a]: critical path, the five longest: " + json.dumps(
            [[r["span"], r["cp_s"]] for r in cp]), flush=True)

        # (b) the single-history path: bench 3 and 7 corrupted
        wk.reset_counts()
        t0 = time.perf_counter()
        with obs.recording(root / "b") as rec:
            res_b = [wgl.analysis(model, hists[i],
                                  capacity=SINGLE_DEFAULT_LADDER, fast=True,
                                  dedup_backend="fused", device=dev)
                     for i in DECIDED_BENCH]
        seconds["b"] = time.perf_counter() - t0
        launches["b"] = _launch_counts(wk)
        chunk = {}
        for e in rec.events:
            if (e.get("type") == "counter"
                    and e["name"].startswith("wgl.chunk.")):
                chunk[e["name"]] = chunk.get(e["name"], 0) + e["n"]
        gauges = [e["value"] for e in rec.events if e.get("type") == "gauge"
                  and e["name"] == "device.buffer_bytes"
                  and e["attrs"].get("at") == "wgl-chunk"]
        if (any(r["valid?"] is not False for r in res_b) or not chunk
                or not gauges or min(gauges) <= 0):
            raise AssertionError(f"telemetry[b]: verdicts "
                                 f"{[r['valid?'] for r in res_b]}, counters "
                                 f"{chunk}, wgl-chunk gauges {gauges}")
        print(f"telemetry[b]: wgl.analysis(fast=True) on bench "
              f"{list(DECIDED_BENCH)} corrupted, refuted, {seconds['b']:.3f} "
              f"s; counters {json.dumps(chunk)}; device.buffer_bytes at "
              f"wgl-chunk {len(gauges)} samples, {min(gauges)}-"
              f"{max(gauges)} bytes; launches {launches['b']}; {card}",
              flush=True)

        # (c) the checkers: independent "tpu" on bench keys 0-7, and
        # config 3c's check_batch with the cycle phase on the card
        keys = list(range(EVIDENCE_KEYS))
        keyed = _keyed(independent, hists, keys)
        chk = independent.checker(lin.linearizable(
            {"model": "cas-register", "algorithm": "tpu", "device": dev,
             "kernel-opts": {"capacity": CAPS}}))
        txns = [gentxn.append_history(PER_KEY_TXNS, n_keys=PER_KEY_KEYS,
                                      n_procs=PER_KEY_PROCS,
                                      seed=PER_KEY_SEED + i)
                for i in range(PER_KEY_GRAPHS)]
        wk.reset_counts()
        prev = elle.CYCLE_BACKEND
        t0 = time.perf_counter()
        try:
            with obs.recording(root / "c") as rec:
                res_c = checker.check_safe(chk, {}, keyed, {})
                elle.CYCLE_BACKEND = "device"
                outs = elle.ListAppendChecker(device=dev).check_batch(
                    {}, txns, {})
        finally:
            elle.CYCLE_BACKEND = prev
        seconds["c"] = time.perf_counter() - t0
        launches["c"] = _launch_counts(wk)
        checks = [e for e in rec.events if e.get("type") == "span"
                  and e["name"] == "checker.check"]
        scc_dev = [e for e in rec.events if e.get("type") == "span"
                   and e["name"] == "elle.scc"
                   and e["attrs"].get("backend") == "device"]
        per_key = [res_c["results"][k]["valid?"] for k in keys]
        differ = [k for k, v in zip(keys, per_key)
                  if "unknown" not in (v, ladder_results[k]["valid?"])
                  and v != ladder_results[k]["valid?"]]
        if (_errors(res_c) or len(checks) != 1 or differ
                or not scc_dev or len(outs) != PER_KEY_GRAPHS):
            raise AssertionError(
                f"telemetry[c]: {len(checks)} checker.check spans, per-key "
                f"{per_key} (differ from phase 5 at {differ}), "
                f"{len(scc_dev)} device elle.scc spans, errors "
                f"{_errors(res_c)[:3]}")
        elle_rows = json.loads(
            (root / "c" / "telemetry.json").read_text())["elle"]
        print(f"telemetry[c]: check_safe(independent(linearizable tpu)) on "
              f"bench keys 0-{keys[-1]} ({checks[0]['dur']} s, one "
              f"checker.check span, verdicts {per_key}, none against phase "
              f"5's) and config 3c's "
              f"check_batch on the card ({len(scc_dev)} device elle.scc "
              f"span, {scc_dev[0]['dur']} s); elle table "
              f"{json.dumps(elle_rows)}; {seconds['c']:.3f} s; launches "
              f"{launches['c']}; {card}", flush=True)

        # (d) (a)'s stream as a Chrome/Perfetto trace
        t0 = time.perf_counter()
        raw, skipped = trace.read_jsonl_events(jsonl)
        doc = json.loads(json.dumps(trace.to_trace_events(
            raw, skipped_lines=skipped)))
        tev = doc["traceEvents"]
        lanes = {e["tid"]: e["args"]["name"] for e in tev
                 if e.get("ph") == "M" and e.get("name") == "thread_name"}
        dev_lanes = [t for t, n in lanes.items() if n.startswith("device ")]
        on_dev0 = sum(1 for e in tev if e.get("ph") == "X"
                      and e["name"] == "ladder.launch"
                      and lanes.get(e["tid"]) == "device 0")
        tracks = sorted({e["name"] for e in tev if e.get("ph") == "C"})
        seconds["d"] = time.perf_counter() - t0
        if (skipped or [lanes[t] for t in dev_lanes] != ["device 0"]
                or on_dev0 != len(launch_spans)
                or not {"ladder.unknowns_remaining",
                        "device.buffer_bytes"} <= set(tracks)):
            raise AssertionError(f"telemetry[d]: lanes {lanes}, "
                                 f"{on_dev0} launches on device 0 of "
                                 f"{len(launch_spans)}, tracks {tracks}, "
                                 f"skipped {skipped}")
        print(f"telemetry[d]: trace export of (a): {len(tev)} trace events, "
              f"one device lane ('device 0') with all {on_dev0} "
              f"ladder.launch spans, counter tracks {tracks}; "
              f"{seconds['d']:.3f} s", flush=True)
    finally:
        tmp.cleanup()

    # (e) every recording closed: the phases before ran, and what runs
    # after runs, the no-op path only
    if obs.active() is not None or obs.observing():
        raise AssertionError("telemetry[e]: a recording is still open")
    print(f"telemetry[e]: no recording open after the phase (obs.active() "
          f"None, obs.observing() False)", flush=True)
    print(f"telemetry: phase 12 {time.perf_counter() - t_phase:.3f} s "
          f"(a {seconds['a']:.3f}, b {seconds['b']:.3f}, c "
          f"{seconds['c']:.3f}, d {seconds['d']:.3f}); {card}", flush=True)
    return launches


def _pcts(xs) -> str:
    """p50 and p99 (nearest rank) of ``xs`` in seconds, as text."""
    if not xs:
        return "-"
    xs = sorted(xs)

    def q(f):
        return xs[min(len(xs) - 1, max(0, int(round(f * len(xs) + 0.5)) - 1))]

    return f"p50 {q(0.50):.4f} p99 {q(0.99):.4f}"


def _serve_agree(tag: str, got: dict, want: list) -> int:
    """Each decided verdict of ``want`` (by bench index) equal in
    ``got``; returns the unknowns of ``got``."""
    differ = [i for i, r in got.items() if want[i]["valid?"] != "unknown"
              and r["valid?"] != want[i]["valid?"]]
    if differ:
        raise AssertionError(
            f"{tag}: verdicts differ from the reference at bench histories "
            f"{differ}: {[(i, got[i]['valid?'], want[i]['valid?']) for i in differ]}")
    return sum(1 for r in got.values() if r["valid?"] == "unknown")


def _wait_for_rung(rec, t_limit: float = 300.0) -> float:
    """Poll a recording until a running ladder reports its first rung
    (the feeder's ``serve.rung_occupancy`` gauge); returns the seconds
    waited."""
    t0 = time.perf_counter()
    while not any(e.get("name") == "serve.rung_occupancy"
                  for e in list(rec.events)):
        if time.perf_counter() - t0 > t_limit:
            raise AssertionError(f"no rung boundary in {t_limit} s")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _groups(batch, wgl, model, hists) -> list:
    """Each history's padded geometry bucket (the service's batch key
    less the model)."""
    out = []
    for hh in hists:
        p = wgl.pack(model, hh)
        out.append(batch.bucket_geometry(p["B"], p["P"], p["G"]))
    return out


def run_serve(dev, batch, wk, wgl, mesh_mod, genhist, model, hists,
              ladder_results, ladder_seconds, mesh_results, card) -> dict:
    """Phase 13: the check service on the card (see the module
    docstring); returns the kernels' launch counts of each sub-phase."""
    import collections
    import tempfile
    import threading

    from jepsen_tpu_torch import faults, obs, serve
    from jepsen_tpu_torch.checker import elle
    from jepsen_tpu_torch.obs import critpath
    from jepsen_tpu_torch.obs import metrics
    from jepsen_tpu_torch.serve import health
    from jepsen_tpu_torch.store import durable
    from jepsen_tpu_torch.testing import gentxn

    kw = {k: v for k, v in LADDER_KW.items() if k != "capacity"}
    launches: dict = {}
    seconds: dict = {}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")
    root = Path(tmp.name)
    groups = _groups(batch, wgl, model, hists)
    by_group: dict = {}
    for i, g in enumerate(groups):
        by_group.setdefault(g, []).append(i)
    big = sorted(by_group.values(), key=len, reverse=True)
    greedy = [i for i, r in enumerate(ladder_results)
              if r["valid?"] is True
              and (r.get("kernel") or {}).get("capacity") == 1]
    unknown = [i for i, r in enumerate(ladder_results)
               if r["valid?"] == "unknown"]

    def with_hard(group, n):
        """``n`` members of ``group``, one of them a history phase 5 took
        to its top rung or left unknown (so the ladder runs past rung 0)."""
        hard = [i for i in group if ladder_results[i]["valid?"] == "unknown"
                or (ladder_results[i].get("kernel") or {}).get(
                    "capacity") == CAPS[-1]]
        return (hard[:1] + [i for i in group if i not in hard[:1]])[:n]
    try:
        # (a) four tenants, two interactive and two batch
        wk.reset_counts()
        t0 = time.perf_counter()
        with obs.recording(root / "a") as rec:
            svc = serve.CheckService(
                capacity=CAPS, max_batch=N_HISTORIES, warm_pool=True,
                evidence_dir=root / "a_evidence",
                journal_dir=root / "a_journal", **kw).start()
            futs: dict = {}
            go = threading.Barrier(len(SERVE_CLASSES))

            def tenant(k):
                go.wait()
                for j in range(SERVE_TENANT_HISTORIES):
                    i = k * SERVE_TENANT_HISTORIES + j
                    futs[i] = svc.submit(
                        hists[i], model=model, class_=SERVE_CLASSES[k],
                        priority=j % 3, client=f"tenant-{k}")

            threads = [threading.Thread(target=tenant, args=(k,))
                       for k in range(len(SERVE_CLASSES))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            if any(t.is_alive() for t in threads) or len(futs) != N_HISTORIES:
                raise AssertionError("serve[a]: the tenants did not submit")
            got = {i: f.result(timeout=600) for i, f in futs.items()}
            svc.shutdown(wait=True)
            st = svc.stats()
            tiers = {i: svc.get(futs[i].id).tier for i in futs}
            journal_left = svc.journal.depth()
        seconds["a"] = time.perf_counter() - t0
        launches["a"] = _launch_counts(wk)
        unk = _serve_agree("serve[a]", got, ladder_results)
        if unk > len(unknown):
            raise AssertionError(f"serve[a]: {unk} unknowns against phase 5's "
                                 f"{len(unknown)}")
        if st["batches"] < 1 or st["fastpath_resolved"] < 1:
            raise AssertionError(f"serve[a]: batches {st['batches']}, "
                                 f"fast-path resolved {st['fastpath_resolved']}")
        if st["completed"] != N_HISTORIES or journal_left:
            raise AssertionError(f"serve[a]: {st['completed']} completed, "
                                 f"{journal_left} journal entries left")
        rolled = json.loads((root / "a" / "telemetry.json").read_text())
        sv = rolled.get("serve") or {}
        if sv.get("batches", 0) < 1 or (sv.get("request") or {}).get(
                "count") != N_HISTORIES:
            raise AssertionError(f"serve[a]: telemetry.json's serve section "
                                 f"{sv}")
        parts = critpath.decompose_requests(rec.events)
        rows = list(parts.values())
        if len(parts) != N_HISTORIES:
            raise AssertionError(f"serve[a]: decompose_requests split "
                                 f"{len(parts)} requests of {N_HISTORIES}")
        # a rung joiner rides a launch whose span names its first
        # members only (as in the JAX package): its residence after the
        # join lands in other_s
        joiners = {e.get("trace") for e in rec.events
                   if e.get("name") == "serve.admission"
                   and "joined_at_rung" in (e.get("attrs") or {})}
        for tid, r in parts.items():
            s_ = sum(r[k] for k in ("route_s", "queue_s", "pack_s", "launch_s",
                                    "confirm_s", "other_s"))
            if abs(s_ - r["total_s"]) > 1e-5 or (
                    r["launch_span"] is None and tid not in joiners):
                raise AssertionError(f"serve[a]: request split {r}")
        lat = {t: {"queue": [], "total": []} for t in ("interactive", "batch")}
        for i, r in got.items():
            lat[tiers[i]]["queue"].append(r["latency"]["queue_s"])
            lat[tiers[i]]["total"].append(r["latency"]["total_s"])
        spans = [e for e in rec.events if e.get("type") == "span"
                 and e["name"] == "serve.batch"]
        print(f"serve[a]: {len(SERVE_CLASSES)} tenants x "
              f"{SERVE_TENANT_HISTORIES} bench histories (classes "
              f"{list(SERVE_CLASSES)}): verdicts phase 5's where phase 5 "
              f"decided, unknowns {unk} (phase 5 {len(unknown)}); batches "
              f"{st['batches']}, avg occupancy {st['avg_occupancy']}, "
              f"padding waste {round(1 - (st['avg_occupancy'] or 0), 4)}, "
              f"continuous occupancy {st['continuous_occupancy']}, fast path "
              f"resolved {st['fastpath_resolved']} escalated "
              f"{st['escalated']}; launches {launches['a']}; {card}",
              flush=True)
        for t, d in lat.items():
            print(f"serve[a]: {t}: {len(d['total'])} requests, admission "
                  f"{_pcts(d['queue'])} s, request {_pcts(d['total'])} s",
                  flush=True)
        # what one durable write costs in this temp dir: the journal
        # writes one per ladder request at admission, the evidence dir
        # one per settled request on the serving threads
        probe = root / "a_durable_probe"
        probe.mkdir()
        writes = []
        for k in range(SERVE_TENANT_HISTORIES):
            t1 = time.perf_counter()
            durable.write_record(probe / f"r{k}.json", serve.service.KIND_DRAIN,
                                 {"k": k})
            writes.append(time.perf_counter() - t1)
        print(f"serve[a]: one durable write (tmp, fsync, rename, dir fsync) "
              f"in the sub-phase's directory: {_pcts(writes)} s over "
              f"{len(writes)} writes", flush=True)
        print(f"serve[a]: {seconds['a']:.3f} s for the sub-phase, ladders "
              f"(serve.batch spans) {sum(e['dur'] for e in spans):.3f} s over "
              f"{len(spans)} batches, against phase 5's ladder "
              f"{ladder_seconds:.3f} s; every request split into queue, pack, "
              f"launch and demux (decompose_requests: {len(parts)} rows, "
              f"{len(joiners)} rung joiners, launch spans "
              f"{json.dumps(collections.Counter(r['launch_span'] for r in rows))})",
              flush=True)

        # (b) a second wave joins the running ladder at a rung boundary
        g1 = big[0]
        wave1 = with_hard(g1, SERVE_WAVE)
        wave2 = [i for i in g1 if i not in wave1][:SERVE_WAVE]
        wk.reset_counts()
        t0 = time.perf_counter()
        with obs.recording(root / "b") as rec:
            svc = serve.CheckService(capacity=CAPS, max_batch=N_HISTORIES,
                                     warm_pool=True, **kw)
            futs = {i: svc.submit(hists[i], model=model) for i in wave1}
            svc.start()
            waited = _wait_for_rung(rec)
            futs.update({i: svc.submit(hists[i], model=model) for i in wave2})
            got = {i: f.result(timeout=600) for i, f in futs.items()}
            svc.shutdown(wait=True)
            st = svc.stats()
        seconds["b"] = time.perf_counter() - t0
        launches["b"] = _launch_counts(wk)
        joined = sum(int(e.get("value", e.get("n", 1)) or 1)
                     for e in rec.events if e.get("name") == "serve.rung_joined")
        unk = _serve_agree("serve[b]", got, ladder_results)
        if joined < 1:
            raise AssertionError("serve[b]: no request joined a running ladder")
        print(f"serve[b]: wave of {len(wave2)} submitted {waited:.3f} s after "
              f"the first ({len(wave1)} histories of geometry {groups[g1[0]]}), "
              f"once its ladder passed rung 0: serve.rung_joined {joined}, "
              f"batches {st['batches']}, verdicts phase 5's where phase 5 "
              f"decided, unknowns {unk}; {seconds['b']:.3f} s; launches "
              f"{launches['b']}; {card}", flush=True)

        # (c) shutdown(drain=True) at the first rung boundary, then resume
        running = with_hard(big[0], SERVE_WAVE)
        queued = big[1][:SERVE_WAVE]
        wk.reset_counts()
        t0 = time.perf_counter()
        drain_dir = root / "c_drain"
        with obs.recording(root / "c") as rec:
            svc = serve.CheckService(capacity=CAPS, max_batch=SERVE_WAVE,
                                     warm_pool=True, drain_dir=drain_dir, **kw)
            futs = {i: svc.submit(hists[i], model=model)
                    for i in running + queued}
            svc.start()
            _wait_for_rung(rec)
            t_drain = time.perf_counter()
            summary = svc.shutdown(drain=True)
            drain_s = time.perf_counter() - t_drain
            got = {i: f.result(timeout=60) for i, f in futs.items()}
        drained = {i for i in futs if svc.get(futs[i].id).status == "drained"}
        if not drained or not summary["checkpoints"]:
            raise AssertionError(f"serve[c]: nothing drained: {summary}")
        by_id = {futs[i].id: i for i in futs}
        t_res = time.perf_counter()
        out = serve.resume_drained(drain_dir, capacity=CAPS, **kw)
        resume_s = time.perf_counter() - t_res
        resumed = {}
        for grp in out:
            if "error" in grp:
                raise AssertionError(f"serve[c]: corrupt drain group {grp}")
            for rid, r in zip(grp["ids"], grp["results"]):
                resumed[by_id[rid]] = r
        seconds["c"] = time.perf_counter() - t0
        launches["c"] = _launch_counts(wk)
        if set(resumed) != drained:
            raise AssertionError(f"serve[c]: resumed {sorted(resumed)} against "
                                 f"drained {sorted(drained)}")
        _serve_agree("serve[c]",
                     {i: r for i, r in got.items() if i not in drained},
                     ladder_results)
        unequal = [i for i, r in resumed.items()
                   if r["valid?"] != ladder_results[i]["valid?"]]
        _serve_agree("serve[c]", resumed, ladder_results)
        print(f"serve[c]: {len(futs)} histories, shutdown(drain=True) at the "
              f"first rung boundary: {len(futs) - len(drained)} settled by the "
              f"running ladder, {len(drained)} drained into "
              f"{len(summary['checkpoints'])} checkpoint(s) in {drain_s:.3f} s "
              f"(the running ladder's end included); resume_drained "
              f"{resume_s:.3f} s; drained verdicts against phase 5's: "
              f"{len(unequal)} not equal {unequal}; launches {launches['c']}; "
              f"{card}", flush=True)
        if unequal:
            raise AssertionError(f"serve[c]: resumed verdicts differ from "
                                 f"phase 5's at {unequal}")

        # (d) one poison member, isolated by bisection, then quarantined
        refuted = [i for i in big[0] if ladder_results[i]["valid?"] is False
                   and (ladder_results[i].get("kernel") or {}).get(
                       "capacity") == CAPS[0]]
        easy = [i for i in big[0] if i in set(greedy)]
        members = easy[:SERVE_POISON_MEMBERS - 2] + refuted[:2]
        poison = members[1]
        poison_fp = health.history_fingerprint(hists[poison])

        def poison_inj(ctx, attempt):
            if (ctx.get("what") == "serve.batch"
                    and poison_fp in (ctx.get("members") or ())):
                raise ValueError("injected poison member failure")

        wk.reset_counts()
        t0 = time.perf_counter()
        svc = serve.CheckService(capacity=CAPS, max_batch=N_HISTORIES,
                                 warm_pool=True, quarantine_ttl_s=600.0, **kw)
        with faults.inject_scope(poison_inj):
            futs = {i: svc.submit(hists[i], model=model) for i in members}
            svc.step()
        got = {i: f.result(timeout=60) for i, f in futs.items()}
        st = svc.stats()
        again = svc.submit(hists[poison], model=model).result(timeout=60)
        st2 = svc.stats()
        seconds["d"] = time.perf_counter() - t0
        launches["d"] = _launch_counts(wk)
        budget = health.bisect_launch_budget(len(members))
        quarantined = [i for i, r in got.items() if r.get("quarantined")]
        if (quarantined != [poison] or st["poison_isolated"] != 1
                or not 0 < st["bisect_launches"] <= budget
                or "bisection" not in got[poison]["cause"]):
            raise AssertionError(f"serve[d]: quarantined {quarantined} (poison "
                                 f"{poison}), stats {st}")
        _serve_agree("serve[d]",
                     {i: r for i, r in got.items() if i != poison},
                     ladder_results)
        if (not again.get("quarantined") or "repeat poison" not in again["cause"]
                or st2["bisect_launches"] != st["bisect_launches"]):
            raise AssertionError(f"serve[d]: the repeat submission gave {again}")
        print(f"serve[d]: {len(members)} members (bench {members}), poison "
              f"bench {poison}: isolated alone in {st['bisect_launches']} "
              f"launches (budget {budget}), the other {len(members) - 1} "
              f"verdicts phase 5's, breaker {st['breaker']['state']}; the "
              f"repeat submission quarantined at admission with no launch; "
              f"{seconds['d']:.3f} s; launches {launches['d']}; {card}",
              flush=True)

        # (e) a placement of 4 logical shards, parity, then a lost shard
        decided = [i for i in range(N_HISTORIES)
                   if groups[i] in {groups[u] for u in unknown}
                   and ladder_results[i]["valid?"] is not True
                   and ladder_results[i]["valid?"] != "unknown"][:5]
        picks = unknown + decided
        wk.reset_counts()
        t0 = time.perf_counter()
        with obs.recording(root / "e") as rec:
            svc = serve.CheckService(
                capacity=CAPS, devices=SERVE_SHARDS, verify_placement=True,
                health_probe_every_s=0.0, max_batch=N_HISTORIES,
                warm_pool=True, **kw)
            futs = {i: svc.submit(hists[i], model=model) for i in picks}
            while svc.stats()["queue_depth"]:
                svc.step()
            got = {i: f.result(timeout=60) for i, f in futs.items()}
            launches["e"] = _launch_counts(wk)
            t_mesh = time.perf_counter() - t0

            def lose_shard(ctx, attempt):
                # the shard is lost once: after the shrink, index 2 of
                # the new mesh is another shard
                if (ctx.get("what") == "placement.probe"
                        and svc._placement.generation == 0
                        and int(ctx.get("device", -1)) == SERVE_LOST_SHARD):
                    raise RuntimeError("injected shard loss")

            after = greedy[:4]
            with faults.inject_scope(lose_shard):
                futs2 = {i: svc.submit(hists[i], model=model) for i in after}
                while svc.stats()["queue_depth"]:
                    svc.step()
            got2 = {i: f.result(timeout=60) for i, f in futs2.items()}
            place = svc.stats()["placement"]
            lost = list(svc._placement.lost)
        seconds["e"] = time.perf_counter() - t0
        parity_ok = sum(1 for e in rec.events
                        if e.get("name") == "serve.placement_parity_ok")
        mismatch = sum(1 for e in rec.events
                       if e.get("name") == "serve.placement_parity_mismatch")
        if launches["e"]["mesh_exchange"] <= 0:
            raise AssertionError(f"serve[e]: no exchange launch: "
                                 f"{launches['e']}")
        if parity_ok < 1 or mismatch:
            raise AssertionError(f"serve[e]: placement parity ok {parity_ok}, "
                                 f"mismatch {mismatch}")
        differ = [i for i in picks if got[i]["valid?"] != mesh_results[i]["valid?"]]
        if differ:
            raise AssertionError(
                f"serve[e]: verdicts differ from phase 7's at {differ}: "
                f"{[(i, got[i]['valid?'], mesh_results[i]['valid?']) for i in differ]}")
        _serve_agree("serve[e]", got2, ladder_results)
        if (place.get("devices") != SERVE_SHARDS - 1
                or place.get("generation") != 1 or lost != [SERVE_LOST_SHARD]
                or any(r["valid?"] == "unknown" for r in got2.values())):
            raise AssertionError(f"serve[e]: after the lost shard {place}, "
                                 f"lost {lost}, verdicts {got2}")
        print(f"serve[e]: devices={SERVE_SHARDS}, verify_placement, fused: "
              f"bench {picks} (phase 5's unknowns {unknown}) -> "
              f"{json.dumps([got[i]['valid?'] for i in picks])}, phase 7's; "
              f"serve.placement_parity_ok {parity_ok}; {t_mesh:.3f} s, "
              f"launches {launches['e']}; shard {SERVE_LOST_SHARD} failed its "
              f"probe: placement {json.dumps(place)}, lost {lost}, the next "
              f"batch (bench {after}) decided "
              f"{json.dumps([got2[i]['valid?'] for i in after])}; "
              f"{seconds['e']:.3f} s; {card}", flush=True)

        # (f) the graph lane: config 3c on the card's closure
        txns = [gentxn.append_history(PER_KEY_TXNS, n_keys=PER_KEY_KEYS,
                                      n_procs=PER_KEY_PROCS,
                                      seed=PER_KEY_SEED + i)
                for i in range(SERVE_GRAPHS)]
        chk = elle.ListAppendChecker()
        wk.reset_counts()
        prev = elle.CYCLE_BACKEND
        t0 = time.perf_counter()
        try:
            elle.CYCLE_BACKEND = "device"
            with obs.recording(root / "f") as rec:
                svc = serve.CheckService(capacity=CAPS, warm_pool=False, **kw)
                gfuts = [svc.submit(t, checker=chk) for t in txns]
                svc.step()
                gres = [f.result(timeout=120) for f in gfuts]
                st = svc.stats()
            direct = chk.check_batch({}, txns, {"device": dev})
        finally:
            elle.CYCLE_BACKEND = prev
        seconds["f"] = time.perf_counter() - t0
        launches["f"] = _launch_counts(wk)
        gb = sum(1 for e in rec.events if e.get("name") == "serve.graph_batches")
        scc_dev = sum(1 for e in rec.events if e.get("type") == "span"
                      and e["name"] == "elle.scc"
                      and e["attrs"].get("backend") == "device")
        keep = ("valid?", "anomaly-types", "anomalies", "not", "also-not")
        unequal = [k for k, (a, b) in enumerate(zip(gres, direct))
                   if {x: a.get(x) for x in keep} != {x: b.get(x) for x in keep}]
        if st["graph_batches"] != 1 or gb != 1 or unequal or not scc_dev:
            raise AssertionError(f"serve[f]: graph batches {st['graph_batches']}"
                                 f" (events {gb}), device scc spans {scc_dev}, "
                                 f"results unequal at {unequal}")
        print(f"serve[f]: {SERVE_GRAPHS} config-3c histories (seeds "
              f"{PER_KEY_SEED}-{PER_KEY_SEED + SERVE_GRAPHS - 1}) on the graph "
              f"lane, CYCLE_BACKEND device: one check_batch for the one batch "
              f"key (serve.graph_batches {gb}), {scc_dev} device elle.scc "
              f"span(s), results equal a direct check_batch, valid "
              f"{sum(1 for r in gres if r['valid?'] is True)}; "
              f"{seconds['f']:.3f} s; {card}", flush=True)

        # (g) a stream: bench 3 (corrupted) fed in epochs
        wk.reset_counts()
        t0 = time.perf_counter()
        svc = serve.CheckService(capacity=CAPS, warm_pool=False, **kw)
        sid = svc.stream_open(model=model)["stream-id"]
        h3 = hists[3]
        for k in range(0, len(h3), STREAM_FEED_OPS):
            svc.stream_feed(sid, h3[k: k + STREAM_FEED_OPS], seq=k)
        closed = svc.stream_close(sid)
        seconds["g"] = time.perf_counter() - t0
        launches["g"] = _launch_counts(wk)
        if (closed["result"]["valid?"] is not False
                or ladder_results[3]["valid?"] is not False):
            raise AssertionError(f"serve[g]: stream verdict "
                                 f"{closed['result']['valid?']}, phase 5 "
                                 f"{ladder_results[3]['valid?']}")
        print(f"serve[g]: bench 3 streamed in epochs of {STREAM_FEED_OPS} ops "
              f"({len(h3)} ops): False, as phase 5; {seconds['g']:.3f} s; "
              f"launches {launches['g']}; {card}", flush=True)
    finally:
        metrics.enable_mirror(False)
        tmp.cleanup()

    total = {n: sum(c[n] for c in launches.values())
             for n in ("keep_mask", "fused_frontier_update", "mesh_exchange")}
    for name, c in total.items():
        if c <= 0:
            raise AssertionError(f"serve: {name} was not launched in phase 13")
    if obs.active() is not None or obs.observing():
        raise AssertionError("serve: a recording or the metrics mirror is "
                             "still open after phase 13")
    print(f"serve: phase 13 {time.perf_counter() - t_phase:.3f} s, seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}, "
          f"launches {total}; {card}", flush=True)
    return launches


def _http(port: int, method: str, path: str, body=None, *,
          ndjson: bool = False, length: int | None = None):
    """One HTTP call to the phase's server: ``(status, headers, doc)``,
    ``doc`` the parsed JSON body (or the text); ``length`` claims a
    Content-Length and sends no body."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        if length is not None:
            c.putrequest(method, path)
            c.putheader("Content-Type", "application/json")
            c.putheader("Content-Length", str(length))
            c.endheaders()
        else:
            data = None
            if body is not None:
                data = ("\n".join(json.dumps(x) for x in body) if ndjson
                        else json.dumps(body)).encode()
            c.request(method, path, body=data, headers={
                "Content-Type": "application/x-ndjson" if ndjson
                else "application/json"})
        r = c.getresponse()
        raw = r.read()
        headers = dict(r.getheaders())
    finally:
        c.close()
    try:
        return r.status, headers, json.loads(raw)
    except ValueError:
        return r.status, headers, raw.decode("utf-8", "replace")


def _expect(tag: str, got, status: int):
    if got[0] != status:
        raise AssertionError(f"{tag}: HTTP {got[0]} (expected {status}): "
                             f"{str(got[2])[:400]}")
    return got[2]


def _capture_kind(profiler) -> str:
    """What the hook's captures record here, in words."""
    acts = profiler.capture_config()["activities"]
    return "of " + " and ".join(
        {"CUDA": "the card's activity", "CPU": "the host's ops"}.get(
            a.name, a.name) for a in acts)


def run_web(wk, hists, ladder_results, card) -> dict:
    """Phase 14: the check service's HTTP API on the card (see the
    module docstring); returns the kernels' launch counts of each
    sub-phase."""
    import tempfile
    import threading

    from jepsen_tpu_torch import independent, native, obs, serve, store, web
    from jepsen_tpu_torch.obs import metrics, profiler, provenance, regress

    kw = {k: v for k, v in LADDER_KW.items() if k != "capacity"}
    launches: dict = {}
    seconds: dict = {}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_web_")
    root = Path(tmp.name)
    store_dir = root / "store"
    store_dir.mkdir()
    inter = list(range(WEB_INTERACTIVE))
    batch_ids = list(range(WEB_INTERACTIVE, WEB_INTERACTIVE + WEB_BATCH))
    svc = srv = None
    hook = profiler.ProfilerHook(root / "profile", max_seconds=120)
    # a phase that hangs fails, with every thread's stack on stderr
    faulthandler.dump_traceback_later(WEB_LIMIT_S, exit=True)
    try:
        # (a) the server, with the service and the profiler hook mounted
        wk.reset_counts()
        t0 = time.perf_counter()
        svc = serve.CheckService(capacity=CAPS, warm_pool=True,
                                 evidence_dir=root / "evidence", **kw).start()
        srv = web.make_server("127.0.0.1", 0, str(store_dir),
                              check_service=svc, profiler=hook,
                              max_request_mb=WEB_MAX_REQUEST_MB)
        port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        t1 = time.perf_counter()
        health = _expect("web[a] /healthz", _http(port, "GET", "/healthz"), 200)
        health_idle_s = time.perf_counter() - t1
        ready = _expect("web[a] /readyz", _http(port, "GET", "/readyz"), 200)
        if health.get("ok") is not True or ready.get("ready") is not True:
            raise AssertionError(f"web[a]: {health} {ready}")
        seconds["a"] = time.perf_counter() - t0
        launches["a"] = _launch_counts(wk)
        print(f"web[a]: server on 127.0.0.1:{port} with a CheckService "
              f"(phase 5's ladder options) and a profiler hook: /healthz "
              f"200 in {health_idle_s:.6f} s, /readyz 200 (breaker "
              f"{ready['breaker']['state']}); {seconds['a']:.3f} s; {card}",
              flush=True)

        # (b) two bounded captures while the service runs one ladder (a
        # capture over (c) would hold ~10^6 launches, and its stop holds
        # the GIL while it writes them: PERF.md, PR 13): one second of the
        # narrow rungs, stopped by the hook's watchdog on its timer
        # thread, and the top rung, started when the fused update first
        # launches and stopped over HTTP when the request returns
        wk.reset_counts()
        t0 = time.perf_counter()
        box: dict = {}

        def profiled():
            box["doc"] = _http(port, "POST", "/check", {
                "history": hists[WEB_PROFILE_HISTORY], "model": "cas-register",
                "class": "batch", "wait": True, "client": "chip-smoke"})

        req = threading.Thread(target=profiled)
        req.start()
        while svc.stats()["running"] < 1 and req.is_alive():
            time.sleep(0.005)
        time.sleep(WEB_PROFILE_NARROW_DELAY_S)
        narrow = _expect("web[b] /profile/start", _http(
            port, "POST", "/profile/start",
            {"seconds": WEB_PROFILE_NARROW_S}), 200)
        while _http(port, "GET", "/profile")[2]["profiling"]:
            time.sleep(0.05)
        fused0 = wk.FUSED_LAUNCHES
        while wk.FUSED_LAUNCHES == fused0 and req.is_alive():
            time.sleep(0.01)
        top = _expect("web[b] /profile/start", _http(
            port, "POST", "/profile/start", {"seconds": WEB_PROFILE_S}), 200)
        req.join(timeout=600)
        t1 = time.perf_counter()
        stop = _expect("web[b] /profile/stop", _http(
            port, "POST", "/profile/stop"), 200)
        t_stop = time.perf_counter() - t1
        res = _expect(f"web[b] bench {WEB_PROFILE_HISTORY}", box["doc"], 200)
        if res["result"]["valid?"] != ladder_results[WEB_PROFILE_HISTORY][
                "valid?"]:
            raise AssertionError(f"web[b]: bench {WEB_PROFILE_HISTORY}: "
                                 f"{res['result']['valid?']}, phase 5 "
                                 f"{ladder_results[WEB_PROFILE_HISTORY]['valid?']}")
        # each capture's window is the hook's: its elapsed time when it
        # stopped, which for the first is its watchdog's bound
        captures = {"narrow": (Path(narrow["capture_dir"]),
                               narrow["seconds"]),
                    "top": (Path(top["capture_dir"]),
                            stop["stopped"]["elapsed_s"])}
        seconds["b"] = time.perf_counter() - t0
        launches["b"] = _launch_counts(wk)
        print(f"web[b]: bench {WEB_PROFILE_HISTORY} (phase 5: "
              f"{ladder_results[WEB_PROFILE_HISTORY]['valid?']}) as one batch "
              f"POST /check with wait, the same over HTTP; captures "
              f"{_capture_kind(profiler)}: POST /profile/start "
              f"{{\"seconds\": {WEB_PROFILE_NARROW_S}}} "
              f"{WEB_PROFILE_NARROW_DELAY_S} s into the ladder, stopped by "
              f"the hook's watchdog; POST /profile/start "
              f"{{\"seconds\": {WEB_PROFILE_S}}} at the first fused update, "
              f"POST /profile/stop after {stop['stopped']['elapsed_s']} s "
              f"({t_stop:.3f} s to stop and write); {seconds['b']:.3f} s; "
              f"launches {launches['b']}; {card}", flush=True)

        # (c) bench 0-31 over POST /check: interactive waits, batch async
        wk.reset_counts()
        t0 = time.perf_counter()
        got: dict = {}
        wall: dict = {}
        ids: dict = {}
        rtt: dict = {}
        errors: list = []
        health_s: list = []
        wave_done = threading.Event()

        def health_probe():
            while not wave_done.wait(WEB_HEALTH_PROBE_S):
                t1 = time.perf_counter()
                got_h = _http(port, "GET", "/healthz")
                if got_h[0] == 200:
                    health_s.append(time.perf_counter() - t1)

        def interactive(i):
            t1 = time.perf_counter()
            try:
                d = _expect(f"web[c] bench {i}", _http(
                    port, "POST", "/check", {
                        "history": hists[i], "model": "cas-register",
                        "class": "interactive", "wait": True,
                        "client": "chip-smoke"}), 200)
                got[i], ids[i] = d["result"], d["id"]
                wall[i] = time.perf_counter() - t1
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(repr(e))

        def submit(i):
            """A batch request, then its own poll of GET /check/<id>; the
            POST's and the last GET's round trips are HTTP's own share."""
            try:
                t1 = time.perf_counter()
                d = _expect(f"web[c] bench {i}", _http(
                    port, "POST", "/check", {
                        "history": hists[i], "model": "cas-register",
                        "class": "batch", "client": "chip-smoke",
                        "idempotency_key": f"bench-{i}"}), 202)
                post_s = time.perf_counter() - t1
                ids[i] = d["id"]
                while True:
                    t2 = time.perf_counter()
                    d = _expect(f"web[c] GET /check/{ids[i]}", _http(
                        port, "GET", f"/check/{ids[i]}"), 200)
                    if d["status"] in ("done", "error"):
                        rtt[i] = post_s + time.perf_counter() - t2
                        break
                    if time.perf_counter() - t1 > 600:
                        raise AssertionError(f"bench {i} still {d['status']}")
                    time.sleep(WEB_POLL_S)
                if d["status"] != "done":
                    raise AssertionError(f"bench {i}: {d}")
                got[i] = d["result"]
                wall[i] = time.perf_counter() - t1
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(repr(e))

        threads = [threading.Thread(target=interactive, args=(i,))
                   for i in inter]
        threads += [threading.Thread(target=submit, args=(i,))
                    for i in batch_ids]
        probe = threading.Thread(target=health_probe, daemon=True)
        probe.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wave_done.set()
        probe.join(timeout=60)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"web[c]: {errors[:3]}")
        unk = _serve_agree("web[c]", got, ladder_results)
        phase5_unk = sum(1 for i in got
                         if ladder_results[i]["valid?"] == "unknown")
        if unk > phase5_unk:
            raise AssertionError(f"web[c]: {unk} unknowns against phase 5's "
                                 f"{phase5_unk}")
        again = _expect("web[c] resubmit", _http(port, "POST", "/check", {
            "history": hists[batch_ids[0]], "model": "cas-register",
            "class": "batch", "idempotency_key": f"bench-{batch_ids[0]}"}),
            200)
        if again["id"] != ids[batch_ids[0]]:
            raise AssertionError(f"web[c]: the resubmission got id "
                                 f"{again['id']}, not {ids[batch_ids[0]]}")
        refuted = [i for i in sorted(got) if got[i]["valid?"] is False]
        bundle = _expect("web[c] /evidence", _http(
            port, "GET", f"/evidence/{ids[refuted[0]]}"), 200)
        rep = provenance.verify_bundle(bundle)
        if not rep["ok"]:
            raise AssertionError(f"web[c]: the evidence bundle of bench "
                                 f"{refuted[0]} fails: {rep['errors']}")
        queue = _expect("web[c] /queue", _http(port, "GET", "/queue"), 200)
        alerts = _expect("web[c] /alerts", _http(port, "GET", "/alerts"), 200)
        big = _expect("web[c] oversized", _http(
            port, "POST", "/check",
            length=int(2 * WEB_MAX_REQUEST_MB * 1024 * 1024)), 413)
        seconds["c"] = time.perf_counter() - t0
        launches["c"] = _launch_counts(wk)
        for name in ("keep_mask", "fused_frontier_update"):
            if launches["c"][name] <= 0:
                raise AssertionError(f"web[c]: {name} was not launched behind "
                                     f"POST /check")
        print(f"web[c]: bench 0-{WEB_INTERACTIVE + WEB_BATCH - 1} over POST "
              f"/check ({WEB_INTERACTIVE} interactive with wait, {WEB_BATCH} "
              f"batch async polled by GET /check/<id>): verdicts phase 5's "
              f"where phase 5 decided, unknowns {unk} (phase 5 {phase5_unk}); "
              f"the idempotent resubmission got its id back; GET /evidence of "
              f"bench {refuted[0]} passes verify_bundle; /queue completed "
              f"{queue['completed']}, batches {queue['batches']}; /alerts "
              f"{len(alerts['alerts'])} firing; a {big['bytes']}-byte body "
              f"413; {seconds['c']:.3f} s; launches {launches['c']}; {card}",
              flush=True)
        for tier, members in (("interactive", inter), ("batch", batch_ids)):
            http_s = [wall[i] for i in members]
            svc_s = [got[i]["latency"]["total_s"] for i in members]
            if tier == "interactive":
                extra = [a - b for a, b in zip(http_s, svc_s)]
                own = f"HTTP beyond it {_pcts(extra)} s"
            else:
                own = (f"the POST and the last GET round trips "
                       f"{_pcts([rtt[i] for i in members])} s (the rest "
                       f"beyond the service is the client's poll every "
                       f"{WEB_POLL_S} s)")
            print(f"web[c]: {tier}: {len(members)} requests, over HTTP "
                  f"{_pcts(http_s)} s, the service's own latency "
                  f"{_pcts(svc_s)} s, {own}", flush=True)
        print(f"web[c]: GET /healthz every {WEB_HEALTH_PROBE_S} s under the "
              f"wave: {len(health_s)} round trips, "
              f"{_pcts(health_s)} s (idle in (a): "
              f"{health_idle_s:.6f} s)", flush=True)

        # (d) bench 3 as one NDJSON POST /stream
        wk.reset_counts()
        t0 = time.perf_counter()
        closed = _expect("web[d] /stream", _http(
            port, "POST", "/stream",
            [{"model": "cas-register", "client": "chip-smoke"}, *hists[3],
             {"end": True}], ndjson=True), 200)
        seconds["d"] = time.perf_counter() - t0
        launches["d"] = _launch_counts(wk)
        if (closed["result"]["valid?"] is not False
                or ladder_results[3]["valid?"] is not False):
            raise AssertionError(f"web[d]: stream verdict "
                                 f"{closed['result']['valid?']}, phase 5 "
                                 f"{ladder_results[3]['valid?']}")
        print(f"web[d]: bench 3 ({len(hists[3])} ops) as one NDJSON POST "
              f"/stream: False, as phase 5; {seconds['d']:.3f} s; launches "
              f"{launches['d']}; {card}", flush=True)

        # (e) the captures: the port's kernels, the device's busy share
        wk.reset_counts()
        t0 = time.perf_counter()
        summs: dict = {}
        for tag, (cdir, wall_s) in captures.items():
            trace = cdir / profiler.TRACE_FILE
            if not trace.is_file():
                raise AssertionError(f"web[e]: the {tag} capture wrote no "
                                     f"{profiler.TRACE_FILE}")
            size = trace.stat().st_size
            t1 = time.perf_counter()
            summ = profiler.device_summary(trace, wall_s=wall_s)
            t_read = time.perf_counter() - t1
            ours: dict = {}
            for name, n in summ["kernels"].items():
                short = name.replace("(anonymous namespace)::", "").replace(
                    "void ", "").split("(")[0].split("<")[0]
                if short.startswith("k_"):
                    ours[short] = ours.get(short, 0) + n
            trace.unlink()
            summs[tag] = summ
            print(f"web[e]: the {tag} capture: {size / 1e6:.1f} MB (read "
                  f"{t_read:.3f} s), {summ['device_events']} device events; "
                  f"the port's kernels {json.dumps(ours)}; device busy "
                  f"{summ['busy_s']} s (kernels and copies summed "
                  f"{summ['sum_s']} s) of {summ['wall_s']} s: busy share "
                  f"{summ['busy_share']}; {card}", flush=True)
            if tag == "top" and not any(k in ours for k in WIDE_KERNEL_NAMES):
                raise AssertionError(f"web[e]: the top-rung capture holds no "
                                     f"kernel of wide_kernel.cu: {sorted(ours)}")
        seconds["e"] = time.perf_counter() - t0
        launches["e"] = _launch_counts(wk)

        # (f) phase 5's first histories and results as a stored run
        wk.reset_counts()
        t0 = time.perf_counter()
        keys = list(range(WEB_RUN_KEYS))
        verdicts = [ladder_results[k]["valid?"] for k in keys]
        valid = (False if False in verdicts
                 else "unknown" if "unknown" in verdicts else True)
        test = {"name": "chip-smoke-web", "start-time-str": store.time_str(),
                "store-dir": str(store_dir), "nodes": [],
                "history": _keyed(independent, hists, keys),
                "results": {"valid?": valid, "results": {
                    str(k): ladder_results[k] for k in keys}}}
        store.save_0(test)
        store.save_1(test)
        store.save_2(test)
        c_path = native.blockio() is not None
        home = _expect("web[f] /", _http(port, "GET", "/"), 200)
        row = (f"<td>{test['start-time-str']}</td>" in home
               or f">{test['start-time-str']}</a>" in home)
        rows = [r for r in web.run_index(str(store_dir))
                if r[1] == test["start-time-str"]]
        if not row or [r[3] for r in rows] != [valid]:
            raise AssertionError(f"web[f]: GET / lists {rows} (expected "
                                 f"valid? {valid})")
        status, headers, _ = _http(
            port, "GET", f"/zip/chip-smoke-web/{test['start-time-str']}")
        if status != 200 or headers.get("Content-Type") != "application/zip":
            raise AssertionError(f"web[f]: /zip/ answered {status}")
        peek = store.peek_dir(store.test_dir(test))
        seconds["f"] = time.perf_counter() - t0
        launches["f"] = _launch_counts(wk)
        print(f"web[f]: bench 0-{WEB_RUN_KEYS - 1} and phase 5's results "
              f"stored through save_0..save_2 ({peek['op-count']} ops, "
              f"valid? {peek['valid?']} from the footer); GET / lists it "
              f"with that validity, /zip/ serves it; the C blockio path "
              f"{'used' if c_path else 'not built (Python path)'}; "
              f"{seconds['f']:.3f} s", flush=True)

        # (g) the perf ledger, a competition, /perf and /metrics
        wk.reset_counts()
        t0 = time.perf_counter()
        inter_s = sorted(wall[i] for i in inter)
        batch_s = sorted(wall[i] for i in batch_ids)
        fp = regress.fingerprint()
        rec = regress.make_record("web", {
            "web_c_s": round(seconds["c"], 6),
            "web_interactive_p50_s": round(inter_s[len(inter_s) // 2], 6),
            "web_batch_p50_s": round(batch_s[len(batch_s) // 2], 6),
            "web_batch_http_p50_s": round(
                sorted(rtt.values())[len(rtt) // 2], 6),
            "device_busy_share_narrow": summs["narrow"]["busy_share"] or 0.0,
            "device_busy_share_top": summs["top"]["busy_share"] or 0.0},
            stages={f"web[{k}]": v for k, v in seconds.items()}, fp=fp)
        regress.append_record(rec, store_dir=store_dir)
        wl = dict(COMPETE_WORKLOAD, device=LADDER_KW["device"])
        base_runner = regress._default_runner("dedup_backend", repeats=2,
                                              **wl)
        arm: dict = {}

        def runner(value):
            wk.reset_counts()
            times = base_runner(value)
            arm[value] = _launch_counts(wk)
            return times

        comp = regress.run_competition("dedup_backend", ["fused", "bucket"],
                                       runner=runner, repeats=2, workload=wl)
        regress.append_record(comp, store_dir=store_dir)
        if (arm["fused"]["fused_frontier_update"] <= 0
                or arm["bucket"]["fused_frontier_update"] != 0):
            raise AssertionError(f"web[g]: fused_frontier_update launches by "
                                 f"arm {arm}: the axis did not reach the "
                                 f"engine")
        perf = _expect("web[g] /perf", _http(port, "GET", "/perf"), 200)
        if "<h2>web</h2>" not in perf or "competition verdicts" not in perf:
            raise AssertionError("web[g]: /perf does not render both records")
        _s, _h, text = _http(port, "GET", "/metrics")
        if "jepsen_tpu_perf_headline{" not in text:
            raise AssertionError("web[g]: /metrics carries no "
                                 "jepsen_tpu_perf_headline")
        v = comp["extra"]
        seconds["g"] = time.perf_counter() - t0
        launches["g"] = {n: sum(a[n] for a in arm.values())
                         for n in ("keep_mask", "fused_frontier_update",
                                   "mesh_exchange")}
        print(f"web[g]: a 'web' record (fingerprint {rec['fingerprint_key']}: "
              f"torch {fp.get('torch')}, CUDA {fp.get('cuda')}, "
              f"{fp.get('device_kind')}) and a competition appended to "
              f"{regress.ledger_path(store_dir=store_dir).name}: "
              f"dedup_backend fused against bucket on "
              f"{json.dumps(COMPETE_WORKLOAD)}: medians "
              f"{json.dumps({k: r['median_s'] for k, r in v['results'].items()})} "
              f"s, winner {v['winner']}, margin {v['margin_pct']} %, decisive "
              f"{v['decisive']}, pallas_interpret "
              f"{v.get('pallas_interpret')}; launches by arm {json.dumps(arm)}; "
              f"/perf renders both, /metrics carries jepsen_tpu_perf_headline; "
              f"{seconds['g']:.3f} s; {card}", flush=True)
    finally:
        if hook.status()["profiling"]:
            hook.stop()
        faulthandler.cancel_dump_traceback_later()
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if svc is not None:
            svc.shutdown(drain=False)
        metrics.enable_mirror(False)
        tmp.cleanup()

    total = {n: sum(c[n] for c in launches.values())
             for n in ("keep_mask", "fused_frontier_update")}
    if obs.active() is not None or obs.observing():
        raise AssertionError("web: a recording or the metrics mirror is "
                             "still open after phase 14")
    print(f"web: phase 14 {time.perf_counter() - t_phase:.3f} s, seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}, "
          f"launches {total}; {card}", flush=True)
    return launches


def run_ladder(batch, wk, m, genhist):
    """Phase 5: the bench ladder on the card; returns (model, results,
    histories, stats, seconds, launch counts, the ``_Capture`` of its
    fused update calls)."""
    model = m.CASRegister(None)
    hists = _bench_histories(genhist)
    batch.warm_confirm_pool()
    stats: dict = {}
    capture = _Capture(wk)
    wk.fused_frontier_update = capture
    wk.reset_counts()
    t0 = time.perf_counter()
    try:
        results = batch.batch_analysis(model, hists, stats=stats, **LADDER_KW)
    finally:
        wk.fused_frontier_update = capture.fn
    seconds = time.perf_counter() - t0
    counts = _launch_counts(wk)
    return model, results, hists, stats, seconds, counts, capture


def profile_ladder(batch, model, hists) -> None:
    """``--profile``: the warm ladder with and without worker
    confirmations (the sweeps share the host's cores with the driver
    thread), then one run under torch.profiler: device busy time (sum
    of CUDA kernel and copy time) against wall time, and the kernels
    that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = dict(capacity=CAPS, exact_escalation=(), cpu_fallback=False,
              dedup_backend="fused", device="cuda")
    for confirm in (True, False):
        st: dict = {}
        t0 = time.perf_counter()
        batch.batch_analysis(model, hists, confirm_refutations=confirm,
                             stats=st, **kw)
        torch.cuda.synchronize()
        rungs = [[r["capacity"], r["lanes"], round(r["seconds"], 4)]
                 for r in st["rungs"]]
        print(f"profile: warm ladder confirm={confirm}: "
              f"{time.perf_counter() - t0:.3f} s; rungs [capacity, lanes, s] "
              f"{json.dumps(rungs)}", flush=True)

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0)
                     or getattr(e, "self_cuda_time_total", 0))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch.batch_analysis(model, hists, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in events) / 1e6
    print(f"profile: traced ladder {wall:.3f} s wall, device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f} %), "
          f"{sum(e.count for e in events)} device ops", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        print(f"profile: {dev_us(e) / 1e3:.2f} ms device, {e.count} calls: "
              f"{e.key[:100]}", flush=True)
    # the port's own kernels (csrc/*.cu, in anonymous namespaces)
    for e in sorted(events, key=dev_us, reverse=True):
        if "(anonymous namespace)::k_" in e.key:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            print(f"profile: port kernel {name.split('(')[0]}: "
                  f"{dev_us(e) / 1e3:.3f} ms device, {e.count} calls", flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the checks, time the warm ladder with and "
                    "without worker confirmations and trace one run with "
                    "torch.profiler")
    ap.add_argument("--entry-times", metavar="ROOT",
                    help="only time the kernels' entry points of the port "
                    "package under ROOT (another commit's checkout) at the "
                    "bench shapes, print one entry_times JSON line, and exit")
    ap.add_argument("--ladder-child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ladder_child:
        return ladder_child(args.ladder_child)
    # a process of this run whose parent ends first is still found and
    # stopped at the end
    _adopt_orphans()
    if args.entry_times:
        sys.path.insert(0, os.path.abspath(args.entry_times))
    # phase 14 profiles the service while its threads launch kernels:
    # CUPTI stays up between this process's profiler sessions
    # (obs/profiler.py), from the first one on
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from jepsen_tpu_torch import models as m
        from jepsen_tpu_torch.ops import _build
        from jepsen_tpu_torch.ops import wgl
        from jepsen_tpu_torch.ops import wide_kernel as wk
        from jepsen_tpu_torch.parallel import batch, sharded
        from jepsen_tpu_torch.parallel import mesh as mesh_mod
        from jepsen_tpu_torch.testing import genhist
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = _smi()
    print(f"device: {kind} ({torch.cuda.device_count()} visible); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    sources = ["wide_kernel", "mesh_exchange"]
    t0 = time.perf_counter()
    _build.build(sources)
    if args.entry_times:
        print("entry_times: " + json.dumps(entry_times(dev, wk, mesh_mod)))
        return 0
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, "
          f"{len(sources)} sources in parallel)", flush=True)
    for name in sources:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"ptxas[{name}]: " + line.strip(), flush=True)

    measured = check_kernels(dev, wk)
    exchange = check_exchange(dev, wk, mesh_mod)
    check_fused_child(dev, wk)
    check_cross_path(dev, wk, mesh_mod, sharded)

    model, results, hists, stats, seconds, counts, capture = run_ladder(
        batch, wk, m, genhist)
    total_ops = sum(len(hh) for hh in hists) // 2
    unknowns = sum(1 for r in results if r["valid?"] == "unknown")
    for r in stats["rungs"]:
        print("rung: " + json.dumps(r), flush=True)
    print(f"ladder: {seconds:.3f} s for {N_HISTORIES} histories "
          f"({total_ops} ops), {total_ops / seconds:.1f} ops/s, "
          f"unknowns {unknowns}, confirm drain "
          f"{stats['confirm_drain_s']:.3f} s, launches {counts}", flush=True)
    for name in ("keep_mask", "fused_frontier_update"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    check_captured(wk, capture, "captured-ladder")
    del capture

    sample = hists[:CPU_SAMPLE]
    pool = batch.confirm_pool()
    t0 = time.perf_counter()
    futs = [pool.submit(batch._confirm_worker.sweep, model, hh, CPU_MAX_CONFIGS)
            for hh in sample]
    cpu = [f.result() for f in futs]
    disagree = sum(
        1 for tr, cr in zip(results, cpu)
        if "unknown" not in (tr["valid?"], cr["valid?"])
        and tr["valid?"] != cr["valid?"]
    )
    print(f"verdicts: {CPU_SAMPLE}-history sample vs the exact sweep: "
          f"{disagree} disagreements, cpu unknowns "
          f"{sum(1 for r in cpu if r['valid?'] == 'unknown')} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if disagree:
        raise AssertionError(f"{disagree} verdict disagreements")

    mesh_counts, mesh_results = run_mesh_ladder(batch, wk, mesh_mod, model,
                                                hists, results)
    check_mesh_engine(batch, sharded, mesh_mod, model, hists, results)
    single_counts, single_measured = run_single_history(
        batch, wk, wgl, sharded, mesh_mod, genhist, model, hists, results, cpu)
    checker_counts = run_checkers(batch, wk, mesh_mod, genhist, model, hists,
                                  results, cpu)
    elle_out = run_elle(dev, card)
    services_counts = run_services(
        dev, batch, wk, wgl, sharded, mesh_mod, genhist, model, hists,
        results, seconds, stats, card)
    telemetry_counts = run_telemetry(
        dev, batch, wk, wgl, genhist, model, hists, results, seconds, counts,
        card)
    serve_counts = run_serve(
        dev, batch, wk, wgl, mesh_mod, genhist, model, hists, results,
        seconds, mesh_results, card)
    web_counts = run_web(wk, hists, results, card)
    if args.profile:
        profile_ladder(batch, model, hists)
    batch.shutdown_confirm_pool()
    stopped = _stop_descendants()
    print(f"processes: {len(stopped)} of this run's processes still ran "
          f"after its phases and were stopped {json.dumps(stopped)} (the "
          f"multiprocessing resource tracker ends with this process)",
          flush=True)

    bench = {**measured["bench-G32"], "mesh_exchange": exchange}
    sources = {"keep_mask": "jepsen_tpu_torch/ops/csrc/wide_kernel.cu",
               "fused_frontier_update": "jepsen_tpu_torch/ops/csrc/wide_kernel.cu",
               "mesh_exchange": "jepsen_tpu_torch/ops/csrc/mesh_exchange.cu"}
    replaces = {"keep_mask": "jepsen_tpu/ops/wide_kernel.py:421",
                "fused_frontier_update": "jepsen_tpu/ops/wide_kernel.py:442",
                "mesh_exchange": "jepsen_tpu/ops/wide_kernel.py:873"}
    kernels = [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "launches": mesh_counts[name],
         "max_abs_err": bench[name]["max_abs_err"], "ms": bench[name]["ms"],
         "device_ms": bench[name]["device_ms"],
         "plain_ms": bench[name]["plain_ms"],
         "bound_ms": bench[name]["bound_ms"],
         "bound_by": bench[name]["bound_by"],
         "library_ms": bench[name].get("library_ms"),
         "single_history_launches": single_counts[name],
         "checker_launches": {sub: c[name] for sub, c in checker_counts.items()},
         "services_launches": {sub: c[name]
                               for sub, c in services_counts.items()},
         "telemetry_launches": {sub: c[name]
                                for sub, c in telemetry_counts.items()},
         "serve_launches": {sub: c[name] for sub, c in serve_counts.items()},
         "web_launches": {sub: c[name] for sub, c in web_counts.items()},
         **({f"single_{c}_ms": single_measured[c][name]["ms"]
             for c in SPILL_CAPS} if name in single_measured[SPILL_CAPS[0]]
            else {}),
         **{k: bench[name][k] for k in ("sort_stage_ms", "sort_library_ms")
            if k in bench[name]}}
        for name in ("keep_mask", "fused_frontier_update", "mesh_exchange")
    ]
    print("elle_json: " + json.dumps(elle_out))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        for line in _stop_descendants():
            print(f"chip_smoke: stopped a process left running: {line}",
                  file=sys.stderr)
    sys.exit(rc)
