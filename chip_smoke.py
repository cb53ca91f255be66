#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository.  It imports only the port (never
jax or the JAX package), builds the CUDA kernels from the sources in the
checkout, and then:

  1. prints the card's name and power limit (nvidia-smi);
  2. holds each kernel against its plain PyTorch version on the card, at
     the bench wide-rung shapes (capacity 2048, P = 8, G = 16 and 32, 8
     lanes) and one small shape: the results must be identical (integer
     and bit outputs, tolerance 0); times both with CUDA events;
  3. runs the bench ladder: 128 CAS-register histories of 100 ops, 8
     processes, 30 % :info, 8 values, every 4th corrupted (seeds
     0-127), capacity ladder (128, 512, 2048), no exact stages, no CPU
     fallback, the fused backend, on the card; every kernel's launch
     count must be > 0 in that run;
  4. checks the verdicts of the first 48 histories against the exact CPU
     sweep (100,000-configuration budget): no disagreement among
     verdicts that are not "unknown".

It prints a ``{"kernels": [...]}`` JSON line and the card line, and as
its last line ``{"ok": true, "device": {...}}``.  It exits non-zero,
printing no result, without a CUDA device or outside the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N_HISTORIES = 128
OPS_PER_HISTORY = 100
PROCS = 8
INFO_RATE = 0.3
N_VALUES = 8
CORRUPT_EVERY = 4
CAPS = (128, 512, 2048)
CPU_MAX_CONFIGS = 100_000
CPU_SAMPLE = 48

#: H100 SXM published peaks (dense): HBM bytes/s, and the 32-bit
#: non-tensor rate used for the kernels' integer compare/hash work.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

#: int ops per hashed column per lane: one xor, then fmix32's 3
#: xor-shifts (2 ops each) and 2 multiplies.
HASH_OPS_PER_COL = 9


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


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


def _tables(capacity: int, P: int, G: int, lanes: int, dev):
    """A [lanes, capacity*(1+P+G)] candidate table of probe rows, one
    seed per lane."""
    import numpy as np
    import torch

    from jepsen_tpu_torch.ops import hashing

    rows = [hashing.probe_candidates(capacity, P, G, 1, seed=s)
            for s in range(lanes)]
    return tuple(torch.from_numpy(np.stack([r[k] for r in rows])).to(dev)
                 for k in range(4))


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


def _work(state, fok, fcr, alive, capacity: int, fused: bool):
    """(bytes, ops) the function must move and do on these inputs: each
    input read once and each output written once; the two row-hash
    lanes of every row; for the fused update also the fingerprint
    hashes of its output rows and the pairwise domination tests within
    each (state, fok) class of its 2C buffer (this data's class sizes)."""
    import torch

    from jepsen_tpu_torch.ops import wide_kernel as wk

    L, n = state.shape
    W, G = fok.shape[2], fcr.shape[2]
    row_in = 4 + 4 * W + 2 * G + 1
    cols = 1 + W + G
    nbytes = L * n * row_in + L * n + 4 * L  # + keep mask, overflow flag
    ops = L * n * 2 * cols * HASH_OPS_PER_COL
    if not fused:
        return nbytes, ops
    C = capacity
    nbytes = L * n * row_in + L * (C * (row_in + 1) + 8 + 12)
    keep, _ovf = wk.keep_mask_ref(state, fok, fcr, alive)
    for l in range(L):
        sel = keep[l].nonzero().squeeze(1)[: 2 * C]
        key = torch.cat([state[l, sel, None], fok[l, sel]], 1)
        _u, counts = torch.unique(key, dim=0, return_counts=True)
        pairs = int((counts * (counts - 1)).sum())
        ops += pairs * 2 * G + min(int(sel.numel()), C) * 2 * cols * HASH_OPS_PER_COL
    return nbytes, ops


def _bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_kernels(dev, wk) -> dict:
    """Phase 2: each kernel against its plain version; returns the
    bench-shape measurements per kernel."""
    import torch

    shapes = [("small", 64, 4, 3, 2), ("bench-G16", 2048, 8, 16, 8),
              ("bench-G32", 2048, 8, 32, 8)]
    out = {}
    for tag, C, P, G, lanes in shapes:
        st, fo, fc, al = _tables(C, P, G, lanes, dev)
        n = st.shape[1]
        m = P + 1
        keep_k = wk.keep_mask(st, fo, fc, al)
        keep_r = wk.keep_mask_ref(st, fo, fc, al)
        torch.cuda.synchronize()
        err_keep = _max_abs_err(keep_k, keep_r)
        fused_k = wk.fused_frontier_update(st, fo, fc, al, None, C,
                                           n_parents=C, max_count=m)
        fused_r = wk.fused_frontier_update_ref(st, fo, fc, al, C, 4, C, m)
        torch.cuda.synchronize()
        err_fused = _max_abs_err(fused_k, fused_r)
        alive_rows = int(fused_r[3].sum())
        ovf = int(fused_r[4].sum())
        print(f"kernels[{tag}]: lanes={lanes} n={n} C={C} G={G} "
              f"keep max_abs_err={err_keep} fused max_abs_err={err_fused} "
              f"(tolerance 0; alive out rows {alive_rows}, overflowed lanes {ovf})",
              flush=True)
        if err_keep != 0 or err_fused != 0:
            raise AssertionError(f"{tag}: kernel disagrees with its plain version")
        if tag == "small":
            continue
        keep_ms = _time_ms(lambda: wk.keep_mask(st, fo, fc, al), 20)
        keep_plain = _time_ms(lambda: wk.keep_mask_ref(st, fo, fc, al), 3, 1)
        fused_ms = _time_ms(lambda: wk.fused_frontier_update(
            st, fo, fc, al, None, C, n_parents=C, max_count=m), 10)
        fused_plain = _time_ms(lambda: wk.fused_frontier_update_ref(
            st, fo, fc, al, C, 4, C, m), 2, 1)
        kb, kbb = _bound_ms(*_work(st, fo, fc, al, C, fused=False))
        fb, fbb = _bound_ms(*_work(st, fo, fc, al, C, fused=True))
        print(f"timing[{tag}]: keep_mask {keep_ms:.4f} ms (plain "
              f"{keep_plain:.4f} ms, bound {kb:.4f} ms by {kbb}); "
              f"fused_frontier_update {fused_ms:.4f} ms (plain "
              f"{fused_plain:.4f} ms, bound {fb:.4f} ms by {fbb})", flush=True)
        out[tag] = {
            "keep_mask": dict(max_abs_err=err_keep, ms=keep_ms,
                              plain_ms=keep_plain, bound_ms=kb, bound_by=kbb),
            "fused_frontier_update": dict(max_abs_err=max(err_keep, err_fused),
                                          ms=fused_ms, plain_ms=fused_plain,
                                          bound_ms=fb, bound_by=fbb),
        }
    return out


def run_ladder(batch, wk, m, genhist):
    """Phase 3: the bench ladder on the card; returns (results,
    histories, stats, seconds, launch counts)."""
    model = m.CASRegister(None)
    hists = []
    for i in range(N_HISTORIES):
        hh = genhist.valid_register_history(
            OPS_PER_HISTORY, PROCS, seed=i, info_rate=INFO_RATE,
            n_values=N_VALUES)
        if i % CORRUPT_EVERY == CORRUPT_EVERY - 1:
            hh = genhist.corrupt(hh, seed=i)
        hists.append(hh)
    batch.warm_confirm_pool()
    stats: dict = {}
    wk.reset_counts()
    t0 = time.perf_counter()
    results = batch.batch_analysis(
        model, hists, capacity=CAPS, exact_escalation=(), cpu_fallback=False,
        dedup_backend="fused", device="cuda", stats=stats,
    )
    seconds = time.perf_counter() - t0
    counts = {"keep_mask": wk.KEEP_LAUNCHES,
              "fused_frontier_update": wk.FUSED_LAUNCHES}
    return model, results, hists, stats, seconds, counts


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


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the checks, time the warm ladder with and "
                    "without worker confirmations and trace one run with "
                    "torch.profiler")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from jepsen_tpu_torch import models as m
        from jepsen_tpu_torch.ops import _build
        from jepsen_tpu_torch.ops import wide_kernel as wk
        from jepsen_tpu_torch.parallel import batch
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

    t0 = time.perf_counter()
    _build.build(["wide_kernel"])
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)", flush=True)
    log = _build.BUILD_DIR / "wide_kernel.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("ptxas: " + line.strip(), flush=True)

    measured = check_kernels(dev, wk)

    model, results, hists, stats, seconds, counts = run_ladder(
        batch, wk, m, genhist)
    total_ops = sum(len(hh) for hh in hists) // 2
    unknowns = sum(1 for r in results if r["valid?"] == "unknown")
    for r in stats["rungs"]:
        print("rung: " + json.dumps(r), flush=True)
    print(f"ladder: {seconds:.3f} s for {N_HISTORIES} histories "
          f"({total_ops} ops), {total_ops / seconds:.1f} ops/s, "
          f"unknowns {unknowns}, confirm drain "
          f"{stats['confirm_drain_s']:.3f} s, launches {counts}", flush=True)
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

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
    if args.profile:
        profile_ladder(batch, model, hists)
    batch.shutdown_confirm_pool()

    bench = measured["bench-G32"]
    source = "jepsen_tpu_torch/ops/csrc/wide_kernel.cu"
    replaces = {"keep_mask": "jepsen_tpu/ops/wide_kernel.py:421",
                "fused_frontier_update": "jepsen_tpu/ops/wide_kernel.py:442"}
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces[name], "launches": counts[name],
         "max_abs_err": bench[name]["max_abs_err"], "ms": bench[name]["ms"],
         "plain_ms": bench[name]["plain_ms"],
         "bound_ms": bench[name]["bound_ms"],
         "bound_by": bench[name]["bound_by"], "library_ms": None}
        for name in ("keep_mask", "fused_frontier_update")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
