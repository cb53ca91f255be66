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
     never calls);
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

It prints a ``{"kernels": [...]}`` JSON line (launches from the mesh
ladder of phase 7, times at the G = 32 shapes) and the card line, and as
its last line ``{"ok": true, "device": {...}}``.  It exits non-zero,
printing no result, without a CUDA device or outside the repository.

    python3 chip_smoke.py --entry-times ROOT

only times the kernels' entry points of the port package in ROOT (a
checkout of another commit, or ``.``) at the bench shapes; run it for
two trees in turns (parent, change, change, parent) to compare them on
one card.
"""

from __future__ import annotations

import json
import os
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
MESH_SHARDS = 4
RESCUE_MAX_CONFIGS = 2_000_000
MESH_ENGINE_LANES = 8

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
    """Stands in for ``wide_kernel.fused_frontier_update`` during one
    ladder run and keeps a copy of the inputs of its call with the most
    alive candidate rows.  Calls of one shape are compared on the card
    (``torch.where`` on the alive counts), so the run takes no extra
    host sync; a call of a larger shape replaces the copy."""

    def __init__(self, wk):
        self.fn = wk.fused_frontier_update
        self.key = None
        self.tables = None
        self.count = None

    def __call__(self, state, fok, fcr, alive, cost, capacity, window=4,
                 n_parents=None, max_count=None, child=None):
        import torch

        if child is None:
            key = (tuple(state.shape), tuple(fok.shape), tuple(fcr.shape),
                   capacity, window, n_parents, max_count)
            cnt = alive.sum()
            args = (state, fok, fcr, alive)
            if self.key is None or (key != self.key and state.numel()
                                    > self.tables[0].numel()):
                self.key, self.count = key, cnt
                self.tables = [t.clone() for t in args]
            elif key == self.key:
                more = cnt > self.count
                for t, x in zip(self.tables, args):
                    t.copy_(torch.where(more, x, t))
                self.count = torch.maximum(self.count, cnt)
        return self.fn(state, fok, fcr, alive, cost, capacity, window=window,
                       n_parents=n_parents, max_count=max_count, child=child)


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
    return out


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
    shards; returns the launch counts of that run."""
    stats: dict = {}
    wk.reset_counts()
    t0 = time.perf_counter()
    results = batch.batch_analysis(
        model, hists, capacity=CAPS, exact_escalation=(), cpu_fallback=False,
        dedup_backend="fused", device="cuda", stats=stats,
        mesh=mesh_mod.make_mesh(MESH_SHARDS),
    )
    seconds = time.perf_counter() - t0
    counts = {"keep_mask": wk.KEEP_LAUNCHES,
              "fused_frontier_update": wk.FUSED_LAUNCHES,
              "mesh_exchange": wk.EXCHANGE_LAUNCHES}
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
    return counts


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


def run_ladder(batch, wk, m, genhist):
    """Phase 5: the bench ladder on the card; returns (model, results,
    histories, stats, seconds, launch counts, the ``_Capture`` of its
    fused update calls)."""
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
    capture = _Capture(wk)
    wk.fused_frontier_update = capture
    wk.reset_counts()
    t0 = time.perf_counter()
    try:
        results = batch.batch_analysis(
            model, hists, capacity=CAPS, exact_escalation=(), cpu_fallback=False,
            dedup_backend="fused", device="cuda", stats=stats,
        )
    finally:
        wk.fused_frontier_update = capture.fn
    seconds = time.perf_counter() - t0
    counts = {"keep_mask": wk.KEEP_LAUNCHES,
              "fused_frontier_update": wk.FUSED_LAUNCHES}
    return model, results, hists, stats, seconds, counts, capture


def check_captured(wk, capture) -> dict:
    """Phase 5b: the inputs of phase 5's fused update call with the most
    alive candidate rows, held against the plain versions and timed as
    the bench tables are."""
    if capture.tables is None:
        raise AssertionError("the ladder made no fused update call")
    _s, _f, _g, capacity, window, n_parents, max_count = capture.key
    st = capture.tables[0]
    print(f"captured: the ladder's fused call with the most alive "
          f"candidate rows: {int(capture.count)} of {st.numel()} "
          f"(lanes {st.shape[0]}, capacity {capacity}, n_parents "
          f"{n_parents}, max_count {max_count})", flush=True)
    return check_fused_table("captured-ladder", wk, *capture.tables, capacity,
                             n_parents, max_count, window)


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
    args = ap.parse_args(argv)
    if args.entry_times:
        sys.path.insert(0, os.path.abspath(args.entry_times))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from jepsen_tpu_torch import models as m
        from jepsen_tpu_torch.ops import _build
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
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    check_captured(wk, capture)
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

    mesh_counts = run_mesh_ladder(batch, wk, mesh_mod, model, hists, results)
    check_mesh_engine(batch, sharded, mesh_mod, model, hists, results)
    if args.profile:
        profile_ladder(batch, model, hists)
    batch.shutdown_confirm_pool()

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
         **{k: bench[name][k] for k in ("sort_stage_ms", "sort_library_ms")
            if k in bench[name]}}
        for name in ("keep_mask", "fused_frontier_update", "mesh_exchange")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
