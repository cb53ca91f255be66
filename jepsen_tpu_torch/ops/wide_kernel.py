"""The fused wide-stage frontier update (``dedup_backend="fused"``).

Wrappers of the two hand-written CUDA kernels in ``csrc/wide_kernel.cu``
and their plain PyTorch versions:

  * ``keep_mask`` — the dedup stage alone (row hash, bucket prefix rank,
    windowed 64-bit-hash kills): the keep mask in candidate order and
    the bucket overflow flag, bit-identical to ``hashing._keep_bucket``.
    Replaces the Pallas kernel ``_keep_kernel``
    (jepsen_tpu/ops/wide_kernel.py, ``keep_mask``).
  * ``fused_frontier_update`` — that dedup, then compaction of the
    survivors into a 2C buffer, the one-hot domination prune on it, and
    compaction to capacity with the order-insensitive fingerprint: a
    drop-in for ``hashing.frontier_update_fast`` on wide rungs.  Alive
    rows (content and position), the overflow flag, the fingerprint and
    ``child & alive`` are bit-identical to the bucket path; dead output
    rows are zeros.  Replaces ``_fused_kernel``
    (jepsen_tpu/ops/wide_kernel.py, ``fused_frontier_update``); the
    kernel's source note says what bounds it on Hopper and how it is
    built.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises — there is no fallback between the
two.  Every table carries a leading lane axis (``[L, n]``; 1-D tables
are one lane): the vmapped lane axis of the JAX package is a grid
dimension of the kernels.

The plain versions are written from the kernels' contract and share no
code with the bucket path (only the row-hash fold, which both packages
gate bit for bit): the keep mask by a stable argsort on the bucket id
with run ranks, the prune by integer compares, compaction by
``nonzero``.  The tests hold both, independently, against the JAX
package.
"""

from __future__ import annotations

import ctypes
import os

import torch

from jepsen_tpu_torch.ops import _build, hashing

#: Env override for the wide-rung routing floor (see wide_min_capacity).
FUSED_MIN_CAPACITY_ENV = "JEPSEN_TPU_TORCH_FUSED_MIN_CAPACITY"

#: Default routing floor: the fused update serves the wide rungs
#: (capacity >= 1024), as in the JAX package; narrower rungs keep the
#: bucket path.  A routing choice, not a correctness bound.
FUSED_MIN_CAPACITY = 1024

#: Launch counts, one per wrapper call that launches its kernel (never
#: for the plain version): a run can show that it went through them.
KEEP_LAUNCHES = 0
FUSED_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wk_chunk_rows": (_I, []),
    "wk_error_string": (ctypes.c_char_p, [_I]),
    "wk_keep_mask": (_I, [_I] * 7 + [_P] * 15),
    "wk_fused_tail": (_I, [_I] * 7 + [_P] * 20),
}


def _lib():
    return _build.load("wide_kernel", _SIGNATURES)


def reset_counts() -> None:
    """Set both launch counts to 0."""
    global KEEP_LAUNCHES, FUSED_LAUNCHES
    KEEP_LAUNCHES = 0
    FUSED_LAUNCHES = 0


def wide_min_capacity() -> int:
    """The smallest rung capacity routed to the fused update (env
    override > module default)."""
    v = os.environ.get(FUSED_MIN_CAPACITY_ENV)
    return int(v) if v else FUSED_MIN_CAPACITY


def _geometry_ok(n: int, capacity: int, max_count) -> bool:
    """The fused update's own geometry: a usable bucket key, the prune's
    plane bound, and a full 2C buffer's worth of candidate rows (engine
    tables hold capacity * (1 + P + G) rows)."""
    return (hashing.bucket_feasible(n) and max_count is not None
            and n >= 2 * capacity)


def fused_feasible(n: int, capacity: int, max_count) -> bool:
    """Whether a rung routes to the fused update: its geometry, and a
    wide rung (``wide_min_capacity()``).  The JAX package's gate also
    holds the working set to a 3 MiB VMEM budget; on Hopper the table
    lives in device memory and L2, so there is no such term."""
    return (_geometry_ok(n, capacity, max_count)
            and capacity >= wide_min_capacity())


def _super_bits(n: int) -> tuple[int, int]:
    """(super-bucket bits, bucket bits) at n rows: the kernel partitions
    rows by the top ``min(bucket bits, index bits)`` bits of h1, about
    one super-bucket per row, so the bucket lists stay short."""
    ibits, bbits = hashing._bucket_bits(n)
    return min(bbits, ibits), bbits


def _check_table(state, fok, fcr, alive):
    if state.dim() != 2:
        raise ValueError(f"state must be [lanes, n], got {tuple(state.shape)}")
    L, n = state.shape
    if (fok.dim() != 3 or fcr.dim() != 3 or tuple(fok.shape[:2]) != (L, n)
            or tuple(fcr.shape[:2]) != (L, n) or tuple(alive.shape) != (L, n)):
        raise ValueError("fok/fcr/alive shapes do not match state")
    for name, t, dt in (("state", state, torch.int32), ("fok", fok, torch.int32),
                        ("fcr", fcr, torch.int16), ("alive", alive, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device.type != "cuda" or t.device != state.device:
            raise ValueError(f"{name} must lie on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not hashing.bucket_feasible(n):
        raise ValueError(f"bucket geometry infeasible at {n} rows")
    return L, n, fok.shape[2], fcr.shape[2]


def _launch_keep(state, fok, fcr, alive, window: int, with_chunks: bool):
    """Launch the keep-mask kernels; returns (keep [L, n] bool, ovf [L]
    int32, per-block kept counts or None)."""
    global KEEP_LAUNCHES
    L, n, W, G = _check_table(state, fok, fcr, alive)
    lib = _lib()
    sbits, bbits = _super_bits(n)
    S = 1 << sbits
    dev = state.device
    i32 = dict(dtype=torch.int32, device=dev)
    h1 = torch.empty(L, n, **i32)
    h2 = torch.empty(L, n, **i32)
    cnt = torch.zeros(L, S, **i32)
    off = torch.empty(L, S, **i32)
    cursor = torch.empty(L, S, **i32)
    lst = torch.empty(L, n, **i32)
    pre = torch.empty(L, n, **i32)
    keep = torch.empty(L, n, dtype=torch.bool, device=dev)
    ovf = torch.zeros(L, **i32)
    chunk_rows = lib.wk_chunk_rows()
    chunk_cnt = (torch.empty(L, -(-n // chunk_rows), **i32)
                 if with_chunks else None)
    rc = lib.wk_keep_mask(
        L, n, W, G, int(window), sbits, bbits,
        *(t.data_ptr() for t in (state, fok, fcr, alive, h1, h2, cnt, off,
                                 cursor, lst, pre, keep, ovf)),
        None if chunk_cnt is None else chunk_cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "wk_keep_mask")
    KEEP_LAUNCHES += 1
    return keep, ovf, chunk_cnt


def keep_mask(state, fok, fcr, alive, window: int = 4):
    """The dedup stage alone (row hash + bucket prefix rank + windowed
    kills).  Returns (keep bool in candidate order, overflow bool per
    lane), bit-identical to ``hashing._keep_bucket``."""
    (state, fok, fcr, alive), single = hashing._lanes(state, fok, fcr, alive)
    if state.device.type == "cpu":
        keep, ovf = keep_mask_ref(state, fok, fcr, alive, window)
    else:
        keep, ovf, _ = _launch_keep(state, fok, fcr, alive, window, False)
        ovf = ovf != 0
    return (keep[0], ovf[0]) if single else (keep, ovf)


def fused_frontier_update(
    state, fok, fcr, alive, cost, capacity: int, window: int = 4,
    n_parents: int | None = None, max_count: int | None = None,
):
    """Drop-in fused replacement for ``hashing.frontier_update_fast``:
    same arguments (``cost`` accepted and unused), same returns
    (state', fok', fcr', alive', overflowed, fp, child).  See the module
    docstring for the parity contract."""
    (state, fok, fcr, alive), single = hashing._lanes(state, fok, fcr, alive)
    n = state.shape[1]
    if not _geometry_ok(n, capacity, max_count):
        raise ValueError(f"fused update infeasible at n={n}, "
                         f"capacity={capacity}, max_count={max_count}")
    m = min(int(max_count), hashing.MXU_PRUNE_MAX_COUNT)
    if state.device.type == "cpu":
        out = fused_frontier_update_ref(state, fok, fcr, alive, capacity,
                                        window, n_parents, max_count)
    else:
        out = _launch_fused(state, fok, fcr, alive, capacity, window,
                            n_parents, m)
    return tuple(o[0] for o in out) if single else out


def _launch_fused(state, fok, fcr, alive, capacity, window, n_parents, m):
    global FUSED_LAUNCHES
    keep, _ovf, chunk_cnt = _launch_keep(state, fok, fcr, alive, window, True)
    (L, n), W, G = state.shape, fok.shape[2], fcr.shape[2]
    lib = _lib()
    C = int(capacity)
    Cb = 2 * C
    dev = state.device
    i32 = dict(dtype=torch.int32, device=dev)
    u8 = dict(dtype=torch.bool, device=dev)
    chunk_off = torch.empty_like(chunk_cnt)
    nk0 = torch.empty(L, **i32)
    bst = torch.empty(L, Cb, **i32)
    bfo = torch.empty(L, Cb, W, **i32)
    bfc = torch.empty(L, Cb, G, dtype=torch.int16, device=dev)
    bch = torch.empty(L, Cb, **u8)
    dead = torch.empty(L, Cb, **u8)
    kst = torch.empty(L, C, **i32)
    kfo = torch.empty(L, C, W, **i32)
    kfc = torch.empty(L, C, G, dtype=torch.int16, device=dev)
    alv = torch.empty(L, C, **u8)
    chd = torch.empty(L, C, **u8)
    flags = torch.empty(L, 2, **i32)
    fp = torch.empty(L, 3, **i32)
    rc = lib.wk_fused_tail(
        L, n, C, W, G, int(m), -1 if n_parents is None else int(n_parents),
        *(t.data_ptr() for t in (state, fok, fcr, keep, chunk_cnt, chunk_off,
                                 nk0, bst, bfo, bfc, bch, dead, kst, kfo,
                                 kfc, alv, chd, flags, fp)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "wk_fused_tail")
    FUSED_LAUNCHES += 1
    return (kst, kfo, kfc, alv, flags[:, 0] != 0,
            hashing.u32(fp), chd)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def keep_mask_ref(state, fok, fcr, alive, window: int = 4):
    """Plain version of ``keep_mask`` over [L, n] tables, from its
    contract: ``pre[i]`` = alive rows j < i in i's bucket (top bucket
    bits of h1); row i dies iff an alive j < i has both hash lanes equal
    and ``pre[i] - pre[j] <= window``.  Computed with a stable argsort
    on (lane, bucket) and run ranks.  Returns (keep, overflow)."""
    L, n = state.shape
    dev = state.device
    h1, h2 = hashing.row_hashes(state, fok, fcr)
    _ibits, bbits = hashing._bucket_bits(n)
    nb = 1 << bbits
    lane = torch.arange(L, device=dev)[:, None]
    key = torch.where(alive, lane * nb + (h1 >> (32 - bbits)), L * nb)
    flat = key.reshape(-1)
    order = torch.argsort(flat, stable=True)
    skey = flat[order]
    pos = torch.arange(L * n, device=dev)
    start = torch.ones_like(skey, dtype=torch.bool)
    start[1:] = skey[1:] != skey[:-1]
    run_start = torch.cummax(torch.where(start, pos, 0), 0).values
    sh1 = h1.reshape(-1)[order]
    sh2 = h2.reshape(-1)[order]
    dup = torch.zeros(L * n, dtype=torch.bool, device=dev)
    for k in range(1, window + 1):
        j = torch.clamp(pos - k, min=0)
        dup |= ((pos - k) >= run_start) & (sh1[j] == sh1) & (sh2[j] == sh2)
    skeep = alive.reshape(-1)[order] & ~dup
    keep = torch.empty_like(skeep)
    keep[order] = skeep
    pre = torch.empty_like(pos)
    pre[order] = pos - run_start
    keep = keep.reshape(L, n)
    ovf = (keep & (pre.reshape(L, n) >= window)).any(-1)
    return keep, ovf


def prune_ref(bst, bfo, bfc, m: int):
    """Plain domination prune of one lane's buffer (every row alive):
    the dead mask.  Row j dies when a row i != j of the same (state, fok)
    class has fcr_i <= min(fcr_j, m-1) on every group (a group counts
    only where that saturated count is >= 0) and either fails the
    reverse test or comes earlier.  Integer compares, blocked over i."""
    nv, G = bfc.shape
    dev = bst.device
    f = bfc.to(torch.int64)
    sat = torch.clamp(f, max=m - 1)
    dead = torch.zeros(nv, dtype=torch.bool, device=dev)
    blk = max(1, (1 << 24) // max(1, nv * max(G, 1)))
    cols = torch.arange(nv, device=dev)
    for i0 in range(0, nv, blk):
        i1 = min(nv, i0 + blk)
        fi, si = f[i0:i1], sat[i0:i1]
        le_ij = ((fi[:, None, :] <= sat[None]) & (sat[None] >= 0)).all(-1)
        le_ji = ((f[None] <= si[:, None, :]) & (si[:, None, :] >= 0)).all(-1)
        same = ((bst[i0:i1, None] == bst[None, :])
                & (bfo[i0:i1, None, :] == bfo[None]).all(-1))
        earlier = torch.arange(i0, i1, device=dev)[:, None] < cols[None, :]
        dead |= (same & le_ij & (~le_ji | earlier)).any(0)
    return dead


def fused_frontier_update_ref(state, fok, fcr, alive, capacity: int,
                              window: int = 4, n_parents: int | None = None,
                              max_count: int | None = None):
    """Plain version of ``fused_frontier_update`` over [L, n] tables:
    the keep mask of ``keep_mask_ref``; the first 2C survivors in
    candidate order form the buffer (more is a spill); ``prune_ref``;
    the first C buffer survivors are the output (more is an overflow),
    dead rows zero; the fingerprint sums two row hashes of the alive
    output rows and counts them, mod 2^32."""
    L, n = state.shape
    W, G = fok.shape[2], fcr.shape[2]
    dev = state.device
    m = min(int(max_count), hashing.MXU_PRUNE_MAX_COUNT)
    C = int(capacity)
    keep, _ovf = keep_mask_ref(state, fok, fcr, alive, window)
    kst = torch.zeros(L, C, dtype=torch.int32, device=dev)
    kfo = torch.zeros(L, C, W, dtype=torch.int32, device=dev)
    kfc = torch.zeros(L, C, G, dtype=torch.int16, device=dev)
    alv = torch.zeros(L, C, dtype=torch.bool, device=dev)
    chd = torch.zeros(L, C, dtype=torch.bool, device=dev)
    overflowed = torch.zeros(L, dtype=torch.bool, device=dev)
    for l in range(L):
        rows = keep[l].nonzero().squeeze(1)
        sel = rows[: 2 * C]
        bst, bfo, bfc = state[l, sel], fok[l, sel], fcr[l, sel]
        surv = (~prune_ref(bst, bfo, bfc, m)).nonzero().squeeze(1)
        out = surv[:C]
        k = out.numel()
        kst[l, :k] = bst[out]
        kfo[l, :k] = bfo[out]
        kfc[l, :k] = bfc[out]
        alv[l, :k] = True
        if n_parents is not None:
            chd[l, :k] = sel[out] >= n_parents
        overflowed[l] = rows.numel() > 2 * C or surv.numel() > C
    cols = hashing.row_columns(kst, kfo, kfc)
    am = alv.to(torch.int64)
    fp = torch.stack([
        (hashing.hash_rows(cols, hashing.FP_SEED_1) * am).sum(-1) & hashing.MASK32,
        (hashing.hash_rows(cols, hashing.FP_SEED_2) * am).sum(-1) & hashing.MASK32,
        am.sum(-1),
    ], -1)
    return kst, kfo, kfc, alv, overflowed, fp, chd
