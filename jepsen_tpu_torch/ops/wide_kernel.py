"""The fused wide-stage frontier update (``dedup_backend="fused"``) and
the mesh-spanning wide stage.

Wrappers of the hand-written CUDA kernels in ``csrc/wide_kernel.cu``
and ``csrc/mesh_exchange.cu`` and their plain PyTorch versions:

  * ``keep_mask`` — the dedup stage alone (row hash, bucket prefix rank,
    windowed 64-bit-hash kills): the keep mask in candidate order and
    the bucket overflow flag, bit-identical to ``hashing._keep_bucket``.
    On the card: a hash pass over fcr rows staged in shared memory, a
    stable radix sort of each lane's alive rows by bucket, and a window
    stencil over the sorted order, so its work is linear in the table
    whatever the bucket sizes.  Replaces the Pallas kernel
    ``_keep_kernel`` (jepsen_tpu/ops/wide_kernel.py, ``keep_mask``).
  * ``fused_frontier_update`` — that dedup, then compaction of the
    survivors into a 2C buffer, the one-hot domination prune on it, and
    compaction to capacity with the order-insensitive fingerprint: a
    drop-in for ``hashing.frontier_update_fast`` on wide rungs.  Alive
    rows (content and position), the overflow flag, the fingerprint and
    ``child & alive`` are bit-identical to the bucket path; dead output
    rows are zeros.  Replaces ``_fused_kernel``
    (jepsen_tpu/ops/wide_kernel.py, ``fused_frontier_update``); the
    kernel's source note says what bounds it on Hopper and how it is
    built.  ``child=`` takes an explicit child column in place of the
    positional ``n_parents``.
  * ``mesh_exchange`` — the all-to-all of D logical shards' pre-rotated
    slot matrices.  Replaces ``_exchange_kernel``
    (jepsen_tpu/ops/wide_kernel.py, ``mesh_exchange``).

``mesh_frontier_update`` is the mesh-spanning stage built on them: the
JAX package's per-shard body with the shard axis written out (tables
``[D, n_loc]``, see ``parallel.mesh``): class-hash routing into fixed
receive slots, the exchange, the parents-first partition, and the fused
update on each shard's received table.

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
import functools
import math
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
EXCHANGE_LAUNCHES = 0

#: Skew headroom on the per-peer receive slots (the JAX package's
#: value): each of the D targets gets a fixed slot of
#: ``ceil(HEADROOM * n_loc / D)`` rows, 128-padded; more rows for one
#: target is a spill, reported as overflow.
MESH_RCAP_HEADROOM = 1.5

#: Routing seed of the class-hash owner (the JAX package's value):
#: rows route by (state, fok), so duplicates and domination pairs meet
#: on one shard and every kill is decided with all of its rows local.
MESH_ROUTE_SEED = 0x5EED_0D15

#: The JAX package's row tile: receive slots pad to it, so the received
#: table has the JAX package's row count and bucket geometry.
TILE = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wk_chunk_rows": (_I, []),
    "wk_error_string": (ctypes.c_char_p, [_I]),
    "wk_keep_scratch_words": (ctypes.c_int64, [_I, _I]),
    "wk_keep_mask": (_I, [_I] * 7 + [_P] * 9),
    "wk_fused_tail": (_I, [_I] * 8 + [_P] * 25),
}
#: The most shards one exchange takes: the kernel gets its D send and D
#: receive bases by value, in one fixed-size parameter (``kMaxShards``
#: in ``csrc/mesh_exchange.cu``).
MESH_MAX_SHARDS = 64
_Bases = _P * MESH_MAX_SHARDS
_EXCHANGE_SIGNATURES = {
    "wk_error_string": (ctypes.c_char_p, [_I]),
    "wk_mesh_exchange": (_I, [_I, ctypes.c_int64, ctypes.POINTER(_P),
                              ctypes.POINTER(_P), _P]),
}


def _lib():
    return _build.load("wide_kernel", _SIGNATURES)


def reset_counts() -> None:
    """Set every launch count to 0."""
    global KEEP_LAUNCHES, FUSED_LAUNCHES, EXCHANGE_LAUNCHES
    KEEP_LAUNCHES = 0
    FUSED_LAUNCHES = 0
    EXCHANGE_LAUNCHES = 0


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


@functools.lru_cache(maxsize=64)
def _keep_geometry(L: int, n: int) -> tuple[int, int]:
    """(kept-count chunks per lane, int32 scratch words) of the keep
    mask's launch over L lanes of n rows."""
    lib = _lib()
    return -(-n // lib.wk_chunk_rows()), lib.wk_keep_scratch_words(L, n)


def _launch_keep(state, fok, fcr, alive, window: int, with_chunks: bool):
    """Launch the keep-mask kernels; returns (keep [L, n] bool, ovf [L]
    bool, per-chunk kept counts [L, chunks] int32 or None).  One
    allocation holds the three outputs and the kernels' scratch (the
    outputs are views of it)."""
    global KEEP_LAUNCHES
    L, n, W, G = _check_table(state, fok, fcr, alive)
    lib = _lib()
    ibits, bbits = hashing._bucket_bits(n)
    nchunks, words = _keep_geometry(L, n)
    buf, (_k, ovf_p, cnt_p, scratch) = _scratch(
        state.device, [-(-L * n // 4), -(-L // 4), L * nchunks, words])
    rc = lib.wk_keep_mask(
        L, n, W, G, int(window), bbits, ibits,
        state.data_ptr(), fok.data_ptr(), fcr.data_ptr(), alive.data_ptr(),
        scratch, buf.data_ptr(), ovf_p, cnt_p if with_chunks else None,
        _build.stream(state),
    )
    _build.check(lib, rc, "wk_keep_mask")
    KEEP_LAUNCHES += 1
    base = buf.data_ptr()
    flags = buf.view(torch.uint8)
    keep = flags[: L * n].view(torch.bool).view(L, n)
    ovf = flags[ovf_p - base:][:L].view(torch.bool)
    chunk_cnt = (buf[(cnt_p - base) // 4:][: L * nchunks].view(L, nchunks)
                 if with_chunks else None)
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
    return (keep[0], ovf[0]) if single else (keep, ovf)


def _child_lanes(child, state, n_parents):
    """The explicit child column as a [L, n] bool table like ``state``
    (None stays None); it excludes ``n_parents``, as in the JAX
    package."""
    if child is None:
        return None
    if n_parents is not None:
        raise ValueError("pass either an explicit child column or "
                         "positional n_parents, not both")
    child = child.reshape(state.shape)
    if child.dtype != torch.bool:
        child = child != 0
    return child


def fused_frontier_update(
    state, fok, fcr, alive, cost, capacity: int, window: int = 4,
    n_parents: int | None = None, max_count: int | None = None,
    child=None,
):
    """Drop-in fused replacement for ``hashing.frontier_update_fast``:
    same arguments (``cost`` accepted and unused), same returns
    (state', fok', fcr', alive', overflowed, fp, child).  ``child``: an
    explicit per-row child bit (``[L, n]`` or ``[n]``) for callers whose
    candidate order no longer encodes provenance (the mesh path); it
    excludes ``n_parents``.  See the module docstring for the parity
    contract."""
    (state, fok, fcr, alive), single = hashing._lanes(state, fok, fcr, alive)
    child = _child_lanes(child, state, n_parents)
    n = state.shape[1]
    if not _geometry_ok(n, capacity, max_count):
        raise ValueError(f"fused update infeasible at n={n}, "
                         f"capacity={capacity}, max_count={max_count}")
    m = min(int(max_count), hashing.MXU_PRUNE_MAX_COUNT)
    if state.device.type == "cpu":
        out = fused_frontier_update_ref(state, fok, fcr, alive, capacity,
                                        window, n_parents, max_count, child)
    else:
        out = _launch_fused(state, fok, fcr, alive, capacity, window,
                            n_parents, m, child)
    return tuple(o[0] for o in out) if single else out


def _launch_fused(state, fok, fcr, alive, capacity, window, n_parents, m,
                  child=None):
    global FUSED_LAUNCHES
    keep, _ovf, chunk_cnt = _launch_keep(state, fok, fcr, alive, window, True)
    out = _launch_tail(state, fok, fcr, keep, chunk_cnt, capacity,
                       n_parents, m, child)
    FUSED_LAUNCHES += 1
    return out


def _class_bits(Cb: int) -> int:
    """Class super-bucket bits of the prune's partition of a Cb-row
    buffer: about 8 rows per super-bucket, so a list holds one big class
    or a few small ones."""
    return max(1, (Cb - 1).bit_length() - 3)


def _scratch(dev, sizes):
    """One int32 allocation cut into 256-byte-aligned regions of the
    given int32 counts: (the tensor, which must outlive the launch, and
    each region's address)."""
    offs, total = [], 0
    for s in sizes:
        offs.append(total)
        total += -(-s // 64) * 64
    buf = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
    return buf, [buf.data_ptr() + 4 * o for o in offs]


def _launch_tail(state, fok, fcr, keep, chunk_cnt, capacity, n_parents, m,
                 child=None):
    """Launch ``wk_fused_tail`` on a keep mask and its per-chunk kept
    counts (``_launch_keep(..., with_chunks=True)``); returns the fused
    update's outputs.  It reads its inputs only, so it can be timed on
    its own."""
    (L, n), W, G = state.shape, fok.shape[2], fcr.shape[2]
    if child is not None and (child.device != state.device
                              or not child.is_contiguous()):
        raise ValueError("child must be a contiguous table on the same "
                         "CUDA device as state")
    lib = _lib()
    C = int(capacity)
    Cb = 2 * C
    cbits = _class_bits(Cb)
    S = 1 << cbits
    dev = state.device
    # nk0; bst, bfo, bfc; bch, dead (bytes); bcls, clist; ccnt, coff, cursor
    rows = L * Cb
    buf, scratch = _scratch(dev, [L, rows, rows * W, -(-rows * G // 2),
                                  -(-rows // 4), -(-rows // 4), rows, rows,
                                  L * S, L * S, L * S])
    i32 = dict(dtype=torch.int32, device=dev)
    u8 = dict(dtype=torch.bool, device=dev)
    kst = torch.empty(L, C, **i32)
    kfo = torch.empty(L, C, W, **i32)
    kfc = torch.empty(L, C, G, dtype=torch.int16, device=dev)
    alv = torch.empty(L, C, **u8)
    chd = torch.empty(L, C, **u8)
    ovf = torch.empty(L, **u8)
    fp = torch.empty(L, 3, dtype=torch.int64, device=dev)
    rc = lib.wk_fused_tail(
        L, n, C, W, G, int(m), -1 if n_parents is None else int(n_parents),
        cbits, state.data_ptr(), fok.data_ptr(), fcr.data_ptr(),
        None if child is None else child.data_ptr(),
        keep.data_ptr(), chunk_cnt.data_ptr(), *scratch,
        *(t.data_ptr() for t in (kst, kfo, kfc, alv, chd, ovf, fp)),
        _build.stream(state),
    )
    _build.check(lib, rc, "wk_fused_tail")
    # Freed once enqueued: the caching allocator reuses it in stream order.
    del buf
    return kst, kfo, kfc, alv, ovf, fp, chd


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
                              max_count: int | None = None, child=None):
    """Plain version of ``fused_frontier_update`` over [L, n] tables:
    the keep mask of ``keep_mask_ref``; the first 2C survivors in
    candidate order form the buffer (more is a spill); ``prune_ref``;
    the first C buffer survivors are the output (more is an overflow),
    dead rows zero; an output row's child bit is its source row's
    ``child`` entry, else ``index >= n_parents``; the fingerprint sums
    two row hashes of the alive output rows and counts them, mod 2^32."""
    child = _child_lanes(child, state, n_parents)
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
        if child is not None:
            chd[l, :k] = child[l, sel[out]]
        elif n_parents is not None:
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


# ---------------------------------------------------------------------------
# Mesh-spanning wide stage: class-hash routed shards and the exchange
# ---------------------------------------------------------------------------


def _pad_rows(n: int) -> int:
    return ((n + TILE - 1) // TILE) * TILE


def exchange_cols(w: int, g: int) -> int:
    """int32 columns per exchanged row:
    [ state | fok lanes | fcr groups | alive | child ]."""
    return 1 + w + g + 2


def mesh_rcap(n_loc: int, devices: int) -> int:
    """Fixed per-target receive-slot rows for a shard of ``n_loc``
    candidate rows on ``devices`` shards: ``ceil(HEADROOM * n_loc / D)``
    padded to TILE rows (the JAX package's arithmetic, float and all)."""
    per = int(math.ceil(MESH_RCAP_HEADROOM * n_loc / devices))
    return _pad_rows(max(per, 1))


def mesh_feasible(n: int, capacity: int, max_count, devices: int) -> bool:
    """Whether the mesh-spanning stage runs at GLOBAL shape ``n``
    candidate rows / ``capacity`` output rows on ``devices`` shards: the
    JAX package's ``mesh_feasible`` without its two VMEM terms.  At
    least two shards, both totals split evenly, and each shard's slice
    (the received ``D * rcap`` rows against ``capacity / D``) passes the
    fused update's gate with the JAX package's 64-row granule.  The
    routing floor (``wide_min_capacity``) applies per shard, as in the
    JAX package."""
    if devices < 2 or capacity % devices or n % devices:
        return False
    cap_d = capacity // devices
    rcap = mesh_rcap(n // devices, devices)
    return (cap_d % (TILE // 2) == 0
            and fused_feasible(devices * rcap, cap_d, max_count))


def mesh_occupancy(capacity: int, P: int, G: int, W: int | None = None,
                   max_count: int | None = None, devices: int = 2) -> dict:
    """Per-shard geometry of one mesh-spanning stage at a rung's GLOBAL
    shape, and the bytes one exchange moves (every send slot read once,
    every receive slot written once).  Pure arithmetic."""
    W = (P + 31) // 32 if W is None else W
    D = int(devices)
    n = int(capacity) * (1 + P + G)
    rcap = mesh_rcap(n // D, D)
    return {
        "devices": D,
        "per_device_capacity": int(capacity) // D,
        "candidates": n,
        "rcap": rcap,
        "recv_rows": D * rcap,
        "exchange_bytes": 2 * D * D * rcap * exchange_cols(W, G) * 4,
        "feasible": mesh_feasible(n, int(capacity), max_count, D),
    }


def mesh_exchange(mesh, send):
    """Exchange the shards' pre-rotated slot matrices.  ``send`` is
    ``[D, D, rcap, NC]`` int32: shard ``me``'s slot ``s`` is its bucket
    for shard ``(me + s) % D``.  Returns ``recv`` of the same shape:
    shard ``r``'s slot ``s`` holds the rows source ``(r - s) % D`` sent.
    CPU tensors run ``mesh_exchange_ref``; CUDA tensors launch the
    kernel or raise."""
    D = mesh.size
    if send.dim() != 4 or tuple(send.shape[:2]) != (D, D):
        raise ValueError(f"send must be [{D}, {D}, rcap, NC], "
                         f"got {tuple(send.shape)}")
    if send.dtype != torch.int32:
        raise TypeError(f"send must be int32, got {send.dtype}")
    if send.is_cpu:
        return mesh_exchange_ref(send)
    return _launch_exchange(send)


def _exchange_bases(send, recv):
    """The exchange kernel's pointer tables: shard m's send and receive
    base addresses, as two host arrays of ``MESH_MAX_SHARDS`` pointers
    that the kernel takes by value at launch (no copy to the card).
    Raises ValueError for more shards than the kernel's parameter holds,
    or for slot matrices that the 16-byte path cannot address."""
    D, _, rcap, nc = send.shape
    if D > MESH_MAX_SHARDS:
        raise ValueError(f"the exchange kernel takes at most "
                         f"{MESH_MAX_SHARDS} shards, got {D}")
    step = D * rcap * nc * send.element_size()
    s0, r0 = send.data_ptr(), recv.data_ptr()
    if (rcap * nc) % 4 == 0 and (s0 % 16 or r0 % 16):
        raise ValueError("shard slot matrices must be 16-byte aligned")
    sb, rb = _Bases(), _Bases()
    sb[:D] = [s0 + m * step for m in range(D)]
    rb[:D] = [r0 + m * step for m in range(D)]
    return sb, rb


def _launch_exchange(send):
    global EXCHANGE_LAUNCHES
    D, _, rcap, nc = send.shape
    if not send.is_cuda:
        raise ValueError("send must lie on a CUDA device")
    if not send.is_contiguous():
        raise ValueError("send must be contiguous")
    recv = torch.empty_like(send)
    send_b, recv_b = _exchange_bases(send, recv)
    lib = _build.load("mesh_exchange", _EXCHANGE_SIGNATURES)
    rc = lib.wk_mesh_exchange(D, rcap * nc, send_b, recv_b,
                              _build.stream(send))
    _build.check(lib, rc, "wk_mesh_exchange")
    EXCHANGE_LAUNCHES += 1
    return recv


def mesh_exchange_ref(send):
    """Plain version of ``mesh_exchange``: the ring's stores, one slot
    copy at a time, ``recv[(me + s) % D, s] = send[me, s]``."""
    D = send.shape[0]
    recv = torch.empty_like(send)
    for me in range(D):
        for s in range(D):
            recv[(me + s) % D, s] = send[me, s]
    return recv


def mesh_frontier_update(
    mesh, state, fok, fcr, alive, cost, capacity: int, window: int = 4,
    n_parents: int | None = None, max_count: int | None = None,
    child=None,
):
    """The mesh-spanning fused wide stage over ``[D, n_loc]`` tables,
    one shard per row of the leading axis (the JAX package's per-shard
    body of ``mesh_frontier_update``, every shard at once).
    ``capacity`` is per shard; ``n_parents`` (per shard) or ``child``
    gives the child bits.  Returns (state', fok', fcr', alive' [D, C],
    overflowed [] bool, fp [3] int64, child [D, C]): the row outputs are
    each shard's slice of the global frontier, ``overflowed`` and ``fp``
    (mod 2^32) are global, as the JAX package's psums make them.

    Phases, as in the JAX package: (1) route every alive row to shard
    ``hash(state, fok) % D`` and place it by its rank among that
    target's rows in its pre-rotated slot (slot ``(target - me) % D``);
    a rank at or past ``rcap`` is a spill (overflow, never silent loss)
    and dead or spilled rows go to a drop row; (2) ``mesh_exchange``;
    (3) un-rotate into source-major order, move parents ahead of
    children with a stable partition (dedup keeps the first copy and
    domination ties the earlier row, so a parent must precede an
    identical child, or a re-routed duplicate would bring back the child
    bit every round and the engine's no-growth fixpoint would never
    settle), and run the fused update with the child column.  Routing,
    ranks and the partition are integer-exact, so each shard's outputs,
    positions included, are the JAX package's."""
    D = mesh.size
    if state.dim() != 2 or state.shape[0] != D:
        raise ValueError(f"state must be [{D}, n_loc], got {tuple(state.shape)}")
    n_loc = state.shape[1]
    W, G = fok.shape[2], fcr.shape[2]
    NC = exchange_cols(W, G)
    rcap = mesh_rcap(n_loc, D)
    dev = state.device
    if child is None:
        first = n_loc if n_parents is None else int(n_parents)
        child = (torch.arange(n_loc, device=dev) >= first).expand(D, n_loc)
    elif n_parents is not None:
        raise ValueError("pass either an explicit child column or "
                         "positional n_parents, not both")
    shard = torch.arange(D, device=dev)

    # ---- phase 1: class-hash routing into fixed per-target slots ----
    target = hashing.hash_rows(
        [state] + [fok[..., k] for k in range(W)], MESH_ROUTE_SEED) % D
    onehot = (target[..., None] == shard) & alive[..., None]
    csum = torch.cumsum(onehot, 1, dtype=torch.int32)
    rank = csum.gather(2, target[..., None]).squeeze(2) - 1
    spill = (csum[:, -1, :] > rcap).any()
    ok = alive & (rank < rcap)
    slot = (target - shard[:, None]) % D
    flat = torch.where(ok, (shard[:, None] * D + slot) * rcap + rank,
                       D * D * rcap)
    packed = torch.cat([
        state[..., None], fok, fcr.to(torch.int32),
        ok[..., None].to(torch.int32), child[..., None].to(torch.int32),
    ], -1)
    buf = torch.zeros(D * D * rcap + 1, NC, dtype=torch.int32, device=dev)
    buf.index_copy_(0, flat.reshape(-1), packed.reshape(-1, NC))
    send = buf[: D * D * rcap].view(D, D, rcap, NC)

    # ---- phase 2: the exchange ----
    recv = mesh_exchange(mesh, send)

    # ---- phase 3: source-major order, parents first, the fused update --
    src = (shard[:, None] - shard[None, :]) % D
    table = recv[shard[:, None], src].reshape(D, D * rcap, NC)
    ic = table[..., NC - 1] != 0
    pc = ~ic
    dest = torch.where(ic, pc.sum(1, keepdim=True) + torch.cumsum(ic, 1) - 1,
                       torch.cumsum(pc, 1) - 1)
    table = torch.empty_like(table).scatter_(
        1, dest[..., None].expand(-1, -1, NC), table)
    kst, kfo, kfc, al2, ovf, fp, ch2 = fused_frontier_update(
        table[..., 0].contiguous(), table[..., 1:1 + W].contiguous(),
        table[..., 1 + W:1 + W + G].to(torch.int16),
        table[..., 1 + W + G] != 0, None, capacity, window=window,
        max_count=max_count, child=table[..., NC - 1] != 0,
    )
    return (kst, kfo, kfc, al2, (ovf | spill).any(),
            fp.sum(0) & hashing.MASK32, ch2)
