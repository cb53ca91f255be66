"""Row hashing, dedup, domination pruning and compaction of the frontier.

The port of the JAX package's ``ops/hashing.py``.  The frontier is a
struct-of-arrays table with a leading lane axis (the JAX package vmaps
one lane; here every function takes ``[L, n]`` tables, and a 1-D table
is treated as one lane):

  state [L, n] int32 · fok [L, n, W] int32 (the uint32 fired-open-op
  bitsets, carried as int32 bit patterns) · fcr [L, n, G] int16 (fired
  count per crashed group) · alive [L, n] bool

torch on the CPU has no ``>>`` or ``+`` for uint32, so the 32-bit hash
lanes are carried as int64 tensors masked to ``0xFFFFFFFF``; products
are split into 16-bit halves so no int64 product overflows.  Hashes,
keep masks and fingerprints are bit-identical to the JAX package's.

Two frontier updates:

  * ``frontier_update_fast`` — the fast engines' update: hash dedup
    (kills need both 32-bit hash lanes equal), the one-hot matmul
    domination prune on a 2C buffer, cumsum-rank compaction.
  * ``frontier_update`` — the exact engine's update: rows sorted by
    their (state, fok) class hash and cost, windowed content compares,
    then an exact pairwise domination pass (``dominate``); every kill is
    content-decided.

Three dedup backends (``dedup_backend``):

  * "sort"   — one stable single-key sort of the hash lanes
    (``_keep_sort``); in ``frontier_update``, the 4-key sort by
    (dead, class hash, cost) done as three stable ``torch.sort`` passes
    from the least significant key, which is the JAX package's order
    exactly.
  * "bucket" — the packed radix bucket partition of ``_keep_bucket``
    (one single-key sort of ``[dead | bucket | index]``, windowed 64-bit
    hash kills); in ``frontier_update``, the same partition by the class
    hash.  An infeasible geometry (``bucket_feasible``) routes to "sort".
  * "fused"  — the port's name for the JAX package's "pallas" backend:
    the fused wide-stage update of ``ops.wide_kernel`` (hand-written
    CUDA on the card), routed on wide rungs (``fused_feasible``); other
    rounds fall down the bucket -> sort ladder, as in the JAX package,
    and ``frontier_update`` rides the bucket partition.  It is the
    default, because it is the configuration this port carries.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9

#: Row-hash / fingerprint fold seeds (the JAX package's values: the
#: hashes are part of the contract the differential tests check).
HASH_SEED_1 = 0xB00B_135
HASH_SEED_2 = 0x1CEB_00DA
FP_SEED_1 = 0xFEED_0001
FP_SEED_2 = 0xFEED_0002

#: Recognized dedup backends (see the module docstring).
DEDUP_BACKENDS = ("sort", "bucket", "fused")

#: The backend when the caller names none; the env var below overrides
#: it, an explicit ``dedup_backend=`` argument overrides both.
DEDUP_BACKEND = "fused"

DEDUP_BACKEND_ENV = "JEPSEN_TPU_DEDUP_BACKEND"

#: The JAX package's names for the port's backends, accepted from the
#: env var so that one environment runs the same route in both packages.
_ENV_ALIASES = {"pallas": "fused"}

#: Fewer bucket bits than this and the radix partition degenerates into
#: a handful of giant buckets; such tables (more than 2^25 candidate
#: rows) route to the sort path.
BUCKET_MIN_BITS = 6

#: One-hot plane count for the matmul prune; counts at or above the last
#: plane compare saturating (sound at any count, exact below M-1).
MXU_PRUNE_MAX_COUNT = 64


def resolve_dedup_backend(backend: str | None = None) -> str:
    """The dedup backend to use: the explicit argument, else the
    JEPSEN_TPU_DEDUP_BACKEND env var (its "pallas" read as "fused"),
    else the module default."""
    env = os.environ.get(DEDUP_BACKEND_ENV)
    b = backend or _ENV_ALIASES.get(env, env) or DEDUP_BACKEND
    if b not in DEDUP_BACKENDS:
        raise ValueError(
            f"unknown dedup backend {b!r}; expected one of {DEDUP_BACKENDS}"
        )
    return b


def _bucket_bits(n: int) -> tuple[int, int]:
    """(index_bits, bucket_bits) of the packed radix key for an
    ``n``-row candidate table: 1 dead bit + bucket_bits of hash prefix +
    index_bits of candidate index in one uint32."""
    ibits = max(1, (n - 1).bit_length())
    return ibits, 31 - ibits


def bucket_feasible(n: int) -> bool:
    """Whether the packed bucket geometry is usable at ``n`` rows."""
    return _bucket_bits(n)[1] >= BUCKET_MIN_BITS


def _lanes(*xs):
    """Give 1-D tables (one lane) a leading lane axis; returns the
    tensors and whether they were unbatched."""
    single = xs[0].dim() == 1
    if single:
        xs = tuple(x.unsqueeze(0) for x in xs)
    return xs, single


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 32-bit values in int64 without overflowing:
    the high half's product is reduced mod 2^16 before the shift."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def mix32(x):
    """murmur3 fmix32 finalizer over int64-carried uint32 values."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def u32(x):
    """Any integer tensor as its uint32 bit pattern, carried in int64
    (negative int32/int16 values wrap as ``astype(uint32)`` does)."""
    return x.to(torch.int64) & MASK32


def hash_rows(columns, seed: int):
    """Hash a list of equal-shape integer column tensors to one uint32
    lane (int64-carried), column by column."""
    h = torch.full(columns[0].shape, (seed ^ _GOLDEN) & MASK32,
                   dtype=torch.int64, device=columns[0].device)
    for col in columns:
        h = mix32(h ^ u32(col))
    return h


def row_columns(state, fok, fcr):
    """The hashed columns of a table, in the fold order: state, then the
    fok lanes, then the fcr groups."""
    return ([state] + [fok[..., k] for k in range(fok.shape[-1])]
            + [fcr[..., k] for k in range(fcr.shape[-1])])


def row_hashes(state, fok, fcr):
    """The two 32-bit dedup hash lanes of every row."""
    cols = row_columns(state, fok, fcr)
    return hash_rows(cols, HASH_SEED_1), hash_rows(cols, HASH_SEED_2)


def np_mix32(x) -> np.ndarray:
    """Host-side mirror of ``mix32`` in numpy uint32: bit-identical on
    the same input, so hashes on either side of a device-to-host spill
    agree (the spill merge's bucket keys are the class hashes)."""
    x = np.asarray(x).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_C1)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(_C2)
    x = x ^ (x >> np.uint32(16))
    return x


def np_hash_rows(columns, seed: int) -> np.ndarray:
    """Host-side mirror of ``hash_rows`` (same constants, same fold
    order), as numpy uint32."""
    cols = [np.asarray(c) for c in columns]
    h = np.full(cols[0].shape, np.uint32((seed ^ _GOLDEN) & MASK32), np.uint32)
    for col in cols:
        h = np_mix32(h ^ col.astype(np.uint32))
    return h


def np_class_hash(state, fok) -> tuple[np.ndarray, np.ndarray]:
    """The two 32-bit lanes of a host frontier's (state, fok) class hash:
    identical classes always share both lanes, so the pair is the bucket
    key of the host-spill merge (``ops.spill.merge_frontiers``).  fok
    may be uint32 or the port's int32 bit patterns."""
    state = np.asarray(state)
    fok = np.asarray(fok)
    cols = [state] + [fok[:, k] for k in range(fok.shape[1])]
    return np_hash_rows(cols, HASH_SEED_1), np_hash_rows(cols, HASH_SEED_2)


def _keep_sort(h1, h2, alive, window: int):
    """Hash-dup keep mask, sort formulation (the JAX package's
    ``_keep_sort``, lane-batched): one stable single-key sort by h1 (dead
    rows keyed ``0xFFFFFFFF``, after every alive row of a smaller key);
    a row is a dup when one of its ``window`` sorted predecessors is
    alive with both hash lanes equal.  ``jax.lax.sort`` is stable, so
    ties keep candidate order and the mask is bit-identical.  Returns
    the keep mask in candidate order."""
    n = h1.shape[-1]
    key = torch.where(alive, h1, MASK32)
    order = torch.sort(key, dim=-1, stable=True).indices
    k1 = key.gather(-1, order)
    k2 = h2.gather(-1, order)
    al = alive.gather(-1, order)
    pos = torch.arange(n, device=h1.device)
    dup = torch.zeros_like(al)
    for k in range(1, window + 1):
        dup = dup | ((k1 == torch.roll(k1, k, -1)) & (k2 == torch.roll(k2, k, -1))
                     & torch.roll(al, k, -1) & (pos >= k))
    keep = al & ~dup
    return torch.zeros_like(keep).scatter(-1, order, keep)


def _keep_bucket(h1, h2, alive, window: int):
    """Hash-dup keep mask, bucketed radix formulation (the JAX package's
    ``_keep_bucket``, lane-batched).

    Rows partition by the top bucket bits of h1: ``[dead:1 | bucket:b |
    index:i]`` packed in one key and sorted (the key is unique, so the
    order is deterministic and survivors are always the first copy in
    candidate order).  A row dies when one of its ``window`` sorted
    predecessors is alive with both hash lanes equal.  ``overflow``
    marks a survivor whose whole window was same-bucket alive rows
    (possible bloat, never loss).

    Returns (keep mask in candidate order, overflow per lane).
    """
    n = h1.shape[-1]
    ibits, bbits = _bucket_bits(n)
    if bbits < 1:
        raise ValueError(f"bucket geometry infeasible at {n} rows")
    iota = torch.arange(n, device=h1.device)
    packed = (
        torch.where(alive, 0, 1 << 31)
        | ((h1 >> (32 - bbits)) << ibits)
        | iota
    )
    spacked = torch.sort(packed, dim=-1).values
    al = spacked < (1 << 31)
    sidx = spacked & ((1 << ibits) - 1)
    sh1 = h1.gather(-1, sidx)
    sh2 = h2.gather(-1, sidx)
    sbucket = spacked >> ibits  # dead bit folds into bucket
    dup = torch.zeros_like(al)
    full = torch.ones_like(al)  # window entirely same-bucket alive rows
    for k in range(1, window + 1):
        pal = torch.roll(al, k, -1) & (iota >= k)
        dup = dup | ((sh1 == torch.roll(sh1, k, -1))
                     & (sh2 == torch.roll(sh2, k, -1)) & pal)
        full = full & (sbucket == torch.roll(sbucket, k, -1)) & pal
    keep = al & ~dup
    overflow = (full & keep).any(-1)
    keep_orig = torch.zeros_like(keep).scatter(-1, sidx, keep)
    return keep_orig, overflow


def exact_prune_mxu(state, fok, fcr, alive, max_count: int):
    """Kill duplicate and dominated rows, with the pairwise pointwise-≤
    test as one matmul (the JAX package's ``exact_prune_mxu``).

    Each row's fired-crashed counts become a cumulative one-hot
    u[k, c] = (fcr[k] ≤ c) and a saturating exact one-hot
    v[k, c] = (min(fcr[k], M-1) == c), both [n, G·M] with
    M = min(max_count, MXU_PRUNE_MAX_COUNT); (u @ vᵀ)[i, j] counts the
    groups where fcr_i ≤ min(fcr_j, M-1), so == G ⟹ pointwise ≤.  The
    counts are at most G ≤ 64, exact in float32.  Row j dies when an
    alive row i of the same (state, fok) class is ≤ pointwise and either
    not ≥ pointwise or earlier in the table (ties keep the first copy).
    """
    L, n = state.shape
    g = fcr.shape[-1]
    m = min(int(max_count), MXU_PRUNE_MAX_COUNT)
    c = torch.arange(m, device=fcr.device)
    f = fcr.to(torch.int64)
    sat = torch.clamp(f, max=m - 1)
    u = (f[..., None] <= c).reshape(L, n, g * m).to(torch.float32)
    v = (sat[..., None] == c).reshape(L, n, g * m).to(torch.float32)
    cnt = torch.bmm(u, v.transpose(1, 2))
    le = cnt > g - 0.5  # le[i, j]: fcr_i ≤ fcr_j pointwise
    same = state[:, :, None] == state[:, None, :]
    for k in range(fok.shape[-1]):
        col = fok[..., k]
        same &= col[:, :, None] == col[:, None, :]
    idx = torch.arange(n, device=state.device)
    earlier = idx[:, None] < idx[None, :]
    killer = (
        same & le & (~le.transpose(1, 2) | earlier)
        & alive[:, :, None] & alive[:, None, :]
    )
    return alive & ~killer.any(dim=1)


def _fingerprint(kst, kfo, kfc, new_alive):
    """Order-insensitive content fingerprint of the alive rows: the sums
    mod 2^32 of two row hashes, and the alive count."""
    cols = row_columns(kst, kfo, kfc)
    am = new_alive.to(torch.int64)
    r1 = (hash_rows(cols, FP_SEED_1) * am).sum(-1) & MASK32
    r2 = (hash_rows(cols, FP_SEED_2) * am).sum(-1) & MASK32
    return torch.stack([r1, r2, am.sum(-1)], -1)


def _gather_rows(x, idx):
    """x[l, idx[l, r], ...] for a [L, n] index table."""
    if x.dim() == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def frontier_update_fast(
    state, fok, fcr, alive, cost, capacity: int, window: int = 4,
    n_parents: int | None = None, max_count: int | None = None,
    dedup_backend: str = "fused",
):
    """Frontier dedup, domination prune and truncation for one engine
    round (the JAX package's ``frontier_update_fast``, lane-batched).

      1. hash each row to 64 bits (two uint32 lanes);
      2. dedup: a row dies when an alive earlier copy within ``window``
         sorted neighbours has both lanes equal (``_keep_bucket`` under
         "bucket"/"fused", whose survivors are the first copy in
         candidate order; ``_keep_sort`` under "sort" or when the bucket
         geometry is infeasible);
      3. survivors compact in candidate order into a 2·capacity buffer,
         which is domination-pruned (``exact_prune_mxu`` when
         ``max_count`` bounds the counts, else ``exact_prune``);
      4. the antichain compacts to ``capacity`` by cumsum rank.

    ``cost`` is accepted for signature parity and unused: candidate
    order already approximates cheapest-first.  ``max_count`` is the
    static bound on any count (callers pass the mover-table size + 1).
    ``n_parents``: the first ``n_parents`` candidate rows are the
    previous frontier, so the returned ``child`` marks survivors that
    came from an expansion.

    ``dedup_backend="fused"`` routes feasible wide geometry
    (``wide_kernel.fused_feasible``) to the fused update, whose alive
    rows, positions, overflow flag, fingerprint and ``child & alive``
    are bit-identical to the bucket path's; its dead rows are zeros
    where this path leaves row-0 copies.

    Returns (state', fok', fcr', alive', overflowed, fp, child): fp is
    [L, 3] int64 (uint32 values), overflowed [L] bool.
    """
    if dedup_backend not in DEDUP_BACKENDS:
        raise ValueError(f"unknown dedup backend {dedup_backend!r}")
    (state, fok, fcr, alive), single = _lanes(state, fok, fcr, alive)
    L, n = state.shape
    if dedup_backend == "fused":
        from jepsen_tpu_torch.ops import wide_kernel

        if wide_kernel.fused_feasible(n, capacity, max_count):
            out = wide_kernel.fused_frontier_update(
                state, fok, fcr, alive, cost, capacity, window=window,
                n_parents=n_parents, max_count=max_count,
            )
            return tuple(o[0] for o in out) if single else out
    dev = state.device
    h1, h2 = row_hashes(state, fok, fcr)
    if dedup_backend in ("bucket", "fused") and bucket_feasible(n):
        keep_orig, _bovf = _keep_bucket(h1, h2, alive, window)
    else:
        keep_orig = _keep_sort(h1, h2, alive, window)
    Cb = min(2 * capacity, n)
    iota = torch.arange(n, device=dev)
    rank = torch.cumsum(keep_orig, -1) - 1
    n_keep0 = torch.clamp(rank[:, -1] + 1, min=0)
    pos2 = torch.where(keep_orig, rank, Cb + iota)
    srcB = torch.zeros(L, Cb + n, dtype=torch.int64, device=dev).scatter(
        1, pos2, iota.expand(L, n))[:, :Cb]
    bst = _gather_rows(state, srcB)
    bfo = _gather_rows(fok, srcB)
    bfc = _gather_rows(fcr, srcB)
    cb_iota = torch.arange(Cb, device=dev)
    balive = cb_iota < torch.clamp(n_keep0, max=Cb)[:, None]
    spill = n_keep0 > Cb
    if max_count is not None:
        balive = exact_prune_mxu(bst, bfo, bfc, balive, max_count)
    else:
        balive = exact_prune(bst, bfo, bfc, balive)
    rank2 = torch.cumsum(balive, -1) - 1
    n_keep = torch.clamp(rank2[:, -1] + 1, min=0)
    pos3 = torch.where(balive, rank2, capacity + cb_iota)
    src2 = torch.zeros(L, capacity + Cb, dtype=torch.int64, device=dev).scatter(
        1, pos3, cb_iota.expand(L, Cb))[:, :capacity]
    kst = _gather_rows(bst, src2)
    kfo = _gather_rows(bfo, src2)
    kfc = _gather_rows(bfc, src2)
    new_alive = (torch.arange(capacity, device=dev)
                 < torch.clamp(n_keep, max=capacity)[:, None])
    overflowed = spill | (n_keep > capacity)
    if n_parents is None:
        child = torch.zeros(L, capacity, dtype=torch.bool, device=dev)
    else:
        child = srcB.gather(1, src2) >= n_parents
    fp = _fingerprint(kst, kfo, kfc, new_alive)
    out = (kst, kfo, kfc, new_alive, overflowed, fp, child)
    return tuple(o[0] for o in out) if single else out


def _lex_order(keys):
    """The permutation that sorts ``[L, n]`` rows by the int64 key
    tensors ``keys`` (most significant first), ties in index order: one
    stable sort per key, from the least significant, which is the order
    of ``jax.lax.sort`` with ``num_keys`` keys and an index payload."""
    perm = None
    for k in reversed(keys):
        if perm is not None:
            k = k.gather(-1, perm)
        step = torch.sort(k, dim=-1, stable=True).indices
        perm = step if perm is None else perm.gather(-1, step)
    return perm


def frontier_update(
    state, fok, fcr, alive, cost, capacity: int, window: int = 16,
    dedup_backend: str = "fused",
):
    """One-pass exact frontier maintenance: dedup, domination and
    truncation (the JAX package's ``frontier_update``, lane-batched).

    Rows sort by (dead, class hash of (state, fok), cost), index-stable,
    so rows of one class lie together, cheapest first; a row dies when
    one of its ``window`` sorted predecessors is alive with the same
    exact (state, fok) and pointwise <= counts.  Under "bucket" and
    "fused" the first sort is the packed radix partition by the top bits
    of the class hash (class-mates share a bucket; rows stay in
    candidate order within it); an infeasible geometry takes the sort.
    The survivors, cheapest first, fill a 2·capacity buffer that
    ``dominate`` prunes exactly; the antichain truncates to capacity,
    cheapest first.  Every kill compares content, so this engine's
    refutations are final under every backend.

    ``cost`` [L, n]: the truncation priority (fired ops per row).
    Returns (state', fok', fcr', alive', overflowed, fp): overflowed
    when the buffer spilled or the antichain exceeded capacity (loss);
    fp the order-insensitive fingerprint, [L, 3] int64.
    """
    if dedup_backend not in DEDUP_BACKENDS:
        raise ValueError(f"unknown dedup backend {dedup_backend!r}")
    (state, fok, fcr, alive, cost), single = _lanes(state, fok, fcr, alive,
                                                    cost)
    L, n = state.shape
    dev = state.device
    class_cols = [state] + [fok[..., k] for k in range(fok.shape[-1])]
    ch1 = hash_rows(class_cols, HASH_SEED_1)
    ch2 = hash_rows(class_cols, HASH_SEED_2)
    iota = torch.arange(n, device=dev)
    dead = (~alive).to(torch.int64)
    if dedup_backend in ("bucket", "fused") and bucket_feasible(n):
        ibits, bbits = _bucket_bits(n)
        packed = (dead << 31) | ((ch1 >> (32 - bbits)) << ibits) | iota
        spacked = torch.sort(packed, dim=-1).values
        al = spacked < (1 << 31)
        sidx = spacked & ((1 << ibits) - 1)
    else:
        sidx = _lex_order([(dead << 32) | ch1, ch2, u32(cost)])
        al = alive.gather(-1, sidx)
    st = state.gather(-1, sidx)
    fo = _gather_rows(fok, sidx)
    fc = _gather_rows(fcr, sidx)
    killed = torch.zeros_like(al)
    for k in range(1, window + 1):
        pfo = torch.roll(fo, k, 1)
        pfc = torch.roll(fc, k, 1)
        same = ((torch.roll(st, k, 1) == st) & (pfo == fo).all(-1)
                & torch.roll(al, k, 1) & (iota >= k))
        killed = killed | (same & (pfc <= fc).all(-1))
    alive_d = al & ~killed
    n_w = alive_d.sum(-1)
    b2 = min(2 * capacity, n)
    sc2 = u32(cost).gather(-1, sidx)
    bsel = _lex_order([(~alive_d).to(torch.int64), sc2])[:, :b2]
    bst = st.gather(-1, bsel)
    bfo = _gather_rows(fo, bsel)
    bfc = _gather_rows(fc, bsel)
    bcost = sc2.gather(-1, bsel)
    balive = (torch.arange(b2, device=dev)
              < torch.clamp(n_w, max=b2)[:, None])
    balive = dominate(bst, bfo, bfc, balive)
    n_x = balive.sum(-1)
    keep = _lex_order([(~balive).to(torch.int64), bcost])[:, :capacity]
    kst = bst.gather(-1, keep)
    kfo = _gather_rows(bfo, keep)
    kfc = _gather_rows(bfc, keep)
    new_alive = (torch.arange(capacity, device=dev)
                 < torch.clamp(n_x, max=capacity)[:, None])
    overflowed = (n_w > b2) | (n_x > capacity)
    fp = _fingerprint(kst, kfo, kfc, new_alive)
    out = (kst, kfo, kfc, new_alive, overflowed, fp)
    return tuple(o[0] for o in out) if single else out


def _pairwise_chunk(f: int, g: int, lanes: int, elements: int) -> int:
    """Killed-axis chunk of the exact pairwise passes: keeps their
    [L, f, chunk, G] intermediates near ``elements``."""
    return min(f, max(16, elements // max(1, lanes * f * g)))


def _pairwise_kills(state, fok, fcr, alive, ties: bool, chunk_rows: int):
    """[L, f] mask of rows killed by an alive row of the same (state,
    fok) with pointwise <= counts that is strictly smaller somewhere, or
    (``ties``) equal and earlier in the table; chunked over the killed
    axis.  The class compare runs over every pair of a chunk, the count
    compares only over the pairs of one class: on an H100 that is faster
    than comparing the counts of every pair (``chip_smoke.py``'s
    ``pairwise`` lines; PERF.md)."""
    L, f = state.shape
    if chunk_rows <= 0:
        # the JAX package's 4M-element bound on the CPU; on the card a
        # 64M-element chunk keeps the host's loop short
        chunk_rows = _pairwise_chunk(
            f, fcr.shape[-1], L, 1 << (22 if state.device.type == "cpu" else 26))
    killed = torch.zeros(L, f, dtype=torch.bool, device=state.device)
    for lo in range(0, f, chunk_rows):
        hi = min(f, lo + chunk_rows)
        same = ((state[:, :, None] == state[:, None, lo:hi])
                & (fok[:, :, None, :] == fok[:, None, lo:hi, :]).all(-1)
                & alive[:, :, None] & alive[:, None, lo:hi])
        ln, i, j = same.nonzero(as_tuple=True)
        j = j + lo
        fi, fj = fcr[ln, i], fcr[ln, j]
        lt = (fi < fj).any(-1)
        if ties:
            lt = lt | (i < j)
        dom = (fi <= fj).all(-1) & lt
        killed[ln[dom], j[dom]] = True
    return killed


def exact_prune(state, fok, fcr, alive, chunk_rows: int = 0):
    """Kill duplicate and dominated rows, exactly (the JAX package's
    ``exact_prune``): row j dies when an alive row i of the same (state,
    fok) has pointwise <= counts and is strictly smaller somewhere or
    earlier in the table (ties keep the first copy).  Chunked over the
    killed axis to bound the [L, f, chunk, G] intermediates."""
    (state, fok, fcr, alive), single = _lanes(state, fok, fcr, alive)
    out = alive & ~_pairwise_kills(state, fok, fcr, alive, True, chunk_rows)
    return out[0] if single else out


def dominate(state, fok, fcr, alive, chunk_rows: int = 0):
    """Kill dominated rows (the JAX package's ``dominate``): row j dies
    when an alive row i of the same (state, fok) fired pointwise <= and
    not equal crashed counts.  Duplicates both stay.  Chunked over the
    dominated axis."""
    (state, fok, fcr, alive), single = _lanes(state, fok, fcr, alive)
    out = alive & ~_pairwise_kills(state, fok, fcr, alive, False, chunk_rows)
    return out[0] if single else out


def _dedup_stage(state, fok, fcr, alive, window: int = 4,
                 dedup_backend: str = "fused"):
    """Just the dedup stage of ``frontier_update_fast`` (row hash,
    partition, windowed kills): the keep mask in candidate order.  Under
    "fused" the standalone keep-mask kernel (``wide_kernel.keep_mask``,
    bit-identical to ``_keep_bucket``); then the bucket -> sort ladder,
    as in the JAX package."""
    if dedup_backend not in DEDUP_BACKENDS:
        raise ValueError(f"unknown dedup backend {dedup_backend!r}")
    n = state.shape[-1]
    if dedup_backend == "fused" and bucket_feasible(n):
        from jepsen_tpu_torch.ops import wide_kernel

        keep, _ovf = wide_kernel.keep_mask(state, fok, fcr, alive, window)
        return keep
    (state, fok, fcr, alive), single = _lanes(state, fok, fcr, alive)
    h1, h2 = row_hashes(state, fok, fcr)
    if dedup_backend == "bucket" and bucket_feasible(n):
        keep = _keep_bucket(h1, h2, alive, window)[0]
    else:
        keep = _keep_sort(h1, h2, alive, window)
    return keep[0] if single else keep


def dedup_round_probe(capacity: int, P: int, G: int, W: int = 1,
                      backends=DEDUP_BACKENDS, rounds: int = 5,
                      seed: int = 0, device=None) -> dict:
    """Time the dedup stage per round at a rung's candidate shape
    (``probe_candidates``), one backend at a time: ``{backend: mean
    seconds per round}``.  On the card the rounds run between CUDA
    events after one untimed call; on the CPU they are timed by the host
    clock.  ``device``: the card unless the caller asks for "cpu".

    One ``dedup.round`` span per backend (backend,
    candidates, capacity, rounds, per_round_us) lands in the telemetry
    summary's dedup table.  "fused" is probed where the JAX package
    probes its keep-mask kernel (at least one 128-row tile, and a
    bucket geometry), and its span carries ``interpret``: True when the
    wrapper ran its plain PyTorch version (CPU tensors), so such
    timings never pass for the card's."""
    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch._platform import resolve_device

    dev = resolve_device(device)
    tables = tuple(torch.from_numpy(a).to(dev)
                   for a in probe_candidates(capacity, P, G, W, seed))
    rounds = max(1, int(rounds))
    n = int(tables[0].shape[0])
    out: dict = {}
    for b in backends:
        extra = {}
        if b == "fused":
            from jepsen_tpu_torch.ops import wide_kernel

            if not (n >= wide_kernel.TILE and bucket_feasible(n)):
                continue  # below the JAX package's keep-mask geometry
            extra["interpret"] = dev.type != "cuda"
        _dedup_stage(*tables, 4, b)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(rounds):
                _dedup_stage(*tables, 4, b)
            end.record()
            end.synchronize()
            out[b] = start.elapsed_time(end) / 1e3 / rounds
        else:
            t0 = time.perf_counter()
            for _ in range(rounds):
                _dedup_stage(*tables, 4, b)
            out[b] = (time.perf_counter() - t0) / rounds
        obs.span_event(
            "dedup.round", out[b], backend=b, candidates=n,
            capacity=int(capacity), rounds=rounds,
            per_round_us=round(out[b] * 1e6, 1), **extra,
        )
    return out


def probe_candidates(capacity: int, P: int, G: int, W: int = 1, seed: int = 0):
    """A synthetic candidate table at an engine tick's shape —
    ``capacity * (1 + P + G)`` rows with realistic duplicate density
    (~half the rows copy another row, ~20% dead) — as numpy arrays: the
    same draws as the JAX package's ``probe_candidates``, with fok
    returned as int32 bit patterns (the port's fok dtype)."""
    n = capacity * (1 + P + G)
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 64, n).astype(np.int32)
    fok = rng.integers(0, 1 << 16, (n, W)).astype(np.uint32)
    fcr = rng.integers(0, 4, (n, G)).astype(np.int16)
    src = rng.integers(0, n, n // 2)
    state[: n // 2] = state[src]
    fok[: n // 2] = fok[src]
    fcr[: n // 2] = fcr[src]
    alive = rng.random(n) < 0.8
    return state, fok.view(np.int32), fcr, alive
