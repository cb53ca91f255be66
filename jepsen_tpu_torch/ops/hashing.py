"""Row hashing, dedup, domination pruning and compaction of the frontier.

The port of the JAX package's ``ops/hashing.py`` main-path pieces.  The
frontier is a struct-of-arrays table with a leading lane axis (the JAX
package vmaps one lane; here every function takes ``[L, n]`` tables, and
a 1-D table is treated as one lane):

  state [L, n] int32 · fok [L, n, W] int32 (the uint32 fired-open-op
  bitsets, carried as int32 bit patterns) · fcr [L, n, G] int16 (fired
  count per crashed group) · alive [L, n] bool

torch on the CPU has no ``>>`` or ``+`` for uint32, so the 32-bit hash
lanes are carried as int64 tensors masked to ``0xFFFFFFFF``; products
are split into 16-bit halves so no int64 product overflows.  Hashes,
keep masks and fingerprints are bit-identical to the JAX package's.

Two dedup backends (``dedup_backend``):

  * "bucket" — the packed radix bucket partition of ``_keep_bucket``
    (one single-key sort of ``[dead | bucket | index]``, windowed 64-bit
    hash kills), the one-hot matmul domination prune on the 2C buffer
    and cumsum-rank compaction, as plain torch ops.
  * "fused"  — the port's name for the JAX package's "pallas" backend:
    the fused wide-stage update of ``ops.wide_kernel`` (hand-written
    CUDA on the card), routed on wide rungs (``fused_feasible``);
    narrower rungs take the bucket path, as in the JAX package.  It is
    the default, because it is the configuration this port carries.
"""

from __future__ import annotations

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
DEDUP_BACKENDS = ("bucket", "fused")

#: The backend when the caller names none.
DEDUP_BACKEND = "fused"

#: Fewer bucket bits than this and the radix partition degenerates into
#: a handful of giant buckets; such tables are refused (they need more
#: than 2^25 candidate rows).
BUCKET_MIN_BITS = 6

#: One-hot plane count for the matmul prune; counts at or above the last
#: plane compare saturating (sound at any count, exact below M-1).
MXU_PRUNE_MAX_COUNT = 64


def resolve_dedup_backend(backend: str | None = None) -> str:
    """The dedup backend to use: the explicit argument, else the
    module default."""
    b = backend or DEDUP_BACKEND
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
    tick (the JAX package's ``frontier_update_fast``, lane-batched).

      1. hash each row to 64 bits (two uint32 lanes);
      2. bucket dedup (``_keep_bucket``): a row dies when an alive
         earlier copy within ``window`` bucket-mates has both lanes
         equal, so survivors are the first copy in candidate order;
      3. survivors compact in candidate order into a 2·capacity buffer,
         which is domination-pruned (``exact_prune_mxu``);
      4. the antichain compacts to ``capacity`` by cumsum rank.

    ``cost`` is accepted for signature parity and unused: candidate
    order already approximates cheapest-first.  ``max_count`` (the
    static bound on any count, callers pass the mover-table size + 1)
    is required: the prune is the one-hot matmul.  ``n_parents``: the
    first ``n_parents`` candidate rows are the previous frontier, so the
    returned ``child`` marks survivors that came from an expansion.

    ``dedup_backend="fused"`` routes feasible wide geometry
    (``wide_kernel.fused_feasible``) to the fused update, whose alive
    rows, positions, overflow flag, fingerprint and ``child & alive``
    are bit-identical to this path's; its dead rows are zeros where this
    path leaves row-0 copies.

    Returns (state', fok', fcr', alive', overflowed, fp, child): fp is
    [L, 3] int64 (uint32 values), overflowed [L] bool.
    """
    if dedup_backend not in DEDUP_BACKENDS:
        raise ValueError(f"unknown dedup backend {dedup_backend!r}")
    if max_count is None:
        raise ValueError("frontier_update_fast needs max_count (the prune "
                         "is the one-hot matmul)")
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
    if not bucket_feasible(n):
        raise ValueError(f"bucket geometry infeasible at {n} candidate rows")
    dev = state.device
    h1, h2 = row_hashes(state, fok, fcr)
    keep_orig, _bovf = _keep_bucket(h1, h2, alive, window)
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
    balive = exact_prune_mxu(bst, bfo, bfc, balive, max_count)
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


def keep_stage(state, fok, fcr, alive, window: int = 4,
               dedup_backend: str = "fused"):
    """Just the dedup stage of ``frontier_update_fast`` (row hash,
    partition, windowed kills): the keep mask in candidate order, from
    the standalone keep-mask kernel under "fused" or ``_keep_bucket``
    under "bucket" (the JAX package's ``_dedup_stage``)."""
    if dedup_backend not in DEDUP_BACKENDS:
        raise ValueError(f"unknown dedup backend {dedup_backend!r}")
    if dedup_backend == "fused":
        from jepsen_tpu_torch.ops import wide_kernel

        keep, _ovf = wide_kernel.keep_mask(state, fok, fcr, alive, window)
        return keep
    h1, h2 = row_hashes(state, fok, fcr)
    return _keep_bucket(h1, h2, alive, window)[0]


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
