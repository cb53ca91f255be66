"""The keep mask's sort-and-stencil algorithm on heavy buckets.

The CUDA keep mask (``ops/csrc/wide_kernel.cu``, ``wk_keep_mask``) sorts
each lane's alive rows by bucket with a stable LSD radix sort of the
packed keys ``[bucket | index]`` and kills a row when one of its
``window`` sorted predecessors has both hash lanes equal.  There is no
compiler for it here, so ``_model_keep`` replays that algorithm in numpy
with the kernel's own tile size and digit width (read from the source):
a first pass by the bucket's top digit (per-tile digit histograms, a
digit-major scan, stable ranks inside each tile) into bins of whole
buckets, then each bin sorted by the remaining bits and the stencil run
inside the bin, without a bucket run start.  The model is a test of the
algorithm only; no path of the port runs it.

The model, the port's plain version ``keep_mask_ref`` and the port's
``keep_mask`` on CPU tensors are held, at tolerance 0 (bits), to the
JAX package's ``hashing._keep_bucket`` and, for n <= 4,096, to its
Pallas ``keep_mask`` in interpret mode: the keep mask and the overflow
flag, on tables of many copies of one row, copies exactly ``window``
and ``window + 1`` bucket-mates apart, one bucket holding every alive
row, no or a single alive row, ragged row counts, bins sorted in two
digits (22 bucket bits), and the suite's shared probe shapes.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.ops import hashing as hx
from jepsen_tpu.ops import wide_kernel as wk
from jepsen_tpu_torch.ops import hashing as th
from jepsen_tpu_torch.ops import wide_kernel as twk

_CU = (Path(twk.__file__).parent / "csrc" / "wide_kernel.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


#: The kernel's rows per tile, widest sort digit and the bucket bits its
#: bins are sorted by.
TILE_ROWS = _constant("kTileRows")
DIGIT_BITS = _constant("kMaxDigitBits")
BIN_BITS = _constant("kBinBits")

#: Largest table held to the Pallas kernel in interpret mode.
PALLAS_MAX_ROWS = 4096

_JAX_KEEP_BUCKET = jax.jit(hx._keep_bucket, static_argnames="window")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hashes(st, fo, fc):
    """The two row-hash lanes (uint32) of a numpy table, by the JAX
    package's host mirror of the fold."""
    cols = [st] + [fo[:, k] for k in range(fo.shape[1])] + [fc[:, g] for g in range(fc.shape[1])]
    return hx.np_hash_rows(cols, hx.HASH_SEED_1), hx.np_hash_rows(cols, hx.HASH_SEED_2)


def _stable_pass(keys, shift: int, width: int, tile: int):
    """One stable counting-sort pass of packed keys by the digit at
    [shift, shift + width), as the kernel scatters: per-tile digit
    histograms, their digit-major exclusive scan, and ranks inside a
    tile in key order."""
    dig = ((keys >> np.uint32(shift)) & np.uint32((1 << width) - 1)).astype(np.int64)
    ntiles = -(-keys.size // tile)
    t = np.arange(keys.size) // tile
    hist = np.zeros((1 << width, ntiles), np.int64)
    np.add.at(hist, (dig, t), 1)
    flat = hist.reshape(-1)
    offset = (np.cumsum(flat) - flat).reshape(hist.shape)
    order = np.lexsort((np.arange(keys.size), dig, t))
    grp = dig[order] * ntiles + t[order]
    first = np.r_[0, np.flatnonzero(grp[1:] != grp[:-1]) + 1]
    run = np.zeros(keys.size, np.int64)
    run[first] = first
    rank = np.empty(keys.size, np.int64)
    rank[order] = np.arange(keys.size) - np.maximum.accumulate(run)
    out = np.empty_like(keys)
    out[offset[dig, t] + rank] = keys
    return out


def _model_keep(h1, h2, alive, window: int):
    """The kernel's algorithm on one lane (numpy): (keep, overflow)."""
    n = h1.shape[0]
    ibits, bbits = hx._bucket_bits(n)
    idx = np.arange(n, dtype=np.uint32)
    keys = ((h1.astype(np.uint32) >> np.uint32(32 - bbits)) << np.uint32(ibits)) | idx
    keys = keys[alive]  # dead rows never enter the sort
    keep = np.zeros(n, bool)
    if keys.size == 0:
        return keep, False
    # the first pass: by the bucket's top digit, into bins of whole buckets
    tbits = min(DIGIT_BITS, max(1, bbits - BIN_BITS))
    keys = _stable_pass(keys, ibits + bbits - tbits, tbits, TILE_ROWS)
    rbits = bbits - tbits
    rpasses = -(-rbits // DIGIT_BITS)
    rwidth = -(-rbits // rpasses) if rpasses else 0
    top = keys >> np.uint32(ibits + bbits - tbits)
    starts = np.r_[0, np.flatnonzero(top[1:] != top[:-1]) + 1, keys.size]
    overflow = False
    for s, e in zip(starts[:-1], starts[1:]):
        # each bin by the remaining bits (counts over the whole bin), then
        # the stencil inside the bin, without a bucket run start
        b = keys[s:e]
        for shift in range(0, rbits, rwidth or 1):
            b = _stable_pass(b, ibits + shift, min(rwidth, rbits - shift), b.size)
        pos = b & np.uint32((1 << ibits) - 1)
        sh1, sh2, bucket = h1[pos], h2[pos], b >> np.uint32(ibits)
        dup = np.zeros(b.size, bool)
        for k in range(1, window + 1):
            dup[k:] |= (sh1[k:] == sh1[:-k]) & (sh2[k:] == sh2[:-k])
        full = np.arange(b.size) >= window
        if b.size > window:
            full[window:] &= bucket[window:] == bucket[: b.size - window]
        keep[pos] = ~dup
        overflow |= bool((~dup & full).any())
    return keep, overflow


@functools.lru_cache(maxsize=None)
def _bucket_mates(n: int, G: int, need: int = 8):
    """``need`` distinct (state, fok, fcr) rows whose h1 falls in one
    bucket of an n-row table: states searched with fok and fcr zero."""
    _ibits, bbits = hx._bucket_bits(n)
    st = np.arange(1 << 22, dtype=np.int32)
    fo = np.zeros((st.size, 1), np.uint32)
    fc = np.zeros((st.size, G), np.int16)
    bucket = _hashes(st, fo, fc)[0] >> np.uint32(32 - bbits)
    order = np.argsort(bucket, kind="stable")
    b = bucket[order]
    start = np.r_[0, np.flatnonzero(b[1:] != b[:-1]) + 1]
    size = np.diff(np.r_[start, b.size])
    k = int(np.argmax(size >= need))
    assert size[k] >= need
    return st[order[start[k]:start[k] + need]]


def _probe(n: int, G: int, seed: int):
    """Random rows (a quarter copies of others, a fifth dead)."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, 64, n).astype(np.int32)
    fo = rng.integers(0, 1 << 16, (n, 1)).astype(np.uint32)
    fc = rng.integers(0, 4, (n, G)).astype(np.int16)
    src = rng.integers(0, n, n // 4)
    st[: n // 4], fo[: n // 4], fc[: n // 4] = st[src], fo[src], fc[src]
    return st, fo, fc, rng.random(n) < 0.8


def _case(name: str):
    """(state, fok uint32, fcr, alive, window) of one named table."""
    G, window = 3, 4
    if name == "copies-1000":
        st, fo, fc, al = _probe(4096, G, 1)
        pos = np.random.default_rng(2).choice(4096, 1000, replace=False)
        st[pos], fo[pos], fc[pos], al[pos] = st[5], fo[5], fc[5], True
    elif name in ("mates-window", "mates-window+1"):
        # A, then window-1 (or window) distinct bucket-mates, then A again:
        # the copies' bucket ranks differ by window (killed) or window+1
        # (kept: bloat past the window, and an overflow)
        n = 2048
        st, fo, fc, al = _probe(n, G, 3)
        mates = _bucket_mates(n, G)
        gap = window - 1 if name == "mates-window" else window
        pos = 100 + 3 * np.arange(gap + 2)
        st[pos] = np.r_[mates[0], mates[1:gap + 1], mates[0]]
        fo[pos], fc[pos], al[pos] = 0, 0, True
    elif name == "one-bucket":
        n = 4096
        st, fo, fc, al = _probe(n, G, 4)
        mates = _bucket_mates(n, G)
        pick = np.random.default_rng(5).integers(0, mates.size, n)
        st[:], fo[:], fc[:] = mates[pick], 0, 0
    elif name == "all-dead":
        st, fo, fc, al = _probe(1024, G, 6)
        al[:] = False
    elif name == "one-alive":
        st, fo, fc, al = _probe(1024, G, 7)
        al[:] = False
        al[700] = True
    elif name == "ragged":
        st, fo, fc, al = _probe(TILE_ROWS * 3 + 77, G, 8)
    elif name == "bbits22":
        st, fo, fc, al = _probe(512, G, 9)
        assert hx._bucket_bits(512)[1] == 22
    elif name.startswith("probe-"):  # the suite's (64, 256) probe shapes
        st, fo, fc, al = th.probe_candidates(int(name[6:]), 4, 3, 1, seed=11)
        fo = fo.view(np.uint32)
    elif name == "large-copies":
        st, fo, fc, al = _probe(20000, G, 12)
        pos = np.random.default_rng(13).choice(20000, 5000, replace=False)
        src = np.array([3, 17, 400])[np.arange(5000) % 3]
        st[pos], fo[pos], fc[pos], al[pos] = st[src], fo[src], fc[src], True
    else:
        raise KeyError(name)
    return st, fo, fc, al, window


CASES = ["copies-1000", "mates-window", "mates-window+1", "one-bucket",
         "all-dead", "one-alive", "ragged", "bbits22", "probe-64",
         "probe-256", "large-copies"]


@pytest.mark.parametrize("name", CASES)
def test_keep_sort_model_and_port_match_jax(name):
    """The algorithm's model, keep_mask_ref and keep_mask (CPU tensors)
    against _keep_bucket and, up to PALLAS_MAX_ROWS rows, the Pallas
    keep mask in interpret mode: keep masks and overflow flags equal."""
    st, fo, fc, al, window = _case(name)
    n = st.shape[0]
    h1, h2 = _hashes(st, fo, fc)
    jk, jo = _JAX_KEEP_BUCKET(jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(al),
                              window=window)
    jk, jo = np.asarray(jk), bool(jo)
    mk, mo = _model_keep(h1, h2, al, window)
    assert (mk == jk).all() and mo == jo, "model"
    tables = tuple(torch.from_numpy(a) for a in (st, fo.view(np.int32), fc, al))
    rk, ro = twk.keep_mask_ref(*(t[None] for t in tables), window)
    assert (rk[0].numpy() == jk).all() and bool(ro[0]) == jo, "keep_mask_ref"
    pk, po = twk.keep_mask(*tables, window)
    assert (pk.numpy() == jk).all() and bool(po) == jo, "keep_mask"
    if n <= PALLAS_MAX_ROWS and wk.keep_feasible(n):
        xk, xo = wk.keep_mask(*(jnp.asarray(a) for a in (st, fo, fc, al)),
                              window, interpret=True)
        assert (np.asarray(xk) == jk).all() and bool(xo) == jo, "pallas"


def test_keep_sort_heavy_cases_are_heavy():
    """The named tables hold what their names say: a bucket of 1,000
    alive copies, the mates' copies kept or killed by the window, one
    bucket for every alive row, bins sorted in two digits at 512 rows."""
    st, fo, fc, al, window = _case("copies-1000")
    h1, h2 = _hashes(st, fo, fc)
    assert (h1[al] == h1[5]).sum() >= 1000
    for name, kept in (("mates-window", False), ("mates-window+1", True)):
        st, fo, fc, al, window = _case(name)
        h1, h2 = _hashes(st, fo, fc)
        gap = window - 1 if name == "mates-window" else window
        last = 100 + 3 * (gap + 1)
        keep, _ovf = _model_keep(h1, h2, al, window)
        assert keep[100] and keep[last] == kept, name
    st, fo, fc, al, window = _case("one-bucket")
    h1, _h2 = _hashes(st, fo, fc)
    _ibits, bbits = hx._bucket_bits(st.shape[0])
    assert np.unique(h1[al] >> np.uint32(32 - bbits)).size == 1
    ibits, bbits = hx._bucket_bits(512)
    rbits = bbits - min(DIGIT_BITS, max(1, bbits - BIN_BITS))
    assert -(-rbits // DIGIT_BITS) == 2
