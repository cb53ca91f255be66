"""The plain versions of the port's two CUDA kernels against the JAX
package's Pallas kernels (interpret mode) and its bucket path.

``keep_mask_ref`` and ``fused_frontier_update_ref`` are what the CUDA
kernels are held to on the card; here they are held to the JAX package
on the same numpy inputs.  All comparisons are exact (integers and bits,
tolerance 0): the keep mask and overflow flag; for the fused update the
alive mask, the alive rows' content and positions, the overflow flag,
the fingerprint and ``child & alive`` (dead rows are zeros in the fused
update and row-0 copies in the bucket path, so only alive rows are
compared with the bucket path, as the JAX suite does).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.ops import hashing as hx
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.ops import wide_kernel as wk
from jepsen_tpu_torch.ops import hashing as th
from jepsen_tpu_torch.ops import wide_kernel as twk

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on one host: one torch
    thread each keeps them from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: the suite-shared probe shape: capacity 64, P=4, G=3
CAP, P_, G_ = 64, 4, 3


@pytest.fixture(autouse=True)
def _wide_floor(monkeypatch):
    """Route the shared (64) shapes to the Pallas kernel as the JAX
    suite does; the runner caches do not key on the floor, so they are
    evicted at teardown."""
    monkeypatch.setenv(wk.PALLAS_MIN_CAPACITY_ENV, "64")
    yield
    jwgl.evict_runner_caches()


_JAX_BUCKET = jax.jit(functools.partial(
    hx.frontier_update_fast, capacity=CAP, n_parents=CAP, max_count=P_ + 1,
    dedup_backend="bucket"))
_JAX_KEEP = functools.partial(hx._dedup_stage_jit, window=4,
                              dedup_backend="pallas")


def _probe_lanes(seeds, capacity=CAP, P=P_, G=G_):
    """Port-side [L, n] tables from the probe rows of several seeds, and
    the same rows as numpy (fok uint32) for the JAX side."""
    rows = [th.probe_candidates(capacity, P, G, 1, seed=s) for s in seeds]
    np_rows = [(st, fo.view(np.uint32), fc, al) for st, fo, fc, al in rows]
    tables = tuple(T(np.stack([r[k] for r in rows])) for k in range(4))
    return tables, np_rows


def _jax_args(r):
    return tuple(jnp.asarray(a) for a in r)


def _assert_same(port_out, l, jax_out, tag, alive_only=False):
    """Port lane ``l`` of a (state, fok, fcr, alive, ovf, fp, child)
    tuple against a JAX single-lane tuple."""
    pa = port_out[3][l].numpy()
    ja = np.asarray(jax_out[3])
    assert (pa == ja).all(), (tag, "alive mask")
    for k in range(3):
        p = port_out[k][l].numpy()
        if k == 1:
            p = p.view(np.uint32)
        j = np.asarray(jax_out[k])
        if alive_only:
            p, j = p[pa], j[ja]
        assert (p.astype(np.int64) == j.astype(np.int64)).all(), (tag, "column", k)
    assert bool(port_out[4][l]) == bool(jax_out[4]), (tag, "overflow")
    assert (port_out[5][l].numpy() == np.asarray(jax_out[5]).astype(np.int64)).all(), (tag, "fp")
    assert ((port_out[6][l].numpy() & pa) == (np.asarray(jax_out[6]) & ja)).all(), (tag, "child")


def test_keep_mask_ref_matches_pallas_and_bucket_20_seeds():
    """keep_mask_ref (20 seeds as 20 lanes of one call) is bit-identical
    to the Pallas keep-mask kernel in interpret mode and to
    _keep_bucket, mask and overflow flag (exact)."""
    seeds = range(20)
    tables, rows = _probe_lanes(seeds)
    keep, ovf = twk.keep_mask_ref(*tables)
    h1, h2 = th.row_hashes(*tables[:3])
    kb, ob = th._keep_bucket(h1, h2, tables[3], 4)
    assert (keep == kb).all() and (ovf == ob).all()
    for l, r in enumerate(rows):
        assert (keep[l].numpy() == np.asarray(_JAX_KEEP(*_jax_args(r)))).all(), l
        jk, jo = wk.keep_mask(*_jax_args(r), 4, interpret=True) if l < 2 else (None, None)
        if jk is not None:
            assert (keep[l].numpy() == np.asarray(jk)).all()
            assert bool(ovf[l]) == bool(jo)
    # the wrapper takes the plain version for CPU tensors, lane or not
    k1, o1 = twk.keep_mask(*(t[3] for t in tables))
    assert (k1 == keep[3]).all() and bool(o1) == bool(ovf[3])


def test_keep_mask_kills_only_true_duplicates():
    """Every killed row has an identical earlier surviving copy, and
    every survivor is the first copy of its content (exact)."""
    tables, _rows = _probe_lanes([7], capacity=32, P=4, G=2)
    keep = twk.keep_mask_ref(*tables)[0][0].numpy()
    st, fo, fc, al = (t[0].numpy() for t in tables)
    rows = [(int(st[i]), tuple(fo[i]), tuple(fc[i])) for i in range(len(st))]
    first = {}
    for i in range(len(rows)):
        if al[i]:
            first.setdefault(rows[i], i)
    for i in np.flatnonzero(al & ~keep):
        j = first[rows[i]]
        assert j < i and keep[j]
    for i in np.flatnonzero(keep):
        assert first[rows[i]] == i


def test_fused_ref_matches_pallas_and_bucket_20_seeds():
    """fused_frontier_update_ref over 20 seeds (20 lanes of one call):
    bit-identical to the Pallas fused kernel in interpret mode (every
    row, dead rows included) and, on alive rows, to the JAX bucket
    update; the CPU wrapper returns the same (exact)."""
    tables, rows = _probe_lanes(range(20))
    got = twk.fused_frontier_update_ref(*tables, CAP, 4, CAP, P_ + 1)
    via = twk.fused_frontier_update(*tables, None, CAP, n_parents=CAP,
                                    max_count=P_ + 1)
    for a, b in zip(got, via):
        assert (a == b).all()
    for l, r in enumerate(rows):
        args = _jax_args(r)
        cost = jnp.zeros(r[0].shape[0], jnp.int32)
        pal = wk.fused_update_jit(*args, cost, CAP, n_parents=CAP,
                                  max_count=P_ + 1, interpret=True)
        _assert_same(got, l, pal, ("pallas", l))
        _assert_same(got, l, _JAX_BUCKET(*args, cost), ("bucket", l),
                     alive_only=True)


def _edge_tables():
    """The JAX suite's edge cases (tests/test_wide_kernel.py): duplicate
    runs far past the window with spill pressure, full-range values
    through the byte planes, saturated counts, and all-dead / all-alive
    masks.  Yields (tag, numpy rows, capacity, max_count)."""
    rng = np.random.default_rng(7)
    for trial in range(3):
        n = 1024
        st = rng.integers(0, 8, n).astype(np.int32)
        fo = rng.integers(0, 4, (n, 1)).astype(np.uint32)
        fc = rng.integers(0, 3, (n, 2)).astype(np.int16)
        src = rng.integers(0, n, (3 * n) // 4)
        st[: len(src)] = st[src]
        fo[: len(src)] = fo[src]
        fc[: len(src)] = fc[src]
        al = rng.random(n) < 0.9
        yield f"dup-heavy{trial}", (st, fo, fc, al), 64, 4
    rng = np.random.default_rng(3)
    n = 512
    st = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    fo = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    fc = rng.integers(0, 32767, (n, 3)).astype(np.int16)
    st[:200] = st[200:400]
    fo[:200] = fo[200:400]
    fc[:200] = fc[200:400]
    al = rng.random(n) < 0.8
    yield "extreme", (st, fo, fc, al), 64, 64
    fc2 = rng.integers(0, 200, (n, 3)).astype(np.int16)
    yield "saturate", (st, fo, fc2, al), 64, 4
    st, fo, fc, al = hx.probe_candidates(CAP, P_, G_, 1, seed=11)
    yield "all-dead", (st, fo, fc, np.zeros_like(al)), CAP, P_ + 1
    yield "all-alive", (st, fo, fc, np.ones_like(al)), CAP, P_ + 1
    # few distinct rows: nothing overflows, the whole antichain survives
    rng = np.random.default_rng(9)
    n = 512
    yield "roomy", (rng.integers(0, 4, n).astype(np.int32),
                    rng.integers(0, 2, (n, 1)).astype(np.uint32),
                    rng.integers(0, 3, (n, 2)).astype(np.int16),
                    rng.random(n) < 0.7), 64, 4
    # big (state, fok) classes, whose rows dominate each other often: the
    # class-partitioned prune's long lists.  Counts are a level plus
    # sparse +1 noise, up to m - 1 and past it; then saturating far past m
    yield "class-heavy", _class_heavy(1), 64, 4
    yield "class-heavy-saturate", _class_heavy(5), 64, 4


def _class_heavy(scale, neg=0.0):
    """1024 rows, 70 % of them in 6 (state, fok) classes; counts a level
    in [0, 4] plus sparse +1 noise, times ``scale``; a share ``neg`` of
    the counts set to -1."""
    rng = np.random.default_rng(21)
    n, m = 1024, 4
    big = rng.random(n) < 0.7
    st = np.where(big, rng.integers(0, 2, n), rng.integers(0, 64, n))
    fo = np.where(big, rng.integers(0, 3, n), rng.integers(0, 1 << 16, n))
    lvl = rng.integers(0, m + 1, (n, 1))
    fc = (lvl + (rng.random((n, 8)) < 0.15)) * scale
    fc[rng.random((n, 8)) < neg] = -1
    return (st.astype(np.int32), fo.astype(np.uint32)[:, None],
            fc.astype(np.int16), rng.random(n) < 0.9)


@pytest.mark.parametrize("case", [c[0] for c in _edge_tables()])
def test_fused_ref_edge_cases(case):
    """Edge cases: the plain fused update and keep mask against the
    Pallas kernels (interpret mode) and the JAX bucket path (exact)."""
    tag, r, capacity, mc = next(c for c in _edge_tables() if c[0] == case)
    tables = (T(r[0])[None], T(r[1].view(np.int32))[None], T(r[2])[None],
              T(r[3])[None])
    args = _jax_args(r)
    cost = jnp.zeros(r[0].shape[0], jnp.int32)
    got = twk.fused_frontier_update_ref(*tables, capacity, 4, 64, mc)
    pal = wk.fused_update_jit(*args, cost, capacity, n_parents=64,
                              max_count=mc, interpret=True)
    _assert_same(got, 0, pal, tag)
    ref = hx.frontier_update_fast(*args, cost, capacity, n_parents=64,
                                  max_count=mc, dedup_backend="bucket")
    _assert_same(got, 0, ref, tag, alive_only=True)
    keep, ovf = twk.keep_mask_ref(*tables)
    jk, jo = wk.keep_mask(*args, 4, interpret=True)
    assert (keep[0].numpy() == np.asarray(jk)).all() and bool(ovf[0]) == bool(jo)
    if tag == "all-dead":
        assert not got[3].any() and not bool(got[4])
        assert (got[5] == 0).all()
    if tag == "roomy":
        assert not bool(got[4]) and got[3].sum() > 0


def test_fused_ref_negative_counts_follow_bucket_path():
    """Negative counts (never packed by the engines): a row with one
    cannot be killed, since its saturated count has no one-hot plane.
    The plain fused update holds that contract with the JAX bucket path
    (``exact_prune_mxu``) on alive rows, and the keep mask with the
    Pallas keep kernel (exact).  The JAX Pallas fused kernel is not held
    here: its byte planes read a negative count back as count + 65536
    (ROADMAP queue C)."""
    r = _class_heavy(1, neg=0.02)
    assert (r[2] < 0).any()
    tables = (T(r[0])[None], T(r[1].view(np.int32))[None], T(r[2])[None],
              T(r[3])[None])
    args = _jax_args(r)
    cost = jnp.zeros(r[0].shape[0], jnp.int32)
    got = twk.fused_frontier_update_ref(*tables, 64, 4, 64, 4)
    ref = hx.frontier_update_fast(*args, cost, 64, n_parents=64,
                                  max_count=4, dedup_backend="bucket")
    _assert_same(got, 0, ref, "negative", alive_only=True)
    assert (got[2][0][got[3][0]] < 0).any()  # rows with a -1 survive
    keep, ovf = twk.keep_mask_ref(*tables)
    jk, jo = wk.keep_mask(*args, 4, interpret=True)
    assert (keep[0].numpy() == np.asarray(jk)).all() and bool(ovf[0]) == bool(jo)


def test_fused_routing_gates(monkeypatch):
    """The Hopper gate: bucket geometry, the plane bound, a full 2C
    buffer, and the wide floor (env override) — no VMEM term: the bench
    wide rung (G=32, 83,968 rows) routes here where the JAX 3 MiB
    budget refuses it."""
    monkeypatch.delenv(twk.FUSED_MIN_CAPACITY_ENV, raising=False)
    assert twk.wide_min_capacity() == 1024
    n32 = 2048 * (1 + 8 + 32)
    assert twk.fused_feasible(n32, 2048, 9)
    assert not wk.fused_feasible(n32, 2048, 9, w=1, g=32)
    assert not twk.fused_feasible(n32, 2048, None)
    assert not twk.fused_feasible(2048 * 13, 512, 9)  # narrow rung
    assert not twk.fused_feasible(3000, 2048, 9)      # n < 2C
    monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "64")
    assert twk.fused_feasible(512, 64, 5)
    monkeypatch.setattr(th, "BUCKET_MIN_BITS", 40)
    assert not twk.fused_feasible(512, 64, 5)


def test_frontier_update_fast_fused_route_matches_bucket(monkeypatch):
    """frontier_update_fast under "fused" routes to the fused update
    when feasible and to the bucket path below the floor; both agree on
    alive rows, overflow, fingerprint and child & alive (exact)."""
    tables, _rows = _probe_lanes(range(3))
    bucket = th.frontier_update_fast(*tables, None, CAP, n_parents=CAP,
                                     max_count=P_ + 1, dedup_backend="bucket")
    monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "4096")  # nothing wide
    below = th.frontier_update_fast(*tables, None, CAP, n_parents=CAP,
                                    max_count=P_ + 1, dedup_backend="fused")
    for a, b in zip(bucket, below):
        assert (a == b).all()
    monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "64")
    fused = th.frontier_update_fast(*tables, None, CAP, n_parents=CAP,
                                    max_count=P_ + 1, dedup_backend="fused")
    ref = twk.fused_frontier_update_ref(*tables, CAP, 4, CAP, P_ + 1)
    for a, b in zip(fused, ref):
        assert (a == b).all()
    al = bucket[3]
    assert (fused[3] == al).all()
    for k in range(3):
        assert (fused[k][al] == bucket[k][al]).all()
    assert (fused[4] == bucket[4]).all() and (fused[5] == bucket[5]).all()
    assert ((fused[6] & al) == (bucket[6] & al)).all()


@pytest.mark.parametrize("dedup", ["fused", "bucket"])
def test_keep_stage_matches_jax_dedup_stage(dedup):
    """_dedup_stage, the dedup stage alone, equals the JAX package's
    _dedup_stage under the matching backend ("fused" <-> "pallas"),
    lane by lane (exact)."""
    tables, rows = _probe_lanes(range(4))
    got = th._dedup_stage(*tables, 4, dedup)
    jb = "pallas" if dedup == "fused" else "bucket"
    for l, r in enumerate(rows):
        want = hx._dedup_stage_jit(*_jax_args(r), window=4, dedup_backend=jb)
        assert (got[l].numpy() == np.asarray(want)).all(), l
