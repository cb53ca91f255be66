"""The port's "sort" dedup backend and exact frontier update against the
JAX package's, on the same numpy inputs.

``_keep_sort``, ``frontier_update`` (under "sort", and under "fused",
which rides the bucket partition as the JAX package's "pallas" does),
``exact_prune``, ``dominate``, ``_dedup_stage`` (every backend) and
``frontier_update_fast`` under "sort" must be bit-identical (tolerance
0): every output row, alive or dead, the overflow flags and the
fingerprints.  The tables are ``probe_candidates`` at the suite's shared
shapes, (30, 3)@(64, 256) as (P, G) = (4, 3) at capacities 64 and 256
and (40, 5)@(16, 64, 512) as (5, 4) at 16, 64 and 512, plus one table
of heavy duplicates.  The JAX side runs on its CPU backend; its Pallas
keep mask runs in interpret mode on the small table only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.ops import hashing as hx
from jepsen_tpu_torch.ops import hashing as th

T = torch.from_numpy

#: (capacity, P, G) of the probe tables.
SHAPES = [(64, 4, 3), (256, 4, 3), (16, 5, 4), (64, 5, 4), (512, 5, 4)]

_J_UPDATE = jax.jit(hx.frontier_update,
                    static_argnames=("capacity", "window", "dedup_backend"))
_J_FAST = jax.jit(hx.frontier_update_fast,
                  static_argnames=("capacity", "window", "n_parents",
                                   "max_count", "dedup_backend"))
_J_KEEP_SORT = jax.jit(hx._keep_sort, static_argnames="window")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _heavy(seed: int = 3):
    """A (256, 4, 3) probe table (2,048 rows) in which 1,000 alive rows
    are copies of one row and another 600 copies of three others."""
    st, fo, fc, al = th.probe_candidates(256, 4, 3, 1, seed=seed)
    rng = np.random.default_rng(seed)
    n = st.shape[0]
    pos = rng.choice(n, 1600, replace=False)
    src = np.r_[np.full(1000, 7), np.array([11, 23, 40])[np.arange(600) % 3]]
    st[pos], fo[pos], fc[pos], al[pos] = st[src], fo[src], fc[src], True
    return st, fo, fc, al


@functools.lru_cache(maxsize=None)
def _table(name: str):
    """(state, fok int32 bits, fcr, alive, cost) of a named table; the
    cost is small so that it ties often (the tie order is the test)."""
    if name == "heavy":
        st, fo, fc, al = _heavy()
        capacity = 256
    else:
        capacity, P, G, seed = (int(x) for x in name.split("-"))
        st, fo, fc, al = th.probe_candidates(capacity, P, G, 1, seed=seed)
    cost = np.random.default_rng(len(name)).integers(0, 5, st.shape[0])
    return st, fo, fc, al, cost.astype(np.int32), capacity


NAMES = [f"{c}-{p}-{g}-{s}" for c, p, g in SHAPES for s in (0, 1)] + ["heavy"]


def _jax_args(st, fo, fc, al):
    return (jnp.asarray(st), jnp.asarray(fo.view(np.uint32)), jnp.asarray(fc),
            jnp.asarray(al))


def _same(want, got, what):
    """Every output equal as integers (fok compared as bit patterns)."""
    for k, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32 and g.dtype == np.int32:
            g = g.view(np.uint32)
        assert w.shape == g.shape, (what, k, w.shape, g.shape)
        assert (w.astype(np.int64) == g.astype(np.int64)).all(), (what, k)


@pytest.mark.parametrize("name", NAMES)
def test_keep_sort_matches_jax(name):
    """_keep_sort: the same keep mask on every table, for windows 1, 4
    and 16; lane-batched equals per lane."""
    st, fo, fc, al, _cost, _cap = _table(name)
    h1, h2 = th.row_hashes(T(st), T(fo), T(fc))
    jh = [jnp.asarray(h.numpy().astype(np.uint32)) for h in (h1, h2)]
    for window in (1, 4, 16):
        want = np.asarray(_J_KEEP_SORT(*jh, jnp.asarray(al), window=window))
        got = th._keep_sort(h1[None], h2[None], T(al)[None], window)[0]
        assert (got.numpy() == want).all(), window
    two = th._keep_sort(torch.stack([h1, h1]), torch.stack([h2, h2]),
                        torch.stack([T(al), ~T(al)]), 4)
    assert (two[0].numpy() == np.asarray(
        _J_KEEP_SORT(*jh, jnp.asarray(al), window=4))).all()
    assert (two[1].numpy() == np.asarray(
        _J_KEEP_SORT(*jh, jnp.asarray(~al), window=4))).all()


@pytest.mark.parametrize("backend", ["sort", "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_frontier_update_matches_jax(name, backend):
    """The exact update, every output row and the fingerprint, under
    "sort" (the three stable passes against the 4-key sort) and under
    "fused" against the JAX package's "pallas" (both ride the bucket
    partition)."""
    st, fo, fc, al, cost, capacity = _table(name)
    jb = "pallas" if backend == "fused" else backend
    want = _J_UPDATE(*_jax_args(st, fo, fc, al), jnp.asarray(cost),
                     capacity=capacity, dedup_backend=jb)
    got = th.frontier_update(T(st), T(fo), T(fc), T(al), T(cost), capacity,
                             dedup_backend=backend)
    _same(want, got, (name, backend))


def test_frontier_update_bucket_equals_fused_and_lanes():
    """"bucket" and "fused" take the same partition in the exact update,
    and a lane-batched call equals its lanes one by one."""
    rows = [_table(n) for n in ("64-4-3-0", "64-4-3-1")]
    lanes = [T(np.stack([r[k] for r in rows])) for k in range(5)]
    both = th.frontier_update(*lanes, 64, dedup_backend="bucket")
    fused = th.frontier_update(*lanes, 64, dedup_backend="fused")
    for a, b in zip(both, fused):
        assert torch.equal(a, b)
    for i, r in enumerate(rows):
        one = th.frontier_update(*(T(a) for a in r[:5]), 64,
                                 dedup_backend="sort")
        two = th.frontier_update(*(x[i:i + 1] for x in lanes), 64,
                                 dedup_backend="sort")
        for a, b in zip(one, two):
            assert torch.equal(a, b[0])


@pytest.mark.parametrize("name", NAMES)
def test_exact_prune_and_dominate_match_jax(name):
    """exact_prune and dominate on the table's first 2C rows (the buffer
    the updates prune), with the JAX package's chunking and with a small
    chunk that splits the killed axis, and through the lane-batched
    ``_pairwise_kills``."""
    st, fo, fc, al, _cost, capacity = _table(name)
    b = min(2 * capacity, st.shape[0])
    args = (st[:b] % 8, fo[:b] % 4, fc[:b], al[:b])  # big classes: kills
    jargs = _jax_args(*args)
    targs = tuple(T(np.ascontiguousarray(a)) for a in args)
    lanes = tuple(t[None] for t in targs)
    for ties, fn_j, fn_t in ((True, hx.exact_prune, th.exact_prune),
                             (False, hx.dominate, th.dominate)):
        want = np.asarray(fn_j(*jargs))
        assert (fn_t(*targs).numpy() == want).all(), fn_t.__name__
        assert (fn_t(*targs, chunk_rows=16).numpy() == want).all()
        kills = th._pairwise_kills(*lanes, ties, 16)[0]
        assert ((args[3] & ~kills.numpy()) == want).all()
        assert (want != args[3]).any() or b < 64, "nothing was pruned"


@pytest.mark.parametrize("name", NAMES)
def test_frontier_update_fast_sort_matches_jax(name):
    """frontier_update_fast under "sort": every output row, the
    overflow flag, the fingerprint and the child mask, with the one-hot
    prune (max_count) and with the exact prune (max_count None)."""
    st, fo, fc, al, _cost, capacity = _table(name)
    for mc in (8, None):
        want = _J_FAST(*_jax_args(st, fo, fc, al), None, capacity=capacity,
                       n_parents=capacity, max_count=mc,
                       dedup_backend="sort")
        got = th.frontier_update_fast(T(st), T(fo), T(fc), T(al), None,
                                      capacity, n_parents=capacity,
                                      max_count=mc, dedup_backend="sort")
        _same(want, got, (name, mc))


def test_frontier_update_fast_routes_to_sort(monkeypatch):
    """Where the bucket geometry is infeasible, "bucket" and "fused"
    take the sort path, as the JAX package does; the port raised there
    before.  With max_count None the buffer takes exact_prune."""
    st, fo, fc, al, _cost, capacity = _table("64-4-3-0")
    monkeypatch.setattr(th, "BUCKET_MIN_BITS", 32)
    assert not th.bucket_feasible(st.shape[0])
    want = th.frontier_update_fast(T(st), T(fo), T(fc), T(al), None, capacity,
                                   n_parents=capacity, max_count=None,
                                   dedup_backend="sort")
    jwant = _J_FAST(*_jax_args(st, fo, fc, al), None, capacity=capacity,
                    n_parents=capacity, max_count=None, dedup_backend="sort")
    _same(jwant, want, "sort")
    for backend in ("bucket", "fused"):
        got = th.frontier_update_fast(T(st), T(fo), T(fc), T(al), None,
                                      capacity, n_parents=capacity,
                                      max_count=None, dedup_backend=backend)
        for a, b in zip(want, got):
            assert torch.equal(a, b), backend


@pytest.mark.parametrize("name", ["64-4-3-0", "512-5-4-1", "heavy"])
def test_dedup_stage_matches_jax(name):
    """_dedup_stage under every backend: "sort" and "bucket" against the
    JAX package's, "fused" against its "pallas" (the Pallas keep mask in
    interpret mode on the smallest table, its bucket stage otherwise)."""
    st, fo, fc, al, _cost, _cap = _table(name)
    jargs = _jax_args(st, fo, fc, al)
    n = st.shape[0]
    for backend in th.DEDUP_BACKENDS:
        jb = backend
        if backend == "fused":
            jb = "pallas" if n <= 1024 else "bucket"
        want = np.asarray(hx._dedup_stage(*jargs, 4, jb))
        got = th._dedup_stage(T(st), T(fo), T(fc), T(al), 4, backend)
        assert (got.numpy() == want).all(), backend


def test_np_hash_mirrors_and_probe():
    """The host mirrors equal the JAX package's on int32 and uint32
    columns, and the probe times each backend on the CPU."""
    rng = np.random.default_rng(7)
    st = rng.integers(-5, 100, 64).astype(np.int32)
    fo = rng.integers(0, 2**32, (64, 2), dtype=np.uint64).astype(np.uint32)
    for a, b in zip(th.np_class_hash(st, fo.view(np.int32)),
                    hx.np_class_hash(st, fo)):
        assert a.dtype == np.uint32 and (a == b).all()
    x = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    assert (th.np_mix32(x) == hx.np_mix32(x)).all()
    t = th.dedup_round_probe(16, 4, 3, rounds=1, device="cpu")
    assert set(t) == set(th.DEDUP_BACKENDS) and min(t.values()) > 0
