"""The port's hashing, bucket dedup, bucket frontier update and tensor
model steps against the JAX package, on the same numpy inputs.

Every comparison is exact: integers and bits (tolerance 0).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.history import NIL
from jepsen_tpu.models import tensor as jtensor
from jepsen_tpu.ops import hashing as hx
from jepsen_tpu_torch.models import tensor as ttensor
from jepsen_tpu_torch.ops import hashing as th

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on one host: one torch
    thread each keeps them from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_mix32_bit_identical_over_full_uint32_range():
    """mix32 is exact against jnp mix32 and np_mix32 over random uint32
    values, half of them >= 2^31, plus the edge values (exact)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:6] = [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    assert (x >= 2**31).sum() > 1000
    got = th.mix32(T(x.astype(np.int64))).numpy()
    assert (got == _u32(hx.np_mix32(x))).all()
    assert (got == _u32(hx.mix32(jnp.asarray(x)))).all()


@pytest.mark.parametrize("seed", range(4))
def test_hash_rows_bit_identical(seed):
    """hash_rows over int32 (negative too), uint32 (>= 2^31 too) and
    int16 columns equals the JAX fold for both seeds (exact)."""
    rng = np.random.default_rng(seed)
    n = 777
    cols = [
        rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 32767, n).astype(np.int16),
    ]
    tcols = [T(cols[0]), T(cols[1].view(np.int32)), T(cols[2])]
    for s in (hx.HASH_SEED_1, hx.HASH_SEED_2, hx.FP_SEED_1, hx.FP_SEED_2):
        want = _u32(hx.hash_rows([jnp.asarray(c) for c in cols], s))
        assert (th.hash_rows(tcols, s).numpy() == want).all()
        assert (want == _u32(hx.np_hash_rows(cols, s))).all()


@pytest.mark.parametrize("seed", range(6))
def test_keep_bucket_matches_jax(seed):
    """_keep_bucket: the same keep mask and overflow flag as the JAX
    package's on the probe tables; lane-batched equals per-lane (exact)."""
    lanes = []
    for s in (seed, seed + 100):
        st, fo, fc, al = hx.probe_candidates(64, 4, 3, 1, seed=s)
        cols = [st, fo[:, 0]] + [fc[:, k] for k in range(3)]
        h1 = hx.hash_rows([jnp.asarray(c) for c in cols], hx.HASH_SEED_1)
        h2 = hx.hash_rows([jnp.asarray(c) for c in cols], hx.HASH_SEED_2)
        keep, ovf = hx._keep_bucket(h1, h2, jnp.asarray(al), 4)
        lanes.append((_u32(h1), _u32(h2), al, np.asarray(keep), bool(ovf)))
    h1 = T(np.stack([x[0] for x in lanes]))
    h2 = T(np.stack([x[1] for x in lanes]))
    al = T(np.stack([x[2] for x in lanes]))
    keep, ovf = th._keep_bucket(h1, h2, al, 4)
    for l, (_a, _b, _c, k, o) in enumerate(lanes):
        assert (keep[l].numpy() == k).all()
        assert bool(ovf[l]) == o


def _jax_bucket_update(st, fo, fc, al, capacity, max_count):
    return hx.frontier_update_fast(
        jnp.asarray(st), jnp.asarray(fo), jnp.asarray(fc), jnp.asarray(al),
        jnp.zeros(st.shape[0], jnp.int32), capacity, n_parents=capacity,
        max_count=max_count, dedup_backend="bucket")


@pytest.mark.parametrize("seed", range(4))
def test_bucket_frontier_update_matches_jax_bit_for_bit(seed):
    """The bucket path reproduces the JAX bucket path entirely — alive
    and dead rows, overflow, fingerprint, child — at the shared probe
    shape and at a roomier capacity that does not overflow (exact)."""
    for capacity, P, G in ((64, 4, 3), (256, 2, 2)):
        st, fo, fc, al = th.probe_candidates(capacity, P, G, 1, seed=seed)
        if capacity == 256:
            st, fo, fc = st % 4, fo % 2, fc % 2  # few distinct rows: no overflow
        ref = _jax_bucket_update(st, fo.view(np.uint32), fc, al, capacity, 8)
        got = th.frontier_update_fast(T(st), T(fo), T(fc), T(al), None,
                                      capacity, n_parents=capacity,
                                      max_count=8, dedup_backend="bucket")
        for k, (r, g) in enumerate(zip(ref, got)):
            g = g.numpy()
            if k == 1:
                g = g.view(np.uint32)
            assert (np.asarray(r).astype(np.int64) == g.astype(np.int64)).all(), k
        if capacity == 256:
            assert not bool(got[4])


def test_exact_prune_mxu_matches_jax_with_saturation():
    """The one-hot prune, including saturated counts (>= m-1), equals
    the JAX prune (exact)."""
    rng = np.random.default_rng(5)
    n = 96
    st = rng.integers(0, 3, n).astype(np.int32)
    fo = rng.integers(0, 2, (n, 1)).astype(np.uint32)
    fc = rng.integers(0, 7, (n, 3)).astype(np.int16)
    al = rng.random(n) < 0.9
    for mc in (3, 9):
        want = np.asarray(hx.exact_prune_mxu(
            jnp.asarray(st), jnp.asarray(fo), jnp.asarray(fc),
            jnp.asarray(al), mc))
        got = th.exact_prune_mxu(T(st)[None], T(fo.view(np.int32))[None],
                                 T(fc)[None], T(al)[None], mc)[0]
        assert (got.numpy() == want).all()


def _grid(name):
    """Every (state, f, v1, v2) combination over a small grid with NIL,
    negatives and the fifo's packed states."""
    f_codes = sorted(jtensor.REGISTRY[name].f_codes.values()) + [3]
    vals = [int(NIL), -1, 0, 1, 2, 5, 6, 7]
    if name == "fifo-queue":
        states = [0, 1, 2, 7, 9, 10, 17, 25, (2 << 6) | (1 << 3) | 2,
                  (7 << 18) | 7, 0x7FFFFFFF & ~7]
    else:
        states = vals
    rows = np.array(list(itertools.product(states, f_codes, vals, vals)),
                    dtype=np.int64)
    return [rows[:, k].astype(np.int32) for k in range(4)]


@pytest.mark.parametrize("name", sorted(jtensor.REGISTRY))
def test_tensor_model_steps_exhaustive(name):
    """Every TensorModel step: (state', legal) identical to the JAX step
    over the whole grid (exact)."""
    assert set(ttensor.REGISTRY) == set(jtensor.REGISTRY)
    assert ttensor.REGISTRY[name].f_codes == jtensor.REGISTRY[name].f_codes
    cols = _grid(name)
    js, jl = jtensor.REGISTRY[name].step(*[jnp.asarray(c) for c in cols])
    ts, tl = ttensor.REGISTRY[name].step(*[T(c) for c in cols])
    assert ts.dtype == torch.int32
    assert (ts.numpy() == np.asarray(js)).all()
    assert (tl.numpy() == np.asarray(jl)).all()


def test_resolve_dedup_backend():
    assert th.resolve_dedup_backend() == "fused"
    assert th.resolve_dedup_backend("bucket") == "bucket"
    with pytest.raises(ValueError):
        th.resolve_dedup_backend("pallas")
