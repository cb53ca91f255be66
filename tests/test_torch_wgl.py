"""The port's packing, candidate expansion and engines against the JAX
package's, on the same histories.

Packed tables must be identical; the greedy walk and the async engine
(backends "bucket" and "fused", the JAX side under "pallas" with the
wide floor lowered to 64 so the fused kernel runs on these shapes) must
give lane-by-lane identical (valid, failed_at, lossy, peak) and resume
snapshots — the snapshot's barrier and its alive rows, content and
positions.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.ops import wide_kernel as wk
from jepsen_tpu.parallel import batch as jbatch
from jepsen_tpu_torch import convert
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wide_kernel as twk
from jepsen_tpu_torch.parallel import batch as tbatch
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on one host: one torch
    thread each keeps them from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def wide_floor(monkeypatch):
    """Both packages route the 64-row rungs to their fused update; the
    JAX runner caches do not key on the floor, so they are evicted."""
    monkeypatch.setenv(wk.PALLAS_MIN_CAPACITY_ENV, "64")
    monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "64")
    yield
    jwgl.evict_runner_caches()


def _histories():
    """Valid, corrupted and info-heavy CAS histories: lanes that resolve,
    refute, and overflow a 64-row frontier."""
    hs = []
    for i in range(8):
        hh = valid_register_history(40, 5, seed=i, info_rate=0.35)
        if i % 3 == 1:
            hh = corrupt(hh, seed=i)
        hs.append(hh)
    return hs


def _pair_packs(hists):
    jp = [jwgl.pack(jm.CASRegister(None), hh) for hh in hists]
    tp = [twgl.pack(tm.CASRegister(None), hh) for hh in hists]
    return jp, tp


def _same_tables(a: dict, b: dict):
    for k in ("B", "P", "G", "W", "init_state", "bar_active", "bar_quiet",
              "bar_opid", "grp_open", "slot_lane"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    for k in ("bar", "mov", "grp"):
        for x, y in zip(a[k], b[k]):
            assert np.array_equal(x, y), k
    assert np.array_equal(np.asarray(a["slot_onehot"]).view(np.int32),
                          np.asarray(b["slot_onehot"]))


def test_pack_and_pad_tables_identical():
    """pack and pad_packed: every table identical to the JAX package's;
    from_jax_packed turns the JAX pack into the port's (step mapped by
    name) (exact)."""
    jp, tp = _pair_packs(_histories())
    for a, b in zip(jp, tp):
        _same_tables(a, b)
        assert b["step"] is tm.tensor.REGISTRY["cas-register"].step
        _same_tables(jwgl.pad_packed(a), twgl.pad_packed(b))
        _same_tables(jwgl.pad_packed(a, B=256, P=16, G=32),
                     twgl.pad_packed(b, B=256, P=16, G=32))
        c = convert.from_jax_packed(a)
        _same_tables(a, c)
        assert c["step"] is b["step"]
    assert jbatch.bucket_geometry(100, 8, 17) == tbatch.bucket_geometry(100, 8, 17)
    assert jbatch.padded_batch(5) == tbatch.padded_batch(5) == 8


def _stacked(jp, tp):
    B, P, G = jbatch.bucket_geometry(max(p["B"] for p in jp),
                                     max(p["P"] for p in jp),
                                     max(p["G"] for p in jp))
    js = jbatch._stack(jp, B, P, G)
    ts = tbatch._stack(tp, B, P, G)
    for k in twgl.TABLE_ORDER + ("init_state",):
        assert np.array_equal(js[k], ts[k]), k
    return B, P, G, (P + 31) // 32, js, ts


def test_expand_candidates_matches_jax():
    """One round's candidate table from a random frontier: state, fok,
    fcr and alive identical to the JAX expansion, lane by lane (exact)."""
    jp, tp = _pair_packs(_histories()[:4])
    B, P, G, W, js, ts = _stacked(jp, tp)
    rng = np.random.default_rng(1)
    F, L = 16, len(jp)
    st = rng.integers(0, 5, (L, F)).astype(np.int32)
    fo = rng.integers(0, 1 << P, (L, F, W)).astype(np.uint32)
    fc = rng.integers(0, 2, (L, F, G)).astype(np.int16)
    al = rng.random((L, F)) < 0.7
    b = rng.integers(0, 20, L)
    padded = jwgl.pad_packed(jp[0], B=B, P=P, G=G)
    slot_lane, onehot = padded["slot_lane"], padded["slot_onehot"]
    tl = torch.from_numpy(slot_lane).long()
    toh = T(onehot.view(np.int32))
    ar = np.arange(L)
    step = tp[0]["step"]
    got = twgl.expand_candidates(
        step, torch.eye(G, dtype=torch.int16), tl, toh.sum(1, dtype=torch.int32),
        toh, T(st), T(fo.view(np.int32)), T(fc), T(al),
        *(T(ts[k][ar, b]) for k in ("mov_f", "mov_v1", "mov_v2", "mov_open")),
        *(T(ts[k]) for k in ("grp_f", "grp_v1", "grp_v2")),
        T(ts["grp_open"][ar, b]))
    for l in range(L):
        want = jwgl.expand_candidates(
            jp[0]["step"], jnp.eye(G, dtype=jnp.int16), slot_lane,
            onehot.sum(axis=1), onehot, st[l], fo[l], fc[l], al[l],
            *(js[k][l, b[l]] for k in ("mov_f", "mov_v1", "mov_v2", "mov_open")),
            *(js[k][l] for k in ("grp_f", "grp_v1", "grp_v2")),
            js["grp_open"][l, b[l]])
        assert (got[0][l].numpy() == np.asarray(want[0])).all()
        assert (got[1][l].numpy().view(np.uint32) == np.asarray(want[1])).all()
        assert (got[2][l].numpy() == np.asarray(want[2])).all()
        assert (got[3][l].numpy() == np.asarray(want[3])).all()


def test_greedy_walk_lane_identical():
    """The batched greedy walk: (finished, stuck_at, fired) identical to
    the JAX greedy runner, lane by lane (exact)."""
    jp, tp = _pair_packs(_histories())
    B, P, G, W, js, ts = _stacked(jp, tp)
    n_act = np.array([p["bar_active"].sum() for p in jp], np.int32)
    runner = jwgl.greedy_runner(jp[0]["step"], B, P, G, W)
    slot_lane, onehot = twgl._slot_tables(P, W)
    want = runner(js["init_state"], jnp.asarray(n_act),
                  *(js[k] for k in jbatch.ASYNC_ARG_ORDER[1:]))
    got = twgl.greedy_run(tp[0]["step"], B, T(ts["init_state"]), T(n_act),
                          {k: T(ts[k]) for k in twgl.TABLE_ORDER},
                          T(slot_lane).long(), T(onehot))
    for w, g in zip(want, got):
        assert (np.asarray(w) == g.numpy()).all()
    assert 0 < int(got[0].sum()) < len(jp)  # some lanes walk, some stick


def _run_jax_async(jp, js, B, P, G, W, F, T_, fresh=None):
    n = len(jp)
    n_act = np.array([p["bar_active"].sum() for p in jp], np.int32)
    if fresh is None:
        fresh = jwgl.fresh_frontier(n, F, W, G, js["init_state"])
    runner = jwgl.async_runner(jp[0]["step"], F, T_, B, P, G, W, "pallas")
    return runner(*(jnp.asarray(a) for a in fresh), jnp.asarray(n_act),
                  *(js[k] for k in jbatch.ASYNC_ARG_ORDER[1:]))


def _run_port_async(tp, ts, B, P, G, W, F, T_, dedup, fresh=None):
    n = len(tp)
    n_act = np.array([p["bar_active"].sum() for p in tp], np.int32)
    if fresh is None:
        fresh = twgl.fresh_frontier(n, F, W, G, ts["init_state"])
    slot_lane, onehot = twgl._slot_tables(P, W)
    return twgl.run_async(tp[0]["step"], F, T_, *(T(a) for a in fresh),
                          T(n_act), {k: T(ts[k]) for k in twgl.TABLE_ORDER},
                          T(slot_lane).long(), T(onehot), dedup=dedup)


def _assert_async_same(want, got, tag):
    for k in range(5):  # valid, failed_at, lossy, peak, bsnap
        assert (np.asarray(want[k]) == got[k].numpy()).all(), (tag, k)
    wal, gal = np.asarray(want[8]), got[8].numpy()
    assert (wal == gal).all(), (tag, "snapshot alive")
    assert (np.asarray(want[5])[wal] == got[5].numpy()[gal]).all(), tag
    assert (np.asarray(want[6])[wal] == got[6].numpy().view(np.uint32)[gal]).all(), tag
    assert (np.asarray(want[7])[wal] == got[7].numpy()[gal]).all(), tag


def test_async_engine_lane_identical(wide_floor):
    """The async engine at F=64 with the bucket and the fused backends:
    lane-by-lane identical verdict outputs and resume snapshots to the
    JAX async runner under "pallas"; the lanes cover resolved, refuted
    and overflowing histories (exact)."""
    jp, tp = _pair_packs(_histories())
    B, P, G, W, js, ts = _stacked(jp, tp)
    F, T_ = 64, jwgl.async_ticks(B, 64)
    want = _run_jax_async(jp, js, B, P, G, W, F, T_)
    for dedup in ("fused", "bucket"):
        got = _run_port_async(tp, ts, B, P, G, W, F, T_, dedup)
        _assert_async_same(want, got, dedup)
    valid, fat, lossy = (np.asarray(want[k]) for k in range(3))
    assert valid.any() and (fat >= 0).any() and lossy.any()


def test_resume_from_converted_jax_snapshot(wide_floor):
    """A rung resumed in the port from a converted JAX snapshot gives the
    same lane outputs as the JAX rung resumed from it (exact)."""
    jp, tp = _pair_packs(_histories())
    B, P, G, W, js, ts = _stacked(jp, tp)
    first = _run_jax_async(jp, js, B, P, G, W, 64, jwgl.async_ticks(B, 64))
    snap = convert.from_jax_resume(tuple(np.asarray(a) for a in first[4:]))
    assert snap[2].dtype == np.int32
    F2 = 256
    jres = [jwgl.pad_resume(tuple(np.asarray(a)[l] for a in first[4:]), F2, W, G)
            for l in range(len(jp))]
    tres = [twgl.pad_resume(tuple(a[l] for a in snap), F2, W, G)
            for l in range(len(tp))]
    jfresh = tuple(np.stack([r[k] for r in jres]) for k in range(5))
    tfresh = tuple(np.stack([r[k] for r in tres]) for k in range(5))
    assert (jfresh[2].view(np.int32) == tfresh[2]).all()
    T2 = jwgl.async_ticks(B, F2)
    want = _run_jax_async(jp, js, B, P, G, W, F2, T2, fresh=jfresh)
    got = _run_port_async(tp, ts, B, P, G, W, F2, T2, "fused", fresh=tfresh)
    _assert_async_same(want, got, "resumed")
    assert (snap[0] > 0).any()  # some lane resumes mid-history
