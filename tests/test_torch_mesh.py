"""The port's mesh-spanning wide stage against the JAX package's.

The JAX suite's mesh shapes (tests/test_wide_kernel.py): D = 4, global
capacity 256 (64 rows per shard), P = 4, G = 3, W = 1.  The JAX side
runs on the virtual 8-device CPU mesh of tests/conftest.py in Pallas
interpret mode, as the JAX suite runs it, and its references are built
once per module.  The port runs on 4 logical shards of the CPU, where
its kernel wrappers take their plain versions.  Inputs are numpy arrays
from a seed.  Every comparison is exact (integers and bits, tolerance
0): per-shard outputs with positions, overflow flags, fingerprints,
verdicts and kernel stats.  Both packages' wide floors are lowered to
64 together, so that they route the same shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from jepsen_tpu import _platform as jplatform
from jepsen_tpu import models as jm
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.ops import wide_kernel as wk
from jepsen_tpu.parallel import batch_analysis as jax_batch_analysis
from jepsen_tpu.parallel import make_mesh as jax_make_mesh
from jepsen_tpu.parallel import sharded as jsh
from jepsen_tpu_torch import convert
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.ops import hashing as th
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wide_kernel as twk
from jepsen_tpu_torch.parallel import batch as tbatch
from jepsen_tpu_torch.parallel import sharded as tsh
from jepsen_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_device_ids
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history

T = torch.from_numpy

MESH_D = 4
MESH_CAP = 256
MESH_P, MESH_G, MESH_W = 4, 3, 1
MESH_N = MESH_CAP * (1 + MESH_P + MESH_G)


@pytest.fixture(scope="module", autouse=True)
def _wide_floors():
    """Route the 64-row shard shapes to the fused update in both
    packages; the JAX runner caches do not key on the floor, so they are
    evicted at teardown."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(wk.PALLAS_MIN_CAPACITY_ENV, "64")
        mp.setenv(twk.FUSED_MIN_CAPACITY_ENV, "64")
        yield
    jwgl.evict_runner_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on one host: one torch
    thread each keeps them from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(MESH_D, axis="frontier")


@pytest.fixture(scope="module")
def pmesh():
    return make_mesh(MESH_D, device="cpu")


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 4, 8])
def test_mesh_exchange_matches_jax(D):
    """The plain exchange (and the wrapper, which takes it on the CPU)
    equals the JAX remote-DMA ring on a D-device mesh bit for bit, and
    shard m's slot s holds what source (m - s) % D put in its slot s."""
    rcap, nc = 8, 5
    rng = np.random.default_rng(D)
    noise = rng.integers(-2**31, 2**31 - 1, (D, D, rcap, nc), dtype=np.int64)
    tagged = np.broadcast_to(
        (np.arange(D)[:, None] * D + np.arange(D)[None, :])[:, :, None, None],
        (D, D, rcap, nc))
    jmesh_d = jax_make_mesh(D, axis="frontier")
    fn = jax.jit(jplatform.shard_map(
        lambda x: wk.mesh_exchange("frontier", D, x, interpret=True),
        mesh=jmesh_d, in_specs=(PartitionSpec("frontier"),),
        out_specs=PartitionSpec("frontier"), check_vma=False,
    ))
    for send in (noise.astype(np.int32), tagged.astype(np.int32)):
        want = np.asarray(fn(jnp.asarray(send.reshape(D * D, rcap, nc))))
        want = want.reshape(D, D, rcap, nc)
        got = twk.mesh_exchange(make_mesh(D, device="cpu"), T(send.copy()))
        assert (twk.mesh_exchange_ref(T(send.copy())) == got).all()
        assert (got.numpy() == want).all()
        for m in range(D):
            for s in range(D):
                assert (got[m, s].numpy() == send[(m - s) % D, s]).all(), (m, s)
    out = got.numpy()
    for m in range(D):
        for s in range(D):
            assert (out[m, s] == ((m - s) % D) * D + s).all()


def test_exchange_wrapper_refuses_what_it_cannot_launch():
    """A send matrix that is not on the CPU goes to the kernel path,
    which refuses a non-CUDA tensor without falling back; shapes and
    dtypes are checked first.  No launch is counted."""
    mesh = Mesh((torch.device("meta"),) * 2)
    before = twk.EXCHANGE_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        twk.mesh_exchange(mesh, torch.zeros(2, 2, 4, 3, dtype=torch.int32,
                                            device="meta"))
    with pytest.raises(ValueError, match=r"\[2, 2"):
        twk.mesh_exchange(mesh, torch.zeros(2, 3, 4, 3, dtype=torch.int32))
    with pytest.raises(TypeError):
        twk.mesh_exchange(mesh, torch.zeros(2, 2, 4, 3, dtype=torch.int64))
    assert twk.EXCHANGE_LAUNCHES == before


def test_exchange_bases_by_value():
    """The kernel's pointer tables: shard m's send and receive bases in
    two fixed-size host arrays (passed by value at launch, no copy to
    the card), zero past D; more shards than the kernel's parameter
    holds are refused."""
    D = 4
    send = torch.zeros(D, D, 8, 5, dtype=torch.int32)
    recv = torch.empty_like(send)
    sb, rb = twk._exchange_bases(send, recv)
    assert len(sb) == len(rb) == twk.MESH_MAX_SHARDS == 64
    assert list(sb[:D]) == [send[m].data_ptr() for m in range(D)]
    assert list(rb[:D]) == [recv[m].data_ptr() for m in range(D)]
    assert all(p is None for p in list(sb[D:]) + list(rb[D:]))
    big = torch.zeros(65, 65, 1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 64 shards"):
        twk._exchange_bases(big, big)
    before = twk.EXCHANGE_LAUNCHES
    mesh = Mesh((torch.device("meta"),) * 65)
    with pytest.raises(ValueError):
        twk.mesh_exchange(mesh, torch.zeros(65, 65, 1, 1, dtype=torch.int32,
                                            device="meta"))
    assert twk.EXCHANGE_LAUNCHES == before


# ---------------------------------------------------------------------------
# The fused update's explicit child column
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_fused_child_matches_pallas(seed):
    """fused_frontier_update_ref(child=) against the Pallas fused kernel
    in interpret mode with the same randomized child column: every row
    (dead rows are zeros in both), overflow, fingerprint and child; the
    CPU wrapper returns the same."""
    cap = 64
    st, fo, fc, al = th.probe_candidates(cap, MESH_P, MESH_G, 1, seed=seed)
    child = np.random.default_rng(100 + seed).random(st.shape[0]) < 0.5
    got = twk.fused_frontier_update_ref(
        T(st)[None], T(fo)[None], T(fc)[None], T(al)[None], cap, 4, None,
        MESH_P + 1, child=T(child)[None])
    via = twk.fused_frontier_update(T(st), T(fo), T(fc), T(al), None, cap,
                                    max_count=MESH_P + 1, child=T(child))
    want = wk.fused_update_jit(
        jnp.asarray(st), jnp.asarray(fo.view(np.uint32)), jnp.asarray(fc),
        jnp.asarray(al), jnp.zeros(st.shape[0], jnp.int32), cap,
        max_count=MESH_P + 1, interpret=True, child=jnp.asarray(child))
    for k in range(7):
        g = got[k][0].numpy()
        if k == 1:
            g = g.view(np.uint32)
        w = np.asarray(want[k])
        assert (g.astype(np.int64) == w.astype(np.int64)).all(), k
        assert (via[k].numpy() == got[k][0].numpy()).all(), k
    assert got[6][0].any() and (got[6][0] != got[3][0]).any()
    with pytest.raises(ValueError, match="either"):
        twk.fused_frontier_update(T(st), T(fo), T(fc), T(al), None, cap,
                                  n_parents=cap, max_count=MESH_P + 1,
                                  child=T(child))


# ---------------------------------------------------------------------------
# mesh_update: per-shard bit identity with the JAX package
# ---------------------------------------------------------------------------


def _mesh_gen(seed, n=MESH_N, alive_p=0.6, rich=False):
    """The JAX suite's small-content-space tables (few unique rows, so
    non-overflow rounds dominate); ``rich`` widens the content space so
    that shards overflow and positions carry more."""
    rng = np.random.default_rng(seed)
    hi = (32, 16, 4) if rich else (5, 3, 2)
    return (
        rng.integers(0, hi[0], n).astype(np.int32),
        rng.integers(0, hi[1], (n, MESH_W)).astype(np.uint32),
        rng.integers(0, hi[2], (n, MESH_G)).astype(np.int16),
        rng.random(n) < alive_p,
    )


def _mesh_case(tag):
    if tag.startswith("seed"):
        return _mesh_gen(int(tag[4:]))
    if tag.startswith("rich"):
        return _mesh_gen(10 + int(tag[4:]), rich=True)
    if tag == "ragged":  # every live row in the first input shard
        st, fo, fc, al = _mesh_gen(2)
        return st, fo, fc, al & (np.arange(MESH_N) < MESH_N // 4)
    # all-to-one: one (state, fok) class, so one owner shard whose live
    # rows exceed its fixed receive slot
    return (np.zeros(MESH_N, np.int32), np.zeros((MESH_N, MESH_W), np.uint32),
            np.arange(MESH_N)[:, None].repeat(MESH_G, 1).astype(np.int16),
            np.ones(MESH_N, bool))


MESH_CASES = ["seed0", "seed1", "seed2", "seed3", "rich0", "rich1",
              "ragged", "all-to-one"]


@pytest.fixture(scope="module")
def jax_mesh_ref(jmesh):
    """JAX ``sh.mesh_update`` of every case, in the port's layout."""
    out = {}
    for tag in MESH_CASES:
        st, fo, fc, al = _mesh_case(tag)
        res = jsh.mesh_update(
            jmesh, jnp.asarray(st), jnp.asarray(fo), jnp.asarray(fc),
            jnp.asarray(al), jnp.zeros(MESH_N, jnp.int32), MESH_CAP,
            n_parents=MESH_CAP, max_count=MESH_P + 1)
        out[tag] = convert.from_jax_mesh(res, MESH_D)
    return out


def _port_update(pmesh, tag):
    st, fo, fc, al = _mesh_case(tag)
    return tsh.mesh_update(pmesh, T(st), T(fo.view(np.int32)), T(fc), T(al),
                           None, MESH_CAP, n_parents=MESH_CAP,
                           max_count=MESH_P + 1)


def _content_child(state, fok, fcr, alive, child):
    """The alive rows' (content, child bit) set of a table, shards
    flattened."""
    s, a, ch = (np.asarray(x).reshape(-1) for x in (state, alive, child))
    f = np.asarray(fok).reshape(len(s), -1)
    c = np.asarray(fcr).reshape(len(s), -1)
    return {(int(s[i]), tuple(int(x) for x in f[i]),
             tuple(int(x) for x in c[i]), bool(ch[i]))
            for i in np.flatnonzero(a)}


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_update_matches_jax(case, pmesh, jax_mesh_ref):
    """Port ``mesh_update`` against JAX ``sh.mesh_update``: each shard's
    rows bit-identical, positions included (dead rows zeros), and the
    global overflow flag and fingerprint.  Without overflow, the content
    with child bits and the fingerprint also equal the single-shard
    fused update's at the same global capacity (the cross-path
    contract); the all-to-one class overflows its owner's receive slot
    and must say so."""
    got = _port_update(pmesh, case)
    want = jax_mesh_ref[case]
    for k in (0, 1, 2, 3, 6):
        assert tuple(got[k].shape[:2]) == (MESH_D, MESH_CAP // MESH_D)
        assert got[k].numpy().shape == want[k].shape
        assert (got[k].numpy() == want[k]).all(), (case, k)
    assert bool(got[4]) == want[4], case
    assert (got[5].numpy() == want[5]).all(), case
    st, fo, fc, al = _mesh_case(case)
    single = twk.fused_frontier_update_ref(
        T(st)[None], T(fo.view(np.int32))[None], T(fc)[None], T(al)[None],
        MESH_CAP, 4, MESH_CAP, MESH_P + 1)
    if case == "all-to-one":
        assert bool(got[4])
    elif not bool(got[4]):
        assert not bool(single[4][0])
        assert (_content_child(*got[:4], got[6])
                == _content_child(*(x[0] for x in single[:4]), single[6][0]))
        assert (got[5] == single[5][0]).all()


def test_mesh_update_comparisons_are_not_vacuous(pmesh, jax_mesh_ref):
    """At least three of the four seeded tables and the ragged one run
    without overflow, and the rich tables overflow, so both kinds of
    round are held to the JAX package."""
    quiet = [t for t in ("seed0", "seed1", "seed2", "seed3")
             if not jax_mesh_ref[t][4]]
    assert len(quiet) >= 3
    assert not jax_mesh_ref["ragged"][4]
    assert any(jax_mesh_ref[t][4] for t in ("rich0", "rich1"))
    assert all(jax_mesh_ref[t][3].sum() > 0 for t in quiet)


# ---------------------------------------------------------------------------
# The engine and the ladder's rescue
# ---------------------------------------------------------------------------


def _engine_cases():
    """(tag, history, kwargs): valid and corrupted histories at the JAX
    suite's capacities, and a starved closure (rounds=1) that ends
    unknown with the mesh-capacity report."""
    out = [(f"valid{s}", valid_register_history(40, 4, seed=s, info_rate=0.1),
            dict(capacity=(64, 256))) for s in range(2)]
    out += [(f"corrupt{s}", corrupt(valid_register_history(
        30, 3, seed=s, info_rate=0.1), seed=s), dict(capacity=(64, 256)))
        for s in range(4)]
    out.append(("starved", corrupt(valid_register_history(
        40, 4, seed=5, info_rate=0.35), seed=5),
        dict(capacity=(256,), rounds=1)))
    return out


ENGINE_CASES = [c[0] for c in _engine_cases()]


@pytest.fixture(scope="module")
def jax_engine_ref(jmesh):
    return {tag: jsh.mesh_kernel_analysis(jm.CASRegister(None), h, jmesh, **kw)
            for tag, h, kw in _engine_cases()}


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_mesh_kernel_analysis_matches_jax(case, pmesh, jax_engine_ref):
    """Port ``mesh_kernel_analysis`` against the JAX engine: the same
    result keys, verdict, kernel stats (failed-at, frontier-peak,
    lossy?, capacities), provisional flag, and for an unknown the same
    undecidability report and cause; a decided verdict agrees with the
    exact sweep."""
    _tag, hist, kw = next(c for c in _engine_cases() if c[0] == case)
    got = tsh.mesh_kernel_analysis(tm.CASRegister(None), hist, pmesh, **kw)
    want = jax_engine_ref[case]
    assert sorted(got) == sorted(want)
    assert got["valid?"] == want["valid?"]
    assert got["kernel"] == want["kernel"]
    assert got.get("provisional?") == want.get("provisional?")
    assert got.get("op") == want.get("op")
    if got["valid?"] == "unknown":
        assert got["undecidability"] == want["undecidability"]
        assert got["cause"] == want["cause"]
        assert case == "starved"
    else:
        cpu = wgl_cpu.sweep_analysis(tm.CASRegister(None), hist)
        assert cpu["valid?"] == got["valid?"]
    assert tsh.mesh_kernel_analysis(tm.CASRegister(None), [], pmesh) == {"valid?": True}


def test_batch_analysis_mesh_rescue_matches_jax(pmesh, jmesh):
    """The slice as a whole: port ``batch_analysis(mesh=4 shards)``
    against JAX ``batch_analysis(mesh=4 devices, "pallas")`` on a ladder
    narrow enough (one 64-row rung, no greedy walk) that three lanes
    reach the mesh rescue at 256 rows, where one lands True, one is
    refuted and confirmed by the exact sweep, and one stays unknown with
    the mesh-capacity cause.  Verdicts, rescue kernel stats and causes
    are identical."""
    hists = [valid_register_history(60, 6, seed=3, info_rate=0.35),
             corrupt(valid_register_history(60, 6, seed=11, info_rate=0.35),
                     seed=11),
             corrupt(valid_register_history(60, 6, seed=9, info_rate=0.35),
                     seed=9),
             valid_register_history(30, 3, seed=1, info_rate=0.1)]
    kw = dict(capacity=(64,), cpu_fallback=False, exact_escalation=(),
              greedy_first=False)
    want = jax_batch_analysis(jm.CASRegister(None), hists, mesh=jmesh,
                              dedup_backend="pallas", **kw)
    stats = {}
    got = tbatch.batch_analysis(tm.CASRegister(None), hists, mesh=pmesh,
                                dedup_backend="fused", confirm_workers=2,
                                stats=stats, **kw)
    assert [r["valid?"] for r in got] == [r["valid?"] for r in want]
    assert [r["valid?"] for r in got] == [True, False, "unknown", True]
    rescue = stats["mesh_rescue"]
    assert (rescue["capacity"], rescue["shards"], rescue["lanes"],
            rescue["resolved"]) == (MESH_CAP, MESH_D, 3, 2)
    for g, w in zip(got, want):
        assert g.get("kernel") == w.get("kernel")
        assert g.get("undecidability") == w.get("undecidability")
        assert g.get("confirmed?") == w.get("confirmed?")
    # the mesh-capacity cause, then the ladder's exhaustion note (whose
    # wording the port shortens)
    mesh_cause = got[2]["cause"].split("; ")[0]
    assert mesh_cause == want[2]["cause"].split("; ")[0]
    assert mesh_cause.startswith("undecidable under fixed memory")
    assert "exhausted" in got[2]["cause"]
    assert got[1]["confirmed?"] is True


# ---------------------------------------------------------------------------
# Gates and refusals
# ---------------------------------------------------------------------------


def test_mesh_feasible_mirrors_jax_without_vmem(monkeypatch):
    """Without its VMEM terms the JAX gate decides as the port's does,
    at both floors, over a grid of rung shapes; with them, the JAX gate
    refuses the bench rescue shape (G = 32, 4 x 2048 rows), which the
    port runs (a routing difference by design)."""
    for floor in ("64", "1024"):
        monkeypatch.setenv(wk.PALLAS_MIN_CAPACITY_ENV, floor)
        monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, floor)
        for cap in (256, 512, 1000, 2048, 4096, 8192, 16384):
            for D in (1, 2, 3, 4, 8):
                for G in (4, 16, 32):
                    n = cap * (1 + 8 + G)
                    assert twk.mesh_feasible(n, cap, 9, D) == wk.mesh_feasible(
                        n, cap, 9, D), (floor, cap, D, G)
                    assert twk.mesh_rcap(n // D, D) == wk.mesh_rcap(n // D, D)
    n = 8192 * (1 + 8 + 32)
    assert twk.mesh_feasible(n, 8192, 9, 4)
    assert not wk.mesh_feasible(n, 8192, 9, 4, w=1, g=32)
    occ = twk.mesh_occupancy(8192, 8, 32, max_count=9, devices=4)
    assert (occ["rcap"], occ["recv_rows"], occ["per_device_capacity"]) == (
        31488, 125952, 2048)
    assert occ["feasible"] and occ["exchange_bytes"] == 2 * 16 * 31488 * 36 * 4
    assert twk.exchange_cols(1, 32) == wk.exchange_cols(1, 32) == 36


@pytest.mark.parametrize("case", ["one-shard", "infeasible", "mixed-devices",
                                  "no-shards", "foreign-mesh"])
def test_mesh_refusals(case, monkeypatch):
    """What the port does not run raises: shards on different devices
    (the cross-card mesh), an empty mesh, and a mesh that is not the
    port's.  A mesh of fewer than two shards or an infeasible geometry
    falls back to the chunked engine, as in the JAX package."""
    model = tm.CASRegister(None)
    hist = valid_register_history(20, 3, seed=0, info_rate=0.1)
    if case in ("one-shard", "infeasible"):
        shards, cap = (1, 64) if case == "one-shard" else (4, 256)
        if case == "infeasible":
            monkeypatch.setenv(twk.FUSED_MIN_CAPACITY_ENV, "4096")
        got = tsh.mesh_kernel_analysis(model, hist,
                                       make_mesh(shards, device="cpu"),
                                       capacity=(cap,))
        assert got == twgl.analysis(model, hist, capacity=(cap,), fast=True,
                                    dedup_backend="fused", device="cpu")
        assert got["valid?"] is True and "devices" not in got["kernel"]
    elif case == "mixed-devices":
        with pytest.raises(NotImplementedError, match="cross-card"):
            Mesh((torch.device("cpu"), torch.device("cuda", 1)))
    elif case == "no-shards":
        with pytest.raises(ValueError):
            make_mesh(0, device="cpu")
        with pytest.raises(ValueError):
            Mesh(())
    else:
        with pytest.raises(NotImplementedError, match="cross-card"):
            tbatch.batch_analysis(model, [hist], device="cpu",
                                  mesh=jax_make_mesh(4))
    mesh = make_mesh(2, device="cpu", axis="x")
    assert (mesh.size, mesh.axis, mesh_device_ids(mesh)) == (2, "x", [0, 0])
    assert mesh_device_ids(None) == [0]
