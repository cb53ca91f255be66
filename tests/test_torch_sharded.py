"""The context-parallel path (ROADMAP queue A4) in the port against the
JAX package's: one history's frontier sharded over 4 shards.

The port runs ``sharded_analysis`` on ``make_mesh(4, device="cpu")``
(4 logical shards; the exchange wrapper takes its plain version), the
JAX package on its virtual 4-device CPU mesh, for the cases of
tests/test_sharded.py: valid (40, 4) histories and corrupted (30, 3)
ones at (64, 512), the info-heavy (60, 6, 35 % :info) history at
(256,), and the empty history.  Results are equal, kernel stats
(frontier peak, loss) included, and every decided verdict is the CPU
oracle's.  ``_route`` keeps the JAX routing: each received row lands on
its hash owner, in source order.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.parallel import make_mesh as jax_make_mesh
from jepsen_tpu.parallel.sharded import sharded_analysis as jax_sharded
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.ops import hashing, wide_kernel
from jepsen_tpu_torch.parallel import sharded as tsh
from jepsen_tpu_torch.parallel.mesh import make_mesh
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history

D = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    return make_mesh(D, device="cpu"), jax_make_mesh(D, axis="frontier")


CASES = (
    [(f"valid-{s}", ("valid", s), (64, 512)) for s in range(6)]
    + [(f"corrupt-{s}", ("corrupt", s), (64, 512)) for s in range(12)]
    + [("info-heavy", ("info", 3), (256,)), ("empty", ("empty", 0), (64,))]
)


def _history(kind, seed):
    if kind == "valid":
        return valid_register_history(40, 4, seed=seed, info_rate=0.1)
    if kind == "corrupt":
        return corrupt(valid_register_history(30, 3, seed=seed, info_rate=0.1),
                       seed=seed)
    if kind == "info":
        return valid_register_history(60, 6, seed=seed, info_rate=0.35)
    return []


@pytest.mark.parametrize("name,spec,cap", CASES, ids=[c[0] for c in CASES])
def test_sharded_analysis_matches_jax(meshes, name, spec, cap):
    pmesh, jmesh = meshes
    hist = _history(*spec)
    want = jax_sharded(jm.CASRegister(None), hist, jmesh, capacity=cap)
    got = tsh.sharded_analysis(tm.CASRegister(None), hist, pmesh, capacity=cap)
    assert got == want
    if got["valid?"] != "unknown" and hist:
        assert got["valid?"] == wgl_cpu.dfs_analysis(
            tm.CASRegister(None), hist)["valid?"]
    if spec[0] in ("valid", "info"):
        assert got["valid?"] is True and got["kernel"]["devices"] == D


def test_route_sends_rows_to_their_hash_owner(meshes):
    """Every alive row arrives on shard hash % D, in source-shard order,
    cheapest first within a source, and a bucket too small spills."""
    pmesh, _ = meshes
    rng = np.random.default_rng(0)
    n, W, G, C = 40, 1, 3, 16
    state = torch.from_numpy(rng.integers(0, 6, (D, n)).astype(np.int32))
    fok = torch.from_numpy(rng.integers(0, 8, (D, n, W)).astype(np.int32))
    fcr = torch.from_numpy(rng.integers(0, 3, (D, n, G)).astype(np.int16))
    alive = torch.from_numpy(rng.random((D, n)) < 0.7)
    cost = torch.from_numpy(rng.integers(0, 5, (D, n)).astype(np.int32))
    st, fo, fc, al, co, spilled = tsh._route(pmesh, C, state, fok, fcr,
                                            alive, cost)
    assert st.shape == (D, D * C) and fo.shape == (D, D * C, W)
    h = hashing.hash_rows([state, fok[..., 0]], wide_kernel.MESH_ROUTE_SEED) % D
    for r in range(D):
        got = []
        for src in range(D):
            blk = slice(src * C, (src + 1) * C)
            rows = [(int(c), int(s), int(f), tuple(x.tolist()))
                    for s, f, x, c, a in zip(st[r, blk], fo[r, blk, 0],
                                             fc[r, blk], co[r, blk], al[r, blk])
                    if a]
            assert rows == sorted(rows, key=lambda t: t[0])
            want = sorted(
                ((int(cost[src, i]), int(state[src, i]), int(fok[src, i, 0]),
                  tuple(fcr[src, i].tolist()))
                 for i in range(n) if alive[src, i] and int(h[src, i]) == r),
                key=lambda t: t[0])[:C]
            assert sorted(rows) == sorted(want)
            got += rows
    counts = [[int(((h[s] == r) & alive[s]).sum()) for r in range(D)]
              for s in range(D)]
    assert spilled == any(c > C for row in counts for c in row)


def test_mesh_round_probe_times_a_feasible_shape(monkeypatch, meshes):
    """mesh_round_probe returns the occupancy and, at a shape the mesh
    stage takes, seconds per round; an infeasible shape is not timed."""
    pmesh, _ = meshes
    monkeypatch.setenv(wide_kernel.FUSED_MIN_CAPACITY_ENV, "64")
    out = tsh.mesh_round_probe(pmesh, 256, 8, 4, rounds=1)
    assert out["occupancy"]["feasible"] and out["mesh"] > 0
    assert out["occupancy"]["devices"] == D
    bad = tsh.mesh_round_probe(pmesh, 12, 8, 4)
    assert bad["mesh"] is None and not bad["occupancy"]["feasible"]
