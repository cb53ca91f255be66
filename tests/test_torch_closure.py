"""The port's dense closure backend (``ops.closure``) and host SCC
(``checker.scc``) against the JAX package's.

Inputs are random 0/1 adjacency matrices made from numpy seeds, the
ring/chain/self-loop graphs of tests/test_elle_batch.py, and sizes 0, 3,
7, 127, 128, 129 and 300 nodes, which cross the 128-node bucket edges.
The JAX side runs on the CPU (its closure is ``jnp.dot`` outside
Pallas); the port runs with ``device="cpu"`` (float32 products).
Tolerance 0: closures, flags and hints are booleans and indices.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import scc as jscc
from jepsen_tpu.ops import closure as jcl
from jepsen_tpu.parallel import make_mesh as jmake_mesh
from jepsen_tpu_torch.checker import scc as tscc
from jepsen_tpu_torch.ops import closure as tcl
from jepsen_tpu_torch.parallel.mesh import make_mesh

SIZES = (3, 7, 127, 128, 129, 300)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(n: int, seed: int, p=(0.012, 0.01, 0.01, 0.004), diag=False):
    """(ww, wr, rw, extra) bool matrices with about 40·p edges a row:
    sparse enough that the large sizes mix flagged and clean classes."""
    rng = np.random.default_rng(seed)
    out = []
    for q in p:
        m = rng.random((n, n)) < q * 40.0 / max(n, 1)
        if not diag:
            np.fill_diagonal(m, False)
        out.append(m)
    return tuple(out)


def ring(n):
    ww = np.zeros((n, n), bool)
    for i in range(n):
        ww[i, (i + 1) % n] = True
    return ww


def chain(n):
    ww = np.zeros((n, n), bool)
    for i in range(n - 1):
        ww[i, i + 1] = True
    return ww


def _planted(n: int) -> tuple:
    """One G0, one G1c, one G-single and one G2 cycle on disjoint nodes
    of an otherwise acyclic n-node graph (n ≥ 16)."""
    z = np.zeros((n, n), bool)
    ww, wr, rw, extra = z.copy(), z.copy(), z.copy(), z.copy()
    ww[1, 2] = ww[2, 1] = True                      # G0
    ww[4, 5] = True; wr[5, 4] = True                 # G1c
    ww[7, 8] = True; rw[8, 7] = True                 # G-single
    rw[10, 11] = True; rw[11, 10] = True             # G2 (two rw)
    for i in range(12, n - 1):                       # an acyclic tail
        extra[i, i + 1] = True
    return ww, wr, rw, extra


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", range(2))
def test_transitive_closure_matches_jax_and_numpy(n, seed):
    """One closure at the padded size and its step count: the port's
    equals the JAX package's and the Warshall oracle's."""
    adj = _graph(n, seed)[0] | _graph(n, seed + 10)[1]
    size, steps = tcl._pad_to(n), tcl._n_steps(n)
    assert (size, steps) == (jcl._pad_to(n), jcl._n_steps(n))
    padded = tcl.pad_adj(adj, size)
    np.testing.assert_array_equal(padded, jcl.pad_adj(adj, size))
    got = tcl.transitive_closure(padded, steps, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jcl.transitive_closure(padded, steps))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:n, :n] > 0,
                                  tcl.transitive_closure_np(adj))
    np.testing.assert_array_equal(tcl.transitive_closure_np(adj),
                                  jcl.transitive_closure_np(adj))


@pytest.mark.parametrize("n", SIZES)
def test_classify_cycles_flags_and_closures(n):
    """``classify_cycles``: the four flags and the three closures."""
    mats = [tcl.pad_adj(m, tcl._pad_to(n)) for m in _graph(n, 100 + n)]
    steps = tcl._n_steps(n)
    got = tcl.classify_cycles(*mats, steps, device="cpu")
    want = jcl.classify_cycles(*mats, steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("self_loops", [False, True])
def test_classify_cycles_hints(n, self_loops):
    """``classify_cycles_hints``: flags and first-index hints (the
    port's uint8 ``argmax`` takes the first maximal cell as ``jnp``'s)."""
    mats = [tcl.pad_adj(m, tcl._pad_to(n))
            for m in _graph(n, 200 + n, diag=self_loops)]
    steps = tcl._n_steps(n)
    got = tcl.classify_cycles_hints(*mats, steps, device="cpu")
    want = jcl.classify_cycles_hints(*mats, steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", (0,) + SIZES)
@pytest.mark.parametrize("seed", range(2))
def test_classify_graph_matches_jax(n, seed):
    """``classify_graph`` on random graphs of every size, self-loops
    allowed in the second seed: the same flags and hints."""
    g = _graph(n, 300 + seed, diag=bool(seed))
    assert tcl.classify_graph(*g, device="cpu") == jcl.classify_graph(*g)


@pytest.mark.parametrize("n", (16, 127, 129, 300))
def test_planted_cycles(n):
    """Each Adya anomaly planted once: both packages flag all four and
    hint the same witness edges; the acyclic tail alone flags none."""
    g = _planted(n)
    flags, hints = tcl.classify_graph(*g, device="cpu")
    assert flags == {"G0": True, "G1c": True, "G-single": True, "G2": True}
    assert hints == {"G0": (1, 1), "G1c": (5, 4), "G-single": (8, 7),
                     "G2": (8, 7)}
    assert (flags, hints) == jcl.classify_graph(*g)
    z = np.zeros((n, n), bool)
    assert tcl.classify_graph(z, z, z, g[3], device="cpu") == (
        tcl._EMPTY_FLAGS, tcl._EMPTY_HINTS)


def _corpus():
    z3, z7 = np.zeros((3, 3), bool), np.zeros((7, 7), bool)
    rng = np.random.default_rng(5)
    rand = []
    for n in (0, 3, 7, 127, 128, 129, 300, 40, 5):
        m = [rng.random((n, n)) < 0.03 for _ in range(4)]
        rand.append(tuple(m))
    return [
        (ring(3), z3, z3, z3),          # G0 cycle
        (chain(7), z7, z7, z7),         # acyclic
        (np.zeros((0, 0), bool),) * 4,  # empty
        (chain(3), ring(3) & ~chain(3) & ~np.eye(3, dtype=bool), z3, z3),
        *[(ring(n), np.zeros((n, n), bool), np.zeros((n, n), bool),
           np.zeros((n, n), bool)) for n in (3, 150, 5, 140)],
        *rand,
    ]


def test_classify_graphs_matches_jax_and_single():
    """The bucketed batch (ring, chain, empty, mixed-bucket and random
    graphs of 0–300 nodes): each graph's flags and hints equal the JAX
    package's batch and the port's single-graph classification."""
    graphs = _corpus()
    tcl.reset_counts()
    timings: list = []
    got = tcl.classify_graphs(graphs, device="cpu", timings=timings)
    assert got == jcl.classify_graphs(graphs)
    assert got == [tcl.classify_graph(*g, device="cpu") for g in graphs]
    # one batched classification per padded size in the batch, plus
    # one per non-empty single-graph call above
    sizes = sorted({tcl._pad_to(g[0].shape[0]) for g in graphs if len(g[0])})
    assert [t["size"] for t in timings] == sizes
    for t in timings:
        assert t["products"] == 3 * t["steps"] == 3 * tcl._n_steps(t["size"])
        assert all(t[k] >= 0 for k in ("pad", "h2d", "closure", "d2h"))
    assert sum(t["graphs"] for t in timings) == sum(
        1 for g in graphs if len(g[0]))
    singles = {s: sum(1 for g in graphs if len(g[0]) and tcl._pad_to(len(g[0])) == s)
               for s in sizes}
    assert tcl.BUCKET_LAUNCHES == {s: 1 + singles[s] for s in sizes}
    tcl.reset_counts()
    assert tcl.BUCKET_LAUNCHES == {}


def test_classify_cycles_batch_shapes():
    """The batched form takes [b, n, n] and refuses a single matrix."""
    rng = np.random.default_rng(0)
    n, size = 10, 128
    ww = np.stack([tcl.pad_adj(rng.random((n, n)) < 0.2, size)
                   for _ in range(4)])
    zero = np.zeros_like(ww)
    got = tcl.classify_cycles_batch(ww, zero, zero, zero, tcl._n_steps(n),
                                    device="cpu")
    want = jcl.classify_cycles_batch(ww, zero, zero, zero, jcl._n_steps(n))
    assert got.g0.shape == (4,) and got.h_g0.shape == (4, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match=r"\[b, n, n\]"):
        tcl.classify_cycles_batch(ww[0], zero[0], zero[0], zero[0], 4,
                                  device="cpu")


@pytest.mark.parametrize("n", (50, 129, 300))
def test_sharded_closure_matches_jax(n):
    """The row-block-sharded closure on 4 logical shards equals the JAX
    package's on its virtual 8-device CPU mesh, the oracle's, and the
    port's on 1 and 2 shards."""
    rng = np.random.default_rng(7 + n)
    adj = rng.random((n, n)) < 2.5 / n
    np.fill_diagonal(adj, False)
    want = jcl.transitive_closure_np(adj)
    got = tcl.transitive_closure_sharded(adj, make_mesh(4, device="cpu"))
    assert got.dtype == bool and got.shape == (n, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jcl.transitive_closure_sharded(adj, jmake_mesh()))
    for d in (1, 2):
        np.testing.assert_array_equal(
            tcl.transitive_closure_sharded(adj, make_mesh(d, device="cpu")), want)


@pytest.mark.parametrize("seed", range(6))
def test_scc_matches_jax_and_closure(seed):
    """``classify_graph_scc``, with and without the sparse edge view,
    equals the JAX function and the dense closure (flags and hints),
    self-loops included."""
    rng = np.random.default_rng(11 + seed)
    n = int(rng.integers(2, 40))
    g = tuple(rng.random((n, n)) < p for p in (0.05, 0.04, 0.04, 0.02))
    if seed % 2 == 0:
        for m in g:
            np.fill_diagonal(m, False)
    edges = {k: np.argwhere(m) for k, m in zip(("ww", "wr", "rw", "extra"), g)}
    got = tscc.classify_graph_scc(*g)
    assert got == jscc.classify_graph_scc(*g)
    assert got == tscc.classify_graph_scc(*g, edges=edges)
    assert got == jscc.classify_graph_scc(*g, edges=edges)
    assert got == tcl.classify_graph(*g, device="cpu")
    comp = tscc.tarjan_scc(n, tscc._adj_lists(n, np.argwhere(g[0])))
    np.testing.assert_array_equal(
        comp, jscc.tarjan_scc(n, jscc._adj_lists(n, np.argwhere(g[0]))))


def test_scc_self_loop_corner():
    """A bare rw self-loop is G2 but not G-single, on both backends of
    both packages; on a node with a real wwr cycle it is G-single."""
    n = 3
    zero = np.zeros((n, n), bool)
    rw = zero.copy()
    rw[1, 1] = True
    for g in ((zero, zero, rw, zero),):
        sf, _ = tscc.classify_graph_scc(*g)
        assert not sf["G-single"] and sf["G2"]
        assert tscc.classify_graph_scc(*g) == jscc.classify_graph_scc(*g)
        assert tcl.classify_graph(*g, device="cpu") == jcl.classify_graph(*g)
    ww = zero.copy()
    ww[1, 2] = ww[2, 1] = True
    g = (ww, zero, rw, zero)
    assert tscc.classify_graph_scc(*g)[0]["G-single"]
    assert tcl.classify_graph(*g, device="cpu") == tscc.classify_graph_scc(*g)
