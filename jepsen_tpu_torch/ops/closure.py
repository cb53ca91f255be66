"""Dense cycle classification of transactional dependency graphs.

The port of the JAX package's ``ops.closure``, the Elle checkers'
``backend="device"``.  Where the default backend (host SCC,
``checker.scc``) walks edge lists, this one decides cycle existence by
dense boolean matrix powering: the transitive closure of an [n, n]
adjacency is ``ceil(log2 n)`` squarings ``R ← max(R, (R·R) > 0)``, each
one matrix product.  Graphs are padded to multiples of 128 and bucketed
by padded size; a bucket of graphs is one batched product per squaring
(``torch.matmul`` over a leading batch axis, the counterpart of the JAX
package's ``vmap``).

On the card the products run in bf16 on the tensor cores; on the CPU,
which the tests take, in float32.  Both are exact: every entry is 0 or
1, a sum of non-negative terms never rounds to zero, and only the sign
of a product is read.  The JAX package computes these products with
``jnp.dot`` outside Pallas, so this module holds no kernel of its own:
its products are PyTorch's.

Anomaly classification follows Adya's vocabulary:

  G0        cycle of ww edges only
  G1c       cycle of ww+wr edges with ≥1 wr
  G-single  cycle with exactly one rw edge (rest ww/wr)
  G2        cycle with ≥1 rw edge (≥2 when G-single is absent)

The edge tests read "∃ edge (a, b) of type T with a return path b→a in
graph G" as ``(T ∧ closureᵀ(G)).any()``.  Cycle existence is decided on
the device, with one witness hint per anomaly (the first offending edge
in row-major order, or the first node on a ww cycle for G0); witness
cycles are recovered on the host by BFS over the adjacency
(``checker.elle``), so nothing O(n²) leaves the device.  Each bucket's
flags and hints come back in one transfer.

``extra`` edges (realtime/process session graphs) are dependency-neutral:
they may take part in any cycle but never count as ww/wr/rw evidence.

Every entry point runs on the card unless ``device="cpu"`` is asked
for (``_platform.resolve_device``); ``transitive_closure_sharded`` runs
on its mesh's device.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np

from jepsen_tpu_torch._platform import resolve_device

#: Padded sizes are multiples of this (the JAX package's bucket tile).
TILE = 128

#: Batched classifications run, by padded size, since ``reset_counts``
#: (one per bucket of ``classify_graphs``, one per ``classify_graph``).
BUCKET_LAUNCHES: dict[int, int] = {}


def reset_counts() -> None:
    """Set the classification counts to 0."""
    BUCKET_LAUNCHES.clear()


def _pad_to(n: int, tile: int = TILE) -> int:
    return max(tile, ((n + tile - 1) // tile) * tile)


def _n_steps(n: int) -> int:
    # After k squarings R covers paths of length up to 2^k; need 2^k >= n.
    return max(1, int(np.ceil(np.log2(max(2, n)))))


def _mm_dtype(dev):
    """The product dtype: bf16 on the tensor cores, float32 on the CPU."""
    import torch

    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def _on(dev, *mats):
    """Each matrix (numpy or tensor) on ``dev`` in the product dtype."""
    import torch

    dt = _mm_dtype(dev)
    return [torch.as_tensor(m, device=dev).to(dt) for m in mats]


def _closure(r, steps: int):
    """``steps`` squarings of a 0/1 [..., n, n] tensor in its own dtype."""
    import torch

    for _ in range(steps):
        sq = torch.matmul(r, r)
        r = torch.maximum(r, (sq > 0).to(r.dtype))
    return r


def transitive_closure(adj, steps: int, device=None):
    """Closure of a 0/1 adjacency matrix ([n, n], or a batch [b, n, n])
    by ``steps`` squarings; a float32 0/1 tensor on the device."""
    import torch

    (r,) = _on(resolve_device(device), adj)
    return _closure(r, steps).to(torch.float32)


class CycleFlags(NamedTuple):
    """Anomaly verdicts + the closures needed for witnesses."""

    g0: object  # bool tensor (one per graph of a batch)
    g1c: object
    g_single: object
    g2: object  # ≥1 rw in some cycle (g_single implies a weak g2)
    closure_ww: object  # closure(ww|extra)
    closure_wwr: object  # closure(ww|wr|extra)
    closure_all: object  # closure(ww|wr|rw|extra)


def _closures(ww, wr, rw, extra, steps: int):
    import torch

    c_ww = _closure(torch.maximum(ww, extra), steps)
    c_wwr = _closure(torch.maximum(c_ww, wr), steps)  # warm-start
    c_all = _closure(torch.maximum(c_wwr, rw), steps)
    return c_ww, c_wwr, c_all


def _any2(mask):
    """Any true cell of each [n, n] matrix of a [..., n, n] mask."""
    return mask.flatten(-2).any(-1)


def classify_cycles(ww, wr, rw, extra, steps: int, device=None) -> CycleFlags:
    """Adya cycle-anomaly flags of one dependency graph (or of a batch
    with a leading axis).  Inputs are 0/1 [..., n, n] matrices."""
    import torch

    ww, wr, rw, extra = _on(resolve_device(device), ww, wr, rw, extra)
    c_ww, c_wwr, c_all = _closures(ww, wr, rw, extra, steps)
    back_wwr = c_wwr.transpose(-1, -2) > 0
    return CycleFlags(
        c_ww.diagonal(dim1=-2, dim2=-1).sum(-1) > 0,
        _any2((wr > 0) & back_wwr),
        _any2((rw > 0) & back_wwr),
        _any2((rw > 0) & (c_all.transpose(-1, -2) > 0)),
        c_ww.to(torch.float32),
        c_wwr.to(torch.float32),
        c_all.to(torch.float32),
    )


class CycleHints(NamedTuple):
    """Anomaly flags + one witness *hint* per anomaly: the (a, b) indices
    of an offending edge (the diagonal node for G0), or (-1, -1).  Hints
    replace shipping [n, n] closures to the host: a graph returns 4
    flags and 8 ints whatever its size."""

    g0: object
    g1c: object
    g_single: object
    g2: object
    h_g0: object  # [..., 2] int32
    h_g1c: object
    h_g_single: object
    h_g2: object


def _first_edge(mask):
    """(i, j) of the first true cell (row-major) of each [n, n] matrix
    of a [..., n, n] bool mask, else (-1, -1).  ``argmax`` refuses bool,
    so it reads the mask as uint8; it returns the first maximal index."""
    import torch

    n = mask.shape[-1]
    flat = mask.flatten(-2).to(torch.uint8)
    idx = flat.argmax(-1)
    found = flat.gather(-1, idx.unsqueeze(-1)) > 0
    ij = torch.stack([idx // n, idx % n], -1).to(torch.int32)
    return torch.where(found, ij, torch.full_like(ij, -1))


def classify_cycles_hints(ww, wr, rw, extra, steps: int,
                          device=None) -> CycleHints:
    """``classify_cycles``, returning witness hints instead of closures:
    the scalable form (its host transfer is O(1) in n)."""
    import torch

    ww, wr, rw, extra = _on(resolve_device(device), ww, wr, rw, extra)
    c_ww, c_wwr, c_all = _closures(ww, wr, rw, extra, steps)
    diag = c_ww.diagonal(dim1=-2, dim2=-1) > 0
    v = diag.to(torch.uint8).argmax(-1, keepdim=True)
    vv = torch.cat([v, v], -1).to(torch.int32)
    h_g0 = torch.where(diag.gather(-1, v), vv, torch.full_like(vv, -1))
    back_wwr = c_wwr.transpose(-1, -2) > 0
    m_g1c = (wr > 0) & back_wwr
    m_gs = (rw > 0) & back_wwr
    m_g2 = (rw > 0) & (c_all.transpose(-1, -2) > 0)
    return CycleHints(
        diag.any(-1),
        _any2(m_g1c),
        _any2(m_gs),
        _any2(m_g2),
        h_g0,
        _first_edge(m_g1c),
        _first_edge(m_gs),
        _first_edge(m_g2),
    )


def classify_cycles_batch(ww, wr, rw, extra, steps: int,
                          device=None) -> CycleHints:
    """The batched form: [b, n, n] inputs, one step count for all; each
    squaring is one batched product.  The per-key scale-out path."""
    if len(ww.shape) != 3:
        raise ValueError(f"expected [b, n, n] inputs, got shape {tuple(ww.shape)}")
    return classify_cycles_hints(ww, wr, rw, extra, steps, device=device)


def _to_host(res: CycleHints) -> CycleHints:
    """Flags and hints as numpy arrays, in one device-to-host transfer."""
    import torch

    flags = torch.stack([res.g0, res.g1c, res.g_single, res.g2], -1)
    hints = torch.cat([res.h_g0, res.h_g1c, res.h_g_single, res.h_g2], -1)
    packed = torch.cat([flags.to(torch.int32), hints], -1).cpu().numpy()
    return CycleHints(
        *(packed[..., k] > 0 for k in range(4)),
        *(packed[..., 4 + 2 * k: 6 + 2 * k] for k in range(4)),
    )


def pad_adj(m: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a bool adjacency to [size, size] float32."""
    out = np.zeros((size, size), dtype=np.float32)
    n = m.shape[0]
    out[:n, :n] = m.astype(np.float32)
    return out


_EMPTY_FLAGS = {"G0": False, "G1c": False, "G-single": False, "G2": False}
_EMPTY_HINTS = {"G0": None, "G1c": None, "G-single": None, "G2": None}


def _hints_out(res: CycleHints, i=None) -> tuple[dict, dict]:
    """(flags, hints) dicts of one graph from host-side ``CycleHints``
    (graph ``i`` of a batch)."""

    def get(x):
        return np.asarray(x) if i is None else np.asarray(x)[i]

    flags = {
        "G0": bool(get(res.g0)),
        "G1c": bool(get(res.g1c)),
        "G-single": bool(get(res.g_single)),
        "G2": bool(get(res.g2)),
    }
    hints = {}
    for name, h in (
        ("G0", res.h_g0),
        ("G1c", res.h_g1c),
        ("G-single", res.h_g_single),
        ("G2", res.h_g2),
    ):
        pair = get(h)
        hints[name] = (int(pair[0]), int(pair[1])) if pair[0] >= 0 else None
    return flags, hints


def _pad_stack(graphs, idxs, size: int) -> np.ndarray:
    """[4, len(idxs), size, size] bool: the (ww, wr, rw, extra) matrices
    of the graphs ``idxs``, zero-padded."""
    out = np.zeros((4, len(idxs), size, size), dtype=bool)
    for j, i in enumerate(idxs):
        for k in range(4):
            m = graphs[i][k]
            out[k, j, : m.shape[0], : m.shape[1]] = m
    return out


def classify_graph(ww: np.ndarray, wr: np.ndarray, rw: np.ndarray,
                   extra: np.ndarray, device=None):
    """Pad → classify on the device → (flags, hints) for one graph.

    ``hints[anomaly]`` is an (a, b) witness-edge index pair (diagonal
    node for G0) or None."""
    n = ww.shape[0]
    if n == 0:
        return dict(_EMPTY_FLAGS), dict(_EMPTY_HINTS)
    import torch

    dev = resolve_device(device)
    size = _pad_to(n)
    x = torch.from_numpy(_pad_stack([(ww, wr, rw, extra)], [0], size)).to(dev)
    res = classify_cycles_hints(x[0, 0], x[1, 0], x[2, 0], x[3, 0],
                                _n_steps(n), device=dev)
    BUCKET_LAUNCHES[size] = BUCKET_LAUNCHES.get(size, 0) + 1
    return _hints_out(_to_host(res))


def classify_graphs(graphs, device=None, timings: list | None = None
                    ) -> list[tuple[dict, dict]]:
    """Classify MANY dependency graphs in batched device launches.

    ``graphs``: a sequence of (ww, wr, rw, extra) numpy bool matrix
    tuples (ragged sizes fine).  Graphs are bucketed by padded size and
    each bucket runs as one batched classification: one host-to-device
    copy of its bool matrices, ``3 * _n_steps(size)`` batched products,
    one device-to-host copy of its flags and hints.  Returns (flags,
    hints) per graph, in input order.

    With a ``timings`` list, each bucket appends its size, graph count,
    steps and seconds of its stages (``pad`` on the host, ``h2d``,
    ``closure``, ``d2h``), the device synchronised between stages."""
    import torch

    dev = resolve_device(device)
    sync = (torch.cuda.synchronize if timings is not None and dev.type == "cuda"
            else (lambda: None))
    out: list = [None] * len(graphs)
    buckets: dict[int, list[int]] = {}
    for i, (ww, _wr, _rw, _extra) in enumerate(graphs):
        n = ww.shape[0]
        if n == 0:
            out[i] = (dict(_EMPTY_FLAGS), dict(_EMPTY_HINTS))
        else:
            buckets.setdefault(_pad_to(n), []).append(i)
    for size, idxs in sorted(buckets.items()):
        steps = _n_steps(size)
        t0 = time.perf_counter()
        stack = _pad_stack(graphs, idxs, size)
        t1 = time.perf_counter()
        x = torch.from_numpy(stack).to(dev)
        sync()
        t2 = time.perf_counter()
        res = classify_cycles_batch(x[0], x[1], x[2], x[3], steps, device=dev)
        sync()
        t3 = time.perf_counter()
        host = _to_host(res)
        t4 = time.perf_counter()
        BUCKET_LAUNCHES[size] = BUCKET_LAUNCHES.get(size, 0) + 1
        for j, i in enumerate(idxs):
            out[i] = _hints_out(host, j)
        if timings is not None:
            timings.append({"size": size, "graphs": len(idxs), "steps": steps,
                            "products": 3 * steps, "pad": t1 - t0,
                            "h2d": t2 - t1, "closure": t3 - t2, "d2h": t4 - t3})
    return out


# ---------------------------------------------------------------------------
# Row-block-sharded closure: one big graph over the shards of a mesh
# ---------------------------------------------------------------------------


def transitive_closure_sharded(adj: np.ndarray, mesh, steps: int | None = None):
    """Closure of one large adjacency, row-block-sharded over ``mesh``
    (``parallel.mesh``: D logical shards of one card).

    Each shard owns an [n/D, n] row block; at each squaring it multiplies
    its block by the full matrix, the concatenation of every shard's
    block (the counterpart of the JAX package's ``all_gather`` over the
    mesh axis), and ORs the result into its block — the classic 1-D
    sharded product, the D blocks as one batched product.  The carry is
    bool.  Runs on the mesh's device; returns a numpy bool [n, n]."""
    import torch

    D = mesh.size
    n0 = adj.shape[0]
    n = max(TILE, ((n0 + D * TILE - 1) // (D * TILE)) * D * TILE)
    steps = steps if steps is not None else _n_steps(n0)
    padded = np.zeros((n, n), dtype=bool)
    padded[:n0, :n0] = np.asarray(adj, dtype=bool)
    dev = mesh.device
    dt = _mm_dtype(dev)
    blocks = torch.from_numpy(padded).to(dev).view(D, n // D, n)
    for _ in range(steps):
        full = blocks.reshape(n, n).to(dt)
        sq = torch.matmul(blocks.to(dt), full)
        blocks = blocks | (sq > 0)
    return blocks.reshape(n, n)[:n0, :n0].cpu().numpy()


# ---------------------------------------------------------------------------
# CPU oracle (the differential tests' reference)
# ---------------------------------------------------------------------------


def transitive_closure_np(adj: np.ndarray) -> np.ndarray:
    """Pure-numpy Warshall closure — the slow-but-obvious oracle."""
    r = adj.copy().astype(bool)
    n = r.shape[0]
    for k in range(n):
        r |= np.outer(r[:, k], r[k, :])
    return r
