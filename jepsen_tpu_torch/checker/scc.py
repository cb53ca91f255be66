"""Host-side SCC cycle classification for dependency graphs.

The port's copy of the JAX package's ``checker.scc``, and the Elle
checkers' default cycle backend (``checker.elle.CYCLE_BACKEND``): sparse
O(V+E) Tarjan over the graph's edge lists.  The dense closure on the
card (``ops.closure``) is the ``backend="device"`` opt-in.

Classification is exact, matching ops/closure.py's semantics:

  G0        some SCC of (ww ∪ extra) contains a cycle
  G1c       some wr edge (a, b) has a return path b→a in (ww ∪ wr ∪ extra)
            — equivalently both endpoints sit in one SCC of that graph
  G-single  some rw edge (a, b) has a return path b→a in (ww ∪ wr ∪ extra)
            (reachability over the rw-free graph: condensation + bitset
            DAG closure)
  G2        some rw edge (a, b) has a return path b→a in the full graph —
            both endpoints in one SCC of it

Returns the same (flags, hints) shape as ops/closure.classify_graph so
witness recovery (host BFS) is shared.
"""

from __future__ import annotations

import numpy as np


def tarjan_scc(n: int, adj_lists) -> np.ndarray:
    """SCC id per node (iterative Tarjan). ``adj_lists[v]`` = successor
    list."""
    UNVISITED = -1
    index = np.full(n, UNVISITED, dtype=np.int64)
    low = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int64)
    stack: list[int] = []
    counter = 0
    n_comps = 0
    for root in range(n):
        if index[root] != UNVISITED:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            succs = adj_lists[v]
            for j in range(pi, len(succs)):
                w = succs[j]
                if index[w] == UNVISITED:
                    work[-1] = (v, j + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            work.pop()
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp[w] = n_comps
                    if w == v:
                        break
                n_comps += 1
            if work:
                u, _ = work[-1]
                low[u] = min(low[u], low[v])
    return comp


def _adj_lists(n: int, edges: np.ndarray):
    out: list[list[int]] = [[] for _ in range(n)]
    for a, b in edges:
        out[a].append(int(b))
    return out


def _first_edge_in_cycle(edges: np.ndarray, comp: np.ndarray):
    """(a, b) of some edge whose endpoints share an SCC (a cycle passes
    through it), else None.  Self-loops qualify."""
    if len(edges) == 0:
        return None
    same = comp[edges[:, 0]] == comp[edges[:, 1]]
    sizes = np.bincount(comp, minlength=comp.max() + 1 if len(comp) else 0)
    real = same & ((edges[:, 0] == edges[:, 1]) | (sizes[comp[edges[:, 0]]] > 1))
    idx = np.flatnonzero(real)
    if len(idx) == 0:
        return None
    a, b = edges[idx[0]]
    return int(a), int(b)


def _dag_reach_pairs(n: int, comp: np.ndarray, edges: np.ndarray, queries: np.ndarray):
    """For each query edge (a, b): is there a NONEMPTY path b→a in the
    graph?  Bitset closure over the SCC condensation (O(C·E/64)).

    Nonempty matters for self-loop queries (a == b): the dense backend's
    ``closure(wwr)[a, a]`` is true only for a real cycle through a, so a
    bare rw self-loop on an otherwise-acyclic node must NOT read as a
    return path here either (it is G2 territory, not G-single — both
    backends must agree regardless of graph size)."""
    if len(queries) == 0:
        return np.zeros(0, dtype=bool)
    C = int(comp.max()) + 1 if n else 0
    words = (C + 63) // 64
    reach = np.zeros((C, words), dtype=np.uint64)
    reach[np.arange(C), np.arange(C) // 64] |= np.uint64(1) << (
        np.arange(C) % 64
    ).astype(np.uint64)
    # A component contains a nonempty internal path between any two of its
    # nodes iff it is cyclic: size > 1, or a singleton with a self-loop.
    cyclic = np.bincount(comp, minlength=C) > 1
    if len(edges):
        self_loops = edges[edges[:, 0] == edges[:, 1], 0]
        cyclic[comp[self_loops]] = True
    cedges = np.unique(comp[edges], axis=0) if len(edges) else np.zeros((0, 2), np.int64)
    cedges = cedges[cedges[:, 0] != cedges[:, 1]]
    # Tarjan completes an SCC only after all its successors, so an SCC's
    # successors always have SMALLER ids: ascending id order visits
    # successors before their predecessors.
    by_src: list[list[int]] = [[] for _ in range(C)]
    for a, b in cedges:
        by_src[a].append(int(b))
    for c in range(C):
        for d in by_src[c]:
            reach[c] |= reach[d]
    qa, qb = comp[queries[:, 0]], comp[queries[:, 1]]
    word, bit = qa // 64, (qa % 64).astype(np.uint64)
    reach_refl = (reach[qb, word] >> bit) & np.uint64(1) > 0
    # Same component: reflexive reach is trivially true; the real question
    # is whether the component supports a nonempty return path.
    return np.where(qa == qb, cyclic[qa], reach_refl)


def _union_edges(*parts: np.ndarray) -> np.ndarray:
    """Sorted-unique union of (E, 2) edge arrays — exactly the rows
    ``np.argwhere`` would produce on the OR of the dense matrices."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.zeros((0, 2), np.int64)
    cat = np.concatenate(parts)
    return np.unique(cat, axis=0)


def classify_graph_scc(ww, wr, rw, extra, edges=None):
    """(flags, hints) — same contract as ops/closure.classify_graph, via
    sparse host algorithms.

    ``edges`` is an optional precomputed sparse view ({"ww"/"wr"/"rw"/
    "extra": (E, 2) argwhere-ordered rows} — ``TxnGraph.edge_arrays``):
    with it, classification of an n-node graph never scans the dense
    [n, n] matrices (five ``np.argwhere`` passes over a 10k-node graph's
    10^8 cells, where the edge lists hold some 37k rows)."""
    n = ww.shape[0]
    flags = {"G0": False, "G1c": False, "G-single": False, "G2": False}
    hints = {"G0": None, "G1c": None, "G-single": None, "G2": None}
    if n == 0:
        return flags, hints

    if edges is not None:
        e_ww = _union_edges(edges["ww"], edges["extra"])
        e_wr = np.asarray(edges["wr"])
        e_rw = np.asarray(edges["rw"])
        e_wwr = _union_edges(edges["ww"], edges["wr"], edges["extra"])
    else:
        e_ww = np.argwhere(ww | extra)
        e_wr = np.argwhere(wr)
        e_rw = np.argwhere(rw)
        e_wwr = np.argwhere(ww | wr | extra)

    # G0
    comp_ww = tarjan_scc(n, _adj_lists(n, e_ww))
    hit = _first_edge_in_cycle(e_ww, comp_ww)
    if hit:
        flags["G0"] = True
        hints["G0"] = (hit[0], hit[0])

    # G1c / G-single share the wwr SCCs
    comp_wwr = tarjan_scc(n, _adj_lists(n, e_wwr))
    if len(e_wr):
        same = comp_wwr[e_wr[:, 0]] == comp_wwr[e_wr[:, 1]]
        idx = np.flatnonzero(same)
        if len(idx):
            flags["G1c"] = True
            hints["G1c"] = (int(e_wr[idx[0], 0]), int(e_wr[idx[0], 1]))
    if len(e_rw):
        back = _dag_reach_pairs(n, comp_wwr, e_wwr, e_rw)
        idx = np.flatnonzero(back)
        if len(idx):
            flags["G-single"] = True
            hints["G-single"] = (int(e_rw[idx[0], 0]), int(e_rw[idx[0], 1]))

    # G2 over the full graph
    if edges is not None:
        e_all = _union_edges(e_wwr, e_rw)
    else:
        e_all = np.argwhere(ww | wr | rw | extra)
    comp_all = tarjan_scc(n, _adj_lists(n, e_all))
    if len(e_rw):
        same = comp_all[e_rw[:, 0]] == comp_all[e_rw[:, 1]]
        idx = np.flatnonzero(same)
        if len(idx):
            flags["G2"] = True
            hints["G2"] = (int(e_rw[idx[0], 0]), int(e_rw[idx[0], 1]))
    return flags, hints
