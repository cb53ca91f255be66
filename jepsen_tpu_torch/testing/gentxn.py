"""Synthetic list-append transaction histories (BASELINE config 3's
shape: cockroach-style multi-key append workloads, 10k transactions).

Serializable by construction: transactions execute atomically in
history order (the server applies each at a point inside its window),
so the dependency graph is acyclic unless ``corrupt_wr`` injects an
anomaly.  The same seed gives the same history as the JAX package's
``tools/gentxn.py``.
"""

from __future__ import annotations

import random

from jepsen_tpu_torch import history as h


def append_history(
    n_txns: int,
    n_keys: int = 50,
    n_procs: int = 16,
    mops_per_txn: tuple = (1, 4),
    read_frac: float = 0.5,
    seed: int = 1,
) -> list[dict]:
    rng = random.Random(seed)
    state: dict = {k: [] for k in range(n_keys)}
    next_el: dict = {k: 0 for k in range(n_keys)}
    hist: list[dict] = []
    t = 0
    for _ in range(n_txns):
        p = rng.randrange(n_procs)
        n_mops = rng.randint(*mops_per_txn)
        keys = rng.sample(range(n_keys), min(n_mops, n_keys))
        mops = []
        for k in keys:
            if rng.random() < read_frac:
                mops.append(["r", k, None])
            else:
                mops.append(["append", k, next_el[k]])
                next_el[k] += 1
        t += rng.randint(1, 5)
        invoke_mops = [list(m) for m in mops]
        hist.append(h.op(h.INVOKE, p, "txn", invoke_mops, time=t))
        done = []
        for f, k, v in mops:
            if f == "r":
                done.append(["r", k, list(state[k])])
            else:
                state[k].append(v)
                done.append(["append", k, v])
        t += rng.randint(1, 5)
        hist.append(h.op(h.OK, p, "txn", done, time=t))
    return h.index(hist)


def corrupt_wr(history: list[dict], seed: int = 2) -> list[dict]:
    """Swap the last two elements of one read's list, injecting an
    incompatible-order / cycle anomaly."""
    rng = random.Random(seed)
    hist = [dict(o) for o in history]
    # find a read whose list has ≥2 elements and reverse its tail pair
    candidates = []
    for i, o in enumerate(hist):
        if o["type"] != h.OK:
            continue
        for m in o["value"]:
            if m[0] == "r" and isinstance(m[2], list) and len(m[2]) >= 2:
                candidates.append(i)
                break
    if not candidates:
        return hist
    i = rng.choice(candidates)
    o = hist[i]
    val = [list(m) for m in o["value"]]
    for m in val:
        if m[0] == "r" and isinstance(m[2], list) and len(m[2]) >= 2:
            m[2] = list(m[2])
            m[2][-1], m[2][-2] = m[2][-2], m[2][-1]
            break
    hist[i] = {**o, "value": val}
    return hist


def tarjan_has_cycle(n: int, edges) -> bool:
    """Iterative Tarjan SCC over an edge list: the elle-JVM-style CPU
    oracle for cycle existence (O(V+E))."""
    adj: list[list[int]] = [[] for _ in range(n)]
    for a, b in edges:
        adj[a].append(b)
    index = [0] * n
    low = [0] * n
    state = [0] * n  # 0 unvisited, 1 on stack, 2 done
    counter = [1]
    stack: list[int] = []
    for root in range(n):
        if state[root]:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                state[v] = 1
                stack.append(v)
            advanced = False
            for j in range(pi, len(adj[v])):
                w = adj[v][j]
                if state[w] == 0:
                    work[-1] = (v, j + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if state[w] == 1:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                size = 0
                while True:
                    w = stack.pop()
                    state[w] = 2
                    size += 1
                    if w == v:
                        break
                if size > 1:
                    return True
            if work:
                u, _ = work[-1]
                low[u] = min(low[u], low[v])
    # self-loops
    for a, b in edges:
        if a == b:
            return True
    return False
