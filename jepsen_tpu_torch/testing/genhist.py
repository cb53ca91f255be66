"""Synthetic history generators for the smoke run and the tests.

Simulates a linearizable register serving concurrent clients (the server
applies each op atomically at a point inside its invocation window),
with a configurable fraction of indeterminate (:info) completions whose
effects may or may not land: histories that are linearizable by
construction, plus ``corrupt`` to produce invalid ones.  The same seed
gives the same history as the JAX package's ``tools/genhist.py``.
"""

from __future__ import annotations

import random

from jepsen_tpu_torch import history as h


def valid_register_history(
    n_ops: int,
    n_procs: int,
    seed: int = 1,
    info_rate: float = 0.05,
    n_values: int = 5,
    fs=("read", "write", "cas"),
) -> list[dict]:
    rng = random.Random(seed)
    hist: list[dict] = []
    state = None
    live: dict[int, dict] = {}
    invoked = 0
    t = 0
    while invoked < n_ops or live:
        t += 1
        can_invoke = [p for p in range(n_procs) if p not in live]
        if can_invoke and invoked < n_ops and (not live or rng.random() < 0.6):
            p = rng.choice(can_invoke)
            f = rng.choice(fs)
            if f == "read":
                v = None
            elif f == "write":
                v = rng.randrange(n_values)
            else:
                old = state if state is not None and rng.random() < 0.7 else rng.randrange(n_values)
                v = [old, rng.randrange(n_values)]
            live[p] = h.op(h.INVOKE, p, f, v, time=t)
            hist.append(live[p])
            invoked += 1
        else:
            p = rng.choice(list(live))
            inv = live.pop(p)
            f, v = inv["f"], inv["value"]
            if rng.random() < info_rate:
                o = h.op(h.INFO, p, f, v, time=t)
                if rng.random() < 0.5:  # effect may have landed anyway
                    if f == "write":
                        state = v
                    elif f == "cas" and state == v[0]:
                        state = v[1]
            elif f == "read":
                o = h.op(h.OK, p, "read", state, time=t)
            elif f == "write":
                state = v
                o = h.op(h.OK, p, "write", v, time=t)
            else:
                ok = state == v[0]
                if ok:
                    state = v[1]
                o = h.op(h.OK if ok else h.FAIL, p, "cas", v, time=t)
            hist.append(o)
    return h.index(hist)


def corrupt(history: list[dict], seed: int = 2, n_flips: int = 1) -> list[dict]:
    """Perturb ok-read values to (very likely) break linearizability."""
    rng = random.Random(seed)
    hist = [dict(o) for o in history]
    reads = [i for i, o in enumerate(hist) if o["type"] == h.OK and o["f"] == "read" and o["value"] is not None]
    for i in rng.sample(reads, min(n_flips, len(reads))):
        hist[i]["value"] = hist[i]["value"] + 1000
    return h.index(hist)
