"""Transaction micro-op utilities.

A *transaction* op is a history op whose ``value`` is a list of micro-ops
(mops), each ``[f, k, v]`` — e.g. ``["r", "x", [1, 2]]`` or
``["append", "x", 3]``.  Mirrors the reference's vendored ``jepsen.txn``
library (txn/src/jepsen/txn.clj) which backs the Elle-style workloads.
The port's copy of the JAX package's ``txn``.

Mops are plain 3-element lists/tuples; accessors below mirror
``jepsen.txn.micro-op``.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Iterable, Iterator, Sequence

# ---------------------------------------------------------------------------
# Micro-op accessors (jepsen.txn.micro-op)
# ---------------------------------------------------------------------------


def mop_f(mop) -> Any:
    """The function of a micro-op: "r", "w", "append", ..."""
    return mop[0]


def mop_key(mop) -> Any:
    return mop[1]


def mop_value(mop) -> Any:
    return mop[2]


def is_read(mop) -> bool:
    return mop[0] == "r"


def is_write(mop) -> bool:
    return mop[0] != "r"


# ---------------------------------------------------------------------------
# Transaction folds (txn/src/jepsen/txn.clj:5-76)
# ---------------------------------------------------------------------------


def reduce_mops(f: Callable, init, history: Iterable[dict]):
    """Fold ``f(state, op, mop)`` over every micro-op of every op in history
    (txn.clj:5-17)."""
    state = init
    for op in history:
        for mop in op["value"] or ():
            state = f(state, op, mop)
    return state


def op_mops(history: Iterable[dict]) -> Iterator[tuple[dict, Sequence]]:
    """All (op, mop) pairs from a history (txn.clj:19-23)."""
    for op in history:
        for mop in op["value"] or ():
            yield op, mop


def ext_reads(txn: Sequence) -> dict:
    """Keys → values this transaction *externally* read: observed values it
    did not itself write earlier in the txn (txn.clj:25-41)."""
    ext: dict = {}
    ignore: set = set()
    for mop in txn:
        f, k, v = mop[0], mop[1], mop[2]
        if f == "r" and k not in ignore:
            ext[k] = v
        ignore.add(k)
    return ext


def ext_writes(txn: Sequence) -> dict:
    """Keys → final values written by this transaction (txn.clj:43-54)."""
    ext: dict = {}
    for mop in txn:
        if mop[0] != "r":
            ext[mop[1]] = mop[2]
    return ext


def int_write_mops(txn: Sequence) -> dict:
    """Keys → list of *non-final* write mops to that key (txn.clj:56-76).
    These are the writes whose observation constitutes a G1b intermediate
    read."""
    writes: dict = {}
    for mop in txn:
        if mop[0] != "r":
            writes.setdefault(mop[1], []).append(list(mop))
    return {k: vs[:-1] for k, vs in writes.items() if len(vs) > 1}


# ---------------------------------------------------------------------------
# Transaction generators (mirroring elle's gen / wr-txns defaults, which the
# reference re-exports at tests/cycle/append.clj:24-28)
# ---------------------------------------------------------------------------


def wr_txns(
    rng: random.Random,
    key_count: int = 2,
    min_txn_length: int = 1,
    max_txn_length: int = 2,
    max_writes_per_key: int = 32,
) -> Iterator[list]:
    """Infinite stream of write/read transactions over a sliding window of
    integer keys, with globally unique writes per key.  Mirrors elle's
    ``wr-txns`` defaults (key-count 2, txn length 1-2, max-writes-per-key
    32)."""
    active = list(range(key_count))
    next_key = key_count
    writes: dict[int, int] = {}
    while True:
        length = rng.randint(min_txn_length, max_txn_length)
        txn = []
        for _ in range(length):
            k = rng.choice(active)
            if rng.random() < 0.5:
                txn.append(["r", k, None])
            else:
                w = writes.get(k, 0) + 1
                if w > max_writes_per_key:
                    # Retire this key, open a fresh one.
                    active[active.index(k)] = next_key
                    k = next_key
                    next_key += 1
                    w = 1
                writes[k] = w
                txn.append(["w", k, w])
        yield txn


def append_txns(
    rng: random.Random,
    key_count: int = 2,
    min_txn_length: int = 1,
    max_txn_length: int = 2,
    max_writes_per_key: int = 32,
) -> Iterator[list]:
    """Like :func:`wr_txns` but writes are ``append`` mops (elle
    list-append generator semantics)."""
    for txn in wr_txns(rng, key_count, min_txn_length, max_txn_length, max_writes_per_key):
        yield [["append", k, v] if f == "w" else [f, k, v] for f, k, v in txn]
