"""Operation histories: the subset of the reference's history module that
packing, the exact sweep and the Elle checkers use (op records,
predicates, pairing, value encoding, and ``ColumnHistory``, a stored
history as lazy ops over its columns).

A history is an ordered list of op dicts with keys ``type process f
value time`` (plus ``index``).  Op types: ``invoke``; ``ok`` (definitely
happened); ``fail`` (definitely did not); ``info`` (indeterminate: may
take effect at any later time, so it stays concurrent with the rest of
the history).  Client processes are integers; anything else (the
nemesis) is not a client.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any

import numpy as np

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

#: The nemesis's process, which is not a client.
NEMESIS = "nemesis"

#: Packed codes for op types, and the nemesis's packed process id.
TYPE_CODES = {INVOKE: 0, OK: 1, FAIL: 2, INFO: 3}
NEMESIS_PID = np.int32(-1)

#: Packed int32 for "no value" (nil), far outside any realistic register
#: value so the model steps can branch on it.
NIL = np.int32(np.iinfo(np.int32).min)
#: Packed int32 "no partner" marker in pair indices.
NO_PAIR = np.int32(-1)


def op(type: str, process, f, value=None, time: int | None = None, **extra):
    """Construct an op dict."""
    o = {"type": type, "process": process, "f": f, "value": value}
    if time is not None:
        o["time"] = time
    o.update(extra)
    return o


def is_invoke(o) -> bool:
    return o["type"] == INVOKE


def is_ok(o) -> bool:
    return o["type"] == OK


def is_fail(o) -> bool:
    return o["type"] == FAIL


def is_info(o) -> bool:
    return o["type"] == INFO


def is_client_op(o) -> bool:
    """True iff the op was performed by a client process (an integer),
    not the nemesis."""
    return isinstance(o["process"], int)


def index(history: Sequence[dict]) -> list[dict]:
    """Add a monotone ``index`` key to each op, returning a new list
    (ops already carrying their position keep their identity).  A
    positional ``ColumnHistory`` is already indexed and passes through
    untouched (no op dict is built)."""
    if isinstance(history, ColumnHistory) and history.positional():
        return history
    out = []
    for i, o in enumerate(history):
        if o.get("index") != i:
            o = {**o, "index": i}
        out.append(o)
    return out


def pair_index(history: Sequence[dict]) -> np.ndarray:
    """``pair[i]`` = index of op i's invoke/completion partner, or
    NO_PAIR.  An invoke by process p pairs with the next non-invoke op
    by p."""
    n = len(history)
    pair = np.full(n, NO_PAIR, dtype=np.int32)
    open_by_process: dict[Any, int] = {}
    for i, o in enumerate(history):
        p = o["process"]
        if is_invoke(o):
            open_by_process[p] = i
        else:
            j = open_by_process.pop(p, None)
            if j is not None:
                pair[j] = i
                pair[i] = j
    return pair


def encode_register_value(f, value) -> tuple[int, int]:
    """Value encoder for register-family workloads: read/write values are
    ints (None -> NIL); cas carries ``[old, new]``.  Returns the ``(v1,
    v2)`` int pair of the packed columns."""
    if value is None:
        return int(NIL), int(NIL)
    if isinstance(value, (list, tuple)):
        a = int(NIL) if value[0] is None else int(value[0])
        b = int(NIL) if len(value) < 2 or value[1] is None else int(value[1])
        return a, b
    if isinstance(value, (int, np.integer)):
        return int(value), int(NIL)
    raise TypeError(f"register value encoder can't pack {value!r}")


def decode_register_value(f, v1: int, v2: int):
    """Inverse of ``encode_register_value``."""
    if v1 == NIL and v2 == NIL:
        return None
    if v2 == NIL:
        return int(v1)
    return [None if v1 == NIL else int(v1), None if v2 == NIL else int(v2)]


class ColumnHistory(Sequence):
    """A stored history as lazy ops over its columns.

    ``cols`` holds int64 columns (``index``, ``type``, ``process``,
    ``f``, ``value1``, ``value2``, ``time``); ``fs`` names the f codes
    and ``extras`` maps an op's position to the keys its columns cannot
    hold (a non-register value, a non-int process).  Checkers that
    iterate ops get dicts built one at a time on access; the Elle
    column engine reads ``cols`` and ``extras`` directly.  Positions
    double as indices, so ``index()`` passes a positional one through.
    """

    _TYPE_NAMES = (INVOKE, OK, FAIL, INFO)

    def __init__(self, cols: Mapping, fs: Sequence[str], extras: Mapping):
        self.cols = cols
        self.fs = list(fs)
        self.extras = dict(extras)
        self._py: dict | None = None  # plain-int column cache, built lazily
        self._ops: list | None = None  # memoized op dicts (one build each)
        self._complete = False  # _ops fully materialized?

    def __len__(self) -> int:
        return len(self.cols["index"])

    def _pycols(self) -> dict:
        # one tolist() per column on first access: per-op numpy scalar
        # conversions would otherwise dominate
        if self._py is None:
            self._py = {k: v.tolist() for k, v in self.cols.items()}
        return self._py

    def _op(self, i: int) -> dict:
        c = self._pycols()
        extra = self.extras.get(i, {})
        if "value" in extra:
            value = extra["value"]
        else:
            value = decode_register_value(None, c["value1"][i], c["value2"][i])
            if extra.get("value-tuple?") and isinstance(value, list):
                value = tuple(value)
        p = c["process"][i]
        op = {
            "index": c["index"][i],
            "type": extra.get("type", self._TYPE_NAMES[c["type"][i]]),
            "process": extra.get("process", NEMESIS if p == -1 else p),
            "f": self.fs[c["f"][i]],
            "value": value,
            "time": c["time"][i],
        }
        for k, v in extra.items():
            if k not in ("value", "value-tuple?", "type", "process"):
                op[k] = v
        return op

    def __getitem__(self, i):
        if self._ops is None:
            self._ops = [None] * len(self)
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        op = self._ops[i]
        if op is None:
            op = self._ops[i] = self._op(i)
        return op

    def __iter__(self):
        # a full scan materializes in one batch: per-access laziness
        # costs more than the loop
        yield from self.materialized()

    def materialized(self) -> list:
        """All ops as dicts, built once and memoized (ops already built
        by ``__getitem__`` keep their identity)."""
        if not self._complete:
            prior = self._ops
            self._ops = [
                (prior[i] if prior is not None and prior[i] is not None else self._op(i))
                for i in range(len(self))
            ]
            self._complete = True
        return self._ops

    def positional(self) -> bool:
        """True when stored indices equal positions (an indexed history)."""
        idx = self.cols["index"]
        return bool((idx == np.arange(len(idx))).all())

    def __eq__(self, other):
        if other is self:
            return True
        try:
            n = len(other)
        except TypeError:
            return NotImplemented
        return n == len(self) and all(a == b for a, b in zip(self, other))

    def __repr__(self) -> str:
        return f"ColumnHistory({len(self)} ops)"


def materialize(history):
    """A plain-list view of a history: a ``ColumnHistory`` materializes
    once (memoized); anything else passes through."""
    if isinstance(history, ColumnHistory):
        return history.materialized()
    return history
