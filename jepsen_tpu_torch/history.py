"""Operation histories: the subset of the reference's history module that
packing and the exact sweep use (op records, predicates, pairing, value
encoding).

A history is an ordered list of op dicts with keys ``type process f
value time`` (plus ``index``).  Op types: ``invoke``; ``ok`` (definitely
happened); ``fail`` (definitely did not); ``info`` (indeterminate: may
take effect at any later time, so it stays concurrent with the rest of
the history).  Client processes are integers; anything else (the
nemesis) is not a client.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

#: The nemesis's process, which is not a client.
NEMESIS = "nemesis"

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
    (ops already carrying their position keep their identity)."""
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
