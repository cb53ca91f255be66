"""Elementwise model steps for the device engines, in torch.

The CPU models (``jepsen_tpu_torch.models``) are arbitrary Python
objects; the frontier engines need each model as an elementwise function
over packed int32 state:

    step(state, f, v1, v2) -> (state', legal)

over broadcastable int32 tensors, where ``f`` is a model-specific small
int code and ``v1``/``v2`` are the packed value columns (``history.NIL``
for absent).  State fits one int32: registers, mutex and counter
trivially, the fifo queue through a bounded packed encoding gated by a
precheck (histories outside its envelope are not tensorizable and fall
back to the CPU sweep).  Each step computes what the JAX package's
``models/tensor.py`` step of the same name computes, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from jepsen_tpu_torch.history import NIL

INT_NIL = int(NIL)


@dataclasses.dataclass(frozen=True)
class TensorModel:
    """A vectorizable model: f-code vocabulary + elementwise step fn."""

    name: str
    f_codes: dict  # f name -> small int code
    step: Callable  # (state, f, v1, v2) -> (state', legal)
    encode_state: Callable  # python model instance -> int32 initial state
    #: optional: raise ValueError when a history's ops don't fit this
    #: model's packed-state representation
    precheck: Callable | None = None


def _encode_register_state(model) -> int:
    v = getattr(model, "value", None)
    return INT_NIL if v is None else int(v)


def _register_step(state, f, v1, v2):
    """register/cas-register step. f: 0=read, 1=write, 2=cas.

    A read of NIL (value unknown) is always legal and leaves state alone;
    a read of v requires state == v.  cas [old, new] requires state == old.
    """
    is_read = f == 0
    is_write = f == 1
    is_cas = f == 2
    read_legal = (v1 == INT_NIL) | (state == v1)
    cas_legal = state == v1
    legal = torch.where(is_read, read_legal, torch.where(is_cas, cas_legal, is_write))
    state2 = torch.where(is_write, v1, torch.where(is_cas & cas_legal, v2, state))
    return state2, legal


def _plain_register_step(state, f, v1, v2):
    state2, legal = _register_step(state, f, v1, v2)
    return state2, legal & (f != 2)  # no cas on the plain register


def _mutex_step(state, f, v1, v2):
    """mutex step. f: 0=acquire, 1=release. state: 0 free, 1 locked."""
    is_acq = f == 0
    legal = torch.where(is_acq, state == 0, state == 1)
    state2 = torch.where(legal, is_acq.to(state.dtype), state)
    return state2, legal


def _counter_step(state, f, v1, v2):
    """counter step. f: 0=read, 1=add. NIL-state counters start at 0."""
    is_read = f == 0
    legal = torch.where(is_read, (v1 == INT_NIL) | (state == v1), v1 >= 0)
    state2 = torch.where(is_read, state, state + torch.where(v1 == INT_NIL, 0, v1))
    return state2, legal


def _encode_mutex_state(model) -> int:
    return 1 if getattr(model, "locked", False) else 0


def _encode_counter_state(model) -> int:
    return int(getattr(model, "value", 0) or 0)


# ---------------------------------------------------------------------------
# FIFO queue: the whole queue packed into one int32.
#
# Layout: bits [0..2] = length (0..7, so the capacity is 7); slot i
# (head = slot 0) at bits [3 + 3i .. 5 + 3i], storing value+1 (0 =
# empty).  Values 0..6; histories that can't fit (checked by
# _fifo_precheck) refuse to tensorize, so a packed-state overflow can
# never refute a valid history.
# ---------------------------------------------------------------------------

FIFO_CAP = 7
FIFO_MAX_VALUE = 6


def _fifo_step(state, f, v1, v2):
    """fifo-queue step. f: 0=enqueue, 1=dequeue (of the observed head)."""
    length = state & 7
    vals = state >> 3  # stored v+1, head in the low 3 bits
    head = vals & 7
    is_enq = f == 0
    enq_legal = (length < FIFO_CAP) & (v1 >= 0) & (v1 <= FIFO_MAX_VALUE)
    enq_vals = vals | ((v1 + 1) << (3 * length))
    enq_state = (enq_vals << 3) | (length + 1)
    deq_legal = (length > 0) & (head == v1 + 1)
    deq_state = ((vals >> 3) << 3) | torch.clamp(length - 1, min=0)
    legal = torch.where(is_enq, enq_legal, deq_legal)
    state2 = torch.where(is_enq & enq_legal, enq_state,
                         torch.where(~is_enq & deq_legal, deq_state, state))
    return state2, legal


def _encode_fifo_state(model) -> int:
    items = tuple(getattr(model, "items", ()) or ())
    if len(items) > FIFO_CAP:
        raise ValueError(f"initial queue longer than {FIFO_CAP}")
    state = len(items)
    for i, v in enumerate(items):
        if not isinstance(v, int) or not 0 <= v <= FIFO_MAX_VALUE:
            raise ValueError(f"queue value {v!r} outside 0..{FIFO_MAX_VALUE}")
        state |= (v + 1) << (3 + 3 * i)
    return state


def _fifo_precheck(model, ops):
    """Sound tensorization gate: every value must fit 0..6, and the queue
    can never need more than FIFO_CAP slots in ANY linearization —
    bounded by initial length + total enqueues."""
    items = tuple(getattr(model, "items", ()) or ())
    enqueues = 0
    for op in ops:
        v = op.get("value")
        if not isinstance(v, int) or isinstance(v, bool) or not 0 <= v <= FIFO_MAX_VALUE:
            raise ValueError(f"queue value {v!r} outside 0..{FIFO_MAX_VALUE}")
        if op["f"] == "enqueue":
            enqueues += 1
    if len(items) + enqueues > FIFO_CAP:
        raise ValueError(
            f"{len(items)} initial + {enqueues} enqueued items exceed the "
            f"packed capacity {FIFO_CAP}"
        )


REGISTRY = {
    "cas-register": TensorModel(
        "cas-register",
        {"read": 0, "write": 1, "cas": 2},
        _register_step,
        _encode_register_state,
    ),
    "register": TensorModel(
        "register",
        {"read": 0, "write": 1},
        _plain_register_step,
        _encode_register_state,
    ),
    "mutex": TensorModel(
        "mutex", {"acquire": 0, "release": 1}, _mutex_step, _encode_mutex_state
    ),
    "counter": TensorModel(
        "counter", {"read": 0, "add": 1}, _counter_step, _encode_counter_state
    ),
    "fifo-queue": TensorModel(
        "fifo-queue",
        {"enqueue": 0, "dequeue": 1},
        _fifo_step,
        _encode_fifo_state,
        precheck=_fifo_precheck,
    ),
}


def tensor_model_for(model) -> TensorModel | None:
    return REGISTRY.get(getattr(model, "name", None))
