"""Consistency models: pure state machines histories are checked against.

A model's ``step(op)`` returns the successor model, or an
``Inconsistent`` describing why the op is illegal from this state.
Models are immutable and hashable: the exact sweep's configuration
dedup relies on structural equality.  The device engines use the
elementwise steps in ``jepsen_tpu_torch.models.tensor``, registered under
the same names.  This module imports no torch, because the spawned
confirmation workers unpickle these classes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar


@dataclasses.dataclass(frozen=True)
class Inconsistent:
    msg: str

    def step(self, op) -> "Inconsistent":
        return self


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(m) -> bool:
    return isinstance(m, Inconsistent)


class Model:
    """Base model protocol. Subclasses are frozen dataclasses."""

    name: ClassVar[str] = "model"

    def step(self, op) -> "Model | Inconsistent":
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Register(Model):
    """A read/write register (knossos.model/register)."""

    value: Any = None
    name: ClassVar[str] = "register"

    def step(self, op):
        f, v = op["f"], op["value"]
        if f == "write":
            return Register(v)
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v!r} from register {self.value!r}")
        raise ValueError(f"register cannot handle op f={f!r}")


@dataclasses.dataclass(frozen=True)
class CASRegister(Model):
    """A register supporting read/write/cas ops; cas value is [old, new]
    (knossos.model/cas-register)."""

    value: Any = None
    name: ClassVar[str] = "cas-register"

    def step(self, op):
        f, v = op["f"], op["value"]
        if f == "write":
            return CASRegister(v)
        if f == "cas":
            if v is None:
                return inconsistent("cas with nil value")
            old, new = v
            if old == self.value:
                return CASRegister(new)
            return inconsistent(f"can't CAS {self.value!r} from {old!r} to {new!r}")
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v!r} from register {self.value!r}")
        raise ValueError(f"cas-register cannot handle op f={f!r}")


@dataclasses.dataclass(frozen=True)
class Mutex(Model):
    """A single mutex with acquire/release (knossos.model/mutex)."""

    locked: bool = False
    name: ClassVar[str] = "mutex"

    def step(self, op):
        f = op["f"]
        if f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire a locked mutex")
            return Mutex(True)
        if f == "release":
            if not self.locked:
                return inconsistent("cannot release a free mutex")
            return Mutex(False)
        raise ValueError(f"mutex cannot handle op f={f!r}")


@dataclasses.dataclass(frozen=True)
class UnorderedQueue(Model):
    """A queue where dequeues may come back in any order
    (knossos.model/unordered-queue).  State is a multiset held as a sorted
    tuple of (value, count) pairs to stay hashable."""

    pairs: tuple = ()
    name: ClassVar[str] = "unordered-queue"

    def _counts(self) -> dict:
        return dict(self.pairs)

    @staticmethod
    def _of(counts: dict) -> "UnorderedQueue":
        return UnorderedQueue(tuple(sorted((k, v) for k, v in counts.items() if v > 0)))

    def step(self, op):
        f, v = op["f"], op["value"]
        counts = self._counts()
        if f == "enqueue":
            counts[v] = counts.get(v, 0) + 1
            return self._of(counts)
        if f == "dequeue":
            if counts.get(v, 0) > 0:
                counts[v] -= 1
                return self._of(counts)
            return inconsistent(f"can't dequeue {v!r}: not in queue")
        raise ValueError(f"unordered-queue cannot handle op f={f!r}")


@dataclasses.dataclass(frozen=True)
class FIFOQueue(Model):
    """A strictly-ordered queue (knossos.model/fifo-queue)."""

    items: tuple = ()
    name: ClassVar[str] = "fifo-queue"

    def step(self, op):
        f, v = op["f"], op["value"]
        if f == "enqueue":
            return FIFOQueue(self.items + (v,))
        if f == "dequeue":
            if not self.items:
                return inconsistent(f"can't dequeue {v!r} from empty queue")
            if self.items[0] != v:
                return inconsistent(f"expected head {self.items[0]!r}, dequeued {v!r}")
            return FIFOQueue(self.items[1:])
        raise ValueError(f"fifo-queue cannot handle op f={f!r}")


@dataclasses.dataclass(frozen=True)
class MonotonicCounter(Model):
    """A counter where reads must observe a value ≥ the last read and ≤ the
    number of completed increments — a simple model for grow-only counters."""

    value: int = 0
    name: ClassVar[str] = "counter"

    def step(self, op):
        f, v = op["f"], op["value"]
        if f == "add":
            return MonotonicCounter(self.value + v)
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v!r} from counter {self.value!r}")
        raise ValueError(f"counter cannot handle op f={f!r}")


#: Registry by name — mirrors the reference's practice of choosing models by
#: keyword in workload options.
REGISTRY = {
    "register": Register,
    "cas-register": CASRegister,
    "mutex": Mutex,
    "unordered-queue": UnorderedQueue,
    "fifo-queue": FIFOQueue,
    "counter": MonotonicCounter,
}


def model(name: str, *args, **kwargs) -> Model:
    return REGISTRY[name](*args, **kwargs)
