"""Checker framework: validates a history against a consistency claim.

The port's copy of the JAX package's checker protocol, which mirrors
``jepsen.checker`` (jepsen/src/jepsen/checker.clj:52-116): a checker's
``check(test, history, opts)`` returns a result dict with at least
``"valid?"`` ∈ {True, False, "unknown"}; ``check_safe`` converts
exceptions into ``"unknown"`` results; ``compose`` runs a map of
checkers in parallel and merges validity with false > unknown > true
priority (checker.clj:29-50).

The device checkers (``checker.linearizable``, ``independent.checker``)
and the Elle checkers (``checker.elle``) implement the same protocol.
This package's ``__init__`` imports no torch: the spawned confirmation
workers import ``checker.wgl_cpu`` through it.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Mapping, Sequence

from jepsen_tpu_torch import faults
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.utils import bounded_pmap

UNKNOWN = "unknown"

#: checker.clj:29-34 — larger numbers dominate when composing.
VALID_PRIORITIES = {True: 0, False: 1, UNKNOWN: 0.5}


def merge_valid(valids) -> Any:
    """Merge validity verdicts, highest priority wins (checker.clj:36-50)."""
    result = True
    for v in valids:
        if v not in VALID_PRIORITIES:
            raise ValueError(f"{v!r} is not a known valid? value")
        if VALID_PRIORITIES[v] > VALID_PRIORITIES[result]:
            result = v
    return result


class Checker:
    """Base checker protocol (checker.clj:52-67).

    ``opts`` keys include ``subdirectory`` — a directory within the test's
    store directory for output files.
    """

    def check(self, test: Mapping, history: Sequence[dict], opts: Mapping) -> dict | None:
        raise NotImplementedError

    def __call__(self, test, history, opts=None):
        return self.check(test, history, opts or {})


class FnChecker(Checker):
    """Adapt a plain function ``(test, history, opts) -> result`` to Checker."""

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn-checker")

    def check(self, test, history, opts):
        return self.fn(test, history, opts)

    def __repr__(self):
        return f"FnChecker({self.name})"


def checker(fn: Callable) -> Checker:
    """Decorator form of FnChecker."""
    return FnChecker(fn)


def checker_name(chk: Checker) -> str:
    """A human-attributable name for a checker: its ``name`` attribute
    (FnChecker, or anything that sets one) else the class name."""
    n = getattr(chk, "name", None)
    if n:
        return str(n)
    return type(chk).__name__


def resolve_opts(opts: Mapping | None) -> dict:
    """Normalize checker opts for the deadline keys: a raw
    ``"check-deadline"`` seconds value is wrapped once into a shared
    ``faults.Deadline`` under ``"deadline"`` (Compose normalizes before
    fanning out, so every composed checker sees one budget).  An unset
    deadline stays None."""
    opts = dict(opts or {})
    if opts.get("deadline") is None and opts.get("check-deadline") is not None:
        opts["deadline"] = faults.Deadline(float(opts["check-deadline"]))
    else:
        opts["deadline"] = faults.Deadline.coerce(opts.get("deadline"))
    return opts


def check_safe(chk: Checker, test, history, opts=None, name: str | None = None) -> dict:
    """check, but exceptions become ``{"valid?": "unknown", "error": ...}``
    (checker.clj:74-85).

    The failure names which checker raised (``"checker"`` key; ``name``
    lets Compose pass the map key the caller knows the checker by), so
    composed results stay attributable, and each check emits a
    ``checker.check`` span with the checker's name and verdict.  Opts
    are normalized through ``resolve_opts``, so a ``"check-deadline"``
    budget reaches the checker as a live ``"deadline"``."""
    name = name or checker_name(chk)
    opts = resolve_opts(opts)
    with obs.span("checker.check", checker=name) as sp:
        try:
            result = chk.check(test, history, opts)
            if result is None:
                result = {"valid?": True}
        except Exception:  # noqa: BLE001 - contract: never propagate
            obs.counter("checker.errors", checker=name)
            result = {
                "valid?": UNKNOWN,
                "checker": name,
                "error": traceback.format_exc(),
            }
        sp.set(valid=result.get("valid?"))
    return result


class Noop(Checker):
    """Empty checker returning nothing (checker.clj:68-72)."""

    def check(self, test, history, opts):
        return None


def noop() -> Checker:
    return Noop()


class UnbridledOptimism(Checker):
    """Everything is awesome (checker.clj:118-122)."""

    def check(self, test, history, opts):
        return {"valid?": True}


def unbridled_optimism() -> Checker:
    return UnbridledOptimism()


class Compose(Checker):
    """Run named checkers (in parallel) and merge results (checker.clj:87-99)."""

    def __init__(self, checker_map: Mapping[str, Checker]):
        self.checker_map = dict(checker_map)

    def check(self, test, history, opts):
        items = list(self.checker_map.items())
        # normalize once so every composed checker shares one deadline
        opts = resolve_opts(opts)
        results = bounded_pmap(
            lambda kv: (kv[0], check_safe(kv[1], test, history, opts, name=kv[0])),
            items,
        )
        out = dict(results)
        out["valid?"] = merge_valid(r["valid?"] for _, r in results)
        return out


def compose(checker_map: Mapping[str, Checker]) -> Checker:
    return Compose(checker_map)


class ConcurrencyLimit(Checker):
    """Bound concurrent executions of a memory-hungry checker
    (checker.clj:101-116)."""

    def __init__(self, limit: int, chk: Checker):
        self.sem = threading.Semaphore(limit)
        self.chk = chk

    def check(self, test, history, opts):
        with self.sem:
            return self.chk.check(test, history, opts)


def concurrency_limit(limit: int, chk: Checker) -> Checker:
    return ConcurrencyLimit(limit, chk)


# ---------------------------------------------------------------------------
# Stats & exceptions
# ---------------------------------------------------------------------------


def _stats_of(history) -> dict:
    """Counts for one (sub)history (checker.clj:153-164)."""
    ok = sum(1 for o in history if h.is_ok(o))
    fail = sum(1 for o in history if h.is_fail(o))
    info = sum(1 for o in history if h.is_info(o))
    return {
        "valid?": ok > 0,
        "count": ok + fail + info,
        "ok-count": ok,
        "fail-count": fail,
        "info-count": info,
    }


class Stats(Checker):
    """Success/failure rates overall and by :f; valid iff every f has some ok
    ops (checker.clj:166-183)."""

    def check(self, test, history, opts):
        completions = [o for o in history if not h.is_invoke(o) and o["process"] != h.NEMESIS]
        by_f: dict[Any, dict] = {}
        for f in sorted({o["f"] for o in completions}, key=str):
            by_f[f] = _stats_of([o for o in completions if o["f"] == f])
        out = _stats_of(completions)
        out["by-f"] = by_f
        out["valid?"] = merge_valid(g["valid?"] for g in by_f.values())
        return out


def stats() -> Checker:
    return Stats()


class UnhandledExceptions(Checker):
    """Descending-frequency summary of exceptions embedded in :info ops
    (checker.clj:124-151).  Ops carry exceptions as an ``exception`` key —
    either an Exception instance or a dict with a ``class`` key."""

    @staticmethod
    def _class_of(e) -> str:
        if isinstance(e, BaseException):
            return type(e).__name__
        if isinstance(e, Mapping):
            return str(e.get("class", "unknown"))
        return str(type(e).__name__)

    def check(self, test, history, opts):
        groups: dict[str, list] = {}
        for o in history:
            if h.is_info(o) and o.get("exception") is not None:
                groups.setdefault(self._class_of(o["exception"]), []).append(o)
        exes = [
            {"count": len(ops), "class": cls, "example": ops[0]}
            for cls, ops in sorted(groups.items(), key=lambda kv: -len(kv[1]))
        ]
        return {"valid?": True, "exceptions": exes} if exes else {"valid?": True}


def unhandled_exceptions() -> Checker:
    return UnhandledExceptions()
