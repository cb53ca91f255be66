"""Independent: check a single-key workload across a whole keyspace.

The checker half of the JAX package's ``independent``, which mirrors
``jepsen.independent`` (jepsen/src/jepsen/independent.clj).
Linearizability checking is NP-hard in history length, so a workload is
sharded into many independent keys with bounded per-key op counts
(independent.clj:2-7), and the checker splits the history back out per
key (independent.clj:240-317).  A checker with ``check_batch`` (the
linearizable checker) takes every key's subhistory in one call: the
keys become the lanes of one batched ladder on the card.

Values are tagged as ``(key, value)`` tuples (the reference uses a
MapEntry, independent.clj:21-29); ``tuple_`` / ``is_tuple`` handle the
tagging.  The generator half waits for the port of the generators.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker import Checker, check_safe, merge_valid
from jepsen_tpu_torch.utils import bounded_pmap

KEY_SENTINEL = "__independent-key__"


def tuple_(key, value) -> list:
    """Tag a value with its key (independent.clj:21-25).  JSON-friendly
    lists, round-tripping through history.jsonl."""
    return [KEY_SENTINEL, key, value]


def is_tuple(v) -> bool:
    return isinstance(v, (list, tuple)) and len(v) == 3 and v[0] == KEY_SENTINEL


def tuple_key(v):
    return v[1]


def tuple_value(v):
    return v[2]


# ---------------------------------------------------------------------------
# History surgery (independent.clj:240-264)
# ---------------------------------------------------------------------------


def history_keys(history: Sequence[Mapping]) -> list:
    """Distinct keys, in order of first appearance."""
    seen = {}
    for o in history:
        v = o.get("value")
        if is_tuple(v):
            seen.setdefault(tuple_key(v), True)
    return list(seen)


def subhistory(key, history: Sequence[Mapping]) -> list[dict]:
    """Ops for one key, values untagged; non-tuple ops (e.g. nemesis) are
    kept with their value intact (independent.clj:251-264)."""
    out = []
    for o in history:
        v = o.get("value")
        if is_tuple(v):
            if tuple_key(v) == key:
                out.append({**o, "value": tuple_value(v)})
        else:
            out.append(o)
    return out


# ---------------------------------------------------------------------------
# Checker (independent.clj:266-317)
# ---------------------------------------------------------------------------


class IndependentChecker(Checker):
    """Split the history per key, run the wrapped checker on each, merge
    validity; per-key results land in ``independent/<key>/``."""

    def __init__(self, checker: Checker):
        self.checker = checker

    def check(self, test, history, opts):
        keys = history_keys(history)
        opts = dict(opts or {})

        def save_key(k, sub, res, from_batch=False):
            try:
                d = store.test_dir(test) / "independent" / str(k)
                d.mkdir(parents=True, exist_ok=True)
                store._write_json(d / "results.json", res)
                store.write_history(d, sub)
            except (KeyError, OSError, TypeError):
                return  # no store configured (bare unit tests)
            # Checkers with extra artifact output render per key too.
            # Only the batch path needs the hook: it skips the per-key
            # check(), which writes its own artifacts on the fallback path.
            if from_batch:
                write = getattr(self.checker, "write_artifacts", None)
                if write is not None:
                    write(test, res, {**opts, "subdirectory": f"independent/{k}"})

        batch = None
        if hasattr(self.checker, "check_batch"):
            # Batch-capable checkers take every per-key subhistory in one
            # call — the reference's bounded-pmap scale-out
            # (independent.clj:285-307) as the ladder's lanes.  A batch
            # failure falls back to the per-key path below so one key's
            # exception can't mask another key's real violation.
            subs = [h.index(subhistory(k, history)) for k in keys]
            try:
                batch = self.checker.check_batch(test, subs, opts)
            except Exception:  # noqa: BLE001 — per-key path isolates it
                batch = None
        if batch is not None:
            results = {}
            for k, sub, res in zip(keys, subs, batch):
                results[k] = res
                save_key(k, sub, res, from_batch=True)
        else:

            def check_key(k):
                sub = h.index(subhistory(k, history))
                sub_opts = {**opts, "subdirectory": f"independent/{k}"}
                res = check_safe(self.checker, test, sub, sub_opts)
                save_key(k, sub, res)
                return k, res

            results = dict(bounded_pmap(check_key, keys))
        valid = merge_valid([r.get("valid?") for r in results.values()] or [True])
        failures = [k for k, r in results.items() if r.get("valid?") is not True]
        return {
            "valid?": valid,
            "results": results,
            "failures": failures,
        }


def checker(inner: Checker) -> Checker:
    return IndependentChecker(inner)
