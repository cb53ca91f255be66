"""CPU linearizability checkers (Wing–Gong–Lowe family): the oracles of
the device engines.

A copy of the JAX package's ``checker/wgl_cpu``, so that the port and
its spawned confirmation workers never import ``jepsen_tpu``.  Pure
Python: no torch, no numpy arrays on the hot path.  Three engines over
the same prepared event stream:

  * ``dfs_analysis`` — depth-first search with a visited-set cache
    (knossos's WGL; the "wgl" algorithm and the default ``analysis``);
  * ``sweep_analysis`` — the configuration-set sweep with domination
    pruning, the algorithm the device engines vectorize, which confirms
    their refutations;
  * ``brute_analysis`` — every linearization order of a tiny history,
    for validating the other two.

``greedy_walk`` is the one-config walk (returning op first, never
back): True is a constructive witness, and ``record=`` receives it.

Op semantics (knossos convention):

  * ``ok``   — definitely happened; must linearize between call and return;
  * ``fail`` — definitely did not happen; removed from the search entirely;
  * ``info`` — indeterminate; may linearize anywhere after its call, or
    never: it stays open forever;
  * crashed ops whose ``f`` is pure (state-preserving, e.g. reads) are
    dropped: linearizing them never changes any state.

Crashed ops are canonicalized into (f, value) groups tracked as fired
counts, and linearization points are chosen only at return barriers
(both shared with the device engines).  The searches answer
``"unknown"`` on budget exhaustion, never a wrong verdict.
"""

from __future__ import annotations

import bisect
from typing import Any, Sequence

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import models as m
from jepsen_tpu_torch import obs

#: fs that never change model state; crashed ops with these fs are dropped.
PURE_FS = {
    "register": {"read"},
    "cas-register": {"read"},
    "counter": {"read"},
}

CALL = 0
RET = 1


def _canon_value(v) -> Any:
    return tuple(v) if isinstance(v, list) else v


def prepare(model: m.Model, history: Sequence[dict]):
    """Reduce a history to the event stream the searches consume.

    Returns ``(events, eff_ops, crashed)``: events are ``(kind, op_index)``
    pairs in true history order; ``eff_ops[i]`` is the *effective* op for
    model stepping — the invoke op carrying its completion's value when the
    completion is ok (knossos.history/complete semantics: reads invoke with
    nil and learn their value on completion); ``crashed`` is the set of op
    ids that never definitely completed.
    """
    pairs = h.pair_index(history)
    pure = PURE_FS.get(getattr(model, "name", None), set())
    order: list[tuple[int, int, int]] = []  # (history position, kind, op id)
    eff_ops: dict[int, dict] = {}
    crashed: set[int] = set()
    for i, op in enumerate(history):
        if not h.is_invoke(op) or not h.is_client_op(op):
            continue
        j = int(pairs[i])
        completion = history[j] if j != -1 else None
        ctype = completion["type"] if completion is not None else h.INFO
        if ctype == h.FAIL:
            continue  # definitely didn't happen
        if ctype == h.INFO and op["f"] in pure:
            continue  # crashed pure op can never matter
        eff = op
        if ctype == h.OK and completion.get("value") is not None and op.get("value") != completion["value"]:
            eff = {**op, "value": completion["value"]}
        eff_ops[i] = eff
        order.append((i, CALL, i))
        if ctype == h.OK:
            order.append((j, RET, i))
        else:
            crashed.add(i)
    order.sort()
    return [(kind, i) for _, kind, i in order], eff_ops, crashed


def _barrier_snapshots(events, eff_ops, crashed):
    """For each return event, snapshot the open ok ops and open crashed
    group counts at that point.  Returns (barriers, group_ops) where
    barriers is a list of (event_pos, op_id, open_ok tuple, open_crashed
    tuple of ((f, value), count)) and group_ops maps group -> effective op.

    ``open_ok`` stays sorted by construction (CALL events arrive in
    position order and an op's id is its invoke position); group tuples
    use stable insertion order (consumers key groups through their own
    index maps)."""
    open_ok: list[int] = []
    open_crashed: dict[tuple, int] = {}
    group_ops: dict[tuple, dict] = {}
    barriers = []
    for pos, (kind, i) in enumerate(events):
        if kind == CALL:
            if i in crashed:
                g = (eff_ops[i]["f"], _canon_value(eff_ops[i]["value"]))
                open_crashed[g] = open_crashed.get(g, 0) + 1
                group_ops[g] = eff_ops[i]
            else:
                open_ok.append(i)  # monotone: sorted by construction
        else:
            barriers.append(
                (pos, i, tuple(open_ok), tuple(open_crashed.items()))
            )
            k = bisect.bisect_left(open_ok, i)
            if k < len(open_ok) and open_ok[k] == i:
                del open_ok[k]
    return barriers, group_ops


# ---------------------------------------------------------------------------
# DFS engine (knossos-equivalent)
# ---------------------------------------------------------------------------


def dfs_analysis(
    model: m.Model,
    history: Sequence[dict],
    max_visited: int = 5_000_000,
) -> dict:
    """Decide linearizability by depth-first search over configurations.

    A node is ``(barrier_index, state, fired_ok, fired_crashed)``.  At each
    barrier the returning op must be fired; if it already is, we advance
    (barrier compression); otherwise we branch over firing any available
    open op, greedy-first.  A visited cache makes re-exploration O(1).

    Returns knossos-shaped maps: ``{"valid?": True}``, or ``{"valid?":
    False, "op": ..., "configs": [...]}`` with the furthest barrier op
    reached, or ``{"valid?": "unknown", "cause": ...}`` past the node
    budget.
    """
    with obs.span("wgl_cpu.dfs") as sp:
        stats: dict = {}
        out = _dfs_analysis(model, history, max_visited, stats)
        sp.set(valid=out.get("valid?"), **stats)
        return out


def _dfs_analysis(model, history, max_visited, stats: dict) -> dict:
    events, eff_ops, crashed = prepare(model, history)
    barriers, group_ops = _barrier_snapshots(events, eff_ops, crashed)
    n_barriers = len(barriers)
    if n_barriers == 0:
        return {"valid?": True, "configs": [{"model": model}]}

    # Fired-crash multisets as fixed-vocabulary count tuples (same form
    # as the sweep).
    groups, gidx, group_op_list, empty = _group_vocab(group_ops)
    max_visited = _g_scaled(max_visited, len(groups))
    start = (0, model, frozenset(), empty)
    stack = [start]
    visited = {start}
    deepest = 0
    deepest_sample: list = []

    while stack:
        b, state, fok, fcr = stack.pop()
        if b >= n_barriers:
            stats.update(visited=len(visited), barriers=n_barriers)
            return {"valid?": True, "configs": [{"model": state}]}
        if b > deepest:
            deepest = b
            deepest_sample = [(state, fok, fcr)]
        _pos, i, open_ok, open_crashed = barriers[b]

        if i in fok:
            # Barrier satisfied: strip i and advance.
            nxt = (b + 1, state, fok - {i}, fcr)
            if nxt not in visited:
                visited.add(nxt)
                stack.append(nxt)
            continue

        succs = []
        # Fire another open ok op (enabling move).
        for j in open_ok:
            if j in fok or j == i:
                continue
            s2 = state.step(eff_ops[j])
            if not m.is_inconsistent(s2):
                succs.append((b, s2, fok | {j}, fcr))
        # Fire one crashed op from an available group.
        for g, open_count in open_crashed:
            gi = gidx[g]
            if fcr[gi] >= open_count:
                continue
            s2 = state.step(group_op_list[gi])
            if not m.is_inconsistent(s2):
                fcr2 = fcr[:gi] + (fcr[gi] + 1,) + fcr[gi + 1 :]
                succs.append((b, s2, fok, fcr2))
        # Fire the returning op itself — pushed last so DFS tries it first.
        s2 = state.step(eff_ops[i])
        if not m.is_inconsistent(s2):
            succs.append((b, s2, fok | {i}, fcr))

        for nxt in succs:
            if nxt not in visited:
                visited.add(nxt)
                stack.append(nxt)
        if len(visited) > max_visited:
            stats.update(visited=len(visited), barriers=n_barriers, deepest=deepest)
            return {
                "valid?": "unknown",
                "cause": f"visited more than {max_visited} configurations",
                "op": history[barriers[deepest][1]],
            }

    stats.update(visited=len(visited), barriers=n_barriers, deepest=deepest)
    return {
        "valid?": False,
        "op": history[barriers[deepest][1]],
        "configs": [
            {"model": st, "pending": sorted(set(barriers[deepest][2]) - fok)}
            for st, fok, fcr in deepest_sample[:10]
        ],
    }


def greedy_walk(model: m.Model, history: Sequence[dict],
                max_steps: int | None = None,
                record: list | None = None) -> bool | None:
    """Speculative single-config greedy walk (one beam lane, returning op
    first, no backtracking).  Returns ``True`` when the walk completes:
    that is a full linearization, a constructive witness, so the verdict
    is exact.  Returns ``None`` when the walk sticks (no greedy-consistent
    move, or ``max_steps`` fired): a stuck walk never refutes, because
    only search proves the absence of witnesses.

    ``record``, when given, receives the fired *effective* ops in fire
    order: on a ``True`` return it is the full linearization, the witness
    ``obs.provenance`` puts in evidence bundles.
    """
    events, eff_ops, crashed = prepare(model, history)
    barriers, group_ops = _barrier_snapshots(events, eff_ops, crashed)
    n_barriers = len(barriers)
    if n_barriers == 0:
        return True
    groups, gidx, group_op_list, empty = _group_vocab(group_ops)
    # Every fired op strictly grows fok or a crashed count, both bounded,
    # so the walk terminates without the cap; the cap bounds worst-case
    # latency anyway.
    cap = max_steps if max_steps is not None else 4 * len(history) + 64
    state, fok, fcr = model, frozenset(), empty
    b = steps = 0
    with obs.span("wgl_cpu.greedy_walk") as sp:
        while b < n_barriers:
            _pos, i, open_ok, open_crashed = barriers[b]
            if i in fok:
                fok = fok - {i}
                b += 1
                continue
            steps += 1
            if steps > cap:
                sp.set(completed=False, steps=steps)
                return None
            # Greedy: fire the returning op itself first.
            s2 = state.step(eff_ops[i])
            if not m.is_inconsistent(s2):
                state, fok = s2, fok | {i}
                if record is not None:
                    record.append(eff_ops[i])
                continue
            # Enabling move: the first consistent open ok op, else the first
            # available crashed group (same legality and order the DFS
            # branches over — we just never come back).
            for j in open_ok:
                if j in fok or j == i:
                    continue
                s2 = state.step(eff_ops[j])
                if not m.is_inconsistent(s2):
                    state, fok = s2, fok | {j}
                    if record is not None:
                        record.append(eff_ops[j])
                    break
            else:
                for g, open_count in open_crashed:
                    k = gidx[g]
                    if fcr[k] >= open_count:
                        continue
                    s2 = state.step(group_op_list[k])
                    if not m.is_inconsistent(s2):
                        state = s2
                        fcr = fcr[:k] + (fcr[k] + 1,) + fcr[k + 1:]
                        if record is not None:
                            record.append(group_op_list[k])
                        break
                else:
                    sp.set(completed=False, steps=steps)
                    return None  # stuck: every greedy move is inconsistent
        sp.set(completed=True, steps=steps)
    return True


# ---------------------------------------------------------------------------
# Configuration-set sweep (the device engines' semantics oracle)
# ---------------------------------------------------------------------------


def _group_vocab(group_ops):
    """Fixed group vocabulary shared by the engines: (groups, gidx,
    group_op_list, zero-count tuple).  Count tuples are O(G) per config,
    so the engines scale their exploration budgets by G — a group-heavy history answers "unknown"
    early instead of chewing through gigabytes of wide tuples."""
    groups = list(group_ops)
    gidx = {g: k for k, g in enumerate(groups)}
    group_op_list = [group_ops[g] for g in groups]
    return groups, gidx, group_op_list, (0,) * len(groups)


def _g_scaled(budget: int, n_groups: int, floor: int = 10_000) -> int:
    """Cap a visited/config budget so total tuple storage stays bounded
    (~50M counts) however wide the group vocabulary is."""
    if n_groups <= 64:
        return budget
    return max(floor, min(budget, 50_000_000 // n_groups))


def _tuple_dominates(a: tuple, b: tuple) -> bool:
    """a ≤ b pointwise over fixed-vocabulary count tuples."""
    for x, y in zip(a, b):
        if x > y:
            return False
    return True


class _Antichain:
    """Minimal fired-crashed multisets for one (state, fired_ok) class.

    A config that fired *fewer* crashed ops dominates one that fired more:
    every continuation of the bigger set is available to the smaller one
    (crashed ops carry no obligations), so only the minimal antichain needs
    exploring.  Multisets are count tuples over the sweep's fixed group
    vocabulary."""

    __slots__ = ("items",)

    def __init__(self):
        self.items: list[tuple] = []

    def add(self, fcr: tuple) -> bool:
        for it in self.items:
            if _tuple_dominates(it, fcr):
                return False
        self.items = [it for it in self.items if not _tuple_dominates(fcr, it)]
        self.items.append(fcr)
        return True


def sweep_analysis(
    model: m.Model,
    history: Sequence[dict],
    max_configs: int = 200_000,
    stop_at_index: int | None = None,
    stats: dict | None = None,
) -> dict:
    """Exhaustive configuration-set sweep with domination pruning — the
    algorithm the device engines vectorize (``ops.wgl``), kept on the
    CPU as their oracle.

    ``stop_at_index`` bounds a refutation-confirmation run to the prefix
    ending at the device's failure barrier (the returning op's history
    index): a genuine refutation dies by that barrier, so sweeping past
    it is wasted work.  Surviving past it means the device refutation was
    a hash-collision artifact — returned as "unknown" (the prefix proves
    nothing about the suffix).

    ``stats``: an optional dict the sweep fills with its work counters
    (barriers, groups, configs_explored, peak_configs)."""
    with obs.span("wgl_cpu.sweep") as sp:
        st: dict = {} if stats is None else stats
        out = _sweep_analysis(model, history, max_configs, stop_at_index, st)
        sp.set(valid=out.get("valid?"), **st)
        return out


def _sweep_analysis(model, history, max_configs, stop_at_index, stats: dict) -> dict:
    events, eff_ops, crashed = prepare(model, history)
    barriers, group_ops = _barrier_snapshots(events, eff_ops, crashed)
    # Fixed group vocabulary: all groups are known after the snapshots,
    # so fired-crash multisets become count TUPLES indexed by group.
    groups, gidx, group_op_list, zero = _group_vocab(group_ops)
    max_configs = _g_scaled(max_configs, len(groups))

    # configs: (state, fok) -> antichain of fired-crashed count tuples
    configs: dict[tuple, _Antichain] = {}
    ac = _Antichain()
    ac.add(zero)
    configs[(model, frozenset())] = ac
    explored = 0  # closure work across barriers (telemetry)
    peak = 1      # peak per-barrier frontier occupancy (telemetry)
    stats.update(barriers=len(barriers), groups=len(groups))

    for _pos, i, open_ok, open_crashed in barriers:
        bar_open = [(gidx[g], c) for g, c in open_crashed]
        # Closure under firing, with domination pruning.
        work = [(st, fok, fcr) for (st, fok), a in configs.items() for fcr in a.items]
        seen: dict[tuple, _Antichain] = {}
        for st, fok, fcr in work:
            seen.setdefault((st, fok), _Antichain()).add(fcr)
        count = len(work)
        while work:
            state, fok, fcr = work.pop()
            cands = []
            for j in open_ok:
                if j in fok:
                    continue
                s2 = state.step(eff_ops[j])
                if not m.is_inconsistent(s2):
                    cands.append((s2, fok | {j}, fcr))
            for gi, open_count in bar_open:
                if fcr[gi] >= open_count:
                    continue
                s2 = state.step(group_op_list[gi])
                if not m.is_inconsistent(s2):
                    fcr2 = fcr[:gi] + (fcr[gi] + 1,) + fcr[gi + 1 :]
                    cands.append((s2, fok, fcr2))
            for s2, fok2, fcr2 in cands:
                a = seen.setdefault((s2, fok2), _Antichain())
                if a.add(fcr2):
                    work.append((s2, fok2, fcr2))
                    count += 1
                    if count > max_configs:
                        stats.update(
                            configs_explored=explored + count,
                            peak_configs=max(peak, count),
                        )
                        return {
                            "valid?": "unknown",
                            "cause": f"configuration set exceeded {max_configs}",
                            "op": history[i],
                        }
        explored += count
        peak = max(peak, count)
        stats.update(configs_explored=explored, peak_configs=peak)
        # Keep configs that fired i; retire i.
        configs = {}
        for (st, fok), a in seen.items():
            if i in fok:
                tgt = configs.setdefault((st, fok - {i}), _Antichain())
                for fcr in a.items:
                    tgt.add(fcr)
        if not configs:
            return {
                "valid?": False,
                "op": history[i],
                "configs": [
                    {"model": st, "pending": sorted(set(open_ok) - fok)}
                    for (st, fok) in list(seen)[:10]
                ],
            }
        if stop_at_index is not None and i == stop_at_index:
            # Barriers are ordered by return position, not op id, so the
            # bound is the IDENTITY of the device's failure barrier (both
            # sides name it by the returning op's history index).
            return {
                "valid?": "unknown",
                "cause": "confirmation prefix survived past the device failure point",
                "op": history[i],
            }
    return {"valid?": True, "configs": [{"model": st} for (st, _fok) in list(configs)[:10]]}


#: Default engine, reference-equivalent ("wgl" algorithm).
analysis = dfs_analysis


# ---------------------------------------------------------------------------
# Independent brute-force oracle (for validating the oracles themselves)
# ---------------------------------------------------------------------------


def brute_analysis(model: m.Model, history: Sequence[dict]) -> dict:
    """Tiny-history oracle: enumerate every linearization order consistent
    with real-time precedence and check sequential legality.  Exponential —
    differential-test use only (≲ 12 ops)."""
    events, eff_ops, _crashed = prepare(model, history)
    call_pos: dict[int, int] = {}
    ret_pos: dict[int, int] = {}
    for pos, (kind, i) in enumerate(events):
        if kind == CALL:
            call_pos[i] = pos
        else:
            ret_pos[i] = pos
    ids = sorted(call_pos)
    must = [i for i in ids if i in ret_pos]  # ok ops must appear

    # At each step, the next linearized op must be callable before the
    # earliest unlinearized return: if ret(j) < call(i), j precedes i in
    # every legal order.
    def search(state, done: frozenset) -> bool:
        remaining_must = [i for i in must if i not in done]
        if not remaining_must:
            return True
        barrier = min(ret_pos[i] for i in remaining_must)
        for i in ids:
            if i in done:
                continue
            if call_pos[i] > barrier:
                continue
            s2 = state.step(eff_ops[i])
            if m.is_inconsistent(s2):
                continue
            if search(s2, done | {i}):
                return True
        return False

    return {"valid?": search(model, frozenset())}
