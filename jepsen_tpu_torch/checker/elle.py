"""Elle-equivalent transactional consistency checkers.

The port of the JAX package's ``checker.elle``.  The reference
delegates transactional anomaly detection to the external ``elle
0.1.3`` library through thin adapters (jepsen/src/jepsen/tests/cycle/
append.clj, wr.clj); this is the native rebuild: dependency-graph
inference on the host (``checker.txn_graph``: the column engine by
default, the loop reference as fallback and oracle), cycle
classification on the backend ``CYCLE_BACKEND`` names (host SCC,
``checker.scc``, by default; the dense closure on the card,
``ops.closure``, as the ``"device"`` opt-in for graphs of at most
``SCC_THRESHOLD`` nodes), and witness cycles for explanations recovered
by BFS over the host adjacency.

Result shape follows elle's: ``{"valid?": bool, "anomaly-types": [...],
"anomalies": {type: [explanation, ...]}, "not": [models ruled out],
"also-not": [stronger models implied ruled out]}``.  The anomaly vocabulary
is the reference's documented set (tests/cycle/wr.clj:30-46): G0, G1a, G1b,
G1c, G-single, G2, internal — plus list-append's duplicate-elements and
incompatible-order.

The checkers take the device of the ``"device"`` backend from their
``device=`` argument, else from ``opts["device"]``: the card unless it
is ``"cpu"``.  Results carry a ``provenance`` block
(``obs.provenance.attach``), and with a store configured each result's
evidence bundle is written (``obs.provenance.emit``), as in the JAX
package.  Each checker sets ``geometry_batchable = False`` and has a
``batch_key``: the check service (``serve``) runs them on its graph
lane, one ``check_batch`` per key.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.checker import scc
from jepsen_tpu_torch.checker import txn_graph as tg
from jepsen_tpu_torch.obs import provenance as _prov
from jepsen_tpu_torch.ops import closure as cl

# ---------------------------------------------------------------------------
# Consistency-model hierarchy (elle.consistency-model's lattice, rebuilt
# from the Adya / Cerone model relationships it encodes)
# ---------------------------------------------------------------------------

#: anomaly → weakest consistency models it rules out.  Our G2 evidence is
#: item anti-dependency cycles (G2-item), which Adya's PL-2.99 already
#: proscribes — so it rules out repeatable-read, and serializable /
#: strict-serializable follow through the lattice.
ANOMALY_RULES_OUT = {
    "G0": ["read-uncommitted"],
    "duplicate-elements": ["read-uncommitted"],
    "duplicate-writes": ["read-uncommitted"],
    "incompatible-order": ["read-uncommitted"],
    "G1a": ["read-committed"],
    "G1b": ["read-committed"],
    "G1c": ["read-committed"],
    "internal": ["read-atomic"],
    "G-single": ["consistent-view", "snapshot-isolation"],
    "G2": ["repeatable-read", "serializable"],
}

#: DIRECT weaker→stronger edges; STRONGER_MODELS below is the transitive
#: closure (computed, so adding a model can't silently break the
#: closure).  Chains follow Adya's PL hierarchy (thesis Fig. 4-3) on
#: one side — read-committed → {cursor-stability, monotonic-view};
#: PL-2L → PL-MSR / PL-CV → PL-FCV → PL-SI; PL-FCV → PL-3U
#: (update-serializable) → PL-3 — and the atomic-snapshot family on the
#: other (monotonic-atomic-view → read-atomic → causal →
#: parallel-snapshot-isolation → snapshot-isolation), meeting at
#: serializable; session-strengthened variants (Daudjee & Salem)
#: interpose between the snapshot/serializable levels and
#: strict-serializable at the top.
_STRONGER_DIRECT = {
    # Daudjee & Salem session ladders exist at every isolation level
    # ("Lazy Database Replication with Ordering Guarantees" for SI,
    # "Maintaining Transaction Isolation Guarantees ..." for RC): the
    # strong-session-X / strong-X variants add per-session then global
    # real-time ordering to X, and the ladders are pointwise ordered
    # (X <= Y implies strong-session-X <= strong-session-Y etc.).
    "read-uncommitted": ["read-committed", "strong-session-read-uncommitted"],
    "strong-session-read-uncommitted": [
        "strong-read-uncommitted", "strong-session-read-committed",
    ],
    "strong-read-uncommitted": ["strong-read-committed"],
    "read-committed": [
        "cursor-stability", "monotonic-atomic-view", "monotonic-view",
        "strong-session-read-committed",
    ],
    "strong-session-read-committed": [
        "strong-read-committed", "strong-session-snapshot-isolation",
    ],
    "strong-read-committed": ["strong-snapshot-isolation"],
    "cursor-stability": ["repeatable-read"],
    # Adya PL-2L: reads observe a monotonically growing prefix of commits
    "monotonic-view": ["monotonic-snapshot-read", "consistent-view"],
    # Adya PL-MSR: reads are snapshots that advance monotonically
    "monotonic-snapshot-read": ["snapshot-isolation"],
    "monotonic-atomic-view": ["read-atomic", "repeatable-read"],
    # Adya PL-CV → PL-FCV → PL-SI
    "consistent-view": ["forward-consistent-view"],
    "forward-consistent-view": ["snapshot-isolation", "update-serializable"],
    # Adya PL-3U: serializable with respect to update transactions
    "update-serializable": ["serializable"],
    "read-atomic": ["causal"],
    # Cerone et al.'s atomic-visibility chain (A Framework for
    # Transactional Consistency Models with Atomic Visibility): RA ⊂
    # causal ⊂ {prefix, PSI} ⊂ SI — prefix and PSI are incomparable
    # siblings between causal and snapshot-isolation
    "causal": ["parallel-snapshot-isolation", "prefix"],
    "prefix": ["snapshot-isolation"],
    "parallel-snapshot-isolation": ["snapshot-isolation"],
    "repeatable-read": ["serializable"],
    # PL-SI sits below PL-3 in Adya's proscribed-phenomena ordering, and
    # below its own session-strengthened ladder (Daudjee & Salem:
    # per-session real-time order, then global real-time order)
    "snapshot-isolation": ["serializable", "strong-session-snapshot-isolation"],
    "strong-session-snapshot-isolation": [
        "strong-snapshot-isolation", "strong-session-serializable",
    ],
    "strong-snapshot-isolation": ["strict-serializable"],
    "serializable": ["strong-session-serializable"],
    "strong-session-serializable": ["strict-serializable"],
    "strict-serializable": [],
}


def _transitive_closure(direct: Mapping) -> dict:
    out: dict[str, list] = {}
    for start in direct:
        seen: set[str] = set()
        stack = list(direct[start])
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            stack.extend(direct.get(x, ()))
        out[start] = sorted(seen)
    return out


#: model → strictly stronger models (transitively closed) — ruling out a
#: model also rules these out.
STRONGER_MODELS = _transitive_closure(_STRONGER_DIRECT)

#: Which anomalies each requested headline anomaly expands to
#: (tests/cycle/wr.clj:43-46: "G2 implies G-single and G1c; G1 implies G1a,
#: G1b, and G1c; G1c implies G0").
ANOMALY_EXPANSION = {
    "G2": ["G2", "G-single", "G1c", "G0"],
    "G-single": ["G-single", "G1c", "G0"],
    "G1": ["G1a", "G1b", "G1c", "G0"],
    "G1c": ["G1c", "G0"],
}


def expand_anomalies(requested: Sequence[str]) -> set[str]:
    out: set[str] = set()
    for a in requested:
        out.update(ANOMALY_EXPANSION.get(a, [a]))
    return out


def models_ruled_out(anomaly_types: Sequence[str]) -> tuple[list, list]:
    """(not, also-not): weakest models ruled out, and the stronger models
    those imply are ruled out too."""
    out: set[str] = set()
    for a in anomaly_types:
        out.update(ANOMALY_RULES_OUT.get(a, []))
    # Keep only the weakest: drop any model implied by another in the set.
    implied: set[str] = set()
    for m in out:
        implied.update(STRONGER_MODELS[m])
    weakest = sorted(out - implied)
    also = sorted((implied | out) - set(weakest))
    return weakest, also


# ---------------------------------------------------------------------------
# Witness-cycle recovery (host-side, from the classifier's hints)
# ---------------------------------------------------------------------------


def _shortest_path(adj: np.ndarray, src: int, dst: int) -> list[int] | None:
    """BFS shortest path src→dst over a bool adjacency matrix."""
    n = adj.shape[0]
    if src == dst:
        return [src]
    prev = np.full(n, -1, dtype=np.int64)
    frontier = [src]
    seen = {src}
    while frontier:
        nxt = []
        for u in frontier:
            for v in np.flatnonzero(adj[u]):
                v = int(v)
                if v not in seen:
                    seen.add(v)
                    prev[v] = u
                    if v == dst:
                        path = [dst]
                        while path[-1] != src:
                            path.append(int(prev[path[-1]]))
                        return path[::-1]
                    nxt.append(v)
        frontier = nxt
    return None


def _find_cycle_through_edge(
    graph_adj: np.ndarray, a: int, b: int, edge_adj: np.ndarray | None = None
) -> list[int] | None:
    """A cycle using edge a→b: b→a path (over ``graph_adj``) + the edge.

    The hinted edge must exist host-side in ``edge_adj`` (default: the
    path graph; G-single/G2 pass the rw matrix since their edge is not in
    the return-path graph) — a stale device hint must surface as
    unwitnessed, never as a fabricated cycle."""
    if not (edge_adj if edge_adj is not None else graph_adj)[a, b]:
        return None
    back = _shortest_path(graph_adj, b, a)
    if back is None:
        return None
    return [a] + back


def _edge_type(g: tg.TxnGraph, i: int, j: int) -> str:
    if g.ww[i, j]:
        return "ww"
    if g.wr[i, j]:
        return "wr"
    if g.rw[i, j]:
        return "rw"
    return "rt"


def _explain_cycle(g: tg.TxnGraph, cycle: list[int]) -> dict:
    """Render a node cycle into an elle-style explanation."""
    if len(cycle) > 1 and cycle[0] == cycle[-1]:
        # recovery paths come back closed ([a, …, a]); the step zip
        # re-closes the cycle itself, so drop the duplicate endpoint
        cycle = cycle[:-1]
    steps = []
    for i, j in zip(cycle, cycle[1:] + [cycle[0]]):
        et = _edge_type(g, i, j)
        steps.append(
            {
                "type": et,
                "from": g.nodes[i].op,
                "to": g.nodes[j].op,
                "explanation": g.explain(et, i, j),
            }
        )
    return {"cycle": [g.nodes[i].op for i in cycle], "steps": steps}


def _diag_cycle_at(adj_parts: np.ndarray, v: int) -> list[int] | None:
    """A cycle through node v (the device flagged closure[v, v]), or None
    when the host adjacency has no such cycle — a stale/mismatched hint
    must surface as unwitnessed, not as a fabricated witness."""
    if adj_parts[v, v]:
        return [v]
    for u in np.flatnonzero(adj_parts[v]):
        c = _find_cycle_through_edge(adj_parts, v, int(u))
        if c is not None:
            return c
    return None


# ---------------------------------------------------------------------------
# Checkers
# ---------------------------------------------------------------------------


def _merge_flags(g: tg.TxnGraph, flags: dict, hints: dict, requested) -> dict:
    """Merge device cycle flags+hints with inference anomalies into an
    elle-style result, recovering witness cycles by host BFS over the
    (sparse, host-resident) adjacency — nothing O(n²) crosses the device
    boundary."""
    wanted = expand_anomalies(requested)
    anomalies: dict[str, list] = {k: v for k, v in g.anomalies.items() if k in wanted}
    # A device flag asserts a cycle exists; host BFS recovers the witness.
    # If recovery fails (stale/empty hint, adjacency mismatch), the flag
    # must still surface — never a clean True over a flagged graph.
    unwitnessed: list[str] = []
    # The dense unions below are only for witness BFS: on a 10k-node
    # graph each one is a 100M-entry boolean scan, so a clean (unflagged)
    # graph must never pay for them.
    if g.n and any(flags[nm] for nm in ("G0", "G1c", "G-single", "G2")):
        any_adj = g.ww | g.wr | g.extra
        full_adj = any_adj | g.rw
        if flags["G0"] and "G0" in wanted:
            cyc = _diag_cycle_at(g.ww | g.extra, hints["G0"][0]) if hints["G0"] else None
            if cyc:
                anomalies.setdefault("G0", []).append(_explain_cycle(g, cyc))
            else:
                unwitnessed.append("G0")
        for name, graph_adj, edge_adj, gate in (
            ("G1c", any_adj, any_adj, True),
            ("G-single", any_adj, g.rw, True),
            ("G2", full_adj, g.rw, not flags["G-single"]),
        ):
            if flags[name] and gate and name in wanted:
                cyc = (
                    _find_cycle_through_edge(graph_adj, *hints[name], edge_adj=edge_adj)
                    if hints[name]
                    else None
                )
                if cyc:
                    anomalies.setdefault(name, []).append(_explain_cycle(g, cyc))
                else:
                    unwitnessed.append(name)

    types = sorted(anomalies)
    not_, also_not = models_ruled_out(types)
    out: dict[str, Any] = {"valid?": not anomalies}
    if anomalies:
        out.update(
            {
                "anomaly-types": types,
                "anomalies": anomalies,
                "not": not_,
                "also-not": also_not,
            }
        )
    if unwitnessed:
        out["unwitnessed-flags"] = sorted(set(unwitnessed))
        if not anomalies:
            out["valid?"] = "unknown"
            out["cause"] = (
                "device flagged cycle(s) "
                f"({', '.join(out['unwitnessed-flags'])}) but witness "
                "recovery found no cycle — flag and host graph disagree"
            )
    return out

#: Above this many nodes a graph NEVER classifies on the dense closure
#: (O(n³ log n) against Tarjan's O(V+E)), even under
#: ``backend="device"``: the JAX package's routing, kept as it is.
SCC_THRESHOLD = 1024

#: Default cycle-classification backend: host SCC, as in the JAX
#: package, whose measurements on its TPU found the host faster at every
#: single-chip shape.  ``"device"`` runs the dense closure on the card
#: for graphs of at most ``SCC_THRESHOLD`` nodes; chip_smoke.py's phase
#: 10 measures both on the H100 (PERF.md).
CYCLE_BACKEND = "host"


def _device_classify(n: int, backend: str | None) -> bool:
    b = backend or CYCLE_BACKEND
    if b not in ("host", "device"):
        raise ValueError(f"unknown cycle backend {b!r}; expected 'host' or 'device'")
    return b == "device" and n <= SCC_THRESHOLD


def check_graph(
    g: tg.TxnGraph, requested: Sequence[str], backend: str | None = None,
    device=None,
) -> dict:
    """Classify cycles + merge inference anomalies into an elle-style
    result, on the backend that ``backend`` (else ``CYCLE_BACKEND``)
    names; ``device`` is the device backend's (the card unless "cpu")."""
    if not g.n:
        return _merge_flags(g, dict(cl._EMPTY_FLAGS), dict(cl._EMPTY_HINTS), requested)
    if _device_classify(g.n, backend):
        with obs.span("elle.scc", nodes=g.n, backend="device"):
            flags, hints = cl.classify_graph(g.ww, g.wr, g.rw, g.extra,
                                             device=device)
    else:
        # the sparse edge view skips argwhere over the dense matrices
        with obs.span("elle.scc", nodes=g.n, backend="host"):
            flags, hints = scc.classify_graph_scc(
                g.ww, g.wr, g.rw, g.extra, edges=g.edge_arrays()
            )
    return _merge_flags(g, flags, hints, requested)


def check_graphs(
    graphs: Sequence[tg.TxnGraph],
    requested: Sequence[str],
    backend: str | None = None,
    device=None,
) -> list[dict]:
    """Classify MANY graphs (the per-key scale-out path): one SCC pass
    per graph on the host backend; on ``backend="device"``, the
    bucketed batched closures (``ops.closure.classify_graphs``).  Each
    backend's pass is one ``elle.scc`` span (the device one is the
    port's: the JAX package times only the host pass here)."""
    results: list = [None] * len(graphs)
    dev_idx = [i for i, g in enumerate(graphs) if _device_classify(g.n, backend)]
    if dev_idx:
        # routed per graph: an oversized graph (> SCC_THRESHOLD) goes
        # host without cancelling the device opt-in for the others
        with obs.span("elle.scc", graphs=len(dev_idx), backend="device"):
            dev_out = cl.classify_graphs(
                [(graphs[i].ww, graphs[i].wr, graphs[i].rw, graphs[i].extra)
                 for i in dev_idx],
                device=device,
            )
        for i, r in zip(dev_idx, dev_out):
            results[i] = r
    if len(dev_idx) < len(graphs):
        with obs.span("elle.scc", graphs=len(graphs) - len(dev_idx),
                      backend="host"):
            for i, g in enumerate(graphs):
                if results[i] is None:
                    results[i] = scc.classify_graph_scc(
                        g.ww, g.wr, g.rw, g.extra, edges=g.edge_arrays()
                    )
    return [
        _merge_flags(g, flags, hints, requested)
        for g, (flags, hints) in zip(graphs, results)
    ]


# ---------------------------------------------------------------------------
# elle/ output directory (anomaly explanation files)
# ---------------------------------------------------------------------------


def _render_op(op: Mapping) -> str:
    return (
        f"{{:index {op.get('index')}, :process {op.get('process')}, "
        f":type :{op.get('type')}, :f :{op.get('f')}, :value {op.get('value')!r}}}"
    )


def render_anomaly(name: str, item) -> str:
    """One anomaly instance as elle-style prose (elle writes files like
    elle/G1c.txt with 'Let's consider the following transaction cycle'
    sections; SURVEY.md §2.3)."""
    if isinstance(item, Mapping) and "cycle" in item:
        lines = ["Let's consider the following transaction cycle:", ""]
        for op in item["cycle"]:
            lines.append("  " + _render_op(op))
        lines.append("  (and back to the start)")
        lines.append("")
        lines.append("Each step in the cycle:")
        for s in item.get("steps", ()):
            lines.append(f"  - [{s['type']}] {s['explanation']}")
        return "\n".join(lines)
    if isinstance(item, Mapping):
        lines = []
        for k, v in item.items():
            if isinstance(v, Mapping) and "type" in v and "f" in v:
                lines.append(f"  :{k} {_render_op(v)}")
            elif (
                isinstance(v, Sequence)
                and not isinstance(v, (str, bytes))
                and v
                and all(isinstance(x, Mapping) and "type" in x for x in v)
            ):
                lines.append(f"  :{k}")
                lines.extend(f"    {_render_op(x)}" for x in v)
            else:
                lines.append(f"  :{k} {v!r}")
        return "\n".join(lines)
    return f"  {item!r}"


def write_anomaly_dir(test, result: Mapping, opts=None, dirname: str = "elle"):
    """Write one explanation file per anomaly type under the test's store
    directory (the reference's elle output dir: elle emits anomaly
    explanations into ``elle/``, served alongside the other artifacts by
    jepsen.web).  Returns the directory, or None when no store is
    configured or the result is clean."""
    anomalies = result.get("anomalies")
    if not anomalies:
        return None
    try:
        d = store.test_dir(test)
    except (KeyError, TypeError):
        return None  # bare unit-test maps have no store coordinates
    sub = (opts or {}).get("subdirectory")
    if sub:
        d = d / sub
    d = d / dirname
    d.mkdir(parents=True, exist_ok=True)
    for name, items in anomalies.items():
        n = len(items)
        chunks = [f"{n} {name} anomal{'y' if n == 1 else 'ies'}"]
        for i, item in enumerate(items, 1):
            chunks.append(f"--- {name} #{i} ---\n{render_anomaly(name, item)}")
        (d / f"{name}.txt").write_text("\n\n".join(chunks) + "\n", encoding="utf-8")
    return d


DEFAULT_ANOMALIES = ["G2", "G1a", "G1b", "internal"]  # tests/cycle/wr.clj:46


class _ElleChecker(Checker):
    """Shared artifact and provenance plumbing for the elle-style
    checkers."""

    #: Graph workloads have no padded-kernel geometry to share, so the
    #: check service must never pack them into a geometry bucket:
    #: admission routes them to the host side lane instead.
    geometry_batchable = False

    def batch_key(self) -> tuple:
        """Column-shape compatibility key for the serve graph lane (the
        graph analogue of ``parallel.batch.bucket_geometry``): queued
        requests whose checkers share this key are served by ONE
        ``check_batch`` call."""
        return (type(self).__name__,)

    def _device(self, opts):
        """The device backend's device: the checker's own, else
        ``opts["device"]`` (the card when both are None)."""
        if self.device is not None:
            return self.device
        return (opts or {}).get("device")

    def write_artifacts(self, test, result, opts=None):
        """Render the elle/ anomaly-explanation directory for a stored
        run (called per key by independent.checker on the batch path)."""
        try:
            write_anomaly_dir(test, result, opts)
        except OSError:
            pass

    def _prov_engine(self) -> dict:
        """The engine/backend resolution the provenance block records:
        which inference engine ran (the instance's pin, or the
        env/default resolution) and the cycle-detection backend."""
        eng = getattr(self, "engine", None)
        if eng is None:
            try:
                eng = tg.resolve_engine(None)
            except ValueError:
                eng = None
        return {
            "engine": "elle", "graph_engine": eng,
            "cycle_backend": getattr(self, "backend", None) or CYCLE_BACKEND,
        }

    def _emit_evidence(self, test, history, res, opts, *,
                       workload: str, source: str = "check") -> None:
        _prov.attach(
            res, [{"event": "elle.check", "workload": workload}],
            engine=self._prov_engine(),
        )
        _prov.emit(test, history, res, source=source,
                   checker=f"elle-{workload}", opts=opts)


class ListAppendChecker(_ElleChecker):
    """Native elle.list-append equivalent (tests/cycle/append.clj:11-22).

    Options:
      anomalies          headline anomalies to report (default catches all)
      additional_graphs  iterable of "realtime" / "process"
      engine             inference engine ("columns"/"loops"; None defers
                         to txn_graph.resolve_engine — vectorized columns
                         by default, loop reference on fallback)
      device             the device backend's device (None: opts'
                         "device", else the card)
    """

    def __init__(
        self,
        anomalies: Sequence[str] = DEFAULT_ANOMALIES,
        additional_graphs: Sequence[str] = (),
        engine: str | None = None,
        device=None,
    ):
        self.anomalies = list(anomalies) + [
            "duplicate-elements",
            "incompatible-order",
        ]
        self.additional_graphs = tuple(additional_graphs)
        self.engine = engine
        self.device = device

    def batch_key(self) -> tuple:
        return (
            type(self).__name__, tuple(self.anomalies),
            self.additional_graphs, self.engine,
        )

    def check(self, test, history, opts):
        g = tg.list_append_graph(
            history, self.additional_graphs, engine=self.engine
        )
        res = check_graph(g, self.anomalies, device=self._device(opts))
        self.write_artifacts(test, res, opts)
        self._emit_evidence(test, history, res, opts, workload="list-append")
        return res

    def check_batch(self, test, histories, opts):
        """Check many histories through one batched inference pass (one
        engine resolution; independent.checker hands it every key) and
        one classification sweep."""
        graphs = tg.list_append_graphs(
            histories, self.additional_graphs, engine=self.engine
        )
        outs = check_graphs(graphs, self.anomalies, device=self._device(opts))
        for hh, res in zip(histories, outs):
            self._emit_evidence(test, hh, res, opts,
                                workload="list-append", source="check_batch")
        return outs


class WRRegisterChecker(_ElleChecker):
    """Native elle.rw-register equivalent (tests/cycle/wr.clj:15-46)."""

    def __init__(
        self,
        anomalies: Sequence[str] = DEFAULT_ANOMALIES,
        additional_graphs: Sequence[str] = (),
        sequential_keys: bool = False,
        linearizable_keys: bool = False,
        engine: str | None = None,
        device=None,
    ):
        self.anomalies = list(anomalies) + ["duplicate-writes"]
        self.additional_graphs = tuple(additional_graphs)
        self.sequential_keys = sequential_keys
        self.linearizable_keys = linearizable_keys
        self.engine = engine
        self.device = device

    def batch_key(self) -> tuple:
        return (
            type(self).__name__, tuple(self.anomalies),
            self.additional_graphs, self.sequential_keys,
            self.linearizable_keys, self.engine,
        )

    def _graph(self, history):
        return tg.rw_register_graph(
            history,
            self.additional_graphs,
            sequential_keys=self.sequential_keys,
            linearizable_keys=self.linearizable_keys,
            engine=self.engine,
        )

    def check(self, test, history, opts):
        res = check_graph(self._graph(history), self.anomalies,
                          device=self._device(opts))
        self.write_artifacts(test, res, opts)
        self._emit_evidence(test, history, res, opts, workload="wr-register")
        return res

    def check_batch(self, test, histories, opts):
        """Batched per-key form (see ListAppendChecker.check_batch)."""
        graphs = tg.rw_register_graphs(
            histories, self.additional_graphs,
            sequential_keys=self.sequential_keys,
            linearizable_keys=self.linearizable_keys, engine=self.engine,
        )
        outs = check_graphs(graphs, self.anomalies, device=self._device(opts))
        for hh, res in zip(histories, outs):
            self._emit_evidence(test, hh, res, opts,
                                workload="wr-register", source="check_batch")
        return outs


class CycleChecker(_ElleChecker):
    """Cycle detection over an ARBITRARY user relation graph — the
    reference's generic adapter (jepsen/src/jepsen/tests/cycle.clj:10-16,
    reifying a Checker over elle.core/check with a custom analyzer).

    ``analyzer(history)`` returns ``(nodes, relations, explainer)``:

      nodes      list of op dicts (one graph node per entry)
      relations  one of: a ``{name: [n, n] bool ndarray}`` mapping (the
                 scalable form — a 50k-op realtime relation is one
                 vectorized comparison, never a Python edge list), a bare
                 [n, n] ndarray, or an iterable of ``(i, j, name)``
                 tuples for small graphs
      explainer  ``fn(i, j, relation) -> str`` prose for one edge (may be
                 None for a generic rendering)

    Any cycle in the combined relation graph is an anomaly (reported
    under ``"cycle"`` with a recovered witness).  Detection routes like
    the typed checkers: host Tarjan by default, the dense closure when
    the device backend is opted in for graphs ≤ SCC_THRESHOLD.

    ``backend`` pins this checker instance's routing ("host"|"device"),
    matching the per-call ``backend`` on check_graph/check_graphs —
    per-instance opt-in without mutating the CYCLE_BACKEND module
    global.  None (the default) defers to CYCLE_BACKEND.
    """

    def __init__(self, analyzer, backend: str | None = None, device=None):
        if backend is not None and backend not in ("host", "device"):
            raise ValueError(
                f"unknown cycle backend {backend!r}; expected 'host' or 'device'"
            )
        self.analyzer = analyzer
        self.backend = backend
        self.device = device

    def batch_key(self) -> tuple:
        # instances share a serve-lane batch only when they share the
        # SAME analyzer object: its output shape is the compatibility
        # contract, and there is no cheaper identity for a callable
        return (type(self).__name__, id(self.analyzer), self.backend)

    def check(self, test, history, opts):
        res = self._check_one(history, self._device(opts))
        self.write_artifacts(test, res, opts)
        self._emit_evidence(test, history, res, opts, workload="cycle")
        return res

    def check_batch(self, test, histories, opts):
        """One classification loop over many histories, one span."""
        dev = self._device(opts)
        with obs.span(
            "elle.infer_batch", histories=len(histories), workload="cycle",
        ):
            outs = [self._check_one(hh, dev) for hh in histories]
        for hh, res in zip(histories, outs):
            self._emit_evidence(test, hh, res, opts,
                                workload="cycle", source="check_batch")
        return outs

    def _check_one(self, history, device=None):
        nodes, relations, explainer = self.analyzer(history)
        n = len(nodes)
        adj = np.zeros((n, n), dtype=bool)
        if isinstance(relations, np.ndarray):
            relations = {"rel": relations}
        if isinstance(relations, Mapping):
            for mat in relations.values():
                adj |= np.asarray(mat, dtype=bool)

            def rel_of(a: int, b: int):
                for name, mat in relations.items():
                    if mat[a, b]:
                        return name
                return None
        else:
            rels: dict[tuple[int, int], Any] = {}
            for i, j, r in relations:
                adj[i, j] = True
                rels.setdefault((int(i), int(j)), r)

            def rel_of(a: int, b: int):
                return rels.get((a, b))
        flagged, cycle = self._find_cycle(adj, n, self.backend, device)
        if not flagged:
            res: dict[str, Any] = {"valid?": True}
        elif cycle is None:
            # never a clean True over a flagged graph (same invariant as
            # _merge_flags): flag and host witness recovery disagree
            res = {
                "valid?": "unknown",
                "unwitnessed-flags": ["cycle"],
                "cause": (
                    "device flagged a cycle but witness recovery found "
                    "none — flag and host graph disagree"
                ),
            }
        else:
            steps = []
            for a, b in zip(cycle, cycle[1:] + [cycle[0]]):
                r = rel_of(a, b)
                prose = None
                if explainer is not None:
                    prose = explainer(a, b, r)
                steps.append(
                    {
                        "type": r,
                        "from": nodes[a],
                        "to": nodes[b],
                        "explanation": prose or f"{r}: node {a} precedes node {b}",
                    }
                )
            res = {
                "valid?": False,
                "anomaly-types": ["cycle"],
                "anomalies": {
                    "cycle": [{"cycle": [nodes[i] for i in cycle], "steps": steps}]
                },
            }
        return res

    @staticmethod
    def _find_cycle(
        adj: np.ndarray, n: int, backend: str | None = None, device=None
    ) -> tuple[bool, list[int] | None]:
        """(cycle-flagged, witness-cycle-or-None); the witness node list
        is unclosed.  ``backend`` and ``device`` route like
        check_graph's."""
        if n == 0:
            return False, None
        if _device_classify(n, backend):
            zeros = np.zeros_like(adj)
            flags, hints = cl.classify_graph(adj, zeros, zeros, zeros,
                                             device=device)
            if not flags["G0"]:
                return False, None
            cyc = _diag_cycle_at(adj, hints["G0"][0]) if hints["G0"] else None
        else:
            edges = np.argwhere(adj)
            comp = scc.tarjan_scc(n, [list(np.flatnonzero(adj[v])) for v in range(n)])
            hit = scc._first_edge_in_cycle(edges, comp)
            if hit is None:
                return False, None
            cyc = _find_cycle_through_edge(adj, hit[0], hit[1])
        if cyc and len(cyc) > 1 and cyc[0] == cyc[-1]:
            cyc = cyc[:-1]
        return True, cyc


def realtime_analyzer(history):
    """Built-in analyzer: realtime precedence between completed client
    ops (elle.core's realtime graph vocabulary) — op A precedes op B
    when A's completion lands before B's invocation.  One vectorized
    comparison (the same dense form txn_graph.realtime_edges uses), not
    a Python edge list."""
    pairs = h.pair_index(history)
    nodes = []
    inv_pos, comp_pos = [], []
    for i, o in enumerate(history):
        if h.is_invoke(o) and h.is_client_op(o):
            j = int(pairs[i])
            if j != -1 and history[j]["type"] == h.OK:
                nodes.append(history[j])
                inv_pos.append(i)
                comp_pos.append(j)
    inv = np.array(inv_pos, dtype=np.int64)
    comp = np.array(comp_pos, dtype=np.int64)
    adj = comp[:, None] < inv[None, :]

    def explain(a, b, _r):
        return (
            f"op {nodes[a].get('index')} completed before "
            f"op {nodes[b].get('index')} was invoked"
        )

    return nodes, {"realtime": adj}, explain


def cycle_checker(analyzer, backend: str | None = None, device=None) -> Checker:
    """The reference's ``jepsen.tests.cycle/checker`` entry point."""
    return CycleChecker(analyzer, backend=backend, device=device)


def list_append(**kw) -> Checker:
    return ListAppendChecker(**kw)


def wr_register(**kw) -> Checker:
    return WRRegisterChecker(**kw)
