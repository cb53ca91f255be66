"""Transaction dependency-graph inference (Elle-style).

Builds write-write / write-read / read-write (anti-)dependency graphs over
the committed transactions of a history, for the two workload families the
reference checks through Elle (jepsen/src/jepsen/tests/cycle/append.clj,
wr.clj; elle 0.1.3 is an external dep per jepsen/project.clj:13):

* **list-append** — every write is an append to a per-key list; reads observe
  the whole list.  Version orders are directly recoverable from reads
  (the longest observed list), which makes inference exact.
* **rw-register** — writes are unique register values.  Only write-read
  edges are directly observable; version orders (hence ww/rw edges) are
  inferred under optional assumptions (``linearizable_keys``,
  ``sequential_keys``), mirroring elle.rw-register's options surfaced at
  tests/cycle/wr.clj:20-29.

The port's copy of the JAX package's ``checker.txn_graph``.  The graphs
come out as dense boolean adjacency matrices over transaction nodes,
with sparse edge arrays beside them: the host SCC backend
(``checker.scc``) reads the edges, the dense closure on the card
(``ops.closure``) the matrices.  Non-cycle anomalies (G1a aborted read, G1b intermediate read,
internal, duplicates, incompatible orders) are detected host-side during
inference, since they are single-pass folds.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Sequence

import numpy as np

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch import txn as t

#: engine selection: per-call arg > env > the vectorized default.  The
#: "columns" engine (checker.txn_columns) runs inference as
#: flat int64 column operations and falls back to "loops" (the retained
#: per-op reference below, also the differential oracle) whenever a
#: history's values can't ride int64 columns.
ENGINE_ENV = "JEPSEN_TPU_ELLE_ENGINE"
DEFAULT_ENGINE = "columns"
ENGINES = ("columns", "loops")


def resolve_engine(engine: str | None = None) -> str:
    e = engine or os.environ.get(ENGINE_ENV) or DEFAULT_ENGINE
    if e not in ENGINES:
        raise ValueError(f"unknown elle engine {e!r}; expected one of {ENGINES}")
    return e

# ---------------------------------------------------------------------------
# Transaction nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TxnNode:
    """One committed (ok) or indeterminate (info) transaction."""

    id: int  # node index in the graph
    op: dict  # the completion op (carries the observed values)
    invoke_index: int
    complete_index: int
    ok: bool  # True for ok, False for info (writes *may* have happened)

    @property
    def value(self) -> Sequence:
        return self.op["value"] or []


@dataclasses.dataclass
class TxnGraph:
    """Dense dependency graph over transaction nodes.

    ``ww``/``wr``/``rw`` are [n, n] bool adjacency matrices; ``extra`` holds
    additional-graph edges (realtime/process — elle's ``additional-graphs``
    option, tests/cycle/wr.clj:18-20) which participate in cycles but are
    dependency-type-neutral.
    """

    nodes: list[TxnNode]
    ww: np.ndarray
    wr: np.ndarray
    rw: np.ndarray
    extra: np.ndarray
    #: (type, i, j) → human-readable explanation of why edge i→j exists —
    #: a string, or a zero-arg callable producing one.  Inference stores
    #: CALLABLES for per-edge prose: a 10k-txn history has ~37k edges
    #: whose eager f-strings (the ww ones repr the key's whole version
    #: order) would cost about as much as the rest of inference, while
    #: only the handful of edges on a witness cycle are ever rendered.
    explanations: dict[tuple[str, int, int], Any]
    #: non-cycle anomalies found during inference: name → [explanation dict]
    anomalies: dict[str, list]
    #: optional sparse edge cache: type → (E, 2) int64 (i, j) rows in
    #: ``np.argwhere`` order.  The columns engine fills it at build time
    #: so classification never scans the dense matrices; ``edge_arrays``
    #: computes (and caches) it by argwhere otherwise.
    edges: dict | None = None

    @property
    def n(self) -> int:
        return len(self.nodes)

    def edge_arrays(self) -> dict:
        """Sparse (i, j) edge rows per type ("ww"/"wr"/"rw"/"extra"),
        argwhere-ordered; cached."""
        if self.edges is None:
            self.edges = {
                "ww": np.argwhere(self.ww),
                "wr": np.argwhere(self.wr),
                "rw": np.argwhere(self.rw),
                "extra": np.argwhere(self.extra),
            }
        return self.edges

    def explain(self, et: str, i: int, j: int) -> str:
        """Render the explanation for edge (et, i, j), forcing a lazy
        one; the bare edge type when no explanation was recorded."""
        v = self.explanations.get((et, i, j))
        if v is None:
            return et
        return v() if callable(v) else v


def _t(nd: TxnNode) -> str:
    """Name a transaction in explanation prose by its history index
    (elle names them T1, T2, … — the completion op's :index is our
    stable equivalent)."""
    return f"T{nd.op.get('index', nd.id)}"


def _empty(n: int) -> np.ndarray:
    return np.zeros((n, n), dtype=bool)


def txn_nodes(history: Sequence[dict], pairs=None) -> list[TxnNode]:
    """Extract transaction nodes: ok txns (fully trusted) and info txns
    (indeterminate — their writes may be visible, so they join the graph as
    writers; their reads are not evidence).  Failed txns are excluded — their
    writes must never be visible (observing one is G1a).

    ``pairs`` lets a caller that already holds ``h.pair_index(history)``
    thread it through instead of paying the per-op pairing walk again
    (batched checks used to recompute it per history per call)."""
    if pairs is None:
        pairs = h.pair_index(history)
    nodes: list[TxnNode] = []
    for i, op in enumerate(history):
        if h.is_invoke(op) or not h.is_client_op(op):
            continue
        if h.is_ok(op) or h.is_info(op):
            j = int(pairs[i])
            inv = j if j != -1 else i
            # Info completions may carry no value; fall back to the invocation.
            o = op
            if h.is_info(op) and op.get("value") is None and j != -1:
                o = {**op, "value": history[j].get("value")}
            nodes.append(
                TxnNode(
                    id=len(nodes),
                    op=o,
                    invoke_index=inv,
                    complete_index=i,
                    ok=h.is_ok(op),
                )
            )
    return nodes


def _failed_writes(history: Sequence[dict], append: bool) -> dict:
    """(key, value) → failed op, for G1a detection (elle: aborted reads)."""
    out = {}
    fname = "append" if append else "w"
    for op in history:
        if h.is_fail(op) and h.is_client_op(op):
            for mop in op["value"] or ():
                if mop[0] == fname:
                    out[(mop[1], mop[2])] = op
    return out


def _intermediate_writes(nodes: list[TxnNode]) -> dict:
    """(key, value) → (node, next-value) for every non-final write a txn made
    to a key.  Observing one (without its successor) is G1b."""
    out = {}
    for node in nodes:
        writes: dict = {}
        for mop in node.value:
            if mop[0] != "r":
                writes.setdefault(mop[1], []).append(mop[2])
        for k, vs in writes.items():
            for a, b in zip(vs, vs[1:]):
                out[(k, a)] = (node, b)
    return out


# ---------------------------------------------------------------------------
# Additional graphs: realtime & process (elle's additional-graphs)
# ---------------------------------------------------------------------------


def realtime_edges(nodes: list[TxnNode]) -> np.ndarray:
    """i→j iff txn i completed before txn j was invoked.  Dense O(n²) — the
    closure on the card wants the dense form anyway.  Only ok nodes get
    realtime edges *out* (an info txn has no known completion time)."""
    n = len(nodes)
    comp = np.array(
        [nd.complete_index if nd.ok else np.iinfo(np.int64).max for nd in nodes]
    )
    inv = np.array([nd.invoke_index for nd in nodes])
    return comp[:, None] < inv[None, :]


def process_edges(nodes: list[TxnNode]) -> np.ndarray:
    """i→j iff same process and i immediately precedes j for that process."""
    adj = _empty(len(nodes))
    last: dict[Any, int] = {}
    for nd in sorted(nodes, key=lambda x: x.invoke_index):
        p = nd.op["process"]
        if p in last:
            adj[last[p], nd.id] = True
        last[p] = nd.id
    return adj


def build_extra(nodes: list[TxnNode], additional_graphs: Sequence[str]) -> np.ndarray:
    extra = _empty(len(nodes))
    for g in additional_graphs:
        if g == "realtime":
            extra |= realtime_edges(nodes)
        elif g == "process":
            extra |= process_edges(nodes)
        else:
            raise ValueError(f"unknown additional graph {g!r}")
    return extra


# ---------------------------------------------------------------------------
# Internal consistency (shared by both workloads)
# ---------------------------------------------------------------------------


def _internal_anomalies_append(node: TxnNode) -> list:
    """A txn must observe its own prior reads plus its own appends
    (elle.list-append internal checking)."""
    out = []
    expected: dict = {}  # key -> known list state within the txn
    for mop in node.value:
        f, k, v = mop[0], mop[1], mop[2]
        if f == "r":
            if k in expected and list(v or []) != expected[k]:
                out.append(
                    {
                        "op": node.op,
                        "mop": list(mop),
                        "expected": expected[k],
                    }
                )
            expected[k] = list(v or [])
        else:  # append
            if k in expected:
                expected[k] = expected[k] + [v]
    return out


def _internal_anomalies_wr(node: TxnNode) -> list:
    out = []
    known: dict = {}  # key -> last value this txn wrote or read
    for mop in node.value:
        f, k, v = mop[0], mop[1], mop[2]
        if f == "r":
            if k in known and v != known[k]:
                out.append({"op": node.op, "mop": list(mop), "expected": known[k]})
            known[k] = v
        else:
            known[k] = v
    return out


# ---------------------------------------------------------------------------
# list-append inference (elle.list-append equivalent)
# ---------------------------------------------------------------------------


def list_append_graph(
    history: Sequence[dict],
    additional_graphs: Sequence[str] = (),
    engine: str | None = None,
    pairs=None,
) -> TxnGraph:
    """Infer the dependency graph for a list-append history.

    Version order per key is recovered from reads: every observed read must
    be a prefix of the longest observed read (else ``incompatible-order``),
    so the longest read *is* the version order of observed values
    (elle's core trick — the paper's "recoverability").

    ``engine`` routes between the vectorized column engine (the default;
    see ``resolve_engine``) and the retained per-op loop reference
    (``list_append_graph_loops``) — identical results either way,
    differential-tested.  Histories whose values can't ride int64
    columns fall back to the loops automatically."""
    if resolve_engine(engine) == "columns":
        from jepsen_tpu_torch.checker import txn_columns as tc

        try:
            return tc.list_append_graph_columns(
                history, additional_graphs, pairs=pairs
            )
        except tc.NotColumnizable:
            # the loop reference below gives the same graph
            obs.counter("elle.columns_fallback", workload="list-append")
    return list_append_graph_loops(history, additional_graphs, pairs=pairs)


def list_append_graph_loops(
    history: Sequence[dict],
    additional_graphs: Sequence[str] = (),
    pairs=None,
) -> TxnGraph:
    """The per-op/per-mop loop reference for ``list_append_graph`` —
    retained as the differential oracle and the fallback for histories
    the column engine can't pack."""
    nodes = txn_nodes(history, pairs)
    n = len(nodes)
    ww, wr, rw = _empty(n), _empty(n), _empty(n)
    expl: dict = {}
    anomalies: dict[str, list] = {}

    def add_anom(name: str, item) -> None:
        anomalies.setdefault(name, []).append(item)

    # -- Per-txn (internal, duplicate in-txn appends handled via appender map)
    for nd in nodes:
        if nd.ok:
            for a in _internal_anomalies_append(nd):
                add_anom("internal", a)

    # -- Appender map + duplicate appends
    appender: dict = {}  # (k, v) -> node
    for nd in nodes:
        for mop in nd.value:
            if mop[0] == "append":
                kv = (mop[1], mop[2])
                if kv in appender:
                    add_anom(
                        "duplicate-elements",
                        {"key": mop[1], "element": mop[2], "ops": [appender[kv].op, nd.op]},
                    )
                else:
                    appender[kv] = nd

    failed = _failed_writes(history, append=True)
    inter = _intermediate_writes(nodes)

    # -- Collect external reads per key (ok txns only: info reads aren't
    #    evidence) and all observed elements
    reads_by_key: dict[Any, list[tuple[TxnNode, list]]] = {}
    for nd in nodes:
        if not nd.ok:
            continue
        for k, v in t.ext_reads(nd.value).items():
            reads_by_key.setdefault(k, []).append((nd, list(v or [])))

    # -- G1a / G1b from read contents
    for k, pairs in reads_by_key.items():
        for nd, lst in pairs:
            for x in lst:
                if (k, x) in failed:
                    add_anom(
                        "G1a",
                        {"op": nd.op, "key": k, "element": x, "writer": failed[(k, x)]},
                    )
            for pos, x in enumerate(lst):
                if (k, x) in inter:
                    wnode, nxt = inter[(k, x)]
                    if pos + 1 >= len(lst) or lst[pos + 1] != nxt:
                        add_anom(
                            "G1b",
                            {"op": nd.op, "key": k, "element": x, "writer": wnode.op},
                        )

    # -- Version order per key = longest observed read; prefix check
    for k, pairs in reads_by_key.items():
        longest: list = []
        for _, lst in pairs:
            if len(lst) > len(longest):
                longest = lst
        ok_order = True
        for nd, lst in pairs:
            if lst != longest[: len(lst)]:
                add_anom(
                    "incompatible-order",
                    {"key": k, "read": lst, "longest": longest, "op": nd.op},
                )
                ok_order = False
        if not ok_order:
            continue  # no trustworthy version order for this key

        order = longest
        # ww: consecutive observed appends
        for a, b in zip(order, order[1:]):
            na, nb = appender.get((k, a)), appender.get((k, b))
            if na is not None and nb is not None and na.id != nb.id:
                ww[na.id, nb.id] = True
                expl[("ww", na.id, nb.id)] = lambda na=na, nb=nb, a=a, b=b, k=k, order=order: (
                    f"{_t(na)} appended {a!r} to {k!r} ([:append {k!r} {a!r}]) "
                    f"and {_t(nb)} appended {b!r} immediately after it in "
                    f"{k!r}'s version order {order!r}"
                )
        # wr / rw per read
        for nd, lst in pairs:
            if lst:
                wn = appender.get((k, lst[-1]))
                if wn is not None and wn.id != nd.id:
                    wr[wn.id, nd.id] = True
                    expl[("wr", wn.id, nd.id)] = lambda nd=nd, wn=wn, k=k, lst=lst: (
                        f"{_t(nd)}'s read of {k!r} ([:r {k!r} {lst!r}]) observed "
                        f"{lst[-1]!r} as its final element, which {_t(wn)} "
                        f"appended ([:append {k!r} {lst[-1]!r}])"
                    )
            pos = len(lst)
            if pos < len(order):
                nxt = appender.get((k, order[pos]))
                if nxt is not None and nxt.id != nd.id:
                    rw[nd.id, nxt.id] = True
                    expl[("rw", nd.id, nxt.id)] = lambda nd=nd, nxt=nxt, k=k, lst=lst, nv=order[pos]: (
                        f"{_t(nd)}'s read of {k!r} ([:r {k!r} {lst!r}]) did not "
                        f"observe {nv!r}, which {_t(nxt)} appended next "
                        f"in the version order ([:append {k!r} {nv!r}])"
                    )

    return TxnGraph(
        nodes=nodes,
        ww=ww,
        wr=wr,
        rw=rw,
        extra=build_extra(nodes, additional_graphs),
        explanations=expl,
        anomalies=anomalies,
    )


# ---------------------------------------------------------------------------
# rw-register inference (elle.rw-register equivalent)
# ---------------------------------------------------------------------------


def rw_register_graph(
    history: Sequence[dict],
    additional_graphs: Sequence[str] = (),
    sequential_keys: bool = False,
    linearizable_keys: bool = False,
    engine: str | None = None,
    pairs=None,
) -> TxnGraph:
    """Infer the dependency graph for unique-write register transactions.

    Only wr edges are directly observable.  With ``linearizable_keys`` (per
    tests/cycle/wr.clj:25-27) each key is assumed independently
    linearizable, so the realtime completion order of its writers yields a
    version order (hence ww/rw edges); ``sequential_keys`` uses invocation
    order instead (weaker: per-process program order lifted to a total
    order).

    ``engine`` routes like ``list_append_graph``'s (vectorized columns by
    default, loop reference on fallback — identical results)."""
    if resolve_engine(engine) == "columns":
        from jepsen_tpu_torch.checker import txn_columns as tc

        try:
            return tc.rw_register_graph_columns(
                history, additional_graphs,
                sequential_keys=sequential_keys,
                linearizable_keys=linearizable_keys, pairs=pairs,
            )
        except tc.NotColumnizable:
            # the loop reference below gives the same graph
            obs.counter("elle.columns_fallback", workload="rw-register")
    return rw_register_graph_loops(
        history, additional_graphs, sequential_keys=sequential_keys,
        linearizable_keys=linearizable_keys, pairs=pairs,
    )


def rw_register_graph_loops(
    history: Sequence[dict],
    additional_graphs: Sequence[str] = (),
    sequential_keys: bool = False,
    linearizable_keys: bool = False,
    pairs=None,
) -> TxnGraph:
    """The loop reference for ``rw_register_graph`` (differential oracle
    + fallback; see ``list_append_graph_loops``)."""
    nodes = txn_nodes(history, pairs)
    n = len(nodes)
    ww, wr, rw = _empty(n), _empty(n), _empty(n)
    expl: dict = {}
    anomalies: dict[str, list] = {}

    def add_anom(name: str, item) -> None:
        anomalies.setdefault(name, []).append(item)

    for nd in nodes:
        if nd.ok:
            for a in _internal_anomalies_wr(nd):
                add_anom("internal", a)

    writer: dict = {}  # (k, v) -> node
    for nd in nodes:
        for k, v in t.ext_writes(nd.value).items():
            if (k, v) in writer:
                add_anom(
                    "duplicate-writes",
                    {"key": k, "value": v, "ops": [writer[(k, v)].op, nd.op]},
                )
            else:
                writer[(k, v)] = nd

    failed = _failed_writes(history, append=False)
    inter = _intermediate_writes(nodes)

    reads: list[tuple[TxnNode, Any, Any]] = []  # (node, key, value)
    for nd in nodes:
        if not nd.ok:
            continue
        for k, v in t.ext_reads(nd.value).items():
            reads.append((nd, k, v))

    for nd, k, v in reads:
        if v is None:
            continue
        if (k, v) in failed:
            add_anom("G1a", {"op": nd.op, "key": k, "value": v, "writer": failed[(k, v)]})
            continue
        if (k, v) in inter:
            wnode, _ = inter[(k, v)]
            add_anom("G1b", {"op": nd.op, "key": k, "value": v, "writer": wnode.op})
        wn = writer.get((k, v))
        if wn is not None and wn.id != nd.id:
            wr[wn.id, nd.id] = True
            expl[("wr", wn.id, nd.id)] = lambda nd=nd, wn=wn, k=k, v=v: (
                f"{_t(nd)}'s read of {k!r} ([:r {k!r} {v!r}]) observed the "
                f"value {_t(wn)} wrote ([:w {k!r} {v!r}])"
            )

    # -- Version orders under per-key ordering assumptions
    if sequential_keys or linearizable_keys:
        by_key: dict[Any, list[tuple[int, Any, TxnNode]]] = {}
        for (k, v), nd in writer.items():
            sort_key = nd.complete_index if linearizable_keys else nd.invoke_index
            by_key.setdefault(k, []).append((sort_key, v, nd))
        readers: dict[Any, list[tuple[TxnNode, Any]]] = {}
        for nd, k, v in reads:
            readers.setdefault(k, []).append((nd, v))
        for k, writes in by_key.items():
            writes.sort(key=lambda x: x[0])
            order = [None] + [v for _, v, _ in writes]
            wnodes = {v: nd for _, v, nd in writes}
            for a, b in zip(order, order[1:]):
                na, nb = wnodes.get(a), wnodes.get(b)
                if na is not None and nb is not None and na.id != nb.id:
                    ww[na.id, nb.id] = True
                    expl[("ww", na.id, nb.id)] = lambda na=na, nb=nb, a=a, b=b, k=k: (
                        f"{_t(na)} wrote {k!r} = {a!r} ([:w {k!r} {a!r}]) and "
                        f"{_t(nb)} overwrote it with {b!r} ([:w {k!r} {b!r}]) "
                        f"in {k!r}'s version order"
                    )
            pos_of = {v: i for i, v in enumerate(order)}
            for nd, v in readers.get(k, ()):
                if v not in pos_of:
                    continue
                pos = pos_of[v]
                if pos + 1 < len(order):
                    nxt = wnodes.get(order[pos + 1])
                    if nxt is not None and nxt.id != nd.id:
                        rw[nd.id, nxt.id] = True
                        expl[("rw", nd.id, nxt.id)] = lambda nd=nd, nxt=nxt, k=k, v=v, nv=order[pos + 1]: (
                            f"{_t(nd)}'s read of {k!r} ([:r {k!r} {v!r}]) did "
                            f"not observe {nv!r}, which {_t(nxt)} "
                            f"wrote next in the version order "
                            f"([:w {k!r} {nv!r}])"
                        )

    return TxnGraph(
        nodes=nodes,
        ww=ww,
        wr=wr,
        rw=rw,
        extra=build_extra(nodes, additional_graphs),
        explanations=expl,
        anomalies=anomalies,
    )


# ---------------------------------------------------------------------------
# Batched inference (the pass independent.checker's check_batch routes
# through)
# ---------------------------------------------------------------------------


def list_append_graphs(
    histories: Sequence[Sequence[dict]],
    additional_graphs: Sequence[str] = (),
    engine: str | None = None,
) -> list[TxnGraph]:
    """Infer MANY list-append histories under one shared pass: the
    engine is resolved once, and every graph comes out carrying its
    sparse edge arrays so the batch classification sweep never scans a
    dense matrix."""
    engine = resolve_engine(engine)
    with obs.span(
        "elle.infer_batch", histories=len(histories),
        workload="list-append", engine=engine,
    ):
        return [
            list_append_graph(hh, additional_graphs, engine=engine)
            for hh in histories
        ]


def rw_register_graphs(
    histories: Sequence[Sequence[dict]],
    additional_graphs: Sequence[str] = (),
    sequential_keys: bool = False,
    linearizable_keys: bool = False,
    engine: str | None = None,
) -> list[TxnGraph]:
    """Batched form of ``rw_register_graph`` (see
    ``list_append_graphs``)."""
    engine = resolve_engine(engine)
    with obs.span(
        "elle.infer_batch", histories=len(histories),
        workload="rw-register", engine=engine,
    ):
        return [
            rw_register_graph(
                hh, additional_graphs, sequential_keys=sequential_keys,
                linearizable_keys=linearizable_keys, engine=engine,
            )
            for hh in histories
        ]
