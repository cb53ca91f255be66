"""Column-native transaction-graph inference (the vectorized elle engine).

The port's copy of the JAX package's ``checker.txn_columns``: the
per-op/per-mop Python loops of :mod:`checker.txn_graph` rebuilt as flat
int64 column operations over numpy:

  * **node extraction** — op-type masks and pair-index gathers over the
    history's SoA columns.  A stored ``history.ColumnHistory`` feeds its
    ``.cols`` arrays straight in (``store.format.read_columns``), so
    checking a disk history never rehydrates op dicts; plain dict
    histories pay one thin column-building pass and then ride the same
    vectorized core.
  * **mop columns** — every micro-op flattened to ``(node, pos, key,
    is_read, value)`` rows with interned key codes; external reads,
    intermediate writes, duplicate detection, and version orders are
    ``np.argsort``/``np.searchsorted`` key-group operations instead of
    dict folds.
  * **pair lookups** — ``(key, value)`` maps (appender / writer / failed
    / intermediate) are packed into single int64 codes and resolved by
    binary search, preserving Python's int equality semantics exactly
    (``True == 1`` included, since bools coerce to the same codes).

Anomaly *emission* stays host-side Python — anomalies are rare, and the
emitted dicts must reference the original op/mop objects so results are
bit-identical with the loop reference (`txn_graph.list_append_graph_loops`
/ ``rw_register_graph_loops``, retained as the differential oracle).
Nodes and per-edge explanations materialize lazily: only ops on a
witness cycle (or in an anomaly) ever build a dict.

Histories whose mop values are not machine-int-packable (strings,
floats, huge ints past the packing range) raise :class:`NotColumnizable`
and the front door in ``txn_graph`` falls back to the loop reference —
identical results, loop-reference speed.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs

_I64 = np.int64
_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min


class NotColumnizable(Exception):
    """This history's values can't ride int64 columns; use the loops."""


# ---------------------------------------------------------------------------
# Small array helpers
# ---------------------------------------------------------------------------


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenated aranges: ``[s0, s0+l0) ++ [s1, s1+l1) ++ ...``."""
    starts = np.asarray(starts, _I64)
    lens = np.asarray(lens, _I64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, _I64)
    before = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return np.repeat(starts - before, lens) + np.arange(total, dtype=_I64)


def _int_array(vals: list) -> np.ndarray:
    """int64 array from a list of Python ints (NotColumnizable otherwise:
    floats/strings/objects must not silently coerce — 1.5 != 1)."""
    if not vals:
        return np.zeros(0, _I64)
    arr = np.asarray(vals)
    if arr.dtype.kind not in ("i", "u"):
        raise NotColumnizable(f"non-integer values (dtype {arr.dtype})")
    if arr.dtype.kind == "u" and len(arr) and int(arr.max()) > 2**62:
        raise NotColumnizable("unsigned values past the packing range")
    return arr.astype(_I64, copy=False)


def _vals_with_none(raw: list) -> tuple[np.ndarray, np.ndarray]:
    """(int64 array, none-mask) for a value list that may contain None
    (``nil`` mop values); the sentinel is substituted once the global
    value range is known."""
    if not raw:
        return np.zeros(0, _I64), np.zeros(0, bool)
    none = np.fromiter((x is None for x in raw), bool, len(raw))
    filled = [0 if x is None else x for x in raw]
    return _int_array(filled), none


class _ValuePool:
    """Collects every value array that participates in a ``(key, value)``
    identity, then packs (key, value) pairs into single int64 codes.
    ``None`` maps to a sentinel strictly below the observed minimum, so
    it can never collide with a real value."""

    def __init__(self, n_keys: int):
        self.n_keys = max(1, int(n_keys))
        self._arrays: list[tuple[np.ndarray, np.ndarray]] = []

    def add(self, arr: np.ndarray, none_mask: np.ndarray | None = None):
        if none_mask is None:
            none_mask = np.zeros(len(arr), bool)
        self._arrays.append((arr, none_mask))
        return arr, none_mask

    def finalize(self) -> None:
        vmin, vmax = _I64_MAX, _I64_MIN
        for arr, none in self._arrays:
            real = arr[~none] if none.any() else arr
            if len(real):
                vmin = min(vmin, int(real.min()))
                vmax = max(vmax, int(real.max()))
        if vmin > vmax:  # no real values at all
            vmin = vmax = 0
        if vmin <= _I64_MIN + 1:
            raise NotColumnizable("values reach the packing range floor")
        self.none_code = vmin - 1
        self.vmin = self.none_code
        span = vmax - self.vmin + 1
        if span <= 0 or span > (2**62) // self.n_keys:
            raise NotColumnizable("value range too wide to pack with keys")
        self.span = span
        for arr, none in self._arrays:
            if none.any():
                arr[none] = self.none_code

    def pack(self, keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """(key code, value) -> one sortable int64."""
        return keys.astype(_I64) * self.span + (vals - self.vmin)


class _PackedMap:
    """Sorted (packed-code -> source-row) map with binary-search lookup.
    ``keep`` selects which duplicate wins — "first" mirrors dict
    ``setdefault`` maps (appender/writer), "last" mirrors plain
    assignment maps (failed/intermediate writes)."""

    def __init__(self, packed: np.ndarray, keep: str = "first"):
        order = np.argsort(packed, kind="stable")
        sp = packed[order]
        if len(sp) == 0:
            self.packed = sp
            self.rows = order
            self.dup_rows = order
            return
        first = np.ones(len(sp), bool)
        first[1:] = sp[1:] != sp[:-1]
        if keep == "first":
            sel = first
        else:
            sel = np.ones(len(sp), bool)
            sel[:-1] = sp[1:] != sp[:-1]
        self.packed = sp[sel]
        self.rows = order[sel]
        #: source rows that lost the "first" race (duplicate detection).
        self.dup_rows = np.sort(order[~first])

    def lookup(self, q: np.ndarray) -> np.ndarray:
        """Source row per query code, -1 when absent."""
        if len(self.packed) == 0:
            return np.full(len(q), -1, _I64)
        pos = np.searchsorted(self.packed, q)
        pos_c = np.minimum(pos, len(self.packed) - 1)
        hit = self.packed[pos_c] == q
        return np.where(hit, self.rows[pos_c], _I64(-1))


# ---------------------------------------------------------------------------
# Node columns (the op-level front end)
# ---------------------------------------------------------------------------

_CODE_OTHER = 4  # op types outside invoke/ok/fail/info (never a node)


def pair_index_codes(type_codes: np.ndarray, proc_codes: np.ndarray) -> np.ndarray:
    """Vectorized ``history.pair_index`` over type/process code columns:
    a completion pairs with its process-group predecessor iff that
    predecessor is an invoke (the open-slot-overwrite semantics of the
    dict walk, proven equivalent: a second invoke overwrites the open
    slot, and any completion consumes it)."""
    n = len(type_codes)
    pair = np.full(n, -1, _I64)
    if n < 2:
        return pair
    order = np.argsort(proc_codes, kind="stable")
    t = type_codes[order]
    p = proc_codes[order]
    link = (p[1:] == p[:-1]) & (t[:-1] == 0) & (t[1:] != 0)
    a = order[:-1][link]
    b = order[1:][link]
    pair[a] = b
    pair[b] = a
    return pair


def _column_value(hist: h.ColumnHistory, i: int):
    """One op's value straight off the columns/sidecar — no op dict."""
    ex = hist.extras.get(i)
    if ex is not None and "value" in ex:
        return ex["value"]
    c = hist.cols
    v = h.decode_register_value(None, int(c["value1"][i]), int(c["value2"][i]))
    if ex is not None and ex.get("value-tuple?") and isinstance(v, list):
        v = tuple(v)
    return v


class NodeColumns:
    """Transaction nodes as flat arrays (complete/invoke op index, ok
    mask, process codes) plus each node's raw txn value.  ``node_op``
    materializes an op dict lazily — witness/anomaly emission only."""

    __slots__ = ("hist", "pair", "complete", "invoke", "ok", "proc",
                 "values", "fail_idx", "_fail_vals")

    def __init__(self, history, pairs=None):
        self.hist = history
        if isinstance(history, h.ColumnHistory):
            self._from_columns(history, pairs)
        else:
            self._from_dicts(history, pairs)

    # -- construction -----------------------------------------------------

    def _from_columns(self, hist: h.ColumnHistory, pairs):
        cols = hist.cols
        n = len(cols["type"])
        type_c = cols["type"].astype(_I64, copy=False)
        proc_c = cols["process"].astype(_I64, copy=True)
        # client test must mirror the materialized view: ONLY the
        # NEMESIS_PID sentinel (-1) maps back to "nemesis"; any other
        # pid — negative ones included — materializes as an int client
        # (non-int processes ride extras overrides, handled below)
        client = proc_c != int(h.NEMESIS_PID)
        over_t = [i for i, ex in hist.extras.items() if "type" in ex]
        over_p = [i for i, ex in hist.extras.items() if "process" in ex]
        if over_t:
            type_c = type_c.copy()
            type_c[np.asarray(over_t, _I64)] = _CODE_OTHER
        if over_p:
            # non-int process overrides: never client, and each distinct
            # value gets a fresh code so pair matching can't merge them
            idx = np.asarray(over_p, _I64)
            client[idx] = False
            base = int(proc_c.max()) + 1 if n else 0
            codes: dict = {}
            for i in over_p:
                key = repr(hist.extras[i]["process"])
                proc_c[i] = base + codes.setdefault(key, len(codes))
        self._finish(type_c, proc_c, client, pairs,
                     lambda i: _column_value(hist, i))

    def _from_dicts(self, history, pairs):
        n = len(history)
        type_c = np.empty(n, _I64)
        proc_c = np.empty(n, _I64)
        client = np.empty(n, bool)
        vals: list = [None] * n
        codes: dict = {}
        tcodes = h.TYPE_CODES
        for i, o in enumerate(history):
            type_c[i] = tcodes.get(o["type"], _CODE_OTHER)
            p = o["process"]
            client[i] = isinstance(p, int)
            try:
                proc_c[i] = codes.setdefault(p, len(codes))
            except TypeError:  # unhashable process: its own group
                proc_c[i] = codes.setdefault(repr(p), len(codes))
            vals[i] = o.get("value")
        self._finish(type_c, proc_c, client, pairs, lambda i: vals[i])

    def _finish(self, type_c, proc_c, client, pairs, value_at):
        if pairs is not None:
            self.pair = np.asarray(pairs, _I64)
        else:
            self.pair = pair_index_codes(type_c, proc_c)
        sel = client & ((type_c == 1) | (type_c == 3))  # ok | info
        ci = np.flatnonzero(sel).astype(_I64)
        inv = self.pair[ci]
        self.complete = ci
        self.invoke = np.where(inv != -1, inv, ci)
        self.ok = type_c[ci] == 1
        self.proc = proc_c[ci]
        values = []
        for k in range(len(ci)):
            i = int(ci[k])
            v = value_at(i)
            if not self.ok[k] and v is None:
                j = int(self.pair[i])
                if j != -1:
                    v = value_at(j)
            values.append(v)
        self.values = values
        self.fail_idx = np.flatnonzero(client & (type_c == 2)).astype(_I64)
        self._fail_vals = None

    # -- lazy op access ---------------------------------------------------

    @property
    def n(self) -> int:
        return len(self.complete)

    def node_op(self, i: int) -> dict:
        ci = int(self.complete[i])
        op = self.hist[ci]
        if not self.ok[i] and op.get("value") is None:
            j = int(self.pair[ci])
            if j != -1:
                op = {**op, "value": self.hist[j].get("value")}
        return op

    def fail_values(self) -> list:
        """Each client fail op's value (for failed-write maps)."""
        if self._fail_vals is None:
            if isinstance(self.hist, h.ColumnHistory):
                self._fail_vals = [
                    _column_value(self.hist, int(i)) for i in self.fail_idx
                ]
            else:
                self._fail_vals = [
                    self.hist[int(i)].get("value") for i in self.fail_idx
                ]
        return self._fail_vals


class LazyNodes(Sequence):
    """``TxnGraph.nodes`` as a lazily-materializing sequence: node ``i``
    builds its :class:`txn_graph.TxnNode` (and its op dict) only when a
    witness/anomaly path touches it."""

    def __init__(self, nc: NodeColumns):
        self._nc = nc
        self._cache: dict[int, object] = {}

    def __len__(self) -> int:
        return self._nc.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        i = int(i)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        nd = self._cache.get(i)
        if nd is None:
            from jepsen_tpu_torch.checker.txn_graph import TxnNode

            nc = self._nc
            nd = TxnNode(
                id=i,
                op=nc.node_op(i),
                invoke_index=int(nc.invoke[i]),
                complete_index=int(nc.complete[i]),
                ok=bool(nc.ok[i]),
            )
            self._cache[i] = nd
        return nd


# ---------------------------------------------------------------------------
# Mop columns
# ---------------------------------------------------------------------------


class MopColumns:
    """Every micro-op of every node, flattened: ``(node, pos, key code,
    is_read, is_append)`` plus raw write values (ints/None enforced)."""

    __slots__ = ("node", "pos", "key", "isread", "isappend",
                 "w_rows", "w_raw", "key_objs", "n_keys")

    def __init__(self, nc: NodeColumns):
        m_node: list = []
        m_pos: list = []
        m_key: list = []
        m_isread: list = []
        m_isapp: list = []
        w_rows: list = []
        w_raw: list = []
        keys: dict = {}
        key_objs: list = []
        row = 0
        for i, v in enumerate(nc.values):
            for pos, mop in enumerate(v or ()):
                f, k = mop[0], mop[1]
                try:
                    kc = keys.get(k)
                except TypeError:
                    raise NotColumnizable("unhashable mop key")
                if kc is None:
                    kc = keys[k] = len(key_objs)
                    key_objs.append(k)
                m_node.append(i)
                m_pos.append(pos)
                m_key.append(kc)
                rd = f == "r"
                m_isread.append(rd)
                m_isapp.append(f == "append")
                if not rd:
                    w_rows.append(row)
                    w_raw.append(mop[2])
                row += 1
        self.node = np.asarray(m_node, _I64)
        self.pos = np.asarray(m_pos, _I64)
        self.key = np.asarray(m_key, _I64)
        self.isread = np.asarray(m_isread, bool)
        self.isappend = np.asarray(m_isapp, bool)
        self.w_rows = np.asarray(w_rows, _I64)
        self.w_raw = w_raw
        self.key_objs = key_objs
        self.n_keys = len(key_objs)

    def ext_read_rows(self) -> np.ndarray:
        """Mop rows that are EXTERNAL reads (first touch of their key in
        their txn; ``txn.ext_reads`` semantics), ascending row order."""
        if len(self.node) == 0:
            return np.zeros(0, _I64)
        order = np.lexsort((self.pos, self.key, self.node))
        first = np.ones(len(order), bool)
        first[1:] = ~(
            (self.node[order][1:] == self.node[order][:-1])
            & (self.key[order][1:] == self.key[order][:-1])
        )
        rows = order[first & self.isread[order]]
        rows.sort()
        return rows

    def repeat_read_nodes(self, ok: np.ndarray) -> np.ndarray:
        """Ok nodes with a read of an already-touched key — the only
        candidates for internal anomalies (superset; the host check
        decides).  Sorted ascending (the reference's node order)."""
        if len(self.node) == 0:
            return np.zeros(0, _I64)
        order = np.lexsort((self.pos, self.key, self.node))
        again = np.zeros(len(order), bool)
        again[1:] = (
            (self.node[order][1:] == self.node[order][:-1])
            & (self.key[order][1:] == self.key[order][:-1])
        )
        cand = np.unique(self.node[order[again & self.isread[order]]])
        return cand[ok[cand]]

    def consecutive_writes(self) -> tuple[np.ndarray, np.ndarray]:
        """(from_row, to_row) for in-txn consecutive writes to one key —
        ``_intermediate_writes`` rows: observing ``from``'s value
        without ``to``'s is G1b."""
        w = np.flatnonzero(~self.isread)
        if len(w) < 2:
            return np.zeros(0, _I64), np.zeros(0, _I64)
        order = np.lexsort((self.pos[w], self.key[w], self.node[w]))
        ws = w[order]
        adj = (self.node[ws][1:] == self.node[ws][:-1]) & (
            self.key[ws][1:] == self.key[ws][:-1]
        )
        return ws[:-1][adj], ws[1:][adj]


def _failed_write_rows(nc: NodeColumns, mc: MopColumns, fname: str):
    """(op index, key code, raw value) rows for client FAIL ops' write
    mops (``_failed_writes`` semantics).  Keys no node ever touched are
    dropped — no read can observe them, so they never match."""
    f_ops: list = []
    f_key: list = []
    f_raw: list = []
    key_index = {}
    for c, k in enumerate(mc.key_objs):
        try:
            key_index[k] = c
        except TypeError:
            raise NotColumnizable("unhashable mop key")
    for fi, fv in zip(nc.fail_idx, nc.fail_values()):
        for mop in fv or ():
            if mop[0] == fname:
                try:
                    code = key_index.get(mop[1], -1)
                except TypeError:
                    raise NotColumnizable("unhashable mop key")
                if code == -1:
                    continue
                f_ops.append(int(fi))
                f_key.append(code)
                f_raw.append(mop[2])
    return f_ops, f_key, f_raw


# ---------------------------------------------------------------------------
# Lazy per-edge explanations
# ---------------------------------------------------------------------------


class LazyExplanations(Mapping):
    """``TxnGraph.explanations`` backed by edge-id arrays: ``get((et, i,
    j))`` binary-searches the winner table for that edge type and renders
    the prose on demand — no per-edge closures, identical text to the
    loop reference's lambdas.  Payload columns are renderer-specific row
    indices into the graph constructor's column state."""

    def __init__(self, n: int, nodes: LazyNodes):
        self._n = max(1, int(n))
        self._nodes = nodes
        #: et -> (sorted eid array, payload row arrays tuple, render fn)
        self._tables: dict[str, tuple] = {}

    def add_table(self, et: str, eids: np.ndarray, payload: tuple, render):
        order = np.argsort(eids, kind="stable")
        self._tables[et] = (
            eids[order], tuple(p[order] for p in payload), render,
        )

    def _find(self, key):
        if not (isinstance(key, tuple) and len(key) == 3):
            return None
        et, i, j = key
        tab = self._tables.get(et)
        if tab is None:
            return None
        eids, payload, render = tab
        q = int(i) * self._n + int(j)
        pos = int(np.searchsorted(eids, q))
        if pos >= len(eids) or int(eids[pos]) != q:
            return None
        return render(int(i), int(j), *(int(p[pos]) for p in payload))

    def get(self, key, default=None):
        v = self._find(key)
        return default if v is None else v

    def __getitem__(self, key):
        v = self._find(key)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key):
        return self._find(key) is not None

    def __len__(self):
        return sum(len(t[0]) for t in self._tables.values())

    def __iter__(self):
        for et, (eids, _p, _r) in self._tables.items():
            for e in eids:
                yield (et, int(e) // self._n, int(e) % self._n)


def _keep_last(eids: np.ndarray) -> np.ndarray:
    """Indices of the LAST occurrence per edge id (the loop reference's
    dict assignment overwrites; occurrence order must already be the
    loop's iteration order)."""
    if len(eids) == 0:
        return np.zeros(0, _I64)
    order = np.argsort(eids, kind="stable")
    se = eids[order]
    last = np.ones(len(se), bool)
    last[:-1] = se[1:] != se[:-1]
    return order[last]


def _edge_pairs(eids: np.ndarray, n: int) -> np.ndarray:
    """Unique sorted (i, j) rows from edge ids — the ``np.argwhere``
    order, without scanning a dense matrix."""
    if len(eids) == 0:
        return np.zeros((0, 2), _I64)
    u = np.unique(eids)
    return np.stack([u // n, u % n], axis=1)


def _read_key_ranks(r_key: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(unique key codes sorted, appearance rank per unique key, rank per
    read) — ``reads_by_key`` iterates keys in first-appearance order."""
    uk, ufirst = np.unique(r_key, return_index=True)
    rank = np.empty(len(uk), _I64)
    rank[np.argsort(ufirst, kind="stable")] = np.arange(len(uk), dtype=_I64)
    r_rank = rank[np.searchsorted(uk, r_key)]
    return uk, rank, r_rank


# ---------------------------------------------------------------------------
# list-append inference
# ---------------------------------------------------------------------------


def list_append_graph_columns(history, additional_graphs=(), pairs=None):
    """Vectorized ``txn_graph.list_append_graph`` — identical nodes,
    edges, anomalies, and explanation prose (differential-tested against
    the loop reference)."""
    from jepsen_tpu_torch.checker import txn_graph as tg

    with obs.span("elle.nodes", workload="list-append"):
        nc = NodeColumns(history, pairs)
        n = nc.n
        nodes = LazyNodes(nc)
        mc = MopColumns(nc)
        ok = nc.ok

        # external reads of OK nodes, with their element lists flattened
        er = mc.ext_read_rows()
        er = er[ok[mc.node[er]]]
        r_node = mc.node[er]
        r_key = mc.key[er]
        r_list: list = []
        flat: list = []
        for row in er:
            v = nc.values[int(mc.node[row])][int(mc.pos[row])][2]
            lst = list(v or [])
            r_list.append(lst)
            flat.extend(lst)
        r_len = np.asarray([len(x) for x in r_list], _I64)
        r_off = np.concatenate(([0], np.cumsum(r_len)))[:-1] if len(r_list) \
            else np.zeros(0, _I64)

        pool = _ValuePool(mc.n_keys)
        e_val, _ = pool.add(_int_array(flat))
        w_val, w_none = pool.add(*_vals_with_none(mc.w_raw))
        # failed client writes ((key, value) -> op; "append" mops only)
        f_ops, f_key, f_raw = _failed_write_rows(nc, mc, fname="append")
        f_val, f_none = pool.add(*_vals_with_none(f_raw))
        pool.finalize()
        f_key_arr = np.asarray(f_key, _I64)
        f_packed = pool.pack(f_key_arr, f_val) if len(f_val) else \
            np.zeros(0, _I64)
        failed = _PackedMap(f_packed, keep="last")

    anomalies: dict[str, list] = {}

    def add_anom(name, item):
        anomalies.setdefault(name, []).append(item)

    with obs.span("elle.anomalies", workload="list-append"):
        # -- internal (ok nodes that re-read a touched key; host check)
        cand = mc.repeat_read_nodes(ok)
        for i in cand:
            for a in tg._internal_anomalies_append(nodes[int(i)]):
                add_anom("internal", a)

        # -- appender map + duplicate appends (all nodes, scan order)
        ap = np.flatnonzero(mc.isappend)
        ap_in_w = np.searchsorted(mc.w_rows, ap)  # appends ⊆ writes
        ap_packed = pool.pack(mc.key[ap], w_val[ap_in_w])
        appender = _PackedMap(ap_packed, keep="first")
        ap_node = mc.node[ap]

        def _appender_node(rows):
            """appender row -> node id (-1 when absent)."""
            if len(ap_node) == 0:
                return np.full(len(rows), -1, _I64)
            return np.where(rows >= 0, ap_node[np.maximum(rows, 0)], _I64(-1))

        for d in appender.dup_rows:
            row = int(ap[d])
            first = int(ap_node[appender.lookup(ap_packed[d : d + 1])[0]])
            mop = nc.values[int(mc.node[row])][int(mc.pos[row])]
            add_anom(
                "duplicate-elements",
                {"key": mop[1], "element": mop[2],
                 "ops": [nodes[first].op, nodes[int(mc.node[row])].op]},
            )

        # -- intermediate writes (non-final in-txn writes; last-wins map)
        iw_from, iw_to = mc.consecutive_writes()
        iw_packed = pool.pack(
            mc.key[iw_from], w_val[np.searchsorted(mc.w_rows, iw_from)]
        )
        inter = _PackedMap(iw_packed, keep="last")
        iw_node = mc.node[iw_from]
        iw_next = w_val[np.searchsorted(mc.w_rows, iw_to)]

        # -- G1a / G1b over read contents (flat element occurrences)
        E = len(e_val)
        if E:
            e_read = np.repeat(np.arange(len(r_list), dtype=_I64), r_len)
            e_pos = np.arange(E, dtype=_I64) - r_off[e_read]
            e_packed = pool.pack(r_key[e_read], e_val)
            uk, k_rank, r_rank = _read_key_ranks(r_key)

            g1a = failed.lookup(e_packed)
            g1a_idx = np.flatnonzero(g1a >= 0)
            if len(g1a_idx):
                order = np.lexsort(
                    (e_pos[g1a_idx], e_read[g1a_idx],
                     r_rank[e_read[g1a_idx]])
                )
                for x in g1a_idx[order]:
                    ri = int(e_read[x])
                    fr = int(g1a[x])
                    add_anom(
                        "G1a",
                        {"op": nodes[int(r_node[ri])].op,
                         "key": mc.key_objs[int(r_key[ri])],
                         "element": r_list[ri][int(e_pos[x])],
                         "writer": nc.hist[int(f_ops[fr])]},
                    )

            g1b = inter.lookup(e_packed)
            hit = np.flatnonzero(g1b >= 0)
            if len(hit):
                has_next = e_pos[hit] + 1 < r_len[e_read[hit]]
                nxt = np.where(
                    has_next, e_val[np.minimum(hit + 1, E - 1)], _I64(0)
                )
                want = iw_next[g1b[hit]]
                flag = hit[~(has_next & (nxt == want))]
                order = np.lexsort(
                    (e_pos[flag], e_read[flag], r_rank[e_read[flag]])
                )
                for x in flag[order]:
                    ri = int(e_read[x])
                    add_anom(
                        "G1b",
                        {"op": nodes[int(r_node[ri])].op,
                         "key": mc.key_objs[int(r_key[ri])],
                         "element": r_list[ri][int(e_pos[x])],
                         "writer": nodes[int(iw_node[g1b[x]])].op},
                    )
        else:
            e_read = np.zeros(0, _I64)
            e_pos = np.zeros(0, _I64)
            uk, k_rank, r_rank = _read_key_ranks(r_key)

    ww = np.zeros((n, n), dtype=bool)
    wr = np.zeros((n, n), dtype=bool)
    rw = np.zeros((n, n), dtype=bool)
    expl = LazyExplanations(n, nodes)
    edge_out: dict[str, np.ndarray] = {}
    NK = len(uk)

    with obs.span("elle.edges", workload="list-append"):
        # -- version order per key: the longest read wins; prefix check
        if NK:
            korder = np.lexsort((np.arange(len(r_key)), -r_len, r_rank))
            kfirst = np.ones(len(korder), bool)
            kfirst[1:] = r_rank[korder][1:] != r_rank[korder][:-1]
            longest_ri = np.empty(NK, _I64)
            longest_ri[r_rank[korder[kfirst]]] = korder[kfirst]
            key_off = r_off[longest_ri]
            key_len = r_len[longest_ri]
            kcode_by_rank = np.empty(NK, _I64)
            kcode_by_rank[k_rank] = uk

            if len(e_val):
                lpos = key_off[r_rank[e_read]] + e_pos
                mismatch = e_val != e_val[lpos]
                bad_reads = np.unique(e_read[mismatch])
            else:
                bad_reads = np.zeros(0, _I64)
            bad_key = np.zeros(NK, bool)
            bad_key[r_rank[bad_reads]] = True
            if len(bad_reads):
                order = np.argsort(r_rank[bad_reads], kind="stable")
                for ri in bad_reads[order]:
                    ri = int(ri)
                    add_anom(
                        "incompatible-order",
                        {"key": mc.key_objs[int(r_key[ri])],
                         "read": r_list[ri],
                         "longest": r_list[int(longest_ri[r_rank[ri]])],
                         "op": nodes[int(r_node[ri])].op},
                    )
            good = np.flatnonzero(~bad_key)  # ascending key rank

            # -- ww: consecutive observed appends in each version order
            pair_cnt = np.maximum(key_len[good] - 1, 0)
            pa = _ranges(key_off[good], pair_cnt)
            occ_rank = np.repeat(good, pair_cnt)
            na = _appender_node(
                appender.lookup(pool.pack(kcode_by_rank[occ_rank], e_val[pa]))
            )
            nb = _appender_node(
                appender.lookup(
                    pool.pack(kcode_by_rank[occ_rank], e_val[pa + 1])
                )
            )
            ok_pair = (na >= 0) & (nb >= 0) & (na != nb)
            na, nb = na[ok_pair], nb[ok_pair]
            occ_rank_ww = occ_rank[ok_pair]
            occ_pos = (pa - key_off[occ_rank])[ok_pair]
            ww[na, nb] = True
            ww_eid = na * n + nb
            win = _keep_last(ww_eid)
            expl.add_table(
                "ww", ww_eid[win], (occ_rank_ww[win], occ_pos[win]),
                _render_ww_append(nodes, mc.key_objs, kcode_by_rank,
                                  r_list, longest_ri),
            )
            edge_out["ww"] = _edge_pairs(ww_eid, n)

            # -- wr / rw per read of a good key
            rr = np.flatnonzero(~bad_key[r_rank])  # reads of good keys
            rr = rr[np.argsort(r_rank[rr], kind="stable")]  # key-major
            nz = rr[r_len[rr] > 0]
            last = e_val[r_off[nz] + r_len[nz] - 1]
            wn = _appender_node(
                appender.lookup(pool.pack(r_key[nz], last))
            )
            okw = (wn >= 0) & (wn != r_node[nz])
            wr_i, wr_j = wn[okw], r_node[nz][okw]
            wr[wr_i, wr_j] = True
            wr_eid = wr_i * n + wr_j
            win = _keep_last(wr_eid)
            expl.add_table(
                "wr", wr_eid[win], (nz[okw][win],),
                _render_wr_append(nodes, mc.key_objs, r_key, r_list),
            )
            edge_out["wr"] = _edge_pairs(wr_eid, n)

            beyond = rr[r_len[rr] < key_len[r_rank[rr]]]
            nv = e_val[key_off[r_rank[beyond]] + r_len[beyond]]
            nx = _appender_node(
                appender.lookup(pool.pack(r_key[beyond], nv))
            )
            okr = (nx >= 0) & (nx != r_node[beyond])
            rw_i, rw_j = r_node[beyond][okr], nx[okr]
            rw[rw_i, rw_j] = True
            rw_eid = rw_i * n + rw_j
            win = _keep_last(rw_eid)
            expl.add_table(
                "rw", rw_eid[win], (beyond[okr][win],),
                _render_rw_append(nodes, mc.key_objs, r_key, r_list,
                                  longest_ri, r_rank),
            )
            edge_out["rw"] = _edge_pairs(rw_eid, n)
        else:
            for et in ("ww", "wr", "rw"):
                edge_out[et] = np.zeros((0, 2), _I64)

        extra = _extra_columns(nc, additional_graphs, n)
        edge_out["extra"] = (
            np.argwhere(extra) if extra.any() else np.zeros((0, 2), _I64)
        )

    return tg.TxnGraph(
        nodes=nodes, ww=ww, wr=wr, rw=rw, extra=extra,
        explanations=expl, anomalies=anomalies, edges=edge_out,
    )


def _extra_columns(nc: NodeColumns, additional_graphs, n: int) -> np.ndarray:
    extra = np.zeros((n, n), dtype=bool)
    for g in additional_graphs:
        if g == "realtime":
            comp = np.where(nc.ok, nc.complete, _I64_MAX)
            extra |= comp[:, None] < nc.invoke[None, :]
        elif g == "process":
            if n:
                order = np.lexsort((nc.invoke, nc.proc))
                same = nc.proc[order][1:] == nc.proc[order][:-1]
                extra[order[:-1][same], order[1:][same]] = True
        else:
            raise ValueError(f"unknown additional graph {g!r}")
    return extra


# -- explanation renderers (prose byte-identical to the loop lambdas) -------


def _tname(nodes, i: int) -> str:
    nd = nodes[i]
    return f"T{nd.op.get('index', nd.id)}"


def _render_ww_append(nodes, key_objs, kcode_by_rank, r_list, longest_ri):
    def render(i, j, rank, pos):
        k = key_objs[int(kcode_by_rank[rank])]
        order = r_list[int(longest_ri[rank])]
        a, b = order[pos], order[pos + 1]
        return (
            f"{_tname(nodes, i)} appended {a!r} to {k!r} ([:append {k!r} {a!r}]) "
            f"and {_tname(nodes, j)} appended {b!r} immediately after it in "
            f"{k!r}'s version order {order!r}"
        )

    return render


def _render_wr_append(nodes, key_objs, r_key, r_list):
    def render(i, j, ri):
        k = key_objs[int(r_key[ri])]
        lst = r_list[ri]
        return (
            f"{_tname(nodes, j)}'s read of {k!r} ([:r {k!r} {lst!r}]) observed "
            f"{lst[-1]!r} as its final element, which {_tname(nodes, i)} "
            f"appended ([:append {k!r} {lst[-1]!r}])"
        )

    return render


def _render_rw_append(nodes, key_objs, r_key, r_list, longest_ri, r_rank):
    def render(i, j, ri):
        k = key_objs[int(r_key[ri])]
        lst = r_list[ri]
        order = r_list[int(longest_ri[int(r_rank[ri])])]
        nv = order[len(lst)]
        return (
            f"{_tname(nodes, i)}'s read of {k!r} ([:r {k!r} {lst!r}]) did not "
            f"observe {nv!r}, which {_tname(nodes, j)} appended next "
            f"in the version order ([:append {k!r} {nv!r}])"
        )

    return render


# ---------------------------------------------------------------------------
# rw-register inference
# ---------------------------------------------------------------------------


def rw_register_graph_columns(history, additional_graphs=(),
                              sequential_keys=False, linearizable_keys=False,
                              pairs=None):
    """Vectorized ``txn_graph.rw_register_graph`` (same differential
    contract as the list-append engine)."""
    from jepsen_tpu_torch.checker import txn_graph as tg

    with obs.span("elle.nodes", workload="rw-register"):
        nc = NodeColumns(history, pairs)
        n = nc.n
        nodes = LazyNodes(nc)
        mc = MopColumns(nc)
        ok = nc.ok

        # external reads (ok nodes): scalar values
        er = mc.ext_read_rows()
        er = er[ok[mc.node[er]]]
        r_node = mc.node[er]
        r_key = mc.key[er]
        r_raw = [nc.values[int(mc.node[x])][int(mc.pos[x])][2] for x in er]

        pool = _ValuePool(mc.n_keys)
        r_val, r_none = pool.add(*_vals_with_none(r_raw))
        w_val, _w_none = pool.add(*_vals_with_none(mc.w_raw))
        f_ops, f_key, f_raw = _failed_write_rows(nc, mc, fname="w")
        f_val, _f_none = pool.add(*_vals_with_none(f_raw))
        pool.finalize()
        failed = _PackedMap(
            pool.pack(np.asarray(f_key, _I64), f_val) if len(f_val)
            else np.zeros(0, _I64),
            keep="last",
        )

    anomalies: dict[str, list] = {}

    def add_anom(name, item):
        anomalies.setdefault(name, []).append(item)

    ww = np.zeros((n, n), dtype=bool)
    wr = np.zeros((n, n), dtype=bool)
    rw = np.zeros((n, n), dtype=bool)
    expl = LazyExplanations(n, nodes)
    edge_out: dict[str, np.ndarray] = {
        et: np.zeros((0, 2), _I64) for et in ("ww", "wr", "rw")
    }

    with obs.span("elle.anomalies", workload="rw-register"):
        # -- internal
        for i in mc.repeat_read_nodes(ok):
            for a in tg._internal_anomalies_wr(nodes[int(i)]):
                add_anom("internal", a)

        # -- writer map (final external writes) + duplicate-writes.
        # ext_writes insertion order = (node, FIRST write pos of key);
        # its value = the LAST write.
        w = mc.w_rows
        ew_first = np.zeros(0, _I64)
        ew_last = np.zeros(0, _I64)
        if len(w):
            order = np.lexsort((mc.pos[w], mc.key[w], mc.node[w]))
            ws = w[order]
            first = np.ones(len(ws), bool)
            first[1:] = ~(
                (mc.node[ws][1:] == mc.node[ws][:-1])
                & (mc.key[ws][1:] == mc.key[ws][:-1])
            )
            last = np.ones(len(ws), bool)
            last[:-1] = first[1:]
            ef, el = ws[first], ws[last]
            ins = np.argsort(ef, kind="stable")  # (node, first-pos) order
            ew_first, ew_last = ef[ins], el[ins]
        ew_key = mc.key[ew_first] if len(ew_first) else np.zeros(0, _I64)
        ew_node = mc.node[ew_first] if len(ew_first) else np.zeros(0, _I64)
        ew_val = (
            w_val[np.searchsorted(w, ew_last)] if len(ew_last)
            else np.zeros(0, _I64)
        )
        ew_val_obj = [mc.w_raw[int(np.searchsorted(w, x))] for x in ew_last]
        ew_packed = pool.pack(ew_key, ew_val)
        writer = _PackedMap(ew_packed, keep="first")
        for d in writer.dup_rows:
            d = int(d)
            firstrow = int(writer.lookup(ew_packed[d : d + 1])[0])
            add_anom(
                "duplicate-writes",
                {"key": mc.key_objs[int(ew_key[d])], "value": ew_val_obj[d],
                 "ops": [nodes[int(ew_node[firstrow])].op,
                         nodes[int(ew_node[d])].op]},
            )

        # -- intermediate writes (non-final in-txn writes; last wins)
        iw_from, _iw_to = mc.consecutive_writes()
        inter = _PackedMap(
            pool.pack(mc.key[iw_from], w_val[np.searchsorted(w, iw_from)])
            if len(iw_from) else np.zeros(0, _I64),
            keep="last",
        )
        iw_node = mc.node[iw_from] if len(iw_from) else np.zeros(0, _I64)

        # -- per-read G1a / G1b / wr (global read order; None skipped).
        # r_packed covers ALL reads (None rides the sentinel code) so the
        # version-order pass can look nil reads up too.
        live = np.flatnonzero(~r_none)
        r_packed = (
            pool.pack(r_key, r_val) if len(r_val) else np.zeros(0, _I64)
        )
        g1a = failed.lookup(r_packed[live]) if len(live) else np.zeros(0, _I64)
        g1b = inter.lookup(r_packed[live]) if len(live) else np.zeros(0, _I64)
        wrow = (writer.lookup(r_packed[live]) if len(live)
                else np.zeros(0, _I64))
        # anomalies are rare — loop only over the hits (read order; a
        # G1a read emits no G1b and, below, no wr edge)
        for x in np.flatnonzero((g1a >= 0) | (g1b >= 0)):
            ri = int(live[x])
            if g1a[x] >= 0:
                add_anom(
                    "G1a",
                    {"op": nodes[int(r_node[ri])].op,
                     "key": mc.key_objs[int(r_key[ri])],
                     "value": r_raw[ri],
                     "writer": nc.hist[int(f_ops[int(g1a[x])])]},
                )
            else:
                add_anom(
                    "G1b",
                    {"op": nodes[int(r_node[ri])].op,
                     "key": mc.key_objs[int(r_key[ri])],
                     "value": r_raw[ri],
                     "writer": nodes[int(iw_node[int(g1b[x])])].op},
                )
        # wr edges, fully vectorized: a live read whose value has a
        # final writer other than itself — unless G1a aborted it
        if len(live) and len(ew_node):
            wn_nodes = ew_node[np.maximum(wrow, 0)]
            ok_wr = (g1a < 0) & (wrow >= 0) & (wn_nodes != r_node[live])
            sel = np.flatnonzero(ok_wr)  # ascending = global read order
            wi = wn_nodes[sel]
            wj = r_node[live[sel]]
            wri = live[sel]
        else:
            wi = wj = wri = np.zeros(0, _I64)
        wr[wi, wj] = True
        wr_eid = wi * n + wj
        win = _keep_last(wr_eid)
        expl.add_table(
            "wr", wr_eid[win], (wri[win],),
            _render_wr_register(nodes, mc.key_objs, r_key, r_raw),
        )
        edge_out["wr"] = _edge_pairs(wr_eid, n)

    with obs.span("elle.edges", workload="rw-register"):
        if (sequential_keys or linearizable_keys) and len(ew_first):
            if (ew_val == pool.none_code).any():
                # A FINAL None write makes the reference's version order
                # contain None twice ([None] prefix + the written nil),
                # with dict-overwrite semantics on pos_of — a corner the
                # loop reference handles exactly; route it there.
                raise NotColumnizable(
                    "nil final write under per-key version orders"
                )
            sort_key = (
                nc.complete[ew_node] if linearizable_keys
                else nc.invoke[ew_node]
            )
            kept = np.sort(writer.rows)  # writer-map insertion order
            kk = ew_key[kept]
            uk, ufirst = np.unique(kk, return_index=True)
            krank_of = np.empty(len(uk), _I64)
            krank_of[np.argsort(ufirst, kind="stable")] = np.arange(
                len(uk), dtype=_I64
            )
            kranks = krank_of[np.searchsorted(uk, kk)]
            # key-major, sort_key-minor, insertion-stable
            order = np.lexsort(
                (np.arange(len(kept)), sort_key[kept], kranks)
            )
            srows = kept[order]
            sranks = kranks[order]
            NKw = len(uk)
            cnt = np.bincount(sranks, minlength=NKw).astype(_I64)
            off = np.concatenate(([0], np.cumsum(cnt)))[:-1]

            # ww: consecutive writes in each key's version order
            pair_cnt = np.maximum(cnt - 1, 0)
            pa = _ranges(off, pair_cnt)
            na = ew_node[srows[pa]]
            nb = ew_node[srows[pa + 1]]
            okp = na != nb
            na, nb, pa_ok = na[okp], nb[okp], pa[okp]
            ww[na, nb] = True
            ww_eid = na * n + nb
            win = _keep_last(ww_eid)
            expl.add_table(
                "ww", ww_eid[win], (pa_ok[win],),
                _render_ww_register(nodes, mc.key_objs, ew_key, ew_val_obj,
                                    srows),
            )
            edge_out["ww"] = _edge_pairs(ww_eid, n)

            # rw: each read (None included) against its key's order
            in_keys = np.searchsorted(uk, r_key)
            in_keys_ok = (in_keys < len(uk))
            if len(r_key):
                in_keys_ok &= uk[np.minimum(in_keys, len(uk) - 1)] == r_key
            rd = np.flatnonzero(in_keys_ok)
            rd_rank = krank_of[in_keys[rd]] if len(rd) else np.zeros(0, _I64)
            # position in [None] + values: None -> 0; else writer row pos
            srow_pos = np.empty(len(ew_first), _I64)
            srow_pos[srows] = np.arange(len(srows), dtype=_I64)
            wrow_rd = writer.lookup(r_packed[rd]) if len(rd) else \
                np.zeros(0, _I64)
            p = np.full(len(rd), -1, _I64)
            p[r_none[rd]] = 0
            hitw = np.flatnonzero(wrow_rd >= 0)
            if len(hitw):
                p[hitw] = srow_pos[wrow_rd[hitw]] - off[rd_rank[hitw]] + 1
            valid = (p >= 0) & (p < cnt[rd_rank])
            rd, p, rd_rank = rd[valid], p[valid], rd_rank[valid]
            # iterate keys in by_key order, reads in global order per key
            order = np.lexsort((rd, rd_rank))
            rd, p, rd_rank = rd[order], p[order], rd_rank[order]
            nxrow = srows[off[rd_rank] + p]
            nx = ew_node[nxrow]
            okr = nx != r_node[rd]
            rw_i = r_node[rd[okr]]
            rw_j = nx[okr]
            rw[rw_i, rw_j] = True
            rw_eid = rw_i * n + rw_j
            win = _keep_last(rw_eid)
            expl.add_table(
                "rw", rw_eid[win], (rd[okr][win], nxrow[okr][win]),
                _render_rw_register(nodes, mc.key_objs, r_key, r_raw,
                                    ew_val_obj),
            )
            edge_out["rw"] = _edge_pairs(rw_eid, n)

        extra = _extra_columns(nc, additional_graphs, n)
        edge_out["extra"] = (
            np.argwhere(extra) if extra.any() else np.zeros((0, 2), _I64)
        )

    return tg.TxnGraph(
        nodes=nodes, ww=ww, wr=wr, rw=rw, extra=extra,
        explanations=expl, anomalies=anomalies, edges=edge_out,
    )


def _render_wr_register(nodes, key_objs, r_key, r_raw):
    def render(i, j, ri):
        k = key_objs[int(r_key[ri])]
        v = r_raw[ri]
        return (
            f"{_tname(nodes, j)}'s read of {k!r} ([:r {k!r} {v!r}]) observed the "
            f"value {_tname(nodes, i)} wrote ([:w {k!r} {v!r}])"
        )

    return render


def _render_ww_register(nodes, key_objs, ew_key, ew_val_obj, srows):
    def render(i, j, pa):
        ra, rb = int(srows[pa]), int(srows[pa + 1])
        k = key_objs[int(ew_key[ra])]
        a, b = ew_val_obj[ra], ew_val_obj[rb]
        return (
            f"{_tname(nodes, i)} wrote {k!r} = {a!r} ([:w {k!r} {a!r}]) and "
            f"{_tname(nodes, j)} overwrote it with {b!r} ([:w {k!r} {b!r}]) "
            f"in {k!r}'s version order"
        )

    return render


def _render_rw_register(nodes, key_objs, r_key, r_raw, ew_val_obj):
    def render(i, j, ri, nxrow):
        k = key_objs[int(r_key[ri])]
        v = r_raw[ri]
        nv = ew_val_obj[int(nxrow)]
        return (
            f"{_tname(nodes, i)}'s read of {k!r} ([:r {k!r} {v!r}]) did "
            f"not observe {nv!r}, which {_tname(nodes, j)} "
            f"wrote next in the version order "
            f"([:w {k!r} {nv!r}])"
        )

    return render
