"""`.jepsen` block file: single-file runs with cheap partial reads.

Mirrors the *objectives* of ``jepsen.store.format`` (reference:
jepsen/src/jepsen/store/format.clj:36-176) with a tensor-native layout
instead of Fressian:

  - one append-only file per run: magic ``JTPU1`` + version + an 8-byte
    footer-index offset patched in last (format.clj:36-53's
    block-index-offset header);
  - self-delimiting blocks ``[u32 len | u32 crc32 | u8 type | payload]``
    (format.clj:66-81) so a crash mid-write never corrupts earlier
    blocks, and a file without a footer is recovered by scanning
    (format.clj:141-150's crash-safe history recovery);
  - history chunks store the PACKED SoA int64 columns
    (the JAX package's ``history.pack`` layout) plus a
    JSON sidecar for op fields the columns can't hold — loading a stored
    run for re-checking costs one mmap-friendly read, no per-op parsing;
  - the footer index carries ``{name, start-time, valid?, op-count,
    block offsets}`` so ``valid?``/name/time reads never touch history
    blocks — the reference's PartialMap trick (format.clj:113-129), which
    the web UI's test table depends on.

Write lifecycle matches the reference's crash-safety story
(store.clj:375-420): save-0 appends the test map, save-1 appends history
chunks the moment the run ends, save-2 appends results + footer.

The port's copy of the JAX package's ``store.format``: the two write and
read the same files.  It imports no torch (the store package stays
importable by the confirmation workers).
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

MAGIC = b"JTPU1\x00"
VERSION = 1
HEADER_LEN = len(MAGIC) + 2 + 8  # magic + u16 version + u64 footer offset

# Block types
T_TEST = 1
T_HISTORY = 2
T_RESULTS = 3
T_INDEX = 4

#: ops per history chunk — large enough to amortize, small enough to
#: stream (reference chunks history similarly for lazy loads).
CHUNK_OPS = 8192

#: op fields with dedicated SoA columns; everything else rides the JSON
#: sidecar.
_COLS = ("index", "type", "process", "f", "time", "value1", "value2")


class CorruptFile(Exception):
    pass


def _col_packable(v, nil) -> bool:
    """Can the value ride the int columns and round-trip exactly?  Bools,
    >2-element sequences, NIL-colliding ints, and anything non-integer go
    to the JSON sidecar instead."""

    def ok_int(x):
        return (
            x is None
            or (isinstance(x, (int, np.integer)) and not isinstance(x, bool) and int(x) != int(nil) and -(2**62) < int(x) < 2**62)
        )

    if ok_int(v):
        return True
    # Pairs round-trip via (v1, v2) — except a None second element, which
    # decodes back as a bare int (the columns can't tell them apart).
    if isinstance(v, (list, tuple)) and len(v) == 2:
        return ok_int(v[0]) and ok_int(v[1]) and v[1] is not None
    return False


def _pack_chunk(ops: Sequence[Mapping]) -> bytes:
    """One history chunk: packed int64 columns + JSON sidecar.

    Columns: index, type-code, process (NEMESIS → -1), f interned id,
    time, value1/value2 (register encoding when packable).  The sidecar
    holds the f vocabulary and, per op, any fields the columns can't
    carry (non-integer values, extra keys like clock-offsets).
    """
    from jepsen_tpu_torch import history as h

    n = len(ops)
    cols = {c: np.zeros(n, np.int64) for c in _COLS}
    f_ids: dict[str, int] = {}
    extras: dict[int, dict] = {}
    type_codes = {h.INVOKE: 0, h.OK: 1, h.FAIL: 2, h.INFO: 3}
    for i, o in enumerate(ops):
        cols["index"][i] = o.get("index", i)
        cols["type"][i] = type_codes.get(o.get("type"), 3)
        p = o.get("process")
        p_packable = isinstance(p, (int, np.integer)) and not isinstance(p, bool)
        cols["process"][i] = int(p) if p_packable else -1
        fname = str(o.get("f"))
        cols["f"][i] = f_ids.setdefault(fname, len(f_ids))
        cols["time"][i] = int(o.get("time") or 0)
        extra = {
            k: v
            for k, v in o.items()
            if k not in ("index", "type", "process", "f", "time", "value")
        }
        v = o.get("value")
        if _col_packable(v, h.NIL):
            v1, v2 = h.encode_register_value(None, list(v) if isinstance(v, tuple) else v)
            cols["value1"][i], cols["value2"][i] = v1, v2
            if isinstance(v, tuple):
                extra["value-tuple?"] = True
        else:
            cols["value1"][i] = cols["value2"][i] = int(h.NIL)
            extra["value"] = v
        if o.get("type") not in type_codes:
            extra["type"] = o.get("type")
        if not p_packable:
            extra["process"] = p
        if extra:
            extras[i] = extra
    buf = io.BytesIO()
    np.savez(buf, **cols)
    sidecar = json.dumps(
        {"fs": list(f_ids), "extras": {str(k): _jsonable(v) for k, v in extras.items()}},
        separators=(",", ":"),
    ).encode()
    # (op-count, sidecar-len) prefix: scans recover op counts without
    # touching the npz payload.
    return struct.pack("<II", n, len(sidecar)) + sidecar + buf.getvalue()


def _unpack_chunk(payload: bytes) -> list[dict]:
    # One decoder for both read paths: ColumnHistory's batch
    # materializer IS the dict decode (history.py), so the eager read
    # and the zero-copy read can never diverge.
    from jepsen_tpu_torch import history as h

    cols, fs, extras = _chunk_columns(payload)
    return h.ColumnHistory(cols, fs, extras).materialized()


def _jsonable(x: Any):
    from jepsen_tpu_torch import store

    return store._jsonable(x)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class Writer:
    """Append blocks to a run file; call close() (or save_2 path) to seal
    with the footer index (format.clj:131-158 write lifecycle)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.index: dict = {"blocks": []}
        if not self.path.exists():
            with open(self.path, "wb") as f:
                f.write(MAGIC + struct.pack("<HQ", VERSION, 0))
        else:
            # Re-opening an existing file (save_1 after save_0): recover
            # its block table, drop any footer (we'll rewrite it).
            self.index = scan(self.path)

    def _append(self, btype: int, payload: bytes) -> dict:
        try:
            from jepsen_tpu_torch.native import blockio

            ext = blockio()
        except ImportError:
            ext = None
        with open(self.path, "r+b") as f:
            if ext is not None:
                # C fast path: CRC + framed append in one buffer pass
                # (the FileOffsetOutputStream role).
                off, _n = ext.append_block(f.fileno(), btype, payload)
            else:
                f.seek(0, 2)
                off = f.tell()
                f.write(struct.pack("<IIB", len(payload), zlib.crc32(payload), btype))
                f.write(payload)
        entry = {"type": btype, "offset": off, "len": len(payload)}
        self.index["blocks"].append(entry)
        return entry

    def write_test(self, test: Mapping):
        from jepsen_tpu_torch import store

        self._append(T_TEST, json.dumps(store.serializable_test(test)).encode())
        self.index["name"] = str(test.get("name"))
        self.index["start-time"] = str(test.get("start-time-str"))

    def write_history(self, history: Sequence[Mapping]):
        for lo in range(0, len(history), CHUNK_OPS):
            self._append(T_HISTORY, _pack_chunk(history[lo : lo + CHUNK_OPS]))
        self.index["op-count"] = len(history)

    def write_results(self, results: Mapping):
        self._append(T_RESULTS, json.dumps(_jsonable(results)).encode())
        self.index["valid?"] = results.get("valid?")

    def close(self):
        """Append the footer index and patch its offset into the header —
        the last write; a crash before this leaves a scannable file."""
        payload = json.dumps(_jsonable(self.index)).encode()
        entry = self._append(T_INDEX, payload)
        with open(self.path, "r+b") as f:
            f.seek(len(MAGIC) + 2)
            f.write(struct.pack("<Q", entry["offset"]))


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def _read_block(f, off: int) -> tuple[int, bytes]:
    f.seek(off)
    hdr = f.read(9)
    if len(hdr) < 9:
        raise CorruptFile(f"truncated block header at {off}")
    length, crc, btype = struct.unpack("<IIB", hdr)
    payload = f.read(length)
    if len(payload) < length:
        raise CorruptFile(f"truncated block payload at {off}")
    if zlib.crc32(payload) != crc:
        raise CorruptFile(f"crc mismatch at {off}")
    return btype, payload


def _peek_block(f, off: int, end: int) -> tuple[int, int, bytes]:
    """Block type, total size, and a small payload PREFIX — without
    reading (or CRC-checking) the whole payload.  Truncation is detected
    by bounds; a torn tail within the final block is caught by the full
    read path when that block is actually loaded."""
    f.seek(off)
    hdr = f.read(9)
    if len(hdr) < 9:
        raise CorruptFile(f"truncated block header at {off}")
    length, _crc, btype = struct.unpack("<IIB", hdr)
    if off + 9 + length > end:
        raise CorruptFile(f"truncated block payload at {off}")
    prefix = f.read(min(length, 4096))
    return btype, length, prefix


def scan(path: str | Path) -> dict:
    """Walk every block; rebuild the index (crash recovery — a file
    without a footer still yields everything fully written,
    format.clj:141-150)."""
    index: dict = {"blocks": []}
    with open(path, "rb") as f:
        head = f.read(HEADER_LEN)
        if head[: len(MAGIC)] != MAGIC:
            raise CorruptFile("bad magic")
        if len(head) < HEADER_LEN:
            raise CorruptFile("truncated header")
        off = HEADER_LEN
        end = f.seek(0, 2)
        while off < end:
            try:
                btype, length, prefix = _peek_block(f, off, end)
            except CorruptFile:
                break  # torn tail from a crash: keep what's whole
            if btype == T_INDEX:
                _bt, payload = _read_block(f, off)
                base = json.loads(payload.decode())
                base["blocks"] = index["blocks"]
                index = base
            else:
                index["blocks"].append({"type": btype, "offset": off, "len": length})
                if btype == T_HISTORY:
                    (n_ops,) = struct.unpack_from("<I", prefix)
                    index["op-count"] = index.get("op-count", 0) + n_ops
                elif btype in (T_TEST, T_RESULTS):
                    _bt, payload = _read_block(f, off)
                    data = json.loads(payload.decode())
                    if btype == T_TEST:
                        index["name"] = data.get("name")
                        index["start-time"] = data.get("start-time-str")
                    else:
                        index["valid?"] = data.get("valid?")
            off += 9 + length
    return index


def read_index(path: str | Path) -> dict:
    """The cheap read: footer only — name/start-time/valid?/op-count
    without touching history blocks (the PartialMap role,
    format.clj:113-129).  Falls back to a scan for unsealed files."""
    with open(path, "rb") as f:
        head = f.read(HEADER_LEN)
        if head[: len(MAGIC)] != MAGIC:
            raise CorruptFile("bad magic")
        if len(head) < HEADER_LEN:
            raise CorruptFile("truncated header")
        (version, footer_off) = struct.unpack("<HQ", head[len(MAGIC) :])
        if footer_off:
            try:
                btype, payload = _read_block(f, footer_off)
                if btype == T_INDEX:
                    return json.loads(payload.decode())
            except (CorruptFile, ValueError):
                pass  # torn footer: recover by scanning below
    return scan(path)


def read(path: str | Path, index: dict | None = None, history: bool = True) -> dict:
    """Load the full run: test map + history + results.  ``history=False``
    skips the history blocks (callers on the zero-copy path read them as
    columns via ``read_columns`` instead)."""
    index = index or read_index(path)
    out: dict = {}
    hist: list = []
    with open(path, "rb") as f:
        for entry in index["blocks"]:
            if not history and entry["type"] == T_HISTORY:
                continue
            btype, payload = _read_block(f, entry["offset"])
            if btype == T_TEST:
                out.update(json.loads(payload.decode()))
            elif btype == T_HISTORY:
                hist.extend(_unpack_chunk(payload))
            elif btype == T_RESULTS:
                out["results"] = json.loads(payload.decode())
    if hist:
        out["history"] = hist
    return out


def _chunk_columns(payload: bytes):
    """One history chunk's raw columns without materializing op dicts."""
    _n, side_len = struct.unpack_from("<II", payload)
    sidecar = json.loads(payload[8 : 8 + side_len].decode())
    npz = np.load(io.BytesIO(payload[8 + side_len :]))
    cols = {c: npz[c] for c in _COLS}
    return cols, sidecar["fs"], {int(k): v for k, v in sidecar["extras"].items()}


def read_columns(path: str | Path, index: dict | None = None):
    """The stored history as concatenated SoA columns — the zero-copy
    analyze path: no per-op dict is built at load time (ops materialize
    lazily through jepsen_tpu_torch.history.ColumnHistory, and vectorized
    consumers read the arrays directly).

    Returns ``(cols, fs, extras)``: int64 column arrays over the whole
    history, the merged ``f`` vocabulary (per-chunk ids remapped), and
    ``{position: extra-fields}`` for ops the columns can't fully carry.
    """
    index = index or read_index(path)
    parts: list = []
    with open(path, "rb") as f:
        for entry in index["blocks"]:
            if entry["type"] != T_HISTORY:
                continue
            btype, payload = _read_block(f, entry["offset"])
            parts.append(_chunk_columns(payload))
    if not parts:
        return {c: np.zeros(0, np.int64) for c in _COLS}, [], {}
    fs: list[str] = []
    f_ids: dict[str, int] = {}
    extras: dict[int, dict] = {}
    off = 0
    all_cols: dict[str, list] = {c: [] for c in _COLS}
    for cols, chunk_fs, chunk_extras in parts:
        remap = np.array(
            [f_ids.setdefault(name, len(f_ids)) for name in chunk_fs], np.int64
        )
        for c in _COLS:
            all_cols[c].append(remap[cols[c]] if c == "f" else cols[c])
        for k, v in chunk_extras.items():
            extras[off + k] = v
        off += len(cols["index"])
    fs = [name for name, _ in sorted(f_ids.items(), key=lambda kv: kv[1])]
    return {c: np.concatenate(all_cols[c]) for c in _COLS}, fs, extras
