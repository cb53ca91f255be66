"""Streaming online checking: verdicts while the test runs.

The port's copy of the JAX package's ``checker.streaming``.  The
:class:`StreamingChecker` consumes an op stream incrementally: each
arriving invoke/complete epoch extends the barrier schedule and advances
a carried frontier through the same chunk scans the post-hoc chunked
engine uses (``ops.wgl.scan_barrier_range`` — same ``Bc`` padding rule,
same capacity-escalation ladder, same dedup backends, on the card unless
``device="cpu"``), emitting a verdict the moment the frontier dies
(refuted) or a constructive witness completes (valid), with an honest
``unknown``-so-far status in between.

Settlement — why online verdicts equal post-hoc ones
----------------------------------------------------

Mid-stream, an invoke with no completion yet is *pending*: the final
history may complete it ok (it joins the barrier schedule) or never
(it becomes a crashed/info group member).  The checker therefore only
advances the frontier through SETTLED barriers: with ``u`` the history
position of the first pending invoke (∞ if none), every event at a
position below ``u`` is final, so the barrier-table prefix below ``u``
is bit-identical to the one the eventual full-history pack will build.
Three invariants make the carried frontier reusable across epochs:

* **Barriers are append-only.**  New completions only append events
  past every existing one, so the settled prefix only grows.
* **Process slots are prefix-stable.**  ``pack`` assigns slots by first
  ok-completing invoke in position order, and the frontier's fok
  bitsets only cover ops open at the settled cut, whose slots all sit
  below ``u``.  Carried fok words need only zero-padding as the
  slot-word count ``W`` grows.
* **Crashed-group columns remap by key.**  The group vocabulary is
  re-derived per epoch, so carried fired-crashed counts are permuted
  onto the new vocabulary by their ``(f_code, v1, v2)`` key.  A dropped
  group's column is provably all-zero; the remap verifies that, and if
  the invariant is ever violated the checker rescans from barrier 0
  (``stream.rescan``), trading latency for verdict identity.

A frontier death at a settled barrier is final: linearizability is
prefix-closed, so the stream is refuted no matter what arrives later.
A ``valid`` verdict exists only at :meth:`~StreamingChecker.finalize`.
Loss (capacity truncation) latches exactly as in ``chunked_analysis``:
once lossy, a death degrades to ``unknown``.  Every decision-path entry
this engine records is ``stream.``-prefixed, and :func:`parity_digest`
strips the engine trajectory, so a streamed and a post-hoc check of one
history digest the same — in this package and in the JAX package.

Durability: with ``checkpoint_dir`` every accepted epoch persists the op
stream, the cursor and the carried frontier through the
``store.checkpoint``/``store.durable`` pair (``stream-checkpoint.json``
and ``.npz``, the JAX package's files), so a killed stream resumes
mid-history (:meth:`StreamingChecker.resume`, ``stream_check(resume=
True)``) and gives the verdict of an uninterrupted run.  A chunk scan
whose launch fails under ``faults.call_with_retry`` ends the stream
``unknown`` with the error named.
"""

from __future__ import annotations

import logging
import math
import time
import uuid
from typing import Mapping, Sequence

import numpy as np

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import models as m
from jepsen_tpu_torch import obs
from jepsen_tpu_torch._platform import resolve_device
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.obs import metrics as _metrics
from jepsen_tpu_torch.obs import provenance as _prov
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops.hashing import resolve_dedup_backend

logger = logging.getLogger(__name__)


def parity_digest(bundle: Mapping) -> str:
    """The cross-engine evidence digest the differential suite compares.

    Returns the bundle's stability-core digest with the decision path,
    ``engine`` and ``config`` zeroed: those record how a verdict was
    produced and legitimately differ between the streaming epoch scan
    and the post-hoc ladder.  What survives — history fingerprint,
    verdict, cause, model, checker, and the constructive witness — must
    be bit-identical between a streamed and a post-hoc check of the
    same history.
    """
    b = dict(bundle)
    b["decision_path"] = []
    b["engine"] = {}
    b["config"] = {}
    return _prov.bundle_digest(b)


def _remap_fcr(
    fcr: np.ndarray,
    old_keys: Sequence[tuple],
    new_keys: Sequence[tuple],
    G_new: int,
) -> tuple[np.ndarray, bool]:
    """Permute carried fired-crashed-count columns onto a new group
    vocabulary by ``(f_code, v1, v2)`` key; new groups zero-fill.
    Returns ``(remapped, violated)`` — ``violated`` means a dropped
    group's column held a nonzero count, which the settlement invariant
    rules out; the caller must rescan from barrier 0."""
    out = np.zeros((fcr.shape[0], G_new), np.int16)
    new_idx = {k: i for i, k in enumerate(new_keys)}
    violated = False
    for j, key in enumerate(old_keys):
        if j >= fcr.shape[1]:
            break
        col = fcr[:, j]
        i = new_idx.get(key)
        if i is None:
            violated |= bool(np.any(col))
            continue
        out[:, i] = col
    return out, violated


class StreamingChecker:
    """Incremental linearizability checker over an op stream.

    ``feed(ops)`` appends arriving invoke/complete ops and advances the
    carried frontier through every newly settled barrier; it returns the
    stream's status doc (``valid?`` stays ``"unknown"`` until a verdict
    exists).  ``finalize()`` classifies any still-pending invokes as
    crashed (exactly what the post-hoc checker does to a stored history)
    and returns the knossos-shaped result.  Once a verdict is emitted
    the stream is terminal: further feeds are accepted but change
    nothing (refutation is prefix-closed).

    Scan parameters mirror ``ops.wgl.analysis``: ``capacity`` is the
    per-chunk escalation ladder, ``rounds`` the closure depth,
    ``dedup_backend`` the per-round dedup backend, ``spill`` slices an
    overflowing carried frontier through the scan instead of
    truncating.  ``device``: the card unless the caller asks for "cpu".

    Each epoch re-packs the full current prefix (O(n) host work per
    epoch; the scan itself only pays the new barriers), so feed in
    batches.
    """

    def __init__(
        self,
        model: m.Model,
        *,
        capacity: int | Sequence[int] = (64, 256),
        rounds: int = 8,
        chunk_barriers: int = 512,
        fast: bool = False,
        dedup_backend: str | None = None,
        spill: bool = False,
        max_groups: int = 64,
        max_procs: int = 128,
        checkpoint_dir=None,
        stream_id: str | None = None,
        checker: str = "linearizable",
        device=None,
    ):
        self.model = model
        self.caps = (
            [int(capacity)] if isinstance(capacity, int)
            else [int(c) for c in capacity]
        )
        self.rounds = int(rounds)
        self.chunk_barriers = int(chunk_barriers)
        self.fast = bool(fast)
        self.dedup = resolve_dedup_backend(dedup_backend)
        self.spill = bool(spill)
        self.max_groups = int(max_groups)
        self.max_procs = int(max_procs)
        self.checkpoint_dir = checkpoint_dir
        self.stream_id = stream_id or uuid.uuid4().hex[:16]
        self.checker_name = checker
        self.device = resolve_device(device)

        self._history: list[dict] = []
        self._frontier: tuple | None = None  # (state, fok, fcr) host arrays
        self._gkeys: list[tuple] = []  # fcr column keys (f_code, v1, v2)
        self._advanced = 0  # settled barriers the frontier has passed
        self._pending = 0
        self._cap_idx = 0
        self._lossy = False
        self._verified = 0
        self._launches = 0
        self._peak = 1
        self._epochs = 0
        self._rescans = 0
        self._result: dict | None = None
        self._detect: dict | None = None
        self._traj: list[dict] = []
        self._finalized = False
        self._t0 = time.perf_counter()
        self._t_epoch = self._t0

    # ------------------------------------------------------------------
    # Public surface
    # ------------------------------------------------------------------

    @property
    def terminal(self) -> bool:
        """A verdict exists (possibly before the stream ends)."""
        return self._result is not None

    @property
    def result(self) -> dict | None:
        return self._result

    @property
    def ops_consumed(self) -> int:
        """Ops accepted so far: a resuming feeder continues from here."""
        return len(self._history)

    @property
    def epochs(self) -> int:
        """Feed epochs processed so far."""
        return self._epochs

    @property
    def rescans(self) -> int:
        """Full from-barrier-0 rescans forced by a settlement-invariant
        violation (``stream.rescan``)."""
        return self._rescans

    @property
    def frontier_rows(self) -> int:
        """Rows in the carried frontier right now (0 before the first
        settled barrier)."""
        if self._frontier is None:
            return 0
        return int(self._frontier[0].shape[0])

    @property
    def detection(self) -> dict | None:
        """Violation-detection metadata when a verdict fired mid-stream:
        ops seen at detection, the killed barrier/op position, and the
        wall-clock latency from the offending epoch's arrival."""
        return dict(self._detect) if self._detect else None

    def feed(self, ops: Sequence[Mapping]) -> dict:
        """Append arriving ops (one epoch) and advance through every
        newly settled barrier.  Returns :meth:`status`.  An undecidable
        stream degrades to a terminal ``unknown`` with a ``cause``; a
        kernel that fails to build or launch raises."""
        ops = [dict(o) for o in ops]
        if self._result is not None:
            # Terminal latch: late ops are recorded for the status doc
            # but never change the verdict.
            self._history.extend(ops)
            return self.status()
        if ops:
            self._history.extend(ops)
            obs.counter("stream.ops", len(ops), stream=self.stream_id)
            self._advance(final=False)
            self._save_ck()
        return self.status()

    def finalize(self) -> dict:
        """End of stream: classify still-pending invokes as crashed
        (info) — exactly the post-hoc treatment of a stored history —
        advance through the remaining schedule, and return the
        knossos-shaped result.  Idempotent."""
        if self._result is None:
            self._finalized = True
            self._advance(final=True)
            if self._result is None:
                # survived the whole schedule with everything classified:
                # any surviving config is a constructive witness (sound
                # even after loss, as in chunked_analysis)
                self._terminal({"valid?": True}, barrier=None)
            self._save_ck()
        return self._result

    def status(self) -> dict:
        """The honest unknown-so-far status doc."""
        res = self._result or {}
        out = {
            "valid?": res.get("valid?", UNKNOWN),
            "terminal?": self._result is not None,
            "stream-id": self.stream_id,
            "ops": len(self._history),
            "pending": self._pending,
            "settled-barriers": self._advanced,
            "epochs": self._epochs,
            "lossy?": self._lossy,
        }
        if self._detect:
            out["detection"] = dict(self._detect)
        if res.get("cause") is not None:
            out["cause"] = res["cause"]
        return out

    def evidence(self, *, trace_id=None) -> dict | None:
        """Build the stream's evidence bundle (terminal streams only).
        Its engine-independent core digests identically to the post-hoc
        path's on the same history (:func:`parity_digest`)."""
        if self._result is None:
            return None
        try:
            return _prov.build_bundle(
                history=self._history, result=self._result,
                source="stream", model=self.model,
                checker=self.checker_name, trace_id=trace_id,
                bundle_id=self.stream_id,
            )
        except Exception as e:  # noqa: BLE001 — evidence never loses verdicts
            logger.warning("stream evidence bundle build failed: %s", e)
            obs.counter("provenance.emit_error", error=type(e).__name__)
            return None

    # ------------------------------------------------------------------
    # Epoch advance
    # ------------------------------------------------------------------

    def _pv(self, event: str, **attrs) -> None:
        if len(self._traj) < _prov.MAX_PATH:
            self._traj.append({"event": event, **attrs})

    def _stats(self) -> dict:
        return {
            "frontier-peak": self._peak, "capacity": self.caps[self._cap_idx],
            "lossy?": self._lossy, "epochs": self._epochs,
            "launches": self._launches,
            "verified-barriers": self._verified,
            "settled-barriers": self._advanced,
        }

    def _terminal(self, res: dict, *, barrier: int | None) -> None:
        res = dict(res)
        res.setdefault("kernel", self._stats())
        self._pv(
            "stream.verdict", verdict=_prov.verdict_str(res.get("valid?")),
            barrier=barrier, final=self._finalized,
        )
        _prov.attach(
            res, self._traj,
            engine={
                "engine": "streaming", "dedup_backend": self.dedup,
                "spill": self.spill, "fast": self.fast,
            },
            config={
                "capacity": self.caps, "rounds": self.rounds,
                "chunk_barriers": self.chunk_barriers, "fast": self.fast,
            },
        )
        self._result = res
        obs.span_event(
            "stream.verdict", time.perf_counter() - self._t0,
            verdict=_prov.verdict_str(res.get("valid?")),
            ops=len(self._history), epochs=self._epochs,
            settled=self._advanced, final=self._finalized,
            stream=self.stream_id,
        )

    def _refute_or_unknown(self, packed: dict, gb: int) -> None:
        op_pos = int(packed["bar_opid"][gb])
        op = self._history[op_pos]
        stats = self._stats()
        stats["bar-opid"] = op_pos  # positional id for stop_at_index
        stats["witnessed-barriers"] = gb
        if self._lossy:
            self._pv("stream.lossy-death", barrier=gb)
            self._terminal({
                "valid?": UNKNOWN,
                "cause": "frontier capacity or closure rounds exhausted",
                "op": op, "kernel": stats,
            }, barrier=gb)
            return
        self._pv("stream.refuted", barrier=gb, provisional=self.fast)
        res = {"valid?": False, "op": op, "kernel": stats}
        if self.fast:
            res["provisional?"] = True  # hash-decided kills
        # Detect latency = wall from the offending epoch's arrival, not
        # from stream open.
        self._detect = {
            "ops": len(self._history), "barrier": gb, "op-position": op_pos,
            "seconds": time.perf_counter() - self._t0,
            "epoch_seconds": time.perf_counter() - self._t_epoch,
        }
        _metrics.observe("serve.stream_detect_latency_seconds",
                         self._detect["epoch_seconds"])
        self._terminal(res, barrier=gb)

    def _advance(self, final: bool) -> None:
        self._t_epoch = time.perf_counter()
        self._epochs += 1
        history = self._history
        try:
            packed_raw = wgl.pack(self.model, history)
        except wgl.NotTensorizable as e:
            self._terminal(
                {"valid?": UNKNOWN, "cause": f"not tensorizable: {e}"},
                barrier=None)
            return
        pairs = h.pair_index(history)

        # Settlement cursor: position of the first pending invoke.
        u: float = math.inf
        pending = 0
        for i, op in enumerate(history):
            if (h.is_invoke(op) and h.is_client_op(op)
                    and int(pairs[i]) == -1):
                pending += 1
                if u is math.inf:
                    u = i
        self._pending = pending
        B = packed_raw["B"]
        bar_opid = packed_raw["bar_opid"]
        if final or u is math.inf:
            S = B
        else:
            S = 0
            for b in range(B):
                if int(pairs[int(bar_opid[b])]) < u:
                    S += 1
                else:
                    break

        def _epoch_span(scanned: int, rows: int) -> None:
            obs.span_event(
                "stream.epoch", time.perf_counter() - self._t_epoch,
                ops=len(history), pending=pending, settled=S,
                scanned=scanned, frontier_rows=rows,
                epoch=self._epochs, stream=self.stream_id,
            )

        if B == 0 or S <= self._advanced:
            _epoch_span(0, 0 if self._frontier is None
                        else int(self._frontier[0].shape[0]))
            return
        if packed_raw["G"] > self.max_groups:
            self._terminal({
                "valid?": UNKNOWN,
                "cause": (f"{packed_raw['G']} crashed-op groups exceeds "
                          f"{self.max_groups}"),
            }, barrier=None)
            return
        if packed_raw["P"] > self.max_procs:
            self._terminal({
                "valid?": UNKNOWN,
                "cause": (f"{packed_raw['P']} process slots exceeds "
                          f"{self.max_procs}"),
            }, barrier=None)
            return

        # Re-bucket: keep B for range indexing (the chunked convention).
        packed = wgl.pad_packed(packed_raw, B=B)
        G, W = packed["G"], packed["W"]
        grp_f, grp_v1, grp_v2 = packed_raw["grp"]
        new_keys = [
            (int(grp_f[k]), int(grp_v1[k]), int(grp_v2[k]))
            for k in range(packed_raw["G"])
        ]

        def fresh():
            return (np.array([packed["init_state"]], np.int32),
                    np.zeros((1, W), np.int32), np.zeros((1, G), np.int16))

        if self._frontier is None:
            f_state, f_fok, f_fcr = fresh()
        else:
            f_state, f_fok, f_fcr = self._frontier
            if f_fok.shape[1] < W:  # slots are prefix-stable: pad only
                pad = np.zeros((f_fok.shape[0], W - f_fok.shape[1]),
                               f_fok.dtype)
                f_fok = np.concatenate([f_fok, pad], axis=1)
            f_fcr, violated = _remap_fcr(f_fcr, self._gkeys, new_keys, G)
            if violated:
                # Settlement invariant violated (should be unreachable):
                # rescan from barrier 0 — latency, never a wrong verdict.
                obs.counter("stream.rescan", stream=self.stream_id)
                self._rescans += 1
                self._pv("stream.rescan", barrier=self._advanced)
                logger.warning(
                    "stream %s: dropped crashed-group column was nonzero; "
                    "rescanning from barrier 0", self.stream_id)
                self._advanced = 0
                self._verified = 0
                f_state, f_fok, f_fcr = fresh()

        self._pv("stream.epoch", ops=len(history), settled=S,
                 from_barrier=self._advanced)
        r = wgl.scan_barrier_range(
            packed, (f_state, f_fok, f_fcr), self._advanced, S,
            capacities=self.caps, rounds=self.rounds,
            chunk_barriers=self.chunk_barriers, cap_idx=self._cap_idx,
            lossy=self._lossy, fast=self.fast, dedup_backend=self.dedup,
            spill=self.spill,
            on_event=lambda ev, **a: self._pv("stream." + ev, **a),
            device=self.device,
        )
        self._launches += r["launches"]
        self._peak = max(self._peak, r["peak"])
        self._cap_idx = r["cap_idx"]
        self._lossy = r["lossy"]
        self._frontier = r["frontier"]
        self._gkeys = new_keys
        if r["error"] is not None:
            _epoch_span(S - self._advanced,
                        int(self._frontier[0].shape[0]))
            self._terminal({
                "valid?": UNKNOWN,
                "cause": f"device launch failed: {r['error']}",
            }, barrier=self._advanced)
            return
        if r["failed_barrier"] is not None:
            _epoch_span(r["failed_barrier"] - self._advanced, 0)
            self._refute_or_unknown(packed, r["failed_barrier"])
            return
        if not self._lossy:
            # verified counts loss-free barriers, as in chunked_analysis
            self._verified = S
        scanned = S - self._advanced
        self._advanced = S
        _epoch_span(scanned, int(self._frontier[0].shape[0]))

    # ------------------------------------------------------------------
    # Checkpoint and resume
    # ------------------------------------------------------------------

    def _ck_config(self) -> dict:
        return {
            "model": getattr(self.model, "name", None),
            "stream_id": self.stream_id,
            "capacity": self.caps, "rounds": self.rounds,
            "chunk_barriers": self.chunk_barriers, "fast": self.fast,
            "dedup": self.dedup, "spill": self.spill,
            "max_groups": self.max_groups, "max_procs": self.max_procs,
            "checker": self.checker_name,
        }

    def _save_ck(self) -> str | None:
        """Persist the stream cursor and the carried frontier (fok as the
        JAX package's uint32); a failed save is logged, never fatal."""
        if self.checkpoint_dir is None:
            return None
        from jepsen_tpu_torch.store import checkpoint as _ckpt

        if self._frontier is None:
            frontier = (np.zeros(0, np.int32), np.zeros((0, 1), np.uint32),
                        np.zeros((0, 1), np.int16))
        else:
            st, fo, fc = self._frontier
            frontier = (st, np.asarray(fo).view(np.uint32), fc)
        try:
            p = _ckpt.save_stream(
                self.checkpoint_dir, config=self._ck_config(),
                ops=self._history, advanced=self._advanced,
                cap_idx=self._cap_idx, frontier=frontier,
                group_keys=self._gkeys, lossy=self._lossy,
                verified=self._verified, launches=self._launches,
                epochs=self._epochs, result=self._result,
            )
            return str(p)
        except Exception:  # noqa: BLE001 — a recovery aid, not a verdict input
            logger.warning("couldn't write stream checkpoint to %s",
                           self.checkpoint_dir, exc_info=True)
            obs.counter("fault.checkpoint.error")
            return None

    @classmethod
    def resume(cls, checkpoint_dir, model: m.Model,
               device=None) -> "StreamingChecker":
        """Rebuild a killed stream from its checkpoint pair.  The saved
        config wins over the caller's arguments, but ``model`` must match
        the saved model's name (``CheckpointError`` otherwise).  Re-feed
        from :attr:`ops_consumed`.  ``device``: the card unless the
        caller asks for "cpu"."""
        from jepsen_tpu_torch.convert import fok_bits
        from jepsen_tpu_torch.store import checkpoint as _ckpt

        saved = _ckpt.load_stream(checkpoint_dir)
        cfg = saved["config"]
        want = cfg.get("model")
        have = getattr(model, "name", None)
        if want is not None and want != have:
            raise _ckpt.CheckpointError(
                f"stream checkpoint was written for model {want!r}, "
                f"resume offered {have!r}",
                {"artifact": _ckpt.KIND_STREAM, "reason": "model-mismatch"})
        sc = cls(
            model,
            capacity=cfg.get("capacity") or (64, 256),
            rounds=cfg.get("rounds") or 8,
            chunk_barriers=cfg.get("chunk_barriers") or 512,
            fast=bool(cfg.get("fast")),
            dedup_backend=cfg.get("dedup"),
            spill=bool(cfg.get("spill")),
            max_groups=cfg.get("max_groups") or 64,
            max_procs=cfg.get("max_procs") or 128,
            checkpoint_dir=checkpoint_dir,
            stream_id=cfg.get("stream_id"),
            checker=cfg.get("checker") or "linearizable",
            device=device,
        )
        sc._history = [dict(o) for o in saved["ops"]]
        st, fo, fc = saved["frontier"]
        if st.shape[0]:
            sc._frontier = (np.asarray(st, np.int32), fok_bits(fo),
                            np.asarray(fc, np.int16))
        sc._gkeys = [tuple(k) for k in saved["group_keys"]]
        sc._advanced = saved["advanced"]
        sc._cap_idx = saved["cap_idx"]
        sc._lossy = saved["lossy"]
        sc._verified = saved["verified"]
        sc._launches = saved["launches"]
        sc._epochs = saved["epochs"]
        sc._result = saved["result"]
        obs.span_event(
            "fault.checkpoint.load", 0.0, barrier=sc._advanced,
            rows=int(st.shape[0]), stream=True,
            complete=sc._result is not None,
        )
        sc._pv("stream.resumed", barrier=sc._advanced,
               ops=len(sc._history))
        return sc


def stream_check(
    model: m.Model,
    history: Sequence[Mapping],
    *,
    feed_ops: int = 8,
    checkpoint_dir=None,
    resume: bool = False,
    **kw,
) -> tuple[dict, "StreamingChecker"]:
    """Replay a stored history through a :class:`StreamingChecker` in
    ``feed_ops``-sized epochs and finalize.  With ``resume`` and a stream
    checkpoint in ``checkpoint_dir``, the stream is rebuilt first and
    feeding continues from its consumed-op count (a killed replay gives
    the uninterrupted verdict; an unreadable checkpoint streams fresh).
    Returns ``(result, checker)``; ``kw`` goes to the checker
    (``device`` among them)."""
    history = h.materialize(history)
    sc: StreamingChecker | None = None
    if resume and checkpoint_dir is not None:
        from jepsen_tpu_torch.store import checkpoint as _ckpt

        if _ckpt.stream_exists(checkpoint_dir):
            try:
                sc = StreamingChecker.resume(checkpoint_dir, model,
                                             device=kw.get("device"))
            except _ckpt.CheckpointError as e:
                logger.warning(
                    "unreadable stream checkpoint in %s (%s); "
                    "streaming fresh", checkpoint_dir, e)
                obs.counter("fault.checkpoint.mismatch", reason="unreadable")
    if sc is None:
        sc = StreamingChecker(model, checkpoint_dir=checkpoint_dir, **kw)
    at = sc.ops_consumed
    while at < len(history):
        # feed to the end even after a verdict latches (terminal feeds
        # are cheap no-ops): evidence parity with the post-hoc path
        # requires the stream to have consumed the same history
        sc.feed(history[at:at + max(1, int(feed_ops))])
        at = sc.ops_consumed
    return sc.finalize(), sc
