"""Frontier-parallel Wing–Gong–Lowe linearizability search, in torch.

The port of the JAX package's ``ops/wgl.py``: packing histories into
barrier tables, the batched greedy witness walk, the lane-asynchronous
frontier engine, the barrier-scan engine (fast and exact), the chunked
single-history engine with host spill, and the single-history entry
points (``analysis``, ``greedy_analysis``, ``analysis_async``).  The JAX
engines are ``jit(vmap(...))`` of a ``lax.scan`` / ``lax.while_loop``;
here the lane axis is written out (every tensor is ``[L, ...]``) and the
loops are host loops over batched tensor ops, with each lane's update
masked by its own loop condition, as ``vmap`` of a ``while_loop`` masks
it.

Data layout (F = frontier capacity, P = process slots, G = crashed-op
groups, W = ⌈P/32⌉ bitset lanes, B = barriers):

  frontier:  state [L, F] int32 · fok [L, F, W] int32 (uint32 fired
             open-op bitsets by slot, as int32 bit patterns) · fcr
             [L, F, G] int16 (fired count per crashed group) · alive
             [L, F] bool
  barriers:  per-barrier op (f, v1, v2, slot), per-slot open-op tables
             (mov_*[B, P]), per-group open counts (grp_open[B, G])

Soundness (as in the JAX package): every applied transition is legal,
so a surviving frontier is a constructive witness and ``True`` is
always sound.  ``False`` requires that no capacity or tick-budget loss
occurred (``lossy``); kills are hash-decided, so the batch driver
confirms every refutation on the exact CPU sweep.  Anything else is
``"unknown"``.
"""

from __future__ import annotations

import logging
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from jepsen_tpu_torch import faults
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import models as m
from jepsen_tpu_torch import obs
from jepsen_tpu_torch._platform import resolve_device
from jepsen_tpu_torch.convert import fok_bits
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.models import tensor as tmodels
from jepsen_tpu_torch.obs import provenance as _prov
from jepsen_tpu_torch.ops import spill as spill_mod
from jepsen_tpu_torch.ops.hashing import (
    MASK32,
    frontier_update,
    frontier_update_fast,
    resolve_dedup_backend,
)

logger = logging.getLogger(__name__)


class NotTensorizable(Exception):
    """History/model can't be packed for the engines (exotic model, f, or
    value vocabulary); callers fall back to the CPU sweep."""


# ---------------------------------------------------------------------------
# Host-side packing (numpy; the JAX package's tables, with its own step)
# ---------------------------------------------------------------------------


def _encode_value(value) -> tuple[int, int]:
    try:
        v1, v2 = h.encode_register_value(None, list(value) if isinstance(value, tuple) else value)
    except TypeError as e:
        raise NotTensorizable(str(e)) from None
    return v1, v2


def pack(model: m.Model, history: Sequence[dict]):
    """Pack a history of op dicts into the engines' barrier tables.

    Raises NotTensorizable when the model has no tensor step function or
    ops carry values the int32 columns can't hold.  The tables equal the
    JAX package's ``wgl.pack`` output for the same history, except that
    ``step`` is the torch step and ``slot_onehot`` holds int32 bit
    patterns."""
    tm = tmodels.tensor_model_for(model)
    if tm is None:
        raise NotTensorizable(f"no tensor model for {getattr(model, 'name', model)!r}")
    history = list(history)
    events, eff_ops, crashed = wgl_cpu.prepare(model, history)
    if tm.precheck is not None:
        try:
            tm.precheck(model, eff_ops.values())
        except ValueError as e:
            raise NotTensorizable(str(e)) from None
    barriers, group_ops = wgl_cpu._barrier_snapshots(events, eff_ops, crashed)
    B = len(barriers)

    def fcode(op) -> int:
        f = op["f"]
        if f not in tm.f_codes:
            raise NotTensorizable(f"model {tm.name} has no f code for {f!r}")
        return tm.f_codes[f]

    # Process slots: one in-flight ok op per process at a time.
    slots: dict = {}
    for i in eff_ops:
        if i not in crashed:
            p = history[i]["process"]
            if p not in slots:
                slots[p] = len(slots)
    P = max(1, len(slots))
    W = (P + 31) // 32

    groups = sorted(group_ops, key=repr)
    gidx = {g: k for k, g in enumerate(groups)}
    G = max(1, len(groups))

    bar_f = np.zeros(B, np.int32)
    bar_v1 = np.zeros(B, np.int32)
    bar_v2 = np.zeros(B, np.int32)
    bar_slot = np.zeros(B, np.int32)
    bar_opid = np.zeros(B, np.int32)
    mov_f = np.zeros((B, P), np.int32)
    mov_v1 = np.zeros((B, P), np.int32)
    mov_v2 = np.zeros((B, P), np.int32)
    mov_open = np.zeros((B, P), bool)
    grp_open = np.zeros((B, G), np.int32)
    bar_quiet = np.zeros(B, bool)

    codes: dict[int, tuple[int, int, int]] = {}

    def op_codes(j: int) -> tuple[int, int, int]:
        t = codes.get(j)
        if t is None:
            oj = eff_ops[j]
            v1, v2 = _encode_value(oj.get("value"))
            t = codes[j] = (fcode(oj), v1, v2)
        return t

    for b, (_pos, i, open_ok, open_crashed) in enumerate(barriers):
        bar_quiet[b] = open_ok == (i,)
        bar_f[b], bar_v1[b], bar_v2[b] = op_codes(i)
        bar_slot[b] = slots[history[i]["process"]]
        bar_opid[b] = i
        for j in open_ok:
            s = slots[history[j]["process"]]
            mov_f[b, s], mov_v1[b, s], mov_v2[b, s] = op_codes(j)
            mov_open[b, s] = True
        for g, count in open_crashed:
            grp_open[b, gidx[g]] = count

    grp_f = np.zeros(G, np.int32)
    grp_v1 = np.zeros(G, np.int32)
    grp_v2 = np.zeros(G, np.int32)
    for g, k in gidx.items():
        grp_f[k] = fcode(group_ops[g])
        grp_v1[k], grp_v2[k] = _encode_value(group_ops[g].get("value"))

    return _finish_pack(
        tm, model, B, P, G, W, bar_quiet,
        (bar_f, bar_v1, bar_v2, bar_slot), bar_opid,
        (mov_f, mov_v1, mov_v2, mov_open),
        (grp_f, grp_v1, grp_v2), grp_open,
    )


def _slot_tables(P: int, W: int):
    slot_lane = np.arange(P, dtype=np.int32) // 32
    slot_onehot = np.zeros((P, W), np.uint32)
    for p in range(P):
        slot_onehot[p, p // 32] = np.uint32(1) << np.uint32(p % 32)
    return slot_lane, slot_onehot.view(np.int32)


def _finish_pack(tm, model, B, P, G, W, bar_quiet, bar, bar_opid, mov, grp, grp_open):
    """The int16 count gate, the slot one-hot layout, and the table
    contract."""
    if B and grp_open.max(initial=0) > 32767:
        raise NotTensorizable("crashed-group open count exceeds int16 range")
    slot_lane, slot_onehot = _slot_tables(P, W)
    return {
        "B": B,
        "P": P,
        "G": G,
        "W": W,
        "init_state": np.int32(_encode_state(tm, model)),
        "step": tm.step,
        "bar_active": np.ones(B, bool),
        "bar_quiet": bar_quiet,
        "bar": bar,
        "bar_opid": bar_opid,
        "mov": mov,
        "grp": grp,
        "grp_open": grp_open,
        "slot_lane": slot_lane,
        "slot_onehot": slot_onehot,
    }


def _encode_state(tm, model) -> int:
    try:
        return tm.encode_state(model)
    except ValueError as e:
        raise NotTensorizable(str(e)) from None


def _bucket(x: int, choices) -> int:
    for c in choices:
        if c >= x:
            return c
    return x


def pad_B(B: int) -> int:
    """The barrier-table padding of the batched launches (power of two,
    floor 64)."""
    return 1 << max(6, (B - 1).bit_length())


def pad_packed(packed: dict, B: int | None = None, P: int | None = None,
               G: int | None = None) -> dict:
    """Pad the packed tables to bucketed shapes.  Padding barriers are
    inactive; padding slots/groups are never open, so the engines'
    behaviour is unchanged.  Explicit targets override the buckets."""
    B0, P0, G0 = packed["B"], packed["P"], packed["G"]
    B = B if B is not None else pad_B(B0)
    P = P if P is not None else _bucket(P0, [8, 16, 32, 64, 128])
    G = G if G is not None else _bucket(G0, [4, 8, 16, 32, 64])
    if B < B0 or P < P0 or G < G0:
        raise ValueError(f"pad targets {(B, P, G)} below {(B0, P0, G0)}")
    if (B, P, G) == (B0, P0, G0):
        return packed
    W = (P + 31) // 32
    bar_f, bar_v1, bar_v2, bar_slot = packed["bar"]
    mov_f, mov_v1, mov_v2, mov_open = packed["mov"]
    grp_f, grp_v1, grp_v2 = packed["grp"]

    def padB(a, fill=0):
        out = np.full((B,) + a.shape[1:], fill, a.dtype)
        out[:B0] = a
        return out

    def padBP(a):
        out = np.zeros((B, P), a.dtype)
        out[:B0, :P0] = a
        return out

    def padG(a):
        out = np.zeros(G, a.dtype)
        out[:G0] = a
        return out

    def padBG(a):
        out = np.zeros((B, G), a.dtype)
        out[:B0, :G0] = a
        return out

    slot_lane, slot_onehot = _slot_tables(P, W)
    out = dict(packed)
    out.update(
        B=B, P=P, G=G, W=W,
        bar_active=padB(packed["bar_active"], False),
        bar_quiet=padB(packed["bar_quiet"], False),
        bar=(padB(bar_f), padB(bar_v1), padB(bar_v2), padB(bar_slot)),
        mov=(padBP(mov_f), padBP(mov_v1), padBP(mov_v2), padBP(mov_open)),
        grp=(padG(grp_f), padG(grp_v1), padG(grp_v2)),
        grp_open=padBG(packed["grp_open"]),
        slot_lane=slot_lane,
        slot_onehot=slot_onehot,
    )
    return out


# ---------------------------------------------------------------------------
# Device engines
# ---------------------------------------------------------------------------


def _bit(slot):
    """The in-lane bit of process slot(s) as int32 bit patterns (bit 31
    is int32's sign bit)."""
    return torch.bitwise_left_shift(torch.ones_like(slot), slot % 32)


def expand_candidates(
    step, eye_g, slot_lane, slot_mask, slot_onehot,
    state, fok, fcr, alive,
    xmov_f, xmov_v1, xmov_v2, xmov_open,
    grp_f, grp_v1, grp_v2, xgrp_open,
):
    """One closure round's candidate table per lane: parents + every
    legal single move.

    Process moves fire any open ok op not yet fired; group moves fire one
    crashed op from any open group.  A crashed fire that leaves the
    state unchanged yields a config dominated by its own parent —
    dropped at the source.  Lane-batched: frontier [L, F, ...], movers
    [L, P], groups [L, G]; slot tables are shared.

    Returns (cat_state, cat_fok, cat_fcr, cat_alive, cost) with
    F*(1+P+G) rows per lane.  ``cost`` is None: the frontier update
    ignores it (candidate order is the truncation order), so the port
    computes no popcount."""
    L, F, W = fok.shape
    P = xmov_f.shape[1]
    G = grp_f.shape[1]
    pstate2, plegal = step(state[:, :, None], xmov_f[:, None, :],
                           xmov_v1[:, None, :], xmov_v2[:, None, :])
    already = (fok[:, :, slot_lane] & slot_mask) != 0
    plegal = plegal & alive[:, :, None] & xmov_open[:, None, :] & ~already
    pfok = (fok[:, :, None, :] | slot_onehot).reshape(L, F * P, W)
    pfcr = fcr.repeat_interleave(P, dim=1)
    gstate2, glegal = step(state[:, :, None], grp_f[:, None, :],
                           grp_v1[:, None, :], grp_v2[:, None, :])
    glegal = (glegal & alive[:, :, None] & (fcr < xgrp_open[:, None, :])
              & (gstate2 != state[:, :, None]))
    gfok = fok.repeat_interleave(G, dim=1)
    gfcr = (fcr[:, :, None, :] + eye_g).reshape(L, F * G, G)

    cat_state = torch.cat([state, pstate2.reshape(L, -1),
                           gstate2.reshape(L, -1)], 1)
    cat_alive = torch.cat([alive, plegal.reshape(L, -1),
                           glegal.reshape(L, -1)], 1)
    cat_fok = torch.cat([fok, pfok, gfok], 1)
    cat_fcr = torch.cat([fcr, pfcr, gfcr], 1)
    return cat_state, cat_fok, cat_fcr, cat_alive, None


#: Lane tables the engines take, in order (the JAX package's
#: ASYNC_ARG_ORDER after init_state): per-lane barrier, mover and group
#: tables.
TABLE_ORDER = (
    "bar_f", "bar_v1", "bar_v2", "bar_slot",
    "mov_f", "mov_v1", "mov_v2", "mov_open",
    "grp_f", "grp_v1", "grp_v2", "grp_open",
)


def async_ticks(B: int, capacity: int | None = None) -> int:
    """Tick budget for the lane-async engine (the JAX package's rule):
    wide stages (capacity >= 1024) get ~2 closure rounds per barrier
    plus slack, narrow stages 1.5.  Exceeding it flags lossy and
    escalates — a wasted stage, never a wrong verdict."""
    if capacity is not None and capacity < 1024:
        return (3 * B) // 2 + 32
    return 2 * B + 64


#: Host loops poll "does any lane still run?" (a device sync) once per
#: this many iterations; extra iterations on finished lanes are no-ops.
POLL_EVERY = 8


def greedy_run(step, B: int, init_state, n_active, tables, slot_lane,
               slot_onehot):
    """The batched greedy witness walk (the JAX package's
    ``_greedy_core`` under vmap): each lane walks ONE configuration
    through its barriers — retire the returning op if an earlier enabler
    already fired it, else fire it directly if legal, else fire one
    enabling open ok op, else one enabling crashed-group op — and sticks
    when none applies.  Completion is a constructive witness; sticking
    proves nothing.

    ``init_state``/``n_active`` [L]; ``tables`` the dict of lane tables
    (``TABLE_ORDER``) as tensors.  A host loop over barriers; lanes that
    are done stay fixed, and the loop stops early, polling every
    ``POLL_EVERY`` barriers, once every lane is done.

    Returns (finished [L] bool, stuck_at [L] int32, fired-crashed total
    [L] int32)."""
    dev = init_state.device
    L = init_state.shape[0]
    P = tables["mov_f"].shape[2]
    G = tables["grp_f"].shape[1]
    W = slot_onehot.shape[1]
    slot_mask = slot_onehot.sum(1, dtype=torch.int32)  # one bit per slot
    p_iota = torch.arange(P, device=dev)
    g_iota = torch.arange(G, device=dev)
    w_iota = torch.arange(W, device=dev)
    ar = torch.arange(L, device=dev)
    state = init_state.to(torch.int32)
    fok = torch.zeros(L, W, dtype=torch.int32, device=dev)
    fcr = torch.zeros(L, G, dtype=torch.int16, device=dev)
    stuck_at = torch.full((L,), -1, dtype=torch.int32, device=dev)
    grp_f, grp_v1, grp_v2 = tables["grp_f"], tables["grp_v1"], tables["grp_v2"]
    for b in range(B):
        if b % POLL_EVERY == 0 and not bool(
                ((stuck_at < 0) & (b < n_active)).any()):
            break
        bf = tables["bar_f"][:, b]
        bv1 = tables["bar_v1"][:, b]
        bv2 = tables["bar_v2"][:, b]
        bslot = tables["bar_slot"][:, b]
        mf = tables["mov_f"][:, b]
        mv1 = tables["mov_v1"][:, b]
        mv2 = tables["mov_v2"][:, b]
        mopen = tables["mov_open"][:, b]
        gopen = tables["grp_open"][:, b]
        done = (stuck_at >= 0) | (b >= n_active)
        lane = (bslot // 32).long()
        bit = _bit(bslot)
        has_bit = (fok[ar, lane] & bit) != 0
        s1, legal1 = step(state, bf, bv1, bv2)
        already = (fok[:, slot_lane] & slot_mask) != 0
        ps2, plegal = step(state[:, None], mf, mv1, mv2)
        ps3, plegal3 = step(ps2, bf[:, None], bv1[:, None], bv2[:, None])
        pcand = plegal & plegal3 & mopen & ~already & (p_iota != bslot[:, None])
        gs2, glegal = step(state[:, None], grp_f, grp_v1, grp_v2)
        gs3, glegal3 = step(gs2, bf[:, None], bv1[:, None], bv2[:, None])
        gcand = glegal & glegal3 & (fcr < gopen) & (gs2 != state[:, None])
        p_any = pcand.any(1)
        g_any = gcand.any(1)
        p_idx = pcand.to(torch.int8).argmax(1)
        g_idx = gcand.to(torch.int8).argmax(1)
        clear = torch.where(w_iota == lane[:, None], bit[:, None], 0)
        new_state = torch.where(
            has_bit, state,
            torch.where(legal1, s1,
                        torch.where(p_any, ps3[ar, p_idx], gs3[ar, g_idx])))
        new_fok = torch.where(
            has_bit[:, None], fok & ~clear,
            torch.where(legal1[:, None], fok,
                        torch.where(p_any[:, None], fok | slot_onehot[p_idx],
                                    fok)))
        new_fcr = torch.where(
            (~has_bit & ~legal1 & ~p_any & g_any)[:, None],
            fcr + (g_iota == g_idx[:, None]).to(torch.int16), fcr)
        ok = has_bit | legal1 | p_any | g_any
        stuck_at = torch.where(~done & ~ok, b, stuck_at)
        hold = done | ~ok
        state = torch.where(hold, state, new_state)
        fok = torch.where(hold[:, None], fok, new_fok)
        fcr = torch.where(hold[:, None], fcr, new_fcr)
    finished = stuck_at < 0
    return finished, stuck_at, fcr.sum(1, dtype=torch.int32)


def run_async(step, F: int, T: int, bptr0, state0, fok0, fcr0, alive0,
              n_active, tables, slot_lane, slot_onehot,
              dedup: str = "fused"):
    """Lane-asynchronous barrier stepping (the JAX package's
    ``_run_core_async`` under vmap), from carried frontiers.

    Each of at most ``T`` ticks runs one closure round at each lane's
    own barrier: expand, then ``frontier_update_fast``.  When a round
    adds no surviving child (the closure fixpoint), the barrier's return
    filter applies — configs that fired the returning op survive, its
    slot bit retires — and the lane's barrier pointer advances.  A lane
    that finished or failed is a fixed point of the tick (every carried
    value, ``peak`` and the snapshot included, is unchanged), so one
    host loop over all lanes that stops once none runs (polled every
    ``POLL_EVERY`` ticks) equals the vmapped while loop.

    Resume snapshot: the frontier at entry of the first overflowing tick
    (exact: no loss yet), else the final carry.

    Returns (valid, failed_at, lossy, peak, bsnap, sst, sfo, sfc, sal),
    lane-batched tensors."""
    dev = state0.device
    L = state0.shape[0]
    B = tables["bar_f"].shape[1]
    P = tables["mov_f"].shape[2]
    G = tables["grp_f"].shape[1]
    W = fok0.shape[2]
    eye_g = torch.eye(G, dtype=torch.int16, device=dev)
    slot_mask = slot_onehot.sum(1, dtype=torch.int32)
    ar = torch.arange(L, device=dev)
    w_iota = torch.arange(W, device=dev)
    bptr = bptr0.to(torch.int32)
    state, fok, fcr, alive = state0, fok0, fcr0, alive0
    failed_at = torch.full((L,), -1, dtype=torch.int32, device=dev)
    lossy = torch.zeros(L, dtype=torch.bool, device=dev)
    peak = torch.clamp(alive0.sum(1), min=1).to(torch.int32)
    snapped = torch.zeros(L, dtype=torch.bool, device=dev)
    bsnap, sst, sfo, sfc, sal = bptr, state0, fok0, fcr0, alive0
    grp_f, grp_v1, grp_v2 = tables["grp_f"], tables["grp_v1"], tables["grp_v2"]
    for t in range(T):
        if t % POLL_EVERY == 0 and not bool(
                ((bptr < n_active) & (failed_at < 0)).any()):
            break
        bc = torch.clamp(bptr, 0, B - 1).long()
        done = (bptr >= n_active) | (failed_at >= 0)
        cat = expand_candidates(
            step, eye_g, slot_lane, slot_mask, slot_onehot,
            state, fok, fcr, alive,
            tables["mov_f"][ar, bc], tables["mov_v1"][ar, bc],
            tables["mov_v2"][ar, bc], tables["mov_open"][ar, bc],
            grp_f, grp_v1, grp_v2, tables["grp_open"][ar, bc],
        )
        s2, fo2, fc2, a2, ovf, _fp, child = frontier_update_fast(
            *cat, F, n_parents=F, max_count=P + 1, dedup_backend=dedup,
        )
        # First overflow: snapshot the PRE-update frontier (exact: lossy
        # is still False) for the next rung to resume from.
        take = ovf & ~snapped & ~lossy & ~done
        snapped = snapped | take
        bsnap = torch.where(take, bc.to(torch.int32), bsnap)
        sst = torch.where(take[:, None], state, sst)
        sfo = torch.where(take[:, None, None], fok, sfo)
        sfc = torch.where(take[:, None, None], fcr, sfc)
        sal = torch.where(take[:, None], alive, sal)
        stable = ~(a2 & child).any(1)
        bslot = tables["bar_slot"][ar, bc]
        lane = (bslot // 32).long()
        bitmask = _bit(bslot)
        lane_vals = fo2.gather(2, lane[:, None, None].expand(L, F, 1))[:, :, 0]
        a3 = a2 & ((lane_vals & bitmask[:, None]) != 0)
        clear = torch.where(w_iota == lane[:, None], bitmask[:, None], 0)
        fo3 = fo2 & ~clear[:, None, :]
        adv = stable & ~done
        state = torch.where(done[:, None], state, s2)
        fok = torch.where(done[:, None, None], fok,
                          torch.where(adv[:, None, None], fo3, fo2))
        fcr = torch.where(done[:, None, None], fcr, fc2)
        alive = torch.where(done[:, None], alive,
                            torch.where(adv[:, None], a3, a2))
        none_left = ~a3.any(1)
        failed_at = torch.where(adv & none_left & ~lossy,
                                bc.to(torch.int32), failed_at)
        # a lossy lane can't refute: record no failure, report unknown
        failed_at = torch.where(adv & none_left & lossy, B + 1, failed_at)
        bptr = torch.where(adv, bptr + 1, bptr)
        lossy = lossy | (ovf & ~done)
        peak = torch.maximum(peak, alive.sum(1).to(torch.int32))
    finished = bptr >= n_active
    valid = finished & alive.any(1)
    # Budget exhaustion (neither finished nor failed) is loss.
    lossy_out = lossy | (~finished & (failed_at < 0)) | (failed_at > B)
    failed_out = torch.where(failed_at > B, -1, failed_at)
    bsnap = torch.where(snapped, bsnap, bptr)
    sst = torch.where(snapped[:, None], sst, state)
    sfo = torch.where(snapped[:, None, None], sfo, fok)
    sfc = torch.where(snapped[:, None, None], sfc, fcr)
    sal = torch.where(snapped[:, None], sal, alive)
    return valid, failed_out, lossy_out, peak, bsnap, sst, sfo, sfc, sal


def fresh_frontier(n: int, F: int, W: int, G: int, init_states):
    """Stage-one resume inputs for ``n`` lanes (numpy): barrier 0, one
    alive config per lane holding the lane's initial state."""
    bptr0 = np.zeros(n, np.int32)
    state0 = np.zeros((n, F), np.int32)
    state0[:] = np.asarray(init_states, np.int32)[:, None]
    fok0 = np.zeros((n, F, W), np.int32)
    fcr0 = np.zeros((n, F, G), np.int16)
    alive0 = np.zeros((n, F), bool)
    alive0[:, 0] = True
    return bptr0, state0, fok0, fcr0, alive0


def pad_resume(resume, F: int, W: int, G: int):
    """Re-bucket one lane's saved (bsnap, state, fok, fcr, alive) resume
    frontier (numpy) to the next stage's (F, W, G).  Growing pads with
    dead rows / zero columns; shrinking is safe because a history's own
    slots and groups always fit its own (P, G)."""
    bsnap, st, fo, fc, al = resume
    F0, W0 = fo.shape
    G0 = fc.shape[1]
    n_alive = int(al.sum())
    if n_alive > F:
        raise ValueError(f"resume frontier {n_alive} exceeds capacity {F}")
    out_st = np.zeros(F, np.int32)
    out_fo = np.zeros((F, W), np.int32)
    out_fc = np.zeros((F, G), np.int16)
    out_al = np.zeros(F, bool)
    k = min(F0, F)
    out_st[:k] = st[:k]
    out_fo[:k, : min(W0, W)] = fo[:k, : min(W0, W)]
    out_fc[:k, : min(G0, G)] = fc[:k, : min(G0, G)]
    out_al[:k] = al[:k]
    if F < F0 and al[F:].any():
        # compact alive rows first instead of truncating live configs
        sel = np.flatnonzero(al)[:F]
        out_st[: len(sel)] = st[sel]
        out_fo[: len(sel), : min(W0, W)] = fo[sel][:, : min(W0, W)]
        out_fc[: len(sel), : min(G0, G)] = fc[sel][:, : min(G0, G)]
        out_al[:] = False
        out_al[: len(sel)] = True
    return int(bsnap), out_st, out_fo, out_fc, out_al


# ---------------------------------------------------------------------------
# The barrier-scan engine ("sync"; fast and exact)
# ---------------------------------------------------------------------------

#: Host reads of the barrier-scan engine and the chunked engine (the
#: round flags "does any lane still close?", the active-barrier table,
#: each slice's verdict scalars and alive rows), counted so that a run
#: can report its host syncs per barrier.
SCAN_SYNCS = 0


def _popcount32(x):
    """Set bits per 32-bit word of int32 bit patterns, as int64."""
    x = x.to(torch.int64) & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _candidate_cost(cat_fok, cat_fcr):
    """The exact update's truncation priority of each candidate row:
    fired open ops plus fired crashed ops (the JAX package's ``cost``
    column of ``expand_candidates``), int32."""
    return (_popcount32(cat_fok).sum(-1)
            + cat_fcr.sum(-1, dtype=torch.int64)).to(torch.int32)


def _scan_chunk_core(step, F: int, R: int, fast: bool, state0, fok0, fcr0,
                     alive0, tables, slot_lane, slot_onehot,
                     dedup: str = "fused"):
    """Scan lane-batched frontiers over a chunk of barriers from explicit
    frontiers and return the final ones (the JAX package's
    ``_scan_chunk_core`` under vmap).

    Per barrier, closure rounds run while a lane still grows, up to
    ``R``: a round is ``expand_candidates`` and then the frontier update
    (``frontier_update_fast`` when ``fast``, whose no-growth signal ends
    the closure; else the exact ``frontier_update``, whose fingerprint
    fixpoint ends it).  Each lane's round is masked by its own
    ``(r < R) & changed`` and by ``done`` (failed earlier, or an inactive
    barrier), so a lane that reached its fixpoint keeps its frontier
    while others close further, as the vmapped ``while_loop`` keeps it.
    Then the barrier's return filter applies: rows that fired the
    returning op survive and its slot bit retires.  A closure still
    growing after ``R`` rounds is loss.

    ``tables``: the lane tables (``TABLE_ORDER`` and ``bar_active``,
    ``[L, Bc, ...]``).  The loop reads "does any lane still close?" back
    once a round (``SCAN_SYNCS``); the first round of a barrier runs
    unpolled except every ``POLL_EVERY`` barriers, since a round on a
    finished lane changes nothing.

    Returns (state, fok, fcr, alive, failed_at, lossy, peak): failed_at
    the chunk-local barrier where a lane's frontier died (-1 never);
    lossy and peak (the largest post-filter frontier) cover this chunk.
    """
    global SCAN_SYNCS
    dev = state0.device
    L = state0.shape[0]
    Bc = tables["bar_f"].shape[1]
    P = tables["mov_f"].shape[2]
    G = tables["grp_f"].shape[1]
    W = fok0.shape[2]
    eye_g = torch.eye(G, dtype=torch.int16, device=dev)
    slot_mask = slot_onehot.sum(1, dtype=torch.int32)
    w_iota = torch.arange(W, device=dev)
    grp = (tables["grp_f"], tables["grp_v1"], tables["grp_v2"])
    active = tables["bar_active"]
    any_active = active.any(0).tolist()
    SCAN_SYNCS += 1
    state, fok, fcr, alive = state0, fok0, fcr0, alive0
    failed_at = torch.full((L,), -1, dtype=torch.int32, device=dev)
    lossy = torch.zeros(L, dtype=torch.bool, device=dev)
    peak = torch.clamp(alive0.sum(1), min=1).to(torch.int32)
    fp0 = torch.full((L, 3), MASK32, dtype=torch.int64, device=dev)
    polled = 0
    for b in range(Bc):
        if not any_active[b]:
            continue
        done = (failed_at >= 0) | ~active[:, b]
        xmov = [tables[k][:, b] for k in ("mov_f", "mov_v1", "mov_v2", "mov_open")]
        xgrp_open = tables["grp_open"][:, b]
        s_w, fo_w, fc_w, a_w = state, fok, fcr, alive
        run = ~done  # lanes whose closure goes on: (r < R) & changed
        lossy_w = lossy
        fp = fp0
        for r in range(R):
            if r > 0 or polled % POLL_EVERY == 0:
                SCAN_SYNCS += 1
                if not bool(run.any()):
                    break
            if r == 0:
                polled += 1
            cat = expand_candidates(
                step, eye_g, slot_lane, slot_mask, slot_onehot,
                s_w, fo_w, fc_w, a_w, *xmov, *grp, xgrp_open,
            )
            if fast:
                s2, fo2, fc2, a2, ovf, _fp, child = frontier_update_fast(
                    *cat[:4], None, F, n_parents=F, max_count=P + 1,
                    dedup_backend=dedup,
                )
                grew = (a2 & child).any(1)
            else:
                s2, fo2, fc2, a2, ovf, fp2 = frontier_update(
                    *cat[:4], _candidate_cost(cat[1], cat[2]), F,
                    dedup_backend=dedup,
                )
                grew = ~(fp2 == fp).all(1)
                fp = torch.where(run[:, None], fp2, fp)
            s_w = torch.where(run[:, None], s2, s_w)
            fo_w = torch.where(run[:, None, None], fo2, fo_w)
            fc_w = torch.where(run[:, None, None], fc2, fc_w)
            a_w = torch.where(run[:, None], a2, a_w)
            lossy_w = lossy_w | (ovf & run)
            run = run & grew
        # a lane still growing after R rounds ran out of closure rounds
        lossy_w = lossy_w | run
        bslot = tables["bar_slot"][:, b]
        lane = (bslot // 32).long()
        bit = _bit(bslot)
        lane_vals = fo_w.gather(2, lane[:, None, None].expand(L, F, 1))[:, :, 0]
        a3 = a_w & ((lane_vals & bit[:, None]) != 0)
        clear = torch.where(w_iota == lane[:, None], bit[:, None], 0)
        fo3 = fo_w & ~clear[:, None, :]
        keep = done[:, None]
        state = torch.where(keep, state, s_w)
        fok = torch.where(keep[:, :, None], fok, fo3)
        fcr = torch.where(keep[:, :, None], fcr, fc_w)
        alive = torch.where(keep, alive, a3)
        failed_at = torch.where(~done & ~a3.any(1), b, failed_at)
        lossy = torch.where(done, lossy, lossy_w)
        peak = torch.where(done, peak,
                           torch.maximum(peak, a3.sum(1).to(torch.int32)))
    return state, fok, fcr, alive, failed_at, lossy, peak


def _run_core(step, F: int, R: int, fast: bool, init_state, tables,
              slot_lane, slot_onehot, dedup: str = "fused"):
    """Scan lane-batched histories over all barriers from each lane's
    single initial configuration.  Returns (any_alive, failed_at, lossy,
    peak), each [L]."""
    dev = init_state.device
    L = init_state.shape[0]
    W = slot_onehot.shape[1]
    G = tables["grp_f"].shape[1]
    state0 = init_state.to(torch.int32)[:, None].expand(L, F).contiguous()
    fok0 = torch.zeros(L, F, W, dtype=torch.int32, device=dev)
    fcr0 = torch.zeros(L, F, G, dtype=torch.int16, device=dev)
    alive0 = torch.zeros(L, F, dtype=torch.bool, device=dev)
    alive0[:, 0] = True
    _s, _fo, _fc, alive, failed_at, lossy, peak = _scan_chunk_core(
        step, F, R, fast, state0, fok0, fcr0, alive0, tables, slot_lane,
        slot_onehot, dedup=dedup)
    return alive.any(1), failed_at, lossy, peak


def batched_runner(step, F: int, R: int, init_state, tables, slot_lane,
                   slot_onehot, dedup: str = "fused"):
    """The "sync" engine: ``_run_core`` with the fast hash-dedup update
    over a stack of same-shape packed histories (the JAX package's
    vmapped runner, called directly).  Its refutations are hash-decided,
    so callers confirm them."""
    return _run_core(step, F, R, True, init_state, tables, slot_lane,
                     slot_onehot, dedup=dedup)


def exact_batched_runner(step, F: int, R: int, init_state, tables, slot_lane,
                         slot_onehot, dedup: str = "fused"):
    """``_run_core`` with the exact update (content compares and exact
    domination under every backend): its refutations are final."""
    return _run_core(step, F, R, False, init_state, tables, slot_lane,
                     slot_onehot, dedup=dedup)


#: The JAX package's runner-cache keys seen in this process (the port
#: has no jitted runners to cache; the keys keep its
#: ``wgl.runner_cache.*`` counters equal to the JAX package's).
_RUNNER_KEYS: set = set()


def runner_cache_counter(key, kind: str) -> None:
    """One ``wgl.runner_cache.hit``/``miss`` counter per runner lookup
    (``kind``: "greedy", "async", "sync" or "exact"): a miss is a key
    new to the process, where the JAX package pays a jit compile and the
    port its first-touch costs."""
    obs.counter(
        "wgl.runner_cache.hit" if key in _RUNNER_KEYS
        else "wgl.runner_cache.miss",
        kind=kind,
    )
    _RUNNER_KEYS.add(key)


def device_buffer_bytes(device=None) -> int | None:
    """Bytes the caching allocator holds in live tensors on ``device``
    (a CUDA device), or None on the CPU, which keeps no such count."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.memory_allocated(dev))


def _history_tables(packed: dict, device):
    """One packed history's engine tables on ``device`` with a lane axis
    of one (``TABLE_ORDER`` and ``bar_active``), and its slot tables."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)[None]

    cols = (list(packed["bar"]) + list(packed["mov"]) + list(packed["grp"])
            + [packed["grp_open"]])
    tables = {k: t(a) for k, a in zip(TABLE_ORDER, cols)}
    tables["bar_active"] = t(packed["bar_active"])
    slot_lane = torch.from_numpy(np.asarray(packed["slot_lane"])).long().to(device)
    slot_onehot = torch.from_numpy(
        fok_bits(packed["slot_onehot"])).to(device)
    return tables, slot_lane, slot_onehot


def _chunk_tables(tables: dict, lo: int, hi: int) -> dict:
    """The barriers [lo, hi) of a history's tables (views)."""
    per_group = ("grp_f", "grp_v1", "grp_v2")
    return {k: v if k in per_group else v[:, lo:hi] for k, v in tables.items()}


# ---------------------------------------------------------------------------
# The chunked single-history engine
# ---------------------------------------------------------------------------

#: Bound on slices per chunk attempt: slice-width narrowing stops at
#: ceil(n_in / _MAX_SLICES) entry rows per slice.
_MAX_SLICES = 64


class _LaunchDegraded(Exception):
    """A chunk scan's launch failed under ``faults.call_with_retry``:
    the capacity it ran at, the failure's one-line description, and the
    slice scans launched before it in this chunk attempt."""

    def __init__(self, capacity: int, cause: str, launches: int):
        self.capacity = capacity
        self.cause = cause
        self.launches = launches
        super().__init__(cause)


def _chunk_bounds(quiet, B0: int, target: int) -> list[tuple[int, int]]:
    """Split [0, B0) into chunks of at most ``target`` barriers, cut just
    after the latest quiescent barrier (whose only open ok op is the
    returning one) in the back half of each window where there is one:
    the carried frontier there has every fok bitset empty, its smallest
    summary."""
    bounds = []
    lo = 0
    while lo < B0:
        hi_max = min(lo + target, B0)
        hi = hi_max
        if hi_max < B0:
            for b in range(hi_max - 1, lo + target // 2 - 1, -1):
                if quiet[b]:
                    hi = b + 1
                    break
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _scan_slices(step, F: int, rounds: int, fast: bool, dedup: str,
                 c_tables: dict, slot_lane, slot_onehot, frontier,
                 cuts, width: int, W: int, G: int, dev):
    """Scan one chunk from each slice ``frontier[a : a + width]`` (``a``
    in ``cuts``) of the host frontier, each at the full capacity F, one
    single-lane scan per slice.  Returns the slice outputs (state, fok,
    fcr, alive on the device; failed_at, lossy, peak as host values)."""
    global SCAN_SYNCS
    f_state, f_fok, f_fcr = frontier
    n_in = f_state.shape[0]
    outs = []
    ctx = dict(what="wgl.chunk", engine="fast" if fast else "exact",
               capacity=F, lanes=1)
    for a in cuts:
        b = min(a + width, n_in)
        k = max(1, b - a)  # the initial 1-row frontier case
        st0 = np.zeros(F, np.int32)
        fo0 = np.zeros((F, W), np.int32)
        fc0 = np.zeros((F, G), np.int16)
        al0 = np.zeros(F, bool)
        st0[:k] = f_state[a:a + k]
        fo0[:k] = f_fok[a:a + k]
        fc0[:k] = f_fcr[a:a + k]
        al0[: b - a] = True

        def scan():
            s, fo, fc, al, failed_at, lossy, peak = _scan_chunk_core(
                step, F, rounds, fast,
                *(torch.from_numpy(x).to(dev)[None]
                  for x in (st0, fo0, fc0, al0)),
                c_tables, slot_lane, slot_onehot, dedup=dedup)
            fat, lz, pk = torch.stack([failed_at.long(), lossy.long(),
                                       peak.long()], 1)[0].tolist()
            return s[0], fo[0], fc[0], al[0], fat, bool(lz), pk

        try:
            out = faults.call_with_retry(scan, ctx)
        except faults.LaunchFailure as lf:
            cause = faults.describe(lf.cause)
            faults.release(lf)
            raise _LaunchDegraded(F, cause, len(outs)) from None
        SCAN_SYNCS += 1
        outs.append(out)
    return outs


class _Attempt(NamedTuple):
    """One chunk's scan (``_attempt_chunk``): the last attempt's slice
    outputs, whether it lost rows (``truncated``: the entry frontier was
    cut to the rung), its summed peak, the rung index it ran at; over
    every attempt, the slice scans launched, the extra slices spent
    (spill work) and the largest summed peak."""
    outs: list
    lossy: bool
    truncated: bool
    peak: int
    idx: int
    launches: int
    spent: int
    peak_max: int


def _attempt_chunk(step, rounds: int, fast: bool, dedup: str, c_tables: dict,
                   slot_lane, slot_onehot, frontier, caps, idx: int,
                   W: int, G: int, dev, *, spill: bool, usable=None,
                   narrow: bool = False, spill_left: int | None = None,
                   ring=None, on_event=None, barrier: int = 0,
                   count_slices: bool = False) -> _Attempt:
    """Scan one chunk from the carried host ``frontier``, the scan loop
    shared by ``chunked_analysis`` and ``scan_barrier_range``: climb the
    rungs of ``caps`` while the frontier does not fit, scan it (under
    ``spill`` in slices of at most the rung's rows, else truncated to
    the rung), and re-run from the same frontier at the next larger
    usable rung while any slice lost rows.  With ``narrow`` (a single
    barrier under spill), a loss at the top rung retries with slices
    half as wide, down to ``_MAX_SLICES`` slices, while the spill work
    (``spill_left`` extra slices and retries) lasts.  ``ring`` drops a
    failed attempt's pending rows.  ``on_event`` receives "escalation"
    and "slice-narrowing", each also counted (``wgl.chunk.escalations``,
    ``wgl.chunk.slice_narrowing``); ``count_slices`` counts a
    multi-slice attempt's slices (``wgl.chunk.slices``).  A launch that
    fails under the retry policy raises ``_LaunchDegraded`` (its
    launches counting every attempt's), with ``ring``'s pending rows
    dropped."""
    def ok(i: int) -> bool:
        return usable is None or usable(i)

    n_in = frontier[0].shape[0]
    while (idx + 1 < len(caps) and caps[idx] < n_in
           and caps[idx + 1] > caps[idx] and ok(idx + 1)):
        idx += 1
    launches = spent = peak_max = 0
    width = None  # entry rows per slice; F on entry, halves on retry
    while True:
        F = caps[idx]
        if width is None:
            width = F
        cuts = list(range(0, n_in, width)) if spill else []
        cuts = cuts or [0]
        if count_slices and len(cuts) > 1:
            obs.counter("wgl.chunk.slices", len(cuts))
        spent += len(cuts) - 1
        try:
            outs = _scan_slices(step, F, rounds, fast, dedup, c_tables,
                                slot_lane, slot_onehot, frontier, cuts, width,
                                W, G, dev)
        except _LaunchDegraded as e:
            if ring is not None:
                ring.discard()
            raise _LaunchDegraded(F, e.cause, launches + e.launches) from None
        launches += len(outs)
        # without spill, an entry frontier past F is truncated: loss
        trunc = not spill and n_in > F
        lossy = trunc or any(o[5] for o in outs)
        peak = sum(o[6] for o in outs)
        peak_max = max(peak_max, peak)
        nxt = idx + 1
        retry = False
        if lossy and nxt < len(caps) and caps[nxt] > caps[idx] and ok(nxt):
            obs.counter("wgl.chunk.escalations")
            if on_event is not None:
                on_event("escalation", barrier=barrier, to_capacity=caps[nxt])
            idx = nxt  # re-run this chunk wider, from the same frontier
            width = None
            retry = True
        elif (lossy and narrow and spent < spill_left
              and width > max(1, (n_in + _MAX_SLICES - 1) // _MAX_SLICES)):
            # a single barrier still overflowing: narrower slices at the
            # same capacity before declaring exhaustion
            obs.counter("wgl.chunk.slice_narrowing")
            if on_event is not None:
                on_event("slice-narrowing", barrier=barrier)
            spent += 1
            width = max(max(1, (n_in + _MAX_SLICES - 1) // _MAX_SLICES),
                        width // 2)
            retry = True
        if not retry:
            return _Attempt(outs, lossy, trunc, peak, idx, launches, spent,
                            peak_max)
        if ring is not None:
            ring.discard()


def _death(slice_outs) -> int | None:
    """The chunk-relative barrier at which every slice died (the latest
    slice's death), or None while any slice survives."""
    fails = [o[4] for o in slice_outs]
    return max(fails) if all(f >= 0 for f in fails) else None


def _step_down(idx: int, caps, peak: int, rows: int) -> int:
    """The rung for the next chunk: one down when the last chunk's peak
    left 4x headroom there and the carried frontier fits it."""
    if idx > 0 and peak * 4 <= caps[idx - 1] and rows <= caps[idx - 1]:
        return idx - 1
    return idx


def _survivors(slice_outs, ring):
    """The carried frontier after a chunk, as host arrays (state, fok
    int32 bits, fcr): one slice's alive rows directly (its output is an
    antichain already), or the surviving slices' rows through ``ring``
    and the exact merge."""
    global SCAN_SYNCS
    if len(slice_outs) == 1:
        s, fo, fc, al = slice_outs[0][:4]
        SCAN_SYNCS += 1
        sel = al.nonzero().squeeze(1)
        return (s[sel].cpu().numpy(), fo[sel].cpu().numpy(),
                fc[sel].cpu().numpy())
    for s, fo, fc, al, failed, _lz, _pk in slice_outs:
        if failed < 0:  # dead slices contribute no rows
            ring.push(s, fo, fc, al)
    popped = ring.pop_all()
    return spill_mod.merge_frontiers([popped] if popped is not None else [])[:3]


def chunked_analysis(
    model: m.Model,
    history: Sequence[dict],
    packed: dict,
    capacities: Sequence[int],
    rounds: int = 8,
    chunk_barriers: int = 512,
    fast: bool = False,
    dedup_backend: str | None = None,
    deadline=None,
    spill: bool | None = None,
    frontier_budget_mb: float | None = None,
    spill_factor: float = 4.0,
    spill_launches: int | None = None,
    factor_groups: bool | None = None,
    checkpoint_dir=None,
    resume: bool = False,
    device=None,
) -> dict:
    """Decide linearizability as a chain of chunk scans with a carried
    frontier, under a bounded device-memory contract (the JAX package's
    ``chunked_analysis``).

    The history's barriers split into chunks of at most
    ``chunk_barriers`` (``_chunk_bounds``).  Each chunk scans from the
    exact frontier the previous one left, on the barrier-scan engine
    (``_scan_chunk_core``, one lane) at the current rung of
    ``capacities``; an overflowing chunk re-runs from the same frontier
    at the next rung, and the rung steps back down when a chunk's peak
    leaves 4x headroom.

    Spill (``spill``; by default on when ``frontier_budget_mb`` or
    ``spill_launches`` is given): the sweep is linear in the frontier,
    so an entry frontier larger than the rung streams through the chunk
    scan in slices of at most the rung's rows.  The slices' survivors go
    to the host through a ``spill.HostRing`` and recombine by the exact
    ``spill.merge_frontiers``; refutation needs every slice to die.
    ``frontier_budget_mb`` (or JEPSEN_TPU_FRONTIER_BUDGET_MB) skips the
    rungs whose working set does not fit.  A chunk that still overflows
    at the highest usable rung bisects, down to single barriers, where
    the slices narrow; only then is the loss accepted, within a budget
    of extra launches (``spill_launches``, default 2 per chunk + 8).
    The host frontier is bounded by ``spill_factor`` times the widest
    usable rung.  ``factor_groups`` (default: with spill) first removes
    the trace-independent crashed-op groups (``spill.factor_packed``).

    Soundness: True needs only a surviving frontier.  False is reported
    only when no chunk lost rows up to the death; with ``fast`` it is
    marked ``provisional?`` (hash-decided kills).  An unknown that
    exhausted memory carries ``spill.undecidability_report``.  Stats
    under ``"kernel"``: frontier-peak, capacity, lossy?, chunks,
    launches (chunk-slice scans), spill-rows, spill-bytes, factors,
    verified-barriers (passed with no loss), witnessed-barriers, and
    bar-opid at a death.

    Services, as in the JAX package: ``deadline`` (seconds or a
    ``faults.Deadline``) is polled at chunk boundaries, and on expiry the
    run returns ``unknown`` with cause ``deadline-exceeded`` (and a
    pointer to the checkpoint, when one is kept).  Every chunk scan runs
    under ``faults.call_with_retry``; a scan that still fails (or runs
    out of memory: one history has no sub-batch to halve) degrades this
    history to ``unknown``, its cause naming the error.
    ``checkpoint_dir`` persists the scan cursor and the carried frontier
    (host-spilled rows included) after every accepted chunk
    (``store.checkpoint.save_chunked``); ``resume=True`` reloads it when
    its fingerprint and config match (else the stale pair is quarantined
    and the scan starts fresh), so a kill between chunks and a resume
    give the uninterrupted verdict; a finished run's checkpoint returns
    its saved result.  Every result carries a ``provenance`` block: the
    scan, its escalations, bisections, slice narrowing, truncations and
    fault events.  ``device``: the card unless the caller asks for
    "cpu".
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    dedup = resolve_dedup_backend(dedup_backend)
    deadline = faults.Deadline.coerce(deadline)
    B0 = packed["B"]
    quiet = packed["bar_quiet"]
    budget_mb = spill_mod.resolve_budget_mb(frontier_budget_mb)
    spill_on = (
        bool(spill) if spill is not None
        else (budget_mb is not None or spill_launches is not None)
    )
    if factor_groups is None:
        factor_groups = spill_on
    factors = 0
    if factor_groups:
        packed, factors = spill_mod.factor_packed(packed)
    packed = pad_packed(packed, B=B0)  # bucket P/G; keep B for slicing
    P, G, W = packed["P"], packed["G"], packed["W"]
    caps = [int(c) for c in capacities]
    b_rows = spill_mod.budget_rows(budget_mb, W, G, P)
    step = packed["step"]

    # The decision path (obs.provenance) attached to every return.
    traj: list[dict] = []
    prov_engine = {
        "engine": "chunked-fast" if fast else "chunked-exact",
        "dedup_backend": dedup, "spill": spill_on,
    }
    prov_cfg = {
        "capacity": caps, "rounds": int(rounds),
        "chunk_barriers": int(chunk_barriers), "fast": bool(fast),
        "frontier_budget_mb": budget_mb,
        "spill_launches": spill_launches, "factor_groups": bool(factor_groups),
    }

    def _pv(event: str, **attrs) -> None:
        if len(traj) < _prov.MAX_PATH:
            traj.append({"event": event, **attrs})

    def _finish(res: dict) -> dict:
        return _prov.attach(res, traj, engine=prov_engine, config=prov_cfg)

    def _usable(i: int) -> bool:
        """Rung i fits the device budget (rung 0 always runs)."""
        return i == 0 or b_rows is None or caps[i] <= b_rows

    top_usable = max(c for i, c in enumerate(caps) if _usable(i))
    host_rows_max = max(int(spill_factor * top_usable), top_usable)

    f_state = np.array([packed["init_state"]], np.int32)
    f_fok = np.zeros((1, W), np.int32)
    f_fcr = np.zeros((1, G), np.int16)
    idx = 0
    lossy_any = False
    peak_g = 1
    verified = 0
    launches = 0
    start_barrier = 0
    resume_spill_spent = 0
    ring = spill_mod.HostRing(W, G)
    exhaust_rep: dict | None = None

    # ------------------------------------------------------------------
    # Chunk checkpoint and resume (store.checkpoint's chunk pair).
    # ------------------------------------------------------------------
    ckpt = None
    ck_cfg = None
    if checkpoint_dir is not None or resume:
        from jepsen_tpu_torch.store import checkpoint as ckpt

        ck_cfg = {
            "fingerprint": ckpt.fingerprint([history]),
            "capacity": caps, "rounds": int(rounds),
            "chunk_barriers": int(chunk_barriers), "fast": bool(fast),
            "dedup": dedup, "budget_mb": budget_mb,
            "spill_factor": float(spill_factor),
            "spill_launches": spill_launches,
            "factor_groups": bool(factor_groups), "spill": spill_on,
        }
    if (resume and checkpoint_dir is not None
            and ckpt.chunked_exists(checkpoint_dir)):
        saved = None
        try:
            saved = ckpt.load_chunked(checkpoint_dir)
        except ckpt.CheckpointError as e:
            logger.warning("unreadable chunk checkpoint in %s (%s); running "
                           "fresh", checkpoint_dir, e)
            obs.counter("fault.checkpoint.mismatch", reason="unreadable")
        if saved is not None and saved["config"] != ck_cfg:
            quarantined = ckpt.quarantine_chunked(
                checkpoint_dir, reason="stale-fingerprint")
            logger.warning(
                "chunk checkpoint in %s was written for different inputs "
                "or config; running fresh (stale files quarantined: %s)",
                checkpoint_dir, quarantined)
            obs.counter("fault.checkpoint.quarantined",
                        reason="fingerprint", files=quarantined)
            obs.counter("fault.checkpoint.mismatch", reason="fingerprint")
            saved = None
        if saved is not None:
            if saved["result"] is not None:
                # a finished run: its result, provenance and all
                obs.span_event(
                    "fault.checkpoint.load", 0.0,
                    barrier=int(saved["barrier"]), chunked=True,
                    complete=True,
                )
                return saved["result"]
            st, fo, fc = saved["frontier"]
            f_state = np.asarray(st, np.int32)
            f_fok = fok_bits(fo)
            f_fcr = np.asarray(fc, np.int16)
            start_barrier = saved["barrier"]
            idx = min(saved["cap_idx"], len(caps) - 1)
            lossy_any = saved["lossy"]
            verified = saved["verified"]
            launches = saved["launches"]
            resume_spill_spent = saved.get("spill_spent", 0)
            obs.span_event(
                "fault.checkpoint.load", 0.0, barrier=start_barrier,
                rows=int(f_state.shape[0]), chunked=True,
            )
            _pv("checkpoint.restored", barrier=start_barrier)

    def _save_ck(barrier: int, result: dict | None = None) -> str | None:
        """Persist the chunk cursor and the carried frontier (fok as the
        JAX package's uint32); a failed save is logged, never fatal."""
        if checkpoint_dir is None:
            return None
        try:
            p = ckpt.save_chunked(
                checkpoint_dir, config=ck_cfg, barrier=barrier, cap_idx=idx,
                frontier=(f_state, np.asarray(f_fok).view(np.uint32), f_fcr),
                lossy=lossy_any, verified=verified, launches=launches,
                spill_rows=ring.rows_total, spill_bytes=ring.bytes_total,
                spill_spent=spill_spent, result=result,
            )
            return str(p)
        except Exception:  # noqa: BLE001 — a recovery aid, not a verdict input
            logger.warning("couldn't write chunk checkpoint to %s",
                           checkpoint_dir, exc_info=True)
            obs.counter("fault.checkpoint.error")
            return None

    def _offset_bounds(start: int) -> list[tuple[int, int]]:
        if start >= B0:
            return []
        rel = _chunk_bounds(quiet[start:], B0 - start, int(chunk_barriers))
        return [(start + a, start + b) for a, b in rel]

    spans = _offset_bounds(start_barrier)
    n_spans0 = len(spans)
    # the whole history's span count: a resumed run's default spill
    # budget must equal the uninterrupted run's
    n_spans_full = n_spans0 if start_barrier == 0 else len(_offset_bounds(0))
    spill_budget = (
        int(spill_launches) if spill_launches is not None
        else 2 * max(1, n_spans_full) + 8
    )
    spill_spent = resume_spill_spent
    tables, slot_lane, slot_onehot = _history_tables(packed, dev)

    def _stats(capacity: int) -> dict:
        s = {
            "frontier-peak": peak_g, "capacity": capacity,
            "lossy?": lossy_any, "chunks": n_spans0, "launches": launches,
            "spill-rows": ring.rows_total, "spill-bytes": ring.bytes_total,
        }
        if factors:
            s["factors"] = factors
        return s

    def _emit(valid, stats: dict) -> None:
        """One ``wgl.chunked`` span per run: the frontier sweep's
        occupancy, loss and spill."""
        obs.span_event(
            "wgl.chunked", time.perf_counter() - t0, valid=valid,
            chunks=stats.get("chunks"), launches=stats.get("launches"),
            peak_frontier=stats.get("frontier-peak"),
            capacity=stats.get("capacity"), lossy=stats.get("lossy?"),
            verified_barriers=stats.get("verified-barriers"), dedup=dedup,
            spill_rows=stats.get("spill-rows"),
            spill_bytes=stats.get("spill-bytes"),
            factors=stats.get("factors"),
        )

    def _report(**kw) -> dict:
        return spill_mod.undecidability_report(
            barriers_total=B0, budget_mb=budget_mb, budget_rows=b_rows,
            spill_rows=ring.rows_total, spill_bytes=ring.bytes_total,
            factor_count=factors, device_buffer_bytes=device_buffer_bytes(dev),
            **kw)

    def _attach_report(res: dict) -> dict:
        """An unknown that exhausted fixed memory carries the report; only
        the generic capacity cause is rewritten to it (a deadline or a
        failed launch keeps its own cause)."""
        if exhaust_rep is not None and res.get("valid?") == "unknown":
            res["undecidability"] = exhaust_rep
            if res.get("cause") in (
                    None, "frontier capacity or closure rounds exhausted"):
                res["cause"] = spill_mod.undecidable_cause(exhaust_rep)
        return res

    _pv("wgl.chunk.scan", barriers=int(B0), chunks=len(spans),
        capacity=caps[idx], start_barrier=start_barrier)
    si = 0
    while si < len(spans):
        lo, hi = spans[si]
        if deadline is not None and deadline.expired():
            obs.counter("fault.deadline.trip")
            obs.event("fault.deadline", at="wgl-chunk", barrier=lo)
            _pv("fault.deadline", at="wgl-chunk", barrier=lo)
            ck = _save_ck(lo)
            note = f"; resumable checkpoint: {ck}" if ck else ""
            stats = _stats(caps[idx])
            stats["verified-barriers"] = verified
            _emit("unknown", stats)
            return _finish(_attach_report({
                "valid?": "unknown",
                "cause": ("deadline-exceeded: check budget exhausted at "
                          f"barrier {lo}/{B0}{note}"),
                "kernel": stats,
            }))
        n_in = f_state.shape[0]

        def on_event(event: str, **attrs) -> None:
            _pv("chunk." + event, **attrs)

        try:
            att = _attempt_chunk(
                step, int(rounds), fast, dedup, _chunk_tables(tables, lo, hi),
                slot_lane, slot_onehot, (f_state, f_fok, f_fcr), caps, idx,
                W, G, dev, spill=spill_on, usable=_usable,
                narrow=spill_on and (hi - lo) == 1,
                spill_left=spill_budget - spill_spent, ring=ring,
                on_event=on_event, barrier=lo, count_slices=True)
        except _LaunchDegraded as e:
            launches += e.launches
            obs.counter("fault.launch.degraded", what="wgl.chunk",
                        capacity=e.capacity, lanes=1, error=e.cause)
            _pv("fault.launch-degraded", capacity=e.capacity, error=e.cause)
            stats = _stats(e.capacity)
            stats["verified-barriers"] = verified
            _emit("unknown", stats)
            return _finish(_attach_report({
                "valid?": "unknown",
                "cause": f"device launch failed: {e.cause}",
                "kernel": stats,
            }))
        slice_outs, any_lossy, peak_total, idx = (att.outs, att.lossy,
                                                  att.peak, att.idx)
        launches += att.launches
        spill_spent += att.spent
        peak_g = max(peak_g, att.peak_max)
        if (any_lossy and spill_on and spill_spent < spill_budget
                and (hi - lo) > 1):
            # bisect the chunk, so that the frontier is re-checked (and
            # spilled) at its midpoint
            ring.discard()
            rel = _chunk_bounds(quiet[lo:hi], hi - lo,
                                max(1, (hi - lo + 1) // 2))
            spans[si:si + 1] = [(lo + a, lo + b) for a, b in rel]
            obs.counter("wgl.chunk.bisections")
            _pv("chunk.bisection", barrier=lo)
            spill_spent += 1
            continue
        if spill_on and spill_spent >= spill_budget:
            # the spill work budget is spent: truncation from here on
            spill_on = False
            _pv("spill.budget-exhausted", barrier=lo)
            if exhaust_rep is None:
                exhaust_rep = _report(
                    capacity=caps[idx], frontier_rows=n_in,
                    peak_frontier=peak_total, barrier=lo,
                    reason="spill-budget")
        if any_lossy and exhaust_rep is None:
            # the kernel reports the post-filter peak; a lossy round
            # overflowed the capacity, so the closure peak is > capacity
            exhaust_rep = _report(
                capacity=caps[idx], frontier_rows=n_in,
                peak_frontier=max(peak_total, caps[idx] + 1), barrier=lo)
        lossy_any |= any_lossy
        if att.truncated:
            obs.counter("wgl.frontier.truncations")
        if obs.observing():
            # the carried frontier's chunk-boundary device footprint
            # (None on the CPU, which keeps no allocator count)
            db = device_buffer_bytes(dev)
            if db is not None:
                obs.gauge("device.buffer_bytes", db, at="wgl-chunk",
                          barrier=lo)
        died = _death(slice_outs)
        if died is not None:
            gb = lo + died
            op_pos = int(packed["bar_opid"][gb])
            stats = _stats(caps[idx])
            stats["bar-opid"] = op_pos
            stats["verified-barriers"] = verified
            stats["witnessed-barriers"] = gb
            if lossy_any:
                _pv("chunk.lossy-death", barrier=gb)
                _emit("unknown", stats)
                return _finish(_attach_report({
                    "valid?": "unknown",
                    "cause": "frontier capacity or closure rounds exhausted",
                    "op": history[op_pos],
                    "kernel": stats,
                }))
            _pv("chunk.refuted", barrier=gb, provisional=bool(fast))
            res = {"valid?": False, "op": history[op_pos], "kernel": stats}
            if fast:
                res["provisional?"] = True  # hash-decided kills
            _emit(False, stats)
            return _finish(res)
        if not lossy_any:
            verified = hi
        f_state, f_fok, f_fcr = _survivors(slice_outs, ring)
        del slice_outs
        rows = int(f_state.shape[0])
        if rows > host_rows_max:
            # the host bound: truncate (the most speculative rows last in
            # candidate order drop first) and latch loss
            if exhaust_rep is None:
                exhaust_rep = _report(
                    capacity=caps[idx], frontier_rows=rows,
                    peak_frontier=peak_g, barrier=hi, reason="host-budget")
            obs.counter("wgl.frontier.truncations")
            _pv("frontier.truncated", reason="host-budget", barrier=hi)
            f_state = f_state[:host_rows_max]
            f_fok = f_fok[:host_rows_max]
            f_fcr = f_fcr[:host_rows_max]
            lossy_any = True
            rows = host_rows_max
        idx = _step_down(idx, caps, peak_total, rows)
        _save_ck(hi)
        si += 1
    stats = _stats(caps[idx])
    stats["verified-barriers"] = verified
    stats["witnessed-barriers"] = B0  # the survivor is the whole witness
    _emit(True, stats)
    result = _finish({"valid?": True, "kernel": stats})
    _save_ck(B0, result=result)
    return result


def scan_barrier_range(
    packed: dict,
    frontier: tuple,
    lo: int,
    hi: int,
    *,
    capacities: Sequence[int],
    rounds: int = 8,
    chunk_barriers: int = 512,
    cap_idx: int = 0,
    lossy: bool = False,
    fast: bool = False,
    dedup_backend: str | None = None,
    spill: bool = False,
    on_event=None,
    device=None,
) -> dict:
    """Advance a carried frontier through barriers ``[lo, hi)`` of an
    already-padded pack, chunk by chunk through ``chunked_analysis``'s
    own chunk attempt (``_attempt_chunk``), without its device budget,
    bisection or slice narrowing, so that an incremental caller can
    extend a scan range by range (the JAX package's
    ``scan_barrier_range``).

    ``packed`` is ``pad_packed`` output with ``B`` kept at the true
    barrier count; ``frontier`` the carried ``(state, fok, fcr)`` host
    arrays at the pack's (W, G), fok as uint32 or int32 bit patterns.
    Chunk cuts and the capacity ladder are ``chunked_analysis``'s.
    ``spill`` slices an overflowing entry frontier through the same scan
    and merges the survivors exactly; without it the overflow truncates
    and latches ``lossy``.  ``on_event(event, **attrs)`` receives the
    escalation, truncation and launch-degraded events.  Each chunk scan
    runs under ``faults.call_with_retry``; one that still fails ends the
    range with ``"error"`` set to its description.  ``device``: the card
    unless the caller asks for "cpu".

    Returns {"frontier": surviving (state, fok int32 bits, fcr),
    "failed_barrier": the global barrier the frontier died at or None,
    "cap_idx", "lossy": to thread into the next call, "launches",
    "peak", "error": None or the failed launch's description}.
    """
    dev = resolve_device(device)
    dedup = resolve_dedup_backend(dedup_backend)
    caps = [int(c) for c in capacities]
    P, G, W = packed["P"], packed["G"], packed["W"]
    quiet = packed["bar_quiet"]
    f_state = np.asarray(frontier[0], np.int32)
    f_fok = fok_bits(frontier[1])
    f_fcr = np.asarray(frontier[2], np.int16)
    idx = min(max(int(cap_idx), 0), len(caps) - 1)
    lossy_any = bool(lossy)
    launches = 0
    peak_g = 0

    def _ev(event: str, **attrs) -> None:
        if on_event is not None:
            on_event(event, **attrs)

    def _out(failed=None, error=None):
        return {
            "frontier": (f_state, f_fok, f_fcr),
            "failed_barrier": failed, "cap_idx": idx, "lossy": lossy_any,
            "launches": launches, "peak": peak_g, "error": error,
        }

    if hi <= lo:
        return _out()
    tables, slot_lane, slot_onehot = _history_tables(packed, dev)
    spans = [
        (lo + a, lo + b)
        for a, b in _chunk_bounds(quiet[lo:hi], hi - lo, int(chunk_barriers))
    ]
    for clo, chi in spans:
        try:
            att = _attempt_chunk(
                packed["step"], int(rounds), fast, dedup,
                _chunk_tables(tables, clo, chi), slot_lane, slot_onehot,
                (f_state, f_fok, f_fcr), caps, idx, W, G, dev, spill=spill,
                on_event=_ev, barrier=clo)
        except _LaunchDegraded as e:
            launches += e.launches
            obs.counter("fault.launch.degraded", what="wgl.chunk",
                        capacity=e.capacity, lanes=1, error=e.cause)
            _ev("launch-degraded", capacity=e.capacity, error=e.cause)
            return _out(error=e.cause)
        idx = att.idx
        launches += att.launches
        peak_g = max(peak_g, att.peak_max)
        lossy_any |= att.lossy
        if att.truncated:
            obs.counter("wgl.frontier.truncations")
            _ev("truncated", barrier=clo)
        died = _death(att.outs)
        if died is not None:
            return _out(failed=clo + died)
        f_state, f_fok, f_fcr = _survivors(att.outs, spill_mod.HostRing(W, G))
        idx = _step_down(idx, caps, att.peak, int(f_state.shape[0]))
        del att
    return _out()


def _admit(model, history, max_groups: int, max_procs: int):
    """Pack one history for the single-history entry points: (packed,
    None), or (None, the result that decides it without the engines)."""
    try:
        packed = pack(model, history)
    except NotTensorizable as e:
        return None, {"valid?": "unknown", "cause": f"not tensorizable: {e}"}
    if packed["B"] == 0:
        return None, {"valid?": True}
    if packed["G"] > max_groups:
        return None, {"valid?": "unknown",
                      "cause": f"{packed['G']} crashed-op groups exceeds {max_groups}"}
    if packed["P"] > max_procs:
        return None, {"valid?": "unknown",
                      "cause": f"{packed['P']} process slots exceeds {max_procs}"}
    return packed, None


def analysis(
    model: m.Model,
    history: Sequence[dict],
    capacity: int | Sequence[int] = (128, 1024, 4096),
    rounds: int = 8,
    max_groups: int = 64,
    max_procs: int = 128,
    chunk_barriers: int = 512,
    fast: bool = False,
    dedup_backend: str | None = None,
    deadline=None,
    spill: bool | None = None,
    frontier_budget_mb: float | None = None,
    spill_factor: float = 4.0,
    spill_launches: int | None = None,
    factor_groups: bool | None = None,
    checkpoint_dir=None,
    resume: bool = False,
    device=None,
) -> dict:
    """Decide one history's linearizability on the card (the JAX
    package's ``wgl.analysis``).

    Knossos-shaped result: ``{"valid?": True|False|"unknown", ...}`` with
    engine stats under ``"kernel"``.  True is always exact; False is
    exact unless the frontier lost rows (then "unknown"), and provisional
    with ``fast``.  ``capacity`` may be a sequence: the per-chunk
    escalation ladder of ``chunked_analysis``, which takes every other
    argument, the services (``deadline``, ``checkpoint_dir``,
    ``resume``) among them.  ``device``: the card unless the caller asks
    for "cpu"."""
    packed, decided = _admit(model, history, max_groups, max_procs)
    if decided is not None:
        if decided["valid?"] is True:
            decided["configs"] = [{"model": model}]
        return decided
    capacities = [capacity] if isinstance(capacity, int) else list(capacity)
    return chunked_analysis(
        model, history, packed, capacities, rounds, chunk_barriers, fast=fast,
        dedup_backend=dedup_backend, deadline=deadline, spill=spill,
        frontier_budget_mb=frontier_budget_mb, spill_factor=spill_factor,
        spill_launches=spill_launches, factor_groups=factor_groups,
        checkpoint_dir=checkpoint_dir, resume=resume, device=device,
    )


def greedy_analysis(
    model: m.Model,
    history: Sequence[dict],
    max_groups: int = 64,
    max_procs: int = 128,
    device=None,
) -> dict:
    """The greedy witness walk on one history (``greedy_run``, one
    lane): True (a witness) or "unknown", never False.  ``device``: the
    card unless the caller asks for "cpu"."""
    packed, decided = _admit(model, history, max_groups, max_procs)
    if decided is not None:
        return decided
    dev = resolve_device(device)
    n_active = int(packed["bar_active"].sum())
    packed = pad_packed(packed)
    tables, slot_lane, slot_onehot = _history_tables(packed, dev)
    init = torch.tensor([int(packed["init_state"])], dtype=torch.int32,
                        device=dev)
    finished, stuck_at, fired = greedy_run(
        packed["step"], packed["B"], init,
        torch.tensor([n_active], dtype=torch.int32, device=dev), tables,
        slot_lane, slot_onehot)
    finished, stuck_at, fired = (int(x) for x in torch.stack(
        [finished.long(), stuck_at.long(), fired.long()], 1)[0].tolist())
    stats = {"engine": "greedy", "fired-crashed": fired}
    if finished:
        return {"valid?": True, "kernel": stats}
    return {
        "valid?": "unknown",
        "cause": "greedy walk stuck (no single-enabler move)",
        "op": history[int(packed["bar_opid"][stuck_at])],
        "kernel": {**stats, "stuck-at": stuck_at},
    }


def analysis_async(
    model: m.Model,
    history: Sequence[dict],
    capacity: int = 128,
    ticks: int | None = None,
    max_groups: int = 64,
    max_procs: int = 128,
    dedup_backend: str | None = None,
    device=None,
) -> dict:
    """One history on the lane-asynchronous engine (``run_async``, one
    lane), from barrier 0 at ``capacity`` rows with ``ticks`` ticks
    (default ``async_ticks``).  Its refutations are hash-decided.
    ``device``: the card unless the caller asks for "cpu"."""
    dedup = resolve_dedup_backend(dedup_backend)
    packed, decided = _admit(model, history, max_groups, max_procs)
    if decided is not None:
        return decided
    dev = resolve_device(device)
    n_active = int(packed["bar_active"].sum())
    packed = pad_packed(packed)
    B = packed["B"]
    T = int(ticks) if ticks is not None else async_ticks(B)
    F, W, G = int(capacity), packed["W"], packed["G"]
    t0 = time.perf_counter()
    tables, slot_lane, slot_onehot = _history_tables(packed, dev)
    fresh = fresh_frontier(1, F, W, G, [packed["init_state"]])
    out = run_async(
        packed["step"], F, T,
        *(torch.from_numpy(a).to(dev) for a in fresh),
        torch.tensor([n_active], dtype=torch.int32, device=dev), tables,
        slot_lane, slot_onehot, dedup=dedup)
    valid, failed_at, lossy, peak = (int(x) for x in torch.stack(
        [o.long() for o in out[:4]], 1)[0].tolist())
    stats = {"frontier-peak": peak, "capacity": F, "ticks": T,
             "lossy?": bool(lossy)}
    obs.span_event(
        "wgl.async", time.perf_counter() - t0, valid=bool(valid),
        lossy=bool(lossy), peak_frontier=peak, capacity=F, ticks=T,
        dedup=dedup,
    )
    if valid:
        return {"valid?": True, "kernel": stats}
    if not lossy:
        op = None
        if 0 <= failed_at < len(packed["bar_opid"]):
            op_pos = int(packed["bar_opid"][failed_at])
            op = history[op_pos]
            stats["bar-opid"] = op_pos
        return {"valid?": False, "op": op, "kernel": stats}
    return {
        "valid?": "unknown",
        "cause": "frontier capacity or tick budget exhausted",
        "kernel": stats,
    }
