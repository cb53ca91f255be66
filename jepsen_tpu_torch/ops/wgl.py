"""Frontier-parallel Wing–Gong–Lowe linearizability search, in torch.

The port of the JAX package's ``ops/wgl.py`` main-path engines: packing
histories into barrier tables, the batched greedy witness walk, and the
lane-asynchronous frontier engine.  The JAX engines are ``jit(vmap(...))``
of a ``lax.scan`` / ``lax.while_loop``; here the lane axis is written out
(every tensor is ``[L, ...]``) and the loops are host loops over batched
tensor ops.

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

from typing import Sequence

import numpy as np
import torch

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import models as m
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.models import tensor as tmodels
from jepsen_tpu_torch.ops.hashing import frontier_update_fast


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
