"""State carried across from the JAX package: packed histories, ladder
resume snapshots, host frontiers and mesh-update outputs.

The JAX package's ``wgl.pack`` tables and its engines' resume snapshots
are plain numpy arrays (plus the JAX step function).  These converters
turn them into the port's forms so that a run can continue in the port
from where a JAX run stood.  They take numpy only and import nothing of
the JAX package: the JAX step is mapped to the port's step by the
function's name, which is the same in both packages' ``models/tensor``.
"""

from __future__ import annotations

import numpy as np

from jepsen_tpu_torch.models import tensor as tmodels

#: The JAX package's TensorModel step-function names -> model names.
_STEP_MODELS = {
    tm.step.__name__: name for name, tm in tmodels.REGISTRY.items()
}


def port_step(step):
    """The port's torch step for a JAX package step function, by the
    step function's name."""
    name = _STEP_MODELS.get(getattr(step, "__name__", None))
    if name is None:
        raise ValueError(f"no port step for {step!r}")
    return tmodels.REGISTRY[name].step


def fok_bits(a) -> np.ndarray:
    """A uint32 bitset array (a JAX frontier's fok, a slot table) as the
    port's int32 bit patterns; int32 bit patterns pass unchanged."""
    return np.ascontiguousarray(np.asarray(a).astype(np.uint32).view(np.int32))


def from_jax_packed(packed: dict) -> dict:
    """A JAX ``wgl.pack`` (or ``pad_packed``) dict as the port's packed
    dict: the same tables, ``step`` mapped to the port's torch step, and
    ``slot_onehot`` as int32 bit patterns."""
    out = dict(packed)
    out["step"] = port_step(packed["step"])
    out["slot_onehot"] = fok_bits(packed["slot_onehot"])
    out["slot_lane"] = np.asarray(packed["slot_lane"], np.int32)
    return out


def from_jax_mesh(out, devices: int):
    """A JAX ``mesh_update`` result (the shards' outputs concatenated
    ``[D*Fl]``, overflow and fingerprint replicated) in the port's
    layout: state, fok (int32 bit patterns), fcr (int16), alive and child
    as ``[D, Fl]`` shard tables, overflow as a bool, the fingerprint as
    ``[3]`` int64."""
    state, fok, fcr, alive, ovf, fp, child = (np.asarray(a) for a in out)
    D = int(devices)

    def shards(a):
        return a.reshape(D, a.shape[0] // D, *a.shape[1:])

    fp = fp.astype(np.int64).reshape(-1, 3)
    return (
        shards(state.astype(np.int32)),
        shards(fok_bits(fok)),
        shards(fcr.astype(np.int16)),
        shards(alive.astype(bool)),
        bool(ovf.ravel()[0]),
        fp[0],
        shards(child.astype(bool)),
    )


def from_jax_resume(snap):
    """A JAX ladder resume snapshot ``(bsnap, state, fok, fcr, alive)``
    (one lane, or lane-batched with a leading axis) as the port's:
    int32 state, fok as int32 bit patterns, int16 counts, bool alive."""
    bsnap, state, fok, fcr, alive = snap
    bs = np.asarray(bsnap)
    return (
        int(bs) if bs.ndim == 0 else bs.astype(np.int32),
        np.asarray(state, np.int32),
        fok_bits(fok),
        np.asarray(fcr, np.int16),
        np.asarray(alive, bool),
    )
