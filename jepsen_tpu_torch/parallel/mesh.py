"""The port's device mesh: D logical shards of one card.

The JAX package runs its mesh-spanning wide stage under ``shard_map``:
one controller, one program per device of a ``jax.sharding.Mesh``, with
the exchange as remote DMA between chips.  The port keeps the
single-controller form and puts all D shards on one device: every
sharded table carries a leading shard axis ``[D, ...]`` and the
exchange kernel (``ops.wide_kernel.mesh_exchange``) moves rows between
the shards' slots with one launch.  On one card the shards give no
capacity that a single shard could not (the port's fused gate has no
VMEM term); what they buy is the JAX package's mesh semantics,
bit-identical per shard.  Shards on different cards are not ported yet
(ROADMAP queue B, the cross-card mesh).
"""

from __future__ import annotations

from dataclasses import dataclass

from jepsen_tpu_torch._platform import resolve_device

#: The ROADMAP item a mesh across cards waits for (named in refusals).
CROSS_CARD = "ROADMAP queue B: the cross-card mesh"


@dataclass(frozen=True)
class Mesh:
    """D logical shards and the device each lies on (all the same one),
    with the axis name the JAX package's mesh calls them by."""

    devices: tuple
    axis: str = "frontier"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                f"shards on different devices {sorted(map(str, set(self.devices)))}"
                f" are not ported; {CROSS_CARD}")

    @property
    def size(self) -> int:
        """The number of shards, D."""
        return len(self.devices)

    @property
    def device(self):
        """The one device every shard lies on."""
        return self.devices[0]


def make_mesh(n_shards: int, device=None, axis: str = "frontier") -> Mesh:
    """A mesh of ``n_shards`` logical shards, all on ``resolve_device(
    device)`` (the card unless the caller asks for the CPU)."""
    if int(n_shards) < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    dev = resolve_device(device)
    return Mesh((dev,) * int(n_shards), axis)


def mesh_device_ids(mesh: Mesh | None) -> list[int]:
    """The device index of each shard in shard order (the CPU and an
    unindexed card count as 0), or ``[0]`` without a mesh."""
    if mesh is None:
        return [0]
    return [d.index or 0 for d in mesh.devices]
