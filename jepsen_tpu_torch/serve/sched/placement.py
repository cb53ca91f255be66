"""Placement: which shards a packed batch launches on.

The port of the JAX package's ``serve.sched.placement`` on the port's
``parallel.mesh.Mesh`` of logical shards.  In the JAX package placing a
packed batch on an N-device mesh shards the ladder's lane axis across
the devices.  The port's mesh is D logical shards of one card: its
ladder runs every rung on that card and uses the shards for the mesh
rescue, the mesh-spanning fused stage that takes the lanes the last
rung leaves undecided (``parallel.batch.batch_analysis(mesh=...)``,
``parallel.sharded.mesh_kernel_analysis``), so a placement of
``devices=4`` under the "fused" backend is what sends exhausted lanes
through the exchange kernel.  Lanes are not spread across shards
(ROADMAP C4).

Placement is pure arbitration, WHERE and never WHAT: a launch with the
mesh must give the verdicts a launch without it gives.
``assert_parity`` is that check, run at service start
(``verify_placement=True``) and in the tests.

Shards are tracked by their index in the mesh.  Every shard of a port
``Mesh`` is the same ``torch.device``, so device equality cannot tell a
lost shard from a live one: ``probe`` returns shard indices, and
``shrink_to`` keeps the shards it is given by index and records the
others' original indices in ``lost``.  On one card a real loss takes
every shard at once; the per-shard probe failure is reached through the
``faults.INJECT`` seam.
"""

from __future__ import annotations

import logging
from typing import Sequence

from jepsen_tpu_torch import obs

logger = logging.getLogger(__name__)


class PlacementMismatch(AssertionError):
    """Verdicts with the mesh disagreed with verdicts without it: a
    placement bug, never an acceptable degradation."""


class Placement:
    """The service's launch-placement policy.

    ``devices=N`` places every packed batch on a mesh of N logical
    shards (``parallel.mesh.make_mesh(N, device)``); ``mesh=`` pins an
    explicit port ``Mesh``; neither means no mesh.  ``device`` is the
    service's device choice (the card unless "cpu").  The mesh is built
    lazily: constructing a Placement must not touch a device."""

    def __init__(self, *, devices: int | None = None, mesh=None,
                 device=None):
        if devices is not None and mesh is not None:
            raise TypeError("pass devices= or mesh=, not both")
        self.devices = int(devices) if devices is not None else None
        self._mesh = mesh
        self._device = device
        #: bumped by every shrink_to: running ladders compare it to the
        #: generation they launched under and drain on mismatch.
        self.generation = 0
        #: original indices of the shards removed by shrink_to
        #: (operator-visible in describe).
        self.lost: list[int] = []
        #: the original index of each shard of the current mesh.
        self._ids: list[int] | None = None

    @property
    def mesh(self):
        if self._mesh is None and self.devices is not None:
            from jepsen_tpu_torch.parallel.mesh import make_mesh

            self._mesh = make_mesh(self.devices, device=self._device)
        return self._mesh

    @property
    def n_devices(self) -> int:
        m = self.mesh
        return int(m.size) if m is not None else 1

    def span(self, *, requests: int, tier: str):
        """The per-launch ``serve.placement`` telemetry span: where this
        batch ran and how wide."""
        return obs.span(
            "serve.placement", devices=self.n_devices, requests=requests,
            tier=tier, sharded=self.mesh is not None,
        )

    def probe(self) -> tuple[list[int], list[int]]:
        """Health-probe every shard with a round trip of one value on
        its device; returns ``(healthy, failed)`` shard indices in the
        current mesh.  The ``faults.INJECT`` seam runs first with
        ``{"what": "placement.probe", "device": i}``, so a test or a
        fault harness can fail one shard deterministically."""
        import torch

        from jepsen_tpu_torch import faults

        m = self.mesh
        if m is None:
            return [], []
        healthy, failed = [], []
        for i, dev in enumerate(m.devices):
            try:
                hook = faults.INJECT
                if hook is not None:
                    hook({"what": "placement.probe", "device": i}, 0)
                x = torch.ones((), dtype=torch.int32, device=dev)
                if int(x.item()) != 1:
                    raise RuntimeError("device readback mismatch")
                healthy.append(i)
            except Exception:  # noqa: BLE001 — a failing shard is the
                # condition being probed for, whatever the exception
                logger.warning("shard %d (%s) failed its health probe",
                               i, dev, exc_info=True)
                failed.append(i)
        return healthy, failed

    def shrink_to(self, shards: Sequence[int]) -> None:
        """Re-place onto the surviving shards (indices in the current
        mesh): build a mesh of that many shards on the same device,
        record the others as lost, bump the generation so running
        ladders drain at their next rung boundary, and drop the old
        mesh's runners (``sharded.forget_mesh``).  With one shard left
        the ladder takes no mesh rescue, with verdicts unchanged."""
        from jepsen_tpu_torch.parallel import sharded
        from jepsen_tpu_torch.parallel.mesh import Mesh

        old = self.mesh
        keep = [int(i) for i in shards]
        if not keep:
            raise ValueError("a placement needs at least one shard")
        if old is None:
            raise ValueError("no mesh to shrink")
        ids = self._ids if self._ids is not None else list(range(old.size))
        self.lost.extend(ids[i] for i in range(old.size) if i not in keep)
        self._ids = [ids[i] for i in keep]
        self._mesh = Mesh((old.device,) * len(keep), old.axis)
        self.devices = len(keep)
        self.generation += 1
        sharded.forget_mesh(old)

    def describe(self) -> dict:
        return {
            "devices": self.n_devices,
            "sharded": self.mesh is not None,
            # the mesh-spanning fused stage engages only beyond one
            # shard: operators read this to know whether a fused
            # ladder's exhausted lanes take the mesh rescue
            "mesh_kernel": self.n_devices > 1,
            **({"lost_devices": len(self.lost),
                "generation": self.generation} if self.generation else {}),
        }


def assert_parity(model, histories, *, mesh, capacity=(64, 256), **opts) -> list[dict]:
    """Run the same batch with the mesh AND without it; raise
    ``PlacementMismatch`` on any verdict disagreement.  Returns the
    mesh results (so a verifying caller pays the run without the mesh
    as the only overhead)."""
    from jepsen_tpu_torch.parallel import batch

    sharded = batch.batch_analysis(
        model, histories, capacity=capacity, mesh=mesh, **opts
    )
    single = batch.batch_analysis(
        model, histories, capacity=capacity, mesh=None, **opts
    )
    got = [r["valid?"] for r in sharded]
    want = [r["valid?"] for r in single]
    if got != want:
        raise PlacementMismatch(
            f"mesh-sharded verdicts {got} != single-device {want} "
            f"(devices={mesh.size if mesh is not None else 1})"
        )
    obs.counter("serve.placement_parity_ok", histories=len(histories))
    return sharded
