"""Packing: continuous batching via the ladder's rung-admission hook.

``RungFeeder`` is the bridge object ``CheckService`` hands to
``parallel.batch.batch_analysis(admission=...)``.  The ladder consults
it at every rung boundary:

  * ``poll`` — geometry-compatible queued requests JOIN the running
    ladder (entering at rung 0, the greedy walk, so their verdict path
    is identical to a one-shot call); lane slots freed by resolved
    members are what the joiners recycle.  The poll also gives the
    service a bounded mid-ladder service opportunity (expiring overdue
    queued requests and running an interactive fast-path wave), which
    is what bounds interactive latency by ONE RUNG instead of one
    batch.
  * ``on_result`` — a member's verdict demuxes the moment the ladder
    decides it: the caller's future resolves mid-ladder instead of at
    batch completion.
  * ``on_rung`` — true per-rung lane occupancy (live lanes over the
    padded batch axis the kernel actually launched), the continuous
    counterpart of the per-batch occupancy spans.  The aggregate is
    DEVICE-TIME-WEIGHTED: each rung's live/padded ratio counts in
    proportion to its launch seconds (compile + execute, not host-side
    packing/demux), so a 2 ms underfull greedy tail launch cannot
    swamp the 300 ms full-width beam rungs that carried the device's
    actual work.  This is the number the ≥ 0.80 acceptance gate reads.

The feeder also advertises ``pad_lanes`` — the fixed batch axis every
rung of this ladder launches at (the padded width of the group's
members plus its queued backlog, clamped to the service width).
Joiners and resolved lanes then recycle slots inside ONE launch
shape; without it, membership churn walks the ladder through a new
padded shape per batch size (in the JAX package a fresh compile each;
in the port each new shape pays the allocator's first-touch growth).

The feeder never decides verdicts and never blocks the ladder: every
hook call is bounded work on the scheduler thread, and a hook failure
degrades to "no joiners" inside ``batch_analysis`` by contract.
"""

from __future__ import annotations

import time

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.obs import metrics


class RungFeeder:
    """One running ladder's admission hook + demux table.

    ``members`` stays index-aligned with the ladder's result list: the
    ladder assigns each joiner index ``len(histories)`` at poll time,
    which is exactly ``len(self.members)`` here — appending on return
    keeps the two counters mirrored (the demux contract in
    ``batch_analysis``'s docstring)."""

    def __init__(self, service, group, members):
        self.service = service
        self.group = group
        self.members: list = list(members)
        #: the fixed batch axis every rung of this ladder launches at
        #: (batch_analysis reads this): the padded width of the work
        #: this GROUP can actually fill — initial members plus the
        #: same-group queue at feeder construction, clamped to the
        #: service width.  Pinning per-ladder keeps membership churn
        #: from walking the ladder through a new padded shape per
        #: batch size, while a 2-member odd-geometry group pads to 8
        #: lanes, not the service's 16: its launches are a separate
        #: geometry bucket anyway, so full-width padding there buys no
        #: shape reuse, only dead lane-slot-seconds.
        from jepsen_tpu_torch.parallel import batch as _batch

        with service._lock:
            backlog = sum(
                1 for r in service._adm.queues["batch"] if r.group == group
            )
        self.pad_lanes = _batch.padded_batch(
            min(max(1, service.max_batch),
                max(1, len(self.members) + backlog)),
            service._placement.mesh,
        )
        #: rung-occupancy accumulators (read into service stats):
        #: live lane-seconds over launched lane-slot-seconds — the
        #: device-TIME-utilization aggregate, so a 2 ms underfull tail
        #: launch can't swamp the full-width rungs that carried the
        #: work.
        self.rungs = 0
        self.lane_sum = 0.0
        self.slot_sum = 0.0
        self.joined = 0
        self.t_start = time.monotonic()
        #: a closed feeder admits no more joiners — flipped by the
        #: service when the ladder must drain (hung-launch abandonment:
        #: the zombie thread's polls must not pull queued requests into
        #: a ladder nobody will settle; device-loss re-placement: the
        #: mesh is changing under it).
        self.closed = False
        #: the placement generation this ladder launched under; a
        #: mid-ladder device-loss shrink bumps the service's counter
        #: and the mismatch closes the feeder at the next poll.
        self.placement_gen = service._placement.generation

    def close(self) -> None:
        self.closed = True

    # -- the batch_analysis hook protocol ---------------------------------

    def poll(self, *, stage: int, lanes: int):
        """New member histories for the running ladder (may be empty).
        Budget: the service's ``max_batch`` minus the lanes still live —
        resolved members' slots are recycled, the batch never grows past
        the configured width."""
        svc = self.service
        joiners = svc._admit_joiners(self, stage=stage, lanes=lanes)
        for r in joiners:
            self.members.append(r)
            self.joined += 1
            with obs.attach(r.ctx):
                obs.counter(
                    "serve.rung_joined", stage=stage, client=r.client
                )
        return [r.history for r in joiners]

    def on_result(self, i: int, result: dict) -> None:
        """Mid-ladder demux: member ``i``'s verdict is final — settle
        its future now."""
        self.service._settle_member(self.members[i], result)

    def on_rung(self, *, stage: int, engine: str, capacity: int,
                lanes: int, padded: int, seconds: float = 0.0) -> None:
        occ = lanes / max(1, padded)
        w = max(float(seconds), 1e-6)  # device-time weight per rung
        self.rungs += 1
        self.lane_sum += lanes * w
        self.slot_sum += padded * w
        metrics.set_gauge("serve.continuous_occupancy", round(occ, 4))
        obs.gauge(
            "serve.rung_occupancy", round(occ, 4),
            stage=stage, engine=engine, capacity=capacity,
            lanes=lanes, padded=padded, seconds=round(w, 6),
        )

    # -- introspection -----------------------------------------------------

    @property
    def mean_occupancy(self) -> float | None:
        return (
            round(self.lane_sum / self.slot_sum, 4) if self.slot_sum else None
        )

    def unresolved(self) -> list:
        """Members whose futures the ladder's early demux did NOT settle
        (unknowns and confirmation leftovers) — the service resolves
        them from the returned result list."""
        return [r for r in self.members if not r.future.done()]
