"""The CheckService scheduler: admission, packing, placement — separated.

The port of the JAX package's ``serve.sched``.  A monolithic
window-then-launch loop (one queue, one batch at a time) idles the
device between batches and pads dead lanes inside them; this package
splits the scheduler along the three decisions a serving scheduler
actually makes:

  * **admission** (``sched.admission``) — WHO gets in, and into which
    latency class: an ``interactive`` tier (small likely-valid
    histories; served by a speculative greedy single-rung fast path)
    and a ``batch`` tier (everything else), each with its own bounded
    queue and its own retry-after EWMA, so a queue-full interactive
    request is told to come back in fast-path units, not batch-ladder
    units.  Graph-shaped work (elle ``CycleChecker`` & co.) is tagged
    non-geometry-batchable here and runs on a host side lane — it never
    occupies a geometry bucket or stalls packable ladder work.
  * **packing** (``sched.packing``) — WHAT shares a launch, over TIME:
    continuous batching.  A ``RungFeeder`` is handed to
    ``parallel.batch.batch_analysis(admission=...)`` and consulted at
    every rung boundary: geometry-compatible queued requests JOIN the
    running ladder as members resolve and free lane slots (streaming
    batched beam search, arXiv:2010.02164), verdicts demux the moment
    they are decided, and true per-rung occupancy is recorded.
  * **placement** (``sched.placement``) — WHERE a packed batch runs:
    with a mesh of N logical shards of one card (``parallel.mesh``),
    whose mesh rescue takes the lanes the ladder leaves undecided, with
    a verdict-parity assertion against a launch without the mesh.

``serve.service.CheckService`` composes the three; nothing here decides
a verdict — soundness stays in the ladder.
"""

from jepsen_tpu_torch.serve.sched.admission import (
    CLASSES,
    AdmissionQueues,
    classify,
    geometry_batchable,
    graph_batch_key,
)
from jepsen_tpu_torch.serve.sched.packing import RungFeeder
from jepsen_tpu_torch.serve.sched.placement import Placement, PlacementMismatch, assert_parity

__all__ = [
    "CLASSES",
    "AdmissionQueues",
    "Placement",
    "PlacementMismatch",
    "RungFeeder",
    "assert_parity",
    "classify",
    "geometry_batchable",
    "graph_batch_key",
]
