"""The PyTorch/CUDA port of the jepsen_tpu linearizability checker.

A second package beside ``jepsen_tpu``: the batched Wing–Gong–Lowe
capacity ladder (``parallel.batch.batch_analysis``) and the chunked
single-history check (``ops.wgl.analysis``) rebuilt on PyTorch, with the
fused wide-stage frontier update written by hand in CUDA for Hopper
(``ops/csrc/wide_kernel.cu``).  The JAX package is the reference
the port is tested against; this package imports neither ``jax`` nor
anything of ``jepsen_tpu`` and keeps its own copies of the host-side
modules it needs (history, models, the exact CPU sweep).

Layer map:

  parallel/batch   the capacity ladder: greedy rung, async or sync
                   capacity rungs (carried-frontier resume on async),
                   exact stages, worker-process confirmation of
                   refutations, the mesh rescue
  parallel/sharded the mesh-spanning wide stage, and its fallback
  ops/wgl          packing, the batched greedy walk, the async and
                   barrier-scan engines, the chunked single-history
                   engine and its entry points
  ops/spill        host spill of frontiers, the exact merge, crashed-op
                   group factorization, undecidability reports
  ops/hashing      row hashes, sort/bucket dedup, exact and one-hot
                   domination prunes, compaction
  ops/wide_kernel  wrappers of the CUDA kernels and their plain versions
  models/tensor    elementwise torch model steps
  checker/wgl_cpu  the exact CPU configuration-set sweep (the oracle)

This ``__init__`` imports no torch: the spawned confirmation workers
import the package and must never initialise CUDA.
"""

__version__ = "0.1.0"
