"""The PyTorch/CUDA port of the jepsen_tpu linearizability checker.

A second package beside ``jepsen_tpu``: the batched Wing–Gong–Lowe
capacity ladder (``parallel.batch.batch_analysis``), the chunked
single-history check (``ops.wgl.analysis``) and the checkers a Jepsen
test calls (``checker.linearizable``, ``independent.checker``,
``checker.streaming``) and the Elle checkers for transactional
histories (``checker.elle``) rebuilt on PyTorch, with the
fused wide-stage frontier update written by hand in CUDA for Hopper
(``ops/csrc/wide_kernel.cu``).  The JAX package is the reference
the port is tested against; this package imports neither ``jax`` nor
anything of ``jepsen_tpu`` and keeps its own copies of the host-side
modules it needs (history, models, the exact CPU sweep).

Layer map:

  checker          the Checker protocol (check_safe, compose, stats, ...)
  checker/linearizable  the linearizable checker: "wgl", "sweep",
                   "tpu" (the chunked engine) and "competition", and
                   check_batch over the batched ladder
  independent      per-key subhistories; their check_batch as lanes
  checker/streaming  the online checker over scan_barrier_range
  checker/elle     the Elle checkers: list_append, wr_register,
                   cycle_checker; host SCC (checker/scc) or the dense
                   closure on the card (ops/closure) classifies cycles
  checker/txn_graph, checker/txn_columns  dependency-graph inference
                   (the loop reference and the column engine)
  txn              micro-op folds of transactions
  obs/provenance   decision paths, evidence bundles (in memory and on
                   disk), their digests and their audit
  faults           the launch retry policy, fault injection, deadlines
  store            a test's directory, atomic JSON and history writes
  store/durable    checksummed, versioned records; quarantine
  store/checkpoint the ladder's, chunk and stream checkpoints
  parallel/batch   the capacity ladder: greedy rung, async or sync
                   capacity rungs (carried-frontier resume on async),
                   exact stages, worker or device confirmation of
                   refutations, the mesh rescue; checkpoints, deadlines,
                   OOM halving and rung admission
  parallel/sharded the context-parallel path and the mesh-spanning wide
                   stage, with its fallback
  ops/wgl          packing, the batched greedy walk, the async and
                   barrier-scan engines, the chunked single-history
                   engine and its entry points
  ops/spill        host spill of frontiers, the exact merge, crashed-op
                   group factorization, undecidability reports
  ops/hashing      row hashes, sort/bucket dedup, exact and one-hot
                   domination prunes, compaction
  ops/wide_kernel  wrappers of the CUDA kernels and their plain versions
  ops/closure      batched boolean closures by matrix squaring (bf16
                   products on the tensor cores), cycle flags and hints
  models/tensor    elementwise torch model steps
  checker/wgl_cpu  the CPU oracles: DFS, the exact configuration-set
                   sweep, the greedy walk, the brute-force enumerator
  testing          history generators (genhist, gentxn)

This ``__init__`` imports no torch: the spawned confirmation workers
import the package and must never initialise CUDA.
"""

__version__ = "0.1.0"
