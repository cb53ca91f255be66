"""Entry points for the confirmation-sweep worker processes.

The device engines dedup by 64-bit row hash, so ``parallel.batch``
confirms each refutation with the exact CPU configuration-set sweep in a
worker process, concurrently with the remaining rungs.

This module and everything it imports stay free of torch: a spawned
worker unpickles its task function by importing the defining module,
and a worker must never initialise CUDA (the parent owns the card).
The import chain is ``checker.wgl_cpu`` -> ``history`` + ``models``,
numpy and the standard library only.
"""

from __future__ import annotations

import os
import sys


def confirm_refutation(
    model, history, max_configs: int, stop_at_index: int | None = None
) -> dict:
    """Exact CPU sweep over one refuted history, bounded to the prefix
    ending at the device's failure barrier (``stop_at_index``): its
    kills are content-decided, so it confirms (or, in the rare
    hash-collision case, overturns) the device's refutation."""
    from jepsen_tpu_torch.checker import wgl_cpu

    return wgl_cpu.sweep_analysis(
        model, history, max_configs=max_configs, stop_at_index=stop_at_index
    )


def sweep(model, history, max_configs: int) -> dict:
    """The unbounded exact sweep of one history (verdict checks)."""
    from jepsen_tpu_torch.checker import wgl_cpu

    return wgl_cpu.sweep_analysis(model, history, max_configs=max_configs)


def probe() -> dict:
    """Diagnostic task: this worker's pid, whether torch or jax is
    loaded, and which modules of the port its tasks imported."""
    return {
        "pid": os.getpid(),
        "torch_loaded": "torch" in sys.modules,
        "jax_loaded": "jax" in sys.modules,
        "modules": sorted(k for k in sys.modules
                          if k.startswith("jepsen_tpu")),
    }
