"""Device selection for the port's entry points.

Entry points run on the card: ``device=None`` (or ``"cuda"``) means the
first CUDA device, and a missing card raises instead of quietly
continuing on the CPU.  Only a caller that asks for ``"cpu"`` gets the
CPU (the tests do, to compare the plain versions with the JAX package).
"""

from __future__ import annotations


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: cuda unless the
    caller asks for the CPU; raises when cuda is asked for and absent."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
