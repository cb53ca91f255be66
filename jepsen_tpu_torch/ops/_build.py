"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
under ``build/`` beside this file (listed in ``.gitignore``), and loaded
with ``ctypes``.  The library's file name carries a digest of the
sources, so an edited kernel is rebuilt and a stale one never loaded.
Nothing is built at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else the one on
    PATH, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source that has no current library, one
    ``nvcc`` process per source, all started together.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills per kernel)
    goes to ``build/<name>.log``.  Raises with the log on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = {}
    for n, path in out.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        log = open(BUILD_DIR / f"{n}.log", "w")
        procs[n] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        ), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{n} (nvcc exit {rc}):\n"
                          + (BUILD_DIR / f"{n}.log").read_text())
            continue
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed, with
    ``signatures`` ({function: (restype, [argtypes])}) declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _LIBS[name] = lib
        return lib


def stream(tensor) -> int:
    """The raw handle of the current CUDA stream of ``tensor``'s device,
    the stream the kernels launch on, read without building a
    ``torch.cuda.Stream`` object (a few microseconds of host time per
    launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(tensor.get_device())


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.wk_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
