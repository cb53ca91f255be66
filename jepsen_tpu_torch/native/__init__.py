"""Native runtime components (C, built on demand).

``blockio`` — CRC32-tracked positioned block appends for the run.jepsen
store format: the role of the reference's Java FileOffsetOutputStream
(jepsen/src/jepsen/store/FileOffsetOutputStream.java).  Built lazily
with the system compiler into ``build/`` beside this file (listed in
``.gitignore``; the library's name carries a digest of the source, so an
edited source is rebuilt and a stale one never loaded).  Every consumer
falls back to the pure-Python implementation when the extension is
missing, and the two paths write identical bytes, so nothing depends on
the toolchain at runtime.  This is host C, not a device kernel: the
package imports no torch.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

logger = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "build"
_SRC = _HERE / "blockio.c"
_CFLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> Path:
    """Where the built extension lives: ``build/_blockio-<digest>.so``."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CFLAGS).encode())
    return BUILD_DIR / f"_blockio-{h.hexdigest()[:16]}.so"


def build_blockio(force: bool = False):
    """Compile blockio.c into ``build/`` (gcc, one translation unit;
    written under a per-process tmp name and renamed, so concurrent
    builders never load a torn library).  Returns the imported module
    or None."""
    so = library_path()
    if force or not so.exists():
        include = sysconfig.get_paths()["include"]
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = ["gcc", *_CFLAGS, f"-I{include}", str(_SRC), "-o", str(tmp)]
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            logger.debug("blockio build failed (%s); using the Python path", e)
            try:
                tmp.unlink()
            except OSError:
                pass
            return None
    return _import_blockio(so)


def _import_blockio(so: Path):
    """Load the extension from its file under this package's name (its
    init function is ``PyInit__blockio``), so it never shadows or takes
    the place of another package's ``_blockio`` on ``sys.path``."""
    try:
        spec = importlib.util.spec_from_file_location(
            __name__ + "._blockio", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except (ImportError, OSError):
        return None


_blockio = None
_tried = False
_LOCK = threading.Lock()


def blockio():
    """The extension module, building it on first use; None when no
    toolchain is available (callers use the Python fallback)."""
    global _blockio, _tried
    with _LOCK:
        if not _tried:
            _tried = True
            _blockio = build_blockio()
    return _blockio
