"""Native extension loader (port of kubeai_tpu/utils/native.py): builds the
port's ``csrc/fasthash.cc`` with g++ on first use and binds it via ctypes.
Every native entry point has a pure-Python fallback, so absence of a
toolchain degrades performance, never correctness.

The library lands in ``build/torch_kernels/`` beside the CUDA kernels
(``ops/_build.py``'s ``BUILD_DIR``), named by a hash of the source, the
flags and the machine, so an edited source builds anew and an unchanged
one is reused. The operator, loader Jobs and tests may build at once:
each build writes its own temporary file and renames it into place, so
no process ever loads half a library. A failed build leaves no library
behind (the next process tries again) and is not retried in this one.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path

from kubeai_tpu_torch.ops._build import BUILD_DIR

log = logging.getLogger("kubeai_tpu_torch.native")

SRC = Path(__file__).resolve().parent.parent / "csrc" / "fasthash.cc"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    """Where the library built from the current source lives."""
    h = hashlib.sha256()
    h.update(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(platform.machine().encode())
    return BUILD_DIR / f"fasthash-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    # Keyed by process and thread: two builds never share a file.
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        if tmp.exists():
            tmp.unlink()


def load() -> ctypes.CDLL | None:
    """Build (if needed) and load the fasthash library; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.xxh64.restype = ctypes.c_uint64
            lib.xxh64.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
            lib.ring_hashes.restype = None
            lib.ring_hashes.argtypes = [
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.ring_search.restype = ctypes.c_uint64
            lib.ring_search.argtypes = [
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64,
                ctypes.c_uint64,
            ]
            _lib = lib
            log.info("native fasthash loaded from %s", path)
        except (subprocess.CalledProcessError, OSError) as e:
            log.warning("native fasthash unavailable (%s); using Python fallback", e)
            _lib = None
        return _lib


def native_xxh64(data: bytes, seed: int = 0) -> int | None:
    lib = load()
    if lib is None:
        return None
    return lib.xxh64(data, len(data), seed)


def native_ring_hashes(name: bytes, replication: int) -> list[int] | None:
    lib = load()
    if lib is None:
        return None
    out = (ctypes.c_uint64 * replication)()
    lib.ring_hashes(name, len(name), replication, out)
    return list(out)
