"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain ``extern "C"``
interface and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds rather than minutes. Libraries land in
``build/torch_kernels/`` at the repository root (git-ignored), named by a
hash of the source, the shared headers and the flags, so an edited
kernel is rebuilt and an unchanged one is reused.

Every launcher returns ``cudaGetLastError()``; wrappers call
:func:`check` on it so a refused launch raises instead of vanishing.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# ctypes argument types, named once for the wrappers.
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas resource lines with ptxas_verbose)


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library_path(name: str, extra: tuple[str, ...]) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str], ptxas_verbose: bool = False) -> dict[str, BuildResult]:
    """Compile every source in *names* that is not built yet, one
    ``nvcc`` process per source, all started together. Raises with the
    compiler's output if any build fails."""
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    results: dict[str, BuildResult] = {}
    t0 = time.monotonic()
    for name in names:
        path = _library_path(name, ())
        if path.exists() and not ptxas_verbose:
            results[name] = BuildResult(name, path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        results[name] = BuildResult(name, path, time.monotonic() - t0, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    *signatures* maps each launcher to its ctypes argtypes (every pointer
    and the stream are ``c_void_p``; each launcher returns an int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name].path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> PTR:
    import torch

    return PTR(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda_inputs(what: str, head_dim: int, floats: dict, ints: dict | None = None) -> int:
    """Validate a kernel's tensors before their pointers reach native
    code: all on one CUDA device, contiguous, 16-byte aligned; the float
    tensors all float32 or all bfloat16, the index tensors int32; head
    dim 32, 64 or 128. Returns the kernel's dtype code (0 f32, 1 bf16)."""
    import torch

    tensors = {**floats, **(ints or {})}
    dev = next(iter(floats.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    dtypes = {t.dtype for t in floats.values()}
    if len(dtypes) != 1 or dtypes.pop() not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"{what}: {', '.join(floats)} must share dtype float32 or bfloat16, "
            f"got {[t.dtype for t in floats.values()]}"
        )
    for name, t in (ints or {}).items():
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32, got {t.dtype}")
    if head_dim not in (32, 64, 128):
        raise ValueError(f"{what}: head_dim {head_dim} unsupported (32, 64 or 128)")
    return 1 if next(iter(floats.values())).dtype == torch.bfloat16 else 0
