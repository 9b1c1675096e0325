"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain ``extern "C"``
interface and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds rather than minutes. Libraries land in
``build/torch_kernels/`` at the repository root (git-ignored), named by a
hash of the source, the shared headers, the flags and nvcc's release, so
an edited kernel (or another toolkit) builds anew and an unchanged one is
reused. :func:`set_library_dir` moves that directory
(engine/coldstart.py's ``setup_compile_cache``: a mount every replica
shares turns first-use builds into file reads). Threads of one process
that want the same library wait for one build, and each build writes
its own temporary file, so a background warm and a first-use load never
race into one.

Every launcher returns ``cudaGetLastError()``; wrappers call
:func:`check` on it so a refused launch raises instead of vanishing.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# The default library directory; set_library_dir() points the builds
# elsewhere.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_lib_dir = BUILD_DIR
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Libraries built from another library's source with extra flags:
# name -> (source under csrc/, nvcc flags). The paged kernels' one-byte
# instances at head dim 32 would double their libraries' build time, so
# they build apart (in parallel) and load at first use of head dim 32;
# so do the three attention kernels' instances at head dim 256 (Gemma's):
# bf16 in the "_d256" libraries, float32 in the "_f32d256" ones (a
# float32 Gemma), so that neither grows the other's build.
VARIANTS = {
    "paged_attention_q8d32": ("paged_attention", ("-DKATTN_ONE_BYTE_D32",)),
    "paged_decode_attention_q8d32": ("paged_decode_attention", ("-DKATTN_ONE_BYTE_D32",)),
    "flash_attention_d256": ("flash_attention", ("-DKATTN_D256",)),
    "paged_attention_d256": ("paged_attention", ("-DKATTN_D256",)),
    "paged_decode_attention_d256": ("paged_decode_attention", ("-DKATTN_D256",)),
    "flash_attention_f32d256": ("flash_attention", ("-DKATTN_F32D256",)),
    "paged_attention_f32d256": ("paged_attention", ("-DKATTN_F32D256",)),
    "paged_decode_attention_f32d256": ("paged_decode_attention", ("-DKATTN_F32D256",)),
}
# The head dim whose instances are the "_d256" and "_f32d256" libraries.
WIDE_HEAD_DIM = 256


def attention_library(name: str, head_dim: int, float32: bool = False) -> str:
    """The library holding attention kernel *name*'s instances at
    *head_dim* for float32 (*float32*) or bf16 inputs (the one-byte pools
    at head dim 32 are the paged wrappers' own choice)."""
    if head_dim != WIDE_HEAD_DIM:
        return name
    return f"{name}_f32d256" if float32 else f"{name}_d256"


def serving_libraries(model_config, engine_config, quantization: str = "") -> list[str]:
    """The libraries an engine on CUDA over *model_config* and
    *engine_config* loads as it serves (warmup, prefill, decode, embed),
    by the wrappers' own choices: flash when a prefill bucket takes it
    (a multiple of 256, no softcap, no window), the ragged paged kernel
    without a window, the dedicated one where the decode step resolves
    to it, each at the model's head dim, dtype and pool (``_d256``,
    ``_f32d256``, ``_q8d32``), and the W8A16 library under int8
    weights."""
    from kubeai_tpu_torch.ops.paged_attention import library
    from kubeai_tpu_torch.ops.paged_decode_attention import resolve_decode_kernel

    h = model_config.head_dim_
    f32 = model_config.dtype == "float32"
    windowed = model_config.sliding_window > 0
    one_byte = (engine_config.kv_cache_dtype or model_config.kv_cache_dtype) in ("fp8", "int8")
    pool_code = POOL_INT8 if one_byte else POOL_SAME  # either one-byte code picks alike
    names = []
    if (not windowed and model_config.attn_softcap == 0.0
            and any(b >= 256 and b % 256 == 0 for b in engine_config.prefill_buckets)):
        names.append(attention_library("flash_attention", h, f32))
    if not windowed:
        names.append(library("paged_attention", h, pool_code, f32))
        mode = resolve_decode_kernel(engine_config.decode_kernel,
                                     1 + engine_config.speculate_tokens)
        if mode == "dedicated":
            names.append(library("paged_decode_attention", h, pool_code, f32))
    if quantization == "int8":
        names.append("w8a16_matmul")
    return names

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
# Library files being built by a thread of this process, each with the
# event its build sets when it ends: a second thread waits for it.
_building: dict[Path, threading.Event] = {}
_building_lock = threading.Lock()


def set_library_dir(path) -> Path:
    """Build and look up libraries under *path* from now on (created if
    missing). Libraries already loaded stay loaded."""
    global _lib_dir
    _lib_dir = Path(path)
    _lib_dir.mkdir(parents=True, exist_ok=True)
    return _lib_dir


def library_dir() -> Path:
    return _lib_dir


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@functools.lru_cache(maxsize=4)
def _nvcc_release_of(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    return next((line.strip() for line in out.stdout.splitlines() if "release" in line), "")


def nvcc_release() -> str:
    """The release line of ``nvcc --version`` ("" without nvcc): part of
    every library's hash, so a directory shared by nodes with another
    toolkit never hands one node another toolkit's build."""
    try:
        return _nvcc_release_of(nvcc_path())
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return ""


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source file and extra nvcc flags of library *name*."""
    src, flags = VARIANTS.get(name, (name, ()))
    return CSRC / f"{src}.cu", flags


def _library_path(name: str) -> Path:
    src, flags = _source(name)
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    h.update(nvcc_release().encode())
    return _lib_dir / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str], ptxas_verbose: bool = False) -> dict[str, BuildResult]:
    """Compile every source in *names* that is not built yet, one
    ``nvcc`` process per source, all started together. A library another
    thread of this process is building is waited for (and built here if
    that build failed). Raises with the compiler's output if any build
    fails."""
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    _lib_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    waits = {}
    results: dict[str, BuildResult] = {}
    t0 = time.monotonic()
    for name in names:
        path = _library_path(name)
        with _building_lock:
            if path.exists() and not ptxas_verbose:
                results[name] = BuildResult(name, path, 0.0, "")
                continue
            other = _building.get(path)
            if other is not None and not ptxas_verbose:
                waits[name] = (path, other)
                continue
            done = _building[path] = threading.Event()
        try:
            src, flags = _source(name)
            # Keyed by process and thread: two builds never share a file.
            tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, *flags, *extra, "-I", str(CSRC), "-o", str(tmp),
                   str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        except BaseException:
            _finish_build(path, done)
            raise
        procs[name] = (path, tmp, proc, done)
    failed = []
    for name, (path, tmp, proc, done) in procs.items():
        try:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
                continue
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
            results[name] = BuildResult(name, path, time.monotonic() - t0, out)
        finally:
            _finish_build(path, done)
    for name, (path, other) in waits.items():
        other.wait()
        if path.exists():
            results[name] = BuildResult(name, path, time.monotonic() - t0, "")
        else:
            try:
                results.update(build([name]))
            except RuntimeError as e:
                failed.append(str(e))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


def _finish_build(path: Path, done: threading.Event) -> None:
    with _building_lock:
        if _building.get(path) is done:
            del _building[path]
    done.set()


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or a VARIANTS entry),
    built on first use.
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
            lib.kernels_preload.argtypes = []
            lib.kernels_preload.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def preload(lib: ctypes.CDLL, device) -> int:
    """Load every kernel of a loaded library onto CUDA *device* now
    (csrc/preload.cuh), so its first launch pays no lazy module load.
    Returns the number of kernels, or a negative CUDA error code."""
    import torch

    with torch.cuda.device(device):
        return int(lib.kernels_preload())


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> PTR:
    import torch

    return PTR(torch.cuda.current_stream(t.device).cuda_stream)


# Scratch of the launches on one stream, by (device index, raw stream
# handle) and then by name: the split-KV decode partials and counters,
# the W8A16 split-K workspace. Launches on one stream run in order, so
# the counters each launch leaves at zero are zero for the next, and a
# stream of its own keeps other streams' launches off them. A captured
# CUDA graph keeps the pointers it saw: once hold_stream() marks its
# capture stream, a growth of that stream's scratch raises instead of
# freeing memory the graph still writes.
_stream_scratch: dict = {}
_held: set = set()


def stream_key(device) -> tuple[int, int]:
    """(device index, raw handle of the current stream) of *device*."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return index, (raw(index) if raw is not None else
                   torch.cuda.current_stream(index).cuda_stream)


def scratch(device, name: str, sizes: tuple, make):
    """The current stream's scratch *name* on *device*: a tuple of flat
    tensors holding at least *sizes* elements each, made by
    ``make(sizes)`` and grown (to the larger of old and new) on demand."""
    key = stream_key(device)
    bufs = _stream_scratch.setdefault(key, {})
    have = bufs.get(name)
    if have is None or any(t.numel() < n for t, n in zip(have, sizes)):
        if key in _held:
            raise RuntimeError(
                f"{name}: a CUDA graph holds this stream's scratch; growing it to {sizes} "
                f"would free memory the graph still writes (reserve it before capture)"
            )
        old = [0] * len(sizes) if have is None else [t.numel() for t in have]
        have = bufs[name] = make(tuple(max(n, o) for n, o in zip(sizes, old)))
    return have


def hold_stream(stream) -> None:
    """Freeze the scratch of a CUDA *stream*: a captured graph holds it."""
    _held.add((stream.device.index, stream.cuda_stream))


def release_stream(stream) -> None:
    """Drop the hold and the scratch of *stream* (its graphs are gone)."""
    key = (stream.device.index, stream.cuda_stream)
    _held.discard(key)
    _stream_scratch.pop(key, None)


# Element codes of a KV pool beside q (the kernels' kv_code): the
# compute dtype itself, or one byte per element dequantized in the kernel.
POOL_SAME, POOL_INT8, POOL_FP8 = 0, 1, 2


def check_cuda_inputs(what: str, head_dim: int, floats: dict, ints: dict | None = None,
                      pool: dict | None = None) -> tuple[int, int]:
    """Validate a kernel's tensors before their pointers reach native
    code: all on one CUDA device, contiguous, 16-byte aligned; the float
    tensors all float32 or all bfloat16, the index tensors int32; head
    dim 32, 64, 128 or 256. *pool* (one named tensor) may share the floats'
    dtype or hold one byte per element (int8 or float8_e4m3fn) beside
    them; any other mix raises. Returns (the kernel's dtype code, 0 f32
    or 1 bf16; the pool's element code, POOL_SAME, POOL_INT8 or
    POOL_FP8)."""
    import torch

    tensors = {**floats, **(ints or {}), **(pool or {})}
    dev = next(iter(floats.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    dtypes = {t.dtype for t in floats.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"{what}: {', '.join(floats)} must share dtype float32 or bfloat16, "
            f"got {[t.dtype for t in floats.values()]}"
        )
    dtype = next(iter(dtypes))
    pool_code = POOL_SAME
    codes = {dtype: POOL_SAME, torch.int8: POOL_INT8, torch.float8_e4m3fn: POOL_FP8}
    for name, t in (pool or {}).items():
        if t.dtype not in codes:
            raise ValueError(
                f"{what}: {name} must be {dtype}, int8 or float8_e4m3fn beside "
                f"{', '.join(floats)} in {dtype}, got {t.dtype}"
            )
        pool_code = codes[t.dtype]
    for name, t in (ints or {}).items():
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32, got {t.dtype}")
    if head_dim not in (32, 64, 128, WIDE_HEAD_DIM):
        raise ValueError(f"{what}: head_dim {head_dim} unsupported (32, 64, 128 or 256)")
    return (1 if dtype == torch.bfloat16 else 0), pool_code
