"""The port's native fasthash library (kubeai_tpu_torch/csrc/fasthash.cc,
built and bound by kubeai_tpu_torch/utils/native.py) against the pure-
Python xxHash64 of both packages, on the CPU.

- ``xxh64`` at every length 0-1000, seeds 0, 42 and 2^64 - 1: the library
  equals the port's ``_xxh64_py`` and the JAX package's, and the known
  vectors hold; a str hashes as its UTF-8 bytes.
- ``ring_hashes`` equals ``_xxh64_py(f"{name}/{i}")``; ``ring_search``
  equals ``bisect`` on a sorted ring, wrapping past the end.
- The port's ``xxh64`` dispatches to the library, and a CHWBL ring routes
  every key to the same endpoint with the library and with ``_xxh64_py``
  patched in.
- A source that does not compile loads nothing, leaves no library behind
  and is not retried; two processes building at once both load one
  library.

Skipped, as tests/test_native.py is, only where there is no g++.
"""

import bisect
import ctypes
import shutil
import subprocess
import sys

import numpy as np
import pytest

from kubeai_tpu.utils.xxh import _xxh64_py as jax_xxh64_py
from kubeai_tpu_torch.loadbalancer import chwbl
from kubeai_tpu_torch.utils import native, xxh

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")

SEEDS = [0, 42, 2**64 - 1]


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert lib is not None, "g++ is present but the library did not build"
    return lib


def _data(n: int) -> bytes:
    return bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh64_equals_python_at_every_length(lib, seed):
    for n in range(1001):
        data = _data(n)
        want = xxh._xxh64_py(data, seed)
        assert native.native_xxh64(data, seed) == want == jax_xxh64_py(data, seed), n


def test_known_vectors_and_str(lib):
    assert native.native_xxh64(b"") == 0xEF46DB3751D8E999
    assert native.native_xxh64(b"abc") == 0x44BC2CF5AD770999
    assert xxh.xxh64("") == 0xEF46DB3751D8E999
    assert xxh.xxh64("héllo/0") == xxh.xxh64("héllo/0".encode()) == \
        xxh._xxh64_py("héllo/0".encode())


@pytest.mark.parametrize("name", [b"pod-12", b"", b"m-" + b"x" * 200, "pod-é".encode()])
def test_ring_hashes_equal_python(lib, name):
    got = native.native_ring_hashes(name, 256)
    assert got == [xxh._xxh64_py(name + f"/{i}".encode()) for i in range(256)]


def test_ring_search_equals_bisect(lib):
    ring = sorted(xxh._xxh64_py(f"pod-{p}/{i}".encode()) for p in range(3) for i in range(256))
    arr = (ctypes.c_uint64 * len(ring))(*ring)
    keys = [0, ring[0], ring[-1], ring[-1] + 1, 2**64 - 1] + [
        xxh._xxh64_py(f"k{i}".encode()) for i in range(500)]
    for h in keys:
        want = bisect.bisect_left(ring, h)
        assert lib.ring_search(arr, len(ring), h) == (0 if want >= len(ring) else want)


def test_xxh64_dispatches_to_the_library(lib, monkeypatch):
    monkeypatch.setattr(xxh, "_impl", None)
    assert xxh.xxh64("hello world") == xxh._xxh64_py(b"hello world")
    assert xxh._impl is not xxh._xxh64_py


def test_chwbl_routes_alike_on_either_backend(lib, monkeypatch):
    names = [f"10.0.0.{i}:8000" for i in range(5)]
    keys = [f"prefix {i} of a prompt" for i in range(300)]

    def route():
        ring = chwbl.HashRing(256)
        for n in names:
            ring.add(n)
        return ring._sorted, [next(ring.walk(k)) for k in keys]

    monkeypatch.setattr(xxh, "_impl", None)
    native_route = route()
    assert xxh._impl is not xxh._xxh64_py
    monkeypatch.setattr(xxh, "_impl", xxh._xxh64_py)
    assert route() == native_route
    assert len(set(native_route[1])) == len(names)


def test_broken_source_loads_nothing_and_is_not_retried(tmp_path, monkeypatch):
    good = native.SRC.read_text()
    src = tmp_path / "fasthash.cc"
    src.write_text('extern "C" int xxh64( {\n')
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.load() is None
    assert list((tmp_path / "lib").iterdir()) == []
    src.write_text(good)
    assert native.load() is None  # not retried in this process
    monkeypatch.setattr(native, "_tried", False)
    assert native.load() is not None  # the next process builds it
    assert [p.name for p in (tmp_path / "lib").iterdir()] == [native.library_path().name]


def test_two_processes_build_one_library(tmp_path):
    code = ("import sys; from pathlib import Path; from kubeai_tpu_torch.utils import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); lib = native.load(); "
            "print(lib is not None and lib.xxh64(b'abc', 3, 0))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == [str(0x44BC2CF5AD770999)] * 2
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]
