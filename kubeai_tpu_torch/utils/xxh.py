"""xxHash64 (port of kubeai_tpu/utils/xxh.py): the hash behind the CHWBL
consistent-hash ring, the pod-spec and adapter hashes, and the loader's
staging directory names (a staging volume shared with the JAX engine
names the same download alike).

``xxh64`` calls the port's C++ library (``csrc/fasthash.cc``, built and
bound by ``utils/native.py``) when it builds, as the JAX package does;
without g++ the pure-Python ``_xxh64_py`` answers, bit for bit the same,
and stays the tests' reference. The library's ``ring_hashes`` hashes a
ring's virtual nodes in one call but truncates names past 480 bytes, so
the CHWBL ring (``loadbalancer/chwbl.py``), like the JAX one, hashes each
``"<name>/<i>"`` through ``xxh64`` instead.
"""

from __future__ import annotations

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M = 0xFFFFFFFFFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M
    return (_rotl(acc, 31) * _P1) & _M


def _merge_round(h: int, v: int) -> int:
    h ^= _round(0, v)
    return (h * _P1 + _P4) & _M


# Resolved once on first use: either the raw ctypes function (direct C
# call, no lock on the steady-state path) or the Python fallback.
_impl = None


def xxh64(data: bytes | str, seed: int = 0) -> int:
    """xxHash64 of *data* (a str is hashed as UTF-8) with *seed*: an
    unsigned 64-bit int. Uses the native library when it builds; the
    Python version is the fallback and the test reference."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    global _impl
    if _impl is None:
        from kubeai_tpu_torch.utils.native import load

        lib = load()  # one-time (compiles the library if needed)
        _impl = (lambda d, s: lib.xxh64(d, len(d), s)) if lib is not None else _xxh64_py
    return _impl(data, seed)


def _xxh64_py(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0

    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        limit = n - 32
        while i <= limit:
            v1 = _round(v1, int.from_bytes(data[i : i + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[i + 8 : i + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[i + 16 : i + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[i + 24 : i + 32], "little"))
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + _P5) & _M

    h = (h + n) & _M

    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i : i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i : i + 4], "little") * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        i += 1

    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h
