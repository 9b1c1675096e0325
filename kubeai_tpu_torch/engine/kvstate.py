"""KV-page serialization (port of kubeai_tpu/engine/kvstate.py): the
versioned, checksummed "KVPG" blob of one request's paged-KV state, the
host park store behind preemption and the prefill->decode handoff, and
the offer helpers the proxy reads.

Wire format, byte for byte the JAX package's:

    magic "KVPG" | u8 version | u32 header_len | header JSON | payload

The header carries the model fingerprint (every field that changes what
a page's bytes mean), the request fingerprint (prompt, sampling params,
adapter), the payload's shape and dtype name, a CRC32 per page, and the
host resume state (token history, pending token, key data, the emitted
events, the detokenizer's cursors). The payload is the C-order bytes of
[n_pages, L, page, 2*Kv, h] pages gathered from the flat pool.

The card's machine has no ``ml_dtypes``, so numpy has no bfloat16 or
float8 there: the payload travels as raw bytes under the dtype name the
JAX package writes ("bfloat16", "float8_e4m3fn", "int8", "float32"), and
is read back with ``torch.frombuffer(...).view(dtype)`` through the name
table below.

``decode_state`` rejects any mismatch (magic, version, a fingerprint, a
truncated payload, a failed page checksum) with KVFormatError; every
rejection degrades to the deterministic replay, so the client's stream
is the same either way. Stdlib, numpy and torch (CPU) only: blobs are
validated on HTTP handler threads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import http.client
import json
import os
import struct
import threading
import time
import warnings
import zlib
from collections import OrderedDict

import numpy as np
import torch

from kubeai_tpu_torch import env_float
from kubeai_tpu_torch.metrics import default_registry

MAGIC = b"KVPG"
VERSION = 1

# The payload dtypes by the name the JAX package writes (numpy's names,
# with ml_dtypes' for bfloat16 and float8).
DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8,
    "float16": torch.float16,
    "float32": torch.float32,
}
_NAMES = {v: k for k, v in DTYPES.items()}

# -- metrics (the JAX package's names and help strings) ---------------------

M_KV_EXPORT = default_registry.counter(
    "kubeai_kv_export_total",
    "KV page-state exports by outcome (ok|error): serialized park "
    "snapshots taken at preemption or handoff-capped finishes.",
)
M_KV_IMPORT = default_registry.counter(
    "kubeai_kv_import_total",
    "KV page-state import attempts by outcome (ok|corrupt|error|miss): "
    "corrupt = wire-format/checksum/fingerprint rejection, error = "
    "injected or device-side failure, miss = park entry gone before "
    "the resume arrived. Every non-ok outcome degrades to replay.",
)
M_KV_TRANSFER = default_registry.counter(
    "kubeai_kv_transfer_bytes_total",
    "Serialized KV bytes moved over the direct engine-to-engine "
    "transfer socket, by direction (tx = served from the park store, "
    "rx = fetched for a restore).",
)
M_KV_RESTORE_SECONDS = default_registry.histogram(
    "kubeai_kv_restore_seconds",
    "Restore-path latency by phase (acquire = blob fetch + validation "
    "on the serving thread; import = device upload + slot rebuild on "
    "the scheduler thread).",
)


# -- knobs (the JAX package's names and defaults) ---------------------------


def restore_enabled() -> bool:
    """KUBEAI_KV_RESTORE=0 turns the subsystem off (no parking, no
    offers, no imports): every resume replays."""
    return os.environ.get("KUBEAI_KV_RESTORE", "1") != "0"


def park_ttl() -> float:
    return max(env_float("KUBEAI_KV_PARK_TTL", 120.0), 0.0)


def park_cap_bytes() -> int:
    return max(int(env_float("KUBEAI_KV_PARK_BYTES", float(256 << 20))), 0)


def breakeven_tokens() -> int:
    """Prefix length below which a remote restore is not attempted (a
    same-replica restore skips the fetch and ignores it)."""
    return max(int(env_float("KUBEAI_KV_BREAKEVEN_TOKENS", 256.0)), 0)


def fetch_timeout() -> float:
    return max(env_float("KUBEAI_KV_FETCH_TIMEOUT", 5.0), 0.1)


def fetch_retries() -> int:
    return max(int(env_float("KUBEAI_KV_FETCH_RETRIES", 2.0)), 0)


# -- fingerprints -----------------------------------------------------------


class KVFormatError(ValueError):
    """A blob failed validation; it is never imported."""


def model_fingerprint(model_config, page_size: int) -> str:
    """Digest over every field that changes what a page's bytes mean (the
    JAX package's fields, so both packages agree for one config). The
    pool's page count is left out: the blob is layout-independent."""
    mc = model_config
    fields = (
        int(mc.vocab_size),
        int(mc.hidden_size),
        int(mc.num_layers),
        int(mc.num_kv_heads),
        int(mc.head_dim_),
        str(mc.dtype),
        str(getattr(mc, "kv_cache_dtype", "") or ""),
        int(page_size),
        VERSION,
    )
    return hashlib.sha256(repr(fields).encode()).hexdigest()[:32]


def request_fingerprint(prompt_ids, params, adapter: str | None) -> str:
    """A blob resumes exactly one request: same prompt, sampling params
    and adapter. max_tokens is left out: it differs across a handoff
    (the prefill leg runs with the capped budget) and never changes what
    a step generates. The port's SamplingParams has the JAX fields in the
    JAX order, so the repr, and the digest, agree."""
    try:
        params = dataclasses.replace(params, max_tokens=0)
    except TypeError:
        pass
    h = hashlib.sha256()
    h.update(",".join(map(str, prompt_ids)).encode())
    h.update(b"|")
    h.update(repr(params).encode())
    h.update(b"|")
    h.update((adapter or "").encode())
    return h.hexdigest()[:32]


# -- encode / decode --------------------------------------------------------


@dataclasses.dataclass
class RestoreState:
    """A validated blob, ready for the scheduler's restore admission."""

    history: list[int]  # prompt + generated-minus-one token ids (KV written)
    pending: int  # the last emitted token (its KV is the next decode's write)
    prompt_len: int
    generated: int  # emitted events at park time (= len(events))
    committed_text: str
    delivered_chars: int
    key_data: np.ndarray  # the slot's sampling key (the port: its 32-bit seed)
    events: list  # ("token", id, text, logprob, top) tuples, emitted order
    adapter: str | None
    payload: torch.Tensor  # [n_pages, L, page, 2*Kv, h] page contents (CPU)
    n_bytes: int  # serialized blob size


def _raw_bytes(payload: torch.Tensor) -> bytes:
    t = payload.detach().contiguous().cpu()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def encode_state(
    *,
    model_fp: str,
    request_fp: str,
    history: list[int],
    pending: int,
    prompt_len: int,
    generated: int,
    committed_text: str,
    delivered_chars: int,
    key_data: np.ndarray,
    events: list,
    adapter: str | None,
    payload: torch.Tensor,
) -> bytes:
    """Serialize one request's KV state; *payload* is the gathered
    [n_pages, L, page, 2*Kv, h] page tensor."""
    if payload.dtype not in _NAMES:
        raise KVFormatError(f"no KV payload name for {payload.dtype}")
    raw = _raw_bytes(payload)
    n_pages = payload.shape[0]
    page_bytes = len(raw) // n_pages if n_pages else 0
    pages = memoryview(raw)
    crcs = [zlib.crc32(pages[i * page_bytes : (i + 1) * page_bytes]) for i in range(n_pages)]
    key_data = np.asarray(key_data)
    header = {
        "version": VERSION,
        "model_fp": model_fp,
        "request_fp": request_fp,
        "dtype": _NAMES[payload.dtype],
        "shape": list(payload.shape),
        "page_crc": crcs,
        "history": list(map(int, history)),
        "pending": int(pending),
        "prompt_len": int(prompt_len),
        "generated": int(generated),
        "committed_text": committed_text,
        "delivered_chars": int(delivered_chars),
        "key_dtype": str(key_data.dtype),
        "key_shape": list(key_data.shape),
        "key_data": [int(x) for x in key_data.reshape(-1)],
        "events": [
            [int(ev[1]), ev[2], ev[3] if len(ev) > 3 else None, ev[4] if len(ev) > 4 else None]
            for ev in events
        ],
        "adapter": adapter or "",
    }
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return MAGIC + struct.pack(">BI", VERSION, len(hdr)) + hdr + raw


def peek_header(blob: bytes) -> dict:
    """Parse just the JSON header; KVFormatError on framing problems."""
    if len(blob) < 9 or blob[:4] != MAGIC:
        raise KVFormatError("bad magic: not a KV state blob")
    version, hlen = struct.unpack(">BI", blob[4:9])
    if version != VERSION:
        raise KVFormatError(f"unsupported KV state version {version}")
    if len(blob) < 9 + hlen:
        raise KVFormatError("truncated header")
    try:
        header = json.loads(blob[9 : 9 + hlen])
    except ValueError as e:
        raise KVFormatError(f"unparseable header: {e}") from None
    if not isinstance(header, dict):
        raise KVFormatError("header must be an object")
    return header


def decode_state(blob: bytes, *, expect_model_fp: str,
                 expect_request_fp: str | None = None) -> RestoreState:
    """Validate and deserialize; KVFormatError on any mismatch, never
    silently wrong state. The payload is a CPU tensor over the blob's own
    bytes (no copy)."""
    header = peek_header(blob)
    if header.get("model_fp") != expect_model_fp:
        raise KVFormatError("model/config fingerprint mismatch: blob "
                            f"{header.get('model_fp')!r} vs local {expect_model_fp!r}")
    if expect_request_fp is not None and header.get("request_fp") != expect_request_fp:
        raise KVFormatError("request fingerprint mismatch")
    try:
        shape = tuple(int(x) for x in header["shape"])
        dtype = DTYPES[header["dtype"]]
        crcs = [int(c) for c in header["page_crc"]]
        history = [int(t) for t in header["history"]]
        key_shape = tuple(int(x) for x in header["key_shape"])
        key_dtype = np.dtype(header["key_dtype"])
        key_flat = [int(x) for x in header["key_data"]]
        events_raw = header["events"]
    except (KeyError, TypeError, ValueError) as e:
        raise KVFormatError(f"malformed header field: {e}") from None
    if len(shape) != 5 or any(d < 0 for d in shape):
        raise KVFormatError(f"payload shape must be 5-D, got {shape}")
    if len(crcs) != shape[0]:
        raise KVFormatError("page checksum count does not match page count")
    hlen = struct.unpack(">I", blob[5:9])[0]
    raw = memoryview(blob)[9 + hlen :]
    itemsize = torch.empty((), dtype=dtype).element_size()
    expect_bytes = int(np.prod(shape)) * itemsize if shape[0] else 0
    if len(raw) != expect_bytes:
        raise KVFormatError(f"payload is {len(raw)} bytes, header promises {expect_bytes}")
    page_bytes = expect_bytes // shape[0] if shape[0] else 0
    for i, crc in enumerate(crcs):
        if zlib.crc32(raw[i * page_bytes : (i + 1) * page_bytes]) != crc:
            raise KVFormatError(f"page {i} checksum mismatch")
    if expect_bytes:
        with warnings.catch_warnings():
            # The blob is read-only and the payload is only read.
            warnings.simplefilter("ignore", UserWarning)
            payload = torch.frombuffer(raw, dtype=torch.uint8).view(dtype).reshape(shape)
    else:
        payload = torch.empty(shape, dtype=dtype)
    try:
        key_data = np.array(key_flat, dtype=key_dtype).reshape(key_shape)
    except (TypeError, ValueError, OverflowError) as e:
        raise KVFormatError(f"malformed key data: {e}") from None
    events = [("token", int(e[0]), e[1], e[2], e[3]) for e in events_raw]
    return RestoreState(
        history=history,
        pending=int(header["pending"]),
        prompt_len=int(header["prompt_len"]),
        generated=int(header["generated"]),
        committed_text=str(header["committed_text"]),
        delivered_chars=int(header["delivered_chars"]),
        key_data=key_data,
        events=events,
        adapter=(header.get("adapter") or None),
        payload=payload,
        n_bytes=len(blob),
    )


# -- the park store ---------------------------------------------------------


@dataclasses.dataclass
class ParkEntry:
    blob: bytes
    tokens: int  # len(history): the prefix a restore saves re-prefilling
    parked_at: float


class ParkStore:
    """Host-RAM store of park blobs under the offer key, bounded by a TTL
    (KUBEAI_KV_PARK_TTL) and a byte cap (KUBEAI_KV_PARK_BYTES, LRU).
    Thread-safe: the scheduler parks, HTTP threads read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, ParkEntry]" = OrderedDict()
        self._bytes = 0

    def put(self, key: str, blob: bytes, tokens: int) -> list[str]:
        """Store a blob; returns the keys evicted to stay under the byte
        cap (the engine drops their pinned pages too)."""
        evicted: list[str] = []
        cap = park_cap_bytes()
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old.blob)
            self._entries[key] = ParkEntry(blob, tokens, time.monotonic())
            self._bytes += len(blob)
            while self._bytes > cap and len(self._entries) > 1:
                k, e = self._entries.popitem(last=False)
                self._bytes -= len(e.blob)
                evicted.append(k)
        return evicted

    def get(self, key: str) -> ParkEntry | None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if time.monotonic() - e.parked_at > park_ttl():
                self._entries.pop(key, None)
                self._bytes -= len(e.blob)
                return None
            return e

    def drop(self, key: str) -> bool:
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                return False
            self._bytes -= len(e.blob)
            return True

    def sweep(self) -> list[str]:
        """Expire TTL-stale entries; returns their keys."""
        ttl = park_ttl()
        now = time.monotonic()
        out: list[str] = []
        with self._lock:
            for k in list(self._entries):
                if now - self._entries[k].parked_at > ttl:
                    e = self._entries.pop(k)
                    self._bytes -= len(e.blob)
                    out.append(k)
        return out

    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# -- offers and transfer ----------------------------------------------------

# Proxy -> engine headers on a resume dispatch.
KV_KEY_HEADER = "X-KV-Key"
KV_SOURCE_HEADER = "X-KV-Source"
KV_TOKENS_HEADER = "X-KV-Tokens"


def extract_kv_offer(event: bytes) -> dict | None:
    """The ``kubeai_kv`` offer on a preempt or handoff marker chunk:
    {"key", "source" ("host:port"), "tokens", "bytes"}; None for other
    events."""
    if not event.startswith(b"data:") or b"kubeai_kv" not in event:
        return None
    payload = event[5:].strip()
    if payload == b"[DONE]":
        return None
    try:
        offer = json.loads(payload).get("kubeai_kv")
    except (ValueError, AttributeError):
        return None
    if not isinstance(offer, dict):
        return None
    key, source = offer.get("key"), offer.get("source")
    if not isinstance(key, str) or not key or not isinstance(source, str):
        return None
    try:
        tokens = int(offer.get("tokens", 0))
    except (TypeError, ValueError):
        tokens = 0
    return {"key": key, "source": source, "tokens": tokens,
            "bytes": int(offer.get("bytes", 0) or 0)}


def fetch_blob(source: str, key: str, remaining: float | None = None) -> bytes | None:
    """GET http://<source>/v1/kv/<key> with the timeout and retry knobs;
    None on any failure (the caller replays)."""
    host, _, port = source.partition(":")
    if not host or not port.isdigit():
        return None
    attempts = fetch_retries() + 1
    for attempt in range(attempts):
        timeout = fetch_timeout()
        if remaining is not None:
            if remaining <= 0.05:
                return None
            timeout = min(timeout, remaining)
        t0 = time.monotonic()
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
        try:
            conn.request("GET", f"/v1/kv/{key}")
            resp = conn.getresponse()
            if resp.status != 200:
                return None  # a definitive miss: no retry
            blob = resp.read()
            M_KV_TRANSFER.inc(len(blob), labels={"direction": "rx"})
            return blob
        except (OSError, http.client.HTTPException):
            if remaining is not None:
                remaining -= time.monotonic() - t0
            if attempt + 1 >= attempts:
                return None
        finally:
            conn.close()
    return None
