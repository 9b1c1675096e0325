"""The port's KV-state wire format, park store and parked pages
(kubeai_tpu_torch/engine/kvstate.py, engine/paging.py) against the JAX
package's (kubeai_tpu/engine/kvstate.py, engine/paging.py).

The same inputs, made from a seed, give byte-identical "KVPG" blobs from
both encoders, for bf16, fp8, int8 and float32 payloads, and each
package's decode_state reads the other's blob. Both fingerprints agree
for one config and request. Every rejection of tests/test_kvstate.py's
TestWireFormat holds for the port, and the same sequence of page-pool
operations gives the same pages in both pools."""

import dataclasses
import json
import struct
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import kvstate as jkv
from kubeai_tpu.engine.paging import PagePool as JPool
from kubeai_tpu.engine.sampling import SamplingParams as JParams
from kubeai_tpu_torch.engine import kvstate as tkv
from kubeai_tpu_torch.engine.paging import PagePool as TPool
from kubeai_tpu_torch.engine.sampling import SamplingParams as TParams

SHAPE = (3, 2, 4, 4, 8)  # [n_pages, L, page, 2*Kv, h]
# payload name -> (numpy dtype of the JAX side, torch dtype of the port)
PAYLOADS = {
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
    "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
    "int8": (np.int8, torch.int8),
    "float32": (np.float32, torch.float32),
}


def _payloads(name, seed=0):
    """(numpy payload for the JAX encoder, torch payload for the port),
    the same bytes."""
    np_dt, t_dt = PAYLOADS[name]
    rng = np.random.default_rng(seed)
    if name == "int8":
        arr = rng.integers(-128, 128, SHAPE).astype(np.int8)
    else:
        arr = rng.normal(0, 2, SHAPE).astype(np.float32).astype(np_dt)
    raw = np.ascontiguousarray(arr).view(np.uint8)
    tp = torch.from_numpy(raw.copy()).view(t_dt).reshape(SHAPE)
    return arr, tp


def _fields(**over):
    kw = dict(
        model_fp="m" * 32,
        request_fp="r" * 32,
        history=[11, 12, 13, 14, 15],
        pending=9,
        prompt_len=3,
        generated=3,
        committed_text="abcé",
        delivered_chars=1,
        key_data=np.array([1234567], np.uint32),
        events=[
            ("token", 7, "a", None, None),
            ("token", 8, "b", -0.5, [[8, -0.5], [3, -1.25]]),
            ("token", 9, "cé", -0.125, None),
        ],
        adapter="lora-a",
    )
    kw.update(over)
    return kw


def _blobs(name, **over):
    jp, tp = _payloads(name)
    kw = _fields(**over)
    return jkv.encode_state(payload=jp, **kw), tkv.encode_state(payload=tp, **kw), tp


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_encode_state_bytes_equal_jax(name):
    jblob, tblob, _ = _blobs(name)
    assert tblob == jblob
    assert json.loads(tblob[9:9 + struct.unpack(">I", tblob[5:9])[0]])["dtype"] == name


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_each_decode_state_reads_the_others_blob(name):
    jblob, tblob, tp = _blobs(name)
    kw = _fields()
    t_st = tkv.decode_state(jblob, expect_model_fp="m" * 32, expect_request_fp="r" * 32)
    j_st = jkv.decode_state(tblob, expect_model_fp="m" * 32, expect_request_fp="r" * 32)
    for st in (t_st, j_st):
        assert st.history == kw["history"] and st.pending == 9 and st.prompt_len == 3
        assert st.generated == 3 and st.committed_text == kw["committed_text"]
        assert st.delivered_chars == 1 and st.adapter == "lora-a"
        assert st.n_bytes == len(tblob)
        assert st.key_data.dtype == np.uint32 and list(st.key_data) == [1234567]
        assert st.events == kw["events"]
    assert t_st.payload.dtype == tp.dtype and tuple(t_st.payload.shape) == SHAPE
    assert torch.equal(t_st.payload.view(torch.uint8), tp.view(torch.uint8))
    assert j_st.payload.dtype == np.dtype(PAYLOADS[name][0])
    np.testing.assert_array_equal(np.ascontiguousarray(j_st.payload).view(np.uint8),
                                  tp.view(torch.uint8).numpy())


def test_model_fingerprint_equals_jax():
    from kubeai_tpu.models.base import ModelConfig as JMC
    from kubeai_tpu_torch.models.base import ModelConfig as TMC
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    configs = [
        dict(vocab_size=272, hidden_size=128, intermediate_size=256, num_layers=2,
             num_heads=4, num_kv_heads=2, dtype="float32"),
        {f.name: getattr(llama_3_1_8b(), f.name) for f in dataclasses.fields(TMC)},
    ]
    for fields in configs:
        for kv_dtype in ("", "fp8", "int8"):
            fields = dict(fields, kv_cache_dtype=kv_dtype)
            jmc = JMC(**{k: v for k, v in fields.items()
                         if k in {f.name for f in dataclasses.fields(JMC)}})
            tmc = TMC(**fields)
            for page in (16, 64):
                assert tkv.model_fingerprint(tmc, page) == jkv.model_fingerprint(jmc, page)
    assert tkv.model_fingerprint(tmc, 64) != tkv.model_fingerprint(tmc.replace(num_kv_heads=4), 64)


@pytest.mark.parametrize("over,adapter", [
    ({}, None),
    ({"temperature": 0.0, "max_tokens": 8}, None),
    ({"temperature": 0.7, "top_p": 0.9, "top_k": 40, "seed": 3, "stop": ("\n", "x")}, "lora-a"),
    ({"logprobs": True, "presence_penalty": 0.5, "frequency_penalty": -0.25,
      "logit_bias": ((5, 1.5), (7, -100.0))}, "b"),
])
def test_request_fingerprint_equals_jax(over, adapter):
    ids = [1, 2, 3, 250]
    t, j = TParams(**over), JParams(**over)
    assert repr(t) == repr(j)
    base = tkv.request_fingerprint(ids, t, adapter)
    assert base == jkv.request_fingerprint(ids, j, adapter)
    # max_tokens alone is left out; every other field counts.
    assert tkv.request_fingerprint(ids, dataclasses.replace(t, max_tokens=400), adapter) == base
    assert tkv.request_fingerprint(ids, dataclasses.replace(t, seed=99), adapter) != base
    assert tkv.request_fingerprint(ids[:-1], t, adapter) != base


def _mangle(kind, blob):
    """The rejections of tests/test_kvstate.py::TestWireFormat:
    (mangled blob, decode kwargs, message)."""
    fp = {"expect_model_fp": "m" * 32}
    if kind == "magic":
        return b"XXXX" + blob[4:], fp, "magic"
    if kind == "version":
        return blob[:4] + bytes([tkv.VERSION + 1]) + blob[5:], fp, "version"
    if kind == "model_fp":
        return blob, {"expect_model_fp": "x" * 32}, "fingerprint"
    if kind == "request_fp":
        return blob, {**fp, "expect_request_fp": "x" * 32}, "request fingerprint"
    if kind == "truncated":
        return blob[:-4], fp, "bytes"
    if kind == "flipped":
        return blob[:-1] + bytes([blob[-1] ^ 0xFF]), fp, "checksum"
    if kind == "header":
        junk = b"not-json"
        return tkv.MAGIC + struct.pack(">BI", tkv.VERSION, len(junk)) + junk, fp, "header"
    if kind == "inverted":  # the JAX `corrupt` failpoint's bitwise inversion
        return bytes(b ^ 0xFF for b in blob), fp, "magic"
    if kind == "dtype":
        h = tkv.peek_header(blob)
        h["dtype"] = "complex64"
        hdr = json.dumps(h, separators=(",", ":")).encode()
        hlen = struct.unpack(">I", blob[5:9])[0]
        return blob[:5] + struct.pack(">I", len(hdr)) + hdr + blob[9 + hlen:], fp, "malformed"
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["magic", "version", "model_fp", "request_fp", "truncated",
                                  "flipped", "header", "inverted", "dtype"])
def test_decode_state_rejects_as_jax_does(kind):
    _, blob, _ = _blobs("bfloat16")
    bad, kwargs, match = _mangle(kind, blob)
    with pytest.raises(tkv.KVFormatError, match=match):
        tkv.decode_state(bad, **kwargs)
    with pytest.raises(jkv.KVFormatError):
        jkv.decode_state(bad, **kwargs)
    # Without a request expectation the blob itself is accepted.
    tkv.decode_state(blob, expect_model_fp="m" * 32)


@pytest.mark.parametrize("pkg", [tkv, jkv], ids=["port", "jax"])
def test_park_store_ttl_cap_lru(pkg, monkeypatch):
    ps = pkg.ParkStore()
    assert ps.put("a", b"x" * 10, tokens=5) == []
    e = ps.get("a")
    assert e.blob == b"x" * 10 and e.tokens == 5 and ps.total_bytes() == 10 and len(ps) == 1
    assert ps.drop("a") and not ps.drop("a") and ps.get("a") is None
    monkeypatch.setenv("KUBEAI_KV_PARK_TTL", "0.01")
    ps.put("a", b"x", tokens=1)
    time.sleep(0.03)
    assert ps.get("a") is None
    ps.put("b", b"y", tokens=1)
    time.sleep(0.03)
    assert ps.sweep() == ["b"] and ps.total_bytes() == 0
    monkeypatch.setenv("KUBEAI_KV_PARK_TTL", "120")
    monkeypatch.setenv("KUBEAI_KV_PARK_BYTES", "100")
    assert ps.put("a", b"x" * 60, tokens=1) == []
    assert ps.put("b", b"y" * 60, tokens=1) == ["a"]
    ps.get("b")
    assert ps.put("c", b"z" * 60, tokens=1) == ["b"]
    assert ps.get("a") is None and ps.get("c") is not None and ps.total_bytes() == 60


def test_knob_defaults_equal_jax(monkeypatch):
    for k in ("KUBEAI_KV_RESTORE", "KUBEAI_KV_PARK_TTL", "KUBEAI_KV_PARK_BYTES",
              "KUBEAI_KV_BREAKEVEN_TOKENS", "KUBEAI_KV_FETCH_TIMEOUT", "KUBEAI_KV_FETCH_RETRIES"):
        monkeypatch.delenv(k, raising=False)
    for fn in ("restore_enabled", "park_ttl", "park_cap_bytes", "breakeven_tokens",
               "fetch_timeout", "fetch_retries"):
        assert getattr(tkv, fn)() == getattr(jkv, fn)(), fn
    assert tkv.breakeven_tokens() == 256 and tkv.park_cap_bytes() == 256 << 20
    monkeypatch.setenv("KUBEAI_KV_RESTORE", "0")
    assert not tkv.restore_enabled()


@pytest.mark.parametrize("event", [
    b"data: " + json.dumps({"choices": [{"finish_reason": "preempted"}],
                            "kubeai_kv": {"key": "k1", "source": "10.0.0.2:8000",
                                          "tokens": 37, "bytes": 12000}}).encode(),
    b"data: [DONE]", b'data: {"choices": []}', b"event: ping", b'data: {"kubeai_kv": "junk"}',
    b'data: {"kubeai_kv": {"key": "", "source": "a:1"}}',
    b'data: {"kubeai_kv": {"key": "k", "source": "a:1", "tokens": "x"}}',
])
def test_extract_kv_offer_equals_jax(event):
    assert tkv.extract_kv_offer(event) == jkv.extract_kv_offer(event)


def test_fetch_blob_rejects_bad_source():
    for src in ("", "no-port", "host:notaport"):
        assert tkv.fetch_blob(src, "k") is None


# -- the parked pages: the same operations on both pools ---------------------


def _ops_occupancy(pool):
    row = pool.allocate(4)
    out = [row, pool.used(), pool.available()]
    pool.park("k", row)
    out += [pool.parked_pages(), pool.used(), pool.available(),
            [pool.is_parked(p) for p in row], pool.parked_keys()]
    return out


def _ops_claimed(pool):
    tokens = [1, 2, 3, 4]
    row = pool.allocate(2)
    pool.register_chain(tokens, None, row)
    pool.park("k", row)
    out = [row, pool.used()]
    claimed = pool.match_prefix(tokens[:3], None)
    out += [claimed, pool.used(), pool.available()]
    pool.release(claimed)
    return out + [pool.used(), pool.available()]


def _ops_unpark_drop(pool):
    row = pool.allocate(3)
    pool.park("k", row)
    out = [pool.unpark("missing"), pool.unpark("k"), pool.parked_pages()]
    pool.release(row)
    row2 = pool.allocate(2)
    pool.park("k2", row2)
    return out + [pool.available(), row2, pool.drop_park("k2"), pool.drop_park("k2"),
                  pool.available()]


def _ops_pressure(pool):
    parked = pool.allocate(4)
    pool.park("victim", parked)
    live = pool.allocate(5)
    got = pool.allocate(3)
    out = [parked, live, got, pool.park_evictions, pool.parked_pages(), pool.unpark("victim")]
    pool.release(live + got)
    return out + [pool.available(), pool.used()]


def _ops_mixed(pool):
    """Parks, prefix claims, releases and pressure from a seed."""
    rng = np.random.default_rng(5)
    held, out = [], []
    for step in range(80):
        ids = [int(x) for x in rng.integers(0, 3, 9)]
        claimed = pool.match_prefix(ids, (0, 0))
        need = 3 - len(claimed)
        if need <= pool.available():
            row = claimed + pool.allocate(need)
            pool.register_chain(ids, (0, 0), row)
            held.append(row)
        else:
            pool.release(claimed)
        if held and step % 3 == 0:
            row = held.pop(0)
            if step % 2 and not any(pool.is_parked(p) for p in row[:2]):
                pool.park(f"k{step}", row[:2])
                pool.release(row[2:])
            else:
                pool.release(row)
        if step % 7 == 0 and pool.parked_keys():
            pool.drop_park(pool.parked_keys()[0])
        out.append((claimed, pool.available(), pool.used(), pool.cached_pages(),
                    pool.parked_pages(), pool.park_evictions))
    return out


@pytest.mark.parametrize("ops,pages,page_size", [
    (_ops_occupancy, 10, 4), (_ops_claimed, 10, 2), (_ops_unpark_drop, 10, 4),
    (_ops_pressure, 10, 4), (_ops_mixed, 12, 4),
])
def test_parked_pages_match_jax(ops, pages, page_size):
    assert ops(TPool(pages, page_size)) == ops(JPool(pages, page_size))


def test_release_never_frees_a_parked_page():
    pool = TPool(10, 4)
    row = pool.allocate(1)
    pool.park("k", row)
    with pytest.raises(RuntimeError, match="parked"):
        pool.release(row)
    with pytest.raises(RuntimeError, match="duplicate"):
        pool.park("k", pool.allocate(1))
