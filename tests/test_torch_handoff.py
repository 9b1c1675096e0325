"""KV park and restore through the port's engine and server
(kubeai_tpu_torch/engine/core.py, engine/server.py), against the JAX
package's on the same weights (tests/_torch_parity.py), on the CPU.

A handoff-capped stream on a prefill-role server parks its KV: the blob's
header equals the JAX engine's for the same request (except the key
data: the port keeps the slot's seed where JAX keeps a threefry key), and
its payload is within 1e-4 of JAX's. A resume by unpark (same replica)
and by upload (fetched from the peer's /v1/kv/<key>) equals the unbroken
stream byte for byte; so does every fallback (a corrupt blob, an export
error, an import error, a missing entry, a blob of the other package)."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_parity import parity_engines
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from kubeai_tpu.engine import kvstate as jkv
from kubeai_tpu.engine.server import EngineServer as JServer
from kubeai_tpu.metrics import default_registry as jreg
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine import kvstate as tkv
from kubeai_tpu_torch.engine.server import EngineServer as TServer
from kubeai_tpu_torch.metrics import default_registry as treg

EC = dict(max_slots=2, max_seq_len=512, prefill_buckets=(16, 32), decode_chunk=2, max_queue=8)
BODY = {"model": "kv1", "prompt": "the quick brown fox jumps over the lazy dog",
        "stream": True, "temperature": 0, "max_tokens": 20, "seed": 7}
BUDGET = 6


def _serve(engine, server_cls, **kw):
    srv = server_cls(engine, "kv1", host="127.0.0.1", port=0, **kw)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def servers():
    """A JAX prefill server and a port prefill server on the same weights,
    and a port decode server on them too."""
    je, te = parity_engines(EC)
    te2 = tcore.build_test_engine(tcore.EngineConfig(**EC), device="cpu", params=te.params,
                                  model_config=te.model_config)
    srvs = (_serve(je, JServer, role="prefill", handoff_budget=BUDGET),
            _serve(te, TServer, role="prefill", handoff_budget=BUDGET),
            _serve(te2, TServer, role="decode"))
    yield srvs
    for s in srvs:
        s.stop()


def count(name, **labels):
    return treg.get(name).value(labels=labels or None)


def stream(port, body, headers=None, timeout=60):
    """((text, finish_reason) events + "[DONE]", kv offers) of a stream."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
    out, offers = [], []
    for block in raw.replace(b"\r\n", b"\n").split(b"\n\n"):
        if not block.startswith(b"data: "):
            continue
        offer = tkv.extract_kv_offer(block)
        if offer is not None:
            offers.append(offer)
        payload = block[6:].decode()
        if payload == "[DONE]":
            out.append("[DONE]")
            continue
        c = json.loads(payload)["choices"][0]
        out.append((c.get("text"), c.get("finish_reason")))
    return out, offers


def park(port, body=BODY):
    events, offers = stream(port, body, headers={"X-Handoff-Planned": "1"})
    assert events[-1] == "[DONE]" and events[-2][1] == "handoff", events
    return events, (offers[0] if offers else None)


def resume_headers(offer, forwarded=5):
    return {"X-Resume-Tokens": str(forwarded), "X-KV-Key": offer["key"],
            "X-KV-Source": offer["source"], "X-KV-Tokens": str(offer["tokens"])}


def test_handoff_park_matches_jax(servers):
    jsrv, tsrv, _ = servers
    exp_before = count("kubeai_kv_export_total", outcome="ok")
    jleg, joffer = park(jsrv.port)
    tleg, toffer = park(tsrv.port)
    assert tleg == jleg
    assert count("kubeai_kv_export_total", outcome="ok") == exp_before + 1
    assert toffer["source"] == tsrv.kv_advertise and toffer["tokens"] == joffer["tokens"]
    jblob = jsrv.engine.kv_park.get(joffer["key"]).blob
    tblob = tsrv.engine.kv_park.get(toffer["key"]).blob
    assert toffer["bytes"] == len(tblob) and joffer["bytes"] == len(jblob)
    jh, th = jkv.peek_header(jblob), tkv.peek_header(tblob)
    differ = {"key_data", "key_shape", "page_crc", "events"}
    assert set(th) == set(jh)
    assert {k: th[k] for k in th if k not in differ} == {k: jh[k] for k in jh if k not in differ}
    assert th["key_shape"] == [1] and th["key_data"] == [7] and jh["key_shape"] == [2]
    assert [e[:2] for e in th["events"]] == [e[:2] for e in jh["events"]]
    np.testing.assert_allclose([e[2] for e in th["events"]], [e[2] for e in jh["events"]],
                               atol=1e-4)
    # The payload within 1e-4 where the history's KV lies (past it, the
    # last page holds what the chunk in flight wrote after the finish).
    fp = tsrv.engine._kv_fp
    assert fp == jsrv.engine._kv_fp
    jst = jkv.decode_state(jblob, expect_model_fp=fp)
    tst = tkv.decode_state(tblob, expect_model_fp=fp)
    n, L, page = jst.payload.shape[:3]
    flat = lambda p: np.moveaxis(np.asarray(p), 1, 0).reshape(L, n * page, -1)  # noqa: E731
    hist = len(th["history"])
    np.testing.assert_allclose(flat(tst.payload.numpy())[:, :hist], flat(jst.payload)[:, :hist],
                               atol=1e-4, rtol=0)
    for srv, key in ((jsrv, joffer["key"]), (tsrv, toffer["key"])):
        srv.engine.kv_park.drop(key)


def test_resume_by_unpark_equals_the_unbroken_stream(servers):
    _, tsrv, _ = servers
    eng = tsrv.engine
    reference, _ = stream(tsrv.port, BODY)
    assert reference[-1] == "[DONE]" and len(reference) > 8
    imp_before = count("kubeai_kv_import_total", outcome="ok")
    leg1, offer = park(tsrv.port)
    assert eng._pool.parked_pages() > 0 and eng.kv_park.get(offer["key"]) is not None
    resumed, _ = stream(tsrv.port, BODY, headers=resume_headers(offer, len(leg1) - 2))
    assert resumed == reference
    assert count("kubeai_kv_import_total", outcome="ok") == imp_before + 1
    assert [e for e in eng.kv_log if e["event"] == "import"][-1]["how"] == "unparked"
    assert eng.kv_park.get(offer["key"]) is None  # the restore consumed the entry


@pytest.mark.parametrize("extra", [{}, {"presence_penalty": 0.5, "frequency_penalty": 0.5}],
                         ids=["plain", "penalties"])
def test_resume_by_upload_from_the_peer(servers, monkeypatch, extra):
    """The decode replica fetches the blob from the prefill replica's
    /v1/kv/<key> and uploads it into fresh pages (with penalties, the
    restored history row steers the continuation)."""
    _, tsrv, dsrv = servers
    body = {**BODY, **extra}
    monkeypatch.setenv("KUBEAI_KV_BREAKEVEN_TOKENS", "0")
    reference, _ = stream(dsrv.port, body)
    _, offer = park(tsrv.port, body)
    blob_len = len(tsrv.engine.kv_park.get(offer["key"]).blob)
    rx_before = count("kubeai_kv_transfer_bytes_total", direction="rx")
    imp_before = count("kubeai_kv_import_total", outcome="ok")
    resumed, _ = stream(dsrv.port, body, headers=resume_headers(offer))
    assert resumed == reference
    assert count("kubeai_kv_import_total", outcome="ok") == imp_before + 1
    assert count("kubeai_kv_transfer_bytes_total", direction="rx") == rx_before + blob_len
    assert [e for e in dsrv.engine.kv_log if e["event"] == "import"][-1]["how"] == "uploaded"
    tsrv.engine.kv_park.drop(offer["key"])


def _corrupt(srv, offer, monkeypatch):
    entry = srv.engine.kv_park.get(offer["key"])
    blob = entry.blob
    srv.engine.kv_park.put(offer["key"], blob[:-1] + bytes([blob[-1] ^ 0xFF]), entry.tokens)
    return srv


def _import_error(srv, offer, monkeypatch):
    dsrv = srv.peer

    def fail(*a, **k):
        raise RuntimeError("injected import failure")

    monkeypatch.setattr(dsrv.engine, "_import_pages", fail)
    monkeypatch.setenv("KUBEAI_KV_BREAKEVEN_TOKENS", "0")
    return dsrv


def _missing(srv, offer, monkeypatch):
    srv.engine.kv_park.drop(offer["key"])
    return srv


@pytest.mark.parametrize("fault,outcome", [(_corrupt, "corrupt"), (_import_error, "error"),
                                           (_missing, "miss")],
                         ids=["corrupt", "import_error", "miss"])
def test_failed_restore_replays_the_same_stream(servers, monkeypatch, fault, outcome):
    _, tsrv, dsrv = servers
    tsrv.peer = dsrv
    reference, _ = stream(tsrv.port, BODY)
    _, offer = park(tsrv.port)
    target = fault(tsrv, offer, monkeypatch)
    before = count("kubeai_kv_import_total", outcome=outcome)
    ok_before = count("kubeai_kv_import_total", outcome="ok")
    resumed, _ = stream(target.port, BODY, headers=resume_headers(offer))
    assert resumed == reference
    assert count("kubeai_kv_import_total", outcome=outcome) == before + 1
    assert count("kubeai_kv_import_total", outcome="ok") == ok_before
    tsrv.engine.kv_park.drop(offer["key"])


def test_export_error_means_no_offer_and_a_plain_replay(servers, monkeypatch):
    _, tsrv, _ = servers
    reference, _ = stream(tsrv.port, BODY)
    err_before = count("kubeai_kv_export_total", outcome="error")

    def fail(**kw):
        raise RuntimeError("injected export failure")

    # Compared by park key: earlier cases' dropped blobs leave pinned
    # pages that the engine's sweep (_sweep_kv_park) may release while
    # this request runs, so the pool's page count alone may fall.
    pool = tsrv.engine._pool
    keys = set(pool.parked_keys())
    monkeypatch.setattr(tkv, "encode_state", fail)
    leg1, offers = stream(tsrv.port, BODY, headers={"X-Handoff-Planned": "1"})
    monkeypatch.undo()
    assert leg1[-2][1] == "handoff" and offers == []
    assert count("kubeai_kv_export_total", outcome="error") == err_before + 1
    # This request parked nothing: no new key, and no page pinned
    # beyond the earlier keys that are left.
    left = set(pool.parked_keys())
    assert left <= keys
    assert pool.parked_pages() == sum(len(pool._parked[k]) for k in left)
    resumed, _ = stream(tsrv.port, BODY, headers={"X-Resume-Tokens": "5"})
    assert resumed == reference


def test_blobs_of_the_other_package_are_refused_on_the_key_layout(servers):
    """A JAX blob (threefry key data, shape (2,)) passes the port's wire
    checks (the fingerprints agree) and is refused at admission; a port
    blob (the seed, shape (1,)) likewise by the JAX engine. Both replay."""
    jsrv, tsrv, _ = servers
    _, joffer = park(jsrv.port)
    _, toffer = park(tsrv.port)
    jentry, tentry = (s.engine.kv_park.get(o["key"]) for s, o in ((jsrv, joffer), (tsrv, toffer)))
    tsrv.engine.kv_park.put("from-jax", jentry.blob, jentry.tokens)
    jsrv.engine.kv_park.put("from-port", tentry.blob, tentry.tokens)
    for srv, key, reg, name in ((tsrv, "from-jax", treg, "port"), (jsrv, "from-port", jreg, "jax")):
        reference, _ = stream(srv.port, BODY)
        metric = reg.get("kubeai_kv_import_total")
        before = metric.value(labels={"outcome": "corrupt"})
        ok_before = metric.value(labels={"outcome": "ok"})
        offer = {"key": key, "source": srv.kv_advertise, "tokens": jentry.tokens}
        resumed, _ = stream(srv.port, BODY, headers=resume_headers(offer))
        assert resumed == reference, name
        assert metric.value(labels={"outcome": "corrupt"}) == before + 1, name
        assert metric.value(labels={"outcome": "ok"}) == ok_before, name
    for srv, key in ((jsrv, joffer["key"]), (tsrv, toffer["key"]), (jsrv, "from-port"),
                     (tsrv, "from-jax")):
        srv.engine.kv_park.drop(key)


def test_break_even_skips_a_short_remote_fetch(servers, monkeypatch):
    _, _, dsrv = servers
    calls = []
    monkeypatch.setattr(tkv, "fetch_blob", lambda *a, **k: calls.append(a))
    reference, _ = stream(dsrv.port, BODY)
    miss_before = count("kubeai_kv_import_total", outcome="miss")
    offer = {"key": "elsewhere", "source": "127.0.0.1:9", "tokens": 255}
    resumed, _ = stream(dsrv.port, BODY, headers=resume_headers(offer))
    assert resumed == reference and calls == []
    assert count("kubeai_kv_import_total", outcome="miss") == miss_before


def test_restore_disabled_kills_offers(servers, monkeypatch):
    _, tsrv, _ = servers
    parked = tsrv.engine._pool.parked_pages()
    monkeypatch.setenv("KUBEAI_KV_RESTORE", "0")
    leg1, offers = stream(tsrv.port, BODY, headers={"X-Handoff-Planned": "1"})
    assert leg1[-2][1] == "handoff" and offers == []
    assert tsrv.engine._pool.parked_pages() == parked


def test_transfer_route_and_metrics_show_the_park(servers):
    """/v1/kv/<key> 404s a miss and serves a parked blob; /metrics (the
    page gauges bind to the engine built last: this test's own) shows the
    parked pages, and none of them as occupancy."""
    te = servers[1].engine
    eng = tcore.build_test_engine(tcore.EngineConfig(**EC), device="cpu", params=te.params,
                                  model_config=te.model_config)
    srv = _serve(eng, TServer, role="prefill", handoff_budget=BUDGET)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/kv/absent", timeout=10)
        assert exc.value.code == 404
        _, offer = park(srv.port)
        tx_before = count("kubeai_kv_transfer_bytes_total", direction="tx")
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/kv/{offer['key']}",
                                    timeout=10) as r:
            blob = r.read()
        assert blob == eng.kv_park.get(offer["key"]).blob and blob[:4] == tkv.MAGIC
        assert count("kubeai_kv_transfer_bytes_total", direction="tx") == tx_before + len(blob)
        from kubeai_tpu.metrics.registry import parse_prometheus_text

        def scrape():
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                        timeout=10) as r:
                page = parse_prometheus_text(r.read().decode())
            return {k: v[0][1] for k, v in page.items() if len(v) == 1}

        got, pool = scrape(), eng._pool
        assert got["kubeai_engine_kv_pages_parked"] == pool.parked_pages() > 0
        assert got["kubeai_engine_kv_pages_used"] == 0  # every slot is free
        assert got["kubeai_engine_kv_pages_total"] == pool.num_pages - 1
        assert got["kubeai_engine_slots_total"] == EC["max_slots"]
        # The blob expires: the scheduler's sweep releases its pinned pages.
        eng.kv_park.drop(offer["key"])
        eng._kv_park_sweep_at = 0.0
        deadline = time.monotonic() + 10
        while pool.parked_pages() and time.monotonic() < deadline:
            eng._wake.set()
            time.sleep(0.02)
        assert scrape()["kubeai_engine_kv_pages_parked"] == pool.parked_pages() == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("G", [3], ids=["G3"])
def test_speculative_and_adapter_streams_resume(servers, tmp_path, G):
    """Under --speculate-tokens G (the restored history row feeds the
    drafter through the admission merge), and on a LoRA adapter (the
    request fingerprint carries its name)."""
    from kubeai_tpu_torch.engine.lora import write_peft_checkpoint

    _, tsrv, _ = servers
    te = tsrv.engine
    eng = tcore.build_test_engine(tcore.EngineConfig(**EC, speculate_tokens=G), device="cpu",
                                  params=te.params, model_config=te.model_config)
    srv = _serve(eng, TServer, role="prefill", handoff_budget=BUDGET)
    try:
        write_peft_checkpoint(str(tmp_path / "a"), te.model_config, rank=4, alpha=8, seed=1)
        assert srv.load_adapter("a", str(tmp_path / "a"))[0]
        for body in (BODY, {**BODY, "model": "a"}):
            reference, _ = stream(srv.port, body)
            leg1, offer = park(srv.port, body)
            resumed, _ = stream(srv.port, body, headers=resume_headers(offer, len(leg1) - 2))
            assert resumed == reference, body["model"]
            assert [e for e in eng.kv_log if e["event"] == "import"][-1]["how"] == "unparked"
        assert stream(srv.port, {**BODY, "model": "a"})[0] != stream(srv.port, BODY)[0]
    finally:
        srv.stop()
