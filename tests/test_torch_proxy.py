"""The operator's proxy, load balancer and reconciler (the JAX package's,
unchanged) driving port engine servers on the CPU: the engine's side of
the resume protocol is what the port serves them.

The fixtures are tests/test_disagg.py's ``disagg_stack`` and
tests/test_qos.py's ``qos_stack``, over port servers in place of the JAX
package's (``role_engines`` and ``qos_engine`` are redefined here):
- a disaggregated Model hands a stream off from a prefill-role port
  server to a decode-role one, importing the parked KV, and the client's
  stream equals a direct port engine's byte for byte;
- a preempted batch stream resumes byte-identical through the proxy;
- the autoscaler's engine-load scrape reads the port's /metrics.
"""

import json
import threading
import urllib.request

import pytest

import test_disagg as _disagg
import test_qos as _qos
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from kubeai_tpu.autoscaler.autoscaler import scrape_engine_load
from kubeai_tpu.disagg import ROLE_DECODE, ROLE_PREFILL
from kubeai_tpu.disagg.handoff import M_HANDOFFS
from kubeai_tpu.qos.stats import M_RESUMES
from kubeai_tpu_torch.engine.core import EngineConfig, build_test_engine
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.metrics import default_registry as treg

disagg_stack = _disagg.disagg_stack
qos_stack = _qos.qos_stack


def count(name, **labels):
    return treg.get(name).value(labels=labels or None)


@pytest.fixture(scope="module")
def role_engines():
    """Port servers in test_disagg's roles: prefill (handoff budget 3) and
    decode, from the same seed."""
    ec = EngineConfig(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32), decode_chunk=2)
    prefill = EngineServer(build_test_engine(ec, device="cpu"), "dz1", host="127.0.0.1",
                           port=0, role=ROLE_PREFILL, handoff_budget=3)
    decode = EngineServer(build_test_engine(ec, device="cpu"), "dz1", host="127.0.0.1",
                          port=0, role=ROLE_DECODE)
    prefill.start()
    decode.start()
    yield prefill, decode
    prefill.stop()
    decode.stop()


@pytest.fixture(scope="module")
def qos_engine():
    """A one-slot port server in test_qos's place."""
    eng = build_test_engine(EngineConfig(max_slots=1, max_seq_len=2048, prefill_buckets=(16, 32),
                                         decode_chunk=2, max_queue=16), device="cpu")
    srv = EngineServer(eng, "q1", host="127.0.0.1", port=0)
    srv.start()
    yield eng, srv
    srv.stop()


@pytest.mark.parametrize("breakeven", ["0", "256"], ids=["import", "replay"])
def test_handoff_through_the_proxy_equals_a_direct_stream(disagg_stack, role_engines,
                                                          monkeypatch, breakeven):
    """With the break-even at 0 the decode replica fetches the prefill
    replica's blob and imports it; at the default 256 this short prefix
    replays. The client's stream is the same either way."""
    monkeypatch.setenv("KUBEAI_KV_BREAKEVEN_TOKENS", breakeven)
    prefill, decode = role_engines
    _, _, _, api = disagg_stack
    body = _disagg.TestDisaggE2E.BODY
    reference, _ = _disagg.sse_post(decode.port, body, "/v1/completions")
    assert reference[-1] == "[DONE]" and len(reference) > 5
    ok_before = M_HANDOFFS.value(labels={"outcome": "ok"})
    capped_before = count("kubeai_engine_handoff_capped_total")
    imp_before = count("kubeai_kv_import_total", outcome="ok")
    exp_before = count("kubeai_kv_export_total", outcome="ok")
    got, _ = _disagg.sse_post(api.port, body, "/openai/v1/completions", rid=f"torch-dz-{breakeven}")
    assert _disagg.shape(got) == _disagg.shape(reference)
    assert M_HANDOFFS.value(labels={"outcome": "ok"}) == ok_before + 1
    assert count("kubeai_engine_handoff_capped_total") == capped_before + 1
    assert count("kubeai_kv_export_total", outcome="ok") == exp_before + 1
    assert count("kubeai_kv_import_total", outcome="ok") == imp_before + (breakeven == "0")
    assert all("handoff" not in (fr or "") for t in _disagg.shape(got) if isinstance(t, tuple)
               for fr in [t[1]])


def test_preempted_batch_stream_resumes_through_the_proxy(qos_stack, qos_engine):
    eng, srv = qos_engine
    api = qos_stack
    body = dict(_qos.BATCH_BODY)
    path = "/openai/v1/completions"
    reference = _qos.sse_post(api.port, body, path=path, headers={"X-Priority": "batch"})
    assert reference[-1] == "[DONE]" and len(reference) > 5
    pre_before = count("kubeai_qos_preemptions_total")
    imp_before = count("kubeai_kv_import_total", outcome="ok")
    res_before = M_RESUMES.value()
    got: list = []

    def run():
        got.append(_qos.sse_post(api.port, body, path=path, headers={"X-Priority": "batch"},
                                 timeout=120))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _qos.await_cond(lambda: eng.active_slots() >= 1, msg="batch stream holding the slot")
    inter = _qos.sse_post(api.port, dict(body, prompt="quick question", max_tokens=4), path=path,
                          headers={"X-Priority": "interactive"})
    assert inter[-1] == "[DONE]"
    t.join(timeout=120)
    assert not t.is_alive() and got, "batch stream never completed"
    assert count("kubeai_qos_preemptions_total") == pre_before + 1
    assert M_RESUMES.value() >= res_before + 1
    assert count("kubeai_kv_import_total", outcome="ok") == imp_before + 1
    assert got[0] == reference


def test_engine_load_scrape_reads_the_port_metrics(qos_engine):
    eng, srv = qos_engine
    addr = f"127.0.0.1:{srv.port}"
    assert scrape_engine_load(addr) == 0
    occupier = eng.submit(eng.tokenizer.encode("hold the slot"),
                          SamplingParams(temperature=0.0, max_tokens=1600))
    queued = eng.submit(eng.tokenizer.encode("wait"), SamplingParams(max_tokens=2))
    try:
        _qos.await_cond(lambda: eng.active_slots() == 1, msg="occupier admitted")
        assert scrape_engine_load(addr) == 2  # one active slot, one queued
        with urllib.request.urlopen(f"http://{addr}/health", timeout=10) as r:
            assert json.load(r)["status"] == "ok"
    finally:
        occupier.cancelled.set()
        queued.cancelled.set()
        _qos.await_cond(lambda: eng.active_slots() == 0 and eng.queue_depth() == 0,
                        msg="engine drained")
