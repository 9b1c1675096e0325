"""The port's proxy on the resume protocol's paths (kubeai_tpu_torch/proxy/
handler.py with disagg/handoff.py and qos/preempt.py) against the JAX
package's proxy, both in front of the same port engine servers on the
CPU (tests/test_torch_proxy.py's ``role_engines`` and ``qos_engine``):

- a disaggregated Model: a stream handed off from the prefill-role
  server to the decode-role one after 3 tokens (the KV blob imported at
  break-even 0, replayed at the default) reaches the client equal to a
  direct stream from the decode server, through either proxy, and the
  port proxy counts the handoff in its own ``kubeai_disagg_handoffs_total``;
- a batch stream preempted by an interactive request resumes through
  either proxy byte-identical to its unpreempted run, the port proxy
  counting the resume in its own ``kubeai_qos_resumes_total``.
"""

import threading

import pytest

import test_disagg as _disagg
import test_qos as _qos
from _torch_operator import to_port
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from kubeai_tpu.disagg import ROLE_PREFILL
from kubeai_tpu_torch.disagg.handoff import M_HANDOFFS
from kubeai_tpu_torch.qos.stats import M_RESUMES
from test_torch_operator_proxy import Stack
from test_torch_proxy import qos_engine, role_engines  # noqa: F401  (fixtures)


@pytest.fixture(scope="module")
def disagg_stacks(role_engines):  # noqa: F811
    prefill, decode = role_engines
    out = []
    for pkg in ("kubeai_tpu", "kubeai_tpu_torch"):
        st = Stack(pkg, await_timeout=10.0)
        model = _disagg.mk_disagg_model()
        st.store.create("Model", model if pkg == "kubeai_tpu" else to_port(model))
        pods = _disagg.await_role_pods(st.store, "dz1", {ROLE_PREFILL: 1, "decode": 1})
        for pod in pods:
            role = pod.meta.labels[st.m["model_types"].LABEL_ROLE]
            st.point(pod.meta.name, (prefill if role == ROLE_PREFILL else decode).port)
        _qos.await_cond(lambda st=st: len(st.lb.get_all_addresses("dz1")) == 2,
                        msg="both role endpoints")
        out.append(st)
    yield out
    for st in out:
        st.stop()


@pytest.mark.parametrize("breakeven", ["0", "256"])
def test_handoff_through_the_port_proxy_equals_the_jax_proxy(disagg_stacks, role_engines,  # noqa: F811
                                                             monkeypatch, breakeven):
    monkeypatch.setenv("KUBEAI_KV_BREAKEVEN_TOKENS", breakeven)
    prefill, decode = role_engines
    body = _disagg.TestDisaggE2E.BODY
    reference, _ = _disagg.sse_post(decode.port, body, "/v1/completions")
    assert reference[-1] == "[DONE]" and len(reference) > 5
    shapes = []
    for st in disagg_stacks:
        before = M_HANDOFFS.value(labels={"outcome": "ok"})
        got, _ = _disagg.sse_post(st.api.port, body, "/openai/v1/completions",
                                  rid=f"op-dz-{st.m['store'].__name__}-{breakeven}")
        shapes.append(_disagg.shape(got))
        port_proxy = st.m["store"].__name__.startswith("kubeai_tpu_torch")
        assert M_HANDOFFS.value(labels={"outcome": "ok"}) == before + port_proxy
    assert shapes[0] == shapes[1] == _disagg.shape(reference)


@pytest.fixture(scope="module")
def qos_stacks(qos_engine):  # noqa: F811
    eng, srv = qos_engine
    out = []
    for pkg in ("kubeai_tpu", "kubeai_tpu_torch"):
        st = Stack(pkg, await_timeout=10.0)
        st.model("q1", url="hf://qos/model", replicas=1, min_replicas=1)
        _qos.await_cond(lambda st=st: st.store.list("Pod"), msg="a q1 pod")
        st.point(st.store.list("Pod")[0].meta.name, srv.port)
        _qos.await_cond(lambda st=st: st.lb.get_all_addresses("q1"), msg="the q1 endpoint")
        out.append(st)
    yield out
    for st in out:
        st.stop()


def test_preempted_batch_stream_resumes_through_the_port_proxy(qos_stacks, qos_engine):  # noqa: F811
    eng, _ = qos_engine
    body = dict(_qos.BATCH_BODY)
    path = "/openai/v1/completions"
    results = []
    for st in qos_stacks:
        reference = _qos.sse_post(st.api.port, body, path=path, headers={"X-Priority": "batch"})
        assert reference[-1] == "[DONE]" and len(reference) > 5
        resumes = M_RESUMES.value()
        got: list = []
        t = threading.Thread(target=lambda st=st: got.append(_qos.sse_post(
            st.api.port, body, path=path, headers={"X-Priority": "batch"}, timeout=120)),
            daemon=True)
        t.start()
        _qos.await_cond(lambda: eng.active_slots() >= 1, msg="batch stream holding the slot")
        inter = _qos.sse_post(st.api.port, dict(body, prompt="quick question", max_tokens=4),
                              path=path, headers={"X-Priority": "interactive"})
        assert inter[-1] == "[DONE]"
        t.join(timeout=120)
        assert not t.is_alive() and got, "batch stream never completed"
        assert got[0] == reference
        port_proxy = st.m["store"].__name__.startswith("kubeai_tpu_torch")
        assert M_RESUMES.value() >= resumes + port_proxy
        results.append(got[0])
    assert results[0] == results[1]
