"""The engine's side of QoS in the port (kubeai_tpu_torch/qos, and the
preemption in engine/core.py) against the JAX package's.

QoSQueue gives the JAX queue's answers to the same puts and gets from a
seed (class order, fair tenant lanes, shedding, budgets). On a port
server with one slot, an interactive request seizes a preemptible batch
slot: the victim's stream ends "preempted" with no tail flush, carries a
park offer, and resumes byte-identical by unpark; a handoff-planned or
non-preemptible stream is never preempted; a shed request gets 429 with
a Retry-After scaled by its class's backlog; the wait-budget sweep errors
expired batch requests."""

import json
import queue as stdqueue
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from kubeai_tpu.qos.queue import QoSQueue as JQueue
from kubeai_tpu_torch.engine import kvstate as tkv
from kubeai_tpu_torch.engine.core import EngineConfig, build_test_engine
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.metrics import default_registry as treg
from kubeai_tpu_torch.qos import QoSQueue as TQueue
from kubeai_tpu_torch.qos import normalize_priority, rank


def count(name, **labels):
    return treg.get(name).value(labels=labels or None)


def _req(i, priority, tenant, tokens, arrival=0.0):
    return types.SimpleNamespace(i=i, priority=priority, tenant=tenant,
                                 prompt_ids=[0] * tokens, arrival=arrival)


def _drive(q, seed):
    """Outcomes of a seeded sequence of puts, gets and queries."""
    rng = np.random.default_rng(seed)
    classes = ("interactive", "standard", "batch", "platinum", "")
    out = []
    for i in range(400):
        op = rng.random()
        if op < 0.55:
            r = _req(i, classes[rng.integers(len(classes))], f"t{rng.integers(6)}",
                     int(rng.integers(1, 3000)), arrival=float(rng.integers(100)))
            try:
                q.put_nowait(r)
                out.append(("put", i))
            except stdqueue.Full:
                out.append(("full", i))
        elif op < 0.9:
            try:
                out.append(("get", q.get_nowait().i))
            except stdqueue.Empty:
                out.append(("empty",))
        else:
            cls = classes[rng.integers(3)]
            out.append(("q", q.qsize(), q.peek_priority(), q.outranks(cls),
                        q.backlog_at_or_above(cls)))
    return out + [q.snapshot()]


@pytest.mark.parametrize("seed,maxsize,quantum,topk", [
    (0, 0, None, None), (1, 24, 1, 2), (2, 40, 700, 3), (3, 9, 2048, 32)])
def test_queue_matches_jax(seed, maxsize, quantum, topk):
    kw = dict(quantum=quantum, topk=topk)
    assert _drive(TQueue(maxsize, **kw), seed) == _drive(JQueue(maxsize, **kw), seed)


def test_budget_sweep_matches_jax(monkeypatch):
    monkeypatch.setenv("KUBEAI_QOS_BUDGET_BATCH", "0.5")
    monkeypatch.setenv("KUBEAI_QOS_BUDGET_STANDARD", "5")
    got = []
    for q in (TQueue(), JQueue()):
        reqs = [_req(i, c, f"t{i % 3}", 4, arrival=a) for i, (c, a) in enumerate(
            [("batch", 100.0), ("batch", 109.8), ("interactive", 100.0), ("standard", 104.0),
             ("standard", 106.0), ("batch", 90.0)])]
        for r in reqs:
            q.put_nowait(r)
        dropped = [r.i for r in q.sweep_budgets(now=110.0)]
        again = q.sweep_budgets(now=110.1)  # rate-limited
        got.append((dropped, again, q.qsize(), q.snapshot()))
    assert got[0] == got[1]
    assert got[0][0] == [3, 0, 5] and got[0][1] == []


def test_classes_match_jax():
    from kubeai_tpu.qos import classes as jc
    from kubeai_tpu.obs import tenants as jt
    from kubeai_tpu_torch.qos import classes as tc

    for v in ("interactive", " BATCH ", "standard", "platinum", "", None):
        assert normalize_priority(v) == jc.normalize_priority(v)
        assert rank(v or "") == jc.rank(v or "")
    assert (tc.CLASSES, tc.DEFAULT_CLASS, tc.PRIORITY_HEADER, tc.PREEMPTIBLE_HEADER) == \
        (jc.CLASSES, jc.DEFAULT_CLASS, jc.PRIORITY_HEADER, jc.PREEMPTIBLE_HEADER)
    assert (tc.TENANT_HEADER, tc.ANONYMOUS, tc.OTHER) == (jt.TENANT_HEADER, jt.ANONYMOUS, jt.OTHER)
    for t in ("abc-1.2_x", "a b/c\\"*20, "ü"):
        assert tc.sanitize_tenant(t) == jt.sanitize_tenant(t)


# -- one-slot engine server ----------------------------------------------------


@pytest.fixture(scope="module")
def qos_engine():
    """A port engine server with one decode slot: every batch-interactive
    contention is deterministic."""
    eng = build_test_engine(EngineConfig(max_slots=1, max_seq_len=2048, prefill_buckets=(16, 32),
                                         decode_chunk=2, max_queue=16), device="cpu")
    srv = EngineServer(eng, "q1", host="127.0.0.1", port=0)
    srv.start()
    yield eng, srv
    srv.stop()


def sse_post(port, body, headers=None, timeout=60):
    """((text, finish_reason) events + "[DONE]", kv offers)."""
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


def await_cond(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out awaiting {msg}")


# Long enough to be mid-decode when the interactive request lands.
BATCH_BODY = {"model": "q1", "prompt": "the long batch job", "stream": True,
              "temperature": 0, "max_tokens": 400}


def _contend(eng, srv, headers):
    """A batch stream with *headers*, and an interactive request once it
    holds the slot: (batch events, batch offers, interactive events)."""
    got: list = []

    def run():
        got.append(sse_post(srv.port, BATCH_BODY, headers={"X-Priority": "batch", **headers}))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    await_cond(lambda: eng.active_slots() >= 1 and count("kubeai_engine_active_slots") >= 1,
               msg="batch stream holding the slot")
    inter, _ = sse_post(srv.port, dict(BATCH_BODY, prompt="quick question", max_tokens=4),
                        headers={"X-Priority": "interactive"})
    t.join(timeout=60)
    assert not t.is_alive(), "batch stream never ended"
    return got[0][0], got[0][1], inter


def test_interactive_preempts_and_the_victim_resumes_by_unpark(qos_engine):
    eng, srv = qos_engine
    reference, _ = sse_post(srv.port, BATCH_BODY, headers={"X-Priority": "batch"})
    pre_before = count("kubeai_qos_preemptions_total")
    imp_before = count("kubeai_kv_import_total", outcome="ok")
    events, offers, inter = _contend(eng, srv, {"X-Preemptible": "1"})
    assert inter[-1] == "[DONE]"
    fins = [s[1] for s in events if isinstance(s, tuple) and s[1]]
    assert fins == ["preempted"] and events[-1] == "[DONE]"
    assert count("kubeai_qos_preemptions_total") == pre_before + 1
    # No tail flush: the events before the marker are the reference's own.
    n = len(events) - 2
    assert 0 < n < len(reference) - 2 and events[:n] == reference[:n]
    assert len(offers) == 1 and offers[0]["source"] == srv.kv_advertise
    resumed, _ = sse_post(srv.port, BATCH_BODY, headers={
        "X-Priority": "batch", "X-Resume-Tokens": str(n), "X-KV-Key": offers[0]["key"],
        "X-KV-Source": offers[0]["source"], "X-KV-Tokens": str(offers[0]["tokens"])})
    assert resumed == reference
    assert count("kubeai_kv_import_total", outcome="ok") == imp_before + 1
    assert [e for e in eng.kv_log if e["event"] == "import"][-1]["how"] == "unparked"


@pytest.mark.parametrize("headers", [{"X-Preemptible": "1", "X-Handoff-Planned": "1"}, {}],
                         ids=["handoff_planned", "not_preemptible"])
def test_never_preempted(qos_engine, headers):
    eng, srv = qos_engine
    pre_before = count("kubeai_qos_preemptions_total")
    events, offers, inter = _contend(eng, srv, headers)
    assert inter[-1] == "[DONE]"
    assert [s[1] for s in events if isinstance(s, tuple) and s[1]] == ["length"]
    assert offers == [] and count("kubeai_qos_preemptions_total") == pre_before


def _occupy(eng):
    occupier = eng.submit(eng.tokenizer.encode("hold the slot"),
                          SamplingParams(temperature=0.0, max_tokens=1600),
                          priority="interactive")
    await_cond(lambda: eng.active_slots() >= 1, msg="occupier admitted")
    return occupier


def test_queue_wait_budget_errors_expired_batch(qos_engine, monkeypatch):
    eng, _ = qos_engine
    monkeypatch.setenv("KUBEAI_QOS_BUDGET_BATCH", "0.3")
    drops_before = count("kubeai_qos_budget_drops_total", **{"class": "batch"})
    occupier = _occupy(eng)
    try:
        batch = eng.submit(eng.tokenizer.encode("bulk"),
                           SamplingParams(temperature=0.0, max_tokens=4), priority="batch")
        ev = batch.out.get(timeout=10)
        assert ev[0] == "error" and "budget" in ev[1], ev
        assert count("kubeai_qos_budget_drops_total", **{"class": "batch"}) == drops_before + 1
    finally:
        occupier.cancelled.set()
        await_cond(lambda: eng.active_slots() == 0, msg="engine drained")


def test_shed_batch_gets_429_with_a_scaled_retry_after(qos_engine):
    """Batch sheds at 50% of max_queue (8 of 16), with a Retry-After of
    1 + backlog // slots."""
    eng, srv = qos_engine
    occupier = _occupy(eng)
    queued = []
    try:
        for _ in range(8):
            queued.append(eng.submit(eng.tokenizer.encode("bulk"),
                                     SamplingParams(temperature=0.0, max_tokens=4),
                                     priority="batch"))
        with pytest.raises(stdqueue.Full):
            eng.submit(eng.tokenizer.encode("bulk"), SamplingParams(), priority="batch")
        assert eng.qos_retry_after("batch") == 9 and eng.qos_retry_after("interactive") == 1
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps(dict(BATCH_BODY, stream=False)).encode(),
            headers={"Content-Type": "application/json", "X-Priority": "batch"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 429 and exc.value.headers.get("Retry-After") == "9"
        assert count("kubeai_engine_queue_depth") == eng.queue_depth() == 8
    finally:
        for r in queued:
            r.cancelled.set()
        occupier.cancelled.set()
        await_cond(lambda: eng.active_slots() == 0 and eng.queue_depth() == 0,
                   msg="engine drained")
