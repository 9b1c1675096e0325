"""Failure containment of the port's engine and server on the CPU, with
the port's failpoints (kubeai_tpu_torch/faults.py): the JAX package's
tests/test_chaos.py::TestEngineContainment (nine cases) and
TestEngineDrainAndStop against port servers, and ``n`` > 1.

Every case asserts containment: the client's status (429 + Retry-After,
500, 504), and no slot, KV page or in-system request leaked. A deadline
that expires mid-decode aborts through the cancel path, so the pages
come back only after the chunk in flight is fetched: ``_pool.used()`` is
0 once the engine drains.

``n`` = 3 greedy choices equal three single requests of the port, each
equal to the JAX server's on the same weights; sampled choices are held
to ``seed + i`` on the port alone (the two packages' noise differs by
design).
"""

import json
import queue
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubeai_tpu.engine.server import EngineServer as JServer
from kubeai_tpu_torch import faults
from kubeai_tpu_torch.engine.core import EngineConfig, build_test_engine
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.server import EngineServer

from _torch_parity import parity_engines
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear_all()
    yield
    faults.clear_all()


def _await(cond, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out awaiting {msg}")


def post(port, body, path="/v1/completions", headers=None, timeout=30):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode()
            return resp.status, dict(resp.headers), (
                raw if body.get("stream") else json.loads(raw))
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def get(port, path, timeout=5):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def mk_params(**kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("max_tokens", 8)
    return SamplingParams(**kw)


@pytest.fixture(scope="module")
def eng_srv():
    ec = EngineConfig(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32), max_queue=2,
                      decode_chunk=2)
    eng = build_test_engine(ec, device="cpu")
    srv = EngineServer(eng, "chaos-model", host="127.0.0.1", port=0)
    srv.start()
    eng.generate(eng.tokenizer.encode("warm"), mk_params(max_tokens=4), timeout=120)
    yield eng, srv
    faults.clear_all()
    srv.stop()


def park_scheduler(eng):
    """Hang the scheduler at the engine.step failpoint, and wait until it
    provably hangs there."""
    faults.arm_spec("engine.step", "hang")
    eng._wake.set()
    _await(lambda: any(f["name"] == "engine.step" and f["fired"] >= 1
                       for f in faults.list_faults()),
           msg="scheduler parked at engine.step failpoint")


def drain_engine(eng, timeout=10.0):
    _await(lambda: eng.queue_depth() == 0 and eng.active_slots() == 0
           and eng.requests_in_system() == 0, timeout=timeout, msg="engine drained")


def cancelled_count(eng):
    return eng.m_requests.value(labels={"outcome": "cancelled"})


class TestEngineContainment:
    def test_deadline_expires_mid_decode_frees_slot_and_pages(self, eng_srv):
        eng, srv = eng_srv
        before = cancelled_count(eng)
        ids = eng.tokenizer.encode("tell me everything")
        # A slowed scheduler: the ~230-token budget cannot finish inside
        # the deadline, so the abort comes from the sweep.
        faults.arm_spec("engine.step", "delay:0.02")
        req = eng.submit(ids, mk_params(max_tokens=2000), deadline=time.monotonic() + 0.2)
        events = []
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            ev = req.out.get(timeout=10)
            events.append(ev)
            if ev[0] in ("done", "error"):
                break
        assert events[-1] == ("error", eng.DEADLINE_MSG)
        assert 0 < len(events) - 1 < 200  # it decoded, and was cut short
        drain_engine(eng)
        assert eng._pool.used() == 0, "KV pages leaked by the deadline abort"
        assert eng.m_active.value() == 0
        assert cancelled_count(eng) == before + 1
        assert req.out.empty()  # nothing after the error

    def test_deadline_expired_while_queued_never_takes_slot(self, eng_srv):
        eng, srv = eng_srv
        before = cancelled_count(eng)
        park_scheduler(eng)
        req = eng.submit(eng.tokenizer.encode("hi"), mk_params(),
                         deadline=time.monotonic() + 0.05)
        time.sleep(0.1)  # expire while the scheduler is parked
        faults.clear_fault("engine.step")
        assert req.out.get(timeout=10) == ("error", eng.DEADLINE_MSG)
        drain_engine(eng)
        assert eng._pool.used() == 0
        assert cancelled_count(eng) == before + 1

    def test_queue_full_maps_to_429_with_retry_after(self, eng_srv):
        eng, srv = eng_srv
        park_scheduler(eng)
        fillers = []
        try:
            while True:
                try:
                    fillers.append(eng.submit(eng.tokenizer.encode("f"), mk_params()))
                except queue.Full:
                    break
            status, headers, body = post(srv.port, {"model": "chaos-model", "prompt": "x"})
            assert status == 429
            assert headers.get("Retry-After")
            assert body["error"]["type"] == "rate_limit_error"
        finally:
            for r in fillers:
                r.cancelled.set()
            faults.clear_fault("engine.step")
        drain_engine(eng)

    def test_multi_choice_queue_full_cancels_submitted_siblings(self, eng_srv):
        eng, srv = eng_srv
        before = cancelled_count(eng)
        park_scheduler(eng)
        try:
            # n = 3 against a 2-deep queue: choices 1-2 submit, choice 3
            # is shed, and the server cancels the two.
            status, headers, _ = post(srv.port, {"model": "chaos-model", "prompt": "x", "n": 3,
                                                 "max_tokens": 4})
            assert status == 429
            assert headers.get("Retry-After")
        finally:
            faults.clear_fault("engine.step")
        drain_engine(eng)
        assert eng.m_active.value() == 0
        assert eng._pool.used() == 0
        _await(lambda: cancelled_count(eng) >= before + 2, msg="sibling cancellation accounting")

    def test_multi_choice_submit_fault_cancels_siblings(self, eng_srv):
        """An injected submit error on choice 2 (not a queue.Full) also
        cancels the sibling already submitted."""
        eng, srv = eng_srv
        before = cancelled_count(eng)
        park_scheduler(eng)
        faults.arm_spec("engine.submit", "error:1:skip=1")
        try:
            status, _, body = post(srv.port, {"model": "chaos-model", "prompt": "x", "n": 2,
                                              "max_tokens": 4})
            assert status == 500
        finally:
            faults.clear_fault("engine.submit")
            faults.clear_fault("engine.step")
        drain_engine(eng)
        assert eng.m_active.value() == 0
        _await(lambda: cancelled_count(eng) >= before + 1, msg="sibling cancellation accounting")

    def test_engine_hang_contained_by_request_deadline(self, eng_srv):
        """The scheduler hangs mid-serving: the handler's deadline wait
        still answers 504; no thread waits forever."""
        eng, srv = eng_srv
        park_scheduler(eng)
        try:
            t0 = time.monotonic()
            status, _, body = post(srv.port, {"model": "chaos-model", "prompt": "x",
                                              "max_tokens": 4},
                                   headers={"X-Request-Deadline": "0.2"})
            assert status == 504
            assert body["error"]["type"] == "timeout_error"
            assert time.monotonic() - t0 < 8.0
        finally:
            faults.clear_fault("engine.step")
        drain_engine(eng)
        assert eng._pool.used() == 0

    def test_deadline_header_504_while_healthy(self, eng_srv):
        eng, srv = eng_srv
        faults.arm_spec("engine.step", "delay:0.02")
        status, _, body = post(srv.port, {"model": "chaos-model", "prompt": "x",
                                          "max_tokens": 2000},
                               headers={"X-Request-Deadline": "0.15"})
        assert status == 504
        assert body["error"]["type"] == "timeout_error"
        # A spent budget is refused before admission.
        status, _, body = post(srv.port, {"model": "chaos-model", "prompt": "x"},
                               headers={"X-Request-Deadline": "0"})
        assert status == 504 and body["error"]["message"] == "deadline exceeded"
        faults.clear_fault("engine.step")
        drain_engine(eng)
        assert eng._pool.used() == 0

    def test_scheduler_fault_recovers_and_serves_again(self, eng_srv, monkeypatch):
        eng, srv = eng_srv
        # The reset fails whatever is queued when it runs, which can be
        # after the fault is counted: wait for the reset itself.
        reset = threading.Event()
        recover = eng._recover
        monkeypatch.setattr(eng, "_recover", lambda: (recover(), reset.set()))
        faults.arm_spec("engine.step", "error:1")
        _await(lambda: any(f["name"] == "engine.step" and f["fired"] >= 1
                           for f in faults.list_faults()), msg="injected scheduler fault")
        assert reset.wait(30), "the scheduler's reset after the fault"
        # The loop's reset path rebuilt the device state; serving resumes.
        ids, text, fin = eng.generate(eng.tokenizer.encode("still alive"),
                                      mk_params(max_tokens=4), timeout=60)
        assert fin.reason in ("stop", "length")

    def test_submit_racing_fail_inflight_never_strands(self):
        """submit() against stop()'s _fail_inflight: every request submit()
        returned sees a terminal event."""
        ec = EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(16,), max_queue=64,
                          decode_chunk=2)
        eng = build_test_engine(ec, device="cpu")
        eng.start()
        reqs, lock, go = [], threading.Lock(), threading.Event()

        def submitter():
            go.wait()
            for _ in range(20):
                try:
                    r = eng.submit(eng.tokenizer.encode("r"), mk_params(max_tokens=2))
                except queue.Full:
                    continue
                except RuntimeError as e:
                    if "not running" in str(e) or "shutting down" in str(e):
                        continue
                    raise
                with lock:
                    reqs.append(r)

        threads = [threading.Thread(target=submitter, daemon=True) for _ in range(4)]
        for t in threads:
            t.start()
        go.set()
        time.sleep(0.05)
        eng.stop()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        for r in reqs:
            deadline = time.monotonic() + 5
            while True:
                try:
                    ev = r.out.get(timeout=max(0.01, deadline - time.monotonic()))
                except queue.Empty:
                    raise AssertionError("request stranded without terminal event") from None
                if ev[0] in ("done", "error"):
                    break
        assert eng.requests_in_system() == 0


def _sse_texts(raw: str) -> tuple[dict, dict]:
    """{choice index: joined text}, {choice index: finish reason} and the
    usage block of an SSE body."""
    texts, reasons, usage = {}, {}, None
    for line in raw.splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        ev = json.loads(line[6:])
        usage = ev.get("usage") or usage
        for ch in ev["choices"]:
            texts[ch["index"]] = texts.get(ch["index"], "") + ch.get("text", "")
            if ch.get("finish_reason"):
                reasons[ch["index"]] = ch["finish_reason"]
    return texts, reasons, usage


class TestDrainAndStop:
    def test_drain_flips_readyz_rejects_new_finishes_inflight(self):
        ec = EngineConfig(max_slots=2, max_seq_len=256, prefill_buckets=(16,), decode_chunk=2)
        srv = EngineServer(build_test_engine(ec, device="cpu"), "drain-model",
                           host="127.0.0.1", port=0)
        srv.start()
        try:
            assert get(srv.port, "/readyz") == (200, {"status": "ok", "model": "drain-model"})
            # A slowed stream in flight outlasts the checks below.
            faults.arm_spec("engine.step", "delay:0.05")
            result = {}
            stream = threading.Thread(target=lambda: result.setdefault("r", post(
                srv.port, {"prompt": "long one", "max_tokens": 40, "temperature": 0,
                           "stream": True})), daemon=True)
            stream.start()
            _await(lambda: srv.engine.active_slots() == 1, msg="stream admitted")
            t = threading.Thread(target=srv.drain, args=(15.0,), daemon=True)
            t.start()
            _await(srv.draining.is_set, msg="engine draining flag")
            assert get(srv.port, "/readyz") == (503, {"status": "draining",
                                                      "model": "drain-model"})
            status, headers, body = post(srv.port, {"prompt": "x"})
            assert status == 429 and headers.get("Retry-After")
            assert body["error"]["type"] == "rate_limit_error"
            status, _, _ = post(srv.port, {"prompt": "x", "stream": True})
            assert status == 429
            assert get(srv.port, "/v1/models")[0] == 200
            assert t.is_alive(), "the drain must wait for the stream in flight"
            faults.clear_fault("engine.step")
            stream.join(timeout=30)
            t.join(timeout=30)
            assert not stream.is_alive() and not t.is_alive()
            status, _, raw = result["r"]
            texts, reasons, _ = _sse_texts(raw)
            assert status == 200 and reasons == {0: "length"} and raw.endswith("[DONE]\n\n")
            assert srv.engine._pool.used() == 0 and srv.stopped_event.is_set()
        finally:
            srv.stop()  # idempotent

    def test_drain_budget_expiry_fails_remainder(self):
        ec = EngineConfig(max_slots=1, max_seq_len=64, prefill_buckets=(16,), decode_chunk=2)
        eng = build_test_engine(ec, device="cpu")
        srv = EngineServer(eng, "drain2", host="127.0.0.1", port=0)
        srv.start()
        try:
            faults.arm_spec("engine.step", "hang:max=1.0")
            eng._wake.set()
            _await(lambda: any(f["name"] == "engine.step" and f["fired"] >= 1
                               for f in faults.list_faults()), msg="scheduler parked")
            stuck = eng.submit(eng.tokenizer.encode("stuck"), mk_params())
            srv.drain(grace=0.2)  # the budget expires: hard stop
            while True:
                ev = stuck.out.get(timeout=10)
                if ev[0] in ("done", "error"):
                    break
            assert ev[0] == "error"
            assert eng.requests_in_system() == 0
        finally:
            srv.stop()


@pytest.fixture(scope="module")
def twin_servers():
    """A JAX and a port server on one set of weights (test:tiny)."""
    je, te = parity_engines()
    jsrv = JServer(je, "tiny", host="127.0.0.1", port=0)
    tsrv = EngineServer(te, "tiny", host="127.0.0.1", port=0)
    jsrv.start()
    tsrv.start()
    yield jsrv, tsrv
    jsrv.stop()
    tsrv.stop()


GREEDY = {"prompt": "The sea", "max_tokens": 10, "temperature": 0}


def test_n3_greedy_equals_single_requests_and_the_jax_server(twin_servers):
    jsrv, tsrv = twin_servers
    status, _, port_n = post(tsrv.port, {**GREEDY, "n": 3})
    _, _, jax_n = post(jsrv.port, {**GREEDY, "n": 3})
    _, _, single = post(tsrv.port, GREEDY)
    assert status == 200 and [c["index"] for c in port_n["choices"]] == [0, 1, 2]
    texts = [c["text"] for c in port_n["choices"]]
    assert texts == [single["choices"][0]["text"]] * 3
    assert texts == [c["text"] for c in jax_n["choices"]]
    assert port_n["usage"] == jax_n["usage"]
    assert port_n["usage"]["completion_tokens"] == 3 * single["usage"]["completion_tokens"]
    # Streamed: every event carries its choice's index; usage is summed.
    status, _, raw = post(tsrv.port, {**GREEDY, "n": 3, "stream": True,
                                      "stream_options": {"include_usage": True}})
    stexts, reasons, usage = _sse_texts(raw)
    assert status == 200 and stexts == dict(enumerate(texts)) and len(reasons) == 3
    assert usage == port_n["usage"]
    chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "temperature": 0}
    _, _, tchat = post(tsrv.port, {**chat, "n": 2}, path="/v1/chat/completions")
    _, _, jchat = post(jsrv.port, {**chat, "n": 2}, path="/v1/chat/completions")
    assert [c["message"] for c in tchat["choices"]] == [c["message"] for c in jchat["choices"]]


def test_sampled_choices_use_seed_plus_i(twin_servers):
    _, tsrv = twin_servers
    body = {"prompt": "Once", "max_tokens": 12, "temperature": 0.9, "seed": 7}
    _, _, multi = post(tsrv.port, {**body, "n": 3})
    singles = [post(tsrv.port, {**body, "seed": 7 + i})[2]["choices"][0]["text"]
               for i in range(3)]
    assert [c["text"] for c in multi["choices"]] == singles
    assert len(set(singles)) > 1


@pytest.mark.parametrize("n", [0, 17, 1.5, True, "2"])
def test_bad_n_is_refused_before_any_submit(twin_servers, n):
    _, tsrv = twin_servers
    before = tsrv.engine.requests_in_system()
    status, _, body = post(tsrv.port, {**GREEDY, "n": n})
    assert status == 400 and "between 1 and 16" in body["error"]["message"]
    status, _, _ = post(tsrv.port, {**GREEDY, "n": 2, "echo": "yes"})
    assert status == 400
    assert tsrv.engine.requests_in_system() == before
