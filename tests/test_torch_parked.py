"""The port's parked replica (kubeai_tpu_torch/engine/server.py) against
the JAX server's: /readyz, /health, /v1/* and a second /v1/attach answer
with the JAX bodies and codes; an attach to a tiny checkpoint serves the
JAX engine's greedy tokens; a park config's warmed engine is adopted (its
weights loaded in place) by an attach of the same configuration and not by
another; a failing kernel build ends an attach as "failed: ..."; and the
JAX operator's ParkedPool claims a running port parked server and sweeps
one whose attach failed."""

import json
import time
import urllib.error
import urllib.request

import pytest

from kubeai_tpu.api import model_types as mt
from kubeai_tpu.api.core_types import KIND_POD, Container, Pod, PodSpec
from kubeai_tpu.api.model_types import Model, ModelSpec
from kubeai_tpu.autoscaler.autoscaler import DecisionLog
from kubeai_tpu.controller.parked import LABEL_PARKED, ParkedPool
from kubeai_tpu.engine import server as jserver
from kubeai_tpu.engine import weights as jw
from kubeai_tpu.engine.core import EngineConfig as JEC
from kubeai_tpu.runtime.store import ObjectMeta, Store
from kubeai_tpu_torch.engine import coldstart as tcs
from kubeai_tpu_torch.engine import weights as tw
from kubeai_tpu_torch.engine.core import EngineConfig as TEC
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.ops import _build

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from test_parked import _seed_running_parked, _system
from test_torch_coldstart import _leaves
from test_torch_engine import _assert_same_greedy
from test_torch_weights import _checkpoint

ARGS = ["--max-slots", "2", "--max-seq-len", "128"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _checkpoint(tmp_path_factory.mktemp("ck") / "tiny", V=300)


def _http(port, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _await_attach(port, timeout=120) -> dict:
    """/readyz once the attach has left "attaching"."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code, body = _http(port, "/readyz")
        if code == 200 or not str(body.get("attach", "")).startswith(("attaching", "parked")):
            return {"code": code, **body}
        time.sleep(0.05)
    raise AssertionError("attach did not finish")


@pytest.fixture
def parked():
    srv = EngineServer(None, "(parked)", host="127.0.0.1", port=0, device="cpu")
    srv.start()
    yield srv
    srv.stop()


def test_parked_routes_match_jax(ckpt, parked, monkeypatch):
    # Both attaches skip the warmup (the JAX one would compile every
    # bucket): the routes are the subject here.
    monkeypatch.setenv("KUBEAI_ATTACH_WARMUP", "0")
    js = jserver.EngineServer(None, "(parked)", host="127.0.0.1", port=0)
    js.start()
    try:
        probes = [("GET", "/readyz", None), ("GET", "/health", None), ("GET", "/v1/models", None),
                  ("GET", "/v1/kv/nope", None),
                  ("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 2}),
                  ("POST", "/v1/chat/completions", {"messages": [{"role": "user",
                                                                  "content": "hi"}]}),
                  ("POST", "/v1/embeddings", {"input": "hi"})]
        for method, path, body in probes:
            got = _http(parked.port, path, body if method == "POST" else None)
            want = _http(js.port, path, body if method == "POST" else None)
            if path == "/v1/models":
                for b in (got[1], want[1]):
                    for m in b["data"]:
                        m.pop("owned_by")
            assert got == want, path
        assert _http(parked.port, "/readyz") == (503, {"status": "parked", "attach": "parked"})
        # The same attach into each: accepted, then a second one refused.
        attach = {"model": ckpt, "served_model_name": "tiny", "args": ARGS}
        assert _http(parked.port, "/v1/attach", attach) == (202, {"status": "attaching"})
        assert _http(js.port, "/v1/attach", attach) == (202, {"status": "attaching"})
        for port in (parked.port, js.port):
            assert _await_attach(port)["code"] == 200
        got = _http(parked.port, "/v1/attach", attach)
        assert got == _http(js.port, "/v1/attach", attach)
        assert got == (409, {"status": "model 'tiny' already attached"})
        assert _http(parked.port, "/health") == _http(js.port, "/health")
        # Greedy tokens of the attached engine against the JAX engine on
        # the same checkpoint.
        je = jw.load_engine_from_path(ckpt, JEC(max_slots=2, max_seq_len=128))
        je.start()
        try:
            _assert_same_greedy(je, parked.engine, [256] + list(b"Hello there"), n=12)
        finally:
            je.stop()
        snap = parked.engine.cold_start_timeline.snapshot()
        assert {"stage", "load", "build"} <= set(snap["phases"]) and "ready_s" in snap
        assert "adopted_park_engine" not in snap["attrs"]  # no park config: nothing to adopt
    finally:
        js.stop()


def test_drain_of_a_parked_server_stops_it(parked):
    parked.drain()
    assert parked.stopped_event.is_set()


def test_attach_refusals_and_retry(ckpt, parked):
    """An attach without --model fails (retryable); one while attaching is
    refused; a good one after the failure attaches."""
    assert parked.attach(["--max-slots", "2"]) == (True, "attaching")
    state = _await_attach(parked.port)
    assert state["code"] == 503 and state["attach"].startswith("failed: ")
    with parked._attach_lock:
        parked._attach_state = "attaching"
    assert parked.attach(["--model", ckpt]) == (False, "attach already in progress")
    with parked._attach_lock:
        parked._attach_state = "failed: earlier"
    assert parked.attach(["--model", ckpt, "--port", "9", "--bogus", "1"] + ARGS) == \
        (True, "attaching")
    assert _await_attach(parked.port)["code"] == 200
    assert parked.port != 9 and parked.model_name == ckpt


def _park(srv, ckpt, args):
    srv.start_park_warm(ckpt, ["--device", "cpu"] + args)
    stats = srv.park_warm.join()
    assert "error" not in stats, stats
    return stats


def test_attach_adopts_the_park_engine(ckpt, parked):
    """--park-config warms an engine over zero weights at the checkpoint's
    shapes; an attach of the same configuration takes it, weights copied
    in place, and serves what an engine loaded directly serves."""
    stats = _park(parked, ckpt, ARGS)
    eng = parked.park_engine
    assert stats["warmup"]["shapes"] == eng.warmup_result["shapes"] > 0
    assert all(not t.any() for t in _leaves(eng.params))  # zeros until the attach
    ptrs = [t.data_ptr() for t in _leaves(eng.params)]
    assert parked.attach(["--model", ckpt] + ARGS) == (True, "attaching")
    assert _await_attach(parked.port)["code"] == 200
    assert parked.engine is eng and parked.park_engine is None
    assert [t.data_ptr() for t in _leaves(eng.params)] == ptrs
    snap = eng.cold_start_timeline.snapshot()
    assert snap["attrs"]["adopted_park_engine"] is True and "ready_s" in snap
    code, body = _http(parked.port, "/debug/engine")
    assert body["cold_start"]["attrs"]["adopted_park_engine"] is True
    direct = tw.load_engine_from_path(ckpt, TEC(max_slots=2, max_seq_len=128), device="cpu")
    direct.start()
    try:
        for prompt in ([256] + list(b"Hello there"), [256] + [(i * 11) % 250 + 1 for i in range(90)]):
            sp = TSP(temperature=0.0, max_tokens=10)
            assert eng.generate(prompt, sp)[0] == direct.generate(prompt, sp)[0]
    finally:
        direct.stop()


def test_failed_attach_keeps_the_park_engine_for_a_retry(ckpt, parked, monkeypatch):
    """A read that fails mid-attach leaves the park engine parked (its
    weights untouched: load_params_ checks before it writes); the retry
    adopts it."""
    _park(parked, ckpt, ARGS)
    eng = parked.park_engine
    real = tw.stream_params_from_hf

    def broken(*a, **kw):
        raise OSError("injected read failure")

    monkeypatch.setattr(tw, "stream_params_from_hf", broken)
    assert parked.attach(["--model", ckpt] + ARGS)[0]
    assert _await_attach(parked.port)["attach"] == "failed: injected read failure"
    assert parked.park_engine is eng and all(not t.any() for t in _leaves(eng.params))
    monkeypatch.setattr(tw, "stream_params_from_hf", real)
    assert parked.attach(["--model", ckpt] + ARGS)[0]
    assert _await_attach(parked.port)["code"] == 200 and parked.engine is eng


def test_attach_of_another_config_builds_afresh(ckpt, parked):
    _park(parked, ckpt, ARGS)
    park_engine = parked.park_engine
    assert parked.attach(["--model", ckpt, "--max-slots", "3", "--max-seq-len", "128"])[0]
    assert _await_attach(parked.port)["code"] == 200
    assert parked.engine is not park_engine and parked.engine.cfg.max_slots == 3
    assert parked.engine.cold_start_timeline.snapshot()["attrs"]["adopted_park_engine"] is False


def test_failing_build_fails_the_attach(ckpt, parked, monkeypatch):
    """A warm whose kernel build fails: the failure is in the stats, and
    the attach that needs the kernel ends "failed: ...", never serving
    without it."""
    def failing_build(names, ptxas_verbose=False):
        raise RuntimeError("CUDA kernel build failed:\n--- injected")

    monkeypatch.setattr(tcs, "runs_kernels", lambda device: True)
    monkeypatch.setattr(_build, "build", failing_build)
    monkeypatch.setenv("KUBEAI_COLDSTART_OVERLAP", "1")
    parked.start_park_warm(ckpt, ["--device", "cpu"] + ARGS)
    stats = parked.park_warm.join()
    assert "kernel build failed" in stats["error"] and parked.park_engine is None
    assert parked.attach(["--model", ckpt] + ARGS) == (True, "attaching")
    state = _await_attach(parked.port)
    assert state["code"] == 503 and state["status"] == "parked"
    assert state["attach"].startswith("failed: CUDA kernel build failed")
    assert parked.engine is None


def _desired_pod(model_name, ckpt, pod_hash="abcd1234"):
    """The model pod a controller plans (the JAX engine's args)."""
    return Pod(
        meta=ObjectMeta(name="", labels={mt.LABEL_MODEL: model_name, mt.LABEL_POD_HASH: pod_hash}),
        spec=PodSpec(containers=[Container(
            name="server", command=["python", "-m", "kubeai_tpu.engine.server"],
            args=["--model", ckpt, "--served-model-name", model_name, "--port", "8000"] + ARGS)]),
    )


def test_jax_parked_pool_claims_a_port_parked_server(ckpt, parked):
    """ParkedPool.claim POSTs the desired pod's args to a running port
    parked server, which attaches and serves; the pod is relabeled."""
    store = Store()
    log = DecisionLog()
    pool = ParkedPool(store, _system(parked=1), decision_log=log)
    pod = _seed_running_parked(store, pool, parked.port)
    model = Model(meta=ObjectMeta(name="m1", uid="uid-1"), spec=ModelSpec(url=f"file://{ckpt}"))
    claimed = pool.claim(model, _desired_pod("m1", ckpt))
    assert claimed is not None and claimed.meta.name == pod.meta.name
    adopted = store.get(KIND_POD, pod.meta.name, "default")
    assert adopted.meta.labels[LABEL_PARKED] == "attached"
    assert adopted.meta.labels[mt.LABEL_MODEL] == "m1"
    assert log.snapshot(model="m1")[0]["action"] == "parked_attach"
    assert _await_attach(parked.port)["code"] == 200
    code, body = _http(parked.port, "/v1/completions",
                       {"model": "m1", "prompt": "hello", "max_tokens": 3, "temperature": 0})
    assert code == 200 and body["model"] == "m1"
    assert body["choices"][0]["finish_reason"] in ("length", "stop")
    pool.reconcile()  # a ready-to-be adopted pod whose attach succeeded stays
    assert store.list(KIND_POD, "default", {mt.LABEL_MODEL: "m1"}) != []


def test_jax_parked_pool_sweeps_a_failed_port_attach(tmp_path, parked):
    store = Store()
    log = DecisionLog()
    pool = ParkedPool(store, _system(parked=1), decision_log=log)
    pod = _seed_running_parked(store, pool, parked.port)
    model = Model(meta=ObjectMeta(name="m2"), spec=ModelSpec(url="file:///missing"))
    assert pool.claim(model, _desired_pod("m2", str(tmp_path / "missing"))) is not None
    assert _await_attach(parked.port)["attach"].startswith("failed: ")
    pool.reconcile()
    assert store.list(KIND_POD, "default", {mt.LABEL_MODEL: "m2"}) == []
    recs = [r for r in log.snapshot(model="m2") if r["action"] == "parked_attach_failed"]
    assert recs and recs[0]["pod"] == pod.meta.name and recs[0]["error"].startswith("failed: ")
