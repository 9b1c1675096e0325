"""The port's operator end to end on the CPU (the counterpart of
tests/test_e2e_local.py): ``kubeai_tpu_torch.manager.Manager`` with
LocalRuntime runs real ``python -m kubeai_tpu_torch.engine.server``
processes.

A Model over a tiny checkpoint (``file://``, ``--device cpu``: the pods
would otherwise ask for the card), minReplicas 0, PrefixHash:
- the first request scales it from zero (replicas 1, one pod running the
  port's server with ``--tensor-parallel-size 1``), and the greedy text
  of three completions through ``/openai/v1/completions`` equals the JAX
  engine's over the same checkpoint, built in process with the JAX
  server's own arguments; where the two first differ the JAX engine's
  top-2 logprobs must lie within 2 bf16 ulps (both serve the checkpoint
  in bf16);
- the same three bodies published over the Manager's mem:// and file://
  streams (its messengers) come back on the response streams with status
  200 and their correlation metadata, held to the same JAX choices;
- at replicas 2, eight requests that share a 100-character prefix land
  on one pod (found by request id in each pod's /debug/requests);
- deleting the Model ends both processes.
The Model holds its replicas through these checks with a long
scaleDownDelaySeconds: the autoscaler runs in the Manager and would
otherwise take the hand-set second replica away.

The control loops, with an autoscaler interval of 0.3 s and one parked
pod (``--parked --device cpu``): a Model listing a ``file://`` adapter
scales from zero by claiming the parked pod (a ``parked_attach`` record
in ``/debug/autoscaler``); the adapter reconciler loads the adapter on it,
and the greedy text of ``<model>_gsa`` through the proxy equals the JAX
engine's with that adapter (the same near-tie rule); after
scaleDownDelaySeconds without traffic the autoscaler takes the Model to
zero and its process exits.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from kubeai_tpu.engine.core import EngineConfig as JEC
from kubeai_tpu.engine.weights import load_engine_from_path as jload
from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.core_types import KIND_POD
from kubeai_tpu_torch.api.model_types import Adapter, LoadBalancing, Model, ModelSpec, PrefixHash
from kubeai_tpu_torch.config.system import MessageStream, System
from kubeai_tpu_torch.controller.parked import LABEL_PARKED
from kubeai_tpu_torch.engine.lora import write_peft_checkpoint
from kubeai_tpu_torch.manager import Manager
from kubeai_tpu_torch.messenger import open_subscription, open_topic
from kubeai_tpu_torch.models.base import ModelConfig
from kubeai_tpu_torch.runtime.store import ObjectMeta

from _torch_operator import obs_dirs  # noqa: F401  (autouse)
from test_torch_weights import _checkpoint


@pytest.fixture(autouse=True)
def no_canary(monkeypatch):
    # A Manager's canary probes would land in the windows these tests
    # count requests and launches in: off, as before the port had one.
    monkeypatch.setenv("KUBEAI_CANARY", "0")

ARGS = ["--device", "cpu", "--max-slots", "2", "--max-seq-len", "128"]
PROMPTS = ["Hello there", "The sea is", "Once upon a time, in a land"]
PREFIX = ("You keep the harbor lights on a northern coast. Answer each question "
          "about the harbor in one short sentence. ")


def post(port, path, body, headers=None, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read())


def _jax_choices(ckpt, bodies, adapters=()):
    """The JAX engine server's choices for *bodies*: the engine built in
    process as the JAX server builds it from ``--model <dir>`` (bf16),
    with *adapters* ((name, path)) loaded through its route."""
    from kubeai_tpu.engine.server import EngineServer as JServer

    srv = JServer(jload(ckpt, JEC(max_slots=2, max_seq_len=128)), "tiny", host="127.0.0.1",
                  port=0)
    srv.start()
    try:
        for name, path in adapters:
            post(srv.port, "/v1/load_lora_adapter", {"lora_name": name, "lora_path": path})
        return [post(srv.port, "/v1/completions", b)["choices"][0] for b in bodies]
    finally:
        srv.stop()


def _same_greedy(got, want):
    """Greedy choices equal, or first different where the JAX engine's top
    two lie within 2 bf16 ulps (both serve the checkpoint in bf16)."""
    for mine, theirs in zip(got, want):
        if mine["text"] == theirs["text"]:
            continue
        a, b = mine["logprobs"]["tokens"], theirs["logprobs"]["tokens"]
        k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        top = sorted(theirs["logprobs"]["top_logprobs"][k].values(), reverse=True)
        assert top[0] - top[1] <= 2 * 2.0 ** -8 * max(1.0, abs(top[0])), (
            f"greedy text differs at step {k} with no near-tie: {mine['text']!r} "
            f"!= {theirs['text']!r}")


def _over_bus(requests_url, responses_url, bodies):
    """The choices of *bodies* published as envelopes on *requests_url*,
    read back from *responses_url* in their correlation order."""
    topic, sub = open_topic(requests_url), open_subscription(responses_url)
    for i, b in enumerate(bodies):
        topic.send(json.dumps({"metadata": {"corr": i}, "path": "/v1/completions",
                               "body": {"model": "tiny", **b}}).encode())
    out = {}
    for _ in bodies:
        msg = sub.receive(timeout=300)
        assert msg is not None, f"no response on {responses_url}"
        msg.ack()
        resp = json.loads(msg.body)
        assert resp["status_code"] == 200, resp
        out[resp["metadata"]["corr"]] = resp["body"]["choices"][0]
    assert sorted(out) == list(range(len(bodies)))
    return [out[i] for i in range(len(bodies))]


@pytest.mark.e2e
def test_operator_scales_the_port_engine_from_zero(tmp_path):
    ckpt = _checkpoint(tmp_path / "ckpt", V=300)
    bus = tmp_path / "bus"
    system = System()
    system.streams = [
        MessageStream(requests_url="mem://e2e-req", responses_url="mem://e2e-resp",
                      max_handlers=3),
        MessageStream(requests_url=f"file://{bus}/req", responses_url=f"file://{bus}/resp",
                      max_handlers=2)]
    mgr = Manager(system, local_runtime=True, host="127.0.0.1", port=0)
    mgr.start()
    procs = []
    try:
        mgr.store.create(mt.KIND_MODEL, Model(meta=ObjectMeta(name="tiny"), spec=ModelSpec(
            url=f"file://{ckpt}", engine=mt.ENGINE_TPU, resource_profile="cpu:1",
            min_replicas=0, max_replicas=2, args=ARGS, scale_down_delay_seconds=600,
            load_balancing=LoadBalancing(strategy=mt.PREFIX_HASH_STRATEGY,
                                         prefix_hash=PrefixHash()))))
        time.sleep(0.3)
        assert mgr.store.list(KIND_POD, selector={mt.LABEL_MODEL: "tiny"}) == []
        bodies = [{"prompt": p, "max_tokens": 8, "temperature": 0, "logprobs": 2}
                  for p in PROMPTS]
        got = [post(mgr.api.port, "/openai/v1/completions", {"model": "tiny", **b},
                    timeout=300)["choices"][0] for b in bodies]
        (pod,) = mgr.store.list(KIND_POD, selector={mt.LABEL_MODEL: "tiny"})
        c = pod.spec.containers[0]
        assert c.command == ["python", "-m", "kubeai_tpu_torch.engine.server"]
        assert c.args[c.args.index("--tensor-parallel-size") + 1] == "1"
        assert mgr.store.get(mt.KIND_MODEL, "tiny").spec.replicas == 1
        want = _jax_choices(ckpt, bodies)
        _same_greedy(got, want)
        # The same bodies over the two streams.
        for stream in system.streams:
            _same_greedy(_over_bus(stream.requests_url, stream.responses_url, bodies), want)
        assert mgr.store.get(mt.KIND_MODEL, "tiny").spec.replicas == 1

        # Two replicas: a shared prefix stays on one pod.
        mgr.store.mutate(mt.KIND_MODEL, "tiny", lambda m: setattr(m.spec, "replicas", 2))
        deadline = time.monotonic() + 120
        while True:
            pods = mgr.store.list(KIND_POD, selector={mt.LABEL_MODEL: "tiny"})
            if len(pods) == 2 and all(p.status.ready for p in pods) and \
                    len(mgr.lb.get_all_addresses("tiny")) == 2:
                break
            assert time.monotonic() < deadline, "the second pod never became ready"
            time.sleep(0.1)
        ports = {p.meta.name: int(p.meta.annotations[mt.ANNOTATION_MODEL_POD_PORT])
                 for p in pods}
        for i in range(8):
            post(mgr.api.port, "/openai/v1/completions",
                 {"model": "tiny", "prompt": PREFIX + f"Question {i}?", "max_tokens": 2,
                  "temperature": 0}, headers={"X-Request-ID": f"affinity-{i}"})
        served = {name: sum(bool(get(port, f"/debug/requests?id=affinity-{i}")["requests"])
                            for i in range(8)) for name, port in ports.items()}
        assert sorted(served.values()) == [0, 8], served

        procs = [mgr.local_runtime._procs[name].proc for name in ports]
        mgr.store.delete(mt.KIND_MODEL, "tiny")
        deadline = time.monotonic() + 30
        while any(p.poll() is None for p in procs):
            assert time.monotonic() < deadline, "a pod process outlived its Model"
            time.sleep(0.05)
        assert mgr.store.list(KIND_POD, selector={mt.LABEL_MODEL: "tiny"}) == []
    finally:
        mgr.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()


def _wait(cond, what, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


@pytest.mark.e2e
def test_control_loops_attach_load_adapters_and_scale_to_zero(tmp_path):
    ckpt = _checkpoint(tmp_path / "ckpt", V=300)
    adapter = str(tmp_path / "gsa")
    write_peft_checkpoint(adapter, ModelConfig(vocab_size=300, hidden_size=64,
                                               intermediate_size=128, num_layers=2,
                                               num_heads=4, num_kv_heads=2),
                          rank=4, alpha=8, seed=3, std=0.2)
    system = System()
    system.autoscaling.interval_seconds = 0.3
    system.autoscaling.time_window_seconds = 0.9
    system.parked_replicas = 1
    system.parked_args = ["--device", "cpu"]
    mgr = Manager(system, local_runtime=True, host="127.0.0.1", port=0)
    mgr.start()
    try:
        def parked_up():
            for p in mgr.store.list(KIND_POD, selector={LABEL_PARKED: "true"}):
                port = p.meta.annotations.get(mt.ANNOTATION_MODEL_POD_PORT)
                try:
                    return port and get(int(port), "/health").get("parked", False)
                except OSError:
                    pass
            return False

        _wait(parked_up, "the parked pod never served /health", timeout=120)
        mgr.store.create(mt.KIND_MODEL, Model(meta=ObjectMeta(name="tiny"), spec=ModelSpec(
            url=f"file://{ckpt}", engine=mt.ENGINE_TPU, resource_profile="cpu:1",
            min_replicas=0, max_replicas=2, target_requests=1, scale_down_delay_seconds=1,
            adapters=[Adapter(name="gsa", url=f"file://{adapter}")], args=ARGS)))
        bodies = [{"prompt": p, "max_tokens": 8, "temperature": 0, "logprobs": 2}
                  for p in PROMPTS]
        got = [post(mgr.api.port, "/openai/v1/completions", {"model": "tiny_gsa", **b},
                    timeout=300)["choices"][0] for b in bodies]
        (pod,) = mgr.store.list(KIND_POD, selector={mt.LABEL_MODEL: "tiny"})
        proc = mgr.local_runtime._procs[pod.meta.name].proc
        assert pod.meta.name.startswith("parked-") and pod.meta.labels[LABEL_PARKED] == "attached"
        assert pod.meta.labels["adapter.kubeai.org/gsa"]
        recs = get(mgr.api.port, "/debug/autoscaler?model=tiny&limit=1000")["decisions"]
        assert [r["pod"] for r in recs if r.get("action") == "parked_attach"] == [pod.meta.name]
        want = _jax_choices(ckpt, [{"model": "gsa", **b} for b in bodies],
                            adapters=[("gsa", adapter)])
        _same_greedy(got, want)
        base = _jax_choices(ckpt, bodies[:1])
        assert base[0]["text"] != want[0]["text"], "the adapter left greedy text unchanged"

        # No traffic: the autoscaler takes the Model to zero and the
        # attached process exits.
        _wait(lambda: mgr.store.get(mt.KIND_MODEL, "tiny").spec.replicas == 0,
              "the autoscaler never scaled the Model to zero", timeout=30)
        _wait(lambda: proc.poll() is not None, "the pod's process outlived replicas 0",
              timeout=30)
        recs = get(mgr.api.port, "/debug/autoscaler?model=tiny&limit=1000")["decisions"]
        assert any(r.get("applied") and r.get("applied_replicas") == 0 for r in recs)
    finally:
        procs = [h.proc for h in mgr.local_runtime._procs.values()]
        mgr.stop()
        for p in procs:
            p.wait(timeout=30)
