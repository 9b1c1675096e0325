"""The port's tensor-parallel engine against the JAX package's: llama
through the whole engine at tp = 2 (rank 0 publishing over the gang's
TCP wire to rank 1, each rank a thread with its own gloo process group
over one store): greedy tokens identical to the JAX engine at tp = 2 (a
mesh of 2 of conftest's 8 virtual CPU devices) and at tp = 1, a LoRA
adapter served at tp = 2 as the port serves it at tp = 1, and
/v1/embeddings of the gang's server within 1e-4 of tp = 1."""

import dataclasses
import json
import threading
import urllib.request

import jax
import numpy as np

from _torch_parity import assert_same_greedy
from _torch_threads import few_torch_threads  # noqa: F401
from kubeai_tpu.engine import core as jcore
from kubeai_tpu.engine.sampling import SamplingParams as JSP
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.parallel import make_mesh, shard_tree
from kubeai_tpu.parallel.sharding import llama_param_specs
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine.gang import GangFollower, GangPublisher
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models.base import ModelConfig as TMC
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.parallel.group import run_local_ranks
from kubeai_tpu_torch.parallel.sharding import shard_params

TOL = dict(rtol=1e-4, atol=1e-4)
TP = 2


def _gang_engines(tc, tparams, ec, secret="tp-test"):
    """A tp = 2 port gang in this process: rank 0's Engine (returned, not
    started) publishing to rank 1's, which replays on its own thread
    until rank 0 stops. Returns (leader, follower thread)."""
    pub = GangPublisher(TP - 1, port=0, host="127.0.0.1", secret=secret)
    box: dict = {}
    ready = threading.Event()

    def rank(group):
        eng = tcore.Engine(tc, shard_params(tparams, tc, group), ByteTokenizer(),
                           tcore.EngineConfig(**ec), device="cpu", tp_group=group,
                           publisher=pub if group.rank == 0 else None)
        if group.rank == 0:
            box["leader"] = eng
            ready.set()
            box["done"].wait()
            return None
        box["follower"] = eng
        eng.run_follower(GangFollower("127.0.0.1", pub.port, secret=secret, rank=group.rank))
        return dict(eng.follower_ops)

    box["done"] = threading.Event()
    runner = threading.Thread(
        target=lambda: box.update(result=run_local_ranks(TP, rank, "cpu", timeout=300)),
        daemon=True)
    runner.start()
    assert ready.wait(60)
    pub.accept_all(timeout=60)
    leader = box["leader"]
    real_stop = leader.stop

    def stop():
        real_stop()
        box["done"].set()
        runner.join(60)
        assert not runner.is_alive(), "the gang's ranks did not stop"

    leader.stop = stop
    leader.gang_box = box
    return leader


EC = dict(max_slots=4, max_seq_len=256, prefill_buckets=(16, 32, 64, 128))
PROMPTS = [[256] + list(b"Hello there"), [256] + [(i * 11) % 250 + 1 for i in range(150)]]


def _greedy(engine, sp_cls, prompt, n=12, adapter=None):
    kw = {"adapter": adapter} if adapter else {}
    req = engine.submit(prompt, sp_cls(temperature=0.0, max_tokens=n, logprobs=True), **kw)
    out = []
    while True:
        ev = req.out.get(timeout=120)
        if ev[0] == "token" and ev[1] >= 0:
            out.append((ev[1], ev[4]))
        elif ev[0] == "done":
            return out
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


def test_engine_greedy_lora_and_embeddings_at_tp2(tmp_path, cpu_mesh_devices):
    """llama through the whole engine: the port's tp = 2 gang against the
    JAX engine at tp = 2 and at tp = 1 (greedy tokens), an adapter served
    at tp = 2 as the port serves it at tp = 1, and /v1/embeddings of the
    gang's server within 1e-4 of tp = 1."""
    from kubeai_tpu_torch.engine.lora import write_peft_checkpoint
    from kubeai_tpu_torch.engine.server import EngineServer

    je1 = jcore.build_test_engine(jcore.EngineConfig(**EC), seed=4)
    jc = je1.model_config
    tc = TMC(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(TMC)})
    tparams = params_from_jax(jax.tree.map(np.asarray, je1.params), tc, "cpu")
    mesh = make_mesh(tp=TP)
    with mesh:
        je2 = jcore.Engine(jc, shard_tree(je1.params, llama_param_specs(jc), mesh),
                           JByteTokenizer(), jcore.EngineConfig(**EC), mesh=mesh)
    te1 = tcore.Engine(tc, tparams, ByteTokenizer(), tcore.EngineConfig(**EC), device="cpu")
    leader = _gang_engines(tc, tparams, EC)
    srv = EngineServer(leader, "gang", host="127.0.0.1", port=0)
    write_peft_checkpoint(str(tmp_path / "ad"), tc, rank=4, seed=5)
    for e in (je1, je2, te1):
        e.start()
    srv.start()
    try:
        for i, prompt in enumerate(PROMPTS):
            got = _greedy(leader, TSP, prompt)
            assert_same_greedy(got, _greedy(je1, JSP, prompt), f"tp=1 prompt {i}")
            with mesh:
                assert_same_greedy(got, _greedy(je2, JSP, prompt), f"JAX tp=2 prompt {i}")
        for e in (leader, te1):
            e.load_adapter("ad", str(tmp_path / "ad"))
        for prompt in PROMPTS:
            want = _greedy(te1, TSP, prompt, adapter="ad")
            assert_same_greedy(_greedy(leader, TSP, prompt, adapter="ad"), want, "adapter")
            assert [t for t, _ in want] != [t for t, _ in _greedy(te1, TSP, prompt)]
        inputs = ["embed me", "and me too, a little longer"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/embeddings",
            data=json.dumps({"model": "gang", "input": inputs}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.array([d["embedding"] for d in json.loads(r.read())["data"]])
        want = te1.embed([te1.tokenizer.encode(s) for s in inputs])
        np.testing.assert_allclose(got, want, **TOL)
        follower = leader.gang_box["follower"]
        assert follower.follower_ops["embed"] >= 1 and follower.loaded_adapters() == ["ad"]
    finally:
        srv.stop()
        for e in (je1, je2, te1):
            e.stop()
