"""End to end on the CPU: the port's engine and server against the JAX
engine on the same weights (kubeai_tpu.engine.core.build_test_engine's,
converted by params_from_jax: tests/_torch_parity.py), plus the port's
device rule and its freedom from JAX.

Greedy completions must be token-identical. Where the JAX engine's top
two logprobs at a step are closer than 1e-5, float32 summation order may
legitimately pick the other token, so the comparison stops before that
step (and the test says so in its assertion message)."""

import json
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from kubeai_tpu.engine.sampling import SamplingParams as JSP
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP

from _torch_parity import TIE_GAP, parity_engines
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def engines():
    je, te = parity_engines()
    je.start()
    te.start()
    yield je, te
    je.stop()
    te.stop()


def _events(engine, prompt, params):
    req = engine.submit(prompt, params)
    toks = []
    while True:
        ev = req.out.get(timeout=120)
        if ev[0] == "token" and ev[1] >= 0:
            toks.append((ev[1], ev[4]))
        elif ev[0] == "done":
            return toks, ev[1]
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


def _assert_same_greedy(je, te, prompt, n=24, **kw):
    jt, jfin = _events(je, prompt, JSP(temperature=0.0, max_tokens=n, logprobs=True, **kw))
    tt, tfin = _events(te, prompt, TSP(temperature=0.0, max_tokens=n, logprobs=True, **kw))
    upto = len(jt)
    for i, (_, top) in enumerate(jt):
        if top and len(top) > 1 and top[0][1] - top[1][1] < TIE_GAP:
            upto = i
            break
    j_ids = [t for t, _ in jt][:upto]
    t_ids = [t for t, _ in tt][:upto]
    assert t_ids == j_ids, f"greedy tokens differ (compared {upto} steps before a near-tie)"
    if upto == len(jt):
        assert (tfin.reason, tfin.completion_tokens) == (jfin.reason, jfin.completion_tokens)


@pytest.mark.parametrize(
    "prompt",
    [
        [256] + list(b"Hello there"),  # short: bucket 16
        [256] + [(i * 7) % 250 + 1 for i in range(40)],  # crosses 16 and 32: bucket 64
        [256] + [(i * 11) % 250 + 1 for i in range(170)],  # > largest bucket: chunked
    ],
    ids=["short", "bucket-crossing", "chunked"],
)
def test_greedy_tokens_match_jax_engine(engines, prompt):
    _assert_same_greedy(*engines, prompt)


def test_shared_prefix_reuse_matches_jax_engine(engines):
    je, te = engines
    base = [256] + [(i * 13) % 250 + 1 for i in range(100)]
    _assert_same_greedy(je, te, base, n=8)
    # Shares the first full page (64 tokens) with `base`: both engines
    # resume from the cached page through the chunked path.
    _assert_same_greedy(je, te, base[:80] + [9, 8, 7, 6], n=16)


def test_penalties_and_bias_match_jax_engine(engines):
    _assert_same_greedy(
        *engines, [256] + list(b"repeat repeat repeat"), n=20,
        presence_penalty=0.8, frequency_penalty=0.5, logit_bias=((101, 3.0), (32, -100.0)),
    )


def test_vocab_256_config_serves_bos_like_jax_engine():
    """The JAX package's vocab-256 test configuration (its tiny checkpoint's:
    hidden 64, 2 layers) with the byte tokenizer, whose BOS is 256: the
    embedding gather clamps that id to row 255 in both engines, and the
    port serves the JAX engine's greedy tokens on the same weights."""
    from kubeai_tpu.models.base import ModelConfig as JMC

    jmc = JMC(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=4, num_kv_heads=2, dtype="float32")
    ec = dict(max_slots=2, max_seq_len=128, prefill_buckets=(16, 32))
    je, te = parity_engines(ec, seed=3, jax_model_config=jmc)
    je.start()
    te.start()
    try:
        _assert_same_greedy(je, te, [256] + list(b"vocab 256"), n=12)
    finally:
        je.stop()
        te.stop()


def test_seeded_sampling_is_reproducible(engines):
    _, te = engines
    sp = TSP(temperature=0.9, top_p=0.95, max_tokens=12, seed=42)
    a = te.generate([256, 10, 20, 30], sp)[0]
    b = te.generate([256, 10, 20, 30], sp)[0]
    assert a == b and len(a) >= 1


def test_http_server_matches_jax_engine(engines):
    from kubeai_tpu_torch.engine.server import EngineServer

    je, te = engines
    srv = EngineServer(te, "tiny", host="127.0.0.1", port=0)
    srv.start()

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read().decode()

    try:
        assert json.loads(call("/health"))["status"] == "ok"
        assert json.loads(call("/v1/models"))["data"][0]["id"] == "tiny"
        body = {"prompt": "The sea", "max_tokens": 10, "temperature": 0, "logprobs": 2}
        resp = json.loads(call("/v1/completions", body))
        ch = resp["choices"][0]
        ids, text, fin = je.generate([256] + list(b"The sea"), JSP(temperature=0.0, max_tokens=10))
        assert ch["text"] == text and ch["finish_reason"] == fin.reason
        assert resp["usage"] == {"prompt_tokens": 8, "completion_tokens": fin.completion_tokens,
                                 "total_tokens": 8 + fin.completion_tokens}
        lp = ch["logprobs"]
        assert len(lp["tokens"]) == len(lp["token_logprobs"]) == len(lp["top_logprobs"])
        chat = json.loads(call("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "temperature": 0, "logprobs": True, "top_logprobs": 1}))
        assert chat["object"] == "chat.completion"
        assert chat["choices"][0]["message"]["role"] == "assistant"
        stream = call("/v1/completions", {**body, "stream": True,
                                          "stream_options": {"include_usage": True}})
        events = [line[6:] for line in stream.splitlines() if line.startswith("data: ")]
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        assert "".join(c["choices"][0]["text"] for c in chunks if c["choices"]) == text
        assert chunks[-1]["usage"]["completion_tokens"] == fin.completion_tokens
        with pytest.raises(urllib.error.HTTPError) as e:
            call("/v1/completions", {"prompt": "x", "max_tokens": 0})
        assert e.value.code == 400
    finally:
        srv.stop()


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a device argument an entry point runs on CUDA, and raises
    where there is none: nothing falls back to the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.build_test_engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.build_engine("llama-3.1-8b")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kubeai_tpu_torch\n"
        "for m in pkgutil.walk_packages(kubeai_tpu_torch.__path__, 'kubeai_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'kubeai_tpu.'))"
        " or m in ('kubeai_tpu', 'safetensors', 'transformers')]\n"
        "new = ['kubeai_tpu_torch.ops.quant', 'kubeai_tpu_torch.engine.weights']\n"
        "bad += [m for m in new if m not in sys.modules]\n"
        "print(len([m for m in sys.modules if m.startswith('kubeai_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 18  # every module really imported


def test_page_pool_copy_matches_jax():
    from kubeai_tpu.engine.paging import PagePool as JPool
    from kubeai_tpu_torch.engine.paging import PagePool as TPool

    rng = np.random.default_rng(0)
    pools = [JPool(12, 4), TPool(12, 4)]
    held: list = [[], []]
    for step in range(60):
        ids = [int(x) for x in rng.integers(0, 3, 9)]
        outs = []
        for k, pool in enumerate(pools):
            claimed = pool.match_prefix(ids, (0, 0))
            need = 3 - len(claimed)
            if need <= pool.available():
                row = claimed + pool.allocate(need)
                pool.register_chain(ids, (0, 0), row)
                held[k].append(row)
            else:
                pool.release(claimed)
            if held[k] and step % 3 == 0:
                pool.release(held[k].pop(0))
            outs.append((claimed, pool.available(), pool.used(), pool.cached_pages()))
        assert outs[0] == outs[1]


def test_failed_prefill_errors_its_request_and_the_engine_serves_on(monkeypatch):
    eng = tcore.build_test_engine(device="cpu")
    real = tcore.llama.prefill_paged_cold
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected prefill fault")
        return real(*a, **kw)

    monkeypatch.setattr(tcore.llama, "prefill_paged_cold", flaky)
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="prefill failed"):
            eng.generate([256, 1, 2, 3], TSP(temperature=0.0, max_tokens=4), timeout=60)
        assert eng._pool.available() == eng._pool.num_pages - 1  # its pages came back
        ids, _, fin = eng.generate([256, 1, 2, 3], TSP(temperature=0.0, max_tokens=4), timeout=60)
        assert fin.completion_tokens >= 1 and eng.is_ready()
    finally:
        eng.stop()
