"""The port's embeddings against the JAX package's, on the CPU.

- ``models/llama.py::apply(return_hidden=True)``: the final-norm hidden
  states of test:tiny's config and of a Gemma2 config (post norms,
  softcaps, a window of 8 on even layers: tests/_torch_families.py)
  equal the JAX package's within 1e-4 (float32 over two layers).
- ``Engine.embed`` against the JAX engine's on one set of weights
  (tests/_torch_parity.py): ragged lengths, more prompts than
  ``max_slots``, one-token inputs, the largest bucket; within 1e-5, and
  unit norm.
- tests/test_embeddings.py's five cases against the port's server and
  engine, the test under decode load included (embeds from the running
  loop equal the idle direct path, rtol 2e-5, while six greedy
  generations run and finish).
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.models import llama as jl
from kubeai_tpu_torch.engine.core import build_test_engine
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.models import llama as tl

import _torch_families as fam
from _torch_parity import parity_engines
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


def _tiny():
    """test:tiny's config and weights, both packages (the JAX engine's
    own, converted)."""
    je, te = parity_engines()
    return je.model_config, te.model_config, je.params, te.params


@pytest.mark.parametrize("which", ["tiny", "gemma2"])
def test_return_hidden_matches_jax(which):
    jc, tc, jp, tp = _tiny() if which == "tiny" else fam.model("gemma2")
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 259, (3, 40)).astype(np.int32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (3, 40))
    want, _ = jl.apply(jp, jc, jnp.asarray(toks), jnp.asarray(pos), return_hidden=True)
    got, cache = tl.apply(tp, tc, torch.from_numpy(toks), torch.from_numpy(pos.copy()),
                          return_hidden=True)
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (3, 40, tc.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_engine_embed_matches_jax_engine():
    je, te = parity_engines()
    rng = np.random.default_rng(4)
    # 9 prompts over groups of max_slots = 4: ragged lengths, one-token
    # inputs, and one at the largest bucket (128).
    lengths = [1, 5, 17, 1, 33, 64, 100, 128, 2]
    prompts = [[int(t) for t in rng.integers(1, 259, n)] for n in lengths]
    want = je.embed(prompts)
    got = te.embed(prompts)
    assert got.shape == want.shape == (9, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="too long"):
        te.embed([[1] * 129])


@pytest.fixture(scope="module")
def server():
    srv = EngineServer(build_test_engine(device="cpu"), "embedder", host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.stop()


def post(srv, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/embeddings", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_single_and_batch(server):
    status, body = post(server, {"model": "embedder", "input": "hello world"})
    assert status == 200
    assert len(body["data"]) == 1
    v = np.asarray(body["data"][0]["embedding"])
    assert v.shape == (128,)  # hidden size of the test model
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-5)
    assert body["usage"] == {"prompt_tokens": 12, "total_tokens": 12}  # BOS + 11 bytes

    status, body = post(server, {"model": "embedder", "input": ["a", "b", "c", "d", "e"]})
    assert status == 200
    assert [d["index"] for d in body["data"]] == [0, 1, 2, 3, 4]
    # A batch of token arrays and one token array are the same inputs
    # (the byte tokenizer's BOS, then the byte).
    _, toks = post(server, {"model": "embedder", "input": [[256, 97], [256, 98]]})
    _, one = post(server, {"model": "embedder", "input": [256, 97]})
    np.testing.assert_array_equal(toks["data"][0]["embedding"], body["data"][0]["embedding"])
    np.testing.assert_array_equal(one["data"][0]["embedding"], body["data"][0]["embedding"])


def test_deterministic_and_input_sensitive(server):
    _, b1 = post(server, {"model": "embedder", "input": "same text"})
    _, b2 = post(server, {"model": "embedder", "input": "same text"})
    _, b3 = post(server, {"model": "embedder", "input": "different text"})
    v1 = np.asarray(b1["data"][0]["embedding"])
    v2 = np.asarray(b2["data"][0]["embedding"])
    v3 = np.asarray(b3["data"][0]["embedding"])
    np.testing.assert_allclose(v1, v2)
    assert np.abs(v1 - v3).max() > 1e-4


def test_base64_format(server):
    _, fb = post(server, {"model": "embedder", "input": "x"})
    _, bb = post(server, {"model": "embedder", "input": "x", "encoding_format": "base64"})
    decoded = np.frombuffer(base64.b64decode(bb["data"][0]["embedding"]), "<f4")
    np.testing.assert_allclose(decoded, fb["data"][0]["embedding"], rtol=1e-6)


def test_validation(server):
    assert post(server, {"model": "m"})[0] == 400
    assert post(server, {"model": "m", "input": []})[0] == 400
    assert post(server, {"model": "m", "input": "x" * 100_000})[0] == 400
    assert post(server, {"model": "m", "input": [[1], []]})[0] == 400
    assert post(server, {"model": "m", "input": [1.5]})[0] == 400


def test_embed_under_decode_load():
    """Embeds dispatched by the scheduler thread between decode chunks
    (Engine._run_aux) complete under concurrent generation, equal the
    idle engine's direct results, and do not disturb the generations."""
    eng = build_test_engine(device="cpu")
    baseline = eng.embed([[1, 2, 3], [7, 8, 9, 10]])  # direct: the loop is not running
    eng.start()
    try:
        results = {}

        def gen(i):
            results[i] = eng.generate(
                list(range(1, 20)), SamplingParams(temperature=0.0, max_tokens=32),
                timeout=300)

        threads = [threading.Thread(target=gen, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        embeds = [eng.embed([[1, 2, 3], [7, 8, 9, 10]]) for _ in range(4)]
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        for e in embeds:
            np.testing.assert_allclose(e, baseline, rtol=2e-5, atol=2e-6)
        assert len(results) == 6
        for ids, _, fin in results.values():
            assert fin.completion_tokens >= 1
    finally:
        eng.stop()
