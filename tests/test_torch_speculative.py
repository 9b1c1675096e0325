"""Speculative decoding in the port (EngineConfig.speculate_tokens G > 0),
on the CPU: the port's twin of tests/test_speculative.py, plus parity
with the JAX engine on the same weights (the tiny float32 config,
converted by params_from_jax).

Greedy output at G = 3 must equal the port's own at G = 0 and the JAX
engine's at G = 3, token for token. Where the reference's top two
logprobs at a step are closer than 1e-5, float32 summation order (a
4-token verify step against a 1-token step, or PyTorch against XLA) may
legitimately pick the other token, so a comparison stops before that step
(the assertion message says how far it got)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import core as jcore
from kubeai_tpu.engine.sampling import SamplingParams as JSP
from kubeai_tpu.ops.paged_decode_attention import resolve_decode_kernel as j_resolve
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.models.base import ModelConfig
from kubeai_tpu_torch.models.convert import params_from_jax

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

TIE_GAP = 1e-5
G = 3
EC = dict(max_slots=4, max_seq_len=256, prefill_buckets=(16, 32, 64, 128), decode_chunk=4)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine at G, port at G, port at 0), one set of weights."""
    je = jcore.build_test_engine(jcore.EngineConfig(**EC, speculate_tokens=G), seed=0)
    mc = ModelConfig(**{f.name: getattr(je.model_config, f.name)
                        for f in dataclasses.fields(ModelConfig)})
    tp = params_from_jax(jax.tree.map(np.asarray, je.params), mc, "cpu")
    spec, base = (
        tcore.build_test_engine(tcore.EngineConfig(**EC, speculate_tokens=g), device="cpu",
                                params=tp, model_config=mc)
        for g in (G, 0)
    )
    for e in (je, spec, base):
        e.start()
    yield je, spec, base
    for e in (je, spec, base):
        e.stop()


def _drain(req):
    """[(id, logprob, top)] and the FinishInfo of a request's events."""
    out = []
    while True:
        ev = req.out.get(timeout=120)
        if ev[0] == "token" and ev[1] >= 0:
            out.append((ev[1], ev[3], ev[4]))
        elif ev[0] == "done":
            return out, ev[1]
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


def _run(engine, prompt, sp):
    return _drain(engine.submit(list(prompt), sp))


def _greedy(engine, prompt, n, jax_engine=False, **kw):
    cls = JSP if jax_engine else TSP
    return _run(engine, prompt, cls(temperature=0.0, max_tokens=n, logprobs=True, **kw))


def _untied(ref) -> int:
    """Steps of a greedy reference run before its first near-tie."""
    for i, (_, _, top) in enumerate(ref):
        if top and len(top) > 1 and top[0][1] - top[1][1] < TIE_GAP:
            return i
    return len(ref)


def _assert_same_tokens(got, ref, what):
    upto = _untied(ref)
    assert [t for t, _, _ in got][:upto] == [t for t, _, _ in ref][:upto], \
        f"{what}: greedy tokens differ (compared {upto} of {len(ref)} steps before a near-tie)"
    return upto


PROMPTS = {
    "short": [256] + list(b"Hello there"),
    "repetitive": [256] + list(b"abc abc abc abc abc abc abc"),
    "cycling": [256] + [1, 2, 3, 4] * 10,  # its greedy output accepts drafts early
    "bucket-crossing": [256] + [(i * 7) % 250 + 1 for i in range(40)],
    "chunked": [256] + [(i * 11) % 250 + 1 for i in range(170)],
}


@pytest.mark.parametrize("name", list(PROMPTS))
def test_greedy_identical_to_non_speculative_and_jax(engines, name):
    je, spec, base = engines
    prompt = PROMPTS[name]
    got, fin = _greedy(spec, prompt, 24)
    want, want_fin = _greedy(base, prompt, 24)
    upto = _assert_same_tokens(got, want, "G=3 against G=0")
    if upto == len(want):
        assert (fin.reason, fin.completion_tokens) == (want_fin.reason, want_fin.completion_tokens)
    ref, _ = _greedy(je, prompt, 24, jax_engine=True)
    _assert_same_tokens(got, ref, "port G=3 against the JAX engine at G=3")


def test_long_greedy_run_accepts_drafts(engines):
    """Greedy decoding of a random-weight model drifts into cycles; once
    the output repeats bigrams, drafts must be accepted, and the tokens
    still equal G = 0's."""
    _, spec, base = engines
    prompt = [int(t) for t in np.random.default_rng(0).integers(1, 200, 24)]
    d0, a0 = spec.spec_drafted, spec.spec_accepted
    got, _ = _greedy(spec, prompt, 120)
    drafted, accepted = spec.spec_drafted - d0, spec.spec_accepted - a0
    assert drafted > 0 and drafted % G == 0
    assert accepted > 0, f"0/{drafted} drafts accepted on a cycling run"
    # Each verify step emits 1 + its accepted drafts (the first token is
    # the prefill's; the last step's may be cut by the budget): fewer
    # steps than decoded tokens.
    assert len(got) - 1 - accepted <= drafted // G < len(got) - 1
    _assert_same_tokens(got, _greedy(base, prompt, 120)[0], "120-token run")


def test_sampled_requests_unaffected(engines):
    """temperature > 0 slots accept no drafts: a seeded sample is the same
    stream at G = 3 and at G = 0."""
    _, spec, base = engines
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, 200, 32)]
    sp = TSP(temperature=0.8, top_p=0.9, max_tokens=16, seed=77)
    a0 = spec.spec_accepted
    got, _ = _run(spec, prompt, sp)
    assert spec.spec_accepted == a0
    assert [t for t, _, _ in got] == [t for t, _, _ in _run(base, prompt, sp)[0]]


def test_mixed_greedy_and_sampled_slots(engines):
    """Concurrent greedy and sampled requests at G = 3 each equal their
    G = 0 twins."""
    _, spec, base = engines
    rng = np.random.default_rng(5)
    pg = TSP(temperature=0.0, max_tokens=16, logprobs=True)
    ps = TSP(temperature=0.9, max_tokens=16, seed=5)
    prompt_g = [int(t) for t in rng.integers(1, 200, 40)]
    prompt_s = [int(t) for t in rng.integers(1, 200, 40)]
    rg, rs = spec.submit(prompt_g, pg), spec.submit(prompt_s, ps)
    got_g, got_s = _drain(rg)[0], _drain(rs)[0]
    _assert_same_tokens(got_g, _run(base, prompt_g, pg)[0], "mixed: greedy slot")
    assert [t for t, _, _ in got_s] == [t for t, _, _ in _run(base, prompt_s, ps)[0]]


@pytest.mark.parametrize("name,kw", [
    ("repetitive", dict(presence_penalty=0.8, frequency_penalty=0.5,
                        logit_bias=((101, 3.0), (32, -100.0)))),
    # A bias on a token the run never picks: the tokens are the unbiased
    # run's, whose drafts a greedy slot would accept.
    ("cycling", dict(logit_bias=((258, -1.0),))),
], ids=["penalties", "bias"])
def test_penalty_and_bias_slots_accept_no_drafts(engines, name, kw):
    """Penalties and bias steer position 0 alone; such slots accept no
    drafts, and their tokens equal G = 0's and the JAX engine's."""
    je, spec, base = engines
    prompt = PROMPTS[name]
    a0 = spec.spec_accepted
    got, _ = _greedy(spec, prompt, 40, **kw)
    assert spec.spec_accepted == a0
    _assert_same_tokens(got, _greedy(base, prompt, 40, **kw)[0], "penalised G=3 against G=0")
    _assert_same_tokens(got, _greedy(je, prompt, 40, jax_engine=True, **kw)[0],
                        "penalised G=3 against the JAX engine")


def test_admission_writes_the_prompt_into_the_history():
    """At G > 0 every admission (a cold bucket, a chunked prompt, a
    shared-prefix resume) writes the prompt into the slot's history row,
    where the drafter looks bigrams up."""
    eng = tcore.build_test_engine(tcore.EngineConfig(**EC, speculate_tokens=G), device="cpu")
    eng.start()
    try:
        long = [256] + [(i * 11) % 250 + 1 for i in range(170)]
        for prompt in ([256] + list(b"Hello there"), long, long[:140] + [7, 8, 9]):
            eng.generate(prompt, TSP(temperature=0.0, max_tokens=1))  # slot 0 each time
            assert eng._tok_hist[0, : len(prompt)].tolist() == prompt
    finally:
        eng.stop()


def test_speculative_with_prefix_cache_multi_turn(engines):
    """Turn 2 resumes from turn 1's registered pages and speculates."""
    _, spec, base = engines
    rng = np.random.default_rng(8)
    turn1 = [int(t) for t in rng.integers(1, 200, 80)]
    r1, r1b = _greedy(spec, turn1, 12)[0], _greedy(base, turn1, 12)[0]
    _assert_same_tokens(r1, r1b, "turn 1")
    turn2 = turn1 + [t for t, _, _ in r1] + [int(t) for t in rng.integers(1, 200, 8)]
    _assert_same_tokens(_greedy(spec, turn2, 12)[0], _greedy(base, turn2, 12)[0], "turn 2")


def test_draft_logprobs_and_top_n_match_jax(engines):
    """Every emitted token's logprob (accepted drafts' from the verify
    positions) and its top-5 within 1e-4 of the JAX engine's at G = 3."""
    je, spec, _ = engines
    prompt = PROMPTS["cycling"]
    a0 = spec.spec_accepted
    got, _ = _greedy(spec, prompt, 40)
    ref, _ = _greedy(je, prompt, 40, jax_engine=True)
    assert spec.spec_accepted > a0, "the run must emit accepted drafts"
    upto = _assert_same_tokens(got, ref, "logprob run")
    assert upto > 0
    for (t, lp, top), (_, rlp, rtop) in zip(got[:upto], ref[:upto]):
        assert abs(lp - rlp) < 1e-4
        vals, rvals = np.array([v for _, v in top]), np.array([v for _, v in rtop])
        np.testing.assert_allclose(vals, rvals, atol=1e-4, rtol=0)
        # Ids agree wherever the reference's neighbours are apart.
        for i, (tid, rid) in enumerate(zip([k for k, _ in top], [k for k, _ in rtop])):
            near = any(abs(rvals[i] - rvals[j]) < 1e-4 for j in (i - 1, i + 1)
                       if 0 <= j < len(rvals))
            assert near or tid == rid


def _jax_ngram_drafts(g):
    """The JAX engine's own n-gram drafter (a closure of
    build_step_functions over G), rebuilt from its code object."""
    code = next(c for c in jcore.build_step_functions.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "ngram_drafts")
    return types.FunctionType(code, jcore.__dict__, None, None, (types.CellType(g),))


@pytest.mark.parametrize("g", [1, 3, 7])
def test_ngram_drafts_match_jax(g):
    """Seeded histories over a small alphabet (bigrams repeat), lengths
    from 0 to the width, including a tail too short for G drafts."""
    rng = np.random.default_rng(g)
    B, W = 16, 48
    hist = rng.integers(0, 4, (B, W))
    lengths = np.concatenate([[0, 1, 2, W - 1, W], rng.integers(0, W + 1, B - 5)])
    last = rng.integers(0, 4, B)
    want = np.asarray(_jax_ngram_drafts(g)(
        jnp.asarray(hist, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(last, jnp.int32)))
    got = tcore.ngram_drafts(torch.from_numpy(hist), torch.from_numpy(lengths),
                             torch.from_numpy(last), g).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != 0).any() and (want == 0).all(axis=1).any()


@pytest.mark.parametrize("g", [0, 3, 7, 8, 12])
def test_auto_decode_kernel_resolves_with_verify_length(g):
    """--decode-kernel auto resolves with 1 + speculate_tokens queries per
    slot, as the JAX engine does: dedicated up to G = 7, ragged above."""
    eng = tcore.build_test_engine(
        tcore.EngineConfig(**EC, speculate_tokens=g, decode_kernel="auto"), device="cpu")
    assert eng.decode_kernel == j_resolve("auto", 1 + g)
    assert eng.decode_kernel == ("dedicated" if g <= 7 else "ragged")


def test_server_flag_serves_speculative_completions():
    """--speculate-tokens (default 0) reaches EngineConfig; the OpenAI
    server answers with the greedy text of the same weights at G = 0,
    streamed and not."""
    import json
    import urllib.request

    from kubeai_tpu_torch.engine.server import EngineServer, build_engine_from_args, make_arg_parser

    base_args = ["--model", "test:tiny", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
                 "--max-slots", "2", "--max-seq-len", "256"]
    assert make_arg_parser().parse_args(base_args).speculate_tokens == 0
    eng, name = build_engine_from_args(
        make_arg_parser().parse_args(base_args + ["--speculate-tokens", "3"]))
    assert eng.cfg.speculate_tokens == 3
    base = tcore.Engine(eng.model_config, eng.params, eng.tokenizer,
                        dataclasses.replace(eng.cfg, speculate_tokens=0), device="cpu")
    srv = EngineServer(eng, name, host="127.0.0.1", port=0)
    srv.start()
    base.start()
    try:
        body = {"prompt": "one two one two one two", "max_tokens": 24, "temperature": 0}

        def call(b):
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/completions",
                                         data=json.dumps(b).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read().decode()

        _, text, fin = base.generate(eng.tokenizer.encode(body["prompt"]),
                                     TSP(temperature=0.0, max_tokens=24))
        resp = json.loads(call(body))
        assert resp["choices"][0]["text"] == text
        assert resp["usage"]["completion_tokens"] == fin.completion_tokens
        events = [line[6:] for line in call({**body, "stream": True}).splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        assert "".join(json.loads(e)["choices"][0]["text"] for e in events) == text
    finally:
        srv.stop()
        base.stop()
