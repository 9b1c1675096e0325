"""The port's pipelined scheduler on the CPU (engine/core.py: dispatch
chunk N+1, emit the admitted first tokens, then fetch and emit chunk N;
admissions merged into the next chunk on the device), against the JAX
engine, itself pipelined, on the same weights (tests/_torch_parity.py):
staggered arrivals, budgets and stop strings that end mid-chunk, G = 0
and G = 3, prefix reuse after a finish with a chunk in flight, a cancel
in flight. Greedy tokens must be identical up to the JAX run's first
near-tie. Plus: a seeded sample is the same stream alone and in a busy
batch, the device-side admission merge equals the JAX decode_fn's
rebase, and warmup leaves the engine's state as it was."""

import queue

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine.sampling import SamplingParams as JSP
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP

from _torch_parity import assert_same_greedy, parity_engines
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

# Chunks of 4 steps, so budgets and stop strings fall inside chunks.
EC = dict(max_slots=4, max_seq_len=256, prefill_buckets=(16, 64), decode_chunk=4)


@pytest.fixture(scope="module", params=[0, 3], ids=["G0", "G3"])
def engines(request):
    je, te = parity_engines(dict(EC, speculate_tokens=request.param))
    je.start()
    te.start()
    yield je, te
    je.stop()
    te.stop()


def _prompt(seed: int, n: int) -> list[int]:
    return [256] + [int(t) for t in np.random.default_rng(seed).integers(1, 250, n)]


def _greedy_sp(port: bool, **kw):
    return (TSP if port else JSP)(temperature=0.0, logprobs=True, **kw)


def _drain(req, timeout=120):
    """[(id, top)], the text and the FinishInfo of a request's events."""
    toks, text = [], []
    while True:
        ev = req.out.get(timeout=timeout)
        if ev[0] == "token":
            if ev[1] >= 0:
                toks.append((ev[1], ev[4]))
            text.append(ev[2])
        elif ev[0] == "done":
            return toks, "".join(text), ev[1]
        else:
            raise RuntimeError(ev[1])


def _wait_tokens(req, n, timeout=120):
    """Take *n* token events off a request's queue (returned, in order)."""
    got = []
    while len(got) < n:
        ev = req.out.get(timeout=timeout)
        assert ev[0] == "token", ev
        got.append(ev)
    return got


def _staggered(engine, port: bool):
    """A decodes; B arrives after A's third token, C after B's second."""
    a = engine.submit(_prompt(1, 20), _greedy_sp(port, max_tokens=30))
    head_a = _wait_tokens(a, 3)
    b = engine.submit(_prompt(2, 40), _greedy_sp(port, max_tokens=22))
    head_b = _wait_tokens(b, 2)
    c = engine.submit(_prompt(3, 9), _greedy_sp(port, max_tokens=17))
    out = []
    for req, head in ((a, head_a), (b, head_b), (c, [])):
        toks, _, fin = _drain(req)
        out.append(([(e[1], e[4]) for e in head] + toks, fin))
    return out


def test_staggered_arrivals_match_jax(engines):
    je, te = engines
    for i, ((got, fin), (ref, rfin)) in enumerate(zip(_staggered(te, True),
                                                      _staggered(je, False))):
        if assert_same_greedy(got, ref, f"request {'abc'[i]}") == len(ref):
            assert (fin.reason, fin.completion_tokens) == (rfin.reason, rfin.completion_tokens)


@pytest.mark.parametrize("max_tokens", [2, 6, 7])
def test_budget_ending_mid_chunk_matches_jax(engines, max_tokens):
    """The first token comes from the prefill, then chunks of 4: budgets
    of 2, 6 and 7 end inside a chunk, whose later steps are dropped."""
    je, te = engines
    prompt = _prompt(4, 30)
    got, _, fin = _drain(te.submit(prompt, _greedy_sp(True, max_tokens=max_tokens)))
    ref, _, rfin = _drain(je.submit(prompt, _greedy_sp(False, max_tokens=max_tokens)))
    if assert_same_greedy(got, ref, f"max_tokens={max_tokens}") == len(ref):
        assert fin.completion_tokens == rfin.completion_tokens == max_tokens
        assert fin.reason == rfin.reason == "length"


def test_stop_string_across_a_chunk_boundary_matches_jax(engines):
    """A stop string taken from the reference's own text where it spans
    the 5th and 6th tokens (chunk 1's last and chunk 2's first)."""
    je, te = engines
    prompt = [256] + list(b"Once upon a time, in a land far away, ")
    ref, _, _ = _drain(je.submit(prompt, _greedy_sp(False, max_tokens=24)))
    ids = [t for t, _ in ref]
    stop = te.tokenizer.decode(ids[4:7])
    head = te.tokenizer.decode(ids[:4])
    assert stop and head + stop == te.tokenizer.decode(ids[:7])
    got_t, got_text, fin = _drain(te.submit(prompt, TSP(temperature=0.0, max_tokens=24,
                                                        stop=(stop,))))
    ref_t, ref_text, rfin = _drain(je.submit(prompt, JSP(temperature=0.0, max_tokens=24,
                                                         stop=(stop,))))
    assert stop not in got_text and got_text == ref_text
    assert (fin.reason, fin.completion_tokens) == (rfin.reason, rfin.completion_tokens)
    assert fin.reason == "stop" and fin.completion_tokens <= 7


def _prefix_reuse(engine, port: bool):
    """A's 61-token prompt and 10 tokens fill its first 64-token page;
    its budget ends mid-chunk while B keeps decoding, so the chunk after
    it was already dispatched with A still active (its writes land past
    A's emitted tokens). Then a follow-up on A's prompt + output resumes
    from A's registered page."""
    b = engine.submit(_prompt(5, 12), _greedy_sp(port, max_tokens=40))
    _wait_tokens(b, 1)
    prompt_a = _prompt(6, 60)
    ta, _, fa = _drain(engine.submit(prompt_a, _greedy_sp(port, max_tokens=10)))
    follow = prompt_a + [t for t, _ in ta] + [7, 8, 9]
    tf, _, ff = _drain(engine.submit(follow, _greedy_sp(port, max_tokens=12)))
    _drain(b)
    return ta, fa, tf, ff


def test_prefix_reuse_after_an_in_flight_finish_matches_jax(engines):
    je, te = engines
    reuse = []
    plan = te._plan_admission

    def spy(req, taken):
        out = plan(req, taken)
        reuse.append(None if out is None else out[1])
        return out

    te._plan_admission = spy
    try:
        ta, fa, tf, ff = _prefix_reuse(te, True)
    finally:
        del te._plan_admission
    ra, rfa, rf, rff = _prefix_reuse(je, False)
    assert reuse[-1] == 64, f"the follow-up must resume from A's page: {reuse}"
    assert_same_greedy(ta, ra, "request A")
    if assert_same_greedy(tf, rf, "follow-up on A's pages") == len(rf):
        assert ff.completion_tokens == rff.completion_tokens


def test_cancel_in_flight(engines):
    """B is cancelled after its fourth token while A decodes beside it: B
    stops short of its budget with no terminal event, its slot and pages
    come back, and A's tokens are the JAX engine's."""
    je, te = engines
    pa, pb = _prompt(7, 25), _prompt(8, 25)
    a = te.submit(pa, _greedy_sp(True, max_tokens=32))
    b = te.submit(pb, _greedy_sp(True, max_tokens=96))
    _wait_tokens(b, 4)
    b.cancelled.set()
    got, _, _ = _drain(a)
    ref, _, _ = _drain(je.submit(pa, _greedy_sp(False, max_tokens=32)))
    assert_same_greedy(got, ref, "A beside a cancelled B")
    extra = []
    while True:
        try:
            extra.append(b.out.get_nowait())
        except queue.Empty:
            break
    # Only the tokens emitted before the engine saw the cancel (the rest
    # of a chunk or two), no "done", and far short of the budget.
    assert all(ev[0] == "token" for ev in extra) and 4 + len(extra) < 64, extra
    assert te.active_slots() == 0
    assert te._pool.available() == te._pool.num_pages - 1


def test_seeded_sample_is_the_same_stream_in_a_busy_batch(engines):
    _, te = engines
    prompt = _prompt(9, 18)
    sp = TSP(temperature=0.9, top_p=0.95, max_tokens=20, seed=1234)
    alone = [t for t, _ in _drain(te.submit(prompt, sp))[0]]
    others = [te.submit(_prompt(10 + i, 10 + 7 * i), _greedy_sp(True, max_tokens=24))
              for i in range(2)]
    _wait_tokens(others[0], 2)
    busy = te.submit(prompt, sp)
    late = te.submit(_prompt(20, 33), TSP(temperature=0.7, max_tokens=16, seed=5))
    assert [t for t, _ in _drain(busy)[0]] == alone
    for r in others + [late]:
        _drain(r)


def test_admission_merge_matches_jax_rebase(engines):
    """The same adm_* arrays and device state through the JAX decode
    chunk and the port's, every slot inactive: what comes out is the
    rebase alone (lengths, next tokens, history rows of admitted slots;
    the rest untouched). The JAX engine's compiled chunk takes copies
    (it donates its state); the port's chunk runs in an engine of its
    own."""
    je, _ = engines
    g = je.cfg.speculate_tokens
    te = tcore.build_test_engine(tcore.EngineConfig(**EC, speculate_tokens=g), device="cpu")
    rng = np.random.default_rng(g)
    B, W, Kb = te.cfg.max_slots, te._tok_hist.shape[1], te.cfg.max_logit_bias
    hist = rng.integers(0, 259, (B, W))
    lengths = rng.integers(0, 200, B)
    last = rng.integers(0, 259, B)
    adm_toks = rng.integers(0, 259, B)
    adm_mask = np.array([True, False, True, False])
    adm_len = rng.integers(1, 200, B)
    adm_seed = rng.integers(0, 2**32, B)
    adm_hist = rng.integers(0, 259, (B, W))
    i32, f32 = (lambda a: np.asarray(a, np.int32)), (lambda a: np.asarray(a, np.float32))
    out = je._decode_jit(
        je.params, {k: jnp.array(v) for k, v in je._cache.items()},
        np.zeros((B, je._max_pages), np.int32), jnp.asarray(i32(hist)),
        jnp.asarray(i32(lengths)), jnp.asarray(i32(last)), jnp.array(je._keys), np.zeros(B, bool),
        f32(np.ones(B)), f32(np.ones(B)), i32(np.zeros(B)), f32(np.zeros(B)), f32(np.zeros(B)),
        i32(np.zeros(B)), np.zeros((B, Kb), np.int32), np.zeros((B, Kb), np.float32),
        adm_mask, i32(adm_len), adm_seed.astype(np.uint32), jnp.asarray(i32(adm_toks)),
        **({"adm_hist": i32(adm_hist)} if g else {}),
    )
    want_hist, want_len, want_last = (np.asarray(x) for x in out[-4:-1])
    # The port's chunk over the same state.
    te._tok_hist.copy_(torch.from_numpy(hist))
    te._lengths.copy_(torch.from_numpy(lengths))
    te._last.copy_(torch.from_numpy(last))
    te._adm_toks.copy_(torch.from_numpy(adm_toks))
    te._adm_mask[:], te._adm_len[:], te._adm_seed[:] = adm_mask, adm_len, adm_seed
    if g:
        te._adm_hist[:] = adm_hist
    te._inputs.upload()
    te._chunk_body()
    np.testing.assert_array_equal(te._lengths.numpy(), want_len)
    np.testing.assert_array_equal(te._last.numpy(), want_last)
    np.testing.assert_array_equal(te._tok_hist.numpy(), want_hist)
    assert te._seeds.tolist() == [int(s) if m else 0 for s, m in zip(adm_seed, adm_mask)]
    # The merge alone, as the chunk calls it.
    h = torch.from_numpy(hist)
    ml, mt, _ = tcore.merge_admissions(
        torch.from_numpy(adm_mask), torch.from_numpy(adm_len), torch.from_numpy(adm_seed),
        torch.from_numpy(adm_toks), torch.from_numpy(adm_hist) if g else None,
        torch.from_numpy(lengths), torch.from_numpy(last), torch.zeros(B, dtype=torch.int64), h)
    np.testing.assert_array_equal(ml.numpy(), want_len)
    np.testing.assert_array_equal(mt.numpy(), want_last)
    np.testing.assert_array_equal(h.numpy(), want_hist)


def test_warmup_runs_every_shape_and_changes_no_state():
    """Warmup (before start) runs the decode chunk, cold prefill at batch
    1 and at the group cap for every bucket, a chunk prefill per bucket,
    and the restore path (imports of 1 and 2 pages, the slot set); the
    pool's bookkeeping, the slots and the decode state stay
    as they were (every write lands in the trash page), and the engine
    then serves the same greedy tokens as one that never warmed up."""
    ec = tcore.EngineConfig(**EC)
    cold = tcore.build_test_engine(ec, seed=1, device="cpu")
    warm = tcore.build_test_engine(ec, seed=1, device="cpu")
    pages_before = warm.cache["kv"].clone()
    res = warm.warmup()
    n = len(EC["prefill_buckets"])
    assert res["shapes"] == 1 + 2 * n + n + 3 and res["seconds"] >= 0
    assert warm.warmup_result == res
    P = warm._pool.num_pages
    assert warm._pool.available() == P - 1 and warm._pool.cached_pages() == 0
    assert warm._slots == [None] * ec.max_slots and warm._slot_epoch == [0] * ec.max_slots
    for t in (warm._lengths, warm._last, warm._seeds, warm._tok_hist, warm._adm_toks):
        assert not t.any()
    # Only page 0 of each layer (the trash page) was written.
    kv = warm.cache["kv"].reshape(warm.model_config.num_layers, P, *pages_before.shape[1:])
    before = pages_before.reshape(kv.shape)
    assert torch.equal(kv[:, 1:], before[:, 1:]) and not torch.equal(kv[:, 0], before[:, 0])
    for e in (cold, warm):
        e.start()
    try:
        for p in (_prompt(11, 12), _prompt(12, 80)):
            sp = TSP(temperature=0.0, max_tokens=10)
            assert warm.generate(p, sp)[0] == cold.generate(p, sp)[0]
        with pytest.raises(RuntimeError, match="before start"):
            warm.warmup()
    finally:
        for e in (cold, warm):
            e.stop()


def test_server_warmup_flag(monkeypatch):
    """--warmup defaults off unless KUBEAI_ENGINE_WARMUP=1 (the JAX
    server's default); with it the engine has warmed up before serving."""
    from kubeai_tpu_torch.engine.server import build_engine_from_args, make_arg_parser

    args = ["--model", "test:tiny", "--device", "cpu", "--max-slots", "2", "--max-seq-len", "128"]
    monkeypatch.delenv("KUBEAI_ENGINE_WARMUP", raising=False)
    assert make_arg_parser().parse_args(args).warmup is False
    monkeypatch.setenv("KUBEAI_ENGINE_WARMUP", "1")
    assert make_arg_parser().parse_args(args).warmup is True
    monkeypatch.delenv("KUBEAI_ENGINE_WARMUP")
    eng, _ = build_engine_from_args(make_arg_parser().parse_args(args + ["--warmup"]))
    assert eng.warmup_result["shapes"] == 1 + 3 * 4 + 3
    eng2, _ = build_engine_from_args(make_arg_parser().parse_args(args))
    assert eng2.warmup_result is None
