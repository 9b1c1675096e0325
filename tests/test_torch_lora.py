"""Multi-LoRA in the port (kubeai_tpu_torch.engine.lora, models/llama.py's
bank and delta, the engine and the server's adapter routes) against the
JAX package on the CPU, at tiny float32 widths:

- the bank equals the JAX AdapterRuntime's after loads, a reload, an
  unload and a load into the recycled row (PEFT checkpoints on all seven
  targets from the port's writer, and on q/v from the JAX tests' writer);
- the model's logits with mixed lora_rows (rows 0, 1, 2 in one batch)
  are within 1e-4 of the JAX package's for Llama, Qwen2 (biases), Gemma,
  Gemma2 (the gather path) and Mixtral (attention targets only), without
  a cache and through the paged step functions;
- the engine's greedy tokens with two adapters and base requests in one
  batch equal the JAX engine's at G = 0 and G = 3;
- capacity, rank, unknown-adapter and remote-source errors;
- row recycling must not alias prefix-cache pages (the JAX package's
  tests/test_prefix_cache.py::test_adapter_row_recycling_does_not_alias);
- the server's adapter routes and /v1/models answer as the JAX server's."""

import json
import queue
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import lora as jlora
from kubeai_tpu.engine.sampling import SamplingParams as JSP
from kubeai_tpu.models import llama as jl
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine import lora as tlora
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.convert import params_from_jax

from _torch_families import configs, model
from _torch_parity import assert_same_greedy, parity_engines
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from test_lora import write_peft_checkpoint as jax_write_peft

TOL = dict(rtol=1e-4, atol=1e-4)


def _same_bank(jrt, trt):
    assert set(jrt.bank) == set(trt.bank)
    for k in jrt.bank:
        np.testing.assert_array_equal(trt.bank[k].numpy(), np.asarray(jrt.bank[k]), err_msg=k)
    assert trt.names() == jrt.names()
    for name in jrt.names() + ["nope", None]:
        assert trt.row_for(name) == jrt.row_for(name)
        assert trt.row_sig(name) == jrt.row_sig(name)


def test_bank_matches_jax_runtime_through_load_reload_unload(tmp_path):
    jc, tc = configs("qwen2")
    for name, seed, rank in (("a", 1, 4), ("a2", 2, 8), ("c", 3, 2)):
        tlora.write_peft_checkpoint(str(tmp_path / name), tc, rank=rank, alpha=16, seed=seed)
    jax_write_peft(str(tmp_path / "b"), jc, rank=4, alpha=4, seed=4)
    jrt = jlora.AdapterRuntime(jc, max_adapters=3, max_rank=8)
    trt = tlora.AdapterRuntime(tc, max_adapters=3, max_rank=8)
    steps = [("load", "a", "a"), ("load", "b", "b"), ("load", "a", "a2"),  # reload
             ("unload", "a", None), ("load", "c", "c"),  # c takes a's recycled row
             ("unload", "zzz", None)]
    for op, name, src in steps:
        if op == "load":
            jrt.load(name, str(tmp_path / src))
            trt.load(name, str(tmp_path / src))
        else:
            assert trt.unload(name) == jrt.unload(name)
        _same_bank(jrt, trt)
    assert trt.row_for("c") == 1 and trt.row_sig("c") == (1, 4)


def test_reload_from_fewer_targets_equals_jax_on_all_targets(tmp_path):
    """Reloading an all-seven-target adapter from a q/v-only checkpoint:
    the scale and all seven targets equal the JAX runtime's. Both write
    only the targets the new checkpoint holds, so q and v are the new
    adapter's and the other five keep the old adapter's weights."""
    jc, tc = configs("qwen2")
    tlora.write_peft_checkpoint(str(tmp_path / "all"), tc, rank=4, alpha=8, seed=1)
    jax_write_peft(str(tmp_path / "qv"), jc, rank=2, alpha=4, seed=2)
    jrt = jlora.AdapterRuntime(jc, max_adapters=2, max_rank=8)
    trt = tlora.AdapterRuntime(tc, max_adapters=2, max_rank=8)
    for rt in (jrt, trt):
        rt.load("a", str(tmp_path / "all"))
        rt.load("a", str(tmp_path / "qv"))
    row = trt.row_for("a")
    assert row == jrt.row_for("a") == 1 and trt.row_sig("a") == jrt.row_sig("a") == (1, 2)
    np.testing.assert_array_equal(trt.bank["scale"].numpy(), np.asarray(jrt.bank["scale"]))
    assert len(tl.LORA_TARGETS) == 7
    for t in tl.LORA_TARGETS:
        for key in (t + "_A", t + "_B"):
            got, want = trt.bank[key][:, row].numpy(), np.asarray(jrt.bank[key][:, row])
            assert want.any(), key
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("x_dtype,bank_dtype", [("float32", "float32"),
                                                 ("bfloat16", "float32"),
                                                 ("bfloat16", "bfloat16")])
def test_lora_delta_matches_jax(x_dtype, bank_dtype):
    """_lora_delta computes at the promoted precision of x and the bank and
    returns x's dtype, as the JAX package's does."""
    rng = np.random.default_rng(3)
    B, S, din, dout, N, r = 3, 5, 48, 40, 4, 8
    x = rng.normal(size=(B, S, din)).astype(np.float32)
    A = rng.normal(0, 0.2, (N, din, r)).astype(np.float32)
    Bm = rng.normal(0, 0.2, (N, r, dout)).astype(np.float32)
    rows = np.array([2, 0, 3], np.int32)
    scale = np.array([0.0, 1.5, 2.0, 0.5], np.float32)
    want = jl._lora_delta(jnp.asarray(x, x_dtype), jnp.asarray(A, bank_dtype),
                          jnp.asarray(Bm, bank_dtype), jnp.asarray(rows), jnp.asarray(scale))
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    got = tl._lora_delta(torch.from_numpy(x).to(td[x_dtype]), torch.from_numpy(A).to(td[bank_dtype]),
                         torch.from_numpy(Bm).to(td[bank_dtype]), torch.from_numpy(rows),
                         torch.from_numpy(scale))
    assert got.dtype == td[x_dtype]
    tol = TOL if x_dtype == bank_dtype == "float32" else dict(rtol=2**-7, atol=2**-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    assert not got[1].any()  # row 0: no adapter


def test_apply_refuses_a_bank_of_another_dtype():
    """Nothing is refused: a float32 bank on a bfloat16 model (the
    fine-tune's) computes its delta in float32 and adds it in bf16, as the
    JAX package's _lora_delta does; the logits agree with JAX's as closely
    as the bank-free model's do, and the no-adapter row equals the model
    without a bank."""
    jc, tc, jp, _ = model("qwen2")
    jc, tc = jc.replace(dtype="bfloat16"), tc.replace(dtype="bfloat16")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    rng = np.random.default_rng(6)
    jbank = jl.init_lora_bank(jc, 3, 4, dtype=jnp.float32)
    for k in jbank:
        if k != "scale":
            jbank[k] = jnp.asarray(rng.normal(0, 0.3, jbank[k].shape).astype(np.float32))
    jbank["scale"] = jnp.asarray([0.0, 2.0, 1.0], jnp.float32)
    tbank = params_from_jax(jax.tree.map(np.asarray, jbank), tc, "cpu")
    assert tbank["wq_A"].dtype == torch.float32
    rows = np.array([1, 0, 2], np.int32)
    toks = rng.integers(1, 259, (3, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (3, 12))
    want, _ = jl.apply(jp, jc, jnp.asarray(toks), jnp.asarray(pos), lora=jbank,
                       lora_rows=jnp.asarray(rows))
    got, _ = tl.apply(tp, tc, torch.from_numpy(toks), torch.from_numpy(pos.copy()), lora=tbank,
                      lora_rows=torch.from_numpy(rows))
    want = np.asarray(want)
    base, _ = tl.apply(tp, tc, torch.from_numpy(toks), torch.from_numpy(pos.copy()))
    jbase = np.asarray(jl.apply(jp, jc, jnp.asarray(toks), jnp.asarray(pos))[0])

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    # bf16 rounds in another order in each package (~1% over two layers
    # without a bank): the bank may add no more than as much again.
    assert rel(got.numpy(), want) <= 2 * rel(base.numpy(), jbase)
    assert not np.allclose(got[0].numpy(), base[0].numpy(), atol=1e-2)  # the adapter acts
    torch.testing.assert_close(got[1], base[1], rtol=0, atol=0)  # row 0: none


def _banks(tmp_path, jc, tc):
    """(JAX bank, port bank) with adapters on rows 1 (all seven targets)
    and 2 (q/v only)."""
    tlora.write_peft_checkpoint(str(tmp_path / "a"), tc, rank=4, alpha=8, seed=1)
    jax_write_peft(str(tmp_path / "b"), jc, rank=2, alpha=4, seed=2)
    jrt = jlora.AdapterRuntime(jc, max_adapters=2, max_rank=8)
    trt = tlora.AdapterRuntime(tc, max_adapters=2, max_rank=8)
    for rt in (jrt, trt):
        rt.load("a", str(tmp_path / "a"))
        rt.load("b", str(tmp_path / "b"))
    return jrt.bank, trt.bank


@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma", "gemma2", "mixtral"])
def test_apply_with_mixed_rows_matches_jax(tmp_path, family):
    # Llama: Mixtral's config without experts.
    jc, tc, jp, tp = model("mixtral", num_experts=0) if family == "llama" else model(family)
    jbank, tbank = _banks(tmp_path, jc, tc)
    rng = np.random.default_rng(0)
    B = 3
    rows = np.array([1, 0, 2], np.int32)
    toks = rng.integers(1, 259, (B, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12))
    want, _ = jl.apply(jp, jc, jnp.asarray(toks), jnp.asarray(pos), lora=jbank,
                       lora_rows=jnp.asarray(rows))
    got, _ = tl.apply(tp, tc, torch.from_numpy(toks), torch.from_numpy(pos.copy()), lora=tbank,
                      lora_rows=torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    base, _ = tl.apply(tp, tc, torch.from_numpy(toks), torch.from_numpy(pos.copy()))
    assert not np.allclose(got[0].numpy(), base[0].numpy(), atol=1e-3)  # the adapter acts
    np.testing.assert_allclose(got[1].numpy(), base[1].numpy(), **TOL)  # row 0: none

    # The paged step functions with the kernel gates on (their plain
    # versions here): a cold prefill, then an 8-token verify step.
    flags = dict(use_flash_prefill=True, use_paged_kernel=True)
    jc, tc = jc.replace(**flags), tc.replace(**flags)
    ps, mp = 16, 4
    P = 1 + B * mp
    table = np.arange(1, P, dtype=np.int32).reshape(B, mp)
    jpool, tpool = jl.init_paged_cache(jc, P, ps), tl.init_paged_cache(tc, P, ps, "cpu")
    lens = np.array([12, 7, 12], np.int32)
    lr = dict(lora=jbank, lora_rows=jnp.asarray(rows))
    tr = dict(lora=tbank, lora_rows=torch.from_numpy(rows))
    jlog, jpool = jl.prefill_paged_cold(jp, jc, jnp.asarray(toks), jpool, jnp.asarray(table),
                                        jnp.asarray(lens), **lr)
    tlog, _ = tl.prefill_paged_cold(tp, tc, torch.from_numpy(toks), tpool,
                                    torch.from_numpy(table), torch.from_numpy(lens), **tr)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    spec = rng.integers(1, 259, (B, 8)).astype(np.int32)
    jlog, jpool = jl.decode_speculative_paged(jp, jc, jnp.asarray(spec), jpool,
                                              jnp.asarray(table), jnp.asarray(lens), **lr,
                                              decode_kernel="auto")
    tlog, _ = tl.decode_speculative_paged(tp, tc, torch.from_numpy(spec), tpool,
                                          torch.from_numpy(table), torch.from_numpy(lens), **tr,
                                          decode_kernel="auto")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tpool["kv"].numpy(), np.asarray(jpool["kv"]), **TOL)


def _greedy_batch(engine, sp_cls, jobs, n=16):
    """Submit every (prompt, adapter) job at once (one batch), then read
    each one's [(id, top)]."""
    reqs = [engine.submit(p, sp_cls(temperature=0.0, max_tokens=n, logprobs=True), adapter=a)
            for p, a in jobs]
    out = []
    for req in reqs:
        toks = []
        while True:
            ev = req.out.get(timeout=120)
            if ev[0] == "token" and ev[1] >= 0:
                toks.append((ev[1], ev[4]))
            elif ev[0] == "done":
                break
            elif ev[0] == "error":
                raise RuntimeError(ev[1])
        out.append(toks)
    return out


@pytest.mark.parametrize("G", [0, 3])
def test_engine_greedy_with_mixed_adapters_matches_jax(tmp_path, G):
    je, te = parity_engines({"max_slots": 4, "max_seq_len": 256,
                             "prefill_buckets": (16, 32, 64, 128), "speculate_tokens": G})
    for name, seed in (("a", 1), ("b", 2)):
        tlora.write_peft_checkpoint(str(tmp_path / name), te.model_config, rank=4, alpha=8,
                                    seed=seed)
    je.start()
    te.start()
    try:
        for eng in (je, te):
            eng.load_adapter("a", str(tmp_path / "a"))
            eng.load_adapter("b", f"file://{tmp_path / 'b'}")
        assert te.loaded_adapters() == je.loaded_adapters() == ["a", "b"]
        repeat = [256] + [5, 6, 7, 8] * 8  # greedy output the drafter can follow
        jobs = [([256] + list(b"Hello there"), "a"), (repeat, "b"),
                ([256] + list(b"Hello there"), None), ([256] + [(i * 11) % 250 + 1
                                                        for i in range(150)], "a")]
        want = _greedy_batch(je, JSP, jobs)
        got = _greedy_batch(te, TSP, jobs)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_greedy(g, w, f"G={G} job {i}")
        assert [t for t, _ in got[0]] != [t for t, _ in got[2]]  # adapter a acts
    finally:
        je.stop()
        te.stop()


def test_errors(tmp_path):
    te = tcore.build_test_engine(tcore.EngineConfig(max_slots=2, max_seq_len=128,
                                                    prefill_buckets=(16, 32), max_adapters=1,
                                                    max_lora_rank=8), device="cpu")
    mc = te.model_config
    tlora.write_peft_checkpoint(str(tmp_path / "a"), mc, rank=4, seed=1)
    tlora.write_peft_checkpoint(str(tmp_path / "wide"), mc, rank=16, seed=2)
    te.start()
    try:
        with pytest.raises(ValueError, match="not loaded"):
            te.submit([256, 1, 2], TSP(max_tokens=2), adapter="a")
        with pytest.raises(ValueError, match="rank 16 exceeds engine max 8"):
            te.load_adapter("wide", str(tmp_path / "wide"))
        te.load_adapter("a", str(tmp_path / "a"))
        with pytest.raises(RuntimeError, match="capacity 1 exhausted"):
            te.load_adapter("a2", str(tmp_path / "a"))
        with pytest.raises(NotImplementedError, match="item 13"):
            te.load_adapter("remote", "s3://bucket/adapter")
        with pytest.raises(FileNotFoundError):
            te.load_adapter("missing", str(tmp_path / "missing"))
        assert te.loaded_adapters() == ["a"]
        assert te.unload_adapter("a") and not te.unload_adapter("a")
        # A gang replicates the bank: each rank reads its slice of it
        # (parallel/sharding.py) as views, so a load reaches every rank.
        from kubeai_tpu_torch.parallel.sharding import shard_lora_bank

        bank = te._adapters.bank
        part = shard_lora_bank(bank, 1, 2)
        assert part["wq_B"].data_ptr() == bank["wq_B"][..., bank["wq_B"].shape[-1] // 2:].data_ptr()
        assert part["wo_A"].shape[-2] == bank["wo_A"].shape[-2] // 2
        assert part["wo_B"] is bank["wo_B"] and part["wq_A"] is bank["wq_A"]
    finally:
        te.stop()


def test_unload_while_queued_errors_the_request(tmp_path):
    """A request for an adapter unloaded while it waited for a slot fails
    at admission instead of running on the base model (JAX engine)."""
    te = tcore.build_test_engine(tcore.EngineConfig(max_slots=1, max_seq_len=128,
                                                    prefill_buckets=(16, 32)), device="cpu")
    tlora.write_peft_checkpoint(str(tmp_path / "a"), te.model_config, seed=1)
    te.load_adapter("a", str(tmp_path / "a"))
    te.start()
    try:
        busy = te.submit([256, 1, 2, 3], TSP(temperature=0.0, max_tokens=60))
        waiting = te.submit([256, 4, 5], TSP(max_tokens=4), adapter="a")
        te.unload_adapter("a")
        ev = waiting.out.get(timeout=60)
        while ev[0] == "token":
            ev = waiting.out.get(timeout=60)
        assert ev[0] == "error" and "not loaded" in ev[1]
        busy.cancelled.set()
    finally:
        te.stop()


def test_adapter_row_recycling_does_not_alias(tmp_path):
    """Unloading adapter A and loading B into the recycled row must not let
    B's requests reuse KV computed under A (the JAX package's test)."""
    ec = dict(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32, 64))

    def mk(prefix_cache_min):
        return tcore.build_test_engine(tcore.EngineConfig(**ec, prefix_cache_min=prefix_cache_min),
                                       seed=12, device="cpu")

    eng = mk(8)
    tlora.write_peft_checkpoint(str(tmp_path / "a"), eng.model_config, seed=1)
    tlora.write_peft_checkpoint(str(tmp_path / "b"), eng.model_config, seed=2)
    prompt = np.random.default_rng(5).integers(1, 200, 32).tolist()
    p = TSP(temperature=0.0, max_tokens=4)
    eng.start()
    try:
        eng.load_adapter("a", str(tmp_path / "a"))
        eng.generate(prompt, p, adapter="a")  # registers pages under a's (row, generation)
        eng.generate(prompt, p)
        eng.unload_adapter("a")
        eng.load_adapter("b", str(tmp_path / "b"))  # recycles row 1
        fresh = mk(0)
        fresh.start()
        try:
            fresh.load_adapter("b", str(tmp_path / "b"))
            want = fresh.generate(prompt, p, adapter="b")
        finally:
            fresh.stop()
        assert eng.generate(prompt, p, adapter="b")[0] == want[0]
    finally:
        eng.stop()


def test_server_adapter_routes_match_jax_server(tmp_path):
    from kubeai_tpu.engine.server import EngineServer as JServer
    from kubeai_tpu_torch.engine.server import EngineServer as TServer

    je, te = parity_engines({"max_slots": 2, "max_seq_len": 128, "prefill_buckets": (16, 32)})
    tlora.write_peft_checkpoint(str(tmp_path / "a"), te.model_config, seed=3)
    servers = [JServer(je, "tiny", host="127.0.0.1", port=0),
               TServer(te, "tiny", host="127.0.0.1", port=0)]
    for s in servers:
        s.start()

    def call(srv, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    a = str(tmp_path / "a")
    gen = {"prompt": "The sea", "max_tokens": 8, "temperature": 0}
    script = [
        ("/v1/load_lora_adapter", {"lora_name": "bad name!", "lora_path": a}),
        ("/v1/load_lora_adapter", {"lora_name": "ad1", "lora_path": a}),
        ("/v1/load_lora_adapter", {"lora_name": "ad1", "lora_path": a}),  # same path: ok
        ("/v1/load_lora_adapter", {"lora_name": "ad1", "lora_path": a + "/other"}),
        ("/v1/load_lora_adapter", {"lora_name": "gone", "lora_path": str(tmp_path / "no")}),
        ("/v1/models", None),
        ("/v1/completions", {**gen, "model": "ad1"}),
        ("/v1/completions", {**gen, "model": "tiny"}),
        ("/v1/completions", {**gen, "model": "unknown"}),
        ("/v1/unload_lora_adapter", {"lora_name": "ad1"}),
        ("/v1/unload_lora_adapter", {"lora_name": "ad1"}),
        ("/v1/models", None),
    ]
    try:
        for path, body in script:
            (jcode, jbody), (tcode, tbody) = (call(s, path, body) for s in servers)
            assert tcode == jcode, (path, body, jbody, tbody)
            if path == "/v1/completions":
                assert tbody["choices"][0]["text"] == jbody["choices"][0]["text"], body
            elif path == "/v1/models":
                assert tbody["data"] == [{k: v for k, v in m.items() if k != "created"}
                                         for m in jbody["data"]]
            elif jcode == 200:
                assert tbody == jbody, (path, body)
            else:
                assert ("already loaded" in tbody["status"]) == \
                    ("already loaded" in jbody["status"]), (tbody, jbody)
        texts = {}
        for model_name in ("ad1", "tiny"):
            call(servers[1], "/v1/load_lora_adapter", {"lora_name": "ad1", "lora_path": a})
            texts[model_name] = call(servers[1], "/v1/completions",
                                     {**gen, "model": model_name})[1]["choices"][0]["text"]
        assert texts["ad1"] != texts["tiny"]
    finally:
        for s in servers:
            s.stop()
    with pytest.raises(queue.Empty):
        te._aux.get_nowait()
