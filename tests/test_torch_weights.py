"""The port's checkpoint loader (kubeai_tpu_torch.engine.weights) against
the JAX package's (kubeai_tpu.engine.weights), on the CPU:

- its safetensors reader reads the safetensors package's files exactly,
  and the package reads its writer's files exactly (only this test
  imports safetensors: the card's machine has none);
- stream_params_from_hf equals the JAX one leaf for leaf, bf16 and
  float32, with and without int8, untied, tied (no lm_head.weight) and
  with a vocab that needs padding;
- load_engine_from_path(..., quantization="int8") gives the JAX engine's
  greedy tokens (test_torch_engine.py's near-tie rule), and so does the
  server started with --model <dir> --quantization int8;
- tp = 2 and an unknown quantization raise; a directory with a
  tokenizer.json serves it, and a malformed one raises;
- each model family (Qwen2, Gemma, Gemma2, Mixtral) round-trips: the
  port's save_hf_checkpoint then --model <dir>, bf16 and int8, equals the
  JAX package's params_from_hf of the same state dict.

Checkpoints have save_tiny_test_checkpoint's names and shapes (vocab 256,
hidden 64, 2 layers, 4 heads, 2 KV heads) with seeded numpy weights,
written by the JAX package's save_hf_checkpoint: transformers' import
alone would take most of this file's time budget."""

import dataclasses
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from kubeai_tpu.engine import weights as jw
from kubeai_tpu.engine.core import EngineConfig as JEC
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu_torch.engine import weights as tw
from kubeai_tpu_torch.engine.core import EngineConfig as TEC
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.engine.server import EngineServer, build_engine_from_args, make_arg_parser
from kubeai_tpu_torch.models.base import ModelConfig as TMC

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from test_torch_engine import _assert_same_greedy


def _state_dict(V=256, D=64, F=128, L=2, H=4, Kv=2, tied=False, seed=0):
    rng = np.random.default_rng(seed)
    h = D // H

    def w(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, D, scale=1.0), "model.norm.weight": 1 + w(D)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": 1 + w(D), p + "post_attention_layernorm.weight": 1 + w(D),
            p + "self_attn.q_proj.weight": w(H * h, D), p + "self_attn.k_proj.weight": w(Kv * h, D),
            p + "self_attn.v_proj.weight": w(Kv * h, D), p + "self_attn.o_proj.weight": w(D, H * h),
            p + "mlp.gate_proj.weight": w(F, D), p + "mlp.up_proj.weight": w(F, D),
            p + "mlp.down_proj.weight": w(D, F),
        })
    if not tied:
        sd["lm_head.weight"] = w(V, D)
    return sd


def _checkpoint(path, V=256, tied=False, seed=0):
    cfg = JMC(vocab_size=V, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
              num_kv_heads=2, dtype="float32", tie_word_embeddings=tied)
    jw.save_hf_checkpoint(str(path), cfg, _state_dict(V=V, tied=tied, seed=seed))
    return str(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    # Vocab 300 (padded to 384): room for the byte tokenizer's specials.
    return _checkpoint(tmp_path_factory.mktemp("ck") / "tiny", V=300)


def test_reader_reads_safetensors_files_exactly(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn((5, 7), generator=g),
        "bf16": torch.randn((3, 4, 6), generator=g).to(torch.bfloat16),
        "f16": torch.randn((9,), generator=g).to(torch.float16),
        "i8": torch.randint(-128, 128, (4, 33), generator=g, dtype=torch.int8),
        "scalar": torch.tensor(3.5),
    }
    path = str(tmp_path / "a.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    src = tw.SafetensorsSource(str(tmp_path))
    assert set(src.names()) == set(tensors) and "f32" in src and "nope" not in src
    for name, t in tensors.items():
        got = src.get(name)
        assert got.dtype == t.dtype and got.shape == t.shape and torch.equal(got, t), name


def test_writer_files_read_back_by_safetensors(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {
        "f32": torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32)),
        "bf16": torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32)).to(torch.bfloat16),
        "i8": torch.from_numpy(rng.integers(-127, 128, (3, 17)).astype(np.int8)),
        "np_f32": rng.normal(size=(4,)).astype(np.float32),
    }
    path = str(tmp_path / "b.safetensors")
    tw.save_safetensors(tensors, path)
    with safe_open(path, framework="pt") as f:
        assert set(f.keys()) == set(tensors)
        for name, t in tensors.items():
            want = t if isinstance(t, torch.Tensor) else torch.from_numpy(t)
            got = f.get_tensor(name)
            assert got.dtype == want.dtype and torch.equal(got, want), name
    # and the port's own reader agrees
    src = tw.SafetensorsSource(str(tmp_path))
    assert torch.equal(src.get("bf16"), tensors["bf16"])


def _same_tree(jtree, ttree):
    """Leaf for leaf equality of a JAX tree and the port's, values compared
    in float32 (bf16 exactly) and int8 as is."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        t = ttree
        for p in path:
            t = t[p.key]
        a = np.asarray(leaf)
        a = a if a.dtype == np.int8 else a.astype(np.float32)
        b = t.numpy() if t.dtype == torch.int8 else t.float().numpy()
        assert a.shape == b.shape and np.array_equal(a, b), jax.tree_util.keystr(path)
    n = len(jax.tree_util.tree_leaves(jtree))
    assert n == len(jax.tree_util.tree_leaves(jax.tree.map(lambda x: 0, ttree)))


@pytest.mark.parametrize("quantization", ["", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["tiny", "tied", "padded"])
def test_stream_params_match_jax(tmp_path, quantization, dtype, kind):
    V, tied = {"tiny": (256, False), "tied": (256, True), "padded": (300, False)}[kind]
    path = _checkpoint(tmp_path / kind, V=V, tied=tied, seed=len(kind))
    jc = JMC.from_json_file(path).replace(dtype=dtype)
    tc = TMC.from_json_file(path).replace(dtype=dtype)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jp, jcfg = jw.stream_params_from_hf(jw.SafetensorsSource(path), jc, quantization=quantization)
    tp, tcfg = tw.stream_params_from_hf(tw.SafetensorsSource(path), tc, quantization=quantization,
                                        device="cpu")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.vocab_size == (384 if kind == "padded" else 256)
    assert ("lm_head" in tp) == (not tied)
    _same_tree(jp, tp)


def test_pad_vocab_matches_jax():
    rng = np.random.default_rng(3)
    params = {"embed": rng.normal(size=(300, 8)).astype(np.float32),
              "lm_head": rng.normal(size=(8, 300)).astype(np.float32), "layers": {}}
    jc = JMC(vocab_size=300, hidden_size=8)
    tc = TMC(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(JMC)})
    jp, jcfg = jw.pad_vocab(params, jc, 128)
    tp, tcfg = tw.pad_vocab({k: torch.from_numpy(v) if k != "layers" else v
                             for k, v in params.items()}, tc, 128)
    assert jcfg.vocab_size == tcfg.vocab_size == tw.padded_vocab_size(300) == 384
    for k in ("embed", "lm_head"):
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_state_dict_source_matches_safetensors_source(ckpt):
    """A pytorch_model.bin checkpoint goes through the same streaming path
    as a name -> tensor dict."""
    tc = TMC.from_json_file(ckpt)
    sd = tw.load_state_dict(ckpt)
    a, _ = tw.stream_params_from_hf(sd, tc, quantization="int8", device="cpu")
    b, _ = tw.stream_params_from_hf(tw.SafetensorsSource(ckpt), tc, quantization="int8",
                                    device="cpu")
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_load_state_dict_reads_pytorch_bin(tmp_path):
    sd = {"a": torch.randn(3, 4), "b": torch.randn(5).to(torch.bfloat16)}
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    got = tw.load_state_dict(str(tmp_path))
    assert set(got) == {"a", "b"} and all(torch.equal(got[k], sd[k]) for k in sd)


ENGINE = dict(max_slots=4, max_seq_len=256, prefill_buckets=(16, 32, 64, 128))


@pytest.fixture(scope="module")
def int8_engines(ckpt):
    je = jw.load_engine_from_path(ckpt, JEC(**ENGINE), dtype="float32", quantization="int8")
    te = tw.load_engine_from_path(ckpt, TEC(**ENGINE), dtype="float32", quantization="int8",
                                  device="cpu")
    assert te.model_config.tie_word_embeddings is False and "lm_head" in te.params
    je.start()
    te.start()
    yield je, te
    je.stop()
    te.stop()


@pytest.mark.parametrize(
    "prompt",
    [[256] + list(b"Hello there"), [256] + [(i * 11) % 250 + 1 for i in range(170)]],
    ids=["short", "chunked"],
)
def test_int8_checkpoint_greedy_matches_jax_engine(int8_engines, prompt):
    _assert_same_greedy(*int8_engines, prompt, n=16)


def test_server_serves_int8_checkpoint(ckpt, int8_engines):
    _, te = int8_engines
    args = make_arg_parser().parse_args([
        "--model", ckpt, "--quantization", "int8", "--device", "cpu", "--max-slots", "2",
        "--max-seq-len", "128",
    ])
    eng, name = build_engine_from_args(args)
    assert eng.model_config.dtype == "bfloat16" and "int8_q" in eng.params["layers"]["wq"]
    srv = EngineServer(eng, name, host="127.0.0.1", port=0)
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps({"prompt": "hi", "max_tokens": 6, "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        srv.stop()
    assert body["model"] == ckpt and body["usage"]["completion_tokens"] >= 1
    # The same weights loaded directly give the same greedy text.
    direct = tw.load_engine_from_path(ckpt, TEC(max_slots=2, max_seq_len=128),
                                      quantization="int8", device="cpu")
    direct.start()
    try:
        _, text, _ = direct.generate([256] + list(b"hi"), TSP(temperature=0.0, max_tokens=6))
    finally:
        direct.stop()
    assert body["choices"][0]["text"] == text


def test_loader_refusals(ckpt, tmp_path):
    with pytest.raises(ValueError, match="tensor-parallel"):
        tw.load_engine_from_path("/nonexistent", tp=2, quantization="int8", device="cpu")
    with pytest.raises(ValueError, match="needs a tp group of 2 ranks"):
        tw.load_engine_from_path(ckpt, tp=2, device="cpu")
    with pytest.raises(ValueError, match="unsupported quantization"):
        tw.load_engine_from_path(ckpt, quantization="int4", device="cpu")
    # A valid tokenizer.json is the engine's tokenizer; a malformed one raises.
    with_tok = tmp_path / "with_tok"
    _checkpoint(with_tok)
    (with_tok / "tokenizer.json").write_text(json.dumps({"model": {
        "type": "BPE", "vocab": {"a": 0, "b": 1, "ab": 2, "<s>": 3}, "merges": ["a b"]},
        "added_tokens": [{"id": 3, "content": "<s>", "special": True}]}))
    (with_tok / "tokenizer_config.json").write_text(json.dumps({"bos_token": "<s>"}))
    eng = tw.load_engine_from_path(str(with_tok), device="cpu")
    assert type(eng.tokenizer).__name__ == "HFTokenizer"
    assert eng.tokenizer.encode("abab") == [3, 2, 2] and eng.n_valid_vocab == 4
    (with_tok / "tokenizer.json").write_text("{}")
    with pytest.raises(ValueError, match="no model"):
        tw.load_engine_from_path(str(with_tok), device="cpu")
    os.remove(with_tok / "tokenizer.json")
    os.remove(with_tok / "tokenizer_config.json")
    assert type(tw.load_tokenizer(str(with_tok))).__name__ == "ByteTokenizer"
    # tp > 1 parses (the server starts the ranks); the JAX server's gang
    # refusals are parser errors.
    assert make_arg_parser().parse_args(
        ["--model", ckpt, "--tensor-parallel-size", "2"]).tensor_parallel_size == 2
    from kubeai_tpu_torch.engine.server import main as server_main

    for bad in (["--model", ckpt, "--tensor-parallel-size", "0"],
                ["--model", ckpt, "--tensor-parallel-size", "2", "--parked"],
                ["--model", "test:tiny", "--tensor-parallel-size", "2", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            server_main(bad)


@pytest.mark.parametrize("quantization", ["", "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("family", ["qwen2", "gemma", "gemma2", "mixtral"])
def test_family_checkpoint_round_trip_matches_jax(tmp_path, family, quantization):
    """Each family's weights written by the port's save_hf_checkpoint (HF
    names from hf_state_dict: Qwen2's biases, Gemma2's four norms,
    Mixtral's router and experts, no lm_head when tied) and served by
    --model <dir> equal the JAX package's params_from_hf of the same
    state dict (vocab padded, int8-quantized as its loader does: experts
    and router stay full precision), through params_from_jax."""
    import _torch_families as fam
    from kubeai_tpu.models import llama as jl
    from kubeai_tpu_torch.models.convert import params_from_jax

    _, tc, _, tp = fam.model(family)
    path = str(tmp_path / family)
    sd = tw.hf_state_dict(tp, tc)
    assert ("lm_head.weight" in sd) == (not tc.tie_word_embeddings)
    tw.save_hf_checkpoint(path, tc, sd)
    argv = ["--model", path, "--device", "cpu", "--max-slots", "2", "--max-seq-len", "128"]
    eng, _ = build_engine_from_args(make_arg_parser().parse_args(
        argv + (["--quantization", quantization] if quantization else [])))
    jc = JMC.from_json_file(path).replace(dtype="bfloat16")
    assert dataclasses.asdict(jc) == dataclasses.asdict(
        tc.replace(dtype="bfloat16", tie_word_embeddings=jc.tie_word_embeddings))
    jp = jl.params_from_hf({k: v.numpy() for k, v in sd.items()}, jc, to_device=False)
    jp, jc = jw.pad_vocab(jp, jc, 128)
    if quantization:
        jp = jw.quantize_model_params(jp, jc)
    want = params_from_jax(jax.tree.map(np.asarray, jp), TMC(**dataclasses.asdict(jc)), "cpu")
    assert eng.model_config.vocab_size == jc.vocab_size == 384
    la = jax.tree_util.tree_leaves_with_path(want)
    lb = jax.tree_util.tree_leaves_with_path(eng.params)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, a), (_, b) in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a, b), jax.tree_util.keystr(p)
    if family == "mixtral" and quantization:
        assert eng.params["layers"]["wg"].dtype == torch.bfloat16  # experts stay bf16
