"""LoRA fine-tuning in the port (kubeai_tpu_torch.train.finetune, and the
LoRA delta of models/llama.py under autograd) against the JAX package's
kubeai_tpu.train.finetune on the CPU, over one tiny checkpoint (2
layers, width 64, vocab 300: not a multiple of the engine's 128-wide
padding) written by the port's save_hf_checkpoint:

- load_dataset and make_batch give JAX's arrays, draw for draw;
- the loss and the bank's gradient against jax.value_and_grad of the JAX
  fine-tune's loss on the same bank and batch: a float32 model (rtol
  1e-5) and the fine-tune's own bf16 base with a float32 bank (loss
  within 2 bf16 ulps, gradient within 1e-2 relative L2);
- torch AdamW against optax.adamw on the same gradients (the fine-tune's
  weight decay 1e-4 and the trainer's 0), and five steps of the port's
  loop against JAX's jitted step from one bank and one batch stream;
- save_peft_adapter writes JAX's file, read back by the safetensors
  package;
- the CLI (--device cpu) lowers the loss, and its adapter changes a port
  engine's greedy output and gives the JAX engine the same tokens;
- a run resumed from its checkpoint equals an uninterrupted one; an
  orbax-looking .ckpt is refused;
- the two forms of _lora_add (out= for serving, none under autograd)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeai_tpu.engine import core as jcore
from kubeai_tpu.engine import weights as jweights
from kubeai_tpu.engine.sampling import SamplingParams as JSP
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.models import llama as jl
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu.train import finetune as jft
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine import weights as tweights
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.base import ModelConfig as TMC
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.train import finetune as tft

from _torch_parity import assert_same_greedy
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

CFG = TMC(vocab_size=300, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
          num_kv_heads=2, dtype="float32")
RANK, ALPHA, TARGETS = 4, 8.0, ("wq", "wv")
KW = dict(rank=RANK, batch_size=4, seq_len=32, lr=5e-3)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ft-ckpt"))
    params = tl.init_params(CFG, torch.Generator().manual_seed(0))
    tweights.save_hf_checkpoint(path, CFG, tweights.hf_state_dict(params, CFG))
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "train.jsonl"
    with open(path, "w") as f:
        for i in range(16):
            f.write(json.dumps({"prompt": f"Q{i}: say banana. A:", "completion": " banana!"}) + "\n")
    return str(path)


def _rows(dataset):
    return tft.load_dataset(dataset, ByteTokenizer(), KW["seq_len"])


def _bank(jc, seed, b_std):
    """(JAX bank, port bank): float32, A row 1 ~ N(0, 0.01), B row 1 ~
    N(0, b_std) (0: the fine-tune's zero B), scale[1] = ALPHA / RANK."""
    rng = np.random.default_rng(seed)
    jbank = jl.init_lora_bank(jc, 2, RANK, dtype=jnp.float32)
    for t in TARGETS:
        for s, std in (("_A", 0.01), ("_B", b_std)):
            a = np.asarray(jbank[t + s]).copy()
            a[:, 1] = rng.normal(0, std, a[:, 1].shape) if std else 0.0
            jbank[t + s] = jnp.asarray(a)
    jbank["scale"] = jbank["scale"].at[1].set(ALPHA / RANK)
    return jbank, params_from_jax(jax.tree.map(np.asarray, jbank), CFG, "cpu")


def _jax_loss(params, config):
    """The JAX fine-tune's loss_fn (a closure inside finetune())."""
    def loss_fn(trainable, frozen_bank, batch):
        b = dict(frozen_bank)
        b.update(trainable)
        B, S = batch["tokens"].shape
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (B, S))
        logits, _ = jl.apply(params, config, batch["tokens"], pos, lora=b,
                             lora_rows=jnp.ones((B,), jnp.int32))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        ll = jnp.take_along_axis(logp, batch["targets"][..., None], axis=-1)[..., 0]
        m = batch["mask"].astype(jnp.float32)
        return -(ll * m).sum() / jnp.maximum(m.sum(), 1.0)
    return loss_fn


def _split(bank):
    keys = [t + s for t in TARGETS for s in ("_A", "_B")]
    return {k: bank[k] for k in keys}, {k: v for k, v in bank.items() if k not in keys}


def _jax_model(ckpt, dtype):
    jc = JMC.from_json_file(ckpt).replace(dtype=dtype)
    return jc, jl.params_from_hf(jweights.load_state_dict(ckpt), jc)


def test_dataset_and_batches_equal_jax(tmp_path):
    path = tmp_path / "mixed.jsonl"
    with open(path, "w") as f:
        for i in range(7):
            f.write(json.dumps({"prompt": f"Q{i}:", "completion": " é" * i}) + "\n")
        f.write(json.dumps({"text": "a long row " * 20}) + "\n\n")
        f.write(json.dumps({"text": ""}) + "\n")  # BOS only: an empty batch row
    for seq_len in (16, 64):
        want = jft.load_dataset(str(path), JByteTokenizer(), seq_len)
        got = tft.load_dataset(str(path), ByteTokenizer(), seq_len)
        assert got == want
        jr, tr = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(6):
            jb = jft.make_batch(want, 5, seq_len, jr)
            tb = tft.make_batch(got, 5, seq_len, tr)
            for k in ("tokens", "targets", "mask"):
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    with pytest.raises(ValueError, match="no training rows"):
        tft.load_dataset(str(empty), ByteTokenizer(), 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_bank_gradient_match_jax(ckpt, dataset, dtype):
    """bfloat16 is the fine-tune's own case: the checkpoint's base read in
    bf16 by load_base_model, the float32 bank's delta cast to bf16 where
    JAX's _lora_delta casts it."""
    jc, jp = _jax_model(ckpt, dtype)
    if dtype == "bfloat16":
        tp, tc, _ = tft.load_base_model(ckpt, "cpu")
        assert tc.dtype == "bfloat16"
        for k, v in params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu").items():
            if k != "layers":
                torch.testing.assert_close(tp[k], v, rtol=0, atol=0)
    else:
        tc = TMC.from_json_file(ckpt).replace(dtype=dtype)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    jbank, tbank = _bank(jc, seed=1, b_std=0.05)
    batch = tft.make_batch(_rows(dataset), 4, 32, np.random.default_rng(0))

    trainable, frozen = _split(jbank)
    want, jgrads = jax.jit(jax.value_and_grad(_jax_loss(jp, jc)))(
        trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()})
    for k in trainable:
        tbank[k].requires_grad_(True)
    got = tft.lora_loss(tp, tc, tbank, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    got = got.detach()

    want = float(want)
    if dtype == "float32":
        np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(abs(want))) - 7)
        assert abs(got.item() - want) <= 2 * ulp, (got.item(), want)
    for k, g in jgrads.items():
        g = np.asarray(g)
        t = tbank[k].grad.numpy()
        assert not t[:, 0].any()  # row 0, the identity, takes no gradient
        if dtype == "float32":
            np.testing.assert_allclose(t, g, rtol=1e-5, atol=1e-5 * np.abs(g).max(), err_msg=k)
        else:
            assert np.linalg.norm(t - g) <= 1e-2 * np.linalg.norm(g), k


def test_padded_vocab_is_not_read(ckpt, dataset):
    """The engine pads the vocab to 128-wide tiles (300 -> 384); the
    fine-tune must not: a padded column's logit 0 enters the softmax."""
    tp, tc, _ = tft.load_base_model(ckpt, "cpu")
    assert tc.vocab_size == 300
    assert tp["embed"].shape[0] == 300 and tp["lm_head"].shape[1] == 300
    _, tbank = _bank(JMC.from_json_file(ckpt), seed=1, b_std=0.05)
    batch = {k: torch.from_numpy(v)
             for k, v in tft.make_batch(_rows(dataset), 4, 32, np.random.default_rng(0)).items()}
    padded, pc = tweights.pad_vocab(tp, tc, 128)
    assert pc.vocab_size == 384
    with torch.no_grad():
        loss = float(tft.lora_loss(tp, tc, tbank, batch))
        loss_padded = float(tft.lora_loss(padded, pc, tbank, batch))
    assert loss_padded - loss > 0.1, (loss, loss_padded)


@pytest.mark.parametrize("weight_decay", [1e-4, 0.0], ids=["finetune", "trainer"])
def test_adamw_equals_optax_on_the_same_gradients(weight_decay):
    """Five steps of torch AdamW against optax.adamw(lr) (the fine-tune's
    defaults) and optax.adamw(lr, weight_decay=0.0) (the trainer's) on
    one seeded gradient stream, a step of zero gradients among them.
    optax computes the bias corrections in float32 (1 - 0.999 rounds by
    4.7e-5 relative at the first step), torch in float64: each update
    agrees to 1e-4 of a step (lr 1e-3)."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(0, 0.1, (64, 48)).astype(np.float32)
    grads = [rng.normal(0, 10.0 ** rng.uniform(-6, -1), p0.shape).astype(np.float32)
             for _ in range(5)]
    grads[2][:] = 0.0
    opt = optax.adamw(1e-3, weight_decay=weight_decay)
    jp, state = jnp.asarray(p0), None
    state = opt.init(jp)
    tp = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.AdamW([tp], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g.copy())
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)


def test_five_lora_steps_match_the_jax_loop(ckpt, dataset):
    """train_lora against the JAX fine-tune's jitted step (optax.adamw(lr))
    from one float32 bank (A drawn, B zero) on one batch stream; the
    per-element and update-norm bounds of test_torch_trainer.py."""
    jc, jp = _jax_model(ckpt, "float32")
    tc = TMC.from_json_file(ckpt).replace(dtype="float32")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    jbank, tbank = _bank(jc, seed=3, b_std=0.0)
    rows, lr = _rows(dataset), KW["lr"]
    start = {k: np.asarray(v) for k, v in _split(jbank)[0].items()}

    opt = optax.adamw(lr)
    loss_fn = _jax_loss(jp, jc)

    @jax.jit
    def step(trainable, opt_state, frozen, batch):
        loss, grads = jax.value_and_grad(loss_fn)(trainable, frozen, batch)
        updates, opt_state = opt.update(grads, opt_state, trainable)
        return loss, optax.apply_updates(trainable, updates), opt_state

    trainable, frozen = _split(jbank)
    state = opt.init(trainable)
    rng = np.random.default_rng(0)
    want = []
    for _ in range(5):
        b = {k: jnp.asarray(v) for k, v in jft.make_batch(rows, 4, 32, rng).items()}
        loss, trainable, state = step(trainable, state, frozen, b)
        want.append(float(loss))

    stats = {}
    first, last = tft.train_lora(tp, tc, tbank, rows, TARGETS, 5, 4, 32, lr, seed=0, stats=stats)
    np.testing.assert_allclose(stats["losses"], want, rtol=1e-5)
    assert (first, last) == (stats["losses"][0], stats["losses"][-1])
    for k, v in trainable.items():
        got, v = tbank[k].detach().numpy(), np.asarray(v)
        assert not tbank[k].requires_grad
        np.testing.assert_allclose(got, v, rtol=1e-5, atol=0.1 * lr, err_msg=k)
        assert np.linalg.norm(got - v) <= 1e-3 * np.linalg.norm(v - start[k]), k


def test_save_peft_adapter_equals_jax(tmp_path):
    from safetensors.numpy import load_file

    jc = JMC(**{k: getattr(CFG, k) for k in ("vocab_size", "hidden_size", "intermediate_size",
                                             "num_layers", "num_heads", "num_kv_heads")})
    targets = ["wq", "wk", "wo", "wd"]
    rng = np.random.default_rng(5)
    jbank = jl.init_lora_bank(jc, 2, 8, dtype=jnp.float32)
    for k in list(jbank):
        jbank[k] = jnp.asarray(rng.normal(size=jbank[k].shape).astype(np.float32))
    tbank = params_from_jax(jax.tree.map(np.asarray, jbank), CFG, "cpu")
    jft.save_peft_adapter(str(tmp_path / "jax"), jbank, jc, 6, 12.0, targets)
    tft.save_peft_adapter(str(tmp_path / "port"), tbank, CFG, 6, 12.0, targets)
    for name in ("adapter_config.json",):
        with open(tmp_path / "jax" / name) as a, open(tmp_path / "port" / name) as b:
            assert json.load(b) == json.load(a)
    want = load_file(str(tmp_path / "jax" / "adapter_model.safetensors"))
    got = load_file(str(tmp_path / "port" / "adapter_model.safetensors"))
    assert set(got) == set(want) and len(want) == 2 * 2 * len(targets)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _greedy(engine, sp_cls, prompt, adapter, n=8):
    req = engine.submit(prompt, sp_cls(temperature=0.0, max_tokens=n, logprobs=True),
                        adapter=adapter)
    toks = []
    while True:
        ev = req.out.get(timeout=120)
        if ev[0] == "token" and ev[1] >= 0:
            toks.append((ev[1], ev[4]))
        elif ev[0] == "done":
            return toks
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


def test_cli_lowers_the_loss_and_both_engines_serve_the_adapter(ckpt, dataset, tmp_path,
                                                               monkeypatch):
    # main() in this process (a second interpreter would pay torch's
    # import again); its logging setup would replace the test process's
    # root handlers.
    monkeypatch.setattr(tft, "setup_logging", lambda role: None)
    out = str(tmp_path / "adapter")
    stats = {}
    first, last = tft.main(["--model", ckpt, "--data", dataset, "--output", out, "--rank", "4",
                            "--steps", "30", "--seq-len", "32", "--lr", "5e-3",
                            "--device", "cpu"], stats=stats)
    assert last < first, (first, last)
    assert len(stats["step_s"]) == 30 and stats["adapter_s"] > 0

    ec = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16, 32))
    te = tweights.load_engine_from_path(ckpt, tcore.EngineConfig(**ec), dtype="float32",
                                        device="cpu")
    je = jweights.load_engine_from_path(ckpt, jcore.EngineConfig(**ec), dtype="float32")
    prompt = ByteTokenizer().encode("Q9: say banana. A:")
    te.start()
    je.start()
    try:
        base = _greedy(te, TSP, prompt, None)
        for eng in (te, je):
            eng.load_adapter("tuned", out)
        got = _greedy(te, TSP, prompt, "tuned")
        want = _greedy(je, JSP, prompt, "tuned")
    finally:
        te.stop()
        je.stop()
    assert [t for t, _ in got] != [t for t, _ in base]
    assert assert_same_greedy(got, want, "tuned adapter") > 0


def test_resume_equals_an_uninterrupted_run(ckpt, dataset, tmp_path):
    tft.finetune(ckpt, dataset, str(tmp_path / "ref"), steps=12, device="cpu", **KW)
    tft.finetune(ckpt, dataset, str(tmp_path / "out"), steps=6, checkpoint_every=3,
                 device="cpu", **KW)
    assert sorted(os.listdir(tmp_path / "out.ckpt")) == ["2", "5"]
    first, last = tft.finetune(ckpt, dataset, str(tmp_path / "out"), steps=12,
                               checkpoint_every=3, resume=True, device="cpu", **KW)
    assert first is not None and last is not None
    assert sorted(os.listdir(tmp_path / "out.ckpt")) == ["11", "8"]  # the newest 2

    from safetensors.numpy import load_file

    ref = load_file(str(tmp_path / "ref" / "adapter_model.safetensors"))
    got = load_file(str(tmp_path / "out" / "adapter_model.safetensors"))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_foreign_checkpoint_is_refused_and_a_missing_one_starts_at_zero(ckpt, dataset,
                                                                        tmp_path, caplog):
    orbax = tmp_path / "out.ckpt" / "5"
    (orbax / "default").mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match=r"did not write \(5\)"):
        tft.finetune(ckpt, dataset, str(tmp_path / "out"), steps=2, resume=True,
                     device="cpu", **KW)
    with caplog.at_level("WARNING", logger="kubeai_tpu_torch.finetune"):
        first, _ = tft.finetune(ckpt, dataset, str(tmp_path / "fresh"), steps=2, resume=True,
                                device="cpu", **KW)
    assert first is not None
    assert any("no checkpoint found" in r.getMessage() for r in caplog.records)


def test_lora_add_forms_are_equal(monkeypatch):
    """_lora_add writes through out= when nothing needs a gradient (the
    served step: four kernels a target, graph-safe) and allocates under
    autograd; both give the same values."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 5, 48)).astype(np.float32))
    A = torch.from_numpy(rng.normal(0, 0.2, (4, 48, 8)).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(0, 0.2, (4, 8, 40)).astype(np.float32))
    out = torch.from_numpy(rng.normal(size=(3, 5, 40)).astype(np.float32))
    w = tl.lora_weights(torch.tensor([2, 0, 3]), torch.tensor([0.0, 1.5, 2.0, 0.5]),
                        torch.float32)
    calls = []
    mul = torch.mul

    def spy(*args, **kw):
        calls.append("out" in kw)
        return mul(*args, **kw)

    monkeypatch.setattr(torch, "mul", spy)
    with torch.no_grad():
        served = tl._lora_add(out, x, A, Bm, w)
    assert calls == [True]
    A.requires_grad_(True)
    trained = tl._lora_add(out, x, A, Bm, w)
    assert calls == [True]  # the form without out=
    torch.testing.assert_close(trained.detach(), served, rtol=0, atol=0)
    trained.sum().backward()
    assert A.grad is not None and not A.grad[0].any()  # row 0 is no row's adapter
