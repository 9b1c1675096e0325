"""LoRA fine-tuning CLI (port of kubeai_tpu/train/finetune.py): PEFT
adapters that both packages' engines serve.

    python -m kubeai_tpu_torch.train.finetune \
        --model <hf-ckpt-dir> --data train.jsonl --output ./my-adapter \
        --rank 8 --steps 100 --targets q_proj,v_proj [--device cpu]

The base model stays frozen, in bfloat16 (``ModelConfig.from_json_file``
reads no dtype from config.json, as in the JAX package). Gradients flow
only into a float32 LoRA bank (row 0 the identity, row 1 the adapter)
applied by the decoder the serving engine runs, and torch's AdamW takes
the place of ``optax.adamw(lr)`` with its defaults (weight decay 1e-4).
Data is JSONL with {"text": ...} or {"prompt": ..., "completion": ...}
rows (loss masked to the completion when split). Runs on the card
unless ``--device cpu``.

Where the port differs from the JAX package:
- A's initial draw comes from a ``torch.Generator`` seeded with *seed*
  (JAX's threefry draws cannot be made without JAX), so one seed starts
  the two packages from different banks; :func:`init_bank` is the one
  place it happens.
- Checkpoints are not orbax's: ``<output>.ckpt/<step>/train_state.pt``
  holds the trainable tensors, the optimizer's ``state_dict`` and the
  step (``torch.save``, written under a temporary name and renamed); the
  newest 2 are kept. A ``.ckpt`` directory that holds anything else (an
  orbax checkpoint) is refused by name.
- The vocab is not padded to the engine's 128-wide tiles: a padded
  column's logit 0 would enter the loss's softmax.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np
import torch

from kubeai_tpu_torch import resolve_device
from kubeai_tpu_torch.engine.lora import peft_module, write_peft_files
from kubeai_tpu_torch.engine.tokenizer import load_tokenizer
from kubeai_tpu_torch.engine.weights import (
    SafetensorsSource,
    load_state_dict,
    stream_params_from_hf,
)
from kubeai_tpu_torch.models import llama
from kubeai_tpu_torch.models.base import ModelConfig
from kubeai_tpu_torch.obs.logs import get_logger, setup_logging
from kubeai_tpu_torch.train.trainer import leaves, make_optimizer, masked_nll, positions

log = get_logger("kubeai_tpu_torch.finetune")

PEFT_NAMES = {
    "wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj",
    "wg": "gate_proj", "wu": "up_proj", "wd": "down_proj",
}

CKPT_FILE = "train_state.pt"
CKPT_KEEP = 2


def load_dataset(path: str, tokenizer, seq_len: int) -> list[tuple[list[int], list[int]]]:
    """Returns (token_ids, loss_mask) pairs, truncated to seq_len."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if "text" in doc:
                ids = tokenizer.encode(doc["text"])
                mask = [1] * len(ids)
            else:
                prompt_ids = tokenizer.encode(doc["prompt"])
                completion_ids = tokenizer.encode(doc["completion"], add_bos=False)
                ids = prompt_ids + completion_ids
                mask = [0] * len(prompt_ids) + [1] * len(completion_ids)
            rows.append((ids[:seq_len], mask[:seq_len]))
    if not rows:
        raise ValueError(f"no training rows in {path}")
    return rows


def make_batch(rows, batch_size: int, seq_len: int, rng) -> dict[str, np.ndarray]:
    idx = rng.integers(0, len(rows), batch_size)
    tokens = np.zeros((batch_size, seq_len), np.int32)
    targets = np.zeros((batch_size, seq_len), np.int32)
    mask = np.zeros((batch_size, seq_len), np.int32)
    for i, j in enumerate(idx):
        ids, m = rows[j]
        n = min(len(ids) - 1, seq_len)
        if n <= 0:
            continue
        tokens[i, :n] = ids[:n]
        targets[i, :n] = ids[1 : n + 1]
        mask[i, :n] = m[1 : n + 1]
    return {"tokens": tokens, "targets": targets, "mask": mask}


def save_peft_adapter(path: str, bank, config, rank: int, alpha: float, targets: list[str]):
    """Write adapter_config.json + adapter_model.safetensors in the PEFT
    layout engine/lora.py loads (A [r, in], B [out, r], float32): the
    JAX package's keys, names and values."""
    tensors = {}
    for t in targets:
        A = bank[t + "_A"][:, 1, :, :rank].detach().float().cpu()  # [L, in, r]
        B = bank[t + "_B"][:, 1, :rank, :].detach().float().cpu()  # [L, r, out]
        for li in range(config.num_layers):
            base = peft_module(li, PEFT_NAMES[t])
            tensors[base + ".lora_A.weight"] = A[li].T.contiguous()  # [r, in]
            tensors[base + ".lora_B.weight"] = B[li].T.contiguous()  # [out, r]
    write_peft_files(path, tensors, rank, alpha, [PEFT_NAMES[t] for t in targets])


def load_base_model(model_path: str, device) -> tuple[dict, ModelConfig, object]:
    """(frozen params, config, tokenizer) of the checkpoint at
    *model_path*, read as the JAX fine-tune reads it: config.json in
    bfloat16, the head tied when the weights have no ``lm_head.weight``,
    the vocab unpadded, the checkpoint's own tokenizer."""
    config = ModelConfig.from_json_file(model_path)
    llama.check_supported(config)
    try:
        source = SafetensorsSource(model_path)
    except FileNotFoundError:
        source = load_state_dict(model_path)  # pytorch_model*.bin
    if "lm_head.weight" not in source and not config.tie_word_embeddings:
        config = config.replace(tie_word_embeddings=True)
    params, config = stream_params_from_hf(source, config, device=device, pad=False)
    for t in leaves(params):
        t.requires_grad_(False)
    return params, config, load_tokenizer(model_path)


def init_bank(config: ModelConfig, rank: int, alpha: float, targets, seed: int = 0,
              init_scale: float = 0.01, device="cpu") -> dict:
    """The float32 bank a fine-tune starts from: row 0 the identity, row
    1 the adapter, with A ~ N(0, init_scale) on *targets* and B zero (the
    delta starts at 0), ``scale[1] = alpha / rank``. A is drawn on the
    CPU from a ``torch.Generator`` seeded with *seed*, so the bank does
    not depend on *device* (nor equals the JAX package's threefry
    draw)."""
    bank = llama.init_lora_bank(config, 2, rank, dtype=torch.float32, device=device)
    gen = torch.Generator().manual_seed(seed)
    for t in targets:
        L, _, din, r = bank[t + "_A"].shape
        bank[t + "_A"][:, 1] = (torch.randn((L, din, r), generator=gen) * init_scale).to(device)
    bank["scale"][1] = alpha / rank
    return bank


def lora_loss(params, config: ModelConfig, bank, batch) -> torch.Tensor:
    """The JAX fine-tune's loss_fn: every batch row on the bank's row 1,
    the masked mean of the targets' negative log-likelihood."""
    tokens = batch["tokens"]
    rows = torch.ones((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
    logits, _ = llama.apply(params, config, tokens, positions(tokens), lora=bank, lora_rows=rows)
    return masked_nll(logits, batch["targets"], batch["mask"])


class Checkpoints:
    """``<output>.ckpt/``: one directory per saved step, named by the step,
    holding :data:`CKPT_FILE`; the newest :data:`CKPT_KEEP` are kept. Opening
    a directory that holds anything else (an orbax checkpoint of the JAX
    package) raises, naming it."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        foreign = sorted(n for n in os.listdir(root)
                         if not (n.startswith(".tmp-") or self._step_dir(n)))
        if foreign:
            raise ValueError(
                f"{root} holds what this fine-tune did not write ({', '.join(foreign[:5])}): "
                f"not a checkpoint of the port (an orbax checkpoint of the JAX package?); "
                f"remove it or write to another --output")

    def _step_dir(self, name: str) -> bool:
        return name.isdigit() and os.path.isfile(os.path.join(self.root, name, CKPT_FILE))

    def steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.root) if self._step_dir(n))

    def latest(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainable: dict, optimizer) -> None:
        tmp = os.path.join(self.root, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"step": step, "trainable": {k: v.detach() for k, v in trainable.items()},
                    "optimizer": optimizer.state_dict()}, os.path.join(tmp, CKPT_FILE))
        final = os.path.join(self.root, str(step))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-CKPT_KEEP]:
            shutil.rmtree(os.path.join(self.root, str(old)))

    def restore(self, step: int, device) -> dict:
        return torch.load(os.path.join(self.root, str(step), CKPT_FILE), map_location=device,
                          weights_only=True)


def train_lora(params, config: ModelConfig, bank: dict, rows, targets, steps: int,
               batch_size: int, seq_len: int, lr: float, seed: int = 0,
               ckpt_dir: str | None = None, checkpoint_every: int = 0, resume: bool = False,
               stats: dict | None = None):
    """Train the *targets*' A and B leaves of *bank* (both rows, as in the
    JAX package; row 0 gets zero gradients) on batches of *rows* drawn
    from ``np.random.default_rng(seed)``, in place. With *ckpt_dir*,
    saves every *checkpoint_every* steps and at the last one, and
    *resume* continues from the newest save (replaying the data RNG's
    draws). Returns (first loss, last loss) of the steps run; *stats*
    gets each step's seconds (``step_s``, to the loss on the host) and
    each save's (``save_s``)."""
    keys = [t + s for t in targets for s in ("_A", "_B")]
    for k in keys:
        bank[k].requires_grad_(True)
    optimizer = make_optimizer({k: bank[k] for k in keys}, lr, weight_decay=1e-4)  # optax's
    dev = bank["scale"].device
    stats = {} if stats is None else stats
    stats.update(step_s=[], save_s=[], losses=[])

    ckpt = None
    start_step = 0
    if checkpoint_every > 0 or resume:
        ckpt = Checkpoints(ckpt_dir)
        latest = ckpt.latest() if resume else None
        if latest is not None:
            state = ckpt.restore(latest, dev)
            with torch.no_grad():
                for k in keys:
                    bank[k].copy_(state["trainable"][k])
            optimizer.load_state_dict(state["optimizer"])
            start_step = latest + 1
            log.info("resumed from checkpoint step %d", latest)
        elif resume:
            log.warning("--resume requested but no checkpoint found under %s; "
                        "starting from step 0", ckpt_dir)

    # Replay only the data RNG's consumed draws (one index draw per batch).
    rng = np.random.default_rng(seed)
    for _ in range(start_step):
        rng.integers(0, len(rows), batch_size)

    first_loss = last_loss = None
    for i in range(start_step, steps):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in make_batch(rows, batch_size, seq_len, rng).items()}
        optimizer.zero_grad(set_to_none=True)
        loss = lora_loss(params, config, bank, batch)
        loss.backward()
        optimizer.step()
        last_loss = float(loss.detach())  # waits for the step: the device is in order
        stats["step_s"].append(time.perf_counter() - t0)
        stats["losses"].append(last_loss)
        if first_loss is None:
            first_loss = last_loss
        if i % 10 == 0 or i == steps - 1:
            log.info("step %d loss %.4f", i, last_loss)
        if ckpt is not None and checkpoint_every > 0 and (
                (i + 1) % checkpoint_every == 0 or i == steps - 1):
            t0 = time.perf_counter()
            ckpt.save(i, {k: bank[k] for k in keys}, optimizer)
            stats["save_s"].append(time.perf_counter() - t0)
    for k in keys:
        bank[k].requires_grad_(False)
    return first_loss, last_loss


def finetune(
    model_path: str,
    data_path: str,
    output_path: str,
    rank: int = 8,
    alpha: float | None = None,
    steps: int = 100,
    batch_size: int = 4,
    seq_len: int = 256,
    lr: float = 1e-3,
    targets: tuple[str, ...] = ("wq", "wv"),
    seed: int = 0,
    init_scale: float = 0.01,
    checkpoint_every: int = 0,
    resume: bool = False,
    device=None,
    stats: dict | None = None,
):
    """LoRA fine-tune `model_path` on `data_path`, writing a PEFT
    adapter to `output_path`, on *device* (default cuda).

    checkpoint_every > 0 saves (the trainable bank leaves, the
    optimizer's state, the step) every N steps into <output_path>.ckpt/;
    resume=True restores the latest and continues: a preempted job re-runs
    the same command with --resume and loses at most N steps. Returns
    (first loss, last loss); *stats* gets the loop's timings
    (:func:`train_lora`) and the adapter write's seconds (``adapter_s``)."""
    alpha = alpha if alpha is not None else float(rank)
    dev = resolve_device(device)
    params, config, tokenizer = load_base_model(model_path, dev)
    rows = load_dataset(data_path, tokenizer, seq_len)
    log.info("%d training rows", len(rows))
    bank = init_bank(config, rank, alpha, targets, seed, init_scale, dev)
    stats = {} if stats is None else stats
    first_loss, last_loss = train_lora(
        params, config, bank, rows, targets, steps, batch_size, seq_len, lr, seed,
        ckpt_dir=os.path.abspath(output_path.rstrip("/") + ".ckpt"),
        checkpoint_every=checkpoint_every, resume=resume, stats=stats)
    t0 = time.perf_counter()
    save_peft_adapter(output_path, bank, config, rank, alpha, list(targets))
    stats["adapter_s"] = time.perf_counter() - t0
    log.info(
        "adapter saved to %s (loss %s -> %s)", output_path,
        "-" if first_loss is None else f"{first_loss:.4f}",
        "-" if last_loss is None else f"{last_loss:.4f}",
    )
    return first_loss, last_loss


def main(argv=None, stats: dict | None = None):
    """The CLI: the JAX package's flags plus --device. Returns finetune's
    (first loss, last loss); *stats* as finetune's."""
    parser = argparse.ArgumentParser("kubeai-tpu-torch-finetune")
    parser.add_argument("--model", required=True)
    parser.add_argument("--data", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--rank", type=int, default=8)
    parser.add_argument("--alpha", type=float, default=None)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--targets", default="q_proj,v_proj")
    parser.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="save trainable state + optimizer every N steps into <output>.ckpt "
             "(0 disables)",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="restore the latest checkpoint under <output>.ckpt and "
             "continue (preempted-job recovery)",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; never falls back to the CPU")
    args = parser.parse_args(argv)
    setup_logging("finetune")

    rev = {v: k for k, v in PEFT_NAMES.items()}
    targets = tuple(rev[t.strip()] for t in args.targets.split(","))
    return finetune(
        args.model, args.data, args.output,
        rank=args.rank, alpha=args.alpha, steps=args.steps,
        batch_size=args.batch_size, seq_len=args.seq_len, lr=args.lr,
        targets=targets,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        device=args.device, stats=stats,
    )


if __name__ == "__main__":
    main()
