"""LoRA adapters: PEFT checkpoints -> the stacked adapter bank (port of
kubeai_tpu/engine/lora.py, single process).

PEFT-format adapter directories (``adapter_config.json`` plus
``adapter_model*.safetensors`` or ``adapter_model*.bin``) are parsed on
the host and written into the batched multi-LoRA bank
(``models/llama.py::init_lora_bank``). The JAX package publishes a new
bank dict on every load; here every load and unload writes the adapter's
rows IN PLACE on the caller's CUDA stream (the engine's): a captured
decode chunk keeps reading the same tensors, the chunk already queued
sees the old row, and the next one the new row. The bank is never
rebound.

The card's machine has no ``safetensors`` package: adapter files are read
with the port's own reader (engine/weights.py), and
:func:`write_peft_checkpoint` writes them with its writer.
"""

from __future__ import annotations

import glob
import json
import os
import threading

import numpy as np
import torch

from kubeai_tpu_torch.engine.weights import (
    read_safetensors_header,
    read_safetensors_tensor,
    save_safetensors,
)
from kubeai_tpu_torch.models import llama
from kubeai_tpu_torch.models.base import ModelConfig

# PEFT target_modules name -> the model's parameter name.
TARGET_MAP = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "wg",
    "up_proj": "wu",
    "down_proj": "wd",
}
_MODULE = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
           "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp"}


def stage_remote(url: str) -> str:
    """The local directory of an adapter (or model) source: ``file://`` is
    stripped and a plain path passes through. Remote schemes (hf, s3, gs,
    oss) need the JAX loader's downloaders and a network; they are
    refused (ROADMAP queue 1 item 13: remote sources)."""
    if url.startswith("file://"):
        return url[len("file://"):]
    if "://" in url:
        raise NotImplementedError(
            f"remote source {url!r}: only local paths and file:// are ported "
            "(ROADMAP queue 1 item 13: remote adapter and model sources)"
        )
    return url


def load_peft_checkpoint(path: str) -> tuple[dict, dict[str, dict[int, list]], float]:
    """(adapter_config, {target: {layer: [A [r, in], B [out, r]]}}, scale)
    of a PEFT adapter directory; arrays are float32 numpy. The scale is
    lora_alpha / r."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    rank = cfg.get("r", 8)
    scale = cfg.get("lora_alpha", rank) / rank

    tensors: dict[str, np.ndarray] = {}
    files = sorted(glob.glob(os.path.join(path, "adapter_model*.safetensors")))
    if files:
        for fpath in files:
            header, start = read_safetensors_header(fpath)
            for name, entry in header.items():
                tensors[name] = read_safetensors_tensor(fpath, entry, start).float().numpy()
    else:
        bins = sorted(glob.glob(os.path.join(path, "adapter_model*.bin")))
        if not bins:
            raise FileNotFoundError(f"no adapter weights under {path}")
        for fpath in bins:
            for name, t in torch.load(fpath, map_location="cpu", weights_only=True).items():
                tensors[name] = t.float().numpy()

    out: dict[str, dict[int, list]] = {}
    for name, arr in tensors.items():
        # e.g. base_model.model.model.layers.3.self_attn.q_proj.lora_A.weight
        parts = name.split(".")
        try:
            layer_idx = int(parts[parts.index("layers") + 1])
        except (ValueError, IndexError):
            continue
        target = next((t for t in TARGET_MAP if t in parts), None)
        kind = "A" if "lora_A" in parts else "B" if "lora_B" in parts else None
        if target is None or kind is None:
            continue
        slot = out.setdefault(TARGET_MAP[target], {}).setdefault(layer_idx, [None, None])
        slot[0 if kind == "A" else 1] = arr
    return cfg, out, scale


def peft_module(li: int, target: str) -> str:
    """The PEFT name of layer *li*'s module *target* (a PEFT name), which
    its ``.lora_A.weight`` [r, in] and ``.lora_B.weight`` [out, r] extend."""
    return f"base_model.model.model.layers.{li}.{_MODULE[target]}.{target}"


def write_peft_files(path: str, tensors: dict, rank: int, alpha: float, targets) -> None:
    """adapter_config.json (the JAX fine-tune's keys) and
    adapter_model.safetensors of *tensors* (PEFT names) under *path*."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": rank, "lora_alpha": alpha,
                   "target_modules": list(targets)}, f, indent=1)
    save_safetensors(tensors, os.path.join(path, "adapter_model.safetensors"))


def write_peft_checkpoint(path: str, config: ModelConfig, rank: int = 4, alpha: float = 8,
                          seed: int = 0, targets=tuple(TARGET_MAP), std: float = 0.1) -> dict:
    """A PEFT-format adapter directory (adapter_config.json and
    adapter_model.safetensors) with N(0, std) float32 A and B of *rank* on
    *targets* (PEFT names) in every layer, from *seed*. Returns the
    tensors by name."""
    rng = np.random.default_rng(seed)
    dims = llama.lora_dims(config)
    tensors = {}
    for li in range(config.num_layers):
        for t in targets:
            din, dout = dims[TARGET_MAP[t]]
            base = peft_module(li, t)
            tensors[base + ".lora_A.weight"] = rng.normal(0, std, (rank, din)).astype(np.float32)
            tensors[base + ".lora_B.weight"] = rng.normal(0, std, (dout, rank)).astype(np.float32)
    write_peft_files(path, tensors, rank, alpha, targets)
    return tensors


class AdapterRuntime:
    """The adapter bank of one engine and its name -> row assignment.

    Row 0 is the identity (no adapter); adapters take rows 1..max_adapters.
    Every row has a generation, bumped whenever its weights change (load,
    reload, unload): rows are recycled, so anything derived from a row
    (the prefix cache's KV) keys on (row, generation), never the bare
    index."""

    def __init__(self, config: ModelConfig, max_adapters: int = 8, max_rank: int = 64,
                 dtype: torch.dtype | None = None, device: torch.device | str = "cpu"):
        self.config = config
        self.max_adapters = max_adapters
        self.max_rank = max_rank
        self.bank = llama.init_lora_bank(config, max_adapters + 1, max_rank, dtype, device)
        self._rows: dict[str, int] = {}
        self._row_gen: dict[int, int] = {}
        self._lock = threading.Lock()

    def row_for(self, name: str | None) -> int:
        if not name:
            return 0
        with self._lock:
            return self._rows.get(name, 0)

    def row_sig(self, name: str | None) -> tuple[int, int]:
        """(row, generation) identity of the adapter's current weights."""
        with self._lock:
            row = self._rows.get(name, 0) if name else 0
            return row, self._row_gen.get(row, 0)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._rows)

    def load(self, name: str, path: str) -> None:
        """Install (or reload) adapter *name* from the PEFT directory
        *path*. Only the targets the checkpoint holds are written, as in
        the JAX runtime: a reload from fewer targets keeps the replaced
        adapter's other targets (ROADMAP queue 3)."""
        cfg, targets, scale = load_peft_checkpoint(path)
        rank = cfg.get("r", 8)
        if rank > self.max_rank:
            raise ValueError(f"adapter rank {rank} exceeds engine max {self.max_rank}")
        with self._lock:
            if name in self._rows:
                row = self._rows[name]
            else:
                used = set(self._rows.values())
                free = [i for i in range(1, self.max_adapters + 1) if i not in used]
                if not free:
                    raise RuntimeError(f"adapter capacity {self.max_adapters} exhausted")
                row = free[0]
            # Build every row on the host first: a shape or name failure
            # raises before the bank is touched.
            L = self.config.num_layers
            updates = {}
            for target, layers in targets.items():
                din = self.bank[target + "_A"].shape[2]
                dout = self.bank[target + "_B"].shape[3]
                A = np.zeros((L, din, self.max_rank), np.float32)
                Bm = np.zeros((L, self.max_rank, dout), np.float32)
                for li, (a, b) in layers.items():
                    if a is None or b is None or li >= L:
                        continue
                    # PEFT stores A [r, in], B [out, r]; the bank wants
                    # [in, r] / [r, out], zero-padded to max_rank.
                    A[li, :, : a.shape[0]] = a.T
                    Bm[li, : b.shape[1], :] = b.T
                updates[target] = (A, Bm)
            for target, (A, Bm) in updates.items():
                for key, host in ((target + "_A", A), (target + "_B", Bm)):
                    dst = self.bank[key]
                    dst[:, row].copy_(torch.from_numpy(host).to(dst.dtype))
            self.bank["scale"][row] = scale
            self._rows[name] = row
            self._row_gen[row] = self._row_gen.get(row, 0) + 1

    def unload(self, name: str) -> bool:
        with self._lock:
            row = self._rows.pop(name, None)
            if row is None:
                return False
            for key, t in self.bank.items():
                if key == "scale":
                    t[row] = 0.0
                else:
                    t[:, row].zero_()
            self._row_gen[row] = self._row_gen.get(row, 0) + 1
            return True
