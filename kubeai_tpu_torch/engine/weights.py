"""Checkpoint loading: HF-format directories -> the port's engine params
(port of kubeai_tpu/engine/weights.py, single process, tp = 1).

``stream_params_from_hf`` reads one parameter group at a time (a stacked
layer weight, the embedding, the head), converts it to the model dtype,
pads the vocab and, with ``quantization="int8"``, quantizes it on the
host before it moves to the device, so full-precision weights never fill
the card. ``load_engine_from_path`` drives it for ``--model <dir>``. Every model
family's HF names are read (Qwen2's q/k/v biases, Gemma2's four norms,
Mixtral's router and experts, a tied head with no ``lm_head.weight``);
``hf_state_dict`` and ``save_hf_checkpoint`` write them back.

The card's machine has no ``safetensors`` package, so this module reads
and writes the format itself: an 8-byte little-endian header length, a
JSON header (dtype, shape and data offsets of each tensor), then the raw
little-endian data. Tensors are read lazily by name. F32, F16, BF16 and
I8 are supported.

Left out (ROADMAP queue 1 items 10-11): the JAX loader's tensor-parallel
mesh and gang ranks, its background compile overlap, warmup and
compile cache.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from kubeai_tpu_torch import resolve_device
from kubeai_tpu_torch.engine.core import Engine, EngineConfig
from kubeai_tpu_torch.engine.tokenizer import load_tokenizer
from kubeai_tpu_torch.models import llama
from kubeai_tpu_torch.models.base import ModelConfig
from kubeai_tpu_torch.ops.quant import quantize, quantize_rows

# safetensors dtype -> (numpy storage dtype, torch dtype). BF16 moves
# through int16: numpy has no bfloat16 without ml_dtypes.
_ST_DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<i2"), torch.bfloat16),
    "I8": (np.dtype("i1"), torch.int8),
}
_ST_NAMES = {t: name for name, (_, t) in _ST_DTYPES.items()}


def read_safetensors_header(path: str) -> tuple[dict[str, dict], int]:
    """(tensor entries by name, byte offset of the data) of one file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensors_tensor(path: str, entry: dict, data_start: int) -> torch.Tensor:
    """One tensor of a file, read from disk now (a CPU tensor)."""
    if entry["dtype"] not in _ST_DTYPES:
        raise ValueError(f"{path}: unsupported safetensors dtype {entry['dtype']}")
    np_dtype, dtype = _ST_DTYPES[entry["dtype"]]
    begin, end = entry["data_offsets"]
    shape = tuple(entry["shape"])
    if end - begin != int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize:
        raise ValueError(f"{path}: data_offsets {begin, end} do not match shape {shape}")
    buf = bytearray(end - begin)
    with open(path, "rb") as f:
        f.seek(data_start + begin)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: file ends inside a tensor")
    t = torch.from_numpy(np.frombuffer(buf, dtype=np_dtype).reshape(shape))
    return t.view(dtype) if dtype == torch.bfloat16 else t


def save_safetensors(tensors: dict[str, Any], path: str) -> None:
    """Write *tensors* (torch tensors, F32 / F16 / BF16 / I8, or numpy
    arrays of those but BF16) as one safetensors file, readable by the
    safetensors package."""
    header: dict[str, dict] = {}
    blobs = []
    offset = 0
    for name, t in tensors.items():
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        t = t.detach().cpu().contiguous()
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


class SafetensorsSource:
    """Random-access view over a checkpoint's *.safetensors shards: opens
    every shard's header now, reads a tensor's data when asked for it, so
    peak host memory is one parameter group, not the model."""

    def __init__(self, path: str):
        self.files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not self.files:
            raise FileNotFoundError(f"no *.safetensors under {path}")
        self._index: dict[str, tuple[str, dict, int]] = {}
        for f in self.files:
            header, start = read_safetensors_header(f)
            for name, entry in header.items():
                self._index[name] = (f, entry, start)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def get(self, name: str) -> torch.Tensor:
        return read_safetensors_tensor(*self._index[name])

    def names(self):
        return self._index.keys()


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the *.safetensors (else pytorch_model*.bin) files
    under *path*, by name, as CPU tensors."""
    try:
        source = SafetensorsSource(path)
    except FileNotFoundError:
        bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
        if not bin_files:
            raise FileNotFoundError(f"no safetensors or pytorch_model.bin under {path}") from None
        sd: dict[str, torch.Tensor] = {}
        for f in bin_files:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
        return sd
    return {name: source.get(name) for name in source.names()}


def padded_vocab_size(vocab_size: int, tp: int = 1) -> int:
    """The engine's vocab padding target: tp divisibility, 128-wide tiles."""
    multiple = max(tp * 128, 128)
    return ((vocab_size + multiple - 1) // multiple) * multiple


def pad_vocab(params: dict, config: ModelConfig, multiple: int) -> tuple[dict, ModelConfig]:
    """Pad the embedding's and lm_head's vocab dim to a multiple. Padded
    columns carry zero weights (logit 0.0); the engine masks logits past
    the tokenizer's vocab before sampling."""
    V = config.vocab_size
    target = ((V + multiple - 1) // multiple) * multiple
    if target == V:
        return params, config
    pad = target - V
    params = dict(params)
    params["embed"] = F.pad(params["embed"], (0, 0, 0, pad))
    if "lm_head" in params:
        params["lm_head"] = F.pad(params["lm_head"], (0, pad))
    return params, config.replace(vocab_size=target)


def _quant_dense(config: ModelConfig) -> tuple[str, ...]:
    return ("wq", "wk", "wv", "wo") + (() if config.num_experts > 0 else ("wg", "wu", "wd"))


def quantize_model_params(params: dict, config: ModelConfig) -> dict:
    """Weight-only int8: per-output-channel scales on the projection
    weights and the head, per-row scales on the embedding; norms stay
    full precision. One stacked weight at a time, so the float32
    temporaries stay one group wide."""
    out = dict(params)
    out["embed"] = quantize_rows(params["embed"])
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"], contract_axis=-2)
    layers = dict(params["layers"])
    for t in _quant_dense(config):
        layers[t] = quantize(layers[t], contract_axis=-2)
    out["layers"] = layers
    return out


def _hf_layer_names(config: ModelConfig) -> list[tuple[str, str, bool]]:
    """(port key, HF name under model.layers.{i}., transposed) of every
    per-layer tensor but Mixtral's experts, for each family as the JAX
    loader names them: Qwen2's q/k/v biases, Gemma2's four norms (its
    post_attention_layernorm is the post-attention norm ln1b,
    pre_feedforward_layernorm the MLP's input norm ln2), Mixtral's
    router."""
    names = [
        ("ln1", "input_layernorm.weight", False),
        ("wq", "self_attn.q_proj.weight", True),
        ("wk", "self_attn.k_proj.weight", True),
        ("wv", "self_attn.v_proj.weight", True),
        ("wo", "self_attn.o_proj.weight", True),
    ]
    if config.qkv_bias:
        names += [("b" + t, f"self_attn.{t}_proj.bias", False) for t in "qkv"]
    if config.post_norms:
        names += [("ln1b", "post_attention_layernorm.weight", False),
                  ("ln2", "pre_feedforward_layernorm.weight", False),
                  ("ln2b", "post_feedforward_layernorm.weight", False)]
    else:
        names.append(("ln2", "post_attention_layernorm.weight", False))
    if config.num_experts > 0:
        names.append(("wr", "block_sparse_moe.gate.weight", True))
    else:
        names += [("wg", "mlp.gate_proj.weight", True), ("wu", "mlp.up_proj.weight", True),
                  ("wd", "mlp.down_proj.weight", True)]
    return names


def _expert_name(li: int, e: int, which: str) -> str:
    return f"model.layers.{li}.block_sparse_moe.experts.{e}.{which}.weight"


def hf_state_dict(params: dict, config: ModelConfig) -> dict[str, torch.Tensor]:
    """The HF state dict (names and [out, in] layouts, CPU tensors) of a
    bf16 or float32 parameter dict: the inverse of stream_params_from_hf
    for every family (a tied model has no lm_head.weight)."""
    def cpu(t):
        return t.contiguous().cpu()

    lay = params["layers"]
    sd = {"model.embed_tokens.weight": cpu(params["embed"]),
          "model.norm.weight": cpu(params["final_norm"])}
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = cpu(params["lm_head"].T)
    for li in range(config.num_layers):
        for key, name, transpose in _hf_layer_names(config):
            sd[f"model.layers.{li}.{name}"] = cpu(lay[key][li].T if transpose else lay[key][li])
        if config.num_experts > 0:
            for key, which in (("wg", "w1"), ("wu", "w3"), ("wd", "w2")):
                for e in range(config.num_experts):
                    sd[_expert_name(li, e, which)] = cpu(lay[key][li, e].T)
    return sd


def stream_params_from_hf(
    source,
    config: ModelConfig,
    tp: int = 1,
    quantization: str = "",
    device: torch.device | str | None = None,
) -> tuple[dict, ModelConfig]:
    """Read, convert, vocab-pad and (int8) quantize each parameter group
    on the host, then move it to *device* before the next group is read.
    *source* is a SafetensorsSource or a name -> tensor dict. Returns
    (params, config with the padded vocab)."""
    llama.check_supported(config)
    if tp != 1:
        raise NotImplementedError("tensor parallelism is not ported yet (ROADMAP queue 1 item 10)")
    dev = resolve_device(device)
    dtype = llama.torch_dtype(config.dtype)
    L = config.num_layers
    V = config.vocab_size
    pad = padded_vocab_size(V, tp) - V
    out_config = config.replace(vocab_size=V + pad) if pad else config
    quant_dense = _quant_dense(config)

    def put(host: torch.Tensor, *key_path):
        host = host.contiguous()
        if quantization == "int8":
            if key_path == ("embed",):
                host = quantize_rows(host)
            elif key_path == ("lm_head",) or (len(key_path) == 2 and key_path[1] in quant_dense):
                host = quantize(host, contract_axis=-2)
        if isinstance(host, dict):
            return {k: v.contiguous().to(dev) for k, v in host.items()}
        return host.to(dev)

    def stack(fmt, transpose=True):
        ws = [source.get(fmt.format(i)) for i in range(L)]
        return torch.stack([w.T if transpose else w for w in ws]).to(dtype)

    embed = source.get("model.embed_tokens.weight").to(dtype)
    if pad:
        embed = F.pad(embed, (0, 0, 0, pad))
    params: dict = {
        "embed": put(embed, "embed"),
        "final_norm": put(source.get("model.norm.weight").to(dtype), "final_norm"),
    }
    del embed
    layers: dict = {}
    for key, name, transpose in _hf_layer_names(config):
        layers[key] = put(stack("model.layers.{}." + name, transpose), "layers", key)
    if config.num_experts > 0:
        # Mixtral: experts.{e}.w1 / w3 / w2 (gate / up / down), stacked
        # to [L, E, in, out]; one stacked weight at a time.
        for key, which in (("wg", "w1"), ("wu", "w3"), ("wd", "w2")):
            layers[key] = put(torch.stack([
                torch.stack([source.get(_expert_name(li, e, which)).T
                             for e in range(config.num_experts)])
                for li in range(L)]).to(dtype), "layers", key)
    params["layers"] = layers
    if not out_config.tie_word_embeddings:
        head = source.get("lm_head.weight").T.to(dtype)
        if pad:
            head = F.pad(head, (0, pad))
        params["lm_head"] = put(head, "lm_head")
        del head
    return params, out_config


def load_engine_from_path(
    path: str,
    engine_config: EngineConfig | None = None,
    tp: int = 1,
    dtype: str = "bfloat16",
    quantization: str = "",
    device: torch.device | str | None = None,
) -> Engine:
    """An Engine over the HF-format checkpoint directory *path*
    (config.json and *.safetensors, else pytorch_model*.bin), on *device*
    (default cuda). A checkpoint without ``lm_head.weight`` ties the head
    to the embedding."""
    if quantization:
        if quantization != "int8":
            raise ValueError(f"unsupported quantization {quantization!r} (supported: int8)")
        if tp > 1:
            raise ValueError("int8 quantization currently supports tensor-parallel-size 1")
    if tp != 1:
        raise NotImplementedError("tensor parallelism is not ported yet (ROADMAP queue 1 item 10)")
    dev = resolve_device(device)
    config = ModelConfig.from_json_file(path).replace(dtype=dtype)
    llama.check_supported(config)
    tokenizer = load_tokenizer(path)
    try:
        source = SafetensorsSource(path)
    except FileNotFoundError:
        source = load_state_dict(path)  # pytorch_model*.bin: a name -> tensor dict
    if "lm_head.weight" not in source and not config.tie_word_embeddings:
        config = config.replace(tie_word_embeddings=True)
    params, config = stream_params_from_hf(source, config, tp=tp, quantization=quantization,
                                           device=dev)
    return Engine(config, params, tokenizer, engine_config or EngineConfig(), device=dev)


def _hf_family(config: ModelConfig) -> tuple[str, str, dict]:
    """(architecture, model_type, the family's own config.json fields)
    that ModelConfig.from_hf reads back into *config*."""
    if config.num_experts > 0:
        return "MixtralForCausalLM", "mixtral", {
            "num_local_experts": config.num_experts,
            "num_experts_per_tok": config.num_experts_per_tok}
    if config.post_norms:
        return "Gemma2ForCausalLM", "gemma2", {
            "hidden_act": "gelu_pytorch_tanh",
            "attn_logit_softcapping": config.attn_softcap or None,
            "final_logit_softcapping": config.logit_softcap or None,
            "query_pre_attn_scalar": (round(config.query_scale**-2)
                                      if config.query_scale else None),
            "sliding_window": config.sliding_window or None}
    if config.rms_one_offset:
        return "GemmaForCausalLM", "gemma", {"hidden_act": "gelu_pytorch_tanh"}
    if config.qkv_bias:
        return "Qwen2ForCausalLM", "qwen2", {}
    return "LlamaForCausalLM", "llama", {}


def save_hf_checkpoint(path: str, config: ModelConfig, state_dict: dict[str, Any]) -> None:
    """Write a minimal HF-format checkpoint directory: config.json (the
    family's model_type and fields, head_dim and llama3 rope scaling
    where the config sets them) and one model.safetensors (HF names and
    [out, in] layouts, torch tensors or numpy arrays: hf_state_dict's)."""
    os.makedirs(path, exist_ok=True)
    arch, model_type, family = _hf_family(config)
    cfg = {
        "architectures": [arch],
        "model_type": model_type,
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads,
        "rope_theta": config.rope_theta,
        "rms_norm_eps": config.rms_norm_eps,
        "max_position_embeddings": config.max_position,
        "tie_word_embeddings": config.tie_word_embeddings,
        **family,
    }
    if config.head_dim:
        cfg["head_dim"] = config.head_dim
    if config.rope_scaling is not None:
        rs = config.rope_scaling
        cfg["rope_scaling"] = {
            "rope_type": "llama3", "factor": rs.factor, "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position,
        }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    save_safetensors(state_dict, os.path.join(path, "model.safetensors"))
