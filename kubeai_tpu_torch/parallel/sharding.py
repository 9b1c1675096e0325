"""Megatron split rules for the model's parameters (port of
kubeai_tpu/parallel/sharding.py).

The JAX package writes one PartitionSpec per leaf and lets XLA insert
the collectives. Here the rules are data, one per leaf: the dimension
of the stacked leaf (every layer weight is [L, in, out], an expert
weight [L, E, in, out]) that is split over the tp ranks, or None for a
replicated leaf. ``models/llama.py`` calls the collectives the split
needs:

- column-parallel (``wq wk wv wg wu`` on their output dim, Qwen2's
  ``bq bk bv``): each rank computes its heads or its FFN columns;
- row-parallel (``wo wd`` on their input dim): each rank's product is a
  partial sum, all-reduced;
- vocab-sharded ``embed`` [V, D] (rows) and ``lm_head`` [D, V]
  (columns): a masked lookup of this rank's vocab range plus an
  all-reduce, and an all-gather of the logits;
- Mixtral's ``wg wu wd`` split their FFN dim as the dense ones do, the
  router ``wr`` is replicated, and so are the norms. Serving splits
  every expert this way; training over a mesh also splits the experts
  themselves over ep (below).

The paged KV pool splits its combined KV heads: rank r holds KV heads
r*Kv/tp .. (r+1)*Kv/tp-1 of every page, so tp must divide Kv, pages are
not split, and block tables are host state every rank shares.

An int8 leaf ({"int8_q", "int8_s"}, engine/weights.py) splits its values
as the weight; its per-output-channel scales [.., 1, out] split with a
column-parallel weight and stay whole with a row-parallel one (the
scale is taken over the whole input dim, as the JAX package's is).

Training over a mesh (parallel/mesh.py) adds the JAX package's fsdp
split (``llama_param_specs(fsdp=True)``): :func:`llama_fsdp_rules` gives
each leaf's dimension split over dp, the one its tp split leaves alone
(the input dim of wq wk wv wg wu, the output dim of wo wd, the hidden
dim of embed and lm_head); norms and biases have none. The JAX
package's ``ep`` axis splits the experts of ``wg wu wd`` (dim 1 of the
stacked [L, E, in, out]; :func:`llama_ep_rules`) and nothing else. A
mesh rank holds the block of its (dp, ep, tp) coordinates and the same
block as every rank along sp (and, for a leaf that is not an expert's,
along ep).
"""

from __future__ import annotations

from typing import Any

import torch

from kubeai_tpu_torch.models.base import ModelConfig
from kubeai_tpu_torch.ops.quant import QKEY, SKEY

COLUMN = ("wq", "wk", "wv", "wg", "wu")
ROW = ("wo", "wd")
BIAS = ("bq", "bk", "bv")


def llama_split_rules(config: ModelConfig) -> dict[str, Any]:
    """The split dimension of every leaf of ``llama.init_params``'s tree
    for *config* (None: replicated), in the tree's own structure."""
    moe = config.num_experts > 0
    layers: dict[str, int | None] = {"ln1": None, "ln2": None,
                                     "wq": 2, "wk": 2, "wv": 2, "wo": 1}
    if config.qkv_bias:
        layers.update({b: 1 for b in BIAS})
    if config.post_norms:
        layers.update({"ln1b": None, "ln2b": None})
    if moe:
        layers.update({"wr": None, "wg": 3, "wu": 3, "wd": 2})
    else:
        layers.update({"wg": 2, "wu": 2, "wd": 1})
    rules: dict[str, Any] = {"embed": 0, "final_norm": None, "layers": layers}
    if not config.tie_word_embeddings:
        rules["lm_head"] = 1
    return rules


def llama_fsdp_rules(config: ModelConfig) -> dict[str, Any]:
    """The dimension of every leaf that fsdp splits over dp (None: not
    split), in the tree's own structure: the "dp" entries of the JAX
    package's ``llama_param_specs(config, fsdp=True)``."""
    layers: dict[str, int | None] = {"ln1": None, "ln2": None,
                                     "wq": 1, "wk": 1, "wv": 1, "wo": 2}
    if config.qkv_bias:
        layers.update({b: None for b in BIAS})
    if config.post_norms:
        layers.update({"ln1b": None, "ln2b": None})
    if config.num_experts > 0:
        layers.update({"wr": 1, "wg": 2, "wu": 2, "wd": 3})
    else:
        layers.update({"wg": 1, "wu": 1, "wd": 2})
    rules: dict[str, Any] = {"embed": 1, "final_norm": None, "layers": layers}
    if not config.tie_word_embeddings:
        rules["lm_head"] = 0
    return rules


def llama_ep_rules(config: ModelConfig) -> dict[str, Any]:
    """The dimension of every leaf that is split over ep (None: not
    split), in the tree's own structure: the "ep" entries of the JAX
    package's ``llama_param_specs`` (dim 1, E, of the stacked experts)."""
    rules: dict[str, Any] = {k: None for k in llama_split_rules(config)}
    rules["layers"] = {k: None for k in llama_split_rules(config)["layers"]}
    if config.num_experts > 0:
        rules["layers"].update({"wg": 1, "wu": 1, "wd": 1})
    return rules


def _rule(rules, key_path):
    for k in key_path:
        rules = rules[k]
    return rules


def key_paths(params: dict):
    """(key_path, leaf) of every tensor of a parameter tree, in order:
    ("embed",), ("layers", "wq"), ..."""
    for key, leaf in params.items():
        if key == "layers":
            for k, v in leaf.items():
                yield ("layers", k), v
        else:
            yield (key,), leaf


def _put(tree: dict, key_path, value) -> None:
    for k in key_path[:-1]:
        tree = tree.setdefault(k, {})
    tree[key_path[-1]] = value


def check_divisible(config: ModelConfig, tp: int, ep: int = 1) -> None:
    """Raise ValueError unless *tp* divides the KV heads (and so the
    heads, a multiple of them), the FFN width (dense or expert) and the
    vocab, and *ep* the experts of a MoE config."""
    if tp < 1:
        raise ValueError(f"tensor-parallel size must be >= 1, got {tp}")
    if config.num_experts > 0 and config.num_experts % ep:
        raise ValueError(f"ep={ep} must divide the experts (num_experts={config.num_experts})")
    if tp == 1:
        return
    if config.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide the KV heads (num_kv_heads={config.num_kv_heads}): the paged "
            f"pool's combined KV heads are split over tp, each rank holding whole K/V pairs")
    for what, n in (("intermediate_size", config.intermediate_size),
                    ("vocab_size", config.vocab_size)):
        if n % tp:
            raise ValueError(
                f"{what}: the split over tp={tp} implies that the global size of its "
                f"dimension should be divisible by {tp}, but it is equal to {n}")


def shard_leaf(leaf, dim: int | None, rank: int, tp: int, scale_whole: bool = False):
    """Rank *rank*'s part of *leaf* split on *dim* (None: the leaf
    itself), as a contiguous copy; an int8 leaf's scales stay whole when
    *scale_whole* (a row-parallel weight)."""
    if dim is None or tp == 1:
        return leaf
    if isinstance(leaf, dict):
        return {k: (v if k == SKEY and scale_whole else shard_leaf(v, dim, rank, tp))
                for k, v in leaf.items()}
    n = leaf.shape[dim]
    if n % tp:
        raise ValueError(
            f"the split over tp={tp} implies that the global size of its dimension {dim} "
            f"should be divisible by {tp}, but it is equal to {n} (full shape: "
            f"{tuple(leaf.shape)})")
    part = n // tp
    return leaf.narrow(dim, rank * part, part).contiguous()


def shard_group(key_path: tuple[str, ...], leaf, config: ModelConfig, rank: int, tp: int):
    """This rank's part of the parameter group at *key_path* (("embed",),
    ("layers", "wq"), ...), a full bf16/float32 tensor or int8 leaf."""
    rule: Any = llama_split_rules(config)
    for k in key_path:
        rule = rule[k]
    return shard_leaf(leaf, rule, rank, tp, scale_whole=key_path[-1] in ROW)


def shard_params(params: dict, config: ModelConfig, group) -> dict:
    """Rank ``group.rank``'s shard of the full parameter tree *params*
    (host or device tensors; the shard stays where the leaf is). Raises
    ValueError when tp does not divide a split dimension."""
    tp = group.world_size
    check_divisible(config, tp)
    out: dict = {}
    for key, leaf in params.items():
        if key == "layers":
            out[key] = {k: shard_group(("layers", k), v, config, group.rank, tp)
                        for k, v in leaf.items()}
        else:
            out[key] = shard_group((key,), leaf, config, group.rank, tp)
    return out


def shard_mesh_params(params: dict, config: ModelConfig, mesh) -> dict:
    """A parallel/mesh.py Mesh rank's fsdp x ep x tp block of the full
    tree *params* (:func:`shard_mesh_group` of each leaf)."""
    out: dict = {}
    for path, leaf in key_paths(params):
        _put(out, path, shard_mesh_group(path, leaf, config, mesh))
    return out


def shard_mesh_group(key_path: tuple[str, ...], leaf, config: ModelConfig, mesh):
    """A mesh rank's block of the full leaf at *key_path*: its tp part,
    then its ep part of that (an expert's leaf), then its dp part on the
    fsdp dim."""
    check_divisible(config, mesh.shape["tp"], mesh.shape["ep"])
    part = shard_group(key_path, leaf, config, mesh.coords["tp"], mesh.shape["tp"])
    for rules, axis in ((llama_ep_rules, "ep"), (llama_fsdp_rules, "dp")):
        part = shard_leaf(part, _rule(rules(config), key_path), mesh.coords[axis],
                          mesh.shape[axis])
    return part


def gather_params(params: dict, config: ModelConfig, mesh) -> dict:
    """The whole tree from every mesh rank's block *params* (a parameter
    tree or one of its gradients): each leaf all-gathered over dp on its
    fsdp dim, over ep on its expert dim, then over tp on its split dim.
    Every rank of the mesh calls it; the result is on the leaves' device,
    outside autograd."""
    rules = [(llama_fsdp_rules(config), mesh.dp), (llama_ep_rules(config), mesh.ep),
             (llama_split_rules(config), mesh.tp)]
    out: dict = {}
    with torch.no_grad():
        for path, leaf in key_paths(params):
            for rule, group in rules:
                dim = _rule(rule, path)
                if dim is not None:
                    leaf = group.all_gather_dim(leaf, dim)
            _put(out, path, leaf)
    return out


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def global_nbytes(params: dict, config: ModelConfig, tp: int) -> int:
    """Bytes of the whole model whose rank shard is *params*: a split
    leaf counts tp times, a replicated one (and a row-parallel weight's
    whole int8 scales) once."""
    rules = llama_split_rules(config)
    total = 0
    for key, leaf in params.items():
        group = leaf.items() if key == "layers" else [(key, leaf)]
        for k, v in group:
            dim = rules["layers"][k] if key == "layers" else rules[k]
            if dim is None or tp == 1:
                total += _nbytes(v)
            elif isinstance(v, dict) and k in ROW:
                total += _nbytes(v[QKEY]) * tp + _nbytes(v[SKEY])
            else:
                total += _nbytes(v) * tp
    return total


def shard_lora_bank(bank: dict, rank: int, tp: int) -> dict:
    """This rank's view of a replicated LoRA bank: a column target's B
    [L, N, r, out] keeps its columns, a row target's A [L, N, in, r] its
    rows (views: the bank stays whole, written in place by loads)."""
    if tp == 1:
        return bank
    out = dict(bank)
    for t in COLUMN:
        b = bank[t + "_B"]
        part = b.shape[-1] // tp
        out[t + "_B"] = b.narrow(-1, rank * part, part)
    for t in ROW:
        a = bank[t + "_A"]
        part = a.shape[-2] // tp
        out[t + "_A"] = a.narrow(-2, rank * part, part)
    return out
