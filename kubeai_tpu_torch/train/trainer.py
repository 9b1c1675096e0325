"""The full-parameter training step, on one card or over a mesh (port
of kubeai_tpu/train/trainer.py).

The loss is the JAX package's: next-token cross-entropy over mask = 1
positions of the cache-less forward (``models/llama.py::apply``, plain
attention in float32), through torch autograd where JAX differentiates
with ``jax.value_and_grad``. ``torch.optim.AdamW`` takes optax.adamw's
place with its defaults (b1 0.9, b2 0.999, eps 1e-8; both decouple the
weight decay and correct the moments' bias).

Over a mesh (parallel/mesh.py, one Mesh per rank) the JAX step's
shardings become each rank's own work: parameters fsdp over dp and
Megatron over tp (parallel/sharding.py), the batch split P("dp", "sp"),
attention as ring attention over sp (or the dense arm). The loss is the
JAX loss over the global batch, Σ(nll·mask) over every rank ÷
max(Σmask, 1): each rank's backward leaves on its block its share of the
gradient of that loss, and the shares are summed over the ranks that saw
other data (dp through fsdp's reduce-scatter, then sp; dp x sp for the
leaves fsdp does not split), never over tp, where Megatron's pair
already makes the replicated leaves' gradients equal, nor over ep, whose
ranks see the same data: a MoE router's gradient alone is summed over ep
x tp, since each rank's products see only its experts' part. AdamW is
elementwise, so each rank's update of its block is optax's update of the
whole, sliced.
"""

from __future__ import annotations

import math
import time

import torch

from kubeai_tpu_torch import resolve_device
from kubeai_tpu_torch.models import llama
from kubeai_tpu_torch.models.base import ModelConfig
from kubeai_tpu_torch.parallel.group import reduce_from_group
from kubeai_tpu_torch.parallel.mesh import Mesh, single_rank_mesh
from kubeai_tpu_torch.parallel.sharding import (
    key_paths,
    llama_fsdp_rules,
    shard_mesh_group,
    shard_mesh_params,
)


def leaves(tree) -> list[torch.Tensor]:
    """Every tensor of a parameter dict (nested dicts walked in order)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def nll_sum(logits, targets, mask) -> torch.Tensor:
    """Σ(nll·mask): the negative log-likelihood of *targets* [B, S] under
    *logits* [B, S, V] summed over the mask = 1 positions, the
    log_softmax in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(ll * mask.float()).sum()


def masked_nll(logits, targets, mask) -> torch.Tensor:
    """Mean negative log-likelihood of *targets* [B, S] under *logits*
    [B, S, V] over the mask = 1 positions, divided by max(mask.sum(), 1):
    the JAX package's formula, the log_softmax in float32."""
    return nll_sum(logits, targets, mask) / torch.clamp(mask.float().sum(), min=1.0)


def positions(tokens, offset: int = 0) -> torch.Tensor:
    """offset + arange(S) for every row of *tokens* [B, S]."""
    B, S = tokens.shape
    pos = torch.arange(offset, offset + S, dtype=torch.int64, device=tokens.device)
    return pos[None, :].expand(B, S)


def loss_fn(params, config: ModelConfig, tokens, targets, mask, mesh=None, ring=False,
            routes=None):
    """Mean next-token cross-entropy over mask = 1 positions.
    tokens / targets / mask: [B, S] (targets already shifted by the
    caller). *routes* as ``llama.apply``'s (a MoE config's routing).

    Over a *mesh* (*ring*: ring attention over its sp axis, else the
    dense arm) the arguments are this rank's [B/dp, S/sp] block of
    the global batch and *params* its block of the parameters; the
    result is the JAX loss of the global batch, the same on every rank,
    whose gradient on this rank is its share (summed over the data ranks
    by :func:`sync_grads`)."""
    if mesh is None:
        logits, _ = llama.apply(params, config, tokens, positions(tokens), routes=routes)
        return masked_nll(logits, targets, mask)
    pos = positions(tokens, mesh.coords["sp"] * tokens.shape[1])
    logits, _ = llama.apply(params, config, tokens, pos, mesh=mesh, ring=ring, routes=routes)
    with torch.no_grad():
        count = mesh.data.all_reduce(mask.float().sum().reshape(1))
    return reduce_from_group(nll_sum(logits, targets, mask) / torch.clamp(count, min=1.0)[0],
                             mesh.data)


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0,
                   foreach: bool | None = None):
    """``optax.adamw(lr, weight_decay=weight_decay)`` as torch AdamW over
    every tensor of *params*. Unlike optax's, a torch optimizer holds the
    tensors it updates, so it takes them when it is built (and holds the
    moments itself: there is no opt_state to pass around). *foreach*
    False updates one tensor at a time (temporaries of one leaf, not of
    the whole tree)."""
    return torch.optim.AdamW(leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, foreach=foreach)


def train_step(params, optimizer, batch, config: ModelConfig, routes=None) -> torch.Tensor:
    """One full-parameter step. batch = {"tokens", "targets", "mask"}, each
    [B, S]. Updates *params* in place and returns the loss (before the
    update). *routes* as :func:`loss_fn`'s."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, config, batch["tokens"], batch["targets"], batch["mask"],
                   routes=routes)
    loss.backward()
    optimizer.step()
    return loss.detach()


def sync_grads(params, config: ModelConfig, mesh: Mesh) -> None:
    """Sum each leaf's gradient share over the ranks that saw other data,
    in place, in the tree's order on every rank: a leaf fsdp splits has
    its dp sum from the gather's reduce-scatter and is summed over sp; any
    other over dp x sp. A MoE router is also summed over ep x tp
    (``mesh.expert``): its products see only this rank's experts, and of
    them only its columns. The experts themselves are never summed over
    ep: each ep rank owns its own."""
    fsdp = llama_fsdp_rules(config)
    for path, leaf in key_paths(params):
        if leaf.grad is None:  # every rank takes part in every sum
            leaf.grad = torch.zeros_like(leaf)
        rule = fsdp["layers"][path[1]] if path[0] == "layers" else fsdp[path[0]]
        group = mesh.sp if rule is not None else mesh.data
        group.all_reduce(leaf.grad, pin=True)
        if path == ("layers", "wr"):
            mesh.expert.all_reduce(leaf.grad, pin=True)


def _mesh_devices(mesh) -> int:
    """Devices of *mesh* (None: one), from its ``shape`` of axis sizes as
    the JAX Mesh gives it."""
    return 1 if mesh is None else math.prod(dict(mesh.shape).values())


def ring_rule(config: ModelConfig, mesh, ring_attention: bool | None) -> bool:
    """Whether the step runs ring attention: *ring_attention*, or when
    None the JAX package's auto rule (sp > 1, no window, no softcap)."""
    if ring_attention is None:
        return (dict(mesh.shape).get("sp", 1) > 1 and config.sliding_window == 0
                and config.attn_softcap == 0.0) if mesh is not None else False
    return bool(ring_attention)


def init_sharded_training(config: ModelConfig, mesh=None, seed: int = 0, lr: float = 1e-4,
                          ring_attention: bool | None = None, device=None, params=None):
    """float32 parameters and their optimizer. Returns (params, optimizer,
    step), ``step(batch)`` one training step returning the loss (the JAX
    package's also returns its opt_state and data sharding: a torch
    optimizer holds its own state, and each rank takes its block itself).

    On one device (*mesh* None or of one device, no ring attention):
    ``llama.init_params`` drawn from *seed* (or *params*, a whole tree)
    on *device* (default cuda), and :func:`train_step` on the batch
    (tensors or numpy arrays, moved to the device).

    Over a mesh (*mesh* this rank's parallel/mesh.py Mesh, from make_mesh
    or run_local_mesh; or ``ring_attention=True`` on one device, a mesh
    of one rank): every rank draws the whole tree from *seed* (or takes
    *params*, a whole tree on any device, as params_from_jax gives the
    JAX package's) and keeps its fsdp x tp block on the mesh's device
    (*device*, if given, must be it). ``step(batch)`` takes the global
    batch {"tokens", "targets", "mask"} [B, S], the same on every rank,
    runs this rank's P("dp", "sp") block, sums the gradients
    (:func:`sync_grads`) and updates the block; each leaf's ``.grad``
    keeps the summed gradient until the next step. *ring_attention* None
    is the JAX package's auto rule (:func:`ring_rule`). For a MoE config,
    ``step.routes`` keeps the last step's (top-k ids, keep) [B, S, k] of
    each layer over the global batch (``llama.apply``'s *routes*).

    *config* must compute in float32: torch's matmul refuses a bf16
    activation against a float32 weight, where JAX promotes it."""
    if config.dtype != "float32":
        raise ValueError(f"init_sharded_training draws float32 parameters; the config computes "
                         f"in {config.dtype} (pass dtype='float32')")
    ring = ring_rule(config, mesh, ring_attention)
    if not isinstance(mesh, Mesh):
        if _mesh_devices(mesh) > 1:
            raise TypeError("a mesh of more than one device is a parallel/mesh.py Mesh, one "
                            "per rank (make_mesh, run_local_mesh)")
        if ring:
            mesh = single_rank_mesh(resolve_device(device))
        else:
            return _init_one_device(config, seed, lr, device, params)
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
            raise ValueError(f"device {device} is not the mesh rank's device {mesh.device}")
    if ring and (config.sliding_window != 0 or config.attn_softcap != 0.0):
        raise ValueError("ring attention does not support sliding windows or softcap")
    dev = mesh.device
    resolve_device(dev)
    if params is None:
        # Each group is cut to this rank's block as soon as it is drawn
        # (a copy: a view would keep the whole group alive).
        shard = llama.init_params(
            config, torch.Generator(device=dev).manual_seed(seed), device=dev,
            dtype=torch.float32,
            keep=lambda path, t: shard_mesh_group(path, t, config, mesh).clone())
    else:  # copies: the caller's tensors are never updated in place
        shard = _tree_map(lambda t: t.detach().to(dev, torch.float32).clone(),
                          shard_mesh_params(params, config, mesh))
    for t in leaves(shard):
        t.requires_grad_(True)
    # One leaf's temporaries at a time: ranks sharing a card would each
    # hold a tree-sized one in the foreach update.
    optimizer = make_optimizer(shard, lr, foreach=False)
    cuda = dev.type == "cuda"

    def step(batch):
        """One step. ``step.phases`` keeps its host seconds by phase and,
        on a card, the bytes the card's allocator held at each phase's
        end (every rank on that card counted)."""
        t, held = [time.perf_counter()], []

        def mark():
            t.append(time.perf_counter())
            if cuda:
                held.append(torch.cuda.memory_allocated(dev))

        block = {k: torch.as_tensor(mesh.block(v)).to(dev) for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        step.routes = [] if config.num_experts > 0 else None
        loss = loss_fn(shard, config, block["tokens"], block["targets"], block["mask"],
                       mesh=mesh, ring=ring, routes=step.routes)
        mark()
        loss.backward()
        mark()
        sync_grads(shard, config, mesh)
        mark()
        optimizer.step()
        mark()
        names = ("forward", "backward", "grad_sum", "update")
        step.phases = {f"{n}_s": b - a for n, a, b in zip(names, t, t[1:])}
        step.phases.update({f"{n}_held_bytes": h for n, h in zip(names, held)})
        return loss.detach()

    return shard, optimizer, step


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _init_one_device(config, seed, lr, device, params):
    dev = resolve_device(device)
    if params is None:
        params = llama.init_params(config, torch.Generator(device=dev).manual_seed(seed),
                                   device=dev, dtype=torch.float32)
    else:
        params = _tree_map(lambda t: t.detach().to(dev, torch.float32).clone(), params)
    for t in leaves(params):
        t.requires_grad_(True)
    optimizer = make_optimizer(params, lr)

    def step(batch):
        step.routes = [] if config.num_experts > 0 else None
        return train_step(params, optimizer, {k: torch.as_tensor(v).to(dev)
                                              for k, v in batch.items()}, config, step.routes)

    return params, optimizer, step
