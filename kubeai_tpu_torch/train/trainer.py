"""The one-card training step (port of the mesh-free part of
kubeai_tpu/train/trainer.py).

The loss is the JAX package's: next-token cross-entropy over mask = 1
positions of the cache-less forward (``models/llama.py::apply``, plain
attention in float32), through torch autograd where JAX differentiates
with ``jax.value_and_grad``. ``torch.optim.AdamW`` takes optax.adamw's
place with its defaults (b1 0.9, b2 0.999, eps 1e-8; both decouple the
weight decay and correct the moments' bias).

Left out (ROADMAP queue 1 item 12b): the JAX step's fsdp + tp + sp
sharding over a mesh and ring attention over its sp axis; a mesh of more
than one device, ``ring_attention=True`` or a ``ring_mesh`` raise naming
it.
"""

from __future__ import annotations

import math

import torch

from kubeai_tpu_torch import resolve_device
from kubeai_tpu_torch.models import llama
from kubeai_tpu_torch.models.base import ModelConfig


def leaves(tree) -> list[torch.Tensor]:
    """Every tensor of a parameter dict (nested dicts walked in order)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def masked_nll(logits, targets, mask) -> torch.Tensor:
    """Mean negative log-likelihood of *targets* [B, S] under *logits*
    [B, S, V] over the mask = 1 positions, divided by max(mask.sum(), 1):
    the JAX package's formula, the log_softmax in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    m = mask.float()
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def positions(tokens) -> torch.Tensor:
    """arange(S) for every row of *tokens* [B, S]."""
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int64, device=tokens.device)[None, :].expand(B, S)


def loss_fn(params, config: ModelConfig, tokens, targets, mask, ring_mesh=None):
    """Mean next-token cross-entropy over mask = 1 positions.
    tokens / targets / mask: [B, S] (targets already shifted by the
    caller). A *ring_mesh* raises (ROADMAP queue 1 item 12b)."""
    logits, _ = llama.apply(params, config, tokens, positions(tokens), ring_mesh=ring_mesh)
    return masked_nll(logits, targets, mask)


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0):
    """``optax.adamw(lr, weight_decay=weight_decay)`` as torch AdamW over
    every tensor of *params*. Unlike optax's, a torch optimizer holds the
    tensors it updates, so it takes them when it is built (and holds the
    moments itself: there is no opt_state to pass around)."""
    return torch.optim.AdamW(leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def train_step(params, optimizer, batch, config: ModelConfig) -> torch.Tensor:
    """One full-parameter step. batch = {"tokens", "targets", "mask"}, each
    [B, S]. Updates *params* in place and returns the loss (before the
    update)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, config, batch["tokens"], batch["targets"], batch["mask"])
    loss.backward()
    optimizer.step()
    return loss.detach()


def _mesh_devices(mesh) -> int:
    """Devices of *mesh* (None: one), from its ``shape`` of axis sizes as
    the JAX Mesh gives it."""
    return 1 if mesh is None else math.prod(dict(mesh.shape).values())


def init_sharded_training(config: ModelConfig, mesh=None, seed: int = 0, lr: float = 1e-4,
                          ring_attention: bool | None = None, device=None):
    """float32 parameters from ``llama.init_params`` (drawn from *seed*)
    and their optimizer on one device (default cuda). Returns (params,
    optimizer, step), ``step(batch)`` one :func:`train_step` returning the
    loss; the JAX package's also returns its opt_state and data sharding,
    which one device has no use for.

    *config* must compute in float32: torch's matmul refuses a bf16
    activation against a float32 weight, where JAX promotes it. A *mesh*
    of more than one device and ``ring_attention=True`` raise (ROADMAP
    queue 1 item 12b); None is off on one device, as
    the JAX package's auto rule (sp > 1) gives."""
    if _mesh_devices(mesh) > 1:
        raise NotImplementedError(
            "training over a mesh of more than one device is not ported yet "
            "(ROADMAP queue 1 item 12b)")
    if ring_attention:
        raise NotImplementedError("ring attention is not ported yet (ROADMAP queue 1 item 12b)")
    if config.dtype != "float32":
        raise ValueError(f"init_sharded_training draws float32 parameters; the config computes "
                         f"in {config.dtype} (pass dtype='float32')")
    dev = resolve_device(device)
    params = llama.init_params(config, torch.Generator(device=dev).manual_seed(seed), device=dev,
                               dtype=torch.float32)
    for t in leaves(params):
        t.requires_grad_(True)
    optimizer = make_optimizer(params, lr)

    def step(batch):
        return train_step(params, optimizer, batch, config)

    return params, optimizer, step
