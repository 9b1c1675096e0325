"""The (dp, sp, ep, tp) mesh of process groups (port of
kubeai_tpu/parallel/mesh.py).

The JAX package builds one Mesh of devices with the axes ("dp", "sp",
"ep", "tp") and lets XLA place the collectives. Here every rank is one
process (or, in the tests and the card check, one thread) and holds a
:class:`Mesh`: its place in the layout ``np.arange(n).reshape(dp, sp, ep,
tp)`` (rank r sits where device r sits in ``make_mesh``'s fallback
layout) and, for each axis, a parallel/group.py ``TPGroup`` over the
ranks that differ from it only along that axis, each over its own store
prefix. A fifth group spans (dp, sp): the ranks that see different data,
over which the loss and the gradients are summed. A sixth spans (ep,
tp): the ranks that hold other parts of the same tokens' experts, over
which a MoE layer's partial outputs are summed in one collective (it is
the ep or the tp group itself when the other axis has size 1). An axis
of size 1 has a group of one rank and no process group.

Axes, as in the JAX package: dp data parallel (and fsdp's parameter
split), sp sequence parallel (ring attention), ep expert parallel, tp
tensor parallel (Megatron). A mesh always has all four.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from kubeai_tpu_torch.parallel.group import (
    DEFAULT_COORDINATOR_PORT,
    TPGroup,
    choose_backend,
    make_process_group,
    run_threads,
)

AXES = ("dp", "sp", "ep", "tp")


def mesh_shape(shape=None, **axes) -> dict[str, int]:
    """{axis: size} for all four axes (missing ones 1), from a dict or
    keywords."""
    sizes = dict(shape or {}, **axes)
    unknown = set(sizes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)} (axes: {AXES})")
    out = {a: int(sizes.get(a, 1)) for a in AXES}
    if any(n < 1 for n in out.values()):
        raise ValueError(f"mesh axis sizes must be >= 1, got {out}")
    return out


def mesh_layout(shape: dict[str, int]) -> np.ndarray:
    """The ranks laid out [dp, sp, ep, tp], as make_mesh lays out devices
    when it reshapes them itself."""
    return np.arange(int(np.prod([shape[a] for a in AXES]))).reshape(
        *(shape[a] for a in AXES))


def group_ranks(shape: dict[str, int], rank: int, axes: tuple[str, ...]) -> list[int]:
    """The ranks that share *rank*'s coordinates on every axis but *axes*,
    in the order of their coordinates on *axes* (dp before sp)."""
    layout = mesh_layout(shape)
    coords = np.unravel_index(rank, layout.shape)
    index = tuple(slice(None) if a in axes else int(c) for a, c in zip(AXES, coords))
    return [int(r) for r in layout[index].reshape(-1)]


class Mesh:
    """One rank's view of the mesh: ``shape`` (axis name -> size, as the
    JAX Mesh exposes it), ``rank``, ``coords`` (axis -> this rank's index
    on it), ``device``, ``backend``, ``groups`` (axis -> its group; also
    the ``dp``, ``sp``, ``ep`` and ``tp`` properties), ``data``, the group
    over (dp, sp), and ``expert``, the group over (ep, tp)."""

    axis_names = AXES

    def __init__(self, shape: dict[str, int], rank: int, device, backend: str,
                 groups: dict[str, TPGroup], data: TPGroup, expert: TPGroup):
        self.shape = dict(shape)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.backend = backend
        layout = mesh_layout(self.shape)
        self.coords = {a: int(c) for a, c in zip(AXES, np.unravel_index(self.rank, layout.shape))}
        self.groups = groups
        self.data = data
        self.expert = expert

    @property
    def dp(self) -> TPGroup:
        return self.groups["dp"]

    @property
    def sp(self) -> TPGroup:
        return self.groups["sp"]

    @property
    def ep(self) -> TPGroup:
        return self.groups["ep"]

    @property
    def tp(self) -> TPGroup:
        return self.groups["tp"]

    def all_groups(self) -> list[TPGroup]:
        """Every distinct group of this rank (the axes', data, expert)."""
        out: list[TPGroup] = []
        for g in [*self.groups.values(), self.data, self.expert]:
            if all(g is not o for o in out):
                out.append(g)
        return out

    def block(self, a):
        """This rank's P("dp", "sp") block of a global [B, S, ...] array
        (numpy or torch): rows split over dp, columns over sp."""
        cuts = []
        for what, n, axis in (("batch", a.shape[0], "dp"), ("sequence", a.shape[1], "sp")):
            k = self.shape[axis]
            if n % k:
                raise ValueError(f"the {what} dimension ({n}) must be divisible by its mesh "
                                 f"axis size ({k})")
            c = self.coords[axis]
            cuts.append(slice(c * (n // k), (c + 1) * (n // k)))
        return a[cuts[0], cuts[1]]

    def gather_blocks(self, t: torch.Tensor) -> torch.Tensor:
        """The global [B, S, ...] tensor from every data rank's P("dp",
        "sp") block *t* [B/dp, S/sp, ...] (all-gathered over ``data``,
        outside autograd). Under sp > 1 a rank's rows are not a
        contiguous run of the global tokens b*S + s, so the blocks are
        placed by their (dp, sp) coordinates, not concatenated."""
        dp, sp = self.shape["dp"], self.shape["sp"]
        if dp * sp == 1:
            return t
        Bl, Sl, *rest = t.shape
        parts = self.data.all_gather_dim(t.contiguous()[None], 0)  # [dp*sp, Bl, Sl, ...]
        parts = parts.reshape(dp, sp, Bl, Sl, *rest).transpose(1, 2)
        return parts.reshape(dp * Bl, sp * Sl, *rest)


def build_mesh(store, rank: int, shape: dict[str, int], device, backend: str,
               timeout: float = 300.0) -> Mesh:
    """This rank's Mesh over *store*: a process group per axis of size > 1
    and one over (dp, sp) and (ep, tp) each, each under its own store
    prefix. Every rank builds its groups in the same order (gloo connects
    a group's members when it is built)."""
    shape = mesh_shape(shape)
    device = torch.device(device)
    groups: dict[str, TPGroup] = {}
    both = shape["ep"] > 1 and shape["tp"] > 1  # else (ep, tp) is one axis's group
    for axes in [(a,) for a in AXES] + [("dp", "sp")] + [("ep", "tp")] * both:
        members = group_ranks(shape, rank, axes)
        n, me = len(members), members.index(rank)
        pg = None
        if n > 1:
            prefix = f"kubeai-mesh/{'x'.join(axes)}/{members[0]}"
            pg = make_process_group(store, me, n, backend, timeout, prefix=prefix)
        group = TPGroup(me, n, device, pg, backend)
        group.axis = "x".join(axes)
        group.members = members
        groups["x".join(axes)] = group
    data = groups.pop("dpxsp")
    expert = groups.pop("epxtp") if both else groups["tp" if shape["ep"] == 1 else "ep"]
    return Mesh(shape, rank, device, backend, groups, data, expert)


def single_rank_mesh(device) -> Mesh:
    """A mesh of one rank (every axis 1): no process group at all."""
    return build_mesh(None, 0, mesh_shape(), device, "gloo")


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, ep: int = 1, rank: int = 0,
              device=None, backend: str | None = None, host: str = "127.0.0.1",
              port: int = DEFAULT_COORDINATOR_PORT, timeout: float = 300.0) -> Mesh:
    """This process's rank of a (dp, sp, ep, tp) mesh of one process per
    rank, meeting through a TCPStore at *host*:*port* (rank 0 serves it).
    *device* defaults to cuda:<rank mod cards>; *backend* to nccl when
    every rank on this host has a card of its own, else gloo
    (choose_backend)."""
    shape = mesh_shape(dp=dp, sp=sp, ep=ep, tp=tp)
    n = int(np.prod(list(shape.values())))
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n} ranks")
    if device is None:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass device='cpu'")
        device = torch.device("cuda", rank % cards)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        backend = choose_backend(device, n, cards)
    store = dist.TCPStore(host, int(port), n, rank == 0, datetime.timedelta(seconds=timeout))
    mesh = build_mesh(store, rank, shape, device, backend, timeout)
    mesh.store = store  # rank 0's serves the others: it lives as long as the mesh
    return mesh


def run_local_mesh(shape, fn, devices, backend: str = "gloo", timeout: float = 300.0) -> list:
    """Run ``fn(mesh)`` for every rank of a mesh of *shape* (a dict of
    axis sizes), each rank on its own thread over one in-process store,
    and return the results in rank order (the first rank's exception is
    raised). *devices* is one device, or one per rank. For the tests and
    the card check on one machine; a job of one process per rank calls
    :func:`make_mesh`."""
    shape = mesh_shape(shape)
    n = int(np.prod(list(shape.values())))
    store = dist.HashStore()

    def rank_fn(rank, dev):
        return fn(build_mesh(store, rank, shape, dev, backend, timeout))

    return run_threads(n, rank_fn, devices, timeout, name="mesh-rank")
