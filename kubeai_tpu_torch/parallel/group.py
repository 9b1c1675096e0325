"""The tensor-parallel process group (the counterpart of
kubeai_tpu/parallel/mesh.py).

The JAX package lays PartitionSpecs over a device mesh and lets XLA
insert the collectives. Here each rank is one process (or, in the CPU
tests, one thread) driving one device, and the model calls the two
collectives Megatron's split needs itself, on a :class:`TPGroup` passed
in: an all-reduce of the row-parallel partial sums and an all-gather of
the vocab-sharded logits. The group object is built directly
(``ProcessGroupNCCL`` / ``ProcessGroupGloo`` over a store), never the
process's default group, so two ranks can live in one process.

Backend follows placement, and the caller states it:

- ``nccl`` when every rank has a card of its own;
- ``gloo`` on the CPU, and when ranks share a card (a check on a
  one-card machine). Gloo moves CUDA tensors through host memory here,
  explicitly: the stream is synchronized, the tensor copied to the host,
  reduced or gathered there, and copied back. So a gloo group's
  collectives cannot be captured in a CUDA graph, and the engine runs
  its decode chunk eagerly under gloo (:attr:`TPGroup.graphable`).

A failed NCCL initialisation raises; nothing retries on gloo.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

from kubeai_tpu_torch.obs.logs import get_logger

log = get_logger("kubeai_tpu_torch.parallel")

DEFAULT_COORDINATOR_PORT = 8476


def choose_backend(device: torch.device, ranks_on_host: int, cards_on_host: int) -> str:
    """``nccl`` when this host's ranks each have a card of their own,
    else ``gloo`` (the CPU, or ranks sharing a card)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if ranks_on_host <= cards_on_host else "gloo"


class TPGroup:
    """One rank's view of a tensor-parallel group: its rank, the world
    size, its device, the backend and the process-group object. The
    collectives keep a count and the host seconds spent in them
    (``stats``), which the gang's step breakdown reads."""

    def __init__(self, rank: int, world_size: int, device: torch.device | str, pg,
                 backend: str):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device)
        self.pg = pg
        self.backend = backend
        self.stats = {"all_reduce": [0, 0.0], "all_gather": [0, 0.0]}

    @property
    def staged(self) -> bool:
        """Collectives of CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def graphable(self) -> bool:
        """Whether a CUDA graph may capture this group's collectives."""
        return self.backend == "nccl"

    def describe(self) -> dict:
        return {"rank": self.rank, "world_size": self.world_size, "backend": self.backend,
                "device": str(self.device), "host_staged": self.staged,
                "collectives": {k: {"calls": n, "seconds": s}
                                for k, (n, s) in self.stats.items()}}

    def _count(self, kind: str, t0: float) -> None:
        entry = self.stats[kind]
        entry[0] += 1
        entry[1] += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum *t* over the group, in place; returns *t*."""
        if self.world_size == 1:
            return t
        if self.staged:
            torch.cuda.current_stream(t.device).synchronize()
            t0 = time.perf_counter()
            host = t.to("cpu")
            self.pg.allreduce([host]).wait()
            t.copy_(host)
            torch.cuda.current_stream(t.device).synchronize()
        else:
            t0 = time.perf_counter()
            self.pg.allreduce([t]).wait()
        self._count("all_reduce", t0)
        return t

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' *t* [..., n] side by side on the last dim, in rank
        order: [..., world_size * n]."""
        if self.world_size == 1:
            return t
        W = self.world_size
        src = t.contiguous()
        if self.staged:
            torch.cuda.current_stream(t.device).synchronize()
            t0 = time.perf_counter()
            host = src.to("cpu")
            out = torch.empty((W * host.numel(),), dtype=host.dtype)
            self.pg._allgather_base(out, host.reshape(-1)).wait()
            out = out.to(t.device)
            torch.cuda.current_stream(t.device).synchronize()
        else:
            t0 = time.perf_counter()
            out = torch.empty((W * src.numel(),), dtype=src.dtype, device=src.device)
            self.pg._allgather_base(out, src.reshape(-1)).wait()
        self._count("all_gather", t0)
        out = out.view(W, *t.shape).movedim(0, -2)
        return out.reshape(*t.shape[:-1], W * t.shape[-1])


def make_process_group(store, rank: int, world_size: int, backend: str,
                       timeout: float = 300.0):
    """A process group of *backend* over *store* (its own prefix), not
    registered as the process's default group."""
    td = datetime.timedelta(seconds=timeout)
    store = dist.PrefixStore("kubeai-tp", store)
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, world_size, td)
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("backend nccl was chosen (a card per rank) but this torch "
                               "has no NCCL")
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        return dist.ProcessGroupNCCL(store, rank, world_size, opts)
    raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")


def init_tp_group(rank: int, world_size: int, device: torch.device | str, backend: str,
                  host: str = "127.0.0.1", port: int = DEFAULT_COORDINATOR_PORT,
                  timeout: float = 300.0) -> TPGroup:
    """Rendezvous of *world_size* ranks through a TCPStore at
    *host*:*port* (rank 0 serves it) and this rank's group. Under nccl
    the first all-reduce runs here, so a failed NCCL initialisation
    raises at start, not at the first request."""
    device = torch.device(device)
    store = dist.TCPStore(host, int(port), world_size, rank == 0,
                          datetime.timedelta(seconds=timeout))
    pg = make_process_group(store, rank, world_size, backend, timeout)
    group = TPGroup(rank, world_size, device, pg, backend)
    # The store lives as long as the group (rank 0's serves the others).
    group.store = store
    probe = torch.ones((1,), device=device)
    group.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"tp group rendezvous: all-reduce of ones gave {probe.item()}, "
                           f"expected {world_size}")
    group.stats["all_reduce"] = [0, 0.0]
    log.info("tp group: rank %d/%d on %s, backend %s%s", rank, world_size, device, backend,
             " (host-staged)" if group.staged else "")
    return group


def run_local_ranks(world_size: int, fn, devices, backend: str = "gloo",
                    timeout: float = 120.0) -> list:
    """Run ``fn(group)`` for every rank of a *world_size* group, each rank
    on its own thread with its own process group over one in-process
    store, and return the results in rank order (the first rank's
    exception is raised). *devices* is one device, or one per rank. For
    checks and tests on one machine; a served gang has a process per
    rank (init_tp_group)."""
    import threading

    if not isinstance(devices, (list, tuple)):
        devices = [devices] * world_size
    store = dist.HashStore()
    results: list = [None] * world_size
    errors: list = [None] * world_size

    def run(rank):
        try:
            dev = torch.device(devices[rank])
            if dev.type == "cuda" and dev.index is not None:
                torch.cuda.set_device(dev)
            pg = make_process_group(store, rank, world_size, backend, timeout)
            results[rank] = fn(TPGroup(rank, world_size, dev, pg, backend))
        except BaseException as e:  # re-raised on the caller's thread
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,), name=f"tp-rank-{r}", daemon=True)
               for r in range(world_size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(f"{t.name} did not finish within {timeout} s")
    for e in errors:
        if e is not None:
            raise e
    return results
