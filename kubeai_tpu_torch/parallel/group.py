"""Process groups and their collectives (with parallel/mesh.py, the
counterpart of kubeai_tpu/parallel/mesh.py).

The JAX package lays PartitionSpecs over a device mesh and lets XLA
insert the collectives. Here each rank is one process (or, in the CPU
tests, one thread) driving one device, and the model calls the
collectives itself, on a :class:`TPGroup` passed in: serving's
tensor-parallel split needs an all-reduce of the row-parallel partial
sums and an all-gather of the vocab-sharded logits. The group object is
built directly (``ProcessGroupNCCL`` / ``ProcessGroupGloo`` over a
store), never the process's default group, so two ranks can live in one
process.

Training over a mesh (parallel/mesh.py, one such group per axis) needs
collectives that a gradient can pass through, ``torch.autograd.Function``
s at the end of this module: Megatron's pair (:func:`copy_to_group`,
:func:`reduce_from_group`), the fsdp gather whose backward
reduce-scatters (:func:`all_gather_grad`, :func:`fsdp_gather`), the
vocab gather of the logits whose backward takes this rank's slice
(:func:`gather_last_grad`) and ring attention's pass to the next rank
(:func:`ring_shift_grad`).

Backend follows placement, and the caller states it:

- ``nccl`` when every rank has a card of its own;
- ``gloo`` on the CPU, and when ranks share a card (a check on a
  one-card machine). Gloo moves CUDA tensors through host memory here,
  explicitly: the stream is synchronized, the tensor copied to the host,
  reduced or gathered there, and copied back. So a gloo group's
  collectives cannot be captured in a CUDA graph, and the engine runs
  its decode chunk eagerly under gloo (:attr:`TPGroup.graphable`);
- ``threads`` when the ranks are threads of one process (run_local_ranks,
  run_local_mesh): gloo's host staging, with the host tensors exchanged
  in the process's memory (:class:`ThreadGroup`) instead of over
  loopback TCP. Sums run in rank order.

A failed NCCL initialisation raises; nothing retries on gloo.
"""

from __future__ import annotations

import datetime
import queue
import threading
import time

import torch
import torch.distributed as dist

from kubeai_tpu_torch.obs.logs import get_logger

log = get_logger("kubeai_tpu_torch.parallel")

DEFAULT_COORDINATOR_PORT = 8476
# The collectives a group counts in ``stats``: calls and host seconds.
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "ring_pass")
# Backends whose collectives run on host tensors: a CUDA tensor is staged.
HOST_BACKENDS = ("gloo", "threads")


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of *t*: into pinned memory when *t* is on a card (a
    direct DMA, several times the rate of a copy to pageable memory; the
    caching host allocator keeps the blocks for the next copy)."""
    if t.device.type != "cuda":
        return t.cpu()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _pinned(t: torch.Tensor) -> bool:
    """Whether a host result computed from *t* should be pinned too: the
    staged autograd collectives hand pinned copies in, and their results
    go back to the card."""
    return t.device.type == "cpu" and torch.cuda.is_available() and t.is_pinned()


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
        self.stats = {k: [0, 0.0] for k in COLLECTIVES}

    @property
    def staged(self) -> bool:
        """Collectives of CUDA tensors go through host memory (gloo,
        threads)."""
        return self.backend in HOST_BACKENDS and self.device.type == "cuda"

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

    def _staged_for(self, t: torch.Tensor) -> bool:
        return self.backend in HOST_BACKENDS and t.device.type == "cuda"

    def _stage(self, t: torch.Tensor, pin: bool) -> torch.Tensor:
        """The host copy a staged collective sends: pinned for the mesh
        trainer's collectives (*pin*), pageable for serving's, whose
        staging stays as the gang was measured with."""
        return to_host(t) if pin else t.to("cpu")

    def all_reduce(self, t: torch.Tensor, pin: bool = False) -> torch.Tensor:
        """Sum *t* over the group, in place; returns *t*. *pin*: stage a
        CUDA tensor through pinned host memory (see :meth:`_stage`)."""
        if self.world_size == 1:
            return t
        if self._staged_for(t):
            torch.cuda.current_stream(t.device).synchronize()
            t0 = time.perf_counter()
            host = self._stage(t, pin)
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
        return self.all_gather_dim(t, -1)

    def all_gather_dim(self, t: torch.Tensor, dim: int, pin: bool = False) -> torch.Tensor:
        """The ranks' *t* side by side on *dim*, in rank order (its size
        times world_size). *pin* as for :meth:`all_reduce`."""
        if self.world_size == 1:
            return t
        W = self.world_size
        src = t.contiguous()
        if self._staged_for(t):
            torch.cuda.current_stream(t.device).synchronize()
            t0 = time.perf_counter()
            host = self._stage(src, pin)
            out = torch.empty((W * host.numel(),), dtype=host.dtype, pin_memory=pin)
            self.pg._allgather_base(out, host.reshape(-1)).wait()
            out = out.to(t.device)
            torch.cuda.current_stream(t.device).synchronize()
        else:
            t0 = time.perf_counter()
            out = torch.empty((W * src.numel(),), dtype=src.dtype, device=src.device,
                              pin_memory=_pinned(src))
            self.pg._allgather_base(out, src.reshape(-1)).wait()
        self._count("all_gather", t0)
        dim = dim % t.dim()
        out = out.view(W, *t.shape).movedim(0, dim)
        return out.reshape(*t.shape[:dim], W * t.shape[dim], *t.shape[dim + 1:])

    def reduce_scatter_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block on *dim* of the sum of the ranks' *t*: block r
        is ``t.narrow(dim, r * n, n)`` with n = size / world_size."""
        if self.world_size == 1:
            return t
        W = self.world_size
        dim = dim % t.dim()
        n = t.shape[dim]
        if n % W:
            raise ValueError(f"reduce-scatter over {W} ranks of a dimension of size {n}")
        blocks = t.unflatten(dim, (W, n // W)).movedim(dim, 0).contiguous()
        shape = blocks.shape[1:]
        if self._staged_for(t):
            torch.cuda.current_stream(t.device).synchronize()
            t0 = time.perf_counter()
            host = to_host(blocks)
            out = torch.empty((host.numel() // W,), dtype=host.dtype, pin_memory=True)
            self.pg._reduce_scatter_base(out, host.reshape(-1)).wait()
            out = out.to(t.device)
            torch.cuda.current_stream(t.device).synchronize()
        else:
            t0 = time.perf_counter()
            out = torch.empty((blocks.numel() // W,), dtype=t.dtype, device=t.device,
                              pin_memory=_pinned(t))
            self.pg._reduce_scatter_base(out, blocks.reshape(-1)).wait()
        self._count("reduce_scatter", t0)
        return out.view(shape)

    def ring_shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """*t* sent to rank + *step* and the tensor of rank - *step*
        received, around the ring. Under gloo both are posted before
        either is waited on, so no rank blocks the ring. Under nccl even
        ranks send first and odd ranks receive first (blocking sends in
        one order would hang the stream); that path has no second card
        here to run on."""
        if self.world_size == 1:
            return t
        W, r = self.world_size, self.rank
        dst, src = (r + step) % W, (r - step) % W
        send = t.contiguous()
        if self._staged_for(t):
            torch.cuda.current_stream(t.device).synchronize()
            t0 = time.perf_counter()
            send = to_host(send)
        else:
            t0 = time.perf_counter()
        recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                           pin_memory=_pinned(send))
        ops = [lambda: self.pg.recv([recv], src, 0), lambda: self.pg.send([send], dst, 0)]
        if self.backend == "nccl" and r % 2 == 0:
            ops.reverse()
        for w in [op() for op in ops]:
            w.wait()
        if recv.device != t.device:
            recv = recv.to(t.device)
            torch.cuda.current_stream(t.device).synchronize()
        self._count("ring_pass", t0)
        return recv


def make_process_group(store, rank: int, world_size: int, backend: str,
                       timeout: float = 300.0, prefix: str = "kubeai-tp"):
    """A process group of *backend* over *store* (under its own *prefix*),
    not registered as the process's default group."""
    if backend == "threads":
        return ThreadGroup(_thread_hub(store, prefix, world_size), rank, timeout)
    td = datetime.timedelta(seconds=timeout)
    store = dist.PrefixStore(prefix, store)
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, world_size, td)
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("backend nccl was chosen (a card per rank) but this torch "
                               "has no NCCL")
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        return dist.ProcessGroupNCCL(store, rank, world_size, opts)
    raise ValueError(f"unknown backend {backend!r} (nccl, gloo or threads)")


class _Done:
    """A collective that ended in its call: ``wait()`` returns at once."""

    def wait(self):
        return True


class _Recv:
    """A receive posted by :meth:`ThreadGroup.recv`; ``wait()`` takes the
    sender's tensor from the mailbox into the posted one."""

    def __init__(self, box: queue.Queue, out: torch.Tensor, timeout: float):
        self.box, self.out, self.timeout = box, out, timeout

    def wait(self):
        try:
            self.out.copy_(self.box.get(timeout=self.timeout))
        except queue.Empty:
            raise RuntimeError(f"threads group: no send within {self.timeout} s") from None
        return True


class _ThreadHub:
    """What the ranks of one thread group share: a slot per rank, a
    barrier, and a mailbox per (source, destination, tag)."""

    def __init__(self, n: int):
        self.n = n
        self.slots: list = [None] * n
        self.sums: list = [None] * n
        self.barrier = threading.Barrier(n)
        self.joined = 0
        self.lock = threading.Lock()
        self.boxes: dict[tuple[int, int, int], queue.Queue] = {}

    def box(self, src: int, dst: int, tag: int) -> queue.Queue:
        with self.lock:
            return self.boxes.setdefault((src, dst, tag), queue.Queue())


_HUBS: dict[tuple[int, str], _ThreadHub] = {}
_HUBS_LOCK = threading.Lock()


def _thread_hub(store, prefix: str, n: int) -> _ThreadHub:
    """The hub of the group under *prefix* of *store*: made by its first
    rank, dropped from the registry once all *n* have it."""
    key = (id(store), prefix)
    with _HUBS_LOCK:
        hub = _HUBS.get(key)
        if hub is None:
            hub = _HUBS[key] = _ThreadHub(n)
        hub.joined += 1
        if hub.joined == n:
            del _HUBS[key]
    return hub


class ThreadGroup:
    """The process-group calls TPGroup makes (``allreduce``,
    ``_allgather_base``, ``_reduce_scatter_base``, ``send``, ``recv``) for
    ranks that are threads of one process, on host tensors: each rank
    puts its tensor in the hub and, past a barrier, reads the others'.
    Every element is summed in rank order, so all ranks get the same
    bits. A rank that does not arrive within *timeout* breaks the barrier
    and every rank raises."""

    def __init__(self, hub: _ThreadHub, rank: int, timeout: float):
        self.hub, self.rank, self.timeout = hub, rank, timeout

    def _wait(self):
        try:
            self.hub.barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            raise RuntimeError(f"threads group: a rank did not arrive within "
                               f"{self.timeout} s") from None

    def _post(self, t: torch.Tensor) -> list:
        """Every rank's *t*, in rank order."""
        self.hub.slots[self.rank] = t
        self._wait()
        return list(self.hub.slots)

    def _bounds(self, r: int, numel: int) -> tuple[int, int]:
        """Rank *r*'s block of an all-reduce over *numel* elements."""
        n = -(-numel // self.hub.n)
        return min(r * n, numel), min((r + 1) * n, numel)

    def allreduce(self, tensors):
        (t,) = tensors
        flat = t.view(-1)
        got = [g.view(-1) for g in self._post(t)]
        lo, hi = self._bounds(self.rank, flat.numel())
        part = got[0][lo:hi].clone()
        for g in got[1:]:
            part += g[lo:hi]
        self.hub.sums[self.rank] = part
        self._wait()  # every block summed: the inputs may be overwritten
        for r, part in enumerate(list(self.hub.sums)):
            lo, hi = self._bounds(r, flat.numel())
            flat[lo:hi].copy_(part)
        self._wait()  # every rank has every block
        return _Done()

    def _allgather_base(self, out, inp):
        got = self._post(inp)
        n = inp.numel()
        for r, g in enumerate(got):
            out[r * n:(r + 1) * n].copy_(g.view(-1))
        self._wait()
        return _Done()

    def _reduce_scatter_base(self, out, inp):
        got = [g.view(-1) for g in self._post(inp)]
        n = out.numel()
        lo, hi = self.rank * n, (self.rank + 1) * n
        out.copy_(got[0][lo:hi])
        for g in got[1:]:
            out += g[lo:hi]
        self._wait()
        return _Done()

    def send(self, tensors, dst: int, tag: int = 0):
        (t,) = tensors
        self.hub.box(self.rank, dst, tag).put(t.clone())
        return _Done()

    def recv(self, tensors, src: int, tag: int = 0):
        (t,) = tensors
        return _Recv(self.hub.box(src, self.rank, tag), t, self.timeout)


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
    store = dist.HashStore()

    def rank_fn(rank, dev):
        pg = make_process_group(store, rank, world_size, backend, timeout)
        return fn(TPGroup(rank, world_size, dev, pg, backend))

    return run_threads(world_size, rank_fn, devices, timeout, name="tp-rank")


def run_threads(n: int, fn, devices, timeout: float, name: str = "rank") -> list:
    """``fn(rank, device)`` for ranks 0..n-1, each on its own thread (its
    current CUDA device set to its own), and the results in rank order;
    the first rank's exception is raised on the caller's thread."""
    import threading

    if not isinstance(devices, (list, tuple)):
        devices = [devices] * n
    results: list = [None] * n
    errors: list = [None] * n

    def run(rank):
        try:
            dev = torch.device(devices[rank])
            if dev.type == "cuda" and dev.index is not None:
                torch.cuda.set_device(dev)
            results[rank] = fn(rank, dev)
        except BaseException as e:  # re-raised on the caller's thread
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,), name=f"{name}-{r}", daemon=True)
               for r in range(n)]
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


# ---------------------------------------------------------------------------
# Collectives that autograd passes through
#
# Each is a torch.autograd.Function over the collectives above. Under a
# host-staged group (gloo, CUDA tensors) the Function runs on host
# copies, its input moved to the host and its output back to the card by
# ordinary differentiable copies: every grad that reaches the Function's
# backward is then a host tensor, so the autograd engine runs that
# backward on the thread that called backward(), never on the device's
# own autograd thread, which all thread ranks sharing a card share (a
# blocking collective there would wait for a rank queued behind it).
# Every collective of a backward pass lies on the chain of the
# activations' gradient (fsdp_gather passes the layer's input through
# for that reason), so every rank meets them in one order. A Function
# whose backward has no collective (Megatron's g, the logits' vocab
# gather) stages inside its forward instead and keeps its backward on
# the card.


class _ToHost(torch.autograd.Function):
    """A card tensor's host copy (pinned); the gradient goes back to the
    card."""

    @staticmethod
    def forward(ctx, x):
        ctx.device = x.device
        return to_host(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.device)


class _ToDevice(torch.autograd.Function):
    """A host tensor on the card; the gradient comes back to pinned host
    memory (the copy the card's autograd thread makes for every rank)."""

    @staticmethod
    def forward(ctx, x, device):
        return x.to(device)

    @staticmethod
    def backward(ctx, g):
        return to_host(g), None


def _host_apply(fn, group: TPGroup, consts: tuple, *tensors):
    """``fn.apply(group, *consts, *tensors)``, on host copies of the
    tensors under a staged group; the outputs come back on their device."""
    if not group._staged_for(tensors[0]):
        return fn.apply(group, *consts, *tensors)
    dev = tensors[0].device
    out = fn.apply(group, *consts, *(_ToHost.apply(t) for t in tensors))
    if isinstance(out, tuple):
        return tuple(_ToDevice.apply(o, dev) for o in out)
    return _ToDevice.apply(out, dev)


def _solo(group: TPGroup | None) -> bool:
    return group is None or group.world_size == 1


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group.all_reduce(g.contiguous().clone())


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity gradient."""

    @staticmethod
    def forward(ctx, group, x):
        return group.all_reduce(x.contiguous().clone(), pin=True)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _AllGatherDim(torch.autograd.Function):
    """All-gather on a dim; the gradient is reduce-scattered back."""

    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim = group, dim
        return group.all_gather_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.group.reduce_scatter_dim(g, ctx.dim)


class _GatherLast(torch.autograd.Function):
    """All-gather on the last dim of a tensor whose gradient every rank
    holds whole (the logits after the vocab gather): the gradient is this
    rank's slice."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group, ctx.n = group, x.shape[-1]
        return group.all_gather_dim(x, -1, pin=True)

    @staticmethod
    def backward(ctx, g):
        return None, g.narrow(-1, ctx.group.rank * ctx.n, ctx.n)


class _RingShift(torch.autograd.Function):
    """Send to rank + 1, receive from rank - 1; the gradient goes the
    other way round the ring."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group.ring_shift(x, 1)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group.ring_shift(g, -1)


class _FsdpGather(torch.autograd.Function):
    """The fsdp gather of one layer's shards, each on its own dim, with
    the layer's input passed through: the backward (one reduce-scatter per
    shard, in order) runs when the input's gradient is complete, between
    this layer's backward and the one below it."""

    @staticmethod
    def forward(ctx, group, dims, x, *shards):
        ctx.group, ctx.dims = group, dims
        ctx.shapes = [s.shape for s in shards]
        return (x.view_as(x),) + tuple(group.all_gather_dim(s, d) for s, d in zip(shards, dims))

    @staticmethod
    def backward(ctx, gx, *gfull):
        grads = []
        for g, d, shape in zip(gfull, ctx.dims, ctx.shapes):
            if g is None:  # an unused weight still takes part in the collective
                full = list(shape)
                full[d] *= ctx.group.world_size
                g = torch.zeros(full, dtype=gx.dtype, device=gx.device)
            grads.append(ctx.group.reduce_scatter_dim(g, d))
        return (None, None, gx) + tuple(grads)


def copy_to_group(x: torch.Tensor, group: TPGroup | None) -> torch.Tensor:
    """Identity forward; the gradient is summed over *group* (the input of
    a column-parallel product)."""
    return x if _solo(group) else _host_apply(_CopyToGroup, group, (), x)


def reduce_from_group(x: torch.Tensor, group: TPGroup | None) -> torch.Tensor:
    """The sum of the ranks' *x* (a row-parallel product's partial sums);
    the gradient passes unchanged."""
    return x if _solo(group) else _ReduceFromGroup.apply(group, x)


def all_gather_grad(x: torch.Tensor, group: TPGroup | None, dim: int) -> torch.Tensor:
    """The ranks' *x* side by side on *dim*; the gradient is
    reduce-scattered back (each rank gets the sum of its block)."""
    return x if _solo(group) else _host_apply(_AllGatherDim, group, (dim,), x)


def gather_last_grad(x: torch.Tensor, group: TPGroup | None) -> torch.Tensor:
    """The vocab gather of the logits: the ranks' *x* side by side on the
    last dim; the gradient is this rank's slice."""
    return x if _solo(group) else _GatherLast.apply(group, x)


def ring_shift_grad(x: torch.Tensor, group: TPGroup | None) -> torch.Tensor:
    """*x* passed to the next rank of the ring (the previous rank's *x*
    returned); the gradient passes back the other way."""
    return x if _solo(group) else _host_apply(_RingShift, group, (), x)


def fsdp_gather(x: torch.Tensor, shards: list, dims: list, group: TPGroup | None):
    """(x, [the shards gathered over *group*, each on its dim]): *x* (the
    layer's input) passes through so that the gradient's reduce-scatters
    come in the chain's order (see above)."""
    if _solo(group) or not shards:
        return x, list(shards)
    out = _host_apply(_FsdpGather, group, (tuple(int(d) for d in dims),), x, *shards)
    return out[0], list(out[1:])
