"""Continuous-batching inference engine (port of kubeai_tpu/engine/core.py).

A slim port of the JAX engine's serving path:

- a fixed pool of decode **slots** over a **paged KV pool** (one flat
  [L*P, page, 2*Kv, h] tensor updated in place) with content-addressed
  prefix sharing across slots (engine/paging.py); pages for
  prompt + budget are reserved at admission, so a request waits for
  pages and never dies mid-decode;
- **prefill**: cold prompts up to the largest bucket are padded to their
  bucket and batched (at most ``prefill_group_cap`` per call); longer
  prompts and prompts resuming after a shared-prefix hit are prefilled in
  chunks of the largest bucket. Each prefill samples its first token into
  a device staging vector (``adm_toks``);
- **decode**: ``decode_chunk`` steps per dispatch, each sampling every
  slot with its temperature / top-k / top-p, presence and frequency
  penalties, logit bias, the chosen token's logprob and top-N logprobs.
  The decode state (lengths, next tokens, seeds, token history) lives on
  the device and the chunk updates it in place; slots admitted since the
  last dispatch are merged in by the chunk itself from the admission
  arrays (the JAX ``decode_fn``'s rebase). On CUDA each chunk is ONE
  CUDA graph replay (the counterpart of the JAX engine's jitted scan),
  captured once per resolved decode kernel;
- **pipelined scheduler** (the JAX ``_loop``): admit, dispatch chunk
  N+1, emit the admitted first tokens, then fetch and emit chunk N. A
  snapshot of (slot, request, epoch) taken at each dispatch decides
  which of a chunk's tokens still reach a request;
- **speculative decoding** (``speculate_tokens`` G > 0): each step
  feeds every slot its next token and G drafts from an n-gram lookup in
  the device token history (:func:`ngram_drafts`), verifies them in one
  forward, and emits the longest draft prefix the model's argmax agrees
  with plus the model's own next token. Only greedy slots without
  penalties or bias accept drafts, so greedy output equals G = 0's;
- **multi-LoRA** (:meth:`Engine.load_adapter`): PEFT adapters in one
  bank (engine/lora.py), allocated at the first load; every request
  names its adapter or none, and each prefill and decode step gives each
  row its adapter's delta. Loads and unloads run on the scheduler thread
  between dispatches and write the bank in place; the prefix cache keys
  pages on the adapter's (row, generation);
- **QoS** (kubeai_tpu_torch/qos): the admission queue serves classes in
  strict order with fair tenant lanes and sheds batch first; an
  interactive request finding every slot busy seizes a preemptible batch
  slot, whose stream ends ``"preempted"``;
- **KV park and restore** (engine/kvstate.py): a preempted stream, or a
  stream a prefill-role server capped for its handoff, parks its pages
  at the finish (a blob in the park store, the pages pinned on the
  device) and offers them on the finish; a resume carrying the blob
  imports it instead of re-running the prefill, and enters the decode
  chunk through the admission merge, as a prefill does. Any failure
  falls back to the deterministic replay;
- **embeddings** (:meth:`Engine.embed`): mean-pooled, L2-normalised
  final hidden states of up to ``max_slots`` prompts a group, each group
  run on the scheduler thread between decode chunks (eagerly, on the
  engine's stream; it touches no pool page and no decode state);
- **deadlines**: a request past its end-to-end deadline never takes a
  slot, and a decoding one is aborted through the cancel path (its
  chunk in flight is dropped by the dispatch snapshot, its pages return
  after that chunk is fetched);
- **failpoints** (kubeai_tpu_torch/faults.py) at the JAX sites:
  ``engine.submit``, ``engine.step``, ``engine.kv_export``,
  ``engine.kv_import``;
- every request carries a trace (obs/trace.py); its terminal accounting
  (``_finish_request``) feeds the latency histograms and the flight
  recorder, which also keeps one step record per decode chunk and
  prefill; the stall tracker and rate window feed ``pipeline_report``;
- :meth:`Engine.warmup` runs every step shape before serving (the
  server's ``--warmup``), the restore path's imports included;
  :meth:`Engine.load_params_` copies a model's weights into the
  engine's parameter storage in place, under its captured graphs (a
  parked replica's attach, engine/coldstart.py);
- one scheduler thread owns the device state and runs every device call
  on the engine's own CUDA stream; callers talk to it through
  per-request queues. Stop strings, EOS and ``max_tokens`` are handled on
  the host over the incrementally detokenized stream.

On the CPU the same loop runs the chunk eagerly (the tests), and on CUDA
too when the caller passes ``cuda_graphs=False``.

Tensor parallelism and the gang (``Engine(..., tp_group=, publisher=)``,
the JAX engine's ``mesh`` / ``publisher``): each rank's engine holds its
shard of the weights (parallel/sharding.py) and a pool of its KV heads
with the same page indices as every other rank; the forward's collectives
run on the *tp_group*. Rank 0 owns the scheduler and, before every
device dispatch (``prefill_batch``, ``prefill_chunk``, ``decode`` with
the resolved decode kernel, ``embed``) and every bank change
(``load_adapter``, ``unload_adapter``), publishes the op and its host
arguments (engine/gang.py); the other ranks replay them in
:meth:`Engine.run_follower` on the same host arrays, so their
collectives line up and their device state stays bit-identical to rank
0's. A failure after a broadcast is :class:`GangDesync` (the rank exits:
its followers are inside a collective rank 0 never reached); a lost
follower is :class:`GangLost`: in-flight work fails, the engine reads
not ready until the follower reconnects, then "reset" re-forms the gang
(``kubeai_gang_reforms_total``) and adapters are replayed. On a gang
warmup and KV park/restore are off, as in the JAX engine, and the
decode chunk is captured as a CUDA graph only under nccl (a gloo
collective goes through host memory and cannot be captured).

Metrics: the JAX engine's families under its names, types and buckets
(queue, slot, page and HBM gauges, the TTFT / queue-wait / prefill /
TPOT / e2e / step histograms, token, request, prefix and slot-step
counters, goodput, MFU and roofline gauges), with the ``kubeai_kv_*``
and ``kubeai_qos_*`` series, in kubeai_tpu_torch/metrics.py's registry.
``kubeai_engine_jit_recompiles_total`` has no counterpart: the port
counts decode-graph captures as ``kubeai_engine_graph_captures_total``.

Per-tenant cost: each tenanted request records its slot-seconds and
KV-page-seconds once, at slot release (``_record_slot_cost``, on every
path through ``_free`` and in ``_fail_inflight``), into obs/tenants.py's
accountant.

Left for later slices: CUDA graphs for prefill.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import os
import queue
import threading
import time
import uuid
import weakref
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from kubeai_tpu_torch import env_float, resolve_device
from kubeai_tpu_torch.engine import kvstate
from kubeai_tpu_torch.engine.paging import PagePool, pages_for
from kubeai_tpu_torch.engine.sampling import (
    SamplingParams,
    apply_logit_bias,
    apply_penalties,
    sample,
)
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer, IncrementalDetokenizer
from kubeai_tpu_torch.faults import FaultError, fault, set_thread_scope
from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.models import llama
from kubeai_tpu_torch.models.base import (
    ModelConfig,
    gemma2_2b,
    gemma_2b,
    llama_3_1_8b,
    mixtral_8x7b,
    qwen2_5_7b,
)
from kubeai_tpu_torch.obs import perf as perf_obs
from kubeai_tpu_torch.obs.logs import get_logger, trace_extra
from kubeai_tpu_torch.obs.recorder import (
    default_recorder,
    register_engine_debug_section,
    unregister_engine_debug_section,
)
from kubeai_tpu_torch.obs.tenants import default_accountant as tenant_accountant
from kubeai_tpu_torch.obs.trace import RequestTrace, TraceContext
from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.flash_attention import flash_attention
from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
from kubeai_tpu_torch.ops.paged_decode_attention import (
    paged_decode_attention,
    resolve_decode_kernel,
)
from kubeai_tpu_torch.ops.quant import qdot, qdot_many
from kubeai_tpu_torch.parallel.sharding import check_divisible, global_nbytes
from kubeai_tpu_torch.qos import QoSQueue, record_admitted, record_preemption
from kubeai_tpu_torch.qos.stats import install_queue, uninstall_queue

# The scheduler thread serves many requests, so its per-request log
# lines stamp the request's trace explicitly (extra=trace_extra(...)).
log = get_logger("kubeai_tpu_torch.engine")


class GangLost(ConnectionError):
    """A gang follower's dispatch connection failed: the gang's
    collectives cannot line up until the follower reconnects and the
    gang re-forms (or, failing that in time, the rank exits)."""


class GangDesync(RuntimeError):
    """Rank 0 failed to run an op after broadcasting it: the followers
    have entered that op's collectives and wait for rank 0, which no
    reset can realign. Fatal for the rank."""


@dataclass
class EngineConfig:
    """The JAX engine's configuration, field for field (same names and
    defaults). Fields of parts this port has not taken yet raise when set
    away from their default (see Engine.__init__)."""

    max_slots: int = 8
    max_seq_len: int = 2048
    prefill_buckets: tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    max_queue: int = 512
    default_max_tokens: int = 256
    decode_chunk: int = 8
    max_adapters: int = 8
    max_lora_rank: int = 64
    max_top_k: int = 128
    prefill_group_cap: int = 8
    page_size: int = 64
    num_pages: int = 0
    prefix_cache_min: int = 16
    speculate_tokens: int = 0
    kv_cache_dtype: str = ""
    enable_penalties: bool = True
    decode_kernel: str = "ragged"
    max_logit_bias: int = 300
    top_logprobs_k: int = 5


def engine_dims(cfg: EngineConfig) -> tuple[int, int, int]:
    """(max_pages_per_slot, total_pool_pages, hist_width)."""
    ps = cfg.page_size
    max_pages = -(-cfg.max_seq_len // ps)
    P = cfg.num_pages or (cfg.max_slots * max_pages + 1)
    hist_width = cfg.max_seq_len + (cfg.decode_chunk + 1) * (cfg.speculate_tokens + 1)
    return max_pages, P, hist_width


@dataclass
class FinishInfo:
    reason: str  # "stop" | "length" | "preempted"
    prompt_tokens: int
    completion_tokens: int
    # The restore offer ({key, source, tokens, bytes}) when the finish
    # parked the request's KV; the server puts it on the marker chunk.
    kv: dict | None = None


@dataclass
class Request:
    prompt_ids: list[int]
    params: SamplingParams
    # events: ("token", id, text_delta, logprob, top) | ("done", FinishInfo)
    # | ("error", message). id -1 = text-only flush (held-back chars).
    out: "queue.Queue[Any]" = field(default_factory=queue.Queue)
    cancelled: threading.Event = field(default_factory=threading.Event)
    adapter: str | None = None  # a loaded LoRA adapter's name
    arrival: float = field(default_factory=time.monotonic)
    # Absolute end-to-end deadline (time.monotonic()): a request past it
    # never takes a slot, and a decoding one is aborted (outcome
    # cancelled) instead of decoding for a caller that gave up.
    deadline: float | None = None
    # Lifecycle stamps (obs/trace.py), assembled by the flight recorder.
    trace: RequestTrace | None = None
    # Set once by _finish_request (under the engine's lock): a request
    # two threads finish at once is accounted once.
    finished: bool = False
    # The proxy's hashed tenant id: the queue's fair lane ("" = anonymous).
    tenant: str = ""
    # QoS class: queue lane, shedding and preemption.
    priority: str = "standard"
    # The slot may be seized mid-decode for a waiting interactive request
    # (replayable batch streams with no planned handoff).
    preemptible: bool = False
    # Park the KV at the finish: "preempt" at a "preempted" finish,
    # "handoff" at the budget-capped "length" finish; "" never.
    park_kv: str = ""
    # Validated restore state (kvstate.RestoreState): admitted by page
    # import instead of prefill; cleared on any failure (then replayed).
    restore: Any = None
    # The park-store key of a same-replica restore: its pinned pages are
    # taken back instead of uploading the payload.
    restore_key: str = ""


@dataclass
class _Slot:
    req: Request
    detok: IncrementalDetokenizer
    prompt_len: int
    generated: int = 0
    committed_text: str = ""  # decodable text so far
    delivered_chars: int = 0  # prefix of committed_text already sent
    budget: int = 0  # max new tokens
    # When the slot was taken (after the prefill): the base of the
    # tenant cost recorded at release.
    admitted_at: float = field(default_factory=time.monotonic)
    # The emitted ("token", ...) events of a request that may park: a
    # restore re-emits exactly these. None = not recording.
    event_log: list | None = None
    # The slot's sampling seed. The port's noise is a function of (seed,
    # position, rank), so a park needs no key evolution (the JAX engine
    # evolves a PRNG key per step): the seed is the whole key.
    kv_seed: int = 0

    @property
    def holdback(self) -> int:
        """Chars withheld so a stop string spanning chunk boundaries can
        be trimmed before the client sees it."""
        return max((len(s) for s in self.req.params.stop), default=1) - 1


class _HostInputs:
    """The per-slot arrays the host owns and the decode chunk reads (page
    table, active mask, sampling rows, admission arrays). The host's
    mirrors are numpy views of one flat array per dtype; the device holds
    static buffers of the same layout. :meth:`upload` copies the mirrors
    into one of two pinned staging sets and from there, in stream order,
    into the device buffers: the host may change its mirrors while a copy
    is still queued behind the chunk in flight, and never waits on it."""

    def __init__(self, specs: dict, device: torch.device):
        offs: dict = {}
        totals: dict = collections.Counter()
        for name, (shape, dtype) in specs.items():
            dt = np.dtype(dtype)
            offs[name] = (dt, totals[dt], int(np.prod(shape)), shape)
            totals[dt] += int(np.prod(shape))
        self.host = {dt: np.zeros(n, dt) for dt, n in totals.items()}
        self.dev_flat = {dt: torch.zeros(n, dtype=torch.from_numpy(self.host[dt]).dtype,
                                         device=device) for dt, n in totals.items()}
        self.views = {k: self.host[dt][o:o + n].reshape(shape)
                      for k, (dt, o, n, shape) in offs.items()}
        self.dev = {k: self.dev_flat[dt][o:o + n].view(shape)
                    for k, (dt, o, n, shape) in offs.items()}
        self.cuda = device.type == "cuda"
        self._pinned = [{dt: torch.empty(n, dtype=self.dev_flat[dt].dtype, pin_memory=True)
                         for dt, n in totals.items()} for _ in range(2)] if self.cuda else []
        self._done: list = [None, None]
        self._turn = 0

    def upload(self) -> None:
        if not self.cuda:
            for dt, a in self.host.items():
                self.dev_flat[dt].copy_(torch.from_numpy(a))
            return
        j, self._turn = self._turn, self._turn ^ 1
        if self._done[j] is not None:
            self._done[j].synchronize()  # the copy two dispatches back: long done
        for dt, a in self.host.items():
            self._pinned[j][dt].numpy()[:] = a
            self.dev_flat[dt].copy_(self._pinned[j][dt], non_blocking=True)
        self._done[j] = torch.cuda.Event()
        self._done[j].record()

    def make_inert(self) -> None:
        """Device inputs of a chunk that changes no slot: none active,
        none admitted, every table row the trash page."""
        for t in self.dev_flat.values():
            t.zero_()


# The kernel wrappers whose launch counters (attributes named launches*,
# ints or Counters) a CUDA graph's replays must keep counting.
_COUNTED = (flash_attention, paged_attention_ragged, paged_decode_attention, qdot, qdot_many)


def _counts() -> dict:
    return {(fn, k): (v.copy() if isinstance(v, collections.Counter) else v)
            for fn in _COUNTED for k, v in vars(fn).items() if k.startswith("launches")}


def _set_counts(counts: dict) -> None:
    for (fn, k), v in counts.items():
        cur = getattr(fn, k)
        if isinstance(cur, collections.Counter):
            cur.clear()
            cur.update(v)
        else:
            setattr(fn, k, v)


def _add_counts(delta: dict) -> None:
    for (fn, k), d in delta.items():
        cur = getattr(fn, k)
        if isinstance(cur, collections.Counter):
            cur.update(d)
        else:
            setattr(fn, k, cur + d)


def _param_bytes(tree) -> int:
    """Bytes of every tensor in a parameter tree (int8 values and their
    scales as stored)."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_param_bytes(v) for v in tree)
    return 0


class _ChunkGraph:
    """A decode chunk captured as one CUDA graph: its static outputs and
    the launches its capture counted, which every replay counts again
    (capture itself launches nothing)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs: tuple, launches: dict):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def replay(self) -> tuple:
        self.graph.replay()
        _add_counts(self.launches)
        return self.outputs


# (device index, raw handle) of the CUDA streams that live engines own.
# torch hands out pooled streams, which repeat after 32 draws, and two
# engines on one stream would share its kernel scratch (_build.scratch).
_owned_streams: set = set()


def _own_stream(device: torch.device) -> torch.cuda.Stream:
    """A pooled CUDA stream no other live engine owns (released when the
    owning engine is collected)."""
    for collect in (False, True):
        if collect:
            gc.collect()  # engines no longer referenced give theirs back
        for _ in range(64):
            s = torch.cuda.Stream(device)
            key = (s.device.index, s.cuda_stream)
            if key not in _owned_streams:
                _owned_streams.add(key)
                return s
    raise RuntimeError("every pooled CUDA stream is owned by a live engine")


class Engine:
    """Single-model engine; one instance per replica.

    Runs on ``device`` (default ``cuda``; pass ``"cpu"`` explicitly to run
    on the CPU). On CUDA the model's kernel gates are turned on, as the
    JAX engine turns them on for the TPU: flash prefill and, without a
    sliding window, the paged attention kernels; every device call runs on the engine's own stream,
    and each decode chunk replays a CUDA graph unless ``cuda_graphs`` is
    False (the same chunk eagerly: for comparisons on the card).

    On a gang *params* is this rank's shard, *tp_group* the ranks'
    parallel/group.py TPGroup, and rank 0 passes the gang's *publisher*
    (engine/gang.py); the other ranks call :meth:`run_follower`."""

    def __init__(
        self,
        model_config: ModelConfig,
        params,
        tokenizer,
        engine_config: EngineConfig | None = None,
        device: torch.device | str | None = None,
        cuda_graphs: bool = True,
        tp_group=None,
        publisher=None,
    ):
        self.cfg = engine_config or EngineConfig()
        self.device = resolve_device(device)
        self.tp_group = tp_group
        self.tp = tp_group.world_size if tp_group is not None else 1
        check_divisible(model_config, self.tp)
        self._publisher = publisher
        # Any rank of a gang (rank 0 publishes; the others replay).
        self._gang = publisher is not None or tp_group is not None
        if self.cfg.decode_kernel not in ("ragged", "dedicated", "auto"):
            raise ValueError(
                f"decode_kernel must be 'ragged', 'dedicated' or 'auto', "
                f"got {self.cfg.decode_kernel!r}"
            )
        if self.cfg.speculate_tokens < 0:
            raise ValueError(f"speculate_tokens must be >= 0, got {self.cfg.speculate_tokens}")
        if self.cfg.kv_cache_dtype:
            # Replaces the model config's pool dtype, as in the JAX engine;
            # the pool keeps engine_dims' page count (half the bytes).
            model_config = model_config.replace(kv_cache_dtype=self.cfg.kv_cache_dtype)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            # The JAX package's apply_backend_flags: flash prefill, and the
            # paged kernels unless a sliding window rules them out.
            model_config = model_config.replace(
                use_flash_prefill=True, use_paged_kernel=model_config.sliding_window == 0)
        llama.check_supported(model_config)
        self.model_config = model_config
        self.params = params
        self.tokenizer = tokenizer
        # A decode step runs 1 + G queries per slot, as in the JAX engine.
        self.decode_kernel = resolve_decode_kernel(
            self.cfg.decode_kernel, 1 + self.cfg.speculate_tokens)
        # Drafts proposed and accepted for greedy slots (the JAX engine's
        # kubeai_engine_speculative_{drafted,accepted}_total).
        self.spec_drafted = 0
        self.spec_accepted = 0
        # The model vocab may be padded past the tokenizer's; padded
        # logits are masked so they are never sampled.
        self.n_valid_vocab = min(
            getattr(tokenizer, "vocab_size", model_config.vocab_size), model_config.vocab_size
        )
        # A gloo group's collectives pass through host memory, which a
        # CUDA graph cannot capture: its chunk runs eagerly.
        self.cuda_graphs = bool(cuda_graphs) and self._cuda and (
            tp_group is None or tp_group.graphable)
        # Set by EngineServer.start(): the scheduler thread's failpoint
        # scope (engine.step@PORT and the other sites' twins).
        self.fault_scope: str | None = None
        # Requests submit() accepted with no terminal accounting yet:
        # drain's idle signal (queue + slots misses mid-admission).
        self._in_system = 0
        self._in_system_lock = threading.Lock()
        # Every device call of the engine (prefill, upload, replay, host
        # copies) runs on this stream, in the order the scheduler issues
        # it; a graph is captured on a stream of its own, whose kernel
        # scratch only the graph uses.
        self._stream = _own_stream(self.device) if self._cuda else None
        self._capture_stream = _own_stream(self.device) if self.cuda_graphs else None
        weakref.finalize(self, _owned_streams.difference_update,
                         {(s.device.index, s.cuda_stream)
                          for s in (self._stream, self._capture_stream) if s is not None})
        self._graphs: dict[str, _ChunkGraph] = {}
        self._graph_pool = None
        # Seconds each graph's capture took (eager run included), by kernel,
        # and their split (_capture).
        self.graph_capture_seconds: dict[str, float] = {}
        self.graph_capture_segments: dict[str, dict] = {}
        # Recent decode chunks: host-clock segments (the JAX engine's
        # flight-recorder step records) and the device span between CUDA
        # events around the chunk.
        self.chunk_log: collections.deque = collections.deque(maxlen=4096)
        self.warmup_result: dict | None = None  # the last warmup()'s
        # Class-aware admission queue (qos/queue.py): queue.Queue's surface.
        self._queue = QoSQueue(maxsize=self.cfg.max_queue)
        # The host park store of serialized KV state and the address its
        # offers point peers at (EngineServer.start() stamps it).
        self.kv_park = kvstate.ParkStore()
        self.kv_advertise = ""
        self._kv_fp = kvstate.model_fingerprint(self.model_config, self.cfg.page_size)
        self._kv_park_sweep_at = 0.0
        # Recent park, acquire and import events with their milliseconds.
        self.kv_log: collections.deque = collections.deque(maxlen=256)
        self._init_metrics()
        # Thunks the scheduler thread runs between dispatches (adapter
        # loads and unloads), each with its reply queue.
        self._aux: "queue.Queue[tuple]" = queue.Queue()
        self._adapters = None  # engine/lora.py AdapterRuntime, made at the first load
        # Gang supervision: set while a follower is lost (not ready); the
        # adapters loaded, replayed to a re-formed gang; the seconds rank 0
        # waits for a lost follower before it exits.
        self._gang_degraded = threading.Event()
        self._adapter_sources: dict[str, str] = {}
        self.gang_reform_timeout = env_float("KUBEAI_GANG_REFORM_TIMEOUT", 300.0)
        # Ops a follower replayed, by name, and the decode kernels they ran.
        self.follower_ops: collections.Counter = collections.Counter()
        self.follower_kernels: set[str] = set()
        self.follower_reconnects = 0
        self._follower_profile = None
        self._running = False
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        if self._cuda:
            # The caller's stream made the weights.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            self._init_state()

    def _init_metrics(self) -> None:
        """The engine's metrics: the JAX engine's names, types, help
        strings and buckets. Occupancy, HBM, MFU and roofline gauges are
        callback gauges, evaluated at render; stop() unbinds them so the
        process-wide registry does not pin this engine's pool."""
        reg = default_registry
        self.m_queue = reg.gauge("kubeai_engine_queue_depth", "requests waiting for a slot")
        self.m_active = reg.gauge("kubeai_engine_active_slots", "decode slots in use")
        self.m_slots_total = reg.gauge(
            "kubeai_engine_slots_total", "configured decode slot capacity")
        self.m_slots_total.set(self.cfg.max_slots)
        self.m_queue.set(0)
        self.m_active.set(0)
        self.m_gen = reg.counter("kubeai_engine_generated_tokens_total", "tokens generated")
        self.m_prefill = reg.counter(
            "kubeai_engine_prefill_tokens_total", "prompt tokens prefilled")
        self.m_ttft = reg.histogram(
            "kubeai_engine_ttft_seconds",
            "submit to first emitted token (true TTFT: queue wait + prefill "
            "+ first-token round-trip)")
        self.m_requests = reg.counter(
            "kubeai_engine_requests_total",
            "terminal request events by outcome (ok|error|cancelled)")
        self.m_queue_wait = reg.histogram(
            "kubeai_engine_queue_wait_seconds",
            "submit to prefill dispatch (slot + KV page wait)")
        self.m_prefill_s = reg.histogram(
            "kubeai_engine_prefill_seconds", "prefill dispatch to first emitted token")
        self.m_tpot = reg.histogram(
            "kubeai_engine_tpot_seconds", "inter-token latency during decode",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5))
        self.m_e2e = reg.histogram(
            "kubeai_request_e2e_seconds", "request end-to-end latency by terminal outcome",
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120))
        self.m_prefix_cached = reg.counter(
            "kubeai_engine_prefix_cached_tokens_total",
            "prompt tokens skipped via shared-prefix page reuse")
        self.m_prefix_lookup = reg.counter(
            "kubeai_engine_prefix_lookup_tokens_total",
            "prompt tokens offered to the shared-prefix cache lookup at "
            "admission (denominator for the prefix hit ratio; 0 growth = "
            "prefix caching disabled)")
        self.m_cached_evictions = reg.counter(
            "kubeai_engine_kv_cached_evictions_total",
            "reusable cached KV pages evicted by allocation pressure "
            "(LRU; sustained growth means the prefix cache is thrashing)")
        self._evictions_seen = 0
        self.m_step = reg.histogram(
            "kubeai_engine_step_seconds",
            "scheduler step wall time by phase. decode_chunk = chunk TURNAROUND "
            "(dispatch to results consumed — the pipelined loop overlaps host "
            "work, admissions, and the next dispatch inside it; the pure host "
            "wait is the step record's fetch_wait_ms); prefill_* = dispatch call")
        self.m_slot_steps = reg.counter(
            "kubeai_engine_slot_steps_total",
            "fused decode slot-steps by state; batch utilization = "
            "active / (active + idle)")
        self.m_pad_prefill = reg.counter(
            "kubeai_engine_prefill_padded_tokens_total",
            "prompt positions computed as bucket/batch padding (prefill waste; "
            "compare against kubeai_engine_prefill_tokens_total)")
        self.m_tok_rate = reg.gauge(
            "kubeai_engine_tokens_per_second",
            "decode goodput over the most recent chunks (0 when idle)")
        # The counterpart of kubeai_engine_jit_recompiles_total: the port
        # compiles no step function; what it builds per shape is the
        # decode chunk's CUDA graph, so it counts those captures.
        self.m_captures = reg.counter(
            "kubeai_engine_graph_captures_total",
            "decode-chunk CUDA graph captures (warmup's included; growth after "
            "warmup means the graphs were dropped and captured again)")
        self.m_spec_drafted = reg.counter(
            "kubeai_engine_speculative_drafted_total", "draft tokens proposed")
        self.m_spec_accepted = reg.counter(
            "kubeai_engine_speculative_accepted_total", "draft tokens accepted")
        self.m_gang_reforms = reg.counter(
            "kubeai_gang_reforms_total",
            "gang re-formations: a lost follower reconnected and rank 0 "
            "re-synchronized every rank with a reset")
        # Weight residency: on a tp gang each rank holds about 1/tp of the
        # model (the replicated norms and row-parallel int8 scales whole).
        self.param_bytes_local = _param_bytes(self.params)
        self.param_bytes_global = global_nbytes(self.params, self.model_config, self.tp)
        reg.gauge("kubeai_engine_param_bytes_global", "total model parameter bytes"
                  ).set(self.param_bytes_global)
        reg.gauge("kubeai_engine_param_bytes_local", "parameter bytes resident on this rank"
                  ).set(self.param_bytes_local)
        # Live roofline / MFU accounting (obs/perf.py): FLOPs per token
        # from the config, weight bytes measured off the parameters (int8
        # values and their scales as stored), the card's peaks; on a gang
        # the whole model's bytes over every rank's device.
        self.perf = perf_obs.PerfModel.from_model_config(
            self.model_config, weight_bytes=self.param_bytes_global)
        self.perf_env = perf_obs.detect_device(self.device)
        self._rate_window = perf_obs.TokenRateWindow(span=10.0)
        self._stall = perf_obs.PipelineStallTracker()
        gauges = (
            ("kubeai_engine_hbm_used_bytes", "accelerator memory in use",
             lambda: float(self._hbm_stats()[0])),
            ("kubeai_engine_hbm_limit_bytes", "accelerator memory capacity",
             lambda: float(self._hbm_stats()[1])),
            ("kubeai_engine_mfu",
             "model FLOPs utilization (fraction of device peak) at the "
             "current decode rate window; 0 on unknown devices/CPU", lambda: self._mfu()),
            ("kubeai_engine_roofline_fraction",
             "current decode rate as a fraction of the weight-read "
             "roofline at the configured slot count; 0 on unknown devices",
             lambda: self._roofline_fraction()),
            ("kubeai_engine_kv_pages_used", "KV pool pages referenced by live slots",
             lambda: float(self._pool.used())),
            ("kubeai_engine_kv_pages_cached", "free KV pages retaining reusable prefixes",
             lambda: float(self._pool.cached_pages())),
            ("kubeai_engine_kv_pages_total", "allocatable KV pool pages",
             lambda: float(self._pool.num_pages - 1)),
            ("kubeai_engine_kv_pages_parked",
             "device pages pinned by parked (preempted/handed-off) request "
             "state awaiting restore — reclaimable, excluded from "
             "kubeai_engine_kv_pages_used so parked state never reads as "
             "live KV pressure", lambda: float(self._pool.parked_pages())),
        )
        self._gauge_callbacks = [(reg.callback_gauge(name, help_, fn), fn)
                                 for name, help_, fn in gauges]
        # One bound method kept for the register / unregister identity.
        self._perf_section_fn = self._perf_debug_section
        register_engine_debug_section("perf", self._perf_section_fn)
        self._gang_section_fn = self.gang_report
        register_engine_debug_section("gang", self._gang_section_fn)

    def _hbm_stats(self) -> tuple[int, int]:
        """(used, capacity) bytes of the engine's card (cudaMemGetInfo:
        every process's allocations); (0, 0) on the CPU."""
        if not self._cuda:
            return 0, 0
        free, total = torch.cuda.mem_get_info(self.device)
        return total - free, total

    # -- perf X-ray --------------------------------------------------------

    def _peaks(self) -> tuple:
        """(peak FLOP/s, HBM GB/s) of every device the model spans: one
        card's times the tp ranks (the JAX engine scales by the mesh)."""
        env = self.perf_env
        return ((env.peak_flops * self.tp if env.peak_flops else env.peak_flops),
                (env.hbm_gbps * self.tp if env.hbm_gbps else env.hbm_gbps))

    def _mfu(self) -> float:
        return self.perf.mfu(self.m_tok_rate.value(), self._peaks()[0])

    def _roofline_fraction(self) -> float:
        roof = self.perf.roofline_tokens_per_sec(self.cfg.max_slots, self._peaks()[1])
        return self.m_tok_rate.value() / roof if roof else 0.0

    def _perf_debug_section(self) -> dict:
        """The ``perf`` block of /debug/engine: live rate, MFU, roofline
        context and the windowed stall summary."""
        env = self.perf_env
        peak_flops, hbm_gbps = self._peaks()
        roof = self.perf.roofline_tokens_per_sec(self.cfg.max_slots, hbm_gbps)
        return {
            "tokens_per_second": self.m_tok_rate.value(),
            "mfu": round(self._mfu(), 5),
            "roofline_fraction": round(self._roofline_fraction(), 5),
            "roofline_toks_per_sec": round(roof, 1) if roof else None,
            "flops_per_token": self.perf.flops_per_token,
            "weight_bytes": self.perf.weight_bytes,
            "device": env.kind,
            "devices": self.tp,
            "peak_flops": peak_flops,
            "hbm_gbps": hbm_gbps,
            "stall": self._stall.report(),
        }

    def gang_report(self) -> dict:
        """The ``gang`` block of /debug/engine (and a follower's
        /debug/gang): this rank's place in the gang, the group's backend
        and collective counts, the parameter bytes and the kernel launch
        counts of this process."""
        out = {
            "tp": self.tp,
            "rank": self.tp_group.rank if self.tp_group is not None else 0,
            "role": "leader" if self._publisher is not None else (
                "follower" if self._gang else "single"),
            "param_bytes_local": self.param_bytes_local,
            "param_bytes_global": self.param_bytes_global,
            "cuda_graphs": self.cuda_graphs,
            "launches": {f"{fn.__name__}.{k}": (dict(v) if isinstance(v, collections.Counter)
                                                 else v)
                         for (fn, k), v in _counts().items()},
        }
        if self.tp_group is not None:
            out["group"] = self.tp_group.describe()
        if self._publisher is not None:
            out["complete"] = self._publisher.is_complete()
            out["degraded"] = self._gang_degraded.is_set()
            out["reforms"] = self.m_gang_reforms.value()
        if self._gang and not self._publisher:
            out["ops"] = dict(self.follower_ops)
            out["kernels"] = sorted(self.follower_kernels)
            out["reconnects"] = self.follower_reconnects
        return out

    def pipeline_report(self) -> dict:
        """The GET /debug/pipeline payload: windowed stall attribution
        with the live MFU and roofline context."""
        report = self._stall.report()
        report["mfu"] = round(self._mfu(), 5)
        report["roofline_fraction"] = round(self._roofline_fraction(), 5)
        report["tokens_per_second"] = self.m_tok_rate.value()
        return report

    # -- terminal accounting -----------------------------------------------

    def _finish_request(self, req: Request, outcome: str, **attrs) -> None:
        """Terminal accounting of every request submit() accepted: the
        outcome counter, the per-phase histograms from its trace and the
        flight recorder's handoff (spans are assembled on the recorder's
        thread). A request is accounted once, whichever thread gets here
        first. The outcome is counted before the request leaves
        ``requests_in_system()``: whoever sees the engine drained also sees
        every outcome counted."""
        with self._in_system_lock:
            if req.finished:
                return
            req.finished = True
            self.m_requests.inc(labels={"outcome": outcome})
            self._in_system -= 1
        tr = req.trace
        if tr is None:
            return
        tr.finish(outcome, **attrs)
        end = tr.end_mono
        t_prefill = tr.first_mark("prefill")
        # Queue wait ends at the prefill call; a request that never
        # reached a slot waited its whole life.
        self.m_queue_wait.observe((t_prefill if t_prefill is not None else end) - tr.t0_mono)
        if t_prefill is not None:
            self.m_prefill_s.observe((tr.tokens[0] if tr.tokens else end) - t_prefill)
        self.m_e2e.observe(end - tr.t0_mono, labels={"outcome": outcome})
        # TPOT is O(tokens) observes: the recorder's thread does them.
        default_recorder.submit(tr, observe=self._observe_tpot)

    def _observe_tpot(self, tr: RequestTrace) -> None:
        for a, b in zip(tr.tokens, tr.tokens[1:]):
            self.m_tpot.observe(b - a)

    # -- state -------------------------------------------------------------

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext()

    def _init_state(self) -> None:
        self._drop_graphs()
        B = self.cfg.max_slots
        G = self.cfg.speculate_tokens
        Kb = self.cfg.max_logit_bias
        self._max_pages, P, hist_width = engine_dims(self.cfg)
        self._pool = PagePool(P, self.cfg.page_size)
        self.cache = llama.init_paged_cache(
            self.model_config, P, self.cfg.page_size, self.device, tp=self.tp
        )
        self._slots: list[_Slot | None] = [None] * B
        self._slot_epoch = [0] * B  # bumped at each admission (JAX _slot_epoch)
        self._n_active = 0
        specs = {
            "table": ((B, self._max_pages), np.int32),
            "active": ((B,), np.bool_),
            "temp": ((B,), np.float32),
            "top_p": ((B,), np.float32),
            "top_k": ((B,), np.int64),
            "presence": ((B,), np.float32),
            "freq": ((B,), np.float32),
            "gen_start": ((B,), np.int64),
            "bias_ids": ((B, Kb), np.int64),
            "bias_vals": ((B, Kb), np.float32),
            # Admission merge for the next dispatch (JAX _adm_*).
            "adm_mask": ((B,), np.bool_),
            "adm_len": ((B,), np.int64),
            "adm_seed": ((B,), np.int64),
            "lora_rows": ((B,), np.int64),  # each slot's adapter row (0: none)
        }
        if G:
            specs["adm_hist"] = ((B, hist_width), np.int64)
        self._inputs = _HostInputs(specs, self.device)
        h = self._inputs.views
        self._page_table = h["table"]
        self._h_active, self._h_temp, self._h_top_p = h["active"], h["temp"], h["top_p"]
        self._h_top_k, self._h_presence, self._h_freq = h["top_k"], h["presence"], h["freq"]
        self._h_gen_start = h["gen_start"]
        self._h_bias_ids, self._h_bias_vals = h["bias_ids"], h["bias_vals"]
        self._adm_mask, self._adm_len, self._adm_seed = h["adm_mask"], h["adm_len"], h["adm_seed"]
        self._adm_hist = h.get("adm_hist")
        self._h_lora_rows = h["lora_rows"]
        self._h_temp[:] = 1.0
        self._h_top_p[:] = 1.0
        # Device-resident decode state (the JAX decode jit's carries): the
        # chunk reads and updates it in place; the host never reads it.
        dev = self.device
        self._lengths = torch.zeros((B,), dtype=torch.int64, device=dev)  # next input's position
        self._last = torch.zeros((B,), dtype=torch.int64, device=dev)  # next input token
        self._seeds = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._tok_hist = torch.zeros((B, hist_width), dtype=torch.int64, device=dev)
        self._adm_toks = torch.zeros((B,), dtype=torch.int64, device=dev)  # first tokens
        # Two pinned sets of chunk outputs: chunk N+1's copy is queued
        # while the host still reads chunk N's.
        self._out_sets: list = [None, None]
        self._out_turn = 0
        self._slot_pages: list[list[int]] = [[] for _ in range(B)]
        self._slot_fresh: list[list[int]] = [[] for _ in range(B)]
        self._slot_budget = [0] * B
        # Token ids whose KV a slot has written (registered as shared
        # prefix pages when the slot frees), and the token the next
        # decode step writes.
        self._kv_history: list[list[int]] = [[] for _ in range(B)]
        self._kv_pending: list[int | None] = [None] * B
        # The adapter (row, generation) the slot's KV was computed under:
        # the prefix-cache signature its pages register with.
        self._kv_lora_sig: list[tuple[int, int]] = [(0, 0)] * B
        self._deferred: list[Request] = []  # fit a slot but not the pool

    def _drop_graphs(self) -> None:
        """Free the captured graphs, their memory pool and their scratch."""
        for g in self._graphs.values():
            g.graph.reset()
        self._graphs.clear()
        self._graph_pool = None
        if self._capture_stream is not None:
            _build.release_stream(self._capture_stream)

    # -- public API --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._running = True
            return
        self._running = True
        install_queue(self._queue)  # /debug/qos reads the live queue
        self._thread = threading.Thread(target=self._loop, name="engine-loop", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                log.warning("engine loop did not exit; skipping in-flight cleanup")
                if self._publisher is not None:
                    self._publisher.close()
                return
        # After the loop exits: a close racing its broadcast would look
        # like a lost follower. Sends the followers "stop".
        if self._publisher is not None:
            self._publisher.close()
        self._fail_inflight("engine shutting down")
        # Unbind this engine from the process-wide registries (only where
        # it is still the owner): they must not pin its pool.
        for gauge, fn in self._gauge_callbacks:
            gauge.clear_callback(fn)
        unregister_engine_debug_section("perf", self._perf_section_fn)
        unregister_engine_debug_section("gang", self._gang_section_fn)
        uninstall_queue(self._queue)
        # The graphs and their pool die with the engine's serving life (a
        # later start() captures anew), once the last chunk has run.
        if self._cuda:
            self._stream.synchronize()
        self._drop_graphs()
        self._out_sets = [None, None]

    def is_ready(self) -> bool:
        """The loop is alive and, on a gang, every follower is connected
        and the gang is not re-forming (a degraded gang cannot decode)."""
        gang_ok = self._publisher is None or (
            self._publisher.is_complete() and not self._gang_degraded.is_set())
        return bool(self._running and self._thread is not None and self._thread.is_alive()
                    and gang_ok)

    def queue_depth(self) -> int:
        return self._queue.qsize() + len(self._deferred)

    def requests_in_system(self) -> int:
        """Requests submit() accepted with no terminal event yet: queued,
        deferred, mid-admission or decoding (drain's idle signal)."""
        with self._in_system_lock:
            return self._in_system

    def active_slots(self) -> int:
        return self._n_active

    def submit(self, prompt_ids: list[int], params: SamplingParams,
               adapter: str | None = None, trace_ctx: TraceContext | None = None,
               deadline: float | None = None, tenant: str = "", priority: str = "standard",
               preemptible: bool = False, park_kv: str = "", restore: Any = None,
               restore_key: str = "") -> Request:
        """Enqueue a request (with the LoRA *adapter* of that name); raises
        queue.Full when its class is shed, ValueError for a prompt that
        cannot fit or an adapter that is not loaded, RuntimeError when not
        running. *trace_ctx* joins the request to an inbound trace (a
        fresh one otherwise); *deadline* (time.monotonic()) aborts it,
        queued or decoding, once passed. *priority*, *tenant* and
        *preemptible* place it in the QoS queue; *park_kv* parks its KV
        at a preempted or handoff-capped finish; *restore* (a
        kvstate.RestoreState, from the park store under *restore_key* on
        this replica) admits it by page import."""
        fault("engine.submit")
        max_prompt = min(
            self.cfg.max_seq_len, (self._pool.num_pages - 1) * self.cfg.page_size
        ) - 1
        if not prompt_ids:
            raise ValueError("prompt must not be empty")
        if len(prompt_ids) > max_prompt:
            raise ValueError(f"prompt too long: {len(prompt_ids)} tokens > {max_prompt}")
        if adapter and self._adapter_row(adapter) == 0:
            raise ValueError(f"adapter {adapter!r} is not loaded")
        if not self._running:
            raise RuntimeError("engine is not running")
        if not self._kv_enabled():
            park_kv, restore, restore_key = "", None, ""
        req = Request(prompt_ids=list(prompt_ids), params=params, adapter=adapter or None,
                      deadline=deadline, tenant=tenant, priority=priority,
                      preemptible=preemptible, park_kv=park_kv, restore=restore,
                      restore_key=restore_key)
        req.trace = RequestTrace(ctx=trace_ctx, component="engine", t0_mono=req.arrival)
        req.trace.attrs["prompt_tokens"] = len(prompt_ids)
        req.trace.attrs["priority"] = priority
        if tenant:
            req.trace.attrs["tenant"] = tenant
        with self._in_system_lock:
            self._in_system += 1
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._in_system_lock:
                self._in_system -= 1
            raise
        if not self._running:
            # Raced stop(): its queue drain may have run before the put.
            # Never strand the caller (a doubled terminal is harmless:
            # consumers take the first, _finish_request dedupes).
            req.out.put(("error", "engine shutting down"))
            self._finish_request(req, "error", error="engine shutting down")
            return req
        self.m_queue.set(self.queue_depth())
        self._wake.set()
        return req

    def generate(self, prompt_ids: list[int], params: SamplingParams, timeout: float = 300,
                 adapter: str | None = None):
        """Blocking wrapper: returns (token_ids, text, FinishInfo). The
        *timeout* is also the request's deadline: a timed-out generate()
        frees its slot."""
        req = self.submit(prompt_ids, params, adapter=adapter,
                          deadline=time.monotonic() + timeout)
        ids: list[int] = []
        chunks: list[str] = []
        deadline = time.monotonic() + timeout
        while True:
            try:
                ev = req.out.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                req.cancelled.set()
                raise TimeoutError(
                    f"generate() produced no event within {timeout}s ({len(ids)} tokens)"
                ) from None
            if ev[0] == "token":
                if ev[1] >= 0:
                    ids.append(ev[1])
                chunks.append(ev[2])
            elif ev[0] == "done":
                return ids, "".join(chunks), ev[1]
            else:
                raise RuntimeError(ev[1])

    # -- embeddings --------------------------------------------------------

    def embed(self, prompts: list[list[int]]) -> np.ndarray:
        """[N, hidden] float32: each prompt's final hidden states (after
        the final norm), mean-pooled over its tokens and L2-normalised
        (the JAX ``Engine.embed``; the catalog's TextEmbedding feature).
        Prompts go in groups of ``max_slots``, each padded to its bucket
        and to ``max_slots`` rows. While the loop runs, each group is a
        scheduler thunk between decode chunks (queued together, run one
        an iteration); otherwise it runs here. Raises ValueError for a
        prompt longer than the largest bucket."""
        max_prompt = max(self.cfg.prefill_buckets)
        B = self.cfg.max_slots
        groups = []
        for start in range(0, len(prompts), B):
            group = prompts[start : start + B]
            longest = max(len(p) for p in group)
            if longest > max_prompt:
                raise ValueError(f"embedding input too long: {longest} > {max_prompt}")
            # Padding rows (length 0) pool to zeros and are sliced off.
            tokens = np.zeros((B, self._bucket(longest)), np.int64)
            lengths = np.zeros((B,), np.int64)
            for i, p in enumerate(group):
                tokens[i, : len(p)] = p
                lengths[i] = len(p)
            groups.append((len(group), tokens, lengths))
        pending = [(n, self._submit_aux(lambda t=tokens, ln=lengths: self._embed_group(t, ln)))
                   for n, tokens, lengths in groups]
        out = []
        for n, rq in pending:
            (vecs,), ev = self._await_aux(rq, "embedding")
            if ev is not None:
                ev.synchronize()
            out.append(vecs.numpy()[:n])
        return np.concatenate(out, axis=0)

    def _embed_group(self, tokens: np.ndarray, lengths: np.ndarray) -> tuple:
        """One padded group through the model, broadcast first on a gang."""
        with self._lockstep("embed", arrays={"tokens": tokens, "lengths": lengths}):
            return self._run_embed(tokens, lengths)

    def _run_embed(self, tokens: np.ndarray, lengths: np.ndarray) -> tuple:
        """One padded group through the model without a cache (no pool
        page, no decode state: plain attention, as the JAX embed_fn's
        cache-less apply), pooled on the device; the result's copy to
        pinned host memory is queued (host tensors, event)."""
        B, S = tokens.shape
        tok = self._t(tokens)
        pos = torch.arange(S, device=self.device)[None, :].expand(B, S)
        hidden, _ = llama.apply(self.params, self.model_config, tok, pos, return_hidden=True,
                                tp_group=self.tp_group)
        valid = (pos < self._t(lengths)[:, None]).float()[..., None]
        pooled = (hidden * valid).sum(1) / torch.clamp(valid.sum(1), min=1.0)
        vecs = pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True),
                                    min=1e-12)
        return self._to_host((vecs,))

    # -- LoRA adapters -----------------------------------------------------

    def load_adapter(self, name: str, path: str) -> None:
        """Install the PEFT adapter at *path* (a local directory, file://,
        or a remote source staged under KUBEAI_ADAPTER_STAGING_DIR as
        ``{name}-<12 hex>``) as *name*, or reload it. Staged on the caller's thread;
        installed on the scheduler thread between dispatches, so the bank
        changes in stream order: the chunk in flight runs with the old
        rows, the next with the new ones. The first load allocates the
        bank and drops the captured chunk graphs: the next dispatch
        captures the chunk with the adapter deltas."""
        from kubeai_tpu_torch.loader import stage_adapter

        staged = stage_adapter(name, path)

        def do():
            # Install first: a bad checkpoint fails here with nothing
            # broadcast. On a gang the broadcast then takes this thunk's
            # place in the dispatch stream, and each follower stages the
            # original path itself.
            self._install_adapter(name, staged)
            self._bcast("load_adapter", scalars={"name": name, "path": path})
            self._adapter_sources[name] = path

        self._run_on_scheduler(do, "adapter load")

    def _load_adapter_local(self, name: str, path: str) -> None:
        """A follower's load (the op's place in the stream orders it): each
        rank stages the original source itself."""
        from kubeai_tpu_torch.loader import stage_adapter

        self._install_adapter(name, stage_adapter(name, path))

    def _install_adapter(self, name: str, path: str) -> None:
        from kubeai_tpu_torch.engine.lora import AdapterRuntime

        if self._adapters is None:
            if self._cuda:
                # The graphs read no bank: retire them (and the memory
                # their replays in flight still use) before the next
                # dispatch captures the chunk with the deltas.
                self._stream.synchronize()
            self._drop_graphs()
            self._adapters = AdapterRuntime(
                self.model_config, max_adapters=self.cfg.max_adapters,
                max_rank=self.cfg.max_lora_rank, device=self.device)
        self._adapters.load(name, path)

    def unload_adapter(self, name: str) -> bool:
        """Zero adapter *name*'s row (on the scheduler thread); False when
        it was not loaded. Requests still decoding with it go on with the
        zeroed row."""
        if self._adapters is None:
            return False

        def do():
            ok = self._adapters.unload(name)
            if ok:  # an unload of nothing broadcasts nothing
                self._bcast("unload_adapter", scalars={"name": name})
                self._adapter_sources.pop(name, None)
            return ok

        return self._run_on_scheduler(do, "adapter unload")

    def loaded_adapters(self) -> list[str]:
        return self._adapters.names() if self._adapters else []

    def _adapter_row(self, name: str | None) -> int:
        return self._adapters.row_for(name) if self._adapters is not None else 0

    def _lora_sig(self, name: str | None) -> tuple[int, int]:
        return self._adapters.row_sig(name) if self._adapters is not None else (0, 0)

    def _lora_args(self, rows) -> dict:
        """The model's lora keywords for batch *rows* (host ints), or none
        before the first adapter load."""
        if self._adapters is None:
            return {}
        return {"lora": self._adapters.bank, "lora_rows": self._t(np.asarray(rows, np.int64))}

    def _lora_kw(self, ar: dict) -> dict:
        """The lora keywords of a dispatch's arrays: its ``lora_rows`` when
        rank 0 had a bank at the dispatch (a follower must have one too)."""
        if "lora_rows" not in ar:
            return {}
        if self._adapters is None:
            raise RuntimeError("rank 0 dispatched LoRA state this follower lacks")
        return {"lora": self._adapters.bank, "lora_rows": self._t(ar["lora_rows"])}

    def _run_on_scheduler(self, thunk, what: str, timeout: float = 600):
        """Run *thunk* on the scheduler thread (between dispatches, on the
        engine's stream) and return its result; before start(), here on
        the engine's stream."""
        return self._await_aux(self._submit_aux(thunk), what, timeout)

    def _submit_aux(self, thunk) -> "queue.Queue":
        """Queue *thunk* for the scheduler thread; its reply queue. When
        the loop is not running the thunk runs here at once, on the
        engine's stream."""
        rq: "queue.Queue" = queue.Queue()
        if not self.is_ready():
            try:
                with self._on_stream():
                    rq.put((True, thunk()))
            except Exception as e:  # raised by _await_aux
                rq.put((False, e))
            return rq
        self._aux.put((thunk, rq))
        self._wake.set()
        return rq

    def _await_aux(self, rq: "queue.Queue", what: str, timeout: float = 600):
        """The result of a thunk queued by _submit_aux (its exception
        raised here)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                ok, val = rq.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._running:
                    raise RuntimeError("engine shutting down") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{what} produced no result within {timeout}s") from None
        if not ok:
            raise val
        return val

    def _run_aux(self) -> None:
        """Run one queued scheduler thunk (one an iteration, so a batch of
        embedding groups interleaves with decode chunks); its exception
        goes back to its caller."""
        try:
            thunk, rq = self._aux.get_nowait()
        except queue.Empty:
            return
        try:
            rq.put((True, thunk()))
        except (GangLost, GangDesync) as e:  # the caller's, and the loop's
            rq.put((False, e))
            raise
        except Exception as e:  # the caller raises it
            log.exception("scheduler thunk failed")
            rq.put((False, e))

    def warmup(self, include_group: bool = True) -> dict:
        """Run every step shape the serving path hits before the first
        request (JAX ``Engine.warmup``): the decode chunk (on CUDA its
        graph's capture), batch-1 and, with *include_group*, group-cap
        cold prefill for every bucket, one chunked-prefill shape per
        bucket, and with KV restore on the restore path: an import of 1
        and of 2 pages (the park's gather of trash pages written back in
        place) and a restored slot's device writes into slot 0's
        pre-serving state (JAX warms these lest the first preemption pay
        for them mid-flood; its KV evolve has no counterpart: a slot's
        sampling key is its seed). Builds and loads the kernels and fills
        the allocator's and libraries' caches. Every write goes to the
        KV pool's trash page (tables all zero) and no slot bookkeeping
        changes. Call it before start(). Returns {"shapes", "seconds",
        "names"}, the names in the JAX warmup's terms."""
        if self.is_ready():
            raise RuntimeError("warmup() runs before start()")
        if self._gang:
            # Every dispatch of a gang is broadcast; warmup's are not.
            log.info("warmup skipped on a gang")
            self.warmup_result = {"shapes": 0, "seconds": 0.0, "names": [], "skipped": "gang"}
            return self.warmup_result
        t0 = time.monotonic()
        names = []
        B, Kb, mp = self.cfg.max_slots, self.cfg.max_logit_bias, self._max_pages
        with self._on_stream():
            if self.cuda_graphs:
                if self.decode_kernel not in self._graphs:
                    self._capture()
            else:
                self._inputs.make_inert()
                self._chunk_body()
            names.append("decode")

            def first(logits, n):
                z, zf = np.zeros((n,), np.int64), np.zeros((n,), np.float32)
                self._sample_first(logits[:, -1], np.zeros((n, Kb), np.int64),
                                   np.zeros((n, Kb), np.float32), z, z, zf, zf, z)

            cap = max(1, min(self.cfg.prefill_group_cap, B))
            sizes = (1, cap) if include_group and cap > 1 else (1,)
            for bucket in self.cfg.prefill_buckets:
                for n in sizes:
                    logits, _ = llama.prefill_paged_cold(
                        self.params, self.model_config, self._t(np.zeros((n, bucket), np.int64)),
                        self.cache, self._t(np.zeros((n, mp), np.int32)),
                        self._t(np.full((n,), bucket, np.int64)), **self._lora_args([0] * n),
                    )
                    first(logits, n)
                    names.append(f"prefill_batch[{n}x{bucket}]")
            for bucket in self.cfg.prefill_buckets:
                logits, _ = llama.prefill_paged(
                    self.params, self.model_config, self._t(np.zeros((1, bucket), np.int64)),
                    self.cache, self._t(np.zeros((1, mp), np.int32)),
                    self._t([0]), self._t([bucket - 1]), **self._lora_args([0]),
                )
                first(logits, 1)
                names.append(f"prefill_chunk[{bucket}]")
            if self._kv_enabled():
                for n in (1, 2):
                    trash = [0] * n
                    self._import_pages(trash, self._gather_pages(trash))
                    names.append(f"kv_import[{n}]")
                # _admit_restored's device writes, with slot 0's values.
                self._adm_toks[0] = 0
                self._tok_hist[0].copy_(self._t(np.zeros(self._tok_hist.shape[1:], np.int64)))
                names.append("kv_slotset")
            if self._cuda:
                self._stream.synchronize()
        dur = time.monotonic() - t0
        log.info("engine warmup: %d shapes in %.1fs", len(names), dur)
        self.warmup_result = {"shapes": len(names), "seconds": round(dur, 3), "names": names}
        return self.warmup_result

    def load_params_(self, params) -> None:
        """Copy *params*, a tree with this engine's leaves, shapes and
        dtypes, into the engine's parameter storage, before start(). The
        captured decode graphs read every weight by its address, so a
        leaf is written in place and never rebound (as LoRA rows are).
        The page pool's bookkeeping, the park store and the decode state
        return to a fresh engine's: no page cached under the old weights
        is matched again. A parked replica warms up over zeros and takes
        its model's weights this way."""
        if self.is_ready():
            raise RuntimeError("load_params_() runs before start()")
        if self._gang:
            raise RuntimeError("load_params_() is not supported on a gang")
        pairs = []

        def walk(dst, src, where):
            if isinstance(dst, dict):
                if not isinstance(src, dict) or set(src) != set(dst):
                    raise ValueError(f"load_params_: params{where} has keys "
                                     f"{sorted(src) if isinstance(src, dict) else type(src)}, "
                                     f"expected {sorted(dst)}")
                for k in dst:
                    walk(dst[k], src[k], f"{where}/{k}")
            elif (not isinstance(src, torch.Tensor) or src.shape != dst.shape
                  or src.dtype != dst.dtype):
                raise ValueError(f"load_params_: params{where} is "
                                 f"{getattr(src, 'dtype', type(src))} "
                                 f"{tuple(getattr(src, 'shape', ()))}, expected {dst.dtype} "
                                 f"{tuple(dst.shape)}")
            else:
                pairs.append((dst, src))

        walk(self.params, params, "")  # every leaf checked before any is written
        if self._cuda:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream(), torch.no_grad():
            for dst, src in pairs:
                dst.copy_(src)
            for t in (self._lengths, self._last, self._seeds, self._tok_hist, self._adm_toks):
                t.zero_()
            if self._cuda:
                # The caller may free *params* as soon as this returns.
                self._stream.synchronize()
        self._pool = PagePool(self._pool.num_pages, self.cfg.page_size)
        self.kv_park = kvstate.ParkStore()

    # -- scheduler loop ----------------------------------------------------

    def _loop(self) -> None:
        """Pipelined scheduler (JAX ``_loop``): dispatch decode chunk N+1
        before fetching chunk N's tokens, so the host's work overlaps the
        device's. Admissions merge into the next dispatch on the device;
        a chunk dispatched while a slot still held an earlier request is
        reconciled through the dispatch's slot snapshot."""
        log.info("engine loop started (slots=%d, device=%s, graphs=%s)",
                 self.cfg.max_slots, self.device, self.cuda_graphs)
        # This replica's failpoint scope (EngineServer.start stamps it):
        # the scheduler's sites also fire their name@PORT twins.
        set_thread_scope(self.fault_scope)
        pending = None
        with self._on_stream():
            while self._running:
                try:
                    # Failpoint: an injected error takes the reset path
                    # below, as a failed step would.
                    fault("engine.step")
                    t_aux = time.monotonic()
                    self._run_aux()
                    aux_ms = (time.monotonic() - t_aux) * 1e3
                    self._sweep_deadlines()
                    self._sweep_qos_budgets()
                    self._sweep_kv_park()
                    admitted = self._admit_waiting()
                    dispatched = self._dispatch_chunk() if self._n_active > 0 else None
                    # First-token sync AFTER the dispatch: the chunk reads
                    # them from the device staging vector.
                    t_host = time.monotonic()
                    self._emit_admitted(admitted)
                    # The host work chunk N's device time hid: this
                    # iteration's thunk and first-token emission.
                    host_ms = (time.monotonic() - t_host) * 1e3 + aux_ms
                    if pending is not None:
                        self._process_chunk(*pending, host_overlap_ms=host_ms)
                    pending = dispatched
                    self._poll_evictions()
                    if (pending is None and not admitted and self._n_active == 0
                            and self._aux.empty()):
                        # Idle: the goodput gauge reads 0, and the next busy
                        # chunk re-anchors the window.
                        if len(self._rate_window):
                            self._rate_window.reset()
                            self.m_tok_rate.set(0.0)
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                except GangDesync as e:
                    # The followers ran an op this rank did not: no reset
                    # can realign them (they wait inside its collective).
                    log.critical("%s; terminating rank 0", e)
                    self._terminate_rank("gang desynced; restarting the gang", code=14)
                    return  # where _terminate_rank is stubbed (tests)
                except GangLost as e:
                    # A follower's dispatch connection died: fail the work
                    # in flight, go not ready, and wait for the gang to
                    # re-form.
                    self._handle_gang_loss(str(e))
                    pending = None
                except Exception:
                    # A failed capture, replay or step: fail everything in
                    # flight and rebuild the device state (no eager
                    # fallback); a gang's followers rebuild theirs too.
                    log.exception("engine step failed; resetting device state")
                    self._recover()
                    pending = None
            if pending is not None:
                # The chunk dispatched last, still in flight at stop(): its
                # replay counted its launches, so it is fetched and logged
                # too (chunk_log then holds every dispatched chunk).
                try:
                    self._process_chunk(*pending)
                except Exception:
                    log.exception("the last decode chunk failed at stop")

    def _recover(self) -> None:
        """The reset after a failed step: "reset" to the followers, then
        fail the work in flight and rebuild the device state."""
        try:
            self._bcast("reset")
        except GangLost as e:
            if self._running:
                self._handle_gang_loss(str(e))
            return
        self._fail_inflight("engine reset after device error")
        self._reset_device_state()

    def _reset_device_state(self) -> None:
        if self._cuda:
            # The chunk in flight still reads the state about to be
            # rebuilt (a device error may be sticky).
            with contextlib.suppress(RuntimeError):
                self._stream.synchronize()
        self._init_state()

    # -- gang (rank 0's side; the followers' is run_follower) --------------

    def _bcast(self, op: str, scalars: dict | None = None, arrays: dict | None = None) -> None:
        """On rank 0 of a gang, publish the upcoming dispatch to the
        followers BEFORE running it (wire order = dispatch order); a
        no-op otherwise. A send failure is GangLost."""
        if self._publisher is not None:
            try:
                self._publisher.publish(op, scalars, arrays)
            except OSError as e:
                raise GangLost(str(e)) from e

    @contextlib.contextmanager
    def _lockstep(self, op: str, scalars: dict | None = None, arrays: dict | None = None):
        """Broadcast *op*, then run its local dispatch in the with-body. On
        a gang a body failure after the broadcast is GangDesync (the
        followers replayed an op rank 0 never finished); alone, the
        exception passes unchanged into the reset."""
        self._bcast(op, scalars, arrays)
        try:
            yield
        except (GangLost, GangDesync):
            raise
        except Exception as e:
            if self._publisher is not None:
                raise GangDesync(f"rank 0 failed to execute broadcast op {op!r}: {e}") from e
            raise

    def _terminate_rank(self, message: str, code: int) -> None:
        """An unrecoverable gang failure: error everything in flight, then
        exit for the controller to recreate the whole gang. Tests replace
        this hook."""
        self._fail_inflight(message)
        os._exit(code)

    def _handle_gang_loss(self, reason: str) -> None:
        """Rank 0's supervision of a lost follower: fail the work in
        flight, read not ready, wait for the follower to reconnect; then
        "reset" every rank, replay the adapter loads, rebuild the local
        state, count kubeai_gang_reforms_total and serve again. A gang
        that does not re-form within KUBEAI_GANG_REFORM_TIMEOUT seconds
        (<= 0: at once) ends the rank."""
        self._gang_degraded.set()
        log.warning("gang degraded (%s); waiting for re-form", reason)
        self._fail_inflight(f"gang follower lost; re-forming ({reason})")
        pub = self._publisher
        if pub is None:
            self._gang_degraded.clear()
            return
        if self.gang_reform_timeout <= 0:
            self._terminate_rank("gang follower lost; restarting the gang", code=13)
            return
        deadline = time.monotonic() + self.gang_reform_timeout
        while self._running:
            if pub.wait_complete(0.1):
                try:
                    self._bcast("reset")
                    # A restarted follower has an empty bank: every rank
                    # (re)installs the loaded adapters before any dispatch.
                    for name, path in self._adapter_sources.items():
                        self._bcast("load_adapter", scalars={"name": name, "path": path})
                except GangLost:
                    if time.monotonic() >= deadline:
                        break
                    continue
                self._reset_device_state()
                self._gang_degraded.clear()
                self.m_gang_reforms.inc()
                log.info("gang re-formed; serving resumes")
                return
            if time.monotonic() >= deadline:
                break
        if self._running:
            log.critical("gang did not re-form within %.0fs; terminating rank 0",
                         self.gang_reform_timeout)
            self._terminate_rank("gang follower lost; restarting the gang", code=13)

    def broadcast_profile(self, seconds: float, out_dir: str) -> int:
        """Rank 0: ask the followers for a profile of the same window, in
        the dispatch stream (from the scheduler thread). Returns the
        number of followers asked; 0 off a gang."""
        if self._publisher is None:
            return 0
        self._run_on_scheduler(
            lambda: self._bcast("profile", scalars={"seconds": float(seconds), "dir": out_dir}),
            "profile broadcast")
        return int(self._publisher.n_followers)

    # -- gang follower (ranks > 0) -----------------------------------------

    def run_follower(self, follower) -> None:
        """Replay rank 0's dispatch stream from *follower* (an
        engine/gang.py GangFollower) until "stop" or a lost connection
        that does not come back within KUBEAI_GANG_RECONNECT_TIMEOUT
        seconds. Every op runs on this engine's stream with the host
        arrays rank 0 used, so the collectives line up and this rank's
        device state follows rank 0's. No scheduler and no inference
        surface: the balancer routes to rank 0 only."""
        reconnect_timeout = env_float("KUBEAI_GANG_RECONNECT_TIMEOUT", 60.0)
        try:
            with self._on_stream():
                while True:
                    self._follower_profile_tick()
                    try:
                        op, sc, ar = follower.recv()
                    except ConnectionError:
                        # Rank 0 restarted, a network cut, or an injected
                        # gang.follower fault: reconnect with backoff;
                        # rank 0 holds the gang degraded until then and
                        # resets every rank.
                        if reconnect_timeout <= 0 or not hasattr(follower, "reconnect"):
                            log.warning("gang publisher connection closed; follower exiting")
                            return
                        log.warning("gang dispatch stream lost; reconnecting (up to %.0fs)",
                                    reconnect_timeout)
                        try:
                            follower.reconnect(timeout=reconnect_timeout)
                        except Exception as e:
                            log.warning("gang reconnect failed (%s); follower exiting", e)
                            return
                        self.follower_reconnects += 1
                        log.info("gang dispatch stream re-established")
                        continue
                    if op == "stop":
                        return
                    if not self._replay(op, sc or {}, ar):
                        log.error("unknown gang op %r; stopping follower", op)
                        return
                    self.follower_ops[op] += 1
        finally:
            self._follower_profile_tick(force=True)

    def _replay(self, op: str, sc: dict, ar: dict) -> bool:
        """Run one op of rank 0's stream here; False for an unknown op. A
        failure raises and ends the follower: a rank that cannot do what
        rank 0 did cannot stay in lockstep."""
        if op == "reset":
            self._reset_device_state()
        elif op == "load_adapter":
            self._load_adapter_local(sc["name"], sc["path"])
        elif op == "unload_adapter":
            if self._adapters is not None:
                self._adapters.unload(sc["name"])
        elif op == "profile":
            self._follower_profile_start(float(sc.get("seconds", 2.0)), sc.get("dir") or None)
        elif op == "decode":
            # Rank 0's resolved kernel, not this rank's: every rank must
            # run the same program.
            kernel = sc.get("decode_kernel", self.decode_kernel)
            self.follower_kernels.add(kernel)
            for name, view in self._inputs.views.items():
                view[...] = ar[name]
            self._run_chunk(kernel, fetch=False)
        elif op == "prefill_batch":
            self._run_prefill_batch(ar, fetch=False)
        elif op == "prefill_chunk":
            self._run_prefill_chunk(ar, fetch=False)
        elif op == "embed":
            self._run_embed(ar["tokens"], ar["lengths"])
        else:
            return False
        return True

    def _follower_profile_start(self, seconds: float, out_dir: str | None) -> None:
        """Rank 0's /debug/profile fan-out: a torch.profiler session on
        this (the replay) thread, stopped at the first op boundary after
        *seconds* (the port's sessions start and stop on the thread that
        launches). The trace goes to *out_dir*-rank<r>. Best effort."""
        if self._follower_profile is not None:
            log.warning("profile fan-out ignored: a capture is in flight")
            return
        from torch.profiler import ProfilerActivity, profile

        rank = self.tp_group.rank if self.tp_group is not None else 0
        out_dir = f"{out_dir or perf_obs.default_profiler.root}-rank{rank}"
        try:
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self._cuda else []))
            prof.__enter__()
        except Exception:
            log.exception("follower profile capture failed to start")
            return
        self._follower_profile = (prof, time.monotonic() + seconds, out_dir)

    def _follower_profile_tick(self, force: bool = False) -> None:
        if self._follower_profile is None:
            return
        prof, deadline, out_dir = self._follower_profile
        if not force and time.monotonic() < deadline:
            return
        self._follower_profile = None
        try:
            prof.__exit__(None, None, None)
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        except Exception:
            log.exception("follower profile capture failed")

    def _poll_evictions(self) -> None:
        """kubeai_engine_kv_cached_evictions_total from the pool's count."""
        ev = self._pool.evictions
        if ev > self._evictions_seen:
            self.m_cached_evictions.inc(ev - self._evictions_seen)
        self._evictions_seen = ev  # also re-anchors after a rebuilt pool

    def _fail_inflight(self, message: str) -> None:
        """Error every slotted, deferred, queued and thunk-waiting request
        (shutdown and the reset after a failed step)."""
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                slot.req.out.put(("error", message))
                self._finish_request(slot.req, "error", error=message,
                                     completion_tokens=slot.generated)
                self._record_slot_cost(slot, i)
                self._release_slot_pages(i)
        self._n_active = 0
        self.m_active.set(0)
        self._h_active[:] = False
        self._adm_mask[:] = False
        for req in self._deferred:
            req.out.put(("error", message))
            self._finish_request(req, "error", error=message)
        self._deferred.clear()
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.out.put(("error", message))
            self._finish_request(req, "error", error=message)
        while True:
            try:
                _, rq = self._aux.get_nowait()
            except queue.Empty:
                break
            rq.put((False, RuntimeError(message)))
        self.m_queue.set(0)

    DEADLINE_MSG = "deadline exceeded"

    def _sweep_deadlines(self) -> None:
        """Abort the decoding requests past their deadline: the caller (or
        the proxy for it) gave up. The abort is a cancel: the request gets
        its error now, and the slot frees when its next token reaches the
        host (``_emit_token``), after the chunk that wrote it was
        fetched; a later chunk still in flight is dropped by its
        dispatch snapshot. Outcome: cancelled."""
        now = time.monotonic()
        for slot in self._slots:
            if slot is None or slot.req.deadline is None or slot.req.cancelled.is_set():
                continue
            if now > slot.req.deadline:
                slot.req.out.put(("error", self.DEADLINE_MSG))
                slot.req.cancelled.set()
                log.info("aborting a slot past its deadline (%d tokens generated)",
                         slot.generated, extra=trace_extra(slot.req.trace))

    # -- admission ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        return self.cfg.prefill_buckets[-1]

    def _admit_waiting(self) -> list:
        """Admit queued requests into free slots and run their prefills.
        Returns the admitted entries for _emit_admitted: the first-token
        host sync happens after the next decode chunk's dispatch."""
        admitted: list = []
        groups: dict[int, list[tuple[int, Request]]] = {}
        singles: list[tuple[int, Request, int]] = []
        taken: set[int] = set()
        max_bucket = max(self.cfg.prefill_buckets)
        while True:
            if self._n_active + len(taken) >= self.cfg.max_slots:
                # Every slot is busy: an interactive request at the head
                # of the line may seize a preemptible batch slot.
                if self._peek_priority() != "interactive" or not self._preempt_one(taken):
                    break
            # A request waiting for pages keeps the head of the line
            # unless a strictly higher class queued behind it.
            if self._deferred and not self._queue.outranks(self._deferred[0].priority):
                req = self._deferred.pop(0)
            else:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                self.m_queue.set(self.queue_depth())
            if req.cancelled.is_set():
                self._finish_request(req, "cancelled")
                continue
            if req.deadline is not None and time.monotonic() > req.deadline:
                # Expired while queued or deferred: never takes a slot.
                req.out.put(("error", self.DEADLINE_MSG))
                self._finish_request(req, "cancelled", error=self.DEADLINE_MSG)
                continue
            if req.adapter and self._adapter_row(req.adapter) == 0:
                # Checked at submit(), but unloaded while the request
                # waited: the base model's answer would be silently wrong.
                msg = f"adapter {req.adapter!r} is not loaded"
                req.out.put(("error", msg))
                self._finish_request(req, "error", error=msg)
                continue
            if req.restore is not None:
                res = self._admit_restored(req, taken)
                if isinstance(res, int):
                    # Joins the next dispatch through the admission merge:
                    # no prefill, no first-token sync.
                    taken.add(res)
                    continue
                if res == "defer":
                    self._deferred.insert(0, req)
                    self.m_queue.set(self.queue_depth())
                    break
                # None: the restore failed and was cleared; replay below.
            plan = self._plan_admission(req, taken)
            if plan is None and req.priority == "interactive" and self._preempt_one(taken):
                # The seized slot released its pages: plan once more.
                plan = self._plan_admission(req, taken)
            if plan is None:
                self._deferred.insert(0, req)  # wait for pages
                self.m_queue.set(self.queue_depth())
                break
            slot_idx, reuse = plan
            taken.add(slot_idx)
            record_admitted(req.priority, time.monotonic() - req.arrival)
            if reuse == 0 and len(req.prompt_ids) <= max_bucket:
                groups.setdefault(self._bucket(len(req.prompt_ids)), []).append((slot_idx, req))
            else:
                singles.append((slot_idx, req, reuse))

        # Groups first: pages a cold member registered must be written
        # before a same-round reuse single reads them.
        cap = max(1, min(self.cfg.prefill_group_cap, self.cfg.max_slots))
        work = []
        for bucket, items in groups.items():
            for off in range(0, len(items), cap):
                part = items[off : off + cap]
                work.append((part, lambda part=part, bucket=bucket: self._prefill_group(part, bucket)))
        for slot_idx, req, reuse in singles:
            work.append((
                [(slot_idx, req)],
                lambda s=slot_idx, r=req, u=reuse: self._prefill_chunked(s, r, u),
            ))
        for w, (items, thunk) in enumerate(work):
            try:
                admitted.extend(thunk())
            except Exception as e:
                log.exception("prefill failed")
                poisoned = False
                for slot_idx, req in items:
                    if self._slots[slot_idx] is None:
                        # Pages registered at plan time were never written:
                        # unregister them. If a same-round request already
                        # claimed one, its prefill would read garbage. The
                        # pages are back before the caller hears of it.
                        fresh = self._slot_fresh[slot_idx]
                        poisoned |= any(self._pool.refcount(p) > 1 for p in fresh)
                        self._pool.unregister_pages(fresh)
                        self._slot_fresh[slot_idx] = []
                        self._release_slot_pages(slot_idx)
                        req.out.put(("error", f"prefill failed: {e}"))
                        self._finish_request(req, "error", error=f"prefill failed: {e}")
                if poisoned or isinstance(e, (GangLost, GangDesync)):
                    # Escalate to the loop's reset (or the gang's
                    # supervision); requests of this round not prefilled
                    # yet hold no slot, so fail them first.
                    for later, _ in work[w + 1 :]:
                        for slot_idx, req in later:
                            req.out.put(("error", f"prefill failed: {e}"))
                            self._finish_request(req, "error", error=f"prefill failed: {e}")
                    raise
        return admitted

    QOS_BUDGET_MSG = "queue-wait budget exceeded for priority class"

    def _sweep_qos_budgets(self) -> None:
        """Error the queued requests past their class's queue-wait budget
        (KUBEAI_QOS_BUDGET_*; the queue rate-limits the scan)."""
        dropped = self._queue.sweep_budgets()
        for req in dropped:
            req.out.put(("error", self.QOS_BUDGET_MSG))
            self._finish_request(req, "cancelled", error=self.QOS_BUDGET_MSG)
        if dropped:
            self.m_queue.set(self.queue_depth())

    def _peek_priority(self) -> str | None:
        """Class of the next request admission would serve (the deferred
        head, unless the queue holds a strictly higher class)."""
        if self._deferred:
            head = self._deferred[0].priority
            return self._queue.peek_priority() if self._queue.outranks(head) else head
        return self._queue.peek_priority()

    def _preempt_one(self, taken: set) -> bool:
        """Seize one preemptible batch slot for a waiting interactive
        request: the victim (fewest tokens generated) finishes
        "preempted" with no tail flush (flushed text would desync the
        proxy's event-count resume cursor), parking its KV when it asked
        to. True when a slot was freed."""
        victim, best = -1, None
        for i, slot in enumerate(self._slots):
            if slot is None or i in taken:
                continue
            r = slot.req
            if not r.preemptible or r.priority != "batch" or r.finished:
                continue
            if best is None or slot.generated < best:
                victim, best = i, slot.generated
        if victim < 0:
            return False
        log.info("preempting slot %d (batch, %d tokens generated) for interactive admission",
                 victim, best, extra=trace_extra(self._slots[victim].req.trace,
                                                 qos_class="batch"))
        record_preemption(best)
        self._free(victim, "preempted", flush=False, outcome="preempted")
        return True

    def qos_retry_after(self, priority: str) -> int:
        """Retry-After seconds for a shed request of this class, scaled by
        the backlog it would wait behind."""
        backlog = self._queue.backlog_at_or_above(priority)
        return int(min(max(1 + backlog // max(self.cfg.max_slots, 1), 1), 30))

    def _plan_admission(self, req: Request, taken: set[int]) -> tuple[int, int] | None:
        """Reserve a slot and KV pages for prompt + budget, claiming
        resident shared-prefix pages. Returns (slot, reuse_tokens), or
        None when the pool cannot back it yet."""
        slot_idx = next(i for i, s in enumerate(self._slots) if s is None and i not in taken)
        ids = req.prompt_ids
        ps = self.cfg.page_size
        usable_tokens = (self._pool.num_pages - 1) * ps
        budget = max(
            min(
                req.params.max_tokens or self.cfg.default_max_tokens,
                self.cfg.max_seq_len - len(ids) - 1,
                usable_tokens - len(ids),
            ),
            0,
        )
        n_total = pages_for(len(ids) + budget, ps)
        sig = self._lora_sig(req.adapter)
        claimed: list[int] = []
        if self.cfg.prefix_cache_min:
            claimed = self._pool.match_prefix(ids, sig)
            if claimed and len(claimed) * ps < self.cfg.prefix_cache_min:
                self._pool.release(claimed)
                claimed = []
        if n_total - len(claimed) > self._pool.available():
            self._pool.release(claimed)
            return None
        row = claimed + self._pool.allocate(n_total - len(claimed))
        if self.cfg.prefix_cache_min:
            self._slot_fresh[slot_idx] = self._pool.register_chain(ids, sig, row)
        self._slot_budget[slot_idx] = budget
        self._slot_pages[slot_idx] = row
        self._page_table[slot_idx, :] = 0
        self._page_table[slot_idx, : len(row)] = row
        reuse = len(claimed) * ps
        if self.cfg.prefix_cache_min:
            # Counted at admission, not per lookup: a deferred request
            # looks up again every round.
            self.m_prefix_lookup.inc(len(ids))
        if reuse:
            self.m_prefix_cached.inc(reuse)
        return slot_idx, reuse

    def _record_slot_cost(self, slot: _Slot, slot_idx: int) -> None:
        """The request's tenant cost, once, before its pages are released
        or parked: slot-seconds (wall time the slot was held) and
        KV-page-seconds (that time x the pages _plan_admission reserved).
        An untenanted request records nothing."""
        if not slot.req.tenant:
            return
        held = max(time.monotonic() - slot.admitted_at, 0.0)
        tenant_accountant.record_cost(slot.req.tenant, held, held * len(self._slot_pages[slot_idx]))

    def _release_slot_pages(self, slot_idx: int, register: bool = False) -> None:
        row = self._slot_pages[slot_idx]
        if not row:
            return
        if register and self.cfg.prefix_cache_min:
            # Content-register every full page this slot wrote (prompt and
            # emitted tokens) so a follow-up turn can reuse them. A chunk
            # still in flight writes only past them.
            self._pool.register_chain(self._kv_history[slot_idx], self._kv_lora_sig[slot_idx],
                                      row)
        self._pool.release(row)
        self._slot_pages[slot_idx] = []
        self._page_table[slot_idx, :] = 0

    @staticmethod
    def _seed32(sp: SamplingParams, j: int = 0) -> int:
        seed = sp.seed if sp.seed is not None else (time.monotonic_ns() & 0xFFFFFFFF) + j
        return int(seed) & 0xFFFFFFFF

    def _bias_rows(self, sp: SamplingParams) -> tuple[np.ndarray, np.ndarray]:
        K = self.cfg.max_logit_bias
        ids = np.zeros((K,), np.int64)
        vals = np.zeros((K,), np.float32)
        for j, (t, b) in enumerate(tuple(sp.logit_bias)[:K]):
            ids[j] = int(t)
            vals[j] = float(b)
        return ids, vals

    def _t(self, a) -> torch.Tensor:
        """A host array on the device. On CUDA through pinned memory: a
        copy from pageable memory may wait for the chunk in flight."""
        t = torch.as_tensor(a)
        if self._cuda:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        if self.n_valid_vocab < logits.shape[-1]:
            logits = logits.clone()
            logits[..., self.n_valid_vocab :] = float("-inf")
        return logits

    def _sample_first(self, logits, bias_ids, bias_vals, seeds, positions, temp, top_p, top_k):
        """First tokens from prefill logits [N, V] (host rows for the
        rest): device (tokens, logprobs, top-N ids, top-N logprobs)."""
        masked = self._mask_pad(logits)
        biased = apply_logit_bias(masked, self._t(bias_ids), self._t(bias_vals))
        toks = sample(biased, self._t(seeds), self._t(positions), self._t(temp),
                      self._t(top_p), self._t(top_k), max_top_k=self.cfg.max_top_k)
        logp = torch.log_softmax(masked, dim=-1)
        lps = logp.gather(1, toks[:, None])[:, 0]
        t_lp, t_ids = torch.topk(logp, max(1, self.cfg.top_logprobs_k), dim=-1)
        return toks, lps, t_ids, t_lp

    def _sampling_rows(self, reqs, slots, seeds, positions) -> dict:
        """The host arrays a prefill samples its first tokens with: each
        request's slot, seed, position and sampling parameters."""
        sp = [r.params for r in reqs]
        bias = [self._bias_rows(p) for p in sp]
        return {
            "slots": np.asarray(slots, np.int64), "seeds": np.asarray(seeds, np.int64),
            "positions": np.asarray(positions, np.int64),
            "bias_ids": np.stack([b[0] for b in bias]),
            "bias_vals": np.stack([b[1] for b in bias]),
            "temp": np.array([p.temperature for p in sp], np.float32),
            "top_p": np.array([p.top_p for p in sp], np.float32),
            "top_k": np.array([p.top_k for p in sp], np.int64),
        }

    def _first_tokens(self, logits, ar: dict, fetch: bool = True):
        """Sample the first tokens of slots ar["slots"] from prefill logits
        [N, V] (the rest of *ar* from :meth:`_sampling_rows`) into the
        device staging vector adm_toks[slots], which the next chunk merges
        in (JAX ``prefill_batch_fn``), and with *fetch* queue their copy
        to the host: (host tensors, event) for _emit_admitted."""
        out = self._sample_first(logits, ar["bias_ids"], ar["bias_vals"], ar["seeds"],
                                 ar["positions"], ar["temp"], ar["top_p"], ar["top_k"])
        self._adm_toks[self._t(ar["slots"])] = out[0]
        return self._to_host(out) if fetch else None

    def _to_host(self, tensors) -> tuple:
        """Queue the copy of *tensors* to pinned host memory: (host
        tensors, the event after the copy; None on the CPU)."""
        if not self._cuda:
            return tensors, None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _prefill_group(self, items: list[tuple[int, Request]], bucket: int) -> list:
        """One cold prefill call for up to prefill_group_cap prompts of
        the same bucket."""
        n = len(items)
        t_disp = time.monotonic()
        tokens = np.zeros((n, bucket), np.int64)
        lengths = np.zeros((n,), np.int64)
        for j, (slot_idx, req) in enumerate(items):
            tokens[j, : len(req.prompt_ids)] = req.prompt_ids
            lengths[j] = len(req.prompt_ids)
            req.trace.mark("prefill")
        reqs = [r for _, r in items]
        slots = [s for s, _ in items]
        seeds = [self._seed32(r.params, j) for j, r in enumerate(reqs)]
        ar = {"tokens": tokens, "lengths": lengths, "tables": self._page_table[slots],
              **self._sampling_rows(reqs, slots, seeds, lengths)}
        if self._adapters is not None:
            ar["lora_rows"] = np.array([self._adapter_row(r.adapter) for r in reqs], np.int64)
        with self._lockstep("prefill_batch", arrays=ar):
            host, ev = self._run_prefill_batch(ar)
        out = []
        for j, (slot_idx, req) in enumerate(items):
            self._register(slot_idx, req, seeds[j], reuse=0)
            out.append((slot_idx, self._slot_epoch[slot_idx], host, j, ev))
        real = int(lengths.sum())
        self._record_prefill("prefill_group", t_disp, n * bucket - real, bucket=bucket, batch=n,
                             slots=[s for s, _ in items], prompt_tokens=real)
        return out

    def _run_prefill_batch(self, ar: dict, fetch: bool = True):
        """The device side of a cold prefill group (rank 0's and each
        follower's replay): the prompts' KV into their pages and the
        first tokens into adm_toks."""
        logits, _ = llama.prefill_paged_cold(
            self.params, self.model_config, self._t(ar["tokens"]), self.cache,
            self._t(ar["tables"]), self._t(ar["lengths"]), tp_group=self.tp_group,
            **self._lora_kw(ar))
        return self._first_tokens(logits[:, -1], ar, fetch)

    def _run_prefill_chunk(self, ar: dict, fetch: bool = True):
        """The device side of one prefill chunk; the last chunk of a prompt
        (its arrays carry the sampling rows) samples its first token."""
        logits, _ = llama.prefill_paged(
            self.params, self.model_config, self._t(ar["tokens"]), self.cache,
            self._t(ar["table"]), self._t(ar["start"]), self._t(ar["last_idx"]),
            tp_group=self.tp_group, **self._lora_kw(ar))
        if "slots" not in ar:
            return None
        return self._first_tokens(logits[:, -1], ar, fetch)

    def _record_prefill(self, kind: str, t_disp: float, pad_tokens: int, **fields) -> None:
        """A prefill call's step histogram, stall record, padding count and
        flight-recorder step (host time of the call: its launches, the
        device's work runs on behind them)."""
        dur = time.monotonic() - t_disp
        self.m_step.observe(dur, labels={"phase": kind})
        self._stall.record_prefill(kind, dur * 1e3)
        if pad_tokens > 0:
            self.m_pad_prefill.inc(pad_tokens)
        default_recorder.record_step(kind=kind, pad_tokens=pad_tokens,
                                     dur_ms=round(dur * 1e3, 3), **fields)

    def _prefill_chunked(self, slot_idx: int, req: Request, reuse: int) -> list:
        """Chunk-prefill a prompt from offset *reuse* (its first *reuse*
        tokens live in claimed shared pages): largest-bucket chunks, the
        last one padded to its bucket; only the last chunk is sampled."""
        ids = req.prompt_ids
        t_disp = time.monotonic()
        req.trace.mark("prefill")
        req.trace.attrs["reuse_tokens"] = reuse
        table = self._page_table[slot_idx : slot_idx + 1]
        max_bucket = max(self.cfg.prefill_buckets)
        seed = self._seed32(req.params)
        pad_tokens = 0
        for start in range(reuse, len(ids), max_bucket):
            chunk = ids[start : start + max_bucket]
            is_last = start + max_bucket >= len(ids)
            bucket = max_bucket if not is_last else self._bucket(len(chunk))
            pad_tokens += bucket - len(chunk)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, : len(chunk)] = chunk
            ar = {"tokens": padded, "table": table, "start": np.array([start], np.int64),
                  "last_idx": np.array([len(chunk) - 1], np.int64)}
            if self._adapters is not None:
                ar["lora_rows"] = np.array([self._adapter_row(req.adapter)], np.int64)
            if is_last:
                ar.update(self._sampling_rows([req], [slot_idx], [seed], [len(ids)]))
            with self._lockstep("prefill_chunk", arrays=ar):
                first = self._run_prefill_chunk(ar)
        host, ev = first
        self._register(slot_idx, req, seed, reuse)
        self._record_prefill("prefill_chunked", t_disp, pad_tokens, slot=slot_idx,
                             prompt_tokens=len(ids), reuse_tokens=reuse)
        return [(slot_idx, self._slot_epoch[slot_idx], host, 0, ev)]

    def _register(self, slot_idx: int, req: Request, seed: int, reuse: int) -> None:
        """Host bookkeeping of a prefilled slot, and its admission arrays:
        the next dispatch merges it into the device state (position
        prompt_len, first token from adm_toks, seed, and the prompt into
        the history row at G > 0, where the drafter looks bigrams up)."""
        ids = req.prompt_ids
        sp = req.params
        self._slot_fresh[slot_idx] = []  # prefill succeeded; content valid
        self._slots[slot_idx] = _Slot(
            req=req, detok=IncrementalDetokenizer(self.tokenizer),
            prompt_len=len(ids), budget=self._slot_budget[slot_idx],
            event_log=[] if req.park_kv else None, kv_seed=seed,
        )
        self._n_active += 1
        self.m_active.set(self._n_active)
        self.m_prefill.inc(len(ids) - reuse)  # the prefill work done
        self._kv_history[slot_idx] = list(ids)
        self._kv_pending[slot_idx] = None  # set once the token id is known
        self._kv_lora_sig[slot_idx] = self._lora_sig(req.adapter)
        self._h_lora_rows[slot_idx] = self._adapter_row(req.adapter)
        self._slot_epoch[slot_idx] += 1
        self._h_active[slot_idx] = True
        self._h_temp[slot_idx] = sp.temperature
        self._h_top_p[slot_idx] = sp.top_p
        self._h_top_k[slot_idx] = sp.top_k
        self._h_presence[slot_idx] = sp.presence_penalty
        self._h_freq[slot_idx] = sp.frequency_penalty
        self._h_gen_start[slot_idx] = len(ids)
        self._h_bias_ids[slot_idx], self._h_bias_vals[slot_idx] = self._bias_rows(sp)
        self._adm_mask[slot_idx] = True
        self._adm_len[slot_idx] = len(ids)
        self._adm_seed[slot_idx] = seed
        if self._adm_hist is not None:
            self._adm_hist[slot_idx] = 0
            self._adm_hist[slot_idx, : len(ids)] = ids

    def _emit_admitted(self, admitted: list) -> None:
        """One host sync for the first tokens of an admission round,
        after the next chunk's dispatch (JAX ``_emit_admitted``): the
        event follows the prefill, not the chunk queued behind it."""
        if not admitted:
            return
        for ev in {id(a[4]): a[4] for a in admitted if a[4] is not None}.values():
            ev.synchronize()
        for slot_idx, epoch, (toks, lps, t_ids, t_lp), j, _ in admitted:
            tok = int(toks[j])
            if self._slot_epoch[slot_idx] == epoch:
                # This token is what the next decode step writes.
                self._kv_pending[slot_idx] = tok
            slot = self._slots[slot_idx]
            if slot is not None and self._slot_epoch[slot_idx] == epoch:
                top = (list(zip(t_ids[j].tolist(), t_lp[j].tolist()))
                       if slot.req.params.logprobs else None)
                self._emit_token(slot_idx, tok, float(lps[j]), top)

    # -- decode ------------------------------------------------------------

    def _chunk_body(self, kernel: str | None = None) -> tuple:
        """decode_chunk fused steps over every slot, reading and updating
        the static device buffers in place; the function a CUDA graph
        captures. First the admission merge (JAX ``decode_fn``'s rebase);
        then each step verifies G = speculate_tokens drafts per slot (none
        at G = 0). Returns (drafts [K, B, G], corr [K, B], acc [K, B],
        lp_d [K, B, G], lp_c [K, B], t_ids [K, B, G+1, N], t_lp
        [K, B, G+1, N]); the host emits drafts[:a] + [corr] per slot and
        step. Slots that finish mid-chunk keep stepping to the chunk's
        end, as in the JAX engine: their extra tokens are dropped, and
        their writes land past the emitted tokens, in pages that are
        released without content registration (or in the trash page)."""
        mc = self.model_config
        kernel = kernel or self.decode_kernel
        K = self.cfg.decode_chunk
        G = self.cfg.speculate_tokens
        topn = max(1, self.cfg.top_logprobs_k)
        d = self._inputs.dev
        active, tables = d["active"], d["table"]
        temp, top_p, top_k = d["temp"], d["top_p"], d["top_k"]
        presence, freq, gen_start = d["presence"], d["freq"], d["gen_start"]
        bias_ids, bias_vals = d["bias_ids"], d["bias_vals"]
        hist = self._tok_hist
        lora = ({"lora": self._adapters.bank, "lora_rows": d["lora_rows"]}
                if self._adapters is not None else {})
        lengths, last, seeds = merge_admissions(
            d["adm_mask"], d["adm_len"], d["adm_seed"], self._adm_toks, d.get("adm_hist"),
            self._lengths, self._last, self._seeds, hist)
        self._seeds.copy_(seeds)
        rows = torch.arange(self.cfg.max_slots, device=self.device)[:, None]
        w_idx = torch.arange(hist.shape[1], device=self.device)[None, :]
        offs = torch.arange(G + 1, device=self.device)[None, :]
        if G:
            # Drafts are exact only against the raw argmax of the verify
            # positions: sampled slots and slots with a penalty or a bias
            # accept none.
            may_accept = ((temp <= 0.0) & active & (presence == 0.0) & (freq == 0.0)
                          & (bias_vals == 0.0).all(1))
        outs = []
        for _ in range(K):
            drafts = ngram_drafts(hist, lengths, last, G) if G else last[:, None][:, :0]
            inputs = torch.cat([last[:, None], drafts], dim=1) if G else last[:, None]
            # The history records this step's inputs at positions
            # lengths .. lengths+G before penalties read it: every emitted
            # token counts, and rejected drafts sit past the window.
            pos = lengths[:, None] + offs
            hist[rows, pos] = torch.where(active[:, None], inputs, hist[rows, pos])
            logits, _ = llama.decode_speculative_paged(
                self.params, mc, inputs, self.cache, tables, lengths,
                decode_kernel=kernel, tp_group=self.tp_group, **lora,
            )
            logits = self._mask_pad(logits)  # [B, G+1, V]
            # Penalties and bias steer position 0's choice only.
            pen0 = logits[:, 0]
            if self.cfg.enable_penalties:
                valid = (w_idx >= gen_start[:, None]) & (w_idx <= lengths[:, None])
                pen0 = apply_penalties(pen0, hist, valid, presence, freq)
            pen0 = apply_logit_bias(pen0, bias_ids, bias_vals)
            corr = sample(pen0, seeds, lengths + 1, temp, top_p, top_k, self.cfg.max_top_k)
            lse = torch.logsumexp(logits, dim=-1)  # [B, G+1]
            if G:
                # Greedy slots accept the longest draft prefix the model's
                # argmax agrees with; their next token is the argmax
                # after it (position 0's penalised choice when none).
                yhat = logits.argmax(dim=-1)
                acc = torch.cumprod((yhat[:, :G] == drafts).long(), dim=1).sum(1)
                acc = torch.where(may_accept, acc, 0)
                corr = torch.where(acc > 0, yhat.gather(1, acc[:, None])[:, 0], corr)
                lp_d = logits[:, :G].gather(2, drafts[:, :, None])[:, :, 0] - lse[:, :G]
                at_a = logits.gather(1, acc[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]
                lse_a = lse.gather(1, acc[:, None])[:, 0]
            else:
                acc = torch.zeros_like(lengths)
                lp_d = lse[:, :0]
                at_a, lse_a = logits[:, 0], lse[:, 0]
            corr = torch.where(active, corr, last)
            lp_c = at_a.gather(1, corr[:, None])[:, 0] - lse_a
            # Top-N at every position: the raw model distribution.
            t_raw, t_ids = torch.topk(logits, topn, dim=-1)
            outs.append((drafts, corr, acc, lp_d, lp_c, t_ids, t_raw - lse[..., None]))
            lengths = torch.where(active, lengths + acc + 1, lengths)
            last = corr
        self._lengths.copy_(lengths)
        self._last.copy_(last)
        return tuple(torch.stack(x) for x in zip(*outs))

    def _capture(self, kernel: str | None = None) -> _ChunkGraph:
        """Capture the decode chunk as one CUDA graph for the resolved
        decode kernel (JAX ``_decode_jit_for`` builds one program per
        flavour). The chunk first runs once eagerly on the capture stream
        over inert inputs (no slot active: the state stays as it is and
        writes go to the trash page), so every kernel instance is built,
        loaded and configured and the stream's split-KV scratch and W8A16
        workspace are reserved; the capture then holds that scratch. The
        counts the capture added are taken back and added at each replay.
        Any failure raises: there is no eager fallback. Under nccl the
        graph captures the chunk's collectives; every rank of the gang
        captures at the same decode op, so the eager run's collectives
        line up too."""
        kernel = kernel or self.decode_kernel
        t0 = time.monotonic()
        cs = self._capture_stream
        self._inputs.make_inert()
        cs.wait_stream(self._stream)
        with torch.cuda.stream(cs):
            self._chunk_body(kernel)
        cs.synchronize()  # torch.cuda.graph synchronizes on entry anyway
        t_eager = time.monotonic()
        gc.collect()  # as torch.cuda.graph's entry does, timed apart here
        t_gc = time.monotonic()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool, stream=cs,
                                  capture_error_mode="thread_local"):
                t_rec = time.monotonic()
                outputs = self._chunk_body(kernel)
                t_end = time.monotonic()
        finally:
            after = _counts()
            _set_counts(before)
        t_inst = time.monotonic()
        # Where a capture's seconds go: the eager chunk (enqueue and run),
        # the garbage collection, torch.cuda.graph's entry, recording the
        # chunk's launches, and ending the capture (instantiation).
        self.graph_capture_segments[kernel] = {
            "eager_s": t_eager - t0, "gc_s": t_gc - t_eager, "enter_s": t_rec - t_gc,
            "record_s": t_end - t_rec, "instantiate_s": t_inst - t_end}
        _build.hold_stream(cs)
        self._stream.wait_stream(cs)
        delta = {}
        for key, v in after.items():
            d = v - before[key]
            if d:
                delta[key] = d
        g = self._graphs[kernel] = _ChunkGraph(graph, outputs, delta)
        self.graph_capture_seconds[kernel] = time.monotonic() - t0
        self.m_captures.inc()
        log.info("decode chunk captured (%s) in %.2fs", kernel, self.graph_capture_seconds[kernel])
        return g

    def _dispatch_chunk(self) -> tuple:
        """Dispatch one decode chunk and snapshot which request occupied
        each slot (JAX ``_dispatch_chunk``): upload the host inputs
        (admission arrays included, then cleared: this dispatch consumes
        them), replay the graph (or run the chunk eagerly), and queue the
        outputs' copy into a pinned set with an event behind it. On a gang
        the host inputs and the decode kernel are broadcast first."""
        t_start = time.monotonic()
        coll0 = self._collective_s()
        with self._lockstep("decode", scalars={"decode_kernel": self.decode_kernel},
                            arrays=self._inputs.views):
            host, events = self._run_chunk(self.decode_kernel)
        snapshot = [(i, s, self._slot_epoch[i]) for i, s in enumerate(self._slots) if s is not None]
        return (host, events, snapshot, t_start, time.monotonic(),
                (self._collective_s() - coll0) * 1e3)

    def _collective_s(self) -> float:
        """Host seconds this rank's group has spent in collectives (the
        host-staged gloo ones; a graphed chunk's run on the device)."""
        if self.tp_group is None:
            return 0.0
        return sum(sec for _, sec in self.tp_group.stats.values())

    def _run_chunk(self, kernel: str, fetch: bool = True) -> tuple:
        """The device side of a decode chunk (rank 0's and each follower's
        replay): upload the host inputs, clear the admission mask, replay
        the chunk's graph for *kernel* (captured at its first use) or run
        it eagerly, and with *fetch* queue the outputs' copy. Returns
        (outputs, (start event, end event))."""
        graph = None
        if self.cuda_graphs:
            graph = self._graphs.get(kernel) or self._capture(kernel)
        ev0 = None
        if self._cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        self._inputs.upload()
        self._adm_mask[:] = False
        outs = graph.replay() if graph is not None else self._chunk_body(kernel)
        if not fetch:
            return None, (None, None)
        if self._cuda:
            j, self._out_turn = self._out_turn, self._out_turn ^ 1
            if self._out_sets[j] is None:
                self._out_sets[j] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                     for t in outs]
            host = self._out_sets[j]
            for h, t in zip(host, outs):
                h.copy_(t, non_blocking=True)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            host, ev = outs, None
        return host, (ev0, ev)

    def _process_chunk(self, host, events, snapshot, t_start: float, t_disp: float,
                       collective_ms: float = 0.0, host_overlap_ms: float = 0.0) -> None:
        """Wait for a dispatched chunk's outputs and emit its tokens (JAX
        ``_process_chunk``): a token reaches a request only while its slot
        still holds the request it held at dispatch; the slot's KV history
        advances only while its epoch is the dispatch's."""
        t_fetch = time.monotonic()
        ev0, ev = events
        if ev is not None:
            ev.synchronize()
        t_fetched = time.monotonic()
        drafts, corr, acc, lp_d, lp_c, t_ids, t_lp = (x.numpy() for x in host)
        K, G = acc.shape[0], drafts.shape[2]
        # Saturation accounting before emission: a client unblocked by a
        # terminal event below already sees these.
        self.m_step.observe(t_fetched - t_disp, labels={"phase": "decode_chunk"})
        self.m_slot_steps.inc(K * len(snapshot), labels={"state": "active"})
        if self.cfg.max_slots > len(snapshot):
            self.m_slot_steps.inc(K * (self.cfg.max_slots - len(snapshot)),
                                  labels={"state": "idle"})
        n_emitted = 0
        drafted = accepted = 0
        for k in range(K):
            for i, slot_obj, epoch in snapshot:
                owned = self._slots[i] is slot_obj
                a = int(acc[k, i])
                if G and owned and slot_obj.req.params.temperature <= 0.0:
                    drafted += G
                    accepted += a
                want_top = owned and slot_obj.req.params.logprobs
                emitted = [(int(drafts[k, i, j]), float(lp_d[k, i, j]), j) for j in range(a)]
                emitted.append((int(corr[k, i]), float(lp_c[k, i]), a))
                for tok, lp, j in emitted:
                    # Each step wrote its pending (input) token; each
                    # emitted token becomes the next write. Skip when a
                    # new occupant reset the slot.
                    if self._slot_epoch[i] == epoch:
                        if self._kv_pending[i] is not None:
                            self._kv_history[i].append(self._kv_pending[i])
                        self._kv_pending[i] = tok
                    # Emit only while the slot still holds the request it
                    # held at dispatch (it may have finished mid-chunk, or
                    # been freed and re-admitted since).
                    if self._slots[i] is slot_obj:
                        top = list(zip(t_ids[k, i, j].tolist(), t_lp[k, i, j].tolist())) \
                            if want_top else None
                        self._emit_token(i, tok, lp, top)
                        n_emitted += 1
        if G:
            self.spec_drafted += drafted
            self.spec_accepted += accepted
            self.m_spec_drafted.inc(drafted)
            self.m_spec_accepted.inc(accepted)
        now = time.monotonic()
        self._rate_window.add(n_emitted, now)
        self.m_tok_rate.set(round(self._rate_window.rate(now), 3))
        entry = {
            "steps": K, "slots": len(snapshot), "tokens": n_emitted,
            "graph": self.cuda_graphs,
            "dispatch_ms": (t_disp - t_start) * 1e3,  # upload + replay (or eager launches)
            "fetch_wait_ms": (t_fetched - t_fetch) * 1e3,  # host blocked on the chunk
            "emit_ms": (now - t_fetched) * 1e3,
            "dur_ms": (t_fetched - t_disp) * 1e3,  # dispatched -> fetched
            "fetched_at": t_fetched,
            "device_ms": ev0.elapsed_time(ev) if ev is not None else None,
            # In the dispatch: a host-staged group's collectives.
            "collective_ms": collective_ms,
        }
        self.chunk_log.append(entry)
        self._stall.record_decode(dispatch_ms=entry["dispatch_ms"],
                                  host_overlap_ms=host_overlap_ms,
                                  fetch_wait_ms=entry["fetch_wait_ms"],
                                  emit_ms=entry["emit_ms"], now=now)
        # The flight recorder's step record (the JAX engine's fields):
        # one per chunk, a graph replay on the card.
        step = {
            "kind": "decode_chunk", "steps": K, "slots": [i for i, _, _ in snapshot],
            "tokens": n_emitted, "kernel": self.decode_kernel, "graph": self.cuda_graphs,
            "pages_used": self._pool.used(), "pages_total": self._pool.num_pages - 1,
            "queue_depth": self.queue_depth(),
            "host_overlap_ms": round(max(host_overlap_ms, 0.0), 3),
            **{k: round(entry[k], 3) for k in ("dur_ms", "fetch_wait_ms", "dispatch_ms",
                                                "emit_ms")},
            "device_ms": entry["device_ms"],
        }
        if self.tp_group is not None:
            step["collective_ms"] = round(collective_ms, 3)
        if G:
            step["spec_drafted"], step["spec_accepted"] = drafted, accepted
        default_recorder.record_step(**step)

    # -- emission ----------------------------------------------------------

    def _emit_token(self, slot_idx: int, token_id: int, logprob: float | None = None, top=None):
        """Deliver one generated token; apply EOS, stop strings and the
        token budget."""
        slot = self._slots[slot_idx]
        req = slot.req
        if req.cancelled.is_set():
            self._free(slot_idx, "stop", deliver=False)
            return
        slot.generated += 1
        self.m_gen.inc()
        if slot.generated == 1:
            # True TTFT: the first token reached emission.
            self.m_ttft.observe(time.monotonic() - req.arrival)
        req.trace.tok()
        eos = self.tokenizer.eos_id
        if eos is not None and token_id == eos:
            self._free(slot_idx, "stop")
            return
        slot.committed_text += slot.detok.push(token_id)
        text = slot.committed_text
        search_from = max(0, slot.delivered_chars - slot.holdback)
        for s in req.params.stop:
            pos = text.find(s, search_from)
            if pos != -1:
                tail = text[slot.delivered_chars : pos]
                slot.delivered_chars = pos
                self._put_event(slot, ("token", token_id, tail, logprob, top))
                self._free(slot_idx, "stop", flush=False)
                return
        emit_upto = max(len(text) - slot.holdback, slot.delivered_chars)
        delta = text[slot.delivered_chars : emit_upto]
        slot.delivered_chars = emit_upto
        self._put_event(slot, ("token", token_id, delta, logprob, top))
        if slot.generated >= slot.budget:
            self._free(slot_idx, "length")

    @staticmethod
    def _put_event(slot: _Slot, ev: tuple) -> None:
        if slot.event_log is not None:
            slot.event_log.append(ev)
        slot.req.out.put(ev)

    def _free(self, slot_idx: int, reason: str, deliver: bool = True, flush: bool = True,
              outcome: str | None = None):
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        self._n_active -= 1
        self.m_active.set(self._n_active)
        self._h_active[slot_idx] = False
        self._record_slot_cost(slot, slot_idx)
        # A finish the request asked to park at (a preempted batch stream,
        # a handoff-capped "length") serializes its KV before the pages
        # are released; any failure releases them and the resume replays.
        offer = None
        want = {"preempt": "preempted", "handoff": "length"}.get(slot.req.park_kv)
        if deliver and reason == want and self._kv_enabled():
            offer = self._park_slot(slot_idx, slot)
        if offer is None:
            self._release_slot_pages(slot_idx, register=True)
        if not deliver:
            self._finish_request(slot.req, outcome or "cancelled", finish_reason=reason,
                                 completion_tokens=slot.generated)
            return
        if flush:
            # Deliver held-back chars (stop-checked: they never were).
            text = slot.detok.text()
            end = len(text)
            search_from = max(0, slot.delivered_chars - slot.holdback)
            for s in slot.req.params.stop:
                pos = text.find(s, search_from)
                if pos != -1:
                    end = min(end, pos)
                    reason = "stop"
            tail = text[slot.delivered_chars : end]
            if tail:
                slot.req.out.put(("token", -1, tail, None, None))
        slot.req.out.put(("done", FinishInfo(reason, slot.prompt_len, slot.generated, kv=offer)))
        self._finish_request(slot.req, outcome or "ok", finish_reason=reason,
                             completion_tokens=slot.generated)

    # -- KV park / restore (engine/kvstate.py) -----------------------------

    def _kv_enabled(self) -> bool:
        """KUBEAI_KV_RESTORE=0 turns parking, offers and imports off; so
        does a gang (the JAX engine's rule: a park's gather and an import
        would be dispatches the followers never see)."""
        return kvstate.restore_enabled() and not self._gang

    def _pool_rows(self, pages: list[int]) -> torch.Tensor:
        """Rows of the flat [L*P, ...] pool holding *pages* in every
        layer, page-major: [len(pages) * L] on the device."""
        P, L = self._pool.num_pages, self.model_config.num_layers
        idx = np.arange(L, dtype=np.int64)[None, :] * P + np.asarray(pages, np.int64)[:, None]
        return self._t(idx.reshape(-1))

    def _gather_pages(self, pages: list[int]) -> torch.Tensor:
        """The [n, L, page, 2*Kv, h] contents of *pages*, on the host. The
        gather runs on the engine's stream, so it waits for the chunk in
        flight (which writes only past the parked history)."""
        kv = self.cache["kv"]
        raw = kv.view(torch.uint8).index_select(0, self._pool_rows(pages))
        return raw.cpu().view(kv.dtype).reshape(len(pages), self.model_config.num_layers,
                                                *kv.shape[1:])

    def _import_pages(self, pages: list[int], payload: torch.Tensor) -> None:
        """Write a blob's [n, L, ...] payload into *pages* of the pool in
        place, on the engine's stream: the captured decode graphs hold the
        pool's address, so it is never rebound."""
        kv = self.cache["kv"]
        src = payload.reshape(-1, *kv.shape[1:]).view(torch.uint8)
        kv.view(torch.uint8).index_copy_(0, self._pool_rows(pages), self._t(src))

    def _park_slot(self, slot_idx: int, slot: _Slot) -> dict | None:
        """Serialize a finishing slot's KV state into the park store and
        pin its history pages for a same-replica restore. Returns the offer
        the finish carries, or None (any failure or unsettled state: the
        caller releases the pages and the resume replays)."""
        history = list(self._kv_history[slot_idx])
        pending = self._kv_pending[slot_idx]
        row = self._slot_pages[slot_idx]
        if (pending is None or not row
                or len(history) - slot.prompt_len != slot.generated - 1
                or slot.event_log is None or len(slot.event_log) != slot.generated):
            return None  # e.g. preempted before its first token reached the host
        n_hist = pages_for(len(history), self.cfg.page_size)
        if n_hist > len(row):
            return None
        hist_pages = row[:n_hist]
        t0 = time.monotonic()
        try:
            payload = self._gather_pages(hist_pages)
            t_gathered = time.monotonic()
            blob = kvstate.encode_state(
                model_fp=self._kv_fp,
                request_fp=kvstate.request_fingerprint(slot.req.prompt_ids, slot.req.params,
                                                       slot.req.adapter),
                history=history, pending=int(pending), prompt_len=slot.prompt_len,
                generated=slot.generated, committed_text=slot.committed_text,
                delivered_chars=slot.delivered_chars,
                key_data=np.array([slot.kv_seed], np.uint32), events=slot.event_log,
                adapter=slot.req.adapter, payload=payload,
            )
            # Failpoint: error aborts the park (the resume replays);
            # corrupt parks a mangled blob the import's checksums reject.
            blob = fault("engine.kv_export", payload=blob)
        except FaultError:
            kvstate.M_KV_EXPORT.inc(labels={"outcome": "error"})
            return None
        except Exception:
            log.exception("KV export failed; the resume will replay")
            kvstate.M_KV_EXPORT.inc(labels={"outcome": "error"})
            return None
        if self.cfg.prefix_cache_min:
            # As the plain release does: follow-up turns still hit these pages.
            self._pool.register_chain(history, self._kv_lora_sig[slot_idx], row)
        key = uuid.uuid4().hex
        if all(not self._pool.is_parked(p) for p in hist_pages):
            # The slot's reference to its history pages passes to the park.
            self._pool.park(key, hist_pages)
            self._pool.release(row[n_hist:])
        else:
            # A page is pinned under another key (a shared prefix of parked
            # content): the blob alone; a restore uploads it.
            self._pool.release(row)
        self._slot_pages[slot_idx] = []
        self._page_table[slot_idx, :] = 0
        for evicted in self.kv_park.put(key, blob, len(history)):
            self._pool.drop_park(evicted)
        kvstate.M_KV_EXPORT.inc(labels={"outcome": "ok"})
        t1 = time.monotonic()
        self.kv_log.append({"event": "park", "ms": (t1 - t0) * 1e3,
                            "gather_ms": (t_gathered - t0) * 1e3,
                            "encode_ms": (t1 - t_gathered) * 1e3, "bytes": len(blob),
                            "tokens": len(history), "pages": n_hist, "kind": slot.req.park_kv})
        log.info("parked KV of slot %d: %d tokens, %d pages, %d bytes (%s)",
                 slot_idx, len(history), n_hist, len(blob), slot.req.park_kv)
        return {"key": key, "source": self.kv_advertise, "tokens": len(history),
                "bytes": len(blob)}

    def _admit_restored(self, req: Request, taken: set[int]) -> int | str | None:
        """Admit a resume carrying validated KV state: take its pinned
        pages back (same replica) or upload the payload into fresh pages,
        stage the slot for the next dispatch's admission merge (position,
        pending token, seed, history row), and re-emit the parked events
        so the stream is the replay's. Returns the slot, "defer" when the
        pool cannot back prompt + budget yet, or None on any failure (the
        restore is cleared and the request replays)."""
        state = req.restore
        t0 = time.monotonic()
        ps = self.cfg.page_size
        ids = req.prompt_ids
        row: list[int] | None = None
        pinned: list[int] | None = None
        outcome = "error"
        try:
            # Failpoint: the scheduler-side import fails after the serving
            # thread validated the blob (the deepest replay fallback).
            fault("engine.kv_import")
            n_hist = pages_for(len(state.history), ps)
            kv = self.cache["kv"]
            L = self.model_config.num_layers
            if (state.prompt_len != len(ids) or state.history[: len(ids)] != list(ids)
                    or len(state.history) - len(ids) != state.generated - 1
                    or len(state.events) != state.generated):
                raise kvstate.KVFormatError("restore state does not match request")
            # The key data is the port's 32-bit seed, shape (1,): a JAX
            # blob (threefry key data) is refused here, and a port blob by
            # the JAX engine's own check.
            if (tuple(state.payload.shape) != (n_hist, L, *kv.shape[1:])
                    or state.payload.dtype != kv.dtype
                    or tuple(np.asarray(state.key_data).shape) != (1,)):
                raise kvstate.KVFormatError("restore payload layout mismatch")
            usable_tokens = (self._pool.num_pages - 1) * ps
            budget = max(min(req.params.max_tokens or self.cfg.default_max_tokens,
                             self.cfg.max_seq_len - len(ids) - 1, usable_tokens - len(ids)), 0)
            if state.generated >= budget:
                raise ValueError("parked request has no budget left to resume")
            # Rebuild the detokenizer from the emitted ids; a mismatch with
            # the parked cursors means the stream could not continue
            # byte-identically: refuse before touching the device.
            detok = IncrementalDetokenizer(self.tokenizer)
            committed = ""
            for t in state.history[len(ids):] + [state.pending]:
                committed += detok.push(t)
            if committed != state.committed_text or not (
                    0 <= state.delivered_chars <= len(committed)):
                raise kvstate.KVFormatError("detokenizer replay mismatch")
            n_total = pages_for(len(ids) + budget, ps)
            pinned = self._pool.unpark(req.restore_key) if req.restore_key else None
            if pinned is not None and len(pinned) != n_hist:
                self._pool.release(pinned)
                pinned = None
            if n_total - (len(pinned) if pinned is not None else 0) > self._pool.available():
                if pinned is not None:
                    self._pool.park(req.restore_key, pinned)  # put back untouched
                return "defer"
            slot_idx = next(i for i, s in enumerate(self._slots) if s is None and i not in taken)
            t_dev = None
            if pinned is not None:
                row, pinned = pinned + self._pool.allocate(n_total - len(pinned)), None
                how = "unparked"
            else:
                row = self._pool.allocate(n_total)
                how = "uploaded"
                t_dev = self._event()
                self._import_pages(row[:n_hist], state.payload)
            # The slot's device row, staged for the next dispatch's merge:
            # its pending token into the staging vector, its history row.
            self._adm_toks[slot_idx] = int(state.pending)
            hist_row = np.zeros((self._tok_hist.shape[1],), np.int64)
            hist_row[: len(state.history)] = state.history
            if self._adm_hist is not None:
                self._adm_hist[slot_idx] = hist_row
            else:
                # No merge of the history at G = 0: the penalties read the
                # generated tokens from the row itself.
                self._tok_hist[slot_idx].copy_(self._t(hist_row))
            t_end = self._event()
            seed = int(np.asarray(state.key_data).reshape(-1)[0])
        except kvstate.KVFormatError as e:
            outcome = "corrupt"
            log.warning("KV restore rejected (%s); falling back to replay", e)
        except Exception as e:
            log.warning("KV restore failed (%s); falling back to replay", e)
        else:
            sp = req.params
            sig = self._lora_sig(req.adapter)
            slot = _Slot(req=req, detok=detok, prompt_len=len(ids), budget=budget,
                         committed_text=committed, delivered_chars=int(state.delivered_chars),
                         generated=int(state.generated),
                         event_log=list(state.events) if req.park_kv else None, kv_seed=seed)
            self._slots[slot_idx] = slot
            self._n_active += 1
            self.m_active.set(self._n_active)
            self._slot_fresh[slot_idx] = []
            self._slot_budget[slot_idx] = budget
            self._slot_pages[slot_idx] = row
            self._page_table[slot_idx, :] = 0
            self._page_table[slot_idx, : len(row)] = row
            self._kv_history[slot_idx] = list(state.history)
            self._kv_pending[slot_idx] = int(state.pending)
            self._kv_lora_sig[slot_idx] = sig
            self._slot_epoch[slot_idx] += 1
            self._h_active[slot_idx] = True
            self._h_temp[slot_idx] = sp.temperature
            self._h_top_p[slot_idx] = sp.top_p
            self._h_top_k[slot_idx] = sp.top_k
            self._h_presence[slot_idx] = sp.presence_penalty
            self._h_freq[slot_idx] = sp.frequency_penalty
            self._h_gen_start[slot_idx] = len(ids)
            self._h_bias_ids[slot_idx], self._h_bias_vals[slot_idx] = self._bias_rows(sp)
            self._h_lora_rows[slot_idx] = self._adapter_row(req.adapter)
            self._adm_mask[slot_idx] = True
            self._adm_len[slot_idx] = len(state.history)
            self._adm_seed[slot_idx] = seed
            if self.cfg.prefix_cache_min:
                self._pool.register_chain(state.history, sig, row)
            # The parked events again, verbatim: the stream is the one the
            # replay would have regenerated.
            for ev in state.events:
                req.out.put(ev)
            self.kv_park.drop(req.restore_key)
            dur = time.monotonic() - t0
            kvstate.M_KV_IMPORT.inc(labels={"outcome": "ok"})
            kvstate.M_KV_RESTORE_SECONDS.observe(dur, labels={"phase": "import"})
            self._stall.record_kv_transfer(dur * 1e3)
            record_admitted(req.priority, time.monotonic() - req.arrival)
            self.kv_log.append({"event": "import", "how": how, "host_ms": dur * 1e3,
                                "device_events": (t_dev, t_end) if t_dev is not None else None,
                                "tokens": len(state.history), "pages": n_hist})
            log.info("restored KV into slot %d: %d tokens (%s)", slot_idx,
                     len(state.history), how)
            req.restore = None
            return slot_idx
        kvstate.M_KV_IMPORT.inc(labels={"outcome": outcome})
        if row:
            self._pool.release(row)
        if pinned:
            self._pool.release(pinned)
        req.restore = None
        return None

    def _event(self):
        """A CUDA event recorded on the current stream (None on the CPU)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _sweep_kv_park(self) -> None:
        """Release the pinned pages of park entries whose blob expired
        (TTL or byte cap); throttled to once per 5 s."""
        now = time.monotonic()
        if now - self._kv_park_sweep_at < 5.0:
            return
        self._kv_park_sweep_at = now
        self.kv_park.sweep()
        for key in self._pool.parked_keys():
            if self.kv_park.get(key) is None:
                self._pool.drop_park(key)


def merge_admissions(adm_mask, adm_len, adm_seed, adm_toks, adm_hist,
                     lengths, last, seeds, hist) -> tuple:
    """Rebase the slots admitted since the last dispatch (the JAX
    ``decode_fn``'s admission merge): each admitted slot's position, its
    first token from the device staging vector *adm_toks*, its seed and,
    at G > 0 (*adm_hist* given), its history row, written into *hist* in
    place. Returns the merged (lengths, last, seeds)."""
    if adm_hist is not None:
        hist.copy_(torch.where(adm_mask[:, None], adm_hist, hist))
    return (torch.where(adm_mask, adm_len, lengths), torch.where(adm_mask, adm_toks, last),
            torch.where(adm_mask, adm_seed, seeds))


def ngram_drafts(hist: torch.Tensor, lengths: torch.Tensor, last: torch.Tensor,
                 G: int) -> torch.Tensor:
    """[B, G] drafts from the device token history [B, W] (the JAX
    engine's n-gram lookup): per slot the latest earlier occurrence of
    the bigram (hist[L-1], last), L = lengths, and the G tokens that
    followed it; zeros where there is no match or the tail is short
    (they fail verification)."""
    B, W = hist.shape
    idx = torch.arange(W, device=hist.device)[None, :]
    L = lengths[:, None]
    prev = hist.gather(1, torch.clamp(L - 1, min=0))
    nxt = torch.roll(hist, -1, dims=1)  # nxt[j] = hist[j+1]
    ok = (hist == prev) & (nxt == last[:, None]) & (idx < L - 1) & (L > 0)
    j = torch.where(ok, idx, -1).amax(dim=1, keepdim=True)  # -1: no match
    didx = j + 2 + torch.arange(G, device=hist.device)[None, :]
    valid = (j >= 0) & (didx < L)
    return torch.where(valid, hist.gather(1, torch.clamp(didx, 0, W - 1)), 0)


def test_model_config() -> ModelConfig:
    """The JAX package's float32 test model (``--model test:tiny``)."""
    return ModelConfig(
        vocab_size=272,  # 259 used; padded as in the JAX package
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        dtype="float32",
        max_position=2048,
    )


# Prefill buckets of a test:tiny engine served from the command line.
TEST_PREFILL_BUCKETS = (16, 32, 64, 128)


def build_test_engine(
    engine_config: EngineConfig | None = None,
    seed: int = 0,
    model_config: ModelConfig | None = None,
    device: torch.device | str | None = None,
    params=None,
    quantization: str = "",
) -> Engine:
    """A tiny byte-vocab float32 engine (the JAX package's test config).
    *params* replaces the random weights, e.g. the JAX engine's own
    through models/convert.py::params_from_jax; ``quantization="int8"``
    quantizes them (the W8A16 kernels' float32 instance on the card)."""
    if quantization not in ("", "int8"):
        raise ValueError(f"unsupported quantization {quantization!r} (supported: int8)")
    dev = resolve_device(device)
    mc = model_config or test_model_config()
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = llama.init_params(mc, gen, device=dev)
    if quantization:
        from kubeai_tpu_torch.engine.weights import quantize_model_params  # imports this module

        params = quantize_model_params(params, mc)
    ec = engine_config or EngineConfig(
        max_slots=4, max_seq_len=256, prefill_buckets=(16, 32, 64, 128)
    )
    return Engine(mc, params, ByteTokenizer(), ec, device=dev)


# The catalog's model families at their published widths (models/base.py).
PRESETS = {
    "llama-3.1-8b": llama_3_1_8b,
    "qwen2.5-7b": qwen2_5_7b,
    "gemma-2b": gemma_2b,
    "gemma2-2b": gemma2_2b,
    "mixtral-8x7b": mixtral_8x7b,
}


def build_engine(
    preset: str,
    device: torch.device | str | None = None,
    engine_config: EngineConfig | None = None,
    seed: int = 0,
    quantization: str = "",
    num_layers: int | None = None,
) -> Engine:
    """An engine over a preset's full widths with random weights in the
    preset's dtype drawn from *seed* (``--model <dir>`` loads a
    checkpoint: engine/weights.py), at the preset's depth unless
    *num_layers* cuts it (Mixtral-8x7B's 32 layers do not fit one 80 GB
    card in bf16). ``quantization="int8"`` quantizes them, one stacked
    weight at a time (a MoE model's experts and router stay in full
    precision, as in the JAX package). The byte tokenizer drives it;
    logits past its vocab are masked."""
    mc = preset_config(preset, num_layers)
    if quantization not in ("", "int8"):
        raise ValueError(f"unsupported quantization {quantization!r} (supported: int8)")
    dev = resolve_device(device)
    params = preset_params(mc, dev, seed, quantization)
    return Engine(mc, params, ByteTokenizer(), engine_config or EngineConfig(), device=dev)


def preset_config(preset: str, num_layers: int | None = None) -> ModelConfig:
    """A preset's model config, at *num_layers* when given."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; known: {sorted(PRESETS)}")
    mc = PRESETS[preset]()
    return mc if num_layers is None else mc.replace(num_layers=num_layers)


def preset_params(mc: ModelConfig, device: torch.device, seed: int = 0, quantization: str = "",
                  tp_group=None):
    """A preset's random weights on *device*, drawn from *seed* (int8
    quantized one stacked weight at a time under ``quantization="int8"``).
    With *tp_group* every rank draws the same values, one group at a time
    at full size, and keeps its shard of each (quantized first)."""
    if quantization not in ("", "int8"):
        raise ValueError(f"unsupported quantization {quantization!r} (supported: int8)")
    from kubeai_tpu_torch.engine.weights import quantize_group  # imports this module
    from kubeai_tpu_torch.parallel.sharding import shard_group

    tp = tp_group.world_size if tp_group is not None else 1
    check_divisible(mc, tp)

    def keep(path, t):
        if quantization:
            t = quantize_group(path, t, mc)
        return shard_group(path, t, mc, tp_group.rank, tp) if tp > 1 else t

    gen = torch.Generator(device=device).manual_seed(seed)
    return llama.init_params(mc, gen, device=device, keep=keep)
