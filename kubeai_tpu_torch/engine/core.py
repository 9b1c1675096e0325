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
- :meth:`Engine.warmup` runs every step shape before serving (the
  server's ``--warmup``);
- one scheduler thread owns the device state and runs every device call
  on the engine's own CUDA stream; callers talk to it through
  per-request queues. Stop strings, EOS and ``max_tokens`` are handled on
  the host over the incrementally detokenized stream.

On the CPU the same loop runs the chunk eagerly (the tests), and on CUDA
too when the caller passes ``cuda_graphs=False``.

Left for later slices (ROADMAP queue 1): LoRA, KV park/restore, gangs,
QoS classes, fault injection, metrics, tracing and CUDA graphs for
prefill.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import logging
import queue
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from kubeai_tpu_torch import resolve_device
from kubeai_tpu_torch.engine.paging import PagePool, pages_for
from kubeai_tpu_torch.engine.sampling import (
    SamplingParams,
    apply_logit_bias,
    apply_penalties,
    sample,
)
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer, IncrementalDetokenizer
from kubeai_tpu_torch.models import llama
from kubeai_tpu_torch.models.base import (
    ModelConfig,
    gemma2_2b,
    gemma_2b,
    llama_3_1_8b,
    mixtral_8x7b,
    qwen2_5_7b,
)
from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.flash_attention import flash_attention
from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
from kubeai_tpu_torch.ops.paged_decode_attention import (
    paged_decode_attention,
    resolve_decode_kernel,
)
from kubeai_tpu_torch.ops.quant import qdot, qdot_many

log = logging.getLogger("kubeai_tpu_torch.engine")


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
    reason: str  # "stop" | "length"
    prompt_tokens: int
    completion_tokens: int


@dataclass
class Request:
    prompt_ids: list[int]
    params: SamplingParams
    # events: ("token", id, text_delta, logprob, top) | ("done", FinishInfo)
    # | ("error", message). id -1 = text-only flush (held-back chars).
    out: "queue.Queue[Any]" = field(default_factory=queue.Queue)
    cancelled: threading.Event = field(default_factory=threading.Event)


@dataclass
class _Slot:
    req: Request
    detok: IncrementalDetokenizer
    prompt_len: int
    generated: int = 0
    committed_text: str = ""  # decodable text so far
    delivered_chars: int = 0  # prefix of committed_text already sent
    budget: int = 0  # max new tokens

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
    False (the same chunk eagerly: for comparisons on the card)."""

    def __init__(
        self,
        model_config: ModelConfig,
        params,
        tokenizer,
        engine_config: EngineConfig | None = None,
        device: torch.device | str | None = None,
        cuda_graphs: bool = True,
    ):
        self.cfg = engine_config or EngineConfig()
        self.device = resolve_device(device)
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
        self.cuda_graphs = bool(cuda_graphs) and self._cuda
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
        # Seconds each graph's capture took (eager run included), by kernel.
        self.graph_capture_seconds: dict[str, float] = {}
        # Recent decode chunks: host-clock segments (the JAX engine's
        # flight-recorder step records) and the device span between CUDA
        # events around the chunk.
        self.chunk_log: collections.deque = collections.deque(maxlen=4096)
        self.warmup_result: dict | None = None  # the last warmup()'s
        self._queue: "queue.Queue[Request]" = queue.Queue(maxsize=self.cfg.max_queue)
        self._running = False
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        if self._cuda:
            # The caller's stream made the weights.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            self._init_state()

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
            self.model_config, P, self.cfg.page_size, self.device
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
        self._thread = threading.Thread(target=self._loop, name="engine-loop", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                log.warning("engine loop did not exit; skipping in-flight cleanup")
                return
        self._fail_inflight("engine shutting down")
        # The graphs and their pool die with the engine's serving life (a
        # later start() captures anew), once the last chunk has run.
        if self._cuda:
            self._stream.synchronize()
        self._drop_graphs()
        self._out_sets = [None, None]

    def is_ready(self) -> bool:
        return bool(self._running and self._thread is not None and self._thread.is_alive())

    def queue_depth(self) -> int:
        return self._queue.qsize() + len(self._deferred)

    def active_slots(self) -> int:
        return self._n_active

    def submit(self, prompt_ids: list[int], params: SamplingParams) -> Request:
        """Enqueue a request; raises queue.Full when saturated, ValueError
        for a prompt that cannot fit, RuntimeError when not running."""
        max_prompt = min(
            self.cfg.max_seq_len, (self._pool.num_pages - 1) * self.cfg.page_size
        ) - 1
        if not prompt_ids:
            raise ValueError("prompt must not be empty")
        if len(prompt_ids) > max_prompt:
            raise ValueError(f"prompt too long: {len(prompt_ids)} tokens > {max_prompt}")
        if not self._running:
            raise RuntimeError("engine is not running")
        req = Request(prompt_ids=list(prompt_ids), params=params)
        self._queue.put_nowait(req)
        if not self._running:  # raced stop(): never strand the caller
            req.out.put(("error", "engine shutting down"))
        self._wake.set()
        return req

    def generate(self, prompt_ids: list[int], params: SamplingParams, timeout: float = 300):
        """Blocking wrapper: returns (token_ids, text, FinishInfo)."""
        req = self.submit(prompt_ids, params)
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

    def warmup(self, include_group: bool = True) -> dict:
        """Run every step shape the serving path hits before the first
        request (JAX ``Engine.warmup``): the decode chunk (on CUDA its
        graph's capture), batch-1 and, with *include_group*, group-cap
        cold prefill for every bucket, and one chunked-prefill shape per
        bucket. Builds and loads the kernels and fills the allocator's
        and libraries' caches. Every write goes to the KV pool's trash
        page (tables all zero) and no slot bookkeeping changes. Call it
        before start(). Returns {"shapes", "seconds"}."""
        if self.is_ready():
            raise RuntimeError("warmup() runs before start()")
        t0 = time.monotonic()
        shapes = 0
        B, Kb, mp = self.cfg.max_slots, self.cfg.max_logit_bias, self._max_pages
        with self._on_stream():
            if self.cuda_graphs:
                if self.decode_kernel not in self._graphs:
                    self._capture()
            else:
                self._inputs.make_inert()
                self._chunk_body()
            shapes += 1

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
                        self._t(np.full((n,), bucket, np.int64)),
                    )
                    first(logits, n)
                    shapes += 1
            for bucket in self.cfg.prefill_buckets:
                logits, _ = llama.prefill_paged(
                    self.params, self.model_config, self._t(np.zeros((1, bucket), np.int64)),
                    self.cache, self._t(np.zeros((1, mp), np.int32)),
                    self._t([0]), self._t([bucket - 1]),
                )
                first(logits, 1)
                shapes += 1
            if self._cuda:
                self._stream.synchronize()
        dur = time.monotonic() - t0
        log.info("engine warmup: %d shapes in %.1fs", shapes, dur)
        self.warmup_result = {"shapes": shapes, "seconds": round(dur, 3)}
        return self.warmup_result

    # -- scheduler loop ----------------------------------------------------

    def _loop(self) -> None:
        """Pipelined scheduler (JAX ``_loop``): dispatch decode chunk N+1
        before fetching chunk N's tokens, so the host's work overlaps the
        device's. Admissions merge into the next dispatch on the device;
        a chunk dispatched while a slot still held an earlier request is
        reconciled through the dispatch's slot snapshot."""
        log.info("engine loop started (slots=%d, device=%s, graphs=%s)",
                 self.cfg.max_slots, self.device, self.cuda_graphs)
        pending = None
        with self._on_stream():
            while self._running:
                try:
                    admitted = self._admit_waiting()
                    dispatched = self._dispatch_chunk() if self._n_active > 0 else None
                    # First-token sync AFTER the dispatch: the chunk reads
                    # them from the device staging vector.
                    self._emit_admitted(admitted)
                    if pending is not None:
                        self._process_chunk(*pending)
                    pending = dispatched
                    if pending is None and not admitted and self._n_active == 0:
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                except Exception:
                    # A failed capture, replay or step: fail everything in
                    # flight and rebuild the device state (no eager
                    # fallback).
                    log.exception("engine step failed; resetting device state")
                    self._fail_inflight("engine reset after device error")
                    self._init_state()
                    pending = None

    def _fail_inflight(self, message: str) -> None:
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                slot.req.out.put(("error", message))
        self._n_active = 0
        self._h_active[:] = False
        self._adm_mask[:] = False
        for req in self._deferred:
            req.out.put(("error", message))
        self._deferred.clear()
        while True:
            try:
                self._queue.get_nowait().out.put(("error", message))
            except queue.Empty:
                break

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
        while self._n_active + len(taken) < self.cfg.max_slots:
            if self._deferred:
                req = self._deferred.pop(0)
            else:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
            if req.cancelled.is_set():
                continue
            plan = self._plan_admission(req, taken)
            if plan is None:
                self._deferred.insert(0, req)  # wait for pages
                break
            slot_idx, reuse = plan
            taken.add(slot_idx)
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
                        req.out.put(("error", f"prefill failed: {e}"))
                        # Pages registered at plan time were never written:
                        # unregister them. If a same-round request already
                        # claimed one, its prefill would read garbage.
                        fresh = self._slot_fresh[slot_idx]
                        poisoned |= any(self._pool.refcount(p) > 1 for p in fresh)
                        self._pool.unregister_pages(fresh)
                        self._slot_fresh[slot_idx] = []
                        self._release_slot_pages(slot_idx)
                if poisoned:
                    # Escalate to the loop's reset; requests of this round
                    # not prefilled yet hold no slot, so fail them first.
                    for later, _ in work[w + 1 :]:
                        for slot_idx, req in later:
                            req.out.put(("error", f"prefill failed: {e}"))
                    raise
        return admitted

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
        sig = (0, 0)  # adapter signature: no LoRA in this port yet
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
        return slot_idx, len(claimed) * ps

    def _release_slot_pages(self, slot_idx: int, register: bool = False) -> None:
        row = self._slot_pages[slot_idx]
        if not row:
            return
        if register and self.cfg.prefix_cache_min:
            # Content-register every full page this slot wrote (prompt and
            # emitted tokens) so a follow-up turn can reuse them. A chunk
            # still in flight writes only past them.
            self._pool.register_chain(self._kv_history[slot_idx], (0, 0), row)
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

    def _first_tokens(self, logits, slots, reqs, seeds, positions) -> tuple:
        """Sample the first tokens of *slots* from prefill logits [N, V]
        into the device staging vector adm_toks[slots], which the next
        chunk merges in (JAX ``prefill_batch_fn``), and queue their copy
        to the host. Returns (host tensors, event) for _emit_admitted."""
        sp = [r.params for r in reqs]
        bias = [self._bias_rows(p) for p in sp]
        out = self._sample_first(
            logits, np.stack([b[0] for b in bias]), np.stack([b[1] for b in bias]),
            np.asarray(seeds, np.int64), np.asarray(positions, np.int64),
            np.array([p.temperature for p in sp], np.float32),
            np.array([p.top_p for p in sp], np.float32),
            np.array([p.top_k for p in sp], np.int64),
        )
        self._adm_toks[self._t(np.asarray(slots, np.int64))] = out[0]
        return self._to_host(out)

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
        tokens = np.zeros((n, bucket), np.int64)
        lengths = np.zeros((n,), np.int64)
        for j, (slot_idx, req) in enumerate(items):
            tokens[j, : len(req.prompt_ids)] = req.prompt_ids
            lengths[j] = len(req.prompt_ids)
        tables = self._page_table[[s for s, _ in items]]
        logits, _ = llama.prefill_paged_cold(
            self.params, self.model_config, self._t(tokens), self.cache,
            self._t(tables), self._t(lengths),
        )
        reqs = [r for _, r in items]
        seeds = [self._seed32(r.params, j) for j, r in enumerate(reqs)]
        host, ev = self._first_tokens(logits[:, -1], [s for s, _ in items], reqs, seeds, lengths)
        out = []
        for j, (slot_idx, req) in enumerate(items):
            self._register(slot_idx, req, seeds[j])
            out.append((slot_idx, self._slot_epoch[slot_idx], host, j, ev))
        return out

    def _prefill_chunked(self, slot_idx: int, req: Request, reuse: int) -> list:
        """Chunk-prefill a prompt from offset *reuse* (its first *reuse*
        tokens live in claimed shared pages): largest-bucket chunks, the
        last one padded to its bucket; only the last chunk is sampled."""
        ids = req.prompt_ids
        table = self._t(self._page_table[slot_idx : slot_idx + 1])
        max_bucket = max(self.cfg.prefill_buckets)
        logits = None
        for start in range(reuse, len(ids), max_bucket):
            chunk = ids[start : start + max_bucket]
            is_last = start + max_bucket >= len(ids)
            bucket = max_bucket if not is_last else self._bucket(len(chunk))
            padded = np.zeros((1, bucket), np.int64)
            padded[0, : len(chunk)] = chunk
            logits, _ = llama.prefill_paged(
                self.params, self.model_config, self._t(padded), self.cache, table,
                self._t([start]), self._t([len(chunk) - 1]),
            )
        seed = self._seed32(req.params)
        host, ev = self._first_tokens(logits[:, -1], [slot_idx], [req], [seed], [len(ids)])
        self._register(slot_idx, req, seed)
        return [(slot_idx, self._slot_epoch[slot_idx], host, 0, ev)]

    def _register(self, slot_idx: int, req: Request, seed: int) -> None:
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
        )
        self._n_active += 1
        self._kv_history[slot_idx] = list(ids)
        self._kv_pending[slot_idx] = None  # set once the token id is known
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

    def _chunk_body(self) -> tuple:
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
        K = self.cfg.decode_chunk
        G = self.cfg.speculate_tokens
        topn = max(1, self.cfg.top_logprobs_k)
        d = self._inputs.dev
        active, tables = d["active"], d["table"]
        temp, top_p, top_k = d["temp"], d["top_p"], d["top_k"]
        presence, freq, gen_start = d["presence"], d["freq"], d["gen_start"]
        bias_ids, bias_vals = d["bias_ids"], d["bias_vals"]
        hist = self._tok_hist
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
                decode_kernel=self.decode_kernel,
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

    def _capture(self) -> _ChunkGraph:
        """Capture the decode chunk as one CUDA graph for the resolved
        decode kernel (JAX ``_decode_jit_for`` builds one program per
        flavour). The chunk first runs once eagerly on the capture stream
        over inert inputs (no slot active: the state stays as it is and
        writes go to the trash page), so every kernel instance is built,
        loaded and configured and the stream's split-KV scratch and W8A16
        workspace are reserved; the capture then holds that scratch. The
        counts the capture added are taken back and added at each replay.
        Any failure raises: there is no eager fallback."""
        t0 = time.monotonic()
        cs = self._capture_stream
        self._inputs.make_inert()
        cs.wait_stream(self._stream)
        with torch.cuda.stream(cs):
            self._chunk_body()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool, stream=cs,
                                  capture_error_mode="thread_local"):
                outputs = self._chunk_body()
        finally:
            after = _counts()
            _set_counts(before)
        _build.hold_stream(cs)
        self._stream.wait_stream(cs)
        delta = {}
        for key, v in after.items():
            d = v - before[key]
            if d:
                delta[key] = d
        g = self._graphs[self.decode_kernel] = _ChunkGraph(graph, outputs, delta)
        self.graph_capture_seconds[self.decode_kernel] = time.monotonic() - t0
        log.info("decode chunk captured (%s) in %.2fs", self.decode_kernel,
                 self.graph_capture_seconds[self.decode_kernel])
        return g

    def _dispatch_chunk(self) -> tuple:
        """Dispatch one decode chunk and snapshot which request occupied
        each slot (JAX ``_dispatch_chunk``): upload the host inputs
        (admission arrays included, then cleared: this dispatch consumes
        them), replay the graph (or run the chunk eagerly), and queue the
        outputs' copy into a pinned set with an event behind it."""
        t_start = time.monotonic()
        graph = None
        if self.cuda_graphs:
            graph = self._graphs.get(self.decode_kernel) or self._capture()
        ev0 = None
        if self._cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        self._inputs.upload()
        self._adm_mask[:] = False
        outs = graph.replay() if graph is not None else self._chunk_body()
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
        snapshot = [(i, s, self._slot_epoch[i]) for i, s in enumerate(self._slots) if s is not None]
        return host, (ev0, ev), snapshot, t_start, time.monotonic()

    def _process_chunk(self, host, events, snapshot, t_start: float, t_disp: float) -> None:
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
        n_emitted = 0
        for k in range(K):
            for i, slot_obj, epoch in snapshot:
                owned = self._slots[i] is slot_obj
                a = int(acc[k, i])
                if G and owned and slot_obj.req.params.temperature <= 0.0:
                    self.spec_drafted += G
                    self.spec_accepted += a
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
        now = time.monotonic()
        self.chunk_log.append({
            "steps": K, "slots": len(snapshot), "tokens": n_emitted,
            "graph": self.cuda_graphs,
            "dispatch_ms": (t_disp - t_start) * 1e3,  # upload + replay (or eager launches)
            "fetch_wait_ms": (t_fetched - t_fetch) * 1e3,  # host blocked on the chunk
            "emit_ms": (now - t_fetched) * 1e3,
            "dur_ms": (t_fetched - t_disp) * 1e3,  # dispatched -> fetched
            "fetched_at": t_fetched,
            "device_ms": ev0.elapsed_time(ev) if ev is not None else None,
        })

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
                req.out.put(("token", token_id, tail, logprob, top))
                self._free(slot_idx, "stop", flush=False)
                return
        emit_upto = max(len(text) - slot.holdback, slot.delivered_chars)
        delta = text[slot.delivered_chars : emit_upto]
        slot.delivered_chars = emit_upto
        req.out.put(("token", token_id, delta, logprob, top))
        if slot.generated >= slot.budget:
            self._free(slot_idx, "length")

    def _free(self, slot_idx: int, reason: str, deliver: bool = True, flush: bool = True):
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        self._n_active -= 1
        self._h_active[slot_idx] = False
        self._release_slot_pages(slot_idx, register=True)
        if not deliver:
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
        slot.req.out.put(("done", FinishInfo(reason, slot.prompt_len, slot.generated)))


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
    mc = model_config or ModelConfig(
        vocab_size=272,  # 259 used; padded as in the JAX package
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        dtype="float32",
        max_position=2048,
    )
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
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; known: {sorted(PRESETS)}")
    if quantization not in ("", "int8"):
        raise ValueError(f"unsupported quantization {quantization!r} (supported: int8)")
    dev = resolve_device(device)
    mc = PRESETS[preset]()
    if num_layers is not None:
        mc = mc.replace(num_layers=num_layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = llama.init_params(mc, gen, device=dev)
    if quantization:
        from kubeai_tpu_torch.engine.weights import quantize_model_params  # imports this module

        params = quantize_model_params(params, mc)
    return Engine(mc, params, ByteTokenizer(), engine_config or EngineConfig(), device=dev)
