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
  chunks of the largest bucket;
- **decode**: ``decode_chunk`` steps per dispatch, each sampling every
  slot with its temperature / top-k / top-p, presence and frequency
  penalties, logit bias, the chosen token's logprob and top-N logprobs;
  one host sync per chunk;
- **speculative decoding** (``speculate_tokens`` G > 0): each step
  feeds every slot its next token and G drafts from an n-gram lookup in
  the device token history (:func:`ngram_drafts`), verifies them in one
  forward, and emits the longest draft prefix the model's argmax agrees
  with plus the model's own next token. Only greedy slots without
  penalties or bias accept drafts, so greedy output equals G = 0's;
- one scheduler thread owns the device state; callers talk to it through
  per-request queues. Stop strings, EOS and ``max_tokens`` are handled on
  the host over the incrementally detokenized stream.

Left for later slices (ROADMAP queue 1): LoRA,
KV park/restore, gangs, QoS classes, fault injection, metrics, tracing
and the pipelined dispatch of the JAX scheduler (here each chunk is
dispatched and read back before the next).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
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
from kubeai_tpu_torch.models.base import ModelConfig, llama_3_1_8b
from kubeai_tpu_torch.ops.paged_decode_attention import resolve_decode_kernel

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


class Engine:
    """Single-model engine; one instance per replica.

    Runs on ``device`` (default ``cuda``; pass ``"cpu"`` explicitly to run
    on the CPU). On CUDA the model's kernel gates are turned on, as the
    JAX engine turns them on for the TPU: flash prefill and the paged
    attention kernels."""

    def __init__(
        self,
        model_config: ModelConfig,
        params,
        tokenizer,
        engine_config: EngineConfig | None = None,
        device: torch.device | str | None = None,
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
        if self.device.type == "cuda":
            model_config = model_config.replace(use_flash_prefill=True, use_paged_kernel=True)
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
        self._queue: "queue.Queue[Request]" = queue.Queue(maxsize=self.cfg.max_queue)
        self._running = False
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._init_state()

    # -- state -------------------------------------------------------------

    def _init_state(self) -> None:
        B = self.cfg.max_slots
        self._max_pages, P, hist_width = engine_dims(self.cfg)
        self._pool = PagePool(P, self.cfg.page_size)
        self.cache = llama.init_paged_cache(
            self.model_config, P, self.cfg.page_size, self.device
        )
        self._slots: list[_Slot | None] = [None] * B
        self._n_active = 0
        self._page_table = np.zeros((B, self._max_pages), np.int32)
        self._tok_hist = torch.zeros((B, hist_width), dtype=torch.int64, device=self.device)
        # Host-authoritative per-slot state, uploaded with every decode chunk.
        self._h_active = np.zeros((B,), bool)
        self._h_lengths = np.zeros((B,), np.int64)  # position of the next input
        self._h_last = np.zeros((B,), np.int64)  # next input token
        self._h_seed = np.zeros((B,), np.int64)
        self._h_temp = np.ones((B,), np.float32)
        self._h_top_p = np.ones((B,), np.float32)
        self._h_top_k = np.zeros((B,), np.int64)
        self._h_presence = np.zeros((B,), np.float32)
        self._h_freq = np.zeros((B,), np.float32)
        self._h_gen_start = np.zeros((B,), np.int64)
        Kb = self.cfg.max_logit_bias
        self._h_bias_ids = np.zeros((B, Kb), np.int64)
        self._h_bias_vals = np.zeros((B, Kb), np.float32)
        self._slot_pages: list[list[int]] = [[] for _ in range(B)]
        self._slot_fresh: list[list[int]] = [[] for _ in range(B)]
        self._slot_budget = [0] * B
        # Token ids whose KV a slot has written (registered as shared
        # prefix pages when the slot frees), and the token the next
        # decode step writes.
        self._kv_history: list[list[int]] = [[] for _ in range(B)]
        self._kv_pending: list[int | None] = [None] * B
        self._deferred: list[Request] = []  # fit a slot but not the pool

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

    # -- scheduler loop ----------------------------------------------------

    def _loop(self) -> None:
        log.info("engine loop started (slots=%d, device=%s)", self.cfg.max_slots, self.device)
        while self._running:
            try:
                admitted = self._admit_waiting()
                if self._n_active > 0:
                    self._decode_chunk()
                elif not admitted:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception:
                log.exception("engine step failed; resetting device state")
                self._fail_inflight("engine reset after device error")
                self._init_state()

    def _fail_inflight(self, message: str) -> None:
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                slot.req.out.put(("error", message))
        self._n_active = 0
        self._h_active[:] = False
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

    def _admit_waiting(self) -> int:
        """Admit queued requests into free slots, run their prefills and
        emit their first tokens. Returns the number admitted."""
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
                thunk()
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
        return len(taken)

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
            # generated tokens) so a follow-up turn can reuse them.
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
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        if self.n_valid_vocab < logits.shape[-1]:
            logits = logits.clone()
            logits[..., self.n_valid_vocab :] = float("-inf")
        return logits

    def _first_tokens(self, logits, reqs, seeds, positions):
        """Sample first tokens from prefill logits [N, V]: (tokens,
        logprobs, top-N ids, top-N logprobs) as numpy."""
        masked = self._mask_pad(logits)
        bias = [self._bias_rows(r.params) for r in reqs]
        biased = apply_logit_bias(
            masked, self._t(np.stack([b[0] for b in bias])), self._t(np.stack([b[1] for b in bias]))
        )
        sp = [r.params for r in reqs]
        toks = sample(
            biased, self._t(np.asarray(seeds, np.int64)), self._t(np.asarray(positions, np.int64)),
            self._t(np.array([p.temperature for p in sp], np.float32)),
            self._t(np.array([p.top_p for p in sp], np.float32)),
            self._t(np.array([p.top_k for p in sp], np.int64)),
            max_top_k=self.cfg.max_top_k,
        )
        logp = torch.log_softmax(masked, dim=-1)
        lps = logp.gather(1, toks[:, None])[:, 0]
        t_lp, t_ids = torch.topk(logp, max(1, self.cfg.top_logprobs_k), dim=-1)
        return tuple(x.cpu().numpy() for x in (toks, lps, t_ids, t_lp))

    def _prefill_group(self, items: list[tuple[int, Request]], bucket: int) -> None:
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
        out = self._first_tokens(logits[:, -1], reqs, seeds, lengths)
        for j, (slot_idx, req) in enumerate(items):
            self._register(slot_idx, req, seeds[j])
            self._emit_first(slot_idx, *(o[j] for o in out))

    def _prefill_chunked(self, slot_idx: int, req: Request, reuse: int) -> None:
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
        out = self._first_tokens(logits[:, -1], [req], [seed], [len(ids)])
        self._register(slot_idx, req, seed)
        self._emit_first(slot_idx, *(o[0] for o in out))

    def _register(self, slot_idx: int, req: Request, seed: int) -> None:
        ids = req.prompt_ids
        sp = req.params
        self._slot_fresh[slot_idx] = []  # prefill succeeded; content valid
        self._slots[slot_idx] = _Slot(
            req=req, detok=IncrementalDetokenizer(self.tokenizer),
            prompt_len=len(ids), budget=self._slot_budget[slot_idx],
        )
        self._n_active += 1
        self._kv_history[slot_idx] = list(ids)
        self._kv_pending[slot_idx] = None
        if self.cfg.speculate_tokens > 0:
            # The drafter looks bigrams up in the prompt too.
            row = np.zeros((self._tok_hist.shape[1],), np.int64)
            row[: len(ids)] = ids
            self._tok_hist[slot_idx] = self._t(row)
        self._h_active[slot_idx] = True
        self._h_lengths[slot_idx] = len(ids)
        self._h_seed[slot_idx] = seed
        self._h_temp[slot_idx] = sp.temperature
        self._h_top_p[slot_idx] = sp.top_p
        self._h_top_k[slot_idx] = sp.top_k
        self._h_presence[slot_idx] = sp.presence_penalty
        self._h_freq[slot_idx] = sp.frequency_penalty
        self._h_gen_start[slot_idx] = len(ids)
        self._h_bias_ids[slot_idx], self._h_bias_vals[slot_idx] = self._bias_rows(sp)

    def _emit_first(self, slot_idx, tok, lp, t_ids, t_lp) -> None:
        tok = int(tok)
        self._kv_pending[slot_idx] = tok
        self._h_last[slot_idx] = tok
        slot = self._slots[slot_idx]
        top = list(zip(t_ids.tolist(), t_lp.tolist())) if slot.req.params.logprobs else None
        self._emit_token(slot_idx, tok, float(lp), top)

    # -- decode ------------------------------------------------------------

    def _decode_chunk(self) -> None:
        """decode_chunk fused steps over every slot, then one host sync.
        Each step verifies G = speculate_tokens drafts per slot (none at
        G = 0); the host then emits drafts[:a] + [corr] per slot and step,
        a being the accepted drafts and corr the device's next token.
        Slots that finish mid-chunk keep stepping to the chunk's end, as in
        the JAX engine: their extra tokens are dropped, and their writes
        land past the emitted tokens, in pages that are released without
        content registration (or in the trash page)."""
        mc = self.model_config
        K = self.cfg.decode_chunk
        G = self.cfg.speculate_tokens
        topn = max(1, self.cfg.top_logprobs_k)
        active = self._t(self._h_active)
        tables = self._t(self._page_table)
        lengths = self._t(self._h_lengths)
        last = self._t(self._h_last)
        seeds = self._t(self._h_seed)
        temp = self._t(self._h_temp)
        top_p = self._t(self._h_top_p)
        top_k = self._t(self._h_top_k)
        presence = self._t(self._h_presence)
        freq = self._t(self._h_freq)
        gen_start = self._t(self._h_gen_start)
        bias_ids = self._t(self._h_bias_ids)
        bias_vals = self._t(self._h_bias_vals)
        hist = self._tok_hist
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
        drafts, toks, accs, lp_d, lp_c, t_ids, t_lps = (
            torch.stack(x).cpu().numpy() for x in zip(*outs)
        )
        self._h_lengths = lengths.cpu().numpy()
        self._h_last = last.cpu().numpy()
        snapshot = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        for k in range(K):
            for i, slot_obj in snapshot:
                if self._slots[i] is not slot_obj:
                    continue  # finished earlier in this chunk
                a = int(accs[k, i])
                if G and slot_obj.req.params.temperature <= 0.0:
                    self.spec_drafted += G
                    self.spec_accepted += a
                want_top = slot_obj.req.params.logprobs
                emitted = [(int(drafts[k, i, j]), float(lp_d[k, i, j]), j) for j in range(a)]
                emitted.append((int(toks[k, i]), float(lp_c[k, i]), a))
                for tok, lp, j in emitted:
                    if self._slots[i] is not slot_obj:
                        break  # finished on an earlier token of this step
                    if self._kv_pending[i] is not None:
                        self._kv_history[i].append(self._kv_pending[i])
                    self._kv_pending[i] = tok
                    top = list(zip(t_ids[k, i, j].tolist(), t_lps[k, i, j].tolist())) \
                        if want_top else None
                    self._emit_token(i, tok, lp, top)

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


PRESETS = {"llama-3.1-8b": llama_3_1_8b}


def build_engine(
    preset: str,
    device: torch.device | str | None = None,
    engine_config: EngineConfig | None = None,
    seed: int = 0,
    quantization: str = "",
) -> Engine:
    """An engine over a preset's full widths and depth with random bf16
    weights drawn from *seed* (``--model <dir>`` loads a checkpoint:
    engine/weights.py). ``quantization="int8"`` quantizes them, one
    stacked weight at a time. The byte tokenizer drives it; logits past
    its vocab are masked."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; known: {sorted(PRESETS)}")
    if quantization not in ("", "int8"):
        raise ValueError(f"unsupported quantization {quantization!r} (supported: int8)")
    dev = resolve_device(device)
    mc = PRESETS[preset]()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = llama.init_params(mc, gen, device=dev)
    if quantization:
        from kubeai_tpu_torch.engine.weights import quantize_model_params  # imports this module

        params = quantize_model_params(params, mc)
    return Engine(mc, params, ByteTokenizer(), engine_config or EngineConfig(), device=dev)
