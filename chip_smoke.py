#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubeai_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (any failure exits non-zero; nothing is caught into a pass):
  1. environment: the card's name and power limit, torch/CUDA versions,
     the kernels' build time (the paged kernels' head-dim-32 one-byte
     instances in libraries of their own, built beside the others),
     nvcc's per-kernel resource report and the HGMMA / HMMA (tensor-core)
     instruction count of each library (the three attention kernels'
     bf16 instances at head dim 256, Gemma's, also in libraries of their
     own); the dedicated decode kernel (its head-dim-256 library too) and
     the W8A16 kernels must use HMMA and spill nothing, and the W8A16
     library must show HGMMA (its wgmma tile);
  2. kernels: each hand-written CUDA kernel at the main path's shapes
     against its plain PyTorch version (float32 math on the same bf16
     inputs), timed beside the plain version, one PyTorch library call
     that computes the same function (a yardstick the port never calls)
     and the least time the card could take (bound); decode cases (S = 1,
     4 and 8 queries per slot; W8A16 at M = 8 and 64) are timed with a
     cold L2 beside a cold read of as many bytes, with a split-count
     sweep of the split-KV decode kernels; the decode grid must cover
     every SM. The paged kernels again over fp8 and int8 pools (one byte
     per element) in every regime: split-KV decode at 4, 32 and 64 rows,
     the TMA prefill tile, the CUDA-core tile, float32, and at head dim
     32; the plain version dequantizes to float32. Speculative verify
     steps: the ragged kernel at S = 5, 8, 12, 16 (20 to 64 rows on its
     split-KV tile; at 64 rows its prefill tile timed beside it) at kv
     512 and 2048 over bf16, fp8 and int8 pools and at head dim 32, the
     dedicated kernel at S = 8, 9, 16, 17 and at 128 rows (row groups). The W8A16 kernels at
     8, 16, 32, 64, 256, 1024, 2048 and 8192 rows through each projection
     (both regimes; 256-8192 are the embeddings' groups), the heads, the
     grouped qkv and gate/up launches at 8, 64, 1024, 2048 and 8192 rows
     (equal byte for byte to separate ones) and the float32 instance; two launches must agree
     byte for byte. The families' instances and regimes: flash at
     Gemma-2B's head dim 256 (8 heads over 1) and at Qwen2.5-7B's G = 7
     (28 heads over 4, 63-row tiles), both on the tensor-core tile; the
     paged kernels at h 256 (decode at kv 512 and 2048 over bf16 and fp8
     pools, an 8-token verify, a 1024 chunk at 1024) and at G = 7
     (decode, verify at 56 rows on split KV and 70 on the prefill tile,
     the chunk); W8A16 at Qwen's and Gemma's projections and heads
     (Gemma's tied 256000 x 2048 head as qmatT); the decode grid must
     cover every SM with 8, 4 and 1 KV heads;
  3. model parity: a 2-layer Llama-3.1-8B-width model, kernel path vs
     plain path on the same weights (bf16: gather attention; int8: also
     the W8A16 product in float32 math; an fp8 pool: the same gates with
     each attention kernel's plain version), for cold prefill (flash and
     ragged buckets), a chunked prefill, decode steps and 8- and
     17-token speculative verify steps under both decode kernels; the
     same for 2-layer full-width Qwen2.5-7B (bf16, int8), Gemma-2B (bf16,
     fp8 pool), Mixtral-8x7B (bf16; the plain path takes the kernel
     path's expert choices, and the choices it would have made otherwise
     are counted) and Gemma2-2B (bf16 and int8 on the gather path: no
     attention kernel may launch); the 2-layer Llama model with a LoRA
     bank (adapters a and b, rank 16 on all seven targets) and rows
     [1, 0, 2] in one batch, the same bank on the plain path;
  4. serving: the port's OpenAI server over Llama-3.1-8B (32 layers,
     random bf16 weights from a seed) answers completions, chat, a
     flash-sized prompt, a chunked prompt, a shared prefix, 8 concurrent
     requests (one streamed) and a seeded sample sent twice — with the
     ragged decode kernel, with the dedicated one, and over the same
     weights quantized to int8 (ragged), over an fp8 KV pool (ragged),
     and over an int8 KV pool with int8 weights (dedicated; the pool's
     scales from one bf16 prefill's K/V absmax), and with
     --speculate-tokens 7 on each decode kernel (drafted and accepted
     drafts; greedy tokens equal to the same engine's at G = 0 up to a
     near-tie within 2 bf16 ulps of the logits), each run with the launch
     counters zeroed before it. Then LoRA (LORA_RUNS: ragged, dedicated,
     int8 weights, --speculate-tokens 7): two PEFT adapters written by the
     port's writer load through /v1/load_lora_adapter, /v1/models lists
     them, and 8 requests (3 on a, 3 on b, 2 base; staggered arrivals,
     decoding together) are served: base tokens equal those of the same
     engine before it had a bank, adapter tokens differ, and an eager
     engine gives the graphed engine's tokens; in the ragged run an
     adapter is unloaded while its requests decode and another loaded into
     its row, and the follow-up turn claims none of the row's old pages.
     A LoRA run's counts are the graphed engine's alone: they are read
     before the eager engine starts. Every kernel of a run's path must launch
     there, a whole number of times per model step, the paged kernels on
     the run's pool dtype alone; a quantized pool has half the bf16
     pool's bytes. Every decode chunk of every serving run is one CUDA
     graph replay (the engine's chunk log), and the fp8-pool run starts
     with --warmup (its shapes, seconds and capture seconds printed).
     After the bf16 runs, eager and graphed engines in turns (eager,
     graphed, graphed, eager) on the same weights, bf16 ragged at G = 0
     and G = 7: 3 rounds of 8 concurrent greedy requests of 128 tokens
     each (wall per step of a chunk, aggregate and per-stream tok/s,
     TTFT, the chunk's host segments), the greedy tokens equal across
     turns up to near-ties. After the last timed serving run (a
     profiler session slows a process's later launches), one eager and
     one graphed engine per G serve a round with a torch.profiler window
     over 6 chunks (device busy ms of a chunk, idle share). Then a
     32-layer step profile: decode and verify steps
     under both decode kernels, in int8 and over an fp8 pool, prefills
     with bf16 and int8 weights, and a decode step without a bank and with
     one (all rows 0, one adapter, two mixed). Then the other families, each served
     with the same request set (FAMILY_RUNS: Qwen2.5-7B at 28 layers,
     bf16 ragged and int8 weights with the dedicated kernel; Gemma-2B at
     18, bf16 ragged and an fp8 pool with the dedicated kernel; Gemma2-2B
     at 26, bf16, with zero flash and paged launches; Mixtral-8x7B at 16
     of its 32 layers, full width, bf16 ragged), no CUDA-core tile in any
     of them, and a step profile of each (decode, 8-token verify, cold
     512 prefill). Then the loader: a 2-layer checkpoint at 8B width
     written by the port's save_hf_checkpoint, with a Llama-3-style
     tokenizer.json and chat template built here, is served through
     --model <dir> --quantization int8; its int8 leaves must equal
     quantize_model_params of the written weights, and a chat completion's
     text must equal the checkpoint tokenizer's decode of the greedy ids
     (and the host's encode time of a 4,096-token prompt is printed). Last, the JAX
     package's float32 test config serves through the server's command
     line with --quantization int8 --kv-cache-dtype fp8 and then with
     --speculate-tokens 3, its greedy tokens equal to the same engine's on
     the CPU;
  5. handoff (phase_handoff): the resume protocol between a prefill-role
     and a decode-role server on Llama-3.1-8B (bf16 ragged, fp8
     dedicated), and a preemption resumed by unpark;
  6. serving ops (phase_serving_ops): the engine's operational surface on
     Llama-3.1-8B (32 layers, 8 slots), bf16 then int8 weights:
     /v1/embeddings of 8 inputs of 16-1,000 tokens (unit norm, equal to
     the direct path idle and under 6 decode streams; ms per group,
     tokens/s, the allocator's peak, in int8 the W8A16 launches the embed
     added and its vectors against the plain int8 products), a 512-token
     request past X-Request-Deadline: 0.2 answering 504 beside 3 streams
     that stay token-identical, a failpoint armed over /debug/faults,
     n = 4 (seed + i equal to the singles on a float32 test:tiny server),
     /debug/pipeline's MFU and roofline fraction under load, a 2 s
     /debug/profile naming the decode kernel (the decode step timed
     before and after it), and the drain (/readyz 200 -> 503, the stream
     in flight completes, new work gets 429);
  7. cold start (phase_coldstart, budget 120 s): a spawned server over a
     4-layer checkpoint at Llama-3.1-8B width into an empty library
     directory (KUBEAI_COMPILE_CACHE, the build overlapped with the
     weight stream, --warmup): spawn -> /readyz 200 and each phase; then
     a parked server warmed for preset:llama-3.1-8b and attached with
     the same args (the park engine adopted, weights in place): park
     warm and attach -> ready seconds, capture seconds by part, 8 greedy
     requests equal to a directly built engine's (path "parked");
  8. fine-tune (phase_finetune, budget 90 s): the LoRA fine-tune CLI
     (train/finetune.py's main) over a 4-layer checkpoint at
     Llama-3.1-8B width (64 seeded JSONL rows, --seq-len 256, rank 16 on
     q and v, batch 4, 30 steps): the loss must drop; median step,
     tokens/s and peak memory beside the step's operations bound,
     checkpoint and adapter seconds; 20 steps resumed to 30 must equal
     the uninterrupted adapter; the same loop at 32 layers over
     preset:llama-3.1-8b (10 steps); the adapter served through
     EngineServer.load_adapter changes greedy text (path "finetune");
     a trainer step and a LoRA step on the card equal the CPU's.
  9. the gang (phase_gang, budget 90 s): tensor parallelism at tp = 2 on
     the one card. (d) a one-rank NCCL group's all-reduce and all-gather
     captured in a CUDA graph and replayed equal the eager ones; (b) a
     float32 config at Llama-3.1-8B width, 2 layers, served by a tp = 2
     gang in this process (two threads over gloo, rank 0 publishing to
     rank 1 over the gang's TCP wire): greedy tokens identical to tp = 1;
     (a) + (c) ``python -m kubeai_tpu_torch.engine.server --model
     preset:llama-3.1-8b --tensor-parallel-size 2`` (two processes on the
     card over gloo, eager chunks) with the gang.follower failpoint armed
     once: rank 1 reconnects and the next request re-forms the gang
     (kubeai_gang_reforms_total 1); then 8 greedy requests over HTTP,
     each rank holding about half the parameter bytes, first tokens and
     top-5 logprobs against a tp = 1 engine within the tolerance of one
     extra bf16 rounding per row-parallel layer, flash and ragged
     launched on both ranks (path "gang"); the decode step's wall,
     device and collective milliseconds. Phase 2 also runs each kernel
     at a tp = 2 rank's shapes (H 16, Kv 4; W8A16 N and K halved).
 10. sharded training (phase_sharded_train, budget 120 s; started FIRST,
     in a child process, while the card is empty: its eight ranks peak
     near 70-79 GB, and the earlier phases leave ~20 GB allocated in this
     process; it runs beside phase 1's nvcc build, which needs no card,
     and phase 2 starts after it ends):
     ``python3 -m kubeai_tpu_torch.tools.sharded_check``. (a)
     ring attention at Llama-3.1-8B's attention widths (H 32, Kv 8, h 128,
     float32, S 8,192) at sp = 2 and 4, thread ranks over host-staged
     gloo, output and q / k / v gradients against dense attention on the
     card within 2·S·u; (b) the full-parameter step at Llama-3.1-8B's
     published widths, 2 layers, float32, B 2 x S 2,048, over a dp = sp =
     tp = 2 mesh of eight thread ranks against one rank's step: loss,
     every leaf's gradient, the updated final_norm; (c) the same step for
     Mixtral-8x7B at its published widths, 1 layer, float32, capacity
     factor 0.5, B 2 x S 1,024, over a dp = ep = tp = 2 mesh (experts
     split over ep, routing over the global tokens): top-k ids and keep
     masks equal to one rank's, the loss within 1e-6, gradients within
     1e-5 of each leaf's max |g|, pairs dropped (must be > 0). One
     ``sharded_train`` line per part. It adds no kernel and launches none
     of the four.
The last two lines are the kernels summary (each kernel's launches in
the run of its own path, and per path; every entry must have launched
there) and {"ok": true, ...}.
"""

from __future__ import annotations

import contextlib
import faulthandler
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# Kernel outputs are bf16: one rounding of the output (<= 2^-8 of its
# magnitude) plus float32 summation in another order (<= 1e-3 absolute
# for these O(1) outputs) separates a correct kernel from the float32
# plain version on the same inputs.
REL_TOL = 2.0**-8
ABS_TOL = 1e-3

# Seconds after which a run that has not finished dumps its threads'
# stacks and exits (the whole run must end within 1200 s).
DEADLINE_S = 1140

KERNELS = ("flash_attention", "paged_attention", "paged_decode_attention", "w8a16_matmul")
# Libraries built beside them: the paged kernels' one-byte instances at
# head dim 32 (the float32 test configuration's pools), and the three
# attention kernels' bf16 instances at head dim 256 (Gemma's).
VARIANTS = ("paged_attention_q8d32", "paged_decode_attention_q8d32", "flash_attention_d256",
            "paged_attention_d256", "paged_decode_attention_d256")


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# Cold-L2 timing reads this many bytes between launches: well past the
# H100's 50 MB L2, so a decode case finds its KV pages in device memory,
# as a real decode step does after ~436 MB of layer weights went through.
# A read, not a write, evicts: like the weights it leaves clean lines, so
# the timed kernel pays no write-back of the eviction buffer.
L2_FLUSH_BYTES = 128 << 20
_flush_buf = None


# Cycles of the spin kernel that holds the card while a timed loop is
# enqueued (~25 ms): the events then measure device time, not the gaps of
# a host that enqueues slower than the card runs short kernels.
HOLD_CYCLES = 40_000_000


def timed_ms(fn, iters: int = 20, warmup: int = 3, cold_l2: bool = False) -> float:
    """Mean device ms per call of *fn* (CUDA events around calls enqueued
    behind a spin kernel). With *cold_l2* every call is timed alone,
    right after a 128 MB read that evicts the L2; the read sits outside
    the timed events."""
    global _flush_buf
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not cold_l2:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters
    if _flush_buf is None:
        _flush_buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(HOLD_CYCLES)
    for i in range(iters):
        _flush_buf.sum()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def compare_f32(got, want, what: str) -> float:
    """Max abs error of a float32 kernel output against the float32 plain
    version: summation order alone, within 1e-4 absolute plus 1e-4 of
    |want| (the card tests' float32 tolerance)."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (g - w).abs()
    if (err - (1e-4 * w.abs() + 1e-4)).max().item() > 0:
        raise AssertionError(f"{what}: max abs err {err.max().item():.3e} exceeds tolerance")
    return err.max().item()


def compare(got, want, what: str) -> float:
    """Max abs error of a bf16 kernel output against the float32 plain
    version; raises past REL_TOL * |want| + ABS_TOL."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (g - w).abs()
    excess = (err - (REL_TOL * w.abs() + ABS_TOL)).max().item()
    if excess > 0:
        raise AssertionError(f"{what}: max abs err {err.max().item():.3e} exceeds tolerance")
    return err.max().item()


# ---------------------------------------------------------------------------
# Phase 1


def phase_env() -> dict:
    import torch

    from kubeai_tpu_torch.ops import _build

    log("gpu:", gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log("device:", torch.cuda.get_device_name(0), "count:", torch.cuda.device_count())
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True)
    log("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton  # noqa: F401  (recorded only; the port does not use it)

        log("triton:", triton.__version__)
    except ImportError:
        log("triton: not installed")
    t0 = time.monotonic()
    res = _build.build(list(KERNELS + VARIANTS), ptxas_verbose=True)
    build_s = time.monotonic() - t0
    log(f"build: {len(res)} kernels in {build_s:.1f}s (parallel nvcc)")
    spills = {}
    for name, r in res.items():
        for line in r.log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "smem")):
                log(f"  ptxas[{name}] {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[name] = spills.get(name, 0) + int(m.group(1)) + int(m.group(2))
    # Whether the tensor cores are used: Hopper's warpgroup products show
    # as HGMMA in the SASS, mma.sync as HMMA. Logged; the dedicated
    # kernel's bf16 instances must use them and no instance may spill.
    tool = _cuobjdump()
    hmma, hgmma = {}, {}
    for name, r in res.items():
        if tool is None:
            log(f"  sass[{name}] not inspected: no cuobjdump")
            continue
        sass = subprocess.run([tool, "-sass", str(r.path)], capture_output=True, text=True)
        lines = sass.stdout.splitlines()
        hgmma[name] = sum("HGMMA" in line for line in lines)
        hmma[name] = sum("HMMA" in line and "HGMMA" not in line for line in lines)
        log(f"  sass[{name}] HGMMA instructions: {hgmma[name]}, HMMA: {hmma[name]}")
    log("spill_bytes", json.dumps(spills))
    # The W8A16 library: mma.sync (decode) and wgmma (verify, prefill).
    for name in ("paged_decode_attention", "paged_decode_attention_d256", "w8a16_matmul"):
        if spills.get(name, 0):
            raise AssertionError(f"{name} spills: {spills}")
        if tool is not None and not hmma.get(name):
            raise AssertionError(f"no HMMA in {name}'s SASS")
    if tool is not None and not hgmma.get("w8a16_matmul"):
        raise AssertionError("no HGMMA in w8a16_matmul's SASS")
    return {"build_s": build_s}


def _cuobjdump() -> str | None:
    from pathlib import Path

    from kubeai_tpu_torch.ops import _build

    cands = [Path(_build.nvcc_path()).parent / "cuobjdump"]
    try:
        import triton

        cands.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    return next((str(c) for c in cands if c.exists()), None)


# ---------------------------------------------------------------------------
# Phase 2


def _paged_case(B, S, kv_lens, H=32, Kv=8, h=128, page=64, seed=0):
    """Random bf16 q and pool with a shuffled page table, main-path widths."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    max_pages = -(-max(max(kv_lens), 1) // page)
    P = 1 + B * max_pages
    pool = torch.randn((P, page, 2 * Kv, h), generator=g, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(P - 1, generator=g, device="cuda")[: B * max_pages] + 1
    table = perm.reshape(B, max_pages).to(torch.int32).contiguous()
    q = torch.randn((B, S, H, h), generator=g, device="cuda").to(torch.bfloat16)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    return q, pool, table, lens


def _paged_cost(B, S, kv_lens, H, Kv, h, page=64, q_bytes=2, kv_bytes=2):
    """(bytes, flops) the paged function needs for these inputs: q and
    out once (q_bytes per element), each valid K/V row once (kv_bytes per
    element: 1 for a quantized pool), the lengths and the table entries
    of the pages that hold those rows; 4*h flops per (query head,
    visible key)."""
    visible = sum(max(0, L - S + s + 1) for L in kv_lens for s in range(S))
    kv_rows = sum(kv_lens)
    pages = sum(-(-L // page) for L in kv_lens)
    nbytes = (q_bytes * (2 * B * S * H * h) + kv_bytes * (kv_rows * 2 * Kv * h)
              + 4 * (B + pages))
    return nbytes, 4.0 * h * H * visible


def _bound(nbytes, flops, kind="bf16"):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _sdpa_paged(q, pool, table, lens, k_scale=None, v_scale=None):
    """Library yardstick for paged attention: gather the pages (a
    quantized pool's then dequantized to q's dtype), then one
    scaled_dot_product_attention call with the position mask."""
    import torch
    import torch.nn.functional as F

    B, S, H, h = q.shape
    page, Kv = pool.shape[1], pool.shape[2] // 2
    skv = table.shape[1] * page
    gathered = pool[table.long()]
    k = gathered[..., 0::2, :].reshape(B, skv, Kv, h).transpose(1, 2)
    v = gathered[..., 1::2, :].reshape(B, skv, Kv, h).transpose(1, 2)
    if k_scale is not None:
        k = (k.float() * k_scale).to(q.dtype)
        v = (v.float() * v_scale).to(q.dtype)
    pos_q = lens.long()[:, None] - S + torch.arange(S, device=q.device)[None, :]
    mask = torch.arange(skv, device=q.device)[None, None, :] <= pos_q[:, :, None]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:, None], enable_gqa=True
    )


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import (
        MAX_DECODE_QUERY_LEN,
        paged_decode_attention,
    )

    H, Kv, h = 32, 8, 128
    results: dict[str, dict] = {}

    def record(name, case, err, ms, plain_ms, nbytes, flops, lib_ms, headline, cold,
               read_ms=None, kind="bf16", extra=None):
        bound_ms, bound_by = _bound(nbytes, flops, kind)
        line = {
            "kernel": name, "case": case, "l2": "cold" if cold else "warm",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
        }
        if read_ms is not None:
            line["read_ms"] = read_ms
        line.update(extra or {})
        log("kernel_case", json.dumps(line))
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if headline:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib_ms, case=case)

    # #1 flash attention: cold prefill buckets 1024 and 512 (the serving
    # run's 300-byte prompt takes the 512 bucket).
    for S, headline in ((1024, True), (512, False)):
        g = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn((1, S, H, h), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, S, Kv, h), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, S, Kv, h), generator=g, device="cuda").to(torch.bfloat16)
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
        torch.cuda.synchronize()
        err = compare(got, want, f"flash_attention S={S}")
        ms = timed_ms(lambda: flash_attention(q, k, v, causal=True))
        plain_ms = timed_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters=5)
        lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True))
        nbytes = 2 * (2 * S * H * h + 2 * S * Kv * h)
        flops = 4.0 * h * H * S * (S + 1) / 2
        record("flash_attention", f"B=1 S={S} causal", err, ms, plain_ms, nbytes, flops,
               lib_ms, headline, False)

    # #2 and #3 on decode shapes (S <= 8: decode, speculative verify); #2
    # also on prefill shapes. A real decode step finds its layer's KV
    # cold, so decode cases are timed cold-L2.
    cases = [
        ("decode B=8 kv_len=1", 8, 1, [1] * 8, False),
        ("decode B=8 kv_len=300", 8, 1, [300] * 8, False),
        ("decode B=8 kv_len=512", 8, 1, [512] * 8, True),
        ("decode B=8 kv_len=2048", 8, 1, [2048] * 8, False),
        ("decode B=8 S=4 kv_len=512", 8, 4, [512] * 8, False),
        ("decode B=8 S=8 kv_len=512", 8, 8, [512] * 8, False),
        ("decode B=8 S=8 kv_len=2048", 8, 8, [2048] * 8, False),
        ("prefill B=1 S=128", 1, 128, [128], False),
        ("prefill chunk B=1 S=1024 start=1024", 1, 1024, [2048], False),
    ]
    for case, B, S, lens_list, headline in cases:
        cold = case.startswith("decode")
        q, pool, table, lens = _paged_case(B, S, lens_list)
        want = paged_attention_plain(q.float(), pool.float(), table, lens)
        nbytes, flops = _paged_cost(B, S, lens_list, H, Kv, h, page=pool.shape[1])
        lib_ms = timed_ms(lambda: _sdpa_paged(q, pool, table, lens), iters=5, cold_l2=cold)
        plain_ms = timed_ms(lambda: paged_attention_plain(q, pool, table, lens), iters=5,
                            cold_l2=cold)
        # What the memory delivers at this size: one cold sum() over as
        # many bytes as the case needs (a memory-bound kernel's yardstick
        # beside its bound).
        read_ms = None
        if cold:
            buf = torch.zeros(nbytes // 4, device="cuda")
            read_ms = timed_ms(lambda: buf.sum(), cold_l2=True)
            del buf
        kernels = [("paged_attention", paged_attention_ragged)]
        if S <= MAX_DECODE_QUERY_LEN:
            kernels.append(("paged_decode_attention", paged_decode_attention))
        for name, fn in kernels:
            got = fn(q, pool, table, lens)
            torch.cuda.synchronize()
            err = compare(got, want, f"{name} {case}")
            ms = timed_ms(lambda: fn(q, pool, table, lens), cold_l2=cold)
            record(name, case, err, ms, plain_ms, nbytes, flops, lib_ms, headline, cold,
                   read_ms)
        if case in SWEEP_CASES:
            _split_sweep(case, q, pool, table, lens)
        del q, pool, table, lens, want
    torch.cuda.empty_cache()
    for kv in ("fp8", "int8"):
        _quant_pool_cases(record, kv)
        _quant_pool_cases(record, kv, QUANT_CASES_H32, H32_SHAPE, " h32")
    _verify_cases(record)
    _w8a16_cases(record)
    _family_cases(record)
    _tp2_cases(record)
    for name, r in results.items():
        log("kernel", json.dumps({"kernel": name, **r}))
    return results


# Quantized pools: int8 with the JAX package's test scales (K 0.05, V
# 0.02; pool values round(N(0, 1) / scale)), fp8 scale-free (N(0, 1) in
# e4m3).
KV_QUANT = {"int8": ("int8", 0.05, 0.02), "fp8": ("float8_e4m3fn", 1.0, 1.0)}
QUANT_CASES = (
    # (case, B, S, kv_lens, H, q dtype, headline): B=8 decode at kv 512
    # and 2048 (4 rows per KV head: one m16 tile), S=8 (32 rows: the
    # ragged kernel's CUDA-core tile, the dedicated kernel's two tiles),
    # S=8 at G=8 (64 rows: four tiles; the ragged kernel's TMA tile), the
    # prefill regime, and float32 (both CUDA-core kernels).
    ("decode B=8 kv_len=512", 8, 1, [512] * 8, 32, "bf16", True),
    ("decode B=8 kv_len=2048", 8, 1, [2048] * 8, 32, "bf16", False),
    ("decode B=8 S=8 kv_len=512", 8, 8, [512] * 8, 32, "bf16", False),
    ("decode B=8 S=8 G=8 kv_len=512", 8, 8, [512] * 8, 64, "bf16", False),
    ("prefill B=1 S=128", 1, 128, [128], 32, "bf16", False),
    ("prefill chunk B=1 S=1024 start=1024", 1, 1024, [2048], 32, "bf16", False),
    ("float32 decode B=8 S=4 kv_len=512", 8, 4, [512] * 8, 32, "f32", False),
)
# Head dim 32 (the JAX package's float32 test configuration, served with
# an fp8 pool in phase 4; its one-byte instances are a library of their
# own): (Kv, h, page), and cases as above: split-KV decode, 16 rows per
# KV head (verify), the TMA prefill tile, and float32 decode (test:tiny's
# own path: the headline).
H32_SHAPE = (2, 32, 16)
QUANT_CASES_H32 = (
    ("h=32 decode B=4 kv_len=256", 4, 1, [256] * 4, 4, "bf16", False),
    ("h=32 verify B=4 S=8 kv_len=256", 4, 8, [256] * 4, 4, "bf16", False),
    ("h=32 prefill B=1 S=128", 1, 128, [128], 4, "bf16", False),
    ("h=32 float32 decode B=4 kv_len=256", 4, 1, [256] * 4, 4, "f32", True),
)


def _quant_case(B, S, kv_lens, kv, H=32, Kv=8, h=128, page=64, qdtype=None, seed=11):
    """q (bf16 unless *qdtype*), a one-byte pool of kind *kv* (KV_QUANT)
    with a shuffled page table, lengths, and the pool's (k, v) scales."""
    import torch

    dt_name, ks, vs = KV_QUANT[kv]
    dt = getattr(torch, dt_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    max_pages = -(-max(kv_lens) // page)
    P = 1 + B * max_pages
    x = torch.randn((P, page, 2 * Kv, h), generator=g, device="cuda")
    if dt == torch.int8:
        sc = torch.tensor([ks, vs] * Kv, device="cuda")[:, None]
        pool = torch.clamp(torch.round(x / sc), -127, 127).to(dt)
    else:
        pool = x.to(dt)
    del x
    perm = torch.randperm(P - 1, generator=g, device="cuda")[: B * max_pages] + 1
    table = perm.reshape(B, max_pages).to(torch.int32).contiguous()
    q = torch.randn((B, S, H, h), generator=g, device="cuda").to(qdtype or torch.bfloat16)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    return q, pool, table, lens, ks, vs


def _quant_pool_cases(record, kv, cases=QUANT_CASES, shape=(8, 128, 64), tag="") -> None:
    """Both paged kernels over a one-byte pool in every regime, against
    the plain version on float32 q with the pool dequantized to float32
    (x * scale), timed beside the plain version in q's dtype, gather +
    dequantize to bf16 + SDPA, and a cold read of the bytes (half the
    bf16 pool's K/V bytes). *shape* is (Kv, h, page); *tag* marks the
    kernel entries of another head dim."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import (
        MAX_DECODE_QUERY_LEN,
        paged_decode_attention,
    )

    Kv, h, page = shape
    for case, B, S, lens_list, H, qdt, headline in cases:
        cold = "decode" in case
        q, pool, table, lens, ks, vs = _quant_case(
            B, S, lens_list, kv, H=H, Kv=Kv, h=h, page=page,
            qdtype=torch.bfloat16 if qdt == "bf16" else torch.float32)
        want = paged_attention_plain(q.float(), pool, table, lens, None, 0.0, ks, vs)
        nbytes, flops = _paged_cost(B, S, lens_list, H, Kv, h, page, q.element_size(), 1)
        lib_ms = timed_ms(lambda: _sdpa_paged(q, pool, table, lens, ks, vs), iters=5,
                          cold_l2=cold)
        plain_ms = timed_ms(lambda: paged_attention_plain(q, pool, table, lens, None, 0.0,
                                                          ks, vs), iters=5, cold_l2=cold)
        read_ms = None
        if cold:
            buf = torch.zeros(nbytes // 4, device="cuda")
            read_ms = timed_ms(lambda: buf.sum(), cold_l2=True)
            del buf
        kernels = [("paged_attention", paged_attention_ragged)]
        if S <= MAX_DECODE_QUERY_LEN:
            kernels.append(("paged_decode_attention", paged_decode_attention))
        for name, fn in kernels:
            got = fn(q, pool, table, lens, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            err = (compare if qdt == "bf16" else compare_f32)(got, want, f"{name} {kv} pool {case}")
            ms = timed_ms(lambda: fn(q, pool, table, lens, k_scale=ks, v_scale=vs),
                          cold_l2=cold)
            record(f"{name}[{kv} pool{tag}]", f"{kv} pool {case}", err, ms, plain_ms, nbytes,
                   flops, lib_ms, headline, cold, read_ms, "f32" if qdt == "f32" else "bf16")
        del q, pool, table, lens, want
    torch.cuda.empty_cache()


# Speculative verify steps (S = G+1 queries per slot) at Llama-3.1-8B's
# widths, B=8: the ragged kernel at 20 to 64 rows per KV head (S = 5, 8,
# 12, 16 at G = 4: its split-KV body below 64 rows, its prefill tile at
# 64; kv 512 and 2048; bf16, fp8 and int8 pools), S = 8 at head dim 32 (32 rows: the q8d32 libraries for one-byte
# pools), and the dedicated kernel past auto's 8 queries and past 64 rows
# (row groups). The headline of each entry is S = 8 at kv 512, the
# --speculate-tokens 7 serving runs' shape.
VERIFY_S = (5, 8, 12, 16)
VERIFY_DEDICATED = ((9, 32), (16, 32), (17, 32), (16, 64))  # (S, H) at kv 512


def _verify_cases(record) -> None:
    """The verify cases, each against the plain version (float32 q, the
    pool in float32 or dequantized to it), timed cold-L2 beside the plain
    version, gather (+ dequantize) + SDPA and a cold read of the bytes.
    Each records the ragged kernel's tile (ragged_regime) or the dedicated
    kernel's row groups; at 64 rows the ragged kernel's split-KV body is
    timed beside the prefill tile that it runs there (split_kv_ms)."""
    import torch

    from kubeai_tpu_torch.ops import paged_attention as pa
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention, row_groups

    def run(name, fn, case, B, S, H, Kv, h, page, lens, kv, headline, launch=None):
        if kv is None:
            q, pool, table, lens_t = _paged_case(B, S, lens, H=H, Kv=Kv, h=h, page=page, seed=S)
            ks = vs = None
            want = pa.paged_attention_plain(q.float(), pool.float(), table, lens_t)
        else:
            q, pool, table, lens_t, ks, vs = _quant_case(B, S, lens, kv, H=H, Kv=Kv, h=h,
                                                          page=page, seed=S)
            want = pa.paged_attention_plain(q.float(), pool, table, lens_t, None, 0.0, ks, vs)
        kw = {} if kv is None else {"k_scale": ks, "v_scale": vs}
        got = fn(q, pool, table, lens_t, **kw)
        torch.cuda.synchronize()
        err = compare(got, want, f"{name} {case}")
        nbytes, flops = _paged_cost(B, S, lens, H, Kv, h, page, 2, 1 if kv else 2)
        ms = timed_ms(lambda: fn(q, pool, table, lens_t, **kw), cold_l2=True)
        plain_ms = timed_ms(lambda: pa.paged_attention_plain(q, pool, table, lens_t, None, 0.0,
                                                             ks, vs), iters=5, cold_l2=True)
        lib_ms = timed_ms(lambda: _sdpa_paged(q, pool, table, lens_t, ks, vs), iters=5,
                          cold_l2=True)
        buf = torch.zeros(nbytes // 4, device="cuda")
        read_ms = timed_ms(lambda: buf.sum(), cold_l2=True)
        del buf
        R = S * (H // Kv)
        if fn is paged_decode_attention:
            extra = {"rows": R, "row_groups": row_groups(R)[0]}
        else:
            extra = {"rows": R, "tile": pa.ragged_regime(q, pool)}
            if R == 64:  # the split-KV body (four row tiles) beside the prefill tile
                scale = h**-0.5
                sk = pa._launch_ragged(q, pool, table, lens_t, scale, 0.0, split_kv=True, **kw)
                torch.cuda.synchronize()
                compare(sk, want, f"{name} {case} split-KV body")
                extra["split_kv_ms"] = timed_ms(lambda: pa._launch_ragged(
                    q, pool, table, lens_t, scale, 0.0, split_kv=True, **kw), cold_l2=True)
        record(name, case, err, ms, plain_ms, nbytes, flops, lib_ms, headline, True, read_ms,
               extra=extra)
        del q, pool, table, lens_t, want, got

    for kv in (None, "fp8", "int8"):
        tag = "" if kv is None else f" {kv} pool"
        name = f"paged_attention[verify{tag}]"
        for S in VERIFY_S:
            for L in (512, 2048):
                run(name, pa.paged_attention_ragged, f"verify{tag} B=8 S={S} kv_len={L}",
                    8, S, 32, 8, 128, 64, [L] * 8, kv, S == 8 and L == 512)
        run(name, pa.paged_attention_ragged, f"verify{tag} h=32 B=8 S=8 kv_len=512",
            8, 8, 32, 8, 32, 64, [512] * 8, kv, False)
    for S, H in ((8, 32),) + VERIFY_DEDICATED:
        run("paged_decode_attention[verify]", paged_decode_attention,
            f"verify B=8 S={S} H={H} kv_len=512", 8, S, H, 8, 128, 64, [512] * 8, None,
            (S, H) == (8, 32))
    torch.cuda.empty_cache()


# The model families' attention shapes (H, Kv, h): Gemma-2B's head dim
# 256 over one KV head, Qwen2.5-7B's groups of G = 7.
GEMMA_ATTN = (8, 1, 256)
QWEN_ATTN = (28, 4, 128)
# (entry, case, B, S, kv_lens, pool, kernels, headline): the ragged
# kernel ("r") and/or the dedicated one ("d") on Gemma's and Qwen's
# shapes; an entry's headline is the case its family's serving path runs
# most. Decode and verify cases are timed cold-L2.
FAMILY_PAGED = (
    ("h256", "decode B=8 kv_len=512", 8, 1, [512] * 8, None, "rd", True),
    ("h256", "decode B=8 kv_len=2048", 8, 1, [2048] * 8, None, "rd", False),
    ("h256", "verify B=8 S=8 kv_len=512", 8, 8, [512] * 8, None, "rd", False),
    ("h256", "prefill chunk B=1 S=1024 start=1024", 1, 1024, [2048], None, "r", False),
    ("h256 fp8 pool", "fp8 pool decode B=8 kv_len=512", 8, 1, [512] * 8, "fp8", "rd", True),
    ("h256 fp8 pool", "fp8 pool decode B=8 kv_len=2048", 8, 1, [2048] * 8, "fp8", "rd", False),
    ("h256 fp8 pool", "fp8 pool prefill chunk B=1 S=1024 start=1024", 1, 1024, [2048], "fp8",
     "r", False),
    ("G7", "decode B=8 kv_len=512", 8, 1, [512] * 8, None, "rd", True),
    ("G7", "verify B=8 S=8 kv_len=512 (56 rows)", 8, 8, [512] * 8, None, "rd", False),
    ("G7 prefill tile", "prefill chunk B=1 S=1024 start=1024", 1, 1024, [2048], None, "r", True),
    ("G7 prefill tile", "verify B=8 S=10 kv_len=512 (70 rows)", 8, 10, [512] * 8, None, "r",
     False),
)
# W8A16 at the families' shapes: (name, K, N, M, layout): Qwen2.5-7B's
# grouped q|k|v (3584 -> 3584 + 512 + 512), gate|up (18944 each), wo,
# wd and untied head; Gemma-2B's q, gate and down and its tied head
# (qmatT over the [256000, 2048] table). The headline is Qwen's gate at
# M = 8, its int8 serving run's decode.
FAMILY_W8A16 = (
    ("qwen wqkv", 3584, 4608, 8, 0), ("qwen wg", 3584, 18944, 8, 0),
    ("qwen wo", 3584, 3584, 8, 0), ("qwen wd", 18944, 3584, 8, 0),
    ("qwen wg", 3584, 18944, 1024, 0), ("qwen lm_head", 3584, 152064, 8, 0),
    ("gemma wq", 2048, 2048, 8, 0), ("gemma wg", 2048, 16384, 8, 0),
    ("gemma wd", 16384, 2048, 8, 0), ("gemma tied head", 2048, 256000, 8, 1),
)


def _family_cases(record) -> None:
    """The kernel instances and regimes the model families add, each
    against its plain version (float32 q; a pool in float32 or
    dequantized to it), timed beside the plain version, one library call
    (SDPA, or gather + SDPA) and its bound: flash at Gemma-2B's head dim
    256 and at Qwen2.5-7B's G = 7 (S = 1024), the paged kernels at both
    (FAMILY_PAGED), and W8A16 at their projection and head shapes."""
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops import paged_attention as pa
    from kubeai_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        flash_regime,
    )
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention
    from kubeai_tpu_torch.ops.quant import dequantize, qdot, qdot_plain, qmatT, qmatT_plain

    for tag, (H, Kv, h) in (("h256", GEMMA_ATTN), ("G7", QWEN_ATTN)):
        S = 1024
        g = torch.Generator(device="cuda").manual_seed(31)
        q, k, v = (torch.randn((1, S, n, h), generator=g, device="cuda").to(torch.bfloat16)
                   for n in (H, Kv, Kv))
        if flash_regime(q, k) != "tensor_core":
            raise AssertionError(f"flash_attention[{tag}] not on the tensor-core tile")
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = compare(got, flash_attention_plain(q.float(), k.float(), v.float()),
                      f"flash_attention[{tag}]")
        ms = timed_ms(lambda: flash_attention(q, k, v, causal=True))
        plain_ms = timed_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters=5)
        lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True))
        record(f"flash_attention[{tag}]", f"B=1 S={S} H={H} Kv={Kv} h={h} causal", err, ms,
               plain_ms, 2 * (2 * S * H * h + 2 * S * Kv * h), 4.0 * h * H * S * (S + 1) / 2,
               lib_ms, True, False)
        del q, k, v, got

    for tag, case, B, S, lens, kv, which, headline in FAMILY_PAGED:
        H, Kv, h = GEMMA_ATTN if tag.startswith("h256") else QWEN_ATTN
        cold = S <= 10
        if kv is None:
            q, pool, table, lens_t = _paged_case(B, S, lens, H=H, Kv=Kv, h=h, seed=S + h)
            ks = vs = None
            want = pa.paged_attention_plain(q.float(), pool.float(), table, lens_t)
        else:
            q, pool, table, lens_t, ks, vs = _quant_case(B, S, lens, kv, H=H, Kv=Kv, h=h,
                                                          seed=S + h)
            want = pa.paged_attention_plain(q.float(), pool, table, lens_t, None, 0.0, ks, vs)
        kw = {} if kv is None else {"k_scale": ks, "v_scale": vs}
        nbytes, flops = _paged_cost(B, S, lens, H, Kv, h, 64, 2, 1 if kv else 2)
        plain_ms = timed_ms(lambda: pa.paged_attention_plain(q, pool, table, lens_t, None, 0.0,
                                                             ks, vs), iters=5, cold_l2=cold)
        lib_ms = timed_ms(lambda: _sdpa_paged(q, pool, table, lens_t, ks, vs), iters=5,
                          cold_l2=cold)
        regime = pa.ragged_regime(q, pool)
        if regime == "cuda_core":
            raise AssertionError(f"paged_attention[{tag}] {case}: on the CUDA-core tile")
        fns = [("paged_attention", pa.paged_attention_ragged)] * ("r" in which)
        fns += [("paged_decode_attention", paged_decode_attention)] * ("d" in which)
        for name, fn in fns:
            got = fn(q, pool, table, lens_t, **kw)
            torch.cuda.synchronize()
            err = compare(got, want, f"{name}[{tag}] {case}")
            ms = timed_ms(lambda: fn(q, pool, table, lens_t, **kw), cold_l2=cold)
            extra = {"rows": S * (H // Kv), "H": H, "Kv": Kv, "h": h}
            if name == "paged_attention":
                extra["tile"] = regime
            record(f"{name}[{tag}]", case, err, ms, plain_ms, nbytes, flops, lib_ms, headline,
                   cold, extra=extra)
            del got
        del q, pool, table, lens_t, want
    torch.cuda.empty_cache()

    for name, K, N, M, layout in FAMILY_W8A16:
        g = torch.Generator(device="cuda").manual_seed(K + N + M)
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        w = _w8a16_weight(g, K, N, layout)
        fn, plain = (qdot, qdot_plain) if layout == 0 else (qmatT, qmatT_plain)
        got = fn(x, w)
        torch.cuda.synchronize()
        err = compare(got, _w8a16_want(x, w, layout), f"w8a16 {name} M={M}")
        cold = M <= 64
        ms = timed_ms(lambda: fn(x, w), cold_l2=cold)
        plain_ms = timed_ms(lambda: plain(x, w["int8_q"], w["int8_s"]), iters=5, cold_l2=cold)
        wb = dequantize(w, torch.bfloat16)
        wb = wb if layout == 0 else wb.T
        lib_ms = timed_ms(lambda: torch.matmul(x, wb), cold_l2=cold)
        nbytes = K * N + 4 * N + 2 * (M * K + M * N)
        record("w8a16_matmul[families]", f"{name} M={M} K={K} N={N}" + (" (qmatT)" if layout
                                                                          else ""),
               err, ms, plain_ms, nbytes, 2.0 * M * N * K, lib_ms, (name, M) == ("qwen wg", 8),
               cold)
        del x, w, wb, got
    torch.cuda.empty_cache()


# Llama-3.1-8B's projections (K, N): wq and wo, wk and wv, wg and wu, wd.
W8A16_SHAPES = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wg", 4096, 14336), ("wd", 14336, 4096))
VOCAB = 128256
# Rows: a decode step (8 slots), the regime crossover (16 | 32), an
# 8-slot verify step of 8 tokens (64), a prefill chunk (1024), and the
# embeddings' groups (8 x bucket: 256 at bucket 32, 2048 at 256, 8192 at
# 1024, where the grouped qkv launch takes the 256-column tile).
W8A16_ROWS = (8, 16, 32, 64, 256, 1024, 2048, 8192)
W8A16_GROUP_ROWS = (8, 64, 1024, 2048, 8192)
# The launches that share x (qdot_many), by the model's weight names.
W8A16_GROUPS = (("qkv", (("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024))),
                ("gate_up", (("wg", 4096, 14336), ("wu", 4096, 14336))))


def _w8a16_weight(g, K, N, layout):
    import torch

    from kubeai_tpu_torch.ops.quant import quantize, quantize_rows

    if layout == 0:
        return quantize(torch.randn((K, N), generator=g, device="cuda") * K**-0.5)
    return quantize_rows(torch.randn((N, K), generator=g, device="cuda") * K**-0.5)


def _w8a16_want(x, w, layout):
    q, s = w["int8_q"], w["int8_s"]
    return (x.float() @ (q.float() if layout == 0 else q.float().T)) * s.reshape(1, -1)


def _w8a16_cases(record) -> None:
    """The W8A16 kernels at the main path's shapes: each projection at
    W8A16_ROWS (decode regime up to 16 rows, the wgmma tile above), decode
    through the untied lm_head and, as qmatT, through a tied head over a
    [128256, 4096] table; the grouped launches of the model (qkv,
    gate/up) at W8A16_GROUP_ROWS, each output equal byte for byte to
    its own launch; the float32 instance at 8 and 1024 rows. Checked
    against float32 math on the same int8 weights and inputs, and two
    launches against each other (determinism); M <= 64 timed with a cold
    L2 (a real step reads its weights from device memory). library_ms is
    torch.matmul of x with the dequantized weight (bf16, or float32 for
    the float32 instance), made outside the timed region: the same
    function up to one rounding, reading twice (four times) the weight
    bytes."""
    import torch

    from kubeai_tpu_torch.ops.quant import dequantize, qdot, qdot_many, qdot_plain, qmatT, qmatT_plain

    def cold_read(nbytes):
        buf = torch.zeros(nbytes // 4, device="cuda")
        ms = timed_ms(lambda: buf.sum(), cold_l2=True)
        del buf
        return ms

    cases = [(name, K, N, M, 0, torch.bfloat16) for name, K, N in W8A16_SHAPES
             for M in W8A16_ROWS]
    cases += [("lm_head", 4096, VOCAB, 8, 0, torch.bfloat16),
              ("tied head", 4096, VOCAB, 8, 1, torch.bfloat16)]
    cases += [("float32 wq", 4096, 4096, M, layout, torch.float32) for M in (8, 1024)
              for layout in (0, 1)]
    for name, K, N, M, layout, dt in cases:
        f32 = dt == torch.float32
        g = torch.Generator(device="cuda").manual_seed(K + N + M)
        x = torch.randn((M, K), generator=g, device="cuda").to(dt)
        w = _w8a16_weight(g, K, N, layout)
        fn, plain = (qdot, qdot_plain) if layout == 0 else (qmatT, qmatT_plain)
        q, s = w["int8_q"], w["int8_s"]
        got = fn(x, w)
        again = fn(x, w)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"w8a16 {name} M={M}: two launches differ")
        err = (compare_f32 if f32 else compare)(got, _w8a16_want(x, w, layout),
                                                f"w8a16 {name} M={M}")
        del got, again
        cold = M <= 64
        ms = timed_ms(lambda: fn(x, w), cold_l2=cold)
        plain_ms = timed_ms(lambda: plain(x, q, s), iters=5, cold_l2=cold)
        wb = dequantize(w, dt)
        wb = wb if layout == 0 else wb.T  # x @ table.T: cuBLAS takes the transpose as is
        lib_ms = timed_ms(lambda: torch.matmul(x, wb), cold_l2=cold)
        esize = x.element_size()
        nbytes = K * N + 4 * N + esize * (M * K + M * N)
        read_ms = cold_read(nbytes) if cold else None
        case = f"{name} M={M} K={K} N={N}" + (" q[N,K] (qmatT)" if layout else "")
        record("w8a16_matmul[float32]" if f32 else "w8a16_matmul", case, err, ms, plain_ms,
               nbytes, 2.0 * M * N * K, lib_ms,
               (name, M) in (("wg", 8), ("float32 wq", 8)) and layout == 0, cold, read_ms,
               "f32" if f32 else "bf16")
        del x, w, q, s, wb
    for gname, shapes in W8A16_GROUPS:
        for M in W8A16_GROUP_ROWS:
            g = torch.Generator(device="cuda").manual_seed(M + len(shapes))
            K = shapes[0][1]
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            ws = [_w8a16_weight(g, K, N, 0) for _, K, N in shapes]
            got = qdot_many(x, ws)
            sep = [qdot(x, w) for w in ws]
            torch.cuda.synchronize()
            err = 0.0
            for (wname, _, _), y, y1, w in zip(shapes, got, sep, ws):
                if not torch.equal(y, y1):
                    raise AssertionError(f"w8a16 {gname} M={M}: {wname} differs from its own launch")
                err = max(err, compare(y, _w8a16_want(x, w, 0), f"w8a16 {gname} {wname} M={M}"))
            del got, sep
            cold = M <= 64
            ms = timed_ms(lambda: qdot_many(x, ws), cold_l2=cold)
            sep_ms = timed_ms(lambda: [qdot(x, w) for w in ws], cold_l2=cold)
            plain_ms = timed_ms(lambda: [qdot_plain(x, w["int8_q"], w["int8_s"]) for w in ws],
                                iters=5, cold_l2=cold)
            wbs = [dequantize(w, torch.bfloat16) for w in ws]
            lib_ms = timed_ms(lambda: [torch.matmul(x, wb) for wb in wbs], cold_l2=cold)
            nbytes = sum(K * N + 4 * N + 2 * M * N for _, _, N in shapes) + 2 * M * K
            flops = sum(2.0 * M * N * K for _, _, N in shapes)
            read_ms = cold_read(nbytes) if cold else None
            case = f"{gname} M={M} K={K} N=" + "+".join(str(N) for _, _, N in shapes)
            record("w8a16_matmul[grouped]", case, err, ms, plain_ms, nbytes, flops, lib_ms,
                   gname == "qkv" and M == 8, cold, read_ms, extra={"separate_ms": sep_ms})
            del x, ws, wbs
    torch.cuda.empty_cache()


# W8A16 launches per layer of a model step: qkv and gate/up grouped
# (qdot_many), wo and wd.
W8A16_PER_LAYER = 4

SWEEP_CASES = ("decode B=8 kv_len=512", "decode B=8 kv_len=2048", "decode B=8 S=8 kv_len=512")


def _split_sweep(case, q, pool, table, lens) -> None:
    """Cold-L2 ms of the split-KV decode kernels (ragged where its rows
    take that regime, and dedicated) under other split counts than the
    wrappers' own choice (marked), on the same inputs."""
    import torch

    from kubeai_tpu_torch.ops import paged_attention as pa
    from kubeai_tpu_torch.ops import paged_decode_attention as pd

    B, S, H = q.shape[:3]
    Kv, page = pool.shape[2] // 2, pool.shape[1]
    chosen = pa.split_kv_plan(B, Kv, table.shape[1], page,
                              torch.cuda.get_device_properties(0).multi_processor_count)
    scale = q.shape[-1] ** -0.5
    launchers = {"paged_decode_attention": pd._launch_dedicated}
    if S * (H // Kv) <= pa.SPLIT_MAX_ROWS:
        launchers["paged_attention"] = pa._launch_ragged
    for name, launch in launchers.items():
        ms = {}
        for n in sorted({2, 4, 8, 16, chosen}):
            n = min(n, pa.MAX_SPLITS)
            ms[n] = timed_ms(lambda: launch(q, pool, table, lens, scale, 0.0, n), cold_l2=True)
        log("split_sweep", json.dumps({"kernel": name, "case": case, "chosen": chosen,
                                       "ms_by_splits": ms}))


def check_decode_grid() -> dict:
    """The split-KV decode grid of both paged kernels at B=8, kv_len 512,
    for Llama's 8 KV heads, Qwen2.5's 4 and Gemma-2B's one, over phase
    2's table (8 pages) and the serving engine's (32 pages): the live
    blocks must cover every SM of the card."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import split_chunk, split_kv_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = {}
    for Kv in (8, 4, 1):
        for mp in (8, 32):
            n = split_kv_plan(8, Kv, mp, 64, sms)
            blocks[f"Kv={Kv} pages={mp}"] = 8 * Kv * -(-512 // split_chunk(512, n))
    log("decode_grid", json.dumps({"sms": sms, "live_blocks_by_table_pages": blocks}))
    if min(blocks.values()) < sms:
        raise AssertionError(f"decode grid at kv_len 512 leaves SMs idle: {blocks} < {sms}")
    return blocks


# ---------------------------------------------------------------------------
# Phase 3


def phase_model_parity() -> None:
    import torch

    from kubeai_tpu_torch.engine.weights import quantize_model_params
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(mc, gen, device="cuda")
    _parity(params, mc, "bf16", contextlib.nullcontext)
    _parity(quantize_model_params(params, mc), mc, "int8", _float32_w8a16)
    # An fp8 pool: the gather path would attend the dequantized pool where
    # flash attends the fresh bf16 k/v (as in the JAX package), so the
    # plain path keeps the kernel path's gates and swaps each attention
    # kernel for its plain version.
    _parity(params, mc.replace(kv_cache_dtype="fp8"), "fp8 pool", _plain_attention,
            plain_gates=True)
    # LoRA: adapters a and b (rank 16 on all seven targets) and the base
    # model in one batch, the same bank on both paths.
    from kubeai_tpu_torch.engine.lora import AdapterRuntime

    rt = AdapterRuntime(mc, device="cuda")
    for name, path in zip("ab", _adapter_dirs()):
        rt.load(name, path)
    _parity(params, mc, "bf16 lora rows [1, 0, 2]", _plain_attention, plain_gates=True,
            lora=(rt.bank, torch.tensor([1, 0, 2], device="cuda")))
    del params, rt
    torch.cuda.empty_cache()
    _family_parity()


def _family_parity() -> None:
    """The same check for 2-layer full-width models of the other
    families: Qwen2.5-7B (G = 7, biases; bf16 and int8), Gemma-2B (head
    dim 256, one KV head; bf16 and an fp8 pool) and Mixtral-8x7B (MoE;
    bf16), and Gemma2-2B, whose window keeps every call on the gather
    path (bf16, and int8 for the W8A16 kernel at its shapes): its
    attention kernels must not launch at all."""
    import torch

    from kubeai_tpu_torch.engine.core import PRESETS
    from kubeai_tpu_torch.engine.weights import quantize_model_params
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.ops.flash_attention import flash_attention
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention

    attention = (flash_attention, paged_attention_ragged, paged_decode_attention)
    for preset, runs in (("qwen2.5-7b", ("bf16", "int8")), ("gemma-2b", ("bf16", "fp8 pool")),
                         ("mixtral-8x7b", ("bf16",)), ("gemma2-2b", ("bf16", "int8"))):
        mc = PRESETS[preset](num_layers=2)
        params = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0),
                                   device="cuda")
        before = [fn.launches for fn in attention]
        for run in runs:
            label = f"{preset} {run}"
            if run == "int8":
                _parity(quantize_model_params(params, mc), mc, label, _float32_w8a16)
            elif run == "fp8 pool":
                _parity(params, mc.replace(kv_cache_dtype="fp8"), label, _plain_attention,
                        plain_gates=True)
            elif mc.num_experts:
                routes = _SharedRoutes(label)
                _parity(params, mc, label, routes.replay, kernel_ctx=routes.record)
                routes.report()
            else:
                _parity(params, mc, label, contextlib.nullcontext)
        launched = [fn.launches - b for fn, b in zip(attention, before)]
        log(f"parity {preset}: attention kernel launches (flash, ragged, dedicated) {launched}")
        if (mc.sliding_window > 0) != (sum(launched) == 0):
            raise AssertionError(f"parity {preset}: attention kernel launches {launched}")
        del params
        torch.cuda.empty_cache()


class _SharedRoutes:
    """MoE routing is a discrete function of the router logits: a near-tie
    between two experts flips with the last bit of a hidden state, and a
    flipped token's FFN output is another expert's. So the MoE parity
    check gives the plain path the kernel path's expert choices (each
    layer's top-k, recorded in the kernel call and replayed, in order, in
    the plain call; the weights are the plain path's own softmax over
    them) and counts the choices the plain path would have made
    otherwise."""

    def __init__(self, label):
        self.label, self.routes, self.choices, self.flips = label, [], 0, 0

    @contextlib.contextmanager
    def _patched(self, route):
        from kubeai_tpu_torch.models import llama

        saved = llama.moe_route
        llama.moe_route = route
        try:
            yield
        finally:
            llama.moe_route = saved

    def record(self):
        from kubeai_tpu_torch.models import llama

        self.routes.clear()
        own = llama.moe_route

        def route(xt, wr, k):
            out = own(xt, wr, k)
            self.routes.append(out[1])
            return out

        return self._patched(route)

    def replay(self):
        from kubeai_tpu_torch.models import llama

        own, it = llama.moe_route, iter(list(self.routes))

        def route(xt, wr, k):
            router, mine = own(xt, wr, k)
            theirs = next(it)
            self.choices += mine.numel()
            self.flips += int((mine.sort(dim=-1)[0] != theirs.sort(dim=-1)[0]).sum().item())
            return router, theirs

        return self._patched(route)

    def report(self):
        log(f"parity {self.label}: plain-path expert choices that differ from the kernel "
            f"path's (replaced by them): {self.flips} of {self.choices}")


@contextlib.contextmanager
def _plain_attention():
    """The model's three attention kernels as their plain versions (same
    arguments; a quantized pool dequantized to q's dtype, as the JAX CPU
    twin does). No kernel launches in it."""
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.ops.flash_attention import flash_attention_plain
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_plain

    saved = llama.flash_attention, llama.paged_attention_ragged, llama.paged_decode_attention
    llama.flash_attention = flash_attention_plain
    llama.paged_attention_ragged = llama.paged_decode_attention = paged_attention_plain
    try:
        yield
    finally:
        llama.flash_attention, llama.paged_attention_ragged, llama.paged_decode_attention = saved


@contextlib.contextmanager
def _float32_w8a16(halves: bool = False):
    """The model's int8 products as float32 math on the same int8 weights,
    rounded once to bf16 (the kernel's function, summed in another order):
    the plain path of the int8 parity check. With *halves* the untransposed
    products sum K's two halves apart and then add them (the same
    function, summed in a third order). No kernel launches in it."""
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.ops import quant

    def dot(x, w):
        if not quant.is_quantized(w):
            return x @ w
        q = w["int8_q"]
        if halves:
            k = q.shape[0] // 2
            acc = x[..., :k].float() @ q[:k].float() + x[..., k:].float() @ q[k:].float()
        else:
            acc = x.float() @ q.float()
        return (acc * w["int8_s"].squeeze(-2)).to(x.dtype)

    def dot_t(x, w):
        if not quant.is_quantized(w):
            return x @ w.to(x.dtype).T
        return ((x.float() @ w["int8_q"].float().T) * w["int8_s"].squeeze(-1)).to(x.dtype)

    def dot_many(x, ws):
        return [dot(x, w) for w in ws]

    saved = llama.qdot, llama.qdot_many, llama.qmatT
    llama.qdot, llama.qdot_many, llama.qmatT = dot, dot_many, dot_t
    try:
        yield
    finally:
        llama.qdot, llama.qdot_many, llama.qmatT = saved


def _parity(params, mc, label, plain_ctx, plain_gates=False,
            kernel_ctx=contextlib.nullcontext, lora=None) -> None:
    """Kernel path (flash, paged kernels and, for int8 weights, the W8A16
    kernel) against the plain path (gather attention, or with
    *plain_gates* the kernel path's gates; *plain_ctx* around each plain
    call, *kernel_ctx* around each kernel call) on the same weights and
    tokens; with *lora* (bank, rows) every call takes the bank with one
    adapter row per batch row (3 rows then, 2 otherwise)."""
    import torch

    from kubeai_tpu_torch.models import llama

    kern = mc.replace(use_flash_prefill=True, use_paged_kernel=True)
    plain_cfg = kern if plain_gates else mc
    lk = {} if lora is None else {"lora": lora[0], "lora_rows": lora[1]}
    page, B, mp = 64, 2 if lora is None else len(lora[1]), 32
    P = 1 + B * mp
    table = torch.arange(1, P, dtype=torch.int32, device="cuda").reshape(B, mp)
    tok_g = torch.Generator(device="cuda").manual_seed(7)

    def toks(S):
        return torch.randint(0, 259, (B, S), generator=tok_g, device="cuda")

    def check(what, a, b):
        # Logits leave the bf16 lm_head product, so they differ in whole
        # bf16 steps (ulps, 2^-7 relative) of their magnitude. The paths
        # differ only in summation order and the bf16 rounding of
        # attention's output: allow 2 ulps of the largest logit at most
        # and half an ulp on average.
        ulp = 2.0 ** (torch.floor(torch.log2(b.abs().max())).item() - 7)
        d = (a - b).abs()
        log(f"parity {label} {what}: max|dlogit| {d.max().item():.4f} "
            f"mean {d.mean().item():.5f} (bf16 ulp at max|logit|: {ulp})")
        if not torch.isfinite(a).all() or d.max().item() > 2 * ulp or d.mean().item() > 0.5 * ulp:
            raise AssertionError(f"model parity {label} {what} outside tolerance")

    pools = {name: llama.init_paged_cache(cfg, P, page, "cuda")
             for name, cfg in (("kernel", kern), ("plain", plain_cfg))}

    def both(what, call):
        """call(config, pool) on both paths; each keeps its own pool."""
        with kernel_ctx():
            kernel = call(kern, pools["kernel"])
        with plain_ctx():
            plain = call(plain_cfg, pools["plain"])
        check(what, kernel, plain)

    for S, lens in ((512, [300, 512, 400]), (128, [77, 128, 100])):
        t = toks(S)
        L = torch.tensor(lens[:B], device="cuda")
        both(f"cold prefill S={S}", lambda cfg, pool: llama.prefill_paged_cold(
            params, cfg, t, pool, table, L, **lk)[0])
    t = toks(256)
    start = torch.tensor([128] * B, device="cuda")
    last = torch.tensor([255, 100, 200][:B], device="cuda")
    both("chunked prefill start=128 S=256", lambda cfg, pool: llama.prefill_paged(
        params, cfg, t, pool, table, start, last, **lk)[0])
    d = toks(1)
    lengths = torch.tensor([384, 229, 300][:B], device="cuda")
    for dk in ("ragged", "dedicated"):
        both(f"decode step ({dk})", lambda cfg, pool: llama.decode_step_paged(
            params, cfg, d, {"kv": pool["kv"].clone()}, table, lengths, decode_kernel=dk,
            **lk)[0])
    # Speculative verify: 8 candidate tokens per slot (S = G+1 = 8: the
    # ragged kernel's split-KV tile at 32 rows), and 17 (68 rows: its
    # prefill tile, and the dedicated kernel's two row groups).
    for S in (8, 17):
        spec = toks(S)
        for dk in ("ragged", "dedicated"):
            both(f"verify step S={S} ({dk})", lambda cfg, pool: llama.decode_speculative_paged(
                params, cfg, spec, {"kv": pool["kv"].clone()}, table, lengths,
                decode_kernel=dk, **lk)[0])
    del pools
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4


def _post(port, path, body, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _stream(port, body, timeout=600, headers=None):
    """(text, finish_reason, event times in s since the request) of an
    SSE completion. With logprobs on, every token sends an event."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        # EOS (token 257 of the byte tokenizer) is banned so the timed
        # stream runs its full length.
        data=json.dumps({**body, "stream": True, "logprobs": 0,
                         "logit_bias": {"257": -100}}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    t0 = time.monotonic()
    times, text, reason = [], [], None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            ev = json.loads(data)
            if "error" in ev:
                raise AssertionError(f"stream error: {ev['error']}")
            ch = ev["choices"][0]
            if ch.get("logprobs"):
                times.append(time.monotonic() - t0)
            text.append(ch.get("text") or "")
            reason = ch.get("finish_reason") or reason
    return "".join(text), reason, times


def _check_completion(resp, what, chat=False):
    ch = resp["choices"][0]
    text = ch["message"]["content"] if chat else ch["text"]
    u = resp["usage"]
    ok = (
        isinstance(text, str)
        and ch["finish_reason"] in ("stop", "length")
        and u["completion_tokens"] >= 1
        and u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    )
    if not ok:
        raise AssertionError(f"malformed response for {what}: {resp}")
    return text


def _serve_once(params, decode_kernel: str, int8: bool = False, kv_cache_dtype: str = "",
                model_config=None, run: str | None = None, cli: list | None = None,
                engine=None) -> dict:
    """One serving run of the port's OpenAI server over the 32-layer model
    (the launch counters zeroed before it); *model_config* carries an
    int8 pool's scales. With *cli* the engine comes from the server's own
    command line (random preset weights from its --seed) instead of
    *params*; *engine* serves a model the caller built (another family).
    A model with a sliding window (Gemma2) must launch no attention
    kernel: it gathers its pages, as in the JAX package."""
    import torch

    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.ops.flash_attention import flash_attention
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention

    run = run or ("int8" if int8 else decode_kernel)
    if engine is not None:
        eng = engine
    elif cli:
        from kubeai_tpu_torch.engine.server import build_engine_from_args, make_arg_parser

        eng, _ = build_engine_from_args(make_arg_parser().parse_args(cli))
    else:
        ec = EngineConfig(max_slots=8, max_seq_len=2048, page_size=64,
                          decode_kernel=decode_kernel, kv_cache_dtype=kv_cache_dtype)
        eng = Engine(model_config or llama_3_1_8b(), params, ByteTokenizer(), ec, device="cuda")
    pool = eng.cache["kv"]
    pool_dtype = str(pool.dtype).removeprefix("torch.")
    log(f"serving[{run}] pool {tuple(pool.shape)} {pool_dtype}: {pool.nbytes} bytes")
    srv = EngineServer(eng, run, host="127.0.0.1", port=0)
    srv.start()
    p = srv.port
    attention = (flash_attention, paged_attention_ragged, paged_decode_attention)
    _zero_launches()
    try:
        t = _post(p, "/v1/completions", {"prompt": "Hello", "max_tokens": 8, "temperature": 0})
        _check_completion(t, "short")
        c = _post(p, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say hi."}], "max_tokens": 8,
            "temperature": 0, "logprobs": True, "top_logprobs": 2})
        _check_completion(c, "chat", chat=True)
        if len(c["choices"][0]["logprobs"]["content"][0]["top_logprobs"]) != 2:
            raise AssertionError("chat top_logprobs malformed")
        mid = ("The quick brown fox jumps over the lazy dog. " * 7)[:300]
        _check_completion(_post(p, "/v1/completions", {
            "prompt": mid, "max_tokens": 8, "temperature": 0, "logprobs": 1}), "300-byte")
        long = ("Lorem ipsum dolor sit amet, consectetur adipiscing elit. " * 27)[:1500]
        _check_completion(_post(p, "/v1/completions", {
            "prompt": long, "max_tokens": 8, "temperature": 0}), "1500-byte chunked")
        prefix = ("You are a helpful assistant. Answer briefly and precisely. " * 5)[:256]
        for tail in ("What is two plus two?", "Name a prime number."):
            _check_completion(_post(p, "/v1/completions", {
                "prompt": prefix + tail, "max_tokens": 8, "temperature": 0}), "shared prefix")
        # 8 concurrent requests, one streamed.
        results: list = [None] * 8
        errors: list = []

        def worker(i):
            try:
                body = {"prompt": f"Request number {i}: tell a story about the sea.",
                        "max_tokens": 32, "temperature": 0}
                results[i] = _stream(p, body) if i == 0 else _post(p, "/v1/completions", body)
            except Exception as e:  # reported below
                errors.append(f"{i}: {e!r}")

        t0 = time.monotonic()
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.monotonic() - t0
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"concurrent requests failed: {errors}")
        text0, reason0, times = results[0]
        if reason0 not in ("stop", "length") or not times:
            raise AssertionError("streamed request malformed")
        for r in results[1:]:
            _check_completion(r, "concurrent")
        tokens = sum(r["usage"]["completion_tokens"] for r in results[1:])
        seeded = {"prompt": "Once upon a time", "max_tokens": 16, "temperature": 0.8,
                  "top_p": 0.95, "seed": 1234}
        a = _check_completion(_post(p, "/v1/completions", seeded), "seeded")
        b = _check_completion(_post(p, "/v1/completions", seeded), "seeded again")
        if a != b:
            raise AssertionError(f"seeded sample not reproducible: {a!r} vs {b!r}")
        counts = _read_launches()
        launches, by_pool = counts["launches"], counts["launches_by_pool"]
        by_regime = counts["launches_by_regime"]
        flash_by_regime = counts["flash_launches_by_regime"]
        chunks = _check_graphed(eng, run)
        spec = _spec_parity(eng, run) if eng.cfg.speculate_tokens else None
    finally:
        srv.stop()
    # The paged kernels read the run's pool alone (one-byte pages in a
    # quantized run).
    for name, counts in by_pool.items():
        if set(counts) - {pool_dtype}:
            raise AssertionError(f"{run} run: {name} launched on other pools: {counts}")
    windowed = eng.model_config.sliding_window > 0
    want = [] if windowed else ["flash_attention", "paged_attention_ragged"]
    if decode_kernel == "dedicated" and not windowed:
        want.append("paged_decode_attention")
    if int8:
        want.append("qdot")
    missing = [n for n in want if launches[n] == 0]
    if missing:
        raise AssertionError(f"{run} run: kernels never launched: {missing}")
    if windowed and any(launches[fn.__name__] for fn in attention):
        raise AssertionError(f"{run} run: a sliding-window model launched attention "
                             f"kernels: {launches}")
    # Every bf16 shape of these models takes a tensor-core tile (G <= 64).
    if flash_by_regime.get("cuda_core") or by_regime.get("cuda_core"):
        raise AssertionError(f"{run} run: CUDA-core tiles launched: {flash_by_regime}, "
                             f"{by_regime}")
    # A model step calls its attention kernel once per layer, and the W8A16
    # kernels 4 times per layer (wq|wk|wv and wg|wu grouped, wo, wd) and
    # once for the head (bf16 weights: never).
    layers = eng.model_config.num_layers
    per_step = W8A16_PER_LAYER * layers + 1
    if any(launches[fn.__name__] % layers for fn in attention):
        raise AssertionError(f"{run} run: launches not whole steps of {layers}: {launches}")
    if launches["qdot"] % per_step or (launches["qdot"] > 0) != int8:
        raise AssertionError(f"{run} run: W8A16 launches {launches['qdot']} not whole steps "
                             f"of {per_step}")
    if launches["qdot_many"] * per_step != launches["qdot"] * 2 * layers:
        raise AssertionError(f"{run} run: grouped W8A16 launches {launches['qdot_many']} are "
                             f"not 2 per layer of each step")
    # A speculative run's decode steps are all verify steps (S = G+1): on
    # the ragged kernel they take its split-KV tile, which no prefill of
    # the run takes.
    if spec and decode_kernel == "ragged" and (
            by_regime.get("split_kv", 0) == 0 or by_regime["split_kv"] % layers):
        raise AssertionError(f"{run} run: verify steps not on the split-KV tile: {by_regime}")
    # TTFT and decode tok/s of the streamed request (one of 8 running
    # together: its inter-token time is one decode step of the batch),
    # and the 7 others' tokens over the batch's wall time (prefills
    # included).
    stats = {
        "ttft_s": times[0],
        "stream_decode_tok_s": (len(times) - 1) / (times[-1] - times[0]) if len(times) > 1 else None,
        "concurrent_tok_s": tokens / wall,
        "launches": launches,
        "launches_by_pool": by_pool,
        "launches_by_regime": by_regime,
        "flash_launches_by_regime": flash_by_regime,
        "pool": {"dtype": pool_dtype, "bytes": pool.nbytes},
        "steps": {n: c // {"qdot": per_step, "qdot_many": 2 * layers}.get(n, layers)
                  for n, c in launches.items()},
        "graph_replays": chunks,
        "capture_s": dict(eng.graph_capture_seconds),
        "warmup": eng.warmup_result,
    }
    if spec:
        stats["speculative"] = spec
    log(f"serving[{run}]", json.dumps(stats))
    # The server and its handler class form a cycle: collect it, or a run
    # that built its own weights keeps them on the card.
    del eng, srv, engine
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _check_graphed(eng, run) -> int:
    """Every decode chunk the engine ran was one replay of its CUDA graph
    (the engine's chunk log), and there were some. Returns how many."""
    chunks = list(eng.chunk_log)
    if not chunks or not all(c["graph"] for c in chunks) or not eng.graph_capture_seconds:
        raise AssertionError(f"{run}: decode chunks not all graph replays: "
                             f"{sum(bool(c['graph']) for c in chunks)} of {len(chunks)}")
    return len(chunks)


# Greedy prompts of the speculative runs' parity check: text, and a
# repeating pattern whose continuation the n-gram drafter can find.
SPEC_PROMPTS = ("The quick brown fox jumps over the lazy dog. The quick brown fox",
                "one two three four one two three four one two three four one",
                "Request number 3: tell a story about the sea.")


def _spec_parity(eng, run) -> dict:
    """A speculative engine's greedy tokens against the same engine's
    config at G = 0 on the same weights (SPEC_PROMPTS, 48 tokens each),
    and the drafted and accepted drafts of the whole serving run. Where
    the two first differ, the G = 0 run's top-2 logit gap there must be
    within 2 bf16 ulps of its largest logit (a near-tie that the verify
    step's other summation order may break the other way)."""
    import dataclasses

    from kubeai_tpu_torch.engine.core import Engine

    G = eng.cfg.speculate_tokens
    base = Engine(eng.model_config, eng.params, eng.tokenizer,
                  dataclasses.replace(eng.cfg, speculate_tokens=0), device="cuda")
    base.start()
    compared, diverged = 0, []
    try:
        for text in SPEC_PROMPTS:
            ids = eng.tokenizer.encode(text)
            want, gaps = _greedy(base, ids, 48)
            got, _ = _greedy(eng, ids, 48)
            i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
            if i is None:
                compared += len(want)
                continue
            ulp = _logit_ulp(eng.params, eng.model_config, ids + want[:i])
            diverged.append({"prompt": text, "at": i, "gap": gaps[i], "ulp": ulp})
            if gaps[i] > 2 * ulp:
                raise AssertionError(f"{run}: greedy token {i} differs from G=0's ({got[i]} vs "
                                     f"{want[i]}) at a top-2 gap of {gaps[i]} > 2 ulps ({ulp})")
            compared += i
        _check_graphed(base, f"{run} (G=0 base)")
    finally:
        base.stop()
    del base
    steps = eng.spec_drafted // G
    out = {"G": G, "drafted": eng.spec_drafted, "accepted": eng.spec_accepted,
           "greedy_verify_steps": steps,
           "tokens_per_greedy_step": (steps + eng.spec_accepted) / steps if steps else None,
           "greedy_tokens_compared": compared, "diverged_at_near_ties": diverged}
    log(f"speculative[{run}]", json.dumps(out))
    return out


def _logit_ulp(params, mc, ids) -> float:
    """One bf16 ulp of the largest valid logit after *ids* (one cold
    prefill of them through the model)."""
    import torch

    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models import llama

    page = 64
    mp = -(-len(ids) // page)
    pool = llama.init_paged_cache(mc, 1 + mp, page, "cuda")
    table = torch.arange(1, 1 + mp, dtype=torch.int32, device="cuda")[None]
    toks = torch.zeros((1, mp * page), dtype=torch.int64, device="cuda")
    toks[0, : len(ids)] = torch.tensor(ids, device="cuda")
    logits, _ = llama.prefill_paged_cold(params, mc, toks, pool, table,
                                         torch.tensor([len(ids)], device="cuda"))
    top = logits[0, -1, : ByteTokenizer.vocab_size].abs().max().item()
    del pool
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def _wall_ms(fn, n):
    """Host-clock ms of one call of *fn* (after one untimed), synchronized."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3 / n


def _profiled(fn) -> dict:
    """One call of *fn* under torch.profiler: its wall, the device's busy
    ms and kernel count, and the six kernels that took longest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    # Kernel entries only: an operator's entry repeats its kernels' time.
    dev = [(a.key, a.self_device_time_total / 1e3, a.count) for a in prof.key_averages()
           if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]
    return {
        "wall_ms": wall, "device_busy_ms": sum(t for _, t, _ in dev),
        "device_kernels": sum(c for _, _, c in dev),
        "top": [{"kernel": k[:60], "ms": t, "count": c}
                for k, t, c in sorted(dev, key=lambda x: -x[1])[:6]],
    }


def _step_profile(params, qparams) -> None:
    """Where a model step's time goes, at the serving shapes: host-clock
    time of decode steps (B=8, kv_len 512) and of 8-token speculative
    verify steps (kv_len 512 after them) under each decode kernel, with
    int8 weights (*qparams*: ragged decode, dedicated verify) and over an
    fp8 pool (decode, both kernels), and of cold / chunked prefills with
    bf16 and int8 weights, and a torch.profiler breakdown of each one's
    device time by kernel."""
    import torch

    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(use_flash_prefill=True, use_paged_kernel=True)
    B, page, mp = 8, 64, 32
    P = 1 + B * mp
    pool = llama.init_paged_cache(mc, P, page, "cuda")
    table = torch.arange(1, P, dtype=torch.int32, device="cuda").reshape(B, mp)
    tok = torch.randint(0, 259, (B, 1), device="cuda")
    spec = torch.randint(0, 259, (B, 8), device="cuda")
    lengths = torch.full((B,), 512, device="cuda")

    wall_ms, profiled = _wall_ms, _profiled
    steps = {}
    for dk in ("ragged", "dedicated"):
        steps[f"decode_{dk}"] = lambda dk=dk: llama.decode_step_paged(
            params, mc, tok, pool, table, lengths, decode_kernel=dk)
        steps[f"verify8_{dk}"] = lambda dk=dk: llama.decode_speculative_paged(
            params, mc, spec, pool, table, lengths - 8, decode_kernel=dk)
    steps["decode_int8"] = lambda: llama.decode_step_paged(
        qparams, mc, tok, pool, table, lengths, decode_kernel="ragged")
    # An fp8 pool: half the K/V bytes, and the quantize-on-write ops of
    # each layer in the step.
    mc8 = mc.replace(kv_cache_dtype="fp8")
    pool8 = llama.init_paged_cache(mc8, P, page, "cuda")
    for dk in ("ragged", "dedicated"):
        steps[f"decode_fp8_{dk}"] = lambda dk=dk: llama.decode_step_paged(
            params, mc8, tok, pool8, table, lengths, decode_kernel=dk)
    steps["verify8_int8"] = lambda: llama.decode_speculative_paged(
        qparams, mc, spec, pool, table, lengths - 8, decode_kernel="dedicated")
    res = {f"{name}_step_ms": wall_ms(fn, 10) for name, fn in steps.items()}
    # Prefills, bf16 and int8 weights: a cold 512-token bucket (flash) and
    # a 1024-token chunk at 1024 (the ragged kernel's prefill tile).
    t512 = torch.randint(0, 259, (1, 512), device="cuda")
    t1024 = torch.randint(0, 259, (1, 1024), device="cuda")
    L512, start, last = (torch.tensor([n], device="cuda") for n in (512, 1024, 1023))
    prefills = {}
    for tag, p in (("", params), ("_int8", qparams)):
        prefills[f"cold_prefill_512{tag}"] = lambda p=p: llama.prefill_paged_cold(
            p, mc, t512, pool, table[:1], L512)
        prefills[f"chunk_prefill_1024_at_1024{tag}"] = lambda p=p: llama.prefill_paged(
            p, mc, t1024, pool, table[:1], start, last)
    res.update({f"{name}_ms": wall_ms(fn, 3) for name, fn in prefills.items()})
    res["profiled"] = {name: profiled(fn) for name, fn in {**steps, **prefills}.items()}
    log("step_profile", gpu_line(), json.dumps(res))
    del pool, pool8
    torch.cuda.empty_cache()


def _calibrate_int8_pool(qparams) -> tuple[float, float]:
    """Static int8 pool scales for the serving run (calibration in this
    harness, not a feature of the port): one bf16-pool cold prefill of a
    300-byte prompt through the 32-layer model, then the absmax of the K
    and of the V rows it wrote, over 127."""
    import torch

    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(use_flash_prefill=True, use_paged_kernel=True)
    page, mp = 64, 8
    ids = ByteTokenizer().encode(("The quick brown fox jumps over the lazy dog. " * 7)[:300])
    n = len(ids)
    toks = torch.zeros((1, mp * page), dtype=torch.int64, device="cuda")
    toks[0, :n] = torch.tensor(ids, device="cuda")
    pool = llama.init_paged_cache(mc, 1 + mp, page, "cuda")
    table = torch.arange(1, 1 + mp, dtype=torch.int32, device="cuda")[None]
    llama.prefill_paged_cold(qparams, mc, toks, pool, table, torch.tensor([n], device="cuda"))
    L = mc.num_layers
    kv = pool["kv"].reshape(L, 1 + mp, page, 2 * mc.num_kv_heads, -1)[:, 1:]
    kv = kv.reshape(L, mp * page, 2 * mc.num_kv_heads, -1)[:, :n].float()
    sk = (kv[:, :, 0::2].abs().max() / 127.0).item()
    sv = (kv[:, :, 1::2].abs().max() / 127.0).item()
    log("int8_pool_scales", json.dumps({"prompt_tokens": n, "kv_scale_k": sk, "kv_scale_v": sv}))
    del pool, kv
    torch.cuda.empty_cache()
    return sk, sv


def phase_serving() -> dict:
    import torch

    from kubeai_tpu_torch.engine.weights import quantize_model_params
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    t0 = time.monotonic()
    params = llama.init_params(llama_3_1_8b(), torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"weights: Llama-3.1-8B random bf16 in {time.monotonic() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    out = {}
    for dk in ("ragged", "dedicated"):
        out[dk] = _serve_once(params, dk)
    t0 = time.monotonic()
    _graph_turns(params)
    log(f"graph turns: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    qparams = quantize_model_params(params, llama_3_1_8b())
    torch.cuda.synchronize()
    log(f"weights: quantized to int8 on the card in {time.monotonic() - t0:.1f}s")
    out["int8"] = _serve_once(qparams, "ragged", int8=True)
    # The fp8 pool through the server's command line, as a user starts it
    # (its own seed-0 weights: the same as *params*).
    # It starts with --warmup: every step shape, the decode chunk's capture
    # included, before the first request.
    out["fp8_pool"] = _serve_once(None, "ragged", run="fp8_pool", cli=[
        "--model", "preset:llama-3.1-8b", "--kv-cache-dtype", "fp8", "--decode-kernel", "ragged",
        "--max-slots", "8", "--max-seq-len", "2048", "--page-size", "64", "--warmup"])
    warm = out["fp8_pool"]["warmup"]
    if not warm or warm["shapes"] != 1 + 3 * 6 + 3:
        raise AssertionError(f"fp8_pool: --warmup ran {warm}")
    log("warmup[fp8_pool]", gpu_line(), json.dumps(
        {**warm, "capture_s": out["fp8_pool"]["capture_s"]}))
    sk, sv = _calibrate_int8_pool(qparams)
    out["int8_pool"] = _serve_once(qparams, "dedicated", int8=True, kv_cache_dtype="int8",
                                   model_config=llama_3_1_8b(kv_scale_k=sk, kv_scale_v=sv),
                                   run="int8_pool")
    # Speculative decoding through the server's command line (its own
    # seed-0 weights, the same as *params*): 7 drafts a step, verify steps
    # of 8 tokens on each decode kernel.
    for dk in ("ragged", "dedicated"):
        out[f"spec_{dk}"] = _serve_once(None, dk, run=f"spec_{dk}", cli=[
            "--model", "preset:llama-3.1-8b", "--speculate-tokens", "7", "--decode-kernel", dk,
            "--max-slots", "8", "--max-seq-len", "2048", "--page-size", "64"])
    out.update(_serve_lora(params, qparams))
    bf16_bytes = out["ragged"]["pool"]["bytes"]
    for run in ("fp8_pool", "int8_pool"):
        if out[run]["pool"]["bytes"] * 2 != bf16_bytes:
            raise AssertionError(f"{run}: pool bytes {out[run]['pool']['bytes']} are not half "
                                 f"of bf16's {bf16_bytes}")
    log("serving_summary", gpu_line(), json.dumps(
        {k: {m: v.get(m) for m in ("ttft_s", "stream_decode_tok_s", "concurrent_tok_s",
                                   "speculative")}
         for k, v in out.items()}))
    # Profiler sessions after every timed serving run.
    _graph_profiles(params)
    _step_profile(params, qparams)
    _lora_step_profile(params)
    shutil.rmtree(os.path.dirname(_ADAPTERS[0]), ignore_errors=True)
    del params, qparams
    torch.cuda.empty_cache()
    out.update(_serve_families())
    _serve_checkpoint()
    out["tiny_int8_fp8"] = _serve_tiny("tiny_int8_fp8", ["--quantization", "int8",
                                                         "--kv-cache-dtype", "fp8"])
    out["tiny_spec"] = _serve_tiny("tiny_spec", ["--speculate-tokens", "3"])
    return out


# ---------------------------------------------------------------------------
# LoRA adapters (phase 3's parity, phase 4's serving runs and step profile)

_ADAPTERS: list = []


def _adapter_dirs() -> list:
    """Three PEFT adapters (a, b, c) for Llama-3.1-8B, written once by the
    port's writer under build/: rank 16 on all seven targets of all 32
    layers, alpha 32, N(0, 0.02) A and B from seeds 1-3 (each delta a
    fraction of its projection)."""
    if not _ADAPTERS:
        from kubeai_tpu_torch.engine.lora import write_peft_checkpoint
        from kubeai_tpu_torch.models.base import llama_3_1_8b

        t0 = time.monotonic()
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "lora_adapters")
        for i, name in enumerate("abc"):
            path = os.path.join(root, name)
            write_peft_checkpoint(path, llama_3_1_8b(), rank=16, alpha=32, seed=i + 1, std=0.02)
            _ADAPTERS.append(path)
        log(f"adapters: 3 PEFT checkpoints (rank 16, 7 targets, 32 layers) written in "
            f"{time.monotonic() - t0:.1f}s")
    return _ADAPTERS


LORA_PROMPTS = tuple(f"Adapter request {i}: write two lines about the {w}."
                     for i, w in enumerate(("sea", "moon", "forest", "city", "desert", "river",
                                            "storm", "mountain")))
# 3 requests on adapter a, 3 on b, 2 on the base model.
LORA_MIX = ("a", "b", "a", None, "b", "a", None, "b")
# (run, decode kernel, int8 weights, speculate_tokens)
LORA_RUNS = (("lora_ragged", "ragged", False, 0), ("lora_dedicated", "dedicated", False, 0),
             ("lora_int8", "ragged", True, 0), ("lora_spec", "ragged", False, 7))
NO_EOS = {"257": -100}  # the byte tokenizer's EOS, banned: full-length runs


def _zero_launches():
    from kubeai_tpu_torch.ops.flash_attention import flash_attention
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention
    from kubeai_tpu_torch.ops.quant import qdot, qdot_many

    for fn in (flash_attention, paged_attention_ragged, paged_decode_attention, qdot, qdot_many):
        fn.launches = 0
    for fn in (paged_attention_ragged, paged_decode_attention):
        fn.launches_by_pool.clear()
    paged_attention_ragged.launches_by_regime.clear()
    flash_attention.launches_by_regime.clear()


def _read_launches() -> dict:
    """The launch counts as _serve_once reports them."""
    from kubeai_tpu_torch.ops.flash_attention import flash_attention
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention
    from kubeai_tpu_torch.ops.quant import qdot, qdot_many

    return {
        "launches": {fn.__name__: fn.launches for fn in (
            flash_attention, paged_attention_ragged, paged_decode_attention, qdot, qdot_many)},
        "launches_by_pool": {fn.__name__: dict(fn.launches_by_pool)
                             for fn in (paged_attention_ragged, paged_decode_attention)},
        "launches_by_regime": dict(paged_attention_ragged.launches_by_regime),
        "flash_launches_by_regime": dict(flash_attention.launches_by_regime),
    }


def _staggered(eng, prompts, adapters, n=32):
    """Greedy token ids and texts of *prompts* through the engine's queue,
    each with its adapter and EOS banned, each submitted once the one
    before it has its first token: every prefill runs alone (its numbers
    do not depend on timing), and all decode together."""
    return _collect(_start_staggered(eng, prompts, adapters, n))


def _start_staggered(eng, prompts, adapters, n=32) -> list:
    """_staggered's submissions: [(request, ids, texts)], each with its
    first token, all still decoding."""
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    reqs = []
    for prompt, adapter in zip(prompts, adapters):
        sp = SamplingParams(temperature=0.0, max_tokens=n, logit_bias=((257, -100.0),))
        reqs.append((eng.submit(eng.tokenizer.encode(prompt), sp, adapter=adapter), [], []))
        ev = reqs[-1][0].out.get(timeout=300)
        if ev[0] != "token":
            raise AssertionError(f"no first token: {ev}")
        reqs[-1][1].append(ev[1])
        reqs[-1][2].append(ev[2])
    return reqs


def _collect(reqs) -> tuple:
    """(ids, texts) of _start_staggered's requests, once they finish."""
    for req, ids, text in reqs:
        while True:
            ev = req.out.get(timeout=300)
            if ev[0] == "token":
                if ev[1] >= 0:
                    ids.append(ev[1])
                text.append(ev[2])
            elif ev[0] == "done":
                break
            else:
                raise AssertionError(f"request failed: {ev}")
    return [ids for _, ids, _ in reqs], ["".join(t) for _, _, t in reqs]


def _stream_http_staggered(port, prompts, models, n=32):
    """The same requests through the server (SSE streams, "model" naming
    the adapter or the served model): each starts once the one before it
    has streamed its first token, then all decode together. Returns each
    one's text."""
    results: list = [None] * len(prompts)
    started = [threading.Event() for _ in prompts]
    errors: list = []

    def worker(i):
        try:
            body = {"model": models[i], "prompt": prompts[i], "max_tokens": n,
                    "temperature": 0, "logit_bias": NO_EOS, "stream": True}
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            text = []
            with urllib.request.urlopen(req, timeout=600) as r:
                for raw in r:
                    line = raw.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    ev = json.loads(line[len("data: "):])
                    if "error" in ev:
                        raise AssertionError(ev["error"])
                    text.append(ev["choices"][0].get("text") or "")
                    started[i].set()
            results[i] = "".join(text)
        except Exception as e:  # reported below
            errors.append(f"{i}: {e!r}")
        finally:
            started[i].set()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for i, th in enumerate(threads):
        th.start()
        started[i].wait(timeout=300)
    for th in threads:
        th.join(timeout=600)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"adapter requests failed: {errors}")
    return results


def _serve_lora(params, qparams) -> dict:
    """LORA_RUNS: the 32-layer model served with two PEFT adapters loaded
    through the server's routes (bf16 ragged and dedicated, int8 weights,
    --speculate-tokens 7), the launch counters zeroed before each run.
    Before the first load the engine (no bank) serves LORA_PROMPTS alone
    (staggered): the reference. Then /v1/load_lora_adapter a and b (the
    bank is allocated, the chunk graph dropped and captured again with the
    deltas), /v1/models, and LORA_PROMPTS with LORA_MIX through the server
    (3 on a, 3 on b, 2 base; staggered, decoding together): base texts
    equal the reference, adapter texts differ. The same through the
    engine's queue: base token ids equal the reference's, and an eager
    engine (cuda_graphs=False) with the same adapters gives the graphed
    engine's ids token for token. The first run also unloads a while its
    requests decode and loads c into the recycled row: the follow-up turn
    under c finds none of the row's old pages and gives the eager
    engine's tokens. The run's launch counts are the graphed engine's
    alone, read before the eager engine starts. Records bank bytes, the
    routes' load seconds, the capture seconds before and after the first
    load."""
    import torch

    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    paths = dict(zip("abc", _adapter_dirs()))
    out = {}
    for run, dk, int8, G in LORA_RUNS:
        ec = EngineConfig(max_slots=8, max_seq_len=2048, page_size=64, decode_kernel=dk,
                          speculate_tokens=G)
        w = qparams if int8 else params
        eng = Engine(llama_3_1_8b(), w, ByteTokenizer(), ec, device="cuda")
        srv = EngineServer(eng, run, host="127.0.0.1", port=0)
        _zero_launches()
        srv.start()
        p = srv.port
        try:
            ref_ids, ref_text = _staggered(eng, LORA_PROMPTS, [None] * 8)
            capture_before = dict(eng.graph_capture_seconds)
            load_s = {}
            for name in "ab":
                t0 = time.monotonic()
                r = _post(p, "/v1/load_lora_adapter", {"lora_name": name, "lora_path": paths[name]})
                load_s[name] = time.monotonic() - t0
                if r != {"status": "ok"}:
                    raise AssertionError(f"{run}: load {name}: {r}")
            with urllib.request.urlopen(f"http://127.0.0.1:{p}/v1/models", timeout=60) as r:
                models = json.loads(r.read())["data"]
            if [(m["id"], m.get("parent")) for m in models] != [(run, None), ("a", run),
                                                                 ("b", run)]:
                raise AssertionError(f"{run}: /v1/models {models}")
            texts = _stream_http_staggered(p, LORA_PROMPTS, [a or run for a in LORA_MIX])
            capture_after = dict(eng.graph_capture_seconds)
            ids, _ = _staggered(eng, LORA_PROMPTS, LORA_MIX)
            for i, a in enumerate(LORA_MIX):
                if a is None and (texts[i] != ref_text[i] or ids[i] != ref_ids[i]):
                    raise AssertionError(f"{run}: base request {i} changed by the bank")
                if a is not None and (texts[i] == ref_text[i] or ids[i] == ref_ids[i]):
                    raise AssertionError(f"{run}: adapter request {i} ({a}) equals base")
            recycle = _unload_under_load(eng, p, paths) if run == "lora_ragged" else None
            # The run's counts: the graphed engine's traffic alone, read
            # before the eager engine below launches anything.
            stats = _read_launches()
            _check_lora_launches(run, stats["launches"], eng.model_config.num_layers, dk, int8)
            _zero_launches()
            eager = Engine(llama_3_1_8b(), w, ByteTokenizer(), ec, device="cuda",
                           cuda_graphs=False)
            eager.start()
            try:
                for name in "ab":
                    eager.load_adapter(name, paths[name])
                eager_ids, _ = _staggered(eager, LORA_PROMPTS, LORA_MIX)
                if eager_ids != ids:
                    bad = [i for i, (x, y) in enumerate(zip(ids, eager_ids)) if x != y]
                    raise AssertionError(f"{run}: graphed ids differ from eager for {bad}")
                if recycle:
                    eager.unload_adapter("a")
                    eager.load_adapter("c", paths["c"])  # a's row, as in the served engine
                    if _greedy_ids(eager, recycle["follow"], "c") != recycle.pop("got"):
                        raise AssertionError("follow-up under c differs from the eager engine's")
                    del recycle["follow"]
            finally:
                eager.stop()
            # The eager engine's counts, kept apart from the run's.
            eager_launches = _read_launches()["launches"]
            chunks = _check_graphed(eng, run)
        finally:
            srv.stop()
        bank = eng._adapters.bank
        res = {**stats, "eager_engine_launches": eager_launches, "graph_replays": chunks,
               "bank_bytes": sum(t.nbytes for t in bank.values()),
               "load_adapter_s": load_s, "capture_s_before_load": capture_before,
               "capture_s_after_load": capture_after}
        if G:
            res["speculative"] = {"drafted": eng.spec_drafted, "accepted": eng.spec_accepted}
        if recycle:
            res["unload_reload"] = recycle
        log(f"serving[{run}]", gpu_line(), json.dumps(res))
        out[run] = res
        del eng, eager, srv, bank
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _check_lora_launches(run, launches, layers, dk, int8) -> None:
    """Every kernel of the run's path launched, the paged ones in whole
    model steps."""
    want = ["paged_attention_ragged"] + (["paged_decode_attention"] if dk == "dedicated"
                                         else []) + (["qdot"] if int8 else [])
    if [n for n in want if launches[n] == 0] or any(
            launches[n] % layers for n in ("paged_attention_ragged", "paged_decode_attention")):
        raise AssertionError(f"{run}: launches {launches}")


def _unload_under_load(eng, port, paths) -> dict:
    """Three greedy requests on adapter a decode (96 tokens, EOS banned);
    /v1/unload_lora_adapter a and /v1/load_lora_adapter c while they do
    (c takes a's row, one generation later); the requests finish. The
    follow-up turn (a request's prompt and output) under c must claim
    none of the pages the a requests registered, which do match under
    a's old (row, generation). Returns the record, with the follow-up's
    prompt ("follow") and greedy ids ("got") for the eager engine to
    match."""
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=96, logit_bias=((257, -100.0),))
    sig_a = eng._lora_sig("a")
    prompts = [eng.tokenizer.encode(t) for t in LORA_PROMPTS[:3]]
    reqs = [eng.submit(ids, sp, adapter="a") for ids in prompts]
    first = [r.out.get(timeout=300) for r in reqs]
    if any(ev[0] != "token" for ev in first):
        raise AssertionError(f"unload under load: {first}")
    if _post(port, "/v1/unload_lora_adapter", {"lora_name": "a"}) != {"status": "ok"}:
        raise AssertionError("unload a failed")
    decoding = eng.active_slots()
    if _post(port, "/v1/load_lora_adapter", {"lora_name": "c", "lora_path": paths["c"]}) != \
            {"status": "ok"}:
        raise AssertionError("load c failed")
    if decoding != len(reqs):
        raise AssertionError(f"{decoding} of {len(reqs)} requests decoding at the unload")
    outs = []
    for r, ev in zip(reqs, first):
        ids = [ev[1]]
        while True:
            ev = r.out.get(timeout=300)
            if ev[0] == "done":
                break
            if ev[0] != "token":
                raise AssertionError(f"a request failed after the unload: {ev}")
            if ev[1] >= 0:
                ids.append(ev[1])
        outs.append(ids)
    sig_c = eng._lora_sig("c")
    if sig_c[0] != sig_a[0] or sig_c[1] != sig_a[1] + 2:
        raise AssertionError(f"c did not take a's row one generation on: {sig_a} -> {sig_c}")
    follow = prompts[0] + outs[0] + eng.tokenizer.encode(" And then?", add_bos=False)

    def claims():
        pool = eng._pool
        got = {}
        for name, sig in (("old_a", sig_a), ("c", sig_c)):
            pages = pool.match_prefix(follow, sig)
            pool.release(pages)
            got[name] = len(pages)
        return got

    claimed = eng._run_on_scheduler(claims, "prefix probe")
    if claimed["c"] or not claimed["old_a"]:
        raise AssertionError(f"follow-up under c: pages matched {claimed}")
    got = _greedy_ids(eng, follow, "c")
    res = {"decoding_at_unload": decoding, "sig_a": sig_a, "sig_c": sig_c,
           "pages_matched": claimed, "follow_up_tokens": len(got)}
    log("lora_unload_reload", json.dumps(res))
    return {**res, "follow": follow, "got": got}


def _greedy_ids(eng, ids, adapter, n=32):
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=n, logit_bias=((257, -100.0),))
    return eng.generate(ids, sp, adapter=adapter)[0]


def _lora_step_profile(params) -> None:
    """A decode step (B=8, kv_len 512, ragged) of the 32-layer model
    without a bank, and with a bank holding adapters a and b (rank 16,
    max rank 64, 9 rows) for: every row 0, every slot on a, and a and b
    alternating: host-clock ms and a torch.profiler breakdown of each."""
    import torch

    from kubeai_tpu_torch.engine.lora import AdapterRuntime
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(use_flash_prefill=True, use_paged_kernel=True)
    B, page, mp = 8, 64, 32
    P = 1 + B * mp
    pool = llama.init_paged_cache(mc, P, page, "cuda")
    table = torch.arange(1, P, dtype=torch.int32, device="cuda").reshape(B, mp)
    tok = torch.randint(0, 259, (B, 1), device="cuda")
    lengths = torch.full((B,), 512, device="cuda")
    rt = AdapterRuntime(mc, device="cuda")
    t0 = time.monotonic()
    for name, path in zip("ab", _adapter_dirs()):
        rt.load(name, path)
    torch.cuda.synchronize()
    load_s = (time.monotonic() - t0) / 2
    rows = {"bank_rows_0": [0] * B, "one_adapter": [1] * B, "two_adapters": [1, 2] * (B // 2)}
    steps = {"no_bank": lambda: llama.decode_step_paged(params, mc, tok, pool, table, lengths)}
    for name, r in rows.items():
        rr = torch.tensor(r, device="cuda")
        steps[name] = lambda rr=rr: llama.decode_step_paged(params, mc, tok, pool, table,
                                                            lengths, lora=rt.bank, lora_rows=rr)
    res = {"bank_bytes": sum(t.nbytes for t in rt.bank.values()),
           "runtime_load_s_per_adapter": load_s}
    res.update({f"{name}_step_ms": _wall_ms(fn, 10) for name, fn in steps.items()})
    res["profiled"] = {name: _profiled(fn) for name, fn in steps.items()}
    log("step_profile[lora]", gpu_line(), json.dumps(res))
    del pool, rt
    torch.cuda.empty_cache()


# The other families' serving runs: (run, preset, layers (None: the
# preset's), decode kernel, weight quantization, KV pool dtype).
# Mixtral-8x7B's 32 bf16 layers (93 GB) do not fit one 80 GB card: 16 of
# them at full width (47 GB) until tensor parallelism.
FAMILY_RUNS = (
    ("qwen_bf16", "qwen2.5-7b", None, "ragged", "", ""),
    ("qwen_int8", "qwen2.5-7b", None, "dedicated", "int8", ""),
    ("gemma_bf16", "gemma-2b", None, "ragged", "", ""),
    ("gemma_fp8", "gemma-2b", None, "dedicated", "", "fp8"),
    ("gemma2_bf16", "gemma2-2b", None, "ragged", "", ""),
    ("mixtral_bf16", "mixtral-8x7b", 16, "ragged", "", ""),
)


def _serve_families() -> dict:
    """Each FAMILY_RUNS entry: the preset's engine (random weights from
    seed 0, build_engine) serves _serve_once's request set through the
    server, then its model steps are profiled (_family_step_profile);
    the engine is freed before the next run."""
    import torch

    from kubeai_tpu_torch.engine.core import PRESETS, EngineConfig, build_engine

    out = {}
    for run, preset, layers, dk, quant, kv in FAMILY_RUNS:
        t0 = time.monotonic()
        ec = EngineConfig(max_slots=8, max_seq_len=2048, page_size=64, decode_kernel=dk,
                          kv_cache_dtype=kv)
        eng = build_engine(preset, "cuda", ec, seed=0, quantization=quant, num_layers=layers)
        torch.cuda.synchronize()
        mc = eng.model_config
        log(f"weights[{run}]: {preset} {mc.num_layers} of {PRESETS[preset]().num_layers} layers, "
            f"{'int8' if quant else mc.dtype}, built in {time.monotonic() - t0:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
        out[run] = _serve_once(None, dk, int8=bool(quant), run=run, engine=eng)
        out[run]["layers"] = mc.num_layers
        _family_step_profile(run, eng.params, mc, dk)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _family_step_profile(run, params, mc, decode_kernel) -> None:
    """A family's model steps at the serving shapes (B=8, kv_len 512,
    page 64): host-clock ms of a decode step and an 8-token verify step
    on the run's decode kernel and of a cold 512-token prefill, and each
    one under torch.profiler (device busy ms, kernel count)."""
    import torch

    from kubeai_tpu_torch.models import llama

    B, page, mp = 8, 64, 32
    P = 1 + B * mp
    pool = llama.init_paged_cache(mc, P, page, "cuda")
    table = torch.arange(1, P, dtype=torch.int32, device="cuda").reshape(B, mp)
    tok = torch.randint(0, 259, (B, 1), device="cuda")
    spec = torch.randint(0, 259, (B, 8), device="cuda")
    lengths = torch.full((B,), 512, device="cuda")
    t512 = torch.randint(0, 259, (1, 512), device="cuda")
    L512 = torch.tensor([512], device="cuda")
    steps = {
        "decode": lambda: llama.decode_step_paged(params, mc, tok, pool, table, lengths,
                                                  decode_kernel=decode_kernel),
        "verify8": lambda: llama.decode_speculative_paged(params, mc, spec, pool, table,
                                                          lengths - 8,
                                                          decode_kernel=decode_kernel),
        "cold_prefill_512": lambda: llama.prefill_paged_cold(params, mc, t512, pool, table[:1],
                                                             L512),
    }
    res = {"layers": mc.num_layers, "decode_kernel": decode_kernel,
           "pool": str(pool["kv"].dtype).removeprefix("torch.")}
    res.update({f"{name}_ms": _wall_ms(fn, 5) for name, fn in steps.items()})
    res["profiled"] = {name: _profiled(fn) for name, fn in steps.items()}
    log(f"step_profile[{run}]", gpu_line(), json.dumps(res))
    del pool
    torch.cuda.empty_cache()


def _graph_turns(params) -> None:
    """Eager and graphed engines in turns (eager, graphed, graphed, eager)
    on the same 32-layer weights, bf16 with the ragged kernel at G = 0 and
    at G = 7: each warms up, then serves 3 rounds of 8 concurrent greedy
    requests of 128 tokens (tools/time_decode_variants.py serve_rounds).
    Prints per engine each round's wall per step of a chunk (chunk wall /
    K), aggregate and per-stream tok/s, the streamed request's TTFT and
    the chunk's host segments. Every graphed engine's chunks must be
    replays, and its greedy tokens the eager engine's (up to near-ties of
    differently grouped prefills)."""
    for G in (0, 7):
        ref = None
        for turn, graphs in enumerate((False, True, True, False)):
            res = _serve_traffic(params, G, graphs, profile=False)
            diverged = []
            for r in res["rounds"]:
                ids, gaps = r.pop("ids"), r.pop("gaps")
                if ref is None:
                    ref = (ids, gaps)
                    continue
                diverged += _near_tie_divergence(params, ids, *ref, f"turns G={G} #{turn}")
            res["diverged_at_near_ties"] = diverged
            log(f"graph_turns[G={G} #{turn} {res['mode']}]", gpu_line(), json.dumps(res))


def _graph_profiles(params) -> None:
    """One eager and one graphed engine per G (0 and 7, bf16 ragged)
    serve a round of 64 tokens a stream with a torch.profiler window over
    6 chunks: device busy ms per chunk and the window's idle share. Run
    after the timed serving runs: a profiler session slows the launches
    a process makes after it."""
    for G in (0, 7):
        for graphs in (False, True):
            res = _serve_traffic(params, G, graphs, profile=True)
            for r in res["rounds"]:
                del r["ids"], r["gaps"]
            log(f"graph_profile[G={G} {res['mode']}]", gpu_line(), json.dumps(res))


def _serve_traffic(params, G: int, graphs: bool, profile: bool) -> dict:
    """A warmed-up engine (bf16 ragged, 8 slots, speculate_tokens G,
    graphed or eager) serving the turns' traffic: 3 rounds, or with
    *profile* one round of 64 tokens a stream with a profiled window."""
    import torch

    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.tools.time_decode_variants import serve_rounds

    ec = EngineConfig(max_slots=8, max_seq_len=2048, page_size=64, speculate_tokens=G)
    eng = Engine(llama_3_1_8b(), params, ByteTokenizer(), ec, device="cuda",
                 cuda_graphs=graphs)
    warm = eng.warmup()
    eng.start()
    try:
        rounds = (serve_rounds(eng, rounds=1, max_tokens=64, profile=True) if profile
                  else serve_rounds(eng))
    finally:
        eng.stop()
    if graphs:
        _check_graphed(eng, f"turns G={G}")
    elif any(c["graph"] for c in eng.chunk_log):
        raise AssertionError(f"turns G={G}: an eager engine replayed a graph")
    res = {"mode": "graphed" if graphs else "eager", "warmup": warm,
           "capture_s": dict(eng.graph_capture_seconds), "rounds": rounds}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _near_tie_divergence(params, ids, ref_ids, ref_gaps, what) -> list:
    """Greedy token lists of the turns' requests against the first
    round's. Requests admitted together prefill as one group, whose size
    depends on timing and may round a logit the other way: where a
    request first differs, the reference's top-2 gap must be within 2
    bf16 ulps of its largest logit (as _spec_parity allows). Returns the
    divergences."""
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.tools.time_decode_variants import SERVE_PROMPTS

    out = []
    for i, (got, want) in enumerate(zip(ids, ref_ids)):
        j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if j is None:
            if len(got) != len(want):
                raise AssertionError(f"{what}: request {i} has {len(got)} tokens, not "
                                     f"{len(want)}")
            continue
        prompt = ByteTokenizer().encode(SERVE_PROMPTS[i % len(SERVE_PROMPTS)])
        ulp = _logit_ulp(params, llama_3_1_8b(), prompt + want[:j])
        out.append({"request": i, "at": j, "gap": ref_gaps[i][j], "ulp": ulp})
        if ref_gaps[i][j] > 2 * ulp:
            raise AssertionError(f"{what}: request {i}'s greedy token {j} differs from the "
                                 f"first round's at a top-2 gap of {ref_gaps[i][j]} > 2 ulps "
                                 f"({ulp})")
    return out


def _greedy(engine, prompt, n):
    """(tokens, top-2 logprob gaps) of a greedy completion through the
    engine's own queue."""
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    req = engine.submit(prompt, SamplingParams(temperature=0.0, max_tokens=n, logprobs=True))
    toks, gaps = [], []
    while True:
        ev = req.out.get(timeout=300)
        if ev[0] == "token" and ev[1] >= 0:
            toks.append(ev[1])
            gaps.append(ev[4][0][1] - ev[4][1][1])
        elif ev[0] == "done":
            return toks, gaps
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


def _serve_tiny(run: str, extra: list) -> dict:
    """The JAX package's float32 test configuration as a user starts it
    (--model test:tiny with *extra* flags; random weights from --seed):
    with int8 weights over an fp8 pool (quantized on the card), or with
    speculative decoding (--speculate-tokens 3: verify steps of 4
    tokens). The server answers a completion, and the engine's greedy
    tokens equal those of the same engine config and weights on the CPU
    (the plain versions) up to the first step whose top-2 logprobs are
    within 1e-4. The launch counters are zeroed before the card's run;
    the ragged kernel (the head-dim-32 fp8 instances for an fp8 pool)
    and, with int8 weights, the W8A16 kernels' float32 instance must
    launch there, a whole number of times per step; a speculative run
    must accept drafts."""
    import torch

    from kubeai_tpu_torch.engine.core import Engine
    from kubeai_tpu_torch.engine.server import (
        EngineServer,
        build_engine_from_args,
        make_arg_parser,
    )
    from kubeai_tpu_torch.ops.flash_attention import flash_attention
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention
    from kubeai_tpu_torch.ops.quant import qdot, qdot_many

    args = make_arg_parser().parse_args([
        "--model", "test:tiny", *extra,
        "--host", "127.0.0.1", "--port", "0", "--max-slots", "4", "--max-seq-len", "512"])
    card, name = build_engine_from_args(args)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    cpu = Engine(card.model_config, to_cpu(card.params), card.tokenizer, card.cfg, device="cpu")
    pool = card.cache["kv"]
    pool_dtype = str(pool.dtype).removeprefix("torch.")
    want_pool = torch.float8_e4m3fn if args.kv_cache_dtype == "fp8" else torch.float32
    if pool.dtype != want_pool or pool.shape[-1] != 32:
        raise AssertionError(f"{run}: pool {pool.dtype} {tuple(pool.shape)}")
    counters = (flash_attention, paged_attention_ragged, paged_decode_attention, qdot, qdot_many)
    for fn in counters:
        fn.launches = 0
    for fn in (paged_attention_ragged, paged_decode_attention):
        fn.launches_by_pool.clear()
    srv = EngineServer(card, name, host=args.host, port=args.port)
    srv.start()
    cpu.start()
    compared = 0
    try:
        text = _check_completion(_post(srv.port, "/v1/completions", {
            "prompt": "Hello", "max_tokens": 8, "temperature": 0}), run)
        for prompt in ([256] + list(b"short prompt"),
                       [256] + [1, 2, 3, 4] * 10,  # its greedy output accepts drafts
                       [256] + [(i * 7) % 250 + 1 for i in range(100)],
                       [256] + [(i * 11) % 250 + 1 for i in range(200)]):  # chunked
            want, gaps = _greedy(cpu, prompt, 48)
            got, _ = _greedy(card, prompt, 48)
            upto = next((i for i, g in enumerate(gaps) if g < 1e-4), len(want))
            if got[:upto] != want[:upto]:
                raise AssertionError(f"{run}: card tokens {got} differ from the CPU's {want} "
                                     f"(compared {upto})")
            compared += upto
        launches = {fn.__name__: fn.launches for fn in counters}
        by_pool = {fn.__name__: dict(fn.launches_by_pool)
                   for fn in (paged_attention_ragged, paged_decode_attention)}
        graph_replays = _check_graphed(card, run)
    finally:
        srv.stop()
        cpu.stop()
    layers = card.model_config.num_layers
    int8 = bool(args.quantization)
    if ((launches["qdot"] > 0) != int8 or launches["qdot"] % (W8A16_PER_LAYER * layers + 1)
            or launches["paged_attention_ragged"] == 0
            or launches["paged_attention_ragged"] % layers
            or set(by_pool["paged_attention_ragged"]) != {pool_dtype}):
        raise AssertionError(f"{run}: launches {launches} {by_pool}")
    stats = {"completion": text, "greedy_tokens_compared": compared, "launches": launches,
             "launches_by_pool": by_pool, "pool": {"dtype": pool_dtype, "bytes": pool.nbytes},
             "graph_replays": graph_replays, "capture_s": dict(card.graph_capture_seconds)}
    if card.cfg.speculate_tokens:
        if card.spec_accepted == 0:
            raise AssertionError(f"{run}: no draft accepted ({card.spec_drafted} drafted)")
        stats["speculative"] = {"drafted": card.spec_drafted, "accepted": card.spec_accepted}
    log(f"serving[{run}]", json.dumps(stats))
    del card, cpu, srv
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# Llama-3's pre-tokenizer pattern (its tokenizer.json's Split regex).
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_CHAT = (
    "{{ bos_token }}{% for message in messages %}"
    "{{ '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n' "
    "+ message['content'] | trim + '<|eot_id|>' }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
    "{% endif %}")
TOKENIZER_CORPUS = (
    "The quick brown fox jumps over the lazy dog. It's a dog's life, isn't it? "
    "Operators serve open-weight models to users who pay for time to first token. "
    "Héllo wörld, café au lait; naïve façade. 日本語のテキスト。 Numbers 1234567 and 3.14159, "
    "x² + Ⅻ. We'll see; they're here, you've done it, I'm sure.\n\nNew paragraph\twith tabs. "
    "def serve(request):\n    return engine.generate(request.prompt, max_tokens=256)\n"
    "Adapters load through /v1/load_lora_adapter while requests keep decoding; the prefix "
    "cache never shares pages across adapters. Gradually, the tokenizer learns frequent pairs: "
    "th, he, in, er, an, re, on, at, en, nd, ti, es, or, te, of, ed, is, it, al, ar, st, to.\n")


def _write_tokenizer(path: str, merges: int = 300) -> dict:
    """A Llama-3-style tokenizer.json and tokenizer_config.json in *path*,
    built here: a byte-level BPE over the 256 byte symbols with *merges*
    merges learned from TOKENIZER_CORPUS (most frequent pair first, ties
    to the smaller pair) under Llama-3's Split pattern, five special
    tokens after them, and a Llama-3 chat template."""
    import collections

    from kubeai_tpu_torch.engine.tokenizer import _bytes_to_unicode, translate_regex

    table = _bytes_to_unicode()
    vocab = {table[b]: b for b in range(256)}
    words = collections.Counter(
        tuple(table[b] for b in w.encode("utf-8"))
        for w in re.findall(translate_regex(LLAMA3_SPLIT), TOKENIZER_CORPUS))
    learned = []
    for _ in range(merges):
        pairs = collections.Counter()
        for w, n in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = min(pairs, key=lambda pr: (-pairs[pr], pr))
        learned.append(list(best))
        vocab.setdefault(best[0] + best[1], len(vocab))
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>"]
    added = [{"id": len(vocab) + i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(specials)]
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": learned},
    }
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
                   "clean_up_tokenization_spaces": False, "chat_template": LLAMA3_CHAT,
                   "tokenizer_class": "PreTrainedTokenizerFast"}, f)
    return {"merges": len(learned), "vocab": len(vocab) + len(specials)}


def _tokenizer_checks(eng, path, port) -> dict:
    """The served checkpoint's own tokenizer (engine *eng* from the
    directory *path*): a round trip of the corpus, a chat completion
    through the server whose text equals decode of the engine's greedy
    ids for the templated prompt, and the host's encode time of a
    4,096-token prompt, by a fresh tokenizer (its word cache empty), then
    again (warm)."""
    from kubeai_tpu_torch.engine.sampling import SamplingParams
    from kubeai_tpu_torch.engine.tokenizer import HFTokenizer

    tok = eng.tokenizer
    if not isinstance(tok, HFTokenizer) or eng.n_valid_vocab != tok.vocab_size:
        raise AssertionError(f"checkpoint tokenizer {type(tok).__name__}, "
                             f"n_valid_vocab {eng.n_valid_vocab}")
    if tok.decode(tok.encode(TOKENIZER_CORPUS)) != TOKENIZER_CORPUS:
        raise AssertionError("tokenizer round trip failed")
    messages = [{"role": "system", "content": "Answer briefly."},
                {"role": "user", "content": "Name a prime number larger than 10."}]
    templated = tok.apply_chat_template(messages)
    if not templated.startswith("<|begin_of_text|><|start_header_id|>system"):
        raise AssertionError(f"chat template not applied: {templated!r}")
    resp = _post(port, "/v1/chat/completions", {"messages": messages, "max_tokens": 24,
                                                 "temperature": 0})
    text = resp["choices"][0]["message"]["content"]
    ids, gen_text, _ = eng.generate(tok.encode(templated),
                                    SamplingParams(temperature=0.0, max_tokens=24))
    if not (text == gen_text == tok.decode(ids)):
        raise AssertionError(f"chat text {text!r} != decode of the greedy ids {tok.decode(ids)!r}")
    long_text = TOKENIZER_CORPUS
    while len(tok.encode(long_text, add_bos=False)) < 4096:
        long_text += TOKENIZER_CORPUS
    fresh = HFTokenizer(path)
    timings = {}
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        n = len(fresh.encode(long_text, add_bos=False))
        timings[f"encode_{n}_tokens_{name}_ms"] = (time.perf_counter() - t0) * 1e3
    return {"chat_prompt_tokens": len(tok.encode(templated)), "chat_completion_tokens": len(ids),
            "chat_text": text, **timings}


def _serve_checkpoint() -> None:
    """The loader: a 2-layer checkpoint at Llama-3.1-8B width (random bf16
    weights from seed 1, HF names and [out, in] layouts) written by the
    port's save_hf_checkpoint under build/, with a tokenizer.json and chat
    template built here (_write_tokenizer), served through the server's
    own argument path with --model <dir> --quantization int8 (a completion
    and a chat completion through the checkpoint's tokenizer); its int8
    leaves must equal quantize_model_params of the written weights, and
    its config the written one."""

    import torch

    from kubeai_tpu_torch.engine.server import (
        EngineServer,
        build_engine_from_args,
        make_arg_parser,
    )
    from kubeai_tpu_torch.engine.weights import (
        hf_state_dict,
        quantize_model_params,
        save_hf_checkpoint,
    )
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(num_layers=2)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ckpt_8b_width_2_layers")
    t0 = time.monotonic()
    p = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    sd = hf_state_dict(p, mc)
    shutil.rmtree(path, ignore_errors=True)
    save_hf_checkpoint(path, mc, sd)
    tok_files = _write_tokenizer(path)
    del sd
    write_s = time.monotonic() - t0
    t0 = time.monotonic()
    args = make_arg_parser().parse_args([
        "--model", path, "--quantization", "int8", "--host", "127.0.0.1", "--port", "0",
        "--max-slots", "2", "--max-seq-len", "512"])
    eng, name = build_engine_from_args(args)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    try:
        if eng.model_config.replace(use_flash_prefill=False, use_paged_kernel=False) != mc:
            raise AssertionError(f"loaded config differs: {eng.model_config}")
        want = quantize_model_params(p, mc)
        bad = []

        def same(a, b, where):
            if isinstance(b, dict):
                for k in b:
                    same(a[k], b[k], f"{where}/{k}")
            elif a.dtype != b.dtype or not torch.equal(a, b):
                bad.append(where)

        same(eng.params, want, "")
        if bad or set(eng.params) != set(want):
            raise AssertionError(f"loaded leaves differ from quantize_model_params: {bad}")
        del want, p
        srv = EngineServer(eng, name, host=args.host, port=args.port)
        srv.start()
        try:
            text = _check_completion(_post(srv.port, "/v1/completions", {
                "prompt": "Hello", "max_tokens": 8, "temperature": 0}), "checkpoint")
            tok_stats = _tokenizer_checks(eng, path, srv.port)
        finally:
            srv.stop()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    log("loader", json.dumps({"checkpoint": "2 layers at Llama-3.1-8B width, bf16 safetensors",
                              "write_s": write_s, "load_quantize_s": load_s,
                              "completion": text}))
    log("tokenizer", gpu_line(), json.dumps({**tok_files, **tok_stats}))
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: the disaggregated handoff and QoS preemption (KV park and restore)

HANDOFF_BUDGET = 16
# (run, decode kernel, KV pool dtype, prompt lengths): the bf16 pool on the
# ragged kernel, and an fp8 pool on the dedicated kernel; the bf16 run
# also at 1024 tokens, a second point of the restore's cost.
HANDOFF_RUNS = (("handoff_bf16_ragged", "ragged", "", (512, 1024)),
                ("handoff_fp8_dedicated", "dedicated", "fp8", (512,)))


def _sse(port, body, headers=None, timeout=300):
    """[(text, finish_reason, kv offer, seconds since the request, whether
    it is a token's event)] of an SSE completion (the [DONE] line
    excluded). With logprobs on, every token sends an event with its
    logprob; a text-only event is the detokenizer's held-back tail."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.monotonic()
    out = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[len("data: "):])
            if "error" in ev:
                raise AssertionError(f"stream error: {ev['error']}")
            ch = ev["choices"][0]
            out.append((ch.get("text") or "", ch.get("finish_reason"), ev.get("kubeai_kv"),
                        time.monotonic() - t0, bool(ch.get("logprobs"))))
    return out


def _texts(events):
    """The events' texts (the finish chunk dropped)."""
    return [e[0] for e in events if not e[1]]


def _tokens(events) -> int:
    return sum(e[4] for e in events)


def _resume_headers(offer, forwarded, priority=None):
    h = {"X-Resume-Tokens": str(forwarded), "X-KV-Key": offer["key"],
         "X-KV-Source": offer["source"], "X-KV-Tokens": str(offer["tokens"])}
    if priority:
        h["X-Priority"] = priority
    return h


def _kv_import_ok() -> float:
    from kubeai_tpu_torch.metrics import default_registry

    return default_registry.get("kubeai_kv_import_total").value(labels={"outcome": "ok"})


def phase_handoff() -> dict:
    """The resume protocol on Llama-3.1-8B at its published widths (32
    layers, random bf16 weights from seed 0, shared by a prefill-role
    server with --handoff-budget 16 and a decode-role server), once with a
    bf16 pool on the ragged kernel and once with an fp8 pool on the
    dedicated kernel: a 512-token greedy stream of 128 tokens sent with
    X-Handoff-Planned to the prefill server parks 527 tokens at its
    "handoff" finish; the decode server resumes it from the X-KV-* offer,
    fetching the blob over /v1/kv (527 >= the 256-token break-even) and
    importing it. The joined stream must equal the unbroken one byte for
    byte and the decode server's kubeai_kv_import_total{outcome="ok"}
    must rise by one. Timed: the blob's bytes, park, acquire and import
    ms, and the same resume replayed (KUBEAI_KV_RESTORE=0: a 512-token
    prefill and 16 decode steps). In the bf16 run, eight preemptible
    batch streams fill the decode server's slots and an interactive
    request seizes one: the victim ends "preempted" and resumes by unpark,
    byte-identical to its uninterrupted run."""
    import torch

    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    t0 = time.monotonic()
    mc = llama_3_1_8b()
    params = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"handoff: Llama-3.1-8B random bf16 weights in {time.monotonic() - t0:.1f}s")
    out = {}
    for run, dk, kv, lengths in HANDOFF_RUNS:
        out[run] = _handoff_run(run, params, mc, dk, kv, lengths,
                                preempt=(run == HANDOFF_RUNS[0][0]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _handoff_run(run, params, mc, decode_kernel, kv_cache_dtype, lengths, preempt) -> dict:
    import torch

    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    ec = EngineConfig(max_slots=8, max_seq_len=2048, page_size=64, decode_kernel=decode_kernel,
                      kv_cache_dtype=kv_cache_dtype)
    prefill = EngineServer(Engine(mc, params, ByteTokenizer(), ec, device="cuda"), run,
                           host="127.0.0.1", port=0, role="prefill",
                           handoff_budget=HANDOFF_BUDGET)
    decode = EngineServer(Engine(mc, params, ByteTokenizer(), ec, device="cuda"), run,
                          host="127.0.0.1", port=0, role="decode")
    pool = decode.engine.cache["kv"]
    pool_dtype = str(pool.dtype).removeprefix("torch.")
    t_run = time.monotonic()
    prefill.start()
    decode.start()
    try:
        # Capture both engines' decode chunk before anything is timed.
        for srv in (prefill, decode):
            _sse(srv.port, {"prompt": [256, 1, 2, 3], "max_tokens": 4, "temperature": 0,
                            "stream": True})
        _zero_launches()
        by_len = {plen: _handoff_once(prefill, decode, run, plen) for plen in lengths}
        victim = _preempt_and_unpark(decode, run) if preempt else None
        counts = _read_launches()
    finally:
        prefill.stop()
        decode.stop()
    launches, by_pool = counts["launches"], counts["launches_by_pool"]
    want = ["flash_attention",
            "paged_decode_attention" if decode_kernel == "dedicated" else "paged_attention_ragged"]
    missing = [k for k in want if not launches[k]]
    if missing:
        raise AssertionError(f"{run}: kernels never launched: {missing} ({launches})")
    for name, per_pool in by_pool.items():
        if set(per_pool) - {pool_dtype}:
            raise AssertionError(f"{run}: {name} launched on other pools: {per_pool}")
    stats = {**counts, "pool": {"dtype": pool_dtype, "bytes": pool.nbytes},
             "by_prompt_len": by_len, "preempt_victim": victim,
             "phase_s": time.monotonic() - t_run}
    log(f"handoff[{run}]", gpu_line(), json.dumps({k: v for k, v in stats.items()
                                                    if k not in ("launches_by_regime",
                                                                 "flash_launches_by_regime")}))
    del prefill, decode, pool
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _handoff_once(prefill, decode, run, plen) -> dict:
    """One greedy stream of 128 tokens on a *plen*-token prompt: handed off
    after HANDOFF_BUDGET tokens and resumed on the decode server from the
    blob it fetches, against the unbroken stream; then a fresh prompt of
    the same length resumed by replay (KUBEAI_KV_RESTORE=0). Times: park,
    acquire and import, and the first token past the handed-off prefix."""
    import torch

    # EOS (token 257) banned so every stream runs its length; one event a
    # token (logprobs on). Each length's prompts share no page with
    # another's: every leg prefills cold.
    prompt = [256] + [(i * 37 + plen) % 250 + 1 for i in range(plen - 1)]
    body = {"prompt": prompt, "max_tokens": 128, "temperature": 0, "stream": True,
            "logprobs": 0, "logit_bias": {"257": -100}}
    reference = _sse(decode.port, body)
    if _tokens(reference) != 128 or reference[-1][1] != "length":
        raise AssertionError(f"{run}: reference stream malformed: {reference[-1]}")
    leg1 = _sse(prefill.port, body, headers={"X-Handoff-Planned": "1"})
    offer = leg1[-1][2]
    if leg1[-1][1] != "handoff" or not offer:
        raise AssertionError(f"{run}: no handoff offer: {leg1[-1]}")
    # A capped stream holds its text-only tail back: n token events.
    n = len(_texts(leg1))
    if n != _tokens(leg1):
        raise AssertionError(f"{run}: the handoff leg sent a text-only event")
    if n != HANDOFF_BUDGET or offer["tokens"] != plen + HANDOFF_BUDGET - 1 \
            or offer["source"] != prefill.kv_advertise:
        raise AssertionError(f"{run}: offer {offer} after {n} events")
    ok_before = _kv_import_ok()
    resumed = _sse(decode.port, body, headers=_resume_headers(offer, n))
    # The proxy suppresses the first n events of the resume.
    joined = _texts(leg1) + _texts(resumed)[n:]
    if "".join(joined) != "".join(_texts(reference)) or joined != _texts(reference):
        raise AssertionError(f"{run}: the joined stream differs from the unbroken one")
    if _kv_import_ok() != ok_before + 1:
        raise AssertionError(f"{run}: kubeai_kv_import_total{{outcome=ok}} rose by "
                             f"{_kv_import_ok() - ok_before}, not 1")
    park = [e for e in prefill.engine.kv_log if e["event"] == "park"][-1]
    acquire = [e for e in decode.engine.kv_log if e["event"] == "acquire"][-1]
    imp = [e for e in decode.engine.kv_log if e["event"] == "import"][-1]
    if not acquire["fetched"] or imp["how"] != "uploaded" or park["bytes"] != offer["bytes"]:
        raise AssertionError(f"{run}: not a remote fetch and upload: {acquire}, {imp}")
    torch.cuda.synchronize()
    ev0, ev1 = imp["device_events"]
    # The first token past the handed-off prefix: restored, and replayed
    # (a fresh prompt of the same length: no prefix-cache hit).
    os.environ["KUBEAI_KV_RESTORE"] = "0"
    try:
        fresh = [256] + [(i * 53 + plen) % 250 + 1 for i in range(plen - 1)]
        replay = _sse(decode.port, {**body, "prompt": fresh, "max_tokens": n + 1},
                      headers={"X-Resume-Tokens": str(n)})
    finally:
        del os.environ["KUBEAI_KV_RESTORE"]
    return {"blob_bytes": park["bytes"], "parked_tokens": park["tokens"],
            "pages": park["pages"], "park_ms": park["ms"],
            "park_gather_d2h_ms": park["gather_ms"], "park_encode_ms": park["encode_ms"],
            "acquire_ms": acquire["ms"], "import_host_ms": imp["host_ms"],
            "import_device_ms": ev0.elapsed_time(ev1),
            "resume_first_token_s": resumed[n][3], "replay_first_token_s": replay[n][3]}


def _preempt_and_unpark(srv, run) -> dict:
    """Eight preemptible batch streams (short prompts: no prefix-cache hit,
    each prefilled alone) fill the server's slots, first uninterrupted,
    then again with one interactive request arriving once all eight
    decode: one victim ends "preempted" with an offer and resumes on this
    server by unpark, byte-identical to its uninterrupted stream."""
    eng = srv.engine
    prompts = [[256] + list(f"Batch job {i}: summarize the ledger.".encode()) for i in range(8)]
    # 256 tokens (~32 chunks): every stream still decodes when the eighth
    # is admitted.
    batch = {"max_tokens": 256, "temperature": 0, "stream": True, "logprobs": 0,
             "logit_bias": {"257": -100}}
    hdrs = {"X-Priority": "batch", "X-Preemptible": "1"}

    def wave(interactive: bool):
        results: list = [None] * 8
        errors: list = []

        def worker(i):
            try:
                results[i] = _sse(srv.port, {**batch, "prompt": prompts[i]}, headers=hdrs)
            except Exception as e:  # reported below
                errors.append(f"{i}: {e!r}")

        threads = []
        for i in range(8):
            threads.append(threading.Thread(target=worker, args=(i,)))
            threads[-1].start()
            deadline = time.monotonic() + 10
            while eng.active_slots() < i + 1 and not errors and time.monotonic() < deadline:
                time.sleep(0.002)
            if eng.active_slots() != i + 1:
                raise AssertionError(f"{run}: {eng.active_slots()} slots busy after admitting "
                                     f"{i + 1} batch streams ({errors})")
        if interactive:
            inter = _sse(srv.port, {**batch, "prompt": [256] + list(b"Quick question?"),
                                    "max_tokens": 8}, headers={"X-Priority": "interactive"})
            if inter[-1][1] != "length":
                raise AssertionError(f"{run}: interactive request ended {inter[-1][1]}")
        for th in threads:
            th.join(timeout=300)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"{run}: batch streams failed: {errors}")
        return results

    reference = wave(False)
    contended = wave(True)
    victims = [i for i, r in enumerate(contended) if r[-1][1] == "preempted"]
    if len(victims) != 1:
        raise AssertionError(f"{run}: {len(victims)} streams preempted")
    i = victims[0]
    leg, offer = contended[i], contended[i][-1][2]
    n = len(_texts(leg))
    if not offer or _texts(leg) != _texts(reference[i])[:n]:
        raise AssertionError(f"{run}: preempted stream {i} malformed or without an offer")
    ok_before = _kv_import_ok()
    resumed = _sse(srv.port, {**batch, "prompt": prompts[i]},
                   headers=_resume_headers(offer, n, "batch"))
    how = [e for e in eng.kv_log if e["event"] == "import"][-1]["how"]
    if _texts(resumed) != _texts(reference[i]) or _kv_import_ok() != ok_before + 1 \
            or how != "unparked":
        raise AssertionError(f"{run}: the preempted stream did not resume by unpark "
                             f"byte-identically ({how})")
    return {"stream": i, "preempted_after_tokens": n, "parked_tokens": offer["tokens"],
            "blob_bytes": offer["bytes"], "how": how}


# ---------------------------------------------------------------------------


# The embeddings' 8 inputs (tokens): one of each bucket from 32 to 1024.
EMBED_LENGTHS = (16, 40, 100, 200, 300, 500, 700, 1000)
OPS_PROMPTS = ("Tell me a story about a lighthouse keeper.",
               "List the planets of the solar system in order.",
               "Explain how a paged KV cache works, briefly.")


def _http(port, path, body=None, headers=None, timeout=300) -> tuple:
    """(status, headers, parsed body or raw SSE text) of a GET (no body)
    or a POST; HTTP errors are returned, not raised."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read().decode()
            return r.status, dict(r.headers), raw if (body or {}).get("stream") else json.loads(raw)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _embed_checks(srv, run, prompts, direct) -> dict:
    """/v1/embeddings of *prompts* on the idle running engine: unit
    norms, equal to the *direct* result (the engine before start); ms per
    group (8 inputs, one group at bucket 1024, and each input alone, one
    group at its own bucket), embedded tokens/s, the allocator's peak
    across the embed and the W8A16 launches the 8-input embed added."""
    import numpy as np
    import torch

    from kubeai_tpu_torch.ops.quant import qdot

    eng = srv.engine
    st, _, body = _http(srv.port, "/v1/embeddings", {"input": prompts})
    vecs = np.asarray([d["embedding"] for d in body["data"]], np.float32)
    if st != 200 or vecs.shape != (len(prompts), eng.model_config.hidden_size):
        raise AssertionError(f"{run}: /v1/embeddings answered {st}: {vecs.shape}")
    norms = np.linalg.norm(vecs, axis=1)
    if not np.all(np.isfinite(vecs)) or np.abs(norms - 1).max() > 1e-4:
        raise AssertionError(f"{run}: embeddings not of unit norm: {norms}")
    if not np.allclose(vecs, direct, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"{run}: the running engine's embeddings differ from the direct "
                             f"path's by {np.abs(vecs - direct).max()}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches0 = qdot.launches
    t0 = time.monotonic()
    eng.embed(prompts)
    wall = time.monotonic() - t0
    launched = qdot.launches - launches0
    peak = torch.cuda.max_memory_allocated() - base
    per_bucket = {}
    for p in prompts:
        t0 = time.monotonic()
        eng.embed([p])
        per_bucket[eng._bucket(len(p))] = (time.monotonic() - t0) * 1e3
    tokens = sum(len(p) for p in prompts)
    return {"group_ms": wall * 1e3, "tokens": tokens, "tokens_per_s": tokens / wall,
            "group_ms_by_bucket": per_bucket, "single_tokens_per_s": tokens / (
                sum(per_bucket.values()) / 1e3),
            "peak_bytes_over_resident": peak, "w8a16_launches": launched}


def phase_serving_ops() -> dict:
    """The engine's operational surface on Llama-3.1-8B at its published
    widths (32 layers, random weights from seed 0, byte tokenizer, 8
    slots, the ragged decode kernel), bf16 and then the same weights in
    int8: /v1/embeddings of 8 inputs of 16-1,000 tokens (unit norm, equal
    to the engine's direct path before start, idle and under 6 decode
    streams; ms per group, tokens/s, the allocator's peak; in int8 the
    W8A16 launches the embed added: 4 a layer, and the kernel's vectors
    against the plain int8 products'); a 512-token request with
    X-Request-Deadline: 0.2 answers 504 while 3 greedy streams decode,
    which stay token-identical to their undisturbed run and leave no
    page behind; engine.step=delay:0.02 armed over /debug/faults and
    cleared; n = 4 (four distinct seeded choices, four identical greedy
    ones, a seeded single the same twice; equality to the singles
    counted beside the bf16 batch-rounding witness, and required of the
    float32 test:tiny server); /debug/pipeline under load (MFU and
    roofline fraction in (0, 1]); a 2 s /debug/profile naming the decode
    kernel, with the decode step timed before and after it; and the
    drain (/readyz 200 -> 503, the stream in flight completes, new work
    is refused). The bf16 server also runs the telemetry: an OTLP
    exporter to a loopback collector and a history sampler every 0.25 s;
    8 greedy 128-token streams (3 of tenant a, 5 of b, each with a
    traceparent) check /debug/tenants (3 and 5 records, page-seconds over
    slot-seconds = each request's reserved pages, each tenant's
    slot-seconds between its streams' token spans and their whole
    times), /debug/history (TTFT p50, p95 and the token rate with 4
    samples or more; a file flushed at stop) and the collector (all 8
    traces, the two tenant cost series, nothing dropped), with the decode
    step timed with the exporter and sampler running and again after
    both stopped. The launch counts of that round are the kernel line's
    "telemetry" path."""
    import numpy as np
    import torch

    from benchmarks.otlp_stub import StubCollector
    from kubeai_tpu_torch import faults
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.engine.weights import quantize_model_params
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    t_phase = time.monotonic()
    os.environ["KUBEAI_DEBUG_FAULTS"] = "1"
    os.environ["KUBEAI_DEBUG_PROFILE"] = "1"
    mc = llama_3_1_8b()
    params = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    g = np.random.default_rng(0)
    prompts = [[int(t) for t in g.integers(1, 256, n)] for n in EMBED_LENGTHS]
    ec = EngineConfig(max_slots=8, max_seq_len=2048, page_size=64)
    out = {}
    for run in ("bf16", "int8"):
        if run == "int8":
            params = quantize_model_params(params, mc)
        eng = Engine(mc, params, ByteTokenizer(), ec, device="cuda")
        direct = eng.embed(prompts)  # the loop is not running: on this thread
        pre = _int8_embed_parity(eng, prompts, direct) if run == "int8" else \
            {"batch_rounding": _batch_rounding_witness(eng, N4_BODY)}
        srv = EngineServer(eng, f"ops-{run}", host="127.0.0.1", port=0)
        if run == "bf16":
            # The telemetry the bf16 server starts with: an exporter to a
            # loopback collector, a history sampler every 0.25 s.
            collector = StubCollector().start()
            hist_dir = tempfile.mkdtemp(prefix="kubeai-history-")
            telemetry_env = {"KUBEAI_OTLP_ENDPOINT": collector.endpoint,
                             "KUBEAI_HISTORY_DIR": hist_dir, "KUBEAI_HISTORY_INTERVAL": "0.25"}
            os.environ.update(telemetry_env)
        try:
            srv.start()
        finally:
            for k in telemetry_env if run == "bf16" else ():
                os.environ.pop(k, None)
        try:
            # The decode chunk's capture before anything is timed.
            _http(srv.port, "/v1/completions", {"prompt": "warm", "max_tokens": 4})
            res = {"embed": _embed_checks(srv, run, prompts, direct), **pre}
            if run == "int8" and res["embed"]["w8a16_launches"] != 4 * mc.num_layers:
                raise AssertionError(f"int8 embeds launched W8A16 "
                                     f"{res['embed']['w8a16_launches']} times, not 4 a layer")
            if run == "bf16":
                res.update(_ops_under_load(srv, prompts, direct))
                t_tel = time.monotonic()
                res["telemetry"] = _telemetry(srv, collector, hist_dir)
                res["telemetry"]["round_s"] = time.monotonic() - t_tel
            else:
                res.update(_ops_profile_and_drain(srv))
        finally:
            faults.clear_all()
            srv.stop()
            if run == "bf16":
                collector.stop()
        if eng._pool.used():
            raise AssertionError(f"{run}: {eng._pool.used()} pages still used after the run")
        if run == "bf16":
            flushed = [n for n in os.listdir(os.path.join(hist_dir, "engine"))
                       if n.startswith("history-") and n.endswith(".json")]
            if not flushed:
                raise AssertionError(f"no history file flushed under {hist_dir}")
            res["telemetry"]["history_files"] = len(flushed)
            shutil.rmtree(hist_dir, ignore_errors=True)
            tel = res["telemetry"]
            log("serving_ops[telemetry] decode step ms, telemetry on / off:",
                tel["decode_step_telemetry_on"]["wall_ms"],
                tel["decode_step_telemetry_off"]["wall_ms"], gpu_line())
        out[run] = res
        log(f"serving_ops[{run}]", gpu_line(), json.dumps(res))
        del eng, srv
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["tiny_n4"] = _tiny_n4()
    log("serving_ops[tiny_n4]", gpu_line(), json.dumps(out["tiny_n4"]))
    out["phase_s"] = time.monotonic() - t_phase
    return out


def _int8_embed_parity(eng, prompts, direct) -> dict:
    """The int8 embeddings (every projection through the W8A16 kernel, at
    8 x bucket rows) against the same int8 weights through float32 math
    rounded once to bf16 (_float32_w8a16), and that plain path against
    itself summed in a third order (K in halves): the kernel may stand
    no further from the plain path than twice the plain path's own
    spread under reordering (per vector, the L2 norm of the difference
    of unit vectors; 32 random layers carry one bf16 rounding's
    difference to ~1e-2 at the output)."""
    import numpy as np

    from kubeai_tpu_torch.ops.quant import qdot, qdot_many

    t0 = time.monotonic()
    launches = qdot.launches, qdot_many.launches
    with _float32_w8a16():
        plain = eng.embed(prompts)
    with _float32_w8a16(halves=True):
        halves = eng.embed(prompts)
    if (qdot.launches, qdot_many.launches) != launches:
        raise AssertionError("the plain int8 embed launched the W8A16 kernel")
    kern = float(np.linalg.norm(direct - plain, axis=1).max())
    spread = float(np.linalg.norm(halves - plain, axis=1).max())
    if not np.all(np.isfinite(plain)) or kern > 2 * spread:
        raise AssertionError(f"int8 embeddings: kernel vs plain {kern}, plain vs plain in "
                             f"halves {spread}")
    return {"int8_embed_vs_plain": {"kernel_l2_max": kern, "plain_halves_l2_max": spread,
                                    "seconds": time.monotonic() - t0}}


N4_BODY = {"prompt": "Once upon a time", "max_tokens": 16, "temperature": 0.8, "seed": 5,
           "logit_bias": {"257": -100}}


def _batch_rounding_witness(eng, body) -> dict:
    """The n = 4 check's first sampled token, outside the engine: the
    prompt's last logits from one row and from row 0 of four identical
    rows (the prefill of 4 choices: the same bf16 projections at 4x the
    rows), then sample()'s token for the body's seed + i, i < 4. The
    sampling noise is keyed by candidate rank among the top 128, so two
    candidates that trade places take each other's noise. Reports
    max|dlogit|, the ranks whose token changed, and how many of the 4
    sampled tokens and whether the greedy one changed."""
    import torch

    from kubeai_tpu_torch.engine.sampling import sample
    from kubeai_tpu_torch.models import llama

    ids = eng.tokenizer.encode(body["prompt"])
    S = eng._bucket(len(ids))
    row = torch.zeros((1, S), dtype=torch.int64, device="cuda")
    row[0, :len(ids)] = torch.tensor(ids, device="cuda")
    got = {}
    for B in (1, 4):
        pos = torch.arange(S, device="cuda")[None, :].expand(B, S)
        with torch.no_grad():
            logits, _ = llama.apply(eng.params, eng.model_config, row.expand(B, S), pos,
                                    logits_idx=torch.full((B,), len(ids) - 1, device="cuda"))
        lg = logits[:1, -1].float()
        top = float(lg.abs().max()) if B == 1 else top
        for t, b in body["logit_bias"].items():
            lg[:, int(t)] += b
        toks = sample(lg.expand(4, -1), body["seed"] + torch.arange(4, device="cuda"),
                      torch.full((4,), len(ids), device="cuda"),
                      torch.full((4,), body["temperature"], device="cuda"),
                      torch.ones(4, device="cuda"), torch.zeros(4, dtype=torch.int64,
                                                                device="cuda"))
        got[B] = (lg[0], torch.topk(lg[0], 128).indices, toks, int(lg[0].argmax()))
    (l1, r1, s1, g1), (l4, r4, s4, g4) = got[1], got[4]
    return {"max_abs_dlogit": float((l1 - l4).abs().max()),
            "max_abs_logit": top,
            "top128_ranks_changed": int((r1 != r4).sum()),
            "sampled_tokens_changed": int((s1 != s4).sum()), "greedy_token_changed": g1 != g4}


def _tiny_n4() -> dict:
    """n = 4 on the float32 test configuration served on the card
    (--model test:tiny): choice i equals a single request with seed + i,
    as it does on the CPU, and the greedy choices equal a greedy single."""
    import torch

    from kubeai_tpu_torch.engine.server import (
        EngineServer,
        build_engine_from_args,
        make_arg_parser,
    )

    t0 = time.monotonic()
    args = make_arg_parser().parse_args([
        "--model", "test:tiny", "--host", "127.0.0.1", "--port", "0", "--max-slots", "4",
        "--max-seq-len", "512"])
    eng, name = build_engine_from_args(args)
    srv = EngineServer(eng, name, host=args.host, port=args.port)
    srv.start()
    try:
        body = {**N4_BODY, "max_tokens": 32}
        _, _, multi = _http(srv.port, "/v1/completions", {**body, "n": 4})
        singles = [_http(srv.port, "/v1/completions", {**body, "seed": body["seed"] + i})[2]
                   ["choices"][0]["text"] for i in range(4)]
        seeded = [c["text"] for c in multi["choices"]]
        greedy = {**body, "temperature": 0}
        _, _, gmulti = _http(srv.port, "/v1/completions", {**greedy, "n": 4})
        gsingle = _http(srv.port, "/v1/completions", greedy)[2]["choices"][0]["text"]
    finally:
        srv.stop()
    gtexts = [c["text"] for c in gmulti["choices"]]
    if seeded != singles or len(set(seeded)) != 4 or gtexts != [gsingle] * 4:
        raise AssertionError(f"test:tiny n = 4: seeded {seeded} singles {singles}; "
                             f"greedy {gtexts} single {gsingle!r}")
    del eng, srv
    gc.collect()
    torch.cuda.empty_cache()
    return {"seeded_equal_to_singles": 4, "greedy_equal_to_single": True,
            "seconds": time.monotonic() - t0}


def _ops_under_load(srv, prompts, direct) -> dict:
    """The bf16 run's checks with streams decoding (see phase_serving_ops)."""
    import numpy as np

    eng = srv.engine
    res = {}
    # Embeddings under 6 decode streams: equal to the direct path.
    streams = _start_staggered(eng, [OPS_PROMPTS[i % 3] + f" ({i})" for i in range(6)],
                               [None] * 6, n=256)
    st, _, body = _http(srv.port, "/v1/embeddings", {"input": prompts})
    loaded = np.asarray([d["embedding"] for d in body["data"]], np.float32)
    # The X-ray under the same load: MFU and the roofline fraction.
    time.sleep(0.5)
    _, _, pipe = _http(srv.port, "/debug/pipeline")
    _collect(streams)
    if st != 200 or not np.allclose(loaded, direct, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"embeddings under load differ: {st}")
    if not (0 < pipe["mfu"] <= 1 and 0 < pipe["roofline_fraction"] <= 1):
        raise AssertionError(f"/debug/pipeline under load: {pipe}")
    res["pipeline"] = {k: pipe[k] for k in ("mfu", "roofline_fraction", "tokens_per_second",
                                            "dominant_cause", "coverage") if k in pipe}
    res["pipeline"]["causes"] = {k: v["fraction"] for k, v in pipe["causes"].items()}
    # Deadline: 3 streams undisturbed, then again beside a 512-token
    # request whose 0.2 s budget ends in a 504.
    three = list(OPS_PROMPTS)
    ref_ids, _ = _collect(_start_staggered(eng, three, [None] * 3, n=192))
    streams = _start_staggered(eng, three, [None] * 3, n=192)
    t0 = time.monotonic()
    st, _, body = _http(srv.port, "/v1/completions",
                        {"prompt": [int(t) for t in np.random.default_rng(1).integers(1, 256, 512)],
                         "max_tokens": 1000, "temperature": 0},
                        headers={"X-Request-Deadline": "0.2"})
    t_504 = time.monotonic() - t0
    freed = _await_cond(lambda: eng.requests_in_system() == 3, 30)
    used = eng._pool.used()
    held = sum(len(eng._slot_pages[i]) for i, s in enumerate(eng._slots) if s is not None)
    ids, _ = _collect(streams)
    if st != 504 or body["error"]["type"] != "timeout_error":
        raise AssertionError(f"deadline request answered {st}: {body}")
    if not freed or used != held or ids != ref_ids:
        raise AssertionError(f"deadline abort disturbed the others: freed={freed} used={used} "
                             f"held={held} same_tokens={ids == ref_ids}")
    res["deadline"] = {"status": st, "seconds_to_504": t_504, "pool_used_beside": used,
                       "pages_of_the_others": held, "others_identical": True}
    # A failpoint over /debug/faults: armed, fired, cleared; serving resumes.
    t0 = time.monotonic()
    _http(srv.port, "/v1/completions", {"prompt": "ping", "max_tokens": 16, "temperature": 0})
    clean_s = time.monotonic() - t0
    st, _, doc = _http(srv.port, "/debug/faults?set=engine.step=delay:0.02")
    t0 = time.monotonic()
    _http(srv.port, "/v1/completions", {"prompt": "ping", "max_tokens": 16, "temperature": 0})
    slowed_s = time.monotonic() - t0
    fired = [f for f in _http(srv.port, "/debug/faults")[2]["faults"]
             if f["name"] == "engine.step"]
    st2, _, cleared = _http(srv.port, "/debug/faults?clear=all")
    after = _http(srv.port, "/v1/completions", {"prompt": "ping", "max_tokens": 16,
                                                "temperature": 0})
    if st != 200 or not fired or fired[0]["fired"] < 1 or cleared["faults"] or after[0] != 200:
        raise AssertionError(f"failpoint over /debug/faults: {st} {fired} {cleared} {after[0]}")
    res["failpoint"] = {"fired": fired[0]["fired"], "request_s_clean": clean_s,
                        "request_s_delayed": slowed_s}
    # n = 4: four seeded choices (seed + i: distinct streams), four
    # identical greedy ones. Choice i equals a single request with
    # seed + i on the CPU (tests/test_torch_containment.py) and on the
    # card in float32 (_tiny_n4); here the 4 choices' prefill runs the
    # bf16 projections at 4x the rows, so equality to the singles, and a
    # greedy single's to the greedy choices, is only counted, beside the
    # witness of that rounding (_batch_rounding_witness).
    body = {**N4_BODY, "logprobs": 1}
    _, _, multi = _http(srv.port, "/v1/completions", {**body, "n": 4})
    single_choices = [_http(srv.port, "/v1/completions", {**body, "seed": 5 + i})[2]["choices"][0]
                      for i in range(4)]
    singles = [c["text"] for c in single_choices]
    again = _http(srv.port, "/v1/completions", body)[2]["choices"][0]["text"]
    seeded = [c["text"] for c in multi["choices"]]
    # The first position: the token each got, and its logprob (the
    # prefill's logits, batched or alone).
    firsts = [(c["logprobs"]["tokens"][0], c["logprobs"]["token_logprobs"][0])
              for c in multi["choices"]]
    single_firsts = [(c["logprobs"]["tokens"][0], c["logprobs"]["token_logprobs"][0])
                     for c in single_choices]
    same_first = [abs(a[1] - b[1]) for a, b in zip(firsts, single_firsts) if a[0] == b[0]]
    _, _, greedy = _http(srv.port, "/v1/completions", {**body, "temperature": 0, "n": 4})
    gtexts = [c["text"] for c in greedy["choices"]]
    gsingle_choice = _http(srv.port, "/v1/completions", {**body, "temperature": 0})[2]["choices"][0]
    gsingle = gsingle_choice["text"]
    if ([c["index"] for c in multi["choices"]] != [0, 1, 2, 3] or len(set(seeded)) != 4
            or multi["usage"]["completion_tokens"] != 64 or len(set(gtexts)) != 1
            or greedy["usage"]["completion_tokens"] != 64 or again != singles[0]):
        raise AssertionError(f"n = 4: seeded {seeded}; greedy {gtexts}; a single twice "
                             f"{[singles[0], again]}")
    res["n4"] = {"seeded_distinct": len(set(seeded)), "greedy_identical": True,
                 "single_repeated_identical": True,
                 "seeded_equal_to_singles": sum(a == b for a, b in zip(seeded, singles)),
                 "first_token_equal_to_singles": len(same_first),
                 "first_logprob_max_abs_diff": max(same_first, default=None),
                 "greedy_equal_to_single": gtexts[0] == gsingle,
                 "greedy_first_logprob_abs_diff": abs(
                     greedy["choices"][0]["logprobs"]["token_logprobs"][0]
                     - gsingle_choice["logprobs"]["token_logprobs"][0])}
    return res


def _await_cond(cond, timeout) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _decode_step_ms(srv, n=64) -> dict:
    """One greedy *n*-token stream alone: the median, over its graphed
    chunks in chunk_log, of the wall (dispatch to fetch) and the device
    time per decode step."""
    t0 = time.monotonic()
    _stream(srv.port, {"prompt": "step timing", "max_tokens": n, "temperature": 0})
    return _step_from_log(srv, t0, 1)


def _step_from_log(srv, t0, slots) -> dict:
    """The median wall (dispatch to fetch) and device time per decode
    step over the graphed chunks fetched since *t0* that ran *slots*
    slots."""
    import numpy as np

    log_ = [e for e in list(srv.engine.chunk_log)
            if e["fetched_at"] > t0 and e["graph"] and e["slots"] == slots]
    if not log_:
        raise AssertionError(f"no graphed chunk of {slots} slots in chunk_log")
    dev = [e["device_ms"] / e["steps"] for e in log_ if e["device_ms"] is not None]
    return {"chunks": len(log_),
            "wall_ms": float(np.median([e["dur_ms"] / e["steps"] for e in log_])),
            "device_ms": float(np.median(dev)) if dev else None}


# The telemetry round: 3 streams of tenant a and 5 of tenant b on one
# prompt long enough for a flash prefill (bucket 256).
TELEMETRY_TENANTS = ("a",) * 3 + ("b",) * 5
TELEMETRY_PROMPT = OPS_PROMPTS[0] * 5
TELEMETRY_TOKENS = 128


def _tenant_round(srv, tag: int) -> list:
    """TELEMETRY_TENANTS' greedy streams, all started at once, each with
    its tenant header and a traceparent of its own: per stream (tenant,
    trace id, submit, first token, last token, end), monotonic seconds."""
    from kubeai_tpu_torch.obs.tenants import TENANT_HEADER

    out: list = [None] * len(TELEMETRY_TENANTS)
    errors: list = []

    def run(i, tenant):
        trace_id = f"{tag:04x}{i:04x}" + "7" * 24
        try:
            t0 = time.monotonic()
            _, reason, times = _stream(
                srv.port, {"prompt": TELEMETRY_PROMPT, "max_tokens": TELEMETRY_TOKENS,
                           "temperature": 0},
                headers={TENANT_HEADER: tenant, "traceparent": f"00-{trace_id}-{'ab' * 8}-01"})
            if reason != "length" or len(times) != TELEMETRY_TOKENS:
                raise AssertionError(f"stream {i}: {reason} after {len(times)} tokens")
            out[i] = (tenant, trace_id, t0, t0 + times[0], t0 + times[-1], time.monotonic())
        except Exception as e:  # reported below
            errors.append(f"{i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i, t)) for i, t in enumerate(TELEMETRY_TENANTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors or any(o is None for o in out):
        raise AssertionError(f"telemetry streams failed: {errors}")
    return out


def _telemetry(srv, collector, hist_dir) -> dict:
    """The bf16 run's telemetry checks (see phase_serving_ops): the
    server started with the exporter pointed at *collector* and the
    history sampler ticking every 0.25 s into *hist_dir*."""
    from kubeai_tpu_torch.obs.otel import M_DROPPED, installed_exporter, uninstall_exporter
    from kubeai_tpu_torch.obs.tenants import default_accountant

    eng = srv.engine
    exp = installed_exporter()
    if exp is None or srv._history_sampler is None:
        raise AssertionError("the server started no exporter or no history sampler")
    # Each record: the request's tenant and prompt, its seconds, and the
    # pages its slot held at release.
    default_accountant.reset()
    recs, pending = [], []
    record_cost, record_slot = default_accountant.record_cost, eng._record_slot_cost

    def spy_cost(tenant, slot_s, page_s):
        pending.append((slot_s, page_s))
        record_cost(tenant, slot_s, page_s)

    def spy_slot(slot, slot_idx):
        n, pages = len(pending), len(eng._slot_pages[slot_idx])
        record_slot(slot, slot_idx)
        recs.extend((slot.req.tenant, len(slot.req.prompt_ids), s, p, pages)
                    for s, p in pending[n:])

    default_accountant.record_cost, eng._record_slot_cost = spy_cost, spy_slot
    try:
        _zero_launches()
        t0 = time.monotonic()
        streams = _tenant_round(srv, 1)
        launches = _read_launches()
        step_on = _step_from_log(srv, t0, len(TELEMETRY_TENANTS))
        weights = {t: default_accountant._tracked[t].weight for t in ("a", "b")}
        _, _, rep = _http(srv.port, "/debug/tenants")
    finally:
        del default_accountant.record_cost, eng._record_slot_cost
    missing = [k for k in ("flash_attention", "paged_attention_ragged")
               if not launches["launches"][k]]
    if missing:
        raise AssertionError(f"telemetry round: kernels never launched: {missing}")
    # /debug/tenants: 3 and 5 records; each request's page-seconds over
    # slot-seconds is its reservation; each tenant's slot-seconds within
    # its streams' token spans and their whole times.
    ps = eng.cfg.page_size
    bad = [r for r in recs if r[4] != math.ceil((r[1] + TELEMETRY_TOKENS) / ps)
           or not r[2] > 0 or abs(r[3] / r[2] - r[4]) > 1e-9 * r[4]]
    rows = {row["tenant"]: row for row in rep["tenants"]}
    if weights != {"a": 3, "b": 5} or len(recs) != 8 or bad or set(rows) != {"a", "b"}:
        raise AssertionError(f"/debug/tenants: weights {weights}, {len(recs)} records, "
                             f"reservations off: {bad}, rows {sorted(rows)}")
    tenants = {}
    for t in ("a", "b"):
        slot_s = sum(r[2] for r in recs if r[0] == t)
        page_s = sum(r[3] for r in recs if r[0] == t)
        lo = sum(s[4] - s[3] for s in streams if s[0] == t)
        hi = sum(s[5] - s[2] for s in streams if s[0] == t)
        if not lo <= slot_s <= hi or rows[t]["cost"] != {
                "slot_seconds": round(slot_s, 4), "kv_page_seconds": round(page_s, 4)}:
            raise AssertionError(f"tenant {t}: slot-seconds {slot_s} outside [{lo}, {hi}] or "
                                 f"the report's {rows[t]['cost']}")
        tenants[t] = {"slot_seconds": slot_s, "kv_page_seconds": page_s,
                      "token_span_s": lo, "request_s": hi}
    # /debug/history: the sampler's TTFT quantiles and token rate.
    ttft = "kubeai_engine_ttft_seconds"
    names = (f"{ttft}_p50", f"{ttft}_p95", "kubeai_engine_generated_tokens_total")
    _, _, hist = _http(srv.port, f"/debug/history?series={','.join(names)}&since=600")
    samples = {n: sum(p[1] for p in hist["series"].get(n, {}).get("points", [])) for n in names}
    if min(samples.values()) < 4:
        raise AssertionError(f"/debug/history samples: {samples}")
    # The collector: every stream's spans, the tenant series, no drops.
    want = {s[1] for s in streams}

    def traces():
        return {span["traceId"] for span in collector.spans()}

    _await_cond(lambda: want <= traces(), 15)
    exp.export_metrics()
    names_got = collector.metric_names()
    dropped = sum(M_DROPPED.snapshot().values())
    tenant_series = {"kubeai_tenant_slot_seconds_total", "kubeai_tenant_kv_page_seconds_total"}
    if not want <= traces() or not tenant_series <= names_got or dropped:
        raise AssertionError(f"collector: {len(want - traces())} traces missing, "
                             f"tenant series {sorted(tenant_series & names_got)}, "
                             f"dropped {dropped}")
    # The same round with the sampler and the exporter stopped.
    srv._history_sampler.stop()
    srv._history_sampler = None
    exp.stop()
    uninstall_exporter(exp)
    srv._otel = None
    t0 = time.monotonic()
    _tenant_round(srv, 2)
    step_off = _step_from_log(srv, t0, len(TELEMETRY_TENANTS))
    return {"launches": launches, "tenants": tenants, "history_samples": samples,
            "traces": len(want), "exported": exp.report()["exported"],
            "decode_step_telemetry_on": step_on, "decode_step_telemetry_off": step_off,
            "on_over_off": step_on["wall_ms"] / step_off["wall_ms"]}


def _ops_profile_and_drain(srv) -> dict:
    """The int8 run's end (see phase_serving_ops): a torch.profiler
    session slows a process's later launches, so it comes last, then the
    drain, which stops the server."""
    from kubeai_tpu_torch.obs.perf import default_profiler

    res = {"decode_step_before_profile": _decode_step_ms(srv)}
    # The window opens on an idle engine; a 32-token stream then decodes
    # inside it (4 chunks: a trace of a few tens of MB, where 2 s of
    # decode write ~285 MB and take ~20 s to export).
    got = {}
    prof = threading.Thread(target=lambda: got.setdefault(
        "p", _http(srv.port, "/debug/profile?seconds=2")), daemon=True)
    t0 = time.monotonic()
    prof.start()
    _await_cond(default_profiler._lock.locked, 10)
    time.sleep(0.5)
    _stream(srv.port, {"prompt": "profile me", "max_tokens": 32})
    prof.join(timeout=120)
    wall = time.monotonic() - t0
    st, _, doc = got["p"]
    with open(doc["trace"], "rb") as f:
        trace = f.read()
    if st != 200 or doc["activities"] != ["cpu", "cuda"] or b"paged_decode_mma_kernel" not in trace:
        raise AssertionError(f"/debug/profile: {st} {doc}")
    res["profile"] = {"wall_s": wall, "trace_bytes": len(trace),
                      "decode_kernel_events": trace.count(b"paged_decode_mma_kernel")}
    shutil.rmtree(doc["trace_dir"], ignore_errors=True)
    # What the capture costs the process's later decode (reported).
    res["decode_step_after_profile"] = _decode_step_ms(srv)
    # The drain: /readyz 200 -> 503, the stream in flight completes, new
    # work is refused with the JAX server's 429.
    ready = _http(srv.port, "/readyz")[0]
    got = {}
    stream = threading.Thread(target=lambda: got.setdefault("r", _stream(
        srv.port, {"prompt": "drain me", "max_tokens": 64})), daemon=True)
    stream.start()
    _await_cond(lambda: srv.engine.active_slots() == 1, 30)
    t0 = time.monotonic()
    drain = threading.Thread(target=srv.drain, args=(60.0,), daemon=True)
    drain.start()
    _await_cond(srv.draining.is_set, 10)
    draining = _http(srv.port, "/readyz")[0]
    refused = _http(srv.port, "/v1/completions", {"prompt": "late", "max_tokens": 4})
    stream.join(timeout=120)
    drain.join(timeout=120)
    text, reason, times = got.get("r", ("", None, []))
    if (ready, draining, refused[0]) != (200, 503, 429) or reason != "length" \
            or len(times) != 64 or drain.is_alive() or not srv.stopped_event.is_set():
        raise AssertionError(f"drain: readyz {ready}->{draining}, new work {refused[0]}, "
                             f"stream {reason} after {len(times)} tokens")
    res["drain"] = {"readyz": [ready, draining], "new_request": refused[0],
                    "inflight_tokens": len(times), "drain_s": time.monotonic() - t0}
    return res


# ---------------------------------------------------------------------------
# Phase 7: cold start and the parked replica

COLDSTART_LAYERS = 4
COLDSTART_ARGS = ["--max-slots", "8", "--max-seq-len", "2048", "--page-size", "64"]
COLDSTART_PHASES = ("stage", "load", "compile", "build", "warmup", "ready")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _await_ready(port, timeout, proc=None) -> float:
    """Seconds until /readyz answers 200 (polled every 50 ms); raises at
    *timeout*, or when *proc* exits first."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"engine process exited with {proc.returncode}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=2) as r:
                if r.status == 200:
                    return time.monotonic() - t0
        except (urllib.error.URLError, OSError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"/readyz on :{port} not 200 within {timeout} s")


def _metric_counts(port, name) -> dict:
    """{phase: observation count} of histogram *name* on /metrics."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    return {m[0]: float(m[1]) for m in re.findall(
        rf'^{name}_count{{phase="([^"]+)"}} (\S+)$', text, re.M)}


def _greedy_batch(eng, prompts, n=32) -> list:
    """[(ids, top-2 gaps)] of *prompts*, greedy, submitted together to the
    engine's queue (they decode together)."""
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    reqs = [eng.submit(eng.tokenizer.encode(p), SamplingParams(
        temperature=0.0, max_tokens=n, logprobs=True, logit_bias=((257, -100.0),)))
        for p in prompts]
    out = []
    for req in reqs:
        ids, gaps = [], []
        while True:
            ev = req.out.get(timeout=300)
            if ev[0] == "token" and ev[1] >= 0:
                ids.append(ev[1])
                gaps.append(ev[4][0][1] - ev[4][1][1])
            elif ev[0] == "done":
                break
            elif ev[0] == "error":
                raise AssertionError(f"request failed: {ev[1]}")
        out.append((ids, gaps))
    return out


def _write_width_checkpoint(path: str) -> float:
    """Seconds to write an HF checkpoint of Llama-3.1-8B's widths at
    COLDSTART_LAYERS layers (bf16 weights drawn from seed 3 on the card,
    no tokenizer: the byte tokenizer serves it) to *path*."""
    import torch

    from kubeai_tpu_torch.engine.weights import hf_state_dict, save_hf_checkpoint
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(num_layers=COLDSTART_LAYERS)
    t0 = time.monotonic()
    p = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(3), device="cuda")
    shutil.rmtree(path, ignore_errors=True)
    save_hf_checkpoint(path, mc, hf_state_dict(p, mc))
    del p
    torch.cuda.empty_cache()
    return time.monotonic() - t0


def _spawn_cold() -> dict:
    """(a) A fresh engine process over a checkpoint at Llama-3.1-8B width
    with an empty library directory: spawn -> /readyz 200, and its start
    timeline from /debug/engine and /metrics."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "build", f"ckpt_8b_width_{COLDSTART_LAYERS}_layers")
    libs = os.path.join(root, "build", "coldstart_libraries")
    write_s = _write_width_checkpoint(path)
    shutil.rmtree(libs, ignore_errors=True)
    os.makedirs(libs)
    port = _free_port()
    env = {**os.environ, "KUBEAI_COMPILE_CACHE": libs, "KUBEAI_COLDSTART_OVERLAP": "1",
           "PYTHONPATH": root}
    log_path = os.path.join(root, "build", "coldstart_spawn.log")
    t0 = time.monotonic()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeai_tpu_torch.engine.server", "--model", path,
             "--host", "127.0.0.1", "--port", str(port), "--warmup"] + COLDSTART_ARGS,
            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=root)
    try:
        try:
            ready_s = _await_ready(port, 240, proc)
        except AssertionError:
            with open(log_path) as f:
                log(f.read()[-4000:])
            raise
        snap = _http(port, "/debug/engine")[2]["cold_start"]
        counts = _metric_counts(port, "kubeai_engine_cold_start_seconds")
        _check_completion(_post(port, "/v1/completions", {
            "prompt": "Hello", "max_tokens": 8, "temperature": 0}), "cold spawn")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        shutil.rmtree(path, ignore_errors=True)
        shutil.rmtree(libs, ignore_errors=True)
    ph = snap["phases"]
    warm = snap["attrs"]["warm_compile"]
    if not ph["compile"]["start_s"] < ph["load"]["end_s"]:
        raise AssertionError(f"cold spawn: compile did not start before load ended: {ph}")
    if warm.get("missing") or sorted(warm["built"]) != sorted(warm["libraries"]):
        raise AssertionError(f"cold spawn: not every library was built into the empty "
                             f"directory: {warm}")
    if any(counts.get(name, 0) < 1 for name in COLDSTART_PHASES):
        raise AssertionError(f"cold spawn: /metrics lacks a phase: {counts}")
    return {"checkpoint": f"{COLDSTART_LAYERS} layers at Llama-3.1-8B width, bf16",
            "write_s": write_s, "spawn_to_ready_s": ready_s,
            "phases": {k: v.get("duration_s") for k, v in ph.items()},
            "starts": {k: v["start_s"] for k, v in ph.items()},
            "phase_sum_s": snap["phase_sum_s"], "span_s": snap["span_s"],
            "overlap_s": snap["overlap_s"], "ready_s": snap["ready_s"],
            "built": warm["built"], "preloaded": warm["preloaded"],
            "warm_seconds": warm["seconds"], "warmup": _shapes(snap["attrs"]["warmup"]),
            "capture_segments": snap["attrs"]["capture_segments"], "metric_counts": counts}


def _shapes(warmup: dict) -> dict:
    """A warmup's result without its list of shape names."""
    return {k: v for k, v in warmup.items() if k != "names"}


def _parked_attach() -> tuple[dict, dict]:
    """(b) An in-process parked server warmed for preset:llama-3.1-8b,
    then attached with the same args: park warm, attach -> ready, the
    adoption, the captures; 8 greedy requests against an engine built
    directly. Returns (the run's numbers, its launch counts)."""
    import torch

    from kubeai_tpu_torch.engine.server import (
        EngineServer,
        build_engine_from_args,
        make_arg_parser,
    )
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    args = ["--model", "preset:llama-3.1-8b"] + COLDSTART_ARGS
    srv = EngineServer(None, "(parked)", host="127.0.0.1", port=0)
    srv.start()
    try:
        t0 = time.monotonic()
        srv.start_park_warm("preset:llama-3.1-8b", COLDSTART_ARGS)
        park = srv.park_warm.join()
        park_s = time.monotonic() - t0
        if "error" in park or srv.park_engine is None:
            raise AssertionError(f"park warm failed: {park}")
        code, _, body = _http(srv.port, "/readyz")
        if code != 503 or body != {"status": "parked", "attach": "parked"}:
            raise AssertionError(f"parked /readyz: {code} {body}")
        t0 = time.monotonic()
        code, _, body = _http(srv.port, "/v1/attach", {"args": args})
        if code != 202:
            raise AssertionError(f"/v1/attach: {code} {body}")
        attach_s = _await_ready(srv.port, 120)
        eng = srv.engine
        tl = eng.cold_start_timeline.snapshot()
        if not tl["attrs"].get("adopted_park_engine"):
            raise AssertionError(f"the park engine was not adopted: {tl}")
        prompts = [f"Request number {i}: tell a story about the sea." for i in range(8)]
        _zero_launches()
        got = _greedy_batch(eng, prompts)
        mid = ("The quick brown fox jumps over the lazy dog. " * 7)[:300]
        _check_completion(_post(srv.port, "/v1/completions", {
            "prompt": mid, "max_tokens": 8, "temperature": 0}), "parked 300-byte")
        launches = _read_launches()
        _check_graphed(eng, "parked")
        # Captures since the park's (the attach and its traffic): none.
        recaptured = {k: v for k, v in eng.graph_capture_seconds.items()
                      if park["capture_s"].get(k) != v}
        if recaptured:
            raise AssertionError(f"the attached engine captured again: {recaptured}")
        park_tl = srv.park_timeline.snapshot()
        counts = _metric_counts(srv.port, "kubeai_engine_cold_start_seconds")
        if any(counts.get(p, 0) < 1 for p in ("load", "build", "ready")):
            raise AssertionError(f"parked /metrics lacks a phase: {counts}")
    finally:
        srv.stop()
    del eng, srv
    gc.collect()
    torch.cuda.empty_cache()
    if not (launches["launches"]["flash_attention"] and
            launches["launches"]["paged_attention_ragged"]):
        raise AssertionError(f"parked: flash and ragged must launch: {launches}")
    direct, _ = build_engine_from_args(make_arg_parser().parse_args(args))
    direct.start()
    try:
        want = _greedy_batch(direct, prompts)
        diverged = []
        for i, ((ids, _), (ref, gaps)) in enumerate(zip(got, want)):
            j = next((k for k, (a, b) in enumerate(zip(ids, ref)) if a != b), None)
            if j is None:
                if len(ids) != len(ref):
                    raise AssertionError(f"parked: request {i} has {len(ids)} tokens, "
                                         f"not {len(ref)}")
                continue
            ulp = _logit_ulp(direct.params, llama_3_1_8b(),
                             direct.tokenizer.encode(prompts[i]) + ref[:j])
            diverged.append({"request": i, "at": j, "gap": gaps[j], "ulp": ulp})
            if gaps[j] > 2 * ulp:
                raise AssertionError(f"parked: request {i}'s greedy token {j} differs from "
                                     f"the direct engine's at a top-2 gap of {gaps[j]} > 2 ulps")
    finally:
        direct.stop()
    del direct
    gc.collect()
    torch.cuda.empty_cache()
    res = {"park_warm_s": park_s,
           "park_phases": {k: v.get("duration_s") for k, v in park_tl["phases"].items()},
           "park_libraries": park["libraries"], "park_preloaded": park["preloaded"],
           "park_zero_params_s": park["zero_params_s"], "park_warmup": _shapes(park["warmup"]),
           "capture_s_at_park": park["capture_s"],
           "capture_segments_at_park": park["capture_segments"],
           "attach_to_ready_s": attach_s, "adopted_park_engine": True,
           "capture_s_at_attach": recaptured,
           "attach_phases": {k: v.get("duration_s") for k, v in tl["phases"].items()},
           "tokens_equal": not diverged, "diverged_at_near_ties": diverged,
           "metric_counts": counts}
    return res, launches


def phase_coldstart() -> dict:
    """Cold start on Llama-3.1-8B's widths: (a) a cold spawn of the
    server over a 4-layer checkpoint into an empty library directory
    (KUBEAI_COMPILE_CACHE) with the background warm overlapped
    (KUBEAI_COLDSTART_OVERLAP=1) and --warmup: spawn -> /readyz 200, each
    phase, overlap_s and the libraries built; compile must start before
    load ends, and /metrics must carry every phase; (b) a parked server
    warmed for preset:llama-3.1-8b (the libraries, then a zero-weight
    engine whose decode graph is captured), attached with the same
    args: park warm and attach -> ready seconds, the adoption, capture
    seconds at park and at attach (none), 8 greedy requests equal to an
    engine built directly from the same args and seed (up to near-ties
    within 2 bf16 ulps) and a 300-byte request, with the launch counts of
    that run (path "parked"); flash and ragged must launch there."""
    t0 = time.monotonic()
    spawn = _spawn_cold()
    log("coldstart[spawn]", gpu_line(), json.dumps(spawn))
    parked, launches = _parked_attach()
    log("coldstart[parked]", gpu_line(), json.dumps(parked))
    log(f"coldstart phase: {time.monotonic() - t0:.1f}s (budget 120 s)")
    return {"parked": launches}


# ---------------------------------------------------------------------------
# Phase 8: LoRA fine-tuning and the training step

FINETUNE_ROWS = 64
FINETUNE_SEQ = 256
FINETUNE_BATCH = 4
FINETUNE_ARGS = ["--rank", "16", "--targets", "q_proj,v_proj", "--batch-size",
                 str(FINETUNE_BATCH), "--seq-len", str(FINETUNE_SEQ), "--checkpoint-every", "10"]
FINETUNE_WORDS = ("the", "river", "keeper", "lamp", "north", "stone", "quiet", "harbor",
                  "winter", "signal", "carries", "across", "bright", "a", "of", "and")


def _finetune_data(path: str, seed: int = 0) -> None:
    """FINETUNE_ROWS JSONL text rows of seeded word sequences, each longer
    than FINETUNE_SEQ bytes (the byte tokenizer's tokens), so every
    position of a batch carries loss."""
    import random

    rng = random.Random(seed)
    with open(path, "w") as f:
        for _ in range(FINETUNE_ROWS):
            words = []
            while sum(len(w) + 1 for w in words) < FINETUNE_SEQ + 64:
                words.append(rng.choice(FINETUNE_WORDS))
            f.write(json.dumps({"text": " ".join(words) + "."}) + "\n")


def _train_flops(mc, tokens: int) -> float:
    """Operations of one LoRA step over the frozen weights: the forward's
    product with every projection and the head (2 per weight and token),
    and as much again for the input gradients (no weight gradients)."""
    D, Fi, L = mc.hidden_size, mc.intermediate_size, mc.num_layers
    H, Kv, h = mc.num_heads, mc.num_kv_heads, mc.head_dim_
    weights = L * (D * (H + 2 * Kv) * h + H * h * D + 3 * D * Fi) + D * mc.vocab_size
    return 2 * (2.0 * weights * tokens)


def _step_numbers(stats, mc) -> dict:
    """Median step (steps 2 on), tokens a second and the bound of a step
    of FINETUNE_BATCH x FINETUNE_SEQ tokens."""
    import statistics

    tokens = FINETUNE_BATCH * FINETUNE_SEQ
    med = statistics.median(stats["step_s"][1:])
    return {"step_ms": med * 1e3, "step_ms_all": [t * 1e3 for t in stats["step_s"]],
            "tokens_per_s": tokens / med,
            "bound_ms": _train_flops(mc, tokens) / PEAK_FLOPS["bf16"] * 1e3,
            "bound_by": "operations", "first_loss": stats["losses"][0],
            "last_loss": stats["losses"][-1]}


def _adapter_tensors(path: str) -> dict:
    from kubeai_tpu_torch.engine.weights import read_safetensors_header, read_safetensors_tensor

    f = os.path.join(path, "adapter_model.safetensors")
    header, start = read_safetensors_header(f)
    return {k: read_safetensors_tensor(f, e, start) for k, e in header.items()}


def _finetune_cli(ckpt, data, work) -> tuple[dict, str]:
    """(a) main() over the 4-layer checkpoint: 30 steps with a checkpoint
    every 10, then 20 steps and a resume to 30, whose adapter must equal
    the uninterrupted run's."""
    import numpy as np
    import torch

    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.train import finetune

    rows = finetune.load_dataset(data, ByteTokenizer(), FINETUNE_SEQ)
    batch = finetune.make_batch(rows, FINETUNE_BATCH, FINETUNE_SEQ, np.random.default_rng(0))
    covered = float(batch["mask"].mean())
    if covered < 0.9:
        raise AssertionError(f"finetune: {covered:.3f} of a batch's positions carry loss (< 0.9)")
    out, part = os.path.join(work, "adapter"), os.path.join(work, "resumed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    stats = {}
    t0 = time.monotonic()
    first, last = finetune.main(["--model", ckpt, "--data", data, "--output", out, "--steps", "30"]
                                + FINETUNE_ARGS, stats=stats)
    run_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - resident
    if not last < first:
        raise AssertionError(f"finetune: the loss did not drop ({first} -> {last})")
    res = {"layers": COLDSTART_LAYERS, "rows": len(rows), "loss_positions": covered,
           **_step_numbers(stats, llama_3_1_8b(num_layers=COLDSTART_LAYERS)),
           "peak_bytes": peak, "resident_bytes": resident, "save_s": stats["save_s"], "adapter_s": stats["adapter_s"],
           "main_s": run_s}
    finetune.main(["--model", ckpt, "--data", data, "--output", part, "--steps", "20"]
                  + FINETUNE_ARGS)
    finetune.main(["--model", ckpt, "--data", data, "--output", part, "--steps", "30", "--resume"]
                  + FINETUNE_ARGS)
    ref, got = _adapter_tensors(out), _adapter_tensors(part)
    if set(ref) != set(got):
        raise AssertionError("finetune: the resumed adapter has other tensors")
    err = max((got[k] - ref[k]).abs().max().item() for k in ref)
    scale = max(ref[k].abs().max().item() for k in ref)
    res["resume"] = {"bitwise": all(torch.equal(got[k], ref[k]) for k in ref),
                     "max_abs_err": err, "max_abs": scale}
    if err > 1e-5 * scale:
        raise AssertionError(f"finetune: the resumed adapter differs by {err} (max {scale})")
    return res, out


def _finetune_full_depth(data) -> dict:
    """(b) The fine-tune's loop over preset:llama-3.1-8b's seeded weights
    (32 layers, bf16), a float32 rank-16 bank on q and v, 10 steps."""
    import torch

    from kubeai_tpu_torch.engine.core import preset_params
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.train import finetune

    mc = llama_3_1_8b()
    params_bytes = -torch.cuda.memory_allocated()
    params = preset_params(mc, torch.device("cuda"), seed=0)
    params_bytes += torch.cuda.memory_allocated()
    bank = finetune.init_bank(mc, 16, 16.0, ("wq", "wv"), seed=0, device="cuda")
    rows = finetune.load_dataset(data, ByteTokenizer(), FINETUNE_SEQ)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - params_bytes
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    finetune.train_lora(params, mc, bank, rows, ("wq", "wv"), 10, FINETUNE_BATCH, FINETUNE_SEQ,
                        1e-3, stats=stats)
    res = {"layers": mc.num_layers, **_step_numbers(stats, mc),
           "peak_bytes": torch.cuda.max_memory_allocated() - resident,
           "weights_bytes": params_bytes, "resident_bytes": resident}
    del params, bank
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _finetune_serves(ckpt, adapter) -> tuple[dict, dict]:
    """(c) (a)'s adapter loaded into a port engine over the same
    checkpoint (EngineServer.load_adapter): a greedy completion on it must
    differ from the base model's. Returns (the texts, the launch counts
    of the run, path "finetune")."""
    import torch

    from kubeai_tpu_torch.engine.core import EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.weights import load_engine_from_path

    eng = load_engine_from_path(ckpt, EngineConfig(
        max_slots=4, max_seq_len=512, prefill_buckets=(32, 64, 128, 256), max_adapters=1,
        max_lora_rank=16))
    srv = EngineServer(eng, "base", host="127.0.0.1", port=0)
    srv.start()
    try:
        _zero_launches()
        body = {"prompt": "the river keeper carries a lamp across the", "max_tokens": 24,
                "temperature": 0, "logit_bias": NO_EOS}
        base = _post(srv.port, "/v1/completions", {**body, "model": "base"})
        ok, msg = srv.load_adapter("tuned", adapter)
        if not ok:
            raise AssertionError(f"finetune: the adapter did not load: {msg}")
        tuned = _post(srv.port, "/v1/completions", {**body, "model": "tuned"})
        launches = _read_launches()
    finally:
        srv.stop()
    del eng, srv
    gc.collect()
    torch.cuda.empty_cache()
    texts = {"base": base["choices"][0]["text"], "tuned": tuned["choices"][0]["text"]}
    if texts["base"] == texts["tuned"]:
        raise AssertionError(f"finetune: the trained adapter left greedy output unchanged: {texts}")
    if not launches["launches"]["paged_attention_ragged"]:
        raise AssertionError(f"finetune: the ragged kernel never launched: {launches}")
    return texts, launches


def _card_vs_cpu() -> dict:
    """(d) One trainer.train_step and one LoRA step on a float32 tiny
    config, on the card and on the CPU from the same weights and batch:
    the loss within 1e-5 relative, every parameter after the step within
    1e-5 (TF32 off)."""
    import numpy as np
    import torch

    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import ModelConfig
    from kubeai_tpu_torch.train import finetune, trainer

    mc = ModelConfig(vocab_size=300, hidden_size=64, intermediate_size=128, num_layers=2,
                     num_heads=4, num_kv_heads=2, dtype="float32")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 259, (4, 32)).astype(np.int32)
    host = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
            "mask": (rng.random((4, 32)) < 0.9).astype(np.int32)}
    base = llama.init_params(mc, torch.Generator().manual_seed(0))
    rows = [(list(map(int, rng.integers(0, 259, 40))), [1] * 40) for _ in range(8)]
    def copy(dev):  # a copy on each device: a step updates its weights in place
        return {k: ({n: w.to(dev, copy=True) for n, w in v.items()} if isinstance(v, dict)
                    else v.to(dev, copy=True)) for k, v in base.items()}

    out = {}
    for dev in ("cuda", "cpu"):
        params = copy(dev)
        for t in trainer.leaves(params):
            t.requires_grad_(True)
        opt = trainer.make_optimizer(params, 1e-4)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        loss = trainer.train_step(params, opt, batch, mc).item()
        frozen = copy(dev)
        bank = finetune.init_bank(mc, 8, 16.0, ("wq", "wv"), seed=1, device=dev)
        bank["wq_B"][:, 1] = 0.01  # a nonzero B: A takes a gradient in the first step
        stats = {}
        finetune.train_lora(frozen, mc, bank, rows, ("wq", "wv"), 1, 4, 32, 1e-4, stats=stats)
        out[dev] = (loss, [t.detach().cpu() for t in trainer.leaves(params)],
                    stats["losses"][0], [bank[k].cpu() for k in ("wq_A", "wq_B", "wv_A", "wv_B")])
    res = {}
    for i, what in ((0, "train_step"), (2, "lora_step")):
        (lg, pg), (lc, pc) = out["cuda"][i:i + 2], out["cpu"][i:i + 2]
        perr = max((a - b).abs().max().item() for a, b in zip(pg, pc))
        res[what] = {"loss_card": lg, "loss_cpu": lc, "loss_rel_err": abs(lg - lc) / abs(lc),
                     "param_max_abs_err": perr}
        if abs(lg - lc) > 1e-5 * abs(lc) or perr > 1e-5:
            raise AssertionError(f"finetune: {what} on the card differs from the CPU: "
                                 f"{res[what]}")
    return res


def phase_finetune() -> dict:
    """LoRA fine-tuning on Llama-3.1-8B's widths (budget 90 s): (a) the
    CLI's main() over a 4-layer checkpoint written as phase_coldstart's
    (64 seeded JSONL rows filling --seq-len 256, rank 16 on q and v,
    batch 4, 30 steps, a checkpoint every 10): the loss must drop; the
    median step, tokens a second, peak memory, checkpoint and adapter
    seconds; then 20 steps and a resume to 30, equal to the uninterrupted
    adapter; (b) the same loop at 32 layers over preset:llama-3.1-8b's
    seeded weights, 10 steps; (c) (a)'s adapter served by a port engine
    over the checkpoint, its greedy text unlike the base model's (launch
    counts under path "finetune"; ragged must launch); (d) a trainer step
    and a LoRA step on the card against the CPU."""
    t0 = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "finetune")
    ckpt = os.path.join(work, f"ckpt_8b_width_{COLDSTART_LAYERS}_layers")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        write_s = _write_width_checkpoint(ckpt)
        data = os.path.join(work, "train.jsonl")
        _finetune_data(data)
        cli, adapter = _finetune_cli(ckpt, data, work)
        cli["checkpoint_write_s"] = write_s
        log("finetune[cli]", gpu_line(), json.dumps(cli))
        full = _finetune_full_depth(data)
        log("finetune[32 layers]", gpu_line(), json.dumps(full))
        texts, launches = _finetune_serves(ckpt, adapter)
        log("finetune[serve]", gpu_line(), json.dumps(texts))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("finetune[card vs cpu]", gpu_line(), json.dumps(_card_vs_cpu()))
    log(f"finetune phase: {time.monotonic() - t0:.1f}s (budget 90 s)")
    return {"finetune": launches}


# name -> (source, TPU kernel it replaces, wrapper, the serving path it
# belongs to: the default ragged-decode path, --decode-kernel dedicated,
# --quantization int8, --kv-cache-dtype fp8 (ragged), --kv-cache-dtype
# int8 with int8 weights and the dedicated kernel, test:tiny, or
# --speculate-tokens 7 on either decode kernel; the pool dtype whose
# launches a paged kernel's entry counts; optionally the ragged kernel's
# tile whose launches it counts instead). A "[... pool]" entry is its
# kernel's one-byte-pool instances, with phase 2's numbers for that pool;
# a "[verify]" entry the verify shapes, with phase 2's verify cases.
SOURCES = {
    "flash_attention": ("kubeai_tpu_torch/csrc/flash_attention.cu",
                        "kubeai_tpu/ops/flash_attention.py:27", "flash_attention", "ragged",
                        None),
    "paged_attention": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                        "kubeai_tpu/ops/paged_attention.py:55", "paged_attention_ragged",
                        "ragged", "bfloat16"),
    "paged_decode_attention": ("kubeai_tpu_torch/csrc/paged_decode_attention.cu",
                               "kubeai_tpu/ops/paged_decode_attention.py:66",
                               "paged_decode_attention", "dedicated", "bfloat16"),
    "w8a16_matmul": ("kubeai_tpu_torch/csrc/w8a16_matmul.cu", "kubeai_tpu/ops/quant.py:50",
                     "qdot", "int8", None),
    "paged_attention[fp8 pool]": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                                  "kubeai_tpu/ops/paged_attention.py:31",
                                  "paged_attention_ragged", "fp8_pool", "float8_e4m3fn"),
    "paged_attention[int8 pool]": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                                   "kubeai_tpu/ops/paged_attention.py:31",
                                   "paged_attention_ragged", "int8_pool", "int8"),
    "paged_decode_attention[int8 pool]": ("kubeai_tpu_torch/csrc/paged_decode_attention.cu",
                                          "kubeai_tpu/ops/paged_decode_attention.py:111",
                                          "paged_decode_attention", "int8_pool", "int8"),
    "w8a16_matmul[grouped]": ("kubeai_tpu_torch/csrc/w8a16_matmul.cu",
                              "kubeai_tpu/ops/quant.py:50", "qdot_many", "int8", None),
    "w8a16_matmul[float32]": ("kubeai_tpu_torch/csrc/w8a16_matmul.cu",
                              "kubeai_tpu/ops/quant.py:50", "qdot", "tiny_int8_fp8", None),
    "paged_attention[fp8 pool h32]": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                                      "kubeai_tpu/ops/paged_attention.py:31",
                                      "paged_attention_ragged", "tiny_int8_fp8",
                                      "float8_e4m3fn"),
    # Speculative verify steps (--speculate-tokens 7: 8 queries a slot, 32
    # rows per KV head): the ragged kernel's split-KV tile (its launches
    # of that tile in the run) and the dedicated kernel.
    "paged_attention[verify]": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                                "kubeai_tpu/ops/paged_attention.py:55", "paged_attention_ragged",
                                "spec_ragged", "bfloat16", "split_kv"),
    "paged_decode_attention[verify]": ("kubeai_tpu_torch/csrc/paged_decode_attention.cu",
                                       "kubeai_tpu/ops/paged_decode_attention.py:66",
                                       "paged_decode_attention", "spec_dedicated", "bfloat16"),
    # The other families (FAMILY_RUNS): head dim 256 (Gemma-2B, the _d256
    # libraries) and Qwen2.5-7B's G = 7 on the tensor-core tiles, and
    # W8A16 at Qwen's shapes.
    "flash_attention[h256]": ("kubeai_tpu_torch/csrc/flash_attention.cu",
                              "kubeai_tpu/ops/flash_attention.py:27", "flash_attention",
                              "gemma_bf16", None, "tensor_core"),
    "paged_attention[h256]": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                              "kubeai_tpu/ops/paged_attention.py:55", "paged_attention_ragged",
                              "gemma_bf16", "bfloat16"),
    "paged_attention[h256 fp8 pool]": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                                       "kubeai_tpu/ops/paged_attention.py:31",
                                       "paged_attention_ragged", "gemma_fp8", "float8_e4m3fn"),
    "paged_decode_attention[h256 fp8 pool]": ("kubeai_tpu_torch/csrc/paged_decode_attention.cu",
                                              "kubeai_tpu/ops/paged_decode_attention.py:111",
                                              "paged_decode_attention", "gemma_fp8",
                                              "float8_e4m3fn"),
    "flash_attention[G7]": ("kubeai_tpu_torch/csrc/flash_attention.cu",
                            "kubeai_tpu/ops/flash_attention.py:27", "flash_attention",
                            "qwen_bf16", None, "tensor_core"),
    "paged_attention[G7]": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                            "kubeai_tpu/ops/paged_attention.py:55", "paged_attention_ragged",
                            "qwen_bf16", "bfloat16", "split_kv"),
    "paged_attention[G7 prefill tile]": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                                         "kubeai_tpu/ops/paged_attention.py:55",
                                         "paged_attention_ragged", "qwen_bf16", "bfloat16",
                                         "prefill_tile"),
    "paged_decode_attention[G7]": ("kubeai_tpu_torch/csrc/paged_decode_attention.cu",
                                   "kubeai_tpu/ops/paged_decode_attention.py:66",
                                   "paged_decode_attention", "qwen_int8", "bfloat16"),
    "w8a16_matmul[families]": ("kubeai_tpu_torch/csrc/w8a16_matmul.cu",
                               "kubeai_tpu/ops/quant.py:50", "qdot", "qwen_int8", None),
}



# ---------------------------------------------------------------------------
# Phase 9: tensor parallelism and the gang (tp = 2 on the one card)

GANG_TP = 2
GANG_MAX_TOKENS = 16
GANG_BUDGET_S = 90.0
# bf16 unit roundoff.
BF16_U = 2.0**-8


def _gang_prompts(n=8, length=220) -> list:
    """*n* prompts of *length* seeded lowercase bytes (distinct from the
    first page, so no prefix is shared: every prompt takes the cold
    bucket-256 prefill, the flash kernel's path)."""
    import random

    rng = random.Random(15)
    return ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(length))
            for _ in range(n)]


def _tp2_cases(record) -> None:
    """The kernels at a tp = 2 rank's shapes of Llama-3.1-8B (H 16, Kv 4
    per rank, G 4; the W8A16 column-parallel N and row-parallel K
    halved), each held against its plain version."""
    import torch

    from kubeai_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention
    from kubeai_tpu_torch.ops.quant import dequantize, qdot, qdot_many, qdot_plain

    H, Kv, h = 32 // GANG_TP, 8 // GANG_TP, 128
    for S in (256, 1024):
        g = torch.Generator(device="cuda").manual_seed(S + 2)
        q = torch.randn((1, S, H, h), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, S, Kv, h), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, S, Kv, h), generator=g, device="cuda").to(torch.bfloat16)
        got = flash_attention(q, k, v, causal=True)
        err = compare(got, flash_attention_plain(q.float(), k.float(), v.float(), causal=True),
                      f"flash_attention tp2 S={S}")
        ms = timed_ms(lambda: flash_attention(q, k, v, causal=True))
        plain_ms = timed_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters=5)
        lib_ms = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True))
        record("flash_attention", f"tp2 B=1 S={S} H={H} Kv={Kv} causal", err, ms, plain_ms,
               2 * (2 * S * H * h + 2 * S * Kv * h), 4.0 * h * H * S * (S + 1) / 2, lib_ms,
               False, False)
    for case, B, S, lens_list in (("tp2 decode B=8 kv_len=512", 8, 1, [512] * 8),
                                  ("tp2 decode B=8 kv_len=2048", 8, 1, [2048] * 8),
                                  ("tp2 prefill chunk B=1 S=256 start=256", 1, 256, [512])):
        cold = "decode" in case
        q, pool, table, lens = _paged_case(B, S, lens_list, H=H, Kv=Kv)
        want = paged_attention_plain(q.float(), pool.float(), table, lens)
        nbytes, flops = _paged_cost(B, S, lens_list, H, Kv, h)
        lib_ms = timed_ms(lambda: _sdpa_paged(q, pool, table, lens), iters=5, cold_l2=cold)
        plain_ms = timed_ms(lambda: paged_attention_plain(q, pool, table, lens), iters=5,
                            cold_l2=cold)
        kernels = [("paged_attention", paged_attention_ragged)]
        if S == 1:
            kernels.append(("paged_decode_attention", paged_decode_attention))
        for name, fn in kernels:
            got = fn(q, pool, table, lens)
            err = compare(got, want, f"{name} {case}")
            ms = timed_ms(lambda: fn(q, pool, table, lens), cold_l2=cold)
            record(name, f"{case} H={H} Kv={Kv}", err, ms, plain_ms, nbytes, flops, lib_ms,
                   False, cold)
        del q, pool, table, lens, want
    # W8A16 at a rank's projections: single launches and the two groups.
    shards = [(name, K, N // GANG_TP) for name, K, N in W8A16_SHAPES if name != "wd"]
    shards += [("wv", 4096, 1024 // GANG_TP), ("wo", 4096 // GANG_TP, 4096),
               ("wd", 14336 // GANG_TP, 4096)]
    groups = [("qkv", [(n, 4096, N // GANG_TP) for n, _, N in W8A16_GROUPS[0][1]]),
              ("gate_up", [(n, 4096, N // GANG_TP) for n, _, N in W8A16_GROUPS[1][1]])]
    for M in (8, 256):
        cold = M <= 64
        for name, K, N in shards:
            g = torch.Generator(device="cuda").manual_seed(K + N + M)
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            w = _w8a16_weight(g, K, N, 0)
            got = qdot(x, w)
            err = compare(got, _w8a16_want(x, w, 0), f"w8a16 tp2 {name} M={M}")
            ms = timed_ms(lambda: qdot(x, w), cold_l2=cold)
            plain_ms = timed_ms(lambda: qdot_plain(x, w["int8_q"], w["int8_s"]), iters=5,
                                cold_l2=cold)
            wb = dequantize(w, torch.bfloat16)
            lib_ms = timed_ms(lambda: torch.matmul(x, wb), cold_l2=cold)
            record("w8a16_matmul", f"tp2 {name} M={M} K={K} N={N}", err, ms, plain_ms,
                   K * N + 4 * N + 2 * (M * K + M * N), 2.0 * M * N * K, lib_ms, False, cold)
            del x, w, wb, got
        for gname, shapes in groups:
            g = torch.Generator(device="cuda").manual_seed(M + 7)
            x = torch.randn((M, 4096), generator=g, device="cuda").to(torch.bfloat16)
            ws = [_w8a16_weight(g, K, N, 0) for _, K, N in shapes]
            got = qdot_many(x, ws)
            err = 0.0
            for (wname, _, _), y, w in zip(shapes, got, ws):
                if not torch.equal(y, qdot(x, w)):
                    raise AssertionError(f"w8a16 tp2 {gname} M={M}: {wname} differs from "
                                         "its own launch")
                err = max(err, compare(y, _w8a16_want(x, w, 0), f"w8a16 tp2 {gname} {wname}"))
            ms = timed_ms(lambda: qdot_many(x, ws), cold_l2=cold)
            plain_ms = timed_ms(lambda: [qdot_plain(x, w["int8_q"], w["int8_s"]) for w in ws],
                                iters=5, cold_l2=cold)
            wbs = [dequantize(w, torch.bfloat16) for w in ws]
            lib_ms = timed_ms(lambda: [torch.matmul(x, wb) for wb in wbs], cold_l2=cold)
            nbytes = sum(K * N + 4 * N + 2 * M * N for _, K, N in shapes) + 2 * M * 4096
            record("w8a16_matmul", f"tp2 {gname} M={M} K=4096 N="
                   + "+".join(str(N) for _, _, N in shapes), err, ms, plain_ms, nbytes,
                   sum(2.0 * M * N * K for _, K, N in shapes), lib_ms, False, cold)
            del x, ws, wbs, got
    torch.cuda.empty_cache()


def _nccl_graph_check() -> dict:
    """(d) A one-rank NCCL group's all-reduce and all-gather captured in
    a CUDA graph and replayed on new inputs equal the eager collectives
    on the same inputs: the mechanism a multi-card gang's graphed decode
    chunk relies on."""
    import torch
    import torch.distributed as dist

    from kubeai_tpu_torch.parallel.group import make_process_group

    pg = make_process_group(dist.HashStore(), 0, 1, "nccl", timeout=60)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.empty((8, 4096), dtype=torch.bfloat16, device="cuda")
    red = torch.empty_like(x)
    gat = torch.empty((x.numel(),), dtype=x.dtype, device="cuda")

    def body():
        red.copy_(x)
        pg.allreduce([red]).wait()
        pg._allgather_base(gat, x.reshape(-1)).wait()

    x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
    body()  # eager: the communicator is made here, outside the capture
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        body()
    torch.cuda.synchronize()
    replays = 3
    for i in range(replays):
        x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        got_r, got_g = red.clone(), gat.clone()
        body()
        torch.cuda.synchronize()
        if not (torch.equal(got_r, red) and torch.equal(got_g, gat)
                and torch.equal(red, x) and torch.equal(gat, x.reshape(-1))):
            raise AssertionError(f"nccl capture: replay {i} differs from the eager collectives")
    graph.reset()
    if hasattr(pg, "shutdown"):  # the communicator's resources, before exit
        pg.shutdown()
    return {"replays": replays, "equal": True}


def _gang_float32() -> dict:
    """(b) A float32 config at Llama-3.1-8B width, 2 layers: a tp = 2
    gang in this process (two threads on the card over gloo, rank 0
    publishing over the gang's TCP wire to rank 1) against a tp = 1
    engine on the same seeded weights: greedy tokens identical."""
    import torch

    from kubeai_tpu_torch.engine.core import Engine, EngineConfig, preset_params
    from kubeai_tpu_torch.engine.gang import GangFollower, GangPublisher
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.parallel.group import run_local_ranks

    mc = llama_3_1_8b(num_layers=2).replace(dtype="float32")
    ec = EngineConfig(max_slots=4, max_seq_len=512)
    prompts = _gang_prompts(4, 120)
    t0 = time.monotonic()
    ref_eng = Engine(mc, preset_params(mc, torch.device("cuda"), seed=5), ByteTokenizer(), ec,
                     device="cuda")
    ref_eng.start()
    try:
        want = _greedy_batch(ref_eng, prompts, n=GANG_MAX_TOKENS)
    finally:
        ref_eng.stop()
    del ref_eng
    torch.cuda.empty_cache()
    secret = "chip-smoke-gang"
    pub = GangPublisher(GANG_TP - 1, port=0, host="127.0.0.1", secret=secret)

    def rank(group):
        params = preset_params(mc, group.device, seed=5, tp_group=group)
        if group.rank == 0:
            eng = Engine(mc, params, ByteTokenizer(), ec, device=group.device,
                         tp_group=group, publisher=pub)
            pub.accept_all(timeout=120)
            eng.start()
            try:
                return _greedy_batch(eng, prompts, n=GANG_MAX_TOKENS)
            finally:
                eng.stop()
        eng = Engine(mc, params, ByteTokenizer(), ec, device=group.device, tp_group=group)
        eng.run_follower(GangFollower("127.0.0.1", pub.port, secret=secret, rank=group.rank))
        return dict(eng.follower_ops)

    got, ops = run_local_ranks(GANG_TP, rank, "cuda:0", backend="gloo", timeout=300)
    torch.cuda.empty_cache()
    for i, ((g_ids, _), (w_ids, _)) in enumerate(zip(got, want)):
        if g_ids != w_ids:
            raise AssertionError(f"gang float32: prompt {i} greedy tokens differ from tp = 1: "
                                 f"{g_ids} vs {w_ids}")
    return {"prompts": len(prompts), "tokens": GANG_MAX_TOKENS, "identical": True,
            "follower_ops": ops, "seconds": time.monotonic() - t0}


def _gang_reference(prompts) -> list:
    """The tp = 1 reference over preset:llama-3.1-8b's seed-0 weights: an
    eager engine's first greedy token (EOS banned) and its top-5
    logprobs for each prompt, the prompts submitted together as the
    server gets them, and the prefill logits' max |logit| over the byte
    tokenizer's vocab (the tolerance's scale, from llama.apply)."""
    import torch

    from kubeai_tpu_torch.engine.core import Engine, EngineConfig, preset_config, preset_params
    from kubeai_tpu_torch.engine.sampling import SamplingParams
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models import llama

    tok = ByteTokenizer()
    mc = preset_config("llama-3.1-8b")
    params = preset_params(mc, torch.device("cuda"), seed=0)
    eng = Engine(mc, params, tok, EngineConfig(), device="cuda", cuda_graphs=False)
    eng.start()
    try:
        reqs = [eng.submit(tok.encode(p), SamplingParams(
            temperature=0.0, max_tokens=1, logprobs=True, logit_bias=((257, -100.0),)))
            for p in prompts]
        firsts = []
        for req in reqs:
            while True:
                ev = req.out.get(timeout=300)
                if ev[0] == "token" and ev[1] >= 0:
                    firsts.append((ev[1], sorted((lp for _, lp in ev[4]), reverse=True)[:5]))
                elif ev[0] == "done":
                    break
                elif ev[0] == "error":
                    raise AssertionError(f"gang reference: {ev[1]}")
    finally:
        eng.stop()
    out = []
    with torch.no_grad():
        for p, (first, top5) in zip(prompts, firsts):
            ids = torch.tensor([tok.encode(p)], device="cuda")
            pos = torch.arange(ids.shape[1], device="cuda")[None, :]
            logits, _ = llama.apply(params, mc, ids, pos, logits_idx=torch.tensor(
                [ids.shape[1] - 1], device="cuda"))
            lg = logits[0, -1, :tok.vocab_size].float()
            out.append((first, top5, float(lg.abs().max()), top5[0] - top5[1]))
    del eng, params
    torch.cuda.empty_cache()
    return out


def _gang_server() -> dict:
    """(a) and (c): ``python -m kubeai_tpu_torch.engine.server --model
    preset:llama-3.1-8b --tensor-parallel-size 2`` (both ranks on the one
    card over gloo, eager chunks), started with the gang.follower
    failpoint armed once: rank 1's first recv fails, it reconnects, and
    the first request after that re-forms the gang
    (kubeai_gang_reforms_total 1). Then 8 greedy requests over HTTP,
    their first tokens and top-5 logprobs against tp = 1."""
    import socket

    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    root = os.path.dirname(os.path.abspath(__file__))
    while True:  # rank 1 answers on the port after rank 0's
        port = _free_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            break
        except OSError:
            continue
    env = {**os.environ, "PYTHONPATH": root, "KUBEAI_FAILPOINTS": "gang.follower=error:1",
           "KUBEAI_GANG_REFORM_TIMEOUT": "60"}
    cmd = [sys.executable, "-m", "kubeai_tpu_torch.engine.server", "--model",
           "preset:llama-3.1-8b", "--tensor-parallel-size", str(GANG_TP), "--host",
           "127.0.0.1", "--port", str(port)]
    log_path = os.path.join(root, "build", "gang_server.log")
    prompts = _gang_prompts()
    t0 = time.monotonic()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=env, cwd=root)
    try:
        ref = _gang_reference(prompts)  # while the ranks load
        try:
            ready_s = _await_ready(port, 240, proc)
        except AssertionError:
            with open(log_path) as f:
                log(f.read()[-4000:])
            raise
        # (c) rank 1's reconnect is accepted only once rank 0 dropped its
        # old connection, so rank 0 owes the gang a reset: the next
        # request fails and re-forms the gang.
        deadline = time.monotonic() + 60
        while _http(port + 1, "/debug/gang")[2].get("reconnects", 0) < 1:
            if time.monotonic() > deadline:
                raise AssertionError("gang: rank 1 never reconnected after its failpoint")
            time.sleep(0.05)
        _await_ready(port, 60, proc)
        probe = _http(port, "/v1/completions", {"prompt": "re-form", "max_tokens": 2})
        _await_ready(port, 60, proc)
        reforms = _http(port, "/debug/engine")[2]["gang"]["reforms"]
        if reforms != 1:
            raise AssertionError(f"gang: kubeai_gang_reforms_total {reforms}, expected 1 "
                                 f"(probe answered {probe[0]} {probe[2]})")
        # (a) 8 greedy requests at once.
        results: list = [None] * len(prompts)

        def one(i):
            results[i] = _http(port, "/v1/completions", {
                "prompt": prompts[i], "max_tokens": GANG_MAX_TOKENS, "temperature": 0,
                "logprobs": 5, "logit_bias": {"257": -100}})

        t_req = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        requests_s = time.monotonic() - t_req
        r0 = _http(port, "/debug/engine?limit=200")[2]
        r1 = _http(port + 1, "/debug/gang")[2]
        metrics = {}
        for rank, p in ((0, port), (1, port + 1)):
            with urllib.request.urlopen(f"http://127.0.0.1:{p}/metrics", timeout=30) as r:
                text = r.read().decode()
            metrics[rank] = {m[0]: float(m[1]) for m in re.findall(
                r"^kubeai_engine_param_bytes_(global|local) (\S+)$", text, re.M)}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    L = 32
    tok = ByteTokenizer()
    tol_terms = []
    first_equal = 0
    for i, (status, _, body) in enumerate(results):
        if status != 200:
            raise AssertionError(f"gang: request {i} answered {status}: {body}")
        _check_completion(body, f"gang request {i}")
        lp = body["choices"][0]["logprobs"]
        want_tok, want_top5, max_logit, gap = ref[i]
        # One extra bf16 rounding of a partial sum per row-parallel layer
        # (wo, wd: 2L of them), each <= u (|S1| + |S2|) <= 2u |S|; as a
        # random walk over 2L steps, the hidden state moves by
        # 2 sqrt(2L) u of its size, and a logit by that share of the
        # largest |logit|; a logprob by twice that (the logit and the
        # log-sum-exp).
        tol = 4.0 * math.sqrt(2 * L) * BF16_U * max_logit
        got_top5 = sorted(lp["top_logprobs"][0].values(), reverse=True)
        top_err = max(abs(a - b) for a, b in zip(got_top5, want_top5))
        same = lp["tokens"][0] == tok.decode([want_tok])
        first_equal += same
        if top_err > tol:
            raise AssertionError(f"gang: prompt {i} top-5 logprobs differ by {top_err} > {tol}")
        if not same and gap > tol:
            raise AssertionError(f"gang: prompt {i} first token differs from tp = 1 with a "
                                 f"top-2 gap of {gap} > {tol}")
        tol_terms.append({"top5_err": top_err, "tol": tol, "first_equal": same, "gap": gap})
    for rank, m in metrics.items():
        share = m["local"] / m["global"]
        if not 0.45 <= share <= 0.55:
            raise AssertionError(f"gang: rank {rank} holds {share:.3f} of the parameter bytes")
    g0 = r0["gang"]
    steps = [s for s in r0["steps"] if s.get("kind") == "decode_chunk"]
    step_wall = [s["dur_ms"] / s["steps"] for s in steps]
    step_dev = [s["device_ms"] / s["steps"] for s in steps if s.get("device_ms")]
    step_coll = [s.get("collective_ms", 0.0) / s["steps"] for s in steps]
    launches = {}
    for rank, rep in ((0, g0), (1, r1)):
        launches[rank] = {k: v for k, v in rep["launches"].items()
                          if k in ("flash_attention.launches", "paged_attention_ragged.launches",
                                   "qdot.launches", "qdot_many.launches")}
        if not (launches[rank]["flash_attention.launches"]
                and launches[rank]["paged_attention_ragged.launches"]):
            raise AssertionError(f"gang: rank {rank} did not launch flash and ragged: "
                                 f"{launches[rank]}")
    def med(xs):
        return sorted(xs)[len(xs) // 2] if xs else None

    run = {
        "launches": {"flash_attention": g0["launches"]["flash_attention.launches"],
                     "paged_attention_ragged": g0["launches"]["paged_attention_ragged.launches"],
                     "paged_decode_attention": g0["launches"]["paged_decode_attention.launches"],
                     "qdot": g0["launches"]["qdot.launches"],
                     "qdot_many": g0["launches"]["qdot_many.launches"]},
        "launches_by_pool": {
            "paged_attention_ragged": g0["launches"]["paged_attention_ragged.launches_by_pool"],
            "paged_decode_attention": g0["launches"]["paged_decode_attention.launches_by_pool"]},
        "launches_by_regime": g0["launches"]["paged_attention_ragged.launches_by_regime"],
        "flash_launches_by_regime": g0["launches"]["flash_attention.launches_by_regime"],
        "launches_by_rank": launches,
        "backend": g0["group"]["backend"], "host_staged": g0["group"]["host_staged"],
        "cuda_graphs": g0["cuda_graphs"],
        "spawn_to_ready_s": ready_s, "requests": len(prompts), "requests_s": requests_s,
        "param_bytes": metrics, "reforms": reforms, "probe_status": probe[0],
        "first_tokens_equal": first_equal, "logprob_checks": tol_terms,
        "decode_step_wall_ms": med(step_wall), "decode_step_device_ms": med(step_dev),
        "decode_step_collective_ms": med(step_coll),
        "collective_share": (med(step_coll) / med(step_wall)) if step_wall else None,
        "collectives_rank0": g0["group"]["collectives"],
        "collectives_rank1": r1["group"]["collectives"], "follower_ops": r1["ops"],
        "server_s": time.monotonic() - t0,
    }
    return run


SHARDED_BUDGET_S = 120.0


def start_sharded_train() -> dict:
    """Start phase 10's child process (kubeai_tpu_torch/tools/
    sharded_check.py; see the module docstring), its output in temporary
    files; phase_sharded_train waits for it."""
    root = os.path.dirname(os.path.abspath(__file__))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "kubeai_tpu_torch.tools.sharded_check"],
                            cwd=root, stdout=out, stderr=err, text=True)
    run = {"proc": proc, "t0": time.monotonic(), "out": out, "err": err}

    def stamp_exit():  # the child's own wall, whichever of it and the build ends first
        proc.wait()
        run["t_end"] = time.monotonic()

    threading.Thread(target=stamp_exit, name="sharded-train-wait", daemon=True).start()
    return run


def phase_sharded_train(run: dict) -> dict:
    """Phase 10 (budget SHARDED_BUDGET_S): wait for the child that
    start_sharded_train started and check its parts. Its
    ``sharded_train[...]`` lines are printed with the card's name and
    power limit."""
    proc = run["proc"]
    left = SHARDED_BUDGET_S + 60 - (time.monotonic() - run["t0"])
    try:
        proc.wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired as e:
        proc.kill()
        proc.wait()
        raise AssertionError(f"sharded_train: the check did not end within "
                             f"{SHARDED_BUDGET_S + 60:.0f} s") from e
    phase_s = run.get("t_end", time.monotonic()) - run["t0"]
    for f in (run["out"], run["err"]):
        f.seek(0)
    stdout, stderr = run["out"].read(), run["err"].read()
    if proc.returncode != 0:
        raise AssertionError(f"sharded_train: exit {proc.returncode}\n{stdout[-3000:]}"
                             f"\n{stderr[-3000:]}")
    parts = {}
    for line in stdout.splitlines():
        if line.startswith("sharded_train["):
            name, body = line.split(" ", 1)
            parts[name] = json.loads(body)
            log(name, gpu_line(), body)
    if set(parts) != {"sharded_train[ring]", "sharded_train[step]", "sharded_train[moe]"}:
        raise AssertionError(f"sharded_train: parts {sorted(parts)}\n{stdout[-3000:]}")
    for name in ("sharded_train[step]", "sharded_train[moe]"):
        if any(parts[name]["kernel_launches"].values()):
            raise AssertionError(f"{name}: the training step launched a kernel: "
                                 f"{parts[name]['kernel_launches']}")
    moe = parts["sharded_train[moe]"]
    if not moe["routes_equal"] or moe["routing"]["dropped"] == 0:
        raise AssertionError(f"sharded_train[moe]: routes equal {moe['routes_equal']}, "
                             f"routing {moe['routing']} (capacity factor 0.5 must drop pairs)")
    log(f"sharded_train phase: {phase_s:.1f}s (budget {SHARDED_BUDGET_S:.0f} s; beside the "
        f"kernel build)")
    if phase_s > SHARDED_BUDGET_S:
        raise AssertionError(f"sharded_train phase took {phase_s:.1f} s > {SHARDED_BUDGET_S} s")
    return parts


def phase_gang() -> dict:
    """Phase 9 (budget GANG_BUDGET_S): (d) NCCL capture, (b) the float32
    gang in process, (a) + (c) the two-rank server. Returns {"gang": run}
    for the kernels line's launches_by_path."""
    t0 = time.monotonic()
    out = {"nccl_capture": _nccl_graph_check()}
    log("gang_nccl_capture", json.dumps(out["nccl_capture"]))
    out["float32"] = _gang_float32()
    log("gang_float32", json.dumps(out["float32"]))
    run = _gang_server()
    run["phase_s"] = time.monotonic() - t0
    log("gang_server", json.dumps(run))
    if run["phase_s"] > GANG_BUDGET_S:
        raise AssertionError(f"gang phase took {run['phase_s']:.1f} s > {GANG_BUDGET_S} s")
    return {"gang": run}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import kubeai_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # A hang prints every thread's stack and exits non-zero inside the
    # 1200 s the run is given.
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    t0 = time.monotonic()
    sharded = start_sharded_train()
    try:
        phase_env()
    except BaseException:
        sharded["proc"].kill()
        raise
    phase_sharded_train(sharded)
    log(f"elapsed after phases 1 and 10: {time.monotonic() - t0:.1f}s")
    kern = phase_kernels()
    check_decode_grid()
    log(f"elapsed after phases 1-2: {time.monotonic() - t0:.1f}s")
    phase_model_parity()
    log(f"elapsed after phase 3: {time.monotonic() - t0:.1f}s")
    serving = phase_serving()
    log(f"elapsed after phase 4: {time.monotonic() - t0:.1f}s")
    t5 = time.monotonic()
    serving.update(phase_handoff())
    log(f"handoff phase: {time.monotonic() - t5:.1f}s")
    t6 = time.monotonic()
    ops = phase_serving_ops()
    serving["telemetry"] = ops["bf16"]["telemetry"]["launches"]
    log(f"serving_ops phase: {time.monotonic() - t6:.1f}s")
    serving.update(phase_coldstart())
    serving.update(phase_finetune())
    t9 = time.monotonic()
    serving.update(phase_gang())
    log(f"gang phase: {time.monotonic() - t9:.1f}s")
    log(f"total: {time.monotonic() - t0:.1f}s")
    # Each serving path is its own run with the counts zeroed before it:
    # `launches` is the count from the run of the kernel's own path (a
    # paged kernel's on its entry's pool dtype), and `launches_by_path`
    # keeps the runs apart.
    def launched(run, wrapper, pool, regime=None):
        if regime:
            key = "flash_launches_by_regime" if wrapper == "flash_attention" else \
                "launches_by_regime"
            return run.get(key, {}).get(regime, 0)
        return run["launches_by_pool"][wrapper].get(pool, 0) if pool else run["launches"][wrapper]

    summary = []
    for name, (src, replaces, wrapper, path, pool, *regime) in SOURCES.items():
        r = kern[name]
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "path": path, "launches": launched(serving[path], wrapper, pool, *regime),
            "launches_by_path": {p: launched(run, wrapper, pool, *regime)
                                 for p, run in serving.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    idle = [e["name"] for e in summary if not e["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on their own serving path: {idle}")
    log(gpu_line())
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
