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
     8, 16, 32, 64 and 1024 rows through each projection (both regimes),
     the heads, the grouped qkv and gate/up launches (equal byte for byte
     to separate ones) and the float32 instance; two launches must agree
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
     attention kernel may launch);
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
     counters zeroed before it. Every kernel of a run's path must launch
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
     with bf16 and int8 weights. Then the other families, each served
     with the same request set (FAMILY_RUNS: Qwen2.5-7B at 28 layers,
     bf16 ragged and int8 weights with the dedicated kernel; Gemma-2B at
     18, bf16 ragged and an fp8 pool with the dedicated kernel; Gemma2-2B
     at 26, bf16, with zero flash and paged launches; Mixtral-8x7B at 16
     of its 32 layers, full width, bf16 ragged), no CUDA-core tile in any
     of them, and a step profile of each (decode, 8-token verify, cold
     512 prefill). Then the loader: a 2-layer checkpoint at
     8B width written by the port's save_hf_checkpoint is served through
     --model <dir> --quantization int8, and its int8 leaves must equal
     quantize_model_params of the written weights. Last, the JAX
     package's float32 test config serves through the server's command
     line with --quantization int8 --kv-cache-dtype fp8 and then with
     --speculate-tokens 3, its greedy tokens equal to the same engine's on
     the CPU.
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
import subprocess
import sys
import threading
import time
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
# 8-slot verify step of 8 tokens (64), a prefill chunk (1024).
W8A16_ROWS = (8, 16, 32, 64, 1024)
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
    gate/up) at 8, 64 and 1024 rows, each output equal byte for byte to
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
        for M in (8, 64, 1024):
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
    del params
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
def _float32_w8a16():
    """The model's int8 products as float32 math on the same int8 weights,
    rounded once to bf16 (the kernel's function, summed in another order):
    the plain path of the int8 parity check. No kernel launches in it."""
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.ops import quant

    def dot(x, w):
        if not quant.is_quantized(w):
            return x @ w
        return ((x.float() @ w["int8_q"].float()) * w["int8_s"].squeeze(-2)).to(x.dtype)

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
            kernel_ctx=contextlib.nullcontext) -> None:
    """Kernel path (flash, paged kernels and, for int8 weights, the W8A16
    kernel) against the plain path (gather attention, or with
    *plain_gates* the kernel path's gates; *plain_ctx* around each plain
    call, *kernel_ctx* around each kernel call) on the same weights and
    tokens."""
    import torch

    from kubeai_tpu_torch.models import llama

    kern = mc.replace(use_flash_prefill=True, use_paged_kernel=True)
    plain_cfg = kern if plain_gates else mc
    page, B, mp = 64, 2, 32
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

    for S, lens in ((512, [300, 512]), (128, [77, 128])):
        t = toks(S)
        L = torch.tensor(lens, device="cuda")
        both(f"cold prefill S={S}", lambda cfg, pool: llama.prefill_paged_cold(
            params, cfg, t, pool, table, L)[0])
    t = toks(256)
    start = torch.tensor([128, 128], device="cuda")
    last = torch.tensor([255, 100], device="cuda")
    both("chunked prefill start=128 S=256", lambda cfg, pool: llama.prefill_paged(
        params, cfg, t, pool, table, start, last)[0])
    d = toks(1)
    lengths = torch.tensor([384, 229], device="cuda")
    for dk in ("ragged", "dedicated"):
        both(f"decode step ({dk})", lambda cfg, pool: llama.decode_step_paged(
            params, cfg, d, {"kv": pool["kv"].clone()}, table, lengths, decode_kernel=dk)[0])
    # Speculative verify: 8 candidate tokens per slot (S = G+1 = 8: the
    # ragged kernel's split-KV tile at 32 rows), and 17 (68 rows: its
    # prefill tile, and the dedicated kernel's two row groups).
    for S in (8, 17):
        spec = toks(S)
        for dk in ("ragged", "dedicated"):
            both(f"verify step S={S} ({dk})", lambda cfg, pool: llama.decode_speculative_paged(
                params, cfg, spec, {"kv": pool["kv"].clone()}, table, lengths,
                decode_kernel=dk)[0])
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


def _stream(port, body, timeout=600):
    """(text, finish_reason, event times in s since the request) of an
    SSE completion. With logprobs on, every token sends an event."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        # EOS (token 257 of the byte tokenizer) is banned so the timed
        # stream runs its full length.
        data=json.dumps({**body, "stream": True, "logprobs": 0,
                         "logit_bias": {"257": -100}}).encode(),
        headers={"Content-Type": "application/json"},
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
    from kubeai_tpu_torch.ops.quant import qdot, qdot_many

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
    counters = attention + (qdot, qdot_many)
    for fn in counters:
        fn.launches = 0
    for fn in (paged_attention_ragged, paged_decode_attention):
        fn.launches_by_pool.clear()
    paged_attention_ragged.launches_by_regime.clear()
    flash_attention.launches_by_regime.clear()
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
        launches = {fn.__name__: fn.launches for fn in counters}
        by_pool = {fn.__name__: dict(fn.launches_by_pool)
                   for fn in (paged_attention_ragged, paged_decode_attention)}
        by_regime = dict(paged_attention_ragged.launches_by_regime)
        flash_by_regime = dict(flash_attention.launches_by_regime)
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
    if not warm or warm["shapes"] != 1 + 3 * 6:
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
    del params, qparams
    torch.cuda.empty_cache()
    out.update(_serve_families())
    _serve_checkpoint()
    out["tiny_int8_fp8"] = _serve_tiny("tiny_int8_fp8", ["--quantization", "int8",
                                                         "--kv-cache-dtype", "fp8"])
    out["tiny_spec"] = _serve_tiny("tiny_spec", ["--speculate-tokens", "3"])
    return out


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


def _serve_checkpoint() -> None:
    """The loader: a 2-layer checkpoint at Llama-3.1-8B width (random bf16
    weights from seed 1, HF names and [out, in] layouts) written by the
    port's save_hf_checkpoint under build/, served through the server's
    own argument path with --model <dir> --quantization int8 (one
    completion); its int8 leaves must equal quantize_model_params of the
    written weights, and its config the written one."""
    import shutil

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
        finally:
            srv.stop()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    log("loader", json.dumps({"checkpoint": "2 layers at Llama-3.1-8B width, bf16 safetensors",
                              "write_s": write_s, "load_quantize_s": load_s,
                              "completion": text}))
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


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
    phase_env()
    kern = phase_kernels()
    check_decode_grid()
    log(f"elapsed after phases 1-2: {time.monotonic() - t0:.1f}s")
    phase_model_parity()
    log(f"elapsed after phase 3: {time.monotonic() - t0:.1f}s")
    serving = phase_serving()
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
