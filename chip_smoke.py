#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubeai_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (any failure exits non-zero; nothing is caught into a pass):
  1. environment: the card's name and power limit, torch/CUDA versions,
     the kernels' build time and nvcc's per-kernel resource report;
  2. kernels: each hand-written CUDA kernel at the main path's shapes
     against its plain PyTorch version (float32 math on the same bf16
     inputs), timed beside the plain version, one PyTorch library call
     that computes the same function (a yardstick the port never calls)
     and the least time the card could take (bound);
  3. model parity: a 2-layer Llama-3.1-8B-width model, kernel path vs
     plain gather path on the same weights, for cold prefill (flash and
     ragged buckets), a chunked prefill and decode steps;
  4. serving: the port's OpenAI server over Llama-3.1-8B (32 layers,
     random bf16 weights from a seed) answers completions, chat, a
     flash-sized prompt, a chunked prompt, a shared prefix, 8 concurrent
     requests (one streamed) and a seeded sample sent twice — once with
     the ragged decode kernel and once with the dedicated one, each run
     with the launch counters zeroed before it. Every kernel of a run's
     path must launch there, a whole number of times per layer.
The last two lines are the kernels summary (each kernel's launches in
the run of its own path, and per path) and {"ok": true, ...}.
"""

from __future__ import annotations

import json
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

KERNELS = ("flash_attention", "paged_attention", "paged_decode_attention")


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


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


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
    res = _build.build(list(KERNELS), ptxas_verbose=True)
    build_s = time.monotonic() - t0
    log(f"build: {len(res)} kernels in {build_s:.1f}s (parallel nvcc)")
    for name, r in res.items():
        for line in r.log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "smem")):
                log(f"  ptxas[{name}] {line.strip()}")
    return {"build_s": build_s}


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


def _paged_cost(B, S, kv_lens, H, Kv, h, page=64):
    """(bytes, flops) the paged function needs for these inputs: q and
    out once, each valid K/V row once, the lengths and the table entries
    of the pages that hold those rows; 4*h flops per (query head,
    visible key)."""
    visible = sum(max(0, L - S + s + 1) for L in kv_lens for s in range(S))
    kv_rows = sum(kv_lens)
    pages = sum(-(-L // page) for L in kv_lens)
    nbytes = 2 * (2 * B * S * H * h) + 2 * (kv_rows * 2 * Kv * h) + 4 * (B + pages)
    return nbytes, 4.0 * h * H * visible


def _bound(nbytes, flops, kind="bf16"):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _sdpa_paged(q, pool, table, lens):
    """Library yardstick for paged attention: gather the pages, then one
    scaled_dot_product_attention call with the position mask."""
    import torch
    import torch.nn.functional as F

    B, S, H, h = q.shape
    page, Kv = pool.shape[1], pool.shape[2] // 2
    skv = table.shape[1] * page
    gathered = pool[table.long()]
    k = gathered[..., 0::2, :].reshape(B, skv, Kv, h).transpose(1, 2)
    v = gathered[..., 1::2, :].reshape(B, skv, Kv, h).transpose(1, 2)
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
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention

    H, Kv, h = 32, 8, 128
    results: dict[str, dict] = {}

    def record(name, case, err, ms, plain_ms, nbytes, flops, lib_ms, headline):
        bound_ms, bound_by = _bound(nbytes, flops)
        line = {
            "kernel": name, "case": case, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        }
        log("kernel_case", json.dumps(line))
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if headline:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib_ms, case=case)

    # #1 flash attention: cold prefill bucket 1024.
    g = torch.Generator(device="cuda").manual_seed(1)
    S = 1024
    q = torch.randn((1, S, H, h), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((1, S, Kv, h), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((1, S, Kv, h), generator=g, device="cuda").to(torch.bfloat16)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    err = compare(got, want, "flash_attention S=1024")
    ms = timed_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = timed_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters=5)
    lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * S * H * h + 2 * S * Kv * h)
    flops = 4.0 * h * H * S * (S + 1) / 2
    record("flash_attention", "B=1 S=1024 causal", err, ms, plain_ms, nbytes, flops, lib_ms, True)

    # #2 and #3 on decode shapes; #2 also on prefill shapes.
    cases = [
        ("decode B=8 kv_len=1", 8, 1, [1] * 8, False),
        ("decode B=8 kv_len=300", 8, 1, [300] * 8, False),
        ("decode B=8 kv_len=512", 8, 1, [512] * 8, True),
        ("decode B=8 kv_len=2048", 8, 1, [2048] * 8, False),
        ("prefill B=1 S=128", 1, 128, [128], False),
        ("prefill chunk B=1 S=1024 start=1024", 1, 1024, [2048], False),
    ]
    for case, B, S, lens_list, headline in cases:
        q, pool, table, lens = _paged_case(B, S, lens_list)
        want = paged_attention_plain(q.float(), pool.float(), table, lens)
        nbytes, flops = _paged_cost(B, S, lens_list, H, Kv, h, page=pool.shape[1])
        lib_ms = timed_ms(lambda: _sdpa_paged(q, pool, table, lens), iters=5)
        plain_ms = timed_ms(lambda: paged_attention_plain(q, pool, table, lens), iters=5)
        kernels = [("paged_attention", paged_attention_ragged)]
        if S == 1:
            kernels.append(("paged_decode_attention", paged_decode_attention))
        for name, fn in kernels:
            got = fn(q, pool, table, lens)
            torch.cuda.synchronize()
            err = compare(got, want, f"{name} {case}")
            ms = timed_ms(lambda: fn(q, pool, table, lens))
            record(name, case, err, ms, plain_ms, nbytes, flops, lib_ms, headline)
        del q, pool, table, lens, want
    torch.cuda.empty_cache()
    for name, r in results.items():
        log("kernel", json.dumps({"kernel": name, **r}))
    return results


# ---------------------------------------------------------------------------
# Phase 3


def phase_model_parity() -> None:
    import torch

    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(mc, gen, device="cuda")
    kern = mc.replace(use_flash_prefill=True, use_paged_kernel=True)
    page, B, mp = 64, 2, 32
    P = 1 + B * mp
    table = torch.arange(1, P, dtype=torch.int32, device="cuda").reshape(B, mp)
    tok_g = torch.Generator(device="cuda").manual_seed(7)

    def toks(S):
        return torch.randint(0, 259, (B, S), generator=tok_g, device="cuda")

    pools = {}

    def check(what, a, b):
        # Logits leave the bf16 lm_head product, so they differ in whole
        # bf16 steps (ulps, 2^-7 relative) of their magnitude. The paths
        # differ only in attention's summation order and its bf16 output
        # rounding: allow 2 ulps of the largest logit at most and half an
        # ulp on average.
        ulp = 2.0 ** (torch.floor(torch.log2(b.abs().max())).item() - 7)
        d = (a - b).abs()
        log(f"parity {what}: max|dlogit| {d.max().item():.4f} mean {d.mean().item():.5f} "
            f"(bf16 ulp at max|logit|: {ulp})")
        if not torch.isfinite(a).all() or d.max().item() > 2 * ulp or d.mean().item() > 0.5 * ulp:
            raise AssertionError(f"model parity {what} outside tolerance")

    for cfg_name, cfg in (("kernel", kern), ("plain", mc)):
        pools[cfg_name] = llama.init_paged_cache(cfg, P, page, "cuda")
    out = {}
    for S, lens in ((512, [300, 512]), (128, [77, 128])):
        t = toks(S)
        L = torch.tensor(lens, device="cuda")
        for name, cfg in (("kernel", kern), ("plain", mc)):
            out[name] = llama.prefill_paged_cold(params, cfg, t, pools[name], table, L)[0]
        check(f"cold prefill S={S}", out["kernel"], out["plain"])
    t = toks(256)
    start = torch.tensor([128, 128], device="cuda")
    last = torch.tensor([255, 100], device="cuda")
    for name, cfg in (("kernel", kern), ("plain", mc)):
        out[name] = llama.prefill_paged(params, cfg, t, pools[name], table, start, last)[0]
    check("chunked prefill start=128 S=256", out["kernel"], out["plain"])
    d = toks(1)
    lengths = torch.tensor([384, 229], device="cuda")
    for dk in ("ragged", "dedicated"):
        for name, cfg in (("kernel", kern), ("plain", mc)):
            pool = {"kv": pools[name]["kv"].clone()}
            out[name] = llama.decode_step_paged(params, cfg, d, pool, table, lengths, decode_kernel=dk)[0]
        check(f"decode step ({dk})", out["kernel"], out["plain"])
    del params, pools, out
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


def _serve_once(params, decode_kernel: str) -> dict:
    import torch

    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.ops.flash_attention import flash_attention
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention

    ec = EngineConfig(max_slots=8, max_seq_len=2048, page_size=64, decode_kernel=decode_kernel)
    eng = Engine(llama_3_1_8b(), params, ByteTokenizer(), ec, device="cuda")
    srv = EngineServer(eng, "llama-3.1-8b", host="127.0.0.1", port=0)
    srv.start()
    p = srv.port
    counters = (flash_attention, paged_attention_ragged, paged_decode_attention)
    for fn in counters:
        fn.launches = 0
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
    finally:
        srv.stop()
    want = ["flash_attention", "paged_attention_ragged"]
    if decode_kernel == "dedicated":
        want.append("paged_decode_attention")
    missing = [n for n in want if launches[n] == 0]
    if missing:
        raise AssertionError(f"{decode_kernel} run: kernels never launched: {missing}")
    # A model step calls its attention kernel once per layer.
    layers = eng.model_config.num_layers
    if any(n % layers for n in launches.values()):
        raise AssertionError(f"{decode_kernel} run: launches not whole steps of {layers}: {launches}")
    # TTFT and decode tok/s of the streamed request (one of 8 running
    # together: its inter-token time is one decode step of the batch),
    # and the 7 others' tokens over the batch's wall time (prefills
    # included).
    stats = {
        "ttft_s": times[0],
        "stream_decode_tok_s": (len(times) - 1) / (times[-1] - times[0]) if len(times) > 1 else None,
        "concurrent_tok_s": tokens / wall,
        "launches": launches,
        "steps": {n: c // layers for n, c in launches.items()},
    }
    log(f"serving[{decode_kernel}]", json.dumps(stats))
    del eng, srv
    torch.cuda.empty_cache()
    return stats


def _step_profile(params) -> None:
    """Where a model step's time goes, at the serving shapes: host-clock
    time of decode steps (B=8, kv_len 512) under each decode kernel and
    of cold / chunked prefills, and a torch.profiler breakdown of one
    decode step's device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(use_flash_prefill=True, use_paged_kernel=True)
    B, page, mp = 8, 64, 32
    P = 1 + B * mp
    pool = llama.init_paged_cache(mc, P, page, "cuda")
    table = torch.arange(1, P, dtype=torch.int32, device="cuda").reshape(B, mp)
    tok = torch.randint(0, 259, (B, 1), device="cuda")
    lengths = torch.full((B,), 512, device="cuda")

    def wall_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / n

    res = {}
    for dk in ("ragged", "dedicated"):
        res[f"decode_step_ms_{dk}"] = wall_ms(
            lambda: llama.decode_step_paged(params, mc, tok, pool, table, lengths, decode_kernel=dk), 10)
    t512 = torch.randint(0, 259, (1, 512), device="cuda")
    res["cold_prefill_512_ms"] = wall_ms(lambda: llama.prefill_paged_cold(
        params, mc, t512, pool, table[:1], torch.tensor([512], device="cuda")), 3)
    t1024 = torch.randint(0, 259, (1, 1024), device="cuda")
    res["chunk_prefill_1024_at_1024_ms"] = wall_ms(lambda: llama.prefill_paged(
        params, mc, t1024, pool, table[:1], torch.tensor([1024], device="cuda"),
        torch.tensor([1023], device="cuda")), 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        llama.decode_step_paged(params, mc, tok, pool, table, lengths, decode_kernel="ragged")
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    # Kernel entries only: an operator's entry repeats its kernels' time.
    dev = [(a.key, a.self_device_time_total / 1e3, a.count) for a in prof.key_averages()
           if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]
    busy = sum(t for _, t, _ in dev)
    res["profiled_decode_step"] = {
        "wall_ms": wall, "device_busy_ms": busy, "device_kernels": sum(c for _, _, c in dev),
        "top": [{"kernel": k[:60], "ms": t, "count": c}
                for k, t, c in sorted(dev, key=lambda x: -x[1])[:8]],
    }
    log("step_profile", gpu_line(), json.dumps(res))
    del pool
    torch.cuda.empty_cache()


def phase_serving() -> dict:
    import torch

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
    log("serving_summary", gpu_line(), json.dumps(
        {k: {m: v[m] for m in ("ttft_s", "stream_decode_tok_s", "concurrent_tok_s")}
         for k, v in out.items()}))
    _step_profile(params)
    return out


# ---------------------------------------------------------------------------


# name -> (source, TPU kernel it replaces, wrapper, the serving path it
# belongs to: the default ragged-decode path, or --decode-kernel dedicated).
SOURCES = {
    "flash_attention": ("kubeai_tpu_torch/csrc/flash_attention.cu",
                        "kubeai_tpu/ops/flash_attention.py:27", "flash_attention", "ragged"),
    "paged_attention": ("kubeai_tpu_torch/csrc/paged_attention.cu",
                        "kubeai_tpu/ops/paged_attention.py:55", "paged_attention_ragged",
                        "ragged"),
    "paged_decode_attention": ("kubeai_tpu_torch/csrc/paged_decode_attention.cu",
                               "kubeai_tpu/ops/paged_decode_attention.py:66",
                               "paged_decode_attention", "dedicated"),
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
    t0 = time.monotonic()
    phase_env()
    kern = phase_kernels()
    phase_model_parity()
    serving = phase_serving()
    log(f"total: {time.monotonic() - t0:.1f}s")
    # Each serving path is its own run with the counts zeroed before it:
    # `launches` is the count from the run of the kernel's own path, and
    # `launches_by_path` keeps both runs apart.
    summary = []
    for name, (src, replaces, wrapper, path) in SOURCES.items():
        r = kern[name]
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "path": path, "launches": serving[path]["launches"][wrapper],
            "launches_by_path": {p: run["launches"][wrapper] for p, run in serving.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(gpu_line())
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
