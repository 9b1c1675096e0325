#!/usr/bin/env python3
"""Time the two split-KV decode kernels of several copies of the port
side by side on one card.

    python3 kubeai_tpu_torch/tools/time_decode_variants.py DIR [DIR ...] [--no-check]
        [--pool fp8|int8] [--steps] [--serve [--speculate G]]

Each DIR holds a copy of ``chip_smoke.py`` and ``kubeai_tpu_torch/`` (the
parent's package, or a variant with an edited ``csrc/``). The copies run
in the order given, each in its own process from its own directory, so
each imports and builds its own kernels (list them in turns, v0 v1 v1 v0,
to see the spread). Every run times the dedicated and the ragged kernel
on chip_smoke's decode and verify cases (up to 64 rows per KV head) at
B=8, Kv=8, h=128, page 64, with chip_smoke's cold-L2
``timed_ms``, after checking each output against the plain version
(``--no-check`` skips that, for ablations whose results are wrong on
purpose). ``--pool`` runs them over chip_smoke's one-byte pool of that
kind instead of bf16, and adds the ragged kernel's prefill tile (a 128
bucket and a 1024-query chunk at 1024, warm L2, as chip_smoke times
them). Prints one ``timing DIR {case: ms}`` line per run. ``--steps``
profiles whole 32-layer Llama-3.1-8B verify steps instead (B=8, 8 tokens
a slot at kv 512, random bf16 weights from seed 0, each decode kernel;
torch.profiler, two profiled steps each): one ``steps DIR {...}`` line
per run with each step's device busy ms, kernel count and the ms of its
paged attention kernels. ``--serve`` serves instead: Llama-3.1-8B at
full depth (random bf16 weights from seed 0, ragged decode kernel, 8
slots, ``--speculate G``), :data:`ROUNDS` rounds of :data:`STREAMS`
concurrent greedy requests of :data:`MAX_TOKENS` tokens through
``Engine.submit`` (:func:`serve_rounds`), so a parent copy of the port
and this one can be set against each other on one card: one
``serve DIR {...}`` line per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (S, kv_len, H) at B=8, Kv=8: decode, speculative verify at G=4 and G=8.
CASES = [(1, 1, 32), (1, 512, 32), (1, 2048, 32), (4, 512, 32), (8, 512, 32),
         (8, 2048, 32), (16, 512, 32), (8, 512, 64)]


# With --pool, the ragged kernel's prefill tile as well: (B, S, kv_len).
PREFILL_CASES = [(1, 128, 128), (1, 1024, 2048)]


def time_here(tag: str, check: bool, pool_kind: str | None) -> None:
    """Time the package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention

    def inputs(B, S, L, H):
        if pool_kind is None:
            q, pool, table, lens = c._paged_case(B, S, [L] * B, H=H)
            return q, pool, table, lens, {}
        q, pool, table, lens, ks, vs = c._quant_case(B, S, [L] * B, pool_kind, H=H)
        return q, pool, table, lens, {"k_scale": ks, "v_scale": vs}

    runs = [("ded", S, L, H, True) for S, L, H in CASES]
    runs += [("rag", S, L, H, True) for S, L, H in CASES]
    if pool_kind:
        runs += [("rag", S, L, 32, False) for _, S, L in PREFILL_CASES]
    out = {}
    for name, S, L, H, cold in runs:
        B = 8 if cold else 1
        q, pool, table, lens, kw = inputs(B, S, L, H)
        fn = paged_decode_attention if name == "ded" else paged_attention_ragged
        case = f"{name} S={S} kv={L} H={H}"
        try:
            got = fn(q, pool, table, lens, **kw)
        except ValueError as e:  # a copy that refuses the shape
            out[case] = f"refused: {e}"
            continue
        if check:
            want = paged_attention_plain(q.float(), pool if kw else pool.float(), table, lens,
                                         **kw)
            c.compare(got, want, case)
        out[case] = c.timed_ms(lambda: fn(q, pool, table, lens, **kw), cold_l2=cold)
    print("timing", tag, json.dumps(out), flush=True)


def steps_here(tag: str) -> None:
    """Profile verify steps of the package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(use_flash_prefill=True, use_paged_kernel=True)
    params = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    B, page, mp, S = 8, 64, 32, 8
    pool = llama.init_paged_cache(mc, 1 + B * mp, page, "cuda")
    table = torch.arange(1, 1 + B * mp, dtype=torch.int32, device="cuda").reshape(B, mp)
    spec = torch.randint(0, 259, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    lengths = torch.full((B,), 512 - S, device="cuda")
    out = {}
    for dk in ("ragged", "dedicated"):
        def step():
            return llama.decode_speculative_paged(params, mc, spec, pool, table, lengths,
                                                  decode_kernel=dk)
        step()
        torch.cuda.synchronize()
        for rep in range(2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            dev = [(a.key, a.self_device_time_total / 1e3, a.count) for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]
            out[f"verify{S}_{dk}#{rep}"] = {
                "device_busy_ms": sum(t for _, t, _ in dev),
                "kernels": sum(c for _, _, c in dev),
                "attention_ms": sum(t for k, t, _ in dev if "paged" in k),
            }
    print("steps", tag, json.dumps(out), flush=True)


# The serving traffic (--serve, and chip_smoke.py's graph turns): rounds
# of concurrent greedy requests, one after another.
ROUNDS, STREAMS, MAX_TOKENS = 3, 8, 128
# Prompts of the 8 streams, each under one 64-token page (a later round
# then prefills as the first did, never from the prefix cache): text,
# and repeating patterns whose continuation the n-gram drafter can find.
SERVE_PROMPTS = (
    "Request number 0: tell a story about the sea.",
    "The quick brown fox jumps over the lazy dog. The quick brown",
    "one two three four one two three four one two three four",
    "Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed",
    "a b c d e f g a b c d e f g a b c d e f g a b c",
    "In the beginning the universe was created. This has made",
    "red green blue red green blue red green blue red green",
    "def fib(n):\n    return n if n < 2 else fib(n - 1) + fib(n - 2)",
)


# Seconds between rounds: longer than an eager chunk of the 8B model.
IDLE_S = 0.5


def serve_rounds(engine, rounds: int = ROUNDS, streams: int = STREAMS,
                 max_tokens: int = MAX_TOKENS, profile: bool = False) -> list[dict]:
    """*rounds* rounds of *streams* concurrent greedy requests of
    *max_tokens* tokens through ``engine.submit`` (a started engine of
    any copy of the port), each round after IDLE_S of quiet. Per round: wall seconds, completion tokens,
    aggregate tok/s; request 0's TTFT, per-stream tok/s and its chunk
    wall (median interval between its bursts of tokens: a chunk's tokens
    arrive together) over the chunk's steps; every request's token ids
    and the top-2 logprob gap at each;
    and, where the engine keeps a chunk log, the medians of its host
    segments and of the device span between the events around a chunk,
    over chunks with every stream in flight. With *profile* each round
    also traces a window of PROFILE_CHUNKS chunks with every stream in
    flight (:func:`_profile_window`)."""
    import statistics
    import threading
    import time

    from kubeai_tpu_torch.engine.sampling import SamplingParams

    K = engine.cfg.decode_chunk
    prompts = [engine.tokenizer.encode(SERVE_PROMPTS[i % len(SERVE_PROMPTS)])
               for i in range(streams)]
    out = []
    for _ in range(rounds):
        times = [[] for _ in range(streams)]
        toks = [[] for _ in range(streams)]
        gaps = [[] for _ in range(streams)]
        done = [0.0] * streams
        errors = []

        def drain(i, req, t0):
            while True:
                ev = req.out.get(timeout=600)
                if ev[0] == "token":
                    if ev[1] >= 0:
                        toks[i].append(ev[1])
                        times[i].append(time.monotonic() - t0)
                        gaps[i].append(ev[4][0][1] - ev[4][1][1])
                elif ev[0] == "done":
                    done[i] = time.monotonic() - t0
                    return
                else:
                    errors.append(ev[1])
                    return

        # Each round starts on an idle engine: a pipelined engine still
        # runs the chunk it dispatched before the last stream finished,
        # which a request submitted at once would wait behind.
        time.sleep(IDLE_S)
        log0 = len(getattr(engine, "chunk_log", ()))
        t0 = time.monotonic()
        reqs = [engine.submit(p, SamplingParams(temperature=0.0, max_tokens=max_tokens,
                                                logprobs=True))
                for p in prompts]
        threads = [threading.Thread(target=drain, args=(i, r, t0)) for i, r in enumerate(reqs)]
        for th in threads:
            th.start()
        prof = None
        if profile:
            prof = _profile_window(engine, times, threads)
        for th in threads:
            th.join(timeout=900)
        if errors or any(th.is_alive() for th in threads):
            raise RuntimeError(f"serving round failed: {errors}")
        wall = max(done)
        n_tok = sum(len(t) for t in toks)
        t = times[0]
        # A chunk's tokens reach the stream within a few ms of each other
        # (thread switches); chunks are tens of ms apart.
        bursts = [t[0]] + [b for a, b in zip(t, t[1:]) if b - a > 5e-3]
        chunk_walls = [b - a for a, b in zip(bursts, bursts[1:])]
        r = {
            "wall_s": wall, "tokens": n_tok, "agg_tok_s": n_tok / wall,
            "ttft_s": t[0], "stream_tok_s": (len(t) - 1) / (t[-1] - t[0]) if len(t) > 1 else None,
            "step_wall_ms": statistics.median(chunk_walls) * 1e3 / K if chunk_walls else None,
            "ids": toks, "gaps": gaps,
        }
        log_ = list(getattr(engine, "chunk_log", ()))[log0:]
        full = [c for c in log_ if c["slots"] == streams]
        if full:
            for key in ("dispatch_ms", "fetch_wait_ms", "emit_ms", "dur_ms", "device_ms"):
                vals = [c[key] for c in full if c.get(key) is not None]
                r[f"chunk_{key}"] = statistics.median(vals) if vals else None
            r["chunks"] = len(log_)
            r["graph_chunks"] = sum(bool(c["graph"]) for c in log_)
        if prof is not None:
            r["profile"] = prof
        out.append(r)
    return out


# Chunks of a profiled window.
PROFILE_CHUNKS = 5


def _profile_window(engine, times, threads) -> dict:
    """torch.profiler (CPU and CUDA activity) over PROFILE_CHUNKS + 1
    decode chunks once every stream has its first token. The engine's
    own thread starts and stops the session (its dispatch and fetch are
    wrapped for the window): a session stopped on another thread while
    the engine thread launched a CUDA graph deadlocked on the H100. The
    window opens on an idle card before a dispatch and closes once the
    chunk in flight after the last fetched one has finished. Returns the
    window's host clock, the kernels' summed device time (busy; a graph's
    kernels count like any other), the idle share, and busy ms per
    chunk."""
    import threading
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    while not all(times) and any(th.is_alive() for th in threads):
        time.sleep(0.0005)
    state: dict = {}
    done = threading.Event()

    def dispatch():
        if "prof" not in state:
            torch.cuda.synchronize()
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].__enter__()
            state["t0"], state["n0"] = time.monotonic(), len(engine.chunk_log)
        return type(engine)._dispatch_chunk(engine)

    def process(*args):
        type(engine)._process_chunk(engine, *args)
        if "prof" in state and len(engine.chunk_log) >= state["n0"] + PROFILE_CHUNKS:
            torch.cuda.synchronize()  # the chunk dispatched after this one too
            state["t1"] = time.monotonic()
            state["prof"].__exit__(None, None, None)
            del engine._dispatch_chunk, engine._process_chunk
            done.set()

    engine._dispatch_chunk, engine._process_chunk = dispatch, process
    while not done.wait(0.01):
        if not any(th.is_alive() for th in threads):
            raise RuntimeError("the round ended before the profiled window")
    n = PROFILE_CHUNKS + 1
    # Kernel entries only: an operator's entry repeats its kernels' time.
    dev = [(a.self_device_time_total / 1e3, a.count) for a in state["prof"].key_averages()
           if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]
    window = (state["t1"] - state["t0"]) * 1e3
    busy = sum(t for t, _ in dev)
    if not dev:
        return {"window_ms": window, "chunks": n, "device_busy_ms": "not measured"}
    return {"window_ms": window, "device_busy_ms": busy, "kernels": sum(c for _, c in dev),
            "idle_share": 1 - busy / window, "chunks": n, "window_ms_per_chunk": window / n,
            "busy_ms_per_chunk": busy / n}


def serve_here(tag: str, speculate: int) -> None:
    """Serve the traffic with the package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b()
    params = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    ec = EngineConfig(max_slots=STREAMS, max_seq_len=2048, page_size=64,
                      speculate_tokens=speculate)
    eng = Engine(mc, params, ByteTokenizer(), ec, device="cuda")
    eng.start()
    try:
        serve_rounds(eng, rounds=1)  # the first chunk's capture, the allocator's growth
        rounds = serve_rounds(eng)
    finally:
        eng.stop()
    for r in rounds:
        r.pop("ids")
        r.pop("gaps")
    print("serve", tag, json.dumps({"G": speculate, "rounds": rounds}), flush=True)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--pool", choices=("fp8", "int8"))
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--speculate", type=int, default=0, help="G of --serve")
    args = ap.parse_args(argv)
    if len(args.dirs) == 1 and os.environ.get("TIME_DECODE_CHILD"):
        if args.serve:
            serve_here(args.dirs[0], args.speculate)
        elif args.steps:
            steps_here(args.dirs[0])
        else:
            time_here(args.dirs[0], not args.no_check, args.pool)
        return 0
    rc = 0
    for d in args.dirs:
        env = dict(os.environ, TIME_DECODE_CHILD="1")
        cmd = [sys.executable, os.path.abspath(__file__), d] + ["--no-check"] * args.no_check
        cmd += ["--pool", args.pool] if args.pool else []
        cmd += ["--steps"] * args.steps
        cmd += ["--serve", "--speculate", str(args.speculate)] if args.serve else []
        rc |= subprocess.run(cmd, cwd=d, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
