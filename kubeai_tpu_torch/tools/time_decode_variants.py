#!/usr/bin/env python3
"""Time the two split-KV decode kernels of several copies of the port
side by side on one card.

    python3 kubeai_tpu_torch/tools/time_decode_variants.py DIR [DIR ...] [--no-check]
        [--pool fp8|int8] [--steps]

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
paged attention kernels.
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


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--pool", choices=("fp8", "int8"))
    ap.add_argument("--steps", action="store_true")
    args = ap.parse_args(argv)
    if len(args.dirs) == 1 and os.environ.get("TIME_DECODE_CHILD"):
        if args.steps:
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
        rc |= subprocess.run(cmd, cwd=d, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
