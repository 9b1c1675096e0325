#!/usr/bin/env python3
"""Time the two split-KV decode kernels of several copies of the port
side by side on one card.

    python3 kubeai_tpu_torch/tools/time_decode_variants.py DIR [DIR ...] [--no-check]
        [--pool fp8|int8]

Each DIR holds a copy of ``chip_smoke.py`` and ``kubeai_tpu_torch/`` (the
parent's package, or a variant with an edited ``csrc/``). The copies run
in the order given, each in its own process from its own directory, so
each imports and builds its own kernels (list them in turns, v0 v1 v1 v0,
to see the spread). Every run times the dedicated and the ragged kernel
(the ragged one while its rows take the split-KV regime) on chip_smoke's
decode cases at B=8, Kv=8, h=128, page 64, with chip_smoke's cold-L2
``timed_ms``, after checking each output against the plain version
(``--no-check`` skips that, for ablations whose results are wrong on
purpose). ``--pool`` runs them over chip_smoke's one-byte pool of that
kind instead of bf16, and adds the ragged kernel's prefill tile (a 128
bucket and a 1024-query chunk at 1024, warm L2, as chip_smoke times
them). Prints one ``timing DIR {case: ms}`` line per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (S, kv_len, H) at B=8, Kv=8: decode, speculative verify at G=4 and G=8.
CASES = [(1, 1, 32), (1, 512, 32), (1, 2048, 32), (4, 512, 32), (8, 512, 32),
         (8, 2048, 32), (8, 512, 64)]


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
    runs += [("rag", S, L, H, True) for S, L, H in CASES if S * H // 8 <= 16]
    if pool_kind:
        runs += [("rag", S, L, 32, False) for _, S, L in PREFILL_CASES]
    out = {}
    for name, S, L, H, cold in runs:
        B = 8 if cold else 1
        q, pool, table, lens, kw = inputs(B, S, L, H)
        fn = paged_decode_attention if name == "ded" else paged_attention_ragged
        case = f"{name} S={S} kv={L} H={H}"
        if check:
            want = paged_attention_plain(q.float(), pool if kw else pool.float(), table, lens,
                                         **kw)
            c.compare(fn(q, pool, table, lens, **kw), want, case)
        out[case] = c.timed_ms(lambda: fn(q, pool, table, lens, **kw), cold_l2=cold)
    print("timing", tag, json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--pool", choices=("fp8", "int8"))
    args = ap.parse_args(argv)
    if len(args.dirs) == 1 and os.environ.get("TIME_DECODE_CHILD"):
        time_here(args.dirs[0], not args.no_check, args.pool)
        return 0
    rc = 0
    for d in args.dirs:
        env = dict(os.environ, TIME_DECODE_CHILD="1")
        cmd = [sys.executable, os.path.abspath(__file__), d] + ["--no-check"] * args.no_check
        cmd += ["--pool", args.pool] if args.pool else []
        rc |= subprocess.run(cmd, cwd=d, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
