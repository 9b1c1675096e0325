#!/usr/bin/env python3
"""Time the two split-KV decode kernels of several copies of the port
side by side on one card.

    python3 kubeai_tpu_torch/tools/time_decode_variants.py DIR [DIR ...] [--no-check]

Each DIR holds a copy of ``chip_smoke.py`` and ``kubeai_tpu_torch/`` (the
parent's package, or a variant with an edited ``csrc/``). The copies run
in the order given, each in its own process from its own directory, so
each imports and builds its own kernels (list them in turns, v0 v1 v1 v0,
to see the spread). Every run times the dedicated and the ragged kernel
(the ragged one while its rows take the split-KV regime) on chip_smoke's
decode cases at B=8, Kv=8, h=128, page 64, with chip_smoke's cold-L2
``timed_ms``, after checking each output against the plain version
(``--no-check`` skips that, for ablations whose results are wrong on
purpose). Prints one ``timing DIR {case: ms}`` line per run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# (S, kv_len, H) at B=8, Kv=8: decode, speculative verify at G=4 and G=8.
CASES = [(1, 1, 32), (1, 512, 32), (1, 2048, 32), (4, 512, 32), (8, 512, 32),
         (8, 2048, 32), (8, 512, 64)]


def time_here(tag: str, check: bool) -> None:
    """Time the package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention

    out = {}
    for S, L, H in CASES:
        q, pool, table, lens = c._paged_case(8, S, [L] * 8, H=H)
        want = paged_attention_plain(q.float(), pool.float(), table, lens) if check else None
        for name, fn in (("ded", paged_decode_attention), ("rag", paged_attention_ragged)):
            if name == "rag" and S * H // 8 > 16:
                continue
            case = f"{name} S={S} kv={L} H={H}"
            if check:
                c.compare(fn(q, pool, table, lens), want, case)
            out[case] = c.timed_ms(lambda: fn(q, pool, table, lens), cold_l2=True)
    print("timing", tag, json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    check = "--no-check" not in argv
    dirs = [a for a in argv if a != "--no-check"]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    if len(dirs) == 1 and os.environ.get("TIME_DECODE_CHILD"):
        time_here(dirs[0], check)
        return 0
    rc = 0
    for d in dirs:
        env = dict(os.environ, TIME_DECODE_CHILD="1")
        cmd = [sys.executable, os.path.abspath(__file__), d] + ([] if check else ["--no-check"])
        rc |= subprocess.run(cmd, cwd=d, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
