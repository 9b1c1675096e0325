#!/usr/bin/env python3
"""Time the W8A16 kernel under other split-K plans than the wrapper's,
and the host cost of one wrapper call beside one torch.matmul.

    python3 kubeai_tpu_torch/tools/w8a16_split_sweep.py     # from the repo root, on the card

For Llama-3.1-8B's projection and head shapes at M = 8 and 64, each plan
(target blocks per SM, least 64-deep stages per split) is checked against
float32 math on the same int8 weights and timed with chip_smoke's cold-L2
``timed_ms``; prints one ``sweep`` line per shape. Then ``host_us_per_call``:
the host time of enqueueing one qdot (M = 8, 4096 x 1024) and one
torch.matmul on the dequantized bf16 weight, behind a spin kernel that
keeps the card from draining the queue.
"""

from __future__ import annotations

import json
import os
import sys
import time

# (target blocks per SM, least stages per split); the wrapper's plan is (2, 4).
PLANS = ((1, 4), (2, 4), (4, 4), (8, 4), (4, 2), (8, 2))
SHAPES = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wg", 4096, 14336), ("wd", 14336, 4096),
          ("lm_head", 4096, 128256))


def plan(blocks_per_sm: int, min_steps: int):
    """A split_plan with another target and least split depth."""

    def split_plan(M, N, K, sms):
        steps = -(-K // 64)
        if M > 64:
            return 1, steps * 64
        want = max(1, min(-(-blocks_per_sm * sms // -(-N // 128)), steps // min_steps))
        k_split = -(-steps // want) * 64
        return -(-K // k_split), k_split

    return split_plan


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from kubeai_tpu_torch.ops import quant

    print(cs.gpu_line(), flush=True)
    wrapper_plan = quant.split_plan
    for name, K, N in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        w = quant.quantize(torch.randn((K, N), generator=g, device="cuda") * K**-0.5)
        for M in (8, 64):
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            want = (x.float() @ w["int8_q"].float()) * w["int8_s"]
            row = {}
            try:
                for f, min_steps in PLANS:
                    quant.split_plan = plan(f, min_steps)
                    cs.compare(quant.qdot(x, w), want, f"{name} M={M} plan {f},{min_steps}")
                    splits = quant.split_plan(M, N, K, 132)[0]
                    row[f"f{f}_min{min_steps}_splits{splits}"] = cs.timed_ms(
                        lambda: quant.qdot(x, w), cold_l2=True)
            finally:
                quant.split_plan = wrapper_plan
            print("sweep", name, M, json.dumps(row), flush=True)
    x = torch.randn((8, 4096), device="cuda").to(torch.bfloat16)
    w = quant.quantize(torch.randn((4096, 1024), device="cuda") * 0.01)
    wb = quant.dequantize(w, torch.bfloat16)
    for label, fn in (("qdot", lambda: quant.qdot(x, w)), ("matmul", lambda: torch.matmul(x, wb))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        print("host_us_per_call", label, us, flush=True)


if __name__ == "__main__":
    main()
