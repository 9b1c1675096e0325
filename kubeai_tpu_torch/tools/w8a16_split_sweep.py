#!/usr/bin/env python3
"""Time the W8A16 kernels under other regimes, split-K plans and column
tiles than the wrapper's, and the host cost of one wrapper call beside
one torch.matmul.

    python3 kubeai_tpu_torch/tools/w8a16_split_sweep.py     # from the repo root, on the card

For Llama-3.1-8B's projection and head shapes, every variant is checked
against float32 math on the same int8 weights and timed with
chip_smoke's cold-L2 ``timed_ms``:

* ``crossover``: M = 8, 16, 32, 64 under the decode regime (mma.sync,
  16, 32 or 64 rows a block) and the wgmma tile (64 rows, BN 64 and
  128), each with its own split plan;
* ``sweep``: M = 8 and 64 under other split plans (target blocks per SM,
  least 64-deep stages per split) in the wrapper's regime;
* ``host_us_per_call``: the host time of enqueueing one qdot (M = 8,
  4096 x 1024), one qdot_many (wq|wk|wv) and one torch.matmul on the
  dequantized bf16 weight, behind a spin kernel that keeps the card from
  draining the queue.
"""

from __future__ import annotations

import json
import os
import sys
import time

# (target blocks per SM, least stages per split); the wrapper's is (2, 4)
# for mma.sync and the 128-column wgmma tile, (3, 4) for the 64-column one.
PLANS = ((1, 4), (2, 4), (4, 4), (8, 4), (4, 8), (8, 8))
SHAPES = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wg", 4096, 14336), ("wd", 14336, 4096),
          ("lm_head", 4096, 128256))


def split_plan(blocks_per_sm: int, min_steps: int):
    """A split_plan with another target and least split depth (the
    wrapper's partial-bytes cap kept)."""

    def plan(M, N, K, sms, bn=128, _bps=2):
        steps = -(-K // 64)
        if M > 64:
            return 1, steps * 64
        want = max(1, min(-(-blocks_per_sm * sms // -(-N // bn)), steps // min_steps,
                          K // (16 * M)))
        k_split = -(-steps // want) * 64
        return -(-K // k_split), k_split

    return plan


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from kubeai_tpu_torch.ops import quant

    print(cs.gpu_line(), flush=True)
    saved = quant.regime, quant.split_plan

    def use(regime=None, plan=None):
        quant.regime = regime or saved[0]
        quant.split_plan = plan or saved[1]
        quant._plan.cache_clear()

    def timed(x, w, want, label):
        cs.compare(quant.qdot(x, w), want, label)
        return cs.timed_ms(lambda: quant.qdot(x, w), cold_l2=True)

    try:
        for name, K, N in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(0)
            w = quant.quantize(torch.randn((K, N), generator=g, device="cuda") * K**-0.5)
            for M in (8, 16, 32, 64):
                x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
                want = (x.float() @ w["int8_q"].float()) * w["int8_s"]
                variants = {
                    "mma": lambda M, tma, *_a, **_k: saved[0](M, False),
                    "wgmma_bn64": lambda M, tma, *_a, **_k: (quant.WGMMA, 64, 64),
                    "wgmma_bn128": lambda M, tma, *_a, **_k: (quant.WGMMA, 64, 128),
                    "wgmma_128x256": lambda M, tma, *_a, **_k: (quant.WGMMA, 128, 256),
                }
                row = {"wrapper": quant._plan(M, N, K, True, False, 132)[:3]}
                for label, regime in variants.items():
                    use(regime=regime)
                    splits = quant._plan(M, N, K, True, False, 132)[3]
                    row[f"{label}_splits{splits}"] = timed(x, w, want, f"{name} M={M} {label}")
                use()
                print("crossover", name, M, json.dumps(row), flush=True)
                if M in (8, 64):
                    row = {}
                    for f, min_steps in PLANS:
                        use(plan=split_plan(f, min_steps))
                        splits = quant._plan(M, N, K, True, False, 132)[3]
                        row[f"f{f}_min{min_steps}_splits{splits}"] = timed(
                            x, w, want, f"{name} M={M} plan {f},{min_steps}")
                    use()
                    print("sweep", name, M, json.dumps(row), flush=True)
    finally:
        use()
    x = torch.randn((8, 4096), device="cuda").to(torch.bfloat16)
    w = quant.quantize(torch.randn((4096, 1024), device="cuda") * 0.01)
    qkv = [quant.quantize(torch.randn((4096, n), device="cuda") * 0.01) for n in (4096, 1024, 1024)]
    wb = quant.dequantize(w, torch.bfloat16)
    for label, fn in (("qdot", lambda: quant.qdot(x, w)),
                      ("qdot_many_qkv", lambda: quant.qdot_many(x, qkv)),
                      ("matmul", lambda: torch.matmul(x, wb))):
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
