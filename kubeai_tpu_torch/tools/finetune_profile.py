#!/usr/bin/env python3
"""Where a LoRA fine-tune step's time goes on one card.

    python3 kubeai_tpu_torch/tools/finetune_profile.py [--layers 32 4] [--steps 3]

``train/finetune.py::train_lora`` over preset:llama-3.1-8b's seeded
bf16 weights cut to each ``--layers`` depth, a float32 rank-16 bank on q
and v, batch 4 x 256 tokens (the chip_smoke fine-tune cell): after 2
warm steps, ``--steps`` steps under torch.profiler. Per step: wall ms
(host clock to the loss on the host), device busy ms (the union of the
kernels' intervals), kernels launched, and the top kernels by device
time; then the same steps without the profiler (wall ms).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line per depth.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from kubeai_tpu_torch.engine.core import preset_params
from kubeai_tpu_torch.models.base import llama_3_1_8b
from kubeai_tpu_torch.train import finetune

SEQ, BATCH, TARGETS = 256, 4, ("wq", "wv")


def _rows(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return [(list(map(int, rng.integers(0, 256, SEQ + 8))), [1] * (SEQ + 8)) for _ in range(n)]


def _busy_ms(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3  # us -> ms


def profile(layers: int, steps: int) -> dict:
    mc = llama_3_1_8b(num_layers=layers)
    params = preset_params(mc, torch.device("cuda"), seed=0)
    bank = finetune.init_bank(mc, 16, 16.0, TARGETS, device="cuda")
    rows = _rows()
    finetune.train_lora(params, mc, bank, rows, TARGETS, 2, BATCH, SEQ, 1e-3)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    stats = {}
    with torch.profiler.profile(activities=acts) as prof:
        finetune.train_lora(params, mc, bank, rows, TARGETS, steps, BATCH, SEQ, 1e-3, stats=stats)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    plain = {}
    finetune.train_lora(params, mc, bank, rows, TARGETS, steps, BATCH, SEQ, 1e-3, stats=plain)
    res = {"layers": layers, "steps": steps,
           "wall_ms_profiled": [t * 1e3 for t in stats["step_s"]],
           "wall_ms": [t * 1e3 for t in plain["step_s"]],
           "device_busy_ms_per_step": _busy_ms(events) / steps,
           "kernels_per_step": len(kernels) / steps,
           "top_kernels_ms_per_step": {k: v / steps for k, v in top}}
    del params, bank
    torch.cuda.empty_cache()
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[32, 4])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("finetune_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for layers in args.layers:
        t0 = time.monotonic()
        print("profile", json.dumps(profile(layers, args.steps)),
              f"({time.monotonic() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
