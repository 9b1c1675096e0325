#!/usr/bin/env python3
"""What LoRA adapters cost on one card, at Llama-3.1-8B's widths.

    python3 kubeai_tpu_torch/tools/lora_profile.py [--no-serve]
    python3 kubeai_tpu_torch/tools/lora_profile.py --first-load

1. ``deltas``: the LoRA deltas of one model step alone (32 layers x 7
   targets; a bank of 9 rows at rank 64, bf16, 3.02 GB; rows 1 and 2
   alternating over the batch) for a decode step (B=8) and an 8-token
   verify step (B=8, S=8), in two forms: the port's
   (``models/llama.py::_lora_add``: x through every row's A in one
   batched product, a mask, one product over the rows' B stacked) and
   the JAX package's literal one (gather each batch row's A and B, two
   batched products, scale, add). Device ms per step from CUDA events
   over 5 steps (each layer's slice is read once a step, far past the
   L2), the bound (the bank's bytes at 3.35 TB/s) and a torch.profiler
   breakdown of one step by kernel. Then the A side alone at the decode
   step: x through every row's A in the bank's layout [N, in, r] (a
   batched product) and in an [in, N*r] layout (one product; copies of
   A made outside the profiled step), profiler busy ms.
2. ``serve`` (unless ``--no-serve``): the 32-layer model (random bf16
   weights from seed 0, ragged kernel, CUDA graphs) serving 8 streams
   of 128 greedy tokens, 2 rounds per engine, in turns: no bank, two
   rank-16 adapters (streams alternate a, b), the same again, no bank
   (``time_decode_variants.serve_rounds``): wall per decode step and the
   chunk's device ms per step.

3. ``first_load`` (``--first-load``, alone in a fresh process): what an
   operator's first adapter load costs a server that is already
   serving. An engine (the same model and settings) serves a round of 8
   streams of 32 tokens without a bank (the chunk is captured), loads
   two rank-16 adapters (``Engine.load_adapter``: the bank is allocated
   and the graphs dropped), and serves a round on them (the chunk is
   captured again, with the deltas). Then a second engine in the same
   process does the same. Per engine: capture s before and after the
   load, each load's wall s.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line per part.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12
RANK, ROWS, STEPS = 64, 9, 5


def _gather_add(out, x, A_l, B_l, rows, scale):
    """The JAX package's _lora_delta, literally: each batch row's A and B
    gathered (copied), two batched products, the scale, the add."""
    low = torch.bmm(x, A_l[rows])
    return out + torch.bmm(low, B_l[rows]) * scale[rows].to(x.dtype)[:, None, None]


def deltas() -> dict:
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from torch.profiler import ProfilerActivity, profile

    mc = llama_3_1_8b()
    g = torch.Generator(device="cuda").manual_seed(0)
    bank = llama.init_lora_bank(mc, ROWS, RANK, device="cuda")
    for key, t in bank.items():
        if key != "scale":
            t[:, 1:3].copy_(torch.randn(t[:, 1:3].shape, generator=g, device="cuda") * 0.02)
    bank["scale"][1:3] = 2.0
    dims = llama.lora_dims(mc)
    res = {"bank_bytes": sum(t.nbytes for t in bank.values())}
    res["bound_ms"] = res["bank_bytes"] / HBM_BYTES_PER_S * 1e3
    for case, (B, S) in {"decode_B8": (8, 1), "verify_B8_S8": (8, 8)}.items():
        rows = torch.tensor([1, 2] * (B // 2), device="cuda")
        w = llama.lora_weights(rows, bank["scale"], torch.bfloat16)
        xs = {t: torch.randn((B, S, din), generator=g, device="cuda").to(torch.bfloat16)
              for t, (din, _) in dims.items()}
        outs = {t: torch.randn((B, S, dout), generator=g, device="cuda").to(torch.bfloat16)
                for t, (_, dout) in dims.items()}
        forms = {
            "port": lambda li, t: llama._lora_add(outs[t], xs[t], bank[t + "_A"][li],
                                                  bank[t + "_B"][li], w),
            "jax_gather": lambda li, t: _gather_add(outs[t], xs[t], bank[t + "_A"][li],
                                                    bank[t + "_B"][li], rows, bank["scale"]),
        }
        # The two forms agree (bf16: the scale's place and one rounding).
        for t in dims:
            a, b = forms["port"](1, t).float(), forms["jax_gather"](1, t).float()
            err = ((a - b).abs() / (b.abs() + 1)).max().item()
            if err > 2**-6:
                raise AssertionError(f"{case} {t}: forms differ by {err}")
        for name, fn in forms.items():
            def step():
                for li in range(mc.num_layers):
                    for t in dims:
                        fn(li, t)
            step()
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(STEPS):
                step()
            e1.record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            res[f"{case}_{name}"] = {
                "ms_per_step": e0.elapsed_time(e1) / STEPS,
                **_busy(prof),
            }
    # The A side of the decode step in the bank's layout and in [in, N*r].
    xs = {t: torch.randn((8, din), generator=g, device="cuda").to(torch.bfloat16)
          for t, (din, _) in dims.items()}
    flat = {t: [bank[t + "_A"][li].permute(1, 0, 2).reshape(din, -1).contiguous()
                for li in range(mc.num_layers)] for t, (din, _) in dims.items()}
    sides = {
        "bank_layout": lambda li, t: torch.matmul(xs[t][None], bank[t + "_A"][li]),
        "in_by_rows_layout": lambda li, t: xs[t] @ flat[t][li],
    }
    for name, fn in sides.items():
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for li in range(mc.num_layers):
                    for t in dims:
                        fn(li, t)
                torch.cuda.synchronize()
        res[f"decode_B8_A_side_{name}"] = _busy(prof)
    return res


def _busy(prof) -> dict:
    """Device busy ms, kernel count and the longest kernels of a
    torch.profiler session."""
    from torch.autograd import DeviceType

    kern = sorted(((a.key[:70], a.self_device_time_total / 1e3, a.count)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0),
                  key=lambda k: -k[1])
    return {"profiled_busy_ms": sum(k[1] for k in kern), "kernels": sum(k[2] for k in kern),
            "by_kernel": [{"kernel": k, "ms": ms, "count": c} for k, ms, c in kern[:8]]}


def serve() -> dict:
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.lora import write_peft_checkpoint
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.tools.time_decode_variants import serve_rounds

    mc = llama_3_1_8b()
    params = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "build",
                        "lora_profile_adapters")
    paths = [os.path.join(root, n) for n in "ab"]
    for i, p in enumerate(paths):
        write_peft_checkpoint(p, mc, rank=16, alpha=32, seed=i + 1, std=0.02)
    out = []
    try:
        for turn, lora in enumerate((False, True, True, False)):
            ec = EngineConfig(max_slots=8, max_seq_len=2048, page_size=64)
            eng = Engine(mc, params, ByteTokenizer(), ec, device="cuda")
            adapters = (None,)
            if lora:
                for name, p in zip("ab", paths):
                    eng.load_adapter(name, p)
                adapters = ("a", "b")
            eng.start()
            try:
                serve_rounds(eng, rounds=1, max_tokens=32, adapters=adapters)  # capture, growth
                rounds = serve_rounds(eng, rounds=2, adapters=adapters)
            finally:
                eng.stop()
            for r in rounds:
                del r["ids"], r["gaps"]
            out.append({"turn": turn, "adapters": list(adapters),
                        "capture_s": dict(eng.graph_capture_seconds),
                        "rounds": [{k: r.get(k) for k in (
                            "step_wall_ms", "chunk_device_ms", "agg_tok_s", "stream_tok_s",
                            "ttft_s", "graph_chunks", "chunks")} for r in rounds]})
            del eng
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"turns": out}


def first_load() -> dict:
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.lora import write_peft_checkpoint
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.tools.time_decode_variants import serve_rounds

    mc = llama_3_1_8b()
    params = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "build",
                        "lora_profile_adapters")
    paths = [os.path.join(root, n) for n in "ab"]
    for i, p in enumerate(paths):
        write_peft_checkpoint(p, mc, rank=16, alpha=32, seed=i + 1, std=0.02)
    out = []
    try:
        for turn in range(2):
            ec = EngineConfig(max_slots=8, max_seq_len=2048, page_size=64)
            eng = Engine(mc, params, ByteTokenizer(), ec, device="cuda")
            eng.start()
            try:
                serve_rounds(eng, rounds=1, max_tokens=32)
                before = dict(eng.graph_capture_seconds)
                load_s = {}
                for name, p in zip("ab", paths):
                    t0 = time.monotonic()
                    eng.load_adapter(name, p)
                    load_s[name] = time.monotonic() - t0
                serve_rounds(eng, rounds=1, max_tokens=32, adapters=("a", "b"))
            finally:
                eng.stop()
            out.append({"engine": turn, "capture_s_before_load": before,
                        "load_adapter_s": load_s,
                        "capture_s_after_load": dict(eng.graph_capture_seconds)})
            del eng
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"engines": out}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("lora_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    print(smi.stdout.strip(), flush=True)
    t0 = time.monotonic()
    if "--first-load" in argv:
        print("first_load", json.dumps(first_load()), flush=True)
        print(f"lora_profile: {time.monotonic() - t0:.1f}s", flush=True)
        return 0
    print("deltas", json.dumps(deltas()), flush=True)
    if "--no-serve" not in argv:
        print("serve", json.dumps(serve()), flush=True)
    print(f"lora_profile: {time.monotonic() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.exit(main(sys.argv[1:]))
