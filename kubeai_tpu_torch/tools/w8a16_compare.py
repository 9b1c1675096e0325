#!/usr/bin/env python3
"""Side-by-side measurements of the W8A16 kernels on one card.

    python3 kubeai_tpu_torch/tools/w8a16_compare.py turns DIR [DIR ...]
    python3 kubeai_tpu_torch/tools/w8a16_compare.py steps
    python3 kubeai_tpu_torch/tools/w8a16_compare.py ablate

``turns``: each DIR holds a copy of ``chip_smoke.py`` and
``kubeai_tpu_torch/`` (the parent's package, or this one); the copies run
in the order given, each in its own process from its own directory, so
each builds its own kernels (list them in turns, a b b a). Every run
checks and times qdot at Llama-3.1-8B's projections for M = 8, 16, 32, 64
and 1024 rows and the untied and tied heads at M = 8 (chip_smoke's
``timed_ms``, cold L2 up to 64 rows) and prints one ``turn DIR {case:
ms}`` line.

``steps``: the int8 decode, verify and 1024-token chunk steps of the
32-layer model (B = 8, kv 512; random weights from seed 0) with the
projections that share x in one launch (qdot_many) and as separate
launches, in turns: torch.profiler's device busy time, kernel count and
the W8A16 kernels' time and launches.

``ablate``: builds variants of ``csrc/w8a16_matmul.cu`` whose wgmma tile
skips the widening, the products or both (wrong results on purpose) and
times them beside the kernel at 64 and 1024 rows, in turns.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

SHAPES = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wg", 4096, 14336), ("wd", 14336, 4096))
ROWS = (8, 16, 32, 64, 1024)


def turn(tag: str) -> None:
    """Time the package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from kubeai_tpu_torch.ops import quant

    out = {}
    for name, K, N in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        w = quant.quantize(torch.randn((K, N), generator=g, device="cuda") * K**-0.5)
        for M in ROWS:
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            c.compare(quant.qdot(x, w), (x.float() @ w["int8_q"].float()) * w["int8_s"], name)
            out[f"{name} M={M}"] = c.timed_ms(lambda: quant.qdot(x, w), cold_l2=M <= 64)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((8, 4096), generator=g, device="cuda").to(torch.bfloat16)
    for name, fn, quantize, shape in (("lm_head", quant.qdot, quant.quantize, (4096, 128256)),
                                      ("tied head", quant.qmatT, quant.quantize_rows, (128256, 4096))):
        w = quantize(torch.randn(shape, generator=g, device="cuda") * 4096**-0.5)
        out[f"{name} M=8"] = c.timed_ms(lambda: fn(x, w), cold_l2=True)
        del w
    print("turn", tag, c.gpu_line(), json.dumps(out), flush=True)


def steps() -> None:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from kubeai_tpu_torch.engine.weights import quantize_model_params
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.ops import quant

    mc = llama_3_1_8b(use_flash_prefill=True, use_paged_kernel=True)
    p = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    qp = quantize_model_params(p, mc)
    del p
    torch.cuda.empty_cache()
    B, page, mp = 8, 64, 32
    pool = llama.init_paged_cache(mc, 1 + B * mp, page, "cuda")
    table = torch.arange(1, 1 + B * mp, dtype=torch.int32, device="cuda").reshape(B, mp)
    tok = torch.randint(0, 259, (B, 1), device="cuda")
    spec = torch.randint(0, 259, (B, 8), device="cuda")
    chunk = torch.randint(0, 259, (1, 1024), device="cuda")
    lengths = torch.full((B,), 512, device="cuda")
    start, last = torch.tensor([1024], device="cuda"), torch.tensor([1023], device="cuda")
    runs = {
        "decode": lambda: llama.decode_step_paged(qp, mc, tok, pool, table, lengths),
        "verify8": lambda: llama.decode_speculative_paged(qp, mc, spec, pool, table, lengths - 8,
                                                          decode_kernel="dedicated"),
        "chunk1024": lambda: llama.prefill_paged(qp, mc, chunk, pool, table[:1], start, last),
    }
    grouped = llama.qdot_many

    def separate(x, ws):
        return [quant.qdot(x, w) for w in ws]

    print(c.gpu_line(), flush=True)
    for name, fn in runs.items():
        for mode in ("grouped", "separate", "grouped", "separate"):
            llama.qdot_many = grouped if mode == "grouped" else separate
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            dev = [(a.key, a.self_device_time_total / 1e3, a.count) for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]
            w8 = [(k, t, n) for k, t, n in dev if "w8a16" in k]
            print("step", name, mode, json.dumps({
                "busy_ms": sum(t for _, t, _ in dev), "kernels": sum(n for _, _, n in dev),
                "w8a16_ms": sum(t for _, t, _ in w8), "w8a16_launches": sum(n for _, _, n in w8),
            }), flush=True)
    llama.qdot_many = grouped


# Source edits of each ablation of the wgmma tile.
ABLATIONS = {
    "no_widen": (("widen<BK, WBN>(in, out, pt);", ";"), ("widen<WBN, BK>(in, out, pt);", ";")),
    "no_wgmma": (("wgmma_step<LAYOUT, WBN>(acc, da, db);", ";"),),
}
ABLATIONS["skeleton"] = ABLATIONS["no_widen"] + ABLATIONS["no_wgmma"]


def ablate() -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from kubeai_tpu_torch.ops import _build, quant

    src = (_build.CSRC / "w8a16_matmul.cu").read_text()
    out = _build.BUILD_DIR / "w8a16_ablations"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in {"kernel": (), **ABLATIONS}.items():
        s = src
        for old, new in edits:
            if old not in s:
                raise RuntimeError(f"ablation {name}: {old!r} is not in the source")
            s = s.replace(old, new)
        (out / f"{name}.cu").write_text(s)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.w8a16_launch.argtypes = quant._SIG["w8a16_launch"]
        lib.w8a16_launch.restype = ctypes.c_int
        libs[name] = lib
    print(c.gpu_line(), flush=True)
    order = list(libs) + list(libs)[::-1]
    try:
        for cname, K, N in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(0)
            w = quant.quantize(torch.randn((K, N), generator=g, device="cuda") * K**-0.5)
            for M in (64, 1024):
                x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
                row = {}
                for name in order:
                    quant._lib = libs[name]
                    quant.qdot(x, w)
                    row.setdefault(name, []).append(
                        c.timed_ms(lambda: quant.qdot(x, w), cold_l2=M <= 64))
                print("ablate", cname, M, json.dumps(row), flush=True)
    finally:
        quant._lib = None


def main(argv: list[str]) -> int:
    if not argv or argv[0] not in ("turns", "turn", "steps", "ablate"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "turn":  # a child of `turns`, in its package's directory
        turn(argv[1])
    elif argv[0] == "turns":
        rc = 0
        for d in argv[1:]:
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "turn", d],
                                 cwd=d).returncode
        return rc
    elif argv[0] == "steps":
        steps()
    else:
        ablate()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
