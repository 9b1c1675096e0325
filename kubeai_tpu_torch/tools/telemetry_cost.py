#!/usr/bin/env python3
"""What the engine's telemetry costs a decode step, on one card at
Llama-3.1-8B's widths.

    python3 kubeai_tpu_torch/tools/telemetry_cost.py [--turns 2]

One bf16 engine server (32 layers, random weights from seed 0, byte
tokenizer, 8 slots, page 64, the ragged kernel, CUDA graphs), the same
as chip_smoke's serving-ops server, serves rounds of chip_smoke's
telemetry traffic (``_tenant_round``: 8 greedy 128-token streams of one
211-token prompt, 3 of tenant a and 5 of tenant b, each with a
traceparent) under three modes, in turns (off, external, in-process,
in-process, external, off; *turns* times):

- ``off``: no history sampler, no OTLP exporter;
- ``external``: the sampler every 0.25 s and the exporter posting to a
  collector in another process (benchmarks/otlp_stub.py's);
- ``in_process``: the same, with the collector a thread of this process
  (as chip_smoke runs it: it parses every POST under the same GIL as
  the scheduler).

Per round: the median wall (dispatch to fetch) and device time (CUDA
events) per decode step over the graphed chunks that ran all 8 slots
(chip_smoke's ``_step_from_log``). Prints the card's ``nvidia-smi`` name
and power limit, one JSON line per round, then one line of the medians
per mode. Run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
MODES = ("off", "external", "in_process")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from benchmarks.otlp_stub import StubCollector
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.obs.history import RegistrySampler
    from kubeai_tpu_torch.obs.otel import OtelExporter, install_exporter, uninstall_exporter

    if not torch.cuda.is_available():
        print("telemetry_cost: no CUDA device is available", file=sys.stderr)
        return 1
    print(cs.gpu_line(), flush=True)
    ext = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time; sys.path.insert(0, sys.argv[1]);"
         "from benchmarks.otlp_stub import StubCollector;"
         "s = StubCollector().start(); print(s.endpoint, flush=True); time.sleep(3600)", ROOT],
        stdout=subprocess.PIPE, text=True)
    inproc = StubCollector().start()
    srv = None
    try:
        endpoints = {"external": ext.stdout.readline().strip(), "in_process": inproc.endpoint}
        mc = llama_3_1_8b()
        params = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0),
                                   device="cuda")
        eng = Engine(mc, params, ByteTokenizer(),
                     EngineConfig(max_slots=8, max_seq_len=2048, page_size=64), device="cuda")
        srv = EngineServer(eng, "telemetry-cost", host="127.0.0.1", port=0)
        srv.start()  # installs the history store and a 5 s sampler
        srv._history_sampler.stop()
        srv._history_sampler = None
        cs._http(srv.port, "/v1/completions", {"prompt": "warm", "max_tokens": 4})
        cs._tenant_round(srv, 0)  # capture, prefix pages, first-use costs

        def turn_on(mode):
            exp = OtelExporter(endpoints[mode], service="kubeai-engine").start()
            install_exporter(exp)
            sampler = RegistrySampler(srv._history, interval_seconds=0.25)
            sampler.start()
            return exp, sampler

        def turn_off(on):
            if on is not None:
                exp, sampler = on
                sampler.stop()
                exp.stop()
                uninstall_exporter(exp)

        order = [m for _ in range(args.turns)
                 for m in ("off", "external", "in_process", "in_process", "external", "off")]
        rounds = []
        for i, mode in enumerate(order, start=1):
            on = None if mode == "off" else turn_on(mode)
            try:
                t0 = time.monotonic()
                cs._tenant_round(srv, i)
                step = cs._step_from_log(srv, t0, len(cs.TELEMETRY_TENANTS))
            finally:
                turn_off(on)
            rounds.append({"round": i, "mode": mode, **step})
            print("round", json.dumps(rounds[-1]), flush=True)
        summary = {}
        for mode in MODES:
            rs = [r for r in rounds if r["mode"] == mode]
            summary[mode] = {"rounds": len(rs),
                             "wall_ms": float(np.median([r["wall_ms"] for r in rs])),
                             "device_ms": float(np.median([r["device_ms"] for r in rs])),
                             "wall_ms_each": [r["wall_ms"] for r in rs]}
        for mode in ("external", "in_process"):
            summary[mode]["wall_over_off"] = summary[mode]["wall_ms"] / summary["off"]["wall_ms"]
        print("summary", json.dumps(summary), flush=True)
    finally:
        if srv is not None:
            srv.stop()
        inproc.stop()
        ext.kill()
        ext.wait(timeout=30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
