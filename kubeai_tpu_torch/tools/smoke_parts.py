#!/usr/bin/env python3
"""Run one part of chip_smoke.py alone on the card.

    python3 kubeai_tpu_torch/tools/smoke_parts.py serving
    python3 kubeai_tpu_torch/tools/smoke_parts.py loader
    python3 kubeai_tpu_torch/tools/smoke_parts.py sharded
    python3 kubeai_tpu_torch/tools/smoke_parts.py chaos

``serving``: phase 1 (the kernel build), then phase 4 with the wall of
each of its parts (each serving run, the graph turns and profiles, the
LoRA runs, the step profiles, each family, the checkpoint and tiny runs)
printed as ``PART <function>[<run>] <seconds>s``. ``loader``: the
4-layer checkpoint at Llama-3.1-8B width, the cache loader in a child
process, then ``phase_loader`` (the ``operator``, ``operator_loops``
and ``kube`` runs, their pods on the loader's library directory; this
process builds its own, as phase 1 would). ``sharded``: phase 10
(tools/sharded_check.py) with its step and moe parts on each of
SHARDED_BACKENDS, alone and then beside phase 1's kernel build; each
wall printed as ``PART sharded[...]``. ``chaos``: phase 1, the chaos
path's kernel cases (``_chaos_cases``), then the campaign's child
process (``start_chaos``, ``phase_chaos``) alone.
Each prints chip_smoke's own lines. Run from the repository root, where
chip_smoke.py is.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import sys
import time

# Phase 4's parts, and where a call's run name sits.
SERVING_PARTS = ("_serve_once", "_graph_turns", "_serve_lora", "_graph_profiles",
                 "_step_profile", "_lora_step_profile", "_serve_families",
                 "_family_step_profile", "_serve_checkpoint", "_serve_tiny",
                 "_calibrate_int8_pool", "_serve_spm")
# The step and moe parts' backends in the ``sharded`` part's runs.
SHARDED_BACKENDS = ("gloo", "threads")


def _run_name(name: str, args: tuple, kwargs: dict) -> str:
    if "run" in kwargs:
        return kwargs["run"]
    if name in ("_family_step_profile", "_serve_tiny") and args:
        return args[0]
    if name == "_serve_once" and len(args) > 1:
        return args[1]  # the decode kernel
    return ""


def _time_parts(cs) -> None:
    """Wrap each of chip_smoke's SERVING_PARTS so that a call logs its
    wall (chip_smoke calls them through its module globals)."""
    for name in SERVING_PARTS:
        fn = getattr(cs, name)

        @functools.wraps(fn)
        def timed(*a, _fn=fn, _name=name, **k):
            t0 = time.monotonic()
            try:
                return _fn(*a, **k)
            finally:
                cs.log(f"PART {_name}[{_run_name(_name, a, k)}] {time.monotonic() - t0:.1f}s")

        setattr(cs, name, timed)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("part", choices=("serving", "loader", "sharded", "chaos"))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    cs.log(cs.gpu_line())
    t0 = time.monotonic()
    if args.part == "serving":
        _time_parts(cs)
        cs.phase_env()
        cs.log(f"PART phase_env {time.monotonic() - t0:.1f}s")
        t1 = time.monotonic()
        cs.phase_serving()
        cs.log(f"PART phase_serving {time.monotonic() - t1:.1f}s")
        return 0
    if args.part == "chaos":
        cs.phase_env()
        cs._chaos_cases(lambda name, case, err, ms, plain_ms, nbytes, flops, lib_ms, *a, **k:
                        cs.log("kernel_case", json.dumps({
                            "kernel": name, "case": case, "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": cs._bound(nbytes, flops, "f32")[0],
                            "library_ms": lib_ms})))
        t1 = time.monotonic()
        cs.log(json.dumps(cs.phase_chaos(cs.start_chaos())))
        cs.log(f"PART chaos {time.monotonic() - t1:.1f}s")
        return 0
    from kubeai_tpu_torch.ops import _build

    if args.part == "sharded":
        _sharded_runs(cs, _build)
        return 0

    build = os.path.join(os.getcwd(), "build")
    ckpt = os.path.join(build, f"ckpt_8b_width_{cs.COLDSTART_LAYERS}_layers")
    work = os.path.join(build, "loader_run")
    shutil.rmtree(work, ignore_errors=True)
    cs.log("checkpoint written in", cs._write_width_checkpoint(ckpt), "s")
    run = cs._start_loader(ckpt, work)
    run.update(ckpt=ckpt, spawn={"spawn_to_ready_s": None, "phases": {}})
    cs.log(json.dumps(cs.phase_loader(run)))
    cs.log(f"PART loader {time.monotonic() - t0:.1f}s")
    return 0


def _sharded_runs(cs, _build) -> None:
    """The ``sharded`` part: phase 10's wall for each of SHARDED_BACKENDS,
    alone and beside phase 1's build. A run over phase 10's budget is
    logged, not raised, so every run is made."""
    for beside in (False, True):
        for backend in SHARDED_BACKENDS:
            label = f"{backend}{', beside the build' if beside else ''}"
            run = cs.start_sharded_train(("--mesh-backend", backend))
            if beside:
                t0 = time.monotonic()
                _build.build(list(cs.KERNELS + cs.VARIANTS), ptxas_verbose=True)
                cs.log(f"PART build[beside {backend}] {time.monotonic() - t0:.1f}s")
            try:
                cs.phase_sharded_train(run)
            except AssertionError as e:
                cs.log(f"sharded[{label}]: {str(e)[:300]}")
            cs.log(f"PART sharded[{label}] "
                   f"{run.get('t_end', time.monotonic()) - run['t0']:.1f}s")


if __name__ == "__main__":
    sys.exit(main())
