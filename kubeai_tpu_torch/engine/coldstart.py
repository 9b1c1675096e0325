"""Cold start on the card: phase stamps, the kernel-library cache, and the
background warm of an engine's kernels (port of
kubeai_tpu/engine/coldstart.py).

On CUDA the JAX engine's "compile" has two parts: the nvcc builds of the
hand-written kernels with their first load (ops/_build.py), and the decode
chunk's graph capture (Engine.warmup). This module pays the first part
from the config alone, so it can run before the weights exist:

- ``setup_compile_cache()`` — the ONE place ``KUBEAI_COMPILE_CACHE`` is
  honoured: it points ops/_build.py's library directory at that path, so
  a mount every replica shares turns first-use nvcc builds into file
  reads.
- ``ColdStartTimeline`` — per-phase stamps (stage / load / compile /
  build / warmup, then ready) in ``/debug/engine`` and the
  ``kubeai_engine_cold_start_seconds{phase}`` histogram. A phase sum past
  the span is the evidence that load and compile overlapped.
- ``warm_compile()`` / ``warm_from_checkpoint()`` — build exactly the
  libraries a config's serving path loads (``_build.serving_libraries``),
  then load each and load every kernel in it onto the card.
- ``start_background_warm()`` — run that warm on a thread while the
  weights stream, so a start costs about max(load, compile), not the sum.
- ``park()`` — a parked replica's warm: the libraries, then an engine over
  zero weights at the config's shapes whose warmup captures the decode
  graph. An attach with the same configuration adopts that engine and
  copies its weights in place (``Engine.load_params_``): the captured
  graph holds the parameters' addresses.

A warm never hides a kernel: a library it failed to build is built again
before the engine is (``require_libraries``), and that build raises.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import torch

from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.obs.logs import get_logger
from kubeai_tpu_torch.ops import _build

log = get_logger("kubeai_tpu_torch.engine.coldstart")

# Engine starts span milliseconds (tiny CPU tests) to minutes (big
# checkpoints with a first nvcc build): the default buckets resolve
# neither end.
_COLD_START_BUCKETS = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600)

M_COLD_START = default_registry.histogram(
    "kubeai_engine_cold_start_seconds",
    "engine start phase durations, labeled phase=stage|load|compile|"
    "build|warmup plus phase=ready (total start-to-serving wall "
    "clock); phase sums exceeding their span mean phases overlapped",
    buckets=_COLD_START_BUCKETS,
)


def setup_compile_cache(cache_dir: str | None = None) -> str | None:
    """Point the kernel-library directory at *cache_dir* (default: the
    ``KUBEAI_COMPILE_CACHE`` env var; no-op returning None when neither is
    set). Every entry point calls it (the CLI server, in-process engines
    through load_engine_from_path), so a shared mount serves them all.
    Safe to call repeatedly. JAX's ``KUBEAI_COMPILE_CACHE_MIN_SECS`` has
    no counterpart: every library build is kept."""
    cache_dir = cache_dir or os.environ.get("KUBEAI_COMPILE_CACHE")
    if not cache_dir:
        return None
    _build.set_library_dir(cache_dir)
    return cache_dir


def compile_cache_dir() -> str | None:
    """The library directory when setup_compile_cache moved it, else None."""
    d = _build.library_dir()
    return None if d == _build.BUILD_DIR else str(d)


class ColdStartTimeline:
    """Thread-safe per-phase stamps for one engine start.

    Phases may overlap (the compile phase runs on a background thread
    while the weights stream on the caller's), so stamps are independent
    begin/end pairs, not a stack. ``install()`` makes the timeline visible
    at ``/debug/engine`` under ``cold_start``."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.t0_mono = clock()
        self.t0_wall = time.time()
        self._phases: dict[str, dict] = {}
        self.ready_mono: float | None = None
        self.attrs: dict = {}

    def begin(self, name: str) -> None:
        with self._lock:
            self._phases.setdefault(name, {})["start"] = self._clock()

    def end(self, name: str) -> None:
        now = self._clock()
        with self._lock:
            ph = self._phases.setdefault(name, {})
            ph.setdefault("start", now)
            ph["end"] = now
            dur = ph["end"] - ph["start"]
        M_COLD_START.observe(dur, labels={"phase": name})

    @contextmanager
    def phase(self, name: str):
        self.begin(name)
        try:
            yield self
        finally:
            self.end(name)

    def ready(self) -> None:
        """Stamp serving readiness; observes the total wall clock as
        phase="ready" (idempotent: the first stamp wins)."""
        with self._lock:
            if self.ready_mono is not None:
                return
            self.ready_mono = self._clock()
            total = self.ready_mono - self.t0_mono
        M_COLD_START.observe(total, labels={"phase": "ready"})

    def snapshot(self) -> dict:
        with self._lock:
            phases = {k: dict(v) for k, v in self._phases.items()}
            ready = self.ready_mono
        out_phases = {}
        intervals: list[tuple[float, float]] = []
        phase_sum = 0.0
        for name, ph in phases.items():
            start = ph.get("start")
            end = ph.get("end")
            rec = {"start_s": round(start - self.t0_mono, 4)}
            if end is not None:
                rec["end_s"] = round(end - self.t0_mono, 4)
                rec["duration_s"] = round(end - start, 4)
                phase_sum += end - start
                intervals.append((start, end))
            out_phases[name] = rec
        out = {
            "t0_unix": round(self.t0_wall, 3),
            "phases": out_phases,
            "phase_sum_s": round(phase_sum, 4),
            "attrs": dict(self.attrs),
        }
        if intervals:
            # Interval-union coverage: sum - union is the time at least two
            # phases ran concurrently (gaps between serial phases must not
            # mask it, as a span-based difference would).
            union = 0.0
            cur_s, cur_e = None, None
            for s, e in sorted(intervals):
                if cur_e is None or s > cur_e:
                    union += cur_e - cur_s if cur_e is not None else 0.0
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            union += cur_e - cur_s
            out["span_s"] = round(max(e for _, e in intervals) - min(s for s, _ in intervals), 4)
            out["overlap_s"] = round(max(phase_sum - union, 0.0), 4)
        if ready is not None:
            out["ready_s"] = round(ready - self.t0_mono, 4)
        return out

    def install(self) -> "ColdStartTimeline":
        """Expose this timeline at /debug/engine (the latest install wins:
        a parked replica's attach installs a fresh timeline over the
        park's)."""
        from kubeai_tpu_torch.obs.recorder import register_engine_debug_section

        register_engine_debug_section("cold_start", self.snapshot)
        return self


# ---------------------------------------------------------------------------
# Shapes and libraries from the config alone.


def param_shapes(model_config, quantization: str = ""):
    """The engine's parameter tree as ``meta`` tensors (shapes and dtypes,
    nothing allocated), from the model config alone: llama.init_params
    builds the same tree the checkpoint loader does, and int8 runs the
    same quantize_model_params. The config must carry the padded vocab."""
    from kubeai_tpu_torch.engine.weights import quantize_model_params
    from kubeai_tpu_torch.models import llama

    params = llama.init_params(model_config, None, device="meta")
    if quantization == "int8":
        params = quantize_model_params(params, model_config)
    return params


def zero_params(model_config, quantization: str, device) -> dict:
    """param_shapes' tree as zeros on *device*: a parked engine's weights
    until an attach copies the model's in (zeros, not empty memory: no
    NaN logits reach the sampler)."""
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    return zeros(param_shapes(model_config, quantization))


def runs_kernels(device) -> bool:
    """Whether an engine on *device* launches the CUDA kernels (the CPU
    runs each wrapper's plain version and builds nothing)."""
    return torch.device(device).type == "cuda"


def _signatures(name: str) -> dict:
    """The ctypes signatures of library *name*, from its wrapper module."""
    from kubeai_tpu_torch.ops import flash_attention, paged_attention, paged_decode_attention, quant

    src = _build.VARIANTS.get(name, (name,))[0]
    return {"flash_attention": flash_attention._SIG, "paged_attention": paged_attention._SIG,
            "paged_decode_attention": paged_decode_attention._SIG,
            "w8a16_matmul": quant._SIG}[src]


def warm_compile(model_config, engine_config=None, quantization: str = "",
                 device=None) -> dict:
    """Build the libraries an engine on *device* (default cuda) over
    *model_config* and *engine_config* loads (``_build.serving_libraries``:
    one nvcc per library, in parallel; a library already in the library
    directory is read), then load each and every kernel in it onto the
    card. Returns {"libraries", "built" (seconds of each library compiled
    here), "loaded", "preloaded" (kernels per library), "missing",
    "seconds"} and "errors" when any failed; failures are collected, not
    raised (require_libraries raises them). On the CPU it builds nothing
    and says so under "skipped"."""
    from kubeai_tpu_torch.engine.core import EngineConfig

    cfg = engine_config or EngineConfig()
    t0 = time.monotonic()
    names = _build.serving_libraries(model_config, cfg, quantization)
    dev = torch.device("cuda" if device is None else device)
    out: dict = {"libraries": names, "built": {}, "loaded": [], "preloaded": {}}
    if not runs_kernels(dev):
        out["skipped"] = f"no kernels on {dev.type}"
        out["missing"] = []
        out["seconds"] = round(time.monotonic() - t0, 3)
        return out
    errors: list[str] = []
    try:
        res = _build.build(names)
    except Exception:
        # One build at a time tells which failed (the others are files now).
        res = {}
        for name in names:
            try:
                res.update(_build.build([name]))
            except Exception as e:
                log.warning("warm build of %s failed: %s", name, e)
                errors.append(f"{name}: {e}")
    out["built"] = {n: round(r.seconds, 3) for n, r in res.items() if r.seconds > 0}
    for name in names:
        if name not in res:
            continue
        try:
            lib = _build.load(name, _signatures(name))
            out["preloaded"][name] = _build.preload(lib, dev)
            out["loaded"].append(name)
        except Exception as e:
            log.warning("warm load of %s failed: %s", name, e)
            errors.append(f"{name}: {e}")
    out["missing"] = [n for n in names if n not in out["loaded"]]
    out["seconds"] = round(time.monotonic() - t0, 3)
    if errors:
        out["errors"] = errors
    log.info("warm compile: %d libraries (%d built) in %.1fs (%d failed)",
             len(names), len(out["built"]), out["seconds"], len(out["missing"]))
    return out


def require_libraries(stats: dict | None) -> None:
    """Build again, raising on failure, every library a warm left
    missing: a kernel that cannot build fails the start here, never
    leaving an engine without it."""
    missing = (stats or {}).get("missing")
    if missing:
        _build.build(list(missing))


# ---------------------------------------------------------------------------
# What a command line starts.


@dataclass
class StartSpec:
    """An engine's configuration as a start resolves it before any weight
    is read: the model config as served (padded vocab, tie resolved), the
    engine config, the quantization, the tokenizer and the device. Two
    starts with equal keys run the same kernels at the same shapes."""

    model_config: Any
    engine_config: Any
    quantization: str
    tokenizer: Any
    device: torch.device
    # Whether a park engine may be adopted for this spec: not where the
    # config is known only once the weights are read (a .bin checkpoint),
    # nor for a test: model, whose start has no phases (as in JAX).
    adoptable: bool = True

    def n_valid_vocab(self) -> int:
        V = self.model_config.vocab_size
        return min(getattr(self.tokenizer, "vocab_size", V), V)

    def key(self) -> tuple:
        return (self.model_config, self.engine_config, self.quantization,
                self.n_valid_vocab(), str(self.device))


def start_spec(model: str, engine_args: list[str] | None = None, device=None):
    """(StartSpec, parsed args) of *model* (what ``--model`` takes: a
    checkpoint directory, ``preset:NAME`` or ``test:NAME``) under the
    engine-server arguments *engine_args* (on *device* unless they name
    one; default cuda), through the server's own parser and the loader's
    config pipeline (dtype, tie fallback, padded vocab), so a warm can
    never drift from the start it prepares."""
    from kubeai_tpu_torch import resolve_device
    from kubeai_tpu_torch.engine import core
    from kubeai_tpu_torch.engine.server import engine_config_from_args, make_arg_parser
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.engine.weights import open_checkpoint
    from kubeai_tpu_torch.loader import stage_model

    args, unknown = make_arg_parser(require_model=False).parse_known_args(
        list(engine_args or []) + ["--model", model])
    if unknown:
        log.info("start spec ignoring unknown args: %s", unknown)
    ec = engine_config_from_args(args)
    dev = resolve_device(args.device or device)
    if model.startswith("test:"):
        return StartSpec(core.test_model_config(), ec, args.quantization, ByteTokenizer(), dev,
                         adoptable=False), args
    if model.startswith("preset:"):
        return StartSpec(core.preset_config(model[len("preset:"):]), ec, args.quantization,
                         ByteTokenizer(), dev), args
    config, tokenizer, source = open_checkpoint(stage_model(model),
                                                tp=args.tensor_parallel_size)
    return StartSpec(config, ec, args.quantization, tokenizer, dev,
                     adoptable=source is not None), args


def warm_from_checkpoint(path: str, engine_args: list[str] | None = None) -> dict:
    """Warm the libraries of the model at *path* (a checkpoint directory,
    whose config.json and tokenizer alone are read, or ``preset:NAME`` /
    ``test:NAME``) under the engine-server arguments *engine_args* (the
    Model's pod args), so the warmed libraries are the ones a serving
    pod started with those args loads."""
    spec, _ = start_spec(path, engine_args)
    return warm_compile(spec.model_config, spec.engine_config, spec.quantization, spec.device)


def park(path: str, engine_args: list[str] | None, timeline: ColdStartTimeline):
    """A parked replica's warm for the model at *path*: warm_from_checkpoint's
    libraries (phase "compile"), then, where the spec is adoptable, an
    engine over zero weights at its shapes with its KV pool (phase
    "build"), warmed up (phase "warmup": on CUDA the decode graph's
    capture). Returns (stats,
    engine or None); the engine carries ``park_key``, the key an attach
    must match to adopt it."""
    from kubeai_tpu_torch.engine.core import Engine

    spec, _ = start_spec(path, engine_args)
    with timeline.phase("compile"):
        stats = warm_compile(spec.model_config, spec.engine_config, spec.quantization,
                             spec.device)
    timeline.attrs["warm_compile"] = stats
    if not spec.adoptable:
        return stats, None
    require_libraries(stats)
    with timeline.phase("build"):
        t0 = time.monotonic()
        params = zero_params(spec.model_config, spec.quantization, spec.device)
        stats["zero_params_s"] = round(time.monotonic() - t0, 4)
        eng = Engine(spec.model_config, params, spec.tokenizer, spec.engine_config,
                     device=spec.device)
        del params
    with timeline.phase("warmup"):
        stats["warmup"] = timeline.attrs["warmup"] = eng.warmup()
    stats["capture_s"] = dict(eng.graph_capture_seconds)
    stats["capture_segments"] = dict(eng.graph_capture_segments)
    eng.park_key = spec.key()
    return stats, eng


# ---------------------------------------------------------------------------
# Background warm: build while the weights stream.


class BackgroundWarm:
    """Handle to a warm running on a daemon thread. With a *timeline* the
    compile phase spans the thread's life; join() returns the warm's
    stats, or the error as a stats dict: a warm failure never raises on
    the caller's thread (require_libraries decides what it costs)."""

    def __init__(self, fn, timeline: ColdStartTimeline | None = None):
        self.result: dict | None = None
        self._timeline = timeline
        if timeline is not None:
            # The compile phase begins as the thread launches: the builds
            # start concurrently with the caller's weight stream.
            timeline.begin("compile")

        def run():
            try:
                self.result = fn()
            except Exception as e:
                log.warning("background warm failed: %s", e)
                self.result = {"libraries": [], "error": str(e)}
            finally:
                if timeline is not None:
                    timeline.end("compile")

        self._thread = threading.Thread(target=run, name="coldstart-warm", daemon=True)
        self._thread.start()

    def join(self, timeout: float | None = None) -> dict | None:
        self._thread.join(timeout)
        return self.result


def start_background_warm(model_config, engine_config, quantization: str = "",
                          timeline: ColdStartTimeline | None = None,
                          device=None) -> BackgroundWarm:
    return BackgroundWarm(
        lambda: warm_compile(model_config, engine_config, quantization=quantization,
                             device=device),
        timeline=timeline,
    )


def start_engine(spec: StartSpec, load, timeline: ColdStartTimeline | None = None,
                 overlap: bool | None = None, warmup: bool | None = None, park_engine=None,
                 tp_group=None, publisher=None):
    """Start an engine for *spec* with its phases on *timeline* (a fresh
    one, installed, when None): ``compile`` (the background warm, started
    before the weights when *overlap*), ``load`` (``load()`` returns
    (params, model config)), ``build`` (the Engine) and ``warmup``.

    *overlap* None reads ``KUBEAI_COLDSTART_OVERLAP``: auto (overlap when
    a compile cache is set, the one regime where an early build pays
    for every replica), 1 or 0. *warmup* None reads
    ``KUBEAI_ENGINE_WARMUP=1``. A *park_engine* whose ``park_key`` equals
    the spec's is adopted instead: the weights load into it in place and
    its park-time warmup stands (``attrs.adopted_park_engine``).

    A gang rank (*tp_group*, and on rank 0 the gang's *publisher*) builds
    its engine over its shard with no warmup and no overlap, as the JAX
    loader starts a gang: the libraries load from the compile cache at
    first use."""
    from kubeai_tpu_torch.engine.core import Engine

    setup_compile_cache()
    timeline = (timeline or ColdStartTimeline()).install()
    if tp_group is not None:
        if park_engine is not None:
            raise ValueError("a parked engine cannot be adopted by a gang rank")
        overlap = warmup = False
    if park_engine is not None:
        adopt = spec.adoptable and getattr(park_engine, "park_key", None) == spec.key()
        timeline.attrs["adopted_park_engine"] = adopt
        if adopt:
            with timeline.phase("load"):
                params, _ = load()
            with timeline.phase("build"):
                park_engine.load_params_(params)
                park_engine.tokenizer = spec.tokenizer
            del params
            timeline.attrs["warmup"] = park_engine.warmup_result
            park_engine.cold_start_timeline = timeline
            return park_engine
    if overlap is None:
        knob = os.environ.get("KUBEAI_COLDSTART_OVERLAP", "auto")
        overlap = knob == "1" or (knob != "0" and compile_cache_dir() is not None)
    if warmup is None:
        warmup = os.environ.get("KUBEAI_ENGINE_WARMUP", "0") == "1"
    warmer = None
    if overlap:
        warmer = start_background_warm(spec.model_config, spec.engine_config,
                                       spec.quantization, timeline=timeline, device=spec.device)
    with timeline.phase("load"):
        params, config = load()
    if warmer is not None:
        # The Engine's first launches must not race the builds; by now the
        # warm has had the whole load to run.
        stats = warmer.join()
        timeline.attrs["warm_compile"] = stats
        require_libraries(stats)
    timeline.begin("build")
    eng = Engine(config, params, spec.tokenizer, spec.engine_config, device=spec.device,
                 tp_group=tp_group, publisher=publisher)
    timeline.end("build")
    if warmup:
        with timeline.phase("warmup"):
            timeline.attrs["warmup"] = eng.warmup()
        timeline.attrs["capture_segments"] = dict(eng.graph_capture_segments)
    eng.cold_start_timeline = timeline
    return eng
