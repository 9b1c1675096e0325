"""Perf X-ray (port of kubeai_tpu/obs/perf.py): roofline and MFU
accounting, stall attribution of the pipelined loop, and on-demand
profiler capture.

- **PerfModel**: FLOPs and weight bytes per decode token from a
  ModelConfig, against the card's peaks (``device_constants``: the
  published H100 SXM figures, 989 TFLOP/s bf16 dense and 3.35 TB/s; an
  unknown device or the CPU reads 0 MFU rather than an invented
  denominator).
- **TokenRateWindow**: the sliding-window tokens/s behind
  ``kubeai_engine_tokens_per_second``.
- **PipelineStallTracker**: the decode chunks' and prefills' host
  segments over a window, ``GET /debug/pipeline`` and
  ``kubeai_engine_stall_seconds_total{cause}``.
- **ProfilerCapture** + ``handle_perf_request``: ``GET /debug/profile
  ?seconds=N`` records a ``torch.profiler`` trace (CPU and, on a card,
  CUDA activity) into a Chrome trace file; single-flight, and opt-in via
  ``KUBEAI_DEBUG_PROFILE=1``. A running engine's own scheduler thread
  starts and stops the session (a session stopped on another thread
  while the engine launched a CUDA graph deadlocked on the H100). On a
  gang's rank 0 the capture first asks the followers for the same
  window through the dispatch stream (``Engine.broadcast_profile``;
  each follower writes ``<dir>-rank<r>/trace.json``).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass
from urllib.parse import parse_qs

from kubeai_tpu_torch.metrics import default_registry

log = logging.getLogger("kubeai_tpu_torch.obs.perf")

# ---------------------------------------------------------------------------
# Device constants: (peak dense bf16 FLOP/s, HBM GB/s) by a substring of
# the device name. The H100's are NVIDIA's data sheet (SXM part, 700 W);
# the CPU has none, so MFU and the roofline read 0 there.
DEVICE_CONSTANTS: dict[str, tuple[float | None, float | None]] = {
    "h100": (989e12, 3350.0),
    "cpu": (None, None),
}


@dataclass(frozen=True)
class DeviceEnv:
    """Resolved perf constants for one device. ``peak_flops`` /
    ``hbm_gbps`` are None when the device is unknown (or the CPU):
    MFU and the roofline then read 0 rather than inventing a
    denominator."""

    kind: str = ""
    peak_flops: float | None = None
    hbm_gbps: float | None = None


def device_constants(device_kind: str) -> DeviceEnv:
    """Match a device name (``torch.cuda.get_device_name``, e.g. "NVIDIA
    H100 80GB HBM3", or "cpu") against DEVICE_CONSTANTS by substring."""
    kl = str(device_kind).lower()
    peak, hbm = next((v for k, v in DEVICE_CONSTANTS.items() if k in kl), (None, None))
    return DeviceEnv(kind=str(device_kind), peak_flops=peak, hbm_gbps=hbm)


def detect_device(device=None) -> DeviceEnv:
    """DeviceEnv of *device* (a torch.device or name; the current CUDA
    device when None and one exists, else the CPU). Never raises: an
    unprobeable device is just unknown."""
    import torch

    try:
        dev = torch.device(device) if device is not None else torch.device(
            "cuda" if torch.cuda.is_available() else "cpu")
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    except (RuntimeError, AssertionError):
        kind = ""
    return device_constants(kind)


# ---------------------------------------------------------------------------
# Roofline / MFU accounting.

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def param_counts(mc) -> tuple[float, float]:
    """(total, active) parameter counts from a ModelConfig, analytically.
    Dense families have total == active; MoE counts every expert as
    resident (weight-read roofline: a batched decode step touches all
    experts) but only the routed top-k as active (FLOPs/token)."""
    D, F, L, V = mc.hidden_size, mc.intermediate_size, mc.num_layers, mc.vocab_size
    H, Kv, h = mc.num_heads, mc.num_kv_heads, mc.head_dim_
    attn = D * H * h + 2 * D * Kv * h + H * h * D
    if getattr(mc, "qkv_bias", False):
        attn += (H + 2 * Kv) * h
    mlp = 3 * D * F
    norms = 2 * D + (2 * D if getattr(mc, "post_norms", False) else 0)
    E = getattr(mc, "num_experts", 0)
    if E:
        k = mc.num_experts_per_tok
        router = D * E
        layer_total = attn + norms + E * mlp + router
        layer_active = attn + norms + k * mlp + router
    else:
        layer_total = layer_active = attn + norms + mlp
    embed = V * D
    head = 0 if getattr(mc, "tie_word_embeddings", False) else V * D
    fixed = embed + head + D
    return float(fixed + L * layer_total), float(fixed + L * layer_active)


@dataclass(frozen=True)
class PerfModel:
    """Per-model roofline constants, computed once. ``flops_per_token``
    is the standard decode estimate 2 * active params (attention adds a
    few % at seq <= 1k); ``weight_bytes`` is what one decode step must
    stream from HBM."""

    param_count: float  # resident params (weight-read roofline)
    active_params: float  # params touched per token (FLOPs)
    flops_per_token: float
    weight_bytes: float

    @classmethod
    def from_model_config(cls, mc, quantization: str = "", weight_bytes: float | None = None) -> "PerfModel":
        """*weight_bytes*, when given (measured off the live parameters),
        overrides the analytic estimate; otherwise params are costed at 1
        byte for int8 weight-only quantization, else the model dtype's
        width."""
        total, active = param_counts(mc)
        if weight_bytes is None:
            per_param = 1 if quantization == "int8" else _DTYPE_BYTES.get(mc.dtype, 2)
            weight_bytes = total * per_param
        return cls(
            param_count=total,
            active_params=active,
            flops_per_token=2.0 * active,
            weight_bytes=float(weight_bytes),
        )

    def step_floor_seconds(self, hbm_gbps: float) -> float:
        """Weight-read floor for ONE decode step (the whole batch shares
        the read, which is why batch is 'nearly free' until HBM fills)."""
        return self.weight_bytes / (hbm_gbps * 1e9)

    def roofline_tokens_per_sec(self, batch: int, hbm_gbps: float | None) -> float | None:
        """Output tok/s if decode were purely weight-read-bound at this
        batch size (None when the device bandwidth is unknown)."""
        if not hbm_gbps or batch <= 0:
            return None
        return batch / self.step_floor_seconds(hbm_gbps)

    def mfu(self, tokens_per_sec: float, peak_flops: float | None) -> float:
        """Model FLOPs utilization (fraction of peak) at a decode rate."""
        if not peak_flops:
            return 0.0
        return tokens_per_sec * self.flops_per_token / peak_flops


# ---------------------------------------------------------------------------
# Shared sliding-window token rate.


class TokenRateWindow:
    """Sliding-window rate over a cumulative count: the engine's goodput
    gauge (``add(n)`` per decode chunk). Samples are (t, cumulative
    total); rate = (last-first)/(t_last-t_0). The first sample only
    anchors the window: its tokens were produced before the window
    opened. (The JAX class's ``observe_total`` serves the operator's
    fleet collector, which the port does not have.)"""

    def __init__(self, span: float = 10.0, clock=time.monotonic):
        self.span = span
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: deque[tuple[float, float]] = deque()
        self._total = 0.0

    def add(self, n: float, now: float | None = None) -> None:
        with self._lock:
            self._total += n
            now = self._clock() if now is None else now
            self._samples.append((now, self._total))
            cutoff = now - self.span
            # Keep at least two samples: the oldest retained one is the
            # anchor just before (or at) the window edge, so the delta is
            # always measured over a real elapsed span.
            while len(self._samples) > 2 and self._samples[1][0] <= cutoff:
                self._samples.popleft()

    def rate(self, now: float | None = None) -> float:
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            t0, c0 = self._samples[0]
            t1, c1 = self._samples[-1]
            return (c1 - c0) / (t1 - t0) if t1 > t0 else 0.0

    def reset(self) -> None:
        """Drop the window (engine idle: the gauge must read 0, and the
        next busy chunk must re-anchor rather than span the idle gap)."""
        with self._lock:
            self._samples.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)


# ---------------------------------------------------------------------------
# Stall attribution.

# The timing breakdown every scheduler step record maps onto, the JAX
# engine's causes on the port's pipelined loop (disjoint wall-time
# slices, each measured directly, so they sum without double counting):
#   dispatch      host inputs' upload + the chunk's graph replay (or its
#                 eager launches) + the queued copy of its outputs
#   host_overlap  first-token emission for admitted requests + scheduler
#                 thunks (embeddings, adapter loads) between a dispatch
#                 and the fetch of the chunk before it: host work the
#                 pipelining hid behind the device's
#   fetch_wait    the host blocked on the event behind the chunk's
#                 output copy (device work outlasting the overlapped
#                 host work)
#   emit          detokenize / stop-check / client delivery
#   prefill       prefill calls (group and chunked)
#   kv_transfer   KV restore admissions (engine/kvstate.py): blob
#                 validation, page upload and slot rebuild on the
#                 scheduler thread
STALL_CAUSES = ("dispatch", "host_overlap", "fetch_wait", "emit", "prefill", "kv_transfer")

_INTERPRET = {
    "fetch_wait": (
        "host blocked on the chunk's outputs: the device's decode chunk "
        "outlasts the overlapped host work (device-bound)"
    ),
    "host_overlap": (
        "host-bound between dispatch and fetch: admissions, scheduler "
        "thunks and first-token emission dominate the chunk turnaround "
        "(the device likely waits for the next dispatch)"
    ),
    "dispatch": "host-bound on dispatch: input upload and graph launch dominate",
    "emit": "host-bound on emission: detokenize/stop-check/delivery dominates",
    "prefill": "prefill-bound: prompt processing dominates the window",
    "kv_transfer": (
        "restore-bound: KV page import (blob upload + slot rebuild) "
        "dominates — resumes are arriving faster than pages can be "
        "imported; check kubeai_kv_restore_seconds and the break-even "
        "floor (KUBEAI_KV_BREAKEVEN_TOKENS)"
    ),
}


class PipelineStallTracker:
    """Sliding-window aggregation of the scheduler's step records into a
    stall-attribution report (where decode wall time goes). The engine
    records one entry per decode chunk and prefill call; ``report``
    answers ``GET /debug/pipeline``. Per-cause totals also feed the
    ``kubeai_engine_stall_seconds_total{cause}`` counter."""

    def __init__(self, window: float = 60.0, clock=time.monotonic, registry=None):
        self.window = window
        self._clock = clock
        self._lock = threading.Lock()
        # (t, kind, {cause: ms})
        self._records: deque[tuple[float, str, dict]] = deque()
        reg = registry or default_registry
        self._counter = reg.counter(
            "kubeai_engine_stall_seconds_total",
            "scheduler step wall time by stall cause (dispatch | "
            "host_overlap | fetch_wait | emit | prefill | kv_transfer) — "
            "the aggregate behind GET /debug/pipeline",
        )

    def record_decode(
        self,
        dispatch_ms: float,
        host_overlap_ms: float,
        fetch_wait_ms: float,
        emit_ms: float,
        now: float | None = None,
    ) -> None:
        self._record(
            "decode_chunk",
            {
                "dispatch": max(dispatch_ms, 0.0),
                "host_overlap": max(host_overlap_ms, 0.0),
                "fetch_wait": max(fetch_wait_ms, 0.0),
                "emit": max(emit_ms, 0.0),
            },
            now,
        )

    def record_prefill(self, kind: str, dur_ms: float, now: float | None = None) -> None:
        self._record(kind, {"prefill": max(dur_ms, 0.0)}, now)

    def record_kv_transfer(self, dur_ms: float, now: float | None = None) -> None:
        self._record("kv_restore", {"kv_transfer": max(dur_ms, 0.0)}, now)

    def _record(self, kind: str, causes: dict, now: float | None) -> None:
        now = self._clock() if now is None else now
        for cause, ms in causes.items():
            if ms:
                self._counter.inc(ms / 1000.0, labels={"cause": cause})
        with self._lock:
            self._records.append((now, kind, causes))
            self._prune_locked(now)

    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.window
        while self._records and self._records[0][0] < cutoff:
            self._records.popleft()

    def report(self, now: float | None = None) -> dict:
        """The /debug/pipeline payload: per-cause ms + fraction of
        accounted step time (fractions sum to 1.0 by construction),
        step counts by kind, and a human interpretation of the dominant
        cause. ``coverage`` is accounted time / observed wall span — the
        remainder is scheduler idle (or work between records)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._prune_locked(now)
            records = list(self._records)
        cause_ms = {c: 0.0 for c in STALL_CAUSES}
        steps: dict[str, int] = {}
        for _, kind, causes in records:
            steps[kind] = steps.get(kind, 0) + 1
            for cause, ms in causes.items():
                cause_ms[cause] = cause_ms.get(cause, 0.0) + ms
        accounted = sum(cause_ms.values())
        out: dict = {
            "window_seconds": self.window,
            "steps": steps,
            "accounted_ms": round(accounted, 3),
            "causes": {
                c: {
                    "ms": round(ms, 3),
                    "fraction": round(ms / accounted, 4) if accounted else 0.0,
                }
                for c, ms in cause_ms.items()
            },
        }
        if records:
            span = now - records[0][0]
            if span > 0:
                out["coverage"] = round(min(accounted / (span * 1000.0), 1.0), 4)
        if accounted:
            dominant = max(cause_ms, key=lambda c: cause_ms[c])
            out["dominant_cause"] = dominant
            pct = round(100.0 * cause_ms[dominant] / accounted)
            out["interpretation"] = f"{pct}% {dominant} → {_INTERPRET[dominant]}"
        return out


# ---------------------------------------------------------------------------
# On-demand profiler capture.


def profiling_enabled() -> bool:
    """Whether /debug/profile may start a trace. Off by default (a trace
    slows the process and fills disk), so it needs the explicit
    ``KUBEAI_DEBUG_PROFILE=1`` opt-in, like /debug/faults' arming gate.
    Re-read per request so tests can toggle it."""
    return os.environ.get("KUBEAI_DEBUG_PROFILE", "") in ("1", "true", "yes")


class ProfilerBusy(RuntimeError):
    """A capture is already in flight (the profiler is process-global
    state: overlapping sessions would corrupt each other)."""


class ProfilerCapture:
    """Single-flight torch.profiler capture. ``capture`` blocks for the
    requested window (the HTTP handler thread is per-connection) and
    returns the artifact summary; the trace is ``trace.json`` (Chrome
    trace-event JSON) in the capture's directory under ``root``. With a
    running *engine*, the session starts and stops on the engine's
    scheduler thread, between decode chunks."""

    def __init__(self, root: str | None = None):
        self._lock = threading.Lock()
        self.root = root or os.environ.get(
            "KUBEAI_PROFILE_DIR", os.path.join(tempfile.gettempdir(), "kubeai-profiles"))

    def capture(self, seconds: float, engine=None, out_dir: str | None = None) -> dict:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if not self._lock.acquire(blocking=False):
            raise ProfilerBusy("a profile capture is already in flight")
        try:
            out_dir = out_dir or os.path.join(
                self.root, time.strftime("profile-%Y%m%d-%H%M%S"))
            os.makedirs(out_dir, exist_ok=True)
            cuda = torch.cuda.is_available() and (
                engine is None or engine.device.type == "cuda")
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            on_engine = engine is not None and engine.is_ready()
            fanout = 0
            if on_engine and getattr(engine, "_publisher", None) is not None:
                try:  # best effort: a degraded gang still profiles rank 0
                    fanout = engine.broadcast_profile(seconds, out_dir)
                except Exception as e:
                    log.warning("profile gang fan-out failed: %s", e)

            def run(fn):
                return engine._run_on_scheduler(fn, "profiler") if on_engine else fn()

            run(prof.__enter__)
            try:
                time.sleep(seconds)
            finally:
                run(lambda: prof.__exit__(None, None, None))
            trace = os.path.join(out_dir, "trace.json")
            prof.export_chrome_trace(trace)
            files = total = 0
            for r, _, fs in os.walk(out_dir):
                for f in fs:
                    files += 1
                    total += os.path.getsize(os.path.join(r, f))
            return {
                "trace_dir": out_dir,
                "trace": trace,
                "seconds": seconds,
                "files": files,
                "bytes": total,
                "activities": ["cpu"] + (["cuda"] if cuda else []),
                "gang_fanout": fanout,
            }
        finally:
            self._lock.release()


default_profiler = ProfilerCapture()


# ---------------------------------------------------------------------------
# HTTP surface (the engine server's /debug router).


def handle_perf_request(path: str, query: str = "", engine=None) -> tuple[int, str, bytes] | None:
    """Route a GET to the perf X-ray surface. Returns (status,
    content_type, body) or None when *path* is not a perf route.

    - ``/debug/pipeline``: the windowed stall-attribution report with
      the live MFU and roofline context (``Engine.pipeline_report``).
    - ``/debug/profile?seconds=N``: a torch.profiler trace of N seconds
      (default 2, clamped to [0.05, 120]); 403 unless
      ``KUBEAI_DEBUG_PROFILE=1``, 400 on a bad N, 409 while a capture
      is in flight.
    """
    if path == "/debug/pipeline":
        if engine is None:
            body = {"available": False, "reason": "no engine attached"}
        else:
            body = engine.pipeline_report()
        return 200, "application/json", json.dumps(body).encode()
    if path == "/debug/profile":
        if not profiling_enabled():
            return 403, "application/json", json.dumps({
                "error": {
                    "message": "device profiling over HTTP is disabled; set "
                               "KUBEAI_DEBUG_PROFILE=1 on this process to enable",
                    "type": "invalid_request_error",
                }
            }).encode()
        q = parse_qs(query or "")
        try:
            seconds = float((q.get("seconds") or ["2"])[0])
        except ValueError:
            return 400, "application/json", json.dumps(
                {"error": {"message": "seconds must be a number"}}
            ).encode()
        seconds = min(max(seconds, 0.05), 120.0)
        try:
            result = default_profiler.capture(seconds, engine=engine)
        except ProfilerBusy as e:
            return 409, "application/json", json.dumps(
                {"error": {"message": str(e), "type": "conflict"}}
            ).encode()
        except Exception as e:  # the profiler is unavailable here
            log.exception("profile capture failed")
            return 500, "application/json", json.dumps(
                {"error": {"message": f"profile capture failed: {e}"}}
            ).encode()
        return 200, "application/json", json.dumps(result).encode()
    return None
