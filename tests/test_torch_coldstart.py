"""Cold start in the port (kubeai_tpu_torch/engine/coldstart.py) against
the JAX package's (kubeai_tpu/engine/coldstart.py): the phase timeline's
snapshot under one fake clock, the kernel-library cache directory,
param_shapes against a loaded engine, the libraries a config's serving
path loads (recorded from the wrappers' own choices during a warmup with
the CUDA gates on), the background warm overlapped with the weight
stream, a failing build, the warmup's shapes against the JAX engine's 11
on tests/test_coldstart.py's TINY_EC, and Engine.load_params_.

On the CPU nothing is built: the tests that exercise the build path
monkeypatch ``coldstart.runs_kernels`` and ``_build.build`` / ``load`` /
``preload`` with recording fakes."""

import json
import time
from pathlib import Path

import jax
import pytest
import torch

from kubeai_tpu.engine import coldstart as jcs
from kubeai_tpu.engine import weights as jw
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu_torch.engine import coldstart as tcs
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine import weights as tw
from kubeai_tpu_torch.engine.core import EngineConfig as TEC
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.models import llama
from kubeai_tpu_torch.obs.recorder import handle_debug_request
from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops import paged_attention as tpa
from kubeai_tpu_torch.ops.quant import is_quantized

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from test_coldstart import TINY_EC
from test_torch_weights import _checkpoint


def _tec(ec) -> TEC:
    """The port's EngineConfig with the fields of a JAX one."""
    return TEC(max_slots=ec.max_slots, max_seq_len=ec.max_seq_len,
               prefill_buckets=tuple(ec.prefill_buckets), decode_chunk=ec.decode_chunk)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    # save_tiny_test_checkpoint's names and shapes, vocab 300 (the byte
    # tokenizer's specials fit), written without transformers.
    return _checkpoint(tmp_path_factory.mktemp("ck") / "tiny", V=300)


# ---------------------------------------------------------------------------
# The timeline


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive(tl, clk):
    """tests/test_coldstart.py's stamp sequence: load inside compile, a
    gap, then a serial warmup, and readiness stamped twice."""
    tl.begin("compile")
    clk.t = 101.0
    tl.begin("load")
    clk.t = 103.0
    tl.end("load")
    clk.t = 105.0
    tl.end("compile")
    clk.t = 106.0
    with tl.phase("warmup"):
        clk.t = 108.0
    tl.begin("stage")  # begun, never ended: start_s only
    tl.attrs["warm_compile"] = {"libraries": ["x"]}
    tl.ready()
    clk.t = 500.0
    tl.ready()


def test_timeline_snapshot_matches_jax():
    snaps = []
    for mod in (jcs, tcs):
        clk = FakeClock()
        tl = mod.ColdStartTimeline(clock=clk)
        _drive(tl, clk)
        snap = tl.snapshot()
        snap.pop("t0_unix")
        snaps.append(snap)
    assert snaps[0] == snaps[1]
    snap = snaps[1]
    assert snap["phase_sum_s"] == pytest.approx(9.0) and snap["overlap_s"] == pytest.approx(2.0)
    assert snap["ready_s"] == pytest.approx(8.0)  # the first ready() won
    assert snap["phases"]["stage"] == {"start_s": 8.0}
    json.dumps(snap)


def test_timeline_ready_is_idempotent():
    clk = FakeClock()
    tl = tcs.ColdStartTimeline(clock=clk)
    clk.t = 101.0
    tl.ready()
    clk.t = 500.0
    tl.ready()
    assert tl.snapshot()["ready_s"] == pytest.approx(1.0)


def test_timeline_shows_at_debug_engine():
    tl = tcs.ColdStartTimeline().install()
    with tl.phase("load"):
        pass
    code, _, body = handle_debug_request("/debug/engine")
    assert code == 200
    assert "load" in json.loads(body)["cold_start"]["phases"]


def test_cold_start_histogram_has_jax_name_help_and_buckets():
    from kubeai_tpu.metrics import default_registry as jreg
    from kubeai_tpu_torch.metrics import default_registry as treg

    j, t = jreg.get("kubeai_engine_cold_start_seconds"), treg.get("kubeai_engine_cold_start_seconds")
    assert type(t).__name__ == type(j).__name__ == "Histogram"
    assert t.help == j.help and tuple(t.buckets) == tuple(j.buckets)


# ---------------------------------------------------------------------------
# The library directory


def test_setup_compile_cache_env_and_explicit(tmp_path, monkeypatch):
    prior = _build.library_dir()
    try:
        monkeypatch.delenv("KUBEAI_COMPILE_CACHE", raising=False)
        assert tcs.setup_compile_cache() is None  # no env, no arg: no-op
        assert _build.library_dir() == prior and tcs.compile_cache_dir() is None

        d1 = str(tmp_path / "cache1")
        assert tcs.setup_compile_cache(d1) == d1
        assert Path(d1).is_dir() and _build.library_dir() == Path(d1)
        assert tcs.compile_cache_dir() == d1
        assert _build._library_path("flash_attention").parent == Path(d1)

        d2 = str(tmp_path / "cache2")
        monkeypatch.setenv("KUBEAI_COMPILE_CACHE", d2)
        assert tcs.setup_compile_cache() == d2 and _build.library_dir() == Path(d2)
    finally:
        _build.set_library_dir(prior)


def test_library_hash_names_the_compiler(monkeypatch):
    """Another toolkit's release line gives another file: a directory
    shared across nodes never hands one node another toolkit's build."""
    a = _build._library_path("paged_attention")
    monkeypatch.setattr(_build, "nvcc_release", lambda: "Cuda compilation tools, release 99.9")
    b = _build._library_path("paged_attention")
    assert a != b and a.parent == b.parent and b.name.startswith("paged_attention-")


def test_concurrent_builds_of_one_library_share_one_nvcc(tmp_path, monkeypatch):
    """Sixteen threads building the same library: one nvcc runs, the
    others wait for it, and no two write one temporary file."""
    import subprocess
    import sys
    import threading

    prior = _build.library_dir()
    _build.set_library_dir(tmp_path)
    procs = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            self.out = Path(cmd[cmd.index("-o") + 1])
            procs.append(self.out)
            self.returncode = 0

        def communicate(self):
            time.sleep(0.3)
            self.out.write_bytes(b"lib")
            return "", None

    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "nvcc_release", lambda: "release 12.9")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = []
        threads = [threading.Thread(target=lambda: results.append(_build.build(["w8a16_matmul"])))
                   for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads) and len(results) == 16
        # One nvcc, writing a file named by its process and thread.
        assert len(procs) == 1 and procs[0].name.endswith(".tmp")
        assert len(procs[0].suffixes) >= 3
        paths = {r["w8a16_matmul"].path for r in results}
        assert len(paths) == 1 and next(iter(paths)).read_bytes() == b"lib"
        assert not list(tmp_path.glob("*.tmp"))
    finally:
        sys.setswitchinterval(switch)
        _build.set_library_dir(prior)


# ---------------------------------------------------------------------------
# Shapes and libraries from the config alone


@pytest.mark.parametrize("quantization", ["", "int8"])
def test_param_shapes_match_loaded_engine(ckpt, quantization):
    eng = tw.load_engine_from_path(ckpt, _tec(TINY_EC), quantization=quantization, device="cpu",
                                   overlap=False, warmup=False)
    served, _, _ = tw.open_checkpoint(ckpt)
    shapes = tcs.param_shapes(served, quantization)
    n = 0

    def same(a, b, where):
        nonlocal n
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
        else:
            n += 1
            assert a.device.type == "meta", where
            assert (a.shape, a.dtype) == (b.shape, b.dtype), where

    same(shapes, eng.params, "")
    # The JAX engine's abstract tree has as many leaves.
    jmc = JMC.from_json_file(ckpt).replace(vocab_size=jcs.padded_vocab_size(300))
    assert n == len(jax.tree_util.tree_leaves(jcs.param_shapes(jmc, quantization)))
    if quantization:
        assert is_quantized(shapes["layers"]["wq"])


def _cut(mc):
    """A preset's kernel-relevant fields (head dim, query group, window,
    softcaps, experts, biases) at a width a CPU warmup runs in a moment."""
    G = mc.num_heads // mc.num_kv_heads
    return mc.replace(vocab_size=512, hidden_size=64, intermediate_size=64, num_layers=1,
                      num_heads=G, num_kv_heads=1, head_dim=mc.head_dim_,
                      num_experts=min(mc.num_experts, 4), max_position=1024,
                      sliding_window=min(mc.sliding_window, 64))


def _recorded_libraries(monkeypatch) -> list:
    """Wrap the model's kernel entry points: each call records the
    library its wrapper would load on CUDA (its own choice functions),
    then runs the plain version as the CPU does."""
    seen = []

    def pool_code(q, pool):
        return _build.POOL_SAME if pool.dtype == q.dtype else _build.POOL_INT8

    def wrap(name, fn, lib):
        def call(*a, **kw):
            got = lib(*a, **kw)
            if got:
                seen.append(got)
            return fn(*a, **kw)
        monkeypatch.setattr(llama, name, call)

    wrap("flash_attention", llama.flash_attention,
         lambda q, *a, **kw: _build.attention_library("flash_attention", q.shape[-1]))
    wrap("paged_attention_ragged", llama.paged_attention_ragged,
         lambda q, pool, *a, **kw: tpa.library("paged_attention", q.shape[-1], pool_code(q, pool)))
    wrap("paged_decode_attention", llama.paged_decode_attention,
         lambda q, pool, *a, **kw: tpa.library("paged_decode_attention", q.shape[-1],
                                               pool_code(q, pool)))
    wrap("qdot", llama.qdot, lambda x, w: "w8a16_matmul" if is_quantized(w) else None)
    wrap("qmatT", llama.qmatT, lambda x, w: "w8a16_matmul" if is_quantized(w) else None)
    wrap("qdot_many", llama.qdot_many,
         lambda x, ws: "w8a16_matmul" if all(is_quantized(w) for w in ws) else None)
    return seen


LIBRARY_CASES = [
    # (preset, quantization, kv_cache_dtype, decode_kernel, speculate_tokens)
    ("llama-3.1-8b", "", "", "ragged", 0),
    ("llama-3.1-8b", "int8", "", "dedicated", 0),
    ("llama-3.1-8b", "", "fp8", "auto", 3),
    ("llama-3.1-8b", "", "", "auto", 8),
    ("qwen2.5-7b", "int8", "", "ragged", 0),
    ("gemma-2b", "", "fp8", "dedicated", 0),
    ("gemma2-2b", "int8", "", "ragged", 0),
    ("mixtral-8x7b", "", "", "ragged", 0),
    ("test:tiny", "int8", "fp8", "dedicated", 0),
]


@pytest.mark.parametrize("preset,quantization,kv,decode_kernel,G", LIBRARY_CASES,
                         ids=["-".join(str(x) for x in c if x != "") for c in LIBRARY_CASES])
def test_serving_libraries_are_the_wrappers_choices(monkeypatch, preset, quantization, kv,
                                                    decode_kernel, G):
    """serving_libraries names exactly the libraries the wrappers choose
    across a warmup (every serving shape, with the restore path) and an
    embed, run on the CPU with the CUDA kernel gates on."""
    if preset == "test:tiny":
        mc = tcore.test_model_config()
        buckets = tcore.TEST_PREFILL_BUCKETS
    else:
        mc = _cut(tcore.preset_config(preset))
        buckets = (32, 256)
    ec = TEC(max_slots=2, max_seq_len=512, prefill_buckets=buckets, decode_chunk=2,
             decode_kernel=decode_kernel, speculate_tokens=G, kv_cache_dtype=kv)
    gated = mc.replace(use_flash_prefill=True, use_paged_kernel=mc.sliding_window == 0)
    params = tcore.preset_params(gated, torch.device("cpu"), 0, quantization)
    eng = tcore.Engine(gated, params, tcore.ByteTokenizer(), ec, device="cpu")
    seen = _recorded_libraries(monkeypatch)
    eng.warmup()
    eng.embed([[1, 2, 3]])
    want = _build.serving_libraries(mc, ec, quantization)
    assert len(set(want)) == len(want)
    assert set(seen) == set(want), (sorted(set(seen)), want)


def _fake_builds(monkeypatch, calls, seconds=1.0, fail=False, delay=0.0):
    """Recording fakes of the build, load and preload steps, with
    runs_kernels forced on: warm_compile walks its CUDA path on the CPU."""
    def build(names, ptxas_verbose=False):
        calls.append(list(names))
        time.sleep(delay)
        if fail:
            raise RuntimeError("CUDA kernel build failed:\n--- injected")
        return {n: _build.BuildResult(n, Path(n), seconds, "") for n in names}

    monkeypatch.setattr(tcs, "runs_kernels", lambda device: True)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "load", lambda name, sig: ("lib", name, tuple(sig)))
    monkeypatch.setattr(_build, "preload", lambda lib, device: 7)


def test_warm_compile_builds_and_loads_the_config_libraries(monkeypatch):
    mc = tcore.preset_config("gemma-2b")
    ec = TEC(kv_cache_dtype="fp8", decode_kernel="dedicated")
    want = _build.serving_libraries(mc, ec, "int8")
    assert want == ["flash_attention_d256", "paged_attention_d256",
                    "paged_decode_attention_d256", "w8a16_matmul"]
    calls = []
    _fake_builds(monkeypatch, calls)
    stats = tcs.warm_compile(mc, ec, "int8", device="cuda")
    assert calls == [want]
    assert stats["libraries"] == want and stats["loaded"] == want and stats["missing"] == []
    assert stats["built"] == {n: 1.0 for n in want}
    assert stats["preloaded"] == {n: 7 for n in want} and "errors" not in stats
    # A library already in the directory builds in 0 s: not "built".
    _fake_builds(monkeypatch, calls, seconds=0.0)
    assert tcs.warm_compile(mc, ec, "int8", device="cuda")["built"] == {}


def test_warm_from_checkpoint_reads_the_config_and_the_pod_args(ckpt, monkeypatch):
    """The checkpoint's config.json and the pod's args (through the
    server's parser; unknown args ignored) choose the libraries."""
    calls = []
    _fake_builds(monkeypatch, calls)
    stats = tcs.warm_from_checkpoint(ckpt, ["--device", "cpu", "--max-slots", "2",
                                            "--decode-kernel", "dedicated",
                                            "--kv-cache-dtype", "fp8", "--unknown", "1"])
    served, _, _ = tw.open_checkpoint(ckpt)
    assert served.head_dim_ == 16 and served.vocab_size == 384
    assert stats["libraries"] == calls[0] == ["flash_attention", "paged_attention",
                                              "paged_decode_attention"]
    assert tcs.warm_from_checkpoint("preset:gemma-2b", ["--device", "cpu", "--quantization",
                                                        "int8"])["libraries"] == [
        "flash_attention_d256", "paged_attention_d256", "w8a16_matmul"]


def test_warm_compile_on_the_cpu_builds_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "build", lambda names, **kw: calls.append(names))
    stats = tcs.warm_compile(tcore.test_model_config(), TEC(), device="cpu")
    assert calls == [] and stats["skipped"] == "no kernels on cpu"
    assert stats["libraries"] == ["flash_attention", "paged_attention"]
    assert stats["loaded"] == [] and stats["built"] == {}


def test_compile_overlaps_load(ckpt, monkeypatch):
    """The background warm starts before the weight stream ends (a slow
    fake build stands in for nvcc)."""
    calls = []
    _fake_builds(monkeypatch, calls, delay=0.5)
    eng = tw.load_engine_from_path(ckpt, _tec(TINY_EC), dtype="float32", device="cpu",
                                   overlap=True, warmup=False)
    snap = eng.cold_start_timeline.snapshot()
    load, compile_ = snap["phases"]["load"], snap["phases"]["compile"]
    assert compile_["start_s"] < load["end_s"], snap
    assert compile_["duration_s"] >= 0.5 and snap["overlap_s"] > 0
    assert snap["attrs"]["warm_compile"]["loaded"] == ["paged_attention"]
    assert set(snap["phases"]) == {"compile", "load", "build"}


def test_failing_build_lands_in_stats_and_fails_the_start(ckpt, monkeypatch):
    """A warm's failed build is in its stats (never raised by the warm);
    the start then builds the library again, which raises: no engine runs
    without its kernel."""
    calls = []
    _fake_builds(monkeypatch, calls, fail=True)
    ec = TEC(prefill_buckets=tcore.TEST_PREFILL_BUCKETS)
    stats = tcs.warm_compile(tcore.test_model_config(), ec, device="cuda")
    assert stats["missing"] == ["paged_attention"] and stats["loaded"] == []
    assert "injected" in stats["errors"][0]
    warm = tcs.start_background_warm(tcore.test_model_config(), ec, device="cuda")
    assert warm.join()["missing"] == ["paged_attention"]
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tcs.require_libraries(stats)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tw.load_engine_from_path(ckpt, _tec(TINY_EC), dtype="float32", device="cpu",
                                 overlap=True, warmup=False)


def test_overlap_knob(ckpt, monkeypatch, tmp_path):
    """KUBEAI_COLDSTART_OVERLAP: auto overlaps only with a compile cache
    set (as in JAX), 1 forces it, 0 disables it."""
    calls = []
    _fake_builds(monkeypatch, calls)
    prior = _build.library_dir()

    def compiled():
        eng = tw.load_engine_from_path(ckpt, _tec(TINY_EC), dtype="float32", device="cpu")
        return "compile" in eng.cold_start_timeline.snapshot()["phases"]

    try:
        monkeypatch.delenv("KUBEAI_COMPILE_CACHE", raising=False)
        monkeypatch.delenv("KUBEAI_COLDSTART_OVERLAP", raising=False)
        assert not compiled()
        monkeypatch.setenv("KUBEAI_COMPILE_CACHE", str(tmp_path / "libs"))
        assert compiled()
        monkeypatch.setenv("KUBEAI_COLDSTART_OVERLAP", "0")
        assert not compiled()
    finally:
        _build.set_library_dir(prior)
    monkeypatch.delenv("KUBEAI_COMPILE_CACHE")
    monkeypatch.setenv("KUBEAI_COLDSTART_OVERLAP", "1")
    assert compiled()


# ---------------------------------------------------------------------------
# Warmup shapes against the JAX engine's


# The JAX engine's warmup on TINY_EC (kubeai_tpu/engine/core.py warmup):
# the decode chunk, cold prefill at batch 1 and 2 (the group cap) for
# each bucket, a chunk prefill per bucket, then the restore path.
JAX_TINY_SHAPES = ["decode", "prefill_batch[1x8]", "prefill_batch[2x8]", "prefill_batch[1x16]",
                   "prefill_batch[2x16]", "prefill_chunk[8]", "prefill_chunk[16]", "kv_evolve",
                   "kv_import[1]", "kv_import[2]", "kv_slotset"]
# The JAX shape with no counterpart: the port's sampling key is the
# slot's seed, so there is no key to evolve.
NO_COUNTERPART = {"kv_evolve"}


def test_warmup_shapes_against_jax_tiny_ec(ckpt):
    je = jw.load_engine_from_path(ckpt, TINY_EC, dtype="float32", stream=True, overlap=False,
                                  warmup=True)
    jax_stats = je.cold_start_timeline.snapshot()["attrs"]["warmup"]
    assert jax_stats["shapes"] == len(JAX_TINY_SHAPES) == 11
    te = tw.load_engine_from_path(ckpt, _tec(TINY_EC), dtype="float32", device="cpu",
                                  overlap=False, warmup=True)
    stats = te.cold_start_timeline.snapshot()["attrs"]["warmup"]
    assert stats == te.warmup_result
    assert stats["names"] == [s for s in JAX_TINY_SHAPES if s not in NO_COUNTERPART]
    assert stats["shapes"] == 10
    assert set(te.cold_start_timeline.snapshot()["phases"]) == {"load", "build", "warmup"}


# ---------------------------------------------------------------------------
# load_params_


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("quantization", ["", "int8"])
def test_load_params_keeps_storage_and_equals_a_fresh_engine(quantization):
    """A parked engine (zero weights, warmed up, served once) takes seed
    2's weights in place: every leaf keeps its storage, the prefix cache
    is dropped, and its logits and greedy tokens are a fresh engine's."""
    mc = tcore.test_model_config()
    ec = TEC(max_slots=2, max_seq_len=128, prefill_buckets=(16, 32), decode_chunk=2)
    dev = torch.device("cpu")
    parked = tcore.Engine(mc, tcs.zero_params(mc, quantization, dev), tcore.ByteTokenizer(),
                          ec, device="cpu")
    parked.warmup()
    prompt = [256] + [(i * 7) % 250 + 1 for i in range(70)]
    sp = TSP(temperature=0.0, max_tokens=6)
    parked.start()
    parked.generate(prompt, sp)  # registers prefix pages under the zero weights
    parked.stop()
    assert parked._pool.cached_pages() > 0
    ptrs = [t.data_ptr() for t in _leaves(parked.params)]
    weights = tcore.preset_params(mc, dev, 2, quantization)
    parked.load_params_(weights)
    assert [t.data_ptr() for t in _leaves(parked.params)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(_leaves(parked.params), _leaves(weights)))
    assert parked._pool.cached_pages() == 0 and parked._pool.available() == \
        parked._pool.num_pages - 1
    fresh = tcore.build_test_engine(ec, seed=2, device="cpu", quantization=quantization)
    tok = torch.tensor([prompt[:16]])
    pos = torch.arange(16)[None]
    a, _ = llama.apply(parked.params, parked.model_config, tok, pos)
    b, _ = llama.apply(fresh.params, fresh.model_config, tok, pos)
    assert torch.equal(a, b)
    for e in (parked, fresh):
        e.start()
    try:
        assert parked.generate(prompt, sp)[0] == fresh.generate(prompt, sp)[0]
    finally:
        for e in (parked, fresh):
            e.stop()


def test_load_params_refuses_another_tree():
    mc = tcore.test_model_config()
    eng = tcore.build_test_engine(device="cpu")
    other = tcore.preset_params(mc.replace(intermediate_size=128), torch.device("cpu"))
    with pytest.raises(ValueError, match="expected"):
        eng.load_params_(other)
    missing = dict(eng.params)
    missing.pop("final_norm")
    with pytest.raises(ValueError, match="keys"):
        eng.load_params_(missing)
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            eng.load_params_(eng.params)
    finally:
        eng.stop()
