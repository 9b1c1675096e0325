"""The port's loader and remote model sources (kubeai_tpu_torch/loader.py,
controller/model_source.py, utils/xxh.py, and the engine's staging)
against the JAX package's, on the CPU, with no download:

- tests/test_loader.py's eleven cases, each run on both loaders;
- ``stage_remote`` destinations for a seeded set of hf://, s3://, gs://,
  oss:// and file:// URLs and prefixes;
- each scheme's command line, with ``subprocess.run`` recorded in both,
  and a real copy through stand-in ``aws`` / ``gcloud`` / ``ossutil``
  executables (the only ones on PATH: no real CLI is reachable);
- hf:// through a monkeypatched ``huggingface_hub.snapshot_download``;
- ``parse_model_source`` on tests/test_model_source.py's URLs and
  ``xxh64`` against the JAX ``_xxh64_py``;
- a CPU server over ``--model s3://...`` (the float32 test checkpoint)
  whose greedy tokens equal the same checkpoint's from its local path,
  and an adapter loaded from gs://... staged as ``{name}-<12 hex>``;
- ``--warm-compile-cache`` handing its engine arguments to the port's
  warm, and the warm itself on the CPU;
- ``check_dockerfile`` of tests/check_dockerfiles.py (imported) on the
  port's ``Dockerfile.engine``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from kubeai_tpu import loader as jl
from kubeai_tpu.controller.model_source import parse_model_source as j_parse
from kubeai_tpu.utils.xxh import _xxh64_py
from kubeai_tpu_torch import loader as tl
from kubeai_tpu_torch.controller.model_source import parse_model_source as t_parse
from kubeai_tpu_torch.utils.xxh import xxh64

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from test_torch_weights import _checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STANDIN = """#!{python}
# Stand-in for the {name} CLI: copies the tree under $STANDIN_BUCKETS named
# by the source URL (s3://B/K, gs://B/K/*, oss://B/K) into the destination,
# and records its arguments.
import os, shutil, sys
url, dest = sys.argv[-2], sys.argv[-1]
path = url.split("://", 1)[1]
if path.endswith("/*"):
    path = path[:-2]
root = os.environ["STANDIN_BUCKETS"]
with open(os.path.join(root, "calls.jsonl"), "a") as f:
    f.write(__import__("json").dumps(["{name}"] + sys.argv[1:]) + "\\n")
shutil.copytree(os.path.join(root, path), dest, dirs_exist_ok=True)
"""


@pytest.fixture
def standins(tmp_path, monkeypatch):
    """Stand-in aws / gcloud / ossutil as the only executables on PATH,
    over buckets under the returned directory."""
    bin_dir, buckets = tmp_path / "standin-bin", tmp_path / "buckets"
    bin_dir.mkdir()
    buckets.mkdir()
    for name in ("aws", "gcloud", "ossutil"):
        p = bin_dir / name
        p.write_text(STANDIN.format(python=sys.executable, name=name))
        p.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setenv("STANDIN_BUCKETS", str(buckets))
    return buckets


def _mkmodel(d):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write("{}")
    with open(os.path.join(d, "model.safetensors"), "w") as f:
        f.write("fake-weights")


def _tree(d) -> dict:
    """{relative path: bytes} of every file under *d*."""
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


# ---------------------------------------------------------------------------
# tests/test_loader.py's cases on both loaders


def _load_copies_file_source(mod, tmp, mp, caplog):
    _mkmodel(f"{tmp}/src")
    mod.load(f"file://{tmp}/src", f"{tmp}/dest")
    return sorted(os.listdir(f"{tmp}/dest"))


def _failed_load_leaves_no_partial_dest(mod, tmp, mp, caplog):
    with pytest.raises(FileNotFoundError):
        mod.load(f"file://{tmp}/does-not-exist", f"{tmp}/dest")
    return os.path.exists(f"{tmp}/dest"), [d for d in os.listdir(tmp) if ".tmp." in d]


def _restage_of_populated_dest_is_noop(mod, tmp, mp, caplog):
    _mkmodel(f"{tmp}/src")
    mod.load(f"file://{tmp}/src", f"{tmp}/dest")
    with open(f"{tmp}/dest/marker.txt", "w") as f:
        f.write("existing content survives")
    with open(f"{tmp}/src/model.safetensors", "w") as f:
        f.write("changed")
    mod.load(f"file://{tmp}/src", f"{tmp}/dest")
    return {k: v.decode() for k, v in _tree(f"{tmp}/dest").items()}


def _evict_missing_dest_is_harmless(mod, tmp, mp, caplog):
    caplog.clear()
    with caplog.at_level("INFO", logger=mod.__name__):
        mod.evict(f"{tmp}/absent")
    return any("already absent" in m for m in caplog.messages)


def _evict_removes_dest(mod, tmp, mp, caplog):
    _mkmodel(f"{tmp}/d")
    mod.evict(f"{tmp}/d")
    return os.path.exists(f"{tmp}/d")


def _stage_remote_passthroughs(mod, tmp, mp, caplog):
    return (mod.stage_remote("file:///models/x", tmp), mod.stage_remote("/models/y", tmp))


def _stage_remote_keys_dest_by_url(mod, tmp, mp, caplog):
    calls = []
    mp.setattr(mod, "load", lambda url, dest: calls.append((url, dest)))
    d1 = mod.stage_remote("hf://org/model", tmp, prefix="m-")
    d2 = mod.stage_remote("hf://org/model", tmp, prefix="m-")
    d3 = mod.stage_remote("hf://org/model-v2", tmp, prefix="m-")
    assert d1 == d2 and d1 != d3 and os.path.basename(d1).startswith("m-")
    return d1, d3, calls


def _cli_evict(mod, tmp, mp, caplog):
    _mkmodel(f"{tmp}/d")
    mod.main(["--evict", f"{tmp}/d"])
    return os.path.exists(f"{tmp}/d")


def _cli_requires_dest(mod, tmp, mp, caplog):
    with pytest.raises(SystemExit) as e:
        mod.main([f"file://{tmp}"])
    return e.value.code


def _cli_warm_passes_engine_args_through(mod, tmp, mp, caplog):
    _mkmodel(f"{tmp}/src")
    seen = {}
    mp.setattr(mod, "warm_compile_cache",
               lambda d, engine_args=None: seen.update(dest=d, args=engine_args))
    mod.main(["--warm-compile-cache", f"file://{tmp}/src", f"{tmp}/dest",
              "--max-seq-len", "512", "--max-slots", "4"])
    return seen, os.path.isdir(f"{tmp}/dest")


def _warm_compile_cache_requires_cache_env(mod, tmp, mp, caplog):
    mp.delenv("KUBEAI_COMPILE_CACHE", raising=False)
    caplog.clear()
    with caplog.at_level("INFO", logger=mod.__name__):
        got = mod.warm_compile_cache(tmp)
    return got, any("skipping compile warm" in m for m in caplog.messages)


LOADER_CASES = {f.__name__[1:]: f for f in (
    _load_copies_file_source, _failed_load_leaves_no_partial_dest,
    _restage_of_populated_dest_is_noop, _evict_missing_dest_is_harmless, _evict_removes_dest,
    _stage_remote_passthroughs, _stage_remote_keys_dest_by_url, _cli_evict, _cli_requires_dest,
    _cli_warm_passes_engine_args_through, _warm_compile_cache_requires_cache_env)}


def _relative(x, tmp):
    """*x* with the directory *tmp* written as "<tmp>" (each package runs
    in a directory of its own)."""
    return json.loads(json.dumps(x).replace(tmp, "<tmp>"))


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_cases_equal_jax(case, tmp_path, monkeypatch, caplog):
    got = []
    for name, mod in (("jax", jl), ("port", tl)):
        tmp = str(tmp_path / name)
        os.makedirs(tmp)
        with monkeypatch.context() as mp:
            got.append(_relative(LOADER_CASES[case](mod, tmp, mp, caplog), tmp))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# Staging destinations and command lines


def _urls(seed=0, n=40) -> list[tuple[str, str]]:
    g = np.random.default_rng(seed)
    out = [("file:///models/x", ""), ("/plain/path", "a-")]
    for i in range(n):
        scheme = str(g.choice(["hf", "s3", "gs", "oss", "file"]))
        parts = ["".join(g.choice(list("abcxyz019-_.")) for _ in range(int(g.integers(1, 9))))
                 for _ in range(int(g.integers(2, 4)))]
        ref = "/".join(parts[:2]) if scheme == "hf" else "/".join(parts)
        url = f"{scheme}://{'/' if scheme == 'file' else ''}{ref}"
        if g.random() < 0.3 and scheme != "file":
            url += "?model=m" + str(i)
        out.append((url, str(g.choice(["", "m-", "adapter-7-", "ñ-"]))))
    return out


def test_stage_remote_destinations_equal_jax(tmp_path, monkeypatch):
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jl, "load", lambda url, dest: calls["jax"].append((url, dest)))
    monkeypatch.setattr(tl, "load", lambda url, dest: calls["port"].append((url, dest)))
    base = str(tmp_path)
    for url, prefix in _urls():
        assert tl.stage_remote(url, base, prefix=prefix) == jl.stage_remote(url, base,
                                                                            prefix=prefix), url
    assert calls["port"] == calls["jax"] and len(calls["port"]) > 20
    for url, dest in calls["port"]:
        assert os.path.basename(dest)[-12:] == f"{xxh64(url) & 0xFFFFFFFFFFFF:012x}"


@pytest.mark.parametrize("url", ["s3://bucket/llama/8b", "gs://bucket/llama/8b",
                                 "oss://bucket/llama/8b?model=x"])
def test_command_lines_equal_jax(url, tmp_path, monkeypatch):
    calls = []

    def run(cmd, check=False, **kw):
        calls.append(([c.replace(str(tmp_path), "<tmp>") for c in cmd], check))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", run)
    for name, mod in (("jax", jl), ("port", tl)):
        mod.load(url, str(tmp_path / name / "dest"))
    (j_cmd, j_check), (t_cmd, t_check) = calls
    # The temporary directory's random suffix differs: compare up to it.
    assert t_cmd[:-1] == j_cmd[:-1] and t_check == j_check is True
    assert t_cmd[-1].startswith("<tmp>/port/dest.tmp.")
    assert j_cmd[-1].startswith("<tmp>/jax/dest.tmp.")


@pytest.mark.parametrize("scheme", ["s3", "gs", "oss"])
def test_real_copy_through_standin_cli(scheme, tmp_path, standins):
    _mkmodel(str(standins / "bkt" / "models" / "tiny"))
    os.makedirs(standins / "bkt" / "models" / "tiny" / "sub")
    (standins / "bkt" / "models" / "tiny" / "sub" / "x.bin").write_bytes(bytes(range(256)))
    url = f"{scheme}://bkt/models/tiny"
    dests = {}
    for name, mod in (("jax", jl), ("port", tl)):
        dests[name] = mod.stage_remote(url, str(tmp_path / name), prefix="m-")
    assert os.path.basename(dests["port"]) == os.path.basename(dests["jax"])
    assert _tree(dests["port"]) == _tree(dests["jax"]) == _tree(standins / "bkt/models/tiny")
    with open(standins / "calls.jsonl") as f:
        calls = [json.loads(line) for line in f]
    assert len(calls) == 2 and calls[0][:-1] == calls[1][:-1]


def test_cli_missing_is_an_error_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="aws"):
        tl.load("s3://bkt/k", str(tmp_path / "dest"))
    assert os.listdir(tmp_path) == []


def test_hf_through_snapshot_download(tmp_path, monkeypatch):
    import huggingface_hub

    seen = []

    def snapshot_download(repo_id, local_dir):
        seen.append(repo_id)
        _mkmodel(local_dir)
        return local_dir

    monkeypatch.setattr(huggingface_hub, "snapshot_download", snapshot_download)
    got = [mod.stage_remote("hf://org/model", str(tmp_path / name))
           for name, mod in (("jax", jl), ("port", tl))]
    assert seen == ["org/model", "org/model"]
    assert os.path.basename(got[0]) == os.path.basename(got[1])
    assert _tree(got[0]) == _tree(got[1])
    # Without the package the error names it.
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        tl.load("hf://org/other", str(tmp_path / "none"))


MODEL_SOURCE_URLS = ["hf://meta-llama/Llama-3.1-8B", "hf://onlyorg", "pvc://my-claim/models/llama",
                     "pvc://my-claim", "ollama://qwen2:0.5b?pull=always&insecure=true",
                     "s3://bucket/path/to/model?model=sub", "gs://b/k", "oss://b/k",
                     "file:///tmp/ckpt", "ftp://nope", "no-scheme", "pvc:///x",
                     "hf://org/model?insecure=1", "s3://b?pull=never"]


@pytest.mark.parametrize("url", MODEL_SOURCE_URLS)
def test_parse_model_source_equal_jax(url):
    try:
        want = j_parse(url)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_parse(url)
        assert str(got.value) == str(e)
        return
    assert t_parse(url).__dict__ == want.__dict__


def test_xxh64_equals_jax():
    g = np.random.default_rng(0)
    for n in range(101):
        for _ in range(3):
            data = bytes(g.integers(0, 256, n, dtype=np.uint8))
            seed = int(g.integers(0, 2**63))
            assert xxh64(data) == _xxh64_py(data)
            assert xxh64(data, seed) == _xxh64_py(data, seed)
    assert xxh64(b"") == 0xEF46DB3751D8E999 and xxh64(b"abc") == 0x44BC2CF5AD770999
    assert xxh64("hello world") == xxh64(b"hello world") == _xxh64_py(b"hello world")
    assert xxh64(b"abc", seed=1) != xxh64(b"abc")
    data = bytes(range(256)) * 4
    for n in [1, 3, 4, 7, 8, 15, 16, 31, 32, 33, 63, 64, 100, 1000]:
        assert xxh64(data[:n]) == _xxh64_py(data[:n])


# ---------------------------------------------------------------------------
# The engine's staging


SERVE_ARGS = ["--device", "cpu", "--max-slots", "2", "--max-seq-len", "128", "--host",
              "127.0.0.1", "--port", "0"]


def test_server_over_s3_equals_local_path(tmp_path, standins, monkeypatch):
    from kubeai_tpu_torch.engine.sampling import SamplingParams
    from kubeai_tpu_torch.engine.server import (
        EngineServer,
        build_engine_from_args,
        make_arg_parser,
    )

    ckpt = _checkpoint(standins / "bkt" / "tiny", V=300)
    monkeypatch.setenv("KUBEAI_MODEL_STAGING_DIR", str(tmp_path / "models"))
    remote, _ = build_engine_from_args(make_arg_parser().parse_args(
        ["--model", "s3://bkt/tiny"] + SERVE_ARGS))
    local, _ = build_engine_from_args(make_arg_parser().parse_args(["--model", ckpt] + SERVE_ARGS))
    staged = tmp_path / "models" / f"{xxh64('s3://bkt/tiny') & 0xFFFFFFFFFFFF:012x}"
    assert _tree(staged) == _tree(ckpt)
    stage = remote.cold_start_timeline.snapshot()["phases"]["stage"]
    assert stage["duration_s"] > 0
    srv = EngineServer(remote, "s3://bkt/tiny", host="127.0.0.1", port=0)
    srv.start()
    local.start()
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=12)
        for prompt in ("Hello", "The staged checkpoint answers"):
            want, text, _ = local.generate(local.tokenizer.encode(prompt), sp)
            got, _, _ = remote.generate(remote.tokenizer.encode(prompt), sp)
            assert got == want
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps({"prompt": prompt, "max_tokens": 12, "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["choices"][0]["text"] == text
    finally:
        srv.stop()
        local.stop()


def test_adapter_from_gs_is_staged_by_name(tmp_path, standins, monkeypatch):
    from kubeai_tpu_torch.engine import core as tcore
    from kubeai_tpu_torch.engine import lora as tlora
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    te = tcore.build_test_engine(tcore.EngineConfig(max_slots=2, max_seq_len=128,
                                                    prefill_buckets=(16, 32), max_adapters=2,
                                                    max_lora_rank=8), device="cpu")
    tlora.write_peft_checkpoint(str(standins / "adapters" / "a"), te.model_config, rank=4,
                                seed=1, std=0.5)
    monkeypatch.setenv("KUBEAI_ADAPTER_STAGING_DIR", str(tmp_path / "staging"))
    url = "gs://adapters/a"
    te.start()
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=8)
        base, _, _ = te.generate([256, 10, 20, 30], sp)
        te.load_adapter("ad", url)
        want = f"ad-{xxh64(url) & 0xFFFFFFFFFFFF:012x}"
        assert os.listdir(tmp_path / "staging") == [want]
        assert want == os.path.basename(jl.stage_remote(url, str(tmp_path / "jax"),
                                                        prefix="ad-"))
        assert _tree(tmp_path / "staging" / want) == _tree(standins / "adapters" / "a")
        got, _, _ = te.generate([256, 10, 20, 30], sp, adapter="ad")
        assert got != base
    finally:
        te.stop()


def test_warm_compile_cache_runs_the_ports_warm(tmp_path, monkeypatch):
    """The CLI stages, then warms the libraries of the staged checkpoint's
    serving path under the trailing engine args (on the CPU nothing
    builds, and the warm says so)."""
    from kubeai_tpu_torch.engine import coldstart as tcs
    from kubeai_tpu_torch.ops import _build

    ckpt = _checkpoint(tmp_path / "src", V=300)
    prior = _build.library_dir()
    monkeypatch.setenv("KUBEAI_COMPILE_CACHE", str(tmp_path / "cache"))
    seen = {}
    real = tcs.warm_from_checkpoint

    def spy(path, engine_args=None):
        seen.update(path=path, args=engine_args)
        seen["stats"] = real(path, engine_args)
        return seen["stats"]

    monkeypatch.setattr(tcs, "warm_from_checkpoint", spy)
    try:
        tl.main(["--warm-compile-cache", f"file://{ckpt}", str(tmp_path / "dest"),
                 "--device", "cpu", "--max-slots", "4", "--quantization", "int8"])
        assert _build.library_dir() == tmp_path / "cache"
    finally:
        _build.set_library_dir(prior)
    assert seen["path"] == str(tmp_path / "dest")
    assert seen["args"] == ["--device", "cpu", "--max-slots", "4", "--quantization", "int8"]
    stats = seen["stats"]
    assert stats["skipped"] == "no kernels on cpu" and "w8a16_matmul" in stats["libraries"]
    # A warm that fails is logged, not raised.
    monkeypatch.setattr(tcs, "warm_from_checkpoint",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("nvcc failed")))
    try:
        assert tl.warm_compile_cache(str(tmp_path / "dest")) is None
    finally:
        _build.set_library_dir(prior)


def test_engine_dockerfile_checks(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from check_dockerfiles import check_dockerfile

    path = "kubeai_tpu_torch/Dockerfile.engine"
    assert check_dockerfile(path) == []
    text = open(os.path.join(ROOT, path)).read()
    assert 'ENTRYPOINT ["python", "-m", "kubeai_tpu_torch.engine.server"]' in text
    assert "KUBEAI_COMPILE_CACHE=/cache" in text and "COPY kubeai_tpu_torch/" in text
    broken = tmp_path / "Dockerfile.engine"
    broken.write_text(text.replace("COPY kubeai_tpu_torch/", "COPY kubeai_tpu_torch_gone/"))
    errs = check_dockerfile(str(broken))
    assert len(errs) == 1 and "kubeai_tpu_torch_gone/" in errs[0]
