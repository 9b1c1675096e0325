"""Model loader: stages weights from a source URL into a directory (port
of kubeai_tpu/loader.py). Cache loader Jobs and the adapter loader run
it; the engine stages ``--model`` and adapter sources through
``stage_remote``.

    python -m kubeai_tpu_torch.loader <src-url> <dest-dir>
    python -m kubeai_tpu_torch.loader --evict <dir>
    python -m kubeai_tpu_torch.loader --warm-compile-cache <src-url> <dest-dir> [engine args...]

Schemes: file:// and pvc:// copy locally; hf:// uses huggingface_hub
(imported at use); s3:// gs:// oss:// run their CLIs (aws, gcloud,
ossutil), with the JAX loader's command lines. The destination is
written atomically (a temporary directory, then a rename), so a crashed
load never looks complete, and a populated destination is left as it is.

--warm-compile-cache then builds the kernel libraries that an engine
serving the staged checkpoint loads (``coldstart.warm_from_checkpoint``:
config.json and the tokenizer only, no weights) into the shared
``KUBEAI_COMPILE_CACHE``, so the nvcc builds are done before the first
replica starts. Trailing engine-server arguments (the Model's args, e.g.
``--max-seq-len 512 --max-slots 4``) pick the libraries the serving pods
load. A warm that fails is logged and does not fail the staging Job; a
server started on that cache builds what is missing, and that build
raises if it fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from kubeai_tpu_torch.controller.model_source import parse_model_source
from kubeai_tpu_torch.obs.logs import get_logger, setup_logging

log = get_logger("kubeai_tpu_torch.loader")


def _atomic_dest(dest: str):
    os.makedirs(os.path.dirname(dest.rstrip("/")) or "/", exist_ok=True)
    return tempfile.mkdtemp(prefix=os.path.basename(dest.rstrip("/")) + ".tmp.",
                            dir=os.path.dirname(dest.rstrip("/")))


def load(src_url: str, dest: str) -> None:
    src = parse_model_source(src_url)
    if os.path.isdir(dest) and os.listdir(dest):
        log.info("destination %s already populated; nothing to do", dest)
        return
    t0 = time.monotonic()
    tmp = _atomic_dest(dest)
    try:
        if src.scheme in ("file", "pvc"):
            source_dir = src.local_path if src.scheme == "file" else f"/model/{src.pvc_subpath}"
            shutil.copytree(source_dir, tmp, dirs_exist_ok=True)
        elif src.scheme == "hf":
            try:
                from huggingface_hub import snapshot_download
            except ImportError as e:
                raise ImportError(f"hf:// sources need the huggingface_hub package ({e})") from e

            snapshot_download(repo_id=src.huggingface_repo, local_dir=tmp)
        elif src.scheme == "s3":
            subprocess.run(["aws", "s3", "sync", src.bucket_url, tmp], check=True)
        elif src.scheme == "gs":
            subprocess.run(["gcloud", "storage", "cp", "-r", src.bucket_url + "/*", tmp], check=True)
        elif src.scheme == "oss":
            subprocess.run(["ossutil", "cp", "-r", src.bucket_url, tmp], check=True)
        else:
            raise ValueError(f"loader does not support scheme {src.scheme!r}")
        if os.path.isdir(dest):
            shutil.rmtree(dest)
        os.rename(tmp, dest)
        tmp = None
        log.info("loaded %s -> %s in %.3f s", src_url, dest, time.monotonic() - t0)
    finally:
        if tmp and os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def evict(dest: str) -> None:
    if os.path.isdir(dest):
        shutil.rmtree(dest)
        log.info("evicted %s", dest)
    else:
        log.info("%s already absent", dest)


def stage_remote(url: str, base_dir: str, prefix: str = "") -> str:
    """The local directory of a model or adapter source: file:// is
    stripped to its path, a plain path passes through, and another scheme
    (hf, s3, gs, oss, pvc) is loaded into *base_dir* under
    ``{prefix}{xxh64(url) & 0xFFFFFFFFFFFF:012x}`` (the JAX loader's
    name, so a staging volume shared by both engines agrees; a changed
    URL never reuses a stale download, since load() keeps a populated
    destination)."""
    if url.startswith("file://"):
        return url[len("file://"):]
    if "://" in url:
        from kubeai_tpu_torch.utils.xxh import xxh64

        dest = os.path.join(base_dir, f"{prefix}{xxh64(url) & 0xFFFFFFFFFFFF:012x}")
        load(url, dest)
        return dest
    return url


def stage_model(url: str) -> str:
    """``--model``'s local directory: a remote source staged under
    ``KUBEAI_MODEL_STAGING_DIR`` (default /tmp/kubeai-models)."""
    return stage_remote(url, os.environ.get("KUBEAI_MODEL_STAGING_DIR", "/tmp/kubeai-models"))


def stage_adapter(name: str, url: str) -> str:
    """Adapter *name*'s local directory: a remote source staged under
    ``KUBEAI_ADAPTER_STAGING_DIR`` (default /tmp/kubeai-adapters) as
    ``{name}-<12 hex>``."""
    return stage_remote(url, os.environ.get("KUBEAI_ADAPTER_STAGING_DIR", "/tmp/kubeai-adapters"),
                        prefix=f"{name}-")


def warm_compile_cache(dest: str, engine_args: list[str] | None = None) -> dict | None:
    """Build the kernel libraries an engine serving *dest* under
    *engine_args* loads into ``KUBEAI_COMPILE_CACHE`` (required: a warm of
    a process-local directory would serve nobody). Never raises: a warm
    failure must not fail the staging Job that gates pod creation."""
    from kubeai_tpu_torch.engine.coldstart import setup_compile_cache, warm_from_checkpoint

    if setup_compile_cache() is None:
        log.info("KUBEAI_COMPILE_CACHE is not set; skipping compile warm")
        return None
    try:
        stats = warm_from_checkpoint(dest, engine_args)
    except Exception as e:
        log.warning("compile warm failed (non-fatal): %s", e)
        return None
    log.info("warmed compile cache for %s: %s", dest, json.dumps(stats))
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser("kubeai-tpu-torch-loader")
    parser.add_argument("--evict", action="store_true")
    parser.add_argument(
        "--warm-compile-cache", action="store_true",
        help="after staging, build the kernel libraries the engine loads for the "
             "checkpoint into KUBEAI_COMPILE_CACHE; trailing engine-server args "
             "pick the libraries",
    )
    parser.add_argument("src_or_dir")
    parser.add_argument("dest", nargs="?")
    args, engine_args = parser.parse_known_args(argv)
    setup_logging("loader")
    if engine_args and not args.warm_compile_cache:
        # Trailing args are only the warm's engine flags; without it they
        # are typos (a misspelled --evict must not turn into a staging run).
        parser.error(f"unrecognized arguments: {' '.join(engine_args)}")
    if args.evict:
        evict(args.src_or_dir)
    else:
        if not args.dest:
            parser.error("dest required")
        load(args.src_or_dir, args.dest)
        if args.warm_compile_cache:
            warm_compile_cache(args.dest, engine_args)


if __name__ == "__main__":
    sys.exit(main())
