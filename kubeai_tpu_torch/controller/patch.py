"""RFC-6902 JSON patches over generated pods — the admin escape hatch
(parity: internal/modelcontroller/patch.go:12-43; e.g. injecting extra
TPU scheduling fields via config without forking the controller).

Port of kubeai_tpu/controller/patch.py: the JAX package's code,
its imports in this package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

from kubeai_tpu_torch.api.core_types import Pod


def _to_doc(pod: Pod) -> dict:
    return dataclasses.asdict(pod)


def _pointer_parts(path: str) -> list[str]:
    if path == "":
        return []
    if not path.startswith("/"):
        raise ValueError(f"bad JSON pointer {path!r}")
    return [p.replace("~1", "/").replace("~0", "~") for p in path[1:].split("/")]


def _resolve(doc: Any, parts: list[str]):
    """Walk to the parent of the final element; returns (parent, last_key)."""
    cur = doc
    for p in parts[:-1]:
        cur = cur[int(p)] if isinstance(cur, list) else cur[p]
    return cur, parts[-1]


def apply_json_patch(doc: Any, patches: list[dict]) -> Any:
    """Apply add/remove/replace/copy/move/test ops to a JSON-ish doc."""
    doc = copy.deepcopy(doc)
    for op in patches:
        kind = op["op"]
        parts = _pointer_parts(op.get("path", ""))
        if kind in ("add", "replace"):
            value = op["value"]
            if not parts:
                doc = value
                continue
            parent, last = _resolve(doc, parts)
            if isinstance(parent, list):
                if last == "-":
                    parent.append(value)
                elif kind == "add":
                    parent.insert(int(last), value)
                else:
                    parent[int(last)] = value
            else:
                parent[last] = value
        elif kind == "remove":
            parent, last = _resolve(doc, parts)
            if isinstance(parent, list):
                parent.pop(int(last))
            else:
                del parent[last]
        elif kind in ("copy", "move"):
            src_parts = _pointer_parts(op["from"])
            sparent, slast = _resolve(doc, src_parts)
            val = sparent[int(slast)] if isinstance(sparent, list) else sparent[slast]
            val = copy.deepcopy(val)
            if kind == "move":
                if isinstance(sparent, list):
                    sparent.pop(int(slast))
                else:
                    del sparent[slast]
            parent, last = _resolve(doc, parts)
            if isinstance(parent, list):
                if last == "-":
                    parent.append(val)
                else:
                    parent.insert(int(last), val)
            else:
                parent[last] = val
        elif kind == "test":
            parent, last = _resolve(doc, parts)
            cur = parent[int(last)] if isinstance(parent, list) else parent[last]
            if cur != op["value"]:
                raise ValueError(f"test failed at {op['path']}: {cur!r} != {op['value']!r}")
        else:
            raise ValueError(f"unsupported patch op {kind!r}")
    return doc


def apply_json_patch_to_pod(patches: list[dict], pod: Pod) -> Pod:
    if not patches:
        return pod
    doc = apply_json_patch(_to_doc(pod), patches)
    return _rebuild_pod(doc)


def _rebuild_pod(doc: dict) -> Pod:
    from kubeai_tpu_torch.api.core_types import (
        Container,
        PodSpec,
        PodStatus,
        Probe,
        Volume,
        VolumeMount,
    )
    from kubeai_tpu_torch.runtime.store import ObjectMeta

    def build_container(c: dict) -> Container:
        cont = Container(**{k: v for k, v in c.items() if k not in ("volume_mounts", "startup_probe", "readiness_probe", "liveness_probe")})
        cont.volume_mounts = [VolumeMount(**m) for m in c.get("volume_mounts", [])]
        for probe_name in ("startup_probe", "readiness_probe", "liveness_probe"):
            p = c.get(probe_name)
            setattr(cont, probe_name, Probe(**p) if p else None)
        return cont

    spec_doc = doc.get("spec", {})
    spec = PodSpec(**{k: v for k, v in spec_doc.items() if k not in ("containers", "init_containers", "volumes")})
    spec.containers = [build_container(c) for c in spec_doc.get("containers", [])]
    spec.init_containers = [build_container(c) for c in spec_doc.get("init_containers", [])]
    spec.volumes = [Volume(**v) for v in spec_doc.get("volumes", [])]
    return Pod(
        meta=ObjectMeta(**doc.get("meta", {})),
        spec=spec,
        status=PodStatus(**doc.get("status", {})),
    )
