"""The port's chart renderer (kubeai_tpu_torch/utils/helmlite.py) against
the JAX package's (kubeai_tpu/utils/helmlite.py), on the CPU.

Every case of the one parametrised test renders a chart through both
renderers with the same value files, ``--set`` values, release name and
namespace: the documents must be equal, and so must the bytes each CLI's
``template`` writes (each ``main`` called in this process; one case runs
the port's CLI as ``python -m kubeai_tpu_torch.utils.helmlite``). The
charts are the JAX package's two (their defaults, ``-f`` overlays, the
``--set`` values of tests/test_helm_charts.py, escaped dots in catalog
names), the port's two, a chart whose define holds nested blocks, and
charts of unsupported syntax, which must raise the same ValueError in
both.
"""

import contextlib
import io
import os
import subprocess
import sys

import pytest
import yaml

from kubeai_tpu.utils import helmlite as jax_helmlite
from kubeai_tpu_torch.utils import helmlite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARTS = {
    "jax-operator": os.path.join(REPO, "charts", "kubeai-tpu"),
    "jax-models": os.path.join(REPO, "charts", "models"),
    "port-operator": os.path.join(REPO, "kubeai_tpu_torch", "charts", "kubeai-tpu-torch"),
    "port-models": os.path.join(REPO, "kubeai_tpu_torch", "charts", "models"),
}

# tests/test_helm_charts.py's overrides (a JSON list among them).
OVERRIDES = {
    "replicaCount": "3",
    "autoscaling.intervalSeconds": "5",
    "secrets.huggingface.name": "my-hf",
    "messaging.streams": ('[{"requestsUrl": "kafka://g?topic=req", '
                          '"responsesUrl": "kafka://resp", "maxHandlers": 2}]'),
}

# Every optional block of the operator charts switched on.
OVERLAY = {
    "ingress": {"enabled": True, "className": "nginx",
                "annotations": {"a.example.com/x": "1"},
                "tls": [{"hosts": ["kubeai.example.com"], "secretName": "tls"}],
                "rules": [{"host": "kubeai.example.com", "path": "/", "pathType": "Prefix"},
                          {"host": "b.example.com", "path": "/v1", "pathType": "Exact"}]},
    "metrics": {"prometheusOperator": {"enginePodMonitor": {
        "enabled": True, "apiVersion": "monitoring.coreos.com/v1",
        "labels": {"release": "prom"}}}},
    "cacheProfiles": {"standard-filestore": {"sharedFilesystem": {
        "storageClassName": "standard-rwx", "size": "100Gi"}}},
    "modelServerPods": {"serviceAccountName": "engines", "imagePullSecrets": ["pull"]},
    "secrets": {"aws": {"create": True, "accessKeyID": "k", "secretAccessKey": "s\\n\"q"},
                "gcp": {"create": True, "jsonKeyfile": '{"a": "b\\nc"}'},
                "alibaba": {"create": True, "accessKeyID": "i", "accessKeySecret": "j"}},
}


def _escaped(name: str) -> str:
    return name.replace(".", "\\.")


def _enable_all(chart: str) -> dict:
    with open(os.path.join(CHARTS[chart], "values.yaml")) as f:
        names = yaml.safe_load(f)["catalog"]
    return {"catalog": {n: {"enabled": True} for n in names}}


def _tiny_chart(root, templates: dict, values: str = "x: 1\n") -> str:
    chart = root / "c"
    (chart / "templates").mkdir(parents=True)
    (chart / "Chart.yaml").write_text("name: c\nversion: 0.1.0\n")
    (chart / "values.yaml").write_text(values)
    for name, text in templates.items():
        (chart / "templates" / name).write_text(text)
    return str(chart)


NESTED_DEFINE = {
    "_helpers.tpl": ('{{- define "c.fullname" -}}\n'
                     "{{- if .Values.fullnameOverride }}{{ .Values.fullnameOverride }}"
                     "{{- else }}{{ .Release.Name }}{{- end }}\n"
                     "{{- end }}\n"),
    "cm.yaml": 'kind: ConfigMap\nmetadata:\n  name: {{ include "c.fullname" . }}\n',
}

# (chart, overlay or None, --set values, release name, namespace)
CASES = {
    "jax-operator-defaults": ("jax-operator", None, {}, "kubeai", "default"),
    "jax-operator-release": ("jax-operator", None, {}, "rel", "kubeai-ns"),
    "jax-operator-sets": ("jax-operator", None, OVERRIDES, "kubeai", "default"),
    "jax-operator-overlay": ("jax-operator", OVERLAY, {"image.tag": "v1"}, "kubeai", "ops"),
    "jax-models-defaults": ("jax-models", None, {}, "kubeai", "default"),
    "jax-models-overlay": ("jax-models", "enable-all", {}, "kubeai", "default"),
    "jax-models-escaped-dots": ("jax-models", None, {
        "catalog." + _escaped("qwen2.5-7b-instruct-tpu") + ".enabled": "true",
        "catalog." + _escaped("llama-3.1-8b-instruct-tpu") + ".enabled": "true",
        "catalog." + _escaped("llama-3.1-8b-instruct-tpu") + ".spec.args":
            '["--max-seq-len", "4096"]'}, "kubeai", "default"),
    "port-operator-defaults": ("port-operator", None, {}, "kubeai", "default"),
    "port-operator-sets": ("port-operator", OVERLAY, OVERRIDES, "kubeai", "kubeai-ns"),
    "port-models-overlay": ("port-models", "enable-all", {}, "kubeai", "default"),
    "port-models-escaped-dots": ("port-models", None, {
        "catalog." + _escaped("qwen2.5-7b-instruct-h100") + ".enabled": "true"},
        "kubeai", "default"),
    # The port's CLI in a process of its own.
    "port-models-escaped-dots-cli-process": ("port-models", None, {
        "catalog." + _escaped("qwen2.5-7b-instruct-h100") + ".enabled": "true",
        "catalog.gemma-2b-it-h100.enabled": "true"}, "rel", "ns"),
    "nested-define": ("nested-define", None, {}, "rel", "default"),
    "nested-define-empty-override": ("nested-define", None, {"fullnameOverride": '""'},
                                     "rel", "default"),
    "unsupported-function": ({"bad.yaml": "a: {{ tpl .Values.x . }}\n"}, None, {}, "kubeai",
                             "default"),
    "unterminated-block": ({"bad.yaml": "{{ if .Values.x }}a: 1\n"}, None, {}, "kubeai",
                           "default"),
    "unexpected-end": ({"bad.yaml": "a: 1\n{{ end }}\n"}, None, {}, "kubeai", "default"),
    "undefined-include": ({"bad.yaml": 'a: {{ include "nope" . }}\n'}, None, {}, "kubeai",
                          "default"),
}


def _render(mod, args, process=False):
    """(documents, CLI bytes) of *mod*'s renderer, or its error; with
    *process* the CLI runs as ``python -m``."""
    chart, files, sets, name, ns = args
    try:
        docs = mod.render_chart(chart, files, sets, release_name=name, namespace=ns)
    except ValueError as e:
        return ("ValueError", str(e))
    argv = ["template", chart, "--name", name, "--namespace", ns]
    for f in files:
        argv += ["-f", f]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    if process:
        return docs, subprocess.run([sys.executable, "-m", mod.__name__, *argv],
                                    capture_output=True, check=True, cwd=REPO,
                                    timeout=60).stdout
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(argv)
    return docs, out.getvalue().encode()


@pytest.mark.parametrize("case", list(CASES))
def test_renders_equal_jax(case, tmp_path):
    chart, overlay, sets, name, ns = CASES[case]
    if isinstance(chart, dict):
        chart = _tiny_chart(tmp_path, chart)
    elif chart == "nested-define":
        chart = _tiny_chart(tmp_path, NESTED_DEFINE, "fullnameOverride: custom\n")
    else:
        if overlay == "enable-all":
            overlay = _enable_all(chart)
        chart = CHARTS[chart]
    files = []
    if overlay is not None:
        path = tmp_path / "overlay.yaml"
        path.write_text(yaml.safe_dump(overlay))
        files.append(str(path))
    args = (chart, files, sets, name, ns)
    got = _render(helmlite, args, process=case.endswith("cli-process"))
    want = _render(jax_helmlite, args)
    assert got == want
    if case.startswith("unsupported"):
        assert got[0] == "ValueError" and "unsupported template function" in got[1]
    elif got[0] != "ValueError":
        docs, _ = got
        if "escaped-dots" in case:
            assert sorted(d["metadata"]["name"] for d in docs) == sorted(
                k.split(".", 1)[1].rsplit(".enabled", 1)[0].replace("\\.", ".")
                for k in sets if k.endswith(".enabled"))
        if case == "nested-define":
            assert docs[0]["metadata"]["name"] == "custom"
        if case == "nested-define-empty-override":
            assert docs[0]["metadata"]["name"] == "rel"
        if case in ("jax-operator-overlay", "port-operator-sets"):
            assert {"Ingress", "PodMonitor"} <= {d["kind"] for d in docs}

