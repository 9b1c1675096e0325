"""helmlite — render Helm charts without the helm binary (port of
kubeai_tpu/utils/helmlite.py: the same renderer, its output equal to the
JAX package's byte for byte).

The port ships its own charts inside the package
(kubeai_tpu_torch/charts/kubeai-tpu-torch, kubeai_tpu_torch/charts/models);
this module implements the Go-template subset those charts (and the JAX
package's) use so CI and air-gapped environments can render and validate
them with `python -m kubeai_tpu_torch.utils.helmlite template <chart>
[-f values.yaml] [--set a.b=c] [--name N] [--namespace NS]` producing the
same manifests `helm template` would.

Supported template syntax:
- {{ .Values.x.y }}, {{ .Release.Name }}, {{ .Release.Namespace }},
  {{ .Chart.Name }}, {{ .Chart.Version }}
- {{- ... }} / {{ ... -}} whitespace trimming
- {{ if PIPE }} / {{ else if PIPE }} / {{ else }} / {{ end }}
- {{ range .list }} / {{ range $k, $v := .map }} / {{ end }}
- {{ define "name" }} / {{ include "name" CTX }}
- pipelines: toYaml, indent N, nindent N, quote, default, eq, not,
  trunc N, trimSuffix, printf, b64enc
- variables: $, $name (from range bindings)

Intentionally NOT a general Go-template engine: unsupported constructs
raise, so a chart edit that silently needs real helm is caught in CI.
"""

from __future__ import annotations

import base64
import json
import os
import re
import sys
from dataclasses import dataclass

import yaml

_ACTION_RE = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.S)


@dataclass
class _Tok:
    kind: str  # "text" | "action"
    value: str


def _tokenize(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    pos = 0
    for m in _ACTION_RE.finditer(src):
        text = src[pos : m.start()]
        if m.group(1) == "-":
            text = text.rstrip()
        if text:
            toks.append(_Tok("text", text))
        toks.append(_Tok("action", m.group(2)))
        pos = m.end()
        if m.group(3) == "-":
            # Trim following whitespace: mark by peeking at next emit.
            rest = src[pos:]
            trimmed = rest.lstrip()
            pos += len(rest) - len(trimmed)
    tail = src[pos:]
    if tail:
        toks.append(_Tok("text", tail))
    return toks


# -- AST ---------------------------------------------------------------------


@dataclass
class _Text:
    s: str


@dataclass
class _Out:
    pipe: str


@dataclass
class _If:
    arms: list  # [(pipe or None for else, nodes)]


@dataclass
class _Range:
    vars: tuple[str | None, str | None]  # ($k, $v) or (None, None)
    pipe: str
    body: list


def _parse(toks: list[_Tok], i: int = 0, in_block: bool = False):
    """Returns (nodes, next_i, terminator_action or None)."""
    nodes: list = []
    while i < len(toks):
        t = toks[i]
        if t.kind == "text":
            nodes.append(_Text(t.value))
            i += 1
            continue
        a = t.value
        if a.startswith("/*") or a.startswith("#"):
            i += 1
            continue
        if a == "end" or a == "else" or a.startswith("else if "):
            if not in_block:
                raise ValueError(f"unexpected {{{{ {a} }}}}")
            return nodes, i, a
        if a.startswith("if "):
            arms = []
            cond = a[3:]
            while True:
                body, i, term = _parse(toks, i + 1, in_block=True)
                arms.append((cond, body))
                if term == "end":
                    break
                if term == "else":
                    body, i, term = _parse(toks, i + 1, in_block=True)
                    arms.append((None, body))
                    if term != "end":
                        raise ValueError("else must be followed by end")
                    break
                cond = term[len("else if ") :]
            nodes.append(_If(arms))
            i += 1
            continue
        if a.startswith("range "):
            expr = a[len("range ") :]
            m = re.match(r"^\$(\w+)\s*,\s*\$(\w+)\s*:=\s*(.*)$", expr)
            if m:
                vars_, pipe = (m.group(1), m.group(2)), m.group(3)
            else:
                m1 = re.match(r"^\$(\w+)\s*:=\s*(.*)$", expr)
                if m1:
                    vars_, pipe = (None, m1.group(1)), m1.group(2)
                else:
                    vars_, pipe = (None, None), expr
            body, i, term = _parse(toks, i + 1, in_block=True)
            if term != "end":
                raise ValueError("range must end with end")
            nodes.append(_Range(vars_, pipe, body))
            i += 1
            continue
        if a.startswith("define "):
            # handled at file scope by Renderer; skip bodies here
            raise ValueError("define must be at top level of a template file")
        nodes.append(_Out(a))
        i += 1
    if in_block:
        raise ValueError("unterminated block (missing {{ end }})")
    return nodes, i, None


# -- evaluation --------------------------------------------------------------


def _truthy(v) -> bool:
    if v is None or v is False:
        return False
    if isinstance(v, (str, bytes, list, dict, tuple)):
        return len(v) > 0
    if isinstance(v, (int, float)):
        return v != 0
    return True


def _to_yaml(v) -> str:
    return yaml.safe_dump(v, default_flow_style=False, sort_keys=False).rstrip("\n")


def _indent(n: int, s: str) -> str:
    pad = " " * n
    return "\n".join(pad + line if line else line for line in str(s).split("\n"))


# Pipeline function table (sprig-compatible semantics for the supported
# subset). `quote` matches Go %q via JSON escaping — backslashes and
# newlines in values (e.g. GCP keyfiles) must survive a YAML round-trip.
_FNS = {
    "toYaml": lambda v: _to_yaml(v),
    "toJson": lambda v: json.dumps(v),
    "quote": lambda v: json.dumps(str(v)),
    "indent": lambda n, v: _indent(n, v),
    "nindent": lambda n, v: "\n" + _indent(n, v),
    "default": lambda d, v=None: v if _truthy(v) else d,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "not": lambda v: not _truthy(v),
    "and": lambda *vs: all(_truthy(v) for v in vs),
    "or": lambda *vs: next((v for v in vs if _truthy(v)), vs[-1]),
    "trunc": lambda n, v: str(v)[:n],
    "trimSuffix": lambda suf, v: str(v).removesuffix(suf),
    "printf": lambda fmt, *vs: fmt % tuple(vs),
    "b64enc": lambda v: base64.b64encode(str(v).encode()).decode(),
    "len": lambda v: len(v),
}


class Renderer:
    def __init__(self, defines: dict[str, list] | None = None):
        self.defines = defines or {}

    # expression atoms: quoted string, number, $var.path, .path, (call)
    def _atom(self, tok: str, ctx: dict):
        if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
            return tok[1:-1].encode().decode("unicode_escape")
        if re.fullmatch(r"-?\d+", tok):
            return int(tok)
        if re.fullmatch(r"-?\d+\.\d+", tok):
            return float(tok)
        if tok in ("true", "false"):
            return tok == "true"
        if tok == "nil":
            return None
        if tok == ".":
            return ctx["."]
        if tok == "$":
            return ctx["$"]
        if tok.startswith("$"):
            name, _, path = tok[1:].partition(".")
            base = ctx["vars"][name]
            return self._walk(base, path)
        if tok.startswith("."):
            return self._walk(ctx["."], tok[1:])
        raise ValueError(f"unsupported expression atom {tok!r}")

    @staticmethod
    def _walk(base, path: str):
        if not path:
            return base
        cur = base
        for part in path.split("."):
            if cur is None:
                return None
            if isinstance(cur, dict):
                cur = cur.get(part)
            else:
                cur = getattr(cur, part, None)
        return cur

    def _split_args(self, s: str) -> list[str]:
        out, cur, depth, inq = [], "", 0, False
        for ch in s:
            if inq:
                cur += ch
                if ch == '"' and not cur.endswith('\\"'):
                    inq = False
                continue
            if ch == '"':
                inq = True
                cur += ch
            elif ch == "(":
                depth += 1
                cur += ch
            elif ch == ")":
                depth -= 1
                cur += ch
            elif ch.isspace() and depth == 0:
                if cur:
                    out.append(cur)
                    cur = ""
            else:
                cur += ch
        if cur:
            out.append(cur)
        return out

    def _call(self, parts: list[str], ctx: dict, piped=_ACTION_RE):
        """Evaluate one pipeline stage. `piped` sentinel = no piped arg."""
        name = parts[0]
        raw_args = parts[1:]

        def ev(tok):
            if tok.startswith("(") and tok.endswith(")"):
                return self._eval_pipe(tok[1:-1], ctx)
            return self._atom(tok, ctx)

        if name == "include":
            tpl_name = ev(raw_args[0])
            dot = ev(raw_args[1]) if len(raw_args) > 1 else ctx["."]
            return self._render_define(tpl_name, dot, ctx["$"])
        args = [ev(a) for a in raw_args]
        if piped is not _ACTION_RE:
            args.append(piped)
        if name not in _FNS:
            # Bare value expression with no function call.
            if not raw_args and piped is _ACTION_RE:
                return self._atom(name, ctx)
            raise ValueError(f"unsupported template function {name!r}")
        return _FNS[name](*args)

    def _eval_pipe(self, pipe: str, ctx: dict):
        stages = [s.strip() for s in self._split_pipeline(pipe)]
        val = _ACTION_RE  # sentinel: nothing piped yet
        for stage in stages:
            parts = self._split_args(stage)
            if not parts:
                raise ValueError(f"empty pipeline stage in {pipe!r}")
            val = self._call(parts, ctx, piped=val)
        return val

    @staticmethod
    def _split_pipeline(pipe: str) -> list[str]:
        out, cur, depth, inq = [], "", 0, False
        for ch in pipe:
            if inq:
                cur += ch
                if ch == '"':
                    inq = False
                continue
            if ch == '"':
                inq = True
                cur += ch
            elif ch == "(":
                depth += 1
                cur += ch
            elif ch == ")":
                depth -= 1
                cur += ch
            elif ch == "|" and depth == 0:
                out.append(cur)
                cur = ""
            else:
                cur += ch
        out.append(cur)
        return out

    def _render_define(self, name: str, dot, root) -> str:
        if name not in self.defines:
            raise ValueError(f"include of undefined template {name!r}")
        return self.render_nodes(self.defines[name], dot, root)

    def render_nodes(self, nodes: list, dot, root, vars_: dict | None = None) -> str:
        ctx = {".": dot, "$": root, "vars": vars_ or {}}
        out: list[str] = []
        for node in nodes:
            if isinstance(node, _Text):
                out.append(node.s)
            elif isinstance(node, _Out):
                v = self._eval_pipe(node.pipe, ctx)
                out.append("" if v is None else str(v))
            elif isinstance(node, _If):
                for cond, body in node.arms:
                    if cond is None or _truthy(self._eval_pipe(cond, ctx)):
                        out.append(self.render_nodes(body, dot, root, ctx["vars"]))
                        break
            elif isinstance(node, _Range):
                coll = self._eval_pipe(node.pipe, ctx)
                items = (
                    list(coll.items()) if isinstance(coll, dict)
                    else list(enumerate(coll or []))
                )
                kvar, vvar = node.vars
                for k, v in items:
                    sub_vars = dict(ctx["vars"])
                    if kvar:
                        sub_vars[kvar] = k
                    if vvar:
                        sub_vars[vvar] = v
                    out.append(self.render_nodes(node.body, v, root, sub_vars))
            else:
                raise TypeError(node)
        return "".join(out)


# -- chart loading -----------------------------------------------------------


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _extract_defines(src: str, renderer: Renderer) -> list[_Tok]:
    """Pull {{ define "x" }}...{{ end }} blocks out of the token stream
    (depth-aware, so define bodies may contain if/range blocks — the
    stock Helm helper pattern) and return the remaining tokens.
    Whitespace-trim markers were already applied by _tokenize, so bodies
    carry no stray newlines into inline {{ include }} expansions."""
    toks = _tokenize(src)
    out: list[_Tok] = []
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.kind == "action" and t.value.startswith("define "):
            m = re.match(r'^define\s+"([^"]+)"$', t.value)
            if not m:
                raise ValueError(f"malformed define action {t.value!r}")
            depth = 1
            body: list[_Tok] = []
            j = i + 1
            while j < len(toks):
                tj = toks[j]
                if tj.kind == "action":
                    if tj.value.startswith(("if ", "range ", "define ", "with ")):
                        depth += 1
                    elif tj.value == "end":
                        depth -= 1
                        if depth == 0:
                            break
                body.append(tj)
                j += 1
            if depth != 0:
                raise ValueError(f'unterminated define "{m.group(1)}"')
            nodes, _, _ = _parse(body)
            renderer.defines[m.group(1)] = nodes
            i = j + 1
        else:
            out.append(t)
            i += 1
    return out


def render_chart(
    chart_dir: str,
    value_files: list[str] | None = None,
    sets: dict[str, str] | None = None,
    release_name: str = "kubeai",
    namespace: str = "default",
) -> list[dict]:
    """Render every template; returns the parsed manifest documents."""
    with open(os.path.join(chart_dir, "Chart.yaml")) as f:
        chart_meta = yaml.safe_load(f)
    values_path = os.path.join(chart_dir, "values.yaml")
    values: dict = {}
    if os.path.exists(values_path):
        with open(values_path) as f:
            values = yaml.safe_load(f) or {}
    for vf in value_files or []:
        with open(vf) as f:
            values = _deep_merge(values, yaml.safe_load(f) or {})
    for key, val in (sets or {}).items():
        cur = values
        # Helm-style escaping: `\.` is a literal dot inside a key
        # segment (model names like qwen2.5-... need it).
        parts = [p.replace("\\.", ".") for p in re.split(r"(?<!\\)\.", key)]
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = yaml.safe_load(val)

    root = {
        "Values": values,
        "Release": {"Name": release_name, "Namespace": namespace},
        "Chart": {
            "Name": chart_meta.get("name", ""),
            "Version": str(chart_meta.get("version", "")),
        },
    }

    renderer = Renderer()
    tmpl_dir = os.path.join(chart_dir, "templates")
    files = sorted(os.listdir(tmpl_dir))
    # First pass: collect defines from helpers.
    sources: list[tuple[str, list[_Tok]]] = []
    for name in files:
        if not (name.endswith(".yaml") or name.endswith(".tpl")):
            continue
        with open(os.path.join(tmpl_dir, name)) as f:
            toks = _extract_defines(f.read(), renderer)
        if not name.startswith("_"):
            sources.append((name, toks))

    docs: list[dict] = []
    for name, toks in sources:
        nodes, _, _ = _parse(toks)
        text = renderer.render_nodes(nodes, root, root)
        for doc in yaml.safe_load_all(text):
            if doc:
                docs.append(doc)
    # CRDs ship alongside templates (helm's crds/ dir).
    crds_dir = os.path.join(chart_dir, "crds")
    if os.path.isdir(crds_dir):
        for name in sorted(os.listdir(crds_dir)):
            with open(os.path.join(crds_dir, name)) as f:
                for doc in yaml.safe_load_all(f):
                    if doc:
                        docs.append(doc)
    return docs


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("helmlite")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("template", help="render a chart to stdout")
    t.add_argument("chart")
    t.add_argument("-f", "--values", action="append", default=[])
    t.add_argument("--set", action="append", default=[], dest="sets")
    t.add_argument("--name", default="kubeai")
    t.add_argument("--namespace", default="default")
    args = p.parse_args(argv)

    sets = {}
    for s in args.sets:
        k, _, v = s.partition("=")
        sets[k] = v
    docs = render_chart(
        args.chart, args.values, sets, release_name=args.name, namespace=args.namespace
    )
    out = []
    for doc in docs:
        out.append(yaml.safe_dump(doc, default_flow_style=False, sort_keys=False))
    sys.stdout.write("---\n".join(out))


if __name__ == "__main__":
    main()
