"""Request parsing: body -> (model, adapter, prefix, rewritten body).

Port of kubeai_tpu/proxy/apiutils.py: the JAX package's code,
its imports in this package.

Parity: internal/apiutils/request.go:64-232 and model.go:23-37 —
"model_adapter" ids split on the first underscore, adapter name written
back into the body's model field (engines serve adapters as model ids),
prefix extracted for PrefixHash routing, label-selector lookup semantics
with 404/400 distinctions.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.openai_types import _Body, body_for_path


class APIError(Exception):
    def __init__(self, code: int, message: str, headers: dict[str, str] | None = None):
        super().__init__(message)
        self.code = code
        self.message = message
        # Extra response headers (e.g. Retry-After on 429/503 so clients
        # back off instead of synchronized-retry-storming the operator).
        self.headers = headers or {}


@dataclass
class Request:
    id: str = ""
    model_name: str = ""
    adapter: str = ""
    prefix: str = ""
    selectors: dict[str, str] = field(default_factory=dict)
    body: _Body | None = None
    raw_body: bytes | None = None  # multipart passthrough (model field stripped)
    model_obj: object = None
    # obs.SpanBuilder attached by the proxy handler (duck-typed so this
    # module stays import-light); the load balancer annotates its
    # endpoint-pick span onto it when present.
    trace: object = None
    # Client-requested end-to-end budget in seconds (body "timeout" field
    # or X-Request-Timeout header; the proxy budgets it across await /
    # connect / stream and forwards the remainder to the engine).
    timeout: float | None = None
    # Disaggregated phase-role routing preference ("prefill" | "decode"
    # | ""), set by the proxy per request and FLIPPED at the handoff
    # point — endpoint selection prefers this pool and fails open to
    # the surviving one.
    role: str = ""
    # Tenant attribution (obs/tenants.py): the HASHED tenant id derived
    # from the request's credentials (never the raw key), forwarded
    # engine-ward as X-KubeAI-Tenant. canary marks synthetic probes
    # excluded from all tenant accounting; meter is the per-request
    # RequestMeter the terminal paths finish (duck-typed, import-light).
    tenant: str = ""
    canary: bool = False
    meter: object = None
    # QoS class (kubeai_tpu/qos): resolved once by the proxy handler
    # (X-Priority header > body "priority" field > tenant default) and
    # stamped engine-ward as X-Priority after the inbound copy is
    # stripped. priority_hint carries the body field's raw value —
    # proxy-consumed like "timeout", stripped before forwarding.
    priority: str = ""
    priority_hint: str = ""

    @property
    def load_balancing(self) -> mt.LoadBalancing:
        if self.model_obj is not None:
            return self.model_obj.spec.load_balancing
        return mt.LoadBalancing()

    def body_bytes(self) -> bytes:
        if self.raw_body is not None:
            return self.raw_body
        return self.body.to_bytes() if self.body else b""


def sanitize_request_id(rid: str) -> str:
    """Correlation ids go into HTTP headers and log lines: restrict to a
    safe charset (a newline would fail http.client's header validation
    and allow log forging) and bound the length. Returns "" when nothing
    safe remains — callers fall back to a generated id.

    Delegates to the canonical rule in obs.trace: the proxy and engine
    derive trace ids from the SANITIZED request id, so the two rules
    drifting apart would silently break the cross-hop trace join."""
    from kubeai_tpu_torch.obs.trace import sanitize_request_id as _canonical

    return _canonical(rid)


def split_model_adapter(s: str) -> tuple[str, str]:
    """"model_adapter" -> (model, adapter); parity: model.go:23-37."""
    model, sep, adapter = s.partition("_")
    return model, adapter if sep else ""


def parse_label_selector(header: str | None) -> dict[str, str]:
    """X-Label-Selector: "k=v,k2=v2"."""
    out: dict[str, str] = {}
    if not header:
        return out
    for part in header.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise APIError(400, f"bad label selector segment {part!r}")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip().strip('"')
    return out


def parse_multipart_model(raw_body: bytes, content_type: str) -> tuple[str, bytes]:
    """Extract the `model` form field from a multipart body and return
    (model_value, body_without_model_field) — the FasterWhisper workaround
    the reference carries (ref: apiutils/request.go:109-165: the engine
    rejects unknown served-model names, so the field is stripped)."""
    import email
    import email.policy

    idx = content_type.lower().find("boundary=")
    if idx < 0:
        raise APIError(400, "no boundary in multipart content-type")
    boundary = content_type[idx + len("boundary=") :].split(";")[0].strip().strip('"')

    delim = b"--" + boundary.encode()
    parts = raw_body.split(delim)
    model_value = ""
    kept: list[bytes] = []
    # parts[0] is the preamble, the last part is the closing "--\r\n".
    for part in parts[1:-1]:
        chunk = part.lstrip(b"\r\n")
        header_blob, _, _body = chunk.partition(b"\r\n\r\n")
        msg = email.message_from_bytes(header_blob, policy=email.policy.HTTP)
        # Parse the disposition's `name` parameter properly: a substring
        # test would also match filename="model" on a file part.
        field = msg.get_param("name", header="Content-Disposition")
        if field == "model":
            model_value = _body.rstrip(b"\r\n").decode(errors="replace")
            continue
        kept.append(part)
    if not model_value:
        raise APIError(400, "missing 'model' form field")
    if not kept:
        raise APIError(400, "multipart body has no content parts besides 'model'")
    new_body = delim + delim.join(kept) + delim + b"--\r\n"
    return model_value, new_body


# End-to-end deadline bounds: a sub-millisecond budget can't cover one
# RTT, and an unbounded one defeats the point of deadlines.
MIN_REQUEST_TIMEOUT = 0.001
MAX_REQUEST_TIMEOUT = 3600.0


def parse_request_timeout(value, source: str) -> float:
    """Validate a client-supplied end-to-end timeout (seconds)."""
    try:
        t = float(value)
    except (TypeError, ValueError):
        raise APIError(400, f"{source} must be a number of seconds")
    if not (t == t) or t in (float("inf"), float("-inf")):
        raise APIError(400, f"{source} must be finite")
    if t < MIN_REQUEST_TIMEOUT:
        raise APIError(400, f"{source} must be >= {MIN_REQUEST_TIMEOUT}s")
    return min(t, MAX_REQUEST_TIMEOUT)


def parse_request(model_client, raw_body: bytes, path: str, headers: dict[str, str]) -> Request:
    """Decode + validate + rewrite; parity: ParseRequest
    (ref: apiutils/request.go:64-107). JSON bodies are rewritten (adapter
    ids); multipart bodies (audio transcription) pass through with the
    model field stripped."""
    import uuid

    # Header names are case-insensitive; the dict preserves wire casing.
    content_type = next(
        (v for k, v in headers.items() if k.lower() == "content-type"), ""
    )
    # End-to-end budget: the X-Request-Timeout header wins over the body
    # "timeout" field (a gateway in front of us can clamp every request
    # without parsing bodies).
    timeout_hdr = next(
        (v for k, v in headers.items() if k.lower() == "x-request-timeout"), ""
    )
    timeout = (
        parse_request_timeout(timeout_hdr, "X-Request-Timeout")
        if timeout_hdr
        else None
    )

    if content_type.lower().startswith("multipart/form-data"):
        requested, new_body = parse_multipart_model(raw_body, content_type)
        model_name, adapter = split_model_adapter(requested)
        selectors = parse_label_selector(headers.get("X-Label-Selector"))
        model = model_client.lookup_model(model_name, adapter, selectors)
        return Request(
            id=uuid.uuid4().hex,
            model_name=model_name,
            adapter=adapter,
            selectors=selectors,
            raw_body=new_body,
            model_obj=model,
            timeout=timeout,
        )

    try:
        data = json.loads(raw_body or b"{}")
    except json.JSONDecodeError as e:
        raise APIError(400, f"invalid JSON body: {e}")
    # "timeout" is proxy-consumed, not an OpenAI field: strip it before
    # validation/forwarding (the engine learns the budget via the
    # X-Request-Deadline header the proxy stamps per attempt).
    if isinstance(data, dict) and "timeout" in data:
        field_timeout = parse_request_timeout(data.pop("timeout"), "timeout")
        if timeout is None:
            timeout = field_timeout
    # "priority" is proxy-consumed the same way: the resolved class
    # travels engine-ward as the restamped X-Priority header, never as a
    # body field the engine would reject as unknown.
    priority_hint = ""
    if isinstance(data, dict) and "priority" in data:
        priority_hint = str(data.pop("priority") or "")
    try:
        body = body_for_path(path, data)
    except LookupError as e:
        raise APIError(404, str(e))
    except ValueError as e:
        raise APIError(400, str(e))

    requested = body.get_model()
    if not requested:
        raise APIError(400, "missing 'model' field")
    model_name, adapter = split_model_adapter(requested)

    selectors = parse_label_selector(headers.get("X-Label-Selector"))
    model = model_client.lookup_model(model_name, adapter, selectors)

    req = Request(
        id=uuid.uuid4().hex,
        model_name=model_name,
        adapter=adapter,
        prefix="",
        selectors=selectors,
        body=body,
        model_obj=model,
        timeout=timeout,
        priority_hint=priority_hint,
    )
    if model.spec.load_balancing.strategy == mt.PREFIX_HASH_STRATEGY:
        req.prefix = body.prefix(model.spec.load_balancing.prefix_hash.prefix_char_length)

    # The engine serves adapters under their bare adapter name
    # (ref: apiutils rewrite + engine /v1/models adapter ids).
    body.set_model(adapter if adapter else model_name)
    return req
