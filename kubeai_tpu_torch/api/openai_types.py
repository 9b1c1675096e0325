"""Typed OpenAI API request surface: validation + unknown-field passthrough.

Port of kubeai_tpu/api/openai_types.py: the JAX package's code,
its imports in this package.

The reference achieves engine-arg passthrough by decoding into typed Go
structs that stash unrecognized JSON (`Unknown jsontext.Value ",unknown"`,
ref: api/openai/v1/chat_completions.go:513-514). The idiomatic Python
equivalent: requests stay as the parsed dict (so every field round-trips
byte-for-byte up to JSON re-encoding) behind typed accessor wrappers that
implement the GetModel/SetModel/Prefix interface
(ref: api/openai/v1 model interfaces, apiutils/request.go:207-225).

`validate()` enforces the KNOWN fields' shapes (messages structure,
prompt/input types, sampling ranges, streaming options, embedding
encoding_format, ...) so malformed requests fail at the proxy with a
clean 400 instead of surfacing as engine 500s — while fields we don't
know about pass through untouched, exactly like the reference's
",unknown" stash."""

from __future__ import annotations

import json
from typing import Any

ROLES = {"system", "user", "assistant", "tool", "developer", "function"}

# OpenAI's documented logit_bias entry cap. The engine's default
# EngineConfig.max_logit_bias equals this so a request that passes proxy
# validation can never 400 downstream at the engine server (ADVICE r5:
# the layers previously disagreed, 300 here vs 32 there).
LOGIT_BIAS_CAP = 300


class ValidationError(ValueError):
    """Raised for malformed request bodies (mapped to HTTP 400)."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValidationError(msg)


def _check_number(data: dict, field: str, lo=None, hi=None) -> None:
    v = data.get(field)
    if v is None:
        return
    _check(isinstance(v, (int, float)) and not isinstance(v, bool),
           f"'{field}' must be a number")
    if lo is not None:
        _check(v >= lo, f"'{field}' must be >= {lo}")
    if hi is not None:
        _check(v <= hi, f"'{field}' must be <= {hi}")


def _check_int(data: dict, field: str, lo=None, hi=None) -> None:
    v = data.get(field)
    if v is None:
        return
    _check(isinstance(v, int) and not isinstance(v, bool), f"'{field}' must be an integer")
    if lo is not None:
        _check(v >= lo, f"'{field}' must be >= {lo}")
    if hi is not None:
        _check(v <= hi, f"'{field}' must be <= {hi}")


def _check_stop(data: dict) -> None:
    v = data.get("stop")
    if v is None:
        return
    ok = isinstance(v, str) or (
        isinstance(v, list) and all(isinstance(s, str) for s in v)
    )
    _check(ok, "'stop' must be a string or list of strings")


def _check_sampling(data: dict) -> None:
    _check_number(data, "temperature", lo=0)
    _check_number(data, "top_p", lo=0, hi=1)
    _check_number(data, "presence_penalty", lo=-2, hi=2)
    _check_number(data, "frequency_penalty", lo=-2, hi=2)
    _check_int(data, "max_tokens", lo=1)
    _check_int(data, "max_completion_tokens", lo=1)
    _check_int(data, "n", lo=1)
    _check_int(data, "seed")
    _check_int(data, "top_k", lo=0)
    _check_int(data, "top_logprobs", lo=0, hi=20)
    lb = data.get("logit_bias")
    if lb is not None:
        _check(isinstance(lb, dict), "'logit_bias' must be an object")
        _check(len(lb) <= LOGIT_BIAS_CAP,
               f"'logit_bias' supports at most {LOGIT_BIAS_CAP} entries")
        for k, v in lb.items():
            _check(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                and -100 <= v <= 100,  # also rejects NaN (comparisons False)
                "'logit_bias' values must be numbers in [-100, 100]",
            )
            try:
                _check(int(k) >= 0, "'logit_bias' keys must be token ids")
            except (TypeError, ValueError):
                _check(False, "'logit_bias' keys must be token ids")
    _check_stop(data)
    if data.get("echo") is not None:
        _check(isinstance(data["echo"], bool), "'echo' must be a boolean")
    if "stream" in data:
        _check(isinstance(data["stream"], bool), "'stream' must be a boolean")
    so = data.get("stream_options")
    if so is not None:
        _check(isinstance(so, dict), "'stream_options' must be an object")
        _check(data.get("stream") is True, "'stream_options' requires 'stream': true")
        if "include_usage" in so:
            _check(isinstance(so["include_usage"], bool),
                   "'stream_options.include_usage' must be a boolean")


def _is_token_array(v) -> bool:
    return (
        isinstance(v, list)
        and len(v) > 0
        and all(isinstance(t, int) and not isinstance(t, bool) for t in v)
    )


class _Body:
    """Base wrapper: the raw dict is the source of truth."""

    def __init__(self, data: dict[str, Any]):
        if not isinstance(data, dict):
            raise ValidationError("request body must be a JSON object")
        self.data = data

    def validate(self) -> None:
        model = self.data.get("model")
        if model is not None:
            _check(isinstance(model, str), "'model' must be a string")

    def get_model(self) -> str:
        return str(self.data.get("model", ""))

    def set_model(self, model: str) -> None:
        self.data["model"] = model

    def prefix(self, n: int) -> str:
        return ""

    @property
    def stream(self) -> bool:
        return bool(self.data.get("stream"))

    def to_bytes(self) -> bytes:
        return json.dumps(self.data).encode()


class ChatCompletionRequest(_Body):
    @property
    def messages(self) -> list[dict]:
        return self.data.get("messages") or []

    def validate(self) -> None:
        super().validate()
        msgs = self.data.get("messages")
        _check(isinstance(msgs, list) and len(msgs) > 0,
               "'messages' must be a non-empty array")
        for i, msg in enumerate(msgs):
            _check(isinstance(msg, dict), f"messages[{i}] must be an object")
            role = msg.get("role")
            _check(isinstance(role, str) and role in ROLES,
                   f"messages[{i}].role must be one of {sorted(ROLES)}")
            content = msg.get("content")
            if content is None:
                # Assistant tool-call turns may carry no content.
                _check(role == "assistant" and ("tool_calls" in msg or "function_call" in msg),
                       f"messages[{i}].content is required")
                continue
            if isinstance(content, str):
                continue
            _check(isinstance(content, list),
                   f"messages[{i}].content must be a string or array of parts")
            for j, part in enumerate(content):
                _check(isinstance(part, dict) and isinstance(part.get("type"), str),
                       f"messages[{i}].content[{j}] must be an object with a 'type'")
                if part["type"] == "text":
                    _check(isinstance(part.get("text"), str),
                           f"messages[{i}].content[{j}].text must be a string")
        tools = self.data.get("tools")
        if tools is not None:
            _check(isinstance(tools, list), "'tools' must be an array")
            for i, tool in enumerate(tools):
                _check(isinstance(tool, dict) and isinstance(tool.get("type"), str),
                       f"tools[{i}] must be an object with a 'type'")
                if tool["type"] == "function":
                    fn = tool.get("function")
                    _check(isinstance(fn, dict) and isinstance(fn.get("name"), str),
                           f"tools[{i}].function.name is required")
        tc = self.data.get("tool_choice")
        if tc is not None:
            _check(isinstance(tc, (str, dict)),
                   "'tool_choice' must be a string or object")
        _check_sampling(self.data)

    def prefix(self, n: int) -> str:
        """First user message's text, first n chars
        (ref: chat_completions.go:525-543)."""
        for msg in self.messages:
            if msg.get("role") == "user":
                content = msg.get("content")
                if isinstance(content, str):
                    return content[:n]
                if isinstance(content, list):  # content parts
                    for part in content:
                        if isinstance(part, dict) and part.get("type") == "text":
                            return str(part.get("text", ""))[:n]
                return ""
        return ""


class CompletionRequest(_Body):
    def validate(self) -> None:
        super().validate()
        prompt = self.data.get("prompt")
        _check(prompt is not None, "'prompt' is required")
        ok = (
            isinstance(prompt, str)
            or _is_token_array(prompt)
            or (
                isinstance(prompt, list)
                and len(prompt) > 0
                and (
                    all(isinstance(p, str) for p in prompt)
                    or all(_is_token_array(p) for p in prompt)
                )
            )
        )
        _check(ok, "'prompt' must be a string, array of strings, array of "
                   "tokens, or array of token arrays")
        _check_int(self.data, "logprobs", lo=0)
        _check_sampling(self.data)

    def prefix(self, n: int) -> str:
        prompt = self.data.get("prompt")
        if isinstance(prompt, str):
            return prompt[:n]
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], str):
            return prompt[0][:n]
        return ""


class EmbeddingRequest(_Body):
    def validate(self) -> None:
        super().validate()
        inp = self.data.get("input")
        _check(inp is not None, "'input' is required")
        ok = (
            isinstance(inp, str)
            or _is_token_array(inp)
            or (
                isinstance(inp, list)
                and len(inp) > 0
                and (
                    all(isinstance(p, str) for p in inp)
                    or all(_is_token_array(p) for p in inp)
                )
            )
        )
        _check(ok, "'input' must be a string, array of strings, array of "
                   "tokens, or array of token arrays")
        fmt = self.data.get("encoding_format")
        if fmt is not None:
            _check(fmt in ("float", "base64"),
                   "'encoding_format' must be 'float' or 'base64'")
        _check_int(self.data, "dimensions", lo=1)


class RerankRequest(_Body):
    def validate(self) -> None:
        super().validate()
        _check(isinstance(self.data.get("query"), str), "'query' must be a string")
        docs = self.data.get("documents")
        _check(
            isinstance(docs, list) and len(docs) > 0
            and all(isinstance(d, str) for d in docs),
            "'documents' must be a non-empty array of strings",
        )
        _check_int(self.data, "top_n", lo=1)


class TranscriptionRequest(_Body):
    """Multipart transcription requests carry the model as a form field;
    apiutils strips it before proxying (ref: apiutils/request.go:109-165)."""


# Path suffix -> wrapper type (ref: apiutils/request.go:167-205).
BODY_TYPES = {
    "/v1/chat/completions": ChatCompletionRequest,
    "/v1/completions": CompletionRequest,
    "/v1/embeddings": EmbeddingRequest,
    "/v1/rerank": RerankRequest,
    "/v1/audio/transcriptions": TranscriptionRequest,
}


def body_for_path(path: str, data: dict) -> _Body:
    for suffix, cls in BODY_TYPES.items():
        if path.endswith(suffix):
            body = cls(data)
            body.validate()
            return body
    raise LookupError(f"unsupported inference path {path!r}")
