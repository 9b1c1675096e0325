"""OpenAI-compatible HTTP server over the port's engine (slim port of
kubeai_tpu/engine/server.py).

    GET  /health                 liveness (+ engine readiness)
    GET  /v1/models              the served model
    POST /v1/completions         (+ SSE streaming)
    POST /v1/chat/completions    (+ SSE streaming)

Responses keep the JAX server's shapes: the same ``usage`` block, the
completions ``logprobs`` object (tokens / token_logprobs / top_logprobs)
and the chat ``logprobs.content`` list. One choice per request (``n`` > 1
is refused); LoRA, embeddings, KV handoff, QoS headers, metrics and the
debug routes are not ported yet (ROADMAP queue 1).

Run: ``python -m kubeai_tpu_torch.engine.server --model preset:llama-3.1-8b``
(on the card; ``--device cpu --model test:tiny`` for a CPU smoke run).
The presets, random weights at published widths: ``llama-3.1-8b``,
``qwen2.5-7b``, ``gemma-2b``, ``gemma2-2b`` and ``mixtral-8x7b``
(Mixtral's 32 bf16 layers need more than one 80 GB card; chip_smoke.py
serves 16 of them through ``build_engine(..., num_layers=16)``).
``--model <dir>`` serves an HF-format checkpoint directory
(engine/weights.py), and ``--quantization int8`` serves a preset, a
checkpoint or test:tiny with int8 weights through the W8A16 kernels.
``--kv-cache-dtype fp8|int8`` stores the paged KV pool at one byte per
element; the paged kernels dequantize it. ``--warmup`` (default on with
KUBEAI_ENGINE_WARMUP=1, as in the JAX server) runs every step shape,
the decode chunk's CUDA graph capture included, before serving.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubeai_tpu_torch.engine.core import (
    Engine,
    EngineConfig,
    build_engine,
    build_test_engine,
)
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.weights import load_engine_from_path

log = logging.getLogger("kubeai_tpu_torch.engine.server")

RETRY_AFTER_HINT = "1"
STREAM_WAIT_S = 600.0


class EngineServer:
    def __init__(self, engine: Engine, model_name: str, host: str = "0.0.0.0", port: int = 8000):
        self.engine = engine
        self.model_name = model_name
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_port
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        log.info("engine server for %s on :%d", self.model_name, self.port)

    def stop(self) -> None:
        """Stop the engine first (in-flight requests get terminal events),
        then the HTTP server."""
        try:
            self.engine.stop()
        finally:
            self.httpd.shutdown()
            self.httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=10)


def _make_handler(srv: EngineServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("%s " + fmt, self.address_string(), *args)

        def _json(self, code: int, obj, headers: dict | None = None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str, etype: str = "invalid_request_error", headers=None):
            self._json(code, {"error": {"message": msg, "type": etype}}, headers=headers)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path in ("/health", "/healthz"):
                ready = srv.engine.is_ready()
                self._json(200 if ready else 503, {
                    "status": "ok" if ready else "engine not ready",
                    "model": srv.model_name,
                })
            elif path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": srv.model_name, "object": "model", "owned_by": "kubeai-tpu"},
                ]})
            else:
                self._error(404, f"no route {path}")

        def do_POST(self):
            path = self.path.split("?")[0]
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._error(400, f"invalid JSON: {e}")
            if not isinstance(body, dict):
                return self._error(400, "request body must be a JSON object")
            try:
                if path == "/v1/completions":
                    self._completions(body, chat=False)
                elif path == "/v1/chat/completions":
                    self._completions(body, chat=True)
                else:
                    self._error(404, f"no route {path}")
            except (BrokenPipeError, ConnectionResetError):
                pass
            except Exception as e:  # the handler thread must answer
                log.exception("request failed")
                try:
                    self._error(500, str(e), "internal_error")
                except OSError:
                    pass

        # ---- request parsing ----

        def _params(self, body: dict, chat: bool):
            """(SamplingParams, top_n, want_logprobs) or None after an error."""
            eng = srv.engine

            def num(key, default):
                v = body.get(key)
                return default if v is None else v

            stop = body.get("stop") or ()
            if isinstance(stop, str):
                stop = (stop,)
            if not all(isinstance(s, str) for s in stop):
                return self._error(400, "stop must be a string or list of strings")
            max_tokens = body.get("max_tokens", body.get("max_completion_tokens"))
            if max_tokens is None:
                max_tokens = 16 if not chat else eng.cfg.default_max_tokens
            elif not isinstance(max_tokens, int) or isinstance(max_tokens, bool) or max_tokens < 1:
                return self._error(400, "max_tokens must be a positive integer")
            bias_raw = body.get("logit_bias") or {}
            if not isinstance(bias_raw, dict):
                return self._error(400, "logit_bias must be an object")
            if len(bias_raw) > eng.cfg.max_logit_bias:
                return self._error(
                    400, f"logit_bias supports at most {eng.cfg.max_logit_bias} entries"
                )
            logit_bias = []
            for k, v in bias_raw.items():
                try:
                    tok_id, val = int(k), float(v)
                except (TypeError, ValueError):
                    return self._error(400, "logit_bias keys must be token ids, values numbers")
                if tok_id < 0 or tok_id >= eng.model_config.vocab_size or val != val \
                        or val in (float("inf"), float("-inf")):
                    return self._error(400, "logit_bias requires valid token ids and finite values")
                logit_bias.append((tok_id, max(-100.0, min(100.0, val))))
            lp_field = body.get("logprobs")
            want_logprobs = lp_field is not None and lp_field is not False
            if chat:
                top_n = body.get("top_logprobs") or 0
                if top_n and not want_logprobs:
                    return self._error(400, "logprobs must be set to true if top_logprobs is used")
            else:
                top_n = lp_field if isinstance(lp_field, int) and not isinstance(lp_field, bool) else 0
            if not isinstance(top_n, int) or isinstance(top_n, bool) or top_n < 0:
                return self._error(400, "top_logprobs must be a non-negative integer")
            if top_n > eng.cfg.top_logprobs_k:
                return self._error(
                    400, f"at most {eng.cfg.top_logprobs_k} alternative logprobs are supported"
                )
            seed = body.get("seed")
            if seed is not None and (not isinstance(seed, int) or isinstance(seed, bool)):
                return self._error(400, "seed must be an integer")
            try:
                params = SamplingParams(
                    temperature=float(num("temperature", 1.0)),
                    top_p=float(num("top_p", 1.0)),
                    top_k=int(num("top_k", 0)),
                    max_tokens=max_tokens,
                    stop=tuple(stop),
                    seed=seed,
                    logprobs=want_logprobs,
                    presence_penalty=float(num("presence_penalty", 0.0)),
                    frequency_penalty=float(num("frequency_penalty", 0.0)),
                    logit_bias=tuple(logit_bias),
                )
            except (TypeError, ValueError) as e:
                return self._error(400, f"invalid sampling parameter: {e}")
            return params, top_n, want_logprobs

        def _prompt(self, body: dict, chat: bool):
            """(prompt_ids, prompt_text or None) or None after an error."""
            tok = srv.engine.tokenizer
            if chat:
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages or not all(
                    isinstance(m, dict) and isinstance(m.get("content"), str) for m in messages
                ):
                    return self._error(400, "messages is required")
                text = tok.apply_chat_template(messages, add_generation_prompt=True)
                return tok.encode(text), text
            prompt = body.get("prompt")
            if isinstance(prompt, list) and len(prompt) == 1 and not isinstance(prompt[0], int):
                prompt = prompt[0]
            if isinstance(prompt, str):
                return tok.encode(prompt), prompt
            if isinstance(prompt, list) and prompt and all(
                isinstance(x, int) and not isinstance(x, bool) for x in prompt
            ):
                return list(prompt), None
            return self._error(400, "prompt must be a string or a token id list")

        def _completions(self, body: dict, chat: bool):
            got = self._prompt(body, chat)
            if got is None:
                return
            prompt_ids, prompt_text = got
            got = self._params(body, chat)
            if got is None:
                return
            params, top_n, want_logprobs = got
            if body.get("n") not in (None, 1):
                return self._error(400, "n > 1 is not supported by this engine")
            echo = body.get("echo")
            if echo is not None and not isinstance(echo, bool):
                return self._error(400, "echo must be a boolean")
            so = body.get("stream_options")
            if so is not None and (not isinstance(so, dict) or not body.get("stream")):
                return self._error(400, "stream_options must be an object and requires stream: true")
            try:
                req = srv.engine.submit(prompt_ids, params)
            except ValueError as e:
                return self._error(400, str(e))
            except queue.Full:
                return self._error(
                    429, "engine saturated; retry after backoff", "rate_limit_error",
                    headers={"Retry-After": RETRY_AFTER_HINT},
                )
            except RuntimeError as e:
                return self._error(503, str(e), "service_unavailable")
            rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
            echo_text = ""
            if not chat and echo:
                echo_text = prompt_text if prompt_text is not None else srv.engine.tokenizer.decode(prompt_ids)
            ctx = dict(rid=rid, created=int(time.time()), chat=chat,
                       want_logprobs=want_logprobs, top_n=top_n, echo_text=echo_text)
            try:
                if body.get("stream"):
                    self._stream(req, include_usage=bool((so or {}).get("include_usage")),
                                 prompt_tokens=len(prompt_ids), **ctx)
                else:
                    self._full(req, **ctx)
            finally:
                req.cancelled.set()  # a no-op once the request finished

        # ---- responses ----

        def _token_text(self, token_id: int) -> str:
            return srv.engine.tokenizer.decode([token_id])

        def _top_entries(self, top, top_n, chat):
            if not top_n or not top:
                return None
            pairs = top[:top_n]
            if chat:
                return [{"token": self._token_text(t), "logprob": lp} for t, lp in pairs]
            out = {}
            for t, lp in pairs:
                out.setdefault(self._token_text(t), lp)
            return out

        def _lp_completion(self, pieces, top_n):
            return {
                "tokens": [self._token_text(t) for t, _, _ in pieces],
                "token_logprobs": [lp for _, lp, _ in pieces],
                "top_logprobs": (
                    [self._top_entries(top, top_n, False) or {} for _, _, top in pieces]
                    if top_n else None
                ),
            }

        def _lp_chat(self, pieces, top_n):
            content = []
            for t, lp, top in pieces:
                entry = {"token": self._token_text(t), "logprob": lp}
                if top_n:
                    entry["top_logprobs"] = self._top_entries(top, top_n, True) or []
                content.append(entry)
            return {"content": content}

        def _full(self, req, rid, created, chat, want_logprobs, top_n, echo_text):
            chunks, pieces = [], []
            while True:
                try:
                    ev = req.out.get(timeout=STREAM_WAIT_S)
                except queue.Empty:
                    return self._error(504, "generation timed out", "timeout_error")
                if ev[0] == "token":
                    chunks.append(ev[2])
                    if ev[1] >= 0 and ev[3] is not None:
                        pieces.append((ev[1], ev[3], ev[4]))
                elif ev[0] == "done":
                    fin = ev[1]
                    break
                else:
                    return self._error(500, ev[1], "internal_error")
            text = "".join(chunks)
            if chat:
                choice = {"index": 0, "message": {"role": "assistant", "content": text},
                          "finish_reason": fin.reason}
                if want_logprobs:
                    choice["logprobs"] = self._lp_chat(pieces, top_n)
            else:
                choice = {"index": 0, "text": echo_text + text, "finish_reason": fin.reason}
                if want_logprobs:
                    choice["logprobs"] = self._lp_completion(pieces, top_n)
            self._json(200, {
                "id": rid, "object": "chat.completion" if chat else "text_completion",
                "created": created, "model": srv.model_name, "choices": [choice],
                "usage": {
                    "prompt_tokens": fin.prompt_tokens,
                    "completion_tokens": fin.completion_tokens,
                    "total_tokens": fin.prompt_tokens + fin.completion_tokens,
                },
            })

        def _stream(self, req, rid, created, chat, want_logprobs, top_n, echo_text,
                    include_usage, prompt_tokens):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            obj = "chat.completion.chunk" if chat else "text_completion"

            def send(payload: str):
                data = f"data: {payload}\n\n".encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            def chunk(choice, **extra):
                send(json.dumps({"id": rid, "object": obj, "created": created,
                                 "model": srv.model_name, "choices": [choice], **extra}))

            def end():
                send("[DONE]")
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

            emitted = 0
            if chat:
                chunk({"index": 0, "delta": {"role": "assistant"}, "finish_reason": None})
            elif echo_text:
                chunk({"index": 0, "text": echo_text, "finish_reason": None})
            while True:
                try:
                    ev = req.out.get(timeout=STREAM_WAIT_S)
                except queue.Empty:
                    ev = ("error", "generation timed out")
                if ev[0] == "token":
                    emitted += ev[1] >= 0
                    has_lp = want_logprobs and ev[1] >= 0 and ev[3] is not None
                    if not ev[2] and not has_lp:
                        continue
                    pieces = [(ev[1], ev[3], ev[4])] if has_lp else []
                    if chat:
                        choice = {"index": 0, "delta": {"content": ev[2]}, "finish_reason": None}
                        if has_lp:
                            choice["logprobs"] = self._lp_chat(pieces, top_n)
                    else:
                        choice = {"index": 0, "text": ev[2], "finish_reason": None}
                        if has_lp:
                            choice["logprobs"] = self._lp_completion(pieces, top_n)
                    chunk(choice)
                elif ev[0] == "done":
                    fin = ev[1]
                    chunk({"index": 0, "delta": {}, "finish_reason": fin.reason} if chat
                          else {"index": 0, "text": "", "finish_reason": fin.reason})
                    if include_usage:
                        emitted = fin.completion_tokens
                        send(json.dumps({
                            "id": rid, "object": obj, "created": created,
                            "model": srv.model_name, "choices": [],
                            "usage": {"prompt_tokens": prompt_tokens,
                                      "completion_tokens": emitted,
                                      "total_tokens": prompt_tokens + emitted},
                        }))
                    return end()
                else:
                    send(json.dumps({"error": {"message": ev[1]}}))
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                    return

    return Handler


# ---------------------------------------------------------------------------
# CLI


def make_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("kubeai-tpu-torch-engine")
    p.add_argument("--model", required=True,
                   help="an HF checkpoint dir, test:tiny, or preset:NAME (random weights; NAME "
                        "llama-3.1-8b, qwen2.5-7b, gemma-2b, gemma2-2b or mixtral-8x7b)")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--tensor-parallel-size", type=int, default=1, choices=[1])
    p.add_argument("--quantization", default="", choices=["", "int8"],
                   help="int8: weight-only int8 (W8A16 kernel on CUDA)")
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=64, help="KV pool tokens per page")
    p.add_argument("--speculate-tokens", type=int, default=0,
                   help="draft tokens verified per decode step via n-gram prompt "
                        "lookup (greedy-exact; 0 disables)")
    p.add_argument("--decode-kernel", default="ragged", choices=["ragged", "dedicated", "auto"])
    p.add_argument("--kv-cache-dtype", default="", choices=["", "fp8", "int8"],
                   help="store the paged KV pool in fp8 (e4m3) or int8 (static scales, "
                        "kv_scale_k/v of the model config: 1.0 unless set there); "
                        "halves the pool's bytes")
    p.add_argument("--prefix-cache-min", type=int, default=16,
                   help="min shared-prefix tokens reused across slots (0 disables)")
    p.add_argument("--warmup", action="store_true",
                   default=os.environ.get("KUBEAI_ENGINE_WARMUP", "0") == "1",
                   help="run every step shape (on CUDA: capture the decode chunk's graph) "
                        "before serving, so the first request pays for none")
    return p


def build_engine_from_args(args) -> tuple[Engine, str]:
    """The engine and served name of a command line; with ``--warmup`` the
    engine has run Engine.warmup (its result in ``engine.warmup_result``)."""
    eng, name = _engine_from_args(args)
    if getattr(args, "warmup", False):
        eng.warmup()
    return eng, name


def _engine_from_args(args) -> tuple[Engine, str]:
    ec = EngineConfig(
        max_slots=args.max_slots, max_seq_len=args.max_seq_len, page_size=args.page_size,
        decode_kernel=args.decode_kernel, speculate_tokens=args.speculate_tokens,
        prefix_cache_min=args.prefix_cache_min,
        kv_cache_dtype=args.kv_cache_dtype,
    )
    name = args.served_model_name or args.model
    if args.model.startswith("test:"):
        ec.prefill_buckets = (16, 32, 64, 128)
        return build_test_engine(ec, seed=args.seed, device=args.device,
                                 quantization=args.quantization), name
    if args.model.startswith("preset:"):
        return build_engine(args.model[len("preset:"):], args.device, ec, seed=args.seed,
                            quantization=args.quantization), name
    return load_engine_from_path(args.model, ec, tp=args.tensor_parallel_size,
                                 quantization=args.quantization, device=args.device), name


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    args = make_arg_parser().parse_args(argv)
    engine, name = build_engine_from_args(args)
    srv = EngineServer(engine, name, host=args.host, port=args.port)
    srv.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()


if __name__ == "__main__":
    main()
