"""HTTP client of the engine's adapter routes (port of
kubeai_tpu/controller/engineclient.py): JSON POSTs to
/v1/load_lora_adapter and /v1/unload_lora_adapter; unloading an adapter
the engine does not hold counts as done.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request


class EngineClient:
    def __init__(self, timeout: float = 120.0):
        self.timeout = timeout

    def _post(self, addr: str, path: str, body: dict) -> tuple[int, str]:
        req = urllib.request.Request(
            f"http://{addr}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def load_lora_adapter(self, addr: str, name: str, path: str) -> None:
        status, body = self._post(
            addr, "/v1/load_lora_adapter", {"lora_name": name, "lora_path": path}
        )
        # No already-loaded tolerance here: a conflict means the engine
        # holds DIFFERENT weights under this name (same name + same path
        # returns 200); the reconciler must unload first.
        if status != 200:
            raise RuntimeError(f"load adapter {name} on {addr}: {status} {body[:200]}")

    def unload_lora_adapter(self, addr: str, name: str) -> None:
        status, body = self._post(addr, "/v1/unload_lora_adapter", {"lora_name": name})
        if status != 200 and "not" not in body:
            raise RuntimeError(f"unload adapter {name} on {addr}: {status} {body[:200]}")
