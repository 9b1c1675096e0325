"""The port's OpenAI proxy (kubeai_tpu_torch/proxy) against the JAX
package's, on the CPU.

- The cases of tests/test_apiutils.py run through both packages
  (tests/_torch_operator.py): ``parse_request``, ``parse_label_selector``
  and ``split_model_adapter`` give equal Requests (all but the random
  request id) or equal APIErrors on each test's bodies.
- A JAX stack and a port stack (store, reconciler, balancer, model
  client, ``ModelProxy`` with 2 retries, ``OpenAIServer``), each in front
  of its own stub upstream that follows the same script: an unknown
  model, a bad body, an upstream that fails every attempt, one that fails
  twice then answers, one that answers 429 with its own Retry-After, one
  that stalls past the client's X-Request-Timeout, a model with no ready
  endpoint, and a scale from zero. Both give the same status codes, the
  same Retry-After, the same number of upstream attempts and the same
  error text; the scale from zero sets replicas to 1 in both stores.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import test_apiutils as jtest_apiutils
from _torch_operator import jax_cases, plain, run_jax_case


@pytest.fixture(autouse=True)
def no_canary(monkeypatch):
    # A Manager's canary probes would land in the windows these tests
    # count requests and launches in: off, as before the port had one.
    monkeypatch.setenv("KUBEAI_CANARY", "0")


def _same_request(j, t):
    strip = (lambda doc: (doc[0], {k: v for k, v in doc[1].items() if k != "id"})
             if isinstance(doc, tuple) and doc[0] == "Request" else doc)
    return strip(plain(j)) == strip(plain(t))


@pytest.mark.parametrize("module,qual,params", jax_cases(jtest_apiutils))
def test_apiutils_cases_through_both_packages(module, qual, params, request, monkeypatch):
    calls = run_jax_case(module, qual, params,
                         (("parse_request", _same_request), "parse_label_selector",
                          "split_model_adapter"), request, monkeypatch)
    assert calls > 0


class Stub:
    """An upstream engine whose answers follow a script: "ok", "503",
    "429" (Retry-After: 7) or "stall" (1.5 s, then ok); past the script's
    end it repeats the last entry. Counts attempts."""

    def __init__(self, script):
        self.script, self.attempts = list(script), 0
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                what = outer.script[min(outer.attempts, len(outer.script) - 1)]
                outer.attempts += 1
                headers = {}
                if what == "stall":
                    time.sleep(1.5)
                    what = "ok"
                if what == "ok":
                    code, payload = 200, {"choices": [{"text": f"ok:{body.get('model')}"}]}
                elif what == "429":
                    code, payload = 429, {"error": {"message": "queue full"}}
                    headers["Retry-After"] = "7"
                else:
                    code, payload = 503, {"error": {"message": "boom"}}
                raw = json.dumps(payload).encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(raw)))
                    for k, v in headers.items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(raw)
                except OSError:
                    pass  # the proxy gave up on a stalled attempt

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_port
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()


def _packages(pkg):
    import importlib

    names = ("api.model_types", "api.core_types", "config.system", "controller.controller",
             "loadbalancer.balancer", "proxy.handler", "proxy.modelclient", "proxy.server",
             "runtime.store")
    return {n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}") for n in names}


class Stack:
    def __init__(self, pkg, await_timeout=0.3):
        m = self.m = _packages(pkg)
        self.store = m["store"].Store()
        system = m["system"].System().default_and_validate()
        system.allow_pod_address_override = True
        self.rec = m["controller"].ModelReconciler(self.store, system)
        self.lb = m["balancer"].LoadBalancer(self.store, allow_pod_address_override=True)
        mc = m["modelclient"].ModelClient(self.store)
        proxy = m["handler"].ModelProxy(mc, self.lb, max_retries=2,
                                        await_timeout=await_timeout)
        self.api = m["server"].OpenAIServer(proxy, mc, host="127.0.0.1", port=0)
        self.stubs = []
        for part in (self.rec, self.lb, self.api):
            part.start()

    def model(self, name, **kw):
        mt = self.m["model_types"]
        kw.setdefault("url", "hf://org/model")
        kw.setdefault("resource_profile", "cpu:1")
        self.store.create(mt.KIND_MODEL, mt.Model(meta=self.m["store"].ObjectMeta(name=name),
                                                  spec=mt.ModelSpec(**kw)))

    def point(self, pod_name, port):
        """Mark pod *pod_name* ready at 127.0.0.1:*port*."""
        mt = self.m["model_types"]

        def mutate(p):
            p.status.ready = True
            p.status.pod_ip = "127.0.0.1"
            p.meta.annotations[mt.ANNOTATION_MODEL_POD_IP] = "127.0.0.1"
            p.meta.annotations[mt.ANNOTATION_MODEL_POD_PORT] = str(port)

        self.store.mutate("Pod", pod_name, mutate)

    def serve(self, name, script):
        """A pod of *name* pointed at a new stub, marked ready."""
        mt = self.m["model_types"]
        stub = Stub(script)
        self.stubs.append(stub)
        deadline = time.monotonic() + 5
        while not (pods := self.store.list("Pod", selector={mt.LABEL_MODEL: name})):
            assert time.monotonic() < deadline, "no pod planned"
            time.sleep(0.01)
        self.point(pods[0].meta.name, stub.port)
        deadline = time.monotonic() + 5
        while not self.lb.get_all_addresses(name):
            assert time.monotonic() < deadline, "the balancer never saw the pod"
            time.sleep(0.01)
        return stub

    def post(self, body, headers=None, raw=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.api.port}/openai/v1/completions",
            data=raw if raw is not None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.headers.get("Retry-After"), json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After"), json.loads(e.read())

    def stop(self):
        for part in (self.api, self.lb, self.rec):
            part.stop()
        for s in self.stubs:
            s.stop()


def _error_text(doc):
    msg = (doc.get("error") or {}).get("message", "") if isinstance(doc, dict) else ""
    # Addresses (stub ports) differ between the stacks.
    import re
    return re.sub(r"127\.0\.0\.1:\d+", "ADDR", msg)


SCENARIOS = {
    "unknown_model": dict(model=None, body={"model": "ghost", "prompt": "x"}),
    "bad_body": dict(model={}, raw=b"{not json"),
    "invalid_field": dict(model={}, body={"model": "m", "prompt": 3.5}),
    "always_503": dict(model={"replicas": 1}, script=["503"]),
    "503_twice_then_ok": dict(model={"replicas": 1}, script=["503", "503", "ok"]),
    "429_backpressure": dict(model={"replicas": 1}, script=["429"]),
    "stall_past_timeout": dict(model={"replicas": 1}, script=["stall"],
                               headers={"X-Request-Timeout": "0.5"}),
    "no_ready_endpoint": dict(model={"replicas": 1}),
    "bad_priority": dict(model={"replicas": 1}, script=["ok"],
                         headers={"X-Priority": "urgent"}),
}


@pytest.fixture(scope="module")
def stacks():
    out = (Stack("kubeai_tpu"), Stack("kubeai_tpu_torch"))
    yield out
    for st in out:
        st.stop()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_proxy_status_codes_match_jax(name, stacks):
    sc = SCENARIOS[name]
    model = name.replace("_", "-")
    outs = []
    for st in stacks:
        if sc["model"] is not None:
            st.model(model, **sc["model"])
        stub = st.serve(model, sc["script"]) if sc.get("script") else None
        body = {k: (model if v == "m" else v) for k, v in
                sc.get("body", {"model": "m", "prompt": "hi"}).items()}
        status, retry_after, doc = st.post(body, sc.get("headers"), sc.get("raw"))
        outs.append((status, retry_after, stub.attempts if stub else None,
                     _error_text(doc), doc.get("choices")))
    assert outs[0] == outs[1]
    want = {"unknown_model": 404, "bad_body": 400, "invalid_field": 400, "always_503": 503,
            "503_twice_then_ok": 200, "429_backpressure": 429, "stall_past_timeout": 504,
            "no_ready_endpoint": 503, "bad_priority": 400}[name]
    assert outs[0][0] == want, outs[0]


def test_scale_from_zero_matches_jax(stacks, monkeypatch):
    outs = []
    for st in stacks:
        monkeypatch.setattr(st.api.proxy, "await_timeout", 20.0)
        st.model("zero", min_replicas=0)
        got = {}
        t = threading.Thread(target=lambda: got.update(r=st.post(
            {"model": "zero", "prompt": "hi"}, {"X-Request-Timeout": "20"})))
        t.start()
        stub = st.serve("zero", ["ok"])
        t.join(30)
        outs.append((got["r"][0], got["r"][2]["choices"], stub.attempts,
                     st.store.get("Model", "zero").spec.replicas))
    assert outs[0] == outs[1] == (200, [{"text": "ok:zero"}], 1, 1)
