"""The port's LocalRuntime marks a pod Ready only on its own server.

free_port() hands a pod a port that is free only until the pod binds it.
Where another process takes that port first, the pod exits, but a probe
of the port still answers: LocalRuntime must not mark the pod Ready on
that foreign server's answer (the proxy would route the Model's requests
there)."""

from __future__ import annotations

import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubeai_tpu_torch.api.core_types import KIND_POD, Container, Pod, PodSpec
from kubeai_tpu_torch.runtime import local
from kubeai_tpu_torch.runtime.local import LocalRuntime, group_listens_on
from kubeai_tpu_torch.runtime.store import ObjectMeta, Store

# A server answering 200 on every GET, on the port LocalRuntime appends.
SERVER = """
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer
class H(BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200)
        self.end_headers()
    def log_message(self, *a):
        pass
HTTPServer(("127.0.0.1", int(sys.argv[-1])), H).serve_forever()
"""


class _Ok(BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def test_group_listens_on_its_own_socket_only():
    port = local.free_port()
    proc = subprocess.Popen([sys.executable, "-c", SERVER, "--port", str(port)],
                            start_new_session=True)
    held = socket.socket()
    try:
        held.bind(("127.0.0.1", 0))
        held.listen()
        assert _wait(lambda: group_listens_on(proc.pid, port))
        assert group_listens_on(proc.pid, held.getsockname()[1]) is False
    finally:
        held.close()
        proc.kill()
        proc.wait()


def test_a_foreign_server_on_the_pods_port_does_not_make_it_ready(monkeypatch):
    foreign = ThreadingHTTPServer(("127.0.0.1", 0), _Ok)
    threading.Thread(target=foreign.serve_forever, daemon=True).start()
    ports = iter([foreign.server_address[1], local.free_port()])
    monkeypatch.setattr(local, "free_port", lambda: next(ports))
    store = Store()
    rt = LocalRuntime(store, restart_crashed=False)
    rt.start()

    def pod(name, code):
        store.create(KIND_POD, Pod(meta=ObjectMeta(name=name), spec=PodSpec(containers=[
            Container(name="server", command=[sys.executable, "-c", code])])))

    def ready(name):
        return store.get(KIND_POD, name).status.ready

    try:
        # The squatted pod's process lives but never binds: the foreign
        # server answers every probe of its port.
        pod("squatted", "import time; time.sleep(60)")
        assert _wait(lambda: "squatted" in rt._procs)
        pod("own", SERVER)
        assert _wait(lambda: ready("own")), "a pod serving on its own port never became Ready"
        time.sleep(1.0)  # four more health-loop rounds
        assert not ready("squatted")
        assert store.get(KIND_POD, "squatted").status.phase == "Running"
    finally:
        rt.stop()
        foreign.shutdown()
        foreign.server_close()
