"""LocalRuntime: runs Pod objects as local subprocesses (port of
kubeai_tpu/runtime/local.py).

The kubelet's stand-in for operation without a cluster (a workstation, a
single GPU machine, the end-to-end tests): it watches Pods in the store,
launches the server container's command as a subprocess (rewriting
``--port`` to a free one), marks the pod Ready while its ``/readyz`` (or
``/health``) answers 200 from a socket its own process group listens on,
relaunches a crashed pod after an exponential
backoff (``CrashBackoff``), and kills the process group when the pod is
deleted. Jobs run to completion the same way. ``extra_env`` is added to
every process's environment (the tests' ``--device cpu`` engines need
none; a card's caller passes its compile-cache and staging directories).
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import subprocess
import threading
import time

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.core_types import KIND_JOB, KIND_POD, Pod
from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.runtime.store import NotFound, Store
from kubeai_tpu_torch import env_float as _env_float

log = logging.getLogger("kubeai_tpu_torch.localruntime")

# Pod phase surfaced while a crashed pod waits out its restart backoff
# (mirrors the kubelet's waiting-state reason). The pod reads not-ready
# (status.ready False), so the balancer routes around it; operators see
# WHY in the phase instead of a bare "Failed".
CRASH_LOOP_PHASE = "CrashLoopBackOff"

M_POD_RESTARTS = default_registry.counter(
    "kubeai_pod_restarts_total",
    "pod subprocess restarts performed by the local runtime after a "
    "crash (post-backoff relaunches, labeled by model)",
)


class CrashBackoff:
    """Exponential restart backoff with reset-after-stable, one per pod.

    Each crash doubles the delay before the next relaunch (base * 2^k,
    capped) so a wedged model stops hot-looping; a process that stayed
    up for *stable_reset* seconds before dying counts as having been
    healthy — its next crash starts the schedule over at *base*. Pure
    host-side math over an injectable *clock* so chaos tests drive the
    whole schedule deterministically."""

    def __init__(
        self,
        base: float = 1.0,
        cap: float = 60.0,
        stable_reset: float = 120.0,
        clock=time.monotonic,
    ):
        self.base = base
        self.cap = cap
        self.stable_reset = stable_reset
        self._clock = clock
        self.crashes = 0  # consecutive crashes (resets after stability)
        self.restarts = 0  # total relaunches performed
        self._started_at: float | None = None

    def on_start(self) -> None:
        self._started_at = self._clock()

    def on_exit(self) -> float:
        """Record a process exit; returns the backoff delay (seconds)
        before the next relaunch."""
        now = self._clock()
        if (
            self._started_at is not None
            and now - self._started_at >= self.stable_reset
        ):
            self.crashes = 0  # it ran stably; forgive the history
        self._started_at = None
        self.crashes += 1
        return min(self.base * (2 ** (self.crashes - 1)), self.cap)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group_listens_on(pgid: int, port: int) -> bool | None:
    """Whether a process of process group *pgid* holds a TCP socket
    listening on *port*, from /proc; None where /proc cannot tell. The
    port free_port() gave a pod is free only until the pod binds it, and
    another process may take it first: the pod then exits, and the server
    that answers its probes is not its own."""
    inodes, tables = set(), 0
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                lines = f.read().splitlines()[1:]
        except OSError:
            continue
        tables += 1
        for line in lines:
            fields = line.split()
            if fields[3] == "0A" and int(fields[1].rsplit(":", 1)[1], 16) == port:
                inodes.add(f"socket:[{fields[9]}]")
    if not tables:
        return None
    for pid in (d for d in os.listdir("/proc") if d.isdigit()):
        try:
            with open(f"/proc/{pid}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[2]) != pgid:
                    continue
            fds = os.listdir(f"/proc/{pid}/fd")
            if any(os.readlink(f"/proc/{pid}/fd/{fd}") in inodes for fd in fds):
                return True
        except (OSError, ValueError, IndexError):
            continue
    return False


class LocalProcess:
    def __init__(self, pod_name: str, proc: subprocess.Popen, port: int):
        self.pod_name = pod_name
        self.proc = proc
        self.port = port
        self.ready = False


class LocalRuntime:
    def __init__(
        self,
        store: Store,
        namespace: str = "default",
        repo_root: str | None = None,
        extra_env: dict[str, str] | None = None,
        restart_crashed: bool | None = None,
        crash_backoff_base: float | None = None,
        crash_backoff_cap: float | None = None,
        crash_stable_reset: float | None = None,
        clock=time.monotonic,
    ):
        self.store = store
        self.namespace = namespace
        self.repo_root = repo_root or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        self.extra_env = extra_env or {}
        self._procs: dict[str, LocalProcess] = {}
        self._gang_ports: dict[str, int] = {}  # slice-id -> coordinator port
        self._lock = threading.Lock()
        self._running = False
        self._threads: list[threading.Thread] = []
        # Crash-loop supervision (the kubelet restart-policy analogue):
        # a crashed pod process is relaunched after exponential backoff
        # instead of staying dead forever (or hot-looping). Knobs come
        # from the constructor (tests) or KUBEAI_CRASH_* env.
        self.restart_crashed = (
            os.environ.get("KUBEAI_CRASH_RESTARTS", "1") not in ("0", "false", "no")
            if restart_crashed is None
            else restart_crashed
        )
        self.crash_backoff_base = (
            _env_float("KUBEAI_CRASH_BACKOFF_BASE", 1.0)
            if crash_backoff_base is None
            else crash_backoff_base
        )
        self.crash_backoff_cap = (
            _env_float("KUBEAI_CRASH_BACKOFF_CAP", 60.0)
            if crash_backoff_cap is None
            else crash_backoff_cap
        )
        self.crash_stable_reset = (
            _env_float("KUBEAI_CRASH_STABLE_RESET", 120.0)
            if crash_stable_reset is None
            else crash_stable_reset
        )
        self._clock = clock
        self._backoffs: dict[str, CrashBackoff] = {}  # pod name -> schedule
        self._pending_restarts: dict[str, float] = {}  # pod name -> due time

    def start(self):
        self._running = True
        t = threading.Thread(target=self._watch_loop, name="local-runtime", daemon=True)
        t.start()
        self._threads.append(t)
        t2 = threading.Thread(target=self._health_loop, name="local-runtime-health", daemon=True)
        t2.start()
        self._threads.append(t2)

    def stop(self):
        self._running = False
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for lp in procs:
            self._kill(lp)
        for t in self._threads:
            t.join(timeout=5)

    # -- pod lifecycle -----------------------------------------------------

    def _watch_loop(self):
        q = self.store.watch()  # Pods AND Jobs
        while self._running:
            try:
                ev = q.get(timeout=0.1)
            except Exception:
                continue
            try:
                if ev.kind == KIND_POD:
                    if ev.type == "ADDED":
                        self._launch(ev.obj)
                    elif ev.type == "DELETED":
                        with self._lock:
                            lp = self._procs.pop(ev.obj.meta.name, None)
                            # A deleted pod must not restart out of the
                            # grave (nor keep its crash history).
                            self._pending_restarts.pop(ev.obj.meta.name, None)
                            self._backoffs.pop(ev.obj.meta.name, None)
                        if lp:
                            self._kill(lp)
                elif ev.kind == KIND_JOB and ev.type == "ADDED":
                    self._run_job(ev.obj)
            except Exception:
                log.exception("pod event handling failed")

    def _container_env(self, server, namespace: str) -> dict[str, str]:
        """Plain env values plus the kubelet's envFrom-secretRef analogue:
        `__envFromSecret_<name>` markers resolve against Secret objects
        in the store (missing secrets are skipped — optional:true, same
        as the rendered manifests)."""
        from kubeai_tpu_torch.api.core_types import KIND_SECRET

        env: dict[str, str] = {}
        for k, v in server.env.items():
            if not k.startswith("__envFromSecret_"):
                env[k] = v
                continue
            try:
                sec = self.store.get(KIND_SECRET, v, namespace)
            except NotFound:
                continue
            env.update(sec.data)
        return env

    def _run_job(self, job):
        """Execute a Job's container to completion in a worker thread and
        record success/failure in its status (the kubelet's job controller
        analogue; cache loader/eviction Jobs run through this)."""
        if not job.spec.containers:
            return
        server = job.spec.containers[0]
        cmd = list(server.command) + list(server.args)
        env = dict(os.environ)
        env.update(self._container_env(server, job.meta.namespace))
        env.update(self.extra_env)
        env["PYTHONPATH"] = self.repo_root + os.pathsep + env.get("PYTHONPATH", "")

        def run():
            try:
                rc = subprocess.run(
                    cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT
                ).returncode
            except OSError as e:
                log.error("job %s failed to start: %s", job.meta.name, e)
                rc = 127

            def mutate(j):
                if rc == 0:
                    j.status.succeeded += 1
                else:
                    j.status.failed += 1

            try:
                self.store.mutate(KIND_JOB, job.meta.name, mutate, job.meta.namespace)
            except NotFound:
                pass

        t = threading.Thread(target=run, name=f"job-{job.meta.name}", daemon=True)
        t.start()
        self._threads.append(t)

    def _launch(self, pod: Pod):
        with self._lock:
            if pod.meta.name in self._procs:
                return
        if not pod.spec.containers:
            return
        server = pod.spec.containers[0]
        cmd = list(server.command) + list(server.args)
        if not cmd:
            return
        port = free_port()
        cmd = self._rewrite_port(cmd, port)
        env = dict(os.environ)
        env.update(self._container_env(server, pod.meta.namespace))
        env.update(self.extra_env)
        env["PYTHONPATH"] = self.repo_root + os.pathsep + env.get("PYTHONPATH", "")
        if "TPU_WORKER_HOSTNAMES" in env:
            # Multi-host slice gang running as local processes: the
            # controller's subdomain DNS names don't resolve here —
            # everyone is 127.0.0.1 and the gang shares one coordinator
            # port keyed by slice-id (rank 0 listens on it).
            sid = pod.meta.labels.get("slice-id", pod.meta.name)
            n_hosts = len([h for h in env["TPU_WORKER_HOSTNAMES"].split(",") if h.strip()])
            with self._lock:
                gang_port = self._gang_ports.get(sid)
                if gang_port is None:
                    gang_port = self._gang_ports[sid] = free_port()
                # Second per-slice port: rank 0's lockstep dispatch
                # stream (engine/gang.py); distinct pods share one IP
                # here, unlike in-cluster where the default port works.
                data_port = self._gang_ports.get(sid + "/dispatch")
                if data_port is None:
                    data_port = self._gang_ports[sid + "/dispatch"] = free_port()
            env["TPU_WORKER_HOSTNAMES"] = ",".join(["127.0.0.1"] * n_hosts)
            env["TPU_COORDINATOR_PORT"] = str(gang_port)
            env["KUBEAI_GANG_PORT"] = str(data_port)
        log.info("launching pod %s: %s (port %d)", pod.meta.name, " ".join(cmd[:4]), port)
        # KUBEAI_POD_LOGS=<dir> tees pod output to per-pod files (the
        # LocalRuntime analogue of `kubectl logs`; indispensable when a
        # gang rank dies during bring-up).
        logdir = os.environ.get("KUBEAI_POD_LOGS", "")
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            stdout = open(os.path.join(logdir, f"{pod.meta.name}.log"), "ab")
        else:
            stdout = subprocess.DEVNULL
        try:
            proc = subprocess.Popen(
                cmd,
                env=env,
                stdout=stdout,
                stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        except OSError as e:
            log.error("failed to launch pod %s: %s", pod.meta.name, e)
            self._set_status(pod.meta.name, phase="Failed")
            return
        finally:
            if stdout is not subprocess.DEVNULL:
                stdout.close()  # the child holds its own dup of the fd
        with self._lock:
            self._procs[pod.meta.name] = LocalProcess(pod.meta.name, proc, port)
            # Stability clock for reset-after-stable: a process that
            # lives >= crash_stable_reset before dying restarts the
            # backoff schedule from base.
            self._backoffs.setdefault(
                pod.meta.name,
                CrashBackoff(
                    self.crash_backoff_base,
                    self.crash_backoff_cap,
                    self.crash_stable_reset,
                    self._clock,
                ),
            ).on_start()
        self._set_status(pod.meta.name, phase="Running", scheduled=True, pod_ip="127.0.0.1", port=port)

    @staticmethod
    def _rewrite_port(cmd: list[str], port: int) -> list[str]:
        out = []
        i = 0
        replaced = False
        while i < len(cmd):
            if cmd[i] == "--port" and i + 1 < len(cmd):
                out += ["--port", str(port)]
                i += 2
                replaced = True
                continue
            out.append(cmd[i])
            i += 1
        if not replaced:
            out += ["--port", str(port)]
        return out

    def _kill(self, lp: LocalProcess):
        try:
            os.killpg(os.getpgid(lp.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        lp.proc.wait(timeout=5)

    # -- readiness ---------------------------------------------------------

    def _health_loop(self):
        import urllib.request

        while self._running:
            time.sleep(0.25)
            self._process_due_restarts()
            with self._lock:
                procs = list(self._procs.values())
            for lp in procs:
                if lp.proc.poll() is not None:
                    log.warning("pod process %s exited (%s)", lp.pod_name, lp.proc.returncode)
                    with self._lock:
                        self._procs.pop(lp.pod_name, None)
                    self._on_pod_exit(lp)
                    continue
                ready = self._probe_ready(lp.port)
                if ready and not lp.ready and group_listens_on(lp.proc.pid, lp.port) is False:
                    continue  # another process holds the pod's port
                if ready and not lp.ready:
                    lp.ready = True
                    self._set_status(
                        lp.pod_name, ready=True, pod_ip="127.0.0.1", port=lp.port
                    )
                elif lp.ready and ready is False:
                    # Readiness is CONTINUOUS (the kubelet's contract),
                    # not sticky: a parked pod adopted by a model, a
                    # draining engine, or a degraded gang must flip back
                    # to not-ready so the balancer routes around it.
                    lp.ready = False
                    self._set_status(lp.pod_name, ready=False)

    @staticmethod
    def _probe_ready(port: int) -> bool | None:
        """One readiness probe: /readyz when the server has one (the
        engine's is real readiness — parked/loading/draining read 503),
        falling back to /health for servers without a readiness route.
        None = unreachable (no status change; the exit poller owns
        process death)."""
        import urllib.error
        import urllib.request

        for path in ("/readyz", "/health"):
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=1
                ) as resp:
                    return resp.status == 200
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    continue  # no such route; try the next probe
                return False
            except Exception:
                return None
        return None

    def _on_pod_exit(self, lp: LocalProcess) -> None:
        """A pod subprocess died. With restarts enabled and the pod
        object still desired (present in the store), schedule a
        relaunch after this pod's current backoff delay and surface the
        CrashLoopBackOff phase (not-ready — the balancer routes around
        it; `pod_is_ready` is false the whole time). Without restarts,
        the old terminal Failed phase."""
        name = lp.pod_name
        if self.restart_crashed and self._running:
            try:
                self.store.get(KIND_POD, name, self.namespace)
            except NotFound:
                with self._lock:
                    self._backoffs.pop(name, None)
                return  # pod deleted; nothing to revive
            with self._lock:
                bo = self._backoffs.setdefault(
                    name,
                    CrashBackoff(
                        self.crash_backoff_base,
                        self.crash_backoff_cap,
                        self.crash_stable_reset,
                        self._clock,
                    ),
                )
                delay = bo.on_exit()
                self._pending_restarts[name] = self._clock() + delay
                crashes = bo.crashes
            self._set_status(name, phase=CRASH_LOOP_PHASE, ready=False)
            log.warning(
                "pod %s in %s (crash #%d); restarting in %.1fs",
                name, CRASH_LOOP_PHASE, crashes, delay,
            )
        else:
            self._set_status(name, phase="Failed", ready=False)

    def _process_due_restarts(self) -> None:
        """Relaunch crashed pods whose backoff delay has elapsed (health
        loop cadence, so restart latency quantizes to its 0.25 s poll)."""
        with self._lock:
            now = self._clock()
            due = [n for n, t in self._pending_restarts.items() if now >= t]
            for n in due:
                self._pending_restarts.pop(n, None)
        for name in due:
            try:
                pod = self.store.get(KIND_POD, name, self.namespace)
            except NotFound:
                with self._lock:
                    self._backoffs.pop(name, None)
                continue
            model = pod.meta.labels.get(mt.LABEL_MODEL) or "unknown"
            M_POD_RESTARTS.inc(labels={"model": model})
            log.info("relaunching crashed pod %s (model %s)", name, model)
            try:
                self._launch(pod)
            except Exception:
                # A transient relaunch failure (fd exhaustion, port
                # race, store hiccup) must not kill the supervisor
                # thread — reschedule after another backoff step.
                log.exception("relaunch of pod %s failed; rescheduling", name)
                with self._lock:
                    bo = self._backoffs.get(name)
                    delay = bo.on_exit() if bo is not None else self.crash_backoff_base
                    self._pending_restarts[name] = self._clock() + delay

    def _set_status(self, pod_name: str, phase: str | None = None, ready: bool | None = None, scheduled: bool | None = None, pod_ip: str | None = None, port: int | None = None):
        def mutate(p):
            if phase is not None:
                p.status.phase = phase
            if ready is not None:
                p.status.ready = ready
            if scheduled is not None:
                p.status.scheduled = scheduled
            if pod_ip is not None:
                p.status.pod_ip = pod_ip
            if port is not None:
                p.meta.annotations[mt.ANNOTATION_MODEL_POD_PORT] = str(port)

        try:
            self.store.mutate(KIND_POD, pod_name, mutate, self.namespace)
        except NotFound:
            pass
