"""The port's metrics history (kubeai_tpu_torch/obs/history.py) against the
JAX package's, on the CPU.

- Both packages' ``RegistrySampler``s tick over registries that get the
  same counter, gauge and histogram updates (from a seed), with one
  monotonic clock and one wall clock each, stepping alike: the answers of
  ``handle_history_request`` to the same queries are equal JSON (the
  report less its directory; range queries with and without a step,
  prefixes, unknown names), and so are the gap markers of a stalled
  sampler and of a counter reset.
- A file the port's store flushes loads in the JAX store, and the
  reverse, with the same query answers and a restart gap.
- The port's ``bucket_quantile`` and ``sparkline`` equal JAX's; the
  ``history.disk`` failpoint keeps the history in memory only.
- A port engine server installs a store under
  ``<KUBEAI_HISTORY_DIR>/engine``, answers ``/debug/history`` 200 with
  its sampled series, and flushes a file at stop.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

from kubeai_tpu.metrics.registry import Registry as JRegistry
from kubeai_tpu.obs import history as jh
from kubeai_tpu.obs import slo as jslo
from kubeai_tpu_torch import faults
from kubeai_tpu_torch.engine.core import build_test_engine
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.metrics import Registry as TRegistry
from kubeai_tpu_torch.obs import history as th
from kubeai_tpu_torch.obs import tenants as tt

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("KUBEAI_HISTORY_DIR", str(tmp_path))
    tt.default_accountant.reset()
    faults.clear_all()
    yield
    faults.clear_all()


class Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


TTFT = "kubeai_engine_ttft_seconds"


def _feed(seed, reg_mods, ticks=40, interval=5.0):
    """Per package: (registry, store, sampler, mono, wall). Each tick the
    registries get the same updates, then both samplers tick."""
    g = np.random.default_rng(seed)
    stacks = []
    for Reg, mod in reg_mods:
        reg = Reg()
        mono, wall = Clock(100.0), Clock(1_000_000.0)
        store = mod.HistoryStore(history_dir="", wall=wall)
        samp = mod.RegistrySampler(store, registry=reg, interval_seconds=interval,
                                   clock=mono, wall=wall)
        stacks.append((reg, store, samp, mono, wall))
    for i in range(ticks):
        n_tok = float(g.integers(0, 500))
        queue = float(g.integers(0, 12))
        lat = [float(x) for x in g.exponential(0.3, int(g.integers(0, 20)))]
        outcome = "ok" if g.random() < 0.9 else "error"
        # A stall (the sampler misses ticks) at 25, a counter reset at 30.
        step = interval * (5 if i == 25 else 1) + float(g.uniform(-0.5, 0.5))
        for reg, store, samp, mono, wall in stacks:
            c = reg.counter("kubeai_engine_generation_tokens_total", "tokens")
            if i == 30:
                with c._lock:
                    c._values.clear()
            c.inc(n_tok)
            reg.counter("kubeai_engine_requests_total", "requests").inc(
                1, labels={"outcome": outcome})
            reg.gauge("kubeai_engine_queue_depth", "queue").set(queue)
            reg.gauge("kubeai_engine_slots", "slots").set(queue / 2, labels={"model": "m"})
            reg.callback_gauge("kubeai_engine_free_pages", "pages", fn=lambda q=queue: 100 - q)
            h = reg.histogram(TTFT, "ttft")
            other = reg.histogram("kubeai_not_a_key_seconds", "skipped")
            for v in lat:
                h.observe(v)
                other.observe(v)
            samp.tick()
            mono.t += step
            wall.t += step
    return stacks


QUERIES = ["", "series=kubeai_engine_generation_tokens_total", f"series={TTFT}_p50,{TTFT}_p95",
           "series=kubeai_engine_*&since=120", "series=kubeai_engine_*&since=300&step=60",
           "series=kubeai_missing,kubeai_engine_queue_depth&since=999990",
           "series=kubeai_engine_requests_total*&step=30"]


def _answers(mod, store):
    out = []
    mod.install_history(store)
    try:
        for q in QUERIES:
            code, ctype, body = mod.handle_history_request("/debug/history", q)
            doc = json.loads(body)
            doc.pop("history_dir", None)
            out.append((code, ctype, doc))
    finally:
        mod.uninstall_history(store)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_answers_equal_jax(seed):
    (_, jstore, *_), (_, tstore, *_) = _feed(seed, [(JRegistry, jh), (TRegistry, th)])
    j, t = _answers(jh, jstore), _answers(th, tstore)
    assert t == j
    assert json.dumps([a[2] for a in t]) == json.dumps([a[2] for a in j])
    names = tstore.series_names()
    assert {f"{TTFT}_p50", f"{TTFT}_p95", "kubeai_engine_free_pages",
            "kubeai_engine_slots{model=m}",
            "kubeai_engine_requests_total{outcome=ok}"} <= set(names)
    assert not any(n.startswith("kubeai_not_a_key") for n in names)
    assert any(gap["reason"] == "sampler_stall" for gap in tstore.gaps())
    pts = t[1][2]["series"]["kubeai_engine_generation_tokens_total"]["points"]
    assert all(p[3] >= 0 for p in pts)  # the reset re-anchored


def test_files_load_across_packages(tmp_path):
    (_, jmem, *_), (_, tmem, *_) = _feed(3, [(JRegistry, jh), (TRegistry, th)])
    wall = Clock(tmem._wall())
    for src_mod, src_mem, dst_mod, sub in ((th, tmem, jh, "from-port"), (jh, jmem, th, "from-jax")):
        d = str(tmp_path / sub)
        src = src_mod.HistoryStore(history_dir=d, wall=wall)
        with src_mem._lock:
            src._series = src_mem._series
            src._gaps = src_mem._gaps
            src._last_sample_t = src_mem._last_sample_t
        src.save(force=True)
        (name,) = os.listdir(d)
        assert name.startswith("history-") and name.endswith(".json")
        wall.t += 30.0
        dst = dst_mod.HistoryStore(history_dir=d, wall=wall)
        same = src_mod.HistoryStore(history_dir=d, wall=wall)
        assert dst.series_names() == src_mem.series_names() == same.series_names()
        a, b = _answers(dst_mod, dst), _answers(src_mod, same)
        assert a == b
        assert dst.gaps()[-1]["reason"] == "restart"


def test_quantile_sparkline_and_bounds_equal_jax():
    g = np.random.default_rng(5)
    bounds = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)
    for _ in range(200):
        counts = [int(x) for x in g.integers(0, 5, len(bounds) + 1)]
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert th.bucket_quantile(bounds, counts, q) == jslo.bucket_quantile(bounds, counts, q)
    assert th.bucket_quantile(bounds, [0] * 12, 0.5) is None
    for vals in ([], [1.0], [1, 1, 1], [None, 2, None, 5], list(g.normal(size=150)),
                 [None] * 4):
        assert th.sparkline(vals) == jh.sparkline(vals)
        assert th.sparkline(vals, width=7) == jh.sparkline(vals, width=7)
    assert th.DEFAULT_TIERS == jh.DEFAULT_TIERS and th.KEY_HISTOGRAMS == jh.KEY_HISTOGRAMS
    # The series bound and the gap ring, as in JAX.
    for mod in (th, jh):
        s = mod.HistoryStore(history_dir="", max_series=3, wall=Clock(1e6))
        for i in range(5):
            s.record(f"s{i}", 1.0)
        for i in range(100):
            s.mark_gap("x", since=float(i), t=float(i + 1))
        assert (len(s.series_names()), s.dropped_series, len(s.gaps())) == (3, 2, 64)


def test_history_disk_failpoint_keeps_memory_only(tmp_path):
    d = str(tmp_path / "h")
    s = th.HistoryStore(history_dir=d, wall=Clock(1e6))
    s.record("kubeai_g", 1.0)
    faults.arm_spec("history.disk", "error:1")
    s.save(force=True)
    assert not os.path.exists(d) or not os.listdir(d)
    assert s.series_names() == ["kubeai_g"]
    s.save(force=True)  # the fault fired once: the next write lands
    assert len(os.listdir(d)) == 1


def test_install_is_identity_checked():
    a, b = th.HistoryStore(history_dir=""), th.HistoryStore(history_dir="")
    assert th.handle_history_request("/debug/fleet") is None
    th.install_history(a)
    th.install_history(b)
    th.uninstall_history(a)
    assert th.installed_history() is b
    th.uninstall_history(b)
    assert th.installed_history() is None
    code, _, body = th.handle_history_request("/debug/history")
    assert code == 404 and b"no history store" in body


def test_port_server_serves_history_and_flushes_at_stop(tmp_path, monkeypatch):
    monkeypatch.setenv("KUBEAI_HISTORY_INTERVAL", "0.25")
    srv = EngineServer(build_test_engine(device="cpu"), "hist", host="127.0.0.1", port=0)
    srv.start()
    try:
        store = th.installed_history()
        assert store is not None and store.history_dir == str(tmp_path / "engine")
        # The first tick only anchors the histograms: the requests come
        # after it, or their TTFTs hide in the baseline.
        deadline = time.monotonic() + 10
        while not store.series_names():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        for i in range(3):
            body = json.dumps({"prompt": f"hello {i}", "max_tokens": 6}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/completions", data=body,
                                         headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=60).read()
        deadline = time.monotonic() + 10
        while f"{TTFT}_p50" not in store.series_names():
            assert time.monotonic() < deadline, store.series_names()
            time.sleep(0.05)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/debug/history?series={TTFT}_p50,"
                "kubeai_engine_generation_tokens_total&since=60", timeout=10) as r:
            assert r.status == 200
            doc = json.loads(r.read())
        assert doc["series"][f"{TTFT}_p50"]["points"]
    finally:
        srv.stop()
    assert th.installed_history() is None
    files = os.listdir(tmp_path / "engine")
    assert any(f.startswith("history-") and f.endswith(".json") for f in files)
