"""The port's forecaster (kubeai_tpu_torch/obs/forecast.py) against the JAX
package's, on the CPU.

- The cases of tests/test_forecast.py run on both packages
  (``run_jax_case_both``), less the drill (a JAX benchmark's whole stack).
- One seeded numpy series (a season with noise, a gap, a flood, a
  trough) recorded into both packages' stores with one wall clock each,
  both forecasters ticking alike: ``report()``, ``signal_at_lead``, the
  decision records (scoring, auto-disable, re-enable) and the published
  ``traffic_anomaly`` triggers are equal (pure Python arithmetic: exact).
- ``derive_lead_seconds`` is equal given the same profile; with nothing
  set the port's is 60 s and it never reads ``BENCH_cold_start.json``
  from the working directory (the JAX one does).
"""

import builtins
import json
import os

import numpy as np
import pytest

import test_forecast as jtest_forecast
from _torch_operator import jax_cases, obs_dirs, run_jax_case_both  # noqa: F401  (obs_dirs: autouse)
from kubeai_tpu.obs import forecast as jf
from kubeai_tpu.obs import history as jh
from kubeai_tpu_torch.obs import forecast as tf
from kubeai_tpu_torch.obs import history as th

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = jax_cases(jtest_forecast, skip=("test_forecast_drill_fast",))


@pytest.mark.parametrize("module,qual,params", CASES)
def test_jax_cases_on_both_packages(module, qual, params, request, monkeypatch):
    run_jax_case_both(module, qual, params, request, monkeypatch)


class Wall:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


MODELS = ("m1", "m2")


def _series(model):
    return f"kubeai_inference_requests_active{{request_model={model},request_type=http}}"


def _stack(mod, hmod, wall, seed):
    store = hmod.HistoryStore(history_dir="", wall=wall)
    fc = mod.Forecaster(store, interval_seconds=5.0, season_seconds=800.0, bins=16,
                        horizon_seconds=400.0, lead_seconds=100.0, fit_seasons=3,
                        wall=wall, clock=wall)
    fc.decision_log = []
    fc.min_scored = 4
    return store, fc


def _run(seed, monkeypatch):
    """Both packages through one seeded day: [(report, signals, log,
    published)] per package."""
    out = []
    for mod, hmod in ((jf, jh), (tf, th)):
        g = np.random.default_rng(seed)
        wall = Wall(1_000_000.0)
        store, fc = _stack(mod, hmod, wall, seed)
        published = []
        monkeypatch.setattr(mod, "publish_trigger",
                            lambda trigger, **kw: published.append((trigger, kw)))
        # Three seasons of history at a 10 s cadence, with a gap.
        t = wall.t - 3 * 800.0
        while t < wall.t:
            for i, m in enumerate(MODELS):
                frac = (t % 800.0) / 800.0
                v = (4 + 4 * i) * (0.55 + 0.45 * np.sin(2 * np.pi * (frac - 0.25)))
                store.record(_series(m), float(v + g.normal(0, 0.3)), t=t)
                store.record(f"fleet.{m}.tokens_per_second", float(50 * v + g.normal(0, 5)), t=t)
            t += 10.0
        store.mark_gap("restart", since=wall.t - 1500.0, t=wall.t - 1400.0)
        signals = []
        # Then live ticks: normal, a flood on m1, a trough on m2, normal.
        for k in range(60):
            for half in (0, 1):
                wall.t += 25.0
                if half:
                    for i, m in enumerate(MODELS):
                        base = (4 + 4 * i) * (0.55 + 0.45 * np.sin(
                            2 * np.pi * ((wall.t % 800.0) / 800.0 - 0.25)))
                        if 15 <= k < 25 and m == "m1":
                            base *= 6.0
                        if 35 <= k < 45 and m == "m2":
                            base = 0.0
                        store.record(_series(m), float(base + g.normal(0, 0.3)), t=wall.t - 1.0)
                        store.record(f"fleet.{m}.tokens_per_second",
                                     float(50 * base + g.normal(0, 5)), t=wall.t - 1.0)
                fc.tick()
            signals.append([fc.signal_at_lead(m) for m in MODELS])
        out.append((fc.report(points=16), signals, fc.decision_log, published))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_series_gives_equal_forecasts(seed, monkeypatch):
    (jrep, jsig, jlog, jpub), (trep, tsig, tlog, tpub) = _run(seed, monkeypatch)
    assert json.dumps(trep, sort_keys=True) == json.dumps(jrep, sort_keys=True)
    assert tsig == jsig
    assert tlog == jlog
    assert tpub == jpub
    # The day exercised what it is for: scoring, the anomaly triggers.
    assert any(r["action"] == "forecast_scored" for r in tlog)
    assert {kw["model"] for _, kw in tpub} == {"m1", "m2"}
    assert all(t == "traffic_anomaly" for t, _ in tpub)
    assert trep["models"]["m1"]["signals"]["requests"]["accuracy"]["scored"] > 0


def test_auto_disable_equal(monkeypatch):
    """A forecast promising 10 where 0 arrives: both disable at the same
    tick with the same reason, and re-enable at the same tick."""
    logs = []
    for mod, hmod in ((jf, jh), (tf, th)):
        monkeypatch.setattr(mod, "publish_trigger", lambda *a, **k: None)
        wall = Wall(1_000_000.0)
        store, fc = _stack(mod, hmod, wall, 0)
        fc.mape_disable = 0.5
        t = wall.t - 3 * 800.0
        while t < wall.t:
            store.record(_series("m1"), 10.0, t=t)
            t += 10.0
        fc.tick()
        states = []
        for k in range(400):
            wall.t += 50.0
            v = 0.0 if k < 10 else 10.0
            for dt in (40.0, 30.0, 20.0, 10.0, 0.0):
                store.record(_series("m1"), v, t=wall.t - 50.0 + dt)
            fc.tick()
            states.append(fc.signal_at_lead("m1"))
        logs.append((fc.decision_log, states, fc.report()))
    (jlog, jst, jrep), (tlog, tst, trep) = logs
    assert tlog == jlog and tst == jst and trep == jrep
    actions = [r["action"] for r in tlog]
    assert "forecast_auto_disable" in actions and "forecast_reenable" in actions


def test_lead_equal_given_a_profile(tmp_path, monkeypatch):
    monkeypatch.delenv("KUBEAI_FORECAST_LEAD", raising=False)
    monkeypatch.delenv("KUBEAI_COLD_START_PROFILE", raising=False)
    for doc in ({"parked_attach_s": 9.5, "serial_s": 90.0}, {"fast_warm_s": 14.0},
                {"phases": {"ready_s": 16.1}}, {"serial_s": 0}, {}):
        p = tmp_path / "profile.json"
        p.write_text(json.dumps(doc))
        assert tf.derive_lead_seconds(profile_path=str(p)) == \
            jf.derive_lead_seconds(profile_path=str(p))
        monkeypatch.setenv("KUBEAI_COLD_START_PROFILE", str(p))
        assert tf.derive_lead_seconds() == jf.derive_lead_seconds(profile_path=str(p))
        monkeypatch.delenv("KUBEAI_COLD_START_PROFILE")
    monkeypatch.setenv("KUBEAI_FORECAST_LEAD", "11.5")
    assert tf.derive_lead_seconds() == jf.derive_lead_seconds() == 11.5


def test_port_lead_never_reads_the_jax_profile(monkeypatch):
    """In the repo root, with nothing set, JAX takes its lead from
    BENCH_cold_start.json (a JAX engine's measurement); the port's is
    the 60 s default and opens no file."""
    monkeypatch.delenv("KUBEAI_FORECAST_LEAD", raising=False)
    monkeypatch.delenv("KUBEAI_COLD_START_PROFILE", raising=False)
    monkeypatch.chdir(ROOT)
    assert os.path.exists("BENCH_cold_start.json")
    assert jf.derive_lead_seconds() != 60.0
    opened = []
    real_open = builtins.open
    monkeypatch.setattr(builtins, "open", lambda f, *a, **k: (opened.append(f),
                                                             real_open(f, *a, **k))[1])
    assert tf.derive_lead_seconds() == 60.0
    fc = tf.Forecaster(th.HistoryStore(history_dir=""))
    monkeypatch.setattr(builtins, "open", real_open)
    assert fc.lead == min(60.0, fc.horizon) and opened == []
