"""The port's chaos campaign (kubeai_tpu_torch/chaos) against the JAX
package's, on the CPU.

- ``generate_schedule`` gives the same JSON as JAX's for seeds 0-4,
  episodes 0-9 and 1-3 replicas; ``ddmin`` the same result and run
  count on seeded predicates; ``validate_chaos_doc`` the same problems;
  the unit cases of tests/test_chaos_campaign.py run on both packages.
- ``python -m kubeai_tpu_torch.chaos --induce`` over the port's stack
  (two port engine servers on the CPU) runs its seeded episodes clean,
  with faults fired, exits 0 and writes a valid document; the induced
  schedule is detected, shrunk to the connect kill, and still violates
  on replay.
"""

import copy
import json

import numpy as np
import pytest

import test_chaos_campaign as jtest_chaos_campaign
from _torch_operator import jax_cases, obs_dirs, run_jax_case_both  # noqa: F401  (autouse)
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from kubeai_tpu.chaos import report as jreport
from kubeai_tpu.chaos import schedule as jsched
from kubeai_tpu.chaos import shrink as jshrink
from kubeai_tpu_torch.chaos import report as treport
from kubeai_tpu_torch.chaos import schedule as tsched
from kubeai_tpu_torch.chaos import shrink as tshrink
from kubeai_tpu_torch.chaos.campaign import induced_schedule

LIVE = ("test_fast_soak_runs_clean", "test_induced_violation_detected_shrunk_and_replayable",
        "test_benign_episode_replays_clean")


@pytest.mark.parametrize("module,qual,params", jax_cases(jtest_chaos_campaign, skip=LIVE))
def test_jax_cases_on_both_packages(module, qual, params, request, monkeypatch):
    run_jax_case_both(module, qual, params, request, monkeypatch)


@pytest.mark.parametrize("seed", range(5))
def test_generate_schedule_json_equal(seed):
    for episode in range(10):
        for replicas in (1, 2, 3):
            t = tsched.generate_schedule(seed, episode, replicas)
            j = jsched.generate_schedule(seed, episode, replicas)
            assert t.to_json() == j.to_json()
            assert t.describe() == j.describe() and t.subsystems() == j.subsystems()
            back = tsched.Schedule.from_json(j.to_json())
            assert back.to_json() == j.to_json()
            assert [e.resolve_site([8101, 8102, 8103]) for e in t.events] == \
                [e.resolve_site([8101, 8102, 8103]) for e in j.events]
    assert tsched.SUBSYSTEM_OF == jsched.SUBSYSTEM_OF


@pytest.mark.parametrize("seed", range(3))
def test_ddmin_equal(seed):
    g = np.random.default_rng(seed)
    for _ in range(40):
        n = int(g.integers(1, 9))
        jev = [jsched.FaultEvent(f"s{i}", "error:1", at=float(i)) for i in range(n)]
        tev = [tsched.FaultEvent(f"s{i}", "error:1", at=float(i)) for i in range(n)]
        culprits = {f"s{i}" for i in g.choice(n, size=int(g.integers(1, n + 1)), replace=False)}
        flaky = float(g.uniform(0, 0.3))
        coin = np.random.default_rng(int(g.integers(1 << 30)))
        draws = [coin.random() for _ in range(200)]

        def predicate(draws):
            it = iter(draws)
            return lambda evs: culprits <= {e.site for e in evs} and next(it) >= flaky

        max_runs = int(g.integers(3, 40))
        jred, jruns = jshrink.ddmin(jev, predicate(draws), max_runs=max_runs)
        tred, truns = tshrink.ddmin(tev, predicate(draws), max_runs=max_runs)
        assert [e.to_dict() for e in tred] == [e.to_dict() for e in jred] and truns == jruns


def _doc():
    return {
        "bench": "chaos", "schema_version": 1, "seed": 1, "episodes": 3, "replicas": 2,
        "requests_per_episode": 6,
        "site_coverage": {"proxy.connect": {"subsystem": "proxy", "episodes_armed": 2,
                                            "fired": 3}},
        "subsystems_covered": ["proxy"], "sites_fired": ["proxy.connect"],
        "invariants": {k: {"violations": 0} for k in jreport.INVARIANT_KEYS},
        "violations": [], "degradation": {}, "duration_s": 1.0,
    }


def _variants():
    yield _doc()
    yield []
    for k in jreport.REQUIRED_KEYS:
        d = _doc()
        del d[k]
        yield d
    for k, v in (("bench", "x"), ("schema_version", 2), ("episodes", 0), ("site_coverage", []),
                 ("sites_fired", "x"), ("subsystems_covered", {}), ("invariants", []),
                 ("violations", {}), ("violations", [{"episode": 1}])):
        d = _doc()
        d[k] = v
        yield d
    d = _doc()
    d["site_coverage"]["x"] = {"fired": 1}
    del d["invariants"]["recovery"]
    yield d
    d = _doc()
    d["violations"] = [{f: 1 for f in ("episode", "seed", "violations", "schedule",
                                       "reduced_schedule", "replay")}]
    yield d


def test_validate_chaos_doc_equal():
    for doc in _variants():
        for kw in ({}, {"min_episodes": 5}, {"min_sites": 2, "min_subsystems": 2},
                   {"require_clean": True}):
            assert treport.validate_chaos_doc(copy.deepcopy(doc), **kw) == \
                jreport.validate_chaos_doc(copy.deepcopy(doc), **kw)
    assert treport.validate_chaos_doc(_doc(), require_clean=True) == []


@pytest.fixture(scope="module")
def campaign_doc(tmp_path_factory):
    """``python -m kubeai_tpu_torch.chaos`` (its main, in this process) on
    the CPU: 4 seeded episodes over 2 replicas, then the induced
    schedule. Returns (exit code, document, output directory)."""
    from kubeai_tpu_torch.chaos.__main__ import main

    out = tmp_path_factory.mktemp("chaos")
    code = main(["--device", "cpu", "--episodes", "4", "--seed", "1", "--replicas", "2",
                 "--requests", "6", "--induce", "--out", str(out)])
    return code, json.loads((out / "CHAOS.json").read_text()), out


def test_cpu_campaign_runs_clean(campaign_doc):
    code, doc, out = campaign_doc
    assert code == 0
    assert doc["violations"] == [], [v["violations"] for v in doc["violations"]]
    assert treport.validate_chaos_doc(doc, min_episodes=4, require_clean=True) == []
    assert doc["sites_fired"] and doc["degradation"]["episodes_with_faults_fired"] >= 2
    assert set(doc["launches"]["launches"]) == {"flash_attention", "paged_attention_ragged",
                                                "paged_decode_attention", "qdot", "qdot_many"}
    assert not any(doc["launches"]["launches"].values())  # no kernel runs on the CPU
    assert (out / "incidents").is_dir() and (out / "history").is_dir()


def test_induced_violation_detected_shrunk_and_replayable(campaign_doc):
    _, doc, _ = campaign_doc
    induced = doc["induced"]
    assert induced["violations"] and induced["shrink_runs"] >= 1
    reduced = tsched.Schedule.from_dict(induced["reduced_schedule"]).events
    assert 1 <= len(reduced) <= 3 and any(e.site == "proxy.connect" for e in reduced)
    assert induced["replay_violations"]
    assert induced_schedule(1).to_json() == tsched.Schedule.from_json(
        induced_schedule(1).to_json()).to_json()
