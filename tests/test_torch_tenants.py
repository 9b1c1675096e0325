"""The port's tenant accountant and the engine's per-request cost against
the JAX package's, on the CPU.

- **Accountant.** The JAX accountant cases of tests/test_tenants.py
  (eviction folding and conserved sums, the fold's window hygiene,
  anonymous outside the top-K, window shares and the flood trigger, the
  flood never naming __other__ or anonymous, p95 and attainment buckets,
  canary exclusion, reset) and a seeded random script of the same calls
  run on both accountants, each with its own FakeClock; after every tick
  and at the end ``report()``, the published triggers (captured through
  each package's ``install_recorder``) and the ``kubeai_tenant_*``
  series of the script's tenants are equal. The sums are exact: both
  packages add the same doubles in the same order (the flood's ``at``,
  a wall-clock stamp, is compared within 5 s).
- **Engine costs.** Port and JAX engine servers on one test:tiny weight
  set serve the same staggered requests of two tenants: each request
  records once, its ``page_seconds / slot_seconds`` is the pages it
  reserved (within 1e-9), ceil((prompt + max_tokens) / page_size), and
  the JAX engine's count for the same prompt; ``/debug/tenants`` and
  ``/metrics`` carry the sums. A request failed in flight records once;
  an untenanted one records nothing.
"""

import json
import math
import threading
import time
import urllib.request

import numpy as np
import pytest

from kubeai_tpu.engine.server import EngineServer as JServer
from kubeai_tpu.obs import incidents as jinc
from kubeai_tpu.obs import tenants as jt
from kubeai_tpu_torch import faults
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.metrics import default_registry as treg
from kubeai_tpu_torch.obs import incidents as tinc
from kubeai_tpu_torch.obs import tenants as tt

from _torch_parity import parity_engines
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("KUBEAI_HISTORY_DIR", str(tmp_path))
    tt.default_accountant.reset()
    jt.default_accountant.reset()
    faults.clear_all()
    yield
    faults.clear_all()
    tt.default_accountant.reset()
    jt.default_accountant.reset()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Capture:
    """An installed incident recorder: the triggers published to it."""

    def __init__(self):
        self.got = []

    def publish(self, trigger, model="", detail=None, key=""):
        self.got.append((trigger, model, detail, key))
        return None


SERIES = ("M_T_REQUESTS", "M_T_TOKENS", "M_T_SLOT_SECONDS", "M_T_PAGE_SECONDS", "M_T_SHARE")


def _series(mod, tenants) -> dict:
    """The script's tenants' kubeai_tenant_* series of one package."""
    out = {}
    for attr in SERIES:
        out[attr] = {k: v for k, v in getattr(mod, attr).snapshot().items()
                     if dict(k).get("tenant") in tenants}
    return out


def _strip_at(rep):
    rep = json.loads(json.dumps(rep))
    last = rep["flood"]["last"]
    at = last.pop("at") if last else None
    return rep, at


def _run(mod, inc, script, **kw):
    """*script* on a new accountant of package *mod*: the reports after
    every tick and at the end, the triggers published, the window states,
    the totals and the series."""
    kw = {"topk": 4, "window_seconds": 60.0, "flood_share": 0.5, "flood_min": 4.0, **kw}
    clock = FakeClock()
    a = mod.TenantAccountant(clock=clock, **kw)
    a.ttft_threshold_s, a.e2e_threshold_s = 2.0, 30.0
    cap = Capture()
    inc.install_recorder(cap)
    reports, states = [], []
    try:
        for op, *args in script:
            if op == "req":
                a.record_request(*args[:3], ttft_s=args[3], prompt_tokens=args[4],
                                 completion_tokens=args[5], canary=args[6])
            elif op == "cost":
                a.record_cost(*args)
            elif op == "advance":
                clock.t += args[0]
            elif op == "tick":
                a.tick()
                reports.append(a.report())
                states.append(json.loads(json.dumps(a._window_state)))
            elif op == "reset":
                a.reset()
        reports.append(a.report())
    finally:
        inc.uninstall_recorder(cap)
    tenants = {s[1] for s in script if s[0] in ("req", "cost")} | {jt.OTHER, jt.ANONYMOUS}
    return reports, cap.got, states, a.totals(), _series(mod, tenants)


def _assert_same(script, **kw):
    j = _run(jt, jinc, script, **kw)
    t = _run(tt, tinc, script, **kw)
    for jr, tr in zip(j[0], t[0]):
        (jr, jat), (tr, tat) = _strip_at(jr), _strip_at(tr)
        assert tr == jr  # exact: the same doubles added in the same order
        assert (jat is None) == (tat is None) and (jat is None or abs(jat - tat) < 5)
    assert len(j[0]) == len(t[0])
    assert t[1] == j[1]  # triggers
    assert t[2] == j[2]  # window states after every tick
    assert t[3] == j[3]  # totals, exact
    assert t[4] == j[4]  # series, exact
    return t


def req(tenant, outcome="ok", e2e=0.1, ttft=None, pt=0, ct=0, canary=False):
    return ("req", tenant, outcome, e2e, ttft, pt, ct, canary)


def cost(tenant, slot_s, page_s):
    return ("cost", tenant, slot_s, page_s)


ADV = lambda dt: ("advance", dt)  # noqa: E731
TICK = ("tick",)


# The cases of tests/test_tenants.py, as call sequences.
CASES = {
    "eviction_folds_and_conserves": (dict(topk=2), [
        req("ev-t1", pt=10, ct=5), req("ev-t1", pt=10, ct=5), req("ev-t2", "error", 0.2, pt=7),
        req("ev-t3", pt=3, ct=1), req("ev-t4"), cost("ev-t3", 0.25, 1.0)]),
    "fold_keeps_other_window_share": (dict(topk=3, window_seconds=60.0), [
        *[req("fw-v", pt=1)] * 1000, ADV(120), TICK, ADV(30), *[req("fw-hitter")] * 9,
        req("fw-n1"), req("fw-n2"), ADV(35), TICK]),
    "anonymous_rides_free": (dict(topk=1), [
        req(jt.ANONYMOUS), req("an-t1"), req("an-t2"), req(""), req("bad id{}"), TICK]),
    "shares_and_flood": (dict(topk=8, window_seconds=30.0, flood_min=5.0), [
        *[req("fl-small")] * 3, ADV(5), TICK, *[req("fl-hog")] * 9, ADV(5), TICK,
        ADV(31), TICK]),
    "flood_never_names_other_or_anonymous": (dict(topk=1, flood_min=2.0), [
        *[req(f"tail-{i}") for i in range(20)], ADV(2), TICK,
        *[req(jt.ANONYMOUS)] * 50, ADV(2), TICK]),
    "p95_and_attainment": ({}, [
        *[req("pa-t", e2e=0.3, ttft=0.2)] * 9, req("pa-t", e2e=40.0, ttft=35.0), ADV(5), TICK]),
    "canary_excluded": ({}, [req("ca-t1", pt=10, ct=5, canary=True), TICK]),
    "reset_reseeds_the_window": ({}, [
        req("rs-probe", pt=5), cost("rs-probe", 1.5, 3.0), ("reset",), req("rs-probe"),
        ADV(1), TICK]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_accountant_cases_equal_jax(case):
    kw, script = CASES[case]
    reports, triggers, states, totals, _ = _assert_same(script, **kw)
    if case == "shares_and_flood":
        assert [d["tenant"] for _, _, d, _ in triggers] == ["fl-hog"]
        assert triggers[0][2]["share"] == 0.75 and states[-1]["fl-hog"]["window_requests"] == 0
    elif case == "eviction_folds_and_conserves":
        # t3 evicts t2, t4 evicts t3 (a tie: the newer goes), and t3's
        # cost evicts t1: every sum is conserved in __other__.
        other = next(r for r in reports[-1]["tenants"] if r["tenant"] == jt.OTHER)
        assert reports[-1]["evictions"] == 3 and other["outcomes"] == {"error": 1, "ok": 3}
        assert (totals["requests"], totals["prompt_tokens"]) == (5, 30)
    elif case == "fold_keeps_other_window_share":
        assert states[-1]["fw-hitter"]["share"] == 0.9 and states[-1][jt.OTHER]["window_requests"] == 0
    elif case == "flood_never_names_other_or_anonymous":
        assert all(d["tenant"] not in (jt.OTHER, jt.ANONYMOUS) for _, _, d, _ in triggers)
    elif case == "p95_and_attainment":
        assert states[-1]["pa-t"]["e2e_p95_s"] == 60.0
        assert states[-1]["pa-t"]["ttft_attainment"] == pytest.approx(0.9)
    elif case == "canary_excluded":
        assert totals["requests"] == 0 and reports[-1]["canary_excluded"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_script_equals_jax(seed):
    """Requests, costs, ticks and clock steps over 12 tenants at top-K 4
    (evictions, floods and window slides), from a seed."""
    g = np.random.default_rng(seed)
    names = [f"rnd{seed}-{i}" for i in range(11)] + [jt.ANONYMOUS]
    script = []
    for _ in range(600):
        u = g.random()
        t = names[min(int(g.zipf(1.6)) - 1, len(names) - 1)]
        if u < 0.6:
            script.append(req(t, str(g.choice(["ok", "ok", "error", "cancelled"])),
                              float(g.exponential(2.0)), float(g.exponential(0.5)),
                              int(g.integers(0, 200)), int(g.integers(0, 50)), bool(g.random() < 0.02)))
        elif u < 0.85:
            s = float(g.exponential(1.0))
            script.append(cost(t, s, s * int(g.integers(1, 9))))
        elif u < 0.95:
            script.append(ADV(float(g.exponential(4.0))))
        else:
            script.append(TICK)
    reports, *_ = _assert_same(script, flood_min=10.0, window_seconds=20.0)
    assert reports[-1]["evictions"] > 0


def test_concurrent_records_conserve_sums():
    """tests/test_tenants.py's 8 threads on the port's accountant: every
    token and second lands once, in a tracked row or in __other__."""
    a = tt.TenantAccountant(topk=3, clock=FakeClock())
    n_threads, per_thread = 8, 200
    barrier = threading.Barrier(n_threads)

    def work(k):
        barrier.wait()
        for i in range(per_thread):
            a.record_request(f"cc-{(k * 7 + i) % 11}", "ok", 0.05, prompt_tokens=3,
                             completion_tokens=2)
            a.record_cost(f"cc-{(k * 3 + i) % 11}", 0.5, 1.5)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    total = n_threads * per_thread
    got = a.totals()
    assert (got["requests"], got["prompt_tokens"], got["completion_tokens"]) == \
        (total, 3 * total, 2 * total)
    # 0.5 and 1.5 are exact in binary and the sums stay below 2^53: exact.
    assert (got["slot_seconds"], got["kv_page_seconds"]) == (0.5 * total, 1.5 * total)


def test_constants_and_sanitize_equal_jax():
    from kubeai_tpu_torch.qos import classes

    assert (tt.TENANT_HEADER, tt.ANONYMOUS, tt.OTHER, tt.LATENCY_BUCKETS) == \
        (jt.TENANT_HEADER, jt.ANONYMOUS, jt.OTHER, jt.LATENCY_BUCKETS)
    assert classes.sanitize_tenant is tt.sanitize_tenant
    for s in ("abc-DEF_1.2", 'evil"\nvalue{}', "x" * 200, "ü"):
        assert tt.sanitize_tenant(s) == jt.sanitize_tenant(s)
    assert tt.handle_tenant_request("/debug/other") is None
    code, _, body = tt.handle_tenant_request("/debug/tenants")
    j = json.loads(jt.handle_tenant_request("/debug/tenants")[2])
    t = json.loads(body)
    assert code == 200 and t.keys() == j.keys() and t["tenants"] == []


# -- engine costs --------------------------------------------------------------


def _post(port, body, tenant=None, timeout=60):
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers[tt.TENANT_HEADER] = tenant
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps(body).encode(), headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _spy(monkeypatch, eng, accountant):
    """Each record of *eng*: (tenant, prompt ids, slot-seconds,
    page-seconds, pages the slot held at release)."""
    got = []
    record, pending = accountant.record_cost, []
    monkeypatch.setattr(accountant, "record_cost",
                        lambda t, s, p: (pending.append((s, p)), record(t, s, p)))
    orig = eng._record_slot_cost

    def spy(slot, slot_idx):
        n = len(pending)
        pages = len(eng._slot_pages[slot_idx])
        orig(slot, slot_idx)
        for s, p in pending[n:]:
            got.append((slot.req.tenant, tuple(slot.req.prompt_ids), s, p, pages))

    monkeypatch.setattr(eng, "_record_slot_cost", spy)
    return got


@pytest.fixture(scope="module")
def twin():
    je, te = parity_engines()
    jsrv = JServer(je, "tiny", host="127.0.0.1", port=0)
    tsrv = EngineServer(te, "tiny", host="127.0.0.1", port=0)
    jsrv.start()
    tsrv.start()
    yield jsrv, tsrv
    jsrv.stop()
    tsrv.stop()


# (tenant, prompt, max_tokens): two tenants, prompts and budgets that
# reserve different page counts.
REQUESTS = [("cost-a", "The sea", 12), ("cost-b", "z" * 50, 30), ("cost-a", "x" * 100, 40),
            ("cost-b", "Once", 4), ("cost-b", "y" * 150, 60)]


def _staggered(port, reqs):
    """Each request starts 20 ms after the one before; all overlap."""
    out = [None] * len(reqs)

    def run(i, tenant, prompt, n):
        out[i] = _post(port, {"prompt": prompt, "max_tokens": n, "temperature": 0,
                              "logit_bias": {"257": -100}}, tenant=tenant)

    threads = []
    for i, r in enumerate(reqs):
        threads.append(threading.Thread(target=run, args=(i, *r)))
        threads[-1].start()
        time.sleep(0.02)
    for th in threads:
        th.join(timeout=60)
    assert all(o is not None and o[0] == 200 for o in out), out
    return out


def test_each_request_records_its_reserved_pages_as_the_jax_engine(twin, monkeypatch):
    jsrv, tsrv = twin
    tgot = _spy(monkeypatch, tsrv.engine, tt.default_accountant)
    jgot = _spy(monkeypatch, jsrv.engine, jt.default_accountant)
    _staggered(tsrv.port, REQUESTS)
    _staggered(jsrv.port, REQUESTS)
    ps = tsrv.engine.cfg.page_size
    assert ps == jsrv.engine.cfg.page_size
    assert len(tgot) == len(jgot) == len(REQUESTS)  # once per request
    jpages = {(t, ids): p / s for t, ids, s, p, _ in jgot}
    by_tenant = {}
    for tenant, ids, slot_s, page_s, held in tgot:
        n = next(n for t, p, n in REQUESTS if t == tenant and
                 tuple(tsrv.engine.tokenizer.encode(p)) == ids)
        assert slot_s > 0 and abs(page_s / slot_s - held) < 1e-9
        assert held == math.ceil((len(ids) + n) / ps)
        assert abs(jpages[(tenant, ids)] - held) < 1e-9
        by_tenant.setdefault(tenant, []).append((slot_s, page_s))
    assert sorted({h for *_, h in tgot}) == sorted({h for *_, h in jgot}) and \
        len({h for *_, h in tgot}) > 2
    # /debug/tenants: both tenants, their cost sums; each record adds one
    # to the tenant's sketch weight (an engine keeps no request totals).
    with urllib.request.urlopen(f"http://127.0.0.1:{tsrv.port}/debug/tenants", timeout=10) as r:
        rep = json.loads(r.read())
    rows = {row["tenant"]: row for row in rep["tenants"]}
    assert set(rows) == {"cost-a", "cost-b"}
    for tenant, recs in by_tenant.items():
        assert rows[tenant]["cost"]["slot_seconds"] == round(sum(s for s, _ in recs), 4)
        assert rows[tenant]["cost"]["kv_page_seconds"] == round(sum(p for _, p in recs), 4)
        assert tt.default_accountant._tracked[tenant].weight == len(recs)
    assert [len(by_tenant["cost-a"]), len(by_tenant["cost-b"])] == [2, 3]
    with urllib.request.urlopen(f"http://127.0.0.1:{tsrv.port}/metrics", timeout=10) as r:
        text = r.read().decode()
    for tenant, recs in by_tenant.items():
        for name, i in (("kubeai_tenant_slot_seconds_total", 0),
                        ("kubeai_tenant_kv_page_seconds_total", 1)):
            line = f'{name}{{tenant="{tenant}"}} '
            assert line in text
            assert treg.get(name).value({"tenant": tenant}) == sum(r[i] for r in recs)


def test_failed_request_records_once_and_untenanted_nothing(twin, monkeypatch):
    _, tsrv = twin
    got = _spy(monkeypatch, tsrv.engine, tt.default_accountant)
    st, _ = _post(tsrv.port, {"prompt": "nobody", "max_tokens": 6, "temperature": 0})
    assert st == 200 and got == []
    # A decoding tenanted request, then a failed scheduler step: the
    # engine's reset errors it in flight (_fail_inflight).
    out = {}
    th = threading.Thread(target=lambda: out.setdefault("r", _post(
        tsrv.port, {"prompt": "doomed", "max_tokens": 400, "temperature": 0,
                    "logit_bias": {"257": -100}}, tenant="cost-fail")))
    th.start()
    deadline = time.monotonic() + 20
    while tsrv.engine.active_slots() == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    faults.arm_spec(f"engine.step@{tsrv.port}", "error:1")
    th.join(timeout=30)
    assert out["r"][0] != 200, out
    deadline = time.monotonic() + 10
    while tsrv.engine.requests_in_system() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [(t, ids) for t, ids, *_ in got] == \
        [("cost-fail", tuple(tsrv.engine.tokenizer.encode("doomed")))]
    assert tsrv.engine._pool.used() == 0
