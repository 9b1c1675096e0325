"""The port's load balancer (kubeai_tpu_torch/loadbalancer) against the
JAX package's, on the CPU.

- ``HashRing``: the cases of tests/test_chwbl_churn.py and seeded churn
  give the same ring size and the same walk for every key.
- ``EndpointGroup`` under seeded scripts of endpoint churn (adds,
  removals, adapters), requests that hold their in-flight slot for a
  random number of steps, and passive-health reports (failures that
  open breakers, successes, latencies past the fleet's median that
  soft-eject), on a shared fake clock: PrefixHash (CHWBL), LeastLoad and
  RoundRobin pick the same endpoint at every step (LeastLoad's random
  tie-break reseeded alike before each pick), and the breaker, health
  and routing snapshots are equal after the script.
- ``LoadBalancer`` over a store: the same pods (ready or not, with
  adapter labels, a gang's two ranks, a role label, a port annotation)
  become the same endpoints, roles and breaker views.
"""

import random

import numpy as np
import pytest

import test_chwbl_churn as jtest_churn
from _torch_operator import plain, to_port
from kubeai_tpu.loadbalancer import balancer as jbal
from kubeai_tpu.loadbalancer import chwbl as jchwbl
from kubeai_tpu.loadbalancer import group as jgroup
from kubeai_tpu_torch.loadbalancer import balancer as tbal
from kubeai_tpu_torch.loadbalancer import chwbl as tchwbl
from kubeai_tpu_torch.loadbalancer import group as tgroup


class _RingTwin:
    """HashRing of both packages behind one object; each call's results
    must be equal."""

    def __init__(self, *a, **k):
        self.rings = (jchwbl.HashRing(*a, **k), tchwbl.HashRing(*a, **k))

    def __getattr__(self, name):
        def call(*a, **k):
            outs = [getattr(r, name)(*a, **k) for r in self.rings]
            outs = [list(o) if name == "walk" else o for o in outs]
            assert outs[0] == outs[1], name
            return outs[0]
        return call

    def __len__(self):
        assert len(self.rings[0]) == len(self.rings[1])
        return len(self.rings[0])


@pytest.mark.parametrize("case", ["test_ambiguous_names_do_not_collide",
                                  "test_ring_survives_churn"])
def test_chwbl_churn_cases_through_both_packages(case, monkeypatch):
    monkeypatch.setattr(jtest_churn, "HashRing", _RingTwin)
    getattr(jtest_churn, case)()


@pytest.mark.parametrize("seed", range(4))
def test_ring_walks_equal_under_churn(seed):
    rng = np.random.default_rng(seed)
    ring = _RingTwin(replication=int(rng.choice([8, 64, 256])))
    live: set = set()
    for step in range(60):
        name = f"pod-{int(rng.integers(0, 12))}"
        if name in live and rng.random() < 0.4:
            ring.remove(name)
            live.discard(name)
        elif name not in live:
            ring.add(name)
            live.add(name)
        len(ring)
        ring.vnode_counts()
        for k in range(5):
            ring.walk(f"prefix-{step}-{k}")


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _groups(clock, **kw):
    return (jgroup.EndpointGroup(clock=clock, name="m", **kw),
            tgroup.EndpointGroup(clock=clock, name="m", **kw))


def _observed(pkg, live, adapters):
    ep = jgroup.Endpoint if pkg is jgroup else tgroup.Endpoint
    return {n: ep(address=f"10.0.0.{i}:8000", adapters=set(adapters.get(n, ())))
            for i, n in sorted((int(n.split("-")[1]), n) for n in live)}


STRATEGIES = [jgroup.PREFIX_HASH, jgroup.LEAST_LOAD, jgroup.ROUND_ROBIN]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", range(3))
def test_picks_and_health_equal_under_a_seeded_script(strategy, seed):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    groups = _groups(clock, chwbl_replication=32, breaker_threshold=2, breaker_cooldown=5.0,
                     outlier_min_requests=4, scoring_window=2.0, slow_start_window=3.0)
    live = {f"pod-{i}" for i in range(4)}
    adapters = {"pod-1": {"a1"}, "pod-2": {"a1", "a2"}}
    for g, pkg in zip(groups, (jgroup, tgroup)):
        g.reconcile_endpoints(_observed(pkg, live, adapters))
    held = []  # (release step, (done_j, done_t))
    picks, roles, states = 0, {}, set()
    for step in range(150):
        clock.t += float(rng.choice([0.05, 0.3, 1.0]))
        if rng.random() < 0.08:  # churn
            name = f"pod-{int(rng.integers(0, 6))}"
            if name in live and len(live) > 2:
                live.discard(name)
            else:
                live.add(name)
            for g, pkg in zip(groups, (jgroup, tgroup)):
                g.reconcile_endpoints(_observed(pkg, live, adapters))
        prefix = f"conversation {int(rng.integers(0, 8))}: " * 3
        adapter = str(rng.choice(["", "", "a1", "a2"]))
        outs = []
        for g in groups:
            random.seed(seed * 1000 + step)
            try:
                outs.append(g.get_best_addr(strategy, prefix=prefix, adapter=adapter,
                                            mean_load_factor=1.25, timeout=0.0))
            except TimeoutError:
                outs.append(None)
        assert (outs[0] is None) == (outs[1] is None), step
        if outs[0] is not None:
            assert outs[0][0] == outs[1][0], f"step {step}: {outs[0][0]} != {outs[1][0]}"
            picks += 1
            addr = outs[0][0]
            # The outcome: the first endpoint picked always fails, the
            # second is slow.
            if addr not in roles:
                roles[addr] = ("bad", "slow", "ok", "ok", "ok", "ok", "ok")[len(roles)]
            for g in groups:
                g.report_result(addr, ok=roles[addr] != "bad", started_at=clock.t - 0.1)
                g.observe_latency(addr, 2.0 if roles[addr] == "slow" else 0.1)
            held.append((step + int(rng.integers(0, 6)), (outs[0][1], outs[1][1])))
        for item in [h for h in held if h[0] <= step]:
            held.remove(item)
            for done in item[1]:
                done()
        assert plain(groups[0].endpoint_loads()) == plain(groups[1].endpoint_loads())
        assert groups[0].total_in_flight() == groups[1].total_in_flight()
        breakers = [g.breaker_snapshot() for g in groups]
        assert plain(breakers[0]) == plain(breakers[1]), step
        states |= {e["state"] for e in breakers[0]}
    assert picks > 50
    snaps = [(g.health_snapshot(), g.routing_snapshot()) for g in groups]
    assert plain(snaps[0]) == plain(snaps[1])
    assert states - {"closed"}, "the script never opened a breaker"


def test_load_balancer_endpoints_from_the_same_pods():
    from kubeai_tpu.api import core_types as jct
    from kubeai_tpu.api import model_types as jmt
    from kubeai_tpu.runtime import store as js
    from kubeai_tpu_torch.runtime import store as ts

    pods = []
    for i, (ready, labels, ann) in enumerate([
            (True, {}, {jmt.ANNOTATION_MODEL_POD_PORT: "9001"}),
            (False, {}, {}),
            (True, {jmt.LABEL_ADAPTER_PREFIX + "a1": "a1-hash"}, {}),
            (True, {"slice-id": "s1", "slice-rank": "1"}, {}),
            (True, {"slice-id": "s1", "slice-rank": "0"}, {}),
            (True, {jmt.LABEL_ROLE: "prefill"}, {})]):
        p = jct.Pod(meta=js.ObjectMeta(name=f"p{i}", labels={jmt.LABEL_MODEL: "m", **labels},
                                       annotations=ann),
                    status=jct.PodStatus(ready=ready, pod_ip=f"10.1.0.{i}", scheduled=True))
        pods.append(p)
    out = []
    for bal, store_mod, conv in ((jbal, js, lambda x: x), (tbal, ts, to_port)):
        store = store_mod.Store()
        for p in pods:
            store.create("Pod", conv(p))
        lb = bal.LoadBalancer(store, allow_pod_address_override=True)
        lb.start()
        try:
            import time
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and len(lb.get_all_addresses("m")) < 4:
                time.sleep(0.01)
            out.append((sorted(lb.get_all_addresses("m")), lb.get_endpoint_roles("m"),
                        plain(lb.breaker_snapshot())))
        finally:
            lb.stop()
    assert out[0] == out[1]
    assert len(out[0][0]) >= 3
