"""The port's object store (kubeai_tpu_torch/runtime/store.py) against
the JAX package's, on the CPU.

The same seeded scripts of create, get, list, update (current and stale
versions), mutate and delete, with labels, owners (cascading deletes)
and finalizers, run on both stores: every step gives the same result or
the same error (AlreadyExists, Conflict, NotFound), and a watcher of all
kinds and one of a single kind see the same events, with the same
resource versions.
"""

import queue

import numpy as np
import pytest

from _torch_operator import plain, to_port
from kubeai_tpu.api import core_types as jct
from kubeai_tpu.api import model_types as jmt
from kubeai_tpu.runtime import store as js
from kubeai_tpu_torch.runtime import store as ts

KINDS = (jmt.KIND_MODEL, jct.KIND_POD, jct.KIND_CONFIGMAP)


def _obj(kind, name, rng, owners=()):
    meta = js.ObjectMeta(name=name, labels={"app": str(rng.integers(0, 3))},
                         owner_uids=list(owners))
    if rng.random() < 0.2:
        meta.finalizers = ["kubeai.org/test"]
    if kind == jmt.KIND_MODEL:
        return jmt.Model(meta=meta, spec=jmt.ModelSpec(url="hf://a/b",
                                                       min_replicas=int(rng.integers(0, 3))))
    if kind == jct.KIND_POD:
        return jct.Pod(meta=meta)
    return jct.ConfigMap(meta=meta, data={"k": str(rng.integers(0, 9))})


def _drain(q):
    out = []
    while True:
        try:
            ev = q.get_nowait()
        except queue.Empty:
            return out
        out.append((ev.type, ev.kind, ev.obj.meta.name, ev.obj.meta.resource_version,
                    plain(ev.obj.meta.labels), ev.obj.meta.deletion_timestamp is not None))


def _run(store, step):
    """One step's result or error, in a package-free form."""
    try:
        out = step(store)
    except (js.AlreadyExists, js.Conflict, js.NotFound,
            ts.AlreadyExists, ts.Conflict, ts.NotFound) as e:
        return ("error", type(e).__name__, str(e))
    if isinstance(out, list):
        return sorted((o.meta.name, o.meta.resource_version) for o in out)
    if out is None or isinstance(out, int):
        return out
    return (out.meta.name, out.meta.resource_version, plain(out.meta.labels),
            out.meta.finalizers)


def _script(seed, n=160):
    """Seeded steps (functions of a store) over a few names of each kind;
    objects come from the JAX package and are carried to the port's."""
    rng = np.random.default_rng(seed)
    names = [f"o{i}" for i in range(5)]
    steps = []
    uids = {}  # name -> a created Model's uid, for owners (equal in both: set here)
    for i in range(n):
        kind = KINDS[int(rng.integers(0, len(KINDS)))]
        name = names[int(rng.integers(0, len(names)))]
        op = rng.choice(["create", "create", "get", "list", "update", "stale", "mutate",
                         "delete", "delete_all", "unfinalize"])
        if op == "create":
            owners = [uids[o] for o in rng.choice(list(uids), size=min(1, len(uids)),
                                                  replace=False)] if uids and kind != \
                jmt.KIND_MODEL and rng.random() < 0.5 else []
            obj = _obj(kind, name, rng, owners)
            if kind == jmt.KIND_MODEL:
                obj.meta.uid = uids.setdefault(name, f"uid-{name}")
            steps.append(lambda s, k=kind, o=obj: s.create(k, o if type(s) is js.Store
                                                           else to_port(o)))
        elif op == "get":
            steps.append(lambda s, k=kind, nm=name: s.get(k, nm))
        elif op == "list":
            sel = {"app": str(rng.integers(0, 3))} if rng.random() < 0.5 else None
            steps.append(lambda s, k=kind, sel=sel: s.list(k, "default", sel))
        elif op in ("update", "stale"):
            label = str(rng.integers(0, 3))

            def upd(s, k=kind, nm=name, label=label, stale=op == "stale"):
                o = s.get(k, nm)
                o.meta.labels["app"] = label
                if stale:
                    o.meta.resource_version -= 1
                return s.update(k, o)
            steps.append(upd)
        elif op == "mutate":
            label = str(rng.integers(0, 3))
            steps.append(lambda s, k=kind, nm=name, label=label: s.mutate(
                k, nm, lambda o: o.meta.labels.__setitem__("app", label)))
        elif op == "delete":
            steps.append(lambda s, k=kind, nm=name: s.delete(k, nm))
        elif op == "delete_all":
            sel = {"app": str(rng.integers(0, 3))}
            steps.append(lambda s, k=kind, sel=sel: s.delete_all_of(k, "default", sel))
        else:
            steps.append(lambda s, k=kind, nm=name: s.mutate(
                k, nm, lambda o: o.meta.finalizers.clear()))
    return steps


@pytest.mark.parametrize("seed", range(6))
def test_the_same_script_gives_the_same_results_and_events(seed):
    stores = (js.Store(), ts.Store())
    watch_all = [s.watch() for s in stores]
    watch_pods = [s.watch(jct.KIND_POD) for s in stores]
    results = ([], [])
    for step in _script(seed):
        for store, out in zip(stores, results):
            out.append(_run(store, step))
    assert results[0] == results[1]
    assert any(r and r[0] == "error" for r in results[0])
    assert _drain(watch_all[0]) == _drain(watch_all[1])
    assert _drain(watch_pods[0]) == _drain(watch_pods[1])
    # A late watcher gets the same synthetic ADDED events.
    assert sorted(_drain(stores[0].watch())) == sorted(_drain(stores[1].watch()))

