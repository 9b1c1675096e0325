"""Helpers of the operator parity tests (tests/test_torch_{store,
model_types,pods,balancer,operator_proxy}.py): objects carried from the
JAX package's classes to the port's, a plain form of either for equality,
and the JAX test files' own cases run through both packages.

``jax_cases(module)`` lists every test of a JAX test module (class
methods and parametrize cases included) as a case of one parametrised
test; ``run_jax_case`` runs it with each name in *wrap* (a function the
test module imported from the JAX package, or "module:name" in the JAX
package) replaced by ``dual``: the JAX
function and the port's run on the same arguments (carried across by
``to_port``), and their results, their effects on the arguments and
their errors (type name and message) must be equal. The test's own
assertions then run on the JAX result, unchanged.

``port_clone(module)`` is a JAX test module's own source with every name
of the JAX package spelled as the port's (the test modules it imports
cloned alike), loaded as a module of its own: its cases run the same
inputs and the same assertions on the port's objects. A stateful object
(an autoscaler, a reconciler over a store) cannot be carried across per
call as ``dual`` carries functions, so such test files run each case
twice, on the JAX module and on its clone (``run_jax_case_both``).

``obs_dirs`` (autouse where imported) points ``KUBEAI_HISTORY_DIR`` and
``KUBEAI_INCIDENT_DIR`` under the test's ``tmp_path``: a Manager's or a
recorder's rings never reach the shared default directories, where
another test (or a later run) would restore them; and it puts back each
package's installed forecaster, recorder, history store and prober."""

from __future__ import annotations

import dataclasses
import enum
import importlib
import inspect
import re
import sys
import types

import pytest
from _pytest.fixtures import FixtureFunctionDefinition

JAX, PORT = "kubeai_tpu", "kubeai_tpu_torch"


# Each package's process-wide install points (module, global): a test
# that builds a Manager and never stops it (a JAX wiring case) leaves them
# set for the next test file on its worker.
_INSTALLS = (("obs.forecast", "_forecaster"), ("obs.incidents", "_recorder"),
             ("obs.history", "_store"), ("obs.canary", "_prober"))


@pytest.fixture(autouse=True)
def obs_dirs(tmp_path, monkeypatch):
    """The history and incident directories under ``tmp_path``:
    {"history": dir, "incidents": dir}; each package's install points are
    as before the test after it."""
    dirs = {"history": str(tmp_path / "obs-history"),
            "incidents": str(tmp_path / "obs-incidents")}
    monkeypatch.setenv("KUBEAI_HISTORY_DIR", dirs["history"])
    monkeypatch.setenv("KUBEAI_INCIDENT_DIR", dirs["incidents"])
    for pkg in (JAX, PORT):
        for mod, name in _INSTALLS:
            m = importlib.import_module(f"{pkg}.{mod}")
            monkeypatch.setattr(m, name, getattr(m, name))
    return dirs


def _package_of(obj) -> str | None:
    mod = type(obj).__module__
    for pkg in (PORT, JAX):
        if mod == pkg or mod.startswith(pkg + "."):
            return pkg
    return None


def _counterpart(cls, src: str, dst: str):
    mod = importlib.import_module(dst + cls.__module__[len(src):])
    return getattr(mod, cls.__qualname__)


class _PortView:
    """A test's helper object (a fake model client) seen from the port:
    its methods' results are carried to the port's classes, and a JAX
    exception it raises becomes the port's exception of that name."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        attr = getattr(self._obj, name)
        if not callable(attr):
            return to_port(attr)

        def call(*a, **k):
            try:
                return to_port(attr(*a, **k))
            except Exception as e:
                raise _exception_to(e, JAX, PORT) from e

        return call


def _exception_to(e: Exception, src: str, dst: str) -> Exception:
    if _package_of(e) != src:
        return e
    new = _counterpart(type(e), src, dst).__new__(_counterpart(type(e), src, dst))
    new.args = e.args
    new.__dict__.update(_convert(vars(e), src, dst))
    return new


def _convert(obj, src: str, dst: str):
    if isinstance(obj, (str, bytes, int, float, bool, type(None), enum.Enum)):
        return obj
    if isinstance(obj, list):
        return [_convert(x, src, dst) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_convert(x, src, dst) for x in obj)
    if isinstance(obj, dict):
        return {_convert(k, src, dst): _convert(v, src, dst) for k, v in obj.items()}
    if isinstance(obj, set):
        return {_convert(x, src, dst) for x in obj}
    if _package_of(obj) == src:
        cls = _counterpart(type(obj), src, dst)
        if dataclasses.is_dataclass(obj):
            init = {f.name: _convert(getattr(obj, f.name), src, dst)
                    for f in dataclasses.fields(obj) if f.init}
            new = cls(**init)
            for f in dataclasses.fields(obj):
                if not f.init:
                    setattr(new, f.name, _convert(getattr(obj, f.name), src, dst))
            return new
        if isinstance(obj, Exception):
            return _exception_to(obj, src, dst)
        new = cls.__new__(cls)
        new.__dict__.update(_convert(vars(obj), src, dst))
        return new
    if src == JAX and not callable(obj) and hasattr(obj, "__dict__") and \
            type(obj).__module__.startswith("test_"):
        return _PortView(obj)
    return obj


def to_port(obj):
    """*obj* with every JAX-package object replaced by the port's."""
    return _convert(obj, JAX, PORT)


def plain(obj):
    """A package-free form for equality: objects become (class name,
    their fields), recursively."""
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, (list, tuple)):
        return [plain(x) for x in obj]
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, set):
        return sorted((plain(x) for x in obj), key=repr)
    if isinstance(obj, BaseException):
        return (type(obj).__name__, str(obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if hasattr(obj, "__dict__") and _package_of(obj) is not None:
        return (type(obj).__name__, plain(vars(obj)))
    return obj


class Dual:
    """A JAX function and its port counterpart as one callable; counts
    its calls."""

    def __init__(self, jfn, tfn, same=None):
        self.jfn, self.tfn, self.calls = jfn, tfn, 0
        self.same = same or (lambda j, t: plain(j) == plain(t))

    def __call__(self, *a, **k):
        self.calls += 1
        ta, tk = to_port(a), to_port(k)
        jres = tres = jerr = terr = None
        try:
            jres = self.jfn(*a, **k)
        except Exception as e:
            jerr = e
        try:
            tres = self.tfn(*ta, **tk)
        except Exception as e:
            terr = e
        what = getattr(self.jfn, "__name__", repr(self.jfn))
        if jerr is not None or terr is not None:
            assert plain(jerr) == plain(terr), f"{what}: JAX raised {jerr!r}, the port {terr!r}"
            raise jerr
        assert self.same(jres, tres), f"{what}: results differ:\n{plain(jres)}\n{plain(tres)}"
        # The arguments as the calls left them (a test's own helper
        # objects, seen through _PortView, are not compared).
        pairs = [(x, y) for x, y in list(zip(a, ta)) + [(k[n], tk[n]) for n in k]
                 if not isinstance(y, _PortView)]
        assert all(plain(x) == plain(y) for x, y in pairs), f"{what}: arguments differ after"
        return jres


def dual(name: str, jax_module, same=None) -> Dual:
    """The Dual of *name* as *jax_module* (a JAX test module, or a JAX
    package module) holds it."""
    jfn = getattr(jax_module, name)
    tmod = importlib.import_module(PORT + jfn.__module__[len(JAX):])
    return Dual(jfn, getattr(tmod, jfn.__name__), same)


def _param_sets(fn):
    """[(id, {argname: value})] of *fn*'s parametrize marks (one set when
    it has none)."""
    sets = [("", {})]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        out = []
        for i, v in enumerate(values):
            vals = v.values if hasattr(v, "values") and not isinstance(v, dict) else \
                (v if len(names) > 1 else (v,))
            for sid, got in sets:
                out.append((f"{sid}-{i}" if sid else str(i), {**got, **dict(zip(names, vals))}))
        sets = out
    return sets


def jax_cases(module, skip=()) -> list:
    """pytest.param cases, one per test (and parametrize case) of *module*."""
    cases = []
    for name, obj in vars(module).items():
        tests = []
        if name.startswith("test") and inspect.isfunction(obj):
            tests = [(name, obj)]
        elif name.startswith("Test") and inspect.isclass(obj):
            tests = [(f"{name}.{m}", f) for m, f in vars(obj).items()
                     if m.startswith("test") and inspect.isfunction(f)]
        for qual, fn in tests:
            if qual in skip:
                continue
            for sid, params in _param_sets(fn):
                cid = f"{module.__name__}::{qual}" + (f"[{sid}]" if sid else "")
                cases.append(pytest.param(module, qual, params, id=cid))
    return cases


def run_jax_case(module, qual, params, wrap, request, monkeypatch) -> int:
    """Run one JAX test with the names in *wrap* dual; returns the dual
    calls it made."""
    duals = {}
    for name in wrap:
        # (name, same) compares results with *same*; "package.module:name"
        # wraps a JAX module's attribute (a test that imports the function
        # inside its body reads it there).
        name, same = name if isinstance(name, tuple) else (name, None)
        owner = importlib.import_module(name.split(":")[0]) if ":" in name else module
        attr = name.split(":")[-1]
        duals[name] = dual(attr, owner, same)
        monkeypatch.setattr(owner, attr, duals[name])
    if "." in qual:
        cls_name, meth = qual.split(".")
        fn = getattr(getattr(module, cls_name)(), meth)
    else:
        fn = getattr(module, qual)
    kwargs = dict(params)
    teardown = []
    try:
        for arg in inspect.signature(fn).parameters:
            if arg not in kwargs:
                kwargs[arg] = _fixture_value(module, arg, request, teardown)
        fn(**kwargs)
    finally:
        for gen in reversed(teardown):
            next(gen, None)
    return sum(d.calls for d in duals.values())


def _fixture_value(module, name, request, teardown):
    """The value of fixture *name* for a case of *module*: the module's
    own fixture function (its arguments resolved alike; a generator's
    rest runs at *teardown*), else pytest's."""
    fixture = getattr(module, name, None)
    if not isinstance(fixture, FixtureFunctionDefinition):
        return request.getfixturevalue(name)
    fn = fixture._get_wrapped_function()
    args = {a: _fixture_value(module, a, request, teardown)
            for a in inspect.signature(fn).parameters}
    value = fn(**args)
    if inspect.isgenerator(value):
        teardown.append(value)
        value = next(value)
    return value


# Modules of the JAX package whose port has another path.
_PORT_MODULES = (("kubeai_tpu_torch.metrics.registry", "kubeai_tpu_torch.metrics"),)


def port_clone(module):
    """*module*'s source with the JAX package's names spelled as the
    port's, loaded as a module named ``port_<name>`` (once)."""
    name = "port_" + module.__name__.replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    with open(module.__file__) as f:
        src = f.read()
    src = re.sub(r"\bkubeai_tpu\b(?!_torch)", PORT, src)
    for jax_name, port_name in _PORT_MODULES:
        src = src.replace(jax_name, port_name)

    def clone_import(m):
        dep = port_clone(importlib.import_module(m.group(2)))
        return f"from {dep.__name__} import"

    src = re.sub(r"from (tests\.)?(test_\w+) import", clone_import, src)
    mod = types.ModuleType(name)
    mod.__file__ = module.__file__
    sys.modules[name] = mod
    try:
        exec(compile(src, module.__file__, "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def run_jax_case_both(module, qual, params, request, monkeypatch) -> None:
    """Run one JAX test case on the JAX package, then on the port (its
    clone): the same inputs and the same assertions."""
    run_jax_case(module, qual, params, (), request, monkeypatch)
    run_jax_case(port_clone(module), qual, to_port(params), (), request, monkeypatch)
