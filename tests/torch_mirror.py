"""Run a JAX-package test module's own cases against the port.

``mirror("tests.test_shards")`` executes that test module's source again,
as a new module, with every import of ``mqtt_tpu`` (or of ``mqtt_tpu.X``)
answered by the port's ``mqtt_tpu_torch`` (``mqtt_tpu_torch.X``) and every
import of another mirrored test module (``tests.test_server``, ...)
answered by its mirror. The imports inside test bodies go through the same
redirect, so a case's local ``from mqtt_tpu.cluster import Cluster`` gets
the port's ``Cluster``. The port's ``Options`` default to ``device="cpu"``
here (``CpuOptions``): the JAX cases build brokers without naming a device.
Likewise the scenario lab's entry points (``run_scenario``, ``run_matrix``,
``ScenarioBroker``) default to ``device="cpu"`` through the mirror.

``export(mirrored, namespace, prefix)`` binds the mirrored module's test
classes and functions into a test file's namespace under new names
(``TestX`` -> ``Test<prefix>X``, ``test_x`` -> ``test_<prefix>_x``), with
the fixtures they use, so pytest collects them there. Nothing here changes
a case: its body, parameters and assertions are the JAX module's.
"""

from __future__ import annotations

import builtins
import dataclasses
import importlib.util
import sys
import types

_MIRRORS: dict = {}


def _port_name(name: str) -> str:
    if name == "mqtt_tpu" or name.startswith("mqtt_tpu."):
        return "mqtt_tpu_torch" + name[len("mqtt_tpu"):]
    return name


def _cpu_options():
    from mqtt_tpu_torch.server import Options

    @dataclasses.dataclass
    class CpuOptions(Options):
        """The port's ``Options`` with its planes on the CPU."""

        device: str = "cpu"

    return CpuOptions


class _Shim(types.ModuleType):
    """A port module seen through the mirror: ``Options`` is the CPU one,
    every other attribute the module's own."""

    def __init__(self, real: types.ModuleType, options) -> None:
        super().__init__(real.__name__)
        self.__dict__["_real"] = real
        self.__dict__["Options"] = options

    def __getattr__(self, name: str):
        return getattr(self.__dict__["_real"], name)


_SHIMS: dict = {}


class _Missing(types.ModuleType):
    """A module the port does not have (yet): importing names from it
    works, calling one raises, so only the cases that use it fail."""

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)

        def missing(*_a, **_k):
            raise ModuleNotFoundError(f"{self.__name__} is not in the port")

        return missing


class _ScenarioShim(types.ModuleType):
    """The port's scenario lab seen through the mirror: its entry points
    run on the CPU unless a case names a device."""

    def __init__(self, real: types.ModuleType) -> None:
        import functools

        super().__init__(real.__name__)
        self.__dict__["_real"] = real
        for name in ("run_scenario", "run_matrix"):
            self.__dict__[name] = functools.partial(getattr(real, name), device="cpu")

        class CpuScenarioBroker(real.ScenarioBroker):
            def __init__(self, options=None, listener_id: str = "scn", device: str = "cpu") -> None:
                super().__init__(options, listener_id, device)

        self.__dict__["ScenarioBroker"] = CpuScenarioBroker

    def __getattr__(self, name: str):
        return getattr(self.__dict__["_real"], name)


def _shim(mod: types.ModuleType) -> types.ModuleType:
    """Modules exporting ``Options`` (the package and ``server``) and the
    scenario lab come back as shims; the rest as they are."""
    if mod.__name__ == "mqtt_tpu_torch.scenarios":
        s = _SHIMS.get(mod.__name__)
        if s is None:
            s = _SHIMS[mod.__name__] = _ScenarioShim(mod)
        return s
    if getattr(mod, "Options", None) is None or mod.__name__ not in ("mqtt_tpu_torch", "mqtt_tpu_torch.server"):
        return mod
    s = _SHIMS.get(mod.__name__)
    if s is None:
        s = _SHIMS[mod.__name__] = _Shim(mod, _OPTIONS[0])
    return s


_OPTIONS: list = []


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and name in _MIRROR_SOURCES:
        mod = mirror(name)
        return mod if fromlist else sys.modules[name.split(".")[0]]
    if level == 0 and (name == "mqtt_tpu" or name.startswith("mqtt_tpu.")):
        port = _port_name(name)
        try:
            top = builtins.__import__(port, globals, locals, fromlist, level)
        except ModuleNotFoundError as e:
            if e.name != port:
                raise
            return _Missing(port)
        if fromlist:
            return _shim(top)
        # ``import mqtt_tpu.x`` binds the package: give the port's
        return _shim(sys.modules["mqtt_tpu_torch"])
    return builtins.__import__(name, globals, locals, fromlist, level)


# the test modules whose imports the mirror answers with their mirrors
_MIRROR_SOURCES = {"tests.test_server", "tests.test_tree_mesh", "tests.test_shards",
                   "tests.test_mesh_topology", "tests.test_cluster_metrics", "tests.test_cluster"}


def mirror(name: str) -> types.ModuleType:
    """The JAX test module ``name`` executed over the port (cached)."""
    mod = _MIRRORS.get(name)
    if mod is not None:
        return mod
    if not _OPTIONS:
        _OPTIONS.append(_cpu_options())
    spec = importlib.util.find_spec(name)
    with open(spec.origin, encoding="utf-8") as f:
        src = f.read()
    mod = types.ModuleType(name + "_on_torch")
    mod.__file__ = spec.origin
    bdict = dict(builtins.__dict__)
    bdict["__import__"] = _import
    mod.__dict__["__builtins__"] = bdict
    _MIRRORS[name] = mod
    exec(compile(src, spec.origin, "exec"), mod.__dict__)
    return mod


def export(mod: types.ModuleType, namespace: dict, prefix: str, only=None) -> list:
    """Bind ``mod``'s test classes and functions (``only`` those names,
    when given) and the fixtures they may request into ``namespace``; the
    names bound."""
    bound = []
    for name, obj in list(vars(mod).items()):
        if only is not None and name not in only:
            continue
        if isinstance(obj, type) and name.startswith("Test") and obj.__module__ == mod.__name__:
            new = f"Test{prefix}{name[4:]}"
        elif isinstance(obj, types.FunctionType) and name.startswith("test_") and obj.__module__ == mod.__name__:
            new = f"test_{prefix.lower()}_{name[5:]}"
        elif hasattr(obj, "_pytestfixturefunction") or type(obj).__name__ == "FixtureFunctionDefinition":
            new = name
        else:
            continue
        namespace[new] = obj
        bound.append(new)
    return bound
