"""Run a JAX-package test module's own cases against the port.

``mirror("tests.test_shards")`` executes that test module's source again,
as a new module, with every import of ``mqtt_tpu`` (or of ``mqtt_tpu.X``)
answered by the port's ``mqtt_tpu_torch`` (``mqtt_tpu_torch.X``) and every
import of another mirrored test module (``tests.test_server``,
``tests.tpackets``, ...) answered by its mirror. The imports inside test
bodies go through the same redirect, so a case's local
``from mqtt_tpu.cluster import Cluster`` gets the port's ``Cluster``.

A port module is seen through a view (``_View``) that changes four
things and nothing else:

- the JAX names of the matchers map to the port's (``TpuMatcher`` ->
  ``TorchMatcher``, ``ShardedTpuMatcher`` -> ``ShardedTorchMatcher``);
- every device entry point (a class or function of the port whose
  ``device`` parameter defaults to ``"cuda"``: the matchers, the engines,
  ``DeviceStatsPlane``, the scenario lab, ...) and the server's
  ``Options`` default to the mirror's device, ``mirror(name,
  device="cpu")`` by default; ``make_mesh()`` and a
  ``ShardedTorchMatcher`` without a mesh take eight positions on it, the
  JAX suite's eight host devices. A class keeps its identity for
  ``isinstance``: an object the port builds itself is an instance of the
  view's class. The port's own defaults stay ``"cuda"``;
- assignments to a view land on the port module (``monkeypatch.setattr``
  patches the port);
- the JAX call sites that the port spells differently are adapted: the
  matchers' retired ``frontier``/``out_slots``/``transfer_slots``
  arguments are dropped, ``TpuMatcher.csr`` reads ``index`` and
  ``TpuMatcher._expand_snap`` is ``expand_snap_py``, ``resolve_compact_py``
  takes the JAX argument order, and ``PredicateEngine``'s
  ``device_agg_min_window``/``device_agg_min_batch`` hold the port's
  module constants for the engine's ``apply``.

``subprocess`` and ``asyncio`` are seen through views as well: a command
``python -m mqtt_tpu.<mod>`` runs ``mqtt_tpu_torch.<mod>``, with
``--device`` set where the port's CLI takes it, so a mirrored case that
spawns a broker spawns the port's. ``pytest.importorskip`` of a
``mqtt_tpu`` module answers with the port's.

``export(mirrored, namespace, prefix, only=..., exclude=...)`` binds the
mirrored module's test classes and functions into a test file's namespace
under new names (``TestX`` -> ``Test<prefix>X``, ``test_x`` ->
``test_<prefix>_x``), with the fixtures they use and the module's own
marks, so pytest collects them there; ``exclude`` leaves cases out (a
file's ``EXCLUDED``, each case with its class and reason: (b) a ROADMAP
departure, (c) the JAX original fails too, (d) a JAX internal, (ref) a
defect of the reference test itself, in ROADMAP). Nothing
here changes a case: its body, parameters and assertions are the JAX
module's.
"""

from __future__ import annotations

import builtins
import dataclasses
import functools
import inspect
import os
import sys
import types

_HERE = os.path.dirname(os.path.abspath(__file__))

# the test modules whose imports the mirror answers with their mirrors
_MIRROR_SOURCES = {
    "tests.tpackets", "tests.test_server", "tests.test_topics", "tests.test_ops_matcher",
    "tests.test_telemetry", "tests.test_overload", "tests.test_federation",
    "tests.test_tree_mesh", "tests.test_shards", "tests.test_mesh_topology",
    "tests.test_cluster_metrics", "tests.test_cluster",
}

# JAX class names and the port's names for the same classes
_NAME_MAP = {"TpuMatcher": "TorchMatcher", "ShardedTpuMatcher": "ShardedTorchMatcher"}

# constructor arguments of the JAX matchers that the port's flat match has
# no use for (the JAX matcher keeps them for its callers): dropped
_RETIRED_ARGS = {"TorchMatcher": ("frontier", "out_slots", "transfer_slots"),
                 "DeltaMatcher": ("frontier", "transfer_slots")}

# the port CLIs that take ``--device``: whether a run's arguments build a
# broker (the entry point serves unless given one of its other commands)
_DEVICE_CLIS = {
    "mqtt_tpu_torch.stress": lambda args: "--serve" in args,
    "mqtt_tpu_torch": lambda args: not {"initauth", "code-password", "genecc", "-h", "--help", "--version"} & set(args),
}

_MIRRORS: dict = {}


def _port_name(name: str) -> str:
    if name == "mqtt_tpu" or name.startswith("mqtt_tpu."):
        return "mqtt_tpu_torch" + name[len("mqtt_tpu"):]
    return name


def _is_port(obj) -> bool:
    mod = getattr(obj, "__module__", None) or ""
    return mod == "mqtt_tpu_torch" or mod.startswith("mqtt_tpu_torch.")


def _is_jax(obj) -> bool:
    return type(obj).__module__.split(".")[0] in ("jax", "jaxlib")


def _device_default(fn) -> bool:
    """Whether ``fn`` takes ``device`` defaulting to ``"cuda"``."""
    try:
        p = inspect.signature(fn).parameters.get("device")
    except (TypeError, ValueError):
        return False
    return p is not None and p.default == "cuda"


class _Mirror:
    """What one device's mirrors share: the views of the port's modules,
    the entry points seen with the device, the import hook."""

    def __init__(self, device: str) -> None:
        self.device = device
        self.views: dict = {}
        self.adapted: dict = {}
        self.subprocess = _SubprocessView(self)
        self.asyncio = _AsyncioView(self)
        self.pytest = None

    # -- port objects seen with the mirror's device --------------------

    def adapt(self, obj):
        if isinstance(obj, types.ModuleType):
            return self.view(obj) if obj.__name__.split(".")[0] == "mqtt_tpu_torch" else obj
        if not _is_port(obj) or not callable(obj):
            return obj
        key = id(obj)
        hit = self.adapted.get(key)
        if hit is not None and hit[0] is obj:
            return hit[1]
        new = self._adapt(obj)
        self.adapted[key] = (obj, new)
        return new

    def _adapt(self, obj):
        name = getattr(obj, "__name__", "")
        device = self.device
        if isinstance(obj, type) and name == "Options" and dataclasses.is_dataclass(obj):
            return dataclasses.make_dataclass(
                "Options", [("device", str, dataclasses.field(default=device))],
                bases=(obj,), namespace={"__module__": obj.__module__, "__qualname__": obj.__qualname__},
            )
        if name == "make_mesh" and not isinstance(obj, type):
            @functools.wraps(obj)
            def make_mesh(devices=None, *a, **k):
                if devices is None:
                    devices = [device] * 8
                # a JAX case's ``jax.devices()``: its positions on the mirror's device
                return obj([device if _is_jax(d) else d for d in devices], *a, **k)

            make_mesh._mirror_real = obj
            return make_mesh
        if isinstance(obj, type):
            if name == "ShardedTorchMatcher":
                mesh_of = self.adapt(sys.modules[obj.__module__].make_mesh)

                def init(inst, topics, mesh=None, *a, **k):
                    obj.__init__(inst, topics, mesh if mesh is not None else mesh_of(), *a, **k)

                return _same_class(obj, init)
            if _device_default(obj):
                retired = _RETIRED_ARGS.get(name, ())
                extra, after, knob_names = self._jax_spelling(obj)

                def init(inst, *a, **k):
                    for arg in retired:
                        k.pop(arg, None)
                    if "device" not in k and not _positional_device(obj.__init__, a, 1):
                        k["device"] = device
                    knobs = {arg: k.pop(arg) for arg in knob_names if arg in k}
                    obj.__init__(inst, *a, **k)
                    if after is not None:
                        after(inst, **knobs)

                return _same_class(obj, init, **extra)
            return obj
        if name == "resolve_compact_py":
            @functools.wraps(obj)
            def resolve_compact_py(pair_sid, pair_shard, totals, host_route, topics, subs_table,
                                   tables=None, n_hits=None):
                # the JAX function's argument order
                return obj(pair_sid, totals, host_route, topics, subs_table, n_hits=n_hits,
                           pair_shard=pair_shard, tables=tables)

            resolve_compact_py._mirror_real = obj
            return resolve_compact_py
        if isinstance(obj, types.FunctionType) and obj.__module__ == "mqtt_tpu_torch.config":
            # a configuration names no device in the JAX suite: its
            # ``Options`` come back as the mirror's
            options = self.adapt(sys.modules["mqtt_tpu_torch.server"].Options)

            @functools.wraps(obj)
            def load(*a, **k):
                got = obj(*a, **k)
                if type(got) is options.__mro__[1]:
                    got = options(**{f.name: getattr(got, f.name) for f in dataclasses.fields(got) if f.init
                                     and f.name != "device"})
                return got

            load._mirror_real = obj
            return load
        if isinstance(obj, types.FunctionType) and _device_default(obj):
            @functools.wraps(obj)
            def call(*a, **k):
                if "device" not in k and not _positional_device(obj, a, 0):
                    k["device"] = device
                return obj(*a, **k)

            call._mirror_real = obj
            return call
        return obj

    def _jax_spelling(self, cls: type) -> tuple:
        """What the JAX class of the same name has that the port's spells
        differently: ``(members, after, knobs)``, the view's class members,
        a function run on each new instance with the constructor arguments
        named in ``knobs`` that its caller passed."""
        name = cls.__name__
        mod = sys.modules[cls.__module__]
        if name == "TorchMatcher":
            return _matcher_members(mod), None, ()
        if name == "DeltaMatcher":
            def after(inst):
                # the snapshot the port builds, seen with the JAX matcher's
                # members
                snap = inst.__dict__.get("_snap")
                key = ("snapshot", type(snap))
                if key not in self.adapted:
                    cls_ = type(snap)
                    self.adapted[key] = type(cls_.__name__, (cls_,), {
                        "__module__": cls_.__module__, "__qualname__": cls_.__qualname__,
                        **_matcher_members(sys.modules["mqtt_tpu_torch.ops.matcher"]),
                    })
                snap.__class__ = self.adapted[key]

            return {}, after, ()
        if name == "PredicateEngine":
            def after(inst, device_agg_min_window=mod.DEVICE_AGG_MIN_WINDOW):
                inst.device_agg_min_window = device_agg_min_window
                inst.device_agg_min_batch = mod.DEVICE_AGG_MIN_BATCH

            def apply(inst, *a, **k):
                # the JAX engine's thresholds are its attributes, the
                # port's module constants: they hold for this call
                saved = mod.DEVICE_AGG_MIN_WINDOW, mod.DEVICE_AGG_MIN_BATCH
                window = inst.device_agg_min_window
                mod.DEVICE_AGG_MIN_WINDOW = window if window > 0 else sys.maxsize
                mod.DEVICE_AGG_MIN_BATCH = max(1, inst.device_agg_min_batch)
                try:
                    return cls.apply(inst, *a, **k)
                finally:
                    mod.DEVICE_AGG_MIN_WINDOW, mod.DEVICE_AGG_MIN_BATCH = saved

            return {"apply": apply}, after, ("device_agg_min_window",)
        return {}, None, ()

    def view(self, mod: types.ModuleType) -> types.ModuleType:
        v = self.views.get(mod.__name__)
        if v is None:
            v = self.views[mod.__name__] = _View(mod, self)
        return v

    # -- the import hook of the mirrored modules ----------------------

    def import_(self, name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name in _MIRROR_SOURCES:
            mod = mirror(name, self.device)
            return mod if fromlist else sys.modules[name.split(".")[0]]
        if level == 0 and (name == "mqtt_tpu" or name.startswith("mqtt_tpu.")):
            port = _port_name(name)
            top = builtins.__import__(port, globals, locals, fromlist, level)
            if fromlist:
                v = self.view(top)
                absent = [n for n in fromlist if n.startswith("_") and n != "*" and not hasattr(top, n)]
                if absent:
                    return _Overlay(v, **{n: _absent(f"{port}.{n}") for n in absent})
                return v
            # ``import mqtt_tpu.x`` binds the package: give the port's
            return self.view(sys.modules["mqtt_tpu_torch"])
        top = builtins.__import__(name, globals, locals, fromlist, level)
        if level == 0 and not fromlist:
            if name == "subprocess":
                return self.subprocess
            if name == "asyncio":
                return self.asyncio
            if name == "pytest":
                return self.pytest_view(top)
        if level == 0 and fromlist and name == "subprocess":
            return self.subprocess
        return top

    def pytest_view(self, real):
        if self.pytest is None:
            def importorskip(modname, *a, **k):
                if modname == "mqtt_tpu" or modname.startswith("mqtt_tpu."):
                    return self.view(real.importorskip(_port_name(modname), *a, **k))
                return real.importorskip(modname, *a, **k)

            self.pytest = _Overlay(real, importorskip=importorskip)
        return self.pytest

    # -- commands ------------------------------------------------------

    def argv(self, args):
        """``args`` with ``-m mqtt_tpu[.mod]`` made the port's module and,
        where that CLI builds a broker, ``--device`` added."""
        if isinstance(args, (str, bytes)) or args is None:
            return args
        out = list(args)
        for i in range(len(out) - 1):
            if out[i] == "-m" and isinstance(out[i + 1], str):
                port = _port_name(out[i + 1])
                if port == out[i + 1]:
                    continue
                out[i + 1] = port
                serves = _DEVICE_CLIS.get(port)
                if serves is not None and serves(out[i + 2:]) and "--device" not in out:
                    out += ["--device", self.device]
                break
        return type(args)(out) if isinstance(args, tuple) else out


def _matcher_members(mod: types.ModuleType) -> dict:
    """The JAX ``TpuMatcher``'s spellings of the port matcher's members."""
    return {"csr": property(lambda m: m.index), "_expand_snap": staticmethod(mod.expand_snap_py)}


def _positional_device(fn, args: tuple, skip: int) -> bool:
    """Whether ``args`` (after ``skip`` leading parameters) reach the
    ``device`` parameter of ``fn``."""
    try:
        names = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return False
    names = names[skip:]
    return "device" in names and names.index("device") < len(args)


def _same_class(cls: type, init, **members) -> type:
    """A subclass of ``cls`` with ``init`` for ``__init__`` (and
    ``members``), for which every instance of ``cls`` is an instance (and
    ``cls`` a subclass)."""

    class Meta(type(cls)):
        def __instancecheck__(self, obj):
            return isinstance(obj, cls)

        def __subclasscheck__(self, sub):
            return issubclass(sub, cls)

    functools.update_wrapper(init, cls.__init__)
    return Meta(cls.__name__, (cls,), {
        "__init__": init, "__module__": cls.__module__, "__qualname__": cls.__qualname__,
        "__doc__": cls.__doc__, "_mirror_real": cls, **members,
    })


def _real(obj):
    """The port's own object behind one the mirror made (an instance is
    its own)."""
    return getattr(obj, "__dict__", {}).get("_mirror_real", obj)


class _View(types.ModuleType):
    """A port module seen through the mirror (module docstring)."""

    def __init__(self, real: types.ModuleType, owner: _Mirror) -> None:
        super().__init__(real.__name__, real.__doc__)
        object.__setattr__(self, "_real", real)
        object.__setattr__(self, "_owner", owner)
        for k in ("__file__", "__path__", "__package__", "__spec__", "__all__"):
            if hasattr(real, k):
                object.__setattr__(self, k, getattr(real, k))

    def __getattr__(self, name: str):
        real = object.__getattribute__(self, "_real")
        if name.startswith("__"):
            return getattr(real, name)
        obj = getattr(real, _NAME_MAP.get(name, name))
        return object.__getattribute__(self, "_owner").adapt(obj)

    def __setattr__(self, name: str, value) -> None:
        setattr(object.__getattribute__(self, "_real"), _NAME_MAP.get(name, name), _real(value))

    def __delattr__(self, name: str) -> None:
        delattr(object.__getattribute__(self, "_real"), _NAME_MAP.get(name, name))

    def __dir__(self):
        return dir(object.__getattribute__(self, "_real"))


class _Overlay(types.ModuleType):
    """A module with some attributes replaced; the rest read through."""

    def __init__(self, real: types.ModuleType, **over) -> None:
        super().__init__(real.__name__, real.__doc__)
        self.__dict__["_real"] = real
        self.__dict__.update(over)

    def __getattr__(self, name: str):
        return getattr(self.__dict__["_real"], name)


class _SubprocessView(_Overlay):
    """``subprocess`` whose commands run the port (``_Mirror.argv``)."""

    def __init__(self, owner: _Mirror) -> None:
        import subprocess

        def wrap(fn):
            @functools.wraps(fn)
            def call(args, *a, **k):
                return fn(owner.argv(args), *a, **k)

            return call

        super().__init__(subprocess, **{
            n: wrap(getattr(subprocess, n)) for n in ("run", "call", "check_call", "check_output")
        })

        class Popen(subprocess.Popen):
            def __init__(self, args, *a, **k):
                super().__init__(owner.argv(args), *a, **k)

        self.__dict__["Popen"] = Popen


class _AsyncioView(_Overlay):
    """``asyncio`` whose ``create_subprocess_exec`` runs the port."""

    def __init__(self, owner: _Mirror) -> None:
        import asyncio

        @functools.wraps(asyncio.create_subprocess_exec)
        async def create_subprocess_exec(program, *args, **k):
            argv = owner.argv([program, *args])
            return await asyncio.create_subprocess_exec(*argv, **k)

        super().__init__(asyncio, create_subprocess_exec=create_subprocess_exec)


def _absent(name: str):
    """A private JAX name the port has none of (a Python scanner, a jit
    cache): importing it works, calling it raises."""

    def absent(*_a, **_k):
        raise AttributeError(f"{name}: a JAX internal the port has none of")

    absent.__qualname__ = absent.__name__ = name.rsplit(".", 1)[1]
    return absent


_OWNERS: dict = {}


def mirror(name: str, device: str = "cpu") -> types.ModuleType:
    """The JAX test module ``name`` executed over the port, its device
    entry points defaulting to ``device`` (cached)."""
    key = (name, device)
    mod = _MIRRORS.get(key)
    if mod is not None:
        return mod
    owner = _OWNERS.get(device)
    if owner is None:
        owner = _OWNERS[device] = _Mirror(device)
    # by path: a package named ``tests`` elsewhere on the path may shadow
    # this directory (it has no ``__init__.py``)
    origin = os.path.join(_HERE, name.split(".", 1)[1] + ".py")
    with open(origin, encoding="utf-8") as f:
        src = f.read()
    mod = types.ModuleType(name + ("_on_torch" if device == "cpu" else f"_on_torch_{device}"))
    mod.__file__ = origin
    bdict = dict(builtins.__dict__)
    bdict["__import__"] = owner.import_
    mod.__dict__["__builtins__"] = bdict
    _MIRRORS[key] = mod
    # dataclasses and pickling look a class's module up by name
    sys.modules[mod.__name__] = mod
    exec(compile(src, origin, "exec"), mod.__dict__)
    return mod


def cases(mod: types.ModuleType) -> list:
    """The names of ``mod``'s test classes and functions."""
    return [n for n, _ in _tests(mod)]


def _tests(mod: types.ModuleType):
    for name, obj in list(vars(mod).items()):
        if isinstance(obj, type) and name.startswith("Test") and obj.__module__ == mod.__name__:
            yield name, obj
        elif isinstance(obj, types.FunctionType) and name.startswith("test_") and obj.__module__ == mod.__name__:
            yield name, obj


def export(mod: types.ModuleType, namespace: dict, prefix: str, only=None, exclude=()) -> list:
    """Bind ``mod``'s test classes and functions (``only`` those names,
    when given) and the fixtures they may request into ``namespace``; the
    names bound. ``exclude`` names cases left out: a class or function,
    or ``"TestX::test_y"`` for one method of a class."""
    bound = []
    tests = dict(_tests(mod))
    dropped: dict = {}
    for case in exclude:
        head, _, meth = case.partition("::")
        if head not in tests:
            raise KeyError(f"{mod.__name__} has no case {case!r}")
        if meth:
            if not callable(getattr(tests[head], meth, None)):
                raise KeyError(f"{mod.__name__} has no case {case!r}")
            dropped.setdefault(head, set()).add(meth)
        else:
            dropped[head] = None
    if hasattr(mod, "pytestmark"):
        # the module's own marks (``slow``, ...) hold for every case bound
        def as_list(m):
            return m if isinstance(m, list) else [m]

        namespace["pytestmark"] = as_list(namespace.get("pytestmark", [])) + as_list(mod.pytestmark)
    for name, obj in list(vars(mod).items()):
        if name in tests:
            if (only is not None and name not in only) or (name in dropped and dropped[name] is None):
                continue
            if name in dropped:
                obj = type(obj)(name, (obj,), {
                    **{m: None for m in dropped[name]},
                    "__module__": obj.__module__, "__qualname__": obj.__qualname__,
                })
            new = f"Test{prefix}{name[4:]}" if name.startswith("Test") else f"test_{prefix.lower()}_{name[5:]}"
        elif hasattr(obj, "_pytestfixturefunction") or type(obj).__name__ == "FixtureFunctionDefinition":
            new = name
        else:
            continue
        namespace[new] = obj
        bound.append(new)
    return bound
