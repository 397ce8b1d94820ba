"""The mirror itself (``tests/torch_mirror.py``): what it changes in the
JAX test modules it runs over the port, and that it changes nothing else.

The JAX class names map to the port's classes, with ``isinstance`` kept;
the device entry points default to the mirror's device while the port's
own defaults stay ``"cuda"`` (and raise here); a spawned ``python -m
mqtt_tpu.<mod>`` runs ``mqtt_tpu_torch.<mod>`` with ``--device``, in
every mirrored module, the five mirrored before the others included; and
every ``tests/test_torch_mirror_<module>.py`` file mirrors its module,
each exclusion naming a real case with its class.
"""

import ast
import glob
import os
import sys

import pytest
import torch

from mqtt_tpu_torch import TopicsIndex, TorchMatcher
from mqtt_tpu_torch.ops import delta as tdelta
from mqtt_tpu_torch.server import Options

from tests import torch_mirror

HERE = os.path.dirname(os.path.abspath(__file__))

# the JAX test modules mirrored, one file each
MIRRORED = (
    "aux", "clients", "codec", "compact", "devicestats", "durable", "fanout", "federation", "hooks_dispatch",
    "interop", "lockplane", "loopwitness", "mesh_drill", "native", "ops_delta", "ops_matcher", "overload",
    "packets", "parallel", "predicates", "profiling", "race", "resilience", "server", "slo", "stage_gate",
    "staging", "telemetry", "tenancy", "topics", "tracing", "tree_mesh",
)
# mirrored in the port's own test files since earlier
EARLIER = ("cluster", "cluster_metrics", "mesh_topology", "scenarios", "shards")


def _owner():
    """The CPU mirrors' shared state (made by the first mirror)."""
    torch_mirror.mirror("tests.test_topics")
    return torch_mirror._OWNERS["cpu"]


def _view(name: str):
    return _owner().import_(name, fromlist=("x",))


def test_jax_matcher_names_are_the_port_classes():
    ops = _view("mqtt_tpu.ops")
    m = ops.TpuMatcher(TopicsIndex(), max_levels=4)
    assert isinstance(m, TorchMatcher) and isinstance(m, ops.TpuMatcher) and m.device.type == "cpu"
    made_by_the_port = tdelta.DeltaMatcher(TopicsIndex(), background=False, device="cpu")
    try:
        assert isinstance(made_by_the_port.snapshot, ops.TpuMatcher)
    finally:
        made_by_the_port.close()
    sharded = _view("mqtt_tpu.parallel").ShardedTpuMatcher(TopicsIndex())
    try:
        positions = [d for row in sharded.mesh.devices for d in row]
        assert len(positions) == 8 and {d.type for d in positions} == {"cpu"}
    finally:
        sharded.close()


def test_the_ports_own_defaults_stay_cuda():
    assert not torch.cuda.is_available()
    assert _view("mqtt_tpu").Options().device == "cpu" and Options().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchMatcher(TopicsIndex())
    mirrored = torch_mirror.mirror("tests.test_ops_matcher", device="cuda")
    assert mirrored is not torch_mirror.mirror("tests.test_ops_matcher")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mirrored.TpuMatcher(TopicsIndex())


@pytest.mark.parametrize("argv, want", [
    (["-m", "mqtt_tpu.stress", "--serve", "--broker", "127.0.0.1:1"],
     ["-m", "mqtt_tpu_torch.stress", "--serve", "--broker", "127.0.0.1:1", "--device", "cpu"]),
    (["-m", "mqtt_tpu.stress", "--broker", "127.0.0.1:1"], ["-m", "mqtt_tpu_torch.stress", "--broker", "127.0.0.1:1"]),
    (["-m", "mqtt_tpu", "serve", "--config", "c.yaml"],
     ["-m", "mqtt_tpu_torch", "serve", "--config", "c.yaml", "--device", "cpu"]),
    (["-m", "mqtt_tpu", "initauth", "a.yaml"], ["-m", "mqtt_tpu_torch", "initauth", "a.yaml"]),
    (["-m", "mqtt_tpu.stress", "--serve", "--device", "cuda"], ["-m", "mqtt_tpu_torch.stress", "--serve", "--device", "cuda"]),
    (["openssl", "req", "-x509"], ["openssl", "req", "-x509"]),
    ("echo -m mqtt_tpu", "echo -m mqtt_tpu"),
])
def test_a_spawned_command_runs_the_port(argv, want):
    assert _owner().argv(argv) == want


@pytest.mark.parametrize("name", EARLIER + ("mesh_drill", "tree_mesh"))
def test_every_mirrored_module_spawns_through_the_view(name):
    mod = torch_mirror.mirror(f"tests.test_{name}")
    owner = _owner()
    assert getattr(mod, "subprocess", owner.subprocess) is owner.subprocess
    assert getattr(mod, "asyncio", owner.asyncio) is owner.asyncio
    assert mod.__builtins__["__import__"] == owner.import_


def test_a_spawned_entry_point_is_the_ports():
    run = _owner().subprocess.run
    r = run([sys.executable, "-m", "mqtt_tpu", "--help"], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("usage: mqtt_tpu_torch"), r.stdout[:200]


def _excluded(path: str) -> dict:
    tree = ast.parse(open(path, encoding="utf-8").read())
    node = next(n for n in tree.body if isinstance(n, ast.AnnAssign) and n.target.id == "EXCLUDED")
    return eval(compile(ast.Expression(node.value), path, "eval"))  # a literal built of literals


@pytest.mark.parametrize("name", MIRRORED)
def test_each_module_has_its_mirror_and_its_exclusions_name_real_cases(name):
    path = os.path.join(HERE, f"test_torch_mirror_{name}.py")
    src = open(path, encoding="utf-8").read()
    assert f'torch_mirror.mirror("tests.test_{name}")' in src
    cases = set(torch_mirror.cases(torch_mirror.mirror(f"tests.test_{name}")))
    for case, reason in _excluded(path).items():
        head, _, meth = case.partition("::")
        assert head in cases, case
        assert reason.startswith(("(b) ", "(c) ", "(d) ", "(ref) ")), (case, reason)


def test_no_other_test_module_is_left_unmirrored():
    """Every JAX test module is mirrored, mirrored since earlier, or one of
    those the README names as testing JAX tooling or the JAX planes."""
    tooling = {"lint", "bench_flow", "bench_trend", "examples", "dryrun", "zz_lockwitness", "zz_loopwitness"}
    jax_modules = {os.path.basename(p)[len("test_"):-3] for p in glob.glob(os.path.join(HERE, "test_*.py"))
                   if not os.path.basename(p).startswith("test_torch_")}
    assert jax_modules == set(MIRRORED) | set(EARLIER) | tooling
