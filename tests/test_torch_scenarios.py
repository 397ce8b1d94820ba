"""The port's scenario lab (``mqtt_tpu_torch.scenarios``) held against the
JAX package's ``mqtt_tpu.scenarios`` on the CPU.

First the JAX suite's own cases, run over the port through
``tests/torch_mirror.py`` (the same bodies and assertions, the imports
answered by the port, its entry points on ``device="cpu"``): the delivery
oracle's math, the SLO gate's breaches, the catalog's sanity, the QoS 2
exactly-once regressions, and the full matrix (marked ``slow``, as the
JAX case is).

Then the two packages side by side, with tolerance 0: the catalog row by
row (seeds, objectives, params, smoke), ``payload_sweep`` and
``mixed_fleet`` run through both, their result documents equal apart from
the walls and the rates derived from them, and ``run_matrix``'s rule that
a crashed driver is a failed row. On a host without CUDA the port's entry
points raise at their default device.
"""

import pytest

import mqtt_tpu.scenarios as jscn
import mqtt_tpu_torch.scenarios as tscn

from tests import torch_mirror

torch_mirror.export(torch_mirror.mirror("tests.test_scenarios"), globals(), "Port")

# measured on the clock: left out of the package comparison
WALL_KEYS = ("wall_s", "deliveries_per_sec", "qos2_deliveries_per_sec")


def _without_walls(doc: dict) -> dict:
    out = {k: v for k, v in doc.items() if k not in WALL_KEYS}
    out["metrics"] = {k: v for k, v in doc["metrics"].items() if k not in WALL_KEYS}
    return out


def test_the_catalog_equals_the_jax_catalog_row_by_row():
    assert list(tscn.SCENARIOS) == list(jscn.SCENARIOS)
    for name, j in jscn.SCENARIOS.items():
        t = tscn.SCENARIOS[name]
        assert (t.name, t.title, t.seed, t.objectives, t.params, t.smoke) == (
            j.name, j.title, j.seed, j.objectives, j.params, j.smoke), name
    for smoke in (False, True):
        assert tscn.scenario_names(smoke) == jscn.scenario_names(smoke)
    assert (tscn.RUN_TIMEOUT_S, tscn.GATE_SPAN_S) == (jscn.RUN_TIMEOUT_S, jscn.GATE_SPAN_S)


@pytest.mark.parametrize("name", ["payload_sweep", "mixed_fleet"])
def test_smoke_rows_give_the_jax_result_document(name):
    j = jscn.run_scenario(name)
    t = tscn.run_scenario(name, device="cpu")
    assert _without_walls(t) == _without_walls(j)
    assert t["passed"] and t["slo"]["passed"] and t["oracle"]["gaps"] == 0
    assert t["oracle"]["delivered"] == t["oracle"]["expected"] > 0


def test_a_crashed_driver_is_a_failed_row_as_in_the_jax_matrix(monkeypatch):
    async def crash(run):
        raise RuntimeError("driver fault")

    rows = {}
    for name, mod, kw in (("jax", jscn, {}), ("torch", tscn, {"device": "cpu"})):
        monkeypatch.setitem(mod._DRIVERS, "will_storm", crash)
        rows[name] = mod.run_matrix(["will_storm"], seed=77, **kw)
    assert rows["torch"] == rows["jax"]
    (row,) = rows["torch"]
    assert row["passed"] is False and row["failures"] == ["driver crashed: RuntimeError('driver fault')"]
    assert row["seed"] == 77 and row["slo"] == {"passed": False, "objectives": []}


def test_the_entry_points_raise_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for call in (lambda: tscn.run_scenario("mixed_fleet"), lambda: tscn.run_matrix(["mixed_fleet"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(RuntimeError, match="CUDA"):
        tscn.ScenarioBroker()
