"""The JAX package's ``tests/test_devicestats.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "TestRecompileGuard::test_capacity_churn_is_caught_with_attribution": (
        "(b) the first-launch ledger notes only the card's launches and builds (ROADMAP, Departures), so "
        "a CPU launch notes nothing; pinned by "
        "tests/test_torch_devicestats.py::test_cuda_wrapper_on_cpu_tensors_raises_and_notes_nothing"
    ),
    "TestMeshExposition::test_all_eight_devices_and_tiles_exported": (
        "(b) the per-card plane lists the devices of its own device (ROADMAP, Departures): on the CPU the"
        " host's one entry, where the JAX plane lists the 8 host devices tests/conftest.py makes; pinned "
        "by tests/test_torch_devicestats.py::test_cpu_plane_matches_the_jax_planes_cpu_snapshot"
    ),
    "TestDevicesEndpoint::test_matrix": (
        "(b) the per-card plane lists the devices of its own device (ROADMAP, Departures): on the CPU the"
        " host's one entry, where the JAX plane lists the 8 host devices tests/conftest.py makes; pinned "
        "by tests/test_torch_devicestats.py::test_cpu_plane_matches_the_jax_planes_cpu_snapshot"
    ),
    "TestDumpAndSkewSLO::test_trigger_dump_writes_devices_sibling": (
        "(b) the per-card plane lists the devices of its own device (ROADMAP, Departures): on the CPU the"
        " host's one entry, where the JAX plane lists the 8 host devices tests/conftest.py makes; pinned "
        "by tests/test_torch_devicestats.py::test_cpu_plane_matches_the_jax_planes_cpu_snapshot"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_devicestats"), globals(), "MDevicestats", exclude=EXCLUDED)
