"""The JAX package's ``tests/test_compact.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "TestCapacityEdges::test_hits_equal_capacity_is_not_overflow": (
        "(d) calls the kernel on jnp arrays (jnp.asarray), a JAX internal; the port's K2 header at and "
        "past its capacity is held by tests/test_torch_cuda.py::test_compact_kernel_matches_plain"
    ),
    "TestCapacityEdges::test_hits_past_capacity_sets_the_flag": (
        "(d) calls the kernel on jnp arrays (jnp.asarray), a JAX internal; the port's K2 overflow flag is"
        " held by tests/test_torch_cuda.py::test_compact_kernel_matches_plain"
    ),
    "TestMaterializerDifferential::test_c_and_python_pair_expansion_identical": (
        "(d) launches the kernel on jnp arrays over TpuMatcher.device_arrays (JAX arrays); the port's C "
        "pair expansion against its plain version is "
        "tests/test_torch_native.py::test_c_materializer_equals_the_plain_version"
    ),
    "TestDeviceAggReduction::test_device_fault_degrades_to_host_reduction": (
        "(b) the predicate and re-encryption engines and the stage have no breaker (ROADMAP, Departures):"
        " a device failure raises to the caller where the JAX package serves the host path; pinned by "
        "tests/test_torch_stage_legs.py::test_a_kernel_failure_on_a_leg_reaches_the_futures and "
        "::test_fanout_kernel_failures_raise"
    ),
    "TestDeviceAggReduction::test_open_breaker_serves_windows_from_host_silently": (
        "(b) the predicate and re-encryption engines and the stage have no breaker (ROADMAP, Departures):"
        " a device failure raises to the caller where the JAX package serves the host path; pinned by "
        "tests/test_torch_stage_legs.py::test_a_kernel_failure_on_a_leg_reaches_the_futures and "
        "::test_fanout_kernel_failures_raise"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_compact"), globals(), "MCompact", exclude=EXCLUDED)
