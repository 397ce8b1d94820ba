"""The JAX package's ``tests/test_predicates.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "TestBreakerDegradation::test_breaker_trips_to_host_and_probes_back": (
        "(b) the predicate and re-encryption engines and the stage have no breaker (ROADMAP, Departures):"
        " a device failure raises to the caller where the JAX package serves the host path; pinned by "
        "tests/test_torch_stage_legs.py::test_a_kernel_failure_on_a_leg_reaches_the_futures and "
        "::test_fanout_kernel_failures_raise"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_predicates"), globals(), "MPredicates", exclude=EXCLUDED)
