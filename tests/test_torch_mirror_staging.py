"""The JAX package's ``tests/test_staging.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "TestMatchStageUnit::test_stage_error_falls_back_to_host": (
        "(b) the stage has no host route for a matcher failure (ROADMAP, Departures): the error reaches "
        "the futures; pinned by "
        "tests/test_torch_stage_legs.py::test_a_matcher_failure_reaches_the_futures_where_the_jax_stage_walks"
    ),
    "TestMatchStageUnit::test_stage_stop_drains_pending_via_host": (
        "(b) the stage has no host route for a matcher failure (ROADMAP, Departures): the error reaches "
        "the futures; pinned by "
        "tests/test_torch_stage_legs.py::test_a_matcher_failure_reaches_the_futures_where_the_jax_stage_walks"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_staging"), globals(), "MStaging", exclude=EXCLUDED)
