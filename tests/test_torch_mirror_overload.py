"""The JAX package's ``tests/test_overload.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "TestBoundedStagingAdmission::test_deadline_aware_admission": (
        "(b) the port's admission deadline reads the resolve leg's own time, not the loop-clock EWMA the "
        "case sets (ROADMAP Queue C item 6); pinned by "
        "tests/test_torch_stage_legs.py::test_a_busy_event_loop_trips_the_deadline_only_in_the_jax_stage"
    ),
    "TestPublishStorm::test_storm_sheds_gracefully_and_recovers": (
        "(c) tests/test_overload.py fails the same case on the same tree, with the same "
        "IncompleteReadError: the original fails beside the mirror in one run"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_overload"), globals(), "MOverload", exclude=EXCLUDED)
