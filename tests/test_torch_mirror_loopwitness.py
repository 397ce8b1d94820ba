"""The JAX package's ``tests/test_loopwitness.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "TestInstrumentedTouchPoints::test_session_plane_is_armed_recording": (
        "(b) asserts the loop plane tests/conftest.py arms, the JAX package's; the port's plane is its "
        "own and nothing arms it here (ROADMAP, Departures); pinned by "
        "tests/test_torch_locked.py::test_the_loop_plane_is_the_ports_own"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_loopwitness"), globals(), "MLoopwitness", exclude=EXCLUDED)
