"""The JAX package's ``tests/test_stage_gate.py`` seen through
``tests/torch_mirror.py``. This file exports no case: every case of the
module tests ``exp/stage_gate.py``, the JAX package's bench tooling, which
imports nothing of ``mqtt_tpu``, so its mirror would run the same code
again. Each class is in ``EXCLUDED`` with that reason."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {name: (
    "(d) tests exp/stage_gate.py, the JAX package's bench tooling, which imports nothing of "
    "mqtt_tpu: a mirror would run the same code again and test nothing of the port"
) for name in (
    "TestCompare",
    "TestDeviceSubStages",
    "TestBenchRanking",
    "TestCli",
)}

torch_mirror.export(torch_mirror.mirror("tests.test_stage_gate"), globals(), "MStageGate", exclude=EXCLUDED)
