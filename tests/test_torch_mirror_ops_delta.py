"""The JAX package's ``tests/test_ops_delta.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {}

torch_mirror.export(torch_mirror.mirror("tests.test_ops_delta"), globals(), "MOpsDelta", exclude=EXCLUDED)
