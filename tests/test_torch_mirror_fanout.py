"""The JAX package's ``tests/test_fanout.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "TestDeliveryDifferential::test_lazy_matches_eager_bit_identically": (
        "(c) tests/test_fanout.py fails the same case on the same tree: the original fails beside the "
        "mirror in one run"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_fanout"), globals(), "MFanout", exclude=EXCLUDED)
