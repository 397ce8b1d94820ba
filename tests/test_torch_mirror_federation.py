"""The JAX package's ``tests/test_federation.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "TestPriorityWeightedShedding::test_server_assigns_class_at_connect": (
        "(c) tests/test_federation.py fails the same case on the same tree: the original fails beside the"
        " mirror in one run"
    ),
    "TestMeshFederationStorm::test_shed_worker_raises_mesh_refuses_connects_and_weights_sheds": (
        "(c) tests/test_federation.py fails the same case on the same tree, with the same "
        "IncompleteReadError in the storm's collector: 2 of 4 runs of the original, 1 of 4 of the "
        "mirror, four at a time"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_federation"), globals(), "MFederation", exclude=EXCLUDED)
