"""The JAX package's ``tests/test_race.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "test_handoff_fuzz_quick_sweep": (
        "(c) tests/test_race.py fails the same case on the same tree: the original fails beside the "
        "mirror in one run; both pass and fail from run to run"
    ),
    "test_lazy_view_lifetime_churn_quick": (
        "(ref) a defect of the reference test (ROADMAP, Where we stand), none of (a)-(d): the drill keeps "
        "views[:4] and calls materialize() on them, but its writers' random filters ('+' and '#' over "
        "its few segments) put in the delta overlay filters that match every topic it resolves, so every row is a host-walked plain Subscribers in both "
        "packages and the drill never holds a view; it fails on its own materialize() in either package "
        "once a run reaches its 25th batch in its 4 s. The view lifetime on the card is held by "
        "tests/test_torch_cuda.py::test_lazy_views_outlive_folds_under_churn_on_the_card"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_race"), globals(), "MRace", exclude=EXCLUDED)
