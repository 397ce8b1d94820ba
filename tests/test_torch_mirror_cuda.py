"""The JAX package's device-path cases run over the port on the card.

``tests/torch_mirror.py`` executes each JAX test module below with every
``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` and every device entry
point on ``"cuda"`` (``mirror(name, device="cuda")``): the same bodies,
parameters and assertions as on the CPU, now through the hand-written
kernels. Every case here needs an NVIDIA card with ``sm_90a`` and
``nvcc``; where there is none it skips with that reason. The mirrored
sources import no JAX, so this runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_mirror_cuda.py

The JAX test modules whose sources import ``jax`` at their top cannot
come (``JAX_AT_TOP``); their CPU mirrors run in the tier-1 suite.
"""

import pytest
import torch
import torch_mirror  # this directory, first on the path (a ``tests`` package may be installed)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")


# sources with ``import jax`` (or its importorskip) at their top
JAX_AT_TOP = {
    "tests.test_compact": "import jax.numpy as jnp",
    "tests.test_parallel": "import jax",
    "tests.test_devicestats": 'jax = pytest.importorskip("jax")',
}

# module -> the cases run on the card (None: every case)
CASES = {
    "tests.test_ops_delta": None,
    "tests.test_race": (
        "test_churn_while_matching_two_writers",
        "test_lazy_view_lifetime_churn_quick",
        "test_fold_lock_order_regression",
    ),
    "tests.test_durable": ("TestRetainedMatchEngine",),
    "tests.test_predicates": ("TestDifferentialOracle", "TestBrokerEndToEnd"),
    "tests.test_tenancy": ("TestAESVectors",),
}

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED = {
    "tests.test_race": {
        "test_lazy_view_lifetime_churn_quick": (
            "(ref) a defect of the reference test (ROADMAP, Where we stand), none of (a)-(d): every row of "
            "the drill is host-walked in both packages, so it holds no view and fails on its own "
            "materialize() once it reaches its 25th batch; the view lifetime on the card is "
            "tests/test_torch_cuda.py::test_lazy_views_outlive_folds_under_churn_on_the_card"
        ),
    },
    "tests.test_durable": {
        "TestRetainedMatchEngine::test_fault_storm_degrades_to_host": (
            "(b) the retained engine has no breaker (ROADMAP, Departures); pinned by "
            "tests/test_torch_retained.py::test_a_device_failure_raises_where_the_jax_engine_walks"
        ),
        "TestRetainedMatchEngine::test_server_retained_delivery_with_engine": (
            "(b) the retained engine has no breaker (ROADMAP, Departures); pinned by "
            "tests/test_torch_retained.py::test_a_device_failure_raises_where_the_jax_engine_walks"
        ),
    },
}

for _name, _only in CASES.items():
    _prefix = "Cuda" + "".join(w.capitalize() for w in _name.rsplit(".", 1)[1][len("test_"):].split("_"))
    torch_mirror.export(torch_mirror.mirror(_name, device="cuda"), globals(), _prefix, only=_only,
                        exclude=EXCLUDED.get(_name, {}))
